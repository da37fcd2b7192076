"""The port's sharded selection engine, GPipe executor, sharding rules and
legacy driver against the JAX package (CPU).

Two subprocess runs serve the module, each once:
* JAX's own ``select_sharded`` and ``pipeline_forward`` in a fresh python
  with 4 forced CPU devices (``conftest.run_forced_devices``). jax 0.9's
  ``shard_map`` calls the keyword ``check_rep`` ``check_vma``, so that
  subprocess alone sets ``repro.selection.engine.shard_map`` to a local
  function passing ``check_vma=check_rep`` to ``jax.shard_map``; no file of
  the JAX package changes. The mesh is a hand-built
  ``Mesh((2, 2), ("data", "model"))``: the batch runs over "data", 2 shards.
* A 4-rank gloo fleet of ``python -m repro_torch.backend --worker --job``
  (``backend/fleet.py``), the same (2, 2) mesh over the port's ``Mesh``:
  each rank passes its own shard's rows.

Held:
* (a) every sampler but ``random`` at two steps, the carry threaded:
  pivots and rank EXACT, weights, ``last_error``, ``alignment`` and the
  carry's float leaves at rtol 1e-5 / atol 1e-6; the ranks' global states
  bit-equal. ``streaming_graft``'s sketch rows have free signs (each
  shard's Gram eigendecomposition picks them, float32 LAPACK in JAX,
  float64 in the port), and the pmean of the shards' sketches sums rows
  whose relative signs differ between the two: the averaged sketch is
  held to JAX's per-shard rows with the port's signs (atol 1e-6 of its
  largest entry), and the step after it is run a second time from JAX's
  own carry, where every field is held. From the port's own carry that
  step's pivots are JAX's (MaxVol reads V alone); the rest follows the
  signs.
  ``random``'s draws are the port's own: pivots in range, weights summing
  to 1, the carry's structure.
* (b) one batch tiled over the 2 data shards: shard s's pivots are
  ``select_batch``'s plus s·K, the rank is equal.
* (c) in process on the local backend's (1, 1) mesh: every deterministic
  sampler bit-equal to ``select_batch`` (its carry too); the selector
  cached; the ``r_max`` and "no axis" refusals; on the fleet, unequal
  shards refused on every rank.
* (d) ``pipeline_forward`` on 4 ranks (S 4, M 3) against JAX's and the
  sequential loop at atol 1e-5; ``pipeline_bubble_fraction`` equal to JAX's.
* (e) ``sharding.logical_to_spec`` / ``drop_indivisible`` equal to JAX's.
* (f) ``launch/train.py`` beside the JAX shim and the Trainer.
* (g) the launch contract of a sharded GRAFT refresh (one ``graft_select``
  a rank a call) on the CPU's counted route, in process and on the fleet.
"""
import dataclasses

import numpy as np
import pytest
import torch

from conftest import run_forced_devices
from repro.distributed import pipeline as jpipeline
from repro.distributed import sharding as jsharding
from repro.launch import train as jtrain
from repro_torch.analysis import launch_audit as la
from repro_torch.analysis import runner
from repro_torch.api import Trainer
from repro_torch.backend import LocalBackend, LocalBackendConfig, fleet, make_mesh
from repro_torch.distributed import pipeline as tpipeline
from repro_torch.distributed import sharding as tsharding
from repro_torch.launch import train as ttrain
from repro_torch.selection import GraftConfig, engine
from repro_torch.selection import streaming as tstream

T = torch.from_numpy
DETERMINISTIC = ("graft", "loss_topk", "full", "el2n", "gradmatch", "craig", "glister",
                 "streaming_graft")
GCFG = dict(rset=(2, 4), eps=0.2, sketch_rows=8)
K, R, D, SHARDS, STEPS = 32, 4, 32, 2, 2          # global K; 16 rows a shard
PIPE_S, PIPE_M, PIPE_MB, PIPE_D = 4, 3, 2, 8
FLEET_TIMEOUT_S = 150


def _inputs():
    """Per step: V (K, R), G (d, K) with a shared direction, scores (K,);
    then the pipeline's W (S, D, D) and x (M, mb, D). Seed 0, numpy."""
    rng = np.random.default_rng(0)
    f = np.float32
    out = {}
    for s in range(STEPS):
        out[f"V{s}"] = rng.normal(size=(K, R)).astype(f)
        out[f"G{s}"] = (rng.normal(size=(D, K)) + 0.3 * rng.normal(size=(D, 1))).astype(f)
        out[f"s{s}"] = rng.random(K).astype(f)
    out["W"] = (rng.normal(size=(PIPE_S, PIPE_D, PIPE_D)) / np.sqrt(PIPE_D)).astype(f)
    out["x"] = rng.normal(size=(PIPE_M, PIPE_MB, PIPE_D)).astype(f)
    return out


_JAX_SCRIPT = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
import repro.selection.engine as E
from repro.distributed import pipeline as P
from repro.selection import GraftConfig
from repro.selection import streaming as S
assert len(jax.devices()) == 4

def shard_map(f, *, mesh, in_specs, out_specs, check_rep=True):
    # jax 0.9 names the keyword check_vma
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                         check_vma=check_rep)

E.shard_map = shard_map
z = np.load({inputs!r})
cfg = GraftConfig(**{gcfg!r})
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
out, k = {{}}, {K} // {SHARDS}
for name in {samplers!r}:
    carry = None
    for step in range({STEPS}):
        V, G, sc = (jnp.asarray(z[f"{{c}}{{step}}"]) for c in "VGs")
        if name == "streaming_graft":
            # each shard's own sketch update, from the carry this step starts from
            base = carry.sketch if carry is not None else jnp.zeros((cfg.sketch_rows, G.shape[0]))
            for s in range({SHARDS}):
                out[f"fd/{{step}}/{{s}}"] = np.asarray(S.fd_update(cfg, base, G[:, s * k:(s + 1) * k]))
        state, carry = E.select_sharded(cfg, mesh, V, G, sampler=name, scores=sc,
                                        carry=carry, step=step)
        for f in state._fields:
            out[f"{{name}}/{{step}}/state/{{f}}"] = np.asarray(getattr(state, f))
        for f in getattr(carry, "_fields", ()):
            out[f"{{name}}/{{step}}/carry/{{f}}"] = np.asarray(getattr(carry, f))
mesh3 = Mesh(np.array(jax.devices()).reshape(2, 2, 1), ("pod", "data", "model"))
V, G, sc = (jnp.asarray(z[f"{{c}}0"]) for c in "VGs")
for name in ("graft", "loss_topk"):
    state, _ = E.select_sharded(cfg, mesh3, V, G, sampler=name, scores=sc)
    for f in state._fields:
        out[f"pod/{{name}}/0/state/{{f}}"] = np.asarray(getattr(state, f))
pmesh = Mesh(np.array(jax.devices()), ("pod",))
y = P.pipeline_forward(lambda W, h: jnp.tanh(h @ W), jnp.asarray(z["W"]),
                       jnp.asarray(z["x"]), pmesh, axis="pod")
out["pipe/y"] = np.asarray(y)
out["bubble"] = np.array([P.pipeline_bubble_fraction(s, m) for s, m in ((2, 1), (4, 13), (1, 8))])
np.savez({output!r}, **out)
print("JAX_SHARDED_OK")
"""


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory, inputs):
    work = tmp_path_factory.mktemp("jax_sharded")
    np.savez(work / "inputs.npz", **inputs)
    code = _JAX_SCRIPT.format(inputs=str(work / "inputs.npz"), output=str(work / "out.npz"),
                              gcfg=GCFG, samplers=DETERMINISTIC, K=K, SHARDS=SHARDS,
                              STEPS=STEPS)
    assert "JAX_SHARDED_OK" in run_forced_devices(code, devices=4, timeout=240)
    return dict(np.load(work / "out.npz"))


def _sharded_task(samplers, inputs_list, **extra):
    task = {"kind": "sharded", "mesh": ((2, 2), ("data", "model")), "samplers": list(samplers),
            "inputs": inputs_list}
    task["gcfg"] = dict(GCFG, **extra.pop("gcfg", {}))
    task.update(extra)
    return task


@pytest.fixture(scope="module")
def fleet_out(tmp_path_factory, inputs, jax_out):
    """The 4-rank gloo fleet's results, one dict a rank (the tasks in the
    job's order: sharded vs JAX, tiled, use_pallas, unequal, pipeline, the
    (2, 2, 1) pod mesh, the mesh's collectives)."""
    work = tmp_path_factory.mktemp("port_sharded")
    steps = [(T(inputs[f"V{s}"]), T(inputs[f"G{s}"]), T(inputs[f"s{s}"])) for s in range(STEPS)]
    jax_carry0 = {f: T(jax_out[f"streaming_graft/0/carry/{f}"])
                  for f in ("sketch", "g_ema", "count", "agreement")}
    k = K // SHARDS
    V1, G1, s1 = steps[0][0][:k], steps[0][1][:, :k], steps[0][2][:k]
    tiled = [(V1.repeat(SHARDS, 1), G1.repeat(1, SHARDS), s1.repeat(SHARDS))]
    job = [
        _sharded_task(("random",) + DETERMINISTIC, steps,
                      carry_in={"streaming_graft": {1: jax_carry0}}),
        _sharded_task(("graft",), tiled),
        _sharded_task(("graft", "streaming_graft", "loss_topk"), steps,
                      gcfg={"use_pallas": True}),
        {"kind": "unequal", "mesh": ((2, 2), ("data", "model")), "gcfg": GCFG, "rows": 8,
         "d": D},
        {"kind": "pipeline", "mesh": ((PIPE_S,), ("pod",)), "axis": "pod", "layer": "tanh",
         "W": T(inputs["W"]), "x": T(inputs["x"])},
        dict(_sharded_task(("graft", "loss_topk"), steps[:1]),
             mesh=((2, 2, 1), ("pod", "data", "model"))),
        {"kind": "collectives", "mesh": ((2, 2), ("a", "b")),
         "axes": [("a",), ("b",), ("a", "b"), ("b", "a")]},
    ]
    torch.save(job, work / "job.pt")
    port = fleet.free_port()
    cmds = [fleet.mesh_worker_command(str(work / "job.pt"), str(work / "out"),
                                      fleet.backend_overrides(4, r, port), device="cpu")
            for r in range(4)]
    summaries = [r.last_json() for r in fleet.launch(cmds, timeout=FLEET_TIMEOUT_S)]
    assert [s["rank"] for s in summaries] == [0, 1, 2, 3]
    assert all(s["collectives"] == "gloo" for s in summaries)
    return [torch.load(s["path"], weights_only=True) for s in summaries]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_state(got, jax_out, key, rtol=1e-5, atol=1e-6):
    np.testing.assert_array_equal(_np(got["pivots"]), jax_out[f"{key}/state/pivots"])
    assert int(got["rank"]) == int(jax_out[f"{key}/state/rank"])
    assert int(got["step"]) == int(jax_out[f"{key}/state/step"])
    for f in ("weights", "last_error", "alignment"):
        np.testing.assert_allclose(_np(got[f]), jax_out[f"{key}/state/{f}"], rtol=rtol,
                                   atol=atol, err_msg=f"{key} {f}")


def _assert_ranks_agree(fleet_out, task, key):
    calls = [r["tasks"][task]["calls"][key] for r in fleet_out]
    for other in calls[1:]:
        for f, v in calls[0]["state"].items():
            assert torch.equal(other["state"][f], v), (key, f)
    return calls[0]


# ---------------------------------------------------------------------------
# (a) against JAX's own select_sharded
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sampler", [s for s in DETERMINISTIC if s != "streaming_graft"])
def test_sharded_matches_jax_select_sharded(sampler, fleet_out, jax_out):
    for step in range(STEPS):
        got = _assert_ranks_agree(fleet_out, 0, f"{sampler}/{step}")
        assert got["state"]["pivots"].shape == (SHARDS * R,)
        _assert_state(got["state"], jax_out, f"{sampler}/{step}")
        assert got["carry"] == {}


def _signed_mean(port_base, jax_rows, G):
    """JAX's per-shard sketch rows with the signs the port's own update of
    the same shard picks, averaged over the shards."""
    cfg = GraftConfig(**GCFG)
    k = K // SHARDS
    out = 0.0
    for s in range(SHARDS):
        mine = tstream.fd_update(cfg, port_base, T(G[:, s * k:(s + 1) * k])).numpy()
        theirs = jax_rows[s]
        signs = np.where(np.sum(mine * theirs, axis=1) < 0, -1.0, 1.0)[:, None]
        out = out + signs * theirs
    return (out / SHARDS).astype(np.float32)


def _assert_sketch_carry(carry, jax_out, key, expected_sketch):
    for f in ("g_ema", "count", "agreement"):
        np.testing.assert_allclose(_np(carry[f]), jax_out[f"{key}/carry/{f}"], rtol=1e-5,
                                   atol=1e-6, err_msg=f"{key} {f}")
    # the Gram eigendecomposition is float32 LAPACK in JAX, float64 in the
    # port: the rows agree to ~6.5e-7 of the largest entry
    np.testing.assert_allclose(_np(carry["sketch"]), expected_sketch, rtol=1e-5,
                               atol=1e-6 * np.abs(expected_sketch).max())


def test_sharded_streaming_matches_jax(fleet_out, jax_out, inputs):
    """Step 0 from a fresh carry, then step 1 from JAX's step-0 carry: every
    state field held; the averaged sketch held row by row against JAX's
    per-shard rows with the port's signs. Step 1 from the port's own carry:
    pivots (MaxVol on V alone) and the carry's structure."""
    L = GCFG["sketch_rows"]
    got = _assert_ranks_agree(fleet_out, 0, "streaming_graft/0")
    _assert_state(got["state"], jax_out, "streaming_graft/0")
    expected = _signed_mean(torch.zeros(L, D), [jax_out[f"fd/0/{s}"] for s in range(SHARDS)],
                            inputs["G0"])
    _assert_sketch_carry(got["carry"], jax_out, "streaming_graft/0", expected)

    got = _assert_ranks_agree(fleet_out, 0, "streaming_graft@carry_in/1")
    _assert_state(got["state"], jax_out, "streaming_graft/1")
    expected = _signed_mean(T(jax_out["streaming_graft/0/carry/sketch"]),
                            [jax_out[f"fd/1/{s}"] for s in range(SHARDS)], inputs["G1"])
    _assert_sketch_carry(got["carry"], jax_out, "streaming_graft/1", expected)

    own = _assert_ranks_agree(fleet_out, 0, "streaming_graft/1")
    np.testing.assert_array_equal(_np(own["state"]["pivots"]),
                                  jax_out["streaming_graft/1/state/pivots"])
    assert sorted(own["carry"]) == ["agreement", "count", "g_ema", "sketch"]
    assert own["carry"]["sketch"].shape == (L, D)


@pytest.mark.parametrize("sampler", ["graft", "loss_topk"])
def test_pod_and_data_axes_shard_first_axis_major(sampler, fleet_out, jax_out):
    """``("pod", "data", "model")`` at (2, 2, 1): ``act_batch`` maps to
    ``("pod", "data")``, 4 shards whose index puts pod first, as JAX's."""
    assert fleet_out[0]["tasks"][5]["axes"] == ["pod", "data"]
    assert sorted(r["tasks"][5]["shard"] for r in fleet_out) == [0, 1, 2, 3]
    got = _assert_ranks_agree(fleet_out, 5, f"{sampler}/0")
    assert got["state"]["pivots"].shape == (4 * R,)
    _assert_state(got["state"], jax_out, f"pod/{sampler}/0")


def test_mesh_collectives_over_every_tuple_of_axes(fleet_out):
    """Rank r = 2a + b holds [r, r + 0.5]: each reduction, gather (rank
    order along the axes as given, first axis major; bf16 bit for bit),
    broadcast from the last index and shift i → i + 1 (zeros at index 0)."""
    for res in fleet_out:
        out = res["tasks"][6]
        a, b = out["coords"]["a"], out["coords"]["b"]
        members = {"a": [2 * i + b for i in range(2)], "b": [2 * a + j for j in range(2)],
                   "a,b": [0, 1, 2, 3], "b,a": [0, 2, 1, 3]}
        for key, ranks in members.items():
            got = out[key]
            vals = np.array([[r, r + 0.5] for r in ranks], dtype=np.float32)
            me = ranks.index(res["rank"])
            assert got["index"] == me and got["size"] == len(ranks)
            np.testing.assert_array_equal(got["psum"].numpy(), vals.sum(0))
            np.testing.assert_array_equal(got["pmean"].numpy(), vals.sum(0) / len(ranks))
            np.testing.assert_array_equal(got["pmax"].numpy(), vals.max(0))
            np.testing.assert_array_equal(got["gather"].numpy(), vals.reshape(-1))
            assert torch.equal(got["gather_bf16"],
                               torch.from_numpy(vals.reshape(-1)).to(torch.bfloat16))
            assert torch.equal(got["broadcast"], torch.from_numpy(vals[-1]).to(torch.bfloat16))
            want = vals[me - 1] if me > 0 else np.zeros(2, np.float32)
            np.testing.assert_array_equal(got["shift"].numpy(), want)
            assert got["ints"] == ranks


def test_sharded_random_holds_the_invariants(fleet_out):
    for step in range(STEPS):
        got = _assert_ranks_agree(fleet_out, 0, f"random/{step}")
        piv = _np(got["state"]["pivots"])
        assert piv.shape == (SHARDS * R,)
        assert piv.min() >= 0 and piv.max() < K
        for s in range(SHARDS):              # each shard picks from its own rows
            k = K // SHARDS
            assert np.all((piv[s * R:(s + 1) * R] >= s * k) & (piv[s * R:(s + 1) * R] < (s + 1) * k))
        np.testing.assert_allclose(_np(got["state"]["weights"]).sum(), 1.0, atol=1e-5)
        assert got["carry"] == {}


# ---------------------------------------------------------------------------
# (b) tests/test_selection.py's invariant, (c) the local mesh and refusals
# ---------------------------------------------------------------------------

def test_tiled_batch_shards_equal_select_batch(fleet_out, inputs):
    k = K // SHARDS
    V, G = T(inputs["V0"][:k]), T(inputs["G0"][:, :k])
    single, _ = engine.select_batch(GraftConfig(**GCFG), "graft", V, G, G.mean(dim=1))
    got = _assert_ranks_agree(fleet_out, 1, "graft/0")["state"]
    piv = _np(got["pivots"]).reshape(SHARDS, R)
    for s in range(SHARDS):
        np.testing.assert_array_equal(piv[s] - s * k, single.pivots.numpy())
    assert int(got["rank"]) == int(single.rank)
    np.testing.assert_allclose(float(got["last_error"]), float(single.last_error), atol=1e-5)
    np.testing.assert_allclose(float(got["alignment"]), float(single.alignment), atol=1e-5)
    np.testing.assert_allclose(_np(got["weights"]).sum(), 1.0, atol=1e-5)


def _local_mesh(shape=(1, 1), names=("data", "model")):
    return make_mesh(shape, names, LocalBackend(LocalBackendConfig()))


@pytest.mark.parametrize("sampler", DETERMINISTIC)
def test_local_mesh_is_select_batch_bit_for_bit(sampler, inputs):
    cfg = GraftConfig(**GCFG)
    mesh = _local_mesh()
    carry_s = carry_b = None
    for step in range(STEPS):
        V, G, sc = T(inputs[f"V{step}"]), T(inputs[f"G{step}"]), T(inputs[f"s{step}"])
        got, carry_s = engine.select_sharded(cfg, mesh, V, G, sampler=sampler, scores=sc,
                                             carry=carry_s, step=step)
        want, carry_b = engine.select_batch(cfg, sampler, V, G, G.mean(dim=1), scores=sc,
                                            carry=carry_b, step=step)
        for f in want._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), (sampler, step, f)
        assert type(carry_s) is type(carry_b)
        for a, b in zip(tuple(carry_s), tuple(carry_b)):
            assert torch.equal(a, b), (sampler, step)


def test_selector_is_cached_and_refuses_what_jax_refuses(inputs):
    cfg = GraftConfig(**GCFG)
    mesh = _local_mesh()
    a = engine.make_sharded_selector(cfg, mesh)
    assert a is engine.make_sharded_selector(cfg, mesh)
    assert a is not engine.make_sharded_selector(cfg, mesh, sampler="full")
    backend = LocalBackend(LocalBackendConfig())
    assert engine.make_sharded_selector(cfg, backend) is \
        engine.make_sharded_selector(cfg, backend.mesh())
    with pytest.raises(ValueError, match="r_max"):
        engine.select_sharded(cfg, mesh, torch.zeros(3, R), torch.zeros(D, 3))
    with pytest.raises(ValueError, match="no axis"):
        engine.select_sharded(cfg, _local_mesh((1,), ("model",)), T(inputs["V0"]),
                              T(inputs["G0"]))
    with pytest.raises(ValueError, match="requires SelectionInputs.scores"):
        engine.select_sharded(cfg, mesh, T(inputs["V0"]), T(inputs["G0"]),
                              sampler="loss_topk")


def test_unequal_shards_are_refused_on_every_rank(fleet_out):
    refused = [r["tasks"][3]["refused"] for r in fleet_out]
    assert all(msg and "unequal shards" in msg for msg in refused), refused


# ---------------------------------------------------------------------------
# (d) the GPipe executor
# ---------------------------------------------------------------------------

def test_pipeline_forward_matches_jax_and_the_sequential_loop(fleet_out, jax_out, inputs):
    W, x = inputs["W"], inputs["x"]
    seq = np.stack([x[m] for m in range(PIPE_M)])
    for s in range(PIPE_S):
        seq = np.tanh(seq @ W[s])
    ys = [r["tasks"][4]["y"] for r in fleet_out]
    for y in ys[1:]:
        assert torch.equal(y, ys[0])          # every rank returns the last stage's
    assert sorted(r["tasks"][4]["stage"] for r in fleet_out) == list(range(PIPE_S))
    np.testing.assert_allclose(ys[0].numpy(), jax_out["pipe/y"], atol=1e-5)
    np.testing.assert_allclose(ys[0].numpy(), seq, atol=1e-5)
    # S + M − 1 ticks; S + M − 2 shifts of the buffer
    assert all(len(r["tasks"][4]["tick_s"]) == PIPE_S + PIPE_M - 1 for r in fleet_out)
    assert all(len(r["tasks"][4]["p2p_s"]) == PIPE_S + PIPE_M - 2 for r in fleet_out)


def test_bubble_fraction_equals_jax(jax_out):
    got = [tpipeline.pipeline_bubble_fraction(s, m) for s, m in ((2, 1), (4, 13), (1, 8))]
    assert got == list(jax_out["bubble"])
    assert got == [jpipeline.pipeline_bubble_fraction(s, m) for s, m in ((2, 1), (4, 13), (1, 8))]


def test_pipeline_on_one_stage_is_the_layer():
    W = torch.randn(1, 4, 4, generator=torch.Generator().manual_seed(0))
    x = torch.randn(3, 2, 4, generator=torch.Generator().manual_seed(1))
    y = tpipeline.pipeline_forward(lambda w, h: h @ w, W, x, _local_mesh((1,), ("pod",)))
    assert torch.equal(y, x @ W[0])


# ---------------------------------------------------------------------------
# (e) the sharding rules
# ---------------------------------------------------------------------------

class _Mesh:
    """A mesh's names and sizes: what both ``logical_to_spec`` read."""

    def __init__(self, shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


MESHES = [{"data": 4, "model": 2}, {"pod": 2, "data": 8, "model": 16}]


def _jspec(spec):
    """A ``PartitionSpec``'s entries (one axis by its name, several as a
    tuple)."""
    return tuple(spec)


@pytest.mark.parametrize("shape", MESHES, ids=["data_model", "pod_data_model"])
def test_logical_to_spec_matches_jax_for_every_rule(shape):
    assert tsharding.DEFAULT_RULES == jsharding.DEFAULT_RULES
    mesh = _Mesh(shape)
    names = list(jsharding.DEFAULT_RULES) + [None, "not_a_rule"]
    assert tsharding.logical_to_spec(names, mesh) == _jspec(jsharding.logical_to_spec(names, mesh))
    for name in names:
        assert tsharding.logical_to_spec((name,), mesh) == \
            _jspec(jsharding.logical_to_spec((name,), mesh)), name
    overrides = {"act_batch": "data", "act_kv_seq": ("data", "model"), "heads": None}
    assert tsharding.logical_to_spec(names, mesh, overrides) == \
        _jspec(jsharding.logical_to_spec(names, mesh, overrides))
    with tsharding.sharding_rules(mesh, overrides), jsharding.sharding_rules(mesh, overrides):
        assert tsharding.logical_to_spec(names) == _jspec(jsharding.logical_to_spec(names))


@pytest.mark.parametrize("shape", MESHES, ids=["data_model", "pod_data_model"])
def test_drop_indivisible_matches_jax(shape):
    mesh = _Mesh(shape)
    cases = [(("act_batch", "act_seq", "act_embed"), (32, 64, 128)),
             (("act_batch", "act_kv_seq"), (6, 512)),
             (("kv_heads", "embed"), (4, 2304)),
             (("act_moe_groups", "act_mlp"), (128, 96)),
             (("vocab", "embed"), (122753, 2304)),
             (("act_batch", "act_kv_seq", "act_heads"), (16, 4096, 36))]
    overrides = {"act_kv_seq": ("data", "model")}
    for logical, dims in cases:
        for rules in (None, overrides):
            t = tsharding.drop_indivisible(tsharding.logical_to_spec(logical, mesh, rules),
                                           dims, mesh)
            j = jsharding.drop_indivisible(jsharding.logical_to_spec(logical, mesh, rules),
                                           dims, mesh)
            assert t == _jspec(j), (logical, dims, rules)


# ---------------------------------------------------------------------------
# (f) the legacy driver
# ---------------------------------------------------------------------------

SMALL_RUN = dict(steps=2, batch=8, seq=16, graft_rset=(2, 4), graft_refresh=2, log_every=0)


@pytest.mark.parametrize("kw", [{}, SMALL_RUN, dict(SMALL_RUN, use_graft=False, lr=1e-3),
                                dict(SMALL_RUN, sampler="loss_topk", seed=3)])
def test_to_experiment_has_the_jax_shims_config_hash(kw):
    assert ttrain.to_experiment(ttrain.RunConfig(**kw)).config_hash() == \
        jtrain.to_experiment(jtrain.RunConfig(**kw)).config_hash()
    assert [f.name for f in dataclasses.fields(ttrain.RunConfig)] == \
        [f.name for f in dataclasses.fields(jtrain.RunConfig)]


def test_legacy_train_is_the_trainer_and_fires_legacy_callbacks():
    run = ttrain.RunConfig(**SMALL_RUN)
    seen = []
    report = ttrain.train(run, callbacks=[lambda step, state, m: seen.append(step)],
                          device="cpu")
    assert seen == [0, 1]
    want = Trainer(ttrain.to_experiment(run), device="cpu").fit()
    assert report["final_loss"] == want["final_loss"]
    assert ttrain.main(["--steps", "1", "--batch", "8", "--seq", "8", "--device=cpu"]) == 0


def test_legacy_driver_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.train(ttrain.RunConfig(**SMALL_RUN))


def test_core_graft_re_exports_the_selection_names():
    from repro.core import graft as jgraft
    from repro_torch.core import graft as tgraft
    assert tgraft.__all__ == jgraft.__all__
    state = tgraft.init_state(GraftConfig(**GCFG), 8)
    V, G = torch.randn(8, R), torch.randn(D, 8)
    kept = tgraft.maybe_refresh(GraftConfig(**GCFG, refresh_every=2), state, 1, V, G,
                                G.mean(dim=1))
    assert torch.equal(kept.pivots, state.pivots) and int(kept.step) == 1
    fresh = tgraft.maybe_refresh(GraftConfig(**GCFG, refresh_every=2), state, 2, V, G,
                                 G.mean(dim=1))
    assert torch.equal(fresh.pivots, tgraft.graft_select(
        GraftConfig(**GCFG), V, G, G.mean(dim=1), torch.tensor(2)).pivots)
    # the raw-matrix path: svd features of the rows, given gradients
    rng = np.random.default_rng(1)
    A = rng.normal(size=(16, 12)).astype(np.float32)
    Gm = rng.normal(size=(D, 16)).astype(np.float32)
    got = tgraft.select_from_batch(GraftConfig(**GCFG), T(A),
                                   grad_fn_outputs=(T(Gm), T(Gm.mean(axis=1))), step=3)
    want = jgraft.select_from_batch(jgraft.GraftConfig(**GCFG), A,
                                    grad_fn_outputs=(Gm, Gm.mean(axis=1)), step=3)
    np.testing.assert_array_equal(got.pivots.numpy(), np.asarray(want.pivots))
    assert int(got.rank) == int(want.rank) and int(got.step) == 3
    with pytest.raises(ValueError, match="loss_fn"):
        tgraft.select_from_batch(GraftConfig(**GCFG), T(A))


# ---------------------------------------------------------------------------
# (g) the launch contract
# ---------------------------------------------------------------------------

def test_sharded_refresh_is_one_launch_on_the_counted_route(inputs):
    cfg = GraftConfig(**GCFG, use_pallas=True)
    V, G = T(inputs["V0"]), T(inputs["G0"])
    counts = la.count_launches(engine.select_sharded, cfg, _local_mesh(), V, G)
    assert counts == {"graft_select": 1}
    assert counts == {k: v for k, v in la.expected_sharded_launches(cfg, "graft").items() if v}
    assert la.expected_sharded_launches(cfg, "loss_topk", 3) == dict.fromkeys(la.KERNEL_NAMES, 0)
    assert la.expected_sharded_launches(GraftConfig(**GCFG), "graft")["graft_select"] == 0
    report = runner.check_sharded_selection("cpu", 64, 128, 16, (4, 8, 16))
    assert report.ok, report.format()


def test_sharded_refresh_launches_per_rank_as_reckoned(fleet_out, jax_out):
    """use_pallas on the fleet: each rank's route decisions equal the
    reckoning call by call, and the states equal the unfused run's
    (pivots and rank exact, floats rtol 1e-5)."""
    cfg = GraftConfig(**GCFG, use_pallas=True)
    for r in fleet_out:
        for key, call in r["tasks"][2]["calls"].items():
            name = key.split("/")[0]
            want = {k: v for k, v in la.expected_sharded_launches(cfg, name).items() if v}
            assert call["launches"] == want, (r["rank"], key)
    for name in ("graft", "streaming_graft", "loss_topk"):
        for step in range(STEPS):
            got = _assert_ranks_agree(fleet_out, 2, f"{name}/{step}")["state"]
            plain = fleet_out[0]["tasks"][0]["calls"][f"{name}/{step}"]["state"]
            torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-6)
            assert torch.equal(got["pivots"], plain["pivots"])

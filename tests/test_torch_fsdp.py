"""Parameter sharding under JAX's ``fsdp`` preset (ZeRO-3) against the JAX
package, on the CPU.

* ``params_logical`` and ``train_state_logical`` (AdamW, SGD, Lion,
  Adafactor) equal JAX's leaf by leaf for all ten archs' smoke configs,
  ``params_logical`` also at full size for the non-MoE archs: each block of
  the port's list takes the JAX tuple without its leading ``layers``.
* Each leaf's shard shape equals ``NamedSharding(AbstractMesh(...),
  spec).shard_shape`` of JAX's spec (``logical_to_spec`` and
  ``drop_indivisible``) for every non-MoE arch on the (16, 16) pod and on
  two pods (2, 16, 16), at full width (JAX's tree traced at 2 layers: no
  shard shape depends on the depth); no compile.
* One 4-rank gloo fleet on a (2, 2) ``("data", "model")`` mesh
  (``python -m repro_torch.backend --worker --job``, ``backend/fleet.py``)
  runs 3 steps under ``sharding_rules(mesh, RULE_PRESETS["fsdp"])``, float32,
  from the same weights (seed 0, in JAX's layout as numpy) through
  ``jax_bridge.sharded_params_from_numpy``, for four cases (``CASES``):
  ``graft_train_step`` with a refresh every 2 for the minicpm-2b smoke
  config with 3 KV heads (``wk``/``wv``'s 3 heads do not divide the model
  axis: ``drop_indivisible`` leaves them sharded over data alone), for the
  rwkv6-7b smoke config, and for minicpm-2b with ``rset=(2,)`` (the 2
  subset rows split over data alone: the rank at model index 1 holds its
  peer's rows and its loss counts zero); and ``baseline_train_step`` on a
  global batch of 2 (split over data alone: each counted rank's mean
  scaled by 1/2, its model peer's by 0). Each is held against
  ``jax.jit(repro.launch.steps.make_train_step)`` with no mesh on the same
  global batches, run in a process of its own a case: pivots and ranks
  EXACT, losses at rtol 1e-4, the grad norm at rtol 1e-5 (a replicated
  leaf counted twice would be off by far more); each leaf of the first
  moment after step 0 (the clipped gradient times 1 - beta1, gathered)
  at the families' gradient tolerance (rtol 1e-4, atol 1e-4 of the leaf's
  largest element, ``test_torch_rwkv.py``'s: the rwkv6 smoke model's
  gradients differ from JAX's by up to 5e-5 of a leaf in one process),
  which catches a wrong gradient on a leaf too small to move the norm
  (AdamW's update would not show a scale error); each leaf of the gathered params after 3
  steps at 1e-4 relative (Frobenius): AdamW moves an element by about lr
  whatever its gradient's size, so where a gradient is near 0 the step
  follows the summation order — one process of the port differs from JAX
  the same way (1 of rwkv's 16384 embedding elements by 1.2e-4, the zero-
  initialised norm scales by up to 1e-7), which the families' elementwise
  1e-5 does not admit; shard then gather bit-equal; each rank's resident
  params and moments exactly its shards' bytes; launches as
  ``expected_launches(sharded=True)`` reckons. The same fleet runs the
  mesh's dim-1 gather and reduce-scatter over every tuple of axes. The
  fleet and JAX's processes run beside the module's other tests.
* The dry run's ``fsdp`` cells on the CPU stand-in at smoke size: one
  non-MoE arch a family reports ``"state": "sharded"``; on a (2, 2) mesh the
  argument bytes equal JAX's shard sizes (each rounded to the allocator's
  512-byte blocks) plus the replicated rest; under ``remat="full"`` the
  peak is below the replicated cell's on the same mesh.
* The refusals: ``grad_mode="full"`` on a sharded state (A18), the
  ``head_tp`` preset's head-parallel rule set (ROADMAP.md A13), a MoE
  model's chunk-major groups and microbatches under a mesh (A14c). What
  was refused before runs: the ``default`` preset on the hybrid family
  (every family runs it, ``tests/test_torch_tp.py``), the sharded step
  under Adafactor and on the MoE family, on a (1, 1) mesh, bit-equal to
  one process.
"""
import contextlib
import dataclasses
import functools
import threading

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro import configs as jconfigs
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.distributed import sharding as jsharding
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro.optim import OptimizerConfig as JOptCfg
from repro.selection.base import GraftConfig as JGraftConfig
from repro_torch import configs as tconfigs
from repro_torch.backend import LocalBackend, LocalBackendConfig, fleet, make_mesh
from repro_torch.distributed import sharding as tsharding
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tspecs
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tmodel
from repro_torch.optim import OptimizerConfig as TOptCfg
from repro_torch.selection.base import GraftConfig as TGraftConfig

ARCHS = list(jconfigs.CANONICAL_IDS)
DENSE = [a for a in ARCHS if tconfigs.get_config(a).family != "moe"]
# the smallest smoke config of each non-MoE family
ONE_A_FAMILY = ["minicpm-2b", "rwkv6-7b", "musicgen-medium", "internvl2-26b", "hymba-1.5b"]
CARD = dict(stand_in=not torch.cuda.is_available())
OPT = dict(name="adamw", learning_rate=3e-4, schedule="cosine", total_steps=8, warmup_steps=1)
# the port routes its refresh through graft_select (the plain version on the
# CPU, counted by the launch audit); JAX's plain chain (``use_pallas`` off in
# its job) selects alike and compiles in a fraction of its interpret-mode
# Pallas kernel's time
GC = dict(rset=(2, 4), eps=0.25, refresh_every=2, use_pallas=True)
STEPS, K, SEQ = 3, 8, 16
MINICPM = dict(param_dtype="float32", num_kv_heads=3)
# the fleet's cases: arch, model overrides, GRAFT config (None: the
# baseline step), global batch, and the (batch, subset) axes it splits over
CASES = {
    "minicpm-2b": dict(arch="minicpm-2b", model=MINICPM, graft=GC, K=K,
                       axes=(["data", "model"], ["data", "model"])),
    "rwkv6-7b": dict(arch="rwkv6-7b", model=dict(param_dtype="float32"), graft=GC, K=K,
                     axes=(["data", "model"], ["data", "model"])),
    "minicpm-2b-subset-over-data": dict(arch="minicpm-2b", model=MINICPM,
                                        graft=dict(GC, rset=(2,)), K=K,
                                        axes=(["data", "model"], ["data"])),
    "minicpm-2b-baseline": dict(arch="minicpm-2b", model=MINICPM, graft=None, K=2,
                                axes=(["data"], ["data"])),
}
FLEET_TIMEOUT_S = 150


def _is_logical(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def _stacked(port_logical):
    """The port's logical tree in JAX's layout: ``blocks`` one tree whose
    leaves are the per-block tuple behind ``layers`` (every block's the
    same)."""
    out = dict(port_logical)
    blocks = port_logical["blocks"]
    assert all(b == blocks[0] for b in blocks)
    out["blocks"] = jax.tree_util.tree_map(lambda lg: ("layers",) + lg, blocks[0],
                                           is_leaf=_is_logical)
    return out


JAX_LAYERS = 2


@functools.lru_cache(maxsize=None)
def _full_size(arch):
    """(JAX config and its abstract params at full width and ``JAX_LAYERS``
    layers, port config, a port Model on the meta device at full size),
    made once for the module. A leaf's shard shape does not depend on the
    depth (``layers`` maps to no mesh axis), and JAX's ``eval_shape`` of
    an init traces every layer (0.5-1 s at full depth, 0.03 s at 2)."""
    jcfg = jconfigs.get_config(arch, num_layers=JAX_LAYERS)
    tcfg = tconfigs.get_config(arch)
    jparams = jax.eval_shape(lambda k: jmodel.init_params(jcfg, k), jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg, tmodel.Model(tcfg, device="meta")


# ---------------------------------------------------------------------------
# the logical trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_params_logical_equals_jax(arch):
    """Every arch's smoke config (the full-size trees of the non-MoE archs
    are held in ``test_shard_shapes_equal_jax``)."""
    jcfg, tcfg = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    jparams = jax.eval_shape(lambda k: jmodel.init_params(jcfg, k), jax.random.PRNGKey(0))
    want = jmodel.params_logical(jcfg, jparams)
    got = tmodel.params_logical(tcfg, tmodel.Model(tcfg, device="meta"))
    assert len(got["blocks"]) == tcfg.num_layers - tcfg.first_k_dense
    assert ("first_blocks" in got) == (tcfg.first_k_dense > 0)
    assert _stacked(got) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_logical_equals_jax(arch):
    """The arch's smoke state under each optimizer's config: params, opt,
    step, graft, sampler_carry and health (neither side reads the state's
    own moments, so one state serves the four)."""
    jm, tm = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    jstate = jax.eval_shape(lambda k: jsteps.init_train_state(
        jm, jsteps.TrainConfig(graft=JGraftConfig(rset=(2, 4))), k, K), jax.random.PRNGKey(0))
    tstate = tsteps.init_train_state(tm, tsteps.TrainConfig(graft=TGraftConfig(rset=(2, 4))),
                                     torch.Generator().manual_seed(0), K)
    for opt in ("adamw", "sgd", "lion", "adafactor"):
        jt = jsteps.TrainConfig(optimizer=JOptCfg(name=opt), graft=JGraftConfig(rset=(2, 4)))
        tt = tsteps.TrainConfig(optimizer=TOptCfg(name=opt), graft=TGraftConfig(rset=(2, 4)))
        want = jsteps.train_state_logical(jm, jt, jstate)
        got = tsteps.train_state_logical(tm, tt, tstate)
        assert _stacked(got["params"]) == want["params"], opt
        if opt == "adafactor":
            assert got["opt"] == want["opt"]
        else:
            assert {k: _stacked(v) for k, v in got["opt"].items()} == want["opt"], opt
        assert got["step"] == want["step"] == ()
        assert got["graft"]._asdict() == want["graft"]._asdict()
        assert got["sampler_carry"] == want["sampler_carry"] == {}
        assert got["health"] == want["health"]


# ---------------------------------------------------------------------------
# shard shapes against JAX's NamedSharding
# ---------------------------------------------------------------------------

def _leaves(tree, path=()):
    if _is_logical(tree) or not isinstance(tree, (dict, list)):
        return [(path, tree)]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return [x for k, v in items for x in _leaves(v, path + (k,))]


@pytest.mark.parametrize("arch", DENSE)
def test_shard_shapes_equal_jax(arch):
    jcfg, jparams, tcfg, model = _full_size(arch)
    jlogical = jmodel.params_logical(jcfg, jparams)
    tree = model.tree()
    tlogical = tmodel.params_logical(tcfg, tree)
    assert _stacked(tlogical) == jlogical
    for sizes, names in (((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))):
        jmesh = AbstractMesh(sizes, names)
        tmesh_ = tmesh.make_mesh(sizes, names)
        want, jleaves = {}, dict(_leaves(jparams))
        for path, lg in _leaves(jlogical):
            leaf = jleaves[path]
            spec = jsharding.drop_indivisible(jsharding.logical_to_spec(lg, jmesh), leaf.shape,
                                              jmesh)
            want[path] = NamedSharding(jmesh, spec).shard_shape(leaf.shape)
        tleaves = dict(_leaves(tree))
        for path, lg in _leaves(tlogical):
            t = tleaves[path]
            got = tsharding.leaf_sharding(t.shape, lg, tmesh_)
            if path[0] == "blocks":
                jpath = ("blocks",) + path[2:]
                assert (JAX_LAYERS,) + got.local_shape == want[jpath], (sizes, path)
            else:
                assert got.local_shape == want[path], (sizes, path)


def test_shard_then_gather_in_process():
    """On a one-rank mesh every leaf stays whole; ``shard_tensor`` cuts the
    rank's block of a spec that splits, and ``gather_tensor`` over a mesh
    of size one gives it back unchanged."""
    mesh = make_mesh((1, 1), ("data", "model"), LocalBackend(LocalBackendConfig()))
    s = tsharding.leaf_sharding((8, 6), ("embed", "mlp"), mesh)
    assert s.spec == ("data", "model") and not s.is_sharded and s.counted()
    x = torch.arange(48.0).reshape(8, 6)
    assert tsharding.shard_tensor(x, s) is x
    assert torch.equal(tsharding.gather_tensor(x, s), x)
    abstract = tmesh.make_mesh((2, 2), ("data", "model"))
    s = tsharding.leaf_sharding((8, 6), ("embed", "mlp"), abstract)
    assert s.local_shape == (4, 3) and s.bounds == ((0, 4), (0, 3)) and s.is_sharded
    shard = tsharding.shard_tensor(x, s)
    assert torch.equal(shard, x[:4, :3]) and shard.untyped_storage().nbytes() == 12 * 4


# ---------------------------------------------------------------------------
# the dry run's fsdp cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ONE_A_FAMILY)
def test_fsdp_cell_runs_sharded(arch):
    res = dryrun.run_cell(arch, "train_4k", "single", "graft", smoke=True,
                          rules_preset="fsdp", **CARD)
    assert res["state"] == "sharded" and res["rules_preset"] == "fsdp"
    assert res["argument_bytes_per_device"] == res["full"]["memory"]["argument_size_in_bytes"]
    assert res["full"]["memory"]["fits"]


def _round(n):
    return -(-n // dryrun.BLOCK_BYTES) * dryrun.BLOCK_BYTES


def test_fsdp_cell_argument_bytes_are_jax_shards():
    """minicpm-2b smoke on one device of (2, 2): the params and AdamW
    moments are JAX's shards of ``jax.eval_shape(init_train_state)``'s
    leaves under ``train_state_logical``; the rest (GRAFT state, this
    device's batch rows) is the port's, replicated."""
    import dataclasses
    from repro.launch import specs as jspecs
    mesh = tmesh.make_mesh((2, 2), ("data", "model"))
    backend = dryrun.RecordingBackend(mesh.size)
    rules = dict(tsharding.DEFAULT_RULES, **tspecs.RULE_PRESETS["fsdp"])
    cell = tspecs.build_cell("minicpm-2b", "train_4k", smoke=True, batch_shards=4,
                             backend=backend, mesh=dryrun.RecordingMesh(mesh, backend),
                             rules=rules, **CARD)
    res = dryrun.trace(cell, backend)
    jm = jconfigs.get_smoke_config("minicpm-2b")
    jt = dataclasses.replace(jspecs.default_train_config("minicpm-2b", batch=4), sentinel=False)
    jstate = jax.eval_shape(lambda k: jsteps.init_train_state(jm, jt, k, 4),
                            jax.random.PRNGKey(0))
    logical = jsteps.train_state_logical(jm, jt, jstate)
    jmesh = AbstractMesh((2, 2), ("data", "model"))
    shards = 0
    for section in ("params", "opt"):
        jleaves = dict(_leaves(jstate[section]))
        for path, lg in _leaves(logical[section]):
            leaf = jleaves[path]
            spec = jsharding.drop_indivisible(jsharding.logical_to_spec(lg, jmesh), leaf.shape,
                                              jmesh)
            shape = NamedSharding(jmesh, spec).shard_shape(leaf.shape)
            stacked = "blocks" in path                # one storage a block in the port
            per = int(np.prod(shape[1:] if stacked else shape)) * leaf.dtype.itemsize
            shards += (shape[0] if stacked else 1) * _round(per)
    state, batch = cell.abstract_args
    rest = [*state["graft"], *batch.values()]
    assert cell.batch == 1 and state["sampler_carry"] == {}
    assert res["memory"]["argument_size_in_bytes"] == shards + sum(
        _round(t.numel() * t.element_size()) for t in rest)


def test_fsdp_remat_full_peaks_below_replicated(monkeypatch):
    """minicpm-2b's smoke config with ``remat="full"`` (the full-size
    configs' setting), replicated and sharded on one (2, 2) mesh."""
    smoke, built = tconfigs.get_smoke_config, []
    me = threading.current_thread()

    def full_remat(arch, **kw):
        if threading.current_thread() is not me:     # the module's fleet, still preparing
            return smoke(arch, **kw)
        built.append(smoke(arch, **dict(kw, remat="full")))
        return built[-1]
    monkeypatch.setattr(tconfigs, "get_smoke_config", full_remat)
    mesh = tmesh.make_mesh((2, 2), ("data", "model"))
    fsdp = dryrun.run_cell("minicpm-2b", "train_4k", "t", "graft", smoke=True,
                           mesh_override=mesh, rules_preset="fsdp", **CARD)
    # the replicated state with the batch over data, as the default preset
    # ran before it sharded the dense archs' train cells
    backend = dryrun.RecordingBackend(2)
    replicated = dryrun.trace(tspecs.build_cell("minicpm-2b", "train_4k", smoke=True,
                                                batch_shards=2, backend=backend, **CARD),
                              backend)
    assert [c.remat for c in built] == ["full", "full"]
    mem = {"fsdp": fsdp["full"]["memory"], "default": replicated["memory"]}
    assert mem["fsdp"]["peak_bytes"] < mem["default"]["peak_bytes"]
    assert mem["fsdp"]["argument_size_in_bytes"] < mem["default"]["argument_size_in_bytes"]
    coll = fsdp["full"]["collectives"]["count_by_op"]
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_sharded_step_refusals():
    mesh = make_mesh((1, 1), ("data", "model"), LocalBackend(LocalBackendConfig()))
    mcfg = tconfigs.get_smoke_config("minicpm-2b")
    fsdp = tspecs.RULE_PRESETS["fsdp"]
    tt = tsteps.TrainConfig(graft=TGraftConfig(rset=(2, 4), grad_mode="full"))
    with tsharding.sharding_rules(mesh, fsdp), pytest.raises(ValueError, match="per-sample"):
        tsteps.init_train_state(mcfg, tt, torch.Generator().manual_seed(0), K)
    tt = tsteps.TrainConfig(graft=TGraftConfig(rset=(2, 4)))
    with tsharding.sharding_rules(mesh, tspecs.RULE_PRESETS["head_tp"]), \
            pytest.raises(ValueError, match="A13"):
        tsteps.make_train_step(mcfg, tt)
    hybrid = tconfigs.get_smoke_config("hymba-1.5b")
    assert tsharding.check_rules(mesh, {}, "hybrid") == "default"
    with tsharding.sharding_rules(mesh, {}):
        assert callable(tsteps.make_train_step(hybrid, tt))
    moe = tconfigs.get_smoke_config("qwen3-moe-235b-a22b")
    local = dataclasses.replace(moe, moe_local_groups=True)
    for preset in (fsdp, {}):
        with tsharding.sharding_rules(mesh, preset), pytest.raises(ValueError, match="A14c"):
            tsteps.init_train_state(local, tt, torch.Generator().manual_seed(0), 64)
    accumulate = tsteps.TrainConfig(microbatches=2)
    with tsharding.sharding_rules(mesh, fsdp), pytest.raises(ValueError, match="A14c"):
        tsteps.make_train_step(moe, accumulate)
    state = tsteps.init_train_state(mcfg, tt, torch.Generator().manual_seed(0), K)
    with tsharding.sharding_rules(mesh, fsdp):
        step = tsteps.make_train_step(mcfg, tt)
    with pytest.raises(ValueError, match="sharded state"):
        step(state, {})


@pytest.mark.parametrize("arch,opt", [("minicpm-2b", "adafactor"),
                                      ("qwen3-moe-235b-a22b", "adamw"),
                                      ("kimi-k2-1t-a32b", "adafactor")])
def test_sharded_step_runs_moe_and_adafactor(arch, opt):
    """What the sharded step refused before: Adafactor on a sharded state
    (its factored moments a shard's rows and columns of the leaf's) and the
    MoE family, on a (1, 1) mesh, against the same step on one process:
    the same loss and grad norm, bit for bit."""
    mesh = make_mesh((1, 1), ("data", "model"), LocalBackend(LocalBackendConfig()))
    mcfg = tconfigs.get_smoke_config(arch)
    tt = tsteps.TrainConfig(optimizer=TOptCfg(name=opt), graft=TGraftConfig(rset=(2, 4)))
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(DataConfig(
        vocab_size=mcfg.vocab_size, seq_len=16, global_batch=K)).batch_at(0).items()}
    got = []
    for rules in (tspecs.RULE_PRESETS["fsdp"], None):
        with (tsharding.sharding_rules(mesh, rules) if rules is not None
              else contextlib.nullcontext()):
            state = tsteps.init_train_state(mcfg, tt, torch.Generator().manual_seed(0), K)
            step = tsteps.make_train_step(mcfg, tt)
        for _ in range(2):
            state, metrics = step(state, batch)
        got.append((float(metrics["loss"]), float(metrics["grad_norm"])))
        if rules is not None:
            assert "layout" in state and ("m" in state["opt"]) == (opt == "adamw")
    assert got[0] == got[1]


# ---------------------------------------------------------------------------
# the 4-rank fleet against jax.jit(make_train_step)
# ---------------------------------------------------------------------------

def _batches(vocab, k):
    data = SyntheticLM(DataConfig(vocab_size=vocab, seq_len=SEQ, global_batch=k))
    return [data.batch_at(s) for s in range(STEPS)]


# JAX's side, in two processes beside the fleet and the module's other
# tests, each taking every other case (one import of JAX a process): the
# weights (numpy, JAX's layout) put into ``jax.jit(init_train_state)``'s
# state, then ``STEPS`` jitted steps
_JAX_SCRIPT = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro import configs
from repro.launch import steps
from repro.optim import OptimizerConfig
from repro.selection.base import GraftConfig
for path in sys.argv[1:]:
    with open(path + ".pkl", "rb") as f:
        job = pickle.load(f)
    jm = configs.get_smoke_config(job["arch"], **job["model"])
    graft = GraftConfig(**job["graft"]) if job["graft"] else None
    jt = steps.TrainConfig(optimizer=OptimizerConfig(**job["opt"]), graft=graft,
                           probe_positions=8)
    state = jax.jit(lambda k: steps.init_train_state(jm, jt, k, job["K"]))(jax.random.PRNGKey(0))
    state["params"] = jax.tree_util.tree_map(jnp.asarray, job["params"])
    fn = jax.jit(steps.make_train_step(jm, jt))
    res = {"losses": [], "grad_norms": [], "ranks": [], "pivots": {}}
    for step, b in enumerate(job["batches"]):
        state, met = fn(state, {k: jnp.asarray(v) for k, v in b.items()})
        res["losses"].append(float(met["loss"]))
        res["grad_norms"].append(float(met["grad_norm"]))
        if step == 0:
            res["m0"] = jax.tree_util.tree_map(np.asarray, state["opt"]["m"])
        if graft is not None:
            res["ranks"].append(int(met["rank"]))
            if step % graft.refresh_every == 0:
                res["pivots"][step] = np.asarray(state["graft"].pivots).tolist()
    res["final"] = jax.tree_util.tree_map(np.asarray, state["params"])
    with open(path + ".out", "wb") as f:
        pickle.dump(res, f)
"""
JAX_PROCESSES = 2


def _init(case):
    """The port's init from seed 0 as JAX's param tree (numpy): the weights
    both sides start from."""
    from repro_torch.checkpoint import params_to_numpy
    mcfg = tconfigs.get_smoke_config(case["arch"], **case["model"])
    return params_to_numpy(tmodel.init_params(mcfg, torch.Generator().manual_seed(0)))


def _fsdp_task(case, init, batches):
    return {"kind": "fsdp", "mesh": ((2, 2), ("data", "model")), "arch": case["arch"],
            "smoke": True, "model": case["model"], "steps": STEPS,
            "tcfg": {"optimizer": OPT, "graft": case["graft"], "probe_positions": 8},
            "params": jax.tree_util.tree_map(torch.from_numpy, init),
            "batches": [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]}


class _Fleet:
    """The fleet and JAX's runs, started when the module starts and run
    beside its other tests: a thread draws the weights and writes the
    jobs, then the fleet's ranks and one JAX process a case run at once."""

    def __init__(self, work):
        self.work, self.got, self.errors = work, {}, []
        self.threads = [threading.Thread(target=self._run, args=("prep", self._start))]
        self.threads[0].start()

    def _start(self):
        import pickle
        import sys
        work = self.work
        job, jax_jobs = [], []
        for name, case in CASES.items():
            init = _init(case)
            batches = _batches(tconfigs.get_smoke_config(case["arch"]).vocab_size, case["K"])
            job.append(_fsdp_task(case, init, batches))
            graft = case["graft"] and dict(case["graft"], use_pallas=False)
            with open(work / f"jax_{name}.pkl", "wb") as f:
                pickle.dump({"arch": case["arch"], "model": case["model"], "opt": OPT,
                             "graft": graft, "K": case["K"], "params": init,
                             "batches": batches}, f)
            jax_jobs.append(str(work / f"jax_{name}"))
        jax_cmds = [[sys.executable, "-c", _JAX_SCRIPT, *jax_jobs[i::JAX_PROCESSES]]
                    for i in range(JAX_PROCESSES)]
        job.append({"kind": "collectives", "mesh": ((2, 2), ("a", "b")),
                    "axes": [("a",), ("b",), ("a", "b"), ("b", "a")]})
        torch.save(job, work / "job.pt")
        port = fleet.free_port()
        cmds = [fleet.mesh_worker_command(str(work / "job.pt"), str(work / "out"),
                                          fleet.backend_overrides(4, r, port), device="cpu")
                for r in range(4)]
        jax_env = fleet.fleet_env(JAX_PROCESSES, {"JAX_PLATFORMS": "cpu"})
        more = [threading.Thread(target=self._run, args=(
                    "fleet", lambda: fleet.launch(cmds, timeout=FLEET_TIMEOUT_S))),
                threading.Thread(target=self._run, args=(
                    "jax", lambda: fleet.launch(jax_cmds, timeout=FLEET_TIMEOUT_S,
                                                env=jax_env)))]
        for t in more:
            t.start()
        self.threads += more

    def _run(self, key, fn):
        try:
            self.got[key] = fn()
        except BaseException as e:                  # noqa: BLE001 — raised in result()
            self.errors.append(e)

    def join(self):
        self.threads[0].join()              # it starts the others
        for t in self.threads[1:]:
            t.join()

    def result(self):
        import pickle
        self.join()
        if self.errors:
            raise self.errors[0]
        summaries = [r.last_json() for r in self.got["fleet"]]
        assert [s["rank"] for s in summaries] == [0, 1, 2, 3]
        ranks = [torch.load(s["path"], weights_only=True)["tasks"] for s in summaries]
        jax_runs = {}
        for name in CASES:
            with open(self.work / f"jax_{name}.out", "rb") as f:
                jax_runs[name] = pickle.load(f)
        return ranks, jax_runs


@pytest.fixture(scope="module", autouse=True)
def background(tmp_path_factory):
    bg = _Fleet(tmp_path_factory.mktemp("fsdp"))
    yield bg
    bg.join()


@pytest.fixture(scope="module")
def runs(background):
    """(the fleet's results, one list of task results a rank; JAX's runs by
    case)."""
    return background.result()


@pytest.mark.parametrize("case", list(CASES))
def test_fleet_matches_jax_step(case, runs):
    ranks, jax_runs = runs
    want = jax_runs[case]
    task = list(CASES).index(case)
    for rank in ranks:
        got = rank[task]
        assert got["gather_exact"]                    # JAX params → shard → gather
        assert got["ranks"] == want["ranks"]
        assert {int(k): v for k, v in got["pivots"].items()} == want["pivots"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
        np.testing.assert_allclose(got["grad_norms"], want["grad_norms"], rtol=1e-5)
        assert got["resident_bytes"] == got["shard_bytes"]
        assert got["launches"] == {k: v for k, v in got["launches_expected"].items() if v}
        assert (got["batch_axes"], got["subset_axes"]) == CASES[case]["axes"]
    from repro_torch.checkpoint import params_to_numpy
    # step 0's gradients, leaf by leaf (through AdamW's first moment), at
    # the families' gradient tolerance; then the parameters after the last
    # step: AdamW steps an element by about ±lr whatever its gradient's
    # size, so where a gradient is near 0 the step follows the summation
    # order (the one-process port differs from JAX alike) and each leaf is
    # held as a whole
    for key, want_tree in (("m0", want["m0"]), ("params", want["final"])):
        want_leaves = dict(_leaves(want_tree))
        got_leaves = _leaves(params_to_numpy(ranks[0][task][key]))
        assert len(got_leaves) == len(want_leaves), key
        for path, g in got_leaves:
            w = want_leaves[path]
            if key == "m0":
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                           err_msg=str(path))
            else:
                assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w), path


def test_fleet_shards_every_leaf_it_can(runs):
    """minicpm's 3 KV heads do not divide the model axis: ``wk`` is split
    over data alone (replicated over model), ``wq``'s 6 heads over both;
    the embedding's d_model over data; the norms stay whole. Each rank's
    shards differ, and every rank's shard shape is the same."""
    ranks, _ = runs
    specs = {r[0]["specs"][i][0]: r[0]["specs"][i][1:] for r in ranks[:1]
             for i in range(len(r[0]["specs"]))}
    assert specs["blocks.0.attn.wk"][0] == ["data", None, None]
    assert specs["blocks.0.attn.wk"][2] == [36, 3, 12]
    assert specs["blocks.0.attn.wq"][0] == ["data", "model", None]
    assert specs["blocks.0.mlp.w_up"][0] == ["data", "model"]
    assert specs["embed"][0] == [None, "data"]
    assert specs["final_norm"][0] == [None]
    assert all(r[0]["specs"] == ranks[0][0]["specs"] for r in ranks)


def test_mesh_dim_gather_and_scatter(runs):
    """Rank r = 2a + b: its (2, 3) block ``arange(6) + 10 r`` gathered along
    dim 1 in rank order along the axes as given (bf16, bit for bit), and
    ``arange(24).reshape(3, 8) · (r + 1)`` reduce-scattered along dim 1:
    the member at index i keeps columns [i·8/n, (i+1)·8/n) of the sum."""
    ranks, _ = runs
    task = len(CASES)
    members = {"a": lambda a, b: [2 * i + b for i in range(2)],
               "b": lambda a, b: [2 * a + j for j in range(2)],
               "a,b": lambda a, b: [0, 1, 2, 3], "b,a": lambda a, b: [0, 2, 1, 3]}
    wide = np.arange(24, dtype=np.float32).reshape(3, 8)
    for rank in ranks:
        out = rank[task]
        a, b = out["coords"]["a"], out["coords"]["b"]
        for key, of in members.items():
            ids = of(a, b)
            grid = np.concatenate([np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r
                                   for r in ids], axis=1)
            assert torch.equal(out[key]["gather_dim1"],
                               torch.from_numpy(grid).to(torch.bfloat16)), key
            n, me = len(ids), out[key]["index"]
            total = wide * sum(r + 1 for r in ids)
            np.testing.assert_array_equal(out[key]["scatter_dim1"].numpy(),
                                          total[:, me * 8 // n:(me + 1) * 8 // n])

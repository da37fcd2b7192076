"""The port's execution backend and data-parallel training on the CPU.

In process, against the JAX package's functions (no mesh):
* the registry, ``resolve``, one config class per backend, and the tagged,
  hash-neutral ``backend`` section (the port's ``config_hash`` of a config
  with a multiprocess section equals JAX's);
* ``shard_for_backend`` on the local, split and indivisible cases, and the
  refusal of an ``R_max`` the process count does not divide;
* ``BatchStager`` beside JAX's on the same source, depth 0 and 2, with its
  consumed state and ``reset``;
* the int8 compression beside JAX's, the error-feedback reduce beside
  ``jax.vmap(ef_compressed_psum, axis_name="data")`` over two shards;
* world size 1 over gloo, in process: losses and pivots bit-equal to the
  local backend's over 6 steps.

Fleets of ranks, each a subprocess (``backend/fleet.py``: every rank's
process group times out after 60 s, every fleet is killed after at most
120 s and fails with every rank's stderr):
* the 2-rank harness ``python -m repro_torch.backend --json``: step 0 at
  rtol 1e-5, later steps at 3e-3, pivots and rank of the first refresh equal
  to the 1-process run's and equal across ranks at every refresh, launches
  equal to the one-rank reckoning, JSONL from rank 0 alone, the manifest
  stamped {2, 2, replicated}, the 2 → 1 resume at 3e-3, and the compressed
  ``all_reduce`` of the ranks against JAX's reduce of their inputs;
* a 1 → 2 resume of a 1-process checkpoint;
* a 2-rank fleet under the ``nan_rollback`` fault plan, through
  ``python -m repro_torch.api --backend.kind=multiprocess``;
* a fleet whose ranks differ in ``optimizer.learning_rate``: both fail.
"""
import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import backend as jbackend
from repro.api.config import ExperimentConfig as JExperimentConfig
from repro.data import sources as jsources
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.distributed import compression as jcomp
from repro.distributed.pipeline import BatchStager as JBatchStager
from repro_torch import backend as tbackend
from repro_torch.api import ExperimentConfig
from repro_torch.backend import fleet
from repro_torch.backend.__main__ import BASE_OVERRIDES, STEPS, STOP_AFTER, check_fleet
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.data import sources as tsources
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed.pipeline import BatchStager

HARNESS_TIMEOUT_S = 110        # the harness's own fleet is held to 90 s
# one thread a rank: the smoke model needs no more, and the suite runs
# beside other workers
ENV = fleet.fleet_env(2, {"OMP_NUM_THREADS": "1"})


# ---------------------------------------------------------------------------
# registry and config
# ---------------------------------------------------------------------------

def test_registry_lists_both_backends_and_resolves_local():
    assert tbackend.available_backends() == jbackend.available_backends() == \
        ("local", "multiprocess")
    assert isinstance(tbackend.resolve(None), tbackend.LocalBackend)
    mp = tbackend.resolve(tbackend.MultiProcessBackendConfig(num_processes=2, process_id=1))
    assert isinstance(mp, tbackend.MultiProcessBackend)
    assert tbackend.resolve(mp) is mp
    assert (mp.process_count, mp.process_index, mp.is_primary) == (2, 1, False)
    assert mp.topology() == {"process_count": 2, "device_count": 2,
                             "shard_layout": "replicated"}
    assert tbackend.resolve(None).topology() == {"process_count": 1, "device_count": 1,
                                                 "shard_layout": "replicated"}


def test_one_config_class_per_backend():
    for name in ("local", "multiprocess"):
        entry = tbackend.get_backend(name)
        with pytest.raises(ValueError, match="one config class per backend"):
            tbackend.register_backend(tbackend.BackendEntry("dup", entry.config_cls, entry.build))
    assert [f.name for f in dataclasses.fields(tbackend.MultiProcessBackendConfig)] == \
        [f.name for f in dataclasses.fields(jbackend.MultiProcessBackendConfig)]
    assert tbackend.MultiProcessBackendConfig() == tbackend.MultiProcessBackendConfig(
        **dataclasses.asdict(jbackend.MultiProcessBackendConfig()))


@pytest.mark.parametrize("overrides", [
    [],
    ["backend.kind=local"],
    ["backend.kind=multiprocess"],
    ["backend.kind=multiprocess", "backend.num_processes=2", "backend.process_id=1",
     "backend.coordinator=10.0.0.1:4444", "backend.compress_reduce=true",
     "backend.prefetch=2"],
])
def test_backend_section_round_trips_and_hashes_as_jax(overrides):
    base = ["train.steps=6", "train.batch=8"]
    t = ExperimentConfig().apply_overrides(base + overrides)
    j = JExperimentConfig().apply_overrides(base + overrides)
    assert t.to_dict()["backend"] == j.to_dict()["backend"]
    assert t.finalized().to_json() == j.finalized().to_json()
    assert ExperimentConfig.from_json(t.to_json()) == t
    # hash-neutral: the section never changes which experiment it is
    assert t.config_hash() == j.config_hash() == \
        ExperimentConfig().apply_overrides(base).config_hash()


class _Shard:
    def __init__(self, n, i):
        self.n, self.i = n, i

    def data_shard(self):
        return self.n, self.i

    @property
    def process_count(self):
        return self.n


@pytest.mark.parametrize("num,index", [(1, 0), (2, 1), (4, 3), (3, 0)])
def test_shard_for_backend_matches_jax(num, index):
    t_cfg = DataConfig(vocab_size=64, seq_len=8, global_batch=8)
    j_cfg = JDataConfig(vocab_size=64, seq_len=8, global_batch=8)
    try:
        want = dataclasses.asdict(jsources.shard_for_backend(j_cfg, _Shard(num, index)))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tsources.shard_for_backend(t_cfg, _Shard(num, index))
        assert str(got.value) == str(e)
        return
    got = tsources.shard_for_backend(t_cfg, _Shard(num, index))
    assert dataclasses.asdict(got) == want
    if num > 1:
        # the shards' union is the 1-host batch, byte for byte
        whole = SyntheticLM(t_cfg).batch_at(3)["tokens"]
        part = SyntheticLM(got).batch_at(3)["tokens"]
        B = 8 // num
        np.testing.assert_array_equal(part, whole[index * B:(index + 1) * B])


def test_an_r_max_the_processes_do_not_divide_is_refused_at_build():
    cfg = ExperimentConfig().apply_overrides(
        ["train.batch=12", "graft.rset=[2,4,8]", "train.steps=2"])
    with pytest.raises(ValueError, match="graft R_max 8 does not divide over 3 processes"):
        cfg.build(backend=_Shard(3, 0))
    with pytest.raises(ValueError, match="global batch 12 does not divide over 8 processes"):
        cfg.build(backend=_Shard(8, 0))
    _, _, data = cfg.build(backend=_Shard(4, 2))
    assert data.cfg.host_index == 2 and data.batch_at(0)["tokens"].shape[0] == 3


# ---------------------------------------------------------------------------
# the batch stager
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [0, 2])
def test_batch_stager_matches_jax(depth):
    kw = dict(vocab_size=64, seq_len=8, global_batch=4, seed=3)
    t_src, j_src = SyntheticLM(DataConfig(**kw)), JSyntheticLM(JDataConfig(**kw))
    t_st = BatchStager(t_src, lambda b: {k: v.copy() for k, v in b.items()}, depth=depth)
    j_st = JBatchStager(j_src, lambda b: {k: v.copy() for k, v in b.items()}, depth=depth)
    try:
        def pull(n):
            for _ in range(n):
                tb, jb = next(t_st), next(j_st)
                for k in jb:
                    np.testing.assert_array_equal(tb[k], jb[k])
                assert t_st.consumed_state() == j_st.consumed_state()
                assert t_src.state_dict() == j_src.state_dict()   # lookahead included

        pull(3)
        assert t_st.consumed_state() == {"step": 3}
        # a rewind (restore / rollback) drops the lookahead
        t_src.load_state_dict({"step": 1})
        j_src.load_state_dict({"step": 1})
        t_st.reset()
        j_st.reset()
        assert t_st.consumed_state() == j_st.consumed_state() == {"step": 1}
        pull(2)
        assert t_st.consumed_state() == {"step": 3}
    finally:
        t_st.close()
        j_st.close()


# ---------------------------------------------------------------------------
# int8 error-feedback compression
# ---------------------------------------------------------------------------

def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape", [(7,), (256,), (3, 300), (2, 5, 64)])
def test_quantize_int8_matches_jax(shape):
    x = _rand(shape, 1, 3.0)
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    tq, ts = tcomp.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))            # exact payload
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7, atol=0)
    np.testing.assert_allclose(
        tcomp.dequantize_int8(tq, ts, shape, torch.float32).numpy(),
        np.asarray(jcomp.dequantize_int8(jq, js, shape, jnp.float32)), rtol=1e-7, atol=0)
    np.testing.assert_allclose(tcomp.quantization_error(torch.from_numpy(x)).numpy(),
                               np.asarray(jcomp.quantization_error(jnp.asarray(x))),
                               rtol=0, atol=1e-6)


def _jax_ef(grads, errors):
    """JAX's ef_compressed_psum over the stacked shards, one vmap lane each."""
    n = grads.shape[0]
    fn = jax.vmap(lambda g, e: jcomp.ef_compressed_psum(g, e, "data", n), axis_name="data")
    mean, err = fn(jnp.asarray(grads), jnp.asarray(errors))
    return np.asarray(mean), np.asarray(err)


def _port_ef(grads, errors):
    """The port's per-shard functions over the same shards, the two
    collectives done by hand: (q payloads, means, new errors)."""
    parts = [tcomp.ef_block_scales(torch.from_numpy(g), torch.from_numpy(e))
             for g, e in zip(grads, errors)]
    scale = torch.stack([s for _, s in parts]).amax(dim=0)                 # pmax
    qs = [tcomp.ef_quantize(b, scale, grads.shape[1:]) for b, _ in parts]
    summed = sum(q.to(torch.int32) for q, _ in qs)                        # exact psum
    mean = tcomp.ef_mean(summed, scale, len(grads), grads.shape[1:])
    return ([q for q, _ in qs], [mean.numpy()] * len(grads),
            [e.numpy() for _, e in qs], scale)


@pytest.mark.parametrize("shape", [(300,), (4, 129)])
def test_ef_compressed_psum_matches_jax_over_two_shards(shape):
    grads = np.stack([_rand(shape, 2), _rand(shape, 3, 5.0)])
    errors = np.zeros_like(grads)
    for _ in range(3):                          # the error carries over calls
        jmean, jerr = _jax_ef(grads, errors)
        qs, tmeans, terrs, scale = _port_ef(grads, errors)
        for s in range(2):
            # the payload JAX sends: the same rounding under the same scale
            blocks = tcomp._blocks(torch.from_numpy(grads[s] + errors[s]))
            want_q = np.clip(np.round(blocks.numpy() / scale.numpy()[:, None]), -127, 127)
            np.testing.assert_array_equal(qs[s].numpy(), want_q.astype(np.int8))
            np.testing.assert_allclose(tmeans[s], jmean[s], rtol=0, atol=1e-6)
            np.testing.assert_allclose(terrs[s], jerr[s], rtol=0, atol=1e-6)
        errors = np.stack(terrs)
        grads = grads * np.float32(0.7)


def test_ef_compressed_psum_with_collectives_matches_jax_on_one_shard():
    g, e = _rand((3, 100), 5), _rand((3, 100), 6, 0.01)
    mean, err = tcomp.ef_compressed_psum(torch.from_numpy(g), torch.from_numpy(e), 1,
                                         lambda t: t, lambda t: t)
    jmean, jerr = _jax_ef(g[None], e[None])
    np.testing.assert_allclose(mean.numpy(), jmean[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(err.numpy(), jerr[0], rtol=0, atol=1e-6)
    (m2,), (e2,) = tcomp.ef_compressed_psum_tree([torch.from_numpy(g)], [torch.from_numpy(e)],
                                                 1, lambda t: t, lambda t: t)
    np.testing.assert_array_equal(m2.numpy(), mean.numpy())
    np.testing.assert_array_equal(e2.numpy(), err.numpy())


# ---------------------------------------------------------------------------
# world size 1 over gloo, in this process
# ---------------------------------------------------------------------------

SMOKE = ["train.steps=6", "train.batch=8", "train.seq=16", "graft.rset=[2,4]",
         "graft.refresh_every=2", "graft.use_pallas=true", "train.log_every=0"]


def test_world_size_one_over_gloo_is_bit_equal_to_local(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_DIST_TIMEOUT_S", str(fleet.DIST_TIMEOUT_S))
    local = fleet.run_worker(SMOKE, device="cpu")
    one = fleet.run_worker(SMOKE + fleet.backend_overrides(1, 0, fleet.free_port()),
                           device="cpu")
    assert (local["backend"], one["backend"], one["collectives"]) == \
        ("local", "multiprocess", "gloo")
    assert one["losses"] == local["losses"]                  # bit-equal floats
    assert one["pivots"] == local["pivots"] and one["ranks"] == local["ranks"]
    assert one["launches"] == local["launches"]
    assert len(one["reduce_s"]) == 6                         # one reduce a step
    # the float32 all_reduce of one rank is its input
    probe = fleet.all_reduce_probe_inputs(0)
    for call in one["all_reduce"]:
        np.testing.assert_array_equal(np.asarray(call["vec"], np.float32), probe["vec"])
        assert call["scalar"] == float(probe["scalar"])
    assert not torch.distributed.is_initialized()            # torn down


@pytest.mark.parametrize("batch,world", [(8, 2), (12, 3)])
def test_eval_shards_average_to_the_eval_of_their_union(batch, world):
    """Each rank evaluates an equal share of the eval batch (at most 8,
    rounded up to a multiple of the process count: 9 for 3 ranks), and the
    mean of the ranks' results is one process's eval of those examples."""
    from repro_torch.data.sources import entry_for_config
    from repro_torch.launch import evaluate
    from repro_torch.models import model as model_lib

    cfg = ExperimentConfig().apply_overrides([f"train.batch={batch}", "train.seq=16"])
    mcfg, _, _ = cfg.build()
    params = model_lib.init_params(mcfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    shares = []
    for r in range(world):
        mp = tbackend.resolve(tbackend.MultiProcessBackendConfig(num_processes=world,
                                                                 process_id=r))
        mp.reduce_tensors = lambda values, op: list(values)     # this rank's share
        shares.append(evaluate.make_eval_fn_for(cfg, mcfg, device="cpu", backend=mp)(params))
    eval_batch = -(-min(batch, 8) // world) * world
    dcfg = cfg.finalized().data
    union = entry_for_config(dcfg).build(dataclasses.replace(dcfg, global_batch=eval_batch))
    whole = evaluate._lm_eval(mcfg, [union.batch_at(evaluate.EVAL_STEP_OFFSET + i)
                                     for i in range(4)], "cpu")(params)
    np.testing.assert_allclose(np.mean([x["eval_loss"] for x in shares]), whole["eval_loss"],
                               rtol=1e-5, atol=0)
    if eval_batch == min(batch, 8):         # the one-process eval's own examples
        one = evaluate.make_eval_fn_for(cfg, mcfg, device="cpu")(params)
        assert one["eval_loss"] == whole["eval_loss"]


# ---------------------------------------------------------------------------
# fleets
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """One run of ``python -m repro_torch.backend --json --device=cpu``."""
    work = str(tmp_path_factory.mktemp("fleet"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.backend", "--json", "--device=cpu",
         f"--workdir={work}", "--timeout=90"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=ENV, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=HARNESS_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)         # the harness and its ranks
        out, err = proc.communicate()
        pytest.fail(f"the harness timed out and was killed:\n{err[-6000:]}")
    assert proc.returncode == 0, err[-6000:] + out[-3000:]
    return work, out, json.loads(out.strip().splitlines()[-1])


def test_harness_two_ranks_track_one_and_resume_on_one(harness):
    work, stdout, out = harness
    ref, ranks = out["reference"], out["ranks"]
    assert [r["process_index"] for r in ranks] == [0, 1]
    ref_loss = {int(k): v for k, v in ref["losses"].items()}
    for r in ranks:
        assert r["collectives"] == "gloo"
        loss = {int(k): v for k, v in r["losses"].items()}
        assert sorted(loss) == list(range(STOP_AFTER))
        np.testing.assert_allclose(loss[0], ref_loss[0], rtol=1e-5, atol=0)
        for s in loss:
            np.testing.assert_allclose(loss[s], ref_loss[s], rtol=3e-3, atol=0)
        # pivots and rank at the first refresh equal the 1-process run's;
        # equal across ranks at every refresh
        assert r["pivots"]["0"] == ref["pivots"]["0"] and r["ranks"]["0"] == ref["ranks"]["0"]
        assert r["pivots"] == ranks[0]["pivots"] and sorted(r["pivots"]) == ["0", "2"]
        # each rank launches what one rank reckons
        assert r["launches_expected"]["graft_select"] == 2
        assert {k: r["launches"].get(k, 0) for k in r["launches_expected"]} == \
            r["launches_expected"]
        assert r["topology"] == out["stamp"] == {"process_count": 2, "device_count": 2,
                                                 "shard_layout": "replicated"}
        # the grad norm of the reduced gradients tracks the 1-process run's
        ref_norm = {int(k): v for k, v in ref["grad_norms"].items()}
        norm = {int(k): v for k, v in r["grad_norms"].items()}
        np.testing.assert_allclose(norm[0], ref_norm[0], rtol=1e-5, atol=0)
        for s in norm:
            np.testing.assert_allclose(norm[s], ref_norm[s], rtol=3e-3, atol=0)
    # the ranks end with the same parameters
    assert ranks[0]["params_sha256"] == ranks[1]["params_sha256"]
    # the JSONL stream comes from rank 0 alone
    assert os.path.exists(os.path.join(work, "two.p0.jsonl"))
    assert not os.path.exists(os.path.join(work, "two.p1.jsonl"))
    with open(os.path.join(work, "two.p0.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    # steps 0-3 from the fleet's rank 0, 4-7 from the 1-process resume
    assert [row["step"] for row in rows] == list(range(STEPS))
    # elastic 2 → 1: the resharding line, then the uninterrupted run's loss
    assert "resharding" in stdout
    np.testing.assert_allclose(out["resume_final"], ref_loss[STEPS - 1], rtol=3e-3, atol=0)
    np.testing.assert_allclose(out["resume_losses"], [ref_loss[s] for s in
                                                      range(STOP_AFTER, STEPS)],
                               rtol=3e-3, atol=0)


# reduce_grads with a planted fault, the loss still reduced right, so that
# only the grad norm and the parameters can show it
PLANTED_REDUCE_FAULTS = {
    "grads_not_reduced": "lambda self, g, op: self.reduce_tensors(g[:1], op) + list(g[1:])",
    "mean_for_sum": "lambda self, g, op: self.reduce_tensors(g[:1], op) + "
                    "self.reduce_tensors(g[1:], 'mean')",
}


@pytest.mark.parametrize("fault", sorted(PLANTED_REDUCE_FAULTS))
def test_the_fleet_check_fails_on_a_planted_gradient_reduce_fault(harness, fault):
    _, _, out = harness
    code = ("import sys\n"
            "from repro_torch.backend.multiprocess import MultiProcessBackend\n"
            f"MultiProcessBackend.reduce_grads = {PLANTED_REDUCE_FAULTS[fault]}\n"
            "from repro_torch.backend.__main__ import main\n"
            "sys.exit(main(sys.argv[1:]))\n")
    port = fleet.free_port()
    ranks = [r.last_json() for r in fleet.launch(
        [[sys.executable, "-c", code, "--worker", "--device=cpu"] +
         [f"--{o}" for o in BASE_OVERRIDES + ["train.stop_after=2",
                                              *fleet.backend_overrides(2, r, port)]]
         for r in (0, 1)], env=ENV)]
    # the losses alone agree with the 1-process run at step 0
    assert ranks[0]["losses"]["0"] == pytest.approx(out["reference"]["losses"]["0"], rel=1e-5)
    with pytest.raises(AssertionError, match="grad norm"):
        check_fleet(out["reference"], ranks)
    if fault == "grads_not_reduced":
        assert ranks[0]["params_sha256"] != ranks[1]["params_sha256"]


def test_harness_compressed_all_reduce_matches_jax(harness):
    """The ranks' host-side ``all_reduce`` under ``compress_reduce`` (two
    calls, the error carried between them) against JAX's reduce of the same
    inputs."""
    _, _, out = harness
    ranks = out["ranks"]
    inputs = [fleet.all_reduce_probe_inputs(r) for r in (0, 1)]
    for key in ("vec", "scalar"):
        grads = np.stack([np.asarray(i[key], np.float32).reshape(-1) for i in inputs])
        errors = np.zeros_like(grads)
        for call in range(2):
            jmean, jerr = _jax_ef(grads, errors)
            for r in ranks:
                got = np.asarray(r["all_reduce"][call][key], np.float32).reshape(-1)
                np.testing.assert_allclose(got, jmean[0], rtol=0, atol=1e-6)
            errors = jerr


def test_one_process_checkpoint_resumes_on_two_ranks(harness, tmp_path):
    work, _, out = harness
    ref_loss = {int(k): v for k, v in out["reference"]["losses"].items()}
    ck = str(tmp_path / "ck")
    os.makedirs(ck)
    shutil.copytree(os.path.join(work, "ref_ckpt", f"step_{STOP_AFTER:08d}"),
                    os.path.join(ck, f"step_{STOP_AFTER:08d}"))
    port = fleet.free_port()
    ranks = [r.last_json() for r in fleet.launch(
        [fleet.worker_command(BASE_OVERRIDES + [f"train.checkpoint_dir={ck}",
                                                *fleet.backend_overrides(2, r, port)],
                              device="cpu") for r in (0, 1)], env=ENV)]
    for r in ranks:
        assert r["start_step"] == STOP_AFTER
        loss = {int(k): v for k, v in r["losses"].items()}
        assert sorted(loss) == list(range(STOP_AFTER, STEPS))
        for s in loss:
            np.testing.assert_allclose(loss[s], ref_loss[s], rtol=3e-3, atol=0)
    assert ranks[0]["pivots"] == ranks[1]["pivots"]


def _api(overrides):
    return [sys.executable, "-m", "repro_torch.api", "--device=cpu"] + \
        [f"--{o}" for o in overrides]


def _report(stdout):
    return json.loads(stdout[stdout.rindex("\n{") + 1:])


def test_two_ranks_roll_back_together(tmp_path):
    """``nan_rollback`` in a fleet: both ranks skip, roll back to the same
    step and finish within 3e-3 of the 1-process scenario."""
    plan = json.dumps([{"kind": "nan_batch", "step": 5}])

    def cell(name):
        return ["train.steps=8", "train.batch=8", "train.seq=16", "train.log_every=0",
                f"train.checkpoint_dir={tmp_path / name}", "train.checkpoint_every=2",
                "train.metrics_flush_every=2", "train.bad_step_patience=1",
                "graft.rset=[2,4]", "graft.refresh_every=3", f"train.fault_plan={plan}"]

    port = fleet.free_port()
    runs = fleet.launch([_api(cell("two") + fleet.backend_overrides(2, r, port))
                         for r in (0, 1)], env=ENV)
    one = fleet.run_worker(cell("one"), device="cpu")
    assert len(one["rollbacks"]) == 1
    for r in runs:
        rep = _report(r.stdout)
        assert rep["resilience"]["rollbacks"] == one["rollbacks"]
        assert rep["resilience"]["bad_steps"] == 1
        np.testing.assert_allclose(rep["final_loss"], one["final_loss"], rtol=3e-3, atol=0)
    assert "ROLLBACK" in runs[0].stdout and "ROLLBACK" in runs[1].stdout


def test_ranks_with_different_configs_fail_loudly():
    port = fleet.free_port()
    runs = fleet.launch(
        [_api(SMOKE + [f"optimizer.learning_rate={lr}"] + fleet.backend_overrides(2, r, port))
         for r, lr in ((0, 3e-4), (1, 1e-3))], env=ENV, check=False)
    for r in runs:
        assert r.returncode != 0
        assert "processes disagree" in r.stderr and "identical experiment config" in r.stderr


def test_a_fleet_past_its_timeout_is_killed_with_every_ranks_stderr():
    hang = [sys.executable, "-c",
            "import sys, time; print('rank up', file=sys.stderr, flush=True); time.sleep(60)"]
    with pytest.raises(fleet.FleetError) as e:
        fleet.launch([hang, hang], timeout=3, env=ENV)
    msg = str(e.value)
    assert "timed out after 3 s and was killed" in msg
    assert msg.count("rank up") == 2 and "rank 0" in msg and "rank 1" in msg

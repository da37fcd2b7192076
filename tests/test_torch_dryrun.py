"""The port's dry run (``repro_torch.launch.{specs,mesh,dryrun}``) against the
JAX package's, on the CPU.

* The cell tables and helpers equal JAX's: ``SHAPES``, ``SHAPE_RULES``,
  ``RULE_PRESETS``, ``LONG_CONTEXT_ARCHS``, ``cell_is_supported``,
  ``all_cells``, ``default_train_config`` for every arch × shape; the
  batch specs of every arch and source; ``--list``'s lines.
* The abstract train state's parameter and optimizer leaves equal
  ``jax.eval_shape(repro.launch.steps.init_train_state)`` leaf by leaf under
  the checkpoint's names (``checkpoint/jax_bridge.py``) at full size for
  every arch; the decode cache's bytes equal ``jax.eval_shape(init_cache)``
  at decode_32k (the JAX cache's int32 ``index`` aside: the port's is a
  host int).
* At smoke size the fake step on fake CPU tensors counts the
  ``FlopCounterMode`` FLOPs of the real CPU step exactly; on the card's
  routes its launches are ``launch_audit.expected_launches``'s.
* Each kernel's cost function gives PERF.md §6's hand counts.
* The memory tracker's peak on a toy is known to the byte; ``remat=full``
  peaks below ``none``.
* JAX's ``TestDryrunSmoke`` cases in process, and the presets the port
  refuses (``fsdp`` on a MoE arch or a decode cell, ``head_tp``; the fsdp
  cells themselves are ``tests/test_torch_fsdp.py``'s).

Where PyTorch has no CUDA (a CPU-only build) the card's routes are taken on
fake CPU tensors, asked for by name (``stand_in=True``: ``kernels/build.py``
``as_card``); a plain ``cuda:0`` request raises there.
"""
import contextlib
import dataclasses
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode, is_fake
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as jconfigs
from repro.checkpoint.checkpoint import _path_str
from repro.data import sources as jsources
from repro.launch import specs as jspecs
from repro.launch import steps as jsteps
from repro.models import decode as jdecode
from repro_torch import configs as tconfigs
from repro_torch.analysis import launch_audit
from repro_torch.api import ExperimentConfig
from repro_torch.checkpoint.jax_bridge import train_state_spec
from repro_torch.data import sources as tsources
from repro_torch.distributed import sharding as tsharding
from repro_torch.kernels import fast_maxvol, flash_attention, fused_optim, graft_select
from repro_torch.kernels import projection_sweep, rwkv_scan
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tspecs
from repro_torch.launch import steps as tsteps
from repro_torch.models import decode as tdecode
from repro_torch.models import model as tmodel
from repro_torch.selection.base import GraftConfig as TGraftConfig

ARCHS = list(jconfigs.CANONICAL_IDS)
# the card's routes: fake cuda:0 tensors, or the CPU stand-in where there is no CUDA
CARD = dict(stand_in=not torch.cuda.is_available())


def _dtype(d) -> str:
    return str(d).removeprefix("torch.")


# ---------------------------------------------------------------------------
# the cell tables
# ---------------------------------------------------------------------------

def test_tables_equal_jax():
    assert tconfigs.CANONICAL_IDS == jconfigs.CANONICAL_IDS
    assert tspecs.SHAPES == jspecs.SHAPES
    assert tspecs.SHAPE_RULES == jspecs.SHAPE_RULES
    assert tspecs.RULE_PRESETS == jspecs.RULE_PRESETS
    assert tspecs.LONG_CONTEXT_ARCHS == jspecs.LONG_CONTEXT_ARCHS
    assert list(tspecs.all_cells()) == list(jspecs.all_cells())


@pytest.mark.parametrize("arch", ARCHS)
def test_cells_and_train_config_equal_jax(arch):
    for shape in jspecs.SHAPES:
        assert tspecs.cell_is_supported(arch, shape) == jspecs.cell_is_supported(arch, shape)
    for batch in (256, 4, 2):
        for use_graft in (True, False):
            j = jspecs.default_train_config(arch, use_graft=use_graft, batch=batch,
                                            feature_mode="pca_sketch", grad_mode="logit_embed")
            t = tspecs.default_train_config(arch, use_graft=use_graft, batch=batch,
                                            feature_mode="pca_sketch", grad_mode="logit_embed")
            jo, to = dataclasses.asdict(j.optimizer), dataclasses.asdict(t.optimizer)
            assert {k: to[k] for k in jo} == jo
            assert (j.graft is None) == (t.graft is None)
            if j.graft is not None:
                jg, tg = dataclasses.asdict(j.graft), dataclasses.asdict(t.graft)
                assert {k: tg[k] for k in jg} == jg


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_equal_jax(arch):
    jm, tm = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for batch, seq in ((256, 4096), (3, 300)):
        j = jspecs.batch_specs(jm, batch, seq)
        t = tspecs.batch_specs(tm, batch, seq)
        assert {k: (tuple(s.shape), str(s.dtype)) for k, s in j.items()} == \
            {k: (s.shape, _dtype(s.dtype)) for k, s in t.items()}
    assert tspecs.input_specs(arch) == tspecs.batch_specs(tm, 256, 4096)


@pytest.mark.parametrize("source", ["synthetic_lm", "synthetic_classification",
                                    "synthetic_vision"])
def test_source_batch_specs_equal_jax(source):
    arch = "internvl2-26b" if source == "synthetic_vision" else "minicpm-2b"
    jm, tm = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    jentry, tentry = jsources.get_source(source), tsources.get_source(source)
    j = jspecs.source_batch_specs(jentry.build(jentry.task.derive(jm, batch=8, seq=32, seed=0)))
    t = tspecs.source_batch_specs(tentry.build(tentry.task.derive(tm, batch=8, seq=32, seed=0)))
    assert {k: (tuple(s.shape), str(s.dtype)) for k, s in j.items()} == \
        {k: (s.shape, _dtype(s.dtype)) for k, s in t.items()}


def test_list_prints_jax_lines(monkeypatch):
    import os
    # the JAX module sets XLA_FLAGS when it is first imported: keep it here
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import dryrun as jdryrun
    outs = []
    for main in (jdryrun.main, dryrun.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["--list"]) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert outs[1].count("CELL ") == 42 and outs[1].count("SKIP ") == 8


# ---------------------------------------------------------------------------
# abstract state and cache against jax.eval_shape
# ---------------------------------------------------------------------------

def _jax_flat(tree):
    return {"/".join(_path_str(p) for p in path): (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_state_equals_jax_eval_shape(arch):
    cell = tspecs.build_cell(arch, "train_4k", device="cpu")
    state = cell.abstract_args[0]
    got = {k: (tuple(s), _dtype(d)) for k, (s, d) in train_state_spec(state).items()
           if k.startswith(("params/", "opt/"))}
    jm = jconfigs.get_config(arch, attn_chunk=1024, loss_chunk=512)
    jt = jspecs.default_train_config(arch, batch=256)
    abstract = jax.eval_shape(lambda key: jsteps.init_train_state(jm, jt, key, 256),
                              jax.ShapeDtypeStruct((2,), jnp.uint32))
    want = {k: v for k, v in _jax_flat(abstract).items() if k.startswith(("params/", "opt/"))}
    assert got == want
    assert all(is_fake(t) for t in state["params"])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cache_bytes_equal_jax(arch):
    cell = tspecs.build_cell(arch, "decode_32k", variant="serve", device="cpu")
    _, cache, tokens = cell.abstract_args
    got = sum(t.numel() * t.element_size() for t in dryrun._tensors(cache))
    jm = jconfigs.get_config(arch, attn_chunk=1024, loss_chunk=512)
    jcache = jax.eval_shape(lambda: jdecode.init_cache(jm, 128, 32768))
    leaves = jax.tree_util.tree_flatten_with_path(jcache)[0]
    want = sum(int(np.prod(leaf.shape)) * leaf.dtype.itemsize for path, leaf in leaves
               if _path_str(path[-1]) != "index")
    assert got == want
    assert tuple(tokens.shape) == (128, 1) and cache["index"] == 0


# ---------------------------------------------------------------------------
# the step on fake tensors
# ---------------------------------------------------------------------------

def _real_batch(specs, vocab, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {k: (torch.randint(0, vocab, s.shape, generator=g, dtype=torch.int64).to(s.dtype)
                if not s.dtype.is_floating_point else torch.randn(s.shape, generator=g).to(s.dtype))
            for k, s in specs.items()}


@pytest.mark.parametrize("arch,variant", [("minicpm-2b", "graft"), ("minicpm-2b", "baseline"),
                                          ("qwen3-moe-235b-a22b", "graft")])
def test_fake_cpu_flops_equal_the_real_cpu_step(arch, variant):
    res = dryrun.run_cell(arch, "train_4k", "t", variant, smoke=True,
                          mesh_override=tmesh.make_mesh((1,), ("data",)), device="cpu")
    cell = tspecs.build_cell(arch, "train_4k", variant=variant, smoke=True, device="cpu")
    model = tmodel.init_params(cell.mcfg, torch.Generator().manual_seed(0))
    state = tsteps.state_for_model(cell.mcfg, cell.tcfg, model, cell.batch)
    batch = _real_batch(tspecs.batch_specs(cell.mcfg, cell.batch, 64), cell.mcfg.vocab_size)
    with FlopCounterMode(display=False) as counter:
        cell.step_fn(state, batch)
    assert res["full"]["aten_flops"] == counter.get_total_flops() > 0
    assert res["full"]["kernel_flops"] == 0        # the CPU's plain versions
    assert res["traced_on"] == "fake cpu tensors"


@pytest.mark.parametrize("arch", ["minicpm-2b", "rwkv6-7b"])
def test_launches_on_the_cards_routes_equal_expected(arch):
    cfg = ExperimentConfig().apply_overrides(
        [f"model.arch={arch}", "graft.use_pallas=true", "graft.rset=[2,4]",
         "graft.refresh_every=2", "train.batch=8", "train.seq=16", "train.steps=1"])
    cell = tspecs.experiment_cell(cfg, **CARD)
    res = dryrun.trace(cell)
    launches = {k: row["launches"] for k, row in res["kernels"].items()}
    mcfg = cfg.model.build()
    groups = launch_audit.optim_groups(cell.abstract_args[0]["params"])
    want = {k: v for k, v in launch_audit.expected_launches(mcfg, cfg, groups).items() if v}
    assert launches == want
    assert res["kernel_flops"] > 0 and res["kernel_bytes"] > 0
    before = launch_audit.read_counts()
    dryrun.trace(tspecs.experiment_cell(cfg, **CARD))
    assert launch_audit.read_counts() == before        # nothing launched, nothing counted


# ---------------------------------------------------------------------------
# the kernels' cost functions (PERF.md §6's hand counts)
# ---------------------------------------------------------------------------

def test_cost_functions_give_the_hand_counts():
    assert graft_select.cost(16, 8, 2304, 8)[1] == 230_980
    assert graft_select.cost(16, 8, 2304, 8, B=4)[1] == 923_920
    assert fast_maxvol.cost(16, 8, 8)[1] == 548
    assert projection_sweep.cost(2304, 8)[1] == 82_976
    bf16 = torch.bfloat16
    fwd = flash_attention.cost("fwd", 576, 576, 256, 256, 64, bf16)
    assert fwd[1] == 76_087_296 and round(fwd[0] / 1e9, 2) == 4.85
    assert flash_attention.cost("dq", 576, 576, 256, 256, 64, bf16)[1] == 95_551_488
    assert flash_attention.cost("dkv", 576, 576, 256, 256, 64, bf16)[1] == 114_425_856
    assert rwkv_scan.cost("fwd", 1024, 256, 64)[1] == 335_806_464
    bwd = rwkv_scan.cost("bwd", 128, 256, 64)
    assert bwd[1] == 75_563_008 and round(bwd[0] / 1e9, 2) == 1.91
    mcfg = ExperimentConfig().apply_overrides(["model.smoke=false"]).model.build()
    leaves = [(p.numel(), p.dtype) for p in tmodel.Model(mcfg, device="meta").parameters()]
    assert len(leaves) == 362
    assert fused_optim.norm_cost(leaves)[1] == 5_450_135_048
    assert fused_optim.update_cost("adamw", [(n, d, torch.float32) for n, d in leaves]
                                   )[1] == 59_948_499_460


def test_flash_cost_counts_the_unmasked_pairs():
    assert flash_attention.unmasked_pairs(4, 4, True, None) == 10
    assert flash_attention.unmasked_pairs(4, 4, False, None) == 16
    assert flash_attention.unmasked_pairs(6, 6, True, 2) == 11
    assert flash_attention.unmasked_pairs(1, 8, True, None) == 1


# ---------------------------------------------------------------------------
# the memory tracker
# ---------------------------------------------------------------------------

def test_tracker_peak_on_a_toy():
    from torch._subclasses.fake_tensor import FakeTensorMode
    tracker = dryrun.Tracker()
    with FakeTensorMode():
        x = torch.empty(1000, dtype=torch.float32)          # 4000 B → 4096
        tracker.see(x)
        with tracker:
            y = x * 2                                       # + 4096
            z = y.view(10, 100)                             # a view: no block
            w = torch.cat([z, z])                           # + 8192 → 16384
            del y, z, w                                     # back to 4096
            v = torch.empty(10, dtype=torch.bfloat16)       # + 512
    assert tracker.peak == 16384
    assert tracker.current == 4096 + 512
    assert tracker.bytes == 2 * 4000 + 2 * 8000             # mul, cat; view, empty none
    del v


@pytest.mark.parametrize("shape,variant,threads", [("train_4k", "graft", 2),
                                                   ("decode_32k", "serve", 1)])
def test_card_peak_counts_the_cublas_workspaces(shape, variant, threads):
    """On the card's routes a cell's peak adds one cuBLAS workspace for each
    thread that runs a matmul: the forward's and the backward's of a train
    step, the forward's alone of a serve step; a CPU cell adds none."""
    res = dryrun.run_cell("minicpm-2b", shape, "single", variant, smoke=True, **CARD)
    mem = res["full"]["memory"]
    assert mem["workspace_bytes"] == threads * dryrun.CUBLAS_WORKSPACE_BYTES
    assert mem["temp_size_in_bytes"] == mem["peak_bytes"] - mem["argument_size_in_bytes"]
    cfg = ExperimentConfig().apply_overrides(["graft.rset=[2,4]", "train.batch=8",
                                              "train.seq=32"])
    cpu = dryrun.trace(tspecs.experiment_cell(cfg, device="cpu"))["memory"]
    assert cpu["workspace_bytes"] == 0


def test_remat_full_peaks_below_none():
    peaks = {}
    for remat in ("full", "none"):
        cfg = ExperimentConfig().apply_overrides(
            ["graft.rset=[2,4]", "train.batch=8", "train.seq=32",
             f'model.overrides={{"remat": "{remat}", "num_layers": 4}}'])
        peaks[remat] = dryrun.trace(tspecs.experiment_cell(
            cfg, device="cpu"))["memory"]["peak_bytes"]
    assert peaks["full"] < peaks["none"]


# ---------------------------------------------------------------------------
# JAX's TestDryrunSmoke cases, meshes and refusals
# ---------------------------------------------------------------------------

def test_train_cell_on_2x4():
    mesh = tmesh.make_mesh((2, 4), ("data", "model"))
    res = dryrun.run_cell("minicpm-2b", "train_4k", "t", "graft", with_deltas=False,
                          smoke=True, mesh_override=mesh, **CARD)
    assert res["full"]["flops"] > 0
    assert res["full"]["collectives"]["total_count"] > 0
    # the default preset shards a dense arch's train cell (the sequence over
    # the model axis), the batch over data alone
    assert res["batch_shards"] == 2 and res["state"] == "sharded"
    assert res["scaled"]["flops"] == res["full"]["flops"]


def test_decode_cell_on_multipod_2x2x2():
    mesh = tmesh.make_mesh((2, 2, 2), ("pod", "data", "model"))
    res = dryrun.run_cell("hymba-1.5b", "decode_32k", "t", "serve", with_deltas=False,
                          smoke=True, mesh_override=mesh, **CARD)
    assert res["full"]["flops"] >= 0 and res["batch_shards"] == 4
    # the default preset shards the hybrid family's serve cell: the tick's
    # heads and d_ff partials and the split-KV combine meet over "model"
    assert res["state"] == "sharded"
    assert res["full"]["collectives"]["count_by_op"]["all-reduce"] > 0


def test_production_mesh_shapes():
    m1, m2 = tmesh.make_production_mesh(), tmesh.make_production_mesh(multi_pod=True)
    assert (m1.devices.shape, m1.axis_names) == ((16, 16), ("data", "model"))
    assert (m2.devices.shape, m2.axis_names) == ((2, 16, 16), ("pod", "data", "model"))
    assert tmesh.make_host_mesh().axis_names == ("data",)
    assert dryrun.batch_shards(m2, 256, {}) == 32
    assert dryrun.batch_shards(m1, 1, {}) == 1          # indivisible: replicated


@pytest.mark.parametrize("arch,preset,reason", [
    ("qwen3-moe-235b-a22b", "fsdp", "expert parallelism"),
    ("minicpm-2b", "head_tp", "tensor parallelism"),
    ("rwkv6-7b", "default", None), ("musicgen-medium", "default", None),
    ("hymba-1.5b", "default", None), ("qwen3-moe-235b-a22b", "default", "A14")])
def test_parameter_sharding_presets_raise(arch, preset, reason):
    """What the port's partitioner does not run: head-parallel attention in
    the dry run; sharded serving of a MoE arch under either preset (A14s),
    whose train step and train cell run sharded (expert parallelism). The
    ``default`` preset on the ssm, audio and hybrid families, refused until
    A12b and A12s at the serve steps (the hybrid one at the train step
    too), runs: the train step is made, and the decode cell traces
    sharded."""
    moe = tconfigs.get_config(arch).family == "moe"
    if preset == "default":
        mesh = tmesh.make_mesh((2, 2), ("data", "model"))
        mcfg = tconfigs.get_smoke_config(arch)
        tt = tsteps.TrainConfig(graft=TGraftConfig(rset=(2, 4)))
        with tsharding.sharding_rules(mesh, {}):
            assert callable(tsteps.make_train_step(mcfg, tt))
        if reason is None:
            res = dryrun.run_cell(arch, "decode_32k", "t", "serve", smoke=True,
                                  mesh_override=mesh, rules_preset=preset, **CARD)
            assert res["state"] == "sharded" and "replicated_why" not in res
            return
        with tsharding.sharding_rules(mesh, {}), pytest.raises(ValueError, match=reason):
            tsteps.decode_step(mcfg, None, None, None)
        return
    if moe:
        res = dryrun.run_cell(arch, "train_4k", "single", "graft", smoke=True,
                              rules_preset=preset, **CARD)
        assert res["state"] == "sharded"
    else:
        with pytest.raises(ValueError, match=reason):
            dryrun.run_cell(arch, "train_4k", "single", "graft", smoke=True,
                            rules_preset=preset)
    if preset == "fsdp":
        with pytest.raises(ValueError, match=reason):
            dryrun.run_cell(arch, "decode_32k", "single", "serve", smoke=True,
                            rules_preset=preset)


# ---------------------------------------------------------------------------
# the CPU stand-in is asked for by name
# ---------------------------------------------------------------------------

def test_a_cuda_request_without_cuda_raises(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="stand-in"):
        tspecs.build_cell("minicpm-2b", "decode_32k", variant="serve", smoke=True)
    with pytest.raises(ValueError, match="stands for a cuda device"):
        tspecs.abstract_device("cpu", stand_in=True)
    assert tspecs.abstract_device("cuda:0", stand_in=True) == (torch.device("cpu"), True)
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(dryrun, "STAND_IN_DIR", str(tmp_path / "cpu_stand_in"))
    assert dryrun.main(["--arch", "minicpm-2b", "--shape", "decode_32k", "--smoke"]) == 2
    assert "--cpu-stand-in" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())                  # nothing written


def test_stand_in_results_stay_apart_from_the_cards(monkeypatch, tmp_path):
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(dryrun, "STAND_IN_DIR", str(tmp_path / "cpu_stand_in"))
    card = dryrun.result_path("minicpm-2b", "decode_32k", "one", "serve")
    stand_in = dryrun.result_path("minicpm-2b", "decode_32k", "one", "serve", stand_in=True)
    assert os.path.dirname(card) == str(tmp_path) != os.path.dirname(stand_in)
    assert os.path.basename(card) == os.path.basename(stand_in)
    assert dryrun.main(["--arch", "minicpm-2b", "--shape", "decode_32k", "--smoke",
                        "--mesh", "one", "--cpu-stand-in"]) == 0
    assert os.path.exists(stand_in) and not os.path.exists(card)
    with open(stand_in) as f:
        res = json.load(f)
    assert res["ok"] and res["device"] == "cpu" and "stand-in" in res["traced_on"]


def test_the_stand_in_moves_only_fake_tensors_to_the_cards_routes():
    from repro_torch.kernels import build
    from repro_torch.models import layers
    mcfg = tconfigs.get_smoke_config("minicpm-2b")
    real = torch.zeros(2, 16, mcfg.d_model)
    with FakeTensorMode():
        fake = torch.zeros(2, 16, mcfg.d_model)
    with build.as_card():
        assert build.on_card(fake) and not build.on_card(real)
        assert not build.on_card(torch.device("cpu"))
        assert layers.resolve_attn_backend(mcfg, 16, 16, fake) == "flash"
        assert layers.resolve_attn_backend(mcfg, 16, 16, real) == "dense"
        assert not build.placement("x", real)
    assert not build.on_card(fake)
    assert layers.resolve_attn_backend(mcfg, 16, 16, fake) == "dense"

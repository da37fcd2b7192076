"""The port's shared-memory estimator (``repro_torch.analysis.smem``) beside
the JAX package's ``repro.analysis.vmem``: the estimate's API and rules
(VM001 over the budget, VM002 divisibility, VM003 headroom), the sums of
every Hopper kernel plan written out from the CUDA sources
(``csrc/flash_attention.cu`` ``plan_smem``, ``csrc/graft_select.cu``
``smem_words`` / ``sweep_smem_words``, ``csrc/rwkv_scan.cu`` ``BwdSmem``;
the card holds them to the libraries' own sums in
``tests/test_torch_cuda.py``), the refresh plans the wrappers pick from
them, and the attention router against JAX's ``vmem.flash_feasible``.
Byte counts are integers and compared exactly; no tolerance is involved.
"""
import dataclasses

import numpy as np
import pytest

from repro.analysis import vmem
from repro.models import layers as jlayers
from repro_torch.analysis import smem
from repro_torch.kernels import graft_select as gs
from repro_torch.models.layers import resolve_attn_backend
from repro_torch.models.model import ModelConfig

SEED = 0
KINDS = ("fwd", "dq", "dkv")


def _f32_flash(kind, dh):
    """float32 tiles of (tile + 4) columns, tile 64 (32 above head dim 160)."""
    t = 32 if dh > 160 else 64
    staged = {"fwd": 3 * dh + t, "dq": 4 * dh + t, "dkv": 4 * dh + 2 * t}[kind]
    return 4 * staged * (t + 4) + (8 * t if kind == "dkv" else 0)


def _bf16_flash(kind, dh):
    """bf16 rows of the padded head dim + 8, K/V (Q/dO) double-buffered."""
    dp = next(p for p in (16, 32, 64, 128, 160, 256) if dh <= p)
    kv = 32 if dp > 160 else 64
    q = 32 if dp >= 160 else 64
    if kind == "fwd":
        return 2 * (64 + 4 * kv) * (dp + 8)
    if kind == "dq":
        return 2 * (2 * 64 + 4 * kv) * (dp + 8)
    return 2 * (2 * 64 + 4 * q) * (dp + 8) + 16 * q


def test_flash_plans_equal_the_cuda_sums_at_every_head_dim():
    for dh in range(1, smem.FLASH_MAX_HEAD_DIM + 1):
        for kind in KINDS:
            f32 = smem.flash_smem(kind, dh, "float32")
            bf16 = smem.flash_smem(kind, dh, "bfloat16")
            assert f32.total == _f32_flash(kind, dh), (kind, dh)
            assert bf16.total == _bf16_flash(kind, dh), (kind, dh)
            assert f32.fits and bf16.fits
    assert [smem.flash_smem(k, 64).total for k in KINDS] == [46_080, 55_296, 56_320]
    with pytest.raises(ValueError, match="head_dim 257"):
        smem.flash_smem("fwd", 257)
    report = smem.flash_attention_report(256, 256, 257, "bfloat16")
    assert [f.rule for f in report.errors] == ["VM001"]
    assert not smem.flash_feasible(256, 256, 64, "float16")


def _refresh_sum(K, R, d, rank, plan, basis):
    """``smem_words``: the basis (shared basis plan), the working set
    (shared W plan), the scratch and the staging tiles, in words."""
    work = K * R + 2 * K + R if plan == "shared" else 0
    basis_w = (rank + 1) * d if basis == "shared" else 0
    scratch = (2 * 8 + 2) * rank + 2 * 8 + 2
    tiles = 256 * (K + 1) if K <= 16 else 0
    return 4 * (work + basis_w + scratch + tiles)


def _refresh_grid():
    rng = np.random.default_rng(SEED)
    cases = [(16, 8, 2304, 8), (16, 8, 4096, 8), (16, 8, 6144, 8), (256, 32, 1024, 32),
             (1024, 64, 1024, 64), (2048, 256, 64, 256)]
    for _ in range(24):
        K = int(rng.choice([8, 16, 40, 64, 256, 1024]))
        R = int(rng.choice([4, 8, 16, 32, 64]))
        cases.append((K, R, int(rng.choice([32, 1536, 1600, 2304, 5120])),
                      int(rng.integers(1, min(K, R) + 1))))
    return cases


@pytest.mark.parametrize("K,R,d,rank", _refresh_grid())
def test_refresh_plans_and_their_choice(K, R, d, rank):
    """Every plan pair's sum; the wrapper keeps each part in shared memory
    exactly when the estimate fits, and refuses a forced shared plan that
    does not (VM001 in the report)."""
    for plan in smem.PLANS:
        for basis in smem.PLANS:
            est = smem.graft_select_smem(K, R, d, rank, plan, basis)
            assert est.total == _refresh_sum(K, R, d, rank, plan, basis)
            assert est.fits == (est.total <= smem.SMEM_LIMIT_BYTES)
            assert [f.rule for f in est.report()] == ["VM003" if est.fits else "VM001"]
        mv = smem.fast_maxvol_smem(K, R, rank, plan)
        assert mv.total == _refresh_sum(K, R, 0, rank, plan, "global")
    plan = gs.choose_plan(K, R, rank)
    assert (plan == "shared") == smem.graft_select_smem(K, R, 0, rank).fits
    basis = gs.choose_basis(K, R, d, rank, plan)
    assert (basis == "shared") == smem.graft_select_smem(K, R, d, rank, plan, "shared").fits
    assert gs.resolve_plan(K, R, rank, None) == plan
    assert gs.resolve_basis(K, R, d, rank, plan, None) == basis
    if plan == "global":
        with pytest.raises(ValueError, match="shared plan"):
            gs.resolve_plan(K, R, rank, "shared")
    if basis == "global":
        with pytest.raises(ValueError, match="shared basis"):
            gs.resolve_basis(K, R, d, rank, plan, "shared")


@pytest.mark.parametrize("K,R,d,rank", _refresh_grid())
def test_fused_refusal_equals_jax_fused_select_vmem(K, R, d, rank):
    est, want = smem.fused_select_vmem(K, R, d, rank), vmem.fused_select_vmem(K, R, d, rank)
    assert (est.total, est.budget, est.fits) == (want.total, want.budget, want.fits)
    assert sorted(est.parts.items()) == sorted(want.parts.items())
    assert smem.VMEM_BUDGET_BYTES == vmem.VMEM_BUDGET_BYTES


def test_projection_sweep_and_rwkv_plans():
    for R in (1, 8, 16, 17, 32, 64, 512):
        tiles = 256 * (R + 1) if R <= 16 else 0
        assert smem.projection_sweep_smem(R, "shared").total == 4 * ((2 * 8 + 1) * R + tiles)
        assert smem.projection_sweep_smem(R, "global").total == 4 * tiles
    assert smem.rwkv_backward_smem().total == 127_488
    assert smem.rwkv_forward_vmem(64).total == 4 * (4 * 32 * 64 + 64 * 64 + 32 * 64)
    assert [f.rule for f in smem.rwkv_report(256, 64)] == ["VM003", "VM003"]
    assert [f.rule for f in smem.rwkv_report(250, 2048).errors] == ["VM002", "VM001"]


def test_estimate_api_mirrors_vmem_estimate():
    fields = {f.name for f in dataclasses.fields(vmem.VmemEstimate)}
    assert fields == {f.name for f in dataclasses.fields(smem.SmemEstimate)}
    for name in ("total", "headroom", "fits", "describe", "report"):
        assert hasattr(smem.SmemEstimate, name) and hasattr(vmem.VmemEstimate, name)
    est = smem.SmemEstimate("k", {"a": 200_000, "b": 40_000})
    assert (est.total, est.headroom, est.fits) == (240_000, -7_552, False)
    assert [f.rule for f in est.report().errors] == ["VM001"]


_SHAPES = [(S, T) for S in (1, 8, 12, 64, 100, 128, 256, 2048)
           for T in (8, 64, 96, 256, 4096, 8192, 65536)]


@pytest.mark.parametrize("S,T", _SHAPES)
def test_vm002_agrees_with_jax_check_divisible(S, T):
    pick_q, pick_k = smem.flash_blocks(S, T)
    assert (pick_q, pick_k) == jlayers._flash_blocks(S, T)
    for block in (8, 16, 64, 128, 0):
        for extent, axis in ((S, "Sq"), (T, "T")):
            got = smem.check_divisible(extent, block, axis, "loc")
            want = vmem.check_divisible(extent, block, axis, "loc")
            assert (got is None) == (want is None)
            if got is not None:
                assert (got.rule, got.location, got.message) == \
                    (want.rule, want.location, want.message)
    report = smem.flash_attention_report(S, T, 64)
    assert bool(report.by_rule("VM002")) == (pick_q is None or pick_k is None)


@pytest.mark.parametrize("S,T", _SHAPES)
def test_router_takes_flash_wherever_jax_vmem_does(S, T):
    """Where JAX's ``vmem.flash_feasible`` holds (head dims of the JAX
    configs, up to 256), the port's ``auto`` router takes flash on a CUDA
    device. The port takes flash on more shapes only where the JAX kernel's
    whole K/V stream exceeds its 12 MB VMEM (long T): the Hopper kernels
    tile KV (ROADMAP.md C)."""
    for dh in (12, 16, 64, 128, 160, 256):
        for dtype in ("bfloat16", "float32"):
            cfg = ModelConfig(head_dim=dh, attn_backend="auto", param_dtype=dtype)
            port = resolve_attn_backend(cfg, S, T, "cuda") == "flash"
            bq, bk = jlayers._flash_blocks(S, T)
            jax_ok = bq is not None and bk is not None and \
                vmem.flash_feasible(S, T, dh, bq, bk)
            if jax_ok:
                assert port, (S, T, dh, dtype)
            elif port:
                assert bq and bk and not vmem.flash_forward_vmem(T, dh, bq).fits, (S, T, dh)
            assert port == smem.flash_feasible(S, T, dh, dtype)

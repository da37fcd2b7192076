"""Card-only tests of the port: the hand-written CUDA kernels against their
plain PyTorch twins, and a short GPU training run. Marked ``cuda``; they
skip where there is no NVIDIA GPU. Imports no JAX, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: graft_select's pivots and ``G_sel`` bit-equal (same
single-rounding elimination; the gather is a copy); errors atol 1e-5 and
logvol rtol 1e-5, because the kernel sums in another order than PyTorch:
each Gram-Schmidt coefficient, norm and dot over a thread's rows in order,
then over a warp's lanes by a xor butterfly, then over the 8 warps in warp
order (the log-volume in pivot order by one thread). The kernels of one
source share their device code, so the batched kernel's rows, the two
MaxVol (W) plans, the two basis plans, the standalone MaxVol and the
standalone sweep are bit-equal to the fused single kernel. Flash attention: float32 outputs and gradients within
1e-4·max|plain| and lse within 1e-4 (float32 sums of up to T products in
another order); bf16 outputs within one bf16 ulp of max|plain| (2^-7·max).
The bf16 kernels run on the tensor cores. The forward and dK/dV round P
(and dS) to bf16 once before their products: that adds at most
2^-9·Σ pⱼ|vⱼ| to o before its own rounding, and far less for random inputs;
dQ feeds dS·K with dS as bf16 hi + lo (~16 bits), because Σⱼ dSⱼ kⱼ cancels
heavily. Bounded vs exhaustive KV loops and two runs on the same inputs are
bit-equal. RWKV scan: the output within
1e-5·max|plain| and each gradient within 1e-4·max|plain| (float32 sums over
D and, for the gradients, over T in another order), plus 1e-6; reruns, and
inputs that take the 4-byte copies instead of the 16-byte ones, bit-equal
(fixed summation order, no atomics).
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.core import maxvol as maxvol_lib
from repro_torch.core import projection as proj_lib
from repro_torch.kernels import fast_maxvol as fm
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import graft_select as gs
from repro_torch.kernels import projection_sweep as ps
from repro_torch.kernels import rwkv_scan as rw
from repro_torch.kernels.graft_select import graft_select, graft_select_reference
from torch_cases import CASES, RWKV_SHAPES, assert_refresh_match, graft_case, rwkv_case


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc) to build and run the CUDA kernel")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _on(dev, *arrays):
    return [torch.from_numpy(a).to(dev) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_twin(cuda, name):
    V, G, gb, rank = graft_case(name)
    V, G, gb = _on(cuda, V, G, gb)
    before = graft_select.launches
    got = graft_select(V, G, gb, rank)
    torch.cuda.synchronize()
    assert graft_select.launches == before + 1
    want = graft_select_reference(V, G, gb, rank)
    assert_refresh_match([t.cpu().numpy() for t in got],
                         [t.cpu().numpy() for t in want])


@pytest.mark.cuda
@pytest.mark.parametrize("K,R,d,rank", [(16, 8, 2304, 8), (256, 64, 4096, 64)])
def test_kernel_matches_twin_at_training_widths(cuda, K, R, d, rank):
    rng = np.random.default_rng(1)
    V = rng.normal(size=(K, R)).astype(np.float32)
    G = rng.normal(size=(d, K)).astype(np.float32)
    V, G, gb = _on(cuda, V, G, G.mean(axis=1).astype(np.float32))
    got = graft_select(V, G, gb, rank)
    want = graft_select_reference(V, G, gb, rank)
    assert_refresh_match([t.cpu().numpy() for t in got],
                         [t.cpu().numpy() for t in want])


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(cuda):
    """A V of 1024×64 does not fit a block's shared memory: it runs on the
    global plan and matches the plain version. What the JAX kernel's 12 MB
    estimate refuses, this refuses; so it does bad types and layouts."""
    rng = np.random.default_rng(4)
    Vn = rng.normal(size=(1024, 64)).astype(np.float32)
    Gn = rng.normal(size=(8, 1024)).astype(np.float32)
    V, G, gb = _on(cuda, Vn, Gn, Gn.mean(axis=1).astype(np.float32))
    got = graft_select(V, G, gb, 64)
    want = graft_select_reference(V, G, gb, 64)
    assert_refresh_match([t.cpu().numpy() for t in got],
                         [t.cpu().numpy() for t in want])
    with pytest.raises(ValueError, match="VMEM budget"):
        graft_select(V, torch.zeros(4096, 1024, device=cuda),
                     torch.zeros(4096, device=cuda), 8)
    with pytest.raises(TypeError, match="float32"):
        graft_select(V[:16].double(), G[:, :16].double(),
                     torch.zeros(8, device=cuda, dtype=torch.float64), 4)
    with pytest.raises(ValueError, match="contiguous"):
        graft_select(torch.zeros(8, 16, device=cuda).T, G[:, :16],
                     torch.zeros(8, device=cuda), 4)


def _random_stack(B, K, R, d, seed):
    rng = np.random.default_rng(seed)
    Vs = rng.normal(size=(B, K, R)).astype(np.float32)
    Gs = rng.normal(size=(B, d, K)).astype(np.float32)
    return Vs, Gs, Gs.mean(axis=2).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,R,d,rank", [(4, 16, 8, 2304, 8), (8, 256, 32, 1024, 32),
                                          (3, 1024, 64, 64, 64)])
def test_batched_kernel_rows_equal_single_kernel(cuda, B, K, R, d, rank):
    """One launch for the stack; row b bit-equal to the single kernel on row
    b (the same block code), and to the plain version as the single one is."""
    Vs, Gs, gbs = _on(cuda, *_random_stack(B, K, R, d, seed=B))
    before = (gs.graft_select.launches, gs.graft_select_batched.launches)
    got = gs.graft_select_batched(Vs, Gs, gbs, rank)
    torch.cuda.synchronize()
    assert (gs.graft_select.launches, gs.graft_select_batched.launches) == \
        (before[0], before[1] + 1)
    assert got[0].shape == (B, rank) and got[3].shape == (B, d, rank)
    for b in range(B):
        single = graft_select(Vs[b], Gs[b], gbs[b], rank)
        for a, s in zip(got, single):
            assert torch.equal(a[b], s)
    want = gs.graft_select_batched_reference(Vs, Gs, gbs, rank)
    for b in range(B):
        assert_refresh_match([t[b].cpu().numpy() for t in got],
                             [t[b].cpu().numpy() for t in want])


@pytest.mark.cuda
@pytest.mark.parametrize("basis", gs.PLANS)
@pytest.mark.parametrize("K,R,d,rank", [(16, 8, 2304, 8), (16, 8, 4096, 8),
                                        (256, 64, 512, 64), (64, 8, 32, 6)])
def test_global_plan_bit_equal_to_shared_plan(cuda, K, R, d, rank, basis):
    """Both W plans under either basis plan give the bits of the plans the
    wrapper picks (at these shapes every pair fits one block)."""
    V, G, gb = _on(cuda, *(x[0] for x in _random_stack(1, K, R, d, seed=K)))
    picked = graft_select(V, G, gb, rank)
    shared = graft_select(V, G, gb, rank, plan="shared", basis=basis)
    glob = graft_select(V, G, gb, rank, plan="global", basis=basis)
    for a, b, c in zip(shared, glob, picked):
        assert torch.equal(a, b) and torch.equal(a, c)
    for plan in ("shared", "global"):
        p, lv = fm.fast_maxvol(V, rank, plan=plan)
        assert torch.equal(p, shared[0]) and torch.equal(lv, shared[2])


@pytest.mark.cuda
@pytest.mark.parametrize("K,R,d,rank", [(16, 8, 2304, 8), (16, 8, 4096, 8),
                                        (16, 8, 5120, 8), (256, 64, 4096, 64),
                                        (1024, 64, 1024, 64), (64, 8, 32, 6)])
def test_refresh_shared_memory_matches_the_library(cuda, K, R, d, rank):
    """The C library's shared-memory sum of a refresh block equals the
    wrapper's mirror under every pair of plans (-1 above 227 KB)."""
    for plan in gs.PLANS:
        for basis in gs.PLANS:
            want = gs.smem_bytes(K, R, rank, plan, d if basis == "shared" else 0)
            got = gs.library_smem_bytes(K, R, d, rank, plan, basis)
            assert got == (want if want <= gs.SMEM_LIMIT_BYTES else -1), (plan, basis)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_fast_maxvol_and_sweep_kernels_match_plain(cuda, name):
    V, G, gb, rank = graft_case(name)
    V, G, gb = _on(cuda, V, G, gb)
    before = (fm.fast_maxvol.launches, ps.projection_sweep.launches)
    piv, lv = fm.fast_maxvol(V, rank)
    fused = graft_select(V, G, gb, rank)
    errs = ps.projection_sweep(fused[3], gb)
    torch.cuda.synchronize()
    assert (fm.fast_maxvol.launches, ps.projection_sweep.launches) == \
        (before[0] + 1, before[1] + 1)
    piv_r, lv_r = maxvol_lib.fast_maxvol(V, rank)
    assert torch.equal(piv.long(), piv_r.long()) and torch.equal(piv, fused[0])
    assert torch.equal(lv, fused[2])
    np.testing.assert_allclose(lv.item(), lv_r.item(), rtol=1e-5)
    # the same sweep routine as the fused kernel: bit-equal errors
    assert torch.equal(errs, fused[1])
    errs_r = proj_lib.prefix_projection_errors(fused[3], gb)
    np.testing.assert_allclose(errs.cpu().numpy(), errs_r.cpu().numpy(), atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("K,R,rank", [(1024, 64, 64), (2048, 256, 256)])
def test_fast_maxvol_kernel_wide(cuda, K, R, rank):
    rng = np.random.default_rng(K)
    V = torch.from_numpy(rng.normal(size=(K, R)).astype(np.float32)).to(cuda)
    assert gs.choose_plan(K, R, rank) == "global"
    piv, lv = fm.fast_maxvol(V, rank)
    piv_r, lv_r = maxvol_lib.fast_maxvol(V, rank)
    assert torch.equal(piv.long(), piv_r.long())
    np.testing.assert_allclose(lv.item(), lv_r.item(), rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("d,R", [(2304, 8), (1024, 32), (16384, 64)])
def test_projection_sweep_kernel_wide(cuda, d, R):
    rng = np.random.default_rng(d + R)
    G = torch.from_numpy(rng.normal(size=(d, R)).astype(np.float32)).to(cuda)
    gb = G.mean(dim=1).contiguous()
    got = ps.projection_sweep(G, gb)
    want = proj_lib.prefix_projection_errors(G, gb)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-5)
    # the reduction scratch in global memory: the same sums, bit-equal
    assert torch.equal(ps.projection_sweep(G, gb, plan="global"), got)


@pytest.mark.cuda
def test_select_multi_batch_on_card_one_batched_launch(cuda):
    from repro_torch.selection import GraftConfig, engine
    Vs, Gs, gbs = _on(cuda, *_random_stack(4, 16, 8, 2304, seed=9))
    cfg = GraftConfig(rset=(2, 4, 8), eps=0.25, use_pallas=True)
    before = (gs.graft_select.launches, gs.graft_select_batched.launches)
    multi, _ = engine.select_multi_batch(cfg, "graft", Vs, Gs, gbs, step=2)
    torch.cuda.synchronize()
    assert (gs.graft_select.launches, gs.graft_select_batched.launches) == \
        (before[0], before[1] + 1)
    plain, _ = engine.select_multi_batch(GraftConfig(rset=(2, 4, 8), eps=0.25),
                                         "graft", Vs, Gs, gbs, step=2)
    assert torch.equal(multi.pivots, plain.pivots) and torch.equal(multi.rank, plain.rank)
    np.testing.assert_allclose(multi.last_error.cpu().numpy(),
                               plain.last_error.cpu().numpy(), atol=1e-5)
    for b in range(4):
        single, _ = engine.select_batch(cfg, "graft", Vs[b], Gs[b], gbs[b], step=2)
        for field in single._fields:
            assert torch.equal(getattr(multi, field)[b], getattr(single, field)), field


def _flash_counts():
    f = fa.flash_attention
    return f.forward_launches, f.dq_launches, f.dkv_launches


@pytest.mark.cuda
def test_trainer_on_card_launches_kernel_per_refresh(cuda):
    """The default smoke config on the card: auto → flash at head_dim 12.
    4 steps, refresh every 2, 2 layers, no remat: 2·4 subset forwards + 2·2
    selection forwards, and one dQ and one dK/dV per layer and step."""
    from repro_torch.api import ExperimentConfig, Trainer
    cfg = ExperimentConfig().apply_overrides(
        ["train.steps=4", "train.batch=8", "train.seq=16", "graft.rset=[2,4]",
         "graft.refresh_every=2", "graft.use_pallas=true", "train.log_every=0"])
    before, flash_before = graft_select.launches, _flash_counts()
    report = Trainer(cfg).fit()
    assert graft_select.launches - before == 2
    assert tuple(a - b for a, b in zip(_flash_counts(), flash_before)) == (12, 8, 8)
    assert report["device"].startswith("cuda")
    assert all(np.isfinite(r["loss"]) and r["rank"] in (2, 4)
               for r in report["history"])


# (B, H, Hkv, S, Dh, dtype, causal, window, softcap): the training path's
# shape, gemma2-like (window, softcap, GQA 2, Dh 128), stablelm's Dh 160 with
# GQA 4, the smoke Dh 12 in f32, Dh 256 (tiles of 32) on a ragged S, and
# bidirectional; then the edges of the bf16 tensor-core kernels: the smoke
# Dh 12 (zero-padded to 16, element copies) and Dh 16 with GQA 2, a ragged
# S 200, Dh 256 with a window (KV tiles of 32, dK/dV's columns in two
# halves), bidirectional, and Dh 32 (the padded class no other case takes)
# with GQA 2, a window and a ragged S 300
FLASH_CASES = {
    "slice": (16, 36, 36, 256, 64, torch.bfloat16, True, None, None),
    "gemma2_like": (1, 32, 16, 1024, 128, torch.bfloat16, True, 512, 50.0),
    "stablelm_dh160_gqa4": (1, 32, 8, 512, 160, torch.bfloat16, True, None, None),
    "smoke_dh12_f32": (8, 6, 6, 16, 12, torch.float32, True, None, None),
    "dh256_f32_ragged": (1, 4, 2, 200, 256, torch.float32, True, 96, None),
    "bidirectional_f32": (2, 4, 4, 192, 64, torch.float32, False, None, None),
    "smoke_dh12_bf16_gqa2": (8, 6, 3, 16, 12, torch.bfloat16, True, None, None),
    "dh16_bf16_gqa2": (4, 6, 3, 256, 16, torch.bfloat16, True, None, None),
    "ragged_bf16_s200": (1, 8, 4, 200, 64, torch.bfloat16, True, None, None),
    "dh256_bf16_window": (1, 4, 2, 320, 256, torch.bfloat16, True, 96, None),
    "bidirectional_bf16": (2, 4, 4, 192, 64, torch.bfloat16, False, None, None),
    "dh32_bf16_gqa2_window": (2, 8, 4, 300, 32, torch.bfloat16, True, 128, None),
}


def _flash_inputs(name, dev, seed=0):
    B, H, Hkv, S, Dh, dtype, causal, window, softcap = FLASH_CASES[name]
    g = torch.Generator(device="cpu").manual_seed(seed)

    def rnd(n):
        return torch.randn((n, S, Dh), generator=g).to(dev, dtype)

    q, k, v, do = rnd(B * H), rnd(B * Hkv), rnd(B * Hkv), rnd(B * H)
    return q, k, v, do, dict(causal=causal, window=window, softcap=softcap,
                             group=H // Hkv)


def _assert_close(got, want, what):
    bf16 = torch.bfloat16 in (got.dtype, want.dtype)
    got, want = got.float(), want.float()
    scale = want.abs().max().item()
    tol = 2.0 ** -7 * scale if bf16 else 1e-4 * scale + 1e-6
    err = (got - want).abs().max().item()
    assert err <= tol, f"{what}: max|diff| {err:.3g} > {tol:.3g}"


def _run_kernels(q, k, v, do, opts, bound_loop=True):
    o, lse = fa.flash_forward(q, k, v, bound_loop=bound_loop, **opts)
    delta = (o.float() * do.float()).sum(-1)
    dq = fa.flash_dq(q, k, v, do, lse, delta, bound_loop=bound_loop, **opts)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, bound_loop=bound_loop, **opts)
    torch.cuda.synchronize()
    return o, lse, delta, dq, dk, dv


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_kernels_match_plain(cuda, name):
    q, k, v, do, opts = _flash_inputs(name, cuda)
    before = _flash_counts()
    o, lse, delta, dq, dk, dv = _run_kernels(q, k, v, do, opts)
    assert tuple(a - b for a, b in zip(_flash_counts(), before)) == (1, 1, 1)
    o_r, lse_r = fa.flash_forward_reference(q, k, v, **opts)
    _assert_close(o, o_r, "o")
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    assert (lse - lse_r).abs().max().item() <= 1e-4
    dq_r = fa.flash_dq_reference(q, k, v, do, lse, delta, **opts)
    dk_r, dv_r = fa.flash_dkv_reference(q, k, v, do, lse, delta, **opts)
    for got, want, what in ((dq, dq_r, "dq"), (dk, dk_r, "dk"), (dv, dv_r, "dv")):
        assert got.dtype == want.dtype
        _assert_close(got, want, what)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["slice", "gemma2_like", "dh256_f32_ragged",
                                  "dh256_bf16_window", "smoke_dh12_bf16_gqa2"])
def test_flash_bounded_loops_and_reruns_are_bit_equal(cuda, name):
    q, k, v, do, opts = _flash_inputs(name, cuda, seed=1)
    first = _run_kernels(q, k, v, do, opts)
    again = _run_kernels(q, k, v, do, opts)
    exhaustive = _run_kernels(q, k, v, do, opts, bound_loop=False)
    for a, b, c in zip(first, again, exhaustive):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_flash_fully_masked_rows_are_exactly_zero(cuda):
    """window = 0 masks every key of every row: o, dq, dk, dv exactly 0 and
    lse +inf (the masked-row guard)."""
    q, k, v, do, opts = _flash_inputs("bidirectional_f32", cuda, seed=2)
    opts = dict(opts, causal=True, window=0)
    o, lse, _, dq, dk, dv = _run_kernels(q, k, v, do, opts)
    for t in (o, dq, dk, dv):
        assert torch.equal(t, torch.zeros_like(t))
    assert bool(torch.all(torch.isinf(lse) & (lse > 0)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bidirectional_bf16", "smoke_dh12_bf16_gqa2"])
def test_flash_fully_masked_rows_are_exactly_zero_bf16(cuda, name):
    """The same guard in the tensor-core kernels, bounded and exhaustive."""
    q, k, v, do, opts = _flash_inputs(name, cuda, seed=2)
    opts = dict(opts, causal=True, window=0)
    for bound_loop in (True, False):
        o, lse, _, dq, dk, dv = _run_kernels(q, k, v, do, opts, bound_loop=bound_loop)
        for t in (o, dq, dk, dv):
            assert torch.equal(t, torch.zeros_like(t))
        assert bool(torch.all(torch.isinf(lse) & (lse > 0)))


@pytest.mark.cuda
def test_flash_autograd_on_card_matches_cpu(cuda):
    q, k, v, do, opts = _flash_inputs("smoke_dh12_f32", cuda, seed=3)
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        out = fa.flash_attention(*leaves, **opts)
        (out * do.to(dev)).sum().backward()
        grads[dev.type] = [out.detach().cpu()] + [t.grad.cpu() for t in leaves]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        _assert_close(got, want, "autograd")


@pytest.mark.cuda
def test_flash_smem_plans_fit_one_block(cuda):
    """Every tile plan of the CUDA source fits one Hopper block at every
    head dim up to 256; its float32 sums equal the wrapper's
    ``f32_smem_bytes`` (what ``supports`` checks without the library). The
    bf16 plans: bf16 rows of the padded head dim + 8; the forward holds 64 Q
    rows and two K and two V tiles of 64 rows (32 at 256), dQ 64 Q and 64 dO
    rows and the forward's K and V tiles, dK/dV 64 K and V rows, two Q and
    two dO tiles of 64 rows (32 at 160 and 256) and two tiles of lse and
    delta (float32)."""
    for kind in ("fwd", "dq", "dkv"):
        for dh in range(1, fa.MAX_HEAD_DIM + 1):
            for dtype in (torch.bfloat16, torch.float32):
                assert 0 < fa.plan_smem_bytes(kind, dh, dtype) <= fa.SMEM_LIMIT_BYTES, \
                    (kind, dh, dtype)
            assert fa.plan_smem_bytes(kind, dh, torch.float32) == fa.f32_smem_bytes(kind, dh)
    padded = {12: 16, 16: 16, 32: 32, 64: 64, 112: 128, 128: 128, 160: 160, 256: 256}
    for dh, dp in padded.items():
        kv_rows = 32 if dp == 256 else 64
        q_rows = 32 if dp >= 160 else 64
        assert fa.plan_smem_bytes("fwd", dh, torch.bfloat16) == 2 * (64 + 4 * kv_rows) * (dp + 8)
        assert fa.plan_smem_bytes("dq", dh, torch.bfloat16) == (
            2 * (2 * 64 + 4 * kv_rows) * (dp + 8))
        assert fa.plan_smem_bytes("dkv", dh, torch.bfloat16) == (
            2 * (2 * 64 + 4 * q_rows) * (dp + 8) + 16 * q_rows)
    assert fa.plan_smem_bytes("fwd", 64, torch.bfloat16) == 46_080
    assert fa.plan_smem_bytes("dq", 64, torch.bfloat16) == 55_296
    assert fa.plan_smem_bytes("dkv", 64, torch.bfloat16) == 56_320
    with pytest.raises(ValueError, match="head_dim 257"):
        fa.plan_smem_bytes("dq", 257, torch.bfloat16)


@pytest.mark.cuda
def test_flash_refuses_what_it_cannot_take(cuda):
    x = torch.zeros(2, 64, 272, device=cuda)
    with pytest.raises(ValueError, match="head_dim 272"):
        fa.flash_forward(x, x, x)
    h = torch.zeros(2, 64, 32, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa.flash_forward(h, h, h)
    nc = torch.zeros(2, 32, 64, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_forward(nc, nc.contiguous(), nc.contiguous())
    with pytest.raises(ValueError, match="GQA"):
        fa.flash_forward(torch.zeros(3, 64, 32, device=cuda),
                         torch.zeros(2, 64, 32, device=cuda),
                         torch.zeros(2, 64, 32, device=cuda), group=2)


# (BH, T, D, w_low): the JAX kernel test's shapes, a T that is not a multiple
# of the kernels' time tile, w down to 0, a D above one 64-row pass that is
# not a multiple of it, and D 256, which the model never uses (no-refusal
# rule); the grids of one, a few and the subset's 128 streams at D 64 (a
# block per stream: 4 warps forward, 8 backward); D 48; T of one step, one
# short of a tile, one past it and ragged at the path's width; w down to 0 at
# BH 128
RWKV_CASES = {f"jax_{BH}x{T}x{D}": (BH, T, D, 0.4) for BH, T, D, _ in RWKV_SHAPES}
RWKV_CASES.update({"ragged_T": (3, 37, 64, 0.4), "w_to_zero": (2, 40, 12, 0.0),
                   "D100": (2, 50, 100, 0.4), "D256": (2, 40, 256, 0.4),
                   "BH1_D64": (1, 64, 64, 0.4), "BH3_D64": (3, 64, 64, 0.4),
                   "BH128_D64": (128, 256, 64, 0.4), "D48": (2, 40, 48, 0.4),
                   "T1": (2, 1, 64, 0.4), "T15": (2, 15, 64, 0.4), "T17": (2, 17, 64, 0.4),
                   "T250": (2, 250, 64, 0.4), "w_to_zero_BH128": (128, 256, 64, 0.0)})


def _rwkv_on(name, dev, seed=0):
    BH, T, D, w_low = RWKV_CASES[name]
    return [torch.from_numpy(a).to(dev) for a in rwkv_case(BH, T, D, seed=seed, w_low=w_low)]


def _rwkv_kernels(r, k, v, w, u, do):
    o, states = rw.rwkv_scan_forward(r, k, v, w, u, save_states=True)
    grads = rw.rwkv_scan_backward(r, k, v, w, u, do, states)
    torch.cuda.synchronize()
    return (o,) + grads


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(RWKV_CASES))
def test_rwkv_kernels_match_plain(cuda, name):
    r, k, v, w, u, do = _rwkv_on(name, cuda)
    before = (rw.rwkv_scan.launches, rw.rwkv_scan_backward.launches)
    got = _rwkv_kernels(r, k, v, w, u, do)
    assert (rw.rwkv_scan.launches, rw.rwkv_scan_backward.launches) == \
        (before[0] + 1, before[1] + 1)
    want = (rw.rwkv_scan_reference(r, k, v, w, u),) + \
        rw.rwkv_scan_backward_reference(r, k, v, w, u, do)
    for what, a, b in zip(("o", "dr", "dk", "dv", "dw", "du"), got, want):
        scale = b.abs().max().item()
        tol = (1e-5 if what == "o" else 1e-4) * scale + 1e-6
        err = (a - b).abs().max().item()
        assert a.shape == b.shape and err <= tol, f"{name} {what}: {err:.3g} > {tol:.3g}"
    # the no-grad forward writes no states and gives the same output
    o_only, none = rw.rwkv_scan_forward(r, k, v, w, u)
    assert none is None and torch.equal(o_only, got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ragged_T", "D100", "BH128_D64"])
def test_rwkv_reruns_are_bit_equal(cuda, name):
    args = _rwkv_on(name, cuda, seed=1)
    first, again = _rwkv_kernels(*args), _rwkv_kernels(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ragged_T", "T17"])
def test_rwkv_unaligned_inputs_give_the_same_bits(cuda, name):
    """Inputs that do not start on 16 bytes take the kernels' 4-byte copies
    instead of the 16-byte ones: the same values land in shared memory, so
    the outputs are bit-equal."""
    r, k, v, w, u, do = _rwkv_on(name, cuda, seed=3)

    def shifted(t):
        return torch.empty(t.numel() + 1, device=t.device)[1:].view_as(t).copy_(t)
    aligned = _rwkv_kernels(r, k, v, w, u, do)
    moved = _rwkv_kernels(*(shifted(t) for t in (r, k, v, w)), u, shifted(do))
    assert all(torch.equal(a, b) for a, b in zip(aligned, moved))


@pytest.mark.cuda
def test_rwkv_backward_shared_memory_matches_its_plan(cuda):
    assert rw._launchers()["backward_smem_bytes"]() == rw.backward_smem_bytes()


@pytest.mark.cuda
def test_rwkv_autograd_on_card_matches_cpu(cuda):
    r, k, v, w, u, do = _rwkv_on("ragged_T", "cpu", seed=2)
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        leaves = [t.to(dev).requires_grad_() for t in (r, k, v, w, u)]
        out = rw.rwkv_scan(*leaves)
        (out * do.to(dev)).sum().backward()
        grads[dev.type] = [out.detach().cpu()] + [t.grad.cpu() for t in leaves]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item() + 1e-6


@pytest.mark.cuda
def test_rwkv_refuses_what_it_cannot_take(cuda):
    x = torch.zeros(2, 16, 8, device=cuda)
    u = torch.zeros(2, 8, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        rw.rwkv_scan_forward(x.double(), x, x, x, u)
    with pytest.raises(ValueError, match="contiguous"):
        rw.rwkv_scan_forward(x.transpose(1, 2).contiguous().transpose(1, 2), x, x, x, u)
    with pytest.raises(ValueError, match="tile states"):
        rw.rwkv_scan_backward(x, x, x, x, u, x, None)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        rw.rwkv_scan_forward(x, x, x, x.cpu(), u)


@pytest.mark.cuda
def test_trainer_on_card_runs_rwkv_kernels(cuda):
    """rwkv6-7b smoke on the card: 4 steps, refresh every 2, 2 layers, no
    remat: per layer one forward launch per step and per refresh, one
    backward launch per step."""
    from repro_torch.api import ExperimentConfig, Trainer
    cfg = ExperimentConfig().apply_overrides(
        ["model.arch=rwkv6-7b", "train.steps=4", "train.batch=8", "train.seq=16",
         "graft.rset=[2,4]", "graft.refresh_every=2", "graft.use_pallas=true",
         "train.log_every=0"])
    before = (rw.rwkv_scan.launches, rw.rwkv_scan_backward.launches, graft_select.launches)
    report = Trainer(cfg).fit()
    after = (rw.rwkv_scan.launches, rw.rwkv_scan_backward.launches, graft_select.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (2 * (4 + 2), 2 * 4, 2)
    assert all(np.isfinite(r["loss"]) and r["rank"] in (2, 4) for r in report["history"])


# ---------------------------------------------------------------------------
# the optimizer step: kernel A (global norm + clip factor), kernel B (update)
# ---------------------------------------------------------------------------

# leaf shapes: a 16-byte-aligned matrix, a ragged vector (numel % 8 != 0), a
# leaf longer than one 4096-element chunk with a ragged tail, and one that
# starts 1 element past its buffer (not 16-byte aligned: the element path)
OPT_LEAVES = [((33, 64), True), ((7,), True), ((4099,), True), ((5, 13), False)]


def _opt_leaves(dev, dtype, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    out = []
    for shape, aligned in OPT_LEAVES:
        x = (torch.randn(shape, generator=g) * scale).to(dtype).to(dev)
        if not aligned:
            x = torch.empty(x.numel() + 1, dtype=dtype, device=dev)[1:].view(shape).copy_(x)
        out.append(x)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_grad_norm_kernel_matches_plain(cuda, dtype):
    from repro_torch.kernels import fused_optim as fo
    grads = _opt_leaves(cuda, dtype, seed=1) + _opt_leaves(cuda, torch.float32, seed=2)
    assert grads[-1].data_ptr() % 16 != 0
    norm, scale = fo.grad_norm(grads, 1.0)
    want_norm, want_scale = fo.grad_norm_reference(grads, 1.0)
    assert abs(norm.item() - want_norm.item()) <= 1e-6 * want_norm.item()
    assert abs(scale.item() - want_scale.item()) <= 1e-6 * want_scale.item()
    again = fo.grad_norm(grads, 1.0)
    assert torch.equal(again[0], norm) and torch.equal(again[1], scale)
    n0, s0 = fo.grad_norm(grads, None)
    assert torch.equal(n0, norm) and s0.item() == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["adamw", "sgd", "lion"])
@pytest.mark.parametrize("pdt,sdt", [(torch.bfloat16, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.float32),
                                     (torch.float32, torch.bfloat16)])
def test_update_kernel_is_bit_equal_to_plain(cuda, rule, pdt, sdt):
    """Three steps of kernel B against the plain per-leaf code on the card,
    given kernel A's clip factor: p, m and v bit-equal, also for the ragged
    and the misaligned leaf."""
    from repro_torch.kernels import fused_optim as fo
    params = {k: _opt_leaves(cuda, pdt, seed=3) for k in ("kernel", "plain")}
    moments = {k: [_opt_leaves(cuda, sdt, seed=4, scale=0.1),
                   [x.abs() for x in _opt_leaves(cuda, sdt, seed=5, scale=0.01)]]
               for k in ("kernel", "plain")}
    for step in range(3):
        grads = _opt_leaves(cuda, pdt, seed=10 + step, scale=3.0)
        _, scale = fo.grad_norm(grads, 1.0)
        t = np.float32(step + 1)
        hp = fo.Hyper(lr=1e-2 / (step + 1), beta1=0.9, beta2=0.95, eps=1e-8,
                      weight_decay=0.01, momentum=0.9,
                      bc1=float(np.float32(1) - np.float32(0.9) ** t),
                      bc2=float(np.float32(1) - np.float32(0.95) ** t))
        for key, fn in (("kernel", fo.optimizer_update), ("plain", fo.update_reference)):
            m, v = moments[key]
            fn(rule, params[key], grads, m, v if rule == "adamw" else None, hp, scale)
    torch.cuda.synchronize()
    for name, a, b in [("p", params["kernel"], params["plain"]),
                       ("m", moments["kernel"][0], moments["plain"][0]),
                       ("v", moments["kernel"][1], moments["plain"][1])]:
        for i, (x, y) in enumerate(zip(a, b)):
            assert torch.equal(x, y), (name, i, (x.float() - y.float()).abs().max().item())


@pytest.mark.cuda
def test_optimizer_kernels_refuse_what_they_cannot_take(cuda):
    from repro_torch.kernels import fused_optim as fo
    x = torch.zeros(8, 8, device=cuda)
    hp = fo.Hyper(lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.0, momentum=0.9)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fo.grad_norm([x.double()], 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        fo.grad_norm([x.t()], 1.0)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fo.optimizer_update("sgd", [x], [x.cpu()], [x.clone()], None, hp)
    with pytest.raises(ValueError, match="match the param"):
        fo.optimizer_update("sgd", [x], [x.bfloat16()], [x.clone()], None, hp)
    with pytest.raises(ValueError, match="v must be given"):
        fo.optimizer_update("adamw", [x], [x], [x.clone()], None, hp)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["adamw", "sgd", "lion"])
def test_trainer_on_card_launches_the_optimizer_kernels_once_a_step(cuda, name):
    """A 2-step Trainer run on the card: one norm launch per step and one
    update launch per step and (param dtype, state dtype) group (minicpm
    smoke: bf16 matrices and float32 norm scales, 2 groups)."""
    from repro_torch.api import ExperimentConfig, Trainer
    from repro_torch.kernels import fused_optim as fo
    cfg = ExperimentConfig().apply_overrides(
        ["train.steps=2", "train.batch=8", "train.seq=16", "graft.rset=[2,4]",
         "graft.refresh_every=2", "graft.use_pallas=true", "train.log_every=0",
         f"optimizer.name={name}"])
    before = (fo.grad_norm.launches, fo.optimizer_update.launches)
    trainer = Trainer(cfg)
    report = trainer.fit()
    after = (fo.grad_norm.launches, fo.optimizer_update.launches)
    groups = len({p.dtype for p in trainer.state["params"]})
    assert groups == 2
    assert (after[0] - before[0], after[1] - before[1]) == (2, 2 * groups)
    assert all(np.isfinite(r["loss"]) for r in report["history"])
    assert report["host_loop"]["device_timed_steps"] == 1      # CUDA-event clock


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["adamw", "sgd", "lion"])
def test_optimizer_step_on_card_writes_no_clipped_copy_and_never_syncs(cuda, name):
    """``preprocess`` returns the gradients themselves with the clip factor
    on the device; ``preprocess`` + ``update`` are one launch of each kernel
    and no host sync (PyTorch's sync debug mode raises on one)."""
    from repro_torch.kernels import fused_optim as fo
    from repro_torch.optim import ClippedGrads, OptimizerConfig, make_optimizer
    opt = make_optimizer(OptimizerConfig(name=name, clip_norm=1.0))
    params = _opt_leaves(cuda, torch.bfloat16, seed=1)
    grads = _opt_leaves(cuda, torch.bfloat16, seed=2, scale=3.0)
    state = opt.init(params)
    opt.apply(params, grads, state, 0)              # build and warm up first
    before = (fo.grad_norm.launches, fo.optimizer_update.launches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        clipped, metrics = opt.preprocess(grads)
        opt.update(params, clipped, state, 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert isinstance(clipped, ClippedGrads) and clipped.clip_scale.is_cuda
    assert all(c is g for c, g in zip(clipped, grads))
    assert metrics["grad_norm"].is_cuda
    assert (fo.grad_norm.launches - before[0], fo.optimizer_update.launches - before[1]) == (1, 1)


@pytest.mark.cuda
def test_vetoed_step_on_card_launches_no_update(cuda):
    """The sentinel reads the norm kernel's result and vetoes a non-finite
    step before the update: one grad_norm launch, no optimizer_update, the
    parameters untouched."""
    from repro_torch.api import ExperimentConfig
    from repro_torch.kernels import fused_optim as fo
    from repro_torch.launch import steps as steps_lib
    cfg = ExperimentConfig().apply_overrides(
        ["train.batch=8", "train.seq=16", "graft.rset=[2,4]", "graft.use_pallas=true"])
    mcfg, tcfg, data = cfg.build()
    state = steps_lib.init_train_state(mcfg, tcfg, torch.Generator(device=cuda).manual_seed(0),
                                       8, cuda)
    with torch.no_grad():
        state["model"].blocks[0].mlp["w_up"][0, 0] = float("nan")
    before = [p.detach().clone() for p in state["params"]]
    counts = (fo.grad_norm.launches, fo.optimizer_update.launches)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in data.batch_at(0).items()}
    state, metrics = steps_lib.make_train_step(mcfg, tcfg)(state, batch)
    assert metrics["healthy"] == 0.0 and state["step"] == 1
    assert (fo.grad_norm.launches - counts[0], fo.optimizer_update.launches - counts[1]) == (1, 0)
    assert all(torch.equal(a.nan_to_num(), b.nan_to_num()) and torch.equal(a.isnan(), b.isnan())
               for a, b in zip(before, state["params"]))


# ---------------------------------------------------------------------------
# the baseline samplers, the sources, streaming and graft.overlap
# ---------------------------------------------------------------------------

SAMPLER_NAMES = ("graft", "random", "loss_topk", "full", "el2n", "gradmatch", "craig",
                 "glister")


@pytest.mark.cuda
@pytest.mark.parametrize("name", SAMPLER_NAMES)
def test_sampler_on_card_matches_cpu(cuda, name):
    """d 2304, K 16, R 8 (seed 0 keeps CRAIG's gains apart): pivots, rank and
    step equal; weights bit-equal (GradMatch rtol 1e-4, a float32 solve);
    last_error and alignment within 1e-5 relative."""
    from repro_torch.selection import engine
    from repro_torch.selection.base import GraftConfig
    from torch_cases import sampler_case
    cfg = GraftConfig(rset=(2, 4, 8), use_pallas=True)
    host = [torch.from_numpy(a) for a in sampler_case(2304, 16, 8, seed=0)]
    dev = [t.to(cuda) for t in host]
    got, _ = engine.select_batch(cfg, name, *dev[:3], scores=dev[3], step=3)
    want, _ = engine.select_batch(cfg, name, *host[:3], scores=host[3], step=3)
    assert got.pivots.tolist() == want.pivots.tolist()
    assert int(got.rank) == int(want.rank) and int(got.step) == int(want.step) == 3
    if name == "gradmatch":
        torch.testing.assert_close(got.weights.cpu(), want.weights, rtol=1e-4, atol=1e-7)
    else:
        assert torch.equal(got.weights.cpu(), want.weights)
    for f in ("last_error", "alignment"):
        a, b = float(getattr(got, f)), float(getattr(want, f))
        assert abs(a - b) <= 1e-5 * abs(b) + 1e-6, f


@pytest.mark.cuda
def test_sources_on_card_match_cpu(cuda):
    """Every feature source up to column sign within 1e-4 of max|V|, and the
    probe and logit_embed grad sources within 1e-5 of max|G|."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as model_lib
    from repro_torch.selection import sources
    g = torch.Generator().manual_seed(0)
    A = torch.randn(16, 2304, generator=g)
    for name in sources.available_features():
        fx = sources.resolve_features(name)
        got, want = fx(A.to(cuda), 8).cpu().double(), fx(A, 8).double()
        signs = (got * want).sum(0).sign()
        assert (got * signs - want).abs().max() <= 1e-4 * want.abs().max(), name
    mcfg = get_smoke_config("minicpm-2b", param_dtype="float32")
    model = model_lib.init_params(mcfg, torch.Generator().manual_seed(0))
    logits = torch.randn(8, 5, mcfg.vocab_size, generator=g)
    labels = torch.randint(0, mcfg.vocab_size, (8, 5), generator=g)
    hiddens = torch.randn(8, 5, mcfg.d_model, generator=g)
    mask = (torch.rand(8, 5, generator=g) > 0.3).float()
    card_model = copy.deepcopy(model).to(cuda)
    for name in ("probe", "logit_embed"):
        src = sources.resolve_grad_source(name)
        with torch.no_grad():
            want = src(sources.GradSourceInputs(logits, labels, hiddens, mcfg=mcfg,
                                                params=model.tree(), mask=mask))
            got = src(sources.GradSourceInputs(logits.to(cuda), labels.to(cuda),
                                               hiddens.to(cuda), mcfg=mcfg,
                                               params=card_model.tree(), mask=mask.to(cuda)))
        assert (got.cpu() - want).abs().max() <= 1e-5 * want.abs().max(), name


@pytest.mark.cuda
def test_streaming_on_card_launches_the_refresh_kernel_once_a_refresh(cuda):
    """Four refreshes at d 2304: four graft_select launches, every refresh
    equal to the CPU's (pivots; weights, errors and carry within 1e-5)."""
    from repro_torch.selection import engine
    from repro_torch.selection.base import GraftConfig
    from torch_cases import sampler_case
    cfg = GraftConfig(rset=(2, 4, 8), use_pallas=True)
    carry = carry_cpu = None
    before = graft_select.launches
    for i in range(4):
        host = [torch.from_numpy(a) for a in sampler_case(2304, 16, 8, seed=10 + i)]
        got, carry = engine.select_batch(cfg, "streaming_graft", *(t.to(cuda) for t in host[:3]),
                                         carry=carry, step=i)
        want, carry_cpu = engine.select_batch(cfg, "streaming_graft", *host[:3],
                                              carry=carry_cpu, step=i)
        assert got.pivots.tolist() == want.pivots.tolist() and int(got.rank) == int(want.rank)
        torch.testing.assert_close(got.weights.cpu(), want.weights, rtol=1e-5, atol=1e-6)
        assert abs(float(got.last_error) - float(want.last_error)) <= 1e-5
    assert graft_select.launches - before == 4
    sk, skc = carry.sketch.cpu().double(), carry_cpu.sketch.double()
    assert ((sk.T @ sk) - (skc.T @ skc)).abs().max() <= 1e-5 * (skc.T @ skc).abs().max()
    assert float(carry.count) == 4.0 and carry.sketch.is_cuda


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["graft", "streaming_graft"])
def test_overlap_on_card_is_bit_identical_to_sequential(cuda, sampler):
    """``graft.overlap`` on the card: the same losses, ranks and pivots as
    the sequential step, bit for bit, and the same launches."""
    from repro_torch.api import ExperimentConfig
    from repro_torch.launch import steps as steps_lib
    runs = {}
    for overlap in (False, True):
        cfg = ExperimentConfig().apply_overrides(
            ["train.steps=6", "train.batch=8", "train.seq=16", "graft.rset=[2,4]",
             "graft.refresh_every=2", "graft.use_pallas=true", f"train.sampler={sampler}",
             f"graft.overlap={str(overlap).lower()}",
             'model.overrides={"attn_backend": "flash"}'])
        mcfg, tcfg, data = cfg.build()
        state = steps_lib.init_train_state(mcfg, tcfg, torch.Generator(cuda).manual_seed(0), 8,
                                           cuda)
        run_step = steps_lib.make_run_step(mcfg, tcfg)
        before = (graft_select.launches, fa.flash_attention.forward_launches)
        rows = []
        for step in range(6):
            batch = {k: torch.from_numpy(v).to(cuda) for k, v in data.batch_at(step).items()}
            state, m = run_step(state, batch)
            rows.append((m["loss"].item(), int(m["rank"]), state["graft"].pivots.tolist()))
        launches = (graft_select.launches - before[0],
                    fa.flash_attention.forward_launches - before[1])
        runs[overlap] = (rows, launches, [p.detach().clone() for p in state["params"]])
    assert runs[True][0] == runs[False][0] and runs[True][1] == runs[False][1]
    assert all(torch.equal(a, b) for a, b in zip(runs[True][2], runs[False][2]))


@pytest.mark.cuda
def test_full_grad_source_on_card_runs_the_flash_kernels(cuda):
    """The ``full`` grad source differentiates each example through the
    flash kernels: dQ and dK/dV launch once a layer an example, and G is
    within 1e-4 of max|G| of the CPU's dense-attention run (float32; the
    online softmax sums in another order)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as model_lib
    from repro_torch.selection import sources
    mcfg = get_smoke_config("minicpm-2b", param_dtype="float32", attn_backend="flash")
    model = model_lib.init_params(mcfg, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, mcfg.vocab_size, (4, 16), generator=g),
             "labels": torch.randint(0, mcfg.vocab_size, (4, 16), generator=g)}
    src = sources.resolve_grad_source("full")
    with torch.no_grad():
        want = src(sources.GradSourceInputs(None, None, None, mcfg=mcfg, params=model.tree(),
                                            batch=batch))
        before = _flash_counts()
        got = src(sources.GradSourceInputs(
            None, None, None, mcfg=mcfg, params=model.to(cuda).tree(),
            batch={k: v.to(cuda) for k, v in batch.items()}))
        after = _flash_counts()
    fwd, dq, dkv = (a - b for a, b in zip(after, before))
    assert dq == dkv == 4 * mcfg.num_layers and fwd >= 4 * mcfg.num_layers
    assert (got.cpu() - want).abs().max() <= 1e-4 * want.abs().max()


# ---------------------------------------------------------------------------
# the moe and hybrid families, remat = dots
# ---------------------------------------------------------------------------

def _moe_params(dev, seed=0):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import layers
    cfg = get_smoke_config("qwen3-moe-235b-a22b", param_dtype="float32",
                           moe_capacity_factor=0.5)
    g = torch.Generator().manual_seed(seed)
    p = {n: (torch.randn(shape, generator=g) * shape[-2] ** -0.5).to(t)
         for n, (shape, t) in layers.moe_shapes(cfg, torch.float32).items()}
    x = torch.randn(4, 32, cfg.d_model, generator=g)
    return cfg, {n: v.to(dev).requires_grad_() for n, v in p.items()}, x.to(dev)


@pytest.mark.cuda
def test_moe_on_card_matches_cpu_and_reruns_bit_equal(cuda):
    """float32 with drops (capacity factor 0.5): expert ids and keep masks
    equal to the CPU's, output and gradients within 1e-5 of max|CPU|
    (cuBLAS sums in another order); two card runs bit-equal (the combine
    and the dispatch's backward gather, no atomics)."""
    from repro_torch.models import layers
    runs = []
    for dev in ("cpu", cuda, cuda):
        cfg, p, x = _moe_params(dev)
        x.requires_grad_()
        r = layers.moe_routing(cfg, p["router"], layers.moe_groups(cfg, x)[0])
        out = layers.moe(cfg, p, x)
        grads = torch.autograd.grad(out, [x] + [p[n] for n in sorted(p)],
                                    torch.ones_like(out))
        runs.append((r.ids.cpu(), r.keep.cpu(), out.detach().cpu(), [g.cpu() for g in grads]))
    (ids0, keep0, out0, g0), (ids1, keep1, out1, g1), (_, _, out2, g2) = runs
    assert torch.equal(ids0, ids1) and torch.equal(keep0, keep1) and not bool(keep0.all())
    assert (out1 - out0).abs().max() <= 1e-5 * out0.abs().max()
    for a, b in zip(g1, g0):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()
    assert torch.equal(out1, out2) and all(torch.equal(a, b) for a, b in zip(g1, g2))


@pytest.mark.cuda
def test_ssm_heads_on_card_match_cpu(cuda):
    """float32: output and gradients within 1e-5 of max|CPU| (the same
    recurrence order; the projections' sums in another)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import ssm
    cfg = get_smoke_config("hymba-1.5b", param_dtype="float32")
    g = torch.Generator().manual_seed(0)
    p = {n: torch.randn(shape, generator=g) * 0.2 for n, (shape, _) in
         ssm.ssm_shapes(cfg, torch.float32).items()}
    x = torch.randn(3, 40, cfg.d_model, generator=g)
    runs = []
    for dev in ("cpu", cuda):
        pd = {n: v.to(dev).requires_grad_() for n, v in p.items()}
        xd = x.to(dev).requires_grad_()
        out, _ = ssm.ssm_heads(cfg, pd, xd)
        grads = torch.autograd.grad(out, [xd] + [pd[n] for n in sorted(pd)],
                                    torch.ones_like(out))
        runs.append([out.detach().cpu()] + [t.cpu() for t in grads])
    for a, b in zip(runs[1], runs[0]):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["minicpm-2b", "qwen3-moe-235b-a22b", "hymba-1.5b"])
def test_remat_dots_on_card_is_bit_equal_to_full(cuda, arch):
    """Under flash, the loss and every gradient bit-equal between ``dots``
    and ``full``, and the flash forward launched twice a layer (the forward
    and its recompute) under both."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as model_lib
    runs = {}
    for remat in ("full", "dots"):
        cfg = get_smoke_config(arch, param_dtype="float32", attn_backend="flash", remat=remat)
        model = model_lib.init_params(cfg, torch.Generator().manual_seed(0)).to(cuda)
        g = torch.Generator().manual_seed(1)
        batch = {k: torch.randint(0, cfg.vocab_size, (4, 32), generator=g).to(cuda)
                 for k in ("tokens", "labels")}
        before = _flash_counts()
        loss = model_lib.loss_fn(cfg, model, batch)[0]
        grads = torch.autograd.grad(loss, list(model.parameters()))
        fwd = _flash_counts()[0] - before[0]
        runs[remat] = (loss.detach(), grads, fwd)
        assert fwd == 2 * cfg.num_layers
    assert torch.equal(runs["full"][0], runs["dots"][0])
    assert all(torch.equal(a, b) for a, b in zip(runs["full"][1], runs["dots"][1]))

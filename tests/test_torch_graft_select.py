"""The port's fused GRAFT refresh (``repro_torch.kernels.graft_select``)
against the JAX package's Pallas kernel, on the CPU.

The wrapper runs its plain twin for CPU tensors; the same numpy inputs go
to ``fused_graft_select_pallas(..., interpret=True)``. Pivots and the
gathered ``G_sel`` must be EXACTLY equal (the elimination rounds once in
both; the gather is a copy). ``errors`` agree to atol 1e-5 and ``logvol``
to rtol 1e-5: both are sums taken in another order (the Gram-Schmidt
reductions over d, the log accumulation), so they differ by float32
reassociation only. The hand-written kernel itself is held against the
twin on the card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.graft_select import fused_graft_select_pallas
from repro_torch.analysis import smem
from repro_torch.analysis.smem import SMEM_LIMIT_BYTES
from repro_torch.kernels.graft_select import graft_select
from torch_cases import CASES, assert_refresh_match, graft_case


@pytest.mark.parametrize("name", CASES)
def test_twin_matches_pallas_kernel(name):
    V, G, gb, rank = graft_case(name)
    want = fused_graft_select_pallas(jnp.asarray(V), jnp.asarray(G),
                                     jnp.asarray(gb), rank, interpret=True)
    before = graft_select.launches
    got = graft_select(torch.from_numpy(V), torch.from_numpy(G),
                       torch.from_numpy(gb), rank)
    assert graft_select.launches == before, "CPU tensors must not count a launch"
    assert got[0].dtype == torch.int32 and got[3].shape == (G.shape[0], rank)
    assert_refresh_match([t.numpy() for t in got], want)


def test_prefix_errors_monotone_and_pivots_distinct():
    V, G, gb, rank = graft_case("rank_deficient")
    piv, err, _, _ = graft_select(torch.from_numpy(V), torch.from_numpy(G),
                                  torch.from_numpy(gb), rank)
    assert len(set(piv.tolist())) == rank
    assert torch.all(torch.diff(err) <= 1e-5)


def test_shape_validation():
    V = torch.zeros(16, 8)
    with pytest.raises(ValueError, match="columns"):
        graft_select(V, torch.zeros(4, 12), torch.zeros(4), 4)
    with pytest.raises(ValueError, match="rank"):
        graft_select(V, torch.zeros(4, 16), torch.zeros(4), 12)
    with pytest.raises(ValueError, match="g_bar"):
        graft_select(V, torch.zeros(4, 16), torch.zeros(5), 4)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        graft_select(V.to("meta"), torch.zeros(4, 16, device="meta"),
                     torch.zeros(4, device="meta"), 4)


# (K, R, d, rank, W plan, basis plan) the wrapper picks: the minicpm-2b and
# rwkv6-7b refreshes, gemma2-27b's and stablelm-12b's widths at rank 8, a
# wide refresh whose basis does not fit, and a V that does not fit either
PLAN_CASES = [(16, 8, 2304, 8, "shared", "shared"), (16, 8, 4096, 8, "shared", "shared"),
              (16, 8, 4608, 8, "shared", "shared"), (16, 8, 5120, 8, "shared", "shared"),
              (256, 64, 4096, 64, "shared", "global"),
              (1024, 64, 1024, 64, "global", "global")]


@pytest.mark.parametrize("K,R,d,rank,plan,basis", PLAN_CASES)
def test_shared_memory_budget_formula(K, R, d, rank, plan, basis):
    """V's K·R·4 bytes (shared W plan) and the basis's (rank+1)·d·4 bytes
    (shared basis plan) dominate the block's shared memory; the rest is the
    per-rank and per-warp scratch with its two reduction slots, and for
    K <= 16 the warps' tiles that stage G's rows. The slice's
    and the wide test shape's V fit, a 1024×64 V does not."""
    from repro_torch.analysis.smem import basis_words, work_words

    def smem_bytes(K, R, rank, plan="shared", basis_d=0):
        return smem.graft_select_smem(K, R, basis_d, rank, plan,
                                      "shared" if basis_d else "global").total

    tiles = 256 * (K + 1) if K <= 16 else 0        # G's staging tiles, 32 rows a warp
    rest = 4 * ((2 * 8 + 2) * rank + 2 * 8 + 2 + tiles)
    for p in ("shared", "global"):
        work = 4 * work_words(K, R) if p == "shared" else 0
        assert smem_bytes(K, R, rank, p) == work + rest
        assert smem_bytes(K, R, rank, p, d) == work + 4 * basis_words(d, rank) + rest
    assert basis_words(d, rank) == (rank + 1) * d
    on_chip = smem_bytes(K, R, rank, plan, d if basis == "shared" else 0)
    assert on_chip <= SMEM_LIMIT_BYTES
    assert (smem_bytes(K, R, rank, plan, d) <= SMEM_LIMIT_BYTES) == (basis == "shared")
    assert smem_bytes(16, 8, 8) < SMEM_LIMIT_BYTES
    assert smem_bytes(256, 64, 64) < SMEM_LIMIT_BYTES
    assert smem_bytes(1024, 64, 64) > SMEM_LIMIT_BYTES
    assert smem_bytes(256, 64, 64) >= 256 * 64 * 4
    # the slice's basis: 9 rows of 2304 floats, 73.7 KB of Qᵀ and 9.2 KB of ĝ
    assert smem_bytes(16, 8, 8, "shared", 2304) - smem_bytes(16, 8, 8) == 4 * 9 * 2304


def test_unfused_chain_vs_pallas_reference_chain():
    """The port's building blocks agree with the JAX ones on the degenerate
    case too: separate fast_maxvol → gather → prefix sweep."""
    from repro.core import maxvol as jmaxvol, projection as jproj
    from repro_torch.core import maxvol as tmaxvol, projection as tproj
    V, G, gb, rank = graft_case("rank_deficient")
    jp, jlv = jmaxvol.fast_maxvol(jnp.asarray(V), rank)
    tp, tlv = tmaxvol.fast_maxvol(torch.from_numpy(V), rank)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    np.testing.assert_allclose(float(jlv), float(tlv), rtol=1e-5)
    je = jproj.prefix_projection_errors(jnp.asarray(G[:, np.asarray(jp)]), jnp.asarray(gb))
    te = tproj.prefix_projection_errors(torch.from_numpy(G[:, tp.numpy()]),
                                        torch.from_numpy(gb))
    np.testing.assert_allclose(np.asarray(je), te.numpy(), atol=1e-5)


@pytest.mark.parametrize("K,R,d,rank,plan,basis", PLAN_CASES)
def test_plan_choice_and_the_fused_budget_refusal(K, R, d, rank, plan, basis):
    """The wrapper keeps V's working copy and the Gram-Schmidt basis in
    shared memory where they fit and in a global scratch where they do not
    (1024×64 runs now); forcing a shared plan that does not fit raises. It
    refuses exactly what the JAX kernel's 12 MB estimate refuses, with the
    same message."""
    from repro_torch.analysis.smem import VMEM_BUDGET_BYTES
    from repro_torch.kernels.graft_select import (choose_basis, choose_plan, resolve_basis,
                                                  resolve_plan)

    def fused_budget_bytes(K, R, d, rank):
        return smem.fused_select_vmem(K, R, d, rank).total

    assert choose_plan(K, R, rank) == plan
    assert choose_basis(K, R, d, rank, plan) == basis
    assert resolve_basis(K, R, d, rank, plan, None) == basis
    assert resolve_basis(K, R, d, rank, plan, "global") == "global"
    if basis == "global":
        with pytest.raises(ValueError, match="shared basis"):
            resolve_basis(K, R, d, rank, plan, "shared")
    if plan == "global":
        with pytest.raises(ValueError, match="shared plan"):
            resolve_plan(K, R, rank, "shared")
    assert fused_budget_bytes(K, R, d, rank) < VMEM_BUDGET_BYTES
    assert choose_plan(16, 8, 8) == "shared"
    assert choose_plan(256, 64, 64) == "shared"
    assert choose_plan(1024, 64, 64) == "global"
    assert choose_plan(2048, 256, 256) == "global"
    # the global plans keep only the per-rank and per-warp scratch in a block
    assert smem.graft_select_smem(1024, 64, 8, 64, "global").total == \
        4 * ((2 * 8 + 2) * 64 + 2 * 8 + 2)
    assert fused_budget_bytes(1024, 64, 8, 64) < VMEM_BUDGET_BYTES
    V = torch.zeros(1024, 64)
    got = graft_select(V, torch.zeros(8, 1024), torch.zeros(8), 64)   # plain version
    assert got[0].shape == (64,) and len(set(got[0].tolist())) == 64
    big = dict(V=np.zeros((1024, 64), np.float32), G=np.zeros((4096, 1024), np.float32),
               gb=np.zeros(4096, np.float32))                        # 16 MB of G
    assert fused_budget_bytes(1024, 64, 4096, 8) > VMEM_BUDGET_BYTES
    with pytest.raises(ValueError) as want:
        fused_graft_select_pallas(jnp.asarray(big["V"]), jnp.asarray(big["G"]),
                                  jnp.asarray(big["gb"]), 8, interpret=True)
    with pytest.raises(ValueError) as got_err:
        graft_select(torch.from_numpy(big["V"]), torch.from_numpy(big["G"]),
                     torch.from_numpy(big["gb"]), 8)
    assert str(got_err.value) == str(want.value)
    assert "VMEM budget" in str(got_err.value)

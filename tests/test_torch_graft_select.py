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
from repro_torch.kernels.graft_select import (SMEM_LIMIT_BYTES, graft_select,
                                              smem_bytes)
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


def test_shared_memory_budget_formula():
    """V's K·R·4 bytes dominate the block's shared memory; the slice's and
    the wide test shape fit, a 1024×64 V does not."""
    assert smem_bytes(16, 8, 8) < SMEM_LIMIT_BYTES
    assert smem_bytes(256, 64, 64) < SMEM_LIMIT_BYTES
    assert smem_bytes(1024, 64, 64) > SMEM_LIMIT_BYTES
    assert smem_bytes(256, 64, 64) >= 256 * 64 * 4


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

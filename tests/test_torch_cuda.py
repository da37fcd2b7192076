"""Card-only tests of the port: the hand-written CUDA kernel against its
plain PyTorch twin, and a short GPU training run. Marked ``cuda``; they
skip where there is no NVIDIA GPU. Imports no JAX, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: pivots and ``G_sel`` bit-equal (same single-rounding
elimination; the gather is a copy); errors atol 1e-5 and logvol rtol 1e-5,
because the kernel's block reductions sum in another order than PyTorch.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.graft_select import graft_select, graft_select_reference
from torch_cases import CASES, assert_refresh_match, graft_case


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
    V = torch.zeros(1024, 64, device=cuda)
    G = torch.zeros(8, 1024, device=cuda)
    with pytest.raises(ValueError, match="232448"):
        graft_select(V, G, torch.zeros(8, device=cuda), 8)
    with pytest.raises(TypeError, match="float32"):
        graft_select(V[:16].double(), G[:, :16].double(),
                     torch.zeros(8, device=cuda, dtype=torch.float64), 4)
    with pytest.raises(ValueError, match="contiguous"):
        graft_select(torch.zeros(8, 16, device=cuda).T, G[:, :16],
                     torch.zeros(8, device=cuda), 4)


@pytest.mark.cuda
def test_trainer_on_card_launches_kernel_per_refresh(cuda):
    from repro_torch.api import ExperimentConfig, Trainer
    cfg = ExperimentConfig().apply_overrides(
        ["train.steps=4", "train.batch=8", "train.seq=16", "graft.rset=[2,4]",
         "graft.refresh_every=2", "graft.use_pallas=true", "train.log_every=0"])
    before = graft_select.launches
    report = Trainer(cfg).fit()
    assert graft_select.launches - before == 2
    assert report["device"].startswith("cuda")
    assert all(np.isfinite(r["loss"]) and r["rank"] in (2, 4)
               for r in report["history"])

"""Hand-written Hopper kernels (``csrc/``) with their plain PyTorch twins.

Ported: ``graft_select`` (the fused GRAFT refresh). The flash-attention,
batched-refresh, standalone MaxVol / projection-sweep and RWKV kernels of
the JAX package are listed as still to port in ``ROADMAP.md``. Nothing here
imports Triton or builds a kernel at import time: ``build.load`` runs at
the first launch.
"""

"""Hand-written Hopper kernels (``csrc/``) with their plain PyTorch twins.

Ported: ``graft_select`` (the fused GRAFT refresh, single and batched),
``fast_maxvol`` and ``projection_sweep`` (its stages 1 and 3 alone), all
three in ``csrc/graft_select.cu``, and ``flash_attention`` (the forward, dQ
and dK/dV kernels). ``ops`` is the twin of the JAX package's
``kernels/ops.py``. The RWKV kernel of the JAX package is still to port
(``ROADMAP.md``, B8). Nothing here imports Triton or builds a kernel at
import time: ``build.load`` runs at the first launch.
"""

"""Hand-written Hopper kernels (``csrc/``) with their plain PyTorch twins.

Ported: ``graft_select`` (the fused GRAFT refresh, single and batched),
``fast_maxvol`` and ``projection_sweep`` (its stages 1 and 3 alone), all
three in ``csrc/graft_select.cu``, ``flash_attention`` (the forward, dQ
and dK/dV kernels) and ``rwkv_scan`` (the RWKV6 recurrence's forward and a
backward kernel for its gradient, ``csrc/rwkv_scan.cu``): every Pallas
kernel of the JAX package has its Hopper counterpart. ``ops`` is the twin
of the JAX package's ``kernels/ops.py``. Nothing here imports Triton or
builds a kernel at import time: ``build.load`` runs at the first launch.
"""

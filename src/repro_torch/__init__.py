"""GRAFT in PyTorch for one NVIDIA H100 — the port of the JAX package ``repro``.

The layout mirrors ``repro`` one to one (``repro/x/y.py`` ↔
``repro_torch/x/y.py``). The port imports ``torch`` and never ``jax``, and
nothing of ``repro``: it keeps its own copies of what it needs.

Entry points (``repro_torch.api.Trainer``, ``python -m repro_torch.api``)
run on the CUDA device and refuse to start without one unless the caller
asks for the CPU (``device="cpu"`` / ``--device=cpu``). Every TPU kernel of
the JAX package on a ported path has a hand-written Hopper kernel here
(``repro_torch/csrc/``), with a plain PyTorch twin that the wrapper takes
only for tensors that lie on the CPU.

What is ported so far, and what is not, is listed in ``ROADMAP.md``.
"""

__all__ = ["api", "checkpoint", "configs", "core", "data", "kernels",
           "launch", "models", "optim", "registry", "selection"]

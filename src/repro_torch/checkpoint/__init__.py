"""Checkpoint interop. The port reads the JAX package's checkpoints
(``jax_bridge``); its own save/resume is still to port (``ROADMAP.md``)."""
from repro_torch.checkpoint.jax_bridge import (load_jax_checkpoint,
                                               params_from_numpy,
                                               params_to_numpy)

__all__ = ["load_jax_checkpoint", "params_from_numpy", "params_to_numpy"]

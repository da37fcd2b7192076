"""Atomic, resumable checkpointing in the JAX package's format
(``checkpoint``), and the map between the port's state and the JAX train
state's leaves (``jax_bridge``)."""
from repro_torch.checkpoint.checkpoint import (CheckpointManager, EmergencySaver,
                                               load_experiment)
from repro_torch.checkpoint.jax_bridge import (load_jax_checkpoint, load_train_state,
                                               params_from_numpy, params_to_numpy,
                                               train_state_spec, train_state_to_host)

__all__ = ["CheckpointManager", "EmergencySaver", "load_experiment",
           "load_jax_checkpoint", "params_from_numpy", "params_to_numpy",
           "load_train_state", "train_state_spec", "train_state_to_host"]

"""GRAFT math in plain PyTorch: MaxVol, prefix projection errors, features
and gradient embeddings; ``graft`` re-exports the selector's names from
``repro_torch.selection``."""

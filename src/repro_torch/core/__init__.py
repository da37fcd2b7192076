"""GRAFT math in plain PyTorch: MaxVol, prefix projection errors, features
and gradient embeddings."""

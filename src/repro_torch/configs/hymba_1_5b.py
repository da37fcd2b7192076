"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16; parallel attention+Mamba heads per layer,
sliding-window attention except 3 global layers (first/middle/last).
[arXiv:2411.13676; hf]"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid",
        num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
        head_dim=64, d_ff=5504, vocab_size=32001,
        mlp_activation="silu", ssm_state=16,
        sliding_window=1024, global_layer_indices=(0, 15, 31),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hymba-smoke", family="hybrid",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256,
        mlp_activation="silu", ssm_state=8,
        sliding_window=16, global_layer_indices=(0, 2), remat="none",
    )

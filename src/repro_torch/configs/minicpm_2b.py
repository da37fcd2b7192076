"""minicpm-2b [dense] — 40L d_model=2304 36H (GQA kv=36) d_ff=5760
vocab=122753; WSD schedule (optimizer-side), llama-like arch.
[arXiv:2404.06395; hf]"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b", family="dense",
        num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
        head_dim=2304 // 36, d_ff=5760, vocab_size=122753,
        rope_theta=10_000.0, mlp_activation="silu", tie_embeddings=True,
    )


# WSD (warmup-stable-decay) is the paired optimizer schedule
SCHEDULE = "wsd"


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b-smoke", family="dense",
        num_layers=2, d_model=72, num_heads=6, num_kv_heads=6,
        head_dim=12, d_ff=144, vocab_size=257,   # odd vocab on purpose
        mlp_activation="silu", tie_embeddings=True, remat="none",
    )

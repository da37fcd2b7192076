"""rwkv6-7b [ssm] — 32L d_model=4096 (attention-free) d_ff=14336 vocab=65536;
Finch — data-dependent decay. Heads = d_model/64. [arXiv:2404.05892; hf]"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b", family="ssm",
        num_layers=32, d_model=4096, num_heads=64, num_kv_heads=64,
        head_dim=64, d_ff=14336, vocab_size=65536,
        mlp_activation="relu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b-smoke", family="ssm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=256, remat="none",
    )

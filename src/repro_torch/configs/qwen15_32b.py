"""qwen1.5-32b [dense] — 64L d_model=5120 40H (GQA kv=40... kv=40 = MHA)
d_ff=27392 vocab=152064; QKV bias. [hf:Qwen/Qwen1.5-32B; hf]"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b", family="dense",
        num_layers=64, d_model=5120, num_heads=40, num_kv_heads=40,
        head_dim=5120 // 40, d_ff=27392, vocab_size=152064,
        rope_theta=1_000_000.0, qkv_bias=True, mlp_activation="silu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=256,
        qkv_bias=True, mlp_activation="silu", remat="none",
    )

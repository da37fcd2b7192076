"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) d_ff=1536
(expert ffn) vocab=151936; MoE 128 experts top-8. [hf:Qwen/Qwen3-235B-A22B; hf]"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe",
        num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
        head_dim=128, d_ff=1536, vocab_size=151936,
        rope_theta=1_000_000.0, mlp_activation="silu",
        num_experts=128, num_experts_per_tok=8,
        moe_capacity_factor=1.25, moe_group_size=512,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=96, vocab_size=256,
        mlp_activation="silu", num_experts=8, num_experts_per_tok=2,
        moe_capacity_factor=1.5, moe_group_size=64, remat="none",
    )

"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) d_ff=2048
(expert ffn) vocab=163840; MoE 384 experts top-8, first layer dense
(d_ff_dense=18432). Kimi K2 — trillion-param MoE (paper-table).
[arXiv:2501.kimi2; unverified]"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe",
        num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
        head_dim=112, d_ff=2048, vocab_size=163840,
        rope_theta=1_000_000.0, mlp_activation="silu",
        num_experts=384, num_experts_per_tok=8,
        moe_capacity_factor=1.25, moe_group_size=512,
        first_k_dense=1, d_ff_dense=18432,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-smoke", family="moe",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=96, vocab_size=256,
        mlp_activation="silu", num_experts=8, num_experts_per_tok=2,
        moe_capacity_factor=1.5, moe_group_size=64,
        first_k_dense=1, d_ff_dense=128, remat="none",
    )

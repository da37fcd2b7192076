"""gemma2-27b [dense] — 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000; local/global alternating attention (window 4096), attn logit
softcap 50, final logit softcap 30, post-block norms, GeGLU, q-scale
1/sqrt(query_pre_attn_scalar=144... d_model/num_heads=144); head_dim=128.
[arXiv:2408.00118; hf]"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b", family="dense",
        num_layers=46, d_model=4608, num_heads=32, num_kv_heads=16,
        head_dim=128, d_ff=36864, vocab_size=256_000,
        rope_theta=10_000.0, mlp_activation="gelu",
        sliding_window=4096, layer_pattern=("local", "global"),
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        post_block_norm=True, tie_embeddings=True,
        query_scale=(4608 / 32) ** -0.5,   # query_pre_attn_scalar = d_model/heads
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b-smoke", family="dense",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=256, vocab_size=512,
        mlp_activation="gelu", sliding_window=16,
        layer_pattern=("local", "global"),
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        post_block_norm=True, tie_embeddings=True,
        query_scale=16.0 ** -0.5, remat="none",
    )

"""internvl2-26b [vlm] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553; InternViT (STUB: input_specs() provides patch embeddings)
+ InternLM2-20B backbone. [arXiv:2404.16821; hf]"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b", family="vlm", frontend="vision_patches",
        num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
        head_dim=128, d_ff=16384, vocab_size=92553,
        rope_theta=1_000_000.0, mlp_activation="silu",
        num_patches=256,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke", family="vlm", frontend="vision_patches",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256,
        mlp_activation="silu", num_patches=8, remat="none",
    )

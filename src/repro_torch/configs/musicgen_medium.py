"""musicgen-medium [audio] — 48L d_model=1536 24H (MHA kv=24) d_ff=6144
vocab=2048; decoder-only over EnCodec tokens. Frontend (EnCodec) is a STUB:
input_specs() provides precomputed frame embeddings. [arXiv:2306.05284; hf]"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium", family="audio", frontend="audio_frames",
        num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
        head_dim=64, d_ff=6144, vocab_size=2048,
        mlp_activation="gelu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-smoke", family="audio", frontend="audio_frames",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=128,
        mlp_activation="gelu", remat="none",
    )

"""gemma-2b [dense] — GeGLU, head_dim=256, MQA, 256k vocab [arXiv:2403.08295]."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab=256000,
        family="dense",
        ffn="geglu",
        tie_embeddings=True,
        embed_scale=True,
        rope_theta=10000.0,
    )

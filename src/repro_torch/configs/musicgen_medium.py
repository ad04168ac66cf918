"""musicgen-medium [audio] — decoder-only over EnCodec tokens, 4 codebooks
[arXiv:2306.05284].

The EnCodec frontend is a STUB per the assignment: tokens are 4 parallel
codebook streams [B, T, 4]; embeddings are summed, 4 output heads. The
delay-pattern interleaving is a serving-side detail outside the backbone.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,  # MHA
        head_dim=64,
        d_ff=6144,
        vocab=2048,
        family="audio",
        ffn="mlp",
        n_codebooks=4,
        rope_theta=10000.0,
    )

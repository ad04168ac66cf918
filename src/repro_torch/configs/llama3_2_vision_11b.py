"""llama-3.2-vision-11b [vlm] — 32 self + 8 interleaved cross-attention
layers (40 total), GQA kv=8 [hf:meta-llama/Llama-3.2-11B-Vision].

The vision frontend is a STUB per the assignment: input_specs() provides
precomputed patch embeddings [B, 1601, d_model]; only the transformer
backbone is modelled.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b",
        n_layers=32,          # self-attention layers
        n_cross_layers=8,     # +8 cross layers -> 40 total
        group_self=4,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab=128256,
        family="vlm",
        vision_seq=1601,
        rope_theta=500000.0,
    )

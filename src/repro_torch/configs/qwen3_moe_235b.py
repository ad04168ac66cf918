"""qwen3-moe-235b-a22b [moe] — 128 experts, top-8, GQA kv=4
[hf:Qwen/Qwen3 family]."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        head_dim=128,
        d_ff=0,  # every layer is MoE
        vocab=151936,
        family="moe",
        n_experts=128,
        top_k=8,
        d_ff_expert=1536,
        rope_theta=1000000.0,
    )

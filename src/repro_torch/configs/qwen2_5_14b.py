"""qwen2.5-14b [dense] — GQA kv=8, QKV bias [hf:Qwen/Qwen2.5 family]."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=13824,
        vocab=152064,
        family="dense",
        qkv_bias=True,
        rope_theta=1000000.0,
    )

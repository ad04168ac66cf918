"""deepseek-coder-33b [dense] — llama-arch, GQA kv=8 [arXiv:2401.14196]."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b",
        n_layers=62,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=19200,
        vocab=32256,
        family="dense",
        rope_theta=100000.0,
    )

"""falcon-mamba-7b [ssm] — 64L attention-free Mamba-1, ssm_state=16
[arXiv:2410.05355]."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b",
        n_layers=64,
        d_model=4096,
        n_heads=1,       # unused (attention-free)
        n_kv_heads=1,
        head_dim=1,
        d_ff=0,          # mamba blocks have no separate FFN
        vocab=65024,
        family="ssm",
        block="mamba",
        ssm_state=16,
        d_conv=4,
        expand=2,
        tie_embeddings=True,
        ssm_chunk=256,
    )

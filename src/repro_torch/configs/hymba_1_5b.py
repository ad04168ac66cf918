"""hymba-1.5b [hybrid] — parallel attention + mamba heads per block
[arXiv:2411.13676].

Hymba pairs sliding-window attention with global-context SSM heads; we
model that as SWA(1024) attention + full Mamba in every block, which is
what makes long_500k decoding O(window + state) per step.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab=32001,
        family="hybrid",
        block="hymba",
        ssm_state=16,
        d_conv=4,
        expand=2,
        sliding_window=1024,
        rope_theta=10000.0,
        ssm_chunk=256,
    )

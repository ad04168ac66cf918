"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, 64 routed experts top-6 +
2 shared, first layer dense [arXiv:2405.04434].

The assignment line also quotes the full-V2 expert count (160); we build
the Lite config it names: 27L, d_model 2048, 64 routed experts.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=192,  # qk_nope + qk_rope
        d_ff=10944,    # the leading dense layer
        vocab=102400,
        family="moe",
        attn_impl="mla",
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        n_experts=64,
        top_k=6,
        n_shared_experts=2,
        d_ff_expert=1408,
        first_dense=1,
        rope_theta=10000.0,
    )

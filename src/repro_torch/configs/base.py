"""Model / run configuration dataclasses + the assigned input-shape suite."""
from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    family: str = "dense"       # dense | moe | ssm | hybrid | vlm | audio
    block: str = "attn"         # attn | mamba | hymba
    ffn: str = "swiglu"         # swiglu | geglu
    attn_impl: str = "gqa"      # gqa | mla
    qkv_bias: bool = False
    rope_theta: float = 5e5
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    embed_scale: bool = False   # gemma multiplies embeddings by sqrt(d)
    sliding_window: int = 0     # 0 = full attention
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    first_dense: int = 0        # leading dense layers (DeepSeek)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    # MLA (DeepSeek)
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # SSM (Mamba-1)
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0
    ssm_chunk: int = 256
    # cross-attention (VLM): groups of (1 cross + group_self self) layers
    n_cross_layers: int = 0
    group_self: int = 0
    vision_seq: int = 0
    # audio
    n_codebooks: int = 0
    # analysis (see models/scan_utils.py)
    unroll_scans: bool = False
    loss_chunk: int = 512   # fused-CE block; bigger = fewer head re-gathers
    # serving
    kv_quant: bool = False  # int8 KV cache (decode memory floor /2)
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or max(1, self.d_model // 16)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


# The assigned input-shape suite (identical for all 10 archs).
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# long_500k requires sub-quadratic global context: only SSM/hybrid run it
# (the 8 pure-full-attention skips are recorded in DESIGN.md §4).
LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")


def shapes_for(cfg: ModelConfig) -> list[str]:
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.family in LONG_CONTEXT_FAMILIES:
        names.append("long_500k")
    return names


@dataclass(frozen=True)
class RunConfig:
    """Training-run / serving-run level knobs."""
    model: ModelConfig
    shape: ShapeConfig
    learning_rate: float = 3e-4
    lr_warmup: int = 100
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    remat: str = "full"         # none | dots | full
    microbatches: int = 1       # gradient accumulation
    zero1: bool = True          # shard optimizer state over the data axis
    grad_compression: str = "none"  # none | int8ef
    profile: str = "default"        # sharding profile (dist/sharding.py)
    context_parallel: bool = False


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=16,
        d_ff=128,
        vocab=512,
        sliding_window=min(cfg.sliding_window, 32) if cfg.sliding_window else 0,
    )
    if cfg.is_moe:
        kw.update(n_experts=4, top_k=2, d_ff_expert=64,
                  n_shared_experts=min(cfg.n_shared_experts, 1),
                  first_dense=min(cfg.first_dense, 1))
    if cfg.attn_impl == "mla":
        kw.update(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
    if cfg.block in ("mamba", "hymba"):
        kw.update(ssm_state=8, dt_rank=8, ssm_chunk=16)
    if cfg.n_cross_layers:
        kw.update(n_cross_layers=2, group_self=1, n_layers=2, vision_seq=16)
    if cfg.n_codebooks:
        kw.update(n_codebooks=cfg.n_codebooks)
    return replace(cfg, **kw)

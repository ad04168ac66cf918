"""Decoder blocks: the dense-attention block in the full, prefill and
decode modes.

The counterpart of ``repro.models.blocks``. Every family's parameters are
declared here (so that ``models.model.model_spec`` and ``count_params``
cover all ten architectures), but only ``block="attn"`` with
``attn_impl="gqa"`` and a dense FFN is applied, in every mode (the full
forward, which trains, prefill and decode); the MoE, MLA, Mamba, Hymba,
VLM and audio branches raise NotImplementedError until they are ported
(ROADMAP §1 items 9.2-9.6).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.params import ParamSpec

# {item}: the ROADMAP §1 sub-item that ports the family
NOT_PORTED = "is not ported yet (ROADMAP §1 item {item})"


class BlockCache(NamedTuple):
    """Uniform per-layer cache; unused fields are () placeholders."""

    kv: Any = ()      # attention.KVCache | QuantKVCache
    ssm: Any = ()     # the Mamba state, once ported


# ---------------------------------------------------------------------------
# parameter declarations of the families that are not applied yet (the
# reference's mamba.mamba_spec, mla.mla_spec and moe.moe_spec)
# ---------------------------------------------------------------------------
def mamba_spec(cfg):
    d, di, n, r = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank_
    return {
        "in_proj": ParamSpec((d, 2 * di), ("fsdp", "model")),
        "conv_w": ParamSpec((cfg.d_conv, di), (None, "model"), scale=0.2),
        "conv_b": ParamSpec((di,), ("model",), init="zeros"),
        "x_proj": ParamSpec((di, r + 2 * n), ("model", None)),
        "dt_proj": ParamSpec((r, di), (None, "model"), scale=0.1),
        "dt_bias": ParamSpec((di,), ("model",), init="zeros"),
        "a_log": ParamSpec((di, n), ("model", None), init="ones"),
        "d_skip": ParamSpec((di,), ("model",), init="ones"),
        "out_proj": ParamSpec((di, d), ("model", "fsdp")),
    }


def mla_spec(cfg):
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {
        "wq": ParamSpec((cfg.d_model, cfg.n_heads, qk), ("fsdp", "model", None)),
        "wdkv": ParamSpec((cfg.d_model, cfg.kv_lora_rank), ("fsdp", None)),
        "wkr": ParamSpec((cfg.d_model, cfg.qk_rope_dim), ("fsdp", None)),
        "kv_norm": ParamSpec((cfg.kv_lora_rank,), (None,), init="ones"),
        "wuk": ParamSpec((cfg.kv_lora_rank, cfg.n_heads, cfg.qk_nope_dim),
                         (None, "model", None)),
        "wuv": ParamSpec((cfg.kv_lora_rank, cfg.n_heads, cfg.v_head_dim),
                         (None, "model", None)),
        "wo": ParamSpec((cfg.n_heads, cfg.v_head_dim, cfg.d_model),
                        ("model", None, "fsdp")),
    }


def moe_spec(cfg):
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    s = {
        "router": ParamSpec((d, e), (None, None), scale=0.02),
        "wi": ParamSpec((e, d, f), ("experts", "fsdp", None)),
        "wg": ParamSpec((e, d, f), ("experts", "fsdp", None)),
        "wo": ParamSpec((e, f, d), ("experts", None, "fsdp")),
    }
    if cfg.n_shared_experts:
        fs = cfg.d_ff_expert * cfg.n_shared_experts
        s["shared"] = {
            "wi": ParamSpec((d, fs), ("fsdp", "model")),
            "wg": ParamSpec((d, fs), ("fsdp", "model")),
            "wo": ParamSpec((fs, d), ("model", "fsdp")),
        }
    return s


# ---------------------------------------------------------------------------
# spec
# ---------------------------------------------------------------------------
def block_spec(cfg, *, moe_layer: bool | None = None):
    if moe_layer is None:
        moe_layer = cfg.is_moe
    s = {"norm1": layers.rmsnorm_spec(cfg.d_model)}
    if cfg.block == "mamba":
        s["mamba"] = mamba_spec(cfg)
        return s  # mamba blocks in Falcon-Mamba have no separate FFN
    if cfg.block == "hymba":
        s["attn"] = attn.attn_spec(cfg)
        s["mamba"] = mamba_spec(cfg)
        s["norm_a"] = layers.rmsnorm_spec(cfg.d_model)
        s["norm_m"] = layers.rmsnorm_spec(cfg.d_model)
    elif cfg.attn_impl == "mla":
        s["attn"] = mla_spec(cfg)
    else:
        s["attn"] = attn.attn_spec(cfg)
    s["norm2"] = layers.rmsnorm_spec(cfg.d_model)
    s["ffn"] = (moe_spec(cfg) if moe_layer
                else layers.ffn_spec(cfg.d_model, cfg.d_ff, cfg.ffn))
    s["_moe"] = moe_layer  # static marker, stripped before init
    return s


def cross_block_spec(cfg):
    return {
        "norm1": layers.rmsnorm_spec(cfg.d_model),
        "attn": attn.cross_attn_spec(cfg),
        "norm2": layers.rmsnorm_spec(cfg.d_model),
        "ffn": layers.ffn_spec(cfg.d_model, cfg.d_ff, cfg.ffn),
    }


def strip_markers(tree):
    """Remove static `_moe` markers so the tree is a pure param tree."""
    if isinstance(tree, dict):
        return {k: strip_markers(v) for k, v in tree.items() if k != "_moe"}
    return tree


def check_ported(cfg) -> None:
    """Raise NotImplementedError for a family whose apply is not ported."""
    what = item = None
    if cfg.block != "attn":
        what, item = f"the {cfg.block!r} block", "9.4"
    elif cfg.attn_impl != "gqa":
        what, item = f"attn_impl={cfg.attn_impl!r}", "9.3"
    elif cfg.is_moe:
        what, item = "the MoE FFN", "9.2"
    elif cfg.n_cross_layers:
        what, item = "cross-attention (the VLM family)", "9.5"
    elif cfg.n_codebooks:
        what, item = "the audio embedding and heads", "9.6"
    if what is not None:
        raise NotImplementedError(
            f"{cfg.name}: {what} {NOT_PORTED.format(item=item)}")


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------
def _mixer_full(p, h, cfg, mode, cache, positions, pos, dt):
    """Token mixer (dense attention) in any mode."""
    check_ported(cfg)
    if mode == "decode":
        return attn.decode_attention(p["attn"], h, cfg, cache.kv, pos=pos,
                                     dt=dt)
    if mode == "prefill":
        return attn.prefill_attention(p["attn"], h, cfg, positions=positions,
                                      cache_len=_cache_len(cfg, h.shape[1]),
                                      dt=dt)
    return attn.self_attention(p["attn"], h, cfg, positions=positions,
                               chunk_q=_chunk_q(h.shape[1]), dt=dt), ()


def _cache_len(cfg, seq: int) -> int:
    return min(seq, cfg.sliding_window) if cfg.sliding_window else seq


def _chunk_q(seq: int) -> int:
    """Query-block size: keeps the fp32 score matrix O(chunk x seq)."""
    if seq >= 8192 and seq % 1024 == 0:
        return 1024
    if seq >= 4096 and seq % 512 == 0:
        return 512
    return 0


def block(p, h, cfg, *, mode="full", cache=BlockCache(), positions=None,
          pos=None, moe_layer=None, dt=torch.bfloat16):
    """One decoder block. Returns (h, new_cache, aux_loss)."""
    if moe_layer is None:
        moe_layer = cfg.is_moe and cfg.block == "attn"
    if moe_layer:
        raise NotImplementedError(
            f"{cfg.name}: the MoE FFN {NOT_PORTED.format(item='9.2')}")
    aux = torch.zeros((), dtype=torch.float32, device=h.device)

    hn = layers.rmsnorm(p["norm1"], h, cfg.rms_eps)
    y, kv = _mixer_full(p, hn, cfg, mode, cache, positions, pos, dt)
    h = h + y
    if mode == "full":  # training: never materialise stacked caches
        kv = ()
    new_cache = BlockCache(kv=kv, ssm=())

    hn = layers.rmsnorm(p["norm2"], h, cfg.rms_eps)
    h = h + layers.ffn(p["ffn"], hn, cfg.ffn, compute_dtype=dt)
    return h, new_cache, aux

"""Decoder blocks: attention (dense GQA or MLA) with a dense or MoE FFN,
Mamba (no FFN), Hymba (attention and Mamba heads in parallel, then the
FFN) and the VLM's cross-attention block, in the full, prefill and decode
modes.

The counterpart of ``repro.models.blocks``. Every family's parameters are
declared here (so that ``models.model.model_spec`` and ``count_params``
cover all ten architectures), and every family is applied in every mode:
the full forward, which trains, prefill and decode. The audio family's
blocks are the dense attention ones; its codebooks live only in the
embedding and the heads (``models.model``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import layers, mamba, mla, moe


class BlockCache(NamedTuple):
    """Uniform per-layer cache; unused fields are () placeholders."""

    kv: Any = ()      # attention.KVCache | QuantKVCache | mla.MLACache
    ssm: Any = ()     # mamba.MambaCache


# ---------------------------------------------------------------------------
# spec
# ---------------------------------------------------------------------------
def block_spec(cfg, *, moe_layer: bool | None = None):
    if moe_layer is None:
        moe_layer = cfg.is_moe
    s = {"norm1": layers.rmsnorm_spec(cfg.d_model)}
    if cfg.block == "mamba":
        s["mamba"] = mamba.mamba_spec(cfg)
        return s  # mamba blocks in Falcon-Mamba have no separate FFN
    if cfg.block == "hymba":
        s["attn"] = attn.attn_spec(cfg)
        s["mamba"] = mamba.mamba_spec(cfg)
        s["norm_a"] = layers.rmsnorm_spec(cfg.d_model)
        s["norm_m"] = layers.rmsnorm_spec(cfg.d_model)
    elif cfg.attn_impl == "mla":
        s["attn"] = mla.mla_spec(cfg)
    else:
        s["attn"] = attn.attn_spec(cfg)
    s["norm2"] = layers.rmsnorm_spec(cfg.d_model)
    s["ffn"] = (moe.moe_spec(cfg) if moe_layer
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


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------
def _mixer_full(p, h, cfg, mode, cache, positions, pos, dt):
    """Token mixer (attention, MLA, Mamba or Hymba) in any mode -> (y,
    the mixer's cache: Hymba's a pair (kv, ssm))."""
    if cfg.block == "mamba":
        if mode == "decode":
            return mamba.mamba_decode(p["mamba"], h, cfg, cache.ssm, dt=dt)
        return mamba.mamba_block(p["mamba"], h, cfg, dt=dt)

    if cfg.block == "hymba":
        if mode == "decode":
            ya, kvc = attn.decode_attention(p["attn"], h, cfg, cache.kv,
                                            pos=pos, dt=dt)
            ym, ssc = mamba.mamba_decode(p["mamba"], h, cfg, cache.ssm,
                                         dt=dt)
        else:
            if mode == "prefill":
                ya, kvc = attn.prefill_attention(
                    p["attn"], h, cfg, positions=positions,
                    cache_len=_cache_len(cfg, h.shape[1]), dt=dt)
            else:
                ya = attn.self_attention(p["attn"], h, cfg,
                                         positions=positions,
                                         chunk_q=_chunk_q(h.shape[1]), dt=dt)
                kvc = ()
            ym, ssc = mamba.mamba_block(p["mamba"], h, cfg, dt=dt)
        ya = layers.rmsnorm(p["norm_a"], ya, cfg.rms_eps)
        ym = layers.rmsnorm(p["norm_m"], ym, cfg.rms_eps)
        return 0.5 * (ya + ym), (kvc, ssc)

    if cfg.attn_impl == "mla":
        if mode == "decode":
            return mla.mla_decode(p["attn"], h, cfg, cache.kv, pos=pos, dt=dt)
        if mode == "prefill":
            return mla.mla_attention(p["attn"], h, cfg, positions=positions,
                                     dt=dt, return_cache=True)
        return mla.mla_attention(p["attn"], h, cfg, positions=positions,
                                 dt=dt), ()
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
    aux = torch.zeros((), dtype=torch.float32, device=h.device)

    hn = layers.rmsnorm(p["norm1"], h, cfg.rms_eps)
    y, mixer_cache = _mixer_full(p, hn, cfg, mode, cache, positions, pos, dt)
    h = h + y
    if mode == "full":  # training: never materialise stacked caches
        new_cache = BlockCache()
    elif cfg.block == "mamba":
        new_cache = BlockCache(ssm=mixer_cache)
    elif cfg.block == "hymba":
        new_cache = BlockCache(*mixer_cache)
    else:
        new_cache = BlockCache(kv=mixer_cache)
    if cfg.block == "mamba":  # mamba blocks have no FFN
        return h, new_cache, aux

    hn = layers.rmsnorm(p["norm2"], h, cfg.rms_eps)
    if moe_layer:
        y, aux = moe.moe_ffn(p["ffn"], hn, cfg, dt=dt)
    else:
        y = layers.ffn(p["ffn"], hn, cfg.ffn, compute_dtype=dt)
    h = h + y
    return h, new_cache, aux


def cross_block(p, h, enc, cfg, dt=torch.bfloat16):
    """Cross-attention block (VLM): attends to vision embeddings."""
    hn = layers.rmsnorm(p["norm1"], h, cfg.rms_eps)
    h = h + attn.cross_attention(p["attn"], hn, enc, cfg, dt=dt)
    hn = layers.rmsnorm(p["norm2"], h, cfg.rms_eps)
    return h + layers.ffn(p["ffn"], hn, cfg.ffn, compute_dtype=dt)

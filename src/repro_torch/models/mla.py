"""Multi-head Latent Attention (DeepSeek-V2): train, prefill, decode.

The counterpart of ``repro.models.mla``. The decode path uses the
*absorbed* formulation: W_uk is folded into the query and W_uv applied
after the latent contraction, so the cache holds only the compressed
latent c_kv [B,S,kv_lora] and the shared rope key [B,S,rope_dim].

Rounding follows the reference: products in the compute dtype, the two
score products (no-rope and rope parts) added in it, then fp32 for the
scale, the additive causal bias (0 or -1e30) and the softmax, whose
weights go back to the compute dtype. The weight products (``wq``,
``wdkv``, ``wkr``, ``wuk``, ``wuv``, ``wo``) are matrix products of the
flattened heads (``aten.mm``), the score and value products batched ones
(``aten.bmm``), for the "dots" remat policy (``models.model``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers
from repro_torch.models.attention import (NEG, _bias, _heads_in, _heads_out,
                                          _write_slot)
from repro_torch.models.params import ParamSpec

NEG_INF = NEG


def mla_spec(cfg):
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {
        "wq": ParamSpec((cfg.d_model, cfg.n_heads, qk),
                        ("fsdp", "model", None)),
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


class MLACache(NamedTuple):
    c_kv: torch.Tensor    # [B, S, kv_lora]
    k_rope: torch.Tensor  # [B, S, rope_dim]


def _latents(p, x, cfg, positions, dt):
    """x [B,T,d] -> the normed latent c_kv [B,T,kv_lora] and the shared
    rope key [B,T,rope]."""
    c_kv = x @ p["wdkv"].to(dt)
    c_kv = layers.rmsnorm({"scale": p["kv_norm"]}, c_kv, cfg.rms_eps)
    k_r = (x @ p["wkr"].to(dt))[:, :, None, :]   # [B,T,1,rope]
    k_r = layers.apply_rope(k_r, positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_r


def _queries(p, x, cfg, positions, dt):
    """x [B,T,d] -> the no-rope and rope parts of the queries [B,T,H,.]."""
    q = _heads_in(x, p["wq"], dt)
    q_n = q[..., : cfg.qk_nope_dim]
    q_r = layers.apply_rope(q[..., cfg.qk_nope_dim:], positions,
                            cfg.rope_theta)
    return q_n, q_r


def _causal_bias(tq: int, s: int, offset: int, device=None) -> torch.Tensor:
    """f32 [tq, s]: 0 where key <= query position (offset + row), else
    -1e30."""
    qpos = offset + torch.arange(tq, device=device)[:, None]
    kpos = torch.arange(s, device=device)[None, :]
    return _bias(kpos <= qpos)


def mla_attention(p, x, cfg, *, positions, dt=torch.bfloat16,
                  return_cache=False, cache_len: int = 0):
    """Full-sequence causal MLA (train / prefill). Queries go in blocks of
    512 when T >= 4096 and 512 divides T (MLA's own rule); while autograd
    records, each block is checkpointed, so its scores are recomputed in
    the backward pass instead of kept for every block. With
    ``return_cache`` also returns MLACache of the last ``cache_len`` (all
    T by default) positions."""
    b, t, _ = x.shape
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    c_kv, k_r = _latents(p, x, cfg, positions, dt)
    q_n, q_r = _queries(p, x, cfg, positions, dt)
    k_n = _heads_in(c_kv, p["wuk"], dt)
    v = _heads_in(c_kv, p["wuv"], dt)

    def attend(qn_b, qr_b, k_n, k_r, v, offset):
        scores = torch.einsum("btnh,bsnh->bnts", qn_b, k_n)
        scores = scores + torch.einsum("btnh,bsh->bnts", qr_b, k_r)
        scores = scores.float() * scale
        scores = scores + _causal_bias(qn_b.shape[1], t, offset,
                                       x.device)[None, None]
        w = torch.softmax(scores, dim=-1).to(dt)
        return torch.einsum("bnts,bsnh->btnh", w, v)

    chunk = 512 if (t >= 4096 and t % 512 == 0) else 0
    if chunk and t > chunk:
        recording = torch.is_grad_enabled() and any(
            z.requires_grad for z in (q_n, q_r, k_n, k_r, v))
        outs = []
        for i in range(0, t, chunk):
            args = (q_n[:, i:i + chunk], q_r[:, i:i + chunk], k_n, k_r, v, i)
            outs.append(checkpoint(attend, *args, use_reentrant=False)
                        if recording else attend(*args))
        out = torch.cat(outs, dim=1)
    else:
        out = attend(q_n, q_r, k_n, k_r, v, 0)
    y = _heads_out(out, p["wo"], dt)
    if return_cache:
        cl = cache_len or t
        return y, MLACache(c_kv=c_kv[:, -cl:], k_rope=k_r[:, -cl:])
    return y


def mla_decode(p, x, cfg, cache: MLACache, *, pos, dt=torch.bfloat16):
    """Absorbed single-token decode: the contractions stay in the latent
    space. x [B,1,d]; pos (int or 0-d tensor) the new token's position,
    written at slot pos % S; every slot at or before pos is attended (past
    S, the whole ring). Returns (y, new cache); the cache passed in is
    left as it was."""
    s = cache.c_kv.shape[1]
    pos = int(pos)
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)

    c_new, kr_new = _latents(p, x, cfg, posv, dt)
    c_kv = _write_slot(cache.c_kv, c_new, pos % s)
    k_r = _write_slot(cache.k_rope, kr_new, pos % s)

    q_n, q_r = _queries(p, x, cfg, posv, dt)
    # absorb W_uk into the query: q_lat [B,1,H,kv_lora]
    q_lat = torch.einsum("btnh,lnh->btnl", q_n, p["wuk"].to(dt))
    scores = torch.einsum("btnl,bsl->bnts", q_lat, c_kv)
    scores = scores + torch.einsum("btnh,bsh->bnts", q_r, k_r)
    scores = scores.float() * scale
    ok = torch.arange(s, device=x.device) <= pos
    scores = scores + _bias(ok)[None, None, None]
    w = torch.softmax(scores, dim=-1).to(dt)
    # absorbed output: contract the weights against the latent, then W_uv
    out_lat = torch.einsum("bnts,bsl->btnl", w, c_kv)
    out = torch.einsum("btnl,lnh->btnh", out_lat, p["wuv"].to(dt))
    y = _heads_out(out, p["wo"], dt)
    return y, MLACache(c_kv=c_kv, k_rope=k_r)

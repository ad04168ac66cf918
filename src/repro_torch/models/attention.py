"""Attention: GQA/MQA/MHA self-attention (full, prefill, decode), sliding
windows, ring-buffer and int8 KV caches.

The counterpart of ``repro.models.attention``, in plain tensor operations
in the reference's order: the score product in the compute dtype, then
fp32 for the scale, the additive mask and the softmax, whose weights go
back to the compute dtype for the second product. Masks are additive
fp32 biases (0 or -1e30). Query head h reads KV head h // n_rep. The
weight products are matrix products of the flattened heads (``aten.mm``),
the score and value products batched ones (``aten.bmm``): the "dots"
remat policy saves the first kind only (``models.model``).

K9 (``kernels/flash_attention.py``) is not called here, in serving or in
training: the reference's model does not call its flash kernel either,
and that kernel has no backward. ``cross_attention`` (the VLM's) attends
to encoder states with no mask and no rotary embedding.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers
from repro_torch.models.params import ParamSpec

NEG = -1e30


def attn_spec(cfg):
    hd = cfg.head_dim
    s = {
        "wq": ParamSpec((cfg.d_model, cfg.n_heads, hd), ("fsdp", "model", None)),
        "wk": ParamSpec((cfg.d_model, cfg.n_kv_heads, hd), ("fsdp", "model", None)),
        "wv": ParamSpec((cfg.d_model, cfg.n_kv_heads, hd), ("fsdp", "model", None)),
        "wo": ParamSpec((cfg.n_heads, hd, cfg.d_model), ("model", None, "fsdp")),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((cfg.n_heads, hd), ("model", None), init="zeros")
        s["bk"] = ParamSpec((cfg.n_kv_heads, hd), ("model", None), init="zeros")
        s["bv"] = ParamSpec((cfg.n_kv_heads, hd), ("model", None), init="zeros")
    return s


def cross_attn_spec(cfg):
    return attn_spec(cfg)


class KVCache(NamedTuple):
    """k/v: [B, S_cache, n_kv, head_dim]; ring buffer iff S_cache < seq."""

    k: torch.Tensor
    v: torch.Tensor


class QuantKVCache(NamedTuple):
    """int8 KV cache with per-(token, head) scales.

    k/v: int8[B, S, KV, hd]; k_scale/v_scale: f32[B, S, KV, 1]."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor


def quantise_kv(x: torch.Tensor):
    """[..., hd] -> (int8 [..., hd], f32 scale [..., 1]), symmetric per
    vector, rounding half to even."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantise_kv(q: torch.Tensor, scale: torch.Tensor, dt) -> torch.Tensor:
    return (q.float() * scale).to(dt)


def _promoted(*xs):
    """xs cast to their common dtype, as jnp's einsum promotes mixed
    operands (a bf16 vision embedding or cache under fp32 compute)."""
    ct = xs[0].dtype
    for x in xs[1:]:
        ct = torch.promote_types(ct, x.dtype)
    return tuple(x.to(ct) for x in xs)


def _heads_in(x, w, dt):
    """The reference's einsum "btd,dnh->btnh" as one matrix product (x
    and the weight cast to dt promoted to their common dtype)."""
    d, n, hd = w.shape
    x, w = _promoted(x, w.to(dt).reshape(d, n * hd))
    return (x @ w).reshape(*x.shape[:-1], n, hd)


def _heads_out(y, w, dt):
    """The reference's einsum "btnh,nhd->btd" as one matrix product."""
    n, hd, d = w.shape
    return y.reshape(*y.shape[:-2], n * hd) @ w.to(dt).reshape(n * hd, d)


def _qkv(p, x, cfg, dt):
    q = _heads_in(x, p["wq"], dt)
    k = _heads_in(x, p["wk"], dt)
    v = _heads_in(x, p["wv"], dt)
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return q, k, v


def _sdpa(q, k, v, bias, n_rep: int):
    """q [B,Tq,H,hd]; k/v [B,S,KV,hd]; bias additive f32, broadcastable to
    [B,KV,rep,Tq,S] (or None)."""
    b, tq, h, hd = q.shape
    kv = k.shape[2]
    q = q.reshape(b, tq, kv, n_rep, hd)
    scores = torch.einsum("btkrh,bskh->bkrts", q, k).float()
    scores = scores * (hd ** -0.5)
    if bias is not None:
        scores = scores + bias
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkrts,bskh->btkrh", w, v)
    return out.reshape(b, tq, h, hd)


def _bias(ok: torch.Tensor) -> torch.Tensor:
    return torch.zeros(ok.shape, dtype=torch.float32,
                       device=ok.device).masked_fill_(~ok, NEG)


def _causal_bias(tq: int, s: int, offset: int, window: int, device=None):
    """f32[1,1,1,tq,s] additive causal(+window) bias."""
    qpos = offset + torch.arange(tq, device=device)[:, None]
    kpos = torch.arange(s, device=device)[None, :]
    ok = kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    return _bias(ok)[None, None, None]


def _attend_chunked(q, k, v, cfg, n_rep, chunk_q):
    """Causal attention in query blocks of chunk_q rows (when chunk_q
    divides T and is smaller), so the fp32 scores stay O(chunk x T).

    While autograd records, each block is checkpointed, as the reference's
    ``body_inner`` is: its scores are recomputed in the backward pass
    instead of being kept for every block, which would cost the whole
    T x T score matrix that chunking avoids. The values are the same."""
    t = q.shape[1]
    if chunk_q and t % chunk_q == 0 and t > chunk_q:
        def block(qb, k, v, i):
            bias = _causal_bias(chunk_q, t, i, cfg.sliding_window, q.device)
            return _sdpa(qb, k, v, bias, n_rep)

        recording = torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k, v))
        outs = []
        for i in range(0, t, chunk_q):
            qb = q[:, i:i + chunk_q]
            outs.append(checkpoint(block, qb, k, v, i, use_reentrant=False)
                        if recording else block(qb, k, v, i))
        return torch.cat(outs, dim=1)
    bias = _causal_bias(t, t, 0, cfg.sliding_window, q.device)
    return _sdpa(q, k, v, bias, n_rep)


def _rope_qk(q, k, positions, cfg):
    return (layers.apply_rope(q, positions, cfg.rope_theta),
            layers.apply_rope(k, positions, cfg.rope_theta))


def self_attention(p, x, cfg, *, positions, chunk_q: int = 0,
                   dt=torch.bfloat16):
    """Full-sequence causal attention (train)."""
    n_rep = cfg.n_heads // cfg.n_kv_heads
    q, k, v = _qkv(p, x, cfg, dt)
    q, k = _rope_qk(q, k, positions, cfg)
    out = _attend_chunked(q, k, v, cfg, n_rep, chunk_q)
    return _heads_out(out, p["wo"], dt)


def prefill_attention(p, x, cfg, *, positions, cache_len: int,
                      dt=torch.bfloat16):
    """Causal attention that also returns the KV cache (ring-truncated)."""
    t = x.shape[1]
    n_rep = cfg.n_heads // cfg.n_kv_heads
    q, k, v = _qkv(p, x, cfg, dt)
    q, k = _rope_qk(q, k, positions, cfg)
    chunk = 1024 if (t > 4096 and t % 1024 == 0) else 0
    out = _attend_chunked(q, k, v, cfg, n_rep, chunk)
    y = _heads_out(out, p["wo"], dt)
    if cache_len < t:  # ring buffer keeps the last cache_len positions
        k, v = k[:, -cache_len:], v[:, -cache_len:]
    if getattr(cfg, "kv_quant", False):
        kq, ks = quantise_kv(k)
        vq, vs = quantise_kv(v)
        return y, QuantKVCache(k=kq, v=vq, k_scale=ks, v_scale=vs)
    return y, KVCache(k=k, v=v)


def _write_slot(buf: torch.Tensor, x: torch.Tensor, slot: int) -> torch.Tensor:
    """A copy of buf with x written at position ``slot`` of dim 1 (the
    reference's dynamic_update_slice). Like it, refuses to convert: a
    cache of another dtype than the new rows raises TypeError."""
    if buf.dtype != x.dtype:
        raise TypeError(f"cache update requires the same dtypes, got"
                        f" {buf.dtype} cache and {x.dtype} rows (pass"
                        " init_caches(..., dt=<compute dtype>))")
    out = buf.clone()
    out[:, slot:slot + x.shape[1]] = x
    return out


def decode_attention(p, x, cfg, cache, *, pos, dt=torch.bfloat16):
    """Single-token decode against a (possibly ring, possibly int8) cache.

    x [B,1,d]; pos (int or 0-d tensor) the global position of the new
    token, the same for every row. Returns (y, new cache); the cache
    passed in is left as it was.
    """
    s_cache = cache.k.shape[1]
    n_rep = cfg.n_heads // cfg.n_kv_heads
    pos = int(pos)
    q, k, v = _qkv(p, x, cfg, dt)
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k = _rope_qk(q, k, posv, cfg)

    slot = pos % s_cache
    quant = isinstance(cache, QuantKVCache)
    if quant:
        kq, ks = quantise_kv(k)
        vq, vs = quantise_kv(v)
        cache = QuantKVCache(k=_write_slot(cache.k, kq, slot),
                             v=_write_slot(cache.v, vq, slot),
                             k_scale=_write_slot(cache.k_scale, ks, slot),
                             v_scale=_write_slot(cache.v_scale, vs, slot))
        new_k = dequantise_kv(cache.k, cache.k_scale, dt)
        new_v = dequantise_kv(cache.v, cache.v_scale, dt)
    else:
        new_k = _write_slot(cache.k, k, slot)
        new_v = _write_slot(cache.v, v, slot)

    # valid cache slots: ring position maps slot -> global position
    idx = torch.arange(s_cache, device=x.device)
    kpos = torch.where(idx <= slot, pos - slot + idx,
                       pos - slot - s_cache + idx)
    ok = (kpos >= 0) & (kpos <= pos)
    if cfg.sliding_window:
        ok &= kpos > pos - cfg.sliding_window
    bias = _bias(ok)[None, None, None, None]

    out = _sdpa(q, new_k, new_v, bias, n_rep)
    y = _heads_out(out, p["wo"], dt)
    return y, (cache if quant else KVCache(k=new_k, v=new_v))


def cross_attention(p, x, enc, cfg, dt=torch.bfloat16):
    """x [B,T,d] attends to encoder states enc [B,S,d] (no mask, no
    rope)."""
    n_rep = cfg.n_heads // cfg.n_kv_heads
    q = _heads_in(x, p["wq"], dt)
    k = _heads_in(enc, p["wk"], dt)
    v = _heads_in(enc, p["wv"], dt)
    out = _sdpa(*_promoted(q, k, v), None, n_rep)
    return _heads_out(out, p["wo"], dt)

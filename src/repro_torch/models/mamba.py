"""Mamba-1 selective SSM block: the chunked associative-scan path of the
full sequence, and the O(1)-state decode step.

The counterpart of ``repro.models.mamba``, with its casts: the products
in the compute dtype; the step sizes, B, C, the decays exp(delta * A)
and the state in fp32; the scan's output cast back to the compute dtype
before the skip and the gate. The full-sequence recurrence h_t = a_t *
h_{t-1} + b_t runs an associative scan within chunks of ``ssm_chunk``
steps (``scan_utils.associative_scan``, the reference's odd/even
recursion, over every chunk at once) and carries the [B, d_inner, N]
state across the chunks in order. The scan reaches no kernel of the
port, as the reference's reaches no ``pallas_call``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import device as devmod
from repro_torch.models import layers
from repro_torch.models.params import ParamSpec
from repro_torch.models.scan_utils import associative_scan, scan


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


class MambaCache(NamedTuple):
    conv: torch.Tensor  # [B, d_conv-1, d_inner] trailing conv inputs
    ssm: torch.Tensor   # [B, d_inner, N] recurrent state (fp32)


def init_cache(cfg, batch: int, dtype=torch.bfloat16,
               device=devmod.DEFAULT_DEVICE) -> MambaCache:
    device = devmod.resolve(device)
    return MambaCache(
        conv=torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                        dtype=torch.float32, device=device))


def softplus(x):
    """jax.nn.softplus, logaddexp(x, 0): max(x, 0) + log1p(exp(-|x|)),
    op by op in x's dtype."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _ssm_inputs(p, xc, cfg, dt):
    """xc [B,T,di] (post-conv, post-silu) -> (delta, B_ssm, C_ssm) fp32."""
    n, r = cfg.ssm_state, cfg.dt_rank_
    proj = xc @ p["x_proj"].to(dt)
    dt_in, b_ssm, c_ssm = torch.split(proj, [r, n, n], dim=-1)
    delta = softplus(dt_in @ p["dt_proj"].to(dt)
                     + p["dt_bias"].to(dt)).float()
    return delta, b_ssm.float(), c_ssm.float()


def _causal_conv(p, x, cfg, dt, history=None):
    """Depthwise causal conv1d over x [B,T,di] with the d_conv-1 inputs
    before it (history [B, d_conv-1, di], zeros if None) -> (out, the
    last d_conv-1 inputs). The taps are summed in the reference's order;
    a history of another dtype than x is promoted with it, as
    jnp.concatenate does."""
    k = cfg.d_conv
    if history is None:
        history = x.new_zeros((x.shape[0], k - 1, x.shape[-1]))
    xp = torch.cat([history, x], dim=1)
    w = p["conv_w"].to(dt)
    t = x.shape[1]
    out = xp[:, 0:t] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + t] * w[i]
    return out + p["conv_b"].to(dt), xp[:, -(k - 1):]


def _combine(left, right):
    al, bl = left
    ar, br = right
    return al * ar, bl * ar + br


def _scan_chunks(a, bx, h0, chunk: int, unroll: bool = False):
    """h_t = a_t * h_{t-1} + bx_t over T, chunked.

    a, bx: [B, T, di, N] fp32; h0 [B, di, N]. Returns (h_all [B,T,di,N],
    h_T). Within a chunk the scan is associative (every chunk at once:
    each chunk's own prefix products and sums, which do not depend on the
    state), then the chunks are walked in order, each applying its
    prefixes to the state the one before left, as the reference's
    ``lax.scan`` step does."""
    b, t, di, n = a.shape
    nc = t // chunk
    ca, cb = associative_scan(
        _combine, (a.reshape(b, nc, chunk, di, n),
                   bx.reshape(b, nc, chunk, di, n)), dim=2)

    def step(h, inputs):
        ac, bc = inputs
        h_all = ac * h[:, None] + bc
        return h_all[:, -1], h_all

    h_last, h_chunks = scan(step, h0, (ca.transpose(0, 1),
                                       cb.transpose(0, 1)), unroll=unroll)
    return h_chunks.transpose(0, 1).reshape(b, t, di, n), h_last


def mamba_block(p, x, cfg, *, dt=torch.bfloat16,
                cache: MambaCache | None = None):
    """Full-sequence Mamba block, x [B,T,d]. Returns (y, new cache)."""
    b, t, _ = x.shape
    di, n = cfg.d_inner, cfg.ssm_state
    xz = x @ p["in_proj"].to(dt)
    x_in, z = torch.chunk(xz, 2, dim=-1)
    xc, conv_hist = _causal_conv(p, x_in, cfg, dt,
                                 cache.conv if cache is not None else None)
    xc = layers.silu(xc)

    delta, b_ssm, c_ssm = _ssm_inputs(p, xc, cfg, dt)
    a = -torch.exp(p["a_log"].float())                          # [di, N]
    abar = torch.exp(delta[..., None] * a)                      # [B,T,di,N]
    bx = (delta * xc.float())[..., None] * b_ssm[:, :, None, :]

    h0 = (cache.ssm if cache is not None
          else torch.zeros((b, di, n), dtype=torch.float32, device=x.device))
    chunk = min(cfg.ssm_chunk, t)
    if t % chunk:
        chunk = t
    h_all, h_last = _scan_chunks(abar, bx, h0, chunk,
                                 unroll=getattr(cfg, "unroll_scans", False))

    y = torch.einsum("btdn,btn->btd", h_all, c_ssm).to(dt)
    y = y + xc * p["d_skip"].to(dt)
    y = y * layers.silu(z)
    out = y @ p["out_proj"].to(dt)
    return out, MambaCache(conv=conv_hist, ssm=h_last)


def mamba_decode(p, x, cfg, cache: MambaCache, *, dt=torch.bfloat16):
    """Single-token step, x [B,1,d]: an O(d_inner x N) state update, no
    scan. Returns (y, new cache); the cache passed in is left as it was."""
    xz = x @ p["in_proj"].to(dt)
    x_in, z = torch.chunk(xz, 2, dim=-1)                        # [B,1,di]
    xc, conv_hist = _causal_conv(p, x_in, cfg, dt, cache.conv)
    xc = layers.silu(xc)

    delta, b_ssm, c_ssm = _ssm_inputs(p, xc, cfg, dt)
    a = -torch.exp(p["a_log"].float())
    abar = torch.exp(delta[:, 0, :, None] * a)                  # [B,di,N]
    bx = ((delta[:, 0] * xc[:, 0].float())[..., None]
          * b_ssm[:, 0, None, :])
    h = abar * cache.ssm + bx
    y = torch.einsum("bdn,bn->bd", h, c_ssm[:, 0])[:, None].to(dt)
    y = y + xc * p["d_skip"].to(dt)
    y = y * layers.silu(z)
    out = y @ p["out_proj"].to(dt)
    return out, MambaCache(conv=conv_hist, ssm=h)

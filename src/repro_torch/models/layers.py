"""Shared neural layers: RMSNorm, rotary embeddings, linear, gated FFNs.

The counterpart of ``repro.models.layers``: parameters are declared as
ParamSpec trees and applied as plain functions on nested dicts of
tensors. Weights are kept in ``param_dtype`` and cast to the compute dtype
at each use, as in the reference.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.params import ParamSpec


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def rmsnorm_spec(d: int):
    return {"scale": ParamSpec((d,), (None,), init="ones")}


def rmsnorm(p, x, eps: float):
    """Computed in fp32, cast back to x's dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * p["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x [..., T, n, head_dim]; positions broadcastable to [..., T]. The
    two halves of head_dim rotate together (not interleaved pairs)."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * freqs      # [..., T, hd/2]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Linear
# ---------------------------------------------------------------------------
def linear(p, x, compute_dtype=torch.bfloat16):
    y = x @ p["w"].to(compute_dtype)
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


# ---------------------------------------------------------------------------
# Gated FFN (SwiGLU / GeGLU) and the plain GELU MLP
# ---------------------------------------------------------------------------
def ffn_spec(d: int, d_ff: int, kind: str = "swiglu"):
    s = {
        "wi": ParamSpec((d, d_ff), ("fsdp", "model")),
        "wo": ParamSpec((d_ff, d), ("model", "fsdp")),
    }
    if kind != "mlp":
        s["wg"] = ParamSpec((d, d_ff), ("fsdp", "model"))
    return s


def _const(value: float, like: torch.Tensor) -> float:
    """value rounded to like's dtype, as a Python float: a weak-typed
    constant of the reference, with no tensor made on the device (a
    host-to-device copy would wait for the device)."""
    return float(torch.tensor(value, dtype=like.dtype))


def gelu(x):
    """jax.nn.gelu's default, the tanh approximation, op for op in x's
    dtype as the reference rounds it (``F.gelu(x, approximate="tanh")``
    rounds once, which differs in bf16)."""
    inner = _const(math.sqrt(2 / math.pi), x) * (
        x + _const(0.044715, x) * (x * (x * x)))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def silu(x):
    """x * sigmoid(x) with sigmoid as 1 / (1 + exp(-x)), rounded after
    each op in x's dtype as the reference's jax.nn.silu is."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def ffn(p, x, kind: str = "swiglu", compute_dtype=torch.bfloat16):
    dt = compute_dtype
    h = x @ p["wi"].to(dt)
    if kind == "mlp":  # plain 2-matrix GELU MLP (MusicGen / classic)
        return gelu(h) @ p["wo"].to(dt)
    g = x @ p["wg"].to(dt)
    act = silu(g) if kind == "swiglu" else gelu(g)
    return (act * h) @ p["wo"].to(dt)

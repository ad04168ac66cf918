"""AdamW with global-norm clipping, a cosine schedule and a configurable
moment dtype, computed in fp32 as the reference's ``repro.train.optimizer``.

``update`` writes the new parameters and moments into the tensors it is
given (under ``torch.no_grad``), the counterpart of the reference's
donated buffers (``jax.jit(..., donate_argnums=(0, 1))``): a full-width
model's state then fits once on the card, not twice.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.models import params as pm


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32, 0-d
    m: dict
    v: dict


def init(params, moments_dtype=torch.float32) -> AdamWState:
    """Zero moments shaped as params, on their device; step 0."""
    dev = pm.tree_leaves(params)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=moments_dtype,
                                  device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=pm.tree_map(zeros, params),
                      v=pm.tree_map(zeros, params))


def abstract_state(abstract_params, moments_dtype=torch.float32) -> AdamWState:
    """init()'s shapes and dtypes on the meta device, with no storage."""
    z = lambda p: torch.empty(p.shape, dtype=moments_dtype, device="meta")
    return AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"),
                      m=pm.tree_map(z, abstract_params),
                      v=pm.tree_map(z, abstract_params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, each summed in fp32."""
    leaves = [torch.sum(torch.square(x.float())) for x in pm.tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def cosine_lr(step, *, peak: float, warmup: int = 100, total: int = 10000,
              floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak``, then a cosine down to ``floor * peak`` at
    ``total``; fp32, on step's device (step an int or an int tensor)."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = peak * (step + 1) / warmup
    frac = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos).float()


@torch.no_grad()
def update(params, grads, state: AdamWState, *, lr, weight_decay=0.1,
           b1=0.9, b2=0.95, eps=1e-8, clip=1.0):
    """One clipped AdamW step. Returns (params, state, metrics) with
    metrics {"grad_norm", "clip_scale"}; params and the moments are
    written in place."""
    gnorm = global_norm(grads)
    scale = torch.clamp(clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    step32 = step.float()
    c1 = 1 - torch.pow(b1, step32)
    c2 = 1 - torch.pow(b2, step32)

    def upd(p, g, m, v):
        # the reference's expressions and rounding order, with in-place ops
        # where a temporary would be a whole leaf (an fp32 m, v or p is
        # its own .float(), so those lines update it directly)
        g32 = g.float() * scale
        m32 = m.float().mul_(b1).add_(g32 * (1 - b1))
        v32 = v.float().mul_(b2).add_((1 - b2) * g32 * g32)
        delta = m32.div(c1).div_(v32.div(c2).sqrt_().add_(eps))
        delta.add_(weight_decay * p.float()).mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_(p.float() - delta)
        if m32 is not m:
            m.copy_(m32)
        if v32 is not v:
            v.copy_(v32)

    pm.tree_map(upd, params, grads, state.m, state.v)
    return params, AdamWState(step=step, m=state.m, v=state.v), {
        "grad_norm": gnorm, "clip_scale": scale}

"""Mixture-of-Experts FFN: top-k routing and a capacity-bounded dispatch
into a static [E, C, d] buffer.

The counterpart of ``repro.models.moe``, in three steps that
``moe_ffn`` composes:

* :func:`routing`: fp32 router logits, softmax, top-k, the renormalised
  top-k probabilities and the Switch load-balancing loss;
* :func:`slots`: each (token, k) assignment's rank among its expert's
  assignments, by a cumsum in token-major order; ranks past the capacity
  are dropped (standard capacity-factor semantics, as the reference);
* :func:`experts` and :func:`combine`: the grouped expert products (a
  batched product over the expert dimension), the probability-weighted
  gather back to the tokens, and the shared experts.

Shapes are static (the capacity comes from the token count) and nothing
syncs with the host: no ``.item()``, no ``.nonzero()``, no boolean-mask
indexing; one-hots are comparisons with an arange (``F.one_hot`` reads
its indices' range on the host on the CPU). No two values are ever added
into one kept element by index, in the forward or the backward pass: a
token's k copies are an ``expand`` (its backward sums the k rows), the
scatter into the buffer writes each kept assignment to a row of its own
and every dropped one to the reference's dump row E x C, which the
experts never read; the way back writes each buffer row to the
assignment that filled it (an empty one to a dump row past T x k), so
racing writes meet only in discarded rows and both backwards are
gathers; and each token's k contributions are added in order, one add at a time, as the
reference's scatter-add rounds them on the CPU. The gradients are
therefore the same from run to run on the card.

Expert parallelism over a mesh is not ported: the reference's goes
through ``sharding.make_constrain``, which its ``dist/sharding.py`` does
not define (ROADMAP §3).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import layers
from repro_torch.models.params import ParamSpec


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


def _capacity(n_tokens: int, cfg) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(cfg.top_k, (c + 127) // 128 * 128)  # lane-aligned


class Routing(NamedTuple):
    probs: torch.Tensor   # f32 [T, E], the router's softmax
    top_p: torch.Tensor   # f32 [T, k], renormalised over the k chosen
    top_e: torch.Tensor   # int64 [T, k], the chosen experts, best first
    aux: torch.Tensor     # f32 [], the weighted load-balancing loss


class Slots(NamedTuple):
    pos: torch.Tensor     # int32 [T*k], rank among the expert's assignments
    keep: torch.Tensor    # bool [T*k], pos < capacity
    dest: torch.Tensor    # int64 [T*k], e * cap + pos, or E * cap if dropped


def routing(p, xf, cfg) -> Routing:
    """xf [T, d] -> the top-k routing of every token and the Switch
    auxiliary loss E * sum_e f_e P_e (f_e the share of assignments to e,
    P_e its mean probability), times ``router_aux_weight``. The router
    product runs in fp32 (the reference promotes xf to fp32 there)."""
    n, (e, k) = xf.shape[0], (cfg.n_experts, cfg.top_k)
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    counts = (top_e.reshape(-1, 1)
              == torch.arange(e, device=xf.device)).sum(0)
    f_e = counts.float() / (n * k)
    aux = e * torch.sum(f_e * probs.mean(0)) * cfg.router_aux_weight
    return Routing(probs=probs, top_p=top_p, top_e=top_e, aux=aux)


def slots(top_e, cap: int, n_experts: int) -> Slots:
    """The buffer row of each assignment: its rank ``pos`` among its
    expert's assignments in token-major order (token t's j-th choice is
    assignment t * k + j), kept while pos < cap; a dropped one's ``dest``
    is the reference's dump row, E * cap."""
    flat_e = top_e.reshape(-1).long()
    # the one-hot expert-major, [E, T*k], so that the cumsum runs along
    # the innermost dim (a scan along the outer dim of [T*k, E] took
    # 4.3 ms a call on the card at T*k = 24,576; the counts are the same)
    onehot = (torch.arange(n_experts, device=flat_e.device)[:, None]
              == flat_e[None, :]).int()
    rank = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    pos = rank.gather(0, flat_e[None, :])[0]
    keep = pos < cap
    dest = torch.where(keep, flat_e * cap + pos,
                       torch.full_like(flat_e, n_experts * cap))
    return Slots(pos=pos, keep=keep, dest=dest)


def dispatch(xf, s: Slots, cap: int, cfg, dt) -> torch.Tensor:
    """xf [T, d] -> the experts' inputs [E, cap, d] in dt: each kept
    assignment's token at its row, zeros elsewhere."""
    n, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    xk = xf.to(dt)[:, None, :].expand(n, k, d).reshape(n * k, d)
    buf = torch.zeros((e * cap + 1, d), dtype=dt, device=xf.device)
    buf = buf.index_put((s.dest,), xk)
    return buf[: e * cap].reshape(e, cap, d)


def experts(p, xe, dt) -> torch.Tensor:
    """The routed experts' SwiGLU on their buffers: [E, C, d] -> [E, C, d]
    by products batched over the expert dimension."""
    h = torch.bmm(xe, p["wi"].to(dt))
    g = torch.bmm(xe, p["wg"].to(dt))
    return torch.bmm(layers.silu(g) * h, p["wo"].to(dt))


def combine(ye, s: Slots, top_p, dt) -> torch.Tensor:
    """ye [E, C, d] -> y [T, d]: each assignment's expert output (zero if
    dropped) times its probability in dt, then a token's k products
    added in order, one add in dt at a time.

    The outputs go back as dispatch's inputs came: written by index, each
    buffer row to the assignment that filled it (an empty row to a dump
    row past the T x k), so the backward is a gather. A gather from the
    buffer by ``dest`` would give the same values, but its backward adds
    every dropped assignment's gradient into the one dump row, which the
    card's sorted index backward walks serially (14.6 ms a layer at
    T 4096 on an H100)."""
    e, cap, d = ye.shape
    n, k = top_p.shape
    arange = torch.arange(n * k, device=ye.device)
    owner = torch.full((e * cap + 1,), n * k, device=ye.device)
    owner = owner.index_put((s.dest,), arange)[: e * cap]
    gathered = ye.new_zeros((n * k + 1, d)).index_put(
        (owner,), ye.reshape(e * cap, d))[: n * k]
    weighted = (gathered * top_p.reshape(-1)[:, None].to(dt)).reshape(n, k, d)
    y = weighted[:, 0]
    for j in range(1, k):
        y = y + weighted[:, j]
    return y


def shared_experts(p, xf, dt) -> torch.Tensor:
    sh = p["shared"]
    xs = xf.to(dt)
    return (layers.silu(xs @ sh["wg"].to(dt)) * (xs @ sh["wi"].to(dt))
            ) @ sh["wo"].to(dt)


def moe_ffn(p, x, cfg, *, dt=torch.bfloat16):
    """x [B,T,d] -> (y [B,T,d], aux_loss scalar)."""
    b, t, d = x.shape
    xf = x.reshape(b * t, d)
    cap = _capacity(b * t, cfg)
    r = routing(p, xf, cfg)
    s = slots(r.top_e, cap, cfg.n_experts)
    ye = experts(p, dispatch(xf, s, cap, cfg, dt), dt)
    y = combine(ye, s, r.top_p, dt)
    if "shared" in p:
        y = y + shared_experts(p, xf, dt)
    return y.reshape(b, t, d), r.aux

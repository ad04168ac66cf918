"""Model assembly: embeddings, the stack of layers, the output head, the
losses, and the execution modes (full, prefill, decode).

The counterpart of ``repro.models.model``. Parameters are the reference's
tree: ``blocks`` holds every layer's leaves stacked on a leading [L]
axis (DeepSeek's leading dense layers a stack of their own,
``dense_blocks``, run first), and a Python loop over the layers takes the
place of the reference's scans. ``model_spec`` declares all ten
architectures; ``forward``, ``loss_fn``, ``init_caches`` and
``decode_step`` run the attention families (dense GQA, MoE, MLA) and
raise NotImplementedError for the rest (ROADMAP §1 items 9.4-9.6).
Training is ``forward(mode="full")`` under autograd, through
``loss_fn``: the full mode keeps no caches, can rematerialise each layer
(``remat_policy``) and, for the chunked loss, stops before the head
(``return_hidden``). Prefill and decode serve.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import device as devmod
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks, layers, mla
from repro_torch.models import params as pm
from repro_torch.models.params import ParamSpec


# ---------------------------------------------------------------------------
# spec
# ---------------------------------------------------------------------------
def model_spec(cfg):
    s: dict = {}
    if cfg.n_codebooks:
        s["embed"] = ParamSpec((cfg.n_codebooks, cfg.vocab, cfg.d_model),
                               (None, "model", "fsdp"), scale=0.02)
    else:
        s["embed"] = ParamSpec((cfg.vocab, cfg.d_model), ("model", "fsdp"),
                               scale=0.02)
    if cfg.n_cross_layers:
        s["self_blocks"] = pm.stack(blocks.strip_markers(
            blocks.block_spec(cfg, moe_layer=False)), cfg.n_layers)
        s["cross_blocks"] = pm.stack(blocks.cross_block_spec(cfg),
                                     cfg.n_cross_layers)
    elif cfg.first_dense:
        dense = blocks.strip_markers(blocks.block_spec(cfg, moe_layer=False))
        moe_b = blocks.strip_markers(blocks.block_spec(cfg, moe_layer=True))
        s["dense_blocks"] = pm.stack(dense, cfg.first_dense)
        s["blocks"] = pm.stack(moe_b, cfg.n_layers - cfg.first_dense)
    else:
        s["blocks"] = pm.stack(
            blocks.strip_markers(blocks.block_spec(cfg)), cfg.n_layers)
    s["final_norm"] = layers.rmsnorm_spec(cfg.d_model)
    if not cfg.tie_embeddings:
        if cfg.n_codebooks:
            s["head"] = ParamSpec((cfg.n_codebooks, cfg.d_model, cfg.vocab),
                                  (None, "fsdp", "model"), scale=0.02)
        else:
            s["head"] = ParamSpec((cfg.d_model, cfg.vocab), ("fsdp", "model"),
                                  scale=0.02)
    return s


def compute_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------
def embed_tokens(p, cfg, tokens, dt):
    """tokens [B,T] -> [B,T,d]. The rows are gathered, then cast: the same
    values as the reference's cast-then-gather (the cast is elementwise)
    without converting the whole table every step. ``F.embedding``, whose
    backward sums a token's rows in a fixed order on the CPU (an indexing
    gather's adds them atomically, in any order)."""
    h = F.embedding(tokens.long(), p["embed"]).to(dt)
    if cfg.embed_scale:   # the scale rounded to dt, as a Python float
        h = h * float(torch.tensor(cfg.d_model ** 0.5, dtype=dt))
    return h


def logits_fn(p, cfg, h, dt):
    if cfg.tie_embeddings:   # the reference's einsum "btd,vd->btv"
        return h @ p["embed"].to(dt).t()
    return h @ p["head"].to(dt)


# ---------------------------------------------------------------------------
# per-layer views of the stacked parameters and caches
# ---------------------------------------------------------------------------
def _layer(tree, i: int):
    return pm.tree_map(lambda x: x[i], tree)


def _unstack(tree) -> list:
    """The layers' views of a stacked parameter tree (nested dicts), cut by
    one ``unbind`` a leaf: its backward stacks the layers' gradients in
    one op, where L ``x[i]`` would each add a zero-filled [L, ...]
    gradient."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v) for k, v in tree.items()}
        return [dict(zip(parts, layer)) for layer in zip(*parts.values())]
    return list(tree.unbind(0))


def _stack_layers(caches: list):
    return pm.tree_map(lambda *xs: torch.stack(xs), *caches)


# ---------------------------------------------------------------------------
# forward (full / prefill)
# ---------------------------------------------------------------------------
class ModelOutputs(NamedTuple):
    logits: torch.Tensor
    aux_loss: torch.Tensor
    caches: Any = ()


def _n_layers(stacked) -> int:
    return int(pm.tree_leaves(stacked)[0].shape[0])


# ---------------------------------------------------------------------------
# rematerialisation: the counterparts of the reference's
# jax.checkpoint_policies, as policies of selective activation checkpointing
# ---------------------------------------------------------------------------
_WEIGHT_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def nothing_saveable(ctx, op, *args, **kwargs):
    """Save nothing inside the region: its forward runs again in the
    backward pass (plain activation checkpointing)."""
    return CheckpointPolicy.PREFER_RECOMPUTE


def dots_with_no_batch_dims_saveable(ctx, op, *args, **kwargs):
    """Save the outputs of the products with no batch dimension, the
    weight products (``aten.mm``, ``aten.addmm``), and recompute the rest,
    the attention's batched products (``aten.bmm``) among it."""
    return (CheckpointPolicy.MUST_SAVE if op in _WEIGHT_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn, policy, *args):
    """fn(*args) under ``policy`` (None: no rematerialisation)."""
    if policy is None:
        return fn(*args)
    if policy is nothing_saveable:
        return checkpoint(fn, *args, use_reentrant=False)
    contexts = functools.partial(create_selective_checkpoint_contexts, policy)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=contexts)


def _stacks(cfg) -> list:
    """(parameter key, cache key, moe_layer) of the layer stacks in the
    order they run: the leading dense layers (``first_dense``), then
    ``blocks``."""
    dense = [("dense_blocks", "dense", False)] if cfg.first_dense else []
    return dense + [("blocks", "blocks", cfg.is_moe)]


def forward(p, cfg, tokens, *, mode="full", remat_policy=None,
            return_hidden=False):
    """tokens [B,T] -> ModelOutputs. mode: full (the training forward: no
    caches) | prefill (which also returns the caches, a stack's layers
    stacked: ``{"blocks": BlockCache(kv=KVCache([L,B,S,KV,hd] ...))}``,
    MLACache leaves [L,B,S,kv_lora] and [L,B,S,rope] for MLA, and
    ``"dense"`` for the leading dense layers).

    remat_policy (None, :func:`nothing_saveable` or
    :func:`dots_with_no_batch_dims_saveable`) wraps each layer's block, as
    the reference's ``jax.checkpoint``. The MoE layers' auxiliary losses
    are summed into ``aux_loss``. return_hidden=True skips the output head
    and returns the final normed hidden states in ``.logits`` (the chunked
    loss applies the head itself)."""
    blocks.check_ported(cfg)
    dt = compute_dtype(cfg)
    h = embed_tokens(p, cfg, tokens, dt)
    t = tokens.shape[1]
    positions = torch.arange(t, dtype=torch.int32, device=h.device)

    caches = {}
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    for key, ckey, moe_layer in _stacks(cfg):
        def layer_fn(lp, h, moe_layer=moe_layer):
            return blocks.block(lp, h, cfg, mode=mode, positions=positions,
                                moe_layer=moe_layer, dt=dt)

        caches[ckey] = []
        for lp in _unstack(p[key]):
            h, cache, aux = remat(layer_fn, remat_policy, lp, h)
            caches[ckey].append(cache)
            aux_total = aux_total + aux

    h = layers.rmsnorm(p["final_norm"], h, cfg.rms_eps)
    if return_hidden:
        return ModelOutputs(logits=h, aux_loss=aux_total)
    logits = logits_fn(p, cfg, h, dt)
    caches = ({k: _stack_layers(v) for k, v in caches.items()}
              if mode == "prefill" else ())
    return ModelOutputs(logits=logits, aux_loss=aux_total, caches=caches)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------
def xent_loss(logits, labels, z_weight: float = 1e-4):
    """Stable CE with z-loss. labels [B,T]; -1 = masked."""
    ce, zl, n = _xent_sums(logits, labels)
    return (ce + z_weight * zl) / torch.clamp(n, min=1)


def _xent_sums(logits, labels):
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    gold = torch.gather(logits32, -1,
                        labels.long().clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((lse - gold) * mask).sum(), ((lse ** 2) * mask).sum(), mask.sum()


def chunked_xent_loss(p, cfg, h, labels, *, chunk: int = 512,
                      z_weight: float = 1e-4):
    """Head matmul + CE a block of ``chunk`` positions: the [B,T,V] logits
    are never materialised, in the forward or (each block checkpointed,
    its logits recomputed) in the backward pass."""
    dt = compute_dtype(cfg)

    def block_sums(hs, ls):
        return _xent_sums(logits_fn(p, cfg, hs, dt), ls)

    ce = zl = n = 0.0
    for i in range(0, h.shape[1], chunk):
        hs, ls = h[:, i:i + chunk], labels[:, i:i + chunk]
        c, z, m = (checkpoint(block_sums, hs, ls, use_reentrant=False)
                   if torch.is_grad_enabled() else block_sums(hs, ls))
        ce, zl, n = ce + c, zl + z, n + m
    return (ce + z_weight * zl) / torch.clamp(n, min=1)


def loss_fn(p, cfg, batch, *, remat_policy=None):
    """The training loss of batch {"tokens", "labels"} [B,T]: the
    cross-entropy with z-loss, chunked over the head when T >= 2048 and
    ``cfg.loss_chunk`` divides T, plus the blocks' auxiliary loss."""
    blocks.check_ported(cfg)
    tokens, labels = batch["tokens"], batch["labels"]
    t = tokens.shape[1]
    lc = cfg.loss_chunk
    chunk = lc if (t >= 2048 and lc and t % lc == 0) else 0
    out = forward(p, cfg, tokens, remat_policy=remat_policy,
                  return_hidden=bool(chunk))
    if chunk:
        ce = chunked_xent_loss(p, cfg, out.logits, labels, chunk=chunk)
    else:
        ce = xent_loss(out.logits, labels)
    return ce + out.aux_loss.float()


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_caches(cfg, batch: int, cache_len: int, dt=torch.bfloat16,
                device=devmod.DEFAULT_DEVICE):
    """Zero caches for every layer stack: ``{"blocks": BlockCache(kv=...)}``
    (and ``"dense"`` for the leading dense layers). Attention caches have
    leaves [L, B, S, KV, hd] (S capped at the sliding window), int8 with
    fp32 scales of one when ``cfg.kv_quant``; MLA caches MLACache(c_kv
    [L, B, S, kv_lora], k_rope [L, B, S, rope]), S never capped. Like the
    reference's, they are bf16 whatever the compute dtype unless ``dt``
    says otherwise."""
    blocks.check_ported(cfg)
    dev = devmod.resolve(device)

    def attn_cache(n):
        cl = (min(cache_len, cfg.sliding_window) if cfg.sliding_window
              else cache_len)
        shape = (n, batch, cl, cfg.n_kv_heads, cfg.head_dim)
        scale_shape = (n, batch, cl, cfg.n_kv_heads, 1)
        if cfg.kv_quant:
            return attn_mod.QuantKVCache(
                k=torch.zeros(shape, dtype=torch.int8, device=dev),
                v=torch.zeros(shape, dtype=torch.int8, device=dev),
                k_scale=torch.ones(scale_shape, dtype=torch.float32,
                                   device=dev),
                v_scale=torch.ones(scale_shape, dtype=torch.float32,
                                   device=dev))
        return attn_mod.KVCache(k=torch.zeros(shape, dtype=dt, device=dev),
                                v=torch.zeros(shape, dtype=dt, device=dev))

    def mla_cache(n):
        return mla.MLACache(
            c_kv=torch.zeros((n, batch, cache_len, cfg.kv_lora_rank),
                             dtype=dt, device=dev),
            k_rope=torch.zeros((n, batch, cache_len, cfg.qk_rope_dim),
                               dtype=dt, device=dev))

    def block_cache(n):
        kv = mla_cache(n) if cfg.attn_impl == "mla" else attn_cache(n)
        return blocks.BlockCache(kv=kv, ssm=())

    caches = {}
    if cfg.first_dense:
        caches["dense"] = block_cache(cfg.first_dense)
    caches["blocks"] = block_cache(cfg.n_layers - cfg.first_dense)
    return caches


def decode_step(p, cfg, tokens, caches, pos):
    """One decode step: tokens [B,1], pos (int or 0-d tensor) the position
    of every row's token. Returns (logits [B,1,V], new caches); the caches
    passed in are left as they were."""
    blocks.check_ported(cfg)
    dt = compute_dtype(cfg)
    h = embed_tokens(p, cfg, tokens, dt)
    new_caches = {}
    for key, ckey, moe_layer in _stacks(cfg):
        new = []
        for i in range(_n_layers(p[key])):
            h, cache, _ = blocks.block(_layer(p[key], i), h, cfg,
                                       mode="decode",
                                       cache=_layer(caches[ckey], i),
                                       pos=pos, moe_layer=moe_layer, dt=dt)
            new.append(cache)
        new_caches[ckey] = _stack_layers(new)
    h = layers.rmsnorm(p["final_norm"], h, cfg.rms_eps)
    return logits_fn(p, cfg, h, dt), new_caches

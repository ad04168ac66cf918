"""Model assembly: embeddings, the stack of layers, the output head, the
losses, and the execution modes (full, prefill, decode).

The counterpart of ``repro.models.model``. Parameters are the reference's
tree: ``blocks`` holds every layer's leaves stacked on a leading [L]
axis (DeepSeek's leading dense layers a stack of their own,
``dense_blocks``, run first; the VLM's ``cross_blocks`` [G] and
``self_blocks`` [G x g], run as G groups of one cross block and g self
blocks), and a Python loop over the layers takes the place of the
reference's scans. ``model_spec`` declares all ten architectures, and
``forward``, ``loss_fn``, ``init_caches`` and ``decode_step`` run every
family: dense GQA, MoE, MLA, Mamba, Hymba, the VLM, whose vision front
end is a stand-in of precomputed embeddings ``vision_embeds`` [B,
vision_seq, d_model], and the audio family (musicgen-medium), whose
tokens are [B, T, K] over K codebooks, one embedding table and one head
each, as in the reference (its EnCodec front end is a stub there too).
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
from repro_torch.models import blocks, layers, mamba, mla
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
    """tokens [B,T] (or the audio family's [B,T,K]) -> [B,T,d]. The rows
    are gathered, then cast: the same values as the reference's
    cast-then-gather (the cast is elementwise) without converting the
    whole table every step. ``F.embedding``, whose backward sums a
    token's rows in a fixed order on the CPU (an indexing gather's adds
    them atomically, in any order)."""
    if cfg.n_codebooks:
        return _audio_embed(p, cfg, tokens, dt)
    h = F.embedding(tokens.long(), p["embed"]).to(dt)
    if cfg.embed_scale:   # the scale rounded to dt, as a Python float
        h = h * float(torch.tensor(cfg.d_model ** 0.5, dtype=dt))
    return h


def _audio_embed(p, cfg, tokens, dt):
    """tokens [B,T,K] -> [B,T,d]: codebook k's row of its table ``embed``
    [K, V, d], gathered and cast, summed over the codebooks in dt in the
    reference's order, ((e0 + e1) + e2) + e3."""
    tokens = tokens.long()
    h = None
    for k in range(cfg.n_codebooks):
        e = F.embedding(tokens[..., k], p["embed"][k]).to(dt)
        h = e if h is None else h + e
    return h


def logits_fn(p, cfg, h, dt):
    if cfg.n_codebooks:
        # the reference's einsum "btd,kdv->btkv", one weight product (mm,
        # as its dot has no batch dimension) on the heads laid side by side
        k, d, v = p["head"].shape
        w = p["head"].to(dt).permute(1, 0, 2).reshape(d, k * v)
        return (h @ w).unflatten(-1, (k, v))
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


def forward(p, cfg, tokens, *, vision_embeds=None, mode="full",
            remat_policy=None, return_hidden=False):
    """tokens [B,T] (or [B,T,K]) -> ModelOutputs, logits [B,T,V] (or
    [B,T,K,V]). mode: full (the training forward: no
    caches) | prefill (which also returns the caches, a stack's layers
    stacked: ``{"blocks": BlockCache(kv=KVCache([L,B,S,KV,hd] ...))}``,
    MLACache leaves [L,B,S,kv_lora] and [L,B,S,rope] for MLA, MambaCache
    leaves [L,B,d_conv-1,d_inner] and [L,B,d_inner,N] in ``ssm`` for
    Mamba and Hymba, ``"dense"`` for the leading dense layers; the VLM's
    ``"self"`` [G,g,B,...] and ``"cross"`` KVCache [G,B,vision_seq,KV,hd],
    the cross-attention keys and values of ``vision_embeds``).

    remat_policy (None, :func:`nothing_saveable` or
    :func:`dots_with_no_batch_dims_saveable`) wraps each layer's block, as
    the reference's ``jax.checkpoint``. The MoE layers' auxiliary losses
    are summed into ``aux_loss``. return_hidden=True skips the output head
    and returns the final normed hidden states in ``.logits`` (the chunked
    loss applies the head itself)."""
    dt = compute_dtype(cfg)
    h = embed_tokens(p, cfg, tokens, dt)
    t = tokens.shape[1]
    positions = torch.arange(t, dtype=torch.int32, device=h.device)

    def layer_fn(lp, h, moe_layer):
        return blocks.block(lp, h, cfg, mode=mode, positions=positions,
                            moe_layer=moe_layer, dt=dt)

    caches = {}
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.n_cross_layers:
        # G groups: one cross block (not rematerialised, as in the
        # reference), then group_self self blocks
        g = cfg.group_self
        self_layers = _unstack(p["self_blocks"])
        groups = []
        for i, cross_p in enumerate(_unstack(p["cross_blocks"])):
            h = blocks.cross_block(cross_p, h, vision_embeds, cfg, dt=dt)
            group = []
            for lp in self_layers[i * g:(i + 1) * g]:
                h, cache, aux = remat(layer_fn, remat_policy, lp, h, False)
                group.append(cache)
                aux_total = aux_total + aux
            groups.append(group)
        if mode == "prefill":
            caches["self"] = _stack_layers([_stack_layers(c) for c in groups])
            caches["cross"] = _cross_kv(p["cross_blocks"], cfg, vision_embeds,
                                        dt)
    else:
        for key, ckey, moe_layer in _stacks(cfg):
            stack = []
            for lp in _unstack(p[key]):
                h, cache, aux = remat(layer_fn, remat_policy, lp, h,
                                      moe_layer)
                stack.append(cache)
                aux_total = aux_total + aux
            if mode == "prefill":
                caches[ckey] = _stack_layers(stack)

    h = layers.rmsnorm(p["final_norm"], h, cfg.rms_eps)
    if return_hidden:
        return ModelOutputs(logits=h, aux_loss=aux_total)
    logits = logits_fn(p, cfg, h, dt)
    return ModelOutputs(logits=logits, aux_loss=aux_total,
                        caches=caches if mode == "prefill" else ())


def _cross_kv(cross_p, cfg, enc, dt):
    """The cross-attention keys and values of every cross layer, from the
    (fixed) encoder states: KVCache(k, v) [G, B, S, KV, hd]."""
    kv = [attn_mod.KVCache(k=attn_mod._heads_in(enc, lp["attn"]["wk"], dt),
                           v=attn_mod._heads_in(enc, lp["attn"]["wv"], dt))
          for lp in _unstack(cross_p)]
    return _stack_layers(kv)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------
def xent_loss(logits, labels, z_weight: float = 1e-4):
    """Stable CE with z-loss. labels [B,T] (or [B,T,K]); -1 = masked."""
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
    """The training loss of batch {"tokens", "labels"} [B,T] (the audio
    family's [B,T,K]; the VLM's also "vision_embeds" [B, vision_seq,
    d_model]): the cross-entropy with z-loss, chunked over the head when
    T >= 2048 and ``cfg.loss_chunk`` divides T, plus the blocks'
    auxiliary loss."""
    tokens, labels = batch["tokens"], batch["labels"]
    t = tokens.shape[1]
    lc = cfg.loss_chunk
    chunk = lc if (t >= 2048 and lc and t % lc == 0) else 0
    out = forward(p, cfg, tokens, vision_embeds=batch.get("vision_embeds"),
                  remat_policy=remat_policy, return_hidden=bool(chunk))
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
    """Zero caches for every layer stack: ``{"blocks": BlockCache(kv=...,
    ssm=...)}`` (and ``"dense"`` for the leading dense layers; the VLM's
    ``"self"`` [G, g, B, ...] and ``"cross"`` [G, B, vision_seq, KV,
    hd]). Attention caches have leaves [L, B, S, KV, hd] (S capped at the
    sliding window), int8 with fp32 scales of one when ``cfg.kv_quant``;
    MLA caches MLACache(c_kv [L, B, S, kv_lora], k_rope [L, B, S, rope]),
    S never capped; Mamba and Hymba MambaCache(conv [L, B, d_conv-1,
    d_inner], ssm [L, B, d_inner, N] fp32), the same at any position.
    Like the reference's, they are bf16 (the SSM state fp32) whatever the
    compute dtype unless ``dt`` says otherwise. ``device="meta"`` gives
    their shapes and dtypes without storage."""
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

    def ssm_cache(n):
        return mamba.MambaCache(
            conv=torch.zeros((n, batch, cfg.d_conv - 1, cfg.d_inner),
                             dtype=dt, device=dev),
            ssm=torch.zeros((n, batch, cfg.d_inner, cfg.ssm_state),
                            dtype=torch.float32, device=dev))

    def block_cache(n):
        if cfg.block == "mamba":
            return blocks.BlockCache(ssm=ssm_cache(n))
        if cfg.block == "hymba":
            return blocks.BlockCache(kv=attn_cache(n), ssm=ssm_cache(n))
        if cfg.attn_impl == "mla":
            return blocks.BlockCache(kv=mla_cache(n))
        return blocks.BlockCache(kv=attn_cache(n))

    caches = {}
    if cfg.n_cross_layers:
        caches["self"] = pm.tree_map(
            lambda x: x.reshape(cfg.n_cross_layers, cfg.group_self,
                                *x.shape[1:]), block_cache(cfg.n_layers))
        shape = (cfg.n_cross_layers, batch, cfg.vision_seq, cfg.n_kv_heads,
                 cfg.head_dim)
        caches["cross"] = attn_mod.KVCache(
            k=torch.zeros(shape, dtype=dt, device=dev),
            v=torch.zeros(shape, dtype=dt, device=dev))
        return caches
    if cfg.first_dense:
        caches["dense"] = block_cache(cfg.first_dense)
    caches["blocks"] = block_cache(cfg.n_layers - cfg.first_dense)
    return caches


def is_axes(x) -> bool:
    """A leaf of :func:`cache_logical_axes`: a non-empty tuple of axis
    names (str or None). An empty tuple is a cache's () placeholder."""
    return (isinstance(x, tuple) and len(x) > 0 and not hasattr(x, "_fields")
            and all(isinstance(e, (str, type(None))) for e in x))


def cache_logical_axes(cfg):
    """Logical sharding axes for every leaf of :func:`init_caches`' tree,
    the counterpart of the reference's: the same structure, each tensor a
    tuple of axis roles for ``dist.sharding.resolve``. Decode KV caches
    shard their sequence dim on the model axis (split-KV); SSM states
    shard d_inner. Kept in lock-step with :func:`init_caches`."""

    def attn_axes():
        a = ("layers", "batch", "kv_seq", None, None)
        if cfg.kv_quant:
            return attn_mod.QuantKVCache(k=a, v=a, k_scale=a, v_scale=a)
        return attn_mod.KVCache(k=a, v=a)

    def mla_axes():
        return mla.MLACache(c_kv=("layers", "batch", "kv_seq", None),
                            k_rope=("layers", "batch", "kv_seq", None))

    def ssm_axes():
        return mamba.MambaCache(conv=("layers", "batch", None, "model"),
                                ssm=("layers", "batch", "model", None))

    def block_axes():
        if cfg.block == "mamba":
            return blocks.BlockCache(ssm=ssm_axes())
        if cfg.block == "hymba":
            return blocks.BlockCache(kv=attn_axes(), ssm=ssm_axes())
        if cfg.attn_impl == "mla":
            return blocks.BlockCache(kv=mla_axes())
        return blocks.BlockCache(kv=attn_axes())

    def grouped(tree):
        # the VLM's self caches gain a leading group dim
        if is_axes(tree):
            return (None, *tree)
        if isinstance(tree, tuple) and tree:
            return type(tree)(*(grouped(t) for t in tree))
        return tree

    axes: dict = {}
    if cfg.n_cross_layers:
        axes["self"] = grouped(block_axes())
        axes["cross"] = attn_mod.KVCache(
            k=(None, "batch", "kv_seq", None, None),
            v=(None, "batch", "kv_seq", None, None))
    else:
        if cfg.first_dense:
            axes["dense"] = block_axes()
        axes["blocks"] = block_axes()
    return axes


def _cross_decode(cross_p, h, cross_c, cfg, dt):
    """A cross block at decode: the query of the new token against the
    prefilled cross keys and values (a cache of another dtype promoted
    with the compute dtype, as the reference's einsums do)."""
    a = cross_p["attn"]
    hn = layers.rmsnorm(cross_p["norm1"], h, cfg.rms_eps)
    q = attn_mod._heads_in(hn, a["wq"], dt)
    y = attn_mod._sdpa(*attn_mod._promoted(q, cross_c.k, cross_c.v), None,
                       cfg.n_heads // cfg.n_kv_heads)
    h = h + attn_mod._heads_out(y, a["wo"], dt)
    hn = layers.rmsnorm(cross_p["norm2"], h, cfg.rms_eps)
    return h + layers.ffn(cross_p["ffn"], hn, cfg.ffn, compute_dtype=dt)


def decode_step(p, cfg, tokens, caches, pos):
    """One decode step: tokens [B,1] (or [B,1,K]), pos (int or 0-d
    tensor) the position of every row's token. Returns (logits [B,1,V]
    (or [B,1,K,V]), new caches); the caches passed in are left as they
    were (the VLM's cross caches are passed on as they are)."""
    dt = compute_dtype(cfg)
    h = embed_tokens(p, cfg, tokens, dt)

    def run(stacked, stack_caches, moe_layer):
        """The layers of one stack in order -> their new caches stacked."""
        nonlocal h
        new = []
        for i in range(_n_layers(stacked)):
            h, cache, _ = blocks.block(_layer(stacked, i), h, cfg,
                                       mode="decode",
                                       cache=_layer(stack_caches, i),
                                       pos=pos, moe_layer=moe_layer, dt=dt)
            new.append(cache)
        return _stack_layers(new)

    new_caches = {}
    if cfg.n_cross_layers:
        g = cfg.group_self
        groups = []
        for i in range(cfg.n_cross_layers):
            h = _cross_decode(_layer(p["cross_blocks"], i), h,
                              _layer(caches["cross"], i), cfg, dt)
            group_p = pm.tree_map(lambda x: x[i * g:(i + 1) * g],
                                  p["self_blocks"])
            groups.append(run(group_p, _layer(caches["self"], i), False))
        new_caches["self"] = _stack_layers(groups)
        new_caches["cross"] = caches["cross"]
    else:
        for key, ckey, moe_layer in _stacks(cfg):
            new_caches[ckey] = run(p[key], caches[ckey], moe_layer)
    h = layers.rmsnorm(p["final_norm"], h, cfg.rms_eps)
    return logits_fn(p, cfg, h, dt), new_caches

"""Model assembly: embeddings, the stack of layers, the output head, and
the execution modes (full, prefill, decode).

The counterpart of ``repro.models.model``. Parameters are the reference's
tree: ``blocks`` holds every layer's leaves stacked on a leading [L]
axis, and a Python loop over the layers takes the place of the
reference's scan. ``model_spec`` declares all ten architectures;
``forward``, ``init_caches`` and ``decode_step`` run the dense-attention
ones and raise NotImplementedError for the rest (ROADMAP §1 item 9).
The losses wait for training.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import device as devmod
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks, layers
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
    without converting the whole table every step."""
    h = p["embed"][tokens.long()].to(dt)
    if cfg.embed_scale:   # the scale rounded to dt, as a Python float
        h = h * float(torch.tensor(cfg.d_model ** 0.5, dtype=dt))
    return h


def logits_fn(p, cfg, h, dt):
    if cfg.tie_embeddings:
        return torch.einsum("btd,vd->btv", h, p["embed"].to(dt))
    return h @ p["head"].to(dt)


# ---------------------------------------------------------------------------
# per-layer views of the stacked parameters and caches
# ---------------------------------------------------------------------------
def _layer(tree, i: int):
    return pm.tree_map(lambda x: x[i], tree)


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


def forward(p, cfg, tokens, *, mode="full"):
    """tokens [B,T] -> ModelOutputs. mode: full | prefill (which also
    returns the caches, ``{"blocks": BlockCache(kv=KVCache([L,B,S,KV,hd]
    ...))}``)."""
    blocks.check_ported(cfg)
    dt = compute_dtype(cfg)
    h = embed_tokens(p, cfg, tokens, dt)
    t = tokens.shape[1]
    positions = torch.arange(t, dtype=torch.int32, device=h.device)

    layer_caches = []
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(_n_layers(p["blocks"])):
        h, cache, aux = blocks.block(_layer(p["blocks"], i), h, cfg,
                                     mode=mode, positions=positions, dt=dt)
        layer_caches.append(cache)
        aux_total = aux_total + aux

    h = layers.rmsnorm(p["final_norm"], h, cfg.rms_eps)
    logits = logits_fn(p, cfg, h, dt)
    caches = ({"blocks": _stack_layers(layer_caches)} if mode == "prefill"
              else ())
    return ModelOutputs(logits=logits, aux_loss=aux_total, caches=caches)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_caches(cfg, batch: int, cache_len: int, dt=torch.bfloat16,
                device=devmod.DEFAULT_DEVICE):
    """Zero caches for every layer: ``{"blocks": BlockCache(kv=...)}``,
    each leaf [L, B, S, KV, hd] (S capped at the sliding window), int8
    with fp32 scales of one when ``cfg.kv_quant``. Like the reference's,
    they are bf16 whatever the compute dtype unless ``dt`` says otherwise."""
    blocks.check_ported(cfg)
    dev = devmod.resolve(device)
    n = cfg.n_layers
    cl = min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len
    shape = (n, batch, cl, cfg.n_kv_heads, cfg.head_dim)
    scale_shape = (n, batch, cl, cfg.n_kv_heads, 1)
    if cfg.kv_quant:
        kv = attn_mod.QuantKVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=dev),
            v=torch.zeros(shape, dtype=torch.int8, device=dev),
            k_scale=torch.ones(scale_shape, dtype=torch.float32, device=dev),
            v_scale=torch.ones(scale_shape, dtype=torch.float32, device=dev))
    else:
        kv = attn_mod.KVCache(k=torch.zeros(shape, dtype=dt, device=dev),
                              v=torch.zeros(shape, dtype=dt, device=dev))
    return {"blocks": blocks.BlockCache(kv=kv, ssm=())}


def decode_step(p, cfg, tokens, caches, pos):
    """One decode step: tokens [B,1], pos (int or 0-d tensor) the position
    of every row's token. Returns (logits [B,1,V], new caches); the caches
    passed in are left as they were."""
    blocks.check_ported(cfg)
    dt = compute_dtype(cfg)
    h = embed_tokens(p, cfg, tokens, dt)
    new = []
    for i in range(_n_layers(p["blocks"])):
        h, cache, _ = blocks.block(_layer(p["blocks"], i), h, cfg,
                                   mode="decode",
                                   cache=_layer(caches["blocks"], i),
                                   pos=pos, dt=dt)
        new.append(cache)
    h = layers.rmsnorm(p["final_norm"], h, cfg.rms_eps)
    return logits_fn(p, cfg, h, dt), {"blocks": _stack_layers(new)}

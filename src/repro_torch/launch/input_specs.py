"""Meta-device stand-ins for every model input, per (arch x shape): the
counterpart of ``repro.launch.input_specs``, whose ShapeDtypeStructs
carry a mesh's shardings. These carry none (the reference's
``sharding.array_sharding`` and ``rules_for`` are undefined, ROADMAP §3):
they are tensors on the meta device, with shapes and dtypes and no
storage, so that a step applied to them allocates no byte and launches no
kernel.
"""
from __future__ import annotations

import torch

from repro_torch.configs import ModelConfig, ShapeConfig
from repro_torch.models import model as model_mod

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _tokens(cfg: ModelConfig, b: int, s: int) -> torch.Tensor:
    """int32 [b, s], or the audio family's [b, s, K]."""
    shape = (b, s, cfg.n_codebooks) if cfg.n_codebooks else (b, s)
    return _meta(shape, torch.int32)


def _vision(cfg: ModelConfig, b: int) -> dict:
    """The VLM's stand-in vision embeddings [b, vision_seq, d] bf16."""
    if not cfg.n_cross_layers:
        return {}
    return {"vision_embeds": _meta((b, cfg.vision_seq, cfg.d_model),
                                   torch.bfloat16)}


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Training-batch stand-ins: tokens and labels (+ vision embeddings)."""
    b, s = shape.global_batch, shape.seq_len
    return {"tokens": _tokens(cfg, b, s), "labels": _tokens(cfg, b, s),
            **_vision(cfg, b)}


def prefill_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    return {"tokens": _tokens(cfg, b, s), **_vision(cfg, b)}


def decode_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Decode-step stand-ins: one new token a sequence, the caches of an
    s-long context (``init_caches(cfg, b, cache_len=s)``, bf16 as the
    reference's, the SSM state fp32) and ``pos``. The reference's pos is
    an abstract int32 scalar; the port's decode reads the position on
    the host, so it is the caches' last one, s - 1."""
    b, s = shape.global_batch, shape.seq_len
    return {"tokens": _tokens(cfg, b, 1),
            "caches": model_mod.init_caches(cfg, b, cache_len=s,
                                            device=META),
            "pos": s - 1}

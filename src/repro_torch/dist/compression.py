"""Int8 gradient compression with error feedback.

The counterpart of ``repro.dist.compression``. Symmetric int8
quantisation cuts an all-reduce's wire format 4x; the quantisation
residual is carried forward and added to the next step's gradient (error
feedback), which keeps the long-run average unbiased (EF-SGD).
"""
from __future__ import annotations

import torch

_EPS = 1e-30


def quantise_tensor(x: torch.Tensor):
    """x float[...] -> (q int8[...] in [-127, 127], scale, a 0-d tensor of
    x's dtype). Symmetric round-half-to-even: x ~= q * scale,
    |x - q * scale| <= scale / 2."""
    scale = torch.clamp(x.abs().max() / 127.0, min=_EPS)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_decompress(grads, errors):
    """One error-feedback round over lists of tensors -> (dequantised,
    new errors): each tensor is quantised after the carried error is
    added, and the new error is exactly what the wire format lost."""
    deqs, new_errors = [], []
    for g, e in zip(grads, errors):
        target = g + e
        q, scale = quantise_tensor(target)
        dq = q.to(g.dtype) * scale
        deqs.append(dq)
        new_errors.append(target - dq)
    return deqs, new_errors

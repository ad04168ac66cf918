"""Fused softmax attention (FlashAttention-style): K9 and its plain version.

The counterpart of ``repro.kernels.flash_attention``. q, k, v are
``[B, H, T, D]`` with the same T (a caller with grouped KV heads expands
them first); the result is ``softmax(q k^T * D^-0.5 [+ causal]) v`` in
``q.dtype``, with fp32 scores and statistics.

  flash_attention_plain   the reference's oracle (``repro/kernels/ref.py:
                          flash_attention_ref``) step for step, any device
  flash_attention_cuda    K9 (``csrc/flash_attention.cu``, replaces
                          ``repro/kernels/flash_attention.py:26``,
                          ``_flash_kernel``): one library, two hand-written
                          instances picked by :func:`_instance` — bf16 at
                          head_dim 64/128/256 on the tensor cores (wgmma,
                          TMA, a warp-specialised ring; P rounded to bf16
                          for P V), everything else register-tiled on the
                          fp32 FMA units; any head_dim, any T
  flash_attention         the entry point: the reference's checks, then K9
                          on a CUDA device or the plain version on the CPU

``block_q`` and ``block_k`` are checked as the reference checks them; the
kernel's own tiles are its own, so they change the result only through
the order of float summation. No model of the port calls this: the
reference's model computes attention in plain einsums too.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import device as devmod

NEG = -1e30
WGMMA_HEAD_DIMS = (64, 128, 256)    # bf16 head dims of the tensor-core instance
_DTYPES = (torch.float32, torch.bfloat16)


def _instance(dtype: torch.dtype, d: int) -> str:
    """The K9 instance a launch takes, by dtype and head_dim alone (the C
    side's ``flash_attention_instance``): ``"wgmma"`` for bf16 with D in
    {64, 128, 256}, ``"fma"`` otherwise."""
    if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "fma"


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True) -> torch.Tensor:
    """Plain softmax attention, on any device: q/k/v [B,H,T,D] -> [B,H,T,D],
    fp32 scores, a -1e30 causal fill, the output in q.dtype."""
    t, d = q.shape[2], q.shape[3]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (d ** -0.5)
    if causal:
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask, s, torch.full_like(s, NEG))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", w, v.float())
    return out.to(q.dtype)


def _check_cuda(q, k, v) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda":
            raise ValueError(f"{name}: the kernel takes CUDA tensors, got one"
                             f" on {x.device}")
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"{name}: want {q.dtype} on {q.device}, got"
                             f" {x.dtype} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: want a contiguous tensor")
    if q.dtype not in _DTYPES:
        raise ValueError(f"the kernel takes float32 or bfloat16, not"
                         f" {q.dtype}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """Launch K9 (``csrc/flash_attention.cu``) on the current stream: same
    contract as :func:`flash_attention_plain`, for contiguous fp32 or bf16
    CUDA tensors of one shape. Adds one to ``flash_attention_cuda.launches``
    and to ``flash_attention_cuda.instances[_instance(dtype, D)]`` per
    launch."""
    from repro_torch.kernels import build  # lazy: builds at first launch

    _check_shapes(q, k, v)
    _check_cuda(q, k, v)
    b, h, t, d = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    instance = _instance(q.dtype, d)
    if instance == "wgmma":
        # TMA reads from 16-byte aligned addresses only
        q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone()
                   for x in (q, k, v))
    lib = build.flash_attention_library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h,
            t, d, int(q.dtype == torch.bfloat16), int(causal),
            ctypes.c_float(d ** -0.5),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err}"
            f" ({lib.error_string(err).decode()})")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.instances[instance] += 1
    return out


def _check_shapes(q, k, v) -> None:
    if q.dim() != 4 or tuple(k.shape) != tuple(q.shape) \
            or tuple(v.shape) != tuple(q.shape):
        raise ValueError(f"q, k, v must share one [B, H, T, D] shape, got"
                         f" {tuple(q.shape)}, {tuple(k.shape)},"
                         f" {tuple(v.shape)}")


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 128,
                    block_k: int = 128,
                    device=devmod.DEFAULT_DEVICE) -> torch.Tensor:
    """softmax(q k^T * D^-0.5 [+ causal]) v on ``device``: q/k/v
    [B, H, T, D] (same T; grouped KV heads expanded by the caller), fp32
    or bf16 -> [B, H, T, D] in q's dtype.

    Raises where the reference asserts: k and v must have q's shape, and T
    must be a multiple of ``min(block_q, T)`` and of ``min(block_k, T)``.
    A CUDA device launches K9 (one launch); the CPU runs its plain version.
    """
    dev = devmod.resolve(device)
    q, k, v = (torch.as_tensor(x).to(dev) for x in (q, k, v))
    _check_shapes(q, k, v)
    t = q.shape[2]
    block_q, block_k = min(block_q, t), min(block_k, t)
    if block_q < 1 or block_k < 1 or t % block_q or t % block_k:
        raise ValueError(f"T={t} is not a multiple of block_q={block_q} and"
                         f" block_k={block_k}")
    if dev.type == "cuda":
        return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=causal)
    return flash_attention_plain(q, k, v, causal=causal)


CUDA_WRAPPERS = (flash_attention_cuda,)
flash_attention_cuda.launches = 0
flash_attention_cuda.instances = {"wgmma": 0, "fma": 0}

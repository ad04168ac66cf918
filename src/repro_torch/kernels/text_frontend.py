"""The text front end (K4): codepoint tile in, the stemmer's word rows out.

The counterpart of ``repro.kernels.text_frontend``. The word geometry
(starts, raw lengths) comes from ``core.textnorm.segment_geometry``, a
plain PyTorch pre-pass, as the reference computes it in jnp before its
kernel; the kernel then turns every word row into the int32[16] row the
stemmer consumes: read the word's raw window of at most MAX_RAW
codepoints, classify through CLASS_LUT, keep the first CMAX letters, strip
the clitics and pack (``core.textnorm.strip_and_pack``).

  text_frontend_plain  the plain PyTorch version, gather-based like the
                       reference's kernel body (a window per word); the
                       CPU path and the yardstick on the card
  text_frontend_cuda   the CUDA kernel, ``csrc/text_frontend.cu`` with the
                       per-word rules in ``csrc/text_frontend.cuh``
                       (replaces ``repro/kernels/text_frontend.py:41``,
                       ``_frontend_kernel``); bound by bytes: every row of
                       the T // 2 + 1 word capacity is written, 64 B each,
                       so a block writes its empty rows a warp a 512-byte
                       piece and hands only the live rows to its groups of
                       G lanes, a word a group (G by the launch's rows,
                       ``last_lanes``)

:func:`text_frontend` takes the plain version for a CPU tensor only; a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import alphabet as ab
from repro_torch.core import textnorm as tn
from repro_torch.kernels.stem_fused import _check_cuda, _cuda_stream, _raise_on

LANE = 128
# rows the plain version handles at once (bounds its [rows, MAX_RAW]
# intermediates)
_PLAIN_ROWS = 1 << 18


def _check_geometry(chars, starts, lens, block_w: int) -> int:
    if chars.dim() != 1 or chars.shape[0] == 0:
        raise ValueError(f"chars must be a non-empty 1-D codepoint tile, got"
                         f" {tuple(chars.shape)}")
    if starts.shape != lens.shape or starts.dim() != 1:
        raise ValueError(f"starts {tuple(starts.shape)} and lens"
                         f" {tuple(lens.shape)} must be matching 1-D rows")
    wp = starts.shape[0]
    if block_w < 1 or wp % block_w:
        raise ValueError(f"word capacity {wp} not a multiple of"
                         f" block_w={block_w}")
    return wp


def text_frontend_plain(chars: torch.Tensor, starts: torch.Tensor,
                        lens: torch.Tensor, *, block_w: int = 128):
    """K4's plain PyTorch version, on any device: chars int32[T] (0 =
    separator), starts/lens int32[Wp] (Wp a multiple of block_w) -> words
    int32[Wp, 16].

    Gather-based like the reference's kernel body: each row reads its
    MAX_RAW-codepoint window (indices clamped into the tile padded with 0
    to a multiple of 128), masks past its length, classifies, and picks
    its k-th letter as the column whose running letter count reaches
    k + 1.
    """
    wp = _check_geometry(chars, starts, lens, block_w)
    dev = chars.device
    lut, fw = tn.device_tables(dev)
    t = chars.shape[0]
    flat = torch.cat([chars.to(torch.int32),
                      chars.new_zeros((-t) % LANE, dtype=torch.int32)])
    j = torch.arange(tn.MAX_RAW, device=dev)
    out = torch.empty((wp, ab.MAXLEN), dtype=torch.int32, device=dev)
    for r0 in range(0, wp, _PLAIN_ROWS):
        s = starts[r0:r0 + _PLAIN_ROWS].to(torch.int64)
        ln = lens[r0:r0 + _PLAIN_ROWS].to(torch.int64)
        idx = (s[:, None] + j).clamp(0, flat.shape[0] - 1)
        live = j < ln.clamp(max=tn.MAX_RAW)[:, None]
        cls = torch.where(live, tn.classify_codes(flat[idx], lut),
                          torch.zeros((), dtype=torch.int32, device=dev))
        is_letter = cls > 0
        csum = torch.cumsum(is_letter, dim=1, dtype=torch.int32)
        nlet = csum[:, -1].clamp(max=tn.CMAX)
        codes = torch.stack(
            [torch.where(is_letter & (csum == k + 1), cls, 0).sum(
                dim=1, dtype=torch.int32) for k in range(tn.CMAX)], dim=1)
        out[r0:r0 + _PLAIN_ROWS] = tn.strip_and_pack(codes, nlet, fw)
    return out


def text_frontend_cuda(chars: torch.Tensor, starts: torch.Tensor,
                       lens: torch.Tensor, *, block_w: int = 128):
    """Launch K4 (``csrc/text_frontend.cu``) on the current stream: same
    contract as :func:`text_frontend_plain`, for CUDA tensors. Records the
    lanes a word and blocks the launch took (``last_lanes``,
    ``last_grid``; ``build.host_text_lanes`` gives the rule's lanes) and
    adds one to ``text_frontend_cuda.launches`` per launch."""
    from repro_torch.kernels import build  # lazy: builds at first launch

    dev = chars.device
    _check_cuda("chars", chars, 1, dev, align=4)
    _check_cuda("starts", starts, 1, dev, align=4)
    _check_cuda("lens", lens, 1, dev, align=4)
    wp = _check_geometry(chars, starts, lens, block_w)
    words = torch.empty((wp, ab.MAXLEN), dtype=torch.int32, device=dev)
    if wp == 0:
        return words
    lut, fw = tn.device_tables(dev)
    lib = build.text_frontend_library()
    with torch.cuda.device(dev):
        err = lib.text_frontend_launch(
            chars.data_ptr(), chars.shape[0], starts.data_ptr(),
            lens.data_ptr(), wp, lut.data_ptr(), fw.data_ptr(), fw.shape[0],
            words.data_ptr(), block_w, _cuda_stream(dev))
    _raise_on(err, lib, "text_frontend")
    lanes, grid = ctypes.c_int(0), ctypes.c_int(0)
    lib.text_frontend_last_shape(ctypes.byref(lanes), ctypes.byref(grid))
    text_frontend_cuda.last_lanes = lanes.value
    text_frontend_cuda.last_grid = grid.value
    text_frontend_cuda.launches += 1
    return words


text_frontend_cuda.launches = 0
text_frontend_cuda.last_lanes = text_frontend_cuda.last_grid = 0
CUDA_WRAPPERS = (text_frontend_cuda,)


def text_frontend(chars: torch.Tensor, starts: torch.Tensor,
                  lens: torch.Tensor, *, block_w: int = 128):
    """chars int32[T], starts/lens int32[Wp] from
    ``textnorm.segment_geometry`` -> words int32[Wp, 16] on the tile's
    device, bit-identical to ``textnorm.frontend_reference`` and to the
    host ``analyze_text_py`` rows. A CUDA tile launches K4 (or raises); a
    CPU tile runs the plain version."""
    if chars.device.type == "cuda":
        return text_frontend_cuda(chars, starts, lens, block_w=block_w)
    if chars.device.type != "cpu":
        raise ValueError(f"no text front end for device {chars.device}")
    return text_frontend_plain(chars, starts, lens, block_w=block_w)

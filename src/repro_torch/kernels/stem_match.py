"""Dictionary layouts and the in-kernel sorted search, in plain PyTorch.

The counterpart of the helpers in ``repro.kernels.stem_match`` that the
stemmer megakernel uses: the padding constants, the two padded table
layouts (lane-padded for the comparator bank, pow2 sentinel-padded for
the sorted search) and ``bsearch_hit``, the branchless bisection that the
CUDA kernel (``csrc/stem_fused.cu``) runs per candidate key.

Padding never matches: candidate keys are >= 0, the bank pads with
DICT_PAD = -2, and the sorted layout pads on the right with a sentinel
larger than any packed 24-bit key, which keeps the table sorted.
"""
from __future__ import annotations

import torch

LANE = 128
KEY_PAD = -1
DICT_PAD = -2
DICT_SENTINEL = 1 << 28


def _ceil_log2(n: int) -> int:
    k = 0
    while (1 << k) < n:
        k += 1
    return k


def _pad_right(dict_keys: torch.Tensor, total: int, value: int):
    pad = torch.full((total - dict_keys.shape[0],), value, dtype=torch.int32,
                     device=dict_keys.device)
    return torch.cat([dict_keys.to(torch.int32), pad])


def pad_dict_lanes(dict_keys: torch.Tensor) -> torch.Tensor:
    """Pad to a LANE multiple with DICT_PAD and reshape (rows, LANE)."""
    r = dict_keys.shape[0]
    return _pad_right(dict_keys, r + (-r) % LANE, DICT_PAD).reshape(-1, LANE)


def pad_dict_sorted(dict_keys: torch.Tensor) -> torch.Tensor:
    """Pad a *sorted* dictionary to the next pow2 >= LANE with DICT_SENTINEL,
    reshaped (rows, LANE)."""
    rp = max(LANE, 1 << _ceil_log2(dict_keys.shape[0]))
    return _pad_right(dict_keys, rp, DICT_SENTINEL).reshape(-1, LANE)


def bsearch_hit(flat_dict: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Membership via an unrolled branchless binary search.

    flat_dict int32[Rp] sorted ascending, Rp a power of two (sentinel
    padded); keys int32[...] -> bool[...]. Exactly ceil(log2 Rp)
    bisection steps; each gather clamps its index into [0, Rp-1], the
    ``jnp.take(mode="clip")`` of the reference.
    """
    rp = flat_dict.shape[0]

    def take(idx):
        return flat_dict[idx.clamp(0, rp - 1).long()]

    lo = torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    hi = torch.full(keys.shape, rp - 1, dtype=torch.int32, device=keys.device)
    for _ in range(_ceil_log2(rp)):
        mid = (lo + hi) // 2
        ge = take(mid) >= keys
        hi = torch.where(ge, mid, hi)
        lo = torch.where(ge, lo, mid + 1)
    return take(lo) == keys

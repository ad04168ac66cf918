"""Dictionary layouts and the in-kernel sorted search, in plain PyTorch.

The counterpart of the helpers in ``repro.kernels.stem_match`` that the
stemmer kernels use: the padding constants, the padded table layouts
(lane-padded for the comparator bank, pow2 sentinel-padded for the sorted
search, and the tiled ``[tri | quad | bi]`` stream of the streamed
layout, :class:`DictTileSet`) and ``bsearch_hit``, the branchless
bisection that the CUDA kernels (``csrc/stem_resident.cuh``) run per
candidate key.

Padding never matches: candidate keys are >= 0, the bank pads with
DICT_PAD = -2, and the sorted layout pads on the right with a sentinel
larger than any packed 24-bit key, which keeps the table sorted.
"""
from __future__ import annotations

from dataclasses import dataclass

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


def pad_dict_tiles(dict_keys: torch.Tensor, tile_rows: int) -> torch.Tensor:
    """Pad a *sorted* dictionary to a whole number of (tile_rows, LANE) tiles
    with DICT_SENTINEL, reshaped (n_tiles * tile_rows, LANE).

    Right padding keeps every tile internally sorted, so each tile can be
    searched on its own and its first/last element is its [min, max].
    Empty and placeholder tables still make one full sentinel tile.
    """
    r = dict_keys.shape[0]
    per_tile = tile_rows * LANE
    rp = max(per_tile, -(-r // per_tile) * per_tile)
    return _pad_right(dict_keys, rp, DICT_SENTINEL).reshape(-1, LANE)


@dataclass
class DictTileSet:
    """The streamed layout, prebuilt once per dictionary version.

    ``stream`` is the concatenated ``[tri | quad | bi]`` tile stream of
    :func:`pad_dict_tiles` (each ``(dict_block_r x LANE)`` tile sorted and
    sentinel-padded); ``mins`` / ``maxs`` are every tile's first and last
    element, which the tile-visit pre-pass intersects candidate keys with.
    """

    stream: torch.Tensor           # int32 [n_tiles * dict_block_r, LANE]
    mins: torch.Tensor             # int32 [n_tiles]
    maxs: torch.Tensor             # int32 [n_tiles]
    dict_block_r: int              # tile height in LANE rows
    counts: tuple                  # (tri_tiles, quad_tiles, bi_tiles)

    @property
    def n_tiles(self) -> int:
        return sum(self.counts)

    def to(self, device) -> "DictTileSet":
        if self.stream.device == torch.device(device):
            return self
        return DictTileSet(self.stream.to(device), self.mins.to(device),
                           self.maxs.to(device), self.dict_block_r,
                           self.counts)


def build_dict_tiles(tri: torch.Tensor, quad: torch.Tensor, bi: torch.Tensor,
                     dict_block_r: int) -> DictTileSet:
    """Pad and concatenate the three sorted dictionaries into the tile
    stream, and take each tile's [min, max]. All three tables are always
    in the stream (bi too, for infix=False): unused tiles are never
    visited."""
    if dict_block_r < 1:
        raise ValueError(f"dict_block_r must be >= 1, got {dict_block_r}")
    tiles = [pad_dict_tiles(d, dict_block_r) for d in (tri, quad, bi)]
    counts = tuple(t.shape[0] // dict_block_r for t in tiles)
    stream = torch.cat(tiles).contiguous()
    flat = stream.reshape(-1, dict_block_r * LANE)   # one row per tile
    return DictTileSet(stream=stream, mins=flat[:, 0].contiguous(),
                       maxs=flat[:, -1].contiguous(),
                       dict_block_r=dict_block_r, counts=counts)


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

"""Dictionary layouts, the in-kernel sorted search, and the standalone
Compare kernels.

The counterpart of ``repro.kernels.stem_match``: the padding constants,
the padded table layouts (lane-padded for the comparator bank, pow2
sentinel-padded for the sorted search, and the tiled ``[tri | quad |
bi]`` stream of the streamed layout with its fence level,
:class:`DictTileSet`), ``bsearch_hit``, the branchless bisection that
the CUDA kernels (``csrc/stem_resident.cuh``) run per candidate key, and
the two membership kernels of the staged Compare path, each beside its
plain PyTorch version (``csrc/dict_match.cu``):

  dict_match_plain / dict_match_cuda (K7, replaces
      ``repro/kernels/stem_match.py:152``, ``_match_kernel``): the
      comparator bank, membership in the table padded with DICT_PAD to a
      multiple of ``block_r * 128``; the plain version compares all
      pairs, the kernel banks the table by a hash of the value
      (``csrc/dict_bank.cuh``, :func:`bank_of`) and compares a key only
      with its own bank;
  dict_match_bsearch_plain / dict_match_bsearch_cuda (K8, replaces
      ``:208``, ``_bsearch_kernel``): ``bsearch_hit`` against the sorted
      table of :func:`pad_dict_sorted`; the kernel reads the unpadded
      table, its padding virtually, and searches a fence tree, then one
      8-entry block (``csrc/dict_search.cuh``).

Padding never matches a candidate key, which is >= 0: the bank pads with
DICT_PAD = -2, and the sorted layout pads on the right with a sentinel
larger than any packed 24-bit key, which keeps the table sorted. Other
keys may: as in the reference, a key equal to -2 hits the bank whenever
the table was padded, and a key equal to DICT_SENTINEL hits the sorted
search whenever R is not already the padded size. The port keeps both.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

LANE = 128
KEY_PAD = -1
DICT_PAD = -2
DICT_SENTINEL = 1 << 28
# The streamed kernels' fence level (csrc/stem_fences.cuh): every F-th
# entry of each table's tile stream, F the smallest power of two >= 8
# whose fences fit one block's shared memory (232,448 bytes on an H100).
FENCE_MIN_STEP = 8
FENCE_BUDGET_BYTES = 227 * 1024
# K8's two instances by their number in csrc/dict_search.cuh (kShared,
# kGlobal): the padded table staged in shared memory, or read from global
# memory with only a tree of its fences staged; the header's ds::instance
# picks one by the padded table's size (build.host_bsearch_instance)
BSEARCH_INSTANCES = ("shared", "global")
# the plain comparator bank's all-pairs temporary, in bytes (bool)
_BANK_TEMP_BYTES = 1 << 28
# K7's banks (csrc/dict_bank.cuh): entries a block banks at once, the
# hash's multiplier, the fewest bank bits
BANK_CHUNK_MAX = 8192
BANK_HASH_MUL = 0x9E3779B1
BANK_MIN_BITS = 5


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


def sorted_padded(r: int) -> int:
    """Entries of the sorted search's table of ``r`` keys after padding:
    the next power of two >= LANE."""
    return max(LANE, 1 << _ceil_log2(r))


def pad_dict_sorted(dict_keys: torch.Tensor) -> torch.Tensor:
    """Pad a *sorted* dictionary to the next pow2 >= LANE with DICT_SENTINEL,
    reshaped (rows, LANE)."""
    return _pad_right(dict_keys, sorted_padded(dict_keys.shape[0]),
                      DICT_SENTINEL).reshape(-1, LANE)


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


def fence_counts(counts, tile_n: int, fence_step: int) -> tuple:
    """Fences of each table of a tile stream: ceil(entries / fence_step)
    for tables of ``counts`` tiles of ``tile_n`` entries."""
    return tuple(-(-c * tile_n // fence_step) for c in counts)


def choose_fence_step(counts, tile_n: int,
                      budget: int = FENCE_BUDGET_BYTES) -> int:
    """The smallest power of two >= FENCE_MIN_STEP whose fences (4 bytes
    each) fit ``budget`` bytes; a larger dictionary gets a coarser step,
    never an error (at worst one fence a table)."""
    step, longest = FENCE_MIN_STEP, max(counts) * tile_n
    while 4 * sum(fence_counts(counts, tile_n, step)) > budget \
            and step < longest:
        step *= 2
    return step


@dataclass
class DictTileSet:
    """The streamed layout, prebuilt once per dictionary version.

    ``stream`` is the concatenated ``[tri | quad | bi]`` tile stream of
    :func:`pad_dict_tiles` (each ``(dict_block_r x LANE)`` tile sorted and
    sentinel-padded); ``mins`` / ``maxs`` are every tile's first and last
    element, which the tile-visit pre-pass intersects candidate keys with.
    ``fences`` is the fence level the streamed kernels search first:
    entries 0, F, 2F, ... of each table's part of the stream, the three
    tables' fences one after the other, F = ``fence_step``.
    """

    stream: torch.Tensor           # int32 [n_tiles * dict_block_r, LANE]
    mins: torch.Tensor             # int32 [n_tiles]
    maxs: torch.Tensor             # int32 [n_tiles]
    dict_block_r: int              # tile height in LANE rows
    counts: tuple                  # (tri_tiles, quad_tiles, bi_tiles)
    fences: torch.Tensor           # int32 [sum(fence_counts)]
    fence_step: int                # F, a power of two >= FENCE_MIN_STEP

    @property
    def n_tiles(self) -> int:
        return sum(self.counts)

    @property
    def fence_counts(self) -> tuple:
        return fence_counts(self.counts, self.dict_block_r * LANE,
                            self.fence_step)

    def to(self, device) -> "DictTileSet":
        if self.stream.device == torch.device(device):
            return self
        return DictTileSet(self.stream.to(device), self.mins.to(device),
                           self.maxs.to(device), self.dict_block_r,
                           self.counts, self.fences.to(device),
                           self.fence_step)


def build_fences(stream: torch.Tensor, counts, tile_n: int,
                 fence_step: int) -> torch.Tensor:
    """Every ``fence_step``-th entry of each table's part of the stream,
    starting at its first entry, the tables concatenated."""
    flat = stream.reshape(-1)
    parts, base = [], 0
    for c in counts:
        parts.append(flat[base:base + c * tile_n:fence_step])
        base += c * tile_n
    return torch.cat(parts).contiguous()


def build_dict_tiles(tri: torch.Tensor, quad: torch.Tensor, bi: torch.Tensor,
                     dict_block_r: int, *,
                     fence_budget: int = FENCE_BUDGET_BYTES) -> DictTileSet:
    """Pad and concatenate the three sorted dictionaries into the tile
    stream, take each tile's [min, max], and the fence level at the
    smallest step whose fences fit ``fence_budget`` bytes. All three
    tables are always in the stream (bi too, for infix=False): unused
    tiles are never searched."""
    if dict_block_r < 1:
        raise ValueError(f"dict_block_r must be >= 1, got {dict_block_r}")
    tiles = [pad_dict_tiles(d, dict_block_r) for d in (tri, quad, bi)]
    counts = tuple(t.shape[0] // dict_block_r for t in tiles)
    stream = torch.cat(tiles).contiguous()
    tile_n = dict_block_r * LANE
    flat = stream.reshape(-1, tile_n)   # one row per tile
    step = choose_fence_step(counts, tile_n, fence_budget)
    return DictTileSet(stream=stream, mins=flat[:, 0].contiguous(),
                       maxs=flat[:, -1].contiguous(),
                       dict_block_r=dict_block_r, counts=counts,
                       fences=build_fences(stream, counts, tile_n, step),
                       fence_step=step)


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


# ---------------------------------------------------------------------------
# the standalone Compare kernels: comparator bank (K7), sorted search (K8)
# ---------------------------------------------------------------------------
def _check_blocks(block_n: int, block_r: int = 1) -> None:
    if block_n < 1 or block_r < 1:
        raise ValueError(f"block_n and block_r must be >= 1, got {block_n},"
                         f" {block_r}")


def bank_padded(r: int, block_r: int) -> int:
    """Entries of the bank's table of ``r`` keys after padding."""
    return r + (-r) % (block_r * LANE)


def pad_dict_bank(dict_keys: torch.Tensor, block_r: int) -> torch.Tensor:
    """The bank's flat table: padded with DICT_PAD to a multiple of
    ``block_r * LANE`` entries, as ``dict_match_pallas`` pads it."""
    return _pad_right(dict_keys, bank_padded(dict_keys.shape[0], block_r),
                      DICT_PAD)


def bank_bits(chunk: int) -> int:
    """Bank bits of a chunk of up to ``chunk`` entries (``db::bank_bits``):
    the next power of two, at least 2^BANK_MIN_BITS banks."""
    return max(BANK_MIN_BITS, _ceil_log2(chunk))


def bank_of(values, bits: int) -> np.ndarray:
    """The bank of each int32 value (``db::bank_of``): the top ``bits`` bits
    of ``uint32(value) * BANK_HASH_MUL`` mod 2^32."""
    v = np.asarray(values, dtype=np.int32).astype(np.uint32).astype(np.uint64)
    return ((v * BANK_HASH_MUL) & 0xFFFFFFFF) >> (32 - bits)


def bank_chunk(rp: int) -> int:
    """Entries K7 banks at once for a padded table of ``rp`` entries."""
    return max(LANE, min(rp, BANK_CHUNK_MAX))


def bank_stats(keys: torch.Tensor, dict_keys: torch.Tensor, *,
               block_r: int = 8) -> dict:
    """What K7's banks do with these inputs, counted on the host: the
    largest bank, the kept entries, and the compares (a key meets every
    entry of its bank in every chunk) -> {"largest", "entries",
    "compares", "banks", "chunks"}."""
    table = pad_dict_bank(dict_keys, block_r).cpu().numpy()
    k = keys.cpu().numpy()
    chunk = bank_chunk(table.shape[0])
    bits = bank_bits(chunk)
    largest = entries = compares = chunks = 0
    for c0 in range(0, max(1, table.shape[0]), chunk):
        part = table[c0:c0 + chunk]
        part = part[np.r_[True, part[1:] != part[:-1]]] if part.size else part
        sizes = np.bincount(bank_of(part, bits).astype(np.int64),
                            minlength=1 << bits)
        largest = max(largest, int(sizes.max()))
        entries += int(part.size)
        compares += int(sizes[bank_of(k, bits).astype(np.int64)].sum())
        chunks += 1
    return dict(largest=largest, entries=entries, compares=compares,
                banks=1 << bits, chunks=chunks)


def dict_match_plain(keys: torch.Tensor, dict_keys: torch.Tensor, *,
                     block_n: int = 2, block_r: int = 8) -> torch.Tensor:
    """K7's plain PyTorch version, on any device: keys int32[N], dict_keys
    int32[R] in any order -> bool[N], each key against every entry of the
    padded table. The keys go in chunks so that the all-pairs temporary
    stays under 256 MB."""
    _check_blocks(block_n, block_r)
    table = pad_dict_bank(dict_keys, block_r)
    n = keys.shape[0]
    out = torch.zeros((n,), dtype=torch.bool, device=keys.device)
    chunk = max(1, _BANK_TEMP_BYTES // max(1, table.shape[0]))
    for c0 in range(0, n, chunk):
        k = keys[c0:c0 + chunk]
        out[c0:c0 + chunk] = (k[:, None] == table[None, :]).any(dim=1)
    return out


def dict_match_bsearch_plain(keys: torch.Tensor, dict_keys: torch.Tensor, *,
                             block_n: int = 8) -> torch.Tensor:
    """K8's plain PyTorch version, on any device: keys int32[N], dict_keys
    int32[R] sorted -> bool[N], ``bsearch_hit`` against the pow2
    sentinel-padded table."""
    _check_blocks(block_n)
    return bsearch_hit(pad_dict_sorted(dict_keys).reshape(-1), keys)


def _check_match_args(keys, dict_keys):
    """-> (keys, dict_keys, device): contiguous int32 vectors on one card."""
    from repro_torch.kernels import stem_fused as sf  # lazy: sf imports us

    keys = keys.contiguous()
    dev = keys.device
    sf._check_cuda("keys", keys, 1, dev, align=4)
    sf._check_cuda("dict_keys", dict_keys, 1, dev, align=4)
    return keys, dev


def dict_match_cuda(keys: torch.Tensor, dict_keys: torch.Tensor, *,
                    block_n: int = 2, block_r: int = 8) -> torch.Tensor:
    """Launch K7 (``csrc/dict_match.cu``) on the current stream: same
    contract as :func:`dict_match_plain`, for CUDA tensors. The padded
    table is banked on the card, :func:`bank_chunk` entries at a time;
    ``block_n`` is only checked (a persistent grid strides over the keys).
    Adds one to ``dict_match_cuda.launches`` per launch."""
    from repro_torch.kernels import build  # lazy: builds at first launch
    from repro_torch.kernels import stem_fused as sf

    _check_blocks(block_n, block_r)
    keys, dev = _check_match_args(keys, dict_keys)
    n = keys.shape[0]
    out = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return out
    r = dict_keys.shape[0]
    rp = bank_padded(r, block_r)      # the kernel reads the padding as -2
    if keys.data_ptr() % 16:          # it reads keys 16 B at a time
        keys = keys.clone()
    lib = build.dict_match_library()
    with torch.cuda.device(dev):
        err = lib.dict_match_bank_launch(
            keys.data_ptr(), n, dict_keys.data_ptr(), r, rp, out.data_ptr(),
            bank_chunk(rp), sf._cuda_stream(dev))
    sf._raise_on(err, lib, "dict_match_bank")
    dict_match_cuda.launches += 1
    return out


def _last_bsearch_instance(lib) -> str:
    """The instance the library's last K8 launch took."""
    shape = [ctypes.c_int(0) for _ in range(4)]
    lib.dict_bsearch_last_shape(*(ctypes.byref(x) for x in shape))
    return BSEARCH_INSTANCES[shape[0].value]


def dict_match_bsearch_cuda(keys: torch.Tensor, dict_keys: torch.Tensor, *,
                            block_n: int = 8) -> torch.Tensor:
    """Launch K8 (``csrc/dict_match.cu``) on the current stream: same
    contract as :func:`dict_match_bsearch_plain`, for CUDA tensors. One
    kernel: it reads the unpadded table and its sentinel padding
    virtually, in shared memory while the padded table fits
    (``build.host_bsearch_instance``); ``block_n`` is only checked (a
    persistent grid strides over the keys). Adds one to
    ``dict_match_bsearch_cuda.launches`` and to ``.instances[instance]``
    (the instance the launch took) per launch."""
    from repro_torch.kernels import build  # lazy: builds at first launch
    from repro_torch.kernels import stem_fused as sf

    _check_blocks(block_n)
    keys, dev = _check_match_args(keys, dict_keys)
    n = keys.shape[0]
    out = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return out
    r = dict_keys.shape[0]
    rp = sorted_padded(r)           # the kernel reads the padding
    if keys.data_ptr() % 16:        # it reads keys 16 B at a time
        keys = keys.clone()
    lib = build.dict_match_library()
    with torch.cuda.device(dev):
        err = lib.dict_match_bsearch_launch(
            keys.data_ptr(), n, dict_keys.data_ptr(), r, rp, out.data_ptr(),
            sf._cuda_stream(dev))
    sf._raise_on(err, lib, "dict_match_bsearch")
    dict_match_bsearch_cuda.launches += 1
    dict_match_bsearch_cuda.instances[_last_bsearch_instance(lib)] += 1
    return out


CUDA_WRAPPERS = (dict_match_cuda, dict_match_bsearch_cuda)
for _wrapper in CUDA_WRAPPERS:
    _wrapper.launches = 0
dict_match_bsearch_cuda.instances = dict.fromkeys(BSEARCH_INSTANCES, 0)

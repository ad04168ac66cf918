"""The inverted-index postings reduction (K5) and its global half.

The counterpart of ``repro.kernels.postings``. Per ``block_w``-word tile
(a power of two) of root ids, the tile's root histogram and each word's
stable rank within its root: the number of earlier words of the tile with
its id. Invalid words carry the drop bucket ``id == n_roots``.
:func:`finish_postings` then turns histograms and ranks into the CSR
postings with exclusive cumsums, one gather and two masked scatters, in
plain PyTorch, as the reference does it outside its kernel.

  postings_plain  the plain PyTorch version, the reference's route: a
                  per-tile ``torch.sort`` of the composite keys ``id *
                  block_w + lane``, ``searchsorted`` at the bucket starts
                  ``r * block_w`` and a diff; the CPU path and the
                  yardstick on the card
  postings_cuda   the CUDA kernel, ``csrc/postings.cu`` with the tile steps
                  in ``csrc/postings.cuh`` (replaces
                  ``repro/kernels/postings.py:92``, ``_postings_kernel``),
                  three instances picked by shape alone (:func:`_instance`):
                  "counting" counts the ids warp by warp in shared-memory
                  counters (ranks in lane order, three barriers a tile, no
                  sort); "sliced", for counters that do not fit one
                  block's shared memory, runs the same count in one block
                  per (tile, slice of SLICE_COUNTERS / warps bins), each
                  block counting only its slice's ids (counting is its
                  one-slice case); "bitonic", for tiles past
                  COUNT_MAX_BLOCK_W, sorts the composite keys with a
                  bitonic network in shared memory (in a global-memory
                  scratch row past MAX_BLOCK_W) and bisects them

:func:`postings` takes the plain version for a CPU tensor only; a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.textnorm import scatter_rows
from repro_torch.kernels.stem_fused import (SMEM_BLOCK_BYTES, _check_cuda,
                                            _cuda_stream, _raise_on)

# int32 composite keys: id * block_w + lane must not overflow.
MAX_COMPOSITE = 1 << 31
# The largest pow2 tile whose keys (4 B each) the bitonic instance sorts in
# one block's shared memory; wider tiles sort in a global-memory scratch row.
MAX_BLOCK_W = 1 << ((SMEM_BLOCK_BYTES // 4).bit_length() - 1)
# The counting instances (postings.cuh): a warp per COUNT_LANES_PER_WARP
# lanes, at most 32 warps, uint16 counters [warps][bins] and a bitmap of
# the bins' quads in shared memory: the whole row of n_roots + 1 bins
# rounded up to 8 ("counting") or, where that does not fit,
# SLICE_COUNTERS / warps bins a block ("sliced").
COUNT_LANES_PER_WARP = 256
COUNT_MAX_BLOCK_W = 32 * COUNT_LANES_PER_WARP
SLICE_COUNTERS = 32768


def _instance(n_roots: int, block_w: int) -> str:
    """The K5 instance a launch takes, by shape alone (the C side's
    ``postings_instance``): ``"bitonic"`` past COUNT_MAX_BLOCK_W, else
    ``"counting"`` while its counters fit one block's shared memory, else
    ``"sliced"``."""
    if block_w > COUNT_MAX_BLOCK_W:
        return "bitonic"
    bins = -(-(n_roots + 1) // 8) * 8
    # uint16 counters a warp and a bitmap of 4-bin quads (postings.cuh)
    smem = 2 * _count_warps(block_w) * bins + 4 * -(-bins // 128)
    return "counting" if smem <= SMEM_BLOCK_BYTES else "sliced"


def _count_warps(block_w: int) -> int:
    return max(1, block_w // COUNT_LANES_PER_WARP)


def slices(n_roots: int, block_w: int) -> tuple[int, int]:
    """-> (bins a block counts, slices a tile) of a counting or sliced
    launch (postings.cuh's ``slice_bins`` and ``slice_count``)."""
    n_roots_pad = n_roots + 1
    if _instance(n_roots, block_w) == "counting":
        return -(-n_roots_pad // 8) * 8, 1
    bins = SLICE_COUNTERS // _count_warps(block_w)
    return bins, -(-n_roots_pad // bins)


def check_block_w(block_w: int, n_roots: int) -> None:
    """The reference's guards: a power of two, and composite keys that fit
    int32."""
    if block_w < 1 or block_w & (block_w - 1):
        raise ValueError(f"block_w must be a power of two, got {block_w}")
    n_roots_pad = n_roots + 1                  # +1: the drop bucket
    if n_roots_pad * block_w >= MAX_COMPOSITE:
        raise ValueError(
            f"composite sort keys overflow int32: ({n_roots} roots + drop)"
            f" * block_w {block_w} >= 2^31 — lower block_w")


def pad_ids(ids: torch.Tensor, *, n_roots: int, block_w: int) -> torch.Tensor:
    """ids int32[W] -> int32[n_tiles, block_w], padded with the drop id."""
    ids = ids.to(torch.int32).reshape(-1)
    pad = (-ids.shape[0]) % block_w
    if pad:
        ids = torch.cat([ids, ids.new_full((pad,), n_roots)])
    return ids.reshape(-1, block_w).contiguous()


def postings_plain(tiles: torch.Tensor, *, n_roots: int, block_w: int):
    """K5's plain PyTorch version, on any device: padded ids int32[n_tiles,
    block_w] -> (hist int32[n_tiles, n_roots + 1], rank int32[n_tiles *
    block_w])."""
    n_tiles = tiles.shape[0]
    dev = tiles.device
    lane = torch.arange(block_w, dtype=torch.int64, device=dev)
    keys = tiles.to(torch.int64) * block_w + lane
    skeys = torch.sort(keys, dim=1).values
    bounds = torch.searchsorted(
        skeys, (torch.arange(n_roots + 2, dtype=torch.int64, device=dev)
                * block_w).expand(n_tiles, -1).contiguous())
    hist = (bounds[:, 1:] - bounds[:, :-1]).to(torch.int32)
    pos = torch.searchsorted(skeys, keys)
    seg = torch.searchsorted(skeys, tiles.to(torch.int64) * block_w)
    return hist, (pos - seg).to(torch.int32).reshape(-1)


def postings_cuda(tiles: torch.Tensor, *, n_roots: int, block_w: int):
    """Launch K5 (``csrc/postings.cu``) on the current stream: same
    contract as :func:`postings_plain`, for CUDA tensors. Adds one to
    ``postings_cuda.launches`` and to
    ``postings_cuda.instances[_instance(n_roots, block_w)]`` per launch."""
    from repro_torch.kernels import build  # lazy: builds at first launch

    dev = tiles.device
    _check_cuda("ids", tiles, 2, dev, align=4)
    check_block_w(block_w, n_roots)
    if tiles.shape[1] != block_w:
        raise ValueError(f"ids {tuple(tiles.shape)} are not tiles of"
                         f" block_w={block_w}")
    n_tiles = tiles.shape[0]
    hist = torch.empty((n_tiles, n_roots + 1), dtype=torch.int32, device=dev)
    rank = torch.empty((n_tiles * block_w,), dtype=torch.int32, device=dev)
    if n_tiles == 0:
        return hist, rank
    instance = _instance(n_roots, block_w)
    # bitonic tiles past MAX_BLOCK_W sort in a scratch row each
    wide = instance == "bitonic" and block_w > MAX_BLOCK_W
    scratch = torch.empty(tiles.shape if wide else (0,), dtype=torch.int32,
                          device=dev)
    lib = build.postings_library()
    with torch.cuda.device(dev):
        err = lib.postings_launch(tiles.data_ptr(), n_tiles, block_w,
                                  n_roots + 1, hist.data_ptr(),
                                  rank.data_ptr(),
                                  scratch.data_ptr() if scratch.numel()
                                  else None, SMEM_BLOCK_BYTES,
                                  _cuda_stream(dev))
    _raise_on(err, lib, "postings")
    postings_cuda.launches += 1
    postings_cuda.instances[instance] += 1
    return hist, rank


postings_cuda.launches = 0
postings_cuda.instances = {"counting": 0, "sliced": 0, "bitonic": 0}
CUDA_WRAPPERS = (postings_cuda,)


def postings(ids: torch.Tensor, *, n_roots: int, block_w: int = 2048):
    """Tile-local postings reduction: root ids -> (hist, rank).

    ids int32[W] in [0, n_roots] (n_roots marks the drop bucket) ->
      hist int32[n_tiles, n_roots + 1]  per-tile root histogram
      rank int32[W_pad]                 stable rank within (tile, root)

    W pads up to a ``block_w`` multiple with drop-bucket ids. A CUDA
    tensor launches K5 (one launch, none for W = 0) or raises; a CPU
    tensor runs the plain version. Combine across tiles with
    :func:`finish_postings`.
    """
    check_block_w(block_w, n_roots)
    tiles = pad_ids(ids, n_roots=n_roots, block_w=block_w)
    if ids.device.type == "cuda":
        return postings_cuda(tiles, n_roots=n_roots, block_w=block_w)
    if ids.device.type != "cpu":
        raise ValueError(f"no postings path for device {ids.device}")
    return postings_plain(tiles, n_roots=n_roots, block_w=block_w)


def finish_postings(hist, rank, ids, doc_ids, positions, *, n_roots: int,
                    block_w: int):
    """Global half of the reduction: cumsums + the postings scatter.

    hist int32[n_tiles, n_roots+1], rank int32[W_pad] from :func:`postings`
    over consecutive word tiles; ids int32[W], doc_ids/positions int32[W]
    aligned with it -> ``(counts int32[n_roots], docs int32[W_pad],
    poss int32[W_pad], n_postings int32[])``: root r's postings occupy
    ``[offsets[r], offsets[r] + counts[r])`` with ``offsets =
    exclusive_cumsum(counts)``, sorted by global word index; entries at
    and past ``n_postings`` are zero. No host sync.
    """
    w = ids.shape[0]
    w_pad = rank.shape[0]
    dev = rank.device
    # per-(tile, root) base: how many of root r landed in earlier tiles
    tile_base = torch.cumsum(hist, dim=0, dtype=torch.int32) - hist
    counts = hist.sum(dim=0, dtype=torch.int32)[:n_roots]
    offsets = torch.cumsum(counts, dim=0, dtype=torch.int32) - counts
    n_postings = counts.sum(dtype=torch.int32)

    tile_of = torch.arange(w, device=dev) // block_w
    safe_ids = torch.clamp(ids.to(torch.int64), max=n_roots)
    starts = torch.cat([offsets, n_postings[None]])
    base = starts[safe_ids] + tile_base[tile_of, safe_ids] + rank[:w]
    # the drop bucket -> the spare row
    dest = torch.where(safe_ids < n_roots, base.to(torch.int64),
                       torch.full_like(safe_ids, w_pad))
    docs = scatter_rows(w_pad, dest, doc_ids)
    poss = scatter_rows(w_pad, dest, positions)
    return counts, docs, poss, n_postings

"""Public entry points of the port's kernels.

The counterpart of ``repro.kernels.ops`` for the main path: the stemmer
megakernels (:func:`extract_roots_fused`), the persistent serving kernel
(:func:`extract_roots_persistent`), their launch counter, and the
per-tile integrity checksum the serving ring verifies at retire.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.core import stemmer as core_stemmer
from repro_torch.kernels import stem_fused as sf


# -- dispatch accounting -----------------------------------------------------
def reset_dispatch_count() -> None:
    """Zero the launch counters of every stemmer kernel (K1, K2, K3)."""
    for wrapper in sf.CUDA_WRAPPERS:
        wrapper.launches = 0


def dispatch_count() -> int:
    """CUDA stemmer-kernel launches (K1, K2 and both K3 variants) since the
    last :func:`reset_dispatch_count`. Only real kernel launches count:
    the plain versions that run on the CPU launch nothing."""
    return sum(wrapper.launches for wrapper in sf.CUDA_WRAPPERS)


def _on_device(roots, dev: torch.device):
    """The dictionary (arrays or resolved handle) with its tables on dev."""
    if isinstance(roots, core_stemmer.ResolvedRootDict):
        if roots.arrays.device == dev:
            return roots
        tiles = roots.tiles.to(dev) if roots.tiles is not None else None
        return core_stemmer.ResolvedRootDict(roots.arrays.to(dev),
                                             roots.residency, tiles)
    return roots.to(dev)


def _launch(words, roots, *, block_b: int, with_checksum: bool, device,
            **kw):
    dev = devmod.resolve(device)
    words = devmod.as_int32(words, dev)
    if with_checksum and words.shape[0] % block_b:
        raise ValueError(f"with_checksum needs B ({words.shape[0]}) to be a"
                         f" multiple of block_b ({block_b})")
    out = sf.stem_fused(words, _on_device(roots, dev), block_b=block_b, **kw)
    if with_checksum:
        return out + (tile_checksum(out[0], out[1], block_b=block_b),)
    return out


def extract_roots_fused(words, roots, *, infix: bool = True,
                        match: str = "bsearch", block_b: int = 256,
                        residency: str = "auto", dict_block_r: int = 8,
                        num_buffers: int = 2, skip_index: bool = True,
                        visit_budget: int | None = None,
                        with_checksum: bool = False,
                        device=devmod.DEFAULT_DEVICE):
    """The stemmer megakernels on ``device``: all five stages, resident (K1)
    or streamed (K2) as ``residency`` resolves. Same contract as
    ``core.stemmer.extract_roots``; bit-identical output.

    words int32[B,16] (numpy or tensor) and RootDictArrays or a resolved
    handle -> (root int32[B,4], source int32[B]) on ``device``. Streamed
    batches whose visit table would exceed ``visit_budget`` entries chunk
    into several launches (``stem_fused.planned_launches``).
    ``with_checksum=True`` adds the per-tile :func:`tile_checksum` row,
    computed on the same stream right after the launch (B must be a
    multiple of block_b).
    """
    return _launch(words, roots, infix=infix, match=match, block_b=block_b,
                   residency=residency, dict_block_r=dict_block_r,
                   num_buffers=num_buffers, skip_index=skip_index,
                   visit_budget=visit_budget, with_checksum=with_checksum,
                   device=device)


def extract_roots_persistent(words, roots, *, infix: bool = True,
                             match: str = "bsearch", block_b: int = 256,
                             residency: str = "auto", dict_block_r: int = 8,
                             num_buffers: int = 2, skip_index: bool = True,
                             version_slot: int = 0,
                             visit_budget: int | None = None,
                             with_checksum: bool = False,
                             device=devmod.DEFAULT_DEVICE):
    """The persistent serving kernel (K3) on ``device``: one launch (one a
    chunk, streamed) walks a descriptor ring of the batch's tiles. Returns
    ``(root, source, flags)``: flags int32[batch_tiles] is ``1 +
    version_slot`` for every retired descriptor, the completion word the
    serving ring checks. Roots and sources are bit-identical to
    :func:`extract_roots_fused`; ``with_checksum=True`` appends the
    :func:`tile_checksum` row.
    """
    return _launch(words, roots, infix=infix, match=match, block_b=block_b,
                   residency=residency, dict_block_r=dict_block_r,
                   num_buffers=num_buffers, skip_index=skip_index,
                   persistent=True, version_slot=version_slot,
                   visit_budget=visit_budget, with_checksum=with_checksum,
                   device=device)


# ---------------------------------------------------------------------------
# Retire-side integrity: a device-computed checksum row per block_b tile
# ---------------------------------------------------------------------------
# odd int32 weights; the position term makes the fold order-sensitive
# inside a tile, so swapped rows are detected, not just flipped values
_CS_WEIGHTS = (1000003, 999983, 65599, 31337, 271829, 69069)
_CS_ROOT_W = np.array(_CS_WEIGHTS[:4], np.int32)
_CS_SRC_W = np.int32(_CS_WEIGHTS[4])


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 it is congruent to mod 2**32 (two's complement)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def tile_checksum(roots: torch.Tensor, sources: torch.Tensor, *,
                  block_b: int) -> torch.Tensor:
    """Per-tile int32 checksum over a launch's (roots, sources) outputs.

    roots int32[rows, 4], sources int32[rows], rows a multiple of block_b
    -> int32[rows // block_b], with the int32 wraparound arithmetic of the
    reference. PyTorch promotes int32 sums to int64 and has no int32
    matmul on CUDA, so the five weighted terms are written out in int64,
    each row is wrapped to int32, the tile sums are taken in int64 and
    wrapped again: exact for any int32 inputs.
    """
    rows = roots.shape[0]
    if rows % block_b:
        raise ValueError(f"rows ({rows}) must be a multiple of block_b"
                         f" ({block_b})")
    w = _CS_WEIGHTS
    r = roots.to(torch.int64)
    s = sources.reshape(-1).to(torch.int64)
    idx = torch.arange(rows, dtype=torch.int64, device=roots.device) % block_b
    row = (r[:, 0] * w[0] + r[:, 1] * w[1] + r[:, 2] * w[2]
           + r[:, 3] * w[3] + s * w[4] + idx * w[5] + 1)
    tiles = _wrap_int32(row).reshape(-1, block_b).sum(dim=1)
    return _wrap_int32(tiles).to(torch.int32)


def tile_checksum_host(roots, sources, *, block_b: int) -> np.ndarray:
    """Numpy mirror of :func:`tile_checksum` (int32 wraparound math; the
    matmul and sum force dtype=int32, numpy would otherwise widen)."""
    r = np.asarray(roots).astype(np.int32, copy=False)
    s = np.asarray(sources).astype(np.int32, copy=False).reshape(-1)
    idx = (np.arange(r.shape[0], dtype=np.int32) % block_b).astype(np.int32)
    row = r @ _CS_ROOT_W + s * _CS_SRC_W
    row += idx * np.int32(_CS_WEIGHTS[5]) + np.int32(1)
    return row.reshape(-1, block_b).sum(axis=1, dtype=np.int32)

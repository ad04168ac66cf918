"""Public entry points of the port's kernels.

The counterpart of ``repro.kernels.ops`` for the main path: the stemmer
megakernel (:func:`extract_roots_fused`), its launch counter, and the
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
    """Zero the stemmer-megakernel launch counter."""
    sf.stem_fused_cuda.launches = 0


def dispatch_count() -> int:
    """CUDA stemmer-megakernel launches since the last
    :func:`reset_dispatch_count`. Only real kernel launches count: the
    plain version that runs on the CPU launches nothing."""
    return sf.stem_fused_cuda.launches


def _on_device(roots, dev: torch.device):
    """The dictionary (arrays or resolved handle) with its tables on dev."""
    if isinstance(roots, core_stemmer.ResolvedRootDict):
        if roots.arrays.device == dev:
            return roots
        return core_stemmer.ResolvedRootDict(roots.arrays.to(dev),
                                             roots.residency)
    return roots.to(dev)


def extract_roots_fused(words, roots, *, infix: bool = True,
                        match: str = "bsearch", block_b: int = 256,
                        residency: str = "auto", with_checksum: bool = False,
                        device=devmod.DEFAULT_DEVICE):
    """The stemmer megakernel on ``device``: all five stages in one launch.
    Same contract as ``core.stemmer.extract_roots``; bit-identical output.

    words int32[B,16] (numpy or tensor) and RootDictArrays or a resolved
    handle -> (root int32[B,4], source int32[B]) on ``device``.
    ``with_checksum=True`` adds the per-tile :func:`tile_checksum` row,
    computed on the same stream right after the launch (B must be a
    multiple of block_b).
    """
    dev = devmod.resolve(device)
    words = devmod.as_int32(words, dev)
    if with_checksum and words.shape[0] % block_b:
        raise ValueError(f"with_checksum needs B ({words.shape[0]}) to be a"
                         f" multiple of block_b ({block_b})")
    root, source = sf.stem_fused(words, _on_device(roots, dev), infix=infix,
                                 match=match, block_b=block_b,
                                 residency=residency)
    if with_checksum:
        return root, source, tile_checksum(root, source, block_b=block_b)
    return root, source


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

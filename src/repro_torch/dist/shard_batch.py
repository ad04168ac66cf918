"""Data-sharded stemmer launches: one batch split across a mesh axis.

The counterpart of ``repro.dist.shard_batch``. Where the reference's
``shard_map`` hands each device a ``[B / n_dev, 16]`` slice of one padded
super-tile, :func:`shard_batch` does the same from one process: it pads
B to a multiple of ``n_dev * block_b``, gives shard i the contiguous rows
``[i * B / n, (i + 1) * B / n)`` on mesh entry i, runs the port's
megakernels there (K1 or K2 by residency; the plain versions on the CPU)
with that entry's copy of the dictionary, copies every shard's roots and
sources back to the first entry, concatenates them and slices back to B.
The checksum row is computed on the merged rows, as the reference's
``_checksum_rows`` is inside its jit scope. Outputs are bit-identical to
``ops.extract_roots_fused`` on one device: each word's root depends on
that word alone.

Each shard is launched under its device's context, on that device's
current stream; the copies onto the first entry are non-blocking, so a
caller syncs once for the merged result. Entries that repeat a device
(``launch.mesh.Mesh.of(["cuda:0"] * 4)``) run their shards one after
another on that device.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch import device as devmod
from repro_torch.core import alphabet as ab
from repro_torch.dist.sharding import axis_devices
from repro_torch.kernels import stem_fused as sf


def device_downshift_ladder(n_dev: int) -> list[int]:
    """Data-device counts the degradation ladder reshards through:
    ``n_dev`` halving down to 1, descending.

    Any count d <= n_dev serves bit-identically (:func:`shard_batch` pads
    each launch to ``d * block_b`` and a word's root depends on that word
    alone), so resharding changes throughput, never results.
    """
    if n_dev < 1:
        raise ValueError(f"n_dev must be >= 1, got {n_dev}")
    out, d = [], n_dev
    while d > 1:
        out.append(d)
        d //= 2
    out.append(1)
    return out


def on_device(dev: torch.device):
    """The context a shard's launches run under: its card's, on a card."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def replica(obj, dev: torch.device, cache: dict):
    """``obj`` (a dictionary, its resolved handle, or a tensor) with its
    tables on ``dev``, copied at most once a device of ``cache``."""
    from repro_torch.kernels import ops  # lazy: ops imports this module

    got = cache.get(dev)
    if got is None:
        if isinstance(obj, torch.Tensor):
            got = obj.to(dev)
        else:
            got = ops._on_device(obj, dev)
        cache[dev] = got
    return got


def pad_rows(words: torch.Tensor, multiple: int) -> torch.Tensor:
    """Zero word rows appended up to a multiple of ``multiple`` (a zero row
    is an empty word: SRC_NONE, the drop bucket)."""
    pad = (-words.shape[0]) % multiple
    if not pad:
        return words
    return torch.cat([words, words.new_zeros((pad,) + tuple(words.shape[1:]))])


def host_words(words) -> torch.Tensor:
    """numpy or tensor words -> a contiguous int32 tensor where they already
    are (a numpy batch on the host), for slicing into shards."""
    t = torch.as_tensor(words)
    t = devmod.as_int32(t, t.device)
    if t.ndim != 2 or t.shape[1] != ab.MAXLEN:
        raise ValueError(f"words must be [B, {ab.MAXLEN}], got"
                         f" {tuple(t.shape)}")
    return t


def map_shards(words, mesh, rows: int, fn) -> tuple:
    """Run ``fn`` on every shard of ``words`` over ``mesh``'s data axis.

    ``words`` (numpy or tensor, [B, 16]) is padded with empty words to a
    multiple of ``n_dev * rows``; shard i, the contiguous rows
    ``[i * B_pad / n, (i + 1) * B_pad / n)``, moves to entry i, and
    ``fn(shard, dev)`` runs there under that device's context and returns
    a tuple of tensors. Each is copied (non-blocking) to the first entry
    and concatenated over the shards in order -> (the first entry, the
    merged tuple). Rows past B stay in the merged outputs: the caller
    slices them off.
    """
    devs = axis_devices(mesh, "data")
    home = devs[0]
    wp = pad_rows(host_words(words), len(devs) * rows)
    per = wp.shape[0] // len(devs)
    parts = []
    for i, dev in enumerate(devs):
        with on_device(dev):
            out = fn(wp[i * per:(i + 1) * per].to(dev, non_blocking=True), dev)
            parts.append([t.to(home, non_blocking=True) for t in out])
    with on_device(home):
        return home, tuple(torch.cat(ts) for ts in zip(*parts))


def shard_batch(words, roots, mesh, *, infix: bool = True,
                match: str = "bsearch", block_b: int = 256,
                residency: str = "auto", dict_block_r: int = 8,
                num_buffers: int = 2, skip_index: bool = True,
                visit_budget: int | None = None, with_checksum: bool = False,
                replicas: dict | None = None):
    """words int32[B, 16] -> (root int32[B, 4], source int32[B]) on the
    mesh's first entry, B split over the mesh's ``data`` axis.

    The same contract as ``ops.extract_roots_fused``, megabatches included:
    each shard runs the whole grid over its ``B / n_dev`` rows (chunked
    against ``visit_budget`` on the streamed path), so one sharded call
    launches ``n_dev * stem_fused.planned_launches(B / n_dev)`` kernels.
    ``roots`` is a RootDictArrays or a resolved handle (its pinned
    residency and tile set travel with it). ``replicas`` maps a device to
    the dictionary's copy there: pass one dict a dictionary version to keep
    the copies across calls (the serving ring does); without it each call
    copies once a distinct device. ``with_checksum=True`` appends
    ``ops.tile_checksum`` of the merged rows (B a multiple of block_b).
    ``ops.extract_roots_sharded`` is this function.
    """
    from repro_torch.kernels import ops  # lazy: ops imports this module

    words = host_words(words)
    b = words.shape[0]
    if with_checksum and b % block_b:
        raise ValueError(f"with_checksum needs B ({b}) to be a multiple of"
                         f" block_b ({block_b})")
    cache = {} if replicas is None else replicas

    def stem(shard, dev):
        return sf.stem_fused(shard, replica(roots, dev, cache), infix=infix,
                             match=match, block_b=block_b,
                             residency=residency, dict_block_r=dict_block_r,
                             num_buffers=num_buffers, skip_index=skip_index,
                             visit_budget=visit_budget)

    if b == 0:
        home = axis_devices(mesh, "data")[0]
        root = torch.zeros((0, 4), dtype=torch.int32, device=home)
        source = torch.zeros((0,), dtype=torch.int32, device=home)
    else:
        home, (root, source) = map_shards(words, mesh, block_b, stem)
        root, source = root[:b], source[:b]
    if with_checksum:
        with on_device(home):
            return root, source, ops.tile_checksum(root, source,
                                                   block_b=block_b)
    return root, source

"""Versioned root-dictionary store for serving-time lexicon hot swaps.

The counterpart of ``repro.serve.dict_store.DictStore`` (publish,
acquire, get, version and two-phase validation):

  publish(arrays)  upload a new dictionary to the store's device, once,
                   as the next monotonically increasing version; it
                   becomes current atomically and is picked up by the
                   *next* tile launch
  acquire()        snapshot the current version; a dispatch holds its
                   snapshot for the whole launch (and through retire), so
                   a concurrent publish never changes — or relabels — a
                   tile in flight

Each version wraps its tables in a ``core.stemmer.ResolvedRootDict``
whose residency is resolved once at publish time (``residency``,
``infix``); a streamed version with ``dict_block_r`` set also gets its
tile stream prebuilt then, and a resident one caches the kernels' padded
table layout, so launches never re-pad or re-upload. Publishes are
two-phase: phase 1 validates the layout every kernel path assumes (1-D
int32 tables of strictly sorted unique packed 24-bit keys, or the single
``[-1]`` empty-table placeholder; a prebuilt tile set of the right shape
whose boundary tables are its tiles' first and last entries and whose
fence level is every F-th entry of each table's tiles) and raises
:class:`DictValidationError` with the store untouched; phase 2 is the
atomic version bump.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.core import pyref
from repro_torch.core import stemmer as core_stemmer

TABLES = ("tri", "quad", "bi")


class DictValidationError(ValueError):
    """A publish failed phase-1 layout validation; nothing was installed."""


def _validate_table(name: str, t: torch.Tensor) -> None:
    if t.dim() != 1 or t.dtype != torch.int32:
        raise DictValidationError(
            f"{name}: expected 1-D int32 table, got shape {tuple(t.shape)}"
            f" dtype {t.dtype}")
    a = t.cpu().numpy()
    if a.size == 0:
        raise DictValidationError(
            f"{name}: empty table must be the [-1] sentinel, not size 0")
    if a.size == 1 and a[0] == -1:
        return                          # the empty-table sentinel
    if int(a.min()) < 0:
        raise DictValidationError(
            f"{name}: negative key {int(a.min())} (the -1 sentinel is only"
            " legal as a whole single-element table)")
    if int(a.max()) >= (1 << 24):
        raise DictValidationError(
            f"{name}: key {int(a.max())} outside the packed 24-bit range")
    d = np.diff(a)
    if d.size and int(d.min()) <= 0:
        at = int(np.argmin(d))
        raise DictValidationError(
            f"{name}: not strictly sorted/unique at index {at}"
            f" ({int(a[at])} -> {int(a[at + 1])})")


def validate_handle(handle: core_stemmer.ResolvedRootDict) -> None:
    """Phase-1 publish validation: binary search and the bank both break
    silently on tables that are not sorted unique packed keys, and the
    streamed search on a tile stream whose tiles are unsorted, whose
    boundary tables are not the tiles' first and last entries, or whose
    fences are not every F-th entry of each table's tiles."""
    from repro_torch.kernels import stem_match as sm  # lazy: kernels need core

    for name in TABLES:
        _validate_table(name, getattr(handle.arrays, name))
    tiles = handle.tiles
    if tiles is None:
        return
    stream = tiles.stream.cpu().numpy()
    n_tiles = sum(tiles.counts)
    if stream.shape != (n_tiles * tiles.dict_block_r, sm.LANE):
        raise DictValidationError(
            f"tile stream shape {stream.shape} != "
            f"({n_tiles} tiles x {tiles.dict_block_r} rows, {sm.LANE})")
    flat = stream.reshape(n_tiles, -1)
    if np.diff(flat, axis=1).min(initial=0) < 0:
        raise DictValidationError(
            "tile stream has an internally unsorted tile (sentinel"
            " padding must keep every tile ascending)")
    mins, maxs = tiles.mins.cpu().numpy(), tiles.maxs.cpu().numpy()
    if (mins.shape != (n_tiles,) or maxs.shape != (n_tiles,)
            or not np.array_equal(mins, flat[:, 0])
            or not np.array_equal(maxs, flat[:, -1])):
        raise DictValidationError(
            "tile boundary tables diverge from the tile stream's"
            " first/last lanes")
    step, tile_n = tiles.fence_step, tiles.dict_block_r * sm.LANE
    fences = tiles.fences.cpu().numpy()
    want = sm.build_fences(torch.from_numpy(stream), tiles.counts, tile_n,
                           max(1, step)).numpy()
    if (step < sm.FENCE_MIN_STEP or step & (step - 1)
            or not np.array_equal(fences, want)):
        raise DictValidationError(
            f"fence level ({fences.size} fences at step {step}) diverges"
            " from every F-th entry of each table's tiles (F a power of"
            f" two >= {sm.FENCE_MIN_STEP})")


@dataclass(frozen=True)
class DictVersion:
    """One published dictionary: immutable (version, resolved handle)."""

    version: int
    handle: core_stemmer.ResolvedRootDict

    @property
    def arrays(self) -> core_stemmer.RootDictArrays:
        return self.handle.arrays


class DictStore:
    """Versioned RootDictArrays with publish/acquire semantics.

    Versions start at 0 (the constructor publishes the initial
    dictionary) and only ever grow; every version stays retrievable
    through :meth:`get`. ``residency`` ("auto" resolves per version),
    ``infix`` (which tables count toward the resident budget) and
    ``dict_block_r`` (prebuild the streamed tile stream at publish time)
    apply to every publish.
    """

    def __init__(self, arrays, *, residency: str = "auto", infix: bool = True,
                 dict_block_r: int | None = None,
                 device=devmod.DEFAULT_DEVICE):
        self._lock = threading.Lock()       # guards the version table
        self._pub_lock = threading.Lock()   # serialises publishers
        self.device = devmod.resolve(device)
        self._residency = residency
        self._infix = infix
        self._dict_block_r = dict_block_r
        self._versions: dict[int, DictVersion] = {}
        self._current: DictVersion | None = None
        self._next_version = 0
        self.publish(arrays)

    def _install(self, handle: core_stemmer.ResolvedRootDict) -> int:
        with self._lock:
            version = self._next_version
            self._next_version += 1
            dv = DictVersion(version, handle)
            self._versions[version] = dv
            self._current = dv
        return version

    def publish(self, arrays) -> int:
        """Upload a new lexicon; returns its version number.

        Accepts packed RootDictArrays (or an already-resolved handle) or
        a raw pyref.RootDict, which is packed here. The tables move to the
        store's device once, here. Two-phase: DictValidationError leaves
        the store untouched; otherwise the new version becomes current
        atomically while in-flight launches keep the snapshot they
        acquired.
        """
        with self._pub_lock:
            if isinstance(arrays, pyref.RootDict):
                arrays = core_stemmer.RootDictArrays.from_rootdict(
                    arrays, device=self.device)
            if isinstance(arrays, core_stemmer.ResolvedRootDict):
                arrays = arrays.arrays
            handle = core_stemmer.resolve_dict(
                arrays.to(self.device), residency=self._residency,
                infix=self._infix, dict_block_r=self._dict_block_r)
            validate_handle(handle)
            return self._install(handle)

    def acquire(self) -> DictVersion:
        """Snapshot the current version (hold it for a whole tile launch)."""
        with self._lock:
            return self._current

    def get(self, version: int) -> DictVersion:
        """Resolve a previously published version (audit / parity checks)."""
        with self._lock:
            try:
                return self._versions[version]
            except KeyError:
                raise KeyError(
                    f"dict version {version} not in store (published so far:"
                    f" {self._next_version})") from None

    @property
    def version(self) -> int:
        """Version number of the current dictionary."""
        with self._lock:
            return self._current.version

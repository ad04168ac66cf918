"""Versioned root-dictionary store for serving-time lexicon hot swaps.

The counterpart of ``repro.serve.dict_store.DictStore``:

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
atomic version bump. A ``FaultInjector`` given at construction can reject
between the phases (site ``publish``), proving no partial state lands.

Beyond ``publish``: ``publish_delta`` merges insert/remove key lists into
the current version (untouched tables keep their device tensors),
``rollback(v)`` re-installs a kept version's handle as a NEW version,
``keep_history=False`` drops superseded versions (and their device
tables), and ``snapshot``/``restore`` persist the version catalog as an
npz with the reference's keys, metadata JSON and per-table sha16 hashes,
so either package restores the other's snapshot.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.core import alphabet as ab
from repro_torch.core import pyref
from repro_torch.core import stemmer as core_stemmer

TABLES = ("tri", "quad", "bi")


class DictValidationError(ValueError):
    """A publish failed phase-1 layout validation; nothing was installed."""


class DictSnapshotError(RuntimeError):
    """A catalog snapshot failed its content-hash verification."""


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


def _sorted_member(haystack: np.ndarray, needles: np.ndarray) -> np.ndarray:
    """Membership of sorted ``needles`` in sorted ``haystack`` via one
    searchsorted pass (no re-sort, unlike np.isin/setdiff1d)."""
    if not haystack.size:
        return np.zeros(needles.shape, bool)
    at = np.minimum(np.searchsorted(haystack, needles), haystack.size - 1)
    return haystack[at] == needles


def _delta_keys(spec) -> np.ndarray:
    """Delta key list -> sorted unique packed int32 keys. Raw root
    strings encode through the alphabet; packed ints pass through."""
    if spec is None:
        return np.zeros(0, np.int32)
    keys = [ab.pack_key(ab.encode_word(k)) if isinstance(k, str) else int(k)
            for k in spec]
    return np.unique(np.asarray(keys, np.int32)) if keys else np.zeros(0, np.int32)


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
    dictionary) and only ever grow. ``keep_history=False`` drops
    superseded versions on publish (their device tables with them) for
    long-lived servers that need no ``get()`` on old versions.
    ``residency`` ("auto" resolves per version), ``infix`` (which tables
    count toward the resident budget) and ``dict_block_r`` (prebuild the
    streamed tile stream at publish time) apply to every publish.
    """

    def __init__(self, arrays, *, residency: str = "auto",
                 keep_history: bool = True, infix: bool = True,
                 dict_block_r: int | None = None, injector=None,
                 device=devmod.DEFAULT_DEVICE):
        self._lock = threading.Lock()       # guards the version table
        self._pub_lock = threading.Lock()   # serialises publishers
        self.device = devmod.resolve(device)
        self._residency = residency
        self._infix = infix
        self._dict_block_r = dict_block_r
        self._keep_history = keep_history
        self._versions: dict[int, DictVersion] = {}
        self._current: DictVersion | None = None
        self._next_version = 0
        self._injector = None
        self.publish(arrays)                # the seed is never injected:
        self._injector = injector           # a store must construct usable

    def _install(self, handle: core_stemmer.ResolvedRootDict) -> int:
        with self._lock:
            version = self._next_version
            self._next_version += 1
            dv = DictVersion(version, handle)
            if not self._keep_history:
                self._versions.clear()
            self._versions[version] = dv
            self._current = dv
        return version

    def _resolve(self, arrays) -> core_stemmer.ResolvedRootDict:
        return core_stemmer.resolve_dict(
            arrays.to(self.device), residency=self._residency,
            infix=self._infix, dict_block_r=self._dict_block_r)

    def _prepare(self, handle) -> core_stemmer.ResolvedRootDict:
        """Phase 1 of a publish: validate + (optionally) inject. No store
        state changes here: a raise leaves the current version serving."""
        validate_handle(handle)
        if self._injector is not None:
            self._injector.on_publish()
        return handle

    def publish(self, arrays, *, validate: bool = True) -> int:
        """Upload a new lexicon; returns its version number.

        Accepts packed RootDictArrays (or an already-resolved handle) or
        a raw pyref.RootDict, which is packed here. The tables move to the
        store's device once, here. Two-phase: DictValidationError (or an
        injected rejection) leaves the store untouched; otherwise the new
        version becomes current atomically while in-flight launches keep
        the snapshot they acquired. ``validate=False`` skips phase 1 for
        trusted bulk republishes.
        """
        with self._pub_lock:
            if isinstance(arrays, pyref.RootDict):
                arrays = core_stemmer.RootDictArrays.from_rootdict(
                    arrays, device=self.device)
            if isinstance(arrays, core_stemmer.ResolvedRootDict):
                arrays = arrays.arrays
            handle = self._resolve(arrays)
            if validate:
                self._prepare(handle)
            return self._install(handle)

    def rollback(self, version: int) -> int:
        """Re-install a previously published version's handle as a NEW
        monotone version; returns the new version number.

        Versions never move backwards (in-flight tiles keep the version
        they pinned), but the next dispatch acquires the restored lexicon.
        Needs the version kept (``keep_history=True``); KeyError otherwise.
        """
        with self._pub_lock:
            dv = self.get(version)
            return self._install(dv.handle)

    def publish_delta(self, insert=None, remove=None) -> int:
        """Publish the next version as a sorted-merge delta against the
        current one; returns the new version number.

        ``insert`` / ``remove`` map table names ("tri" / "quad" / "bi")
        to key lists: packed int32 keys or raw root strings. Only the
        touched tables are merged on the host and uploaded; untouched
        tables keep the current version's device tensors. Removing an
        absent key raises ValueError, as does a key in both lists for one
        table; inserting a present key is idempotent.
        """
        insert = dict(insert or {})
        remove = dict(remove or {})
        unknown = (set(insert) | set(remove)) - set(TABLES)
        if unknown:
            raise ValueError(f"unknown dictionary tables: {sorted(unknown)}"
                             f" (want subset of {TABLES})")
        with self._pub_lock:
            cur = self.acquire().arrays
            merged = {}
            for name in TABLES:
                ins = _delta_keys(insert.get(name))
                rem = _delta_keys(remove.get(name))
                old = getattr(cur, name)
                if not ins.size and not rem.size:
                    merged[name] = old      # untouched: same device tensor
                    continue
                both = np.intersect1d(ins, rem)
                if both.size:
                    raise ValueError(
                        f"{name}: keys {both.tolist()} appear in both"
                        " insert and remove")
                host = old.cpu().numpy()
                host = host[host >= 0]      # drop the empty-table sentinel
                if rem.size:
                    found = _sorted_member(host, rem)
                    if not found.all():
                        raise ValueError(
                            f"{name}: cannot remove absent keys"
                            f" {rem[~found].tolist()}")
                    keep = np.ones(host.size, bool)
                    keep[np.searchsorted(host, rem)] = False
                    host = host[keep]
                if ins.size:
                    ins = ins[~_sorted_member(host, ins)]  # idempotent
                    host = np.insert(host, np.searchsorted(host, ins), ins)
                out = host.astype(np.int32)
                if not out.size:
                    out = np.asarray([-1], np.int32)  # empty-table sentinel
                merged[name] = torch.from_numpy(out).to(self.device)
            handle = self._resolve(core_stemmer.RootDictArrays(**merged))
            self._prepare(handle)       # two-phase, same as publish()
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
                    f" {self._next_version}, keep_history="
                    f"{self._keep_history})") from None

    @property
    def version(self) -> int:
        """Version number of the current dictionary."""
        with self._lock:
            return self._current.version

    # -- crash safety ------------------------------------------------------
    def snapshot(self, path) -> str:
        """Persist the version catalog (every retained version's packed
        tables plus the current/next counters) as one atomically renamed
        npz; returns the catalog's content hash.

        ``Engine.recover`` re-pins each replayed request to the version it
        was admitted under, which exists after a restart only if the
        catalog was snapshotted. Per-table sha16 hashes ride in the
        metadata and are verified by :meth:`restore`.
        """
        path = str(path)
        with self._lock:
            versions = dict(self._versions)
            current = self._current.version
            next_version = self._next_version
        payload, shas = {}, {}
        for v, dv in versions.items():
            for name in TABLES:
                key = f"v{v}_{name}"
                a = np.ascontiguousarray(
                    getattr(dv.arrays, name).cpu().numpy().astype(np.int32))
                payload[key] = a
                shas[key] = hashlib.sha256(a.tobytes()).hexdigest()[:16]
        meta = {"versions": sorted(versions), "current": current,
                "next_version": next_version, "residency": self._residency,
                "infix": self._infix, "dict_block_r": self._dict_block_r,
                "keep_history": self._keep_history, "sha": shas}
        meta_json = json.dumps(meta, sort_keys=True)
        payload["__meta__"] = np.frombuffer(meta_json.encode(), np.uint8)
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return hashlib.sha256(meta_json.encode()).hexdigest()[:16]

    @classmethod
    def restore(cls, path, *, injector=None,
                device=devmod.DEFAULT_DEVICE) -> "DictStore":
        """Rebuild a store on ``device`` from :meth:`snapshot` (either
        package's). Every retained version is re-resolved at its ORIGINAL
        version number (the constructor would renumber from 0, orphaning
        journal pins); per-table content hashes are verified first,
        raising :class:`DictSnapshotError` on any mismatch."""
        with np.load(str(path)) as z:
            meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
            tables = {k: np.asarray(z[k]) for k in z.files if k != "__meta__"}
        self = cls.__new__(cls)
        self._lock = threading.Lock()
        self._pub_lock = threading.Lock()
        self.device = devmod.resolve(device)
        self._residency = meta["residency"]
        self._infix = meta["infix"]
        self._dict_block_r = meta["dict_block_r"]
        self._keep_history = meta["keep_history"]
        self._versions = {}
        self._current = None
        self._injector = None
        for v in meta["versions"]:
            arrs = {}
            for name in TABLES:
                key = f"v{v}_{name}"
                a = np.ascontiguousarray(tables[key].astype(np.int32))
                got = hashlib.sha256(a.tobytes()).hexdigest()[:16]
                if got != meta["sha"][key]:
                    raise DictSnapshotError(
                        f"snapshot table {key} fails its content hash"
                        f" (want {meta['sha'][key]}, got {got})")
                arrs[name] = torch.from_numpy(a)
            handle = self._resolve(core_stemmer.RootDictArrays(**arrs))
            self._versions[int(v)] = DictVersion(int(v), handle)
        self._current = self._versions[int(meta["current"])]
        self._next_version = int(meta["next_version"])
        self._injector = injector
        return self

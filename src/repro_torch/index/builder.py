"""The chunked corpus-index build: stream -> stemmer kernels -> postings
kernel -> checkpointed partials -> one merged RootIndex.

The counterpart of ``repro.index.builder``. Each corpus chunk is one
``ops.build_root_index`` call: the stemmer kernels chained into the
postings kernel (K5) on the device. The host loop is over chunks only;
per-word work never leaves the device, and the per-chunk partials merge
with vectorised searchsorted/scatter numpy.

Checkpointing: with ``checkpoint_dir`` every completed chunk lands as an
``.npz`` partial plus an atomically rewritten ``manifest.json`` that
records the vocab fingerprint and, per chunk, the word range, the
``DictStore`` version pinned while stemming it, and the sha256 content
hash of the partial file (manifest schema 2, and partials, byte-compatible
with the reference's). Partials are written tmp-then-rename and verified
by readback + hash before the rename, so a torn write never leaves a
renamed-but-corrupt chunk; ``resume=True`` replays the manifest:
completed chunks load from disk after their hash is re-verified, and a
missing, torn or hash-divergent partial is recomputed from its stream
item. Chunk compute and checkpoint writes both retry (``chunk_retries``),
and an ``injector`` (``serve.faults.FaultInjector``) fails chunk computes
(site ``dispatch``) and tears checkpoint writes (site ``checkpoint``) to
drive those retries.
"""
from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass

import numpy as np

from repro_torch import device as devmod
from repro_torch import tracing
from repro_torch.core import alphabet as ab
from repro_torch.core import stemmer as core_stemmer

# schema 2: per-chunk "sha" content hashes (PR 9 checkpoint integrity)
MANIFEST_SCHEMA = 2


def build_vocab(arrays) -> np.ndarray:
    """RootDictArrays -> sorted unique packed 24-bit root keys int32[n].

    The union of the tri/quad/bi tables minus padding sentinels — every
    key the megakernel can emit as a match. Index root ids are positions
    in this array.
    """
    arrays, _, _ = core_stemmer.unwrap_dict(arrays)
    keys = np.unique(np.concatenate([t.cpu().numpy().ravel() for t in
                                     (arrays.tri, arrays.quad, arrays.bi)]))
    return keys[(keys >= 0) & (keys < (1 << 24))].astype(np.int32)


def vocab_fingerprint(vocab: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(vocab).tobytes()) \
        .hexdigest()[:16]


@dataclass(frozen=True)
class IndexPartial:
    """One chunk's device-built index slice (CSR over the chunk)."""

    counts: np.ndarray        # int64[n_roots]
    docs: np.ndarray          # int32[n_postings]
    positions: np.ndarray     # int32[n_postings]

    @property
    def n_postings(self) -> int:
        return int(self.docs.shape[0])


@dataclass(frozen=True)
class RootIndex:
    """The merged inverted index: root r's postings (sorted by global
    word order) sit at ``docs/positions[offsets[r] : offsets[r] +
    counts[r]]``; ``root_keys`` maps r back to its packed key."""

    root_keys: np.ndarray     # int32[n_roots] sorted packed keys
    counts: np.ndarray        # int64[n_roots]
    offsets: np.ndarray       # int64[n_roots] exclusive cumsum
    docs: np.ndarray          # int32[n_postings]
    positions: np.ndarray     # int32[n_postings]
    dict_versions: tuple = () # DictStore version pinned per chunk

    @property
    def n_roots(self) -> int:
        return int(self.root_keys.shape[0])

    @property
    def n_postings(self) -> int:
        return int(self.docs.shape[0])

    def postings_for(self, root) -> tuple[np.ndarray, np.ndarray]:
        """Packed key (or root string, e.g. "كتب") -> (docs, positions)."""
        key = (ab.pack_key(ab.encode_word(root)) if isinstance(root, str)
               else int(root))
        r = int(np.searchsorted(self.root_keys, key))
        if r >= self.n_roots or self.root_keys[r] != key:
            return (np.zeros(0, np.int32), np.zeros(0, np.int32))
        lo, hi = int(self.offsets[r]), int(self.offsets[r] + self.counts[r])
        return self.docs[lo:hi], self.positions[lo:hi]


def merge_partials(partials, root_keys: np.ndarray,
                   dict_versions=()) -> RootIndex:
    """Concatenate per-chunk CSR partials into one RootIndex.

    Chunks cover consecutive word ranges, so within a root the merged
    postings are just each chunk's run back to back — computed with one
    searchsorted + scatter per chunk (vectorised over its postings).
    """
    n_roots = root_keys.shape[0]
    counts = np.zeros(n_roots, np.int64)
    for p in partials:
        counts += p.counts
    offsets = np.cumsum(counts) - counts
    total = int(counts.sum())
    docs = np.zeros(total, np.int32)
    positions = np.zeros(total, np.int32)
    base = np.zeros(n_roots, np.int64)
    for p in partials:
        ends = np.cumsum(p.counts)
        j = np.arange(p.n_postings, dtype=np.int64)
        rid = np.searchsorted(ends, j, side="right")
        dest = offsets[rid] + base[rid] + (j - (ends[rid] - p.counts[rid]))
        docs[dest] = p.docs
        positions[dest] = p.positions
        base += p.counts
    return RootIndex(root_keys=root_keys, counts=counts, offsets=offsets,
                     docs=docs, positions=positions,
                     dict_versions=tuple(dict_versions))


# ---------------------------------------------------------------------------
# checkpoint plumbing
# ---------------------------------------------------------------------------
def _chunk_path(ckpt_dir: str, i: int) -> str:
    return os.path.join(ckpt_dir, f"chunk_{i:06d}.npz")


def _file_sha(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()[:16]


def _write_manifest(ckpt_dir: str, manifest: dict) -> None:
    tmp = os.path.join(ckpt_dir, "manifest.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, os.path.join(ckpt_dir, "manifest.json"))


def _load_manifest(ckpt_dir: str) -> dict | None:
    path = os.path.join(ckpt_dir, "manifest.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _read_partial(path: str) -> IndexPartial:
    with np.load(path) as z:
        return IndexPartial(counts=z["counts"].astype(np.int64),
                            docs=z["docs"], positions=z["positions"])


def _load_partial(ckpt_dir: str, i: int,
                  want_sha: str | None = None) -> IndexPartial | None:
    """Load chunk i if its file exists, parses, and (when the manifest
    carries one) matches the recorded content hash; None otherwise — a
    torn or corrupt partial is a recompute, never an error."""
    path = _chunk_path(ckpt_dir, i)
    if not os.path.exists(path):
        return None
    if want_sha is not None and _file_sha(path) != want_sha:
        return None
    try:
        return _read_partial(path)
    except Exception:
        return None


def _write_partial(ckpt_dir: str, i: int, part: IndexPartial,
                   injector=None, retries: int = 2) -> str:
    """Write chunk i tmp-then-rename with readback verification; returns
    the renamed file's content hash. An injected (or real) torn write is
    caught by the readback and retried up to ``retries`` times."""
    path = _chunk_path(ckpt_dir, i)
    tmp = path + ".tmp"
    last = None
    for _ in range(retries + 1):
        with open(tmp, "wb") as f:
            np.savez(f, counts=part.counts, docs=part.docs,
                     positions=part.positions)
        if injector is not None:
            injector.on_checkpoint(tmp)     # may tear the file
        try:
            got = _read_partial(tmp)
            if (got.n_postings != part.n_postings
                    or not np.array_equal(got.counts, part.counts)):
                raise IOError("readback diverges from the in-memory partial")
        except Exception as e:
            last = e
            continue
        sha = _file_sha(tmp)
        os.replace(tmp, path)
        return sha
    raise IOError(f"chunk {i}: checkpoint write still corrupt after"
                  f" {retries + 1} attempts: {last}")


# ---------------------------------------------------------------------------
# the chunked build
# ---------------------------------------------------------------------------
def build_corpus_index(stream, roots, *, mesh=None, checkpoint_dir=None,
                       resume: bool = False, block_b: int = 2048,
                       block_w: int = 2048, injector=None,
                       chunk_retries: int = 2,
                       device=devmod.DEFAULT_DEVICE,
                       **stem_kw) -> RootIndex:
    """Stream of ``core.corpus.CorpusChunk`` -> merged :class:`RootIndex`,
    built on ``device``.

    ``roots`` is a RootDictArrays, a ResolvedRootDict handle, or a live
    ``serve.DictStore``: with a store, each chunk pins ``store.acquire()``
    for its stemming launch and records the pinned version in the
    checkpoint manifest (the index vocabulary itself is frozen at build
    start, so mid-build publishes change *stemming* but never the id
    space). ``checkpoint_dir`` + ``resume`` give chunk-granular restart
    with bit-identical results; resumed partials are hash-verified and
    recomputed if missing or torn. ``injector`` threads a
    ``serve.faults.FaultInjector`` through the chunk compute (site
    ``dispatch``) and the checkpoint writes (site ``checkpoint``);
    ``chunk_retries`` bounds per-chunk retry of either. ``mesh``
    (``launch.mesh``) shards every chunk over its ``data`` axis
    (``ops.build_root_index(mesh=...)``); ``device`` is then unused.
    """
    from repro_torch.kernels import ops  # lazy: keep index importable light

    with tracing.span("index.build"):
        store = roots if hasattr(roots, "acquire") else None
        pinned = store.acquire().handle if store else roots
        with tracing.span("index.vocab"):
            vocab = build_vocab(pinned)
            fp = vocab_fingerprint(vocab)

        done: list[IndexPartial] = []
        versions: list[int] = []
        manifest = None
        if checkpoint_dir:
            os.makedirs(checkpoint_dir, exist_ok=True)
            if resume:
                manifest = _load_manifest(checkpoint_dir)
            if manifest is not None:
                if manifest["schema"] != MANIFEST_SCHEMA:
                    raise ValueError(
                        f"checkpoint schema {manifest['schema']} !="
                        f" {MANIFEST_SCHEMA}")
                if manifest["vocab"] != fp:
                    raise ValueError(
                        "checkpoint was built against a different"
                        f" vocabulary ({manifest['vocab']} != {fp}) —"
                        " refusing to resume")
            else:
                manifest = {"schema": MANIFEST_SCHEMA, "vocab": fp,
                            "n_roots": int(vocab.shape[0]), "chunks": []}
        n_ckpt = len(manifest["chunks"]) if manifest else 0

        for i, ch in enumerate(stream):
            if i < n_ckpt:
                rec = manifest["chunks"][i]
                if rec["start_word"] != ch.start_word or \
                        rec["n_words"] != ch.n_words:
                    raise ValueError(
                        f"resumed stream diverges at chunk {i}: checkpoint"
                        f" covers words [{rec['start_word']},"
                        f" +{rec['n_words']}), stream yields"
                        f" [{ch.start_word}, +{ch.n_words})")
                part = _load_partial(checkpoint_dir, i, rec.get("sha"))
                if part is not None:
                    done.append(part)
                    versions.append(rec["dict_version"])
                    continue
                # missing / torn / hash-divergent partial: fall through and
                # recompute this chunk from its stream item
            last = None
            for _ in range(chunk_retries + 1):
                dv = store.acquire() if store else None
                handle = dv.handle if dv else roots
                try:
                    if injector is not None:
                        injector.on_dispatch()
                    counts, docs, poss, n_post = ops.build_root_index(
                        ch.words, handle, vocab, ch.doc_ids, ch.positions,
                        mesh=mesh, block_b=block_b, block_w=block_w,
                        device=device, **stem_kw)
                except (KeyboardInterrupt, SystemExit):
                    raise
                except Exception as e:
                    last = e
                    continue
                break
            else:
                raise RuntimeError(
                    f"chunk {i}: compute still failing after"
                    f" {chunk_retries + 1} attempts") from last
            with tracing.span("index.readback"):   # the host waits here
                n = int(n_post)
                got = (counts.cpu(), docs[:n].cpu(), poss[:n].cpu())
            tracing.add("index.copy_bytes",
                        n_post.nbytes + sum(t.nbytes for t in got))
            part = IndexPartial(counts=got[0].numpy().astype(np.int64),
                                docs=got[1].numpy(),
                                positions=got[2].numpy())
            done.append(part)
            versions.append(dv.version if dv else 0)
            if checkpoint_dir:
                sha = _write_partial(checkpoint_dir, i, part,
                                     injector=injector, retries=chunk_retries)
                rec = {"i": i, "start_word": int(ch.start_word),
                       "n_words": int(ch.n_words),
                       "n_postings": part.n_postings,
                       "dict_version": versions[-1], "sha": sha}
                if i < len(manifest["chunks"]):
                    manifest["chunks"][i] = rec     # recomputed torn chunk
                else:
                    manifest["chunks"].append(rec)
                _write_manifest(checkpoint_dir, manifest)
        with tracing.span("index.merge"):
            return merge_partials(done, vocab, dict_versions=versions)

"""Public entry points of the port's kernels.

The counterpart of ``repro.kernels.ops``: the stemmer megakernels
(:func:`extract_roots_fused`), the persistent serving kernel
(:func:`extract_roots_persistent`), the staged Compare path's kernels
(:func:`stem_candidates`, :func:`dict_match`,
:func:`extract_roots_multilaunch`), the megakernel autotuner
(:func:`autotune_stem_fused`), the text front end
(:func:`text_to_words`, :func:`extract_roots_text`), the corpus index
(:func:`build_root_index`, :func:`build_root_index_text`), the
data-sharded launches over a mesh (``extract_roots_sharded``, which is
``dist.shard_batch``, and ``build_root_index(mesh=...)``), the launch
counter over every kernel, and the per-tile integrity checksum the
serving ring verifies at retire.
"""
from __future__ import annotations

import functools
import time

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch import tracing
from repro_torch.core import pyref
from repro_torch.core import stemmer as core_stemmer
from repro_torch.core import textnorm as tn
from repro_torch.dist.shard_batch import map_shards, on_device, replica
from repro_torch.dist.shard_batch import shard_batch as extract_roots_sharded
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import postings as pk
from repro_torch.kernels import stem_datapath as sdp
from repro_torch.kernels import stem_fused as sf
from repro_torch.kernels import stem_match as sm
from repro_torch.kernels import text_frontend as tf

# every CUDA wrapper of the port; each counts its own launches
CUDA_WRAPPERS = (sf.CUDA_WRAPPERS + tf.CUDA_WRAPPERS + pk.CUDA_WRAPPERS
                 + sdp.CUDA_WRAPPERS + sm.CUDA_WRAPPERS + fa.CUDA_WRAPPERS)


# -- dispatch accounting -----------------------------------------------------
def reset_dispatch_count() -> None:
    """Zero the launch counters of every kernel (K1-K9), and K5's, K8's
    and K9's counts per instance."""
    for wrapper in CUDA_WRAPPERS:
        wrapper.launches = 0
    for wrapper in (pk.postings_cuda, sm.dict_match_bsearch_cuda,
                    fa.flash_attention_cuda):
        wrapper.instances = dict.fromkeys(wrapper.instances, 0)


def dispatch_count() -> int:
    """CUDA kernel launches (K1, K2, both K3 variants, K4-K9) since the
    last :func:`reset_dispatch_count`. Only real kernel launches count:
    the plain versions that run on the CPU launch nothing."""
    return sum(wrapper.launches for wrapper in CUDA_WRAPPERS)


def dict_match(keys, dict_keys, *, strategy: str = "bank",
               device=devmod.DEFAULT_DEVICE, **kw) -> torch.Tensor:
    """Membership of packed stem keys in a packed root dictionary, on
    ``device``: keys int32[N], dict_keys int32[R] -> bool[N].

    strategy="bank"    the comparator bank (K7): all-pairs compare against
                       the table padded to ``block_r * 128`` entries
    strategy="bsearch" the sorted search (K8): bisection of the sorted,
                       pow2 sentinel-padded table; ``block_r`` is dropped
    A CUDA device launches the kernel (one launch, none for N = 0); the
    CPU runs its plain version.
    """
    dev = devmod.resolve(device)
    keys = devmod.as_int32(keys, dev)
    dict_keys = devmod.as_int32(dict_keys, dev)
    on_cuda = dev.type == "cuda"
    if strategy == "bank":
        run = sm.dict_match_cuda if on_cuda else sm.dict_match_plain
        return run(keys, dict_keys, **kw)
    if strategy == "bsearch":
        kw.pop("block_r", None)  # bsearch holds the whole dict resident
        run = (sm.dict_match_bsearch_cuda if on_cuda
               else sm.dict_match_bsearch_plain)
        return run(keys, dict_keys, **kw)
    raise ValueError(f"unknown match strategy: {strategy}")


def stem_candidates(words, *, block_b: int = 256,
                    device=devmod.DEFAULT_DEVICE):
    """Stages 1-4 alone on ``device`` (K6 on a card): words int32[B,16] ->
    (keys int32[B,32], valid int32[B,32])."""
    dev = devmod.resolve(device)
    return sdp.stem_datapath(devmod.as_int32(words, dev), block_b=block_b)


def unpack_keys(keys: torch.Tensor) -> torch.Tensor:
    """int32[...] packed keys -> int32[..., 4] char codes."""
    return torch.stack([(keys >> 18) & 63, (keys >> 12) & 63,
                        (keys >> 6) & 63, keys & 63], dim=-1).to(torch.int32)


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
    batches chunk into several launches as the reference's do when their
    visit table would exceed ``visit_budget`` entries
    (``stem_fused.planned_launches``).
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
                             with_checksum: bool = False, flags_out=None,
                             device=devmod.DEFAULT_DEVICE):
    """The persistent serving kernel (K3) on ``device``: one launch (one a
    chunk, streamed) walks a descriptor ring of the batch's tiles. Returns
    ``(root, source, flags)``: flags int32[batch_tiles] is ``1 +
    version_slot`` for every retired descriptor, the completion word the
    serving ring checks. Without ``flags_out`` the flags are on
    ``device``; with it (``stem_fused.MappedFlags`` on a card, a CPU
    tensor on the CPU) the kernel writes them straight into host memory,
    and its host tensor is returned. Roots and sources are bit-identical
    to :func:`extract_roots_fused`; ``with_checksum=True`` appends the
    :func:`tile_checksum` row.
    """
    return _launch(words, roots, infix=infix, match=match, block_b=block_b,
                   residency=residency, dict_block_r=dict_block_r,
                   num_buffers=num_buffers, skip_index=skip_index,
                   persistent=True, version_slot=version_slot,
                   visit_budget=visit_budget, with_checksum=with_checksum,
                   flags_out=flags_out, device=device)


def extract_roots_multilaunch(words, roots, *, infix: bool = True,
                              device=devmod.DEFAULT_DEVICE):
    """The pre-megakernel pipeline on ``device``: the datapath kernel (K6),
    then one comparator-bank launch (K7) per candidate group on its
    ``[B, 6]`` slice of the keys, masked by ``valid``, then the priority
    select; keys, flags and hit masks go through device memory between
    the launches. The baseline the megakernel is compared against;
    bit-identical to it.
    """
    dev = devmod.resolve(device)
    words = devmod.as_int32(words, dev)
    arrays, _, _ = core_stemmer.unwrap_dict(roots)
    arrays = arrays.to(dev)
    keys, valid = sdp.stem_datapath(words)
    b = words.shape[0]
    n_groups = 5 if infix else 2
    hits = []
    for g, name in enumerate(sf.GROUP_DICTS[:n_groups]):
        cols = slice(g * sf.N_CAND, (g + 1) * sf.N_CAND)
        hit = dict_match(keys[:, cols].reshape(-1), getattr(arrays, name),
                         strategy="bank", device=dev).reshape(b, sf.N_CAND)
        hits.append(hit & (valid[:, cols] > 0))
    all_hits = torch.cat(hits, dim=1)
    first = torch.argmax(all_hits.to(torch.int32), dim=1)      # first True
    found = all_hits.any(dim=1)
    chosen = torch.gather(keys[:, :n_groups * sf.N_CAND], 1,
                          first[:, None])[:, 0]
    root = torch.where(found[:, None], unpack_keys(chosen), 0)
    tags = torch.tensor([t for t in sf.GROUP_TAGS[:n_groups]
                         for _ in range(sf.N_CAND)], dtype=torch.int32,
                        device=dev)
    source = torch.where(found, tags[first], pyref.SRC_NONE)
    return root.to(torch.int32), source.to(torch.int32)


def _seconds_per_call(call, iters: int, dev: torch.device) -> float:
    """One warm-up call, then ``iters`` calls timed: with CUDA events on a
    card, with the host clock on the CPU."""
    call()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        return (time.perf_counter() - t0) / iters
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(iters):
        call()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) * 1e-3 / iters


def autotune_stem_fused(words, roots, *, infix: bool = True,
                        block_bs=(128, 256, 512), matches=("bank", "bsearch"),
                        residencies=("resident", "streamed"),
                        dict_block_rs=(4, 8, 16),
                        num_bufferss=(1, 2, 4), skip_indexes=(True,),
                        iters: int = 2, device=devmod.DEFAULT_DEVICE):
    """Time the megakernels over (block_b, match, residency, dict tile
    rows, copy pipeline depth, skip index) on ``device`` and return the
    best config.

    Returns ``{"block_b": int, "match": str, "residency": str,
    "dict_block_r": int, "num_buffers": int, "skip_index": bool,
    "timings": {(block_b, match, residency, dict_block_r, num_buffers,
    skip_index): seconds}}``. Each config has one warm-up call, then
    ``iters`` timed calls (CUDA events on a card, the host clock on the
    CPU). Resident configs use ``dict_block_r=0`` / ``num_buffers=0`` in
    the timing key (the knobs only exist on the streamed path) and are
    skipped when the dictionaries exceed the resident budget (counting
    only the tables ``infix`` loads).
    """
    dev = devmod.resolve(device)
    words = devmod.as_int32(words, dev)
    roots, _, _ = core_stemmer.unwrap_dict(roots)
    resident_ok = (sf.choose_residency(roots, "auto", infix=infix)
                   == "resident")
    timings = {}
    # clamp tiles to the batch (small batches still tune over strategies)
    bbs = sorted({min(bb, words.shape[0]) for bb in block_bs})
    for bb in bbs:
        for m in matches:
            for res in residencies:
                if res == "resident" and not resident_ok:
                    continue
                # dict tiling / pipeline depth / skip are no-op knobs on
                # the resident path
                streamed = res == "streamed"
                drs = dict_block_rs if streamed else (0,)
                nbs = num_bufferss if streamed else (0,)
                sks = skip_indexes if streamed else (True,)
                for dr in drs:
                    for nb in nbs:
                        for sk in sks:
                            call = functools.partial(
                                extract_roots_fused, words, roots,
                                infix=infix, match=m, block_b=bb,
                                residency=res, dict_block_r=dr or 8,
                                num_buffers=nb or 2, skip_index=sk,
                                device=dev)
                            timings[(bb, m, res, dr, nb, sk)] = \
                                _seconds_per_call(call, iters, dev)
    if not timings:
        raise ValueError(
            "autotune_stem_fused: no runnable config — the dictionaries"
            f" exceed the VMEM residency budget ({sf.MAX_RESIDENT_KEYS}"
            " keys) and residencies excludes 'streamed'")
    best = min(timings, key=timings.get)
    best_bb, best_m, best_res, best_dr, best_nb, best_sk = best
    return {"block_b": best_bb, "match": best_m, "residency": best_res,
            "dict_block_r": best_dr or 8, "num_buffers": best_nb or 2,
            "skip_index": best_sk, "timings": timings}


# ---------------------------------------------------------------------------
# Text in: the front end (K4) chained into the stemmer kernels
# ---------------------------------------------------------------------------
def text_to_words(chars, *, block_w: int = 128, max_words: int | None = None,
                  device=devmod.DEFAULT_DEVICE):
    """Text front end on ``device``: codepoint tile int32[T] (0-padded) ->
    (words int32[Wp, 16], spans int32[Wp, 2], n_words int32[]).

    The plain PyTorch geometry pre-pass (``textnorm.segment_geometry``:
    word starts, lengths, byte spans) and then one K4 launch for the
    per-word normalise/strip/pack work. Rows at and past ``n_words`` are
    zero; bit-identical to ``textnorm.analyze_text_py`` on the decoded
    text. Nothing is synchronised: ``n_words`` stays on the device.
    """
    dev = devmod.resolve(device)
    chars = devmod.as_int32(chars, dev)
    with tracing.span("text.geometry"):
        geo = tn.segment_geometry(chars, block_w=block_w,
                                  max_words=max_words)
    with tracing.span("text.frontend"):
        words = tf.text_frontend(chars, geo.starts, geo.lens,
                                 block_w=block_w)
    return words, geo.spans, geo.n_words


def extract_roots_text(chars, roots, *, block_w: int = 128,
                       max_words: int | None = None, infix: bool = True,
                       match: str = "bsearch", block_b: int | None = None,
                       residency: str = "auto", dict_block_r: int = 8,
                       num_buffers: int = 2, skip_index: bool = True,
                       visit_budget: int | None = None,
                       device=devmod.DEFAULT_DEVICE):
    """Text in, roots out: codepoint tile -> (roots int32[Wp, 4], sources
    int32[Wp], spans int32[Wp, 2], n_words int32[]).

    The front end (K4) chained into the stemmer kernels; the word rows stay
    on the device between the two. ``block_b`` defaults to ``block_w`` so
    the front end's padded rows feed the stemmer without re-tiling. Rows
    past ``n_words`` are all-zero words and carry SRC_NONE.
    """
    words, spans, n_words = text_to_words(chars, block_w=block_w,
                                          max_words=max_words, device=device)
    root, source = extract_roots_fused(
        words, roots, infix=infix, match=match, block_b=block_b or block_w,
        residency=residency, dict_block_r=dict_block_r,
        num_buffers=num_buffers, skip_index=skip_index,
        visit_budget=visit_budget, device=device)
    return root, source, spans, n_words


# ---------------------------------------------------------------------------
# Corpus indexing: stemmer kernels -> postings kernel (K5) -> CSR scatter
# ---------------------------------------------------------------------------
def _root_ids(root: torch.Tensor, source: torch.Tensor,
              vocab: torch.Tensor) -> torch.Tensor:
    """(root[W,4], source[W]) -> vocab ids int32[W]; unmatched and padding
    words get the drop bucket id ``n_roots = vocab.shape[0]``."""
    n_roots = vocab.shape[0]
    key = core_stemmer.pack_keys(root).contiguous()
    idx = torch.searchsorted(vocab, key).to(torch.int32)
    found = vocab[idx.clamp(max=n_roots - 1).long()] == key
    valid = found & (source != pyref.SRC_NONE)
    return torch.where(valid, idx, torch.full_like(idx, n_roots))


def build_root_index(words, roots, vocab, doc_ids, positions, *,
                     mesh=None, infix: bool = True,
                     match: str = "bsearch", block_b: int = 2048,
                     residency: str = "auto", dict_block_r: int = 8,
                     num_buffers: int = 2, skip_index: bool = True,
                     visit_budget: int | None = None, block_w: int = 2048,
                     device=devmod.DEFAULT_DEVICE):
    """One corpus chunk -> one inverted-index partial, on ``device``.

    words int32[W, 16], vocab int32[n_roots] (sorted packed root keys),
    doc_ids/positions int32[W] -> ``(counts int32[n_roots],
    docs int32[W_pad], poss int32[W_pad], n_postings int32[])`` with root
    r's postings at ``[excl_cumsum(counts)[r], +counts[r])``, sorted by
    global word index (CSR layout; see kernels/postings.py).

    The stemmer kernels chained into the postings kernel (K5); the id map,
    cumsums and final scatter are PyTorch ops between and after them, with
    no per-word host loop and no host sync. ``roots`` accepts plain
    RootDictArrays or a ResolvedRootDict handle, as everywhere.

    With ``mesh`` the words shard over its ``data`` axis in whole postings
    tiles (W padded to ``n_dev * block_w`` with empty words, which drop):
    each entry runs the stemmer, the id map and K5 on its contiguous
    slice with the dictionary and vocabulary copied there, the per-shard
    histograms and ranks are stacked in corpus order on the mesh's first
    entry, and :func:`postings.finish_postings` runs once on the stack, so
    the global exclusive cumsum is the shard merge. ``device`` is then
    unused: the result lies on the mesh's first entry, and W_pad is a
    multiple of ``n_dev * block_w``. ``n_dev * (planned_launches +
    postings launches)`` of a shard's rows, as the reference counts.
    """
    if mesh is not None:
        return _index_sharded(words, roots, vocab, doc_ids, positions,
                              mesh=mesh, block_w=block_w,
                              infix=infix, match=match, block_b=block_b,
                              residency=residency, dict_block_r=dict_block_r,
                              num_buffers=num_buffers, skip_index=skip_index,
                              visit_budget=visit_budget)
    dev = devmod.resolve(device)
    with tracing.span("index.upload"):
        words = devmod.as_int32(words, dev)
        vocab = devmod.as_int32(vocab, dev)
    with tracing.span("index.compute"):     # enqueued, not waited for
        root, source = extract_roots_fused(
            words, roots, infix=infix, match=match, block_b=block_b,
            residency=residency, dict_block_r=dict_block_r,
            num_buffers=num_buffers, skip_index=skip_index,
            visit_budget=visit_budget, device=dev)
        ids = _root_ids(root, source, vocab)
        n_roots = vocab.shape[0]
        hist, rank = pk.postings(ids, n_roots=n_roots, block_w=block_w)
        with tracing.span("index.upload"):  # after the stemmer is enqueued
            doc_ids = devmod.as_int32(doc_ids, dev)
            positions = devmod.as_int32(positions, dev)
        out = pk.finish_postings(hist, rank, ids, doc_ids, positions,
                                 n_roots=n_roots, block_w=block_w)
    tracing.add("index.words", words.shape[0])
    tracing.add("index.copy_bytes", words.nbytes + vocab.nbytes
                + doc_ids.nbytes + positions.nbytes)
    return out


def _index_sharded(words, roots, vocab, doc_ids, positions, *, mesh,
                   block_w: int, **stem_kw):
    """:func:`build_root_index` over a mesh (the counterpart of the
    reference's ``_index_sharded_jit``)."""
    w = torch.as_tensor(words).shape[0]
    vocab = torch.as_tensor(vocab)
    vocab = devmod.as_int32(vocab, vocab.device)
    n_roots = vocab.shape[0]
    dict_copies, vocab_copies = {}, {}

    def index(shard, dev):
        root, source = sf.stem_fused(shard, replica(roots, dev, dict_copies),
                                     **stem_kw)
        ids = _root_ids(root, source, replica(vocab, dev, vocab_copies))
        return pk.postings(ids, n_roots=n_roots, block_w=block_w) + (ids,)

    # whole postings tiles a shard: stacking the shards' (tile, root)
    # histograms keeps corpus tile order
    home, (hist, rank, ids) = map_shards(words, mesh, block_w, index)
    with on_device(home):
        return pk.finish_postings(
            hist, rank, ids[:w], devmod.as_int32(doc_ids, home),
            devmod.as_int32(positions, home), n_roots=n_roots,
            block_w=block_w)


def build_root_index_text(chars, roots, vocab, byte_off, *, doc0: int = 0,
                          word0_of_doc0: int = 0, block_w_text: int = 128,
                          max_words: int | None = None, block_w: int = 2048,
                          device=devmod.DEFAULT_DEVICE, **stem_kw):
    """Raw-text variant: codepoint tile + per-doc byte offsets -> the same
    inverted-index partial as :func:`build_root_index`.

    ``chars`` is a coalesced codepoint tile (textnorm.coalesce_docs),
    ``byte_off`` int64[D] each document's first utf-8 byte offset in it.
    Word-to-document attribution and in-document positions come from the
    front end's byte spans (a sorted search and a scatter-min on the
    device). ``doc0`` offsets the emitted doc ids for chunked corpora;
    ``word0_of_doc0`` is the global position of the chunk's first word
    inside its (chunk-straddling) first document, 0 when documents never
    straddle chunks.
    """
    dev = devmod.resolve(device)
    root, source, spans, n_words = extract_roots_text(
        chars, roots, block_w=block_w_text, max_words=max_words, device=dev,
        **stem_kw)
    return _finish_index_text(
        root, source, spans, n_words, devmod.as_int32(vocab, dev),
        torch.as_tensor(np.asarray(byte_off), dtype=torch.int64).to(dev),
        doc0, word0_of_doc0, block_w=block_w)


def _finish_index_text(root, source, spans, n_words, vocab, byte_off, doc0,
                       word0_of_doc0, *, block_w: int):
    wp = root.shape[0]
    dev = root.device
    arange = torch.arange(wp, dtype=torch.int32, device=dev)
    in_tile = arange < n_words
    # byte span start -> owning document (the serve/text.py retire rule)
    doc_local = torch.searchsorted(byte_off, spans[:, 0].to(torch.int64),
                                   right=True) - 1
    doc_local = doc_local.clamp(min=0)
    # first word index per document by scatter-min (rows past n_words
    # carry arange >= n_words, so they never win the min)
    first = torch.full((byte_off.shape[0],), wp, dtype=torch.int32,
                       device=dev).scatter_reduce(0, doc_local, arange,
                                                  "amin", include_self=True)
    positions = arange - first[doc_local]
    positions = torch.where(doc_local == 0, positions + int(word0_of_doc0),
                            positions)
    n_roots = vocab.shape[0]
    ids = _root_ids(root, source, vocab)
    ids = torch.where(in_tile, ids, torch.full_like(ids, n_roots))
    hist, rank = pk.postings(ids, n_roots=n_roots, block_w=block_w)
    return pk.finish_postings(hist, rank, ids,
                              doc_local.to(torch.int32) + int(doc0),
                              positions, n_roots=n_roots, block_w=block_w)


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

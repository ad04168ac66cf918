#!/usr/bin/env python3
"""Times the stemmer kernels of two checkouts of the port, in turns, on one
CUDA card.

    python3 chip_ab.py OTHER_CHECKOUT [--block-b N]

For the checkouts (other, this, this, other), in that order, a subprocess
imports ``repro_torch`` from that checkout's ``src``, builds its kernels
(into that checkout's ``build/``) and times K6 at 128, 4096, 16,896,
65,536 and 1,048,576 corpus words (each launch first held to the plain
version; by the checkout's rule, with the lanes a word it took where the
checkout records them, and at each lane count through the measurement
builds where the checkout has them), K1, K2 and both K3 variants at
``block_b = N`` (default 256) on 4096 and 1,048,576 corpus words (K3 also
with its flags in host-mapped memory, where the checkout has them), and K1
as the index builds launch it (131,072 words at block_b 2048), with
``chip_smoke.py``'s timers and dictionaries: the realistic dictionary for
the resident kernels (and the lanes a word they took, where the checkout
records them), the 262,144-key grown one (``dict_block_r = 8``)
for the streamed ones, and the wall time of a whole streamed
``stem_fused`` call (pre-pass, if the checkout has one, and launches).
The streamed kernels are called with the checkout's own contract: a
checkout whose K2 takes visit tables gets them from the reference's
pre-pass (not timed), one whose K2 takes the tile set's fence level gets
that. K5 at an index chunk (131,072 words, block_w 2048) and at 1,048,576
words of the realistic vocabulary and at an index chunk of the
262,144-key dictionary's vocabulary, and on that vocabulary 131,072 ids
(the index chunk's, a Zipf draw and a uniform draw over all of it) at
block_w 128, 2048 and 4096 (each on the instance the checkout's rule
picks, named beside its time), and the words/s of
``build_corpus_index`` over 1,048,576 words on the 262,144-key
dictionary (the best of 3 runs after a warm-up). Prints one line a run,
a table of both checkouts' times, and the card's name and power limit.
Needs one CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

import chip_smoke as cs

SIZES = (4096, 1 << 20)


def child(tree: Path, block_b: int) -> None:
    """Time one checkout's kernels; print one JSON line of times."""
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch

    from repro_torch import index as ix
    from repro_torch.core import corpus, stemmer
    from repro_torch.core import textnorm as tn
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import postings as pk
    from repro_torch.kernels import stem_datapath as sdp
    from repro_torch.kernels import stem_fused as sf
    from repro_torch.kernels import stem_match as sm
    from repro_torch.kernels import text_frontend as tf
    from repro_torch.launch.serve import build_documents

    check_root = Path(sf.__file__).resolve().parents[3]
    cs.check(check_root == tree, f"imported {check_root}, not {tree}")
    k6_forced = getattr(build, "CANDIDATE_LANES", ())
    build_s, _ = build.build_cuda(**(
        {"forced_candidates_lanes": k6_forced} if k6_forced else {}))
    dev = torch.device("cuda")
    realistic = stemmer.RootDictArrays.from_rootdict(
        corpus.build_dictionary(), device=dev)
    grown = corpus.grow_root_arrays(realistic, cs.GROWN_KEYS)
    tables = sf.padded_tables(realistic, match="bsearch", infix=True)
    tiles = sm.build_dict_tiles(grown.tri, grown.quad, grown.bi, 8)
    handle = stemmer.resolve_dict(grown, residency="streamed",
                                  dict_block_r=8)
    words = torch.from_numpy(np.concatenate([
        c.words for c in corpus.stream_corpus_words(
            max(SIZES), seed=0, chunk_words=65536)])).to(dev)
    out = {"tree": str(tree), "block_b": block_b, "build_s": build_s}
    # K6 at a pipeline tick, a served request, 16,896 and 65,536 words,
    # and 1M words
    for b in (cs.K6_TICK_WORDS, SIZES[0], 16_896, 65_536, SIZES[1]):
        w = words[:b]
        want = sdp.stem_datapath_plain(w)
        runs = {"K6": lambda: sdp.stem_datapath_cuda(w)}  # noqa: E731
        for lanes in k6_forced:
            runs[f"K6 at {lanes} lanes"] = \
                lambda lanes=lanes: cs.forced_k6(lanes, w)  # noqa: E731
        n = 20 if b == max(SIZES) else 200
        for name, fn in runs.items():
            if cs.same(fn(), want):
                raise RuntimeError(f"chip_ab: {name} at B={b} differs from"
                                   " the plain version")
            out[f"{name} B={b}"] = cs.device_ms(fn, n, cs.call_ms(fn, n))
        out[f"K6 lanes, B={b}"] = getattr(sdp.stem_datapath_cuda,
                                          "last_lanes", None)
    visit_contract = "n_visits" in inspect.signature(
        sf.stem_streamed_cuda).parameters
    for b in SIZES:
        w = words[:b]
        bt = -(-b // block_b)
        res = dict(n_groups=5, match="bsearch", block_b=block_b)
        zeros = torch.zeros(bt, dtype=torch.int32, device=dev)
        res_desc = sf._descriptors(bt, block_b, zeros, 0)
        if visit_contract:
            n_visits, visit_idx = cs.visit_tables(sf, w, tiles, infix=True,
                                                  block_b=block_b)
            stm = dict(res, dict_block_r=8, num_buffers=2,
                       tri_tiles=tiles.counts[0], quad_tiles=tiles.counts[1])
            str_desc = sf._descriptors(bt, block_b, n_visits, 0)
            k2 = lambda: sf.stem_streamed_cuda(  # noqa: E731
                w, tiles.stream, n_visits, visit_idx, **stm)
            k3 = lambda: sf.persistent_streamed_cuda(  # noqa: E731
                w, tiles.stream, str_desc, visit_idx, **stm)
        else:
            k2 = lambda: sf.stem_streamed_cuda(  # noqa: E731
                w, tiles, n_groups=5, match="bsearch")
            k3 = lambda: sf.persistent_streamed_cuda(  # noqa: E731
                w, tiles, res_desc, **res)
        runs = {
            "K1": lambda: sf.stem_fused_cuda(w, tables, **res),
            "K2": k2,
            "K3 resident": lambda: sf.persistent_resident_cuda(
                w, tables, res_desc, **res),
            "K3 streamed": k3,
        }
        if hasattr(sf, "MappedFlags"):
            # K3 as the serving ring launches it, its flags in host-mapped
            # memory (a checkout from before them has no such launch)
            mapped = sf.MappedFlags(bt, dev)
            runs["K3 resident, mapped flags"] = \
                lambda: sf.persistent_resident_cuda(  # noqa: E731
                    w, tables, res_desc, flags_out=mapped, **res)
            runs["K3 streamed, mapped flags"] = \
                lambda: sf.persistent_streamed_cuda(  # noqa: E731
                    w, tiles, res_desc, flags_out=mapped, **res)
        n = 200 if b == min(SIZES) else 20
        for name, fn in runs.items():
            out[f"{name} B={b}"] = cs.device_ms(fn, n, cs.call_ms(fn, n))
        # the resident kernels' lanes a word, where the tree has them
        for name, fn in (("K1", sf.stem_fused_cuda),
                         ("K3 resident", sf.persistent_resident_cuda)):
            out[f"{name} lanes, B={b}"] = getattr(fn, "last_lanes", None)
        entry = lambda: sf.stem_fused(w, handle, block_b=block_b)  # noqa: E731
        out[f"stem_fused streamed, wall B={b}"] = cs.call_ms(entry, 5)
    # K1 as the index builds launch it: a chunk of words at the index's tile
    w = words[:cs.INDEX_CHUNK]
    res = dict(n_groups=5, match="bsearch", block_b=cs.INDEX_BLOCK)
    fn = lambda: sf.stem_fused_cuda(w, tables, **res)  # noqa: E731
    key = f"K1 index chunk, block_b={cs.INDEX_BLOCK} B={cs.INDEX_CHUNK}"
    out[key] = cs.device_ms(fn, 100, cs.call_ms(fn, 100))
    out["K1 lanes, index chunk"] = getattr(sf.stem_fused_cuda, "last_lanes",
                                            None)
    # K4 at a served request's tile and at the 1M-word tile (the same
    # contract in every checkout that has K4)
    table = corpus.build_token_table()
    big = tn.coalesce_docs([d for _, ds in corpus.stream_corpus_docs(
        cs.INDEX_WORDS, seed=0, chunk_words=cs.INDEX_CHUNK,
        words_per_doc=cs.INDEX_WORDS_PER_DOC, table=table) for d in ds])[0]
    req = cs.request_tile(tn, build_documents(
        cs.TEXT_REQUESTS * cs.TEXT_DOCS_PER_REQUEST,
        cs.TEXT_WORDS_PER_DOC)[:cs.TEXT_DOCS_PER_REQUEST])
    for label, chars in (("request tile", req), ("1M-word tile", big)):
        tile = torch.from_numpy(chars).to(dev)
        geo = tn.segment_geometry(tile, block_w=128)
        fn = lambda: tf.text_frontend_cuda(tile, geo.starts,  # noqa: E731
                                           geo.lens)
        n = 200 if label == "request tile" else 20
        out[f"K4 {label} B={int(geo.n_words)}"] = cs.device_ms(
            fn, n, cs.call_ms(fn, n))
    # K8 on the tri group's keys (6 a word) against the realistic tri
    # table, and one call at 4096 words split by the profiler
    for b in SIZES:
        k = sdp.stem_datapath_cuda(words[:b])[0][:, :6].reshape(-1) \
            .contiguous()
        fn = lambda: sm.dict_match_bsearch_cuda(k, realistic.tri)  # noqa
        n = 200 if b == min(SIZES) else 20
        out[f"K8 B={k.shape[0]}"] = cs.device_ms(fn, n, cs.call_ms(fn, n))
    from torch.profiler import ProfilerActivity, profile

    k = sdp.stem_datapath_cuda(words[:min(SIZES)])[0][:, :6].reshape(-1) \
        .contiguous()
    calls = 50
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            sm.dict_match_bsearch_cuda(k, realistic.tri)
        torch.cuda.synchronize()
    split = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            split[e.name] = (split.get(e.name, 0.0)
                             + e.device_time_total / 1e3)
    out["K8 profile, ms a call"] = {name: t / calls
                                    for name, t in split.items()}
    # K5 as the index builds launch it, on the realistic vocabulary and on
    # the 262,144-key dictionary's
    block = cs.INDEX_BLOCK
    table = corpus.build_token_table()
    chunks = list(corpus.stream_corpus_words(
        cs.INDEX_WORDS, seed=0, chunk_words=cs.INDEX_CHUNK,
        words_per_doc=cs.INDEX_WORDS_PER_DOC, table=table))
    index_words = torch.from_numpy(np.concatenate([c.words for c in chunks])
                                   ).to(dev)
    for label, arrays, n_words in (
            ("index chunk", realistic, cs.INDEX_CHUNK),
            ("1M words", realistic, cs.INDEX_WORDS),
            ("index chunk, 262,144-key vocabulary", grown, cs.INDEX_CHUNK)):
        vocab = ix.build_vocab(arrays)
        ids = ops._root_ids(*sf.stem_fused(index_words[:n_words], arrays,
                                           block_b=block),
                            torch.from_numpy(vocab).to(dev))
        tiles_ = pk.pad_ids(ids, n_roots=len(vocab), block_w=block)
        fn = lambda: pk.postings_cuda(  # noqa: E731
            tiles_, n_roots=len(vocab), block_w=block)
        out[f"K5 {label} B={n_words}"] = cs.device_ms(fn, 100,
                                                      cs.call_ms(fn, 100))
        out[f"K5 instance, {label}"] = pk._instance(len(vocab), block)
        if arrays is grown:
            grown_ids = ids
    # K5 on the 262,144-key vocabulary past the index's own chunk: its ids,
    # and ids spread over the whole vocabulary (a Zipf draw whose ranks
    # are scattered over the ids, as the tests draw them, and a uniform
    # one), each at three tile widths
    n_roots = len(ix.build_vocab(grown))
    rng = np.random.default_rng(0)
    ranks = (rng.zipf(1.3, size=cs.INDEX_CHUNK) - 1) % (n_roots + 1)
    spread = {"index ids": grown_ids.cpu().numpy(),
              "Zipf ids": (ranks * 40_503 + 11) % (n_roots + 1),
              "uniform ids": rng.integers(0, n_roots + 1, cs.INDEX_CHUNK)}
    for name, host_ids in spread.items():
        for block_w in (128, 2048, 4096):
            tiles_ = pk.pad_ids(torch.from_numpy(host_ids).to(dev),
                                n_roots=n_roots, block_w=block_w)
            fn = lambda: pk.postings_cuda(  # noqa: E731
                tiles_, n_roots=n_roots, block_w=block_w)
            label = f"262,144-key vocabulary, {name}, block_w {block_w}"
            got = fn()
            want = pk.postings_plain(tiles_, n_roots=n_roots, block_w=block_w)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise RuntimeError(f"chip_ab: K5 at {label} differs from"
                                   " the plain version")
            out[f"K5 {label} B={cs.INDEX_CHUNK}"] = cs.device_ms(
                fn, 100, cs.call_ms(fn, 100))
            out[f"K5 instance, {label}"] = pk._instance(n_roots, block_w)
    kw = dict(block_b=block, block_w=block, device=dev)
    ix.build_corpus_index(iter(chunks[:1]), grown, **kw)      # warm-up
    secs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ix.build_corpus_index(iter(chunks), grown, **kw)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    out["index, 262,144 keys, words/s"] = cs.INDEX_WORDS / min(secs)
    out["index, 262,144 keys, s a run"] = secs
    print(json.dumps(out))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("other", type=Path)
    p.add_argument("--block-b", type=int, default=cs.BLOCK_B)
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.child:
        child(args.other.resolve(), args.block_b)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    this = Path(__file__).resolve().parent
    other = args.other.resolve()
    results = []
    for label, tree in (("other", other), ("this", this), ("this", this),
                        ("other", other)):
        run = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              str(tree), "--block-b", str(args.block_b),
                              "--child"], capture_output=True, text=True)
        if run.returncode:
            print(run.stdout + run.stderr, file=sys.stderr)
            raise RuntimeError(f"chip_ab: the run of {tree} failed")
        row = json.loads(run.stdout.strip().splitlines()[-1])
        row["label"] = label
        results.append(row)
        print(f"[ab] {label} ({tree}): {json.dumps(row)}")
    keys = [k for k in results[1] if "B=" in k and "lanes" not in k]
    keys.append("index, 262,144 keys, words/s")
    print(f"[ab] ms on the card at block_b={args.block_b}"
          " (other, this, this, other; - where a checkout has no such"
          " launch):")
    for k in keys:
        print(f"[ab] {k}: " + ", ".join(
            f"{r[k]:.6f}" if k in r else "-" for r in results))
    for k in (k for k in results[1] if "lanes" in k or "profile" in k
              or "instance" in k or "s a run" in k):
        print(f"[ab] {k}: " + ", ".join(json.dumps(r.get(k))
                                         for r in results))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
drives its main path — root extraction served through
``repro_torch.serve.Engine`` + ``StemmerWorkload`` onto the stemmer
megakernel — at a realistic size. Phases:

  1. card     name and power limit (nvidia-smi)
  2. build    nvcc build of every kernel library, with its seconds
  3. K1       the megakernel against its plain PyTorch version on the card,
              bit for bit, over infix x match x block_b x batch sizes, on
              the realistic dictionary (shared-memory tables) and on a
              ~60K-key grown dictionary (global-memory tables)
  4. serve    1,048,576 corpus words in 256 requests of 4096 through the
              engine; every request checked against the plain sorted-search
              stemmer on the card, every retire checksum-verified, and the
              kernel's launch count equal to the planned launches
  5. accuracy Table-6 root recall through the megakernel, exactly
  6. times    the kernel's device time with CUDA events and its wall
              time per call with the host's share; the plain version's
              wall time per call

Imports nothing of jax or of the ``repro`` package. Any failed check
raises, so the script exits non-zero and prints no result line; it also
exits non-zero without a CUDA device. The last line is the JSON result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# Table-6 root recall over build_corpus(2000, seed=0) (BENCH_stemmer.json)
RECALL_WITH_INFIX = 0.8914728682170543
RECALL_WITHOUT_INFIX = 0.8062015503875969
# H100 SXM peaks (published data sheet): HBM bytes/s, and the
# non-tensor-core 32-bit rate used as the peak for the kernel's int32 ops
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# int32 operations per word for stages 1-4 (count nonzero 16, prefix run
# 5 x 4, suffix run 16 x 3, then per prefix cut: two valid_s tests ~10,
# five packs x 6, infix test 3, flags ~6) and per bisection probe (mid
# add+shift, clamp 2, load, compare, 2 selects, +1)
DATAPATH_OPS_PER_WORD = 16 + 5 * 4 + 16 * 3 + 6 * (10 + 5 * 6 + 3 + 6)
OPS_PER_PROBE = 9
SERVE_WORDS = 1 << 20
SERVE_REQUEST_WORDS = 4096
K1_BATCHES = (0, 1, 257, 65536)
K1_BLOCKS = (64, 128, 256, 512)
DEVICE = "cuda"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def call_ms(fn, n: int) -> float:
    """Wall time per call, host included: n calls after a warm-up, then a
    synchronize."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / n


def device_ms(fn, n: int, host_ms: float) -> float:
    """Device time per call: CUDA events around n back-to-back calls,
    queued behind a spacer kernel that keeps the card busy until the host
    has queued them all, so host time between launches is not counted."""
    import torch

    cycles = int(4 * n * host_ms * 1e-3 * 2e9)   # > 4x the queueing time
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        queued_in_time = not start.query()
        stop.synchronize()
        if queued_in_time:
            return start.elapsed_time(stop) / n
        cycles *= 4
    raise RuntimeError("chip_smoke: the host never got ahead of the card")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch.core import accuracy, corpus, stemmer
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import stem_fused as sf
    from repro_torch.serve import DictStore, Engine, StemmerWorkload

    dev = torch.device(DEVICE)
    t_all = time.perf_counter()

    # ---- 1. card ---------------------------------------------------------
    card = card_line()
    print(f"[card] {card}")
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda}"
          f" python {sys.version.split()[0]}")

    # ---- 2. build --------------------------------------------------------
    build_s, libs = build.build_cuda()
    print(f"[build] {len(libs)} kernel librar{'y' if len(libs) == 1 else 'ies'}"
          f" built in {build_s:.1f} s")
    for name, path in libs.items():
        log = path.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    # ---- 3. K1 against its plain version ---------------------------------
    t0 = time.perf_counter()
    realistic = stemmer.RootDictArrays.from_rootdict(
        corpus.build_dictionary(), device=dev)
    grown = corpus.grow_root_arrays(realistic, 60_000)
    words_np = next(corpus.stream_corpus_words(
        max(K1_BATCHES), seed=0, chunk_words=max(K1_BATCHES))).words
    words = torch.from_numpy(words_np).to(dev)
    max_err = 0
    cases = 0
    for dict_name, arrays, want_shared in (("realistic", realistic, True),
                                           ("grown", grown, False)):
        for infix in (True, False):
            n_groups = 5 if infix else 2
            for match in ("bsearch", "bank"):
                tables = sf.padded_tables(arrays, match=match, infix=infix)
                for b in K1_BATCHES:
                    w = words[:b]
                    if b == 0:   # the wrapper returns early, no launch
                        before = ops.dispatch_count()
                        r, s = sf.stem_fused(w, arrays, infix=infix,
                                             match=match)
                        check(r.shape == (0, 4) and s.shape == (0,)
                              and ops.dispatch_count() == before,
                              "B=0 must return empty outputs, no launch")
                        continue
                    r_ref, s_ref = sf.stem_fused_plain(
                        w, tables, n_groups=n_groups, match=match,
                        block_b=256)
                    for block_b in K1_BLOCKS:
                        shared = sf.dict_in_shared(tables, n_groups=n_groups)
                        check(shared == want_shared,
                              f"{dict_name} tables expected in"
                              f" {'shared' if want_shared else 'global'}"
                              " memory")
                        r, s = sf.stem_fused_cuda(
                            w, tables, n_groups=n_groups, match=match,
                            block_b=block_b)
                        torch.cuda.synchronize()
                        err = max(int((r - r_ref).abs().max()),
                                  int((s - s_ref).abs().max()))
                        bad = int((r != r_ref).any(1).sum()
                                  + (s != s_ref).sum())
                        max_err = max(max_err, err)
                        cases += 1
                        check(bad == 0, f"K1 vs plain: {bad} mismatches"
                              f" ({dict_name}, infix={infix}, match={match},"
                              f" B={b}, block_b={block_b})")
                print(f"[K1] {dict_name} dict ({arrays.n_keys} keys,"
                      f" {'shared' if want_shared else 'global'} memory)"
                      f" infix={infix} match={match}: B in {K1_BATCHES} x"
                      f" block_b in {K1_BLOCKS} identical")
    print(f"[K1] {cases} launches identical to the plain version,"
          f" max_abs_err {max_err} ({time.perf_counter() - t0:.1f} s)")

    # ---- 4. serve --------------------------------------------------------
    serve_words = np.concatenate([c.words for c in corpus.stream_corpus_words(
        SERVE_WORDS, seed=0, chunk_words=65536)])
    n_req = SERVE_WORDS // SERVE_REQUEST_WORDS

    def serve(n_requests: int):
        store = DictStore(realistic, device=dev)
        wl = StemmerWorkload(store, block_b=256, megabatch_tiles=16,
                             max_inflight=2)
        eng = Engine(wl)
        t = time.perf_counter()
        rids = [eng.submit(serve_words[i * SERVE_REQUEST_WORDS:
                                       (i + 1) * SERVE_REQUEST_WORDS])
                for i in range(n_requests)]
        rep = eng.run_until_drained(max_ticks=100_000)
        torch.cuda.synchronize()
        return eng, rids, rep, time.perf_counter() - t

    serve(8)                                  # warm-up: buffers, first load
    ops.reset_dispatch_count()
    eng, rids, rep, serve_s = serve(n_req)
    launches = ops.dispatch_count()
    wl = eng.workload
    planned = n_req * sf.planned_launches(
        SERVE_REQUEST_WORDS, wl.store.acquire().handle)
    want_r, want_s = stemmer.extract_roots(serve_words, realistic,
                                           backend="sorted", device=dev)
    want_r, want_s = want_r.cpu().numpy(), want_s.cpu().numpy()
    for i, rid in enumerate(rids):
        req = eng.result(rid)
        sl = slice(i * SERVE_REQUEST_WORDS, (i + 1) * SERVE_REQUEST_WORDS)
        check(req is not None and req.done, f"request {rid} not finished")
        check(np.array_equal(req.roots, want_r[sl])
              and np.array_equal(req.sources, want_s[sl])
              and (req.dict_versions == 0).all(),
              f"served request {rid} differs from the plain stemmer")
    check(wl.checksum_tiles == SERVE_WORDS // wl.block_b,
          f"{wl.checksum_tiles} tiles checksum-verified, want"
          f" {SERVE_WORDS // wl.block_b}")
    check(launches == planned == wl.ticks_launched,
          f"kernel launches {launches}, planned {planned}, engine"
          f" {wl.ticks_launched}")
    check(launches > 0, "the serve run launched no kernel")
    found = float((want_s > 0).mean())
    print(f"[serve] {n_req} requests / {SERVE_WORDS} words in {serve_s:.3f} s"
          f" ({SERVE_WORDS / serve_s:.0f} words/s, {rep.ticks} ticks,"
          f" {launches} K1 launches = planned {planned}, {wl.checksum_tiles}"
          f" tiles checksum-verified, root found for {found:.4f} of words)")

    # ---- 5. accuracy -----------------------------------------------------
    t6 = accuracy.table6(n_words=2000, seed=0, backend="fused", device=dev)
    rw, ro = t6["with_infix"].root_recall, t6["without_infix"].root_recall
    print(f"[accuracy] table6 root recall with infix {rw!r},"
          f" without {ro!r}")
    check(rw == RECALL_WITH_INFIX and ro == RECALL_WITHOUT_INFIX,
          "table6 recall differs from the reference")

    # ---- 6. times --------------------------------------------------------
    tables = sf.padded_tables(realistic, match="bsearch", infix=True)
    table_bytes = 4 * sum(int(t.shape[0]) for t in tables)
    steps = {name: max(1, int(t.shape[0]) - 1).bit_length()
             for name, t in zip(("tri", "quad", "bi"), tables)}
    times = {}
    for b in (SERVE_REQUEST_WORDS, SERVE_WORDS):
        w = torch.from_numpy(serve_words[:b]).to(dev)
        run = dict(n_groups=5, match="bsearch", block_b=256)
        r_k, s_k = sf.stem_fused_cuda(w, tables, **run)
        r_p, s_p = sf.stem_fused_plain(w, tables, **run)
        check(bool((r_k == r_p).all() and (s_k == s_p).all()),
              f"timed shape B={b} differs from the plain version")
        n_k = 200 if b == SERVE_REQUEST_WORDS else 20
        n_p = 20 if b == SERVE_REQUEST_WORDS else 3
        kernel = lambda: sf.stem_fused_cuda(w, tables, **run)  # noqa: E731
        plain = lambda: sf.stem_fused_plain(w, tables, **run)  # noqa: E731
        k_call = call_ms(kernel, n_k)
        ms = device_ms(kernel, n_k, k_call)
        # the plain version issues hundreds of small kernels a call, more
        # than the launch queue holds behind a spacer: its time is the
        # wall time per call
        plain_ms = call_ms(plain, n_p)
        # the bound: bytes the function must move, and the int32 ops these
        # inputs need (probes stop at each word's first hit)
        keys, valid = sf._candidates(w, 5)
        hits = sf._resident_hits(keys, valid, dict(zip(("tri", "quad", "bi"),
                                                       tables)),
                                 n_groups=5, match="bsearch")
        slot = torch.arange(30, device=dev)
        first = torch.where(hits.any(1), hits.to(torch.int8).argmax(1), 30)
        tried = valid & (slot[None, :] <= first[:, None])
        per_slot = torch.tensor([steps[sf.GROUP_DICTS[g]] + 1
                                 for g in range(5) for _ in range(6)],
                                device=dev)
        probes = int((tried * per_slot).sum())
        n_bytes = b * (16 * 4 + 4 * 4 + 4) + table_bytes
        n_ops = b * DATAPATH_OPS_PER_WORD + probes * OPS_PER_PROBE
        t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / PEAK_OPS_S
        times[b] = dict(ms=ms, plain_ms=plain_ms,
                        bound_ms=1e3 * max(t_bytes, t_ops),
                        bound_by="bytes" if t_bytes >= t_ops else "operations")
        print(f"[times] K1 B={b}: {ms:.6f} ms on the card ({k_call:.6f} ms"
              f" a call with the host), plain {plain_ms:.6f} ms a call,"
              f" bound {times[b]['bound_ms']:.6f} ms by"
              f" {times[b]['bound_by']} ({n_bytes} B, {n_ops} int32 ops,"
              f" {probes} probes); no single PyTorch call computes this"
              f" function, so library_ms is null")

    busy = launches * times[SERVE_REQUEST_WORDS]["ms"] * 1e-3 / serve_s
    print(f"[times] K1 ran for {busy:.6f} of the serve phase's wall time"
          f" ({launches} launches x the device time at B="
          f"{SERVE_REQUEST_WORDS}, over {serve_s:.6f} s)")
    print(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(card_line())
    serve_t = times[SERVE_REQUEST_WORDS]
    print(json.dumps({"kernels": [{
        "name": "stem_fused", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stem_fused.cu",
        "replaces": "src/repro/kernels/stem_fused.py:166",
        "launches": launches, "max_abs_err": max_err,
        "ms": serve_t["ms"], "plain_ms": serve_t["plain_ms"],
        "bound_ms": serve_t["bound_ms"], "bound_by": serve_t["bound_by"],
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

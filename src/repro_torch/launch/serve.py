"""Serving launcher: the LM, stemmer and text workloads through the port's
Engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --workload lm --arch llama3-8b
  PYTHONPATH=src python -m repro_torch.launch.serve --workload stemmer --requests 16
  PYTHONPATH=src python -m repro_torch.launch.serve --workload stemmer --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --workload stemmer \
      --megabatch 4 --persistent
  PYTHONPATH=src python -m repro_torch.launch.serve --workload text \
      --requests 16 --words-per-request 256 [--frontend kernel|reference|host]
  PYTHONPATH=src python -m repro_torch.launch.serve --workload stemmer \
      --devices 4 --device cpu

The LM workload (the default, as in the reference) serves the reduced
same-family config (``configs.smoke_config``) of ``--arch`` with weights
drawn from seed 0: every family, ``falcon-mamba-7b`` and ``hymba-1.5b``
among them; ``llama-3.2-vision-11b`` text-only, with zero cross caches,
and ``musicgen-medium`` on 1-D prompts, each id written into all four
codebooks and codebook 0's greedy id emitted, as the reference's
ServeEngine serves them. Runs on the CUDA device unless ``--device cpu`` is
given; with no CUDA device present the default raises instead of falling
back to the CPU.

The reference's robustness flags: ``--deadline-ms``, ``--max-retries``
(stemmer and text), ``--queue-cap`` with ``--on-full``, ``--journal PATH``
(the write-ahead request journal behind ``Engine.recover``),
``--watchdog-ms`` (needs ``--persistent``) and ``--degrade on`` (the
degradation ladder, stemmer and text). ``--devices N`` shards every
stemmer or text launch over a ``("data",)`` mesh of the first N GPUs (N
CPU entries with ``--device cpu``); asking for more GPUs than the machine
has exits with the mesh's error. Bad combinations are rejected before any
engine is built (exit code 2).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch import device as devmod
from repro_torch.core import corpus, stemmer
from repro_torch.models import model as model_mod
from repro_torch.models import params as pm
from repro_torch.serve import (DegradationPolicy, DictStore, Engine, Journal,
                               LMDecodeWorkload, StemmerWorkload,
                               TextAnalysisWorkload)


def _engine_kw(args) -> dict:
    """Engine admission-control and crash-safety arguments shared by the
    three workloads (the flags are checked in main() first)."""
    kw = dict(queue_cap=args.queue_cap or None, on_full=args.on_full)
    if args.journal:
        kw["journal"] = Journal(args.journal)
    if args.degrade == "on":
        kw["policy"] = DegradationPolicy()
    return kw


def _deadline_s(args) -> float | None:
    return args.deadline_ms / 1000.0 if args.deadline_ms else None


def _retry_kw(args) -> dict:
    """StemmerWorkload/TextAnalysisWorkload retry arguments (lm has none)."""
    kw = {} if args.max_retries is None else dict(
        max_retries=args.max_retries)
    if args.watchdog_ms:
        kw["watchdog_s"] = args.watchdog_ms / 1000.0
    return kw


def _report_events(eng) -> None:
    """The structured incident stream (Engine.events): retries, stalls
    and ladder transitions, counted by kind."""
    events = eng.events()
    if not events:
        return
    counts: dict[str, int] = {}
    for ev in events:
        counts[ev.kind] = counts.get(ev.kind, 0) + 1
    print("  events: " + ", ".join(f"{k} x{n}"
                                   for k, n in sorted(counts.items())))
    for ev in events:
        if ev.kind in ("degrade", "upshift"):
            print(f"    {ev.kind}: {ev.data['from']} -> {ev.data['to']}"
                  f" ({ev.data['reason']})")


def _report_failures(eng, rids) -> str:
    failed = [eng.result(r) for r in rids]
    failed = [r for r in failed if r is not None and r.failure is not None]
    for req in failed[:4]:
        print(f"  req {req.rid} FAILED: {req.failure.code}"
              f" ({req.failure.detail})")
    return f", {len(failed)} failed, {eng.shed} shed" if failed else ""


def required_cache_len(prompt_len: int, max_new: int) -> int:
    """KV positions a request writes: prompt_len prefill steps plus
    max_new - 1 decode steps (the last emitted token is never fed back)."""
    return prompt_len + max_new - 1


def serve_lm(args) -> None:
    need = required_cache_len(args.prompt_len, args.max_new)
    cache_len = args.cache_len if args.cache_len else need
    if cache_len < need:
        raise SystemExit(
            f"--cache-len {cache_len} would overflow: prompt_len"
            f" {args.prompt_len} + max_new {args.max_new} needs >= {need}"
            " cache positions")

    dev = devmod.resolve(args.device)
    cfg = configs.smoke_config(configs.get_config(args.arch))
    params = pm.init_params(model_mod.model_spec(cfg),
                            torch.Generator(dev).manual_seed(0), device=dev)
    eng = Engine(LMDecodeWorkload(cfg, params, max_batch=args.max_batch,
                                  cache_len=cache_len, device=dev),
                 **_engine_kw(args))

    rng = np.random.default_rng(0)
    t0 = time.time()
    rids = [eng.submit(rng.integers(0, cfg.vocab, args.prompt_len),
                       max_new=args.max_new, deadline_s=_deadline_s(args))
            for _ in range(args.requests)]
    rep = eng.run_until_drained()
    dt = time.time() - t0
    total_tokens = sum(len(eng.result(r).tokens_out) for r in rids)
    print(f"served {args.requests} requests / {total_tokens} tokens in "
          f"{dt:.2f}s ({total_tokens / dt:.1f} tok/s, {rep.ticks} ticks, "
          f"cache_len {cache_len}{_report_failures(eng, rids)})")
    for rid in rids[:4]:
        print(f"  req {rid}: {eng.result(rid).tokens_out}")


def serve_stemmer(args) -> None:
    d = corpus.build_dictionary(n_tri=1000, n_quad=120, seed=0)
    store = DictStore(stemmer.RootDictArrays.from_rootdict(
        d, device=args.device), dict_block_r=args.dict_block_r,
        device=args.device)
    eng = Engine(StemmerWorkload(store, block_b=args.block_b,
                                 dict_block_r=args.dict_block_r,
                                 num_buffers=args.num_buffers,
                                 skip_index=not args.full_sweep,
                                 max_inflight=args.inflight,
                                 data_devices=args.devices,
                                 megabatch_tiles=args.megabatch,
                                 persistent=args.persistent,
                                 **_retry_kw(args)), **_engine_kw(args))

    wpr = args.words_per_request
    words, _, _ = corpus.build_corpus(n_words=args.requests * wpr, seed=1)
    enc = corpus.encode_corpus(words)

    t0 = time.time()
    rids = [eng.submit(enc[i * wpr:(i + 1) * wpr],
                       deadline_s=_deadline_s(args))
            for i in range(args.requests)]
    rep = eng.run_until_drained()
    dt = time.time() - t0
    n_words = args.requests * wpr
    print(f"served {args.requests} word-batch requests / {n_words} words in "
          f"{dt:.2f}s ({n_words / dt:.1f} Wps, {rep.ticks} ticks, "
          f"{eng.workload.ticks_launched} launches, dict v{store.version}, "
          f"super-tile {args.devices}x{args.block_b}, megabatch"
          f" {args.megabatch}"
          f"{', persistent' if args.persistent else ''}, "
          f"inflight {args.inflight}{_report_failures(eng, rids)})")
    _report_events(eng)
    for rid in rids[:2]:
        req = eng.result(rid)
        if req.failure is None:
            print(f"  req {rid}: {req.n_words} roots,"
                  f" dict v{req.dict_version}")


def build_documents(n_docs: int, words_per_doc: int, seed: int = 1):
    """Synthesise raw Arabic documents from the conjugated corpus: words
    joined with spaces, an Arabic comma after every 8th word, and a
    rotating proclitic attached to every third word so that the front
    end's stripping path is exercised end to end."""
    words, _, _ = corpus.build_corpus(n_words=n_docs * words_per_doc,
                                      seed=seed)
    pro = ("وال", "ب", "ف", "لل", "ك")
    docs = []
    for i in range(n_docs):
        chunk = words[i * words_per_doc:(i + 1) * words_per_doc]
        toks = [pro[j % len(pro)] + w if j % 3 == 0 else w
                for j, w in enumerate(chunk)]
        toks = [t + "،" if j % 8 == 7 else t for j, t in enumerate(toks)]
        docs.append(" ".join(toks))
    return docs


def edge_documents() -> list[str]:
    """Documents that walk every rule of the text front end: every
    function word, proclitic and enclitic (alone and combined), every
    diacritic and tatweel inside a word, the alef and taa-marbuta
    variants, words longer than MAX_RAW codepoints and than 16 letters,
    stems too short to strip, and empty, whitespace-only, punctuation-only
    and non-Arabic documents."""
    from repro_torch.core import alphabet as ab
    from repro_torch.core import textnorm as tn

    marks = sorted(ab.DIACRITICS) + [ab.TATWEEL]
    return [
        " ".join(tn.FUNCTION_WORDS),
        " ".join(p + "مكتبة" for p in tn.PROCLITICS),
        " ".join("مكتب" + e for e in tn.ENCLITICS),
        " ".join(p + "كاتب" + e for p in tn.PROCLITICS for e in tn.ENCLITICS),
        " ".join("ك" + chr(m) + "ت" + chr(m) + "ب" for m in marks),
        "كـــتـــب الـــكـــتـــاب " + "ـ" * 40,
        " ".join(chr(cp) + "كل" + chr(cp) for cp in sorted(ab.NORMALISE)),
        "ا" * 40 + " " + "ب" * 17 + " " + "كتب" * 12 + " و" + "سـ" * 20,
        "ك" + "\u0651" * 40 + "تب " + "وال" + "م" * 30 + "هما",
        "وكل بها لله ولها فهم كم هما",
        "", " ", "\n\t  \u00a0", "،؛؟!.,«»", "abc 123 ٣٤٥ xyz",
        "كتب،كتب؛كتب. كتب?كتب",
    ]


def serve_text(args) -> None:
    d = corpus.build_dictionary(n_tri=1000, n_quad=120, seed=0)
    store = DictStore(stemmer.RootDictArrays.from_rootdict(
        d, device=args.device), dict_block_r=args.dict_block_r,
        device=args.device)
    eng = Engine(TextAnalysisWorkload(store, block_b=args.block_b,
                                      char_block=args.char_block,
                                      frontend=args.frontend,
                                      dict_block_r=args.dict_block_r,
                                      num_buffers=args.num_buffers,
                                      skip_index=not args.full_sweep,
                                      max_inflight=args.inflight,
                                      data_devices=args.devices,
                                      megabatch_tiles=args.megabatch,
                                      persistent=args.persistent,
                                      **_retry_kw(args)), **_engine_kw(args))

    docs = build_documents(args.requests, args.words_per_request)
    n_bytes = sum(len(doc.encode("utf-8")) for doc in docs)
    t0 = time.time()
    rids = [eng.submit(doc, deadline_s=_deadline_s(args)) for doc in docs]
    rep = eng.run_until_drained()
    dt = time.time() - t0
    n_words = sum(eng.result(r).n_words for r in rids)
    print(f"served {args.requests} documents / {n_bytes} bytes /"
          f" {n_words} words in {dt:.2f}s ({n_bytes / dt:.0f} B/s,"
          f" {n_words / dt:.1f} Wps, {rep.ticks} ticks,"
          f" {eng.workload.ticks_launched} launches,"
          f" frontend {args.frontend}, megabatch {args.megabatch}"
          f"{', persistent' if args.persistent else ''},"
          f" inflight {args.inflight}{_report_failures(eng, rids)})")
    _report_events(eng)
    for rid in rids[:2]:
        req = eng.result(rid)
        if req.failure is not None:
            continue
        root, src, span = req.analyses()[0][0]
        print(f"  req {rid}: {req.n_words} tokens, first root {root!r}"
              f" (src {src}, bytes {span})")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=("lm", "stemmer", "text"),
                    default="lm")
    ap.add_argument("--requests", type=int, default=8)
    # lm knobs
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--cache-len", type=int, default=0,
                    help="KV cache positions per slot (default: derived"
                         " from --prompt-len + --max-new; explicit values"
                         " too small for that are rejected)")
    # stemmer and text knobs
    ap.add_argument("--words-per-request", type=int, default=64)
    ap.add_argument("--block-b", type=int, default=256)
    ap.add_argument("--inflight", type=int, default=2,
                    help="dispatch ring depth: outstanding megakernel"
                         " launches (1 = synchronous tick, overlap off)")
    ap.add_argument("--devices", type=int, default=1,
                    help="data devices per super-tile: each launch is a"
                         " [devices * block_b, 16] tile split over a"
                         " ('data',) mesh (dist.shard_batch)")
    ap.add_argument("--dict-block-r", type=int, default=8,
                    help="streamed dictionary tile height in 128-lane"
                         " rows; also pins the publish-time tile stream")
    ap.add_argument("--num-buffers", type=int, default=2,
                    help="the reference's streamed copy pipeline depth"
                         " (1-4): checked, the same roots for every value")
    ap.add_argument("--full-sweep", action="store_true",
                    help="the reference's full sweep (its tile-visit skip"
                         " index off): the same roots either way")
    ap.add_argument("--megabatch", type=int, default=1,
                    help="block_b tiles coalesced per launch")
    ap.add_argument("--persistent", action="store_true",
                    help="persistent serving kernel: one launch walks a"
                         " descriptor ring over the megabatch's tiles")
    ap.add_argument("--char-block", type=int, default=2048,
                    help="codepoint-tile bucket for the text front end"
                         " (requests round up to a pow2 multiple)")
    ap.add_argument("--frontend", choices=("kernel", "reference", "host"),
                    default="kernel",
                    help="text front end: the kernel (K4), the plain"
                         " scatter-based reference, or the Python oracle")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda runs the CUDA kernels; cpu their plain"
                         " PyTorch versions")
    # robustness
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request deadline in milliseconds; expired"
                         " requests finish with FailureInfo code"
                         " 'deadline' (0 = no deadline)")
    ap.add_argument("--max-retries", type=int, default=None,
                    help="launch retries before bisect/quarantine"
                         " (stemmer/text only; 0 = strict fail-fast,"
                         " default 2)")
    ap.add_argument("--queue-cap", type=int, default=0,
                    help="admission-control bound on queued requests"
                         " (0 = unbounded)")
    ap.add_argument("--on-full", choices=Engine.ON_FULL, default="raise",
                    help="full-queue policy: raise QueueFull, shed the"
                         " new request (FailureInfo 'shed'), or block"
                         " until a place frees")
    # crash safety and degraded modes
    ap.add_argument("--journal", default="", metavar="PATH",
                    help="write-ahead request journal: every accepted"
                         " request is durable before it is served, so a"
                         " killed server restarts through"
                         " Engine.recover(PATH) losing no request")
    ap.add_argument("--watchdog-ms", type=float, default=0.0,
                    help="persistent-kernel watchdog: a launch older"
                         " than this is abandoned and its words"
                         " re-dispatched down the megabatch path"
                         " (requires --persistent; 0 = off)")
    ap.add_argument("--degrade", choices=("on", "off"), default="off",
                    help="degradation ladder: under sustained faults or"
                         " queue pressure the serving mode downshifts"
                         " persistent -> megabatch -> per-tile ->"
                         " streamed-dict -> fewer devices, and upshifts"
                         " when healthy"
                         " (stemmer/text only)")
    args = ap.parse_args(argv)
    if args.requests < 1 or args.words_per_request < 1:
        ap.error("--requests and --words-per-request must be >= 1")
    if args.deadline_ms < 0:
        ap.error("--deadline-ms must be >= 0")
    if args.queue_cap < 0:
        ap.error("--queue-cap must be >= 0")
    if args.max_retries is not None and args.max_retries < 0:
        ap.error("--max-retries must be >= 0")
    if args.on_full != "raise" and not args.queue_cap:
        ap.error(f"--on-full {args.on_full} needs --queue-cap > 0"
                 " (an unbounded queue is never full)")
    if args.workload == "lm" and args.max_retries is not None:
        ap.error("--max-retries applies to the stemmer/text workloads"
                 " (the LM decode loop has no launch retry path)")
    # the crash-safety flags are checked before any engine exists, so a
    # bad combination never half-builds serving state
    if args.watchdog_ms < 0:
        ap.error("--watchdog-ms must be >= 0")
    if args.watchdog_ms and not args.persistent:
        ap.error("--watchdog-ms guards the persistent descriptor ring;"
                 " it requires --persistent")
    if args.watchdog_ms and args.workload == "lm":
        ap.error("--watchdog-ms applies to the stemmer/text workloads")
    if args.degrade == "on" and args.workload == "lm":
        ap.error("--degrade applies to the stemmer/text workloads (the"
                 " LM decode loop has no mode ladder)")
    if args.devices < 1:
        ap.error("--devices must be >= 1")
    if args.devices > 1:
        if args.workload == "lm":
            ap.error("--devices applies to the stemmer/text workloads")
        if args.persistent:
            ap.error("--persistent is single-device (the descriptor ring"
                     " is one kernel's); use --megabatch with --devices")
        from repro_torch.launch import mesh as mesh_mod

        try:
            mesh_mod.make_data_mesh(args.devices, device=args.device)
        except (RuntimeError, ValueError) as e:
            ap.error(f"--devices {args.devices}: {e}")
    if args.workload == "text":
        serve_text(args)
    elif args.workload == "stemmer":
        serve_stemmer(args)
    else:
        serve_lm(args)


if __name__ == "__main__":
    main()

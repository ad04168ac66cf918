"""Serving launcher: the stemmer workload through the port's Engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --workload stemmer --requests 16
  PYTHONPATH=src python -m repro_torch.launch.serve --workload stemmer --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --workload stemmer \
      --megabatch 4 --persistent

Runs on the CUDA device unless ``--device cpu`` is given; with no CUDA
device present the default raises instead of falling back to the CPU.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.core import corpus, stemmer
from repro_torch.serve import DictStore, Engine, StemmerWorkload


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
                                 megabatch_tiles=args.megabatch,
                                 persistent=args.persistent))

    wpr = args.words_per_request
    words, _, _ = corpus.build_corpus(n_words=args.requests * wpr, seed=1)
    enc = corpus.encode_corpus(words)

    t0 = time.time()
    rids = [eng.submit(enc[i * wpr:(i + 1) * wpr])
            for i in range(args.requests)]
    rep = eng.run_until_drained()
    dt = time.time() - t0
    n_words = args.requests * wpr
    print(f"served {args.requests} word-batch requests / {n_words} words in "
          f"{dt:.2f}s ({n_words / dt:.1f} Wps, {rep.ticks} ticks, "
          f"{eng.workload.ticks_launched} launches, dict v{store.version}, "
          f"super-tile 1x{args.block_b}, megabatch {args.megabatch}"
          f"{', persistent' if args.persistent else ''}, "
          f"inflight {args.inflight})")
    for rid in rids[:2]:
        req = eng.result(rid)
        print(f"  req {rid}: {req.n_words} roots, dict v{req.dict_version}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=("stemmer",), default="stemmer")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--words-per-request", type=int, default=64)
    ap.add_argument("--block-b", type=int, default=256)
    ap.add_argument("--inflight", type=int, default=2,
                    help="dispatch ring depth: outstanding megakernel"
                         " launches (1 = synchronous tick, overlap off)")
    ap.add_argument("--dict-block-r", type=int, default=8,
                    help="streamed dictionary tile height in 128-lane"
                         " rows; also pins the publish-time tile stream")
    ap.add_argument("--num-buffers", type=int, default=2,
                    help="streamed-path copy pipeline depth (1 = no"
                         " overlap, 2 = double buffering, up to 4)")
    ap.add_argument("--full-sweep", action="store_true",
                    help="disable the tile-visit skip index (sweep every"
                         " dictionary tile; the skip-off baseline)")
    ap.add_argument("--megabatch", type=int, default=1,
                    help="block_b tiles coalesced per launch")
    ap.add_argument("--persistent", action="store_true",
                    help="persistent serving kernel: one launch walks a"
                         " descriptor ring over the megabatch's tiles")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda runs the CUDA kernels; cpu their plain"
                         " PyTorch versions")
    args = ap.parse_args(argv)
    if args.requests < 1 or args.words_per_request < 1:
        ap.error("--requests and --words-per-request must be >= 1")
    serve_stemmer(args)


if __name__ == "__main__":
    main()

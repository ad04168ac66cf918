"""Serve the stemmer megakernel behind the port's workload-agnostic
Engine, with a versioned dictionary hot swap landing mid-stream.

The PyTorch counterpart of ``examples/serve_stemmer.py``, with its sizes,
seeds and lines. Word-batch requests coalesce into fixed [block_b, 16]
tiles (one K1 launch a tick on a card); after a few ticks a grown lexicon
is publish()ed and picked up by the next tile launch without an engine
restart. Every served word is then checked bit-identical to
``core.stemmer.stem_batch`` (the plain sorted path) under the dictionary
version that served it; the script exits non-zero on any mismatch.

A second pass re-serves the same queue with one injected launch failure
and reads the recovery off ``Engine.events()``, the structured incident
stream.

  PYTHONPATH=src python examples/torch_serve_stemmer.py [--device cuda:0]
  PYTHONPATH=src python examples/torch_serve_stemmer.py --device cpu
"""
import argparse
import time

import numpy as np

from repro_torch import device as devmod
from repro_torch.core import corpus, stemmer
from repro_torch.serve import (DictStore, Engine, FaultInjector, FaultPlan,
                               FaultSpec, StemmerWorkload)

N_REQUESTS, WORDS_PER_REQ, BLOCK_B = 12, 40, 64


def main(argv=None):
    """-> {"words": words checked, "versions": {version: words served},
    "retries": retries seen in the faulted pass}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda:0",
                    help="where the engine serves (cuda:N or cpu)")
    args = ap.parse_args(argv)
    dev = devmod.resolve(args.device)

    d = corpus.build_dictionary(n_tri=800, n_quad=100, seed=0)
    arrays = stemmer.RootDictArrays.from_rootdict(d, device=dev)
    store = DictStore(arrays, device=dev)
    eng = Engine(StemmerWorkload(store, block_b=BLOCK_B))

    words, _, _ = corpus.build_corpus(n_words=N_REQUESTS * WORDS_PER_REQ,
                                      seed=1)
    enc = corpus.encode_corpus(words)

    t0 = time.time()
    rids = [eng.submit(enc[i * WORDS_PER_REQ:(i + 1) * WORDS_PER_REQ])
            for i in range(N_REQUESTS)]
    for _ in range(3):           # a few ticks on dict v0 ...
        eng.step()
    v1 = store.publish(corpus.grow_root_arrays(arrays, 4096, seed=7))
    rep = eng.run_until_drained()  # ... the rest on the hot-swapped v1
    dt = time.time() - t0

    n_words = N_REQUESTS * WORDS_PER_REQ
    versions = np.concatenate([eng.result(r).dict_versions for r in rids])
    split = {int(v): int((versions == v).sum()) for v in np.unique(versions)}
    print(f"served {N_REQUESTS} requests / {n_words} words in {dt:.2f}s "
          f"({n_words / dt:.1f} Wps, {rep.ticks} ticks)")
    print(f"dict versions served: {split} (hot swap published v{v1} "
          f"mid-stream)")

    # bit-exact parity per served version against the batch stemmer
    checked = 0
    for rid in rids:
        req = eng.result(rid)
        if not (req.done and req.dict_versions.shape == (req.n_words,)):
            raise SystemExit(f"req {rid}: not served whole")
        for v in np.unique(req.dict_versions):
            da = store.get(int(v)).arrays
            mask = req.dict_versions == v
            want_r, want_s = stemmer.stem_batch(req.words[mask], da,
                                                device=dev)
            if not np.array_equal(req.roots[mask], want_r.cpu().numpy()):
                raise SystemExit(f"req {rid}: roots diverge from stem_batch"
                                 f" under dict v{v}")
            if not np.array_equal(req.sources[mask], want_s.cpu().numpy()):
                raise SystemExit(f"req {rid}: sources diverge from"
                                 f" stem_batch under dict v{v}")
            checked += int(mask.sum())
    if checked != n_words:
        raise SystemExit(f"checked {checked} of {n_words} words")
    print(f"parity ok: {checked} words bit-identical to stem_batch under "
          f"their serving dict version")

    # -- faulted re-serve, observed through the structured event stream
    inj = FaultInjector(FaultPlan(specs=(FaultSpec("dispatch", at=1),)))
    eng2 = Engine(StemmerWorkload(DictStore(arrays, device=dev),
                                  block_b=BLOCK_B, injector=inj))
    rids2 = [eng2.submit(enc[i * WORDS_PER_REQ:(i + 1) * WORDS_PER_REQ])
             for i in range(N_REQUESTS)]
    if not eng2.run_until_drained().drained:
        raise SystemExit("the faulted pass did not drain")
    retries = [e for e in eng2.events() if e.kind == "retry"]
    if not (len(retries) == 1 and retries[0].data["attempt"] == 1):
        raise SystemExit(f"expected one retry, saw {retries}")
    if any(e.kind == "failure" for e in eng2.events()):
        raise SystemExit("the faulted pass failed a request")
    for rid in rids2:
        req = eng2.result(rid)
        want_r, _ = stemmer.stem_batch(req.words, arrays, device=dev)
        if not np.array_equal(req.roots, want_r.cpu().numpy()):
            raise SystemExit(f"req {rid}: the faulted pass diverges")
    print(f"fault recovery ok: retry observed via Engine.events()"
          f" (rids {retries[0].data['rids']}), drain bit-identical")
    return {"words": checked, "versions": split, "retries": len(retries)}


if __name__ == "__main__":
    main()

"""Build a root -> (doc, position) inverted index on the device, checked.

The PyTorch counterpart of ``examples/index_corpus.py``, with its sizes,
seeds and lines. A seeded synthetic corpus (the ``core/corpus.py``
token-table stream) goes through the chunked index build (the stemmer
megakernel K1 chained into the postings kernel K5 on a card, no per-word
host work), and the index is checked bit-identical to the host reference
build (``index.reference``: plain stem_batch ids + a stable argsort):
same per-root counts, same postings, same within-root order. A
checkpointed rebuild resumed halfway must give the same index again. The
script exits non-zero on any mismatch.

  PYTHONPATH=src python examples/torch_index_corpus.py [--device cuda:0]
  PYTHONPATH=src python examples/torch_index_corpus.py --device cpu
"""
import argparse
import itertools
import tempfile
import time

import numpy as np

from repro_torch import device as devmod
from repro_torch import index as ix
from repro_torch.core import alphabet as ab
from repro_torch.core import corpus, stemmer

N_WORDS = 16384
CHUNK = 4096
WORDS_PER_DOC = 256


def check(ok, what):
    if not ok:
        raise SystemExit(f"index_corpus: {what}")


def main(argv=None):
    """-> the index (a RootIndex) built over the stream."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda:0",
                    help="where the index is built (cuda:N or cpu)")
    args = ap.parse_args(argv)
    dev = devmod.resolve(args.device)

    d = corpus.build_dictionary(n_tri=800, n_quad=100, seed=0)
    arrays = stemmer.RootDictArrays.from_rootdict(d, device=dev)
    vocab = ix.build_vocab(arrays)
    table = corpus.build_token_table()

    def stream():
        return corpus.stream_corpus_words(
            N_WORDS, seed=17, chunk_words=CHUNK,
            words_per_doc=WORDS_PER_DOC, table=table)

    t0 = time.time()
    idx = ix.build_corpus_index(stream(), arrays, block_b=1024,
                                block_w=1024, device=dev)
    dt = time.time() - t0
    print(f"indexed {N_WORDS} words / {N_WORDS // WORDS_PER_DOC} docs in"
          f" {dt:.2f}s ({N_WORDS / dt:.0f} Wps): {idx.n_postings} postings"
          f" over {int((idx.counts > 0).sum())} of {idx.n_roots} roots")

    # -- bit-exact parity vs the host reference ----------------------------
    chunks = list(stream())
    words = np.concatenate([c.words for c in chunks])
    docs = np.concatenate([c.doc_ids for c in chunks]).astype(np.int32)
    poss = np.concatenate([c.positions for c in chunks])
    ids = ix.host_root_ids(words, arrays, vocab)
    want_counts, want_docs, want_poss = ix.host_index(ids, docs, poss,
                                                      len(vocab))
    check(np.array_equal(idx.counts, want_counts), "counts differ")
    check(np.array_equal(idx.docs, want_docs), "docs differ")
    check(np.array_equal(idx.positions, want_poss), "positions differ")
    print(f"parity ok: {idx.n_postings} postings bit-identical to the"
          " host stem_batch -> stable-argsort reference")

    # -- checkpoint half the build, resume, same index ---------------------
    with tempfile.TemporaryDirectory() as ckpt:
        half = N_WORDS // CHUNK // 2
        ix.build_corpus_index(itertools.islice(stream(), half), arrays,
                              checkpoint_dir=ckpt, block_b=1024,
                              block_w=1024, device=dev)
        idx2 = ix.build_corpus_index(stream(), arrays, checkpoint_dir=ckpt,
                                     resume=True, block_b=1024,
                                     block_w=1024, device=dev)
    for name in ("counts", "docs", "positions"):
        check(np.array_equal(getattr(idx2, name), getattr(idx, name)),
              f"the resumed index's {name} differ")
    print(f"resume ok: index rebuilt from a {half}-chunk checkpoint is"
          " bit-identical")

    # -- the retrieval view: top roots and one postings lookup -------------
    top = np.argsort(idx.counts)[::-1][:5]
    for r in top:
        key = int(idx.root_keys[r])
        root = ab.decode_word(ab.unpack_key(key))
        print(f"  root {root!r}: {int(idx.counts[r])} postings, first at"
              f" doc {int(idx.docs[idx.offsets[r]])}"
              f" pos {int(idx.positions[idx.offsets[r]])}")
    dd, pp = idx.postings_for(int(idx.root_keys[top[0]]))
    check(len(dd) == int(idx.counts[top[0]]), "postings_for's length")
    check((np.diff(dd.astype(np.int64) * (max(pp) + 1) + pp) > 0).all(),
          "postings not sorted by (doc, position)")
    print("lookup ok: postings_for returns sorted (doc, position) runs")
    return idx


if __name__ == "__main__":
    main()

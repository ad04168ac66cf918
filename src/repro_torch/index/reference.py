"""Host numpy reference for the inverted-index build.

Stemming truth comes from the port's plain stemmer
(``core.stemmer.stem_batch``, sorted search), and the postings build is
plain vectorised numpy: ``bincount`` for the per-root counts and one
stable ``argsort`` for the CSR layout. The device build (the stemmer
kernels, the postings kernel, the scatter) must reproduce it bit for bit:
same counts, same postings, same within-root order (global word index).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import pyref
from repro_torch.core import stemmer as core_stemmer


def host_root_ids(words: np.ndarray, arrays, vocab: np.ndarray, *,
                  chunk: int = 65536) -> np.ndarray:
    """words int32[W, 16] -> vocab ids int32[W] via the plain stemmer, run
    on the dictionary's device. Chunked so that multi-million-word corpora
    make no giant intermediate; unmatched words get the drop id
    ``len(vocab)``."""
    arrays, _, _ = core_stemmer.unwrap_dict(arrays)
    n_roots = len(vocab)
    out = np.empty(words.shape[0], np.int32)
    for i in range(0, words.shape[0], chunk):
        root, source = core_stemmer.stem_batch(words[i:i + chunk], arrays,
                                               device=arrays.device)
        key = core_stemmer.pack_keys(root).cpu().numpy()
        source = source.cpu().numpy()
        at = np.searchsorted(vocab, key)
        found = vocab[np.minimum(at, n_roots - 1)] == key
        out[i:i + chunk] = np.where(found & (source != pyref.SRC_NONE),
                                    at, n_roots)
    return out


def host_index(ids: np.ndarray, doc_ids: np.ndarray, positions: np.ndarray,
               n_roots: int):
    """(ids, doc, pos) -> (counts int64[n_roots], docs, poss) CSR arrays.

    One stable argsort over the root ids keeps postings within a root in
    global word order, the layout ``kernels.postings.finish_postings``
    produces on the device.
    """
    valid = ids < n_roots
    order = np.argsort(ids[valid], kind="stable")
    counts = np.bincount(ids[valid], minlength=n_roots).astype(np.int64)
    return counts, doc_ids[valid][order].astype(np.int32), \
        positions[valid][order].astype(np.int32)

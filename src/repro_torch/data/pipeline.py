"""Data pipeline: synthetic LM streams + the paper's morphological
analyzer as a preprocessing operator.

The counterpart of ``repro.data.pipeline``. ``morph_lm_batches`` encodes
a stream of Arabic verb forms to character tokens while the batched
stemmer produces per-word root ids, usable as auxiliary labels
(root-prediction heads) or for root-aware vocabulary reduction. Streams
are numpy; the stemmer runs on ``device`` (the card by default).
"""
from __future__ import annotations

import numpy as np

from repro_torch import device as devmod
from repro_torch.core import alphabet as ab
from repro_torch.core import corpus as corpus_mod
from repro_torch.core import stemmer


def synthetic_lm_batches(vocab: int, batch: int, seq: int, seed: int = 0,
                         effective_vocab: int | None = None,
                         branching: int = 4):
    """Endless synthetic token batches (markov chain, learnable signal).

    effective_vocab restricts the emitted ids (< vocab) so small smoke
    models can visibly learn within tens of steps.
    """
    rng = np.random.default_rng(seed)
    ev = min(effective_vocab or vocab, vocab)
    # fixed bigram table so the LM example has signal to learn
    trans = rng.integers(0, ev, size=(ev, branching)).astype(np.int32)
    while True:
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, ev, size=batch)
        for t in range(seq):
            choice = rng.integers(0, branching, size=batch)
            toks[:, t + 1] = trans[toks[:, t], choice]
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


class MorphPreprocessor:
    """Batched root extraction as a pipeline operator.

    backend is any core.stemmer Compare backend ("sorted" / "dense" /
    "pallas" / "fused"). For the fused backend, residency picks the
    megakernel's dictionary layout ("resident" / "streamed" / "auto").
    The stemmer runs on ``device``; inputs and outputs are numpy.
    """

    def __init__(self, n_tri=2000, n_quad=200, backend="sorted", seed=0,
                 residency="auto", device=devmod.DEFAULT_DEVICE):
        self.rootdict = corpus_mod.build_dictionary(n_tri, n_quad, seed)
        self.arrays = stemmer.RootDictArrays.from_rootdict(self.rootdict,
                                                           device=device)
        self.backend = backend
        self.residency = residency
        self.device = self.arrays.device
        # root id table: sorted packed keys; id == searchsorted rank + 1
        keys = sorted(
            {ab.pack_key(r) for r in self.rootdict.tri}
            | {ab.pack_key(r) for r in self.rootdict.quad}
            | {ab.pack_key(r) for r in self.rootdict.bi})
        self._id_keys = np.asarray(keys, np.int64)  # sorted, 0 = none
        self.n_roots = len(keys) + 1

    def __call__(self, words: list[str]):
        """words -> (char_tokens int32[B,16], root_ids int32[B])."""
        enc = corpus_mod.encode_corpus(words)
        roots, _src = stemmer.stem_batch(enc, self.arrays,
                                         backend=self.backend,
                                         residency=self.residency,
                                         device=self.device)
        roots = roots.cpu().numpy().astype(np.int64)
        keys = (((roots[:, 0] * 64 + roots[:, 1]) * 64 + roots[:, 2]) * 64
                + roots[:, 3])
        # vectorised key -> dense id: rank lookup in the sorted key table
        idx = np.searchsorted(self._id_keys, keys)
        idx_c = np.minimum(idx, len(self._id_keys) - 1)
        ids = np.where(self._id_keys[idx_c] == keys, idx_c + 1,
                       0).astype(np.int32)
        return enc, ids


def morph_lm_batches(batch_words: int, seq: int, seed: int = 0,
                     preproc: MorphPreprocessor | None = None):
    """Arabic char-level LM stream with root-id auxiliary labels.

    Words are conjugated verb forms (corpus.build_corpus); tokens are
    6-bit char codes (vocab = alphabet.N_CODES + separator); labels shift
    by one. Each chunk carries ONLY the root ids of the words whose
    characters appear in that chunk ("root_ids"), plus the half-open
    word-index span it covers ("word_span"). Without ``preproc`` the
    stemmer runs on the default device.
    """
    pre = preproc or MorphPreprocessor(seed=seed)
    sep = ab.N_CODES  # word separator token
    vocab = ab.N_CODES + 1
    epoch = 0
    while True:
        words, _truths, _ = corpus_mod.build_corpus(
            n_words=batch_words, seed=seed + epoch)
        enc, root_ids = pre(words)
        stream, word_of = [], []
        for wi, row in enumerate(enc):
            for c in row:
                if c:
                    stream.append(int(c))
                    word_of.append(wi)
            stream.append(sep)
            word_of.append(wi)  # the separator still belongs to word wi
        n_tok = (len(stream) // (seq + 1)) * (seq + 1)
        toks = np.asarray(stream[:n_tok], np.int32).reshape(-1, seq + 1)
        spans = np.asarray(word_of[:n_tok], np.int32).reshape(-1, seq + 1)
        for i in range(toks.shape[0]):
            w0, w1 = int(spans[i, 0]), int(spans[i, -1]) + 1
            yield {
                "tokens": toks[i:i + 1, :-1],
                "labels": toks[i:i + 1, 1:].copy(),
                "vocab": vocab,
                "root_ids": root_ids[w0:w1],
                "word_span": (w0, w1),
            }
        epoch += 1

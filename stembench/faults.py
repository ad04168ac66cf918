"""The timed path broken underneath a run, to show that ``correct`` fails.

``control``: the plain reference put in the program's place with the
paper's infix processing off, a guarantee both configurations state.
The faults a cell can have: ``unchanged`` (a launch that leaves its
outputs as they were made, empty), ``half`` (half of a launch's words
left out), ``altered`` (one answer a launch altered where it is made) and,
for documents, ``altered_span`` (one byte span a request altered in the
text front end). A served launch's checksum is taken of the broken
outputs, as the device would take it, so the ring accepts them.
"""
from __future__ import annotations

import contextlib

import numpy as np

from stembench import reference

SERVE = ("control", "unchanged", "half", "altered", "altered_span")
INDEX = ("control", "unchanged", "half", "altered")


def _torch(a, device):
    import torch
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


@contextlib.contextmanager
def broken(entry: str, how: str, dictionary):
    """Within the block, the program's kernel entry for ``entry``
    ("serve" or "index") is broken as ``how`` says."""
    from repro_torch.kernels import ops

    control = reference.Stemmer(dictionary, infix=False)
    if entry == "serve":
        name, orig = "extract_roots_fused", ops.extract_roots_fused

        def fake(words, roots, *, block_b=256, with_checksum=False,
                 device="cuda", **kw):
            if how == "control":
                r, s = control.stem_rows(np.asarray(
                    words.cpu() if hasattr(words, "cpu") else words))
                r, s = _torch(r, words.device), _torch(s, words.device)
            else:
                r, s = orig(words, roots, block_b=block_b, device=device,
                            **kw)
                r, s = r.clone(), s.clone()
                if how == "unchanged":
                    r.zero_()
                    s.zero_()
                elif how == "half":
                    r[r.shape[0] // 2:] = 0
                    s[s.shape[0] // 2:] = 0
                elif how == "altered":
                    r[0, 0] = r[0, 0] % 33 + 1
            if with_checksum:
                return r, s, ops.tile_checksum(r, s, block_b=block_b)
            return r, s

        if how == "altered_span":
            name, orig = "text_to_words", ops.text_to_words

            def fake(chars, **kw):  # noqa: F811
                words, spans, n = orig(chars, **kw)
                spans = spans.clone()
                spans[0, 1] += 1
                return words, spans, n
    else:
        name, orig = "build_root_index", ops.build_root_index

        def fake(words, roots, vocab, doc_ids, positions, **kw):
            if how == "control":
                rows = np.asarray(words)
                keys = reference.root_keys(*control.stem_rows(rows))
                v = np.asarray(vocab.cpu() if hasattr(vocab, "cpu")
                               else vocab).astype(np.int64)
                at = np.clip(np.searchsorted(v, keys), 0, v.size - 1)
                ids = np.where((keys >= 0) & (v[at] == keys), at, v.size)
                keep = ids < v.size
                order = np.argsort(ids[keep], kind="stable")
                counts = np.bincount(ids[keep], minlength=v.size)[:v.size]
                dev = kw.get("device", "cuda")
                docs = np.asarray(doc_ids)[keep][order]
                poss = np.asarray(positions)[keep][order]
                return (_torch(counts.astype(np.int32), dev),
                        _torch(docs.astype(np.int32), dev),
                        _torch(poss.astype(np.int32), dev),
                        _torch(np.int32(docs.size), dev))
            if how == "half":
                n = len(words) // 2
                words, doc_ids, positions = (words[:n], doc_ids[:n],
                                             positions[:n])
            counts, docs, poss, n_post = orig(words, roots, vocab, doc_ids,
                                              positions, **kw)
            if how == "unchanged":
                counts = counts.clone().zero_()
                n_post = n_post.clone().zero_()
            elif how == "altered":
                docs = docs.clone()
                docs[0] += 1
            return counts, docs, poss, n_post

    setattr(ops, name, fake)
    try:
        yield
    finally:
        setattr(ops, name, orig)

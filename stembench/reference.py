"""The plain reference that decides ``correct``: the paper's stemmer, the
host text front end's word geometry and the index's postings, in Python
and NumPy.

A frozen copy of the oracle ``repro_torch.core.pyref.extract_root``
(stage 5's priority: direct tri > direct quad > restored tri (ا -> و) >
de-infixed quad -> tri > de-infixed tri -> bi), over packed keys of the
dictionary the benchmark made, and of the index's layout (a root's
postings in global word order). It imports nothing of the program and
reads nothing the program made: the dictionary, the token table and the
traffic are the benchmark's own.

Traffic is drawn from a token table of a few thousand distinct tokens, so
the reference stems each distinct word row once and gathers.
"""
from __future__ import annotations

import numpy as np

from stembench import arabic as ar

SRC_NONE, SRC_TRI, SRC_QUAD, SRC_RESTORED, SRC_DEINFIX_TRI, SRC_DEINFIX_BI = \
    range(6)


def _key(codes) -> int:
    return ar.pack_key(codes)


class Stemmer:
    """Root extraction of word rows against a :class:`generate.Dictionary`.

    ``infix=False`` switches the paper's infix processing off: the
    control, which breaks a guarantee the configurations state."""

    def __init__(self, dictionary, *, infix: bool = True):
        self.tri = frozenset(dictionary.tri.tolist())
        self.quad = frozenset(dictionary.quad.tolist())
        self.bi = frozenset(dictionary.bi.tolist())
        self.infix = infix
        self._memo: dict[bytes, tuple] = {}

    def _stems(self, word: list[int]):
        """Stages 1-4: the trilateral and quadrilateral stems, prefix cut
        ascending."""
        n = len(word)
        pp, run, seen_yeh = [], True, False
        for i in range(min(5, n)):
            if seen_yeh:
                run = False
            run = run and word[i] in ar.PREFIX_CODES
            pp.append(run)
            if word[i] == ar.YEH:
                seen_yeh = True
        ps, run = [False] * n, True
        for j in range(n - 1, -1, -1):
            run = run and word[j] in ar.SUFFIX_CODES
            ps[j] = run
        tri, quad = [], []
        for p in range(-1, 5):
            if p != -1 and not (p < len(pp) and pp[p]):
                continue
            for length, out in ((3, tri), (4, quad)):
                s = p + 1 + length
                if s <= n and (s == n or ps[s]):
                    out.append(tuple(word[p + 1:s]))
        return tri, quad

    def root(self, row) -> tuple[tuple, int]:
        """One word row -> (root codes, source tag)."""
        word = [int(c) for c in row if int(c) != 0]
        tri, quad = self._stems(word)
        for st in tri:
            if _key(st) in self.tri:
                return st, SRC_TRI
        for st in quad:
            if _key(st) in self.quad:
                return st, SRC_QUAD
        if self.infix:
            for st in tri:
                if st[1] == ar.ALEF and _key((st[0], ar.WAW, st[2])) in self.tri:
                    return (st[0], ar.WAW, st[2]), SRC_RESTORED
            for st in quad:
                if st[1] in ar.INFIX_CODES and _key((st[0], st[2], st[3])) \
                        in self.tri:
                    return (st[0], st[2], st[3]), SRC_DEINFIX_TRI
            for st in tri:
                if st[1] in ar.INFIX_CODES and _key((st[0], st[2])) in self.bi:
                    return (st[0], st[2]), SRC_DEINFIX_BI
        return (), SRC_NONE

    def stem_rows(self, rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """int32[n, 16] word rows -> (roots int32[n, 4] zero-padded codes,
        sources int32[n]); each distinct row is stemmed once."""
        rows = np.ascontiguousarray(rows, np.int32)
        uniq, inv = np.unique(rows, axis=0, return_inverse=True)
        roots = np.zeros((uniq.shape[0], 4), np.int32)
        sources = np.zeros(uniq.shape[0], np.int32)
        for i, row in enumerate(uniq):
            got = self._memo.get(row.tobytes())
            if got is None:
                got = self._memo[row.tobytes()] = self.root(row)
            codes, src = got
            roots[i, :len(codes)] = codes
            sources[i] = src
        inv = inv.reshape(-1)
        return roots[inv], sources[inv]


def root_keys(roots: np.ndarray, sources: np.ndarray) -> np.ndarray:
    """Each word's packed root key, or -1 where no root was found."""
    r = roots.astype(np.int64)
    key = ((r[:, 0] * 64 + r[:, 1]) * 64 + r[:, 2]) * 64 + r[:, 3]
    return np.where(sources != SRC_NONE, key, -1)


class Index:
    """A root index by key: ``keys`` sorted, root i's postings at
    ``docs/positions[starts[i]: starts[i] + counts[i]]`` in word order."""

    def __init__(self, keys, counts, starts, docs, positions):
        self.keys, self.counts, self.starts = keys, counts, starts
        self.docs, self.positions = docs, positions

    @classmethod
    def build(cls, word_keys, doc_ids, positions) -> "Index":
        valid = word_keys >= 0
        order = np.argsort(word_keys[valid], kind="stable")
        k = word_keys[valid][order]
        keys, counts = np.unique(k, return_counts=True)
        return cls(keys, counts.astype(np.int64),
                   np.cumsum(counts) - counts,
                   np.asarray(doc_ids)[valid][order].astype(np.int64),
                   np.asarray(positions)[valid][order].astype(np.int64))

    @classmethod
    def of_program(cls, idx) -> "Index":
        """The program's RootIndex (root_keys, counts, offsets, docs,
        positions), its empty roots left out."""
        nz = np.asarray(idx.counts) > 0
        return cls(np.asarray(idx.root_keys, np.int64)[nz],
                   np.asarray(idx.counts, np.int64)[nz],
                   np.asarray(idx.offsets, np.int64)[nz],
                   np.asarray(idx.docs, np.int64),
                   np.asarray(idx.positions, np.int64))


def wrong_roots(got: Index, want: Index) -> int:
    """Root keys whose postings differ: present on one side only, another
    count, or a posting's document or position differs."""
    common, ig, iw = np.intersect1d(got.keys, want.keys,
                                    return_indices=True)
    wrong = got.keys.size + want.keys.size - 2 * common.size
    same = got.counts[ig] == want.counts[iw]
    wrong += int((~same).sum())
    lens = want.counts[iw][same]
    if lens.size == 0:
        return wrong
    seg = np.repeat(np.arange(lens.size), lens)
    within = np.arange(int(lens.sum())) - np.repeat(np.cumsum(lens) - lens,
                                                    lens)
    gi = got.starts[ig][same][seg] + within
    wi = want.starts[iw][same][seg] + within
    n = got.docs.size
    inside = (gi >= 0) & (gi < n)
    gic = np.clip(gi, 0, max(n - 1, 0))
    bad = ~inside
    if n:
        bad |= (got.docs[gic] != want.docs[wi]) \
            | (got.positions[gic] != want.positions[wi])
    return wrong + int(np.unique(seg[bad]).size)


def text_geometry(table, tokens: np.ndarray):
    """Documents of ``tokens`` [docs, words] joined by single spaces ->
    (word rows int32[n, 16], byte spans int32[n, 2] within each document,
    document index int32[n]): each token is one word, since no token
    holds a separator."""
    d, w = tokens.shape
    nb = table.n_bytes[tokens]
    starts = np.cumsum(nb + 1, axis=1) - (nb + 1)
    spans = np.stack([starts, starts + nb], axis=-1).reshape(d * w, 2)
    doc_ids = np.repeat(np.arange(d, dtype=np.int32), w)
    return (table.rows[tokens.reshape(-1)], spans.astype(np.int32), doc_ids)

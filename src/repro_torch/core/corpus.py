"""Root dictionary + synthetic corpus with Zipf frequency skew.

The dictionary mixes ~140 real high-frequency Arabic roots (including every
root of the paper's Table 7) with deterministic pseudo-roots to reach a
realistic dictionary size (the Quran yields 1,767 distinct roots; general
dictionaries hold 5-10k). Pseudo-roots make the Compare stage realistically
selective — more entries mean more accidental matches on wrong truncations,
exactly the accuracy/coverage trade-off LB stemmers face.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core import alphabet as ab
from repro_torch.core import conjugator, pyref

# The paper's Table 7 roots first.
TABLE7_ROOTS = ["علم", "كفر", "قول", "نفس", "نزل", "عمل", "خلق", "جعل", "كذب", "كون"]

REAL_TRI_ROOTS = TABLE7_ROOTS + [
    "كتب", "درس", "لعب", "سقي", "قرا", "فتح", "نصر", "ضرب", "سمع", "بصر",
    "قلب", "رحم", "غفر", "صبر", "شكر", "ذكر", "دخل", "خرج", "رجع", "وصل",
    "قطع", "جمع", "فرق", "حمل", "رفع", "وضع", "منع", "دفع", "قتل", "ولد",
    "كبر", "صغر", "طلب", "وجد", "فقد", "اكل", "شرب", "قوم", "جلس", "مشي",
    "جري", "سبح", "زرع", "حصد", "بيع", "ملك", "حكم", "عدل", "ظلم", "صدق",
    "حسب", "عدد", "قسم", "ضعف", "سعد", "حزن", "فرح", "غضب", "خوف", "رجو",
    "دعو", "سجد", "ركع", "طهر", "حرم", "وجب", "سقط", "نهض", "بني", "هدم",
    "سكن", "رحل", "سفر", "عبر", "غرق", "هلك", "سلم", "نظر", "سال", "جوب",
    "حضر", "غيب", "قرب", "بعد", "وقف", "سير", "طير", "نوم", "صحو", "موت",
    "حيي", "زاد", "نقص", "بدا", "ختم", "وعد", "نكث", "شهد", "غزو", "صون",
    "ذهب", "جاء", "عرف", "جهل", "فهم", "حفظ", "نسي", "صنع", "كسب", "خسر",
    "ربح", "تجر", "زور", "صار", "ظهر", "بطن", "علن", "خفي", "كشف", "ستر",
]

REAL_QUAD_ROOTS = [
    "دحرج", "زلزل", "ترجم", "بعثر", "طمان", "وسوس", "زخرف", "سيطر",
    "هيمن", "عسكر", "قهقه", "غرغر", "ثرثر", "برهن", "سلسل", "زحزح",
]

REAL_BI_ROOTS = [
    "مد", "شد", "ظن", "عد", "حب", "حج", "حس", "حق", "حل", "دق",
    "دل", "رد", "سب", "سد", "شق", "صب", "صد", "ضل", "ضم", "عض",
    "غش", "فر", "قص", "كف", "لف", "لم", "مس", "من", "هز", "ود",
]

# Letters used for pseudo-root sampling: strong consonants only, so random
# roots neither collide with affix machinery nor look degenerate.
_STRONG = list("بجدحخذرزسشصضطظعغفقكلمهث")


def _pseudo_roots(n: int, length: int, seed: int, taken: set) -> list[str]:
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        letters = rng.choice(len(_STRONG), size=length)
        if len(set(letters.tolist())) < length:  # no geminates in pseudo roots
            continue
        r = "".join(_STRONG[i] for i in letters)
        if r in taken:
            continue
        taken.add(r)
        out.append(r)
    return out


def build_dictionary(n_tri: int = 2000, n_quad: int = 200, seed: int = 0) -> pyref.RootDict:
    taken = set(REAL_TRI_ROOTS) | set(REAL_QUAD_ROOTS)
    tri = REAL_TRI_ROOTS + _pseudo_roots(max(0, n_tri - len(REAL_TRI_ROOTS)), 3, seed, taken)
    quad = REAL_QUAD_ROOTS + _pseudo_roots(max(0, n_quad - len(REAL_QUAD_ROOTS)), 4, seed + 1, taken)
    return pyref.RootDict.from_words(tri=tri, quad=quad, bi=REAL_BI_ROOTS)


def _synthetic_keys(n: int, arity: int, seed: int, taken: set) -> np.ndarray:
    """n unique packed int32 keys shaped like real `arity`-letter roots
    (dense codes in 1..N_CODES-1, trailing chars zero), disjoint from
    ``taken``. Vectorised rejection sampling."""
    rng = np.random.default_rng(seed)
    out: list[int] = []
    seen = set(taken)
    while len(out) < n:
        c = rng.integers(1, ab.N_CODES, size=(2 * (n - len(out)) + 64, 4),
                         dtype=np.int64)
        c[:, arity:] = 0
        keys = ((c[:, 0] * 64 + c[:, 1]) * 64 + c[:, 2]) * 64 + c[:, 3]
        for k in keys.tolist():
            if k not in seen:
                seen.add(k)
                out.append(k)
                if len(out) == n:
                    break
    return np.asarray(out, np.int32)


def grow_root_arrays(arrays, n_keys: int, seed: int = 0):
    """Grow packed RootDictArrays to ~``n_keys`` total keys with synthetic
    roots (real keys kept, so real matches still occur).

    Production lexicons run to hundreds of thousands of entries — far past
    what ``build_dictionary``'s linguistic generator can produce (distinct
    strong-consonant trilaterals top out near 33^3). The streamed-megakernel
    scaling benchmark and the >64K-key parity tests need dictionaries at
    that scale, so the bulk lands in the quadrilateral table (33^4 ≈ 1.19M
    capacity) with tri/bi capped well under their key-space saturation.
    Returns a new RootDictArrays with sorted unique int32 keys per table,
    on the same device as ``arrays``.
    """
    from repro_torch.core import stemmer  # lazy: stemmer imports corpus's peers

    base = {name: getattr(arrays, name).cpu().numpy()
            for name in ("tri", "quad", "bi")}
    n_base = sum(v.size for v in base.values())
    extra = max(0, n_keys - n_base)
    want = {
        "tri": min(extra // 2, 16_000),
        "bi": min(extra // 64, 500),
    }
    want["quad"] = extra - want["tri"] - want["bi"]
    taken = set(np.concatenate(list(base.values())).tolist())
    grown = {}
    for arity, name in ((3, "tri"), (4, "quad"), (2, "bi")):
        synth = _synthetic_keys(want[name], arity, seed + arity, taken)
        taken.update(synth.tolist())
        merged = np.unique(np.concatenate([base[name], synth])).astype(np.int32)
        grown[name] = merged
    return stemmer.RootDictArrays.from_numpy(
        grown["tri"], grown["quad"], grown["bi"], device=arrays.tri.device)


def build_corpus(
    n_words: int = 20000, seed: int = 0, zipf_a: float = 1.3, rich: bool = True
) -> tuple[list[str], list[str], list[str]]:
    """-> (words, truth_roots, tags); root frequencies follow a Zipf law,
    mirroring the extreme skew of the Quran text (قول appears 1,722 times).
    """
    rng = np.random.default_rng(seed)
    roots = REAL_TRI_ROOTS + REAL_QUAD_ROOTS
    # Zipf-ranked sampling over the real-root list.
    ranks = np.arange(1, len(roots) + 1, dtype=np.float64)
    probs = ranks ** (-zipf_a)
    probs /= probs.sum()
    form_cache: dict[str, list[tuple[str, str]]] = {}
    words, truths, tags = [], [], []
    for ridx in rng.choice(len(roots), size=n_words, p=probs):
        root = roots[int(ridx)]
        if root not in form_cache:
            form_cache[root] = conjugator.conjugate(root, rich=rich)
        forms = form_cache[root]
        w, t = forms[int(rng.integers(len(forms)))]
        words.append(w)
        truths.append(root)
        tags.append(t)
    return words, truths, tags


def encode_corpus(words: list[str]) -> np.ndarray:
    return ab.encode_batch(words)


# ---------------------------------------------------------------------------
# Corpus-scale word and document streams
# ---------------------------------------------------------------------------
# build_corpus() materialises python string lists — fine at 20K words,
# hopeless at 10M. The streaming generator below samples from a prebuilt
# TokenTable instead: every distinct surface token's text AND its word
# row (textnorm.word_row_py: normalise, clitic strip, pack) are computed
# exactly once, so emitting a chunk is one vectorised rng.choice + one
# numpy gather.


@dataclass(frozen=True)
class TokenTable:
    """Distinct surface tokens with precomputed front-end word rows.

    texts  tuple[str]            surface forms (clitics attached)
    rows   int32[n_tokens, 16]   textnorm.word_row_py of each token
    probs  float64[n_tokens]     sampling distribution (Zipf over roots,
                                 uniform over a root's tokens)
    """

    texts: tuple
    rows: np.ndarray
    probs: np.ndarray

    @property
    def n_tokens(self) -> int:
        return len(self.texts)


def build_token_table(*, forms_per_root: int = 24, clitic_every: int = 3,
                      zipf_a: float = 1.3, rich: bool = True) -> TokenTable:
    """Enumerate the corpus streams' token universe, deterministically.

    Every real root contributes its first ``forms_per_root`` conjugated
    forms; every ``clitic_every``-th form additionally appears with a
    textnorm proclitic/enclitic attached (cycled, not sampled — the
    table itself is rng-free). Root probabilities follow the same Zipf
    law as build_corpus; a root's mass splits uniformly over its tokens.
    """
    from repro_torch.core import textnorm as tn  # lazy: textnorm imports peers

    roots = REAL_TRI_ROOTS + REAL_QUAD_ROOTS
    ranks = np.arange(1, len(roots) + 1, dtype=np.float64)
    root_p = ranks ** (-zipf_a)
    root_p /= root_p.sum()

    texts, probs = [], []
    pro = tn.PROCLITICS
    enc = tn.ENCLITICS
    for ridx, root in enumerate(roots):
        forms = [w for w, _ in conjugator.conjugate(root, rich=rich)]
        forms = list(dict.fromkeys(forms))[:forms_per_root]
        toks = list(forms)
        for i, w in enumerate(forms):
            if clitic_every and i % clitic_every == 0:
                toks.append(pro[(ridx + i) % len(pro)] + w)
            if clitic_every and i % clitic_every == 1:
                toks.append(w + enc[(ridx + i) % len(enc)])
        toks = list(dict.fromkeys(toks))
        texts.extend(toks)
        probs.extend([root_p[ridx] / len(toks)] * len(toks))
    rows = np.stack([tn.word_row_py(tuple(map(ord, t))) for t in texts])
    probs = np.asarray(probs, np.float64)
    return TokenTable(texts=tuple(texts), rows=rows, probs=probs / probs.sum())


@dataclass(frozen=True)
class CorpusChunk:
    """One streamed slice of a synthetic corpus, pre-encoded.

    words      int32[n, 16]  front-end word rows (megakernel input)
    doc_ids    int64[n]      global document id per word
    positions  int32[n]      word position within its document
    start_word int           global index of words[0] in the corpus
    """

    words: np.ndarray
    doc_ids: np.ndarray
    positions: np.ndarray
    start_word: int

    @property
    def n_words(self) -> int:
        return self.words.shape[0]


def stream_corpus_words(n_words: int, *, seed: int = 0,
                        chunk_words: int = 65536, words_per_doc: int = 1000,
                        table: TokenTable | None = None):
    """Yield a seeded ``n_words``-word corpus as CorpusChunks of encoded
    word rows — the fast ingest path for corpus-scale index builds.

    Deterministic per (seed, chunk_words, words_per_doc): chunk ``c`` is
    drawn from ``default_rng([seed, c])``, so resuming a checkpointed
    build re-yields byte-identical chunks without replaying the earlier
    ones' rng streams. Documents are ``words_per_doc`` words long and
    split across chunk boundaries exactly (doc ids and positions are
    functions of the global word index alone).
    """
    if table is None:
        table = build_token_table()
    for c, w0 in enumerate(range(0, n_words, chunk_words)):
        n = min(chunk_words, n_words - w0)
        rng = np.random.default_rng([seed, c])
        tok = rng.choice(table.n_tokens, size=n, p=table.probs)
        gwi = w0 + np.arange(n, dtype=np.int64)
        yield CorpusChunk(words=table.rows[tok],
                          doc_ids=gwi // words_per_doc,
                          positions=(gwi % words_per_doc).astype(np.int32),
                          start_word=w0)


def stream_corpus_docs(n_words: int, *, seed: int = 0,
                       chunk_words: int = 65536, words_per_doc: int = 100,
                       table: TokenTable | None = None):
    """The same corpus as :func:`stream_corpus_words` (same seed, the same
    token sequence) rendered as raw text: yields ``(doc0, docs)`` per
    chunk, ``docs`` the chunk's document strings and ``doc0`` the global
    id of ``docs[0]``.

    ``chunk_words`` must be a multiple of ``words_per_doc`` so documents
    never straddle a text chunk (the text index path attributes words to
    documents per chunk). Each document round-trips the front end to
    exactly the word rows the words stream emits.
    """
    if chunk_words % words_per_doc:
        raise ValueError(
            f"chunk_words ({chunk_words}) must be a multiple of"
            f" words_per_doc ({words_per_doc}) for the document stream")
    if table is None:
        table = build_token_table()
    for c, w0 in enumerate(range(0, n_words, chunk_words)):
        n = min(chunk_words, n_words - w0)
        rng = np.random.default_rng([seed, c])
        tok = rng.choice(table.n_tokens, size=n, p=table.probs)
        docs = [" ".join(table.texts[t] for t in tok[d0:d0 + words_per_doc])
                for d0 in range(0, n, words_per_doc)]
        yield w0 // words_per_doc, docs

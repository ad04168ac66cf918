"""The benchmark's generators: dictionaries, the token universe and the
traffic pools, all from ``--seed``.

Copied from ``repro_torch.core.corpus`` (``build_dictionary``,
``grow_root_arrays``, ``build_token_table``, ``stream_corpus_words``) and
kept here so that a change to the program cannot change the work it is
measured on. A dictionary is three sorted int32 arrays of packed root keys
(tri, quad, bi), the raw input that the program and the reference both
read. Traffic is drawn as token ids into the token table; the word rows,
documents and corpora are gathered from them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from stembench import arabic as ar

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
_STRONG = list("بجدحخذرزسشصضطظعغفقكلمهث")


@dataclass(frozen=True)
class Dictionary:
    """Sorted unique packed keys of each table (a [-1] placeholder for an
    empty table, as the program expects)."""

    tri: np.ndarray
    quad: np.ndarray
    bi: np.ndarray

    @property
    def n_keys(self) -> int:
        return int(self.tri.size + self.quad.size + self.bi.size)

    @property
    def n_roots(self) -> int:
        """Real keys (the placeholder left out): the index's vocabulary."""
        return int(sum((t >= 0).sum() for t in (self.tri, self.quad,
                                                self.bi)))


def _pseudo_roots(n: int, length: int, seed, taken: set) -> list[str]:
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        letters = rng.choice(len(_STRONG), size=length)
        if len(set(letters.tolist())) < length:
            continue
        r = "".join(_STRONG[i] for i in letters)
        if r not in taken:
            taken.add(r)
            out.append(r)
    return out


def _packed(roots) -> np.ndarray:
    keys = sorted({ar.pack_key(c for c in ar.encode_word(r) if c)
                   for r in roots}) or [-1]
    return np.asarray(keys, np.int32)


def _synthetic_keys(n: int, arity: int, seed, taken: set) -> np.ndarray:
    """n unique packed keys shaped like real ``arity``-letter roots,
    disjoint from ``taken``."""
    rng = np.random.default_rng(seed)
    out: list[int] = []
    seen = set(taken)
    while len(out) < n:
        c = rng.integers(1, ar.N_CODES, size=(2 * (n - len(out)) + 64, 4),
                         dtype=np.int64)
        c[:, arity:] = 0
        for k in (((c[:, 0] * 64 + c[:, 1]) * 64 + c[:, 2]) * 64
                  + c[:, 3]).tolist():
            if k not in seen:
                seen.add(k)
                out.append(k)
                if len(out) == n:
                    break
    return np.asarray(out, np.int32)


def build_dictionary(spec: dict, seed: int) -> Dictionary:
    """A configuration's ``dictionary`` entry -> its tables: the real
    roots, pseudo-roots up to ``n_tri`` and ``n_quad`` (the paper's
    processor), then, with ``grow_to``, synthetic keys up to that many in
    all (the bulk in the quadrilateral table, as production lexicons)."""
    taken = set(REAL_TRI_ROOTS) | set(REAL_QUAD_ROOTS)
    tri = REAL_TRI_ROOTS + _pseudo_roots(
        max(0, spec["n_tri"] - len(REAL_TRI_ROOTS)), 3, seed, taken)
    quad = REAL_QUAD_ROOTS + _pseudo_roots(
        max(0, spec["n_quad"] - len(REAL_QUAD_ROOTS)), 4, seed + 1, taken)
    base = {"tri": _packed(tri), "quad": _packed(quad),
            "bi": _packed(REAL_BI_ROOTS)}
    grow_to = spec.get("grow_to")
    if not grow_to:
        return Dictionary(**base)
    extra = max(0, grow_to - sum(v.size for v in base.values()))
    want = {"tri": min(extra // 2, 16_000), "bi": min(extra // 64, 500)}
    want["quad"] = extra - want["tri"] - want["bi"]
    taken_keys = set(np.concatenate(list(base.values())).tolist())
    grown = {}
    for arity, name in ((3, "tri"), (4, "quad"), (2, "bi")):
        synth = _synthetic_keys(want[name], arity, seed + arity, taken_keys)
        taken_keys.update(synth.tolist())
        grown[name] = np.unique(np.concatenate([base[name], synth])
                                ).astype(np.int32)
    return Dictionary(**grown)


@dataclass(frozen=True)
class TokenTable:
    """Distinct surface tokens: their text, word row, utf-8 length and
    sampling probability (Zipf over roots, uniform over a root's tokens)."""

    texts: tuple
    rows: np.ndarray          # int32[n, 16]
    n_bytes: np.ndarray       # int64[n]
    probs: np.ndarray         # float64[n]

    @property
    def n_tokens(self) -> int:
        return len(self.texts)


def build_token_table(spec: dict) -> TokenTable:
    """The token universe a traffic file names: each real root's first
    ``forms_per_root`` conjugated forms, every ``clitic_every``-th with a
    proclitic or enclitic attached (cycled, not sampled)."""
    roots = REAL_TRI_ROOTS + REAL_QUAD_ROOTS
    ranks = np.arange(1, len(roots) + 1, dtype=np.float64)
    root_p = ranks ** (-spec["zipf_a"])
    root_p /= root_p.sum()
    every = spec["clitic_every"]
    texts, probs = [], []
    for ridx, root in enumerate(roots):
        forms = [w for w, _ in ar.conjugate(root, rich=True)]
        forms = list(dict.fromkeys(forms))[:spec["forms_per_root"]]
        toks = list(forms)
        for i, w in enumerate(forms):
            if every and i % every == 0:
                toks.append(ar.PROCLITICS[(ridx + i) % len(ar.PROCLITICS)] + w)
            if every and i % every == 1:
                toks.append(w + ar.ENCLITICS[(ridx + i) % len(ar.ENCLITICS)])
        toks = list(dict.fromkeys(toks))
        texts.extend(toks)
        probs.extend([root_p[ridx] / len(toks)] * len(toks))
    rows = np.stack([ar.word_row(tuple(map(ord, t))) for t in texts])
    n_bytes = np.asarray([len(t.encode("utf-8")) for t in texts], np.int64)
    probs = np.asarray(probs, np.float64)
    return TokenTable(tuple(texts), rows, n_bytes, probs / probs.sum())


def draw_tokens(table: TokenTable, n: int, seed) -> np.ndarray:
    """``n`` token ids drawn from ``default_rng(seed)`` by the table's
    probabilities (the draw ``stream_corpus_words`` makes a chunk)."""
    rng = np.random.default_rng(seed)
    return rng.choice(table.n_tokens, size=n, p=table.probs)


def document(table: TokenTable, tokens: np.ndarray) -> str:
    """Tokens -> one document, its words separated by single spaces."""
    return " ".join(table.texts[t] for t in tokens)

"""Host half of the text normaliser: letter classification, clitic
stripping and packing raw Arabic words into the stemmer's int32[16] word
rows.

A copy of the pure-Python part of ``repro.core.textnorm``. The corpus
stream generators (``corpus.build_token_table``) build their word rows
with :func:`word_row_py`. The device half (the text front-end kernel and
its jnp reference) is not part of this package yet.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import alphabet as ab

# ---------------------------------------------------------------------------
# classes + windows
# ---------------------------------------------------------------------------
CLS_SEP = 0       # separator (also the 0 pad codepoint)
CLS_MARK = -1     # diacritic/tatweel: deleted in place, does not split
# class > 0: the letter's dense 6-bit code, normalisation applied

MAX_RAW = 32      # raw codepoints examined per word (letters + marks)
CMAX = 20         # normalised letters kept before clitic stripping
MIN_STEM = 3      # letters a clitic strip must leave (tri stems are the
                  # shortest the candidate grid analyses directly)


def classify_cp(cp: int) -> int:
    """Codepoint -> CLS_SEP | CLS_MARK | dense letter code (> 0)."""
    if cp in ab.DIACRITICS or cp == ab.TATWEEL:
        return CLS_MARK
    return ab.CP_TO_CODE.get(ab.NORMALISE.get(cp, cp), CLS_SEP)


# ---------------------------------------------------------------------------
# clitic patterns (longest first == match priority) and function words
# ---------------------------------------------------------------------------
PROCLITICS = ("وال", "بال", "فال", "كال", "لل", "و", "ف", "ب", "ل", "ك")
ENCLITICS = ("هما", "ها", "هم", "هن", "كم", "كن", "نا", "ني", "ه", "ك")

# Clitic stripping is NOT applied to these (Snippet 1): particles,
# pronouns, demonstratives and common function verbs whose first/last
# letters happen to look like clitics — stripping them manufactures a
# false analysis (كانت -> ك+انت, لكن -> ل+كن, هل -> ه+ل...). Stored
# unnormalised; keys are built through the same classify pipeline.
FUNCTION_WORDS = (
    # prepositions + particles
    "في", "من", "عن", "إلى", "على", "حتى", "منذ", "عند", "لدى", "مع",
    "بين", "فوق", "تحت", "أمام", "خلف", "وراء", "دون", "بعد", "قبل",
    "ضد", "نحو", "عبر", "بل", "قد", "سوف", "لقد", "هل", "لا", "لم",
    "لن", "ما", "إن", "أن", "لو", "لولا", "لعل", "ليت", "كي", "ثم",
    "أو", "أم", "إذ", "إذا", "لما", "لكن", "إنما", "أيضا", "إلا",
    "أما", "كل", "بعض", "غير", "مثل", "أي",
    # pronouns
    "هو", "هي", "هم", "هن", "هما", "أنا", "نحن", "أنت", "أنتم", "أنتن",
    # demonstratives + relatives
    "هذا", "هذه", "ذلك", "تلك", "هؤلاء", "أولئك", "الذي", "التي",
    "الذين",
    # the basmala nouns: ه/هم endings here are part of the word, not
    # object pronouns (الله -> الل under the enclitic rule otherwise)
    "الله", "اللهم",
    # interrogatives
    "ماذا", "لماذا", "متى", "أين", "كيف", "كم",
    # high-frequency function verbs (the Snippet-1 كانت example)
    "كان", "كانت", "كانوا", "يكون", "ليس", "ليست",
)


def _word_codes(word: str) -> tuple[int, ...]:
    return tuple(c for c in (classify_cp(ord(ch)) for ch in word) if c > 0)


PROCLITIC_CODES = tuple(_word_codes(p) for p in PROCLITICS)
ENCLITIC_CODES = tuple(_word_codes(e) for e in ENCLITICS)

FW_MAXLEN = 5                     # packed exemption key covers <= 5 letters


def pack5(codes) -> int:
    """<= 5 dense codes -> base-64 key < 2^30 (PAD-extended right)."""
    cs = list(codes)[:FW_MAXLEN]
    cs += [0] * (FW_MAXLEN - len(cs))
    k = 0
    for c in cs:
        k = k * 64 + int(c)
    return k


def _build_fw_keys() -> np.ndarray:
    keys = set()
    for w in FUNCTION_WORDS:
        codes = _word_codes(w)
        if not 0 < len(codes) <= FW_MAXLEN:
            raise AssertionError(
                f"function word {w!r} has {len(codes)} letters; the packed"
                f" exemption key covers 1..{FW_MAXLEN}")
        keys.add(pack5(codes))
    return np.asarray(sorted(keys), np.int32)


FW_KEYS = _build_fw_keys()                 # sorted unique, host membership
FW_KEY_SET = frozenset(int(k) for k in FW_KEYS)


# ---------------------------------------------------------------------------
# host reference (python strings; the oracle)
# ---------------------------------------------------------------------------
def letters_py(cps) -> list[int]:
    """Raw word codepoints -> normalised letter codes (windows applied)."""
    codes: list[int] = []
    for cp in tuple(cps)[:MAX_RAW]:
        c = classify_cp(cp)
        if c > 0:
            codes.append(c)
            if len(codes) == CMAX:
                break
    return codes


def strip_clitics_py(codes) -> tuple[list[int], int, int]:
    """Letter codes -> (stripped codes, proclitic len, enclitic len)."""
    codes = list(codes)
    n = len(codes)
    if n <= FW_MAXLEN and pack5(codes) in FW_KEY_SET:
        return codes, 0, 0
    pro = 0
    for pat in PROCLITIC_CODES:
        ln = len(pat)
        if n - ln >= MIN_STEM and tuple(codes[:ln]) == pat:
            pro = ln
            break
    rem = codes[pro:]
    m = len(rem)
    enc = 0
    for pat in ENCLITIC_CODES:
        ln = len(pat)
        if m - ln >= MIN_STEM and tuple(rem[m - ln:]) == pat:
            enc = ln
            break
    return (rem[:m - enc] if enc else rem), pro, enc


def word_row_py(cps) -> np.ndarray:
    """Raw word codepoints -> the int32[16] stemmer word-tile row."""
    codes, _, _ = strip_clitics_py(letters_py(cps))
    row = codes[:ab.MAXLEN - 1]
    return np.asarray(row + [0] * (ab.MAXLEN - len(row)), np.int32)

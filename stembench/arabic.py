"""The benchmark's frozen copy of the Arabic tables, the verb-form
generator and the host text front end.

Copied from ``repro_torch.core.alphabet``, ``conjugator`` and the host half
of ``textnorm`` so that the traffic the benchmark generates, and the
reference that judges the program, cannot move when the program does.
Nothing here imports the program. ``test_stembench_generate.py`` holds
these copies to the program's own at a small size.
"""
from __future__ import annotations

import itertools

import numpy as np

# ---------------------------------------------------------------------------
# alphabet: dense 6-bit letter codes, normalisation, the affix letter groups
# ---------------------------------------------------------------------------
_LETTERS = [
    0x0621, 0x0627, 0x0628, 0x0629, 0x062A, 0x062B, 0x062C, 0x062D, 0x062E,
    0x062F, 0x0630, 0x0631, 0x0632, 0x0633, 0x0634, 0x0635, 0x0636, 0x0637,
    0x0638, 0x0639, 0x063A, 0x0641, 0x0642, 0x0643, 0x0644, 0x0645, 0x0646,
    0x0647, 0x0648, 0x0649, 0x064A, 0x0624, 0x0626,
]
TATWEEL = 0x0640
NORMALISE = {0x0622: 0x0627, 0x0623: 0x0627, 0x0625: 0x0627, 0x0671: 0x0627,
             0x0629: 0x062A}
DIACRITICS = (set(range(0x064B, 0x0660)) | {0x0670}
              | set(range(0x06D6, 0x06DD)) | set(range(0x06DF, 0x06E5))
              | {0x06E7, 0x06E8} | set(range(0x06EA, 0x06EE)))
MAXLEN = 16          # 15 letters + 1 pad slot a word row
CP_TO_CODE = {0: 0}
for _i, _cp in enumerate(_LETTERS, start=1):
    CP_TO_CODE[_cp] = _i
N_CODES = len(_LETTERS) + 1
PREFIX_CODES = frozenset(CP_TO_CODE[c] for c in
                         (0x0627, 0x062A, 0x0633, 0x0641, 0x0644, 0x0646,
                          0x064A))
SUFFIX_CODES = frozenset(CP_TO_CODE[c] for c in
                         (0x0627, 0x0644, 0x062A, 0x0647, 0x0643, 0x0645,
                          0x0648, 0x0646, 0x064A))
INFIX_CODES = frozenset(CP_TO_CODE[c] for c in
                        (0x0627, 0x062A, 0x0648, 0x0646, 0x064A))
ALEF = CP_TO_CODE[0x0627]
WAW = CP_TO_CODE[0x0648]
YEH = CP_TO_CODE[0x064A]


def normalise(text: str) -> str:
    out = []
    for ch in text:
        cp = ord(ch)
        if cp in DIACRITICS or cp == TATWEEL:
            continue
        out.append(chr(NORMALISE.get(cp, cp)))
    return "".join(out)


def encode_word(word: str) -> np.ndarray:
    """One word -> int32[16] dense codes, left-aligned, 0-padded."""
    codes = [CP_TO_CODE.get(ord(c), 0) for c in normalise(word)][:MAXLEN - 1]
    return np.asarray(codes + [0] * (MAXLEN - len(codes)), np.int32)


def pack_key(codes) -> int:
    """Up to 4 codes -> ((c0*64 + c1)*64 + c2)*64 + c3, PAD-extended."""
    cs = list(codes)[:4]
    k = 0
    for c in cs + [0] * (4 - len(cs)):
        k = k * 64 + int(c)
    return k


# ---------------------------------------------------------------------------
# verb-form generator (the paper's Tables 1-2 affix patterns)
# ---------------------------------------------------------------------------
PAST_SUFFIXES = ["", "ت", "نا", "تم", "تن", "وا", "ا", "تا", "ن"]
PRESENT_PREFIXES = ["ي", "ت", "ن", "ا"]
PRESENT_SUFFIXES = ["", "ون", "ان", "ين", "ن"]
PAST_PROCLITICS = ["", "و", "ف", "ا"]
PRESENT_PROCLITICS = ["", "و", "ف", "س", "وس", "فس", "ا", "اف"]
OBJECT_SUFFIXES = ["", "ه", "ها", "هم", "كم", "ني", "نا", "كموها"]


def conjugate(root: str, rich: bool = True) -> list[tuple[str, str]]:
    """All generated (surface form, tag) pairs of one root."""
    out: list[tuple[str, str]] = []
    tri = len(root) == 3
    past = [(root, "past")]
    present = [(root, "present")]
    if tri and root[1] in ("و", "ي"):
        past.append((root[0] + "ا" + root[2], "hollow_past"))
        past.append((root[0] + root[2], "hollow_short_past"))
    if tri and root[2] in ("و", "ي", "ا"):
        past.append((root[:2] + "ى", "defective_past"))
    if tri and rich:
        past.append((root[0] + "ا" + root[1] + root[2], "form3"))
        past.append(("است" + root, "form10"))
        present.append((root[0] + "ا" + root[1] + root[2], "form3_present"))
        present.append(("ست" + root, "form10_present"))
    for (stem, tag), proc, suf in itertools.product(past, PAST_PROCLITICS,
                                                    PAST_SUFFIXES):
        if tag == "hollow_short_past" and suf == "":
            continue
        out.append((proc + stem + suf, tag))
    for (stem, tag), proc, pre, suf in itertools.product(
            present, PRESENT_PROCLITICS, PRESENT_PREFIXES, PRESENT_SUFFIXES):
        out.append((proc + pre + stem + suf, tag))
    if rich:
        base = [w for w, t in out if t in ("past", "present")][:24]
        out.extend((w + obj, "object") for w in base
                   for obj in OBJECT_SUFFIXES[1:4])
    return out


# ---------------------------------------------------------------------------
# host text front end: words are maximal runs of non-separators; one
# longest-match proclitic and enclitic stripped when 3 letters remain,
# except from function words
# ---------------------------------------------------------------------------
CLS_SEP, CLS_MARK = 0, -1
MAX_RAW, CMAX, MIN_STEM, FW_MAXLEN = 32, 20, 3, 5
PROCLITICS = ("وال", "بال", "فال", "كال", "لل", "و", "ف", "ب", "ل", "ك")
ENCLITICS = ("هما", "ها", "هم", "هن", "كم", "كن", "نا", "ني", "ه", "ك")
FUNCTION_WORDS = (
    "في", "من", "عن", "إلى", "على", "حتى", "منذ", "عند", "لدى", "مع",
    "بين", "فوق", "تحت", "أمام", "خلف", "وراء", "دون", "بعد", "قبل",
    "ضد", "نحو", "عبر", "بل", "قد", "سوف", "لقد", "هل", "لا", "لم",
    "لن", "ما", "إن", "أن", "لو", "لولا", "لعل", "ليت", "كي", "ثم",
    "أو", "أم", "إذ", "إذا", "لما", "لكن", "إنما", "أيضا", "إلا",
    "أما", "كل", "بعض", "غير", "مثل", "أي",
    "هو", "هي", "هم", "هن", "هما", "أنا", "نحن", "أنت", "أنتم", "أنتن",
    "هذا", "هذه", "ذلك", "تلك", "هؤلاء", "أولئك", "الذي", "التي",
    "الذين", "الله", "اللهم",
    "ماذا", "لماذا", "متى", "أين", "كيف", "كم",
    "كان", "كانت", "كانوا", "يكون", "ليس", "ليست",
)


def classify_cp(cp: int) -> int:
    """Codepoint -> CLS_SEP | CLS_MARK | dense letter code (> 0)."""
    if cp in DIACRITICS or cp == TATWEEL:
        return CLS_MARK
    return CP_TO_CODE.get(NORMALISE.get(cp, cp), CLS_SEP)


def _codes(word: str) -> tuple[int, ...]:
    return tuple(c for c in (classify_cp(ord(ch)) for ch in word) if c > 0)


def _pack5(codes) -> int:
    cs = list(codes)[:FW_MAXLEN]
    k = 0
    for c in cs + [0] * (FW_MAXLEN - len(cs)):
        k = k * 64 + int(c)
    return k


PROCLITIC_CODES = tuple(_codes(p) for p in PROCLITICS)
ENCLITIC_CODES = tuple(_codes(e) for e in ENCLITICS)
FW_KEY_SET = frozenset(_pack5(_codes(w)) for w in FUNCTION_WORDS)


def utf8_len(cp: int) -> int:
    return 1 + (cp >= 0x80) + (cp >= 0x800) + (cp >= 0x10000)


def tokenize(text: str) -> list[tuple[tuple[int, ...], int, int]]:
    """text -> [(raw codepoints, byte_start, byte_end)] a word."""
    toks, cur = [], []
    b = b0 = 0
    for ch in text:
        cp = ord(ch)
        if classify_cp(cp) == CLS_SEP:
            if cur:
                toks.append((tuple(cur), b0, b))
                cur = []
        else:
            if not cur:
                b0 = b
            cur.append(cp)
        b += utf8_len(cp)
    if cur:
        toks.append((tuple(cur), b0, b))
    return toks


def _strip_clitics(codes: list[int]) -> list[int]:
    n = len(codes)
    if n <= FW_MAXLEN and _pack5(codes) in FW_KEY_SET:
        return codes
    pro = 0
    for pat in PROCLITIC_CODES:
        if n - len(pat) >= MIN_STEM and tuple(codes[:len(pat)]) == pat:
            pro = len(pat)
            break
    rem = codes[pro:]
    m = len(rem)
    for pat in ENCLITIC_CODES:
        if m - len(pat) >= MIN_STEM and tuple(rem[m - len(pat):]) == pat:
            return rem[:m - len(pat)]
    return rem


def word_row(cps) -> np.ndarray:
    """Raw word codepoints -> the int32[16] word row the stemmer reads."""
    codes: list[int] = []
    for cp in tuple(cps)[:MAX_RAW]:
        c = classify_cp(cp)
        if c > 0:
            codes.append(c)
            if len(codes) == CMAX:
                break
    row = _strip_clitics(codes)[:MAXLEN - 1]
    return np.asarray(row + [0] * (MAXLEN - len(row)), np.int32)


def analyze_text(text: str) -> tuple[np.ndarray, np.ndarray]:
    """Document -> (word rows int32[W, 16], utf-8 byte spans int32[W, 2])."""
    toks = tokenize(text)
    if not toks:
        return np.zeros((0, MAXLEN), np.int32), np.zeros((0, 2), np.int32)
    return (np.stack([word_row(cps) for cps, _, _ in toks]),
            np.asarray([[b0, b1] for _, b0, b1 in toks], np.int32))

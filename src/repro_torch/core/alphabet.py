"""Arabic alphabet tables, normalisation and fixed-width encoding.

The paper (§3.1, §5.2) processes 16-bit Arabic Unicode with:
  - diacritics stripped,
  - the technical difference between ا and أ ignored,
  - a fixed 15-character input register file sized for the longest Arabic
    word (أفاستسقيناكموها).

We keep the paper's conventions but use a 16-slot tensor (15 chars + 1 pad
slot) so shapes stay lane-friendly, and additionally define a dense 6-bit
per-letter code so a 4-letter stem packs into a single int32 key (<2^24),
which is what the compare-stage kernels and the sorted-search variant use.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Codepoints
# ---------------------------------------------------------------------------
# Base Arabic letters (after normalisation). 36 entries < 64 -> 6-bit codes.
_LETTERS = [
    0x0621,  # ء hamza
    0x0627,  # ا alef (normalisation target for أ إ آ ٱ)
    0x0628,  # ب
    0x0629,  # ة teh marbuta
    0x062A,  # ت
    0x062B,  # ث
    0x062C,  # ج
    0x062D,  # ح
    0x062E,  # خ
    0x062F,  # د
    0x0630,  # ذ
    0x0631,  # ر
    0x0632,  # ز
    0x0633,  # س
    0x0634,  # ش
    0x0635,  # ص
    0x0636,  # ض
    0x0637,  # ط
    0x0638,  # ظ
    0x0639,  # ع
    0x063A,  # غ
    0x0641,  # ف
    0x0642,  # ق
    0x0643,  # ك
    0x0644,  # ل
    0x0645,  # م
    0x0646,  # ن
    0x0647,  # ه
    0x0648,  # و
    0x0649,  # ى alef maqsura
    0x064A,  # ي
    0x0624,  # ؤ waw-hamza
    0x0626,  # ئ yeh-hamza
]

PAD = 0  # empty register slot ("U" in the paper's ModelSim traces)

# Normalisation map: hamza-carrier alef forms collapse onto plain alef (the
# paper explicitly ignores the ا/أ distinction) and taa marbuta onto teh —
# the full Snippet-1 rule set. ة only ever occurs word-finally in correct
# orthography and reads as ت there, so the collapse is unconditional; ت is a
# SUFFIX letter, so the stemmer's prefix/suffix cuts still reach the root.
TATWEEL = 0x0640     # ـ kashida: elongation filler, stripped like a mark
NORMALISE = {
    0x0622: 0x0627,  # آ
    0x0623: 0x0627,  # أ
    0x0625: 0x0627,  # إ
    0x0671: 0x0627,  # ٱ wasla
    0x0629: 0x062A,  # ة -> ت taa marbuta
}

# Diacritics stripped from input (§3.1): fatha, damma, kasra, sukun, shadda,
# tanween forms, the hamza/madda combining marks, superscript alef, the rest
# of the 0x0656-0x065F combining block, and the Quranic annotation marks
# (small high/low signs, sajdah, stop marks — U+06D6..U+06ED) that Quranic
# text carries alongside ordinary tashkil.
DIACRITICS = (set(range(0x064B, 0x0660))            # tashkil + 0653-065F
              | {0x0670}                            # superscript alef
              | set(range(0x06D6, 0x06DD))          # small high ligatures
              | set(range(0x06DF, 0x06E5))          # small high/low signs
              | {0x06E7, 0x06E8}                    # small high yeh/noon
              | set(range(0x06EA, 0x06EE)))         # empty centre marks
# aliases under the tables' older private names
_NORMALISE = NORMALISE
_DIACRITICS = DIACRITICS

MAXLEN = 16          # 15-char register file + 1 pad slot (paper uses 15)
WORD_SLOTS = MAXLEN

# Affix letter groups (paper §1.1):
#   prefixes: the 7 letters of فسألتني  (hamza normalised to alef)
#   suffixes: the 9 letters of التهكمون (+ي, see DESIGN.md deviation note)
#   infixes : the 5 letters ا ت و ن ي
PREFIX_LETTERS = [0x0627, 0x062A, 0x0633, 0x0641, 0x0644, 0x0646, 0x064A]
SUFFIX_LETTERS = [0x0627, 0x0644, 0x062A, 0x0647, 0x0643, 0x0645, 0x0648,
                  0x0646, 0x064A]
INFIX_LETTERS = [0x0627, 0x062A, 0x0648, 0x0646, 0x064A]

# 6-bit dense code: 0 reserved for PAD, letters from 1.
CP_TO_CODE = {PAD: 0}
CODE_TO_CP = {0: PAD}
for _i, _cp in enumerate(_LETTERS, start=1):
    CP_TO_CODE[_cp] = _i
    CODE_TO_CP[_i] = _cp
N_CODES = len(_LETTERS) + 1          # 34
CODE_BITS = 6                        # 4 codes pack into 24 bits < int32

# LUT from (codepoint - 0x0600) -> dense code, for vectorised compression.
_LUT = np.zeros(0x100, dtype=np.int32)
for _cp, _c in CP_TO_CODE.items():
    if _cp:
        _LUT[_cp - 0x0600] = _c
CODE_LUT = _LUT  # int32[256]

PREFIX_CODES = np.array([CP_TO_CODE[c] for c in PREFIX_LETTERS], np.int32)
SUFFIX_CODES = np.array([CP_TO_CODE[c] for c in SUFFIX_LETTERS], np.int32)
INFIX_CODES = np.array([CP_TO_CODE[c] for c in INFIX_LETTERS], np.int32)

ALEF = CP_TO_CODE[0x0627]
WAW = CP_TO_CODE[0x0648]
YEH = CP_TO_CODE[0x064A]


def normalise(text: str) -> str:
    """Strip diacritics + tatweel, collapse alef variants and taa marbuta
    (paper §3.1 + SNIPPETS Snippet 1).

    Thin wrapper over the shared NORMALISE / DIACRITICS tables — the same
    tables core.textnorm compiles into the segmentation CLASS_LUT, so the
    host string path, the jnp reference, and the Pallas text front-end
    kernel cannot drift (parity-tested per rule in tests/test_textnorm.py).
    """
    out = []
    for ch in text:
        cp = ord(ch)
        if cp in DIACRITICS or cp == TATWEEL:
            continue
        cp = NORMALISE.get(cp, cp)
        out.append(chr(cp))
    return "".join(out)


def encode_word(word: str) -> np.ndarray:
    """One word -> int32[MAXLEN] of dense 6-bit codes, left-aligned, 0-padded.

    Words longer than 15 characters are truncated (the paper's register file
    is sized for the longest attested Arabic word, 15 chars).
    """
    word = normalise(word)
    codes = [CP_TO_CODE.get(ord(c), 0) for c in word][: MAXLEN - 1]
    codes += [0] * (MAXLEN - len(codes))
    return np.asarray(codes, dtype=np.int32)


def encode_batch(words: list[str]) -> np.ndarray:
    """Batch of words -> int32[B, MAXLEN]."""
    if not words:
        return np.zeros((0, MAXLEN), np.int32)
    return np.stack([encode_word(w) for w in words])


def decode_word(codes) -> str:
    """int sequence of dense codes -> string (pads dropped)."""
    return "".join(chr(CODE_TO_CP[int(c)]) for c in codes if int(c) != 0)


def pack_key(codes) -> int:
    """Up to 4 dense codes -> int32 key. PAD-extended on the right.

    key = ((c0*64 + c1)*64 + c2)*64 + c3  < 2^24. Key 0 == empty stem.
    """
    cs = list(codes)[:4] + [0] * (4 - len(list(codes)[:4]))
    k = 0
    for c in cs:
        k = k * 64 + int(c)
    return k


def unpack_key(key: int) -> list[int]:
    cs = []
    for _ in range(4):
        cs.append(key % 64)
        key //= 64
    return cs[::-1]

"""Raw-text normalisation and segmentation rules: the single source of
truth for the text front end.

The counterpart of ``repro.core.textnorm``. Three implementations consume
the tables defined here and agree bit for bit on every document:

  host reference   :func:`analyze_text_py`, plain Python over strings; the
                   oracle the parity tests trust
  plain reference  :func:`frontend_reference`, scatter-based PyTorch over
                   the whole codepoint tile
  kernel           ``kernels/text_frontend.py`` (K4): one thread per word,
                   gather-based, with the per-word rules of
                   :func:`strip_and_pack` written out in
                   ``kernels/csrc/text_frontend.cuh``; its plain version
                   shares :func:`strip_and_pack` with the reference here

The rules: every codepoint is a LETTER (a dense 6-bit code with the
normalisation applied: alef variants -> ا, ة -> ت), a MARK (diacritics and
tatweel: deleted in place, never splitting a word) or a SEPARATOR
(whitespace, punctuation, digits, anything not Arabic, the 0 pad). Words
are maximal runs of non-separators with their utf-8 byte span. One
longest-match proclitic and one longest-match enclitic are stripped when
at least MIN_STEM letters remain, except from function words; the first
15 letters make the int32[16] word row the stemmer consumes. At most
MAX_RAW raw codepoints of a word are examined and at most CMAX letters
kept, so a degenerate 100-codepoint "word" truncates the same way
everywhere.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

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


def _build_class_lut() -> np.ndarray:
    lut = np.zeros(0x100, np.int32)
    for off in range(0x100):
        lut[off] = classify_cp(0x0600 + off)
    return lut


# int32[256] over the 0x0600 Arabic page; codepoints outside the page are
# separators by construction (classify_codes range-checks before the take)
CLASS_LUT = _build_class_lut()


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
FW_SENTINEL = np.int32(1 << 30)   # > any packed 5-letter key (64^5 - 1)


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


def _pad_pow2(keys: np.ndarray, lane: int = 128) -> np.ndarray:
    rp = lane
    while rp < keys.shape[0]:
        rp *= 2
    return np.pad(keys, (0, rp - keys.shape[0]),
                  constant_values=FW_SENTINEL)


# sorted and sentinel-padded to a pow2 >= 128: the layout of
# stem_match.pad_dict_sorted, so bsearch_hit runs unchanged on it
FW_FLAT = _pad_pow2(FW_KEYS)


@functools.lru_cache(maxsize=None)
def _tables_on(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(CLASS_LUT, FW_FLAT) as int32 tensors on ``device``, uploaded once."""
    return (torch.as_tensor(CLASS_LUT, device=device),
            torch.as_tensor(FW_FLAT, device=device))


def device_tables(device) -> tuple[torch.Tensor, torch.Tensor]:
    """(CLASS_LUT, FW_FLAT) int32 tensors on ``device``."""
    return _tables_on(torch.device(device))


# ---------------------------------------------------------------------------
# host reference (python strings; the oracle)
# ---------------------------------------------------------------------------
def utf8_len(cp: int) -> int:
    return 1 + (cp >= 0x80) + (cp >= 0x800) + (cp >= 0x10000)


def tokenize_py(text: str) -> list[tuple[tuple[int, ...], int, int]]:
    """text -> [(raw codepoints, byte_start, byte_end)] per word.

    Words are maximal runs of non-separator codepoints; byte offsets are
    utf-8 offsets into ``text.encode()``. Mark-only runs (e.g. a stray
    shadda between spaces) still tokenize: they normalise to an empty
    word row, which the stemmer maps to SRC_NONE.
    """
    toks: list[tuple[tuple[int, ...], int, int]] = []
    cur: list[int] = []
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


def analyze_text_py(text: str) -> tuple[np.ndarray, np.ndarray]:
    """Document -> (words int32[W, 16], spans int32[W, 2] byte offsets)."""
    toks = tokenize_py(text)
    if not toks:
        return (np.zeros((0, ab.MAXLEN), np.int32),
                np.zeros((0, 2), np.int32))
    words = np.stack([word_row_py(cps) for cps, _, _ in toks])
    spans = np.asarray([[b0, b1] for _, b0, b1 in toks], np.int32)
    return words, spans


def coalesce_docs(docs) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Documents -> one codepoint tile with a single 0 separator between
    consecutive docs; returns (chars int32[T], char_offsets int64[D],
    byte_offsets int64[D]): the offsets of each doc's first codepoint and
    utf-8 byte inside the coalesced tile, so per-tile word positions and
    byte spans map back to per-document ones by subtraction.
    """
    parts: list[np.ndarray] = []
    char_off, byte_off = [], []
    c = b = 0
    for i, d in enumerate(docs):
        if i:
            parts.append(np.zeros(1, np.int32))
            c += 1
            b += 1
        char_off.append(c)
        byte_off.append(b)
        if d:
            parts.append(np.frombuffer(
                d.encode("utf-32-le"), np.uint32).astype(np.int32))
        c += len(d)
        b += len(d.encode("utf-8"))
    chars = (np.concatenate(parts) if parts else np.zeros(0, np.int32))
    return (chars, np.asarray(char_off, np.int64),
            np.asarray(byte_off, np.int64))


# ---------------------------------------------------------------------------
# the device half, in plain PyTorch (any device)
# ---------------------------------------------------------------------------
def classify_codes(chars: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """int32[...] codepoints -> class, via the CLASS_LUT tensor ``lut``
    (int32[256]); anything off the 0x0600 page is a separator."""
    off = chars - 0x0600
    in_page = (off >= 0) & (off < 0x100)
    cls = lut[off.clamp(0, 0xFF).long()]
    return torch.where(in_page, cls, torch.zeros_like(cls) + CLS_SEP)


def strip_and_pack(codes: torch.Tensor, lens: torch.Tensor,
                   fw_flat: torch.Tensor) -> torch.Tensor:
    """Normalised letter rows -> stripped, packed word-tile rows.

    codes int32[n, CMAX]  left-aligned letter codes, 0 beyond ``lens``
    lens  int32[n]        letters per row (<= CMAX)
    fw_flat int32[Fp]     FW_FLAT (sorted, sentinel-padded pow2)
    -> int32[n, 16]

    Function-word exemption by bsearch_hit on the packed 5-letter key; the
    proclitic as a first-match scan over the pattern list (longest
    first); the enclitic's letters read at absolute column lens - L + k
    (0 outside the row, as the reference's one-hot sum reads it); the
    proclitic shift as a select over the static shifts.
    """
    from repro_torch.kernels import stem_match as sm  # lazy: core -> kernels

    codes = codes.to(torch.int32)
    lens = lens.to(torch.int32)
    n, cm = codes.shape
    key5 = ((((codes[:, 0] * 64 + codes[:, 1]) * 64 + codes[:, 2]) * 64
             + codes[:, 3]) * 64 + codes[:, 4])
    exempt = (lens <= FW_MAXLEN) & sm.bsearch_hit(fw_flat, key5)

    pro = torch.zeros((n,), dtype=torch.int32, device=codes.device)
    found = exempt
    for pat in PROCLITIC_CODES:
        ln = len(pat)
        m = lens - ln >= MIN_STEM
        for k, c in enumerate(pat):
            m = m & (codes[:, k] == c)
        pro = torch.where(m & ~found, ln, pro)
        found = found | m

    rem_len = lens - pro
    padded = torch.nn.functional.pad(codes, (ab.MAXLEN, ab.MAXLEN))

    def char_at(pos):   # codes[i, pos[i]], 0 outside [0, cm)
        idx = (pos.clamp(-ab.MAXLEN, cm + ab.MAXLEN - 1) + ab.MAXLEN).long()
        return padded.gather(1, idx[:, None])[:, 0]

    enc = torch.zeros((n,), dtype=torch.int32, device=codes.device)
    found = exempt
    for pat in ENCLITIC_CODES:
        ln = len(pat)
        m = rem_len - ln >= MIN_STEM
        for k, c in enumerate(pat):
            # the enclitic's letters sit at absolute column lens - ln + k
            # whatever the proclitic cut (both count from the left)
            m = m & (char_at(lens - ln + k) == c)
        enc = torch.where(m & ~found, ln, enc)
        found = found | m

    out_len = torch.minimum(rem_len - enc,
                            torch.full_like(rem_len, ab.MAXLEN - 1))
    shifted = torch.zeros((n, ab.MAXLEN), dtype=torch.int32,
                          device=codes.device)
    for p in sorted({len(pat) for pat in PROCLITIC_CODES} | {0}):
        shifted = torch.where((pro == p)[:, None],
                              codes[:, p:p + ab.MAXLEN], shifted)
    keep = (torch.arange(ab.MAXLEN, device=codes.device)[None, :]
            < out_len[:, None])
    return torch.where(keep, shifted, torch.zeros_like(shifted))


@dataclass(frozen=True)
class TextGeometry:
    """Per-word layout of a codepoint tile (int32 tensors on its device).

    starts  int32[Wp]    char index of each word's first codepoint
    lens    int32[Wp]    raw codepoint count (un-windowed; 0 past n_words)
    spans   int32[Wp,2]  utf-8 byte [start, end) into the tile's encoding
    n_words int32[]      actual word count (rows past it are zero)
    """

    starts: torch.Tensor
    lens: torch.Tensor
    spans: torch.Tensor
    n_words: torch.Tensor


def _word_capacity(t: int, block_w: int, max_words) -> int:
    w = (t // 2 + 1) if max_words is None else max_words
    return -(-w // block_w) * block_w


def scatter_rows(n: int, rows: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """int32[n] zeros with values written at rows: the masked scatter that
    stands for jax's ``.at[rows].set(values, mode="drop")``. Masked rows
    carry index n and land in a spare row that is cut off, so nothing is
    written out of range and no host sync is needed."""
    out = torch.zeros(n + 1, dtype=torch.int32, device=values.device)
    out.scatter_(0, rows.long(), values.to(torch.int32))
    return out[:n]


def _as_tile(chars) -> torch.Tensor:
    t = torch.as_tensor(chars)
    return t if t.dtype == torch.int32 else t.to(torch.int32)


def segment_geometry(chars, *, block_w: int = 128,
                     max_words: int | None = None) -> TextGeometry:
    """Codepoint tile int32[T] -> word starts, lengths and byte spans,
    scatter-based, on the tile's device.

    The capacity default T // 2 + 1 is exact (words alternate with at
    least one separator), so no word is dropped unless the caller caps
    ``max_words`` below the true count.
    """
    chars = _as_tile(chars)
    t = chars.shape[0]
    if t == 0:
        raise ValueError("segment_geometry needs a non-empty codepoint"
                         " tile; pad with the 0 separator")
    dev = chars.device
    wp = _word_capacity(t, block_w, max_words)
    lut, _ = device_tables(dev)
    is_word = classify_codes(chars, lut) != CLS_SEP
    no = torch.zeros(1, dtype=torch.bool, device=dev)
    prev = torch.cat([no, is_word[:-1]])
    nxt = torch.cat([is_word[1:], no])
    wstart = is_word & ~prev
    wend = is_word & ~nxt
    wid = torch.cumsum(wstart, 0, dtype=torch.int32) - 1
    n_words = wstart.sum(dtype=torch.int32)
    idx = torch.arange(t, dtype=torch.int32, device=dev)
    drop = torch.full_like(wid, wp)
    sidx = torch.where(wstart & (wid < wp), wid, drop)
    eidx = torch.where(wend & (wid < wp), wid, drop)
    starts = scatter_rows(wp, sidx, idx)
    ends = scatter_rows(wp, eidx, idx)
    blen = (1 + (chars >= 0x80).to(torch.int32)
            + (chars >= 0x800).to(torch.int32)
            + (chars >= 0x10000).to(torch.int32))
    boff = torch.cumsum(blen, 0, dtype=torch.int32) - blen
    b0 = scatter_rows(wp, sidx, boff)
    b1 = scatter_rows(wp, eidx, boff + blen)
    valid = torch.arange(wp, device=dev) < n_words
    zero = torch.zeros_like(starts)
    lens = torch.where(valid, ends - starts + 1, zero)
    spans = torch.where(valid[:, None], torch.stack([b0, b1], dim=-1),
                        torch.zeros((wp, 2), dtype=torch.int32, device=dev))
    return TextGeometry(starts=torch.where(valid, starts, zero), lens=lens,
                        spans=spans, n_words=n_words)


def frontend_reference(chars, *, block_w: int = 128,
                       max_words: int | None = None):
    """Plain front end, scatter-based: codepoint tile -> (words
    int32[Wp, 16], TextGeometry), on the tile's device. Bit-identical to
    the host reference row by row and to K4 (``kernels/text_frontend.py``),
    which gathers per word instead of scattering per codepoint.
    """
    chars = _as_tile(chars)
    t = chars.shape[0]
    geo = segment_geometry(chars, block_w=block_w, max_words=max_words)
    wp = geo.starts.shape[0]
    dev = chars.device
    lut, fw = device_tables(dev)
    cls = classify_codes(chars, lut)
    is_word = cls != CLS_SEP
    is_letter = cls > 0
    prev = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                      is_word[:-1]])
    wid = torch.cumsum(is_word & ~prev, 0, dtype=torch.int32) - 1
    start_of = geo.starts[wid.clamp(0, wp - 1).long()]
    raw_off = torch.arange(t, dtype=torch.int32, device=dev) - start_of
    lett = is_letter.to(torch.int32)
    g_excl = torch.cumsum(lett, 0, dtype=torch.int32) - lett
    pos = g_excl - g_excl[start_of.clamp(0, t - 1).long()]
    cond = is_letter & (raw_off < MAX_RAW) & (pos < CMAX) & (wid < wp)
    rows = torch.where(cond, wid, torch.full_like(wid, wp)).long()
    cols = torch.where(cond, pos, torch.zeros_like(pos)).long()
    grid = torch.zeros((wp + 1, CMAX), dtype=torch.int32, device=dev)
    grid.index_put_((rows, cols), torch.where(cond, cls,
                                              torch.zeros_like(cls)))
    nlet = torch.zeros(wp + 1, dtype=torch.int32, device=dev)
    nlet.index_add_(0, rows, lett)
    words = strip_and_pack(grid[:wp], nlet[:wp], fw)
    return words, geo

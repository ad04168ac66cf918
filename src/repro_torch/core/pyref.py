"""Pure-Python oracle of the paper's verb-root-extraction algorithm.

This is the executable specification: every JAX / Pallas implementation in
the repo is tested against this module. It follows the paper's flowcharts
(Figs 1-4), the VHDL substring-truncation semantics (Fig 12 / Table 3) and
the infix-processing passes (Figs 18-19).

Candidate geometry: a stem is ``word[p+1 : s]`` for a prefix cut ``p`` (−1
== no prefix) and suffix start ``s`` (``n`` == no suffix). Only lengths
3 (trilateral) and 4 (quadrilateral) are kept, so for each ``p`` the pair
is fully determined by the length: ``s = p + 1 + L``. The VHDL's 6-slot
candidate arrays therefore exactly hold the 6 possible prefix cuts -- the
``count1 < 5`` cap never drops a candidate (see DESIGN.md).

Produce-Prefixes masking: cumulative AND of prefix-letter membership from
the word start (mirroring the documented Produce-Suffixes rule, anchored at
the word end), with one linguistic refinement required by the paper's own
worked example (سيلعبون → prefixes mask 1100000): the person-marker ي is
always the *final* prefix letter, so the run terminates immediately after
the first ي. This is consistent with both worked examples in the paper.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core import alphabet as ab

PREFIX_SET = frozenset(int(c) for c in ab.PREFIX_CODES)
SUFFIX_SET = frozenset(int(c) for c in ab.SUFFIX_CODES)
INFIX_SET = frozenset(int(c) for c in ab.INFIX_CODES)

# Root-source tags (shared with the JAX implementation).
SRC_NONE = 0          # no root found
SRC_TRI = 1           # direct trilateral match
SRC_QUAD = 2          # direct quadrilateral match
SRC_RESTORED = 3      # Restore-Original-Form (hollow verb, ا→و)
SRC_DEINFIX_TRI = 4   # Remove-Infix on a quadrilateral stem → trilateral
SRC_DEINFIX_BI = 5    # Remove-Infix on a trilateral stem → bilateral
# extended rule pool (beyond-paper; the paper's §7 future work)
SRC_EXT_DEFECTIVE = 6  # final ى → ي (defective verbs: سقى → سقي)
SRC_EXT_HOLLOW_Y = 7   # hollow ا → ي (باع → بيع)

ALEF_MAQSURA = 30  # dense code of ى (see alphabet.CP_TO_CODE ordering)


@dataclass
class RootDict:
    """Stored root lists (dense-code tuples)."""

    tri: frozenset = field(default_factory=frozenset)    # {(c0,c1,c2)}
    quad: frozenset = field(default_factory=frozenset)   # {(c0,c1,c2,c3)}
    bi: frozenset = field(default_factory=frozenset)     # {(c0,c1)}

    @staticmethod
    def from_words(tri=(), quad=(), bi=()):
        enc = lambda w: tuple(int(c) for c in ab.encode_word(w) if c)
        return RootDict(
            tri=frozenset(enc(w) for w in tri),
            quad=frozenset(enc(w) for w in quad),
            bi=frozenset(enc(w) for w in bi),
        )


def check_and_produce(word: list[int]):
    """Stages 1-2: affix checks + contiguous-run masking.

    Returns (pp, ps): pp[i] true iff chars 0..i form a valid prefix run
    (i < 5); ps[j] true iff chars j..n-1 are all suffix letters.
    """
    n = len(word)
    pp = []
    run = True
    seen_yeh = False
    for i in range(min(5, n)):
        if seen_yeh:
            run = False
        run = run and word[i] in PREFIX_SET
        pp.append(run)
        if word[i] == ab.YEH:
            seen_yeh = True
    ps = [False] * n
    run = True
    for j in range(n - 1, -1, -1):
        run = run and word[j] in SUFFIX_SET
        ps[j] = run
    return pp, ps


def generate_stems(word: list[int]):
    """Stages 3-4: substring truncation + size filter (VHDL Fig 12 order).

    Returns (tri, quad): lists of stems in prefix-cut-ascending order, with
    validity implied by inclusion.
    """
    n = len(word)
    pp, ps = check_and_produce(word)

    def p_valid(p):
        return p == -1 or (p < len(pp) and pp[p])

    def s_valid(s):
        return s == n or (0 <= s < n and ps[s])

    tri, quad = [], []
    for p in range(-1, 5):
        if not p_valid(p):
            continue
        for L, out in ((3, tri), (4, quad)):
            s = p + 1 + L
            if s <= n and s_valid(s):
                out.append(tuple(word[p + 1 : s]))
    return tri, quad


def extract_root(word_codes, roots: RootDict, infix: bool = True,
                 extended: bool = False):
    """Full stage-5 compare + infix recovery. Returns (root_tuple, source).

    Priority: direct tri > direct quad > restored tri (ا→و) >
    remove-infix quad→tri > remove-infix tri→bi
    [> extended: final ى→ي > hollow ا→ي].

    extended=True enables the beyond-paper rule pool (the paper's §7
    future work: "widening the pool of implemented rules").
    """
    word = [int(c) for c in word_codes if int(c) != 0]
    tri, quad = generate_stems(word)

    for st in tri:
        if st in roots.tri:
            return st, SRC_TRI
    for st in quad:
        if st in roots.quad:
            return st, SRC_QUAD
    if infix:
        # Restore Original Form (Fig 19): 2nd char ا → و on trilaterals.
        for st in tri:
            if st[1] == ab.ALEF:
                cand = (st[0], ab.WAW, st[2])
                if cand in roots.tri:
                    return cand, SRC_RESTORED
        # Remove Infix (Fig 18): drop infix 2nd char.
        for st in quad:
            if st[1] in INFIX_SET:
                cand = (st[0], st[2], st[3])
                if cand in roots.tri:
                    return cand, SRC_DEINFIX_TRI
        for st in tri:
            if st[1] in INFIX_SET:
                cand = (st[0], st[2])
                if cand in roots.bi:
                    return cand, SRC_DEINFIX_BI
    if extended:
        for st in tri:
            if st[2] == ALEF_MAQSURA:  # defective: سقى → سقي
                cand = (st[0], st[1], ab.YEH)
                if cand in roots.tri:
                    return cand, SRC_EXT_DEFECTIVE
        for st in tri:
            if st[1] == ab.ALEF:       # hollow-ي: باع → بيع
                cand = (st[0], ab.YEH, st[2])
                if cand in roots.tri:
                    return cand, SRC_EXT_HOLLOW_Y
    return (), SRC_NONE


def stem_word(text: str, roots: RootDict, infix: bool = True,
              extended: bool = False) -> tuple[str, int]:
    """Convenience: string in, (root string, source tag) out."""
    codes = ab.encode_word(text)
    root, src = extract_root(codes, roots, infix=infix, extended=extended)
    return ab.decode_word(root), src

"""The stemmer's work, counted from the cell's words and not from how a
kernel does it: the least time of a batch of stemmer launches.

Bytes: each word row in (16 x int32), its root (4 x int32) and source out,
and the dictionary's keys once a launch. Operations: stages 1-4 of a word
(the count of its letters 16, the prefix run 5 x 4, the suffix run 16 x 3,
then for each of 6 prefix cuts two validity tests ~10, five packs x 6, the
infix test 3 and the flags ~6); the dictionary search is left out, so the
count is a lower bound. The profiler's names of the resident (K1) and
streamed (K2) kernels."""
from stembench import peaks

KERNELS = r"fused_resident_kernel|stem_streamed_kernel"
WORD_BYTES = 16 * 4 + 4 * 4 + 4
OPS_PER_WORD = 16 + 5 * 4 + 16 * 3 + 6 * (10 + 5 * 6 + 3 + 6)


def least_s(words: int, launches: int, dict_keys: int) -> float:
    return peaks.least_s(words * WORD_BYTES + launches * 4 * dict_keys,
                         words * OPS_PER_WORD)

"""Configurations for the paper's own system (the stemmer pipeline)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class StemmerConfig:
    """Mirrors the paper's processor parameters + the batch knobs."""

    dict_tri: int = 2000          # trilateral dictionary size
    dict_quad: int = 200
    infix: bool = True            # §6.3 infix processing on/off
    backend: str = "sorted"       # dense | sorted | pallas
    batch: int = 65536            # words per step ("register file" width)
    microbatch: int = 4096        # pipelined-processor microbatch
    n_stages: int = 5             # paper's five pipeline stages


# The paper's three execution models (software, non-pipelined, pipelined
# with comparator banks) and the pipelined one with the sorted search.
PRESETS = {
    "software": StemmerConfig(backend="dense", batch=1),
    "non_pipelined": StemmerConfig(backend="dense"),
    "pipelined": StemmerConfig(backend="pallas"),
    "pipelined_sorted": StemmerConfig(backend="sorted"),
}

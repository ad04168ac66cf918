"""Batch analytics: corpus-scale root -> (doc, position) inverted indexing.

The counterpart of ``repro.index``: corpus chunks stream through the
stemmer kernels into the postings kernel (K5) with no per-word host work,
and checkpoint per chunk.
"""
from repro_torch.index.builder import (IndexPartial, RootIndex,
                                       build_corpus_index, build_vocab,
                                       merge_partials)
from repro_torch.index.reference import host_index, host_root_ids

__all__ = [
    "IndexPartial", "RootIndex", "build_corpus_index", "build_vocab",
    "merge_partials", "host_index", "host_root_ids",
]

"""Accuracy analysis harness (paper Tables 6 and 7 analogues)."""
from __future__ import annotations

from collections import Counter, defaultdict
from dataclasses import dataclass, field

from repro_torch import device as devmod
from repro_torch.core import alphabet as ab
from repro_torch.core import corpus as corpus_mod
from repro_torch.core import pyref, stemmer


@dataclass
class AccuracyReport:
    total: int = 0
    correct: int = 0
    by_source: Counter = field(default_factory=Counter)
    per_root: dict = field(default_factory=dict)  # root -> (actual, correct)

    @property
    def accuracy(self) -> float:
        """Word-level accuracy (stricter than the paper's measure)."""
        return self.correct / max(1, self.total)

    @property
    def root_recall(self) -> float:
        """The paper's Table-6 measure: fraction of distinct ground-truth
        roots successfully extracted at least once anywhere in the corpus."""
        hit = sum(1 for a, c in self.per_root.values() if c > 0)
        return hit / max(1, len(self.per_root))


def _root_matches(pred_codes, pred_src: int, truth: str) -> bool:
    pred = ab.decode_word(pred_codes)
    if pred == truth:
        return True
    # A bilateral extraction matches a geminated trilateral truth (مد ≡ مدد)
    if pred_src == pyref.SRC_DEINFIX_BI and len(pred) == 2:
        return truth in (pred + pred[1], pred)
    return False


def evaluate(words: list[str], truths: list[str], roots: pyref.RootDict, *,
             infix: bool = True, backend: str = "sorted",
             extended: bool = False, batch: int = 4096,
             device=devmod.DEFAULT_DEVICE) -> AccuracyReport:
    enc = corpus_mod.encode_corpus(words)
    dict_arrays = stemmer.RootDictArrays.from_rootdict(roots, device=device)
    rep = AccuracyReport()
    per_root = defaultdict(lambda: [0, 0])
    for i in range(0, len(words), batch):
        chunk = enc[i:i + batch]
        pred_roots, pred_src = stemmer.stem_batch(
            chunk, dict_arrays, infix=infix, backend=backend,
            extended=extended, device=device)
        pred_roots = pred_roots.cpu().numpy()
        pred_src = pred_src.cpu().numpy()
        for j in range(chunk.shape[0]):
            truth = truths[i + j]
            ok = _root_matches(pred_roots[j], int(pred_src[j]), truth)
            rep.total += 1
            rep.correct += int(ok)
            rep.by_source[int(pred_src[j])] += 1
            per_root[truth][0] += 1
            per_root[truth][1] += int(ok)
    rep.per_root = {r: tuple(v) for r, v in per_root.items()}
    return rep


def table6(n_words: int = 20000, seed: int = 0, backend: str = "sorted",
           device=devmod.DEFAULT_DEVICE):
    """Accuracy with vs without infix processing (paper Table 6)."""
    words, truths, _ = corpus_mod.build_corpus(n_words, seed)
    roots = corpus_mod.build_dictionary()
    with_infix = evaluate(words, truths, roots, infix=True, backend=backend,
                          device=device)
    without = evaluate(words, truths, roots, infix=False, backend=backend,
                       device=device)
    return {"with_infix": with_infix, "without_infix": without}


def table7(n_words: int = 20000, seed: int = 0, top_k: int = 10,
           device=devmod.DEFAULT_DEVICE):
    """Per-root accuracy for the highest-frequency roots (paper Table 7):
    rows of {root, actual, with_infix, without_infix}."""
    words, truths, _ = corpus_mod.build_corpus(n_words, seed)
    roots = corpus_mod.build_dictionary()
    rep_with = evaluate(words, truths, roots, infix=True, device=device)
    rep_wo = evaluate(words, truths, roots, infix=False, device=device)
    freq = Counter(truths)
    rows = []
    for root, actual in freq.most_common(top_k):
        w = rep_with.per_root.get(root, (0, 0))
        wo = rep_wo.per_root.get(root, (0, 0))
        rows.append({"root": root, "actual": actual, "with_infix": w[1],
                     "without_infix": wo[1]})
    return rows

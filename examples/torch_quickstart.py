"""Quickstart: extract Arabic verb roots with the port's batched stemmer.

The PyTorch counterpart of ``examples/quickstart.py``: the same seven
words through ``core.stemmer.stem_batch(backend="sorted")`` on the chosen
device, and the same table. Each row is then checked against the port's
one-word host algorithm (``core.pyref.stem_word``); the script exits
non-zero on a mismatch.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cuda:0]
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

from repro_torch import device as devmod
from repro_torch.core import alphabet as ab
from repro_torch.core import corpus, pyref, stemmer

SOURCE_NAMES = {
    pyref.SRC_NONE: "none",
    pyref.SRC_TRI: "trilateral",
    pyref.SRC_QUAD: "quadrilateral",
    pyref.SRC_RESTORED: "restored (hollow ا→و)",
    pyref.SRC_DEINFIX_TRI: "remove-infix (quad→tri)",
    pyref.SRC_DEINFIX_BI: "remove-infix (tri→bi)",
}

WORDS = [
    "أفاستسقيناكموها",  # the paper's flagship example -> سقي
    "سيلعبون",           # Table 3 example -> لعب
    "فتزحزحت",           # Fig 14 quadrilateral -> زحزح
    "قال",               # hollow verb -> قول via Restore-Original-Form
    "كاتب",              # form III -> كتب via Remove-Infix
    "يدرسون",            # plain present plural -> درس
    "والمعلمون",         # not a verb: expect no/incidental root
]


def main(argv=None):
    """-> [(word, root, source name)], the rows of the printed table."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda:0",
                    help="where the stemmer runs (cuda:N or cpu)")
    args = ap.parse_args(argv)
    dev = devmod.resolve(args.device)

    roots = corpus.build_dictionary()
    dict_arrays = stemmer.RootDictArrays.from_rootdict(roots, device=dev)
    enc = corpus.encode_corpus(WORDS)

    extracted, sources = stemmer.stem_batch(enc, dict_arrays,
                                            backend="sorted", device=dev)
    print(f"{'word':>18s} | {'root':>6s} | source")
    print("-" * 54)
    rows = []
    for w, r, s in zip(WORDS, extracted.cpu().tolist(),
                       sources.cpu().tolist()):
        root = ab.decode_word([int(c) for c in r])
        print(f"{w:>18s} | {root:>6s} | {SOURCE_NAMES[int(s)]}")
        rows.append((w, root, SOURCE_NAMES[int(s)]))
    # the one-word host algorithm, word by word
    for w, root, src in rows:
        want_root, want_src = pyref.stem_word(w, roots)
        if (root, src) != (want_root, SOURCE_NAMES[want_src]):
            raise SystemExit(f"{w}: stem_batch gave ({root}, {src}), the"
                             f" host algorithm ({want_root},"
                             f" {SOURCE_NAMES[want_src]})")
    return rows


if __name__ == "__main__":
    main()

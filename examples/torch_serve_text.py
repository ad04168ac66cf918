"""Stream raw Quranic text through the port's text-analysis serving path.

The PyTorch counterpart of ``examples/serve_text.py``, with its documents,
sizes and lines. A Surat Al-Ankabut excerpt (29:1-3, fully vocalised:
diacritics, alef-wasla, madda) plus synthesised cliticised corpus
documents go through Engine + TextAnalysisWorkload: the text front end
(K4 on a card) segments and normalises the raw codepoints into word
tiles, the stemmer megakernel (K1) serves them through the
dispatch/retire ring, and every per-token (root, source, byte_span) is
checked bit-identical to the host pipeline (``textnorm.analyze_text_py``
-> ``stem_batch``); the script exits non-zero on any mismatch.

  PYTHONPATH=src python examples/torch_serve_text.py [--device cuda:0]
  PYTHONPATH=src python examples/torch_serve_text.py --device cpu
"""
import argparse
import time

import numpy as np

from repro_torch import device as devmod
from repro_torch.core import corpus, stemmer
from repro_torch.core import textnorm as tn
from repro_torch.serve import DictStore, Engine, TextAnalysisWorkload

# Surat Al-Ankabut 29:1-3 (vocalised Quranic orthography)
ANKABUT = (
    "الم "
    "أَحَسِبَ النَّاسُ أَن يُتْرَكُوا أَن يَقُولُوا آمَنَّا "
    "وَهُمْ لَا يُفْتَنُونَ "
    "وَلَقَدْ فَتَنَّا الَّذِينَ مِن قَبْلِهِمْ "
    "فَلَيَعْلَمَنَّ اللَّهُ الَّذِينَ صَدَقُوا "
    "وَلَيَعْلَمَنَّ الْكَاذِبِينَ"
)

BLOCK_B = 64


def documents():
    """The excerpt + cliticised corpus documents (strip path exercised)."""
    words, _, _ = corpus.build_corpus(n_words=120, seed=1)
    pro = ("وال", "ب", "ف", "لل", "ك", "")
    return [ANKABUT] + [
        " ".join(pro[j % len(pro)] + w
                 for j, w in enumerate(words[i * 30:(i + 1) * 30]))
        for i in range(4)
    ]


def check(ok, what):
    if not ok:
        raise SystemExit(f"serve_text: {what}")


def main(argv=None):
    """-> {"documents", "tokens": tokens checked, "ayah": the first six
    (surface, root, byte span) of the excerpt}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda:0",
                    help="where the engine serves (cuda:N or cpu)")
    args = ap.parse_args(argv)
    dev = devmod.resolve(args.device)

    d = corpus.build_dictionary(n_tri=800, n_quad=100, seed=0)
    arrays = stemmer.RootDictArrays.from_rootdict(d, device=dev)
    store = DictStore(arrays, device=dev)
    eng = Engine(TextAnalysisWorkload(store, block_b=BLOCK_B,
                                      char_block=512, megabatch_tiles=2))

    docs = documents()
    n_bytes = sum(len(doc.encode("utf-8")) for doc in docs)

    t0 = time.time()
    rids = [eng.submit(doc) for doc in docs]
    rep = eng.run_until_drained()
    dt = time.time() - t0

    n_words = sum(eng.result(r).n_words for r in rids)
    print(f"served {len(docs)} documents / {n_bytes} bytes / {n_words}"
          f" words in {dt:.2f}s ({n_bytes / dt:.0f} B/s,"
          f" {n_words / dt:.1f} Wps, {rep.ticks} ticks)")

    # bit-exact parity: every token vs the host pipeline + stem_batch
    checked = 0
    for rid, doc in zip(rids, docs):
        req = eng.result(rid)
        check(req.done and len(req.docs) == 1, f"req {rid} not served whole")
        want_w, want_spans = tn.analyze_text_py(doc)
        check(req.n_words == want_w.shape[0],
              f"req {rid}: {req.n_words} tokens vs host {want_w.shape[0]}")
        check(np.array_equal(req.words, want_w), f"req {rid}: words differ")
        check(np.array_equal(req.spans, want_spans),
              f"req {rid}: spans differ")
        want_r, want_s = stemmer.stem_batch(want_w, arrays, device=dev)
        check(np.array_equal(req.roots, want_r.cpu().numpy()),
              f"req {rid}: roots differ")
        check(np.array_equal(req.sources, want_s.cpu().numpy()),
              f"req {rid}: sources differ")
        # spans must round-trip through the document bytes
        raw = doc.encode("utf-8")
        for (b0, b1) in req.spans:
            check(0 <= b0 < b1 <= len(raw), f"req {rid}: span ({b0}, {b1})")
            raw[b0:b1].decode("utf-8")       # valid utf-8 or raises
        checked += req.n_words
    check(checked == n_words, f"checked {checked} of {n_words} tokens")
    print(f"parity ok: {checked} tokens bit-identical to the host"
          " normalise->segment->stem_batch pipeline")

    ayah = eng.result(rids[0]).analyses()[0]
    raw = ANKABUT.encode("utf-8")
    shown = []
    for root, _src, (b0, b1) in ayah[:6]:
        surface = raw[b0:b1].decode("utf-8")
        print(f"  {surface!r} -> root {root or '-'!r} bytes ({b0}, {b1})")
        shown.append((surface, root, (b0, b1)))
    return {"documents": len(docs), "tokens": checked, "ayah": shown}


if __name__ == "__main__":
    main()

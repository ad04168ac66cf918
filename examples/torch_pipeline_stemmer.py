"""The paper's pipelined processor on a mesh: the 5-stage stemmer on a
5-entry ``("stage",)`` mesh through the port's ``dist.pipeline``.

The PyTorch counterpart of ``examples/pipeline_stemmer.py``. One process
drives the five entries; each may be its own device or the same one
repeated (``Mesh.of(["cuda:0"] * 5)`` runs the five stages one after
another on one card, the candidates stage through K6). Prints word ->
root pairs and checks the pipeline against ``core.stemmer.stem_batch``.

  PYTHONPATH=src python examples/torch_pipeline_stemmer.py [--device cuda:0]
  PYTHONPATH=src python examples/torch_pipeline_stemmer.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.core import alphabet as ab
from repro_torch.core import corpus, stemmer
from repro_torch.dist import pipeline
from repro_torch.launch.mesh import Mesh

STAGES = 5


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda:0",
                    help="the device every stage runs on (cuda:N or cpu)")
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--microbatch-words", type=int, default=8)
    args = ap.parse_args(argv)

    mesh = Mesh.of([args.device] * STAGES, axis="stage")
    dev = mesh.devices[0]
    roots = corpus.build_dictionary(n_tri=800, n_quad=100)
    da = stemmer.RootDictArrays.from_rootdict(roots, device=dev)

    m, mb = args.microbatches, args.microbatch_words
    words, _, _ = corpus.build_corpus(n_words=m * mb, seed=3)
    enc = torch.from_numpy(corpus.encode_corpus(words)).to(dev)
    bundle = {
        "words": enc.reshape(m, mb, ab.MAXLEN),
        "keys": torch.zeros((m, mb, 32), dtype=torch.int32, device=dev),
        "valid": torch.zeros((m, mb, 32), dtype=torch.int32, device=dev),
        "root": torch.zeros((m, mb, 4), dtype=torch.int32, device=dev),
        "source": torch.zeros((m, mb), dtype=torch.int32, device=dev),
    }
    out = pipeline.pipeline_map(pipeline.stemmer_stage_fns(da), bundle, mesh,
                                axis="stage")

    roots_flat = out["root"].reshape(-1, 4).cpu().numpy()
    for i, w in enumerate(words[:8]):
        print(f"{w:>16s} -> {ab.decode_word([int(c) for c in roots_flat[i]])}")
    # the single-device batch path, on the same device
    ref_roots, ref_src = stemmer.stem_batch(enc, da, device=dev)
    np.testing.assert_array_equal(roots_flat, ref_roots.cpu().numpy())
    np.testing.assert_array_equal(out["source"].reshape(-1).cpu().numpy(),
                                  ref_src.cpu().numpy())
    print(f"pipeline output on {STAGES} x {dev} == single-device batch"
          " output")
    return out


if __name__ == "__main__":
    main()

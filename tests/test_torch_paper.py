"""The port's paper presets (repro_torch.configs.paper) and data pipeline
(repro_torch.data.pipeline) against the JAX package: the presets field by
field, MorphPreprocessor's (tokens, root ids) and the first batches of
both LM streams identical."""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import paper as rpaper  # noqa: E402
from repro.data import pipeline as rpipe  # noqa: E402
from repro_torch.configs import paper as tpaper  # noqa: E402
from repro_torch.core import corpus as tcorpus  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402


def test_presets_equal_field_by_field():
    assert list(tpaper.PRESETS) == list(rpaper.PRESETS)
    for name, cfg in tpaper.PRESETS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            rpaper.PRESETS[name]), name
    assert dataclasses.asdict(tpaper.StemmerConfig()) == dataclasses.asdict(
        rpaper.StemmerConfig())
    assert tpaper.PRESETS["pipelined"].backend == "pallas"


@pytest.mark.parametrize("backend", ["sorted", "pallas", "fused"])
def test_morph_preprocessor_matches_reference(backend):
    words, _, _ = tcorpus.build_corpus(n_words=300, seed=4)
    got = tpipe.MorphPreprocessor(backend=backend, device="cpu")
    want = rpipe.MorphPreprocessor(backend=backend)
    # the root-id table is rebuilt from the port's own dictionary
    np.testing.assert_array_equal(got._id_keys, want._id_keys)
    assert got.n_roots == want.n_roots
    g_enc, g_ids = got(words)
    w_enc, w_ids = want(words)
    np.testing.assert_array_equal(g_enc, np.asarray(w_enc))
    np.testing.assert_array_equal(g_ids, np.asarray(w_ids))
    assert g_ids.dtype == np.int32 and (g_ids > 0).mean() > 0.5


def test_morph_lm_batches_match_reference():
    pre_t = tpipe.MorphPreprocessor(backend="pallas", device="cpu")
    pre_r = rpipe.MorphPreprocessor(backend="pallas")
    got = list(itertools.islice(tpipe.morph_lm_batches(64, 32, seed=2,
                                                        preproc=pre_t), 3))
    want = list(itertools.islice(rpipe.morph_lm_batches(64, 32, seed=2,
                                                        preproc=pre_r), 3))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]))


def test_synthetic_lm_batches_match_reference():
    kw = dict(vocab=512, batch=4, seq=16, seed=3, effective_vocab=64)
    got = list(itertools.islice(tpipe.synthetic_lm_batches(**kw), 3))
    want = list(itertools.islice(rpipe.synthetic_lm_batches(**kw), 3))
    for g, w in zip(got, want):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(g[k], w[k])


def test_preprocessor_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        tpipe.MorphPreprocessor()

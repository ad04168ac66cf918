"""The port's TextAnalysisWorkload (repro_torch.serve.text): raw documents
through the unchanged Engine machinery, held to the reference's host
pipeline (textnorm.analyze_text_py -> stem_batch) across all three front
ends, resident and streamed dictionaries, megabatch on and off, the
persistent kernel and a hot swap landing mid-stream. Every compared
output is int32 and must be identical."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import alphabet as rab  # noqa: E402
from repro.core import corpus as rcorpus  # noqa: E402
from repro.core import stemmer as rstemmer  # noqa: E402
from repro.core import textnorm as rtn  # noqa: E402
from repro.launch.serve import build_documents as rbuild_documents  # noqa: E402
from repro_torch.core import corpus as tcorpus  # noqa: E402
from repro_torch.core import stemmer as tstemmer  # noqa: E402
from repro_torch.launch.serve import build_documents  # noqa: E402
from repro_torch.serve import (DictStore, Engine, StemmerWorkload,  # noqa: E402
                               TextAnalysisWorkload, TextRequest, Workload)

CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def arrays():
    da = rstemmer.RootDictArrays.from_rootdict(
        rcorpus.build_dictionary(n_tri=400, n_quad=60, seed=0))
    return da, tstemmer.RootDictArrays.from_numpy(
        np.asarray(da.tri), np.asarray(da.quad), np.asarray(da.bi), **CPU)


@pytest.fixture(scope="module")
def docs():
    got = build_documents(6, 32, seed=2)
    assert got == rbuild_documents(6, 32, seed=2)
    return got


def _ref_arrays(tda):
    return rstemmer.RootDictArrays(*(jnp.asarray(t) for t in tda.numpy()))


def _check(req, doc_batch, da):
    """One request against the reference's host pipeline."""
    assert req.done
    words, spans, ids = [], [], []
    for i, d in enumerate(doc_batch):
        w, s = rtn.analyze_text_py(d)
        words.append(w)
        spans.append(s)
        ids.append(np.full(w.shape[0], i, np.int32))
    w = np.concatenate(words) if words else np.zeros((0, 16), np.int32)
    r, src = rstemmer.stem_batch(jnp.asarray(w), da)
    assert req.n_words == w.shape[0]
    np.testing.assert_array_equal(req.words, w)
    np.testing.assert_array_equal(
        req.spans, np.concatenate(spans) if spans else np.zeros((0, 2)))
    np.testing.assert_array_equal(
        req.doc_ids, np.concatenate(ids) if ids else np.zeros(0))
    np.testing.assert_array_equal(req.roots, np.asarray(r))
    np.testing.assert_array_equal(req.sources, np.asarray(src))
    assert req.n_bytes == sum(len(d.encode("utf-8")) for d in doc_batch)


def _requests(docs):
    # multi-doc, single-doc list, bare string, and a batch with an empty
    # and a punctuation-only document in the middle
    return [docs[:3], [docs[3]], docs[4], [docs[5], "", "،؟ !", docs[0]]]


def _serve(workload, payloads):
    eng = Engine(workload)
    rids = [eng.submit(p) for p in payloads]
    assert eng.run_until_drained().drained
    return eng, rids


def _batch(payload):
    return [payload] if isinstance(payload, str) else list(payload)


@pytest.mark.parametrize("frontend", ["kernel", "reference", "host"])
def test_text_serve_parity_all_frontends(arrays, docs, frontend):
    da, tda = arrays
    eng, rids = _serve(
        TextAnalysisWorkload(DictStore(tda, **CPU), block_b=32,
                             char_block=256, frontend=frontend),
        _requests(docs))
    for rid, payload in zip(rids, _requests(docs)):
        _check(eng.result(rid), _batch(payload), da)


@pytest.mark.parametrize("residency,megabatch_tiles",
                         [("resident", 2), ("streamed", 1), ("streamed", 2)])
def test_text_serve_residency_x_megabatch(arrays, docs, residency,
                                          megabatch_tiles):
    _, tda = arrays
    use = (tcorpus.grow_root_arrays(tda, 1 << 14, seed=3)
           if residency == "streamed" else tda)
    store = DictStore(use, residency=residency, dict_block_r=8, **CPU)
    eng, rids = _serve(
        TextAnalysisWorkload(store, block_b=32, char_block=256,
                             megabatch_tiles=megabatch_tiles),
        _requests(docs))
    for rid, payload in zip(rids, _requests(docs)):
        _check(eng.result(rid), _batch(payload), _ref_arrays(use))


@pytest.mark.parametrize("residency", ["resident", "streamed"])
def test_text_serve_persistent(arrays, docs, residency):
    _, tda = arrays
    use = (tcorpus.grow_root_arrays(tda, 1 << 14, seed=3)
           if residency == "streamed" else tda)
    store = DictStore(use, residency=residency, dict_block_r=8, **CPU)
    wl = TextAnalysisWorkload(store, block_b=32, char_block=256,
                              persistent=True, megabatch_tiles=2)
    eng, rids = _serve(wl, [docs[:2], docs[2:4]])
    for rid, payload in zip(rids, [docs[:2], docs[2:4]]):
        _check(eng.result(rid), list(payload), _ref_arrays(use))
    assert wl.flag_tiles == wl.checksum_tiles > 0


def test_text_hot_swap_mid_stream(arrays, docs):
    _, tda = arrays
    grown = tcorpus.grow_root_arrays(tda, 2048, seed=7)
    store = DictStore(tda, **CPU)
    eng = Engine(TextAnalysisWorkload(store, block_b=16, char_block=256,
                                      max_inflight=2))
    rids = [eng.submit([d]) for d in docs]
    for _ in range(2):
        eng.step()
    store.publish(grown)
    assert eng.run_until_drained().drained
    versions = np.concatenate([eng.result(r).dict_versions for r in rids])
    assert set(versions.tolist()) == {0, 1}   # the swap landed mid-stream
    for rid, d in zip(rids, docs):
        req = eng.result(rid)
        w, s = rtn.analyze_text_py(d)
        np.testing.assert_array_equal(req.words, w)
        np.testing.assert_array_equal(req.spans, s)
        # every word's root must match the version that served it
        for use, ver in ((tda, 0), (grown, 1)):
            sel = req.dict_versions == ver
            if sel.any():
                r, src = rstemmer.stem_batch(jnp.asarray(w[sel]),
                                             _ref_arrays(use))
                np.testing.assert_array_equal(req.roots[sel], np.asarray(r))
                np.testing.assert_array_equal(req.sources[sel],
                                              np.asarray(src))


def test_text_analyses_scatter_per_document(arrays, docs):
    da, tda = arrays
    batch = [docs[0], "", docs[1]]
    eng, rids = _serve(TextAnalysisWorkload(DictStore(tda, **CPU),
                                            block_b=32, char_block=256),
                       [batch])
    per_doc = eng.result(rids[0]).analyses()
    assert len(per_doc) == 3 and per_doc[1] == []
    for i, d in enumerate(batch):
        w, s = rtn.analyze_text_py(d)
        assert len(per_doc[i]) == w.shape[0]
        r, src = rstemmer.stem_batch(jnp.asarray(w), da)
        for (root, got_src, span), want_r, want_src, want_s in zip(
                per_doc[i], np.asarray(r), np.asarray(src), s):
            assert root == rab.decode_word(want_r)
            assert got_src == int(want_src)
            assert span == (int(want_s[0]), int(want_s[1]))


def test_text_workload_surface(arrays):
    _, tda = arrays
    store = DictStore(tda, **CPU)
    w = TextAnalysisWorkload(store, char_block=256)
    assert [w._char_bucket(n) for n in (1, 256, 257, 5000)] == \
        [256, 256, 512, 8192]
    assert isinstance(w, (Workload, StemmerWorkload))
    assert isinstance(w.make_request(0, "قلم"), TextRequest)
    with pytest.raises(ValueError, match="frontend"):
        TextAnalysisWorkload(store, frontend="gpu")
    with pytest.raises(ValueError, match="char_block"):
        TextAnalysisWorkload(store, char_block=64)
    with pytest.raises(ValueError, match="str documents"):
        w.make_request(0, [b"bytes not str"])
    with pytest.raises(ValueError, match="unknown text request options"):
        w.make_request(0, ["قلم"], max_new=4)
    eng, rids = _serve(TextAnalysisWorkload(store, block_b=16), [[], ""])
    for rid in rids:
        req = eng.result(rid)
        assert req.done and req.n_words == 0
        assert req.analyses() == ([] if req.docs == [] else [[]])


@pytest.mark.cuda
@pytest.mark.parametrize("persistent", [False, True])
def test_text_serve_on_card_matches_host_frontend(arrays, docs, persistent):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _, tda = arrays
    out = {}
    for frontend, dev in (("kernel", "cuda"), ("host", "cpu")):
        store = DictStore(tda, device=dev)
        eng, rids = _serve(
            TextAnalysisWorkload(store, block_b=32, char_block=256,
                                 frontend=frontend, persistent=persistent,
                                 megabatch_tiles=2), _requests(docs))
        out[frontend] = [eng.result(r) for r in rids]
    for got, want in zip(out["kernel"], out["host"]):
        for name in ("words", "spans", "doc_ids", "roots", "sources"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))

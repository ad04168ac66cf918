"""The port's corpus index (repro_torch.index and the index ops) against
the JAX package: the vocabulary, the root-id map, build_root_index on
words and on text, the document stream, and build_corpus_index with
checkpoints written by either package. Every compared output is int32
(counts int64 after the merge, as in the reference) and must be
identical."""
import itertools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import index as rix  # noqa: E402
from repro.core import corpus as rcorpus  # noqa: E402
from repro.core import stemmer as rstemmer  # noqa: E402
from repro.core import textnorm as rtn  # noqa: E402
from repro.index import builder as rbuilder  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro_torch import index as tix  # noqa: E402
from repro_torch.core import corpus as tcorpus  # noqa: E402
from repro_torch.core import stemmer as tstemmer  # noqa: E402
from repro_torch.index import builder as tbuilder  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.serve import DictStore  # noqa: E402

CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def table():
    return tcorpus.build_token_table(forms_per_root=6)


@pytest.fixture(scope="module")
def dicts():
    da = rstemmer.RootDictArrays.from_rootdict(
        rcorpus.build_dictionary(n_tri=300, n_quad=40, seed=0))
    tda = tstemmer.RootDictArrays.from_numpy(
        np.asarray(da.tri), np.asarray(da.quad), np.asarray(da.bi), **CPU)
    return da, tda, rix.build_vocab(da)


def _stream(table, n=6144, chunk=2048, seed=3):
    return tcorpus.stream_corpus_words(n, seed=seed, chunk_words=chunk,
                                       words_per_doc=500, table=table)


def _host(tda, vocab, chunks):
    parts = []
    for ch in chunks:
        ids = tix.host_root_ids(ch.words, tda, vocab)
        parts.append(tix.IndexPartial(*tix.host_index(
            ids, ch.doc_ids.astype(np.int32), ch.positions, len(vocab))))
    return tix.merge_partials(parts, vocab)


def _assert_index_equal(got, want):
    for name in ("root_keys", "counts", "offsets", "docs", "positions"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_vocab_and_host_reference_match_reference(dicts, table):
    da, tda, vocab = dicts
    np.testing.assert_array_equal(tix.build_vocab(tda), vocab)
    assert tbuilder.vocab_fingerprint(vocab) == \
        rbuilder.vocab_fingerprint(vocab)
    ch = next(_stream(table, n=3000, chunk=3000))
    ids = tix.host_root_ids(ch.words, tda, vocab)
    np.testing.assert_array_equal(ids, rix.host_root_ids(ch.words, da, vocab))
    for g, w in zip(tix.host_index(ids, ch.doc_ids, ch.positions, len(vocab)),
                    rix.host_index(ids, ch.doc_ids, ch.positions,
                                   len(vocab))):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_root_ids_and_unpack_keys_match_reference(dicts):
    _, _, vocab = dicts
    rng = np.random.default_rng(4)
    root = rng.integers(0, 40, size=(500, 4)).astype(np.int32)
    keys = rng.choice(vocab, size=200)
    root[:200] = np.asarray(rops.unpack_keys(jnp.asarray(keys)))
    source = rng.integers(0, 3, size=500).astype(np.int32)
    want = rops._root_ids(jnp.asarray(root), jnp.asarray(source),
                          jnp.asarray(vocab))
    got = tops._root_ids(torch.from_numpy(root), torch.from_numpy(source),
                         torch.from_numpy(vocab))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tops.unpack_keys(torch.from_numpy(keys)).numpy(),
        np.asarray(rops.unpack_keys(jnp.asarray(keys))))


def test_stream_corpus_docs_matches_reference(table):
    rtable = rcorpus.build_token_table(forms_per_root=6)
    assert rtable.texts == table.texts
    got = list(tcorpus.stream_corpus_docs(1000, seed=6, chunk_words=400,
                                          words_per_doc=40, table=table))
    want = list(rcorpus.stream_corpus_docs(1000, seed=6, chunk_words=400,
                                           words_per_doc=40, table=rtable))
    assert got == want and len(got) == 3
    with pytest.raises(ValueError, match="multiple of"):
        next(tcorpus.stream_corpus_docs(1000, chunk_words=400,
                                        words_per_doc=77, table=table))


def test_build_root_index_matches_reference(dicts, table):
    da, tda, vocab = dicts
    ch = next(_stream(table, n=1500, chunk=1500))
    want = rops.build_root_index(ch.words, da, vocab, ch.doc_ids,
                                 ch.positions, block_b=256, block_w=256)
    got = tops.build_root_index(ch.words, tda, vocab, ch.doc_ids,
                                ch.positions, block_b=256, block_w=256,
                                **CPU)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_build_root_index_text_matches_reference(dicts, table):
    """The text path against the reference's, with a chunk offset and a
    straddling first document, and against the port's own words path."""
    da, tda, vocab = dicts
    n, wpd = 1200, 60
    doc0, docs = next(tcorpus.stream_corpus_docs(n, seed=6, chunk_words=n,
                                                 words_per_doc=wpd,
                                                 table=table))
    chars, _, byte_off = rtn.coalesce_docs(docs)
    want = rops.build_root_index_text(chars, da, vocab, byte_off, doc0=3,
                                      word0_of_doc0=7, block_b=256,
                                      block_w=512)
    got = tops.build_root_index_text(chars, tda, vocab, byte_off, doc0=3,
                                     word0_of_doc0=7, block_b=256,
                                     block_w=512, **CPU)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    wc = next(tcorpus.stream_corpus_words(n, seed=6, chunk_words=n,
                                          words_per_doc=wpd, table=table))
    text = tops.build_root_index_text(chars, tda, vocab, byte_off, doc0=doc0,
                                      block_b=256, block_w=512, **CPU)
    words = tops.build_root_index(wc.words, tda, vocab, wc.doc_ids,
                                  wc.positions, block_b=256, block_w=512,
                                  **CPU)
    n_post = int(words[3])
    assert int(text[3]) == n_post > 0
    np.testing.assert_array_equal(text[0].numpy(), words[0].numpy())
    for k in (1, 2):
        np.testing.assert_array_equal(text[k].numpy()[:n_post],
                                      words[k].numpy()[:n_post])


def test_builder_matches_host_and_merges(dicts, table):
    _, tda, vocab = dicts
    idx = tix.build_corpus_index(_stream(table), tda, block_b=512,
                                 block_w=512, **CPU)
    _assert_index_equal(idx, _host(tda, vocab, list(_stream(table))))
    np.testing.assert_array_equal(idx.offsets,
                                  np.cumsum(idx.counts) - idx.counts)
    assert idx.n_postings == int(idx.counts.sum()) > 0
    docs, poss = idx.postings_for(int(vocab[np.argmax(idx.counts)]))
    assert docs.shape[0] == int(idx.counts.max())


def test_checkpoints_are_compatible_with_reference(dicts, table, tmp_path):
    """A checkpoint the reference wrote for the first two chunks resumes in
    the port (hashes re-verified, chunk 3 computed), and the port's
    manifest and partials carry the reference's fields and arrays; each
    package resumes from the other's full checkpoint without recomputing."""
    da, tda, vocab = dicts
    full = tix.build_corpus_index(_stream(table), tda, block_b=512,
                                  block_w=512, **CPU)
    ref_ckpt = tmp_path / "ref"
    rix.build_corpus_index(itertools.islice(_stream(table), 2), da,
                           checkpoint_dir=str(ref_ckpt), block_b=512,
                           block_w=512)
    resumed = tix.build_corpus_index(_stream(table), tda,
                                     checkpoint_dir=str(ref_ckpt),
                                     resume=True, block_b=512, block_w=512,
                                     **CPU)
    _assert_index_equal(resumed, full)
    assert resumed.dict_versions == (0, 0, 0)

    port_ckpt = tmp_path / "port"
    tix.build_corpus_index(_stream(table), tda,
                           checkpoint_dir=str(port_ckpt), block_b=512,
                           block_w=512, **CPU)
    ref_man = json.loads((ref_ckpt / "manifest.json").read_text())
    port_man = json.loads((port_ckpt / "manifest.json").read_text())
    assert port_man["schema"] == tbuilder.MANIFEST_SCHEMA == 2
    assert {k: v for k, v in port_man.items() if k != "chunks"} == \
        {k: v for k, v in ref_man.items() if k != "chunks"}
    assert len(port_man["chunks"]) == 3
    for got, want in zip(port_man["chunks"], ref_man["chunks"]):
        assert got.keys() == want.keys()
        assert {k: v for k, v in got.items() if k != "sha"} == \
            {k: v for k, v in want.items() if k != "sha"}
    for rec in port_man["chunks"]:
        path = port_ckpt / f"chunk_{rec['i']:06d}.npz"
        assert rbuilder._file_sha(str(path)) == rec["sha"]
        with np.load(path) as got, \
                np.load(ref_ckpt / path.name) as want:
            for key in ("counts", "docs", "positions"):
                assert got[key].dtype == want[key].dtype
                np.testing.assert_array_equal(got[key], want[key])
    # the reference resumes the port's checkpoint without recomputing:
    # every chunk loads, so a stream of the right ranges is enough
    back = rix.build_corpus_index(_stream(table), da,
                                  checkpoint_dir=str(port_ckpt), resume=True,
                                  block_b=512, block_w=512)
    _assert_index_equal(back, full)


def test_resume_recomputes_torn_chunk_and_rejects_divergence(dicts, table,
                                                             tmp_path):
    _, tda, _ = dicts
    ckpt = tmp_path / "ckpt"
    full = tix.build_corpus_index(_stream(table), tda,
                                  checkpoint_dir=str(ckpt), block_b=512,
                                  block_w=512, **CPU)
    (ckpt / "chunk_000001.npz").write_bytes(b"torn")
    resumed = tix.build_corpus_index(_stream(table), tda,
                                     checkpoint_dir=str(ckpt), resume=True,
                                     block_b=512, block_w=512, **CPU)
    _assert_index_equal(resumed, full)
    other = tcorpus.stream_corpus_words(6144, seed=3, chunk_words=1024,
                                        words_per_doc=500, table=table)
    with pytest.raises(ValueError, match="diverges"):
        tix.build_corpus_index(other, tda, checkpoint_dir=str(ckpt),
                               resume=True, block_b=512, block_w=512, **CPU)
    grown = tcorpus.grow_root_arrays(tda, 4096, seed=1)
    with pytest.raises(ValueError, match="vocabulary"):
        tix.build_corpus_index(_stream(table), grown,
                               checkpoint_dir=str(ckpt), resume=True,
                               block_b=512, block_w=512, **CPU)


def test_builder_records_dictstore_versions(dicts, table):
    _, tda, vocab = dicts
    store = DictStore(tda, **CPU)
    chunks = list(_stream(table))

    def publishing_stream():
        for i, ch in enumerate(chunks):
            if i == 1:        # a publish lands between chunks 0 and 1
                store.publish(tcorpus.grow_root_arrays(tda, 2048, seed=8))
            yield ch

    idx = tix.build_corpus_index(publishing_stream(), store, block_b=512,
                                 block_w=512, **CPU)
    assert idx.dict_versions == (0, 1, 1)
    parts = []
    for ch, v in zip(chunks, idx.dict_versions):
        ids = tix.host_root_ids(ch.words, store.get(v).arrays, vocab)
        parts.append(tix.IndexPartial(*tix.host_index(
            ids, ch.doc_ids.astype(np.int32), ch.positions, len(vocab))))
    _assert_index_equal(idx, tix.merge_partials(parts, vocab))


@pytest.mark.cuda
def test_index_on_card_matches_host(dicts, table):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _, tda, vocab = dicts
    arrays = tda.to("cuda")
    idx = tix.build_corpus_index(_stream(table), arrays, block_b=2048,
                                 block_w=2048, device="cuda")
    _assert_index_equal(idx, _host(arrays, vocab, list(_stream(table))))
    n, wpd = 2048, 512
    doc0, docs = next(tcorpus.stream_corpus_docs(n, seed=3, chunk_words=n,
                                                 words_per_doc=wpd,
                                                 table=table))
    chars, _, byte_off = rtn.coalesce_docs(docs)
    got = tops.build_root_index_text(chars, arrays, vocab, byte_off,
                                     doc0=doc0, block_b=2048, block_w=2048,
                                     device="cuda")
    want = tops.build_root_index_text(chars, tda, vocab, byte_off,
                                      doc0=doc0, block_b=2048, block_w=2048,
                                      **CPU)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))

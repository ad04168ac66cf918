"""The port's plain PyTorch stemmer (repro_torch.core) against the JAX
package and the pure-Python oracle: bit-identical int32 outputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import corpus as rcorpus  # noqa: E402
from repro.core import pyref as rpyref  # noqa: E402
from repro.core import stemmer as rstemmer  # noqa: E402
from repro_torch.core import accuracy  # noqa: E402
from repro_torch.core import alphabet as tab  # noqa: E402
from repro_torch.core import corpus as tcorpus  # noqa: E402
from repro_torch.core import pyref as tpyref  # noqa: E402
from repro_torch.core import stemmer as tstemmer  # noqa: E402


@pytest.fixture(scope="module")
def dicts():
    d = rcorpus.build_dictionary(n_tri=400, n_quad=60, seed=0)
    da = rstemmer.RootDictArrays.from_rootdict(d)
    tda = tstemmer.RootDictArrays.from_numpy(
        np.asarray(da.tri), np.asarray(da.quad), np.asarray(da.bi),
        device="cpu")
    return tcorpus.build_dictionary(n_tri=400, n_quad=60, seed=0), da, tda


@pytest.fixture(scope="module")
def words():
    w, _, _ = rcorpus.build_corpus(n_words=300, seed=2)
    return rcorpus.encode_corpus(w)


def _pyref_rows(enc, d, infix, extended):
    roots = np.zeros((enc.shape[0], 4), np.int32)
    srcs = np.zeros(enc.shape[0], np.int32)
    for i, w in enumerate(enc):
        root, src = tpyref.extract_root(w, d, infix=infix, extended=extended)
        roots[i, :len(root)] = root
        srcs[i] = src
    return roots, srcs


@pytest.mark.parametrize("b", [0, 1, 300])
@pytest.mark.parametrize("backend", ["dense", "sorted"])
@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("infix", [True, False])
def test_extract_roots_matches_reference_and_oracle(dicts, words, b, backend,
                                                    extended, infix):
    d, da, tda = dicts
    enc = words[:b]
    got_r, got_s = tstemmer.extract_roots(enc, tda, infix=infix,
                                          backend=backend, extended=extended,
                                          device="cpu")
    assert got_r.dtype == torch.int32 and got_s.dtype == torch.int32
    assert tuple(got_r.shape) == (b, 4) and tuple(got_s.shape) == (b,)
    want_r, want_s = rstemmer.extract_roots(jnp.asarray(enc), da, infix=infix,
                                            backend="sorted",
                                            extended=extended)
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    ora_r, ora_s = _pyref_rows(enc, d, infix, extended)
    np.testing.assert_array_equal(got_r.numpy(), ora_r)
    np.testing.assert_array_equal(got_s.numpy(), ora_s)


def test_stem_batch_fused_backend_on_cpu(dicts, words):
    _, _, tda = dicts
    r1, s1 = tstemmer.stem_batch(words, tda, backend="fused", device="cpu")
    r2, s2 = tstemmer.stem_batch(words, tda, backend="sorted", device="cpu")
    assert torch.equal(r1, r2) and torch.equal(s1, s2)


def test_pack_keys_unpack_round_trip():
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 64, size=(500, 4)).astype(np.int32)
    keys = tstemmer.pack_keys(torch.from_numpy(codes))
    assert keys.dtype == torch.int32
    np.testing.assert_array_equal(
        keys.numpy(), np.asarray(rstemmer.pack_keys(jnp.asarray(codes))))
    for k, c in zip(keys.tolist(), codes.tolist()):
        assert tab.unpack_key(k) == c
        assert tab.pack_key(c) == k


def test_table6_recall_is_exact():
    t = accuracy.table6(n_words=2000, seed=0, device="cpu")
    assert t["with_infix"].root_recall == 0.8914728682170543
    assert t["without_infix"].root_recall == 0.8062015503875969


def test_table7_rows_match_reference():
    """The per-root rows of the paper's Table 7 (the most frequent roots,
    their counts and how many were extracted with and without infix
    processing) equal the reference's."""
    from repro.core import accuracy as raccuracy

    got = accuracy.table7(n_words=2000, seed=0, device="cpu")
    want = raccuracy.table7(n_words=2000, seed=0)
    assert len(got) == 10 and got == want
    assert all(r["with_infix"] >= r["without_infix"] for r in got)


def test_copied_tables_and_corpus_match_reference():
    d = rcorpus.build_dictionary()
    da = rstemmer.RootDictArrays.from_rootdict(d)
    tda = tstemmer.RootDictArrays.from_rootdict(tcorpus.build_dictionary(),
                                                device="cpu")
    for want, got in zip((da.tri, da.quad, da.bi), tda.numpy()):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert rcorpus.build_corpus(200, seed=4) == tcorpus.build_corpus(200,
                                                                     seed=4)
    got = next(tcorpus.stream_corpus_words(3000, seed=5, chunk_words=3000))
    want = next(rcorpus.stream_corpus_words(3000, seed=5, chunk_words=3000))
    np.testing.assert_array_equal(got.words, want.words)
    w = rcorpus.build_corpus(50, seed=1)[0][0]
    assert tpyref.stem_word(w, tcorpus.build_dictionary()) == \
        rpyref.stem_word(w, d)


def test_resolved_handle_pins_residency(dicts):
    _, _, tda = dicts
    h = tstemmer.resolve_dict(tda)
    assert h.residency == "resident"
    assert tstemmer.unwrap_dict(h) == (tda, "resident", None)
    with pytest.raises(ValueError, match="conflicts"):
        tstemmer.unwrap_dict(h, "streamed")
    with pytest.raises(ValueError, match="unknown backend"):
        tstemmer.extract_roots(np.zeros((1, 16), np.int32), tda,
                               backend="bogus", device="cpu")

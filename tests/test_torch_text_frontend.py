"""The port's text front end (repro_torch.core.textnorm and K4,
repro_torch.kernels.text_frontend) against the JAX package: the tables,
the host oracle, the scatter-based reference, the plain kernel against
the interpret-mode Pallas kernel, the g++ build of the kernel's per-word
header, and the text ops. Every compared output is int32 and must be
identical."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import corpus as rcorpus  # noqa: E402
from repro.core import stemmer as rstemmer  # noqa: E402
from repro.core import textnorm as rtn  # noqa: E402
from repro.kernels import text_frontend as rtf  # noqa: E402
from repro_torch.core import stemmer as tstemmer  # noqa: E402
from repro_torch.core import textnorm as ttn  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import text_frontend as ttf  # noqa: E402
from repro_torch.launch.serve import build_documents, edge_documents  # noqa: E402


@pytest.fixture(scope="module")
def docs():
    return edge_documents() + build_documents(4, 48, seed=5)


@pytest.fixture(scope="module")
def tile(docs):
    chars, _, _ = rtn.coalesce_docs(docs)
    return chars


@pytest.fixture(scope="module")
def odd_geometry(tile):
    """Starts and lengths no segmentation emits: negative, past the end
    of the tile (and of its 128-lane padding), longer than MAX_RAW."""
    rng = np.random.default_rng(7)
    starts = rng.integers(-40, tile.shape[0] + 200, size=256)
    lens = rng.integers(-3, 45, size=256)
    starts[:4] = [tile.shape[0] - 1, tile.shape[0] - 2, -1, 0]
    lens[:4] = [40, 3, 5, 0]
    return starts.astype(np.int32), lens.astype(np.int32)


def _host_rows(docs):
    _, _, byte_off = rtn.coalesce_docs(docs)
    rows, spans = [], []
    for off, doc in zip(byte_off, docs):
        w, s = rtn.analyze_text_py(doc)
        rows.append(w)
        spans.append(s + off)
    return np.concatenate(rows), np.concatenate(spans)


def test_tables_match_reference():
    np.testing.assert_array_equal(ttn.CLASS_LUT, rtn.CLASS_LUT)
    np.testing.assert_array_equal(ttn.FW_FLAT, rtn.FW_FLAT)
    np.testing.assert_array_equal(ttn.FW_KEYS, rtn.FW_KEYS)
    assert ttn.CLASS_LUT.dtype == ttn.FW_FLAT.dtype == np.int32
    assert int(ttn.FW_SENTINEL) == int(rtn.FW_SENTINEL)
    assert ttn.PROCLITIC_CODES == rtn.PROCLITIC_CODES
    assert ttn.ENCLITIC_CODES == rtn.ENCLITIC_CODES
    assert (ttn.MAX_RAW, ttn.CMAX, ttn.MIN_STEM) == (rtn.MAX_RAW, rtn.CMAX,
                                                     rtn.MIN_STEM)
    lut, fw = ttn.device_tables("cpu")
    np.testing.assert_array_equal(lut.numpy(), rtn.CLASS_LUT)
    np.testing.assert_array_equal(fw.numpy(), rtn.FW_FLAT)


def test_host_half_matches_reference(docs):
    for d in docs:
        assert ttn.tokenize_py(d) == rtn.tokenize_py(d)
        for got, want in zip(ttn.analyze_text_py(d), rtn.analyze_text_py(d)):
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want)
    for got, want in zip(ttn.coalesce_docs(docs), rtn.coalesce_docs(docs)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert [ttn.utf8_len(c) for c in (0x41, 0x628, 0x800, 0x1F600)] == \
        [rtn.utf8_len(c) for c in (0x41, 0x628, 0x800, 0x1F600)]


def test_classify_codes_matches_reference():
    cps = np.concatenate([np.arange(0x05F0, 0x0710), np.arange(0, 0x80),
                          [0x10FFFF, -1, 0x1F600]]).astype(np.int32)
    got = ttn.classify_codes(torch.from_numpy(cps),
                             ttn.device_tables("cpu")[0])
    want = rtn.classify_codes(jnp.asarray(cps), jnp.asarray(rtn.CLASS_LUT))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("block_w,max_words", [(128, None), (256, None),
                                               (128, 100)])
def test_reference_front_end_matches_reference(tile, block_w, max_words):
    """segment_geometry and frontend_reference, field by field, including
    a word capacity capped below the true count."""
    want_w, want_g = rtn.frontend_reference(tile, block_w=block_w,
                                            max_words=max_words)
    got_w, got_g = ttn.frontend_reference(torch.from_numpy(tile),
                                          block_w=block_w,
                                          max_words=max_words)
    for got, want in ((got_w, want_w), (got_g.starts, want_g.starts),
                      (got_g.lens, want_g.lens), (got_g.spans, want_g.spans),
                      (got_g.n_words, want_g.n_words)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_plain_kernel_matches_pallas_and_host(docs, tile, odd_geometry):
    """Plain K4 against text_frontend_pallas (interpret mode) on the
    segmented tile and on odd geometry, and the segmented rows against
    the host oracle."""
    geo = ttn.segment_geometry(torch.from_numpy(tile), block_w=128)
    starts, lens = odd_geometry
    cases = [(geo.starts.numpy(), geo.lens.numpy()), (starts, lens)]
    for s, n in cases:
        want = rtf.text_frontend_pallas(tile, s, n, block_w=128,
                                        interpret=True)
        got = ttf.text_frontend_plain(torch.from_numpy(tile),
                                      torch.from_numpy(s), torch.from_numpy(n),
                                      block_w=128)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rows, _ = _host_rows(docs)
    got = ttf.text_frontend(torch.from_numpy(tile), geo.starts, geo.lens)
    np.testing.assert_array_equal(got.numpy()[:rows.shape[0]], rows)
    assert not got.numpy()[rows.shape[0]:].any()


def test_host_build_of_frontend_header_matches_plain(tile, odd_geometry):
    """The g++ build of csrc/text_frontend.cuh (every row through the
    per-word rules, empty rows too) bit for bit against plain K4."""
    geo = ttn.segment_geometry(torch.from_numpy(tile), block_w=128)
    starts, lens = odd_geometry
    for s, n in ((geo.starts.numpy(), geo.lens.numpy()), (starts, lens)):
        want = ttf.text_frontend_plain(torch.from_numpy(tile),
                                       torch.from_numpy(s),
                                       torch.from_numpy(n), block_w=128)
        np.testing.assert_array_equal(build.host_text_frontend(tile, s, n),
                                      want.numpy())


def test_text_to_words_matches_host_oracle(docs, tile):
    words, spans, n_words = tops.text_to_words(tile, block_w=256,
                                               device="cpu")
    rows, want_spans = _host_rows(docs)
    n = int(n_words)
    assert n == rows.shape[0] and words.shape[0] % 256 == 0
    np.testing.assert_array_equal(words.numpy()[:n], rows)
    np.testing.assert_array_equal(spans.numpy()[:n], want_spans)
    assert not words.numpy()[n:].any() and not spans.numpy()[n:].any()


@pytest.mark.parametrize("residency", ["resident", "streamed"])
def test_extract_roots_text_matches_reference_stemmer(docs, tile, residency):
    """Text in, roots out, against the host oracle's rows through the
    reference stemmer; block_b defaults to block_w."""
    da = rstemmer.RootDictArrays.from_rootdict(
        rcorpus.build_dictionary(n_tri=400, n_quad=60, seed=0))
    tda = tstemmer.RootDictArrays.from_numpy(
        np.asarray(da.tri), np.asarray(da.quad), np.asarray(da.bi),
        device="cpu")
    root, source, spans, n_words = tops.extract_roots_text(
        tile, tda, residency=residency, dict_block_r=2, device="cpu")
    rows, want_spans = _host_rows(docs)
    want_r, want_s = rstemmer.stem_batch(jnp.asarray(rows), da)
    n = int(n_words)
    np.testing.assert_array_equal(root.numpy()[:n], np.asarray(want_r))
    np.testing.assert_array_equal(source.numpy()[:n], np.asarray(want_s))
    np.testing.assert_array_equal(spans.numpy()[:n], want_spans)
    assert not source.numpy()[n:].any()


def test_guards():
    with pytest.raises(ValueError, match="non-empty"):
        ttn.segment_geometry(torch.zeros(0, dtype=torch.int32))
    z = torch.zeros(100, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of block_w"):
        ttf.text_frontend(z, z[:96], z[:96], block_w=64)
    with pytest.raises(ValueError, match="CUDA"):
        ttf.text_frontend_cuda(z, z[:64], z[:64], block_w=64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tops.text_to_words(np.zeros(8, np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("block_w", [128, 256, 1024])
def test_frontend_kernel_matches_plain_on_card(tile, odd_geometry, block_w):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    t = torch.from_numpy(tile).cuda()
    geo = ttn.segment_geometry(t, block_w=block_w)
    starts, lens = odd_geometry
    cases = [(geo.starts, geo.lens),
             (torch.from_numpy(starts).cuda(), torch.from_numpy(lens).cuda())]
    if block_w <= starts.shape[0]:
        for s, n in cases:
            s, n = s[:s.shape[0] // block_w * block_w], \
                n[:n.shape[0] // block_w * block_w]
            got = ttf.text_frontend_cuda(t, s, n, block_w=block_w)
            torch.cuda.synchronize()
            want = ttf.text_frontend_plain(t, s, n, block_w=block_w)
            assert torch.equal(got, want)
    one = torch.tensor([0x0628], dtype=torch.int32, device="cuda")
    g1 = ttn.segment_geometry(one, block_w=block_w)
    assert torch.equal(ttf.text_frontend_cuda(one, g1.starts, g1.lens,
                                              block_w=block_w),
                       ttf.text_frontend_plain(one, g1.starts, g1.lens,
                                               block_w=block_w))

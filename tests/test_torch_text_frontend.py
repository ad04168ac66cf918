"""The port's text front end (repro_torch.core.textnorm and K4,
repro_torch.kernels.text_frontend) against the JAX package: the tables,
the host oracle, the scatter-based reference, the plain kernel against
the interpret-mode Pallas kernel, the g++ build of the kernel's per-word
header, and the text ops. Every compared output is int32 and must be
identical."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

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


def _segmented(tile):
    geo = ttn.segment_geometry(torch.from_numpy(tile), block_w=128)
    return geo.starts.numpy(), geo.lens.numpy()


def _sparse_blocks(tile):
    """4096 rows, every even piece of 8 rows empty (so block 0 has no live
    row at every lane count: each launch's grid is even and block 0 takes
    pieces 0, grid, 2 grid, ...), the odd pieces a mix of live and empty
    rows."""
    starts, lens = _segmented(tile)
    live = np.flatnonzero(lens > 0)
    rng = np.random.default_rng(11)
    rows = np.arange(4096).reshape(-1, 8)
    slots = rows[1::2].reshape(-1)
    slots = slots[rng.random(slots.size) < 0.6]
    pick = rng.choice(live, size=slots.size)
    s, n = np.zeros(4096, np.int32), np.zeros(4096, np.int32)
    s[slots], n[slots] = starts[pick], lens[pick]
    return s, n


def _words_tile(words):
    chars, _, _ = rtn.coalesce_docs([" ".join(words)])
    return chars


# words of 31, 32 and 40 raw codepoints with marks inside, and of exactly
# MIN_STEM letters left after a proclitic or an enclitic (and one letter
# short of it)
_LONG = ["\u0628\u064e" * 15 + "\u062a",          # 31 raw, 16 letters
         "\u0643\u0651\u062a" * 10 + "\u0628\u064f",  # 32 raw
         "\u0648\u0627\u0644" + "\u0645\u0650" * 18 + "\u0647\u0627",
         "\u0640" * 12 + "\u0643\u062a\u0628" * 9 + "\u0647\u0645"]
_STEM = "\u062f\u0631\u0633"          # three letters, no clitic among them
_MIN_STEM = ["\u0648\u0627\u0644" + _STEM,     # wal + stem
             "\u0628\u0627\u0644" + _STEM,     # bal + stem
             _STEM + "\u0647\u0645\u0627",     # stem + huma
             "\u0648" + _STEM + "\u0647\u0627",  # wa + stem + ha
             "\u0644\u0644" + _STEM,            # lil + stem
             _STEM + "\u0643\u0645",            # stem + kum
             "\u0648\u0627\u0644" + _STEM[:2],   # wal + 2 letters: wa only
             _STEM[:2] + "\u0647\u0645\u0627"]   # 2 letters + huma: none

FRONTEND_CASES = ("segmented", "odd", "sparse blocks", "long words",
                  "min stem")


@pytest.fixture(scope="module")
def frontend_cases(tile, odd_geometry):
    """name -> (tile, starts, lens, plain rows), each plain result held to
    the interpret-mode Pallas kernel once."""
    out = {}
    for name in FRONTEND_CASES:
        t = {"long words": _words_tile(_LONG),
             "min stem": _words_tile(_MIN_STEM)}.get(name, tile)
        if name == "odd":
            s, n = odd_geometry
        elif name == "sparse blocks":
            s, n = _sparse_blocks(t)
        else:
            s, n = _segmented(t)
        want = ttf.text_frontend_plain(torch.from_numpy(t),
                                       torch.from_numpy(s),
                                       torch.from_numpy(n), block_w=128)
        out[name] = (t, s, n, want.numpy())
    return out


@pytest.mark.parametrize("case", FRONTEND_CASES)
def test_frontend_cases_plain_matches_pallas(frontend_cases, case):
    """The cases the lane counts are checked on, plain K4 against the
    interpret-mode Pallas kernel; the long and short words also against
    the host oracle."""
    t, s, n, want = frontend_cases[case]
    ref = rtf.text_frontend_pallas(t, s, n, block_w=128, interpret=True)
    np.testing.assert_array_equal(want, np.asarray(ref))
    if case in ("long words", "min stem"):
        words = _LONG if case == "long words" else _MIN_STEM
        rows, _ = rtn.analyze_text_py(" ".join(words))
        assert rows.shape[0] == len(words)
        np.testing.assert_array_equal(want[:len(words)], rows)
    if case == "min stem":            # the clitics were stripped
        assert (want[:6, 3] == 0).all() and (want[:6, 2] > 0).all()
        assert want[6, 3] > 0 and want[7, 4] > 0


@pytest.mark.parametrize("lanes", build.TEXT_LANES)
@pytest.mark.parametrize("case", FRONTEND_CASES)
def test_host_build_at_each_lane_count_matches_plain(frontend_cases, case,
                                                     lanes):
    """The g++ build of csrc/text_frontend.cuh run as a launch at `lanes`
    lanes a word (the piece walk block by block, live rows compacted and
    run a word a group with the votes and shuffles emulated, empty rows
    zeroed) against plain K4, every row written."""
    t, s, n, want = frontend_cases[case]
    got = build.host_text_frontend(t, s, n, lanes=lanes)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lanes", build.TEXT_LANES)
@pytest.mark.parametrize("seed", range(5))
def test_host_build_on_seeded_documents_matches_plain(seed, lanes):
    """The g++ build at `lanes` lanes a word on seeded documents, their
    rows in segmentation order (equal to the host oracle's) and shuffled,
    so live rows sit anywhere among empty ones, against plain K4."""
    docs = build_documents(3, 64, seed=seed)
    t = _words_tile([" ".join(docs)])
    starts, lens = _segmented(t)
    perm = np.random.default_rng(seed).permutation(starts.shape[0])
    rows, _ = rtn.analyze_text_py(" ".join(docs))
    for s, n in ((starts, lens), (starts[perm], lens[perm])):
        want = ttf.text_frontend_plain(torch.from_numpy(t),
                                       torch.from_numpy(s),
                                       torch.from_numpy(n), block_w=128)
        got = build.host_text_frontend(t, s, n, lanes=lanes)
        np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(want.numpy()[np.argsort(perm)][:len(rows)],
                                  rows)


def test_lane_rule_and_piece_walk():
    """The launcher's lanes a word by rows (on an H100's 132 SMs: 8 below
    135,168 rows, from a one-codepoint tile's 128 to a served request's
    32,896 and 75,008; 1 from 135,168 on: an index chunk's 446,464, a
    1M-word tile's 3,574,912), and sparse_blocks' premise: block 0 of
    every lane count's grid takes only even pieces."""
    assert [build.host_text_lanes(r, sms=132) for r in
            (32_896, 75_008, 135_167, 135_168, 446_464, 3_574_912)] == \
        [8, 8, 8, 1, 1, 1]
    assert [build.host_text_lanes(r, sms=132) for r in
            (16_896, 16_895, 8_448, 8_447, 128)] == [8] * 5
    lanes = [build.host_text_lanes(r, sms=132)
             for r in (1, 2_000, 20_000, 40_000, 80_000, 140_000, 600_000)]
    assert lanes == sorted(lanes, reverse=True)
    assert set(lanes) <= set(build.TEXT_LANES)
    for g in build.TEXT_LANES:
        pieces = 4096 // 8
        grid = -(-pieces // (256 // g))
        assert grid % 2 == 0 and grid * (256 // g) >= pieces


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


def _forced_frontend(lanes, tile, starts, lens, block_w):
    """K4 through the measurement build that fixes its lanes a word."""
    lib = build.forced_text_lanes_library(lanes)
    words = torch.empty((starts.shape[0], 16), dtype=torch.int32,
                        device="cuda")
    lut, fw = ttn.device_tables("cuda")
    err = lib.text_frontend_launch(
        tile.data_ptr(), tile.shape[0], starts.data_ptr(), lens.data_ptr(),
        starts.shape[0], lut.data_ptr(), fw.data_ptr(), fw.shape[0],
        words.data_ptr(), block_w, torch.cuda.current_stream().cuda_stream)
    assert err == 0
    return words


@pytest.mark.cuda
@pytest.mark.parametrize("block_w", [128, 256, 1024])
def test_frontend_kernel_matches_plain_on_card(tile, odd_geometry,
                                               frontend_cases, block_w):
    """The segmented tile and odd geometry at block_w, the cases of
    FRONTEND_CASES at every lane count (the measurement builds) and by the
    launcher's rule (its lanes the g++ build's), and a one-codepoint
    tile."""
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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, (ct, s, n, want) in frontend_cases.items():
        rows = s.shape[0] // block_w * block_w
        if rows == 0:
            continue
        ct, s, n = (torch.from_numpy(x).cuda() for x in (ct, s[:rows],
                                                          n[:rows]))
        for lanes in build.TEXT_LANES:
            got = _forced_frontend(lanes, ct, s, n, block_w)
            torch.cuda.synchronize()
            assert np.array_equal(got.cpu().numpy(), want[:rows]), \
                (name, lanes)
        got = ttf.text_frontend_cuda(ct, s, n, block_w=block_w)
        assert np.array_equal(got.cpu().numpy(), want[:rows])
        assert ttf.text_frontend_cuda.last_lanes == build.host_text_lanes(
            rows, sms=sms)
    one = torch.tensor([0x0628], dtype=torch.int32, device="cuda")
    g1 = ttn.segment_geometry(one, block_w=block_w)
    assert torch.equal(ttf.text_frontend_cuda(one, g1.starts, g1.lens,
                                              block_w=block_w),
                       ttf.text_frontend_plain(one, g1.starts, g1.lens,
                                               block_w=block_w))

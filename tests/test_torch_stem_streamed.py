"""The port's streamed-dictionary layout (K2) against the JAX package: the
tile stream and its fence level, the tile-visit pre-pass and its counts,
the reference's visit walk, the plain streamed megakernel (the fence
search), the launch chunking, and the host build of the CUDA search
header. Every compared output is int32 and must be identical."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import corpus as rcorpus  # noqa: E402
from repro.core import stemmer as rstemmer  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import stem_datapath as rsdp  # noqa: E402
from repro.kernels import stem_fused as rsf  # noqa: E402
from repro.kernels import stem_match as rsm  # noqa: E402
from repro_torch.core import alphabet as tab  # noqa: E402
from repro_torch.core import corpus as tcorpus  # noqa: E402
from repro_torch.core import stemmer as tstemmer  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import stem_fused as tsf  # noqa: E402
from repro_torch.kernels import stem_match as tsm  # noqa: E402


@pytest.fixture(autouse=True)
def _reset_port_dispatch_count():
    """The port's launch counter is process-global, like the reference's."""
    tops.reset_dispatch_count()
    yield
    tops.reset_dispatch_count()


def _port(da):
    return tstemmer.RootDictArrays.from_numpy(
        np.asarray(da.tri), np.asarray(da.quad), np.asarray(da.bi),
        device="cpu")


@pytest.fixture(scope="module")
def small():
    da = rstemmer.RootDictArrays.from_rootdict(
        rcorpus.build_dictionary(n_tri=600, n_quad=80, seed=9))
    return da, _port(da)


@pytest.fixture(scope="module")
def big(small):
    """~100K loaded keys: past MAX_RESIDENT_KEYS, so "auto" streams."""
    da, tda = small
    grown = rcorpus.grow_root_arrays(da, 100_000, seed=2)
    return grown, _port(grown)


@pytest.fixture(scope="module")
def enc():
    words, _, _ = rcorpus.build_corpus(n_words=300, seed=13)
    return rcorpus.encode_corpus(words)


def _port_tables(enc, tiles, *, infix, block_b, skip_index):
    n_groups = 5 if infix else 2
    keys, valid = tsf._candidates(
        tsf._pad_words(torch.from_numpy(enc), block_b), n_groups)
    return tsf._visit_tables(keys, valid, tiles, n_groups=n_groups,
                             block_b=block_b, skip_index=skip_index)


def _walk(words, tiles, n_visits, visit_idx, *, n_groups, block_b):
    """The reference's visit walk in plain PyTorch over unpadded words."""
    w = torch.as_tensor(words)
    root, source = tsf._streamed_rows(
        tsf._pad_words(w, block_b), tiles.stream, n_visits, visit_idx,
        n_groups=n_groups, block_b=block_b, dict_block_r=tiles.dict_block_r,
        tri_tiles=tiles.counts[0], quad_tiles=tiles.counts[1])
    return root[:w.shape[0]], source[:w.shape[0]]


def _host(words, tiles, *, n_groups, match):
    return build.host_stem_streamed(
        words, tiles.stream.numpy(), tiles.fences.numpy(), n_groups=n_groups,
        match=match, dict_block_r=tiles.dict_block_r,
        fence_step=tiles.fence_step, counts=tiles.counts)


def _ref_tables(enc, tiles, *, infix, block_b, skip_index):
    n_groups = 5 if infix else 2
    n_slots = n_groups * tsf.N_CAND
    pad = (-enc.shape[0]) % block_b
    wp = jnp.pad(jnp.asarray(enc), ((0, pad), (0, 0)))
    kc, vc = rsdp.candidate_columns(wp)
    return rsf._visit_tables(
        jnp.stack(kc[:n_slots], axis=1), jnp.stack(vc[:n_slots], axis=1) > 0,
        tiles, n_groups=n_groups, block_b=block_b, skip_index=skip_index)


# ---------------------------------------------------------------------------
# the tile stream and the visit pre-pass
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dict_block_r", [1, 4])
@pytest.mark.parametrize("which", ["empty", "small", "grown"])
def test_build_dict_tiles_matches_reference(small, big, which, dict_block_r):
    placeholder = np.array([-1], np.int32)
    da = {"empty": rstemmer.RootDictArrays(*(jnp.asarray(placeholder),) * 3),
          "small": small[0], "grown": big[0]}[which]
    want = rsm.build_dict_tiles(da.tri, da.quad, da.bi, dict_block_r)
    tda = _port(da)
    got = tsm.build_dict_tiles(tda.tri, tda.quad, tda.bi, dict_block_r)
    assert got.counts == want.counts and got.dict_block_r == dict_block_r
    for g, w in ((got.stream, want.stream), (got.mins, want.mins),
                 (got.maxs, want.maxs)):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got.n_tiles == tsf.dict_tile_count(tda, dict_block_r)
    if which == "empty":   # every table still makes one full sentinel tile
        assert got.counts == (1, 1, 1)
        assert (got.stream.reshape(3, -1)[:, 1:] == tsm.DICT_SENTINEL).all()


@pytest.mark.parametrize("budget", [tsm.FENCE_BUDGET_BYTES, 2048, 64])
@pytest.mark.parametrize("dict_block_r", [1, 8, 16])
@pytest.mark.parametrize("which", ["empty", "small", "grown"])
def test_fences_match_the_stream_entry_by_entry(small, big, which,
                                                dict_block_r, budget):
    """The fence level is entry F * i of each table's part of the stream,
    F the smallest power of two >= 8 whose fences fit the budget."""
    placeholder = torch.tensor([-1], dtype=torch.int32)
    tda = {"empty": tstemmer.RootDictArrays(placeholder, placeholder,
                                            placeholder),
           "small": small[1], "grown": big[1]}[which]
    tiles = tsm.build_dict_tiles(tda.tri, tda.quad, tda.bi, dict_block_r,
                                 fence_budget=budget)
    step, tile_n = tiles.fence_step, dict_block_r * tsm.LANE
    counts = tsm.fence_counts(tiles.counts, tile_n, step)
    assert step >= 8 and step & (step - 1) == 0
    assert 4 * sum(counts) <= budget
    if step > 8:   # the next finer step does not fit
        assert 4 * sum(tsm.fence_counts(tiles.counts, tile_n,
                                        step // 2)) > budget
    assert tiles.fence_counts == counts
    flat = tiles.stream.reshape(-1).numpy()
    fences = tiles.fences.numpy()
    assert fences.dtype == np.int32 and fences.size == sum(counts)
    base = fbase = 0
    for n_tiles, nf in zip(tiles.counts, counts):
        for i in range(nf):
            assert fences[fbase + i] == flat[base + i * step]
        base += n_tiles * tile_n
        fbase += nf
    assert base == flat.size


@pytest.mark.parametrize("dict_block_r", [1, 4, 16])
@pytest.mark.parametrize("infix", [True, False])
@pytest.mark.parametrize("skip_index", [True, False])
def test_visit_tables_and_stats_match_reference(small, big, enc, skip_index,
                                                infix, dict_block_r):
    for da, tda in (small, big):
        want_t = rsm.build_dict_tiles(da.tri, da.quad, da.bi, dict_block_r)
        got_t = tsm.build_dict_tiles(tda.tri, tda.quad, tda.bi, dict_block_r)
        kw = dict(infix=infix, block_b=64, skip_index=skip_index)
        want_n, want_v = _ref_tables(enc, want_t, **kw)
        got_n, got_v = _port_tables(enc, got_t, **kw)
        assert got_n.dtype == got_v.dtype == torch.int32
        np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        stats = tsf.tile_visit_stats(torch.from_numpy(enc), tda,
                                     dict_block_r=dict_block_r, **kw)
        assert stats == rsf.tile_visit_stats(
            jnp.asarray(enc), da, dict_block_r=dict_block_r, **kw)
        if not skip_index:
            assert stats["visited"] == stats["full_sweep"]


# ---------------------------------------------------------------------------
# the plain streamed megakernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("match,infix,skip_index,num_buffers", [
    ("bsearch", True, True, 2),
    ("bank", True, False, 1),
    ("bsearch", False, False, 4),
    ("bank", False, True, 3),
])
def test_plain_streamed_matches_reference_kernel(small, enc, match, infix,
                                                 skip_index, num_buffers):
    """Against the Pallas kernel in interpret mode, ragged batch (300 = 4 x
    64 + 44), two-row dictionary tiles: the CPU path (the fence search)
    and the reference's visit walk on the port's visit tables."""
    da, tda = small
    kw = dict(infix=infix, match=match, block_b=64, residency="streamed",
              dict_block_r=2, num_buffers=num_buffers, skip_index=skip_index)
    want_r, want_s = rsf.stem_fused_pallas(jnp.asarray(enc), da,
                                           interpret=True, **kw)
    got_r, got_s = tops.extract_roots_fused(enc, tda, device="cpu", **kw)
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert tops.dispatch_count() == 0     # the plain version launches nothing
    tiles = tsm.build_dict_tiles(tda.tri, tda.quad, tda.bi, 2)
    n_visits, visit_idx = _port_tables(enc, tiles, infix=infix, block_b=64,
                                       skip_index=skip_index)
    walk_r, walk_s = _walk(enc, tiles, n_visits, visit_idx,
                           n_groups=5 if infix else 2, block_b=64)
    np.testing.assert_array_equal(walk_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(walk_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("infix", [True, False])
def test_plain_streamed_past_ceiling_matches_core(big, enc, infix):
    """~100K keys: residency="auto" streams, and the roots equal the
    reference's sorted-search stemmer."""
    da, tda = big
    assert tsf.choose_residency(tda, infix=infix) == "streamed"
    want_r, want_s = rstemmer.extract_roots(jnp.asarray(enc), da,
                                            infix=infix, backend="sorted")
    for dict_block_r in (1, 8):
        got_r, got_s = tops.extract_roots_fused(
            enc, tda, infix=infix, block_b=128, dict_block_r=dict_block_r,
            device="cpu")
        np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_262k_dictionary_through_extract_roots(small):
    da, tda = small
    grown = tcorpus.grow_root_arrays(tda, 262_144, seed=5)
    grown_ref = rcorpus.grow_root_arrays(da, 262_144, seed=5)
    chunk = next(tcorpus.stream_corpus_words(1000, seed=4, chunk_words=1000))
    got_r, got_s = tstemmer.extract_roots(chunk.words, grown, backend="fused",
                                          device="cpu")
    want_r, want_s = rstemmer.extract_roots(jnp.asarray(chunk.words),
                                            grown_ref, backend="sorted")
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert int((got_s > 0).sum()) > 0


def _boundary_words(tiles, counts, dict_block_r):
    """Words that are exactly the tri roots at the first and last entry of
    every tri tile (a bare 3-letter root is its own first candidate)."""
    flat = tiles.stream.reshape(-1, dict_block_r * tsm.LANE)[:counts[0]]
    keys = torch.cat([flat[:, 0], flat[:, -1]])
    keys = keys[(keys >= 0) & (keys < tsm.DICT_SENTINEL)].numpy()
    codes = np.stack([(keys >> 18) & 63, (keys >> 12) & 63,
                      (keys >> 6) & 63], axis=1)
    words = np.zeros((keys.size, 16), np.int32)
    words[:, :3] = codes
    return words


def test_tile_boundary_keys_and_empty_visit_lists(small, enc):
    """Keys at tile boundaries hit; a batch tile with no live key visits no
    tile; dropping a landing tile from a visit list changes that batch
    tile's roots in the reference's walk; the fence search (plain and the
    g++ build) finds every boundary key."""
    da, tda = small
    tiles = tsm.build_dict_tiles(tda.tri, tda.quad, tda.bi, 1)
    edge = _boundary_words(tiles, tiles.counts, 1)
    words = np.concatenate([edge, np.zeros((64, 16), np.int32)])
    got_r, got_s = tops.extract_roots_fused(words, tda, residency="streamed",
                                            dict_block_r=1, block_b=64,
                                            device="cpu")
    want_r, want_s = rstemmer.extract_roots(jnp.asarray(words), da,
                                            backend="sorted")
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert (got_s[:edge.shape[0]] > 0).all()
    for match in (0, 1):
        host = _host(words, tiles, n_groups=5, match=match)
        np.testing.assert_array_equal(host[0], got_r.numpy())
        np.testing.assert_array_equal(host[1], got_s.numpy())

    kw = dict(infix=True, block_b=64, skip_index=True)
    n_visits, visit_idx = _port_tables(words, tiles, **kw)
    assert int(n_visits[-1]) == 0          # the all-zero batch tile
    # drop batch tile 0's first landing tile
    dropped = visit_idx.clone()
    dropped[0, :-1] = visit_idx[0, 1:]
    n_dropped = n_visits.clone()
    n_dropped[0] -= 1
    full = _walk(words, tiles, n_visits, visit_idx, n_groups=5, block_b=64)
    cut = _walk(words, tiles, n_dropped, dropped, n_groups=5, block_b=64)
    assert torch.equal(full[0], got_r) and torch.equal(full[1], got_s)
    lost = (full[1] != cut[1]).nonzero().flatten()
    assert lost.numel() > 0 and (lost < 64).all()


def _fence_words(tiles):
    """Words whose first live candidate of a table is a key equal to one
    of its fences, one below or above it, or below or above the table: a
    bare 3-letter word is its own tri candidate, a bare 4-letter word its
    quad one, and [b0, infix, b1] gives the bi candidate (b0, b1)."""
    infix = int(tab.INFIX_CODES[0])
    flat = tiles.stream.reshape(-1)
    tile_n = tiles.dict_block_r * tsm.LANE
    rows, base, fbase = [], 0, 0
    for t, (n_tiles, nf) in enumerate(zip(tiles.counts, tiles.fence_counts)):
        region = flat[base:base + n_tiles * tile_n]
        real = region[(region >= 0) & (region < tsm.DICT_SENTINEL)]
        f = tiles.fences[fbase:fbase + nf]
        f = f[(f >= 0) & (f < tsm.DICT_SENTINEL)]
        keys = torch.cat([f, f - 1, f + 1] + ([real[:1] - 1, real[-1:] + 1,
                                               real[-1:] + 64]
                                              if real.numel() else []))
        keys = keys[(keys > 0) & (keys < (1 << 24))].numpy()
        c = [(keys >> s) & 63 for s in (18, 12, 6, 0)]
        w = np.zeros((keys.size, 16), np.int32)
        if t == 0:
            w[:, 0], w[:, 1], w[:, 2] = c[0], c[1], c[2]
        elif t == 1:
            w[:, 0], w[:, 1], w[:, 2], w[:, 3] = c
        else:
            w[:, 0], w[:, 1], w[:, 2] = c[0], infix, c[1]
        rows.append(w)
        base += n_tiles * tile_n
        fbase += nf
    return np.concatenate(rows + [np.zeros((8, 16), np.int32)])


@pytest.mark.parametrize("budget", [tsm.FENCE_BUDGET_BYTES, 2048])
@pytest.mark.parametrize("dict_block_r", [1, 8, 16])
def test_fence_keys_and_table_edges_match_reference(big, dict_block_r,
                                                    budget):
    """Keys equal to a fence, next to one, below and above each table, and
    words with no live slot: the g++ build of csrc/stem_fences.cuh (both
    match strategies) equals the plain version and the reference's
    sorted-search stemmer, at F = 8 and at the coarser F a small budget
    forces."""
    da, tda = big
    tiles = tsm.build_dict_tiles(tda.tri, tda.quad, tda.bi, dict_block_r,
                                 fence_budget=budget)
    assert (tiles.fence_step == 8) == (budget == tsm.FENCE_BUDGET_BYTES)
    words = _fence_words(tiles)
    for infix in (True, False):
        n_groups = 5 if infix else 2
        want_r, want_s = rstemmer.extract_roots(jnp.asarray(words), da,
                                                infix=infix, backend="sorted")
        got = tsf.stem_streamed_plain(torch.from_numpy(words), tiles,
                                      n_groups=n_groups, match="bsearch")
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want_r))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want_s))
        for match in (0, 1):
            host = _host(words, tiles, n_groups=n_groups, match=match)
            np.testing.assert_array_equal(host[0], got[0].numpy())
            np.testing.assert_array_equal(host[1], got[1].numpy())
        assert int((got[1] > 0).sum()) > 0 and int((got[1] == 0).sum()) > 8


@pytest.mark.parametrize("dict_block_r", [1, 4, 8, 16])
@pytest.mark.parametrize("infix", [True, False])
def test_host_build_of_sweep_header_matches_plain(big, enc, infix,
                                                  dict_block_r):
    """The g++ build of csrc/stem_fences.cuh, word by word as the kernels
    search, bit for bit against the plain streamed version and the
    reference's stemmer, both match strategies, at F = 8 and at a coarser
    F; the reference's walk on the port's visit tables (skip index and
    full sweep) gives the same roots."""
    da, tda = big
    words = enc[:200]                   # 4 batch tiles, the last ragged
    n_groups = 5 if infix else 2
    want_r, want_s = rstemmer.extract_roots(jnp.asarray(words), da,
                                            infix=infix, backend="sorted")
    for budget in (tsm.FENCE_BUDGET_BYTES, 4096):
        tiles = tsm.build_dict_tiles(tda.tri, tda.quad, tda.bi, dict_block_r,
                                     fence_budget=budget)
        want = tsf.stem_streamed_plain(torch.from_numpy(words), tiles,
                                       n_groups=n_groups, match="bsearch")
        np.testing.assert_array_equal(want[0].numpy(), np.asarray(want_r))
        np.testing.assert_array_equal(want[1].numpy(), np.asarray(want_s))
        for match in (0, 1):
            got = _host(words, tiles, n_groups=n_groups, match=match)
            np.testing.assert_array_equal(got[0], want[0].numpy())
            np.testing.assert_array_equal(got[1], want[1].numpy())
    for skip_index in (True, False):
        n_visits, visit_idx = _port_tables(words, tiles, infix=infix,
                                           block_b=64, skip_index=skip_index)
        walk = _walk(words, tiles, n_visits, visit_idx, n_groups=n_groups,
                     block_b=64)
        assert torch.equal(walk[0], want[0]) and torch.equal(walk[1], want[1])


# ---------------------------------------------------------------------------
# launch chunking and accounting
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("visit_budget", [None, 6])
def test_planned_and_actual_launches_match_reference(small, big, enc,
                                                     monkeypatch,
                                                     visit_budget):
    """The visit-budget chunking: planned launches equal the reference's,
    and a streamed call runs exactly that many kernel calls (the
    reference's dispatch count) with the reference's roots."""
    for da, tda in (small, big):
        for n in (0, 1, 300, 65536):
            for dict_block_r in (1, 8):
                kw = dict(block_b=32, dict_block_r=dict_block_r,
                          residency="streamed", visit_budget=visit_budget)
                assert tsf.planned_launches(n, tda, **kw) == \
                    rsf.planned_launches(n, da, **kw)
    da, tda = small                  # 3 dictionary tiles of 8 rows
    kw = dict(block_b=32, residency="streamed", visit_budget=visit_budget)
    words = enc[:100]                # 4 batch tiles
    calls = []
    plain = tsf.stem_streamed_plain
    monkeypatch.setattr(tsf, "stem_streamed_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    got_r, got_s = tops.extract_roots_fused(words, tda, device="cpu", **kw)
    rops.reset_dispatch_count()
    want_r, want_s = rops.extract_roots_fused(jnp.asarray(words), da,
                                              interpret=True, **kw)
    assert len(calls) == rops.dispatch_count() == tsf.planned_launches(
        100, tda, **kw) == {None: 1, 6: 2}[visit_budget]
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_streamed_argument_checks(small, enc):
    _, tda = small
    for nb in (0, 5):
        with pytest.raises(ValueError, match="num_buffers"):
            tops.extract_roots_fused(enc, tda, residency="streamed",
                                     num_buffers=nb, device="cpu")
    with pytest.raises(ValueError, match="dict_block_r"):
        tsm.build_dict_tiles(tda.tri, tda.quad, tda.bi, 0)
    tiles = tsm.build_dict_tiles(tda.tri, tda.quad, tda.bi, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tsf.stem_streamed_cuda(torch.from_numpy(enc[:64]), tiles, n_groups=5,
                               match="bsearch")
    desc = tsf._descriptors(1, 64, torch.zeros(1, dtype=torch.int32), 0)
    with pytest.raises(ValueError, match="CUDA"):
        tsf.persistent_streamed_cuda(torch.from_numpy(enc[:64]), tiles, desc,
                                     n_groups=5, match="bsearch", block_b=64)
    r, s = tops.extract_roots_fused(enc[:0], tda, residency="streamed",
                                    device="cpu")
    assert tuple(r.shape) == (0, 4) and tuple(s.shape) == (0,)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("match", ["bsearch", "bank"])
@pytest.mark.parametrize("infix", [True, False])
def test_streamed_kernel_matches_plain_on_card(big, enc, infix, match):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    _, tda = big
    arrays = tda.to("cuda")
    w = torch.from_numpy(enc).cuda()
    n_groups = 5 if infix else 2
    for dict_block_r in (1, 8, 16):
        for budget in (tsm.FENCE_BUDGET_BYTES, 4096):
            tiles = tsm.build_dict_tiles(arrays.tri, arrays.quad, arrays.bi,
                                         dict_block_r, fence_budget=budget)
            kern = dict(n_groups=n_groups, match=match)
            want = tsf.stem_streamed_plain(w, tiles, **kern)
            for b in (0, 1, 257, w.shape[0]):
                got = tsf.stem_streamed_cuda(w[:b], tiles, **kern)
                torch.cuda.synchronize()
                assert torch.equal(got[0], want[0][:b])
                assert torch.equal(got[1], want[1][:b])


@pytest.mark.cuda
@pytest.mark.parametrize("persistent", [False, True])
def test_cuda_streamed_path_runs_no_visit_tables(big, enc, monkeypatch,
                                                  persistent):
    """On the card the streamed stem_fused runs no visit pre-pass (nor the
    reference's walk): _visit_tables and _streamed_rows raise if called;
    its launches equal planned_launches and its roots the plain path's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    _, tda = big
    arrays = tda.to("cuda")
    w = torch.from_numpy(enc).cuda()

    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA path ran the visit pre-pass")

    monkeypatch.setattr(tsf, "_visit_tables", refuse)
    monkeypatch.setattr(tsf, "_streamed_rows", refuse)
    wrapper = (tsf.persistent_streamed_cuda if persistent
               else tsf.stem_streamed_cuda)
    for visit_budget in (None, 6):
        kw = dict(block_b=32, residency="streamed", persistent=persistent,
                  visit_budget=visit_budget)
        before = wrapper.launches
        got = tsf.stem_fused(w, arrays, **kw)
        torch.cuda.synchronize()
        assert wrapper.launches - before == tsf.planned_launches(
            w.shape[0], arrays, **kw) > 0
        want = tsf.stem_fused(w.cpu(), tda, **kw)
        assert all(torch.equal(g.cpu(), x) for g, x in zip(got, want))

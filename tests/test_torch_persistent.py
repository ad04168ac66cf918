"""The port's persistent serving kernel (K3) against the JAX package: the
descriptor ring, the plain resident and streamed variants (roots, sources
and completion flags), the reference's visit walk over a descriptor ring,
salvage, launch accounting, the tile set's publish checks, and persistent
serving through the engine across a mid-flight hot swap. Every compared
output is int32 and must be identical."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import serve as rserve  # noqa: E402
from repro.core import corpus as rcorpus  # noqa: E402
from repro.core import stemmer as rstemmer  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import stem_fused as rsf  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
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
def dicts():
    da = rstemmer.RootDictArrays.from_rootdict(
        rcorpus.build_dictionary(n_tri=400, n_quad=60, seed=0))
    da2 = rstemmer.RootDictArrays.from_rootdict(
        rcorpus.build_dictionary(n_tri=500, n_quad=80, seed=5))
    return da, da2


def _ring_walk(words, tiles, desc, visit_idx, *, n_groups, block_b):
    """The reference's streamed persistent kernel in plain PyTorch:
    descriptor d's tile walks the first desc[d, 1] entries of
    visit_idx[d] (the reference's visit walk) -> (root, source)."""
    wd, rows = tsf._descriptor_rows(words, desc, block_b)
    root, source = tsf._streamed_rows(
        wd, tiles.stream, desc[:, 1], visit_idx, n_groups=n_groups,
        block_b=block_b, dict_block_r=tiles.dict_block_r,
        tri_tiles=tiles.counts[0], quad_tiles=tiles.counts[1])
    return tsf._scatter_rows(words.shape[0], rows, root, source)


@pytest.fixture(scope="module")
def enc():
    words, _, _ = rcorpus.build_corpus(n_words=600, seed=1)
    return rcorpus.encode_corpus(words)


# ---------------------------------------------------------------------------
# the plain kernels against the reference's persistent kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("residency,match,infix,version_slot,visit_budget", [
    ("resident", "bsearch", True, 3, None),
    ("resident", "bank", False, 0, None),
    ("streamed", "bsearch", True, 3, None),
    ("streamed", "bank", False, 5, 6),      # 3 dict tiles: 2 batch tiles
])
def test_plain_persistent_matches_reference_kernel(dicts, enc, residency,
                                                   match, infix,
                                                   version_slot,
                                                   visit_budget):
    """Ragged batch (300 = 4 x 64 + 44): roots, sources and flags equal the
    Pallas kernel's in interpret mode; a chunked streamed call concatenates
    every chunk's flags; the reference's walk over the same descriptor
    ring and the port's visit tables gives the same roots."""
    da, _ = dicts
    words = enc[:300]
    kw = dict(infix=infix, match=match, block_b=64, residency=residency,
              dict_block_r=2, version_slot=version_slot,
              visit_budget=visit_budget)
    want = rops.extract_roots_persistent(jnp.asarray(words), da,
                                         interpret=True, **kw)
    got = tops.extract_roots_persistent(words, _port(da), device="cpu", **kw)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[2] == 1 + version_slot).all() and got[2].shape == (5,)
    # and the same roots as the non-persistent path
    r, s = tops.extract_roots_fused(words, _port(da), device="cpu",
                                    **{k: v for k, v in kw.items()
                                       if k != "version_slot"})
    assert torch.equal(r, got[0]) and torch.equal(s, got[1])
    if residency == "streamed":
        tda = _port(da)
        tiles = tsm.build_dict_tiles(tda.tri, tda.quad, tda.bi, 2)
        w = torch.from_numpy(words)
        n_groups = 5 if infix else 2
        keys, valid = tsf._candidates(tsf._pad_words(w, 64), n_groups)
        n_visits, visit_idx = tsf._visit_tables(
            keys, valid, tiles, n_groups=n_groups, block_b=64,
            skip_index=True)
        walk = _ring_walk(w, tiles, tsf._descriptors(5, 64, n_visits,
                                                     version_slot),
                          visit_idx, n_groups=n_groups, block_b=64)
        for g, x in zip(walk, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(x))


@pytest.mark.parametrize("residency", ["resident", "streamed"])
def test_persistent_empty_batch_and_checksum(dicts, enc, residency):
    _, da2 = dicts
    tda = _port(da2)
    out = tops.extract_roots_persistent(enc[:0], tda, residency=residency,
                                        device="cpu")
    assert [tuple(t.shape) for t in out] == [(0, 4), (0,), (0,)]
    r, s, f, cs = tops.extract_roots_persistent(
        enc[:128], tda, residency=residency, block_b=64, version_slot=2,
        with_checksum=True, device="cpu")
    np.testing.assert_array_equal(
        cs.numpy(), tops.tile_checksum_host(r.numpy(), s.numpy(), block_b=64))
    assert f.tolist() == [3, 3]


def test_descriptors_match_reference():
    n_visits = np.array([3, 0, 7, 1], np.int32)
    got = tsf._descriptors(4, 64, torch.from_numpy(n_visits), 5)
    want = rsf._descriptors(4, 64, jnp.asarray(n_visits), 5)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_plain_persistent_walks_the_descriptor_ring(dicts, enc):
    """The plain K3 reads each tile through its descriptor's row offset: a
    reversed ring gives the same rows, a descriptor pointed at another
    tile's rows computes those, and its visit count is not read. The
    reference's walk over the same ring does read it: a descriptor whose
    visit count is cut to 0 finds nothing."""
    _, da2 = dicts
    tda = _port(da2)
    words = torch.from_numpy(enc[:256])
    tiles = tsm.build_dict_tiles(tda.tri, tda.quad, tda.bi, 2)
    keys, valid = tsf._candidates(words, 5)
    n_visits, visit_idx = tsf._visit_tables(keys, valid, tiles, n_groups=5,
                                            block_b=64, skip_index=True)
    kern = dict(n_groups=5, match="bsearch", block_b=64)
    desc = tsf._descriptors(4, 64, n_visits, 1)
    want = tsf.persistent_streamed_plain(words, tiles, desc, **kern)
    flip = torch.arange(3, -1, -1)
    got = tsf.persistent_streamed_plain(words, tiles, desc[flip], **kern)
    assert all(torch.equal(g, x) for g, x in zip(got, want))
    cut = desc.clone()
    cut[2, 1] = 0
    got = tsf.persistent_streamed_plain(words, tiles, cut, **kern)
    assert all(torch.equal(g, x) for g, x in zip(got, want))
    moved = desc.clone()
    moved[3, 0] = 0                  # descriptor 3 recomputes tile 0's rows
    got = tsf.persistent_streamed_plain(words, tiles, moved, **kern)
    assert torch.equal(got[1][:64], want[1][:64])
    walk = _ring_walk(words, tiles, desc, visit_idx, n_groups=5, block_b=64)
    assert torch.equal(walk[0], want[0]) and torch.equal(walk[1], want[1])
    walk = _ring_walk(words, tiles, desc[flip], visit_idx[flip], n_groups=5,
                      block_b=64)
    assert torch.equal(walk[0], want[0]) and torch.equal(walk[1], want[1])
    walk = _ring_walk(words, tiles, cut, visit_idx, n_groups=5, block_b=64)
    assert (walk[1][128:192] == 0).all() and (want[1][128:192] > 0).any()
    assert torch.equal(walk[1][:128], want[1][:128])


@pytest.mark.parametrize("flags,want_rows", [
    ([6, 6, 6, 6], 4 * 32),         # all retired
    ([6, 6, 0, 6], 2 * 32),         # a hole: the prefix only
    ([0, 6, 6, 6], 0),              # unproven from the start
    ([6, 5, 6, 6], 32),             # a stale version slot is not retired
    ([6, -3, 6, 6], 32),            # a tile mid-count reads as unretired
    ([-1, 6, 6, 6], 0),
    ([], 0),
])
def test_salvage_descriptor_rows_matches_reference(flags, want_rows):
    f = np.asarray(flags, np.int32)
    got = tsf.salvage_descriptor_rows(f, 5, 32)
    assert got == rsf.salvage_descriptor_rows(f, 5, 32) == want_rows


@pytest.mark.parametrize("visit_budget", [None, 3, 50])
def test_persistent_planned_launches_match_reference(dicts, visit_budget):
    da, _ = dicts
    grown = rcorpus.grow_root_arrays(da, 70_000, seed=3)
    for arrays in (da, grown):
        for residency in ("resident", "streamed", "auto"):
            for n in (0, 1, 257, 4096):
                kw = dict(block_b=64, residency=residency, persistent=True,
                          visit_budget=visit_budget)
                assert tsf.planned_launches(n, _port(arrays), **kw) == \
                    rsf.planned_launches(n, arrays, **kw)


# ---------------------------------------------------------------------------
# persistent serving
# ---------------------------------------------------------------------------
def _serve(mod, store, enc, swap_to, *, persistent):
    """Submit three requests, step once, hot-swap, drain (max_inflight=1,
    so both engines take the same schedule)."""
    eng = mod.Engine(mod.StemmerWorkload(store, block_b=32,
                                         megabatch_tiles=2,
                                         persistent=persistent,
                                         max_inflight=1))
    rids = [eng.submit(enc[i * 100:(i + 1) * 100]) for i in range(3)]
    eng.step()
    store.publish(swap_to)
    rep = eng.run_until_drained()
    assert rep.drained
    return eng, [eng.result(r) for r in rids]


@pytest.mark.parametrize("residency", ["resident", "streamed"])
def test_persistent_engine_matches_reference_across_midflight_swap(
        dicts, enc, residency):
    da, da2 = dicts
    r_eng, r_reqs = _serve(
        rserve, rserve.DictStore(da, residency=residency, dict_block_r=8),
        enc, da2, persistent=True)
    t_store = tserve.DictStore(_port(da), residency=residency,
                               dict_block_r=8, device="cpu")
    t_eng, t_reqs = _serve(tserve, t_store, enc, _port(da2), persistent=True)
    assert t_store.acquire().handle.residency == residency
    assert (t_store.acquire().handle.tiles is None) == (residency
                                                        == "resident")
    assert t_eng.workload.ticks_launched == r_eng.workload.ticks_launched
    for want, got in zip(r_reqs, t_reqs):
        assert got.done
        np.testing.assert_array_equal(got.roots, want.roots)
        np.testing.assert_array_equal(got.sources, want.sources)
        np.testing.assert_array_equal(got.dict_versions, want.dict_versions)
    versions = np.concatenate([r.dict_versions for r in t_reqs])
    assert versions.min() == 0 and versions.max() == 1
    # each word equals the sorted-search stemmer under its version
    got_r = np.concatenate([r.roots for r in t_reqs])
    for v, arrays in ((0, da), (1, da2)):
        idx = np.nonzero(versions == v)[0]
        want_r, _ = rstemmer.extract_roots(jnp.asarray(enc[:300][idx]),
                                           arrays, backend="sorted")
        np.testing.assert_array_equal(got_r[idx], np.asarray(want_r))
    wl = t_eng.workload
    assert wl.checksum_tiles >= wl.ticks_launched


def test_persistent_retire_checks_flags(dicts, enc):
    da, _ = dicts
    wl = tserve.StemmerWorkload(tserve.DictStore(_port(da), device="cpu"),
                                block_b=32, megabatch_tiles=2,
                                persistent=True, max_inflight=1)
    eng = tserve.Engine(wl)
    eng.submit(enc[:64])
    eng.step()                           # one persistent launch in flight
    assert wl.ring[0].flags.tolist() == [1, 1]
    wl.ring[0].flags[1] = 0              # a descriptor that never retired
    with pytest.raises(RuntimeError, match="bad completion flags"):
        eng.run_until_drained()


def test_streamed_store_prebuilds_and_validates_tiles(dicts):
    da, _ = dicts
    store = tserve.DictStore(_port(da), residency="streamed", dict_block_r=4,
                             device="cpu")
    h = store.acquire().handle
    assert h.residency == "streamed" and h.tiles.dict_block_r == 4
    assert tstemmer.unwrap_dict(h)[2] is h.tiles
    assert tstemmer.resolve_dict(h, dict_block_r=4) is h
    assert tstemmer.resolve_dict(h, dict_block_r=2).tiles.dict_block_r == 2
    assert h.tiles.fence_step == 8
    t = h.tiles
    bad = tstemmer.ResolvedRootDict(h.arrays, "streamed",
                                    tsm.DictTileSet(t.stream.flip(0), t.mins,
                                                    t.maxs, 4, t.counts,
                                                    t.fences, t.fence_step))
    with pytest.raises(tserve.DictValidationError, match="unsorted"):
        tserve.validate_handle(bad)
    bad = tstemmer.ResolvedRootDict(h.arrays, "streamed",
                                    tsm.DictTileSet(t.stream, t.maxs, t.maxs,
                                                    4, t.counts, t.fences,
                                                    t.fence_step))
    with pytest.raises(tserve.DictValidationError, match="boundary"):
        tserve.validate_handle(bad)
    # a fence off by one, a fence level of another step, a step that is not
    # a power of two >= 8
    off = t.fences.clone()
    off[1] += 1
    coarse = tsm.build_fences(t.stream, t.counts, 4 * tsm.LANE, 16)
    for fences, step in ((off, 8), (coarse, 8), (coarse, 16),
                         (t.stream.reshape(-1)[::4].contiguous(), 4)):
        bad = tstemmer.ResolvedRootDict(h.arrays, "streamed",
                                        tsm.DictTileSet(t.stream, t.mins,
                                                        t.maxs, 4, t.counts,
                                                        fences, step))
        if step == 16:      # a coarser level is a valid one
            tserve.validate_handle(bad)
            continue
        with pytest.raises(tserve.DictValidationError, match="fence"):
            tserve.validate_handle(bad)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
# ring sizes (words) at which K3 resident's rule picks each of 8, 4, 2 and
# 1 lanes a word on an H100's 132 SMs
LANE_SIZES = (4096, 8192, 16384, 65536)


@pytest.mark.cuda
@pytest.mark.parametrize("match", ["bsearch", "bank"])
@pytest.mark.parametrize("infix", [True, False])
def test_persistent_kernels_match_plain_on_card(dicts, enc, infix, match):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    da, _ = dicts
    arrays = _port(da).to("cuda")
    w = torch.from_numpy(enc[:300]).cuda()        # ragged: 4 x 64 + 44
    n_groups = 5 if infix else 2
    tables = tsf.padded_tables(arrays, match=match, infix=infix)
    zeros = torch.zeros(5, dtype=torch.int32, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    big = torch.from_numpy(next(tcorpus.stream_corpus_words(
        max(LANE_SIZES), seed=4, chunk_words=max(LANE_SIZES))).words).cuda()
    seen = set()
    for version_slot in (0, 5):
        desc = tsf._descriptors(5, 64, zeros, version_slot)
        kern = dict(n_groups=n_groups, match=match, block_b=64)
        got = tsf.persistent_resident_cuda(w, tables, desc, **kern)
        want = tsf.persistent_resident_plain(w, tables, desc, **kern)
        torch.cuda.synchronize()
        assert all(torch.equal(g, x) for g, x in zip(got, want))
        # rings whose sizes reach every G the launcher picks, whole tiles
        # and tiles in pieces; lanes and blocks as the g++ build of the
        # rule and walk gives them for this card
        for ww in (big[:n] for n in LANE_SIZES):
            for block_b in (64, 256, 2048):
                bt = -(-ww.shape[0] // block_b)
                desc = tsf._descriptors(
                    bt, block_b, torch.zeros(bt, dtype=torch.int32,
                                             device="cuda"), version_slot)
                kern = dict(n_groups=n_groups, match=match, block_b=block_b)
                want = tsf.persistent_resident_plain(ww, tables, desc, **kern)
                got = tsf.persistent_resident_cuda(ww, tables, desc, **kern)
                torch.cuda.synchronize()
                assert all(torch.equal(a, x) for a, x in zip(got, want))
                assert (got[2] == 1 + version_slot).all()
                fn = tsf.persistent_resident_cuda
                walk = build.host_resident_walk(
                    bt * block_b, bt, block_b, fn.last_capacity, sms=sms,
                    persistent=True)
                assert (fn.last_lanes, fn.last_grid) == (walk["lanes"],
                                                         walk["grid"])
                seen.add(walk["lanes"])
        for dict_block_r, budget in ((2, tsm.FENCE_BUDGET_BYTES), (2, 256),
                                     (16, tsm.FENCE_BUDGET_BYTES)):
            tiles = tsm.build_dict_tiles(arrays.tri, arrays.quad, arrays.bi,
                                         dict_block_r, fence_budget=budget)
            for block_b in (1, 3, 64, 100, 1024):
                bt = -(-w.shape[0] // block_b)
                desc = tsf._descriptors(
                    bt, block_b, torch.zeros(bt, dtype=torch.int32,
                                             device="cuda"), version_slot)
                kern = dict(n_groups=n_groups, match=match, block_b=block_b)
                want = tsf.persistent_streamed_plain(w, tiles, desc, **kern)
                got = tsf.persistent_streamed_cuda(w, tiles, desc, **kern)
                torch.cuda.synchronize()
                assert all(torch.equal(g, x) for g, x in zip(got, want))
                assert (got[2] == 1 + version_slot).all()
    assert seen == {1, 2, 4, 8}

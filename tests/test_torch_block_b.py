"""Any block_b on every path: the logical tile (checksum tiles, visit lists,
descriptor rows) is not the thread count. The kernels launch at most 512
threads (1024 for the streamed ones) and stride over the tile's words;
the plain versions and the reference take any block_b, so the kernels
must too. The CPU tests hold the plain paths at wide tiles to the
reference, and the reference's visit walk at wide tiles and the g++
build of the streamed search to the plain K2; the cuda-marked ones hold
K1, K2 (through stem_fused's chunks) and K3 to their plain versions at
block_b 1024 and 2048 (and at a width that is not a power of two and one
wider than 4 x 512 words)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.core import corpus as rcorpus  # noqa: E402
from repro.core import stemmer as rstemmer  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro_torch.core import corpus as tcorpus  # noqa: E402
from repro_torch.core import stemmer as tstemmer  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import stem_fused as tsf  # noqa: E402
from repro_torch.kernels import stem_match as tsm  # noqa: E402

WIDE = (1024, 2048)
CARD_WIDTHS = (1024, 2048, 1536, 3000)


@pytest.fixture(scope="module")
def dicts():
    da = rstemmer.RootDictArrays.from_rootdict(
        rcorpus.build_dictionary(n_tri=500, n_quad=70, seed=4))
    tda = tstemmer.RootDictArrays.from_numpy(
        np.asarray(da.tri), np.asarray(da.quad), np.asarray(da.bi),
        device="cpu")
    return da, tda


@pytest.fixture(scope="module")
def enc():
    return next(tcorpus.stream_corpus_words(5000, seed=8,
                                            chunk_words=5000)).words


def _visits(w, tiles, *, n_groups, block_b):
    keys, valid = tsf._candidates(tsf._pad_words(w, block_b), n_groups)
    return tsf._visit_tables(keys, valid, tiles, n_groups=n_groups,
                             block_b=block_b, skip_index=True)


@pytest.mark.parametrize("block_b", WIDE)
def test_wide_tiles_on_the_plain_paths_match_reference(dicts, enc, block_b):
    """Resident, streamed and persistent at block_b 1024 and 2048 give the
    reference's roots, and the checksum row has one entry a tile."""
    da, tda = dicts
    want_r, want_s = rstemmer.extract_roots(jnp.asarray(enc), da,
                                            backend="sorted")
    for kw in (dict(residency="resident"),
               dict(residency="streamed", dict_block_r=2),
               dict(residency="resident", persistent=True),
               dict(residency="streamed", dict_block_r=2, persistent=True)):
        out = tsf.stem_fused(torch.from_numpy(enc), tda, block_b=block_b,
                             **kw)
        np.testing.assert_array_equal(out[0].numpy(), np.asarray(want_r))
        np.testing.assert_array_equal(out[1].numpy(), np.asarray(want_s))
    rows = -(-enc.shape[0] // block_b) * block_b
    padded = np.concatenate([enc, np.zeros((rows - enc.shape[0], 16),
                                           np.int32)])
    r, s, cs = tops.extract_roots_fused(padded, tda, block_b=block_b,
                                        with_checksum=True, device="cpu")
    want = rops.tile_checksum(*rstemmer.extract_roots(
        jnp.asarray(padded), da, backend="sorted"), block_b=block_b)
    np.testing.assert_array_equal(cs.numpy(), np.asarray(want))
    assert cs.shape == (rows // block_b,)


def test_host_sweep_at_wide_tiles_matches_plain(dicts, enc):
    """The reference's visit walk, one block_b tile at a time, at tiles
    wider than a block of threads, and the g++ build of stem_fences.cuh,
    both equal to the plain K2."""
    _, tda = dicts
    tiles = tsm.build_dict_tiles(tda.tri, tda.quad, tda.bi, 2)
    w = torch.from_numpy(enc)
    want = tsf.stem_streamed_plain(w, tiles, n_groups=5, match="bsearch")
    got = build.host_stem_streamed(
        enc, tiles.stream.numpy(), tiles.fences.numpy(), n_groups=5,
        match=0, dict_block_r=2, fence_step=tiles.fence_step,
        counts=tiles.counts)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())
    for block_b in WIDE:
        n_visits, visit_idx = _visits(w, tiles, n_groups=5, block_b=block_b)
        walk = tsf._streamed_rows(
            tsf._pad_words(w, block_b), tiles.stream, n_visits, visit_idx,
            n_groups=5, block_b=block_b, dict_block_r=2,
            tri_tiles=tiles.counts[0], quad_tiles=tiles.counts[1])
        assert torch.equal(walk[0][:w.shape[0]], want[0])
        assert torch.equal(walk[1][:w.shape[0]], want[1])


def test_wrappers_take_any_block_b(dicts, enc):
    """block_b only has to be >= 1; the CUDA wrappers reject CPU tensors
    before anything else."""
    _, tda = dicts
    tables = tsf.padded_tables(tda, match="bsearch", infix=True)
    for block_b in (2048, 4096):
        with pytest.raises(ValueError, match="CUDA tensors"):
            tsf.stem_fused_cuda(torch.from_numpy(enc[:4]), tables,
                                n_groups=5, match="bsearch", block_b=block_b)
    with pytest.raises(ValueError, match="block_b must be >= 1"):
        tsf.stem_fused(torch.from_numpy(enc[:4]), tda, block_b=0)
    assert not hasattr(tsf, "MAX_BLOCK_B")


def _card(dicts, enc):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _, tda = dicts
    return tda.to("cuda"), torch.from_numpy(enc).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("match", ["bsearch", "bank"])
def test_k1_wide_tiles_match_plain_on_card(dicts, enc, match):
    arrays, w = _card(dicts, enc)
    for infix in (True, False):
        n_groups = 5 if infix else 2
        tables = tsf.padded_tables(arrays, match=match, infix=infix)
        for block_b in CARD_WIDTHS:
            kern = dict(n_groups=n_groups, match=match, block_b=block_b)
            got = tsf.stem_fused_cuda(w, tables, **kern)
            torch.cuda.synchronize()
            want = tsf.stem_fused_plain(w, tables, **kern)
            assert all(torch.equal(g, x) for g, x in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("match", ["bsearch", "bank"])
def test_k2_wide_tiles_match_plain_on_card(dicts, enc, match):
    """K2 has no tile of its own: stem_fused cuts the batch into chunks of
    whole block_b tiles (a small visit budget: several launches), each a
    K2 launch, equal to the same chunks through the plain version."""
    arrays, w = _card(dicts, enc)
    for infix in (True, False):
        for block_b in CARD_WIDTHS:
            kw = dict(infix=infix, match=match, block_b=block_b,
                      residency="streamed", dict_block_r=2,
                      visit_budget=4)
            before = tsf.stem_streamed_cuda.launches
            got = tsf.stem_fused(w, arrays, **kw)
            torch.cuda.synchronize()
            assert tsf.stem_streamed_cuda.launches - before == \
                tsf.planned_launches(w.shape[0], arrays, infix=infix,
                                     block_b=block_b, residency="streamed",
                                     dict_block_r=2, visit_budget=4) > 1
            want = tsf.stem_fused(w.cpu(), dicts[1], **kw)
            assert all(torch.equal(g.cpu(), x) for g, x in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("match", ["bsearch", "bank"])
def test_k3_wide_tiles_match_plain_on_card(dicts, enc, match):
    arrays, w = _card(dicts, enc)
    tables = tsf.padded_tables(arrays, match=match, infix=True)
    tiles = tsm.build_dict_tiles(arrays.tri, arrays.quad, arrays.bi, 2)
    for block_b in CARD_WIDTHS:
        bt = -(-w.shape[0] // block_b)
        zeros = torch.zeros(bt, dtype=torch.int32, device="cuda")
        desc = tsf._descriptors(bt, block_b, zeros, 3)
        kern = dict(n_groups=5, match=match, block_b=block_b)
        got = tsf.persistent_resident_cuda(w, tables, desc, **kern)
        torch.cuda.synchronize()
        want = tsf.persistent_resident_plain(w, tables, desc, **kern)
        assert all(torch.equal(g, x) for g, x in zip(got, want))
        want = tsf.persistent_streamed_plain(w, tiles, desc, **kern)
        got = tsf.persistent_streamed_cuda(w, tiles, desc, **kern)
        torch.cuda.synchronize()
        assert all(torch.equal(g, x) for g, x in zip(got, want))

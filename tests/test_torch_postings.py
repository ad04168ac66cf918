"""The port's postings kernel (K5, repro_torch.kernels.postings) against the
JAX package: the plain version against the interpret-mode Pallas kernel,
the guards, the g++ build of the kernel's tile steps, and the global half
(finish_postings). Every compared output is int32 and must be
identical."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import postings as rpk  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import postings as tpk  # noqa: E402


def _ids(n_roots: int, w: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, n_roots + 1, size=w).astype(np.int32)


@pytest.mark.parametrize("block_w,n_roots,w", [(128, 53, 1000), (256, 7, 300),
                                               (128, 7, 200)])
def test_plain_matches_pallas(block_w, n_roots, w):
    """(hist, rank) and the finished postings, ragged W padded with drop
    ids; the last case is all drop ids."""
    ids = _ids(n_roots, w) if w != 200 else np.full(w, n_roots, np.int32)
    want_h, want_r = rpk.postings_pallas(jnp.asarray(ids), n_roots=n_roots,
                                         block_w=block_w, interpret=True)
    got_h, got_r = tpk.postings(torch.from_numpy(ids), n_roots=n_roots,
                                block_w=block_w)
    assert got_h.dtype == got_r.dtype == torch.int32
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    rng = np.random.default_rng(1)
    docs = rng.integers(0, 40, size=w).astype(np.int32)
    poss = np.arange(w, dtype=np.int32)
    want = rpk.finish_postings(want_h, want_r, jnp.asarray(ids),
                               jnp.asarray(docs), jnp.asarray(poss),
                               n_roots=n_roots, block_w=block_w)
    got = tpk.finish_postings(got_h, got_r, torch.from_numpy(ids),
                              torch.from_numpy(docs), torch.from_numpy(poss),
                              n_roots=n_roots, block_w=block_w)
    for g, x in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))


@pytest.mark.parametrize("block_w", [1, 2, 64, 2048])
def test_finish_postings_matches_reference(block_w):
    """The global half alone, fed the same (hist, rank) from the plain
    version, over tile widths the Pallas kernel is slow to interpret."""
    n_roots, w = 31, 3000
    ids = _ids(n_roots, w, seed=block_w)
    hist, rank = tpk.postings(torch.from_numpy(ids), n_roots=n_roots,
                              block_w=block_w)
    docs = np.arange(w, dtype=np.int32) // 50
    poss = np.arange(w, dtype=np.int32) % 50
    want = rpk.finish_postings(jnp.asarray(hist.numpy()),
                               jnp.asarray(rank.numpy()), jnp.asarray(ids),
                               jnp.asarray(docs), jnp.asarray(poss),
                               n_roots=n_roots, block_w=block_w)
    got = tpk.finish_postings(hist, rank, torch.from_numpy(ids),
                              torch.from_numpy(docs), torch.from_numpy(poss),
                              n_roots=n_roots, block_w=block_w)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    valid = ids < n_roots
    order = np.argsort(ids[valid], kind="stable")
    n = int(got[3])
    np.testing.assert_array_equal(got[1].numpy()[:n], docs[valid][order])


@pytest.mark.parametrize("block_w", [1, 2, 128, 1024, 2048, 8192])
def test_host_build_of_postings_header_matches_plain(block_w):
    """The g++ build of csrc/postings.cuh (the same bitonic network, stage
    by stage, and the same searches) against the plain version."""
    for n_roots in (1, 60, 2231):
        ids = _ids(n_roots, 3 * block_w + block_w // 2 + 1, seed=n_roots)
        tiles = tpk.pad_ids(torch.from_numpy(ids), n_roots=n_roots,
                            block_w=block_w)
        want_h, want_r = tpk.postings_plain(tiles, n_roots=n_roots,
                                            block_w=block_w)
        got_h, got_r = build.host_postings(tiles.numpy(), n_roots=n_roots,
                                           block_w=block_w)
        np.testing.assert_array_equal(got_h, want_h.numpy())
        np.testing.assert_array_equal(got_r, want_r.numpy())


def test_guards_match_reference():
    ids = np.zeros(8, np.int32)
    for kw, match in ((dict(n_roots=4, block_w=96), "power of two"),
                      (dict(n_roots=1 << 22, block_w=1024), "overflow")):
        with pytest.raises(ValueError, match=match) as want:
            rpk.postings_pallas(jnp.asarray(ids), interpret=True, **kw)
        with pytest.raises(ValueError, match=match) as got:
            tpk.postings(torch.from_numpy(ids), **kw)
        assert str(got.value) == str(want.value)


def test_block_w_limit():
    """No limit past the reference's guards: a tile wider than one
    block's shared memory (MAX_BLOCK_W) is taken on every device, and the
    kernel sorts it in a global-memory scratch row."""
    assert tpk.MAX_BLOCK_W == 32768
    ids = torch.zeros(8, dtype=torch.int32)
    for block_w in (tpk.MAX_BLOCK_W, 2 * tpk.MAX_BLOCK_W, 1 << 19):
        hist, rank = tpk.postings(ids, n_roots=3, block_w=block_w)
        assert hist.tolist() == [[8, 0, 0, block_w - 8]]
        assert rank[:8].tolist() == list(range(8))
    with pytest.raises(ValueError, match="overflow"):
        tpk.postings(ids, n_roots=2231, block_w=1 << 20)


def test_wide_tile_matches_pallas():
    """block_w = 65536 (two tiles, the realistic vocabulary) against the
    interpret-mode Pallas kernel, and the finished postings."""
    n_roots, w, block_w = 2231, 70_000, 1 << 16
    ids = _ids(n_roots, w, seed=6)
    want_h, want_r = rpk.postings_pallas(jnp.asarray(ids), n_roots=n_roots,
                                         block_w=block_w, interpret=True)
    got_h, got_r = tpk.postings(torch.from_numpy(ids), n_roots=n_roots,
                                block_w=block_w)
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    docs = (np.arange(w) // 100).astype(np.int32)
    poss = (np.arange(w) % 100).astype(np.int32)
    want = rpk.finish_postings(want_h, want_r, jnp.asarray(ids),
                               jnp.asarray(docs), jnp.asarray(poss),
                               n_roots=n_roots, block_w=block_w)
    got = tpk.finish_postings(got_h, got_r, torch.from_numpy(ids),
                              torch.from_numpy(docs), torch.from_numpy(poss),
                              n_roots=n_roots, block_w=block_w)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))


@pytest.mark.parametrize("block_w", [1 << 16, 1 << 17])
def test_host_build_takes_wide_tiles(block_w):
    """The g++ build of csrc/postings.cuh at tiles past MAX_BLOCK_W: the
    same network and searches the scratch-row kernel runs."""
    n_roots = 2231
    ids = _ids(n_roots, 2 * block_w + 5, seed=block_w)
    tiles = tpk.pad_ids(torch.from_numpy(ids), n_roots=n_roots,
                        block_w=block_w)
    want_h, want_r = tpk.postings_plain(tiles, n_roots=n_roots,
                                        block_w=block_w)
    got_h, got_r = build.host_postings(tiles.numpy(), n_roots=n_roots,
                                       block_w=block_w)
    np.testing.assert_array_equal(got_h, want_h.numpy())
    np.testing.assert_array_equal(got_r, want_r.numpy())


def test_empty_and_cpu_wrapper():
    hist, rank = tpk.postings(torch.zeros(0, dtype=torch.int32), n_roots=5,
                              block_w=128)
    assert hist.shape == (0, 6) and rank.shape == (0,)
    counts, docs, poss, n = tpk.finish_postings(
        hist, rank, torch.zeros(0, dtype=torch.int32),
        torch.zeros(0, dtype=torch.int32), torch.zeros(0, dtype=torch.int32),
        n_roots=5, block_w=128)
    assert int(n) == 0 and counts.shape == (5,) and not counts.any()
    with pytest.raises(ValueError, match="CUDA"):
        tpk.postings_cuda(torch.zeros((1, 128), dtype=torch.int32),
                          n_roots=5, block_w=128)


@pytest.mark.cuda
@pytest.mark.parametrize("block_w", [128, 1024, 2048, 8192, 1 << 16, 1 << 17])
def test_postings_kernel_matches_plain_on_card(block_w):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for n_roots, w in ((2231, 5 * block_w + 17), (1, 3 * block_w),
                       (60, block_w)):
        ids = torch.from_numpy(_ids(n_roots, w, seed=w)).cuda()
        tiles = tpk.pad_ids(ids, n_roots=n_roots, block_w=block_w)
        got = tpk.postings_cuda(tiles, n_roots=n_roots, block_w=block_w)
        torch.cuda.synchronize()
        want = tpk.postings_plain(tiles, n_roots=n_roots, block_w=block_w)
        assert all(torch.equal(g, x) for g, x in zip(got, want))

"""The port's postings kernel (K5, repro_torch.kernels.postings) against the
JAX package: the plain version against the interpret-mode Pallas kernel,
the guards, the g++ build of the three instances' tile steps (the counting
and sliced instances' blocks one after another, their warps group by
group with their ballots over the lanes in order; the bitonic network
stage by stage), the instance rule, and the global half
(finish_postings). Every compared output is int32 and must be
identical."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

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


# ids a tile may hold: the drop bucket only, one root, a skewed draw over the
# realistic vocabulary, and ids outside [0, n_roots] (which the reference's
# contract excludes; the plain version still defines their answer)
ID_CASES = ("all dropped", "one root", "realistic", "out of range")
OUT_OF_RANGE = np.array([-1, -7, -(1 << 31), (1 << 31) - 1], np.int32)


def _case_ids(case: str, w: int, seed: int) -> tuple[np.ndarray, int]:
    """-> (ids int32[w], n_roots) for one of ID_CASES."""
    rng = np.random.default_rng(seed)
    n_roots = 2231                            # the realistic vocabulary
    if case == "all dropped":
        return np.full(w, n_roots, np.int32), n_roots
    if case == "one root":
        return np.zeros(w, np.int32), 1
    ids = ((rng.zipf(1.3, size=w) - 1) % (n_roots + 1)).astype(np.int32)
    if case == "out of range":
        bad = rng.random(w) < 0.1
        extra = np.concatenate([OUT_OF_RANGE, [n_roots + 1, n_roots + 9]])
        ids[bad] = rng.choice(extra, size=int(bad.sum())).astype(np.int32)
    return ids, n_roots


@pytest.mark.parametrize("case", ID_CASES)
@pytest.mark.parametrize("block_w", [1, 8, 32, 128, 2048])
def test_host_build_of_counting_instance_matches_plain(block_w, case):
    """The g++ build of the counting instance (postings.cuh) against the
    plain version, and through it against the interpret-mode Pallas
    kernel where the ids keep to the reference's contract. Ragged W, so
    the last tile is padded with drop ids."""
    ids, n_roots = _case_ids(case, 3 * block_w + block_w // 2 + 1,
                             seed=block_w)
    tiles = tpk.pad_ids(torch.from_numpy(ids), n_roots=n_roots,
                        block_w=block_w)
    want_h, want_r = tpk.postings_plain(tiles, n_roots=n_roots,
                                        block_w=block_w)
    got_h, got_r = build.host_postings(tiles.numpy(), n_roots=n_roots,
                                       block_w=block_w, instance="counting")
    np.testing.assert_array_equal(got_h, want_h.numpy())
    np.testing.assert_array_equal(got_r, want_r.numpy())
    if case == "out of range":
        # no histogram entry for them, and each one's rank counts the
        # earlier equal ids of its tile
        flat = tiles.numpy()
        assert got_h.sum() == ((flat >= 0) & (flat <= n_roots)).sum()
        for t, row in enumerate(flat):
            for lane in np.nonzero((row < 0) | (row > n_roots))[0][:5]:
                assert got_r[t * block_w + lane] == (
                    row[:lane] == row[lane]).sum()
        return
    rh, rr = rpk.postings_pallas(jnp.asarray(ids), n_roots=n_roots,
                                 block_w=block_w, interpret=True)
    np.testing.assert_array_equal(got_h, np.asarray(rh))
    np.testing.assert_array_equal(got_r, np.asarray(rr))


@pytest.mark.parametrize("block_w", [1, 128, 2048, 1 << 16])
def test_host_build_of_bitonic_instance_takes_out_of_range_ids(block_w):
    """The bitonic instance gives ids outside [0, n_roots] the plain
    version's answer too, as long as their composite keys fit int32."""
    rng = np.random.default_rng(block_w)
    n_roots = 60
    ids = rng.integers(0, n_roots + 1, size=2 * block_w + 3).astype(np.int32)
    bad = rng.random(ids.size) < 0.1
    ids[bad] = rng.choice(np.array([-1, -7, n_roots + 1, n_roots + 9],
                                   np.int32), size=int(bad.sum()))
    tiles = tpk.pad_ids(torch.from_numpy(ids), n_roots=n_roots,
                        block_w=block_w)
    want = tpk.postings_plain(tiles, n_roots=n_roots, block_w=block_w)
    got = build.host_postings(tiles.numpy(), n_roots=n_roots,
                              block_w=block_w, instance="bitonic")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


# the 262,144-key dictionary's vocabulary: its counters fit no block
BIG_VOCAB = 262_143
SLICED_CASES = ("all dropped", "one root", "zipf", "slice edges",
                "out of range")


def _big_vocab_ids(case: str, w: int, seed: int, block_w: int,
                   n_roots: int = BIG_VOCAB) -> np.ndarray:
    """ids int32[w] over n_roots roots for one of SLICED_CASES: the drop
    bucket only; one root; a Zipf draw whose ranks are spread over the ids
    (an odd multiplier, coprime to 2^18 and to 2^18 + 1); the ids on both
    sides of every slice edge of a ``block_w`` launch, and the first and
    last bins; the Zipf draw with 1 in 10 ids outside [0, n_roots]."""
    rng = np.random.default_rng(seed)
    n_pad = n_roots + 1
    if case == "all dropped":
        return np.full(w, n_roots, np.int32)
    if case == "one root":
        return np.full(w, rng.integers(n_roots), np.int32)
    if case == "slice edges":
        bins, n_slices = tpk.slices(n_roots, block_w)
        edges = np.arange(1, n_slices) * bins
        values = np.concatenate([edges - 1, edges, [0, n_roots]])
        return rng.choice(values, size=w).astype(np.int32)
    ranks = (rng.zipf(1.3, size=w) - 1) % n_pad
    ids = (ranks * 40_503 + 11) % n_pad
    if case == "out of range":
        bad = rng.random(w) < 0.1
        extra = np.concatenate([OUT_OF_RANGE, [n_pad, n_pad + 8]])
        ids[bad] = rng.choice(extra, size=int(bad.sum()))
    return ids.astype(np.int32)


@pytest.mark.parametrize("case", SLICED_CASES)
@pytest.mark.parametrize("block_w", [128, 2048, 4096])
@pytest.mark.parametrize("n_roots", [BIG_VOCAB, BIG_VOCAB + 1])
def test_host_build_of_sliced_instance_matches_plain(n_roots, block_w, case):
    """The g++ build of the sliced instance (postings.cuh; a tile's slices
    one after another in one block's counters) against the plain version,
    bit for bit, over the 262,144-key vocabulary: three tiles, the last
    padded with drop ids. At BIG_VOCAB + 1 roots (the 262,144-key
    dictionary's own vocabulary, 262,145 bins) the last slice holds the
    drop bucket alone and the histogram rows are not 16-byte aligned."""
    assert tpk._instance(n_roots, block_w) == "sliced"
    ids = _big_vocab_ids(case, 2 * block_w + block_w // 2 + 1, block_w,
                         block_w, n_roots)
    tiles = tpk.pad_ids(torch.from_numpy(ids), n_roots=n_roots,
                        block_w=block_w)
    want_h, want_r = tpk.postings_plain(tiles, n_roots=n_roots,
                                        block_w=block_w)
    got_h, got_r = build.host_postings(tiles.numpy(), n_roots=n_roots,
                                       block_w=block_w, instance="sliced")
    np.testing.assert_array_equal(got_h, want_h.numpy())
    np.testing.assert_array_equal(got_r, want_r.numpy())
    if case == "slice edges":
        bins = tpk.slices(n_roots, block_w)[0]
        assert (got_h[:, bins - 1] > 0).any() and (got_h[:, bins] > 0).any()


def test_sliced_instance_matches_pallas():
    """The sliced instance's g++ build against the interpret-mode Pallas
    kernel, on Zipf ids of the 262,144-key vocabulary (two tiles)."""
    block_w = 128
    ids = _big_vocab_ids("zipf", 2 * block_w, 5, block_w)
    want_h, want_r = rpk.postings_pallas(jnp.asarray(ids), n_roots=BIG_VOCAB,
                                         block_w=block_w, interpret=True)
    got_h, got_r = build.host_postings(ids, n_roots=BIG_VOCAB,
                                       block_w=block_w, instance="sliced")
    np.testing.assert_array_equal(got_h, np.asarray(want_h))
    np.testing.assert_array_equal(got_r, np.asarray(want_r))


@pytest.mark.parametrize("case", ("realistic", "out of range"))
def test_counting_instance_is_the_one_slice_case(case):
    """At the realistic vocabulary the counting instance's one slice and
    the sliced instance's two (2048 bins a block at block_w 4096) give
    the plain version's hist and rank."""
    block_w = 4096
    ids, n_roots = _case_ids(case, 3 * block_w, seed=3)
    tiles = tpk.pad_ids(torch.from_numpy(ids), n_roots=n_roots,
                        block_w=block_w)
    want = tpk.postings_plain(tiles, n_roots=n_roots, block_w=block_w)
    assert build.host_postings_slice_bins(
        n_roots=n_roots, block_w=block_w, instance="sliced") < n_roots + 1
    for instance in ("counting", "sliced"):
        got = build.host_postings(tiles.numpy(), n_roots=n_roots,
                                  block_w=block_w, instance=instance)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy())


@pytest.mark.parametrize("block_w", [1, 16, 256, 2048, 8192, 16384])
def test_instance_rule_matches_the_header(block_w):
    """kernels/postings.py:_instance picks what postings.cuh's rule picks:
    bitonic past 8192 lanes, else counting while the counters fit one
    block's shared memory, else sliced; ``slices`` gives the header's bins
    a block. The realistic vocabulary at the index path's block_w 2048 is
    counted in one slice, the 262,144-key dictionary's in slices of 4096
    bins."""
    for n_roots in (0, 1, 2231, 14_000, 14_600, 59_000, 120_000, BIG_VOCAB):
        if (n_roots + 1) * block_w >= tpk.MAX_COMPOSITE:
            continue
        want = build.host_postings_instance(
            n_roots=n_roots, block_w=block_w, max_smem=tpk.SMEM_BLOCK_BYTES)
        instance = tpk._instance(n_roots, block_w)
        assert instance == want, (n_roots, block_w)
        if instance != "bitonic":
            bins, n_slices = tpk.slices(n_roots, block_w)
            assert bins == build.host_postings_slice_bins(
                n_roots=n_roots, block_w=block_w, instance=instance)
            assert (n_slices - 1) * bins < n_roots + 1 <= n_slices * bins
    assert tpk._instance(2231, 2048) == "counting"
    assert tpk.slices(2231, 2048) == (2232, 1)
    assert tpk._instance(BIG_VOCAB, 2048) == "sliced"
    assert tpk.slices(BIG_VOCAB, 2048) == (4096, 64)
    assert tpk._instance(2231, 16384) == "bitonic"


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


def test_reset_zeroes_instance_counts():
    from repro_torch.kernels import ops

    tpk.postings_cuda.instances["counting"] += 3
    ops.reset_dispatch_count()
    assert tpk.postings_cuda.instances == {"counting": 0, "sliced": 0,
                                           "bitonic": 0}
    assert tpk.postings_cuda in ops.CUDA_WRAPPERS


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
@pytest.mark.parametrize("block_w", [1, 8, 32, 128, 1024, 2048, 4096, 8192,
                                     1 << 16, 1 << 17])
def test_postings_kernel_matches_plain_on_card(block_w):
    """The three instances, each launch on the instance its shape picks
    (by the per-instance counter and by the library's own rule), ids
    outside [0, n_roots] included where the instance takes them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    lib = build.postings_library()
    for n_roots, w in ((2231, 5 * block_w + 17), (1, 3 * block_w),
                       (60, block_w), (BIG_VOCAB if block_w <= 4096 else 60,
                                       2 * block_w)):
        ids = _ids(n_roots, w, seed=w)
        instance = tpk._instance(n_roots, block_w)
        bad = np.random.default_rng(w).random(w) < 0.05
        extra = OUT_OF_RANGE if instance != "bitonic" else np.array(
            [-1, -7, n_roots + 1, n_roots + 9], np.int32)
        ids[bad] = np.resize(extra, int(bad.sum()))
        tiles = tpk.pad_ids(torch.from_numpy(ids).cuda(), n_roots=n_roots,
                            block_w=block_w)
        before = dict(tpk.postings_cuda.instances)
        got = tpk.postings_cuda(tiles, n_roots=n_roots, block_w=block_w)
        torch.cuda.synchronize()
        want = tpk.postings_plain(tiles, n_roots=n_roots, block_w=block_w)
        assert all(torch.equal(g, x) for g, x in zip(got, want))
        assert tpk.postings_cuda.instances[instance] == before[instance] + 1
        assert build.POSTINGS_INSTANCES[lib.postings_instance(
            block_w, n_roots + 1, tpk.SMEM_BLOCK_BYTES)] == instance

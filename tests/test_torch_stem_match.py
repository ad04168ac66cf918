"""The port's standalone Compare kernels (repro_torch.kernels.stem_match):
the comparator bank (K7) and the sorted search (K8), plain versions
against the JAX package's interpret-mode Pallas kernels, bool[N] flags
identical, the padding hits included."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import corpus as rcorpus  # noqa: E402
from repro.core import stemmer as rstemmer  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import stem_match as rsm  # noqa: E402
from repro_torch.core import corpus as tcorpus  # noqa: E402
from repro_torch.core import stemmer as tstemmer  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import stem_match as tsm  # noqa: E402


def _table(r: int, seed: int, *, sort: bool) -> np.ndarray:
    rng = np.random.default_rng(seed)
    d = rng.choice(1 << 24, size=r, replace=False).astype(np.int32)
    return np.sort(d) if sort else d


def _keys(n: int, table: np.ndarray, seed: int) -> np.ndarray:
    """Random keys, about a third of them hits."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 24, size=n).astype(np.int32)
    hit = rng.random(n) < 1 / 3
    keys[hit] = rng.choice(table, size=int(hit.sum()))
    return keys


def _bank(keys, table, **kw):
    want = rsm.dict_match_pallas(jnp.asarray(keys), jnp.asarray(table),
                                 interpret=True, **kw)
    got = tsm.dict_match_plain(torch.from_numpy(keys),
                               torch.from_numpy(table), **kw)
    return got, np.asarray(want)


def _bsearch(keys, table, **kw):
    want = rsm.dict_match_bsearch_pallas(jnp.asarray(keys),
                                         jnp.asarray(table),
                                         interpret=True, **kw)
    got = tsm.dict_match_bsearch_plain(torch.from_numpy(keys),
                                       torch.from_numpy(table), **kw)
    return got, np.asarray(want)


@pytest.mark.parametrize("block_n,block_r", [(1, 1), (2, 8), (4, 2)])
@pytest.mark.parametrize("r", [1, 64, 500, 2048])
@pytest.mark.parametrize("n", [1, 5, 128, 300, 1024])
def test_bank_plain_matches_pallas(n, r, block_n, block_r):
    """The table in any order (the bank does not need it sorted)."""
    table = _table(r, n * 1000 + r, sort=False)
    keys = _keys(n, table, r)
    got, want = _bank(keys, table, block_n=block_n, block_r=block_r)
    assert got.dtype == torch.bool and tuple(got.shape) == (n,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("r", [1, 127, 128, 129, 2000, 4096])
def test_bsearch_plain_matches_pallas(r):
    table = _table(r, r, sort=True)
    keys = _keys(1000, table, r + 1)
    keys[:3] = [table[0], table[-1], table[0] - 1]
    got, want = _bsearch(keys, table)
    assert got.dtype == torch.bool and tuple(got.shape) == (1000,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.isin(keys, table))


@pytest.mark.parametrize("r", [1000, 1024])
def test_bank_padding_hits_like_the_reference(r):
    """A key equal to DICT_PAD (-2) hits if and only if the table was
    padded (R not a multiple of block_r * 128); KEY_PAD (-1) never hits."""
    table = _table(r, 3, sort=False)
    keys = np.array([-2, -1, table[5], 7], np.int32)
    got, want = _bank(keys, table)
    np.testing.assert_array_equal(got.numpy(), want)
    assert bool(want[0]) == (r % (8 * tsm.LANE) != 0)
    assert not want[1]


@pytest.mark.parametrize("r", [100, 128, 200, 256])
def test_bsearch_sentinel_hits_like_the_reference(r):
    """A key equal to DICT_SENTINEL hits if and only if R is not already
    the padded (pow2 >= 128) size."""
    table = _table(r, 4, sort=True)
    keys = np.array([tsm.DICT_SENTINEL, table[3], -1], np.int32)
    got, want = _bsearch(keys, table)
    np.testing.assert_array_equal(got.numpy(), want)
    assert bool(want[0]) == (r not in (128, 256))


def test_placeholder_table_through_both():
    """The empty-table placeholder [-1] goes through both like any table:
    -1 hits both; -2 hits the bank (its padding); the sentinel hits the
    search (its padding)."""
    table = np.array([-1], np.int32)
    keys = np.array([-1, -2, tsm.DICT_SENTINEL, 0, 5], np.int32)
    for run in (_bank, _bsearch):
        got, want = run(keys, table)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(_bank(keys, table)[1],
                                  [True, True, False, False, False])
    np.testing.assert_array_equal(_bsearch(keys, table)[1],
                                  [True, False, True, False, False])


def test_dict_match_entry_point_matches_reference():
    table = _table(700, 9, sort=True)
    keys = _keys(513, table, 10)
    for strategy, kw in (("bank", {}), ("bank", dict(block_n=1, block_r=2)),
                         ("bsearch", {}), ("bsearch", dict(block_r=3))):
        want = rops.dict_match(jnp.asarray(keys), jnp.asarray(table),
                               strategy=strategy, interpret=True, **kw)
        got = ops.dict_match(keys, table, strategy=strategy, device="cpu",
                             **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="unknown match strategy: tree"):
        ops.dict_match(keys, table, strategy="tree", device="cpu")
    assert ops.dispatch_count() == 0


def test_realistic_tables_and_candidate_keys():
    """The stemmer's own keys (candidate slots of real words) against the
    realistic tables, both strategies, as the staged path calls them."""
    d = rcorpus.build_dictionary()
    da = rstemmer.RootDictArrays.from_rootdict(d)
    w, _, _ = rcorpus.build_corpus(n_words=400, seed=1)
    enc = rcorpus.encode_corpus(w)
    keys = np.array(rstemmer.pack_keys(
        rstemmer.generate_stems(jnp.asarray(enc))[0])).reshape(-1)
    for table in (np.array(da.tri), np.array(da.quad), np.array(da.bi)):
        for run in (_bank, _bsearch):
            got, want = run(keys, table)
            np.testing.assert_array_equal(got.numpy(), want)


def test_plain_bank_chunks_its_temporary(monkeypatch):
    """Chunked all-pairs compare gives the unchunked answer."""
    table = _table(300, 11, sort=False)
    keys = _keys(1000, table, 12)
    want = tsm.dict_match_plain(torch.from_numpy(keys),
                                torch.from_numpy(table))
    monkeypatch.setattr(tsm, "_BANK_TEMP_BYTES", 3 * 1024)
    got = tsm.dict_match_plain(torch.from_numpy(keys),
                               torch.from_numpy(table))
    assert torch.equal(got, want)


def test_guards():
    k = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="block_n and block_r"):
        tsm.dict_match_plain(k, k, block_r=0)
    with pytest.raises(ValueError, match="block_n and block_r"):
        tsm.dict_match_bsearch_plain(k, k, block_n=0)
    for fn in (tsm.dict_match_cuda, tsm.dict_match_bsearch_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(k, k)
        assert fn.launches == 0


def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("block_n,block_r", [(1, 1), (2, 8), (4, 2),
                                             (16, 200)])
def test_bank_kernel_matches_plain_on_card(block_n, block_r):
    _on_card()
    for n, r in ((2, 1), (300, 500), (1024, 2048), (100_000, 2048)):
        table = torch.from_numpy(_table(r, r, sort=False)).cuda()
        keys = torch.from_numpy(_keys(n, table.cpu().numpy(), n)).cuda()
        keys[:2] = torch.tensor([tsm.DICT_PAD, tsm.KEY_PAD])
        got = tsm.dict_match_cuda(keys, table, block_n=block_n,
                                  block_r=block_r)
        torch.cuda.synchronize()
        want = tsm.dict_match_plain(keys, table, block_n=block_n,
                                    block_r=block_r)
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_bsearch_kernel_matches_plain_on_card():
    """Tables in shared memory (up to 32,768 padded entries) and in global
    memory (the 262,144-key grown dictionary)."""
    _on_card()
    da = tstemmer.RootDictArrays.from_rootdict(tcorpus.build_dictionary())
    grown = tcorpus.grow_root_arrays(da, 262_144)
    tables = [da.tri, da.quad, da.bi, grown.tri,
              torch.from_numpy(_table(32_768, 1, sort=True)).cuda(),
              torch.from_numpy(_table(40_000, 2, sort=True)).cuda()]
    for table in tables:
        keys = torch.from_numpy(_keys(200_000, table.cpu().numpy(), 3)).cuda()
        keys[:2] = torch.tensor([tsm.DICT_SENTINEL, -1])
        for block_n in (1, 8):
            got = tsm.dict_match_bsearch_cuda(keys, table, block_n=block_n)
            torch.cuda.synchronize()
            want = tsm.dict_match_bsearch_plain(keys, table)
            assert torch.equal(got, want)

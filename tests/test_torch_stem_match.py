"""The port's standalone Compare kernels (repro_torch.kernels.stem_match):
the comparator bank (K7) and the sorted search (K8), plain versions
against the JAX package's interpret-mode Pallas kernels, bool[N] flags
identical, the padding hits included; the g++ build of K7's banks
(csrc/dict_bank.cuh: the bank build and the four-key probe) against the
plain version."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.core import corpus as rcorpus  # noqa: E402
from repro.core import stemmer as rstemmer  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import stem_match as rsm  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
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


def _adversarial(n: int, start: int = 0) -> np.ndarray:
    """n distinct int32 values that all hash into bank 0 at any bank count
    up to 2^16: the inverse of the hash's multiplier times 0, 1, ..."""
    inv = pow(tsm.BANK_HASH_MUL, -1, 1 << 32)
    t = np.arange(start, start + n, dtype=np.uint64)
    return (t * inv % (1 << 32)).astype(np.uint32).view(np.int32)


def _bank_table(kind: str) -> np.ndarray:
    """The tables K7 must take: the realistic tri table, one unsorted with
    duplicates and negative values, the empty-table placeholder, one whose
    entries all fall in one bank, and one larger than a block's bank
    budget (BANK_CHUNK_MAX entries), shuffled."""
    rng = np.random.default_rng(len(kind))
    if kind == "realistic tri":
        da = tstemmer.RootDictArrays.from_rootdict(tcorpus.build_dictionary(),
                                                   device="cpu")
        return da.tri.numpy()
    if kind == "unsorted, duplicates":
        d = rng.integers(-(1 << 31), 1 << 31, size=900).astype(np.int32)
        return np.concatenate([d, d[:100], d[::-7], [-2, -2, -1]]).astype(
            np.int32)
    if kind == "placeholder [-1]":
        return np.array([-1], np.int32)
    if kind == "adversarial":
        return _adversarial(1500)
    assert kind == "larger than shared memory"
    return rng.permutation(rng.choice(1 << 24, size=20_000, replace=False)
                           ).astype(np.int32)


BANK_TABLES = ("realistic tri", "unsorted, duplicates", "placeholder [-1]",
               "adversarial", "larger than shared memory")


def _bank_keys(table: np.ndarray, n: int, seed: int) -> np.ndarray:
    """Hits, misses, keys in the adversarial bank, and the keys that hit
    only padding (-2), never (-1) or the sorted layout's sentinel."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(-(1 << 31), 1 << 31, size=max(n, 4)).astype(np.int32)
    keys[::3] = rng.choice(table, size=keys[::3].size)
    keys[1::7] = _adversarial(keys[1::7].size, start=1 << 12)
    keys[:4] = [tsm.DICT_PAD, tsm.KEY_PAD, tsm.DICT_SENTINEL, table[-1]]
    return keys[:n]


@pytest.mark.parametrize("block_r", [1, 8])
@pytest.mark.parametrize("kind", BANK_TABLES)
def test_host_build_of_banks_matches_plain(kind, block_r):
    """The g++ build of dict_bank.cuh (banked chunk by chunk, four keys a
    probe, the ragged tail one by one) against the plain all-pairs
    version, bit for bit, and through it against the interpret-mode
    Pallas kernel for the tables it compares in reasonable time."""
    table = _bank_table(kind)
    keys = _bank_keys(table, 4099, seed=block_r)
    rp = tsm.bank_padded(table.shape[0], block_r)
    want = tsm.dict_match_plain(torch.from_numpy(keys),
                                torch.from_numpy(table), block_r=block_r)
    got = build.host_dict_bank(keys, table, rp=rp, chunk=tsm.bank_chunk(rp))
    np.testing.assert_array_equal(got, want.numpy())
    assert bool(got[0]) == (rp != table.shape[0] or bool((table == -2).any()))
    assert not got[2] and got[3]
    if table.shape[0] <= 2048:
        ref = rsm.dict_match_pallas(jnp.asarray(keys), jnp.asarray(table),
                                    block_r=block_r, interpret=True)
        np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("n", [1, 3, 4, 5, 130])
def test_host_build_of_banks_takes_any_key_count(n):
    """Keys in whole quads and a ragged tail, and an empty table (no
    entries at all: nothing hits, not even -2)."""
    table = _bank_table("unsorted, duplicates")
    keys = _bank_keys(table, n, seed=n)
    for block_r in (1, 3):
        rp = tsm.bank_padded(table.shape[0], block_r)
        want = tsm.dict_match_plain(torch.from_numpy(keys),
                                    torch.from_numpy(table), block_r=block_r)
        got = build.host_dict_bank(keys, table, rp=rp,
                                   chunk=tsm.bank_chunk(rp))
        np.testing.assert_array_equal(got, want.numpy())
    empty = np.zeros(0, np.int32)
    want = tsm.dict_match_plain(torch.from_numpy(keys),
                                torch.from_numpy(empty))
    got = build.host_dict_bank(keys, empty, rp=0, chunk=tsm.bank_chunk(0))
    assert not want.any()
    np.testing.assert_array_equal(got, want.numpy())


def test_bank_stats_count_what_the_banks_do():
    """bank_stats: the realistic tri table spreads over 2048 banks (a few
    entries in the largest, about one compare a key), the adversarial one
    falls in a single bank, and a table past BANK_CHUNK_MAX is banked in
    chunks."""
    keys = torch.from_numpy(_bank_keys(_bank_table("realistic tri"), 4096,
                                       seed=1))
    real = tsm.bank_stats(keys, torch.from_numpy(_bank_table("realistic tri")))
    assert real["banks"] == 2048 and real["chunks"] == 1
    assert real["entries"] == 2001          # 2000 keys and one -2
    assert real["largest"] <= 8 and real["compares"] < 2 * keys.numel()
    adv = _bank_table("adversarial")
    stats = tsm.bank_stats(torch.from_numpy(adv), torch.from_numpy(adv))
    assert stats["largest"] == adv.size
    assert stats["compares"] == adv.size * adv.size
    big = tsm.bank_stats(keys, torch.from_numpy(
        _bank_table("larger than shared memory")))
    assert big["chunks"] == 3 and big["banks"] == tsm.BANK_CHUNK_MAX
    assert tsm.bank_bits(tsm.BANK_CHUNK_MAX) == 13 and tsm.bank_bits(1) == 5
    np.testing.assert_array_equal(tsm.bank_of(_adversarial(64), 16), 0)


# the sorted search's table sizes: below, at and past LANE, the realistic
# tri table's padded size, the shared instance's largest table and one
# past it, and the 262,144-key dictionaries
SEARCH_SIZES = (1, 127, 128, 129, 2000, 32_768, 32_769, 262_144)


@functools.lru_cache(maxsize=None)
def _search_case(r: int):
    """A sorted table of r keys, keys that hit and miss with the sentinel,
    KEY_PAD, the table's ends and a key below it (a count that is not a
    multiple of 4), and the plain and interpret-mode Pallas flags."""
    table = _table(r, r + 17, sort=True)
    keys = _keys(1001, table, r + 18)
    keys[:5] = [tsm.DICT_SENTINEL, tsm.KEY_PAD, table[0], table[-1],
                table[0] - 1]
    got, want = _bsearch(keys, table)
    return table, keys, got.numpy(), want


@pytest.mark.parametrize("instance", ["shared", "global"])
@pytest.mark.parametrize("r", SEARCH_SIZES)
def test_host_build_of_search_matches_plain_and_pallas(r, instance):
    """The g++ build of csrc/dict_search.cuh (the fence tree, the 8-entry
    block, the padding read virtually; four keys a probe and the ragged
    tail one by one) against the plain version and the interpret-mode
    Pallas kernel, bit for bit: the sentinel hits exactly when the table
    was padded, KEY_PAD never (no table here holds it)."""
    table, keys, plain, ref = _search_case(r)
    np.testing.assert_array_equal(plain, ref)
    for n in (1001, 1000, 3):
        for grid in (1, 132):
            got, log2s = build.host_dict_bsearch(keys[:n], table,
                                                 instance=instance, grid=grid)
            np.testing.assert_array_equal(got, plain[:n])
            assert (log2s == 0) == (instance == "shared")
    assert bool(plain[0]) == (tsm.sorted_padded(r) != r)
    assert not plain[1] and plain[2] and plain[3] and not plain[4]


@pytest.mark.parametrize("instance", ["shared", "global"])
def test_host_build_of_search_takes_odd_tables(instance):
    """The placeholder [-1] (KEY_PAD hits), a table with duplicates, a
    table read at a 4-byte offset (the global instance's scalar path), and
    one past the fence budget; the global instance at launches of 1 and
    132 blocks, whose steps differ (a bisection of 8-entry blocks in the
    segment past S = 8)."""
    rng = np.random.default_rng(5)
    dup = np.sort(np.repeat(_table(300, 6, sort=False), 3)).astype(np.int32)
    big = _table(600_001, 7, sort=True)
    for table in (np.array([-1], np.int32), dup, big[1:], big[:300_000]):
        keys = _keys(4099, table, 8)
        keys[:3] = [tsm.DICT_SENTINEL, tsm.KEY_PAD, table[-1]]
        keys[3::50] = rng.integers(-(1 << 31), 1 << 31, keys[3::50].size)
        want = tsm.dict_match_bsearch_plain(torch.from_numpy(keys),
                                            torch.from_numpy(table))
        steps = set()
        for grid in (1, 132):
            got, log2s = build.host_dict_bsearch(keys, table,
                                                 instance=instance, grid=grid)
            np.testing.assert_array_equal(got, want.numpy())
            steps.add(log2s)
        if instance == "global" and table.size > 100_000:
            assert len(steps) == 2 and min(steps) >= 3
    assert build.host_bsearch_instance(tsm.sorted_padded(32_768)) == "shared"
    assert build.host_bsearch_instance(tsm.sorted_padded(32_769)) == "global"


def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("block_n,block_r", [(1, 1), (2, 8), (4, 2),
                                             (16, 200)])
def test_bank_kernel_matches_plain_on_card(block_n, block_r):
    """Random tables, the tables of BANK_TABLES, keys not 16-byte aligned
    (the wrapper copies them) and a ragged tail."""
    _on_card()
    cases = [(n, _table(r, r, sort=False)) for n, r in
             ((2, 1), (300, 500), (1024, 2048), (100_000, 2048))]
    cases += [(100_003, _bank_table(kind)) for kind in BANK_TABLES]
    for n, table_np in cases:
        table = torch.from_numpy(table_np).cuda()
        keys = torch.from_numpy(_bank_keys(table_np, n + 1, n)).cuda()
        for k in (keys[:n], keys[1:]):
            got = tsm.dict_match_cuda(k, table, block_n=block_n,
                                      block_r=block_r)
            torch.cuda.synchronize()
            want = tsm.dict_match_plain(k, table, block_n=block_n,
                                        block_r=block_r)
            assert torch.equal(got, want)


@pytest.mark.cuda
def test_bsearch_kernel_matches_plain_on_card():
    """Tables in shared memory (up to 32,768 padded entries) and in global
    memory (the 262,144-key grown dictionary, SEARCH_SIZES past 32,768),
    each launch's instance from its counter; keys with the sentinel and
    KEY_PAD, counts not a multiple of 4, keys at a 4-byte offset (the
    wrapper copies them); and one kernel queued a call."""
    _on_card()
    da = tstemmer.RootDictArrays.from_rootdict(tcorpus.build_dictionary())
    grown = tcorpus.grow_root_arrays(da, 262_144)
    tables = [da.tri, da.quad, da.bi, grown.tri,
              torch.from_numpy(_table(32_768, 1, sort=True)).cuda(),
              torch.from_numpy(_table(40_000, 2, sort=True)).cuda()]
    tables += [torch.from_numpy(_search_case(r)[0]).cuda()
               for r in SEARCH_SIZES]
    for table in tables:
        keys = torch.from_numpy(_keys(200_003, table.cpu().numpy(), 3)).cuda()
        keys[:2] = torch.tensor([tsm.DICT_SENTINEL, -1])
        inst = build.host_bsearch_instance(tsm.sorted_padded(table.shape[0]))
        for block_n in (1, 8):
            for k in (keys[:200_000], keys[1:], keys[:4097], keys[3:6]):
                tsm.dict_match_bsearch_cuda.instances[inst] = 0
                got = tsm.dict_match_bsearch_cuda(k, table, block_n=block_n)
                torch.cuda.synchronize()
                want = tsm.dict_match_bsearch_plain(k, table)
                assert torch.equal(got, want)
                assert tsm.dict_match_bsearch_cuda.instances[inst] == 1
    from torch.profiler import ProfilerActivity, profile

    keys = torch.from_numpy(_keys(24_576, da.tri.cpu().numpy(), 4)).cuda()
    for table in (da.tri, grown.tri):
        tsm.dict_match_bsearch_cuda(keys, table)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            tsm.dict_match_bsearch_cuda(keys, table)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(kernels) == 1, [e.name for e in kernels]

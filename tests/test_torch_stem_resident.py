"""The resident stemmer kernels' per-word search and tile walk (K1 and K3
resident, csrc/stem_resident.cuh) against the plain versions and the JAX
package.

On the CPU the g++ build of the header runs a launch as the card would:
block by block through the walk, each word's live slots split across G
lanes in rounds, the lanes' votes in lane order. It is held bit for bit to
``stem_fused_plain`` and ``persistent_resident_plain`` (roots, sources,
flags) for G in {1, 2, 4, 8}, both matches, infix on and off, on the
realistic dictionary, a grown one (global memory on the card) and one
built so that words hit only on their last live slot (the rounds and the
vote past the first). The plain path is held to the reference's
``stem_fused_pallas`` in interpret mode. Every compared output is int32
and must be identical."""
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

LANES = (1, 2, 4, 8)
H100_SMS = 132


def _walk(n: int, block_b: int, capacity: int, lanes: int, persistent: bool,
          sms: int = H100_SMS) -> dict:
    """The walk the g++ build of the header gives a launch over n words:
    K1's (the words one tile; block_b only groups them) or K3 resident's
    ring of whole tiles of block_b."""
    bb = block_b if persistent else n
    bt = -(-n // bb)
    return build.host_resident_walk(bt * bb, bt, bb, capacity, sms=sms,
                                    persistent=persistent, lanes=lanes)


def _port(da):
    return tstemmer.RootDictArrays.from_numpy(
        np.asarray(da.tri), np.asarray(da.quad), np.asarray(da.bi),
        device="cpu")


def _live(words: np.ndarray):
    keys, valid = tsf._candidates(torch.from_numpy(words), 5)
    return keys.numpy(), valid.numpy()


@pytest.fixture(scope="module")
def words():
    """Corpus words, words with five to twelve live slots (the most any of
    131,072 corpus words has), and rows no encoder emits (interior pads,
    codes past the alphabet)."""
    base = next(tcorpus.stream_corpus_words(2000, seed=2, chunk_words=2000))
    pool = next(tcorpus.stream_corpus_words(1 << 17, seed=7,
                                            chunk_words=1 << 17)).words
    n_live = _live(pool)[1].sum(1)
    many = np.concatenate([pool[n_live >= 8][:300],
                           pool[(n_live >= 5) & (n_live < 8)][:300]])
    rng = np.random.default_rng(11)
    odd = rng.integers(0, 64, size=(64, 16)).astype(np.int32)
    odd[rng.random(odd.shape) < 0.3] = 0
    return np.concatenate([base.words, many, odd])


def _late_hit_dict(words: np.ndarray):
    """A dictionary holding each word's last live key and no other of its
    keys, plus every third word's second-to-last: first hits past the
    first round at small G, and two hits a round."""
    keys, valid = _live(words)
    tables = {"tri": set(), "quad": set(), "bi": set()}
    for i, (k, v) in enumerate(zip(keys, valid)):
        live = np.flatnonzero(v)
        for s in live[-2:] if i % 3 == 0 else live[-1:]:
            tables[tsf.GROUP_DICTS[s // tsf.N_CAND]].add(int(k[s]))
    for k, v in zip(keys, valid):               # no early slot may hit
        live = np.flatnonzero(v)
        for s in live[:-2]:
            tables[tsf.GROUP_DICTS[s // tsf.N_CAND]].discard(int(k[s]))
    arr = [np.array(sorted(tables[n]) or [0], np.int32)
           for n in ("tri", "quad", "bi")]
    return tstemmer.RootDictArrays.from_numpy(*arr, device="cpu")


@pytest.fixture(scope="module")
def dicts(words):
    real = _port(rstemmer.RootDictArrays.from_rootdict(
        rcorpus.build_dictionary()))
    return {"realistic": real,
            "grown": tcorpus.grow_root_arrays(real, 60_000),
            "late hits": _late_hit_dict(words)}


@pytest.fixture(scope="module")
def plain_cache():
    return {}


def _case(words, dicts, plain_cache, dict_name, match, infix):
    """Words, padded tables and the plain K1 output of one case (the grown
    dictionary's bank on fewer words: its plain version compares them
    all-pairs)."""
    w = words[:700] if (dict_name, match) == ("grown", "bank") else words
    tables = tsf.padded_tables(dicts[dict_name], match=match, infix=infix)
    key = (dict_name, match, infix)
    if key not in plain_cache:
        plain_cache[key] = tsf.stem_fused_plain(
            torch.from_numpy(w), tables, n_groups=5 if infix else 2,
            match=match, block_b=256)
    return w, tables, plain_cache[key]


def test_late_hit_dict_hits_past_the_first_round(words, dicts):
    """The late-hit dictionary does what its tests need: first hits at
    live ranks up to 8, and words with two hits."""
    keys, valid = _live(words)
    tables = tsf.padded_tables(dicts["late hits"], match="bsearch",
                               infix=True)
    hits = tsf._resident_hits(torch.from_numpy(keys),
                              torch.from_numpy(valid),
                              dict(zip(tsf.DICT_NAMES, tables)), n_groups=5,
                              match="bsearch").numpy()
    found = hits.any(1)
    first = np.where(found, hits.argmax(1), 30)
    rank = (valid & (np.arange(30) < first[:, None])).sum(1)[found]
    assert rank.max() >= 8 and (rank >= 2).sum() > 100
    assert (hits.sum(1) >= 2).sum() > 50


@pytest.mark.parametrize("dict_name", ["realistic", "grown", "late hits"])
@pytest.mark.parametrize("infix", [True, False])
@pytest.mark.parametrize("match", ["bsearch", "bank"])
@pytest.mark.parametrize("lanes", LANES)
def test_host_resident_matches_plain(words, dicts, plain_cache, lanes, match,
                                     infix, dict_name):
    """K1's and K3 resident's walk and lane split, bit for bit: tiles of
    256 words on the serve shape's blocks, 64-word tiles on 3 resident
    blocks (a block takes several items), 1000-word tiles (a tile in
    pieces, the last piece writing the flag)."""
    w, tables, want = _case(words, dicts, plain_cache, dict_name, match,
                            infix)
    n_groups = 5 if infix else 2
    kern = dict(n_groups=n_groups, match=tsf.MATCHES.index(match),
                lanes=lanes)
    wt = torch.from_numpy(w)
    for block_b, capacity in ((256, 528), (64, 3), (1000, 7)):
        root, source, blocks = build.host_stem_resident(
            w, tables, block_b=block_b, capacity=capacity, **kern)
        np.testing.assert_array_equal(root, want[0].numpy())
        np.testing.assert_array_equal(source, want[1].numpy())
        assert blocks == _walk(w.shape[0], block_b, capacity, lanes,
                               False)["grid"]
        bt = -(-w.shape[0] // block_b)
        desc = tsf._descriptors(bt, block_b,
                                torch.zeros(bt, dtype=torch.int32), 3)
        want3 = tsf.persistent_resident_plain(wt, tables, desc,
                                              n_groups=n_groups, match=match,
                                              block_b=block_b)
        root, source, flags, blocks = build.host_stem_resident(
            w, tables, block_b=block_b, capacity=capacity, desc=desc.numpy(),
            **kern)
        for got, x in zip((root, source, flags), want3):
            np.testing.assert_array_equal(got, x.numpy())
        assert (flags == 4).all() and blocks == _walk(
            w.shape[0], block_b, capacity, lanes, True)["grid"]


@pytest.mark.parametrize("lanes", LANES)
def test_host_resident_walks_any_ring(words, dicts, lanes):
    """K3 reads each tile through its descriptor: a reversed ring, a
    descriptor past the words and two pointing at the same rows give the
    plain version's rows and flags, whole tiles or tiles in pieces."""
    tables = tsf.padded_tables(dicts["late hits"], match="bsearch",
                               infix=True)
    w = words[:1500]
    wt = torch.from_numpy(w)
    for block_b in (100, 1024):
        bt = -(-w.shape[0] // block_b) + 1
        desc = tsf._descriptors(bt, block_b,
                                torch.zeros(bt, dtype=torch.int32), 5)
        desc = desc.flip(0).contiguous()
        desc[0, 0] = w.shape[0] + 7          # past the words: no row
        desc[1, 0] = desc[2, 0]              # the same rows twice
        want = tsf.persistent_resident_plain(wt, tables, desc, n_groups=5,
                                             match="bsearch",
                                             block_b=block_b)
        got = build.host_stem_resident(w, tables, n_groups=5, match=0,
                                       block_b=block_b, lanes=lanes,
                                       capacity=5, desc=desc.numpy())
        covered = np.zeros(w.shape[0], bool)
        for off in desc[1:, 0].numpy():
            covered[off:off + block_b] = True
        for g, x in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g[covered], x.numpy()[covered])
        assert (got[1][~covered] == -7).all()       # rows no tile covers
        np.testing.assert_array_equal(got[2], want[2].numpy())
        assert (got[2] == 6).all()


@pytest.mark.parametrize("persistent", [False, True])
def test_host_walk_fits_the_launch(persistent):
    """The g++ build of the header's walk: items that cover the tiles
    (whole tiles, `per` a pass's `stride` times up to 4 rounds for K3, or
    a tile's pieces; K1's words are one tile), a grid of one block an
    item for K1 and at most the resident blocks for K3, and the lanes
    asked for (or the rule's)."""
    for sms in (1, 16, 132):
        for capacity in (1, 3, 396, 528):
            for n, block_b in ((1, 1), (257, 64), (4096, 256), (4100, 100),
                               (65536, 256), (1 << 20, 256), (1 << 20, 2048),
                               (3000, 7)):
                for lanes in (0,) + LANES:
                    w = _walk(n, block_b, capacity, lanes, persistent, sms)
                    bb = block_b if persistent else n
                    bt = -(-n // bb)
                    case = (n, block_b, sms, capacity, lanes, w)
                    assert w["lanes"] in LANES and lanes in (0, w["lanes"])
                    assert w["width"] == 256 // w["lanes"], case
                    if w["parts"] > 1:
                        assert (w["per"], w["stride"]) == (1, 1), case
                        assert (w["parts"] - 1) * w["width"] < bb \
                            <= w["parts"] * w["width"], case
                        assert w["n_items"] == bt * w["parts"], case
                    else:
                        assert bb * w["stride"] <= w["width"] \
                            < bb * (w["stride"] + 1), case
                        rounds = w["per"] // w["stride"]
                        assert w["per"] % w["stride"] == 0, case
                        assert 1 <= rounds <= (4 if persistent else 1), case
                        assert (w["n_items"] - 1) * w["per"] < bt \
                            <= w["n_items"] * w["per"], case
                    assert w["grid"] == (min(capacity, w["n_items"])
                                         if persistent else w["n_items"])


def test_lane_rule_at_the_serve_shapes():
    """On an H100's 132 SMs: 8 lanes a word at a 4096-word serve launch
    (K1: 128 blocks of 32 words; K3: each 256-word tile in 8 pieces), 4 at
    8192 words, 2 at 16,384, and 1 from 16,896 words on (4 warps of words
    a SM): an index chunk of 131,072 words (K1: 512 blocks of 256 words)
    and 1,048,576 words (K3: 4 tiles an item)."""
    k1 = _walk(4096, 256, 1, 0, False)
    assert (k1["lanes"], k1["width"], k1["parts"], k1["grid"]) == (8, 32,
                                                                    128, 128)
    k3 = _walk(4096, 256, 528, 0, True)
    assert (k3["lanes"], k3["parts"], k3["n_items"], k3["grid"]) == (8, 8,
                                                                     128, 128)
    assert [_walk(n, 256, 528, 0, p)["lanes"]
            for n in (8192, 16384, 16640, 16896, 65536)
            for p in (False, True)] == [4, 4, 2, 2, 2, 2, 1, 1, 1, 1]
    index = _walk(131072, 2048, 1, 0, False)
    assert (index["lanes"], index["width"], index["grid"]) == (1, 256, 512)
    big = _walk(1 << 20, 256, 528, 0, True)
    assert (big["lanes"], big["per"], big["n_items"], big["grid"]) == (
        1, 4, 1024, 528)
    assert _walk(1 << 20, 256, 1, 0, False)["grid"] == 4096


@pytest.mark.parametrize("match", ["bsearch", "bank"])
def test_plain_and_host_match_reference_kernel(match):
    """Seeded numpy words (corpus words and rows drawn from the seed)
    through the reference's stem_fused_pallas in interpret mode, the
    port's plain path and the g++ build at every G: identical."""
    rng = np.random.default_rng(19)
    w, _, _ = rcorpus.build_corpus(n_words=300, seed=19)
    enc = rcorpus.encode_corpus(w)
    drawn = rng.integers(0, 40, size=(57, 16)).astype(np.int32)
    drawn[:, 6:] = 0
    enc = np.concatenate([enc, drawn])[rng.permutation(357)]
    da = rstemmer.RootDictArrays.from_rootdict(rcorpus.build_dictionary())
    want_r, want_s = rops.extract_roots_fused(jnp.asarray(enc), da,
                                              match=match, block_b=128,
                                              interpret=True)
    got_r, got_s = tops.extract_roots_fused(enc, _port(da), match=match,
                                            block_b=128, device="cpu")
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    tables = tsf.padded_tables(_port(da), match=match, infix=True)
    for lanes in LANES:
        r, s, _ = build.host_stem_resident(enc, tables, n_groups=5,
                                           match=tsf.MATCHES.index(match),
                                           block_b=128, lanes=lanes,
                                           capacity=528)
        np.testing.assert_array_equal(r, np.asarray(want_r))
        np.testing.assert_array_equal(s, np.asarray(want_s))


def test_plain_persistent_matches_reference_kernel():
    """K3 resident's plain version against the reference's persistent
    kernel in interpret mode on seeded words: roots, sources, flags."""
    w, _, _ = rcorpus.build_corpus(n_words=300, seed=23)
    enc = rcorpus.encode_corpus(w)
    da = rstemmer.RootDictArrays.from_rootdict(rcorpus.build_dictionary())
    kw = dict(block_b=64, residency="resident", version_slot=2)
    want = rops.extract_roots_persistent(jnp.asarray(enc), da,
                                         interpret=True, **kw)
    got = tops.extract_roots_persistent(enc, _port(da), device="cpu", **kw)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    assert (got[2] == 3).all()


def test_host_resident_refuses_other_lane_counts(words, dicts):
    """The host build runs 1, 2, 4 or 8 lanes a word, as the launchers
    pick them; another count is refused."""
    tables = tsf.padded_tables(dicts["realistic"], match="bsearch",
                               infix=True)
    for bad in (0, 3, 16, -1):
        with pytest.raises(ValueError):
            build.host_stem_resident(words[:8], tables, n_groups=5, match=0,
                                     block_b=256, lanes=bad, capacity=528)

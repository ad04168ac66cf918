"""The port's stemmer megakernel module (repro_torch.kernels) against the
JAX package: the datapath, the sorted search, the plain megakernel, the
launch checksum, and the host build of the CUDA datapath header. Every
compared output is int32 and must be identical."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.core import corpus as rcorpus  # noqa: E402
from repro.core import stemmer as rstemmer  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import stem_datapath as rsdp  # noqa: E402
from repro.kernels import stem_match as rsm  # noqa: E402
from repro_torch.core import corpus as tcorpus  # noqa: E402
from repro_torch.core import stemmer as tstemmer  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import stem_datapath as tsdp  # noqa: E402
from repro_torch.kernels import stem_fused as tsf  # noqa: E402
from repro_torch.kernels import stem_match as tsm  # noqa: E402


def _port(da):
    return tstemmer.RootDictArrays.from_numpy(
        np.asarray(da.tri), np.asarray(da.quad), np.asarray(da.bi),
        device="cpu")


@pytest.fixture(scope="module")
def dicts():
    da = rstemmer.RootDictArrays.from_rootdict(rcorpus.build_dictionary())
    return da, _port(da)


@pytest.fixture(scope="module")
def words():
    w, _, _ = rcorpus.build_corpus(n_words=300, seed=3)
    enc = rcorpus.encode_corpus(w)
    # plus rows no encoder emits: interior pads, codes past the alphabet
    rng = np.random.default_rng(11)
    odd = rng.integers(0, 40, size=(40, 16)).astype(np.int32)
    odd[rng.random(odd.shape) < 0.3] = 0
    return np.concatenate([enc, odd])


def test_candidate_columns_match_reference(words):
    kr, vr = rsdp.candidate_columns(jnp.asarray(words))
    kt, vt = tsdp.candidate_columns(torch.from_numpy(words))
    assert len(kt) == len(vt) == 30
    for want, got in zip(kr + vr, kt + vt):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_host_build_of_datapath_header_matches_plain(words):
    """The g++ build of csrc/stem_datapath.cuh, bit for bit against the
    plain candidate_columns on a few thousand corpus words."""
    chunk = next(tcorpus.stream_corpus_words(4000, seed=2, chunk_words=4000))
    enc = np.concatenate([chunk.words, words])
    keys, valid = build.host_candidate_columns(enc)
    kt, vt = tsdp.candidate_columns(torch.from_numpy(enc))
    np.testing.assert_array_equal(keys, torch.stack(kt, 1).numpy())
    np.testing.assert_array_equal(valid, torch.stack(vt, 1).numpy())


def test_bsearch_hit_boundaries():
    """First/last/absent keys around the sentinel padding."""
    d = np.array([3, 9, 11, 200, 2**24 - 1], np.int32)
    keys = np.array([0, 3, 4, 9, 199, 200, 2**24 - 1, 2**24 - 2], np.int32)
    flat = tsm.pad_dict_sorted(torch.from_numpy(d)).reshape(-1)
    got = tsm.bsearch_hit(flat, torch.from_numpy(keys)).numpy()
    want = np.asarray(rsm.bsearch_hit(
        rsm.pad_dict_sorted(jnp.asarray(d)).reshape(-1), jnp.asarray(keys)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, [False, True, False, True, False, True, True, False])


@pytest.mark.parametrize("r", [1, 127, 128, 129, 2000])
def test_padded_layouts_match_reference(r):
    d = np.arange(r, dtype=np.int32) * 7
    for tp, rp in ((tsm.pad_dict_sorted, rsm.pad_dict_sorted),
                   (tsm.pad_dict_lanes, rsm.pad_dict_lanes)):
        np.testing.assert_array_equal(tp(torch.from_numpy(d)).numpy(),
                                      np.asarray(rp(jnp.asarray(d))))


@pytest.mark.parametrize("match", ["bsearch", "bank"])
@pytest.mark.parametrize("infix", [True, False])
def test_plain_megakernel_matches_reference_kernel(dicts, words, infix,
                                                   match):
    da, tda = dicts
    enc = words[:300]          # ragged: 300 = 2 x 128 + 44
    want_r, want_s = rops.extract_roots_fused(
        jnp.asarray(enc), da, infix=infix, match=match, block_b=128,
        interpret=True)
    got_r, got_s = tops.extract_roots_fused(enc, tda, infix=infix,
                                            match=match, block_b=128,
                                            device="cpu")
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_empty_batch_launches_nothing(dicts):
    _, tda = dicts
    tops.reset_dispatch_count()
    r, s = tops.extract_roots_fused(np.zeros((0, 16), np.int32), tda,
                                    device="cpu")
    assert tuple(r.shape) == (0, 4) and tuple(s.shape) == (0,)
    assert r.dtype == s.dtype == torch.int32
    assert tops.dispatch_count() == 0
    assert tsf.planned_launches(0, tda) == 0
    assert tsf.planned_launches(300, tda) == 1


def test_grown_dictionary_plain_path(dicts, words):
    """~60K loaded keys: past the kernel's shared-memory budget (the CUDA
    kernel reads such tables from global memory), still resident."""
    da, tda = dicts
    grown_ref = rcorpus.grow_root_arrays(da, 60_000)
    grown = tcorpus.grow_root_arrays(tda, 60_000)
    for want, got in zip((grown_ref.tri, grown_ref.quad, grown_ref.bi),
                         grown.numpy()):
        np.testing.assert_array_equal(got, np.asarray(want))
    tables = tsf.padded_tables(grown, match="bsearch", infix=True)
    assert not tsf.dict_in_shared(tables, n_groups=5)
    assert not tsf.dict_in_shared(
        tsf.padded_tables(grown, match="bank", infix=False), n_groups=2)
    assert tsf.dict_in_shared(tsf.padded_tables(tda, match="bsearch",
                                                infix=True), n_groups=5)
    enc = words[:300]
    want_r, want_s = rstemmer.extract_roots(jnp.asarray(enc), grown_ref,
                                            backend="sorted")
    for match in ("bsearch", "bank"):
        got_r, got_s = tops.extract_roots_fused(enc, grown, match=match,
                                                block_b=128, device="cpu")
        np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("block_b", [1, 128, 512])
def test_tile_checksum_matches_reference_and_host(block_b):
    rng = np.random.default_rng(block_b)
    rows = 4 * block_b
    # full int32 range: every product and sum overflows int32
    roots = rng.integers(-2**31, 2**31, size=(rows, 4)).astype(np.int32)
    sources = rng.integers(-2**31, 2**31, size=rows).astype(np.int32)
    got = tops.tile_checksum(torch.from_numpy(roots),
                             torch.from_numpy(sources), block_b=block_b)
    assert got.dtype == torch.int32
    want = np.asarray(rops.tile_checksum(jnp.asarray(roots),
                                         jnp.asarray(sources),
                                         block_b=block_b))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tops.tile_checksum_host(roots, sources, block_b=block_b), want)


def test_with_checksum_returns_the_tile_row(dicts, words):
    _, tda = dicts
    r, s, cs = tops.extract_roots_fused(words[:256], tda, block_b=128,
                                        with_checksum=True, device="cpu")
    np.testing.assert_array_equal(
        cs.numpy(), tops.tile_checksum_host(r.numpy(), s.numpy(),
                                            block_b=128))
    with pytest.raises(ValueError, match="multiple of block_b"):
        tops.extract_roots_fused(words[:200], tda, block_b=128,
                                 with_checksum=True, device="cpu")


def test_from_numpy_round_trip(dicts):
    da, tda = dicts
    for want, got, t in zip((da.tri, da.quad, da.bi), tda.numpy(),
                            (tda.tri, tda.quad, tda.bi)):
        assert t.dtype == torch.int32 and t.device.type == "cpu"
        np.testing.assert_array_equal(got, np.asarray(want))
    with pytest.raises(ValueError, match="1-D"):
        tstemmer.RootDictArrays.from_numpy(np.zeros((2, 2)), [1], [1],
                                           device="cpu")


def test_streamed_residency_is_not_ported(dicts, words):
    """Streamed residency, and "auto" past MAX_RESIDENT_KEYS, give the
    reference's roots; "resident" past the budget still raises."""
    da, tda = dicts
    want_r, want_s = rstemmer.extract_roots(jnp.asarray(words[:300]), da,
                                            backend="sorted")
    got_r, got_s = tops.extract_roots_fused(words[:300], tda,
                                            residency="streamed",
                                            device="cpu")
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    big = tcorpus.grow_root_arrays(tda, 70_000)
    big_ref = rcorpus.grow_root_arrays(da, 70_000)
    assert tsf.choose_residency(big) == "streamed"
    want_r, want_s = rstemmer.extract_roots(jnp.asarray(words[:300]), big_ref,
                                            backend="sorted")
    got_r, got_s = tops.extract_roots_fused(words[:300], big, device="cpu")
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    with pytest.raises(ValueError, match="too large"):
        tops.extract_roots_fused(words[:8], big, residency="resident",
                                 device="cpu")


def test_cuda_wrapper_refuses_cpu_tensors(dicts, words):
    _, tda = dicts
    tables = tsf.padded_tables(tda, match="bsearch", infix=True)
    with pytest.raises(ValueError, match="CUDA"):
        tsf.stem_fused_cuda(torch.from_numpy(words[:4]), tables, n_groups=5,
                            match="bsearch", block_b=128)


# launch sizes (words) at which the resident kernels' rule picks each of
# 8, 4, 2 and 1 lanes a word on an H100's 132 SMs
LANE_SIZES = (4096, 8192, 16384, 65536)


@pytest.mark.cuda
@pytest.mark.parametrize("match", ["bsearch", "bank"])
@pytest.mark.parametrize("infix", [True, False])
def test_kernel_matches_plain_on_card(dicts, words, infix, match):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    _, tda = dicts
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    big = next(tcorpus.stream_corpus_words(max(LANE_SIZES), seed=4,
                                           chunk_words=max(LANE_SIZES)))
    n_groups = 5 if infix else 2
    seen = set()
    for arrays in (tda.to("cuda"),
                   tcorpus.grow_root_arrays(tda.to("cuda"), 60_000)):
        tables = tsf.padded_tables(arrays, match=match, infix=infix)
        # the fixture's rows and launches whose sizes reach every G the
        # launcher picks; lanes and blocks as the g++ build of the rule
        # and walk gives them for this card
        for w_np in (words, *(big.words[:n] for n in LANE_SIZES)):
            w = torch.from_numpy(w_np).cuda()
            n = w.shape[0]
            want_r, want_s = tsf.stem_fused_plain(
                w, tables, n_groups=n_groups, match=match, block_b=256)
            for block_b in (64, 256, 512, 2048):
                r, s = tsf.stem_fused_cuda(w, tables, n_groups=n_groups,
                                           match=match, block_b=block_b)
                torch.cuda.synchronize()
                assert torch.equal(r, want_r) and torch.equal(s, want_s)
                walk = build.host_resident_walk(n, 1, n, 1, sms=sms,
                                                persistent=False)
                assert (tsf.stem_fused_cuda.last_lanes,
                        tsf.stem_fused_cuda.last_grid) == (walk["lanes"],
                                                           walk["grid"])
                seen.add(walk["lanes"])
    assert seen == {1, 2, 4, 8}

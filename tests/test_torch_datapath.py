"""The port's standalone datapath (K6, repro_torch.kernels.stem_datapath)
against the JAX package's interpret-mode Pallas kernel: keys and valid
int32[B, 32], the 30 candidate slots and two zero pads, identical."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.core import corpus as rcorpus  # noqa: E402
from repro.kernels import stem_datapath as rsdp  # noqa: E402
from repro_torch.core import corpus as tcorpus  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import stem_datapath as tsdp  # noqa: E402


def _words(b: int) -> np.ndarray:
    w, _, _ = rcorpus.build_corpus(n_words=b, seed=b)
    return rcorpus.encode_corpus(w)


@pytest.mark.parametrize("block_b", [8, 32, 256])
@pytest.mark.parametrize("b", [1, 7, 64, 256, 500])
def test_plain_matches_pallas(b, block_b):
    enc = _words(b)
    want_k, want_v = rsdp.stem_datapath_pallas(jnp.asarray(enc),
                                               block_b=block_b,
                                               interpret=True)
    got_k, got_v = tsdp.stem_datapath(torch.from_numpy(enc), block_b=block_b)
    assert got_k.dtype == got_v.dtype == torch.int32
    assert tuple(got_k.shape) == tuple(got_v.shape) == (b, tsdp.N_OUT)
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert not got_k[:, 30:].any() and not got_v[:, 30:].any()


@pytest.fixture(scope="module")
def mixed_reference():
    """Corpus words, codes outside the alphabet (every position filled in
    two rows of three) and all-pad rows, through the reference's Pallas
    kernel once: (words, (keys, valid))."""
    rng = np.random.default_rng(5)
    garbage = rng.integers(-3, 70, size=(300, 16)).astype(np.int32)
    garbage[::3, 10:] = 0
    enc = np.concatenate([_words(128), garbage,
                          np.zeros((8, 16), np.int32)])
    want = rsdp.stem_datapath_pallas(jnp.asarray(enc), block_b=64,
                                     interpret=True)
    return enc, tuple(np.asarray(x) for x in want)


def test_garbage_codes_match_pallas(mixed_reference):
    """Codes outside the alphabet (and every position filled) still give
    the reference's keys and flags."""
    enc, want = mixed_reference
    got = tsdp.stem_datapath(torch.from_numpy(enc), block_b=64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("lanes", build.CANDIDATE_LANES)
def test_host_build_of_lane_split_matches_pallas(mixed_reference, lanes):
    """The g++ build of K6's lane split (each word's G lanes in lane
    order, their position bits ORed, each writing only its 32 / G columns
    through lane_columns) gives the reference's rows bit for bit, pads
    included, on corpus words, garbage codes and all-pad rows."""
    enc, (want_k, want_v) = mixed_reference
    keys, valid = build.host_candidate_lanes(enc, lanes=lanes)
    np.testing.assert_array_equal(keys, want_k)
    np.testing.assert_array_equal(valid, want_v)


def test_lane_rule_picks():
    """K6's launcher takes 8 lanes a word at every size on a 132-SM card
    (a pipeline tick of 128 words, a served request of 4096, 16,896 and
    1M words): with the terms shared, 8 won at every shape timed on the
    card."""
    picks = {b: build.host_candidate_lanes_rule(b, sms=132)
             for b in (128, 4096, 16_896, 1 << 20)}
    assert picks == {128: 8, 4096: 8, 16_896: 8, 1 << 20: 8}
    with pytest.raises(ValueError, match="lanes"):
        build.host_candidate_lanes(np.zeros((1, 16), np.int32), lanes=3)


def test_rows_match_host_build_of_datapath_header():
    """The 30 slots the kernel stores are the g++ build of
    csrc/stem_datapath.cuh, the functions K6 and K1 both call."""
    enc = _words(500)
    keys, valid = tsdp.stem_datapath_plain(torch.from_numpy(enc))
    hk, hv = build.host_candidate_columns(enc)
    np.testing.assert_array_equal(keys[:, :30].numpy(), hk)
    np.testing.assert_array_equal(valid[:, :30].numpy(), hv)


def test_stem_candidates_entry_point():
    enc = _words(64)
    got = ops.stem_candidates(enc, block_b=32, device="cpu")
    want = tsdp.stem_datapath_plain(torch.from_numpy(enc), block_b=32)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    keys, valid = ops.stem_candidates(np.zeros((0, 16), np.int32),
                                      device="cpu")
    assert tuple(keys.shape) == tuple(valid.shape) == (0, 32)
    assert ops.dispatch_count() == 0


def test_guards():
    w = torch.zeros((4, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="block_b"):
        tsdp.stem_datapath(w, block_b=0)
    with pytest.raises(ValueError, match="CUDA"):
        tsdp.stem_datapath_cuda(w)
    assert tsdp.stem_datapath_cuda.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("block_b", [8, 32, 256, 1024])
def test_kernel_matches_plain_on_card(block_b):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for b in (1, 7, 64, 256, 500):
        w = torch.from_numpy(_words(b)).cuda()
        got = tsdp.stem_datapath_cuda(w, block_b=block_b)
        torch.cuda.synchronize()
        want = tsdp.stem_datapath_plain(w, block_b=block_b)
        assert all(torch.equal(g, x) for g, x in zip(got, want))


@pytest.mark.cuda
def test_kernel_at_one_million_words_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    n = 1 << 20
    w = torch.from_numpy(next(tcorpus.stream_corpus_words(
        n, seed=0, chunk_words=n)).words).cuda()
    before = tsdp.stem_datapath_cuda.launches
    got = tsdp.stem_datapath(w)
    torch.cuda.synchronize()
    assert tsdp.stem_datapath_cuda.launches == before + 1
    want = tsdp.stem_datapath_plain(w)
    assert all(torch.equal(g, x) for g, x in zip(got, want))


def _forced_launch(lib, w):
    """K6 through a measurement build that fixes its lanes a word, as the
    wrapper launches it; counted nowhere."""
    keys = torch.empty((w.shape[0], tsdp.N_OUT), dtype=torch.int32,
                       device=w.device)
    valid = torch.empty_like(keys)
    err = lib.stem_candidates_launch(
        w.data_ptr(), w.shape[0], keys.data_ptr(), valid.data_ptr(),
        torch.cuda.current_stream(w.device).cuda_stream)
    assert err == 0, lib.error_string(err)
    return keys, valid


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", build.CANDIDATE_LANES)
def test_forced_lanes_match_plain_on_card(lanes):
    """Each lane count, forced, and the rule's own pick, against the plain
    version on either side of a block's words."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    lib = build.forced_candidates_lanes_library(lanes)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b in (1, 127, 128, 4095, 4096):
        w = torch.from_numpy(_words(b)).cuda()
        want = tsdp.stem_datapath_plain(w)
        got = _forced_launch(lib, w)
        torch.cuda.synchronize()
        assert all(torch.equal(g, x) for g, x in zip(got, want)), (lanes, b)
        got = tsdp.stem_datapath_cuda(w)
        torch.cuda.synchronize()
        assert all(torch.equal(g, x) for g, x in zip(got, want)), b
        assert tsdp.stem_datapath_cuda.last_lanes == \
            build.host_candidate_lanes_rule(b, sms=sms)

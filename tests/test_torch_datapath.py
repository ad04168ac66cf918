"""The port's standalone datapath (K6, repro_torch.kernels.stem_datapath)
against the JAX package's interpret-mode Pallas kernel: keys and valid
int32[B, 32], the 30 candidate slots and two zero pads, identical."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

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


def test_garbage_codes_match_pallas():
    """Codes outside the alphabet (and every position filled) still give
    the reference's keys and flags."""
    rng = np.random.default_rng(5)
    enc = rng.integers(-3, 70, size=(300, 16)).astype(np.int32)
    enc[::3, 10:] = 0
    want = rsdp.stem_datapath_pallas(jnp.asarray(enc), block_b=64,
                                     interpret=True)
    got = tsdp.stem_datapath(torch.from_numpy(enc), block_b=64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


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

"""Flash attention in the port (kernels/flash_attention.py) against the
reference's Pallas kernel in interpret mode and its jnp oracle, over the
grid of tests/test_flash_attention.py plus head_dim 256 (gemma-2b).

Tolerances are the reference test's own: fp32 rtol = atol = 1e-5 (the
same fp32 arithmetic, summed in another order), bf16 2e-2 (a bf16 output
may round the other way, one bf16 step at |x| ~ 1 is 0.0078). The
``cuda``-marked tests hold K9 to its plain version on the card with the
same tolerances.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as kref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as ref_flash  # noqa: E402

from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOLS = {"float32": dict(rtol=1e-5, atol=1e-5),
        "bfloat16": dict(rtol=2e-2, atol=2e-2)}
GRID = [(128, 128, 128), (256, 128, 128), (256, 64, 128), (512, 128, 64)]


def _rand(b, h, t, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, t, d)).astype(np.float32) * 0.5
            for _ in range(3)]


def _both(arrays, dtype: str):
    """The same values for both packages: jnp arrays and torch tensors of
    ``dtype`` (bf16 rounded once, by jax, and carried across bit for bit)."""
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in jx]
    return jx, tx


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,block_q,block_k", GRID)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_reference(dtype, t, block_q, block_k, causal):
    (q, k, v), (tq, tk, tv) = _both(_rand(2, 3, t, 64), dtype)
    got = tfa.flash_attention(tq, tk, tv, causal=causal, block_q=block_q,
                              block_k=block_k, device="cpu")
    assert got.dtype == getattr(torch, dtype) and got.shape == tq.shape
    pallas = ref_flash(q, k, v, causal=causal, block_q=block_q,
                       block_k=block_k, interpret=True)
    oracle = kref.flash_attention_ref(q, k, v, causal=causal)
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(got), _np(want), **TOLS[dtype])


@pytest.mark.parametrize("d", [32, 64, 128, 256, 576])
def test_flash_head_dims(d):
    (q, k, v), (tq, tk, tv) = _both(_rand(1, 2, 128, d, seed=d), "float32")
    got = tfa.flash_attention(tq, tk, tv, device="cpu")
    for want in (ref_flash(q, k, v, interpret=True),
                 kref.flash_attention_ref(q, k, v)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_flash_causality():
    """Future tokens must not influence outputs."""
    q, k, v = (torch.from_numpy(a) for a in _rand(1, 1, 128, 32))
    out1 = tfa.flash_attention(q, k, v, device="cpu")
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 100:] = 99.0   # perturb only future keys
    v2[:, :, 100:] = 99.0
    out2 = tfa.flash_attention(q, k2, v2, device="cpu")
    np.testing.assert_allclose(out1[:, :, :100].numpy(),
                               out2[:, :, :100].numpy(), rtol=1e-6)


@pytest.mark.parametrize("shapes,blocks", [
    (((1, 2, 128, 32), (1, 2, 64, 32), (1, 2, 128, 32)), (128, 128)),
    (((1, 2, 128, 32), (1, 2, 128, 32), (1, 1, 128, 32)), (128, 128)),
    (((1, 2, 192, 32),) * 3, (128, 128)),
    (((1, 2, 256, 32),) * 3, (128, 96)),
])
def test_refuses_what_the_reference_asserts(shapes, blocks):
    arrays = [np.zeros(s, np.float32) for s in shapes]
    bq, bk = blocks
    with pytest.raises(AssertionError):
        ref_flash(*(jnp.asarray(a) for a in arrays), block_q=bq, block_k=bk,
                  interpret=True)
    with pytest.raises(ValueError):
        tfa.flash_attention(*(torch.from_numpy(a) for a in arrays),
                            block_q=bq, block_k=bk, device="cpu")


def test_blocks_clamp_to_t():
    """block_q/block_k above T clamp to T, as in the reference."""
    (q, k, v), (tq, tk, tv) = _both(_rand(1, 1, 64, 16), "float32")
    got = tfa.flash_attention(tq, tk, tv, block_q=128, block_k=256,
                              device="cpu")
    want = ref_flash(q, k, v, block_q=128, block_k=256, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_rule(dtype):
    """The instance depends on dtype and head_dim alone: the tensor cores
    take bf16 at 64, 128 and 256, the FMA instance every other case."""
    dt = getattr(torch, dtype)
    for d in range(16, 1025):
        want = "wgmma" if dtype == "bfloat16" and d in (64, 128, 256) \
            else "fma"
        assert tfa._instance(dt, d) == want, d


def _bf16_model(q, k, v, causal):
    """The tensor-core instance's numerics, from the plain version's steps:
    fp32 scores, max and sum over unrounded p, P rounded to bf16 for P V,
    the output rounded to bf16 once."""
    t, d = q.shape[2], q.shape[3]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (d ** -0.5)
    if causal:
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool))
        s = torch.where(mask, s, torch.full_like(s, tfa.NEG))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p.bfloat16().float(), v.float())
    return (out / l.clamp_min(1e-30)).to(q.dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,t,block_q,block_k",
                         [(64, *g) for g in GRID]
                         + [(128, 256, 128, 128), (256, 128, 128, 128)])
def test_bf16_p_rounding_within_tolerance(d, t, block_q, block_k, causal):
    """Rounding P to bf16 before P V (the wgmma instance) stays inside the
    2e-2 the bf16 checks hold, against the reference's Pallas kernel."""
    (q, k, v), (tq, tk, tv) = _both(_rand(1, 2, t, d, seed=t + d),
                                    "bfloat16")
    got = _bf16_model(tq, tk, tv, causal)
    want = ref_flash(q, k, v, causal=causal, block_q=block_q,
                     block_k=block_k, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **TOLS["bfloat16"])


def test_reset_zeroes_instance_counts():
    tfa.flash_attention_cuda.instances["wgmma"] += 3
    ops.reset_dispatch_count()
    assert tfa.flash_attention_cuda.instances == {"wgmma": 0, "fma": 0}


def test_k9_is_counted_and_refuses_cpu_tensors():
    assert tfa.flash_attention_cuda in ops.CUDA_WRAPPERS
    q = torch.zeros((1, 1, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_cuda(q, q, q)
    assert tfa.flash_attention_cuda.launches == 0


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    q = torch.zeros((1, 1, 8, 16))
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        tfa.flash_attention(q, q, q)


def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


# the grid above, head dims past 512 and shapes that are not multiples of
# the kernels' own tiles (128 query rows; 64 or 128 keys), among them the
# tensor-core head dims at ragged T
CARD_SHAPES = ([(2, 3, t, 64) for t, _, _ in GRID]
               + [(1, 2, 128, d) for d in (16, 32, 80, 128, 256, 512, 576)]
               + [(2, 2, 48, 16), (1, 3, 1, 128), (1, 1, 4097, 128)]
               + [(1, 2, t, d) for d in (64, 128, 256)
                  for t in (1, 200, 4097)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k9_matches_plain_on_card(dtype):
    _on_card()
    dt = getattr(torch, dtype)
    ops.reset_dispatch_count()
    want_inst = {"wgmma": 0, "fma": 0}
    for i, shape in enumerate(CARD_SHAPES):
        q, k, v = (torch.from_numpy(a).to("cuda", dt)
                   for a in _rand(*shape, seed=i))
        for causal in (True, False):
            got = tfa.flash_attention_cuda(q, k, v, causal=causal)
            torch.cuda.synchronize()
            want_inst[tfa._instance(dt, shape[3])] += 1
            want = tfa.flash_attention_plain(q, k, v, causal=causal)
            np.testing.assert_allclose(got.cpu().float().numpy(),
                                       want.cpu().float().numpy(),
                                       **TOLS[dtype])
    assert tfa.flash_attention_cuda.instances == want_inst
    if dtype == "bfloat16":
        assert want_inst["wgmma"] > 0 and want_inst["fma"] > 0


@pytest.mark.cuda
def test_wgmma_takes_unaligned_tensors():
    """TMA needs 16-byte aligned rows' base: a view two bytes in is copied
    by the wrapper, not refused, and still runs the tensor-core instance."""
    _on_card()
    shape = (1, 2, 200, 128)
    n = int(np.prod(shape))
    q, k, v = (torch.from_numpy(np.concatenate([[0.0], a.ravel()]))
               .to("cuda", torch.bfloat16)[1:].view(shape)
               for a in _rand(*shape, seed=7))
    assert q.data_ptr() % 16 and q.is_contiguous() and q.numel() == n
    ops.reset_dispatch_count()
    got = tfa.flash_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    assert tfa.flash_attention_cuda.instances == {"wgmma": 1, "fma": 0}
    want = tfa.flash_attention_plain(q, k, v)
    np.testing.assert_allclose(got.cpu().float().numpy(),
                               want.cpu().float().numpy(),
                               **TOLS["bfloat16"])


@pytest.mark.cuda
def test_instance_rule_matches_the_library():
    _on_card()
    from repro_torch.kernels import build

    lib = build.flash_attention_library()
    for dt in (torch.float32, torch.bfloat16):
        for d in range(1, 1025):
            got = lib.flash_attention_instance(d, int(dt == torch.bfloat16))
            assert ("wgmma" if got else "fma") == tfa._instance(dt, d), d


@pytest.mark.cuda
def test_k9_launches_are_counted_on_card():
    _on_card()
    ops.reset_dispatch_count()
    q, k, v = (torch.from_numpy(a).cuda() for a in _rand(1, 2, 128, 64))
    for n in (1, 2):
        tfa.flash_attention(q, k, v, device="cuda")
        assert tfa.flash_attention_cuda.launches == n
        assert ops.dispatch_count() == n
    torch.cuda.synchronize()

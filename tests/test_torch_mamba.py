"""The port's Mamba-1 and Hymba (repro_torch.models.mamba, scan_utils and
the Mamba and Hymba branches of blocks and model) against the
reference's (repro.models.mamba, scan_utils, blocks, model), on the CPU,
at the smoke configs of falcon-mamba-7b and hymba-1.5b (d 64, d_inner
128, N 8, dt_rank 8, ssm_chunk 16; Hymba's sliding window 32, 4 heads of
16 over 2 KV heads).

Inputs are made with numpy from a seed; the reference's parameters are
carried across with params_from_numpy. Tolerances:
  * associative_scan against jax.lax.associative_scan (the same odd/even
    recursion, so the same association): within 1e-6 of the largest
    |value| (SCAN_TOL);
  * fp32 compute: within 1e-4 of the largest |reference value|
    (FP32_TOL, tests/test_torch_models.py's): the same fp32 arithmetic,
    its products summed in another order;
  * bf16 compute: the norm of the difference within 6e-2 of the
    reference's (BF16_NORM_TOL, tests/test_torch_models.py's);
  * gradients (fp32): each leaf within 1e-4 of that leaf's largest |g|
    (GRAD_TOL, tests/test_torch_train.py's).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from repro import configs as rc  # noqa: E402
from repro.models import blocks as rb  # noqa: E402
from repro.models import mamba as rmamba  # noqa: E402
from repro.models import model as rm  # noqa: E402
from repro.models import params as rp  # noqa: E402
from repro.models import scan_utils as rsu  # noqa: E402

from repro_torch import configs as tc  # noqa: E402
from repro_torch.models import blocks as tb  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import params as tp  # noqa: E402
from repro_torch.models import scan_utils as tsu  # noqa: E402

ARCHS = ["falcon-mamba-7b", "hymba-1.5b"]
SCAN_TOL = 1e-6
FP32_TOL = 1e-4
BF16_NORM_TOL = 6e-2
GRAD_TOL = 1e-4
DTYPES = ["float32", "bfloat16"]


def _cfgs(arch, dtype="float32", **kw):
    return (dataclasses.replace(rc.smoke_config(rc.get_config(arch)),
                                compute_dtype=dtype, **kw),
            dataclasses.replace(tc.smoke_config(tc.get_config(arch)),
                                compute_dtype=dtype, **kw))


@functools.lru_cache(maxsize=None)
def _params(arch, seed=0):
    """The reference's model parameters and the port's copy (the tests
    only read them)."""
    rcfg, _ = _cfgs(arch)
    p = rp.init_params(rm.model_spec(rcfg), jax.random.key(seed))
    return p, tp.params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")


def _layer0(arch):
    p, pt = _params(arch)
    return (jax.tree.map(lambda x: x[0], p["blocks"]),
            tp.tree_map(lambda x: x[0], pt["blocks"]))


def _x(shape, dtype, seed=0, scale=1.0):
    """The same values in both packages, rounded to dtype once."""
    a = np.random.default_rng(seed).normal(size=shape).astype(
        np.float32) * scale
    j = jnp.asarray(a).astype(getattr(jnp, dtype))
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype="float32", tol=FP32_TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    if dtype == "bfloat16":
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= BF16_NORM_TOL, err
    else:
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= tol * scale, (
            np.abs(got - want).max(), scale)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for part in tree for x in _leaves(part)]
    return [tree]


def _trees_close(got, want, dtype="float32"):
    a, b = _leaves(got), jax.tree.leaves(want)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert str(x.dtype).removeprefix("torch.") == str(y.dtype)
        _close(x, y, dtype)


# ---------------------------------------------------------------------------
# scan_utils
# ---------------------------------------------------------------------------
def _combine_j(left, right):
    return left[0] * right[0], left[1] * right[0] + right[1]


@functools.lru_cache(maxsize=None)
def _jax_assoc(axis):
    return jax.jit(lambda a, b: jax.lax.associative_scan(
        _combine_j, (a, b), axis=axis))


@pytest.mark.parametrize("t", [1, 2, 37, 256])
def test_associative_scan_matches_jax(t):
    """Mamba's combine over decays in (0.14, 1] and unit-normal inputs,
    along axis 1 of [2, T, 8, 4], jitted in the reference (XLA may fuse
    b * a + c into one multiply-add)."""
    rng = np.random.default_rng(t)
    a = rng.uniform(0.14, 1.0, (2, t, 8, 4)).astype(np.float32)
    b = rng.normal(size=(2, t, 8, 4)).astype(np.float32)
    want = _jax_assoc(1)(a, b)
    got = tsu.associative_scan(tmamba._combine,
                               (torch.from_numpy(a), torch.from_numpy(b)), 1)
    assert len(got) == 2
    for g, w in zip(got, want):
        _close(g, w, tol=SCAN_TOL)
    # the first element is the input's, the last the whole product
    assert torch.equal(got[0][:, 0], torch.from_numpy(a[:, 0]))
    np.testing.assert_allclose(got[0][:, -1].numpy(), a.prod(axis=1),
                               rtol=1e-5)


def test_scan_matches_lax_scan_and_keeps_the_empty_stack():
    """scan's carry and stacked outputs against jax.lax.scan, with
    ``unroll`` changing nothing; an empty stack gives the initial carry
    and outputs with a leading 0 (the reference's unrolled case)."""
    xs = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)

    def step_j(c, x):
        return c * 0.5 + x, {"y": c * x, "z": (x.sum(),)}

    def step_t(c, x):
        return c * 0.5 + x, {"y": c * x, "z": (x.sum(),)}

    c0 = np.ones(3, np.float32)
    want_c, want_y = jax.lax.scan(step_j, jnp.asarray(c0), jnp.asarray(xs))
    for unroll in (False, True):
        got_c, got_y = tsu.scan(step_t, torch.from_numpy(c0),
                                torch.from_numpy(xs), unroll=unroll)
        _close(got_c, want_c, tol=1e-7)
        _close(got_y["y"], want_y["y"], tol=1e-7)
        _close(got_y["z"][0], want_y["z"][0], tol=1e-7)
    want_c, want_y = rsu.scan(step_j, jnp.asarray(c0),
                              jnp.zeros((0, 3), jnp.float32), unroll=True)
    got_c, got_y = tsu.scan(step_t, torch.from_numpy(c0),
                            torch.zeros((0, 3)))
    assert torch.equal(got_c, torch.from_numpy(c0))
    assert tuple(got_y["y"].shape) == want_y["y"].shape == (0, 3)
    assert tuple(got_y["z"][0].shape) == want_y["z"][0].shape == (0,)


# ---------------------------------------------------------------------------
# mamba.py, piece by piece
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("history", [False, True])
def test_causal_conv(history, dtype):
    rcfg, tcfg = _cfgs(ARCHS[0], dtype)
    lp, lt = _layer0(ARCHS[0])
    dt_j, dt_t = getattr(jnp, dtype), getattr(torch, dtype)
    xj, xt = _x((2, 9, rcfg.d_inner), dtype, seed=1)
    hj = ht = None
    if history:
        hj, ht = _x((2, rcfg.d_conv - 1, rcfg.d_inner), dtype, seed=2)
    want, want_h = rmamba._causal_conv(lp["mamba"], xj, rcfg, dt_j, hj)
    got, got_h = tmamba._causal_conv(lt["mamba"], xt, tcfg, dt_t, ht)
    assert got.dtype == dt_t and got_h.dtype == dt_t
    # the taps summed in the reference's order: equal in fp32, within a
    # bf16 step in bf16
    _close(got, want, dtype)
    assert np.array_equal(_np(got_h), _np(want_h))


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_inputs(dtype):
    rcfg, tcfg = _cfgs(ARCHS[0], dtype)
    lp, lt = _layer0(ARCHS[0])
    xj, xt = _x((2, 9, rcfg.d_inner), dtype, seed=3)
    want = rmamba._ssm_inputs(lp["mamba"], xj, rcfg, getattr(jnp, dtype))
    got = tmamba._ssm_inputs(lt["mamba"], xt, tcfg, getattr(torch, dtype))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, dtype)
    # softplus is jax.nn.softplus, on both sides of 0 and far out
    v = np.array([-90.0, -20.0, -1.5, -1e-3, 0.0, 1e-3, 2.0, 20.0, 90.0],
                 np.float32)
    _close(tmamba.softplus(torch.from_numpy(v)), jax.nn.softplus(v),
           tol=1e-7)


@pytest.mark.parametrize("t,chunk", [(32, 16), (48, 16), (37, 37)])
def test_scan_chunks(t, chunk):
    """Chunks scanned in order carrying the state (two and three chunks),
    and the single chunk of a T that ssm_chunk does not divide
    (mamba_block falls back to chunk = T; test_mamba_block runs it)."""
    rng = np.random.default_rng(t)
    a = rng.uniform(0.14, 1.0, (2, t, 8, 4)).astype(np.float32)
    bx = rng.normal(size=(2, t, 8, 4)).astype(np.float32)
    h0 = rng.normal(size=(2, 8, 4)).astype(np.float32)
    want_all, want_last = jax.jit(rmamba._scan_chunks, static_argnums=3)(
        a, bx, h0, chunk)
    got_all, got_last = tmamba._scan_chunks(
        torch.from_numpy(a), torch.from_numpy(bx), torch.from_numpy(h0),
        chunk)
    _close(got_all, want_all, tol=SCAN_TOL)
    _close(got_last, want_last, tol=SCAN_TOL)
    assert torch.equal(got_last, got_all[:, -1])


@functools.lru_cache(maxsize=None)
def _jit_block(rcfg, mode):
    def fn(lp, h, cache, pos):
        return rb.block(lp, h, rcfg, mode=mode, cache=cache, pos=pos,
                        positions=jnp.arange(h.shape[1], dtype=jnp.int32),
                        dt=jnp.dtype(rcfg.compute_dtype))
    return jax.jit(fn)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cached", [False, True])
def test_mamba_block(cached, dtype):
    """The full-sequence block over 20 tokens (ssm_chunk 16 does not
    divide 20: one chunk of 20) and 32 (two chunks), from zeros or from a
    cache (conv history and state)."""
    rcfg, tcfg = _cfgs(ARCHS[0], dtype)
    lp, lt = _layer0(ARCHS[0])
    dt_j, dt_t = getattr(jnp, dtype), getattr(torch, dtype)
    cj = ct = None
    if cached:
        hj, ht = _x((2, rcfg.d_conv - 1, rcfg.d_inner), dtype, seed=5)
        sj, st = _x((2, rcfg.d_inner, rcfg.ssm_state), "float32", seed=6)
        cj, ct = rmamba.MambaCache(hj, sj), tmamba.MambaCache(ht, st)
    for t in (20, 32):
        xj, xt = _x((2, t, rcfg.d_model), dtype, seed=t)
        want, wc = jax.jit(functools.partial(
            rmamba.mamba_block, cfg=rcfg, dt=dt_j))(lp["mamba"], xj,
                                                    cache=cj)
        got, gc = tmamba.mamba_block(lt["mamba"], xt, tcfg, dt=dt_t,
                                     cache=ct)
        assert got.dtype == dt_t and gc.ssm.dtype == torch.float32
        _close(got, want, dtype)
        _trees_close(gc, wc, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_decode(dtype):
    """Eight decode steps from a nonzero cache, each step's output and
    cache; the cache passed in is left as it was."""
    rcfg, tcfg = _cfgs(ARCHS[0], dtype)
    lp, lt = _layer0(ARCHS[0])
    dt_j, dt_t = getattr(jnp, dtype), getattr(torch, dtype)
    hj, ht = _x((2, rcfg.d_conv - 1, rcfg.d_inner), dtype, seed=7)
    sj, st = _x((2, rcfg.d_inner, rcfg.ssm_state), "float32", seed=8)
    cj, ct = rmamba.MambaCache(hj, sj), tmamba.MambaCache(ht, st)
    before = tp.tree_map(torch.clone, ct)
    step = jax.jit(functools.partial(rmamba.mamba_decode, cfg=rcfg, dt=dt_j))
    for i in range(8):
        xj, xt = _x((2, 1, rcfg.d_model), dtype, seed=20 + i)
        want, cj = step(lp["mamba"], xj, cache=cj)
        got, new = tmamba.mamba_decode(lt["mamba"], xt, tcfg, ct, dt=dt_t)
        if i == 0:
            assert all(torch.equal(a, b) for a, b in zip(ct, before))
        ct = new
        _close(got, want, dtype)
        _trees_close(ct, cj, dtype)


def _ring(x, t: int, axis: int):
    """A prefill cache of the last W of t positions (position t - W + j at
    index j) laid out as the decode ring wants it, position p at slot p %
    W: rolled by t % W along the sequence axis."""
    w = x.shape[axis]
    return np.roll(np.asarray(x), t % w, axis=axis) if t > w else np.asarray(
        x)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["full", "prefill", "decode"])
def test_hymba_block(mode, dtype):
    """One Hymba block (attention over a 32-token window and Mamba heads
    in parallel, each normed, averaged, then the FFN) over 40 tokens, past
    the window: the prefill's ring cache keeps the last 32 positions;
    decode takes it (rolled to the ring's layout) at position 40."""
    rcfg, tcfg = _cfgs(ARCHS[1], dtype)
    lp, lt = _layer0(ARCHS[1])
    t = 40
    assert rcfg.sliding_window < t
    xj, xt = _x((2, t, rcfg.d_model), dtype, seed=11)
    fn = _jit_block(rcfg, "decode" if mode == "decode" else mode)
    positions = torch.arange(t, dtype=torch.int32)
    if mode != "decode":
        want, wc, _ = fn(lp, xj, rb.BlockCache(), None)
        got, gc, aux = tb.block(lt, xt, tcfg, mode=mode, positions=positions,
                                dt=getattr(torch, dtype))
        _close(got, want, dtype)
        assert float(aux) == 0.0
        if mode == "full":
            assert gc == tb.BlockCache() and wc == rb.BlockCache((), ())
            return
        assert gc.kv.k.shape[1] == rcfg.sliding_window
        _trees_close(gc, wc, dtype)
        return
    _, wc, _ = _jit_block(rcfg, "prefill")(lp, xj, rb.BlockCache(), None)
    ring = rb.BlockCache(
        kv=type(wc.kv)(*(jnp.asarray(_ring(x, t, 1)) for x in wc.kv)),
        ssm=wc.ssm)
    ct = tp.params_from_numpy(jax.tree.map(np.asarray, ring), device="cpu")
    yj, yt = _x((2, 1, rcfg.d_model), dtype, seed=12)
    want, wnew, _ = fn(lp, yj, ring, jnp.int32(t))
    got, gnew, _ = tb.block(lt, yt, tcfg, mode="decode", cache=ct, pos=t,
                            dt=getattr(torch, dtype))
    _close(got, want, dtype)
    _trees_close(gnew, wnew, dtype)


# ---------------------------------------------------------------------------
# the models: forward, loss, gradients, prefill then decode
# ---------------------------------------------------------------------------
def _tokens(cfg, b=2, t=32, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, t)).astype(
        np.int32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_full_and_prefill(arch, dtype):
    """Logits (and the prefill's caches: Hymba's attention ring and both
    families' conv history and state, stacked on [L, ...]) over 40
    tokens, past Hymba's window and two and a half Mamba chunks (one chunk
    of 40)."""
    rcfg, tcfg = _cfgs(arch, dtype)
    p, pt = _params(arch)
    toks = _tokens(rcfg, t=40)
    for mode in ("full", "prefill"):
        want = rm.forward(p, rcfg, jnp.asarray(toks), mode=mode)
        got = tm.forward(pt, tcfg, torch.from_numpy(toks), mode=mode)
        _close(got.logits, want.logits, dtype)
        assert float(got.aux_loss) == 0.0
        if mode == "full":
            assert got.caches == ()
        else:
            assert sorted(got.caches) == ["blocks"]
            _trees_close(got.caches, want.caches, dtype)


_ref_grads = jax.jit(jax.value_and_grad(
    lambda p, cfg, batch: rm.loss_fn(p, cfg, batch)), static_argnums=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads(arch):
    """fp32: the loss (1e-5 relative) and each gradient leaf, over T 32
    with masked labels; the three remat policies give identical gradients
    in the port."""
    rcfg, tcfg = _cfgs(arch)
    p, pt = _params(arch)
    rng = np.random.default_rng(1)
    batch = {"tokens": _tokens(rcfg, seed=1),
             "labels": _tokens(rcfg, seed=2)}
    batch["labels"][rng.random(batch["labels"].shape) < 0.1] = -1
    want_l, want_g = _ref_grads(p, rcfg, batch)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    runs = []
    for policy in (None, tm.nothing_saveable,
                   tm.dots_with_no_batch_dims_saveable):
        live = tp.tree_map(lambda x: x.clone().requires_grad_(), pt)
        loss = tm.loss_fn(live, tcfg, tbatch, remat_policy=policy)
        runs.append((loss, torch.autograd.grad(loss, tp.tree_leaves(live))))
    loss, grads = runs[0]
    loss = float(loss.detach())
    assert abs(loss - float(want_l)) <= 1e-5 * abs(float(want_l))
    want_g = jax.tree.leaves(want_g)
    assert len(grads) == len(want_g)
    for g, w in zip(grads, want_g):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert np.abs(g.numpy() - w).max() <= GRAD_TOL * np.abs(w).max()
    for loss_i, grads_i in runs[1:]:
        assert float(loss_i.detach()) == loss
        assert all(torch.equal(a, b) for a, b in zip(grads_i, grads))


@functools.lru_cache(maxsize=None)
def _jit_decode(rcfg):
    return jax.jit(lambda p, t, c, pos: rm.decode_step(p, rcfg, t, c, pos))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_forward(arch):
    """fp32: prefill 40 tokens (past Hymba's 32-token window), its caches
    put into decode caches (the attention ring rolled to position p at
    slot p % W), then 6 teacher-forced decode steps in both packages:
    every step's logits against the reference's decode and against the
    port's own full forward at that position (the reference's
    test_mamba_decode_matches_forward, at FP32_TOL)."""
    rcfg, tcfg = _cfgs(arch)
    p, pt = _params(arch)
    t, n = 40, 6
    toks = _tokens(rcfg, t=t + n, seed=4)
    pre_r = rm.forward(p, rcfg, jnp.asarray(toks[:, :t]), mode="prefill")
    pre_t = tm.forward(pt, tcfg, torch.from_numpy(toks[:, :t]),
                       mode="prefill")
    full = tm.forward(pt, tcfg, torch.from_numpy(toks)).logits
    cl = t + n
    cr = rm.init_caches(rcfg, 2, cl, dt=jnp.float32)
    ct = tm.init_caches(tcfg, 2, cl, dt=torch.float32, device="cpu")

    # the SSM leaves are whole; the attention's go to the leading
    # positions, or to the ring rolled to its layout past the window
    def splice_r(dst, src):
        if dst.shape == src.shape:
            return jnp.asarray(_ring(src, t, 2))
        return jax.lax.dynamic_update_slice_in_dim(dst, src, 0, axis=2)

    def splice_t(dst, src):
        if dst.shape == src.shape:
            dst.copy_(torch.from_numpy(_ring(src, t, 2)))
        else:
            dst[:, :, :src.shape[2]].copy_(src)

    cr = {"blocks": rb.BlockCache(
        kv=jax.tree.map(splice_r, cr["blocks"].kv, pre_r.caches["blocks"].kv),
        ssm=pre_r.caches["blocks"].ssm)}
    tp.tree_map(splice_t, ct["blocks"].kv, pre_t.caches["blocks"].kv)
    tp.tree_map(lambda d, s: d.copy_(s), ct["blocks"].ssm,
                pre_t.caches["blocks"].ssm)
    if arch == "hymba-1.5b":
        assert ct["blocks"].kv.k.shape[2] == rcfg.sliding_window
    step = _jit_decode(rcfg)
    for i in range(n):
        tok = toks[:, t + i:t + i + 1]
        lr, cr = step(p, jnp.asarray(tok), cr, jnp.int32(t + i))
        lt, ct = tm.decode_step(pt, tcfg, torch.from_numpy(tok), ct, t + i)
        _close(lt, lr)
        _close(lt[:, 0], full[:, t + i])
    _trees_close(ct, cr)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_zero_caches(arch, dtype):
    """Ten decode steps from init_caches (bf16 conv history by default,
    as the reference's; fp32 caches at fp32 compute), every step's logits
    and the last caches."""
    rcfg, tcfg = _cfgs(arch, dtype)
    p, pt = _params(arch)
    toks = _tokens(rcfg, t=10, seed=5)
    cr = rm.init_caches(rcfg, 2, 16, dt=getattr(jnp, dtype))
    ct = tm.init_caches(tcfg, 2, 16, dt=getattr(torch, dtype), device="cpu")
    assert ct["blocks"].ssm.ssm.dtype == torch.float32
    step = _jit_decode(rcfg)
    for i in range(toks.shape[1]):
        tok = toks[:, i:i + 1]
        lr, cr = step(p, jnp.asarray(tok), cr, jnp.int32(i))
        lt, ct = tm.decode_step(pt, tcfg, torch.from_numpy(tok), ct, i)
        _close(lt, lr, dtype)
    _trees_close(ct, cr, dtype)


def test_init_cache_and_caches_are_the_references():
    """mamba.init_cache and init_caches' SSM leaves: shapes and dtypes as
    the reference's, the state fp32 whatever dt."""
    rcfg, tcfg = _cfgs(ARCHS[1])
    want = rmamba.init_cache(rcfg, 3)
    got = tmamba.init_cache(tcfg, 3, device="cpu")
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
    want = rm.init_caches(rcfg, 3, 50)
    got = tm.init_caches(tcfg, 3, 50, device="cpu")
    a, b = _leaves(got), jax.tree.leaves(want)
    assert [tuple(x.shape) for x in a] == [x.shape for x in b]
    assert [str(x.dtype).removeprefix("torch.") for x in a] == [
        str(x.dtype) for x in b]
    assert all(torch.count_nonzero(x) == 0 for x in a)

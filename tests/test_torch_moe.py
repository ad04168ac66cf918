"""The port's MoE FFN (repro_torch.models.moe) against the reference's
(repro.models.moe), on the CPU, at the smoke configs of the two MoE
architectures (d 64, 4 experts top-2; deepseek-v2-lite-16b with one
shared expert, qwen3-moe-235b-a22b with none).

Inputs are made with numpy from a seed; the reference's parameters are
carried across with params_from_numpy. ``moe_ffn`` is one function in the
reference, so its steps are held to the reference's own lines, copied
below as ``_ref_*`` (repro/models/moe.py:57-91), and the copies composed
are checked to be the reference's moe_ffn bit for bit. Tolerances:
  * routing: the chosen experts identical on every token whose k-th and
    (k+1)-th probabilities differ by more than 1e-5 (a product one ulp
    apart may flip a closer pair; the tokens it excuses are counted and
    printed), their probabilities within 1e-6;
  * slots (rank, keep, destination), the dispatch buffer and the combine:
    bit-identical, given the reference's routing and expert outputs;
  * moe_ffn: fp32 within 1e-4 of the largest |output|, bf16 a norm within
    6e-2 (the files' FP32_TOL and BF16_NORM_TOL), the aux loss within
    1e-5 relative;
  * gradients (fp32): each leaf within 1e-4 of that leaf's largest |g|.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from repro import configs as rc  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro.models import params as rp  # noqa: E402

from repro_torch import configs as tc  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import params as tp  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["deepseek-v2-lite-16b", "qwen3-moe-235b-a22b"]
FP32_TOL = 1e-4
BF16_NORM_TOL = 6e-2
MARGIN = 1e-5
PROB_TOL = 1e-6
AUX_RTOL = 1e-5
GRAD_TOL = 1e-4
# the drop case: capacity_factor 0.25 at 256 tokens gives a capacity of
# 128 against an average load of 256 * 2 / 4 = 128 an expert
DROP_CF = 0.25
TOKENS = (2, 128)


def _cfgs(arch, dtype="float32", **kw):
    return (dataclasses.replace(rc.smoke_config(rc.get_config(arch)),
                                compute_dtype=dtype, **kw),
            dataclasses.replace(tc.smoke_config(tc.get_config(arch)),
                                compute_dtype=dtype, **kw))


@functools.lru_cache(maxsize=None)
def _params(arch, seed=0):
    """The reference's MoE parameters and the port's copy. The router is
    drawn at 5x its init (std 0.1): at d 64 the init's logits (std about
    0.16) route nearly uniformly, and loads, and so drops, would hardly
    differ between experts."""
    rcfg, _ = _cfgs(arch)
    p = rp.init_params(rmoe.moe_spec(rcfg), jax.random.key(seed))
    p["router"] = p["router"] * 5.0
    return p, tp.params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")


def _x(dtype, seed=0, shape=TOKENS + (64,)):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    xj = jnp.asarray(a).astype(getattr(jnp, dtype))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return xj, xt


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# the reference's lines (repro/models/moe.py), step by step
# ---------------------------------------------------------------------------
def _ref_routing(p, xf, cfg):                          # moe.py:57-64
    logits = (xf @ p["router"].astype(jnp.float32)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    top_p, top_e = jax.lax.top_k(probs, cfg.top_k)
    top_p = top_p / jnp.clip(top_p.sum(-1, keepdims=True), 1e-9)
    return probs, top_p, top_e


def _ref_slots(top_e, cap, e):                         # moe.py:67-71
    flat_e = top_e.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    pos = ((jnp.cumsum(onehot, axis=0) - 1) * onehot).sum(-1)
    keep = pos < cap
    dest = jnp.where(keep, flat_e * cap + pos, e * cap)
    return pos, keep, dest


def _ref_dispatch(xf, dest, cap, cfg, dt):             # moe.py:74-77
    n_tok, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    tok_idx = jnp.repeat(jnp.arange(n_tok), k)
    buf = jnp.zeros((e * cap + 1, d), dt)
    buf = buf.at[dest].add(xf[tok_idx].astype(dt), mode="drop")
    return buf[: e * cap].reshape(e, cap, d)


def _ref_experts(p, xe, dt):                           # moe.py:81-83
    h = jnp.einsum("ecd,edf->ecf", xe, p["wi"].astype(dt))
    g = jnp.einsum("ecd,edf->ecf", xe, p["wg"].astype(dt))
    return jnp.einsum("ecf,efd->ecd", jax.nn.silu(g) * h, p["wo"].astype(dt))


def _ref_combine(ye, dest, keep, top_p, dt):          # moe.py:87-91
    e, cap, d = ye.shape
    n_tok, k = top_p.shape
    tok_idx = jnp.repeat(jnp.arange(n_tok), k)
    yf = ye.reshape(e * cap, d)
    gathered = jnp.where(keep[:, None], yf[jnp.clip(dest, 0, e * cap - 1)],
                         0.0)
    weighted = gathered * top_p.reshape(-1)[:, None].astype(dt)
    return jnp.zeros((n_tok, d), dt).at[tok_idx].add(weighted)


@functools.lru_cache(maxsize=None)
def _ref_steps(rcfg):
    """The copied steps, jitted as the reference runs them, and the
    reference's own moe_ffn (each under jax.jit)."""
    dt = jnp.dtype(rcfg.compute_dtype)

    def route(p, x):
        return _ref_routing(p, x.reshape(-1, x.shape[-1]), rcfg)

    def slot(top_e, cap):
        return _ref_slots(top_e, cap, rcfg.n_experts)

    def dispatch(x, dest, cap):
        return _ref_dispatch(x.reshape(-1, x.shape[-1]), dest, cap, rcfg, dt)

    def composed(p, x):
        b, t, d = x.shape
        xf = x.reshape(b * t, d)
        cap = rmoe._capacity(b * t, rcfg)
        _, top_p, top_e = _ref_routing(p, xf, rcfg)
        _, keep, dest = _ref_slots(top_e, cap, rcfg.n_experts)
        ye = _ref_experts(p, _ref_dispatch(xf, dest, cap, rcfg, dt), dt)
        y = _ref_combine(ye, dest, keep, top_p, dt)
        if "shared" in p:
            sh = p["shared"]
            hs = xf.astype(dt) @ sh["wi"].astype(dt)
            gs = xf.astype(dt) @ sh["wg"].astype(dt)
            y = y + (jax.nn.silu(gs) * hs) @ sh["wo"].astype(dt)
        return y.reshape(b, t, d)

    return dict(
        route=jax.jit(route), slot=jax.jit(slot, static_argnums=1),
        dispatch=jax.jit(dispatch, static_argnums=2),
        combine=jax.jit(lambda ye, dest, keep, top_p: _ref_combine(
            ye, dest, keep, top_p, dt)),
        composed=jax.jit(composed),
        moe_ffn=jax.jit(lambda p, x: rmoe.moe_ffn(p, x, rcfg, dt=dt)))


def _margins(probs, k):
    """Each token's gap between its k-th and (k+1)-th probability."""
    s = np.sort(np.asarray(probs), axis=-1)[:, ::-1]
    return s[:, k - 1] - s[:, k]


def _case(arch, dtype, drops):
    kw = {"capacity_factor": DROP_CF} if drops else {}
    return _cfgs(arch, dtype, **kw)


# ---------------------------------------------------------------------------
# the copies are the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_copied_steps_compose_to_the_reference(arch, dtype):
    rcfg, _ = _cfgs(arch, dtype)
    p, _ = _params(arch)
    xj, _ = _x(dtype)
    steps = _ref_steps(rcfg)
    got = np.asarray(steps["composed"](p, xj).astype(jnp.float32))
    want, _ = steps["moe_ffn"](p, xj)
    assert np.array_equal(got, np.asarray(want.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_routing_matches_reference(arch, dtype):
    rcfg, tcfg = _cfgs(arch, dtype)
    p, pt = _params(arch)
    xj, xt = _x(dtype, seed=1)
    probs_r, top_p_r, top_e_r = _ref_routing_np(rcfg, p, xj)
    r = tmoe.routing(pt, xt.reshape(-1, xt.shape[-1]), tcfg)
    k = tcfg.top_k
    clear = _margins(probs_r, k) > MARGIN
    print(f"{arch} {dtype}: {int((~clear).sum())} of {clear.size} tokens"
          f" within {MARGIN} of a tie at the k-th expert (excused)")
    np.testing.assert_allclose(_np(r.probs), probs_r, rtol=0, atol=PROB_TOL)
    got_e, got_p = r.top_e.numpy(), _np(r.top_p)
    # a token's experts as a set (their order within the token moves no
    # slot: an expert appears once a token), probabilities by expert
    for i in np.flatnonzero(clear):
        o, q = np.argsort(got_e[i]), np.argsort(top_e_r[i])
        assert np.array_equal(got_e[i][o], top_e_r[i][q]), i
        np.testing.assert_allclose(got_p[i][o], top_p_r[i][q], rtol=0,
                                   atol=PROB_TOL)
    # the Switch loss, against the reference's moe_ffn
    _, aux_r = _ref_steps(rcfg)["moe_ffn"](p, xj)
    assert abs(float(r.aux) - float(aux_r)) <= AUX_RTOL * float(aux_r)
    assert r.top_e.dtype == torch.int64 and r.probs.dtype == torch.float32


def _ref_routing_np(rcfg, p, xj):
    probs, top_p, top_e = _ref_steps(rcfg)["route"](p, xj)
    return np.array(probs), np.array(top_p), np.array(top_e)


def test_capacity_is_the_references():
    for arch in ARCHS:
        for cfg_r, cfg_t in (_cfgs(arch), (rc.get_config(arch),
                                           tc.get_config(arch))):
            for n in (1, 4, 7, 32, 64, 256, 4096, 8191):
                assert tmoe._capacity(n, cfg_t) == rmoe._capacity(n, cfg_r)
    assert tmoe._capacity(32, tc.get_config(ARCHS[0])) == 128
    assert tmoe._capacity(4, tc.get_config(ARCHS[0])) == 6   # top_k


# ---------------------------------------------------------------------------
# slots, dispatch and combine: bit-identical given the reference's routing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("drops", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_slots_are_the_references(arch, drops):
    rcfg, tcfg = _case(arch, "float32", drops)
    p, _ = _params(arch)
    xj, _ = _x("float32", seed=2)
    _, _, top_e = _ref_routing_np(rcfg, p, xj)
    n_tok = top_e.shape[0]
    cap = rmoe._capacity(n_tok, rcfg)
    pos, keep, dest = (np.asarray(a) for a in _ref_steps(rcfg)["slot"](
        jnp.asarray(top_e), cap))
    s = tmoe.slots(torch.from_numpy(top_e), cap, tcfg.n_experts)
    dropped = int((~keep).sum())
    print(f"{arch} drops={drops}: cap {cap}, {dropped} of {keep.size}"
          " assignments dropped")
    if drops:
        assert cap == 128 and dropped > 0
    else:
        assert dropped == 0
    assert np.array_equal(s.pos.numpy(), pos)
    assert np.array_equal(s.keep.numpy(), keep)
    assert np.array_equal(s.dest.numpy(), dest)


@pytest.mark.parametrize("drops", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_and_combine_are_the_references(arch, dtype, drops):
    """The experts' buffer from the same tokens, and the combine of the
    same expert outputs, bit for bit."""
    rcfg, tcfg = _case(arch, dtype, drops)
    p, _ = _params(arch)
    xj, xt = _x(dtype, seed=3)
    _, top_p, top_e = _ref_routing_np(rcfg, p, xj)
    n_tok = top_e.shape[0]
    cap = rmoe._capacity(n_tok, rcfg)
    steps = _ref_steps(rcfg)
    _, keep, dest = steps["slot"](jnp.asarray(top_e), cap)
    s = tmoe.slots(torch.from_numpy(top_e), cap, tcfg.n_experts)
    dt = getattr(torch, dtype)
    want = steps["dispatch"](xj, dest, cap)
    got = tmoe.dispatch(xt.reshape(n_tok, -1), s, cap, tcfg, dt)
    assert got.dtype == dt and tuple(got.shape) == want.shape
    assert np.array_equal(_np(got), _np(want))
    ye = _x(dtype, seed=4, shape=(tcfg.n_experts, cap, tcfg.d_model))
    want = steps["combine"](ye[0], dest, keep, jnp.asarray(top_p))
    got = tmoe.combine(ye[1], s, torch.from_numpy(top_p), dt)
    assert got.dtype == dt
    assert np.array_equal(_np(got), _np(want))
    if drops:   # a token whose every assignment was dropped gets zeros
        lost = ~np.asarray(keep).reshape(n_tok, -1).any(-1)
        assert np.all(_np(got)[lost] == 0)


# ---------------------------------------------------------------------------
# the whole FFN and its gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("drops", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, dtype, drops):
    rcfg, tcfg = _case(arch, dtype, drops)
    p, pt = _params(arch)
    xj, xt = _x(dtype, seed=5)
    probs, _, _ = _ref_routing_np(rcfg, p, xj)
    assert (_margins(probs, tcfg.top_k) > MARGIN).all()
    want, aux_r = _ref_steps(rcfg)["moe_ffn"](p, xj)
    got, aux = tmoe.moe_ffn(pt, xt, tcfg, dt=getattr(torch, dtype))
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    if dtype == "float32":
        assert np.abs(got - want).max() <= FP32_TOL * np.abs(want).max()
    else:
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= BF16_NORM_TOL, err
    assert abs(float(aux) - float(aux_r)) <= AUX_RTOL * float(aux_r)


@pytest.mark.parametrize("drops", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_grads_match_reference(arch, drops):
    """d(sum(y * w) + aux) / d(x, every parameter) at fp32."""
    rcfg, tcfg = _case(arch, "float32", drops)
    p, pt = _params(arch)
    xj, xt = _x("float32", seed=6)
    w = np.random.default_rng(7).normal(size=xj.shape).astype(np.float32)

    def ref_loss(p, x):
        y, aux = rmoe.moe_ffn(p, x, rcfg, dt=jnp.float32)
        return jnp.sum(y * w) + aux

    want = jax.jit(jax.grad(ref_loss, argnums=(0, 1)))(p, xj)
    want = jax.tree.leaves(want[0]) + [want[1]]
    live = tp.tree_map(lambda x: x.clone().requires_grad_(), pt)
    x = xt.clone().requires_grad_()
    y, aux = tmoe.moe_ffn(live, x, tcfg, dt=torch.float32)
    loss = (y * torch.from_numpy(w)).sum() + aux
    got = torch.autograd.grad(loss, tp.tree_leaves(live) + [x])
    assert len(got) == len(want)
    for g, r in zip(got, want):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape
        scale = np.abs(r).max()
        assert scale > 0
        assert np.abs(g.numpy() - r).max() <= GRAD_TOL * scale


# ---------------------------------------------------------------------------
# what the dispatch runs: no scattered adds, nothing read on the host
# ---------------------------------------------------------------------------
class _Ops(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name.startswith("index_put"):
            acc = args[3] if len(args) > 3 else kwargs.get("accumulate", False)
            name += "(accumulate)" if acc else ""
        self.calls.append(name)
        return func(*args, **kwargs)


_SCATTER_ADDS = ("index_add", "index_add_", "scatter_add", "scatter_add_",
                 "scatter_reduce", "scatter_reduce_", "put_",
                 "index_put(accumulate)", "index_put_(accumulate)")
_HOST_READS = ("_local_scalar_dense", "nonzero", "masked_select",
               "masked_scatter", "masked_scatter_", "item")


@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_adds_nothing_by_index_and_reads_nothing_on_the_host(arch):
    """The forward pass has no scatter-add (index_add_, scatter_add,
    index_put with accumulate) and no host read (.item(), .nonzero(),
    masked_select); nor does the backward pass add by index: the
    buffer's writes, both ways, have gathers for backwards."""
    _, tcfg = _case(arch, "bfloat16", True)
    _, pt = _params(arch)
    _, xt = _x("bfloat16", seed=8)
    live = tp.tree_map(lambda x: x.clone().requires_grad_(), pt)
    with _Ops() as fwd:
        y, aux = tmoe.moe_ffn(live, xt, tcfg)
    assert "bmm" in fwd.calls and "topk" in fwd.calls
    bad = sorted(set(fwd.calls) & set(_SCATTER_ADDS + _HOST_READS))
    assert not bad, bad
    with _Ops() as bwd:
        torch.autograd.grad(y.float().sum() + aux, tp.tree_leaves(live))
    assert not set(bwd.calls) & set(_HOST_READS)
    assert not set(bwd.calls) & set(_SCATTER_ADDS)


def test_gradients_are_the_same_run_to_run():
    _, tcfg = _case(ARCHS[0], "bfloat16", True)
    _, pt = _params(ARCHS[0])
    _, xt = _x("bfloat16", seed=9)
    runs = []
    for _ in range(2):
        live = tp.tree_map(lambda x: x.clone().requires_grad_(), pt)
        y, aux = tmoe.moe_ffn(live, xt, tcfg)
        runs.append(torch.autograd.grad(y.float().sum() + aux,
                                        tp.tree_leaves(live)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# ---------------------------------------------------------------------------
# imports
# ---------------------------------------------------------------------------
_IMPORT = """
import sys
import repro_torch.models.moe, repro_torch.models.mla
import repro_torch.models.mamba, repro_torch.models.scan_utils
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("forbidden:", bad)
"""


def test_moe_and_mla_import_without_jax_or_repro():
    p = subprocess.run([sys.executable, "-c", _IMPORT], capture_output=True,
                       text=True, cwd=ROOT, timeout=120,
                       env={"PYTHONPATH": str(ROOT / "src"),
                            "PATH": os.environ.get("PATH", "/usr/bin:/bin")})
    assert p.returncode == 0, p.stderr
    assert "forbidden: []" in p.stdout

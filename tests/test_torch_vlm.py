"""The port's VLM backbone (repro_torch.models.attention.cross_attention,
blocks.cross_block, model._cross_kv and the grouped paths of forward,
decode_step and init_caches; serve.engine._merge_slot on the grouped
self-caches) against the reference's, on the CPU, at the smoke config of
llama-3.2-vision-11b (d 64, 2 groups of one cross block and one self
block, 16 vision positions, 4 heads of 16 over 2 KV heads). The vision
front end is a stand-in in both packages: embeddings [B, vision_seq,
d_model] drawn with numpy and rounded to bf16, as
tests/test_arch_smoke.py makes them.

The reference's parameters are carried across with params_from_numpy.
Tolerances, tests/test_torch_models.py's and tests/test_torch_train.py's:
  * fp32 compute within 1e-4 of the largest |reference value| (FP32_TOL);
  * bf16 compute a norm within 6e-2 of the reference's (BF16_NORM_TOL).
    The whole model's bf16 logits are held to the reference run in a
    process of its own with XLA's excess precision off
    (``--xla_allow_excess_precision=false``), which rounds every op's
    bf16 result as the port does. On by default, it lets XLA's CPU
    fusions keep bf16 intermediates in fp32, and that alone moves this
    model's logits by 3-13% of their norm (the random-init attention
    over the raw embeddings is nearly one-hot: the reference's own bf16
    logits lie 16-20% from its fp32 ones); the port equals the
    reference's blocks run one by one, and, with the flag off, its
    scanned forward and decode, to about 1e-6;
  * gradients (fp32) within 1e-4 of each leaf's largest |g| plus the
    reference's own rounding there, the distance of its fp32 gradients
    from its float64 run (as test_torch_train.py's T = 4096 case): the
    one-hot cross attention puts it at 1-2.5e-4 of a leaf's scale in
    both packages.
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

from repro import configs as rc  # noqa: E402
from repro.models import attention as ra  # noqa: E402
from repro.models import blocks as rb  # noqa: E402
from repro.models import layers as rl  # noqa: E402
from repro.models import model as rm  # noqa: E402
from repro.models import params as rp  # noqa: E402
from repro.serve import engine as reng  # noqa: E402

from repro_torch import configs as tc  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402
from repro_torch.models import blocks as tb  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import params as tp  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "llama-3.2-vision-11b"
FP32_TOL = 1e-4
BF16_NORM_TOL = 6e-2
GRAD_TOL = 1e-4
DTYPES = ["float32", "bfloat16"]


def _cfgs(dtype="float32", **kw):
    return (dataclasses.replace(rc.smoke_config(rc.get_config(ARCH)),
                                compute_dtype=dtype, **kw),
            dataclasses.replace(tc.smoke_config(tc.get_config(ARCH)),
                                compute_dtype=dtype, **kw))


@functools.lru_cache(maxsize=None)
def _params(seed=0, **kw):
    rcfg, _ = _cfgs(**kw)
    p = rp.init_params(rm.model_spec(rcfg), jax.random.key(seed))
    return p, tp.params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")


def _vision(cfg, b=2, seed=0):
    """bf16 embeddings in both packages (the same bits)."""
    a = np.random.default_rng(seed + 50).normal(
        size=(b, cfg.vision_seq, cfg.d_model)).astype(np.float32)
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16)


def _x(shape, dtype, seed=0):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    j = jnp.asarray(a).astype(getattr(jnp, dtype))
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))


def _tokens(cfg, b=2, t=32, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, t)).astype(
        np.int32)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype="float32"):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    if dtype == "bfloat16":
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= BF16_NORM_TOL, err
    else:
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= FP32_TOL * scale, (
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


_REF_STRICT = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro import configs as rc
from repro.models import model as rm, params as rp
src, out = sys.argv[1], sys.argv[2]
d = np.load(src)
base = rc.smoke_config(rc.get_config("llama-3.2-vision-11b"))
shape = jax.eval_shape(lambda: rp.init_params(rm.model_spec(base),
                                              jax.random.key(0)))
n = len(jax.tree.leaves(shape))
p = jax.tree.unflatten(jax.tree.structure(shape),
                       [jnp.asarray(d[f"p{i}"]) for i in range(n)])
f32, bf = jnp.float32, jnp.bfloat16
cfg = dataclasses.replace(base, compute_dtype="bfloat16")
res = {}
ve = jnp.asarray(d["fwd_vision"]).astype(bf)
toks = jnp.asarray(d["fwd_tokens"])
res["full"] = rm.forward(p, cfg, toks, vision_embeds=ve).logits.astype(f32)
pre = rm.forward(p, cfg, toks, vision_embeds=ve, mode="prefill")
res["prefill"] = pre.logits.astype(f32)
for i, x in enumerate(jax.tree.leaves(pre.caches)):
    res[f"prefill_cache{i}"] = x.astype(f32)
toks, t = d["dec_tokens"], int(d["dec_t"])
ve = jnp.asarray(d["dec_vision"]).astype(bf)
pre = rm.forward(p, cfg, jnp.asarray(toks[:, :t]), vision_embeds=ve,
                 mode="prefill")
c = rm.init_caches(cfg, toks.shape[0], toks.shape[1], dt=bf)
c = {"self": jax.tree.map(lambda a, b: jax.lax.dynamic_update_slice_in_dim(
    a, b, 0, axis=3), c["self"], pre.caches["self"]),
     "cross": pre.caches["cross"]}
step = jax.jit(lambda p, tk, c, pos: rm.decode_step(p, cfg, tk, c, pos))
for i in range(t, toks.shape[1]):
    logits, c = step(p, jnp.asarray(toks[:, i:i + 1]), c, jnp.int32(i))
    res[f"decode{i - t}"] = logits.astype(f32)
for i, x in enumerate(jax.tree.leaves(c)):
    res[f"decode_cache{i}"] = x.astype(f32)
cfg64 = dataclasses.replace(base, compute_dtype="float64")
batch = {"tokens": d["grad_tokens"], "labels": d["grad_labels"],
         "vision_embeds": jnp.asarray(d["grad_vision"], jnp.float64)}
g = jax.grad(lambda q: rm.loss_fn(q, cfg64, batch))(
    jax.tree.map(lambda x: x.astype(jnp.float64), p))
for i, x in enumerate(jax.tree.leaves(g)):
    assert x.dtype == jnp.float64
    res[f"grad64_{i}"] = x
np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
"""

# the inputs of the cases the strict reference serves
FWD_SEED, DEC_SEED, DEC_T, DEC_N, GRAD_SEED = 0, 3, 16, 6, 5


def _grad_batch(cfg):
    rng = np.random.default_rng(GRAD_SEED)
    labels = _tokens(cfg, seed=GRAD_SEED + 1)
    labels[rng.random(labels.shape) < 0.1] = -1
    return _tokens(cfg, seed=GRAD_SEED), labels


@pytest.fixture(scope="module")
def strict_ref(tmp_path_factory):
    """The reference's bf16 outputs with XLA's excess precision off, and
    its float64 gradients (JAX_ENABLE_X64), from one process of its own
    on the same parameters and inputs as the tests here."""
    rcfg, _ = _cfgs()
    p, _ = _params()
    tmp = tmp_path_factory.mktemp("vlm_ref")
    src, out = tmp / "in.npz", tmp / "out.npz"
    f32 = lambda x: np.asarray(x.astype(jnp.float32))  # noqa: E731
    toks, labels = _grad_batch(rcfg)
    np.savez(src, fwd_tokens=_tokens(rcfg, seed=FWD_SEED),
             fwd_vision=f32(_vision(rcfg, seed=FWD_SEED)[0]),
             dec_tokens=_tokens(rcfg, t=DEC_T + DEC_N, seed=DEC_SEED),
             dec_t=DEC_T, dec_vision=f32(_vision(rcfg, seed=DEC_SEED)[0]),
             grad_tokens=toks, grad_labels=labels,
             grad_vision=f32(_vision(rcfg, seed=GRAD_SEED)[0]),
             **{f"p{i}": np.asarray(x)
                for i, x in enumerate(jax.tree.leaves(p))})
    run = subprocess.run(
        [sys.executable, "-c", _REF_STRICT, str(src), str(out)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "JAX_PLATFORMS": "cpu", "JAX_ENABLE_X64": "1",
             "XLA_FLAGS": "--xla_allow_excess_precision=false"})
    assert run.returncode == 0, run.stderr
    with np.load(out) as data:
        return {k: data[k] for k in data.files}


def _cross0():
    p, pt = _params()
    return (jax.tree.map(lambda x: x[0], p["cross_blocks"]),
            tp.tree_map(lambda x: x[0], pt["cross_blocks"]))


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_and_cross_block(dtype):
    """cross_attention (no mask, no rope: every position attends to every
    vision position) and the cross block around it, on bf16 embeddings
    (promoted to fp32 at fp32 compute, as jnp promotes them)."""
    rcfg, tcfg = _cfgs(dtype)
    lp, lt = _cross0()
    ej, et = _vision(rcfg)
    xj, xt = _x((2, 12, rcfg.d_model), dtype, seed=1)
    dt_j, dt_t = getattr(jnp, dtype), getattr(torch, dtype)
    want = ra.cross_attention(lp["attn"], xj, ej, rcfg, dt=dt_j)
    got = ta.cross_attention(lt["attn"], xt, et, tcfg, dt=dt_t)
    assert got.dtype == dt_t
    _close(got, want, dtype)
    want = rb.cross_block(lp, xj, ej, rcfg, dt=dt_j)
    got = tb.cross_block(lt, xt, et, tcfg, dt=dt_t)
    assert got.dtype == dt_t
    _close(got, want, dtype)
    # no mask: a position's output does not depend on the others
    first = tb.cross_block(lt, xt[:, :1], et, tcfg, dt=dt_t)
    assert torch.allclose(first.float(), got[:, :1].float(), atol=1e-5,
                          rtol=1e-3)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_kv(dtype):
    """The cross keys and values of both cross layers, [G, B, S, KV, hd],
    bit for bit (one product each, of the same rounded operands)."""
    rcfg, tcfg = _cfgs(dtype)
    p, pt = _params()
    ej, et = _vision(rcfg, seed=2)
    want = rm._cross_kv(p["cross_blocks"], rcfg, ej, getattr(jnp, dtype))
    got = tm._cross_kv(pt["cross_blocks"], tcfg, et, getattr(torch, dtype))
    assert tuple(got.k.shape) == (rcfg.n_cross_layers, 2, rcfg.vision_seq,
                                  rcfg.n_kv_heads, rcfg.head_dim)
    _trees_close(got, want, dtype)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_with_vision_embeds(dtype, strict_ref):
    """The grouped forward's logits, and the prefill's caches: "self"
    [G, g, B, T, KV, hd] and "cross" [G, B, S, KV, hd]. In bf16 against
    the strict reference, and the port against the reference's blocks
    composed one by one in this process."""
    rcfg, tcfg = _cfgs(dtype)
    p, pt = _params()
    toks = _tokens(rcfg, seed=FWD_SEED)
    ej, et = _vision(rcfg, seed=FWD_SEED)
    for mode in ("full", "prefill"):
        got = tm.forward(pt, tcfg, torch.from_numpy(toks), vision_embeds=et,
                         mode=mode)
        if dtype == "float32":
            want = rm.forward(p, rcfg, jnp.asarray(toks), vision_embeds=ej,
                              mode=mode)
            want_logits, want_caches = want.logits, jax.tree.leaves(
                want.caches)
        else:
            want_logits = strict_ref[mode]
            want_caches = [strict_ref[f"prefill_cache{i}"] for i in range(4)]
        _close(got.logits, want_logits, dtype)
        if mode == "full":
            assert got.caches == ()
            continue
        assert sorted(got.caches) == ["cross", "self"]
        assert tuple(got.caches["self"].kv.k.shape[:3]) == (
            rcfg.n_cross_layers, rcfg.group_self, 2)
        leaves = _leaves(got.caches)
        assert len(leaves) == len(want_caches) == 4
        for a, b in zip(leaves, want_caches):
            assert a.dtype == getattr(torch, dtype)
            _close(a, b, dtype)
    if dtype == "bfloat16":
        # the reference's blocks one by one (no scan, no fusion across ops)
        h = rm.embed_tokens(p, rcfg, jnp.asarray(toks), jnp.bfloat16)
        pos = jnp.arange(toks.shape[1], dtype=jnp.int32)
        for g in range(rcfg.n_cross_layers):
            h = rb.cross_block(jax.tree.map(lambda x: x[g], p["cross_blocks"]),
                               h, ej, rcfg, dt=jnp.bfloat16)
            for j in range(g * rcfg.group_self, (g + 1) * rcfg.group_self):
                h, _, _ = rb.block(jax.tree.map(lambda x: x[j],
                                                p["self_blocks"]), h, rcfg,
                                   positions=pos, dt=jnp.bfloat16)
        h = rl.rmsnorm(p["final_norm"], h, rcfg.rms_eps)
        _close(got.logits, rm.logits_fn(p, rcfg, h, jnp.bfloat16), dtype)


@functools.lru_cache(maxsize=None)
def _jit_decode(rcfg):
    return jax.jit(lambda p, t, c, pos: rm.decode_step(p, rcfg, t, c, pos))


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_then_decode(dtype, strict_ref):
    """Prefill 16 tokens with the embeddings, its self-caches put into
    longer decode caches (sequence axis 3 of [G, g, B, S, ...]) and its
    cross caches taken whole, then 6 teacher-forced decode steps that
    reuse the prefilled cross keys and values: every step's logits
    against the reference's (in bf16 the strict reference's), and at fp32
    against the port's own full forward at that position."""
    rcfg, tcfg = _cfgs(dtype)
    p, pt = _params()
    t, n = DEC_T, DEC_N
    toks = _tokens(rcfg, t=t + n, seed=DEC_SEED)
    ej, et = _vision(rcfg, seed=DEC_SEED)
    pre_r = rm.forward(p, rcfg, jnp.asarray(toks[:, :t]), vision_embeds=ej,
                       mode="prefill")
    pre_t = tm.forward(pt, tcfg, torch.from_numpy(toks[:, :t]),
                       vision_embeds=et, mode="prefill")
    cdt_j, cdt_t = getattr(jnp, dtype), getattr(torch, dtype)
    cr = rm.init_caches(rcfg, 2, t + n, dt=cdt_j)
    cr = {"self": jax.tree.map(lambda d, s: jax.lax.dynamic_update_slice_in_dim(
        d, s, 0, axis=3), cr["self"], pre_r.caches["self"]),
        "cross": pre_r.caches["cross"]}
    ct = tm.init_caches(tcfg, 2, t + n, dt=cdt_t, device="cpu")
    tp.tree_map(lambda d, s: d[:, :, :, :t].copy_(s), ct["self"],
                pre_t.caches["self"])
    ct["cross"] = pre_t.caches["cross"]
    full = tm.forward(pt, tcfg, torch.from_numpy(toks),
                      vision_embeds=et).logits
    step = _jit_decode(rcfg)
    for i in range(n):
        tok = toks[:, t + i:t + i + 1]
        lr, cr = step(p, jnp.asarray(tok), cr, jnp.int32(t + i))
        lt, ct = tm.decode_step(pt, tcfg, torch.from_numpy(tok), ct, t + i)
        assert ct["cross"] is pre_t.caches["cross"]
        if dtype == "float32":
            _close(lt, lr)
            _close(lt[:, 0], full[:, t + i])
        else:
            _close(lt, strict_ref[f"decode{i}"], dtype)
    if dtype == "float32":
        _trees_close(ct, cr)
    else:
        for i, a in enumerate(_leaves(ct)):
            _close(a, strict_ref[f"decode_cache{i}"], dtype)


def test_groups_of_several_self_blocks():
    """fp32, group_self 2 (the smoke config has 1; the full one 4): the
    self blocks run in their groups, the prefill's self-caches stack as
    [G, g, B, ...], and decode takes layer g' of group G from the stack's
    [G, g'] (4 teacher-forced steps on the prefill's own 8-position
    caches, which the decode then uses as a ring)."""
    rcfg, tcfg = _cfgs(group_self=2, n_layers=4)
    p, pt = _params(group_self=2, n_layers=4)
    toks = _tokens(rcfg, t=12, seed=7)
    ej, et = _vision(rcfg, seed=7)
    t = 8
    pre_r = rm.forward(p, rcfg, jnp.asarray(toks[:, :t]), vision_embeds=ej,
                       mode="prefill")
    pre_t = tm.forward(pt, tcfg, torch.from_numpy(toks[:, :t]),
                       vision_embeds=et, mode="prefill")
    _close(pre_t.logits, pre_r.logits)
    assert tuple(pre_t.caches["self"].kv.k.shape[:3]) == (2, 2, 2)
    _trees_close(pre_t.caches, pre_r.caches)
    cr, ct = dict(pre_r.caches), dict(pre_t.caches)
    for i in range(t, toks.shape[1]):
        lr, cr = _jit_decode(rcfg)(p, jnp.asarray(toks[:, i:i + 1]), cr,
                                   jnp.int32(i))
        lt, ct = tm.decode_step(pt, tcfg, torch.from_numpy(toks[:, i:i + 1]),
                                ct, i)
        _close(lt, lr)


def test_decode_on_default_caches_promotes_the_cross_cache():
    """fp32 compute over bf16 cross caches (init_caches' default), as
    the reference promotes them: the cross attention runs in fp32; the
    self caches given fp32."""
    rcfg, tcfg = _cfgs("float32")
    p, pt = _params()
    ej, et = _vision(rcfg, seed=4)
    cr = rm.init_caches(rcfg, 2, 8, dt=jnp.float32)
    cr["cross"] = rm._cross_kv(p["cross_blocks"], rcfg, ej, jnp.bfloat16)
    ct = tm.init_caches(tcfg, 2, 8, dt=torch.float32, device="cpu")
    ct["cross"] = tm._cross_kv(pt["cross_blocks"], tcfg, et, torch.bfloat16)
    assert ct["cross"].k.dtype == torch.bfloat16
    toks = _tokens(rcfg, t=3, seed=4)
    for i in range(3):
        lr, cr = _jit_decode(rcfg)(p, jnp.asarray(toks[:, i:i + 1]), cr,
                                   jnp.int32(i))
        lt, ct = tm.decode_step(pt, tcfg, torch.from_numpy(toks[:, i:i + 1]),
                                ct, i)
        assert lt.dtype == torch.float32
        _close(lt, lr)


_ref_grads = jax.jit(jax.value_and_grad(
    lambda p, cfg, batch: rm.loss_fn(p, cfg, batch)), static_argnums=1)


def test_loss_and_grads_with_vision_embeds(strict_ref):
    """fp32: loss_fn on {"tokens", "labels", "vision_embeds"} (the loss
    within 1e-5 relative) and every gradient leaf, the cross blocks'
    included, within GRAD_TOL of the leaf's scale plus the reference's
    own distance from its float64 gradients."""
    rcfg, tcfg = _cfgs()
    p, pt = _params()
    ej, et = _vision(rcfg, seed=GRAD_SEED)
    toks, labels = _grad_batch(rcfg)
    want_l, want_g = _ref_grads(p, rcfg, {"tokens": toks, "labels": labels,
                                          "vision_embeds": ej})
    live = tp.tree_map(lambda x: x.clone().requires_grad_(), pt)
    loss = tm.loss_fn(live, tcfg, {"tokens": torch.from_numpy(toks),
                                   "labels": torch.from_numpy(labels),
                                   "vision_embeds": et})
    grads = torch.autograd.grad(loss, tp.tree_leaves(live))
    assert abs(float(loss.detach()) - float(want_l)) <= 1e-5 * abs(
        float(want_l))
    want_g = jax.tree.leaves(want_g)
    assert len(grads) == len(want_g)
    for i, (g, w) in enumerate(zip(grads, want_g)):
        w = np.asarray(w)
        own = np.abs(w - strict_ref[f"grad64_{i}"]).max()
        assert np.abs(g.numpy() - w).max() <= GRAD_TOL * np.abs(w).max() + own


def test_prefill_step_takes_vision_embeds():
    """make_prefill_step passes the embeddings to the model: its last
    logits and caches are forward(mode="prefill")'s."""
    _, tcfg = _cfgs()
    _, pt = _params()
    _, et = _vision(tcfg, seed=6)
    toks = torch.from_numpy(_tokens(tcfg, t=8, seed=6))
    last, caches = tts.make_prefill_step(tcfg)(pt, toks, vision_embeds=et)
    with torch.no_grad():
        full = tm.forward(pt, tcfg, toks, vision_embeds=et, mode="prefill")
    assert torch.equal(last, full.logits[:, -1:])
    assert all(torch.equal(a, b) for a, b in zip(_leaves(caches),
                                                  _leaves(full.caches)))


# ---------------------------------------------------------------------------
# serving: the slot merge
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("group_self", [1, 2])
def test_merge_slot_on_grouped_self_caches(group_self):
    """Merging slot 1 of B = 2 copies axis 2 of every "self" leaf [G, g,
    B, ...] and axis 1 of every "cross" leaf [G, B, ...], nothing else:
    as the reference's _merge_slot when g differs from B (g = 1); at g =
    2 = B the reference's test (a leaf's axis 1 against the batch) takes
    the self-caches' axis 1, the group's layer, and the port its key."""
    _, tcfg = _cfgs(n_layers=2 * group_self, group_self=group_self)
    rcfg, _ = _cfgs(n_layers=2 * group_self, group_self=group_self)
    old = tm.init_caches(tcfg, 2, 8, dt=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(0)
    new = tp.tree_map(lambda x: torch.randn(x.shape, generator=gen), old)
    fresh = tp.tree_map(torch.clone, new)
    teng._merge_slot(old, new, 1)
    for key, axis in (("self", 2), ("cross", 1)):
        for got, src in zip(_leaves(old[key]), _leaves(fresh[key])):
            take = [slice(None)] * axis + [1]
            keep = [slice(None)] * axis + [0]
            assert torch.equal(got[tuple(take)], src[tuple(take)])
            assert torch.count_nonzero(got[tuple(keep)]) == 0
    if group_self == 1:
        ref_old = rm.init_caches(rcfg, 2, 8, dt=jnp.float32)
        ref_new = jax.tree.unflatten(
            jax.tree.structure(ref_old),
            [jnp.asarray(x.numpy()) for x in _leaves(fresh)])
        want = reng._merge_slot(ref_old, ref_new, 1, batch=2)
        for got, w in zip(_leaves(old), jax.tree.leaves(want)):
            assert np.array_equal(got.numpy(), np.asarray(w))

"""The port's LM substrate (repro_torch.models, repro_torch.configs)
against the reference's, for the four dense-attention architectures and
the two MoE ones (qwen3-moe-235b-a22b; deepseek-v2-lite-16b, MLA after a
leading dense layer) at smoke size (Mamba and Hymba are held to the
reference in tests/test_torch_mamba.py, the VLM in test_torch_vlm.py) (the tests/test_arch_smoke.py shapes:
batch 2, seq 32). At these widths and seeds no token of the MoE models
lies within 1e-5 of a routing tie (tests/test_torch_moe.py's margin), so
both packages route every token alike.

Weights come from the reference's init_params and are carried across
with params_from_numpy; tokens are made with numpy. Tolerances:
  * fp32 compute (fp32 caches in both packages): |port - ref| <= 1e-4 x
    the largest |ref| logit. The same fp32 arithmetic, summed in another
    order (measured about 2e-5).
  * bf16 compute (the configs' own): a matrix product of both packages
    may round its bf16 output one step apart (another summation order),
    and the random-init attention is nearly one-hot, so a one-step
    difference can move a near-tie and change a position's logits by
    several percent. The whole-model check is therefore a norm:
    ||port - ref|| <= 6e-2 ||ref|| over all logits (0.06 is the
    reference's own bf16 rtol in tests/test_arch_smoke.py), and
    the layers are held one by one to one bf16 step (rtol 2^-7).
  * the MoE router's aux loss: 1e-5 relative at fp32, one bf16 step
    (2^-7) relative at bf16.
  * int8 KV caches: fp32 keys a few ulp apart can round to int8 values
    one step apart, which moves a key by its scale (about 1% of its
    largest element); logits within 1e-2 x the largest |ref| logit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as rc  # noqa: E402
from repro.models import attention as ra  # noqa: E402
from repro.models import layers as rl  # noqa: E402
from repro.models import model as rm  # noqa: E402
from repro.models import params as rp  # noqa: E402

from repro_torch import configs as tc  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import params as tp  # noqa: E402

DENSE = ["llama3-8b", "qwen2.5-14b", "deepseek-coder-33b", "gemma-2b"]
MOE = ["deepseek-v2-lite-16b", "qwen3-moe-235b-a22b"]
PORTED = DENSE + MOE
SSM_VLM = ["falcon-mamba-7b", "hymba-1.5b", "llama-3.2-vision-11b"]
OTHERS = sorted(set(rc.ARCHS) - set(PORTED))
FP32_TOL = 1e-4
AUX_RTOL = 1e-5
BF16_NORM_TOL = 6e-2
BF16_STEP = 2.0 ** -7
QUANT_TOL = 1e-2


def _cfgs(arch, dtype="bfloat16", **kw):
    r = dataclasses.replace(rc.smoke_config(rc.get_config(arch)),
                            compute_dtype=dtype, **kw)
    t = dataclasses.replace(tc.smoke_config(tc.get_config(arch)),
                            compute_dtype=dtype, **kw)
    return r, t


def _params(rcfg, seed=0):
    """Reference params (qkv biases filled with noise so that their path
    counts) and the port's copy of them."""
    p = rp.init_params(rm.model_spec(rcfg), jax.random.key(seed))
    if rcfg.qkv_bias:
        rng = np.random.default_rng(seed + 100)
        for k in ("bq", "bk", "bv"):
            shape = p["blocks"]["attn"][k].shape
            p["blocks"]["attn"][k] = jnp.asarray(
                rng.normal(size=shape).astype(np.float32) * 0.1)
    return p, tp.params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")


def _tokens(cfg, b=2, t=32, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, t)).astype(
        np.int32)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype, tol=None):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    if dtype == "bfloat16" and tol is None:
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= BF16_NORM_TOL, err
    else:
        scale = np.abs(want).max()
        err = np.abs(got - want).max()
        assert err <= (tol or FP32_TOL) * scale, (err, scale)


@functools.lru_cache(maxsize=None)
def _jit_decode(rcfg):
    return jax.jit(lambda p, t, c, pos: rm.decode_step(p, rcfg, t, c, pos))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
def test_configs_are_the_reference_configs():
    assert list(tc.ARCHS) == list(rc.ARCHS)
    for name in rc.ARCHS:
        r, t = rc.get_config(name), tc.get_config(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(r)
        assert dataclasses.asdict(tc.smoke_config(t)) == dataclasses.asdict(
            rc.smoke_config(r))
        assert tc.shapes_for(t) == rc.shapes_for(r)
    assert {k: dataclasses.asdict(v) for k, v in tc.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in rc.SHAPES.items()}
    with pytest.raises(KeyError):
        tc.get_config("no-such-arch")


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(rc.ARCHS))
def test_count_params_full_width(arch):
    """All ten architectures at full width, counted from the declarations
    alone (nothing is allocated)."""
    r = rp.count_params(rm.model_spec(rc.get_config(arch)))
    t = tp.count_params(tm.model_spec(tc.get_config(arch)))
    assert t == r


@pytest.mark.parametrize("arch", ["llama3-8b"] + MOE)
def test_abstract_params_match_reference_shapes(arch):
    cfg_r, cfg_t = rc.get_config(arch), tc.get_config(arch)
    ref = rp.abstract_params(rm.model_spec(cfg_r))
    meta = tp.abstract_params(tm.model_spec(cfg_t))
    got = {jax.tree_util.keystr(path): tuple(leaf.shape) for path, leaf in
           jax.tree_util.tree_flatten_with_path(meta)[0]}
    want = {jax.tree_util.keystr(path): tuple(leaf.shape) for path, leaf in
            jax.tree_util.tree_flatten_with_path(ref)[0]}
    assert got == want
    assert all(x.device.type == "meta" for x in tp.tree_leaves(meta))


@pytest.mark.parametrize("arch", PORTED)
def test_init_params_follows_the_reference_rule(arch):
    """Per leaf: zeros, ones, or a normal whose std is the reference's
    rule (``scale``, else shape[-2] ** -0.5 of the stacked shape); checked
    as statistics against the rule and against the reference's draw."""
    rcfg, tcfg = _cfgs(arch)
    spec = tm.model_spec(tcfg)
    ref = rp.init_params(rm.model_spec(rcfg), jax.random.key(0))
    got = tp.init_params(spec, torch.Generator().manual_seed(0),
                         device="cpu")
    specs = dict(jax.tree_util.tree_flatten_with_path(
        spec, is_leaf=tp.is_spec)[0])
    refs = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    for path, x in jax.tree_util.tree_flatten_with_path(got)[0]:
        s, r = specs[path], np.asarray(refs[path])
        assert tuple(x.shape) == s.shape == r.shape and x.dtype == torch.float32
        if s.init in ("zeros", "ones"):
            assert torch.all(x == (0.0 if s.init == "zeros" else 1.0))
            continue
        std = tp.init_std(s)
        assert abs(float(x.std()) / std - 1) < 0.1, (path, float(x.std()))
        assert abs(float(r.std()) / std - 1) < 0.1, (path, float(r.std()))
        assert abs(float(x.mean())) < 0.1 * std


def test_init_params_draws_from_the_generator():
    spec = tm.model_spec(tc.smoke_config(tc.get_config("llama3-8b")))
    a = tp.init_params(spec, torch.Generator().manual_seed(3), device="cpu")
    b = tp.init_params(spec, torch.Generator().manual_seed(3), device="cpu")
    c = tp.init_params(spec, torch.Generator().manual_seed(4), device="cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], c["embed"])
    bf = tp.init_params(spec, torch.Generator().manual_seed(3),
                        dtype=torch.bfloat16, device="cpu")
    assert torch.equal(bf["embed"], a["embed"].bfloat16())


def test_params_from_numpy_keeps_values_and_bf16_bits():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(3, 5)).astype(np.float32))
    tree = {"a": np.asarray(x), "b": {"c": np.asarray(x.astype(jnp.bfloat16))}}
    got = tp.params_from_numpy(tree, device="cpu")
    assert torch.equal(got["a"], torch.from_numpy(np.array(x)))
    assert got["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(got["b"]["c"].float(),
                       torch.from_numpy(np.asarray(x.astype(jnp.bfloat16),
                                                   np.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE + SSM_VLM)
def test_params_from_numpy_carries_the_moe_trees(arch, dtype):
    """The reference's whole tree (``dense_blocks``; Mamba's
    ``blocks.mamba``, Hymba's ``norm_a`` and ``norm_m``, the VLM's
    ``cross_blocks`` and ``self_blocks`` included) arrives with the same
    keys, shapes, dtypes and bits."""
    rcfg, _ = _cfgs(arch)
    p = rp.init_params(rm.model_spec(rcfg), jax.random.key(1),
                       dtype=getattr(jnp, dtype))
    got = tp.params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
    want = dict(jax.tree_util.tree_flatten_with_path(p)[0])
    have = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert have.keys() == want.keys()
    assert any("dense_blocks" in jax.tree_util.keystr(k) for k in have) == (
        arch == "deepseek-v2-lite-16b")
    for k, x in have.items():
        w = np.asarray(want[k])
        assert tuple(x.shape) == w.shape
        assert str(x.dtype).removeprefix("torch.") == str(w.dtype)
        if dtype == "bfloat16":
            assert np.array_equal(x.view(torch.int16).numpy(),
                                  w.view(np.int16))
        else:
            assert np.array_equal(x.numpy(), w)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def _x(shape, seed=0, scale=1.0):
    return np.random.default_rng(seed).normal(size=shape).astype(
        np.float32) * scale


def _pair(a, dtype):
    j = jnp.asarray(a).astype(getattr(jnp, dtype))
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_rope(dtype):
    xj, xt = _pair(_x((2, 12, 3, 16)), dtype)
    scale = _x((16,), seed=1)
    got = tl.rmsnorm({"scale": torch.from_numpy(scale)}, xt, 1e-5)
    want = rl.rmsnorm({"scale": jnp.asarray(scale)}, xj, 1e-5)
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_STEP
                               if dtype == "bfloat16" else 1e-6, atol=1e-6)
    pos = np.arange(5, 17, dtype=np.int32)
    for theta in (1e4, 5e5):
        got = tl.apply_rope(xt, torch.from_numpy(pos), theta)
        want = rl.apply_rope(xj, jnp.asarray(pos), theta)
        np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_STEP if
                                   dtype == "bfloat16" else 1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tl.rope_freqs(16, 5e5)),
                               np.asarray(rl.rope_freqs(16, 5e5)), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["swiglu", "geglu", "mlp"])
def test_ffn(kind, dtype):
    spec = rl.ffn_spec(32, 64, kind)
    p = rp.init_params(spec, jax.random.key(1))
    pt = tp.params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
    xj, xt = _pair(_x((2, 5, 32), scale=2.0), dtype)
    got = tl.ffn(pt, xt, kind, compute_dtype=getattr(torch, dtype))
    want = rl.ffn(p, xj, kind, compute_dtype=getattr(jnp, dtype))
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_STEP if
                               dtype == "bfloat16" else 1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_activations_round_as_the_reference(dtype):
    """The tanh GELU and SiLU, op for op: bit-identical in bf16."""
    xj, xt = _pair(_x((4096,), scale=3.0), dtype)
    exact = dtype == "bfloat16"
    for mine, ref in ((tl.gelu, jax.nn.gelu), (tl.silu, jax.nn.silu)):
        got, want = _np(mine(xt)), _np(ref(xj))
        if exact:
            assert np.array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_rep,window", [(1, 0), (2, 0), (4, 0), (2, 5)])
def test_sdpa_gqa(n_rep, window, dtype):
    """Query head h reads KV head h // n_rep; causal (+window) bias."""
    kv, t, hd = 2, 12, 16
    qj, qt = _pair(_x((2, t, kv * n_rep, hd), seed=1, scale=2.0), dtype)
    kj, kt = _pair(_x((2, t, kv, hd), seed=2, scale=2.0), dtype)
    vj, vt = _pair(_x((2, t, kv, hd), seed=3), dtype)
    got = ta._sdpa(qt, kt, vt, ta._causal_bias(t, t, 0, window), n_rep)
    want = ra._sdpa(qj, kj, vj, ra._causal_bias(t, t, 0, window), n_rep)
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_STEP if
                               dtype == "bfloat16" else 1e-5, atol=1e-5)


def test_attend_chunked_and_prefill_ring():
    """Query-block chunking equals the unchunked attention, and prefill
    with cache_len < T keeps the last cache_len positions (int8 too)."""
    rcfg, tcfg = _cfgs("llama3-8b", "float32")
    p, pt = _params(rcfg)
    lp = jax.tree.map(lambda x: x[0], p["blocks"]["attn"])
    lpt = {k: v[0] for k, v in pt["blocks"]["attn"].items()}
    x = _x((2, 32, rcfg.d_model), seed=4)
    pos = np.arange(32, dtype=np.int32)
    q, k, v = ta._qkv(lpt, torch.from_numpy(x), tcfg, torch.float32)
    full = ta._attend_chunked(q, k, v, tcfg, 2, 0)
    np.testing.assert_allclose(_np(ta._attend_chunked(q, k, v, tcfg, 2, 8)),
                               _np(full), rtol=1e-6, atol=1e-6)
    for quant in (False, True):
        rq = dataclasses.replace(rcfg, kv_quant=quant)
        tq = dataclasses.replace(tcfg, kv_quant=quant)
        yr, cr = ra.prefill_attention(lp, jnp.asarray(x), rq,
                                      positions=jnp.asarray(pos),
                                      cache_len=10, dt=jnp.float32)
        yt, ct = ta.prefill_attention(lpt, torch.from_numpy(x), tq,
                                      positions=torch.from_numpy(pos),
                                      cache_len=10, dt=torch.float32)
        _close(yt, yr, "float32")
        assert type(ct).__name__ == type(cr).__name__
        assert ct.k.shape == (2, 10, rcfg.n_kv_heads, rcfg.head_dim)
        for a, b in zip(ct, cr):
            if quant and a.dtype == torch.int8:  # one int8 step, rarely
                d = np.abs(_np(a) - _np(b))
                assert d.max() <= 1 and d.mean() < 1e-3
            else:
                _close(a, b, "float32")


# ---------------------------------------------------------------------------
# the model: forward (full, prefill) and decode
# ---------------------------------------------------------------------------
def _cache_pairs(ct, cr):
    """(port leaf, reference leaf) over every stack's cache, in order."""
    assert sorted(ct) == sorted(cr)
    for key in sorted(ct):
        assert ct[key].ssm == ()
        assert type(ct[key].kv).__name__ == type(cr[key].kv).__name__
        yield from zip(ct[key].kv, cr[key].kv)


def _aux_close(got, want, dtype):
    """The MoE layers' summed router loss: 1e-5 relative at fp32; at bf16
    the routed hidden states are a bf16 step apart, so one bf16 step."""
    want = float(want)
    if want == 0.0:
        assert float(got) == 0.0
    else:
        tol = AUX_RTOL if dtype == "float32" else BF16_STEP
        assert abs(float(got) - want) <= tol * abs(want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", PORTED)
def test_forward_full_and_prefill(arch, dtype):
    rcfg, tcfg = _cfgs(arch, dtype)
    p, pt = _params(rcfg)
    toks = _tokens(rcfg)
    for mode in ("full", "prefill"):
        want = rm.forward(p, rcfg, jnp.asarray(toks), mode=mode)
        got = tm.forward(pt, tcfg, torch.from_numpy(toks), mode=mode)
        _close(got.logits, want.logits, dtype)
        _aux_close(got.aux_loss, want.aux_loss, dtype)
        assert (float(got.aux_loss) > 0) == (arch in MOE)
        if mode == "full":
            assert got.caches == ()
            continue
        for a, b in _cache_pairs(got.caches, want.caches):
            assert a.dtype == getattr(torch, dtype)
            _close(a, b, dtype)


def _decode_both(rcfg, tcfg, p, pt, toks, cache_len, cache_dt):
    """Greedy-free teacher-forced decode over toks in both packages: the
    per-step logits, and the last caches."""
    step = _jit_decode(rcfg)
    cr = rm.init_caches(rcfg, toks.shape[0], cache_len,
                        dt=getattr(jnp, cache_dt))
    ct = tm.init_caches(tcfg, toks.shape[0], cache_len,
                        dt=getattr(torch, cache_dt), device="cpu")
    out = []
    for i in range(toks.shape[1]):
        lr, cr = step(p, jnp.asarray(toks[:, i:i + 1]), cr, jnp.int32(i))
        lt, ct = tm.decode_step(pt, tcfg, torch.from_numpy(toks[:, i:i + 1]),
                                ct, i)
        out.append((lt, lr))
    return out, ct, cr


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", PORTED)
def test_decode_matches_reference(arch, dtype):
    """Twelve decode steps into a 16-position cache, logits at every step
    (fp32 compute runs on fp32 caches in both packages)."""
    rcfg, tcfg = _cfgs(arch, dtype)
    p, pt = _params(rcfg)
    toks = _tokens(rcfg, t=12, seed=1)
    steps, ct, cr = _decode_both(rcfg, tcfg, p, pt, toks, 16, dtype)
    for lt, lr in steps:
        assert lt.shape == (2, 1, rcfg.vocab)
        _close(lt, lr, dtype)
    for a, b in _cache_pairs(ct, cr):
        _close(a, b, dtype)


@pytest.mark.parametrize("variant", ["ring", "ring+window", "kv_quant"])
def test_decode_ring_and_int8_caches(variant):
    """A cache shorter than the sequence (pos >= cache_len wraps the ring),
    a sliding window, and int8 caches, at fp32 compute."""
    kw = {"ring+window": dict(sliding_window=6),
          "kv_quant": dict(kv_quant=True)}.get(variant, {})
    rcfg, tcfg = _cfgs("llama3-8b", "float32", **kw)
    p, pt = _params(rcfg, seed=2)
    toks = _tokens(rcfg, t=14, seed=2)
    cache_len = 16 if variant == "kv_quant" else 8
    steps, ct, cr = _decode_both(rcfg, tcfg, p, pt, toks, cache_len,
                                 "float32")
    if variant == "ring+window":
        assert ct["blocks"].kv.k.shape[2] == 6   # capped at the window
    tol = QUANT_TOL if variant == "kv_quant" else None
    for lt, lr in steps:
        _close(lt, lr, "float32", tol=tol)


@pytest.mark.parametrize("arch", ["gemma-2b"] + MOE)
def test_prefill_then_decode_matches_reference(arch):
    """Prefill caches spliced into longer decode caches, then decode, as
    tests/test_arch_smoke.py does (fp32)."""
    rcfg, tcfg = _cfgs(arch, "float32")
    p, pt = _params(rcfg)
    toks = _tokens(rcfg, t=17, seed=3)
    t = 16
    pre_r = rm.forward(p, rcfg, jnp.asarray(toks[:, :t]), mode="prefill")
    pre_t = tm.forward(pt, tcfg, torch.from_numpy(toks[:, :t]),
                       mode="prefill")
    cr = rm.init_caches(rcfg, 2, t + 8, dt=jnp.float32)
    cr = jax.tree.map(lambda d, s: jax.lax.dynamic_update_slice_in_dim(
        d, s, 0, axis=2), cr, pre_r.caches)
    ct = tm.init_caches(tcfg, 2, t + 8, dt=torch.float32, device="cpu")
    tp.tree_map(lambda d, s: d[:, :, :t].copy_(s), ct, pre_t.caches)
    lr, _ = rm.decode_step(p, rcfg, jnp.asarray(toks[:, t:]), cr,
                           jnp.int32(t))
    lt, _ = tm.decode_step(pt, tcfg, torch.from_numpy(toks[:, t:]), ct, t)
    _close(lt, lr, "float32")


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v2-lite-16b"])
def test_decode_leaves_its_input_caches_alone(arch):
    _, tcfg = _cfgs(arch, "float32")
    pt = tp.init_params(tm.model_spec(tcfg), torch.Generator().manual_seed(0),
                        device="cpu")
    ct = tm.init_caches(tcfg, 2, 8, dt=torch.float32, device="cpu")
    _, new = tm.decode_step(pt, tcfg, torch.ones((2, 1), dtype=torch.int32),
                            ct, 0)
    for key in ct:
        for old, leaf in zip(ct[key].kv, new[key].kv):
            assert torch.count_nonzero(old) == 0
            assert torch.count_nonzero(leaf[:, :, 0]) > 0


def test_cache_dtype_mismatch_raises_in_both():
    """fp32 compute on the default bf16 caches: the reference's
    dynamic_update_slice refuses, and so does the port."""
    rcfg, tcfg = _cfgs("llama3-8b", "float32")
    p, pt = _params(rcfg)
    toks = _tokens(rcfg, t=1)
    with pytest.raises(TypeError):
        rm.decode_step(p, rcfg, jnp.asarray(toks),
                       rm.init_caches(rcfg, 2, 8), jnp.int32(0))
    with pytest.raises(TypeError):
        tm.decode_step(pt, tcfg, torch.from_numpy(toks),
                       tm.init_caches(tcfg, 2, 8, device="cpu"), 0)


def _vision_kw(cfg, b=2):
    """The VLM's stand-in embeddings (bf16), {} for the other families."""
    if not cfg.n_cross_layers:
        return {}
    return {"vision_embeds": torch.from_numpy(_x(
        (b, cfg.vision_seq, cfg.d_model), seed=9)).to(torch.bfloat16)}


@pytest.mark.parametrize("arch", OTHERS)
def test_unported_families_raise(arch):
    """No family the attention ones leave raises any more: Mamba, Hymba
    and the VLM (items 9.4 and 9.5) and the audio family (9.6, [B, T, K]
    tokens, logits [B, T, K, V]) run: caches, forward and a decode
    step."""
    cfg = tc.smoke_config(tc.get_config(arch))
    spec = tm.model_spec(cfg)
    assert tp.count_params(spec) > 0
    pt = tp.init_params(spec, torch.Generator().manual_seed(0),
                        device="cpu")
    k = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    toks = torch.zeros((2, 4, *k), dtype=torch.int32)
    out = tm.forward(pt, cfg, toks, **_vision_kw(cfg))
    assert out.logits.shape == (2, 4, *k, cfg.vocab)
    caches = tm.init_caches(cfg, 2, 8, device="cpu")
    logits, _ = tm.decode_step(pt, cfg, toks[:, :1], caches, 0)
    assert logits.shape == (2, 1, *k, cfg.vocab)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("arch", ["llama3-8b"] + MOE + SSM_VLM)
def test_the_lm_path_launches_no_kernel(arch):
    """The reference's model reaches no pallas_call (its Mamba scan is
    lax.associative_scan and lax.scan, its cross-attention the jnp
    _sdpa), so the port's forward and decode_step launch none of
    K1-K9."""
    from repro_torch.kernels import ops

    _, tcfg = _cfgs(arch)
    pt = tp.init_params(tm.model_spec(tcfg), torch.Generator().manual_seed(0),
                        device="cpu")
    ops.reset_dispatch_count()
    toks = torch.from_numpy(_tokens(tcfg, t=8))
    tm.forward(pt, tcfg, toks, mode="prefill", **_vision_kw(tcfg))
    tm.decode_step(pt, tcfg, toks[:, :1],
                   tm.init_caches(tcfg, 2, 8, device="cpu"), 0)
    assert ops.dispatch_count() == 0

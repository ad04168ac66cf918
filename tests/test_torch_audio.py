"""The audio family (musicgen-medium) in the port against the reference,
on the CPU at smoke size (2 layers, d 64, 4 codebooks of vocab 512).

Tokens are [B, T, K]: codebook k's id looks up its own table of ``embed``
[K, V, d], the rows are summed, and the logits are [B, T, K, V], one head
of ``head`` [K, d, V] a codebook. Weights come from the reference's
init_params, carried across by params_from_numpy; tokens and labels are
made with numpy. Tolerances:
  * the embedding, the heads, forward (full and prefill) and decode: at
    fp32 within 1e-5 of the largest |value|; at bf16 the norm of the
    difference within 2e-2 of the reference's norm;
  * loss_fn: 1e-5 relative, unchunked (T = 32) and chunked (T = 2048,
    loss_chunk 512), with -1 (masked) labels; gradients: each leaf within
    1e-4 of that leaf's largest |g|, at T = 2048 plus the distance of the
    reference's fp32 gradients from its own float64 run (up to 3.8e-4 of
    a leaf's scale there, where the port's fp32 lies within 8e-5 of the
    float64 values);
  * five train steps: losses (and the first step's gradient norm) within
    1e-4 relative, as tests/test_torch_train.py holds the other families.
Checkpoints of the audio tree written by either package restore in the
other bit for bit.
"""
import dataclasses
import functools
import json
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
from repro.configs import RunConfig as RRun, ShapeConfig as RShape  # noqa: E402
from repro.models import model as rm  # noqa: E402
from repro.models import params as rp  # noqa: E402
from repro.serve import Engine as RefEngine  # noqa: E402
from repro.serve import LMDecodeWorkload as RefWorkload  # noqa: E402
from repro.train import checkpoint as rckpt  # noqa: E402
from repro.train import optimizer as ropt  # noqa: E402
from repro.train import train_step as rts  # noqa: E402

from repro_torch import configs as tc  # noqa: E402
from repro_torch.configs import RunConfig as TRun, ShapeConfig as TShape  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import params as tp  # noqa: E402
from repro_torch.serve import Engine, LMDecodeWorkload  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "musicgen-medium"
FP32_TOL = 1e-5
BF16_TOL = 2e-2
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
STEP_RTOL = 1e-4


def _cfgs(dtype="float32"):
    return (dataclasses.replace(rc.smoke_config(rc.get_config(ARCH)),
                                compute_dtype=dtype),
            dataclasses.replace(tc.smoke_config(tc.get_config(ARCH)),
                                compute_dtype=dtype))


@functools.lru_cache(maxsize=None)
def _ref_params(seed=0):
    rcfg, _ = _cfgs()
    return rp.init_params(rm.model_spec(rcfg), jax.random.key(seed))


def _port(tree):
    return tp.params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _tokens(cfg, b=2, t=12, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, t, cfg.n_codebooks)).astype(np.int32)


def _batch(cfg, b, t, seed=0):
    rng = np.random.default_rng(seed)
    shape = (b, t, cfg.n_codebooks)
    labels = rng.integers(0, cfg.vocab, shape).astype(np.int32)
    labels[rng.random(shape) < 0.1] = -1
    return {"tokens": rng.integers(0, cfg.vocab, shape).astype(np.int32),
            "labels": labels}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    if dtype == "bfloat16":
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= BF16_TOL, err
    else:
        err, scale = np.abs(got - want).max(), np.abs(want).max()
        assert err <= FP32_TOL * scale, (err, scale)


def test_params_from_numpy_carries_the_audio_tree():
    """embed [K, V, d] and head [K, d, V] cross as they are, leaf for
    leaf, and the port declares the same tree."""
    rcfg, tcfg = _cfgs()
    p = _ref_params()
    pt = _port(p)
    k, v, d = rcfg.n_codebooks, rcfg.vocab, rcfg.d_model
    assert tuple(pt["embed"].shape) == (k, v, d)
    assert tuple(pt["head"].shape) == (k, d, v)
    assert sorted(pt) == sorted(p)
    for a, b in zip(tp.tree_leaves(pt), jax.tree.leaves(p)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    spec = tm.model_spec(tcfg)
    assert [s.shape for s in tp.tree_leaves(spec)] == [
        tuple(x.shape) for x in jax.tree.leaves(p)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_audio_embed_and_heads(dtype):
    rcfg, tcfg = _cfgs(dtype)
    p = _ref_params()
    pt = _port(p)
    toks = _tokens(rcfg)
    rdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = rm._audio_embed(p, rcfg, jnp.asarray(toks), rdt)
    got = tm.embed_tokens(pt, tcfg, torch.from_numpy(toks), tdt)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    # a gather and four adds in one order: the same bits
    np.testing.assert_array_equal(_np(got), _np(want))
    h = np.random.default_rng(1).normal(size=(2, 12, rcfg.d_model))
    want = rm.logits_fn(p, rcfg, jnp.asarray(h, rdt), rdt)
    got = tm.logits_fn(pt, tcfg, torch.from_numpy(h).to(tdt), tdt)
    assert tuple(got.shape) == (2, 12, rcfg.n_codebooks, rcfg.vocab)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_full_and_prefill(dtype):
    rcfg, tcfg = _cfgs(dtype)
    p = _ref_params()
    pt = _port(p)
    toks = _tokens(rcfg)
    for mode in ("full", "prefill"):
        want = rm.forward(p, rcfg, jnp.asarray(toks), mode=mode)
        got = tm.forward(pt, tcfg, torch.from_numpy(toks), mode=mode)
        _close(got.logits, want.logits, dtype)
        assert float(got.aux_loss) == 0.0
        if mode == "prefill":
            for a, b in zip(got.caches["blocks"].kv,
                            want.caches["blocks"].kv):
                _close(a, b, dtype)


def test_decode_against_prefill_and_reference():
    """Teacher-forced decode over [B, 1, K] tokens into fp32 caches: every
    step's logits [B, 1, K, V] equal the reference's decode, and the
    port's own prefill at that position, within the fp32 tolerance."""
    rcfg, tcfg = _cfgs()
    p = _ref_params()
    pt = _port(p)
    toks = _tokens(rcfg, t=8)
    pre = tm.forward(pt, tcfg, torch.from_numpy(toks), mode="prefill").logits
    step = jax.jit(lambda p, t, c, pos: rm.decode_step(p, rcfg, t, c, pos))
    cr = rm.init_caches(rcfg, 2, 8, dt=jnp.float32)
    ct = tm.init_caches(tcfg, 2, 8, dt=torch.float32, device="cpu")
    for i in range(toks.shape[1]):
        lr, cr = step(p, jnp.asarray(toks[:, i:i + 1]), cr, jnp.int32(i))
        lt, ct = tm.decode_step(pt, tcfg, torch.from_numpy(toks[:, i:i + 1]),
                                ct, i)
        assert tuple(lt.shape) == (2, 1, rcfg.n_codebooks, rcfg.vocab)
        _close(lt, lr, "float32")
        _close(lt, pre[:, i:i + 1], "float32")


_ref_grads = jax.jit(jax.value_and_grad(
    lambda p, cfg, batch: rm.loss_fn(p, cfg, batch)), static_argnums=1)


_REF_X64 = """
import dataclasses, sys
import jax, numpy as np
from repro import configs as rc
from repro.models import model as rm
src, out = sys.argv[1], sys.argv[2]
cfg = dataclasses.replace(rc.smoke_config(rc.get_config("musicgen-medium")),
                          compute_dtype="float64")
data = np.load(src)
n = len(data.files) - 2
treedef = jax.tree.structure(rm.model_spec(cfg), is_leaf=lambda x: hasattr(
    x, "axes"))
params = jax.tree.unflatten(treedef, [data[f"p{i}"].astype(np.float64)
                                      for i in range(n)])
batch = {k: data[k] for k in ("tokens", "labels")}
grads = jax.grad(lambda p: rm.loss_fn(p, cfg, batch))(params)
assert jax.tree.leaves(grads)[0].dtype == np.float64
np.savez(out, *[np.asarray(g) for g in jax.tree.leaves(grads)])
"""


def _ref_grads_x64(rparams, batch, tmp):
    """The reference's gradients in float64 (JAX_ENABLE_X64 in a process
    of its own), from the same fp32 parameters and batch."""
    src, out = tmp / "in.npz", tmp / "out.npz"
    np.savez(src, **batch, **{f"p{i}": np.asarray(x)
                              for i, x in enumerate(jax.tree.leaves(rparams))})
    p = subprocess.run(
        [sys.executable, "-c", _REF_X64, str(src), str(out)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "JAX_PLATFORMS": "cpu", "JAX_ENABLE_X64": "1"})
    assert p.returncode == 0, p.stderr
    data = np.load(out)
    return [data[f"arr_{i}"] for i in range(len(data.files))]


@pytest.mark.parametrize("b,t", [(2, 32), (1, 2048)])
def test_loss_and_grads_match_reference(b, t, tmp_path):
    """T 2048 takes the chunked loss (blocks of 512 positions of [B, 512,
    K, V] logits)."""
    rcfg, tcfg = _cfgs()
    p = _ref_params()
    pt = _port(p)
    batch = _batch(rcfg, b, t, seed=t)
    want_l, want_g = _ref_grads(p, rcfg, batch)
    live = tp.tree_map(lambda x: x.clone().requires_grad_(), pt)
    loss = tm.loss_fn(live, tcfg, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    grads = torch.autograd.grad(loss, tp.tree_leaves(live))
    loss = float(loss.detach())
    assert abs(loss - float(want_l)) <= LOSS_RTOL * abs(float(want_l))
    want_g = [np.asarray(w) for w in jax.tree.leaves(want_g)]
    ref_err = [0.0] * len(want_g)
    if t > 32:
        g64 = _ref_grads_x64(p, batch, tmp_path)
        assert len(g64) == len(want_g)
        ref_err = [np.abs(w - g).max() for w, g in zip(want_g, g64)]
    assert len(grads) == len(want_g)
    for g, w, e in zip(grads, want_g, ref_err):
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= GRAD_TOL * np.abs(w).max() + e


def test_five_train_steps_match_reference():
    rcfg, tcfg = _cfgs()
    rparams = _ref_params()
    tparams = _port(rparams)
    kw = dict(remat="full", learning_rate=3e-4, lr_warmup=2)
    rstep = jax.jit(rts.make_train_step(rcfg, RRun(
        model=rcfg, shape=RShape("t", 32, 4, "train"), **kw)))
    tstep = tts.make_train_step(tcfg, TRun(
        model=tcfg, shape=TShape("t", 32, 4, "train"), **kw))
    ropt_s, topt_s = ropt.init(rparams), topt.init(tparams)
    for i in range(5):
        batch = _batch(rcfg, 4, 32, seed=100 + i)
        rparams, ropt_s, rmet = rstep(rparams, ropt_s, batch)
        tparams, topt_s, tmet = tstep(tparams, topt_s, batch)
        for k in ("loss", "lr") + (("grad_norm",) if i == 0 else ()):
            want = float(rmet[k])
            assert abs(float(tmet[k]) - want) <= STEP_RTOL * abs(want), (
                i, k, float(tmet[k]), want)


def test_checkpoints_interchange_both_ways(tmp_path):
    """{"params", "opt"} of the audio tree after one update, under the
    reference's keys (``embed`` [K, V, d], ``head`` [K, d, V]): a
    reference checkpoint restores in the port, and the port's is the
    reference's, file for file, and restores in the reference."""
    p = _ref_params()
    g = jax.tree.map(lambda x: jnp.full_like(x, 0.01), p)
    p, o, _ = jax.jit(functools.partial(ropt.update, lr=1e-2))(
        p, g, ropt.init(p))
    ref = {"params": p, "opt": o}
    port = {"params": _port(p), "opt": topt.AdamWState(
        step=torch.tensor(int(o.step), dtype=torch.int32),
        m=_port(o.m), v=_port(o.v))}
    keys = tckpt._flatten(port)[0]
    assert keys == rckpt._flatten(ref)[0]
    assert "['params']/['head']" in keys and "['params']/['embed']" in keys

    def same(port_tree, ref_tree):
        for a, b in zip(tckpt._flatten(port_tree)[1],
                        jax.tree.leaves(ref_tree)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    rckpt.save(tmp_path / "ref", 4, ref)
    same(tckpt.restore(tmp_path / "ref", 4, port, device="cpu"), ref)
    tckpt.save(tmp_path / "port", 4, port)
    step = "step_00000004"
    assert (json.loads((tmp_path / "port" / step / "manifest.json")
                       .read_text())
            == json.loads((tmp_path / "ref" / step / "manifest.json")
                          .read_text()))
    with np.load(tmp_path / "ref" / step / "proc_0.npz") as a, \
            np.load(tmp_path / "port" / step / "proc_0.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(a[k].tobytes() == b[k].tobytes() for k in a.files)
    same(port, rckpt.restore(tmp_path / "port", 4, ref))


def test_codebook_prompts_raise_at_submit():
    """A [T, K] prompt, which the reference's Request documents, fails in
    the reference when it is admitted (int() of a K-vector); the port
    refuses it at submit, with the reason."""
    rcfg, tcfg = _cfgs()
    p = _ref_params()
    prompt = _tokens(rcfg, b=1, t=3)[0]
    ref = RefEngine(RefWorkload(rcfg, p, max_batch=2, cache_len=8))
    ref.submit(prompt, max_new=2)
    with pytest.raises(TypeError):
        ref.run_until_drained()
    eng = Engine(LMDecodeWorkload(tcfg, _port(p), max_batch=2, cache_len=8,
                                  device="cpu"))
    with pytest.raises(ValueError, match="1-D token ids"):
        eng.submit(prompt, max_new=2)


def test_launch_train_refuses_the_audio_family(capsys):
    """The launcher's data streams make [B, T] batches; the reference's
    launcher fails on them inside the model, the port's refuses the arch
    with exit code 2 before building anything."""
    with pytest.raises(SystemExit) as e:
        launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    assert e.value.code == 2
    assert "[B, T, 4]" in capsys.readouterr().err

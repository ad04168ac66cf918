"""The port's training path (repro_torch.models.model's losses and backward
pass, repro_torch.train.optimizer and train_step) against the reference's
(repro.models.model, repro.train), on the CPU, for the llama3-8b (SwiGLU,
GQA) and gemma-2b (GeGLU, MQA, tied embeddings, embed_scale) smoke
configs at fp32 compute, and for the MoE ones: qwen3-moe-235b-a22b (GQA,
4 experts top-2) and deepseek-v2-lite-16b (MLA, a leading dense layer,
then MoE with a shared expert). Their losses include the router's
auxiliary loss. Mamba (falcon-mamba-7b), Hymba (hymba-1.5b) and the VLM
(llama-3.2-vision-11b, its batches carrying "vision_embeds" [B, 16, 64]
rounded to bf16, as tests/test_arch_smoke.py makes them) take the loss,
gradient and train-step cases at T = 32.

The reference runs under jax.jit, as its own tests run it; its
parameters are carried across with params_from_numpy; batches are made
with numpy. Tolerances (fp32 arithmetic in both packages, summed in
other orders):
  * loss_fn: 1e-5 relative, unchunked (T = 32) and chunked (T = 2048,
    loss_chunk 512), with -1 (masked) labels;
  * gradients: each leaf within 1e-4 of that leaf's largest |g|; at
    T = 4096, and for the VLM, plus the reference's own rounding error
    there, measured by the reference alone (its fp32 gradients against
    its float64 run; the VLM's nearly one-hot cross attention puts it at
    1-2.5e-4 of a leaf's scale);
  * optimizer.update: parameters and moments within 1e-6 of each leaf's
    largest |value|, bf16 moments within one bf16 step (2^-8) of it, since
    an fp32 value one ulp apart may round to the neighbouring bf16;
    global_norm, cosine_lr: 1e-6 relative;
  * five train steps: losses (and the first step's gradient norm) within
    1e-4 relative.
The three remat policies give bit-identical gradients in the port.
"""
import dataclasses
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
from repro.train import optimizer as ropt  # noqa: E402
from repro.train import train_step as rts  # noqa: E402

from repro_torch import configs as tc  # noqa: E402
from repro_torch.configs import RunConfig as TRun, ShapeConfig as TShape  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import params as tp  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["llama3-8b", "gemma-2b"]
MOE = ["deepseek-v2-lite-16b", "qwen3-moe-235b-a22b"]
SSM_VLM = ["falcon-mamba-7b", "hymba-1.5b", "llama-3.2-vision-11b"]
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
OPT_RTOL = 1e-6
BF16_STEP = 2.0 ** -8
STEP_RTOL = 1e-4


def _cfgs(arch, **kw):
    r = dataclasses.replace(rc.smoke_config(rc.get_config(arch)),
                            compute_dtype="float32", **kw)
    t = dataclasses.replace(tc.smoke_config(tc.get_config(arch)),
                            compute_dtype="float32", **kw)
    return r, t


def _params(rcfg, seed=0):
    p = rp.init_params(rm.model_spec(rcfg), jax.random.key(seed))
    return p, tp.params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")


def _batch(cfg, b, t, seed=0, masked=True):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)
    if masked:
        labels[rng.random((b, t)) < 0.1] = -1
        labels[0, :5] = -1
    out = {"tokens": tokens, "labels": labels}
    if cfg.n_cross_layers:   # bf16 values, held as fp32 in both packages
        ve = rng.normal(size=(b, cfg.vision_seq, cfg.d_model))
        out["vision_embeds"] = np.array(jnp.asarray(
            ve, jnp.bfloat16).astype(jnp.float32))
    return out


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_grads(params, cfg, batch, policy=None):
    live = tp.tree_map(lambda x: x.clone().requires_grad_(), params)
    loss = tm.loss_fn(live, cfg, _tbatch(batch), remat_policy=policy)
    return loss, torch.autograd.grad(loss, tp.tree_leaves(live))


_ref_loss = jax.jit(lambda p, cfg, batch: rm.loss_fn(p, cfg, batch),
                    static_argnums=1)
_ref_grads = jax.jit(jax.value_and_grad(
    lambda p, cfg, batch: rm.loss_fn(p, cfg, batch)), static_argnums=1)


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------
# the MoE families at T 2048 only as deepseek-v2-lite-16b (MLA, MoE and
# dense_blocks): the chunked loss is shared code
_LOSS_CASES = [(a, 2, 32) for a in ARCHS + MOE + SSM_VLM] + [
    (a, 1, 2048) for a in ARCHS + MOE[:1]]


@pytest.mark.parametrize("arch,b,t", _LOSS_CASES,
                         ids=[f"{b}-{t}-{a}" for a, b, t in _LOSS_CASES])
def test_loss_matches_reference(arch, b, t):
    rcfg, tcfg = _cfgs(arch)
    rparams, tparams = _params(rcfg)
    batch = _batch(tcfg, b, t, seed=t)
    want = float(_ref_loss(rparams, rcfg, batch))
    with torch.no_grad():
        got = float(tm.loss_fn(tparams, tcfg, _tbatch(batch)))
    assert np.isfinite(got)
    assert abs(got - want) <= LOSS_RTOL * abs(want), (got, want)


def test_xent_pieces_match_reference():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 16, 40)).astype(np.float32) * 3
    labels = rng.integers(-1, 40, (2, 16)).astype(np.int32)
    labels[1] = -1
    want = rm._xent_sums(jnp.asarray(logits), jnp.asarray(labels))
    got = tm._xent_sums(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose([float(x) for x in got],
                               [float(x) for x in want], rtol=LOSS_RTOL)
    want = float(rm.xent_loss(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(tm.xent_loss(torch.from_numpy(logits),
                             torch.from_numpy(labels)))
    assert abs(got - want) <= LOSS_RTOL * abs(want)
    # every label masked: the count clamps to 1, the loss is 0
    none = torch.full((2, 16), -1, dtype=torch.int32)
    assert float(tm.xent_loss(torch.from_numpy(logits), none)) == 0.0


def test_chunked_loss_equals_unchunked():
    """The same hidden states through the chunked head and the full one."""
    _, tcfg = _cfgs("gemma-2b")
    _, tparams = _params(_cfgs("gemma-2b")[0])
    batch = _tbatch(_batch(tcfg, 1, 2048, seed=5))
    with torch.no_grad():
        h = tm.forward(tparams, tcfg, batch["tokens"],
                       return_hidden=True).logits
        assert h.shape == (1, 2048, tcfg.d_model)
        full = tm.xent_loss(tm.logits_fn(tparams, tcfg, h, torch.float32),
                            batch["labels"])
        chunked = tm.chunked_xent_loss(tparams, tcfg, h, batch["labels"],
                                       chunk=512)
    assert abs(float(full) - float(chunked)) <= LOSS_RTOL * abs(float(full))


_REF_X64 = """
import dataclasses, sys
import jax, numpy as np
from repro import configs as rc
from repro.models import model as rm, params as rp
arch, n_layers, src, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
cfg = dataclasses.replace(rc.smoke_config(rc.get_config(arch)),
                          compute_dtype="float64", n_layers=n_layers)
data = np.load(src)
shape = jax.eval_shape(lambda: rp.init_params(rm.model_spec(cfg),
                                              jax.random.key(0)))
n = len(jax.tree.leaves(shape))
params = jax.tree.unflatten(jax.tree.structure(shape), [
    data[f"p{i}"].astype(np.float64) for i in range(n)])
batch = {k: data[k] for k in ("tokens", "labels", "vision_embeds")
         if k in data}
grads = jax.grad(lambda p: rm.loss_fn(p, cfg, batch))(params)
assert jax.tree.leaves(grads)[0].dtype == np.float64
np.savez(out, *[np.asarray(g) for g in jax.tree.leaves(grads)])
"""


def _ref_grads_x64(arch, n_layers, rparams, batch, tmp):
    """The reference's gradients in float64 (JAX_ENABLE_X64 in a process
    of its own), from the same fp32 parameters and batch."""
    src, out = tmp / "in.npz", tmp / "out.npz"
    np.savez(src, **batch, **{f"p{i}": np.asarray(x)
                              for i, x in enumerate(jax.tree.leaves(rparams))})
    p = subprocess.run(
        [sys.executable, "-c", _REF_X64, arch, str(n_layers), str(src),
         str(out)], capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "JAX_PLATFORMS": "cpu", "JAX_ENABLE_X64": "1"})
    assert p.returncode == 0, p.stderr
    data = np.load(out)
    return [data[f"arr_{i}"] for i in range(len(data.files))]


@pytest.mark.parametrize("arch,b,t", [("llama3-8b", 2, 32),
                                      ("gemma-2b", 2, 32),
                                      ("gemma-2b", 1, 4096),
                                      ("deepseek-v2-lite-16b", 2, 32),
                                      ("qwen3-moe-235b-a22b", 2, 32)]
                         + [(a, 2, 32) for a in SSM_VLM])
def test_grads_match_reference(arch, b, t, tmp_path):
    """T = 4096 (at one layer) takes the checkpointed query blocks (chunk
    512) and the chunked loss. There a gradient sums 4096 positions, so the
    tolerance adds, leaf by leaf, the distance of the reference's fp32
    gradients from the reference's own float64 run (about 1e-5 of a leaf's
    largest |g|; the port lies within about 7e-5 of the reference's fp32)."""
    n_layers = 1 if t > 32 else 2
    rcfg, tcfg = _cfgs(arch, n_layers=n_layers)
    rparams, tparams = _params(rcfg)
    batch = _batch(tcfg, b, t, seed=t + 1)
    want_l, want_g = _ref_grads(rparams, rcfg, batch)
    got_l, got_g = _port_grads(tparams, tcfg, batch,
                               tm.nothing_saveable if t > 32 else None)
    got_l = float(got_l.detach())
    assert abs(got_l - float(want_l)) <= LOSS_RTOL * abs(float(want_l))
    want_g = [np.asarray(w) for w in jax.tree.leaves(want_g)]
    ref_err = [0.0] * len(want_g)
    if t > 32 or rcfg.n_cross_layers:
        g64 = _ref_grads_x64(arch, n_layers, rparams, batch, tmp_path)
        assert len(g64) == len(want_g)
        ref_err = [np.abs(w - g).max() for w, g in zip(want_g, g64)]
    assert len(got_g) == len(want_g)
    for g, w, e in zip(got_g, want_g, ref_err):
        assert g.shape == w.shape
        scale = np.abs(w).max()
        assert scale > 0
        assert np.abs(g.numpy() - w).max() <= GRAD_TOL * scale + e


@pytest.mark.parametrize("arch,t", [("llama3-8b", 32), ("gemma-2b", 4096),
                                    ("deepseek-v2-lite-16b", 32)])
def test_remat_policies_give_identical_grads(arch, t):
    rcfg, tcfg = _cfgs(arch, n_layers=1 if t > 32 else 2)
    _, tparams = _params(rcfg)
    batch = _batch(tcfg, 1, t, seed=7)
    runs = {name: _port_grads(tparams, tcfg, batch, tts.remat_policy(name))
            for name in ("none", "dots", "full")}
    loss0, g0 = runs["none"]
    for name in ("dots", "full"):
        loss, g = runs[name]
        assert torch.equal(loss, loss0), name
        assert all(torch.equal(a, b) for a, b in zip(g, g0)), name


def test_remat_policy_names():
    aten = torch.ops.aten
    assert tts.remat_policy("none") is None
    assert tts.remat_policy("full") is tm.nothing_saveable
    dots = tts.remat_policy("dots")
    must, recompute = (torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE,
                       torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)
    assert dots(None, aten.mm.default) == must
    assert dots(None, aten.addmm.default) == must
    assert dots(None, aten.bmm.default) == recompute
    assert dots(None, aten.exp.default) == recompute
    with pytest.raises(ValueError, match="unknown remat policy"):
        tts.remat_policy("some")


class _CountProducts(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the matrix products (aten.mm) and the batched ones
    (aten.bmm) that run, forward, recomputation and backward together."""

    def __init__(self):
        super().__init__()
        self.counts = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.counts:
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v2-lite-16b"])
def test_remat_policies_recompute_what_they_do_not_save(arch):
    """dots keeps the weight products (no mm runs again, as with none:
    MLA's projections, the router and the shared experts among them) and
    recomputes the batched products (the attention's, the experts'), as
    full does; full recomputes both."""
    _, tcfg = _cfgs(arch)
    _, tparams = _params(_cfgs(arch)[0])
    batch = _batch(tcfg, 2, 32, seed=9)
    counts = {}
    for name in ("none", "dots", "full"):
        with _CountProducts() as mode:
            _port_grads(tparams, tcfg, batch, tts.remat_policy(name))
        counts[name] = mode.counts
    none, dots, full = counts["none"], counts["dots"], counts["full"]
    assert dots["mm"] == none["mm"] < full["mm"], counts
    assert none["bmm"] < dots["bmm"] == full["bmm"], counts


def test_attention_blocks_are_checkpointed_only_under_autograd():
    """The chunked attention's forward values do not depend on autograd."""
    _, tcfg = _cfgs("gemma-2b")
    _, tparams = _params(_cfgs("gemma-2b")[0])
    tokens = torch.from_numpy(_batch(tcfg, 1, 4096, seed=2)["tokens"])
    with torch.no_grad():
        want = tm.forward(tparams, tcfg, tokens).logits
    live = tp.tree_map(lambda x: x.clone().requires_grad_(), tparams)
    got = tm.forward(live, tcfg, tokens).logits
    assert torch.equal(got.detach(), want)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def _random_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.normal(size=(8, 16)).astype(np.float32)},
            "b": rng.normal(size=(33,)).astype(np.float32),
            "c": {"x": rng.normal(size=(4, 3, 5)).astype(np.float32),
                  "y": rng.normal(size=(2,)).astype(np.float32) * 1e-3}}


def _np_tree(tree):
    return tp.tree_map(lambda x: np.asarray(x.float() if isinstance(
        x, torch.Tensor) else jnp.asarray(x, jnp.float32)), tree)


def _t(tree):
    return tp.tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _leaf_close(got, want, tol):
    """Within tol of the leaf's largest |value| (an element summed from
    terms of opposite signs may be near zero, where a relative bound
    would measure the cancellation, not the update)."""
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_update_matches_reference(moments, clip):
    params = _random_tree(0)
    rstate = ropt.init(params, getattr(jnp, moments))
    tstate = topt.init(_t(params), getattr(torch, moments))
    tparams = _t(params)
    rparams = jax.tree.map(jnp.asarray, params)
    rupdate = jax.jit(lambda p, g, s, lr: ropt.update(p, g, s, lr=lr,
                                                      clip=clip))
    for step in range(4):
        grads = tp.tree_map(lambda x: x * (step + 1), _random_tree(10 + step))
        lr = float(ropt.cosine_lr(jnp.int32(step), peak=3e-3, warmup=2))
        rparams, rstate, rmet = rupdate(rparams, grads, rstate, lr)
        tparams, tstate, tmet = topt.update(
            tparams, _t(grads), tstate, lr=torch.tensor(lr), clip=clip)
    assert int(tstate.step) == int(rstate.step) == 4
    assert tstate.step.dtype == torch.int32
    for k in ("grad_norm", "clip_scale"):
        np.testing.assert_allclose(float(tmet[k]), float(rmet[k]),
                                   rtol=OPT_RTOL)
    for got, want in zip(tp.tree_leaves(_np_tree(tparams)),
                         tp.tree_leaves(_np_tree(rparams))):
        _leaf_close(got, want, OPT_RTOL)
    mom_tol = OPT_RTOL if moments == "float32" else BF16_STEP
    for got_t, want_t in ((tstate.m, rstate.m), (tstate.v, rstate.v)):
        assert all(x.dtype == getattr(torch, moments)
                   for x in tp.tree_leaves(got_t))
        for got, want in zip(tp.tree_leaves(_np_tree(got_t)),
                             tp.tree_leaves(_np_tree(want_t))):
            _leaf_close(got, want, mom_tol)


def test_update_writes_in_place():
    params = _t(_random_tree(1))
    before = [x.data_ptr() for x in tp.tree_leaves(params)]
    state = topt.init(params)
    moments = [x.data_ptr() for x in tp.tree_leaves(state.m)]
    new, nstate, _ = topt.update(params, _t(_random_tree(2)), state, lr=1e-2)
    assert [x.data_ptr() for x in tp.tree_leaves(new)] == before
    assert [x.data_ptr() for x in tp.tree_leaves(nstate.m)] == moments
    assert not torch.equal(tp.tree_leaves(new)[0],
                           _t(_random_tree(1))["a"]["w"])


def test_global_norm_and_cosine_lr_match_reference():
    tree = _random_tree(4)
    np.testing.assert_allclose(float(topt.global_norm(_t(tree))),
                               float(ropt.global_norm(tree)), rtol=OPT_RTOL)
    for warmup, total in ((100, 10000), (5, 40), (20, 10)):
        for s in (0, 1, 4, 5, 19, 20, 50, 99, 100, 5000, 9999, 12000):
            want = float(ropt.cosine_lr(jnp.int32(s), peak=1e-3,
                                        warmup=warmup, total=total))
            got = topt.cosine_lr(torch.tensor(s, dtype=torch.int32),
                                 peak=1e-3, warmup=warmup, total=total)
            assert got.dtype == torch.float32
            assert abs(float(got) - want) <= OPT_RTOL * want, (s, got, want)
            assert float(topt.cosine_lr(s, peak=1e-3, warmup=warmup,
                                        total=total)) == float(got)


def test_abstract_state_is_meta():
    spec = tm.model_spec(_cfgs("llama3-8b")[1])
    st = topt.abstract_state(tp.abstract_params(spec), torch.bfloat16)
    assert st.step.device.type == "meta" and st.step.dtype == torch.int32
    leaves = tp.tree_leaves(st.m) + tp.tree_leaves(st.v)
    assert all(x.device.type == "meta" and x.dtype == torch.bfloat16
               for x in leaves)
    assert [tuple(x.shape) for x in tp.tree_leaves(st.m)] == [
        tuple(s.shape) for s in tp.tree_leaves(spec)]


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
def _runs(rcfg, tcfg, **kw):
    kw = {"remat": "none", "learning_rate": 3e-3, "lr_warmup": 2, **kw}
    return (RRun(model=rcfg, shape=RShape("t", 32, 4, "train"), **kw),
            TRun(model=tcfg, shape=TShape("t", 32, 4, "train"), **kw))


@pytest.mark.parametrize("arch", ARCHS + MOE[:1] + SSM_VLM)
def test_five_train_steps_match_reference(arch):
    rcfg, tcfg = _cfgs(arch)
    rparams, tparams = _params(rcfg)
    # RunConfig's default learning rate: at the CLI's 3e-3, AdamW's early
    # steps (m / sqrt(v) about sign(g)) move a near-zero gradient's weight
    # by 2 lr when rounding flips its sign, and gemma's loss parts by 2e-4
    # at the fourth step
    rrun, trun = _runs(rcfg, tcfg, remat="full", learning_rate=3e-4)
    rstep = jax.jit(rts.make_train_step(rcfg, rrun))
    tstep = tts.make_train_step(tcfg, trun)
    ropt_s, topt_s = ropt.init(rparams), topt.init(tparams)
    for i in range(5):
        batch = _batch(tcfg, 4, 32, seed=100 + i)
        rparams, ropt_s, rmet = rstep(rparams, ropt_s, batch)
        tparams, topt_s, tmet = tstep(tparams, topt_s, batch)
        # grad_norm only at the first step: after an update, AdamW's
        # m / sqrt(v) (about sign(g) early on) turns rounding-sized
        # differences of a near-zero gradient into lr-sized ones
        for k in ("loss", "lr") + (("grad_norm",) if i == 0 else ()):
            want = float(rmet[k])
            assert abs(float(tmet[k]) - want) <= STEP_RTOL * abs(want), (
                i, k, float(tmet[k]), want)
    assert set(tmet) == {"loss", "lr", "grad_norm", "clip_scale"}


def test_microbatches_agree():
    """microbatches=2 against 1 in the port (the reference's
    test_microbatched_grads_match), and against the reference's
    microbatched step."""
    rcfg, tcfg = _cfgs("llama3-8b")
    rparams, tparams = _params(rcfg)
    batch = _batch(tcfg, 4, 32, seed=11, masked=False)
    out = {}
    for m in (1, 2):
        _, trun = _runs(rcfg, tcfg, microbatches=m)
        p = tp.tree_map(torch.clone, tparams)
        p, _, met = tts.make_train_step(tcfg, trun)(p, topt.init(p), batch)
        out[m] = (float(met["loss"]), float(met["grad_norm"]), p)
    assert abs(out[2][0] - out[1][0]) <= LOSS_RTOL * out[1][0]
    assert abs(out[2][1] - out[1][1]) <= GRAD_TOL * out[1][1]
    for a, b in zip(tp.tree_leaves(out[1][2]), tp.tree_leaves(out[2][2])):
        assert float((a - b).abs().max()) < 1e-5
    rrun, _ = _runs(rcfg, tcfg, microbatches=2)
    _, _, rmet = jax.jit(rts.make_train_step(rcfg, rrun))(
        rparams, ropt.init(rparams), batch)
    assert abs(out[2][0] - float(rmet["loss"])) <= LOSS_RTOL * out[2][0]


def test_prefill_and_decode_steps_match_the_model():
    rcfg, tcfg = _cfgs("gemma-2b")
    _, tparams = _params(rcfg)
    tokens = torch.from_numpy(_batch(tcfg, 2, 16, seed=1)["tokens"])
    last, caches = tts.make_prefill_step(tcfg)(tparams, tokens)
    with torch.no_grad():
        full = tm.forward(tparams, tcfg, tokens, mode="prefill")
    assert torch.equal(last, full.logits[:, -1:])
    dcaches = tm.init_caches(tcfg, 2, 16, dt=torch.float32, device="cpu")
    got, _ = tts.make_decode_step(tcfg)(tparams, tokens[:, :1], dcaches, 0)
    want, _ = tm.decode_step(tparams, tcfg, tokens[:, :1], dcaches, 0)
    assert torch.equal(got, want)
    # the VLM's prefill step takes the vision embeddings
    vcfg = _cfgs("llama-3.2-vision-11b")[1]
    _, vparams = _params(_cfgs("llama-3.2-vision-11b")[0])
    vbatch = _tbatch(_batch(vcfg, 2, 8, seed=2))
    last, caches = tts.make_prefill_step(vcfg)(
        vparams, vbatch["tokens"], vision_embeds=vbatch["vision_embeds"])
    with torch.no_grad():
        full = tm.forward(vparams, vcfg, vbatch["tokens"], mode="prefill",
                          vision_embeds=vbatch["vision_embeds"])
    assert torch.equal(last, full.logits[:, -1:])
    assert torch.equal(caches["cross"].k, full.caches["cross"].k)


def test_mesh_and_unported_families_raise():
    _, tcfg = _cfgs("llama3-8b")
    _, trun = _runs(*_cfgs("llama3-8b"))
    for make in (lambda: tts.make_train_step(tcfg, trun, mesh=object()),
                 lambda: tts.make_prefill_step(tcfg, mesh=object()),
                 lambda: tts.make_decode_step(tcfg, mesh=object())):
        with pytest.raises(NotImplementedError, match="make_constrain"):
            make()
    # Mamba, Hymba and the VLM (items 9.4 and 9.5) train, and so does the
    # audio family (9.6), on [B, T, K] tokens and labels
    for arch in SSM_VLM + ["musicgen-medium"]:
        _, cfg = _cfgs(arch)
        _, params = _params(_cfgs(arch)[0])
        batch = _batch(cfg, 1, 8)
        if cfg.n_codebooks:
            rng = np.random.default_rng(0)
            batch = {k: rng.integers(0, cfg.vocab, (1, 8, cfg.n_codebooks))
                     .astype(np.int32) for k in ("tokens", "labels")}
        with torch.no_grad():
            loss = tm.loss_fn(params, cfg, _tbatch(batch))
        assert torch.isfinite(loss)


# ---------------------------------------------------------------------------
# imports and devices
# ---------------------------------------------------------------------------
_IMPORT = """
import sys
import repro_torch.train, repro_torch.train.optimizer
import repro_torch.train.train_step, repro_torch.train.checkpoint
import repro_torch.train.loop, repro_torch.launch.train
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("forbidden:", bad)
"""


def test_train_modules_import_without_jax_or_repro():
    p = subprocess.run([sys.executable, "-c", _IMPORT], capture_output=True,
                       text=True, cwd=ROOT, timeout=120,
                       env={"PYTHONPATH": str(ROOT / "src"),
                            "PATH": "/usr/bin:/bin"})
    assert p.returncode == 0, p.stderr
    assert "forbidden: []" in p.stdout


def test_cuda_default_raises_without_cuda(monkeypatch):
    from repro_torch.launch import train as launch_train
    from repro_torch.train import loop

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs("llama3-8b")
    _, trun = _runs(*_cfgs("llama3-8b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.fit(tcfg, trun, iter(()), steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--smoke", "--steps", "1", "--device", "cuda"])

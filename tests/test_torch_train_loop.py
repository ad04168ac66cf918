"""The port's training loop and checkpoints (repro_torch.train.loop,
repro_torch.train.checkpoint), its launcher and example, against the
reference's on the CPU, and its fault tolerance: the port's versions of
tests/test_substrate.py's loop and checkpoint tests.

fit against the reference's fit: the same parameters (carried across
with params_from_numpy), the same synthetic batches (the VLM's with the
same bf16 vision embeddings), 6 steps, losses within 1e-4 relative.
Checkpoints written by either package restore in the other bit for bit,
those of Mamba, Hymba and the VLM among them.
"""
import dataclasses
import functools
import json
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as rc  # noqa: E402
from repro.configs import RunConfig as RRun, ShapeConfig as RShape  # noqa: E402
from repro.data import pipeline as rpipe  # noqa: E402
from repro.models import model as rm  # noqa: E402
from repro.models import params as rp  # noqa: E402
from repro.train import checkpoint as rckpt  # noqa: E402
from repro.train import loop as rloop  # noqa: E402
from repro.train import optimizer as ropt  # noqa: E402

from repro_torch import configs as tc  # noqa: E402
from repro_torch.configs import RunConfig as TRun, ShapeConfig as TShape  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import params as tp  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FIT_RTOL = 1e-4
SSM_VLM = ["falcon-mamba-7b", "hymba-1.5b", "llama-3.2-vision-11b"]


def _cfgs(arch="llama3-8b", dtype="float32"):
    return (dataclasses.replace(rc.smoke_config(rc.get_config(arch)),
                                compute_dtype=dtype),
            dataclasses.replace(tc.smoke_config(tc.get_config(arch)),
                                compute_dtype=dtype))


def _run(cfg, run_cls=TRun, shape_cls=TShape, **kw):
    """tests/test_substrate.py's run: batch 4 of 32 tokens, lr 3e-3."""
    kw = {"remat": "none", "learning_rate": 3e-3, "lr_warmup": 5, **kw}
    return run_cls(model=cfg, shape=shape_cls("t", 32, 4, "train"), **kw)


def _batches(cfg, seed=0, pipe=tpipe):
    """tests/test_substrate.py's batches; the VLM's with vision_embeds
    (launch/train.py's stand-in, the same values as fp32 numpy in both
    packages)."""
    base = pipe.synthetic_lm_batches(cfg.vocab, 4, 32, seed,
                                     effective_vocab=32)
    if not cfg.n_cross_layers:
        return base
    return ({**b, "vision_embeds": b["vision_embeds"].float().numpy()}
            for b in launch_train.with_vision_embeds(base, cfg, seed))


def _ref_params(rcfg, seed=0):
    return rp.init_params(rm.model_spec(rcfg), jax.random.key(seed))


def _port(tree):
    return tp.params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _fit(tmp=None, steps=6, seed=1, data_seed=1, **kw):
    _, tcfg = _cfgs()
    return tloop.fit(tcfg, _run(tcfg), _batches(tcfg, data_seed),
                     steps=steps, ckpt_dir=tmp, ckpt_every=3, seed=seed,
                     device="cpu", **kw)


# ---------------------------------------------------------------------------
# fit against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["llama3-8b", "gemma-2b",
                                  "deepseek-v2-lite-16b"] + SSM_VLM)
def test_fit_matches_reference(arch):
    """Six steps at RunConfig's default learning rate (see
    test_torch_train.py::test_five_train_steps_match_reference). The
    VLM's fp32 gradients lie 1-2.5e-4 of their scale from their float64
    values in both packages (test_torch_vlm.py), and AdamW's early steps
    move a weight by about lr whatever its gradient's size, so its losses
    are held within FIT_RTOL plus the reference's own spread: the
    distance of its run from its run on weights one ulp larger (7.8e-4
    of the loss at the sixth step, where the port lies 2.7e-4 away)."""
    rcfg, tcfg = _cfgs(arch)
    rparams = _ref_params(rcfg)
    tparams = _port(rparams)

    def ref_fit(params):
        return rloop.fit(rcfg, _run(rcfg, RRun, RShape, learning_rate=3e-4),
                         _batches(rcfg, 2, rpipe), params=params, steps=6)

    want = ref_fit(rparams)
    got = tloop.fit(tcfg, _run(tcfg, learning_rate=3e-4),
                    _batches(tcfg, 2), params=tparams, steps=6,
                    device="cpu")
    assert (got.steps_run, got.final_step) == (want.steps_run,
                                               want.final_step) == (6, 6)
    own = 0.0
    if rcfg.n_cross_layers:
        bumped = ref_fit(jax.tree.map(lambda x: x * (1 + 2.0 ** -23),
                                      _ref_params(rcfg)))
        own = np.abs(np.array(bumped.losses) - np.array(want.losses))
    assert np.all(np.abs(np.array(got.losses) - np.array(want.losses))
                  <= FIT_RTOL * np.abs(np.array(want.losses)) + own), (
        got.losses, want.losses, own)


def test_synthetic_batches_are_the_references():
    rcfg, tcfg = _cfgs()
    a, b = _batches(rcfg, 5, rpipe), _batches(tcfg, 5)
    for _ in range(3):
        x, y = next(a), next(b)
        assert set(x) == set(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


def test_fit_draws_params_from_the_seed_on_the_device():
    a, b = _fit(steps=2, seed=4), _fit(steps=2, seed=4)
    assert a.losses == b.losses
    assert _fit(steps=2, seed=5).losses != a.losses


# ---------------------------------------------------------------------------
# fault tolerance (the port's versions of tests/test_substrate.py's)
# ---------------------------------------------------------------------------
def test_train_loss_decreases():
    _, tcfg = _cfgs()
    r = tloop.fit(tcfg, _run(tcfg), _batches(tcfg, 0), steps=40,
                  device="cpu")
    assert r.losses[-1] < r.losses[0] - 1.0, r.losses[::8]


def test_fit_resume_continuity(tmp_path):
    """Kill training mid-run; resume must continue from the checkpoint."""
    r1 = _fit(tmp_path, steps=6)
    assert r1.steps_run == 6
    r2 = _fit(tmp_path, steps=10, data_seed=2)
    assert r2.resumed_from == 6
    assert r2.steps_run == 4
    assert r2.final_step == 10


def test_resume_is_the_uninterrupted_run(tmp_path):
    """Three steps, a checkpoint, a restart from it: the same losses and
    parameters, bit for bit, as six steps in one go."""
    _, tcfg = _cfgs()
    spec = tm.model_spec(tcfg)

    def params():
        return tp.init_params(spec, torch.Generator("cpu").manual_seed(3),
                              device="cpu")

    def fit(data, steps, ckpt, p):
        return tloop.fit(tcfg, _run(tcfg), data, params=p, steps=steps,
                         ckpt_dir=ckpt, ckpt_every=3, device="cpu")

    whole_p = params()
    whole = fit(_batches(tcfg, 8), 6, tmp_path / "a", whole_p)
    data = _batches(tcfg, 8)
    first = fit(data, 3, tmp_path / "b", params())
    resumed_p = params()
    second = fit(data, 6, tmp_path / "b", resumed_p)
    assert second.resumed_from == 3
    assert first.losses + second.losses == whole.losses
    for a, b in zip(tp.tree_leaves(whole_p), tp.tree_leaves(resumed_p)):
        assert torch.equal(a, b)


def test_fit_preemption_checkpoint(tmp_path):
    calls = {"n": 0}

    def on_metrics(step, m):
        calls["n"] += 1
        if calls["n"] == 2:  # simulate a SIGTERM mid-run
            os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    _, tcfg = _cfgs()
    r = tloop.fit(tcfg, _run(tcfg), _batches(tcfg, 3), steps=50,
                  ckpt_dir=tmp_path, ckpt_every=1000, seed=3,
                  on_metrics=on_metrics, device="cpu")
    assert r.steps_run <= 3
    assert tckpt.latest_step(tmp_path) == r.final_step
    assert signal.getsignal(signal.SIGTERM) is before


def test_straggler_counter(monkeypatch):
    """A step that takes 10x the others, on a clock the test drives (fit
    reads time.time() at a step's start and end)."""
    class Clock:
        def __init__(self):
            self.now, self.calls = 0.0, 0

        def time(self):
            self.calls += 1
            if self.calls % 2 == 0:   # the end of step calls // 2
                self.now += 10.0 if self.calls == 14 else 1.0
            return self.now

    monkeypatch.setattr(tloop, "time", Clock())
    assert _fit(steps=8).straggler_events == 1


def test_mesh_and_unported_families_raise():
    _, tcfg = _cfgs()
    with pytest.raises(NotImplementedError, match="make_constrain"):
        tloop.fit(tcfg, _run(tcfg), iter(()), mesh=object(), device="cpu")
    # Mamba (item 9.4) fits now, and so does the audio family (9.6), on
    # [B, T, K] batches
    _, cfg = _cfgs("falcon-mamba-7b")
    res = tloop.fit(cfg, _run(cfg), _batches(cfg), steps=1, device="cpu")
    assert res.steps_run == 1 and np.isfinite(res.losses).all()
    _, cfg = _cfgs("musicgen-medium")
    rng = np.random.default_rng(0)
    audio = ({k: rng.integers(0, cfg.vocab, (4, 32, cfg.n_codebooks))
              .astype(np.int32) for k in ("tokens", "labels")}
             for _ in iter(int, 1))
    res = tloop.fit(cfg, _run(cfg), audio, steps=1, device="cpu")
    assert res.steps_run == 1 and np.isfinite(res.losses).all()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _state(moments="float32", arch="llama3-8b"):
    """The reference's {"params", "opt"} after one update (nonzero
    moments and step) and the port's copy of it (the tests only read
    them)."""
    rcfg, _ = _cfgs(arch)
    p = _ref_params(rcfg)
    g = jax.tree.map(lambda x: jnp.full_like(x, 0.01), p)
    p, o, _ = jax.jit(functools.partial(ropt.update, lr=1e-2))(
        p, g, ropt.init(p, getattr(jnp, moments)))
    tstate = {"params": _port(p), "opt": topt.AdamWState(
        step=torch.tensor(int(o.step), dtype=torch.int32),
        m=_port(o.m), v=_port(o.v))}
    return {"params": p, "opt": o}, tstate


def _same(port_tree, ref_tree):
    pl = tckpt._flatten(port_tree)[1]
    rl = jax.tree.leaves(ref_tree)
    assert len(pl) == len(rl)
    for a, b in zip(pl, rl):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16).numpy(), b.view(np.int16)
        np.testing.assert_array_equal(np.asarray(a), b)


def test_keys_are_the_references():
    ref, port = _state()
    assert tckpt._flatten(port)[0] == rckpt._flatten(ref)[0]
    keys = tckpt._flatten(port)[0]
    assert keys[0] == "['opt']/.step"
    assert "['opt']/.m/['blocks']/['attn']/['wq']" in keys
    assert "['params']/['final_norm']/['scale']" in keys
    assert keys[-1] == "['params']/['head']"


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_in_port(tmp_path, moments):
    ref, port = _state(moments)
    rckpt.save(tmp_path, 7, ref)
    assert tckpt.latest_step(tmp_path) == 7
    _same(tckpt.restore(tmp_path, 7, port, device="cpu"), ref)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_port_checkpoint_is_the_references(tmp_path, moments):
    """The same manifest and arrays as the reference writes; an fp32 one
    restores in the reference (whose restore cannot read bfloat16 from
    an npz, its own or the port's)."""
    ref, port = _state(moments)
    rckpt.save(tmp_path / "ref", 7, ref)
    tckpt.save(tmp_path / "port", 7, port)
    step = "step_00000007"
    mr = json.loads((tmp_path / "ref" / step / "manifest.json").read_text())
    mp = json.loads((tmp_path / "port" / step / "manifest.json").read_text())
    assert mp == mr
    with np.load(tmp_path / "ref" / step / "proc_0.npz") as a, \
            np.load(tmp_path / "port" / step / "proc_0.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes()
    assert (tmp_path / "port" / step / "COMMITTED").read_text() == "ok"
    if moments == "float32":
        _same(port, rckpt.restore(tmp_path / "port", 7, ref))


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "qwen3-moe-235b-a22b"])
def test_moe_checkpoints_interchange_both_ways(tmp_path, arch):
    """The MoE families' trees (deepseek's ``dense_blocks``, the experts,
    the router, MLA's latent projections) under the reference's keys: a
    reference checkpoint restores in the port, and the port's is the
    reference's, file for file, and restores in the reference."""
    ref, port = _state("float32", arch)
    keys = tckpt._flatten(port)[0]
    assert keys == rckpt._flatten(ref)[0]
    assert "['params']/['blocks']/['ffn']/['router']" in keys
    assert (("['params']/['dense_blocks']/['attn']/['wdkv']" in keys)
            == (arch == "deepseek-v2-lite-16b"))
    rckpt.save(tmp_path / "ref", 4, ref)
    _same(tckpt.restore(tmp_path / "ref", 4, port, device="cpu"), ref)
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
    _same(port, rckpt.restore(tmp_path / "port", 4, ref))


@pytest.mark.parametrize("arch", SSM_VLM)
def test_ssm_and_vlm_checkpoints_interchange_both_ways(tmp_path, arch):
    """The trees of Mamba (``blocks.mamba.*``), Hymba (``norm_a``,
    ``norm_m`` beside ``attn`` and ``mamba``) and the VLM
    (``cross_blocks``, ``self_blocks``) under the reference's keys, both
    ways, file for file."""
    ref, port = _state("float32", arch)
    keys = tckpt._flatten(port)[0]
    assert keys == rckpt._flatten(ref)[0]
    want = {"falcon-mamba-7b": "['params']/['blocks']/['mamba']/['a_log']",
            "hymba-1.5b": "['params']/['blocks']/['norm_m']/['scale']",
            "llama-3.2-vision-11b":
                "['params']/['cross_blocks']/['attn']/['wk']"}[arch]
    assert want in keys
    rckpt.save(tmp_path / "ref", 4, ref)
    _same(tckpt.restore(tmp_path / "ref", 4, port, device="cpu"), ref)
    tckpt.save(tmp_path / "port", 4, port)
    step = "step_00000004"
    with np.load(tmp_path / "ref" / step / "proc_0.npz") as a, \
            np.load(tmp_path / "port" / step / "proc_0.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(a[k].tobytes() == b[k].tobytes() for k in a.files)
    _same(port, rckpt.restore(tmp_path / "port", 4, ref))


def test_restore_onto_meta_target_and_errors(tmp_path):
    ref, port = _state()
    tckpt.save(tmp_path, 3, port)
    meta = tp.tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                             device="meta"), port["params"])
    got = tckpt.restore(tmp_path, 3, {"params": meta, "opt": port["opt"]},
                        device="cpu")
    _same(got, ref)
    with pytest.raises(FileNotFoundError):
        tckpt.restore(tmp_path, 4, port, device="cpu")
    with pytest.raises(ValueError, match="mismatch"):
        tckpt.restore(tmp_path, 3, {"params": port["params"]}, device="cpu")
    assert tckpt.latest_step(tmp_path / "none") is None


def test_checkpoint_async_writers_serialised(tmp_path):
    """Five async saves with keep=2, only the last thread joined: every
    writer ran and each GC saw the steps before it, so exactly [4, 5] are
    left, run after run (the reference's writers race here)."""
    _, port = _state()
    for run in range(5):
        d = tmp_path / f"run{run}"
        t = None
        for s in (1, 2, 3, 4, 5):
            t = tckpt.save(d, s, {"p": port["params"]}, keep=2, async_=True)
        t.join(timeout=60)
        assert not t.is_alive()
        steps = sorted(int(x.name.split("_")[1]) for x in d.glob("step_*"))
        assert steps == [4, 5], (run, steps)
        assert not list(d.glob(".tmp_step_*"))


def test_checkpoint_writers_wait_only_within_a_directory(tmp_path,
                                                        monkeypatch):
    """A save into one directory does not wait for a writer still busy
    in another; the held writer then finishes its own step."""
    _, port = _state()
    held, release = tmp_path / "held", threading.Event()
    gc = tckpt._gc

    def slow_gc(ckpt_dir, keep):
        if ckpt_dir == held:
            assert release.wait(timeout=60)
        gc(ckpt_dir, keep)

    monkeypatch.setattr(tckpt, "_gc", slow_gc)
    t = tckpt.save(held, 1, {"p": port["params"]}, async_=True)
    try:
        assert tckpt.save(tmp_path / "other", 1, {"p": port["params"]}) is None
        assert tckpt.latest_step(tmp_path / "other") == 1
        assert t.is_alive()
    finally:
        release.set()
        t.join(timeout=60)
    assert not t.is_alive()
    assert tckpt.latest_step(held) == 1


# ---------------------------------------------------------------------------
# the launcher and the example
# ---------------------------------------------------------------------------
def _python(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=300)


def test_launch_train_cli():
    p = _python("-m", "repro_torch.launch.train", "--smoke", "--steps", "3",
                "--device", "cpu")
    assert p.returncode == 0, p.stderr
    assert "step     0 loss" in p.stdout
    assert "done: 3 steps, final loss" in p.stdout
    assert "resumed_from None" in p.stdout


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b"])
def test_launch_train_takes_the_moe_families(arch, tmp_path, capsys):
    """The launcher's fit, checkpoints and resume on qwen3-moe (deepseek
    runs fit in test_fit_matches_reference)."""
    args = ["--smoke", "--device", "cpu", "--arch", arch, "--batch", "2",
            "--seq", "32", "--remat", "dots", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    r = launch_train.main(args + ["--steps", "2"])
    assert r.steps_run == 2 and np.isfinite(r.losses).all()
    r = launch_train.main(args + ["--steps", "3"])
    assert r.resumed_from == 2 and r.steps_run == 1
    assert "done: 1 steps, final loss" in capsys.readouterr().out


@pytest.mark.parametrize("arch", SSM_VLM)
def test_launch_train_takes_the_ssm_and_vlm_families(arch, capsys):
    """``--arch`` of Mamba, Hymba and the VLM (its batches carrying the
    launcher's stand-in vision embeddings), remat "full"."""
    r = launch_train.main(["--smoke", "--device", "cpu", "--arch", arch,
                           "--batch", "2", "--seq", "32", "--remat", "full",
                           "--steps", "2"])
    assert r.steps_run == 2 and np.isfinite(r.losses).all()
    assert "done: 2 steps, final loss" in capsys.readouterr().out


def test_launch_train_resumes_and_takes_morph_data(tmp_path, capsys):
    args = ["--smoke", "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2", "--batch", "2", "--seq", "32",
            "--remat", "full", "--microbatches", "2"]
    r = launch_train.main(args + ["--steps", "2"])
    assert r.steps_run == 2 and tckpt.latest_step(tmp_path) == 2
    r = launch_train.main(args + ["--steps", "3"])
    assert r.resumed_from == 2 and r.steps_run == 1
    assert "resumed_from 2" in capsys.readouterr().out
    r = launch_train.main(["--smoke", "--device", "cpu", "--steps", "2",
                           "--batch", "2", "--seq", "32", "--morph-data"])
    assert r.steps_run == 2 and np.isfinite(r.losses).all()


def test_torch_train_lm_example():
    p = _python("examples/torch_train_lm.py", "--steps", "3", "--layers",
                "2", "--d-model", "64", "--device", "cpu")
    assert p.returncode == 0, p.stderr
    assert "over 3 steps" in p.stdout

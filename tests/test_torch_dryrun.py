"""The port's dry run (repro_torch.launch.dryrun, launch/input_specs.py)
against the reference's pieces that can run without its mesh, on the CPU.

The reference's dry run lowers every cell onto a 256- or 512-chip mesh
through sharding functions that ``repro.dist.sharding`` lacks, so it
cannot run; its mesh-free parts are arithmetic and are held here: the
cache shapes (``jax.eval_shape`` of its init_caches), count_params,
active_params and the moment dtype (``repro.launch.dryrun``, run in a
subprocess, since importing it sets XLA_FLAGS for the whole process),
and ``repro.launch.hlo_analysis``'s model_flops and roofline terms,
with its TPU peaks swapped for the H100's. The port's counts on the
meta device (FLOPs, bytes moved, bytes kept for the backward pass) are
held against a full-depth count and, for the bytes a step keeps, on a
function whose saved tensors are known.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from repro import configs as rc  # noqa: E402
from repro.launch import hlo_analysis  # noqa: E402
from repro.models import model as rm  # noqa: E402
from repro.models import params as rp  # noqa: E402

from repro_torch import configs as tc  # noqa: E402
from repro_torch import device as devmod  # noqa: E402
from repro_torch.configs import SHAPES  # noqa: E402
from repro_torch.launch import dryrun, input_specs  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import params as tp  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(tc.ARCHS)
DECODE_CELLS = [(a, s) for a, s in dryrun.cells(all_=True)
                if SHAPES[s].kind == "decode"]
RECORD_KEYS = {"arch", "shape", "kind", "tokens_per_step", "params_total",
               "params_active", "model_flops", "flops", "bytes", "memory",
               "fits", "roofline", "hbm_bytes"}
MEMORY_KEYS = {"params", "grads", "moments", "caches", "batch", "arguments",
               "resident", "kept", "peak"}


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "JAX_PLATFORMS": "cpu"}


def _leaves(tree):
    """A tree's leaves in the reference's order: dict keys sorted,
    (Named)tuples in field order, () empty."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for part in tree for x in _leaves(part)]
    return [tree]


def test_cells_are_the_references_suite():
    """10 archs x 3 shapes, plus long_500k for the SSM and hybrid ones."""
    cells = dryrun.cells(all_=True)
    assert len(cells) == 32
    want = [(a, s) for a in sorted(rc.ARCHS)
            for s in rc.shapes_for(rc.get_config(a))]
    assert cells == want
    assert [c for c in cells if c[1] == "long_500k"] == [
        ("falcon-mamba-7b", "long_500k"), ("hymba-1.5b", "long_500k")]


@pytest.mark.parametrize("arch,shape", DECODE_CELLS,
                         ids=[f"{a}-{s}" for a, s in DECODE_CELLS])
def test_decode_cell_caches_are_the_references(arch, shape):
    """Every decode cell's meta caches at full width: the shapes and dtypes
    of jax.eval_shape(init_caches(...)), leaf for leaf."""
    cfg, sh = tc.get_config(arch), SHAPES[shape]
    args = input_specs.decode_specs(cfg, sh)
    want = jax.eval_shape(lambda: rm.init_caches(
        rc.get_config(arch), sh.global_batch, cache_len=sh.seq_len))
    got, ref = _leaves(args["caches"]), jax.tree.leaves(want)
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert a.device.type == "meta"
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
    k = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    assert tuple(args["tokens"].shape) == (sh.global_batch, 1, *k)
    assert args["pos"] == sh.seq_len - 1


def test_meta_is_accepted_only_when_asked_for():
    assert devmod.resolve("meta").type == "meta"
    assert devmod.DEFAULT_DEVICE == "cuda"
    with pytest.raises(ValueError, match="not"):
        devmod.resolve("mps")


def test_batch_and_prefill_specs_are_the_references():
    """The reference's tokens [b, s] (or [b, s, K]) int32 and the VLM's
    vision_embeds [b, vision_seq, d] bf16."""
    for arch in ("musicgen-medium", "llama-3.2-vision-11b", "gemma-2b"):
        cfg, sh = tc.get_config(arch), SHAPES["train_4k"]
        k = (cfg.n_codebooks,) if cfg.n_codebooks else ()
        batch = input_specs.batch_specs(cfg, sh)
        pre = input_specs.prefill_specs(cfg, SHAPES["prefill_32k"])
        assert sorted(batch) == sorted(
            ["tokens", "labels"] + (["vision_embeds"] if cfg.n_cross_layers
                                    else []))
        for name in ("tokens", "labels"):
            assert tuple(batch[name].shape) == (256, 4096, *k)
            assert batch[name].dtype == torch.int32
        assert tuple(pre["tokens"].shape) == (32, 32768, *k)
        if cfg.n_cross_layers:
            assert tuple(pre["vision_embeds"].shape) == (32, 1601, 4096)
            assert pre["vision_embeds"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_is_the_references(arch):
    want = rp.count_params(rm.model_spec(rc.get_config(arch)))
    assert tp.count_params(tm.model_spec(tc.get_config(arch))) == want
    params, opt = dryrun._abstract_state(tc.get_config(arch))
    assert tp.count_params(params) == want
    assert all(x.device.type == "meta" for x in tp.tree_leaves(params))


_REF_META = r"""
import json
import jax.numpy as jnp
from repro import configs
from repro.launch import dryrun
print(json.dumps({a: [dryrun.active_params(configs.get_config(a)),
                      jnp.dtype(dryrun._moments_dtype(configs.get_config(a))).name,
                      jnp.dtype(dryrun._param_dtype(configs.get_config(a))).name]
                  for a in configs.ARCHS}))
"""


def test_active_params_and_dtypes_are_the_references():
    """repro.launch.dryrun's active_params, _moments_dtype and
    _param_dtype for all ten archs, in a process of their own."""
    p = subprocess.run([sys.executable, "-c", _REF_META], capture_output=True,
                       text=True, cwd=ROOT, env=_env(), timeout=300)
    assert p.returncode == 0, p.stderr
    want = json.loads(p.stdout.strip().splitlines()[-1])
    assert sorted(want) == ARCHS
    assert want["qwen3-moe-235b-a22b"][1] == "bfloat16"
    for arch, (active, moments, param) in want.items():
        cfg = tc.get_config(arch)
        assert dryrun.active_params(cfg) == active
        assert str(dryrun._moments_dtype(cfg)).removeprefix("torch.") == moments
        assert str(dryrun._param_dtype(cfg)).removeprefix("torch.") == param


def test_model_flops_and_roofline_are_the_references(monkeypatch):
    """The reference's formulas with its TPU v5e peaks replaced by the
    H100's data-sheet peaks."""
    for kind in ("train", "infer"):
        assert (dryrun.model_flops(1_234_567, 4096, kind)
                == hlo_analysis.model_flops(1_234_567, 4096, kind))
    monkeypatch.setattr(hlo_analysis, "PEAK_FLOPS", dryrun.PEAK_FLOPS)
    monkeypatch.setattr(hlo_analysis, "HBM_BW", dryrun.HBM_BW)
    monkeypatch.setattr(hlo_analysis, "LINK_BW", dryrun.LINK_BW)
    for flops, nbytes, wire in ((2.3e16, 2.2e14, 0.0), (1e12, 4e12, 0.0),
                                (5e15, 1e13, 3e11)):
        want = hlo_analysis.roofline_terms(flops, nbytes, wire, 1)
        assert dryrun.roofline_terms(flops, nbytes, wire, 1) == want
    assert dryrun.roofline_terms(1.0, 1.0)["collective_s"] == 0.0
    assert (dryrun.PEAK_FLOPS, dryrun.HBM_BW) == (989e12, 3.35e12)


def test_analysis_variants():
    """One unit: a layer, the VLM's group, DeepSeek's dense layer and one
    MoE layer; the multiplier reaches the full depth."""
    for arch in ARCHS:
        full = tc.get_config(arch)
        a, mult = dryrun.analysis_variant(arch, 1)
        b, _ = dryrun.analysis_variant(arch, 2)
        if full.n_cross_layers:
            assert (a.n_cross_layers, b.n_cross_layers) == (1, 2)
            assert 1 + mult == full.n_cross_layers
        else:
            assert b.n_layers - a.n_layers == 1
            assert a.n_layers + mult == full.n_layers
        assert dataclasses.replace(a, n_layers=full.n_layers,
                                   n_cross_layers=full.n_cross_layers,
                                   unroll_scans=False) == full


def test_traffic_counts_what_autograd_keeps():
    """On a function whose saved tensors are known: without
    checkpointing, exp keeps its output and the second product its input
    (one storage, counted once) and the loss is alive; checkpointed, only
    the loss; a view moves no bytes, a product its inputs and output."""
    from torch.utils.checkpoint import checkpoint

    w = torch.empty((256, 256), device="meta", requires_grad=True)
    x = torch.empty((64, 256), device="meta")

    def f(x):
        return ((x @ w).exp() @ w).sum()

    with dryrun.Traffic() as tr:
        loss = f(x)
        kept_plain = tr.live
    del loss
    with dryrun.Traffic() as tr:
        loss = checkpoint(f, x, use_reentrant=False)
        kept_ckpt = tr.live
    del loss
    assert kept_plain == 64 * 256 * 4 + 4
    assert kept_ckpt == 4
    with dryrun.Traffic() as tr:
        x.t()
        assert tr.moved == 0
        x @ w
    assert tr.moved == (64 * 256 + 256 * 256 + 64 * 256) * 4
    # a write into a storage allocated before (an update's in-place op on
    # a parameter) starts a stretch of its own
    p = torch.empty(1000, device="meta")
    with dryrun.Traffic() as tr:
        t = p * 2
        p.sub_(t)
        del t
        u = p + 1
        v = p + 2
    assert tr.segments == [4000, 8000] and tr.peak == 8000
    del u, v


def test_kept_bytes_follow_the_remat_policy():
    """gemma-2b's width at 2 layers, T 4096 (phase 10b's configuration):
    "full" keeps each layer's input, "dots" also its weight products'
    outputs, "none" everything; the card measured 2.832, 0.798 and 0.151
    GB (PERF.md §5)."""
    cfg = dataclasses.replace(tc.get_config("gemma-2b"), n_layers=2)
    batch = input_specs.batch_specs(
        cfg, tc.ShapeConfig("chip", 4096, 1, "train"))
    kept = {r: dryrun.kept_bytes(cfg, batch, r) / 1e9
            for r in ("none", "dots", "full")}
    assert kept["none"] > kept["dots"] > kept["full"] > 0
    for r, gb in (("none", 2.832), ("dots", 0.798), ("full", 0.151)):
        assert abs(kept[r] - gb) <= max(0.1 * gb, 0.05), kept


def test_extrapolation_equals_a_full_depth_count():
    """gemma-2b x train_4k: the 1-/2-unit extrapolation of FLOPs, bytes,
    kept bytes and the step's own peak equals the count over all 18
    layers."""
    shape = SHAPES["train_4k"]
    want = dryrun.step_costs(tc.get_config("gemma-2b"), shape)
    got = dryrun.analysis_costs("gemma-2b", shape)
    assert got == want
    assert want["flops"] > 0 and want["kept"] > 0


_END_TO_END = [("musicgen-medium", "train_4k"), ("gemma-2b", "prefill_32k"),
               ("llama3-8b", "decode_32k"), ("falcon-mamba-7b", "long_500k")]


@pytest.mark.parametrize("arch,shape", _END_TO_END,
                         ids=[f"{a}-{s}" for a, s in _END_TO_END])
def test_cells_run_end_to_end(arch, shape, tmp_path, capsys):
    """Through the CLI: one OK line, the summary, a record with every
    field, written under --out and nowhere under benchmarks/."""
    bench = sorted((ROOT / "benchmarks").rglob("*"))
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", arch, "--shape", shape, "--out",
                     str(tmp_path)])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert f"[dryrun] OK   {arch} × {shape} × 1xH100" in out
    assert out.strip().splitlines()[-1] == "[dryrun] 1 ok, 0 failed"
    rec = json.loads((tmp_path / f"dryrun_{arch}_{shape}_1xH100.json")
                     .read_text())
    assert RECORD_KEYS <= set(rec) and MEMORY_KEYS <= set(rec["memory"])
    cfg, sh = tc.get_config(arch), SHAPES[shape]
    mem = rec["memory"]
    assert rec["params_total"] == tp.count_params(tm.model_spec(cfg))
    assert mem["params"] == 4 * rec["params_total"]
    assert (mem["kept"] > 0) == (sh.kind == "train")
    assert (mem["caches"] > 0) == (sh.kind == "decode")
    assert mem["peak"] >= mem["resident"] > 0
    assert rec["fits"] == (mem["peak"] <= 80e9)
    assert rec["flops"] > 0 and rec["bytes"] > 0
    assert rec["roofline"]["collective_s"] == 0.0
    assert rec["roofline"]["compute_s"] == rec["flops"] / 989e12
    if sh.kind == "train":   # the model's 6 N D within the counted FLOPs
        assert mem["grads"] == mem["params"]
        assert 0.3 < rec["useful_flops_frac"] < 1.0
    assert sorted((ROOT / "benchmarks").rglob("*")) == bench


@pytest.mark.parametrize("flag", ["--multi-pod", "--both-meshes",
                                  "--profile=fsdp"])
def test_sharded_dry_run_raises_citing_item_7(flag):
    with pytest.raises(NotImplementedError, match="shard_abstract"):
        dryrun.main(["--arch", "gemma-2b", "--shape", "train_4k", flag])
    with pytest.raises(NotImplementedError, match="shard_abstract"):
        dryrun.run_cell("gemma-2b", "train_4k", multi_pod=True)


_IMPORT = r"""
import sys
import repro_torch.launch.dryrun, repro_torch.models.model
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("forbidden:", bad)
"""


def test_dryrun_imports_no_jax():
    p = subprocess.run([sys.executable, "-c", _IMPORT], capture_output=True,
                       text=True, cwd=ROOT, env=_env(), timeout=120)
    assert p.returncode == 0, p.stderr
    assert "forbidden: []" in p.stdout

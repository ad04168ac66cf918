"""Dry run of the port: every (arch x shape) cell of the suite modelled on
one NVIDIA H100 on the meta device.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--force] \
      [--out DIR] [--hbm-gb GB]

The counterpart of ``repro.launch.dryrun``, which lowers and compiles each
cell onto a 256- or 512-chip mesh. Here the port's own steps
(``train_step.make_train_step``, ``make_prefill_step``,
``make_decode_step``) are applied to parameters, optimizer state, batches
and caches on the meta device (``launch/input_specs.py``): shapes and
dtypes without storage, so nothing is allocated and no kernel launched,
and the run gives the same numbers on any machine. For each cell:

  * FLOPs, counted by ``torch.utils.flop_counter.FlopCounterMode`` over
    the step (a train step: the loss, its backward with the recomputation
    its remat policy asks for, and the AdamW update);
  * bytes: each op's tensor inputs and outputs, summed, where an op whose
    outputs alias its inputs and writes nothing (a view) moves none: an
    unfused upper bound, the counterpart of XLA's "bytes accessed" (the
    reference's fused traffic model is not ported);
  * memory: the arguments (the parameters, and for a train cell their
    gradients and AdamW moments; a decode cell's caches; the batch), the
    bytes the forward pass keeps for the backward pass under the run's
    remat policy (the storages alive once the loss is computed, each
    counted once however many views it has, what ``checkpoint`` keeps
    included), and the predicted peak: the tensors passed in, plus the
    step's own storages at their most;
  * ``fits``: the peak within ``--hbm-gb`` (80 GB);
  * ``roofline_terms`` with one chip and the H100 SXM data-sheet peaks
    (989e12 bf16 dense FLOP/s, 3.35e12 B/s); the collective term is 0 on
    one chip.

FLOPs, bytes, kept bytes and the step's own peak come from the 1- and
2-unit variants (``analysis_variant``), extrapolated in depth as the
reference does. The port runs every layer, so the extrapolation serves
speed only; the arguments are counted at full depth. A mesh
(``--multi-pod``, ``--both-meshes``) or another sharding profile raises
NotImplementedError: the reference's mesh cells call
``sharding.shard_abstract``, ``array_sharding`` and ``rules_for``, which
its ``dist/sharding.py`` does not define (ROADMAP §3).
Records go to ``--out`` (``build/repro_torch/dryrun/``), one JSON file a
cell; the CLI prints one ``[dryrun] OK`` line a cell, then ``[dryrun] N
ok, M failed``, and exits 1 if a cell failed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.configs import SHAPES, RunConfig, shapes_for
from repro_torch.launch import input_specs
from repro_torch.models import model as model_mod
from repro_torch.models import params as pm
from repro_torch.train import optimizer, train_step as ts

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch" / "dryrun"

# NVIDIA H100 SXM 80GB, data-sheet peaks
DEVICE_NAME = "NVIDIA H100 80GB HBM3"
PEAK_FLOPS = 989e12          # bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12             # B/s
LINK_BW = 450e9              # NVLink 4, B/s a direction
HBM_GB = 80.0

MESH_NOT_PORTED = ("the dry run of a mesh ({what}) is not ported: the"
                   " reference's mesh cells call sharding.shard_abstract,"
                   " array_sharding and rules_for, which its"
                   " dist/sharding.py does not define (ROADMAP §3)")


def _moments_dtype(cfg):
    # bf16 moments keep the 235B MoE optimizer's state half as large
    return (torch.bfloat16
            if pm.count_params(model_mod.model_spec(cfg)) > 1e11
            else torch.float32)


def active_params(cfg) -> int:
    """Parameters touched per token (MoE counts top_k+shared experts)."""
    spec = model_mod.model_spec(cfg)
    total = pm.count_params(spec)
    if not cfg.is_moe:
        return total
    per_expert = 3 * cfg.d_model * cfg.d_ff_expert
    n_moe_layers = cfg.n_layers - cfg.first_dense
    routed_total = cfg.n_experts * per_expert * n_moe_layers
    routed_active = cfg.top_k * per_expert * n_moe_layers
    return total - routed_total + routed_active


def _param_dtype(cfg):
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def analysis_variant(arch: str, n_units: int):
    """A reduced-depth config for exact cost accounting -> (cfg,
    unit_multiplier): total = A + (B - A) * unit_multiplier, where A and B
    are the counts of the 1- and 2-unit variants. A unit is one layer, the
    VLM's one group (a cross block and group_self self blocks), or, after
    DeepSeek's leading dense layers, one MoE layer: its 1-unit variant
    keeps the dense layers and one MoE layer (the reference's has none,
    an empty stack, which the port's layer loop cannot stack caches of),
    so its multiplier is one less than the reference's."""
    cfg = configs.get_config(arch)
    if cfg.n_cross_layers:
        var = dataclasses.replace(
            cfg, n_cross_layers=n_units, n_layers=n_units * cfg.group_self,
            unroll_scans=True)
        return var, cfg.n_cross_layers - 1
    if cfg.first_dense:
        var = dataclasses.replace(cfg, n_layers=cfg.first_dense + n_units,
                                  unroll_scans=True)
        return var, cfg.n_layers - cfg.first_dense - 1
    var = dataclasses.replace(cfg, n_layers=n_units, unroll_scans=True)
    return var, cfg.n_layers - 1


def roofline_terms(flops: float, hbm_bytes: float,
                   wire_bytes_per_dev: float = 0.0, chips: int = 1) -> dict:
    """Three roofline terms in seconds (global FLOPs and bytes; wire bytes
    a device), at the H100's data-sheet peaks."""
    terms = {
        "compute_s": flops / (chips * PEAK_FLOPS),
        "memory_s": hbm_bytes / (chips * HBM_BW),
        "collective_s": wire_bytes_per_dev / LINK_BW,
    }
    dom = max(terms, key=terms.get)
    terms["bottleneck"] = dom.replace("_s", "")
    return terms


def model_flops(n_params_active: int, tokens: int, kind: str) -> float:
    """6·N·D for training, 2·N·D for inference forward passes."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_params_active * tokens


# ---------------------------------------------------------------------------
# counting on the meta device
# ---------------------------------------------------------------------------
def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tree_bytes(tree) -> int:
    """The bytes of a tree's tensors (dicts, tuples, NamedTuples)."""
    return sum(_nbytes(t) for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class Traffic(TorchDispatchMode):
    """Every op's bytes moved, and the bytes of the storages the ops
    allocate while they are alive.

    ``moved`` sums each op's tensor inputs and outputs, unless its outputs
    all alias its inputs and it writes nothing (a view, a detach).
    ``live`` is the bytes of the storages allocated under the mode and not
    yet freed, each counted once whatever views of it exist. A storage
    first seen as an op's input was allocated before (a parameter, a
    batch) and is not counted. Storages are followed by weak references,
    which die with the storage itself, so what autograd saves for the
    backward pass stays counted while it is saved.

    ``segments`` holds the largest ``live`` of each stretch of the run
    between two writes into a storage allocated before (an optimizer
    update's in-place ops on the parameters and moments): the same
    stretches, in the same order, at any depth, so that each extrapolates
    on its own (the update of the largest stacked leaf may overtake the
    backward pass as layers are added); ``peak`` is their largest."""

    def __init__(self):
        super().__init__()
        self.moved = 0
        self.live = 0
        self.segments = [0]
        self._known = weakref.WeakSet()
        self._external = weakref.WeakSet()

    @property
    def peak(self) -> int:
        return max(self.segments)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        for t in ins:
            st = t.untyped_storage()
            if st not in self._known:
                self._known.add(st)
                self._external.add(st)
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        fresh = False
        for t in outs:
            st = t.untyped_storage()
            if st not in self._known:
                self._known.add(st)
                n = st.nbytes()
                self.live += n
                weakref.finalize(st, self._free, n)
                fresh = True
        self.segments[-1] = max(self.segments[-1], self.live)
        mutable = func._schema.is_mutable
        if fresh or mutable:
            self.moved += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if mutable and any(t.untyped_storage() in self._external
                           for t in outs):
            self.segments.append(self.live)
        return out


def _abstract_state(cfg):
    params = pm.abstract_params(model_mod.model_spec(cfg), _param_dtype(cfg))
    return params, optimizer.abstract_state(params, _moments_dtype(cfg))


def kept_bytes(cfg, batch, remat: str) -> int:
    """The bytes the loss's forward pass keeps for the backward pass under
    remat policy ``remat`` ("none" | "dots" | "full"): its storages still
    alive once the loss is computed (the loss among them), on cfg's meta
    parameters."""
    params, _ = _abstract_state(cfg)
    live = pm.tree_map(lambda x: x.detach().requires_grad_(), params)
    with Traffic() as tr:
        loss = model_mod.loss_fn(live, cfg, batch,
                                 remat_policy=ts.remat_policy(remat))
        kept = tr.live
    del loss
    return kept


def step_costs(cfg, shape, remat: str = "full") -> dict:
    """One step of ``shape.kind`` on cfg at full (cfg's) depth, on the
    meta device -> {"flops", "bytes", "kept", "segments"}: the FLOPs, the
    bytes moved, the bytes kept for the backward pass (0 but for train)
    and the step's own allocations at their most in each of its
    stretches (Traffic.segments)."""
    params, opt = _abstract_state(cfg)
    kept = 0
    fc = FlopCounterMode(display=False)
    if shape.kind == "train":
        batch = input_specs.batch_specs(cfg, shape)
        kept = kept_bytes(cfg, batch, remat)
        step = ts.make_train_step(cfg, RunConfig(model=cfg, shape=shape,
                                                 remat=remat))
        with fc, Traffic() as tr:
            step(params, opt, batch)
    elif shape.kind == "prefill":
        args = input_specs.prefill_specs(cfg, shape)
        with fc, Traffic() as tr:
            ts.make_prefill_step(cfg)(params, args.pop("tokens"), **args)
    else:
        args = input_specs.decode_specs(cfg, shape)
        with fc, Traffic() as tr:
            ts.make_decode_step(cfg)(params, args["tokens"], args["caches"],
                                     args["pos"])
    return {"flops": float(fc.get_total_flops()), "bytes": float(tr.moved),
            "kept": float(kept), "segments": [float(x) for x in tr.segments]}


def analysis_costs(arch: str, shape, remat: str = "full") -> dict:
    """step_costs of the full depth, from the 1- and 2-unit variants."""
    cfg_a, mult = analysis_variant(arch, 1)
    cfg_b, _ = analysis_variant(arch, 2)
    a = step_costs(cfg_a, shape, remat)
    b = step_costs(cfg_b, shape, remat)
    assert len(a["segments"]) == len(b["segments"])
    out = {k: a[k] + (b[k] - a[k]) * mult
           for k in ("flops", "bytes", "kept")}
    out["segments"] = [x + (y - x) * mult
                       for x, y in zip(a["segments"], b["segments"])]
    return out


def argument_bytes(cfg, shape) -> dict:
    """The bytes of the step's arguments at full depth: parameters, and
    for train their gradients (the parameters' dtype) and AdamW state,
    for decode the caches, and the batch -> parts and their sum
    ``arguments``; ``resident`` the part passed in (all but the
    gradients, which the step allocates)."""
    params, opt = _abstract_state(cfg)
    out = {"params": tree_bytes(params), "grads": 0, "moments": 0,
           "caches": 0}
    if shape.kind == "train":
        out["grads"] = out["params"]
        out["moments"] = tree_bytes(opt)
        out["batch"] = tree_bytes(input_specs.batch_specs(cfg, shape))
    elif shape.kind == "prefill":
        out["batch"] = tree_bytes(input_specs.prefill_specs(cfg, shape))
    else:
        args = input_specs.decode_specs(cfg, shape)
        out["caches"] = tree_bytes(args["caches"])
        out["batch"] = tree_bytes(args["tokens"])
    out["arguments"] = sum(out.values())
    out["resident"] = out["arguments"] - out["grads"]
    return out


def predict(cfg, shape, *, remat: str = "full", costs=None,
            hbm_gb: float = HBM_GB) -> dict:
    """The memory, fit and roofline of one step of cfg at ``shape`` on one
    H100 (``costs``: step_costs or analysis_costs of it; by default
    step_costs at cfg's depth)."""
    costs = costs or step_costs(cfg, shape, remat)
    mem = argument_bytes(cfg, shape)
    mem["kept"] = costs["kept"]
    mem["peak"] = mem["resident"] + max(costs["segments"])
    return {"flops": costs["flops"], "bytes": costs["bytes"],
            "memory": mem, "hbm_bytes": hbm_gb * 1e9,
            "fits": mem["peak"] <= hbm_gb * 1e9,
            "roofline": roofline_terms(costs["flops"], costs["bytes"])}


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------
def _check_one_chip(multi_pod: bool, profile: str) -> None:
    if multi_pod:
        raise NotImplementedError(MESH_NOT_PORTED.format(what="2x16x16"))
    if profile != "default":
        raise NotImplementedError(MESH_NOT_PORTED.format(
            what=f"sharding profile {profile!r}"))


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             force: bool = False, profile: str = "default",
             out_dir=None, hbm_gb: float = HBM_GB) -> dict:
    _check_one_chip(multi_pod, profile)
    out_dir = Path(out_dir or OUT_DIR)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"dryrun_{arch}_{shape_name}_1xH100.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    t0 = time.time()
    cfg = configs.get_config(arch)
    shape = SHAPES[shape_name]
    run = RunConfig(model=cfg, shape=shape, profile=profile)
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    record = {
        "arch": arch,
        "shape": shape_name,
        "profile": profile,
        "kind": shape.kind,
        "mesh": "1",
        "chips": 1,
        "device": f"{DEVICE_NAME} (data-sheet peaks)",
        "remat": run.remat if shape.kind == "train" else None,
        "tokens_per_step": tokens,
        "params_total": pm.count_params(model_mod.model_spec(cfg)),
        "params_active": active_params(cfg),
    }
    record["model_flops"] = model_flops(
        record["params_active"], tokens,
        "train" if shape.kind == "train" else "infer")
    pred = predict(cfg, shape, remat=run.remat, hbm_gb=hbm_gb,
                   costs=analysis_costs(arch, shape, run.remat))
    record.update(pred)
    record["useful_flops_frac"] = (record["model_flops"] / pred["flops"]
                                   if pred["flops"] else 0.0)
    record["analysis_s"] = round(time.time() - t0, 3)
    out_path.write_text(json.dumps(record, indent=2))
    return record


def cells(arch=None, shape=None, all_=False) -> list:
    """(arch, shape) of the run: every arch's shapes_for with --all (or
    no --arch), else the one arch's, or the one shape."""
    archs = sorted(configs.ARCHS) if (all_ or not arch) else [arch]
    out = []
    for a in archs:
        names = (shapes_for(configs.get_config(a)) if (all_ or not shape)
                 else [shape])
        out.extend((a, sh) for sh in names)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--profile", default="default")
    ap.add_argument("--out", default=None,
                    help=f"record directory (default {OUT_DIR})")
    ap.add_argument("--hbm-gb", type=float, default=HBM_GB)
    args = ap.parse_args(argv)
    if args.both_meshes:
        raise NotImplementedError(MESH_NOT_PORTED.format(
            what="16x16 and 2x16x16"))
    _check_one_chip(args.multi_pod, args.profile)

    ok = fail = 0
    t_all = time.time()
    for arch, sh in cells(args.arch, args.shape, args.all):
        tag = f"{arch} × {sh} × 1xH100"
        try:
            rec = run_cell(arch, sh, force=args.force, out_dir=args.out,
                           hbm_gb=args.hbm_gb)
            r, m = rec["roofline"], rec["memory"]
            print(f"[dryrun] OK   {tag}: {rec['analysis_s']}s"
                  f" flops={rec['flops']:.4e} bytes={rec['bytes']:.4e}"
                  f" args={m['arguments'] / 1e9:.3f}GB"
                  f" kept={m['kept'] / 1e9:.3f}GB"
                  f" peak={m['peak'] / 1e9:.3f}GB fits={rec['fits']}"
                  f" compute={r['compute_s']:.3e}s"
                  f" memory={r['memory_s']:.3e}s"
                  f" coll={r['collective_s']:.3e}s -> {r['bottleneck']}",
                  flush=True)
            ok += 1
        except Exception:
            print(f"[dryrun] FAIL {tag}", flush=True)
            traceback.print_exc()
            fail += 1
    print(f"[dryrun] {ok + fail} cells in {time.time() - t_all:.1f} s",
          flush=True)
    print(f"[dryrun] {ok} ok, {fail} failed", flush=True)
    raise SystemExit(1 if fail else 0)


if __name__ == "__main__":
    main()

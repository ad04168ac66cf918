#!/usr/bin/env python3
"""Looks for the smallest recipe at which the port's gemma-2b training
loss jumps back up, with ``chip_smoke.py`` phase 10's learning rate
schedule (peak 3e-3, warmup 20), B 1 and its synthetic batches over 64
live ids, on one CUDA card.

    python3 chip_train_recipe.py
    PYTHONPATH=src python3 chip_train_recipe.py --device cpu --smoke

Each recipe draws its parameters as phase 10 does (``trainable_params``,
seed 0, on the recipe's own depth), trains them phase 10's 8 steps through
``train.loop.fit`` and prints one line a step (loss, gradient norm, lr,
clip scale), then a summary line: the largest rise of a loss above the
lowest loss before it, and whether the loss jumps (that rise is more
than 5% of that lowest loss). Recipes: gemma-2b at full width cut
to 2 layers, at T 512, 1024 and 4096, in bf16 (phase 10's compute) and
fp32; then at T 512 in fp32 at narrower widths (d_model 1024 and 512,
the heads and d_ff cut in proportion, vocab 256,000 kept) and at full
width with a 32,000-id vocabulary, which say how far a CPU run of both
packages can be cut and still show it. Then the card's name and power
limit. ``--device cpu --smoke`` rehearses the script on the smoke config.
Needs one CUDA card otherwise; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

import chip_smoke as cs

JUMP_SHARE = 0.05
LAYERS = 2


def recipes(cfg, smoke: bool) -> list:
    """-> [(label, cfg, T)] in the order they run."""
    full = dataclasses.replace(cfg, n_layers=LAYERS)
    if smoke:
        return [("smoke bf16 T 64", full, 64),
                ("smoke fp32 T 64", dataclasses.replace(
                    full, compute_dtype="float32"), 64)]
    out = [(f"full width bf16 T {t}", full, t) for t in (512, 1024, 4096)]
    f32 = dataclasses.replace(full, compute_dtype="float32")
    out += [(f"full width fp32 T {t}", f32, t) for t in (512, 1024)]
    for d in (1024, 512):
        k = cfg.d_model // d
        out.append((f"d_model {d} fp32 T 512", dataclasses.replace(
            f32, d_model=d, n_heads=cfg.n_heads // k,
            d_ff=cfg.d_ff // k), 512))
    out.append(("full width vocab 32000 fp32 T 512",
                dataclasses.replace(f32, vocab=32000), 512))
    return out


def curve(tm, pm, cfg, t: int, steps: int, dev) -> list:
    """cfg trained ``steps`` steps from trainable_params(seed 0) under phase
    10's schedule -> [(loss, grad_norm, lr, clip_scale)] a step."""
    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.train import loop

    params = cs.trainable_params(tm, pm, cfg, 0)
    run = RunConfig(model=cfg, shape=ShapeConfig("recipe", t, cs.TRAIN_B,
                                                 "train"),
                    learning_rate=cs.TRAIN_LR, lr_warmup=cs.TRAIN_WARMUP)
    log: list = []
    loop.fit(cfg, run, iter(cs.synthetic_batches(cfg, steps, cs.TRAIN_B, t)),
             params=params, steps=steps, device=dev,
             on_metrics=lambda s, m: log.append(
                 tuple(float(m[k]) for k in ("loss", "grad_norm", "lr",
                                             "clip_scale"))))
    del params
    return log


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke config (a rehearsal of the script)")
    args = ap.parse_args(argv)

    from repro_torch import configs
    from repro_torch.models import model as tm
    from repro_torch.models import params as pm

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", flush=True)
        return 1
    cs.DEVICE = args.device
    cfg = configs.get_config(cs.TRAIN_ARCH)
    if args.smoke:
        cfg = configs.smoke_config(cfg)
    for label, c, t in recipes(cfg, args.smoke):
        t0 = time.perf_counter()
        log = curve(tm, pm, c, t, cs.TRAIN_STEPS, dev)
        for i, (loss, gn, lr, clip) in enumerate(log):
            print(f"[recipe] {label} step {i}: loss {loss:.6f} grad_norm"
                  f" {gn:.4e} lr {lr:.4e} clip {clip:.4e}", flush=True)
        losses = [x[0] for x in log]
        rise, low, at = 0.0, 0, 0
        for j in range(1, len(losses)):    # the largest rise above the
            i = min(range(j), key=losses.__getitem__)   # lowest before it
            if losses[j] - losses[i] > rise:
                rise, low, at = losses[j] - losses[i], i, j
        print(f"[recipe] {label}: d_model {c.d_model}, {c.n_layers} layers,"
              f" vocab {c.vocab}, B {cs.TRAIN_B}, T {t}, {c.compute_dtype}:"
              f" largest rise above the lowest loss before it {rise:.4f}"
              f" (step {low} {losses[low]:.4f} -> step {at}"
              f" {losses[at]:.4f}); jumps {rise > JUMP_SHARE * losses[low]}"
              f" ({time.perf_counter() - t0:.1f} s)", flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if dev.type == "cuda":
        print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

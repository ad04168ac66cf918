"""Training launcher of the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --smoke \
      --steps 100 --batch 8 --seq 128 [--ckpt-dir DIR] [--morph-data] \
      [--remat none|dots|full] [--device cuda|cpu]

The reference's flags (``repro.launch.train``) and its log and ``done:``
lines, plus ``--device``: the CUDA device by default, which raises
without one; ``--device cpu`` runs on the CPU. ``--smoke`` takes the
reduced same-family config. Fault tolerance (resume, the preemption
checkpoint, straggler counters) comes from ``train/loop.py``.
``--morph-data`` trains on the Arabic character stream with the stemmer
run on the same device. The VLM (llama-3.2-vision-11b) trains on
stand-in vision embeddings drawn from a seed (``with_vision_embeds``):
its vision front end is not modelled, as in the reference. The audio
family (musicgen-medium) is refused with exit code 2: the data streams
give [B, T] token batches and its model takes [B, T, K] ones (the
reference's launcher fails on them inside the model); ``loop.fit`` and
``train_step.make_train_step`` train it on [B, T, K] batches.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch import device as devmod
from repro_torch.configs import RunConfig, ShapeConfig
from repro_torch.data import pipeline as data_pipeline
from repro_torch.train import loop


def batched(base, batch: int):
    """Rows of a morph stream (one sequence each) stacked into batches of
    tokens and labels."""
    while True:
        rows = [next(base) for _ in range(batch)]
        yield {
            "tokens": np.concatenate([r["tokens"] for r in rows]),
            "labels": np.concatenate([r["labels"] for r in rows]),
        }


def with_vision_embeds(base, cfg, seed: int = 0):
    """The batches of ``base`` with the VLM's stand-in vision_embeds [B,
    vision_seq, d_model]: unit normals drawn with numpy from ``seed``,
    rounded to bf16 (as tests/test_arch_smoke.py makes them)."""
    rng = np.random.default_rng(seed)
    for batch in base:
        ve = rng.normal(size=(batch["tokens"].shape[0], cfg.vision_seq,
                              cfg.d_model)).astype(np.float32)
        yield dict(batch,
                   vision_embeds=torch.from_numpy(ve).to(torch.bfloat16))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--morph-data", action="store_true",
                    help="Arabic char-LM stream with stemmer root labels")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=devmod.DEFAULT_DEVICE,
                    help="cuda (default; raises without a CUDA device) or"
                         " cpu")
    args = ap.parse_args(argv)
    cfg = configs.get_config(args.arch)
    if cfg.n_codebooks:
        ap.error(f"--arch {args.arch}: the audio family trains on [B, T,"
                 f" {cfg.n_codebooks}] token batches, and this launcher's"
                 " data streams make [B, T] ones; train it through"
                 " repro_torch.train.loop.fit on [B, T, K] batches")

    dev = devmod.resolve(args.device)
    if args.smoke:
        cfg = configs.smoke_config(cfg)
    run = RunConfig(
        model=cfg,
        shape=ShapeConfig("cli", args.seq, args.batch, "train"),
        learning_rate=args.lr, lr_warmup=20, remat=args.remat,
        microbatches=args.microbatches)

    if args.morph_data:
        pre = data_pipeline.MorphPreprocessor(device=dev)
        data = batched(data_pipeline.morph_lm_batches(
            batch_words=2048, seq=args.seq, preproc=pre), args.batch)
    else:
        data = data_pipeline.synthetic_lm_batches(
            cfg.vocab, args.batch, args.seq, effective_vocab=64)
    if cfg.n_cross_layers:
        data = with_vision_embeds(data, cfg)

    def on_metrics(step, m):
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {float(m['loss']):.4f} "
                  f"lr {float(m['lr']):.2e} gnorm {float(m['grad_norm']):.2f}",
                  flush=True)

    result = loop.fit(cfg, run, data, steps=args.steps,
                      ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                      on_metrics=on_metrics, device=dev)
    print(f"done: {result.steps_run} steps, final loss "
          f"{result.losses[-1]:.4f}, stragglers {result.straggler_events}, "
          f"resumed_from {result.resumed_from}")
    return result


if __name__ == "__main__":
    main()

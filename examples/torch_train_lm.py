"""End-to-end driver of the port: train a ~100M-param LM for a few hundred
steps on the morphologically-preprocessed Arabic character stream.

The PyTorch counterpart of ``examples/train_lm.py``: the same model (8
layers, d_model=768, vocab=64, character level) and data, the stemmer run
as a preprocessing operator (root-id auxiliary labels) on the same device
as the training. Runs on the CUDA device unless ``--device cpu`` is given.

  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--device cpu]
"""
import argparse
import dataclasses

from repro_torch import device as devmod
from repro_torch.configs import ModelConfig, RunConfig, ShapeConfig
from repro_torch.core import alphabet as ab
from repro_torch.data import pipeline as data_pipeline
from repro_torch.launch.train import batched
from repro_torch.models import model as model_mod
from repro_torch.models import params as pm
from repro_torch.train import loop


def lm_100m() -> ModelConfig:
    return ModelConfig(
        name="arabic-char-100m",
        n_layers=8,
        d_model=768,
        n_heads=12,
        n_kv_heads=4,
        head_dim=64,
        d_ff=3072,
        vocab=ab.N_CODES + 1,
        tie_embeddings=False,
        rope_theta=10000.0,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--device", default=devmod.DEFAULT_DEVICE,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = devmod.resolve(args.device)
    cfg = dataclasses.replace(lm_100m(), d_model=args.d_model,
                              n_layers=args.layers,
                              d_ff=4 * args.d_model)
    n = pm.count_params(model_mod.model_spec(cfg))
    print(f"model: {cfg.name}  {n/1e6:.1f}M params")

    run = RunConfig(model=cfg,
                    shape=ShapeConfig("ex", args.seq, args.batch, "train"),
                    learning_rate=3e-3, lr_warmup=30, remat="none")

    pre = data_pipeline.MorphPreprocessor(device=dev)
    data = batched(data_pipeline.morph_lm_batches(
        batch_words=4096, seq=args.seq, preproc=pre), args.batch)

    losses = []

    def on_metrics(step, m):
        losses.append(float(m["loss"]))
        if step % 20 == 0:
            print(f"step {step:4d}  loss {losses[-1]:.4f}", flush=True)

    result = loop.fit(cfg, run, data, steps=args.steps,
                      on_metrics=on_metrics, device=dev)
    print(f"final loss {result.losses[-1]:.4f} "
          f"(start {result.losses[0]:.4f}) over {result.steps_run} steps")
    assert result.losses[-1] < result.losses[0], "LM failed to learn"


if __name__ == "__main__":
    main()

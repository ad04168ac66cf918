"""Both packages trained under chip_smoke.py phase 10's recipe on the CPU,
from the same weights and on the same batches, in fp32: the reference's
``init_params`` (jax.random.key(0)) rescaled as chip_smoke's
``trainable_params`` rescales the port's, carried into the port with
``params_from_numpy``; peak lr 3e-3 with warmup 20, remat "full", B 1,
the synthetic stream over 64 live ids. Prints one line a step with both
losses, their relative difference, both gradient norms and the lr, then
whether each curve jumps (a loss above the lowest before it by more
than 5% of that lowest, as ``chip_train_recipe.py`` reads the card's).

    PYTHONPATH=src python tests/train_recipe.py --d-model 512 --t 512
    PYTHONPATH=src python tests/train_recipe.py --full-width --t 512

``--full-width`` takes gemma-2b's widths (d_model 2048, 8 heads of 256,
d_ff 16384, vocab 256,000); otherwise the heads and d_ff are cut in
proportion to ``--d-model`` and the vocabulary to ``--vocab``.
``tests/test_torch_train.py`` calls ``curves`` at a cut width.
"""
import argparse
import dataclasses

import jax
import numpy as np

from repro import configs as rc
from repro.configs import RunConfig as RRun, ShapeConfig as RShape
from repro.models import model as rm
from repro.models import params as rp
from repro.train import optimizer as ropt
from repro.train import train_step as rts

ARCH = "gemma-2b"
LAYERS = 2
LR = 3e-3
WARMUP = 20
LIVE_IDS = 64
JUMP_SHARE = 0.05


def recipe_config(d_model=2048, vocab=256000, layers=LAYERS):
    """gemma-2b at ``layers`` layers, fp32, its heads and d_ff cut in
    proportion to d_model (head_dim 256 and one KV head kept) -> (the
    reference's config, the port's)."""
    from repro_torch import configs as tc

    out = []
    for pkg in (rc, tc):
        cfg = pkg.get_config(ARCH)
        k = cfg.d_model // d_model
        out.append(dataclasses.replace(
            cfg, n_layers=layers, d_model=d_model,
            n_heads=max(1, cfg.n_heads // k), d_ff=cfg.d_ff // k,
            vocab=vocab, compute_dtype="float32"))
    return tuple(out)


def rescale(p, n_layers):
    """The reference's parameter tree rescaled as chip_smoke.py's
    trainable_params rescales the port's: attention's 4-d weights to std
    (the product of the dims they contract)^-0.5, the residual outputs by
    a further (2 L)^-0.5. -> a tree of numpy arrays."""
    p = jax.tree.map(np.array, p)
    depth = (2 * n_layers) ** -0.5
    attn, ffn = p["blocks"]["attn"], p["blocks"]["ffn"]
    for name, w in attn.items():
        if w.ndim == 4:
            fan = w.shape[1] * (w.shape[2] if name == "wo" else 1)
            w *= np.float32((w.shape[-2] / fan) ** 0.5)
    attn["wo"] *= np.float32(depth)
    ffn["wo"] *= np.float32(depth)
    return p


def batches(cfg, steps, t):
    from repro_torch.data import pipeline

    it = pipeline.synthetic_lm_batches(cfg.vocab, 1, t,
                                       effective_vocab=LIVE_IDS)
    return [next(it) for _ in range(steps)]


def curves(cfgs, t, steps=8):
    """-> (reference metrics, port metrics): [(loss, grad_norm, lr)] a step
    of both packages' train steps from the same rescaled weights, for
    ``cfgs`` = recipe_config(...)."""
    from repro_torch.configs import RunConfig as TRun, ShapeConfig as TShape
    from repro_torch.models import params as tp
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_step as tts

    cfg, tcfg = cfgs
    kw = {"remat": "full", "learning_rate": LR, "lr_warmup": WARMUP}
    rparams = rescale(rp.init_params(rm.model_spec(cfg), jax.random.key(0)),
                      cfg.n_layers)
    tparams = tp.params_from_numpy(rparams, device="cpu")
    data = batches(cfg, steps, t)
    out = []
    for pkg in ("reference", "port"):
        log = []
        if pkg == "reference":
            step = jax.jit(rts.make_train_step(
                cfg, RRun(model=cfg, shape=RShape("recipe", t, 1, "train"),
                          **kw)), donate_argnums=(0, 1))
            params = jax.tree.map(jax.numpy.asarray, rparams)
            state = ropt.init(params)
        else:
            step = tts.make_train_step(tcfg, TRun(
                model=tcfg, shape=TShape("recipe", t, 1, "train"), **kw))
            params, state = tparams, topt.init(tparams)
        for batch in data:
            params, state, m = step(params, state, batch)
            log.append(tuple(float(m[k]) for k in ("loss", "grad_norm",
                                                   "lr")))
        out.append(log)
        del params, state, step
        if pkg == "reference":
            rparams = None
    return out[0], out[1]


def jumps(losses):
    return any(losses[j] > (1 + JUMP_SHARE) * min(losses[:j])
               for j in range(1, len(losses)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full-width", action="store_true")
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--vocab", type=int, default=256000)
    ap.add_argument("--t", type=int, default=512)
    args = ap.parse_args(argv)
    cfgs = (recipe_config() if args.full_width
            else recipe_config(args.d_model, args.vocab))
    cfg = cfgs[0]
    print(f"{cfg.name} at {cfg.n_layers} layers, d_model {cfg.d_model},"
          f" {cfg.n_heads} heads x {cfg.head_dim}, d_ff {cfg.d_ff}, vocab"
          f" {cfg.vocab}, fp32, B 1, T {args.t}, lr {LR} warmup {WARMUP},"
          f" {LIVE_IDS} live ids", flush=True)
    ref, port = curves(cfgs, args.t)
    for i, (r, p) in enumerate(zip(ref, port)):
        print(f"step {i}: loss reference {r[0]:.6f} port {p[0]:.6f}"
              f" (relative {abs(p[0] - r[0]) / abs(r[0]):.2e}); grad_norm"
              f" {r[1]:.4e} / {p[1]:.4e}; lr {r[2]:.4e} / {p[2]:.4e}",
              flush=True)
    worst = max(abs(p[0] - r[0]) / abs(r[0]) for r, p in zip(ref, port))
    print(f"jumps: reference {jumps([r[0] for r in ref])}, port"
          f" {jumps([p[0] for p in port])}; largest relative difference"
          f" {worst:.2e}", flush=True)


if __name__ == "__main__":
    main()

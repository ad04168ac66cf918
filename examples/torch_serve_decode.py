"""Serve a small model with batched, continuously-batched requests.

The PyTorch counterpart of ``examples/serve_decode.py``: llama3-8b's
smoke config behind the port's ``ServeEngine``, 7 requests of 6 random
ids (numpy seed 1) sharing 3 slots, 6 new tokens each, and the same
lines. The weights are drawn from a torch generator seeded 7 (other
values than the reference's ``jax.random.key(7)``, the same
statistics), unless ``main`` is given ``params`` (a test carries the
reference's across with ``params_from_numpy``). ``--dtype float32``
computes and caches in fp32. The path reaches no kernel of the port, as
the reference's reaches no pallas_call. The script checks that every
request got its 6 tokens, and that each token of request 0 is the
argmax of a plain loop over ``decode_step`` fed the served tokens, to
within ``TOL`` of the largest |logit| (a batch of 3 slots and a batch of
1 may round their products apart); it exits non-zero otherwise.

  PYTHONPATH=src python examples/torch_serve_decode.py [--device cuda:0]
  PYTHONPATH=src python examples/torch_serve_decode.py --device cpu
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch import device as devmod
from repro_torch.models import model as model_mod
from repro_torch.models import params as pm
from repro_torch.serve.engine import ServeEngine

N_REQUESTS, PROMPT, MAX_NEW, SLOTS, CACHE_LEN = 7, 6, 6, 3, 128
# a served token's logit below the largest by more than this share of the
# largest |logit| is not a greedy choice
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def greedy_gaps(params, cfg, prompt, served, dt, dev):
    """-> for each served token, (largest logit - its logit) / largest
    |logit| in a plain loop over decode_step fed the prompt and then the
    served tokens (0 where it is the argmax)."""
    caches = model_mod.init_caches(cfg, 1, CACHE_LEN, dt=dt, device=dev)
    gaps, logits = [], None
    for i, t in enumerate(list(prompt) + list(served)):
        if i >= len(prompt):
            row = logits[0, -1].float()
            gaps.append(float((row.max() - row[t]) / row.abs().max()))
        logits, caches = model_mod.decode_step(
            params, cfg, torch.full((1, 1), int(t), dtype=torch.int32,
                                    device=dev), caches, i)
    return gaps


def main(argv=None, params=None):
    """-> [tokens_out of each request, in submit order]."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda:0",
                    help="where the model serves (cuda:N or cpu)")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"),
                    help="compute and cache dtype (the config's is bf16)")
    args = ap.parse_args(argv)
    dev = devmod.resolve(args.device)

    cfg = dataclasses.replace(
        configs.smoke_config(configs.get_config("llama3-8b")),
        compute_dtype=args.dtype)
    if params is None:
        params = pm.init_params(model_mod.model_spec(cfg),
                                torch.Generator(dev).manual_seed(7),
                                device=dev)
    params = pm.tree_map(lambda x: x.to(dev), params)
    eng = ServeEngine(cfg, params, max_batch=SLOTS, cache_len=CACHE_LEN,
                      device=dev)
    dt = getattr(torch, args.dtype)
    if args.dtype == "float32":
        eng.workload.caches = model_mod.init_caches(
            cfg, SLOTS, CACHE_LEN, dt=dt, device=dev)

    rng = np.random.default_rng(1)
    t0 = time.time()
    prompts = [rng.integers(0, cfg.vocab, PROMPT) for _ in range(N_REQUESTS)]
    rids = [eng.submit(p, max_new=MAX_NEW) for p in prompts]
    rep = eng.run_until_drained()
    dt_s = time.time() - t0

    tokens = [list(eng.result(r).tokens_out) for r in rids]
    toks = sum(len(t) for t in tokens)
    print(f"{len(rids)} requests, {toks} tokens, {rep.ticks} ticks, "
          f"{toks/dt_s:.1f} tok/s")
    for rid, t in zip(rids, tokens):
        print(f"  req {rid}: {t}")
    if not all(len(t) == MAX_NEW and all(0 <= x < cfg.vocab for x in t)
               for t in tokens):
        raise SystemExit("serve_decode: a request did not get its"
                         f" {MAX_NEW} tokens in the vocabulary")
    gaps = greedy_gaps(params, cfg, prompts[0], tokens[0], dt, dev)
    if max(gaps) > TOL[args.dtype]:
        raise SystemExit(f"serve_decode: request 0's tokens {tokens[0]} are"
                         f" not greedy: gaps {gaps}")
    print(f"greedy ok: request 0's tokens are a plain decode_step loop's"
          f" argmax (largest gap {max(gaps):.2e} of the largest |logit|)")
    return tokens


if __name__ == "__main__":
    main()

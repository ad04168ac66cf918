#!/usr/bin/env python3
"""Holds deepseek-v2-lite-16b's prefill against prefill-by-decode over
several prompts and cache lengths, in bf16 and fp32, on one CUDA card.

    python3 chip_moe_prefill.py

The model is ``chip_smoke.py``'s phase 8d model: full width, drawn on the
card from the same seeded generator, cut to 2 layers (the dense layer and
the first MoE layer) as that phase's check cuts it. For each prompt of
16, 20, 24, 28 and 32 random ids (numpy seeds 0-2) it runs the prefill
forward, then prefill-by-decode through ``LMDecodeWorkload`` on 4 slots
with caches of 3 and of 15 positions past the prompt (phase 8d's serve
traffic gives 3 with 4 new tokens, 15 with 16), and prints a line a
prompt and cache: the last logits' max error relative to the largest
|logit| (phase 8d's check holds it to 2e-2 in bf16 and 5e-4 in fp32),
whether the last token's top-6 experts at the MoE layer are the same set
in both paths, each path's gap between the 6th and 7th router
probability, and the largest difference of the two paths' router
probabilities. Then the card's name and power limit. Needs one CUDA
card; exits non-zero without one.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

import chip_smoke as cs

PROMPTS = (16, 20, 24, 28, 32)
SEEDS = (0, 1, 2)
EXTRA = (3, 15)
LAYERS = 2
SLOTS = 4


def main() -> int:
    from repro_torch import configs, serve
    from repro_torch.models import model as tm
    from repro_torch.models import moe
    from repro_torch.models import params as pm

    if not torch.cuda.is_available():
        print("no CUDA card", flush=True)
        return 1
    dev = torch.device("cuda")
    cfg = configs.get_config(cs.MOE_ARCH)
    params = pm.init_params(tm.model_spec(cfg),
                            torch.Generator(dev).manual_seed(0), device=dev)
    cfg_cut, cut = cs.cut_layers(pm, cfg, params, LAYERS)
    routed = []
    plain_routing = moe.routing

    def routing(p, xf, c):
        r = plain_routing(p, xf, c)
        routed.append((r.probs.detach().clone(), r.top_e.detach().clone()))
        return r

    def by_decode(cfg_d, ids, cache_len):
        """-> (the last decode step's logits of slot 0, its routing at the
        MoE layer: probabilities, top-6)."""
        wl = serve.LMDecodeWorkload(cfg_d, cut, max_batch=SLOTS,
                                    cache_len=cache_len, device=dev)
        if cfg_d.compute_dtype == "float32":
            wl.caches = tm.init_caches(cfg_d, SLOTS, cache_len,
                                       dt=torch.float32, device=dev)
        logits = []
        decode = wl._decode

        def step(p, tok, caches, pos):
            out, new = decode(p, tok, caches, pos)
            logits.append(out[0, -1].float())
            return out, new

        wl._decode = step
        routed.clear()
        wl.admit(wl.make_request(0, ids, max_new=1))
        probs, top_e = routed[-1]
        return logits[-1], probs[0], top_e[0]     # slot 0's row

    def gap(p):
        s = torch.sort(p, descending=True).values
        return float(s[5] - s[6])

    moe.routing = routing
    for dtype in ("bfloat16", "float32"):
        cfg_d = dataclasses.replace(cfg_cut, compute_dtype=dtype)
        for n in PROMPTS:
            for seed in SEEDS:
                ids = np.random.default_rng(seed).integers(0, cfg.vocab, n)
                routed.clear()
                pre = tm.forward(cut, cfg_d, torch.from_numpy(ids[None]).to(
                    dev), mode="prefill")
                a = pre.logits[0, -1].float()
                pre_p, pre_e = routed[-1][0][-1], routed[-1][1][-1]
                for extra in EXTRA:
                    b, dec_p, dec_e = by_decode(cfg_d, ids, n + extra)
                    err = float((a - b).abs().max() / a.abs().max())
                    print(f"{dtype} prompt {n} seed {seed} cache {n + extra}:"
                          f" max error {err:.3e}; last token's top-6 the same"
                          f" set {set(pre_e.tolist()) == set(dec_e.tolist())}"
                          f" (prefill {sorted(pre_e.tolist())}, decode"
                          f" {sorted(dec_e.tolist())}); 6th-7th probability"
                          f" gap {gap(pre_p):.2e} / {gap(dec_p):.2e}; router"
                          " probabilities"
                          f" {float((pre_p - dec_p).abs().max()):.2e} apart",
                          flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

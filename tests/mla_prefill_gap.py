"""deepseek-v2-lite's prefill against prefill-by-decode in both packages
on the CPU, from the same weights (the reference's ``init_params``,
jax.random.key(0), carried into the port with ``params_from_numpy``), at
a cut width: d_model 512 and 2 layers (the dense layer, then an MoE
layer with the 64-expert top-6 routing and 2 shared experts). For each
prompt (numpy seed s, n random ids) both packages run the prefill
forward and a decode_step loop over the prompt into caches of n + 3
positions; the gap is the last logits' largest difference over the
largest |prefill logit|. Prints a line a prompt and dtype with both
packages' gaps.

    PYTHONPATH=src python tests/mla_prefill_gap.py            # 15 prompts
    PYTHONPATH=src python tests/mla_prefill_gap.py --dense    # no MoE layer

``tests/test_torch_mla.py`` calls ``gaps`` on three prompts.
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs as rc
from repro.models import model as rm
from repro.models import params as rp

ARCH = "deepseek-v2-lite-16b"
PROMPTS = (16, 20, 24, 28, 32)
SEEDS = (0, 1, 2)
EXTRA = 3


def cfgs(dtype, d_model=512, dense=False):
    """-> (the reference's config, the port's) at 2 layers; ``dense``
    drops the experts and the leading dense layer, so both layers are MLA
    with the dense FFN."""
    from repro_torch import configs as tc

    out = []
    for pkg in (rc, tc):
        c = dataclasses.replace(pkg.get_config(ARCH), n_layers=2,
                                d_model=d_model, compute_dtype=dtype)
        if dense:
            c = dataclasses.replace(c, n_experts=0, n_shared_experts=0,
                                    first_dense=0)
        out.append(c)
    return tuple(out)


def gaps(prompts, dtypes=("bfloat16", "float32"), dense=False):
    """-> {(dtype, n, seed): (reference's gap, port's gap)} over
    ``prompts``, a list of (n, seed)."""
    import torch

    from repro_torch.models import model as tm
    from repro_torch.models import params as tp

    rcfg, _ = cfgs("float32", dense=dense)
    p = rp.init_params(rm.model_spec(rcfg), jax.random.key(0))
    pt = tp.params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
    out = {}
    for dtype in dtypes:
        rcfg, tcfg = cfgs(dtype, dense=dense)
        rfwd = jax.jit(lambda p, t: rm.forward(p, rcfg, t,
                                               mode="prefill").logits)
        rdec = jax.jit(lambda p, t, c, pos: rm.decode_step(p, rcfg, t, c,
                                                           pos))
        for n, seed in prompts:
            ids = np.random.default_rng(seed).integers(
                0, rcfg.vocab, n).astype(np.int32)
            pre = np.asarray(rfwd(p, ids[None])[0, -1], np.float32)
            c = rm.init_caches(rcfg, 1, n + EXTRA, dt=jnp.dtype(dtype))
            for i in range(n):
                lg, c = rdec(p, jnp.asarray(ids[None, i:i + 1]), c,
                             jnp.int32(i))
            dec = np.asarray(lg[0, -1], np.float32)
            with torch.no_grad():
                tpre = tm.forward(pt, tcfg, torch.from_numpy(ids[None]),
                                  mode="prefill").logits[0, -1].float()
                caches = tm.init_caches(tcfg, 1, n + EXTRA,
                                        dt=getattr(torch, dtype),
                                        device="cpu")
                for i in range(n):
                    tl, caches = tm.decode_step(
                        pt, tcfg, torch.from_numpy(ids[None, i:i + 1]),
                        caches, i)
            tdec = tl[0, -1].float()
            out[dtype, n, seed] = (
                float(np.abs(pre - dec).max() / np.abs(pre).max()),
                float((tpre - tdec).abs().max() / tpre.abs().max()))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dense", action="store_true",
                    help="a dense FFN in place of the MoE layer")
    args = ap.parse_args(argv)
    got = gaps([(n, s) for n in PROMPTS for s in SEEDS], dense=args.dense)
    for (dtype, n, seed), (r, t) in got.items():
        print(f"{ARCH}{' dense' if args.dense else ''} {dtype} prompt {n}"
              f" seed {seed}: reference {r:.3e} port {t:.3e}", flush=True)
    for dtype in ("bfloat16", "float32"):
        rs = [v for k, v in got.items() if k[0] == dtype]
        print(f"{dtype}: reference {min(r for r, _ in rs):.3e} to"
              f" {max(r for r, _ in rs):.3e}, port {min(t for _, t in rs):.3e}"
              f" to {max(t for _, t in rs):.3e}", flush=True)


if __name__ == "__main__":
    main()

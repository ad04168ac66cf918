"""The training loop with checkpoint-restart fault tolerance, preemption
handling, a straggler counter and asynchronous checkpoints off the
critical path. The counterpart of ``repro.train.loop``."""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field

import torch

from repro_torch import device as devmod
from repro_torch.models import model as model_mod
from repro_torch.models import params as pm
from repro_torch.train import checkpoint, optimizer, train_step as ts


@dataclass
class FitResult:
    steps_run: int
    final_step: int
    losses: list = field(default_factory=list)
    resumed_from: int | None = None
    straggler_events: int = 0


def fit(cfg, run, data_iter, *, params=None, steps: int = 100,
        ckpt_dir=None, ckpt_every: int = 50, mesh=None, seed: int = 0,
        step_timeout_factor: float = 3.0, on_metrics=None,
        device=devmod.DEFAULT_DEVICE) -> FitResult:
    """Run (or resume) a training job on ``device``.

    Without ``params`` they are drawn by ``init_params`` from a generator
    on the device seeded with ``seed`` (other values than the
    reference's, the same statistics); given ones are trained in place.
    Batches come from ``data_iter`` as numpy arrays (or tensors).

    Fault tolerance:
      - resumes from the latest COMMITTED checkpoint in ckpt_dir;
      - SIGTERM (preemption) triggers a synchronous checkpoint and a clean
        stop; the old handler is restored on the way out;
      - steps slower than step_timeout_factor x the running median (after
        the first five) count as straggler events;
      - checkpoints are written asynchronously, each joined before the
        next save and at exit.
    """
    ts.check_mesh(mesh, "fit")
    dev = devmod.resolve(device)
    step_fn = ts.make_train_step(cfg, run)

    if params is None:
        params = pm.init_params(model_mod.model_spec(cfg),
                                torch.Generator(dev).manual_seed(seed),
                                device=dev)
    else:
        params = pm.tree_map(lambda x: x.to(dev), params)
    opt_state = optimizer.init(params)

    start_step = 0
    resumed = None
    if ckpt_dir is not None:
        latest = checkpoint.latest_step(ckpt_dir)
        if latest is not None:
            state = {"params": params, "opt": opt_state}
            saved = checkpoint.restore(ckpt_dir, latest, state, device="cpu")
            with torch.no_grad():   # into the tensors the step updates
                pm.tree_map(lambda dst, src: dst.copy_(src),
                            {"params": params, "opt": opt_state._asdict()},
                            {"params": saved["params"],
                             "opt": saved["opt"]._asdict()})
            start_step = latest
            resumed = latest

    preempted = {"flag": False}

    def _on_term(signum, frame):
        preempted["flag"] = True

    old_handler = signal.signal(signal.SIGTERM, _on_term)

    result = FitResult(steps_run=0, final_step=start_step,
                       resumed_from=resumed)
    durations: list[float] = []
    pending_ckpt = None
    try:
        for step in range(start_step, steps):
            batch = next(data_iter)
            t0 = time.time()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            durations.append(dt)
            med = sorted(durations)[len(durations) // 2]
            if len(durations) > 5 and dt > step_timeout_factor * med:
                result.straggler_events += 1
            result.losses.append(loss)
            result.steps_run += 1
            result.final_step = step + 1
            if on_metrics:
                on_metrics(step, metrics)

            want_ckpt = ckpt_dir is not None and (
                (step + 1) % ckpt_every == 0 or preempted["flag"])
            if want_ckpt:
                if pending_ckpt is not None:
                    pending_ckpt.join()
                pending_ckpt = checkpoint.save(
                    ckpt_dir, step + 1, {"params": params, "opt": opt_state},
                    async_=not preempted["flag"])
            if preempted["flag"]:
                break
    finally:
        if pending_ckpt is not None:
            pending_ckpt.join()
        signal.signal(signal.SIGTERM, old_handler)
    return result

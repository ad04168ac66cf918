"""The training step: loss -> gradients (rematerialised, microbatched) ->
clipped AdamW update, and the serving steps. The counterpart of
``repro.train.train_step``; the factories return plain functions (the
reference's are jitted by their callers)."""
from __future__ import annotations

import torch

from repro_torch.models import model as model_mod
from repro_torch.models import params as pm
from repro_torch.train import optimizer


def remat_policy(name: str):
    """"none" | "dots" | "full" -> the policy ``model.forward`` takes."""
    if name == "none":
        return None
    if name == "dots":
        return model_mod.dots_with_no_batch_dims_saveable
    if name == "full":
        return model_mod.nothing_saveable
    raise ValueError(f"unknown remat policy {name!r}")


def check_mesh(mesh, what: str) -> None:
    """Raise for a mesh: the port trains on one device."""
    if mesh is not None:
        raise NotImplementedError(
            f"{what}(mesh=...): training on a mesh is not ported: the"
            " reference's training step calls sharding.make_constrain,"
            " which its dist/sharding.py does not define (ROADMAP §3)")


def to_device(batch: dict, device) -> dict:
    """The batch's tokens, labels and the VLM's vision_embeds (numpy or
    tensors) as tensors on ``device``; its other entries (a morph
    stream's root ids) are not the loss's."""
    return {k: torch.as_tensor(batch[k]).to(device)
            for k in ("tokens", "labels", "vision_embeds") if k in batch}


def make_train_step(cfg, run, mesh=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): params and the moments are updated in place; metrics are
    0-d tensors {"grad_norm", "clip_scale", "loss", "lr"}. The batch may
    hold numpy arrays; they go to the parameters' device once a step."""
    check_mesh(mesh, "make_train_step")
    policy = remat_policy(run.remat)

    def loss_and_grads(params, batch):
        leaves = pm.tree_leaves(params)
        live = [x.detach().requires_grad_() for x in leaves]
        it = iter(live)
        p = pm.tree_map(lambda _: next(it), params)
        loss = model_mod.loss_fn(p, cfg, batch, remat_policy=policy)
        grads = torch.autograd.grad(loss, live)
        return loss.detach(), grads

    def grads_fn(params, batch):
        if run.microbatches <= 1:
            return loss_and_grads(params, batch)
        m = run.microbatches
        total_l, total_g = 0.0, None
        for i in range(m):
            mb = {k: x.reshape(m, x.shape[0] // m, *x.shape[1:])[i]
                  for k, x in batch.items()}
            loss, grads = loss_and_grads(params, mb)
            total_l = total_l + loss
            if total_g is None:
                total_g = [g.float() for g in grads]
            else:
                for a, g in zip(total_g, grads):
                    a.add_(g.float())
        scale = 1.0 / m
        return total_l * scale, [g.mul_(scale) for g in total_g]

    def train_step(params, opt_state, batch):
        dev = pm.tree_leaves(params)[0].device
        loss, grads = grads_fn(params, to_device(batch, dev))
        it = iter(grads)
        grads = pm.tree_map(lambda _: next(it), params)
        lr = optimizer.cosine_lr(opt_state.step, peak=run.learning_rate,
                                 warmup=run.lr_warmup)
        params, opt_state, metrics = optimizer.update(
            params, grads, opt_state, lr=lr,
            weight_decay=run.weight_decay, clip=run.grad_clip)
        metrics["loss"] = loss
        metrics["lr"] = lr
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg, mesh=None):
    """prefill_step(params, tokens, vision_embeds=None) -> (last logits
    [B,1,V], caches); the VLM takes vision_embeds [B, vision_seq,
    d_model]."""
    check_mesh(mesh, "make_prefill_step")

    @torch.no_grad()
    def prefill_step(params, tokens, vision_embeds=None):
        out = model_mod.forward(params, cfg, tokens,
                                vision_embeds=vision_embeds, mode="prefill")
        return out.logits[:, -1:], out.caches

    return prefill_step


def make_decode_step(cfg, mesh=None):
    """decode_step(params, tokens, caches, pos) -> (logits, new caches)."""
    check_mesh(mesh, "make_decode_step")

    @torch.no_grad()
    def decode_step(params, tokens, caches, pos):
        return model_mod.decode_step(params, cfg, tokens, caches, pos)

    return decode_step

"""Declarative parameters: trees (nested dicts) of ``ParamSpec`` leaves.

The counterpart of ``repro.models.params``. From one declaration come the
initialised tensors (:func:`init_params`), shapes without storage on the
meta device (:func:`abstract_params`), layer-stacked variants
(:func:`stack`) and the parameter count (:func:`count_params`).
:func:`params_from_numpy` carries a parameter tree of the reference
(converted leaf by leaf to numpy) over to the port's tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import device as devmod


class ParamSpec(NamedTuple):
    shape: tuple
    axes: tuple          # logical axis name (or None) per dim
    init: str = "normal"  # normal | zeros | ones
    scale: float | None = None  # stddev; default fan-in scaled


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(f, *trees):
    """f over the leaves of one or more trees of one structure: nested
    dicts (keys in sorted order, as jax flattens a dict), tuples and
    NamedTuples (caches; () is an empty placeholder). ParamSpecs are
    leaves."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(f, *(t[k] for t in trees)) for k in sorted(t0)}
    if isinstance(t0, tuple) and not is_spec(t0):
        mapped = [tree_map(f, *parts) for parts in zip(*trees)]
        return type(t0)(*mapped) if hasattr(t0, "_fields") else tuple(mapped)
    return f(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    return [tree]


def abstract_params(tree, dtype=torch.float32):
    """Shapes without storage: every leaf an empty tensor on the meta
    device (the counterpart of the reference's ShapeDtypeStructs)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype,
                                          device="meta"), tree)


def stack(tree, n: int):
    """Prepend a layer dimension (the stacked per-layer parameters)."""
    return tree_map(
        lambda s: ParamSpec((n, *s.shape), ("layers", *s.axes), s.init,
                            s.scale), tree)


def init_std(spec: ParamSpec) -> float:
    """The reference's rule: ``scale`` if given, else shape[-2] ** -0.5 of
    the (stacked) shape, or shape[-1] ** -0.5 for a vector."""
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    return spec.scale if spec.scale is not None else fan_in ** -0.5


def init_params(tree, generator: torch.Generator, dtype=torch.float32,
                device=devmod.DEFAULT_DEVICE):
    """Materialise parameters on ``device``: zeros, ones, or a normal of
    :func:`init_std`, drawn leaf by leaf (in flattening order) from
    ``generator``, which must live on that device. The values differ from
    the reference's (another generator); their statistics do not."""
    dev = devmod.resolve(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, parameters on"
                         f" {dev}: draw them on one device")

    def one(spec: ParamSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=dev)
        x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return x.mul_(init_std(spec)).to(dtype)

    return tree_map(one, tree)


def count_params(tree) -> int:
    """Elements over every leaf (specs or tensors)."""
    total = 0
    for leaf in tree_leaves(tree):
        n = 1
        for d in leaf.shape:
            n *= int(d)
        total += n
    return total


def _tensor(x, dev: torch.device) -> torch.Tensor:
    a = np.array(x)                  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":   # ml_dtypes: carry the bits across
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def params_from_numpy(tree, device=devmod.DEFAULT_DEVICE):
    """The reference's parameter tree, as numpy arrays (nested dicts), to
    the port's tensors on ``device``: the same keys, shapes, dtypes and
    values, leaf for leaf."""
    dev = devmod.resolve(device)
    return tree_map(lambda x: _tensor(x, dev), tree)

"""Logical-axis -> mesh-axis resolver for the ParamSpec system.

The counterpart of ``repro.dist.sharding``. Model code names dimensions
by role ("fsdp", "model", "batch", ...); this module maps roles onto the
mesh a launcher built:

  - each role has an ordered mesh-axis group; the data-parallel roles
    ("batch", "fsdp") span ("data", "pod"), so a multi-pod mesh shards
    the whole data-parallel group;
  - a dimension shards on the longest group prefix whose device product
    divides it (a batch of 16 on data=16 x pod=2 backs off from the
    32-way group to 16-way "data"); otherwise it replicates;
  - a mesh axis is used at most once a parameter ("experts" taking
    "model" stops a later "model" dim from reusing it);
  - group members absent from the mesh are skipped, so one spec tree
    resolves on single-pod and multi-pod meshes.

Meshes are duck-typed: only ``axis_names`` and ``devices.shape`` are
read (``launch.mesh.Mesh``, or the reference tests' fakes). The result
is :class:`P`, a tuple of one entry a dimension: None, an axis name, or
a tuple of axis names. :func:`axis_devices` reads a mesh's entries along
one axis, for the paths that run on them.

The reference calls ``make_constrain``, ``shard_abstract``,
``array_sharding`` and ``rules_for`` of this module from its training
step and dry run, but defines none of them; neither package has them
(ROADMAP §3).
"""
from __future__ import annotations

import numpy as np
import torch

# role -> ordered candidate mesh axes
GROUPS = {
    "batch": ("data", "pod"),
    "fsdp": ("data", "pod"),
    "model": ("model",),
    "heads": ("model",),
    "experts": ("model",),
    "kv_seq": ("model",),
    "vocab": ("model",),
}
# never sharded: scan/stack dims and per-feature vectors
_REPLICATED = {"layers", "blocks", "cross_blocks", None}


class P(tuple):
    """A partition spec: ``P("data", None)`` is the tuple ``("data",
    None)``, the entries of a jax ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def axis_sizes(mesh) -> dict:
    """Duck-typed mesh -> {axis name: device count}: the one place mesh
    introspection happens (resolve() and dist.shard_batch both go through
    it), reading only ``axis_names`` and ``devices.shape``."""
    return dict(zip(mesh.axis_names, np.shape(mesh.devices)))


def mesh_axis_size(mesh, axis: str) -> int:
    """Size of ``axis`` in ``mesh`` (duck-typed via :func:`axis_sizes`)."""
    sizes = axis_sizes(mesh)
    if axis not in sizes:
        raise ValueError(
            f"mesh has no axis {axis!r} (axes: {tuple(mesh.axis_names)})")
    return int(sizes[axis])


def axis_devices(mesh, axis: str) -> list:
    """The ``torch.device`` of every entry along ``axis`` of a
    ``launch.mesh.Mesh`` (index 0 on its other axes), in order."""
    n = mesh_axis_size(mesh, axis)
    arr = np.moveaxis(np.asarray(mesh.devices, dtype=object),
                      tuple(mesh.axis_names).index(axis), 0)
    devs = [arr[(i,) + (0,) * (arr.ndim - 1)] for i in range(n)]
    for d in devs:
        if not isinstance(d, torch.device) or d.type not in ("cuda", "cpu"):
            raise ValueError(f"mesh entry {d!r} is not a cuda or cpu"
                             " torch.device")
    return devs


def resolve(axes, shape, mesh) -> P:
    """(logical axes, dim sizes, mesh) -> :class:`P`.

    Every returned entry divides its dimension exactly; anything that
    cannot shard cleanly replicates rather than raising, so one spec tree
    serves every mesh geometry.
    """
    sizes = axis_sizes(mesh)
    used: set = set()
    entries = []
    for name, dim in zip(axes, shape):
        group = GROUPS.get(name, ())
        group = tuple(a for a in group if a in sizes and a not in used)
        entry = None
        for k in range(len(group), 0, -1):  # longest prefix first
            prefix = group[:k]
            prod = 1
            for a in prefix:
                prod *= sizes[a]
            if prod > 1 and dim % prod == 0:
                entry = prefix if k > 1 else prefix[0]
                used.update(prefix)
                break
        entries.append(entry)
    return P(*entries)

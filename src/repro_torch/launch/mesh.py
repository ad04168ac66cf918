"""Device meshes: the counterpart of ``repro.launch.mesh``.

A :class:`Mesh` is a plain record, ``axis_names`` plus ``devices``, a
numpy object array of ``torch.device`` whose shape is the mesh's shape.
Only those two are read (``dist.sharding.axis_sizes``), so the duck-typed
fakes the reference's tests pass work here too.

The port drives every entry of a mesh from one process, as the
reference's ``shard_map`` does from one controller: a sharded call
launches each shard's kernels on its entry's device, one after another,
each on that device's current stream, and gathers the results on the
first entry (``dist.shard_batch``, ``dist.pipeline``).

  make_data_mesh        1-D ``("data",)`` mesh of the first ``n_dev`` GPUs
                        (or of ``n_dev`` CPU entries); never repeats a GPU
  Mesh.of               a 1-D mesh of explicit entries, which may repeat a
                        device: N shards on one card run one after another
                        on its current stream. Nothing else builds such a
                        mesh; a caller asks for it by name
  make_local_mesh       ``("data", "model")`` over the GPUs present
  make_production_mesh  the reference's (16, 16) / (2, 16, 16) shapes on
                        the meta device: shape arithmetic only
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as devmod


class Mesh:
    """``devices``: object array of ``torch.device``, shape = mesh shape;
    ``axis_names``: one name a dimension. Every entry has one device type
    (a mesh never mixes the CPU and a card)."""

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {arr.shape} needs"
                             f" {arr.ndim} axis names, got {axis_names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        kinds = {d.type for d in arr.flat}
        if len(kinds) != 1:
            raise ValueError(f"a mesh's entries share one device type, got"
                             f" {sorted(kinds)}")
        self.devices = arr
        self.axis_names = axis_names

    @classmethod
    def of(cls, entries, axis: str = "data") -> "Mesh":
        """A 1-D mesh of these entries, in order. An entry may repeat a
        device (``Mesh.of(["cuda:0"] * 4)``): its shards then run one after
        another on that device. A ``cuda`` entry needs a card (it raises
        through ``device.resolve``) and an index below the card count."""
        return cls(np.array([_entry(e) for e in entries], dtype=object),
                   (axis,))

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def first(self, n: int, axis: str = "data") -> "Mesh":
        """The 1-D mesh of the first ``n`` entries along ``axis`` (the
        degradation ladder's smaller meshes)."""
        from repro_torch.dist.sharding import axis_devices  # lazy: no cycle

        devs = axis_devices(self, axis)
        if not 1 <= n <= len(devs):
            raise ValueError(f"mesh axis {axis!r} has {len(devs)} entries,"
                             f" asked for {n}")
        return Mesh.of(devs[:n], axis)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"{[str(d) for d in self.devices.flat]})")


def _entry(e) -> torch.device:
    dev = devmod.resolve(e)
    if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
        raise ValueError(f"mesh entry {dev}: only"
                         f" {torch.cuda.device_count()} CUDA devices")
    return dev


def make_data_mesh(n_dev: int | None = None, *,
                   device=devmod.DEFAULT_DEVICE) -> Mesh:
    """1-D ``("data",)`` mesh over the first ``n_dev`` devices of
    ``device``'s type. On ``cuda`` the default is every GPU, more than
    ``torch.cuda.device_count()`` raises ValueError (as the reference does
    for missing devices) and no GPU is repeated. On ``cpu`` it is
    ``n_dev`` CPU entries (default 1), the counterpart of the reference
    tests' forced host devices.

    The serving path (``StemmerWorkload(data_devices=N)``,
    ``dist.shard_batch``) splits each ``[n_dev * block_b, 16]`` launch
    along this axis.
    """
    kind = devmod.resolve(device).type
    if kind == "cuda":
        avail = torch.cuda.device_count()
        if n_dev is None:
            n_dev = avail
        if not 1 <= n_dev <= avail:
            raise ValueError(f"data mesh needs 1 <= n_dev <= {avail}"
                             f" devices, got {n_dev}")
        return Mesh.of([torch.device("cuda", i) for i in range(n_dev)])
    if kind != "cpu":
        raise ValueError(f"a data mesh runs on 'cuda' or 'cpu', not {kind}")
    n_dev = 1 if n_dev is None else n_dev
    if n_dev < 1:
        raise ValueError(f"data mesh needs n_dev >= 1, got {n_dev}")
    return Mesh.of(["cpu"] * n_dev)


def make_local_mesh(model: int = 1, *, device=devmod.DEFAULT_DEVICE) -> Mesh:
    """``("data", "model")`` mesh over the devices present: every GPU on
    ``cuda``, one entry on ``cpu``."""
    kind = devmod.resolve(device).type
    n = torch.cuda.device_count() if kind == "cuda" else 1
    if model < 1 or n % model:
        raise ValueError(f"model={model} does not divide {n} devices")
    devs = ([torch.device("cuda", i) for i in range(n)] if kind == "cuda"
            else [torch.device("cpu")])
    return Mesh(np.array(devs, dtype=object).reshape(n // model, model),
                ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production shapes, ``(16, 16)`` over ``("data",
    "model")`` or ``(2, 16, 16)`` over ``("pod", "data", "model")``, on the
    meta device: only shape arithmetic (``dist.sharding.resolve``) reads
    it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devs = [torch.device("meta")] * int(np.prod(shape))
    return Mesh(np.array(devs, dtype=object).reshape(shape), axes)

"""Atomic, asynchronous checkpoints in the reference's layout, so that a
checkpoint written by either package restores in the other:

  <dir>/step_<n>/manifest.json   keys, shapes and dtypes of the leaves
  <dir>/step_<n>/proc_0.npz      the leaves as arrays a0, a1, ...
  <dir>/step_<n>/COMMITTED       written last: the restart-safe marker

A step is written into ``.tmp_step_<n>`` and renamed into place; the
``keep`` newest committed steps survive. The counterpart of
``repro.train.checkpoint`` on one process. Keys are the reference's
``tree_flatten_with_path`` strings: dict keys sorted, ``['params']``;
NamedTuple fields in declaration order, ``.step``; joined by ``/``.
bfloat16 leaves are stored as the reference stores them, two raw bytes
an element (numpy dtype ``V2``) under the manifest dtype "bfloat16".

Unlike the reference, whose every save runs its own writer and GC, a
save first waits for the writer before it into the same directory, so a
directory's writers never overlap and each GC sees every earlier step.
Saves into other directories do not wait for it.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch import device as devmod

_locks_lock = threading.Lock()
_dir_locks: dict[Path, threading.Lock] = {}
_last_writer: dict[Path, threading.Thread] = {}


def _dir_lock(key: Path) -> threading.Lock:
    with _locks_lock:
        return _dir_locks.setdefault(key, threading.Lock())


def _flatten(tree, prefix=()):
    """(keys, leaves) in the reference's flattening order."""
    if isinstance(tree, dict):
        out = ([], [])
        for k in sorted(tree):
            ks, vs = _flatten(tree[k], prefix + (f"[{k!r}]",))
            out[0].extend(ks)
            out[1].extend(vs)
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = ([], [])
        for name, sub in zip(tree._fields, tree):
            ks, vs = _flatten(sub, prefix + (f".{name}",))
            out[0].extend(ks)
            out[1].extend(vs)
        return out
    return ["/".join(prefix)], [tree]


def _unflatten(tree, leaves):
    """A tree shaped as ``tree`` with the leaves taken in order."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(sub, leaves) for sub in tree))
    return next(leaves)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    """An array just read from the npz (its own, contiguous) as a tensor."""
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def save(ckpt_dir, step: int, tree, *, keep: int = 3, async_: bool = False):
    """Save a tree (nested dicts and NamedTuples) of tensors. The leaves
    are copied to host memory before save returns; with ``async_`` the
    files are written by a thread, which is returned. Either way the
    previous writer into ``ckpt_dir`` is waited for first."""
    ckpt_dir = Path(ckpt_dir)
    key = ckpt_dir.resolve()
    step_dir = ckpt_dir / f"step_{step:08d}"
    tmp_dir = ckpt_dir / f".tmp_step_{step:08d}"

    keys, vals = _flatten(tree)
    dtypes = [_dtype_name(v) for v in vals]
    host_vals = [_to_numpy(v) for v in vals]

    def _write():
        tmp_dir.mkdir(parents=True, exist_ok=True)
        manifest = {
            "step": step,
            "keys": keys,
            "shapes": [list(v.shape) for v in host_vals],
            "dtypes": dtypes,
            "n_processes": 1,
        }
        (tmp_dir / "manifest.json").write_text(json.dumps(manifest))
        np.savez(tmp_dir / "proc_0.npz",
                 **{f"a{i}": v for i, v in enumerate(host_vals)})
        (tmp_dir / "COMMITTED").write_text("ok")
        if step_dir.exists():
            shutil.rmtree(step_dir)
        tmp_dir.rename(step_dir)
        _gc(ckpt_dir, keep)

    with _dir_lock(key):   # a directory's writers one at a time, in order
        prev = _last_writer.pop(key, None)
        if prev is not None:
            prev.join()
        if async_:
            writer = threading.Thread(target=_write, daemon=True)
            _last_writer[key] = writer
            writer.start()
            return writer
        _write()
        return None


def _gc(ckpt_dir: Path, keep: int):
    steps = sorted(d for d in ckpt_dir.glob("step_*")
                   if (d / "COMMITTED").exists())
    for d in steps[:-keep]:
        shutil.rmtree(d, ignore_errors=True)


def latest_step(ckpt_dir) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(d.name.split("_")[1]) for d in ckpt_dir.glob("step_*")
             if (d / "COMMITTED").exists()]
    return max(steps) if steps else None


def restore(ckpt_dir, step: int, target_tree, *, device=None):
    """The tree saved at ``step``, shaped as ``target_tree`` (its values
    are ignored). Each leaf goes to ``device``, or when that is None to its
    target leaf's device (the default device for a meta target)."""
    step_dir = Path(ckpt_dir) / f"step_{step:08d}"
    if not (step_dir / "COMMITTED").exists():
        raise FileNotFoundError(f"no committed checkpoint at {step_dir}")
    manifest = json.loads((step_dir / "manifest.json").read_text())
    keys, targets = _flatten(target_tree)
    if keys != manifest["keys"]:
        raise ValueError("checkpoint tree structure mismatch")
    dev = None if device is None else devmod.resolve(device)
    with np.load(step_dir / "proc_0.npz") as data:
        vals = []
        for i, (tgt, dtype) in enumerate(zip(targets, manifest["dtypes"])):
            where = dev or (devmod.resolve() if tgt.device.type == "meta"
                            else tgt.device)
            vals.append(_from_numpy(data[f"a{i}"], dtype).to(where))
    return _unflatten(target_tree, iter(vals))

"""Device-pipelined execution of the paper's five stemmer stages.

The counterpart of ``repro.dist.pipeline``. The paper's pipelined FPGA
processor (Fig 15) overlaps the five stages on one word stream: while
stage 5 compares word t, stage 1 is already checking word t+4. On a mesh
the analogue is one stage a mesh entry along a ``"stage"`` axis:
microbatches flow from stage to stage in a skewed loop of ``m + S - 1``
ticks.

``pipeline_map`` is generic over any list of bundle -> bundle stage
functions (the bundle's keys and shapes are fixed, as the FPGA's
inter-stage registers are). ``stemmer_stage_fns`` gives the stemmer's
5-stage split: candidates / tri compare / quad compare / bi compare /
priority select. The candidates stage is the port's datapath
(``kernels.stem_datapath.stem_datapath``: K6 on a card, its plain version
on the CPU); the compare stages are ``core.stemmer.match_sorted``.

One process drives every entry, as the reference's ``shard_map`` is
driven by one controller: a tick runs each stage on its entry's device
(on that device's current stream), then hands each stage's bundle to the
next stage's device (the reference's ``ppermute``); the last stage's
outputs are gathered on the first entry (the reference's ``psum`` of the
last stage's outputs). Entries may repeat a device
(``launch.mesh.Mesh.of(["cuda:0"] * 5)``). Bit-identical to
``core.stemmer.stem_batch``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import stemmer
from repro_torch.dist.shard_batch import on_device, replica
from repro_torch.dist.sharding import axis_devices, mesh_axis_size
from repro_torch.kernels import stem_datapath as sdp
from repro_torch.kernels import stem_fused as sf
from repro_torch.kernels import stem_match as sm

N_SLOTS = 30  # 5 groups x 6 candidates (stem_datapath layout)


def _move(bundle: dict, dev: torch.device) -> dict:
    return {k: v.to(dev, non_blocking=True) for k, v in bundle.items()}


def pipeline_map(stage_fns, bundle: dict, mesh, axis: str = "stage"):
    """Run ``stage_fns[s]`` on entry s of ``mesh[axis]``, streaming the
    leading (microbatch) dimension of ``bundle`` through the stages.

    bundle: dict of tensors with one leading dim m. Each stage maps a
    one-microbatch bundle (leading dim dropped) to a bundle of the same
    keys and shapes. Tick t: stage 0 takes microbatch ``clip(t, 0, m-1)``,
    every stage runs on what it holds (zeros while the pipe fills), the
    last stage's result is microbatch ``t - (S-1)`` once that is >= 0, and
    each stage's result moves to the next stage's device for tick t+1.
    Returns the bundle after every stage, on the mesh's first entry.
    """
    stage_fns = list(stage_fns)
    s_count = len(stage_fns)
    n = mesh_axis_size(mesh, axis)
    if n != s_count:
        raise ValueError(f"mesh axis {axis!r} has size {n}, need {s_count}")
    devs = axis_devices(mesh, axis)
    m = next(iter(bundle.values())).shape[0]
    state = [{k: torch.zeros_like(v[0], device=d) for k, v in bundle.items()}
             for d in devs]
    outs = {k: torch.zeros_like(v, device=devs[-1])
            for k, v in bundle.items()}
    for t in range(m + s_count - 1):
        results = []
        for s, (fn, dev) in enumerate(zip(stage_fns, devs)):
            with on_device(dev):
                cur = state[s]
                if s == 0:
                    i = min(max(t, 0), m - 1)
                    cur = _move({k: v[i] for k, v in bundle.items()}, dev)
                results.append(fn(cur))
        t_out = t - (s_count - 1)
        if t_out >= 0:
            with on_device(devs[-1]):
                for k, v in results[-1].items():
                    outs[k][t_out] = v
        # the ppermute: stage s's result is stage s+1's input next tick
        # (stage 0 takes a fresh microbatch, so the wrap-around is unused)
        for s in range(1, s_count):
            with on_device(devs[s]):
                state[s] = _move(results[s - 1], devs[s])
    with on_device(devs[0]):
        return _move(outs, devs[0])


def _slot_mask(groups) -> np.ndarray:
    mask = np.zeros(32, bool)
    for g in groups:
        mask[g * 6:(g + 1) * 6] = True
    return mask


def _streamed_match_sorted(keys, dict_keys, chunk_keys: int):
    """OR-accumulating chunked sorted match, the counterpart of the
    reference's: the sorted dictionary swept in ``chunk_keys``-sized
    sentinel-padded tiles (each tile stays sorted, so each tile's search is
    exact) while the candidate keys stay live."""
    r = dict_keys.shape[0]
    n_tiles = max(1, -(-r // chunk_keys))
    padded = torch.full((n_tiles * chunk_keys,), sm.DICT_SENTINEL,
                        dtype=dict_keys.dtype, device=dict_keys.device)
    padded[:r] = dict_keys
    acc = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    for t in range(n_tiles):
        acc |= stemmer.match_sorted(keys,
                                    padded[t * chunk_keys:(t + 1) * chunk_keys])
    return acc


def stemmer_stage_fns(roots, *, residency: str = "auto",
                      chunk_keys: int = 1 << 14):
    """The paper's 5-stage split over a bundle of ``{words[mb, 16],
    keys[mb, 32], valid[mb, 32], root[mb, 4], source[mb]}`` (int32).

    Stage 1 runs the character datapath (the paper's stages 1-4 fused, as
    in K6); stages 2-4 are the Compare stage split a dictionary (tri /
    quad / bi; ``valid`` doubles as the running hit mask, the FPGA's
    inter-stage flag register); stage 5 is the priority select. Each stage
    runs on its bundle's device, with the dictionary's tables copied there
    once.

    residency mirrors the megakernel policy: "resident" matches against
    the whole dictionary at once, "streamed" sweeps it in
    ``chunk_keys``-sized tiles with an OR-accumulating hit mask, "auto"
    (default) streams any table larger than ``chunk_keys``.
    """
    if residency not in ("resident", "streamed", "auto"):
        raise ValueError(f"unknown residency: {residency!r}")
    arrays, _, _ = stemmer.unwrap_dict(roots)
    masks = {name: torch.from_numpy(_slot_mask(groups))
             for name, groups in (("tri", (0, 2, 3)), ("quad", (1,)),
                                  ("bi", (4,)))}

    def candidates(b):
        keys, valid = sdp.stem_datapath(b["words"])
        return {**b, "keys": keys, "valid": valid}

    def compare(name):
        table = getattr(arrays, name)
        streamed = residency == "streamed" or (
            residency == "auto" and table.shape[0] > chunk_keys)
        copies, mask_copies = {}, {}

        def fn(b):
            dev = b["keys"].device
            dict_keys = replica(table, dev, copies)
            mask = replica(masks[name], dev, mask_copies)
            if streamed:
                hit = _streamed_match_sorted(b["keys"], dict_keys,
                                             chunk_keys)
            else:
                hit = stemmer.match_sorted(b["keys"], dict_keys)
            valid = torch.where(mask[None, :], b["valid"] * hit, b["valid"])
            return {**b, "valid": valid.to(torch.int32)}
        return fn

    def select(b):
        hits = b["valid"][:, :N_SLOTS] > 0
        first = torch.argmax(hits.to(torch.int32), dim=1)
        found = hits.any(dim=1)
        chosen = torch.gather(b["keys"], 1, first[:, None])[:, 0]
        root = torch.where(
            found[:, None],
            torch.stack([(chosen >> 18) & 63, (chosen >> 12) & 63,
                         (chosen >> 6) & 63, chosen & 63], dim=1), 0)
        tags = torch.tensor([t for t in sf.GROUP_TAGS for _ in range(6)],
                            dtype=torch.int32, device=first.device)
        source = torch.where(found, tags[first], 0)
        return {**b, "root": root.to(torch.int32),
                "source": source.to(torch.int32)}

    return [candidates, compare("tri"), compare("quad"), compare("bi"),
            select]

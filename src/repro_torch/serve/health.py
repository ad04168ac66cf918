"""Serving health: the structured engine event stream and the
graceful-degradation ladder.

The counterpart of ``repro.serve.health``. With ``data_devices=1`` the
ladder has no device rungs; with N it ends in ``devices-d`` rungs that
reshard onto the mesh's first d entries
(``dist.shard_batch.device_downshift_ladder``).

Every notable serving incident — a terminal :class:`FailureInfo`, a
retry/bisection/quarantine, a checksum or flag mismatch, a watchdog
stall, a device loss, a ladder transition, a warm restart — is emitted
as an :class:`EngineEvent` into a shared :class:`EventLog` that
``Engine.events()`` exposes, so operators (and the chaos matrix) read
one stream instead of grepping counters scattered across the workload.

:class:`DegradationPolicy` closes the loop: observed once per engine
step, it walks a precomputed ladder of :class:`ServingMode` rungs

    persistent -> megabatch -> per-tile
    resident dictionary -> streamed
    data_devices = N -> N/2 -> ... -> 1

downshifting one rung after ``down_after`` consecutive unhealthy steps
(new faults, or queue length past ``queue_high``) and upshifting one
rung after ``up_after`` consecutive healthy steps — classic hysteresis,
so a single fault burst cannot make the ladder oscillate. A device loss
is special-cased: it downshifts immediately to the first rung with
fewer data devices and *caps* the ladder there (a lost device does not
come back). Every rung serves bit-identically (the megakernel paths are
parity-tested against each other), so transitions change throughput and
footprint, never results; the workload applies a requested mode only at
a tick whose ring is empty, so in-flight launches keep the geometry
they dispatched with.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field

from repro_torch.dist.shard_batch import device_downshift_ladder


@dataclass(frozen=True)
class EngineEvent:
    """One structured serving incident: ``kind`` + monotonic timestamp +
    free-form payload (rids, counts, rung labels...)."""

    kind: str
    t: float
    data: dict = field(default_factory=dict)


class EventLog:
    """Bounded in-memory event stream shared by engine, workload and
    policy; ``maxlen`` keeps a long-lived server's log from growing
    without bound (oldest events drop first)."""

    def __init__(self, maxlen: int = 4096):
        self._events: collections.deque = collections.deque(maxlen=maxlen)

    def emit(self, kind: str, **data) -> EngineEvent:
        ev = EngineEvent(kind, time.monotonic(), data)
        self._events.append(ev)
        return ev

    def snapshot(self) -> list[EngineEvent]:
        return list(self._events)

    def drain(self) -> list[EngineEvent]:
        out = list(self._events)
        self._events.clear()
        return out

    def count(self, kind: str) -> int:
        return sum(e.kind == kind for e in self._events)


@dataclass(frozen=True)
class ServingMode:
    """One ladder rung: the launch geometry + dictionary residency the
    workload should serve with. ``residency=None`` keeps the residency
    each published handle pinned; "streamed" overrides resident handles
    onto the streamed fence-search path (less shared memory a block)."""

    label: str
    persistent: bool = False
    megabatch_tiles: int = 1
    data_devices: int = 1
    residency: str | None = None


def build_ladder(*, persistent: bool = False, megabatch_tiles: int = 1,
                 data_devices: int = 1,
                 resident_dict: bool = True) -> tuple[ServingMode, ...]:
    """The degradation ladder for a workload configuration, top rung
    first (the configured mode) down to the most conservative one.

    Rung order mirrors blast radius: drop the persistent descriptor
    ring first (a wedged kernel is the sharpest failure), then megabatch
    depth, then force the dictionary onto the streamed path, then shed
    data devices (halving; every count shard_batch pads for serves
    bit-identically).
    """
    rungs: list[ServingMode] = []
    if persistent:
        rungs.append(ServingMode("persistent", True, megabatch_tiles,
                                 data_devices))
    if megabatch_tiles > 1:
        rungs.append(ServingMode(f"megabatch x{megabatch_tiles}", False,
                                 megabatch_tiles, data_devices))
    rungs.append(ServingMode("per-tile", False, 1, data_devices))
    if resident_dict:
        rungs.append(ServingMode("streamed-dict", False, 1, data_devices,
                                 "streamed"))
    override = "streamed" if resident_dict else None
    for d in device_downshift_ladder(data_devices):
        if d < data_devices:
            rungs.append(ServingMode(f"devices-{d}", False, 1, d, override))
    return tuple(rungs)


class DegradationPolicy:
    """Hysteresis controller over the ladder; observed once per engine
    step (``Engine`` calls :meth:`observe` at the end of ``step()``).

    A step is *unhealthy* when the workload's fault counters advanced
    since the last observation or the queue length is at/past
    ``queue_high``; ``down_after`` consecutive unhealthy steps downshift
    one rung, ``up_after`` consecutive healthy steps upshift one. Device
    losses bypass the hysteresis (see module docstring). All transitions
    are emitted as ``degrade``/``upshift`` events and recorded in
    ``transitions``.
    """

    FAULT_COUNTERS = ("retries_total", "checksum_failures", "timeouts",
                      "watchdog_stalls", "device_losses")

    def __init__(self, *, queue_high: int | None = None, down_after: int = 2,
                 up_after: int = 8, rungs=None):
        if queue_high is not None and queue_high < 1:
            raise ValueError(f"queue_high must be >= 1, got {queue_high}")
        if down_after < 1 or up_after < 1:
            raise ValueError("down_after and up_after must be >= 1")
        self.queue_high = queue_high
        self.down_after = down_after
        self.up_after = up_after
        self.rungs = tuple(rungs) if rungs is not None else None
        self.level = 0
        self.transitions: list[tuple[str, str, str]] = []  # (from, to, why)
        self._unhealthy = 0
        self._healthy = 0
        self._last: dict | None = None
        self._workload = None
        self._events: EventLog | None = None
        self._device_cap: int | None = None

    # -- wiring (Engine calls attach at construction) ----------------------
    def attach(self, workload, events: EventLog) -> None:
        if not hasattr(workload, "request_mode"):
            raise ValueError(
                "DegradationPolicy needs a workload with mode transitions"
                f" (request_mode); {type(workload).__name__} has none")
        self._workload = workload
        self._events = events
        if self.rungs is None:
            store = getattr(workload, "store", None)
            resident = (store is not None
                        and store.acquire().handle.residency == "resident")
            self.rungs = build_ladder(
                persistent=workload.persistent,
                megabatch_tiles=workload.megabatch_tiles,
                data_devices=workload.data_devices,
                resident_dict=resident)
        self._last = self._counters()

    @property
    def mode(self) -> ServingMode:
        return self.rungs[self.level]

    def _counters(self) -> dict:
        return {c: getattr(self._workload, c, 0)
                for c in self.FAULT_COUNTERS}

    # -- the control loop --------------------------------------------------
    def observe(self, engine) -> None:
        if self._workload is None:
            raise RuntimeError("policy not attached to a workload")
        cur = self._counters()
        new_faults = sum(cur[c] - self._last[c] for c in self.FAULT_COUNTERS)
        lost = cur["device_losses"] - self._last["device_losses"]
        self._last = cur
        if lost > 0:
            self._on_device_loss()
            return
        unhealthy = (new_faults > 0
                     or (self.queue_high is not None
                         and len(engine.queue) >= self.queue_high))
        if unhealthy:
            self._healthy = 0
            self._unhealthy += 1
            if (self._unhealthy >= self.down_after
                    and self.level + 1 < len(self.rungs)):
                self._shift(self.level + 1,
                            "faults" if new_faults else "queue")
                self._unhealthy = 0
        else:
            self._unhealthy = 0
            self._healthy += 1
            if self._healthy >= self.up_after and self.level > 0:
                target = self.level - 1
                if (self._device_cap is None
                        or self.rungs[target].data_devices
                        <= self._device_cap):
                    self._shift(target, "healthy")
                self._healthy = 0

    def _on_device_loss(self) -> None:
        """Immediate downshift to the first rung with fewer data devices,
        capping the ladder there — a lost device does not come back, so
        upshift never climbs above the cap."""
        d = self.mode.data_devices
        cap = next((r.data_devices for r in self.rungs
                    if r.data_devices < d), 1)
        self._device_cap = (cap if self._device_cap is None
                            else min(self._device_cap, cap))
        target = next((i for i in range(self.level + 1, len(self.rungs))
                       if self.rungs[i].data_devices <= cap), None)
        if target is not None:
            self._shift(target, "device_loss")
        self._unhealthy = self._healthy = 0

    def _shift(self, target: int, reason: str) -> None:
        old, new = self.rungs[self.level], self.rungs[target]
        kind = "degrade" if target > self.level else "upshift"
        self.level = target
        self._workload.request_mode(new)
        self.transitions.append((old.label, new.label, reason))
        if self._events is not None:
            self._events.emit(kind, reason=reason,
                              **{"from": old.label, "to": new.label})

"""Deterministic fault injection for the serving / indexing stack.

The counterpart of ``repro.serve.faults``, copied whole (numpy only), so
one :class:`FaultPlan` replays the same faults against either package.

Production serving survives faults only if the recovery paths are
exercised constantly, so every failure mode the engine and the index
builder claim to tolerate is drivable from here, deterministically:

  site ``dispatch``   fail (raise) or delay (sleep) the Nth launch the
                      injector sees — the StemmerWorkload ring and the
                      chunked index builder both report each compute
                      launch before running it.
  site ``retire``     corrupt the host copy of a retired tile's device
                      arrays *before* checksum verification, simulating
                      a torn readback / DMA fault.
  site ``publish``    reject the Nth ``DictStore`` publish after
                      validation but before the version bump — proving
                      the two-phase publish leaves the store untouched.
  site ``checkpoint`` tear (truncate) the Nth index-checkpoint file as
                      it is written, before the builder's readback
                      verification.
  site ``stall``      wedge the Nth *persistent* launch: the ring treats
                      it as never-ready until the watchdog abandons it
                      and re-dispatches the unretired descriptors down
                      the megabatch path. ``retired_tiles`` on the spec
                      says how many leading descriptors "completed"
                      before the wedge (their results are salvaged).
  site ``device_loss``raise :class:`DeviceLost` at the Nth *sharded*
                      launch — the deterministic stand-in for losing a
                      device out of the ``("data",)`` mesh; the
                      degradation ladder reshards onto fewer devices.
                      Only a launch over a mesh of two or more entries
                      (``StemmerWorkload(data_devices > 1)``) reaches it.
  site ``journal``    tear the Nth write-ahead journal append in half —
                      the torn tail a crash mid-write leaves, which
                      recovery must truncate.

A :class:`FaultPlan` is a seeded, ordered tuple of :class:`FaultSpec`s
plus an optional poison set: any dispatch whose request ids intersect
``poison_rids`` fails *every* time, which is what drives the engine's
bisection quarantine. Event counting is per site and strictly
sequential, so a given (plan, workload) pair replays the same faults on
every run — the chaos matrix in CI relies on that to assert bit-identical
recovery.

The default is no injector at all (``injector=None`` everywhere), and
callers guard every hook behind ``if injector is not None``; the fault
layer costs the hot path nothing when unused.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

SITES = ("dispatch", "retire", "publish", "checkpoint", "stall",
         "device_loss", "journal")

# legal fault kinds per site (first entry is the default for the site)
KINDS = {
    "dispatch": ("fail", "delay"),
    "retire": ("corrupt",),
    "publish": ("reject",),
    "checkpoint": ("tear",),
    "stall": ("wedge",),
    "device_loss": ("lost",),
    "journal": ("tear",),
}


class InjectedFault(RuntimeError):
    """Raised by the injector at a faulted event (and nowhere else)."""


class DeviceLost(InjectedFault):
    """A sharded launch lost a device of its mesh (site ``device_loss``)."""


@dataclass(frozen=True)
class FailureInfo:
    """Structured terminal failure attached to a request.

    ``code`` is one of:
      ``quarantined``  the request was isolated by retry bisection (its
                       launches kept failing after ``max_retries``)
      ``deadline``     the request's deadline expired before it finished
      ``shed``         admission control rejected it at a full queue
      ``cancelled``    ``run_until_drained(on_undrained="raise")`` or
                       ``cancel_pending()`` tore it down mid-flight
    ``retries`` counts the dispatch attempts charged to the request's
    last failing group; ``detail`` carries the underlying exception text.
    """

    rid: int
    code: str
    retries: int = 0
    detail: str = ""


@dataclass(frozen=True)
class FaultSpec:
    """One deterministic fault: fire at the ``at``-th event (0-based) a
    site sees, for ``count`` consecutive events."""

    site: str
    kind: str = ""            # "" -> the site's default kind
    at: int = 0
    count: int = 1
    delay_s: float = 0.02     # kind="delay" only
    retired_tiles: int = 0    # kind="wedge" only: descriptors done pre-wedge

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}"
                             f" (choose from {SITES})")
        kind = self.kind or KINDS[self.site][0]
        object.__setattr__(self, "kind", kind)
        if kind not in KINDS[self.site]:
            raise ValueError(f"site {self.site!r} supports kinds"
                             f" {KINDS[self.site]}, not {kind!r}")
        if self.at < 0 or self.count < 1:
            raise ValueError("need at >= 0 and count >= 1")
        if self.retired_tiles < 0:
            raise ValueError(
                f"retired_tiles must be >= 0, got {self.retired_tiles}")

    def covers(self, event: int) -> bool:
        return self.at <= event < self.at + self.count


@dataclass(frozen=True)
class FaultPlan:
    """A seeded, replayable set of faults.

    ``poison_rids`` marks requests as poison pills: any dispatch whose
    segment set includes one of them fails unconditionally (on top of
    whatever the occurrence-counted specs do), independent of event
    order — the deterministic stand-in for "this input crashes the
    kernel every time".
    """

    specs: tuple = ()
    seed: int = 0
    poison_rids: frozenset = field(default_factory=frozenset)

    def __post_init__(self):
        specs = tuple(self.specs)
        for s in specs:
            # a duck-typed tuple/dict (or a spec whose site dodged
            # FaultSpec validation) would be carried but never fire —
            # a chaos plan that silently tests nothing. Reject it here.
            if not isinstance(s, FaultSpec):
                raise TypeError(
                    f"FaultPlan specs must be FaultSpec instances, got"
                    f" {type(s).__name__}: {s!r}")
            if s.site not in SITES:
                raise ValueError(f"unknown fault site {s.site!r}"
                                 f" (choose from {SITES})")
        object.__setattr__(self, "specs", specs)
        object.__setattr__(self, "poison_rids",
                           frozenset(int(r) for r in self.poison_rids))


class FaultInjector:
    """Executes a :class:`FaultPlan`; one instance per run.

    Carries per-site event counters and a ``fired`` log of
    ``(site, kind, event_index)`` tuples so tests and the chaos matrix
    can assert the plan actually triggered. Corruption draws from a rng
    seeded by ``(plan.seed, event_index)`` — deterministic per event, so
    replays corrupt identically.
    """

    def __init__(self, plan: FaultPlan | None = None):
        self.plan = plan or FaultPlan()
        self.events = {site: 0 for site in SITES}
        self.fired: list[tuple] = []

    # -- bookkeeping --------------------------------------------------
    def _step(self, site: str) -> list[FaultSpec]:
        ev = self.events[site]
        self.events[site] = ev + 1
        hits = [s for s in self.plan.specs
                if s.site == site and s.covers(ev)]
        for s in hits:
            self.fired.append((site, s.kind, ev))
        return hits

    # -- the four sites ----------------------------------------------
    def on_dispatch(self, rids=()) -> None:
        """Called once per compute launch, before it runs. Raises
        :class:`InjectedFault` to fail the launch, or sleeps to delay
        it; poison rids fail unconditionally."""
        ev = self.events["dispatch"]
        hits = self._step("dispatch")
        poisoned = self.plan.poison_rids.intersection(int(r) for r in rids)
        if poisoned:
            self.fired.append(("dispatch", "poison", ev))
            raise InjectedFault(
                f"injected poison dispatch (rids {sorted(poisoned)})")
        for s in hits:
            if s.kind == "delay":
                import time
                time.sleep(s.delay_s)
            else:
                raise InjectedFault(f"injected dispatch failure (event {ev})")

    def on_retire(self, roots: np.ndarray, sources: np.ndarray):
        """Called with the host copies of a retired tile's arrays,
        before checksum verification. Returns (possibly corrupted)
        arrays; corruption is a deterministic bit flip."""
        ev = self.events["retire"]
        hits = self._step("retire")
        if not hits:
            return roots, sources
        rng = np.random.default_rng((self.plan.seed, ev))
        roots = np.array(roots, copy=True)
        row = int(rng.integers(0, roots.shape[0]))
        roots[row, int(rng.integers(0, roots.shape[1]))] ^= 0x5A
        return roots, sources

    def on_publish(self) -> None:
        """Called between validation and the atomic version bump."""
        ev = self.events["publish"]
        if self._step("publish"):
            raise InjectedFault(f"injected publish rejection (event {ev})")

    def on_checkpoint(self, path: str) -> None:
        """Called on a freshly written (not yet renamed) checkpoint
        file; tearing truncates it mid-record."""
        if not self._step("checkpoint"):
            return
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(1, size // 2))

    def on_stall(self) -> FaultSpec | None:
        """Called once per *persistent* launch, after it dispatches.
        Returns the covering wedge spec (the serving ring then treats
        the launch as never-ready until the watchdog abandons it;
        ``spec.retired_tiles`` leading descriptors count as completed
        before the wedge) or None."""
        hits = self._step("stall")
        return hits[0] if hits else None

    def on_device_loss(self) -> None:
        """Called once per *sharded* launch, before it runs. Raises
        :class:`DeviceLost` at a faulted event — the degradation
        ladder's cue to reshard onto fewer data devices."""
        ev = self.events["device_loss"]
        if self._step("device_loss"):
            raise DeviceLost(f"injected device loss (event {ev})")

    def on_journal(self, path: str, nbytes: int = 0) -> None:
        """Called after each journal append with the appended record's
        byte length; tearing truncates that record in half — the torn
        tail a crash mid-write leaves for recovery to drop."""
        if not self._step("journal"):
            return
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(0, size - max(1, nbytes // 2)))

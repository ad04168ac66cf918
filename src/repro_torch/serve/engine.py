"""Serving core: queue/admit/finish continuous batching of stemmer and LM
decode requests.

The counterpart of ``repro.serve.engine``'s ``Engine``,
``StemmerWorkload``, ``LMDecodeWorkload`` and the ``ServeEngine`` facade
(Engine + LMDecodeWorkload). The scheduler (:class:`Engine`) owns the
FIFO request queue, rid allocation, admission and the finished table;
what a tick of work means is delegated to a :class:`Workload`.

:class:`StemmerWorkload` coalesces queued word-batch requests into
megabatches of up to ``megabatch_tiles`` ``[block_b, 16]`` tiles, each
megabatch ONE stemmer-kernel launch (``ops.extract_roots_fused``, or with
``persistent=True`` the descriptor-ring kernel through
``ops.extract_roots_persistent``; a streamed dictionary may split a launch
into visit-budget chunks). A tick is a dispatch/retire pass over a ring of
up to ``max_inflight`` outstanding launches:

  retire    every launch whose results have reached the host is scattered
            back into its requests, after its per-tile checksum is
            re-derived on the host and compared with the device's (and,
            persistent, after every completion flag reads 1 + the
            dictionary version pinned at dispatch);
  dispatch  pending words are packed FIFO into a free slot's pinned host
            staging buffer, copied to the device, launched, and the
            outputs copied back asynchronously into the slot's pinned
            output buffers; a CUDA event recorded after those copies says
            when the host may read them. A persistent launch writes its
            completion flags straight into the slot's host-mapped flags
            (``stem_fused.MappedFlags``), which the host reads without a
            copy;
  drain     only a tick that would otherwise make no progress blocks:
            saturated, it waits for the oldest launch; draining, it
            waits for all of them.

A slot's buffers are reused only after its launch retires or is
abandoned. Each launch pins the DictStore version it acquired at
dispatch, so a hot swap landing between dispatch and retire stays exact
per word. On the CPU the launch runs synchronously and a tile is ready as
soon as it is dispatched.

Failure model, as the reference's: requests carry optional deadlines,
the queue has optional cap-based admission control
(``on_full="raise"|"shed"|"block"``), and the stemmer ring retries failed,
timed-out or checksum-failed launches up to ``max_retries`` times before
bisecting the group to quarantine the poison request(s); every terminal
failure comes back through the finished table with a
:class:`~repro_torch.serve.faults.FailureInfo`. ``max_retries=0`` is the
strict mode: the first failure propagates. A persistent launch past
``watchdog_s`` is abandoned: an injected wedge's retired prefix is
salvaged, the rest re-dispatched down the megabatch path. A real wedge
blocks the CUDA stream, and every launch queued behind it, so nothing is
salvaged from it (ROADMAP §3, known limit). The engine journals admits
and retires (``journal=``), walks the degradation ladder (``policy=``)
and rebuilds itself from a journal (:meth:`Engine.recover`).

:class:`LMDecodeWorkload` runs greedy decode of the dense-attention LMs,
one slot per request, with deadline expiry and cancellation.

``StemmerWorkload(data_devices=N)`` splits every launch across a
``("data",)`` mesh of N entries (``ops.extract_roots_sharded``): a launch
is up to ``megabatch_tiles`` super-tiles of ``[N * block_b, 16]``, each
entry runs its contiguous shard, and retire verifies the merged rows. The
ladder's ``devices-d`` rungs reshard onto the mesh's first d entries.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch import tracing
from repro_torch.core import alphabet as ab
from repro_torch.dist.shard_batch import on_device
from repro_torch.dist.sharding import axis_devices
from repro_torch.kernels import ops
from repro_torch.models import model as model_mod
from repro_torch.models import params as pm
from repro_torch.serve.faults import DeviceLost, FailureInfo
from repro_torch.serve.health import EventLog


@runtime_checkable
class Workload(Protocol):
    """What the generic Engine needs from a servable workload."""

    def make_request(self, rid: int, payload, **opts):
        """Validate + wrap a submission; raise ValueError on bad configs."""

    def has_capacity(self) -> bool:
        """Can admit() take one more request right now?"""

    def admit(self, request) -> None:
        """Move a queued request in-flight."""

    def tick(self) -> list:
        """Advance all in-flight work one step; return finished requests."""

    @property
    def active(self) -> int:
        """Number of in-flight (admitted, unfinished) requests."""

    def pending_rids(self) -> list[int]:
        """rids of in-flight requests (for drain reports)."""

    def expire(self, now: float) -> list:
        """Fail + return in-flight requests whose deadline passed."""

    def cancel_pending(self) -> list:
        """Tear down all in-flight work; fail + return the requests."""


@dataclass
class DrainReport:
    """Outcome of run_until_drained: ticks spent and what is still owed."""

    ticks: int
    drained: bool
    pending: list[int]   # rids still queued or in flight at max_ticks
    cancelled: list = field(default_factory=list)
    # rids cancelled and returned through finished by
    # on_undrained="raise", each with FailureInfo(code="cancelled")


class EngineUndrained(RuntimeError):
    """max_ticks elapsed with requests still queued or in flight."""

    def __init__(self, report: DrainReport):
        self.report = report
        super().__init__(
            f"engine not drained after {report.ticks} ticks:"
            f" {len(report.pending)} request(s) unfinished"
            f" (rids {report.pending};"
            f" {len(report.cancelled)} cancelled + returned)")


class QueueFull(RuntimeError):
    """submit() against a full queue under on_full="raise"."""


class Engine:
    """Continuous batching over any Workload.

    submit() validates through the workload and queues; step() expires
    deadlines, admits while the workload has capacity, then runs one
    workload tick; finished requests move to the results table keyed by
    rid.

    ``queue_cap`` bounds the queued (not yet admitted) requests; a submit
    against a full queue follows ``on_full``: "raise" rejects with
    :class:`QueueFull`, "shed" finishes the request at once with
    ``FailureInfo(code="shed")``, "block" serves the backlog inline until
    a place frees. ``deadline_s`` on submit stamps an absolute deadline;
    expiry (checked each step, queued or in flight) finishes the request
    with ``FailureInfo(code="deadline")`` while later requests proceed.
    ``journal`` (a :class:`~repro_torch.serve.journal.Journal`) makes
    every admit durable before it is served and records every retire;
    ``policy`` (a :class:`~repro_torch.serve.health.DegradationPolicy`)
    is observed after every step.
    """

    ON_FULL = ("raise", "shed", "block")

    def __init__(self, workload: Workload, *, queue_cap: int | None = None,
                 on_full: str = "raise", journal=None, policy=None):
        if on_full not in self.ON_FULL:
            raise ValueError(f"unknown on_full policy {on_full!r}"
                             f" (choose from {self.ON_FULL})")
        if queue_cap is not None and queue_cap < 1:
            raise ValueError(f"queue_cap must be >= 1, got {queue_cap}")
        if on_full != "raise" and queue_cap is None:
            raise ValueError(f"on_full={on_full!r} needs a queue_cap"
                             " (an unbounded queue is never full)")
        self.workload = workload
        self.queue: list = []
        self.finished: dict[int, object] = {}
        self.queue_cap = queue_cap
        self.on_full = on_full
        self.shed = 0            # requests rejected by admission control
        self._next_rid = 0
        self.journal = journal
        # one event stream for engine, workload and policy
        self.events_log: EventLog = (getattr(workload, "events", None)
                                     or EventLog())
        self.policy = policy
        if policy is not None:
            policy.attach(workload, self.events_log)
        self.recovery = None     # RecoveryReport when built by recover()

    # -- client API --------------------------------------------------------
    def _queue_full(self) -> bool:
        return (self.queue_cap is not None
                and len(self.queue) >= self.queue_cap)

    def submit(self, payload, *, deadline_s: float | None = None,
               **opts) -> int:
        with tracing.span("serve.submit", self._next_rid):
            return self._submit(payload, deadline_s, opts)

    def _submit(self, payload, deadline_s: float | None, opts: dict) -> int:
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        if self._queue_full():
            if self.on_full == "raise":
                raise QueueFull(
                    f"queue at cap {self.queue_cap}; submit rejected"
                    " (on_full='raise')")
            if self.on_full == "block":
                for _ in range(100_000):
                    self.step()
                    if not self._queue_full():
                        break
                else:
                    raise RuntimeError(
                        "on_full='block' made no progress against a full"
                        " queue — the workload is wedged")
        with tracing.span("serve.make_request", self._next_rid):
            req = self.workload.make_request(self._next_rid, payload, **opts)
        rid = self._next_rid
        self._next_rid += 1
        if deadline_s is not None:
            req.deadline = time.monotonic() + deadline_s
        if self._queue_full():           # only reachable under "shed"
            req.failure = FailureInfo(rid, "shed",
                                      detail=f"queue at cap {self.queue_cap}")
            req.done = True
            self._finish(req)           # shed work is terminal, never
            self.shed += 1              # journaled as an admit
            return rid
        if self.journal is not None:
            # write-ahead: the admit is durable before the request can be
            # served, so a crash between here and retire re-serves it
            store = getattr(self.workload, "store", None)
            self.journal.admit(
                rid, payload, deadline_s=deadline_s,
                dict_version=None if store is None else store.version,
                opts=opts)
        self.queue.append(req)
        return rid

    def result(self, rid: int):
        return self.finished.get(rid)

    def events(self, *, drain: bool = False) -> list:
        """The structured event stream: failures, retries, checksum
        failures, watchdog stalls, ladder transitions, recovery."""
        return (self.events_log.drain() if drain
                else self.events_log.snapshot())

    def _finish(self, req) -> None:
        """The single exit into the finished table: emits the failure
        event and the journal's retire record alongside."""
        self.finished[req.rid] = req
        if req.failure is not None:
            self.events_log.emit("failure", rid=req.rid,
                                 code=req.failure.code,
                                 detail=req.failure.detail)
        if self.journal is not None:
            self.journal.retire(req)

    @property
    def active(self) -> int:
        return self.workload.active

    # -- scheduling --------------------------------------------------------
    def step(self) -> None:
        """One engine tick: expire deadlines, admit while there is
        capacity, then tick the workload."""
        now = time.monotonic()
        if self.queue:
            still = []
            for req in self.queue:
                dl = getattr(req, "deadline", None)
                if dl is not None and now > dl:
                    req.failure = FailureInfo(req.rid, "deadline",
                                              detail="expired while queued")
                    req.done = True
                    self._finish(req)
                else:
                    still.append(req)
            self.queue = still
        expire = getattr(self.workload, "expire", None)
        if expire is not None:
            for req in expire(now):
                self._finish(req)
        while self.queue and self.workload.has_capacity():
            self.workload.admit(self.queue.pop(0))
        for req in self.workload.tick():
            self._finish(req)
        if self.policy is not None:
            self.policy.observe(self)

    def run_until_drained(self, max_ticks: int = 1000, *,
                          on_undrained: str = "raise") -> DrainReport:
        """Tick until queue + in-flight are empty, or max_ticks elapse.

        At max_ticks with work outstanding, on_undrained="raise" (the
        default) cancels the stranded requests (each lands in the finished
        table with FailureInfo(code="cancelled")) and raises
        EngineUndrained carrying the report, leaving the engine empty and
        reusable; "return" hands back the report with drained=False and
        leaves the work in place, so the drain can be resumed.
        """
        if on_undrained not in ("raise", "return"):
            raise ValueError(f"unknown on_undrained policy: {on_undrained!r}")
        ticks = 0
        while (self.queue or self.workload.active) and ticks < max_ticks:
            self.step()
            ticks += 1
        pending = ([r.rid for r in self.queue]
                   + self.workload.pending_rids())
        if pending and on_undrained == "raise":
            cancelled = []
            for req in self.queue:
                req.failure = FailureInfo(req.rid, "cancelled",
                                          detail="undrained at max_ticks"
                                                 " (still queued)")
                req.done = True
                self._finish(req)
                cancelled.append(req.rid)
            self.queue = []
            cancel = getattr(self.workload, "cancel_pending", None)
            if cancel is not None:
                for req in cancel():
                    self._finish(req)
                    cancelled.append(req.rid)
            raise EngineUndrained(DrainReport(ticks=ticks, drained=False,
                                              pending=pending,
                                              cancelled=cancelled))
        return DrainReport(ticks=ticks, drained=not pending,
                           pending=pending)

    # -- warm restart ------------------------------------------------------
    @classmethod
    def recover(cls, journal_path, workload: Workload, *,
                queue_cap: int | None = None, on_full: str = "raise",
                policy=None, fsync_every: int = 32) -> "Engine":
        """Rebuild an engine from a write-ahead journal after a crash.

        Reads the journal (truncating a torn tail), re-queues every admit
        with no matching retire, in rid order, through the normal FIFO
        path, and reopens the journal for appending. Replayed requests
        re-verify their payload digest, re-arm their deadline window and
        re-pin the dict version they were admitted under
        (``workload.store`` must still hold it: pair the journal with
        ``DictStore.snapshot``/``restore``). Retired requests are not
        re-served. The combined (finished before the crash + recovered)
        outputs are bit-identical to an uninterrupted run. Reads the
        reference package's journals too (the same format).
        """
        from repro_torch.serve import journal as journal_mod

        records, dropped = journal_mod.Journal.read(journal_path)
        injector = getattr(workload, "injector", None)
        jr = journal_mod.Journal(journal_path, fsync_every=fsync_every,
                                 injector=injector)
        eng = cls(workload, queue_cap=queue_cap, on_full=on_full,
                  journal=jr, policy=policy)
        retired = {int(r["rid"]) for r in records
                   if r.get("kind") == "retire"}
        max_rid, replayed = -1, []
        for rec in records:
            if rec.get("kind") == "retire":
                max_rid = max(max_rid, int(rec["rid"]))
                continue
            rid = int(rec["rid"])
            max_rid = max(max_rid, rid)
            if rid in retired:
                continue
            payload = journal_mod.decode_payload(rec["payload"])
            if journal_mod.payload_digest(payload) != rec["digest"]:
                raise journal_mod.JournalError(
                    f"admit record for rid {rid} fails its payload digest")
            req = workload.make_request(rid, payload,
                                        **(rec.get("opts") or {}))
            if rec.get("deadline_s") is not None:
                req.deadline = time.monotonic() + float(rec["deadline_s"])
            dv = rec.get("dict_version")
            if dv is not None and hasattr(req, "pin_version"):
                req.pin_version = int(dv)
            eng.queue.append(req)
            replayed.append(rid)
        eng._next_rid = max_rid + 1
        eng.recovery = journal_mod.RecoveryReport(
            replayed=replayed, already_retired=len(retired),
            dropped_bytes=dropped)
        eng.events_log.emit("recovered", replayed=len(replayed),
                            already_retired=len(retired),
                            dropped_bytes=dropped)
        return eng


@dataclass
class StemRequest:
    """A word-batch request and its (incrementally filled) response.

    dict_versions[i] is the DictStore version whose launch served word i:
    across a mid-stream publish() one request may span two versions.
    ``dispatched`` runs ahead of ``served`` while tiles are in flight.
    ``pin_version`` (set by ``Engine.recover``) serves the request under
    the version it was admitted under.
    """

    rid: int
    words: np.ndarray          # int32 [n, 16] encoded words
    roots: np.ndarray          # int32 [n, 4] zero-padded char codes
    sources: np.ndarray        # int32 [n] pyref.SRC_* tags
    dict_versions: np.ndarray  # int32 [n] DictStore version per word
    dispatched: int = 0        # words claimed by a launch
    served: int = 0            # words completed (results scattered back)
    done: bool = False
    deadline: float | None = None       # absolute time.monotonic() bound
    failure: FailureInfo | None = None  # set iff terminally failed
    pin_version: int | None = None      # dict version to serve under

    @property
    def n_words(self) -> int:
        return int(self.words.shape[0])

    @property
    def dict_version(self) -> int | None:
        """Version that served the last word (None for empty requests)."""
        return int(self.dict_versions[-1]) if self.dict_versions.size else None


@dataclass
class InflightTile:
    """One dispatched megabatch awaiting retire.

    ``roots``, ``sources`` and ``checksums`` are the slot's host output
    buffers (pinned on CUDA), filled by asynchronous device-to-host
    copies; ``event`` is recorded after those copies (None on the CPU,
    where the launch is synchronous). The host reads them only once the
    event has completed. ``flags`` (persistent launches) is the slot's
    host-mapped flag memory, which the kernel writes directly. ``version``
    pins the DictStore version acquired at dispatch.
    """

    segments: list             # [(req, req_start, tile_start, count)]
    version: int               # DictStore version pinned at dispatch
    slot: int                  # staging/output ring slot held until retire
    roots: torch.Tensor        # host int32 [rows, 4]
    sources: torch.Tensor      # host int32 [rows]
    checksums: torch.Tensor | None  # host int32 [rows // block_b]
    flags: torch.Tensor | None = None  # host int32 [rows // block_b]
    event: object = None       # torch.cuda.Event | None
    retries: int = 0           # retry generation of this dispatch
    t_dispatch: float = 0.0    # launch_timeout_s / watchdog_s accounting
    stalled: object = None     # injected wedge spec: never reads as ready
    via_megabatch: bool = False  # watchdog re-dispatch: not persistent
    seq: int = -1              # the launch's number (ticks_launched before)

    def is_ready(self) -> bool:
        """True once the host buffers can be read without blocking."""
        return self.event is None or self.event.query()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


@dataclass
class RetryGroup:
    """A claimed segment set awaiting (re-)dispatch.

    Segments are ``(req, req_start, count)``; tile offsets are assigned
    at dispatch, since a retried group repacks from the front of a fresh
    staging slot. ``retries`` counts failed dispatch attempts;
    ``not_before`` implements the retry backoff.
    """

    segments: list             # [(req, req_start, count)]
    retries: int = 0
    not_before: float = 0.0
    via_megabatch: bool = False  # force the megabatch path even when the
    # workload is persistent: the watchdog's re-dispatch route (a wedged
    # descriptor ring is not launched into again)


class StemmerWorkload:
    """Continuous batching of word-batch requests into megakernel launches,
    dispatch/retire-pipelined so host coalescing overlaps device compute.

    ``max_inflight=1`` degenerates to the synchronous dispatch-then-retire
    tick; ``megabatch_tiles=1`` makes each launch one ``block_b`` tile. A
    partially filled megabatch launches at the next power-of-two tile
    count (capped at ``megabatch_tiles``). Runs on the store's device.
    ``infix``, ``match``, ``dict_block_r``, ``num_buffers`` and
    ``skip_index`` are passed to every launch (the last three concern the
    streamed layout, which the store's residency selects).
    ``persistent=True`` launches the descriptor-ring kernel instead, and
    retire checks its completion flags against the version pinned at
    dispatch before it scatters. ``max_requests`` bounds the admitted
    requests.

    Fault tolerance, as the reference's: ``checksum=True`` (the default)
    computes a per-tile checksum on the device at dispatch and re-derives
    it from the host copies at retire; a mismatch discards the launch. A
    launch that raises, times out (``launch_timeout_s``) or fails its
    checksum is retried up to ``max_retries`` times (with exponential
    ``retry_backoff_s``), then bisected until single-request groups that
    still fail are quarantined with ``FailureInfo(code="quarantined")``.
    ``max_retries=0`` is strict: the first failure unwinds the claims and
    propagates. ``watchdog_s`` (persistent only) abandons a launch older
    than that. ``injector`` takes a
    :class:`~repro_torch.serve.faults.FaultInjector` (None: no fault
    layer on the hot path).

    ``data_devices=N > 1`` shards every launch over a ``("data",)`` mesh:
    ``super_b = N * block_b`` rows a super-tile, ``launch_b = super_b *
    megabatch_tiles`` rows a launch, each mesh entry running one
    contiguous shard (``ops.extract_roots_sharded``). The mesh is
    ``launch.mesh.make_data_mesh(N)`` on the store's device type (N GPUs,
    or N CPU entries), or the first N entries of ``mesh`` when one is
    given (``Mesh.of(["cuda:0"] * 4)`` runs four shards on one card).
    The dictionary is copied once a device and a version. A sharded
    launch is where the ``device_loss`` fault site fires. ``persistent``
    is single-device (the descriptor ring is one kernel's), as in the
    reference.
    """

    def __init__(self, store, *, block_b: int = 256, infix: bool = True,
                 match: str = "bsearch", dict_block_r: int = 8,
                 num_buffers: int = 2, skip_index: bool = True,
                 max_inflight: int = 2, data_devices: int = 1,
                 megabatch_tiles: int = 1, persistent: bool = False,
                 max_requests: int | None = None,
                 max_retries: int = 2, retry_backoff_s: float = 0.0,
                 launch_timeout_s: float | None = None,
                 watchdog_s: float | None = None,
                 checksum: bool = True, injector=None, mesh=None):
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        if data_devices < 1:
            raise ValueError(f"data_devices must be >= 1, got {data_devices}")
        if megabatch_tiles < 1:
            raise ValueError(
                f"megabatch_tiles must be >= 1, got {megabatch_tiles}")
        if persistent and data_devices > 1:
            raise ValueError(
                "persistent=True is single-device (the descriptor ring is"
                " one kernel's); use megabatch_tiles for multi-device"
                " coalescing")
        if mesh is not None:
            devs = axis_devices(mesh, "data")
            if len(devs) < data_devices:
                raise ValueError(f"the mesh has {len(devs)} data entries,"
                                 f" fewer than data_devices={data_devices}")
            kinds = {d.type for d in devs}
            if kinds != {store.device.type}:
                raise ValueError(f"mesh entries on {sorted(kinds)}, the"
                                 f" store on {store.device}")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        if retry_backoff_s < 0:
            raise ValueError(
                f"retry_backoff_s must be >= 0, got {retry_backoff_s}")
        if launch_timeout_s is not None and launch_timeout_s <= 0:
            raise ValueError(
                f"launch_timeout_s must be > 0, got {launch_timeout_s}")
        if watchdog_s is not None and watchdog_s <= 0:
            raise ValueError(f"watchdog_s must be > 0, got {watchdog_s}")
        if watchdog_s is not None and not persistent:
            raise ValueError(
                "watchdog_s guards the persistent descriptor ring"
                " (completion-flag stalls); non-persistent launches use"
                " launch_timeout_s")
        self.store = store
        self.device = store.device
        self.block_b = block_b
        self.infix = infix
        self.match = match
        self.dict_block_r = dict_block_r
        self.num_buffers = num_buffers
        self.skip_index = skip_index
        self.persistent = persistent
        self.max_inflight = max_inflight
        self.data_devices = data_devices
        self.megabatch_tiles = megabatch_tiles
        self.max_requests = max_requests
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.launch_timeout_s = launch_timeout_s
        self.watchdog_s = watchdog_s
        self.checksum = checksum
        self.injector = injector
        self.super_b = block_b * data_devices
        self.launch_b = self.super_b * megabatch_tiles
        self.inflight: list[StemRequest] = []
        self.ring: list[InflightTile] = []
        self._requeue: list[RetryGroup] = []
        self.ticks_launched = 0    # megakernel launches (not engine ticks)
        self.checksum_tiles = 0    # tiles whose checksum retire verified
        self.flag_tiles = 0        # tiles whose completion flag it verified
        # fault-path accounting, the reference's counters
        self.retries_total = 0     # failed dispatch attempts charged
        self.bisections = 0        # groups split after exhausting retries
        self.quarantined = 0       # requests isolated with FailureInfo
        self.timeouts = 0          # launches abandoned at launch_timeout_s
        self.checksum_failures = 0  # retires discarded on checksum mismatch
        self.watchdog_stalls = 0   # persistent launches abandoned as wedged
        self.device_losses = 0     # sharded launches failed with DeviceLost
        # the incident stream; the Engine adopts it
        self.events = EventLog()
        # degradation-ladder state: a requested ServingMode lands at the
        # next tick whose ring is empty; "streamed" overrides resident
        # handles (re-resolutions cached per version)
        self.residency_override: str | None = None
        self._pending_mode = None
        self._degraded: dict = {}
        # the data mesh (None on one device) and the dictionary's copies on
        # its entries, {(version, override): {device: handle}}
        self._base_mesh = mesh
        self._mesh = self._data_mesh(data_devices)
        self._replicas: dict = {}
        self._alloc_buffers()

    def _data_mesh(self, d: int):
        """The mesh a launch shards over at ``d`` data devices: None for
        one (the single-device path, as in the reference), else the given
        mesh's first d entries or ``make_data_mesh(d)`` on the store's
        device type, which raises for more GPUs than there are."""
        if d == 1:
            return None
        if self._base_mesh is not None:
            return self._base_mesh.first(d)
        from repro_torch.launch import mesh as mesh_mod

        return mesh_mod.make_data_mesh(d, device=self.device.type)

    def _alloc_buffers(self) -> None:
        """One reusable set of host buffers per ring slot, at the launch
        width: dispatch fills the staging rows in place instead of
        allocating per launch. A persistent slot's mapped flags are
        allocated at its first persistent launch on a card."""
        pin = self.device.type == "cuda"

        def host(*shape):
            return torch.zeros(shape, dtype=torch.int32, pin_memory=pin)

        self._staging = [host(self.launch_b, ab.MAXLEN)
                         for _ in range(self.max_inflight)]
        self._outputs = [(host(self.launch_b, 4), host(self.launch_b),
                          host(self.launch_b // self.block_b))
                         for _ in range(self.max_inflight)]
        self._flags = [None if pin else host(self.megabatch_tiles)
                       for _ in range(self.max_inflight)]
        self._free_slots = list(range(self.max_inflight))

    def _slot_flags(self, slot: int):
        """The slot's completion flags: host-mapped memory on a card
        (``stem_fused.MappedFlags``), a CPU tensor on the CPU."""
        if self._flags[slot] is None:
            from repro_torch.kernels import stem_fused as sf

            self._flags[slot] = sf.MappedFlags(self.megabatch_tiles,
                                               self.device)
        return self._flags[slot]

    # -- workload protocol -------------------------------------------------
    def make_request(self, rid: int, words, **opts) -> StemRequest:
        if opts:
            raise ValueError(f"unknown stemmer request options: {sorted(opts)}")
        if isinstance(words, np.ndarray):
            if words.ndim != 2 or words.shape[1] != ab.MAXLEN:
                raise ValueError(
                    f"encoded word batch must be [n, {ab.MAXLEN}], got"
                    f" {words.shape}")
            enc = words.astype(np.int32, copy=True)
        else:
            enc = ab.encode_batch(list(words))  # raw strings
        n = enc.shape[0]
        return StemRequest(rid, enc,
                           roots=np.zeros((n, 4), np.int32),
                           sources=np.zeros(n, np.int32),
                           dict_versions=np.zeros(n, np.int32))

    def has_capacity(self) -> bool:
        return (self.max_requests is None
                or len(self.inflight) < self.max_requests)

    def admit(self, req: StemRequest) -> None:
        self.inflight.append(req)

    @property
    def active(self) -> int:
        return len(self.inflight)

    def pending_rids(self) -> list[int]:
        return [r.rid for r in self.inflight]

    def tick(self) -> list[StemRequest]:
        self._apply_pending_mode()
        retired = self._retire_ready()
        dispatched = self._fill_ring()
        if not retired and not dispatched and self.ring:
            # a would-be-zero-progress tick must still make progress
            if self._has_undispatched():
                # saturated: wait for the oldest, then refill its slot
                self._retire_blocking(self.ring.pop(0))
                self._fill_ring()
            else:
                # draining: nothing left to launch — wait for the ring
                while self.ring:
                    self._retire_blocking(self.ring.pop(0))
        finished, still = [], []
        for req in self.inflight:
            if req.failure is not None:     # quarantined mid-flight
                req.done = True
                finished.append(req)
            elif req.served >= req.n_words:  # includes empty requests
                req.done = True
                finished.append(req)
            else:
                still.append(req)
        self.inflight = still
        return finished

    def expire(self, now: float) -> list[StemRequest]:
        """Fail + hand back in-flight requests past their deadline. Words
        of an expired request still riding a launch are dropped at retire;
        results up to ``served`` stay on the request."""
        out, still = [], []
        for req in self.inflight:
            if (req.failure is None and req.deadline is not None
                    and now > req.deadline):
                req.failure = FailureInfo(
                    req.rid, "deadline",
                    detail=f"{req.served}/{req.n_words} words served")
                req.done = True
                out.append(req)
            else:
                still.append(req)
        self.inflight = still
        return out

    def cancel_pending(self) -> list[StemRequest]:
        """Tear down the ring and the retry queue; fail every in-flight
        request with FailureInfo(code="cancelled") and return them."""
        for entry in self.ring:
            self._free_slots.append(entry.slot)
        self.ring = []
        self._requeue = []
        out = []
        for req in self.inflight:
            if req.failure is None:
                req.failure = FailureInfo(
                    req.rid, "cancelled",
                    detail=f"{req.served}/{req.n_words} words served")
            req.done = True
            out.append(req)
        self.inflight = []
        return out

    # -- degradation ladder (serve/health.py) ------------------------------
    def request_mode(self, mode) -> None:
        """Ask for a ladder transition: applied at the next tick whose
        ring is empty (in-flight launches keep the geometry they
        dispatched with)."""
        self._pending_mode = mode

    def _apply_pending_mode(self) -> None:
        m = self._pending_mode
        if m is None or self.ring:
            return
        self._pending_mode = None
        geom_changed = (m.data_devices != self.data_devices
                        or m.megabatch_tiles != self.megabatch_tiles)
        self.persistent = m.persistent
        self.megabatch_tiles = m.megabatch_tiles
        self.residency_override = m.residency
        if m.data_devices != self.data_devices:
            # reshard onto the mesh's first d entries (an empty ring: no
            # launch holds the old geometry)
            self._mesh = self._data_mesh(m.data_devices)
            self.data_devices = m.data_devices
        if geom_changed:
            self.super_b = self.block_b * self.data_devices
            self.launch_b = self.super_b * self.megabatch_tiles
            self._alloc_buffers()
            self._split_requeue(self.launch_b)

    def _split_requeue(self, cap: int) -> None:
        """Re-chunk waiting retry groups so none exceeds the (possibly
        shrunken) launch width after a ladder transition."""
        out = []
        for grp in self._requeue:
            cur, fill = [], 0
            for req, r0, take in grp.segments:
                while take > 0:
                    t = min(take, cap - fill)
                    if t == 0:
                        out.append(RetryGroup(cur, retries=grp.retries,
                                              not_before=grp.not_before,
                                              via_megabatch=grp.via_megabatch))
                        cur, fill = [], 0
                        continue
                    cur.append((req, r0, t))
                    fill += t
                    r0 += t
                    take -= t
            if cur:
                out.append(RetryGroup(cur, retries=grp.retries,
                                      not_before=grp.not_before,
                                      via_megabatch=grp.via_megabatch))
        self._requeue = out

    def _degraded_handle(self, dv):
        """This version's tables re-resolved at the ladder's residency
        override (resident -> streamed), cached per (version, override)
        so repeated launches reuse one handle and its tile set."""
        key = (dv.version, self.residency_override)
        h = self._degraded.get(key)
        if h is None:
            from repro_torch.core import stemmer as core_stemmer

            h = core_stemmer.resolve_dict(
                dv.arrays, residency=self.residency_override,
                infix=self.infix, dict_block_r=self.dict_block_r)
            self._degraded[key] = h
        return h

    # -- dispatch side -----------------------------------------------------
    def _has_undispatched(self) -> bool:
        return bool(self._requeue) or any(
            req.n_words > req.dispatched for req in self.inflight
            if req.failure is None)

    def _coalesce(self) -> list[tuple[StemRequest, int, int]]:
        """FIFO-claim one megabatch (up to ``megabatch_tiles`` tiles) of
        undispatched words: -> [(req, req_start, count)].

        Claiming advances ``req.dispatched`` at once: a failed launch
        keeps its words through its RetryGroup. A launch acquires ONE
        dict version, so requests with different ``pin_version``s never
        share a group: coalescing stops at the first pin mismatch.
        """
        segments, fill, pin = [], 0, None
        for req in self.inflight:
            if req.failure is not None:
                continue
            if fill >= self.launch_b:
                break
            take = min(req.n_words - req.dispatched, self.launch_b - fill)
            if take > 0:
                if not segments:
                    pin = req.pin_version
                elif req.pin_version != pin:
                    break
                segments.append((req, req.dispatched, take))
                req.dispatched += take
                fill += take
        return segments

    def _bucket_rows(self, fill: int) -> int:
        """Rows to launch for ``fill`` coalesced words: the next
        power-of-two super-tile count, capped at megabatch_tiles."""
        n_super = -(-fill // self.super_b)
        bucket = 1
        while bucket < n_super:
            bucket *= 2
        return min(bucket, self.megabatch_tiles) * self.super_b

    def _replicas_for(self, version: int) -> dict:
        """The dictionary's copies on the mesh's entries for this version
        (at the ladder's residency override): filled at most once a device
        by the launches, and dropped once no launch can pin the version."""
        key = (version, self.residency_override)
        got = self._replicas.get(key)
        if got is None:
            live = {e.version for e in self.ring} | {version}
            self._replicas = {k: v for k, v in self._replicas.items()
                              if k[0] in live}
            got = self._replicas[key] = {}
        return got

    def _next_group(self) -> RetryGroup | None:
        """The next dispatchable group: an eligible retry first (FIFO),
        else a freshly coalesced one. Drops segments of requests that
        failed while their group waited."""
        now = time.monotonic()
        found, keep = None, []
        for grp in self._requeue:
            grp.segments = [(req, r0, take) for req, r0, take in grp.segments
                            if req.failure is None]
            if not grp.segments:
                continue                # everything in it already failed
            if found is None and grp.not_before <= now:
                found = grp
            else:
                keep.append(grp)
        self._requeue = keep
        if found is not None:
            return found
        segments = self._coalesce()
        return RetryGroup(segments) if segments else None

    def _dispatchable(self) -> bool:
        """Whether ``_next_group`` will find a group: an eligible retry or
        an undispatched word. Asked only while tracing is on, so that the
        many polls that find nothing open no span."""
        now = time.monotonic()
        for grp in self._requeue:
            if grp.not_before <= now and any(req.failure is None
                                             for req, _, _ in grp.segments):
                return True
        return any(req.failure is None and req.dispatched < req.n_words
                   for req in self.inflight)

    def _fill_ring(self) -> int:
        """Dispatch until max_inflight launches are outstanding or nothing
        is dispatchable; returns the number of launches."""
        n = 0
        waited = False
        while len(self.ring) < self.max_inflight:
            if tracing.on() and not self._dispatchable():
                grp = self._next_group()    # a poll: no span
            else:
                with tracing.span("ring.coalesce", self.ticks_launched):
                    grp = self._next_group()
            if grp is None:
                if self._requeue and not self.ring and not waited:
                    # every retryable group is backing off and nothing
                    # else is in flight: wait out the soonest backoff,
                    # once a tick
                    wait = (min(g.not_before for g in self._requeue)
                            - time.monotonic())
                    if wait > 0:
                        time.sleep(wait)
                    waited = True
                    continue
                break
            with tracing.span("ring.dispatch", self.ticks_launched):
                n += self._dispatch_group(grp)
        return n

    def _launch_failed(self, grp: RetryGroup, exc: BaseException) -> int:
        """The failure path of dispatch errors, timeouts and retire
        checksum mismatches: retry with backoff, bisect after
        ``max_retries``, quarantine single-request leaves."""
        if self.max_retries == 0:
            # strict mode: unwind the claims so every word is coalesced
            # again from scratch, and propagate to the caller
            for req, _r0, take in grp.segments:
                req.dispatched -= take
            raise exc
        grp.retries += 1
        self.retries_total += 1
        self.events.emit("retry", attempt=grp.retries,
                         rids=[req.rid for req, _r0, _t in grp.segments],
                         detail=str(exc))
        if grp.retries > self.max_retries:
            if len(grp.segments) > 1:
                # split the failing group so a poison request is isolated
                # in O(log segments) rounds while the healthy halves serve
                mid = len(grp.segments) // 2
                self.bisections += 1
                self.events.emit("bisect", segments=len(grp.segments))
                self._requeue.append(RetryGroup(
                    grp.segments[:mid], via_megabatch=grp.via_megabatch))
                self._requeue.append(RetryGroup(
                    grp.segments[mid:], via_megabatch=grp.via_megabatch))
            else:
                (req, _r0, _take), = grp.segments
                req.failure = FailureInfo(
                    req.rid, "quarantined", retries=grp.retries,
                    detail=str(exc))
                self.quarantined += 1
        else:
            backoff = self.retry_backoff_s * (2 ** (grp.retries - 1))
            grp.not_before = time.monotonic() + backoff
            self._requeue.append(grp)
        return 0

    def _dispatch_group(self, grp: RetryGroup) -> int:
        """Launch one group; returns 1 on success, 0 when the failure was
        absorbed into the retry machinery."""
        if self.injector is not None:
            try:
                self.injector.on_dispatch(
                    rids=[req.rid for req, _r0, _take in grp.segments])
                if self._mesh is not None:
                    self.injector.on_device_loss()
            except Exception as e:
                if isinstance(e, DeviceLost):
                    self.device_losses += 1
                    self.events.emit("device_loss",
                                     data_devices=self.data_devices,
                                     detail=str(e))
                return self._launch_failed(grp, e)
        # one version a launch: recovered requests pin the version they
        # were admitted under, the rest serve the current one
        pin = grp.segments[0][0].pin_version
        if pin is None:
            dv = self.store.acquire()
        else:
            try:
                dv = self.store.get(pin)
            except KeyError as e:
                # the pinned lexicon is gone (snapshot not restored,
                # history dropped): fail into the retry machinery rather
                # than serve another version
                return self._launch_failed(grp, e)
        handle = dv.handle
        if (self.residency_override is not None
                and handle.residency != self.residency_override):
            handle = self._degraded_handle(dv)
        use_persistent = self.persistent and not grp.via_megabatch
        seq = self.ticks_launched
        slot = self._free_slots.pop()
        staging = self._staging[slot]
        tile = staging.numpy()
        placed, fill = [], 0
        with tracing.span("ring.stage", seq):
            for req, r0, take in grp.segments:
                tile[fill:fill + take] = req.words[r0:r0 + take]
                placed.append((req, r0, fill, take))
                fill += take
            rows = self._bucket_rows(fill)
            tile[fill:rows] = 0         # padded words must stay empty
        tiles = rows // self.block_b
        roots_h, sources_h, sums_h = self._outputs[slot]
        on_cuda = self.device.type == "cuda"
        kw = dict(infix=self.infix, match=self.match, block_b=self.block_b,
                  dict_block_r=self.dict_block_r,
                  num_buffers=self.num_buffers, skip_index=self.skip_index,
                  with_checksum=self.checksum)
        flags = event = None
        home = (self.device if self._mesh is None
                else axis_devices(self._mesh, "data")[0])
        with tracing.span("ring.launch", seq):
            try:
                if self._mesh is not None:
                    # each entry's shard goes straight from the pinned staging
                    # rows to its device; the merged rows land on the first
                    out = ops.extract_roots_sharded(
                        staging[:rows], handle, self._mesh,
                        replicas=self._replicas_for(dv.version), **kw)
                else:
                    words = staging[:rows].to(self.device, non_blocking=True)
                    kw["device"] = self.device
                    if use_persistent:
                        out = ops.extract_roots_persistent(
                            words, handle, version_slot=dv.version,
                            flags_out=self._slot_flags(slot)[:tiles], **kw)
                        flags = out[2]
                    else:
                        out = ops.extract_roots_fused(words, handle, **kw)
                copies = [(roots_h[:rows], out[0]), (sources_h[:rows], out[1])]
                if self.checksum:
                    copies.append((sums_h[:tiles], out[-1]))
                with on_device(home):
                    for dst, src in copies:
                        dst.copy_(src, non_blocking=on_cuda)
                    if on_cuda:
                        event = torch.cuda.Event()
                        event.record()
            except BaseException as e:
                # a failed launch must not wedge the engine: return the slot
                # and route the group through the retry machinery (strict
                # mode re-raises with the words unclaimed)
                self._free_slots.append(slot)
                if isinstance(e, (KeyboardInterrupt, SystemExit)):
                    raise
                return self._launch_failed(grp, e)
        entry = InflightTile(
            placed, dv.version, slot, roots_h[:rows], sources_h[:rows],
            sums_h[:tiles] if self.checksum else None, flags, event,
            retries=grp.retries, t_dispatch=time.monotonic(),
            via_megabatch=grp.via_megabatch, seq=seq)
        if flags is not None and self.injector is not None:
            # a wedge shows only in the completion flags, so the stall
            # site covers persistent launches alone
            entry.stalled = self.injector.on_stall()
        self.ring.append(entry)
        self.ticks_launched += 1
        return 1

    # -- retire side -------------------------------------------------------
    def _retire_ready(self) -> int:
        """Retire every launch whose results are on the host (and abandon
        any past ``watchdog_s`` / ``launch_timeout_s``), oldest first,
        without blocking; returns the number processed."""
        still, n = [], 0
        now = time.monotonic()
        for entry in self.ring:
            stalled = entry.stalled is not None
            if not stalled and entry.is_ready():
                with tracing.span("ring.retire", entry.seq):
                    self._retire(entry)
                n += 1
            elif (self.watchdog_s is not None and entry.flags is not None
                  and now - entry.t_dispatch > self.watchdog_s):
                # persistent launch wedged: salvage the retired prefix,
                # re-dispatch the rest down the megabatch path
                self._watchdog_abandon(entry)
                n += 1
            elif (not stalled and self.launch_timeout_s is not None
                  and now - entry.t_dispatch > self.launch_timeout_s):
                # abandon the launch: free the slot and re-dispatch its
                # words through the retry path
                self.timeouts += 1
                self._free_slots.append(entry.slot)
                grp = RetryGroup([(req, r0, take) for req, r0, _t0, take
                                  in entry.segments], retries=entry.retries,
                                 via_megabatch=entry.via_megabatch)
                self._launch_failed(grp, TimeoutError(
                    f"launch exceeded launch_timeout_s="
                    f"{self.launch_timeout_s}"))
                n += 1
            else:
                still.append(entry)
        self.ring = still
        return n

    def _retire_blocking(self, entry: InflightTile) -> None:
        """Blocking drain of one launch. A launch marked wedged (an
        injected stall) is not waited on, as a real wedge never
        completes: the watchdog window is waited out and it is
        abandoned."""
        if entry.stalled is not None and self.watchdog_s is not None:
            wait = self.watchdog_s - (time.monotonic() - entry.t_dispatch)
            if wait > 0:
                time.sleep(wait)
            self._watchdog_abandon(entry)
        else:
            with tracing.span("ring.retire", entry.seq):
                self._retire(entry)

    def _watchdog_abandon(self, entry: InflightTile) -> None:
        """Abandon a wedged persistent launch.

        Salvage the prefix of descriptors whose completion flags read
        done (checksum-verified a tile), scatter its words, and re-dispatch
        the rest as a ``via_megabatch`` RetryGroup, never back into the
        descriptor ring. No retry is charged: the stall is the launch's
        fault, not the group's, so no request is lost even at
        ``max_retries=0``. An injected wedge's launch completes, so its
        flags are read from the slot's mapped memory after it; a real
        wedge never completes and blocks the stream behind it, so nothing
        is salvaged from it and every word re-dispatches.
        """
        from repro_torch.kernels import stem_fused as sf

        self.watchdog_stalls += 1
        rows_ok = 0
        spec = entry.stalled
        if spec is not None:
            # the flag state a wedge after spec.retired_tiles descriptors
            # leaves: those done, the rest untouched
            entry.wait()
            flags = entry.flags.numpy().copy()
            flags[min(spec.retired_tiles, flags.size):] = 0
            rows_ok = sf.salvage_descriptor_rows(flags, entry.version,
                                                 self.block_b)
        roots = sources = None
        if rows_ok > 0:
            roots = entry.roots.numpy()[:rows_ok]
            sources = entry.sources.numpy()[:rows_ok]
            if entry.checksums is not None:
                want = entry.checksums.numpy()[:rows_ok // self.block_b]
                got = ops.tile_checksum_host(roots, sources,
                                             block_b=self.block_b)
                bad = np.flatnonzero(got != want)
                if bad.size:       # trust only the clean flag+sum prefix
                    rows_ok = int(bad[0]) * self.block_b
        salvaged = redispatched = 0
        redo = []
        for req, r0, t0, take in entry.segments:
            if req.failure is not None:   # expired/cancelled mid-flight
                continue
            good = max(0, min(take, rows_ok - t0))
            if good > 0:
                req.roots[r0:r0 + good] = roots[t0:t0 + good]
                req.sources[r0:r0 + good] = sources[t0:t0 + good]
                req.dict_versions[r0:r0 + good] = entry.version
                req.served += good
                salvaged += good
            if take > good:
                redo.append((req, r0 + good, take - good))
                redispatched += take - good
        self._free_slots.append(entry.slot)
        if redo:
            self._requeue.append(RetryGroup(redo, retries=entry.retries,
                                            via_megabatch=True))
        self.events.emit("watchdog_stall", injected=spec is not None,
                         salvaged_words=salvaged,
                         redispatched_words=redispatched,
                         version=entry.version)

    def _retire(self, entry: InflightTile) -> bool:
        """Verify one launch's completion flags and checksums and scatter
        its results back (blocks until its copies have landed).

        Returns False when the launch failed its checksum and its words
        were queued for re-dispatch instead. Bad completion flags raise.
        """
        with tracing.span("ring.wait", entry.seq):
            entry.wait()
        self._free_slots.append(entry.slot)
        roots = entry.roots.numpy()
        sources = entry.sources.numpy()
        if self.injector is not None:
            roots, sources = self.injector.on_retire(roots, sources)
        if entry.flags is not None:
            # every descriptor of the persistent launch must have retired
            # under the version pinned at dispatch (0 = never processed);
            # read from the mapped memory the kernel wrote
            flags = entry.flags.numpy()
            if not (flags == 1 + entry.version).all():
                raise RuntimeError(
                    "persistent launch retired with bad completion flags:"
                    f" expected {1 + entry.version}, got {flags.tolist()}")
            self.flag_tiles += flags.shape[0]
        if entry.checksums is not None:
            want = entry.checksums.numpy()
            with tracing.span("ring.checksum", entry.seq):
                got = ops.tile_checksum_host(roots, sources,
                                             block_b=self.block_b)
            if not np.array_equal(got, want):
                bad = np.nonzero(got != want)[0].tolist()
                err = RuntimeError(
                    f"retire checksum mismatch on tile(s) {bad} of"
                    f" {want.shape[0]} (device vs host copy) — discarding"
                    " the launch")
                if self.max_retries == 0:
                    raise err
                self.checksum_failures += 1
                self.events.emit("checksum_failure", tiles=bad,
                                 rids=[req.rid for req, *_ in entry.segments])
                grp = RetryGroup([(req, r0, take) for req, r0, _t0, take
                                  in entry.segments], retries=entry.retries,
                                 via_megabatch=entry.via_megabatch)
                self._launch_failed(grp, err)
                return False
            self.checksum_tiles += want.shape[0]
        with tracing.span("ring.scatter", entry.seq):
            for req, r0, t0, take in entry.segments:
                if req.failure is not None:   # expired/cancelled mid-flight
                    continue
                req.roots[r0:r0 + take] = roots[t0:t0 + take]
                req.sources[r0:r0 + take] = sources[t0:t0 + take]
                req.dict_versions[r0:r0 + take] = entry.version
                req.served += take
        return True


# ---------------------------------------------------------------------------
# LM decode workload
# ---------------------------------------------------------------------------
@dataclass
class Request:
    rid: int
    prompt: np.ndarray          # int32 [T] (the audio family's too)
    max_new: int = 16
    tokens_out: list = field(default_factory=list)
    done: bool = False
    deadline: float | None = None       # absolute time.monotonic() bound
    failure: FailureInfo | None = None  # set iff terminally failed


class LMDecodeWorkload:
    """Slot-per-request greedy decode over ``models.model.decode_step``.

    Requests enter a fixed pool of B slots. A request's prompt runs
    through decode steps into its slot's rows of the batched cache
    (prefill-by-decode); every tick decodes one token for each live slot;
    a finished slot frees at once for the next queued request. Each step
    runs the whole batch at the slot's position and keeps only the slot's
    rows of the new cache, as the reference does. Runs on ``device``.
    """

    def __init__(self, cfg, params, *, max_batch: int = 4,
                 cache_len: int = 128, device=devmod.DEFAULT_DEVICE):
        self.cfg = cfg
        self.device = devmod.resolve(device)
        self.params = pm.tree_map(lambda x: x.to(self.device), params)
        self.B = max_batch
        self.cache_len = cache_len
        self.caches = model_mod.init_caches(cfg, max_batch, cache_len,
                                            device=self.device)
        self.slot_req: list[Request | None] = [None] * max_batch
        self.slot_pos = np.zeros(max_batch, np.int32)   # next position

        self._decode = (lambda p, tok, caches, pos: model_mod.decode_step(
            p, cfg, tok, caches, pos))

    # -- workload protocol -------------------------------------------------
    def make_request(self, rid: int, prompt, *, max_new: int = 16) -> Request:
        if max_new < 1:
            # prefill always emits the first generated token, so the engine
            # cannot return fewer than one token per request
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1:
            # the reference documents [T, K] audio prompts but fails on
            # them when it admits one (int() of a K-vector)
            raise ValueError(
                f"a prompt is 1-D token ids [T], got shape {prompt.shape};"
                " the audio family takes one id a position, written into"
                " every codebook, as in the reference (whose [T, K] prompts"
                " fail at admission)")
        return Request(rid, prompt, max_new)

    def has_capacity(self) -> bool:
        return any(r is None for r in self.slot_req)

    def admit(self, req: Request):
        self._prefill_into_slot(self.slot_req.index(None), req)

    @property
    def active(self) -> int:
        return sum(r is not None for r in self.slot_req)

    def pending_rids(self) -> list[int]:
        return [r.rid for r in self.slot_req if r is not None]

    def tick(self) -> list[Request]:
        """Decode one token for every live slot.

        Doneness is checked BEFORE decoding: a request admitted this tick
        already holds its prefill-emitted token, so with max_new=1 it frees
        its slot without an extra decode.
        """
        finished = []
        for slot in range(self.B):
            req = self.slot_req[slot]
            if req is None:
                continue
            if len(req.tokens_out) >= req.max_new:
                finished.append(self._finish_slot(slot, req))
                continue
            self._step_slot(slot, req.tokens_out[-1], emit=True)
            if len(req.tokens_out) >= req.max_new:
                finished.append(self._finish_slot(slot, req))
        return finished

    def expire(self, now: float) -> list[Request]:
        """Free + fail slots whose request deadline passed; partial
        tokens stay on the request for the caller to inspect."""
        out = []
        for slot in range(self.B):
            req = self.slot_req[slot]
            if (req is not None and req.deadline is not None
                    and now > req.deadline):
                req.failure = FailureInfo(
                    req.rid, "deadline",
                    detail=f"{len(req.tokens_out)}/{req.max_new} tokens"
                           " decoded")
                out.append(self._finish_slot(slot, req))
        return out

    def cancel_pending(self) -> list[Request]:
        out = []
        for slot in range(self.B):
            req = self.slot_req[slot]
            if req is not None:
                req.failure = FailureInfo(
                    req.rid, "cancelled",
                    detail="slot torn down with the request decoding")
                out.append(self._finish_slot(slot, req))
        return out

    # -- decode machinery --------------------------------------------------
    def _prefill_into_slot(self, slot: int, req: Request):
        """Prompt tokens run through decode steps into this slot's cache;
        the last prompt token emits the first generated token."""
        self.slot_req[slot] = req
        self.slot_pos[slot] = 0
        for tok in req.prompt[:-1]:
            self._step_slot(slot, int(tok), emit=False)
        self._step_slot(slot, int(req.prompt[-1]), emit=True)

    def _step_slot(self, slot: int, token: int, emit: bool):
        """Decode ``token`` at the slot's position (the audio family's
        tokens [B, 1, K], the id in every codebook) and, with ``emit``,
        append the greedy next id (codebook 0's for the audio family)."""
        cfg = self.cfg
        shape = (self.B, 1, cfg.n_codebooks) if cfg.n_codebooks else (self.B, 1)
        toks = torch.zeros(shape, dtype=torch.int32, device=self.device)
        toks[slot] = token
        logits, new_caches = self._decode(self.params, toks, self.caches,
                                          int(self.slot_pos[slot]))
        # keep only this slot's cache rows (positions differ per slot)
        _merge_slot(self.caches, new_caches, slot)
        self.slot_pos[slot] += 1
        if emit:
            nxt = int(torch.argmax(logits[slot, -1], dim=-1).reshape(-1)[0])
            self.slot_req[slot].tokens_out.append(nxt)

    def _finish_slot(self, slot: int, req: Request) -> Request:
        req.done = True
        self.slot_req[slot] = None
        return req


class ServeEngine(Engine):
    """The LM-serving entry point: Engine + LMDecodeWorkload."""

    def __init__(self, cfg, params, *, max_batch: int = 4,
                 cache_len: int = 128, device=devmod.DEFAULT_DEVICE):
        super().__init__(LMDecodeWorkload(cfg, params, max_batch=max_batch,
                                          cache_len=cache_len, device=device))


def _merge_slot(old, new, slot: int) -> None:
    """Copy slot ``slot``'s rows from ``new`` into ``old``, in place: the
    reference builds a new tree with ``.at[:, slot].set``; the values are
    the same. The batch is axis 1 of every [L, B, ...] leaf, and axis 2
    of the VLM's grouped self-caches ``"self"`` [G, g, B, ...], which the
    port tells by their key (the reference by a leaf's axis 1 differing
    from the batch, which misses when g equals it)."""
    for key in old:
        if key == "self":
            pm.tree_map(lambda o, n: o[:, :, slot].copy_(n[:, :, slot]),
                        old[key], new[key])
        else:
            pm.tree_map(lambda o, n: o[:, slot].copy_(n[:, slot]),
                        old[key], new[key])

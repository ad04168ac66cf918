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
            when the host may read them;
  drain     only a tick that would otherwise make no progress blocks:
            saturated, it waits for the oldest launch; draining, it
            waits for all of them.

A slot's buffers are reused only after its launch retires. Each launch
pins the DictStore version it acquired at dispatch, so a hot swap landing
between dispatch and retire stays exact per word. On the CPU the launch
runs synchronously and a tile is ready as soon as it is dispatched.

:class:`LMDecodeWorkload` runs greedy decode of the dense-attention LMs,
one slot per request (its ``expire`` and ``cancel_pending`` are there for
a caller; the port's Engine calls neither yet).

Not ported yet (ROADMAP §1): deadlines, admission caps, retries,
bisection and quarantine (a checksum or flag mismatch raises), the
journal, the watchdog and salvage-on-stall, the health ladder and
multi-device launches.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.core import alphabet as ab
from repro_torch.kernels import ops
from repro_torch.models import model as model_mod
from repro_torch.models import params as pm


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


@dataclass
class DrainReport:
    """Outcome of run_until_drained: ticks spent and what is still owed."""

    ticks: int
    drained: bool
    pending: list[int]   # rids still queued or in flight at max_ticks


class EngineUndrained(RuntimeError):
    """max_ticks elapsed with requests still queued or in flight."""

    def __init__(self, report: DrainReport):
        self.report = report
        super().__init__(
            f"engine not drained after {report.ticks} ticks:"
            f" {len(report.pending)} request(s) unfinished"
            f" (rids {report.pending})")


class Engine:
    """Continuous batching over any Workload.

    submit() validates through the workload and queues; step() admits
    while the workload has capacity, then runs one workload tick;
    finished requests move to the results table keyed by rid.
    """

    def __init__(self, workload: Workload):
        self.workload = workload
        self.queue: list = []
        self.finished: dict[int, object] = {}
        self._next_rid = 0

    def submit(self, payload, **opts) -> int:
        req = self.workload.make_request(self._next_rid, payload, **opts)
        self._next_rid += 1
        self.queue.append(req)
        return req.rid

    def result(self, rid: int):
        return self.finished.get(rid)

    @property
    def active(self) -> int:
        return self.workload.active

    def step(self) -> None:
        """One engine tick: admit while there is capacity, then tick."""
        while self.queue and self.workload.has_capacity():
            self.workload.admit(self.queue.pop(0))
        for req in self.workload.tick():
            self.finished[req.rid] = req

    def run_until_drained(self, max_ticks: int = 1000) -> DrainReport:
        """Tick until queue + in-flight are empty; raise EngineUndrained
        (carrying the report) if max_ticks elapse first."""
        ticks = 0
        while (self.queue or self.workload.active) and ticks < max_ticks:
            self.step()
            ticks += 1
        pending = [r.rid for r in self.queue] + self.workload.pending_rids()
        report = DrainReport(ticks=ticks, drained=not pending,
                             pending=pending)
        if pending:
            raise EngineUndrained(report)
        return report


@dataclass
class StemRequest:
    """A word-batch request and its (incrementally filled) response.

    dict_versions[i] is the DictStore version whose launch served word i:
    across a mid-stream publish() one request may span two versions.
    ``dispatched`` runs ahead of ``served`` while tiles are in flight.
    """

    rid: int
    words: np.ndarray          # int32 [n, 16] encoded words
    roots: np.ndarray          # int32 [n, 4] zero-padded char codes
    sources: np.ndarray        # int32 [n] pyref.SRC_* tags
    dict_versions: np.ndarray  # int32 [n] DictStore version per word
    dispatched: int = 0        # words claimed by a launch
    served: int = 0            # words completed (results scattered back)
    done: bool = False

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

    ``roots``, ``sources``, ``checksums`` and, for a persistent launch,
    ``flags`` are the slot's host output buffers (pinned on CUDA), filled
    by asynchronous device-to-host copies; ``event`` is recorded after
    those copies (None on the CPU, where the launch is synchronous). The
    host reads the buffers only once the event has completed.
    """

    segments: list             # [(req, req_start, tile_start, count)]
    version: int               # DictStore version pinned at dispatch
    slot: int                  # staging/output ring slot held until retire
    roots: torch.Tensor        # host int32 [rows, 4]
    sources: torch.Tensor      # host int32 [rows]
    checksums: torch.Tensor    # host int32 [rows // block_b]
    flags: torch.Tensor | None = None  # host int32 [rows // block_b]
    event: object = None       # torch.cuda.Event | None

    def is_ready(self) -> bool:
        """True once the host buffers can be read without blocking."""
        return self.event is None or self.event.query()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


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
    dispatch before it scatters.
    """

    def __init__(self, store, *, block_b: int = 256, infix: bool = True,
                 match: str = "bsearch", dict_block_r: int = 8,
                 num_buffers: int = 2, skip_index: bool = True,
                 max_inflight: int = 2, megabatch_tiles: int = 1,
                 persistent: bool = False):
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        if megabatch_tiles < 1:
            raise ValueError(
                f"megabatch_tiles must be >= 1, got {megabatch_tiles}")
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
        self.megabatch_tiles = megabatch_tiles
        self.launch_b = block_b * megabatch_tiles
        self.inflight: list[StemRequest] = []
        self.ring: list[InflightTile] = []
        self.ticks_launched = 0    # megakernel launches (not engine ticks)
        self.checksum_tiles = 0    # tiles whose checksum retire verified
        self.flag_tiles = 0        # tiles whose completion flag it verified
        # one reusable set of host buffers per ring slot: dispatch fills
        # the staging rows in place instead of allocating per launch
        pin = self.device.type == "cuda"

        def host(*shape):
            return torch.zeros(shape, dtype=torch.int32, pin_memory=pin)

        self._staging = [host(self.launch_b, ab.MAXLEN)
                         for _ in range(max_inflight)]
        self._outputs = [(host(self.launch_b, 4), host(self.launch_b),
                          host(megabatch_tiles), host(megabatch_tiles))
                         for _ in range(max_inflight)]
        self._free_slots = list(range(max_inflight))

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
        return True                     # admission control is not ported

    def admit(self, req: StemRequest) -> None:
        self.inflight.append(req)

    @property
    def active(self) -> int:
        return len(self.inflight)

    def pending_rids(self) -> list[int]:
        return [r.rid for r in self.inflight]

    def tick(self) -> list[StemRequest]:
        retired = self._retire_ready()
        dispatched = self._fill_ring()
        if not retired and not dispatched and self.ring:
            # a would-be-zero-progress tick must still make progress
            if self._has_undispatched():
                # saturated: wait for the oldest, then refill its slot
                self._retire(self.ring.pop(0))
                self._fill_ring()
            else:
                # draining: nothing left to launch — wait for the ring
                while self.ring:
                    self._retire(self.ring.pop(0))
        finished, still = [], []
        for req in self.inflight:
            if req.served >= req.n_words:   # includes empty requests
                req.done = True
                finished.append(req)
            else:
                still.append(req)
        self.inflight = still
        return finished

    # -- dispatch side -----------------------------------------------------
    def _has_undispatched(self) -> bool:
        return any(req.n_words > req.dispatched for req in self.inflight)

    def _coalesce(self) -> list[tuple[StemRequest, int, int]]:
        """FIFO-claim one megabatch (up to ``megabatch_tiles`` tiles) of
        undispatched words: -> [(req, req_start, count)]."""
        segments, fill = [], 0
        for req in self.inflight:
            if fill >= self.launch_b:
                break
            take = min(req.n_words - req.dispatched, self.launch_b - fill)
            if take > 0:
                segments.append((req, req.dispatched, take))
                req.dispatched += take
                fill += take
        return segments

    def _bucket_rows(self, fill: int) -> int:
        """Rows to launch for ``fill`` coalesced words: the next
        power-of-two tile count, capped at megabatch_tiles."""
        n_tiles = -(-fill // self.block_b)
        bucket = 1
        while bucket < n_tiles:
            bucket *= 2
        return min(bucket, self.megabatch_tiles) * self.block_b

    def _fill_ring(self) -> int:
        """Dispatch until max_inflight launches are outstanding or nothing
        is left to dispatch; returns the number of launches."""
        n = 0
        while len(self.ring) < self.max_inflight:
            segments = self._coalesce()
            if not segments:
                break
            self._dispatch(segments)
            n += 1
        return n

    def _dispatch(self, segments) -> None:
        dv = self.store.acquire()       # one version per launch
        slot = self._free_slots.pop()
        staging = self._staging[slot]
        tile = staging.numpy()
        placed, fill = [], 0
        for req, r0, take in segments:
            tile[fill:fill + take] = req.words[r0:r0 + take]
            placed.append((req, r0, fill, take))
            fill += take
        rows = self._bucket_rows(fill)
        tile[fill:rows] = 0             # padded words must stay empty
        words = staging[:rows].to(self.device, non_blocking=True)
        kw = dict(infix=self.infix, match=self.match, block_b=self.block_b,
                  dict_block_r=self.dict_block_r,
                  num_buffers=self.num_buffers, skip_index=self.skip_index,
                  with_checksum=True, device=self.device)
        if self.persistent:
            root, source, flags, checksums = ops.extract_roots_persistent(
                words, dv.handle, version_slot=dv.version, **kw)
        else:
            root, source, checksums = ops.extract_roots_fused(
                words, dv.handle, **kw)
            flags = None
        tiles = rows // self.block_b
        roots_h, sources_h, sums_h, flags_h = self._outputs[slot]
        copies = [(roots_h[:rows], root), (sources_h[:rows], source),
                  (sums_h[:tiles], checksums)]
        if flags is not None:
            copies.append((flags_h[:tiles], flags))
        on_cuda = self.device.type == "cuda"
        for dst, src in copies:
            dst.copy_(src, non_blocking=on_cuda)
        event = None
        if on_cuda:
            event = torch.cuda.Event()
            event.record()
        self.ring.append(InflightTile(
            placed, dv.version, slot, roots_h[:rows], sources_h[:rows],
            sums_h[:tiles], flags_h[:tiles] if flags is not None else None,
            event))
        self.ticks_launched += 1

    # -- retire side -------------------------------------------------------
    def _retire_ready(self) -> int:
        """Retire every launch whose results are on the host, without
        blocking; returns the number retired."""
        still, n = [], 0
        for entry in self.ring:
            if entry.is_ready():
                self._retire(entry)
                n += 1
            else:
                still.append(entry)
        self.ring = still
        return n

    def _retire(self, entry: InflightTile) -> None:
        """Verify one launch's completion flags and checksums and scatter
        its results back (blocks until its copies have landed)."""
        entry.wait()
        if entry.flags is not None:
            # every descriptor of the persistent launch must have retired
            # under the version pinned at dispatch (0 = never processed)
            flags = entry.flags.numpy()
            if not (flags == 1 + entry.version).all():
                raise RuntimeError(
                    "persistent launch retired with bad completion flags:"
                    f" expected {1 + entry.version}, got {flags.tolist()}")
            self.flag_tiles += flags.shape[0]
        roots = entry.roots.numpy()
        sources = entry.sources.numpy()
        want = entry.checksums.numpy()
        got = ops.tile_checksum_host(roots, sources, block_b=self.block_b)
        if not np.array_equal(got, want):
            bad = np.nonzero(got != want)[0].tolist()
            raise RuntimeError(
                f"retire checksum mismatch on tile(s) {bad} of"
                f" {want.shape[0]} (device vs host copy)")
        self.checksum_tiles += want.shape[0]
        for req, r0, t0, take in entry.segments:
            req.roots[r0:r0 + take] = roots[t0:t0 + take]
            req.sources[r0:r0 + take] = sources[t0:t0 + take]
            req.dict_versions[r0:r0 + take] = entry.version
            req.served += take
        self._free_slots.append(entry.slot)


# ---------------------------------------------------------------------------
# LM decode workload
# ---------------------------------------------------------------------------
@dataclass
class FailureInfo:
    """Terminal failure attached to a request: ``code`` is ``deadline``
    (its deadline passed while it decoded) or ``cancelled`` (torn down by
    ``cancel_pending``); ``detail`` says how far it got."""

    rid: int
    code: str
    detail: str = ""


@dataclass
class Request:
    rid: int
    prompt: np.ndarray          # int32 [T]
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
        return Request(rid, np.asarray(prompt, np.int32), max_new)

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
        toks = torch.zeros((self.B, 1), dtype=torch.int32, device=self.device)
        toks[slot] = token
        logits, new_caches = self._decode(self.params, toks, self.caches,
                                          int(self.slot_pos[slot]))
        # keep only this slot's cache rows (positions differ per slot)
        _merge_slot(self.caches, new_caches, slot)
        self.slot_pos[slot] += 1
        if emit:
            nxt = int(torch.argmax(logits[slot, -1], dim=-1))
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
    """Copy slot ``slot``'s rows (batch axis 1 of every [L, B, ...] leaf)
    from ``new`` into ``old``, in place: the reference builds a new tree
    with ``.at[:, slot].set``; the values are the same."""
    pm.tree_map(lambda o, n: o[:, slot].copy_(n[:, slot]), old, new)

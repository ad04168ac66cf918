"""The two entries the cells drive: serving (``Engine`` over a
``StemmerWorkload`` or ``TextAnalysisWorkload``, a closed loop of clients)
and the corpus index (``build_corpus_index`` back to back).

Each driver makes its pool of inputs from the seed in set-up, builds the
program through its public entries, warms up the shapes its traffic uses,
then runs measured windows over the pool and keeps a sample of their
answers, drawn from the seed, for the reference to judge once the windows
have closed.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np

from stembench import generate

DRAIN_LIMIT_S = 60.0    # an answer later than this past the window is lost


@dataclass
class Chunk:
    """One corpus chunk as ``build_corpus_index`` reads it."""

    words: np.ndarray       # int32[n, 16]
    doc_ids: np.ndarray     # int64[n]
    positions: np.ndarray   # int32[n]
    start_word: int

    @property
    def n_words(self) -> int:
        return int(self.words.shape[0])


class Answers:
    """The window's answers to a sample of its requests, drawn from the
    seed, held against one copy a pool entry.

    The first sampled answer of each pool entry is copied into buffers
    written once in set-up, one row a pool word, for the reference to
    judge once the window has closed. Every later sampled answer of that
    entry, whose request is the same, is compared with the copy in place,
    word by word, as it completes. So memory is bounded by the pool and
    every sampled request is judged at any rate. Holding on to the
    program's own result arrays would make every later request of the
    program allocate fresh pages (their page faults cost as much as the
    request's copy itself), so none is kept."""

    FIELDS = (("roots", (4,)), ("sources", ()))
    TEXT_FIELDS = (("words", (16,)), ("spans", (2,)), ("doc_ids", ()))
    GEOMETRY = tuple(name for name, _ in TEXT_FIELDS)

    def __init__(self, sizes, share: float, seed: int, text: bool):
        fields = self.FIELDS + (self.TEXT_FIELDS if text else ())
        self.sizes = np.asarray(sizes, np.int64)
        self.starts = np.cumsum(self.sizes) - self.sizes
        self.bufs = {}
        for name, shape in fields:
            buf = np.empty((int(self.sizes.sum()),) + shape, np.int32)
            buf.fill(0)                      # touch every page now
            self.bufs[name] = buf
        self.kept = np.zeros(self.sizes.size, bool)
        self.keep = np.random.default_rng([seed, 4]).random(1 << 20) < share
        self.seen = 0            # sampled answers
        self.compared = 0        # of them, held against their entry's copy
        self.changed = 0         # words differing from the copy
        self.changed_geometry = 0    # of them, in their row, span or doc
        self.misshapen = 0       # words of answers of the wrong shape
        self.bad = 0             # answers changed or misshapen

    def wants(self, seq: int) -> bool:
        return not self.seen or bool(self.keep[seq % self.keep.size])

    def add(self, k: int, req) -> None:
        self.seen += 1
        at, n = int(self.starts[k]), int(self.sizes[k])
        rows = {name: buf[at:at + n] for name, buf in self.bufs.items()}
        got = {name: np.asarray(getattr(req, name)) for name in rows}
        if any(got[name].shape != rows[name].shape for name in rows):
            self.misshapen += n
            self.bad += 1
            return
        if not self.kept[k]:
            for name, row in rows.items():
                row[...] = got[name]
            self.kept[k] = True
            return
        self.compared += 1
        diff = {name: (rows[name] != got[name]).reshape(n, -1).any(axis=1)
                for name in rows}
        geo = np.zeros(n, bool)
        for name in self.GEOMETRY:
            if name in diff:
                geo |= diff[name]
        changed = int((diff["roots"] | diff["sources"] | geo).sum())
        self.changed += changed
        self.changed_geometry += int(geo.sum())
        self.bad += changed > 0

    def __len__(self) -> int:
        return self.seen

    def __iter__(self):
        """(pool entry, its kept answer) for the reference to judge."""
        for k in np.flatnonzero(self.kept):
            at, n = int(self.starts[k]), int(self.sizes[k])
            yield int(k), {name: buf[at:at + n]
                           for name, buf in self.bufs.items()}


@dataclass
class Window:
    """What one measured window did: the host-clock spans of the calls
    into the program and the work it was given. Its sampled answers go
    to the driver's ``answers``, which every window of a run shares."""

    t_start: float = 0.0                 # perf_counter at its first request
    seconds: float = 0.0                 # the window's length
    done_words: int = 0                  # words answered inside the window
    latencies: list = field(default_factory=list)    # s, requests done
    done_at: list = field(default_factory=list)      # s into the window
    submit_s: float = 0.0                # time inside Engine.submit
    build_s: list = field(default_factory=list)      # s a build
    lost: int = 0                        # requests with no sound answer
    work: dict = field(default_factory=dict)         # words, codepoints...
    counters: dict = field(default_factory=dict)     # program counters


def _spans(tracing: bool):
    """Named host spans for the traced run's timeline (nothing otherwise)."""
    if not tracing:
        return lambda name: contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _release(device) -> None:
    import gc

    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# serving: a closed loop of clients, one outstanding request each
# ---------------------------------------------------------------------------
class Serve:
    COUNTERS = ("ticks_launched", "checksum_tiles", "flag_tiles",
                "retries_total", "bisections", "quarantined", "timeouts",
                "checksum_failures", "watchdog_stalls", "device_losses")

    def __init__(self, config: dict, traffic: dict, dictionary, table,
                 seed: int, device):
        self.config, self.traffic, self.device = config, traffic, device
        self.table = table
        self.text = traffic["payload"] == "text"
        n_req = traffic["pool_words"] // traffic["request_words"]
        if self.text:
            per = traffic["docs_per_request"]
            shape = (n_req, per, traffic["request_words"] // per)
        else:
            shape = (n_req, traffic["request_words"])
        self.tokens = generate.draw_tokens(
            table, int(np.prod(shape)), [seed, 1]).reshape(shape)
        if self.text:
            self.pool = [[generate.document(table, doc) for doc in req]
                         for req in self.tokens]
        else:
            self.pool = [table.rows[req] for req in self.tokens]
        self.codepoints = [sum(len(d) for d in req) if self.text else 0
                           for req in self.pool]
        self.seed = seed
        self.seq = 0        # requests submitted since set-up began
        self.answers = Answers([t.size for t in self.tokens],
                               traffic["check_share"], seed, self.text)
        self.engine = self._engine(dictionary)

    def _engine(self, d):
        from repro_torch.core.stemmer import RootDictArrays
        from repro_torch.serve import (DictStore, Engine, StemmerWorkload,
                                       TextAnalysisWorkload)

        cfg = self.config
        arrays = RootDictArrays.from_numpy(d.tri, d.quad, d.bi,
                                           device=self.device)
        store = DictStore(arrays, device=self.device, infix=cfg["infix"],
                          **cfg.get("store", {}))
        kw = dict(block_b=cfg["block_b"], infix=cfg["infix"],
                  megabatch_tiles=cfg["batch_words"] // cfg["block_b"],
                  max_inflight=cfg["max_inflight"],
                  **self.traffic.get("workload", {}))
        kind = TextAnalysisWorkload if self.text else StemmerWorkload
        return Engine(kind(store, **kw))

    def _bucket_payload(self, words: int):
        """A request of exactly ``words`` words from the pool's tokens."""
        toks = self.tokens.reshape(-1)[:words]
        if self.text:
            return [generate.document(self.table, toks)]
        return self.table.rows[toks]

    def warm_up(self) -> None:
        """Every launch width the ring can take (the power-of-two tile
        counts up to a full batch), then the closed loop itself."""
        cfg, eng = self.config, self.engine
        tiles = 1
        while tiles * cfg["block_b"] <= cfg["batch_words"]:
            eng.submit(self._bucket_payload(tiles * cfg["block_b"]))
            eng.run_until_drained(max_ticks=100_000)
            eng.finished.clear()
            tiles *= 2
        self.window(self.traffic["warmup_s"], keep=False)
        _sync(self.device)

    def window(self, seconds: float, *, keep: bool = True,
               tracing: bool = False) -> Window:
        eng, wl = self.engine, self.engine.workload
        span = _spans(tracing)
        n_pool = len(self.pool)
        out = Window()
        before = {c: getattr(wl, c) for c in self.COUNTERS}
        inflight: dict[int, tuple[int, int, float]] = {}
        submitted = 0
        words = codepoints = 0

        def submit(now: float) -> None:
            nonlocal submitted, words, codepoints
            k = submitted % n_pool
            with span("stembench.submit"):
                rid = eng.submit(self.pool[k])
            out.submit_s += time.perf_counter() - now
            inflight[rid] = (self.seq, k, now)
            self.seq += 1
            submitted += 1
            words += self.tokens[k].size
            codepoints += self.codepoints[k]

        start = out.t_start = time.perf_counter()
        end = start + seconds
        for _ in range(self.traffic["clients"]):
            submit(time.perf_counter())
        now = start
        while inflight and now < end + DRAIN_LIMIT_S:
            with span("stembench.step"):
                eng.step()
            now = time.perf_counter()
            if not eng.finished:
                continue
            done = list(eng.finished.values())
            eng.finished.clear()
            for req in done:
                seq, k, t0 = inflight.pop(req.rid)
                if req.failure is not None or not req.done:
                    out.lost += 1
                    continue
                if now < end:
                    out.done_words += req.n_words
                    out.latencies.append(now - t0)
                    out.done_at.append(now - start)
                if keep and self.answers.wants(seq):
                    self.answers.add(k, req)
            if now < end:
                for _ in done:
                    submit(time.perf_counter())
        out.lost += len(inflight)
        _sync(self.device)
        out.seconds = seconds
        out.work = dict(words=words, codepoints=codepoints,
                        requests=submitted)
        out.counters = {c: getattr(wl, c) - before[c] for c in self.COUNTERS}
        return out

    def release(self) -> None:
        """Drop the program's state (engine, store, device buffers)."""
        self.engine = None
        _release(self.device)


# ---------------------------------------------------------------------------
# the corpus index: builds back to back
# ---------------------------------------------------------------------------
class Index:
    def __init__(self, config: dict, traffic: dict, dictionary, table,
                 seed: int, device):
        self.config, self.traffic, self.device = config, traffic, device
        self.table, self.seed = table, seed
        self.builds = 0     # builds since the first window began
        self.answers = []   # (pool corpus, index): a sample of the builds
        n, chunk = traffic["corpus_words"], traffic["chunk_words"]
        per_doc = traffic["words_per_doc"]
        self.tokens = generate.draw_tokens(
            table, traffic["pool_corpora"] * n, [seed, 2]
        ).reshape(traffic["pool_corpora"], n)
        self.pool = []
        for toks in self.tokens:
            chunks = []
            for w0 in range(0, n, chunk):
                gwi = w0 + np.arange(min(chunk, n - w0), dtype=np.int64)
                chunks.append(Chunk(table.rows[toks[gwi]], gwi // per_doc,
                                    (gwi % per_doc).astype(np.int32), w0))
            self.pool.append(chunks)
        from repro_torch.core.stemmer import RootDictArrays
        from repro_torch.serve import DictStore

        arrays = RootDictArrays.from_numpy(dictionary.tri, dictionary.quad,
                                           dictionary.bi, device=device)
        self.store = DictStore(arrays, device=device, infix=config["infix"],
                               **config.get("store", {}))

    def build(self, k: int):
        from repro_torch.index import build_corpus_index

        return build_corpus_index(iter(self.pool[k]), self.store,
                                  device=self.device,
                                  infix=self.config["infix"],
                                  **self.traffic["build"])

    def warm_up(self) -> None:
        for _ in range(self.traffic["warmup_builds"]):
            self.build(0)
        _sync(self.device)

    def window(self, seconds: float, *, keep: bool = True,
               tracing: bool = False) -> Window:
        """Builds back to back until ``seconds`` have passed: the window
        ends with its last build, so it holds whole builds only."""
        span = _spans(tracing)
        out = Window()
        sample = np.random.default_rng([self.seed, 4]).random(1 << 16) \
            < self.traffic["check_share"]
        start = now = out.t_start = time.perf_counter()
        k = 0
        while now - start < seconds:
            t = now
            with span("stembench.build"):
                idx = self.build(k % len(self.pool))
            now = time.perf_counter()
            out.build_s.append(now - t)
            # a sample of the builds, drawn from the seed (the first always)
            if keep and (not self.answers
                         or sample[self.builds % sample.size]):
                self.answers.append((k % len(self.pool), idx))
            del idx
            k += 1
            self.builds += 1
        out.seconds = now - start
        out.done_words = k * self.traffic["corpus_words"]
        out.work = dict(words=out.done_words, builds=k,
                        chunks=k * len(self.pool[0]))
        return out

    def release(self) -> None:
        self.store = None
        _release(self.device)


DRIVERS = {"serve": Serve, "index": Index}

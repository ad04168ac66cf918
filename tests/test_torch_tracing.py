"""The port's spans and counters (repro_torch.tracing): nesting, self
time and keys; nothing recorded and nothing allocated while off; the
spans in a CPU profiler's timeline; and the spans the serving ring, text
admission and the index build record, against what those paths did."""
import itertools
import time
import tracemalloc
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from torch.profiler import ProfilerActivity, profile  # noqa: E402
from torch.profiler import record_function  # noqa: E402

from repro_torch import tracing  # noqa: E402
from repro_torch.core import corpus as tcorpus  # noqa: E402
from repro_torch.core import stemmer as tstemmer  # noqa: E402
from repro_torch.index import build_corpus_index  # noqa: E402
from repro_torch.launch.serve import build_documents  # noqa: E402
from repro_torch.serve import (DictStore, Engine, StemmerWorkload,  # noqa: E402
                               TextAnalysisWorkload)
from repro_torch.serve.engine import FailureInfo, RetryGroup  # noqa: E402
from stembench import harness  # noqa: E402

CPU = dict(device="cpu")
ANCHOR = "test.anchor"
SERVE_METRICS = ("make_request_share.serve",
                 "ring_host_us_per_launch.serve", "host_wait_share.serve",
                 "geometry_share.text")
INDEX_METRICS = ("index_merge_share", "index_transfer_share",
                 "copy_bytes_per_word.index")


@pytest.fixture(autouse=True)
def clean_recorder():
    """Every test starts from an empty recorder that is off, and leaves
    one behind for the next test in the process."""
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope="module")
def arrays():
    return tstemmer.RootDictArrays.from_rootdict(
        tcorpus.build_dictionary(n_tri=300, n_quad=40, seed=0), **CPU)


def _busy(us: float) -> None:
    t = time.perf_counter()
    while (time.perf_counter() - t) * 1e6 < us:
        pass


def test_nesting_self_time_and_keys():
    assert not tracing.on()
    tracing.enable()
    assert tracing.on()
    with tracing.span("serve.submit", 7):
        with tracing.span("serve.make_request", 7):
            _busy(300)
        _busy(200)
    with tracing.span("ring.dispatch", 3):
        with tracing.span("ring.stage", 3):
            _busy(100)
        with tracing.span("ring.launch", 3):
            _busy(200)

    recs = {(r.name, r.key): r for r in tracing.records()}
    assert sorted(recs) == sorted([
        ("serve.submit", 7), ("serve.make_request", 7), ("ring.dispatch", 3),
        ("ring.stage", 3), ("ring.launch", 3)])
    submit, dispatch = recs["serve.submit", 7], recs["ring.dispatch", 3]
    assert submit.parent == -1 and dispatch.parent == -1
    assert recs["serve.make_request", 7].parent == submit.index
    assert recs["ring.stage", 3].parent == dispatch.index
    assert recs["ring.launch", 3].parent == dispatch.index
    for r in recs.values():
        assert r.end_ns > r.start_ns

    def dur(*key):
        return recs[key].end_ns - recs[key].start_ns

    s = tracing.summary()
    assert s["dropped"] == 0 and set(s["spans"]) == {n for n, _ in recs}
    want_self = {
        "serve.submit": dur("serve.submit", 7) - dur("serve.make_request", 7),
        "ring.dispatch": (dur("ring.dispatch", 3) - dur("ring.stage", 3)
                          - dur("ring.launch", 3)),
        "ring.stage": dur("ring.stage", 3)}
    for name, ns in want_self.items():
        got = s["spans"][name]
        assert got["count"] == 1
        assert got["self_s"] == pytest.approx(ns * 1e-9, abs=1e-9)
    assert s["spans"]["serve.submit"]["total_s"] == pytest.approx(
        dur("serve.submit", 7) * 1e-9, abs=1e-9)
    assert s["spans"]["serve.submit"]["self_s"] >= 150e-6
    tracing.disable()
    assert not tracing.on()
    tracing.enable()
    tracing.reset()
    with tracing.span("index.build"):          # a span with no key
        pass
    assert [(r.name, r.key, r.parent) for r in tracing.records()] \
        == [("index.build", -1, -1)]


def test_off_records_and_allocates_nothing():
    assert not torch.autograd.profiler._is_profiler_enabled
    key = 123_456_789

    def sites():
        with tracing.span("ring.stage", key):
            pass
        with tracing.span("index.build"):
            pass
        tracing.add("index.copy_bytes", key)

    sites()                                   # warm every code path
    loop = itertools.repeat(None, 2000)
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        before = tracemalloc.get_traced_memory()[0]
        for _ in loop:
            sites()
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert (after, peak) == (before, before)
    s = tracing.summary()
    assert s["spans"] == {} and s["dropped"] == 0
    assert not any(s["counters"].values())


def _serve(workload, payloads):
    eng = Engine(workload)
    launched = workload.ticks_launched
    rids = [eng.submit(p) for p in payloads]
    assert eng.run_until_drained().drained
    assert all(eng.result(r).failure is None for r in rids)
    return eng, workload.ticks_launched - launched


def _words(n_requests: int, size: int):
    words, _, _ = tcorpus.build_corpus(n_words=n_requests * size, seed=1)
    enc = tcorpus.encode_corpus(words)
    return [enc[i * size:(i + 1) * size] for i in range(n_requests)]


def _kineto_spans(events, thread):
    """The events of the port's span names on ``thread``, by name."""
    out = {}
    for e in events:
        if e.name() in tracing.NAMES and e.start_thread_id() == thread:
            out.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    return out


def test_spans_sit_in_the_profilers_timeline(arrays):
    """Each span recorded under a CPU profiler has an event of its name on
    its thread, in the same order and of the same length within 50 us;
    and the polls that find nothing to coalesce record no span and leave
    no event."""
    wl = StemmerWorkload(DictStore(arrays, **CPU), block_b=64,
                         megabatch_tiles=2, max_inflight=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(ANCHOR):
            eng, _ = _serve(wl, _words(6, 50))
            taken = tracing.RECORDER.n
            for _ in range(20):
                eng.step()                   # idle polls
            assert tracing.RECORDER.n == taken
    events = prof.profiler.kineto_results.events()
    anchor = next(e for e in events if e.name() == ANCHOR)
    kineto = _kineto_spans(events, anchor.start_thread_id())
    recs = {}
    for r in tracing.records():
        recs.setdefault(r.name, []).append(r)
    assert set(recs) == set(kineto)
    assert len(recs["serve.submit"]) == 6
    for name, spans in recs.items():
        events = sorted(kineto[name])
        assert len(events) == len(spans), name
        for r, (a, b) in zip(spans, events):
            assert abs((b - a) - (r.end_ns - r.start_ns)) < 50_000, r


@pytest.mark.parametrize("state", ["fresh", "claimed", "failed",
                                   "retry_due", "retry_backing_off",
                                   "retry_failed"])
def test_a_coalesce_span_opens_only_where_a_group_is_found(arrays, state):
    """The look that decides whether a poll gets a ``ring.coalesce`` span
    agrees with what ``_next_group`` then finds."""
    wl = StemmerWorkload(DictStore(arrays, **CPU), block_b=64,
                         megabatch_tiles=2, max_inflight=2)
    req = wl.make_request(0, _words(1, 50)[0])
    wl.admit(req)
    if state != "fresh" and state != "failed":
        req.dispatched = req.n_words            # claimed by a launch
    if state.startswith("retry"):
        wait = 3600.0 if state == "retry_backing_off" else 0.0
        wl._requeue.append(RetryGroup([(req, 0, req.n_words)],
                                      not_before=time.monotonic() + wait))
    if state.endswith("failed"):
        req.failure = FailureInfo(0, "cancelled")
    found = state in ("fresh", "retry_due")
    assert wl._dispatchable() is found
    assert (wl._next_group() is not None) is found


@pytest.mark.parametrize("payload", ["words", "text"])
def test_traced_engine_records_the_ring_and_admission(arrays, payload):
    store = DictStore(arrays, **CPU)
    kw = dict(block_b=64, megabatch_tiles=2, max_inflight=2)
    if payload == "text":
        wl = TextAnalysisWorkload(store, char_block=256, **kw)
        docs = build_documents(8, 24, seed=2)
        payloads = [docs[i:i + 2] for i in range(0, 8, 2)]
    else:
        wl = StemmerWorkload(store, **kw)
        payloads = _words(5, 70)
    with profile(activities=[ProfilerActivity.CPU]):
        eng, launches = _serve(wl, payloads)
    s = tracing.summary()
    count = {n: v["count"] for n, v in s["spans"].items()}
    assert launches > 0 and count["ring.dispatch"] == launches
    for name in ("ring.stage", "ring.launch", "ring.retire", "ring.wait",
                 "ring.checksum", "ring.scatter"):
        assert count[name] == launches, name
    assert count["ring.coalesce"] == launches
    assert count["serve.submit"] == count["serve.make_request"] \
        == len(eng.finished) == len(payloads)
    assert s["dropped"] == 0
    text = ("text.coalesce", "text.geometry", "text.frontend",
            "text.readback", "text.doc_ids")
    for name in text:
        assert count.get(name, 0) == (len(payloads) if payload == "text"
                                      else 0), name
    # every launch's spans carry its sequence number
    keys = {n: sorted(r.key for r in tracing.records() if r.name == n)
            for n in ("ring.dispatch", "ring.retire", "ring.scatter")}
    assert keys["ring.dispatch"] == keys["ring.retire"] \
        == keys["ring.scatter"] == list(range(launches))
    run = SimpleNamespace(kind="serve", text=payload == "text",
                          trace=SimpleNamespace(window_s=60.0))
    for name in SERVE_METRICS:
        got = harness.metric_reader(name)(run)
        assert (got is None) == (name == "geometry_share.text"
                                 and payload == "words"), name


def test_index_build_records_chunks_and_copied_bytes(arrays):
    table = tcorpus.build_token_table(forms_per_root=6)
    chunks = list(tcorpus.stream_corpus_words(
        5000, seed=3, chunk_words=2048, words_per_doc=500, table=table))
    assert len(chunks) == 3
    tracing.enable()
    idx = build_corpus_index(iter(chunks), arrays, block_b=512,
                             block_w=512, **CPU)
    s = tracing.summary()
    count = {n: v["count"] for n, v in s["spans"].items()}
    # a chunk uploads twice: words and vocabulary before the stemmer, doc
    # ids and positions inside index.compute, after it is enqueued
    assert count == {"index.build": 1, "index.vocab": 1, "index.upload": 6,
                     "index.compute": 3, "index.readback": 3,
                     "index.merge": 1}
    uploads = [r for r in tracing.records() if r.name == "index.upload"]
    compute = {r.index for r in tracing.records()
               if r.name == "index.compute"}
    assert sum(r.parent in compute for r in uploads) == 3
    n_roots = idx.n_roots
    # up: words [n, 16], doc ids, positions and the vocabulary, as int32;
    # back: the count, counts a root, and each posting's doc and position
    want = sum(4 * (16 * ch.n_words + 2 * ch.n_words + n_roots)
               for ch in chunks) + sum(4 + 4 * n_roots for _ in chunks) \
        + 8 * idx.n_postings
    assert s["counters"]["index.copy_bytes"] == want
    assert s["counters"]["index.words"] == sum(ch.n_words for ch in chunks)
    run = SimpleNamespace(kind="index", trace=SimpleNamespace(window_s=60.0))
    for name in INDEX_METRICS:
        assert harness.metric_reader(name)(run) is not None, name


@pytest.mark.parametrize("name", SERVE_METRICS + INDEX_METRICS)
def test_a_record_with_drops_reads_none(monkeypatch, name):
    small = tracing.Recorder(capacity=4)
    monkeypatch.setattr(tracing, "RECORDER", small)
    tracing.enable()
    kind = "index" if name in INDEX_METRICS else "serve"
    tracing.add("index.words", 10)
    for i in range(6):
        with tracing.span("index.build" if kind == "index"
                          else "serve.make_request", i):
            with tracing.span("text.geometry" if kind == "serve"
                              else "index.merge", i):
                pass
        with tracing.span("ring.dispatch", i):
            pass
    assert small.dropped > 0 and small.n == small.capacity
    run = SimpleNamespace(kind=kind, text=True,
                          trace=SimpleNamespace(window_s=1.0))
    assert harness.metric_reader(name)(run) is None

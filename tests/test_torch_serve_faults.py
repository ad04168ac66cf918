"""The port's fault tolerance (repro_torch.serve.faults and the fault
paths of Engine, StemmerWorkload, TextAnalysisWorkload, DictStore and the
corpus-index builder) against the JAX package: a counterpart of each test
of tests/test_serve_faults.py, with the same name, on the port's plain
paths. Every run that absorbs a fault must equal the reference stemmer's
fault-free output (its jnp path) bit for bit; three of them also run the
reference engine under the same FaultPlan and must match its outputs,
counters and event kinds."""
import itertools
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro import index as rix  # noqa: E402
from repro import serve as rserve  # noqa: E402
from repro.core import corpus as rcorpus  # noqa: E402
from repro.core import stemmer as rstemmer  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.core import corpus as tcorpus  # noqa: E402
from repro_torch.core import stemmer as tstemmer  # noqa: E402
from repro_torch.index import builder  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve import (DictStore, DictValidationError, Engine,  # noqa: E402
                               EngineUndrained, FailureInfo, FaultInjector,
                               FaultPlan, FaultSpec, InjectedFault,
                               QueueFull, StemmerWorkload,
                               TextAnalysisWorkload, validate_handle)

COUNTERS = ("retries_total", "bisections", "quarantined", "timeouts",
            "checksum_failures", "watchdog_stalls", "device_losses",
            "ticks_launched")


def _port(da):
    return tstemmer.RootDictArrays.from_numpy(
        np.asarray(da.tri), np.asarray(da.quad), np.asarray(da.bi),
        device="cpu")


def _store(arrays, **kw):
    return DictStore(arrays, device="cpu", **kw)


@pytest.fixture(scope="module")
def dict_and_words():
    d = rcorpus.build_dictionary(n_tri=400, n_quad=60, seed=0)
    rarrays = rstemmer.RootDictArrays.from_rootdict(d)
    words, _, _ = rcorpus.build_corpus(n_words=256, seed=1)
    return _port(rarrays), rcorpus.encode_corpus(words), rarrays


@pytest.fixture(scope="module")
def baseline(dict_and_words):
    """The reference stemmer's fault-free roots (its jnp path) for the
    8 x 32-word requests."""
    _, enc, rarrays = dict_and_words
    roots, _ = rstemmer.extract_roots(jnp.asarray(enc), rarrays,
                                      backend="sorted")
    roots = np.asarray(roots)
    return [roots[i * 32:(i + 1) * 32] for i in range(8)]


def _drain_8(arrays, enc, *, injector=None, **kw):
    eng = Engine(StemmerWorkload(_store(arrays), block_b=32,
                                 max_inflight=2, injector=injector, **kw))
    rids = [eng.submit(enc[i * 32:(i + 1) * 32]) for i in range(8)]
    assert eng.run_until_drained().drained
    return eng, rids


def _plan(mod, specs=(), poison=(), seed=0):
    return mod.FaultPlan(specs=tuple(mod.FaultSpec(*a, **k)
                                     for a, k in specs),
                         seed=seed, poison_rids=frozenset(poison))


def _against_reference_engine(dict_and_words, specs=(), poison=(), **kw):
    """Six 32-word requests at block_b 64 through both packages' engines
    (max_inflight 1, so both take the same schedule) under the same
    FaultPlan: the same outputs and failures, counters, event kinds and
    fired log."""
    arrays, enc, rarrays = dict_and_words
    runs = []
    for mod, store in ((rserve, rserve.DictStore(rarrays)),
                       (tserve, _store(arrays))):
        inj = mod.FaultInjector(_plan(mod, specs, poison))
        eng = mod.Engine(mod.StemmerWorkload(store, block_b=64,
                                             max_inflight=1, injector=inj,
                                             **kw))
        rids = [eng.submit(enc[i * 32:(i + 1) * 32]) for i in range(6)]
        assert eng.run_until_drained().drained
        runs.append((eng, rids, inj))
    (r_eng, r_rids, r_inj), (t_eng, t_rids, t_inj) = runs
    assert t_inj.fired == r_inj.fired
    for name in COUNTERS:
        assert getattr(t_eng.workload, name) == \
            getattr(r_eng.workload, name), name
    assert [e.kind for e in t_eng.events()] == \
        [e.kind for e in r_eng.events()]
    for rr, tr in zip(r_rids, t_rids):
        want, got = r_eng.result(rr), t_eng.result(tr)
        assert (got.failure is None) == (want.failure is None)
        if want.failure is None:
            np.testing.assert_array_equal(got.roots, np.asarray(want.roots))
            np.testing.assert_array_equal(got.sources,
                                          np.asarray(want.sources))
        else:
            assert (got.failure.code, got.failure.retries) == \
                (want.failure.code, want.failure.retries)
    return t_eng


# ---------------------------------------------------------------------------
# the injector itself
# ---------------------------------------------------------------------------
def test_fault_spec_validation():
    with pytest.raises(ValueError, match="site"):
        FaultSpec("gpu")
    with pytest.raises(ValueError, match="kind"):
        FaultSpec("dispatch", kind="corrupt")   # corrupt is retire-only
    with pytest.raises(ValueError, match="at"):
        FaultSpec("dispatch", at=-1)
    with pytest.raises(ValueError, match="count"):
        FaultSpec("retire", count=0)
    s = FaultSpec("dispatch", at=2, count=3)
    assert s.kind == "fail"                     # site default
    assert not s.covers(1) and s.covers(2) and s.covers(4)
    assert not s.covers(5)
    assert tserve.faults.SITES == rserve.faults.SITES
    assert tserve.faults.KINDS == rserve.faults.KINDS


def test_injector_is_deterministic():
    """Same plan + same event sequence -> identical fired log and
    identical corruption, equal to the reference injector's."""
    roots0 = np.arange(128, dtype=np.int32).reshape(32, 4)
    srcs = np.zeros(32, np.int32)
    outs = []
    for mod in (tserve, tserve, rserve):
        inj = mod.FaultInjector(_plan(mod, [(("retire",), dict(at=0))],
                                      seed=42))
        r2, _ = inj.on_retire(roots0, srcs)
        outs.append((np.array(r2), inj.fired[:]))
    for got in outs[1:]:
        np.testing.assert_array_equal(outs[0][0], got[0])
        assert got[1] == outs[0][1] == [("retire", "corrupt", 0)]
    assert not np.array_equal(outs[0][0], roots0)


# ---------------------------------------------------------------------------
# dispatch faults: retry, backoff, bisection quarantine
# ---------------------------------------------------------------------------
def test_dispatch_fault_mid_ring_bit_identical(dict_and_words, baseline):
    """An injected launch failure with max_inflight=2 is retried and the
    full drain stays bit-identical to the fault-free run; the reference
    engine under the same plan agrees."""
    arrays, enc, _ = dict_and_words
    inj = FaultInjector(FaultPlan(specs=(FaultSpec("dispatch", at=1),)))
    eng, rids = _drain_8(arrays, enc, injector=inj)
    assert inj.fired == [("dispatch", "fail", 1)]
    assert eng.workload.retries_total == 1
    for rid, want in zip(rids, baseline):
        req = eng.result(rid)
        assert req.failure is None
        np.testing.assert_array_equal(req.roots, want)
    t_eng = _against_reference_engine(dict_and_words,
                                      [(("dispatch",), dict(at=1))])
    assert t_eng.workload.retries_total == 1


def test_repeated_dispatch_faults_with_backoff(dict_and_words, baseline):
    arrays, enc, _ = dict_and_words
    inj = FaultInjector(FaultPlan(specs=(FaultSpec("dispatch", count=2),)))
    eng, rids = _drain_8(arrays, enc, injector=inj, max_retries=3,
                         retry_backoff_s=0.01)
    assert eng.workload.retries_total == 2
    for rid, want in zip(rids, baseline):
        np.testing.assert_array_equal(eng.result(rid).roots, want)


def test_poison_pill_bisection_quarantine(dict_and_words, baseline):
    """Four requests coalesce into one tile; the poisoned one is isolated
    by bisection and quarantined while the other three complete
    bit-identically; the reference engine bisects the same way."""
    arrays, enc, _ = dict_and_words
    inj = FaultInjector(FaultPlan(poison_rids=frozenset({2})))
    eng = Engine(StemmerWorkload(_store(arrays), block_b=128,
                                 max_inflight=1, max_retries=1,
                                 injector=inj))
    rids = [eng.submit(enc[i * 32:(i + 1) * 32]) for i in range(4)]
    assert eng.run_until_drained().drained
    w = eng.workload
    assert w.bisections >= 1 and w.quarantined == 1
    for i, rid in enumerate(rids):
        req = eng.result(rid)
        if i == 2:
            assert isinstance(req.failure, FailureInfo)
            assert req.failure.code == "quarantined"
            assert req.failure.rid == rid and req.failure.retries > 0
        else:
            assert req.failure is None
            np.testing.assert_array_equal(req.roots, baseline[i])
    t_eng = _against_reference_engine(dict_and_words, poison={3},
                                      max_retries=1)
    assert t_eng.workload.quarantined == 1


def test_strict_mode_propagates_first_failure(dict_and_words):
    arrays, enc, _ = dict_and_words
    inj = FaultInjector(FaultPlan(specs=(FaultSpec("dispatch", at=0),)))
    eng = Engine(StemmerWorkload(_store(arrays), block_b=32,
                                 max_retries=0, injector=inj))
    eng.submit(enc[:32])
    with pytest.raises(InjectedFault):
        eng.step()
    assert all(r.dispatched == 0 for r in eng.workload.inflight)
    assert eng.run_until_drained().drained


# ---------------------------------------------------------------------------
# retire faults: checksum catches corrupted results
# ---------------------------------------------------------------------------
def test_tile_checksum_host_device_parity(dict_and_words):
    arrays, enc, rarrays = dict_and_words
    roots, sources = tstemmer.extract_roots(enc[:64], arrays, device="cpu")
    dev = ops.tile_checksum(roots, sources, block_b=32).numpy()
    host = ops.tile_checksum_host(roots.numpy(), sources.numpy(), block_b=32)
    assert dev.shape == (2,)
    np.testing.assert_array_equal(dev, host)
    r_roots, r_sources = rstemmer.stem_batch(jnp.asarray(enc[:64]), rarrays)
    np.testing.assert_array_equal(
        host, np.asarray(rops.tile_checksum(r_roots, r_sources, block_b=32)))
    bad = roots.numpy().copy()
    bad[5, 1] ^= 0x5A
    assert ops.tile_checksum_host(bad, sources.numpy(),
                                  block_b=32)[0] != host[0]


def test_retire_corruption_detected_and_retried(dict_and_words, baseline):
    arrays, enc, _ = dict_and_words
    inj = FaultInjector(FaultPlan(specs=(FaultSpec("retire", at=0),)))
    eng, rids = _drain_8(arrays, enc, injector=inj)
    assert eng.workload.checksum_failures == 1
    assert eng.workload.retries_total == 1
    for rid, want in zip(rids, baseline):
        req = eng.result(rid)
        assert req.failure is None
        np.testing.assert_array_equal(req.roots, want)
    t_eng = _against_reference_engine(dict_and_words,
                                      [(("retire",), dict(at=1))])
    assert t_eng.workload.checksum_failures == 1


def test_retire_corruption_strict_mode_raises(dict_and_words):
    arrays, enc, _ = dict_and_words
    inj = FaultInjector(FaultPlan(specs=(FaultSpec("retire", at=0),)))
    eng = Engine(StemmerWorkload(_store(arrays), block_b=32,
                                 max_retries=0, injector=inj))
    eng.submit(enc[:32])
    with pytest.raises(RuntimeError, match="checksum"):
        eng.run_until_drained()


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------
def test_deadline_expired_request_fails_later_succeed(dict_and_words,
                                                      baseline):
    arrays, enc, _ = dict_and_words
    eng = Engine(StemmerWorkload(_store(arrays), block_b=32))
    rid_dead = eng.submit(enc[:32], deadline_s=0.001)
    time.sleep(0.01)
    rid_live = eng.submit(enc[32:64])
    assert eng.run_until_drained().drained
    dead = eng.result(rid_dead)
    assert dead.failure is not None and dead.failure.code == "deadline"
    live = eng.result(rid_live)
    assert live.failure is None
    np.testing.assert_array_equal(live.roots, baseline[1])


def test_deadline_far_future_never_fires(dict_and_words, baseline):
    arrays, enc, _ = dict_and_words
    eng = Engine(StemmerWorkload(_store(arrays), block_b=32))
    rid = eng.submit(enc[:32], deadline_s=3600.0)
    assert eng.run_until_drained().drained
    assert eng.result(rid).failure is None
    np.testing.assert_array_equal(eng.result(rid).roots, baseline[0])


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------
def test_queue_cap_validation(dict_and_words):
    arrays, _, _ = dict_and_words
    w = StemmerWorkload(_store(arrays), block_b=32)
    with pytest.raises(ValueError, match="on_full"):
        Engine(w, queue_cap=2, on_full="explode")
    with pytest.raises(ValueError, match="queue_cap"):
        Engine(w, queue_cap=0)
    with pytest.raises(ValueError, match="queue_cap"):
        Engine(w, on_full="shed")   # a cap-less queue is never full


def test_queue_cap_raise(dict_and_words):
    arrays, enc, _ = dict_and_words
    eng = Engine(StemmerWorkload(_store(arrays), block_b=32),
                 queue_cap=1, on_full="raise")
    eng.submit(enc[:32])
    with pytest.raises(QueueFull):
        eng.submit(enc[:32])
    assert eng.run_until_drained().drained      # admitted work unaffected


def test_queue_cap_shed(dict_and_words, baseline):
    arrays, enc, _ = dict_and_words
    eng = Engine(StemmerWorkload(_store(arrays), block_b=32),
                 queue_cap=2, on_full="shed")
    rids = [eng.submit(enc[:32]) for _ in range(5)]
    shed = [r for r in rids if eng.result(r) is not None
            and eng.result(r).failure is not None]
    assert len(shed) == 3 and eng.shed == 3
    for r in shed:
        assert eng.result(r).failure.code == "shed"
    assert eng.run_until_drained().drained
    for r in rids:
        if r not in shed:
            np.testing.assert_array_equal(eng.result(r).roots, baseline[0])


def test_queue_cap_block(dict_and_words, baseline):
    arrays, enc, _ = dict_and_words
    eng = Engine(StemmerWorkload(_store(arrays), block_b=32),
                 queue_cap=1, on_full="block")
    rids = [eng.submit(enc[i * 32:(i + 1) * 32]) for i in range(4)]
    assert eng.run_until_drained().drained and eng.shed == 0
    for rid, want in zip(rids, baseline):
        np.testing.assert_array_equal(eng.result(rid).roots, want)


def test_undrained_raise_cancels_and_engine_reusable(dict_and_words,
                                                     baseline):
    arrays, enc, _ = dict_and_words
    inj = FaultInjector(FaultPlan(poison_rids=frozenset({0})))
    eng = Engine(StemmerWorkload(_store(arrays), block_b=32,
                                 max_retries=50, retry_backoff_s=0.01,
                                 injector=inj))
    eng.submit(enc[:32])
    with pytest.raises(EngineUndrained) as exc:
        eng.run_until_drained(max_ticks=3)
    assert exc.value.report.cancelled == [0]
    assert eng.result(0).failure.code == "cancelled"
    assert not eng.queue and eng.workload.active == 0
    assert sorted(eng.workload._free_slots) == [0, 1]
    rid = eng.submit(enc[32:64])
    assert eng.run_until_drained().drained
    np.testing.assert_array_equal(eng.result(rid).roots, baseline[1])


# ---------------------------------------------------------------------------
# text workload inherits the whole fault path
# ---------------------------------------------------------------------------
def test_text_workload_dispatch_fault_and_failed_read(dict_and_words):
    arrays, _, rarrays = dict_and_words
    docs = ["كتب الولد درسا", "ذهب الرجل الى السوق"]
    ref = rserve.Engine(rserve.TextAnalysisWorkload(
        rserve.DictStore(rarrays), block_b=32, frontend="host"))
    ref_rids = [ref.submit(d) for d in docs]
    assert ref.run_until_drained().drained
    want = [ref.result(r).analyses() for r in ref_rids]

    inj = FaultInjector(FaultPlan(specs=(FaultSpec("dispatch", at=0),)))
    eng = Engine(TextAnalysisWorkload(_store(arrays), block_b=32,
                                      frontend="host", injector=inj))
    rids = [eng.submit(d) for d in docs]
    assert eng.run_until_drained().drained
    assert eng.workload.retries_total == 1
    assert [eng.result(r).analyses() for r in rids] == want

    # a quarantined text request refuses to hand out garbage analyses
    inj2 = FaultInjector(FaultPlan(poison_rids=frozenset({0})))
    eng2 = Engine(TextAnalysisWorkload(_store(arrays), block_b=32,
                                       frontend="host", max_retries=1,
                                       injector=inj2))
    rid = eng2.submit(docs[0])
    assert eng2.run_until_drained().drained
    req = eng2.result(rid)
    assert req.failure.code == "quarantined"
    with pytest.raises(RuntimeError, match="quarantined"):
        req.analyses()


# ---------------------------------------------------------------------------
# DictStore: two-phase publish, injected rejection, rollback
# ---------------------------------------------------------------------------
def test_publish_validation_rejects_bad_tables(dict_and_words):
    arrays, _, _ = dict_and_words
    store = _store(arrays)
    v0 = store.version

    def bad(tri):
        return tstemmer.RootDictArrays(torch.tensor(tri, dtype=torch.int32),
                                       arrays.quad, arrays.bi)

    with pytest.raises(DictValidationError, match="sorted"):
        store.publish(bad([5, 3, 1]))               # unsorted
    assert store.version == v0                      # phase 2 never ran
    with pytest.raises(DictValidationError):
        store.publish(bad([3, 3]))
    with pytest.raises(DictValidationError, match="negative"):
        store.publish(bad([-7, 3]))
    validate_handle(store.acquire().handle)         # current is valid
    assert store.publish(bad([5, 3, 1]), validate=False) == v0 + 1


def test_publish_injected_rejection_and_rollback(dict_and_words):
    arrays, _, _ = dict_and_words
    inj = FaultInjector(FaultPlan(specs=(FaultSpec("publish", at=0),)))
    store = _store(arrays, keep_history=True, injector=inj)
    v0 = store.acquire().version
    a2 = tstemmer.RootDictArrays.from_rootdict(
        tcorpus.build_dictionary(n_tri=150, n_quad=20, seed=7),
        device="cpu")
    with pytest.raises(InjectedFault):
        store.publish(a2)
    assert store.acquire().version == v0            # still serving v0
    v1 = store.publish(a2)                          # next publish lands
    assert v1 > v0
    v2 = store.rollback(v0)
    assert v2 > v1                                  # versions stay monotone
    np.testing.assert_array_equal(store.acquire().handle.arrays.tri.numpy(),
                                  store.get(v0).handle.arrays.tri.numpy())


def test_rollback_requires_history(dict_and_words):
    """keep_history=False drops the old version, its device tables with
    it: rollback and get raise, and the store holds one version."""
    arrays, _, _ = dict_and_words
    store = _store(arrays, keep_history=False)
    a2 = tstemmer.RootDictArrays.from_rootdict(
        tcorpus.build_dictionary(n_tri=150, n_quad=20, seed=7),
        device="cpu")
    store.publish(a2)
    with pytest.raises(KeyError):
        store.rollback(0)
    assert list(store._versions) == [1]


# ---------------------------------------------------------------------------
# index builder: torn checkpoints, chunk retry
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def index_setup():
    table = tcorpus.build_token_table(forms_per_root=6)
    d = rcorpus.build_dictionary(n_tri=300, n_quad=40, seed=0)
    rarrays = rstemmer.RootDictArrays.from_rootdict(d)
    arrays = _port(rarrays)

    def stream():
        return tcorpus.stream_corpus_words(9000, seed=3, chunk_words=4096,
                                           table=table)

    # the reference's fault-free index: its stemmer's ids, its host build
    vocab = rix.build_vocab(rarrays)
    parts = []
    for ch in stream():
        ids = rix.host_root_ids(ch.words, rarrays, vocab)
        parts.append(rix.IndexPartial(*rix.host_index(
            ids, ch.doc_ids.astype(np.int32), ch.positions, len(vocab))))
    return arrays, stream, rix.merge_partials(parts, vocab)


def _assert_same_index(got, want):
    for name in ("counts", "docs", "positions"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)


def test_build_under_checkpoint_and_compute_faults(index_setup, tmp_path):
    arrays, stream, ref = index_setup
    inj = FaultInjector(FaultPlan(specs=(FaultSpec("checkpoint", at=1),
                                         FaultSpec("dispatch", at=1))))
    idx = builder.build_corpus_index(stream(), arrays,
                                     checkpoint_dir=str(tmp_path),
                                     block_b=512, block_w=512,
                                     injector=inj, device="cpu")
    assert len(inj.fired) == 2
    _assert_same_index(idx, ref)
    man = json.loads((tmp_path / "manifest.json").read_text())
    assert man["schema"] == builder.MANIFEST_SCHEMA
    for rec in man["chunks"]:
        assert isinstance(rec["sha"], str) and len(rec["sha"]) == 16


def test_torn_partial_on_resume_recomputed(index_setup, tmp_path):
    arrays, stream, ref = index_setup
    ckpt = str(tmp_path / "ckpt")
    builder.build_corpus_index(itertools.islice(stream(), 2), arrays,
                               checkpoint_dir=ckpt, block_b=512,
                               block_w=512, device="cpu")
    parts = sorted(p for p in os.listdir(ckpt) if p.endswith(".npz"))
    assert len(parts) == 2
    torn = os.path.join(ckpt, parts[1])
    with open(torn, "r+b") as f:
        f.truncate(os.path.getsize(torn) // 2)
    resumed = builder.build_corpus_index(stream(), arrays,
                                         checkpoint_dir=ckpt, resume=True,
                                         block_b=512, block_w=512,
                                         device="cpu")
    _assert_same_index(resumed, ref)
    man = json.loads((tmp_path / "ckpt" / "manifest.json").read_text())
    assert man["chunks"][1]["sha"] == builder._file_sha(torn)


def test_chunk_compute_fault_exhaustion_raises(index_setup, tmp_path):
    arrays, stream, _ = index_setup
    inj = FaultInjector(FaultPlan(specs=(FaultSpec("dispatch", count=99),)))
    with pytest.raises(RuntimeError):
        builder.build_corpus_index(stream(), arrays,
                                   checkpoint_dir=str(tmp_path),
                                   block_b=512, block_w=512,
                                   injector=inj, chunk_retries=1,
                                   device="cpu")
    assert inj.events["dispatch"] == 2

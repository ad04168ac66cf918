"""The port's crash safety (repro_torch.serve.journal, Engine.recover,
DictStore snapshots), its watchdog over K3's completion flags and its
degradation ladder (repro_torch.serve.health) against the JAX package: a
counterpart of each test of tests/test_serve_recovery.py, with the same
name, on the port's plain paths (the reference's 4-device resharding
waits for ROADMAP §1 item 7), held to the reference stemmer's fault-free
output bit for bit; then the cross tests: the two engines write
byte-identical journals, the port recovers a journal the reference wrote,
each package restores the other's dictionary snapshot, and an injected
stall on the persistent path salvages and counts as the reference's."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro import serve as rserve  # noqa: E402
from repro.core import corpus as rcorpus  # noqa: E402
from repro.core import stemmer as rstemmer  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.core import corpus as tcorpus  # noqa: E402
from repro_torch.core import stemmer as tstemmer  # noqa: E402
from repro_torch.kernels import stem_fused as tsf  # noqa: E402
from repro_torch.serve import (DegradationPolicy, DictSnapshotError,  # noqa: E402
                               DictStore, Engine, EventLog, FaultInjector,
                               FaultPlan, FaultSpec, Journal, JournalError,
                               ServingMode, StemmerWorkload,
                               TextAnalysisWorkload, build_ladder,
                               payload_digest)
from repro_torch.serve import journal as journal_mod  # noqa: E402

N_REQ, WPR = 6, 32
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
    words, _, _ = rcorpus.build_corpus(n_words=N_REQ * WPR, seed=1)
    return _port(rarrays), rcorpus.encode_corpus(words), rarrays


@pytest.fixture(scope="module")
def baseline(dict_and_words):
    """The reference stemmer's fault-free roots (its jnp path)."""
    _, enc, rarrays = dict_and_words
    roots, _ = rstemmer.extract_roots(jnp.asarray(enc), rarrays,
                                      backend="sorted")
    roots = np.asarray(roots)
    return [roots[i * WPR:(i + 1) * WPR] for i in range(N_REQ)]


# ---------------------------------------------------------------------------
# the journal itself
# ---------------------------------------------------------------------------
def test_journal_roundtrip_and_unfinished(tmp_path):
    """Records round-trip, and the port's journal bytes equal the
    reference's for the same appends."""
    pay = np.arange(32, dtype=np.int32).reshape(2, 16)

    class _Req:
        rid = 0
        failure = None
        roots = np.ones((2, 4), np.int32)
        sources = np.zeros(2, np.int32)

    paths = []
    for mod in (tserve, rserve):
        jp = tmp_path / f"wal_{mod.__name__}.jsonl"
        j = mod.Journal(jp, fsync_every=2)
        j.admit(0, pay, deadline_s=1.5, dict_version=3, opts={"k": 1})
        j.admit(1, ["doc one", "doc two"])
        j.retire(_Req())
        j.close()
        paths.append(jp)
    assert paths[0].read_bytes() == paths[1].read_bytes()

    records, dropped = Journal.read(paths[0])
    assert dropped == 0 and len(records) == 3
    a0, a1, r0 = records
    assert a0["kind"] == "admit" and a0["rid"] == 0
    assert a0["deadline_s"] == 1.5 and a0["dict_version"] == 3
    assert a0["opts"] == {"k": 1}
    got = journal_mod.decode_payload(a0["payload"])
    np.testing.assert_array_equal(got, pay)
    assert payload_digest(got) == a0["digest"]
    assert journal_mod.decode_payload(a1["payload"]) == ["doc one",
                                                         "doc two"]
    assert r0["kind"] == "retire" and r0["rid"] == 0
    assert isinstance(r0["digest"], str)
    assert r0["digest"] == rserve.response_digest(_Req())
    unfinished = journal_mod.unfinished_admits(records)
    assert [r["rid"] for r in unfinished] == [1]


def test_journal_torn_tail_truncated(tmp_path):
    jp = tmp_path / "wal.jsonl"
    j = Journal(jp)
    for rid in range(4):
        j.admit(rid, [rid])
    j.close()
    good_size = os.path.getsize(jp)
    with open(jp, "ab") as f:       # a crash mid-append: half a record
        f.write(b"deadbeefdeadbeef {\"kind\": \"adm")
    records, dropped = Journal.read(jp)
    assert len(records) == 4 and dropped > 0
    assert os.path.getsize(jp) == good_size     # physically truncated
    data = open(jp, "rb").read().splitlines(keepends=True)
    data[1] = b"0" * 16 + data[1][16:]
    open(jp, "wb").write(b"".join(data))
    records, dropped = Journal.read(jp, truncate=False)
    assert [r["rid"] for r in records] == [0] and dropped > 0


def test_payload_codec_rejects_unknown(tmp_path):
    with pytest.raises(TypeError, match="encode payload"):
        journal_mod.encode_payload({"not": "supported"})
    with pytest.raises(JournalError, match="codec"):
        journal_mod.decode_payload({"t": "mystery"})
    with pytest.raises(ValueError, match="fsync_every"):
        Journal(tmp_path / "j", fsync_every=0)


def test_fault_plan_rejects_unknown_sites_at_construction():
    with pytest.raises(ValueError, match="site"):
        FaultSpec("gpu")
    with pytest.raises(TypeError, match="FaultSpec"):
        FaultPlan(specs=(FaultSpec("dispatch"), "stall"))
    with pytest.raises(TypeError, match="FaultSpec"):
        FaultPlan(specs=(42,))
    with pytest.raises(ValueError, match="retired_tiles"):
        FaultSpec("stall", retired_tiles=-1)
    assert FaultSpec("stall").kind == "wedge"
    assert FaultSpec("device_loss").kind == "lost"
    assert FaultSpec("journal").kind == "tear"


# ---------------------------------------------------------------------------
# DictStore snapshots
# ---------------------------------------------------------------------------
def test_dict_snapshot_restore_roundtrip(dict_and_words, tmp_path):
    arrays, _, _ = dict_and_words
    store = _store(arrays, keep_history=True)
    grown = tcorpus.grow_root_arrays(arrays, 2048, seed=7)
    v1 = store.publish(grown)
    sp = tmp_path / "dict.npz"
    sha = store.snapshot(sp)
    assert isinstance(sha, str) and len(sha) == 16

    r = DictStore.restore(sp, device="cpu")
    assert r.version == v1 == 1
    for v in (0, 1):
        np.testing.assert_array_equal(r.get(v).arrays.tri.numpy(),
                                      store.get(v).arrays.tri.numpy())
    v2 = r.publish(tcorpus.grow_root_arrays(arrays, 1024, seed=9))
    assert v2 == 2


def test_dict_snapshot_tamper_detected(dict_and_words, tmp_path):
    arrays, _, _ = dict_and_words
    sp = tmp_path / "dict.npz"
    _store(arrays).snapshot(sp)
    with np.load(sp) as z:
        tables = {k: np.array(z[k]) for k in z.files}
    tables["v0_tri"][0] ^= 0x5A
    np.savez(sp, **tables)
    with pytest.raises(DictSnapshotError, match="content hash"):
        DictStore.restore(sp, device="cpu")


# ---------------------------------------------------------------------------
# warm restart: kill at every tick boundary
# ---------------------------------------------------------------------------
def test_kill_at_every_tick_boundary_bit_identical(dict_and_words,
                                                   baseline, tmp_path):
    arrays, enc, _ = dict_and_words
    for k in range(6):
        jp = tmp_path / f"wal_{k}.jsonl"
        eng = Engine(StemmerWorkload(_store(arrays), block_b=32,
                                     max_inflight=2),
                     journal=Journal(jp, fsync_every=1))
        rids = [eng.submit(enc[i * WPR:(i + 1) * WPR])
                for i in range(N_REQ)]
        for _ in range(k):
            eng.step()
        done_before = {r: eng.result(r) for r in rids
                       if eng.result(r) is not None}
        # the process dies here: no close(), no sync
        eng2 = Engine.recover(jp, StemmerWorkload(_store(arrays),
                                                  block_b=32,
                                                  max_inflight=2))
        assert eng2.run_until_drained().drained
        assert sorted(eng2.recovery.replayed) == [
            r for r in rids if r not in done_before]
        for i, r in enumerate(rids):
            req = done_before.get(r) or eng2.result(r)
            assert req is not None and req.failure is None, (k, r)
            np.testing.assert_array_equal(req.roots, baseline[i],
                                          err_msg=f"kill at tick {k},"
                                                  f" rid {r}")
        eng3 = Engine.recover(jp, StemmerWorkload(_store(arrays),
                                                  block_b=32))
        assert eng3.recovery.replayed == []
        assert eng3._next_rid == N_REQ


def test_recovery_repins_admit_version_across_publish(dict_and_words,
                                                      baseline, tmp_path):
    arrays, enc, _ = dict_and_words
    jp, sp = tmp_path / "wal.jsonl", tmp_path / "dict.npz"
    store = _store(arrays, keep_history=True)
    store.snapshot(sp)
    eng = Engine(StemmerWorkload(store, block_b=32),
                 journal=Journal(jp, fsync_every=1))
    rids = [eng.submit(enc[i * WPR:(i + 1) * WPR]) for i in range(2)]
    store2 = DictStore.restore(sp, device="cpu")
    grown = tcorpus.grow_root_arrays(arrays, 2048, seed=7)
    v1 = store2.publish(grown)
    eng2 = Engine.recover(jp, StemmerWorkload(store2, block_b=32))
    fresh = eng2.submit(enc[2 * WPR:3 * WPR])
    assert eng2.run_until_drained().drained
    for i, r in enumerate(rids):
        req = eng2.result(r)
        assert (req.dict_versions == 0).all()       # pinned at admit
        np.testing.assert_array_equal(req.roots, baseline[i])
    req = eng2.result(fresh)
    assert (req.dict_versions == v1).all()          # current lexicon
    want_r, _ = rstemmer.extract_roots(
        jnp.asarray(req.words), rstemmer.RootDictArrays(
            *(jnp.asarray(t.numpy()) for t in (grown.tri, grown.quad,
                                               grown.bi))),
        backend="sorted")
    np.testing.assert_array_equal(req.roots, np.asarray(want_r))


def test_recovery_rejects_tampered_payload(dict_and_words, tmp_path):
    arrays, enc, _ = dict_and_words
    jp = tmp_path / "wal.jsonl"
    eng = Engine(StemmerWorkload(_store(arrays), block_b=32),
                 journal=Journal(jp, fsync_every=1))
    eng.submit(enc[:WPR])
    eng.journal.close()
    records, _ = Journal.read(jp)
    records[0]["digest"] = "0" * 16     # payload no longer matches
    j2 = Journal(tmp_path / "wal2.jsonl")
    j2._append(records[0])
    j2.close()
    with pytest.raises(JournalError, match="digest"):
        Engine.recover(tmp_path / "wal2.jsonl",
                       StemmerWorkload(_store(arrays), block_b=32))


def test_text_requests_replay_from_raw_documents(dict_and_words, tmp_path):
    arrays, _, rarrays = dict_and_words
    docs = ["كتب الولد درسا", "ذهب الرجل الى السوق"]
    ref = rserve.Engine(rserve.TextAnalysisWorkload(
        rserve.DictStore(rarrays), block_b=32, frontend="host"))
    ref_rids = [ref.submit([d]) for d in docs]
    assert ref.run_until_drained().drained
    want = [ref.result(r).analyses() for r in ref_rids]

    jp = tmp_path / "wal.jsonl"
    eng = Engine(TextAnalysisWorkload(_store(arrays), block_b=32,
                                      frontend="host"),
                 journal=Journal(jp, fsync_every=1))
    rids = [eng.submit([d]) for d in docs]
    eng2 = Engine.recover(jp, TextAnalysisWorkload(_store(arrays),
                                                   block_b=32,
                                                   frontend="host"))
    assert eng2.run_until_drained().drained
    assert [eng2.result(r).analyses() for r in rids] == want


# ---------------------------------------------------------------------------
# the stall watchdog
# ---------------------------------------------------------------------------
def test_watchdog_requires_persistent(dict_and_words):
    arrays, _, _ = dict_and_words
    with pytest.raises(ValueError, match="persistent"):
        StemmerWorkload(_store(arrays), watchdog_s=0.1)
    with pytest.raises(ValueError, match="watchdog_s"):
        StemmerWorkload(_store(arrays), persistent=True, watchdog_s=0)


@pytest.mark.parametrize("retired_tiles", [0, 2])
def test_watchdog_abandons_wedged_launch(dict_and_words, baseline,
                                         retired_tiles):
    arrays, enc, _ = dict_and_words
    inj = FaultInjector(FaultPlan(
        specs=(FaultSpec("stall", at=0, retired_tiles=retired_tiles),)))
    w = StemmerWorkload(_store(arrays), block_b=32, max_inflight=1,
                        persistent=True, megabatch_tiles=4,
                        watchdog_s=0.05, max_retries=0, injector=inj)
    eng = Engine(w)
    rids = [eng.submit(enc[i * WPR:(i + 1) * WPR]) for i in range(N_REQ)]
    assert eng.run_until_drained().drained
    assert w.watchdog_stalls == 1 and w.retries_total == 0
    ev, = [e for e in eng.events() if e.kind == "watchdog_stall"]
    assert ev.data["salvaged_words"] == retired_tiles * 32
    assert ev.data["redispatched_words"] > 0
    for i, r in enumerate(rids):
        req = eng.result(r)
        assert req.failure is None
        np.testing.assert_array_equal(req.roots, baseline[i])


# ---------------------------------------------------------------------------
# the degradation ladder
# ---------------------------------------------------------------------------
def test_build_ladder_rungs():
    rungs = build_ladder(persistent=True, megabatch_tiles=4,
                         data_devices=4, resident_dict=True)
    labels = [r.label for r in rungs]
    assert labels == ["persistent", "megabatch x4", "per-tile",
                      "streamed-dict", "devices-2", "devices-1"]
    assert labels == [r.label for r in rserve.build_ladder(
        persistent=True, megabatch_tiles=4, data_devices=4,
        resident_dict=True)]
    assert rungs[0].persistent and not rungs[1].persistent
    assert rungs[-1].data_devices == 1
    assert [r.label for r in build_ladder(resident_dict=False)] == [
        "per-tile"]
    # one device: no device rungs
    assert [r.label for r in build_ladder(
        persistent=True, megabatch_tiles=16)] == [
        "persistent", "megabatch x16", "per-tile", "streamed-dict"]


class _FakeWorkload:
    def __init__(self, data_devices=1):
        self.persistent = True
        self.megabatch_tiles = 2
        self.data_devices = data_devices
        self.retries_total = 0
        self.checksum_failures = 0
        self.timeouts = 0
        self.watchdog_stalls = 0
        self.device_losses = 0
        self.modes: list[ServingMode] = []

    def request_mode(self, mode):
        self.modes.append(mode)


class _FakeEngine:
    def __init__(self):
        self.queue = []


def _policy(w, **kw):
    p = DegradationPolicy(rungs=build_ladder(
        persistent=w.persistent, megabatch_tiles=w.megabatch_tiles,
        data_devices=w.data_devices, resident_dict=False), **kw)
    p.attach(w, EventLog())
    return p


def test_policy_hysteresis_down_and_up():
    w, eng = _FakeWorkload(), _FakeEngine()
    p = _policy(w, down_after=2, up_after=3)
    w.retries_total += 1
    p.observe(eng)
    assert p.mode.label == "persistent" and not w.modes
    w.retries_total += 1
    p.observe(eng)
    assert p.mode.label == "megabatch x2"
    assert w.modes[-1].label == "megabatch x2"
    for _ in range(2):
        p.observe(eng)
    assert p.mode.label == "megabatch x2"
    p.observe(eng)
    assert p.mode.label == "persistent"
    assert [t[2] for t in p.transitions] == ["faults", "healthy"]
    w.checksum_failures += 1
    p.observe(eng)
    assert p._healthy == 0


def test_policy_queue_pressure_downshifts():
    w, eng = _FakeWorkload(), _FakeEngine()
    p = _policy(w, queue_high=4, down_after=2)
    eng.queue = list(range(5))
    p.observe(eng)
    p.observe(eng)
    assert p.mode.label == "megabatch x2"
    assert p.transitions[-1][2] == "queue"


def test_policy_device_loss_downshifts_and_caps():
    w, eng = _FakeWorkload(data_devices=4), _FakeEngine()
    p = _policy(w, down_after=2, up_after=1)
    assert [r.label for r in p.rungs] == [
        "persistent", "megabatch x2", "per-tile", "devices-2", "devices-1"]
    w.device_losses += 1
    p.observe(eng)
    assert p.mode.label == "devices-2"
    assert p.transitions[-1][2] == "device_loss"
    for _ in range(8):
        p.observe(eng)
    assert p.mode.data_devices <= 2
    w.device_losses += 1
    p.observe(eng)
    assert p.mode.label == "devices-1"


def test_policy_validation():
    with pytest.raises(ValueError, match="queue_high"):
        DegradationPolicy(queue_high=0)
    with pytest.raises(ValueError, match="down_after"):
        DegradationPolicy(down_after=0)
    with pytest.raises(ValueError, match="request_mode"):
        DegradationPolicy().attach(object(), EventLog())


def test_ladder_transition_serves_bit_identical(dict_and_words, baseline):
    """A mid-stream downshift (persistent -> megabatch -> per-tile ->
    streamed-dict) re-chunks waiting work to the new launch width and
    keeps every result bit-identical; the launches show the resident and
    the streamed paths both served."""
    arrays, enc, _ = dict_and_words
    inj = FaultInjector(FaultPlan(specs=(FaultSpec("stall", count=3),)))
    w = StemmerWorkload(_store(arrays), block_b=32, max_inflight=1,
                        persistent=True, megabatch_tiles=2,
                        watchdog_s=0.02, injector=inj)
    pol = DegradationPolicy(down_after=1, up_after=100)
    eng = Engine(w, policy=pol)
    rids = [eng.submit(enc[i * WPR:(i + 1) * WPR]) for i in range(N_REQ)]
    assert eng.run_until_drained().drained
    assert pol.transitions and pol.transitions[0][0] == "persistent"
    assert not w.persistent
    kinds = {e.kind for e in eng.events()}
    assert "degrade" in kinds and "watchdog_stall" in kinds
    for i, r in enumerate(rids):
        req = eng.result(r)
        assert req.failure is None
        np.testing.assert_array_equal(req.roots, baseline[i])


# ---------------------------------------------------------------------------
# the structured event stream
# ---------------------------------------------------------------------------
def test_events_surface_failures_and_recovery(dict_and_words, tmp_path):
    arrays, enc, _ = dict_and_words
    eng = Engine(StemmerWorkload(_store(arrays), block_b=32),
                 queue_cap=1, on_full="shed",
                 journal=Journal(tmp_path / "wal.jsonl", fsync_every=1))
    eng.submit(enc[:WPR])
    eng.submit(enc[:WPR])                # shed: terminal, never journaled
    fails = [e for e in eng.events() if e.kind == "failure"]
    assert len(fails) == 1 and fails[0].data["code"] == "shed"
    assert eng.run_until_drained().drained
    eng2 = Engine.recover(tmp_path / "wal.jsonl",
                          StemmerWorkload(_store(arrays), block_b=32))
    rec, = [e for e in eng2.events() if e.kind == "recovered"]
    assert rec.data["replayed"] == 0 and rec.data["already_retired"] == 2
    assert eng2.events(drain=True) and not eng2.events()


# ---------------------------------------------------------------------------
# launcher flag cross-validation (before any engine is constructed)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("argv", [
    ["--workload", "stemmer", "--watchdog-ms", "50"],        # no --persistent
    ["--workload", "lm", "--watchdog-ms", "50"],
    ["--workload", "lm", "--degrade", "on"],
    ["--workload", "stemmer", "--watchdog-ms", "-1", "--persistent"],
])
def test_serve_launcher_rejects_bad_flag_combos(argv):
    from repro_torch.launch import serve as serve_mod

    with pytest.raises(SystemExit) as exc:
        serve_mod.main(argv + ["--device", "cpu"])
    assert exc.value.code == 2          # argparse .error(), pre-engine


# ---------------------------------------------------------------------------
# against the reference package
# ---------------------------------------------------------------------------
def _journaled(mod, store, enc, jp, steps=None):
    eng = mod.Engine(mod.StemmerWorkload(store, block_b=32, max_inflight=1),
                     journal=mod.Journal(jp, fsync_every=1))
    rids = [eng.submit(enc[i * WPR:(i + 1) * WPR]) for i in range(N_REQ)]
    if steps is None:
        assert eng.run_until_drained().drained
    else:
        for _ in range(steps):
            eng.step()
    return eng, rids


def test_journals_byte_identical_across_packages(dict_and_words, tmp_path):
    """The same submissions to both engines at max_inflight=1 write the
    same journal, byte for byte: admits, retires and their digests."""
    arrays, enc, rarrays = dict_and_words
    jt, jr = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    _journaled(tserve, _store(arrays), enc, jt)[0].journal.close()
    _journaled(rserve, rserve.DictStore(rarrays), enc, jr)[0].journal.close()
    assert jt.read_bytes() == jr.read_bytes()
    records, _ = Journal.read(jt)
    assert [r["kind"] for r in records].count("retire") == N_REQ


def test_reference_journal_recovered_by_port(dict_and_words, baseline,
                                             tmp_path):
    """A journal the reference engine wrote before dying after two ticks,
    with a torn tail, recovers in the port: the combined outputs equal
    the uninterrupted run."""
    arrays, enc, rarrays = dict_and_words
    jp = tmp_path / "wal.jsonl"
    eng, rids = _journaled(rserve, rserve.DictStore(rarrays), enc, jp,
                           steps=2)
    done_before = {r: eng.result(r) for r in rids
                   if eng.result(r) is not None}
    assert 0 < len(done_before) < N_REQ
    with open(jp, "ab") as f:
        f.write(b"0123456789abcdef {\"kind\":\"ret")
    eng2 = Engine.recover(jp, StemmerWorkload(_store(arrays), block_b=32))
    assert eng2.recovery.dropped_bytes > 0
    assert eng2.run_until_drained().drained
    assert sorted(eng2.recovery.replayed) == [
        r for r in rids if r not in done_before]
    for i, r in enumerate(rids):
        req = done_before.get(r) or eng2.result(r)
        assert req.failure is None
        np.testing.assert_array_equal(np.asarray(req.roots), baseline[i])


def test_dict_snapshot_restores_across_packages(dict_and_words, tmp_path):
    """Each package restores the other's snapshot: equal tables, the same
    versions and counters, and the same catalog hash."""
    arrays, _, rarrays = dict_and_words
    grown = tcorpus.grow_root_arrays(arrays, 2048, seed=7)
    r_grown = rstemmer.RootDictArrays(
        *(jnp.asarray(t.numpy()) for t in (grown.tri, grown.quad, grown.bi)))
    tstore = _store(arrays, keep_history=True)
    rstore = rserve.DictStore(rarrays, keep_history=True)
    for s, a in ((tstore, grown), (rstore, r_grown)):
        s.publish(a)
        s.rollback(0)
    tp, rp = tmp_path / "port.npz", tmp_path / "ref.npz"
    assert tstore.snapshot(tp) == rstore.snapshot(rp)
    in_ref = rserve.DictStore.restore(tp)
    in_port = DictStore.restore(rp, device="cpu")
    for got in (in_ref, in_port):
        assert got.version == 2
        for v in (0, 1, 2):
            for name in ("tri", "quad", "bi"):
                want = getattr(tstore.get(v).arrays, name).numpy()
                np.testing.assert_array_equal(
                    np.asarray(getattr(got.get(v).arrays, name)
                               if got is in_ref
                               else getattr(got.get(v).arrays, name).numpy()),
                    want)
    assert in_port.publish(grown) == in_ref.publish(r_grown) == 3


def test_reference_engine_stall_on_persistent_path(dict_and_words):
    """An injected stall after 2 retired descriptors, on both engines'
    persistent paths under the same plan: the same salvaged and
    re-dispatched words, counters, event kinds and outputs."""
    arrays, enc, rarrays = dict_and_words
    runs = []
    for mod, store in ((rserve, rserve.DictStore(rarrays)),
                       (tserve, _store(arrays))):
        inj = mod.FaultInjector(mod.FaultPlan(
            specs=(mod.FaultSpec("stall", at=0, retired_tiles=2),)))
        eng = mod.Engine(mod.StemmerWorkload(
            store, block_b=64, max_inflight=1, persistent=True,
            megabatch_tiles=4, watchdog_s=0.05, injector=inj))
        rids = [eng.submit(enc[i * WPR:(i + 1) * WPR]) for i in range(6)]
        assert eng.run_until_drained().drained
        runs.append((eng, rids))
    (r_eng, r_rids), (t_eng, t_rids) = runs
    for name in COUNTERS:
        assert getattr(t_eng.workload, name) == \
            getattr(r_eng.workload, name), name
    assert [e.kind for e in t_eng.events()] == \
        [e.kind for e in r_eng.events()]
    (t_ev,) = [e for e in t_eng.events() if e.kind == "watchdog_stall"]
    (r_ev,) = [e for e in r_eng.events() if e.kind == "watchdog_stall"]
    assert t_ev.data == r_ev.data
    assert t_ev.data["salvaged_words"] == 2 * 64
    for rr, tr in zip(r_rids, t_rids):
        np.testing.assert_array_equal(t_eng.result(tr).roots,
                                      np.asarray(r_eng.result(rr).roots))
        np.testing.assert_array_equal(t_eng.result(tr).sources,
                                      np.asarray(r_eng.result(rr).sources))


@pytest.mark.cuda
def test_mapped_flags_on_card(dict_and_words):
    """K3 (both variants) writes its flags into host-mapped memory equal
    to the plain version's device flags, read on the host with no copy;
    a slice is a view; a plain tensor is refused as flags_out."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    arrays, enc, _ = dict_and_words
    a = arrays.to("cuda")
    w = torch.from_numpy(np.concatenate([enc] * 8)).cuda()  # 1536 words
    flags = tsf.MappedFlags(128, "cuda")
    for block_b in (16, 64, 256):
        bt = -(-w.shape[0] // block_b)
        for residency in ("resident", "streamed"):
            out = tsf.stem_fused(w, a, block_b=block_b, persistent=True,
                                 version_slot=6, residency=residency,
                                 flags_out=flags[:bt])
            torch.cuda.synchronize()
            want = tsf.stem_fused(w, a, block_b=block_b, persistent=True,
                                  version_slot=6, residency=residency)
            assert out[2].device.type == "cpu"
            assert out[2].data_ptr() == flags.host.data_ptr()
            assert (flags.host[:bt] == 7).all()
            assert torch.equal(out[2], want[2].cpu())
            assert torch.equal(out[0], want[0])
    with pytest.raises(ValueError, match="host-mapped"):
        tsf.stem_fused(w, a, block_b=64, persistent=True,
                       flags_out=torch.zeros(24, dtype=torch.int32))

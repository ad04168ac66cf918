"""The seeded chaos matrix (the scenarios of examples/chaos_matrix.py) on
the port: one case per fault-injection site, plus the poison-pill
quarantine, each asserting the recovery invariant: a run that absorbs the
fault returns the reference stemmer's fault-free roots and sources (its
jnp path) bit for bit, or the right FailureInfo, with no state leaked into
the engine, the store or the checkpoint directory. The device_loss case
is the reference's scenario: data_devices=4 on a mesh of 4 CPU entries,
the first sharded launch loses a device, and the degradation ladder
reshards onto fewer devices."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro import index as rix  # noqa: E402
from repro.core import corpus as rcorpus  # noqa: E402
from repro.core import stemmer as rstemmer  # noqa: E402
from repro_torch.core import corpus as tcorpus  # noqa: E402
from repro_torch.core import stemmer as tstemmer  # noqa: E402
from repro_torch.index import builder  # noqa: E402
from repro_torch.launch.mesh import make_data_mesh  # noqa: E402
from repro_torch.serve import (DegradationPolicy, DictStore, Engine,  # noqa: E402
                               FaultInjector, FaultPlan, FaultSpec,
                               InjectedFault, Journal, StemmerWorkload)
from repro_torch.serve.faults import SITES  # noqa: E402

N_REQ = 8
WORDS_PER_REQ = 32
SEED = 20260809


@pytest.fixture(scope="module")
def inputs():
    d = rcorpus.build_dictionary(n_tri=400, n_quad=60, seed=0)
    rarrays = rstemmer.RootDictArrays.from_rootdict(d)
    arrays = tstemmer.RootDictArrays.from_numpy(
        np.asarray(rarrays.tri), np.asarray(rarrays.quad),
        np.asarray(rarrays.bi), device="cpu")
    words, _, _ = rcorpus.build_corpus(n_words=N_REQ * WORDS_PER_REQ, seed=1)
    enc = rcorpus.encode_corpus(words)
    roots, sources = rstemmer.extract_roots(jnp.asarray(enc), rarrays,
                                            backend="sorted")
    return arrays, rarrays, enc, np.asarray(roots), np.asarray(sources)


def _store(arrays, **kw):
    return DictStore(arrays, device="cpu", **kw)


def _submit(eng, enc, n=N_REQ):
    return [eng.submit(enc[i * WORDS_PER_REQ:(i + 1) * WORDS_PER_REQ])
            for i in range(n)]


def _drain(arrays, enc, *, injector=None, policy=None, **kw):
    eng = Engine(StemmerWorkload(_store(arrays), block_b=32, max_inflight=2,
                                 injector=injector, **kw), policy=policy)
    rids = _submit(eng, enc)
    assert eng.run_until_drained().drained
    return eng, rids


def _check_identical(results, want_r, want_s, skip=()):
    for i, req in enumerate(results):
        if i in skip:
            continue
        assert req is not None and req.failure is None, f"req {i}"
        sl = slice(i * WORDS_PER_REQ, (i + 1) * WORDS_PER_REQ)
        np.testing.assert_array_equal(req.roots, want_r[sl])
        np.testing.assert_array_equal(req.sources, want_s[sl])


def _plan(*specs, **kw):
    return FaultInjector(FaultPlan(specs=specs, seed=SEED, **kw))


def _dispatch(inputs, tmp_path):
    arrays, _, enc, want_r, want_s = inputs
    inj = _plan(FaultSpec("dispatch", at=1))
    eng, rids = _drain(arrays, enc, injector=inj)
    assert inj.fired == [("dispatch", "fail", 1)]
    assert eng.workload.retries_total == 1
    _check_identical([eng.result(r) for r in rids], want_r, want_s)


def _retire(inputs, tmp_path):
    arrays, _, enc, want_r, want_s = inputs
    inj = _plan(FaultSpec("retire", at=0))
    eng, rids = _drain(arrays, enc, injector=inj)
    assert eng.workload.checksum_failures == 1
    _check_identical([eng.result(r) for r in rids], want_r, want_s)


def _publish(inputs, tmp_path):
    arrays, _, _, _, _ = inputs
    inj = _plan(FaultSpec("publish", at=0))
    store = _store(arrays, keep_history=True, injector=inj)
    v0 = store.version
    grown = tcorpus.grow_root_arrays(arrays, 2048, seed=7)
    with pytest.raises(InjectedFault):
        store.publish(grown)
    assert store.version == v0          # phase 2 never ran
    v1 = store.publish(grown)           # the next publish lands
    v2 = store.rollback(v0)             # the old lexicon as a NEW version
    assert v2 > v1 > v0
    np.testing.assert_array_equal(store.acquire().handle.arrays.tri.numpy(),
                                  store.get(v0).handle.arrays.tri.numpy())


def _checkpoint(inputs, tmp_path):
    arrays, rarrays, _, _, _ = inputs
    table = tcorpus.build_token_table(forms_per_root=6)

    def stream():
        return tcorpus.stream_corpus_words(9000, seed=3, chunk_words=4096,
                                           table=table)

    vocab = rix.build_vocab(rarrays)
    parts = []
    for ch in stream():
        ids = rix.host_root_ids(ch.words, rarrays, vocab)
        parts.append(rix.IndexPartial(*rix.host_index(
            ids, ch.doc_ids.astype(np.int32), ch.positions, len(vocab))))
    ref = rix.merge_partials(parts, vocab)
    inj = _plan(FaultSpec("checkpoint", at=1))
    idx = builder.build_corpus_index(stream(), arrays,
                                     checkpoint_dir=str(tmp_path),
                                     block_b=512, block_w=512, injector=inj,
                                     device="cpu")
    assert inj.fired == [("checkpoint", "tear", 1)]
    for name in ("counts", "docs", "positions"):
        np.testing.assert_array_equal(getattr(idx, name), getattr(ref, name))
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


def _poison(inputs, tmp_path):
    arrays, _, enc, want_r, want_s = inputs
    inj = _plan(poison_rids=frozenset({2}))
    eng = Engine(StemmerWorkload(_store(arrays), block_b=128,
                                 max_inflight=1, max_retries=1,
                                 injector=inj))
    rids = _submit(eng, enc, 4)
    assert eng.run_until_drained().drained
    assert eng.workload.quarantined == 1
    bad = eng.result(rids[2])
    assert bad.failure is not None and bad.failure.code == "quarantined"
    _check_identical([eng.result(r) for r in rids], want_r, want_s,
                     skip=(2,))
    with pytest.raises(ValueError):
        FaultSpec("gpu")                # rejected at plan construction


def _stall(inputs, tmp_path):
    arrays, _, enc, want_r, want_s = inputs
    inj = _plan(FaultSpec("stall", at=0, retired_tiles=2))
    eng = Engine(StemmerWorkload(_store(arrays), block_b=32, max_inflight=1,
                                 persistent=True, megabatch_tiles=4,
                                 watchdog_s=0.05, injector=inj))
    rids = _submit(eng, enc)
    assert eng.run_until_drained().drained
    assert eng.workload.watchdog_stalls == 1
    stalls = [e for e in eng.events() if e.kind == "watchdog_stall"]
    assert len(stalls) == 1 and stalls[0].data["salvaged_words"] == 64
    _check_identical([eng.result(r) for r in rids], want_r, want_s)


def _device_loss(inputs, tmp_path):
    arrays, _, enc, want_r, want_s = inputs
    inj = _plan(FaultSpec("device_loss", at=0))
    pol = DegradationPolicy(down_after=1)
    eng, rids = _drain(arrays, enc, injector=inj, policy=pol,
                       data_devices=4, mesh=make_data_mesh(4, device="cpu"))
    assert inj.fired == [("device_loss", "lost", 0)]
    assert eng.workload.device_losses == 1
    assert any(t[2] == "device_loss" and t[1].startswith("devices-")
               for t in pol.transitions), pol.transitions
    eng.step()                # a requested mode lands at an empty-ring tick
    assert eng.workload.data_devices < 4
    _check_identical([eng.result(r) for r in rids], want_r, want_s)


def _journal(inputs, tmp_path):
    arrays, _, enc, want_r, want_s = inputs
    jp = str(tmp_path / "wal.jsonl")
    # tear the 9th append (the first retire; events 0..7 are the admits),
    # so one served request must be served again on replay
    inj = _plan(FaultSpec("journal", at=N_REQ))
    eng = Engine(StemmerWorkload(_store(arrays), block_b=32, max_inflight=2),
                 journal=Journal(jp, fsync_every=1, injector=inj))
    rids = _submit(eng, enc)
    for _ in range(2):
        eng.step()                      # serve a little, then "crash"
    done_before = {r: eng.result(r) for r in rids
                   if eng.result(r) is not None}
    eng2 = Engine.recover(jp, StemmerWorkload(_store(arrays), block_b=32,
                                              max_inflight=2))
    assert eng2.recovery.dropped_bytes > 0     # the tear was truncated
    assert eng2.run_until_drained().drained
    _check_identical([done_before.get(r) or eng2.result(r) for r in rids],
                     want_r, want_s)


SCENARIOS = {"dispatch": _dispatch, "retire": _retire, "publish": _publish,
             "checkpoint": _checkpoint, "stall": _stall,
             "device_loss": _device_loss, "journal": _journal,
             "poison": _poison}


def test_matrix_covers_every_site():
    assert set(SCENARIOS) == set(SITES) | {"poison"}


@pytest.mark.parametrize("site", sorted(SCENARIOS))
def test_chaos_scenario(site, inputs, tmp_path):
    SCENARIOS[site](inputs, tmp_path)

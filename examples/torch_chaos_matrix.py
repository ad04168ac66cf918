"""Chaos smoke: every fault-injection site fired once, recovery checked.

The PyTorch counterpart of ``examples/chaos_matrix.py``, with its
scenarios, sizes, seeds and lines. One scenario per injector site, each
asserting the recovery invariant: a run that absorbs the fault gives
results bit-identical to the fault-free run (or, for terminal faults,
the right structured FailureInfo), with no state leaked into the serving
engine, the dictionary store or the index checkpoint directory.

  dispatch    injected launch failure mid-ring -> retried, bit-identical
  retire      corrupted device readback -> checksum catch, redispatch,
              bit-identical
  publish     injected rejection between validation and the version
              bump -> store untouched, next publish lands, rollback
              restores the old lexicon as a new version
  checkpoint  torn index-partial write -> readback verify + rewrite,
              index bit-identical; plus a poison-pill request isolated
              by bisection quarantine while its tile-mates complete
  stall       wedged persistent descriptor ring (K3 on a card) ->
              watchdog abandons the launch, salvages the retired-prefix
              tiles, re-dispatches the rest down the megabatch path,
              bit-identical
  device_loss sharded launch loses a device -> the degradation ladder
              reshards onto fewer data devices (capped: the device does
              not come back), bit-identical
  journal     torn write-ahead-journal tail -> Engine.recover truncates
              to the last good record and replays the unfinished
              requests bit-identically (warm restart)

The device_loss scenario serves on a mesh of 4 entries: 4 CPU entries
with ``--device cpu``; on a card, 4 GPUs where there are 4, else the
chosen GPU repeated 4 times (``Mesh.of``: the shards run one after
another on its stream). The script exits non-zero on any mismatch.

  PYTHONPATH=src python examples/torch_chaos_matrix.py [--device cuda:0]
  PYTHONPATH=src python examples/torch_chaos_matrix.py --device cpu
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.core import corpus, stemmer
from repro_torch.index import builder
from repro_torch.launch.mesh import Mesh, make_data_mesh
from repro_torch.serve import (DegradationPolicy, DictStore, Engine,
                               FaultInjector, FaultPlan, FaultSpec,
                               InjectedFault, Journal, StemmerWorkload)

N_REQ = 8
WORDS_PER_REQ = 32
SEED = 20260809
DATA_DEVICES = 4


def check(ok, what):
    if not ok:
        raise SystemExit(f"chaos_matrix: {what}")


def build_inputs(dev):
    d = corpus.build_dictionary(n_tri=400, n_quad=60, seed=0)
    arrays = stemmer.RootDictArrays.from_rootdict(d, device=dev)
    words, _, _ = corpus.build_corpus(n_words=N_REQ * WORDS_PER_REQ, seed=1)
    return arrays, corpus.encode_corpus(words)


def data_mesh(dev):
    """-> (a mesh of DATA_DEVICES entries on dev's kind, what it is)."""
    if dev.type == "cpu":
        return make_data_mesh(DATA_DEVICES, device="cpu"), "4 CPU entries"
    if torch.cuda.device_count() >= DATA_DEVICES:
        return make_data_mesh(DATA_DEVICES), "4 GPUs"
    return (Mesh.of([dev] * DATA_DEVICES),
            f"{dev} repeated 4 times (Mesh.of; one GPU: the shards run one"
            " after another on its stream)")


def main(argv=None):
    """-> the OK lines printed, one a scenario."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda:0",
                    help="where the engines serve (cuda:N or cpu)")
    args = ap.parse_args(argv)
    dev = devmod.resolve(args.device)
    ok = []

    def passed(line):
        print(line, flush=True)
        ok.append(line)

    def store(arrays, **kw):
        return DictStore(arrays, device=dev, **kw)

    def submit(eng, enc, n=N_REQ):
        return [eng.submit(enc[i * WORDS_PER_REQ:(i + 1) * WORDS_PER_REQ])
                for i in range(n)]

    def drain(arrays, enc, *, injector=None, policy=None, **kw):
        eng = Engine(StemmerWorkload(store(arrays), block_b=32,
                                     max_inflight=2, injector=injector,
                                     **kw), policy=policy)
        rids = submit(eng, enc)
        check(eng.run_until_drained().drained, "a drain did not finish")
        return eng, rids

    def check_identical(eng, rids, baseline, skip=()):
        for i, rid in enumerate(rids):
            req = eng.result(rid)
            if i in skip:
                continue
            check(req.failure is None, f"req {rid}: {req.failure}")
            check(np.array_equal(req.roots, baseline[i]),
                  f"req {rid}: roots differ from the fault-free run")
            check(np.array_equal(req.sources, baseline[i + N_REQ]),
                  f"req {rid}: sources differ from the fault-free run")

    arrays, enc = build_inputs(dev)
    eng0, rids0 = drain(arrays, enc)
    baseline = ([np.array(eng0.result(r).roots) for r in rids0]
                + [np.array(eng0.result(r).sources) for r in rids0])

    # --- site dispatch: launch failure retried ------------------------
    inj = FaultInjector(FaultPlan(specs=(FaultSpec("dispatch", at=1),),
                                  seed=SEED))
    eng, rids = drain(arrays, enc, injector=inj)
    check(inj.fired == [("dispatch", "fail", 1)], f"fired {inj.fired}")
    check(eng.workload.retries_total == 1, "retries_total")
    check_identical(eng, rids, baseline)
    passed("CHAOS_DISPATCH_OK")

    # --- site retire: corrupted readback caught by checksum -----------
    inj = FaultInjector(FaultPlan(specs=(FaultSpec("retire", at=0),),
                                  seed=SEED))
    eng, rids = drain(arrays, enc, injector=inj)
    check(eng.workload.checksum_failures == 1, "checksum_failures")
    check_identical(eng, rids, baseline)
    passed("CHAOS_RETIRE_OK")

    # --- site publish: two-phase publish rejected, then rollback ------
    inj = FaultInjector(FaultPlan(specs=(FaultSpec("publish", at=0),),
                                  seed=SEED))
    st = store(arrays, keep_history=True, injector=inj)
    v0 = st.version
    grown = corpus.grow_root_arrays(arrays, 2048, seed=7)
    try:
        st.publish(grown)
        check(False, "injected publish rejection did not fire")
    except InjectedFault:
        pass
    check(st.version == v0, "a rejected publish bumped the version")
    v1 = st.publish(grown)              # next publish lands cleanly
    v2 = st.rollback(v0)                # restore as a NEW version
    check(v2 > v1 > v0, f"versions {v0}, {v1}, {v2}")
    check(torch.equal(st.acquire().handle.arrays.tri.cpu(),
                      st.get(v0).handle.arrays.tri.cpu()),
          "the rollback did not restore the old lexicon")
    passed("CHAOS_PUBLISH_OK")

    # --- site checkpoint: torn partial rewritten, index identical -----
    table = corpus.build_token_table(forms_per_root=6)

    def stream():
        return corpus.stream_corpus_words(9000, seed=3, chunk_words=4096,
                                          table=table)

    ref = builder.build_corpus_index(stream(), arrays, block_b=512,
                                     block_w=512, device=dev)
    inj = FaultInjector(FaultPlan(specs=(FaultSpec("checkpoint", at=1),),
                                  seed=SEED))
    with tempfile.TemporaryDirectory() as td:
        idx = builder.build_corpus_index(stream(), arrays,
                                         checkpoint_dir=td, block_b=512,
                                         block_w=512, injector=inj,
                                         device=dev)
        check(not [p for p in os.listdir(td) if p.endswith(".tmp")],
              "a torn partial was left in the checkpoint directory")
    check(inj.fired == [("checkpoint", "tear", 1)], f"fired {inj.fired}")
    for name in ("counts", "docs", "positions"):
        check(np.array_equal(getattr(idx, name), getattr(ref, name)),
              f"the index's {name} differ from the fault-free build")
    passed("CHAOS_CHECKPOINT_OK")

    # --- poison pill: bisection quarantine, tile-mates complete -------
    inj = FaultInjector(FaultPlan(poison_rids=frozenset({2}), seed=SEED))
    eng = Engine(StemmerWorkload(store(arrays), block_b=128,
                                 max_inflight=1, max_retries=1,
                                 injector=inj))
    rids = submit(eng, enc, 4)
    check(eng.run_until_drained().drained, "the poison drain")
    check(eng.workload.quarantined == 1, "quarantined")
    bad = eng.result(rids[2])
    check(bad.failure is not None and bad.failure.code == "quarantined",
          f"the poison request's failure {bad.failure}")
    for i in (0, 1, 3):
        req = eng.result(rids[i])
        check(req.failure is None, f"req {rids[i]}: {req.failure}")
        check(np.array_equal(req.roots, baseline[i]),
              f"req {rids[i]}: roots differ")
    passed("CHAOS_QUARANTINE_OK")

    # unknown sites are rejected at PLAN construction, not at fire time
    try:
        FaultSpec("gpu")
        check(False, "unknown fault site accepted")
    except ValueError:
        pass

    # --- site stall: wedged persistent ring, watchdog salvage ---------
    inj = FaultInjector(FaultPlan(
        specs=(FaultSpec("stall", at=0, retired_tiles=2),), seed=SEED))
    eng = Engine(StemmerWorkload(store(arrays), block_b=32,
                                 max_inflight=1, persistent=True,
                                 megabatch_tiles=4, watchdog_s=0.05,
                                 injector=inj))
    rids = submit(eng, enc)
    check(eng.run_until_drained().drained, "the stall drain")
    check(eng.workload.watchdog_stalls == 1, "watchdog_stalls")
    stalls = [e for e in eng.events() if e.kind == "watchdog_stall"]
    check(len(stalls) == 1 and stalls[0].data["salvaged_words"] == 64,
          f"stall events {stalls}")
    check_identical(eng, rids, baseline)
    passed("CHAOS_STALL_OK")

    # --- site device_loss: ladder reshards onto fewer devices ---------
    mesh, what = data_mesh(dev)
    print(f"device_loss: data_devices={DATA_DEVICES} on a mesh of {what}",
          flush=True)
    inj = FaultInjector(FaultPlan(specs=(FaultSpec("device_loss", at=0),),
                                  seed=SEED))
    pol = DegradationPolicy(down_after=1)
    eng = Engine(StemmerWorkload(store(arrays), block_b=32,
                                 max_inflight=2, data_devices=DATA_DEVICES,
                                 mesh=mesh, injector=inj), policy=pol)
    rids = submit(eng, enc)
    check(eng.run_until_drained().drained, "the device_loss drain")
    check(eng.workload.device_losses == 1, "device_losses")
    check(any(t[2] == "device_loss" and t[1].startswith("devices-")
              for t in pol.transitions), f"transitions {pol.transitions}")
    eng.step()               # a requested mode lands at an empty-ring tick
    check(eng.workload.data_devices < DATA_DEVICES, "not resharded")
    check_identical(eng, rids, baseline)
    passed("CHAOS_DEVICE_LOSS_OK")

    # --- site journal: torn WAL tail, warm restart bit-identical ------
    with tempfile.TemporaryDirectory() as td:
        jp = os.path.join(td, "wal.jsonl")
        # tear the 9th append (the first RETIRE record; events 0..7 are
        # the admits), so one served request must be re-served on replay
        inj = FaultInjector(FaultPlan(
            specs=(FaultSpec("journal", at=N_REQ),), seed=SEED))
        eng = Engine(StemmerWorkload(store(arrays), block_b=32,
                                     max_inflight=2),
                     journal=Journal(jp, fsync_every=1, injector=inj))
        rids = submit(eng, enc)
        for _ in range(2):
            eng.step()                        # serve a little, then "crash"
        done_before = {r: eng.result(r) for r in rids
                       if eng.result(r) is not None}
        eng2 = Engine.recover(jp, StemmerWorkload(store(arrays), block_b=32,
                                                  max_inflight=2))
        check(eng2.recovery.dropped_bytes > 0, "the tear was not truncated")
        check(eng2.run_until_drained().drained, "the replay drain")
        for i, r in enumerate(rids):
            req = done_before.get(r) or eng2.result(r)
            check(req is not None and req.failure is None,
                  f"req {r} after recovery")
            check(np.array_equal(req.roots, baseline[i]),
                  f"req {r}: roots differ after recovery")
    passed("CHAOS_JOURNAL_OK")
    return ok


if __name__ == "__main__":
    t0 = time.time()
    main()
    print(f"CHAOS_MATRIX_OK ({time.time() - t0:.1f}s)")

"""The port's sharded serving path on meshes of CPU entries, in one process:
``StemmerWorkload(data_devices=N)`` through the dispatch/retire ring
(super-tiles, megabatches, a hot swap in flight, a retried launch, the
text workload), an injected device loss walking the ladder onto fewer
devices, the ladder's rungs against the reference's, the mesh's refusals
and the CLI's ``--devices``. The reference's own 4-device serve fails its
test (ROADMAP §3), so every request is held to the single-device serve of
the port and to the reference's ``stem_batch``; integer outputs must be
identical."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.core import corpus as rcorpus  # noqa: E402
from repro.core import stemmer as rstemmer  # noqa: E402
from repro.serve import health as rhealth  # noqa: E402
from repro_torch.core import stemmer as tstemmer  # noqa: E402
from repro_torch.core import textnorm as ttn  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.serve import (DegradationPolicy, DictStore, Engine,  # noqa: E402
                               FaultInjector, FaultPlan, FaultSpec,
                               StemmerWorkload, TextAnalysisWorkload)
from repro_torch.serve import health as thealth  # noqa: E402

CPU = dict(device="cpu")
SIZES = (37, 64, 5, 50)        # 156 words


@pytest.fixture(scope="module")
def dicts():
    da = rstemmer.RootDictArrays.from_rootdict(
        rcorpus.build_dictionary(n_tri=400, n_quad=60, seed=0))
    tda = tstemmer.RootDictArrays.from_numpy(
        np.asarray(da.tri), np.asarray(da.quad), np.asarray(da.bi), **CPU)
    return da, tda


@pytest.fixture(scope="module")
def enc():
    words, _, _ = rcorpus.build_corpus(n_words=200, seed=1)
    return rcorpus.encode_corpus(words)


@pytest.fixture(scope="module")
def want(dicts, enc):
    da, _ = dicts
    r, s = rstemmer.stem_batch(jnp.asarray(enc[:192]), da)
    return np.asarray(r), np.asarray(s)


def _serve(tda, enc, sizes, **kw):
    eng = Engine(StemmerWorkload(DictStore(tda, **CPU), block_b=16, **kw))
    off, rids = 0, []
    for n in sizes:
        rids.append(eng.submit(enc[off:off + n]))
        off += n
    rep = eng.run_until_drained()
    assert rep.drained
    roots = np.concatenate([eng.result(r).roots for r in rids])
    sources = np.concatenate([eng.result(r).sources for r in rids])
    return eng, rids, roots, sources


@pytest.mark.parametrize("megabatch,inflight,launches", [(1, 2, 3),
                                                         (2, 1, 2)])
def test_sharded_serve_matches_single_device(dicts, enc, want, megabatch,
                                             inflight, launches):
    """super_b = 4 x 16 = 64: 156 words take 3 super-tile launches, or 2
    megabatches of 2 super-tiles; the checksum row covers the merged
    tiles."""
    _, tda = dicts
    eng, rids, roots, sources = _serve(
        tda, enc, SIZES, data_devices=4, megabatch_tiles=megabatch,
        max_inflight=inflight)
    wl = eng.workload
    assert wl.super_b == 64 and wl.launch_b == 64 * megabatch
    assert wl.ticks_launched == launches
    assert wl.checksum_tiles == 12       # 3 super-tiles of 4 tiles
    _, _, one_r, one_s = _serve(tda, enc, SIZES, max_inflight=inflight,
                                megabatch_tiles=megabatch)
    np.testing.assert_array_equal(roots, one_r)
    np.testing.assert_array_equal(sources, one_s)
    np.testing.assert_array_equal(roots, want[0][:sum(SIZES)])
    np.testing.assert_array_equal(sources, want[1][:sum(SIZES)])
    assert all((eng.result(r).dict_versions == 0).all() for r in rids)
    assert wl.device_losses == 0
    # four shards on the CPU share one copy of the dictionary
    assert [list(v) for v in wl._replicas.values()] == [[torch.device(
        "cpu")]]


def test_sharded_serve_on_an_explicit_mesh_of_five(dicts, enc, want):
    _, tda = dicts
    eng, _, roots, _ = _serve(tda, enc, SIZES, data_devices=5,
                              mesh=tmesh.Mesh.of(["cpu"] * 5))
    assert eng.workload.super_b == 80 and eng.workload.ticks_launched == 2
    np.testing.assert_array_equal(roots, want[0][:sum(SIZES)])


def test_hot_swap_lands_while_sharded_tiles_are_in_flight(dicts, enc):
    da, tda = dicts
    store = DictStore(tda, **CPU)
    grown = rcorpus.grow_root_arrays(da, 2048, seed=7)
    eng = Engine(StemmerWorkload(store, block_b=16, data_devices=4,
                                 max_inflight=2))
    rids = [eng.submit(enc[i * 32:(i + 1) * 32]) for i in range(6)]
    eng.step()                       # 2 super-tiles (128 words) dispatched
    assert eng.workload.ticks_launched == 2
    v1 = store.publish(tstemmer.RootDictArrays.from_numpy(
        np.asarray(grown.tri), np.asarray(grown.quad), np.asarray(grown.bi),
        **CPU))
    assert eng.run_until_drained().drained and v1 == 1
    versions = np.concatenate([eng.result(r).dict_versions for r in rids])
    np.testing.assert_array_equal(versions[:128], 0)   # pinned at dispatch
    np.testing.assert_array_equal(versions[128:], 1)
    got = np.concatenate([eng.result(r).roots for r in rids])
    for arrays, sl in ((da, slice(0, 128)), (grown, slice(128, 192))):
        want_r, _ = rstemmer.stem_batch(jnp.asarray(enc[sl]), arrays)
        np.testing.assert_array_equal(got[sl], np.asarray(want_r))


def test_sharded_retry_is_exact(dicts, enc, want):
    _, tda = dicts
    inj = FaultInjector(FaultPlan(specs=(FaultSpec("dispatch", at=0),)))
    eng, rids, roots, _ = _serve(tda, enc, SIZES, data_devices=4,
                                 injector=inj)
    assert eng.workload.retries_total == 1
    assert inj.fired == [("dispatch", "fail", 0)]
    assert eng.workload.device_losses == 0
    np.testing.assert_array_equal(roots, want[0][:sum(SIZES)])
    assert all(eng.result(r).failure is None for r in rids)


def test_device_loss_reshards_onto_fewer_devices(dicts, enc, want):
    """A device lost at the 2nd sharded launch: counted, a device_loss
    event, the ladder capped at devices-2, and the lost launch's words
    re-served exactly on the smaller mesh."""
    _, tda = dicts
    inj = FaultInjector(FaultPlan(specs=(FaultSpec("device_loss", at=1),)))
    pol = DegradationPolicy(down_after=1)
    eng = Engine(StemmerWorkload(DictStore(tda, **CPU), block_b=16,
                                 data_devices=4, max_inflight=1,
                                 injector=inj), policy=pol)
    rids = [eng.submit(enc[i * 32:(i + 1) * 32]) for i in range(6)]
    assert eng.run_until_drained().drained
    eng.step()                       # a requested mode lands at an empty ring
    wl = eng.workload
    assert wl.device_losses == 1
    assert inj.fired == [("device_loss", "lost", 1)]
    assert [t for t in pol.transitions if t[2] == "device_loss"] == [
        ("per-tile", "devices-2", "device_loss")]
    assert wl.data_devices == 2 and wl.super_b == 32
    kinds = [e.kind for e in eng.events()]
    assert "device_loss" in kinds and "degrade" in kinds
    lost = next(e for e in eng.events() if e.kind == "device_loss")
    assert lost.data["data_devices"] == 4
    got = np.concatenate([eng.result(r).roots for r in rids])
    np.testing.assert_array_equal(got, want[0])
    assert all(eng.result(r).failure is None for r in rids)
    # served on: the next requests run on 2 devices, streamed-dict override
    rid = eng.submit(enc[:40])
    assert eng.run_until_drained().drained
    np.testing.assert_array_equal(eng.result(rid).roots, want[0][:40])
    assert wl.residency_override == "streamed"


def test_device_loss_site_never_fires_on_one_device(dicts, enc, want):
    _, tda = dicts
    inj = FaultInjector(FaultPlan(specs=(FaultSpec("device_loss", at=0),)))
    eng, _, roots, _ = _serve(tda, enc, SIZES, injector=inj)
    assert eng.workload.device_losses == 0 and inj.fired == []
    np.testing.assert_array_equal(roots, want[0][:sum(SIZES)])


@pytest.mark.parametrize("persistent,megabatch", [(False, 1), (False, 4),
                                                  (True, 1), (True, 4)])
@pytest.mark.parametrize("resident", [True, False])
def test_ladder_rungs_match_reference(persistent, megabatch, resident):
    d = 1 if persistent else 4
    kw = dict(persistent=persistent, megabatch_tiles=megabatch,
              data_devices=d, resident_dict=resident)
    got = thealth.build_ladder(**kw)
    want = rhealth.build_ladder(**kw)
    assert [(m.label, m.persistent, m.megabatch_tiles, m.data_devices,
             m.residency) for m in got] == \
        [(m.label, m.persistent, m.megabatch_tiles, m.data_devices,
          m.residency) for m in want]
    if d == 4:
        assert [m.label for m in got][-2:] == ["devices-2", "devices-1"]


def test_workload_refusals(dicts):
    _, tda = dicts
    store = DictStore(tda, **CPU)
    with pytest.raises(ValueError, match="single-device"):
        StemmerWorkload(store, data_devices=2, persistent=True)
    with pytest.raises(ValueError, match="data_devices"):
        StemmerWorkload(store, data_devices=0)
    with pytest.raises(ValueError, match="fewer than data_devices"):
        StemmerWorkload(store, data_devices=4,
                        mesh=tmesh.Mesh.of(["cpu"] * 2))
    with pytest.raises(ValueError, match="not a cuda or cpu"):
        StemmerWorkload(store, data_devices=2,
                        mesh=tmesh.make_production_mesh())
    if not torch.cuda.is_available():
        # a store on the CPU builds a CPU mesh; GPUs the machine lacks raise
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_data_mesh(2, device="cuda")


def test_text_workload_over_the_mesh(dicts):
    da, tda = dicts
    eng = Engine(TextAnalysisWorkload(DictStore(tda, **CPU), block_b=16,
                                      data_devices=4, char_block=256,
                                      megabatch_tiles=2, max_inflight=2))
    docs = tlaunch.build_documents(4, 40, seed=2)
    rids = [eng.submit([d]) for d in docs]
    assert eng.run_until_drained().drained
    assert eng.workload.super_b == 64
    for rid, doc in zip(rids, docs):
        req = eng.result(rid)
        want_w, want_spans = ttn.analyze_text_py(doc)
        np.testing.assert_array_equal(req.words, want_w)
        np.testing.assert_array_equal(req.spans, want_spans)
        want_r, want_s = rstemmer.stem_batch(jnp.asarray(want_w), da)
        np.testing.assert_array_equal(req.roots, np.asarray(want_r))
        np.testing.assert_array_equal(req.sources, np.asarray(want_s))


def test_cli_devices(capsys):
    tlaunch.main(["--workload", "stemmer", "--devices", "4", "--device",
                  "cpu", "--requests", "4", "--block-b", "32"])
    out = capsys.readouterr().out
    assert "super-tile 4x32" in out and "2 launches" in out
    for argv, msg in ((["--devices", "0"], "must be >= 1"),
                      (["--devices", "2", "--persistent"], "single-device"),
                      (["--workload", "lm", "--devices", "2"],
                       "stemmer/text")):
        with pytest.raises(SystemExit) as e:
            tlaunch.main(["--workload", "stemmer", "--device", "cpu"]
                         + argv)
        assert e.value.code == 2
        assert msg in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as e:
            tlaunch.main(["--workload", "stemmer", "--devices", "2"])
        assert e.value.code == 2
        assert "no CUDA device" in capsys.readouterr().err

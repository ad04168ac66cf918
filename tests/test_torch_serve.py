"""The port's serving core (repro_torch.serve) against the JAX package's
Engine + StemmerWorkload: per-request roots, sources and dict versions
identical across a mid-stream hot swap, tick counts equal, and a
corrupted retire caught by the launch checksum."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro import serve as rserve  # noqa: E402
from repro.core import corpus as rcorpus  # noqa: E402
from repro.core import stemmer as rstemmer  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.core import stemmer as tstemmer  # noqa: E402

SIZES = (37, 64, 5, 50, 90)   # deliberately not block_b-aligned


def _port(da):
    return tstemmer.RootDictArrays.from_numpy(
        np.asarray(da.tri), np.asarray(da.quad), np.asarray(da.bi),
        device="cpu")


@pytest.fixture(scope="module")
def setup():
    da = rstemmer.RootDictArrays.from_rootdict(
        rcorpus.build_dictionary(n_tri=400, n_quad=60, seed=0))
    da2 = rstemmer.RootDictArrays.from_rootdict(
        rcorpus.build_dictionary(n_tri=300, n_quad=40, seed=7))
    words, _, _ = rcorpus.build_corpus(n_words=sum(SIZES), seed=1)
    return da, da2, rcorpus.encode_corpus(words)


def _serve(mod, store, enc, swap_to, *, megabatch_tiles, max_inflight,
           block_b=64):
    """Submit SIZES, step once, hot-swap to ``swap_to``, drain."""
    eng = mod.Engine(mod.StemmerWorkload(store, block_b=block_b,
                                         megabatch_tiles=megabatch_tiles,
                                         max_inflight=max_inflight))
    rids, off = [], 0
    for n in SIZES:
        rids.append(eng.submit(enc[off:off + n]))
        off += n
    eng.step()
    store.publish(swap_to)
    rep = eng.run_until_drained()
    return eng, [eng.result(r) for r in rids], rep


@pytest.mark.parametrize("megabatch_tiles,block_b", [(1, 64), (4, 16)])
def test_engine_matches_reference_engine_across_hot_swap(setup,
                                                         megabatch_tiles,
                                                         block_b):
    """max_inflight=1: every tick retires the previous launch and
    dispatches the next whether or not the reference's async arrays were
    ready, so both engines take the same schedule."""
    da, da2, enc = setup
    kw = dict(megabatch_tiles=megabatch_tiles, max_inflight=1,
              block_b=block_b)
    r_eng, r_reqs, r_rep = _serve(rserve, rserve.DictStore(da), enc, da2,
                                  **kw)
    t_eng, t_reqs, t_rep = _serve(
        tserve, tserve.DictStore(_port(da), device="cpu"), enc, _port(da2),
        **kw)
    assert t_rep.ticks == r_rep.ticks and t_rep.drained
    assert t_eng.workload.ticks_launched == r_eng.workload.ticks_launched
    for want, got in zip(r_reqs, t_reqs):
        assert got.done and got.n_words == want.n_words
        np.testing.assert_array_equal(got.roots, want.roots)
        np.testing.assert_array_equal(got.sources, want.sources)
        np.testing.assert_array_equal(got.dict_versions, want.dict_versions)
    # the swap landed mid-stream: both versions served some words
    assert {int(v) for r in t_reqs for v in r.dict_versions} == {0, 1}


@pytest.mark.parametrize("max_inflight", [1, 2])
@pytest.mark.parametrize("megabatch_tiles", [1, 4])
def test_engine_parity_per_dict_version(setup, megabatch_tiles,
                                        max_inflight):
    """Each word equals the reference stemmer under the version that
    served it, at every ring depth and megabatch width."""
    da, da2, enc = setup
    eng, reqs, rep = _serve(
        tserve, tserve.DictStore(_port(da), device="cpu"), enc, _port(da2),
        megabatch_tiles=megabatch_tiles, max_inflight=max_inflight)
    assert rep.drained
    wants = [rstemmer.extract_roots(jnp.asarray(enc), d, backend="sorted")
             for d in (da, da2)]
    off = 0
    for req in reqs:
        for v in (0, 1):
            sel = req.dict_versions == v
            want_r = np.asarray(wants[v][0])[off:off + req.n_words]
            want_s = np.asarray(wants[v][1])[off:off + req.n_words]
            np.testing.assert_array_equal(req.roots[sel], want_r[sel])
            np.testing.assert_array_equal(req.sources[sel], want_s[sel])
        off += req.n_words
    wl = eng.workload
    assert wl.checksum_tiles >= wl.ticks_launched
    assert sorted(wl._free_slots) == list(range(max_inflight))


def test_corrupted_staged_output_raises_on_checksum(setup):
    """Strict mode (max_retries=0): a torn copy of a launch's output is
    caught by the checksum and raised."""
    da, _, enc = setup
    wl = tserve.StemmerWorkload(tserve.DictStore(_port(da), device="cpu"),
                                block_b=64, max_inflight=1, max_retries=0)
    eng = tserve.Engine(wl)
    eng.submit(enc[:100])
    eng.step()                           # dispatch: one launch in flight
    assert len(wl.ring) == 1
    wl.ring[0].roots[3, 1] += 1          # a torn copy of the output
    with pytest.raises(RuntimeError, match="checksum mismatch"):
        eng.run_until_drained()


def test_corrupted_staged_output_absorbed_by_retry(setup):
    """The default retries absorb the same torn copy: the launch is
    discarded, its words re-dispatched, and the outputs equal the
    reference stemmer's bit for bit."""
    da, _, enc = setup
    wl = tserve.StemmerWorkload(tserve.DictStore(_port(da), device="cpu"),
                                block_b=64, max_inflight=1)
    eng = tserve.Engine(wl)
    rid = eng.submit(enc[:100])
    eng.step()
    wl.ring[0].roots[3, 1] += 1
    assert eng.run_until_drained().drained
    assert wl.checksum_failures == 1 and wl.retries_total == 1
    req = eng.result(rid)
    assert req.failure is None
    want_r, want_s = rstemmer.extract_roots(jnp.asarray(enc[:100]), da,
                                            backend="sorted")
    np.testing.assert_array_equal(req.roots, np.asarray(want_r))
    np.testing.assert_array_equal(req.sources, np.asarray(want_s))
    assert [e.kind for e in eng.events()] == ["checksum_failure", "retry"]


def test_shape_matched_hot_swap_reallocates_nothing(setup, monkeypatch):
    """A publish whose tables keep their shapes re-allocates no staging
    or output buffer, and no served launch pads a table again: the new
    version's tables are padded once, at its first launch, and the old
    version's never again (the reference holds its jit cache size)."""
    from repro_torch.kernels import stem_match as sm

    da, _, enc = setup
    store = tserve.DictStore(_port(da), device="cpu")
    wl = tserve.StemmerWorkload(store, block_b=32, megabatch_tiles=2,
                                max_inflight=2)
    eng = tserve.Engine(wl)
    eng.submit(enc[:200])
    assert eng.run_until_drained().drained
    buffers = [id(t) for t in wl._staging] + [
        id(t) for out in wl._outputs for t in out]
    padded = []
    real = sm.pad_dict_sorted
    monkeypatch.setattr(sm, "pad_dict_sorted",
                        lambda t: padded.append(t.shape) or real(t))
    # the same key counts, other keys: shift every key by one letter code
    tri, quad, bi = (np.asarray(t) for t in (da.tri, da.quad, da.bi))
    swapped = tstemmer.RootDictArrays.from_numpy(tri + 1, quad + 1, bi,
                                                 device="cpu")
    assert store.publish(swapped) == 1
    rids = [eng.submit(enc[i * 50:(i + 1) * 50]) for i in range(6)]
    assert eng.run_until_drained().drained
    assert wl.ticks_launched > 3
    assert [id(t) for t in wl._staging] + [
        id(t) for out in wl._outputs for t in out] == buffers
    assert padded == [(tri.shape[0],), (quad.shape[0],), (bi.shape[0],)]
    for i, rid in enumerate(rids):
        req = eng.result(rid)
        assert (req.dict_versions == 1).all()
        want_r, _ = tstemmer.extract_roots(enc[i * 50:(i + 1) * 50],
                                           swapped, device="cpu")
        np.testing.assert_array_equal(req.roots, want_r.numpy())


def test_empty_and_raw_string_requests(setup):
    da, _, _ = setup
    eng = tserve.Engine(tserve.StemmerWorkload(
        tserve.DictStore(_port(da), device="cpu"), block_b=32))
    words, _, _ = rcorpus.build_corpus(n_words=20, seed=3)
    r_empty = eng.submit(np.zeros((0, 16), np.int32))
    r_raw = eng.submit(words)
    eng.run_until_drained()
    assert eng.result(r_empty).done and eng.result(r_empty).n_words == 0
    want_r, _ = tstemmer.extract_roots(rcorpus.encode_corpus(words), _port(da),
                                       device="cpu")
    np.testing.assert_array_equal(eng.result(r_raw).roots, want_r.numpy())
    with pytest.raises(ValueError, match="encoded word batch"):
        eng.submit(np.zeros((3, 15), np.int32))


def test_dict_store_versions_and_validation(setup):
    da, da2, _ = setup
    store = tserve.DictStore(_port(da), device="cpu")
    assert store.version == 0
    assert store.publish(_port(da2)) == 1 and store.version == 1
    np.testing.assert_array_equal(store.get(0).arrays.tri.numpy(),
                                  np.asarray(da.tri))
    bad = _port(da)
    bad.tri = bad.tri.flip(0)
    with pytest.raises(tserve.DictValidationError, match="sorted"):
        store.publish(bad)
    assert store.version == 1            # nothing was installed
    with pytest.raises(KeyError):
        store.get(5)


def test_undrained_engine_raises(setup):
    da, _, enc = setup
    eng = tserve.Engine(tserve.StemmerWorkload(
        tserve.DictStore(_port(da), device="cpu"), block_b=32,
        max_inflight=1))
    eng.submit(enc[:200])
    with pytest.raises(tserve.EngineUndrained) as exc:
        eng.run_until_drained(max_ticks=2)
    assert exc.value.report.pending == [0]

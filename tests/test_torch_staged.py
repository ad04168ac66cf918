"""The port's staged Compare path: ``extract_roots(backend="pallas")``
(the comparator bank, K7), ``extended=True`` with ``backend="fused"`` (the
sorted search, K8), ``ops.extract_roots_multilaunch`` (K6 then K7 per
group), the paper's three execution models and ``autotune_stem_fused``,
against the JAX package (its Pallas kernels in interpret mode). Every
compared output is int32 and identical."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.core import corpus as rcorpus  # noqa: E402
from repro.core import stemmer as rstemmer  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro_torch.core import accuracy  # noqa: E402
from repro_torch.core import corpus as tcorpus  # noqa: E402
from repro_torch.core import stemmer as tstemmer  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import stem_datapath as tsdp  # noqa: E402
from repro_torch.kernels import stem_match as tsm  # noqa: E402

# Table-6 root recall over build_corpus(2000, seed=0) (BENCH_stemmer.json)
RECALL_WITH_INFIX = 0.8914728682170543
RECALL_WITHOUT_INFIX = 0.8062015503875969


@pytest.fixture(scope="module")
def dicts():
    da = rstemmer.RootDictArrays.from_rootdict(rcorpus.build_dictionary())
    tda = tstemmer.RootDictArrays.from_numpy(
        np.asarray(da.tri), np.asarray(da.quad), np.asarray(da.bi),
        device="cpu")
    return da, tda


@pytest.fixture(scope="module")
def words():
    w, _, _ = rcorpus.build_corpus(n_words=600, seed=3)
    return rcorpus.encode_corpus(w)


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("infix", [True, False])
def test_pallas_backend_matches_reference(dicts, words, infix, extended):
    da, tda = dicts
    got = tstemmer.extract_roots(words, tda, infix=infix, backend="pallas",
                                 extended=extended, device="cpu")
    want = rstemmer.extract_roots(jnp.asarray(words), da, infix=infix,
                                  backend="pallas", extended=extended)
    _same(got, want)
    assert (got[1] > 0).any()
    if not extended:
        fused = tstemmer.extract_roots(words, tda, infix=infix,
                                       backend="fused", device="cpu")
        assert all(torch.equal(g, f) for g, f in zip(got, fused))


@pytest.mark.parametrize("infix", [True, False])
def test_fused_extended_matches_reference(dicts, words, infix):
    """extended=True with backend="fused" takes the staged path, its stage
    5 through the sorted search; equal to the sorted backend too."""
    da, tda = dicts
    got = tstemmer.extract_roots(words, tda, infix=infix, backend="fused",
                                 extended=True, device="cpu")
    want = rstemmer.extract_roots(jnp.asarray(words), da, infix=infix,
                                  backend="fused", extended=True)
    _same(got, want)
    plain = tstemmer.extract_roots(words, tda, infix=infix, backend="sorted",
                                   extended=True, device="cpu")
    assert all(torch.equal(g, p) for g, p in zip(got, plain))


@pytest.mark.parametrize("backend,infix,extended,calls", [
    ("pallas", False, False, 2), ("pallas", True, False, 5),
    ("pallas", True, True, 7), ("pallas", False, True, 4),
    ("fused", True, True, 7), ("fused", False, True, 4)])
def test_one_compare_call_per_group(dicts, words, monkeypatch, backend,
                                    infix, extended, calls):
    """The staged path calls its Compare kernel once a candidate group, as
    the reference traces it: 2, 5 or 7 launches a call on the card."""
    _, tda = dicts
    name = "dict_match_plain" if backend == "pallas" \
        else "dict_match_bsearch_plain"
    seen = []
    real = getattr(tsm, name)
    monkeypatch.setattr(tsm, name,
                        lambda k, d, **kw: seen.append(k.shape) or
                        real(k, d, **kw))
    tstemmer.extract_roots(words[:50], tda, infix=infix, backend=backend,
                           extended=extended, device="cpu")
    assert seen == [(300,)] * calls


@pytest.mark.parametrize("infix", [True, False])
def test_multilaunch_matches_reference(dicts, words, infix):
    da, tda = dicts
    got = ops.extract_roots_multilaunch(words, tda, infix=infix,
                                        device="cpu")
    want = rops.extract_roots_multilaunch(jnp.asarray(words), da,
                                          infix=infix, interpret=True)
    _same(got, want)
    fused = ops.extract_roots_fused(words, tda, infix=infix, device="cpu")
    assert all(torch.equal(g, f) for g, f in zip(got, fused))


def test_multilaunch_empty_batch_and_handle(dicts, words):
    _, tda = dicts
    root, source = ops.extract_roots_multilaunch(
        np.zeros((0, 16), np.int32), tda, device="cpu")
    assert tuple(root.shape) == (0, 4) and tuple(source.shape) == (0,)
    handle = tstemmer.resolve_dict(tda)
    got = ops.extract_roots_multilaunch(words[:40], handle, device="cpu")
    want = ops.extract_roots_multilaunch(words[:40], tda, device="cpu")
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("backend", ["dense", "sorted", "pallas", "fused"])
def test_execution_models_match_stem_batch(dicts, words, backend):
    """Software (one word at a time) and pipelined (microbatches of 128
    over a ragged batch of 300, zero rows padded and sliced off) equal the
    non-pipelined stem_batch, extended too."""
    _, tda = dicts
    for extended in (False, True):
        kw = dict(backend=backend, extended=extended, device="cpu")
        want = tstemmer.stem_batch(words[:300], tda, **kw)
        seq = tstemmer.stem_sequential(words[:40], tda, **kw)
        pipe = tstemmer.stem_pipelined(words[:300], tda, microbatch=128, **kw)
        assert all(torch.equal(s, w[:40]) for s, w in zip(seq, want))
        assert all(torch.equal(p, w) for p, w in zip(pipe, want))


def test_execution_models_match_reference(dicts, words):
    da, tda = dicts
    enc = words[:24]
    _same(tstemmer.stem_sequential(enc, tda, backend="pallas", device="cpu"),
          rstemmer.stem_sequential(jnp.asarray(enc), da, backend="pallas"))
    _same(tstemmer.stem_pipelined(words[:300], tda, backend="pallas",
                                  microbatch=128, device="cpu"),
          rstemmer.stem_pipelined(jnp.asarray(words[:300]), da,
                                  backend="pallas", microbatch=128))
    root, source = tstemmer.stem_sequential(np.zeros((0, 16), np.int32), tda,
                                            device="cpu")
    assert tuple(root.shape) == (0, 4) and tuple(source.shape) == (0,)


def test_table6_recall_through_the_bank():
    t6 = accuracy.table6(n_words=2000, seed=0, backend="pallas",
                         device="cpu")
    assert t6["with_infix"].root_recall == RECALL_WITH_INFIX
    assert t6["without_infix"].root_recall == RECALL_WITHOUT_INFIX


def test_autotune_returns_the_reference_keys_and_a_runnable_config(dicts,
                                                                    words):
    da, tda = dicts
    enc = words[:64]
    grid = dict(block_bs=(32,), dict_block_rs=(8,), num_bufferss=(2,),
                iters=1)
    got = ops.autotune_stem_fused(enc, tda, device="cpu", **grid)
    want = rops.autotune_stem_fused(jnp.asarray(enc), da, interpret=True,
                                    **grid)
    assert set(got) == set(want)
    assert set(got["timings"]) == set(want["timings"])
    assert all(t > 0 for t in got["timings"].values())
    cfg = {k: v for k, v in got.items() if k != "timings"}
    out = ops.extract_roots_fused(enc, tda, device="cpu", **cfg)
    plain = tstemmer.extract_roots(enc, tda, backend="sorted", device="cpu")
    assert all(torch.equal(o, p) for o, p in zip(out, plain))


def test_autotune_error_matches_reference(dicts, words):
    da, tda = dicts
    big = tcorpus.grow_root_arrays(tda, 70_000)
    with pytest.raises(ValueError) as got:
        ops.autotune_stem_fused(words[:8], big, residencies=("resident",),
                                device="cpu")
    rbig = rcorpus.grow_root_arrays(da, 70_000)
    with pytest.raises(ValueError) as want:
        rops.autotune_stem_fused(jnp.asarray(words[:8]), rbig,
                                 residencies=("resident",), interpret=True)
    assert str(got.value) == str(want.value)


def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.cuda
def test_staged_path_on_card_equals_fused_and_counts_launches():
    _on_card()
    da = tstemmer.RootDictArrays.from_rootdict(tcorpus.build_dictionary())
    w = next(tcorpus.stream_corpus_words(65_536, seed=0,
                                         chunk_words=65_536)).words
    fused = tstemmer.extract_roots(w, da, backend="fused")
    for kw, wrapper, launches in (
            (dict(backend="pallas"), tsm.dict_match_cuda, 5),
            (dict(backend="pallas", infix=False), tsm.dict_match_cuda, 2),
            (dict(backend="pallas", extended=True), tsm.dict_match_cuda, 7),
            (dict(backend="fused", extended=True),
             tsm.dict_match_bsearch_cuda, 7)):
        ops.reset_dispatch_count()
        got = tstemmer.extract_roots(w, da, **kw)
        torch.cuda.synchronize()
        assert wrapper.launches == ops.dispatch_count() == launches
        plain = tstemmer.extract_roots(w, da, backend="sorted",
                                       infix=kw.get("infix", True),
                                       extended=kw.get("extended", False))
        assert all(torch.equal(g, p) for g, p in zip(got, plain))
        if not kw.get("extended") and kw.get("infix", True):
            assert all(torch.equal(g, f) for g, f in zip(got, fused))
    ops.reset_dispatch_count()
    got = ops.extract_roots_multilaunch(w, da)
    torch.cuda.synchronize()
    assert tsdp.stem_datapath_cuda.launches == 1
    assert tsm.dict_match_cuda.launches == 5
    assert all(torch.equal(g, f) for g, f in zip(got, fused))

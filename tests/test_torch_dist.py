"""The port's several-device modules against the JAX package, on meshes of
CPU entries in one process: the data-sharded stemmer launches
(``dist.shard_batch``, ``ops.extract_roots_sharded``), the sharded index
(``build_root_index(mesh=)``, ``build_corpus_index(mesh=)``), the stage
pipeline, the sharding resolver with ``cache_logical_axes``, int8 error
feedback, and the meshes. The reference's own sharded run fails its
tests (ROADMAP §3), so the sharded outputs are held to the single-device
outputs of both packages and to ``index.reference.host_index``. Integer
outputs must be identical."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro import index as rix  # noqa: E402
from repro.core import corpus as rcorpus  # noqa: E402
from repro.core import stemmer as rstemmer  # noqa: E402
from repro.dist import compression as rcomp  # noqa: E402
from repro.dist import pipeline as rpipe  # noqa: E402
from repro.dist import sharding as rsharding  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import stem_datapath as rsd  # noqa: E402
from repro.models import model as rmodel  # noqa: E402
from repro.models import params as rpm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import dist as tdist  # noqa: E402
from repro_torch import index as tix  # noqa: E402
from repro_torch.core import corpus as tcorpus  # noqa: E402
from repro_torch.core import stemmer as tstemmer  # noqa: E402
from repro_torch.dist import compression as tcomp  # noqa: E402
from repro_torch.dist import pipeline as tpipe  # noqa: E402
from repro_torch.dist import sharding as tsharding  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import stem_fused as tsf  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import params as tpm  # noqa: E402

CPU = dict(device="cpu")
SIZES = (128, 100, 7, 0)       # 4 x 32 exact | ragged | < one tile | empty


class FakeMesh:
    """The reference tests' duck-typed mesh: axis_names + devices.shape."""

    def __init__(self, sizes: dict):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()))


def _port(da):
    return tstemmer.RootDictArrays.from_numpy(
        np.asarray(da.tri), np.asarray(da.quad), np.asarray(da.bi), **CPU)


@pytest.fixture(scope="module")
def dicts():
    """The resident dictionary (~460 keys) and one grown past the streamed
    ceiling, in both packages."""
    da = rstemmer.RootDictArrays.from_rootdict(
        rcorpus.build_dictionary(n_tri=400, n_quad=60, seed=0))
    grown = rcorpus.grow_root_arrays(da, 70_000, seed=3)
    assert tsf.choose_residency(_port(grown)) == "streamed"
    return {"resident": (da, _port(da)), "streamed": (grown, _port(grown))}


@pytest.fixture(scope="module")
def enc():
    words, _, _ = rcorpus.build_corpus(n_words=200, seed=1)
    return rcorpus.encode_corpus(words)


@pytest.fixture(scope="module")
def want(dicts, enc):
    """The reference's stem_batch over the first 128 words, each dict."""
    return {k: tuple(np.asarray(x) for x in rstemmer.stem_batch(
        jnp.asarray(enc[:128]), da)) for k, (da, _) in dicts.items()}


@pytest.fixture(autouse=True)
def _reset_port_dispatch_count():
    tops.reset_dispatch_count()
    yield
    tops.reset_dispatch_count()


# ---------------------------------------------------------------------------
# data-sharded launches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind,num_buffers,skip_index", [
    ("resident", 2, True), ("streamed", 1, True), ("streamed", 2, True),
    ("streamed", 2, False)])
def test_shard_batch_matches_single_device_and_reference(
        dicts, enc, want, n, kind, num_buffers, skip_index):
    _, tda = dicts[kind]
    mesh = tmesh.make_data_mesh(4, **CPU)
    handle = tstemmer.resolve_dict(tda, dict_block_r=8)
    kw = dict(block_b=32, num_buffers=num_buffers, skip_index=skip_index)
    got_r, got_s = tdist.shard_batch(enc[:n], handle, mesh, **kw)
    one_r, one_s = tops.extract_roots_fused(enc[:n], handle, **kw, **CPU)
    assert got_r.dtype == got_s.dtype == torch.int32
    assert tuple(got_r.shape) == (n, 4) and tuple(got_s.shape) == (n,)
    assert torch.equal(got_r, one_r) and torch.equal(got_s, one_s)
    want_r, want_s = want[kind]
    np.testing.assert_array_equal(got_r.numpy(), want_r[:n])
    np.testing.assert_array_equal(got_s.numpy(), want_s[:n])


@pytest.mark.parametrize("n_dev", [2, 4, 5])
@pytest.mark.parametrize("kind", ["resident", "streamed"])
def test_sharded_checksum_rows_and_launch_accounting(dicts, enc, monkeypatch,
                                                     n_dev, kind):
    """The checksum of the merged rows equals the single-device call's, and
    the shards launch n_dev * planned_launches(ceil(B / n_dev)) kernels:
    counted here on the plain versions, which the card's counters mirror
    (one launch a call)."""
    _, tda = dicts[kind]
    mesh = tmesh.make_data_mesh(n_dev, **CPU)
    calls = []
    for name in ("stem_fused_plain", "stem_streamed_plain"):
        real = getattr(tsf, name)
        monkeypatch.setattr(tsf, name, lambda *a, _r=real, **k: (
            calls.append(1), _r(*a, **k))[1])
    b = 160                    # 10 tiles of 16: ragged over 4 and 5 shards
    got = tops.extract_roots_sharded(enc[:b], tda, mesh, block_b=16,
                                     visit_budget=64, with_checksum=True)
    per_dev = -(-b // n_dev)
    assert len(calls) == n_dev * tsf.planned_launches(
        per_dev, tda, block_b=16, visit_budget=64) > 0
    want = tops.extract_roots_fused(enc[:b], tda, block_b=16,
                                    visit_budget=64, with_checksum=True,
                                    **CPU)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert tops.dispatch_count() == 0       # the CPU launches no kernel
    with pytest.raises(ValueError, match="multiple of block_b"):
        tops.extract_roots_sharded(enc[:100], tda, mesh, block_b=16,
                                   with_checksum=True)


def test_dictionary_copied_once_a_device(dicts, enc):
    _, tda = dicts["resident"]
    handle = tstemmer.resolve_dict(tda)
    replicas = {}
    mesh = tmesh.Mesh.of(["cpu"] * 4)
    for _ in range(2):
        tdist.shard_batch(enc[:128], handle, mesh, block_b=16,
                          replicas=replicas)
    assert list(replicas) == [torch.device("cpu")]
    assert replicas[torch.device("cpu")] is handle   # already there


# ---------------------------------------------------------------------------
# the sharded index
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def table():
    return tcorpus.build_token_table(forms_per_root=6)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_root_index_matches_single_device_and_host(dicts, table,
                                                           n_dev):
    """W = 1500 is not a multiple of n_dev * block_w, and block_b is a
    quarter of block_w: the shards are whole postings tiles, so the stacked
    histograms keep corpus order."""
    da, tda = dicts["resident"]
    vocab = rix.build_vocab(da)
    ch = next(tcorpus.stream_corpus_words(1500, seed=7, chunk_words=1500,
                                          words_per_doc=250, table=table))
    mesh = tmesh.make_data_mesh(n_dev, **CPU)
    got = tops.build_root_index(ch.words, tda, vocab, ch.doc_ids,
                                ch.positions, mesh=mesh, block_b=32,
                                block_w=128)
    one = tops.build_root_index(ch.words, tda, vocab, ch.doc_ids,
                                ch.positions, block_b=32, block_w=128,
                                **CPU)
    ref = rops.build_root_index(ch.words, da, vocab, ch.doc_ids,
                                ch.positions, block_b=32, block_w=128)
    n = int(got[3])
    assert n == int(one[3]) == int(ref[3]) > 0
    assert got[1].shape[0] % (n_dev * 128) == 0
    np.testing.assert_array_equal(got[0].numpy(), one[0].numpy())
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    for g, o, r in zip(got[1:3], one[1:3], ref[1:3]):
        np.testing.assert_array_equal(g[:n].numpy(), o[:n].numpy())
        np.testing.assert_array_equal(g[:n].numpy(), np.asarray(r)[:n])
        assert not g[n:].any()
    ids = tix.host_root_ids(ch.words, tda, vocab)
    wc, wd, wp = tix.host_index(ids, ch.doc_ids.astype(np.int32),
                                ch.positions, len(vocab))
    np.testing.assert_array_equal(got[0].numpy(), wc)
    np.testing.assert_array_equal(got[1][:n].numpy(), wd)
    np.testing.assert_array_equal(got[2][:n].numpy(), wp)


def test_sharded_corpus_index_matches_single_device_and_host(dicts, table):
    _, tda = dicts["resident"]
    vocab = tix.build_vocab(tda)

    def stream():
        return tcorpus.stream_corpus_words(5000, seed=3, chunk_words=2048,
                                           words_per_doc=300, table=table)

    mesh = tmesh.make_data_mesh(4, **CPU)
    got = tix.build_corpus_index(stream(), tda, mesh=mesh, block_b=256,
                                 block_w=256)
    one = tix.build_corpus_index(stream(), tda, block_b=256, block_w=256,
                                 **CPU)
    parts = []
    for ch in stream():
        ids = tix.host_root_ids(ch.words, tda, vocab)
        parts.append(tix.IndexPartial(*tix.host_index(
            ids, ch.doc_ids.astype(np.int32), ch.positions, len(vocab))))
    host = tix.merge_partials(parts, vocab)
    for other in (one, host):
        np.testing.assert_array_equal(got.counts, other.counts)
        np.testing.assert_array_equal(got.docs, other.docs)
        np.testing.assert_array_equal(got.positions, other.positions)
    assert got.n_postings > 2000


# ---------------------------------------------------------------------------
# the stage pipeline
# ---------------------------------------------------------------------------
def _bundle(enc_words, m: int, mb: int, xp):
    z = xp.zeros
    return {"words": xp.asarray(enc_words).reshape(m, mb, 16),
            "keys": z((m, mb, 32), dtype=xp.int32),
            "valid": z((m, mb, 32), dtype=xp.int32),
            "root": z((m, mb, 4), dtype=xp.int32),
            "source": z((m, mb), dtype=xp.int32)}


@pytest.mark.parametrize("residency,chunk_keys", [("resident", 1 << 14),
                                                  ("streamed", 128)])
def test_pipeline_matches_stem_batch(dicts, enc, residency, chunk_keys):
    da, tda = dicts["resident"]
    m, mb = 4, 8
    words = enc[:m * mb]
    bundle = {k: torch.from_numpy(np.asarray(v))
              for k, v in _bundle(words, m, mb, np).items()}
    fns = tpipe.stemmer_stage_fns(tda, residency=residency,
                                  chunk_keys=chunk_keys)
    out = tpipe.pipeline_map(fns, bundle, tmesh.Mesh.of(["cpu"] * 5,
                                                        axis="stage"))
    want_r, want_s = rstemmer.stem_batch(jnp.asarray(words), da)
    np.testing.assert_array_equal(out["root"].reshape(-1, 4).numpy(),
                                  np.asarray(want_r))
    np.testing.assert_array_equal(out["source"].reshape(-1).numpy(),
                                  np.asarray(want_s))
    with pytest.raises(ValueError, match="need 5"):
        tpipe.pipeline_map(fns, bundle, tmesh.Mesh.of(["cpu"] * 4,
                                                      axis="stage"))


@pytest.mark.parametrize("residency,chunk_keys", [("resident", 1 << 14),
                                                  ("streamed", 128)])
def test_each_stage_matches_reference_stage(dicts, enc, residency,
                                            chunk_keys):
    """Each stage alone, on the bundle the previous stage produced: the
    reference's stage functions are plain jnp and run without a mesh."""
    da, tda = dicts["resident"]
    rb = {k: v[0] for k, v in _bundle(enc[:16], 1, 16, jnp).items()}
    tb = {k: torch.from_numpy(np.array(v)) for k, v in rb.items()}
    rfns = rpipe.stemmer_stage_fns(da, residency=residency,
                                   chunk_keys=chunk_keys)
    tfns = tpipe.stemmer_stage_fns(tda, residency=residency,
                                   chunk_keys=chunk_keys)
    for s, (rf, tf) in enumerate(zip(rfns, tfns)):
        tb_in = {k: torch.from_numpy(np.array(v)) for k, v in rb.items()}
        rb, tb = rf(rb), tf(tb_in)
        for k in rb:
            assert tb[k].dtype == torch.int32, (s, k)
            got, want = tb[k].numpy(), np.asarray(rb[k])
            if s == 0 and k == "keys":
                # the reference's stage runs kref.stem_datapath_ref, whose
                # keys in invalid slots differ from its Pallas datapath's;
                # the port's stage runs K6's plain version, held to the
                # Pallas kernel in every slot
                pallas, _ = rsd.stem_datapath_pallas(rb["words"],
                                                     interpret=True)
                np.testing.assert_array_equal(got, np.asarray(pallas))
                live = np.asarray(rb["valid"]) > 0
                got, want = got[live], want[live]
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"stage {s}, {k}")


def test_streamed_match_sorted_matches_reference(dicts):
    da, tda = dicts["streamed"]
    keys = np.asarray(da.tri)[::97].copy()
    keys[::2] += 1
    for chunk in (1 << 14, 1000, 4096):
        got = tpipe._streamed_match_sorted(torch.from_numpy(keys), tda.tri,
                                           chunk)
        want = rpipe._streamed_match_sorted(jnp.asarray(keys), da.tri,
                                            chunk)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the sharding resolver and the caches' logical axes
# ---------------------------------------------------------------------------
def _meshes():
    return [("fake 16x16", FakeMesh({"data": 16, "model": 16})),
            ("fake 2x16x16", FakeMesh({"pod": 2, "data": 16, "model": 16})),
            ("port 16x16", tmesh.make_production_mesh()),
            ("port 2x16x16", tmesh.make_production_mesh(multi_pod=True))]


@pytest.mark.parametrize("arch", sorted(rconfigs.ARCHS))
def test_resolve_matches_reference_for_every_param(arch):
    rspec = jax.tree.leaves(rmodel.model_spec(rconfigs.get_config(arch)),
                            is_leaf=rpm.is_spec)
    tspec = tpm.tree_leaves(tmodel.model_spec(tconfigs.get_config(arch)))
    assert len(rspec) == len(tspec) > 0
    for label, mesh in _meshes():
        for r, t in zip(rspec, tspec):
            assert tuple(r.shape) == tuple(t.shape)
            assert tuple(r.axes) == tuple(t.axes)
            got = tsharding.resolve(t.axes, t.shape, mesh)
            assert isinstance(got, tsharding.P)
            assert tuple(got) == tuple(rsharding.resolve(r.axes, r.shape,
                                                         mesh)), (label, t)


def _is_axes(x):
    return isinstance(x, tuple) and len(x) > 0 and all(
        isinstance(e, (str, type(None))) for e in x)


def _axes_leaves(tree) -> list:
    """The axes tuples in init_caches' flattening order (dict keys
    sorted, fields in order; () placeholders hold none)."""
    if tmodel.is_axes(tree):
        return [tree]
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _axes_leaves(tree[k])]
    return [a for part in tree for a in _axes_leaves(part)]


@pytest.mark.parametrize("arch", sorted(rconfigs.ARCHS))
def test_cache_logical_axes_match_reference(arch):
    rcfg = rconfigs.smoke_config(rconfigs.get_config(arch))
    tcfg = tconfigs.smoke_config(tconfigs.get_config(arch))
    raxes = jax.tree.flatten(rmodel.cache_logical_axes(rcfg),
                             is_leaf=_is_axes)[0]
    taxes = _axes_leaves(tmodel.cache_logical_axes(tcfg))
    caches = tmodel.init_caches(tcfg, 2, 16, device="meta")

    def leaves(t):
        if isinstance(t, torch.Tensor):
            return [t]
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in leaves(t[k])]
        return [x for part in t for x in leaves(part)]

    shapes = [tuple(x.shape) for x in leaves(caches)]
    assert len(taxes) == len(raxes) == len(shapes) > 0
    for label, mesh in _meshes():
        for r, t, shape in zip(raxes, taxes, shapes):
            assert t == tuple(r) and len(t) == len(shape)
            assert tuple(tsharding.resolve(t, shape, mesh)) == tuple(
                rsharding.resolve(r, shape, mesh)), (label, t, shape)


def test_mesh_axis_size_resolves_and_rejects():
    mesh = FakeMesh({"data": 4, "model": 2})
    assert tdist.mesh_axis_size(mesh, "data") == 4
    with pytest.raises(ValueError, match="no axis"):
        tdist.mesh_axis_size(mesh, "stage")
    assert tsharding.axis_sizes(tmesh.make_production_mesh()) == {
        "data": 16, "model": 16}
    assert repr(tsharding.P("data", None)) == "P('data', None)"


# ---------------------------------------------------------------------------
# int8 error feedback
# ---------------------------------------------------------------------------
def test_compress_decompress_matches_reference():
    rng = np.random.default_rng(0)
    shapes = [(64, 33), (7,), (3, 5, 11)]
    grads = [[rng.standard_normal(s).astype(np.float32) * 10 ** k
              for k, s in enumerate(shapes)] for _ in range(3)]
    grads[1][1][:] = 0.0            # an all-zero tensor: scale at _EPS
    r_err = [jnp.zeros(s, jnp.float32) for s in shapes]
    t_err = [torch.zeros(s, dtype=torch.float32) for s in shapes]
    for rnd in range(3):
        r_deq, r_new = rcomp.compress_decompress(
            [jnp.asarray(g) for g in grads[rnd]], r_err)
        t_deq, t_new = tcomp.compress_decompress(
            [torch.from_numpy(g) for g in grads[rnd]], t_err)
        for g, re, te in zip(grads[rnd], r_err, t_err):
            rq, rs = rcomp.quantise_tensor(jnp.asarray(g) + re)
            tq, ts = tcomp.quantise_tensor(torch.from_numpy(g) + te)
            assert tq.dtype == torch.int8
            np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
            np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(rs), 1)
        for a, b in zip(t_deq + t_new, r_deq + r_new):
            assert a.dtype == torch.float32
            np.testing.assert_array_max_ulp(a.numpy(), np.asarray(b), 1)
        r_err, t_err = r_new, t_new


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------
def test_meshes():
    m = tmesh.make_data_mesh(5, **CPU)
    assert m.shape == {"data": 5} and m.axis_names == ("data",)
    assert tdist.shard_batch.__module__ == "repro_torch.dist.shard_batch"
    assert m.first(2).shape == {"data": 2}
    with pytest.raises(ValueError, match="asked for 6"):
        m.first(6)
    assert tmesh.make_data_mesh(**CPU).shape == {"data": 1}
    with pytest.raises(ValueError, match="n_dev >= 1"):
        tmesh.make_data_mesh(0, **CPU)
    local = tmesh.make_local_mesh(**CPU)
    assert local.shape == {"data": 1, "model": 1}
    pod = tmesh.make_production_mesh(multi_pod=True)
    assert pod.shape == {"pod": 2, "data": 16, "model": 16}
    assert {d.type for d in pod.devices.flat} == {"meta"}
    with pytest.raises(ValueError, match="one device type"):
        tmesh.Mesh(np.array([torch.device("cpu"), torch.device("meta")],
                            dtype=object), ("data",))


def test_cuda_mesh_needs_its_gpus(monkeypatch):
    """No silent fallback: a mesh of GPUs the machine lacks raises, a
    ``cuda`` entry without a card through ``device.resolve``."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_data_mesh(2, device="cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.Mesh.of(["cuda:0"] * 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="n_dev <= 1 devices"):
        tmesh.make_data_mesh(2, device="cuda")
    with pytest.raises(ValueError, match="only 1 CUDA devices"):
        tmesh.Mesh.of(["cuda:0", "cuda:1"])
    assert tmesh.make_data_mesh(device="cuda").shape == {"data": 1}
    assert [str(d) for d in tmesh.Mesh.of(["cuda:0"] * 4).devices] == [
        "cuda:0"] * 4


@pytest.mark.cuda
def test_sharded_paths_on_card(dicts, enc, table):
    """Four shards on one card through the real kernels: K1 and K2 a shard,
    K5 a shard of the index, K6 inside the pipeline; each equal to the CPU
    path, and the launches what the reference counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    mesh = tmesh.Mesh.of(["cuda:0"] * 4)
    for kind in ("resident", "streamed"):
        _, tda = dicts[kind]
        card = tda.to("cuda")
        for n in SIZES:
            tops.reset_dispatch_count()
            got = tops.extract_roots_sharded(enc[:n], card, mesh, block_b=32)
            per_dev = -(-n // 4) if n else 0
            assert tops.dispatch_count() == 4 * tsf.planned_launches(
                per_dev, card, block_b=32)
            want = tops.extract_roots_fused(enc[:n], tda, block_b=32, **CPU)
            assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    da, tda = dicts["resident"]
    vocab = rix.build_vocab(da)
    ch = next(tcorpus.stream_corpus_words(1500, seed=7, chunk_words=1500,
                                          words_per_doc=250, table=table))
    got = tops.build_root_index(ch.words, tda.to("cuda"), vocab, ch.doc_ids,
                                ch.positions, mesh=mesh, block_b=128,
                                block_w=128)
    one = tops.build_root_index(ch.words, tda, vocab, ch.doc_ids,
                                ch.positions, block_b=128, block_w=128,
                                **CPU)
    n = int(got[3])
    assert n == int(one[3])
    assert torch.equal(got[0].cpu(), one[0])
    m, mb = 4, 8
    bundle = {k: torch.from_numpy(np.asarray(v)).cuda()
              for k, v in _bundle(enc[:m * mb], m, mb, np).items()}
    tops.reset_dispatch_count()
    out = tpipe.pipeline_map(tpipe.stemmer_stage_fns(tda.to("cuda")), bundle,
                             tmesh.Mesh.of(["cuda:0"] * 5, axis="stage"))
    assert tops.dispatch_count() == m + 5 - 1      # K6 every tick
    want_r, _ = tstemmer.stem_batch(torch.from_numpy(enc[:m * mb]), tda,
                                    **CPU)
    assert torch.equal(out["root"].reshape(-1, 4).cpu(), want_r)


def test_pipeline_example_runs_in_process(capsys):
    """examples/torch_pipeline_stemmer.py's main() on five CPU entries: it
    asserts its own parity with stem_batch."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / \
        "torch_pipeline_stemmer.py"
    spec = importlib.util.spec_from_file_location("torch_pipeline_stemmer",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--device", "cpu", "--microbatches", "4"])
    assert tuple(out["root"].shape) == (4, 8, 4)
    assert "== single-device batch output" in capsys.readouterr().out

"""The port's examples (examples/torch_*.py) run in-process on the CPU,
where the port takes the plain versions of its kernels, at the sizes of
the reference's examples (examples/*.py). Three are held to the
reference's:
  * torch_quickstart's printed table, letter for letter, against
    examples/quickstart.py's (run through runpy);
  * torch_index_corpus's index (per-root counts, postings, their order)
    against the reference's build_corpus_index on the same stream;
  * torch_serve_decode's tokens against the reference's ServeEngine on
    the same weights (the reference's init, carried across), both at fp32
    compute and caches as tests/test_torch_serve_lm.py's
    test_greedy_tokens_identical_at_fp32 runs them: identical.
The other three are held by their own checks (each exits non-zero on a
mismatch, which the mismatch tests show), and the tests assert what they
return. A subprocess imports every example and finds neither jax nor the
reference package loaded.
"""
import contextlib
import dataclasses
import importlib.util
import io
import os
import runpy
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
PORTED = ["quickstart", "serve_stemmer", "serve_text", "index_corpus",
          "serve_decode", "chaos_matrix"]
CPU = ["--device", "cpu"]


def _load(name):
    """examples/torch_<name>.py as a module (examples/ is no package)."""
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", EXAMPLES / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


def test_quickstart_table_is_the_references_letter_for_letter():
    rows, got = _stdout(lambda: _load("quickstart").main(CPU))
    _, want = _stdout(lambda: runpy.run_path(str(EXAMPLES / "quickstart.py"),
                                             run_name="__main__"))
    assert got == want
    assert len(rows) == 7 and rows[0][1] == "سقي"


def test_serve_stemmer_serves_and_checks_every_word():
    out = _load("serve_stemmer").main(CPU)
    # which version served which word depends on when launches complete
    # (the reference's CPU run prints {0: 320, 1: 160}); every word is
    # checked against stem_batch under its own version either way
    assert out["words"] == 480
    assert set(out["versions"]) == {0, 1}
    assert sum(out["versions"].values()) == 480
    assert out["retries"] == 1


def test_serve_text_checks_every_token():
    from repro.core import textnorm as rtn

    mod = _load("serve_text")
    out = mod.main(CPU)
    docs = mod.documents()
    assert out["documents"] == len(docs) == 5
    # the reference's host pipeline: the same tokens, the same spans
    assert out["tokens"] == sum(rtn.analyze_text_py(d)[0].shape[0]
                                for d in docs)
    _, want_spans = rtn.analyze_text_py(mod.ANKABUT)
    raw = mod.ANKABUT.encode("utf-8")
    assert [s for s, _, _ in out["ayah"]] == [
        raw[b0:b1].decode("utf-8") for b0, b1 in want_spans[:6]]
    assert out["ayah"][1][1] == "حسب"


def test_index_corpus_is_the_references_index():
    from repro import index as rix
    from repro.core import corpus as rcorpus
    from repro.core import stemmer as rstemmer

    mod = _load("index_corpus")
    idx = mod.main(CPU)
    d = rcorpus.build_dictionary(n_tri=800, n_quad=100, seed=0)
    arrays = rstemmer.RootDictArrays.from_rootdict(d)
    table = rcorpus.build_token_table()
    stream = rcorpus.stream_corpus_words(
        mod.N_WORDS, seed=17, chunk_words=mod.CHUNK,
        words_per_doc=mod.WORDS_PER_DOC, table=table)
    want = rix.build_corpus_index(stream, arrays, block_b=1024,
                                  block_w=1024)
    np.testing.assert_array_equal(idx.root_keys, np.asarray(want.root_keys))
    for name in ("counts", "offsets", "docs", "positions"):
        np.testing.assert_array_equal(getattr(idx, name),
                                      np.asarray(getattr(want, name)))
    assert idx.n_postings == 14053


def test_serve_decode_tokens_are_the_references_at_fp32():
    from repro import configs as rc
    from repro.models import model as rm
    from repro.models import params as rp
    from repro.serve.engine import ServeEngine as RefServeEngine
    from repro_torch.models import params as tp

    mod = _load("serve_decode")
    cfg = dataclasses.replace(rc.smoke_config(rc.get_config("llama3-8b")),
                              compute_dtype="float32")
    p = rp.init_params(rm.model_spec(cfg), jax.random.key(7))
    ref = RefServeEngine(cfg, p, max_batch=mod.SLOTS,
                         cache_len=mod.CACHE_LEN)
    ref.workload.caches = rm.init_caches(cfg, mod.SLOTS, mod.CACHE_LEN,
                                         dt=jnp.float32)
    rng = np.random.default_rng(1)
    rids = [ref.submit(rng.integers(0, cfg.vocab, mod.PROMPT),
                       max_new=mod.MAX_NEW) for _ in range(mod.N_REQUESTS)]
    ref.run_until_drained()
    want = [list(ref.result(r).tokens_out) for r in rids]

    got = mod.main(CPU + ["--dtype", "float32"],
                   params=tp.params_from_numpy(jax.tree.map(np.asarray, p),
                                               device="cpu"))
    assert got == want
    assert [len(t) for t in got] == [mod.MAX_NEW] * mod.N_REQUESTS


def test_serve_decode_runs_at_the_configs_bf16():
    tokens = _load("serve_decode").main(CPU)
    assert [len(t) for t in tokens] == [6] * 7


def test_chaos_matrix_passes_every_scenario():
    ok = _load("chaos_matrix").main(CPU)
    assert ok == ["CHAOS_DISPATCH_OK", "CHAOS_RETIRE_OK", "CHAOS_PUBLISH_OK",
                  "CHAOS_CHECKPOINT_OK", "CHAOS_QUARANTINE_OK",
                  "CHAOS_STALL_OK", "CHAOS_DEVICE_LOSS_OK",
                  "CHAOS_JOURNAL_OK"]


def _wrong_roots(fn):
    """fn with its roots' first word changed."""
    def wrong(*a, **kw):
        roots, sources = fn(*a, **kw)
        roots = roots.clone()
        roots[0, 0] += 1
        return roots, sources
    return wrong


@pytest.mark.parametrize("name", ["quickstart", "serve_stemmer",
                                  "serve_text", "index_corpus"])
def test_a_mismatch_exits_non_zero(name, monkeypatch):
    mod = _load(name)
    if name == "quickstart":      # the host algorithm disagrees
        monkeypatch.setattr(mod.pyref, "stem_word",
                            lambda w, roots: ("", mod.pyref.SRC_NONE))
    elif name == "index_corpus":  # the host reference's counts disagree
        host = mod.ix.host_index

        def wrong(*a):
            counts, docs, poss = host(*a)
            return counts + 1, docs, poss
        monkeypatch.setattr(mod.ix, "host_index", wrong)
    else:                         # the plain stem_batch disagrees
        monkeypatch.setattr(mod.stemmer, "stem_batch",
                            _wrong_roots(mod.stemmer.stem_batch))
    with pytest.raises(SystemExit) as e, contextlib.redirect_stdout(
            io.StringIO()):
        mod.main(CPU)
    assert e.value.code not in (0, None)


@pytest.mark.parametrize("name", PORTED)
def test_the_card_is_the_default(name):
    """Without --device an example asks for cuda:0 and raises where there
    is no card: it never goes on on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA"):
        _load(name).main([])


def test_examples_import_neither_jax_nor_the_reference():
    files = sorted(EXAMPLES.glob("torch_*.py"))
    assert {f.stem for f in files} >= {f"torch_{n}" for n in PORTED}
    code = (
        "import importlib.util, sys\n"
        f"for i, f in enumerate({[str(f) for f in files]!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'ex{i}', f)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith(('jax.', 'jaxlib')) or m == 'repro'"
        " or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")

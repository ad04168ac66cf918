"""The harness's pieces without a card: discovery by name, the cells'
metrics, the byte counts of the rooflines, the trace's union and gaps,
the result line, and a run that finds no card."""
import json
import shutil
from types import SimpleNamespace

import pytest

import numpy as np

from stembench import drivers, harness, peaks, stemwork
from stembench import trace as tr

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


def test_every_named_file_is_found():
    for c in BENCH["configs"]:
        path = harness.find("configs", c["name"])
        assert path.relative_to(harness.ROOT).as_posix() == c["file"]
        assert harness.load_json(path)["name"] == c["name"]
    for w in BENCH["workloads"]:
        harness.find("traffic", w["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_a_new_entry_is_found_by_name(tmp_path):
    for kind in ("configs", "traffic", "metrics"):
        (tmp_path / kind).mkdir()
    (tmp_path / "configs" / "tiny-1.json").write_text('{"name": "tiny-1"}')
    (tmp_path / "traffic" / "burst.json").write_text('{"entry": "serve"}')
    (tmp_path / "metrics" / "odd_ms.p99.py").write_text(
        "def read(run):\n    return None if run is None else 7.0\n")
    assert harness.load_json(harness.find("configs", "tiny-1", tmp_path)) \
        == {"name": "tiny-1"}
    assert harness.find("traffic", "burst", tmp_path).name == "burst.json"
    read = harness.metric_reader("odd_ms.p99", tmp_path)
    assert read(object()) == 7.0 and read(None) is None
    with pytest.raises(FileNotFoundError):
        harness.find("traffic", "missing", tmp_path)


def test_each_cell_reports_its_metrics():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(BENCH, w["name"], False)}
        layer = harness.cell_metrics(BENCH, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert layer and all(m["moves"] in e2e for m in layer)


def test_byte_counts():
    # 65,536 words of 84 bytes and a 2,230-key dictionary: bytes-bound
    words, keys = 65536, 2230
    want = (words * 84 + 4 * keys) / peaks.HBM_BYTES_S
    assert stemwork.least_s(words, 1, keys) == pytest.approx(want)
    assert stemwork.least_s(words, 2, keys) > stemwork.least_s(words, 1, keys)
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "tf", harness.find("metrics", "text_frontend_roofline"))
    tf = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tf)
    assert tf.least_s(1000, 100) == pytest.approx(
        max((4 * 1000 + 72 * 100) / peaks.HBM_BYTES_S,
            (26 * 1000 + 312 * 100) / peaks.INT32_OPS_S))
    spec = importlib.util.spec_from_file_location(
        "pk", harness.find("metrics", "postings_roofline"))
    pk = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pk)
    # an index chunk: 131,072 ids in, their ranks and one histogram over
    # 262,144 roots and the drop bin out, however K5 tiles them
    assert pk.least_s(131072, 1, 262144) == pytest.approx(
        (8 * 131072 + 4 * 262145) / peaks.HBM_BYTES_S)
    assert pk.least_s(2 * 131072, 2, 262144) == pytest.approx(
        2 * pk.least_s(131072, 1, 262144))


def _answer(roots, sources):
    return SimpleNamespace(roots=np.asarray(roots, np.int32),
                           sources=np.asarray(sources, np.int32))


def test_answers_hold_one_copy_an_entry():
    """The first sampled answer of a pool entry is kept for the reference;
    a later one is held against it in place, word by word."""
    a = drivers.Answers([3, 2], share=1.0, seed=5, text=False)
    assert sum(b.nbytes for b in a.bufs.values()) == 5 * 5 * 4
    roots = np.arange(12).reshape(3, 4)
    a.add(0, _answer(roots, [1, 2, 3]))
    a.add(0, _answer(roots, [1, 2, 3]))
    assert (a.compared, a.changed, a.bad) == (1, 0, 0)
    other = roots.copy()
    other[2, 1] += 1
    a.add(0, _answer(other, [1, 5, 3]))      # words 1 and 2 differ
    assert (a.compared, a.changed, a.bad) == (2, 2, 1)
    a.add(1, _answer(np.zeros((3, 4)), [0, 0, 0]))   # three words for two
    assert (a.misshapen, a.bad, len(a)) == (2, 2, 4)
    kept = list(a)
    assert [k for k, _ in kept] == [0]
    assert np.array_equal(kept[0][1]["roots"], roots)
    assert np.array_equal(kept[0][1]["sources"], [1, 2, 3])


class Ev:
    def __init__(self, name, a, b, cuda=False, thread=1, annotation=False):
        from torch.autograd import DeviceType
        self._n, self._a, self._b = name, a, b
        self._d = DeviceType.CUDA if cuda else DeviceType.CPU
        self._t, self._u = thread, annotation

    def name(self): return self._n
    def start_ns(self): return self._a
    def end_ns(self): return self._b
    def duration_ns(self): return self._b - self._a
    def device_type(self): return self._d
    def start_thread_id(self): return self._t
    def is_user_annotation(self): return self._u


def test_trace_union_and_gaps():
    events = [
        Ev(tr.WINDOW, 0, 1000, annotation=True),
        Ev("stembench.submit", 0, 400, annotation=True),
        Ev("aten::copy_", 100, 300),
        Ev("stembench.step", 400, 1000, annotation=True),
        Ev("k1", 300, 500, cuda=True),
        Ev("copy", 450, 600, cuda=True),           # overlaps k1
        Ev("k1", 900, 1200, cuda=True),             # runs past the window
        Ev("gpu annotation", 0, 1000, cuda=True, annotation=True),
        Ev("other thread", 0, 1000, thread=2),
    ]
    s = tr.summarize(events)
    assert s.window_s == pytest.approx(1e-6)
    assert s.busy_s == pytest.approx(400e-9)        # 300-600 and 900-1000
    assert s.kernels["k1"][0] == 2
    assert s.kernels["k1"][1] == pytest.approx(300e-9)
    assert s.gaps == pytest.approx({"aten::copy_": 300e-9,
                                    "stembench.step": 300e-9})
    b = tr.breakdown(s)
    assert [k for k, _ in b["idle_gaps"]] and len(b["device_ops"]) == 2


def test_result_line_keys():
    out = {"correct": True, "attempted": 3, "failed": 0,
           "metrics": {"words_per_s": {"value": 1.5, "unit": "words/s"}},
           "breakdown": {"device_ops": [], "idle_gaps": []},
           "checks": {"wrong_words": {"value": 0, "limit": 0}}}
    line = harness.result_line(out, {"platform": "gpu", "kind": "H100",
                                     "count": 1, "memory_peak_bytes": 1})
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert json.loads(json.dumps(line)) == line


def test_no_card_no_result(capsys):
    rc = harness.main(["--workload", "paper-words", "--seed", "1",
                       "--seconds", "1"], 0.0)
    assert rc != 0 and capsys.readouterr().out == ""


def test_forbidden_modules_are_named(monkeypatch):
    import sys
    assert harness.forbidden_modules() == [] or "jax" in sys.modules \
        or "repro" in sys.modules
    monkeypatch.setitem(sys.modules, "flax.linen", SimpleNamespace())
    assert "flax" in harness.forbidden_modules()


def test_benchmark_alone_is_not_a_result(tmp_path):
    """A checkout of only BENCHMARK.json and the harness runs nothing."""
    import subprocess
    import sys
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "stembench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "stembench/run.py", "--workload",
                        "paper-words", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""

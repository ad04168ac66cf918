"""Whole runs of each cell on the CPU at a size a test run holds (the
port's plain versions stand in for its kernels; the look for a card is
skipped): sound runs come out correct, and runs with the timed path
broken underneath (the control, and every fault the cell can have) come
out not correct."""
import time

import pytest
import torch

from stembench import faults, generate, harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = {c["name"]: c for c in BENCH["workloads"]}
SEED = 2**33 + 11


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small(name: str):
    """The cell's own files, cut to a test's size: every count, not a
    width (word rows, the dictionary's key shapes and the rules stay)."""
    cell = CELLS[name]
    cfg = harness.load_json(harness.find("configs", cell["config"]))
    tr = harness.load_json(harness.find("traffic", cell["traffic"]))
    cfg["batch_words"] = 1024
    if cfg["dictionary"].get("grow_to"):
        cfg["dictionary"]["grow_to"] = 12_000
    if tr["entry"] == "serve":
        tr.update(clients=4, request_words=256, pool_words=2048,
                  warmup_s=0.05, check_share=1.0)
        if tr["payload"] == "text":
            tr["docs_per_request"] = 4
    else:
        tr.update(corpus_words=4096, chunk_words=2048, words_per_doc=64,
                  warmup_builds=1, check_share=1.0)
        tr["build"] = {"block_b": 256, "block_w": 256}
    return cell, cfg, tr


def run(name: str, how: str | None = None, trace: bool = False) -> dict:
    cell, cfg, tr = small(name)
    kw = dict(seed=SEED, seconds=0.3, trace=trace, device="cpu",
              t0=time.perf_counter())
    if how is None:
        return harness.run_cell(BENCH, cell, cfg, tr, **kw)
    d = generate.build_dictionary(cfg["dictionary"], SEED)
    with faults.broken(tr["entry"], how, d):
        return harness.run_cell(BENCH, cell, cfg, tr, **kw)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_sound_run_is_correct(name):
    out = run(name, trace=name == "paper-text")
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert all(c["limit"] == 0 for c in out["checks"].values())
    want = {m["name"] for m in harness.cell_metrics(BENCH, name,
                                                    name == "paper-text")}
    if name == "paper-text":
        # the device metrics read nothing on the CPU: no kernel ran
        want -= {"stem_fused_roofline.serve", "text_frontend_roofline"}
        assert out["device"]["window_s"] > 0
    assert set(out["metrics"]) == want


def test_a_word_traffic_files_workload_keys_reach_the_ring():
    """A traffic mix is a file of its own: its ``workload`` keys reach the
    ring for words as for documents, with no edit of the drivers."""
    from stembench import drivers
    cell, cfg, tr = small("paper-words")
    tr["workload"] = {"num_buffers": 3}
    table = generate.build_token_table(tr["tokens"])
    d = generate.build_dictionary(cfg["dictionary"], SEED)
    serve = drivers.Serve(cfg, tr, d, table, SEED, torch.device("cpu"))
    assert serve.engine.workload.num_buffers == 3


BROKEN = ([("paper-words", h) for h in faults.SERVE[:-1]]
          + [("paper-text", h) for h in ("control", "half", "altered_span")]
          + [("lexicon-index", h) for h in faults.INDEX])


@pytest.mark.parametrize("name,how", BROKEN)
def test_broken_run_is_not_correct(name, how):
    out = run(name, how)
    assert not out["correct"]
    assert out["failed"] > 0

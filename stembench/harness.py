"""One run of one cell: set-up, the measured window, the reference's
judgement and the result line.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration in ``configs/<name>.json``, its
traffic in ``traffic/<name>.json`` and each metric's reader in
``metrics/<name>.py`` (a ``read(run)`` that returns a number, or None where
it finds nothing to read). A new cell, configuration, traffic mix or
metric is a new file and an entry, never an edit of a file here.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
# a traced run measures the untraced window first, then this share of its
# length again under the profiler
TRACED_SHARE = 0.5


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def find(kind: str, name: str, base: Path = HERE) -> Path:
    """The file of a configuration, traffic mix or metric, by its name."""
    suffix = ".py" if kind == "metrics" else ".json"
    path = base / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r} ({path})")
    return path


def metric_reader(name: str, base: Path = HERE):
    path = find("metrics", name, base)
    spec = importlib.util.spec_from_file_location(
        "stembench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: end-to-end ones untraced,
    per-layer ones traced; those naming cells only in those cells. A
    traced run reads its host-clock and counter metrics from its untraced
    window and its ``device_trace`` ones from the traced window after it,
    so the profiler's cost stays out of every host time."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def parse(argv):
    p = argparse.ArgumentParser(prog="stembench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(bench: dict, cell: dict, config: dict, traffic: dict, *,
             seed: int, seconds: float, trace: bool, device, t0: float,
             base: Path = HERE) -> dict:
    """Set up, measure, judge; -> the result line's object (without the
    device's name and memory, which only a card has)."""
    import torch

    from stembench import check, drivers, generate
    from stembench import trace as tr

    device = torch.device(device)
    phases = {"import": time.perf_counter() - t0}
    t = time.perf_counter()
    dictionary = generate.build_dictionary(config["dictionary"], seed)
    table = generate.build_token_table(traffic["tokens"])
    phases["dictionary_and_tokens"] = time.perf_counter() - t
    t = time.perf_counter()
    kind = traffic["entry"]
    driver = drivers.DRIVERS[kind](config, traffic, dictionary, table, seed,
                                   device)
    phases["inputs_and_program"] = time.perf_counter() - t
    t = time.perf_counter()
    driver.warm_up()
    phases["warm_up"] = time.perf_counter() - t
    # set-up's objects stay out of the window's garbage collections
    gc.collect()
    gc.freeze()
    windows = [driver.window(seconds)]
    if trace:
        with tr.profiled(device) as prof:
            windows.append(driver.window(seconds * TRACED_SHARE,
                                         tracing=True))
    gc.unfreeze()
    window = windows[0]
    setup_s = window.t_start - t0
    run = SimpleNamespace(kind=kind, text=traffic.get("payload") == "text",
                          config=config, traffic=traffic,
                          dictionary=dictionary, window=window,
                          traced=windows[1] if trace else None,
                          trace=prof.summary if trace else None,
                          setup_s=setup_s)
    metrics = {}
    for m in cell_metrics(bench, cell["name"], trace):
        value = metric_reader(m["name"], base)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = sum(w.work.get("requests") or w.work.get("builds")
                    for w in windows)
    out = {"metrics": metrics, "attempted": attempted,
           "setup": dict(phases, total=setup_s), "by_second": by_second(window),
           "rates": [w.done_words / w.seconds for w in windows]}
    if trace:
        out["device"] = {"busy_s": prof.summary.busy_s,
                         "window_s": prof.summary.window_s}
        out["breakdown"] = tr.breakdown(prof.summary)
    if device.type == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    # the program's state goes before the reference runs
    driver.release()
    lost = sum(w.lost for w in windows)
    numbers, failed = check.judge(kind, driver, lost, dictionary, config,
                                  seed)
    out["failed"] = failed
    out["checked"] = (f"checked {len(driver.answers)} answers of"
                      f" {attempted}; counters {window.counters}")
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in numbers.items()}
    out["correct"] = all(v <= lim for v, lim in numbers.values())
    return out


def by_second(window) -> list[int]:
    """Requests (or builds) completed in each second of the window: where
    a run's time went, for the spread's causes."""
    import numpy as np

    at = window.done_at or list(np.cumsum(window.build_s))
    return np.bincount(np.asarray(at, int)).tolist() if at else []


def result_line(out: dict, device_info: dict) -> dict:
    """The last line of standard output; ``checks`` comes last."""
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": device_info}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = out["checks"]
    return line


def main(argv, t0: float) -> int:
    args = parse(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s);"
              f" found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401  (the program under test)
    except ImportError as e:
        print(f"the program is not in this checkout: {e}", file=sys.stderr)
        return 2
    config = load_json(find("configs", cell["config"]))
    traffic = load_json(find("traffic", cell["traffic"]))
    out = run_cell(bench, cell, config, traffic, seed=args.seed,
                   seconds=args.seconds, trace=bool(args.trace),
                   device="cuda:0", t0=t0)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}; the port must not", file=sys.stderr)
        return 3
    device_info = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(0),
                   "count": cell["chips"],
                   "memory_peak_bytes": out.pop("memory_peak_bytes")}
    device_info.update(out.pop("device", {}))
    print("setup " + " ".join(f"{k} {v:.3f}" for k, v in
                              out["setup"].items()), file=sys.stderr)
    print("done by second " + " ".join(map(str, out["by_second"])),
          file=sys.stderr)
    print("words/s by window (untraced, then traced) "
          + " ".join(f"{r:.1f}" for r in out["rates"]), file=sys.stderr)
    print(out["checked"], file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result_line(out, device_info)), flush=True)
    return 0

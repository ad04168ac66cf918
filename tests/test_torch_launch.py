"""The port's entry points: the serving CLI, device selection, and the
rule that repro_torch imports neither jax nor anything of repro."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.core import corpus, stemmer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _run(*argv, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return subprocess.run([sys.executable, *argv], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=timeout)


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")


def test_cli_serves_on_cpu():
    p = _run("-m", "repro_torch.launch.serve", "--workload", "stemmer",
             "--device", "cpu", "--requests", "4", "--words-per-request",
             "64")
    assert p.returncode == 0, p.stderr
    assert re.search(r"^served 4 word-batch requests / 256 words in .* Wps,"
                     r" \d+ ticks, \d+ launches, dict v0, super-tile 1x256,"
                     r" megabatch 1, inflight 2\)$", p.stdout, re.M), p.stdout


def test_cli_persistent_and_streamed_flags_on_cpu():
    p = _run("-m", "repro_torch.launch.serve", "--workload", "stemmer",
             "--device", "cpu", "--requests", "4", "--words-per-request",
             "64", "--megabatch", "2", "--persistent", "--dict-block-r", "4",
             "--num-buffers", "1", "--full-sweep")
    assert p.returncode == 0, p.stderr
    assert re.search(r"^served 4 word-batch requests / 256 words in .*"
                     r" launches, dict v0, super-tile 1x256, megabatch 2,"
                     r" persistent, inflight 2\)$", p.stdout, re.M), p.stdout


def test_cli_serves_text_on_cpu():
    for frontend in ("kernel", "host"):
        p = _run("-m", "repro_torch.launch.serve", "--workload", "text",
                 "--device", "cpu", "--requests", "3", "--words-per-request",
                 "40", "--frontend", frontend, "--megabatch", "2",
                 "--persistent")
        assert p.returncode == 0, p.stderr
        assert re.search(r"^served 3 documents / \d+ bytes / 120 words in"
                         r" .* B/s, .* Wps, \d+ ticks, \d+ launches,"
                         rf" frontend {frontend}, megabatch 2, persistent,"
                         r" inflight 2\)$", p.stdout, re.M), p.stdout
        assert "first root" in p.stdout


def test_cli_default_device_without_cuda_raises():
    _no_cuda()
    p = _run("-m", "repro_torch.launch.serve", "--workload", "stemmer",
             "--requests", "1")
    assert p.returncode != 0
    assert "RuntimeError" in p.stderr
    assert "no CUDA device is available" in p.stderr


def test_library_default_device_without_cuda_raises():
    _no_cuda()
    d = corpus.build_dictionary(n_tri=50, n_quad=10)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        stemmer.RootDictArrays.from_rootdict(d)
    arrays = stemmer.RootDictArrays.from_rootdict(d, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        stemmer.extract_roots(np.zeros((2, 16), np.int32), arrays,
                              backend="fused")


_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), "modules;", "forbidden:", bad)
assert not bad, bad
missing = sorted(set(NEW) - set(names))
print("new modules missing:", missing)
assert not missing, missing
"""

# the modules of the text, index, staged-Compare, LM, dry-run and
# several-device slices, which the walk must reach
_NEW_MODULES = ("repro_torch.core.textnorm", "repro_torch.core.corpus",
                "repro_torch.kernels.text_frontend",
                "repro_torch.kernels.postings", "repro_torch.kernels.ops",
                "repro_torch.index", "repro_torch.index.builder",
                "repro_torch.index.reference", "repro_torch.serve.text",
                "repro_torch.launch.serve", "repro_torch.kernels.stem_match",
                "repro_torch.kernels.stem_datapath", "repro_torch.configs",
                "repro_torch.configs.paper", "repro_torch.data",
                "repro_torch.data.pipeline", "repro_torch.configs.base",
                "repro_torch.configs.llama3_8b", "repro_torch.configs.gemma_2b",
                "repro_torch.kernels.flash_attention", "repro_torch.models",
                "repro_torch.models.params", "repro_torch.models.layers",
                "repro_torch.models.attention", "repro_torch.models.blocks",
                "repro_torch.models.model", "repro_torch.launch.input_specs",
                "repro_torch.launch.dryrun", "repro_torch.launch.mesh",
                "repro_torch.dist", "repro_torch.dist.sharding",
                "repro_torch.dist.shard_batch", "repro_torch.dist.pipeline",
                "repro_torch.dist.compression")


def test_port_imports_without_jax_or_repro():
    p = _run("-c", f"NEW = {_NEW_MODULES!r}\n" + _IMPORT_ALL)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "forbidden: []" in p.stdout
    assert "new modules missing: []" in p.stdout


def test_port_sources_never_import_jax_or_repro():
    forbidden = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)[\s.])",
                           re.M)
    files = sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "chip_ab.py",
        ROOT / "chip_moe_prefill.py", ROOT / "chip_train_recipe.py",
    ] + sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(files) > 10
    for f in files:
        m = forbidden.search(f.read_text())
        assert m is None, f"{f}: {m.group(0)!r}"

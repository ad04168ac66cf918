"""Builds the port's native code from the sources in ``kernels/csrc``.

CUDA kernels are compiled with ``nvcc`` for ``sm_90a`` into shared
libraries with a plain C interface and loaded with ``ctypes``; no
PyTorch headers are involved, so a build takes seconds. Outputs go to
``build/repro_torch/`` at the root of the checkout, named by a digest of
the sources, the generated headers and the flags, so a changed source
rebuilds and an unchanged one loads the library already built. Builds
run under a file lock: parallel test workers or processes build once.

``host_datapath`` compiles the ``__host__ __device__`` headers (the
datapath, the streamed fence search, the resident kernels' walk and lane
split, the text front end's per-word rules, the
postings instances' tile steps, the comparator bank's banks and the
sorted search's fence tree) with
``g++`` for the CPU tests; nothing on the port's CPU path uses it.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from repro_torch.core import alphabet as ab

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")


def _mask(codes) -> str:
    m = 0
    for c in codes:
        if not 0 <= int(c) < 64:
            raise ValueError(f"letter code {c} outside the 6-bit range")
        m |= 1 << int(c)
    return f"0x{m:016x}ull"


def codes_header() -> str:
    """stem_codes.h: the affix code sets, letter codes, candidate-group
    tables and the sorted layout's sentinel, generated from
    ``core.alphabet``, ``kernels.stem_fused`` and ``kernels.stem_match``."""
    from repro_torch.kernels import stem_fused as sf
    from repro_torch.kernels import stem_match as sm

    tables = {"tri": 0, "quad": 1, "bi": 2}

    def select(values) -> str:
        expr = str(int(values[-1]))
        for g in range(len(values) - 2, -1, -1):
            expr = f"g == {g} ? {int(values[g])} : {expr}"
        return expr

    dicts = [tables[name] for name in sf.GROUP_DICTS]
    return "\n".join([
        "// Generated from repro_torch/core/alphabet.py,",
        "// repro_torch/kernels/stem_fused.py and stem_match.py by",
        "// kernels/build.py.",
        "#pragma once",
        "#include <stdint.h>",
        "#ifdef __CUDACC__",
        "#define RT_CODES_HD __host__ __device__ __forceinline__",
        "#else",
        "#define RT_CODES_HD inline",
        "#endif",
        f"#define RT_MAXLEN {ab.MAXLEN}",
        f"#define RT_DICT_SENTINEL {sm.DICT_SENTINEL}",
        f"#define RT_ALEF {int(ab.ALEF)}",
        f"#define RT_WAW {int(ab.WAW)}",
        f"#define RT_YEH {int(ab.YEH)}",
        f"#define RT_PREFIX_MASK {_mask(ab.PREFIX_CODES)}",
        f"#define RT_SUFFIX_MASK {_mask(ab.SUFFIX_CODES)}",
        f"#define RT_INFIX_MASK {_mask(ab.INFIX_CODES)}",
        "// candidate group g -> table (0 tri, 1 quad, 2 bi) and source tag",
        f"RT_CODES_HD int rt_group_dict(int g) {{ return {select(dicts)}; }}",
        "RT_CODES_HD int32_t rt_group_tag(int g) {"
        f" return {select(sf.GROUP_TAGS)}; }}",
        "",
    ])


def text_header() -> str:
    """text_codes.h: the text front end's windows and clitic tables,
    generated from ``core.textnorm``."""
    from repro_torch.core import textnorm as tn

    def patterns(pats) -> str:
        rows = []
        for pat in pats:
            if not 1 <= len(pat) <= 3:
                raise ValueError(f"clitic {pat} outside 1..3 letters")
            codes = list(pat) + [0] * (3 - len(pat))
            rows.append("{" + ", ".join(str(int(c)) for c in
                                        [len(pat)] + codes) + "}")
        return "{" + ", ".join(rows) + "}"

    return "\n".join([
        "// Generated from repro_torch/core/textnorm.py by kernels/build.py.",
        "#pragma once",
        f"#define RT_TEXT_MAX_RAW {tn.MAX_RAW}",
        f"#define RT_TEXT_CMAX {tn.CMAX}",
        f"#define RT_TEXT_MIN_STEM {tn.MIN_STEM}",
        f"#define RT_TEXT_FW_MAXLEN {tn.FW_MAXLEN}",
        f"#define RT_TEXT_MAX_PRO {max(len(p) for p in tn.PROCLITIC_CODES)}",
        f"#define RT_TEXT_N_PRO {len(tn.PROCLITIC_CODES)}",
        f"#define RT_TEXT_N_ENC {len(tn.ENCLITIC_CODES)}",
        "// {length, code 0, code 1, code 2} per clitic, longest first",
        f"#define RT_TEXT_PROCLITICS {patterns(tn.PROCLITIC_CODES)}",
        f"#define RT_TEXT_ENCLITICS {patterns(tn.ENCLITIC_CODES)}",
        "",
    ])


def generated_headers() -> dict[str, str]:
    """Every header the build generates, by file name."""
    return {"stem_codes.h": codes_header(), "text_codes.h": text_header()}


@dataclass(frozen=True)
class _Spec:
    name: str
    source: str                 # file under csrc/
    compiler: tuple             # argv prefix
    out_dir: Path

    def digest(self, headers: dict) -> str:
        h = hashlib.sha256()
        for part in (self.compiler, sorted(headers.items())):
            h.update(repr(part).encode())
        for f in sorted(CSRC.iterdir()):
            if f.suffix in (".cu", ".cuh", ".cpp", ".h"):
                h.update(f.name.encode())
                h.update(f.read_bytes())
        return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(found, os.X_OK):
        raise RuntimeError("repro_torch: nvcc not found (PATH or"
                           " /usr/local/cuda/bin); the CUDA kernels are"
                           " built from source at first use")
    return found


def _cuda_spec(name: str, lanes: int = 0) -> _Spec:
    if not lanes:
        return _Spec(name, f"{name}.cu", (_nvcc(),) + NVCC_FLAGS, BUILD_DIR)
    return _Spec(f"{name}_lanes{lanes}", f"{name}.cu",
                 (_nvcc(),) + NVCC_FLAGS + (f"-DRT_FORCED_LANES={lanes}",),
                 BUILD_DIR / "forced")


def _host_spec() -> _Spec:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("repro_torch: g++ not found for the host build")
    return _Spec("host_datapath", "host_datapath.cpp", (gxx,) + GXX_FLAGS,
                 BUILD_DIR / "host")


# loaded libraries by name: a process builds (or finds) and loads each once
_LOADED: dict[str, ctypes.CDLL] = {}


def _build(specs: list[_Spec]) -> list[Path]:
    """Compile every spec whose library is missing, all compilers started
    together; -> the library paths. Each build holds its lock file until
    its compiler has finished; compiler output goes to a .log beside each
    library."""
    headers = generated_headers()
    paths, failed = [], []
    with contextlib.ExitStack() as stack:
        jobs = []
        for spec in specs:
            spec.out_dir.mkdir(parents=True, exist_ok=True)
            lib = spec.out_dir / f"lib{spec.name}-{spec.digest(headers)}.so"
            paths.append(lib)
            if lib.exists():
                continue
            lock = stack.enter_context(
                open(spec.out_dir / f"{spec.name}.lock", "w"))
            fcntl.flock(lock, fcntl.LOCK_EX)
            if lib.exists():             # another process built it
                continue
            gen = spec.out_dir / f"gen-{lib.stem}"
            gen.mkdir(exist_ok=True)
            for fname, text in headers.items():
                (gen / fname).write_text(text)
            tmp = lib.with_suffix(f".tmp{os.getpid()}")
            argv = [*spec.compiler, "-I", str(gen), "-I", str(CSRC),
                    "-o", str(tmp), str(CSRC / spec.source)]
            log = stack.enter_context(open(lib.with_suffix(".log"), "w"))
            proc = stack.enter_context(subprocess.Popen(
                argv, stdout=log, stderr=subprocess.STDOUT))
            jobs.append((proc, tmp, lib, argv))
        for proc, tmp, lib, argv in jobs:
            rc = proc.wait()
            if rc == 0:
                os.replace(tmp, lib)
            else:
                failed.append((lib, f"{' '.join(argv)} (exit {rc})"))
    if failed:
        raise RuntimeError("repro_torch: kernel build failed:\n" + "\n".join(
            f"{cmd}:\n{lib.with_suffix('.log').read_text()[-4000:]}"
            for lib, cmd in failed))
    return paths


CUDA_LIBRARIES = ("stem_fused", "stem_streamed", "stem_persistent",
                  "text_frontend", "postings", "stem_candidates",
                  "dict_match", "flash_attention")


def build_cuda(forced_lanes: tuple = (), forced_text_lanes: tuple = ()
               ) -> tuple[float, dict[str, Path]]:
    """Build every CUDA library of the port in parallel, and the
    measurement builds of K1 at each of ``forced_lanes`` and of K4 at each
    of ``forced_text_lanes`` (see :func:`forced_lanes_library`,
    :func:`forced_text_lanes_library`); -> (seconds, {name: library
    path}). Zero-cost when all are already built."""
    t0 = time.perf_counter()
    specs = [_cuda_spec(n) for n in CUDA_LIBRARIES]
    specs += [_cuda_spec("stem_fused", g) for g in forced_lanes]
    specs += [_cuda_spec("text_frontend", g) for g in forced_text_lanes]
    paths = _build(specs)
    return time.perf_counter() - t0, {s.name: p
                                      for s, p in zip(specs, paths)}


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_IP = ctypes.POINTER(_I)
# C signatures of each library's launch functions
_SIGNATURES = {
    "stem_fused": {
        "stem_fused_launch": [_P, _I, _P, _I, _P, _I, _P, _I, _P, _P, _I, _I,
                              _I, _I, _P],
        "stem_fused_last_shape": [_IP, _IP, _IP]},
    "stem_streamed": {
        "stem_streamed_launch": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                                 _I, _I, _P, ctypes.POINTER(_I)]},
    "stem_persistent": {
        "persistent_resident_launch": [_P, _I, _P, _I, _P, _I, _P, _I, _P,
                                       _I, _P, _P, _P, _P, _I, _I, _I, _I,
                                       _P, _IP],
        "persistent_flags_alloc": [_I, ctypes.POINTER(_P),
                                   ctypes.POINTER(_P)],
        "persistent_flags_free": [_P],
        "persistent_resident_last_shape": [_IP, _IP, _IP],
        "persistent_streamed_launch": [_P, _I, _P, _I, _P, _P, _I, _I, _I,
                                       _I, _I, _P, _P, _P, _I, _I, _I, _P,
                                       ctypes.POINTER(_I)]},
    "text_frontend": {
        "text_frontend_launch": [_P, _LL, _P, _P, _I, _P, _P, _I, _P, _I,
                                 _P],
        "text_frontend_last_shape": [_IP, _IP]},
    "postings": {"postings_launch": [_P, _I, _I, _I, _P, _P, _P, _I, _P],
                 "postings_instance": [_I, _I, _I]},
    "stem_candidates": {"stem_candidates_launch": [_P, _I, _P, _P, _I, _P]},
    "dict_match": {
        "dict_match_bank_launch": [_P, _I, _P, _I, _I, _P, _I, _P],
        "dict_match_bsearch_launch": [_P, _I, _P, _I, _I, _P, _P],
        "dict_bsearch_last_shape": [_IP, _IP, _IP, _IP]},
    "flash_attention": {
        "flash_attention_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   ctypes.c_float, _P],
        "flash_attention_instance": [_I, _I]},
}


def _cuda_library(name: str, lanes: int = 0) -> ctypes.CDLL:
    """CUDA library ``name`` with its C signatures declared and its error
    string function as ``error_string``; built on first use (a launch
    only looks it up: no compiler search, no digest)."""
    key = f"{name}_lanes{lanes}" if lanes else name
    lib = _LOADED.get(key)
    if lib is None:
        spec = _cuda_spec(name, lanes)
        (path,) = _build([spec])
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.error_string = getattr(lib, f"{name}_error_string")
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _LOADED[key] = lib
    return lib


def stem_fused_library() -> ctypes.CDLL:
    """K1, the resident megakernel (csrc/stem_fused.cu)."""
    return _cuda_library("stem_fused")


def forced_lanes_library(lanes: int) -> ctypes.CDLL:
    """A measurement build of K1 (csrc/stem_fused.cu with
    -DRT_FORCED_LANES) whose every launch splits a word across ``lanes``
    lanes (1, 2, 4 or 8), whatever the launcher's rule picks; for timing
    the rule's choices at one shape. Nothing in the port loads it."""
    if lanes not in (1, 2, 4, 8):
        raise ValueError(f"lanes must be 1, 2, 4 or 8, got {lanes}")
    return _cuda_library("stem_fused", lanes)


def stem_streamed_library() -> ctypes.CDLL:
    """K2, the streamed megakernel (csrc/stem_streamed.cu)."""
    return _cuda_library("stem_streamed")


def stem_persistent_library() -> ctypes.CDLL:
    """K3, the persistent kernel's two variants (csrc/stem_persistent.cu)."""
    return _cuda_library("stem_persistent")


def text_frontend_library() -> ctypes.CDLL:
    """K4, the text front end (csrc/text_frontend.cu)."""
    return _cuda_library("text_frontend")


def forced_text_lanes_library(lanes: int) -> ctypes.CDLL:
    """A measurement build of K4 (csrc/text_frontend.cu with
    -DRT_FORCED_LANES) whose every launch runs a word on ``lanes`` lanes
    (one of TEXT_LANES), whatever the launcher's rule picks; for timing
    the rule's choices at one shape. Nothing in the port loads it."""
    if lanes not in TEXT_LANES:
        raise ValueError(f"lanes must be one of {TEXT_LANES}, got {lanes}")
    return _cuda_library("text_frontend", lanes)


def postings_library() -> ctypes.CDLL:
    """K5, the postings reduction, both instances (csrc/postings.cu)."""
    return _cuda_library("postings")


def stem_candidates_library() -> ctypes.CDLL:
    """K6, the standalone datapath (csrc/stem_candidates.cu)."""
    return _cuda_library("stem_candidates")


def dict_match_library() -> ctypes.CDLL:
    """K7 and K8, the comparator bank and the sorted search
    (csrc/dict_match.cu)."""
    return _cuda_library("dict_match")


def flash_attention_library() -> ctypes.CDLL:
    """K9, fused softmax attention (csrc/flash_attention.cu)."""
    return _cuda_library("flash_attention")


def _host_library() -> ctypes.CDLL:
    lib = _LOADED.get("host_datapath")
    if lib is None:
        (path,) = _build([_host_spec()])
        lib = ctypes.CDLL(str(path))
        lib.host_candidate_columns.argtypes = [_P, _I, _P, _P]
        lib.host_candidate_columns.restype = None
        lib.host_stem_streamed.argtypes = [_P, _I, _P, _P, _I, _I, _I, _I,
                                           _I, _I, _I, _P, _P]
        lib.host_stem_streamed.restype = None
        lib.host_resident_walk.argtypes = [_LL, _I, _I, _I, _I, _I, _I, _P]
        lib.host_resident_walk.restype = None
        lib.host_stem_resident.argtypes = [_P, _I, _P, _I, _P, _I, _P, _I,
                                           _P, _I, _P, _P, _P, _I, _I, _I,
                                           _I, _I]
        lib.host_stem_resident.restype = ctypes.c_int
        lib.host_text_frontend.argtypes = [_P, _LL, _P, _P, _I, _P, _P, _I,
                                           _I, _P]
        lib.host_text_frontend.restype = ctypes.c_int
        lib.host_text_lanes.argtypes = [_LL, _I]
        lib.host_text_lanes.restype = ctypes.c_int
        lib.host_postings.argtypes = [_P, _I, _I, _I, _P, _P]
        lib.host_postings.restype = None
        lib.host_postings_counting.argtypes = [_P, _I, _I, _I, _I, _P, _P]
        lib.host_postings_counting.restype = None
        lib.host_postings_instance.argtypes = [_I, _I, _I]
        lib.host_postings_instance.restype = ctypes.c_int
        lib.host_postings_slice_bins.argtypes = [_I, _I, _I]
        lib.host_postings_slice_bins.restype = ctypes.c_int
        lib.host_dict_bank.argtypes = [_P, _I, _P, _I, _I, _I, _P]
        lib.host_dict_bank.restype = None
        lib.host_dict_bsearch.argtypes = [_P, _I, _P, _I, _I, _I, _I, _P]
        lib.host_dict_bsearch.restype = ctypes.c_int
        lib.host_bsearch_instance.argtypes = [_I]
        lib.host_bsearch_instance.restype = ctypes.c_int
        _LOADED["host_datapath"] = lib
    return lib


def host_candidate_columns(words: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The g++ build of stem_datapath.cuh: words int32[n, 16] ->
    (keys int32[n, 30], valid int32[n, 30])."""
    lib = _host_library()
    w = _host_words(words)
    n = w.shape[0]
    keys = np.zeros((n, 30), np.int32)
    valid = np.zeros((n, 30), np.int32)
    lib.host_candidate_columns(w.ctypes.data, n, keys.ctypes.data,
                               valid.ctypes.data)
    return keys, valid


def host_stem_streamed(words: np.ndarray, stream: np.ndarray,
                       fences: np.ndarray, *, n_groups: int, match: int,
                       dict_block_r: int, fence_step: int, counts
                       ) -> tuple[np.ndarray, np.ndarray]:
    """The g++ build of stem_fences.cuh, word by word as the streamed
    kernels search: words int32[n, 16], the DictTileSet stream and fences
    (step ``fence_step``, tables of ``counts`` tiles), match 0 = bsearch,
    1 = bank -> (root int32[n, 4], source int32[n])."""
    lib = _host_library()
    w = _host_words(words)
    stream = np.ascontiguousarray(stream, dtype=np.int32).reshape(-1)
    fences = np.ascontiguousarray(fences, dtype=np.int32).reshape(-1)
    tile_n = dict_block_r * 128
    log2f = fence_step.bit_length() - 1
    n_fences = sum(-(-c * tile_n // fence_step) for c in counts)
    if (stream.size != sum(counts) * tile_n or fence_step != 1 << log2f
            or fence_step < 8 or fences.size != n_fences):
        raise ValueError(f"stream of {stream.size} entries and {fences.size}"
                         f" fences do not match {counts} tiles of {tile_n}"
                         f" at a fence step of {fence_step}")
    n = w.shape[0]
    root = np.zeros((n, 4), np.int32)
    source = np.zeros((n,), np.int32)
    lib.host_stem_streamed(w.ctypes.data, n, stream.ctypes.data,
                           fences.ctypes.data, *counts, tile_n, log2f,
                           n_groups, match, root.ctypes.data,
                           source.ctypes.data)
    return root, source


WALK_FIELDS = ("lanes", "width", "per", "parts", "n_items", "grid",
               "stride")


def host_resident_walk(words: int, n_tiles: int, block_b: int,
                       capacity: int, *, sms: int, persistent: bool,
                       lanes: int = 0) -> dict:
    """The walk a resident launch takes (csrc/stem_resident.cuh), from the
    g++ build, on a card of ``sms`` SMs: K1's over ``words`` words (one
    tile, a block an item; ``n_tiles``, ``block_b`` and ``capacity`` are
    not read) or K3's (``persistent``: ``n_tiles`` tiles of ``block_b``,
    ``capacity`` resident blocks); ``lanes`` 0 for the launcher's rule ->
    {lanes, width, per, parts, n_items, grid, stride}."""
    out = np.zeros(len(WALK_FIELDS), np.int32)
    _host_library().host_resident_walk(words, n_tiles, block_b, capacity,
                                       sms, int(persistent), lanes,
                                       out.ctypes.data)
    return dict(zip(WALK_FIELDS, (int(v) for v in out)))


def host_stem_resident(words: np.ndarray, tables, *, n_groups: int,
                       match: int, block_b: int, lanes: int, capacity: int,
                       desc: np.ndarray | None = None):
    """The g++ build of stem_resident.cuh, run as a resident launch on the
    card runs it: block by block through the walk, each word's live slots
    split across ``lanes`` lanes (1, 2, 4 or 8) and the lanes' votes taken
    in lane order. words int32[n, 16], the padded (tri, quad, bi) tables of
    ``match`` (0 bsearch, 1 bank) -> (root int32[n, 4], source int32[n],
    blocks) for K1, or with ``desc`` int32[n_desc, 3] (K3's ring) (root,
    source, flags int32[n_desc], blocks). Rows no tile covers keep -7."""
    lib = _host_library()
    w = _host_words(words)
    tabs = [np.ascontiguousarray(t, dtype=np.int32).reshape(-1)
            for t in tables]
    if lanes not in (1, 2, 4, 8) or capacity < 1 or block_b < 1:
        raise ValueError(f"lanes={lanes}, capacity={capacity},"
                         f" block_b={block_b}")
    n = w.shape[0]
    root = np.full((n, 4), -7, np.int32)
    source = np.full((n,), -7, np.int32)
    ring = None if desc is None else np.ascontiguousarray(desc, np.int32)
    flags = np.zeros((0 if ring is None else ring.shape[0],), np.int32)
    blocks = lib.host_stem_resident(
        w.ctypes.data, n, None if ring is None else ring.ctypes.data,
        0 if ring is None else ring.shape[0],
        *(x for t in tabs for x in (t.ctypes.data, t.size)),
        root.ctypes.data, source.ctypes.data, flags.ctypes.data, block_b,
        n_groups, match, lanes, capacity)
    return (root, source, blocks) if ring is None else (root, source, flags,
                                                        blocks)


TEXT_LANES = (1, 8)


def host_text_frontend(chars: np.ndarray, starts: np.ndarray,
                       lens: np.ndarray, *, lanes: int = 1) -> np.ndarray:
    """The g++ build of text_frontend.cuh, run as a K4 launch at ``lanes``
    lanes a word (one of TEXT_LANES) runs it: block by block through the
    piece walk, live rows listed and run a word a group (the kernel's
    ``lane_word`` over the host's group policy, each vote and shuffle over
    the lanes in order), empty rows cleared:
    chars int32[t], starts/lens int32[wp] -> words int32[wp, 16]. A row no
    block wrote would keep -7."""
    from repro_torch.core import textnorm as tn

    lib = _host_library()
    chars = np.ascontiguousarray(chars, dtype=np.int32)
    starts = np.ascontiguousarray(starts, dtype=np.int32)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    if chars.ndim != 1 or chars.size == 0 or starts.shape != lens.shape:
        raise ValueError(f"chars {chars.shape}, starts {starts.shape}, lens"
                         f" {lens.shape}: want a non-empty tile and"
                         " matching geometry")
    if lanes not in TEXT_LANES:
        raise ValueError(f"lanes must be one of {TEXT_LANES}, got {lanes}")
    lut = np.ascontiguousarray(tn.CLASS_LUT, dtype=np.int32)
    fw = np.ascontiguousarray(tn.FW_FLAT, dtype=np.int32)
    words = np.full((starts.shape[0], ab.MAXLEN), -7, np.int32)
    lib.host_text_frontend(chars.ctypes.data, chars.size, starts.ctypes.data,
                           lens.ctypes.data, starts.shape[0], lut.ctypes.data,
                           fw.ctypes.data, fw.size, lanes, words.ctypes.data)
    return words


def host_text_lanes(rows: int, *, sms: int) -> int:
    """The lanes a word K4's launcher takes for ``rows`` rows on a card of
    ``sms`` SMs (the g++ build of ``tf::frontend_lanes``)."""
    return _host_library().host_text_lanes(rows, sms)


# postings.cuh's instance numbers (pk::Instance)
POSTINGS_INSTANCES = ("bitonic", "counting", "sliced")


def host_postings(ids: np.ndarray, *, n_roots: int, block_w: int,
                  instance: str = "bitonic") -> tuple[np.ndarray, np.ndarray]:
    """The g++ build of postings.cuh, tile by tile, through ``instance``
    ("bitonic": the network stage by stage and the searches; "counting"
    and "sliced": the blocks of each tile's slices one after another, each
    block's warps' counters, each 32-lane group in lane order; counting is
    the one-slice case): padded ids int32[n_tiles * block_w] -> (hist
    int32[n_tiles, n_roots + 1], rank int32[n_tiles * block_w])."""
    lib = _host_library()
    ids = np.ascontiguousarray(ids, dtype=np.int32).reshape(-1)
    if block_w < 1 or block_w & (block_w - 1) or ids.size % block_w:
        raise ValueError(f"{ids.size} ids are not whole tiles of a pow2"
                         f" block_w={block_w}")
    n_tiles = ids.size // block_w
    hist = np.zeros((n_tiles, n_roots + 1), np.int32)
    rank = np.zeros(ids.size, np.int32)
    args = (ids.ctypes.data, n_tiles, block_w, n_roots + 1)
    if instance == "bitonic":
        lib.host_postings(*args, hist.ctypes.data, rank.ctypes.data)
    else:
        lib.host_postings_counting(*args, POSTINGS_INSTANCES.index(instance),
                                   hist.ctypes.data, rank.ctypes.data)
    return hist, rank


def host_postings_instance(*, n_roots: int, block_w: int,
                           max_smem: int) -> str:
    """The instance postings.cuh's rule picks for a shape."""
    i = _host_library().host_postings_instance(block_w, n_roots + 1,
                                               max_smem)
    return POSTINGS_INSTANCES[i]


def host_postings_slice_bins(*, n_roots: int, block_w: int,
                             instance: str) -> int:
    """The bins a block of the counting or sliced instance counts
    (postings.cuh's ``slice_bins``)."""
    return _host_library().host_postings_slice_bins(
        POSTINGS_INSTANCES.index(instance), block_w, n_roots + 1)


def host_dict_bank(keys: np.ndarray, dict_keys: np.ndarray, *, rp: int,
                   chunk: int) -> np.ndarray:
    """The g++ build of dict_bank.cuh, run as one block of K7 runs it:
    keys int32[n] against dict_keys int32[r] padded with -2 to ``rp``
    entries, banked ``chunk`` entries at a time -> bool[n]."""
    lib = _host_library()
    keys = np.ascontiguousarray(keys, dtype=np.int32).reshape(-1)
    table = np.ascontiguousarray(dict_keys, dtype=np.int32).reshape(-1)
    if rp < table.size:
        raise ValueError(f"rp={rp} is below the table's {table.size}")
    out = np.zeros(keys.size, np.uint8)
    lib.host_dict_bank(keys.ctypes.data, keys.size, table.ctypes.data,
                       table.size, rp, chunk, out.ctypes.data)
    return out.astype(bool)


def host_bsearch_instance(rp: int) -> str:
    """K8's instance for a table padded to ``rp`` entries, as its launcher
    picks it (the g++ build of ``ds::instance``): "shared" or "global"."""
    from repro_torch.kernels import stem_match as sm

    return sm.BSEARCH_INSTANCES[_host_library().host_bsearch_instance(rp)]


def host_dict_bsearch(keys: np.ndarray, dict_keys: np.ndarray, *,
                      instance: str, grid: int = 1) -> tuple[np.ndarray, int]:
    """The g++ build of dict_search.cuh, run as a block of K8's
    ``instance`` ("shared": the whole padded table as a tree in shared
    memory; "global": a tree of every S-th entry, S by a launch of
    ``grid`` blocks over these keys, the dictionary and its padding read
    virtually) runs it: keys int32[n] against the sorted dict_keys
    int32[r] padded with the sentinel to the next power of two >= 128 ->
    (bool[n], log2 S)."""
    from repro_torch.kernels import stem_match as sm

    lib = _host_library()
    keys = np.ascontiguousarray(keys, dtype=np.int32).reshape(-1)
    table = np.ascontiguousarray(dict_keys, dtype=np.int32).reshape(-1)
    out = np.zeros(keys.size, np.uint8)
    log2s = lib.host_dict_bsearch(
        keys.ctypes.data, keys.size, table.ctypes.data, table.size,
        sm.sorted_padded(table.size), sm.BSEARCH_INSTANCES.index(instance),
        grid, out.ctypes.data)
    return out.astype(bool), log2s


def _host_words(words: np.ndarray) -> np.ndarray:
    w = np.ascontiguousarray(words, dtype=np.int32)
    if w.ndim != 2 or w.shape[1] != ab.MAXLEN:
        raise ValueError(f"words must be [n, {ab.MAXLEN}], got {w.shape}")
    return w

"""Stages 1-4 of the stemmer datapath, in plain PyTorch.

The counterpart of ``repro.kernels.stem_datapath.candidate_columns``: per
word it runs check, produce (masking networks), generate (truncation
grid), filter, the infix transforms and key packing, giving 30 packed
candidate keys and validity flags. The CUDA megakernel runs the same
per-word logic from ``csrc/stem_datapath.cuh``; this module is its plain
version, which the CPU path and the tests use.

The standalone datapath kernel (K6) runs stages 1-4 alone and writes the
candidates to device memory, for the staged Compare path
(``ops.stem_candidates``, ``ops.extract_roots_multilaunch``):

  stem_datapath_plain  the plain PyTorch version (the CPU path)
  stem_datapath_cuda   the CUDA kernel, ``csrc/stem_candidates.cu``
                       (replaces ``repro/kernels/stem_datapath.py:121``,
                       ``_datapath_kernel``), one thread per word over the
                       same ``csrc/stem_datapath.cuh`` functions K1 runs
  stem_datapath        takes the kernel for a CUDA tensor and the plain
                       version for a CPU tensor

Each writes ``keys, valid int32[B, 32]``: the 30 slots below, then two
zero pad columns.

Candidate layout (30 slots), matching ``core.stemmer`` group order:
  [ 0: 6)  trilateral     (dict: tri)
  [ 6:12)  quadrilateral  (dict: quad)
  [12:18)  restored ا→و   (dict: tri)
  [18:24)  remove-infix quad→tri (dict: tri)
  [24:30)  remove-infix tri→bi   (dict: bi)
"""
from __future__ import annotations

import torch

from repro_torch.core import alphabet as ab

N_GROUPS = 5
N_CAND = 6
N_OUT = 32  # 30 candidates padded to a power-of-two minor dim


def _member(x: torch.Tensor, codes) -> torch.Tensor:
    """Unrolled membership test against a static code list (OR-chain)."""
    hit = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    for c in codes:
        hit |= x == int(c)
    return hit


def pack(c0, c1, c2, c3):
    return ((c0 * 64 + c1) * 64 + c2) * 64 + c3


def candidate_columns(w: torch.Tensor):
    """w int32[bb, 16] -> (key_cols, val_cols): two lists of 30 int32[bb]
    columns in the group order documented above."""
    bb = w.shape[0]
    in_word = w != 0
    nn = in_word.to(torch.int32).sum(dim=1)

    # ---- stage 1+2: prefix run (unrolled AND chain + ي terminator) -------
    pp_cols = []
    run = torch.ones((bb,), dtype=torch.bool, device=w.device)
    seen_yeh = torch.zeros_like(run)
    for i in range(5):
        ci = w[:, i]
        run = run & _member(ci, ab.PREFIX_CODES) & ~seen_yeh
        pp_cols.append(run)
        seen_yeh = seen_yeh | (ci == int(ab.YEH))

    # ---- stage 1+2: suffix run anchored at the word end ------------------
    is_suf = _member(w, ab.SUFFIX_CODES) | ~in_word
    ps_cols = [None] * ab.MAXLEN
    run = torch.ones((bb,), dtype=torch.bool, device=w.device)
    for j in range(ab.MAXLEN - 1, -1, -1):
        run = run & is_suf[:, j]
        ps_cols[j] = run

    def valid_s(s: int) -> torch.Tensor:
        # valid suffix start s in 0..16: s == n (no suffix) or run holds at s
        if s >= ab.MAXLEN:
            return nn == s
        return (nn == s) | ((s < nn) & ps_cols[s] & in_word[:, s])

    # ---- stages 3+4: truncation grid + filter + pack ---------------------
    zero = torch.zeros((bb,), dtype=torch.int32, device=w.device)
    waw = torch.full_like(zero, int(ab.WAW))
    tri_k, tri_v, quad_k, quad_v = [], [], [], []
    rest_k, rest_v, dq_k, dq_v, dt_k, dt_v = [], [], [], [], [], []
    for p in range(-1, 5):
        start = p + 1
        p_ok = torch.ones_like(run) if p == -1 else pp_cols[p]
        c = [w[:, start + k] for k in range(4)]

        tv = p_ok & valid_s(p + 4)
        tri_k.append(pack(c[0], c[1], c[2], zero))
        tri_v.append(tv)
        qv = p_ok & valid_s(p + 5)
        quad_k.append(pack(c[0], c[1], c[2], c[3]))
        quad_v.append(qv)

        # infix transforms (paper Figs 18-19) in the same pass
        rest_k.append(pack(c[0], waw, c[2], zero))
        rest_v.append(tv & (c[1] == int(ab.ALEF)))
        is_inf = _member(c[1], ab.INFIX_CODES)
        dq_k.append(pack(c[0], c[2], c[3], zero))
        dq_v.append(qv & is_inf)
        dt_k.append(pack(c[0], c[2], zero, zero))
        dt_v.append(tv & is_inf)

    key_cols = [k.to(torch.int32)
                for k in tri_k + quad_k + rest_k + dq_k + dt_k]
    val_cols = [v.to(torch.int32)
                for v in tri_v + quad_v + rest_v + dq_v + dt_v]
    return key_cols, val_cols


# ---------------------------------------------------------------------------
# the standalone datapath kernel (K6)
# ---------------------------------------------------------------------------
def _check_block_b(block_b: int) -> None:
    if block_b < 1:
        raise ValueError(f"block_b must be >= 1, got {block_b}")


def stem_datapath_plain(words: torch.Tensor, *, block_b: int = 256):
    """K6's plain PyTorch version, on any device: words int32[B,16] ->
    (keys int32[B,32], valid int32[B,32]), 30 slots and two zero pads.
    Each row depends on its word alone, so the kernel's tile (block_b)
    does not change the result."""
    _check_block_b(block_b)
    key_cols, val_cols = candidate_columns(words)
    zero = torch.zeros((words.shape[0],), dtype=torch.int32,
                       device=words.device)
    return (torch.stack(key_cols + [zero, zero], dim=1),
            torch.stack(val_cols + [zero, zero], dim=1))


def stem_datapath_cuda(words: torch.Tensor, *, block_b: int = 256):
    """Launch K6 (``csrc/stem_candidates.cu``) on the current stream: same
    contract as :func:`stem_datapath_plain`, for CUDA tensors. Adds one to
    ``stem_datapath_cuda.launches`` per launch."""
    from repro_torch.kernels import build  # lazy: builds at first launch
    from repro_torch.kernels import stem_fused as sf  # lazy: sf imports us

    dev = sf._check_words(words, block_b)
    b = words.shape[0]
    keys = torch.empty((b, N_OUT), dtype=torch.int32, device=dev)
    valid = torch.empty((b, N_OUT), dtype=torch.int32, device=dev)
    if b == 0:
        return keys, valid
    lib = build.stem_candidates_library()
    with torch.cuda.device(dev):
        err = lib.stem_candidates_launch(words.data_ptr(), b,
                                         keys.data_ptr(), valid.data_ptr(),
                                         block_b, sf._cuda_stream(dev))
    sf._raise_on(err, lib, "stem_candidates")
    stem_datapath_cuda.launches += 1
    return keys, valid


stem_datapath_cuda.launches = 0
CUDA_WRAPPERS = (stem_datapath_cuda,)


def stem_datapath(words: torch.Tensor, *, block_b: int = 256):
    """Stages 1-4 alone: words int32[B,16] -> (keys int32[B,32], valid
    int32[B,32]) on the words' device. A CUDA tensor launches K6 (one
    launch, none for B = 0) or raises; a CPU tensor runs the plain
    version."""
    _check_block_b(block_b)
    if words.device.type == "cuda":
        return stem_datapath_cuda(words, block_b=block_b)
    if words.device.type != "cpu":
        raise ValueError(f"no stem_datapath path for device {words.device}")
    return stem_datapath_plain(words, block_b=block_b)

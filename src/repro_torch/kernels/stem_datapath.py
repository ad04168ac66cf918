"""Stages 1-4 of the stemmer datapath, in plain PyTorch.

The counterpart of ``repro.kernels.stem_datapath.candidate_columns``: per
word it runs check, produce (masking networks), generate (truncation
grid), filter, the infix transforms and key packing, giving 30 packed
candidate keys and validity flags. The CUDA megakernel runs the same
per-word logic from ``csrc/stem_datapath.cuh``; this module is its plain
version, which the CPU path and the tests use.

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

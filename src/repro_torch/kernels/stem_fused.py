"""The stemmer megakernel (stages 1-5 in one launch): wrapper and plain version.

The counterpart of ``repro.kernels.stem_fused`` for the resident,
non-persistent layout. A word tile goes in and ``(root, source)`` comes
out; candidates, validity flags and hit masks never reach device memory.

  - stages 1-4 are ``stem_datapath.candidate_columns`` (30 packed keys +
    validity flags per word);
  - stage 5a matches each candidate group against its dictionary:
      match="bsearch"  branchless binary search over the sorted table,
                       padded to a pow2 >= 128 with DICT_SENTINEL;
      match="bank"     all-pairs comparator bank over the table, padded
                       to a 128 multiple with DICT_PAD;
  - stage 5b keeps the first hit in slot order and unpacks it into four
    6-bit codes; ``source`` is the group's ``GROUP_TAGS`` entry, or 0.

:func:`stem_fused` runs the CUDA kernel ``csrc/stem_fused.cu`` on a CUDA
tensor and :func:`stem_fused_plain`, its plain PyTorch version, on a CPU
tensor. The kernel holds the tables in shared memory when they fit and
reads them from global memory otherwise; outputs are the same.

The streamed-dictionary and persistent layouts of the reference are not
ported yet (ROADMAP §2 K2, K3): ``residency="streamed"``, and ``"auto"``
for dictionaries past MAX_RESIDENT_KEYS, raise NotImplementedError.
"""
from __future__ import annotations

import torch

from repro_torch.core import alphabet as ab
from repro_torch.core import pyref
from repro_torch.core import stemmer as core_stemmer
from repro_torch.kernels import stem_datapath as sdp
from repro_torch.kernels import stem_match as sm

N_CAND = 6
# candidate-group order == stem_datapath layout == core.stemmer priority
GROUP_DICTS = ("tri", "quad", "tri", "tri", "bi")
GROUP_TAGS = (
    pyref.SRC_TRI,
    pyref.SRC_QUAD,
    pyref.SRC_RESTORED,
    pyref.SRC_DEINFIX_TRI,
    pyref.SRC_DEINFIX_BI,
)
MATCHES = ("bsearch", "bank")
# The reference's resident budget (its VMEM limit). The port accepts every
# dictionary the reference keeps resident; the kernel itself decides
# between shared and global memory (dict_in_shared).
MAX_RESIDENT_KEYS = 1 << 16
RESIDENCIES = ("resident", "streamed", "auto")
_STREAMED_TODO = ("the streamed-dictionary megakernel (reference"
                  " stem_fused._fused_pipeline_kernel) is not ported yet:"
                  " ROADMAP §1 item 1 and §2 K2")
# Shared memory one block may opt into on an H100 (232,448 bytes).
SMEM_BLOCK_BYTES = 227 * 1024
MAX_BLOCK_B = 512          # csrc/stem_fused.cu __launch_bounds__
_BANK_CHUNK = 1 << 24      # plain comparator bank: elements per compare


def _loaded_keys(roots, infix: bool) -> int:
    """Keys the Compare stage loads: bi only feeds the deinfix group, so
    infix=False never touches it."""
    dicts = (roots.tri, roots.quad) + ((roots.bi,) if infix else ())
    return sum(int(d.shape[0]) for d in dicts)


def choose_residency(roots, residency: str = "auto", *,
                     infix: bool = True) -> str:
    """Resolve residency="auto": resident while the loaded tables fit the
    reference's budget. Only the resident layout is ported."""
    if residency not in RESIDENCIES:
        raise ValueError(f"unknown residency: {residency!r} (want one of"
                         f" {RESIDENCIES})")
    loaded = _loaded_keys(roots, infix)
    if residency == "streamed" or (residency == "auto"
                                   and loaded > MAX_RESIDENT_KEYS):
        raise NotImplementedError(
            f"residency={residency!r} with {loaded} loaded keys needs "
            + _STREAMED_TODO)
    if loaded > MAX_RESIDENT_KEYS:
        raise ValueError(
            f"dictionaries too large for residency='resident' ({loaded}"
            f" keys > {MAX_RESIDENT_KEYS})")
    return "resident"


def planned_launches(n_words: int, roots, *, infix: bool = True,
                     residency: str = "auto") -> int:
    """Kernel launches one :func:`stem_fused` call makes: 0 for an empty
    batch, else 1 (the resident layout is a single launch)."""
    roots, residency = core_stemmer.unwrap_dict(roots, residency)
    choose_residency(roots, residency, infix=infix)
    return 0 if n_words == 0 else 1


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------
def _bank_hit(flat_dict: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """All-pairs comparator bank: keys[bb,6] vs flat_dict[R] -> bool[bb,6],
    OR-accumulated over dictionary chunks to bound the compare tensor."""
    chunk = max(1, _BANK_CHUNK // max(1, keys.numel()))
    hit = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    for c0 in range(0, flat_dict.shape[0], chunk):
        hit |= (keys[..., None] == flat_dict[c0:c0 + chunk]).any(-1)
    return hit


def _priority_select(keys, hits_i, *, n_groups: int):
    """Stage 5b: first hit in VHDL candidate order -> (root, source).

    One-hot of the first True per row (cumsum == 1 on a hit slot), so the
    winning key and tag fall out of a masked sum.
    """
    is_first = hits_i * (torch.cumsum(hits_i, dim=1) == 1)
    chosen = (keys.to(torch.int64) * is_first).sum(dim=1).to(torch.int32)
    grp_first = is_first.reshape(-1, n_groups, N_CAND).sum(dim=2)
    source = sum(int(GROUP_TAGS[g]) * grp_first[:, g] for g in range(n_groups))
    root = torch.stack([(chosen >> 18) & 63, (chosen >> 12) & 63,
                        (chosen >> 6) & 63, chosen & 63], dim=1)
    return root.to(torch.int32), source.to(torch.int32)


def _candidates(w, n_groups: int):
    """Stages 1-4 on one word tile -> (keys[bb, n_slots], valid[bb, n_slots])."""
    key_cols, val_cols = sdp.candidate_columns(w)
    n_slots = n_groups * N_CAND
    keys = torch.stack(key_cols[:n_slots], dim=1)
    valid = torch.stack(val_cols[:n_slots], dim=1) > 0
    return keys, valid


def _resident_hits(keys, valid, dicts, *, n_groups: int, match: str):
    """Stage 5a against the resident dictionaries -> bool[bb, n_slots]."""
    hit_cols = []
    for g in range(n_groups):
        kg = keys[:, g * N_CAND:(g + 1) * N_CAND]
        d = dicts[GROUP_DICTS[g]]
        hit_cols.append(sm.bsearch_hit(d, kg) if match == "bsearch"
                        else _bank_hit(d, kg))
    return torch.cat(hit_cols, dim=1) & valid


def stem_fused_plain(words, tables, *, n_groups: int, match: str,
                     block_b: int):
    """The kernel's plain PyTorch version, on any device.

    words int32[B,16]; tables (tri, quad, bi) padded flat int32 tables from
    :func:`padded_tables` -> (root int32[B,4], source int32[B]). The batch
    is padded to a multiple of block_b with zero words and the outputs
    trimmed, as the reference does.
    """
    b = words.shape[0]
    pad = (-b) % block_b
    wp = torch.cat([words, words.new_zeros((pad, ab.MAXLEN))]) if pad else words
    keys, valid = _candidates(wp, n_groups)
    dicts = dict(zip(("tri", "quad", "bi"), tables))
    hits = _resident_hits(keys, valid, dicts, n_groups=n_groups, match=match)
    root, source = _priority_select(keys, hits.to(torch.int32),
                                    n_groups=n_groups)
    return root[:b], source[:b]


def padded_tables(roots, *, match: str, infix: bool):
    """-> (tri, quad, bi) flat int32 tables in the layout ``match`` searches.

    infix=False never reads bi: it gets a one-lane DICT_PAD placeholder.
    A ResolvedRootDict handle caches the result per (match, infix).
    """
    cache = roots.padded if isinstance(roots, core_stemmer.ResolvedRootDict) \
        else None
    if cache is not None and (match, infix) in cache:
        return cache[(match, infix)]
    arrays, _ = core_stemmer.unwrap_dict(roots)
    prep = sm.pad_dict_sorted if match == "bsearch" else sm.pad_dict_lanes
    bi = arrays.bi if infix else torch.full((1,), sm.DICT_PAD,
                                            dtype=torch.int32,
                                            device=arrays.bi.device)
    out = tuple(prep(t).reshape(-1).contiguous()
                for t in (arrays.tri, arrays.quad, bi))
    if cache is not None:
        cache[(match, infix)] = out
    return out


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------
def dict_in_shared(tables, *, n_groups: int) -> bool:
    """Whether the kernel copies the tables it reads into shared memory (it
    stages nothing else there); otherwise it reads them from global memory."""
    n_tables = 3 if n_groups == 5 else 2
    return 4 * sum(int(t.shape[0]) for t in tables[:n_tables]) \
        <= SMEM_BLOCK_BYTES


def _check_cuda(name: str, t: torch.Tensor, ndim: int, dev: torch.device):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got one"
                         f" on {t.device}")
    if t.dtype != torch.int32 or t.device != dev or t.dim() != ndim:
        raise ValueError(f"{name}: want a {ndim}-D int32 tensor on {dev},"
                         f" got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: want a contiguous 16-byte aligned tensor")


def stem_fused_cuda(words, tables, *, n_groups: int, match: str,
                    block_b: int):
    """Launch ``csrc/stem_fused.cu`` on the current stream: same contract as
    :func:`stem_fused_plain`, for CUDA tensors. Adds one to
    ``stem_fused_cuda.launches`` per launch."""
    from repro_torch.kernels import build  # lazy: builds at first launch

    dev = words.device
    _check_cuda("words", words, 2, dev)
    if words.shape[1] != ab.MAXLEN:
        raise ValueError(f"words must be [B, {ab.MAXLEN}], got"
                         f" {tuple(words.shape)}")
    for name, t in zip(("tri", "quad", "bi"), tables):
        _check_cuda(name, t, 1, dev)
    if not 1 <= block_b <= MAX_BLOCK_B:
        raise ValueError(f"block_b must be in 1..{MAX_BLOCK_B} on CUDA,"
                         f" got {block_b}")
    b = words.shape[0]
    root = torch.empty((b, 4), dtype=torch.int32, device=dev)
    source = torch.empty((b,), dtype=torch.int32, device=dev)
    if b == 0:
        return root, source
    lib = build.stem_fused_library()
    tri, quad, bi = tables
    shared = dict_in_shared(tables, n_groups=n_groups)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.stem_fused_launch(
            words.data_ptr(), b, tri.data_ptr(), tri.shape[0],
            quad.data_ptr(), quad.shape[0], bi.data_ptr(), bi.shape[0],
            root.data_ptr(), source.data_ptr(), block_b, n_groups,
            MATCHES.index(match), int(shared), stream)
    if err:
        raise RuntimeError(
            f"stem_fused kernel launch failed: CUDA error {err}"
            f" ({lib.stem_fused_error_string(err).decode()})")
    stem_fused_cuda.launches += 1
    return root, source


stem_fused_cuda.launches = 0


def stem_fused(words: torch.Tensor, roots, *, infix: bool = True,
               match: str = "bsearch", block_b: int = 256,
               residency: str = "auto"):
    """words int32[B,16] + RootDictArrays (or a resolved handle) ->
    (root int32[B,4], source int32[B]), on the words' device.

    A CUDA tensor launches the CUDA kernel (or raises); a CPU tensor runs
    the plain version. Bit-identical to ``core.stemmer.extract_roots``.
    """
    if match not in MATCHES:
        raise ValueError(f"unknown in-kernel match strategy: {match}")
    if block_b < 1:
        raise ValueError(f"block_b must be >= 1, got {block_b}")
    n_groups = 5 if infix else 2
    arrays, res = core_stemmer.unwrap_dict(roots, residency)
    choose_residency(arrays, res, infix=infix)
    b = words.shape[0]
    if b == 0:  # degenerate batch: nothing to launch
        return (words.new_zeros((0, 4)), words.new_zeros((0,)))
    tables = padded_tables(roots, match=match, infix=infix)
    if words.device.type == "cuda":
        run = stem_fused_cuda
    elif words.device.type == "cpu":
        run = stem_fused_plain
    else:
        raise ValueError(f"no stem_fused path for device {words.device}")
    return run(words, tables, n_groups=n_groups, match=match,
               block_b=block_b)

"""Batch-parallel PyTorch implementation of the paper's stemmer.

The counterpart of ``repro.core.stemmer``: the five FPGA pipeline stages
(Fig 10) map onto tensor stages over a batch of encoded words
``int32[B, 16]``:

  stage 1  Check Prefixes / Check Suffixes  -> broadcast membership tests
  stage 2  Produce Prefixes / Suffixes      -> anchored cumulative-AND runs
  stage 3  Generate Stems                   -> static 6x2 (prefix-cut x size)
                                               truncation grid (VHDL Fig 12)
  stage 4  Filter by Size                   -> implicit in the static grid
  stage 5  Compare Stems & Extract Root     -> dictionary match (dense /
                                               sorted search / the
                                               comparator-bank or sorted-
                                               search kernel / the stemmer
                                               megakernel) + priority select

Candidate grid: a stem is word[p+1 : p+1+L] for prefix cut p in {-1..4} and
L in {3, 4}; the suffix cut is s = p+1+L. Infix processing (paper §6.3)
adds three recovery candidate groups: restored hollow (ا→و), remove-infix
quad→tri, remove-infix tri→bi.

Every output is int32 and bit-identical to the reference. This module is
also the jax-free oracle the port's kernels are held against.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.core import alphabet as ab
from repro_torch.core import pyref

N_CAND = 6  # prefix cuts -1..4


@dataclass
class RootDictArrays:
    """Packed, sorted root dictionaries (int32 keys; see alphabet.pack_key).

    An empty table is the one-element ``[-1]`` placeholder, as in the
    reference, so every table has at least one entry.
    """

    tri: torch.Tensor   # int32[Rt] sorted
    quad: torch.Tensor  # int32[Rq] sorted
    bi: torch.Tensor    # int32[Rb] sorted

    @staticmethod
    def from_rootdict(d: pyref.RootDict, *,
                      device=devmod.DEFAULT_DEVICE) -> "RootDictArrays":
        def pack(roots):
            keys = sorted(ab.pack_key(r) for r in roots) or [-1]
            return np.asarray(keys, np.int32)

        return RootDictArrays.from_numpy(pack(d.tri), pack(d.quad),
                                         pack(d.bi), device=device)

    @staticmethod
    def from_numpy(tri, quad, bi, *,
                   device=devmod.DEFAULT_DEVICE) -> "RootDictArrays":
        """Three packed sorted key arrays (numpy, e.g. ``np.asarray`` of the
        reference package's tables) -> tensors on ``device``."""
        dev = devmod.resolve(device)
        tables = []
        for name, a in (("tri", tri), ("quad", quad), ("bi", bi)):
            a = np.asarray(a, dtype=np.int32)
            if a.ndim != 1:
                raise ValueError(f"{name}: expected a 1-D key table, got"
                                 f" shape {a.shape}")
            tables.append(torch.tensor(a, dtype=torch.int32, device=dev))
        return RootDictArrays(*tables)

    @property
    def device(self) -> torch.device:
        return self.tri.device

    def to(self, device) -> "RootDictArrays":
        dev = devmod.resolve(device)
        if all(t.device == dev for t in (self.tri, self.quad, self.bi)):
            return self
        return RootDictArrays(self.tri.to(dev), self.quad.to(dev),
                              self.bi.to(dev))

    def numpy(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        return tuple(t.cpu().numpy() for t in (self.tri, self.quad, self.bi))

    @property
    def n_keys(self) -> int:
        return sum(int(d.shape[0]) for d in (self.tri, self.quad, self.bi))


@dataclass
class ResolvedRootDict:
    """A RootDictArrays plus its residency, pinned once (at publish time).

    ``tiles`` optionally carries the streamed layout's prebuilt
    ``stem_match.DictTileSet`` (tile stream + per-tile boundary tables),
    so serving launches never re-pad or re-concatenate the tables.
    ``padded`` caches the resident kernels' padded table layout per
    ``(match, infix)``, so a served dictionary version is padded and
    uploaded once, not per launch.
    """

    arrays: RootDictArrays
    residency: str          # "resident" | "streamed" — never "auto"
    tiles: object = None    # stem_match.DictTileSet | None
    padded: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def n_keys(self) -> int:
        return self.arrays.n_keys


def resolve_dict(roots, *, residency: str = "auto", infix: bool = True,
                 dict_block_r: int | None = None) -> ResolvedRootDict:
    """Pin a dictionary's residency against the kernel's budget up front.

    ``infix`` scopes the budget to the tables the Compare stage loads. A
    streamed resolution with ``dict_block_r`` set also prebuilds the tile
    set; an already-resolved handle without (matching) tiles gets them
    built here.
    """
    if isinstance(roots, ResolvedRootDict):
        unwrap_dict(roots, residency)  # conflicting residency raises
        res, arrays, tiles = roots.residency, roots.arrays, roots.tiles
    else:
        from repro_torch.kernels import stem_fused as sf  # lazy: kernels need core

        res = sf.choose_residency(roots, residency, infix=infix)
        arrays, tiles = roots, None
    if res == "streamed" and dict_block_r and (
            tiles is None or tiles.dict_block_r != dict_block_r):
        from repro_torch.kernels import stem_match as sm

        tiles = sm.build_dict_tiles(arrays.tri, arrays.quad, arrays.bi,
                                    dict_block_r)
    if isinstance(roots, ResolvedRootDict) and tiles is roots.tiles:
        return roots
    return ResolvedRootDict(arrays, res, tiles)


def unwrap_dict(roots, residency: str = "auto"):
    """-> (RootDictArrays, residency, tiles); a handle's pinned residency
    wins, and tiles is its prebuilt DictTileSet (None otherwise)."""
    if isinstance(roots, ResolvedRootDict):
        if residency not in ("auto", roots.residency):
            raise ValueError(
                f"residency={residency!r} conflicts with the resolved dict"
                f" handle's pinned residency {roots.residency!r}")
        return roots.arrays, roots.residency, roots.tiles
    return roots, residency, None


# ---------------------------------------------------------------------------
# Stages 1-2
# ---------------------------------------------------------------------------
def _member(x: torch.Tensor, codes) -> torch.Tensor:
    table = torch.as_tensor(np.asarray(codes), dtype=x.dtype, device=x.device)
    return (x[..., None] == table).any(-1)


def check_and_produce(words: torch.Tensor):
    """words int32[B,16] -> (pp bool[B,5], valid_s bool[B,17], n int32[B])."""
    in_word = words != 0
    n = in_word.sum(dim=-1).to(torch.int32)

    head = words[:, :5]
    run = torch.cumprod(_member(head, ab.PREFIX_CODES).to(torch.int32),
                        dim=1) > 0
    yeh = (head == ab.YEH).to(torch.int32)
    yeh_before = torch.cumsum(yeh, dim=1) - yeh
    pp = run & (yeh_before == 0)

    ok = _member(words, ab.SUFFIX_CODES) | ~in_word   # pads don't break it
    rev = torch.flip(torch.cumprod(torch.flip(ok, [1]).to(torch.int32),
                                   dim=1), [1]) > 0
    ps = rev & in_word                                 # bool[B,16]

    s_grid = torch.arange(ab.MAXLEN + 1, dtype=torch.int32,
                          device=words.device)        # 0..16
    ps_pad = torch.cat([ps, torch.zeros_like(ps[:, :1])], dim=1)
    valid_s = (s_grid[None, :] == n[:, None]) | (
        (s_grid[None, :] < n[:, None]) & ps_pad)
    return pp, valid_s, n


# ---------------------------------------------------------------------------
# Stages 3-4
# ---------------------------------------------------------------------------
def generate_stems(words: torch.Tensor):
    """-> (tri int32[B,6,4] zero-padded, tri_valid, quad int32[B,6,4], quad_valid).

    Candidate order along axis 1 is prefix cut p = -1, 0, 1, 2, 3, 4 — the
    VHDL loop order, which also defines match priority.
    """
    pp, valid_s, _ = check_and_produce(words)
    b = words.shape[0]
    zero_col = torch.zeros((b, 1), dtype=torch.int32, device=words.device)
    everyone = torch.ones(b, dtype=torch.bool, device=words.device)
    tri_list, quad_list, tv_list, qv_list = [], [], [], []
    for p in range(-1, 5):
        start = p + 1
        p_ok = everyone if p == -1 else pp[:, p]
        tri_list.append(torch.cat([words[:, start:start + 3], zero_col], 1))
        tv_list.append(p_ok & valid_s[:, p + 4])
        quad_list.append(words[:, start:start + 4])
        qv_list.append(p_ok & valid_s[:, p + 5])
    return (torch.stack(tri_list, 1), torch.stack(tv_list, 1),
            torch.stack(quad_list, 1), torch.stack(qv_list, 1))


def pack_keys(stems: torch.Tensor) -> torch.Tensor:
    """int32[..., 4] char codes -> int32[...] packed 24-bit keys."""
    c = stems.to(torch.int32)
    return ((c[..., 0] * 64 + c[..., 1]) * 64 + c[..., 2]) * 64 + c[..., 3]


# ---------------------------------------------------------------------------
# Stage 5 backends
# ---------------------------------------------------------------------------
def match_dense(keys: torch.Tensor, dict_keys: torch.Tensor) -> torch.Tensor:
    """O(N*R) broadcast compare — the paper's baseline Compare process."""
    return (keys[..., None] == dict_keys).any(-1)


def match_sorted(keys: torch.Tensor, dict_keys: torch.Tensor) -> torch.Tensor:
    """O(N log R) binary search — the paper's proposed tree-search upgrade."""
    idx = torch.searchsorted(dict_keys, keys.contiguous())
    idx = idx.clamp(0, dict_keys.shape[0] - 1)
    return dict_keys[idx] == keys


def _match(keys, dict_keys, backend: str):
    if backend == "dense":
        return match_dense(keys, dict_keys)
    if backend == "sorted":
        return match_sorted(keys, dict_keys)
    if backend in ("pallas", "fused"):
        from repro_torch.kernels import ops  # lazy: kernels depend on core

        # "pallas" is the comparator bank (K7); "fused" reaching stage 5
        # on its own (the extended rule pool) uses the sorted search (K8).
        # One launch a candidate group on a card.
        strategy = "bsearch" if backend == "fused" else "bank"
        shape = keys.shape
        return ops.dict_match(keys.reshape(-1), dict_keys, strategy=strategy,
                              device=keys.device).reshape(shape)
    raise ValueError(f"unknown match backend: {backend}")


# ---------------------------------------------------------------------------
# Full extraction
# ---------------------------------------------------------------------------
BACKENDS = ("dense", "sorted", "pallas", "fused")


def extract_roots(words, roots, *, infix: bool = True,
                  backend: str = "sorted", extended: bool = False,
                  residency: str = "auto", num_buffers: int = 2,
                  skip_index: bool = True,
                  device=devmod.DEFAULT_DEVICE):
    """words int32[B,16] -> (root int32[B,4], source int32[B]) on ``device``.

    source uses pyref.SRC_* tags; root rows are zero-padded char codes.
    extended=True adds the beyond-paper rule pool (final ى→ي, hollow ا→ي).
    roots may be plain RootDictArrays or a ResolvedRootDict handle whose
    pinned residency then overrides the residency argument.

    backend selects the Compare stage: "dense" / "sorted" (plain PyTorch),
    "pallas" (the comparator-bank kernel, one launch a candidate group) or
    "fused" — the stage 1-5 stemmer megakernels (kernels/stem_fused.py).
    Kernels run as CUDA kernels on a CUDA device and as their plain
    versions on the CPU. For the fused backend, residency picks the
    dictionary layout ("resident", "streamed", or "auto": resident while
    it fits); ``num_buffers`` (copy pipeline depth) and ``skip_index``
    (visit only the tiles that can hit) tune the reference's streamed
    sweep: the port checks them, and its streamed kernels, which search a
    fence level instead, give the same roots for every value. The extended rule pool is not in the megakernel's
    candidate grid, so extended=True keeps the staged path and runs stage
    5 through the sorted-search kernel, one launch a group.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (want one of"
                         f" {BACKENDS})")
    dev = devmod.resolve(device)
    if backend == "fused" and not extended:
        from repro_torch.kernels import ops  # lazy: kernels depend on core

        return ops.extract_roots_fused(words, roots, infix=infix,
                                       residency=residency,
                                       num_buffers=num_buffers,
                                       skip_index=skip_index, device=dev)

    roots, _, _ = unwrap_dict(roots, residency)
    roots = roots.to(dev)
    words = devmod.as_int32(words, dev)
    tri, tri_valid, quad, quad_valid = generate_stems(words)
    zero = torch.zeros_like(tri[..., 0])

    groups = []  # (stems[B,6,4], valid[B,6], dict, src_tag)
    groups.append((tri, tri_valid, roots.tri, pyref.SRC_TRI))
    groups.append((quad, quad_valid, roots.quad, pyref.SRC_QUAD))
    if infix:
        is_alef = tri[..., 1] == ab.ALEF
        restored = tri.clone()
        restored[..., 1] = torch.where(is_alef, ab.WAW, tri[..., 1])
        groups.append((restored, tri_valid & is_alef, roots.tri,
                       pyref.SRC_RESTORED))

        is_inf_q = _member(quad[..., 1], ab.INFIX_CODES)
        deinf_q = torch.stack([quad[..., 0], quad[..., 2], quad[..., 3], zero],
                              dim=-1)
        groups.append((deinf_q, quad_valid & is_inf_q, roots.tri,
                       pyref.SRC_DEINFIX_TRI))

        is_inf_t = _member(tri[..., 1], ab.INFIX_CODES)
        deinf_t = torch.stack([tri[..., 0], tri[..., 2], zero, zero], dim=-1)
        groups.append((deinf_t, tri_valid & is_inf_t, roots.bi,
                       pyref.SRC_DEINFIX_BI))

    if extended:  # beyond-paper rule pool (paper §7 future work)
        is_maq = tri[..., 2] == pyref.ALEF_MAQSURA
        defect = tri.clone()
        defect[..., 2] = torch.where(is_maq, ab.YEH, tri[..., 2])
        groups.append((defect, tri_valid & is_maq, roots.tri,
                       pyref.SRC_EXT_DEFECTIVE))

        is_alef = tri[..., 1] == ab.ALEF
        hollow_y = tri.clone()
        hollow_y[..., 1] = torch.where(is_alef, ab.YEH, tri[..., 1])
        groups.append((hollow_y, tri_valid & is_alef, roots.tri,
                       pyref.SRC_EXT_HOLLOW_Y))

    all_stems = torch.cat([g[0] for g in groups], dim=1)         # [B, 6G, 4]
    all_hits = torch.cat([_match(pack_keys(stems), dict_keys, backend) & valid
                          for stems, valid, dict_keys, _src in groups], dim=1)

    first = torch.argmax(all_hits.to(torch.int32), dim=1)         # first True
    found = all_hits.any(dim=1)
    idx = first[:, None, None].expand(-1, 1, 4)
    root = torch.gather(all_stems, 1, idx)[:, 0]
    root = torch.where(found[:, None], root, 0).to(torch.int32)
    src_tags = torch.as_tensor(
        np.repeat([g[3] for g in groups], N_CAND).astype(np.int32),
        device=dev)
    source = torch.where(found, src_tags[first], pyref.SRC_NONE)
    return root, source.to(torch.int32)


# ---------------------------------------------------------------------------
# The paper's three execution models: each accepts the full (infix,
# backend, extended, residency, num_buffers, skip_index) option set.
# ---------------------------------------------------------------------------
def stem_batch(words, roots, *, infix=True, backend="sorted", extended=False,
               residency="auto", num_buffers=2, skip_index=True,
               device=devmod.DEFAULT_DEVICE):
    """'Non-pipelined processor' analogue: whole batch through all stages."""
    return extract_roots(words, roots, infix=infix, backend=backend,
                         extended=extended, residency=residency,
                         num_buffers=num_buffers, skip_index=skip_index,
                         device=device)


def stem_sequential(words, roots, *, infix=True, backend="sorted",
                    extended=False, residency="auto", num_buffers=2,
                    skip_index=True, device=devmod.DEFAULT_DEVICE):
    """'Software implementation' analogue: one word at a time (the
    reference's lax.scan is a Python loop here)."""
    dev = devmod.resolve(device)
    words = devmod.as_int32(words, dev)
    outs = [extract_roots(words[i:i + 1], roots, infix=infix,
                          backend=backend, extended=extended,
                          residency=residency, num_buffers=num_buffers,
                          skip_index=skip_index, device=dev)
            for i in range(words.shape[0])]
    if not outs:
        return (torch.zeros((0, 4), dtype=torch.int32, device=dev),
                torch.zeros((0,), dtype=torch.int32, device=dev))
    return (torch.cat([o[0] for o in outs]),
            torch.cat([o[1] for o in outs]))


def stem_pipelined(words, roots, *, infix=True, backend="sorted",
                   extended=False, residency="auto", num_buffers=2,
                   skip_index=True, microbatch=256,
                   device=devmod.DEFAULT_DEVICE):
    """'Pipelined processor' analogue on one device: microbatched streaming.

    The batch is padded with zero words to a multiple of ``microbatch``,
    each microbatch goes through :func:`stem_batch` (queued behind the
    last on the card's stream) and the outputs are concatenated and
    trimmed. Bit-identical to stem_batch.
    """
    dev = devmod.resolve(device)
    words = devmod.as_int32(words, dev)
    b = words.shape[0]
    pad = (-b) % microbatch
    wp = torch.cat([words, words.new_zeros((pad, words.shape[1]))]) if pad \
        else words
    outs = [stem_batch(c, roots, infix=infix, backend=backend,
                       extended=extended, residency=residency,
                       num_buffers=num_buffers, skip_index=skip_index,
                       device=dev)
            for c in wp.reshape(-1, microbatch, words.shape[1])]
    root = torch.cat([o[0] for o in outs])[:b]
    source = torch.cat([o[1] for o in outs])[:b]
    return root, source

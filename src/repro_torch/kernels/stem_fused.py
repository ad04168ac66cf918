"""The stemmer megakernels (stages 1-5 in one launch): wrappers and plain
versions.

The counterpart of ``repro.kernels.stem_fused``. A word tile goes in and
``(root, source)`` comes out; candidates, validity flags and hit masks
never reach device memory.

  - stages 1-4 are ``stem_datapath.candidate_columns`` (30 packed keys +
    validity flags per word);
  - stage 5a matches each candidate group against its dictionary:
      match="bsearch"  branchless binary search over the sorted table;
      match="bank"     all-pairs comparator bank over the table;
  - stage 5b keeps the first hit in slot order and unpacks it into four
    6-bit codes; ``source`` is the group's ``GROUP_TAGS`` entry, or 0.

``residency`` picks the dictionary layout:

  "resident"  the padded tables ride along whole (K1,
              ``csrc/stem_fused.cu``): bsearch pads each to a pow2 >= 128
              with DICT_SENTINEL, the bank to a 128 multiple with DICT_PAD.
  "streamed"  the tables are cut into sorted ``(dict_block_r x 128)``
              tiles (``stem_match.DictTileSet``) with a fence level, every
              F-th entry of each table; the kernel (K2,
              ``csrc/stem_streamed.cu``) stages the fences in shared
              memory and searches every live key in its own table: the
              fences, then one 8-entry block of the stream. The reference
              walks a visit list of tiles instead (its tile-visit pre-pass
              is :func:`_visit_tables`, its walk :func:`_streamed_rows`,
              both kept to hold the reference to); the answers are the
              same, so ``num_buffers`` and ``skip_index``, which tune the
              reference's walk, are checked and change nothing.
  "auto"      resident while the loaded tables fit MAX_RESIDENT_KEYS.

``persistent=True`` runs the persistent serving kernel instead (K3,
``csrc/stem_persistent.cu``): one launch whose blocks loop over a
descriptor ring of ``(row offset, n_visits, version slot)`` tiles and
write ``flags[d] = 1 + version_slot`` after each tile's outputs
(``n_visits`` is 0: no kernel of the port reads a visit list).

Each kernel has a plain PyTorch version beside its CUDA wrapper: a CUDA
tensor launches the kernel (or raises), a CPU tensor runs the plain
version. Streamed launches are chunked along the batch axis as the
reference chunks its scalar-prefetch table (at most ``visit_budget`` /
n_tiles batch tiles a launch), so both make the same number of launches.
``block_b`` is the logical tile (checksum tiles, descriptor rows), not the
thread count, so every ``block_b >= 1`` runs on the card as on the CPU.
The resident kernels (K1, K3 resident) run 256 threads a block and split
each word's live slots across G lanes, G in {1, 2, 4, 8} picked per
launch by the rule in ``csrc/stem_resident.cuh`` (which
``build.host_resident_walk`` runs on the host); the streamed ones run 256
to 1024 threads a block, one word a thread.
"""
from __future__ import annotations

import ctypes

import numpy as np
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
DICT_NAMES = ("tri", "quad", "bi")   # the stream's table order
MATCHES = ("bsearch", "bank")
# The reference's resident budget (its VMEM limit). The port accepts every
# dictionary the reference keeps resident; the kernels decide between
# shared and global memory (dict_in_shared).
MAX_RESIDENT_KEYS = 1 << 16
RESIDENCIES = ("resident", "streamed", "auto")
MAX_NUM_BUFFERS = 4
_KEY_NOWHERE = -(1 << 31)  # lands in no tile: below every tile's min
# Visit-table budget in int32 entries ([batch_tiles, n_dict_tiles] per
# launch): a streamed batch whose table would exceed it is chunked along
# the batch axis into several launches, as the reference chunks its
# scalar-prefetch table (16K entries = 64 KB).
VISIT_SMEM_BUDGET = 1 << 14
# Shared memory one block may opt into on an H100 (232,448 bytes).
SMEM_BLOCK_BYTES = 227 * 1024
_BANK_CHUNK = 1 << 24      # plain comparator bank: elements per compare


def _loaded_keys(roots, infix: bool) -> int:
    """Keys the Compare stage loads: bi only feeds the deinfix group, so
    infix=False never touches it."""
    dicts = (roots.tri, roots.quad) + ((roots.bi,) if infix else ())
    return sum(int(d.shape[0]) for d in dicts)


def choose_residency(roots, residency: str = "auto", *,
                     infix: bool = True) -> str:
    """Resolve residency="auto": resident while the loaded tables fit
    MAX_RESIDENT_KEYS, streamed once they don't. Only the tables the
    Compare stage loads count (bi is excluded for infix=False)."""
    if residency not in RESIDENCIES:
        raise ValueError(f"unknown residency: {residency!r} (want one of"
                         f" {RESIDENCIES})")
    if residency != "auto":
        return residency
    return ("streamed" if _loaded_keys(roots, infix) > MAX_RESIDENT_KEYS
            else "resident")


def _dict_slots(name: str, n_groups: int) -> list:
    """Candidate-slot columns fed by dictionary ``name``."""
    return [g * N_CAND + c for g in range(n_groups)
            if GROUP_DICTS[g] == name for c in range(N_CAND)]


def dict_tile_count(roots, dict_block_r: int) -> int:
    """Tiles in the streamed ``[tri | quad | bi]`` stream (every table pads
    to at least one full tile, as stem_match.pad_dict_tiles does)."""
    per = dict_block_r * sm.LANE
    return sum(max(1, -(-int(t.shape[0]) // per))
               for t in (roots.tri, roots.quad, roots.bi))


def _max_chunk_tiles(n_tiles: int, visit_budget: int | None) -> int:
    budget = VISIT_SMEM_BUDGET if visit_budget is None else visit_budget
    return max(1, budget // n_tiles)


def planned_launches(n_words: int, roots, *, infix: bool = True,
                     block_b: int = 256, residency: str = "auto",
                     dict_block_r: int = 8, persistent: bool = False,
                     visit_budget: int | None = None) -> int:
    """Kernel launches one :func:`stem_fused` call makes for this
    configuration: 0 for an empty batch, 1 for the resident layout
    (persistent or not), and ceil(batch_tiles / chunk) for the streamed
    one (persistent or not), chunk being the most batch tiles whose visit
    table fits ``visit_budget``."""
    arrays, residency, tiles = core_stemmer.unwrap_dict(roots, residency)
    residency = choose_residency(arrays, residency, infix=infix)
    if n_words == 0:
        return 0
    if residency == "resident":
        return 1
    if tiles is not None and tiles.dict_block_r == dict_block_r:
        n_tiles = tiles.n_tiles
    else:
        n_tiles = dict_tile_count(arrays, dict_block_r)
    bt = -(-n_words // block_b)
    return -(-bt // _max_chunk_tiles(n_tiles, visit_budget))


# ---------------------------------------------------------------------------
# plain versions
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
    """Stages 1-4 on a word tile -> (keys[bb, n_slots], valid[bb, n_slots])."""
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


def _pad_words(words: torch.Tensor, block_b: int) -> torch.Tensor:
    """Pad the batch with zero words to a multiple of block_b."""
    pad = (-words.shape[0]) % block_b
    return torch.cat([words, words.new_zeros((pad, ab.MAXLEN))]) if pad \
        else words


def stem_fused_plain(words, tables, *, n_groups: int, match: str,
                     block_b: int):
    """K1's plain PyTorch version, on any device.

    words int32[B,16]; tables (tri, quad, bi) padded flat int32 tables from
    :func:`padded_tables` -> (root int32[B,4], source int32[B]). The batch
    is padded to a multiple of block_b with zero words and the outputs
    trimmed, as the reference does.
    """
    b = words.shape[0]
    keys, valid = _candidates(_pad_words(words, block_b), n_groups)
    dicts = dict(zip(DICT_NAMES, tables))
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
    arrays, _, _ = core_stemmer.unwrap_dict(roots)
    prep = sm.pad_dict_sorted if match == "bsearch" else sm.pad_dict_lanes
    bi = arrays.bi if infix else torch.full((1,), sm.DICT_PAD,
                                            dtype=torch.int32,
                                            device=arrays.bi.device)
    out = tuple(prep(t).reshape(-1).contiguous()
                for t in (arrays.tri, arrays.quad, bi))
    if cache is not None:
        cache[(match, infix)] = out
    return out


# -- streamed layout: the reference's visit walk, and K2's plain version ---
def _visit_tables(keys, valid, tiles: sm.DictTileSet, *, n_groups: int,
                  block_b: int, skip_index: bool):
    """The tile-skipping pre-pass: per batch tile, the dictionary tiles a
    live candidate key can land in.

    The tiles partition each sorted dictionary, so a key lands in at most
    one of them: ``searchsorted(mins, key, right) - 1``, kept only when
    the key is also under that tile's max. A hit needs the key in the
    dictionary, hence in its landing tile, so sweeping only the marked
    tiles gives the full sweep's result.

    keys int32[bp, n_slots], valid bool[bp, n_slots] (stages 1-4 of the
    padded batch) ->

      n_visits  int32[batch_tiles]           tiles to visit per batch tile
      visit_idx int32[batch_tiles, n_tiles]  global tile ids, the n_visits
                live ones first in ascending order (the rest are never
                read)

    skip_index=False marks every tile of every swept dictionary (bi stays
    unmarked for infix=False): the full sweep through the same walk.
    """
    bt = keys.shape[0] // block_b
    dev = keys.device
    tri_t, quad_t, bi_t = tiles.counts
    masks = []
    for name, base, td in (("tri", 0, tri_t), ("quad", tri_t, quad_t),
                           ("bi", tri_t + quad_t, bi_t)):
        slots = _dict_slots(name, n_groups)
        if not slots:                # bi with infix=False: never swept
            masks.append(torch.zeros((bt, td), dtype=torch.bool, device=dev))
            continue
        if not skip_index:           # full sweep: every tile of the dict
            masks.append(torch.ones((bt, td), dtype=torch.bool, device=dev))
            continue
        mins = tiles.mins[base:base + td]
        maxs = tiles.maxs[base:base + td]
        k = torch.where(valid[:, slots], keys[:, slots],
                        torch.tensor(_KEY_NOWHERE, dtype=torch.int32,
                                     device=dev))
        k = k.reshape(bt, -1).contiguous()   # [bt, block_b * n_dict_slots]
        t = (torch.searchsorted(mins, k, right=True) - 1).clamp(0, td - 1)
        lands = (mins[t] <= k) & (k <= maxs[t])
        # count the keys landing in each (batch tile, dict tile) with an
        # index_add, not a boolean-mask index: no host sync on the device
        cell = (torch.arange(bt, device=dev)[:, None] * td + t).reshape(-1)
        landed = torch.zeros(bt * td, dtype=torch.int32, device=dev)
        landed.index_add_(0, cell, lands.reshape(-1).to(torch.int32))
        masks.append((landed > 0).reshape(bt, td))
    mask = torch.cat(masks, dim=1)                      # [bt, n_tiles]
    n_visits = mask.sum(dim=1).to(torch.int32)
    # a stable sort of ~mask packs the marked tile ids to the front,
    # ascending: the visit order stays the sorted [tri | quad | bi] order
    visit_idx = torch.sort((~mask).to(torch.int8), dim=1,
                           stable=True).indices.to(torch.int32)
    return n_visits, visit_idx.contiguous()


def _tiles_for(arrays, tiles, dict_block_r: int) -> sm.DictTileSet:
    if tiles is None or tiles.dict_block_r != dict_block_r:
        tiles = sm.build_dict_tiles(arrays.tri, arrays.quad, arrays.bi,
                                    dict_block_r)
    return tiles


def tile_visit_stats(words, roots, *, infix: bool = True, block_b: int = 256,
                     dict_block_r: int = 8, skip_index: bool = True) -> dict:
    """Run only the tile-visit pre-pass and report visit counts:
    ``{"visited": tile visits over all batch tiles, "full_sweep":
    batch_tiles * live dictionary tiles (what skip_index=False visits),
    "batch_tiles", "dict_tiles"}``. words is an int32[B,16] tensor on the
    dictionary's device."""
    arrays, _, tiles = core_stemmer.unwrap_dict(roots, "auto")
    tiles = _tiles_for(arrays, tiles, dict_block_r)
    n_groups = 5 if infix else 2
    keys, valid = _candidates(_pad_words(words, block_b), n_groups)
    n_visits, _ = _visit_tables(keys, valid, tiles, n_groups=n_groups,
                                block_b=block_b, skip_index=skip_index)
    bt = keys.shape[0] // block_b
    tri_t, quad_t, bi_t = tiles.counts
    live = tri_t + quad_t + (bi_t if infix else 0)
    return {"visited": int(n_visits.sum()), "full_sweep": bt * live,
            "batch_tiles": bt, "dict_tiles": live}


def _tile_member(tile: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Membership of keys[bt, M] in the sorted rows tile[bt, R]. bsearch
    and the bank compute the same membership on a sorted tile, so the
    plain version computes it once, by a batched sorted search."""
    idx = torch.searchsorted(tile, keys).clamp(max=tile.shape[1] - 1)
    return tile.gather(1, idx) == keys


def _slot_dicts(n_groups: int, device) -> torch.Tensor:
    """Table index (0 tri, 1 quad, 2 bi) of every candidate slot."""
    return torch.tensor([DICT_NAMES.index(GROUP_DICTS[g])
                         for g in range(n_groups) for _ in range(N_CAND)],
                        dtype=torch.int64, device=device)


def _streamed_rows(wp, stream, n_visits, visit_idx, *, n_groups: int,
                   block_b: int, dict_block_r: int, tri_tiles: int,
                   quad_tiles: int):
    """The reference's streamed Compare in plain PyTorch, which the CPU
    tests hold to its Pallas kernels on the same visit tables: stages 1-5
    over padded words wp[bt * block_b, 16], each batch tile walking its
    visit list, vectorised over batch tiles (visit k of every tile at
    once) -> (root, source) for every padded row.

    As in the reference, a tile's hits count only for the slots of the
    dictionary the tile belongs to (told by its global tile id), and only
    the first n_visits[i] entries of row i are read.
    """
    bt = wp.shape[0] // block_b
    n_slots = n_groups * N_CAND
    keys, valid = _candidates(wp, n_groups)
    k = keys.reshape(bt, block_b * n_slots).contiguous()
    live_slots = valid.reshape(bt, block_b * n_slots)
    slot_dict = _slot_dicts(n_groups, wp.device).repeat(block_b)
    tiles = stream.reshape(-1, dict_block_r * sm.LANE)
    nv = n_visits.to(torch.int64)
    hits = torch.zeros_like(live_slots)
    for v in range(int(nv.max()) if bt else 0):
        t = visit_idx[:, v].to(torch.int64)                        # [bt]
        tile_dict = ((t >= tri_tiles).long()
                     + (t >= tri_tiles + quad_tiles).long())
        counted = (live_slots & (nv > v)[:, None]
                   & (slot_dict[None, :] == tile_dict[:, None]))
        hits |= _tile_member(tiles[t], k) & counted
    return _priority_select(keys, hits.reshape(-1, n_slots).to(torch.int32),
                            n_groups=n_groups)


def _fence_search(keys, tiles: sm.DictTileSet, table: int):
    """The streamed kernels' search (``csrc/stem_fences.cuh``) of table
    ``table`` (0 tri, 1 quad, 2 bi), vectorised: keys int32[...] ->
    bool[...]. A branchless bisection of the table's fences for the last
    fence <= key (none: no hit), then of the 8-entry blocks of its
    F-entry segment (blocks past the table's end read as above every
    key), then the key against that block's 8 entries."""
    dev = keys.device
    tile_n = tiles.dict_block_r * sm.LANE
    base = sum(tiles.counts[:table]) * tile_n
    length = tiles.counts[table] * tile_n
    region = tiles.stream.reshape(-1)[base:base + length]
    nf = tiles.fence_counts
    f = tiles.fences[sum(nf[:table]):sum(nf[:table + 1])]
    at = torch.zeros(keys.shape, dtype=torch.int64, device=dev)
    n = nf[table]
    while n > 1:
        half = n // 2
        at = torch.where(f[at + half] <= keys, at + half, at)
        n -= half
    ok = f[at] <= keys
    at = at * tiles.fence_step
    n = tiles.fence_step // 8
    while n > 1:
        half = n // 2
        p = at + 8 * half
        go = (p < length) & (region[p.clamp(max=length - 1)] <= keys)
        at = torch.where(go, p, at)
        n -= half
    block = region[at[..., None] + torch.arange(8, device=dev)]
    return ok & (block == keys[..., None]).any(-1)


def _fence_hits(keys, valid, tiles: sm.DictTileSet, *, n_groups: int):
    """Stage 5a through the fence search -> bool[bb, n_slots]: every
    valid slot searched in its own table."""
    hits = torch.zeros_like(valid)
    for t, name in enumerate(DICT_NAMES):
        slots = _dict_slots(name, n_groups)
        if slots:
            hits[:, slots] = _fence_search(keys[:, slots].contiguous(),
                                           tiles, t)
    return hits & valid


def stem_streamed_plain(words, tiles: sm.DictTileSet, *, n_groups: int,
                        match: str):
    """K2's plain PyTorch version, on any device: words int32[B,16] and the
    tile set (stream and fences) -> (root int32[B,4], source int32[B]).
    ``match`` changes how the kernel compares a key with its 8-entry
    block, not what it computes."""
    del match
    keys, valid = _candidates(words, n_groups)
    hits = _fence_hits(keys, valid, tiles, n_groups=n_groups)
    return _priority_select(keys, hits.to(torch.int32), n_groups=n_groups)


# -- persistent layout: descriptors, K3's plain versions, salvage ----------
def _descriptors(bt: int, block_b: int, n_visits, version_slot):
    """The work-descriptor ring: int32[bt, 3] of (row offset, n_visits,
    version slot) per tile, on n_visits' device."""
    dev = n_visits.device
    offs = torch.arange(bt, dtype=torch.int32, device=dev) * block_b
    ver = torch.full((bt,), int(version_slot), dtype=torch.int32, device=dev)
    return torch.stack([offs, n_visits.to(torch.int32), ver],
                       dim=1).contiguous()


def _descriptor_rows(words, desc, block_b: int):
    """Gather every descriptor's word tile (rows past B read as zero
    words) -> (tile words [n_desc * block_b, 16], their row numbers)."""
    rows = (desc[:, 0:1].to(torch.int64)
            + torch.arange(block_b, device=desc.device)).reshape(-1)
    wp = torch.cat([words, words.new_zeros((1, ab.MAXLEN))])
    return wp[rows.clamp(max=words.shape[0])], rows


def _scatter_rows(b: int, rows, root, source):
    """Write the rows below b back to their places in [B] outputs."""
    keep = rows < b
    out_r = root.new_zeros((b, 4))
    out_s = source.new_zeros((b,))
    out_r[rows[keep]] = root[keep]
    out_s[rows[keep]] = source[keep]
    return out_r, out_s


def _plain_flags(desc, flags_out):
    """The flags of a plain persistent call, 1 + version slot a descriptor,
    written into ``flags_out`` (a CPU int32 tensor of n_desc) if given."""
    flags = (1 + desc[:, 2]).to(torch.int32)
    if flags_out is None:
        return flags
    if (not isinstance(flags_out, torch.Tensor) or flags_out.device.type
            != "cpu" or tuple(flags_out.shape) != (desc.shape[0],)):
        raise ValueError(f"flags_out: want a CPU int32 tensor of"
                         f" {desc.shape[0]} flags")
    flags_out.copy_(flags)
    return flags_out


def persistent_resident_plain(words, tables, desc, *, n_groups: int,
                              match: str, block_b: int, flags_out=None):
    """K3's resident variant in plain PyTorch: every descriptor's tile runs
    stages 1-5 on the resident tables -> (root int32[B,4], source
    int32[B], flags int32[n_desc] = 1 + version slot; ``flags_out`` when
    given, a CPU tensor the flags are written into)."""
    wd, rows = _descriptor_rows(words, desc, block_b)
    root, source = stem_fused_plain(wd, tables, n_groups=n_groups,
                                    match=match, block_b=block_b)
    return _scatter_rows(words.shape[0], rows, root, source) + (
        _plain_flags(desc, flags_out),)


def persistent_streamed_plain(words, tiles: sm.DictTileSet, desc, *,
                              n_groups: int, match: str, block_b: int,
                              flags_out=None):
    """K3's streamed variant in plain PyTorch: every descriptor's tile runs
    stages 1-5 through the fence search -> (root, source, flags), as
    :func:`persistent_resident_plain`. desc[:, 1] is not read."""
    wd, rows = _descriptor_rows(words, desc, block_b)
    root, source = stem_streamed_plain(wd, tiles, n_groups=n_groups,
                                       match=match)
    return _scatter_rows(words.shape[0], rows, root, source) + (
        _plain_flags(desc, flags_out),)


def salvage_descriptor_rows(flags, version_slot: int, block_b: int) -> int:
    """Rows of an abandoned persistent launch that its completion flags
    prove retired: ``block_b`` times the longest prefix of flags equal to
    ``1 + version_slot``.

    The reference retires descriptors in ring order. The CUDA kernel's
    blocks retire them out of order, but each flag is written after a
    fence that follows its tile's output writes, so every set flag proves
    its rows: the prefix rule stays sound, only more conservative (a set
    flag past the first hole is not salvaged; any other value, such as a
    negative count, reads as unretired).
    """
    f = np.asarray(flags)
    good = f == 1 + version_slot
    k = int(f.size if good.all() else np.argmin(good))
    return k * block_b


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------
def dict_in_shared(tables, *, n_groups: int) -> bool:
    """Whether the resident kernels copy the tables they read into shared
    memory; otherwise they read them from global memory."""
    n_tables = 3 if n_groups == 5 else 2
    return 4 * sum(int(t.shape[0]) for t in tables[:n_tables]) \
        <= SMEM_BLOCK_BYTES


def _record_shape(wrapper, lib, fn: str) -> None:
    """The lanes a word, blocks and resident-block capacity the wrapper's
    last launch took, as ``last_lanes``, ``last_grid``, ``last_capacity``."""
    lanes, grid, cap = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    getattr(lib, fn)(ctypes.byref(lanes), ctypes.byref(grid),
                     ctypes.byref(cap))
    wrapper.last_lanes = lanes.value
    wrapper.last_grid = grid.value
    wrapper.last_capacity = cap.value


def _check_cuda(name: str, t: torch.Tensor, ndim: int, dev: torch.device,
                align: int = 16):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got one"
                         f" on {t.device}")
    if t.dtype != torch.int32 or t.device != dev or t.dim() != ndim:
        raise ValueError(f"{name}: want a {ndim}-D int32 tensor on {dev},"
                         f" got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name}: want a contiguous {align}-byte aligned"
                         " tensor")


def _check_words(words: torch.Tensor, block_b: int = 1) -> torch.device:
    dev = words.device
    _check_cuda("words", words, 2, dev)
    if words.shape[1] != ab.MAXLEN:
        raise ValueError(f"words must be [B, {ab.MAXLEN}], got"
                         f" {tuple(words.shape)}")
    if block_b < 1:
        raise ValueError(f"block_b must be >= 1, got {block_b}")
    return dev


def _check_tiles(tiles: sm.DictTileSet, dev) -> None:
    """Checks of the streamed kernels' dictionary: the stream's tiles, and
    a fence level that matches them and fits one block's shared memory."""
    _check_cuda("stream", tiles.stream, 2, dev)
    _check_cuda("fences", tiles.fences, 1, dev)
    r = tiles.dict_block_r
    n_tiles = tiles.stream.shape[0] // max(1, r)
    if (tiles.stream.shape[1] != sm.LANE or r < 1
            or tiles.stream.shape[0] % r or len(tiles.counts) != 3
            or min(tiles.counts) < 1 or sum(tiles.counts) != n_tiles):
        raise ValueError(f"stream {tuple(tiles.stream.shape)} is not"
                         f" {tiles.counts} tiles of ({r}, {sm.LANE})")
    step = tiles.fence_step
    if step < sm.FENCE_MIN_STEP or step & (step - 1) \
            or tiles.fences.shape[0] != sum(tiles.fence_counts):
        raise ValueError(f"{tiles.fences.shape[0]} fences at step {step}"
                         f" do not match the stream (want a power of two"
                         f" >= {sm.FENCE_MIN_STEP} and"
                         f" {sum(tiles.fence_counts)} fences)")
    if 4 * tiles.fences.shape[0] > SMEM_BLOCK_BYTES:
        raise ValueError(
            f"{4 * tiles.fences.shape[0]} bytes of fences exceed the"
            f" {SMEM_BLOCK_BYTES}-byte shared memory of one block")


def _tile_args(tiles: sm.DictTileSet) -> tuple:
    """The C launch's dictionary arguments after the stream and fence
    pointers: the tables' tile counts, tile_n and log2 F."""
    return (*tiles.counts, tiles.dict_block_r * sm.LANE,
            tiles.fence_step.bit_length() - 1)


def _raise_on(err: int, lib, what: str) -> None:
    if err:
        raise RuntimeError(
            f"{what} kernel launch failed: CUDA error {err}"
            f" ({lib.error_string(err).decode()})")


def _cuda_stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def stem_fused_cuda(words, tables, *, n_groups: int, match: str,
                    block_b: int):
    """Launch K1 (``csrc/stem_fused.cu``) on the current stream: same
    contract as :func:`stem_fused_plain`, for CUDA tensors. Adds one to
    ``stem_fused_cuda.launches`` per launch and records the lanes a word,
    blocks and resident-block capacity it took (the header's rule and
    walk, which ``build.host_resident_walk`` runs on the host) in
    ``last_lanes``, ``last_grid`` and ``last_capacity``."""
    from repro_torch.kernels import build  # lazy: builds at first launch

    dev = _check_words(words, block_b)
    for name, t in zip(DICT_NAMES, tables):
        _check_cuda(name, t, 1, dev)
    b = words.shape[0]
    root = torch.empty((b, 4), dtype=torch.int32, device=dev)
    source = torch.empty((b,), dtype=torch.int32, device=dev)
    if b == 0:
        return root, source
    lib = build.stem_fused_library()
    tri, quad, bi = tables
    shared = dict_in_shared(tables, n_groups=n_groups)
    with torch.cuda.device(dev):
        err = lib.stem_fused_launch(
            words.data_ptr(), b, tri.data_ptr(), tri.shape[0],
            quad.data_ptr(), quad.shape[0], bi.data_ptr(), bi.shape[0],
            root.data_ptr(), source.data_ptr(), block_b, n_groups,
            MATCHES.index(match), int(shared), _cuda_stream(dev))
    _raise_on(err, lib, "stem_fused")
    stem_fused_cuda.launches += 1
    _record_shape(stem_fused_cuda, lib, "stem_fused_last_shape")
    return root, source


def stem_streamed_cuda(words, tiles: sm.DictTileSet, *, n_groups: int,
                       match: str):
    """Launch K2 (``csrc/stem_streamed.cu``) on the current stream: same
    contract as :func:`stem_streamed_plain`, for CUDA tensors. Adds one
    to ``stem_streamed_cuda.launches`` per launch and records the blocks
    it launched in ``last_grid``."""
    from repro_torch.kernels import build

    dev = _check_words(words)
    _check_tiles(tiles, dev)
    b = words.shape[0]
    root = torch.empty((b, 4), dtype=torch.int32, device=dev)
    source = torch.empty((b,), dtype=torch.int32, device=dev)
    if b == 0:
        return root, source
    lib = build.stem_streamed_library()
    grid = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = lib.stem_streamed_launch(
            words.data_ptr(), b, tiles.stream.data_ptr(),
            tiles.fences.data_ptr(), *_tile_args(tiles), root.data_ptr(),
            source.data_ptr(), n_groups, MATCHES.index(match),
            _cuda_stream(dev), ctypes.byref(grid))
    _raise_on(err, lib, "stem_streamed")
    stem_streamed_cuda.launches += 1
    stem_streamed_cuda.last_grid = grid.value
    return root, source


class _MappedBlock:
    """Owner of one cudaHostAlloc'd block: frees it with cudaFreeHost when
    the last view of it goes."""

    def __init__(self, lib, host: int):
        self.lib, self.ptr = lib, host

    def __del__(self):
        if self.ptr:
            self.lib.persistent_flags_free(self.ptr)
            self.ptr = 0


class MappedFlags:
    """int32 completion flags in pinned host memory mapped into the card's
    address space, which K3 writes directly and the host reads without a
    sync, also while a launch runs.

    The memory comes from ``cudaHostAlloc(..., cudaHostAllocMapped)``
    through the persistent library (``persistent_flags_alloc``; PyTorch's
    pinned allocator may register memory rather than map it), and goes
    with ``cudaFreeHost`` when the last view of it does. ``host`` is an
    int32 CPU tensor over the memory, ``device_ptr`` the address a kernel
    writes through; ``flags[a:b]`` is a view of flags a..b-1. A tensor
    taken from ``host`` is valid only while a view of it lives. Raises if
    the card cannot map host memory: there is no device-memory fallback.
    """

    def __init__(self, n: int, device):
        from repro_torch.kernels import build  # lazy: builds at first use

        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.type != "cuda" or n < 1:
            raise ValueError(f"MappedFlags: want n >= 1 flags for a CUDA"
                             f" device, got {n} on {dev}")
        lib = build.stem_persistent_library()
        host, dptr = ctypes.c_void_p(), ctypes.c_void_p()
        with torch.cuda.device(dev):
            err = lib.persistent_flags_alloc(n, ctypes.byref(host),
                                             ctypes.byref(dptr))
        if err:
            raise RuntimeError(
                f"mapped completion flags: CUDA error {err}"
                f" ({lib.error_string(err).decode()})")
        self._block = _MappedBlock(lib, host.value)
        buf = (ctypes.c_int32 * n).from_address(host.value)
        self.host = torch.from_numpy(np.ctypeslib.as_array(buf))
        self.host.zero_()
        self.device_ptr = dptr.value
        self.device = dev

    def __len__(self) -> int:
        return self.host.shape[0]

    def __getitem__(self, sl: slice) -> "MappedFlags":
        start, stop, step = sl.indices(len(self))
        if step != 1 or stop <= start:
            raise ValueError(f"MappedFlags: want a non-empty contiguous"
                             f" slice, got {sl}")
        view = object.__new__(MappedFlags)
        view._block = self._block
        view.host = self.host[start:stop]
        view.device_ptr = self.device_ptr + 4 * start
        view.device = self.device
        return view


def _flag_buffers(bt: int, dev, flags_out, counts: bool):
    """A persistent launch's flags -> (the flags it returns, their device
    pointer, zeroed device counts or None). Without ``flags_out`` the flags
    are device memory, as the counts are (one zeroed allocation); with it
    (a :class:`MappedFlags` of bt flags, in use by no running launch) the
    host zeroes the mapped flags here, and the call returns their host
    tensor."""
    if flags_out is None:
        scratch = torch.zeros((2 * bt if counts else bt,), dtype=torch.int32,
                              device=dev)
        flags = scratch[bt:] if counts else scratch
        return flags, flags.data_ptr(), scratch[:bt] if counts else None
    if not isinstance(flags_out, MappedFlags) or flags_out.device != dev \
            or len(flags_out) != bt:
        raise ValueError(f"flags_out: want MappedFlags of {bt} flags on"
                         f" {dev} (host-mapped memory), got {flags_out!r}")
    flags_out.host.zero_()
    cnt = (torch.zeros((bt,), dtype=torch.int32, device=dev) if counts
           else None)
    return flags_out.host, flags_out.device_ptr, cnt


def _check_desc(desc, dev, bt: int):
    _check_cuda("desc", desc, 2, dev, align=4)
    if tuple(desc.shape) != (bt, 3):
        raise ValueError(f"descriptor ring {tuple(desc.shape)} is not"
                         f" [{bt}, 3]")


def persistent_resident_cuda(words, tables, desc, *, n_groups: int,
                             match: str, block_b: int, flags_out=None):
    """Launch K3's resident variant (``csrc/stem_persistent.cu``): same
    contract as :func:`persistent_resident_plain`, for CUDA tensors, with
    ``flags_out`` a :class:`MappedFlags` (the flags land in host-mapped
    memory and the call returns its host tensor; else device flags). Adds
    one to ``persistent_resident_cuda.launches`` per launch and records
    the lanes a word, blocks and resident-block capacity it took
    (``build.host_resident_walk`` gives them on the host) in
    ``last_lanes``, ``last_grid`` and ``last_capacity``."""
    from repro_torch.kernels import build

    dev = _check_words(words, block_b)
    for name, t in zip(DICT_NAMES, tables):
        _check_cuda(name, t, 1, dev)
    b = words.shape[0]
    bt = desc.shape[0]
    _check_desc(desc, dev, bt)
    root = torch.empty((b, 4), dtype=torch.int32, device=dev)
    source = torch.empty((b,), dtype=torch.int32, device=dev)
    if bt == 0:
        return root, source, torch.zeros((0,), dtype=torch.int32,
                                         device=dev)
    flags, flags_ptr, counts = _flag_buffers(bt, dev, flags_out, True)
    lib = build.stem_persistent_library()
    grid = ctypes.c_int(0)
    tri, quad, bi = tables
    shared = dict_in_shared(tables, n_groups=n_groups)
    with torch.cuda.device(dev):
        err = lib.persistent_resident_launch(
            words.data_ptr(), b, desc.data_ptr(), bt, tri.data_ptr(),
            tri.shape[0], quad.data_ptr(), quad.shape[0], bi.data_ptr(),
            bi.shape[0], root.data_ptr(), source.data_ptr(), flags_ptr,
            counts.data_ptr(), block_b, n_groups, MATCHES.index(match),
            int(shared), _cuda_stream(dev), ctypes.byref(grid))
    _raise_on(err, lib, "persistent_resident")
    persistent_resident_cuda.launches += 1
    _record_shape(persistent_resident_cuda, lib,
                  "persistent_resident_last_shape")
    return root, source, flags


def persistent_streamed_cuda(words, tiles: sm.DictTileSet, desc, *,
                             n_groups: int, match: str, block_b: int,
                             flags_out=None):
    """Launch K3's streamed variant (``csrc/stem_persistent.cu``): same
    contract as :func:`persistent_streamed_plain`, for CUDA tensors, with
    ``flags_out`` as for :func:`persistent_resident_cuda`. Adds one to
    ``persistent_streamed_cuda.launches`` per launch and records the
    blocks it launched in ``last_grid``."""
    from repro_torch.kernels import build

    dev = _check_words(words, block_b)
    _check_tiles(tiles, dev)
    b = words.shape[0]
    bt = desc.shape[0]
    _check_desc(desc, dev, bt)
    root = torch.empty((b, 4), dtype=torch.int32, device=dev)
    source = torch.empty((b,), dtype=torch.int32, device=dev)
    if bt == 0:
        return root, source, torch.zeros((0,), dtype=torch.int32,
                                         device=dev)
    flags, flags_ptr, _ = _flag_buffers(bt, dev, flags_out, False)
    lib = build.stem_persistent_library()
    grid = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = lib.persistent_streamed_launch(
            words.data_ptr(), b, desc.data_ptr(), bt,
            tiles.stream.data_ptr(), tiles.fences.data_ptr(),
            *_tile_args(tiles), root.data_ptr(), source.data_ptr(),
            flags_ptr, block_b, n_groups, MATCHES.index(match),
            _cuda_stream(dev), ctypes.byref(grid))
    _raise_on(err, lib, "persistent_streamed")
    persistent_streamed_cuda.launches += 1
    persistent_streamed_cuda.last_grid = grid.value
    return root, source, flags


# every CUDA wrapper; each counts its own launches
CUDA_WRAPPERS = (stem_fused_cuda, stem_streamed_cuda,
                 persistent_resident_cuda, persistent_streamed_cuda)
for _wrapper in CUDA_WRAPPERS:
    _wrapper.launches = 0


def stem_fused(words: torch.Tensor, roots, *, infix: bool = True,
               match: str = "bsearch", block_b: int = 256,
               residency: str = "auto", dict_block_r: int = 8,
               num_buffers: int = 2, skip_index: bool = True,
               persistent: bool = False, version_slot: int = 0,
               visit_budget: int | None = None, flags_out=None):
    """words int32[B,16] + RootDictArrays (or a resolved handle) ->
    (root int32[B,4], source int32[B]) on the words' device, plus
    ``flags`` int32[batch_tiles] (``1 + version_slot`` per retired
    descriptor) when ``persistent=True``: written into ``flags_out`` if
    given (a :class:`MappedFlags` for CUDA words, a CPU tensor for CPU
    words; its host tensor is returned), else returned on the words'
    device.

    A CUDA tensor launches the CUDA kernels (or raises); a CPU tensor runs
    their plain versions. Bit-identical to ``core.stemmer.extract_roots``
    in every (residency, match, num_buffers, skip_index, persistent)
    combination. A handle's pinned residency replaces the residency
    argument, and its prebuilt tile set of matching dict_block_r is used
    as it is.
    """
    if match not in MATCHES:
        raise ValueError(f"unknown in-kernel match strategy: {match}")
    if not 1 <= num_buffers <= MAX_NUM_BUFFERS:
        raise ValueError(f"num_buffers must be in 1..{MAX_NUM_BUFFERS},"
                         f" got {num_buffers}")
    if block_b < 1:
        raise ValueError(f"block_b must be >= 1, got {block_b}")
    n_groups = 5 if infix else 2
    arrays, residency, tiles = core_stemmer.unwrap_dict(roots, residency)
    residency = choose_residency(arrays, residency, infix=infix)
    loaded = _loaded_keys(arrays, infix)
    if residency == "resident" and loaded > MAX_RESIDENT_KEYS:
        raise ValueError(
            f"dictionaries too large for residency='resident' ({loaded}"
            f" keys > {MAX_RESIDENT_KEYS}); use residency='streamed' or"
            " 'auto'")
    if words.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no stem_fused path for device {words.device}")
    on_cuda = words.device.type == "cuda"
    b = words.shape[0]
    if b == 0:  # degenerate batch: nothing to launch
        empty = (words.new_zeros((0, 4)), words.new_zeros((0,)))
        return empty + (words.new_zeros((0,)),) if persistent else empty
    bt = -(-b // block_b)

    if residency == "resident":
        tables = padded_tables(roots, match=match, infix=infix)
        kern = dict(n_groups=n_groups, match=match, block_b=block_b)
        if persistent:
            desc = _descriptors(
                bt, block_b, torch.zeros(bt, dtype=torch.int32,
                                         device=words.device), version_slot)
            run = persistent_resident_cuda if on_cuda \
                else persistent_resident_plain
            return run(words, tables, desc, flags_out=flags_out, **kern)
        run = stem_fused_cuda if on_cuda else stem_fused_plain
        return run(words, tables, **kern)

    # ---- streamed: chunked launches, no pre-pass ---------------------------
    tiles = _tiles_for(arrays, tiles, dict_block_r).to(words.device)
    max_bt = _max_chunk_tiles(tiles.n_tiles, visit_budget)
    kern = dict(n_groups=n_groups, match=match)
    outs = []
    for c0 in range(0, bt, max_bt):
        c1 = min(bt, c0 + max_bt)
        cw = words[c0 * block_b:c1 * block_b]
        if persistent:
            desc = _descriptors(c1 - c0, block_b,
                                torch.zeros(c1 - c0, dtype=torch.int32,
                                            device=words.device),
                                version_slot)
            run = persistent_streamed_cuda if on_cuda \
                else persistent_streamed_plain
            outs.append(run(cw, tiles, desc, block_b=block_b,
                            flags_out=None if flags_out is None
                            else flags_out[c0:c1], **kern))
        else:
            run = stem_streamed_cuda if on_cuda else stem_streamed_plain
            outs.append(run(cw, tiles, **kern))
    if flags_out is not None:
        host = flags_out.host if on_cuda else flags_out
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]), host)
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat(parts) for parts in zip(*outs))

// Host build of the kernels' per-word and per-tile headers, for the CPU
// tests: g++ compiles the same stages 1-4 code (stem_datapath.cuh), the
// same streamed per-key search (stem_fences.cuh), the same resident walk,
// lane split and round vote (stem_resident.cuh), the same text front-end
// rules (text_frontend.cuh), the same postings steps of both instances
// (postings.cuh), the same bank build and probe of the comparator bank
// (dict_bank.cuh) and the same fence tree and search of the sorted search
// (dict_search.cuh) that the CUDA kernels run, and the tests hold them bit
// for bit against the plain PyTorch versions. Where a kernel uses a warp
// or block primitive (a lane vote, a shuffle, a block scan, an atomic),
// the host runs a small function that does the same over the lanes in
// order.
#include <stddef.h>
#include <stdint.h>

#include <algorithm>
#include <vector>

#include "dict_bank.cuh"
#include "dict_search.cuh"
#include "postings.cuh"
#include "stem_datapath.cuh"
#include "stem_fences.cuh"
#include "stem_resident.cuh"
#include "text_frontend.cuh"

// words int32[n, 16] -> keys int32[n, 30], valid int32[n, 30] (0/1).
extern "C" void host_candidate_columns(const int32_t* words, int n,
                                       int32_t* keys, int32_t* valid) {
  for (int i = 0; i < n; ++i) {
    bool v[rt::kSlots];
    rt::candidate_columns(words + rt::kMaxLen * i, keys + rt::kSlots * i, v);
    for (int s = 0; s < rt::kSlots; ++s) valid[rt::kSlots * i + s] = v[s];
  }
}

namespace {

template <int LANES>
void host_lanes(const int32_t* words, int n, int32_t* keys,
                int32_t* valid) {
  constexpr int C = rt::kOutCols / LANES;
  for (int i = 0; i < n; ++i) {
    const int32_t* w = words + size_t(rt::kMaxLen) * i;
    rt::TermBits t{0u, 0u};
    for (int j = 0; j < LANES; ++j) {            // the group's shuffles
      int32_t codes[rt::kMaxLen / LANES];
      for (int m = 0; m < rt::kMaxLen / LANES; ++m) {
        codes[m] = w[m * LANES + j];
      }
      t = rt::merge(t, rt::lane_terms<LANES>(codes, j));
    }
    const uint32_t v = rt::valid_mask(t);
    for (int j = 0; j < LANES; ++j) {            // the lanes, in lane order
      rt::lane_columns<LANES>(w, v, j,
                              keys + size_t(rt::kOutCols) * i + j * C,
                              valid + size_t(rt::kOutCols) * i + j * C);
    }
  }
}

}  // namespace

// K6's contract (stem_candidates_launch) on the host, as a launch at
// `lanes` lanes a word (1, 2, 4 or 8) runs it: each word's lanes in lane
// order classify their positions (lane_terms), their bits are ORed as
// the group's shuffles OR them, and each lane writes its columns
// (lane_columns):
// words int32[n, 16] -> keys, valid int32[n, 32]. Returns -1 for another
// lane count.
extern "C" int host_candidate_lanes(const int32_t* words, int n, int lanes,
                                    int32_t* keys, int32_t* valid) {
  switch (lanes) {
    case 1: host_lanes<1>(words, n, keys, valid); return 0;
    case 2: host_lanes<2>(words, n, keys, valid); return 0;
    case 4: host_lanes<4>(words, n, keys, valid); return 0;
    case 8: host_lanes<8>(words, n, keys, valid); return 0;
    default: return -1;
  }
}

// The lanes a word stem_candidates_launch takes for `words` words on a
// card of `sms` SMs.
extern "C" int host_candidate_lanes_rule(long long words, int sms) {
  return rt::candidate_lanes(words, sms);
}

// The streamed kernels' contract (stem_streamed_launch), on the host, word
// by word through the same search: words int32[n_words, 16], stream
// int32[(tri_tiles + quad_tiles + bi_tiles) * tile_n], fences (the fence
// level, F = 1 << log2f) -> root int32[n_words, 4], source
// int32[n_words]. match 0 = bsearch, 1 = bank.
extern "C" void host_stem_streamed(const int32_t* words, int n_words,
                                   const int32_t* stream,
                                   const int32_t* fences, int tri_tiles,
                                   int quad_tiles, int bi_tiles, int tile_n,
                                   int log2f, int n_groups, int match,
                                   int32_t* root, int32_t* source) {
  const rt::FenceLayout l =
      rt::fence_layout(tri_tiles, quad_tiles, bi_tiles, tile_n, log2f);
  auto keys_of = n_groups == 5 ? rt::word_keys<5> : rt::word_keys<2>;
  auto search = n_groups == 5
                    ? (match == rt::kMatchBsearch
                           ? rt::search_word<rt::kMatchBsearch, 5>
                           : rt::search_word<rt::kMatchBank, 5>)
                    : (match == rt::kMatchBsearch
                           ? rt::search_word<rt::kMatchBsearch, 2>
                           : rt::search_word<rt::kMatchBank, 2>);
  for (int i = 0; i < n_words; ++i) {
    int32_t keys[rt::kSlots], chosen, src;
    const uint32_t live = keys_of(words + size_t(rt::kMaxLen) * i, keys);
    search(keys, live, fences, stream, l, chosen, src);
    root[4 * size_t(i) + 0] = (chosen >> 18) & 63;
    root[4 * size_t(i) + 1] = (chosen >> 12) & 63;
    root[4 * size_t(i) + 2] = (chosen >> 6) & 63;
    root[4 * size_t(i) + 3] = chosen & 63;
    source[i] = src;
  }
}

namespace {

// A word's first hit (its slot, -1: none; its key in chosen) as a group
// of `lanes` lanes finds it on the card: one lane's unrolled walk of the
// live slots for G = 1, else rounds of each lane's two searches and the
// group's vote (__ballot_sync) as the lanes' bits in lane order, the
// winner's key as its lane hands it over (__shfl_sync).
template <int MATCH, int N_GROUPS>
int host_group_search(const int32_t keys[rt::kSlots], uint32_t live,
                      const rt::Tables& t, int lanes, int32_t& chosen) {
  if (lanes == 1) {
    return rt::first_live_hit<MATCH, true, N_GROUPS>(keys, live, t, chosen);
  }
  uint32_t rest = live;
  int win = -1;
  chosen = 0;
  while (rest != 0 && win < 0) {
    uint32_t va = 0, vb = 0;
    int32_t ka[rt::kMaxLanes], kb[rt::kMaxLanes];
    for (int j = 0; j < lanes; ++j) {
      bool ha, hb;
      rt::lane_hits<MATCH, true>(keys, rt::nth_slot(rest, j),
                                 rt::nth_slot(rest, lanes + j), t, ha, hb,
                                 ka[j], kb[j]);
      va |= uint32_t(ha) << j;
      vb |= uint32_t(hb) << j;
    }
    const int p = rt::round_winner(va, vb, lanes);
    if (p >= 0) {
      win = rt::nth_slot(rest, p);
      chosen = p < lanes ? ka[p] : kb[p - lanes];
    }
    rest = rt::drop_round(rest, lanes);
  }
  return win;
}

template <int MATCH, int N_GROUPS>
void host_resident(const int32_t* words, int n_words, const int32_t* desc,
                   const rt::Tables& t, const rt::Walk& w, int grid,
                   int32_t* root, int32_t* source, int32_t* counts,
                   int32_t* flags) {
  for (int b = 0; b < grid; ++b) {               // the blocks, in turn
    for (int i = b; i < w.n_items; i += grid) {
      const rt::Item it = rt::walk_item(w, i);
      for (int g = 0; g < w.width; ++g) {        // a group of lanes a word
        const rt::Place p = rt::walk_place(w, g);
        for (int d = it.d0 + p.ts; p.ts >= 0 && d < it.d0 + it.nd;
             d += w.stride) {
          const long long r = rt::tile_word(w, it, p, d, desc, n_words);
          if (r < 0) continue;
          int32_t keys[rt::kSlots], chosen;
          const uint32_t live =
              rt::word_keys<N_GROUPS>(words + size_t(rt::kMaxLen) * r, keys);
          const int win = host_group_search<MATCH, N_GROUPS>(
              keys, live, t, w.lanes, chosen);
          const int32_t src = win < 0 ? 0 : rt_group_tag(win / rt::kCand);
          root[4 * r + 0] = (chosen >> 18) & 63;
          root[4 * r + 1] = (chosen >> 12) & 63;
          root[4 * r + 2] = (chosen >> 6) & 63;
          root[4 * r + 3] = chosen & 63;
          source[r] = src;
        }
      }
      if (desc == nullptr) continue;             // the retire (rt::retire)
      if (w.parts == 1) {
        for (int k = 0; k < it.nd; ++k) {
          flags[it.d0 + k] = 1 + desc[3 * (it.d0 + k) + 2];
        }
      } else if (counts[it.d0]-- == 1 - w.parts) {
        flags[it.d0] = 1 + desc[3 * it.d0 + 2];
      }
    }
  }
}

}  // namespace

// The walk a resident launch takes (stem_resident.cuh): words on a card
// of `sms` SMs, K1's (its words one tile, a block an item; n_tiles,
// block_b and capacity not read) or K3's (persistent: n_tiles tiles of
// block_b, `capacity` resident blocks); lanes 0 for the launcher's rule
// -> out[7] = lanes, width, per, parts, n_items, grid, stride.
extern "C" void host_resident_walk(long long words, int n_tiles, int block_b,
                                   int capacity, int sms, int persistent,
                                   int lanes, int* out) {
  if (lanes == 0) lanes = rt::resident_lanes(words, sms);
  const rt::Walk w =
      persistent ? rt::resident_walk(n_tiles, block_b, rt::kResidentThreads,
                                     lanes, capacity, rt::kMaxRounds)
                 : rt::fused_walk(int(words), lanes);
  const int grid =
      persistent && capacity < w.n_items ? capacity : w.n_items;
  const int v[7] = {w.lanes, w.width, w.per, w.parts, w.n_items, grid,
                    w.stride};
  for (int k = 0; k < 7; ++k) out[k] = v[k];
}

// Both resident kernels' contracts on the host, block by block through
// the same walk, each word through the same lane split and round vote
// (stem_fused_launch with desc null, n_tiles, block_b and capacity
// ignored; else persistent_resident_launch over desc int32[n_tiles, 3],
// flags zeroed by the caller): `lanes` a word (1, 2, 4 or 8) and
// `capacity` resident blocks as a launch on the card would take them.
// Returns the blocks.
extern "C" int host_stem_resident(const int32_t* words, int n_words,
                                  const int32_t* desc, int n_tiles,
                                  const int32_t* tri, int tri_n,
                                  const int32_t* quad, int quad_n,
                                  const int32_t* bi, int bi_n, int32_t* root,
                                  int32_t* source, int32_t* flags,
                                  int block_b, int n_groups, int match,
                                  int lanes, int capacity) {
  if (desc == nullptr && n_words <= 0) return 0;
  const rt::Walk w =
      desc == nullptr
          ? rt::fused_walk(n_words, lanes)
          : rt::resident_walk(n_tiles, block_b, rt::kResidentThreads, lanes,
                              capacity, rt::kMaxRounds);
  const int grid =
      desc != nullptr && capacity < w.n_items ? capacity : w.n_items;
  // a tile in pieces counts them down here, apart from its flag
  std::vector<int32_t> counts(desc == nullptr ? 0 : n_tiles, 0);
  if (match == rt::kMatchBsearch) {
    const rt::Tables t = rt::make_tables<rt::kMatchBsearch>(
        tri, tri_n, quad, quad_n, bi, bi_n);
    (n_groups == 5 ? host_resident<rt::kMatchBsearch, 5>
                   : host_resident<rt::kMatchBsearch, 2>)(
        words, n_words, desc, t, w, grid, root, source, counts.data(),
        flags);
  } else {
    const rt::Tables t = rt::make_tables<rt::kMatchBank>(
        tri, tri_n, quad, quad_n, bi, bi_n);
    (n_groups == 5 ? host_resident<rt::kMatchBank, 5>
                   : host_resident<rt::kMatchBank, 2>)(
        words, n_words, desc, t, w, grid, root, source, counts.data(),
        flags);
  }
  return grid;
}

// The lanes a word text_frontend_launch takes for `rows` rows on a card
// of `sms` SMs.
extern "C" int host_text_lanes(long long rows, int sms) {
  return tf::frontend_lanes(rows, sms);
}

// The text front end's contract (text_frontend_launch) on the host, as a
// launch at `lanes` lanes a word (1 or 8) runs it, block by block through
// the same steps: each block's pieces read and their live rows listed in
// piece order (list_rows, at the block scan's offsets, summed here in
// thread order), its empty rows cleared a warp a piece (clear_lane), its
// live rows a word a group in the kernel's order of rounds (word_row, or
// lane_word over HostLanes): chars int32[t], starts/lens int32[wp], lut
// int32[256], fw int32[fw_n] -> words int32[wp, 16] (rows no block writes
// keep what was there). Returns the blocks.
extern "C" int host_text_frontend(const int32_t* chars, long long t,
                                  const int32_t* starts, const int32_t* lens,
                                  int wp, const int32_t* lut,
                                  const int32_t* fw, int fw_n, int lanes,
                                  int32_t* words) {
  if (wp <= 0) return 0;
  if (lanes != 1 && lanes != 8) return -1;
  const long long tp = (t + 127) / 128 * 128;
  const int steps = tf::ceil_log2(fw_n);
  const long long grid = tf::frontend_grid(wp, lanes);
  const long long pieces = tf::n_pieces(wp);
  const int groups = tf::kThreads / lanes;
  const tf::HostLanes<8> g8;
  std::vector<int32_t> list(groups * tf::kPieceRows),
      list_start(list.size()), list_len(list.size());
  std::vector<uint32_t> live(groups);
  for (long long b = 0; b < grid; ++b) {
    int total = 0;                               // 1. the live rows
    for (int k = 0; k < groups; ++k) {
      const long long p = tf::piece_of(b, k, grid);
      int32_t start[tf::kPieceRows], len[tf::kPieceRows];
      live[k] = p < pieces ? tf::piece_rows(starts, lens, wp, p, start, len)
                           : 0;
      tf::list_rows(live[k], p, start, len, total, list.data(),
                    list_start.data(), list_len.data());
      total += tf::popc(live[k]);
    }
    for (int k = 0; k < groups; ++k) {           // 2. the empty rows
      for (int lane = 0; lane < 32; ++lane) {
        tf::clear_lane(words, wp, pieces, tf::piece_of(b, k, grid), live[k],
                       lane);
      }
    }
    for (int tid = 0; tid < tf::kThreads; tid += lanes) {   // 3. the words
      if (lanes == 1) {
        for (int i = tid; i < total; i += groups) {
          tf::word_row(chars, t, tp, list_start[i], list_len[i], lut, fw,
                       fw_n, steps, words + size_t(list[i]) * tf::kRow);
        }
        continue;
      }
      for (int i0 = tid / 32 * (32 / lanes); i0 < total; i0 += groups) {
        const int i = i0 + tid % 32 / lanes;
        const bool has = i < total;
        tf::lane_word(g8, chars, t, tp, has ? list_start[i] : 0,
                      has ? list_len[i] : 0, lut, fw, fw_n, has,
                      words + size_t(has ? list[i] : 0) * tf::kRow);
      }
    }
  }
  return int(grid);
}

// The postings kernel's contract (postings_launch), on the host, one tile
// at a time through the same network, stage by stage: ids int32[n_tiles,
// block_w] -> hist int32[n_tiles, n_roots_pad], rank int32[n_tiles,
// block_w].
extern "C" void host_postings(const int32_t* ids, int n_tiles, int block_w,
                              int n_roots_pad, int32_t* hist,
                              int32_t* rank) {
  int log_bw = 0;
  while ((1 << log_bw) < block_w) ++log_bw;
  std::vector<int32_t> keys(block_w);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int32_t* tile_ids = ids + size_t(tile) * block_w;
    for (int l = 0; l < block_w; ++l) keys[l] = tile_ids[l] * block_w + l;
    for (int k = 2; k <= block_w; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int p = 0; p < block_w / 2; ++p) pk::exchange(keys.data(), k, j, p);
      }
    }
    for (int r = 0; r < n_roots_pad; ++r) {
      hist[size_t(tile) * n_roots_pad + r] =
          pk::bucket(keys.data(), block_w, log_bw, r);
    }
    for (int p = 0; p < block_w; ++p) {
      int lane;
      int32_t rk;
      pk::rank_of(keys.data(), block_w, log_bw, p, &lane, &rk);
      rank[size_t(tile) * block_w + lane] = rk;
    }
  }
}

namespace {

// __ballot_sync over a group of n lanes: the lanes whose predicate is set,
// the in-slice flag for bit < 0, else bit `bit` of the id's bin within the
// slice [lo, lo + len).
uint32_t ballot(const int32_t* group, int n, int lo, int len, int bit) {
  uint32_t m = 0;
  for (int l = 0; l < n; ++l) {
    const bool set = bit < 0 ? pk::in_slice(group[l], lo, len)
                             : (pk::bin_of(group[l], lo) >> bit) & 1;
    m |= uint32_t(set) << l;
  }
  return m;
}

}  // namespace

// The instance a shape takes (postings_instance), on the host.
extern "C" int host_postings_instance(int block_w, int n_roots_pad,
                                      int max_smem) {
  return pk::instance(block_w, n_roots_pad, size_t(max_smem));
}

// The bins a block of the counting (1) or sliced (2) instance counts.
extern "C" int host_postings_slice_bins(int instance, int block_w,
                                        int n_roots_pad) {
  return pk::slice_bins(instance, block_w, n_roots_pad);
}

// The counting (instance 1) or sliced (2) instance's contract on the host:
// a tile's slices one after another in one block's counters (zeroed once
// a tile, the marked quads cleared between slices, as a block that takes
// every slice of its tile does), each block's warps one after another,
// each group of 32 lanes through the same steps in lane order: ids
// int32[n_tiles, block_w] (any int32) -> hist int32[n_tiles, n_roots_pad],
// rank int32[n_tiles, block_w]. block_w <= kCountMaxBlockW.
extern "C" void host_postings_counting(const int32_t* ids, int n_tiles,
                                       int block_w, int n_roots_pad,
                                       int instance, int32_t* hist,
                                       int32_t* rank) {
  const int warps = pk::count_warps(block_w);
  const int per_warp = block_w / warps;
  const int bins = pk::slice_bins(instance, block_w, n_roots_pad);
  const int n_slices = pk::slice_count(n_roots_pad, bins);
  const int words = pk::quad_words(bins);
  std::vector<uint16_t> counts(size_t(warps) * bins);
  std::vector<uint32_t> marked(words);
  std::vector<int32_t> rk(block_w);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int32_t* tile_ids = ids + size_t(tile) * block_w;
    int32_t* h = hist + size_t(tile) * n_roots_pad;
    std::fill(counts.begin(), counts.end(), uint16_t(0));
    std::fill(marked.begin(), marked.end(), 0u);
    for (int s = 0; s < n_slices; ++s) {
      const int lo = s * bins;
      const int len = std::min(bins, n_roots_pad - lo);
      const int bits = pk::id_bits(len);
      for (int w = 0; w < warps; ++w) {
        uint16_t* mine = counts.data() + size_t(w) * bins;
        for (int g0 = 0; g0 < per_warp; g0 += pk::kWarp) {
          const int width = std::min(pk::kWarp, per_warp - g0);
          const int32_t* group = tile_ids + w * per_warp + g0;
          const uint32_t any = ballot(group, width, lo, len, -1);
          if (any == 0) continue;
          const uint32_t active = width == pk::kWarp ? 0xffffffffu
                                                     : (1u << width) - 1u;
          uint32_t peers[pk::kWarp], base[pk::kWarp] = {0};
          for (int l = 0; l < width; ++l) {
            const bool in = pk::in_slice(group[l], lo, len);
            const uint32_t bin = pk::bin_of(group[l], lo);
            peers[l] = pk::narrow(active, any, in);
            for (int b = 0; b < bits; ++b) {
              peers[l] = pk::narrow(peers[l],
                                    ballot(group, width, lo, len, b),
                                    (bin >> b) & 1);
            }
            if (l == pk::lowest_lane(peers[l]) && in) {
              base[l] = pk::bump(mine, bin, peers[l]);
              pk::mark(marked.data(), bin);
            }
          }
          for (int l = 0; l < width; ++l) {      // __shfl_sync from the leader
            rk[w * per_warp + g0 + l] = pk::group_rank(
                base[pk::lowest_lane(peers[l])], peers[l], l);
          }
        }
      }
      for (int w = 0; w < words; ++w) {          // the marked quads
        for (int lane = 0; lane < pk::kWarp; ++lane) {
          if (marked[w] >> lane & 1) {
            pk::scan_quad(counts.data(), warps, bins, 4 * (32 * w + lane));
          }
        }
      }
      std::copy(counts.begin(), counts.begin() + len, h + lo);   // warp 0's
      for (int l = 0; l < block_w; ++l) {
        const int32_t id = tile_ids[l];
        int32_t* out = rank + size_t(tile) * block_w + l;
        if (pk::in_slice(id, lo, len)) {
          *out = rk[l] + pk::earlier(counts.data(), l / per_warp, bins,
                                     pk::bin_of(id, lo));
        } else if (s == 0 && !pk::counted(id, n_roots_pad)) {
          *out = pk::rank_by_scan(tile_ids, l, id);
        }
      }
      for (int w = 0; w < words; ++w) {          // back to 0
        for (int lane = 0; lane < pk::kWarp; ++lane) {
          if (marked[w] >> lane & 1) {
            pk::clear_quad(counts.data(), warps, bins, 4 * (32 * w + lane));
          }
        }
        marked[w] = 0;
      }
    }
  }
}

// The banked comparator bank's contract (dict_match_bank_launch) on the
// host, chunk by chunk: each chunk banked (sizes, an exclusive scan, a
// scatter, in entry order where the kernel's atomics take any), every key
// probed against its bank, hits ORed over the chunks: keys int32[n], dict
// int32[r] read as the table padded with -2 to rp entries -> out uint8[n].
extern "C" void host_dict_bank(const int32_t* keys, int n,
                               const int32_t* dict, int r, int rp, int chunk,
                               uint8_t* out) {
  const int bits = db::bank_bits(chunk);
  std::vector<uint32_t> banks(size_t(1) << bits);
  std::vector<int32_t> entries(size_t(chunk) + 2);   // and the spare words
  std::fill(out, out + n, uint8_t(0));
  for (long long c0 = 0; c0 < rp; c0 += chunk) {
    const int len = int(std::min<long long>(chunk, rp - c0));
    std::fill(banks.begin(), banks.end(), 0u);
    for (long long i = c0; i < c0 + len; ++i) {
      if (db::kept(dict, r, c0, i)) {
        banks[db::bank_of(db::entry(dict, r, i), bits)] += 1u << 16;
      }
    }
    uint32_t run = 0;                            // the block's scan
    for (uint32_t& w : banks) {
      const uint32_t size = w >> 16;
      w = db::bank_start(w, run);
      run += size;
    }
    for (long long i = c0; i < c0 + len; ++i) {
      if (db::kept(dict, r, c0, i)) {
        const int32_t v = db::entry(dict, r, i);
        entries[banks[db::bank_of(v, bits)]++ & 0xffffu] = v;
      }
    }
    const int quads = n / 4;                     // 4 keys a probe, as K7
    for (int q = 0; q < quads; ++q) {
      const uint32_t flags =
          db::probe4(entries.data(), banks.data(), bits, keys + 4 * q);
      for (int u = 0; u < 4; ++u) out[4 * q + u] |= (flags >> (8 * u)) & 1;
    }
    for (int i = 4 * quads; i < n; ++i) {        // the ragged tail
      out[i] |= uint8_t(db::probe(entries.data(), banks.data(), bits,
                                  keys[i]));
    }
  }
}

// The sorted search's instance (0 shared, 1 global) for a table padded to
// rp entries, as dict_match_bsearch_launch picks it.
extern "C" int host_bsearch_instance(int rp) { return ds::instance(rp); }

// The sorted search's contract (dict_match_bsearch_launch) on the host, as
// a block of instance `inst` (0 shared, 1 global) of a launch of `grid`
// blocks runs it: the tree staged as the kernel stages it (the whole
// padded table, or every S-th entry with S by the launch; the global
// instance reads the dictionary and its padding virtually), keys four at
// a time through the same search, the ragged tail one by one: keys
// int32[n], dict int32[r] sorted, read as the table padded with the
// sentinel to rp entries -> out uint8[n]. Returns log2 S.
extern "C" int host_dict_bsearch(const int32_t* keys, int n,
                                 const int32_t* dict, int r, int rp, int inst,
                                 int grid, uint8_t* out) {
  const int log2s = ds::log2_step(rp, inst, n, grid);
  const int levels = ds::log2_of(rp) - log2s;
  std::vector<int32_t> tree(size_t(1) << levels);
  for (int j = 0; j < (1 << levels); ++j) {
    tree[j] = ds::entry(dict, r, ds::node_entry(j, levels, log2s));
  }
  const ds::GlobalTable t{dict, r,
                          reinterpret_cast<uintptr_t>(dict) % 16 == 0};
  auto four = inst == ds::kShared ? ds::search<4, ds::kShared>
                                  : ds::search<4, ds::kGlobal>;
  auto one = inst == ds::kShared ? ds::search<1, ds::kShared>
                                 : ds::search<1, ds::kGlobal>;
  const int quads = n / 4;
  for (int q = 0; q < quads; ++q) {
    const uint32_t flags = four(tree.data(), levels, log2s, t, keys + 4 * q);
    for (int u = 0; u < 4; ++u) out[4 * q + u] = (flags >> (8 * u)) & 1;
  }
  for (int i = 4 * quads; i < n; ++i) {
    out[i] = uint8_t(one(tree.data(), levels, log2s, t, keys + i));
  }
  return log2s;
}

// Host build of the kernels' per-word and per-tile headers, for the CPU
// tests: g++ compiles the same stages 1-4 code (stem_datapath.cuh), the
// same streamed per-tile compare (stem_sweep.cuh), the same text front-end
// rules (text_frontend.cuh) and the same postings sort and searches
// (postings.cuh) that the CUDA kernels run, and the tests hold them bit
// for bit against the plain PyTorch versions.
#include <stddef.h>
#include <stdint.h>

#include <vector>

#include "postings.cuh"
#include "stem_datapath.cuh"
#include "stem_sweep.cuh"
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

// What one block of the streamed kernel computes, run sequentially: the
// block's words, then its visit list tile by tile (the block-wide vote
// becomes an any over the tile's words), then the first hit per word.
template <int MATCH, int N_GROUPS>
void streamed_tiles(const int32_t* words, int n_words, const int32_t* stream,
                    int n_tiles, const int32_t* n_visits,
                    const int32_t* visit_idx, int block_b, int tile_n,
                    int tri_tiles, int quad_tiles, int32_t* root,
                    int32_t* source) {
  const int bt = (n_words + block_b - 1) / block_b;
  const int steps = rt::sweep_log2(tile_n);
  std::vector<int32_t> keys(size_t(block_b) * rt::kSlots);
  std::vector<uint32_t> live(block_b), mask(block_b);
  for (int b = 0; b < bt; ++b) {
    for (int j = 0; j < block_b; ++j) {
      const long long i = (long long)b * block_b + j;
      int32_t w[rt::kMaxLen] = {0};
      if (i < n_words) {
        for (int c = 0; c < rt::kMaxLen; ++c) {
          w[c] = words[rt::kMaxLen * i + c];
        }
      }
      bool v[rt::kSlots];
      rt::candidate_columns(w, &keys[size_t(j) * rt::kSlots], v);
      live[j] = rt::live_mask<N_GROUPS>(v);
      mask[j] = 0;
    }
    const int32_t* vis = visit_idx + size_t(b) * n_tiles;
    for (int k = 0; k < n_visits[b]; ++k) {
      const int32_t* tile = stream + size_t(vis[k]) * tile_n;
      const int table = rt::tile_table(vis[k], tri_tiles, quad_tiles);
      bool vote = false;
      for (int j = 0; j < block_b; ++j) {
        vote = vote || rt::tile_in_range<N_GROUPS>(
                           &keys[size_t(j) * rt::kSlots], live[j], table,
                           tile[0], tile[tile_n - 1]);
      }
      if (!vote) continue;
      for (int j = 0; j < block_b; ++j) {
        mask[j] = rt::tile_hits<MATCH, N_GROUPS>(
            tile, tile_n, steps, table, &keys[size_t(j) * rt::kSlots],
            live[j], mask[j]);
      }
    }
    for (int j = 0; j < block_b; ++j) {
      const long long i = (long long)b * block_b + j;
      if (i >= n_words) break;
      int32_t chosen, src;
      rt::first_hit(&keys[size_t(j) * rt::kSlots], mask[j], chosen, src);
      root[4 * i + 0] = (chosen >> 18) & 63;
      root[4 * i + 1] = (chosen >> 12) & 63;
      root[4 * i + 2] = (chosen >> 6) & 63;
      root[4 * i + 3] = chosen & 63;
      source[i] = src;
    }
  }
}

}  // namespace

// The streamed kernel's contract (stem_streamed_launch), on the host:
// words int32[n_words, 16], stream int32[n_tiles * dict_block_r * 128],
// n_visits int32[bt], visit_idx int32[bt, n_tiles] -> root int32[n_words,
// 4], source int32[n_words]. match 0 = bsearch, 1 = bank.
extern "C" void host_stem_streamed(const int32_t* words, int n_words,
                                   const int32_t* stream, int n_tiles,
                                   const int32_t* n_visits,
                                   const int32_t* visit_idx, int block_b,
                                   int dict_block_r, int tri_tiles,
                                   int quad_tiles, int n_groups, int match,
                                   int32_t* root, int32_t* source) {
  const int tile_n = dict_block_r * 128;
  auto run = n_groups == 5
                 ? (match == rt::kMatchBsearch
                        ? streamed_tiles<rt::kMatchBsearch, 5>
                        : streamed_tiles<rt::kMatchBank, 5>)
                 : (match == rt::kMatchBsearch
                        ? streamed_tiles<rt::kMatchBsearch, 2>
                        : streamed_tiles<rt::kMatchBank, 2>);
  run(words, n_words, stream, n_tiles, n_visits, visit_idx, block_b, tile_n,
      tri_tiles, quad_tiles, root, source);
}

// The text front end's contract (text_frontend_launch), on the host, every
// row through the per-word rules (empty rows too): chars int32[t],
// starts/lens int32[wp], lut int32[256], fw int32[fw_n] -> words
// int32[wp, 16].
extern "C" void host_text_frontend(const int32_t* chars, long long t,
                                   const int32_t* starts,
                                   const int32_t* lens, int wp,
                                   const int32_t* lut, const int32_t* fw,
                                   int fw_n, int32_t* words) {
  const long long tp = (t + 127) / 128 * 128;
  const int steps = tf::ceil_log2(fw_n);
  for (int r = 0; r < wp; ++r) {
    tf::word_row(chars, t, tp, starts[r], lens[r], lut, fw, fw_n, steps,
                 words + size_t(r) * tf::kRow);
  }
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

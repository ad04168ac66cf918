// Host build of stem_datapath.cuh's per-word functions, for the CPU tests:
// g++ compiles the same stages 1-4 code the CUDA megakernel runs, and a
// test holds it bit for bit against the plain PyTorch candidate_columns.
#include <stdint.h>

#include "stem_datapath.cuh"

// words int32[n, 16] -> keys int32[n, 30], valid int32[n, 30] (0/1).
extern "C" void host_candidate_columns(const int32_t* words, int n,
                                       int32_t* keys, int32_t* valid) {
  for (int i = 0; i < n; ++i) {
    bool v[rt::kSlots];
    rt::candidate_columns(words + rt::kMaxLen * i, keys + rt::kSlots * i, v);
    for (int s = 0; s < rt::kSlots; ++s) valid[rt::kSlots * i + s] = v[s];
  }
}

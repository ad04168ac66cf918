// The banked comparator bank's steps (K7), shared by the CUDA kernel
// (dict_match.cu) and a host build the CPU tests check bit for bit
// against the plain version (kernels/stem_match.py).
//
// The padded table is split into 2^bits banks by a hash of the value, as
// a large CAM is banked: a key is compared with every entry of its own
// bank and no other, on average about one entry instead of all of them.
// The table may be in any order, with duplicates and arbitrary int32
// values; a table larger than one block's shared memory is banked in
// chunks of at most kChunkMax entries, and a key's flags OR over them.
// Every hash is exact: a table whose entries all fall in one bank only
// costs more compares.
//
// Layout of a banked chunk: banks uint32[2^bits] and entries
// int32[chunk]. Bank b's word holds its size in the high 16 bits and its
// end in the low 16 (chunks hold at most kChunkMax < 2^16 entries), so a
// key reads one word for its bank: bank b is entries[end - size, end).
// The build fills the words in three steps: each kept entry adds 1 << 16
// (the size), an exclusive scan of the sizes sets the low half to the
// bank's start, and the scatter adds 1 to the low half for each entry it
// places there, which leaves the bank's end.
#pragma once

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#define DB_HD __host__ __device__ __forceinline__
#else
#define DB_HD inline
#endif

namespace db {

constexpr uint32_t kHashMul = 0x9E3779B1u;   // odd: 2^32 / golden ratio
constexpr int kMinBits = 5;
// entries a block banks at once: 64 KB of entries and bounds
constexpr int kChunkMax = 8192;

// Banks of a chunk of up to `chunk` entries: the power of two at or above
// it, at least 2^kMinBits (at most one entry a bank on average).
DB_HD int bank_bits(int chunk) {
  int bits = kMinBits;
  while ((1 << bits) < chunk) ++bits;
  return bits;
}

// Entry i of the table padded with -2 to rp entries, of which the first r
// are the dictionary's: the padding is read, not stored.
DB_HD int32_t entry(const int32_t* dict, int r, long long i) {
  return i < r ? dict[i] : -2;
}

// A value's bank: the top `bits` bits of its multiplicative hash, defined
// for every int32 (negative keys and the -2 padding included).
DB_HD uint32_t bank_of(int32_t v, int bits) {
  return (uint32_t(v) * kHashMul) >> (32 - bits);
}

// Entry i of the padded table goes into a bank unless it repeats entry
// i - 1 of the same chunk (c0 its first): the padding is one run of -2,
// and a repeat cannot change membership.
DB_HD bool kept(const int32_t* dict, int r, long long c0, long long i) {
  return i == c0 || entry(dict, r, i) != entry(dict, r, i - 1);
}

// Shared-memory bytes of a banked chunk of up to `chunk` entries: the bank
// words, the entries and two spare words after them (a probe may read the
// first two entries of an empty bank at the end, and ignores them).
DB_HD size_t smem_bytes(int chunk) {
  return sizeof(int32_t) *
         ((size_t(1) << bank_bits(chunk)) + size_t(chunk) + 2);
}

// The scan's step for bank word w, given the sizes of the banks before it:
// the size stays, the low half becomes the bank's start.
DB_HD uint32_t bank_start(uint32_t w, uint32_t before) {
  return (w & 0xffff0000u) | before;
}

// Four keys against their banks, the loads of all four issued together:
// the four bank words, then the first two entries of each bank (the two
// spare words keep the reads in bounds), then the rest of any bank with
// more than two entries -> the four flags, one a byte, key 0 lowest.
DB_HD uint32_t probe4(const int32_t* entries, const uint32_t* banks,
                      int bits, const int32_t* k) {
  uint32_t w[4];
  int32_t e0[4], e1[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) w[u] = banks[bank_of(k[u], bits)];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int start = int(w[u] & 0xffffu) - int(w[u] >> 16);
    e0[u] = entries[start];
    e1[u] = entries[start + 1];
  }
  uint32_t flags = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int size = int(w[u] >> 16), end = int(w[u] & 0xffffu);
    bool hit = (size > 0 && e0[u] == k[u]) || (size > 1 && e1[u] == k[u]);
    for (int j = end - size + 2; j < end; ++j) hit |= entries[j] == k[u];
    flags |= uint32_t(hit) << (8 * u);
  }
  return flags;
}

// A key against every entry of its bank.
DB_HD bool probe(const int32_t* entries, const uint32_t* banks, int bits,
                 int32_t key) {
  const uint32_t w = banks[bank_of(key, bits)];
  const int end = int(w & 0xffffu);
  bool hit = false;
  for (int j = end - int(w >> 16); j < end; ++j) hit |= entries[j] == key;
  return hit;
}

}  // namespace db

// The size and the key hash of the per-bucket open-addressing tables of
// hash_groupby and hash_semi.
//
// Every key of a bucket shares the hash bits that chose its bucket (its
// hash chain modulo B, fused_bucketing/ref.py:bucket_ids), so a table
// inside a bucket must not index by those bits: key_hash runs murmur3's
// finaliser over a running product of the planes, another function of
// the key, whose low bits do not follow the bucket's.
#pragma once

#include <cuda_runtime.h>

namespace repro {

// The table's size for C slots: a power of two above C, so a probe
// always meets an empty entry.
__host__ __device__ __forceinline__ int table_size(int C) {
  int t = 1;
  while (t <= C) t <<= 1;
  return t;
}

// Key planes 0 .. ks - 1 (ks <= N) hashed for the table.
template <int N>
__device__ __forceinline__ unsigned key_hash(const int (&key)[N], int ks) {
  unsigned h = 0x9e3779b9u;
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (k < ks) h = (h ^ static_cast<unsigned>(key[k])) * 0x85ebca6bu;
  h ^= h >> 16;
  h *= 0xc2b2ae35u;
  return h ^ (h >> 13);
}

}  // namespace repro

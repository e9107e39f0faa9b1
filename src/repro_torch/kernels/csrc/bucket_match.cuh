// The bucket compare of the bucketed join probe (hash_join.cu, its only
// user since hash_semi.cu looks its probes up in a per-bucket hash table):
// which staged build slots of a bucket carry the same K key planes as one
// probe slot.
//
// Layout: a block of kWarps warps takes one bucket (blockIdx.x) and
// walks its probe slots in groups of kWarps * S (groups blockIdx.y,
// + gridDim.y, ...), warp w the S slots from l0 = group * kWarps * S +
// w * S.  S, the slots per warp, is 32 unless the grid would then have
// fewer blocks than the card has SMs: it halves until it has as many, so
// a few wide buckets still spread over the card.  Lane l < S loads slot
// l0 + l's occupancy and key: the loads of a warp are coalesced and all in
// flight at once.  The warp then takes the slots one after another, each
// lane getting the slot's key from its owner by __shfl_sync.  The bucket's
// build slab sits in shared memory `cj` slots at a time ([K][cj] key
// planes, then [cj] occupancy): cj is C when the slab fits in the shared
// memory a block may opt in to, and the slab is then staged once per
// block; else it streams through chunk by chunk for every group, so a slab
// of any width C runs.  A warp compares one probe slot against 32 staged
// build slots per step, lane l on slot c0 + l: the reads of a plane are
// consecutive words, free of bank conflicts.  The key's planes are
// compared in a loop over k, so any K runs: the first travels in a
// register, further ones are read from the L1-cached probe slab.
#pragma once

#include "tile_rank.cuh"

namespace repro {

constexpr int kSMs = 132;            // H100 SXM
constexpr int kTargetBlocks = kSMs * 32;

struct ProbeLaunch {
  dim3 grid;
  int per_warp;                      // S: probe slots per warp
};

// S = the most slots per warp (32, 16, ..., 1) that gives one block per
// bucket and group at least kSMs blocks.  Then one block per bucket and
// per share of its groups: enough shares for about kTargetBlocks blocks,
// at most one per group and 65535 per bucket.  Fewer, longer blocks
// stage a bucket's slab fewer times.
inline ProbeLaunch probe_launch(int B, int Lc) {
  auto groups = [&](int per_warp) {
    const int per_block = kWarps * per_warp;
    return (Lc + per_block - 1) / per_block;
  };
  int s = 32;
  while (s > 1 && static_cast<int64_t>(B) * groups(s) < kSMs) s /= 2;
  int shares = (kTargetBlocks + B - 1) / B;
  if (shares > groups(s)) shares = groups(s);
  if (shares > 65535) shares = 65535;
  return {dim3(static_cast<unsigned>(B), static_cast<unsigned>(shares)), s};
}

// Stage build slots [j0, j0 + jn) of one bucket, bb (K, C) key planes and
// bo (C,) occupancy, into skey [K][cj] and socc [cj].
__device__ __forceinline__ void stage_build(const int* __restrict__ bb,
                                            const int* __restrict__ bo, int K,
                                            int C, int j0, int jn, int cj,
                                            int* skey, int* socc) {
  for (int t = threadIdx.x; t < jn; t += blockDim.x) {
    for (int k = 0; k < K; ++k)
      skey[k * cj + t] = bb[static_cast<int64_t>(k) * C + j0 + t];
    socc[t] = bo[j0 + t];
  }
}

// Does staged build slot c (occupied, c < jn) carry the probe key whose
// plane 0 is key0 and whose plane k is pkey[k * Lc]?  With one key plane
// (kOneKey: every int32 or float32 key) the test has no branch, a lane
// past jn reading slot 0 and masking it out, so the compiler unrolls the
// chain walk around it.  Else an empty slot and the first unequal plane
// end the test.
template <bool kOneKey>
__device__ __forceinline__ bool staged_match(const int* skey,
                                             const int* socc, int cj, int c,
                                             int jn, int key0,
                                             const int* __restrict__ pkey,
                                             int K, int Lc) {
  if (kOneKey) {
    const int cc = c < jn ? c : 0;
    return (c < jn) & (socc[cc] > 0) & (skey[cc] == key0);
  }
  if (c >= jn || socc[c] <= 0 || skey[c] != key0) return false;
  for (int k = 1; k < K; ++k)
    if (skey[k * cj + c] != __ldg(pkey + static_cast<int64_t>(k) * Lc))
      return false;
  return true;
}

}  // namespace repro

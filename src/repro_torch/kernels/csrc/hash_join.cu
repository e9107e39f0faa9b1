// Bucketed hash-join probe: per bucket, the probe slots' match counts and
// each matching (probe slot, chain slot) pair's exclusive rank.
//
// Replaces the TPU kernel bucket_probe_buckets
// (src/repro/kernels/hash_join/kernel.py), which materialises each
// bucket's dense (Lc, C) match matrix in vector registers and reduces it
// with a cumsum.  Here a block of 8 warps takes one bucket and 64 of its
// probe slots: it stages the bucket's build keys and occupancy in shared
// memory, then each warp walks the chain of one probe slot at a time, 32
// chain slots per step.  __ballot_sync over the lanes' match bits and
// __popc of the lower lanes give the running exclusive rank, and the 32
// ranks of a step are written as one coalesced row segment.
//
// Bound: memory.  The (B, Lc, C) int32 rank output is written once and
// dominates every other byte (5.4 GB for the 500 k-row Fig. 4 join); the
// key compares are K integer operations per pair.
#include "tile_rank.cuh"

namespace {

constexpr int kProbePerWarp = 8;
constexpr int kProbePerBlock = repro::kWarps * kProbePerWarp;

__global__ void __launch_bounds__(repro::kThreads)
    hash_join_kernel(const int* __restrict__ pbits,
                     const int* __restrict__ pocc,
                     const int* __restrict__ bbits,
                     const int* __restrict__ bocc, int K, int Lc, int C,
                     int* __restrict__ counts, int* __restrict__ rank) {
  extern __shared__ int build[];           // [K][C] keys, then [C] occupancy
  const int64_t b = blockIdx.x;
  for (int i = threadIdx.x; i < K * C; i += blockDim.x)
    build[i] = bbits[b * K * C + i];
  for (int i = threadIdx.x; i < C; i += blockDim.x)
    build[K * C + i] = bocc[b * C + i];
  __syncthreads();
  const int* occ = build + K * C;

  const int lane = threadIdx.x & 31;
  const unsigned lt = repro::lanemask_lt();
  const int l0 = blockIdx.y * kProbePerBlock + (threadIdx.x >> 5) * kProbePerWarp;
  for (int q = 0; q < kProbePerWarp; ++q) {
    const int l = l0 + q;
    if (l >= Lc) break;
    const int64_t slot = b * Lc + l;
    const bool live = pocc[slot] > 0;
    // lane k holds key plane k of this probe slot (K <= 32)
    const int key = lane < K ? pbits[(b * K + lane) * Lc + l] : 0;
    int* out = rank + slot * C;
    int run = 0;
    for (int c0 = 0; c0 < C; c0 += 32) {
      const int c = c0 + lane;
      bool m = live && c < C && occ[c] > 0;
      for (int k = 0; k < K; ++k) {
        const int want = __shfl_sync(0xffffffffu, key, k);
        m = m && build[k * C + c] == want;
      }
      const unsigned hit = __ballot_sync(0xffffffffu, m);
      if (c < C) out[c] = m ? run + __popc(hit & lt) : -1;
      run += __popc(hit);
    }
    if (lane == 0) counts[slot] = run;
  }
}

}  // namespace

extern "C" int hash_join_max_keys() { return 32; }

// pbits (B, K, Lc), pocc (B, Lc), bbits (B, K, C), bocc (B, C) int32 ->
// counts (B, Lc), rank (B, Lc, C) int32.  B, Lc, C > 0, 0 < K <= 32.
// Returns the launch's cudaError_t.
extern "C" int hash_join_probe(const int* pbits, const int* pocc,
                               const int* bbits, const int* bocc, int B, int K,
                               int Lc, int C, int* counts, int* rank,
                               void* stream) {
  const size_t smem = static_cast<size_t>(K + 1) * C * sizeof(int);
  if (smem > static_cast<size_t>(repro::kMaxSharedBytes) || K > 32 ||
      (Lc + kProbePerBlock - 1) / kProbePerBlock > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hash_join_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e) return static_cast<int>(e);
  }
  const dim3 grid(B, (Lc + kProbePerBlock - 1) / kProbePerBlock);
  hash_join_kernel<<<grid, repro::kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      pbits, pocc, bbits, bocc, K, Lc, C, counts, rank);
  return static_cast<int>(cudaGetLastError());
}

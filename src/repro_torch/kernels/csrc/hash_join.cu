// Bucketed hash-join probe: per bucket, the probe slots' match counts and
// each matching (probe slot, chain slot) pair's exclusive rank.
//
// Replaces the TPU kernel bucket_probe_buckets
// (src/repro/kernels/hash_join/kernel.py), which materialises each
// bucket's dense (Lc, C) match matrix in vector registers and reduces it
// with a cumsum.  Here a block of 8 warps takes one bucket and walks its
// probe slots 8 * S at a time (bucket_match.cuh: S = 32, fewer when the
// buckets are too few to give every SM a block), with the bucket's build
// slab in shared memory (staged once when it fits, else streamed in
// chunks); each warp loads its S probe slots at once and walks their
// chains one after another, 32 chain slots per step (any K, any C).
// __ballot_sync over the lanes' match bits and __popc of the lower lanes
// give the running exclusive rank, which the slot's own lane keeps from
// chunk to chunk, and the 32 ranks of a step are written as one coalesced
// row segment.
//
// Bound: memory.  The (B, Lc, C) int32 rank output is written once and
// dominates every other byte (5.4 GB for the 500 k-row Fig. 4 join); the
// key compares are K integer operations per pair.
#include "bucket_match.cuh"

namespace {

template <bool kOneKey>
__global__ void __launch_bounds__(repro::kThreads)
    hash_join_kernel(const int* __restrict__ pbits,
                     const int* __restrict__ pocc,
                     const int* __restrict__ bbits,
                     const int* __restrict__ bocc, int K, int Lc, int C,
                     int cj, int S, int* __restrict__ counts,
                     int* __restrict__ rank) {
  extern __shared__ int smem[];
  int* skey = smem;                     // [K][cj] build keys
  int* socc = skey + K * cj;            // [cj] build occupancy
  const int64_t b = blockIdx.x;
  const int* pb = pbits + b * K * Lc;
  const int* bb = bbits + b * K * C;
  const int* bo = bocc + b * C;
  const int lane = threadIdx.x & 31;
  const unsigned lt = repro::lanemask_lt();
  const bool one_chunk = C <= cj;
  if (one_chunk) {
    repro::stage_build(bb, bo, K, C, 0, C, cj, skey, socc);
    __syncthreads();
  }

  const int per_block = repro::kWarps * S;
  for (int g = blockIdx.y; g * per_block < Lc; g += gridDim.y) {
    const int l0 = g * per_block + (threadIdx.x >> 5) * S;
    const int nq = Lc - l0 < S ? Lc - l0 : S;     // this warp's slots
    const int l = lane < nq ? l0 + lane : 0;      // this lane's slot
    const bool live = lane < nq && pocc[b * Lc + l] > 0;
    const int key = pb[l];                        // plane 0 of its key
    int my_run = 0;                               // slot l0 + lane's rank
    for (int j0 = 0; j0 < C; j0 += cj) {
      const int jn = C - j0 < cj ? C - j0 : cj;
      if (!one_chunk) {
        __syncthreads();
        repro::stage_build(bb, bo, K, C, j0, jn, cj, skey, socc);
        __syncthreads();
      }
      for (int q = 0; q < nq; ++q) {
        const bool q_live = __shfl_sync(0xffffffffu, live, q);
        const int want = __shfl_sync(0xffffffffu, key, q);
        int run = __shfl_sync(0xffffffffu, my_run, q);
        int* out = rank + (b * Lc + l0 + q) * C + j0;
        for (int c0 = 0; c0 < jn; c0 += 32) {
          const int c = c0 + lane;
          const bool m = q_live && repro::staged_match<kOneKey>(
                                       skey, socc, cj, c, jn, want,
                                       pb + l0 + q, K, Lc);
          const unsigned hit = __ballot_sync(0xffffffffu, m);
          if (c < jn) out[c] = m ? run + __popc(hit & lt) : -1;
          run += __popc(hit);
        }
        if (lane == q) my_run = run;
      }
    }
    if (lane < nq) counts[b * Lc + l] = my_run;
  }
}

}  // namespace

// pbits (B, K, Lc), pocc (B, Lc), bbits (B, K, C), bocc (B, C) int32 ->
// counts (B, Lc), rank (B, Lc, C) int32.  B, K, Lc, C > 0.  Returns the
// launch's cudaError_t.
extern "C" int hash_join_probe(const int* pbits, const int* pocc,
                               const int* bbits, const int* bocc, int B, int K,
                               int Lc, int C, int* counts, int* rank,
                               void* stream) {
  if (B <= 0 || K <= 0 || Lc <= 0 || C <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int cj = 0;
  size_t smem = 0;
  auto* kernel = K == 1 ? hash_join_kernel<true> : hash_join_kernel<false>;
  const int e = repro::prepare_chunk(kernel, K + 1, C, C, &cj, &smem);
  if (e) return e;
  const repro::ProbeLaunch p = repro::probe_launch(B, Lc);
  kernel<<<p.grid, repro::kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      pbits, pocc, bbits, bocc, K, Lc, C, cj, p.per_warp, counts, rank);
  return static_cast<int>(cudaGetLastError());
}

// Shared pieces of the table kernels: the launch-error string, the
// stable within-tile ranking under tile_scan.cuh's counting pass
// (hash_partition, fused_bucketing, radix_sort), a block-wide exclusive
// scan, and the sizing of a slab chunk staged in shared memory
// (hash_join).
//
// Layout of one tile: a block of kWarps warps ranks kThreads * Items
// consecutive rows (Items rows per thread, as the kernel picks).  Warp w
// owns the contiguous rows [w * Items * 32, (w + 1) * Items * 32) of the
// tile and walks them 32 at a time, lane l on row j * 32 + l of its range,
// so loads and stores are coalesced.  Within a warp, __match_any_sync (or
// ballots, see peers_of) groups the lanes that hold the same id and __popc
// of the lower peers gives each row its rank among the warp's earlier
// rows; the group's lowest lane then adds the
// group size to the warp's count for that id in shared memory.  After
// all warps are done, an exclusive scan over the warps of each id turns
// the per-warp counts into per-warp offsets (and its total into the
// tile's histogram), so a row's rank is its warp offset plus its rank
// inside the warp: stable, in row order.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace repro {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSharedBytes = 232448;    // 227 KB: Hopper's per-block cap

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// The lanes of the warp whose id equals this lane's: __match_any_sync,
// whose cost grows with the distinct ids a warp holds, or, with kBallot,
// one ballot per bit of the ids (all below P) and one of validity, whose
// cost grows with log2 P.  Each wins where its callers run (H100, device
// time): at P = 2, the shuffle's partitions, hash_partition takes 0.030
// ms on 10 M rows with the match and 0.034 with ballots; with 256 to 513
// ids in play ballots win: the radix downsweep at 8 bits 0.25 ms against
// 0.29, hash_partition at P = 513 and fused_bucketing at 512 buckets
// 25 % and 16 % faster on 625 k rows (tools/probe_variants.py).
template <bool kBallot>
__device__ __forceinline__ unsigned peers_of(int p, int P) {
  if (!kBallot) return __match_any_sync(0xffffffffu, p);
  unsigned peers = __ballot_sync(0xffffffffu, p >= 0);
  if (p < 0) peers = ~peers;
  const int bits = 32 - __clz(P - 1);
  for (int k = 0; k < bits; ++k) {
    const unsigned set = __ballot_sync(0xffffffffu, (p >> k) & 1);
    peers &= ((p >> k) & 1) ? set : ~set;
  }
  return peers;
}

// Ranks one tile of rows by id: id[j] is the id of the tile's row
// (threadIdx.x >> 5) * Items * 32 + j * 32 + (threadIdx.x & 31), in
// [0, P), or -1 for a row past n or an id outside [0, P): such a row is
// not counted and gets rank 0.  On return rank[j] is the row's stable rank
// among the tile's rows of its id, plus carry[p] when `carry` is given
// (carry[p] then advances by the tile's count of id p), and total[p], when
// given, is the tile's count of id p (global or shared memory).  Uses
// kWarps * P ints of shared memory at `cnt`; begins by clearing them and
// reads them until it returns, so a caller that ranks several tiles in
// turn synchronises between them or alternates two `cnt`.
template <int Items, bool kBallot = false>
__device__ __forceinline__ void block_rank(const int (&id)[Items], int P,
                                           int* cnt, int* total,
                                           int (&rank)[Items],
                                           int* carry = nullptr) {
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kWarps * P; i += kThreads) cnt[i] = 0;
  __syncthreads();

  int* wcnt = cnt + warp * P;
  const unsigned lt = lanemask_lt();
#pragma unroll
  for (int j = 0; j < Items; ++j) {
    const int p = id[j];
    const unsigned peers = peers_of<kBallot>(p, P);
    const int before = p >= 0 ? wcnt[p] : 0;
    __syncwarp();
    if (p >= 0 && (peers & lt) == 0) wcnt[p] = before + __popc(peers);
    __syncwarp();
    rank[j] = before + __popc(peers & lt);
  }
  __syncthreads();

  for (int p = threadIdx.x; p < P; p += kThreads) {
    const int start = carry ? carry[p] : 0;
    int run = start;
    for (int w = 0; w < kWarps; ++w) {
      const int c = cnt[w * P + p];
      cnt[w * P + p] = run;
      run += c;
    }
    if (carry) carry[p] = run;
    if (total) total[p] = run - start;
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < Items; ++j)
    rank[j] = id[j] >= 0 ? rank[j] + wcnt[id[j]] : 0;
}

// Exclusive scan of in[0, len) into out[0, len) (shared memory, or `in`
// in global memory) by the whole block; returns the sum.  `tmp` holds
// kWarps ints of shared memory.  Synchronises before it returns.
__device__ __forceinline__ int block_exclusive_scan(const int* in, int* out,
                                                    int len, int* tmp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (len + kThreads - 1) / kThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * per, len);
  const int hi = min(lo + per, len);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += in[i];
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) tmp[warp] = incl;
  __syncthreads();
  int run = incl - sum, total = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int t = tmp[w];
    if (w < warp) run += t;
    total += t;
  }
  for (int i = lo; i < hi; ++i) {
    const int v = in[i];
    out[i] = run;
    run += v;
  }
  __syncthreads();
  return total;
}

// Dynamic shared memory of one ranking block (kWarps * P ints, and
// `extra_ints` more), raising the kernel's limit above the default 48 KB
// when needed.  Returns a cudaError_t.
template <typename Kernel>
inline int prepare_shared(Kernel kernel, int P, size_t* bytes,
                          int64_t extra_ints = 0) {
  *bytes = (static_cast<size_t>(kWarps) * P + extra_ints) * sizeof(int);
  if (*bytes > static_cast<size_t>(kMaxSharedBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  if (*bytes > 48 * 1024)
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(*bytes)));
  return 0;
}

// Slab slots staged in shared memory per chunk, `ints_per_slot` 4-byte
// words each: at most `max_slots` and C, fewer when the slots would
// overflow the shared memory a block may opt in to.  Sets *slots and
// *bytes, raises the kernel's limit above the default 48 KB when needed,
// and returns a cudaError_t.
template <typename Kernel>
inline int prepare_chunk(Kernel kernel, int64_t ints_per_slot, int C,
                         int max_slots, int* slots, size_t* bytes) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (!e)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e) return static_cast<int>(e);
  const int64_t per_slot = ints_per_slot * static_cast<int64_t>(sizeof(int));
  int64_t n = C < max_slots ? C : max_slots;
  if (n * per_slot > optin) n = optin / per_slot;
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  *slots = static_cast<int>(n);
  *bytes = static_cast<size_t>(n * per_slot);
  if (*bytes > 48 * 1024)
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(*bytes)));
  return 0;
}

}  // namespace repro

// Fused murmur hash + per-tile histogram + stable within-tile ranks.
//
// Replaces the TPU kernel fused_bucket_ranks_tiles
// (src/repro/kernels/fused_bucketing/kernel.py).  Each thread hashes its
// rows' K key planes in native uint32 (h0 = golden ratio; h = fmix32(h ^
// (u + golden + (h << 6) + (h >> 2))) per plane), takes bid = h % P for a
// valid row and the trash bucket P otherwise, writes bid, and feeds it in
// registers to the same warp-matching ranking as hash_partition over
// P + 1 buckets (tile_rank.cuh).  The bucket id equals the plain
// version's bit for bit, which the host-side join planner relies on.
//
// Bound: memory.  Each row reads K planes (4 B each) and its validity byte
// once and writes bid and rank once (8 B); the hash is a few integer
// operations per plane.
#include "tile_rank.cuh"

namespace {

constexpr uint32_t kGolden = 0x9E3779B9u;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__global__ void __launch_bounds__(repro::kThreads)
    fused_bucketing_kernel(const int* __restrict__ bits,
                           const uint8_t* __restrict__ valid, int64_t n, int K,
                           int P, int* __restrict__ bid,
                           int* __restrict__ hist_t,
                           int* __restrict__ rank_t) {
  int id[repro::kItems];
#pragma unroll
  for (int j = 0; j < repro::kItems; ++j) {
    const int64_t row = repro::tile_row(j);
    id[j] = -1;
    if (row < n) {
      uint32_t h = kGolden;
      for (int k = 0; k < K; ++k) {
        const uint32_t u = static_cast<uint32_t>(bits[k * n + row]);
        h = mix32(h ^ (u + kGolden + (h << 6) + (h >> 2)));
      }
      const int b = valid[row] ? static_cast<int>(h % static_cast<uint32_t>(P))
                               : P;
      bid[row] = b;
      id[j] = b;
    }
  }
  repro::tile_rank(id, n, P + 1, hist_t, rank_t);
}

}  // namespace

extern "C" int fused_bucketing_tile_rows() { return repro::kTile; }

// bits int32 (K, n), valid bool (n,) -> bid int32 (n,), hist_t int32
// (ceil(n / tile), P + 1), rank_t int32 (n,).  n > 0, P > 0.  Returns the
// launch's cudaError_t.
extern "C" int fused_bucketing_tiles(const int* bits, const uint8_t* valid,
                                     long long n, int K, int P, int* bid,
                                     int* hist_t, int* rank_t, void* stream) {
  size_t smem = 0;
  const int err = repro::prepare_shared(fused_bucketing_kernel, P + 1, &smem);
  if (err) return err;
  const long long tiles = (n + repro::kTile - 1) / repro::kTile;
  fused_bucketing_kernel<<<static_cast<unsigned>(tiles), repro::kThreads,
                           smem, static_cast<cudaStream_t>(stream)>>>(
      bits, valid, n, K, P, bid, hist_t, rank_t);
  return static_cast<int>(cudaGetLastError());
}

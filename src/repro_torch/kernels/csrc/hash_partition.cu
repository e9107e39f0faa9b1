// Per-tile histogram and stable within-tile ranks of partition ids.
//
// Replaces the TPU kernel radix_histogram_ranks_tiles
// (src/repro/kernels/hash_partition/kernel.py), which builds a (tile, P)
// one-hot in vector registers and reduces it two ways.  Here one block of
// 256 threads ranks a tile of 1024 rows with warp matching (tile_rank.cuh);
// no one-hot exists.  The cross-tile exclusive scan stays outside, in
// ops.py, as in the reference.
//
// Bound: memory.  Each row is read once (4 B) and its rank written once
// (4 B); the per-tile histogram adds 4 * P B per 1024 rows.
#include "tile_rank.cuh"

namespace {

__global__ void __launch_bounds__(repro::kThreads)
    hash_partition_kernel(const int* __restrict__ pid, int64_t n, int P,
                          int* __restrict__ hist_t, int* __restrict__ rank_t) {
  int id[repro::kItems];
#pragma unroll
  for (int j = 0; j < repro::kItems; ++j) {
    const int64_t row = repro::tile_row(j);
    const int p = row < n ? pid[row] : -1;
    id[j] = (p >= 0 && p < P) ? p : -1;
  }
  repro::tile_rank(id, n, P, hist_t, rank_t);
}

}  // namespace

extern "C" int hash_partition_tile_rows() { return repro::kTile; }

// pid int32 (n,) -> hist_t int32 (ceil(n / tile), P), rank_t int32 (n,).
// n > 0.  Returns the launch's cudaError_t.
extern "C" int hash_partition_tiles(const int* pid, long long n, int P,
                                    int* hist_t, int* rank_t, void* stream) {
  size_t smem = 0;
  const int err = repro::prepare_shared(hash_partition_kernel, P, &smem);
  if (err) return err;
  const long long tiles = (n + repro::kTile - 1) / repro::kTile;
  hash_partition_kernel<<<static_cast<unsigned>(tiles), repro::kThreads,
                          smem, static_cast<cudaStream_t>(stream)>>>(
      pid, n, P, hist_t, rank_t);
  return static_cast<int>(cudaGetLastError());
}

// One LSD radix digit pass: per-tile digit histogram and stable
// within-tile ranks of int32 sort words.
//
// Replaces the TPU kernel digit_histogram_ranks_tiles
// (src/repro/kernels/radix_sort/kernel.py), which builds a (tile, D)
// one-hot of the digits in vector registers and reduces it two ways.  Here
// each thread loads its rows' words, extracts the digit in registers
// ((w >> shift) & (D - 1), an arithmetic shift whose sign bits the mask
// drops) and hands it to the warp-matching ranking of tile_rank.cuh over
// D = 2^bits digit values; no one-hot exists.  A block of 256 threads takes
// a tile of 512, 1024 or 2048 rows (2, 4 or 8 per thread); the last tile
// is masked here, so any n >= 1 runs.  The cross-tile exclusive scan stays
// outside, in ops.py, as in the reference.
//
// Bound: memory.  Each word is read once (4 B) and its rank written once
// (4 B); the per-tile histogram adds 4 * D B per tile.  Shared memory holds
// 8 warps' counts, 8 * D ints: 64 KB at 11 bits, above the 48 KB default,
// which prepare_shared raises.
#include "tile_rank.cuh"

namespace {

template <int Items>
__global__ void __launch_bounds__(repro::kThreads)
    radix_digit_kernel(const int* __restrict__ words, int64_t n, int shift,
                       int mask, int* __restrict__ hist_t,
                       int* __restrict__ rank_t) {
  int id[Items];
#pragma unroll
  for (int j = 0; j < Items; ++j) {
    const int64_t row = repro::tile_row<Items>(j);
    id[j] = row < n ? (words[row] >> shift) & mask : -1;
  }
  repro::tile_rank(id, n, mask + 1, hist_t, rank_t);
}

template <int Items>
int launch(const int* words, long long n, int shift, int bits, int* hist_t,
           int* rank_t, cudaStream_t stream) {
  const int D = 1 << bits;
  size_t smem = 0;
  const int err = repro::prepare_shared(radix_digit_kernel<Items>, D, &smem);
  if (err) return err;
  const long long tile = repro::kThreads * Items;
  const long long tiles = (n + tile - 1) / tile;
  radix_digit_kernel<Items><<<static_cast<unsigned>(tiles), repro::kThreads,
                              smem, stream>>>(words, n, shift, D - 1, hist_t,
                                              rank_t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// words int32 (n,) -> hist_t int32 (ceil(n / tile), 2^bits), rank_t int32
// (n,).  n > 0, 0 <= shift < 32, 1 <= bits <= 11, tile in {512, 1024,
// 2048}.  Returns the launch's cudaError_t.
extern "C" int radix_sort_digit_tiles(const int* words, long long n,
                                      int shift, int bits, int tile,
                                      int* hist_t, int* rank_t,
                                      void* stream) {
  if (bits < 1 || bits > 11 || shift < 0 || shift > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 2 * repro::kThreads:
      return launch<2>(words, n, shift, bits, hist_t, rank_t, s);
    case 4 * repro::kThreads:
      return launch<4>(words, n, shift, bits, hist_t, rank_t, s);
    case 8 * repro::kThreads:
      return launch<8>(words, n, shift, bits, hist_t, rank_t, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One LSD radix digit pass over int32 sort words, whole on the card: the
// stable counting-sort scatter of words and perm, or each row's stable
// rank within its digit.
//
// Replaces the TPU kernel digit_histogram_ranks_tiles
// (src/repro/kernels/radix_sort/kernel.py), which builds a (tile, D)
// one-hot of the digits in vector registers and reduces it two ways into
// per-tile histograms and within-tile ranks, leaving the cross-tile scan
// and the scatter to XLA.  Here the digit is (w >> shift) & (D - 1) (an
// arithmetic shift whose sign bits the mask drops), D = 2^bits, and a pass
// is three launches with nothing between them, the counting pass of
// tile_scan.cuh read through the digit (two for the ranks of up to 3
// bits while the blocks are few: the scan folds into the downsweep):
//
// 1. count_upsweep_kernel: each block counts the digits of `per`
//    consecutive tiles (tile = 256 threads x 2, 4 or 8 rows) and writes
//    them to hist (blocks, D).
// 2. count_scan_kernel: for each digit, the exclusive sum over earlier
//    blocks replaces each block's count in place, and total[d] is the
//    pass's histogram.
// 3. For ranks, tile_scan.cuh's rank_downsweep_kernel: a row's rank is the
//    rows of its digit in earlier blocks and tiles plus its stable rank in
//    its tile, written in row order.  For a scatter,
//    radix_downsweep_kernel: each block walks its tiles again, ranks each
//    tile's digits stably with tile_rank.cuh's block_rank (the lanes of a
//    digit found by one ballot per digit bit), and stages all of the
//    block's rows in shared memory in digit order (the block's digit
//    counts are the difference of two scanned rows), so each digit's run,
//    `per` tiles long, leaves as consecutive stores of words_out and
//    perm_out at the digit's offset in the pass.
//
// Because the scatter moves the words with perm, the next pass reads them
// in order and no gather is left between passes.  Bound: memory.  A
// scatter must read words and perm and write both, 16 B a row; beyond
// that the kernels write the per-block histograms and read them back,
// and the upsweep reads the words a second time.  The scattered stores
// are what costs most: at 8 bits a run of a digit is per * tile / 256
// rows long, so the block stages several tiles to make the runs long.
// Shared memory of the downsweep: 8 warps' counts, three digit arrays and
// the staged rows, (11 D + 8 + 2 * per * tile) ints: 184 KB at 11 bits,
// 2048 rows and 6 tiles, which prepare_shared opts in to.
#include "tile_scan.cuh"

namespace {

using repro::kThreads;
using repro::kWarps;
using repro::row_of;

// Tiles a block walks (repro::tiles_per_block): a scatter of 256 digits or
// more stages 6 (its digit runs 24 rows long at 1024-row tiles: 11 %
// faster than 4 at 8 bits on 20 M rows, H100); the others 4, as the 1-bit
// scatter and the ranks form ran 6-9 % slower with 6 (fewer blocks an SM,
// nothing to gain).
int tiles_per_block(long long tiles, int bits, bool scatter) {
  return repro::tiles_per_block(tiles, scatter && bits >= 8 ? 6 : 4);
}

// The digit of a row: an arithmetic shift whose sign bits the mask drops.
// (A reader of tile_scan.cuh.)
struct DigitOf {
  static constexpr int kLoadRows = 16;
  const int* words;
  int shift, mask;
  template <int R>
  __device__ __forceinline__ void read(int64_t start, int stride, int64_t end,
                                       int (&id)[R]) const {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int64_t row = start + static_cast<int64_t>(i) * stride;
      id[i] = row < end ? (words[row] >> shift) & mask : -1;
    }
  }
};

// The scatter of perm (nullptr: the identity) into perm_out and, if
// words_out is given, of the words.
template <int Items>
__global__ void __launch_bounds__(kThreads,
                                  Items == 8 ? 4 : repro::kDownBlocks)
    radix_downsweep_kernel(const int* __restrict__ words,
                           const int* __restrict__ perm, int64_t n, int shift,
                           int mask, int per, const int* __restrict__ hist,
                           int blocks, const int* __restrict__ total,
                           int* __restrict__ words_out,
                           int* __restrict__ perm_out) {
  constexpr int kTile = kThreads * Items;
  const int D = mask + 1;
  extern __shared__ int smem[];
  int* cnt = smem;               // [kWarps][D], block_rank's
  int* base = cnt + kWarps * D;  // [D] see below
  int* fill = base + D;          // [D] the next staged place of each digit
  int* sub = fill + D;           // [D] one tile's digit counts
  int* tmp = sub + D;            // [kWarps]
  int* stage_w = tmp + kWarps;   // [per * kTile] the block's rows in
  int* stage_p = stage_w + per * kTile;  // digit order
  const int64_t first = static_cast<int64_t>(blockIdx.x) * per * kTile;
  const int* mine = hist + static_cast<int64_t>(blockIdx.x) * D;

  // this block's digit counts from the scanned histogram, their exclusive
  // scan (where each digit's rows start in the staged block) and the
  // pass's digit offsets: a staged row i of digit d goes to base[d] + i
  const int* next = blockIdx.x + 1 < blocks ? mine + D : total;
  for (int i = threadIdx.x; i < D; i += kThreads) sub[i] = next[i] - mine[i];
  __syncthreads();
  repro::block_exclusive_scan(sub, fill, D, tmp);
  repro::block_exclusive_scan(total, base, D, tmp);
  for (int i = threadIdx.x; i < D; i += kThreads)
    base[i] += mine[i] - fill[i];
  __syncthreads();

  for (int s = 0; s < per; ++s) {
    const int64_t t0 = first + static_cast<int64_t>(s) * kTile;
    if (t0 >= n) break;
    int w[Items], p[Items], id[Items], rank[Items];
#pragma unroll
    for (int j = 0; j < Items; ++j) {
      const int64_t row = row_of<Items>(t0, j);
      const bool live = row < n;
      w[j] = live ? words[row] : 0;
      p[j] = live ? (perm ? perm[row] : static_cast<int>(row)) : 0;
      id[j] = live ? (w[j] >> shift) & mask : -1;
    }
    repro::block_rank<Items, true>(id, D, cnt, sub, rank);
#pragma unroll
    for (int j = 0; j < Items; ++j) {
      if (id[j] < 0) continue;
      const int at = fill[id[j]] + rank[j];
      stage_w[at] = w[j];
      stage_p[at] = p[j];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < D; i += kThreads) fill[i] += sub[i];
    __syncthreads();
  }

  // each digit's staged run leaves as consecutive stores
  const int64_t left = n - first;
  const int live = left < per * kTile ? static_cast<int>(left) : per * kTile;
  for (int i = threadIdx.x; i < live; i += kThreads) {
    const int wi = stage_w[i];
    const int64_t dest = base[(wi >> shift) & mask] + i;
    perm_out[dest] = stage_p[i];
    if (words_out) words_out[dest] = wi;
  }
}

template <int Items>
int launch(const int* words, const int* perm, long long n, int shift,
           int bits, int* hist, int* total, int* words_out, int* perm_out,
           int* rank_out, cudaStream_t stream) {
  const int D = 1 << bits;
  const DigitOf digit{words, shift, D - 1};
  if (rank_out)
    return repro::count_rank_pass<Items>(digit, digit, n, D, hist, total,
                                         rank_out, stream);
  const long long tile = static_cast<long long>(kThreads) * Items;
  const int per = tiles_per_block((n + tile - 1) / tile, bits, true);
  const long long blocks = repro::count_blocks<Items>(n, per);
  size_t smem = 0;
  int err = repro::prepare_shared(radix_downsweep_kernel<Items>, D, &smem,
                                  3LL * D + kWarps + 2LL * per * tile);
  if (err) return err;
  err = repro::launch_upsweep<Items>(digit, n, D, per, blocks, hist, stream);
  if (!err) err = repro::launch_scan(hist, blocks, D, total, stream);
  if (err) return err;
  radix_downsweep_kernel<Items><<<static_cast<unsigned>(blocks), kThreads,
                                  smem, stream>>>(
      words, perm, n, shift, D - 1, per, hist, static_cast<int>(blocks),
      total, words_out, perm_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Rows of scratch the pass needs for its per-block histograms: hist is
// (radix_sort_blocks(n, tile, bits, scatter), 2^bits) int32, scatter
// nonzero for the scatter and 0 for ranks.
extern "C" long long radix_sort_blocks(long long n, int tile, int bits,
                                       int scatter) {
  const long long tiles = (n + tile - 1) / tile;
  const int per = tiles_per_block(tiles, bits, scatter != 0);
  return (tiles + per - 1) / per;
}

// One pass over words int32 (n,), n > 0, 0 <= shift < 32, 1 <= bits <= 11,
// tile in {512, 1024, 2048}.  Writes total int32 (2^bits,), the pass's
// digit histogram, and with rank_out each row's stable rank within its
// digit; without it the stable scatter perm_out[dest] = perm[i] (perm
// nullptr: i) and, with words_out, words_out[dest] = words[i].  Returns
// the first failed launch's cudaError_t.
extern "C" int radix_sort_pass(const int* words, const int* perm, long long n,
                               int shift, int bits, int tile, int* hist,
                               int* total, int* words_out, int* perm_out,
                               int* rank_out, void* stream) {
  if (n <= 0 || bits < 1 || bits > 11 || shift < 0 || shift > 31 ||
      (rank_out == nullptr && perm_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 2 * kThreads:
      return launch<2>(words, perm, n, shift, bits, hist, total, words_out,
                       perm_out, rank_out, s);
    case 4 * kThreads:
      return launch<4>(words, perm, n, shift, bits, hist, total, words_out,
                       perm_out, rank_out, s);
    case 8 * kThreads:
      return launch<8>(words, perm, n, shift, bits, hist, total, words_out,
                       perm_out, rank_out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

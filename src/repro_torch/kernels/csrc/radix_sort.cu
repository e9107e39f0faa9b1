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
// is three launches with nothing between them:
//
// 1. radix_upsweep_kernel: each block counts the digits of `per`
//    consecutive tiles (tile = 256 threads x 2, 4 or 8 rows) in a shared
//    histogram per warp and writes their sum to hist (blocks, D).
// 2. radix_scan_kernel: for each digit, the exclusive sum over earlier
//    blocks replaces each block's count in place, and total[d] is the
//    pass's histogram.  A block takes 8 digits (one 32-byte sector of a
//    hist row) and splits the blocks among its 128 slices.
// 3. radix_downsweep_kernel: each block walks its tiles again and ranks
//    each tile's digits stably with tile_rank.cuh's block_rank (the lanes
//    of a digit found by one ballot per digit bit).  For ranks, a row's
//    rank is the rows of its digit in earlier blocks and tiles plus that
//    rank, written in row order.  For a scatter, all of the block's rows
//    are first staged in shared memory in digit order (the block's digit
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
#include <algorithm>

#include "tile_rank.cuh"

namespace {

using repro::kThreads;
using repro::kWarps;

constexpr int kScanThreads = 1024;

// Tiles a block of the up- and downsweep walks: several at large n, so
// the per-block histograms stay small, few enough that the last wave of
// blocks is short.  A scatter of 256 digits or more stages 6 (its digit
// runs 24 rows long at 1024-row tiles: 11 % faster than 4 at 8 bits on
// 20 M rows, H100); the others 4, as the 1-bit scatter and the ranks
// form ran 6-9 % slower with 6 (fewer blocks an SM, nothing to gain).
int tiles_per_block(long long tiles, int bits, bool scatter) {
  const long long most = scatter && bits >= 8 ? 6 : 4;
  return static_cast<int>(std::min(most, std::max(1LL, tiles / 1024)));
}

// Row of item j of this thread in the tile that starts at t0 (the layout
// of repro::tile_row: warp w owns Items * 32 consecutive rows).
template <int Items>
__device__ __forceinline__ int64_t row_of(int64_t t0, int j) {
  return t0 + (threadIdx.x >> 5) * (Items * 32) + j * 32 + (threadIdx.x & 31);
}

// Each row adds 1 to its warp's own histogram in shared memory, and the
// warps' histograms are summed at the end.  (Lanes of one digit adding
// their count once, through __match_any_sync, took 4x as long at 8 bits
// and no less at 1 bit.)
template <int Items>
__global__ void __launch_bounds__(kThreads)
    radix_upsweep_kernel(const int* __restrict__ words, int64_t n, int shift,
                         int mask, int per, int* __restrict__ hist) {
  extern __shared__ int cnt[];  // [kWarps][D]
  constexpr int kTile = kThreads * Items;
  const int D = mask + 1;
  for (int i = threadIdx.x; i < kWarps * D; i += kThreads) cnt[i] = 0;
  __syncthreads();
  int* wcnt = cnt + (threadIdx.x >> 5) * D;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * per * kTile;
  for (int s = 0; s < per; ++s) {
    const int64_t t0 = first + static_cast<int64_t>(s) * kTile;
    if (t0 >= n) break;
    int d[Items];
#pragma unroll
    for (int j = 0; j < Items; ++j) {
      const int64_t row = t0 + j * kThreads + threadIdx.x;
      d[j] = row < n ? (words[row] >> shift) & mask : -1;
    }
#pragma unroll
    for (int j = 0; j < Items; ++j)
      if (d[j] >= 0) atomicAdd(&wcnt[d[j]], 1);
  }
  __syncthreads();
  int* out = hist + static_cast<int64_t>(blockIdx.x) * D;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    int sum = 0;
    for (int w = 0; w < kWarps; ++w) sum += cnt[w * D + i];
    out[i] = sum;
  }
}

// G digits per block (G = min(8, D)), kScanThreads / G slices of blocks.
__global__ void __launch_bounds__(kScanThreads)
    radix_scan_kernel(int* __restrict__ hist, int blocks, int D, int G,
                      int* __restrict__ total) {
  constexpr int kBatch = 8;
  __shared__ int part[kScanThreads];
  const int S = kScanThreads / G;
  const int g = threadIdx.x % G, s = threadIdx.x / G;
  const int d = blockIdx.x * G + g;
  const int slice = (blocks + S - 1) / S;
  const int lo = min(s * slice, blocks), hi = min(lo + slice, blocks);
  int sum = 0;
  for (int b = lo; b < hi; b += kBatch) {
    int v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      v[u] = b + u < hi ? hist[static_cast<int64_t>(b + u) * D + d] : 0;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) sum += v[u];
  }
  part[s * G + g] = sum;
  __syncthreads();

  // warp w < G: exclusive scan of digit w's slice sums, in place
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < G) {
    const int per_lane = S / 32;
    int* col = part + lane * per_lane * G + warp;
    int local = 0;
    for (int k = 0; k < per_lane; ++k) local += col[k * G];
    int incl = local;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    int run = incl - local;
    for (int k = 0; k < per_lane; ++k) {
      const int c = col[k * G];
      col[k * G] = run;
      run += c;
    }
    if (lane == 31) total[blockIdx.x * G + warp] = incl;
  }
  __syncthreads();

  int run = part[s * G + g];
  for (int b = lo; b < hi; b += kBatch) {
    int v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      v[u] = b + u < hi ? hist[static_cast<int64_t>(b + u) * D + d] : 0;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (b + u < hi) hist[static_cast<int64_t>(b + u) * D + d] = run;
      run += v[u];
    }
  }
}

// Blocks of the downsweep that stay resident on an SM: a tile's critical
// path is its loads and a handful of block barriers, so it needs many.
constexpr int kDownBlocks = 6;

// rank_out != nullptr: ranks within the digit; otherwise the scatter, of
// perm (nullptr: the identity) into perm_out and, if words_out is given,
// of the words.
template <int Items>
__global__ void __launch_bounds__(kThreads, Items == 8 ? 4 : kDownBlocks)
    radix_downsweep_kernel(const int* __restrict__ words,
                           const int* __restrict__ perm, int64_t n, int shift,
                           int mask, int per, const int* __restrict__ hist,
                           int blocks, const int* __restrict__ total,
                           int* __restrict__ words_out,
                           int* __restrict__ perm_out,
                           int* __restrict__ rank_out) {
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
  const bool scatter = rank_out == nullptr;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * per * kTile;
  const int* mine = hist + static_cast<int64_t>(blockIdx.x) * D;

  if (scatter) {
    // this block's digit counts from the scanned histogram, their
    // exclusive scan (where each digit's rows start in the staged block)
    // and the pass's digit offsets: a staged row i of digit d goes to
    // base[d] + i
    const int* next = blockIdx.x + 1 < blocks ? mine + D : total;
    for (int i = threadIdx.x; i < D; i += kThreads) sub[i] = next[i] - mine[i];
    __syncthreads();
    repro::block_exclusive_scan(sub, fill, D, tmp);
    repro::block_exclusive_scan(total, base, D, tmp);
    for (int i = threadIdx.x; i < D; i += kThreads)
      base[i] += mine[i] - fill[i];
  } else {
    // the rows of each digit in earlier blocks
    for (int i = threadIdx.x; i < D; i += kThreads) base[i] = mine[i];
  }
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
      p[j] = live && scatter ? (perm ? perm[row] : static_cast<int>(row)) : 0;
      id[j] = live ? (w[j] >> shift) & mask : -1;
    }
    repro::block_rank<Items, true>(id, D, cnt, sub, rank);
    int* next = scatter ? fill : base;
#pragma unroll
    for (int j = 0; j < Items; ++j) {
      if (id[j] < 0) continue;
      const int at = next[id[j]] + rank[j];
      if (scatter) {
        stage_w[at] = w[j];
        stage_p[at] = p[j];
      } else {
        rank_out[row_of<Items>(t0, j)] = at;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < D; i += kThreads) next[i] += sub[i];
    __syncthreads();
  }
  if (!scatter) return;

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
  const long long tile = static_cast<long long>(kThreads) * Items;
  const long long tiles = (n + tile - 1) / tile;
  const int per = tiles_per_block(tiles, bits, rank_out == nullptr);
  const unsigned blocks = static_cast<unsigned>((tiles + per - 1) / per);
  size_t down_smem = 0;
  int err = repro::prepare_shared(radix_downsweep_kernel<Items>, D,
                                  &down_smem,
                                  3LL * D + kWarps + 2LL * per * tile);
  if (err) return err;
  size_t up_smem = 0;
  err = repro::prepare_shared(radix_upsweep_kernel<Items>, D, &up_smem);
  if (err) return err;
  radix_upsweep_kernel<Items><<<blocks, kThreads, up_smem, stream>>>(
      words, n, shift, D - 1, per, hist);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int G = D < 8 ? D : 8;
  radix_scan_kernel<<<D / G, kScanThreads, 0, stream>>>(
      hist, static_cast<int>(blocks), D, G, total);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  radix_downsweep_kernel<Items><<<blocks, kThreads, down_smem, stream>>>(
      words, perm, n, shift, D - 1, per, hist, static_cast<int>(blocks),
      total, words_out, perm_out, rank_out);
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

// The counting pass that ranks rows by a small id, whole on the card:
// each row's stable rank among the rows of its id, in row order, and the
// ids' histogram.  The radix digit pass (radix_sort.cu), hash_partition
// and fused_bucketing run it; they differ only in how a row's id is read,
// by a reader (see IdsBelow) that gives each row's id in [0, P), or -1 for
// a row that is not counted (it gets rank 0).  Three launches, nothing
// between them (two for few ids, see 2):
//
// 1. count_upsweep_kernel: each block counts the ids of `per` consecutive
//    tiles (tile = 256 threads x Items rows) into (blocks, P) histograms,
//    each thread loading the reader's kLoadRows rows at once.  Each row
//    adds 1 to its warp's own histogram in shared memory, and the warps'
//    histograms are summed at the end (the lanes of one id adding their
//    count once, through __match_any_sync, took 4x as long at 256 ids).
// 2. count_scan_kernel: for each id, the exclusive sum over earlier blocks
//    replaces each block's count in place, and total[p] is the histogram.
//    A block takes G ids (G the power of two <= min(8, P): one 32-byte
//    sector of a row when P >= 8) and splits the blocks among its
//    1024 / G slices.  Up to kFewIds ids and while the block counts are
//    few (kMaxFoldReads), no scan is launched: each downsweep block sums
//    the counts of the blocks before it from the L2 cache, and the last
//    writes the histogram (10 M rows, P = 2: 0.0455 ms for the pass
//    against 0.0489 with the scan launched).
// 3. rank_downsweep_kernel: each block walks its tiles again, ranks each
//    tile's ids stably with tile_rank.cuh's block_rank and writes a row's
//    rank as the rows of its id in earlier blocks and tiles plus that
//    rank.  It loads the next tile's ids while it ranks a tile, and runs
//    the blocks from the last, whose rows the upsweep read last and the
//    L2 cache may still hold (0.0317 ms against 0.0347 in row order at
//    10 M rows, P = 2).  The lanes of an id are found by __match_any_sync
//    up to kFewIds ids and by ballots past that (at P = 2 on 10 M rows the
//    match took 0.030 ms and ballots 0.034; at 513 ids ballots were 25 %
//    faster).
//
// Tried on the same inputs and dropped: ranking each thread's 8
// consecutive rows in registers with shuffle scans for P <= 8 (the pass
// 0.076 ms against 0.060), the upsweep writing the ids as bytes for the
// downsweep to read (its stores cost more than the downsweep saved),
// 16-byte loads in the upsweep, one wave of blocks and counting up to 8
// ids in registers by __reduce_add_sync (no gain).  Times: device ms,
// H100 80GB HBM3 at 700 W, tools/probe_variants.py.
//
// Bound: memory.  The function reads each id once and writes each rank
// once (8 B a row for int32 ids); the pass reads the ids a second time in
// the downsweep and moves the (blocks, P) histograms, which the blocks'
// `per` tiles keep small.
#pragma once

#include <algorithm>

#include "tile_rank.cuh"

namespace repro {

constexpr int kScanThreads = 1024;
// up to this many ids the downsweep finds peers by __match_any_sync and
// may sum the block counts itself
constexpr int kFewIds = 8;
constexpr int kDownBlocks = 6;  // downsweep blocks resident on an SM
// block counts the downsweep may read in all in place of a scan, about
// blocks^2 * P / 2: at 10 M rows and P = 2, 1.5 M from the L2 cache
constexpr long long kMaxFoldReads = 1LL << 24;

// Tiles a block of the up- and downsweep walks: several at large n, so the
// per-block histograms stay small, few enough that the last wave of blocks
// is short: at most `most` (4 for ranks; radix_sort.cu stages 6 for a
// scatter of 8 bits or more).
inline int tiles_per_block(long long tiles, int most = 4) {
  return static_cast<int>(std::min<long long>(most,
                                              std::max(1LL, tiles / 1024)));
}

// Row of item j of this thread in the tile that starts at t0, in
// block_rank's layout: warp w owns Items * 32 consecutive rows and walks
// them 32 at a time.
template <int Items>
__device__ __forceinline__ int64_t row_of(int64_t t0, int j) {
  return t0 + (threadIdx.x >> 5) * (Items * 32) + j * 32 + (threadIdx.x & 31);
}

// An id reader has `template <int R> void read(int64_t start, int stride,
// int64_t end, int (&id)[R]) const`: id[i] is the id of row start + i *
// stride, or -1 for a row at or past `end` or one that is not counted.
// It issues every load of the R rows before it uses any.  Its kLoadRows
// is how many rows a thread of the upsweep reads at once.

// An id read from an int32 array: counted when in [0, P).  The upsweep
// reads 16 rows a thread at once: 7 % faster than 4 at P = 2 on 10 M rows.
struct IdsBelow {
  static constexpr int kLoadRows = 16;
  const int* ids;
  int P;
  template <int R>
  __device__ __forceinline__ void read(int64_t start, int stride, int64_t end,
                                       int (&id)[R]) const {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int64_t row = start + static_cast<int64_t>(i) * stride;
      id[i] = row < end ? ids[row] : -1;
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
      id[i] = static_cast<unsigned>(id[i]) < static_cast<unsigned>(P) ? id[i]
                                                                      : -1;
  }
};

template <int Items, class Ids>
__global__ void __launch_bounds__(kThreads)
    count_upsweep_kernel(Ids ids, int64_t n, int P, int per,
                         int* __restrict__ hist) {
  extern __shared__ int cnt[];  // [kWarps][P]
  constexpr int kTileRows = kThreads * Items;
  // tiles loaded at once
  constexpr int kAhead = Ids::kLoadRows > Items ? Ids::kLoadRows / Items : 1;
  constexpr int R = kAhead * Items;
  for (int i = threadIdx.x; i < kWarps * P; i += kThreads) cnt[i] = 0;
  __syncthreads();
  int* wcnt = cnt + (threadIdx.x >> 5) * P;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * per * kTileRows;
  const int64_t stop = first + static_cast<int64_t>(per) * kTileRows;
  const int64_t end = stop < n ? stop : n;
  for (int64_t t0 = first; t0 < end; t0 += kAhead * kTileRows) {
    int d[R];
    ids.template read<R>(t0 + threadIdx.x, kThreads, end, d);
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (d[j] >= 0) atomicAdd(&wcnt[d[j]], 1);
  }
  __syncthreads();
  int* out = hist + static_cast<int64_t>(blockIdx.x) * P;
  for (int i = threadIdx.x; i < P; i += kThreads) {
    int sum = 0;
    for (int w = 0; w < kWarps; ++w) sum += cnt[w * P + i];
    out[i] = sum;
  }
}

// The ids per block of count_scan_kernel.
inline int scan_ids_per_block(int P) {
  return P >= 8 ? 8 : P >= 4 ? 4 : P >= 2 ? 2 : 1;
}

// Ids [blockIdx.x * G, + G) of P (G from scan_ids_per_block), kScanThreads
// / G slices of the blocks.
__global__ void __launch_bounds__(kScanThreads)
    count_scan_kernel(int* __restrict__ hist, int blocks, int P, int G,
                      int* __restrict__ total) {
  constexpr int kBatch = 8;
  __shared__ int part[kScanThreads];
  const int S = kScanThreads / G;
  const int g = threadIdx.x % G, s = threadIdx.x / G;
  const int d = blockIdx.x * G + g;
  const bool live = d < P;
  const int slice = (blocks + S - 1) / S;
  const int lo = min(s * slice, blocks), hi = live ? min(lo + slice, blocks)
                                                  : lo;
  int sum = 0;
  for (int b = lo; b < hi; b += kBatch) {
    int v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      v[u] = b + u < hi ? hist[static_cast<int64_t>(b + u) * P + d] : 0;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) sum += v[u];
  }
  part[s * G + g] = sum;
  __syncthreads();

  // warp w < G: exclusive scan of id w's slice sums, in place
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
    if (lane == 31 && blockIdx.x * G + warp < P)
      total[blockIdx.x * G + warp] = incl;
  }
  __syncthreads();

  int run = part[s * G + g];
  for (int b = lo; b < hi; b += kBatch) {
    int v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      v[u] = b + u < hi ? hist[static_cast<int64_t>(b + u) * P + d] : 0;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (b + u < hi) hist[static_cast<int64_t>(b + u) * P + d] = run;
      run += v[u];
    }
  }
}

// Each block's offsets: with `total` (P <= kFewIds, no scan launched),
// hist holds the blocks' counts and the block sums the rows of the blocks
// before it (the last block also writes total[p]); otherwise hist holds
// the scanned offsets.  Sets base[0, P) and synchronises.
__device__ __forceinline__ void block_offsets(const int* __restrict__ hist,
                                              int64_t block, int P,
                                              int* __restrict__ total,
                                              int* base) {
  if (!total) {
    for (int i = threadIdx.x; i < P; i += kThreads)
      base[i] = hist[block * P + i];
    __syncthreads();
    return;
  }
  __shared__ int part[kWarps][kFewIds];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int sum[kFewIds] = {};
  for (int64_t b = threadIdx.x; b < block; b += kThreads) {
#pragma unroll
    for (int p = 0; p < kFewIds; ++p) {
      if (p >= P) break;
      sum[p] += hist[b * P + p];
    }
  }
#pragma unroll
  for (int p = 0; p < kFewIds; ++p) {
    if (p >= P) break;
    const int w = __reduce_add_sync(0xffffffffu, sum[p]);
    if (lane == 0) part[warp][p] = w;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < P; p += kThreads) {
    int all = 0;
    for (int w = 0; w < kWarps; ++w) all += part[w][p];
    base[p] = all;
    if (block + 1 == gridDim.x) total[p] = all + hist[block * P + p];
  }
  __syncthreads();
}

// A row's rank is the rows of its id in earlier blocks, earlier tiles of
// its block, and its rank in its tile.  Blocks run from the last: the
// upsweep ended on the last rows, which the L2 cache may still hold.  Each
// tile's ids are loaded while the tile before is ranked.
template <int Items, bool kBallot, class Ids>
__global__ void __launch_bounds__(kThreads, Items == 8 ? 4 : kDownBlocks)
    rank_downsweep_kernel(Ids ids, int64_t n, int P, int per,
                          const int* __restrict__ hist,
                          int* __restrict__ total,
                          int* __restrict__ rank_out) {
  constexpr int kTileRows = kThreads * Items;
  extern __shared__ int smem[];
  int* base = smem;  // [P] rows of each id before this tile
  // [2][kWarps][P]: block_rank's counts, the two halves in turn, so one
  // tile's are cleared while the tile before may still read its own
  int* cnt = base + P;
  const int64_t block = gridDim.x - 1 - blockIdx.x;
  const int64_t first = block * per * kTileRows;
  const int64_t stop = first + static_cast<int64_t>(per) * kTileRows;
  const int64_t end = stop < n ? stop : n;
  int next[Items];
  ids.template read<Items>(row_of<Items>(first, 0), 32, end, next);
  block_offsets(hist, block, P, total, base);

  int half = 0;
  for (int64_t t0 = first; t0 < end; t0 += kTileRows, half ^= 1) {
    int id[Items], rank[Items];
#pragma unroll
    for (int j = 0; j < Items; ++j) id[j] = next[j];
    if (t0 + kTileRows < end)
      ids.template read<Items>(row_of<Items>(t0 + kTileRows, 0), 32, end,
                               next);
    block_rank<Items, kBallot>(id, P, cnt + half * kWarps * P, nullptr, rank,
                               base);
#pragma unroll
    for (int j = 0; j < Items; ++j) {
      const int64_t row = row_of<Items>(t0, j);
      if (row < end) rank_out[row] = rank[j];
    }
  }
}

// Blocks of `per` tiles of kThreads * Items rows that cover n rows.
template <int Items>
inline long long count_blocks(long long n, int per) {
  const long long tiles = (n + kThreads * Items - 1) / (kThreads * Items);
  return (tiles + per - 1) / per;
}

template <int Items, class Ids>
int launch_upsweep(Ids ids, long long n, int P, int per, long long blocks,
                   int* hist, cudaStream_t stream) {
  size_t smem = 0;
  const int err = prepare_shared(count_upsweep_kernel<Items, Ids>, P, &smem);
  if (err) return err;
  count_upsweep_kernel<Items, Ids>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
          ids, n, P, per, hist);
  return static_cast<int>(cudaGetLastError());
}

// The scan: hist (blocks, P) becomes the exclusive offsets of each block,
// total (P,) the histogram.
inline int launch_scan(int* hist, long long blocks, int P, int* total,
                       cudaStream_t stream) {
  const int G = scan_ids_per_block(P);
  count_scan_kernel<<<(P + G - 1) / G, kScanThreads, 0, stream>>>(
      hist, static_cast<int>(blocks), P, G, total);
  return static_cast<int>(cudaGetLastError());
}

template <int Items, bool kBallot, class Ids>
int launch_downsweep(Ids ids, long long n, int P, int per, long long blocks,
                     const int* hist, int* total, int* rank_out,
                     cudaStream_t stream) {
  size_t smem = 0;
  const int err = prepare_shared(rank_downsweep_kernel<Items, kBallot, Ids>,
                                 P, &smem, (kWarps + 1LL) * P);
  if (err) return err;
  rank_downsweep_kernel<Items, kBallot, Ids>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
          ids, n, P, per, hist, total, rank_out);
  return static_cast<int>(cudaGetLastError());
}

// The whole pass over n > 0 rows and P >= 1 ids: `count_ids` reads a
// row's id in the upsweep, `rank_ids` in the downsweep (the same ids; the
// two differ where the upsweep writes them out for the downsweep to read,
// as fused_bucketing.cu does).  Up to kFewIds ids, and while the blocks'
// counts the downsweep would read stay below kMaxFoldReads, each block of
// the downsweep sums the counts of the blocks before it and no scan is
// launched.  hist is
// scratch of at least ceil(n / (kThreads * Items)) * P ints; writes total
// (P,) and rank_out (n,).  Returns the first failed launch's cudaError_t.
template <int Items, class CountIds, class RankIds>
int count_rank_pass(CountIds count_ids, RankIds rank_ids, long long n, int P,
                    int* hist, int* total, int* rank_out,
                    cudaStream_t stream) {
  if (n <= 0 || P < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (n + kThreads * Items - 1) / (kThreads * Items);
  const int per = tiles_per_block(tiles);
  const long long blocks = count_blocks<Items>(n, per);
  int err = launch_upsweep<Items>(count_ids, n, P, per, blocks, hist, stream);
  if (err) return err;
  const bool few = P <= kFewIds;
  if (few && blocks * blocks * P <= kMaxFoldReads)
    return launch_downsweep<Items, false>(rank_ids, n, P, per, blocks, hist,
                                          total, rank_out, stream);
  err = launch_scan(hist, blocks, P, total, stream);
  if (err) return err;
  if (few)
    return launch_downsweep<Items, false>(rank_ids, n, P, per, blocks, hist,
                                          nullptr, rank_out, stream);
  return launch_downsweep<Items, true>(rank_ids, n, P, per, blocks, hist,
                                       nullptr, rank_out, stream);
}

}  // namespace repro

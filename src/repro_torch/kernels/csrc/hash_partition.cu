// Partition histogram and each row's stable rank within its partition,
// whole on the card.
//
// Replaces the TPU kernel radix_histogram_ranks_tiles
// (src/repro/kernels/hash_partition/kernel.py), which builds a (tile, P)
// one-hot in vector registers and reduces it two ways into per-tile
// histograms and within-tile ranks, leaving the cross-tile scan to XLA.
// Here a call is tile_scan.cuh's counting pass over the ids: per-block
// histograms (an id outside [0, P) is not counted), their exclusive scan
// per id (folded into the downsweep up to 8 ids), and a downsweep that
// ranks each tile of 2048 rows with warp matching (ballots past 8 ids)
// and writes every row's rank in row order, the rows of its id in earlier
// blocks and tiles added.  No one-hot exists, and no per-tile output
// leaves the card.  Tiles of 2048 rows (8 a thread) against 1024: 10 M
// rows at P = 2 0.0515 ms against 0.0543, P = 513 on 625 k rows 0.0154
// against 0.0172 (device ms, H100, tools/probe_variants.py).
//
// Bound: memory.  Each id is read once (4 B) and its rank written once
// (4 B), with the (P,) histogram.  The pass reads the ids twice and moves
// (blocks, P) block histograms, one row per 2048 to 8192 rows.
#include "tile_scan.cuh"

namespace {

constexpr int kItems = 8;  // rows per thread: tiles of 2048 rows

}  // namespace

// The scratch a call needs is at most ceil(n / hash_partition_tile_rows())
// * P ints.
extern "C" int hash_partition_tile_rows() {
  return repro::kThreads * kItems;
}

// pid int32 (n,), n > 0, 1 <= P -> hist int32 (P,), ranks int32 (n,); an
// id outside [0, P) is not counted and gets rank 0.  scratch: see
// hash_partition_tile_rows.  Returns the first failed launch's
// cudaError_t.
extern "C" int hash_partition_ranks(const int* pid, long long n, int P,
                                    int* scratch, int* hist, int* ranks,
                                    void* stream) {
  const repro::IdsBelow ids{pid, P};
  return repro::count_rank_pass<kItems>(
      ids, ids, n, P, scratch, hist, ranks,
      static_cast<cudaStream_t>(stream));
}

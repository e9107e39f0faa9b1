// Fused murmur hash + bucket histogram + each row's stable rank within its
// bucket, whole on the card.
//
// Replaces the TPU kernel fused_bucket_ranks_tiles
// (src/repro/kernels/fused_bucketing/kernel.py).  A call is tile_scan.cuh's
// counting pass over P + 1 buckets.  The upsweep hashes each row's K key
// planes in native uint32 (h0 = golden ratio; h = fmix32(h ^ (u + golden
// + (h << 6) + (h >> 2))) per plane), takes bid = h % P for a valid row and
// the trash bucket P otherwise, writes bid and counts it per block; the
// scan turns the block counts into offsets and the histogram; the
// downsweep reads bid back and ranks it as hash_partition ranks its ids.
// The bucket id equals the plain version's bit for bit, which the
// host-side join planner relies on.
//
// The planes come as pointers by value in the kernel's parameters (up to
// kMaxPlanes), so no stacked copy is made; past that the caller stacks
// them into one (K, n) array.
//
// Hash once or twice: bid is an output, written once either way.  Hashing
// again in the downsweep would read the K planes and the validity byte a
// second time, 4 K + 1 B a row; reading bid back reads 4 B.  That is
// fewer at every K (5 against 4 at K = 1), so the upsweep writes bid and
// the downsweep reads it.
//
// Bound: memory.  Each row reads K planes (4 B each) and its validity byte
// once and writes bid and rank once (8 B); the hash is a few integer
// operations per plane.
#include "tile_scan.cuh"

namespace {

constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr int kMaxPlanes = 32;
constexpr int kItems = 8;  // rows per thread: tiles of 2048 rows

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// The buckets of rows, written to bid as they are read (a reader of
// tile_scan.cuh): plane k of all R rows is loaded before any is mixed in.
// The upsweep hashes one tile's rows a thread at once, not 16: with
// 1024-row tiles 16 rows took 1.4-2x as long as 4 at K 1 and K 3 (device
// ms, H100, tools/probe_variants.py).
struct HashBuckets {
  static constexpr int kLoadRows = 8;
  const int* plane[kMaxPlanes];  // K <= kMaxPlanes: plane k
  const int* stacked;            // otherwise: (K, n), plane k at k * n
  const uint8_t* valid;
  int64_t n;
  int K, P;
  int* bid;
  template <int R>
  __device__ __forceinline__ void read(int64_t start, int stride, int64_t end,
                                       int (&id)[R]) const {
    uint32_t h[R];
    uint8_t v[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int64_t row = start + static_cast<int64_t>(i) * stride;
      v[i] = row < end ? valid[row] : 0;
      h[i] = kGolden;
    }
    for (int k = 0; k < K; ++k) {
      const int* p = stacked ? stacked + k * n : plane[k];
      uint32_t u[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int64_t row = start + static_cast<int64_t>(i) * stride;
        u[i] = row < end ? static_cast<uint32_t>(p[row]) : 0u;
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
        h[i] = mix32(h[i] ^ (u[i] + kGolden + (h[i] << 6) + (h[i] >> 2)));
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int64_t row = start + static_cast<int64_t>(i) * stride;
      id[i] = -1;
      if (row < end) {
        id[i] = v[i] ? static_cast<int>(h[i] % static_cast<uint32_t>(P)) : P;
        bid[row] = id[i];
      }
    }
  }
};

}  // namespace

// The most key planes passed one by one; the scratch a call needs, at most
// ceil(n / fused_bucketing_tile_rows()) * (P + 1) ints.
extern "C" int fused_bucketing_max_planes() { return kMaxPlanes; }
extern "C" int fused_bucketing_tile_rows() {
  return repro::kThreads * kItems;
}

// planes: K host-side addresses of int32 (n,) key planes when K <=
// fused_bucketing_max_planes(), else nullptr and stacked int32 (K, n);
// valid bool (n,); n > 0, K >= 1, P >= 1.  Writes bid int32 (n,), hist
// int32 (P + 1,) (the trash bucket last) and ranks int32 (n,).  Returns
// the first failed launch's cudaError_t.
extern "C" int fused_bucketing_ranks(const int* const* planes,
                                     const int* stacked,
                                     const uint8_t* valid, long long n, int K,
                                     int P, int* scratch, int* bid, int* hist,
                                     int* ranks, void* stream) {
  if (K < 1 || P < 1 || (K > kMaxPlanes) != (stacked != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  HashBuckets hash{};
  if (!stacked)
    for (int k = 0; k < K; ++k) hash.plane[k] = planes[k];
  hash.stacked = stacked;
  hash.valid = valid;
  hash.n = n;
  hash.K = K;
  hash.P = P;
  hash.bid = bid;
  return repro::count_rank_pass<kItems>(
      hash, repro::IdsBelow{bid, P + 1}, n, P + 1, scratch, hist, ranks,
      static_cast<cudaStream_t>(stream));
}

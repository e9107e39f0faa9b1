// Bucketed hash-semi membership probe: per bucket, whether each occupied
// probe slot's key is carried by any occupied build slot.
//
// Replaces the TPU kernel bucket_member_buckets
// (src/repro/kernels/hash_semi/kernel.py), which materialises each
// bucket's dense (Lc, C) match matrix in vector registers and reduces
// each row with a sum.  Membership needs one answer per probe slot and
// nothing per pair, so here a probe slot meets about one build key:
//
// 1. Each bucket's occupied build slots enter an open-addressing hash
//    table of 64-bit entries {plane 0 of the key, build slot}, all ones
//    while empty, each entered by one atomicCAS.  A slot whose key is in
//    the table already enters nothing, so keys repeated in the build side
//    (the set ops' about 5 rows a key) do not lengthen the chains.  The
//    table has table_size(2 C) entries, a power of two above 2 C, so at
//    most half of them fill, and it is indexed by key_hash
//    (bucket_table.cuh), whose bits do not follow the bucket's.  Up to
//    kSharedEntries entries (16 KB) the table sits in shared memory, and
//    every block of the bucket builds its own copy first; a larger one is
//    built once per bucket into a device-memory workspace that the
//    wrapper allocates (cleared by a memset, then filled by many blocks
//    a bucket), and the probe reads it through L2.  A thread enters 4
//    consecutive build slots, their loads issued together.
// 2. Each thread owns vectors of 4 consecutive probe slots, kUnroll
//    vectors at a time whose loads issue together.  It reads the 4
//    occupancy flags as one 16-byte load, the key planes only when one of
//    them is occupied, looks each occupied slot up in the table on its
//    own (no step across the warp per slot), and writes the 4 flags as
//    one 16-byte store.  Planes past the first are compared, at an entry
//    whose plane 0 matches, with the build slab in device memory.  A slab
//    whose rows are not 16-byte aligned (Lc % 4 != 0, or a base pointer
//    at an offset) takes the same steps with scalar loads and stores.
// 3. The grid is (B, shares): as many shares of each bucket's probe slots
//    as give the card kWaves waves of resident blocks, so a few wide
//    buckets (the UNOMT cell filter's 128) still fill every SM.
//
// Bound: the function must read both occupancy slabs, 4 * B * (Lc + C)
// bytes, and the key planes of the occupied slots, 4 * K * (sum_b
// occ_probe_b + occ_build_b), and write one flag per probe slot,
// 4 * B * Lc.  A hash table meets about one build key a probe, so the
// compares (about K per occupied slot) are far below the bytes, and the
// bytes bound it.  The kernel moves each of them once, but for the keys
// of empty slots in a vector that holds an occupied one, and the build
// occupancy once per block of a bucket.
#include "bucket_table.cuh"
#include "tile_rank.cuh"

namespace {

using Entry = unsigned long long;
using repro::key_hash;

constexpr Entry kEmpty = ~0ull;
constexpr int kMaxThreads = 256;
constexpr int kUnroll = 2;            // vectors a thread loads at once
// waves of resident blocks a launch aims at when it splits buckets into
// shares: more, shorter blocks end together (the UNOMT cell filter's 128
// buckets: 0.1441 ms a call at one wave, 0.1319 at 8, 0.1314 at one block
// a round, by probe on an H100)
constexpr int kWaves = 8;
constexpr int kSharedEntries = 2048;  // the largest table in shared memory
constexpr int kHashed = 4;            // key planes hashed, kept in registers
constexpr int kMaxC = 1 << 28;        // build slots a bucket may have

__host__ __device__ __forceinline__ int entries(int C) {
  return repro::table_size(2 * C);
}

__device__ __forceinline__ int entry_key(Entry e) {
  return static_cast<int>(static_cast<unsigned>(e));
}

__device__ __forceinline__ int entry_slot(Entry e) {
  return static_cast<int>(e >> 32);
}

// Planes 1 .. K - 1 of a key (those below kHashed in `key`, the rest at
// rest[k * stride]) equal those of the build slot at bs (bs[k * C]).
__device__ __forceinline__ bool same_rest(const int (&key)[kHashed],
                                          const int* rest, int64_t stride,
                                          const int* bs, int C, int K) {
#pragma unroll
  for (int k = 1; k < kHashed; ++k)
    if (k < K && key[k] != bs[static_cast<int64_t>(k) * C]) return false;
  for (int k = kHashed; k < K; ++k)
    if (rest[k * stride] != bs[static_cast<int64_t>(k) * C]) return false;
  return true;
}

// Build slot c (occupied, key planes `key`) of the bucket whose slab is bb
// (K, C) enters the table, unless an entry carries its key already.
template <bool kOneKey>
__device__ __forceinline__ void enter(Entry* table, int tmask,
                                      const int (&key)[kHashed],
                                      const int* bb, int C, int K, int c) {
  const Entry mine =
      (static_cast<Entry>(static_cast<unsigned>(c)) << 32) |
      static_cast<unsigned>(key[0]);
  const int ks = kOneKey ? 1 : (K < kHashed ? K : kHashed);
  for (int t = key_hash(key, ks) & tmask;; t = (t + 1) & tmask) {
    Entry e = table[t];
    if (e == kEmpty) {
      e = atomicCAS(&table[t], kEmpty, mine);
      if (e == kEmpty) return;
    }
    if (entry_key(e) == key[0] &&
        (kOneKey || same_rest(key, bb + c, C, bb + entry_slot(e), C, K)))
      return;
  }
}

// Slots 4 v .. 4 v + 3 of a row of n ints: one 16-byte access (kVec: the
// row is 16-byte aligned and n % 4 == 0), else four, past n reading 0
// and writing nothing.
template <bool kVec>
__device__ __forceinline__ void load4(const int* __restrict__ row, int v,
                                      int n, int (&x)[4]) {
  if (kVec) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(row) + v);
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x[j] = 4 * v + j < n ? __ldg(row + 4 * v + j) : 0;
  }
}

template <bool kVec>
__device__ __forceinline__ void store4(int* __restrict__ row, int v, int n,
                                       const int (&x)[4]) {
  if (kVec) {
    reinterpret_cast<int4*>(row)[v] = make_int4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * v + j < n) row[4 * v + j] = x[j];
  }
}

// The occupied build slots of one bucket (slab bb, occupancy bo) enter
// its table, 4 consecutive slots a thread (vectors v0, v0 + step, ...),
// their loads issued together.
template <bool kOneKey>
__device__ __forceinline__ void fill(Entry* table, int tmask,
                                     const int* __restrict__ bb,
                                     const int* __restrict__ bo, int C,
                                     int K, int v0, int step) {
  const int ks = kOneKey ? 1 : (K < kHashed ? K : kHashed);
  for (int v = v0; 4 * v < C; v += step) {
    int occ[4];
    load4<false>(bo, v, C, occ);
    if ((occ[0] <= 0) & (occ[1] <= 0) & (occ[2] <= 0) & (occ[3] <= 0))
      continue;
    int key[kHashed][4] = {};
#pragma unroll
    for (int k = 0; k < kHashed; ++k)
      if (k < ks)
        load4<false>(bb + static_cast<int64_t>(k) * C, v, C, key[k]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (occ[j] <= 0) continue;
      const int mine[kHashed] = {key[0][j], key[1][j], key[2][j], key[3][j]};
      enter<kOneKey>(table, tmask, mine, bb, C, K, 4 * v + j);
    }
  }
}

// Is the probe key `key` (planes past kHashed at prest[k * Lc]) in the
// table of the bucket whose build slab is bb?
template <bool kOneKey>
__device__ __forceinline__ int lookup(const Entry* table, int tmask,
                                      const int (&key)[kHashed],
                                      const int* prest, int Lc,
                                      const int* bb, int C, int K) {
  const int ks = kOneKey ? 1 : (K < kHashed ? K : kHashed);
  for (int t = key_hash(key, ks) & tmask;; t = (t + 1) & tmask) {
    const Entry e = table[t];
    if (e == kEmpty) return 0;
    if (entry_key(e) == key[0] &&
        (kOneKey || same_rest(key, prest, Lc, bb + entry_slot(e), C, K)))
      return 1;
  }
}

// Bucket blockIdx.x's occupied build slots enter its table in the
// workspace, 4 slots a thread.
template <bool kOneKey>
__global__ void __launch_bounds__(kMaxThreads)
    hash_semi_table_kernel(const int* __restrict__ bbits,
                           const int* __restrict__ bocc, int K, int C,
                           int tmask, Entry* __restrict__ tables) {
  const int64_t b = blockIdx.x;
  fill<kOneKey>(tables + b * (tmask + 1), tmask, bbits + b * K * C,
                bocc + b * C, C, K, blockIdx.y * blockDim.x + threadIdx.x,
                gridDim.y * blockDim.x);
}

// Block (b, s) probes share s of bucket b's slots: vectors s * blockDim.x
// + threadIdx.x, then on by gridDim.y * blockDim.x.  kShared: the block
// first builds the bucket's table in shared memory; else it reads the
// bucket's table in `tables`.
template <bool kOneKey, bool kShared, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
    hash_semi_kernel(const int* __restrict__ pbits,
                     const int* __restrict__ pocc,
                     const int* __restrict__ bbits,
                     const int* __restrict__ bocc, int K, int Lc, int C,
                     int tmask, const Entry* __restrict__ tables,
                     int* __restrict__ member) {
  extern __shared__ Entry shared_table[];
  const int64_t b = blockIdx.x;
  const int* pb = pbits + b * K * Lc;
  const int* po = pocc + b * Lc;
  const int* bb = bbits + b * K * C;
  int* out = member + b * Lc;
  const int ks = kOneKey ? 1 : (K < kHashed ? K : kHashed);
  const Entry* table = kShared ? shared_table : tables + b * (tmask + 1);
  if (kShared) {
    for (int t = threadIdx.x; t <= tmask; t += blockDim.x)
      shared_table[t] = kEmpty;
    __syncthreads();
    fill<kOneKey>(shared_table, tmask, bb, bocc + b * C, C, K, threadIdx.x,
                  blockDim.x);
    __syncthreads();
  }

  const int nvec = (Lc + 3) >> 2;
  const int step = gridDim.y * blockDim.x;
  for (int v0 = blockIdx.y * blockDim.x + threadIdx.x; v0 < nvec;
       v0 += kUnroll * step) {
    int occ[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (v0 + u * step < nvec) {
        load4<kVec>(po, v0 + u * step, Lc, occ[u]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) occ[u][j] = 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + u * step;
      if (v >= nvec) break;
      int hit[4] = {0, 0, 0, 0};
      if ((occ[u][0] > 0) | (occ[u][1] > 0) | (occ[u][2] > 0) |
          (occ[u][3] > 0)) {
        int key[kHashed][4] = {};
#pragma unroll
        for (int k = 0; k < kHashed; ++k)
          if (k < ks) load4<kVec>(pb + static_cast<int64_t>(k) * Lc, v, Lc,
                                  key[k]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (occ[u][j] <= 0) continue;
          const int mine[kHashed] = {key[0][j], key[1][j], key[2][j],
                                     key[3][j]};
          hit[j] = lookup<kOneKey>(table, tmask, mine, pb + 4 * v + j, Lc,
                                   bb, C, K);
        }
      }
      store4<kVec>(out, v, Lc, hit);
    }
  }
}

using Probe = void (*)(const int*, const int*, const int*, const int*, int,
                       int, int, int, const Entry*, int*);

template <bool kOneKey>
Probe probe_kernel(bool shared, bool vec) {
  if (shared)
    return vec ? hash_semi_kernel<kOneKey, true, true>
               : hash_semi_kernel<kOneKey, true, false>;
  return vec ? hash_semi_kernel<kOneKey, false, true>
             : hash_semi_kernel<kOneKey, false, false>;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Bytes of device memory the tables of B buckets of C build slots need
// outside shared memory: 0 when each fits in a block's shared memory.
extern "C" long long hash_semi_workspace_bytes(int B, int C) {
  if (B <= 0 || C <= 0 || C > kMaxC) return 0;
  const int T = entries(C);
  return T > kSharedEntries
             ? static_cast<long long>(B) * T * static_cast<int>(sizeof(Entry))
             : 0;
}

// pbits (B, K, Lc), pocc (B, Lc), bbits (B, K, C), bocc (B, C) int32 ->
// member (B, Lc) int32 0/1, every slot written.  B, K, Lc > 0, 0 < C <=
// 2^28; `workspace` holds hash_semi_workspace_bytes(B, C) bytes
// (16-byte aligned; unused, and may be null, when that is 0).  Returns
// the first launch's error, as a cudaError_t.
extern "C" int hash_semi_member(const int* pbits, const int* pocc,
                                const int* bbits, const int* bocc, int B,
                                int K, int Lc, int C, void* workspace,
                                int* member, void* stream) {
  if (B <= 0 || K <= 0 || Lc <= 0 || C <= 0 || C > kMaxC)
    return static_cast<int>(cudaErrorInvalidValue);
  const int T = entries(C);
  const bool shared = T <= kSharedEntries;
  if (!shared && !aligned16(workspace))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Entry* tables = static_cast<Entry*>(workspace);
  cudaError_t e = cudaSuccess;
  if (!shared) {
    // every entry empty (all ones), then the build slots enter
    if ((e = cudaMemsetAsync(tables, 0xff,
                             static_cast<size_t>(B) * T * sizeof(Entry),
                             st)))
      return static_cast<int>(e);
    const int parts = (C + 4 * kMaxThreads - 1) / (4 * kMaxThreads);
    const dim3 grid(static_cast<unsigned>(B),
                    static_cast<unsigned>(parts < 65535 ? parts : 65535));
    if (K == 1)
      hash_semi_table_kernel<true><<<grid, kMaxThreads, 0, st>>>(
          bbits, bocc, K, C, T - 1, tables);
    else
      hash_semi_table_kernel<false><<<grid, kMaxThreads, 0, st>>>(
          bbits, bocc, K, C, T - 1, tables);
    if ((e = cudaGetLastError())) return static_cast<int>(e);
  }

  const bool vec = Lc % 4 == 0 && aligned16(pbits) && aligned16(pocc) &&
                   aligned16(member);
  const Probe kernel = K == 1 ? probe_kernel<true>(shared, vec)
                              : probe_kernel<false>(shared, vec);
  // a thread a vector of 4 slots, kUnroll at a time, in whole warps
  const int nvec = (Lc + 3) / 4;
  const int want = (nvec + kUnroll - 1) / kUnroll;
  const int threads =
      want >= kMaxThreads ? kMaxThreads : (want + 31) / 32 * 32;
  const size_t smem = shared ? static_cast<size_t>(T) * sizeof(Entry) : 0;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)))
    return static_cast<int>(e);
  // shares of a bucket: kWaves waves of resident blocks over all buckets,
  // at most one per round of kUnroll vectors a thread
  const int64_t rounds = (nvec + threads * kUnroll - 1) /
                         (static_cast<int64_t>(threads) * kUnroll);
  int64_t shares = static_cast<int64_t>(per_sm) * sms * kWaves / B;
  if (shares > rounds) shares = rounds;
  if (shares > 65535) shares = 65535;
  if (shares < 1) shares = 1;
  kernel<<<dim3(static_cast<unsigned>(B), static_cast<unsigned>(shares)),
           threads, smem, st>>>(pbits, pocc, bbits, bocc, K, Lc, C, T - 1,
                                tables, member);
  return static_cast<int>(cudaGetLastError());
}

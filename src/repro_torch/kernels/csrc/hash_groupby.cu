// Bucketed hash-accumulate groupby: per bucket, every slot's group
// representative flag, group size and per-value-column sum, min and max.
//
// Replaces the TPU kernel bucket_accumulate_buckets
// (src/repro/kernels/hash_groupby/kernel.py), which materialises each
// bucket's dense (C, C) key-equality matrix in vector registers and
// reduces it five ways.  The function needs only the occupied slots
// compared, and on the groupby leg's slabs (about a third full, some 15
// keys a bucket) the bytes bound it, so here one warp takes one bucket,
// one warp a block (at two and four warps a block, a bucket each, the
// groupby leg's slabs ran 2.5 % and 4.6 % slower by probe, on an H100),
// and touches only what is occupied:
//
// 1. The bucket's occupied slots are compacted in slot order into the
//    warp's workspace (__ballot_sync and __popc over 32 slots at a time,
//    for any occupancy, not only a prefix), with their first kStaged key
//    planes and first value column.  The loads of
//    kRound batches issue before the first is used, so a bucket waits on
//    device memory about once per 32 * kRound slots, and the ballots stay
//    in the workspace for the writes.
// 2. Groups are numbered in the order of their first slots: each batch of
//    32 entries looks its keys up among the groups found so far in an
//    open-addressing hash table of the bucket's keys (a power of two
//    above C entries, so mostly one probe); the entries left are new
//    keys, which __match_any_sync of their planes sorts into new groups,
//    each led by its first slot, which enters it in the table.
// 3. Per value column, 32 entries at a time in slot order, the lanes of
//    each group find each other (__match_any_sync of the group numbers)
//    and the first of them folds their values, in lane order, into the
//    group's running count, sum, and NaN-propagating min and max; every
//    slot then takes its group's results, and empty slots 0, +inf and
//    -inf, in coalesced writes in slot order.
//
// min and max propagate NaN explicitly (fminf/fmaxf would drop it), as
// the reference's jnp.min/jnp.max do.  Sums add in slot order, so on
// integer-valued data they are exact.  Key planes compare as integers,
// so NaN keys group by their bits.
//
// The workspace (8 + ks ints a slot, the ballots and a table of up to
// 2 C ints) lives in the block's shared memory.  A slab whose workspace
// does not fit there takes the same steps with it in device memory, in
// a workspace the wrapper allocates (hash_groupby_workspace_bytes) for at
// most kScratchBytes of workspaces, the blocks taking buckets in turn
// (B 512, C 7000, K 2, V 5, a third full: 1.11 ms, where a warp a bucket
// scanning the earlier slots in place in the outputs took 26.6 and a
// 256-thread block a bucket comparing every pair of slots 54.0; by probe,
// on an H100 80GB HBM3 at 700 W).
//
// Work: per occupied slot about one table probe (up to K key compares)
// and one value update per column; bytes: it must read the occupancy and
// the keys and values of the occupied slots, 4 * (B * C + sum_b occ_b *
// (K + V)), and write 4 * B * C * (2 + 3 V).
#include <math.h>

#include "bucket_table.cuh"
#include "tile_rank.cuh"

namespace {

using repro::key_hash;
using repro::table_size;

constexpr int kStaged = 4;    // key planes staged in the workspace
constexpr int kRound = 16;    // 32-slot batches whose loads issue at once
// device memory for the workspaces of slabs too large for shared memory
constexpr int64_t kScratchBytes = int64_t{256} << 20;

__device__ __forceinline__ float nan_min(float a, float x) {
  return (isnan(x) || x < a) ? x : a;
}

__device__ __forceinline__ float nan_max(float a, float x) {
  return (isnan(x) || x > a) ? x : a;
}

// One bucket's slab: kb [K][C] key planes, ob [C] occupancy, vb [V][C]
// values, and its outputs.
struct Slab {
  const int* kb;
  const int* ob;
  const float* vb;
  int* rep;
  int* counts;
  float* sums;
  float* mins;
  float* maxs;
};

// A warp's workspace, C entries per array.
struct Space {
  int* idx;      // entry -> its slot
  int* gid;      // entry -> its group
  int* key;      // [ks][C] the entries' first ks key planes
  float* val;    // entry -> its value in the current column
  int* first;    // group -> its first entry
  int* cnt;      // group -> its size
  float* sum;
  float* lo;
  float* hi;
  unsigned* mask;   // [ceil(C / 32)] occupancy ballots of the slots
  int* table;       // [T] key hash -> group (-1: empty), open addressing
  int tmask;        // T - 1; T the power of two above C
};

// Group keys while groups are numbered: plane k < kStaged of group g at
// gkey(w, k)[g], in the arrays the per-group results use afterwards.
__device__ __forceinline__ int* gkey(const Space& w, int k) {
  return k == 0 ? w.cnt
         : k == 1 ? reinterpret_cast<int*>(w.sum)
         : k == 2 ? reinterpret_cast<int*>(w.lo)
                  : reinterpret_cast<int*>(w.hi);
}

// Planes ks .. K - 1 of entries e and f (compacted indices) are equal.
__device__ __forceinline__ bool same_rest(const Space& w, const Slab& s,
                                          int K, int C, int ks, int e,
                                          int f) {
  for (int k = ks; k < K; ++k)
    if (s.kb[k * C + w.idx[e]] != s.kb[k * C + w.idx[f]]) return false;
  return true;
}

__device__ void bucket_walk(const Space& w, const Slab& s, int K,
                                 int V, int C, int ks) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = repro::lanemask_lt();

  for (int i = lane; i <= w.tmask; i += 32) w.table[i] = -1;

  // 1. compact the occupied slots with their first key plane and first
  // value column, kRound batches of 32 slots at a time, every load of a
  // round issued before the first is used
  int n = 0;
  for (int r0 = 0; r0 < C; r0 += 32 * kRound) {
    int o[kRound], k0[kRound];
    float x0[kRound];
#pragma unroll
    for (int j = 0; j < kRound; ++j) {
      const int i = r0 + 32 * j + lane;
      const bool in = i < C;
      o[j] = in ? s.ob[i] : 0;
      k0[j] = in ? s.kb[i] : 0;
      x0[j] = in ? s.vb[i] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kRound; ++j) {
      const int i = r0 + 32 * j + lane;
      if (r0 + 32 * j >= C) break;
      const unsigned m = __ballot_sync(0xffffffffu, o[j] > 0);
      if (lane == 0) w.mask[(r0 >> 5) + j] = m;
      if (o[j] > 0) {
        const int e = n + __popc(m & lt);
        w.idx[e] = i;
        w.key[e] = k0[j];
        w.val[e] = x0[j];
        for (int k = 1; k < ks; ++k) w.key[k * C + e] = s.kb[k * C + i];
      }
      n += __popc(m);
    }
  }
  __syncwarp();

  // 2. number the groups in the order of their first entries
  int G = 0;
  for (int e0 = 0; e0 < n; e0 += 32) {
    const int e = e0 + lane;
    const bool live = e < n;
    int mine[kStaged];
#pragma unroll
    for (int k = 0; k < kStaged; ++k)
      mine[k] = live && k < ks ? w.key[k * C + e] : 0;
    // the groups found so far, through the table
    const unsigned hash = key_hash(mine, ks);
    int g = -1;
    for (int t = hash & w.tmask; live; t = (t + 1) & w.tmask) {
      const int q = w.table[t];
      if (q < 0) break;                 // a key not seen before
      bool eq = true;
#pragma unroll
      for (int k = 0; k < kStaged; ++k)
        if (k < ks) eq = eq && gkey(w, k)[q] == mine[k];
      if (eq && K > ks) eq = same_rest(w, s, K, C, ks, e, w.first[q]);
      if (eq) {
        g = q;
        break;
      }
    }
    // the rest hold new keys: one group per distinct key, led by its
    // first entry
    const bool fresh = live && g < 0;
    unsigned peers = __ballot_sync(0xffffffffu, fresh);
#pragma unroll
    for (int k = 0; k < kStaged; ++k)
      if (k < ks) peers &= __match_any_sync(0xffffffffu, mine[k]);
    for (int k = ks; k < K; ++k)
      peers &= __match_any_sync(0xffffffffu,
                                live ? s.kb[k * C + w.idx[e]] : 0);
    const int lead = fresh ? __ffs(peers) - 1 : lane;
    const unsigned leads = __ballot_sync(0xffffffffu, fresh && lead == lane);
    if (fresh && lead == lane) {
      g = G + __popc(leads & lt);
      w.first[g] = e;
#pragma unroll
      for (int k = 0; k < kStaged; ++k)
        if (k < ks) gkey(w, k)[g] = mine[k];
      int t = hash & w.tmask;           // other leaders insert other keys
      while (atomicCAS(&w.table[t], -1, g) != -1) t = (t + 1) & w.tmask;
    }
    const int lg = __shfl_sync(0xffffffffu, g, lead);
    if (fresh) g = lg;
    if (live) w.gid[e] = g;
    G += __popc(leads);
    __syncwarp();
  }
  __syncwarp();

  // 3. per value column: fold each group's values, then write every slot
  for (int v = 0; v < V; ++v) {
    if (v > 0) {     // column 0 came with the compaction
      const float* vv = s.vb + static_cast<int64_t>(v) * C;
      for (int e = lane; e < n; e += 32) w.val[e] = vv[w.idx[e]];
      __syncwarp();
    }
    for (int g = lane; g < G; g += 32) {
      w.cnt[g] = 0;
      w.sum[g] = 0.0f;
      w.lo[g] = INFINITY;
      w.hi[g] = -INFINITY;
    }
    __syncwarp();
    // 32 entries at a time: the lanes of one group find each other, and
    // the first of them folds their values into the group's running
    // results in lane order, so every group adds in slot order
    for (int e0 = 0; e0 < n; e0 += 32) {
      const int e = e0 + lane;
      const bool live = e < n;
      const int g = live ? w.gid[e] : -1 - lane;
      const float x = live ? w.val[e] : 0.0f;
      const unsigned peers = __match_any_sync(0xffffffffu, g);
      const int size = __popc(peers);
      const bool lead = live && (peers & lt) == 0;
      float sum = 0.0f, lo = INFINITY, hi = -INFINITY;
      if (lead) {
        sum = w.sum[g];
        lo = w.lo[g];
        hi = w.hi[g];
      }
      const int most = static_cast<int>(
          __reduce_max_sync(0xffffffffu, static_cast<unsigned>(size)));
      unsigned rest = peers;
      for (int it = 0; it < most; ++it) {
        const int j = rest ? __ffs(rest) - 1 : lane;
        rest &= rest - 1;
        const float xj = __shfl_sync(0xffffffffu, x, j);
        if (lead && it < size) {
          sum += xj;
          lo = nan_min(lo, xj);
          hi = nan_max(hi, xj);
        }
      }
      if (lead) {
        w.cnt[g] += size;
        w.sum[g] = sum;
        w.lo[g] = lo;
        w.hi[g] = hi;
      }
      __syncwarp();
    }
    const int64_t o = static_cast<int64_t>(v) * C;
    int done = 0;
#pragma unroll 4
    for (int s0 = 0; s0 < C; s0 += 32) {
      const int i = s0 + lane;
      const unsigned m = w.mask[s0 >> 5];
      const bool occ = (m >> lane) & 1;
      int cnt = 0, rep = 0;
      float sum = 0.0f, lo = INFINITY, hi = -INFINITY;
      if (occ) {
        const int e = done + __popc(m & lt);
        const int g = w.gid[e];
        cnt = w.cnt[g];
        rep = w.first[g] == e;
        sum = w.sum[g];
        lo = w.lo[g];
        hi = w.hi[g];
      }
      done += __popc(m);
      if (i < C) {
        if (v == 0) {
          s.rep[i] = rep;
          s.counts[i] = cnt;
        }
        s.sums[o + i] = sum;
        s.mins[o + i] = lo;
        s.maxs[o + i] = hi;
      }
    }
    __syncwarp();
  }
}

// The workspace of one warp for C slots and ks staged key planes, in
// ints.
__host__ __device__ __forceinline__ int64_t space_ints(int C, int ks) {
  return static_cast<int64_t>(8 + ks) * C + (C + 31) / 32 + table_size(C);
}

// One warp a block, the blocks taking buckets in turn.  `ks` key planes
// are staged; the workspace is in dynamic shared memory (kShared: the
// compiler then addresses it as shared, 4.5 % faster on the groupby
// leg's slabs than through generic pointers, by probe on an H100), or in
// `scratch`, one per block.
template <bool kShared>
__global__ void __launch_bounds__(32)
    hash_groupby_kernel(const int* __restrict__ kbits,
                        const int* __restrict__ occ,
                        const float* __restrict__ vals, int B, int K, int V,
                        int C, int ks, int* scratch, int* rep, int* counts,
                        float* sums, float* mins, float* maxs) {
  extern __shared__ int smem[];
  const int T = table_size(C);
  int* base = kShared ? smem : scratch + blockIdx.x * space_ints(C, ks);
  const Space w{base,
                base + C,
                base + 2 * C,
                reinterpret_cast<float*>(base + (2 + ks) * C),
                base + (3 + ks) * C,
                base + (4 + ks) * C,
                reinterpret_cast<float*>(base + (5 + ks) * C),
                reinterpret_cast<float*>(base + (6 + ks) * C),
                reinterpret_cast<float*>(base + (7 + ks) * C),
                reinterpret_cast<unsigned*>(base + (8 + ks) * C),
                base + (8 + ks) * C + (C + 31) / 32,
                T - 1};
  for (int64_t b = blockIdx.x; b < B; b += gridDim.x) {
    const Slab s{kbits + b * K * C, occ + b * C, vals + b * V * C,
                 rep + b * C,       counts + b * C,
                 sums + b * V * C,  mins + b * V * C, maxs + b * V * C};
    bucket_walk(w, s, K, V, C, ks);
  }
}

// The workspace of one warp in bytes for K key planes and C slots (ks of
// them staged), and the blocks that take the buckets in turn when the
// workspaces are in device memory: as many as kScratchBytes holds.
int64_t space_bytes(int K, int C) {
  return space_ints(C, K < kStaged ? K : kStaged) * 4;
}

int64_t scratch_blocks(int B, int64_t bytes) {
  const int64_t fit = kScratchBytes / bytes;
  return fit < 1 ? 1 : fit < B ? fit : B;
}

// The current device's opt-in shared memory a block.
cudaError_t optin_bytes(int* optin) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (!e)
    e = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  return e;
}

}  // namespace

// Bytes of device memory the workspaces of a (B, K, C) slab with V value
// columns need outside shared memory: 0 when one fits in a block's shared
// memory; -1 when the device cannot be queried.
extern "C" long long hash_groupby_workspace_bytes(int B, int K, int V,
                                                  int C) {
  if (B <= 0 || C <= 0 || V <= 0 || K <= 0) return 0;
  int optin = 0;
  if (optin_bytes(&optin)) return -1;
  const int64_t bytes = space_bytes(K, C);
  return bytes <= optin ? 0 : scratch_blocks(B, bytes) * bytes;
}

// kbits int32 (B, K, C), occ int32 (B, C), vals float32 (B, V, C) ->
// rep, counts int32 (B, C), sums, mins, maxs float32 (B, V, C).
// B, C, V, K > 0; `workspace` holds hash_groupby_workspace_bytes(B, K, V,
// C) bytes (4-byte aligned; unused, and may be null, when that is 0).
// Returns the launch's cudaError_t.
extern "C" int hash_groupby_accumulate(const int* kbits, const int* occ,
                                       const float* vals, int B, int K, int V,
                                       int C, void* workspace, int* rep,
                                       int* counts, float* sums, float* mins,
                                       float* maxs, void* stream) {
  if (B <= 0 || C <= 0 || V <= 0 || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int optin = 0;
  const cudaError_t e = optin_bytes(&optin);
  if (e) return static_cast<int>(e);
  // the workspace in shared memory where it fits, else in the caller's
  // device memory for as many blocks as kScratchBytes holds
  const int ks = K < kStaged ? K : kStaged;
  const int64_t bytes = space_bytes(K, C);
  const bool in_shared = bytes <= optin;
  int* scratch = static_cast<int*>(workspace);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!in_shared && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (in_shared && bytes > 48 * 1024) {
    const cudaError_t f = cudaFuncSetAttribute(
        hash_groupby_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (f) return static_cast<int>(f);
  }
  if (in_shared)
    hash_groupby_kernel<true><<<static_cast<unsigned>(B), 32,
                                static_cast<size_t>(bytes), st>>>(
        kbits, occ, vals, B, K, V, C, ks, nullptr, rep, counts, sums, mins,
        maxs);
  else
    hash_groupby_kernel<false>
        <<<static_cast<unsigned>(scratch_blocks(B, bytes)), 32, 0, st>>>(
        kbits, occ, vals, B, K, V, C, ks, scratch, rep, counts, sums, mins,
        maxs);
  return static_cast<int>(cudaGetLastError());
}

// Bucketed hash-accumulate groupby: per bucket, every slot's group
// representative flag, group size and per-value-column sum, min and max.
//
// Replaces the TPU kernel bucket_accumulate_buckets
// (src/repro/kernels/hash_groupby/kernel.py), which materialises each
// bucket's dense (C, C) key-equality matrix in vector registers and
// reduces it five ways.  Here one block takes one bucket.  Thread t owns
// slot i = i0 + t (i0 stepping by the block size) and keeps its first
// kRegKeys key planes in registers (further planes it reads from the
// L1-cached slab); the bucket's key planes, occupancy and up to kVals
// value rows are staged in shared memory `cj` slots at a time, and the
// thread walks them in increasing slot order j, keeping count, "no earlier
// equal slot", and sum, min and max per value column.  No (C, C) matrix
// exists, a slab of any width streams through shared memory, and the
// chunk narrows as K grows, so any number of key planes fits.  All lanes
// of a warp read the same staged slot, so the reads broadcast.
//
// min and max propagate NaN explicitly (fminf/fmaxf would drop it), as
// the reference's jnp.min/jnp.max do.  Sums add in slot order, so on
// integer-valued data they are exact.
//
// Work: the function needs each occupied slot compared with the occupied
// slots of its bucket, sum over buckets of occ_b^2 pairs, each K key
// compares, a count and 3 V value updates; it must read 4 * B * C *
// (K + 1 + V) B and write 4 * B * C * (2 + 3 V) B.  On the groupby leg's
// slabs (about a third full) the bytes bound it.  This kernel also walks
// the empty slots, B * C^2 pairs in all.
#include <math.h>

#include "tile_rank.cuh"

namespace {

constexpr int kRegKeys = 8;    // key planes held in registers
constexpr int kVals = 4;       // value columns per walk over the slab
constexpr int kChunk = 1024;   // most slab slots staged in shared memory

__device__ __forceinline__ float nan_min(float a, float x) {
  return (isnan(x) || x < a) ? x : a;
}

__device__ __forceinline__ float nan_max(float a, float x) {
  return (isnan(x) || x > a) ? x : a;
}

__global__ void __launch_bounds__(repro::kThreads)
    hash_groupby_kernel(const int* __restrict__ kbits,
                        const int* __restrict__ occ,
                        const float* __restrict__ vals, int K, int V, int C,
                        int cj, int* __restrict__ rep,
                        int* __restrict__ counts, float* __restrict__ sums,
                        float* __restrict__ mins, float* __restrict__ maxs) {
  extern __shared__ int smem[];
  int* skey = smem;                                     // [K][cj]
  int* socc = skey + K * cj;                            // [cj]
  float* sval = reinterpret_cast<float*>(socc + cj);    // [kVals][cj]

  const int64_t b = blockIdx.x;
  const int* kb = kbits + b * K * C;
  const int* ob = occ + b * C;
  const float* vb = vals + b * V * C;

  for (int v0 = 0; v0 < V; v0 += kVals) {
    const int nv = V - v0 < kVals ? V - v0 : kVals;
    for (int i0 = 0; i0 < C; i0 += blockDim.x) {
      const int i = i0 + threadIdx.x;
      const bool live = i < C && ob[i] > 0;
      int key[kRegKeys];
#pragma unroll
      for (int k = 0; k < kRegKeys; ++k)
        key[k] = (live && k < K) ? kb[k * C + i] : 0;
      int cnt = 0;
      bool first = true;
      float s[kVals], lo[kVals], hi[kVals];
#pragma unroll
      for (int v = 0; v < kVals; ++v) {
        s[v] = 0.0f;
        lo[v] = INFINITY;
        hi[v] = -INFINITY;
      }
      for (int j0 = 0; j0 < C; j0 += cj) {
        const int jn = C - j0 < cj ? C - j0 : cj;
        __syncthreads();
        for (int t = threadIdx.x; t < jn; t += blockDim.x) {
          for (int k = 0; k < K; ++k) skey[k * cj + t] = kb[k * C + j0 + t];
          socc[t] = ob[j0 + t];
          for (int v = 0; v < nv; ++v)
            sval[v * cj + t] = vb[(v0 + v) * C + j0 + t];
        }
        __syncthreads();
        if (!live) continue;
        for (int jj = 0; jj < jn; ++jj) {
          bool eq = socc[jj] > 0;
#pragma unroll
          for (int k = 0; k < kRegKeys; ++k)
            if (k < K) eq = eq && skey[k * cj + jj] == key[k];
          for (int k = kRegKeys; eq && k < K; ++k)
            eq = skey[k * cj + jj] == __ldg(kb + k * C + i);
          if (!eq) continue;
          ++cnt;
          if (j0 + jj < i) first = false;
#pragma unroll
          for (int v = 0; v < kVals; ++v) {
            if (v < nv) {
              const float x = sval[v * cj + jj];
              s[v] += x;
              lo[v] = nan_min(lo[v], x);
              hi[v] = nan_max(hi[v], x);
            }
          }
        }
      }
      if (i < C) {
        if (v0 == 0) {
          counts[b * C + i] = cnt;
          rep[b * C + i] = live && first ? 1 : 0;
        }
#pragma unroll
        for (int v = 0; v < kVals; ++v) {
          if (v < nv) {
            const int64_t o = (b * V + v0 + v) * C + i;
            sums[o] = s[v];
            mins[o] = lo[v];
            maxs[o] = hi[v];
          }
        }
      }
    }
  }
}

}  // namespace

// kbits int32 (B, K, C), occ int32 (B, C), vals float32 (B, V, C) ->
// rep, counts int32 (B, C), sums, mins, maxs float32 (B, V, C).
// B, C, V, K > 0.  Returns the launch's cudaError_t.
extern "C" int hash_groupby_accumulate(const int* kbits, const int* occ,
                                       const float* vals, int B, int K, int V,
                                       int C, int* rep, int* counts,
                                       float* sums, float* mins, float* maxs,
                                       void* stream) {
  if (B <= 0 || C <= 0 || V <= 0 || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // staged slots: at most kChunk, fewer when many key planes fill the
  // shared memory a block may opt in to
  int cj = 0;
  size_t smem = 0;
  const int e = repro::prepare_chunk(hash_groupby_kernel, K + 1 + kVals, C,
                                     kChunk, &cj, &smem);
  if (e) return e;
  hash_groupby_kernel<<<static_cast<unsigned>(B), repro::kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      kbits, occ, vals, K, V, C, cj, rep, counts, sums, mins, maxs);
  return static_cast<int>(cudaGetLastError());
}

// Mamba-1 selective scan: y and, when asked, the final state.
//
// Replaces the TPU kernel selective_scan_pallas
// (src/repro/kernels/mamba_scan/kernel.py), whose grid walks time chunks
// of 256 steps in order and carries the state h (256 channels x N) from
// one grid step to the next in VMEM scratch, with 256 x 256 slabs of x
// and delta in VMEM.  Hopper blocks run in no order and a block holds a
// few tens of KB of shared memory, so here one block owns a tile of
// channels of one sequence and walks all of its time steps itself, the
// state in registers the whole way:
//
// * R = min(N, kR) states per thread, L = N / R lanes per channel (at
//   N 16: eight lanes of two states).  A thread keeps its h[e, n0:n0+R]
//   and A[e, n0:n0+R] in registers and reads B_t and C_t as one R-wide
//   vector from shared memory.  R is a trade: at the prefill's batch of
//   one, E * N / R threads are all the parallelism there is, and R = 2
//   (16 warps an SM) ran 0.1103 ms at the prefill shape against 0.1263
//   with R = 4, 0.1424 with R = 1 and 0.1546 with R = 8; at batch 4,
//   R = 8 ran 0.4326 ms against R = 2's 0.4553 (H100 80GB HBM3 at
//   700 W, tools/probe_variants.py, one call of 3 rounds, 64-step
//   chunks).
// * A tile of kChan >= 32 channels per block (32 at N 8 to 32, 64 at
//   N 4, 128 below): a staged time row is at least 128 B of delta, 64 B
//   of bf16 x, and y leaves in rows as wide.
// * Time is staged kChunk steps (64; 32 for the wider tiles) at a time
//   through a ring of kStages buffers filled by cp.async (16-byte
//   pieces, zero-filled past S and E), so chunks k + 1 and k + 2 load
//   while chunk k runs its steps; one __syncthreads per chunk.  y goes
//   through a second, two-slot ring and leaves one chunk late, row by
//   row.
// * The L lanes of a channel hold h * C for L consecutive steps and
//   reduce them with one reduce-scatter (L - 1 shuffles for L steps in
//   place of log2 L for each): afterwards lane l holds step l's sum and
//   writes that step's y.
// * expf, not __expf or exp2f: the accurate exponential keeps the kernel
//   within 2e-4 of the plain version, as the TPU kernel is held to its
//   reference, and the serving engine's states within their tolerance;
//   exp2f of a pre-scaled A was only 3 % faster by probe.
// * hT[b, e, n] is written at the end when hT is not null (prefill needs
//   the final state; the TPU kernel wrote none).
//
// Bound: operations.  At the prefill shape (1, 952, 8192, N 16) the scan
// takes 125 M exponentials, 30 us at the special-function units' 16 per
// SM per clock, against 95 MB in and out, 28 us at 3.35 TB/s; about 15
// issued instructions per exponential (the accurate expf is 8 of them)
// put the issue rate near 70 us.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {

constexpr int kR = 2;        // states per thread (fewer when N is smaller)
constexpr int kStages = 3;   // ring buffers of x, delta, B and C

template <int N, typename T>
struct Tile {
  static constexpr int R = N < kR ? N : kR;
  static constexpr int L = N / R;                      // lanes a channel
  static constexpr int kThreads = 32 * L > 128 ? 32 * L : 128;
  static constexpr int kChan = kThreads / L;           // channels a block
  // time steps a ring buffer: 64, or 32 where wider tiles would not fit
  static constexpr int kChunk = kChan <= 32 ? 64 : 32;
  // bytes of one ring buffer: x and delta rows of the tile, B and C rows
  static constexpr int kXBytes = kChunk * kChan * int(sizeof(T));
  static constexpr int kDBytes = kChunk * kChan * 4;
  static constexpr int kBBytes = kChunk * N * 4;
  static constexpr int kStageBytes = kXBytes + kDBytes + 2 * kBBytes;
  static constexpr int kYBytes = kChunk * kChan * 4;
  static constexpr int kSmem = kStages * kStageBytes + 2 * kYBytes;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_y(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_y(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// cp.async of kBytes (4 or 16) from global to shared, zero-filled when
// `valid` is false (nothing is read then).
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? kBytes : 0;
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// R consecutive floats of shared memory, as one vector load where R
// allows.
template <int R>
__device__ __forceinline__ void load_r(const float* p, float (&v)[R]) {
  if constexpr (R == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (R == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = p[r];
  }
}

// The L lanes of a channel (consecutive lanes, l = lane % L) each hold
// p[j], their partial sum for step j of L steps; afterwards lane l's p[0]
// is the sum over the L lanes for step l.
// (One level per template instance, M = L / 2, L / 4, ..., 1, so every
// index is a constant and p stays in registers.)
template <int M, int L>
__device__ __forceinline__ float reduce_scatter(float (&p)[L], int l) {
  if constexpr (M >= 1) {
    const bool up = l & M;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float send = up ? p[i] : p[i + M];
      const float keep = up ? p[i + M] : p[i];
      p[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
    }
    return reduce_scatter<M / 2, L>(p, l);
  }
  return p[0];
}

// Stage time steps [t0, t0 + kChunk) of the block's channel tile and B,
// C rows into one ring buffer.  Rows past S and channels past E read as
// zeros.  `vec`: x and delta rows in 16-byte pieces (E a multiple of 8,
// x and delta 16-byte aligned), else element by element without
// cp.async; `bc_vec`: B and C in 16-byte pieces (N a multiple of 4,
// aligned), else 4 bytes at a time.
template <int N, typename T>
__device__ __forceinline__ void load_chunk(
    unsigned char* buf, const T* __restrict__ x,
    const float* __restrict__ delta, const float* __restrict__ Bm,
    const float* __restrict__ Cm, size_t row0, int t0, int S, int E, int e0,
    bool vec, bool bc_vec) {
  using Sh = Tile<N, T>;
  constexpr int kChan = Sh::kChan, kChunk = Sh::kChunk;
  T* xs = reinterpret_cast<T*>(buf);
  float* ds = reinterpret_cast<float*>(buf + Sh::kXBytes);
  float* bs = reinterpret_cast<float*>(buf + Sh::kXBytes + Sh::kDBytes);
  float* cs = bs + kChunk * N;
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int kXV = 16 / static_cast<int>(sizeof(T));   // x per piece
    constexpr int kXP = kChan / kXV, kDP = kChan / 4;        // pieces a row
    for (int i = tid; i < kChunk * kXP; i += Sh::kThreads) {
      const int t = i / kXP, e = e0 + (i % kXP) * kXV;
      const bool ok = t0 + t < S && e < E;
      cp_async<16>(xs + t * kChan + (i % kXP) * kXV,
                   ok ? x + (row0 + t0 + t) * E + e : x, ok);
    }
    for (int i = tid; i < kChunk * kDP; i += Sh::kThreads) {
      const int t = i / kDP, e = e0 + (i % kDP) * 4;
      const bool ok = t0 + t < S && e < E;
      cp_async<16>(ds + t * kChan + (i % kDP) * 4,
                   ok ? delta + (row0 + t0 + t) * E + e : delta, ok);
    }
  } else {
    for (int i = tid; i < kChunk * kChan; i += Sh::kThreads) {
      const int t = i / kChan, e = e0 + i % kChan;
      const bool ok = t0 + t < S && e < E;
      const size_t g = (row0 + t0 + t) * E + e;
      xs[i] = ok ? x[g] : T(0.f);
      ds[i] = ok ? delta[g] : 0.f;
    }
  }
  const size_t b0 = (row0 + t0) * N;
  const int rows = min(kChunk, S - t0);
  if (bc_vec) {
    for (int i = tid; i < kChunk * N / 4; i += Sh::kThreads) {
      const bool ok = i * 4 < rows * N;
      cp_async<16>(bs + i * 4, ok ? Bm + b0 + i * 4 : Bm, ok);
      cp_async<16>(cs + i * 4, ok ? Cm + b0 + i * 4 : Cm, ok);
    }
  } else {
    for (int i = tid; i < kChunk * N; i += Sh::kThreads) {
      const bool ok = i < rows * N;
      cp_async<4>(bs + i, ok ? Bm + b0 + i : Bm, ok);
      cp_async<4>(cs + i, ok ? Cm + b0 + i : Cm, ok);
    }
  }
}

// L steps g0 .. g0 + L - 1 of one chunk; with kGuard the steps at or past
// `len` leave the state as it is (the chunk's ragged end).
template <int N, typename T, bool kGuard>
__device__ __forceinline__ void steps(
    const T* xs, const float* ds, const float* bs, const float* cs,
    float* ys, int g0, int len, int c, int l, const float (&a)[Tile<N, T>::R],
    float (&h)[Tile<N, T>::R], float dd) {
  using Sh = Tile<N, T>;
  constexpr int R = Sh::R, L = Sh::L, kChan = Sh::kChan;
  float p[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int t = g0 + j;
    const float dv = ds[t * kChan + c];
    const float dx = dv * to_f(xs[t * kChan + c]);
    float bv[R], cv[R];
    load_r<R>(bs + t * N + l * R, bv);
    load_r<R>(cs + t * N + l * R, cv);
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float hn = expf(dv * a[r]) * h[r] + dx * bv[r];
      h[r] = (!kGuard || t < len) ? hn : h[r];
      acc = fmaf(h[r], cv[r], acc);
    }
    p[j] = acc;
  }
  const float sum = reduce_scatter<L / 2, L>(p, l);
  const int t = g0 + l;
  if (!kGuard || t < len)
    ys[t * kChan + c] = sum + dd * to_f(xs[t * kChan + c]);
}

// x, y (Bsz, S, E) of type T; delta (Bsz, S, E), A (E, N), Bm, Cm
// (Bsz, S, N), D (E,) and hT (Bsz, E, N) float32.  Grid (ceil(E / kChan),
// Bsz), Tile::kThreads threads, Tile::kSmem bytes of dynamic shared
// memory.
template <int N, typename T>
__global__ void __launch_bounds__(Tile<N, T>::kThreads)
    mamba_scan_kernel(const T* __restrict__ x, const float* __restrict__ delta,
                      const float* __restrict__ A,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ D, T* __restrict__ y,
                      float* __restrict__ hT, int S, int E, bool vec,
                      bool bc_vec) {
  using Sh = Tile<N, T>;
  constexpr int R = Sh::R, L = Sh::L, kChan = Sh::kChan;
  constexpr int kChunk = Sh::kChunk;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ybuf = reinterpret_cast<float*>(smem + kStages * Sh::kStageBytes);

  const int b = blockIdx.y;
  const int e0 = blockIdx.x * kChan;
  const int c = threadIdx.x / L;
  const int l = threadIdx.x % L;
  const int e = e0 + c;
  // lanes past E run the steps on zeros (their state stays 0), so every
  // lane of a warp reaches the shuffles
  const bool live = e < E;
  float a[R], h[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    a[r] = live ? A[static_cast<size_t>(e) * N + l * R + r] : 0.f;
    h[r] = 0.f;
  }
  const float dd = live ? D[e] : 0.f;
  const size_t row0 = static_cast<size_t>(b) * S;
  const int chunks = (S + kChunk - 1) / kChunk;

  auto stage = [&](int k) { return smem + (k % kStages) * Sh::kStageBytes; };
  auto flush = [&](int k) {            // chunk k's y rows, from its slot
    const float* ys = ybuf + (k & 1) * kChunk * kChan;
    const int t0 = k * kChunk, len = min(kChunk, S - t0);
    for (int i = threadIdx.x; i < len * kChan; i += Sh::kThreads) {
      const int t = i / kChan, cc = i % kChan;
      if (e0 + cc < E) store_y(y + (row0 + t0 + t) * E + e0 + cc, ys[i]);
    }
  };

  load_chunk<N, T>(stage(0), x, delta, Bm, Cm, row0, 0, S, E, e0, vec,
                   bc_vec);
  cp_async_commit();
  if (chunks > 1)
    load_chunk<N, T>(stage(1), x, delta, Bm, Cm, row0, kChunk, S, E, e0,
                     vec, bc_vec);
  cp_async_commit();
  for (int k = 0; k < chunks; ++k) {
    // chunk k has landed for every thread; every thread is done with
    // chunk k - 1's buffer and has written its y, and has flushed chunk
    // k - 2's y from the slot chunk k writes
    cp_async_wait_one();
    __syncthreads();
    if (k + 2 < chunks)
      load_chunk<N, T>(stage(k + 2), x, delta, Bm, Cm, row0,
                       (k + 2) * kChunk, S, E, e0, vec, bc_vec);
    cp_async_commit();
    if (k > 0) flush(k - 1);

    const unsigned char* buf = stage(k);
    const T* xs = reinterpret_cast<const T*>(buf);
    const float* ds = reinterpret_cast<const float*>(buf + Sh::kXBytes);
    const float* bs =
        reinterpret_cast<const float*>(buf + Sh::kXBytes + Sh::kDBytes);
    const float* cs = bs + kChunk * N;
    float* ys = ybuf + (k & 1) * kChunk * kChan;
    const int len = min(kChunk, S - k * kChunk);
    const int full = len - len % L;
#pragma unroll 1
    for (int g0 = 0; g0 < full; g0 += L)
      steps<N, T, false>(xs, ds, bs, cs, ys, g0, len, c, l, a, h, dd);
    if (full < len)
      steps<N, T, true>(xs, ds, bs, cs, ys, full, len, c, l, a, h, dd);
  }
  __syncthreads();
  flush(chunks - 1);
  if (hT != nullptr && live) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      hT[(static_cast<size_t>(b) * E + e) * N + l * R + r] = h[r];
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int N, typename T>
int launch(const void* x, const void* delta, const void* A, const void* Bm,
           const void* Cm, const void* D, void* y, void* hT, int Bsz, int S,
           int E, cudaStream_t stream) {
  using Sh = Tile<N, T>;
  auto kernel = mamba_scan_kernel<N, T>;
  if (Sh::kSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kSmem);
    if (e) return static_cast<int>(e);
  }
  const bool vec = E % 8 == 0 && aligned16(x) && aligned16(delta);
  const bool bc_vec = N % 4 == 0 && aligned16(Bm) && aligned16(Cm);
  const dim3 grid((E + Sh::kChan - 1) / Sh::kChan, Bsz);
  kernel<<<grid, Sh::kThreads, Sh::kSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(delta),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(D),
      static_cast<T*>(y), static_cast<float*>(hT), S, E, vec, bc_vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int N, const void* x, const void* delta, const void* A,
             const void* Bm, const void* Cm, const void* D, void* y, void* hT,
             int Bsz, int S, int E, cudaStream_t s) {
  switch (N) {
    case 1:
      return launch<1, T>(x, delta, A, Bm, Cm, D, y, hT, Bsz, S, E, s);
    case 2:
      return launch<2, T>(x, delta, A, Bm, Cm, D, y, hT, Bsz, S, E, s);
    case 4:
      return launch<4, T>(x, delta, A, Bm, Cm, D, y, hT, Bsz, S, E, s);
    case 8:
      return launch<8, T>(x, delta, A, Bm, Cm, D, y, hT, Bsz, S, E, s);
    case 16:
      return launch<16, T>(x, delta, A, Bm, Cm, D, y, hT, Bsz, S, E, s);
    case 32:
      return launch<32, T>(x, delta, A, Bm, Cm, D, y, hT, Bsz, S, E, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (Bsz, S, E) float32 (x_bf16 = 0) or bf16 (x_bf16 = 1); delta
// (Bsz, S, E), A (E, N), Bm, Cm (Bsz, S, N) and D (E,) float32, all
// contiguous -> y (Bsz, S, E) in x's type and, when hT is not null,
// hT (Bsz, E, N) float32; the state starts at 0.  N a power of two <= 32,
// 0 < Bsz <= 65535, S > 0, E > 0.  Returns the launch's cudaError_t.
extern "C" int mamba_scan_fwd(const void* x, const void* delta, const void* A,
                              const void* Bm, const void* Cm, const void* D,
                              void* y, void* hT, int Bsz, int S, int E, int N,
                              int x_bf16, void* stream) {
  if (Bsz <= 0 || Bsz > 65535 || S <= 0 || E <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return dispatch<__nv_bfloat16>(N, x, delta, A, Bm, Cm, D, y, hT, Bsz, S,
                                   E, s);
  return dispatch<float>(N, x, delta, A, Bm, Cm, D, y, hT, Bsz, S, E, s);
}

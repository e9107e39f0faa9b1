// Mamba-1 selective scan: y and, when asked, the final state.
//
// Replaces the TPU kernel selective_scan_pallas
// (src/repro/kernels/mamba_scan/kernel.py), whose grid walks time chunks
// of 256 steps in order and carries the state h (256 channels x N) from
// one grid step to the next in VMEM scratch, with 256 x 256 slabs of x
// and delta in VMEM.  Hopper blocks run in no order and a block holds a
// few tens of KB of shared memory, so here one block owns a few channels
// of one sequence and walks all of its time steps itself:
//
// * One thread per (batch, channel, state) triple: N lanes per channel,
//   kThreads / N channels per 128-thread block.  Each thread keeps its
//   h[e, n] and A[e, n] in registers for the whole walk, so the state
//   never leaves the SM; at the serving path's prefill (Bsz 1, E 8192,
//   N 16) that is 1 024 blocks, every SM busy.
// * Per chunk of kChunk steps (64 for N >= 4) the block stages x and delta of its
//   channels and B_t and C_t into shared memory, then runs the chunk's
//   steps: h = expf(delta * A) * h + (delta * x) * B_t[n].  The product
//   h * C_t[n] is summed over the N lanes of a channel by __shfl_xor_sync
//   and lane 0 keeps y = sum + D[e] * x in shared memory; the chunk's y
//   is written out at its end, neighbouring threads on neighbouring
//   channels.
// * expf, not __expf: the accurate exponential keeps the kernel within
//   2e-4 of the plain version, as the TPU kernel is held to its
//   reference.
// * At the end every lane writes its hT[b, e, n] when hT is not null
//   (prefill needs the final state; the TPU kernel wrote none).
//
// Bound: operations.  At the prefill shape (1, 1024, 8192, N 16) the scan
// takes 134 M exponentials, 32 us at the special-function units' 16 per
// SM per clock, against 102 MB in and out, 30 us at 3.35 TB/s.  This
// first version runs one exponential and a four-step shuffle reduction
// per (t, e, n) and overlaps no load with the steps: splitting the N
// lanes' work across fewer threads and a pipelined load are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float load_x(const float* p) { return *p; }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_y(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_y(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// x, y (Bsz, S, E) of type T; delta (Bsz, S, E), A (E, N), Bm, Cm
// (Bsz, S, N), D (E,) and hT (Bsz, E, N) float32.  Grid (ceil(E / kChan),
// Bsz).
template <int N, typename T>
__global__ void __launch_bounds__(kThreads)
    mamba_scan_kernel(const T* __restrict__ x, const float* __restrict__ delta,
                      const float* __restrict__ A,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ D, T* __restrict__ y,
                      float* __restrict__ hT, int S, int E) {
  constexpr int kChan = kThreads / N;
  // time steps staged per shared-memory round: 14 KB at N 16, and under
  // the 48 KB of static shared memory for every N
  constexpr int kChunk = N >= 4 ? 64 : 16;
  __shared__ float xs[kChunk][kChan];
  __shared__ float ds[kChunk][kChan];
  __shared__ float ys[kChunk][kChan];
  __shared__ float bs[kChunk][N];
  __shared__ float cs[kChunk][N];

  const int b = blockIdx.y;
  const int e0 = blockIdx.x * kChan;
  const int c = threadIdx.x / N;
  const int n = threadIdx.x % N;
  const int e = e0 + c;
  // lanes past E run the steps on zeros (their state stays 0), so every
  // lane of a warp reaches the shuffles
  const bool live = e < E;
  const float a = live ? A[static_cast<size_t>(e) * N + n] : 0.f;
  const float dd = live ? D[e] : 0.f;
  const size_t row0 = static_cast<size_t>(b) * S;
  float h = 0.f;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int len = min(kChunk, S - t0);
    for (int i = threadIdx.x; i < kChunk * kChan; i += kThreads) {
      const int t = i / kChan, cc = i % kChan;
      float xv = 0.f, dv = 0.f;
      if (t < len && e0 + cc < E) {
        const size_t g = (row0 + t0 + t) * E + e0 + cc;
        xv = load_x(x + g);
        dv = delta[g];
      }
      xs[t][cc] = xv;
      ds[t][cc] = dv;
    }
    for (int i = threadIdx.x; i < kChunk * N; i += kThreads) {
      const int t = i / N, nn = i % N;
      float bv = 0.f, cv = 0.f;
      if (t < len) {
        const size_t g = (row0 + t0 + t) * N + nn;
        bv = Bm[g];
        cv = Cm[g];
      }
      bs[t][nn] = bv;
      cs[t][nn] = cv;
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < len; ++t) {
      const float dv = ds[t][c], xv = xs[t][c];
      h = expf(dv * a) * h + (dv * xv) * bs[t][n];
      float p = h * cs[t][n];
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (n == 0) ys[t][c] = p + dd * xv;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < len * kChan; i += kThreads) {
      const int t = i / kChan, cc = i % kChan;
      if (e0 + cc < E) store_y(y + (row0 + t0 + t) * E + e0 + cc, ys[t][cc]);
    }
  }
  if (hT != nullptr && live)
    hT[(static_cast<size_t>(b) * E + e) * N + n] = h;
}

template <int N, typename T>
int launch(const void* x, const void* delta, const void* A, const void* Bm,
           const void* Cm, const void* D, void* y, void* hT, int Bsz, int S,
           int E, cudaStream_t stream) {
  constexpr int kChan = kThreads / N;
  const dim3 grid((E + kChan - 1) / kChan, Bsz);
  mamba_scan_kernel<N, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(delta),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(D),
      static_cast<T*>(y), static_cast<float*>(hT), S, E);
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

// Fused attention forward: online softmax over key tiles on the tensor
// cores.
//
// Replaces the TPU kernel flash_attention_fwd
// (src/repro/kernels/flash_attention/kernel.py), whose grid walks the key
// blocks of one query block in order and keeps the running max m, the
// normalizer l and the accumulator in VMEM scratch between grid steps.
// Here a block of 4 warps owns 64 query rows of one (batch, query head)
// and loops over the key tiles itself, 64 keys at a time, so m, l and the
// accumulator stay in registers for the whole walk:
//
// * Query head h reads KV head h / (Hq / Hkv) (grouped-query attention);
//   each K and V tile is staged in shared memory as bf16 (rows padded by
//   8 values so the fragment loads hit distinct banks).
// * S = Q K^T with mma.sync.m16n8k16 (bf16 in, float32 out), each warp on
//   its own 16 query rows; the scale is applied in float32 after the
//   product, folded with log2(e) so the softmax runs on exp2.
// * Masked scores are -1e30, as in the TPU kernel: the causal mask is
//   right-aligned (query row i sees keys <= i + Skv - Sq) and keys past
//   Skv are masked too, so ragged Sq and Skv need no padding.  With the
//   causal mask the walk stops after the last tile that holds a live key
//   for the block, the TPU kernel's skip of fully masked blocks.
// * The running max and normalizer are float32, reduced over the 4 lanes
//   that hold a row by shuffles; P goes to bf16 for the P V product and
//   the accumulator stays float32.  The output is acc / max(l, 1e-30) in
//   bf16; rows past Sq are not written.
//
// Bound: operations.  At the serving path's prefill shape (B 1, Hq 32,
// Sq = Skv = 1024, D 64, causal) the two products need about 4.3 GFLOP,
// 4.4 us at the card's 989 TFLOP/s in bf16, against about 10.5 MB in and
// out, 3.1 us at 3.35 TB/s.  This first version overlaps no copy with the
// products and uses mma.sync, not the warpgroup wgmma: TMA loads, wgmma
// and warp specialisation are a later change's work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = kWarps * 16;  // query rows per block
constexpr int kBlockK = 64;           // keys per tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// c += a b for one m16n8k16 tile: a row-major 16 x 16 bf16 (4 registers),
// b column-major 16 x 8 bf16 (2 registers), c 16 x 8 float32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// Lane l of a warp holds, in every m16n8 fragment, rows g = l / 4 and
// g + 8 and columns 2 t, 2 t + 1 with t = l % 4 (PTX ISA, mma.m16n8k16).
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const uint16_t* __restrict__ q,
                           const uint16_t* __restrict__ k,
                           const uint16_t* __restrict__ v,
                           uint16_t* __restrict__ o, int Hq, int Hkv, int Sq,
                           int Skv, int causal, float scale_log2) {
  constexpr int kStride = D + 8;   // shared row, in bf16 values
  constexpr int kSteps = D / 16;   // k-steps of Q K^T
  constexpr int kOutTiles = D / 8; // n-tiles of P V
  constexpr int kVecs = D / 8;     // 16-byte vectors per row
  __shared__ __align__(16) uint16_t ks[kBlockK * kStride];
  __shared__ __align__(16) uint16_t vs[kBlockK * kStride];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * kBlockQ;
  const int off = Skv - Sq;            // right-aligned causal offset
  const int row0 = q0 + warp * 16 + g; // this lane's rows: row0, row0 + 8

  const uint16_t* qh = q + (static_cast<size_t>(b) * Hq + h) * Sq * D;
  const uint16_t* kh = k + (static_cast<size_t>(b) * Hkv + hk) * Skv * D;
  const uint16_t* vh = v + (static_cast<size_t>(b) * Hkv + hk) * Skv * D;

  // this warp's 16 query rows as A fragments, zeros past Sq
  uint32_t qa[kSteps][4];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const uint16_t* src = qh + static_cast<size_t>(row) * D + s * 16 + 2 * t;
      const bool live = row < Sq;
      qa[s][r] = live ? *reinterpret_cast<const uint32_t*>(src) : 0u;
      qa[s][r + 2] = live ? *reinterpret_cast<const uint32_t*>(src + 8) : 0u;
    }
  }

  float acc[kOutTiles][4];
#pragma unroll
  for (int d = 0; d < kOutTiles; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  int n_tiles = (Skv + kBlockK - 1) / kBlockK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBlockQ - 1 + off) / kBlockK + 1);

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int kv0 = tile * kBlockK;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < kBlockK * kVecs; i += kThreads) {
      const int r = i / kVecs, c = (i % kVecs) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (kv0 + r < Skv) {
        const size_t at = static_cast<size_t>(kv0 + r) * D + c;
        kv = *reinterpret_cast<const uint4*>(kh + at);
        vv = *reinterpret_cast<const uint4*>(vh + at);
      }
      *reinterpret_cast<uint4*>(ks + r * kStride + c) = kv;
      *reinterpret_cast<uint4*>(vs + r * kStride + c) = vv;
    }
    __syncthreads();

    // scores of 16 rows x 64 keys: n-tile j holds keys kv0 + 8 j ..
    float s[kBlockK / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        const uint16_t* kr = ks + (j * 8 + g) * kStride + st * 16 + 2 * t;
        mma_bf16(s[j], qa[st], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // scale, mask, new running max
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = kv0 + j * 8 + 2 * t + (e & 1);
        const bool dead = col >= Skv || (causal && col > row0 + 8 * r + off);
        const float x = dead ? kNegInf : s[j][e] * scale_log2;
        s[j][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int d = 0; d < kOutTiles; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d][e] *= alpha[e >> 1];

    // acc += P V: the score fragments of n-tiles 2 kk and 2 kk + 1 are the
    // A fragment of keys kk * 16 .. kk * 16 + 15
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int d = 0; d < kOutTiles; ++d) {
        const uint16_t* vc = vs + (kk * 16 + 2 * t) * kStride + d * 8 + g;
        const uint32_t b0 = vc[0] | (static_cast<uint32_t>(vc[kStride]) << 16);
        const uint32_t b1 =
            vc[8 * kStride] | (static_cast<uint32_t>(vc[9 * kStride]) << 16);
        mma_bf16(acc[d], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    uint16_t* dst = o + (static_cast<size_t>(b) * Hq + h) * Sq * D +
                    static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
    for (int d = 0; d < kOutTiles; ++d)
      *reinterpret_cast<uint32_t*>(dst + d * 8) =
          pack_bf16(acc[d][2 * r] / denom, acc[d][2 * r + 1] / denom);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Hq,
           int Hkv, int Sq, int Skv, int causal, float scale_log2,
           cudaStream_t stream) {
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, Hq, B);
  flash_attention_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o), Hq, Hkv, Sq,
      Skv, causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q bf16 (B, Hq, Sq, D), k and v bf16 (B, Hkv, Skv, D), all contiguous ->
// o bf16 (B, Hq, Sq, D).  Hq % Hkv == 0, D in {16, 32, 64, 128}, B, Hq,
// Sq, Skv > 0 and, with causal, Sq <= Skv.  Returns the launch's
// cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int Hq, int Hkv, int Sq,
                                   int Skv, int D, int causal, float scale,
                                   void* stream) {
  if (B <= 0 || B > 65535 || Hq <= 0 || Hq > 65535 || Hkv <= 0 ||
      Hq % Hkv != 0 || Sq <= 0 || Skv <= 0 || (causal && Sq > Skv))
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = scale * kLog2e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, scale_log2, s);
    case 32:
      return launch<32>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, scale_log2, s);
    case 64:
      return launch<64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, scale_log2, s);
    case 128:
      return launch<128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, scale_log2,
                         s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

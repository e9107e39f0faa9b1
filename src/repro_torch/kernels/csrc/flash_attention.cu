// Fused attention forward on Hopper's warpgroup tensor cores, fed by TMA.
//
// Replaces the TPU kernel flash_attention_fwd
// (src/repro/kernels/flash_attention/kernel.py), whose grid walks the key
// blocks of one query block in order and keeps the running max m, the
// normalizer l and the accumulator in VMEM scratch between grid steps.
// Here a block owns 64 query rows of one (batch, query head) and walks the
// key tiles itself, 64 keys at a time, so m, l and the accumulator stay in
// registers for the whole walk.  The block is warp-specialised:
//
// * One producer warp (warp 4; one lane issues) loads the Q tile once and
//   keeps a ring of 3 K and V tiles (2 at D = 128) in flight with TMA
//   (cp.async.bulk.tensor), each stage completing on its own mbarrier; the
//   consumers free a stage through a second mbarrier.  Query head h reads
//   KV head h / (Hq / Hkv) (grouped-query attention).  The tensor maps see
//   q, k and v as (B * H, S, D) with boxes of 64 rows by 64 columns in the
//   128-byte swizzle; rows past S and columns past D (D of 16 or 32) arrive
//   as zeros, so ragged Sq and Skv and the small head dims need no
//   padding.  D = 128 is two 64-column panels.
// * One consumer warpgroup (warps 0-3) runs wgmma m64n64k16, bf16 in and
//   float32 out: S = Q K^T with both operands in shared memory (K-major),
//   then O += P V with P as the register A operand and V from shared
//   memory through the descriptor's transpose (MN-major), one panel of 64
//   output columns at a time.  The product S of the next tile is issued
//   before P V of this one, so the next tile's softmax runs while P V is
//   on the tensor cores.  (Two consumer warpgroups per block, sharing the
//   K and V tiles, measured slower: fewer blocks fit an SM.)
// * Masked scores are -1e30, as in the TPU kernel: the causal mask is
//   right-aligned (query row i sees keys <= i + Skv - Sq) and keys past Skv
//   are masked too; only tiles that cross the diagonal or the end of Skv
//   pay for the mask.  A causal block walks only the tiles up to its
//   diagonal, and blocks are numbered so that the longest query tiles
//   launch first and the short ones fill the tail.
// * The running max and normalizer are float32, reduced over the 4 lanes
//   that hold a row by shuffles; the scale, folded with log2(e), is applied
//   in float32 inside the exponent's fused multiply-add (the max is taken
//   on unscaled scores), so the softmax runs on the special-function
//   unit's exp2; P goes to bf16 for P V and the accumulator stays float32.
//   The output is acc / max(l, 1e-30) in bf16; rows past Sq are not
//   written.
//
// Bound: operations.  At the serving path's prefill shape (B 1, Hq 32,
// Sq = Skv = 1024, D 64, causal) the two products need about 4.3 GFLOP,
// 4.4 us at the card's 989 TFLOP/s in bf16, against about 10.5 MB in and
// out, 3.1 us at 3.35 TB/s.  The design keeps the tensor cores fed by
// overlapping each tile's loads with the products of the tiles before it
// and the softmax with the P V product; 3 blocks share an SM at D <= 64
// (2 at D = 128), the registers' limit.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {

constexpr int kBlockM = 64;            // query rows per block
constexpr int kBlockN = 64;            // keys per tile
constexpr int kConsumers = 128;        // one warpgroup
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kPanel = 64 * 128;       // bytes of 64 rows x 64 bf16 columns
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int DP>
struct Config {
  static constexpr int kPanels = DP / 64;
  static constexpr int kTileBytes = kPanels * kPanel;   // Q, K or V tile
  // 3 blocks fit an SM at D <= 64; at D = 128 a third stage would leave
  // room for one
  static constexpr int kStages = DP == 64 ? 3 : 2;
  // Q, then K and V per stage, then the barriers; 1024-byte aligned tiles
  static constexpr int kBarOffset = (1 + 2 * kStages) * kTileBytes;
  static constexpr int kSmem = 1024 + kBarOffset + (1 + 2 * kStages) * 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One 64 x 64 box of a (B * H, S, D) tensor map into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row), "r"(head)
      : "memory");
}

// --- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor of a tile in the 128-byte swizzle (TMA's
// CU_TENSOR_MAP_SWIZZLE_128B): 8-row groups 1024 bytes apart.  Both byte
// offsets are 1024: the one the layout does not use is ignored, and every
// operand here is one 64-column panel wide, so none needs a second panel
// offset.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t kOffset = 1024 >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (kOffset << 16) |
         (kOffset << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of products are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define REPRO_D32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define REPRO_D32_OUT(d)                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (+)= A B, m64n64k16: A (64 x 16) and B (16 x 64) both K-major in
// shared memory; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : REPRO_D32_OUT(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, m64n64k16: A (64 x 16) in registers (the mma.m16n8k16 A
// fragment of each warp's 16 rows), B (16 x 64) MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : REPRO_D32_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// 2^x by the special-function unit, results below 2^-126 flushed to zero
// (a probability that small does not reach a bf16 P).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two floats as a bf16 pair, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// Accumulator layout of wgmma m64nN (PTX ISA): thread (warp w of the
// warpgroup, lane l) holds, for each 8-column n-tile j, registers 4 j ..
// 4 j + 3 = rows 16 w + g, 16 w + g, 16 w + g + 8, 16 w + g + 8 and
// columns 8 j + 2 t, + 1, 8 j + 2 t, + 1, with g = l / 4 and t = l % 4.

// Scale and mask a tile's raw scores (masked: kNegInf, so a row that sees
// no key of the tile keeps its max) and fold them into the running max m
// (log2 domain); leaves p = exp2(s * scale - m) in x.  Returns each row's
// sum of p in rs and the factor alpha the earlier sums shrink by.
template <bool kMask>
__device__ __forceinline__ void online_softmax(float (&x)[32], float (&m)[2],
                                               float (&rs)[2],
                                               float (&alpha)[2], int kv0,
                                               int row0, int Skv, int causal,
                                               int off, float scale_log2) {
  const int t4 = (threadIdx.x & 31) & 3;
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    if (kMask) {
      const int col = kv0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
      if (col >= Skv || (causal && col > row0 + 8 * r + off)) x[i] = kNegInf;
    }
    mx[r] = fmaxf(mx[r], x[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);
    alpha[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
    rs[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    x[i] = fast_exp2(fmaf(x[i], scale_log2, -m[r]));
    rs[r] += x[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
  }
}

// Key tiles that the query rows q0 .. q0 + kBlockM - 1 see (q0 < Sq): up
// to the diagonal of the last row before Sq, when causal.
__device__ __forceinline__ int tiles_for(int q0, int Sq, int Skv, int causal) {
  const int all = (Skv + kBlockN - 1) / kBlockN;
  if (!causal) return all;
  return min(all, (min(q0 + kBlockM, Sq) - 1 + Skv - Sq) / kBlockN + 1);
}

template <int DP>
__global__ void __launch_bounds__(kThreads, DP == 64 ? 3 : 2)
    flash_attention_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           uint16_t* __restrict__ o, int B, int Hq, int Hkv,
                           int Sq, int Skv, int D, int causal,
                           float scale_log2) {
  using C = Config<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_tile = smem;
  auto k_tile = [&](int s) { return smem + (1 + s) * C::kTileBytes; };
  auto v_tile = [&](int s) {
    return smem + (1 + C::kStages + s) * C::kTileBytes;
  };
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + C::kStages;

  // longest causal query tiles first
  const int q_tiles = (Sq + kBlockM - 1) / kBlockM;
  const int heads = B * Hq;
  const int slot = blockIdx.x / heads, bh = blockIdx.x % heads;
  const int qt = causal ? q_tiles - 1 - slot : slot;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kBlockM;
  const int off = Skv - Sq;  // right-aligned causal offset
  const int n_tiles = tiles_for(q0, Sq, Skv, causal);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // ---- producer ----
    if (lane == 0) {
      mbar_expect_tx(q_full, C::kTileBytes);
      for (int p = 0; p < C::kPanels; ++p)
        tma_load(q_tile + p * kPanel, &tq, q_full, 64 * p, q0, b * Hq + h);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % C::kStages;
        if (t >= C::kStages) mbar_wait(&empty[s], (t / C::kStages - 1) & 1);
        mbar_expect_tx(&full[s], 2 * C::kTileBytes);
        for (int p = 0; p < C::kPanels; ++p) {
          tma_load(k_tile(s) + p * kPanel, &tk, &full[s], 64 * p,
                   t * kBlockN, b * Hkv + hk);
          tma_load(v_tile(s) + p * kPanel, &tv, &full[s], 64 * p,
                   t * kBlockN, b * Hkv + hk);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup ----
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  // the first key tile that crosses the diagonal of these rows or Skv
  const int first_edge = causal ? min((q0 + off) / kBlockN, Skv / kBlockN)
                                : Skv / kBlockN;
  const uint32_t q_addr = smem_u32(q_tile);

  float acc[C::kPanels][32];
#pragma unroll
  for (int p = 0; p < C::kPanels; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;

  // S = Q K^T of the tile in stage s: 16 columns of D per step, 32 bytes
  // along the swizzled row
  auto issue_qk = [&](int s) {
    const uint32_t k_addr = smem_u32(k_tile(s));
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t at = (kk / 4) * kPanel + (kk % 4) * 32;
      wgmma_ss(sc, smem_desc(q_addr + at), smem_desc(k_addr + at), kk > 0);
    }
  };
  auto softmax = [&](int t, float (&rs)[2], float (&alpha)[2]) {
    if (t >= first_edge)
      online_softmax<true>(sc, m, rs, alpha, t * kBlockN, row0, Skv, causal,
                           off, scale_log2);
    else
      online_softmax<false>(sc, m, rs, alpha, t * kBlockN, row0, Skv, causal,
                            off, scale_log2);
  };

  // S_0 and its softmax; then for tile t, S_{t+1} is issued ahead of the
  // P_t V_t product, and the softmax of S_{t+1} runs while P_t V_t is on
  // the tensor cores.
  mbar_wait(q_full, 0);
  mbar_wait(&full[0], 0);
  wgmma_fence();
  issue_qk(0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  float first_alpha[2];
  softmax(0, l, first_alpha);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % C::kStages;
    // P as A fragments: keys 16 kk .. 16 kk + 15 are n-tiles 2 kk, 2 kk + 1
    uint32_t pa[kBlockN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    const bool next = t + 1 < n_tiles;
    if (next)
      mbar_wait(&full[(t + 1) % C::kStages], ((t + 1) / C::kStages) & 1);
#pragma unroll
    for (int p = 0; p < C::kPanels; ++p) fence_regs(acc[p]);
    wgmma_fence();
    if (next) {
      issue_qk((t + 1) % C::kStages);
      wgmma_commit();
    }
    // O += P V: 16 keys (16 swizzled rows, 2048 bytes) per step
    const uint32_t v_addr = smem_u32(v_tile(s));
#pragma unroll
    for (int p = 0; p < C::kPanels; ++p)
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
        wgmma_rs(acc[p], pa[kk], smem_desc(v_addr + p * kPanel + kk * 2048));
    wgmma_commit();
    float rs[2] = {0.f, 0.f}, alpha[2] = {1.f, 1.f};
    if (next) {
      wgmma_wait<1>();
      fence_regs(sc);
      softmax(t + 1, rs, alpha);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < C::kPanels; ++p) fence_regs(acc[p]);
    mbar_arrive(&empty[s]);
    if (next) {
#pragma unroll
      for (int p = 0; p < C::kPanels; ++p)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[p][i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    uint16_t* dst = o + (static_cast<size_t>(b) * Hq + h) * Sq * D +
                    static_cast<size_t>(row) * D;
#pragma unroll
    for (int p = 0; p < C::kPanels; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * p + 8 * j + 2 * t4;
        if (col < D)
          *reinterpret_cast<uint32_t*>(dst + col) =
              pack_bf16(acc[p][4 * j + 2 * r] * inv,
                        acc[p][4 * j + 2 * r + 1] * inv);
      }
  }
}

#undef REPRO_D32
#undef REPRO_D32_OUT

// cuTensorMapEncodeTiled, reached through the runtime so the library needs
// no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// x bf16 (heads, S, D) as 64-row, 64-column boxes in the 128-byte swizzle;
// out-of-bounds elements read as zeros.
int tensor_map(CUtensorMap* map, const void* x, int heads, int S, int D) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(S) * D * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

constexpr int kMaxDevices = 64;

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Hq,
           int Hkv, int Sq, int Skv, int D, int causal, float scale_log2,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = tensor_map(&tq, q, B * Hq, Sq, D);
  if (!err) err = tensor_map(&tk, k, B * Hkv, Skv, D);
  if (!err) err = tensor_map(&tv, v, B * Hkv, Skv, D);
  if (err) return err;
  const int smem = Config<DP>::kSmem;
  // the shared-memory opt-in, once per device for this instance (setting
  // it again from a racing thread is harmless)
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  err = static_cast<int>(cudaGetDevice(&dev));
  if (err) return err;
  if (dev >= kMaxDevices || !opted_in[dev]) {
    err = static_cast<int>(cudaFuncSetAttribute(
        flash_attention_kernel<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    if (err) return err;
    if (dev < kMaxDevices) opted_in[dev] = true;
  }
  const long long blocks =
      static_cast<long long>((Sq + kBlockM - 1) / kBlockM) * Hq * B;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  flash_attention_kernel<DP><<<static_cast<unsigned>(blocks), kThreads, smem,
                               stream>>>(tq, tk, tv, static_cast<uint16_t*>(o),
                                         B, Hq, Hkv, Sq, Skv, D, causal,
                                         scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q bf16 (B, Hq, Sq, D), k and v bf16 (B, Hkv, Skv, D), all contiguous and
// 16-byte aligned -> o bf16 (B, Hq, Sq, D).  Hq % Hkv == 0, D in {16, 32,
// 64, 128}, B, Hq, Sq, Skv > 0 and, with causal, Sq <= Skv.  Returns the
// launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int Hq, int Hkv, int Sq,
                                   int Skv, int D, int causal, float scale,
                                   void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 ||
      Skv <= 0 || (causal && Sq > Skv))
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = scale * kLog2e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
    case 32:
    case 64:
      return launch<64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal, scale_log2,
                        s);
    case 128:
      return launch<128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal,
                         scale_log2, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Bucketed hash-semi membership probe: per bucket, whether each occupied
// probe slot's key is carried by any occupied build slot.
//
// Replaces the TPU kernel bucket_member_buckets
// (src/repro/kernels/hash_semi/kernel.py), which materialises each
// bucket's dense (Lc, C) match matrix in vector registers and reduces
// each row with a sum.  Here no (Lc, C) matrix exists: as in hash_join.cu
// a block of 8 warps takes one bucket and walks its probe slots 8 * S at
// a time (bucket_match.cuh: S = 32, fewer when the buckets are too few to
// give every SM a block), with the build slab in shared memory (staged
// once when it fits, else streamed in chunks); each warp loads its S probe
// slots at once and walks the chains of the occupied ones, 32 chain slots
// per step (any K, any C), with __ballot_sync over the lanes' match bits.
// Membership needs no ranks, so a slot stops at its first hit, the empty
// slots are skipped, and a block stops streaming chunks once all of its
// group's live slots have one.  One int32 per probe slot is written: HBM
// traffic is O(B * Lc), not O(B * Lc * C).
//
// Bound: the function must read both occupancy slabs, 4 * B * (Lc + C)
// bytes, the key planes of the occupied slots, 4 * K * (sum_b occ_probe_b
// + occ_build_b) bytes (a prefix of each bucket, read coalesced), and
// write 4 * B * Lc; it needs at most K compares for each pair of occupied
// slots of a bucket, sum_b occ_probe_b * occ_build_b * K.  On the UNOMT
// filters' slabs (a few occupied build slots per bucket) the bytes bound
// it; this kernel walks every staged build slot of a live probe slot's
// chain up to its first hit.
#include "bucket_match.cuh"

namespace {

// 8 blocks of 256 threads per SM (32 registers): the probe waits on loads
// and shared-memory reads, and more warps hide more of them.
template <bool kOneKey>
__global__ void __launch_bounds__(repro::kThreads, 8)
    hash_semi_kernel(const int* __restrict__ pbits,
                     const int* __restrict__ pocc,
                     const int* __restrict__ bbits,
                     const int* __restrict__ bocc, int K, int Lc, int C,
                     int cj, int S, int* __restrict__ member) {
  extern __shared__ int smem[];
  int* skey = smem;                     // [K][cj] build keys
  int* socc = skey + K * cj;            // [cj] build occupancy
  const int64_t b = blockIdx.x;
  const int* pb = pbits + b * K * Lc;
  const int* bb = bbits + b * K * C;
  const int* bo = bocc + b * C;
  const int lane = threadIdx.x & 31;
  const bool one_chunk = C <= cj;
  if (one_chunk) {
    repro::stage_build(bb, bo, K, C, 0, C, cj, skey, socc);
    __syncthreads();
  }

  const int per_block = repro::kWarps * S;
  for (int g = blockIdx.y; g * per_block < Lc; g += gridDim.y) {
    const int l0 = g * per_block + (threadIdx.x >> 5) * S;
    const int nq = Lc - l0 < S ? Lc - l0 : S;     // this warp's slots
    const int l = lane < nq ? l0 + lane : 0;      // this lane's slot
    const bool live = lane < nq && pocc[b * Lc + l] > 0;
    const int key = pb[l];                        // plane 0 of its key
    // bit q: slot l0 + q is occupied and has no hit yet (uniform)
    unsigned open = __ballot_sync(0xffffffffu, live);
    unsigned found = 0;
    for (int j0 = 0; j0 < C; j0 += cj) {
      const int jn = C - j0 < cj ? C - j0 : cj;
      if (!one_chunk) {
        // stop streaming once no slot of the group still looks (a
        // barrier too: the previous chunk is done with)
        if (!__syncthreads_or(open != 0)) break;
        repro::stage_build(bb, bo, K, C, j0, jn, cj, skey, socc);
        __syncthreads();
      }
      for (unsigned todo = open; todo != 0; todo &= todo - 1) {
        const int q = __ffs(todo) - 1;
        const int want = __shfl_sync(0xffffffffu, key, q);
        for (int c0 = 0; c0 < jn; c0 += 32) {
          if (__ballot_sync(0xffffffffu, repro::staged_match<kOneKey>(
                                             skey, socc, cj, c0 + lane, jn,
                                             want, pb + l0 + q, K, Lc))) {
            found |= 1u << q;
            break;
          }
        }
      }
      open &= ~found;
    }
    if (lane < nq) member[b * Lc + l] = (found >> lane) & 1u;
  }
}

}  // namespace

// pbits (B, K, Lc), pocc (B, Lc), bbits (B, K, C), bocc (B, C) int32 ->
// member (B, Lc) int32 0/1.  B, K, Lc, C > 0.  Returns the launch's
// cudaError_t.
extern "C" int hash_semi_member(const int* pbits, const int* pocc,
                                const int* bbits, const int* bocc, int B,
                                int K, int Lc, int C, int* member,
                                void* stream) {
  if (B <= 0 || K <= 0 || Lc <= 0 || C <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int cj = 0;
  size_t smem = 0;
  auto* kernel = K == 1 ? hash_semi_kernel<true> : hash_semi_kernel<false>;
  const int e = repro::prepare_chunk(kernel, K + 1, C, C, &cj, &smem);
  if (e) return e;
  const repro::ProbeLaunch p = repro::probe_launch(B, Lc);
  kernel<<<p.grid, repro::kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      pbits, pocc, bbits, bocc, K, Lc, C, cj, p.per_warp, member);
  return static_cast<int>(cudaGetLastError());
}

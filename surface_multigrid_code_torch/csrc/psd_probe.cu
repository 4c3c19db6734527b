// K4 on tensor cores: the Newton-Schulz sign-apply of 9 x 9 f32 blocks with
// every product on mma.sync, TF32 in one pass or split 3xTF32, for Hopper
// (sm_90a). A measurement of the precision question, on no path of the
// port: probes/psd_precision.py runs it.
//
// Replaces the TPU Pallas probe benchmarks/probes/probe_psd_precision.py:30
// main (pallas_call :80), which ran the sign kernel's products at HIGHEST
// (6-pass bf16, f32-exact) and DEFAULT (1-pass bf16) on the MXU; HIGH
// (bf16x3) did not lower in Mosaic. Its Hopper analogues: K4 itself
// (csrc/psd.cu, f32 on the CUDA cores) for HIGHEST, this kernel with
// PASSES = 3 for HIGH and with PASSES = 1 for DEFAULT's class of error.
//
// What it computes is K4's function (csrc/psd.cu): per block X,
//   Z = X;  for each (a, b) of the schedule:  Z <- a Z - b (Z Z) Z
//   Y = X + X Z
// Every product takes its operands rounded to TF32 (cvt.rna: 10 mantissa
// bits, round to nearest, ties away) and accumulates in f32. With
// PASSES = 1 the product is hi(A) hi(B); with PASSES = 3 each operand is
// split into hi = tf32(a) and lo = tf32(a - hi), and the product is
// lo(A) hi(B) + hi(A) lo(B) + hi(A) hi(B): about f32's precision (the
// dropped lo lo term is 2^-22 of the product).
//
// Design: a warp runs kBlocksPerWarp blocks at once, interleaved, so that
// their mma chains are independent, and keeps each block's X and Z in
// registers for the whole schedule, in the m16n8 accumulator layout:
// lane (g, t) = (lane / 4, lane % 4) holds [g][2t], [g][2t+1] and row 8's
// [8][2t], [8][2t+1] in tile rows g + 8 (row 8 repeated in rows 8-15,
// which a product keeps so: row i of A B depends on row i of A alone),
// and column 8's [g][8] and [8][8] (the same in every t).
//  - The summation index K is relabelled the same way in A and B: slot t
//    of an A fragment is column 2t, slot t + 4 column 2t + 1. A's fragment
//    is then the lane's own {[g][2t], [8][2t], [g][2t+1], [8][2t+1]}: no
//    data moves.
//  - Each operand is split once: Z as A of Z Z, as B of both products of
//    the step and, for its row 8 and [8][8], as B of their ninth K term;
//    Z Z as A of (Z Z) Z; X as A of X Z.
//  - B's fragment, {Z[2t][g], Z[2t+1][g]}, needs transposed positions:
//    two warp shuffles of the split Z (hi, and lo with 3 passes) once a
//    step (each lane sends the entry of its parity, so every shuffle
//    serves 32 lanes), and column 8 for the second tile two more. Z
//    itself is multiplied, never Z^T: Z is not symmetric in rounding.
//  - Columns 0-7 over K 0-7 are one mma.sync.m16n8k8 a pass, column 8 a
//    second one (column 8 repeated in its 8 columns). The ninth K term,
//    A[.][8] B[8][.], is a rank-1 update on the CUDA cores with the same
//    TF32 operands (a product of two TF32 values is exact in f32), the
//    start of the accumulators. (Column 8 on the CUDA cores instead, a
//    2-term dot product a lane summed over a row's 4 lanes by shuffles,
//    was 5-19% slower: PERF.md.)
//  - The rounding to TF32 runs on the integer units, which the splits
//    keep busiest: in the steps by two operations (cvt.rna's sequence is
//    four, with its test for a non-finite value); a block whose steps
//    would round a NaN gets a NaN Y, as the plain version gives it.
//  - No shared-memory tile a product and no __syncwarp between products.
//  - I/O: persistent CTAs of kWarps warps walk chunks of kWarps x
//    kBlocksPerWarp blocks (a multiple of 4: 4 x 324 B = 81 x 16 B, so a
//    chunk is a 16-byte-aligned range). Thread 0 loads the next chunk's X
//    by one cp.async.bulk on an mbarrier into the second buffer while the
//    warps compute the current one; each warp stages its Y in its slice of
//    the buffer it read and writes it back coalesced. A last chunk of
//    fewer blocks is read from global memory directly.
//
// Bound: per block 2 x 81 x 4 B of X and Y, 20.5 MB at 31,608 blocks: 6.1
// us at 3.35 TB/s; the useful work, 25 symmetric products of 810 FLOP a
// block at the 12-step schedule, 0.64 GFLOP, is 1.3 us at the TF32 dense
// peak of 495 TFLOP/s. The tiles this design issues are 2 m16n8k8 a
// product a pass, 4,096 FLOP: 3.24 GFLOP a pass,
// 6.5 us in TF32 and 19.6 us in 3xTF32 at that peak, above the bytes.
// One block a tile cannot fill the m16 rows: rows 9-15 repeat row 8, and
// the second tile has one live column of 8, so 648 of the 2 x 1,024 MACs
// are useful (K 0-7). (The 16^3 zero-padded tiles of the design before
// this one took 4 a product a pass, 729 of 4,096 MACs useful: 13.1 and
// 39.2 us.) Neither bound counts the instructions around the mmas (the
// splits, shuffles and rank-1 terms), which the warps issue besides.
//
// The entry point has a plain C interface (loaded with ctypes) and returns
// cudaGetLastError() of the launch; it launches on the given stream,
// allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSteps = 32;
constexpr int kD = 9;
constexpr int kBlockFloats = kD * kD;
constexpr int kWarps = 4;  // warps a CTA
constexpr int kThreads = 32 * kWarps;
// the knob (kernel_ab.py psd_tc variants flip it with sed)
constexpr int kBlocksPerWarp = 2;  // blocks a warp, interleaved
constexpr int kChunk = kWarps * kBlocksPerWarp;  // blocks a chunk
constexpr int kChunkFloats = kChunk * kBlockFloats;
constexpr int kWarpFloats = kBlocksPerWarp * kBlockFloats;
static_assert(kChunk % 4 == 0, "a chunk must be a whole number of 16-byte groups");
// entries a lane holds of a block: [g][2t], [g][2t+1], [8][2t], [8][2t+1], [g][8], [8][8]
constexpr int kHeld = 6;

struct Schedule {
  float a[kMaxSteps];
  float b[kMaxSteps];
  int n;
};

// ------------------------------------------------- barriers, bulk copies

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// chunk c of X into dst by one bulk copy, completing on bar (one thread;
// the buffer's earlier reads and writes are done: a CTA barrier before)
__device__ __forceinline__ void load_chunk(float* dst, const float* X, int c, uint64_t* bar) {
  constexpr uint32_t bytes = kChunkFloats * 4;
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(X + static_cast<int64_t>(c) * kChunkFloats), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ------------------------------------------------------ the arithmetic

// x rounded to TF32 as cvt.rna does: to nearest on the 13 dropped bits,
// ties away from zero (adding half a TF32 ulp to the magnitude bits and
// truncating). FAST: without cvt.rna's test for a non-finite x, two integer
// operations: exact for every finite x and for +-inf, but a NaN may come
// out as anything, so the steps flag a NaN they round (see the kernel).
template <bool FAST>
__device__ __forceinline__ uint32_t tf32(float x) {
  if (FAST) return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// hi = tf32(x); with PASSES = 3 also lo = tf32(x - hi)
template <int PASSES, bool FAST, int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&hi)[N], uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = tf32<FAST>(x[i]);
    if (PASSES == 3) lo[i] = tf32<FAST>(x[i] - __uint_as_float(hi[i]));
  }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc + the TF32 product of a and b as the mma forms it: hi hi and, with 3
// passes, hi lo + lo hi. Each is exact in f32, and so is bs = hi + lo of b
// (22 significant bits), so hi (hi + lo) + lo hi is the same sum in two
// roundings.
template <int PASSES>
__device__ __forceinline__ float term(uint32_t ah, uint32_t al, uint32_t bh, float bs, float acc) {
  if (PASSES == 1) return fmaf(__uint_as_float(ah), __uint_as_float(bh), acc);
  return fmaf(__uint_as_float(al), __uint_as_float(bh), fmaf(__uint_as_float(ah), bs, acc));
}

// A's columns 0-7 (its fragment, K relabelled) times B's fragment
// {b0, b1}, onto d: lo hi, hi lo, hi hi
template <int PASSES>
__device__ __forceinline__ void mma_passes(float (&d)[4], const uint32_t (&ah)[kHeld],
                                           const uint32_t (&al)[kHeld], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  if (PASSES == 3) {
    mma_tf32(d, al[0], al[2], al[1], al[3], bh0, bh1);
    mma_tf32(d, ah[0], ah[2], ah[1], ah[3], bl0, bl1);
  }
  mma_tf32(d, ah[0], ah[2], ah[1], ah[3], bh0, bh1);
}

// The lanes each lane reads from for B's fragments.
struct Lanes {
  bool odd;  // g odd
  int src1, src2;  // lanes (2t, g/2) and (2t+1, g/2), in the order of g's parity
  int col0, col1;  // lanes (2t, 0) and (2t+1, 0)
};

__device__ __forceinline__ Lanes lanes_of(int g, int t) {
  Lanes L;
  L.odd = g & 1;
  const int even_row = 4 * (2 * t) + g / 2, odd_row = 4 * (2 * t + 1) + g / 2;
  L.src1 = L.odd ? odd_row : even_row;
  L.src2 = L.odd ? even_row : odd_row;
  L.col0 = 8 * t;
  L.col1 = 8 * t + 4;
  return L;
}

// B's fragments of the held (split) matrix v, K relabelled as in A: b[0],
// b[1] = v[2t][g], v[2t+1][g] (the first tile); b[2], b[3] = v[2t][8],
// v[2t+1][8] (column 8, in every column of the second tile). Lane (r, u)
// holds v[r][g] in its entry g % 2 for g / 2 = u; a lane of even r sends
// entry 0 in the first shuffle, one of odd r entry 1, so one shuffle
// brings b[0] to the lanes of even g and b[1] to those of odd g, the
// second the others.
__device__ __forceinline__ void b_fragments(const uint32_t (&v)[kHeld], uint32_t (&b)[4],
                                            const Lanes& L) {
  const uint32_t r1 = __shfl_sync(0xffffffffu, L.odd ? v[1] : v[0], L.src1);
  const uint32_t r2 = __shfl_sync(0xffffffffu, L.odd ? v[0] : v[1], L.src2);
  b[0] = L.odd ? r2 : r1;
  b[1] = L.odd ? r1 : r2;
  b[2] = __shfl_sync(0xffffffffu, v[4], L.col0);
  b[3] = __shfl_sync(0xffffffffu, v[4], L.col1);
}

// B as the operand of both products of a step and of the last: its split
// fragments and, for the ninth K term, its row 8 and [8][8] (held entries
// 2, 3, 5) as hi and hi + lo.
struct BOperand {
  uint32_t bh[4], bl[4];
  uint32_t rh[3];
  float rs[3];
};

template <int PASSES>
__device__ __forceinline__ void b_operand(const uint32_t (&h)[kHeld], const uint32_t (&l)[kHeld],
                                          const Lanes& L, BOperand& B) {
  b_fragments(h, B.bh, L);
  if (PASSES == 3) b_fragments(l, B.bl, L);
  B.rh[0] = h[2];
  B.rh[1] = h[3];
  B.rh[2] = h[5];
  if (PASSES == 3) {
    B.rs[0] = __uint_as_float(h[2]) + __uint_as_float(l[2]);
    B.rs[1] = __uint_as_float(h[3]) + __uint_as_float(l[3]);
    B.rs[2] = __uint_as_float(h[5]) + __uint_as_float(l[5]);
  }
}

// p = A B: a the split of A's held entries, B as above.
template <int PASSES>
__device__ __forceinline__ void product(const uint32_t (&ah)[kHeld], const uint32_t (&al)[kHeld],
                                        const BOperand& B, float (&p)[kHeld]) {
  // K = 8 first, on the CUDA cores: A[g][8] B[8][2t + i], A[8][8] B[8][2t + i]
  float d[4] = {term<PASSES>(ah[4], al[4], B.rh[0], B.rs[0], 0.f),
                term<PASSES>(ah[4], al[4], B.rh[1], B.rs[1], 0.f),
                term<PASSES>(ah[5], al[5], B.rh[0], B.rs[0], 0.f),
                term<PASSES>(ah[5], al[5], B.rh[1], B.rs[1], 0.f)};
  mma_passes<PASSES>(d, ah, al, B.bh[0], B.bh[1], B.bl[0], B.bl[1]);
  // column 8: A[g][8] B[8][8], A[8][8] B[8][8], then the second tile (its
  // columns 9-15 repeat column 8; entries 1 and 3 are not read)
  float e[4] = {term<PASSES>(ah[4], al[4], B.rh[2], B.rs[2], 0.f), 0.f,
                term<PASSES>(ah[5], al[5], B.rh[2], B.rs[2], 0.f), 0.f};
  mma_passes<PASSES>(e, ah, al, B.bh[2], B.bh[3], B.bl[2], B.bl[3]);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = d[i];
  p[4] = e[0];
  p[5] = e[2];
}

__device__ __forceinline__ bool any_nan(const float (&v)[kHeld]) {
  bool r = false;
#pragma unroll
  for (int i = 0; i < kHeld; ++i) r |= isnan(v[i]);
  return r;
}

// a block's held entries from row-major s (shared or global memory)
__device__ __forceinline__ void load_block(const float* s, int g, int t, float (&v)[kHeld]) {
  v[0] = s[g * kD + 2 * t];
  v[1] = s[g * kD + 2 * t + 1];
  v[2] = s[8 * kD + 2 * t];
  v[3] = s[8 * kD + 2 * t + 1];
  v[4] = s[g * kD + 8];
  v[5] = s[8 * kD + 8];
}

// each entry once: row 8 from the lanes of g = 0, column 8 from t = 0
__device__ __forceinline__ void store_block(float* s, int g, int t, const float (&v)[kHeld]) {
  s[g * kD + 2 * t] = v[0];
  s[g * kD + 2 * t + 1] = v[1];
  if (g == 0) {
    s[8 * kD + 2 * t] = v[2];
    s[8 * kD + 2 * t + 1] = v[3];
  }
  if (t == 0) s[g * kD + 8] = v[4];
  if (g == 0 && t == 0) s[8 * kD + 8] = v[5];
}

// The steps round with tf32<true>. A NaN they would round (in Z, or in
// Z Z) spreads to every entry of Y in the plain version (a product makes
// the row and the column of a NaN NaN, the next one everything, and X Z
// every row of a NaN row of Z), so such a block's Y is set NaN; the last
// product, X Z, rounds with cvt.rna.
template <int PASSES>
__global__ void __launch_bounds__(kThreads)
ns_sign_apply_tc_kernel(const float* __restrict__ X, float* __restrict__ Y, int m,
                        Schedule sched) {
  __shared__ __align__(128) float xs[2][kChunkFloats];
  __shared__ __align__(8) uint64_t full[2];
  constexpr int NB = kBlocksPerWarp;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const Lanes L = lanes_of(g, t);
  const int chunks = (m + kChunk - 1) / kChunk;
  const int whole = m / kChunk;  // chunks of kChunk blocks: loaded by bulk copies
  if (threadIdx.x == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_fence_init();
    if (static_cast<int>(blockIdx.x) < whole) load_chunk(xs[0], X, blockIdx.x, &full[0]);
  }
  __syncthreads();
  for (int c = blockIdx.x, it = 0; c < chunks; c += gridDim.x, ++it) {
    const int buf = it & 1;
    if (it > 0) __syncthreads();  // every warp is done with the other buffer
    if (threadIdx.x == 0 && c + static_cast<int>(gridDim.x) < whole)
      load_chunk(xs[buf ^ 1], X, c + static_cast<int>(gridDim.x), &full[buf ^ 1]);
    const float* src = X + static_cast<int64_t>(c) * kChunkFloats;
    if (c < whole) {
      mbar_wait(&full[buf], (it >> 1) & 1);
      src = xs[buf];
    }
    const int nb = min(kChunk, m - c * kChunk) - warp * NB;  // this warp's blocks
    float x[NB][kHeld], z[NB][kHeld], p[NB][kHeld];
    bool bad[NB];  // a NaN was rounded
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (j < nb) {
        load_block(src + (warp * NB + j) * kBlockFloats, g, t, x[j]);
      } else {
#pragma unroll
        for (int i = 0; i < kHeld; ++i) x[j][i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kHeld; ++i) z[j][i] = x[j][i];
      bad[j] = false;
    }
    for (int step = 0; step < sched.n; ++step) {
      const float a = sched.a[step];
      const float b = sched.b[step];
      uint32_t zh[NB][kHeld], zl[NB][kHeld];
      BOperand B[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        bad[j] |= any_nan(z[j]);
        split<PASSES, true>(z[j], zh[j], zl[j]);
        b_operand<PASSES>(zh[j], zl[j], L, B[j]);
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) product<PASSES>(zh[j], zl[j], B[j], p[j]);  // Z Z
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        uint32_t ph[kHeld], pl[kHeld];
        bad[j] |= any_nan(p[j]);
        split<PASSES, true>(p[j], ph, pl);
        product<PASSES>(ph, pl, B[j], p[j]);  // (Z Z) Z
      }
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int i = 0; i < kHeld; ++i) z[j][i] = a * z[j][i] - b * p[j][i];
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {  // Y = X + X Z
      uint32_t zh[kHeld], zl[kHeld], xh[kHeld], xl[kHeld];
      BOperand B;
      split<PASSES, false>(z[j], zh, zl);
      b_operand<PASSES>(zh, zl, L, B);
      split<PASSES, false>(x[j], xh, xl);
      product<PASSES>(xh, xl, B, p[j]);
      const bool poisoned = __any_sync(0xffffffffu, bad[j]);
#pragma unroll
      for (int i = 0; i < kHeld; ++i)
        p[j][i] = poisoned ? __int_as_float(0x7fffffff) : p[j][i] + x[j][i];
    }
    // Y through this warp's slice of the buffer it read (its own blocks)
    __syncwarp();
    float* stage = xs[buf] + warp * kWarpFloats;
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (j < nb) store_block(stage + j * kBlockFloats, g, t, p[j]);
    __syncwarp();
    float* dst = Y + static_cast<int64_t>(c) * kChunkFloats + warp * kWarpFloats;
    const int n = min(NB, nb) * kBlockFloats;
    for (int k = lane; k < n; k += 32) dst[k] = stage[k];
  }
}

// CTAs a multiprocessor holds of the kernel, by pass count and device
int resident[2][64];

}  // namespace

// X, Y: [m, 9, 9] f32, X 16-byte aligned; schedule: host array of `steps`
// (a, b) pairs, copied into the launch as floats; passes: 1 (TF32) or 3
// (3xTF32). A grid of as many CTAs as the card holds at once, at most one
// a chunk.
extern "C" int smg_ns_sign_apply_tc_f32(const float* X, float* Y, int m,
                                        const double* schedule, int steps, int passes,
                                        void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (steps < 0 || steps > kMaxSteps || (passes != 1 && passes != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(X) % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  Schedule sched;
  sched.n = steps;
  for (int i = 0; i < steps; ++i) {
    sched.a[i] = static_cast<float>(schedule[2 * i]);
    sched.b[i] = static_cast<float>(schedule[2 * i + 1]);
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  auto kernel = passes == 3 ? ns_sign_apply_tc_kernel<3> : ns_sign_apply_tc_kernel<1>;
  int& per_sm = resident[passes == 3][dev];
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (m + kChunk - 1) / kChunk;
  const int grid = chunks < sms * per_sm ? chunks : sms * per_sm;
  kernel<<<grid, kThreads, 0, stream>>>(X, Y, m, sched);
  return static_cast<int>(cudaGetLastError());
}

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
// Every product A B of two 16 x 16 tiles (the 9 x 9 block zero-padded) is
// four mma.sync.m16n8k8 TF32 products (two 8-column halves, two 8-deep
// halves), accumulated in f32. With PASSES = 1 each operand is rounded to
// TF32 (cvt.rna: 10 mantissa bits, round to nearest, ties away) and the
// product is hi(A) hi(B). With PASSES = 3 each operand is split into
// hi = tf32(a) and lo = tf32(a - hi), and the product is
// lo(A) hi(B) + hi(A) lo(B) + hi(A) hi(B) in one f32 accumulator: about
// f32's precision (the dropped lo lo term is 2^-22 of the product).
//
// Design: one warp per block, four blocks per CTA. The warp keeps X, Z and
// Z Z as zero-padded 16 x 16 tiles in shared memory (row stride 20 floats,
// so a fragment's 32 loads of A fall in 32 banks); each product loads its
// fragments from there, and the result stays in registers (the
// accumulator's layout) until the warp writes it back: Z Z to its tile,
// the cubic's update into Z in place after a __syncwarp (every lane has
// read Z by then), the last product straight into Y. The padding stays
// zero through every step, since zero rows and columns of the operands
// give zero rows and columns of the products.
//
// Bound: per block 2 x 81 x 4 B of X and Y, and per product 9 x 81 FMAs of
// useful work (1,458 FLOP; the padded tile does 16^3 x 2 = 8,192 a pass,
// 5.6 times the useful). At 31,608 blocks and the 12-step schedule: 20.5
// MB, 6.1 us at 3.35 TB/s, against 0.64 GFLOP of useful work, 1.3 us at
// the TF32 dense peak of 495 TFLOP/s: bytes. Three passes triple the mma
// work (17 times the useful), still below the bytes.
//
// The entry point has a plain C interface (loaded with ctypes) and returns
// cudaGetLastError() of the launch; it launches on the given stream,
// allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSteps = 32;
constexpr int kD = 9;
constexpr int kPad = 16;
constexpr int kStride = 20;  // shared-memory row stride of a tile, in floats
constexpr int kTile = kPad * kStride;
constexpr int kWarps = 4;    // blocks (warps) per CTA

struct Schedule {
  double a[kMaxSteps];
  double b[kMaxSteps];
  int n;
};

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// hi = tf32(x); with PASSES = 3 also lo = tf32(x - hi)
template <int PASSES>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  if (PASSES == 3) lo = tf32(x - __uint_as_float(hi));
}

// acc = A B for 16 x 16 tiles A, B in shared memory (row stride kStride).
// acc[nt][i] is entry (g + 8 (i / 2), 8 nt + 2 t + i % 2) of the product,
// g = lane / 4, t = lane % 4 (the m16n8 accumulator layout). Ends with a
// __syncwarp: every lane has read A and B.
template <int PASSES>
__device__ __forceinline__ void product(const float* A, const float* B, float (&acc)[2][4],
                                        int g, int t) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < kPad; k0 += 8) {
    // A fragment (16 x 8, row-major): rows g, g + 8; columns k0 + t, k0 + t + 4
    const float af[4] = {A[g * kStride + k0 + t], A[(g + 8) * kStride + k0 + t],
                         A[g * kStride + k0 + t + 4], A[(g + 8) * kStride + k0 + t + 4]};
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split<PASSES>(af[i], ah[i], al[i]);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      // B fragment (8 x 8, column-major): rows k0 + t, k0 + t + 4; column 8 nt + g
      const float bf[2] = {B[(k0 + t) * kStride + 8 * nt + g],
                           B[(k0 + t + 4) * kStride + 8 * nt + g]};
      uint32_t bh[2], bl[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) split<PASSES>(bf[i], bh[i], bl[i]);
      if (PASSES == 3) {
        mma_tf32(acc[nt], al, bh);
        mma_tf32(acc[nt], ah, bl);
      }
      mma_tf32(acc[nt], ah, bh);
    }
  }
  __syncwarp();
}

template <int PASSES>
__global__ void __launch_bounds__(kWarps * 32)
ns_sign_apply_tc_kernel(const float* __restrict__ X, float* __restrict__ Y, int m,
                        Schedule sched) {
  __shared__ float tiles[kWarps][3][kTile];
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int64_t blk = (int64_t)blockIdx.x * kWarps + w;
  if (blk >= m) return;  // the whole warp: no CTA-wide barrier follows
  float* x0 = tiles[w][0];
  float* z = tiles[w][1];
  float* z2 = tiles[w][2];
  for (int k = lane; k < kTile; k += 32) {
    x0[k] = 0.f;
    z[k] = 0.f;
  }
  __syncwarp();
  const float* src = X + blk * kD * kD;
  for (int k = lane; k < kD * kD; k += 32) {
    const float v = src[k];
    x0[(k / kD) * kStride + k % kD] = v;
    z[(k / kD) * kStride + k % kD] = v;
  }
  __syncwarp();
  float acc[2][4];
  for (int step = 0; step < sched.n; ++step) {
    const float a = static_cast<float>(sched.a[step]);
    const float b = static_cast<float>(sched.b[step]);
    product<PASSES>(z, z, acc, g, t);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        z2[(g + 8 * (i / 2)) * kStride + 8 * nt + 2 * t + i % 2] = acc[nt][i];
    __syncwarp();
    product<PASSES>(z2, z, acc, g, t);  // (Z Z) Z
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = (g + 8 * (i / 2)) * kStride + 8 * nt + 2 * t + i % 2;
        z[e] = a * z[e] - b * acc[nt][i];
      }
    __syncwarp();
  }
  product<PASSES>(x0, z, acc, g, t);
  float* dst = Y + blk * kD * kD;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = g + 8 * (i / 2);
      const int c = 8 * nt + 2 * t + i % 2;
      if (r < kD && c < kD) dst[r * kD + c] = x0[r * kStride + c] + acc[nt][i];
    }
}

}  // namespace

// X, Y: [m, 9, 9] f32; schedule: host array of `steps` (a, b) pairs,
// copied into the launch; passes: 1 (TF32) or 3 (3xTF32).
extern "C" int smg_ns_sign_apply_tc_f32(const float* X, float* Y, int m,
                                        const double* schedule, int steps, int passes,
                                        void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (steps < 0 || steps > kMaxSteps || (passes != 1 && passes != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  Schedule sched;
  sched.n = steps;
  for (int i = 0; i < steps; ++i) {
    sched.a[i] = schedule[2 * i];
    sched.b[i] = schedule[2 * i + 1];
  }
  const int grid = (m + kWarps - 1) / kWarps;
  if (passes == 3) {
    ns_sign_apply_tc_kernel<3><<<grid, kWarps * 32, 0, stream>>>(X, Y, m, sched);
  } else {
    ns_sign_apply_tc_kernel<1><<<grid, kWarps * 32, 0, stream>>>(X, Y, m, sched);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4: Newton-Schulz sign-apply of symmetric d x d blocks, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel surface_multigrid_code_tpu/ops/psd.py:82
// ns_sign_apply_packed (body _sign_apply_kernel :70, pallas_call :106).
// What it computes, and all this file computes, per block X (d in {9, 18}):
//   Z = X;  for each (a, b) of the schedule:  Z <- a Z - b (Z Z) Z
//   Y = X + X Z
// With ||X||_2 <= 1.4 and the 12-cubic schedule of ops/psd.py:44-57, Z is
// the matrix sign of X and (s/2) Y the PSD projection of the unscaled block
// (models/shell.psd_project_blocks does the scaling and the clamp test).
// X is symmetric (psd_project_blocks symmetrizes it exactly), so every
// iterate, a polynomial in X, is symmetric too; X Z is not, in rounding,
// since the computed Z does not commute with X exactly.
//
// The TPU kernel packs 14 (or 7) blocks into one block-diagonal 128 x 128
// tile so that the MXU gets a large matmul, and selects the blocks back
// out with 0/1 einsums. None of that is needed here. The body follows
// from d and the type:
//
// - registers (9 x 9 in f32, the balloon's path): one thread per block.
//   The iterate lives in registers as its 45 upper-triangle entries
//   (read from X's upper triangle), and each product Z Z and (Z Z) Z is
//   evaluated for i <= j only: 405 FMAs where the full product takes 729.
//   Every index is a compile-time constant of fully unrolled loops, so the
//   arrays stay in registers: Z, Z Z and (Z Z) Z are 135 live floats. The
//   last product X Z is computed in full, row by row with X's row read
//   from shared memory: mirroring its upper triangle instead left a
//   least eigenvalue of -1.1e-5 in Y / 2 on blocks with eigenvalues at
//   the schedule's edges, where the full product leaves -6e-8, as the
//   plain version does. A CTA of kSymBlocks blocks stages X through shared
//   memory with coalesced loads of its kSymBlocks x 81 contiguous values;
//   a thread then reads its block at a stride of 81 words, which is odd,
//   so without bank conflicts, and Y goes back the same way. No barrier
//   runs between the load and the store: each thread works on its own
//   block alone.
// - shared (9 x 9 in f64, 18 x 18 in either type): one CTA runs BPC
//   blocks (4 of 9 x 9, or 1 of 18 x 18: 324 threads either way), one
//   thread per output entry, with the iterate in shared memory and three
//   barriers per cubic step. A thread per block cannot hold these in its
//   255 registers: 135 doubles, or 3 x 171 floats.
//
// Precision: CUDA cores only, in the working type (f32 or f64), no tensor
// cores and no TF32. The growth cubics amplify rounding of the inputs
// about 700-fold on directions with small eigenvalues; bf16 inputs left
// blocks unprojected (min-eig-rel -0.44) in the reference's own study, and
// TF32's 10-bit mantissa is the same class of error. At 9 x 9 a tensor
// core tile pads to 16 x 16, and a split-3 x TF32 product would do about
// 30 times the useful work, so the CUDA cores are also the faster route.
// Both bodies sum each product entry in the order q = 0..d-1, as a chain
// of FMAs; the plain PyTorch version's bmm sums in its own order.
//
// Bound: per 9 x 9 block 25 symmetric products of 45 x 9 FMAs (810 FLOP
// each, 20K FLOP a block; the register body does 24 of them and one full
// product of 81 x 9) for 648 B (f32) of traffic, so operations: at
// bunny_15K's 31,604 faces 0.64 GFLOP, 9.55 us at the card's f32 CUDA-core
// peak. The register body issues those FMAs from 988 warps, about two per
// scheduler; each warp has 45 independent FMA chains per product, which
// hides the FMA latency without more occupancy.
//
// Entry points have a plain C interface (loaded with ctypes) and return
// cudaGetLastError() of the launch; they launch on the given stream,
// allocate nothing and do not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSteps = 32;
constexpr int kSymBlocks = 64;  // blocks (threads) per CTA of the register body

struct Schedule {
  double a[kMaxSteps];
  double b[kMaxSteps];
  int n;
};

template <typename T, int D, int BPC>
__global__ void __launch_bounds__(BPC * D * D)
ns_sign_apply_kernel(const T* __restrict__ X, T* __restrict__ Y, int m,
                     Schedule sched) {
  constexpr int DD = D * D;
  __shared__ T x0[BPC][DD];
  __shared__ T z[BPC][DD];
  __shared__ T z2[BPC][DD];
  const int t = threadIdx.x;
  const int k = t / DD;  // block within the CTA
  const int e = t % DD;  // entry within the block
  const int r = e / D;
  const int c = e % D;
  const int64_t g = (int64_t)blockIdx.x * BPC + k;
  const bool live = g < m;
  const T xv = live ? X[g * DD + e] : T(0);
  x0[k][e] = xv;
  z[k][e] = xv;
  __syncthreads();
  for (int step = 0; step < sched.n; ++step) {
    const T a = static_cast<T>(sched.a[step]);
    const T b = static_cast<T>(sched.b[step]);
    T acc = T(0);
#pragma unroll
    for (int q = 0; q < D; ++q) acc += z[k][r * D + q] * z[k][q * D + c];
    z2[k][e] = acc;
    __syncthreads();
    T acc3 = T(0);
#pragma unroll
    for (int q = 0; q < D; ++q) acc3 += z2[k][r * D + q] * z[k][q * D + c];
    const T zn = a * z[k][e] - b * acc3;
    __syncthreads();
    z[k][e] = zn;
    __syncthreads();
  }
  T acc = T(0);
#pragma unroll
  for (int q = 0; q < D; ++q) acc += x0[k][r * D + q] * z[k][q * D + c];
  if (live) Y[g * DD + e] = xv + acc;
}

// Packed index of entry (i, j) of a symmetric D x D matrix held as its
// upper triangle, row by row. Not recursive, so it inlines and folds to a
// constant wherever i and j are unrolled loop indices.
template <int D>
__host__ __device__ constexpr int up(int i, int j) {
  return i <= j ? i * D - i * (i - 1) / 2 + (j - i) : j * D - j * (j - 1) / 2 + (i - j);
}

template <int D>
constexpr int kTri = D * (D + 1) / 2;

// P = A B for symmetric A and B whose product is symmetric (here they
// commute: both are polynomials in one X), upper triangle only. Every loop
// has a constant trip count (the triangle is a test on j >= i), so full
// unrolling leaves constant indices and the arrays in registers.
template <int D>
__device__ __forceinline__ void sym_product(const float (&A)[kTri<D>],
                                            const float (&B)[kTri<D>],
                                            float (&P)[kTri<D>]) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      if (j >= i) {
        float acc = A[up<D>(i, 0)] * B[up<D>(0, j)];
#pragma unroll
        for (int q = 1; q < D; ++q) acc = fmaf(A[up<D>(i, q)], B[up<D>(q, j)], acc);
        P[up<D>(i, j)] = acc;
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kSymBlocks)
ns_sign_apply_registers_kernel(const float* __restrict__ X, float* __restrict__ Y, int m,
                               Schedule sched) {
  constexpr int DD = D * D;
  constexpr int N = kTri<D>;
  __shared__ float stage[kSymBlocks * DD];
  const int t = threadIdx.x;
  const int64_t g0 = (int64_t)blockIdx.x * kSymBlocks;
  const int64_t left = (int64_t)m - g0;
  const int nblk = left < kSymBlocks ? (int)left : kSymBlocks;
  const float* src = X + g0 * DD;
  for (int k = t; k < nblk * DD; k += kSymBlocks) stage[k] = src[k];
  __syncthreads();
  if (t < nblk) {
    float* mine = stage + t * DD;
    float z[N], z2[N], zn[N];
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        if (j >= i) z[up<D>(i, j)] = mine[i * D + j];
      }
    }
    for (int step = 0; step < sched.n; ++step) {
      const float a = static_cast<float>(sched.a[step]);
      const float b = static_cast<float>(sched.b[step]);
      sym_product<D>(z, z, z2);
      sym_product<D>(z2, z, zn);  // (Z Z) Z
#pragma unroll
      for (int k = 0; k < N; ++k) z[k] = a * z[k] - b * zn[k];
    }
    // Y = X + X Z in full, row by row: row i of X goes to registers and
    // row i of Y overwrites it in the stage
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float xr[D];
#pragma unroll
      for (int q = 0; q < D; ++q) xr[q] = mine[i * D + q];
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float acc = xr[0] * z[up<D>(0, j)];
#pragma unroll
        for (int q = 1; q < D; ++q) acc = fmaf(xr[q], z[up<D>(q, j)], acc);
        mine[i * D + j] = xr[j] + acc;
      }
    }
  }
  __syncthreads();
  float* dst = Y + g0 * DD;
  for (int k = t; k < nblk * DD; k += kSymBlocks) dst[k] = stage[k];
}

template <typename T, int D, int BPC>
void launch(const T* X, T* Y, int m, const Schedule& sched, cudaStream_t stream) {
  const int grid = (m + BPC - 1) / BPC;
  ns_sign_apply_kernel<T, D, BPC><<<grid, BPC * D * D, 0, stream>>>(X, Y, m, sched);
}

template <typename T>
int ns_sign_apply(const T* X, T* Y, int m, int d, const double* schedule, int steps,
                  void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (steps < 0 || steps > kMaxSteps) return static_cast<int>(cudaErrorInvalidValue);
  if (d != 9 && d != 18) return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  Schedule sched;
  sched.n = steps;
  for (int i = 0; i < steps; ++i) {
    sched.a[i] = schedule[2 * i];
    sched.b[i] = schedule[2 * i + 1];
  }
  if (d == 18) {
    launch<T, 18, 1>(X, Y, m, sched, stream);
  } else if constexpr (sizeof(T) == sizeof(float)) {
    const int grid = (m + kSymBlocks - 1) / kSymBlocks;
    ns_sign_apply_registers_kernel<9><<<grid, kSymBlocks, 0, stream>>>(X, Y, m, sched);
  } else {
    launch<T, 9, 4>(X, Y, m, sched, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// schedule: host array of `steps` (a, b) pairs, copied into the launch.
extern "C" int smg_ns_sign_apply_f32(const float* X, float* Y, int m, int d,
                                     const double* schedule, int steps, void* stream) {
  return ns_sign_apply<float>(X, Y, m, d, schedule, steps, stream);
}

extern "C" int smg_ns_sign_apply_f64(const double* X, double* Y, int m, int d,
                                     const double* schedule, int steps, void* stream) {
  return ns_sign_apply<double>(X, Y, m, d, schedule, steps, stream);
}

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
//
// The TPU kernel packs 14 (or 7) blocks into one block-diagonal 128 x 128
// tile so that the MXU gets a large matmul, and selects the blocks back
// out with 0/1 einsums. None of that is needed here: one CTA runs BPC
// blocks (4 of 9 x 9, or 1 of 18 x 18: 324 threads either way), one
// thread per output entry. X is read once into shared memory, the 25
// products of the schedule run from shared memory, and Y is written once.
//
// Precision: CUDA cores only, in the working type (f32 or f64), no tensor
// cores and no TF32. The growth cubics amplify rounding of the inputs
// about 700-fold on directions with small eigenvalues; bf16 inputs left
// blocks unprojected (min-eig-rel -0.44) in the reference's own study, and
// TF32's 10-bit mantissa is the same class of error. A later mma-based
// version has to split f32 into 3 x TF32 and be validated again.
//
// Bound: per 9 x 9 block 25 products of 729 FMAs (18K FMAs) for 648 B
// (f32) of traffic, so arithmetic and, above all, latency: each product
// is a chain of d dependent FMAs between barriers, 50 barriers per block.
// At bunny_15K's 31,604 faces that is 7,901 CTAs of 324 threads, enough
// to fill the 132 SMs. Keeping Z in registers with warp shuffles, and
// several blocks per warp, is later work.
//
// Entry points have a plain C interface (loaded with ctypes) and return
// cudaGetLastError() of the launch; they launch on the given stream,
// allocate nothing and do not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSteps = 32;

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
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  Schedule sched;
  sched.n = steps;
  for (int i = 0; i < steps; ++i) {
    sched.a[i] = schedule[2 * i];
    sched.b[i] = schedule[2 * i + 1];
  }
  if (d == 9) launch<T, 9, 4>(X, Y, m, sched, stream);
  else if (d == 18) launch<T, 18, 1>(X, Y, m, sched, stream);
  else return static_cast<int>(cudaErrorInvalidValue);
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

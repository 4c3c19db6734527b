// Fused CSR SpMV with an elementwise epilogue, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels of surface_multigrid_code_tpu/ops/well.py:
//   K1  well_spmv          (:871; bodies diaq_kernel :951, dia_kernel :1025,
//                           tap_kernel :1106, kernel :1173)
//   K2  well_spmv_planes   (:1598; bodies diaq_kernel :1695, dia_kernel :1770,
//                           tap_kernel :1848, kernel :1910)
// What they compute, and all this file computes:  y = epi(A x)  with
//   none:          y = Ax
//   axpby:         y = u + (b - Ax) * (s * escale)
//   resid:         y = b - Ax
//   add:           y = u + Ax
//   resid_scaled:  y = (b - Ax) * (s * escale)
// (the table of ops/well.py:710-753). x, y, u, b are [n, C] row-major
// (C = 1 for K1); s is one value per row, shared by all C columns.
// With `rows`, only rows[t] are computed, and written in place into y:
// the multicolor Gauss-Seidel update, where x, u and y may all be the same
// buffer. That is race-free because no two rows of one color share a
// structural nonzero, so no thread reads an entry another thread of the
// launch writes; hence no __restrict__ on x, u, b, y.
//
// The TPU kernels exist in four layout variants because the TPU has no
// fast gather (windowed ELL, select chains, 1024-row zero-padded tiles).
// On Hopper a gather is a load, so this is plain CSR, one thread per row,
// the row's sum kept in registers and the epilogue applied before the one
// store. Summation runs in CSR order per row, as the plain PyTorch version
// does; the two differ only by FMA contraction.
//
// Bound: about 8 B (f32) / 12 B (f64) of index and value per nonzero, plus
// the x gathers, which mostly hit L2 on a mesh-ordered operator. At ico7
// (164K rows, 1.15M nonzeros in A, 30 MB of f32 operators over all
// levels) the whole hierarchy fits in the 50 MB L2, so launch overhead and
// latency bound a V-cycle; at ico9 (16x larger) HBM bandwidth does. Hub rows (171 nonzeros in a PT row of the constrained
// ogre hierarchy, against ~7 in A) serialise one thread; a warp-per-row
// path for long rows is later work.
//
// Entry points have a plain C interface (loaded with ctypes) and return
// cudaGetLastError() of the launch; they launch on the given stream,
// allocate nothing and do not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Epi { EPI_NONE = 0, EPI_AXPBY = 1, EPI_RESID = 2, EPI_ADD = 3, EPI_RESID_SCALED = 4 };

constexpr int kThreads = 256;
constexpr int kMaxCols = 4;  // columns served by one pass over a row's nonzeros

template <typename T, int EPI, int CB>
__global__ void spmv_fused_kernel(
    const int* __restrict__ indptr, const int* __restrict__ indices,
    const T* __restrict__ data, const T* x, T* y, const T* u, const T* b,
    const T* __restrict__ s, T escale, const int* __restrict__ rows,
    int n, int C, int c0) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int i = rows ? rows[t] : t;
  T acc[CB];
#pragma unroll
  for (int k = 0; k < CB; ++k) acc[k] = T(0);
  const int lo = indptr[i];
  const int hi = indptr[i + 1];
  for (int p = lo; p < hi; ++p) {
    const T a = data[p];
    const T* xr = x + (int64_t)indices[p] * C + c0;
#pragma unroll
    for (int k = 0; k < CB; ++k) acc[k] += a * xr[k];
  }
  T sc = T(0);
  if (EPI == EPI_AXPBY || EPI == EPI_RESID_SCALED) sc = s[i] * escale;
#pragma unroll
  for (int k = 0; k < CB; ++k) {
    const int64_t o = (int64_t)i * C + c0 + k;
    T v;
    if (EPI == EPI_NONE) v = acc[k];
    else if (EPI == EPI_AXPBY) v = u[o] + (b[o] - acc[k]) * sc;
    else if (EPI == EPI_RESID) v = b[o] - acc[k];
    else if (EPI == EPI_ADD) v = u[o] + acc[k];
    else v = (b[o] - acc[k]) * sc;
    y[o] = v;
  }
}

template <typename T, int EPI, int CB>
void launch_one(const int* indptr, const int* indices, const T* data,
                const T* x, T* y, const T* u, const T* b, const T* s,
                double escale, const int* rows, int n, int C, int c0,
                cudaStream_t stream) {
  const int grid = (n + kThreads - 1) / kThreads;
  spmv_fused_kernel<T, EPI, CB><<<grid, kThreads, 0, stream>>>(
      indptr, indices, data, x, y, u, b, s, static_cast<T>(escale), rows,
      n, C, c0);
}

template <typename T, int EPI>
void launch_cols(const int* indptr, const int* indices, const T* data,
                 const T* x, T* y, const T* u, const T* b, const T* s,
                 double escale, const int* rows, int n, int C, int c0,
                 int cb, cudaStream_t stream) {
  switch (cb) {
    case 1: launch_one<T, EPI, 1>(indptr, indices, data, x, y, u, b, s, escale, rows, n, C, c0, stream); break;
    case 2: launch_one<T, EPI, 2>(indptr, indices, data, x, y, u, b, s, escale, rows, n, C, c0, stream); break;
    case 3: launch_one<T, EPI, 3>(indptr, indices, data, x, y, u, b, s, escale, rows, n, C, c0, stream); break;
    default: launch_one<T, EPI, 4>(indptr, indices, data, x, y, u, b, s, escale, rows, n, C, c0, stream); break;
  }
}

// Runs the C columns in passes of up to kMaxCols; each pass reads the
// row's indices and values once for all of its columns.
template <typename T>
int spmv_fused(const int* indptr, const int* indices, const T* data,
               const T* x, T* y, const T* u, const T* b, const T* s,
               double escale, const int* rows, int n, int C, int epi,
               void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  if (epi < EPI_NONE || epi > EPI_RESID_SCALED) return static_cast<int>(cudaErrorInvalidValue);
  for (int c0 = 0; c0 < C; c0 += kMaxCols) {
    const int cb = (C - c0 < kMaxCols) ? (C - c0) : kMaxCols;
    switch (epi) {
      case EPI_NONE: launch_cols<T, EPI_NONE>(indptr, indices, data, x, y, u, b, s, escale, rows, n, C, c0, cb, stream); break;
      case EPI_AXPBY: launch_cols<T, EPI_AXPBY>(indptr, indices, data, x, y, u, b, s, escale, rows, n, C, c0, cb, stream); break;
      case EPI_RESID: launch_cols<T, EPI_RESID>(indptr, indices, data, x, y, u, b, s, escale, rows, n, C, c0, cb, stream); break;
      case EPI_ADD: launch_cols<T, EPI_ADD>(indptr, indices, data, x, y, u, b, s, escale, rows, n, C, c0, cb, stream); break;
      default: launch_cols<T, EPI_RESID_SCALED>(indptr, indices, data, x, y, u, b, s, escale, rows, n, C, c0, cb, stream); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1: one column.
extern "C" int smg_spmv_fused_f32(const int* indptr, const int* indices, const float* data,
                                  const float* x, float* y, const float* u, const float* b,
                                  const float* s, double escale, const int* rows, int n,
                                  int epi, void* stream) {
  return spmv_fused<float>(indptr, indices, data, x, y, u, b, s, escale, rows, n, 1, epi, stream);
}

extern "C" int smg_spmv_fused_f64(const int* indptr, const int* indices, const double* data,
                                  const double* x, double* y, const double* u, const double* b,
                                  const double* s, double escale, const int* rows, int n,
                                  int epi, void* stream) {
  return spmv_fused<double>(indptr, indices, data, x, y, u, b, s, escale, rows, n, 1, epi, stream);
}

// K2: C columns, x/y/u/b row-major [n, C].
extern "C" int smg_spmv_fused_planes_f32(const int* indptr, const int* indices, const float* data,
                                         const float* x, float* y, const float* u, const float* b,
                                         const float* s, double escale, const int* rows, int n,
                                         int C, int epi, void* stream) {
  return spmv_fused<float>(indptr, indices, data, x, y, u, b, s, escale, rows, n, C, epi, stream);
}

extern "C" int smg_spmv_fused_planes_f64(const int* indptr, const int* indices, const double* data,
                                         const double* x, double* y, const double* u, const double* b,
                                         const double* s, double escale, const int* rows, int n,
                                         int C, int epi, void* stream) {
  return spmv_fused<double>(indptr, indices, data, x, y, u, b, s, escale, rows, n, C, epi, stream);
}

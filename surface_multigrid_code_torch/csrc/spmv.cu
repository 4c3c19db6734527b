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
// With `rows`, only rows[t] are computed and written into y: the
// multicolor Gauss-Seidel update, where x, u and y may all be the same
// buffer (hence no __restrict__ on them).
//
// The TPU kernels exist in four layout variants because the TPU has no
// fast gather (windowed ELL, select chains, 1024-row zero-padded tiles).
// On Hopper a gather is a load, so this is plain CSR.
//
// Design: a sub-warp of L lanes per row, L in {1, 2, 4, 8, 16, 32}, so
// 256 / L rows per CTA. Lane k reads nonzeros lo+k, lo+k+L, ...:
// neighbouring lanes read neighbouring indices and values, which coalesce,
// and a row's gathers of x are in flight together instead of one dependent
// load after another (a 27-nonzero Galerkin row is one step of 32 lanes, a
// 171-wide hub row of constrained ogre's PT 11 steps of 16). The partial
// sums meet in a tree of __shfl_down_sync of width L (one per column,
// CB <= kMaxCols columns per pass over the row), and the row's first lane
// applies the epilogue and stores. Summation is therefore a tree per row,
// not CSR order as in the plain PyTorch version; the two differ by
// rounding only. L is a template parameter: with L a runtime value (shifts
// for the stride, the rows per CTA and the shuffle width) the kernel took
// 2-12% longer at 15 of the 17 L > 1 shapes of the static path, and at
// L = 1 this body runs as fast as a plain one-thread-per-row loop
// (kernel_ab.py spmv, H100).
//
// L is chosen on the host, from shapes only: per operator the smallest
// power of two at or above the mean row length, at most 32
// (ops/sparse.row_lanes), then per launch halved while the launched rows
// times L exceed the threads the card holds at once (ops/spmv.launch_lanes).
// Without that cap a large operator gets about one
// lane per nonzero: ico7's level-0 A at L = 8 is 1.3M threads, five waves
// of the card, each wave a chain of dependent loads (indptr, indices, x),
// and took 7.1 us where one thread per row took 4.0 (H100). Capped, the
// large launches run in one wave with each lane walking several nonzeros
// (unrolled, so their loads overlap), and the small ones, a Galerkin level
// or a GS color of a few thousand rows, keep a lane per nonzero.
//
// Shuffles take the full warp mask, so every lane of a warp that holds a
// row reaches them: lanes past the last row (the ragged last warp) carry
// an empty range and zero partials, and only warps with no row at all
// leave early. A row with no nonzeros stores epi(0). Offsets into x are
// 64-bit (indices[p] * C can pass 2^31).
//
// In-place Gauss-Seidel (x, u and y one buffer, `rows` one color): the
// leader lane writes y[i] only after the shuffle reduction, that is, after
// every lane of row i has loaded its entries of x; and no other row j of
// the color reads x[i] or writes an entry row i reads, because two rows of
// one color share no structural nonzero. So no launch reads an entry that
// it also writes, whatever the order in which its rows run.
//
// Bound: about 8 B (f32) / 12 B (f64) of index and value per nonzero plus
// the x gathers and the row's vectors: 2 FLOP per 8-12 B, far below the
// ~20 FLOP/B at which the card's CUDA cores, let alone its tensor cores,
// would limit. The gathers are irregular, so TMA tiles and wgmma do not
// apply, and no tensor core is used. ico7's level-0 A moves 13.1 MB, 3.9
// us at the 3.35 TB/s of HBM; the whole ico7 hierarchy fits in the 50 MB
// L2, so on the V-cycle those bytes come from L2 and HBM is not the limit
// the kernel meets (with the L2 flushed before each call it takes 7.1 us,
// kernel_ab.py spmv, H100). A Galerkin level or a GS color moves 0.04-7 MB,
// under the ~2 us launch floor, and is latency-bound: what this design
// attacks is the chain of dependent loads per row.
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

template <typename T, int EPI, int CB, int L>
__global__ void __launch_bounds__(kThreads) spmv_fused_kernel(
    const int* __restrict__ indptr, const int* __restrict__ indices,
    const T* __restrict__ data, const T* x, T* y, const T* u, const T* b,
    const T* __restrict__ s, T escale, const int* __restrict__ rows,
    int n, int C, int c0) {
  constexpr int kRows = kThreads / L;  // rows per CTA
  const int base = blockIdx.x * kRows;
  const int lane = threadIdx.x % L;
  const int t = base + threadIdx.x / L;
  // A warp whose first row is past the end has no row: it leaves whole.
  if (base + (int)(threadIdx.x / 32) * (32 / L) >= n) return;
  const bool active = t < n;
  int i = 0, lo = 0, hi = 0;
  if (active) {
    i = rows ? rows[t] : t;
    lo = indptr[i];
    hi = indptr[i + 1];
  }
  T acc[CB];
#pragma unroll
  for (int k = 0; k < CB; ++k) acc[k] = T(0);
#pragma unroll 4
  for (int p = lo + lane; p < hi; p += L) {
    const T a = data[p];
    const T* xr = x + (int64_t)indices[p] * C + c0;
#pragma unroll
    for (int k = 0; k < CB; ++k) acc[k] += a * xr[k];
  }
#pragma unroll
  for (int off = L / 2; off > 0; off /= 2) {
#pragma unroll
    for (int k = 0; k < CB; ++k) acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off, L);
  }
  if (!active || lane != 0) return;
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

template <typename T>
struct Args {
  const int* indptr;
  const int* indices;
  const T* data;
  const T* x;
  T* y;
  const T* u;
  const T* b;
  const T* s;
  double escale;
  const int* rows;
  int n;
  int C;
};

template <typename T, int EPI, int CB, int L>
void launch_one(const Args<T>& a, int c0, cudaStream_t stream) {
  constexpr int kRows = kThreads / L;
  const int grid = (int)(((int64_t)a.n + kRows - 1) / kRows);
  spmv_fused_kernel<T, EPI, CB, L><<<grid, kThreads, 0, stream>>>(
      a.indptr, a.indices, a.data, a.x, a.y, a.u, a.b, a.s,
      static_cast<T>(a.escale), a.rows, a.n, a.C, c0);
}

template <typename T, int EPI, int CB>
void launch_lanes(const Args<T>& a, int c0, int lanes, cudaStream_t stream) {
  switch (lanes) {
    case 1: launch_one<T, EPI, CB, 1>(a, c0, stream); break;
    case 2: launch_one<T, EPI, CB, 2>(a, c0, stream); break;
    case 4: launch_one<T, EPI, CB, 4>(a, c0, stream); break;
    case 8: launch_one<T, EPI, CB, 8>(a, c0, stream); break;
    case 16: launch_one<T, EPI, CB, 16>(a, c0, stream); break;
    default: launch_one<T, EPI, CB, 32>(a, c0, stream); break;
  }
}

template <typename T, int EPI>
void launch_cols(const Args<T>& a, int c0, int cb, int lanes, cudaStream_t stream) {
  switch (cb) {
    case 1: launch_lanes<T, EPI, 1>(a, c0, lanes, stream); break;
    case 2: launch_lanes<T, EPI, 2>(a, c0, lanes, stream); break;
    case 3: launch_lanes<T, EPI, 3>(a, c0, lanes, stream); break;
    default: launch_lanes<T, EPI, 4>(a, c0, lanes, stream); break;
  }
}

// Runs the C columns in passes of up to kMaxCols; each pass reads the
// row's indices and values once for all of its columns.
template <typename T>
int spmv_fused(const Args<T>& a, int lanes, int epi, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (a.n <= 0 || a.C <= 0) return static_cast<int>(cudaGetLastError());
  if (epi < EPI_NONE || epi > EPI_RESID_SCALED) return static_cast<int>(cudaErrorInvalidValue);
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int c0 = 0; c0 < a.C; c0 += kMaxCols) {
    const int cb = (a.C - c0 < kMaxCols) ? (a.C - c0) : kMaxCols;
    switch (epi) {
      case EPI_NONE: launch_cols<T, EPI_NONE>(a, c0, cb, lanes, stream); break;
      case EPI_AXPBY: launch_cols<T, EPI_AXPBY>(a, c0, cb, lanes, stream); break;
      case EPI_RESID: launch_cols<T, EPI_RESID>(a, c0, cb, lanes, stream); break;
      case EPI_ADD: launch_cols<T, EPI_ADD>(a, c0, cb, lanes, stream); break;
      default: launch_cols<T, EPI_RESID_SCALED>(a, c0, cb, lanes, stream); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1: one column. `lanes` is the launch's sub-warp width (1..32, a power of two).
extern "C" int smg_spmv_fused_f32(const int* indptr, const int* indices, const float* data,
                                  const float* x, float* y, const float* u, const float* b,
                                  const float* s, double escale, const int* rows, int n,
                                  int lanes, int epi, void* stream) {
  const Args<float> a{indptr, indices, data, x, y, u, b, s, escale, rows, n, 1};
  return spmv_fused<float>(a, lanes, epi, stream);
}

extern "C" int smg_spmv_fused_f64(const int* indptr, const int* indices, const double* data,
                                  const double* x, double* y, const double* u, const double* b,
                                  const double* s, double escale, const int* rows, int n,
                                  int lanes, int epi, void* stream) {
  const Args<double> a{indptr, indices, data, x, y, u, b, s, escale, rows, n, 1};
  return spmv_fused<double>(a, lanes, epi, stream);
}

// K2: C columns, x/y/u/b row-major [n, C].
extern "C" int smg_spmv_fused_planes_f32(const int* indptr, const int* indices, const float* data,
                                         const float* x, float* y, const float* u, const float* b,
                                         const float* s, double escale, const int* rows, int n,
                                         int C, int lanes, int epi, void* stream) {
  const Args<float> a{indptr, indices, data, x, y, u, b, s, escale, rows, n, C};
  return spmv_fused<float>(a, lanes, epi, stream);
}

extern "C" int smg_spmv_fused_planes_f64(const int* indptr, const int* indices, const double* data,
                                         const double* x, double* y, const double* u, const double* b,
                                         const double* s, double escale, const int* rows, int n,
                                         int C, int lanes, int epi, void* stream) {
  const Args<double> a{indptr, indices, data, x, y, u, b, s, escale, rows, n, C};
  return spmv_fused<double>(a, lanes, epi, stream);
}

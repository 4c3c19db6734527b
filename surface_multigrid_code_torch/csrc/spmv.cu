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
// On Hopper a gather is a load, so this is plain CSR. The kernel template
// is in spmv_fused.cuh; this file holds the production instantiations.
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

#include "spmv_fused.cuh"  // the kernel template, shared with spmv_probe.cu

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

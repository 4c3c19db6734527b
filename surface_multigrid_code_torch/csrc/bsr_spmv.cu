// K3: 3x3-block CSR SpMV with an elementwise epilogue, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel surface_multigrid_code_tpu/ops/well.py:1222
// well_spmv_block3 (via _well_spmv_block3_impl :1255; bodies tap_kernel
// :1331, dia_kernel :1399, kernel :1474; host wrapper well_block3_apply :1535).
// What it computes, and all this file computes:
//   Ax_i = sum_j A_ij x_j   (A_ij a 3x3 block on the vertex graph)
//   y = epi(Ax) with the epilogue table of ops/well.py:710-753:
//     none:          y = Ax
//     axpby:         y = u + (b - Ax) * (s * escale)
//     resid:         y = b - Ax
//     add:           y = u + Ax
//     resid_scaled:  y = (b - Ax) * (s * escale)
// x, y, u, b are [n, 3] row-major; unlike K1/K2 the scale s is per
// component, [n, 3] (_EPI_KINDS_B3, ops/well.py:727-730): the Jacobi and
// Chebyshev smoothers scale by the inverse of the block diagonal's three
// scalar entries.
//
// The TPU kernel resolves a windowed select chain once and shares it over
// the 9 block components and 3 planes, chains partial sums over slot
// groups (acc) and pads the diagonal scale to 1024-row planes: all of that
// exists because the TPU has no fast gather. On Hopper a gather is a load,
// so this is plain BSR-CSR, one thread per vertex row: the thread walks
// its row's blocks (36 B / 72 B contiguous each), loads the x_j 3-vectors,
// keeps three sums in registers and applies the epilogue before its three
// stores. Per block the three row products are summed in column order and
// then added to the row sums in CSR order, as the plain PyTorch version
// (ops/bsr_spmv.fused_bsr_spmv_plain) does; the two differ only by FMA
// contraction and the plain version's own product order.
//
// Bound: per block 36 B (f32) / 72 B (f64) of values plus 4 B of index and
// the x_j gather (12 B, mostly L2 hits on a mesh-ordered vertex graph): 18
// FMAs for ~52 B, far below the card's FLOP/byte balance, so memory bound.
// At bunny_15K level 0 (15,804 rows, ~110K blocks, ~4.5 MB of f32 values)
// the operator sits in the 50 MB L2 and one launch is latency-bound: 62
// CTAs of 256 threads cover under half of the 132 SMs. A warp per row, or
// several rows per warp with the blocks read as coalesced 16-byte vectors,
// is later work.
//
// Entry points have a plain C interface (loaded with ctypes) and return
// cudaGetLastError() of the launch; they launch on the given stream,
// allocate nothing and do not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Epi { EPI_NONE = 0, EPI_AXPBY = 1, EPI_RESID = 2, EPI_ADD = 3, EPI_RESID_SCALED = 4 };

constexpr int kThreads = 256;

template <typename T, int EPI>
__global__ void bsr_spmv_kernel(
    const int* __restrict__ indptr, const int* __restrict__ indices,
    const T* __restrict__ blocks, const T* __restrict__ x, T* __restrict__ y,
    const T* __restrict__ u, const T* __restrict__ b, const T* __restrict__ s,
    T escale, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T acc0 = T(0), acc1 = T(0), acc2 = T(0);
  const int lo = indptr[i];
  const int hi = indptr[i + 1];
  for (int p = lo; p < hi; ++p) {
    const T* B = blocks + (int64_t)p * 9;
    const T* xj = x + (int64_t)indices[p] * 3;
    const T x0 = xj[0], x1 = xj[1], x2 = xj[2];
    acc0 += B[0] * x0 + B[1] * x1 + B[2] * x2;
    acc1 += B[3] * x0 + B[4] * x1 + B[5] * x2;
    acc2 += B[6] * x0 + B[7] * x1 + B[8] * x2;
  }
  const T acc[3] = {acc0, acc1, acc2};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int64_t o = (int64_t)i * 3 + c;
    T v;
    if (EPI == EPI_NONE) v = acc[c];
    else if (EPI == EPI_AXPBY) v = u[o] + (b[o] - acc[c]) * (s[o] * escale);
    else if (EPI == EPI_RESID) v = b[o] - acc[c];
    else if (EPI == EPI_ADD) v = u[o] + acc[c];
    else v = (b[o] - acc[c]) * (s[o] * escale);
    y[o] = v;
  }
}

template <typename T, int EPI>
void launch(const int* indptr, const int* indices, const T* blocks, const T* x,
            T* y, const T* u, const T* b, const T* s, double escale, int n,
            cudaStream_t stream) {
  const int grid = (n + kThreads - 1) / kThreads;
  bsr_spmv_kernel<T, EPI><<<grid, kThreads, 0, stream>>>(
      indptr, indices, blocks, x, y, u, b, s, static_cast<T>(escale), n);
}

template <typename T>
int bsr_spmv(const int* indptr, const int* indices, const T* blocks, const T* x,
             T* y, const T* u, const T* b, const T* s, double escale, int n,
             int epi, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  switch (epi) {
    case EPI_NONE: launch<T, EPI_NONE>(indptr, indices, blocks, x, y, u, b, s, escale, n, stream); break;
    case EPI_AXPBY: launch<T, EPI_AXPBY>(indptr, indices, blocks, x, y, u, b, s, escale, n, stream); break;
    case EPI_RESID: launch<T, EPI_RESID>(indptr, indices, blocks, x, y, u, b, s, escale, n, stream); break;
    case EPI_ADD: launch<T, EPI_ADD>(indptr, indices, blocks, x, y, u, b, s, escale, n, stream); break;
    case EPI_RESID_SCALED: launch<T, EPI_RESID_SCALED>(indptr, indices, blocks, x, y, u, b, s, escale, n, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int smg_bsr_spmv_f32(const int* indptr, const int* indices, const float* blocks,
                                const float* x, float* y, const float* u, const float* b,
                                const float* s, double escale, int n, int epi, void* stream) {
  return bsr_spmv<float>(indptr, indices, blocks, x, y, u, b, s, escale, n, epi, stream);
}

extern "C" int smg_bsr_spmv_f64(const int* indptr, const int* indices, const double* blocks,
                                const double* x, double* y, const double* u, const double* b,
                                const double* s, double escale, int n, int epi, void* stream) {
  return bsr_spmv<double>(indptr, indices, blocks, x, y, u, b, s, escale, n, epi, stream);
}

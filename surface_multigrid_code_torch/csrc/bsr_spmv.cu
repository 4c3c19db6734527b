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
// so this is plain BSR-CSR.
//
// Design: a sub-warp of L lanes per block row, L in {1, 2, 4, 8, 16, 32}
// (the design of K1 in spmv.cu, over block rows), so 256 / L rows per
// CTA. Lane k takes blocks lo+k, lo+k+L, ... of its row: it loads each
// block's 9 values (36 B / 72 B contiguous, neighbouring lanes on
// neighbouring blocks) and its index, gathers the x_j 3-vector, and keeps
// the three row sums in registers; a row's gathers are in flight together
// instead of one dependent load after another (a 26-block Galerkin row is
// one step of 32 lanes). The sub-warp sums the three partial sums in a
// __shfl_xor_sync tree of width L, so every lane then holds the row's
// sums: lane k applies the epilogue to components k, k + L, ... below 3
// and stores them, so lanes 0-2 of each row write its three contiguous
// values. Per block the three row products are summed in column order;
// the row's blocks are summed as a tree, not in CSR order as the plain
// PyTorch version (ops/bsr_spmv.fused_bsr_spmv_plain) sums them: the two
// differ by rounding only. L is a template parameter, as in spmv.cu, where
// a runtime L measured 2-12% slower.
//
// Measured against this design (kernel_ab.py bsr, H100, bunny_15K levels 0-3,
// f32): staging each warp's contiguous block range through shared memory
// with coalesced loads was 4-40% slower (the stage adds a dependent
// shared-memory round trip and two __syncwarp per 32 blocks to a launch
// whose time is latency); three float4 loads per block from its 16-byte
// boundary were no faster; the epilogue's operands loaded before the
// blocks were no faster than after the reduction. Half the lanes below
// was 6% faster at level 0 (L = 4) and up to 11% slower at the Galerkin
// levels (L = 16), so the rule below is kept.
//
// L is chosen on the host from shapes only: BSRMatrix.lanes
// (ops/sparse.row_lanes, the smallest power of two at or above the mean
// blocks per row, at most 32), halved per launch while rows x L exceed
// the threads the card holds at once (ops/spmv.launch_lanes). bunny_15K's
// level-0 Hessian (7.0 blocks a row) runs at L = 8, 126K threads in one
// wave; its Galerkin levels (17.8 to 26.2 blocks a row, up to 47) at 32.
//
// Shuffles take the full warp mask, so every lane of a warp that holds a
// row reaches them: lanes past the last row (the ragged last warp) carry
// an empty range and zero partials, and only warps with no row at all
// leave early. A row with no blocks stores epi(0). Offsets into x and the
// blocks are 64-bit.
//
// Bound: per block 36 B (f32) / 72 B (f64) of values plus 4 B of index and
// the x_j gather, for 18 FMAs: far below the card's FLOP/byte balance, so
// memory bound, and no tensor core is used. At bunny_15K level 0 (15,804
// rows, ~110K blocks, ~5.2 MB) the operator sits in the 50 MB L2, and one
// launch is short enough that its chain of dependent loads (indptr, the
// blocks and indices, the x gather) and the launch itself set its time.
//
// Entry points have a plain C interface (loaded with ctypes) and return
// cudaGetLastError() of the launch; they launch on the given stream,
// allocate nothing and do not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Epi { EPI_NONE = 0, EPI_AXPBY = 1, EPI_RESID = 2, EPI_ADD = 3, EPI_RESID_SCALED = 4 };

constexpr int kThreads = 256;

template <typename T, int EPI, int L>
__global__ void __launch_bounds__(kThreads) bsr_spmv_kernel(
    const int* __restrict__ indptr, const int* __restrict__ indices,
    const T* __restrict__ blocks, const T* __restrict__ x, T* __restrict__ y,
    const T* __restrict__ u, const T* __restrict__ b, const T* __restrict__ s,
    T escale, int n) {
  constexpr int kRows = kThreads / L;  // rows per CTA
  constexpr int K = (3 + L - 1) / L;   // components each lane stores
  const int base = blockIdx.x * kRows;
  const int lane = threadIdx.x % L;
  const int t = base + threadIdx.x / L;
  // A warp whose first row is past the end has no row: it leaves whole.
  if (base + (int)(threadIdx.x / 32) * (32 / L) >= n) return;
  const bool active = t < n;
  int lo = 0, hi = 0;
  if (active) {
    lo = indptr[t];
    hi = indptr[t + 1];
  }
  T acc0 = T(0), acc1 = T(0), acc2 = T(0);
#pragma unroll 2
  for (int p = lo + lane; p < hi; p += L) {
    const T* B = blocks + (int64_t)p * 9;
    const T* xj = x + (int64_t)indices[p] * 3;
    const T x0 = xj[0], x1 = xj[1], x2 = xj[2];
    acc0 += B[0] * x0 + B[1] * x1 + B[2] * x2;
    acc1 += B[3] * x0 + B[4] * x1 + B[5] * x2;
    acc2 += B[6] * x0 + B[7] * x1 + B[8] * x2;
  }
#pragma unroll
  for (int off = L / 2; off > 0; off /= 2) {
    acc0 += __shfl_xor_sync(0xffffffffu, acc0, off, L);
    acc1 += __shfl_xor_sync(0xffffffffu, acc1, off, L);
    acc2 += __shfl_xor_sync(0xffffffffu, acc2, off, L);
  }
  // every lane holds the row's sums; this one stores components lane, lane + L, ...
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = lane + k * L;
    if (!active || c >= 3) continue;
    const T ax = c == 0 ? acc0 : (c == 1 ? acc1 : acc2);
    const int64_t o = (int64_t)t * 3 + c;
    T v;
    if (EPI == EPI_NONE) v = ax;
    else if (EPI == EPI_AXPBY) v = u[o] + (b[o] - ax) * (s[o] * escale);
    else if (EPI == EPI_RESID) v = b[o] - ax;
    else if (EPI == EPI_ADD) v = u[o] + ax;
    else v = (b[o] - ax) * (s[o] * escale);
    y[o] = v;
  }
}

template <typename T>
struct Args {
  const int* indptr;
  const int* indices;
  const T* blocks;
  const T* x;
  T* y;
  const T* u;
  const T* b;
  const T* s;
  double escale;
  int n;
};

template <typename T, int EPI, int L>
void launch_one(const Args<T>& a, cudaStream_t stream) {
  constexpr int kRows = kThreads / L;
  const int grid = (int)(((int64_t)a.n + kRows - 1) / kRows);
  bsr_spmv_kernel<T, EPI, L><<<grid, kThreads, 0, stream>>>(
      a.indptr, a.indices, a.blocks, a.x, a.y, a.u, a.b, a.s,
      static_cast<T>(a.escale), a.n);
}

template <typename T, int EPI>
void launch_lanes(const Args<T>& a, int lanes, cudaStream_t stream) {
  switch (lanes) {
    case 1: launch_one<T, EPI, 1>(a, stream); break;
    case 2: launch_one<T, EPI, 2>(a, stream); break;
    case 4: launch_one<T, EPI, 4>(a, stream); break;
    case 8: launch_one<T, EPI, 8>(a, stream); break;
    case 16: launch_one<T, EPI, 16>(a, stream); break;
    default: launch_one<T, EPI, 32>(a, stream); break;
  }
}

template <typename T>
int bsr_spmv(const Args<T>& a, int lanes, int epi, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (a.n <= 0) return static_cast<int>(cudaGetLastError());
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (epi) {
    case EPI_NONE: launch_lanes<T, EPI_NONE>(a, lanes, stream); break;
    case EPI_AXPBY: launch_lanes<T, EPI_AXPBY>(a, lanes, stream); break;
    case EPI_RESID: launch_lanes<T, EPI_RESID>(a, lanes, stream); break;
    case EPI_ADD: launch_lanes<T, EPI_ADD>(a, lanes, stream); break;
    case EPI_RESID_SCALED: launch_lanes<T, EPI_RESID_SCALED>(a, lanes, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `lanes` is the launch's sub-warp width per block row (1..32, a power of two).
extern "C" int smg_bsr_spmv_f32(const int* indptr, const int* indices, const float* blocks,
                                const float* x, float* y, const float* u, const float* b,
                                const float* s, double escale, int n, int lanes, int epi,
                                void* stream) {
  const Args<float> a{indptr, indices, blocks, x, y, u, b, s, escale, n};
  return bsr_spmv<float>(a, lanes, epi, stream);
}

extern "C" int smg_bsr_spmv_f64(const int* indptr, const int* indices, const double* blocks,
                                const double* x, double* y, const double* u, const double* b,
                                const double* s, double escale, int n, int lanes, int epi,
                                void* stream) {
  const Args<double> a{indptr, indices, blocks, x, y, u, b, s, escale, n};
  return bsr_spmv<double>(a, lanes, epi, stream);
}

// The template of K1/K2, the fused CSR SpMV with an elementwise epilogue.
//
// Its design, bound and the TPU kernels it replaces are in spmv.cu, which
// instantiates it for the production paths (values and vectors of one
// type, float or double). spmv_probe.cu instantiates it once more with
// bfloat16 values and float vectors (V apart from T). With V == T every
// load and every operation is the one the production kernels had before
// V existed: widen() is the identity there.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Epi { EPI_NONE = 0, EPI_AXPBY = 1, EPI_RESID = 2, EPI_ADD = 3, EPI_RESID_SCALED = 4 };

constexpr int kThreads = 256;
constexpr int kMaxCols = 4;  // columns served by one pass over a row's nonzeros

// A stored value in the vectors' type T.
template <typename T>
__device__ __forceinline__ T widen(T v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int EPI, int CB, int L, typename V = T>
__global__ void __launch_bounds__(kThreads) spmv_fused_kernel(
    const int* __restrict__ indptr, const int* __restrict__ indices,
    const V* __restrict__ data, const T* x, T* y, const T* u, const T* b,
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
    const T a = widen(data[p]);
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

template <typename T, typename V = T>
struct Args {
  const int* indptr;
  const int* indices;
  const V* data;
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

template <typename T, int EPI, int CB, int L, typename V>
void launch_one(const Args<T, V>& a, int c0, cudaStream_t stream) {
  constexpr int kRows = kThreads / L;
  const int grid = (int)(((int64_t)a.n + kRows - 1) / kRows);
  spmv_fused_kernel<T, EPI, CB, L, V><<<grid, kThreads, 0, stream>>>(
      a.indptr, a.indices, a.data, a.x, a.y, a.u, a.b, a.s,
      static_cast<T>(a.escale), a.rows, a.n, a.C, c0);
}

template <typename T, int EPI, int CB, typename V>
void launch_lanes(const Args<T, V>& a, int c0, int lanes, cudaStream_t stream) {
  switch (lanes) {
    case 1: launch_one<T, EPI, CB, 1>(a, c0, stream); break;
    case 2: launch_one<T, EPI, CB, 2>(a, c0, stream); break;
    case 4: launch_one<T, EPI, CB, 4>(a, c0, stream); break;
    case 8: launch_one<T, EPI, CB, 8>(a, c0, stream); break;
    case 16: launch_one<T, EPI, CB, 16>(a, c0, stream); break;
    default: launch_one<T, EPI, CB, 32>(a, c0, stream); break;
  }
}

template <typename T, int EPI, typename V>
void launch_cols(const Args<T, V>& a, int c0, int cb, int lanes, cudaStream_t stream) {
  switch (cb) {
    case 1: launch_lanes<T, EPI, 1>(a, c0, lanes, stream); break;
    case 2: launch_lanes<T, EPI, 2>(a, c0, lanes, stream); break;
    case 3: launch_lanes<T, EPI, 3>(a, c0, lanes, stream); break;
    default: launch_lanes<T, EPI, 4>(a, c0, lanes, stream); break;
  }
}

// Runs the C columns in passes of up to kMaxCols; each pass reads the
// row's indices and values once for all of its columns.
template <typename T, typename V = T>
int spmv_fused(const Args<T, V>& a, int lanes, int epi, void* stream_ptr) {
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

// Three measurements of K1's byte question, for Hopper (sm_90a), on no path
// of the port: probes/bf16_values.py, probes/staged_spmv.py and
// probes/band_spmv.py run them. Each computes what K1 computes on the
// finest operator of the V-cycle (csrc/spmv.cu: y = u + (b - A x) (s escale),
// the Jacobi sweep; the band kernel y = A X), with fewer bytes or another
// route for x.
//
// 1. K1 with bfloat16 values (smg_spmv_bf16v_f32). Replaces the TPU Pallas
//    probe benchmarks/probes/probe_bf16_chain.py:34 make_chain (pallas_call
//    :55), which timed the windowed kernel's select chain on f32 8-row
//    against bf16 16-row tiles. The select chain is a TPU layout and is
//    not carried; what is left of the question is the value type. This is
//    K1's own template (spmv_fused.cuh) with V = __nv_bfloat16: the values
//    take 2 B a nonzero instead of 4, x, the sums and y stay f32. Bound:
//    bytes, 6 B a nonzero of index and value against K1's 8.
//
// 2. K1 with the x window staged in shared memory (smg_spmv_staged_f32,
//    spmv_staged_kernel). Replaces benchmarks/probes/probe_dbuf.py:33 main
//    (pallas_call :141), well_spmv's dia mode with its x-window copy
//    double-buffered. Each CTA walks chunks of `chunk_rows` consecutive
//    rows (a grid-stride loop, persistent CTAs). The host gives each
//    chunk's x window [win_lo, win_hi] (its least and largest column);
//    under the RCM ordering the window is contiguous and short. The CTA
//    copies the next chunk's window into one of two shared-memory buffers
//    with cp.async (16 B a copy where aligned, 4 B at the ends) while it
//    computes the current chunk from the other, then gathers x from shared
//    memory: a sub-warp of L lanes a row, as in K1. A chunk whose window
//    exceeds a buffer (`window` floats) is not staged and gathers x from
//    global memory: a branch of the design, which the host counts. Bound:
//    K1's bytes (each input once); the staging reads each window once per
//    chunk from the L2 or HBM, more than the x the chunk gathers.
//
// 3. The band on tensor cores (smg_band_spmv_tc, band_spmv_tc_kernel).
//    Replaces benchmarks/probes/probe_mxu_band.py:44 main (pallas_call
//    :129): SpMV as a dense band times a contiguous x window on the MXU.
//    Layout (built on the host, probes/band_spmv.py): row blocks of
//    kBandRows rows; block r's window starts at start[r] (its least
//    column); the band is [blocks x kBandRows, W] with entry (i, c) the
//    value of A at (i, start + c), zero elsewhere; W is the largest span
//    rounded up to kBandK. Y [n, nc] = band x X[start : start + W, :nc].
//    Eight warps a CTA, each two 16-row tiles; per kBandK window rows the
//    CTA stages X's rows into shared memory (zero past X's last row and
//    past column nc), and each warp runs mma.sync: m16n8k16 bf16 (band in
//    bf16, x rounded to bf16) or m16n8k8 TF32 (band in f32, both rounded
//    to TF32 with cvt.rna), f32 accumulation. Bound: the band's bytes
//    (rows x W x 2 or 4 B) and X's and Y's, against its operations at the
//    tensor cores' dense peak (989 TFLOP/s bf16, 495 TF32): bytes. What it
//    moves is rows x W, against K1's ~8 B a nonzero: W / 7 times more for
//    a 7-nonzero row, so it can only win where many columns share a band.
//
// Entry points have a plain C interface (loaded with ctypes) and return
// cudaGetLastError() of the launch; they launch on the given stream,
// allocate nothing and do not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "spmv_fused.cuh"

namespace {

// ------------------------------------------------------------- staged x

constexpr int kStagedThreads = 512;

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// The window of x that a chunk gathers, from x + lo4 (lo rounded down to
// 4 floats, so the 16 B copies are aligned); nothing for a wide chunk.
__device__ __forceinline__ void stage_window(float* dst, const float* __restrict__ x,
                                             int lo, int hi, int window) {
  const int lo4 = lo & ~3;
  const int count = hi + 1 - lo4;
  if (count > window) return;
  const int nvec = count / 4;
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) cp_async16(dst + 4 * v, x + lo4 + 4 * v);
  for (int e = 4 * nvec + threadIdx.x; e < count; e += blockDim.x) cp_async4(dst + e, x + lo4 + e);
}

template <int L>
__global__ void __launch_bounds__(kStagedThreads) spmv_staged_kernel(
    const int* __restrict__ indptr, const int* __restrict__ indices,
    const float* __restrict__ data, const float* __restrict__ x, float* __restrict__ y,
    const float* __restrict__ u, const float* __restrict__ b, const float* __restrict__ s,
    float escale, const int* __restrict__ win_lo, const int* __restrict__ win_hi, int n,
    int chunk_rows, int n_chunks, int window) {
  extern __shared__ float4 smem4[];
  float* const buf0 = reinterpret_cast<float*>(smem4);
  float* const buf1 = buf0 + window;
  constexpr int kSlots = kStagedThreads / L;  // rows in flight per CTA
  const int lane = threadIdx.x % L;
  int c = blockIdx.x;
  if (c < n_chunks) stage_window(buf0, x, win_lo[c], win_hi[c], window);
  cp_async_commit();
  for (int it = 0; c < n_chunks; ++it, c += gridDim.x) {
    const int cn = c + gridDim.x;
    if (cn < n_chunks) stage_window(it & 1 ? buf0 : buf1, x, win_lo[cn], win_hi[cn], window);
    cp_async_commit();
    cp_async_wait_one();  // every group but the newest, this chunk's, has landed
    __syncthreads();
    const float* w = it & 1 ? buf1 : buf0;
    const int lo4 = win_lo[c] & ~3;
    const bool wide = win_hi[c] + 1 - lo4 > window;
    const int r0 = c * chunk_rows;
    const int r1 = min(n, r0 + chunk_rows);
    for (int base = r0; base < r1; base += kSlots) {
      const int i = base + threadIdx.x / L;
      const bool active = i < r1;
      float acc = 0.f;
      if (active) {
        const int hi = indptr[i + 1];
#pragma unroll 4
        for (int p = indptr[i] + lane; p < hi; p += L) {
          const int col = indices[p];
          acc += data[p] * (wide ? x[col] : w[col - lo4]);
        }
      }
#pragma unroll
      for (int off = L / 2; off > 0; off /= 2) acc += __shfl_down_sync(0xffffffffu, acc, off, L);
      if (active && lane == 0) y[i] = u[i] + (b[i] - acc) * (s[i] * escale);
    }
    __syncthreads();  // the buffer is free for the chunk after next
  }
}

template <int L>
int launch_staged(const int* indptr, const int* indices, const float* data, const float* x,
                  float* y, const float* u, const float* b, const float* s, double escale,
                  const int* win_lo, const int* win_hi, int n, int chunk_rows, int n_chunks,
                  int window, int grid, cudaStream_t stream) {
  const int smem = 2 * window * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(spmv_staged_kernel<L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  spmv_staged_kernel<L><<<grid, kStagedThreads, smem, stream>>>(
      indptr, indices, data, x, y, u, b, s, static_cast<float>(escale), win_lo, win_hi, n,
      chunk_rows, n_chunks, window);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------- the band

constexpr int kBandWarps = 8;
constexpr int kBandMTiles = 2;                          // 16-row tiles a warp
constexpr int kBandRows = kBandWarps * kBandMTiles * 16;  // rows a CTA: 256
constexpr int kBandK = 32;                              // window rows staged per step

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// two bf16 (round to nearest even) in one register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Row stride of the staged X tile, in floats: the B fragments' 32 loads
// fall in 32 banks (bf16 reads rows 2t, 2t + 1; TF32 rows t).
template <bool BF16, int NCP>
__host__ __device__ constexpr int band_stride() {
  return BF16 ? NCP + 4 : (NCP % 32 == 8 ? NCP + 16 : NCP + 8);
}

template <bool BF16, int NT>
__global__ void __launch_bounds__(kBandWarps * 32) band_spmv_tc_kernel(
    const void* __restrict__ band, const int* __restrict__ start, const float* __restrict__ X,
    float* __restrict__ Y, int n_rows, int W, int n_x, int nc) {
  constexpr int NCP = 8 * NT;
  constexpr int S = band_stride<BF16, NCP>();
  __shared__ float xs[kBandK * S];
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int64_t row0 = (int64_t)blockIdx.x * kBandRows + w * kBandMTiles * 16;
  const int x0 = start[blockIdx.x];
  float acc[kBandMTiles][NT][4];
#pragma unroll
  for (int mt = 0; mt < kBandMTiles; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  for (int k0 = 0; k0 < W; k0 += kBandK) {
    for (int e = threadIdx.x; e < kBandK * NCP; e += blockDim.x) {
      const int kr = e / NCP;
      const int cc = e % NCP;
      const int xr = x0 + k0 + kr;
      xs[kr * S + cc] = (xr < n_x && cc < nc) ? X[(int64_t)xr * nc + cc] : 0.f;
    }
    __syncthreads();
    if constexpr (BF16) {
      const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(band);
#pragma unroll
      for (int ks = 0; ks < kBandK; ks += 16) {
        uint32_t a[kBandMTiles][4];
#pragma unroll
        for (int mt = 0; mt < kBandMTiles; ++mt) {
          const __nv_bfloat16* r = A + (row0 + 16 * mt + g) * W + k0 + ks + 2 * t;
          a[mt][0] = *reinterpret_cast<const uint32_t*>(r);
          a[mt][1] = *reinterpret_cast<const uint32_t*>(r + 8 * (int64_t)W);
          a[mt][2] = *reinterpret_cast<const uint32_t*>(r + 8);
          a[mt][3] = *reinterpret_cast<const uint32_t*>(r + 8 * (int64_t)W + 8);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float* c = xs + (ks + 2 * t) * S + 8 * nt + g;
          const uint32_t bb[2] = {pack_bf16(c[0], c[S]), pack_bf16(c[8 * S], c[9 * S])};
#pragma unroll
          for (int mt = 0; mt < kBandMTiles; ++mt) mma_bf16(acc[mt][nt], a[mt], bb);
        }
      }
    } else {
      const float* A = static_cast<const float*>(band);
#pragma unroll
      for (int ks = 0; ks < kBandK; ks += 8) {
        uint32_t a[kBandMTiles][4];
#pragma unroll
        for (int mt = 0; mt < kBandMTiles; ++mt) {
          const float* r = A + (row0 + 16 * mt + g) * W + k0 + ks + t;
          a[mt][0] = tf32(r[0]);
          a[mt][1] = tf32(r[8 * (int64_t)W]);
          a[mt][2] = tf32(r[4]);
          a[mt][3] = tf32(r[8 * (int64_t)W + 4]);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float* c = xs + (ks + t) * S + 8 * nt + g;
          const uint32_t bb[2] = {tf32(c[0]), tf32(c[4 * S])};
#pragma unroll
          for (int mt = 0; mt < kBandMTiles; ++mt) mma_tf32(acc[mt][nt], a[mt], bb);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int mt = 0; mt < kBandMTiles; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t r = row0 + 16 * mt + g + 8 * (i / 2);
        const int c = 8 * nt + 2 * t + i % 2;
        if (r < n_rows && c < nc) Y[r * nc + c] = acc[mt][nt][i];
      }
}

template <bool BF16>
int launch_band(const void* band, const int* start, const float* X, float* Y, int n_rows, int W,
                int n_x, int nc, cudaStream_t stream) {
  const int grid = (n_rows + kBandRows - 1) / kBandRows;
  const int nt = (nc + 7) / 8;
  const dim3 block(kBandWarps * 32);
  if (nt <= 1) {
    band_spmv_tc_kernel<BF16, 1><<<grid, block, 0, stream>>>(band, start, X, Y, n_rows, W, n_x, nc);
  } else if (nt <= 2) {
    band_spmv_tc_kernel<BF16, 2><<<grid, block, 0, stream>>>(band, start, X, Y, n_rows, W, n_x, nc);
  } else if (nt <= 4) {
    band_spmv_tc_kernel<BF16, 4><<<grid, block, 0, stream>>>(band, start, X, Y, n_rows, W, n_x, nc);
  } else if (nt <= 8) {
    band_spmv_tc_kernel<BF16, 8><<<grid, block, 0, stream>>>(band, start, X, Y, n_rows, W, n_x, nc);
  } else {
    band_spmv_tc_kernel<BF16, 16><<<grid, block, 0, stream>>>(band, start, X, Y, n_rows, W, n_x, nc);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1 with bfloat16 values: K1's arguments, data [nnz] bf16, x, y, u, b, s f32.
extern "C" int smg_spmv_bf16v_f32(const int* indptr, const int* indices, const void* data,
                                  const float* x, float* y, const float* u, const float* b,
                                  const float* s, double escale, const int* rows, int n,
                                  int lanes, int epi, void* stream) {
  const Args<float, __nv_bfloat16> a{indptr, indices, static_cast<const __nv_bfloat16*>(data),
                                     x, y, u, b, s, escale, rows, n, 1};
  return spmv_fused<float, __nv_bfloat16>(a, lanes, epi, stream);
}

// y = u + (b - A x) (s escale) with x staged by chunk; win_lo / win_hi:
// [n_chunks] int32, a chunk with no nonzero has the window [0, -1];
// window: floats a buffer holds (a multiple of 4); grid: persistent CTAs.
extern "C" int smg_spmv_staged_f32(const int* indptr, const int* indices, const float* data,
                                   const float* x, float* y, const float* u, const float* b,
                                   const float* s, double escale, const int* win_lo,
                                   const int* win_hi, int n, int chunk_rows, int n_chunks,
                                   int window, int lanes, int grid, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (chunk_rows <= 0 || n_chunks <= 0 || grid <= 0 || window <= 0 || window % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (lanes) {
    case 1: return launch_staged<1>(indptr, indices, data, x, y, u, b, s, escale, win_lo, win_hi,
                                    n, chunk_rows, n_chunks, window, grid, stream);
    case 2: return launch_staged<2>(indptr, indices, data, x, y, u, b, s, escale, win_lo, win_hi,
                                    n, chunk_rows, n_chunks, window, grid, stream);
    case 4: return launch_staged<4>(indptr, indices, data, x, y, u, b, s, escale, win_lo, win_hi,
                                    n, chunk_rows, n_chunks, window, grid, stream);
    case 8: return launch_staged<8>(indptr, indices, data, x, y, u, b, s, escale, win_lo, win_hi,
                                    n, chunk_rows, n_chunks, window, grid, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Y [n_rows, nc] = band x X windows; band [ceil(n_rows / 256) x 256, W]
// bf16 (bf16 = 1) or f32 (TF32); start [blocks] int32; X [n_x, nc] f32;
// W a multiple of 32; nc <= 128.
extern "C" int smg_band_spmv_tc(const void* band, const int* start, const float* X, float* Y,
                                int n_rows, int W, int n_x, int nc, int bf16,
                                void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  if (W <= 0 || W % kBandK != 0 || nc < 1 || nc > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? launch_band<true>(band, start, X, Y, n_rows, W, n_x, nc, stream)
              : launch_band<false>(band, start, X, Y, n_rows, W, n_x, nc, stream);
}

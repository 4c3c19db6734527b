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
// 2. K1 with x held in a shared-memory ring (smg_spmv_staged_f32,
//    spmv_staged_kernel). Replaces benchmarks/probes/probe_dbuf.py:33 main
//    (pallas_call :141), well_spmv's dia mode with its x-window copy
//    double-buffered. The rows are cut into chunks of `chunk_rows`; each
//    persistent CTA walks a contiguous range of chunks (the host's plan,
//    balanced by nonzeros). Under the RCM ordering both ends of a chunk's
//    x window rise with the chunk, so the CTA keeps x in a ring of R
//    floats (a power of two; column c in slot c & (R - 1)) and each chunk
//    copies only the columns its window adds past the previous one: x
//    once, plus one window a CTA. One producer warp issues each chunk's
//    copy (one cp.async.bulk, two where it wraps the ring; the last
//    columns of x past its last 16-byte boundary by plain loads) on an
//    mbarrier while the 16 compute warps work on the chunk before; it
//    waits for the chunk two back to be done (a second mbarrier, one
//    arrival a warp), so a copy never overwrites columns a chunk still
//    reads, and for the previous copy to land, so copies into the ring
//    stay in order. The compute warps gather x from the ring with a
//    sub-warp of L lanes a row, as K1 does, and write the axpby epilogue.
//    A chunk whose window does not fit the ring (or whose copy would
//    overwrite it, or whose least column lies below what the ring holds)
//    is wide: it gathers x from global memory. The plan says which, and
//    gives every copy. With STAGE_A the producer also brings each chunk's
//    slice of the operator (row pointers, indices, values) and of u, b, s
//    by bulk copies into one of two buffers, and the compute warps read
//    them from shared memory; the parts past the last 16-byte boundary of
//    an array are read from global memory. Without it they stream from
//    global memory as in K1. Bound: K1's bytes (each input once: 62.6 us
//    at ico9 on the H100); the ring adds one window a CTA (17 MB at ico9,
//    against the 98 MB the windows of the chunks copied one by one).
//
// 3. The band on tensor cores (smg_band_spmv_tc, band_spmv_tc_kernel).
//    Replaces benchmarks/probes/probe_mxu_band.py:44 main (pallas_call
//    :129): SpMV as a dense band times a contiguous x window on the MXU.
//    Layout (built on the host, probes/band_spmv.py): row blocks of
//    kBandRows = 128 rows; block r's window starts at start[r] (its least
//    column, rounded down to kBandK); the band is cut into tiles of 128
//    rows x kBandK = 32 window columns, and a per-block list (tile_ptr,
//    tile_k: a CSR of window-tile indices) names the tiles to multiply:
//    every tile of the window ("dense", the TPU probe's question) or only
//    those that hold a nonzero ("skip": 39% of them at ico7). The listed
//    tiles lie tile-major on the card, each in the core-matrix order of
//    wgmma's K-major operand (8 x 16 B matrices, 128 B each, no swizzle),
//    so a tile is one cp.async.bulk. A cast pass (band_x_cast_kernel)
//    writes X once, rounded to bf16 (or to TF32 for the f32 band) and
//    padded to N columns (nc rounded up to a power of two, at least 8), as
//    32-row tiles in the same order (X^T K-major), so each listed tile
//    reads its X tile in the band's type: half the bytes of f32 rows, and
//    no conversion on the product's path. The product runs persistent
//    CTAs over the row blocks: one producer warp keeps a ring of 2-4
//    stages full (a band tile and its X tile, two bulk copies on one
//    mbarrier), running on into the next block's tiles while the two
//    consumer warpgroups (64 rows each) write a block's Y; they run
//    wgmma.mma_async m64nNk16 (bf16) or m64nNk8 (TF32: the f32 band as
//    it is stored, which the tensor cores read as TF32) from shared
//    memory, the f32 sums in registers, one group in flight, each stage
//    released when its products are done. Y is written once from the
//    registers; a block with no listed tile writes zeros. Bound: the
//    function's bytes (the CSR operator, the X rows it gathers, Y) against
//    2 nnz nc operations at the tensor cores' peak; this design moves the
//    listed tiles, X (read, and written and read again in the band's
//    type), its X tiles through the L2 and Y.
//
// Entry points have a plain C interface (loaded with ctypes) and return
// cudaGetLastError() of the launch; they launch on the given stream,
// allocate nothing and do not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "spmv_fused.cuh"

namespace {

// ------------------------------------------------- barriers, bulk copies

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// arrive once and expect `bytes` more of asynchronous copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{ .reg .b64 state; mbarrier.arrive.shared::cta.b64 state, [%0]; }" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ------------------------------------------------------- x in a ring

constexpr int kStagedWarps = 16;  // compute warps: 512 threads, a row a lane group
constexpr int kStagedThreads = 32 * (kStagedWarps + 1);  // and the producer warp

__device__ __forceinline__ int floor4(int v) { return v & ~3; }
__device__ __forceinline__ int ceil4(int v) { return (v + 3) & ~3; }

// The shared-memory slices of one chunk's operator and vectors (STAGE_A):
// from the 16-byte boundary at or below each slice's start to the last one
// at or below its end and the array's end; `*_end`: the first element not
// held (read from global memory).
struct Slices {
  int p0, ptr_end, vec_end, nz_end;
};

__device__ __forceinline__ Slices chunk_slices(const int* __restrict__ indptr, int r0, int r1,
                                               int n, int nnz) {
  Slices sl;
  sl.p0 = floor4(indptr[r0]);
  sl.ptr_end = min(ceil4(r1 + 1), floor4(n + 1));
  sl.vec_end = min(ceil4(r1), floor4(n));
  sl.nz_end = min(ceil4(indptr[r1]), floor4(nnz));
  return sl;
}

template <int L, bool STAGE_A>
__global__ void __launch_bounds__(kStagedThreads) spmv_staged_kernel(
    const int* __restrict__ indptr, const int* __restrict__ indices,
    const float* __restrict__ data, const float* __restrict__ x, float* __restrict__ y,
    const float* __restrict__ u, const float* __restrict__ b, const float* __restrict__ s,
    float escale, const int4* __restrict__ table, const int* __restrict__ cta_ptr, int n,
    int n_cols, int nnz, int chunk_rows, int ring, int a_cap) {
  extern __shared__ __align__(128) unsigned char staged_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(staged_smem);  // [2]: a chunk's copies landed
  uint64_t* done = full + 2;  // [2]: a chunk's warps are done
  float* const xr = reinterpret_cast<float*>(staged_smem + 128);
  // STAGE_A: two buffers after the ring, each indices, values, row
  // pointers, u, b, s
  const int buf_words = 2 * a_cap + 4 * (chunk_rows + 4);
  int* const abuf = reinterpret_cast<int*>(xr + ring);
  const int c0 = cta_ptr[blockIdx.x];
  const int c1 = cta_ptr[blockIdx.x + 1];
  if (threadIdx.x == 0) {
    for (int k = 0; k < 2; ++k) {
      mbar_init(&full[k], 1);
      mbar_init(&done[k], kStagedWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x / 32;
  if (warp == kStagedWarps) {  // the producer
    if (threadIdx.x % 32 != 0) return;
    for (int c = c0, i = 0; c < c1; ++c, ++i) {
      if (i >= 2) mbar_wait(&done[i & 1], ((i - 2) >> 1) & 1);  // chunk i - 2 is done
      if (i >= 1) mbar_wait(&full[(i - 1) & 1], ((i - 1) >> 1) & 1);  // copy i - 1 landed
      const int4 t = table[c];
      // the columns [lo, hi) to add: [lo, bhi) by bulk copies, the last
      // columns of x past its last 16-byte boundary by this thread
      const int lo = t.x, hi = t.y;
      const int bhi = max(lo, min(hi, floor4(n_cols)));
      for (int col = bhi; col < min(hi, n_cols); ++col) xr[col & (ring - 1)] = x[col];
      const int len = bhi - lo;
      uint32_t bytes = 4u * len;
      Slices sl{};
      const int r0 = c * chunk_rows, r1 = min(n, r0 + chunk_rows);
      if constexpr (STAGE_A) {
        sl = chunk_slices(indptr, r0, r1, n, nnz);
        bytes += 4u * (max(0, sl.nz_end - sl.p0) * 2 + max(0, sl.ptr_end - r0) +
                       3 * max(0, sl.vec_end - r0));
      }
      mbar_expect_tx(&full[i & 1], bytes);
      if (len > 0) {
        const int slot = lo & (ring - 1);
        const int first = min(len, ring - slot);
        bulk_copy(xr + slot, x + lo, 4u * first, &full[i & 1]);
        if (first < len) bulk_copy(xr, x + lo + first, 4u * (len - first), &full[i & 1]);
      }
      if constexpr (STAGE_A) {
        int* const bi = abuf + (i & 1) * buf_words;
        float* const bv = reinterpret_cast<float*>(bi + a_cap);
        int* const bp = bi + 2 * a_cap;
        float* const bu = reinterpret_cast<float*>(bp + chunk_rows + 4);
        const int nz = sl.nz_end - sl.p0, np = sl.ptr_end - r0, nv = sl.vec_end - r0;
        if (nz > 0) {
          bulk_copy(bi, indices + sl.p0, 4u * nz, &full[i & 1]);
          bulk_copy(bv, data + sl.p0, 4u * nz, &full[i & 1]);
        }
        if (np > 0) bulk_copy(bp, indptr + r0, 4u * np, &full[i & 1]);
        if (nv > 0) {
          bulk_copy(bu, u + r0, 4u * nv, &full[i & 1]);
          bulk_copy(bu + chunk_rows, b + r0, 4u * nv, &full[i & 1]);
          bulk_copy(bu + 2 * chunk_rows, s + r0, 4u * nv, &full[i & 1]);
        }
      }
    }
    return;
  }
  constexpr int kSlots = 32 * kStagedWarps / L;  // rows in flight
  const int lane = threadIdx.x % L;
  for (int c = c0, i = 0; c < c1; ++c, ++i) {
    mbar_wait(&full[i & 1], (i >> 1) & 1);
    const bool wide = table[c].z != 0;
    const int r0 = c * chunk_rows;
    const int r1 = min(n, r0 + chunk_rows);
    Slices sl{};
    const int* bi = nullptr;
    const float* bv = nullptr;
    const int* bp = nullptr;
    const float* bu = nullptr;
    if constexpr (STAGE_A) {
      sl = chunk_slices(indptr, r0, r1, n, nnz);
      bi = abuf + (i & 1) * buf_words;
      bv = reinterpret_cast<const float*>(bi + a_cap);
      bp = bi + 2 * a_cap;
      bu = reinterpret_cast<const float*>(bp + chunk_rows + 4);
    }
    for (int base = r0; base < r1; base += kSlots) {
      const int row = base + threadIdx.x / L;
      const bool active = row < r1;
      float acc = 0.f;
      if (active) {
        int lo, hi;
        if constexpr (STAGE_A) {
          lo = row < sl.ptr_end ? bp[row - r0] : indptr[row];
          hi = row + 1 < sl.ptr_end ? bp[row + 1 - r0] : indptr[row + 1];
        } else {
          lo = indptr[row];
          hi = indptr[row + 1];
        }
#pragma unroll 4
        for (int p = lo + lane; p < hi; p += L) {
          int col;
          float a;
          if constexpr (STAGE_A) {
            const bool held = p < sl.nz_end;
            col = held ? bi[p - sl.p0] : indices[p];
            a = held ? bv[p - sl.p0] : data[p];
          } else {
            col = indices[p];
            a = data[p];
          }
          acc += a * (wide ? x[col] : xr[col & (ring - 1)]);
        }
      }
#pragma unroll
      for (int off = L / 2; off > 0; off /= 2) acc += __shfl_down_sync(0xffffffffu, acc, off, L);
      if (active && lane == 0) {
        float uu, bb, ss;
        if (STAGE_A && row < sl.vec_end) {
          uu = bu[row - r0];
          bb = bu[chunk_rows + row - r0];
          ss = bu[2 * chunk_rows + row - r0];
        } else {
          uu = u[row];
          bb = b[row];
          ss = s[row];
        }
        y[row] = uu + (bb - acc) * (ss * escale);
      }
    }
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(&done[i & 1]);
  }
}

template <int L, bool STAGE_A>
int launch_staged(const int* indptr, const int* indices, const float* data, const float* x,
                  float* y, const float* u, const float* b, const float* s, double escale,
                  const int4* table, const int* cta_ptr, int n, int n_cols, int nnz,
                  int chunk_rows, int ring, int a_cap, int grid, cudaStream_t stream) {
  int smem = 128 + 4 * ring;
  if (STAGE_A) smem += 2 * 4 * (2 * a_cap + 4 * (chunk_rows + 4));
  cudaError_t err = cudaFuncSetAttribute(spmv_staged_kernel<L, STAGE_A>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  spmv_staged_kernel<L, STAGE_A><<<grid, kStagedThreads, smem, stream>>>(
      indptr, indices, data, x, y, u, b, s, static_cast<float>(escale), table, cta_ptr, n, n_cols,
      nnz, chunk_rows, ring, a_cap);
  return static_cast<int>(cudaGetLastError());
}

template <bool STAGE_A>
int launch_staged_lanes(int lanes, const int* indptr, const int* indices, const float* data,
                        const float* x, float* y, const float* u, const float* b,
                        const float* s, double escale, const int4* table, const int* cta_ptr,
                        int n, int n_cols, int nnz, int chunk_rows, int ring, int a_cap,
                        int grid, cudaStream_t stream) {
#define SMG_STAGED(LN)                                                                     \
  launch_staged<LN, STAGE_A>(indptr, indices, data, x, y, u, b, s, escale, table, cta_ptr, \
                             n, n_cols, nnz, chunk_rows, ring, a_cap, grid, stream)
  switch (lanes) {
    case 1: return SMG_STAGED(1);
    case 2: return SMG_STAGED(2);
    case 4: return SMG_STAGED(4);
    case 8: return SMG_STAGED(8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SMG_STAGED
}

// ------------------------------------------------------------- the band

constexpr int kBandRows = 128;  // rows a CTA: two consumer warpgroups of 64
constexpr int kBandK = 32;      // window columns a tile
constexpr int kBandConsumerWarps = 8;  // the consumers: two warpgroups
constexpr int kBandThreads = 32 * (kBandConsumerWarps + 1);  // and the producer warp
constexpr int kBandStageBytes = 72 * 1024;  // the ring's budget: 2-4 stages
constexpr int kCore = 128;      // bytes of a core matrix: 8 rows of 16 B

// A shared-memory matrix descriptor of wgmma: no swizzle, K-major; lbo:
// bytes between core matrices along K, sbo: along M (or N).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int K>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(K) : "memory");
}

// keeps the compiler from moving accesses of the sums across wgmma
template <int R>
__device__ __forceinline__ void fence_sums(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x N] += A[64 x k] B[k x N] from shared memory: bf16 k = 16, TF32 k = 8;
// one overload per N (the sums' count, N / 2)
__device__ __forceinline__ void wgmma_bf16(float (&d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %6, 0; "
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 0, 0; }"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %10, 0; "
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0; }"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %18, 0; "
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, "
      "%16, %17, p, 1, 1, 0, 0; }"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %34, 0; "
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0; }"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %66, 0; "
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0; }"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %6, 0; "
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1; }"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %10, 0; "
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1; }"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %18, 0; "
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, "
      "%16, %17, p, 1, 1; }"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %34, 0; "
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1; }"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %66, 0; "
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1; }"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// The band's and X's tile geometry for element type E (bf16, or f32 read
// as TF32) and N columns. A tile of R rows x kBandK is stored as core
// matrices (8 rows x KC elements, KC = 16 B / sizeof(E)) in the order
// [k group][row group][8][KC]; a wgmma step takes two k groups. A stage
// holds a band tile and its X tile.
template <typename E, int N>
struct BandGeom {
  static constexpr int KC = 16 / static_cast<int>(sizeof(E));
  static constexpr int kSteps = kBandK / (2 * KC);  // wgmma a tile
  static constexpr int kABytes = kBandRows * kBandK * static_cast<int>(sizeof(E));
  static constexpr int kBBytes = N * kBandK * static_cast<int>(sizeof(E));
  static constexpr int kStage = kABytes + kBBytes;
  static constexpr int kFit = kBandStageBytes / kStage;
  static constexpr int kStages = kFit < 2 ? 2 : (kFit > 4 ? 4 : kFit);
  static constexpr int kSmem = 1024 + kStages * kStage;
};

__device__ __forceinline__ void store_x(__nv_bfloat16* dst, const float (&v)[8]) {
  __align__(16) __nv_bfloat162 h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(h);
}

__device__ __forceinline__ void store_x(float* dst, const float (&v)[4]) {
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r[i]) : "f"(v[i]));
  *reinterpret_cast<uint4*>(dst) = make_uint4(r[0], r[1], r[2], r[3]);
}

// X [n_x, nc] f32 -> xt: x_tiles tiles of kBandK rows x N columns, K-major
// core matrices [k group][n group][8 n][KC k], bf16 (round to nearest even)
// or TF32 (cvt.rna); zero past X's last row and past column nc. A thread a
// (k group, column): KC loads along a column, one 16-byte store.
template <typename E, int N>
__global__ void __launch_bounds__(256) band_x_cast_kernel(const float* __restrict__ X,
                                                          E* __restrict__ xt, int n_x, int nc,
                                                          int x_tiles) {
  using G = BandGeom<E, N>;
  const int64_t total = static_cast<int64_t>(x_tiles) * (kBandK / G::KC) * N;
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; e < total;
       e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int col = static_cast<int>(e % N);
    const int64_t grp = e / N;  // k group over all rows
    const int64_t row0 = grp * G::KC;
    float v[G::KC];
#pragma unroll
    for (int k = 0; k < G::KC; ++k)
      v[k] = (row0 + k < n_x && col < nc) ? X[(row0 + k) * nc + col] : 0.f;
    const int64_t tile = row0 / kBandK;
    const int kg = static_cast<int>(grp % (kBandK / G::KC));
    E* dst = xt + tile * (kBandK * N) +
             ((static_cast<int64_t>(kg) * (N / 8) + col / 8) * 8 + col % 8) * G::KC;
    store_x(dst, v);
  }
}

// Warp roles: warps 0-7 the consumers (wgmma, Y), warp 8 the producer.
// Barriers: full[S] (a stage's bulk copies landed), empty[S] (its products
// are done: one arrival a consumer warp). Persistent: the CTA takes row
// blocks blockIdx.x, + gridDim.x, ...; the producer runs on into the next
// block's tiles while the consumers write a block's Y, and i counts the
// CTA's tiles across its blocks.
template <typename E, int N>
__global__ void __launch_bounds__(kBandThreads) band_spmv_tc_kernel(
    const E* __restrict__ tiles, const int* __restrict__ tile_ptr,
    const int* __restrict__ tile_k, const int* __restrict__ start, const E* __restrict__ xt,
    float* __restrict__ Y, int n_rows, int blocks, int nc) {
  using G = BandGeom<E, N>;
  constexpr int S = G::kStages;
  extern __shared__ __align__(1024) unsigned char band_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(band_smem);
  uint64_t* empty = full + S;
  unsigned char* const ring = band_smem + 1024;
  if (threadIdx.x == 0) {
    for (int k = 0; k < S; ++k) {
      mbar_init(&full[k], 1);
      mbar_init(&empty[k], kBandConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == kBandConsumerWarps) {  // the producer
    if (lane != 0) return;
    int i = 0;
    for (int r = blockIdx.x; r < blocks; r += gridDim.x) {
      const int x0 = start[r] / kBandK;
      for (int t = tile_ptr[r]; t < tile_ptr[r + 1]; ++t, ++i) {
        const int st = i % S;
        mbar_wait(&empty[st], ((i / S) & 1) ^ 1);
        mbar_expect_tx(&full[st], G::kStage);
        unsigned char* dst = ring + st * G::kStage;
        bulk_copy(dst, tiles + static_cast<int64_t>(t) * (G::kABytes / sizeof(E)), G::kABytes,
                  &full[st]);
        bulk_copy(dst + G::kABytes,
                  xt + static_cast<int64_t>(x0 + tile_k[t]) * (G::kBBytes / sizeof(E)),
                  G::kBBytes, &full[st]);
      }
    }
    return;
  }
  const int wg = warp / 4;  // rows 64 wg .. 64 wg + 63 of the block
  float acc[N / 2];
  int i = 0;
  for (int r = blockIdx.x; r < blocks; r += gridDim.x) {
#pragma unroll
    for (int j = 0; j < N / 2; ++j) acc[j] = 0.f;
    fence_sums(acc);
    const int t0 = tile_ptr[r], t1 = tile_ptr[r + 1];
    for (int t = t0; t < t1; ++t, ++i) {
      const int st = i % S;
      mbar_wait(&full[st], (i / S) & 1);
      const uint32_t a = smem_u32(ring + st * G::kStage);
      const uint32_t bsm = a + G::kABytes;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < G::kSteps; ++k) {
        // A: k groups 2k, 2k + 1, row groups 8 wg .. 8 wg + 7 of 16
        const uint64_t da = gmma_desc(a + (2 * k * (kBandRows / 8) + 8 * wg) * kCore,
                                      (kBandRows / 8) * kCore, kCore);
        // B (X^T): k groups 2k, 2k + 1, every n group
        const uint64_t db = gmma_desc(bsm + 2 * k * (N / 8) * kCore, (N / 8) * kCore, kCore);
        if constexpr (sizeof(E) == 2) {
          wgmma_bf16(acc, da, db);
        } else {
          wgmma_tf32(acc, da, db);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the products of the tile before are done: free its stage
      if (t > t0 && lane == 0) mbar_arrive(&empty[(i - 1) % S]);
    }
    wgmma_wait<0>();
    fence_sums(acc);
    if (t1 > t0 && lane == 0) mbar_arrive(&empty[(i - 1) % S]);  // the block's last stage
    // the accumulator's layout: warp w of the group holds rows 16 w .. 16 w
    // + 15; sums 4 j .. 4 j + 3 are columns 8 j + 2 (lane % 4) + {0, 1} of
    // rows lane / 4 and lane / 4 + 8
    const int64_t row0 =
        static_cast<int64_t>(r) * kBandRows + 64 * wg + 16 * (warp % 4) + lane / 4;
#pragma unroll
    for (int j = 0; j < N / 2; j += 2) {
      const int64_t rr = row0 + 8 * ((j / 2) % 2);
      const int c = 8 * (j / 4) + 2 * (lane % 4);
      if (rr >= n_rows || c >= nc) continue;
      float* dst = Y + rr * nc + c;
      if (c + 1 < nc && (nc % 2) == 0) {
        *reinterpret_cast<float2*>(dst) = make_float2(acc[j], acc[j + 1]);
      } else {
        dst[0] = acc[j];
        if (c + 1 < nc) dst[1] = acc[j + 1];
      }
    }
  }
}

template <typename E, int N>
int launch_band_n(const E* tiles, const int* tile_ptr, const int* tile_k, const int* start,
                  const float* X, E* xt, float* Y, int n_rows, int blocks, int x_tiles,
                  int n_x, int nc, cudaStream_t stream) {
  using G = BandGeom<E, N>;
  const int64_t groups = static_cast<int64_t>(x_tiles) * (kBandK / G::KC) * N;
  const int64_t want = (groups + 255) / 256;
  const int cast_grid = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  band_x_cast_kernel<E, N><<<cast_grid, 256, 0, stream>>>(X, xt, n_x, nc, x_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = band_spmv_tc_kernel<E, N>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBandThreads,
                                                           G::kSmem)) != cudaSuccess)
    return static_cast<int>(err);
  const int grid = blocks < sms * per_sm ? blocks : sms * per_sm;
  kernel<<<grid > 0 ? grid : 1, kBandThreads, G::kSmem, stream>>>(tiles, tile_ptr, tile_k, start,
                                                                  xt, Y, n_rows, blocks, nc);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int launch_band(const void* tiles, const int* tile_ptr, const int* tile_k, const int* start,
                const float* X, void* xt, float* Y, int n_rows, int blocks, int x_tiles,
                int n_x, int nc, cudaStream_t stream) {
#define SMG_BAND(NN)                                                                        \
  launch_band_n<E, NN>(static_cast<const E*>(tiles), tile_ptr, tile_k, start, X,           \
                       static_cast<E*>(xt), Y, n_rows, blocks, x_tiles, n_x, nc, stream)
  if (nc <= 8) return SMG_BAND(8);
  if (nc <= 16) return SMG_BAND(16);
  if (nc <= 32) return SMG_BAND(32);
  if (nc <= 64) return SMG_BAND(64);
  return SMG_BAND(128);
#undef SMG_BAND
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

// y = u + (b - A x) (s escale) with x in a ring of `ring` floats (a power of
// two); table: [n_chunks] int4 (copy_lo, copy_hi, wide, 0), the columns
// [copy_lo, copy_hi) (16-byte aligned, at most `ring`) each chunk adds,
// and whether it gathers x from global memory; cta_ptr: [grid + 1], the
// contiguous chunk range of each CTA; a_cap: floats of one chunk's slice
// of indices or values in shared memory (stage_a = 1; a multiple of 4).
// x, and with stage_a indptr, indices, data, u, b, s, 16-byte aligned.
extern "C" int smg_spmv_staged_f32(const int* indptr, const int* indices, const float* data,
                                   const float* x, float* y, const float* u, const float* b,
                                   const float* s, double escale, const void* table,
                                   const int* cta_ptr, int n, int n_cols, int nnz,
                                   int chunk_rows, int ring, int a_cap, int lanes, int stage_a,
                                   int grid, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (chunk_rows <= 0 || chunk_rows % 4 != 0 || grid <= 0 || ring < 4 ||
      (ring & (ring - 1)) != 0 || a_cap < 0 || a_cap % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int4* t = static_cast<const int4*>(table);
  return stage_a ? launch_staged_lanes<true>(lanes, indptr, indices, data, x, y, u, b, s,
                                             escale, t, cta_ptr, n, n_cols, nnz, chunk_rows,
                                             ring, a_cap, grid, stream)
                 : launch_staged_lanes<false>(lanes, indptr, indices, data, x, y, u, b, s,
                                              escale, t, cta_ptr, n, n_cols, nnz, chunk_rows,
                                              ring, a_cap, grid, stream);
}

// Y [n_rows, nc] = the listed band tiles x X's tiles. tiles: the listed
// tiles, tile-major, [n_tiles, 128 x 32] bf16 (bf16 = 1) or f32 (TF32) in
// wgmma's core-matrix order; tile_ptr [blocks + 1], tile_k [n_tiles]: the
// window tile of each (the X tile start / 32 + tile_k); start [blocks]
// int32, multiples of 32; X [n_x, nc] f32; xt: scratch of x_tiles x 32 x N
// elements of the band's type, N = nc rounded up to a power of two >= 8;
// 1 <= nc <= 128.
extern "C" int smg_band_spmv_tc(const void* tiles, const int* tile_ptr, const int* tile_k,
                                const int* start, const float* X, void* xt, float* Y,
                                int n_rows, int blocks, int x_tiles, int n_x, int nc, int bf16,
                                void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  if (blocks != (n_rows + kBandRows - 1) / kBandRows || x_tiles <= 0 || nc < 1 || nc > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? launch_band<__nv_bfloat16>(tiles, tile_ptr, tile_k, start, X, xt, Y, n_rows,
                                           blocks, x_tiles, n_x, nc, stream)
              : launch_band<float>(tiles, tile_ptr, tile_k, start, X, xt, Y, n_rows, blocks,
                                   x_tiles, n_x, nc, stream);
}

// K5: the walk of SSP point queries through the collapse log, for Hopper (sm_90a).
//
// Replaces surface_multigrid_code_tpu/query/device.py:123 _query_device, an
// XLA lax.while_loop (no Pallas kernel) that advances every query in
// lockstep with masked, padded gathers, chunked and sorted by walk start
// (_query_chunked :212) so that the TPU's lanes retire together. It
// follows the host walk of native/ssp.cpp (query_walk, walk_step; the
// reference src/query_fine_to_coarse.cpp:23-127) step for step:
//
//   d = -1 (forward) or n_collapse (backward)
//   loop:
//     next = the smallest entry > d (forward) or the largest < d (backward)
//            of the current face's dim_dat range (ascending); none: stop
//     d = next
//     lid[c] = lower_bound(subset of record d, bf[c])
//     q = sum_c bc[c] * uv_src[lid[c]]
//     for each destination face k of record d: barycentrics (u, v, w) of
//       q, mind = -min(u, min(v, w)) with std::min's NaN behaviour
//     best = the first face with mind < bestmind, bestmind from 1.0
//            (strict <: NaN never wins, the first of equal minima wins)
//     if some face won: clamp at 0, renormalise,
//       bf = subset[fuv_dst[best]], fidx = fidx_dst[best]
//
// The forward walk (fine -> coarse) maps uv_pre -> uv_post onto the post
// faces; the backward walk (coarse -> fine) uv_post -> uv_pre onto the pre
// faces. The host wrapper (query/device.query_walk) passes the arrays of
// the direction, so the kernel has no direction branch inside a step.
//
// Design: one thread per query walking the CSR log as it is. Nothing is
// padded, sorted or chunked: a GPU thread has its own control flow, and a
// finished thread idles only until the last walker of its warp ends. The
// state of a query (3 barycentrics, 3 vertex ids, the face id and d) stays
// in registers for the whole walk and is written once at the end. Ids are
// int32 (the wrapper checks that they fit).
//
// What bounds it: the bytes it must move are the query arrays in and out
// and, once each, the log records the walk visits (subset, uv, faces of a
// record; the dim_dat range of each face read): at 1M queries on the
// icosphere(7) log of 161,280 records tens of MB, some 20 us at HBM rate.
// The walk itself is a chain of dependent loads (dim_off -> dim_dat ->
// voff -> subset search -> uv -> faces), a few hundred cycles each, so
// a thread's time is its step count times that latency; the card hides it
// only with many queries in flight. Sorting the queries by walk start, so
// that a warp's walkers retire together, is later work.
//
// Arithmetic is in T (float for the public query functions, as the JAX
// package walks in float32; double to hold the kernel against the host
// walk, which runs in double). Every product, sum and quotient is rounded
// on its own (the _rn intrinsics, which nvcc never fuses into an FMA), in
// the order the host walk writes them, so the kernel computes what the
// plain PyTorch version (query/device.query_walk_plain) computes, one
// elementwise operation at a time.

#include <cuda_runtime.h>

namespace {

template <typename T>
struct Args {
  const int* voff;      // [n_collapse + 1] record -> first subset entry
  const int* subset;    // [voff[n]] sorted global vertex ids per record
  const T* uv_src;      // [voff[n], 2] the walk's source parameterisation
  const T* uv_dst;      // [voff[n], 2] its destination parameterisation
  const int* foff;      // [n_collapse + 1] record -> first destination face
  const int* fuv;       // [foff[n], 3] destination faces, local (record) ids
  const int* fidx;      // [foff[n]] destination faces, working-mesh face ids
  const int* dim_off;   // [nF_working + 1] face -> first dim_dat entry
  const int* dim_dat;   // ascending record ids whose pre-patch holds the face
  T* BC;                // [nq, 3] in place
  int* BF;              // [nq, 3] in place
  int* FIdx;            // [nq] in place
  int nq;
  int n_collapse;
  int forward;
};

// std::min(a, b) as the host writes it: (b < a) ? b : a.
template <typename T>
__device__ __forceinline__ T host_min(T a, T b) {
  return (b < a) ? b : a;
}

// Separately rounded arithmetic (no contraction into FMAs).
__device__ __forceinline__ float rn_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double rn_mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float rn_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double rn_add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float rn_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double rn_sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float rn_div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double rn_div(double a, double b) { return __ddiv_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(128) query_walk_kernel(const Args<T> a) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= a.nq) return;
  T bc[3] = {a.BC[3 * qi], a.BC[3 * qi + 1], a.BC[3 * qi + 2]};
  int bf[3] = {a.BF[3 * qi], a.BF[3 * qi + 1], a.BF[3 * qi + 2]};
  int f = a.FIdx[qi];
  int d = a.forward ? -1 : a.n_collapse;
  while (true) {
    const int lo = __ldg(a.dim_off + f), hi = __ldg(a.dim_off + f + 1);
    int next = -1;
    if (a.forward) {
      for (int k = lo; k < hi; ++k) {
        const int e = __ldg(a.dim_dat + k);
        if (e > d) {
          next = e;
          break;
        }
      }
    } else {
      for (int k = hi - 1; k >= lo; --k) {
        const int e = __ldg(a.dim_dat + k);
        if (e < d) {
          next = e;
          break;
        }
      }
    }
    if (next < 0) break;
    d = next;

    const int v0 = __ldg(a.voff + d), nv = __ldg(a.voff + d + 1) - v0;
    const int* subset = a.subset + v0;
    T qx = T(0), qy = T(0);
    for (int c = 0; c < 3; ++c) {
      int first = 0, count = nv;  // lower_bound of bf[c] in the sorted subset
      while (count > 0) {
        const int half = count >> 1;
        if (__ldg(subset + first + half) < bf[c]) {
          first += half + 1;
          count -= half + 1;
        } else {
          count = half;
        }
      }
      const int g = v0 + first;
      qx = rn_add(qx, rn_mul(bc[c], a.uv_src[2 * g]));
      qy = rn_add(qy, rn_mul(bc[c], a.uv_src[2 * g + 1]));
    }

    const int f0 = __ldg(a.foff + d), nf = __ldg(a.foff + d + 1) - f0;
    const int* tri = a.fuv + 3 * f0;
    T bestmind = T(1);
    int best = -1;
    T B0 = T(0), B1 = T(0), B2 = T(0);
    for (int k = 0; k < nf; ++k) {
      const int ia = v0 + __ldg(tri + 3 * k), ib = v0 + __ldg(tri + 3 * k + 1),
                ic = v0 + __ldg(tri + 3 * k + 2);
      const T ax = a.uv_dst[2 * ia], ay = a.uv_dst[2 * ia + 1];
      const T v0x = rn_sub(a.uv_dst[2 * ib], ax), v0y = rn_sub(a.uv_dst[2 * ib + 1], ay);
      const T v1x = rn_sub(a.uv_dst[2 * ic], ax), v1y = rn_sub(a.uv_dst[2 * ic + 1], ay);
      const T v2x = rn_sub(qx, ax), v2y = rn_sub(qy, ay);
      const T d00 = rn_add(rn_mul(v0x, v0x), rn_mul(v0y, v0y));
      const T d01 = rn_add(rn_mul(v0x, v1x), rn_mul(v0y, v1y));
      const T d11 = rn_add(rn_mul(v1x, v1x), rn_mul(v1y, v1y));
      const T d20 = rn_add(rn_mul(v2x, v0x), rn_mul(v2y, v0y));
      const T d21 = rn_add(rn_mul(v2x, v1x), rn_mul(v2y, v1y));
      const T denom = rn_sub(rn_mul(d00, d11), rn_mul(d01, d01));
      const T v = rn_div(rn_sub(rn_mul(d11, d20), rn_mul(d01, d21)), denom);
      const T w = rn_div(rn_sub(rn_mul(d00, d21), rn_mul(d01, d20)), denom);
      const T u = rn_sub(rn_sub(T(1), v), w);
      const T mind = -host_min(u, host_min(v, w));
      if (mind < bestmind) {
        bestmind = mind;
        best = k;
        B0 = u;
        B1 = v;
        B2 = w;
      }
    }
    if (best < 0) continue;  // no face won: the point stays, the walk goes on
    B0 = B0 > T(0) ? B0 : T(0);
    B1 = B1 > T(0) ? B1 : T(0);
    B2 = B2 > T(0) ? B2 : T(0);
    const T s = rn_add(rn_add(B0, B1), B2);
    bc[0] = rn_div(B0, s);
    bc[1] = rn_div(B1, s);
    bc[2] = rn_div(B2, s);
    for (int c = 0; c < 3; ++c) bf[c] = __ldg(subset + __ldg(tri + 3 * best + c));
    f = __ldg(a.fidx + f0 + best);
  }
  a.BC[3 * qi] = bc[0];
  a.BC[3 * qi + 1] = bc[1];
  a.BC[3 * qi + 2] = bc[2];
  a.BF[3 * qi] = bf[0];
  a.BF[3 * qi + 1] = bf[1];
  a.BF[3 * qi + 2] = bf[2];
  a.FIdx[qi] = f;
}

template <typename T>
int query_walk(const Args<T>& a, void* stream_ptr) {
  if (a.nq <= 0) return static_cast<int>(cudaGetLastError());
  constexpr int kThreads = 128;
  const int blocks = (a.nq + kThreads - 1) / kThreads;
  query_walk_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The arrays of one direction (see Args); forward is 1 for fine -> coarse.
extern "C" int smg_query_walk_f32(const int* voff, const int* subset, const float* uv_src,
                                  const float* uv_dst, const int* foff, const int* fuv,
                                  const int* fidx, const int* dim_off, const int* dim_dat,
                                  float* BC, int* BF, int* FIdx, int nq, int n_collapse,
                                  int forward, void* stream) {
  const Args<float> a{voff, subset, uv_src, uv_dst, foff, fuv, fidx, dim_off, dim_dat,
                      BC, BF, FIdx, nq, n_collapse, forward};
  return query_walk<float>(a, stream);
}

extern "C" int smg_query_walk_f64(const int* voff, const int* subset, const double* uv_src,
                                  const double* uv_dst, const int* foff, const int* fuv,
                                  const int* fidx, const int* dim_off, const int* dim_dat,
                                  double* BC, int* BF, int* FIdx, int nq, int n_collapse,
                                  int forward, void* stream) {
  const Args<double> a{voff, subset, uv_src, uv_dst, foff, fuv, fidx, dim_off, dim_dat,
                       BC, BF, FIdx, nq, n_collapse, forward};
  return query_walk<double>(a, stream);
}

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
// What bounds it: the bytes it must move are the query arrays in and out
// and, once each, the log records the walk visits: at 1M queries on the
// icosphere(7) log of 161,280 records tens of MB, some 20-60 us at HBM
// rate. A query walks ~17 records. Walking the CSR log as it is (the
// version before this layout) read ~100 scattered 4-byte values a step,
// ~30 of them a chain of dependent loads (dim_off -> dim_dat -> voff ->
// three binary searches in the subset -> uv -> per face fuv -> uv_dst).
//
// Design: one thread per query, and a log laid out for the walk. Per
// direction, device_log precomputes where each destination face leads:
// for record d and its face k, the record the host walk visits next from
// that face (next_rec) and the local ids there of the three corners the
// query then carries (next_lid, the lower_bound the next step would do).
// Each record is one 16-byte-aligned block: its source parameterisation
// (nv + 1 pairs: the last is the CSR entry after the record, which the
// host reads when a corner is not in the subset, as after a no-win), its
// destination parameterisation, then one 16-byte entry per destination
// face (its three local ids, next_rec, the next record's block offset, nv
// and nf, and next_lid). After a step that commits, the next step knows
// its block, its sizes and its three local ids from the winner's entry:
// it issues the three uv_src loads and the cp.async copies of uv_dst and
// the face entries together, one round of wide loads, and reads the face
// loop from shared memory (a slice private to the thread, [chunk][thread]
// interleaved). Only the first step and a step after a no-win (where no
// face's barycentrics beat 1, e.g. NaN) scan dim_dat and binary-search
// the CSR subset as before, through the per-record table rec
// {block, nv | nf << 16, voff, foff}. The query's global vertex ids and
// face id are read from the CSR arrays only when they are needed: at a
// no-win and at the end of the walk, from the last commit's record and
// face. A thread's state (3 barycentrics, 3 local ids, the record and the
// last commit) stays in registers; the results are written once.
//
// Records too large for a block (more than 255 vertices or destination
// faces, whose local ids would not fit the face entries' bytes, or more
// chunks than 32 threads' slices can stage in shared memory) are not
// packed: rec holds block -1, and face entries leading to them hold no
// block, sizes or local ids. A step in such a record takes the CSR route
// of the first step: the global ids of the carried corners, the host's
// lower_bound in the subset, the source pairs, faces and destination pairs
// read from the CSR arrays in global memory, the same arithmetic; after it
// the walk searches dim_dat for the next record, as after a no-win.
//
// What bounds it now (H100, PERF.md): the face loop, ~90 instructions a
// face (two IEEE divisions among them) in a dependent chain: at 10K
// queries (~2 warps an SM) a step is that chain's latency, ~4,400 cycles.
// At 100K and 1M the card is full, and the warps of random queries differ
// in their records' face counts and walk lengths: the same kernel on the
// queries sorted by start face is 1.5x faster at 1M. Fewer bytes a step
// (the face entries outside the block), copying a record a warp at a time
// and thread-contiguous slices each measured no faster.

// The precomputed ids are the host walk's: next_rec is the dim_dat search
// and next_lid the lower_bound, both done exactly on integers, so the
// walk visits the same records in the same order and reads the same
// parameterisation entries. After a commit the corners a query carries
// are in the next record's subset (the record holds the face); after a
// no-win they may not be, and lower_bound may then give nv, where the
// host reads the entry after the record (past the last record, the
// packed block holds (0, 0)).
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

constexpr int kMaxThreads = 64;

template <typename T>
struct Vec2;
template <>
struct Vec2<float> {
  using type = float2;
};
template <>
struct Vec2<double> {
  using type = double2;
};

template <typename T>
struct Args {
  const int* subset;    // [voff[n]] sorted global vertex ids per record (CSR)
  const int* fidx;      // [foff[n]] destination faces, working-mesh face ids (CSR)
  const int* dim_off;   // [nF_working + 1] face -> first dim_dat entry
  const int* dim_dat;   // ascending record ids whose pre-patch holds the face
  const int4* rec;      // [n_collapse] {block (-1: not packed), nv | nf << 16, voff, foff}
  const int4* pack;     // the direction's record blocks, 16-byte chunks
  const T* uv_src;      // [nvert, 2] source parameterisation (CSR, from voff)
  const T* uv_dst;      // [nvert, 2] destination parameterisation
  const int* fuv;       // [foff[n], 3] destination faces in local ids (CSR)
  int nvert;            // voff[n]
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

__device__ __forceinline__ int byte_of(int word, int i) {
  return static_cast<int>((static_cast<unsigned>(word) >> (8 * i)) & 0xffu);
}

// 16 bytes from global to shared memory, asynchronously (kept in L1 too:
// many queries walk the same records).
__device__ __forceinline__ void cp_async16(int4* dst, const int4* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The record after d that holds face f: the smallest dim_dat entry > d
// (forward) or the largest < d (backward); -1 if none.
template <typename T>
__device__ int next_record(const Args<T>& a, int f, int d) {
  const int lo = __ldg(a.dim_off + f), hi = __ldg(a.dim_off + f + 1);
  if (a.forward) {
    for (int k = lo; k < hi; ++k) {
      const int e = __ldg(a.dim_dat + k);
      if (e > d) return e;
    }
  } else {
    for (int k = hi - 1; k >= lo; --k) {
      const int e = __ldg(a.dim_dat + k);
      if (e < d) return e;
    }
  }
  return -1;
}

// lower_bound of each of bf in the record's sorted subset (CSR, from voff).
template <typename T>
__device__ void locate(const Args<T>& a, const int4 r, const int* bf, int* lid) {
  const int* subset = a.subset + r.z;
  const int nv = r.y & 0xffff;
  for (int c = 0; c < 3; ++c) {
    int first = 0, count = nv;
    while (count > 0) {
      const int half = count >> 1;
      if (__ldg(subset + first + half) < bf[c]) {
        first += half + 1;
        count -= half + 1;
      } else {
        count = half;
      }
    }
    lid[c] = first;
  }
}

// q = sum_c bc[c] * p[c], in the host walk's order.
template <typename T, typename P>
__device__ __forceinline__ void source_point(const T* bc, const P p0, const P p1, const P p2,
                                             T& qx, T& qy) {
  qx = T(0);
  qy = T(0);
  qx = rn_add(qx, rn_mul(bc[0], p0.x));
  qy = rn_add(qy, rn_mul(bc[0], p0.y));
  qx = rn_add(qx, rn_mul(bc[1], p1.x));
  qy = rn_add(qy, rn_mul(bc[1], p1.y));
  qx = rn_add(qx, rn_mul(bc[2], p2.x));
  qy = rn_add(qy, rn_mul(bc[2], p2.y));
}

// The barycentrics (u, v, w) of q in destination face k with corners A, B,
// C; face k becomes the best if its minimum beats bestmind.
template <typename T, typename P>
__device__ __forceinline__ void test_face(const P A, const P B, const P C, const T qx, const T qy,
                                          const int k, T& bestmind, int& best, T* W) {
  const T v0x = rn_sub(B.x, A.x), v0y = rn_sub(B.y, A.y);
  const T v1x = rn_sub(C.x, A.x), v1y = rn_sub(C.y, A.y);
  const T v2x = rn_sub(qx, A.x), v2y = rn_sub(qy, A.y);
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
    W[0] = u;
    W[1] = v;
    W[2] = w;
  }
}

// The query's global vertex ids and face id from the last commit: packed
// record cd, its destination face ck, whose local ids are the bytes of cz.
template <typename T>
__device__ __forceinline__ void resolve(const Args<T>& a, int cd, int ck, int cz, int* bf,
                                        int& f) {
  const int4 r = __ldg(a.rec + cd);
  for (int c = 0; c < 3; ++c) bf[c] = __ldg(a.subset + r.z + byte_of(cz, c));
  f = __ldg(a.fidx + r.w + ck);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) query_walk_kernel(const Args<T> a) {
  using P = typename Vec2<T>::type;
  constexpr int kPer = 16 / static_cast<int>(sizeof(P));  // uv pairs per 16-byte chunk
  extern __shared__ int4 smem[];
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= a.nq) return;
  int4* slice = smem + threadIdx.x;  // chunk j of this thread at slice[j * stride]
  const int stride = blockDim.x;
  const P* uv_src = reinterpret_cast<const P*>(a.uv_src);
  const P* uv_dst = reinterpret_cast<const P*>(a.uv_dst);

  int bf[3] = {a.BF[3 * qi], a.BF[3 * qi + 1], a.BF[3 * qi + 2]};
  int f = a.FIdx[qi];
  int d = next_record(a, f, a.forward ? -1 : a.n_collapse);
  if (d < 0) return;  // no record holds the face: the query stays as it is
  T bc[3] = {a.BC[3 * qi], a.BC[3 * qi + 1], a.BC[3 * qi + 2]};
  int4 r = __ldg(a.rec + d);  // record d's row; read again only on the CSR route
  int lid[3];
  locate(a, r, bf, lid);
  int blk = r.x, nv = r.y & 0xffff, nf = r.y >> 16;
  // The last commit in a packed record: its record (-1: bf and f are
  // current), face and local ids.
  int cd = -1, ck = 0, cz = 0;
  while (true) {
    T bestmind = T(1);
    int best = -1;
    T W[3] = {T(0), T(0), T(0)};
    const int nud = (nv + kPer - 1) / kPer;  // chunks of the nv destination pairs
    if (blk >= 0) {
      const int4* block = a.pack + blk;
      const int nus = (nv + kPer) / kPer;  // chunks of the nv + 1 source pairs
      for (int j = 0; j < nud + nf; ++j) cp_async16(slice + j * stride, block + nus + j);
      const P* src = reinterpret_cast<const P*>(block);
      T qx, qy;
      source_point(bc, __ldg(src + lid[0]), __ldg(src + lid[1]), __ldg(src + lid[2]), qx, qy);
      cp_async_wait_all();
      for (int k = 0; k < nf; ++k) {
        const int z = slice[(nud + k) * stride].z;
        const int ia = byte_of(z, 0), ib = byte_of(z, 1), ic = byte_of(z, 2);
        test_face(reinterpret_cast<const P*>(slice + (ia / kPer) * stride)[ia % kPer],
                  reinterpret_cast<const P*>(slice + (ib / kPer) * stride)[ib % kPer],
                  reinterpret_cast<const P*>(slice + (ic / kPer) * stride)[ic % kPer], qx, qy,
                  k, bestmind, best, W);
      }
    } else {
      // Not packed: the CSR arrays (past the last record the host reads (0, 0)).
      P p[3];
      for (int c = 0; c < 3; ++c) {
        const int i = r.z + lid[c];
        p[c] = i < a.nvert ? __ldg(uv_src + i) : P{T(0), T(0)};
      }
      T qx, qy;
      source_point(bc, p[0], p[1], p[2], qx, qy);
      for (int k = 0; k < nf; ++k) {
        const int* tri = a.fuv + 3 * (r.w + k);
        test_face(__ldg(uv_dst + r.z + __ldg(tri)), __ldg(uv_dst + r.z + __ldg(tri + 1)),
                  __ldg(uv_dst + r.z + __ldg(tri + 2)), qx, qy, k, bestmind, best, W);
      }
    }
    if (best >= 0) {
      for (int c = 0; c < 3; ++c) W[c] = W[c] > T(0) ? W[c] : T(0);
      const T s = rn_add(rn_add(W[0], W[1]), W[2]);
      for (int c = 0; c < 3; ++c) bc[c] = rn_div(W[c], s);
      if (blk >= 0) {
        // {next_rec, its block, fuv bytes | next nv << 24, next_lid bytes | next nf << 24}
        const int4 e = slice[(nud + best) * stride];
        cd = d;
        ck = best;
        cz = e.z;
        if (e.x < 0) break;
        d = e.x;
        if (e.y >= 0) {
          blk = e.y;
          nv = byte_of(e.z, 3);
          nf = byte_of(e.w, 3);
          lid[0] = byte_of(e.w, 0);
          lid[1] = byte_of(e.w, 1);
          lid[2] = byte_of(e.w, 2);
          continue;
        }
        // The next record is not packed: the host's search for its local ids.
        resolve(a, cd, ck, cz, bf, f);
        cd = -1;
      } else {
        const int* tri = a.fuv + 3 * (r.w + best);
        for (int c = 0; c < 3; ++c) bf[c] = __ldg(a.subset + r.z + __ldg(tri + c));
        f = __ldg(a.fidx + r.w + best);
        d = next_record(a, f, d);
        if (d < 0) break;
      }
    } else {
      // No face won: the point stays, and the walk goes on from the same
      // face with the host's search.
      if (cd >= 0) {
        resolve(a, cd, ck, cz, bf, f);
        cd = -1;
      }
      d = next_record(a, f, d);
      if (d < 0) break;
    }
    r = __ldg(a.rec + d);
    locate(a, r, bf, lid);
    blk = r.x;
    nv = r.y & 0xffff;
    nf = r.y >> 16;
  }
  if (cd >= 0) resolve(a, cd, ck, cz, bf, f);
  a.BC[3 * qi] = bc[0];
  a.BC[3 * qi + 1] = bc[1];
  a.BC[3 * qi + 2] = bc[2];
  a.BF[3 * qi] = bf[0];
  a.BF[3 * qi + 1] = bf[1];
  a.BF[3 * qi + 2] = bf[2];
  a.FIdx[qi] = f;
}

// threads a block (at most kMaxThreads) and its dynamic shared memory
// (threads x the largest record's uv_dst and face chunks x 16 bytes) come
// from the wrapper (query/device.launch_shape).
template <typename T>
int query_walk(const Args<T>& a, int threads, int smem, void* stream_ptr) {
  if (a.nq <= 0) return static_cast<int>(cudaGetLastError());
  if (threads <= 0 || threads > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        query_walk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (a.nq + threads - 1) / threads;
  query_walk_kernel<T><<<blocks, threads, smem, static_cast<cudaStream_t>(stream_ptr)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The arrays of one direction (see Args); forward is 1 for fine -> coarse.
extern "C" int smg_query_walk_f32(const int* subset, const int* fidx, const int* dim_off,
                                  const int* dim_dat, const void* rec, const void* pack,
                                  const void* uv_src, const void* uv_dst, const int* fuv,
                                  float* BC, int* BF, int* FIdx, int nq, int n_collapse,
                                  int nvert, int forward, int threads, int smem, void* stream) {
  const Args<float> a{subset, fidx, dim_off, dim_dat, static_cast<const int4*>(rec),
                      static_cast<const int4*>(pack), static_cast<const float*>(uv_src),
                      static_cast<const float*>(uv_dst), fuv, nvert, BC, BF, FIdx, nq,
                      n_collapse, forward};
  return query_walk<float>(a, threads, smem, stream);
}

extern "C" int smg_query_walk_f64(const int* subset, const int* fidx, const int* dim_off,
                                  const int* dim_dat, const void* rec, const void* pack,
                                  const void* uv_src, const void* uv_dst, const int* fuv,
                                  double* BC, int* BF, int* FIdx, int nq, int n_collapse,
                                  int nvert, int forward, int threads, int smem, void* stream) {
  const Args<double> a{subset, fidx, dim_off, dim_dat, static_cast<const int4*>(rec),
                       static_cast<const int4*>(pack), static_cast<const double*>(uv_src),
                       static_cast<const double*>(uv_dst), fuv, nvert, BC, BF, FIdx, nq,
                       n_collapse, forward};
  return query_walk<double>(a, threads, smem, stream);
}

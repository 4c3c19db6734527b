// K4: Newton-Schulz sign-apply of symmetric d x d blocks, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel surface_multigrid_code_tpu/ops/psd.py:82
// ns_sign_apply_packed (body _sign_apply_kernel :70, pallas_call :106).
// What it computes, and all this file computes, per block X (d in {9, 18}):
//   Z = X;  for each (a, b) of the schedule:  Z <- a Z - b (Z Z) Z
//   Y = X + X Z
// With ||X||_2 <= 1.4 and the 12-cubic schedule of ops/psd.py:44-57, Z is
// the matrix sign of X and (s/2) Y the PSD projection of the unscaled block
// (models/shell.psd_project_blocks does the scaling and the clamp test).
// X is symmetric (psd_project_blocks symmetrizes it exactly), so every
// iterate, a polynomial in X, is symmetric too; X Z is not, in rounding,
// since the computed Z does not commute with X exactly.
//
// The TPU kernel packs 14 (or 7) blocks into one block-diagonal 128 x 128
// tile so that the MXU gets a large matmul, and selects the blocks back
// out with 0/1 einsums. None of that is needed here. The body follows
// from d and the type:
//
// - registers (9 x 9 in f32, the balloon's path): one thread per block.
//   The iterate lives in registers as its 45 upper-triangle entries
//   (read from X's upper triangle), and each product Z Z and (Z Z) Z is
//   evaluated for i <= j only: 405 FMAs where the full product takes 729.
//   Every index is a compile-time constant of fully unrolled loops, so the
//   arrays stay in registers: Z, Z Z and (Z Z) Z are 135 live floats. The
//   last product X Z is computed in full, row by row with X's row read
//   from shared memory: mirroring its upper triangle instead left a
//   least eigenvalue of -1.1e-5 in Y / 2 on blocks with eigenvalues at
//   the schedule's edges, where the full product leaves -6e-8, as the
//   plain version does. A CTA of kSymBlocks blocks stages X through shared
//   memory with coalesced loads of its kSymBlocks x 81 contiguous values;
//   a thread then reads its block at a stride of 81 words, which is odd,
//   so without bank conflicts, and Y goes back the same way. No barrier
//   runs between the load and the store: each thread works on its own
//   block alone.
// - tiled (9 x 9 in f64, 18 x 18 in f32 and f64): a thread per block cannot
//   hold these in its 255 registers (135 doubles, or 3 x 171 floats), so a
//   team of lanes owns a block, with its iterate Z and Z Z in shared memory,
//   held in full so that both operands of a product are read by rows: for
//   symmetric Z and Y, entry (i, j) of Z Y is row i of Z dotted with row j
//   of Y. The D x D block is cut into G x G tiles of R x R (R = kTile18 = 6
//   at 18 x 18, 3 at 9 x 9), and each lane of the team computes one tile on
//   or above the diagonal in registers (6 lanes a block, 5 blocks a warp):
//   per step of q it loads 2R words for R^2 FMAs, and the lanes of one tile
//   row read the same words, so a load instruction is one shared-memory
//   wavefront for the whole warp (the strides and pads of Tiled<> spread
//   its rows over the banks). Z Z and (Z Z) Z are computed on those tiles
//   only and mirrored, so Z stays exactly symmetric; the lane keeps its own
//   tile of Z in registers for the update. The last product X Z is
//   computed in full (D^2 entries, a lane RP rows), never mirrored, as in
//   the register body. The team fits in a warp, so __syncwarp is its only
//   barrier: three a cubic step. A warp stages its blocks with coalesced
//   loads of their D x D contiguous values and writes Y back through
//   shared memory the same way. kernel_ab.py psd timed R = 3 (21 lanes a
//   block, one block a warp) against R = 6, and the unroll of the loop over
//   q (kUnrollQ) and the strides; PERF.md has the readings.
//   This replaces an earlier shared-memory body, a CTA of one thread per output
//   entry reading two shared words per FMA over full D^3 products, which
//   ran at 5-7% of its bound: an SM serves 32 words a clock from shared
//   memory against 128 f32 (64 f64) FMAs, so that body could not pass 1/8
//   of the peak, and only 53% of its FMAs were needed.
//
// Precision: CUDA cores only, in the working type (f32 or f64), no tensor
// cores and no TF32. The growth cubics amplify rounding of the inputs
// about 700-fold on directions with small eigenvalues; bf16 inputs left
// blocks unprojected (min-eig-rel -0.44) in the reference's own study, and
// TF32's 10-bit mantissa is the same class of error. At 9 x 9 a tensor
// core tile pads to 16 x 16, and a split-3 x TF32 product would do about
// 30 times the useful work, so the CUDA cores are also the faster route.
// probes/psd_precision.py measures both on the card beside this kernel
// (csrc/psd_probe.cu: every product on mma.sync TF32, one pass or split
// into three): both are slower, and one pass leaves blocks unprojected.
// At 18 x 18, 3 x TF32 on m16n8k8 pads to 32 x 24 x 24, ~3.2x the useful
// MACs, 9.5x over three passes: at most ~52 useful TFLOP/s against the
// CUDA cores' 67. In f64, DMMA (mma.sync m8n8k4, 67 TFLOP/s) pads 18 x 18
// to 24 x 24 x 20, ~2x the MACs: ~34 useful TFLOP/s, the f64 CUDA cores'
// own peak, so it gains nothing and is not built.
// Both bodies sum each product entry in the order q = 0..d-1, as a chain
// of FMAs; the plain PyTorch version's bmm sums in its own order.
//
// Bound: per d x d block 25 symmetric products of d(d+1)/2 x d FMAs (810
// FLOP at 9 x 9, 6,156 at 18 x 18; the bodies do 24 of them and one full
// product) for 2 d^2 values of traffic, so operations: at bunny_15K's
// 31,604 faces 0.64 GFLOP at 9 x 9, 9.55 us at the card's f32 CUDA-core
// peak, and 4.86 GFLOP at 18 x 18, 72.6 us (f64: 143 us at 34 TFLOP/s).
// The register body issues its FMAs from 988 warps, about two per
// scheduler; each warp has 45 independent FMA chains per product, which
// hides the FMA latency without more occupancy. The tiled body at R = 6
// issues 36 FMAs per 12 single-wavefront loads, 79% of them useful (the
// diagonal tiles' lower halves are not), but each product also stores its
// tile and the mirror, 72 stores a lane at 1.6-2.6 wavefronts each (the
// 30 lanes' block and tile offsets meet in the banks). It reaches 21-29%
// of the operations bound at 18 x 18 (kernel_ab.py psd), with the FMA
// pipe about a third busy: the shared-memory traffic is the suspect.
// Storing no mirrors (reading by column where a row is not stored) and
// 9 x 9 tiles in f32 (3 lanes a block) both measured slower (PERF.md).
// Entry points have a plain C interface (loaded with ctypes) and return
// cudaGetLastError() of the launch; they launch on the given stream,
// allocate nothing and do not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSteps = 32;
constexpr int kSymBlocks = 64;  // blocks (threads) per CTA of the register body

struct Schedule {
  double a[kMaxSteps];
  double b[kMaxSteps];
  int n;
};

// Packed index of entry (i, j) of a symmetric D x D matrix held as its
// upper triangle, row by row. Not recursive, so it inlines and folds to a
// constant wherever i and j are unrolled loop indices.
template <int D>
__host__ __device__ constexpr int up(int i, int j) {
  return i <= j ? i * D - i * (i - 1) / 2 + (j - i) : j * D - j * (j - 1) / 2 + (i - j);
}

template <int D>
constexpr int kTri = D * (D + 1) / 2;

// P = A B for symmetric A and B whose product is symmetric (here they
// commute: both are polynomials in one X), upper triangle only. Every loop
// has a constant trip count (the triangle is a test on j >= i), so full
// unrolling leaves constant indices and the arrays in registers.
template <int D>
__device__ __forceinline__ void sym_product(const float (&A)[kTri<D>],
                                            const float (&B)[kTri<D>],
                                            float (&P)[kTri<D>]) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      if (j >= i) {
        float acc = A[up<D>(i, 0)] * B[up<D>(0, j)];
#pragma unroll
        for (int q = 1; q < D; ++q) acc = fmaf(A[up<D>(i, q)], B[up<D>(q, j)], acc);
        P[up<D>(i, j)] = acc;
      }
    }
  }
}

// kArith = false compiles the arithmetic out: the CTA stages X and writes
// it back as Y, the loads and stores of the body alone (Y = X; the copy
// stage of the probes' stage timing, probes/psd_stages.py).
template <int D, bool kArith = true>
__global__ void __launch_bounds__(kSymBlocks)
ns_sign_apply_registers_kernel(const float* __restrict__ X, float* __restrict__ Y, int m,
                               Schedule sched) {
  constexpr int DD = D * D;
  constexpr int N = kTri<D>;
  __shared__ float stage[kSymBlocks * DD];
  const int t = threadIdx.x;
  const int64_t g0 = (int64_t)blockIdx.x * kSymBlocks;
  const int64_t left = (int64_t)m - g0;
  const int nblk = left < kSymBlocks ? (int)left : kSymBlocks;
  const float* src = X + g0 * DD;
  for (int k = t; k < nblk * DD; k += kSymBlocks) stage[k] = src[k];
  __syncthreads();
  if (kArith && t < nblk) {
    float* mine = stage + t * DD;
    float z[N], z2[N], zn[N];
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        if (j >= i) z[up<D>(i, j)] = mine[i * D + j];
      }
    }
    for (int step = 0; step < sched.n; ++step) {
      const float a = static_cast<float>(sched.a[step]);
      const float b = static_cast<float>(sched.b[step]);
      sym_product<D>(z, z, z2);
      sym_product<D>(z2, z, zn);  // (Z Z) Z
#pragma unroll
      for (int k = 0; k < N; ++k) z[k] = a * z[k] - b * zn[k];
    }
    // Y = X + X Z in full, row by row: row i of X goes to registers and
    // row i of Y overwrites it in the stage
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float xr[D];
#pragma unroll
      for (int q = 0; q < D; ++q) xr[q] = mine[i * D + q];
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float acc = xr[0] * z[up<D>(0, j)];
#pragma unroll
        for (int q = 1; q < D; ++q) acc = fmaf(xr[q], z[up<D>(q, j)], acc);
        mine[i * D + j] = xr[j] + acc;
      }
    }
  }
  __syncthreads();
  float* dst = Y + g0 * DD;
  for (int k = t; k < nblk * DD; k += kSymBlocks) dst[k] = stage[k];
}

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// The tiled body's layout for (T, D, R): G x G tiles of R x R entries; a
// block is owned by NT lanes, one per tile on or above the diagonal, and a
// warp holds BPW blocks. Tile (ti, tj) holds rows ti + G u and columns
// tj + G v (u, v < R): interleaved, so that the rows one load instruction
// reads differ by multiples of the odd stride S. Each block keeps two
// matrices in shared memory, Z and W, of D rows at stride S, and PAD
// elements follow them: with these strides and pads the 3 x BPW distinct
// rows a warp's operand load touches lie in distinct banks (4-byte words)
// or bank pairs (doubles), so each load instruction is one wavefront that
// serves every lane of its tile row. RP: rows a lane computes of the last
// product. WPC: warps a CTA, as many as 48 KB of static shared memory take
// (at most 4). MIN_CTAS: CTAs an SM should hold, as many as its shared
// memory takes while a lane keeps at least 64 registers (f32) or 96 (f64);
// it caps the registers (__launch_bounds__), since the compiler would
// otherwise take ~255 a lane and hold 2 CTAs an SM.
template <typename T, int D, int R>
struct Tiled {
  static_assert(D % R == 0, "R must divide D");
  static constexpr bool F64 = sizeof(T) == 8;
  static constexpr int G = D / R;
  static constexpr int NT = G * (G + 1) / 2;
  static_assert(NT <= 32, "a block's team must fit in a warp");
  static constexpr int BPW = 32 / NT;
  static constexpr int S = D | 1;
  static constexpr int MAT = D * S;
  static constexpr int PAD = !F64 ? 0 : D == 18 && R == 6 ? 11 : D == 9 ? 3 : 0;
  static constexpr int BLK = 2 * MAT + PAD;
  static constexpr int RP = (D + NT - 1) / NT;
  static constexpr int WARP_BYTES = BPW * BLK * (int)sizeof(T);
  static constexpr int WPC = 48 * 1024 / WARP_BYTES < 1   ? 1
                             : 48 * 1024 / WARP_BYTES > 4 ? 4
                                                          : 48 * 1024 / WARP_BYTES;
  static constexpr int BY_SMEM = 232448 / (WPC * WARP_BYTES + 1024);
  static constexpr int BY_REGS = 65536 / ((F64 ? 96 : 64) * WPC * 32);
  static constexpr int MIN_CTAS = BY_SMEM < BY_REGS ? BY_SMEM : BY_REGS;
};

// Unroll factor of a tile product's loop over q
constexpr int kUnrollQ = 6;

// acc[u][v] = sum_q A[i_u][q] B[j_v][q] over rows i_u = ti + G u of A and
// j_v = tj + G v of B: entry (i_u, j_v) of A B, since B is symmetric (held
// in full). Summed in the order q = 0..D-1, a chain of FMAs from 0 (the
// first, fma(a, b, 0), rounds as a b does), as the register body sums. The
// loop over q is unrolled kUnrollQ times, not fully: unrolled fully, the
// compiler hoists its loads and spills.
template <typename T, int D, int R>
__device__ __forceinline__ void tile_product(const T* A, const T* B, int ti, int tj,
                                             T (&acc)[R][R]) {
  using L = Tiled<T, D, R>;
  const T* a = A + ti * L::S;
  const T* b = B + tj * L::S;
#pragma unroll
  for (int u = 0; u < R; ++u) {
#pragma unroll
    for (int v = 0; v < R; ++v) acc[u][v] = T(0);
  }
#pragma unroll(kUnrollQ)
  for (int q = 0; q < D; ++q) {
    T av[R], bv[R];
#pragma unroll
    for (int u = 0; u < R; ++u) av[u] = a[L::G * u * L::S + q];
#pragma unroll
    for (int v = 0; v < R; ++v) bv[v] = b[L::G * v * L::S + q];
#pragma unroll
    for (int u = 0; u < R; ++u) {
#pragma unroll
      for (int v = 0; v < R; ++v) acc[u][v] = fma_t(av[u], bv[v], acc[u][v]);
    }
  }
}

// Writes the tile to M and its mirror image below the diagonal; a diagonal
// tile writes its entries u <= v (i <= j) and their mirrors, so M stays
// exactly symmetric.
template <typename T, int D, int R>
__device__ __forceinline__ void store_symmetric(T* M, int ti, int tj, const T (&acc)[R][R]) {
  using L = Tiled<T, D, R>;
#pragma unroll
  for (int u = 0; u < R; ++u) {
#pragma unroll
    for (int v = 0; v < R; ++v) {
      if (ti != tj || u <= v) {
        const int i = ti + L::G * u, j = tj + L::G * v;
        M[i * L::S + j] = acc[u][v];
        M[j * L::S + i] = acc[u][v];
      }
    }
  }
}

// The tiled body (9 x 9 in f64, 18 x 18 in f32 and f64). A warp runs BPW
// blocks on its own, synchronised by __syncwarp alone: it stages its blocks'
// upper triangles (coalesced loads of BPW x D x D contiguous values)
// mirrored into Z, runs the schedule on Z with W holding Z Z, then reloads X
// into W and computes Y = X + X Z in full: a lane takes rows r_u = tile +
// NT u, reads X's row r_u (no other lane does) and all of Z, and writes row
// r_u of Y over it; the warp then stores Y with coalesced writes.
template <typename T, int D, int R>
__global__ void __launch_bounds__((Tiled<T, D, R>::WPC * 32), (Tiled<T, D, R>::MIN_CTAS))
ns_sign_apply_tiled_kernel(const T* __restrict__ X, T* __restrict__ Y, int m, Schedule sched) {
  using L = Tiled<T, D, R>;
  constexpr int DD = D * D, G = L::G, S = L::S;
  __shared__ T smem[L::WPC * L::BPW * L::BLK];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t g0 = ((int64_t)blockIdx.x * L::WPC + warp) * L::BPW;
  if (g0 >= m) return;  // the whole warp
  const int64_t left = (int64_t)m - g0;
  const int nb = left < L::BPW ? (int)left : L::BPW;
  T* base = smem + warp * L::BPW * L::BLK;
  const int slot = lane / L::NT;
  const bool active = slot < L::BPW;
  const int tile = active ? lane % L::NT : 0;
  T* Z = base + (active ? slot : 0) * L::BLK;
  T* W = Z + L::MAT;
  int ti = 0, rem = tile;
  while (rem >= G - ti) {
    rem -= G - ti;
    ++ti;
  }
  const int tj = ti + rem;
  const T* src = X + g0 * DD;

  // Z = X from its upper triangle; blocks past m hold zeros
#pragma unroll
  for (int blk = 0; blk < L::BPW; ++blk) {
    T* z = base + blk * L::BLK;
    for (int e = lane; e < DD; e += 32) {
      const int i = e / D, j = e % D;
      if (i <= j) {
        const T v = blk < nb ? src[blk * DD + e] : T(0);
        z[i * S + j] = v;
        z[j * S + i] = v;
      }
    }
  }
  __syncwarp();
  // the lane's tile of Z stays in registers: the update needs no loads
  T zt[R][R], acc[R][R];
#pragma unroll
  for (int u = 0; u < R; ++u) {
#pragma unroll
    for (int v = 0; v < R; ++v) zt[u][v] = Z[(ti + G * u) * S + tj + G * v];
  }
  for (int step = 0; step < sched.n; ++step) {
    const T a = static_cast<T>(sched.a[step]);
    const T b = static_cast<T>(sched.b[step]);
    if (active) {
      tile_product<T, D, R>(Z, Z, ti, tj, acc);
      store_symmetric<T, D, R>(W, ti, tj, acc);  // W = Z Z
    }
    __syncwarp();
    if (active) {
      tile_product<T, D, R>(W, Z, ti, tj, acc);  // (Z Z) Z
#pragma unroll
      for (int u = 0; u < R; ++u) {
#pragma unroll
        for (int v = 0; v < R; ++v) zt[u][v] = a * zt[u][v] - b * acc[u][v];
      }
    }
    __syncwarp();
    if (active) store_symmetric<T, D, R>(Z, ti, tj, zt);
    __syncwarp();
  }

  // Y = X + X Z in full, over W = X as given
#pragma unroll
  for (int blk = 0; blk < L::BPW; ++blk) {
    T* w = base + blk * L::BLK + L::MAT;
    for (int e = lane; e < DD; e += 32) w[(e / D) * S + e % D] = blk < nb ? src[blk * DD + e] : T(0);
  }
  __syncwarp();
  if (active) {
    T y[L::RP][D];
    const T* xr[L::RP];
#pragma unroll
    for (int u = 0; u < L::RP; ++u) {
      const int r = tile + L::NT * u;
      // a row past D is computed from row 0 of Z, which no lane writes
      // here, and not stored
      xr[u] = r < D ? W + r * S : Z;
#pragma unroll
      for (int j = 0; j < D; ++j) y[u][j] = T(0);
    }
#pragma unroll 2
    for (int q = 0; q < D; ++q) {
      T xq[L::RP];
#pragma unroll
      for (int u = 0; u < L::RP; ++u) xq[u] = xr[u][q];
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const T zq = Z[j * S + q];
#pragma unroll
        for (int u = 0; u < L::RP; ++u) y[u][j] = fma_t(xq[u], zq, y[u][j]);
      }
    }
#pragma unroll
    for (int u = 0; u < L::RP; ++u) {
      if (tile + L::NT * u < D) {
        T* yr = W + (tile + L::NT * u) * S;
#pragma unroll
        for (int j = 0; j < D; ++j) yr[j] = yr[j] + y[u][j];
      }
    }
  }
  __syncwarp();
  T* dst = Y + g0 * DD;
#pragma unroll
  for (int blk = 0; blk < L::BPW; ++blk) {
    const T* w = base + blk * L::BLK + L::MAT;
    if (blk < nb) {
      for (int e = lane; e < DD; e += 32) dst[blk * DD + e] = w[(e / D) * S + e % D];
    }
  }
}

// Tile side of the 18 x 18 blocks (kernel_ab.py psd times 3 against 6)
constexpr int kTile18 = 6;

template <typename T, int D, int R>
void launch_tiled(const T* X, T* Y, int m, const Schedule& sched, cudaStream_t stream) {
  using L = Tiled<T, D, R>;
  constexpr int per_cta = L::WPC * L::BPW;
  const int grid = (int)(((int64_t)m + per_cta - 1) / per_cta);
  ns_sign_apply_tiled_kernel<T, D, R><<<grid, L::WPC * 32, 0, stream>>>(X, Y, m, sched);
}

template <typename T>
int ns_sign_apply(const T* X, T* Y, int m, int d, const double* schedule, int steps,
                  void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (steps < 0 || steps > kMaxSteps) return static_cast<int>(cudaErrorInvalidValue);
  if (d != 9 && d != 18) return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  Schedule sched;
  sched.n = steps;
  for (int i = 0; i < steps; ++i) {
    sched.a[i] = schedule[2 * i];
    sched.b[i] = schedule[2 * i + 1];
  }
  if (d == 18) {
    launch_tiled<T, 18, kTile18>(X, Y, m, sched, stream);
  } else if constexpr (sizeof(T) == sizeof(float)) {
    const int grid = (m + kSymBlocks - 1) / kSymBlocks;
    ns_sign_apply_registers_kernel<9><<<grid, kSymBlocks, 0, stream>>>(X, Y, m, sched);
  } else {
    launch_tiled<T, 9, 3>(X, Y, m, sched, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

int ns_sign_copy(const float* X, float* Y, int m, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  const int grid = (m + kSymBlocks - 1) / kSymBlocks;
  ns_sign_apply_registers_kernel<9, false><<<grid, kSymBlocks, 0, stream>>>(X, Y, m, Schedule{});
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// schedule: host array of `steps` (a, b) pairs, copied into the launch.
extern "C" int smg_ns_sign_apply_f32(const float* X, float* Y, int m, int d,
                                     const double* schedule, int steps, void* stream) {
  return ns_sign_apply<float>(X, Y, m, d, schedule, steps, stream);
}

extern "C" int smg_ns_sign_apply_f64(const double* X, double* Y, int m, int d,
                                     const double* schedule, int steps, void* stream) {
  return ns_sign_apply<double>(X, Y, m, d, schedule, steps, stream);
}

// The register body's loads and stores alone, 9 x 9 f32 (Y = X).
extern "C" int smg_ns_sign_copy_f32(const float* X, float* Y, int m, void* stream) {
  return ns_sign_copy(X, Y, m, stream);
}

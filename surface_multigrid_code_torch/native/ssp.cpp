// SSP decimation engine (host precompute stage of the TPU framework).
//
// Greedy edge-collapse decimation maintaining a successive
// self-parameterization (SSP): every accepted collapse stores the joint
// LSCM flattening of its pre/post one-ring patches, giving a bijective map
// between consecutive meshes.  Fresh implementation of the behavior of
// reference HTDerekLiu/surface_multigrid_code:
//   - generic greedy loop w/ lazy min-heap  (src/SSP_midpoint.cpp:119-245)
//   - collapse kernel + SSP record          (src/SSP_collapse_edge.cpp)
//   - cost/placement plugins: midpoint (igl::shortest_edge_and_midpoint
//     semantics), qslim quadrics, vertex-removal
//     (src/SSP_qslim*.cpp, src/SSP_vertexRemoval*.cpp)
//   - randomized variants: pop a uniformly random element among the top
//     1 + (rand()%100) heap entries (src/SSP_random_collapse_edge.cpp:408-431)
//   - bidirectional point queries through the collapse log
//     (src/query_fine_to_coarse.cpp, src/query_coarse_to_fine.cpp)
//
// The engine emits FLAT arrays (CSR-style offsets) so the Python/JAX side
// can consume, serialize, and later device-vectorize the collapse log.
//
// Build:  g++ -O3 -march=native -std=c++17 -fPIC -shared -fopenmp ssp.cpp -o libssp.so (portable fallback without -march=native; see ssp/_native.py)

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <limits>
#include <queue>
#include <random>
#include <tuple>
#include <vector>

#include "dense.hpp"
#include "lscm.hpp"
#include "mesh.hpp"

namespace ssp {

static constexpr double kInf = std::numeric_limits<double>::infinity();

// ---------------------------------------------------------------------------
// phase profiler (SSP_PROFILE=1 env; ~0 cost when off).  Chained phases:
// stop(k) restarts the clock so consecutive phases need no start() calls.
// ---------------------------------------------------------------------------
struct PhaseProf {
  static constexpr int kN = 12;
  bool on = false;
  double t[kN] = {0};
  long long n[kN] = {0};
  std::chrono::steady_clock::time_point t0;
  void start() {
    if (on) t0 = std::chrono::steady_clock::now();
  }
  void stop(int k) {
    if (!on) return;
    auto t1 = std::chrono::steady_clock::now();
    t[k] += std::chrono::duration<double>(t1 - t0).count();
    n[k] += 1;
    t0 = t1;
  }
  void report() const {
    if (!on) return;
    const char* names[kN] = {
        "initial_costs", "heap_pop",      "circulate_link", "patch_assemble",
        "joint_lscm",    "decim_push",    "surgery",        "quadric_merge",
        "cost_refresh",  "compaction",    "flaps_manifold", "arena_append"};
    double tot = 0;
    for (int k = 0; k < kN; ++k) tot += t[k];
    std::printf("[ssp-profile] total accounted %.3f s\n", tot);
    for (int k = 0; k < kN; ++k)
      if (n[k])
        std::printf("[ssp-profile] %-15s %8.3f s  (%5.1f%%)  x%lld\n",
                    names[k], t[k], 100.0 * t[k] / tot, n[k]);
  }
};
// thread_local: ctypes releases the GIL during foreign calls, so two
// Python threads may run ssp_decimate concurrently; per-thread state
// keeps the profiler (and the thread_local scratch below) race-free.
// Each thread still runs at most one decimate at a time (the scratch
// vectors are per-thread, not per-call) - see the C API note.
static thread_local PhaseProf g_prof;

// ---------------------------------------------------------------------------
// collapse log — flat CSR arena.  Records append directly into the
// arrays ssp_result_fill hands to Python (one growing allocation per
// array instead of ~7 vectors per collapse; the per-record std::vector
// log was 11% of the ico9 build in the round-4 phase profile).  Layout
// matches the C API exactly: *off arrays carry the leading 0, so they
// are the n+1-entry offset arrays verbatim.
// ---------------------------------------------------------------------------
struct FlatLogStore {
  i64 n = 0;
  std::vector<i64> b;                    // 2n: local ids of (vi, vj)
  std::vector<i64> voff{0};              // n+1
  std::vector<i64> subset;               // sorted global patch vertex ids
  std::vector<double> uv_pre, uv_post;   // 2 * voff[n]
  std::vector<i64> foff_pre{0}, fuv_pre, fidx_pre;
  std::vector<i64> foff_post{0}, fuv_post, fidx_post;
};

// ---------------------------------------------------------------------------
// cost plugins
// ---------------------------------------------------------------------------
struct Quadric {
  double A[9] = {0};
  double b[3] = {0};
  double c = 0;
  void add(const Quadric& o) {
    for (int i = 0; i < 9; ++i) A[i] += o.A[i];
    for (int i = 0; i < 3; ++i) b[i] += o.b[i];
    c += o.c;
  }
  double eval(const double p[3]) const {
    double Ap[3] = {0, 0, 0};
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) Ap[i] += p[j] * A[3 * j + i];  // p * A
    return p[0] * Ap[0] + p[1] * Ap[1] + p[2] * Ap[2] +
           2 * (p[0] * b[0] + p[1] * b[1] + p[2] * b[2]) + c;
  }
};

// Per-vertex point-to-plane quadrics (igl::per_vertex_point_to_plane_quadrics
// semantics, used by reference src/SSP_qslim.cpp:46): each real face adds its
// area/3-weighted plane quadric to its corners; each virtual (boundary) face
// adds a perpendicular-through-the-edge plane quadric to the two real
// endpoints, preserving boundaries.  A tiny pull toward the original
// position keeps A invertible.
static void vertex_quadrics(const FlapMesh& M, std::vector<Quadric>& q) {
  const i64 n = M.nV;
  q.assign(n, Quadric());
  const double w0 = 1e-10;
  for (i64 v = 0; v < n; ++v) {
    if (v == M.virtual_vertex) continue;
    const double* p = &M.V[3 * v];
    for (int i = 0; i < 3; ++i) q[v].A[4 * i] = w0;
    for (int i = 0; i < 3; ++i) q[v].b[i] = -w0 * p[i];
    q[v].c = w0 * (p[0] * p[0] + p[1] * p[1] + p[2] * p[2]);
  }
  auto face_normal = [&](i64 f, double nrm[3], double& dblA) {
    const double* a = &M.V[3 * M.F[3 * f]];
    const double* b = &M.V[3 * M.F[3 * f + 1]];
    const double* c = &M.V[3 * M.F[3 * f + 2]];
    const double u[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
    const double w[3] = {c[0] - a[0], c[1] - a[1], c[2] - a[2]};
    nrm[0] = u[1] * w[2] - u[2] * w[1];
    nrm[1] = u[2] * w[0] - u[0] * w[2];
    nrm[2] = u[0] * w[1] - u[1] * w[0];
    dblA = std::sqrt(nrm[0] * nrm[0] + nrm[1] * nrm[1] + nrm[2] * nrm[2]);
    if (dblA > 0)
      for (int i = 0; i < 3; ++i) nrm[i] /= dblA;
  };
  auto add_plane = [&](i64 v, const double nrm[3], double d, double w) {
    Quadric k;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) k.A[3 * i + j] = w * nrm[i] * nrm[j];
    for (int i = 0; i < 3; ++i) k.b[i] = w * d * nrm[i];
    k.c = w * d * d;
    q[v].add(k);
  };
  for (i64 f = 0; f < M.nF(); ++f) {
    if (!M.face_alive(f)) continue;
    if (!M.face_is_virtual(f)) {
      double nrm[3], dblA;
      face_normal(f, nrm, dblA);
      const double* a = &M.V[3 * M.F[3 * f]];
      const double d = -(nrm[0] * a[0] + nrm[1] * a[1] + nrm[2] * a[2]);
      const double w = dblA / 6.0;  // area/3 per corner
      for (int c = 0; c < 3; ++c) add_plane(M.F[3 * f + c], nrm, d, w);
    } else {
      // boundary edge = the two non-virtual corners
      i64 vs[2];
      int k = 0, cv = -1;
      for (int c = 0; c < 3; ++c) {
        const i64 v = M.F[3 * f + c];
        if (v == M.virtual_vertex)
          cv = c;
        else
          vs[k++] = v;
      }
      if (k != 2) continue;
      // neighboring real face across the boundary edge
      const i64 e = M.EMAP[3 * f + cv];
      const i64 g = (M.EF[2 * e] == f) ? M.EF[2 * e + 1] : M.EF[2 * e];
      if (g == kDead) continue;
      double nrm[3], dblA;
      face_normal(g, nrm, dblA);
      const double* a = &M.V[3 * vs[0]];
      const double* b = &M.V[3 * vs[1]];
      const double ev[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
      double en[3] = {ev[1] * nrm[2] - ev[2] * nrm[1],
                      ev[2] * nrm[0] - ev[0] * nrm[2],
                      ev[0] * nrm[1] - ev[1] * nrm[0]};
      const double len = std::sqrt(en[0] * en[0] + en[1] * en[1] + en[2] * en[2]);
      if (len == 0) continue;
      for (int i = 0; i < 3; ++i) en[i] /= len;
      const double d = -(en[0] * a[0] + en[1] * a[1] + en[2] * a[2]);
      const double elen2 = ev[0] * ev[0] + ev[1] * ev[1] + ev[2] * ev[2];
      add_plane(vs[0], en, d, elen2 / 2);
      add_plane(vs[1], en, d, elen2 / 2);
    }
  }
}

enum DecType { kQslim = 0, kMidpoint = 1, kVertexRemoval = 2 };

// cost & placement for edge e (reference plugin semantics)
static void cost_and_placement(const FlapMesh& M,
                               const std::vector<Quadric>& quadrics,
                               int dec_type, i64 e, double& cost, double p[3]) {
  const i64 a = M.E[2 * e], b = M.E[2 * e + 1];
  if (a == kDead) {
    cost = kInf;
    p[0] = p[1] = p[2] = 0;
    return;
  }
  const double* va = &M.V[3 * a];
  const double* vb = &M.V[3 * b];
  if (dec_type == kMidpoint) {
    // igl::shortest_edge_and_midpoint semantics
    const double dx = va[0] - vb[0], dy = va[1] - vb[1], dz = va[2] - vb[2];
    cost = std::sqrt(dx * dx + dy * dy + dz * dz);
    for (int i = 0; i < 3; ++i) p[i] = 0.5 * (va[i] + vb[i]);
    if (std::isinf(cost) || std::isnan(cost)) {
      cost = kInf;
      p[0] = p[1] = p[2] = 0;
    }
    return;
  }
  Quadric qe = quadrics[a];
  qe.add(quadrics[b]);
  if (dec_type == kQslim) {
    // optimal placement p = -b A^-1 (reference
    // src/SSP_qslim_optimal_collapse_edge_callbacks.cpp:39-44)
    if (!quadric_minimizer(qe.A, qe.b, p)) {
      cost = kInf;
      p[0] = p[1] = p[2] = 0;
      return;
    }
    cost = qe.eval(p);
  } else {
    // vertex removal: cheaper endpoint (reference
    // src/SSP_vertexRemoval_optimal_collapse_edge_callbacks.cpp:42-57)
    const double c0 = qe.eval(va), c1 = qe.eval(vb);
    if (c0 < c1) {
      cost = c0;
      for (int i = 0; i < 3; ++i) p[i] = va[i];
    } else {
      cost = c1;
      for (int i = 0; i < 3; ++i) p[i] = vb[i];
    }
  }
  if (std::isinf(cost) || std::isnan(cost)) {
    cost = kInf;
    p[0] = p[1] = p[2] = 0;
  }
}

// ---------------------------------------------------------------------------
// the engine
// ---------------------------------------------------------------------------
struct Result {
  bool ok = false;
  bool clean_finish = false;
  i64 orig_nV = 0, orig_nF = 0, nF_working = 0;
  std::vector<double> Vc;
  std::vector<i64> Fc;
  std::vector<i64> IM;   // coarse vertex -> original vertex id
  std::vector<i64> IMF;  // coarse face   -> original face id (J)
  std::vector<i64> FIM;  // working face  -> compact face id
  FlatLogStore log;
  std::vector<std::vector<i64>> decIM;  // working face -> collapse ids (asc)
};

// (cost, edge, timestamp) with lexicographic order — (edge, timestamp)
// pairs are unique, so the order is strict and total: ANY correct
// min-heap pops the exact same sequence.  4-ary layout halves the tree
// depth of the binary std::priority_queue and keeps each child scan in
// ~1.5 cache lines; heap_pop was 16% of the ico9 build (phase profile).
struct HeapEntry {
  double cost;
  i64 e, ts;
  bool less(const HeapEntry& o) const {
    if (cost != o.cost) return cost < o.cost;
    if (e != o.e) return e < o.e;
    return ts < o.ts;
  }
};

struct MinHeap {
  std::vector<HeapEntry> a;
  bool empty() const { return a.empty(); }
  size_t size() const { return a.size(); }
  const HeapEntry& top() const { return a[0]; }
  void build(std::vector<HeapEntry>&& v) {
    a = std::move(v);
    if (a.size() > 1)
      for (i64 i = ((i64)a.size() - 2) / 4; i >= 0; --i) sift_down(i);
  }
  void emplace(double cost, i64 e, i64 ts) { push({cost, e, ts}); }
  void push(const HeapEntry& x) {
    a.push_back(x);
    i64 i = (i64)a.size() - 1;
    while (i > 0) {
      const i64 par = (i - 1) / 4;
      if (!a[i].less(a[par])) break;
      std::swap(a[i], a[par]);
      i = par;
    }
  }
  void pop() {
    a[0] = a.back();
    a.pop_back();
    if (!a.empty()) sift_down(0);
  }
  void sift_down(i64 i) {
    const i64 n = (i64)a.size();
    for (;;) {
      const i64 c0 = 4 * i + 1;
      if (c0 >= n) return;
      i64 best = c0;
      const i64 cend = std::min(c0 + 4, n);
      for (i64 c = c0 + 1; c < cend; ++c)
        if (a[c].less(a[best])) best = c;
      if (!a[best].less(a[i])) return;
      std::swap(a[i], a[best]);
      i = best;
    }
  }
};

// Attempt one collapse of edge e with placement p.  Returns true on success
// (record appended, topology updated).  Mirrors reference
// src/SSP_collapse_edge.cpp:17-379 behavior.
static bool try_collapse(FlapMesh& M, i64 e, const double p[3],
                         FlatLogStore& log,
                         std::vector<std::vector<i64>>& decIM,
                         std::vector<i64>& sfaces, std::vector<i64>& dfaces,
                         i64 killed_edges[2], i64 killed_faces[2],
                         int verbose) {
  const i64 s = std::min(M.E[2 * e], M.E[2 * e + 1]);
  const i64 d = std::max(M.E[2 * e], M.E[2 * e + 1]);
  g_prof.start();
  static thread_local std::vector<i64> sring, dring;
  circulate(M, e, s, sfaces, sring);
  circulate(M, e, d, dfaces, dring);
  if (!link_condition(sring, dring)) {
    g_prof.stop(2);
    return false;
  }
  if (s == M.virtual_vertex || d == M.virtual_vertex) {
    g_prof.stop(2);
    return false;
  }
  g_prof.stop(2);

  if (verbose && (log.n + 1) % 100000 == 0)
    std::printf("#collapses: %lld\n", (long long)(log.n + 1));

  // one-ring faces (reference get_collapse_onering_faces): alive, real,
  // touching s or d; sorted unique ascending (thread-local scratch; the
  // arrays are appended into the flat log only on success)
  static thread_local std::vector<i64> FIdx_pre;
  FIdx_pre.clear();
  for (const auto* fs : {&sfaces, &dfaces})
    for (const i64 f : *fs) {
      if (!M.face_alive(f) || M.face_is_virtual(f)) continue;
      if (M.face_has_vertex(f, s) || M.face_has_vertex(f, d))
        FIdx_pre.push_back(f);
    }
  std::sort(FIdx_pre.begin(), FIdx_pre.end());
  FIdx_pre.erase(std::unique(FIdx_pre.begin(), FIdx_pre.end()), FIdx_pre.end());
  const i64 nf_pre = (i64)FIdx_pre.size();

  // localize patch (reference remove_unreferenced_lessF): sorted unique ids
  static thread_local std::vector<i64> subset;
  subset.clear();
  subset.reserve(3 * nf_pre);
  for (const i64 f : FIdx_pre)
    for (int c = 0; c < 3; ++c) subset.push_back(M.F[3 * f + c]);
  std::sort(subset.begin(), subset.end());
  subset.erase(std::unique(subset.begin(), subset.end()), subset.end());
  const i64 nVp = (i64)subset.size();
  auto local_id = [&](i64 v) {
    return (i64)(std::lower_bound(subset.begin(), subset.end(), v) -
                 subset.begin());
  };
  static thread_local std::vector<i64> FUV_pre;
  FUV_pre.assign(3 * nf_pre, 0);
  for (i64 k = 0; k < nf_pre; ++k)
    for (int c = 0; c < 3; ++c)
      FUV_pre[3 * k + c] = local_id(M.F[3 * FIdx_pre[k] + c]);
  static thread_local std::vector<double> V_pre;
  V_pre.assign(3 * nVp, 0.0);
  for (i64 k = 0; k < nVp; ++k)
    for (int c = 0; c < 3; ++c) V_pre[3 * k + c] = M.V[3 * subset[k] + c];
  const i64 b0 = local_id(s), b1 = local_id(d);

  // post patch (reference get_post_faces): drop faces containing both, b1->b0
  static thread_local std::vector<i64> FUV_post, FIdx_post;
  FUV_post.clear();
  FIdx_post.clear();
  for (i64 k = 0; k < nf_pre; ++k) {
    const i64* fv = &FUV_pre[3 * k];
    const bool has0 = fv[0] == b0 || fv[1] == b0 || fv[2] == b0;
    const bool has1 = fv[0] == b1 || fv[1] == b1 || fv[2] == b1;
    if (has0 && has1) continue;
    for (int c = 0; c < 3; ++c)
      FUV_post.push_back(fv[c] == b1 ? b0 : fv[c]);
    FIdx_post.push_back(FIdx_pre[k]);
  }
  const i64 nf_post = (i64)FIdx_post.size();
  static thread_local std::vector<double> V_post;
  V_post.assign(V_pre.begin(), V_pre.end());
  for (int c = 0; c < 3; ++c) V_post[3 * b0 + c] = p[c];

  // boundary flags
  const bool vi_on_bd =
      M.virtual_vertex >= 0 &&
      std::find(sring.begin(), sring.end(), M.virtual_vertex) != sring.end();
  const bool vj_on_bd =
      M.virtual_vertex >= 0 &&
      std::find(dring.begin(), dring.end(), M.virtual_vertex) != dring.end();
  const bool edge_on_bd = M.face_is_virtual(M.EF[2 * e]) ||
                          M.face_is_virtual(M.EF[2 * e + 1]);
  g_prof.stop(3);

  // joint flatten + validity gates
  PatchLSCM P;
  P.V_pre = &V_pre;
  P.F_pre = &FUV_pre;
  P.V_post = &V_post;
  P.F_post = &FUV_post;
  P.nV = nVp;
  P.nf_pre = nf_pre;
  P.nf_post = nf_post;
  P.vi = b0;
  P.vj = b1;
  P.vi_on_bd = vi_on_bd;
  P.vj_on_bd = vj_on_bd;
  P.edge_on_bd = edge_on_bd;
  static thread_local std::vector<double> UV_pre, UV_post;
  const bool lscm_ok = joint_lscm(P, UV_pre, UV_post);
  g_prof.stop(4);
  if (!lscm_ok) return false;
  if (nf_pre <= 2) return false;  // reference src/SSP_collapse_edge.cpp:188-195

  // record: append into the flat arena
  log.b.push_back(b0);
  log.b.push_back(b1);
  log.subset.insert(log.subset.end(), subset.begin(), subset.end());
  log.voff.push_back((i64)log.subset.size());
  log.uv_pre.insert(log.uv_pre.end(), UV_pre.begin(), UV_pre.end());
  log.uv_post.insert(log.uv_post.end(), UV_post.begin(), UV_post.end());
  log.fuv_pre.insert(log.fuv_pre.end(), FUV_pre.begin(), FUV_pre.end());
  log.fidx_pre.insert(log.fidx_pre.end(), FIdx_pre.begin(), FIdx_pre.end());
  log.foff_pre.push_back((i64)log.fidx_pre.size());
  log.fuv_post.insert(log.fuv_post.end(), FUV_post.begin(), FUV_post.end());
  log.fidx_post.insert(log.fidx_post.end(), FIdx_post.begin(),
                       FIdx_post.end());
  log.foff_post.push_back((i64)log.fidx_post.size());
  const i64 dec_id = log.n;
  log.n += 1;
  g_prof.stop(11);
  for (const i64 f : FIdx_pre) decIM[f].push_back(dec_id);
  g_prof.stop(5);

  collapse_edge_topology(M, e, s, d, p, dfaces, killed_edges, killed_faces);
  g_prof.stop(6);
  return true;
}

static Result* run_decimate(const double* Vin, i64 nV, const i64* Fin, i64 nF,
                            i64 tarF, int dec_type, int use_random,
                            uint64_t seed, int verbose) {
  auto* R = new Result();
  g_prof = PhaseProf();
  g_prof.on = std::getenv("SSP_PROFILE") != nullptr;
  g_prof.start();
  FlapMesh M;
  M.nV = nV;
  M.V.assign(Vin, Vin + 3 * nV);
  M.F.assign(Fin, Fin + 3 * nF);
  R->orig_nV = nV;
  R->orig_nF = nF;

  connect_boundary_to_infinity(M);
  const bool mesh_ok =
      build_flaps(M) && all_edges_closed(M) && is_vertex_manifold(M);
  g_prof.stop(10);
  if (!mesh_ok) {
    std::printf("input mesh is not manifold\n");
    return R;  // ok=false
  }
  if (verbose) {
    const char* names[3] = {"qslim", "uniform decimation", "vertex removal"};
    std::printf("%s\n", names[dec_type == 1 ? 1 : (dec_type == 2 ? 2 : 0)]);
  }

  g_prof.start();
  std::vector<Quadric> quadrics;
  if (dec_type != kMidpoint) vertex_quadrics(M, quadrics);

  const i64 nE = M.nE();
  std::vector<double> C;  // placements
  reserve_prefault(C, 3 * nE);
  C.assign(3 * nE, 0.0);
  std::vector<i64> EQ;    // timestamps
  reserve_prefault(EQ, nE);
  EQ.assign(nE, 0);
  MinHeap Q;
  {
    std::vector<double> costs(nE);
#pragma omp parallel for schedule(static)
    for (i64 e = 0; e < nE; ++e)
      cost_and_placement(M, quadrics, dec_type, e, costs[e], &C[3 * e]);
    // bulk-construct (one O(n) make_heap instead of n sift-ups) with
    // headroom reserved for the ~15 refresh pushes per collapse.  Pop
    // order is unaffected: (cost, edge, timestamp) tuples are strictly
    // totally ordered, so any valid heap pops the same sequence.
    std::vector<HeapEntry> init;
    reserve_prefault(init, (size_t)(nE * 2));
    for (i64 e = 0; e < nE; ++e) init.push_back({costs[e], e, 0});
    Q.build(std::move(init));
  }
  g_prof.stop(0);

  std::mt19937_64 rng(seed);
  reserve_prefault(R->decIM, M.nF());
  R->decIM.assign(M.nF(), {});
  i64 m = nF;  // live real-face counter
  bool clean = false;

  // Pre-reserve the flat-log arenas: growth reallocation of the
  // multi-hundred-MB arrays goes through mmap'd copies whose page
  // faults dominated the record phase at ico9 scale (23 s measured).
  // est_n = nF - tarF is a ~2x upper bound on the collapse count
  // (closed-surface collapses kill 2 real faces each); reserve commits
  // only virtual address space — pages fault in once, as appended.
  {
    // est_n is deliberately ~the collapse count, not its 2x upper bound:
    // overshoot is prefaulted (paid) memory on this VM, and vectors that
    // outgrow it just demand-fault their tail.  Boundary collapses kill
    // only ~1 real face each (+1 virtual), so scale by the measured
    // virtual-face fraction: mean real faces/collapse ~ 2*nF/(nF+nVirt).
    const i64 nVirt = (i64)M.nF() - nF;
    const i64 est_n = std::max<i64>(
        16, (nF - tarF) * 5 * (nF + nVirt) / (8 * std::max<i64>(1, nF)));
    reserve_prefault(R->log.b, 2 * est_n);
    reserve_prefault(R->log.voff, est_n + 1);
    reserve_prefault(R->log.subset, 15 * est_n);
    reserve_prefault(R->log.uv_pre, 30 * est_n);
    reserve_prefault(R->log.uv_post, 30 * est_n);
    reserve_prefault(R->log.foff_pre, est_n + 1);
    reserve_prefault(R->log.fuv_pre, 43 * est_n);
    reserve_prefault(R->log.fidx_pre, 15 * est_n);
    reserve_prefault(R->log.foff_post, est_n + 1);
    reserve_prefault(R->log.fuv_post, 37 * est_n);
    reserve_prefault(R->log.fidx_post, 13 * est_n);
  }

  while (true) {
    // pop a valid heap entry (lazy invalidation; random variant pops among
    // the top 1+rand()%100, reference src/SSP_random_collapse_edge.cpp:408-431)
    i64 e = -1;
    bool have = false;
    g_prof.start();
    while (!Q.empty()) {
      HeapEntry top;
      if (!use_random) {
        top = Q.top();
        Q.pop();
      } else {
        i64 nth = 1 + (i64)(rng() % 100);
        if (nth > (i64)Q.size() - 1) nth = (i64)Q.size() - 1;
        std::vector<HeapEntry> holder;
        holder.reserve(nth);
        for (i64 k = 0; k < nth; ++k) {
          holder.push_back(Q.top());
          Q.pop();
        }
        top = Q.top();
        Q.pop();
        for (const auto& h : holder) Q.push(h);
      }
      if (top.cost == kInf) {
        // min-cost edge is infinite: push back and stop
        Q.push(top);
        break;
      }
      e = top.e;
      if (top.ts == EQ[e]) {
        have = true;
        break;
      }
    }
    g_prof.stop(1);
    if (!have) break;

    static thread_local std::vector<i64> sfaces, dfaces;
    i64 killed_edges[2], killed_faces[2];
    if (try_collapse(M, e, &C[3 * e], R->log, R->decIM, sfaces, dfaces,
                     killed_edges, killed_faces, verbose)) {
      // qslim/vertexRemoval quadric merge into the surviving (smaller) id
      // (reference callbacks post_collapse); endpoints recovered from the
      // record since E[e] is dead after surgery.
      g_prof.start();
      if (dec_type != kMidpoint) {
        const FlatLogStore& lg = R->log;
        const i64 v0 = lg.voff[lg.n - 1];
        const i64 vi = lg.subset[v0 + lg.b[2 * (lg.n - 1)]];
        const i64 vj = lg.subset[v0 + lg.b[2 * (lg.n - 1) + 1]];
        Quadric qsum = quadrics[vi];
        qsum.add(quadrics[vj]);
        quadrics[vi] = qsum;
      }
      // stopping counter: only real killed faces count
      // (igl::max_faces_stopping_condition semantics)
      for (int k = 0; k < 2; ++k)
        if (killed_faces[k] < R->orig_nF) m -= 1;
      // invalidate the two dead side edges
      EQ[killed_edges[0]] = -1;
      EQ[killed_edges[1]] = -1;
      // refresh neighborhood costs (reference src/SSP_collapse_edge.cpp:482-520)
      static thread_local std::vector<i64> Nf, Ne;
      Nf.clear();
      Nf.reserve(sfaces.size() + dfaces.size());
      Nf.insert(Nf.end(), sfaces.begin(), sfaces.end());
      Nf.insert(Nf.end(), dfaces.begin(), dfaces.end());
      std::sort(Nf.begin(), Nf.end());
      Nf.erase(std::unique(Nf.begin(), Nf.end()), Nf.end());
      Ne.clear();
      for (const i64 f : Nf) {
        if (!M.face_alive(f)) continue;
        for (int c = 0; c < 3; ++c) Ne.push_back(M.EMAP[3 * f + c]);
      }
      std::sort(Ne.begin(), Ne.end());
      Ne.erase(std::unique(Ne.begin(), Ne.end()), Ne.end());
      for (const i64 ei : Ne) {
        double cost;
        cost_and_placement(M, quadrics, dec_type, ei, cost, &C[3 * ei]);
        EQ[ei] += 1;
        Q.emplace(cost, ei, EQ[ei]);
      }
      g_prof.stop(8);
      if (m <= tarF) {
        clean = true;
        break;
      }
    } else {
      EQ[e] += 1;
      Q.emplace(kInf, e, EQ[e]);
    }
  }

  // compact faces: J/FIM over ALL working faces, then drop virtual faces
  // (they sit at the end; reference src/SSP_midpoint.cpp:221-241,65-70)
  g_prof.start();
  const i64 mW = M.nF();
  R->nF_working = mW;
  R->FIM.assign(mW, 0);
  std::vector<i64> J;
  std::vector<i64> F2;
  for (i64 f = 0; f < mW; ++f) {
    if (!M.face_alive(f)) continue;
    R->FIM[f] = (i64)J.size();
    J.push_back(f);
    for (int c = 0; c < 3; ++c) F2.push_back(M.F[3 * f + c]);
  }
  // keep only real faces
  std::vector<i64> Fk;
  std::vector<i64> Jk;
  for (size_t k = 0; k < J.size(); ++k) {
    if (J[k] >= R->orig_nF) continue;
    Jk.push_back(J[k]);
    for (int c = 0; c < 3; ++c) Fk.push_back(F2[3 * k + c]);
  }
  // remove unreferenced vertices (ascending order = igl::remove_unreferenced)
  std::vector<i64> used(Fk);
  std::sort(used.begin(), used.end());
  used.erase(std::unique(used.begin(), used.end()), used.end());
  std::vector<i64> old2new(M.nV, -1);
  for (size_t k = 0; k < used.size(); ++k) old2new[used[k]] = (i64)k;
  R->IM = used;
  R->IMF = Jk;
  R->Fc.resize(Fk.size());
  for (size_t k = 0; k < Fk.size(); ++k) R->Fc[k] = old2new[Fk[k]];
  R->Vc.resize(3 * used.size());
  for (size_t k = 0; k < used.size(); ++k)
    for (int c = 0; c < 3; ++c) R->Vc[3 * k + c] = M.V[3 * used[k] + c];
  g_prof.stop(9);
  g_prof.report();
  R->clean_finish = clean;
  R->ok = true;
  if (verbose)
    std::printf("decimated to |V| %zu, |F| %zu (%s)\n", used.size(),
                Fk.size() / 3, clean ? "clean" : "early stop");
  return R;
}

// ---------------------------------------------------------------------------
// query walks (stateless over flat log arrays)
// ---------------------------------------------------------------------------
struct FlatLog {
  i64 n;  // #collapses
  const i64* b;                   // 2n
  const i64* voff;                // n+1
  const i64* subset;              // voff[n]
  const double *uv_pre, *uv_post; // voff[n] * 2
  const i64* foff_pre;            // n+1
  const i64 *fuv_pre, *fidx_pre;
  const i64* foff_post;
  const i64 *fuv_post, *fidx_post;
  const i64* dim_off;             // nF_working+1
  const i64* dim_dat;
};

// One walk step: relocate (bc, bf) from the "source" side of collapse d to
// its "target" side (fine->coarse: pre->post; coarse->fine: post->pre),
// with the reference's max-min-barycentric snap + clamp + renormalize
// (src/query_fine_to_coarse.cpp:90-123).
static void walk_step(const FlatLog& L, i64 d, bool fwd, double* bc, i64* bf,
                      i64* fidx) {
  const i64 v0g = L.voff[d], nVp = L.voff[d + 1] - v0g;
  const i64* subset = L.subset + v0g;
  const double* uv_src = (fwd ? L.uv_pre : L.uv_post) + 2 * v0g;
  const double* uv_dst = (fwd ? L.uv_post : L.uv_pre) + 2 * v0g;
  const i64 f0 = fwd ? L.foff_post[d] : L.foff_pre[d];
  const i64 nfd = (fwd ? L.foff_post[d + 1] : L.foff_pre[d + 1]) - f0;
  const i64* fuv_dst = (fwd ? L.fuv_post : L.fuv_pre) + 3 * f0;
  const i64* fidx_dst = (fwd ? L.fidx_post : L.fidx_pre) + f0;

  // local ids of the query face corners (subset sorted -> binary search)
  double q[2] = {0, 0};
  for (int c = 0; c < 3; ++c) {
    const i64* lo = std::lower_bound(subset, subset + nVp, bf[c]);
    const i64 lid = (i64)(lo - subset);
    q[0] += bc[c] * uv_src[2 * lid];
    q[1] += bc[c] * uv_src[2 * lid + 1];
  }
  // barycentric w.r.t. every target face; snap to max-min row
  double bestmind = 1.0;  // reference starts minD at 1.0
  i64 best = -1;
  double bestB[3] = {0, 0, 0};
  for (i64 k = 0; k < nfd; ++k) {
    const double* a = &uv_dst[2 * fuv_dst[3 * k]];
    const double* b2 = &uv_dst[2 * fuv_dst[3 * k + 1]];
    const double* c2 = &uv_dst[2 * fuv_dst[3 * k + 2]];
    const double v0x = b2[0] - a[0], v0y = b2[1] - a[1];
    const double v1x = c2[0] - a[0], v1y = c2[1] - a[1];
    const double v2x = q[0] - a[0], v2y = q[1] - a[1];
    const double d00 = v0x * v0x + v0y * v0y;
    const double d01 = v0x * v1x + v0y * v1y;
    const double d11 = v1x * v1x + v1y * v1y;
    const double d20 = v2x * v0x + v2y * v0y;
    const double d21 = v2x * v1x + v2y * v1y;
    const double denom = d00 * d11 - d01 * d01;
    const double v = (d11 * d20 - d01 * d21) / denom;
    const double w = (d00 * d21 - d01 * d20) / denom;
    const double u = 1.0 - v - w;
    const double mind = -std::min(u, std::min(v, w));
    if (mind < bestmind) {
      bestmind = mind;
      best = k;
      bestB[0] = u;
      bestB[1] = v;
      bestB[2] = w;
    }
  }
  if (best < 0) return;  // should not happen (reference would read garbage)
  double s = 0;
  for (int c = 0; c < 3; ++c) {
    bestB[c] = std::max(0.0, bestB[c]);
    s += bestB[c];
  }
  for (int c = 0; c < 3; ++c) bc[c] = bestB[c] / s;
  for (int c = 0; c < 3; ++c) bf[c] = subset[fuv_dst[3 * best + c]];
  *fidx = fidx_dst[best];
}

static void query_walk(const FlatLog& L, bool fwd, i64 nq, double* BC, i64* BF,
                       i64* FIdx) {
#pragma omp parallel for schedule(dynamic, 256)
  for (i64 qi = 0; qi < nq; ++qi) {
    i64 dIdx = fwd ? -1 : L.n;
    while (true) {
      const i64 f = FIdx[qi];
      const i64 lo = L.dim_off[f], hi = L.dim_off[f + 1];
      i64 next = -1;
      if (fwd) {
        // smallest entry > dIdx (list ascending)
        for (i64 k = lo; k < hi; ++k)
          if (L.dim_dat[k] > dIdx) {
            next = L.dim_dat[k];
            break;
          }
      } else {
        // largest entry < dIdx
        for (i64 k = hi - 1; k >= lo; --k)
          if (L.dim_dat[k] < dIdx) {
            next = L.dim_dat[k];
            break;
          }
      }
      if (next < 0) break;
      dIdx = next;
      walk_step(L, dIdx, fwd, &BC[3 * qi], &BF[3 * qi], &FIdx[qi]);
    }
  }
}

}  // namespace ssp

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------
extern "C" {

using ssp::i64;

// Thread-safety: calls from DIFFERENT Python threads are safe (profiler
// and scratch are thread_local); nesting/re-entering ssp_decimate on the
// SAME thread (e.g. from a signal handler) is not supported - the
// thread_local scratch vectors are per-thread, not per-call.
void* ssp_decimate(const double* V, i64 nV, const i64* F, i64 nF, i64 tarF,
                   int dec_type, int use_random, uint64_t seed, int verbose) {
  return (void*)ssp::run_decimate(V, nV, F, nF, tarF, dec_type, use_random,
                                  seed, verbose);
}

// sizes[0..9] = ok, clean, nV_c, nF_c, n_collapses, totalV, totalF_pre,
//               totalF_post, nF_working, total_decIM
void ssp_result_sizes(void* h, i64* sizes) {
  auto* R = (ssp::Result*)h;
  i64 tdim = 0;
  for (const auto& l : R->decIM) tdim += (i64)l.size();
  sizes[0] = R->ok;
  sizes[1] = R->clean_finish;
  sizes[2] = (i64)R->IM.size();
  sizes[3] = (i64)R->IMF.size();
  sizes[4] = R->log.n;
  sizes[5] = (i64)R->log.subset.size();
  sizes[6] = (i64)R->log.fidx_pre.size();
  sizes[7] = (i64)R->log.fidx_post.size();
  sizes[8] = R->nF_working;
  sizes[9] = tdim;
}

void ssp_result_fill(void* h, double* Vc, i64* Fc, i64* IM, i64* IMF, i64* FIM,
                     i64* b, i64* voff, i64* subset, double* uv_pre,
                     double* uv_post, i64* foff_pre, i64* fuv_pre,
                     i64* fidx_pre, i64* foff_post, i64* fuv_post,
                     i64* fidx_post, i64* dim_off, i64* dim_dat) {
  auto* R = (ssp::Result*)h;
  std::memcpy(Vc, R->Vc.data(), R->Vc.size() * sizeof(double));
  std::memcpy(Fc, R->Fc.data(), R->Fc.size() * sizeof(i64));
  std::memcpy(IM, R->IM.data(), R->IM.size() * sizeof(i64));
  std::memcpy(IMF, R->IMF.data(), R->IMF.size() * sizeof(i64));
  std::memcpy(FIM, R->FIM.data(), R->FIM.size() * sizeof(i64));
  // the flat arena already holds the exact output layout
  const ssp::FlatLogStore& L = R->log;
  std::memcpy(b, L.b.data(), L.b.size() * sizeof(i64));
  std::memcpy(voff, L.voff.data(), L.voff.size() * sizeof(i64));
  std::memcpy(subset, L.subset.data(), L.subset.size() * sizeof(i64));
  std::memcpy(uv_pre, L.uv_pre.data(), L.uv_pre.size() * sizeof(double));
  std::memcpy(uv_post, L.uv_post.data(), L.uv_post.size() * sizeof(double));
  std::memcpy(foff_pre, L.foff_pre.data(), L.foff_pre.size() * sizeof(i64));
  std::memcpy(fuv_pre, L.fuv_pre.data(), L.fuv_pre.size() * sizeof(i64));
  std::memcpy(fidx_pre, L.fidx_pre.data(), L.fidx_pre.size() * sizeof(i64));
  std::memcpy(foff_post, L.foff_post.data(),
              L.foff_post.size() * sizeof(i64));
  std::memcpy(fuv_post, L.fuv_post.data(), L.fuv_post.size() * sizeof(i64));
  std::memcpy(fidx_post, L.fidx_post.data(),
              L.fidx_post.size() * sizeof(i64));
  i64 t = 0;
  for (i64 f = 0; f < R->nF_working; ++f) {
    dim_off[f] = t;
    for (const i64 d : R->decIM[f]) dim_dat[t++] = d;
  }
  dim_off[R->nF_working] = t;
}

void ssp_result_free(void* h) { delete (ssp::Result*)h; }

// Greedy graph coloring of a CSR sparsity pattern (rows sharing an
// off-diagonal structural nonzero never share a color) — host precompute
// for the multi-color Gauss-Seidel smoother.  Returns the color count.
i64 ssp_greedy_coloring(i64 n, const i64* indptr, const i64* indices,
                        int32_t* color) {
  std::vector<int32_t> mark;  // mark[c] == i means color c is used by a
                              // neighbor of the current row
  mark.reserve(64);
  i64 ncolors = 0;
  for (i64 i = 0; i < n; ++i) color[i] = -1;
  for (i64 i = 0; i < n; ++i) {
    for (i64 k = indptr[i]; k < indptr[i + 1]; ++k) {
      const i64 j = indices[k];
      if (j == i || color[j] < 0) continue;
      const i64 c = color[j];
      if (c >= (i64)mark.size()) mark.resize(c + 1, -1);
      mark[c] = (int32_t)(i & 0x7fffffff);
    }
    i64 c = 0;
    const int32_t tag = (int32_t)(i & 0x7fffffff);
    while (c < (i64)mark.size() && mark[c] == tag) ++c;
    color[i] = (int32_t)c;
    if (c + 1 > ncolors) ncolors = c + 1;
  }
  return ncolors;
}

// In-place query walk.  fwd=1: fine->coarse, fwd=0: coarse->fine.
// BC: nq x 3 doubles, BF: nq x 3 int64 (working-mesh vertex ids),
// FIdx: nq int64 (working-mesh face ids).  Index remapping to/from the
// coarse mesh (reference src/query_fine_to_coarse.cpp:132-151 and
// src/query_coarse_to_fine.cpp:22-36) is done by the Python wrapper.
void ssp_query(i64 n, const i64* b, const i64* voff, const i64* subset,
               const double* uv_pre, const double* uv_post,
               const i64* foff_pre, const i64* fuv_pre, const i64* fidx_pre,
               const i64* foff_post, const i64* fuv_post, const i64* fidx_post,
               const i64* dim_off, const i64* dim_dat, int fwd, i64 nq,
               double* BC, i64* BF, i64* FIdx) {
  ssp::FlatLog L{n,        b,        voff,     subset,    uv_pre,
                 uv_post,  foff_pre, fuv_pre,  fidx_pre,  foff_post,
                 fuv_post, fidx_post, dim_off, dim_dat};
  ssp::query_walk(L, fwd != 0, nq, BC, BF, FIdx);
}

}  // extern "C"

// Triangle-mesh connectivity for the SSP decimation engine.
//
// Fresh implementation of the structures the reference builds with libigl:
// unique-edge flaps (igl::edge_flaps semantics: E/EMAP/EF/EI), manifoldness
// checks, boundary closure via a virtual vertex "at infinity"
// (igl::connect_boundary_to_infinity semantics, used by
// reference src/SSP_midpoint.cpp:31), vertex circulation, and the edge
// collapse surgery (reference src/SSP_collapse_edge.cpp:266-378 behavior,
// re-derived; we use -1 sentinels for killed entities instead of the
// reference's IGL_COLLAPSE_EDGE_NULL==0 hack).
#pragma once

#include <algorithm>
#include <cassert>
#ifdef __linux__
#include <sys/mman.h>
#include <unistd.h>
#endif
#include <cmath>
#include <cstdint>
#include <functional>
#include <limits>
#include <unordered_map>
#include <vector>

namespace ssp {

using i64 = int64_t;
constexpr i64 kDead = -1;

// Bulk-populate the pages behind a reserved buffer.  On this class of
// (nested-)VM a demand page fault costs ~40 us — streaming writes into
// cold buffers measured 0.1 GB/s vs 6.6 GB/s on warm pages — while
// MADV_POPULATE_WRITE populates the same pages ~4x faster in one kernel
// call (round-4 membench).  No-op (harmless EINVAL) where unsupported.
inline void prefault_write(void* p, size_t len) {
#ifdef __linux__
  if (!p || !len) return;
  const size_t page = (size_t)sysconf(_SC_PAGESIZE);
  uintptr_t lo = (uintptr_t)p & ~(page - 1);
  uintptr_t hi = ((uintptr_t)p + len + page - 1) & ~(page - 1);
#ifdef MADV_POPULATE_WRITE
  madvise((void*)lo, hi - lo, MADV_POPULATE_WRITE);
#else
  madvise((void*)lo, hi - lo, 23);  // MADV_POPULATE_WRITE value
#endif
#endif
}

template <typename T>
inline void reserve_prefault(std::vector<T>& v, size_t n) {
  v.reserve(n);
  prefault_write(v.data(), n * sizeof(T));
}

struct EdgeKey {
  i64 a, b;  // sorted: a < b
  bool operator==(const EdgeKey& o) const { return a == o.a && b == o.b; }
};
struct EdgeKeyHash {
  size_t operator()(const EdgeKey& k) const {
    return std::hash<i64>()(k.a * 1000003 + k.b);
  }
};

// Flap (unique-edge) connectivity of an oriented triangle mesh.
//
//   E[e]    = {u, v} endpoints (unordered pair; NOT kept sorted after
//             collapses, matching reference behavior where endpoint d is
//             renamed to s in place, src/SSP_collapse_edge.cpp:325-326)
//   EMAP[f][c] = edge opposite corner c of face f
//   EF[e][side], EI[e][side]: the face on each side of e and the corner of
//             that face opposite e.  side 0 is the face in which the edge
//             appears directed as (E[e][0], E[e][1]) in CCW face order.
struct FlapMesh {
  i64 nV = 0;                 // vertex count (incl. virtual vertex if closed)
  std::vector<double> V;      // nV x 3
  std::vector<i64> F;         // nF x 3 (killed face: all -1)
  std::vector<i64> E;         // nE x 2 (killed edge: all -1)
  std::vector<i64> EMAP;      // nF x 3
  std::vector<i64> EF, EI;    // nE x 2
  i64 virtual_vertex = -1;    // index of infinity vertex, or -1 (closed input)

  i64 nF() const { return (i64)F.size() / 3; }
  i64 nE() const { return (i64)E.size() / 2; }
  bool face_alive(i64 f) const { return F[3 * f] != kDead; }
  bool edge_alive(i64 e) const { return E[2 * e] != kDead; }
  bool face_has_vertex(i64 f, i64 v) const {
    return F[3 * f] == v || F[3 * f + 1] == v || F[3 * f + 2] == v;
  }
  bool face_is_virtual(i64 f) const {
    return virtual_vertex >= 0 && face_has_vertex(f, virtual_vertex);
  }
  int corner_of(i64 f, i64 v) const {
    for (int c = 0; c < 3; ++c)
      if (F[3 * f + c] == v) return c;
    return -1;
  }
};

// Build E/EMAP/EF/EI (igl::edge_flaps semantics).  Returns false when the
// mesh is not edge-manifold-and-consistently-oriented (an undirected edge
// with >1 face on the same side, or >2 faces total).
inline bool build_flaps(FlapMesh& M) {
  // Sort-based edge pairing (the former per-halfedge unordered_map was
  // ~8 s of the ico9 build): group the 3m halfedges by undirected key,
  // then assign edge ids in FIRST-ENCOUNTER (f, c) order — exactly the
  // order the hash-map version produced — by sorting groups on their
  // minimum halfedge sequence number.
  const i64 m = M.nF();
  struct HE {
    i64 ka, kb, seq;  // sorted key pair; seq = 3*f + c
  };
  std::vector<HE> hes;
  reserve_prefault(hes, 3 * m);
  for (i64 f = 0; f < m; ++f) {
    for (int c = 0; c < 3; ++c) {
      const i64 a = M.F[3 * f + (c + 1) % 3];
      const i64 b = M.F[3 * f + (c + 2) % 3];
      if (a == b) return false;  // degenerate face
      hes.push_back({std::min(a, b), std::max(a, b), 3 * f + c});
    }
  }
  std::sort(hes.begin(), hes.end(), [](const HE& x, const HE& y) {
    if (x.ka != y.ka) return x.ka < y.ka;
    if (x.kb != y.kb) return x.kb < y.kb;
    return x.seq < y.seq;
  });
  // group boundaries; reject >2 halfedges per undirected edge
  std::vector<std::pair<i64, i64>> order;  // (min_seq, group start)
  reserve_prefault(order, 3 * m / 2 + 1);
  {
    size_t i = 0;
    while (i < hes.size()) {
      size_t j = i + 1;
      while (j < hes.size() && hes[j].ka == hes[i].ka &&
             hes[j].kb == hes[i].kb)
        ++j;
      if (j - i > 2) return false;  // non-manifold edge
      order.emplace_back(hes[i].seq, (i64)i);  // seqs ascend within group
      i = j;
    }
  }
  std::sort(order.begin(), order.end());
  const i64 nE = (i64)order.size();
  M.E.clear();
  reserve_prefault(M.E, 2 * nE);
  reserve_prefault(M.EMAP, 3 * m);
  reserve_prefault(M.EF, 2 * nE);
  reserve_prefault(M.EI, 2 * nE);
  M.E.assign(2 * nE, kDead);
  M.EMAP.assign(3 * m, kDead);
  M.EF.assign(2 * nE, kDead);
  M.EI.assign(2 * nE, kDead);
  for (i64 e = 0; e < nE; ++e) {
    const i64 g0 = order[e].second;
    // endpoints in the direction of first appearance
    const i64 seq0 = hes[g0].seq;
    const i64 f0 = seq0 / 3;
    const int c0 = (int)(seq0 % 3);
    const i64 a0 = M.F[3 * f0 + (c0 + 1) % 3];
    const i64 b0 = M.F[3 * f0 + (c0 + 2) % 3];
    M.E[2 * e] = a0;
    M.E[2 * e + 1] = b0;
    for (i64 k = g0; k < (i64)hes.size() && hes[k].ka == hes[g0].ka &&
                     hes[k].kb == hes[g0].kb;
         ++k) {
      const i64 f = hes[k].seq / 3;
      const int c = (int)(hes[k].seq % 3);
      const i64 a = M.F[3 * f + (c + 1) % 3];
      const i64 b = M.F[3 * f + (c + 2) % 3];
      const int side = (a0 == a && b0 == b) ? 0 : 1;
      if (M.EF[2 * e + side] != kDead) return false;  // bad orientation
      M.EF[2 * e + side] = f;
      M.EI[2 * e + side] = c;
      M.EMAP[3 * f + c] = e;
    }
  }
  return true;
}

// Edge-manifold: established by build_flaps succeeding.  Closed after the
// infinity closure additionally requires both sides present.
inline bool all_edges_closed(const FlapMesh& M) {
  for (i64 e = 0; e < M.nE(); ++e)
    if (M.EF[2 * e] == kDead || M.EF[2 * e + 1] == kDead) return false;
  return true;
}

// Vertex-manifold check (reference gate: src/SSP_decimate.cpp:20-23 uses
// igl::is_vertex_manifold ON THE ORIGINAL, pre-closure mesh): faces incident
// to every vertex form one fan.  Union-find over face-corners joined across
// shared vertex-incident edges.  The virtual infinity vertex is skipped: with
// >=2 boundary loops its fan is legitimately disconnected (one sub-fan per
// loop), and the reference never checks it — rejecting it here would wrongly
// reject manifold inputs like an annulus or open cylinder.
inline bool is_vertex_manifold(const FlapMesh& M) {
  const i64 m = M.nF();
  // collect (vertex -> incident corners) via sorting
  std::vector<std::pair<i64, i64>> vc;  // (vertex, face)
  vc.reserve(3 * m);
  for (i64 f = 0; f < m; ++f)
    for (int c = 0; c < 3; ++c) vc.emplace_back(M.F[3 * f + c], f);
  std::sort(vc.begin(), vc.end());
  std::vector<i64> parent(m);
  std::vector<i64> comp_of_face(m);
  // For each vertex group: union faces sharing an edge through the vertex.
  size_t i = 0;
  while (i < vc.size()) {
    size_t j = i;
    const i64 v = vc[i].first;
    while (j < vc.size() && vc[j].first == v) ++j;
    if (v == M.virtual_vertex) {
      i = j;
      continue;
    }
    const size_t cnt = j - i;
    // union-find local to this vertex group.  Fans are tiny (~6 faces),
    // so a linear scan beats a per-vertex hash map, and a plain lambda
    // beats the former std::function (visible in the round-4 gprof).
    static thread_local std::vector<i64> par;
    par.assign(cnt, 0);
    for (size_t k = 0; k < cnt; ++k) par[k] = (i64)k;
    auto find = [&](i64 x) {
      while (par[x] != x) {
        par[x] = par[par[x]];
        x = par[x];
      }
      return x;
    };
    auto local_of = [&](i64 face) {
      for (size_t k = 0; k < cnt; ++k)
        if (vc[i + k].second == face) return (i64)k;
      return (i64)-1;
    };
    for (size_t k = 0; k < cnt; ++k) {
      const i64 f = vc[i + k].second;
      const int c = M.corner_of(f, v);
      // the two edges of f incident to v are opposite the other corners
      for (int o = 1; o <= 2; ++o) {
        const i64 e = M.EMAP[3 * f + (c + o) % 3];
        const i64 g = (M.EF[2 * e] == f) ? M.EF[2 * e + 1] : M.EF[2 * e];
        if (g == kDead) continue;
        const i64 lg = local_of(g);
        if (lg < 0) return false;  // neighbor across v-edge lacks v?!
        const i64 ra = find((i64)k), rb = find(lg);
        if (ra != rb) par[ra] = rb;
      }
    }
    const i64 root = find(0);
    for (size_t k = 1; k < cnt; ++k)
      if (find((i64)k) != root) return false;
    i = j;
  }
  return true;
}

// Close all boundary loops with a fan to a single virtual vertex whose
// coordinates are +inf (igl::connect_boundary_to_infinity semantics,
// reference src/SSP_midpoint.cpp:31).  Virtual faces are appended AFTER all
// real faces — the face-ordering invariant the reference relies on when
// compacting J/FIM (src/SSP_midpoint.cpp:65-70).
// Call before build_flaps.  Returns the number of virtual faces added.
inline i64 connect_boundary_to_infinity(FlapMesh& M) {
  const i64 m = M.nF();
  // count directed edges; boundary = directed edge whose reverse is absent
  std::unordered_map<EdgeKey, int, EdgeKeyHash> cnt;
  cnt.reserve(3 * m);
  std::vector<std::pair<i64, i64>> directed;
  directed.reserve(3 * m);
  for (i64 f = 0; f < m; ++f) {
    for (int c = 0; c < 3; ++c) {
      const i64 a = M.F[3 * f + (c + 1) % 3];
      const i64 b = M.F[3 * f + (c + 2) % 3];
      cnt[EdgeKey{std::min(a, b), std::max(a, b)}] += 1;
      directed.emplace_back(a, b);
    }
  }
  std::vector<std::pair<i64, i64>> boundary;
  for (const auto& d : directed) {
    const EdgeKey k{std::min(d.first, d.second), std::max(d.first, d.second)};
    if (cnt[k] == 1) boundary.push_back(d);
  }
  if (boundary.empty()) {
    M.virtual_vertex = -1;
    return 0;
  }
  const i64 inf = M.nV;
  M.nV += 1;
  const double INF = std::numeric_limits<double>::infinity();
  M.V.push_back(INF);
  M.V.push_back(INF);
  M.V.push_back(INF);
  // phony face (b, a, inf): reversed boundary edge keeps the closed mesh
  // consistently oriented.
  for (const auto& d : boundary) {
    M.F.push_back(d.second);
    M.F.push_back(d.first);
    M.F.push_back(inf);
  }
  M.virtual_vertex = inf;
  return (i64)boundary.size();
}

// Faces and ring vertices around endpoint v of edge e (circulation).
// Requires a closed mesh (both flap sides present).  Ring vertices are the
// neighbor vertices of v in walk order; faces in walk order.
inline void circulate(const FlapMesh& M, i64 e, i64 v, std::vector<i64>& faces,
                      std::vector<i64>& ring) {
  faces.clear();
  ring.clear();
  const i64 f0 = M.EF[2 * e];
  i64 f = f0;
  i64 prev_e = e;
  do {
    faces.push_back(f);
    const int c = M.corner_of(f, v);
    assert(c >= 0);
    // two edges of f incident to v: opposite the other two corners
    const i64 ea = M.EMAP[3 * f + (c + 1) % 3];
    const i64 eb = M.EMAP[3 * f + (c + 2) % 3];
    const i64 nxt = (ea == prev_e) ? eb : ea;
    // ring vertex: the endpoint of nxt that is not v
    ring.push_back(M.E[2 * nxt] == v ? M.E[2 * nxt + 1] : M.E[2 * nxt]);
    f = (M.EF[2 * nxt] == f) ? M.EF[2 * nxt + 1] : M.EF[2 * nxt];
    prev_e = nxt;
  } while (f != f0);
}

// Link condition (igl::edge_collapse_is_valid semantics,
// reference src/SSP_collapse_edge.cpp:55-60): the vertex rings of the two
// endpoints must intersect in exactly two vertices (the two flap corners).
// Rings include the virtual vertex, which automatically rejects collapsing
// an interior edge whose endpoints both lie on the mesh boundary.
inline bool link_condition(const std::vector<i64>& rs_in,
                           const std::vector<i64>& rd_in) {
  if (rs_in.size() < 2 || rd_in.size() < 2) return false;
  static thread_local std::vector<i64> rs, rd;  // sort scratch (hot loop)
  rs.assign(rs_in.begin(), rs_in.end());
  rd.assign(rd_in.begin(), rd_in.end());
  std::sort(rs.begin(), rs.end());
  std::sort(rd.begin(), rd.end());
  size_t i = 0, j = 0, common = 0;
  while (i < rs.size() && j < rd.size()) {
    if (rs[i] == rd[j]) {
      ++common;
      ++i;
      ++j;
    } else if (rs[i] < rd[j]) {
      ++i;
    } else {
      ++j;
    }
  }
  return common == 2;
}

// Topological edge collapse: merge d into s (s < d required), placing the
// merged vertex at p.  dfaces = pre-collapse faces incident to d (from
// circulate).  Outputs the two killed side edges (for heap timestamp
// invalidation, reference src/SSP_collapse_edge.cpp:473-474).
// Behavior matches the reference surgery (src/SSP_collapse_edge.cpp:266-378)
// re-derived on our structure.
inline void collapse_edge_topology(FlapMesh& M, i64 e, i64 s, i64 d,
                                   const double p[3],
                                   const std::vector<i64>& dfaces,
                                   i64 killed_edges[2], i64 killed_faces[2]) {
  assert(s < d);
  for (int side = 0; side < 2; ++side) {
    const i64 f = M.EF[2 * e + side];
    const int cs = M.corner_of(f, s);
    const int cd = M.corner_of(f, d);
    assert(cs >= 0 && cd >= 0);
    const i64 e_dv = M.EMAP[3 * f + cs];  // edge (d, third) — will die
    const i64 e_sv = M.EMAP[3 * f + cd];  // edge (s, third) — survives
    // neighbor across e_dv
    const int gside = (M.EF[2 * e_dv] == f) ? 1 : 0;
    const i64 g = M.EF[2 * e_dv + gside];
    const i64 gc = M.EI[2 * e_dv + gside];
    // attach g to e_sv where f used to be
    const int slot = (M.EF[2 * e_sv] == f) ? 0 : 1;
    M.EF[2 * e_sv + slot] = g;
    M.EI[2 * e_sv + slot] = gc;
    M.EMAP[3 * g + gc] = e_sv;
    // kill e_dv and f
    M.E[2 * e_dv] = M.E[2 * e_dv + 1] = kDead;
    M.EF[2 * e_dv] = M.EF[2 * e_dv + 1] = kDead;
    M.EI[2 * e_dv] = M.EI[2 * e_dv + 1] = kDead;
    M.F[3 * f] = M.F[3 * f + 1] = M.F[3 * f + 2] = kDead;
    killed_edges[side] = e_dv;
    killed_faces[side] = f;
  }
  // rename d -> s in surviving incident faces and their edges
  for (const i64 f : dfaces) {
    if (!M.face_alive(f)) continue;
    const int c = M.corner_of(f, d);
    if (c < 0) continue;  // already renamed via another path (shouldn't happen)
    M.F[3 * f + c] = s;
    for (int o = 0; o < 3; ++o) {
      const i64 ee = M.EMAP[3 * f + o];
      if (M.E[2 * ee] == d) M.E[2 * ee] = s;
      if (M.E[2 * ee + 1] == d) M.E[2 * ee + 1] = s;
    }
  }
  for (int k = 0; k < 3; ++k) {
    M.V[3 * s + k] = p[k];
    M.V[3 * d + k] = p[k];
  }
  // kill e
  M.E[2 * e] = M.E[2 * e + 1] = kDead;
  M.EF[2 * e] = M.EF[2 * e + 1] = kDead;
  M.EI[2 * e] = M.EI[2 * e + 1] = kDead;
}

}  // namespace ssp

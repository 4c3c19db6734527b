// Joint LSCM flattening of pre/post edge-collapse patches.
//
// Fresh implementation of the reference's key construction
// (src/joint_lscm.cpp): flatten the pre-collapse one-ring patch and the
// post-collapse patch *jointly* — shared UV variables on the common
// boundary — by minimizing the sum of the two LSCM energies
//   Q = (-L2_pre + 2 A_pre) + (-L2_post + 2 A_post)
// (reference src/joint_lscm.cpp:526) under pinned-UV constraints chosen by
// the boundary configuration of the collapsing edge:
//   case 0: both endpoints interior     (reference :557-651)
//   case 1: one endpoint on boundary    (reference :653-748)
//   case 2: both on boundary — try snap-to-vi / snap-to-vj / no-snap and
//           keep the min summed quasi-conformal error (reference :750-836)
// followed by validity gates (NaN / flips / fold-over / UV quality,
// reference check_valid_UV_lscm :243-481).
//
// Layout convention (reference :636-650): the stacked unknown vector is
// [block0; block1] with block0 -> UV column 1 and block1 -> UV column 0.
#pragma once

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <unordered_map>
#include <vector>

#include "dense.hpp"

namespace ssp {

using i64 = int64_t;

// Zero an existing Mat to r x c, reusing its heap storage (the flatten
// path runs ~1 solve per attempted collapse; per-call Mat construction
// was ~40% of joint_lscm time in the round-4 phase profile).
inline void mat_reset(Mat& M, i64 r, i64 c) {
  M.r = r;
  M.c = c;
  M.a.assign((size_t)(r * c), 0.0);
}

// ---------------------------------------------------------------------------
// small geometry kernels
// ---------------------------------------------------------------------------

// 1/2 * cotangent weights per face corner-opposite-edge, edges ordered
// [1,2],[2,0],[0,1] (igl::cotmatrix_entries semantics used by
// reference src/cotmatrix_dense.cpp:12).
inline void cot_entries(const std::vector<double>& V, const std::vector<i64>& F,
                        i64 nf, std::vector<double>& C) {
  C.assign(nf * 3, 0.0);
  for (i64 f = 0; f < nf; ++f) {
    const i64 v0 = F[3 * f], v1 = F[3 * f + 1], v2 = F[3 * f + 2];
    double e[3][3];  // e[k] = edge vector opposite corner k
    for (int k = 0; k < 3; ++k) {
      const i64 a = (k == 0) ? v1 : (k == 1) ? v2 : v0;
      const i64 b = (k == 0) ? v2 : (k == 1) ? v0 : v1;
      for (int j = 0; j < 3; ++j) e[k][j] = V[3 * b + j] - V[3 * a + j];
    }
    // doubled area via cross of two edges
    double cx = e[1][1] * e[2][2] - e[1][2] * e[2][1];
    double cy = e[1][2] * e[2][0] - e[1][0] * e[2][2];
    double cz = e[1][0] * e[2][1] - e[1][1] * e[2][0];
    const double dblA = std::sqrt(cx * cx + cy * cy + cz * cz);
    // cot(angle at corner k) = -dot(e_{k+1}, e_{k+2}) / dblA ; entry = cot/2
    for (int k = 0; k < 3; ++k) {
      const int i = (k + 1) % 3, j = (k + 2) % 3;
      const double dot = e[i][0] * e[j][0] + e[i][1] * e[j][1] + e[i][2] * e[j][2];
      C[3 * f + k] = -dot / (2.0 * dblA);
    }
  }
}

// Dense cotan Laplacian (negative semidefinite, diag negative;
// reference src/cotmatrix_dense.cpp:26-41).
inline void cotmatrix_dense(const std::vector<double>& V,
                            const std::vector<i64>& F, i64 nf, i64 n, Mat& L) {
  static thread_local std::vector<double> C;
  cot_entries(V, F, nf, C);
  mat_reset(L, n, n);
  for (i64 f = 0; f < nf; ++f) {
    for (int k = 0; k < 3; ++k) {
      const i64 s = F[3 * f + (k + 1) % 3];
      const i64 d = F[3 * f + (k + 2) % 3];
      const double w = C[3 * f + k];
      L(s, d) += w;
      L(d, s) += w;
      L(s, s) -= w;
      L(d, d) -= w;
    }
  }
}

// Directed boundary edges of a patch (edges whose reverse never appears),
// oriented as they appear in the faces (igl::boundary_facets semantics used
// by reference src/vector_area_matrix_size.cpp:13).
inline void boundary_edges(const std::vector<i64>& F, i64 nf,
                           std::vector<std::pair<i64, i64>>& bd) {
  // Patch-sized inputs (tens of faces): a sorted key array beats the
  // former unordered_map (hash inserts dominated, 6.9% of ico7 build in
  // the round-4 phase profile).  Output order (face-major, corner-major)
  // is unchanged.
  bd.clear();
  static thread_local std::vector<i64> keys, sorted;
  keys.clear();
  auto key = [](i64 a, i64 b) { return std::min(a, b) * 1000003 + std::max(a, b); };
  for (i64 f = 0; f < nf; ++f)
    for (int c = 0; c < 3; ++c)
      keys.push_back(key(F[3 * f + (c + 1) % 3], F[3 * f + (c + 2) % 3]));
  sorted = keys;
  std::sort(sorted.begin(), sorted.end());
  size_t idx = 0;
  for (i64 f = 0; f < nf; ++f)
    for (int c = 0; c < 3; ++c) {
      const i64 a = F[3 * f + (c + 1) % 3], b = F[3 * f + (c + 2) % 3];
      const i64 k = keys[idx++];
      auto lo = std::lower_bound(sorted.begin(), sorted.end(), k);
      if (lo + 1 == sorted.end() || *(lo + 1) != k) bd.emplace_back(a, b);
    }
}

// Dense vector-area matrix on 2n stacked coordinates
// (reference src/vector_area_matrix_size.cpp:33-45).
inline void vector_area_matrix(const std::vector<i64>& F, i64 nf, i64 n, Mat& A) {
  mat_reset(A, 2 * n, 2 * n);
  std::vector<std::pair<i64, i64>> bd;
  boundary_edges(F, nf, bd);
  for (const auto& e : bd) {
    const i64 i = e.first, j = e.second;
    A(i + n, j) -= 0.25;
    A(j, i + n) -= 0.25;
    A(i, j + n) += 0.25;
    A(j + n, i) += 0.25;
  }
}

// Ordered boundary loop of a disk patch.  The reference assembles this from
// circulation data (src/joint_lscm.cpp:119-181) and debug-verifies it equals
// igl::boundary_loop up to rotation (:183-205); we walk the directed
// boundary edges directly — rotation/direction don't matter to any caller.
inline bool boundary_loop(const std::vector<i64>& F, i64 nf,
                          std::vector<i64>& loop) {
  loop.clear();
  std::vector<std::pair<i64, i64>> bd;
  boundary_edges(F, nf, bd);
  if (bd.empty()) return false;
  std::unordered_map<i64, i64> nxt;
  nxt.reserve(bd.size() * 2);
  for (const auto& e : bd) {
    if (nxt.count(e.first)) return false;  // non-manifold boundary
    nxt[e.first] = e.second;
  }
  i64 v = bd[0].first;
  for (size_t k = 0; k < bd.size(); ++k) {
    loop.push_back(v);
    auto it = nxt.find(v);
    if (it == nxt.end()) return false;
    v = it->second;
  }
  return v == loop[0] && loop.size() == bd.size();  // single loop
}

// Per-face quasi-conformal distortion sigma/gamma
// ("Texture Mapping Progressive Meshes"; reference src/quasi_conformal_error.cpp).
// Returns the 2-norm over faces; NaN propagates (caller maps NaN to +huge).
inline double quasi_conformal_error_norm(const std::vector<double>& V,
                                         const std::vector<i64>& F, i64 nf,
                                         const std::vector<double>& UV) {
  double sumsq = 0.0;
  for (i64 f = 0; f < nf; ++f) {
    const i64 a = F[3 * f], b = F[3 * f + 1], c = F[3 * f + 2];
    const double s1 = UV[2 * a], t1 = UV[2 * a + 1];
    const double s2 = UV[2 * b], t2 = UV[2 * b + 1];
    const double s3 = UV[2 * c], t3 = UV[2 * c + 1];
    const double A2 = ((s2 - s1) * (t3 - t1) - (s3 - s1) * (t2 - t1)) / 2.0;
    double Ss[3], St[3];
    for (int k = 0; k < 3; ++k) {
      const double q1 = V[3 * a + k], q2 = V[3 * b + k], q3 = V[3 * c + k];
      Ss[k] = (q1 * (t2 - t3) + q2 * (t3 - t1) + q3 * (t1 - t2)) / (2 * A2);
      St[k] = (q1 * (s3 - s2) + q2 * (s1 - s3) + q3 * (s2 - s1)) / (2 * A2);
    }
    const double aa = Ss[0] * Ss[0] + Ss[1] * Ss[1] + Ss[2] * Ss[2];
    const double bb = Ss[0] * St[0] + Ss[1] * St[1] + Ss[2] * St[2];
    const double cc = St[0] * St[0] + St[1] * St[1] + St[2] * St[2];
    const double disc = std::sqrt((aa - cc) * (aa - cc) + 4 * bb * bb);
    const double sigma = std::sqrt((aa + cc + disc) / 2);
    const double gamma = std::sqrt((aa + cc - disc) / 2);
    const double err = sigma / gamma;
    sumsq += err * err;
  }
  return std::sqrt(sumsq);
}

// ---------------------------------------------------------------------------
// constrained quadratic solve (reference src/mqwf_dense.cpp semantics with
// RHS = 0): minimize 1/2 x'Qx subject to x[known] = bc.
// ---------------------------------------------------------------------------
inline bool solve_pinned(const Mat& Q, const std::vector<i64>& known,
                         const std::vector<double>& bc, std::vector<double>& x) {
  const i64 n = Q.r;
  static thread_local std::vector<char> is_known;
  static thread_local std::vector<i64> unk;
  static thread_local Mat Auu;
  static thread_local std::vector<double> rhs;
  is_known.assign(n, 0);
  x.assign(n, 0.0);
  for (size_t k = 0; k < known.size(); ++k) {
    is_known[known[k]] = 1;
    x[known[k]] = bc[k];
  }
  unk.clear();
  unk.reserve(n);
  for (i64 i = 0; i < n; ++i)
    if (!is_known[i]) unk.push_back(i);
  const i64 nu = (i64)unk.size();
  mat_reset(Auu, nu, nu);
  rhs.assign(nu, 0.0);
  for (i64 i = 0; i < nu; ++i) {
    const i64 gi = unk[i];
    for (i64 j = 0; j < nu; ++j) Auu(i, j) = Q(gi, unk[j]);
    double s = 0.0;
    for (size_t k = 0; k < known.size(); ++k)
      s += 0.5 * (Q(gi, known[k]) + Q(known[k], gi)) * bc[k];
    rhs[i] = -s;
  }
  if (!lu_solve(Auu, rhs)) return false;
  for (i64 i = 0; i < nu; ++i) x[unk[i]] = rhs[i];
  return true;
}

// ---------------------------------------------------------------------------
// joint flatten of one (pre, post) patch pair under pinned UVs
// (reference flatten(), src/joint_lscm.cpp:483-555)
// ---------------------------------------------------------------------------
inline bool flatten_joint(const std::vector<double>& Vjoint_pre,
                          const std::vector<i64>& Fjoint_pre, i64 nf_pre,
                          const std::vector<double>& Vjoint_post,
                          const std::vector<i64>& Fjoint_post, i64 nf_post,
                          const std::vector<i64>& b_UV,
                          const std::vector<double>& bc_UV, i64 nVjoint,
                          std::vector<double>& UVjoint /* nVjoint x 2 */) {
  // Q = block-diag(-(L_pre+L_post)) + 2*(A_pre+A_post).  The vector-area
  // matrices touch ONLY cross-block entries (every write in
  // vector_area_matrix pairs one index < n with one >= n) and the
  // Laplacian replication ONLY same-block entries, so the two parts
  // assemble independently — bit-identical to the former dense
  // 2.0*(A_pre+A_post) - (L_pre+L_post) per-entry loop (A area weights
  // are dyadic +-0.25 sums, so folding the 2x into +-0.5 accumulation is
  // exact), without materializing the (2n)^2 area matrices.
  static thread_local Mat L_pre, L_post, Q;
  static thread_local std::vector<std::pair<i64, i64>> bd;
  cotmatrix_dense(Vjoint_pre, Fjoint_pre, nf_pre, nVjoint, L_pre);
  cotmatrix_dense(Vjoint_post, Fjoint_post, nf_post, nVjoint, L_post);
  const i64 n2 = 2 * nVjoint;
  mat_reset(Q, n2, n2);
  for (i64 i = 0; i < nVjoint; ++i)
    for (i64 j = 0; j < nVjoint; ++j) {
      const double l = 0.0 - (L_pre(i, j) + L_post(i, j));
      Q(i, j) = l;
      Q(nVjoint + i, nVjoint + j) = l;
    }
  for (int which = 0; which < 2; ++which) {
    boundary_edges(which == 0 ? Fjoint_pre : Fjoint_post,
                   which == 0 ? nf_pre : nf_post, bd);
    for (const auto& e : bd) {
      const i64 i = e.first, j = e.second;
      Q(i + nVjoint, j) -= 0.5;
      Q(j, i + nVjoint) -= 0.5;
      Q(i, j + nVjoint) += 0.5;
      Q(j + nVjoint, i) += 0.5;
    }
  }
  static thread_local std::vector<double> flat;
  if (!solve_pinned(Q, b_UV, bc_UV, flat)) return false;
  // block0 -> UV col 1, block1 -> UV col 0 (reference :636-640)
  UVjoint.assign(2 * nVjoint, 0.0);
  for (i64 i = 0; i < nVjoint; ++i) {
    UVjoint[2 * i + 1] = flat[i];
    UVjoint[2 * i] = flat[nVjoint + i];
  }
  return true;
}

// ---------------------------------------------------------------------------
// validity gates (reference check_valid_UV_lscm, src/joint_lscm.cpp:243-481)
// ---------------------------------------------------------------------------
inline double tri_quality_2d(const double* a, const double* b, const double* c) {
  const double l0 = std::hypot(a[0] - b[0], a[1] - b[1]);
  const double l1 = std::hypot(b[0] - c[0], b[1] - c[1]);
  const double l2 = std::hypot(c[0] - a[0], c[1] - a[1]);
  const double x = (l0 + l1 + l2) / 2;
  const double delta = std::sqrt(x * (x - l0) * (x - l1) * (x - l2));
  return 4 * std::sqrt(3.0) * delta / (l0 * l0 + l1 * l1 + l2 * l2);
}

inline bool check_valid_uv(const std::vector<i64>& F, i64 nf,
                           const std::vector<double>& UV, i64 vi, i64 vj) {
  // NaN
  for (size_t i = 0; i < UV.size(); ++i)
    if (std::isnan(UV[i])) return false;
  // signed-area flips (threshold 1e-10, reference :284,:320)
  for (i64 f = 0; f < nf; ++f) {
    const double* a = &UV[2 * F[3 * f]];
    const double* b = &UV[2 * F[3 * f + 1]];
    const double* c = &UV[2 * F[3 * f + 2]];
    const double sa = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0]);
    if (!(sa >= 1e-10)) return false;  // catches NaN too
  }
  // fold-over: internal-angle sums around vi and vj must be <= 2*pi + 1e-10
  // (reference :346-418)
  double sum_i = 0.0, sum_j = 0.0;
  for (i64 f = 0; f < nf; ++f) {
    for (int c = 0; c < 3; ++c) {
      const i64 v = F[3 * f + c];
      if (v != vi && v != vj) continue;
      const double* p0 = &UV[2 * v];
      const double* p1 = &UV[2 * F[3 * f + (c + 1) % 3]];
      const double* p2 = &UV[2 * F[3 * f + (c + 2) % 3]];
      const double ux = p1[0] - p0[0], uy = p1[1] - p0[1];
      const double wx = p2[0] - p0[0], wy = p2[1] - p0[1];
      const double ang = std::atan2(std::fabs(ux * wy - uy * wx),
                                    ux * wx + uy * wy);
      if (v == vi) sum_i += ang;
      if (v == vj) sum_j += ang;
    }
  }
  if (sum_i - 2 * M_PI > 1e-10 || sum_j - 2 * M_PI > 1e-10) return false;
  // UV triangle quality >= 0.01 (reference :420-477)
  for (i64 f = 0; f < nf; ++f) {
    const double q = tri_quality_2d(&UV[2 * F[3 * f]], &UV[2 * F[3 * f + 1]],
                                    &UV[2 * F[3 * f + 2]]);
    if (!(q >= 0.01)) return false;  // catches NaN
  }
  return true;
}

// ---------------------------------------------------------------------------
// joint_lscm top level
// ---------------------------------------------------------------------------
struct PatchLSCM {
  // inputs (local patch indexing)
  const std::vector<double>* V_pre;   // nV x 3
  const std::vector<i64>* F_pre;      // nf_pre x 3
  const std::vector<double>* V_post;  // nV x 3 (row vi = placement p)
  const std::vector<i64>* F_post;     // nf_post x 3 (vj removed, vj->vi)
  i64 nV, nf_pre, nf_post, vi, vj;
  bool vi_on_bd, vj_on_bd, edge_on_bd;
};

// One flatten attempt with an extra-joint-vertex layout (cases 0 and
// no-snap) or substitute-in-place layout (cases 1 and snap).
// Returns UV_pre/UV_post (nV x 2 each).
inline bool lscm_attempt(const PatchLSCM& P, bool extra_vertex, i64 subst_slot,
                         bool pin_vi_post,
                         const std::vector<i64>& extra_pins_block1,
                         std::vector<double>& UV_pre,
                         std::vector<double>& UV_post) {
  const i64 nV = P.nV;
  const i64 nVjoint = extra_vertex ? nV + 1 : nV;
  const i64 vi_post = extra_vertex ? nV : subst_slot;
  // joint vertex positions (thread-local scratch: one attempt per
  // collapse try; reused across the ~nF collapses of a build)
  static thread_local std::vector<double> Vj_pre, Vj_post;
  static thread_local std::vector<i64> Fj_post, b_UV;
  static thread_local std::vector<double> bc_UV;
  Vj_pre.assign(3 * nVjoint, 0.0);
  std::copy(P.V_pre->begin(), P.V_pre->end(), Vj_pre.begin());
  Vj_post.assign(Vj_pre.begin(), Vj_pre.end());
  const double* p = &(*P.V_post)[3 * P.vi];
  if (extra_vertex) {
    for (int k = 0; k < 3; ++k) Vj_pre[3 * nV + k] = p[k];
    for (int k = 0; k < 3; ++k) Vj_post[3 * nV + k] = p[k];
  } else {
    for (int k = 0; k < 3; ++k) Vj_post[3 * subst_slot + k] = p[k];
  }
  // joint post faces: vi -> vi_post
  Fj_post.assign(P.F_post->begin(), P.F_post->end());
  for (size_t k = 0; k < Fj_post.size(); ++k)
    if (Fj_post[k] == P.vi) Fj_post[k] = vi_post;
  // pins: block0 (UV col 1): vi=0, vj=1; block1 (UV col 0): vi=0, vj=0,
  // plus vi_post and extra collinearity pins at 0.
  b_UV.assign({P.vi, P.vj, P.vi + nVjoint, P.vj + nVjoint});
  bc_UV.assign({0.0, 1.0, 0.0, 0.0});
  if (pin_vi_post) {
    // only the no-snap case-2 layout pins the extra post vertex to the
    // u = 0 line (reference :1101); case 0 leaves it free (reference :619)
    b_UV.push_back(vi_post + nVjoint);
    bc_UV.push_back(0.0);
  }
  for (const i64 v : extra_pins_block1) {
    bool dup = false;
    for (const i64 bb : b_UV) dup |= (bb == v + nVjoint);
    if (!dup) {
      b_UV.push_back(v + nVjoint);
      bc_UV.push_back(0.0);
    }
  }
  static thread_local std::vector<double> UVjoint;
  if (!flatten_joint(Vj_pre, *P.F_pre, P.nf_pre, Vj_post, Fj_post, P.nf_post,
                     b_UV, bc_UV, nVjoint, UVjoint))
    return false;
  UV_pre.assign(UVjoint.begin(), UVjoint.begin() + 2 * nV);
  UV_post = UV_pre;
  UV_post[2 * P.vi] = UVjoint[2 * vi_post];
  UV_post[2 * P.vi + 1] = UVjoint[2 * vi_post + 1];
  return true;
}

// Full joint_lscm with case dispatch (reference src/joint_lscm.cpp:3-241).
// Returns false when the collapse must be rejected.
inline bool joint_lscm(const PatchLSCM& P, std::vector<double>& UV_pre,
                       std::vector<double>& UV_post) {
  const int n_bd = (P.vi_on_bd ? 1 : 0) + (P.vj_on_bd ? 1 : 0);
  // flap rejection (reference :59-77)
  if (n_bd == 2 && !P.edge_on_bd) return false;
  // 3D triangle quality gate on post faces for boundary cases
  // (threshold 0.3, reference :91-117)
  if (n_bd > 0) {
    for (i64 f = 0; f < P.nf_post; ++f) {
      const i64 a = (*P.F_post)[3 * f], b = (*P.F_post)[3 * f + 1],
                c = (*P.F_post)[3 * f + 2];
      double l[3];
      auto dist = [&](i64 u, i64 v) {
        const double dx = (*P.V_post)[3 * u] - (*P.V_post)[3 * v];
        const double dy = (*P.V_post)[3 * u + 1] - (*P.V_post)[3 * v + 1];
        const double dz = (*P.V_post)[3 * u + 2] - (*P.V_post)[3 * v + 2];
        return std::sqrt(dx * dx + dy * dy + dz * dz);
      };
      l[0] = dist(a, b);
      l[1] = dist(b, c);
      l[2] = dist(c, a);
      const double x = (l[0] + l[1] + l[2]) / 2;
      const double delta =
          std::sqrt(x * (x - l[0]) * (x - l[1]) * (x - l[2]));
      const double q = 4 * std::sqrt(3.0) * delta /
                       (l[0] * l[0] + l[1] * l[1] + l[2] * l[2]);
      if (!(q >= 0.3)) return false;
    }
  }

  bool ok = false;
  if (n_bd == 0) {
    // case 0 (reference :557-651): extra joint vertex for post-vi
    ok = lscm_attempt(P, /*extra_vertex=*/true, -1, /*pin_vi_post=*/false, {},
                      UV_pre, UV_post);
  } else if (n_bd == 1) {
    // case 1 (reference :653-748): substitute post-vi in place of the
    // boundary endpoint
    const i64 v_bd = P.vi_on_bd ? P.vi : P.vj;
    ok = lscm_attempt(P, /*extra_vertex=*/false, v_bd, /*pin_vi_post=*/false,
                      {}, UV_pre, UV_post);
  } else {
    // case 2 (reference :750-836): boundary edge — compare snap-to-vi,
    // snap-to-vj and no-snap by summed quasi-conformal error.
    std::vector<i64> loop;
    if (!boundary_loop(*P.F_pre, P.nf_pre, loop)) return false;
    const i64 L = (i64)loop.size();
    auto find_in_loop = [&](i64 v) {
      for (i64 k = 0; k < L; ++k)
        if (loop[k] == v) return k;
      return (i64)-1;
    };
    const double HUGE_ERR = std::numeric_limits<double>::max();
    double best = HUGE_ERR;
    std::vector<double> uvp, uvq;
    // snap attempts (reference case2_constraint3_snap1 :838-968): pin the
    // straight-line continuation vertex vk two boundary steps from snapIdx
    // through the other endpoint.
    for (int which = 0; which < 2; ++which) {
      const i64 snap = which == 0 ? P.vi : P.vj;
      const i64 pos = find_in_loop(snap);
      if (pos < 0) continue;
      i64 vk = -1;
      const i64 prv = loop[(pos - 1 + L) % L], nxt = loop[(pos + 1) % L];
      if (prv == P.vi || prv == P.vj) vk = loop[(pos - 2 + L) % L];
      if (nxt == P.vi || nxt == P.vj) vk = loop[(pos + 2) % L];
      if (vk < 0) continue;
      std::vector<double> up, uq;
      if (!lscm_attempt(P, /*extra_vertex=*/false, snap, /*pin_vi_post=*/false,
                        {vk}, up, uq))
        continue;
      double err = quasi_conformal_error_norm(*P.V_pre, *P.F_pre, P.nf_pre, up) +
                   quasi_conformal_error_norm(*P.V_post, *P.F_post, P.nf_post, uq);
      if (std::isnan(err)) err = HUGE_ERR;
      if (err < best) {
        best = err;
        uvp = up;
        uvq = uq;
      }
    }
    // no-snap attempt (reference case2_constraint4 :970-1131): extra joint
    // vertex; pin the whole pre boundary minus the post-free vertices
    // (every boundary vertex except those strictly between vi's post
    // neighbors) to the u=0 line.
    {
      // post boundary loop = pre loop minus vj
      std::vector<i64> loop_post;
      for (const i64 v : loop)
        if (v != P.vj) loop_post.push_back(v);
      const i64 Lp = (i64)loop_post.size();
      i64 pos = -1;
      for (i64 k = 0; k < Lp; ++k)
        if (loop_post[k] == P.vi) pos = k;
      if (pos >= 0 && Lp >= 3) {
        const i64 nb_prev = loop_post[(pos - 1 + Lp) % Lp];
        const i64 nb_next = loop_post[(pos + 1) % Lp];
        // free = post-boundary minus {nb_prev, vi, nb_next}; pins = pre
        // boundary minus free (reference :1088-1091)
        std::vector<i64> pins;
        for (const i64 v : loop) {
          const bool in_post =
              std::find(loop_post.begin(), loop_post.end(), v) != loop_post.end();
          const bool is_nb = (v == nb_prev || v == P.vi || v == nb_next);
          if (!in_post || is_nb) pins.push_back(v);
        }
        std::vector<double> up, uq;
        if (lscm_attempt(P, /*extra_vertex=*/true, -1, /*pin_vi_post=*/true,
                         pins, up, uq)) {
          double err =
              quasi_conformal_error_norm(*P.V_pre, *P.F_pre, P.nf_pre, up) +
              quasi_conformal_error_norm(*P.V_post, *P.F_post, P.nf_post, uq);
          if (std::isnan(err)) err = HUGE_ERR;
          if (err < best) {
            best = err;
            uvp = up;
            uvq = uq;
          }
        }
      }
    }
    if (uvp.empty()) return false;
    UV_pre = uvp;
    UV_post = uvq;
    ok = true;
  }
  if (!ok) return false;
  return check_valid_uv(*P.F_pre, P.nf_pre, UV_pre, P.vi, P.vj) &&
         check_valid_uv(*P.F_post, P.nf_post, UV_post, P.vi, P.vj);
}

}  // namespace ssp

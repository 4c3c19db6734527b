// Small dense linear algebra for the SSP host engine.
//
// The joint-LSCM flattening solves tiny (≈26x26 .. 60x60) dense
// equality-constrained quadratic systems, one per attempted edge collapse
// (reference: src/mqwf_dense.cpp, src/joint_lscm.cpp:483-543).  We hand-roll
// row-major matrices and an LU solver with partial pivoting — no Eigen
// dependency; these systems are far below any BLAS crossover.
#pragma once

#include <algorithm>
#include <cassert>
#include <cmath>
#include <cstdint>
#include <vector>

namespace ssp {

struct Mat {
  int64_t r = 0, c = 0;
  std::vector<double> a;

  Mat() = default;
  Mat(int64_t rows, int64_t cols) : r(rows), c(cols), a(rows * cols, 0.0) {}

  double& operator()(int64_t i, int64_t j) { return a[i * c + j]; }
  double operator()(int64_t i, int64_t j) const { return a[i * c + j]; }
  void set_zero() { std::fill(a.begin(), a.end(), 0.0); }
};

// Solve A x = b in place (A overwritten with LU factors, b with solution).
// Partial pivoting; returns false when A is numerically singular.
inline bool lu_solve(Mat& A, std::vector<double>& b) {
  const int64_t n = A.r;
  assert(A.c == n && (int64_t)b.size() == n);
  for (int64_t k = 0; k < n; ++k) {
    // pivot
    int64_t piv = k;
    double best = std::fabs(A(k, k));
    for (int64_t i = k + 1; i < n; ++i) {
      const double v = std::fabs(A(i, k));
      if (v > best) {
        best = v;
        piv = i;
      }
    }
    if (!(best > 0.0) || !std::isfinite(best)) return false;
    if (piv != k) {
      for (int64_t j = 0; j < n; ++j) std::swap(A(k, j), A(piv, j));
      std::swap(b[k], b[piv]);
    }
    const double inv = 1.0 / A(k, k);
    for (int64_t i = k + 1; i < n; ++i) {
      const double f = A(i, k) * inv;
      if (f == 0.0) continue;
      A(i, k) = f;
      for (int64_t j = k + 1; j < n; ++j) A(i, j) -= f * A(k, j);
      b[i] -= f * b[k];
    }
  }
  // back substitution
  for (int64_t i = n - 1; i >= 0; --i) {
    double s = b[i];
    for (int64_t j = i + 1; j < n; ++j) s -= A(i, j) * b[j];
    b[i] = s / A(i, i);
  }
  return true;
}

// Solve the 3x3 system p A = -b (row-vector convention of quadric
// minimization: reference src/SSP_qslim_optimal_collapse_edge_callbacks.cpp:39-44).
// Returns false if singular; then cost should be forced to +inf.
inline bool quadric_minimizer(const double A[9], const double b[3], double p[3]) {
  // Row-vector p solving p A = -b  <=>  A^T p^T = -b^T; A symmetric here.
  Mat M(3, 3);
  std::vector<double> rhs(3);
  for (int i = 0; i < 3; ++i) {
    rhs[i] = -b[i];
    for (int j = 0; j < 3; ++j) M(i, j) = A[3 * j + i];
  }
  if (!lu_solve(M, rhs)) return false;
  for (int i = 0; i < 3; ++i) p[i] = rhs[i];
  return std::isfinite(p[0]) && std::isfinite(p[1]) && std::isfinite(p[2]);
}

}  // namespace ssp

// Native robust two-view estimator: essential-matrix RANSAC (8-point, MSAC
// scoring, local optimization) + pose recovery by cheirality voting.
//
// This is the framework's C++ counterpart of the native machinery the
// reference delegates to OpenCV C++ / PoseLib (reference
// romatch/utils/utils.py:31-76, benchmarks/*_poselib.py). Self-contained:
// fixed-size Jacobi eigen/SVD in linalg.h, no external dependencies.
// Exposed through a C ABI consumed via ctypes (roma_torch/estimation/native.py).
//
// Build: make -C roma_torch/native (into build/native/libransac.so)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

#include "linalg.h"

namespace {

using rt::det3;
using rt::jacobi_eigen;
using rt::matmul3;
using rt::nullvec4;
using rt::svd3;
using rt::transpose3;

struct Pt {
  double x, y;
};

// Hartley normalization: returns transform T s.t. q = T p (homogeneous).
void normalize_pts(const Pt* p, const int* idx, int k, Pt* out, double T[9]) {
  double mx = 0, my = 0;
  for (int i = 0; i < k; ++i) {
    mx += p[idx[i]].x;
    my += p[idx[i]].y;
  }
  mx /= k;
  my /= k;
  double d = 0;
  for (int i = 0; i < k; ++i) {
    double dx = p[idx[i]].x - mx, dy = p[idx[i]].y - my;
    d += std::sqrt(dx * dx + dy * dy);
  }
  d /= k;
  double s = std::sqrt(2.0) / std::max(d, 1e-12);
  for (int i = 0; i < k; ++i) {
    out[i].x = s * (p[idx[i]].x - mx);
    out[i].y = s * (p[idx[i]].y - my);
  }
  T[0] = s; T[1] = 0; T[2] = -s * mx;
  T[3] = 0; T[4] = s; T[5] = -s * my;
  T[6] = 0; T[7] = 0; T[8] = 1;
}

// Normalized 8-point on k >= 8 correspondences; E projected to the
// essential manifold after denormalization.
bool eight_point(const Pt* p0, const Pt* p1, const int* idx, int k,
                 double E[9]) {
  std::vector<Pt> n0(k), n1(k);
  double T0[9], T1[9];
  normalize_pts(p0, idx, k, n0.data(), T0);
  normalize_pts(p1, idx, k, n1.data(), T1);

  // accumulate A^T A for rows a = [x1x0, x1y0, x1, y1x0, y1y0, y1, x0, y0, 1]
  double ATA[81] = {0};
  for (int i = 0; i < k; ++i) {
    double a[9] = {n1[i].x * n0[i].x, n1[i].x * n0[i].y, n1[i].x,
                   n1[i].y * n0[i].x, n1[i].y * n0[i].y, n1[i].y,
                   n0[i].x,           n0[i].y,           1.0};
    for (int r = 0; r < 9; ++r)
      for (int c = 0; c < 9; ++c) ATA[r * 9 + c] += a[r] * a[c];
  }
  double w[9], V[81];
  jacobi_eigen<9>(ATA, w, V);
  double F[9];
  for (int i = 0; i < 9; ++i) F[i] = V[i * 9 + 8];  // smallest eigenvalue

  // denormalize F = T1^T F T0
  double T1t[9], tmp[9];
  transpose3(T1, T1t);
  matmul3(T1t, F, tmp);
  matmul3(tmp, T0, F);

  // project to essential manifold
  double U[9], s[3], Vt[9], Vm[9];
  svd3(F, U, s, Vm);
  double sm = 0.5 * (s[0] + s[1]);
  double S[9] = {sm, 0, 0, 0, sm, 0, 0, 0, 0};
  transpose3(Vm, Vt);
  matmul3(U, S, tmp);
  matmul3(tmp, Vt, E);
  return true;
}

// ---------------------------------------------------------------------------
// 5-point minimal solver (Nistér/Stewenius action-matrix formulation).
// Mirrors roma_torch/estimation/fivepoint.py: the 10 cubic constraints are
// built by generic polynomial arithmetic over exponent tuples (no derived
// coefficient tables), then Gauss-Jordan + a 10x10 eigen problem.
// ---------------------------------------------------------------------------

// monomial order: 10 leading degree-3 monomials, then the quotient basis
// [x2, xy, xz, y2, yz, z2, x, y, z, 1]
const int kExp20[20][3] = {
    {3, 0, 0}, {2, 1, 0}, {2, 0, 1}, {1, 2, 0}, {1, 1, 1}, {1, 0, 2},
    {0, 3, 0}, {0, 2, 1}, {0, 1, 2}, {0, 0, 3},
    {2, 0, 0}, {1, 1, 0}, {1, 0, 1}, {0, 2, 0}, {0, 1, 1}, {0, 0, 2},
    {1, 0, 0}, {0, 1, 0}, {0, 0, 1}, {0, 0, 0}};

int col20(int i, int j, int k) {
  for (int c = 0; c < 20; ++c)
    if (kExp20[c][0] == i && kExp20[c][1] == j && kExp20[c][2] == k) return c;
  return -1;
}

// multiply two polynomials given as dense coefficient vectors over kExp20
// (degrees must not exceed 3 in the product)
void pmul(const double a[20], const double b[20], double out[20]) {
  for (int c = 0; c < 20; ++c) out[c] = 0;
  for (int ia = 0; ia < 20; ++ia) {
    if (a[ia] == 0.0) continue;
    for (int ib = 0; ib < 20; ++ib) {
      if (b[ib] == 0.0) continue;
      int e0 = kExp20[ia][0] + kExp20[ib][0];
      int e1 = kExp20[ia][1] + kExp20[ib][1];
      int e2 = kExp20[ia][2] + kExp20[ib][2];
      int c = col20(e0, e1, e2);
      if (c >= 0) out[c] += a[ia] * b[ib];
    }
  }
}

void padd(double acc[20], const double p[20], double s = 1.0) {
  for (int c = 0; c < 20; ++c) acc[c] += s * p[c];
}

// Solve the 5-point problem for one minimal sample. Writes up to 10
// essential matrices (row-major, unit Frobenius norm) to E_out; returns the
// count.
int five_point(const Pt* p0, const Pt* p1, const int idx[5],
               double E_out[10][9]) {
  // nullspace basis of the 5 epipolar rows
  double ATA[81] = {0};
  for (int i = 0; i < 5; ++i) {
    const Pt& a = p0[idx[i]];
    const Pt& b = p1[idx[i]];
    double row[9] = {b.x * a.x, b.x * a.y, b.x, b.y * a.x, b.y * a.y,
                     b.y,       a.x,       a.y, 1.0};
    for (int r = 0; r < 9; ++r)
      for (int c = 0; c < 9; ++c) ATA[r * 9 + c] += row[r] * row[c];
  }
  double w[9], V[81];
  jacobi_eigen<9>(ATA, w, V);
  double Eb[4][9];  // basis: E = x Eb0 + y Eb1 + z Eb2 + Eb3
  for (int b = 0; b < 4; ++b)
    for (int i = 0; i < 9; ++i) Eb[b][i] = V[i * 9 + (5 + b)];

  // E entries as degree-1 polynomials over kExp20
  double Ep[9][20];
  for (int e = 0; e < 9; ++e) {
    for (int c = 0; c < 20; ++c) Ep[e][c] = 0;
    Ep[e][16] = Eb[0][e];  // x
    Ep[e][17] = Eb[1][e];  // y
    Ep[e][18] = Eb[2][e];  // z
    Ep[e][19] = Eb[3][e];  // 1
  }
  auto EP = [&](int i, int j) -> const double* { return Ep[i * 3 + j]; };

  double M[10][20];
  // det(E) = 0
  {
    double t1[20], t2[20], s[20], acc[20] = {0};
    // E00 (E11 E22 - E12 E21)
    pmul(EP(1, 1), EP(2, 2), t1);
    pmul(EP(1, 2), EP(2, 1), t2);
    for (int c = 0; c < 20; ++c) s[c] = t1[c] - t2[c];
    pmul(EP(0, 0), s, t1);
    padd(acc, t1);
    // - E01 (E10 E22 - E12 E20)
    pmul(EP(1, 0), EP(2, 2), t1);
    pmul(EP(1, 2), EP(2, 0), t2);
    for (int c = 0; c < 20; ++c) s[c] = t1[c] - t2[c];
    pmul(EP(0, 1), s, t1);
    padd(acc, t1, -1.0);
    // + E02 (E10 E21 - E11 E20)
    pmul(EP(1, 0), EP(2, 1), t1);
    pmul(EP(1, 1), EP(2, 0), t2);
    for (int c = 0; c < 20; ++c) s[c] = t1[c] - t2[c];
    pmul(EP(0, 2), s, t1);
    padd(acc, t1);
    std::memcpy(M[0], acc, sizeof(acc));
  }
  // 2 E E^T E - tr(E E^T) E = 0
  double EEt[3][3][20];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double acc[20] = {0}, t[20];
      for (int k = 0; k < 3; ++k) {
        pmul(EP(i, k), EP(j, k), t);
        padd(acc, t);
      }
      std::memcpy(EEt[i][j], acc, sizeof(acc));
    }
  double tr[20] = {0};
  for (int i = 0; i < 3; ++i) padd(tr, EEt[i][i]);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double acc[20] = {0}, t[20];
      for (int k = 0; k < 3; ++k) {
        pmul(EEt[i][k], EP(k, j), t);
        padd(acc, t, 2.0);
      }
      pmul(tr, EP(i, j), t);
      padd(acc, t, -1.0);
      std::memcpy(M[1 + i * 3 + j], acc, sizeof(acc));
    }

  // Gauss-Jordan: [A | B] -> G = A^-1 B
  double A[100], B[100];
  for (int r = 0; r < 10; ++r)
    for (int c = 0; c < 10; ++c) {
      A[r * 10 + c] = M[r][c];
      B[r * 10 + c] = M[r][c + 10];
    }
  if (!rt::solve_linear<10, 10>(A, B)) return 0;

  // action matrix of multiplication-by-x on the quotient basis
  double Ax[100] = {0};
  for (int r = 0; r < 6; ++r)
    for (int c = 0; c < 10; ++c) Ax[r * 10 + c] = -B[r * 10 + c];
  Ax[6 * 10 + 0] = 1.0;  // x * x  = x2
  Ax[7 * 10 + 1] = 1.0;  // x * y  = xy
  Ax[8 * 10 + 2] = 1.0;  // x * z  = xz
  Ax[9 * 10 + 6] = 1.0;  // x * 1  = x

  double lam[10];
  int nreal = rt::real_eigenvalues<10>(Ax, lam);
  int n_models = 0;
  for (int r = 0; r < nreal && n_models < 10; ++r) {
    double Mv[100];
    for (int i = 0; i < 10; ++i)
      for (int j = 0; j < 10; ++j)
        Mv[i * 10 + j] = Ax[i * 10 + j] - (i == j ? lam[r] : 0.0);
    double v[10];
    rt::nullvec_general<10>(Mv, v);
    if (std::fabs(v[9]) < 1e-12) continue;
    double x = v[6] / v[9], y = v[7] / v[9], z = v[8] / v[9];
    double* E = E_out[n_models];
    double nrm = 0;
    for (int e = 0; e < 9; ++e) {
      E[e] = x * Eb[0][e] + y * Eb[1][e] + z * Eb[2][e] + Eb[3][e];
      nrm += E[e] * E[e];
    }
    nrm = std::sqrt(nrm);
    if (nrm < 1e-12) continue;
    for (int e = 0; e < 9; ++e) E[e] /= nrm;
    ++n_models;
  }
  return n_models;
}

double sampson_sq(const double E[9], const Pt& a, const Pt& b) {
  double Fx0[3] = {E[0] * a.x + E[1] * a.y + E[2],
                   E[3] * a.x + E[4] * a.y + E[5],
                   E[6] * a.x + E[7] * a.y + E[8]};
  double Ftx1[3] = {E[0] * b.x + E[3] * b.y + E[6],
                    E[1] * b.x + E[4] * b.y + E[7],
                    E[2] * b.x + E[5] * b.y + E[8]};
  double e = b.x * Fx0[0] + b.y * Fx0[1] + Fx0[2];
  double denom =
      Fx0[0] * Fx0[0] + Fx0[1] * Fx0[1] + Ftx1[0] * Ftx1[0] + Ftx1[1] * Ftx1[1];
  return e * e / std::max(denom, 1e-12);
}

// Model score over all points; fills inlier flags (threshold t2 for the
// mask regardless of scoring). scoring 0 = MSAC (truncated squared
// residual); 1 = MAGSAC-style sigma-marginalized truncated quadratic:
// mean over K sigma levels tau_j = threshold * j/K of min(r2, tau_j^2) /
// tau_j^2 (see roma_torch/estimation/ransac.py::_rho).
double score_model(const double E[9], const Pt* p0, const Pt* p1, int n,
                   double t2, int scoring, uint8_t* inl) {
  constexpr int kLevels = 8;
  double taus2[kLevels];
  if (scoring == 1)
    for (int j = 0; j < kLevels; ++j) {
      double f = double(j + 1) / kLevels;
      taus2[j] = t2 * f * f;
    }
  double score = 0;
  for (int i = 0; i < n; ++i) {
    double r2 = sampson_sq(E, p0[i], p1[i]);
    if (inl) inl[i] = r2 < t2 ? 1 : 0;
    if (scoring == 1) {
      double s = 0;
      for (int j = 0; j < kLevels; ++j)
        s += std::min(r2, taus2[j]) / (taus2[j] * kLevels);
      score += s;
    } else {
      score += std::min(r2, t2);
    }
  }
  return score;
}

void triangulate_point(const double R[9], const double t[3], const Pt& a,
                       const Pt& b, double X[3]) {
  // P0 = [I|0], P1 = [R|t]; DLT rows
  double A[16] = {
      -1, 0,  a.x, 0,
      0,  -1, a.y, 0,
      b.x * R[6] - R[0], b.x * R[7] - R[1], b.x * R[8] - R[2], b.x * t[2] - t[0],
      b.y * R[6] - R[3], b.y * R[7] - R[4], b.y * R[8] - R[5], b.y * t[2] - t[1]};
  double x4[4];
  nullvec4(A, x4);
  double wv = (std::fabs(x4[3]) < 1e-12) ? 1e-12 : x4[3];
  X[0] = x4[0] / wv;
  X[1] = x4[1] / wv;
  X[2] = x4[2] / wv;
}

// Decompose E into 4 (R, t) candidates and pick by cheirality.
int recover_pose(const double E[9], const Pt* p0, const Pt* p1, int n,
                 const uint8_t* inl, double R_out[9], double t_out[3]) {
  double U[9], s[3], V[9];
  svd3(E, U, s, V);
  if (det3(U) < 0)
    for (int i = 0; i < 9; ++i) U[i] = -U[i];
  if (det3(V) < 0)
    for (int i = 0; i < 9; ++i) V[i] = -V[i];
  double W[9] = {0, -1, 0, 1, 0, 0, 0, 0, 1};
  double Wt[9];
  transpose3(W, Wt);
  double Vt[9];
  transpose3(V, Vt);
  double R1[9], R2[9], tmp[9];
  matmul3(U, W, tmp);
  matmul3(tmp, Vt, R1);
  matmul3(U, Wt, tmp);
  matmul3(tmp, Vt, R2);
  double tv[3] = {U[2], U[5], U[8]};

  const double* Rs[4] = {R1, R1, R2, R2};
  double ts[4][3] = {{tv[0], tv[1], tv[2]},
                     {-tv[0], -tv[1], -tv[2]},
                     {tv[0], tv[1], tv[2]},
                     {-tv[0], -tv[1], -tv[2]}};
  int best_good = -1, best_i = 0;
  // subsample inliers for the vote
  std::vector<int> sel;
  for (int i = 0; i < n && (int)sel.size() < 512; ++i)
    if (!inl || inl[i]) sel.push_back(i);
  for (int c = 0; c < 4; ++c) {
    int good = 0;
    for (int i : sel) {
      double X[3];
      triangulate_point(Rs[c], ts[c], p0[i], p1[i], X);
      double z0 = X[2];
      double z1 = Rs[c][6] * X[0] + Rs[c][7] * X[1] + Rs[c][8] * X[2] + ts[c][2];
      if (z0 > 0 && z1 > 0 && z0 < 50 && z1 < 50) ++good;
    }
    if (good > best_good) {
      best_good = good;
      best_i = c;
    }
  }
  std::memcpy(R_out, Rs[best_i], 9 * sizeof(double));
  std::memcpy(t_out, ts[best_i], 3 * sizeof(double));
  return best_good;
}

}  // namespace

extern "C" {

// Essential-matrix RANSAC + pose recovery on K-normalized correspondences.
// p0, p1: (n, 2) row-major doubles. Returns number of inliers (0 on failure).
// solver: 0 = 8-point, 1 = 5-point minimal (Nistér); LO always re-fits with
// the non-minimal 8-point. scoring: 0 = MSAC, 1 = MAGSAC-style marginalized.
// Outputs: E (9), R (9), t (3), inliers (n bytes).
int estimate_essential_ransac_v2(const double* p0_raw, const double* p1_raw,
                                 int n, double threshold, int max_iters,
                                 int solver, int scoring, uint64_t seed,
                                 double* E_out, double* R_out, double* t_out,
                                 uint8_t* inliers_out) {
  const int k = (solver == 1) ? 5 : 8;
  if (n < k) return 0;
  const Pt* p0 = reinterpret_cast<const Pt*>(p0_raw);
  const Pt* p1 = reinterpret_cast<const Pt*>(p1_raw);
  double t2 = threshold * threshold;
  std::mt19937_64 rng(seed);
  std::uniform_int_distribution<int> uni(0, n - 1);

  double best_score = 1e300;
  double best_E[9];
  std::vector<uint8_t> inl(n), best_inl(n);

  // adaptive termination: needed = log(1-conf) / log(1 - w^k) for the best
  // inlier ratio w seen so far (standard RANSAC stopping criterion)
  const double kLogOneMinusConf = std::log(1e-5);
  int needed = max_iters;
  int idx[8];
  for (int it = 0; it < max_iters && it < needed; ++it) {
    // sample k distinct indices
    for (int i = 0; i < k; ++i) {
      bool dup;
      do {
        idx[i] = uni(rng);
        dup = false;
        for (int j = 0; j < i; ++j) dup |= (idx[j] == idx[i]);
      } while (dup);
    }
    double models[10][9];
    int nm;
    if (solver == 1) {
      nm = five_point(p0, p1, idx, models);
    } else {
      nm = eight_point(p0, p1, idx, 8, models[0]) ? 1 : 0;
    }
    bool improved = false;
    for (int m = 0; m < nm; ++m) {
      double sc = score_model(models[m], p0, p1, n, t2, scoring, inl.data());
      if (sc < best_score) {
        best_score = sc;
        std::memcpy(best_E, models[m], sizeof(best_E));
        best_inl = inl;
        improved = true;
      }
    }
    if (improved) {
      int cnt = 0;
      for (int i = 0; i < n; ++i) cnt += best_inl[i];
      double w = std::max(double(cnt) / n, 1e-3);
      double denom = std::log(std::max(1.0 - std::pow(w, k), 1e-12));
      needed = (int)std::ceil(kLogOneMinusConf / denom);
    }
  }
  if (best_score >= 1e300) return 0;

  // local optimization: iterated non-minimal (8-point) re-fit on inliers
  for (int lo = 0; lo < 2; ++lo) {
    std::vector<int> ii;
    for (int i = 0; i < n; ++i)
      if (best_inl[i]) ii.push_back(i);
    if ((int)ii.size() <= 8) break;
    if ((int)ii.size() > 4096) {
      std::shuffle(ii.begin(), ii.end(), rng);
      ii.resize(4096);
    }
    double E[9];
    if (!eight_point(p0, p1, ii.data(), (int)ii.size(), E)) break;
    double sc = score_model(E, p0, p1, n, t2, scoring, inl.data());
    if (sc < best_score) {
      best_score = sc;
      std::memcpy(best_E, E, sizeof(best_E));
      best_inl = inl;
    } else {
      break;
    }
  }

  std::memcpy(E_out, best_E, sizeof(best_E));
  if (inliers_out) std::memcpy(inliers_out, best_inl.data(), n);
  int ngood = recover_pose(best_E, p0, p1, n, best_inl.data(), R_out, t_out);
  int count = 0;
  for (int i = 0; i < n; ++i) count += best_inl[i];
  return ngood > 0 ? count : 0;
}

// Backwards-compatible entry: 8-point + MSAC.
int estimate_essential_ransac(const double* p0_raw, const double* p1_raw,
                              int n, double threshold, int max_iters,
                              uint64_t seed, double* E_out, double* R_out,
                              double* t_out, uint8_t* inliers_out) {
  return estimate_essential_ransac_v2(p0_raw, p1_raw, n, threshold, max_iters,
                                      0, 0, seed, E_out, R_out, t_out,
                                      inliers_out);
}

}  // extern "C"

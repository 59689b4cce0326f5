// Small fixed-size linear algebra for the robust estimator.
// Self-contained (no Eigen/LAPACK): cyclic Jacobi eigensolver for symmetric
// matrices, SVD via eigen-decomposition of A^T A, 3x3 helpers.
#pragma once

#include <cmath>
#include <cstring>

namespace rt {

// Cyclic Jacobi eigendecomposition of a symmetric n x n matrix A (row-major).
// On return: eigenvalues in w (descending), eigenvectors in columns of V.
template <int N>
inline void jacobi_eigen(double A[N * N], double w[N], double V[N * N]) {
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < N; ++j) V[i * N + j] = (i == j) ? 1.0 : 0.0;
  for (int sweep = 0; sweep < 60; ++sweep) {
    double off = 0.0;
    for (int p = 0; p < N; ++p)
      for (int q = p + 1; q < N; ++q) off += A[p * N + q] * A[p * N + q];
    if (off < 1e-24) break;
    for (int p = 0; p < N; ++p) {
      for (int q = p + 1; q < N; ++q) {
        double apq = A[p * N + q];
        if (std::fabs(apq) < 1e-300) continue;
        double app = A[p * N + p], aqq = A[q * N + q];
        double theta = 0.5 * (aqq - app) / apq;
        double t = (theta >= 0 ? 1.0 : -1.0) /
                   (std::fabs(theta) + std::sqrt(theta * theta + 1.0));
        double c = 1.0 / std::sqrt(t * t + 1.0), s = t * c;
        for (int k = 0; k < N; ++k) {
          double akp = A[k * N + p], akq = A[k * N + q];
          A[k * N + p] = c * akp - s * akq;
          A[k * N + q] = s * akp + c * akq;
        }
        for (int k = 0; k < N; ++k) {
          double apk = A[p * N + k], aqk = A[q * N + k];
          A[p * N + k] = c * apk - s * aqk;
          A[q * N + k] = s * apk + c * aqk;
        }
        for (int k = 0; k < N; ++k) {
          double vkp = V[k * N + p], vkq = V[k * N + q];
          V[k * N + p] = c * vkp - s * vkq;
          V[k * N + q] = s * vkp + c * vkq;
        }
      }
    }
  }
  for (int i = 0; i < N; ++i) w[i] = A[i * N + i];
  // sort descending (selection sort, tiny N)
  for (int i = 0; i < N - 1; ++i) {
    int m = i;
    for (int j = i + 1; j < N; ++j)
      if (w[j] > w[m]) m = j;
    if (m != i) {
      std::swap(w[i], w[m]);
      for (int k = 0; k < N; ++k) std::swap(V[k * N + i], V[k * N + m]);
    }
  }
}

// SVD of a 3x3 matrix A = U diag(s) V^T. V from eigen(A^T A); U columns are
// derived as A v_j / s_j so the U<->V pairing stays consistent even when
// singular values are (near-)equal — essential matrices have s1 == s2, where
// independent eigen-decompositions of A^T A and A A^T pair arbitrarily.
inline void svd3(const double A[9], double U[9], double s[3], double V[9]) {
  double ATA[9] = {0};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      for (int k = 0; k < 3; ++k) ATA[i * 3 + j] += A[k * 3 + i] * A[k * 3 + j];
  double wv[3];
  jacobi_eigen<3>(ATA, wv, V);
  for (int i = 0; i < 3; ++i) s[i] = std::sqrt(std::fmax(wv[i], 0.0));
  double u[3][3] = {{0}};
  // u0, u1 from A v / s, explicitly normalized (s can be noisy)
  for (int j = 0; j < 2; ++j) {
    double nrm = 0;
    for (int i = 0; i < 3; ++i) {
      double sum = 0;
      for (int k = 0; k < 3; ++k) sum += A[i * 3 + k] * V[k * 3 + j];
      u[j][i] = sum;
      nrm += sum * sum;
    }
    nrm = std::sqrt(nrm);
    if (nrm > 1e-12) {
      for (int i = 0; i < 3; ++i) u[j][i] /= nrm;
    } else {
      // rank-deficient beyond column 0: any orthogonal completion works
      double e[3] = {0, 0, 0};
      e[j] = 1.0;
      for (int k = 0; k < j; ++k) {
        double d = e[0] * u[k][0] + e[1] * u[k][1] + e[2] * u[k][2];
        for (int i = 0; i < 3; ++i) e[i] -= d * u[k][i];
      }
      double en = std::sqrt(e[0] * e[0] + e[1] * e[1] + e[2] * e[2]);
      for (int i = 0; i < 3; ++i) u[j][i] = e[i] / std::fmax(en, 1e-12);
    }
  }
  // u2 = u0 x u1: exact orthonormal completion. Correct up to sign — both
  // call sites are sign-insensitive (E-projection zeroes s3; E-decomposition
  // tries t = +-u3).
  u[2][0] = u[0][1] * u[1][2] - u[0][2] * u[1][1];
  u[2][1] = u[0][2] * u[1][0] - u[0][0] * u[1][2];
  u[2][2] = u[0][0] * u[1][1] - u[0][1] * u[1][0];
  for (int j = 0; j < 3; ++j)
    for (int i = 0; i < 3; ++i) U[i * 3 + j] = u[j][i];
}

inline void matmul3(const double A[9], const double B[9], double C[9]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double sum = 0;
      for (int k = 0; k < 3; ++k) sum += A[i * 3 + k] * B[k * 3 + j];
      C[i * 3 + j] = sum;
    }
}

inline void transpose3(const double A[9], double AT[9]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) AT[i * 3 + j] = A[j * 3 + i];
}

inline double det3(const double A[9]) {
  return A[0] * (A[4] * A[8] - A[5] * A[7]) -
         A[1] * (A[3] * A[8] - A[5] * A[6]) +
         A[2] * (A[3] * A[7] - A[4] * A[6]);
}

// Solve A X = B in-place via Gaussian elimination with partial pivoting.
// A: N x N, B: N x M (row-major); X written into B. Returns false if
// numerically singular.
template <int N, int M>
inline bool solve_linear(double A[N * N], double B[N * M]) {
  for (int c = 0; c < N; ++c) {
    int piv = c;
    for (int r = c + 1; r < N; ++r)
      if (std::fabs(A[r * N + c]) > std::fabs(A[piv * N + c])) piv = r;
    if (std::fabs(A[piv * N + c]) < 1e-14) return false;
    if (piv != c) {
      for (int k = 0; k < N; ++k) std::swap(A[c * N + k], A[piv * N + k]);
      for (int k = 0; k < M; ++k) std::swap(B[c * M + k], B[piv * M + k]);
    }
    double inv = 1.0 / A[c * N + c];
    for (int r = 0; r < N; ++r) {
      if (r == c) continue;
      double f = A[r * N + c] * inv;
      if (f == 0.0) continue;
      for (int k = c; k < N; ++k) A[r * N + k] -= f * A[c * N + k];
      for (int k = 0; k < M; ++k) B[r * M + k] -= f * B[c * M + k];
    }
  }
  for (int r = 0; r < N; ++r) {
    double inv = 1.0 / A[r * N + r];
    for (int k = 0; k < M; ++k) B[r * M + k] *= inv;
  }
  return true;
}

// Real eigenvalues of a general N x N matrix: Householder reduction to
// upper Hessenberg, then shifted QR iteration with Givens rotations and
// 1x1 / 2x2 deflation. Complex-pair 2x2 blocks are skipped. Returns the
// number of real eigenvalues written to `out`.
template <int N>
inline int real_eigenvalues(const double A_in[N * N], double out[N]) {
  double H[N * N];
  std::memcpy(H, A_in, sizeof(H));

  // Householder Hessenberg reduction
  for (int c = 0; c < N - 2; ++c) {
    double v[N] = {0};
    double nrm = 0;
    for (int r = c + 1; r < N; ++r) nrm += H[r * N + c] * H[r * N + c];
    nrm = std::sqrt(nrm);
    if (nrm < 1e-300) continue;
    double a0 = H[(c + 1) * N + c];
    double alpha = (a0 >= 0) ? -nrm : nrm;
    // |v|^2 with v = x - alpha e1: |x|^2 - 2 alpha a0 + alpha^2, alpha^2=|x|^2
    double vnorm2 = 2.0 * (nrm * nrm - a0 * alpha);
    if (vnorm2 < 1e-300) continue;
    v[c + 1] = a0 - alpha;
    for (int r = c + 2; r < N; ++r) v[r] = H[r * N + c];
    // H = (I - 2vv^T/|v|^2) H (I - 2vv^T/|v|^2)
    for (int j = 0; j < N; ++j) {  // left
      double s = 0;
      for (int r = c + 1; r < N; ++r) s += v[r] * H[r * N + j];
      s /= vnorm2;
      for (int r = c + 1; r < N; ++r) H[r * N + j] -= 2 * s * v[r];
    }
    for (int i = 0; i < N; ++i) {  // right
      double s = 0;
      for (int r = c + 1; r < N; ++r) s += H[i * N + r] * v[r];
      s /= vnorm2;
      for (int r = c + 1; r < N; ++r) H[i * N + r] -= 2 * s * v[r];
    }
  }

  int nreal = 0;
  int m = N;
  int guard = 0;
  while (m > 0 && ++guard < 500) {
    if (m == 1) {
      out[nreal++] = H[0];
      break;
    }
    // deflation scan
    int l = m - 1;
    while (l > 0) {
      double s = std::fabs(H[(l - 1) * N + (l - 1)]) + std::fabs(H[l * N + l]);
      if (std::fabs(H[l * N + (l - 1)]) < 1e-13 * (s + 1e-300)) break;
      --l;
    }
    if (l == m - 1) {  // 1x1 deflate
      out[nreal++] = H[(m - 1) * N + (m - 1)];
      --m;
      continue;
    }
    if (l == m - 2) {  // 2x2 deflate
      double a = H[(m - 2) * N + (m - 2)], b = H[(m - 2) * N + (m - 1)];
      double c = H[(m - 1) * N + (m - 2)], d = H[(m - 1) * N + (m - 1)];
      double tr = a + d, det = a * d - b * c;
      double disc = tr * tr / 4 - det;
      if (disc >= 0) {
        double rt = std::sqrt(disc);
        out[nreal++] = tr / 2 + rt;
        out[nreal++] = tr / 2 - rt;
      }
      m -= 2;
      continue;
    }
    // Wilkinson shift from the trailing 2x2 of the active block
    double a = H[(m - 2) * N + (m - 2)], b = H[(m - 2) * N + (m - 1)];
    double c = H[(m - 1) * N + (m - 2)], d = H[(m - 1) * N + (m - 1)];
    double tr = a + d, det = a * d - b * c;
    double disc = tr * tr / 4 - det;
    double mu;
    if (disc >= 0) {
      double r1 = tr / 2 + std::sqrt(disc), r2 = tr / 2 - std::sqrt(disc);
      mu = (std::fabs(r1 - d) < std::fabs(r2 - d)) ? r1 : r2;
    } else {
      mu = d;  // complex pair in the corner: use Rayleigh-ish real shift
    }
    // explicit shifted QR step on the active block H[l..m-1]:
    // H - mu I = Q R (Givens), then H <- R Q + mu I
    double cs[N], sn[N];
    for (int i = l; i < m; ++i) H[i * N + i] -= mu;
    for (int k = l; k < m - 1; ++k) {
      double x = H[k * N + k], y = H[(k + 1) * N + k];
      double r = std::hypot(x, y);
      if (r < 1e-300) { cs[k] = 1; sn[k] = 0; continue; }
      cs[k] = x / r;
      sn[k] = y / r;
      for (int j = k; j < m; ++j) {
        double h1 = H[k * N + j], h2 = H[(k + 1) * N + j];
        H[k * N + j] = cs[k] * h1 + sn[k] * h2;
        H[(k + 1) * N + j] = -sn[k] * h1 + cs[k] * h2;
      }
    }
    for (int k = l; k < m - 1; ++k) {
      for (int i = l; i <= k + 1; ++i) {
        double h1 = H[i * N + k], h2 = H[i * N + (k + 1)];
        H[i * N + k] = cs[k] * h1 + sn[k] * h2;
        H[i * N + (k + 1)] = -sn[k] * h1 + cs[k] * h2;
      }
    }
    for (int i = l; i < m; ++i) H[i * N + i] += mu;
  }
  return nreal;
}

// Smallest-eigenvector nullspace of a general N x N matrix M (via Jacobi on
// M^T M).
template <int N>
inline void nullvec_general(const double M[N * N], double x[N]) {
  double MTM[N * N] = {0};
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < N; ++j) {
      double s = 0;
      for (int k = 0; k < N; ++k) s += M[k * N + i] * M[k * N + j];
      MTM[i * N + j] = s;
    }
  double w[N], V[N * N];
  jacobi_eigen<N>(MTM, w, V);
  for (int i = 0; i < N; ++i) x[i] = V[i * N + (N - 1)];
}

// Solve 4x4 homogeneous system A x = 0 (smallest eigvec of A^T A).
inline void nullvec4(const double A[16], double x[4]) {
  double ATA[16] = {0};
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j)
      for (int k = 0; k < 4; ++k) ATA[i * 4 + j] += A[k * 4 + i] * A[k * 4 + j];
  double w[4], V[16];
  jacobi_eigen<4>(ATA, w, V);
  for (int i = 0; i < 4; ++i) x[i] = V[i * 4 + 3];  // smallest eigenvalue
}

}  // namespace rt

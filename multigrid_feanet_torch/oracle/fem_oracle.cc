// Independent C++ FEM oracle: bi-material Q1 Laplace on a uniform n x n
// element grid, CSR assembly, Jacobi-preconditioned conjugate gradients, f64.
//
// Plays the role of the reference's native ground-truth generators
// (reference: Archive/FEM/dealii_LinearLaplace/linear_laplace.cc:39-321 —
// same PDE: coefficient a1 inside the inclusion else a0, Q1 elements,
// Dirichlet BCs, CG to tight tolerance; reference:
// Archive/FEM/matlab_LinearLaplace/laplace.m) but dependency-free, and
// deliberately shares no code with the library under test.  The port's own
// copy of multigrid_feanet_tpu/oracle/fem_oracle.cc (same ABI and math),
// built by multigrid_feanet_torch/oracle/__init__.py.
//
// Exposed C ABI (ctypes):
//   int fem_solve(int n, const double* phase,  // n*n element phases (0/1)
//                 double a0, double a1,
//                 const double* f,             // (n+1)^2 nodal source
//                 const double* bc,            // (n+1)^2 Dirichlet values
//                                              // (read on the boundary ring)
//                 double tol, int max_iter,
//                 double* u_out,               // (n+1)^2 solution
//                 double* final_res)           // CG residual norm
// Returns the number of CG iterations, or -1 on non-convergence.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Q1 element stiffness for a square element, local nodes CCW from
// lower-left; exact integration (coefficient scales the whole matrix,
// h cancels in 2D).
const double KE[4][4] = {
    {2.0 / 3.0, -1.0 / 6.0, -1.0 / 3.0, -1.0 / 6.0},
    {-1.0 / 6.0, 2.0 / 3.0, -1.0 / 6.0, -1.0 / 3.0},
    {-1.0 / 3.0, -1.0 / 6.0, 2.0 / 3.0, -1.0 / 6.0},
    {-1.0 / 6.0, -1.0 / 3.0, -1.0 / 6.0, 2.0 / 3.0},
};

// Q1 consistent mass matrix / (h^2): diag 1/9, edge 1/18, opposite 1/36.
const double ME[4][4] = {
    {1.0 / 9.0, 1.0 / 18.0, 1.0 / 36.0, 1.0 / 18.0},
    {1.0 / 18.0, 1.0 / 9.0, 1.0 / 18.0, 1.0 / 36.0},
    {1.0 / 36.0, 1.0 / 18.0, 1.0 / 9.0, 1.0 / 18.0},
    {1.0 / 18.0, 1.0 / 36.0, 1.0 / 18.0, 1.0 / 9.0},
};

struct Csr {
  std::vector<int> rowptr, col;
  std::vector<double> val;
};

// Dense-per-row accumulation into a 9-neighbour map, then CSR.
void assemble(int n, const double* phase, double a0, double a1, Csr& K,
              std::vector<double>& mass_diag_free, const double* f,
              std::vector<double>& load) {
  const int H = n + 1;
  const int N = H * H;
  // Per-node 3x3 neighbour coefficient accumulation.
  std::vector<double> acc(static_cast<size_t>(N) * 9, 0.0);
  load.assign(N, 0.0);
  auto nid = [H](int i, int j) { return i * H + j; };
  for (int r = 0; r < n; ++r) {
    for (int c = 0; c < n; ++c) {
      const double a = (phase && phase[r * n + c] > 0.5) ? a1 : a0;
      const int nodes[4] = {nid(r, c), nid(r, c + 1), nid(r + 1, c + 1),
                            nid(r + 1, c)};
      const int di[4] = {0, 0, 1, 1};
      const int dj[4] = {0, 1, 1, 0};
      for (int p = 0; p < 4; ++p) {
        const int pi = r + di[p], pj = c + dj[p];
        for (int q = 0; q < 4; ++q) {
          const int qi = r + di[q], qj = c + dj[q];
          const int off = (qi - pi + 1) * 3 + (qj - pj + 1);
          acc[static_cast<size_t>(nodes[p]) * 9 + off] += a * KE[p][q];
          load[nodes[p]] += ME[p][q] * f[nodes[q]];  // times h^2 by caller
        }
      }
    }
  }
  K.rowptr.assign(N + 1, 0);
  for (int i = 0; i < H; ++i) {
    for (int j = 0; j < H; ++j) {
      const int row = nid(i, j);
      int cnt = 0;
      for (int o = 0; o < 9; ++o) {
        const int ni = i + o / 3 - 1, nj = j + o % 3 - 1;
        if (ni < 0 || nj < 0 || ni > n || nj > n) continue;
        if (acc[static_cast<size_t>(row) * 9 + o] != 0.0) ++cnt;
      }
      K.rowptr[row + 1] = cnt;
    }
  }
  for (int i = 0; i < N; ++i) K.rowptr[i + 1] += K.rowptr[i];
  K.col.resize(K.rowptr.back());
  K.val.resize(K.rowptr.back());
  std::vector<int> cursor(K.rowptr.begin(), K.rowptr.end() - 1);
  for (int i = 0; i < H; ++i) {
    for (int j = 0; j < H; ++j) {
      const int row = nid(i, j);
      for (int o = 0; o < 9; ++o) {
        const int ni = i + o / 3 - 1, nj = j + o % 3 - 1;
        if (ni < 0 || nj < 0 || ni > n || nj > n) continue;
        const double v = acc[static_cast<size_t>(row) * 9 + o];
        if (v == 0.0) continue;
        K.col[cursor[row]] = nid(ni, nj);
        K.val[cursor[row]] = v;
        ++cursor[row];
      }
    }
  }
  (void)mass_diag_free;
}

void spmv(const Csr& K, const std::vector<double>& x, std::vector<double>& y) {
  const int N = static_cast<int>(K.rowptr.size()) - 1;
  for (int i = 0; i < N; ++i) {
    double s = 0.0;
    for (int k = K.rowptr[i]; k < K.rowptr[i + 1]; ++k)
      s += K.val[k] * x[K.col[k]];
    y[i] = s;
  }
}

double dot(const std::vector<double>& a, const std::vector<double>& b) {
  double s = 0.0;
  for (size_t i = 0; i < a.size(); ++i) s += a[i] * b[i];
  return s;
}

}  // namespace

extern "C" int fem_solve(int n, const double* phase, double a0, double a1,
                         const double* f, const double* bc, double tol,
                         int max_iter, double* u_out, double* final_res) {
  const int H = n + 1;
  const int N = H * H;
  const double h = 2.0 / n;

  Csr K;
  std::vector<double> mass_unused, load;
  assemble(n, phase, a0, a1, K, mass_unused, f, load);
  for (auto& v : load) v *= h * h;

  // Boundary mask and Dirichlet lift: solve K u = b with u = bc on the ring;
  // eliminate columns: b_I -= K_IB * bc_B, then solve on interior rows with
  // boundary rows pinned (identity).
  std::vector<uint8_t> is_bnd(N, 0);
  for (int j = 0; j < H; ++j) {
    is_bnd[j] = is_bnd[(H - 1) * H + j] = 1;
  }
  for (int i = 0; i < H; ++i) {
    is_bnd[i * H] = is_bnd[i * H + H - 1] = 1;
  }
  std::vector<double> u(N, 0.0), b(load);
  for (int i = 0; i < N; ++i)
    if (is_bnd[i]) u[i] = bc ? bc[i] : 0.0;
  // b_I -= K_IB u_B ; b_B = u_B
  {
    std::vector<double> ku(N, 0.0);
    spmv(K, u, ku);
    for (int i = 0; i < N; ++i) b[i] = is_bnd[i] ? u[i] : b[i] - ku[i];
  }
  // Pin boundary rows/cols: operator Pi(A) x = x_B on boundary, (K x)_I with
  // x_B zeroed on interior rows.
  auto apply = [&](const std::vector<double>& x, std::vector<double>& y) {
    static std::vector<double> xi;
    xi = x;
    for (int i = 0; i < N; ++i)
      if (is_bnd[i]) xi[i] = 0.0;
    spmv(K, xi, y);
    for (int i = 0; i < N; ++i)
      if (is_bnd[i]) y[i] = x[i];
  };

  // Jacobi-preconditioned CG.
  std::vector<double> diag(N, 1.0);
  for (int i = 0; i < N; ++i) {
    if (is_bnd[i]) continue;
    for (int k = K.rowptr[i]; k < K.rowptr[i + 1]; ++k)
      if (K.col[k] == i) diag[i] = K.val[k];
  }
  std::vector<double> r(N), z(N), p(N), ap(N);
  apply(u, ap);
  for (int i = 0; i < N; ++i) r[i] = b[i] - ap[i];
  for (int i = 0; i < N; ++i) z[i] = r[i] / diag[i];
  p = z;
  double rz = dot(r, z);
  int it = 0;
  double rnorm = std::sqrt(dot(r, r));
  for (; it < max_iter && rnorm > tol; ++it) {
    apply(p, ap);
    const double alpha = rz / dot(p, ap);
    for (int i = 0; i < N; ++i) u[i] += alpha * p[i];
    for (int i = 0; i < N; ++i) r[i] -= alpha * ap[i];
    rnorm = std::sqrt(dot(r, r));
    for (int i = 0; i < N; ++i) z[i] = r[i] / diag[i];
    const double rz_new = dot(r, z);
    const double beta = rz_new / rz;
    rz = rz_new;
    for (int i = 0; i < N; ++i) p[i] = z[i] + beta * p[i];
  }
  std::memcpy(u_out, u.data(), sizeof(double) * N);
  if (final_res) *final_res = rnorm;
  return rnorm <= tol ? it : -1;
}

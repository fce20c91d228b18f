// Fused V-cycle legs of the 2-DOF plane elasticity operator (damped 2x2
// block Jacobi), for Hopper.
//
// Five kernels, each the counterpart of one Pallas TPU kernel of
// multigrid_feanet_tpu/ops/pallas_elastic.py, on compact fields: a
// displacement field is (2, n+1, n+1) float32 with component 0 = x (the
// column displacement) and 1 = y (the row displacement) as planes, the
// element phase map n x n int8 (absent when homogeneous), a coarse field
// (2, n/2+1, n/2+1) float32.  "North" is row + 1.
//
// Operator (_apply_el, the element-factored form of
// ops/elasticity.py::apply_elastic_factored): with the coefficients Q_e =
// a0 + da * phase_e of the node's NE, NW, SE, SW elements (a0 off the
// domain), their sums C4, C4s, Qe, Qw, Qn, Qs and differences dE, dW, dN,
// dS, and the six element-stiffness scalars al, be, ga, ep, de, ze:
//     (A u)_x = al C4 ux + ga (Qe ux_E + Qw ux_W) + de (Qn ux_N + Qs ux_S)
//             + ze (diagonal Q ux) + be C4s uy - ep (dE uy_E + dW uy_W)
//             + ep (dN uy_N + dS uy_S) - be (signed diagonal Q uy)
// and (A u)_y the same with x and y swapped, ga and de swapped and the ep
// terms' sign flipped.  The 2x2 block diagonal is [[Dxx, Dxy], [Dxy, Dxx]]
// with Dxx = al C4, Dxy = be C4s; one damped block-Jacobi update is
//     u + (omega / det) (Dxx rx - Dxy ry, Dxx ry - Dxy rx),
//     det = Dxx^2 - Dxy^2,
// at interior nodes; boundary nodes keep their value.  The arithmetic
// follows the Pallas kernels' order of operations term by term.  Every mask
// is a select, never a product.
//
// Bound: bytes.  Per fine node G1 must move 25 B bi-material (24
// homogeneous), G2 and G3 27, G4 11 and G5 19 (see each kernel), against
// 118-225 operations (98 per operator apply of both components, 14 per
// block update), which the card does in 24-42% of the byte time.
//
// G1, G2, G4 and G5 above G1_ONE_PASS_MAX_N, G2_ONE_PASS_MAX_N,
// G4_ONE_PASS_MAX_N and G5_ONE_PASS_MAX_N (ops/elastic.py) stream rows
// (g1_el_relax_rows, g2_el_descent_rows, g4_el_zdescent_rows,
// g5_el_zascent_rows, below), G1, G2 and G5 on one sweep stage
// (el_sweep_row).  The one-pass design of G3, and of G1, G2, G4 and G5 at
// and below those sizes: one 256-thread block per OY x OX = 16 x 32 tile of
// fine nodes (common.cuh's Tile; the descent legs' coarse output is
// the CY x CX coarse tile above it), so every leg runs on coarse_grid(n).
// Each block stages its inputs over the tile plus a halo of h nodes in
// shared memory, both components and the element coefficients, once; each
// operator apply consumes one ring, so h is the leg's dependency depth (G1
// 1, G2 3, G3 1, G4 2, G5 1: the JAX cache invariants).  Every stage is
// computed on a ring one node smaller than the last, so blocks never depend
// on one another.  The prolonged correction is computed only at interior
// fine nodes, so no read falls past the coarse field.  G1's and G2's
// interior residual norm^2 of the incoming iterate (both components) is
// summed per block in a fixed order and then by the last block to finish
// (finish_sums), in both designs: no float atomics, so sums repeat run to
// run, and no second launch.

#include "common.cuh"

namespace {

// One elastic level: Coef's n, a0, da (Q = a0 + da * phase) and omega, plus
// the six element-stiffness scalars of elastic_factor_constants.
struct ElCoef : Coef {
  float al, be, ga, ep, de, ze;
};

inline ElCoef make_el_coef(int n, double a0, double da, double omega, double al, double be,
                           double ga, double ep, double de, double ze) {
  ElCoef k;
  static_cast<Coef&>(k) = make_coef(n, a0, da, omega);
  k.al = (float)al;
  k.be = (float)be;
  k.ga = (float)ga;
  k.ep = (float)ep;
  k.de = (float)de;
  k.ze = (float)ze;
  return k;
}

// The coefficients of the four elements around a node: NE at q[0] in an
// element tile of row stride sq (NW q[-1], SE q[-sq], SW q[-sq-1]), or a0
// each when homogeneous.
struct Corners {
  float ne, nw, se, sw;
};

template <bool BIM>
__device__ __forceinline__ Corners corners(const float* q, int sq, const ElCoef& k) {
  if (BIM) return {q[0], q[-1], q[-sq], q[-sq - 1]};
  return {k.a0, k.a0, k.a0, k.a0};
}

// Block diagonal entries Dxx = al C4, Dxy = be C4s.
__device__ __forceinline__ void block_diag(const Corners& c, const ElCoef& k, float& dxx,
                                           float& dxy) {
  dxx = k.al * ((c.ne + c.nw) + (c.se + c.sw));
  dxy = k.be * ((c.ne + c.sw) - (c.nw + c.se));
}

// One output component of A u at the node at U[0], V[0] (row stride s): U is
// the same component, V the other; sep = +ep for x and -ep for y; gew and
// gns the same-component east-west and north-south constants.
__device__ __forceinline__ float apply_comp(const float* U, const float* V, int s,
                                            const Corners& c, float C4, float C4s, float sep,
                                            float gew, float gns, const ElCoef& k) {
  const float Qe = c.ne + c.se, Qw = c.nw + c.sw;
  const float Qn = c.ne + c.nw, Qs = c.se + c.sw;
  const float dE = c.ne - c.se, dW = c.sw - c.nw;
  const float dN = c.ne - c.nw, dS = c.sw - c.se;
  float o = (k.al * C4) * U[0];
  o = o + gew * (Qe * U[1] + Qw * U[-1]);
  o = o + gns * (Qn * U[s] + Qs * U[-s]);
  o = o + k.ze * (((c.ne * U[s + 1] + c.nw * U[s - 1]) + c.se * U[-s + 1]) + c.sw * U[-s - 1]);
  o = o + (k.be * C4s) * V[0];
  o = o - sep * (dE * V[1] + dW * V[-1]);
  o = o + sep * (dN * V[s] + dS * V[-s]);
  o = o - k.be * (((c.ne * V[s + 1] - c.nw * V[s - 1]) - c.se * V[-s + 1]) + c.sw * V[-s - 1]);
  return o;
}

// A u and the block diagonal at the node at X[0], Y[0] (the two components
// of one tile, row stride s), its NE element coefficient at q[0] (row
// stride sq).
template <bool BIM>
__device__ __forceinline__ void apply_el(const float* X, const float* Y, int s, const float* q,
                                         int sq, const ElCoef& k, float& ax, float& ay,
                                         float& dxx, float& dxy) {
  const Corners c = corners<BIM>(q, sq, k);
  const float C4 = (c.ne + c.nw) + (c.se + c.sw);
  const float C4s = (c.ne + c.sw) - (c.nw + c.se);
  ax = apply_comp(X, Y, s, c, C4, C4s, k.ep, k.ga, k.de, k);
  ay = apply_comp(Y, X, s, c, C4, C4s, -k.ep, k.de, k.ga, k);
  dxx = k.al * C4;
  dxy = k.be * C4s;
}

// u += w D~ r with w = omega / det: the damped 2x2 block-Jacobi update
// (_block_update) after its division.
__device__ __forceinline__ void bj_apply(float& ux, float& uy, float rx, float ry, float dxx,
                                         float dxy, float w) {
  ux = ux + w * (dxx * rx - dxy * ry);
  uy = uy + w * (dxx * ry - dxy * rx);
}

// u += (omega / det) D~ r: the damped 2x2 block-Jacobi update (_block_update).
__device__ __forceinline__ void bj_update(float& ux, float& uy, float rx, float ry, float dxx,
                                          float dxy, float omega) {
  const float det = dxx * dxx - dxy * dxy;
  bj_apply(ux, uy, rx, ry, dxx, dxy, omega / det);
}

// The zero-guess iterate omega D^-1 f of an interior node.
template <bool BIM>
__device__ __forceinline__ void zero_guess(float fx, float fy, const float* q, int sq,
                                           const ElCoef& k, float& ux, float& uy) {
  float dxx, dxy;
  block_diag(corners<BIM>(q, sq, k), k, dxx, dxy);
  const float det = dxx * dxx - dxy * dxy;
  const float w = k.omega / det;
  ux = w * (dxx * fx - dxy * fy);
  uy = w * (dxx * fy - dxy * fx);
}

// Stages both components of the (2, H, H) field src over the tile (zero off
// the grid) into xs, ys.  With a coarse field uc, adds its bilinear
// prolongation at interior nodes.  When BIM, also stages the element
// coefficients of the tile into qs.
template <int h, bool BIM>
__device__ __forceinline__ void stage(float* xs, float* ys, const float* __restrict__ src,
                                      const float* __restrict__ uc, float* qs,
                                      const int8_t* __restrict__ ph, int oy, int ox,
                                      const ElCoef& k) {
  using T = Tile<h>;
  const int H = k.n + 1, Wc = k.n / 2 + 1;
  const size_t plane = (size_t)H * H, cplane = (size_t)Wc * Wc;
  for (int t = threadIdx.x; t < T::N; t += NT) {
    const int i = oy + t / T::S, j = ox + t % T::S;
    float vx = 0.f, vy = 0.f;
    if (i >= 0 && i < H && j >= 0 && j < H) {
      const size_t g = (size_t)i * H + j;
      vx = src[g];
      vy = src[plane + g];
    }
    if (uc != nullptr && interior(i, j, H)) {
      vx = vx + prolong(uc, Wc, i, j);
      vy = vy + prolong(uc + cplane, Wc, i, j);
    }
    xs[t] = vx;
    ys[t] = vy;
  }
  if (BIM) {
    for (int t = threadIdx.x; t < T::NQ; t += NT)
      qs[t] = elem_q(ph, k.n, oy - 1 + t / T::SQ, ox - 1 + t % T::SQ, k);
  }
}

// One block-Jacobi sweep (MODE 0) or the masked residual (MODE 1) of the
// iterate in xs, ys (valid on ring 1) at the block's output nodes, against
// f in device memory, into out.  Returns this thread's sum of the squared
// residual of the iterate.
template <int h, bool BIM, int MODE>
__device__ __forceinline__ float relax_tile(const float* xs, const float* ys, const float* qs,
                                            const float* __restrict__ f,
                                            float* __restrict__ out, int oy, int ox,
                                            const ElCoef& k) {
  using T = Tile<h>;
  const int H = k.n + 1;
  const size_t plane = (size_t)H * H;
  float rr = 0.f;
  for_ring<h>(0, [&](int ly, int lx) {
    const int i = oy + ly, j = ox + lx;
    if (i >= H || j >= H) return;
    const int p = ly * T::S + lx;
    const size_t g = (size_t)i * H + j;
    float vx = xs[p], vy = ys[p], rx = 0.f, ry = 0.f;
    if (interior(i, j, H)) {
      float ax, ay, dxx, dxy;
      apply_el<BIM>(xs + p, ys + p, T::S, qs + T::q(ly, lx), T::SQ, k, ax, ay, dxx, dxy);
      rx = f[g] - ax;
      ry = f[plane + g] - ay;
      rr += rx * rx + ry * ry;
      if (MODE == 0) bj_update(vx, vy, rx, ry, dxx, dxy, k.omega);
    }
    if (MODE == 1) {
      vx = rx;
      vy = ry;
    }
    out[g] = vx;
    out[plane + g] = vy;
  });
  return rr;
}

// r1 = f - A u1 at interior nodes (0 elsewhere) on ring 1, in place over
// the f tiles fxs, fys (each node reads only its own f), then f_c = 4 FW(r1)
// per component at the block's coarse tile, zero on the coarse boundary.
template <int h, bool BIM>
__device__ __forceinline__ void residual_restrict(const float* x1, const float* y1,
                                                  float* fxs, float* fys, const float* qs,
                                                  float* __restrict__ fc, int oy, int ox,
                                                  const ElCoef& k) {
  using T = Tile<h>;
  const int H = k.n + 1, Hc = k.n / 2 + 1;
  for_ring<h>(1, [&](int ly, int lx) {
    const int p = ly * T::S + lx;
    float rx = 0.f, ry = 0.f;
    if (interior(oy + ly, ox + lx, H)) {
      float ax, ay, dxx, dxy;
      apply_el<BIM>(x1 + p, y1 + p, T::S, qs + T::q(ly, lx), T::SQ, k, ax, ay, dxx, dxy);
      rx = fxs[p] - ax;
      ry = fys[p] - ay;
    }
    fxs[p] = rx;
    fys[p] = ry;
  });
  __syncthreads();
  if (threadIdx.x < CX * CY) {
    const int cy = threadIdx.x / CX, cx = threadIdx.x % CX;
    const int I = blockIdx.y * CY + cy, J = blockIdx.x * CX + cx;
    if (I < Hc && J < Hc) {
      const bool cin = I >= 1 && I <= Hc - 2 && J >= 1 && J <= Hc - 2;
      const int ly = 2 * cy + h, lx = 2 * cx + h;
      const size_t g = (size_t)I * Hc + J, cplane = (size_t)Hc * Hc;
      fc[g] = cin ? restrict4(fxs, T::S, ly, lx) : 0.f;
      fc[cplane + g] = cin ? restrict4(fys, T::S, ly, lx) : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// G1: one damped block-Jacobi sweep (MODE 0) or the masked residual (MODE 1),
// and the interior ||f - A u||^2 of the incoming iterate.
// Replaces multigrid_feanet_tpu/ops/pallas_elastic.py:91 _el_sweep_kernel.
// Bound: bytes, 25 B per node bi-material (u, f in, out: 24 B; phase 1 B),
// 24 homogeneous.
//
// One-pass tile, for levels of up to G1_ONE_PASS_MAX_N (ops/elastic.py):
// halo 1; the norm's partials are added by the last block to finish
// (finish_sums), so one launch.
// ---------------------------------------------------------------------------
template <bool BIM, int MODE>
__global__ void __launch_bounds__(NT)
g1_el_relax(const float* __restrict__ u, const float* __restrict__ f,
            const int8_t* __restrict__ ph, float* __restrict__ out, float* __restrict__ partial,
            unsigned* __restrict__ done, float* __restrict__ rsq, ElCoef k) {
  constexpr int h = 1;
  using T = Tile<h>;
  __shared__ float xs[T::N], ys[T::N];
  __shared__ float qs[BIM ? T::NQ : 1];
  const int oy = OY * blockIdx.y - h, ox = OX * blockIdx.x - h;

  stage<h, BIM>(xs, ys, u, nullptr, qs, ph, oy, ox, k);
  __syncthreads();
  float sums[1] = {relax_tile<h, BIM, MODE>(xs, ys, qs, f, out, oy, ox, k)};
  float* const outs[1] = {rsq};
  finish_sums<NT, 1>(sums, partial, done, outs);
}

// ---------------------------------------------------------------------------
// G2: elastic descent leg: u1 = BJ(u0), f_c = 4 FW(f - A u1) per component,
// and the interior ||f - A u0||^2 of the incoming iterate.
// Replaces multigrid_feanet_tpu/ops/pallas_elastic.py:391 _el_swrr_kernel.
// Bound: bytes, 27 B per fine node (u0, f in, u1 out: 24 B; phase 1 B; a
// quarter node of the two f_c planes out: 2 B).
//
// One-pass tile, for levels of up to G2_ONE_PASS_MAX_N (ops/elastic.py):
// halo 3 (u1 is needed on ring 2 for the residual that the restriction
// reads on ring 1); the norm's partials are added by the last block to
// finish (finish_sums), so one launch.
// ---------------------------------------------------------------------------
template <bool BIM>
__global__ void __launch_bounds__(NT)
g2_el_descent(const float* __restrict__ u, const float* __restrict__ f,
              const int8_t* __restrict__ ph, float* __restrict__ u1_out,
              float* __restrict__ fc, float* __restrict__ partial, unsigned* __restrict__ done,
              float* __restrict__ rsq, ElCoef k) {
  constexpr int h = 3;
  using T = Tile<h>;
  __shared__ float xs[T::N], ys[T::N], fxs[T::N], fys[T::N], x1[T::N], y1[T::N];
  __shared__ float qs[BIM ? T::NQ : 1];
  const int H = k.n + 1;
  const size_t plane = (size_t)H * H;
  const int oy = OY * blockIdx.y - h, ox = OX * blockIdx.x - h;

  stage<h, BIM>(xs, ys, u, nullptr, qs, ph, oy, ox, k);
  stage<h, false>(fxs, fys, f, nullptr, nullptr, nullptr, oy, ox, k);
  __syncthreads();
  // u1 on ring 2; the owned nodes are stored and their residuals summed
  float rr = 0.f;
  for_ring<h>(2, [&](int ly, int lx) {
    const int p = ly * T::S + lx, i = oy + ly, j = ox + lx;
    float vx = xs[p], vy = ys[p];
    if (interior(i, j, H)) {
      float ax, ay, dxx, dxy;
      apply_el<BIM>(xs + p, ys + p, T::S, qs + T::q(ly, lx), T::SQ, k, ax, ay, dxx, dxy);
      const float rx = fxs[p] - ax, ry = fys[p] - ay;
      if (owned(ly, lx, h)) rr += rx * rx + ry * ry;
      bj_update(vx, vy, rx, ry, dxx, dxy, k.omega);
    }
    x1[p] = vx;
    y1[p] = vy;
    if (owned(ly, lx, h) && i < H && j < H) {
      const size_t g = (size_t)i * H + j;
      u1_out[g] = vx;
      u1_out[plane + g] = vy;
    }
  });
  __syncthreads();
  residual_restrict<h, BIM>(x1, y1, fxs, fys, qs, fc, oy, ox, k);
  float sums[1] = {rr};
  float* const outs[1] = {rsq};
  finish_sums<NT, 1>(sums, partial, done, outs);
}

// ---------------------------------------------------------------------------
// G2 as a row-streaming chain, for levels above G2_ONE_PASS_MAX_N; the same
// contract as the tile above.
// Design: sweep.cu's A2 chain (u1 and r1 computed once per node, the coarse
// row's (1, 2, 1) sums finished a step later) with two components a row, in
// one barrier per step, on common.cuh's helpers (E2's chain without its
// conv wavefront).  A block owns fine columns [x0, x0 + BW), BW = RB - 4,
// and rows [y0, y0 + strip) (x0 and y0 even), so the coarse nodes
// [x0/2, (x0 + BW)/2) x [y0/2, (y0 + strip)/2); thread t works on columns
// c0 + e, e < RC, c0 = x0 - 2 + RC t: the block diagonal update and the
// residual each eat a column of halo on each side and the restriction's
// column sums one, so 2 columns on each side are computed beyond the band
// and the staged u0 window starts one further out.  Step s stages both
// components of u0 row R = y0 - 3 + s into a ring of RNS slots, and both
// components of f and the phase row R - 1 into a ring of G2_NF slots (the
// residual reads them 2 rows later; 6 slots hold the stages s - 3 .. s +
// RD), RD steps ahead (stage_plane: the y planes need not start on a
// 16-byte boundary); then, from the bottom of the chain up, a thread
//   1. finishes the coarse row whose column sums completed at step s - 1
//      (common.cuh restrict_finish, per component);
//   2. computes r1 = f - A u1 at row rho = R - 3 from its window of u1 rows
//      rho - 1 .. rho + 1 (row rho + 1 from the shared u1 row of step s - 1)
//      and adds it to its columns' (1, 2, 1) row sums (restrict_rows);
//   3. computes u1 = BJ(u0) at row i = R - 1 from its u0 window of rows
//      i - 1 .. i + 1, stores it at the owned nodes, passes it on through a
//      shared u1 row and sums the owned (f - A u0)^2.
// Each stage reads rows that the stage before finished at an earlier step,
// so one barrier per step orders them, and neither u1's halo nor r1 goes to
// device memory.  Per node the block computes RB / BW of the owned work
// (1.6%) plus the strip's 6 halo steps.  The rings, the u1 row and the
// restriction's row parity turn whole every G2_UNR steps (the main loop's
// unroll), so every slot is a constant; the element rows the residual reads
// (rho - 1, rho) are those the sweep read two steps before, kept in a
// 4-row register ring.  apply_el and _block_update run as the tile runs
// them, term by term, on 3 x 3 register windows, the division omega / det
// by div_normal (the quotient `/` gives, without its slow-path branch);
// every mask is a select (el_sweep_row, which G1 and G5 share).  The norm is
// summed over the owned nodes in a fixed order and the last block to finish
// adds the blocks' partials (finish_sums).
// ---------------------------------------------------------------------------
constexpr int G2_UNR = 6;  // steps per trip of the main loop
constexpr int G2_NF = 6;   // f / phase ring slots: the stages s - 3 .. s + RD
static_assert(G2_UNR % RNS == 0 && G2_UNR % G2_NF == 0 && G2_UNR % 2 == 0,
              "G2_UNR: whole ring turns");
static_assert(G2_NF >= RD + 4, "G2_NF: the f / phase ring");
// resident blocks per SM asked for: caps the registers at 128
constexpr int G2_MINB = 4;

// A u of both components and the block diagonal at the centre of the 3 x 3
// register windows xw, yw (rows i - 1 .. i + 1, columns e .. e + 2) with the
// element coefficients qs (row i - 1) and qn (row i) at columns e, e + 1.
template <bool BIM, int N>
__device__ __forceinline__ void apply_el_window(const float (&xw)[3][N], const float (&yw)[3][N],
                                                int e, const float* qs, const float* qn,
                                                const ElCoef& k, float& ax, float& ay,
                                                float& dxx, float& dxy) {
  const float X[9] = {xw[0][e], xw[0][e + 1], xw[0][e + 2], xw[1][e], xw[1][e + 1],
                      xw[1][e + 2], xw[2][e], xw[2][e + 1], xw[2][e + 2]};
  const float Y[9] = {yw[0][e], yw[0][e + 1], yw[0][e + 2], yw[1][e], yw[1][e + 1],
                      yw[1][e + 2], yw[2][e], yw[2][e + 1], yw[2][e + 2]};
  const float q[4] = {qs[e], qs[e + 1], qn[e], qn[e + 1]};
  apply_el<BIM>(X + 4, Y + 4, 3, q + 3, 2, k, ax, ay, dxx, dxy);
}

// The sweep stage of the row-streaming G1, G2 and G5: at node row i
// (interior when i_in) and a thread's RC columns, from its 3 x (RC + 2)
// windows xw, yw of both components (rows i - 1 .. i + 1, columns from one
// left of its first), the element rows qs (i - 1) and qn (i) at its
// columns' elements (col_in: which of the window's columns are interior)
// and f of row i: r = f - A u at the interior nodes (0 elsewhere, every
// mask a select) and u's damped block-Jacobi update there (u elsewhere),
// apply_el and _block_update term by term, omega / det by div_normal (the
// quotient `/` gives, without its slow-path branch).  Adds the owned nodes'
// (i_own and own[e]) r^2 of both components to rr.
template <bool BIM>
__device__ __forceinline__ void el_sweep_row(const float (&xw)[3][RC + 2],
                                             const float (&yw)[3][RC + 2], const float* qs,
                                             const float* qn, const float (&fx)[RC],
                                             const float (&fy)[RC], bool i_in,
                                             const bool (&col_in)[RC + 2], bool i_own,
                                             const bool (&own)[RC], const ElCoef& k,
                                             float (&ux)[RC], float (&uy)[RC], float (&rx)[RC],
                                             float (&ry)[RC], float& rr) {
#pragma unroll
  for (int e = 0; e < RC; ++e) {
    float ax, ay, dxx, dxy;
    apply_el_window<BIM>(xw, yw, e, qs, qn, k, ax, ay, dxx, dxy);
    const bool in = i_in && col_in[e + 1];
    rx[e] = in ? fx[e] - ax : 0.f;
    ry[e] = in ? fy[e] - ay : 0.f;
    float vxe = xw[1][e + 1], vye = yw[1][e + 1];
    bj_apply(vxe, vye, rx[e], ry[e], dxx, dxy, div_normal(k.omega, dxx * dxx - dxy * dxy));
    ux[e] = in ? vxe : xw[1][e + 1];
    uy[e] = in ? vye : yw[1][e + 1];
    rr += i_own && own[e] ? rx[e] * rx[e] + ry[e] * ry[e] : 0.f;
  }
}

template <bool BIM>
__global__ void __launch_bounds__(RT, G2_MINB)
g2_el_descent_rows(const float* __restrict__ u, const float* __restrict__ f,
                   const int8_t* __restrict__ ph, float* __restrict__ u1_out,
                   float* __restrict__ fc, float* __restrict__ partial,
                   unsigned* __restrict__ done, float* __restrict__ rsq, int strip, ElCoef k) {
  constexpr int BW = RB - 4;  // owned columns of a band
  constexpr int NF = G2_NF;
  constexpr int XS = RB + 4;  // u1 rows: column p at entry p + 2
  __shared__ __align__(16) float us[2][RNS][RSLOT];  // u0 rows: component, slot
  __shared__ __align__(16) float fs[2][NF][RSLOT];   // f rows: component, slot
  __shared__ __align__(16) int8_t qs[BIM ? NF : 1][RSLOTQ];
  __shared__ __align__(16) float u1r[2][2][XS];  // u1: component, the row of step s in s mod 2
  __shared__ __align__(16) float wrow[2][2][RB];  // (1, 2, 1) sums completed at step s
  const int n = k.n, H = n + 1, Hc = n / 2 + 1, t = threadIdx.x;
  const size_t plane = (size_t)H * H, cplane = (size_t)Hc * Hc;
  const int x0 = blockIdx.x * BW, y0 = blockIdx.y * strip;
  const int c0 = x0 - 2 + RC * t, col = x0 - 3, base = y0 - 3;
  const int rows_out = min(strip, H + 1 - y0);  // fine rows this strip restricts
  const int staged = rows_out + 5, steps = rows_out + 6;

  for (int e = t; e < 2 * 2 * XS; e += RT) (&u1r[0][0][0])[e] = 0.f;
  const unsigned ud = smem_addr(us), fd = smem_addr(fs), qd = smem_addr(qs);
  // stages step s (J = s mod G2_UNR): both components of u row base + s into
  // u slot J mod RNS, of f and the phase row base + s - 1 into f / phase
  // slot J mod NF; always commits
  auto stage = [&](int s, auto S) {
    constexpr int SJ = decltype(S)::value;
    const bool live = s < staged;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      stage_plane<4, RW>(ud + 4 * RSLOT * (c * RNS + SJ % RNS), u, c, base + s, H, H, col, live);
      stage_plane<4, RW>(fd + 4 * RSLOT * (c * NF + SJ % NF), f, c, base + s - 1, H, H, col,
                         live);
    }
    if (BIM) stage_window<1, RWQ>(qd + RSLOTQ * (SJ % NF), ph, base + s - 1, n, n, col, live);
    cp_commit();
  };
  static_for<RD>([&](auto S) { stage(decltype(S)::value, S); });

  // columns c0 - 1 .. c0 + RC interior; columns c0 .. c0 + RC - 1 owned by
  // the block, and the coarse column centred on each (-1: none)
  bool col_in[RC + 2], col_own[RC];
  int J[RC];
#pragma unroll
  for (int e = 0; e < RC + 2; ++e) col_in[e] = c0 - 1 + e >= 1 && c0 - 1 + e <= H - 2;
#pragma unroll
  for (int e = 0; e < RC; ++e) {
    const int c = c0 + e, p = RC * t + e;
    col_own[e] = p >= 2 && p < 2 + BW && c < H;
    J[e] = (c & 1) || !col_own[e] ? -1 : c / 2;
  }

  float xw[3][RC + 2] = {}, yw[3][RC + 2] = {};  // u0 rows i - 1 .. i + 1
  float qe[4][RC + 1] = {};  // element rows i - 4 .. i - 1 (rolled to i - 3 .. i at step s)
  float vx[3][RC + 2] = {}, vy[3][RC + 2] = {};  // u1 rows rho - 1 .. rho + 1
  float u1x[RC] = {}, u1y[RC] = {};              // u1's own columns of the last step
  float accx[RC] = {}, accy[RC] = {};            // (1, 2, 1) sums of the coarse row in progress
  float rr = 0.f;
  bool pending = false;  // a coarse row completed at the previous step
  // step s (u slot s mod RNS, f / phase slot s mod NF, u1 and wrow slot
  // s mod 2)
  auto step = [&](int s, auto S) {
    constexpr int I = decltype(S)::value;
    constexpr int slot = I % RNS, xb = I % 2, xp = (I + 1) % 2;
    // f / phase slots of rows i and rho (staged 2 steps earlier)
    constexpr int fnow = I % NF, frho = (I + NF - 2) % NF;
    constexpr bool odd = (I & 1) != 0;  // rho = y0 - 6 + s (y0 and G2_UNR even)
    if (s >= steps) return;
    cp_wait<RD - 1>();
    __syncthreads();
    const int R = base + s, i = R - 1, rho = i - 2;

    if (pending) {  // 1. coarse row (rho - 2) / 2 from the sums of step s - 1
      restrict_finish(fc, (rho - 2) >> 1, Hc, wrow[0][xp] + RC * t, J);
      restrict_finish(fc + cplane, (rho - 2) >> 1, Hc, wrow[1][xp] + RC * t, J);
    }
    pending = odd && s >= 6;  // completes coarse row (rho - 1) / 2 (rho > y0)

    {  // 2. r1 at row rho from u1 rows rho - 1 .. rho + 1 (zero off the interior)
      float nx[RC + 2], ny[RC + 2];
      nx[0] = u1r[0][xp][RC * t + 1];
      nx[RC + 1] = u1r[0][xp][RC * t + RC + 2];
      ny[0] = u1r[1][xp][RC * t + 1];
      ny[RC + 1] = u1r[1][xp][RC * t + RC + 2];
#pragma unroll
      for (int e = 0; e < RC; ++e) {
        nx[e + 1] = u1x[e];
        ny[e + 1] = u1y[e];
      }
      roll<RC + 2>(vx, nx);
      roll<RC + 2>(vy, ny);
      float fx[RC], fy[RC], rx[RC], ry[RC];
      read_row<RC>(fx, fs[0][frho], rho, H, col, RC * t + 1);
      read_row<RC>(fy, fs[1][frho], H + rho, H, col, RC * t + 1);
      const bool r_in = rho >= 1 && rho <= H - 2;
#pragma unroll
      for (int e = 0; e < RC; ++e) {
        float ax, ay, dxx, dxy;  // element rows rho - 1 = i - 3, rho
        apply_el_window<BIM>(vx, vy, e, qe[1], qe[2], k, ax, ay, dxx, dxy);
        const bool in = r_in && col_in[e + 1];
        rx[e] = in ? fx[e] - ax : 0.f;
        ry[e] = in ? fy[e] - ay : 0.f;
      }
      restrict_rows<odd>(accx, rx, wrow[0][xb] + RC * t, pending);
      restrict_rows<odd>(accy, ry, wrow[1][xb] + RC * t, pending);
    }

    {  // 3. u1 = BJ(u0) at row i from u0 rows i - 1 .. i + 1
      float nx[RC + 2], ny[RC + 2];
      read_row<RC + 2>(nx, us[0][slot], R, H, col, RC * t);
      read_row<RC + 2>(ny, us[1][slot], H + R, H, col, RC * t);
      roll<RC + 2>(xw, nx);
      roll<RC + 2>(yw, ny);
      if constexpr (BIM) {  // the element rows roll to i - 3 .. i
        const int8_t* pq = qs[fnow] + win_off<int8_t>(i, n, col) + RC * t;
#pragma unroll
        for (int e = 0; e <= RC; ++e) {
          qe[0][e] = qe[1][e];
          qe[1][e] = qe[2][e];
          qe[2][e] = qe[3][e];
          qe[3][e] = (float)pq[e] * k.da + k.a0;
        }
      }
      float fx[RC], fy[RC], rx[RC], ry[RC];
      read_row<RC>(fx, fs[0][fnow], i, H, col, RC * t + 1);
      read_row<RC>(fy, fs[1][fnow], H + i, H, col, RC * t + 1);
      const bool i_in = i >= 1 && i <= H - 2, i_own = i >= y0 && i < y0 + strip && i < H;
      el_sweep_row<BIM>(xw, yw, qe[2], qe[3], fx, fy, i_in, col_in, i_own, col_own, k, u1x, u1y,
                        rx, ry, rr);
      *reinterpret_cast<float2*>(&u1r[0][xb][RC * t + 2]) = make_float2(u1x[0], u1x[1]);
      *reinterpret_cast<float2*>(&u1r[1][xb][RC * t + 2]) = make_float2(u1y[0], u1y[1]);
      if (i_own) {
        float* orow = u1_out + (size_t)i * H + c0;
#pragma unroll
        for (int e = 0; e < RC; ++e) {
          if (col_own[e]) {
            orow[e] = u1x[e];
            orow[plane + e] = u1y[e];
          }
        }
      }
    }
    // step s + RD reuses the u slot of step s - 1 and the f / phase slot of
    // step s - 4, whose last readers ran at step s - 1
    stage(s + RD, std::integral_constant<int, (I + RD) % G2_UNR>{});
  };
  for (int s0 = 0; s0 < steps; s0 += G2_UNR)
    static_for<G2_UNR>([&](auto S) { step(s0 + decltype(S)::value, S); });
  __syncthreads();
  if (pending) {  // the strip's last coarse row, completed at its last step
    const int Ic = (base + steps - 5) >> 1, xl = (steps - 1) & 1;
    restrict_finish(fc, Ic, Hc, wrow[0][xl] + RC * t, J);
    restrict_finish(fc + cplane, Ic, Hc, wrow[1][xl] + RC * t, J);
  }
  float sums[1] = {rr};
  float* const outs[1] = {rsq};
  finish_sums<RT, 1>(sums, partial, done, outs);
}

// ---------------------------------------------------------------------------
// G1 as a row-streaming kernel, for levels above G1_ONE_PASS_MAX_N; the same
// contract as the tile above.
// Design: C1's and H1's single-sweep row streaming (common.cuh) with two
// components a row.  A block of RT threads of RC adjacent columns owns a
// band of RB columns [x0, x0 + RB) and marches down a strip of rows [y0,
// y0 + strip); step s stages both components of u row R = y0 - 1 + s and of
// f, and the phase row, R - 1 into rings of RNS slots with cp.async, RD
// steps ahead (stage_plane: the y planes need not start on a 16-byte
// boundary).  A thread rolls the u row into its 3 x (RC + 2) windows of both
// components and the element row R - 1 into a 2-row register ring, and from
// step 2 on computes row i = R - 1 with G2's sweep stage (el_sweep_row),
// writing u's block-Jacobi update (MODE 0) or the masked residual (MODE 1).
// Each staged value is read from shared memory once and the y-halo is paid
// once per strip (2 steps, g1_halo_steps).  The norm is summed over the
// owned nodes in a fixed order and the last block to finish adds the
// blocks' partials (finish_sums), as the tile's do: one launch.
// ---------------------------------------------------------------------------
constexpr int G1_UNR = 6;  // steps per trip of the main loop: whole turns of the slots
static_assert(G1_UNR % RNS == 0, "G1_UNR: whole ring turns");
// resident blocks per SM asked for: caps the registers at 102
constexpr int G1_MINB = 5;

template <bool BIM, int MODE>
__global__ void __launch_bounds__(RT, G1_MINB)
g1_el_relax_rows(const float* __restrict__ u, const float* __restrict__ f,
                 const int8_t* __restrict__ ph, float* __restrict__ out,
                 float* __restrict__ partial, unsigned* __restrict__ done,
                 float* __restrict__ rsq, int strip, ElCoef k) {
  __shared__ __align__(16) float us[2][RNS][RSLOT];  // u rows: component, slot
  __shared__ __align__(16) float fs[2][RNS][RSLOT];  // f rows: component, slot
  __shared__ __align__(16) int8_t qs[BIM ? RNS : 1][RSLOTQ];
  const int n = k.n, H = n + 1, t = threadIdx.x;
  const size_t plane = (size_t)H * H;
  const int x0 = blockIdx.x * RB, y0 = blockIdx.y * strip, c0 = x0 + RC * t;
  const int col = x0 - 1, base = y0 - 1;
  const int steps = min(strip, H - y0) + 2;
  const unsigned ud = smem_addr(us), fd = smem_addr(fs), qd = smem_addr(qs);
  // stages step s into ring slot `slot`: both components of u row base + s,
  // of f and the phase row base + s - 1; always commits
  auto stage = [&](int s, int slot) {
    const bool live = s < steps;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      stage_plane<4, RW>(ud + 4 * RSLOT * (c * RNS + slot), u, c, base + s, H, H, col, live);
      stage_plane<4, RW>(fd + 4 * RSLOT * (c * RNS + slot), f, c, base + s - 1, H, H, col,
                         live);
    }
    if (BIM) stage_window<1, RWQ>(qd + RSLOTQ * slot, ph, base + s - 1, n, n, col, live);
    cp_commit();
  };
  for (int s = 0; s < RD; ++s) stage(s, s);

  // columns c0 - 1 .. c0 + RC interior; columns c0 .. c0 + RC - 1 inside
  // the grid (every node a block computes there is its own)
  bool col_in[RC + 2], col_out[RC];
#pragma unroll
  for (int e = 0; e < RC + 2; ++e) col_in[e] = c0 - 1 + e >= 1 && c0 - 1 + e <= H - 2;
#pragma unroll
  for (int e = 0; e < RC; ++e) col_out[e] = c0 + e < H;
  float xw[3][RC + 2] = {}, yw[3][RC + 2] = {};  // u rows i - 1 .. i + 1
  float qa[RC + 1] = {}, qb[RC + 1] = {};        // element rows i - 1, i
  float rr = 0.f;
  // step s (ring slot s mod RNS)
  auto step = [&](int s, auto S) {
    constexpr int slot = decltype(S)::value % RNS;
    if (s >= steps) return;
    cp_wait<RD - 1>();
    __syncthreads();
    const int R = base + s, i = R - 1;
    float nx[RC + 2], ny[RC + 2];
    read_row<RC + 2>(nx, us[0][slot], R, H, col, RC * t);
    read_row<RC + 2>(ny, us[1][slot], H + R, H, col, RC * t);
    roll<RC + 2>(xw, nx);
    roll<RC + 2>(yw, ny);
    if constexpr (BIM) {  // the element rows roll to i - 1, i
      const int8_t* pq = qs[slot] + win_off<int8_t>(i, n, col) + RC * t;
#pragma unroll
      for (int e = 0; e <= RC; ++e) {
        qa[e] = qb[e];
        qb[e] = (float)pq[e] * k.da + k.a0;
      }
    }
    if (s >= 2) {
      float fx[RC], fy[RC], vx[RC], vy[RC], rx[RC], ry[RC];
      read_row<RC>(fx, fs[0][slot], i, H, col, RC * t + 1);
      read_row<RC>(fy, fs[1][slot], H + i, H, col, RC * t + 1);
      el_sweep_row<BIM>(xw, yw, qa, qb, fx, fy, i >= 1 && i <= H - 2, col_in, true, col_out, k,
                        vx, vy, rx, ry, rr);
      float* orow = out + (size_t)i * H + c0;
#pragma unroll
      for (int e = 0; e < RC; ++e) {
        if (col_out[e]) {
          orow[e] = MODE == 1 ? rx[e] : vx[e];
          orow[plane + e] = MODE == 1 ? ry[e] : vy[e];
        }
      }
    }
    // step s + RD reuses the slot of step s - 1
    stage(s + RD, (slot + RD) % RNS);
  };
  for (int s0 = 0; s0 < steps; s0 += G1_UNR)
    static_for<G1_UNR>([&](auto S) { step(s0 + decltype(S)::value, S); });
  float sums[1] = {rr};
  float* const outs[1] = {rsq};
  finish_sums<RT, 1>(sums, partial, done, outs);
}

// ---------------------------------------------------------------------------
// G3: elastic ascent leg: u3 = BJ(u1 + P(uc)), the prolonged correction of
// both components added at interior nodes while staging.
// Replaces multigrid_feanet_tpu/ops/pallas_elastic.py:457 _el_psweep_kernel.
// Bound: bytes, 27 B per fine node (u1, f in, u3 out: 24 B; phase 1 B; a
// quarter node of the two uc planes in: 2 B).  Halo 1.
// ---------------------------------------------------------------------------
template <bool BIM>
__global__ void __launch_bounds__(NT)
g3_el_ascent(const float* __restrict__ u1, const float* __restrict__ f,
             const int8_t* __restrict__ ph, const float* __restrict__ uc,
             float* __restrict__ out, ElCoef k) {
  constexpr int h = 1;
  using T = Tile<h>;
  __shared__ float xs[T::N], ys[T::N];
  __shared__ float qs[BIM ? T::NQ : 1];
  const int oy = OY * blockIdx.y - h, ox = OX * blockIdx.x - h;

  stage<h, BIM>(xs, ys, u1, uc, qs, ph, oy, ox, k);
  __syncthreads();
  relax_tile<h, BIM, 0>(xs, ys, qs, f, out, oy, ox, k);
}

// ---------------------------------------------------------------------------
// G4: zero-guess elastic descent leg: f_c = 4 FW(f - A u1) with
// u1 = omega D^-1 f at interior nodes, computed in shared memory and never
// stored.
// Replaces multigrid_feanet_tpu/ops/pallas_elastic.py:504 _el_zrr_kernel.
// Bound: bytes, 11 B per fine node (f in: 8 B; phase 1 B; a quarter node of
// the two f_c planes out: 2 B).  Halo 2: u1 on ring 2, r1 on ring 1.
// ---------------------------------------------------------------------------
template <bool BIM>
__global__ void __launch_bounds__(NT)
g4_el_zdescent(const float* __restrict__ f, const int8_t* __restrict__ ph,
               float* __restrict__ fc, ElCoef k) {
  constexpr int h = 2;
  using T = Tile<h>;
  __shared__ float fxs[T::N], fys[T::N], x1[T::N], y1[T::N];
  __shared__ float qs[BIM ? T::NQ : 1];
  const int H = k.n + 1;
  const int oy = OY * blockIdx.y - h, ox = OX * blockIdx.x - h;

  stage<h, BIM>(fxs, fys, f, nullptr, qs, ph, oy, ox, k);
  __syncthreads();
  for_ring<h>(2, [&](int ly, int lx) {
    const int p = ly * T::S + lx;
    float vx = 0.f, vy = 0.f;
    if (interior(oy + ly, ox + lx, H))
      zero_guess<BIM>(fxs[p], fys[p], qs + T::q(ly, lx), T::SQ, k, vx, vy);
    x1[p] = vx;
    y1[p] = vy;
  });
  __syncthreads();
  residual_restrict<h, BIM>(x1, y1, fxs, fys, qs, fc, oy, ox, k);
}

// The zero-guess iterate omega D^-1 f at the node of column e of a thread's
// register rows of element coefficients qs (south) and qn (north), as
// zero_guess computes it, omega / det by div_normal.
template <bool BIM>
__device__ __forceinline__ void zero_guess_window(float fx, float fy, const float* qs,
                                                  const float* qn, int e, const ElCoef& k,
                                                  float& ux, float& uy) {
  const float q[4] = {qs[e], qs[e + 1], qn[e], qn[e + 1]};
  float dxx, dxy;
  block_diag(corners<BIM>(q + 3, 2, k), k, dxx, dxy);
  const float w = div_normal(k.omega, dxx * dxx - dxy * dxy);
  ux = w * (dxx * fx - dxy * fy);
  uy = w * (dxx * fy - dxy * fx);
}

// apply_el_window on windows whose rows are held apart: xs, xm, xn (ys, ym,
// yn) the rows i - 1, i, i + 1 of both components, read at columns e .. e +
// 2, so that register rings indexed by the step need no moves.
template <bool BIM>
__device__ __forceinline__ void apply_el_rows(const float* xs, const float* xm, const float* xn,
                                              const float* ys, const float* ym, const float* yn,
                                              int e, const float* qs, const float* qn,
                                              const ElCoef& k, float& ax, float& ay, float& dxx,
                                              float& dxy) {
  const float X[9] = {xs[e], xs[e + 1], xs[e + 2], xm[e], xm[e + 1],
                      xm[e + 2], xn[e], xn[e + 1], xn[e + 2]};
  const float Y[9] = {ys[e], ys[e + 1], ys[e + 2], ym[e], ym[e + 1],
                      ym[e + 2], yn[e], yn[e + 1], yn[e + 2]};
  const float q[4] = {qs[e], qs[e + 1], qn[e], qn[e + 1]};
  apply_el<BIM>(X + 4, Y + 4, 3, q + 3, 2, k, ax, ay, dxx, dxy);
}

// ---------------------------------------------------------------------------
// G4 as a row-streaming chain, for levels above G4_ONE_PASS_MAX_N; the same
// contract as the tile above.
// Design: G2's chain (u1, then r1, the coarse row's (1, 2, 1) sums finished
// a step later) with A3's zero guess as its first stage: no u is staged, and
// u1 = omega D^-1 f is pointwise.  So each thread builds u1 at its own
// columns and at one beside them on each side from the f and element rows
// it reads (two zero guesses of the four are also its neighbours'), and no
// row passes between threads but the restriction's sums.  The tile's cost
// was latency: three stages over a 20 x 36 node tile behind barriers, the
// last run by half the block, for 11 B of traffic per node.  A block owns
// fine columns [x0, x0 + BW), BW = RB - 2, and rows [y0, y0 + strip) (x0 and
// y0 even), so the coarse nodes [x0/2, (x0 + BW)/2) x [y0/2, (y0 + strip)/2);
// thread t works on columns c0 + e, e < RC, c0 = x0 - 1 + RC t (odd): r1 on
// them, u1 from one column left of c0 to one right of its last, so the
// band's u1 reaches 2 columns past it on each side (G4's halo of 2).  Step s
// stages both components of f and the element row R = y0 - 3 + s into rings
// of RNS slots, RD steps ahead (stage_plane: the y plane need not start on a
// 16-byte boundary; the element window starts one column left of f's); then
// a thread
//   1. finishes the coarse row whose column sums completed at step s - 1
//      (common.cuh restrict_finish, per component);
//   2. reads the element row R and f of row R into register rings, builds
//      u1 at row R (zero_guess's arithmetic, omega / det by div_normal; 0
//      off the interior) into its ring of u1 rows R - 2 .. R (from step 1:
//      row y0 - 3 brings only its elements);
//   3. computes r1 = f - A u1 at row rho = R - 1 from those rows, the
//      element rows rho - 1, rho and f of row rho (its own columns, read at
//      step s - 1), and adds it to its columns' (1, 2, 1) row sums
//      (restrict_rows; from step 3, rho = y0 - 1, the first row the
//      restriction reads).
// One barrier per step orders the staged rows and the sums; neither u1 nor
// r1 goes to device memory.  A strip takes 4 steps beyond the fine rows it
// restricts (g4_halo_steps): the element row under its first u1 row, the u1
// rows of its halo (2 above, 1 below) and none for r1, which follows u1 in
// the same step; the first steps skip what no output reads, and a warp
// whose columns all lie past the grid computes nothing.  The register
// rings, the staging rings and the restriction's row parity turn whole every
// G4_UNR steps (the main loop's unroll), so every slot is a constant and no
// row is moved between registers.
// apply_el runs as the tile runs it, term by term, on 3 x 3 register windows,
// and the restriction's sums in restrict4's order (rows first, then
// columns); every mask is a select.  No norm: G4 has none.
// ---------------------------------------------------------------------------
constexpr int G4_UNR = 6;  // steps per trip of the main loop
static_assert(G4_UNR % RNS == 0 && G4_UNR % 3 == 0 && G4_UNR % 2 == 0,
              "G4_UNR: whole ring turns");
// resident blocks per SM asked for: caps the registers at 102
constexpr int G4_MINB = 5;
// the staged element window: columns x0 - 3 .. x0 + RB - 1 (a thread's zero
// guesses read elements c0 - 2 .. c0 + RC)
constexpr int G4_RWQ = RB + 3;
constexpr int G4_SLOTQ = (G4_RWQ + 15 + 15) / 16 * 16;  // bytes per element slot

template <bool BIM>
__global__ void __launch_bounds__(RT, G4_MINB)
g4_el_zdescent_rows(const float* __restrict__ f, const int8_t* __restrict__ ph,
                    float* __restrict__ fc, int strip, ElCoef k) {
  constexpr int BW = RB - 2;  // owned columns of a band
  __shared__ __align__(16) float fs[2][RNS][RSLOT];  // f rows: component, slot
  __shared__ __align__(16) int8_t qs[BIM ? RNS : 1][G4_SLOTQ];
  __shared__ __align__(16) float wrow[2][2][RB];  // (1, 2, 1) sums completed at step s
  const int n = k.n, H = n + 1, Hc = n / 2 + 1, t = threadIdx.x;
  const size_t cplane = (size_t)Hc * Hc;
  const int x0 = blockIdx.x * BW, y0 = blockIdx.y * strip;
  const int c0 = x0 - 1 + RC * t, col = x0 - 2, qcol = x0 - 3, base = y0 - 3;
  const int rows_out = min(strip, H + 1 - y0);  // fine rows this strip restricts
  const int steps = rows_out + 4;

  const unsigned fd = smem_addr(fs), qd = smem_addr(qs);
  // stages step s into ring slot `slot`: both components of f and the
  // element row base + s; always commits
  auto stage = [&](int s, int slot) {
    const bool live = s < steps;
#pragma unroll
    for (int c = 0; c < 2; ++c)
      stage_plane<4, RW>(fd + 4 * RSLOT * (c * RNS + slot), f, c, base + s, H, H, col, live);
    if (BIM) stage_window<1, G4_RWQ>(qd + G4_SLOTQ * slot, ph, base + s, n, n, qcol, live);
    cp_commit();
  };
  for (int s = 0; s < RD; ++s) stage(s, s);

  // columns c0 - 1 .. c0 + RC interior; columns c0 .. c0 + RC - 1 owned by
  // the block, and the coarse column centred on each (-1: none)
  bool col_in[RC + 2], col_own[RC];
  int J[RC];
#pragma unroll
  for (int e = 0; e < RC + 2; ++e) col_in[e] = c0 - 1 + e >= 1 && c0 - 1 + e <= H - 2;
#pragma unroll
  for (int e = 0; e < RC; ++e) {
    const int c = c0 + e, p = RC * t + e;
    col_own[e] = p >= 1 && p < 1 + BW && c < H;
    J[e] = (c & 1) || !col_own[e] ? -1 : c / 2;
  }

  // rings of the rows of the last steps, slot s mod 3 (s mod 2: f) holding
  // row R of step s
  float qe[3][RC + 3] = {};  // element coefficients, columns c0 - 2 .. c0 + RC
  float vx[3][RC + 2] = {}, vy[3][RC + 2] = {};  // u1, columns c0 - 1 .. c0 + RC
  float fox[2][RC] = {}, foy[2][RC] = {};        // f at the own columns
  float accx[RC] = {}, accy[RC] = {};            // (1, 2, 1) sums of the coarse row in progress
  // the warp computes only where its residual columns reach into the grid (a
  // level's last band is ragged: at 1025^2 three of its four warps lie past
  // the grid, and no other warp reads what they would compute)
  const bool busy = x0 - 1 + RC * (t & ~31) < H;
  bool pending = false;  // a coarse row completed at the previous step
  // step s (ring slot s mod RNS, wrow slot s mod 2)
  auto step = [&](int s, auto S) {
    constexpr int I = decltype(S)::value;
    constexpr int slot = I % RNS, xb = I % 2, xp = (I + 1) % 2;
    constexpr int r0 = I % 3, r1 = (I + 2) % 3, r2 = (I + 1) % 3;  // rows R, R - 1, R - 2
    constexpr bool odd = (I & 1) != 0;  // rho = y0 - 4 + s (y0 and G4_UNR even)
    if (s >= steps) return;
    cp_wait<RD - 1>();
    __syncthreads();
    const int R = base + s, rho = R - 1;

    if (pending) {  // 1. coarse row (rho - 2) / 2 from the sums of step s - 1
      restrict_finish(fc, (rho - 2) >> 1, Hc, wrow[0][xp] + RC * t, J);
      restrict_finish(fc + cplane, (rho - 2) >> 1, Hc, wrow[1][xp] + RC * t, J);
    }
    pending = odd && s >= 5;  // completes coarse row (rho - 1) / 2 (rho > y0)

    // 2. the element row R, f of row R and u1 = omega D^-1 f at row R,
    // columns c0 - 1 .. c0 + RC: the first u1 row a residual reads is
    // R = y0 - 2 (step 1)
    if constexpr (BIM) {
      const int8_t* pq = qs[slot] + win_off<int8_t>(R, n, qcol) + RC * t;
#pragma unroll
      for (int e = 0; e < RC + 3; ++e) qe[r0][e] = (float)pq[e] * k.da + k.a0;
    }
    float fx[RC + 2], fy[RC + 2];
    read_row<RC + 2>(fx, fs[0][slot], R, H, col, RC * t);
    read_row<RC + 2>(fy, fs[1][slot], H + R, H, col, RC * t);
#pragma unroll
    for (int e = 0; e < RC; ++e) {
      fox[xb][e] = fx[e + 1];
      foy[xb][e] = fy[e + 1];
    }
#pragma unroll
    for (int e = 0; e < RC + 2; ++e) vx[r0][e] = vy[r0][e] = 0.f;
    if (s >= 1 && busy) {
      const bool r_in = R >= 1 && R <= H - 2;
#pragma unroll
      for (int e = 0; e < RC + 2; ++e) {
        float zx, zy;
        zero_guess_window<BIM>(fx[e], fy[e], qe[r1], qe[r0], e, k, zx, zy);
        const bool in = r_in && col_in[e];
        vx[r0][e] = in ? zx : 0.f;
        vy[r0][e] = in ? zy : 0.f;
      }
    }

    // 3. r1 at row rho from u1 rows rho - 1 .. rho + 1 (zero off the
    // interior): the first row the restriction reads is rho = y0 - 1 (step 3)
    if (s >= 3 && busy) {
      const bool p_in = rho >= 1 && rho <= H - 2;
      float rx[RC], ry[RC];
#pragma unroll
      for (int e = 0; e < RC; ++e) {
        float ax, ay, dxx, dxy;  // element rows rho - 1 = R - 2, rho; columns from c0 - 1
        apply_el_rows<BIM>(vx[r2], vx[r1], vx[r0], vy[r2], vy[r1], vy[r0], e, qe[r2] + 1,
                           qe[r1] + 1, k, ax, ay, dxx, dxy);
        const bool in = p_in && col_in[e + 1];
        rx[e] = in ? fox[xp][e] - ax : 0.f;
        ry[e] = in ? foy[xp][e] - ay : 0.f;
      }
      restrict_rows<odd>(accx, rx, wrow[0][xb] + RC * t, pending);
      restrict_rows<odd>(accy, ry, wrow[1][xb] + RC * t, pending);
    }
    // step s + RD reuses the slots of step s - 1, whose last readers ran at
    // step s - 1
    stage(s + RD, (slot + RD) % RNS);
  };
  for (int s0 = 0; s0 < steps; s0 += G4_UNR)
    static_for<G4_UNR>([&](auto S) { step(s0 + decltype(S)::value, S); });
  __syncthreads();
  if (pending) {  // the strip's last coarse row, completed at its last step
    const int Ic = (y0 + rows_out - 2) >> 1, xl = (steps - 1) & 1;
    restrict_finish(fc, Ic, Hc, wrow[0][xl] + RC * t, J);
    restrict_finish(fc + cplane, Ic, Hc, wrow[1][xl] + RC * t, J);
  }
}

// ---------------------------------------------------------------------------
// G5: zero-guess elastic ascent leg: u3 = BJ(omega D^-1 f + P(uc)); the
// level's pre-smoothed iterate is recomputed in shared memory, never stored.
// Replaces multigrid_feanet_tpu/ops/pallas_elastic.py:555 _el_zpsweep_kernel.
// Bound: bytes, 19 B per fine node (f in, u3 out: 16 B; phase 1 B; a quarter
// node of the two uc planes in: 2 B).  Halo 1: u2 on ring 1.
// ---------------------------------------------------------------------------
template <bool BIM>
__global__ void __launch_bounds__(NT)
g5_el_zascent(const float* __restrict__ f, const int8_t* __restrict__ ph,
              const float* __restrict__ uc, float* __restrict__ out, ElCoef k) {
  constexpr int h = 1;
  using T = Tile<h>;
  __shared__ float fxs[T::N], fys[T::N], xs[T::N], ys[T::N];
  __shared__ float qs[BIM ? T::NQ : 1];
  const int H = k.n + 1, Wc = k.n / 2 + 1;
  const size_t cplane = (size_t)Wc * Wc;
  const int oy = OY * blockIdx.y - h, ox = OX * blockIdx.x - h;

  stage<h, BIM>(fxs, fys, f, nullptr, qs, ph, oy, ox, k);
  __syncthreads();
  for_ring<h>(1, [&](int ly, int lx) {
    const int p = ly * T::S + lx, i = oy + ly, j = ox + lx;
    float vx = 0.f, vy = 0.f;
    if (interior(i, j, H)) {
      zero_guess<BIM>(fxs[p], fys[p], qs + T::q(ly, lx), T::SQ, k, vx, vy);
      vx = vx + prolong(uc, Wc, i, j);
      vy = vy + prolong(uc + cplane, Wc, i, j);
    }
    xs[p] = vx;
    ys[p] = vy;
  });
  __syncthreads();
  relax_tile<h, BIM, 0>(xs, ys, qs, f, out, oy, ox, k);
}

// ---------------------------------------------------------------------------
// G5 as a row-streaming kernel, for levels above G5_ONE_PASS_MAX_N; the same
// contract as the tile above.
// Design: E5's (hrelax.cu e5_h_zascent_rows) without its conv chains, with
// A4's exchange of the zero-guess iterate: no u is staged.  A block covers
// fine columns [x0 - 1, x0 + RB - 1) and owns [x0, x0 + BW), BW = RB - 2 (x0
// even), and rows [y0, y0 + strip) (y0 even); thread t works on columns
// c0 + e, e < RC, c0 = x0 - 1 + RC t (odd).  The block first stages its
// strip's coarse rows of both uc planes (common.cuh stage_coarse; the y
// plane need not start on a 16-byte boundary), rows from (y0 - 1) / 2,
// g5_coarse_rows(strip) of them, columns from c0 / 2 of thread 0.  Step s
// stages both components of f and the phase row R = y0 - 2 + s into a ring
// of G5_NF slots (the sweep reads f two steps later; 6 slots hold the
// stages s - 2 .. s + RD), RD steps ahead; then a thread
//   1. rolls the element row R into a 4-row register ring (rows R - 3 ..
//      R) and the u2 row R - 1 built at step s - 1 into its windows (its own
//      columns from registers, its neighbours' from a shared row);
//   2. sweeps row i = R - 2 with G2's sweep stage (el_sweep_row) on the u2
//      windows, f of row i and the element rows i - 1, i, and stores u3 at
//      the owned nodes;
//   3. builds u2 = omega D^-1 f + P(uc) at row R and its own columns at the
//      interior nodes, 0 elsewhere (zero_guess's arithmetic, omega / det by
//      div_normal; the prolongation by prolong_row from the staged coarse
//      rows, per component), keeps it and passes it on through a shared row.
// Each stage reads rows that the stage before finished at an earlier step,
// so one barrier per step orders them, and each node's u2 is built once.
// A strip takes 4 steps beyond its rows (g5_halo_steps): the u2 rows above
// and below it and the sweep's lag of 2 rows, to which the prolongation adds
// none (its coarse rows are staged before the first step).  The register
// ring, the f / phase ring and the shared rows turn whole every G5_UNR steps
// (the main loop's unroll), so every slot is a constant.
// ---------------------------------------------------------------------------
constexpr int G5_UNR = 6;  // steps per trip of the main loop
constexpr int G5_NF = 6;   // f / phase ring slots: the stages s - 2 .. s + RD
static_assert(G5_UNR % G5_NF == 0 && G5_UNR % 2 == 0, "G5_UNR: whole ring turns");
static_assert(G5_NF >= RD + 3, "G5_NF: the f / phase ring");
// resident blocks per SM asked for: caps the registers at 128
constexpr int G5_MINB = 4;

// The coarse rows a G5 strip of `strip` rows from y0 stages: its u2 rows
// y0 - 1 .. y0 + strip read coarse rows (y0 - 1) / 2 .. (y0 + strip) / 2,
// and prolong_row reads a row and the next.
__host__ __device__ __forceinline__ int g5_coarse_rows(int strip) { return strip / 2 + 3; }

template <bool BIM>
__global__ void __launch_bounds__(RT, G5_MINB)
g5_el_zascent_rows(const float* __restrict__ f, const int8_t* __restrict__ ph,
                   const float* __restrict__ uc, float* __restrict__ out, int strip, ElCoef k) {
  constexpr int BW = RB - 2;  // owned columns of a band
  constexpr int NF = G5_NF;
  constexpr int XS = RB + 4;  // u2 rows: column position p at entry p + 2
  __shared__ __align__(16) float fs[2][NF][RSLOT];  // f rows: component, slot
  __shared__ __align__(16) int8_t qs[BIM ? NF : 1][RSLOTQ];
  __shared__ __align__(16) float u2r[2][2][XS];  // u2: component, the row of step s in s mod 2
  extern __shared__ __align__(16) float ucs[];  // coarse rows of uc's planes 0, 1: CR each
  const int n = k.n, H = n + 1, Hc = n / 2 + 1, t = threadIdx.x;
  const size_t plane = (size_t)H * H;
  const int x0 = blockIdx.x * BW, y0 = blockIdx.y * strip;
  const int c0 = x0 - 1 + RC * t, col = x0 - 2, base = y0 - 2;
  const int rows_out = min(strip, H - y0);
  const int staged = rows_out + 3, steps = rows_out + 4;
  const int ci0 = (y0 - 1) >> 1, CR = g5_coarse_rows(strip), cj0 = (x0 - 1) >> 1;

  for (int e = t; e < 2 * 2 * XS; e += RT) (&u2r[0][0][0])[e] = 0.f;
  stage_coarse(ucs, uc, Hc, ci0, CR, cj0, 0);
  stage_coarse(ucs + CR * RCSLOT, uc, Hc, ci0, CR, cj0, 1);
  cp_commit();
  const unsigned fd = smem_addr(fs), qd = smem_addr(qs);
  // stages step s (J = s mod G5_UNR): both components of f and the phase row
  // base + s into slot J mod NF; always commits
  auto stage = [&](int s, auto S) {
    constexpr int SJ = decltype(S)::value % NF;
    const bool live = s < staged;
#pragma unroll
    for (int c = 0; c < 2; ++c)
      stage_plane<4, RW>(fd + 4 * RSLOT * (c * NF + SJ), f, c, base + s, H, H, col, live);
    if (BIM) stage_window<1, RWQ>(qd + RSLOTQ * SJ, ph, base + s, n, n, col, live);
    cp_commit();
  };
  static_for<RD>([&](auto S) { stage(decltype(S)::value, S); });

  // columns c0 - 1 .. c0 + RC interior; columns c0 .. c0 + RC - 1 owned by
  // the block
  bool col_in[RC + 2], col_own[RC];
#pragma unroll
  for (int e = 0; e < RC + 2; ++e) col_in[e] = c0 - 1 + e >= 1 && c0 - 1 + e <= H - 2;
#pragma unroll
  for (int e = 0; e < RC; ++e) {
    const int p = RC * t + e;
    col_own[e] = p >= 1 && p < 1 + BW && c0 + e < H;
  }

  float qe[4][RC + 1] = {};  // element rows R - 4 .. R - 1 (rolled to R - 3 .. R at step s)
  float xw[3][RC + 2] = {}, yw[3][RC + 2] = {};  // u2 rows i - 1 .. i + 1
  float u2x[RC] = {}, u2y[RC] = {};              // u2's own columns of the last step
  float rr = 0.f;                                // (no norm: unused)
  // step s (f / phase slot s mod NF, u2 row slot s mod 2)
  auto step = [&](int s, auto S) {
    constexpr int I = decltype(S)::value;
    constexpr int xb = I % 2, xp = (I + 1) % 2;
    // f / phase slots of rows R and i (staged 2 steps earlier)
    constexpr int fnow = I % NF, fi = (I + NF - 2) % NF;
    constexpr bool odd = (I & 1) != 0;  // R = y0 - 2 + s (y0 and G5_UNR even)
    if (s >= steps) return;
    cp_wait<RD - 1>();
    __syncthreads();
    const int R = base + s, i = R - 2;

    {  // 1. the element row R and the u2 row R - 1
      if constexpr (BIM) {
        const int8_t* pq = qs[fnow] + win_off<int8_t>(R, n, col) + RC * t;
#pragma unroll
        for (int e = 0; e <= RC; ++e) {
          qe[0][e] = qe[1][e];
          qe[1][e] = qe[2][e];
          qe[2][e] = qe[3][e];
          qe[3][e] = (float)pq[e] * k.da + k.a0;
        }
      }
      float nx[RC + 2], ny[RC + 2];
      nx[0] = u2r[0][xp][RC * t + 1];
      nx[RC + 1] = u2r[0][xp][RC * t + RC + 2];
      ny[0] = u2r[1][xp][RC * t + 1];
      ny[RC + 1] = u2r[1][xp][RC * t + RC + 2];
#pragma unroll
      for (int e = 0; e < RC; ++e) {
        nx[e + 1] = u2x[e];
        ny[e + 1] = u2y[e];
      }
      roll<RC + 2>(xw, nx);
      roll<RC + 2>(yw, ny);
    }

    if (s >= 4) {  // 2. u3 at row i = y0 - 4 + s, from u2 rows i - 1 .. i + 1
      float fx[RC], fy[RC], vx[RC], vy[RC], rx[RC], ry[RC];
      read_row<RC>(fx, fs[0][fi], i, H, col, RC * t + 1);
      read_row<RC>(fy, fs[1][fi], H + i, H, col, RC * t + 1);
      el_sweep_row<BIM>(xw, yw, qe[0], qe[1], fx, fy, i >= 1 && i <= H - 2, col_in, false,
                        col_own, k, vx, vy, rx, ry, rr);
      float* orow = out + (size_t)i * H + c0;
#pragma unroll
      for (int e = 0; e < RC; ++e) {
        if (col_own[e]) {
          orow[e] = vx[e];
          orow[plane + e] = vy[e];
        }
      }
    }

    if (s >= 1 && s < staged) {  // 3. u2 at row R (row y0 - 2 of step 0 brings its phases)
      float fx[RC], fy[RC], px[RC], py[RC];
      read_row<RC>(fx, fs[0][fnow], R, H, col, RC * t + 1);
      read_row<RC>(fy, fs[1][fnow], H + R, H, col, RC * t + 1);
      prolong_row<RC, true>(px, ucs, R, odd, ci0, CR, Hc, cj0, t, 0);
      prolong_row<RC, true>(py, ucs + CR * RCSLOT, R, odd, ci0, CR, Hc, cj0, t, 1);
      const bool r_in = R >= 1 && R <= H - 2;
#pragma unroll
      for (int e = 0; e < RC; ++e) {
        float zx, zy;
        zero_guess_window<BIM>(fx[e], fy[e], qe[2], qe[3], e, k, zx, zy);
        const bool in = r_in && col_in[e + 1];
        u2x[e] = in ? zx + px[e] : 0.f;
        u2y[e] = in ? zy + py[e] : 0.f;
      }
      *reinterpret_cast<float2*>(&u2r[0][xb][RC * t + 2]) = make_float2(u2x[0], u2x[1]);
      *reinterpret_cast<float2*>(&u2r[1][xb][RC * t + 2]) = make_float2(u2y[0], u2y[1]);
    }
    // step s + RD takes the f / phase slot of step s - 4, whose last reader
    // was step s - 2
    stage(s + RD, std::integral_constant<int, (I + RD) % G5_UNR>{});
  };
  for (int s0 = 0; s0 < steps; s0 += G5_UNR)
    static_for<G5_UNR>([&](auto S) { step(s0 + decltype(S)::value, S); });
}

// The grids of G1 and G5: on one-pass tiles, coarse_grid; row streaming,
// bands of `bw` owned columns (G1: RB, G5: RB - 2) and strips of `strip`
// rows (even, 2 .. RS_STRIP_MAX); as ops/elastic.py::g1_launch_tiles and
// g5_launch_tiles compute them.
inline bool el_fine_grid_ok(int n, int bw, bool one_pass, int strip, int gx, int gy) {
  const int H = n + 1;
  if (one_pass) return (unsigned)gx == coarse_grid(n).x && (unsigned)gy == coarse_grid(n).y;
  return strip >= 2 && strip % 2 == 0 && strip <= RS_STRIP_MAX && gx == (H + bw - 1) / bw &&
         gy == (H + strip - 1) / strip;
}

// The grid of G4: on one-pass tiles, coarse_grid; row streaming, bands of
// RB - 2 owned columns and strips of `strip` rows (even, 2 .. RS_STRIP_MAX),
// each restricting to the coarse nodes under it, as
// ops/elastic.py::g4_launch_tiles computes them.
inline bool g4_grid_ok(int n, bool one_pass, int strip, int gx, int gy) {
  const int Hc = n / 2 + 1, bw = (RB - 2) / 2, sh = strip / 2;
  if (one_pass) return (unsigned)gx == coarse_grid(n).x && (unsigned)gy == coarse_grid(n).y;
  return strip >= 2 && strip % 2 == 0 && strip <= RS_STRIP_MAX && gx == (Hc + bw - 1) / bw &&
         gy == (Hc + sh - 1) / sh;
}

template <bool BIM, int MODE>
void launch_g1(bool one_pass, dim3 g, cudaStream_t st, const float* u, const float* f,
               const int8_t* ph, float* out, float* partial, unsigned* done, float* rsq,
               int strip, const ElCoef& k) {
  if (one_pass)
    g1_el_relax<BIM, MODE><<<g, NT, 0, st>>>(u, f, ph, out, partial, done, rsq, k);
  else
    g1_el_relax_rows<BIM, MODE><<<g, RT, 0, st>>>(u, f, ph, out, partial, done, rsq, strip, k);
}

// G5 streams with its strip's coarse rows of both planes in dynamic shared
// memory: opted in to what strips of up to RS_STRIP_MAX rows need (the
// static rings and rows come on top, ~18 KB).
inline size_t g5_coarse_smem(int strip) {
  return sizeof(float) * 2 * RCSLOT * g5_coarse_rows(strip);
}
template <bool BIM>
const void* g5_rows_kernel() {
  const void* kern = (const void*)g5_el_zascent_rows<BIM>;
  static const bool opted =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)g5_coarse_smem(RS_STRIP_MAX)) == cudaSuccess;
  (void)opted;
  return kern;
}

template <bool BIM>
void launch_g5(bool one_pass, dim3 g, cudaStream_t st, const float* f, const int8_t* ph,
               const float* uc, float* out, int strip, const ElCoef& k) {
  if (one_pass) {
    g5_el_zascent<BIM><<<g, NT, 0, st>>>(f, ph, uc, out, k);
  } else {
    g5_rows_kernel<BIM>();
    g5_el_zascent_rows<BIM><<<g, RT, g5_coarse_smem(strip), st>>>(f, ph, uc, out, strip, k);
  }
}
}  // namespace

extern "C" {

// The entry points take the level's a0, da, omega and the six constants
// (al, be, ga, ep, de, ze) of elastic_factor_constants; `bim` selects the
// phase-map build (ph may be null otherwise).  Each returns the CUDA error
// of its launches (0 on success).

// G1.  mode 0: out = BJ(u); 1: out = masked residual.  rsq[0] = interior
// ||f - A u||^2 of u (both components); the launch geometry of
// ops/elastic.py::g1_launch_tiles: one-pass tiles when one_pass, else
// row-streaming strips of `strip` rows, on gx x gy blocks; scratch of gx gy
// partial sums and a zeroed counter that the last block resets.
// cudaErrorInvalidValue for a mode or geometry G1 does not take.
int mg_el_sweep(const float* u, const float* f, const int8_t* ph, float* out, float* partial,
                unsigned* done, float* rsq, int n, double a0, double da, double omega,
                double al, double be, double ga, double ep, double de, double ze, int bim,
                int mode, int one_pass, int strip, int gx, int gy, void* stream) {
  if ((mode != 0 && mode != 1) || !el_fine_grid_ok(n, RB, one_pass != 0, strip, gx, gy))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const ElCoef k = make_el_coef(n, a0, da, omega, al, be, ga, ep, de, ze);
  const dim3 g(gx, gy);
  const bool op = one_pass != 0;
  if (bim) {
    if (mode == 0) launch_g1<true, 0>(op, g, st, u, f, ph, out, partial, done, rsq, strip, k);
    else launch_g1<true, 1>(op, g, st, u, f, ph, out, partial, done, rsq, strip, k);
  } else {
    if (mode == 0) launch_g1<false, 0>(op, g, st, u, f, ph, out, partial, done, rsq, strip, k);
    else launch_g1<false, 1>(op, g, st, u, f, ph, out, partial, done, rsq, strip, k);
  }
  return (int)cudaGetLastError();
}

// Blocks of the row-streaming G1 in one form and mode that one SM holds at
// once: what ops/elastic.py balances the strip height against.  Negative on
// a CUDA error or a mode G1 does not take.
int mg_el_sweep_occupancy(int bim, int mode) {
  if (mode != 0 && mode != 1) return -(int)cudaErrorInvalidValue;
  const void* by_mode[2][2] = {
      {(const void*)g1_el_relax_rows<false, 0>, (const void*)g1_el_relax_rows<false, 1>},
      {(const void*)g1_el_relax_rows<true, 0>, (const void*)g1_el_relax_rows<true, 1>}};
  int blocks = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, by_mode[bim != 0][mode], RT, 0);
  return err == cudaSuccess ? blocks : -(int)err;
}

// G2.  u1 = BJ(u), fc = 4 FW(f - A u1), rsq[0] = interior ||f - A u||^2;
// the launch geometry of ops/elastic.py::g2_launch_tiles: one-pass tiles
// when one_pass, else row-streaming strips of `strip` rows, on gx x gy
// blocks; scratch of gx gy partial sums and a zeroed counter that the last
// block resets.  cudaErrorInvalidValue for a geometry G2 does not take.
int mg_el_swrr(const float* u, const float* f, const int8_t* ph, float* u1, float* fc,
               float* partial, unsigned* done, float* rsq, int n, double a0, double da,
               double omega, double al, double be, double ga, double ep, double de, double ze,
               int bim, int one_pass, int strip, int gx, int gy, void* stream) {
  // the grid of ops/elastic.py::g2_launch_tiles: E2's chain without conv layers
  if (!descent_grid_ok(n, 0, one_pass != 0, strip, gx, gy)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const ElCoef k = make_el_coef(n, a0, da, omega, al, be, ga, ep, de, ze);
  const dim3 g(gx, gy);
  if (one_pass) {
    if (bim) g2_el_descent<true><<<g, NT, 0, st>>>(u, f, ph, u1, fc, partial, done, rsq, k);
    else g2_el_descent<false><<<g, NT, 0, st>>>(u, f, ph, u1, fc, partial, done, rsq, k);
  } else {
    if (bim)
      g2_el_descent_rows<true><<<g, RT, 0, st>>>(u, f, ph, u1, fc, partial, done, rsq, strip, k);
    else
      g2_el_descent_rows<false><<<g, RT, 0, st>>>(u, f, ph, u1, fc, partial, done, rsq, strip,
                                                  k);
  }
  return (int)cudaGetLastError();
}

// Blocks of the row-streaming G2 in one form that one SM holds at once: what
// ops/elastic.py balances the strip height against.  Negative on a CUDA
// error.
int mg_el_swrr_occupancy(int bim) {
  const void* kern = bim ? (const void*)g2_el_descent_rows<true>
                         : (const void*)g2_el_descent_rows<false>;
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, RT, 0);
  return err == cudaSuccess ? blocks : -(int)err;
}

// G3.  out = BJ(u1 + P(uc)).
int mg_el_psweep(const float* u1, const float* f, const int8_t* ph, const float* uc, float* out,
                 int n, double a0, double da, double omega, double al, double be, double ga,
                 double ep, double de, double ze, int bim, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const ElCoef k = make_el_coef(n, a0, da, omega, al, be, ga, ep, de, ze);
  const dim3 g = coarse_grid(n);
  if (bim) g3_el_ascent<true><<<g, NT, 0, st>>>(u1, f, ph, uc, out, k);
  else g3_el_ascent<false><<<g, NT, 0, st>>>(u1, f, ph, uc, out, k);
  return (int)cudaGetLastError();
}

// G4.  fc = 4 FW(f - A u1), u1 = omega D^-1 f; the launch geometry of
// ops/elastic.py::g4_launch_tiles: one-pass tiles when one_pass, else
// row-streaming strips of `strip` rows, on gx x gy blocks.
// cudaErrorInvalidValue for a geometry G4 does not take.
int mg_el_zrr(const float* f, const int8_t* ph, float* fc, int n, double a0, double da,
              double omega, double al, double be, double ga, double ep, double de, double ze,
              int bim, int one_pass, int strip, int gx, int gy, void* stream) {
  if (!g4_grid_ok(n, one_pass != 0, strip, gx, gy)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const ElCoef k = make_el_coef(n, a0, da, omega, al, be, ga, ep, de, ze);
  const dim3 g(gx, gy);
  if (one_pass) {
    if (bim) g4_el_zdescent<true><<<g, NT, 0, st>>>(f, ph, fc, k);
    else g4_el_zdescent<false><<<g, NT, 0, st>>>(f, ph, fc, k);
  } else {
    if (bim) g4_el_zdescent_rows<true><<<g, RT, 0, st>>>(f, ph, fc, strip, k);
    else g4_el_zdescent_rows<false><<<g, RT, 0, st>>>(f, ph, fc, strip, k);
  }
  return (int)cudaGetLastError();
}

// Blocks of the row-streaming G4 in one form that one SM holds at once: what
// ops/elastic.py balances the strip height against.  Negative on a CUDA
// error.
int mg_el_zrr_occupancy(int bim) {
  const void* kern = bim ? (const void*)g4_el_zdescent_rows<true>
                         : (const void*)g4_el_zdescent_rows<false>;
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, RT, 0);
  return err == cudaSuccess ? blocks : -(int)err;
}

// G5.  out = BJ(omega D^-1 f + P(uc)); the launch geometry of
// ops/elastic.py::g5_launch_tiles: one-pass tiles when one_pass, else
// row-streaming strips of `strip` rows, on gx x gy blocks.
// cudaErrorInvalidValue for a geometry G5 does not take.
int mg_el_zpsweep(const float* f, const int8_t* ph, const float* uc, float* out, int n,
                  double a0, double da, double omega, double al, double be, double ga,
                  double ep, double de, double ze, int bim, int one_pass, int strip, int gx,
                  int gy, void* stream) {
  if (!el_fine_grid_ok(n, RB - 2, one_pass != 0, strip, gx, gy)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const ElCoef k = make_el_coef(n, a0, da, omega, al, be, ga, ep, de, ze);
  const dim3 g(gx, gy);
  if (bim) launch_g5<true>(one_pass != 0, g, st, f, ph, uc, out, strip, k);
  else launch_g5<false>(one_pass != 0, g, st, f, ph, uc, out, strip, k);
  return (int)cudaGetLastError();
}

// Blocks of the row-streaming G5 in one form that one SM holds at once with
// the coarse rows of a strip of `strip` rows: what ops/elastic.py balances
// the strip height against.  Negative on a CUDA error or a strip G5 does not
// take.
int mg_el_zpsweep_occupancy(int bim, int strip) {
  if (strip < 2 || strip % 2 || strip > RS_STRIP_MAX) return -(int)cudaErrorInvalidValue;
  int blocks = 0;
  const void* kern = bim ? g5_rows_kernel<true>() : g5_rows_kernel<false>();
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, RT, g5_coarse_smem(strip));
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // extern "C"

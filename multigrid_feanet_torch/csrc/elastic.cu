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
// Design common to all five: one 256-thread block per OY x OX = 16 x 32
// tile of fine nodes (common.cuh's Tile; the descent legs' coarse output is
// the CY x CX coarse tile above it), so every leg runs on coarse_grid(n).
// Each block stages its inputs over the tile plus a halo of h nodes in
// shared memory, both components and the element coefficients, once; each
// operator apply consumes one ring, so h is the leg's dependency depth (G1
// 1, G2 3, G3 1, G4 2, G5 1: the JAX cache invariants).  Every stage is
// computed on a ring one node smaller than the last, so blocks never depend
// on one another.  The prolonged correction is computed only at interior
// fine nodes, so no read falls past the coarse field.  G1's and G2's
// interior residual norm^2 of the incoming iterate (both components) is
// summed per block in a fixed order and then by reduce_kernel (no atomics:
// sums repeat run to run).

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

// u += (omega / det) D~ r: the damped 2x2 block-Jacobi update (_block_update).
__device__ __forceinline__ void bj_update(float& ux, float& uy, float rx, float ry, float dxx,
                                          float dxy, float omega) {
  const float det = dxx * dxx - dxy * dxy;
  const float w = omega / det;
  ux = ux + w * (dxx * rx - dxy * ry);
  uy = uy + w * (dxx * ry - dxy * rx);
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
// 24 homogeneous.  Halo 1.
// ---------------------------------------------------------------------------
template <bool BIM, int MODE>
__global__ void __launch_bounds__(NT)
g1_el_relax(const float* __restrict__ u, const float* __restrict__ f,
            const int8_t* __restrict__ ph, float* __restrict__ out, float* __restrict__ partial,
            ElCoef k) {
  constexpr int h = 1;
  using T = Tile<h>;
  __shared__ float xs[T::N], ys[T::N];
  __shared__ float qs[BIM ? T::NQ : 1];
  __shared__ float red[NT / 32];
  const int oy = OY * blockIdx.y - h, ox = OX * blockIdx.x - h;

  stage<h, BIM>(xs, ys, u, nullptr, qs, ph, oy, ox, k);
  __syncthreads();
  float rr = relax_tile<h, BIM, MODE>(xs, ys, qs, f, out, oy, ox, k);
  rr = block_sum(rr, red);
  if (threadIdx.x == 0) partial[blockIdx.y * gridDim.x + blockIdx.x] = rr;
}

// ---------------------------------------------------------------------------
// G2: elastic descent leg: u1 = BJ(u0), f_c = 4 FW(f - A u1) per component,
// and the interior ||f - A u0||^2 of the incoming iterate.
// Replaces multigrid_feanet_tpu/ops/pallas_elastic.py:391 _el_swrr_kernel.
// Bound: bytes, 27 B per fine node (u0, f in, u1 out: 24 B; phase 1 B; a
// quarter node of the two f_c planes out: 2 B).  Halo 3: u1 is needed on
// ring 2 for the residual that the restriction reads on ring 1.
// ---------------------------------------------------------------------------
template <bool BIM>
__global__ void __launch_bounds__(NT)
g2_el_descent(const float* __restrict__ u, const float* __restrict__ f,
              const int8_t* __restrict__ ph, float* __restrict__ u1_out,
              float* __restrict__ fc, float* __restrict__ partial, ElCoef k) {
  constexpr int h = 3;
  using T = Tile<h>;
  __shared__ float xs[T::N], ys[T::N], fxs[T::N], fys[T::N], x1[T::N], y1[T::N];
  __shared__ float qs[BIM ? T::NQ : 1];
  __shared__ float red[NT / 32];
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
  rr = block_sum(rr, red);
  if (threadIdx.x == 0) partial[blockIdx.y * gridDim.x + blockIdx.x] = rr;
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

}  // namespace

extern "C" {

// The entry points take the level's a0, da, omega and the six constants
// (al, be, ga, ep, de, ze) of elastic_factor_constants; `bim` selects the
// phase-map build (ph may be null otherwise).  Each returns the CUDA error
// of its launches (0 on success).

// G1.  mode 0: out = BJ(u); 1: out = masked residual.  rsq[0] = interior
// ||f - A u||^2 of u (both components); `partial` holds mg_partials(1, n)
// floats.
int mg_el_sweep(const float* u, const float* f, const int8_t* ph, float* out, float* partial,
                float* rsq, int n, double a0, double da, double omega, double al, double be,
                double ga, double ep, double de, double ze, int bim, int mode, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const ElCoef k = make_el_coef(n, a0, da, omega, al, be, ga, ep, de, ze);
  const dim3 g = coarse_grid(n);
  if (bim) {
    if (mode == 0) g1_el_relax<true, 0><<<g, NT, 0, st>>>(u, f, ph, out, partial, k);
    else g1_el_relax<true, 1><<<g, NT, 0, st>>>(u, f, ph, out, partial, k);
  } else {
    if (mode == 0) g1_el_relax<false, 0><<<g, NT, 0, st>>>(u, f, ph, out, partial, k);
    else g1_el_relax<false, 1><<<g, NT, 0, st>>>(u, f, ph, out, partial, k);
  }
  reduce_kernel<<<1, NT, 0, st>>>(partial, (int)(g.x * g.y), rsq);
  return (int)cudaGetLastError();
}

// G2.  u1 = BJ(u), fc = 4 FW(f - A u1), rsq[0] = interior ||f - A u||^2.
int mg_el_swrr(const float* u, const float* f, const int8_t* ph, float* u1, float* fc,
               float* partial, float* rsq, int n, double a0, double da, double omega, double al,
               double be, double ga, double ep, double de, double ze, int bim, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const ElCoef k = make_el_coef(n, a0, da, omega, al, be, ga, ep, de, ze);
  const dim3 g = coarse_grid(n);
  if (bim) g2_el_descent<true><<<g, NT, 0, st>>>(u, f, ph, u1, fc, partial, k);
  else g2_el_descent<false><<<g, NT, 0, st>>>(u, f, ph, u1, fc, partial, k);
  reduce_kernel<<<1, NT, 0, st>>>(partial, (int)(g.x * g.y), rsq);
  return (int)cudaGetLastError();
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

// G4.  fc = 4 FW(f - A u1), u1 = omega D^-1 f.
int mg_el_zrr(const float* f, const int8_t* ph, float* fc, int n, double a0, double da,
              double omega, double al, double be, double ga, double ep, double de, double ze,
              int bim, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const ElCoef k = make_el_coef(n, a0, da, omega, al, be, ga, ep, de, ze);
  const dim3 g = coarse_grid(n);
  if (bim) g4_el_zdescent<true><<<g, NT, 0, st>>>(f, ph, fc, k);
  else g4_el_zdescent<false><<<g, NT, 0, st>>>(f, ph, fc, k);
  return (int)cudaGetLastError();
}

// G5.  out = BJ(omega D^-1 f + P(uc)).
int mg_el_zpsweep(const float* f, const int8_t* ph, const float* uc, float* out, int n,
                  double a0, double da, double omega, double al, double be, double ga,
                  double ep, double de, double ze, int bim, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const ElCoef k = make_el_coef(n, a0, da, omega, al, be, ga, ep, de, ze);
  const dim3 g = coarse_grid(n);
  if (bim) g5_el_zascent<true><<<g, NT, 0, st>>>(f, ph, uc, out, k);
  else g5_el_zascent<false><<<g, NT, 0, st>>>(f, ph, uc, out, k);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Fused V-cycle legs of a general 9-point operator with operator-induced
// (BoxMG) transfers, for Hopper.
//
// Five kernels, each the counterpart of one Pallas TPU kernel of
// multigrid_feanet_tpu/ops/pallas_general.py, on compact row-major fields:
//   u, f     (n+1) x (n+1) float32 node fields (H = n + 1, HH = H * H)
//   s9       9 planes of H x H stencil coefficients; plane 3*dr + dc couples
//            a node to its (dr-1, dc-1) neighbour
//   w4       4 planes [w00, w01, w10, w11] of H x H transfer weights:
//                (P uc)[i, j] = sum_{a,b} w_ab[i, j] uc[i/2 + a, j/2 + b]
//            (the geometric masks are already folded in by the setup)
//   ph       n x n int8 element phases: level 0's exact bi-material
//            operator, applied in difference form (common.cuh)
//   uc, fc   (n/2+1) x (n/2+1) float32 coarse node fields
// s9 and w4 are stored as T = float or __nv_bfloat16 and cast to float on
// load, as the TPU kernels do.
//
// Semantics shared with the TPU kernels: only globally interior nodes are
// updated (boundary nodes keep their value; the zero-guess legs leave 0
// there), residuals and the prolonged correction are zero on the boundary,
// and the coarse output is zero on the coarse boundary ring.  The Jacobi
// diagonal is the guarded centre coefficient (|d| = 0 -> 1) of a general
// operator, (2/3) C4 of the bi-material one.  The restriction is the plain
// transpose P^T: no factor 4, unlike A2/A3's full weighting, because the
// Galerkin coarse operators are P^T A P.
//
// D2 above D2_ONE_PASS_MAX_N (ops/general.py) streams rows
// (d2_gen_descent_rows, below).  The one-pass design of the others, and of
// D2 at and below that size (as sweep.cu): one thread per output node (D1,
// D3, D5) or one block per tile of coarse nodes (D2, D4); each block stages
// the u / f / Q tile it needs, with its halo, in shared memory and
// recomputes the halo overlap instead of the TPU's sequential grid carry.
// Coefficient and weight planes are aligned to the node they belong to, so
// each thread reads its own from device memory (coalesced along rows) and
// they need no shared tile.  The interior residual norm^2 (D1, D2) is summed
// per block in a fixed order and the partials by one fixed-order pass (D1)
// or by D2's last block to finish (finish_sums): no float atomics, so norms
// repeat run to run.
//
// The prolonged correction is read only at interior fine nodes, where
// i/2 + 1 <= n/2 and j/2 + 1 <= n/2 stay inside the coarse grid.  The TPU
// kernel reads one row past the coarse window at the last fine row and
// relies on its zero weight; here that read never happens, so a NaN or an
// out-of-bounds address past the coarse field cannot leak in.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ float guard_d(float d) { return fabsf(d) > 0.f ? d : 1.f; }

// General A u at the node at U[0] of a u tile with row stride su, whose 9
// coefficients sit at offset g of each plane; order of operations as
// _apply_gen (pallas_general.py:92-104).  Sets d to the guarded diagonal.
template <class T>
__device__ __forceinline__ float apply_gen(const float* U, int su, const T* __restrict__ s9,
                                           size_t HH, size_t g, float& d) {
  float s[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) s[q] = ld(s9 + q * HH + g);
  const float t0 = (s[0] * U[-su - 1] + s[1] * U[-su]) + s[2] * U[-su + 1];
  const float t1 = (s[3] * U[-1] + s[4] * U[0]) + s[5] * U[1];
  const float t2 = (s[6] * U[su - 1] + s[7] * U[su]) + s[8] * U[su + 1];
  d = guard_d(s[4]);
  return (t0 + t1) + t2;
}

// W4 prolongation of uc at INTERIOR fine node (i, j) (global offset g):
// ((w00 uc[I, J] + w01 uc[I, J+1]) + w10 uc[I+1, J]) + w11 uc[I+1, J+1]
// with (I, J) = (i/2, j/2), as _w4_corr.  Callers pass interior nodes only,
// so I + 1 and J + 1 are inside the coarse grid.
template <class T>
__device__ __forceinline__ float w4_prolong(const float* __restrict__ uc, int Hc,
                                            const T* __restrict__ w4, size_t HH,
                                            size_t g, int i, int j) {
  const float* p = uc + (size_t)(i >> 1) * Hc + (j >> 1);
  return ((ld(w4 + g) * p[0] + ld(w4 + HH + g) * p[1]) + ld(w4 + 2 * HH + g) * p[Hc])
         + ld(w4 + 3 * HH + g) * p[Hc + 1];
}

// W4 restriction (exact P^T) onto the coarse node over fine node (2I, 2J):
// fine neighbour (dr, dc) reaches it through its weight (a, b) = (dr == -1,
// dc == -1).  ``r`` points at (2I, 2J) in a residual tile of row stride s;
// g is the global offset of (2I, 2J).  Rows first, then columns, as
// _w4_restrict (pallas_general.py:135-151).
template <class T>
__device__ __forceinline__ float w4_restrict(const float* r, int s, const T* __restrict__ w4,
                                             size_t HH, size_t g, int H) {
  const T* base = w4 + g;
  auto w = [&](int plane, int dr, int dc) { return ld(base + plane * HH + dr * H + dc); };
  auto rr = [&](int dr, int dc) { return r[dr * s + dc]; };
  const float rm = (w(3, -1, -1) * rr(-1, -1) + w(1, 0, -1) * rr(0, -1)) + w(1, 1, -1) * rr(1, -1);
  const float r0 = (w(2, -1, 0) * rr(-1, 0) + w(0, 0, 0) * rr(0, 0)) + w(0, 1, 0) * rr(1, 0);
  const float rp = (w(2, -1, 1) * rr(-1, 1) + w(0, 0, 1) * rr(0, 1)) + w(0, 1, 1) * rr(1, 1);
  return (rm + r0) + rp;
}

// The level's operator at a node: the bi-material difference form from an
// element tile (BIM) or the node's 9 planes.  Sets d to the Jacobi diagonal.
template <class T, bool BIM>
__device__ __forceinline__ float apply_level(const float* U, int su, const float* Q, int sq,
                                             const T* __restrict__ s9, size_t HH, size_t g,
                                             const Coef& k, float& d) {
  if (BIM) {
    float c4;
    const float au = apply_op<true, true>(U, su, Q, sq, k, c4);
    d = K23 * c4;
    return au;
  }
  return apply_gen(U, su, s9, HH, g, d);
}

// ---------------------------------------------------------------------------
// D1: general weighted-Jacobi sweep (MODE 0) or masked residual (MODE 1),
// and the interior ||r||^2 of the incoming u.
// Replaces multigrid_feanet_tpu/ops/pallas_general.py:163 _gsweep_kernel.
// Bound: bytes.  Per node it must read u, f (8 B) and the 9 planes (36 B
// f32 / 18 B bf16) and write the output (4 B): 48 / 30 B/node, against ~24
// flops/node.  Design: u in a shared tile with a 1-node halo; the planes
// and f are read once, by the node's own thread.
// ---------------------------------------------------------------------------
template <class T, int MODE>
__global__ void __launch_bounds__(NT)
d1_gen_relax(const float* __restrict__ u, const float* __restrict__ f,
             const T* __restrict__ s9, float* __restrict__ out,
             float* __restrict__ partial, Coef k) {
  constexpr int SU = TX + 2, RU = TY + 2;  // u tile: nodes [y0-1, y0+TY]
  __shared__ float us[RU * SU];
  __shared__ float red[NT / 32];
  const int H = k.n + 1;
  const size_t HH = (size_t)H * H;
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const int tid = threadIdx.y * TX + threadIdx.x;

  for (int t = tid; t < RU * SU; t += NT) {
    const int i = y0 - 1 + t / SU, j = x0 - 1 + t % SU;
    us[t] = (i >= 0 && i < H && j >= 0 && j < H) ? u[(size_t)i * H + j] : 0.f;
  }
  __syncthreads();

  const int i = y0 + threadIdx.y, j = x0 + threadIdx.x;
  float rr = 0.f;
  if (i < H && j < H) {
    const size_t g = (size_t)i * H + j;
    const float* U = us + (threadIdx.y + 1) * SU + threadIdx.x + 1;
    float r = 0.f, d = 1.f;
    if (interior(i, j, H)) r = f[g] - apply_gen(U, SU, s9, HH, g, d);
    out[g] = MODE == 1 ? r : U[0] + (k.omega / d) * r;
    rr = r * r;
  }
  rr = block_sum(rr, red);
  if (tid == 0) partial[blockIdx.y * gridDim.x + blockIdx.x] = rr;
}

// ---------------------------------------------------------------------------
// D2: pre-smoothing sweep + residual of the swept iterate + W4 restriction:
// u1 = sweep(u0), fc = P^T (f - A u1), and the interior ||r||^2 of u0.
// Replaces multigrid_feanet_tpu/ops/pallas_general.py:202 _gswrr_kernel.
// Bound: bytes.  Per fine node it must read u0, f (8 B), the operator (the
// phase, ~1 B, or 9 planes) and the 4 W4 planes (16 B f32 / 8 B bf16), and
// write u1 (4 B) and a quarter node of fc (1 B): bi-material 30 / 22 B/node
// (f32 / bf16 planes), general 65 / 39 B/node; ~100 flops/node.  The
// restriction reads w00 at every fine node but w01 only at odd columns, w10
// at odd rows and w11 at odd rows and columns (_w4_restrict), so the leg
// must move 2.25 of the 4 weight planes: bi-material 23 / 18.5 B/node.
//
// One-pass tile, for levels of up to D2_ONE_PASS_MAX_N (ops/general.py):
// the tiles of sweep.cu's A2 (a 3-node u0 halo for two applies and the
// restriction stencil); u1 and its residual never leave shared memory; the
// norm's partials are added by the last block to finish (finish_sums), so
// one launch.
// ---------------------------------------------------------------------------
template <class T, bool BIM>
__global__ void __launch_bounds__(NT)
d2_gen_descent(const float* __restrict__ u, const float* __restrict__ f,
               const int8_t* __restrict__ ph, const T* __restrict__ s9,
               const T* __restrict__ w4, float* __restrict__ u1_out,
               float* __restrict__ fc, float* __restrict__ partial,
               unsigned* __restrict__ done, float* __restrict__ rsq, Coef k) {
  constexpr int SQ = C0 - 1, RQ = R0 - 1;
  __shared__ float us[R0 * C0];
  __shared__ float fs[R0 * C0];
  __shared__ float u1s[R0 * C0];
  __shared__ float qs[BIM ? RQ * SQ : 1];
  const int H = k.n + 1, Hc = k.n / 2 + 1;
  const size_t HH = (size_t)H * H;
  const int I0 = blockIdx.y * CY, J0 = blockIdx.x * CX;
  const int oy = 2 * I0 - 3, ox = 2 * J0 - 3;
  const int tid = threadIdx.x;

  for (int t = tid; t < R0 * C0; t += NT) {
    const int i = oy + t / C0, j = ox + t % C0;
    const bool in = i >= 0 && i < H && j >= 0 && j < H;
    us[t] = in ? u[(size_t)i * H + j] : 0.f;
    fs[t] = in ? f[(size_t)i * H + j] : 0.f;
    u1s[t] = 0.f;
  }
  if (BIM) {
    for (int t = tid; t < RQ * SQ; t += NT)
      qs[t] = elem_q(ph, k.n, oy + t / SQ, ox + t % SQ, k);
  }
  __syncthreads();

  // u1 = u0 + (omega / d) r0 on local [1, R0-1) x [1, C0-1); the owned nodes
  // are stored and add r0^2 to the pre-sweep norm.
  float rr = 0.f;
  for (int t = tid; t < (R0 - 2) * (C0 - 2); t += NT) {
    const int ly = 1 + t / (C0 - 2), lx = 1 + t % (C0 - 2);
    const int i = oy + ly, j = ox + lx;
    if (i < 0 || i >= H || j < 0 || j >= H) continue;
    const size_t g = (size_t)i * H + j;
    float r0 = 0.f, d = 1.f;
    if (interior(i, j, H))
      r0 = fs[ly * C0 + lx] - apply_level<T, BIM>(us + ly * C0 + lx, C0, qs + ly * SQ + lx,
                                                   SQ, s9, HH, g, k, d);
    const float v = us[ly * C0 + lx] + (k.omega / d) * r0;
    u1s[ly * C0 + lx] = v;
    if (ly >= 3 && ly < 3 + 2 * CY && lx >= 3 && lx < 3 + 2 * CX) {
      u1_out[g] = v;
      rr += r0 * r0;
    }
  }
  __syncthreads();

  // r1 = f - A u1 on local [2, R0-2) x [2, C0-2), written over fs (each
  // entry is read only by the thread that overwrites it).
  for (int t = tid; t < (R0 - 4) * (C0 - 4); t += NT) {
    const int ly = 2 + t / (C0 - 4), lx = 2 + t % (C0 - 4);
    const int i = oy + ly, j = ox + lx;
    float r1 = 0.f;
    if (interior(i, j, H)) {
      float d;
      r1 = fs[ly * C0 + lx] - apply_level<T, BIM>(u1s + ly * C0 + lx, C0, qs + ly * SQ + lx,
                                                   SQ, s9, HH, (size_t)i * H + j, k, d);
    }
    fs[ly * C0 + lx] = r1;
  }
  __syncthreads();

  if (tid < CX * CY) {
    const int cy = tid / CX, cx = tid % CX;
    const int I = I0 + cy, J = J0 + cx;
    if (I < Hc && J < Hc) {
      const bool cin = I >= 1 && I <= Hc - 2 && J >= 1 && J <= Hc - 2;
      fc[(size_t)I * Hc + J] =
          cin ? w4_restrict(fs + (2 * cy + 3) * C0 + 2 * cx + 3, C0, w4, HH,
                            (size_t)(2 * I) * H + 2 * J, H)
              : 0.f;
    }
  }
  float sums[1] = {rr};
  float* const outs[1] = {rsq};
  finish_sums<NT, 1>(sums, partial, done, outs);
}

// ---------------------------------------------------------------------------
// D2 as a row-streaming chain, for levels above D2_ONE_PASS_MAX_N; the same
// contract as the tile above, in both operator forms and both plane types.
// Design: elastic.cu's G2 chain with one scalar stream of u0 and f (the
// A2 chain of sweep.cu on common.cuh's helpers), in one barrier per step.
// A block owns fine columns [x0, x0 + BW), BW = RB - 4, and rows
// [y0, y0 + strip) (x0 and y0 even), so the coarse nodes [x0/2, (x0 +
// BW)/2) x [y0/2, (y0 + strip)/2); thread t works on columns c0 + e,
// e < RC, c0 = x0 - 2 + RC t.  Step s stages u0 row R = y0 - 3 + s into a
// ring of RNS slots; f, the operator (the phase row, or the 9 coefficient
// planes' rows, in dynamic shared memory) row R - 1 into a ring of D2_NF
// slots, which the sweep reads at once and the residual 2 rows later, so
// the planes are staged once for both; and the W4 rows of the residual's
// row R - 3 into a ring of RNS slots, w10 and w11 only when that row is odd
// (no other row reads them); all RD steps ahead, the planes with
// stage_plane (a plane need not start on a 16-byte boundary).  Then a
// thread
//   1. finishes the coarse node over its even column whose row sums
//      completed at step s - 1: (left + mid) + right, the left sum from its
//      left neighbour's shared row (common.cuh restrict_finish_w4);
//   2. computes r1 = f - A u1 at row rho = R - 3 from its window of u1 rows
//      rho - 1 .. rho + 1 (row rho + 1 from the shared u1 row of step s - 1)
//      and adds w r1 to its three row sums: its even column's, its odd
//      column's right sum (b = 0) and its left sum (b = 1) for the coarse
//      node of the thread on its right (restrict_rows_w4);
//   3. computes u1 = u0 + (omega / d) r0 at row i = R - 1 from its u0
//      window of rows i - 1 .. i + 1, stores it at the owned nodes, passes
//      it on through a shared u1 row and sums the owned r0^2.
// Each stage reads rows that the stage before finished at an earlier step;
// neither u1's halo nor r1 goes to device memory.  The rings, the u1 row
// and the row parity turn whole every D2_UNR steps (the main loop's
// unroll), so every slot is a constant; the element rows the residual reads
// are those the sweep read two steps before, kept in a 4-row register
// ring.  The operator and the weights are read as _apply_gen, the
// difference form and _w4_restrict order them; the Jacobi weight omega / d
// is div_normal's on the bi-material level (d is (2/3) of a positive sum of
// coefficients: the quotient `/` gives) and `/`'s on a general one.  The norm is summed over
// the owned nodes in a fixed order and the last block to finish adds the
// blocks' partials (finish_sums).
// ---------------------------------------------------------------------------
constexpr int D2_UNR = 6;  // steps per trip of the main loop
constexpr int D2_NF = 6;   // f / operator ring slots: the stages s - 3 .. s + RD
static_assert(D2_UNR % RNS == 0 && D2_UNR % D2_NF == 0 && D2_UNR % 2 == 0,
              "D2_UNR: whole ring turns");
static_assert(D2_NF >= RD + 4, "D2_NF: the f / operator ring");
// resident blocks per SM asked for: caps the registers at 102
constexpr int D2_MINB = 5;

// Elements of a staged row slot of T: the RW-element window from its
// aligned-down 16-byte start, whole chunks.
template <class T>
__host__ __device__ constexpr int row_slot() {
  constexpr int per = 16 / (int)sizeof(T);
  return (RW + 2 * (per - 1)) / per * per;
}

// _apply_gen's sum from the 9 coefficients s of a node and the 3 x 3
// window of rows um, u0, up (columns c - 1 .. c + 1).
__device__ __forceinline__ float gen_window(const float* um, const float* u0, const float* up,
                                            const float (&s)[9]) {
  const float t0 = (s[0] * um[0] + s[1] * um[1]) + s[2] * um[2];
  const float t1 = (s[3] * u0[0] + s[4] * u0[1]) + s[5] * u0[2];
  const float t2 = (s[6] * up[0] + s[7] * up[1]) + s[8] * up[2];
  return (t0 + t1) + t2;
}

// Dynamic shared memory of the row-streaming D2: the general operator's 9
// coefficient rows in D2_NF slots.
template <class T>
__host__ __device__ constexpr size_t d2_plane_smem(bool bim) {
  return bim ? 0 : sizeof(T) * 9 * D2_NF * row_slot<T>();
}

template <class T, bool BIM>
__global__ void __launch_bounds__(RT, D2_MINB)
d2_gen_descent_rows(const float* __restrict__ u, const float* __restrict__ f,
                    const int8_t* __restrict__ ph, const T* __restrict__ s9,
                    const T* __restrict__ w4, float* __restrict__ u1_out,
                    float* __restrict__ fc, float* __restrict__ partial,
                    unsigned* __restrict__ done, float* __restrict__ rsq, int strip, Coef k) {
  constexpr int BW = RB - 4;  // owned columns of a band
  constexpr int NF = D2_NF, TS = row_slot<T>(), ES = (int)sizeof(T);
  constexpr int XS = RB + 4;  // u1 rows: column p at entry p + 2
  __shared__ __align__(16) float us[RNS][RSLOT];
  __shared__ __align__(16) float fs[NF][RSLOT];
  __shared__ __align__(16) int8_t qs[BIM ? NF : 1][RSLOTQ];
  __shared__ __align__(16) T ws[4][RNS][TS];    // W4 rows of the residual's row
  __shared__ __align__(16) float u1r[2][XS];    // u1: the row of step s in s mod 2
  __shared__ float wl[2][RT + 1];               // left sums of step s, thread t's at t + 1
  extern __shared__ __align__(16) unsigned char dyn[];  // general: [9][NF][TS] plane rows
  const T* const ps = reinterpret_cast<const T*>(dyn);
  const int n = k.n, H = n + 1, Hc = n / 2 + 1, t = threadIdx.x;
  const int x0 = blockIdx.x * BW, y0 = blockIdx.y * strip;
  const int c0 = x0 - 2 + RC * t, col = x0 - 3, base = y0 - 3;
  const int rows_out = min(strip, H + 1 - y0);  // fine rows this strip restricts
  const int staged = rows_out + 5, steps = rows_out + 6;

  for (int e = t; e < 2 * XS; e += RT) (&u1r[0][0])[e] = 0.f;
  const unsigned ud = smem_addr(us), fd = smem_addr(fs), qd = smem_addr(qs);
  const unsigned wd = smem_addr(ws), pd = smem_addr(dyn);
  // stages step s (SJ = s mod D2_UNR): u row base + s into u slot SJ mod
  // RNS; f and the operator row base + s - 1 into slot SJ mod NF; the W4
  // rows of rho = base + s - 3 (odd when SJ is) into slot SJ mod RNS, from
  // the step that first reads them; always commits
  auto stage = [&](int s, auto S) {
    constexpr int SJ = decltype(S)::value;
    const bool live = s < staged, wlive = s >= 5 && s < steps;
    stage_window<4, RW>(ud + 4 * RSLOT * (SJ % RNS), u, base + s, H, H, col, live);
    stage_window<4, RW>(fd + 4 * RSLOT * (SJ % NF), f, base + s - 1, H, H, col, live);
    if (BIM) {
      stage_window<1, RWQ>(qd + RSLOTQ * (SJ % NF), ph, base + s - 1, n, n, col, live);
    } else {
#pragma unroll
      for (int p = 0; p < 9; ++p)
        stage_plane<ES, RW>(pd + ES * TS * (p * NF + SJ % NF), s9, p, base + s - 1, H, H, col,
                            live);
    }
#pragma unroll
    for (int p = 0; p < ((SJ & 1) ? 4 : 2); ++p)
      stage_plane<ES, RW>(wd + ES * TS * (p * RNS + SJ % RNS), w4, p, base + s - 3, H, H, col,
                          wlive);
    cp_commit();
  };
  static_for<RD>([&](auto S) { stage(decltype(S)::value, S); });

  // columns c0 - 1 .. c0 + RC interior; columns c0 .. c0 + RC - 1 owned by
  // the block; the coarse column centred on the even column c0 (-1: none)
  bool col_in[RC + 2], col_own[RC];
#pragma unroll
  for (int e = 0; e < RC + 2; ++e) col_in[e] = c0 - 1 + e >= 1 && c0 - 1 + e <= H - 2;
#pragma unroll
  for (int e = 0; e < RC; ++e) {
    const int p = RC * t + e;
    col_own[e] = p >= 2 && p < 2 + BW && c0 + e < H;
  }
  const int Jc = col_own[0] ? c0 / 2 : -1;

  float uw[3][RC + 2] = {};  // u0 rows i - 1 .. i + 1
  float qe[4][RC + 1] = {};  // element rows i - 4 .. i - 1 (rolled to i - 3 .. i at step s)
  float vw[3][RC + 2] = {};  // u1 rows rho - 1 .. rho + 1
  float u1o[RC] = {};                          // u1's own columns of the last step
  // row sums of the coarse row in progress and of the one completed: the
  // even column's, the odd column's right sum and its left sum
  float acc[3] = {}, dn[3] = {};
  float rr = 0.f;
  bool pending = false;  // a coarse row completed at the previous step
  // A u at the centre of the u rows w[0 .. 2] (columns e .. e + 2) with the
  // element rows qa, qb (bi-material) or the node's coefficients sv[.][e]
  // (general); d: the Jacobi diagonal
  auto apply_at = [&](const float (&w)[3][RC + 2], int e, const float* qa, const float* qb,
                      const float (&sv)[9][RC], float& d) {
    if constexpr (BIM) {
      float c4;
      const float au =
          apply_window<true, 1>(w[0] + e, w[1] + e, w[2] + e, qa + e, qb + e, k, c4);
      d = K23 * c4;
      return au;
    } else {
      const float s[9] = {sv[0][e], sv[1][e], sv[2][e], sv[3][e], sv[4][e],
                          sv[5][e], sv[6][e], sv[7][e], sv[8][e]};
      d = guard_d(s[4]);
      return gen_window(w[0] + e, w[1] + e, w[2] + e, s);
    }
  };
  // the general operator's 9 coefficients of row `row` at the thread's
  // columns, from ring slot fslot
  auto coefficients = [&](float (&sv)[9][RC], int fslot, int row) {
    if constexpr (!BIM) {
#pragma unroll
      for (int p = 0; p < 9; ++p)
        read_row<RC>(sv[p], ps + (p * NF + fslot) * TS, p * H + row, H, col, RC * t + 1);
    }
  };
  // step s (u and W4 slot s mod RNS, f / operator slot s mod NF, u1 and wl
  // slot s mod 2)
  auto step = [&](int s, auto S) {
    constexpr int I = decltype(S)::value;
    constexpr int slot = I % RNS, xb = I % 2, xp = (I + 1) % 2;
    // f / operator slots of rows i and rho (staged 2 steps earlier)
    constexpr int fnow = I % NF, frho = (I + NF - 2) % NF;
    constexpr bool odd = (I & 1) != 0;  // rho = y0 - 6 + s (y0 and D2_UNR even)
    if (s >= steps) return;
    cp_wait<RD - 1>();
    __syncthreads();
    const int R = base + s, i = R - 1, rho = i - 2;

    if (pending)  // 1. coarse row (rho - 2) / 2 from the sums of step s - 1
      restrict_finish_w4(fc, (rho - 2) >> 1, Hc, Jc, wl[xp][t], dn[0], dn[1]);
    pending = odd && s >= 6;  // completes coarse row (rho - 1) / 2 (rho > y0)

    {  // 2. r1 at row rho from u1 rows rho - 1 .. rho + 1 (zero off the interior)
      float nv[RC + 2];
      nv[0] = u1r[xp][RC * t + 1];
      nv[RC + 1] = u1r[xp][RC * t + RC + 2];
#pragma unroll
      for (int e = 0; e < RC; ++e) nv[e + 1] = u1o[e];
      roll<RC + 2>(vw, nv);
      float sv[9][RC];
      coefficients(sv, frho, rho);
      float fr[RC], r1[RC];
      read_row<RC>(fr, fs[frho], rho, H, col, RC * t + 1);
      const bool r_in = rho >= 1 && rho <= H - 2;
#pragma unroll
      for (int e = 0; e < RC; ++e) {
        float d;  // element rows rho - 1 = i - 3, rho
        const float au = apply_at(vw, e, qe[1], qe[2], sv, d);
        r1[e] = r_in && col_in[e + 1] ? fr[e] - au : 0.f;
      }
      // the weights of row rho at columns c0, c0 + 1: a = 0 (w00, w01) and,
      // at odd rho, a = 1 (w10, w11)
      float w[4][RC] = {};
#pragma unroll
      for (int p = 0; p < (odd ? 4 : 2); ++p)
        read_row<RC>(w[p], ws[p][slot], p * H + rho, H, col, RC * t + 1);
      const float r3[3] = {r1[0], r1[1], r1[1]};
      const float w0[3] = {w[0][0], w[0][1], w[1][1]};
      const float w1[3] = {w[2][0], w[2][1], w[3][1]};
      restrict_rows_w4<odd, 3>(acc, dn, r3, w0, w1);
      if (pending) wl[xb][t + 1] = dn[2];
    }

    {  // 3. u1 = u0 + (omega / d) r0 at row i from u0 rows i - 1 .. i + 1
      float un[RC + 2];
      read_row<RC + 2>(un, us[slot], R, H, col, RC * t);
      roll<RC + 2>(uw, un);
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
      float sv[9][RC];
      coefficients(sv, fnow, i);
      float fv[RC];
      read_row<RC>(fv, fs[fnow], i, H, col, RC * t + 1);
      const bool i_in = i >= 1 && i <= H - 2, i_own = i >= y0 && i < y0 + strip && i < H;
#pragma unroll
      for (int e = 0; e < RC; ++e) {
        float d;
        const float au = apply_at(uw, e, qe[2], qe[3], sv, d);
        const bool in = i_in && col_in[e + 1];
        const float r0 = in ? fv[e] - au : 0.f;
        const float u0 = uw[1][e + 1];
        u1o[e] = in ? u0 + (BIM ? div_normal(k.omega, d) : k.omega / d) * r0 : u0;
        rr += i_own && col_own[e] ? r0 * r0 : 0.f;
      }
      *reinterpret_cast<float2*>(&u1r[xb][RC * t + 2]) = make_float2(u1o[0], u1o[1]);
      if (i_own) {
        float* orow = u1_out + (size_t)i * H + c0;
#pragma unroll
        for (int e = 0; e < RC; ++e)
          if (col_own[e]) orow[e] = u1o[e];
      }
    }
    // step s + RD reuses the u and W4 slot of step s - 1 and the f /
    // operator slot of step s - 4, whose last readers ran at step s - 1
    stage(s + RD, std::integral_constant<int, (I + RD) % D2_UNR>{});
  };
  for (int s0 = 0; s0 < steps; s0 += D2_UNR)
    static_for<D2_UNR>([&](auto S) { step(s0 + decltype(S)::value, S); });
  __syncthreads();
  if (pending)  // the strip's last coarse row, completed at its last step
    restrict_finish_w4(fc, (base + steps - 5) >> 1, Hc, Jc, wl[(steps - 1) & 1][t], dn[0],
                       dn[1]);
  float sums[1] = {rr};
  float* const outs[1] = {rsq};
  finish_sums<RT, 1>(sums, partial, done, outs);
}

// ---------------------------------------------------------------------------
// D3: W4 prolongation-add + one sweep: u3 = sweep(u + P uc).
// Replaces multigrid_feanet_tpu/ops/pallas_general.py:303 _gpsweep_kernel.
// Bound: bytes.  Per fine node it must read u, f (8 B), the operator (the
// phase, ~1 B, or 9 planes), the 4 W4 planes and a quarter node of uc
// (1 B), and write u3 (4 B): bi-material 30 / 22 B/node (f32 / bf16
// planes), general 65 / 39 B/node; ~55 flops/node.  Design: u + P uc is
// built in the shared u tile over the tile and its 1-node halo (the halo's
// prolongation recomputed per tile) and never stored.
// ---------------------------------------------------------------------------
template <class T, bool BIM>
__global__ void __launch_bounds__(NT)
d3_gen_ascent(const float* __restrict__ u, const float* __restrict__ f,
              const int8_t* __restrict__ ph, const T* __restrict__ s9,
              const T* __restrict__ w4, const float* __restrict__ uc,
              float* __restrict__ out, Coef k) {
  constexpr int SU = TX + 2, RU = TY + 2;  // u tile: nodes [y0-1, y0+TY]
  constexpr int SQ = TX + 1, RQ = TY + 1;  // Q tile: elements [y0-1, y0+TY)
  __shared__ float us[RU * SU];
  __shared__ float qs[BIM ? RQ * SQ : 1];
  const int H = k.n + 1, Hc = k.n / 2 + 1;
  const size_t HH = (size_t)H * H;
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const int tid = threadIdx.y * TX + threadIdx.x;

  for (int t = tid; t < RU * SU; t += NT) {
    const int i = y0 - 1 + t / SU, j = x0 - 1 + t % SU;
    float v = 0.f;
    if (i >= 0 && i < H && j >= 0 && j < H) {
      const size_t g = (size_t)i * H + j;
      v = u[g];
      if (interior(i, j, H)) v += w4_prolong(uc, Hc, w4, HH, g, i, j);
    }
    us[t] = v;
  }
  if (BIM) {
    for (int t = tid; t < RQ * SQ; t += NT)
      qs[t] = elem_q(ph, k.n, y0 - 1 + t / SQ, x0 - 1 + t % SQ, k);
  }
  __syncthreads();

  const int i = y0 + threadIdx.y, j = x0 + threadIdx.x;
  if (i < H && j < H) {
    const int ly = threadIdx.y + 1, lx = threadIdx.x + 1;
    const size_t g = (size_t)i * H + j;
    float r = 0.f, d = 1.f;
    if (interior(i, j, H))
      r = f[g] - apply_level<T, BIM>(us + ly * SU + lx, SU, qs + ly * SQ + lx, SQ, s9, HH, g,
                                     k, d);
    out[g] = us[ly * SU + lx] + (k.omega / d) * r;
  }
}

// ---------------------------------------------------------------------------
// D4: zero-initial-guess descent leg: u1 = (omega/d) f at interior nodes
// (never stored), fc = P^T (f - A u1).
// Replaces multigrid_feanet_tpu/ops/pallas_general.py:362 _zgwrr_kernel.
// Bound: bytes.  Per fine node it must read f (4 B), the 9 planes and the
// 4 W4 planes (52 B f32 / 26 B bf16) and write a quarter node of fc (1 B):
// 57 / 31 B/node; ~25 flops/node.  Design: the tiles of sweep.cu's A3; u1
// is computed pointwise into shared memory, its residual overwrites f there.
// ---------------------------------------------------------------------------
template <class T>
__global__ void __launch_bounds__(NT)
d4_gen_zdescent(const float* __restrict__ f, const T* __restrict__ s9,
                const T* __restrict__ w4, float* __restrict__ fc, Coef k) {
  __shared__ float fs[R0 * C0];
  __shared__ float u1s[R0 * C0];
  const int H = k.n + 1, Hc = k.n / 2 + 1;
  const size_t HH = (size_t)H * H;
  const int I0 = blockIdx.y * CY, J0 = blockIdx.x * CX;
  const int oy = 2 * I0 - 3, ox = 2 * J0 - 3;
  const int tid = threadIdx.x;

  for (int t = tid; t < R0 * C0; t += NT) {
    const int i = oy + t / C0, j = ox + t % C0;
    fs[t] = (i >= 0 && i < H && j >= 0 && j < H) ? f[(size_t)i * H + j] : 0.f;
    u1s[t] = 0.f;
  }
  __syncthreads();

  for (int t = tid; t < (R0 - 2) * (C0 - 2); t += NT) {
    const int ly = 1 + t / (C0 - 2), lx = 1 + t % (C0 - 2);
    const int i = oy + ly, j = ox + lx;
    if (!interior(i, j, H)) continue;
    const float d = guard_d(ld(s9 + 4 * HH + (size_t)i * H + j));
    u1s[ly * C0 + lx] = (k.omega / d) * fs[ly * C0 + lx];
  }
  __syncthreads();

  for (int t = tid; t < (R0 - 4) * (C0 - 4); t += NT) {
    const int ly = 2 + t / (C0 - 4), lx = 2 + t % (C0 - 4);
    const int i = oy + ly, j = ox + lx;
    float r1 = 0.f;
    if (interior(i, j, H)) {
      float d;
      r1 = fs[ly * C0 + lx] - apply_gen(u1s + ly * C0 + lx, C0, s9, HH, (size_t)i * H + j, d);
    }
    fs[ly * C0 + lx] = r1;
  }
  __syncthreads();

  if (tid < CX * CY) {
    const int cy = tid / CX, cx = tid % CX;
    const int I = I0 + cy, J = J0 + cx;
    if (I < Hc && J < Hc) {
      const bool cin = I >= 1 && I <= Hc - 2 && J >= 1 && J <= Hc - 2;
      fc[(size_t)I * Hc + J] =
          cin ? w4_restrict(fs + (2 * cy + 3) * C0 + 2 * cx + 3, C0, w4, HH,
                            (size_t)(2 * I) * H + 2 * J, H)
              : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// D5: zero-initial-guess ascent leg: u2 = (omega/d) f + P uc at interior
// nodes, then one sweep of u2.
// Replaces multigrid_feanet_tpu/ops/pallas_general.py:411 _zgpsweep_kernel.
// Bound: bytes.  Per fine node it must read f (4 B), the 9 planes and the
// 4 W4 planes (52 B f32 / 26 B bf16) and a quarter node of uc (1 B), and
// write u (4 B): 61 / 35 B/node; ~30 flops/node.  Design: u2 is built in
// the shared tile over the tile and its 1-node halo and never stored.
// ---------------------------------------------------------------------------
template <class T>
__global__ void __launch_bounds__(NT)
d5_gen_zascent(const float* __restrict__ f, const T* __restrict__ s9,
               const T* __restrict__ w4, const float* __restrict__ uc,
               float* __restrict__ out, Coef k) {
  constexpr int SU = TX + 2, RU = TY + 2;  // u2 tile: nodes [y0-1, y0+TY]
  __shared__ float us[RU * SU];
  const int H = k.n + 1, Hc = k.n / 2 + 1;
  const size_t HH = (size_t)H * H;
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const int tid = threadIdx.y * TX + threadIdx.x;

  for (int t = tid; t < RU * SU; t += NT) {
    const int i = y0 - 1 + t / SU, j = x0 - 1 + t % SU;
    float v = 0.f;
    if (interior(i, j, H)) {
      const size_t g = (size_t)i * H + j;
      const float d = guard_d(ld(s9 + 4 * HH + g));
      v = (k.omega / d) * f[g] + w4_prolong(uc, Hc, w4, HH, g, i, j);
    }
    us[t] = v;
  }
  __syncthreads();

  const int i = y0 + threadIdx.y, j = x0 + threadIdx.x;
  if (i < H && j < H) {
    const size_t g = (size_t)i * H + j;
    const float* U = us + (threadIdx.y + 1) * SU + threadIdx.x + 1;
    float r = 0.f, d = 1.f;
    if (interior(i, j, H)) r = f[g] - apply_gen(U, SU, s9, HH, g, d);
    out[g] = U[0] + (k.omega / d) * r;
  }
}

// ---------------------------------------------------------------------------
// Host-side launches, one per coefficient type.
// ---------------------------------------------------------------------------

template <class T>
void launch_gsweep(int mode, cudaStream_t st, const float* u, const float* f, const void* s9,
                   float* out, float* partial, const Coef& k) {
  const dim3 g = fine_grid(k.n), b(TX, TY);
  const T* s = static_cast<const T*>(s9);
  if (mode == 0) d1_gen_relax<T, 0><<<g, b, 0, st>>>(u, f, s, out, partial, k);
  else d1_gen_relax<T, 1><<<g, b, 0, st>>>(u, f, s, out, partial, k);
}

// The row-streaming D2 of one form and plane type, opted in (once) to its
// dynamic shared memory.
template <class T, bool BIM>
const void* d2_kernel() {
  const void* kern = (const void*)d2_gen_descent_rows<T, BIM>;
  static const bool opted = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)d2_plane_smem<T>(BIM)) == cudaSuccess;
  (void)opted;
  return kern;
}

template <class T, bool BIM>
void launch_gswrr_form(bool one_pass, dim3 g, cudaStream_t st, const float* u, const float* f,
                       const int8_t* ph, const T* s, const T* w, float* u1, float* fc,
                       float* partial, unsigned* done, float* rsq, int strip, const Coef& k) {
  if (one_pass) {
    d2_gen_descent<T, BIM><<<g, NT, 0, st>>>(u, f, ph, s, w, u1, fc, partial, done, rsq, k);
  } else {
    d2_kernel<T, BIM>();
    d2_gen_descent_rows<T, BIM><<<g, RT, d2_plane_smem<T>(BIM), st>>>(
        u, f, ph, s, w, u1, fc, partial, done, rsq, strip, k);
  }
}

template <class T>
void launch_gswrr(int bim, bool one_pass, dim3 g, cudaStream_t st, const float* u,
                  const float* f, const int8_t* ph, const void* s9, const void* w4, float* u1,
                  float* fc, float* partial, unsigned* done, float* rsq, int strip,
                  const Coef& k) {
  const T* s = static_cast<const T*>(s9);
  const T* w = static_cast<const T*>(w4);
  if (bim)
    launch_gswrr_form<T, true>(one_pass, g, st, u, f, ph, s, w, u1, fc, partial, done, rsq,
                               strip, k);
  else
    launch_gswrr_form<T, false>(one_pass, g, st, u, f, ph, s, w, u1, fc, partial, done, rsq,
                                strip, k);
}

template <class T>
void launch_gpsweep(int bim, cudaStream_t st, const float* u, const float* f, const int8_t* ph,
                    const void* s9, const void* w4, const float* uc, float* out,
                    const Coef& k) {
  const dim3 g = fine_grid(k.n), b(TX, TY);
  const T* s = static_cast<const T*>(s9);
  const T* w = static_cast<const T*>(w4);
  if (bim) d3_gen_ascent<T, true><<<g, b, 0, st>>>(u, f, ph, s, w, uc, out, k);
  else d3_gen_ascent<T, false><<<g, b, 0, st>>>(u, f, ph, s, w, uc, out, k);
}

}  // namespace

extern "C" {

// D1.  mode 0: out = sweep(u); 1: out = masked residual.
// rsq[0] = interior ||f - A u||^2.  partial: mg_partials(0, n) floats.
int mg_gsweep(const float* u, const float* f, const void* s9, float* out, float* partial,
              float* rsq, int n, double omega, int bf16, int mode, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const Coef k = make_coef(n, 0.0, 0.0, omega);
  if (bf16) launch_gsweep<__nv_bfloat16>(mode, st, u, f, s9, out, partial, k);
  else launch_gsweep<float>(mode, st, u, f, s9, out, partial, k);
  const dim3 g = fine_grid(n);
  reduce_kernel<<<1, NT, 0, st>>>(partial, (int)(g.x * g.y), rsq);
  return (int)cudaGetLastError();
}

// D2.  u1 = sweep(u), fc = P^T (f - A u1), rsq[0] = interior ||f - A u||^2.
// Operator: the phase ph (bim) or the planes s9.  The launch geometry of
// ops/general.py::d2_launch_tiles: one-pass tiles when one_pass, else
// row-streaming strips of `strip` rows, on gx x gy blocks; scratch of gx gy
// partial sums and a zeroed counter that the last block resets.
// cudaErrorInvalidValue for a geometry D2 does not take.
int mg_gswrr(const float* u, const float* f, const int8_t* ph, const void* s9, const void* w4,
             float* u1, float* fc, float* partial, unsigned* done, float* rsq, int n, double a0,
             double da, double omega, int bim, int bf16, int one_pass, int strip, int gx, int gy,
             void* stream) {
  // the grid of ops/general.py::d2_launch_tiles: E2's chain without conv layers
  if (!descent_grid_ok(n, 0, one_pass != 0, strip, gx, gy)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const Coef k = make_coef(n, a0, da, omega);
  const dim3 g(gx, gy);
  if (bf16)
    launch_gswrr<__nv_bfloat16>(bim, one_pass != 0, g, st, u, f, ph, s9, w4, u1, fc, partial,
                                done, rsq, strip, k);
  else
    launch_gswrr<float>(bim, one_pass != 0, g, st, u, f, ph, s9, w4, u1, fc, partial, done, rsq,
                        strip, k);
  return (int)cudaGetLastError();
}

// Blocks of the row-streaming D2 in one form and plane type that one SM
// holds at once (with the general form's dynamic shared memory): what
// ops/general.py balances the strip height against.  Negative on a CUDA
// error.
int mg_gswrr_occupancy(int bim, int bf16) {
  const void* kern = bf16 ? (bim ? d2_kernel<__nv_bfloat16, true>()
                                 : d2_kernel<__nv_bfloat16, false>())
                          : (bim ? d2_kernel<float, true>() : d2_kernel<float, false>());
  const size_t smem = bf16 ? d2_plane_smem<__nv_bfloat16>(bim) : d2_plane_smem<float>(bim);
  int blocks = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, RT, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

// D3.  out = sweep(u + P uc).
int mg_gpsweep(const float* u, const float* f, const int8_t* ph, const void* s9,
               const void* w4, const float* uc, float* out, int n, double a0, double da,
               double omega, int bim, int bf16, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const Coef k = make_coef(n, a0, da, omega);
  if (bf16) launch_gpsweep<__nv_bfloat16>(bim, st, u, f, ph, s9, w4, uc, out, k);
  else launch_gpsweep<float>(bim, st, u, f, ph, s9, w4, uc, out, k);
  return (int)cudaGetLastError();
}

// D4.  fc = P^T (f - A u1), u1 = (omega/d) f at interior nodes.
int mg_zgwrr(const float* f, const void* s9, const void* w4, float* fc, int n, double omega,
             int bf16, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const Coef k = make_coef(n, 0.0, 0.0, omega);
  const dim3 g = coarse_grid(n), b(NT, 1);
  if (bf16)
    d4_gen_zdescent<__nv_bfloat16><<<g, b, 0, st>>>(
        f, static_cast<const __nv_bfloat16*>(s9), static_cast<const __nv_bfloat16*>(w4), fc, k);
  else
    d4_gen_zdescent<float><<<g, b, 0, st>>>(
        f, static_cast<const float*>(s9), static_cast<const float*>(w4), fc, k);
  return (int)cudaGetLastError();
}

// D5.  out = sweep(u2), u2 = (omega/d) f + P uc at interior nodes.
int mg_zgpsweep(const float* f, const void* s9, const void* w4, const float* uc, float* out,
                int n, double omega, int bf16, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const Coef k = make_coef(n, 0.0, 0.0, omega);
  const dim3 g = fine_grid(n), b(TX, TY);
  if (bf16)
    d5_gen_zascent<__nv_bfloat16><<<g, b, 0, st>>>(
        f, static_cast<const __nv_bfloat16*>(s9), static_cast<const __nv_bfloat16*>(w4), uc,
        out, k);
  else
    d5_gen_zascent<float><<<g, b, 0, st>>>(
        f, static_cast<const float*>(s9), static_cast<const float*>(w4), uc, out, k);
  return (int)cudaGetLastError();
}

}  // extern "C"

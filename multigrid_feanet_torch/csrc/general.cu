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
// Design common to all five (as sweep.cu): one thread per output node (D1,
// D3, D5) or one block per tile of coarse nodes (D2, D4); each block stages
// the u / f / Q tile it needs, with its halo, in shared memory and
// recomputes the halo overlap instead of the TPU's sequential grid carry.
// Coefficient and weight planes are aligned to the node they belong to, so
// each thread reads its own from device memory (coalesced along rows) and
// they need no shared tile.  The interior residual norm^2 (D1, D2) is summed
// per block in a fixed order and the partials by one fixed-order pass: no
// float atomics, so norms repeat run to run.
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
// (f32 / bf16 planes), general 65 / 39 B/node; ~100 flops/node.  Design:
// the tiles of sweep.cu's A2 (a 3-node u0 halo for two applies and the
// restriction stencil); u1 and its residual never leave shared memory.
// ---------------------------------------------------------------------------
template <class T, bool BIM>
__global__ void __launch_bounds__(NT)
d2_gen_descent(const float* __restrict__ u, const float* __restrict__ f,
               const int8_t* __restrict__ ph, const T* __restrict__ s9,
               const T* __restrict__ w4, float* __restrict__ u1_out,
               float* __restrict__ fc, float* __restrict__ partial, Coef k) {
  constexpr int SQ = C0 - 1, RQ = R0 - 1;
  __shared__ float us[R0 * C0];
  __shared__ float fs[R0 * C0];
  __shared__ float u1s[R0 * C0];
  __shared__ float qs[BIM ? RQ * SQ : 1];
  __shared__ float red[NT / 32];
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
  rr = block_sum(rr, red);
  if (tid == 0) partial[blockIdx.y * gridDim.x + blockIdx.x] = rr;
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

template <class T>
void launch_gswrr(int bim, cudaStream_t st, const float* u, const float* f, const int8_t* ph,
                  const void* s9, const void* w4, float* u1, float* fc, float* partial,
                  const Coef& k) {
  const dim3 g = coarse_grid(k.n), b(NT, 1);
  const T* s = static_cast<const T*>(s9);
  const T* w = static_cast<const T*>(w4);
  if (bim) d2_gen_descent<T, true><<<g, b, 0, st>>>(u, f, ph, s, w, u1, fc, partial, k);
  else d2_gen_descent<T, false><<<g, b, 0, st>>>(u, f, ph, s, w, u1, fc, partial, k);
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
// Operator: the phase ph (bim) or the planes s9.  partial: mg_partials(1, n).
int mg_gswrr(const float* u, const float* f, const int8_t* ph, const void* s9, const void* w4,
             float* u1, float* fc, float* partial, float* rsq, int n, double a0, double da,
             double omega, int bim, int bf16, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const Coef k = make_coef(n, a0, da, omega);
  if (bf16) launch_gswrr<__nv_bfloat16>(bim, st, u, f, ph, s9, w4, u1, fc, partial, k);
  else launch_gswrr<float>(bim, st, u, f, ph, s9, w4, u1, fc, partial, k);
  const dim3 g = coarse_grid(n);
  reduce_kernel<<<1, NT, 0, st>>>(partial, (int)(g.x * g.y), rsq);
  return (int)cudaGetLastError();
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

// The passes that the JAX package leaves to XLA's fusion inside its compiled
// loops, each as one kernel for Hopper.  None of them is a Pallas kernel in
// the JAX package: XLA fuses each into one program (HeatSolver.march's
// lax.scan, the round-1 solve's while_loop, solve_ir's jitted outer step),
// and the port ran each as a chain of eager torch ops over the whole grid.
//
// X1  the heat right-hand side
//       b = M_h u - (1 - theta) dt K u + dt M_h (theta f1 + (1 - theta) f0)
//     (multigrid_feanet_tpu/ops/heat.py:124 HeatSolver.rhs): M_h the
//     consistent mass stencil h^2 MASS_KERNEL, K the stiffness operator in
//     bitplane form (a0 S9 + da sum_e bit_e(pid) S4_e) or the homogeneous
//     (3, 3) stencil; computed in the f's type, float32 or float64 (the
//     problem's), from u float32, bf16 (the bf16 march) or float64 (with
//     float64 f), b in u's type.
// X2  the x4 full-weighting restriction f_c = 4 FW(r)
//     (multigrid_feanet_tpu/ops/transfer.py:38 restrict_full_weighting, as
//     solvers/pallas_mg.py:138 calls it): (n+1)^2 -> (n/2+1)^2 float32, zero
//     on the coarse ring.
// X3  the prolongation-add u + geo * P(u_c)
//     (multigrid_feanet_tpu/ops/transfer.py:61 prolong_bilinear and the add of
//     solvers/pallas_mg.py:140-141).
// X4  solve_ir's outer step (multigrid_feanet_tpu/solvers/pallas_mg.py:313
//     _outer64): u' = u + e geo, r = f - A u' in float64 (A the homogeneous
//     (3, 3) stencil or the two-phase bitplane form), r as float32, and the
//     interior sum of r^2 in float64.
//
// Every field is compact row-major (n+1) x (n+1); pid the int8 node pattern
// ids (bit e: the phase of the node's element e, in the order SW, SE, NW,
// NE), or absent when homogeneous.  Zero ghosts outside the grid, as F.pad
// gives the plain versions.
//
// Arithmetic.  Each kernel follows its plain version (ops/passes.py) op for
// op, with the rounding intrinsics (__fadd_rn, __fmul_rn, __dadd_rn, ...),
// which the compiler never contracts into fused multiply-adds: X2 and X3
// equal their plain versions bit for bit (the round-1 cell is held to the
// parent's residual history exactly), and X1 and X4 round where their plain
// versions round.  X4's sum is taken per block in a fixed order and the last
// block to finish adds the blocks' sums in a fixed order (no float atomics),
// so two launches agree bitwise.
//
// Bounds at 4097^2 (bytes, 3.35 TB/s): X1 reads u, f0, f1, pid and writes b
// (f0 and f1 the same tensor in the time-independent march: read once); X2
// reads the fine interior and writes the coarse field; X3 reads u, u_c and
// geo and writes u; X4 reads u, e, f, geo (and pid) and writes u' and the
// float32 r.  Design: plain tiles of 32 x 8 outputs, 256 threads, one
// output a thread, neighbouring threads on neighbouring columns (coalesced
// rows).  X1 and X4 stage their tile and its one-node halo in shared memory
// (X1: u and the mixed source; X4: u' = u + e geo, formed as it is staged);
// X2 and X3 read through the cache, their reuse being the 3 x 3 and 2 x 2
// neighbourhoods of stride-2 reads.  Making them fast is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace {

constexpr int PX = 32, PY = 8, PNT = PX * PY;  // output tile, threads per block
constexpr int SX = PX + 2, SY = PY + 2;        // the tile with its halo

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ double load_f(const double* p) { return *p; }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store_f(double* p, double x) { *p = x; }
// a float64 value into float32 or bf16 storage as torch's .to() rounds it:
// to float32, then (bf16) to bf16
__device__ __forceinline__ void store_f(float* p, double x) { *p = __double2float_rn(x); }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, double x) {
  *p = __float2bfloat16_rn(__double2float_rn(x));
}

// The rounding intrinsics in the arithmetic type A (float or double).
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// The taps of the two-phase bitplane form (ops/stencil.py UNIT_S9 and
// UNIT_S4), in the order of their dicts: S9's offsets in the order of first
// appearance over the quadrants, each quadrant's (centre, row edge, column
// edge, corner).  Offsets are (row, column).
__device__ __forceinline__ int s9_dr(int t) {
  constexpr int v[9] = {0, -1, 0, -1, 0, -1, 1, 1, 1};
  return v[t];
}
__device__ __forceinline__ int s9_dc(int t) {
  constexpr int v[9] = {0, 0, -1, -1, 1, 1, 0, -1, 1};
  return v[t];
}
__device__ __forceinline__ int s4_dr(int e, int t) {
  constexpr int v[4][4] = {{0, -1, 0, -1}, {0, -1, 0, -1}, {0, 1, 0, 1}, {0, 1, 0, 1}};
  return v[e][t];
}
__device__ __forceinline__ int s4_dc(int e, int t) {
  constexpr int v[4][4] = {{0, 0, -1, -1}, {0, 0, 1, 1}, {0, 0, -1, -1}, {0, 0, 1, 1}};
  return v[e][t];
}

// ---------------------------------------------------------------------------
// X1
// ---------------------------------------------------------------------------

// The weights of X1 in its arithmetic type A, as the plain version rounds
// them (a Python scalar multiplies a field in the field's type): the mass
// stencil h^2 MASS_KERNEL (row-major), the homogeneous stiffness stencil
// (row-major), S9's taps in dict order, S4's (centre, edge, corner), a0, da,
// theta, 1 - theta, (1 - theta) dt and dt.
template <typename A>
struct RhsW {
  A m[9], k[9], s9[9], c4, e4, d4, a0, da, th, th1, c, dt;
};

// sum_t w_t x(offset_t) in the plain version's order, from 0: the stencil
// apply of ops/stencil.py apply_stencil (out = 0; out = out + w * shifted).
template <typename A>
__device__ __forceinline__ A stencil9(const A (*s)[SX], int y, int x, const A* w) {
  A acc = 0;
#pragma unroll
  for (int dr = 0; dr < 3; ++dr)
#pragma unroll
    for (int dc = 0; dc < 3; ++dc)
      acc = add_rn(acc, mul_rn(w[3 * dr + dc], s[y + dr - 1][x + dc - 1]));
  return acc;
}

// T: u's and b's storage; A: the f's type, in which b is computed.
template <typename T, typename A, bool BIM>
__global__ void __launch_bounds__(PNT)
x1_heat_rhs(const T* __restrict__ u, const A* __restrict__ f0, const A* __restrict__ f1,
            const int8_t* __restrict__ pid, T* __restrict__ out, int H, RhsW<A> w) {
  __shared__ A su[SY][SX], sf[SY][SX];
  const int x0 = blockIdx.x * PX, y0 = blockIdx.y * PY;
  for (int t = threadIdx.x; t < SX * SY; t += PNT) {
    const int ly = t / SX, lx = t % SX, i = y0 + ly - 1, j = x0 + lx - 1;
    A a = 0, b = 0;
    if (i >= 0 && i < H && j >= 0 && j < H) {
      const long long e = (long long)i * H + j;
      a = (A)load_f(u + e);
      // f_mix = theta f1 + (1 - theta) f0, as the plain version mixes it
      b = add_rn(mul_rn(w.th, f1[e]), mul_rn(w.th1, f0[e]));
    }
    su[ly][lx] = a;
    sf[ly][lx] = b;
  }
  __syncthreads();
  const int lx = threadIdx.x % PX + 1, ly = threadIdx.x / PX + 1;
  const int i = y0 + ly - 1, j = x0 + lx - 1;
  if (i >= H || j >= H) return;
  const A mu = stencil9<A>(su, ly, lx, w.m);
  A ku;
  if (BIM) {
    // a0 S9(u) + sum_e (da bit_e) S4_e(u) (ops/stencil.py apply_stencil_bitplane)
    A s9 = 0;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const A v = mul_rn(w.s9[t], su[ly + s9_dr(t)][lx + s9_dc(t)]);
      s9 = t == 0 ? v : add_rn(s9, v);
    }
    ku = mul_rn(w.a0, s9);
    const int p = pid[(long long)i * H + j];
    const A tw[4] = {w.c4, w.e4, w.e4, w.d4};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      A s4 = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const A v = mul_rn(tw[t], su[ly + s4_dr(e, t)][lx + s4_dc(e, t)]);
        s4 = t == 0 ? v : add_rn(s4, v);
      }
      ku = add_rn(ku, mul_rn(mul_rn(w.da, (A)((p >> e) & 1)), s4));
    }
  } else {
    ku = stencil9<A>(su, ly, lx, w.k);
  }
  const A mf = stencil9<A>(sf, ly, lx, w.m);
  // mu - ((1 - theta) dt) K u + dt M f_mix
  const A b = add_rn(sub_rn(mu, mul_rn(w.c, ku)), mul_rn(w.dt, mf));
  store_f(out + (long long)i * H + j, b);
}

// ---------------------------------------------------------------------------
// X2, X3
// ---------------------------------------------------------------------------

// The (1, 2, 1) / 4 filter of three values, as restrict_full_weighting's
// _fw_1d_last rounds it: (a + 2 b) + c, then x 0.25.
__device__ __forceinline__ float fw3(float a, float b, float c) {
  return __fmul_rn(__fadd_rn(__fadd_rn(a, __fmul_rn(2.f, b)), c), 0.25f);
}

__global__ void __launch_bounds__(PNT)
x2_restrict(const float* __restrict__ r, float* __restrict__ fc, int H, int Hc) {
  const int J = blockIdx.x * PX + threadIdx.x % PX, I = blockIdx.y * PY + threadIdx.x / PX;
  if (I >= Hc || J >= Hc) return;
  float v = 0.f;
  if (I > 0 && J > 0 && I < Hc - 1 && J < Hc - 1) {
    // columns first (every fine row), then rows, then x 4
    float c[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float* row = r + (long long)(2 * I - 1 + d) * H + 2 * J;
      c[d] = fw3(row[-1], row[0], row[1]);
    }
    v = __fmul_rn(4.f, fw3(c[0], c[1], c[2]));
  }
  fc[(long long)I * Hc + J] = v;
}

// Row r of the coarse field upsampled along the columns at fine column j
// (prolong_bilinear's _up_1d_last): the coarse value at even j, the
// midpoint 0.5 (left + right) at odd j.
__device__ __forceinline__ float up_cols(const float* __restrict__ row, int j) {
  return (j & 1) ? __fmul_rn(0.5f, __fadd_rn(row[j >> 1], row[(j >> 1) + 1])) : row[j >> 1];
}

__global__ void __launch_bounds__(PNT)
x3_prolong_add(const float* __restrict__ u, const float* __restrict__ uc,
               const float* __restrict__ geo, float* __restrict__ out, int H, int Hc) {
  const int j = blockIdx.x * PX + threadIdx.x % PX, i = blockIdx.y * PY + threadIdx.x / PX;
  if (i >= H || j >= H) return;
  // columns first, then rows, then x geo, then u + the correction
  const float* lo = uc + (long long)(i >> 1) * Hc;
  const float p = (i & 1) ? __fmul_rn(0.5f, __fadd_rn(up_cols(lo, j), up_cols(lo + Hc, j)))
                          : up_cols(lo, j);
  const long long e = (long long)i * H + j;
  out[e] = __fadd_rn(u[e], __fmul_rn(p, geo[e]));
}

// ---------------------------------------------------------------------------
// X4
// ---------------------------------------------------------------------------

// The weights of X4 in float64: the homogeneous stencil (row-major), or
// S9's taps in dict order and S4's (centre, edge, corner) with a0 and da.
struct OuterW {
  double k[9], s9[9], c4, e4, d4, a0, da;
};

template <bool BIM, typename TE>
__global__ void __launch_bounds__(PNT)
x4_outer_step(const double* __restrict__ u, const TE* __restrict__ e,
              const double* __restrict__ f, const double* __restrict__ geo,
              const int8_t* __restrict__ pid, double* __restrict__ u_out, float* __restrict__ r32,
              double* __restrict__ partial, unsigned* __restrict__ done,
              double* __restrict__ rsq, int H, OuterW w) {
  __shared__ double su[SY][SX];
  __shared__ double wsum[PNT / 32];
  __shared__ bool last;
  const int x0 = blockIdx.x * PX, y0 = blockIdx.y * PY;
  for (int t = threadIdx.x; t < SX * SY; t += PNT) {
    const int ly = t / SX, lx = t % SX, i = y0 + ly - 1, j = x0 + lx - 1;
    double v = 0.0;
    if (i >= 0 && i < H && j >= 0 && j < H) {
      const long long k = (long long)i * H + j;
      v = __dadd_rn(u[k], __dmul_rn((double)load_f(e + k), geo[k]));  // u + e geo
    }
    su[ly][lx] = v;
  }
  __syncthreads();
  const int lx = threadIdx.x % PX + 1, ly = threadIdx.x / PX + 1;
  const int i = y0 + ly - 1, j = x0 + lx - 1;
  double sq = 0.0;
  if (i < H && j < H) {
    double au;
    if (BIM) {
      double s9 = 0.0;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const double v = __dmul_rn(w.s9[t], su[ly + s9_dr(t)][lx + s9_dc(t)]);
        s9 = t == 0 ? v : __dadd_rn(s9, v);
      }
      au = __dmul_rn(w.a0, s9);
      const int p = pid[(long long)i * H + j];
      const double tw[4] = {w.c4, w.e4, w.e4, w.d4};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        double s4 = 0.0;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const double v = __dmul_rn(tw[t], su[ly + s4_dr(q, t)][lx + s4_dc(q, t)]);
          s4 = t == 0 ? v : __dadd_rn(s4, v);
        }
        au = __dadd_rn(au, __dmul_rn(__dmul_rn(w.da, (double)((p >> q) & 1)), s4));
      }
    } else {
      au = 0.0;
#pragma unroll
      for (int dr = 0; dr < 3; ++dr)
#pragma unroll
        for (int dc = 0; dc < 3; ++dc)
          au = __dadd_rn(au, __dmul_rn(w.k[3 * dr + dc], su[ly + dr - 1][lx + dc - 1]));
    }
    const long long k = (long long)i * H + j;
    const double r = __dsub_rn(f[k], au);
    u_out[k] = su[ly][lx];
    r32[k] = __double2float_rn(r);
    if (i > 0 && j > 0 && i < H - 1 && j < H - 1) sq = __dmul_rn(r, r);
  }
  // the block's sum in a fixed order: each warp by shuffles, then the warps
  // in order; the last block adds the blocks' sums in a fixed order
  for (int o = 16; o > 0; o >>= 1) sq = __dadd_rn(sq, __shfl_down_sync(0xffffffffu, sq, o));
  const int t = threadIdx.x, m = gridDim.x * gridDim.y, b = blockIdx.y * gridDim.x + blockIdx.x;
  if ((t & 31) == 0) wsum[t >> 5] = sq;
  __syncthreads();
  if (t == 0) {
    double s = 0.0;
    for (int k = 0; k < PNT / 32; ++k) s = __dadd_rn(s, wsum[k]);
    partial[b] = s;
    __threadfence();
    last = atomicAdd(done, 1u) == (unsigned)(m - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  __shared__ double dred[PNT];
  double acc = 0.0;
  for (int k = t; k < m; k += PNT) acc = __dadd_rn(acc, __ldcg(partial + k));
  dred[t] = acc;
  __syncthreads();
  for (int o = PNT / 2; o > 0; o >>= 1) {
    if (t < o) dred[t] = __dadd_rn(dred[t], dred[t + o]);
    __syncthreads();
  }
  if (t == 0) {
    rsq[0] = dred[0];
    *done = 0u;
  }
}

inline dim3 grid_of(int H) { return dim3((H + PX - 1) / PX, (H + PY - 1) / PY); }

inline bool aligned(const void* p, int bytes) { return ((uintptr_t)p % bytes) == 0; }

// One X1 launch with u and b of type T and the f's and weights of type A.
template <typename T, typename A>
int x1_launch(const void* u, const void* f0, const void* f1, const int8_t* pid, void* out,
              int H, const void* w, cudaStream_t st) {
  RhsW<A> k;
  static_assert(sizeof(RhsW<A>) == 36 * sizeof(A), "RhsW is 36 numbers");
  memcpy(&k, w, sizeof(k));
  const dim3 g = grid_of(H);
  if (pid)
    x1_heat_rhs<T, A, true><<<g, PNT, 0, st>>>((const T*)u, (const A*)f0, (const A*)f1, pid,
                                               (T*)out, H, k);
  else
    x1_heat_rhs<T, A, false><<<g, PNT, 0, st>>>((const T*)u, (const A*)f0, (const A*)f1, pid,
                                                (T*)out, H, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// X1.  out = the heat right-hand side of u, f0 and f1 on an (n+1)^2 grid;
// pid null for the homogeneous stencil.  u_type: u and out float32 (0),
// bf16 (1) or float64 (2, with f64).  f64: f0, f1 and w float64 (else
// float32), the type b is computed in.  w: 36 numbers, the fields of RhsW in
// order.
int px_heat_rhs(const void* u, const void* f0, const void* f1, const int8_t* pid, void* out,
                int n, const void* w, int u_type, int f64, void* stream) {
  if (n < 1 || !u || !f0 || !f1 || !out || !w || u_type < 0 || u_type > 2 ||
      (u_type == 2 && !f64))
    return (int)cudaErrorInvalidValue;
  const int H = n + 1;
  const cudaStream_t st = (cudaStream_t)stream;
  using B = __nv_bfloat16;
  if (u_type == 2) return x1_launch<double, double>(u, f0, f1, pid, out, H, w, st);
  if (f64)
    return u_type ? x1_launch<B, double>(u, f0, f1, pid, out, H, w, st)
                  : x1_launch<float, double>(u, f0, f1, pid, out, H, w, st);
  return u_type ? x1_launch<B, float>(u, f0, f1, pid, out, H, w, st)
                : x1_launch<float, float>(u, f0, f1, pid, out, H, w, st);
}

// X2.  fc ((n/2+1)^2) = 4 FW(r) (r: (n+1)^2), zero on the coarse ring.
int px_restrict(const float* r, float* fc, int n, void* stream) {
  if (n < 2 || n % 2 || !r || !fc) return (int)cudaErrorInvalidValue;
  const int Hc = n / 2 + 1;
  x2_restrict<<<grid_of(Hc), PNT, 0, (cudaStream_t)stream>>>(r, fc, n + 1, Hc);
  return (int)cudaGetLastError();
}

// X3.  out ((n+1)^2) = u + geo P(uc) (uc: (n/2+1)^2).
int px_prolong_add(const float* u, const float* uc, const float* geo, float* out, int n,
                   void* stream) {
  if (n < 2 || n % 2 || !u || !uc || !geo || !out) return (int)cudaErrorInvalidValue;
  x3_prolong_add<<<grid_of(n + 1), PNT, 0, (cudaStream_t)stream>>>(u, uc, geo, out, n + 1,
                                                                   n / 2 + 1);
  return (int)cudaGetLastError();
}

// X4.  u_out = u + e geo; r32 = f - A u_out; rsq[0] = interior sum r^2;
// pid null for the homogeneous stencil; e float32, or bf16 when bf16_e (the
// correction of a bf16 hierarchy).  w: 23 doubles, the fields of OuterW in
// order.  partial holds one double per block, ceil((n+1)/32) x
// ceil((n+1)/8); done is a zeroed counter that the last block resets.
int px_outer_step(const double* u, const void* e, const double* f, const double* geo,
                  const int8_t* pid, double* u_out, float* r32, double* partial, unsigned* done,
                  double* rsq, int n, const double* w, int bf16_e, void* stream) {
  if (n < 1 || !u || !e || !f || !geo || !u_out || !r32 || !partial || !done || !rsq || !w ||
      !aligned(u, 8) || !aligned(f, 8) || !aligned(geo, 8) || !aligned(u_out, 8))
    return (int)cudaErrorInvalidValue;
  OuterW k;
  static_assert(sizeof(OuterW) == 23 * sizeof(double), "OuterW is 23 doubles");
  memcpy(&k, w, sizeof(OuterW));
  const int H = n + 1;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 g = grid_of(H);
  using B = __nv_bfloat16;
  if (pid && bf16_e)
    x4_outer_step<true, B><<<g, PNT, 0, st>>>(u, (const B*)e, f, geo, pid, u_out, r32, partial,
                                              done, rsq, H, k);
  else if (pid)
    x4_outer_step<true, float><<<g, PNT, 0, st>>>(u, (const float*)e, f, geo, pid, u_out, r32,
                                                  partial, done, rsq, H, k);
  else if (bf16_e)
    x4_outer_step<false, B><<<g, PNT, 0, st>>>(u, (const B*)e, f, geo, pid, u_out, r32, partial,
                                               done, rsq, H, k);
  else
    x4_outer_step<false, float><<<g, PNT, 0, st>>>(u, (const float*)e, f, geo, pid, u_out, r32,
                                                   partial, done, rsq, H, k);
  return (int)cudaGetLastError();
}

}  // extern "C"

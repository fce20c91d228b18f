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
// X5  the learned restriction (multigrid_feanet_tpu/models/intergrid.py:65
//     restrict_learned: the pattern split, the crop, a VALID stride-2 3 x 3
//     correlation with the (C, 3, 3) kernels, the zero ring, x w[0]) as its
//     per-node form: f_c(I, J) = w[0] sum_{a,b} k[pid(y, x), a, b] r(y, x),
//     y = 2I - 1 + a, x = 2J - 1 + b, on coarse interior nodes, 0 on the
//     ring; the weights of each FINE node's pattern id (the split masks the
//     fine values).
// X6  the learned prolongation-add (multigrid_feanet_tpu/models/intergrid.py:82
//     prolong_learned, the stride-2 transposed convolution, padding 1, of the
//     split coarse correction, and the add of learned_v_cycle:112) in gather
//     form: out(p, q) = u(p, q) + w[1] sum k[pid_c(c, d), t, s] v(c, d) over
//     p = 2c + t - 1, q = 2d + s - 1; the weights of each COARSE node's
//     pattern id.  An even fine index takes tap 1 of one coarse node, an odd
//     one taps 0 and 2 of its two neighbours.
//     X5 and X6 take a batch of N fields (blockIdx.z), rows compact, samples
//     any number of values apart; the (C, 9) weights and w are read from
//     device memory (no host read per call); an id no channel holds adds 0,
//     as the split's comparison puts it in no channel; pid null (a
//     homogeneous level) takes channel 0 of one.
// X7  the backward of X5 (no TPU kernel: the gradient JAX's value_and_grad
//     takes through the convolution of restrict_learned): from the gradient
//     g_c of f_c, grad_r(p) = w[0] sum k[pid(p), a, b] g_c(I, J) over the
//     coarse interior nodes (I, J) whose window holds p at tap (a, b), 0 on
//     the fine ring (the crop), and each block's partial sums of
//     P[c][a, b] = sum [pid(p) = c] g_c(I, J) r(p) over its coarse cells.
// X8  the backward of X6: from the gradient g of out, grad_v(c, d) = w[1]
//     sum_{t,s} k[pid_c(c, d), t, s] g(2c + t - 1, 2d + s - 1) (the adjoint of
//     X6's gather, its restriction-shaped transpose; g zero off the grid),
//     and each block's partial sums of Q[c][t, s] = sum [pid_c = c] v g(..).
//     grad u = g needs no kernel.
// X9  the weight gradients from X7's or X8's partial sums: P = the sum of
//     the blocks' partials, grad_k = w[i] P and grad_w[i] = sum k P (i = 0
//     for X7, 1 for X8), grad_w[1 - i] = 0.
//     The partial sums go by pattern id: each lane of X7 and X8 keeps its
//     nine products a tap in running sums while its ids stay, and its warp
//     adds them into its own row of shared sums when an id changes and at
//     the end of its strip (a (slot, id) pair one lane holds alone by that
//     lane, each other id its lanes hold, in the order of their first lane,
//     by a transposing warp sum); the block adds its warps' rows in order,
//     and X9 adds the blocks' partials in float64 in a fixed order: no float
//     atomics, two runs agree bitwise.
//
// Every field is compact row-major (n+1) x (n+1); pid the int8 node pattern
// ids (bit e: the phase of the node's element e, in the order SW, SE, NW,
// NE), or absent when homogeneous.  Zero ghosts outside the grid, as F.pad
// gives the plain versions.
//
// Arithmetic.  Each kernel follows its plain version (ops/passes.py) op for
// op, with the rounding intrinsics (__fadd_rn, __fmul_rn, __dadd_rn, ...),
// which the compiler never contracts into fused multiply-adds: X1 (in both
// designs), X2, X3 and X6 equal their plain versions bit for bit (the
// round-1 cell is held to the parent's residual history exactly), and X4
// rounds where its plain version rounds; X5's chain of fused multiply-adds
// (__fmaf_rn), which its plain version takes in float64, differs from it
// only where that double rounding meets a float32 tie.  X5 and X6 sum in
// the order the JAX package's convolutions take on the CPU (X5 fused, in
// XLA's nine partial sums; X6 in reverse tap order, its kernel being
// flipped there).
// X4's sum is taken per block in a fixed order and the last block to finish
// adds the blocks' sums in a fixed order (no float atomics), so two
// launches agree bitwise.
//
// X7 and X8 sum grad_r and grad_v from 0 in tap order, the weight w[i]
// last, as their plain versions do (bit for bit); their weight sums and X9
// round in another order than the plain versions' float64 sums, and agree
// with them to the float32 rounding of a few hundred terms a sum.
//
// Bounds at 4097^2 (bytes, 3.35 TB/s): X1 reads u, f0, f1, pid and writes b
// (f0 and f1 the same tensor in the time-independent march: read once); X2
// reads the fine interior and writes the coarse field; X3 reads u, u_c and
// geo and writes u; X4 reads u, e, f, geo (and pid) and writes u' and the
// float32 r; X5 reads the fine interior and pid and writes f_c; X6 reads u,
// v and pid_c and writes u (per sample; pid once); X7 reads g_c, r and pid
// and writes grad_r; X8 reads g, v and pid_c and writes grad_v (the partial
// sums are a few hundred kB).  Design: plain tiles of
// 32 x 8 outputs, 256 threads, one output a thread, neighbouring threads on
// neighbouring columns (coalesced rows); X6 a thread per coarse cell, its
// 2 x 2 fine nodes.  X1 and X4 stage their tile and its one-node halo in
// shared memory (X1: u and the mixed source; X4: u' = u + e geo, formed as
// it is staged); X2, X3, X5 and X6 read through the cache, their reuse
// being the 3 x 3 and 2 x 2 neighbourhoods of stride-2 reads (X5 and X6
// stage only their weight table).  Above a size (ops/passes.py
// X1_ONE_PASS_MAX_N) X1 streams rows instead (x1_heat_rhs_rows, below): the
// tile reads u and f about 1.33 times over, pays a division per staged node
// and overlaps none of its loads with its arithmetic, which bounds X1 by
// its instructions about as much as by its bytes.  X7 and X8 stream rows
// over the batch (x7_learned_restrict_bwd_rows, x8_learned_prolong_bwd_rows:
// a warp a band of 32 columns and a strip of the batch's coarse rows laid
// end to end, the row before carried from step to step) so that a launch
// of many small samples fills the card with short chains and a large field
// fills whole waves, and they bin their weight products per lane in
// registers: a warp sum only where an id changes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cstring>

#include "common.cuh"

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
// s: rows of W values; (y, x) the centre.
template <typename A, int W>
__device__ __forceinline__ A stencil9(const A (*s)[W], int y, int x, const A* w) {
  A acc = 0;
#pragma unroll
  for (int dr = 0; dr < 3; ++dr)
#pragma unroll
    for (int dc = 0; dc < 3; ++dc)
      acc = add_rn(acc, mul_rn(w[3 * dr + dc], s[y + dr - 1][x + dc - 1]));
  return acc;
}

// b at (y, x) of the windows su (u) and sf (the mixed source f_mix), rows of
// W values, in the plain version's order: M u - ((1 - theta) dt) K u +
// dt M f_mix, K u = a0 S9(u) + sum_e (da bit_e) S4_e(u) (ops/stencil.py
// apply_stencil_bitplane) from the pattern id p when BIM, else the
// homogeneous stencil.  The factor da bit_e is taken as da or dz = da x 0,
// the two values the plain version's product gives it.  The weights that
// repeat are read from one place (ops/passes.py checks that they repeat):
// the mass stencil's corner m[0] and edge m[1], and S9's neighbour taps and
// S4's corner as s9[1], so that a thread's outputs share the products of
// one weight with one node.
template <typename A, bool BIM, int W>
__device__ __forceinline__ A rhs_at(const A (*su)[W], const A (*sf)[W], int y, int x, int p,
                                    const RhsW<A>& w, A dz) {
  const A m[9] = {w.m[0], w.m[1], w.m[0], w.m[1], w.m[4], w.m[1], w.m[0], w.m[1], w.m[0]};
  const A mu = stencil9(su, y, x, m);
  A ku;
  if (BIM) {
    A s9 = 0;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const A v = mul_rn(w.s9[t == 0 ? 0 : 1], su[y + s9_dr(t)][x + s9_dc(t)]);
      s9 = t == 0 ? v : add_rn(s9, v);
    }
    ku = mul_rn(w.a0, s9);
    const A tw[4] = {w.c4, w.e4, w.e4, w.s9[1]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      A s4 = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const A v = mul_rn(tw[t], su[y + s4_dr(e, t)][x + s4_dc(e, t)]);
        s4 = t == 0 ? v : add_rn(s4, v);
      }
      ku = add_rn(ku, mul_rn((p >> e) & 1 ? w.da : dz, s4));
    }
  } else {
    ku = stencil9(su, y, x, w.k);
  }
  const A mf = stencil9(sf, y, x, m);
  // mu - ((1 - theta) dt) K u + dt M f_mix
  return add_rn(sub_rn(mu, mul_rn(w.c, ku)), mul_rn(w.dt, mf));
}

// The one-pass tile.  T: u's and b's storage; A: the f's type, in which b
// is computed.
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
  const long long e = (long long)i * H + j;
  store_f(out + e, rhs_at<A, BIM>(su, sf, ly, lx, BIM ? pid[e] : 0, w, mul_rn(w.da, (A)0)));
}

// ---------------------------------------------------------------------------
// X1, row streaming (common.cuh's row-streaming helpers and block shape).
//
// A block of RT threads owns a band of RB columns (RC adjacent columns a
// thread) and marches down a strip of rows, as A1 does (sweep.cu).  Step s
// stages row y0 - 1 + s of u and of the f's (f once when f0 and f1 are one
// tensor, as in the time-independent march) into a ring of RNS slots with
// cp.async, RD steps ahead of the row being read, and the pattern-id row of
// the row it computes (y0 - 2 + s: a byte row, read at the output nodes
// only, never with a halo).  Each thread keeps a 3 x (RC + 2) register
// window of u and of f_mix, mixing a node's source once as its row enters
// the window, and from step 2 on computes its RC outputs of row y0 - 2 + s
// with rhs_at, the tile's arithmetic: the row stream equals the tile and the
// plain version bit for bit.  The windows start one column left of the band
// and reach one right of it; columns off the grid read as zero (the plain
// version's ghosts), rows off it are zero-filled.  A warp wholly past the
// grid's last column (the last band of a 4097-node row holds one) stages but
// computes nothing.  The strip height and the grid come from ops/passes.py
// (x1_tiles, x1_strip), which balances them against the occupancy
// px_heat_rhs_occupancy reports.
// ---------------------------------------------------------------------------

// The ring slot of a row of T: the RW-value window after an offset of up to
// one 16-byte chunk, in whole chunks.
template <typename T>
__host__ __device__ constexpr int x1_slot() {
  constexpr int el = 16 / (int)sizeof(T);
  return (RW + el - 1 + el - 1) / el * el;
}

// Stages the window [col, col + RW) of row `row` of an H x H field of T
// into the slot at dst (common.cuh stage_window, which copies one chunk a
// thread).  A float64 window spans up to 130 chunks, so it goes in two
// parts: the 64 chunks from the window's aligned-down start (values col ..
// col + 126, and col + 127 when the window starts on a chunk), then the
// window from col + 128, whose aligned-down start lies 1024 bytes further.
template <typename T>
__device__ __forceinline__ void stage_x1_row(unsigned dst, const T* src, int row, int H, int col,
                                             bool live) {
  if constexpr (sizeof(T) == 8) {
    stage_window<8, 127>(dst, src, row, H, H, col, live);
    stage_window<8, RW - 128>(dst + 1024, src, row, H, H, col + 128, live);
  } else {
    static_assert((sizeof(T) * RW + 15) / 16 + 1 <= RT, "one chunk of a row per thread");
    stage_window<(int)sizeof(T), RW>(dst, src, row, H, H, col, live);
  }
}

// The RC + 2 values at window positions x .. x + RC + 1 of a staged row in
// the arithmetic type A, zero where `in` is false (columns off the grid).
template <typename A, typename T>
__device__ __forceinline__ void read_x1_row(A (&v)[RC + 2], const T* slot, int row, int H,
                                            int col, int x, const bool (&in)[RC + 2]) {
  const T* p = slot + win_off<T>(row, H, col) + x;
#pragma unroll
  for (int e = 0; e < RC + 2; ++e) v[e] = in[e] ? (A)load_f(p + e) : (A)0;
}

template <typename T, typename A, bool BIM, bool ONE_F>
__global__ void __launch_bounds__(RT)
x1_heat_rhs_rows(const T* __restrict__ u, const A* __restrict__ f0, const A* __restrict__ f1,
                 const int8_t* __restrict__ pid, T* __restrict__ out, int H, int strip,
                 RhsW<A> w) {
  __shared__ __align__(16) T us[RNS][x1_slot<T>()];
  __shared__ __align__(16) A fs[ONE_F ? 1 : 2][RNS][x1_slot<A>()];
  __shared__ __align__(16) int8_t ps[BIM ? RNS : 1][RSLOTQ];
  const int t = threadIdx.x, x0 = blockIdx.x * RB, y0 = blockIdx.y * strip, c0 = x0 + RC * t;
  const int col = x0 - 1, base = y0 - 1, steps = min(strip, H - y0) + 2;
  const bool warp_in = x0 + RC * 32 * (t >> 5) < H;
  bool in[RC + 2];  // columns c0 - 1 .. c0 + RC on the grid
#pragma unroll
  for (int e = 0; e < RC + 2; ++e) in[e] = (unsigned)(c0 - 1 + e) < (unsigned)H;

  // step s: u and f rows base + s and the pattern-id row base + s - 1 into
  // ring slot `slot`; always commits
  auto stage = [&](int s, int slot) {
    const bool live = s < steps;
    stage_x1_row(smem_addr(us[slot]), u, base + s, H, col, live);
    stage_x1_row(smem_addr(fs[0][slot]), f1, base + s, H, col, live);
    if constexpr (!ONE_F) stage_x1_row(smem_addr(fs[1][slot]), f0, base + s, H, col, live);
    if constexpr (BIM) stage_window<1, RB>(smem_addr(ps[slot]), pid, base + s - 1, H, H, x0, live);
    cp_commit();
  };
  for (int s = 0; s < RD; ++s) stage(s, s);

  A wu[3][RC + 2] = {}, wf[3][RC + 2] = {};
  const A dz = mul_rn(w.da, (A)0);
  auto step = [&](int s, auto S) {
    constexpr int slot = decltype(S)::value % RNS;
    if (s >= steps) return;
    cp_wait<RD - 1>();
    __syncthreads();
    const int row = base + s, i = row - 1;
    A un[RC + 2], fn[RC + 2];
    read_x1_row(un, us[slot], row, H, col, RC * t, in);
    read_x1_row(fn, fs[0][slot], row, H, col, RC * t, in);
    if constexpr (!ONE_F) {
      A f0n[RC + 2];
      read_x1_row(f0n, fs[1][slot], row, H, col, RC * t, in);
#pragma unroll
      for (int e = 0; e < RC + 2; ++e) fn[e] = add_rn(mul_rn(w.th, fn[e]), mul_rn(w.th1, f0n[e]));
    } else {
#pragma unroll
      for (int e = 0; e < RC + 2; ++e) fn[e] = add_rn(mul_rn(w.th, fn[e]), mul_rn(w.th1, fn[e]));
    }
    roll<RC + 2>(wu, un);
    roll<RC + 2>(wf, fn);
    if (s >= 2 && warp_in) {
      const int8_t* pp = ps[BIM ? slot : 0] + win_off<int8_t>(i, H, x0) + RC * t;
      T* orow = out + (size_t)i * H + c0;
#pragma unroll
      for (int e = 0; e < RC; ++e) {
        const A b = rhs_at<A, BIM>(wu, wf, 1, e + 1, BIM ? pp[e] : 0, w, dz);
        if (in[e + 1]) store_f(orow + e, b);
      }
    }
    // step s + RD reuses the slot of step s - 1
    stage(s + RD, (slot + RD) % RNS);
  };
  for (int s0 = 0; s0 < steps; s0 += RNS)
    static_for<RNS>([&](auto S) { step(s0 + decltype(S)::value, S); });
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

// ---------------------------------------------------------------------------
// X5, X6
// ---------------------------------------------------------------------------

// Channels a weight table may hold: every id an int8 pattern-id field holds.
constexpr int LK_MAX = 128;

// Stages the (C, 9) weights k, channel-major, into s; every thread of the
// block reaches the barrier.
__device__ __forceinline__ void stage_taps(float* s, const float* __restrict__ k, int C) {
  for (int t = threadIdx.x; t < 9 * C; t += PNT) s[t] = k[t];
  __syncthreads();
}

// Tap t of the kernel of pattern id p; 0 for an id no channel holds.
__device__ __forceinline__ float tap(const float* s, int p, int t, int C) {
  return (unsigned)p < (unsigned)C ? s[9 * p + t] : 0.f;
}

// f_c of sample blockIdx.z, as the plain version rounds it: each tap's
// product added by a fused multiply-add to one of nine partial sums
// (ops/passes.py x5_chain: index t C + p mod 8 over the first 8 floor(9 C /
// 8) indices, the rest in the ninth; all in the first where the launch has
// at most two coarse interior nodes), the nine summed ((0 + 1) + (4 + 5)) +
// ((2 + 3) + (6 + 7)) + 8, then x w[0].  sr, sf: the values between two
// samples of r and f_c.
__global__ void __launch_bounds__(PNT)
x5_learned_restrict(const float* __restrict__ r, const int8_t* __restrict__ pid,
                    const float* __restrict__ k, const float* __restrict__ w,
                    float* __restrict__ fc, int H, int Hc, int C, long long sr, long long sf) {
  __shared__ float sk[9 * LK_MAX];
  stage_taps(sk, k, C);
  const int J = blockIdx.x * PX + threadIdx.x % PX, I = blockIdx.y * PY + threadIdx.x / PX;
  if (I >= Hc || J >= Hc) return;
  float v = 0.f;
  if (I > 0 && J > 0 && I < Hc - 1 && J < Hc - 1) {
    const float* rb = r + (long long)blockIdx.z * sr;
    const int head = 9 * C - 9 * C % 8;  // the indices of the eight chains
    const bool single = gridDim.z <= 2 && Hc == 3;
    float kt[9], x[9];
    int chain[9];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const int t = 3 * a + b;
        const long long e = (long long)(2 * I - 1 + a) * H + 2 * J - 1 + b;
        const int p = pid ? pid[e] : 0, kx = t * C + p;
        chain[t] = single ? 0 : kx < head ? (kx & 7) : 8;
        kt[t] = tap(sk, p, t, C);
        x[t] = rb[e];
      }
    bool one = true;  // every product in one partial sum: the others add 0
#pragma unroll
    for (int t = 1; t < 9; ++t) one = one && chain[t] == chain[0];
    float sum = 0.f;
    if (!pid && !one) {  // one channel: tap t alone in sum t (t < 8), tap 8 in the ninth
      float m[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) m[t] = __fmul_rn(kt[t], x[t]);
      sum = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(m[0], m[1]), __fadd_rn(m[4], m[5])),
                                __fadd_rn(__fadd_rn(m[2], m[3]), __fadd_rn(m[6], m[7]))),
                      m[8]);
    } else if (one) {
#pragma unroll
      for (int t = 0; t < 9; ++t) sum = __fmaf_rn(kt[t], x[t], sum);
    } else {
      float acc[9];
#pragma unroll
      for (int q = 0; q < 9; ++q) acc[q] = 0.f;
#pragma unroll
      for (int t = 0; t < 9; ++t)
#pragma unroll
        for (int q = 0; q < 9; ++q)
          acc[q] = chain[t] == q ? __fmaf_rn(kt[t], x[t], acc[q]) : acc[q];
      sum = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[4], acc[5])),
                                __fadd_rn(__fadd_rn(acc[2], acc[3]), __fadd_rn(acc[6], acc[7]))),
                      acc[8]);
    }
    v = __fmul_rn(__ldg(w), sum);
  }
  fc[(long long)blockIdx.z * sf + (long long)I * Hc + J] = v;
}

// The product of tap (t, s) of coarse node (a, b) of a cell's 2 x 2 with
// its value, as X6 rounds it.
#define X6_TERM(a, b, t, s) __fmul_rn(tap(sk, p[a][b], 3 * (t) + (s), C), x[a][b])

// out of sample blockIdx.z, as the plain version rounds it: from 0 the
// products of the coarse nodes that reach a fine node, in reverse tap
// order, then u + w[1] x the sum.  A thread takes coarse cell (c, d), the
// fine nodes (2c + dy, 2d + dx) on the grid, from coarse nodes (c, d) ..
// (c + 1, d + 1): an even fine index takes tap 1 of its coarse node, an odd
// one tap 2 of the node before and tap 0 of the node after.  su, sv, so:
// the values between two samples of u, v and out.
__global__ void __launch_bounds__(PNT)
x6_learned_prolong_add(const float* __restrict__ u, const float* __restrict__ v,
                       const int8_t* __restrict__ pidc, const float* __restrict__ k,
                       const float* __restrict__ w, float* __restrict__ out, int H, int Hc,
                       int C, long long su, long long sv, long long so) {
  __shared__ float sk[9 * LK_MAX];
  stage_taps(sk, k, C);
  const int d = blockIdx.x * PX + threadIdx.x % PX, c = blockIdx.y * PY + threadIdx.x / PX;
  if (c >= Hc || d >= Hc) return;
  const bool odd_r = c + 1 < Hc, odd_c = d + 1 < Hc;  // fine row 2c + 1, column 2d + 1
  const float* vb = v + (long long)blockIdx.z * sv;
  float x[2][2];
  int p[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const bool in = (a == 0 || odd_r) && (b == 0 || odd_c);
      const long long e = (long long)(c + a) * Hc + d + b;
      x[a][b] = in ? vb[e] : 0.f;
      p[a][b] = in && pidc ? pidc[e] : 0;
    }
  const float w1 = __ldg(w + 1);
  const float* ub = u + (long long)blockIdx.z * su;
  float* ob = out + (long long)blockIdx.z * so;
  const long long e0 = (long long)(2 * c) * H + 2 * d, e1 = e0 + H;
  ob[e0] = __fadd_rn(ub[e0], __fmul_rn(w1, __fadd_rn(0.f, X6_TERM(0, 0, 1, 1))));
  if (odd_c)
    ob[e0 + 1] = __fadd_rn(ub[e0 + 1], __fmul_rn(w1, __fadd_rn(__fadd_rn(0.f, X6_TERM(0, 0, 1, 2)),
                                                                X6_TERM(0, 1, 1, 0))));
  if (odd_r)
    ob[e1] = __fadd_rn(ub[e1], __fmul_rn(w1, __fadd_rn(__fadd_rn(0.f, X6_TERM(0, 0, 2, 1)),
                                                        X6_TERM(1, 0, 0, 1))));
  if (odd_r && odd_c) {
    float acc = __fadd_rn(0.f, X6_TERM(0, 0, 2, 2));
    acc = __fadd_rn(acc, X6_TERM(0, 1, 2, 0));
    acc = __fadd_rn(acc, X6_TERM(1, 0, 0, 2));
    acc = __fadd_rn(acc, X6_TERM(1, 1, 0, 0));
    ob[e1 + 1] = __fadd_rn(ub[e1 + 1], __fmul_rn(w1, acc));
  }
}

#undef X6_TERM

// ---------------------------------------------------------------------------
// X7, X8, X9
// ---------------------------------------------------------------------------

// X7 and X8 stream rows over the batch: the batch's coarse rows laid end to
// end (row R is row R mod Hc of sample R / Hc), a warp takes a band of 32
// columns of coarse cells (X7) or nodes (X8) and walks a strip of `strip`
// of those rows, so that small levels fill whole warps and a launch covers
// the card with short chains.  Unit u = blockIdx.x WARPS + warp is band
// u mod nb of strip u / nb, nb = ceil(Hc / 32); the blocks' partial sums
// are X9's rows (bwd_blocks, ops/passes.py bwd_blocks).  A step loads the
// values of a later step before it computes its own (X8 the next step's,
// X7 the one after it), and the row before it comes from the step before.
// Each lane keeps its nine weight sums in registers while its ids stay as
// they were the step before; the warp adds them by id into its shared row
// (warp_bins) when some lane's id changes, and once at the end of its
// strip.
constexpr int WARPS = PNT / 32;
constexpr unsigned FULL = 0xffffffffu;

// Mask M of the transposing warp sum: lanes whose bit M is clear keep the
// first M / 2 of their first M values and send the others to the lane
// across, which keeps the others; each adds what it receives.
template <int M>
__device__ __forceinline__ void halve(float (&v)[16], bool hi) {
#pragma unroll
  for (int i = 0; i < M / 2; ++i) {
    const float send = hi ? v[i] : v[M / 2 + i];
    const float keep = hi ? v[M / 2 + i] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, M);
  }
}

// The sums over the warp's lanes of x[0 .. 8], in a fixed order, in 16
// shuffles: masks 16, 8, 4 and 2 halve the values a lane holds, mask 1 adds
// the pair; lanes 2t and 2t + 1 return the sum of x[t].
__device__ __forceinline__ float warp_sum9(const float (&x)[9]) {
  const int lane = threadIdx.x & 31;
  float v[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) v[t] = t < 9 ? x[t] : 0.f;
  halve<16>(v, lane & 16);
  halve<8>(v, lane & 8);
  halve<4>(v, lane & 4);
  halve<2>(v, lane & 2);
  return v[0] + __shfl_xor_sync(FULL, v[0], 1);
}

// The slot of tap t = 3 a + b among a lane's S ids: X7's fine node of the
// cell, 2 (a == 1) + (b == 1) (S = 4); X8's one id (S = 1).
template <int S>
__device__ __forceinline__ int slot_of(int t) {
  return S == 1 ? 0 : 2 * (t / 3 == 1) + (t % 3 == 1);
}

// Adds the lanes' running sums x[t] to the warp's row ws of shared sums
// (9 C floats), each under its lane's id q[slot_of<S>(t)].  A (slot, id)
// pair that one lane alone holds adds its taps' sums itself: no other lane
// adds to those entries.  Then for each id c in [0, C) that the lanes'
// other slots hold (in the order of the first lane and slot that holds it),
// the sums over the lanes of the taps under c (warp_sum9) go to ws[9 c + t].
// Every lane of the warp calls it; an id outside [0, C) adds nothing.
template <int S>
__device__ __forceinline__ void warp_bins(float* ws, const int (&q)[S], const float (&x)[9],
                                          int C) {
  const int lane = threadIdx.x & 31;
  unsigned todo = 0;  // the lane's slots not yet added
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const bool alone = __popc(__match_any_sync(FULL, q[s])) == 1;
    if ((unsigned)q[s] >= (unsigned)C) continue;
    if (!alone) {
      todo |= 1u << s;
      continue;
    }
#pragma unroll
    for (int t = 0; t < 9; ++t)
      if (slot_of<S>(t) == s) ws[9 * q[s] + t] += x[t];
  }
  for (unsigned lanes; (lanes = __ballot_sync(FULL, todo != 0)) != 0;) {
    int first = 0;
#pragma unroll
    for (int s = S - 1; s >= 0; --s) first = todo >> s & 1u ? q[s] : first;
    const int c = __shfl_sync(FULL, first, __ffs(lanes) - 1);
    unsigned hit = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) hit |= (unsigned)((todo >> s & 1u) && q[s] == c) << s;
    todo &= ~hit;
    float v[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) v[t] = hit >> slot_of<S>(t) & 1u ? x[t] : 0.f;
    const float sum = warp_sum9(v);
    if (!(lane & 1) && lane < 18) ws[9 * c + lane / 2] += sum;
  }
}

// The block's partial sums: its warps' rows (ws, WARPS rows of S floats)
// added in order into partial[blockIdx.x * S ..].
__device__ __forceinline__ void store_bins(const float* ws, int S, float* __restrict__ partial) {
  __syncthreads();
  for (int j = threadIdx.x; j < S; j += PNT) {
    float v = ws[j];
    for (int q = 1; q < WARPS; ++q) v += ws[q * S + j];
    partial[(long long)blockIdx.x * S + j] = v;
  }
}

// Dynamic shared memory of X7 and X8: the (C, 9) weights and a row of 9
// zeros (the weights of an id no channel holds: kernel_row), then WARPS
// rows of 9 C sums, zeroed; every thread reaches the barrier.
__device__ __forceinline__ void stage_bins(float* sk, float* ws, const float* __restrict__ k,
                                           int C) {
  for (int t = threadIdx.x; t < WARPS * 9 * C; t += PNT) ws[t] = 0.f;
  for (int t = threadIdx.x; t < 9 * C + 9; t += PNT) sk[t] = t < 9 * C ? k[t] : 0.f;
  __syncthreads();
}

inline size_t bins_smem(int C) { return sizeof(float) * 9 * (C + 1 + WARPS * C); }

// The weights of id p in stage_bins' table: its row, or the zero row.
__device__ __forceinline__ const float* kernel_row(const float* sk, int p, int C) {
  return sk + 9 * ((unsigned)p < (unsigned)C ? p : C);
}

// A warp's place in the batch: coarse row `row` of the sample whose fields
// start at the three pointers; next() steps to the next row, row 0 of the
// next sample after the last (a, b, o: the values between two samples).
struct BwdRow {
  int row;
  const float *a, *b;
  float* o;
  __device__ __forceinline__ BwdRow next(int Hc, long long sa, long long sb, long long so) const {
    return row + 1 < Hc ? BwdRow{row + 1, a, b, o} : BwdRow{0, a + sa, b + sb, o + so};
  }
};

// The warp's strip: (its first row, that row's first node's column in its
// band, its rows), or no rows; the same in every lane.
__device__ __forceinline__ BwdRow bwd_start(int Hc, int N, int strip, const float* a,
                                            const float* b, float* o, long long sa,
                                            long long sb, long long so, int& col, int& steps) {
  const int nb = (Hc + 31) / 32;
  const long long unit = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const long long R0 = unit / nb * strip, smp = R0 / Hc;
  col = (int)(unit % nb) * 32 + threadIdx.x % 32;
  steps = (int)max(0LL, min((long long)strip, (long long)N * Hc - R0));
  return BwdRow{(int)(R0 - smp * Hc), a + smp * sa, b + smp * sb, o + smp * so};
}

// X7 on its strip.  A thread takes coarse cell (I, J) of each row: fine
// rows 2I - 1 (I > 0) and 2I by columns 2J - 1 (J > 0) and 2J.  An even
// fine row takes tap a = 1 of coarse row I, an odd one taps a = 0 of row I
// and a = 2 of row I - 1 (columns likewise), so the cell holds nine (fine
// node, coarse node) pairs, one for each tap.  g_c is read as 0 off the
// coarse interior (X5 writes 0 there); its row I passes to the next step as
// row I - 1.  The lane's weight sums run while the ids of its four fine
// nodes stay; a node off the grid, whose products are 0, keeps the id
// before it.  sg, sr, so: the values between two samples of g_c, r and
// grad_r.
__global__ void __launch_bounds__(PNT)
x7_learned_restrict_bwd_rows(const float* __restrict__ g, const float* __restrict__ r,
                             const int8_t* __restrict__ pid, const float* __restrict__ k,
                             const float* __restrict__ w, float* __restrict__ gr,
                             float* __restrict__ partial, int H, int Hc, int C, int N, int strip,
                             long long sg, long long sr, long long so) {
  int J, steps;
  BwdRow at = bwd_start(Hc, N, strip, g, r, gr, sg, sr, so, J, steps);
  const bool live = J < Hc && steps > 0;
  bool cj[2];  // coarse columns J - 1 and J in the interior
#pragma unroll
  for (int j = 0; j < 2; ++j) cj[j] = live && J - 1 + j >= 1 && J - 1 + j <= Hc - 2;
  // g_c's row I at columns J - 1 and J, r and the ids at the cell's fine
  // nodes (2I - 1 + i, 2J - 1 + j) on the grid, of row `rw`
  auto fetch = [&](const BwdRow& rw, bool go, float (&gc)[2], float (&x)[2][2],
                   int (&p)[2][2]) {
    const int I = rw.row;
    const bool ci = go && I >= 1 && I <= Hc - 2;
#pragma unroll
    for (int j = 0; j < 2; ++j) gc[j] = ci && cj[j] ? rw.a[I * Hc + J - 1 + j] : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int y = 2 * I - 1 + i, xx = 2 * J - 1 + j, e = y * H + xx;
        const bool in = go && live && y >= 0 && xx >= 0;
        x[i][j] = in ? rw.b[e] : 0.f;
        p[i][j] = in && pid ? (int)pid[e] : 0;
      }
  };
  float gv[2][2];  // g_c at (I - 1 + i, J - 1 + j)
  float x[2][2];
  int p[2][2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
    gv[0][j] = cj[j] && at.row >= 2 && at.row <= Hc - 1 ? at.a[(at.row - 1) * Hc + J - 1 + j]
                                                        : 0.f;
  // the first two rows' loads run across the barrier; a step then loads the
  // row two after its own
  fetch(at, true, gv[1], x, p);
  BwdRow nx = at.next(Hc, sg, sr, so);
  float ngc[2], nxv[2][2];  // the next row's
  int np[2][2];
  fetch(nx, 1 < steps, ngc, nxv, np);
  extern __shared__ float smem[];
  float* sk = smem;
  float* ws = smem + 9 * (C + 1);
  stage_bins(sk, ws, k, C);
  if (steps > 0) {  // the warp's rows (the same in every lane)
    float* myws = ws + (threadIdx.x / 32) * 9 * C;
    const float w0 = __ldg(w);
    float sum[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) sum[t] = 0.f;
    int run[4] = {-1, -1, -1, -1};  // the ids the sums run under, by fine node 2 i + j
    for (int step = 0; step < steps; ++step) {
      const BwdRow nx2 = nx.next(Hc, sg, sr, so);
      float mgc[2], mxv[2][2];  // the row after the next
      int mp[2][2];
      fetch(nx2, step + 2 < steps, mgc, mxv, mp);
      const int I = at.row;
      int q[4];  // the fine nodes' ids; the run's off the grid
      bool moved = false;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int y = 2 * I - 1 + i, xx = 2 * J - 1 + j;
          const bool in = live && y >= 0 && xx >= 0;
          q[2 * i + j] = in ? p[i][j] : run[2 * i + j];
          moved = moved || (run[2 * i + j] >= 0 && q[2 * i + j] != run[2 * i + j]);
          const float* kp = kernel_row(sk, p[i][j], C);
          float acc = 0.f;
#pragma unroll
          for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int b = 0; b < 3; ++b)
              if ((a == 1) == (i == 1) && (b == 1) == (j == 1))
                acc = __fadd_rn(acc, __fmul_rn(kp[3 * a + b], gv[a != 2][b != 2]));
          const bool ring = y == 0 || xx == 0 || y == H - 1 || xx == H - 1;
          if (in) at.o[y * H + xx] = ring ? 0.f : __fmul_rn(w0, acc);
        }
      if (__any_sync(FULL, moved)) {
        warp_bins<4>(myws, run, sum, C);
#pragma unroll
        for (int t = 0; t < 9; ++t) sum[t] = 0.f;
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) run[t] = q[t];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b)
          sum[3 * a + b] = __fmaf_rn(gv[a != 2][b != 2], x[a == 1][b == 1], sum[3 * a + b]);
      // row 0 of a sample follows row Hc - 1 of g_c, which is 0
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        gv[0][j] = gv[1][j];
        gv[1][j] = ngc[j];
        ngc[j] = mgc[j];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          x[i][j] = nxv[i][j];
          nxv[i][j] = mxv[i][j];
          p[i][j] = np[i][j];
          np[i][j] = mp[i][j];
        }
      at = nx;
      nx = nx2;
    }
    warp_bins<4>(myws, run, sum, C);
  }
  store_bins(ws, 9 * C, partial);
}

// X8 on its strip.  A thread takes coarse node (c, d) of each row: the nine
// fine nodes (2c + t - 1, 2d + s - 1), g read as 0 off the grid.  Fine row
// 2c + 1 is row 2(c + 1) - 1 of the next row's node, so its three values
// pass to the next step and a step loads six.  The lane's weight sums run
// while its id pid_c(c, d) stays.  sg, sv, so: the values between two
// samples of g, v and grad_v.
__global__ void __launch_bounds__(PNT)
x8_learned_prolong_bwd_rows(const float* __restrict__ g, const float* __restrict__ v,
                            const int8_t* __restrict__ pidc, const float* __restrict__ k,
                            const float* __restrict__ w, float* __restrict__ gv,
                            float* __restrict__ partial, int H, int Hc, int C, int N, int strip,
                            long long sg, long long sv, long long so) {
  int d, steps;
  BwdRow at = bwd_start(Hc, N, strip, g, v, gv, sg, sv, so, d, steps);
  const bool live = d < Hc && steps > 0;
  // fine columns 2d - 1, 2d and 2d + 1 on the grid
  const bool col[3] = {live && d > 0, live, live && d < Hc - 1};
  // g at fine rows 2c and 2c + 1 (6 values), v and the id at (c, d), of row `rw`
  auto fetch = [&](const BwdRow& rw, bool go, float (&gm)[6], float& vc, int& p) {
    const int c = rw.row, e = 2 * c * H + 2 * d;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      gm[s] = go && col[s] ? rw.a[e + s - 1] : 0.f;
      gm[3 + s] = go && c < Hc - 1 && col[s] ? rw.a[e + H + s - 1] : 0.f;
    }
    const int ec = c * Hc + d;
    vc = go && live ? rw.b[ec] : 0.f;
    p = !(go && live) ? -1 : pidc ? (int)pidc[ec] : 0;
  };
  float gt[9];  // g at the nine fine nodes, rows 2c - 1, 2c, 2c + 1
  float vc;
  int p;
#pragma unroll
  for (int s = 0; s < 3; ++s)
    gt[s] = at.row > 0 && col[s] ? at.a[(2 * at.row - 1) * H + 2 * d + s - 1] : 0.f;
  {
    float gm[6];
    fetch(at, true, gm, vc, p);  // the first row's loads run across the barrier
#pragma unroll
    for (int s = 0; s < 6; ++s) gt[3 + s] = gm[s];
  }
  extern __shared__ float smem[];
  float* sk = smem;
  float* ws = smem + 9 * (C + 1);
  stage_bins(sk, ws, k, C);
  if (steps > 0) {  // the warp's rows (the same in every lane)
    float* myws = ws + (threadIdx.x / 32) * 9 * C;
    const float w1 = __ldg(w + 1);
    float sum[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) sum[t] = 0.f;
    int run[1] = {-1};  // the id the sums run under
    for (int step = 0; step < steps; ++step) {
      const BwdRow nx = at.next(Hc, sg, sv, so);
      float ngm[6], nvc;
      int np;
      fetch(nx, step + 1 < steps, ngm, nvc, np);
      const float* kp = kernel_row(sk, p, C);
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < 9; ++t) acc = __fadd_rn(acc, __fmul_rn(kp[t], gt[t]));
      if (live) at.o[at.row * Hc + d] = __fmul_rn(w1, acc);
      if (__any_sync(FULL, run[0] >= 0 && p != run[0])) {
        warp_bins<1>(myws, run, sum, C);
#pragma unroll
        for (int t = 0; t < 9; ++t) sum[t] = 0.f;
      }
      run[0] = p;
#pragma unroll
      for (int t = 0; t < 9; ++t) sum[t] = __fmaf_rn(vc, gt[t], sum[t]);
      // fine row 2c + 1 is the next row's 2c - 1 (row H, past a sample, is 0)
#pragma unroll
      for (int s = 0; s < 3; ++s) gt[s] = gt[6 + s];
#pragma unroll
      for (int s = 0; s < 6; ++s) gt[3 + s] = ngm[s];
      vc = nvc;
      p = np;
      at = nx;
    }
    warp_bins<1>(myws, run, sum, C);
  }
  store_bins(ws, 9 * C, partial);
}

constexpr int X9_THREADS = 1024, X9_LANES = 32, X9_GROUPS = X9_THREADS / X9_LANES;

// X9, one block: for each weight j < S, P[j] = the sum over the `blocks`
// rows of partial (row b at b S) in float64 (row group b mod X9_GROUPS
// first, then the groups in order), rounded to float32; gk[j] = w[which]
// P[j]; gw[which] = sum_j k[j] P[j] in float64 (by lane, then a shuffle
// tree), gw[1 - which] = 0.
__global__ void __launch_bounds__(X9_THREADS)
x9_weight_grad(const float* __restrict__ partial, int blocks, int S, const float* __restrict__ k,
               const float* __restrict__ w, int which, float* __restrict__ gk,
               float* __restrict__ gw) {
  __shared__ double red[X9_GROUPS][X9_LANES + 1];
  const int lane = threadIdx.x % X9_LANES, grp = threadIdx.x / X9_LANES;
  const float wi = __ldg(w + which);
  double kp = 0.0;
  for (int j0 = 0; j0 < S; j0 += X9_LANES) {
    const int j = j0 + lane;
    double acc = 0.0;
    if (j < S)
      for (int b = grp; b < blocks; b += X9_GROUPS) acc += (double)partial[(long long)b * S + j];
    red[grp][lane] = acc;
    __syncthreads();
    if (grp == 0 && j < S) {
      double sum = 0.0;
      for (int q = 0; q < X9_GROUPS; ++q) sum += red[q][lane];
      const float P = (float)sum;
      gk[j] = __fmul_rn(wi, P);
      kp += (double)k[j] * (double)P;
    }
    __syncthreads();
  }
  if (grp == 0) {
    for (int o = 16; o > 0; o >>= 1) kp += __shfl_down_sync(FULL, kp, o);
    if (lane == 0) {
      gw[which] = (float)kp;
      gw[1 - which] = 0.f;
    }
  }
}

inline dim3 grid_of(int H) { return dim3((H + PX - 1) / PX, (H + PY - 1) / PY); }

// X7's and X8's blocks on Hc x Hc coarse cells (nodes) of `batch` samples:
// nb = ceil(Hc / 32) bands by the strips of `strip` rows of the batch's
// batch Hc rows, WARPS units a block (ops/passes.py bwd_blocks).
inline long long bwd_blocks(int Hc, int batch, int strip) {
  const long long nb = (Hc + 31) / 32, ns = ((long long)batch * Hc + strip - 1) / strip;
  return (nb * ns + WARPS - 1) / WARPS;
}

// Whether X7 or X8 takes these operands: an even n, C channels (one without
// ids), `batch` samples at least a plane apart (sf: the field of (n + 1)^2,
// sc: of (n/2 + 1)^2 values a sample) and `blocks` the grid of strips of
// `strip` rows.
inline bool bwd_ok(int n, int C, bool ids, int batch, int strip, long long blocks, long long sf,
                   long long sc, long long so, long long oplane) {
  const int Hc = n / 2 + 1;
  // a sample's offsets are ints
  return n >= 2 && n % 2 == 0 && (long long)(n + 1) * (n + 1) <= INT_MAX && C >= 1 &&
         C <= LK_MAX && (ids || C == 1) && batch >= 1 && batch <= 65535 && strip >= 1 &&
         blocks <= INT_MAX &&
         blocks == bwd_blocks(Hc, batch, strip) && sf >= (long long)(n + 1) * (n + 1) &&
         sc >= (long long)Hc * Hc && so >= oplane;
}

inline bool aligned(const void* p, int bytes) { return ((uintptr_t)p % bytes) == 0; }

// Whether gx x gy blocks are X1's grid on H x H nodes: the tile's (one_pass),
// or row-streaming strips of `strip` rows (1 .. RS_STRIP_MAX) of bands of RB
// columns (ops/passes.py x1_tiles).
inline bool x1_grid_ok(int H, bool one_pass, int strip, int gx, int gy) {
  if (one_pass) return (unsigned)gx == grid_of(H).x && (unsigned)gy == grid_of(H).y;
  return strip >= 1 && strip <= RS_STRIP_MAX && gx == (H + RB - 1) / RB &&
         gy == (H + strip - 1) / strip;
}

// X1's instance of u type T and arithmetic type A: the tile's (one_pass) for
// pid or none, or the row stream's for pid or none and one f or two.
template <typename T, typename A>
const void* x1_of(bool one_pass, bool bim, bool one_f) {
  static_assert(sizeof(RhsW<A>) == 36 * sizeof(A), "RhsW is 36 numbers");
  if (one_pass)
    return bim ? (const void*)x1_heat_rhs<T, A, true> : (const void*)x1_heat_rhs<T, A, false>;
  const void* rows[2][2] = {{(const void*)x1_heat_rhs_rows<T, A, false, false>,
                             (const void*)x1_heat_rhs_rows<T, A, false, true>},
                            {(const void*)x1_heat_rhs_rows<T, A, true, false>,
                             (const void*)x1_heat_rhs_rows<T, A, true, true>}};
  return rows[bim][one_f];
}

// x1_of for px_heat_rhs's u_type and f64 (a pair it takes).
inline const void* x1_kernel(int u_type, int f64, bool one_pass, bool bim, bool one_f) {
  using B = __nv_bfloat16;
  if (u_type == 2) return x1_of<double, double>(one_pass, bim, one_f);
  if (f64)
    return u_type ? x1_of<B, double>(one_pass, bim, one_f)
                  : x1_of<float, double>(one_pass, bim, one_f);
  return u_type ? x1_of<B, float>(one_pass, bim, one_f)
                : x1_of<float, float>(one_pass, bim, one_f);
}

inline bool x1_types_ok(int u_type, int f64) {
  return u_type >= 0 && u_type <= 2 && (u_type != 2 || f64);
}

}  // namespace

extern "C" {

// X1.  out = the heat right-hand side of u, f0 and f1 on an (n+1)^2 grid;
// pid null for the homogeneous stencil.  u_type: u and out float32 (0),
// bf16 (1) or float64 (2, with f64).  f64: f0, f1 and w float64 (else
// float32), the type b is computed in.  w: 36 numbers, the fields of RhsW in
// order.  The launch geometry of ops/passes.py x1_launch_tiles: the one-pass
// tile when one_pass, else row-streaming strips of `strip` rows, on gx x gy
// blocks; the row stream stages f once when f0 == f1 and takes u, f0, f1 and
// pid on 16-byte boundaries.  cudaErrorInvalidValue for a geometry, a type or
// a pointer X1 does not take.
int px_heat_rhs(const void* u, const void* f0, const void* f1, const int8_t* pid, void* out,
                int n, const void* w, int u_type, int f64, int one_pass, int strip, int gx,
                int gy, void* stream) {
  int H = n + 1;
  if (n < 1 || !u || !f0 || !f1 || !out || !w || !x1_types_ok(u_type, f64) ||
      !x1_grid_ok(H, one_pass != 0, strip, gx, gy))
    return (int)cudaErrorInvalidValue;
  // the row stream's chunk offsets are ints of bytes into a field
  if (!one_pass && (!aligned(u, 16) || !aligned(f0, 16) || !aligned(f1, 16) ||
                    (pid && !aligned(pid, 16)) || (long long)(f64 ? 8 : 4) * H * H > INT_MAX))
    return (int)cudaErrorInvalidValue;
  void* wp = const_cast<void*>(w);
  void* tile_args[] = {&u, &f0, &f1, &pid, &out, &H, wp};
  void* rows_args[] = {&u, &f0, &f1, &pid, &out, &H, &strip, wp};
  cudaLaunchKernel(x1_kernel(u_type, f64, one_pass != 0, pid != nullptr, f0 == f1), dim3(gx, gy),
                   dim3(one_pass ? PNT : RT), one_pass ? tile_args : rows_args, 0,
                   (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// Blocks of the row-streaming X1 of one instance that one SM holds at once:
// what ops/passes.py balances the strip height against.  Negative on a CUDA
// error.
int px_heat_rhs_occupancy(int u_type, int f64, int bim, int one_f) {
  if (!x1_types_ok(u_type, f64)) return -(int)cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, x1_kernel(u_type, f64, false, bim != 0, one_f != 0), RT, 0);
  return err == cudaSuccess ? blocks : -(int)err;
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

// X5.  fc ((n/2+1)^2 a sample) = the learned restriction of r ((n+1)^2 a
// sample) with the (C, 3, 3) float32 kernels k and w[0] (w: 2 floats in
// device memory), pid the fine level's ids or null (then C is 1), for
// `batch` samples sr and sf values apart (rows compact).
int px_learned_restrict(const float* r, const int8_t* pid, const float* k, const float* w,
                        float* fc, int n, int C, int batch, long long sr, long long sf,
                        void* stream) {
  const int H = n + 1, Hc = n / 2 + 1;
  if (n < 2 || n % 2 || !r || !k || !w || !fc || C < 1 || C > LK_MAX || (!pid && C != 1) ||
      batch < 1 || batch > 65535 || sr < (long long)H * H || sf < (long long)Hc * Hc)
    return (int)cudaErrorInvalidValue;
  dim3 g = grid_of(Hc);
  g.z = batch;
  x5_learned_restrict<<<g, PNT, 0, (cudaStream_t)stream>>>(r, pid, k, w, fc, H, Hc, C, sr, sf);
  return (int)cudaGetLastError();
}

// X6.  out ((n+1)^2 a sample) = u + w[1] P(v), P the learned prolongation of
// v ((n/2+1)^2 a sample) with the (C, 3, 3) float32 kernels k, pidc the
// coarse level's ids or null (then C is 1), for `batch` samples su, sv and
// so values apart (rows compact).
int px_learned_prolong_add(const float* u, const float* v, const int8_t* pidc, const float* k,
                           const float* w, float* out, int n, int C, int batch, long long su,
                           long long sv, long long so, void* stream) {
  const int H = n + 1, Hc = n / 2 + 1;
  const long long plane = (long long)H * H;
  if (n < 2 || n % 2 || !u || !v || !k || !w || !out || C < 1 || C > LK_MAX ||
      (!pidc && C != 1) || batch < 1 || batch > 65535 || su < plane ||
      sv < (long long)Hc * Hc || so < plane)
    return (int)cudaErrorInvalidValue;
  dim3 g = grid_of(Hc);  // a thread per coarse cell
  g.z = batch;
  x6_learned_prolong_add<<<g, PNT, 0, (cudaStream_t)stream>>>(u, v, pidc, k, w, out, H, Hc, C,
                                                               su, sv, so);
  return (int)cudaGetLastError();
}

// X7.  gr ((n+1)^2 a sample) and the blocks' partial weight sums of the
// backward of X5 from g (the gradient of f_c, (n/2+1)^2 a sample), r, the
// fine ids pid (or null: then C is 1) and the (C, 3, 3) float32 kernels k
// and w (device memory), for `batch` samples sg, sr and so values apart, on
// `blocks` blocks of strips of `strip` rows (bwd_blocks); partial holds a
// row of 9 C floats for each block (ops/passes.py bwd_launch_tiles).
int px_learned_restrict_bwd(const float* g, const float* r, const int8_t* pid, const float* k,
                            const float* w, float* gr, float* partial, int n, int C, int batch,
                            int strip, int blocks, long long sg, long long sr, long long so,
                            void* stream) {
  if (!g || !r || !k || !w || !gr || !partial ||
      !bwd_ok(n, C, pid != nullptr, batch, strip, blocks, sr, sg, so, (long long)(n + 1) * (n + 1)))
    return (int)cudaErrorInvalidValue;
  x7_learned_restrict_bwd_rows<<<blocks, PNT, bins_smem(C), (cudaStream_t)stream>>>(
      g, r, pid, k, w, gr, partial, n + 1, n / 2 + 1, C, batch, strip, sg, sr, so);
  return (int)cudaGetLastError();
}

// X8.  gv ((n/2+1)^2 a sample) and the blocks' partial weight sums of the
// backward of X6 from g (the gradient of out, (n+1)^2 a sample), v, the
// coarse ids pidc (or null: then C is 1), k and w, for `batch` samples
// sg, sv and so values apart; the blocks and partial as X7's.
int px_learned_prolong_bwd(const float* g, const float* v, const int8_t* pidc, const float* k,
                           const float* w, float* gv, float* partial, int n, int C, int batch,
                           int strip, int blocks, long long sg, long long sv, long long so,
                           void* stream) {
  if (!g || !v || !k || !w || !gv || !partial ||
      !bwd_ok(n, C, pidc != nullptr, batch, strip, blocks, sg, sv, so,
              (long long)(n / 2 + 1) * (n / 2 + 1)))
    return (int)cudaErrorInvalidValue;
  x8_learned_prolong_bwd_rows<<<blocks, PNT, bins_smem(C), (cudaStream_t)stream>>>(
      g, v, pidc, k, w, gv, partial, n + 1, n / 2 + 1, C, batch, strip, sg, sv, so);
  return (int)cudaGetLastError();
}

// Blocks of X7 (prolong 0) or X8 (1) with C channels' shared memory that
// one SM holds at once: what ops/passes.py balances the strip against.
// Negative on a CUDA error.
int px_learned_bwd_occupancy(int prolong, int C) {
  if (C < 1 || C > LK_MAX) return -(int)cudaErrorInvalidValue;
  const void* kernel = prolong ? (const void*)x8_learned_prolong_bwd_rows
                                : (const void*)x7_learned_restrict_bwd_rows;
  int blocks = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, PNT, bins_smem(C));
  return err == cudaSuccess ? blocks : -(int)err;
}

// X9.  gk (9 C floats) = w[which] P and gw (2 floats) = (sum k P at which,
// 0 at the other), P the sums of `blocks` rows of 9 C partial sums.
int px_weight_grad(const float* partial, int blocks, int C, const float* k, const float* w,
                   int which, float* gk, float* gw, void* stream) {
  if (!partial || !k || !w || !gk || !gw || blocks < 1 || C < 1 || C > LK_MAX ||
      (which != 0 && which != 1))
    return (int)cudaErrorInvalidValue;
  x9_weight_grad<<<1, X9_THREADS, 0, (cudaStream_t)stream>>>(partial, blocks, 9 * C, k, w,
                                                             which, gk, gw);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Weighted-Jacobi sweeps of the two-phase Q1 operator in bitplane form, for
// Hopper.
//
// Two kernels, each the counterpart of one Pallas TPU kernel of
// multigrid_feanet_tpu/ops/pallas_stencil.py, on compact row-major fields:
//   u, f   (n+1) x (n+1) float32 node fields
//   pid    (n+1) x (n+1) int8 node pattern ids, absent when homogeneous:
//          bit e is the phase of the node's element e, in the order SW, SE,
//          NW, NE
//
// Operator (pallas_stencil.py:46-104): with S9 the unit 9-point Q1 Laplace
// stencil (centre 8/3, every neighbour -1/3) and S4_e element e's unit
// taps (centre 2/3, its two edge neighbours -1/6, its corner -1/3),
//     A u = a0 S9(u) + da sum_e bit_e(pid) S4_e(u),
// and the Jacobi diagonal is d = (2/3) (4 a0 + da popcount(pid)).  Unlike the
// element-factored operator of sweep.cu, this form reads one byte per node
// for the operator and has no difference form.  The arithmetic follows the
// Pallas kernels' order of operations term by term.
//
// A sweep writes u + (omega / d) r at interior nodes (1 <= i, j <= n-1) and
// keeps u elsewhere (r is zero there: a select, never a product); the
// residual mode writes the masked r.  The interior ||r||^2 of the incoming
// iterate is summed per block in a fixed order and the last block to finish
// adds the blocks' sums (finish_sums), in both kernels and both designs: no
// atomics on floats and no second launch, so sums repeat run to run.  C1
// streams rows above C1_ONE_PASS_MAX_N and C2 above C2_ONE_PASS_MAX_N[k]
// for k up to C2_STREAM_MAX_K (ops/stencil_sweep.py); both run one-pass
// tiles at and below them.
//
// C1 also takes a batch of fields in one launch (its MODE's C1_BATCH bit,
// instances of their own, so that the single-field instances keep their
// code): sample blockIdx.z of u, f and out starts batch_plane(n + 1) values
// after sample 0 (n+1 squared rounded up to whole 16 bytes, the layout of
// models/intergrid.py's per-level buffers), the pattern ids are shared, and
// the batch instances sum no norm.  Each node of a sample is computed as the
// single-field launch computes it, bit for bit.

#include "common.cuh"

namespace {

constexpr float KN13 = (float)(-1.0 / 3.0);

// C1's MODE: bit 0 the residual (else a sweep), bit 1 (C1_BATCH) a batch
constexpr int C1_RESIDUAL = 1, C1_BATCH = 2;

// Values between two samples of a batch of H x H fields: H^2 rounded up to
// a whole 16 bytes (ops/stencil_sweep.py batch_plane).
__host__ __device__ __forceinline__ long long batch_plane(int H) {
  return ((long long)H * H + 3) / 4 * 4;
}

// One level: n, the phase step da (Q = a0 + da * phase), omega, and the
// taps and diagonals derived from a0 as the Pallas kernel derives them.
struct SCoef {
  int n;
  float da, omega;
  float c9;      // a0 * 8/3, the S9 centre
  float e9;      // a0 * (-1/3), every S9 neighbour
  float four_a0; // 4 a0 (bi-material diagonal)
  float d_hom;   // 4 (2/3) a0 (homogeneous diagonal)
};

inline SCoef make_scoef(int n, double a0, double da, double omega) {
  const double c = 2.0 / 3.0;  // the S9 centre as pallas_stencil.py sums it
  SCoef k;
  k.n = n;
  k.da = (float)da;
  k.omega = (float)omega;
  k.c9 = (float)(a0 * (((c + c) + c) + c));
  k.e9 = (float)(a0 * (-1.0 / 3.0));
  k.four_a0 = (float)(4.0 * a0);
  k.d_hom = (float)(4.0 * c * a0);
  return k;
}

// A u at the node at U[0] of a tile of row stride s, whose pattern id is p:
// the S9 taps in the order _S9 lists them, then each set bit's S4 taps.
template <bool BIM>
__device__ __forceinline__ float apply_bitplane(const float* U, int s, int p,
                                                const SCoef& k) {
#define UU(dy, dx) U[(dy) * s + (dx)]
  float acc = k.c9 * UU(0, 0);
  acc = acc + k.e9 * UU(-1, 0);
  acc = acc + k.e9 * UU(0, -1);
  acc = acc + k.e9 * UU(-1, -1);
  acc = acc + k.e9 * UU(0, 1);
  acc = acc + k.e9 * UU(-1, 1);
  acc = acc + k.e9 * UU(1, 0);
  acc = acc + k.e9 * UU(1, -1);
  acc = acc + k.e9 * UU(1, 1);
  if (BIM) {
    const float c = K23, e = KN16, d = KN13;
    if (p & 1) acc = acc + k.da * (((c * UU(0, 0) + e * UU(-1, 0)) + e * UU(0, -1)) + d * UU(-1, -1));
    if (p & 2) acc = acc + k.da * (((c * UU(0, 0) + e * UU(-1, 0)) + e * UU(0, 1)) + d * UU(-1, 1));
    if (p & 4) acc = acc + k.da * (((c * UU(0, 0) + e * UU(1, 0)) + e * UU(0, -1)) + d * UU(1, -1));
    if (p & 8) acc = acc + k.da * (((c * UU(0, 0) + e * UU(1, 0)) + e * UU(0, 1)) + d * UU(1, 1));
  }
  return acc;
#undef UU
}

template <bool BIM>
__device__ __forceinline__ float diag(int p, const SCoef& k) {
  return BIM ? K23 * (k.four_a0 + k.da * (float)__popc(p & 15)) : k.d_hom;
}

// The 9 values of a thread's 3 x 3 register window around column e + 1 of
// rows w[0] .. w[2], laid out as a tile of row stride 3.
__device__ __forceinline__ void window9(float* v, const float (*w)[RC + 2], int e) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) v[3 * a + b] = w[a][e + b];
}

// ---------------------------------------------------------------------------
// C1: one weighted-Jacobi sweep (MODE 0) or the masked residual (MODE 1),
// and the interior ||f - A u||^2 of the input; with MODE's C1_BATCH bit the
// same on sample blockIdx.z of a batch, without the norm (partial, done and
// rsq unused).
// Replaces multigrid_feanet_tpu/ops/pallas_stencil.py:122 _sweep_kernel.
// Bound: bytes.  Per node it must read u and f (8 B) and the pattern id
// (1 B; 0 when homogeneous) and write the output (4 B): 12-13 B/node,
// against ~20-50 flops/node.
//
// One-pass tile, for levels of up to C1_ONE_PASS_MAX_N elements per side,
// where one wave holds the grid and a row-streaming strip waits on its
// chain of steps: one thread per node of a TX x TY tile (a 1-D block of
// NT threads); the block stages its u tile with a 1-node halo in shared
// memory (the halo re-read comes mostly from L2); f and the pattern id are
// read once by the node's own thread.  The norm's partials are added by the
// last block to finish (finish_sums), so one launch.
// ---------------------------------------------------------------------------
template <bool BIM, int MODE>
__global__ void __launch_bounds__(NT)
c1_stencil_relax(const float* __restrict__ u, const float* __restrict__ f,
                 const int8_t* __restrict__ pid, float* __restrict__ out,
                 float* __restrict__ partial, unsigned* __restrict__ done,
                 float* __restrict__ rsq, SCoef k) {
  constexpr int SU = TX + 2, RU = TY + 2;
  static_assert(TX * TY == NT, "one thread per node of the tile");
  __shared__ float us[RU * SU];
  const int H = k.n + 1;
  if constexpr ((MODE & C1_BATCH) != 0) {
    const long long z = (long long)blockIdx.z * batch_plane(H);
    u += z;
    f += z;
    out += z;
  }
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;

  for (int t = tid; t < RU * SU; t += NT) {
    const int i = y0 - 1 + t / SU, j = x0 - 1 + t % SU;
    us[t] = (i >= 0 && i < H && j >= 0 && j < H) ? u[(size_t)i * H + j] : 0.f;
  }
  __syncthreads();

  const int i = y0 + ty, j = x0 + tx;
  float rr = 0.f;
  if (i < H && j < H) {
    const size_t g = (size_t)i * H + j;
    const int p = BIM ? (int)pid[g] : 0;
    const float* U = us + (ty + 1) * SU + tx + 1;
    const float au = apply_bitplane<BIM>(U, SU, p, k);
    const float r = interior(i, j, H) ? f[g] - au : 0.f;
    out[g] = (MODE & C1_RESIDUAL) ? r : U[0] + (k.omega / diag<BIM>(p, k)) * r;
    rr = r * r;
  }
  if constexpr ((MODE & C1_BATCH) == 0) {
    float sums[1] = {rr};
    float* const outs[1] = {rsq};
    finish_sums<NT, 1>(sums, partial, done, outs);
  }
}

// ---------------------------------------------------------------------------
// C1 as a row-streaming kernel, for levels above C1_ONE_PASS_MAX_N; the same
// contract as the tile above.
// Design: H1's and F1's row streaming (common.cuh) without the torus seam
// and with the pattern id as a 1-byte row stream.  A block of RT threads of
// RC adjacent columns owns a band of RB columns and marches down a strip
// of rows; step s stages u row y0 - 1 + s and the f and pattern-id rows
// y0 - 2 + s into a ring of RNS slots with cp.async, RD steps ahead (the id
// row's window [x0, x0 + RB) in slots of RSLOTQ bytes), and from step 2 on
// a thread computes row y0 - 2 + s from its 3 x (RC + 2) register window
// of u.  Each staged value is read from shared memory once, and the
// y-halo is paid once per strip.  The bi-material weight omega / d takes
// one of five values (d depends on the pattern id's popcount only), so it
// is divided once per block into a table (the quotient `/` gives per node)
// and read by popcount.  The norm is summed over the owned nodes in a fixed
// order and the last block to finish adds the blocks' partials
// (finish_sums): one launch where the tile took two.
// ---------------------------------------------------------------------------
constexpr int C1_UNR = 6;  // steps per trip: whole turns of the slots and the window
static_assert(C1_UNR % RNS == 0 && C1_UNR % 3 == 0, "C1_UNR: whole ring turns");

template <bool BIM, int MODE>
__global__ void __launch_bounds__(RT, 6)
c1_stencil_relax_rows(const float* __restrict__ u, const float* __restrict__ f,
                      const int8_t* __restrict__ pid, float* __restrict__ out,
                      float* __restrict__ partial, unsigned* __restrict__ done,
                      float* __restrict__ rsq, int strip, SCoef k) {
  __shared__ __align__(16) float us[RNS][RSLOT];
  __shared__ __align__(16) float fs[RNS][RSLOT];
  __shared__ __align__(16) int8_t ps[BIM ? RNS : 1][RSLOTQ];
  __shared__ float wdt[5];  // omega / d by the number of the node's phase-1 elements
  const int H = k.n + 1, t = threadIdx.x;
  if constexpr ((MODE & C1_BATCH) != 0) {
    const long long z = (long long)blockIdx.z * batch_plane(H);
    u += z;
    f += z;
    out += z;
  }
  const int x0 = blockIdx.x * RB, y0 = blockIdx.y * strip, c0 = x0 + RC * t;
  const int col = x0 - 1, base = y0 - 1;
  const int steps = min(strip, H - y0) + 2;
  const unsigned ud = smem_addr(us), fd = smem_addr(fs), pd = smem_addr(ps);
  // stages step s into ring slot `slot`: u row base + s, f and pattern-id
  // rows base + s - 1; always commits
  auto stage = [&](int s, int slot) {
    const bool live = s < steps;
    stage_window<4, RW>(ud + 4 * RSLOT * slot, u, base + s, H, H, col, live);
    stage_window<4, RW>(fd + 4 * RSLOT * slot, f, base + s - 1, H, H, col, live);
    if (BIM) stage_window<1, RB>(pd + RSLOTQ * slot, pid, base + s - 1, H, H, x0, live);
    cp_commit();
  };
  for (int s = 0; s < RD; ++s) stage(s, s);
  // diag's five values, divided once (as `/` divides them per node)
  if (BIM && t < 5) wdt[t] = k.omega / diag<true>((1 << t) - 1, k);

  bool col_in[RC], col_out[RC];  // columns c0 .. c0 + RC - 1 interior; inside the grid
#pragma unroll
  for (int e = 0; e < RC; ++e) {
    col_in[e] = c0 + e >= 1 && c0 + e <= H - 2;
    col_out[e] = c0 + e < H;
  }
  float w[3][RC + 2] = {};
  float rr = 0.f;
  // step s (ring slot s mod RNS)
  auto step = [&](int s, auto S) {
    constexpr int slot = decltype(S)::value % RNS;
    if (s >= steps) return;
    cp_wait<RD - 1>();
    __syncthreads();
    const int row = base + s, i = row - 1;
    float un[RC + 2];
    read_row<RC + 2>(un, us[slot], row, H, col, RC * t);
    roll<RC + 2>(w, un);
    if (s >= 2) {
      float fv[RC];
      read_row<RC>(fv, fs[slot], i, H, col, RC * t + 1);
      int p[RC] = {};
      if (BIM) {
        const int8_t* q = ps[slot] + win_off<int8_t>(i, H, x0) + RC * t;
#pragma unroll
        for (int e = 0; e < RC; ++e) p[e] = q[e];
      }
      const bool i_in = i >= 1 && i <= H - 2;
      float* orow = out + (size_t)i * H + c0;
#pragma unroll
      for (int e = 0; e < RC; ++e) {
        float v9[9];
        window9(v9, w, e);
        const float au = apply_bitplane<BIM>(v9 + 4, 3, p[e], k);
        const float r = i_in && col_in[e] ? fv[e] - au : 0.f;
        const float wd = BIM ? wdt[__popc(p[e] & 15)] : k.omega / k.d_hom;
        if (col_out[e]) orow[e] = (MODE & C1_RESIDUAL) ? r : w[1][e + 1] + wd * r;
        rr += r * r;  // zero off the interior
      }
    }
    // step s + RD reuses the slot of step s - 1
    stage(s + RD, (slot + RD) % RNS);
  };
  for (int s0 = 0; s0 < steps; s0 += C1_UNR)
    static_for<C1_UNR>([&](auto S) { step(s0 + decltype(S)::value, S); });
  if constexpr ((MODE & C1_BATCH) == 0) {
    float sums[1] = {rr};
    float* const outs[1] = {rsq};
    finish_sums<RT, 1>(sums, partial, done, outs);
  }
}

// C1's grid: on one-pass tiles, fine_grid; row streaming, bands of RB
// columns and strips of `strip` rows (even, 2 .. RS_STRIP_MAX); as
// ops/stencil_sweep.py::c1_launch_tiles computes them.
inline bool c1_grid_ok(int n, bool one_pass, int strip, int gx, int gy) {
  const int H = n + 1;
  if (n < 2) return false;
  if (one_pass) return (unsigned)gx == fine_grid(n).x && (unsigned)gy == fine_grid(n).y;
  return strip >= 2 && strip % 2 == 0 && strip <= RS_STRIP_MAX && gx == (H + RB - 1) / RB &&
         gy == (H + strip - 1) / strip;
}

// The row-streaming C1 for the runtime flags (mode: its MODE, 0 .. 3).
inline const void* c1_rows_kernel(int bim, int mode) {
  const void* by_mode[2][4] = {
      {(const void*)c1_stencil_relax_rows<false, 0>, (const void*)c1_stencil_relax_rows<false, 1>,
       (const void*)c1_stencil_relax_rows<false, 2>, (const void*)c1_stencil_relax_rows<false, 3>},
      {(const void*)c1_stencil_relax_rows<true, 0>, (const void*)c1_stencil_relax_rows<true, 1>,
       (const void*)c1_stencil_relax_rows<true, 2>, (const void*)c1_stencil_relax_rows<true, 3>}};
  return by_mode[bim != 0][mode & 3];
}

template <bool BIM, int MODE>
void launch_c1(bool one_pass, dim3 g, cudaStream_t st, const float* u, const float* f,
               const int8_t* pid, float* out, float* partial, unsigned* done, float* rsq,
               int strip, const SCoef& k) {
  if (one_pass)
    c1_stencil_relax<BIM, MODE><<<g, NT, 0, st>>>(u, f, pid, out, partial, done, rsq, k);
  else
    c1_stencil_relax_rows<BIM, MODE><<<g, RT, 0, st>>>(u, f, pid, out, partial, done, rsq, strip,
                                                       k);
}

// ---------------------------------------------------------------------------
// C2: K weighted-Jacobi sweeps in one pass over memory, and the interior
// residual norm^2 of the LAST sweep's input (it lags K-1 sweeps).
// Replaces multigrid_feanet_tpu/ops/pallas_stencil.py:364 _fused_sweeps_kernel.
// Bound: bytes.  Per node and pass it must read u, f (8 B) and the pattern
// id (1 B) and write u (4 B): the 12-13 B of one C1 sweep for K sweeps'
// work (~23-45 operations per node per sweep: at K = 8 bi-material the
// operation time exceeds the byte time).
//
// One-pass tile, for levels of up to C2_ONE_PASS_MAX_N[K] elements per side
// and for K above C2_STREAM_MAX_K: the TPU took its column halo free from
// lane rolls over whole rows; here each block stages u, f and the pattern
// ids over its MY x MX tile with a K-node halo in both dimensions, once.
// Sweep s runs on the tile grown by K-1-s nodes, ping-ponging between two
// shared buffers, so the last sweep covers exactly the owned nodes and
// blocks never depend on one another; the halo's recomputation costs 1.1x
// (K = 2) to 1.6x (K = 8) the owned work.  The norm's partials are added by
// the last block to finish (finish_sums), so one launch.
// ---------------------------------------------------------------------------
template <bool BIM, int K>
__global__ void __launch_bounds__(NT)
c2_stencil_multi(const float* __restrict__ u, const float* __restrict__ f,
                 const int8_t* __restrict__ pid, float* __restrict__ out,
                 float* __restrict__ partial, unsigned* __restrict__ done,
                 float* __restrict__ rsq, SCoef k) {
  constexpr int S = MX + 2 * K, N = S * (MY + 2 * K);
  __shared__ float ua[N], ub[N], fs[N];
  __shared__ int8_t ps[BIM ? N : 1];
  const int H = k.n + 1;
  const int oy = MY * blockIdx.y - K, ox = MX * blockIdx.x - K;

  for (int t = threadIdx.x; t < N; t += NT) {
    const int i = oy + t / S, j = ox + t % S;
    const bool in = i >= 0 && i < H && j >= 0 && j < H;
    const size_t g = (size_t)i * H + j;
    ua[t] = in ? u[g] : 0.f;
    fs[t] = in ? f[g] : 0.f;
    if (BIM) ps[t] = in ? pid[g] : (int8_t)0;
  }
  __syncthreads();

  float* cur = ua;
  float* nxt = ub;
  float rr = 0.f;
#pragma unroll 1
  for (int s = 0; s < K; ++s) {
    const int ext = K - 1 - s, w = MX + 2 * ext, count = w * (MY + 2 * ext);
    for (int t = threadIdx.x; t < count; t += NT) {
      const int ly = K - ext + t / w, lx = K - ext + t % w;
      const int p = ly * S + lx;
      const int id = BIM ? (int)ps[p] : 0;
      const float au = apply_bitplane<BIM>(cur + p, S, id, k);
      const float r = interior(oy + ly, ox + lx, H) ? fs[p] - au : 0.f;
      nxt[p] = cur[p] + (k.omega / diag<BIM>(id, k)) * r;
      if (ext == 0) rr += r * r;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  for (int t = threadIdx.x; t < MX * MY; t += NT) {
    const int ly = K + t / MX, lx = K + t % MX;
    const int i = oy + ly, j = ox + lx;
    if (i < H && j < H) out[(size_t)i * H + j] = cur[ly * S + lx];
  }
  float sums[1] = {rr};
  float* const outs[1] = {rsq};
  finish_sums<NT, 1>(sums, partial, done, outs);
}

// ---------------------------------------------------------------------------
// C2 as a row-streaming wavefront, for K up to C2_STREAM_MAX_K at levels
// above C2_ONE_PASS_MAX_N[K]; the same contract as the tile above.
// Design: C1's row streaming with the K sweeps chained as E1 chains its conv
// layers, in one barrier per step, so u is read and written once for all K
// sweeps and no intermediate sweep or halo goes to device memory.  A block
// owns columns [x0, x0 + BW), BW = RB - 2(K - 1), and rows [y0, y0 + strip);
// thread t works on columns c0 + e, e < RC, c0 = x0 - K + 1 + RC t: sweep 1
// is valid on all RB of them (the staged u window adds a column on each
// side), and every later sweep eats a column on each side.  Step s stages
// u row R = y0 - K + s into a ring of RNS slots and the f and pattern-id
// rows i = R - 1 into a ring of NF slots (the pattern ids' window from
// column c0 of thread 0), RD steps ahead; then, from the last sweep up, a
// thread
//   - runs sweep m (K .. 2) at row i - 2(m - 1): it rolls the row sweep
//     m - 1 finished at step s - 1 into its 3 x (RC + 2) register window of
//     u_{m-1} (its own columns from registers, the two edge columns from the
//     neighbours' shared row), reads f and the ids of its row from the ring
//     (staged 2(m - 1) steps earlier) and computes u_m; sweep K stores its
//     owned nodes and sums their squared residuals (the norm of u_{K-1}),
//     the others pass their row on through a shared row;
//   - runs sweep 1 at row i from its window of u rows i - 1 .. i + 1.
// Each sweep reads rows that the one before finished at an earlier step, so
// one barrier per step orders them all.  A strip takes 3K - 1 steps beyond
// its rows (c2_halo_steps): the K u rows above and below it and the
// wavefront's lag of 2(K - 1) rows.  The ring of f and ids holds the 2K + 1
// stages s - 2(K - 1) .. s + RD (NF, a power of two), the u ring, the
// shared rows and the windows turn whole every C1_UNR steps, so their slots
// are constants.  Per node the block computes RB / BW of the owned work
// (1-2.4% more for K = 2 .. 4) plus the strip's halo steps.  The arithmetic
// is the tile's and C1's term by term (apply_bitplane, the select, u +
// (omega / d) r with omega / d from C1's table of its five values), and
// the norm is summed over the owned nodes in a fixed order and finished by
// the last block (finish_sums).  The bi-material step is issue-bound: a
// thread whose nodes all have pattern id 0 skips the S4 taps, which add
// nothing there, so only the warps along and inside the inclusion run them
// (4097^2, k = 2: 0.128 -> 0.116 ms on an H100, PERF.md).
// ---------------------------------------------------------------------------
constexpr int C2_STREAM_MAX_K = 4;  // the deepest chain streamed (ops/stencil_sweep.py)
// ring slots for the f and pattern-id rows of K sweeps: a power of two of at
// least 2K + 1 stages
__host__ __device__ constexpr int c2_nf(int K) { return K <= 1 ? 4 : K <= 3 ? 8 : 16; }
// resident blocks per SM asked for: caps the registers at 102
constexpr int C2_MINB = 5;

template <bool BIM, int K>
__global__ void __launch_bounds__(RT, C2_MINB)
c2_stencil_multi_rows(const float* __restrict__ u, const float* __restrict__ f,
                      const int8_t* __restrict__ pid, float* __restrict__ out,
                      float* __restrict__ partial, unsigned* __restrict__ done,
                      float* __restrict__ rsq, int strip, SCoef k) {
  static_assert(K >= 1 && K <= C2_STREAM_MAX_K, "K: the streamed chain depths");
  constexpr int BW = RB - 2 * (K - 1);  // owned columns of a band
  constexpr int NF = c2_nf(K);
  static_assert(NF >= 2 * K + 1 && (NF & (NF - 1)) == 0, "NF: the f / id ring");
  constexpr int KS = K > 1 ? K - 1 : 1;  // sweeps passed on through shared rows
  constexpr int XS = RB + 4;             // shared rows: column p at entry p + 2
  __shared__ __align__(16) float us[RNS][RSLOT];
  __shared__ __align__(16) float fs[NF][RSLOT];
  __shared__ __align__(16) int8_t ps[BIM ? NF : 1][RSLOTQ];
  __shared__ __align__(16) float xr[KS][2][XS];  // u_1 .. u_{K-1}: the row of step s in s mod 2
  __shared__ float wdt[5];  // omega / d by the number of the node's phase-1 elements
  const int H = k.n + 1, t = threadIdx.x;
  const int x0 = blockIdx.x * BW, y0 = blockIdx.y * strip;
  const int c0 = x0 - K + 1 + RC * t, col = x0 - K, base = y0 - K;
  const int rows_out = min(strip, H - y0);
  const int staged = rows_out + 2 * K, steps = rows_out + 3 * K - 1;

  for (int e = t; e < KS * 2 * XS; e += RT) (&xr[0][0][0])[e] = 0.f;
  const unsigned ud = smem_addr(us), fd = smem_addr(fs), pd = smem_addr(ps);
  // stages step s: u row base + s into u slot `slot`, f and pattern-id rows
  // base + s - 1 into slot s mod NF; always commits
  auto stage = [&](int s, int slot) {
    const bool live = s < staged;
    const int fslot = s & (NF - 1);
    stage_window<4, RW>(ud + 4 * RSLOT * slot, u, base + s, H, H, col, live);
    stage_window<4, RW>(fd + 4 * RSLOT * fslot, f, base + s - 1, H, H, col, live);
    if (BIM) stage_window<1, RB>(pd + RSLOTQ * fslot, pid, base + s - 1, H, H, col + 1, live);
    cp_commit();
  };
  for (int s = 0; s < RD; ++s) stage(s, s);
  // diag's five values, divided once (as `/` divides them per node)
  if (BIM && t < 5) wdt[t] = k.omega / diag<true>((1 << t) - 1, k);

  // columns c0 .. c0 + RC - 1: interior; owned by the block
  bool col_in[RC], col_own[RC];
#pragma unroll
  for (int e = 0; e < RC; ++e) {
    const int c = c0 + e, p = RC * t + e;
    col_in[e] = c >= 1 && c <= H - 2;
    col_own[e] = p >= K - 1 && p < K - 1 + BW && c < H;
  }
  const float wd_hom = k.omega / k.d_hom;  // the homogeneous Jacobi weight
  float uw[3][RC + 2] = {};                // u rows i - 1 .. i + 1
  float xw[KS][3][RC + 2] = {};            // sweep m+1's window of u_m
  float xo[KS][RC] = {};                   // u_m's own columns of the last step
  float rr = 0.f;
  // sweep m (1 .. K) at row r from the window w of u_{m-1}, with f and the
  // ids of ring slot fsl, into v; the last sweep stores the owned nodes and
  // sums their squared residuals
  auto sweep = [&](const float (*w)[RC + 2], int r, int fsl, float (&v)[RC], auto Last) {
    float fv[RC];
    read_row<RC>(fv, fs[fsl], r, H, col, RC * t + 1);
    int p[RC] = {}, any = 0;
    if (BIM) {
      const int8_t* q = ps[fsl] + win_off<int8_t>(r, H, col + 1) + RC * t;
#pragma unroll
      for (int e = 0; e < RC; ++e) {
        p[e] = q[e];
        any |= p[e];
      }
    }
    // the S4 taps add nothing at a node of pattern id 0: a thread whose
    // nodes all have id 0 (every warp but those along the inclusion's edge
    // and inside it) takes the S9 taps alone, the same sums
    float au[RC];
    if (BIM && any != 0) {
#pragma unroll
      for (int e = 0; e < RC; ++e) {
        float v9[9];
        window9(v9, w, e);
        au[e] = apply_bitplane<true>(v9 + 4, 3, p[e], k);
      }
    } else {
#pragma unroll
      for (int e = 0; e < RC; ++e) {
        float v9[9];
        window9(v9, w, e);
        au[e] = apply_bitplane<false>(v9 + 4, 3, 0, k);
      }
    }
    const bool r_in = r >= 1 && r <= H - 2;
    float res[RC];
#pragma unroll
    for (int e = 0; e < RC; ++e) {
      res[e] = r_in && col_in[e] ? fv[e] - au[e] : 0.f;
      const float wd = BIM ? wdt[__popc(p[e] & 15)] : wd_hom;
      v[e] = w[1][e + 1] + wd * res[e];
    }
    if constexpr (decltype(Last)::value) {
      if (r >= y0 && r < y0 + rows_out) {
        float* orow = out + (size_t)r * H + c0;
#pragma unroll
        for (int e = 0; e < RC; ++e) {
          if (col_own[e]) orow[e] = v[e];
          rr += col_own[e] ? res[e] * res[e] : 0.f;
        }
      }
    }
  };
  // step s (u slot s mod RNS; shared rows s mod 2)
  auto step = [&](int s, auto S) {
    constexpr int I = decltype(S)::value;
    constexpr int slot = I % RNS, xb = I % 2, xp = (I + 1) % 2;
    if (s >= steps) return;
    cp_wait<RD - 1>();
    __syncthreads();
    const int R = base + s, i = R - 1;
    // sweeps K .. 2: sweep m computes row i - 2(m - 1) of u_m
    static_for<K - 1>([&](auto M) {
      constexpr int m = K - decltype(M)::value;  // K, K-1, ..., 2
      float nv[RC + 2];
      nv[0] = xr[m - 2][xp][RC * t + 1];
      nv[RC + 1] = xr[m - 2][xp][RC * t + RC + 2];
#pragma unroll
      for (int e = 0; e < RC; ++e) nv[e + 1] = xo[m - 2][e];
      roll<RC + 2>(xw[m - 2], nv);
      float v[RC];
      sweep(xw[m - 2], i - 2 * (m - 1), (s - 2 * (m - 1)) & (NF - 1), v,
            std::integral_constant<bool, m == K>{});
      if constexpr (m < K) {
#pragma unroll
        for (int e = 0; e < RC; ++e) xo[m - 1][e] = v[e];
        *reinterpret_cast<float2*>(&xr[m - 1][xb][RC * t + 2]) = make_float2(v[0], v[1]);
      }
    });
    // sweep 1 at row i from u rows i - 1 .. i + 1
    float un[RC + 2];
    read_row<RC + 2>(un, us[slot], R, H, col, RC * t);
    roll<RC + 2>(uw, un);
    if (s >= 2) {
      float v[RC];
      sweep(uw, i, s & (NF - 1), v, std::integral_constant<bool, K == 1>{});
      if constexpr (K > 1) {
#pragma unroll
        for (int e = 0; e < RC; ++e) xo[0][e] = v[e];
        *reinterpret_cast<float2*>(&xr[0][xb][RC * t + 2]) = make_float2(v[0], v[1]);
      }
    }
    // step s + RD reuses the u slot of step s - 1 and the f / id slot of
    // step s + RD - NF, whose last reader was step s - 1 or earlier
    stage(s + RD, (slot + RD) % RNS);
  };
  for (int s0 = 0; s0 < steps; s0 += C1_UNR)
    static_for<C1_UNR>([&](auto S) { step(s0 + decltype(S)::value, S); });
  float sums[1] = {rr};
  float* const outs[1] = {rsq};
  finish_sums<RT, 1>(sums, partial, done, outs);
}

// C2's grid: on one-pass tiles, multi_grid; row streaming (kk up to
// C2_STREAM_MAX_K), bands of RB - 2(kk - 1) owned columns and strips of
// `strip` rows (even, 2 .. RS_STRIP_MAX); as
// ops/stencil_sweep.py::c2_launch_tiles computes them.
inline bool c2_grid_ok(int n, int kk, bool one_pass, int strip, int gx, int gy) {
  const int H = n + 1, bw = RB - 2 * (kk - 1);
  if (n < 2) return false;
  if (one_pass) return (unsigned)gx == multi_grid(n).x && (unsigned)gy == multi_grid(n).y;
  return kk <= C2_STREAM_MAX_K && strip >= 2 && strip % 2 == 0 && strip <= RS_STRIP_MAX &&
         gx == (H + bw - 1) / bw && gy == (H + strip - 1) / strip;
}

// The row-streaming C2 for the runtime flags, or nullptr for a depth it is
// not built for.
inline const void* c2_rows_kernel(int bim, int kk) {
  const void* by_k[2][C2_STREAM_MAX_K] = {
      {(const void*)c2_stencil_multi_rows<false, 1>, (const void*)c2_stencil_multi_rows<false, 2>,
       (const void*)c2_stencil_multi_rows<false, 3>, (const void*)c2_stencil_multi_rows<false, 4>},
      {(const void*)c2_stencil_multi_rows<true, 1>, (const void*)c2_stencil_multi_rows<true, 2>,
       (const void*)c2_stencil_multi_rows<true, 3>, (const void*)c2_stencil_multi_rows<true, 4>}};
  return kk >= 1 && kk <= C2_STREAM_MAX_K ? by_k[bim != 0][kk - 1] : nullptr;
}

template <bool BIM, int K>
void launch_c2_depth(bool one_pass, dim3 g, cudaStream_t st, const float* u, const float* f,
                     const int8_t* pid, float* out, float* partial, unsigned* done, float* rsq,
                     int strip, const SCoef& k) {
  if constexpr (K <= C2_STREAM_MAX_K) {
    if (!one_pass) {
      c2_stencil_multi_rows<BIM, K><<<g, RT, 0, st>>>(u, f, pid, out, partial, done, rsq, strip,
                                                      k);
      return;
    }
  }
  c2_stencil_multi<BIM, K><<<g, NT, 0, st>>>(u, f, pid, out, partial, done, rsq, k);
}

template <bool BIM>
void launch_c2(int kk, bool one_pass, dim3 g, cudaStream_t st, const float* u, const float* f,
               const int8_t* pid, float* out, float* partial, unsigned* done, float* rsq,
               int strip, const SCoef& k) {
#define C2_ARGS one_pass, g, st, u, f, pid, out, partial, done, rsq, strip, k
  switch (kk) {
    case 1: launch_c2_depth<BIM, 1>(C2_ARGS); break;
    case 2: launch_c2_depth<BIM, 2>(C2_ARGS); break;
    case 3: launch_c2_depth<BIM, 3>(C2_ARGS); break;
    case 4: launch_c2_depth<BIM, 4>(C2_ARGS); break;
    case 5: launch_c2_depth<BIM, 5>(C2_ARGS); break;
    case 6: launch_c2_depth<BIM, 6>(C2_ARGS); break;
    case 7: launch_c2_depth<BIM, 7>(C2_ARGS); break;
    default: launch_c2_depth<BIM, 8>(C2_ARGS); break;
  }
#undef C2_ARGS
}

}  // namespace

extern "C" {

// C1.  mode 0: out = sweep(u); 1: out = masked residual.  batch 0: one
// field, rsq[0] = interior ||f - A u||^2, with scratch of gx gy partial sums
// and a zeroed counter that the last block resets.  batch N >= 1: N samples
// of u, f and out batch_plane(n + 1) values apart (u and f on 16-byte
// boundaries when their first samples are), the pattern ids shared, no norm
// (partial, done and rsq unused).  The launch geometry of
// ops/stencil_sweep.py::c1_launch_tiles: one-pass tiles when one_pass, else
// row-streaming strips of `strip` rows, on gx x gy blocks (a sample).
// cudaErrorInvalidValue for a geometry, mode or batch C1 does not take.
int st_relax(const float* u, const float* f, const int8_t* pid, float* out, float* partial,
             unsigned* done, float* rsq, int n, double a0, double da, double omega, int bim,
             int mode, int one_pass, int strip, int gx, int gy, int batch, void* stream) {
  if (mode < 0 || mode > 1 || batch < 0 || batch > 65535 ||
      !c1_grid_ok(n, one_pass != 0, strip, gx, gy))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const SCoef k = make_scoef(n, a0, da, omega);
  const dim3 g(gx, gy, batch ? batch : 1);
  const bool op = one_pass != 0;
#define C1_ARGS op, g, st, u, f, pid, out, partial, done, rsq, strip, k
  switch ((batch ? C1_BATCH : 0) | mode | (bim ? 4 : 0)) {
    case 0: launch_c1<false, 0>(C1_ARGS); break;
    case 1: launch_c1<false, 1>(C1_ARGS); break;
    case 2: launch_c1<false, 2>(C1_ARGS); break;
    case 3: launch_c1<false, 3>(C1_ARGS); break;
    case 4: launch_c1<true, 0>(C1_ARGS); break;
    case 5: launch_c1<true, 1>(C1_ARGS); break;
    case 6: launch_c1<true, 2>(C1_ARGS); break;
    default: launch_c1<true, 3>(C1_ARGS); break;
  }
#undef C1_ARGS
  return (int)cudaGetLastError();
}

// Blocks of the row-streaming C1 in one form and MODE (0 .. 3: the batch
// instances with C1_BATCH) that one SM holds at once: what
// ops/stencil_sweep.py balances the strip height against.  Negative on a
// CUDA error.
int st_relax_occupancy(int bim, int mode) {
  if (mode < 0 || mode > 3) return -(int)cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, c1_rows_kernel(bim, mode), RT, 0);
  return err == cudaSuccess ? blocks : -(int)err;
}

// C2.  out = kk sweeps of u (1 <= kk <= 8); rsq[0] = interior ||f - A u||^2
// of the last sweep's input.  The launch geometry of
// ops/stencil_sweep.py::c2_launch_tiles: one-pass tiles when one_pass, else
// (kk up to C2_STREAM_MAX_K) row-streaming strips of `strip` rows, on
// gx x gy blocks; scratch of gx gy partial sums and a zeroed counter that
// the last block resets.  cudaErrorInvalidValue for a geometry or a number
// of sweeps C2 does not take.
int st_multi(const float* u, const float* f, const int8_t* pid, float* out, float* partial,
             unsigned* done, float* rsq, int n, double a0, double da, double omega, int bim,
             int kk, int one_pass, int strip, int gx, int gy, void* stream) {
  if (kk < 1 || kk > 8 || !c2_grid_ok(n, kk, one_pass != 0, strip, gx, gy))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const SCoef k = make_scoef(n, a0, da, omega);
  const dim3 g(gx, gy);
  if (bim) launch_c2<true>(kk, one_pass != 0, g, st, u, f, pid, out, partial, done, rsq, strip, k);
  else launch_c2<false>(kk, one_pass != 0, g, st, u, f, pid, out, partial, done, rsq, strip, k);
  return (int)cudaGetLastError();
}

// Blocks of the row-streaming C2 in one form and depth that one SM holds at
// once: what ops/stencil_sweep.py balances the strip height against.
// Negative on a CUDA error.
int st_multi_occupancy(int bim, int kk) {
  const void* kern = c2_rows_kernel(bim, kk);
  if (kern == nullptr) return -(int)cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, RT, 0);
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // extern "C"

// H1: one weighted-Jacobi sweep of the homogeneous Q1 operator on the
// periodic (torus) grid, for Hopper.
//
// Replaces multigrid_feanet_tpu/ops/pallas_torus.py:32 _torus_sweep_kernel.
// Fields are the unique n x n torus grid, row-major float32: node (i, j)'s
// neighbours are (i +- 1 mod n, j +- 1 mod n), so for n = 2 both neighbours
// along an axis are the same node, read twice, as a wrap pad reads it.
// There is no mask: every node is updated,
//     u_new = u + (omega / d) (f - A u),   d = (8/3) a0,
// with A u = 3 a0 u - (a0/3) (3x3-window sum) in the Pallas kernel's order
// (common.cuh apply_op, homogeneous plain form).
//
// Two norms of the pre-update residual r = f - A u come with each sweep:
//   rsq      = sum of r^2 over the unique n x n grid (the TPU kernel's);
//   rsq_wrap = sum_j r[0, j]^2 + sum_i r[i, 0]^2 + r[0, 0]^2, the extra
//              terms of the reference's norm over the (n+1)^2 wrapped grid
//              (ops/pbc.py pbc_interior_norm), whose last row and column
//              repeat row 0 and column 0; only the blocks that hold row 0
//              or column 0 contribute.
// rsq + rsq_wrap is the wrapped norm^2, so the periodic Jacobi history
// needs no residual pass of its own.
//
// Bound: bytes.  Per node it must read u and f and write u_new: 12 B,
// against ~20 flops, far below the card's flop-per-byte balance.
// Design: A1's row streaming (common.cuh) on the torus.  A block of RT
// threads of RC adjacent columns owns a band of RB columns and marches down
// a strip of rows; step s stages u row y0 - 1 + s and f row y0 - 2 + s into
// a ring of RNS slots with cp.async, RD steps ahead, and from step 2 on a
// thread sweeps row y0 - 2 + s from its 3 x (RC + 2) register window of u.
// The grid wraps without a `%` in the loop: the strip that starts at row 0
// stages row n - 1 as its upper halo and the last strip stages row 0 below
// its last row (the row index is corrected once per step); the first band
// takes column n - 1 as its left halo and the last band column 0 as its
// right one, each a 4-byte cp.async of the same step into the slot's two
// wrap cells, which replace the window values the compact row layout puts
// there.  Both norms are summed over the owned nodes in a fixed order and
// the last block to finish adds the blocks' partials (finish_sums): one
// launch, and the sums repeat run to run.  Small grids run on one-pass
// tiles instead (below).  The TPU kernel's ghost-block layout and per-sweep
// wrap-row refresh have no counterpart here.

#include "common.cuh"

namespace {

// H1 on one-pass tiles, for grids of up to H1_ONE_PASS_MAX_N (ops/torus.py)
// nodes per side, where one wave holds the whole grid and a row-streaming
// strip waits on its chain of steps: one thread per node of a TX x TY tile,
// the block's u tile staged with a one-node halo read through wrapped
// indices; both norms as per-block partials, summed in a fixed order by
// h1_reduce_pair, a one-block-per-norm f64 pass.
__device__ __forceinline__ int wrap(int i, int n) {
  const int m = i % n;
  return m < 0 ? m + n : m;
}

__global__ void __launch_bounds__(NT)
h1_torus_tile(const float* __restrict__ u, const float* __restrict__ f,
              float* __restrict__ out, float* __restrict__ partial, Coef k) {
  constexpr int SU = TX + 2, RU = TY + 2;  // u tile: nodes [y0-1, y0+TY] (wrapped)
  __shared__ float us[RU * SU];
  __shared__ float red[2][NT / 32];
  const int n = k.n;
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int blocks = gridDim.x * gridDim.y, b = blockIdx.y * gridDim.x + blockIdx.x;

  for (int t = tid; t < RU * SU; t += NT) {
    const int i = wrap(y0 - 1 + t / SU, n), j = wrap(x0 - 1 + t % SU, n);
    us[t] = u[(size_t)i * n + j];
  }
  __syncthreads();

  const int i = y0 + threadIdx.y, j = x0 + threadIdx.x;
  float rr = 0.f, rw = 0.f;
  if (i < n && j < n) {
    const int p = (threadIdx.y + 1) * SU + threadIdx.x + 1;
    float c4;
    const float r = f[(size_t)i * n + j] - apply_op<false, false>(us + p, SU, nullptr, 0, k, c4);
    out[(size_t)i * n + j] = us[p] + (k.omega / k.d_hom) * r;
    rr = r * r;
    rw = ((i == 0 ? rr : 0.f) + (j == 0 ? rr : 0.f)) + (i == 0 && j == 0 ? rr : 0.f);
  }
  rr = block_sum(rr, red[0]);
  rw = block_sum(rw, red[1]);
  if (tid == 0) {
    partial[b] = rr;
    partial[blocks + b] = rw;
  }
}

// Block b of 2 sums partial[b m, (b + 1) m) in a fixed order in f64 into
// out_b, as common.cuh reduce_kernel.
__global__ void __launch_bounds__(NT)
h1_reduce_pair(const float* __restrict__ partial, int m, float* __restrict__ out0,
               float* __restrict__ out1) {
  __shared__ double s[NT];
  const float* p = partial + (size_t)blockIdx.x * m;
  double acc = 0.0;
  for (int t = threadIdx.x; t < m; t += NT) acc += (double)p[t];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int o = NT / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) s[threadIdx.x] += s[threadIdx.x + o];
    __syncthreads();
  }
  if (threadIdx.x == 0) (blockIdx.x ? out1 : out0)[0] = (float)s[0];
}

inline dim3 torus_grid(int n) { return dim3((n + TX - 1) / TX, (n + TY - 1) / TY); }

constexpr int H1_UNR = 6;  // steps per trip: whole turns of the slots and the window
static_assert(H1_UNR % RNS == 0 && H1_UNR % 3 == 0, "H1_UNR: whole ring turns");

__global__ void __launch_bounds__(RT, 6)
h1_torus_relax(const float* __restrict__ u, const float* __restrict__ f,
               float* __restrict__ out, float* __restrict__ partial, unsigned* __restrict__ done,
               float* __restrict__ rsq, float* __restrict__ rsq_wrap, int strip, Coef k) {
  __shared__ __align__(16) float us[RNS][RSLOT];
  __shared__ __align__(16) float fs[RNS][RSLOT];
  __shared__ float wrap[RNS][2];  // u[row, n - 1] and u[row, 0] of each staged u row
  const int n = k.n, t = threadIdx.x;
  const int x0 = blockIdx.x * RB, y0 = blockIdx.y * strip, c0 = x0 + RC * t;
  const int col = x0 - 1, base = y0 - 1;
  const int rows_out = min(strip, n - y0), steps = rows_out + 2;
  // the threads that copy and read the wrap cells: the first band's left
  // halo is window position 0 (thread 0), the last band's right halo
  // (column n) window position n - col (thread RT - 1 copies it)
  const bool left = x0 == 0, right = x0 + RB >= n;
  const int er = n - col - RC * t;  // column n in this thread's window, if 0 <= er <= RC + 1
  const unsigned ud = smem_addr(us), fd = smem_addr(fs);
  auto stage = [&](int s, int slot) {
    const bool live = s < steps;
    int R = base + s;
    R = R < 0 ? R + n : R >= n ? R - n : R;
    stage_window<4, RW>(ud + 4 * RSLOT * slot, u, R, n, n, col, live);
    stage_window<4, RW>(fd + 4 * RSLOT * slot, f, base + s - 1, n, n, col, live);
    if (live && left && t == 0) cp_async4(&wrap[slot][0], u + (size_t)R * n + n - 1, 4);
    if (live && right && t == RT - 1) cp_async4(&wrap[slot][1], u + (size_t)R * n, 4);
    cp_commit();
  };
  for (int s = 0; s < RD; ++s) stage(s, s);

  bool col_out[RC];
#pragma unroll
  for (int e = 0; e < RC; ++e) col_out[e] = c0 + e < n;
  const float wgt = k.omega / k.d_hom;
  float w[3][RC + 2] = {};
  float rr = 0.f, rw = 0.f;
  const float none[RC + 1] = {};  // no element coefficients: homogeneous
  auto step = [&](int s, auto S) {
    constexpr int slot = decltype(S)::value % RNS;
    if (s >= steps) return;
    cp_wait<RD - 1>();
    __syncthreads();
    int R = base + s;
    R = R < 0 ? R + n : R >= n ? R - n : R;
    float un[RC + 2];
    read_row<RC + 2>(un, us[slot], R, n, col, RC * t);
    if (left && t == 0) un[0] = wrap[slot][0];
#pragma unroll
    for (int e = 0; e < RC + 2; ++e)
      if (right && e == er) un[e] = wrap[slot][1];
    roll<RC + 2>(w, un);
    if (s >= 2) {
      const int i = base + s - 1;
      float fv[RC];
      read_row<RC>(fv, fs[slot], i, n, col, RC * t + 1);
      float* orow = out + (size_t)i * n + c0;
#pragma unroll
      for (int e = 0; e < RC; ++e) {
        float c4;
        const float r = fv[e] - apply_window<false, 0>(w[0] + e, w[1] + e, w[2] + e, none + e,
                                                       none + e, k, c4);
        if (col_out[e]) orow[e] = w[1][e + 1] + wgt * r;
        const float r2 = col_out[e] ? r * r : 0.f;
        rr += r2;
        rw += ((i == 0 ? r2 : 0.f) + (c0 + e == 0 ? r2 : 0.f)) + (i == 0 && c0 + e == 0 ? r2 : 0.f);
      }
    }
    stage(s + RD, (slot + RD) % RNS);
  };
  for (int s0 = 0; s0 < steps; s0 += H1_UNR)
    static_for<H1_UNR>([&](auto S) { step(s0 + decltype(S)::value, S); });
  float sums[2] = {rr, rw};
  float* const outs[2] = {rsq, rsq_wrap};
  finish_sums<RT, 2>(sums, partial, done, outs);
}

// H1's grid: on one-pass tiles, torus_grid; row streaming, bands of RB
// columns and strips of `strip` rows (even, 2 .. RS_STRIP_MAX); as
// ops/torus.py::h1_launch_tiles computes them.
inline bool h1_grid_ok(int n, bool one_pass, int strip, int gx, int gy) {
  if (n < 2) return false;
  if (one_pass) return (unsigned)gx == torus_grid(n).x && (unsigned)gy == torus_grid(n).y;
  return strip >= 2 && strip % 2 == 0 && strip <= RS_STRIP_MAX && gx == (n + RB - 1) / RB &&
         gy == (n + strip - 1) / strip;
}

}  // namespace

extern "C" {

// H1.  out = u + (omega/d)(f - A u) on the n x n torus; rsq[0] = unique
// ||f - A u||^2, rsq_wrap[0] = the wrapped norm's extra row-0 / column-0
// terms; the launch geometry of ops/torus.py::h1_launch_tiles: one-pass
// tiles when one_pass, else row-streaming strips of `strip` rows, on gx x gy
// blocks; scratch of 2 gx gy partial sums (rsq's, then rsq_wrap's) and (row
// streaming) a zeroed counter that the last block resets.
// cudaErrorInvalidValue for a geometry H1 does not take.
int mg_torus(const float* u, const float* f, float* out, float* partial, unsigned* done,
             float* rsq, float* rsq_wrap, int n, double a0, double omega, int one_pass, int strip,
             int gx, int gy, void* stream) {
  if (!h1_grid_ok(n, one_pass != 0, strip, gx, gy)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const Coef k = make_coef(n, a0, 0.0, omega);
  if (one_pass) {
    h1_torus_tile<<<dim3(gx, gy), dim3(TX, TY), 0, st>>>(u, f, out, partial, k);
    h1_reduce_pair<<<2, NT, 0, st>>>(partial, gx * gy, rsq, rsq_wrap);
  } else {
    h1_torus_relax<<<dim3(gx, gy), RT, 0, st>>>(u, f, out, partial, done, rsq, rsq_wrap, strip, k);
  }
  return (int)cudaGetLastError();
}

// Blocks of the row-streaming H1 that one SM holds at once: what
// ops/torus.py balances the strip height against.  Negative on a CUDA error.
int mg_torus_occupancy() {
  int blocks = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, (const void*)h1_torus_relax, RT, 0);
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // extern "C"

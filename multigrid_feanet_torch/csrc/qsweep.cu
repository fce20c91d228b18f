// The coefficient-stream ("Q-stream") bi-material Jacobi sweep, for Hopper.
//
// F1: one weighted-Jacobi sweep of the bi-material Q1 operator in plain
// form, whose element coefficients come from a precomputed (n, n) stream Q
// (float32 or bfloat16) in place of the int8 phase map and (a0, da):
//     out = u + (omega/d)(f - A u) at interior nodes, u elsewhere,
// with d = (2/3) sum of the 4 element Q around the node.  No residual norm.
// Replaces multigrid_feanet_tpu/ops/pallas_qsweep.py:42 _qsweep_kernel.
//
// Fields: (n+1)^2 float32 u, f and out; Q (n, n), element (r, c) spanning
// nodes r..r+1 x c..c+1.  Elements outside the domain count as Q = 0: they
// only touch boundary nodes, whose residual is zero.  bf16 is exact for
// the coefficient pair (1, 20), so there F1 computes A1's sweep.
//
// Bound: bytes.  Per node it must read u and f (8 B) and Q (2 B in bf16,
// 4 in f32) and write out (4 B): 14-16 B/node against ~40 flops/node.
// Design: row streaming (common.cuh), H1's form without the wrap.  A block
// of RT threads of RC adjacent columns owns a band of RB columns and
// marches down a strip of rows; step s stages u row y0 - 1 + s and the f
// and Q rows y0 - 2 + s into a ring of RNS slots with cp.async, RD steps
// ahead (Q as 16-byte chunks of 2- or 4-byte elements, in slots of
// QSlot<ES> bytes), and from step 2 on a thread sweeps row y0 - 2 + s from
// its 3 x (RC + 2) register window of u with the element rows y0 - 3 + s
// (kept from the step before) and y0 - 2 + s, widened to float as they are
// read.  The apply is common.cuh's plain-form bi-material apply in A1's
// order of operations.  Grids of up to F1_ONE_PASS_MAX_N (ops/qsweep.py)
// run the one-pass tile below instead.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ float q_value(const float* q, size_t i) { return q[i]; }
__device__ __forceinline__ float q_value(const __nv_bfloat16* q, size_t i) {
  return __bfloat162float(q[i]);
}

// F1 on one-pass tiles, for grids of up to F1_ONE_PASS_MAX_N nodes per
// side, where one wave holds the grid and a strip waits on its chain of
// steps: one thread per output node of a 32 x 8 tile; the block stages its
// u tile with a 1-node halo and its Q tile (converted to float once) in
// shared memory.
template <typename QT>
__global__ void __launch_bounds__(NT)
f1_qsweep(const float* __restrict__ u, const float* __restrict__ f, const QT* __restrict__ q,
          float* __restrict__ out, Coef k) {
  constexpr int SU = TX + 2, RU = TY + 2;  // u tile: nodes [y0-1, y0+TY]
  constexpr int SQ = TX + 1, RQ = TY + 1;  // Q tile: elements [y0-1, y0+TY)
  __shared__ float us[RU * SU];
  __shared__ float qs[RQ * SQ];
  const int n = k.n, H = n + 1;
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const int tid = threadIdx.y * TX + threadIdx.x;

  for (int t = tid; t < RU * SU; t += NT) {
    const int i = y0 - 1 + t / SU, j = x0 - 1 + t % SU;
    us[t] = (i >= 0 && i < H && j >= 0 && j < H) ? u[(size_t)i * H + j] : 0.f;
  }
  for (int t = tid; t < RQ * SQ; t += NT) {
    const int r = y0 - 1 + t / SQ, c = x0 - 1 + t % SQ;
    qs[t] = (r >= 0 && r < n && c >= 0 && c < n) ? q_value(q, (size_t)r * n + c) : 0.f;
  }
  __syncthreads();

  const int i = y0 + threadIdx.y, j = x0 + threadIdx.x;
  if (i < H && j < H) {
    const int ly = threadIdx.y + 1, lx = threadIdx.x + 1;
    float c4 = 0.f;
    const float au = apply_op<true, false>(us + ly * SU + lx, SU, qs + ly * SQ + lx, SQ, k, c4);
    const float r = interior(i, j, H) ? f[(size_t)i * H + j] - au : 0.f;
    out[(size_t)i * H + j] = us[ly * SU + lx] + (k.omega / diag_of<true>(c4, k)) * r;
  }
}

// Bytes of a staged Q slot of ES-byte elements: the window of RWQ
// elements after an offset of up to 16 - ES bytes, in whole 16-byte chunks
// (common.cuh's RSLOTQ is this for int8).
template <int ES>
struct QSlot {
  static constexpr int BYTES = (ES * RWQ + 16 - ES + 15) / 16 * 16;
  static_assert(BYTES / 16 <= RT, "one chunk of a row per thread");
};

constexpr int F1_UNR = 6;  // steps per trip: whole turns of the slots
static_assert(F1_UNR % RNS == 0, "F1_UNR: whole ring turns");

template <typename QT>
__global__ void __launch_bounds__(RT, 6)
f1_qsweep_rows(const float* __restrict__ u, const float* __restrict__ f,
               const QT* __restrict__ q, float* __restrict__ out, int strip, Coef k) {
  constexpr int ES = (int)sizeof(QT), QB = QSlot<ES>::BYTES;
  __shared__ __align__(16) float us[RNS][RSLOT];
  __shared__ __align__(16) float fs[RNS][RSLOT];
  __shared__ __align__(16) QT qs[RNS][QB / ES];
  const int n = k.n, H = n + 1, t = threadIdx.x;
  const int x0 = blockIdx.x * RB, y0 = blockIdx.y * strip, c0 = x0 + RC * t;
  const int col = x0 - 1, base = y0 - 1;
  const int steps = min(strip, H - y0) + 2;
  const unsigned ud = smem_addr(us), fd = smem_addr(fs), qd = smem_addr(qs);
  // stages step s into ring slot `slot`: u row base + s, f and Q rows
  // base + s - 1; always commits
  auto stage = [&](int s, int slot) {
    const bool live = s < steps;
    stage_window<4, RW>(ud + 4 * RSLOT * slot, u, base + s, H, H, col, live);
    stage_window<4, RW>(fd + 4 * RSLOT * slot, f, base + s - 1, H, H, col, live);
    stage_window<ES, RWQ>(qd + QB * slot, q, base + s - 1, n, n, col, live);
    cp_commit();
  };
  for (int s = 0; s < RD; ++s) stage(s, s);

  bool col_in[RC + 2], col_out[RC];  // columns c0 - 1 .. c0 + RC interior; c0 + e < H
#pragma unroll
  for (int e = 0; e < RC + 2; ++e) col_in[e] = c0 - 1 + e >= 1 && c0 - 1 + e <= H - 2;
#pragma unroll
  for (int e = 0; e < RC; ++e) col_out[e] = c0 + e < H;
  float w[3][RC + 2] = {};
  float qsth[RC + 1] = {}, qnth[RC + 1] = {};  // element rows i - 1, i
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
#pragma unroll
    for (int e = 0; e <= RC; ++e) qsth[e] = qnth[e];
    read_row<RC + 1>(qnth, qs[slot], i, n, col, RC * t);
    if (s >= 2) {
      float fv[RC];
      read_row<RC>(fv, fs[slot], i, H, col, RC * t + 1);
      const bool i_in = i >= 1 && i <= H - 2, i_out = i < H;
      float* orow = out + (size_t)i * H + c0;
#pragma unroll
      for (int e = 0; e < RC; ++e) {
        float c4 = 0.f;
        const float au = apply_window<true, 0>(w[0] + e, w[1] + e, w[2] + e, qsth + e,
                                               qnth + e, k, c4);
        const bool in = i_in && col_in[e + 1];
        const float r = in ? fv[e] - au : 0.f;
        const float v = in ? w[1][e + 1] + (k.omega / diag_of<true>(c4, k)) * r : w[1][e + 1];
        if (i_out && col_out[e]) orow[e] = v;
      }
    }
    // step s + RD reuses the slot of step s - 1
    stage(s + RD, (slot + RD) % RNS);
  };
  for (int s0 = 0; s0 < steps; s0 += F1_UNR)
    static_for<F1_UNR>([&](auto S) { step(s0 + decltype(S)::value, S); });
}

inline bool f1_grid_ok(int n, bool one_pass, int strip, int gx, int gy) {
  const int H = n + 1;
  if (n < 2) return false;
  if (one_pass) return (unsigned)gx == fine_grid(n).x && (unsigned)gy == fine_grid(n).y;
  return strip >= 2 && strip % 2 == 0 && strip <= RS_STRIP_MAX && gx == (H + RB - 1) / RB &&
         gy == (H + strip - 1) / strip;
}

}  // namespace

extern "C" {

// F1.  out = one plain-form sweep of u with the element coefficients q
// ((n, n) float32, or bfloat16 when bf16 is nonzero), on the launch
// geometry of ops/qsweep.py::f1_launch_tiles: the one-pass tile when
// one_pass, else row-streaming strips of `strip` rows, on gx x gy blocks.
// cudaErrorInvalidValue for a geometry F1 does not take.
int mg_qsweep(const float* u, const float* f, const void* q, float* out, int n, double omega,
              int bf16, int one_pass, int strip, int gx, int gy, void* stream) {
  if (!f1_grid_ok(n, one_pass != 0, strip, gx, gy)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const Coef k = make_coef(n, 0.0, 0.0, omega);
  const dim3 g(gx, gy);
  if (one_pass && bf16)
    f1_qsweep<__nv_bfloat16><<<g, dim3(TX, TY), 0, st>>>(u, f, (const __nv_bfloat16*)q, out, k);
  else if (one_pass)
    f1_qsweep<float><<<g, dim3(TX, TY), 0, st>>>(u, f, (const float*)q, out, k);
  else if (bf16)
    f1_qsweep_rows<__nv_bfloat16><<<g, RT, 0, st>>>(u, f, (const __nv_bfloat16*)q, out, strip, k);
  else
    f1_qsweep_rows<float><<<g, RT, 0, st>>>(u, f, (const float*)q, out, strip, k);
  return (int)cudaGetLastError();
}

// Blocks of the row-streaming F1 (bf16 or float32 Q) that one SM holds at
// once: what ops/qsweep.py balances the strip height against.  Negative on a
// CUDA error.
int mg_qsweep_occupancy(int bf16) {
  int blocks = 0;
  const void* kern = bf16 ? (const void*)f1_qsweep_rows<__nv_bfloat16>
                          : (const void*)f1_qsweep_rows<float>;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, RT, 0);
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // extern "C"

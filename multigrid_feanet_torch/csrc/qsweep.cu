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
// Design: A1's (sweep.cu) one thread per output node of a 32 x 8 tile; the
// block stages its u tile with a 1-node halo and its Q tile (converted to
// float once) in shared memory, and the apply is common.cuh's plain-form
// bi-material apply in A1's order of operations.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ float q_value(const float* q, size_t i) { return q[i]; }
__device__ __forceinline__ float q_value(const __nv_bfloat16* q, size_t i) {
  return __bfloat162float(q[i]);
}

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

}  // namespace

extern "C" {

// F1.  out = one plain-form sweep of u with the element coefficients q
// ((n, n) float32, or bfloat16 when bf16 is nonzero).
int mg_qsweep(const float* u, const float* f, const void* q, float* out, int n, double omega,
              int bf16, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const Coef k = make_coef(n, 0.0, 0.0, omega);
  const dim3 g = fine_grid(n), b(TX, TY);
  if (bf16)
    f1_qsweep<__nv_bfloat16><<<g, b, 0, st>>>(u, f, (const __nv_bfloat16*)q, out, k);
  else
    f1_qsweep<float><<<g, b, 0, st>>>(u, f, (const float*)q, out, k);
  return (int)cudaGetLastError();
}

}  // extern "C"

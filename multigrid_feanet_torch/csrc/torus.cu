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
// against ~20 flops, far below the card's flop-per-byte balance.  Design:
// one thread per node of a TX x TY tile; the block stages its u tile with a
// one-node halo read through wrapped indices (no ghost rows, no lane rule:
// any n >= 2 works), so each byte of u is read from device memory once plus
// the halo's share; both norms are per-block partials, summed in a fixed
// order by a one-block-per-norm f64 pass (no float atomics).  The TPU
// kernel's ghost-block layout and per-sweep wrap-row refresh have no
// counterpart here.

#include "common.cuh"

namespace {

__device__ __forceinline__ int wrap(int i, int n) {
  const int m = i % n;
  return m < 0 ? m + n : m;
}

__global__ void __launch_bounds__(NT)
h1_torus_relax(const float* __restrict__ u, const float* __restrict__ f,
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

}  // namespace

extern "C" {

// Length of the `partial` scratch of mg_torus at grid size n.
int mg_torus_partials(int n) {
  const dim3 g = torus_grid(n);
  return (int)(2 * g.x * g.y);
}

// H1.  out = u + (omega/d)(f - A u) on the n x n torus; rsq[0] = unique
// ||f - A u||^2, rsq_wrap[0] = the wrapped norm's extra row-0 / column-0
// terms.
int mg_torus(const float* u, const float* f, float* out, float* partial, float* rsq,
             float* rsq_wrap, int n, double a0, double omega, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const Coef k = make_coef(n, a0, 0.0, omega);
  const dim3 g = torus_grid(n);
  h1_torus_relax<<<g, dim3(TX, TY), 0, st>>>(u, f, out, partial, k);
  h1_reduce_pair<<<2, NT, 0, st>>>(partial, (int)(g.x * g.y), rsq, rsq_wrap);
  return (int)cudaGetLastError();
}

}  // extern "C"

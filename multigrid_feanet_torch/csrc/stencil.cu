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
// iterate is summed per block in a fixed order and then by reduce_kernel
// (no atomics: sums repeat run to run).

#include "common.cuh"

namespace {

constexpr float KN13 = (float)(-1.0 / 3.0);

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

// ---------------------------------------------------------------------------
// C1: one weighted-Jacobi sweep (MODE 0) or the masked residual (MODE 1),
// and the interior ||f - A u||^2 of the input.
// Replaces multigrid_feanet_tpu/ops/pallas_stencil.py:122 _sweep_kernel.
// Bound: bytes.  Per node it must read u and f (8 B) and the pattern id
// (1 B; 0 when homogeneous) and write the output (4 B): 12-13 B/node,
// against ~20-50 flops/node.  Design: one thread per node of a TX x TY
// tile; the block stages its u tile with a 1-node halo in shared memory
// (the halo re-read comes mostly from L2); f and the pattern id are read
// once by the node's own thread.
// ---------------------------------------------------------------------------
template <bool BIM, int MODE>
__global__ void __launch_bounds__(NT)
c1_stencil_relax(const float* __restrict__ u, const float* __restrict__ f,
                 const int8_t* __restrict__ pid, float* __restrict__ out,
                 float* __restrict__ partial, SCoef k) {
  constexpr int SU = TX + 2, RU = TY + 2;
  __shared__ float us[RU * SU];
  __shared__ float red[NT / 32];
  const int H = k.n + 1;
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
    const int p = BIM ? (int)pid[g] : 0;
    const float* U = us + (threadIdx.y + 1) * SU + threadIdx.x + 1;
    const float au = apply_bitplane<BIM>(U, SU, p, k);
    const float r = interior(i, j, H) ? f[g] - au : 0.f;
    out[g] = MODE == 1 ? r : U[0] + (k.omega / diag<BIM>(p, k)) * r;
    rr = r * r;
  }
  rr = block_sum(rr, red);
  if (tid == 0) partial[blockIdx.y * gridDim.x + blockIdx.x] = rr;
}

// ---------------------------------------------------------------------------
// C2: K weighted-Jacobi sweeps in one pass over memory, and the interior
// residual norm^2 of the LAST sweep's input (it lags K-1 sweeps).
// Replaces multigrid_feanet_tpu/ops/pallas_stencil.py:364 _fused_sweeps_kernel.
// Bound: bytes.  Per node and pass it must read u, f (8 B) and the pattern
// id (1 B) and write u (4 B): the 12-13 B of one C1 sweep for K sweeps'
// work (~20-50 flops/node per sweep, still below the card's flop-per-byte
// balance at K = 8).  Design: the TPU took its column halo free from lane
// rolls over whole rows; here each block stages u, f and the pattern ids
// over its MY x MX tile with a K-node halo in both dimensions, once.  Sweep
// s runs on the tile grown by K-1-s nodes, ping-ponging between two shared
// buffers, so the last sweep covers exactly the owned nodes and blocks
// never depend on one another; the halo's recomputation costs 1.1x (K = 2)
// to 1.6x (K = 8) the owned work.
// ---------------------------------------------------------------------------
template <bool BIM, int K>
__global__ void __launch_bounds__(NT)
c2_stencil_multi(const float* __restrict__ u, const float* __restrict__ f,
                 const int8_t* __restrict__ pid, float* __restrict__ out,
                 float* __restrict__ partial, SCoef k) {
  constexpr int S = MX + 2 * K, N = S * (MY + 2 * K);
  __shared__ float ua[N], ub[N], fs[N];
  __shared__ int8_t ps[BIM ? N : 1];
  __shared__ float red[NT / 32];
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
  rr = block_sum(rr, red);
  if (threadIdx.x == 0) partial[blockIdx.y * gridDim.x + blockIdx.x] = rr;
}

template <bool BIM>
void launch_multi(int kk, cudaStream_t st, const float* u, const float* f,
                  const int8_t* pid, float* out, float* partial, const SCoef& k) {
  const dim3 g = multi_grid(k.n);
  switch (kk) {
    case 1: c2_stencil_multi<BIM, 1><<<g, NT, 0, st>>>(u, f, pid, out, partial, k); break;
    case 2: c2_stencil_multi<BIM, 2><<<g, NT, 0, st>>>(u, f, pid, out, partial, k); break;
    case 3: c2_stencil_multi<BIM, 3><<<g, NT, 0, st>>>(u, f, pid, out, partial, k); break;
    case 4: c2_stencil_multi<BIM, 4><<<g, NT, 0, st>>>(u, f, pid, out, partial, k); break;
    case 5: c2_stencil_multi<BIM, 5><<<g, NT, 0, st>>>(u, f, pid, out, partial, k); break;
    case 6: c2_stencil_multi<BIM, 6><<<g, NT, 0, st>>>(u, f, pid, out, partial, k); break;
    case 7: c2_stencil_multi<BIM, 7><<<g, NT, 0, st>>>(u, f, pid, out, partial, k); break;
    default: c2_stencil_multi<BIM, 8><<<g, NT, 0, st>>>(u, f, pid, out, partial, k); break;
  }
}

}  // namespace

extern "C" {

// C1.  mode 0: out = sweep(u); 1: out = masked residual.  rsq[0] =
// interior ||f - A u||^2.  partial holds mg_partials(0, n) floats.
int st_relax(const float* u, const float* f, const int8_t* pid, float* out,
             float* partial, float* rsq, int n, double a0, double da, double omega,
             int bim, int mode, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const SCoef k = make_scoef(n, a0, da, omega);
  const dim3 g = fine_grid(n), b(TX, TY);
  if (bim) {
    if (mode == 0) c1_stencil_relax<true, 0><<<g, b, 0, st>>>(u, f, pid, out, partial, k);
    else c1_stencil_relax<true, 1><<<g, b, 0, st>>>(u, f, pid, out, partial, k);
  } else {
    if (mode == 0) c1_stencil_relax<false, 0><<<g, b, 0, st>>>(u, f, pid, out, partial, k);
    else c1_stencil_relax<false, 1><<<g, b, 0, st>>>(u, f, pid, out, partial, k);
  }
  reduce_kernel<<<1, NT, 0, st>>>(partial, (int)(g.x * g.y), rsq);
  return (int)cudaGetLastError();
}

// C2.  out = kk sweeps of u (1 <= kk <= 8); rsq[0] = interior ||f - A u||^2
// of the last sweep's input.  partial holds mg_partials(2, n) floats.
int st_multi(const float* u, const float* f, const int8_t* pid, float* out,
             float* partial, float* rsq, int n, double a0, double da, double omega,
             int bim, int kk, void* stream) {
  if (kk < 1 || kk > 8) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const SCoef k = make_scoef(n, a0, da, omega);
  if (bim) launch_multi<true>(kk, st, u, f, pid, out, partial, k);
  else launch_multi<false>(kk, st, u, f, pid, out, partial, k);
  const dim3 g = multi_grid(n);
  reduce_kernel<<<1, NT, 0, st>>>(partial, (int)(g.x * g.y), rsq);
  return (int)cudaGetLastError();
}

}  // extern "C"

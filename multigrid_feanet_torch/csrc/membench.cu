// Device-memory bandwidth anchors, for Hopper.
//
// B1: out = in + 1 (one read and one write, 8 B per element): the card's
//     streaming rate for a float32 field.
//     Replaces multigrid_feanet_tpu/ops/pallas_membench.py:33 _copy_kernel.
// B2: out = a + 0.5 b (two reads and one write, 12 B per element): the
//     Jacobi sweep's stream count with no stencil math.
//     Replaces multigrid_feanet_tpu/ops/pallas_membench.py:40 _triad_kernel.
//
// Fields are flat float32 arrays of n elements (a row-major (rows, cols)
// field of any shape); every pointer must be 16-byte aligned.  Bound: bytes,
// at one operation per element.  Design: each thread moves one 16-byte
// vector (float4) per array, neighbouring threads on neighbouring vectors,
// and block 0 does the scalar tail of n % 4 elements.  a + 0.5 b is exact
// with or without a fused multiply-add (0.5 b is exact), so both kernels
// equal their plain versions bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTB = 256;  // threads per block

__global__ void __launch_bounds__(NTB)
b1_copy(const float* __restrict__ src, float* __restrict__ dst, long long n) {
  const long long n4 = n / 4, t = (long long)blockIdx.x * NTB + threadIdx.x;
  if (t < n4) {
    float4 v = reinterpret_cast<const float4*>(src)[t];
    v.x += 1.f;
    v.y += 1.f;
    v.z += 1.f;
    v.w += 1.f;
    reinterpret_cast<float4*>(dst)[t] = v;
  }
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * n4) {
    const long long e = 4 * n4 + threadIdx.x;
    dst[e] = src[e] + 1.f;
  }
}

__global__ void __launch_bounds__(NTB)
b2_triad(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out,
         long long n) {
  const long long n4 = n / 4, t = (long long)blockIdx.x * NTB + threadIdx.x;
  if (t < n4) {
    const float4 x = reinterpret_cast<const float4*>(a)[t];
    const float4 y = reinterpret_cast<const float4*>(b)[t];
    float4 v;
    v.x = x.x + 0.5f * y.x;
    v.y = x.y + 0.5f * y.y;
    v.z = x.z + 0.5f * y.z;
    v.w = x.w + 0.5f * y.w;
    reinterpret_cast<float4*>(out)[t] = v;
  }
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * n4) {
    const long long e = 4 * n4 + threadIdx.x;
    out[e] = a[e] + 0.5f * b[e];
  }
}

inline bool aligned(const void* p) { return ((uintptr_t)p & 15) == 0; }

inline unsigned blocks(long long n) {
  const long long b = (n / 4 + NTB - 1) / NTB;
  return (unsigned)(b > 0 ? b : 1);
}

}  // namespace

extern "C" {

// B1.  dst[e] = src[e] + 1 for e < n.
int mb_copy(const float* src, float* dst, long long n, void* stream) {
  if (n < 1 || !aligned(src) || !aligned(dst)) return (int)cudaErrorInvalidValue;
  b1_copy<<<blocks(n), NTB, 0, (cudaStream_t)stream>>>(src, dst, n);
  return (int)cudaGetLastError();
}

// B2.  out[e] = a[e] + 0.5 b[e] for e < n.
int mb_triad(const float* a, const float* b, float* out, long long n, void* stream) {
  if (n < 1 || !aligned(a) || !aligned(b) || !aligned(out)) return (int)cudaErrorInvalidValue;
  b2_triad<<<blocks(n), NTB, 0, (cudaStream_t)stream>>>(a, b, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"

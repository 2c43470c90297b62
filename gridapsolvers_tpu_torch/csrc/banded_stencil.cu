// Variable-coefficient banded stencil SpMV.
//
// Replaces the TPU kernel gridapsolvers_tpu/ops/banded_pallas.py
// (_kernel / _banded_apply), the Pallas twin of StencilMatrix.matvec:
//
//   y[p] = sum_s bands[s, p] * x[p + off_s]
//
// over S offsets of up to 3 grid axes. A neighbour outside the grid adds
// nothing on an open axis and wraps around on a periodic one.
//
// Types: bands in float, bfloat16 or double; x and y in float or double;
// the sum is taken in x's type, as the TPU kernel does (banded_pallas.py:56).
//
// What bounds it on an H100: memory bandwidth, at (S + 2) values a point
// (bench.py:325): every band value is read once and used once, and the
// bands dominate (27 of 29 values for a Q1 operator in 3D). bf16 bands
// halve that part.
//
// What the design does about it:
// - One thread per output point, last grid axis fastest across a warp, so
//   each band row and each shifted x row is a coalesced read; the S-fold
//   reuse of x comes from L1 and L2.
// - Bands stay in StencilMatrix's own (S, *grid) layout, contiguous, with
//   no padding copy.
// - Offsets are an int32 (S, 3) table staged once per block in shared
//   memory. There is no limit on their size (the TPU kernel needs |dx| <= 1
//   and lane shifts < 128): stencil_from_scipy gives Q2 operators a 5^d
//   envelope with S up to 125.
// - Every neighbour is bounds-checked. The TPU kernel relies on zero bands
//   at out-of-grid neighbours; here a load past the array would fault
//   whatever the band holds.
//
// Entry points take every pointer and the stream as void* and return
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <typename V, typename B>
__device__ __forceinline__ V widen(B b) {
  return static_cast<V>(b);
}

template <>
__device__ __forceinline__ float widen<float, __nv_bfloat16>(__nv_bfloat16 b) {
  return __bfloat162float(b);
}

// In-grid test for coordinate c on an axis of n points; a periodic axis
// wraps c into [0, n) instead.
__device__ __forceinline__ bool resolve(int& c, int n, int periodic) {
  if (c >= 0 && c < n) return true;
  if (!periodic) return false;
  c %= n;
  if (c < 0) c += n;
  return true;
}

template <typename B, typename V>
__global__ void banded_stencil_kernel(const B* __restrict__ bands,
                                      const V* __restrict__ x,
                                      const int* __restrict__ offsets,
                                      V* __restrict__ y, int S,
                                      int n0, int n1, int n2,
                                      int per0, int per1, int per2,
                                      long long n) {
  extern __shared__ int soff[];
  for (int t = threadIdx.x; t < 3 * S; t += blockDim.x) soff[t] = offsets[t];
  __syncthreads();

  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int k = (int)(p % n2);
  const long long q = p / n2;
  const int j = (int)(q % n1);
  const int i = (int)(q / n1);

  V acc = V(0);
  for (int s = 0; s < S; ++s) {
    int ii = i + soff[3 * s];
    int jj = j + soff[3 * s + 1];
    int kk = k + soff[3 * s + 2];
    if (!resolve(ii, n0, per0) || !resolve(jj, n1, per1) || !resolve(kk, n2, per2)) {
      continue;
    }
    const long long nb = ((long long)ii * n1 + jj) * n2 + kk;
    acc += widen<V, B>(bands[(long long)s * n + p]) * x[nb];
  }
  y[p] = acc;
}

template <typename B, typename V>
int launch(const void* bands, const void* x, const void* offsets, void* y, int S,
           int n0, int n1, int n2, int per0, int per1, int per2, void* stream) {
  const long long n = (long long)n0 * n1 * n2;
  if (n == 0) return (int)cudaSuccess;
  constexpr int kThreads = 256;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  const size_t smem = sizeof(int) * 3 * (size_t)S;
  banded_stencil_kernel<B, V><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const B*>(bands), static_cast<const V*>(x),
      static_cast<const int*>(offsets), static_cast<V*>(y), S, n0, n1, n2,
      per0, per1, per2, n);
  return (int)cudaGetLastError();
}

}  // namespace

#define BANDED_ENTRY(NAME, B, V)                                                   \
  extern "C" int NAME(const void* bands, const void* x, const void* offsets,      \
                      void* y, int S, int n0, int n1, int n2, int per0, int per1, \
                      int per2, void* stream) {                                    \
    return launch<B, V>(bands, x, offsets, y, S, n0, n1, n2, per0, per1, per2,    \
                        stream);                                                   \
  }

BANDED_ENTRY(banded_stencil_f32_f32, float, float)
BANDED_ENTRY(banded_stencil_bf16_f32, __nv_bfloat16, float)
BANDED_ENTRY(banded_stencil_f64_f64, double, double)

// Constant-coefficient 3^d-point stencil matvec with a fused Dirichlet mask.
//
// Replaces the TPU kernel gridapsolvers_tpu/ops/stencil_pallas.py
// (_kernel / _stencil_apply), the Pallas twin of ConstStencilMatrix.matvec:
//
//   y[p] = free[p] * sum_s w[s] * free[p+o_s] * x[p+o_s] + (1 - free[p]) * x[p]
//
// with o_s running over sorted(product((-1, 0, 1), repeat=d)), d = 2 or 3,
// and no contribution from a neighbour outside the grid.
//
// What bounds it on an H100: memory bandwidth. A point needs x and free
// read and y written, ~3 values (12 bytes in f32), for ~3 * 3^d flops:
// about 7 flop/byte in 3D, well under the card's f32 balance of ~20
// flop/byte (67 TFLOP/s over 3.35 TB/s).
//
// What the design does about it:
// - One thread per output point, with the last grid axis fastest across a
//   warp, so each of the 3^d neighbour reads is a coalesced row segment.
//   The 3^d-fold reuse of x and free is left to L1 and L2: at 129^3 in f32
//   x and free together are 17 MB and fit in the 50 MB L2, so device
//   memory traffic stays near 3 values a point.
// - The mask multiply and the pass-through term (1 - free) * x, which the
//   TPU kernel leaves to its caller (stencil_pallas.py:53-55, :165-181),
//   are fused here, so one apply reads x and free and writes y once.
// - Every neighbour is bounds-checked. The TPU kernel uses circular rolls
//   that land only on masked rows, which holds only for full-boundary
//   Dirichlet; the checks make this kernel equal ConstStencilMatrix.matvec
//   for any mask, and mask the ragged edges of n+1-point grids.
// - The 3^d weights are read from device memory; every thread of a warp
//   reads the same address, which the cache broadcasts.
//
// Entry points take every pointer and the stream as void* and return
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

template <typename T, int DIM>
__global__ void const_stencil_kernel(const T* __restrict__ x,
                                     const T* __restrict__ free,
                                     const T* __restrict__ w,
                                     T* __restrict__ y,
                                     int n0, int n1, int n2, long long n) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  // grid (n0, n1, n2) in C order; a 2D grid is (n0, n1, 1)
  const int k = (int)(p % n2);
  const long long q = p / n2;
  const int j = (int)(q % n1);
  const int i = (int)(q / n1);

  T acc = T(0);
  int s = 0;
#pragma unroll
  for (int a = -1; a <= 1; ++a) {
    const int ii = i + a;
    const bool in_i = ii >= 0 && ii < n0;
#pragma unroll
    for (int b = -1; b <= 1; ++b) {
      const int jj = j + b;
      const bool in_ij = in_i && jj >= 0 && jj < n1;
      if constexpr (DIM == 2) {
        if (in_ij) {
          const long long nb = (long long)ii * n1 + jj;
          acc += w[s] * (free[nb] * x[nb]);
        }
        ++s;
      } else {
#pragma unroll
        for (int c = -1; c <= 1; ++c, ++s) {
          const int kk = k + c;
          if (in_ij && kk >= 0 && kk < n2) {
            const long long nb = ((long long)ii * n1 + jj) * n2 + kk;
            acc += w[s] * (free[nb] * x[nb]);
          }
        }
      }
    }
  }
  const T f = free[p];
  y[p] = f * acc + (T(1) - f) * x[p];
}

template <typename T>
int launch(const void* x, const void* free, const void* w, void* y, int dim,
           int n0, int n1, int n2, void* stream) {
  const long long n = (long long)n0 * n1 * n2;
  if (n == 0) return (int)cudaSuccess;
  constexpr int kThreads = 256;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const T* ft = static_cast<const T*>(free);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  if (dim == 3) {
    const_stencil_kernel<T, 3><<<blocks, kThreads, 0, st>>>(xt, ft, wt, yt, n0, n1, n2, n);
  } else if (dim == 2) {
    const_stencil_kernel<T, 2><<<blocks, kThreads, 0, st>>>(xt, ft, wt, yt, n0, n1, 1, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int const_stencil_f32(const void* x, const void* free, const void* w, void* y,
                                 int dim, int n0, int n1, int n2, void* stream) {
  return launch<float>(x, free, w, y, dim, n0, n1, n2, stream);
}

extern "C" int const_stencil_f64(const void* x, const void* free, const void* w, void* y,
                                 int dim, int n0, int n1, int n2, void* stream) {
  return launch<double>(x, free, w, y, dim, n0, n1, n2, stream);
}

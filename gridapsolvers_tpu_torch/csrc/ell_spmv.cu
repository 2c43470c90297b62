// Padded-ELL sparse matrix-vector product, square or rectangular.
//
// Replaces the TPU kernel gridapsolvers_tpu/ops/ell_pallas.py
// (_kernel / _ell_apply, reached through PallasELL and PallasRect), the
// Pallas twin of ELLMatrix.matvec:
//
//   y[i] = sum_k values[i, k] * x[cols[i, k]]      i < nrows
//
// values and cols are (nrows, K) row-major; x has ncols entries. Padding
// slots (value 0, a valid column) are computed like any other.
//
// Types: values in float, bfloat16 or double; x and y in float or double;
// the sum is taken in x's type (f32 for bf16 values, as pallas_ell's
// band_dtype contract, ell_pallas.py:240). Columns are int32.
//
// What bounds it on an H100: memory bandwidth, at value + 4 bytes a
// stored slot (8 B in f32) read once. x is read once per slot too, but
// through the read-only path and L2: an AMG level's x (~1 MB for 265 k
// rows) sits in the 50 MB L2, and its gathers hit there.
//
// What the design does about it:
// - A group of G lanes per row, G a power of two up to a warp, chosen by
//   the wrapper so that each lane loads about six slots (ops/ell_spmv.py
//   group_size): several independent loads in flight a thread, and few
//   idle lanes on short rows. Rows are consecutive in memory, so one load
//   instruction of a warp reads 32/G row pieces of G slots within a span
//   of 32/G rows, and the warp's next loads reuse those lines from L1.
// - Each lane strides over its row by G and keeps its partial sum in a
//   register; the group reduces with warp shuffles, and lane 0 writes y.
// - None of the TPU kernel's layout: no (8, 128) tiles, no sorted slots,
//   no per-slot span anchors or int16 encoding, no span cap. Those bound
//   the TPU's lane gathers; a Hopper thread gathers x from any address.
//   So any column pattern is taken, including ones pallas_ell rejects,
//   and P and R need no remap.
// - A column outside [0, ncols) adds nothing instead of reading past x.
//
// Entry points take every pointer and the stream as void* and return
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <typename V, typename T>
__device__ __forceinline__ V widen(T v) {
  return static_cast<V>(v);
}

template <>
__device__ __forceinline__ float widen<float, __nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, typename V, int G>
__global__ void ell_spmv_kernel(const T* __restrict__ values,
                                const int* __restrict__ cols,
                                const V* __restrict__ x, V* __restrict__ y,
                                long long nrows, int K, long long ncols) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = t / G;
  const int lane = (int)(t % G);
  V acc = V(0);
  if (row < nrows) {
    const long long base = row * K;
    for (int k = lane; k < K; k += G) {
      const int c = cols[base + k];
      const V v = widen<V, T>(values[base + k]);
      if (c >= 0 && (long long)c < ncols) acc += v * __ldg(x + c);
    }
  }
  // every lane of the warp takes part, rows past the end with acc = 0
#pragma unroll
  for (int off = G / 2; off > 0; off /= 2) {
    acc += __shfl_down_sync(0xffffffffu, acc, off, G);
  }
  if (row < nrows && lane == 0) y[row] = acc;
}

template <typename T, typename V, int G>
void launch_group(const void* values, const void* cols, const void* x, void* y,
                  long long nrows, int K, long long ncols, cudaStream_t stream) {
  constexpr int kThreads = 256;  // a multiple of every G, so groups never straddle warps
  const long long threads = nrows * G;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  ell_spmv_kernel<T, V, G><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(values), static_cast<const int*>(cols),
      static_cast<const V*>(x), static_cast<V*>(y), nrows, K, ncols);
}

template <typename T, typename V>
int launch(const void* values, const void* cols, const void* x, void* y,
           long long nrows, int K, long long ncols, int group, void* stream) {
  if (nrows == 0) return (int)cudaSuccess;
  if (K < 0 || ncols < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 1: launch_group<T, V, 1>(values, cols, x, y, nrows, K, ncols, s); break;
    case 2: launch_group<T, V, 2>(values, cols, x, y, nrows, K, ncols, s); break;
    case 4: launch_group<T, V, 4>(values, cols, x, y, nrows, K, ncols, s); break;
    case 8: launch_group<T, V, 8>(values, cols, x, y, nrows, K, ncols, s); break;
    case 16: launch_group<T, V, 16>(values, cols, x, y, nrows, K, ncols, s); break;
    case 32: launch_group<T, V, 32>(values, cols, x, y, nrows, K, ncols, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define ELL_ENTRY(NAME, T, V)                                                    \
  extern "C" int NAME(const void* values, const void* cols, const void* x,      \
                      void* y, long long nrows, int K, long long ncols,         \
                      int group, void* stream) {                                \
    return launch<T, V>(values, cols, x, y, nrows, K, ncols, group, stream);    \
  }

ELL_ENTRY(ell_spmv_f32_f32, float, float)
ELL_ENTRY(ell_spmv_bf16_f32, __nv_bfloat16, float)
ELL_ENTRY(ell_spmv_f64_f64, double, double)

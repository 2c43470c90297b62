// Padded-ELL sparse matrix-vector product, square or rectangular, that
// reads only each row's real entries.
//
// Replaces the TPU kernel gridapsolvers_tpu/ops/ell_pallas.py
// (_kernel / _ell_apply, reached through PallasELL and PallasRect), the
// Pallas twin of ELLMatrix.matvec:
//
//   y[i] = sum_{k < len_i} values[i, k] * x[cols[i, k]]      i < nrows
//
// values and cols are (nrows, K) row-major; x has ncols entries. len_i is
// min(row_len[i], K) where the matrix carries row lengths (its real
// entries fill slots 0..len_i-1, as ell_from_scipy and ell_from_coo lay
// them out), and K where row_len is null.
//
// Types: values in float, bfloat16 or double; x and y in float or double;
// the sum is taken in x's type (f32 for bf16 values, as pallas_ell's
// band_dtype contract, ell_pallas.py:240). Columns and row lengths are
// int32.
//
// What bounds it on an H100: memory bandwidth, at value + 4 bytes a real
// entry read once, plus 4 bytes a row for its length. The AMG operators
// are mostly padding (row widths are capped at the p98 row length and
// every row is padded to the cap), so reading all K slots, as the first
// version did, moved up to twice the bytes a CSR product moves. x is
// gathered once per entry, through the read-only path: an AMG level's x
// (~1 MB) and the fine vector that R0 gathers from (8.6 MB at 129^3) stay
// resident in the 50 MB L2.
//
// What the design does about it:
// - Each row is read to its length only: the padding's value and column
//   bytes are never fetched. Rows stay contiguous, so a row's real entries
//   are one contiguous run and a group's loads stay coalesced.
// - A group of G lanes per row, G a power of two up to a warp, chosen on
//   the host from the mean row length so that each lane loads about two
//   entries (about seven slots where every slot is read; ops/ell_spmv.py
//   group_size). A lane loads its slots in predicated batches of four
//   (kBatch): the batch's column and value loads go out together, then its
//   x gathers. With four slots a lane in flight
//   and two expected, most rows take one batch, so a row costs one
//   dependent trip to memory after its length, and no lane runs a serial
//   remainder loop.
// - Values and columns are read with streaming loads (ld.global.cs: read
//   once, evicted first), so they do not push x out of L1 and L2; x goes
//   through the read-only (non-coherent) path.
// - The group reduces with warp shuffles, and lane 0 writes y.
// - Rows that share a warp run as long as its longest row. chip_smoke.py
//   phase 8 measures that imbalance ("warp fill"); R0 with its rows sorted
//   by length (balanced warps, the same entries) ran no faster on the card
//   (PERF.md), so a sliced layout (SELL-C-sigma), which would also give up
//   the values-only refresh on the JAX package's (nrows, K) arrays, is not
//   used.
// - What is left: in the (nrows, K) layout a row's real entries do not
//   start on a sector boundary and short rows share sectors with padding,
//   so the 32-byte sectors read hold more bytes than a packed CSR's arrays
//   (phase 8 counts both; 34% more on the AMG prolongation P0).
// - None of the TPU kernel's layout: no (8, 128) tiles, no sorted slots,
//   no per-slot span anchors or int16 encoding, no span cap. Those bound
//   the TPU's lane gathers; a Hopper thread gathers x from any address.
//   So any column pattern is taken, including ones pallas_ell rejects,
//   and P and R need no remap.
// - A column outside [0, ncols) adds nothing instead of reading past x.
//
// Entry points take every pointer and the stream as void* (row_len may be
// null) and return cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// Streaming loads of a value or a column: read once, evicted first.
__device__ __forceinline__ int load_stream(const int* p) { return __ldcs(p); }
__device__ __forceinline__ float widen_stream(const float* p) { return __ldcs(p); }
__device__ __forceinline__ double widen_stream(const double* p) { return __ldcs(p); }
__device__ __forceinline__ float widen_stream(const __nv_bfloat16* p) {
  const unsigned short bits = __ldcs(reinterpret_cast<const unsigned short*>(p));
  return __bfloat162float(__ushort_as_bfloat16(bits));
}

constexpr int kBatch = 4;  // slots a lane loads at once

// x[c] where c lies in [0, ncols), else 0 (and no load).
template <typename V>
__device__ __forceinline__ V gather(const V* __restrict__ x, int c, long long ncols) {
  return (c >= 0 && (long long)c < ncols) ? __ldg(x + c) : V(0);
}

template <typename T, typename V, int G>
__global__ void ell_spmv_kernel(const T* __restrict__ values,
                                const int* __restrict__ cols,
                                const int* __restrict__ row_len,
                                const V* __restrict__ x, V* __restrict__ y,
                                long long nrows, int K, long long ncols) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = t / G;
  const int lane = (int)(t % G);
  V acc = V(0);
  if (row < nrows) {
    const int len = row_len == nullptr ? K : min(__ldg(row_len + row), K);
    const T* __restrict__ vr = values + row * K;
    const int* __restrict__ cr = cols + row * K;
    // predicated batches of kBatch slots a lane: a batch's column and
    // value loads go out together, then its gathers
    for (int k = lane; k < len; k += kBatch * G) {
      int c[kBatch];
      V v[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const bool in = k + q * G < len;
        c[q] = in ? load_stream(cr + k + q * G) : -1;
        v[q] = in ? widen_stream(vr + k + q * G) : V(0);
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) acc += v[q] * gather(x, c[q], ncols);
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
void launch_group(const void* values, const void* cols, const void* row_len, const void* x,
                  void* y, long long nrows, int K, long long ncols, cudaStream_t stream) {
  constexpr int kThreads = 256;  // a multiple of every G, so groups never straddle warps
  const long long threads = nrows * G;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  ell_spmv_kernel<T, V, G><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(values), static_cast<const int*>(cols),
      static_cast<const int*>(row_len), static_cast<const V*>(x), static_cast<V*>(y), nrows,
      K, ncols);
}

template <typename T, typename V>
int launch(const void* values, const void* cols, const void* row_len, const void* x, void* y,
           long long nrows, int K, long long ncols, int group, void* stream) {
  if (nrows == 0) return (int)cudaSuccess;
  if (K < 0 || ncols < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 1: launch_group<T, V, 1>(values, cols, row_len, x, y, nrows, K, ncols, s); break;
    case 2: launch_group<T, V, 2>(values, cols, row_len, x, y, nrows, K, ncols, s); break;
    case 4: launch_group<T, V, 4>(values, cols, row_len, x, y, nrows, K, ncols, s); break;
    case 8: launch_group<T, V, 8>(values, cols, row_len, x, y, nrows, K, ncols, s); break;
    case 16: launch_group<T, V, 16>(values, cols, row_len, x, y, nrows, K, ncols, s); break;
    case 32: launch_group<T, V, 32>(values, cols, row_len, x, y, nrows, K, ncols, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define ELL_ENTRY(NAME, T, V)                                                         \
  extern "C" int NAME(const void* values, const void* cols, const void* row_len,     \
                      const void* x, void* y, long long nrows, int K, long long ncols, \
                      int group, void* stream) {                                     \
    return launch<T, V>(values, cols, row_len, x, y, nrows, K, ncols, group, stream); \
  }

ELL_ENTRY(ell_spmv_f32_f32, float, float)
ELL_ENTRY(ell_spmv_bf16_f32, __nv_bfloat16, float)
ELL_ENTRY(ell_spmv_f64_f64, double, double)

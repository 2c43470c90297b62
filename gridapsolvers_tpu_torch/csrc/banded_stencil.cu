// Variable-coefficient banded stencil SpMV: a box kernel for 3D 27-point
// operators and a general kernel for every other offset table.
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
// Bands stay in StencilMatrix's own (S, *grid) layout, contiguous, with no
// padding copy.
//
// What bounds it on an H100: memory bandwidth, at (S + 2) values a point
// (bench.py:325): every band value is read once and used once, and the
// bands dominate (27 of 29 values for a Q1 operator in 3D). bf16 bands
// halve that part. The first design (the general kernel below: one thread
// a point, a loop over the offset table with three bounds tests, 64-bit
// index arithmetic and an x load per offset) fell short of that: it was
// limited by the loads and instructions it issued per point, not by
// bytes (cold and warm L2 read the same; halving the band bytes saved 8%).
//
// The box kernel (grids of 3 open axes, offsets exactly {-1, 0, 1}^3 in any
// order: every operator of the Poisson paths) is designed against that:
// - A block owns a tile of 8 x 64 points of the (j, k) plane (8 x 32 in
//   f64: half the points a thread for the same bytes in flight) and marches
//   along i over a run of planes. x comes through shared memory: a ring of
//   five planes of the tile plus a one-point halo, so the 27 reads of a
//   point are shared-memory reads at constant offsets, and within a tile
//   each x value is fetched from global memory once instead of 27 times.
// - Planes are fetched with cp.async, the plane two ahead while this one
//   is computed, so the x loads overlap the arithmetic. The halo's bounds
//   test is done once per loaded element, which is zero-filled outside the
//   grid; the inner loop has no bounds tests and no branches.
// - The band of each box position comes from a 27-entry table of band
//   offsets (the operator's offset table, inverted once on the host) passed
//   by value. A thread issues all its band loads (27 a point) before it
//   sums: the loads are independent and in flight together. Bands are read
//   once, with streaming loads (ld.global.cs, evicted first).
// - A warp covers 32 consecutive k points, so each band load of a warp is
//   one coalesced run (128 bytes in f32); a thread computes its points 32
//   apart. Vector band loads (several consecutive points a thread) are not
//   used: a band starts at s * n, and with n odd (129^3) each band has its
//   own alignment, so no grouping of points aligns all 27 bands at once.
// - Once the loads are in flight, what limits the kernel is how many are:
//   on an H100 at 129^3 more blocks beat longer marches (a run of one plane
//   a block in f32 and f64, two with bf16 bands: the PLANES of each entry
//   point below, from a sweep on the card, PERF.md), so the x reuse along i
//   matters less than the parallelism.
// - The grid is (k tiles, j tiles, i runs); gridDim.y and gridDim.z are
//   capped at 65535, so the wrapper gives grids past that (n1 > 8 * 65535 or
//   n0 > 65535) to the general kernel.

// The general kernel serves every other operator: 1D and 2D grids,
// periodic axes, |offset| > 1 and the 5^3 envelope of Q2 operators. One
// thread per point; offsets are an int32 (S, 3) table staged once per
// block in shared memory, with no limit on their size (the TPU kernel needs
// |dx| <= 1 and lane shifts < 128); every neighbour is bounds-checked. The
// TPU kernel relies on zero bands at out-of-grid neighbours; here a load
// past the array would fault whatever the band holds.
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

// ---- box kernel: 3D, open axes, offsets {-1, 0, 1}^3 ---------------------

constexpr int kSlots = 5;  // ring of x planes: i-1 .. i+3

// Element offset of the band of each box position b = 9(di+1) + 3(dj+1) + dk+1.
struct BoxBands {
  long long off[27];
};

// Copy one element global -> shared, or write 0 when !valid (src-size 0).
template <typename V>
__device__ __forceinline__ void copy_async(V* dst, const V* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
               "n"(sizeof(V)), "r"(valid ? (int)sizeof(V) : 0));
}
__device__ __forceinline__ void commit_async() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void wait_async_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void wait_async_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A block of 32 x TJ threads owns a TJ x TK tile of the (j, k) plane; a
// thread computes the TK / 32 points k0 + tx + 32 v of its row.
// `planes` is a kernel argument, not a template constant: as a constant
// the box kernels built to 63, 66 and 64 registers a thread (63-64 as an
// argument), and the bf16 one ran 7% longer on the card (PERF.md).
template <typename B, typename V, int TK, int TJ>
__global__ void __launch_bounds__(32 * TJ)
banded_box_kernel(const B* __restrict__ bands, const V* __restrict__ x, V* __restrict__ y,
                  const BoxBands tab, int n0, int n1, int n2, int planes) {
  constexpr int kV = TK / 32;
  __shared__ V xs[kSlots][TJ + 2][TK + 2];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 32 + tx;
  const int k0 = blockIdx.x * TK, j0 = blockIdx.y * TJ;
  const int i0 = blockIdx.z * planes;
  const int i1 = min(i0 + planes, n0);
  const long long plane = (long long)n1 * n2;

  // plane ii (i0-1 <= ii <= i1) of the tile and its halo into its ring slot
  auto fetch = [&](int ii) {
    if (ii > i1) return;
    V* dst = &xs[(ii - i0 + 1) % kSlots][0][0];
    const bool in_i = ii >= 0 && ii < n0;
    for (int e = tid; e < (TJ + 2) * (TK + 2); e += 32 * TJ) {
      const int r = e / (TK + 2), c = e - r * (TK + 2);
      const int jj = j0 - 1 + r, kk = k0 - 1 + c;
      const bool valid = in_i && jj >= 0 && jj < n1 && kk >= 0 && kk < n2;
      copy_async(dst + e, valid ? x + (ii * plane + (long long)jj * n2 + kk) : x, valid);
    }
  };
  fetch(i0 - 1);
  fetch(i0);
  fetch(i0 + 1);
  commit_async();
  fetch(i0 + 2);
  commit_async();

  const int j = j0 + ty;
  for (int i = i0; i < i1; ++i) {
    wait_async_all_but_one();  // planes up to i+1 have landed
    __syncthreads();
    if (j < n1) {
      const V(*lo)[TK + 2] = xs[(i - i0) % kSlots];
      const V(*mid)[TK + 2] = xs[(i - i0 + 1) % kSlots];
      const V(*hi)[TK + 2] = xs[(i - i0 + 2) % kSlots];
      const long long row = i * plane + (long long)j * n2;
      // all 27 kV band loads first, so they are in flight together
      V w[kV][27];
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const int k = k0 + tx + 32 * v;
        const B* __restrict__ bp = bands + row + (k < n2 ? k : 0);
#pragma unroll
        for (int b = 0; b < 27; ++b) w[v][b] = widen<V, B>(__ldcs(bp + tab.off[b]));
      }
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const int c = tx + 32 * v;
        V acc = V(0);
#pragma unroll
        for (int b = 0; b < 27; ++b) {
          const int di = b / 9 - 1, dj = (b / 3) % 3 - 1, dk = b % 3 - 1;
          const V(*pl)[TK + 2] = di < 0 ? lo : (di == 0 ? mid : hi);
          acc += w[v][b] * pl[ty + 1 + dj][c + 1 + dk];
        }
        if (k0 + c < n2) y[row + k0 + c] = acc;
      }
    }
    // the ring slot of plane i+3 last held plane i-2, read before this
    // iteration's barrier
    fetch(i + 3);
    commit_async();
  }
  wait_async_all();  // no copy into shared memory outlives the block
}

template <typename B, typename V, int TK, int TJ, int PLANES>
int launch_box(const void* bands, const void* x, void* y, const int* perm, int n0, int n1,
               int n2, void* stream) {
  const long long n = (long long)n0 * n1 * n2;
  if (n == 0) return (int)cudaSuccess;
  if (n0 < 0 || n1 < 0 || n2 < 0) return (int)cudaErrorInvalidValue;
  BoxBands tab;
  for (int b = 0; b < 27; ++b) {
    if (perm[b] < 0 || perm[b] >= 27) return (int)cudaErrorInvalidValue;
    tab.off[b] = (long long)perm[b] * n;
  }
  const dim3 grid((unsigned)((n2 + TK - 1) / TK), (unsigned)((n1 + TJ - 1) / TJ),
                  (unsigned)((n0 + PLANES - 1) / PLANES));
  banded_box_kernel<B, V, TK, TJ><<<grid, dim3(32, TJ), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const B*>(bands), static_cast<const V*>(x), static_cast<V*>(y), tab, n0,
      n1, n2, PLANES);
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

// perm is a host array of 27 band indices, one a box position (see BoxBands).
// Tiles: 8 x 64 points in f32 and bf16, 8 x 32 in f64 (half the points a
// thread, for the same bytes in flight); runs of one plane of i a block,
// two with bf16 bands. Both chosen by sweeps on the card.
#define BOX_ENTRY(NAME, B, V, TK, TJ, PLANES)                                             \
  extern "C" int NAME(const void* bands, const void* x, void* y, const void* perm, int n0, \
                      int n1, int n2, void* stream) {                                    \
    return launch_box<B, V, TK, TJ, PLANES>(bands, x, y, static_cast<const int*>(perm), n0, \
                                            n1, n2, stream);                               \
  }

BOX_ENTRY(banded_box_f32_f32, float, float, 64, 8, 1)
BOX_ENTRY(banded_box_bf16_f32, __nv_bfloat16, float, 64, 8, 2)
BOX_ENTRY(banded_box_f64_f64, double, double, 32, 8, 1)


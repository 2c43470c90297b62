// Constant-coefficient 3^d-point stencil matvec with a fused Dirichlet mask:
// a plane-marching kernel for 3D grids and a general kernel for the rest.
//
// Replaces the TPU kernel gridapsolvers_tpu/ops/stencil_pallas.py
// (_kernel / _stencil_apply), the Pallas twin of ConstStencilMatrix.matvec:
//
//   y[p] = free[p] * sum_s w[s] * free[p+o_s] * x[p+o_s] + (1 - free[p]) * x[p]
//
// with o_s running over sorted(product((-1, 0, 1), repeat=d)), d = 2 or 3,
// and no contribution from a neighbour outside the grid. The sum is taken
// in x's type for float and double; bf16 values are widened to float, the
// 27 products summed in float and y rounded to bf16 once, at the store
// (the TPU kernel sums bf16 in bf16). The result is exact for any mask and any
// weights: the TPU kernel's circular rolls land only on masked rows, which
// holds only for a full-boundary Dirichlet mask; neither kernel here relies
// on that.
//
// What bounds it on an H100: memory bandwidth. A point needs x and free
// read and y written, 3 values (12 bytes in f32), for 3^d multiply-adds:
// about 4.5 flop/byte in 3D f32, under the card's f32 balance of ~20
// flop/byte (67 TFLOP/s over 3.35 TB/s).
//
// The general kernel (the first design, kept for 2D grids, which no path
// runs and which have no axis to march along, and for grids past the
// marching kernel's launch limits): one thread a point, 64-bit
// index arithmetic, three bounds tests and two global loads (free and x)
// for each of the 3^d neighbours, and the weights read from device memory.
// It issued ~56 loads a point and ran at 15% of the bytes bound at 129^3
// (cold and warm L2 read the same), so it was bound by the loads it
// issued, not by bytes.
//
// The plane-marching kernel (3D) is designed against that:
// - A block owns a tile of the (j, k) plane and marches along i over a run
//   of planes. Each plane of the tile, with a one-point halo, is copied once
//   from global memory into a ring of shared-memory slots (x and free side
//   by side) with cp.async, kAhead planes ahead of the one being summed, so
//   the loads overlap the arithmetic. The halo's bounds test is made once
//   per copied point, which is zero-filled outside the grid (x = free = 0
//   there, so free * x adds nothing); the inner loop has no bounds tests
//   and no branches.
// - Sums go plane by plane. For a loaded plane q, a thread forms the
//   in-plane 9-point sums S_a(q) = sum_{b,c} w[a,b,c] * (free * x)(q, j+b,
//   k+c), a = -1, 0, 1, and adds S_a(q) to output plane i = q - a, which
//   it holds in a queue of three accumulators in registers; plane q - 1 is
//   complete after plane q and is written then. A run's first and last
//   planes (the halo planes) add only the one sum their neighbour needs.
// - A thread owns R consecutive rows (j) of one column (k) of the tile, so
//   the 3-wide windows of its rows share their reads: R + 2 rows of 3
//   points for R points, against 9 a point without. Neighbouring threads
//   own neighbouring columns, so a warp reads consecutive shared words and
//   copies consecutive global words.
// - The tile's width and the run length are set by the wrapper from the
//   grid (ops/const_stencil.py march_tiles): the k extent is split into
//   equal tiles of at most 64 columns, not into multiples of 32, so the
//   coarse levels (65, 33, 17 points) leave few threads idle; runs are as
//   long as leave two blocks an SM in f32, four in f64 (sweeps on the
//   card, PERF.md).
// - The pass-through term (1 - free) * x needs the unmasked centre x and
//   free: a thread keeps them in registers from the same shared-memory
//   reads, for its output plane until that plane is written.
// - The 27 weights are a kernel argument passed by value (the constant
//   bank), so the multiply-adds read them with no load.
// - y is written once, with streaming stores (st.global.cs).
// - The launch grid is (k tiles, j tiles, i runs); gridDim.y and gridDim.z
//   are capped at 65535, and in-plane byte offsets are 32-bit, so the wrapper
//   gives grids past that to the general kernel.
// On the card its cold-L2 time is set mostly by the tile copies and its
// warm time by the sums; an elementwise PyTorch kernel that moves the same
// bytes is the nearer yardstick than the HBM bound (PERF.md).
//
// Entry points take every pointer and the stream as void* and return
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

namespace {

// Storage type S and the type its sums are taken in: bf16 sums in float.
template <typename S>
struct Compute {
  using type = S;
};
template <>
struct Compute<__nv_bfloat16> {
  using type = float;
};

__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }

template <typename S, typename T>
__device__ __forceinline__ S narrow(T v) {
  if constexpr (std::is_same_v<S, __nv_bfloat16>) {
    return __float2bfloat16_rn(v);
  } else {
    return v;
  }
}

template <typename S, int DIM>
__global__ void const_stencil_kernel(const S* __restrict__ x,
                                     const S* __restrict__ free,
                                     const S* __restrict__ w,
                                     S* __restrict__ y,
                                     int n0, int n1, int n2, long long n) {
  using T = typename Compute<S>::type;
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
          acc += widen(w[s]) * (widen(free[nb]) * widen(x[nb]));
        }
        ++s;
      } else {
#pragma unroll
        for (int c = -1; c <= 1; ++c, ++s) {
          const int kk = k + c;
          if (in_ij && kk >= 0 && kk < n2) {
            const long long nb = ((long long)ii * n1 + jj) * n2 + kk;
            acc += widen(w[s]) * (widen(free[nb]) * widen(x[nb]));
          }
        }
      }
    }
  }
  const T f = widen(free[p]);
  y[p] = narrow<S>(f * acc + (T(1) - f) * widen(x[p]));
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

// ---- plane-marching kernel: 3D, offsets {-1, 0, 1}^3 in sorted order -----

constexpr int kMarchThreads = 256;     // most threads a block
constexpr int kTileK = 64;             // most columns a tile
constexpr int kPitch = kTileK + 2;     // shared-memory row pitch, in points
constexpr int kMaxShared = 48 * 1024;  // static limit for dynamic shared memory
// Planes copied ahead of the one summed (ring slots: one more). Three and
// four were no faster on the card (PERF.md).
constexpr int kAhead = 2;

// Weight of offset (a, b, c) at 9 (a + 1) + 3 (b + 1) + c + 1.
template <typename T>
struct Weights {
  T w[27];
};

// x and free of one point side by side in shared memory: one 8-byte (f32)
// or 16-byte (f64) shared load reads both.
template <typename T>
struct alignas(2 * sizeof(T)) Pair {
  T x, f;
};

// A thread's R points of one output plane: the sum so far, and the centre
// x and free for the pass-through, kept from the plane's own reads.
template <typename T, int R>
struct Rows {
  T acc[R], x[R], f[R];
};

// Copy one element global -> shared address dst, or write 0 when !valid
// (src-size 0).
template <typename T>
__device__ __forceinline__ void copy_async(unsigned dst, const T* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
               "n"(sizeof(T)), "r"(valid ? (int)sizeof(T) : 0));
}
__device__ __forceinline__ void commit_async() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void wait_async_ahead() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1) : "memory");
}
__device__ __forceinline__ void wait_async_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// One float Pair (x, free) to shared address dst.
__device__ __forceinline__ void store_shared_pair(unsigned dst, float x, float f) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(dst), "f"(x), "f"(f) : "memory");
}
// bf16 bits widened to float, exactly.
__device__ __forceinline__ float bf16_bits_to_float(unsigned short b) {
  return __uint_as_float((unsigned)b << 16);
}

// Streaming stores of y (st.global.cs); a bf16 y is rounded here, once.
__device__ __forceinline__ void store_stream(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void store_stream(double* p, double v) { __stcs(p, v); }
__device__ __forceinline__ void store_stream(__nv_bfloat16* p, float v) {
  const unsigned short b = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  asm volatile("st.global.cs.b16 [%0], %1;\n" ::"l"(p), "h"(b) : "memory");
}

// A block of blockDim.x threads owns a (groups * R) x tk tile of the
// (j, k) plane and the planes [i0, i0 + planes) of it. Thread t owns
// column t % tk and rows R (t / tk) .. R (t / tk) + R - 1 of the tile;
// threads past groups * tk only copy. A tile plane with its halo is
// (groups R + 2) x (tk + 2) points, at most LOADS a thread (the launch
// gives the block enough threads for that), stored at a fixed row pitch so
// that a thread's window reads are at constant offsets.
//
// S is the storage type of x, free and y; the ring and the sums are in T
// (float for bf16). float and double planes come through cp.async.
// cp.async copies 4, 8 or 16 bytes, not a 2-byte bf16 element, so a bf16
// plane is read with plain loads into one of two register sets two planes
// ahead, while the block sums the planes before it, and stored widened into
// its ring slot a step later: the same ring, sums and distance ahead.
template <typename S, int R, int LOADS>
__global__ void __launch_bounds__(kMarchThreads)
const_march_kernel(const S* __restrict__ x, const S* __restrict__ free, S* __restrict__ y,
                   const Weights<typename Compute<S>::type> w, int n0, int n1, int n2, int tk,
                   int groups, int planes) {
  using T = typename Compute<S>::type;
  constexpr bool kAsync = std::is_same_v<S, T>;
  extern __shared__ __align__(16) unsigned char smem[];
  Pair<T>* ring = reinterpret_cast<Pair<T>*>(smem);
  const int slot = (groups * R + 2) * kPitch;  // points of one ring slot
  const int t = threadIdx.x, nt = blockDim.x;
  const int k0 = blockIdx.x * tk, j0 = blockIdx.y * (groups * R);
  const int i0 = blockIdx.z * planes;
  const int i1 = min(i0 + planes, n0);
  const long long plane = (long long)n1 * n2;

  // Point t + m nt of the tile and halo is this thread's to copy where bit
  // m of `mine` is set: from in-plane byte offset src[m] where bit m of
  // `inside` is set (else zero-filled), to shared address dst[m] of slot 0.
  int src[LOADS];
  unsigned dst[LOADS];
  unsigned mine = 0, inside = 0;
  const unsigned ring0 = (unsigned)__cvta_generic_to_shared(ring);
#pragma unroll
  for (int m = 0; m < LOADS; ++m) {
    const int e = t + m * nt;
    const int r = e / (tk + 2), c = e - r * (tk + 2);
    const int jj = j0 - 1 + r, kk = k0 - 1 + c;
    const bool in = jj >= 0 && jj < n1 && kk >= 0 && kk < n2;
    src[m] = in ? (jj * n2 + kk) * (int)sizeof(S) : 0;
    dst[m] = ring0 + (unsigned)((r * kPitch + c) * sizeof(Pair<T>));
    mine |= (unsigned)(e < (groups * R + 2) * (tk + 2)) << m;
    inside |= (unsigned)in << m;
  }
  // plane ii (i0 - 1 <= ii <= i1) of the tile and its halo: the bits of
  // the points this thread copies that lie in the grid, and the plane's
  // x and free
  auto plane_of = [&](int ii, const char*& xp, const char*& fp) {
    // a plane of the grid, read only where valid
    const long long base = (long long)min(max(ii, 0), n0 - 1) * plane * (long long)sizeof(S);
    xp = reinterpret_cast<const char*>(x) + base;
    fp = reinterpret_cast<const char*>(free) + base;
    return ii >= 0 && ii < n0 ? inside : 0u;
  };
  // float / double: plane ii into slot s by cp.async
  auto fetch = [&](int ii, int s) {
    const unsigned off = (unsigned)(s * slot * sizeof(Pair<T>));
    const char *xp, *fp;
    const unsigned valid = plane_of(ii, xp, fp);
#pragma unroll
    for (int m = 0; m < LOADS; ++m) {
      if (mine >> m & 1u) {
        const bool v = valid >> m & 1u;
        copy_async(dst[m] + off, reinterpret_cast<const S*>(xp + src[m]), v);
        copy_async(dst[m] + off + (unsigned)sizeof(T), reinterpret_cast<const S*>(fp + src[m]), v);
      }
    }
  };
  // bf16: plane ii into one of two register sets (load), and a set into
  // ring slot s (store); `set` is std::integral_constant<int, 0 or 1>, so
  // the sets stay in registers
  unsigned short px[2][LOADS], pf[2][LOADS];
  auto load = [&](auto set, int ii) {
    constexpr int b = decltype(set)::value;
    const char *xp, *fp;
    const unsigned valid = plane_of(ii, xp, fp);
#pragma unroll
    for (int m = 0; m < LOADS; ++m) {
      const bool v = (mine & valid) >> m & 1u;
      px[b][m] = v ? __ldg(reinterpret_cast<const unsigned short*>(xp + src[m])) : 0;
      pf[b][m] = v ? __ldg(reinterpret_cast<const unsigned short*>(fp + src[m])) : 0;
    }
  };
  auto store = [&](auto set, int s) {
    constexpr int b = decltype(set)::value;
    const unsigned off = (unsigned)(s * slot * sizeof(Pair<T>));
#pragma unroll
    for (int m = 0; m < LOADS; ++m) {
      if (mine >> m & 1u) {
        store_shared_pair(dst[m] + off, bf16_bits_to_float(px[b][m]),
                          bf16_bits_to_float(pf[b][m]));
      }
    }
  };
  using Set0 = std::integral_constant<int, 0>;
  using Set1 = std::integral_constant<int, 1>;
  if constexpr (kAsync) {
#pragma unroll
    for (int d = 0; d < kAhead; ++d) {
      if (i0 - 1 + d <= i1) fetch(i0 - 1 + d, d);
      commit_async();
    }
  } else {
    // plane i0 - 1 stored now; plane i0 (i0 < i1 always) by the first step
    load(Set0{}, i0 - 1);
    store(Set0{}, 0);
    load(Set1{}, i0);
  }

  const int g = t / tk, c = t - g * tk;
  const bool active = g < groups;
  const int k = k0 + c, j = j0 + g * R;
  const Pair<T>* win0 = ring + g * R * kPitch + c;  // a thread's window in slot 0

  // the thread's first output point in a plane, and bit r of `out` where
  // its row r is in the grid
  const int y0 = j * n2 + k;
  unsigned out = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) out |= (unsigned)(active && k < n2 && j + r < n1) << r;
  int s = 0;  // slot of the plane summed next

  // Plane q, in slot s: its in-plane sums S_a go to P (a = 1: output
  // plane q - 1, complete after this and written), Q (a = 0: output plane
  // q, whose centre values it keeps) and N (a = -1: output plane q + 1,
  // begun here), each only where that output plane is in [i0, i1): the
  // run's first and last planes add one sum, not three.
  //
  // bf16: plane q + kAhead is loaded into register set `set` here and
  // stored at the end of the next step, so its loads have two steps'
  // sums to land in, as the cp.async copies have; this step stores plane
  // q + 1 (loaded a step ago, into the other set) into its slot, that of
  // plane q - 2, read before the last barrier.
  auto step = [&](auto set, int q, Rows<T, R>& P, Rows<T, R>& Q, Rows<T, R>& N) {
    if constexpr (kAsync) {
      // plane q + kAhead goes to the slot of plane q - 1, read before
      // this barrier
      wait_async_ahead();  // plane q has landed
      __syncthreads();
      if (q + kAhead <= i1) fetch(q + kAhead, s == 0 ? kAhead : s - 1);
      commit_async();
    } else {
      __syncthreads();  // plane q, stored a step ago, is visible
      if (q + kAhead <= i1) load(set, q + kAhead);
    }
    const Pair<T>* win = win0 + s * slot;
    s = s == kAhead ? 0 : s + 1;
    if (active) {
      T v[R + 2][3];  // free * x over the window: rows j - 1 .. j + R, columns k - 1 .. k + 1
#pragma unroll
      for (int rr = 0; rr < R + 2; ++rr) {
#pragma unroll
        for (int dc = 0; dc < 3; ++dc) {
          const Pair<T> e = win[rr * kPitch + dc];
          v[rr][dc] = e.f * e.x;
          if (dc == 1 && rr >= 1 && rr <= R) {
            Q.x[rr - 1] = e.x;
            Q.f[rr - 1] = e.f;
          }
        }
      }
      // acc[r] += S_a at point r: the 9 weights of a over rows r .. r + 2
      auto add = [&](T(&acc)[R], int a) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int b = 0; b < 3; ++b) {
            const int i = 9 * (a + 1) + 3 * b;
            acc[r] = fma(w.w[i], v[r + b][0], acc[r]);
            acc[r] = fma(w.w[i + 1], v[r + b][1], acc[r]);
            acc[r] = fma(w.w[i + 2], v[r + b][2], acc[r]);
          }
        }
      };
      if (q > i0) add(P.acc, 1);
      if (q >= i0 && q < i1) add(Q.acc, 0);
      if (q < i1 - 1) {
#pragma unroll
        for (int r = 0; r < R; ++r) N.acc[r] = T(0);
        add(N.acc, -1);
      }
      if (q > i0) {  // output plane q - 1 is complete
        S* yq = y + (long long)(q - 1) * plane;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const T v = P.f[r] * P.acc[r] + (T(1) - P.f[r]) * P.x[r];
          if (out >> r & 1u) store_stream(yq + (y0 + r * n2), v);
        }
      }
    }
    if constexpr (!kAsync) {
      // plane q + 1 into its slot (s, advanced above)
      if (q + 1 <= i1) store(std::integral_constant<int, 1 - decltype(set)::value>{}, s);
    }
  };
  // Three output planes rotate through A, B and C: unrolled by three, the
  // rotation costs no register moves; bf16 unrolls by six, for its two
  // register sets.
  Rows<T, R> A{}, B{}, C{};
  if constexpr (kAsync) {
    for (int q = i0 - 1;; q += 3) {
      step(Set0{}, q, A, B, C);
      if (q + 1 > i1) break;
      step(Set0{}, q + 1, B, C, A);
      if (q + 2 > i1) break;
      step(Set0{}, q + 2, C, A, B);
      if (q + 3 > i1) break;
    }
  } else {
    for (int q = i0 - 1;; q += 6) {
      step(Set0{}, q, A, B, C);
      if (q + 1 > i1) break;
      step(Set1{}, q + 1, B, C, A);
      if (q + 2 > i1) break;
      step(Set0{}, q + 2, C, A, B);
      if (q + 3 > i1) break;
      step(Set1{}, q + 3, A, B, C);
      if (q + 4 > i1) break;
      step(Set0{}, q + 4, B, C, A);
      if (q + 5 > i1) break;
      step(Set1{}, q + 5, C, A, B);
      if (q + 6 > i1) break;
    }
  }
  if constexpr (kAsync) wait_async_all();  // no copy into shared memory outlives the block
}

template <typename S, int R, int LOADS>
int launch_march(const void* x, const void* free, void* y, const void* w, int n0, int n1,
                 int n2, int tk, int groups, int planes, void* stream) {
  using T = typename Compute<S>::type;
  const long long n = (long long)n0 * n1 * n2;
  if (n == 0) return (int)cudaSuccess;
  if (n0 < 0 || n1 < 0 || n2 < 0 || tk < 1 || tk > kTileK || groups < 1 || planes < 1) {
    return (int)cudaErrorInvalidValue;
  }
  // threads: one a column of each row group, and enough that each copies
  // at most LOADS points of a tile plane
  const long long rows = (long long)groups * R + 2;
  const long long threads =
      (std::max((long long)tk * groups, (rows * (tk + 2) + LOADS - 1) / LOADS) + 31) / 32 * 32;
  const long long smem = (kAhead + 1) * rows * kPitch * (long long)sizeof(Pair<T>);
  const long long tiles_j = (n1 + (long long)groups * R - 1) / ((long long)groups * R);
  const long long runs = (n0 + (long long)planes - 1) / planes;
  if (threads > kMarchThreads || smem > kMaxShared || tiles_j > 65535 || runs > 65535 ||
      (long long)n1 * n2 * (long long)sizeof(S) > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  Weights<T> wt;
  for (int s = 0; s < 27; ++s) wt.w[s] = static_cast<const T*>(w)[s];
  const dim3 grid((unsigned)((n2 + tk - 1) / tk), (unsigned)tiles_j, (unsigned)runs);
  const_march_kernel<S, R, LOADS><<<grid, (unsigned)threads, (size_t)smem,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(x), static_cast<const S*>(free), static_cast<S*>(y), wt, n0, n1,
      n2, tk, groups, planes);
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

// x, free, w and y in bf16; sums in float, y rounded once.
extern "C" int const_stencil_bf16(const void* x, const void* free, const void* w, void* y,
                                  int dim, int n0, int n1, int n2, void* stream) {
  return launch<__nv_bfloat16>(x, free, w, y, dim, n0, n1, n2, stream);
}

// w is a host array of the 27 weights (float for f32 and bf16, double for
// f64); tk, groups and planes as chosen by ops/const_stencil.py
// march_tiles. Rows a thread: 4 in f32 and bf16 (whose ring holds float),
// 2 in f64 (half the points a thread for about the same registers and bytes
// in flight); a thread copies at most 5 (f32, bf16) or 3 (f64) points of a
// tile plane.
extern "C" int const_march_f32(const void* x, const void* free, void* y, const void* w,
                               int n0, int n1, int n2, int tk, int groups, int planes,
                               void* stream) {
  return launch_march<float, 4, 5>(x, free, y, w, n0, n1, n2, tk, groups, planes, stream);
}

extern "C" int const_march_f64(const void* x, const void* free, void* y, const void* w,
                               int n0, int n1, int n2, int tk, int groups, int planes,
                               void* stream) {
  return launch_march<double, 2, 3>(x, free, y, w, n0, n1, n2, tk, groups, planes, stream);
}

extern "C" int const_march_bf16(const void* x, const void* free, void* y, const void* w,
                                int n0, int n1, int n2, int tk, int groups, int planes,
                                void* stream) {
  return launch_march<__nv_bfloat16, 4, 5>(x, free, y, w, n0, n1, n2, tk, groups, planes,
                                           stream);
}

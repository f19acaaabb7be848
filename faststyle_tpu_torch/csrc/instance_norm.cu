// Instance norm with its epilogue for NVIDIA Hopper (sm_90a), plain C
// interface: the serving path's 16 norms of the transform net, and AdaIN's
// content norm (C = 512, eps 1e-5, the unbiased variance, the style's
// sigma and mean as scale and shift).
//
//   y[n, h, w, c] = scale[c] * ((x - mean[n, c]) * rsqrt(var[n, c] + eps)) + shift[c]
//
// over NHWC x, moments over H and W in float32 (var = M2 / (count -
// correction): correction 0 is the biased variance, 1 the unbiased), then
// one epilogue:
// none; relu; residual (+ skip[n, h + 2, w + 2, c], the resblock's input
// cropped by 2); tanh ((255 tanh(y) + 255) / 2); tanh_u8 (that, clamped
// to [0, 255] and cast to uint8 by truncation).
//
// No TPU kernel stands behind it: the JAX package's instance norm is XLA's
// (its Pallas one was deleted in c446091). In the port's plain PyTorch the
// norm took a cast, var_mean, four float32 broadcast passes and a cast back,
// then relu, the add or the tanh chain as passes of their own: ~48 bytes of
// traffic an element, half the device time of a served 4K frame.
//
// The bound on an H100 is the bytes (3.35 TB/s): x read twice (once for
// the statistics, once to apply them), the output written once, the skip
// read once: 6 B an element in bf16, 12 in float32, 3 more for a bf16
// residual, 1 less for uint8 out. How the design meets it:
//  1. Two passes over x, three launches. instance_norm_stats_kernel: a
//     grid of (splits, n) blocks, each walking one contiguous slab of an
//     image with 16-byte loads, two in flight a thread, and keeping
//     per-channel Welford partials
//     (count, mean, M2) in float32 registers. instance_norm_merge_kernel:
//     one block per (n, c) merges the slabs' partials by Chan's formula in
//     a fixed order and writes mean and rsqrt(var + eps).
//     instance_norm_apply_kernel: one pass that reads x (and the skip),
//     two vectors in flight a thread, applies the statistics and the
//     epilogue, and writes once.
//  2. A thread always meets the same channels. Blocks have THREADS = 384
//     threads; C must divide a block's stride of THREADS * V elements
//     (every C of the transform net, 3, 16, 32 and 64, divides THREADS
//     itself; AdaIN's 512 divides 384 * 8 and 384 * 4, the bf16 and
//     float32 vectors), so every slab start and every grid stride is a
//     whole number of pixels, and element j of a thread's vector always
//     has channel (threadIdx.x * V + j) % C. The per-channel state lives
//     in registers for the whole walk.
//  3. No atomics: the slabs' partials merge in a tree of fixed shape in
//     shared memory, then across slabs in a fixed order, so two calls give
//     the same bits.
//  4. The apply keeps the rounding points of the plain PyTorch chain:
//     (x - mean) * rstd, then scale * that, then + shift, each rounded in
//     float32 (the _rn intrinsics stop nvcc from contracting them into an
//     fma), then rounded to the activation's dtype; the residual adds in
//     float32 and rounds once more; the tanh chain runs in float32 and
//     rounds to the activation dtype before the clamp. Given the same mean
//     and rstd, the output equals the plain chain's bit for bit.
//  5. The residual's skip is read in place: each output row is one
//     contiguous run of a skip row, so its 16-byte loads stay whole.
//  6. Each kernel runs as one wave: the wrapper asks the card how many of
//     its blocks an SM holds (fs_instance_norm_blocks_per_sm) and launches
//     that many, each with an equal share, so the SMs finish together. In
//     bf16 the kernels hold 3 blocks an SM, and a 4-an-SM grid (a second,
//     one-third wave) read 15% slower over a 4K frame's 16 norms.
// Inputs the vector path cannot take (an unaligned pointer, an image of
// H*W*C not a multiple of the vector, a residual with C not a multiple of
// it) run the same kernels with one element a load (V = 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 384;       // a multiple of 3 and of 64 (see 2.)
constexpr int MERGE_THREADS = 256;  // a power of two: the merge's tree

enum Epilogue { NONE = 0, RELU = 1, RESIDUAL = 2, TANH = 3, TANH_U8 = 4 };

struct Moments {
  float n, mean, m2;
};

// Chan's parallel update: a <- the moments of a's and b's elements together.
__device__ __forceinline__ void merge(Moments& a, const Moments& b) {
  if (b.n == 0.f) return;
  if (a.n == 0.f) {
    a = b;
    return;
  }
  const float n = a.n + b.n;
  const float d = b.mean - a.mean;
  const float wb = b.n / n;
  a.mean += d * wb;
  a.m2 += b.m2 + d * d * a.n * wb;
  a.n = n;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// x rounded to T (to nearest even), as a float.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (sizeof(T) == 2) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// V consecutive elements of p as floats: one 16-byte load when V fills it.
template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = to_float(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = to_float(p[j]);
  }
}

// V values already rounded to T, stored at p: one 16-byte store when V fills it.
template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if constexpr (sizeof(T) == 2) {
        e[j] = __float2bfloat16_rn(v[j]);
      } else {
        e[j] = v[j];
      }
    }
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if constexpr (sizeof(T) == 2) {
        p[j] = __float2bfloat16_rn(v[j]);
      } else {
        p[j] = v[j];
      }
    }
  }
}

// V bytes at p: one 8- or 4-byte store when V is 8 or 4.
template <int V>
__device__ __forceinline__ void store_u8(uint8_t* p, const uint8_t (&b)[V]) {
  if constexpr (V == 8) {
    uint2 u;
    uint8_t* e = reinterpret_cast<uint8_t*>(&u);
#pragma unroll
    for (int j = 0; j < V; ++j) e[j] = b[j];
    *reinterpret_cast<uint2*>(p) = u;
  } else if constexpr (V == 4) {
    uint32_t u = 0;
#pragma unroll
    for (int j = 0; j < V; ++j) u |= static_cast<uint32_t>(b[j]) << (8 * j);
    *reinterpret_cast<uint32_t*>(p) = u;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = b[j];
  }
}

// One more vector into a thread's per-slot moments (the slots share a count).
template <int V>
__device__ __forceinline__ void welford(float& cnt, float (&mean)[V], float (&m2)[V], const float (&v)[V]) {
  cnt += 1.f;
  const float inv = 1.f / cnt;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float d = v[j] - mean[j];
    mean[j] += d * inv;
    m2[j] += d * (v[j] - mean[j]);
  }
}

// Block (s, n) walks elements [s * slab, (s + 1) * slab) of image n, each
// thread every THREADS * V-th vector of them, and writes the slab's
// per-channel moments to partial[n][s][c] as (count, mean, M2).
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    instance_norm_stats_kernel(const T* __restrict__ x, float* __restrict__ partial, long long hwc, int c,
                               long long slab) {
  __shared__ float s_n[THREADS * V];
  __shared__ float s_mean[THREADS * V];
  __shared__ float s_m2[THREADS * V];
  const int t = threadIdx.x;
  const long long begin = blockIdx.x * slab;
  const long long end = begin + slab < hwc ? begin + slab : hwc;
  const T* img = x + blockIdx.y * hwc;
  constexpr long long STRIDE = static_cast<long long>(THREADS) * V;

  float cnt = 0.f, mean[V], m2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) mean[j] = m2[j] = 0.f;
  long long e = begin + t * V;
  for (; e + STRIDE < end; e += 2 * STRIDE) {  // two vectors in flight a thread
    float a[V], b[V];
    load<T, V>(img + e, a);
    load<T, V>(img + e + STRIDE, b);
    welford<V>(cnt, mean, m2, a);
    welford<V>(cnt, mean, m2, b);
  }
  if (e < end) {
    float a[V];
    load<T, V>(img + e, a);
    welford<V>(cnt, mean, m2, a);
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s_n[t * V + j] = cnt;
    s_mean[t * V + j] = mean[j];
    s_m2[t * V + j] = m2[j];
  }
  __syncthreads();

  // item i = ch + c * k holds channel ch: fold items [keep, len) of every
  // channel onto [0, len - keep), halving until one is left
  for (int len = THREADS * V / c; len > 1;) {
    const int half = len / 2, keep = len - half;
    for (int i = t; i < c * half; i += THREADS) {
      const int a = i, b = i + c * keep;
      Moments m = {s_n[a], s_mean[a], s_m2[a]};
      merge(m, Moments{s_n[b], s_mean[b], s_m2[b]});
      s_n[a] = m.n;
      s_mean[a] = m.mean;
      s_m2[a] = m.m2;
    }
    len = keep;
    __syncthreads();
  }
  for (int ch = t; ch < c; ch += THREADS) {  // C may exceed THREADS (AdaIN's 512)
    float* p = partial + ((static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * c + ch) * 3;
    p[0] = s_n[ch];
    p[1] = s_mean[ch];
    p[2] = s_m2[ch];
  }
}

// Block (n * c + ch) merges the `splits` slabs' moments of channel ch of
// image n in a fixed order and writes its mean and rsqrt(var + eps), var =
// M2 / (count - correction).
__global__ void __launch_bounds__(MERGE_THREADS)
    instance_norm_merge_kernel(const float* __restrict__ partial, float* __restrict__ mean,
                               float* __restrict__ rstd, int splits, int c, float eps, float correction) {
  __shared__ Moments s[MERGE_THREADS];
  const int t = threadIdx.x;
  const int n = blockIdx.x / c, ch = blockIdx.x % c;
  Moments m = {0.f, 0.f, 0.f};
  for (int k = t; k < splits; k += MERGE_THREADS) {
    const float* p = partial + ((static_cast<long long>(n) * splits + k) * c + ch) * 3;
    merge(m, Moments{p[0], p[1], p[2]});
  }
  s[t] = m;
  __syncthreads();
  for (int w = MERGE_THREADS / 2; w > 0; w /= 2) {
    if (t < w) merge(s[t], s[t + w]);
    __syncthreads();
  }
  if (t == 0) {
    const float var = __fdiv_rn(s[0].m2, __fsub_rn(s[0].n, correction));
    mean[blockIdx.x] = s[0].mean;
    rstd[blockIdx.x] = rsqrtf(__fadd_rn(var, eps));
  }
}

// Grid (blocks, n): image n's elements, THREADS * V * blocks apart for a
// thread. out is T, or uint8 for TANH_U8; skip is [n, h + 4, w + 4, c].
template <typename T, int V, int EPI>
__global__ void __launch_bounds__(THREADS)
    instance_norm_apply_kernel(const T* __restrict__ x, const T* __restrict__ skip, void* __restrict__ out,
                               const float* __restrict__ mean, const float* __restrict__ rstd,
                               const float* __restrict__ scale, const float* __restrict__ shift, int h,
                               int w, int c) {
  const long long hwc = static_cast<long long>(h) * w * c;
  const int n = blockIdx.y;
  const long long step = static_cast<long long>(gridDim.x) * THREADS * V;
  long long e = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) * V;
  float mu[V], rs[V], sc[V], sh[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int ch = static_cast<int>((e + j) % c);  // the same on every step: step % c == 0
    mu[j] = mean[n * c + ch];
    rs[j] = rstd[n * c + ch];
    sc[j] = scale[ch];
    sh[j] = shift[ch];
  }
  const T* xi = x + n * hwc;
  const long long row = static_cast<long long>(w) * c;
  const T* si = EPI == RESIDUAL ? skip + n * (h + 4LL) * (w + 4LL) * c : nullptr;
  // the skip under output element `at`: each output row is a run of a skip row
  auto skip_at = [&](long long at) {
    const long long y = at / row;
    return si + ((y + 2) * (w + 4) + 2) * c + (at - y * row);
  };
  // x's vector v at output element `at` (r: the skip's there) normalized,
  // through the epilogue, and stored
  auto finish = [&](float (&v)[V], const float (&r)[V], long long at) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float z = __fmul_rn(__fsub_rn(v[j], mu[j]), rs[j]);
      v[j] = round_to<T>(__fadd_rn(__fmul_rn(sc[j], z), sh[j]));
    }
    if constexpr (EPI == RELU) {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = v[j] < 0.f ? 0.f : v[j];
    } else if constexpr (EPI == RESIDUAL) {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = round_to<T>(__fadd_rn(v[j], r[j]));
    } else if constexpr (EPI == TANH || EPI == TANH_U8) {
#pragma unroll
      for (int j = 0; j < V; ++j)
        v[j] = round_to<T>(__fdiv_rn(__fadd_rn(__fmul_rn(255.f, tanhf(v[j])), 255.f), 2.f));
    }
    if constexpr (EPI == TANH_U8) {
      uint8_t b[V];
#pragma unroll
      for (int j = 0; j < V; ++j) b[j] = static_cast<uint8_t>(fminf(fmaxf(v[j], 0.f), 255.f));
      store_u8<V>(static_cast<uint8_t*>(out) + n * hwc + at, b);
    } else {
      store<T, V>(static_cast<T*>(out) + n * hwc + at, v);
    }
  };
  for (; e + step < hwc; e += 2 * step) {  // two vectors in flight a thread
    float a[V], b[V], ra[V], rb[V];
    load<T, V>(xi + e, a);
    load<T, V>(xi + e + step, b);
    if constexpr (EPI == RESIDUAL) {
      load<T, V>(skip_at(e), ra);
      load<T, V>(skip_at(e + step), rb);
    }
    finish(a, ra, e);
    finish(b, rb, e + step);
  }
  if (e < hwc) {
    float a[V], ra[V];
    load<T, V>(xi + e, a);
    if constexpr (EPI == RESIDUAL) load<T, V>(skip_at(e), ra);
    finish(a, ra, e);
  }
}

template <typename T>
struct Type {
  using type = T;
};
template <int N>
using Int = std::integral_constant<int, N>;

// f(Type<T>{}, Int<V>{}) for the element type and vector width asked for.
template <typename F>
cudaError_t with_type(int is_bf16, int vec, F f) {
  if (is_bf16 && vec == 8) return f(Type<__nv_bfloat16>{}, Int<8>{});
  if (is_bf16 && vec == 1) return f(Type<__nv_bfloat16>{}, Int<1>{});
  if (!is_bf16 && vec == 4) return f(Type<float>{}, Int<4>{});
  if (!is_bf16 && vec == 1) return f(Type<float>{}, Int<1>{});
  return cudaErrorInvalidValue;
}

// f(Int<EPI>{}) for the epilogue asked for.
template <typename F>
cudaError_t with_epilogue(int epilogue, F f) {
  switch (epilogue) {
    case NONE:
      return f(Int<NONE>{});
    case RELU:
      return f(Int<RELU>{});
    case RESIDUAL:
      return f(Int<RESIDUAL>{});
    case TANH:
      return f(Int<TANH>{});
    case TANH_U8:
      return f(Int<TANH_U8>{});
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x: [n, hwc] contiguous, float32 (is_bf16 == 0) or bfloat16; vec is 16 /
// element size (x 16-byte aligned, hwc a multiple of it) or 1; c divides
// THREADS * vec. partial: scratch of n * splits * c * 3 floats; slab a
// multiple of THREADS * vec with splits * slab >= hwc. mean, rstd: [n, c]
// float32, rstd = rsqrt(M2 / (count - correction) + eps). Two launches;
// returns cudaGetLastError() of the last, or the first error.
int fs_instance_norm_stats(const void* x, void* partial, void* mean, void* rstd, int is_bf16, int vec, int n,
                           long long hwc, int c, int splits, long long slab, float eps, int correction,
                           void* stream) {
  if (c <= 0 || (THREADS * vec) % c != 0 || correction < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  return static_cast<int>(with_type(is_bf16, vec, [&](auto t, auto v) {
    using T = typename decltype(t)::type;
    instance_norm_stats_kernel<T, decltype(v)::value>
        <<<dim3(splits, n), THREADS, 0, s>>>(static_cast<const T*>(x), p, hwc, c, slab);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    instance_norm_merge_kernel<<<n * c, MERGE_THREADS, 0, s>>>(
        p, static_cast<float*>(mean), static_cast<float*>(rstd), splits, c, eps, static_cast<float>(correction));
    return cudaGetLastError();
  }));
}

// x, out: [n, h, w, c] contiguous (out uint8 for epilogue 4, else x's
// type); skip: [n, h + 4, w + 4, c] of x's type for epilogue 2, else
// unused; mean, rstd: [n, c], scale, shift: [c], float32. Epilogues: 0
// none, 1 relu, 2 residual, 3 tanh, 4 tanh_u8. vec and c as for the stats,
// with skip 16-byte aligned and c a multiple of vec for the residual. One
// launch.
int fs_instance_norm_apply(const void* x, const void* skip, void* out, const void* mean, const void* rstd,
                           const void* scale, const void* shift, int is_bf16, int vec, int epilogue, int n,
                           int h, int w, int c, int blocks, void* stream) {
  if (c <= 0 || (THREADS * vec) % c != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_type(is_bf16, vec, [&](auto t, auto v) {
    using T = typename decltype(t)::type;
    return with_epilogue(epilogue, [&](auto epi) {
      instance_norm_apply_kernel<T, decltype(v)::value, decltype(epi)::value><<<dim3(blocks, n), THREADS, 0, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(skip), out, static_cast<const float*>(mean),
          static_cast<const float*>(rstd), static_cast<const float*>(scale), static_cast<const float*>(shift), h,
          w, c);
      return cudaGetLastError();
    });
  }));
}

// per_sm[0], per_sm[1]: how many blocks of the statistics and of the apply
// kernel one SM of the current device holds at once, for these arguments.
int fs_instance_norm_blocks_per_sm(int is_bf16, int vec, int epilogue, int* per_sm) {
  return static_cast<int>(with_type(is_bf16, vec, [&](auto t, auto v) {
    using T = typename decltype(t)::type;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm[0], instance_norm_stats_kernel<T, decltype(v)::value>, THREADS, 0);
    if (e != cudaSuccess) return e;
    return with_epilogue(epilogue, [&](auto epi) {
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm[1], instance_norm_apply_kernel<T, decltype(v)::value, decltype(epi)::value>, THREADS, 0);
    });
  }));
}

const char* fs_cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"

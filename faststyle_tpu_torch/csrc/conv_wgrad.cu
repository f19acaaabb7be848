// Weight gradient of a 2-D convolution for NVIDIA Hopper (sm_90a), plain C
// interface, deterministic by construction.
//
//   dW[o, i, kh, kw] = sum over n, y, x of dY[n, y, x, o] * Xpad[n, y*s + kh, x*s + kw, i]
//
// X [n, h, w, ci] and dY [n, oh, ow, co] are NHWC in memory (the port's
// channels_last activations); Xpad is X with `ph` / `pw` zero rows and
// columns on both sides, read through masks, never materialized. dW is
// written in torch's OIHW layout, float32.
//
// No TPU kernel stands behind it: the JAX package takes its convolution
// gradients from XLA. It replaces cuDNN's default weight-gradient
// algorithms in the train step, which split the reduction and add the parts
// with atomics in an order that changes from run to run.
//
// The work is an implicit GEMM, C[p, o] = sum over rows q of A[q, p] B[q, o]:
// rows q are the n*oh*ow output pixels, A the im2col rows of X (p = (kh, kw,
// i), kh*kw*ci wide, gathered on the fly) and B the rows of dY. The
// kh*kw*ci side (up to 1296 wide) is the mma's M side and co (3 to 128) its
// N side, so co = 3 wastes five of an n8 tile's eight columns, not thirteen
// of an m16 tile's sixteen rows.
//
// The bound on an H100 (3.35 TB/s; TF32 495 TFLOP/s and bf16 989 on the
// tensor cores) for the six weight gradients of a b4@256 train step: 9.78
// GFLOP and 157.9 MB (float32; 79.1 MB in bf16) with X and dY read once and
// dW written once. float32 runs as 3xTF32, three tensor-core passes, so it is
// bound by its operations (0.059 ms; the bytes take 0.047); bf16 by its
// bytes (0.024 ms). At FFMA's 67 TFLOP/s the float32 work would take 0.146.
//
// How the design answers it:
//  1. Tensor cores through mma.sync, as csrc/gram.cu runs them: bf16 as
//     m16n8k16 with fragments by ldmatrix.trans (both operands are stored
//     [row q][column], so both come transposed), float32 as 3xTF32 (hi and lo
//     parts rounded to TF32 to nearest, lo*hi + hi*lo + hi*hi summed in f32
//     by m16n8k8): near-f32 error where 1xTF32 would leave ~2^-11. Each k8
//     step's three products are summed from zero and added to the running
//     sum by a rounded FADD (the tensor cores truncate as they accumulate).
//  2. A block owns a 128 x TC output tile (TC = 8, 16, 32 or 64 by co) and a
//     slice of the rows; it walks the slice in stages of 32 rows through two
//     shared-memory buffers, the next stage's global loads held in registers
//     while the tensor cores work on the current one (one barrier a stage).
//     Each thread gathers fixed im2col columns: their (kh, kw, i) offset is
//     decoded once, the pixel advances incrementally, and a warp's lanes
//     read consecutive columns, i.e. runs of kw*ci consecutive elements of a
//     row of X. Where ci (co for dY) holds whole 16-byte runs, a thread
//     moves 16 bytes of one tap at a time (a quarter or an eighth of the
//     load instructions); rows of 3 channels (12 bytes in float32, 6 in
//     bf16) take single elements, which need no alignment.
//  3. The rows are split across blocks as far as filling the card's block
//     slots needs, capped so the float32 split scratch stays at or under
//     half the input's bytes (the plan of ops/cuda/conv_wgrad.py, after
//     ops/cuda/gram.py's). One split writes dW straight from the tile kernel
//     (one launch); more write partial tiles that wgrad_reduce_kernel adds in
//     a fixed order. No atomics anywhere: two calls give the same bits.
//
// Ragged edges (columns past kh*kw*ci or co, rows past a slice) load as zero
// and are not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int KSTEP = 32;     // rows (output pixels) per stage
constexpr int TP = 128;       // im2col columns (kh, kw, i) per tile: the mma's M side

// The geometry of one call.
struct Geom {
  int h, w, ci;        // X, NHWC, without its zero pads
  int oh, ow, co;      // dY, NHWC
  int kh, kw, s, ph, pw;
  int p;               // kh * kw * ci
  long long rows;      // n * oh * ow
  long long chunk;     // rows per split, a multiple of KSTEP
};

// A 128 x TC tile over 8 warps: WARPS_M x WARPS_N warps of WM x WN each.
// Global loads move VA elements of a row of A (VB of B) at a time: 16 bytes
// when the channels allow it, else one element.
template <int TC>
struct Tile {
  static constexpr int PA = TP + 8;                   // A row pitch, elements
  static constexpr int PB = TC + 8 < 24 ? 24 : TC + 8;  // B row pitch: conflict-free fragment loads
  static constexpr int WARPS_N = TC >= 32 ? 2 : 1;
  static constexpr int WARPS_M = 8 / WARPS_N;
  static constexpr int WM = TP / WARPS_M;
  static constexpr int WN = TC / WARPS_N;
  static constexpr int MT = WM / 16;                  // m16 fragments per warp
  static constexpr int NT = WN / 8;                   // n8 fragments per warp
  static constexpr int STAGE = KSTEP * (PA + PB);     // elements of one buffer
  static_assert(WARPS_M * WARPS_N == 8 && MT >= 1 && NT >= 1, "8 warps tile the block");
};

// How a stage's KSTEP rows of WIDTH columns are loaded, V elements a copy:
// copy i (= tid + j*THREADS) takes row i / COLS, columns (i % COLS) * V..,
// so a thread keeps its columns across its copies and stages.
template <int WIDTH, int V>
struct Copies {
  static constexpr int COLS = WIDTH / V;                       // copies per row
  static constexpr int STEP = THREADS / COLS;                  // rows between a thread's copies
  static constexpr int TOTAL = KSTEP * COLS;
  static constexpr int PER = (TOTAL + THREADS - 1) / THREADS;  // copies a thread makes per stage
  static_assert(THREADS % COLS == 0 && WIDTH % V == 0, "copies tile the stage");
};

// 16 bytes moved as one load or store, or one element
template <typename T, int V>
using Chunk = std::conditional_t<V == 1, T, uint4>;

template <typename T>
constexpr int smem_bytes(int tc) {
  return 2 * KSTEP * ((TP + 8) + (tc + 8 < 24 ? 24 : tc + 8)) * static_cast<int>(sizeof(T));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Round to TF32 to nearest, ties away (what cvt.rna.tf32.f32 does), in two
// integer operations, as csrc/gram.cu does.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four transposed 8x8 bf16 matrices; lanes 8i..8i+7 give matrix i's rows.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Two transposed 8x8 bf16 matrices; lanes 0..7 and 8..15 give their rows.
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// One stage of 3xTF32 on float32 buffers a [KSTEP][PA], b [KSTEP][PB]; the
// warp owns rows mb.. of the tile and columns nb..
template <int TC>
__device__ __forceinline__ void mma_stage(float (&acc)[Tile<TC>::MT][Tile<TC>::NT][4],
                                          const float* a, const float* b, int mb, int nb,
                                          int lane) {
  using S = Tile<TC>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < KSTEP; k0 += 8) {
    uint32_t ah[S::MT][4], al[S::MT][4], bh[S::NT][2], bl[S::NT][2];
#pragma unroll
    for (int i = 0; i < S::MT; ++i) {
      // A fragment (m16 x k8, row): (g, t) (g+8, t) (g, t+4) (g+8, t+4)
      const float* p = a + (k0 + t) * S::PA + mb + i * 16 + g;
      const float v[4] = {p[0], p[8], p[4 * S::PA], p[4 * S::PA + 8]};
#pragma unroll
      for (int r = 0; r < 4; ++r) split_tf32(v[r], ah[i][r], al[i][r]);
    }
#pragma unroll
    for (int j = 0; j < S::NT; ++j) {
      // B fragment (k8 x n8, col): (k=t, n=g) (k=t+4, n=g)
      const float* p = b + (k0 + t) * S::PB + nb + j * 8 + g;
      split_tf32(p[0], bh[j][0], bl[j][0]);
      split_tf32(p[4 * S::PB], bh[j][1], bl[j][1]);
    }
    // The tensor cores add a product to their accumulator with its low bits
    // cut, not rounded: against a running sum over thousands of rows that
    // bias grows with the slice (8e-5 of max |dW| over 10944 rows on an
    // H100). So each k8 step sums its three passes from zero, the small
    // terms first, and is added to the running sum by a rounded FADD.
#pragma unroll
    for (int i = 0; i < S::MT; ++i)
#pragma unroll
      for (int j = 0; j < S::NT; ++j) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(part, al[i], bh[j]);
        mma_tf32(part, ah[i], bl[j]);
        mma_tf32(part, ah[i], bh[j]);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] += part[r];
      }
  }
}

// One stage on bf16 buffers: m16n8k16 with fragments by ldmatrix.trans.
template <int TC>
__device__ __forceinline__ void mma_stage(float (&acc)[Tile<TC>::MT][Tile<TC>::NT][4],
                                          const __nv_bfloat16* a, const __nv_bfloat16* b,
                                          int mb, int nb, int lane) {
  using S = Tile<TC>;
  const int l7 = lane & 7, l8 = (lane >> 3) & 1, l16 = lane >> 4;
#pragma unroll
  for (int k0 = 0; k0 < KSTEP; k0 += 16) {
    uint32_t af[S::MT][4], bf[S::NT][2];
#pragma unroll
    for (int i = 0; i < S::MT; ++i) {
      // matrices (k0, m) (k0, m+8) (k0+8, m) (k0+8, m+8) -> a0..a3
      const int k = k0 + l7 + l16 * 8;
      const int m = mb + i * 16 + l8 * 8;
      ldsm_x4_t(af[i], smem_u32(a + k * S::PA + m));
    }
    if constexpr (S::NT % 2 == 0) {
#pragma unroll
      for (int j = 0; j < S::NT; j += 2) {
        // matrices (k0, n) (k0+8, n) (k0, n+8) (k0+8, n+8) -> b0,b1 of j, j+1
        const int k = k0 + l7 + l8 * 8;
        const int n = nb + j * 8 + l16 * 8;
        uint32_t r[4];
        ldsm_x4_t(r, smem_u32(b + k * S::PB + n));
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
    } else {
      // matrices (k0, n) (k0+8, n) -> b0, b1
      ldsm_x2_t(bf[0], smem_u32(b + (k0 + l7 + l8 * 8) * S::PB + nb));
    }
#pragma unroll
    for (int i = 0; i < S::MT; ++i)
#pragma unroll
      for (int j = 0; j < S::NT; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
  }
}

// Grid (tile, split). Block (tile, split) sums rows [split*chunk,
// (split+1)*chunk) into the 128 x TC tile of dW^T it owns; with `direct` it
// writes dW (OIHW) itself, else its partial tile into dst[split] ([p][co]).
template <typename T, int TC, int VA, int VB>
__global__ void __launch_bounds__(THREADS, 2)
wgrad_tile_kernel(const T* __restrict__ x, const T* __restrict__ dy, float* __restrict__ dst,
                  Geom g, int direct) {
  using S = Tile<TC>;
  using CA = Copies<TP, VA>;
  using CB = Copies<TC, VB>;
  using AV = Chunk<T, VA>;
  using BV = Chunk<T, VB>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int ntc = (g.co + TC - 1) / TC;
  const int p0 = blockIdx.x / ntc * TP;
  const int c0 = blockIdx.x % ntc * TC;
  const int split = blockIdx.y;
  const long long q_begin = static_cast<long long>(split) * g.chunk;
  const long long q_end = q_begin + g.chunk < g.rows ? q_begin + g.chunk : g.rows;
  const int steps = static_cast<int>((q_end - q_begin + KSTEP - 1) / KSTEP);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int mb = warp / S::WARPS_N * S::WM;
  const int nb = warp % S::WARPS_N * S::WN;

  // this thread's im2col columns pcol..pcol+VA-1: one tap, VA channels
  // (ci % VA == 0), so one mask and one 16-byte load serve them all
  const int pa = tid % CA::COLS * VA, ra = tid / CA::COLS;
  const int pcol = p0 + pa;
  const bool p_ok = pcol < g.p;
  const int ci_i = p_ok ? pcol % g.ci : 0;
  const int win = p_ok ? pcol / g.ci : 0;
  const int dyo = win / g.kw - g.ph;  // row offset of the tap from y*s
  const int dxo = win % g.kw - g.pw;  // column offset of the tap from x*s
  // this thread's dY columns
  const int cb = tid % CB::COLS * VB, rb = tid / CB::COLS;
  const bool c_ok = c0 + cb < g.co;

  AV a_reg[CA::PER];
  BV b_reg[CB::PER];
  // global -> registers: the stage whose first row is q0
  auto load = [&](long long q0) {
    long long q = q0 + ra;
    int xq = static_cast<int>(q % g.ow);
    long long rest = q / g.ow;
    int yq = static_cast<int>(rest % g.oh);
    long long nq = rest / g.oh;
#pragma unroll
    for (int j = 0; j < CA::PER; ++j) {
      const int yy = yq * g.s + dyo, xx = xq * g.s + dxo;
      const bool ok = p_ok && q < q_end && yy >= 0 && yy < g.h && xx >= 0 && xx < g.w;
      a_reg[j] = ok ? *reinterpret_cast<const AV*>(x + ((nq * g.h + yy) * g.w + xx) * g.ci + ci_i) : AV{};
      q += CA::STEP;
      xq += CA::STEP;
      while (xq >= g.ow) {
        xq -= g.ow;
        if (++yq == g.oh) {
          yq = 0;
          ++nq;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < CB::PER; ++j) {
      const long long qb = q0 + rb + j * CB::STEP;
      const bool ok = c_ok && qb < q_end && rb + j * CB::STEP < KSTEP;
      b_reg[j] = ok ? *reinterpret_cast<const BV*>(dy + qb * g.co + c0 + cb) : BV{};
    }
  };
  // registers -> shared buffer `buf`
  auto store = [&](int buf) {
    T* a = smem + buf * S::STAGE;
    T* b = a + KSTEP * S::PA;
#pragma unroll
    for (int j = 0; j < CA::PER; ++j)
      *reinterpret_cast<AV*>(a + (ra + j * CA::STEP) * S::PA + pa) = a_reg[j];
#pragma unroll
    for (int j = 0; j < CB::PER; ++j)
      if (CB::TOTAL % THREADS == 0 || rb + j * CB::STEP < KSTEP)
        *reinterpret_cast<BV*>(b + (rb + j * CB::STEP) * S::PB + cb) = b_reg[j];
  };

  float acc[S::MT][S::NT][4];
#pragma unroll
  for (int i = 0; i < S::MT; ++i)
#pragma unroll
    for (int j = 0; j < S::NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  if (steps > 0) {
    load(q_begin);
    store(0);
  }
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int cur = step & 1;
    const bool more = step + 1 < steps;
    if (more) load(q_begin + static_cast<long long>(step + 1) * KSTEP);  // in flight under the math
    const T* a = smem + cur * S::STAGE;
    mma_stage<TC>(acc, a, a + KSTEP * S::PA, mb, nb, lane);
    if (more) store(cur ^ 1);
    __syncthreads();
  }

  // C fragment: (g, 2t) (g, 2t+1) (g+8, 2t) (g+8, 2t+1)
  const int gq = lane >> 2, t = lane & 3;
  const int kk = g.kh * g.kw;
#pragma unroll
  for (int i = 0; i < S::MT; ++i)
#pragma unroll
    for (int j = 0; j < S::NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = p0 + mb + i * 16 + gq + (r >> 1) * 8;  // (kh, kw, i)
        const int n = c0 + nb + j * 8 + 2 * t + (r & 1);     // o
        if (m < g.p && n < g.co) {
          if (direct)
            dst[(static_cast<long long>(n) * g.ci + m % g.ci) * kk + m / g.ci] = acc[i][j][r];
          else
            dst[(static_cast<long long>(split) * g.p + m) * g.co + n] = acc[i][j][r];
        }
      }
}

// dW (OIHW) = sum over splits of partial[split] ([p][co] each), in a fixed
// order. A block owns RED_ELEMS outputs; thread way w of an output adds
// splits w, w + RED_WAYS, ... in order, and one thread adds the RED_WAYS
// sums in a fixed order: deterministic, with loads in flight.
constexpr int RED_ELEMS = 64;
constexpr int RED_WAYS = 4;

__global__ void __launch_bounds__(RED_ELEMS * RED_WAYS)
wgrad_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out, int p, int co,
                    int ci, int kk, int splits) {
  __shared__ float sums[RED_WAYS][RED_ELEMS];
  const int e = threadIdx.x % RED_ELEMS;
  const int way = threadIdx.x / RED_ELEMS;
  const long long idx = static_cast<long long>(blockIdx.x) * RED_ELEMS + e;  // OIHW index
  const long long total = static_cast<long long>(p) * co;
  float s = 0.f;
  long long src = 0;
  if (idx < total) {
    const int o = static_cast<int>(idx / (static_cast<long long>(ci) * kk));
    const int rem = static_cast<int>(idx % (static_cast<long long>(ci) * kk));
    const int m = rem % kk * ci + rem / kk;  // (kh, kw, i) from (i, kh, kw)
    src = static_cast<long long>(m) * co + o;
#pragma unroll 4
    for (int sp = way; sp < splits; sp += RED_WAYS) s += partial[sp * total + src];
  }
  sums[way][e] = s;
  __syncthreads();
  if (way == 0 && idx < total) out[idx] = (sums[0][e] + sums[1][e]) + (sums[2][e] + sums[3][e]);
}

template <typename T, int TC, int VA, int VB>
cudaError_t launch_tiles(const void* x, const void* dy, float* dst, const Geom& g, int splits,
                         int direct, cudaStream_t stream) {
  constexpr int smem = smem_bytes<T>(TC);
  // A function's attributes belong to one device's context: set them once
  // per kernel and device (bit d of `ready`), before the first launch there.
  static std::atomic<unsigned long long> ready{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;  // beyond 64: every launch
  if (!bit || !(ready.load(std::memory_order_relaxed) & bit)) {
    e = cudaFuncSetAttribute(wgrad_tile_kernel<T, TC, VA, VB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(wgrad_tile_kernel<T, TC, VA, VB>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    ready.fetch_or(bit, std::memory_order_relaxed);
  }
  const dim3 grid(((g.p + TP - 1) / TP) * ((g.co + TC - 1) / TC), splits);
  wgrad_tile_kernel<T, TC, VA, VB><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), dst, g, direct);
  return cudaGetLastError();
}

template <typename T, int TC>
cudaError_t launch_vec(bool va, bool vb, const void* x, const void* dy, float* dst, const Geom& g,
                       int splits, int direct, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (va && vb) return launch_tiles<T, TC, V, V>(x, dy, dst, g, splits, direct, stream);
  if (va) return launch_tiles<T, TC, V, 1>(x, dy, dst, g, splits, direct, stream);
  if (vb) return launch_tiles<T, TC, 1, V>(x, dy, dst, g, splits, direct, stream);
  return launch_tiles<T, TC, 1, 1>(x, dy, dst, g, splits, direct, stream);
}

// 16-byte loads of X when its rows hold whole 16-byte runs of channels and
// its base is 16-byte aligned (so every tap's run is), likewise for dY
template <typename T>
cudaError_t launch_any(int tc, const void* x, const void* dy, float* dst, const Geom& g,
                       int splits, int direct, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool va = g.ci % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vb = g.co % V == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  switch (tc) {
    case 8: return launch_vec<T, 8>(va, vb, x, dy, dst, g, splits, direct, stream);
    case 16: return launch_vec<T, 16>(va, vb, x, dy, dst, g, splits, direct, stream);
    case 32: return launch_vec<T, 32>(va, vb, x, dy, dst, g, splits, direct, stream);
    case 64: return launch_vec<T, 64>(va, vb, x, dy, dst, g, splits, direct, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x: [n, h, w, ci], dy: [n, oh, ow, co], both contiguous, float32 (is_bf16
// == 0) or bfloat16, with oh = (h + 2 ph - kh) / s + 1 (likewise ow). out:
// [co, ci, kh, kw] float32. partial: scratch of splits * kh*kw*ci * co
// floats, unused when splits == 1. Rows [sp*chunk, (sp+1)*chunk) of the
// n*oh*ow output pixels go to split sp; the caller makes chunk a multiple of
// 32 and splits*chunk >= n*oh*ow, and tc one of 8, 16, 32, 64. One launch
// when splits == 1, else two. Returns cudaGetLastError() of the last launch,
// or the first error.
int fs_conv_wgrad(const void* x, const void* dy, void* partial, void* out, int is_bf16, int n,
                  int h, int w, int ci, int oh, int ow, int co, int kh, int kw, int s, int ph,
                  int pw, int splits, long long chunk, int tc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Geom g;
  g.h = h, g.w = w, g.ci = ci, g.oh = oh, g.ow = ow, g.co = co;
  g.kh = kh, g.kw = kw, g.s = s, g.ph = ph, g.pw = pw;
  g.p = kh * kw * ci;
  g.rows = static_cast<long long>(n) * oh * ow;
  g.chunk = chunk;
  const int direct = splits == 1;
  float* dst = static_cast<float*>(direct ? out : partial);
  cudaError_t err = is_bf16 ? launch_any<__nv_bfloat16>(tc, x, dy, dst, g, splits, direct, st)
                            : launch_any<float>(tc, x, dy, dst, g, splits, direct, st);
  if (err != cudaSuccess || direct) return static_cast<int>(err);
  const long long total = static_cast<long long>(g.p) * co;
  const unsigned blocks = static_cast<unsigned>((total + RED_ELEMS - 1) / RED_ELEMS);
  wgrad_reduce_kernel<<<blocks, RED_ELEMS * RED_WAYS, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), g.p, co, ci, kh * kw, splits);
  return static_cast<int>(cudaGetLastError());
}

const char* fs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

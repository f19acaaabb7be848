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
//
// That is the tile design. It gathers each X value once per tap: 81 times
// at a 9x9, which at the train step's two 9x9 convs (x 4x336x336x3 -> 16,
// and 4x256x256x16 -> 3) moves 0.46 and 1.48 GB through L2 for 34 and 20
// MB of input. So float32 shapes with small channel counts and wide kernels
// (ops/cuda/conv_wgrad.py `design`) take the strip design instead:
//  4. A block walks a fixed, contiguous run of strips: R output rows x Wt
//     output columns of one image (strip_plan in ops/cuda/conv_wgrad.py).
//     For each it copies the patch of X those pixels read, ((R-1)s + kh)
//     rows x ((Wt-1)s + kw) columns x ci, into shared memory once (cells in
//     the zero pad or past the image copy as zero), and the strip's dY rows
//     beside it, both by cp.async into a ring of two stages: the next
//     strip's copies fly while the tensor cores work on this one. A patch
//     row is one run of NHWC memory: copied 16 bytes at a time where ci % 4
//     == 0 and X is 16-byte aligned, else 4 bytes (ci = 3).
//  5. The im2col is never built: element (pixel q, column p) of A is
//     patch[qoff(q) + poff(p)], qoff from the pixel's row and column in the
//     strip times s, poff from (kh, kw, i), decoded once per thread for its
//     fragment rows. For ci = 16 at stride 1, the channel halves of a patch
//     column swap by the column's bit 1, so the fragment loads of lanes (g,
//     t) hit 32 distinct banks; dY pixels sit 8 or 24 floats apart, for the
//     same reason.
//  6. Two forms (strip_form): pixels on K keeps all of p (padded to m16
//     tiles, MT a warp) x co (padded to n8) in registers and splits each
//     landed stage into TF32 hi/lo parts once; where kw*co <= 32 at stride
//     1 (the final 9x9, co = 3), kw moves onto the N side instead
//     (wgrad_strip_kn_kernel), filling 27 of 32 columns where pixels on K
//     fills 3 of 8. Either block writes its sums once, to dW or to its
//     partial, which wgrad_reduce_kernel adds in a fixed order, as for the
//     tile design.

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

// cp.async of BYTES (4 or 16) bytes; copies zeros instead when !ok (src is
// then not read)
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool ok) {
  const int n = ok ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
                 "n"(BYTES), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// A function's attributes belong to one device's context: set its dynamic
// shared memory limit and carveout once per kernel and device (bit d of
// `ready`, one per kernel instance), before the first launch there.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem, std::atomic<unsigned long long>& ready) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;  // beyond 64: every launch
  if (bit && (ready.load(std::memory_order_relaxed) & bit)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) ready.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

template <typename T, int TC, int VA, int VB>
cudaError_t launch_tiles(const void* x, const void* dy, float* dst, const Geom& g, int splits,
                         int direct, cudaStream_t stream) {
  constexpr int smem = smem_bytes<T>(TC);
  static std::atomic<unsigned long long> ready{0};
  const cudaError_t e = prepare(wgrad_tile_kernel<T, TC, VA, VB>, smem, ready);
  if (e != cudaSuccess) return e;
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

// ---- The strip design (float32) ----

// The strip geometry of one call (strip_plan in ops/cuda/conv_wgrad.py
// chooses r, wt, pc, rp, dp, swz, dswz and per; the rest follows).
struct Strip {
  int r, wt;        // output rows and columns of a strip; wt a multiple of 8
  int pr, pc;       // patch rows (r-1)*s + kh; columns >= (wt-1)*s + kw (kw on N: a multiple of 8)
  int rp;           // patch row pitch, floats: >= pc*ci, a multiple of 4
  int dp;           // dY pixel pitch, floats: 8 (co <= 8) or 16
  int swz;          // 8: a patch column's channel halves swap by its bit 1 (ci == 16, s == 1); else 0
  int dswz;         // 8: a dY pixel's channel halves swap by its bit 1 (co > 8); else 0
  int sy, sx;       // strips down and across one image
  long long total;  // n * sy * sx
  int per;          // strips a block walks
  int raw;          // floats of one ring stage as copied: the patch, then the dY rows
};

constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may have on sm_90
constexpr int KN_NT = 2;          // n8 tiles a warp of the kw-on-N kernel holds

__device__ __forceinline__ int swap_if(int c, int swz) { return (c >> 1 & 1) ? swz : 0; }

// Strip j's image and the output pixel at its top left.
__device__ __forceinline__ void strip_origin(const Strip& st, long long j, long long& img, int& y0,
                                             int& x0) {
  img = j / (st.sy * st.sx);
  const int k = static_cast<int>(j - img * st.sy * st.sx);
  y0 = k / st.sx * st.r;
  x0 = k % st.sx * st.wt;
}

// Strip j into ring stage `stage` by cp.async: its X patch (cells in the
// zero pad or past the image copy as zero; a patch row is pc*ci consecutive
// floats of X, 16 bytes a copy where va) and its dY rows (pixels past oh or
// ow copy as zero; 16 bytes a copy where vb).
__device__ __forceinline__ void strip_issue(float* stage, long long j, const float* x,
                                            const float* dy, const Geom& g, const Strip& st,
                                            int va, int vb, int tid) {
  long long img;
  int y0, x0;
  strip_origin(st, j, img, y0, x0);
  const int gy0 = y0 * g.s - g.ph, gx0 = x0 * g.s - g.pw;
  const float* ximg = x + img * g.h * g.w * g.ci;
  // copy e = tid + k*THREADS is patch cell (r, c), chunk u of cv: decoded
  // once, then advanced by THREADS without a division
  const int cv = va ? g.ci / 4 : g.ci, width = va ? 4 : 1, run = st.pc * cv;
  const int dr = THREADS / run, dc = THREADS % run / cv, du = THREADS % cv;
  int r = tid / run, c = tid % run / cv, u = tid % cv;
  for (int e = tid; e < st.pr * run; e += THREADS) {
    const int i = u * width;
    const int yy = gy0 + r, xx = gx0 + c;
    const bool ok = yy >= 0 && yy < g.h && xx >= 0 && xx < g.w;
    const float* src = ok ? ximg + (static_cast<long long>(yy) * g.w + xx) * g.ci + i : x;
    const uint32_t to = smem_u32(stage + r * st.rp + c * g.ci + (i ^ swap_if(c, st.swz)));
    if (va)
      cp_async<16>(to, src, ok);
    else
      cp_async<4>(to, src, ok);
    u += du, c += dc, r += dr;
    if (u >= cv) u -= cv, ++c;
    if (c >= st.pc) c -= st.pc, ++r;
  }
  // copy e is chunk v of dv of the strip's pixel (qy, qx), likewise
  float* dys = stage + st.pr * st.rp;
  const int dv = vb ? g.co / 4 : g.co, dwidth = vb ? 4 : 1;
  const int dq = THREADS / dv, dvv = THREADS % dv;
  int qy = tid / dv / st.wt, qx = tid / dv % st.wt, v = tid % dv;
  for (int e = tid; e < st.r * st.wt * dv; e += THREADS) {
    const int q = qy * st.wt + qx, o = v * dwidth;
    const int yy = y0 + qy, xx = x0 + qx;
    const bool ok = yy < g.oh && xx < g.ow;
    const float* src = ok ? dy + ((img * g.oh + yy) * g.ow + xx) * g.co + o : dy;
    const uint32_t to = smem_u32(dys + q * st.dp + (o ^ swap_if(q, st.dswz)));
    if (vb)
      cp_async<16>(to, src, ok);
    else
      cp_async<4>(to, src, ok);
    v += dvv, qx += dq;
    if (v >= dv) v -= dv, ++qx;
    while (qx >= st.wt) qx -= st.wt, ++qy;
  }
}

// dY columns co..dp-1 of every pixel of both stages: zero for good (an n8
// tile reads them; the copies never write them)
__device__ __forceinline__ void strip_zero_pad(float* smem, const Geom& g, const Strip& st,
                                               int tid) {
  const int pad = st.dp - g.co, pixels = st.r * st.wt;
  for (int e = tid; e < 2 * pixels * pad; e += THREADS) {
    const int b = e / (pixels * pad), q = e % (pixels * pad) / pad, c = g.co + e % pad;
    smem[b * st.raw + st.pr * st.rp + q * st.dp + (c ^ swap_if(q, st.dswz))] = 0.f;
  }
}

// With HILO (pixels on K), a landed stage is split once: its TF32 hi parts
// in place, its lo parts into the one lo buffer (the stage before it is
// consumed, so the buffer is free). Each staged X value then serves every
// tap without a split; the ring takes three stages' room instead of two.
__device__ __forceinline__ void strip_split(float* stage, float* lo, int floats, int tid) {
  float4* h4 = reinterpret_cast<float4*>(stage);
  float4* l4 = reinterpret_cast<float4*>(lo);
  for (int e = tid; e < floats / 4; e += THREADS) {
    float4 v = h4[e], l;
    uint32_t hb, lb;
    split_tf32(v.x, hb, lb), v.x = __uint_as_float(hb), l.x = __uint_as_float(lb);
    split_tf32(v.y, hb, lb), v.y = __uint_as_float(hb), l.y = __uint_as_float(lb);
    split_tf32(v.z, hb, lb), v.z = __uint_as_float(hb), l.z = __uint_as_float(lb);
    split_tf32(v.w, hb, lb), v.w = __uint_as_float(hb), l.w = __uint_as_float(lb);
    h4[e] = v;
    l4[e] = l;
  }
}

// One operand value as its TF32 hi and lo parts: split here, or (HILO)
// read from the split stage and the lo buffer, lo_off floats on.
template <bool HILO>
__device__ __forceinline__ void tf32_at(const float* p, int lo_off, uint32_t& hi, uint32_t& lo) {
  if constexpr (HILO) {
    hi = __float_as_uint(p[0]);
    lo = __float_as_uint(p[lo_off]);
  } else {
    split_tf32(p[0], hi, lo);
  }
}

// acc += a*b in 3xTF32: three passes from zero, the small terms first, then
// one rounded FADD into the running sum (see mma_stage)
__device__ __forceinline__ void mma3(float (&acc)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(part, al, bh);
  mma_tf32(part, ah, bl);
  mma_tf32(part, ah, bh);
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r] += part[r];
}

// The ring walk both strip kernels share: strip j of [first, last) lands in
// stage (j - first) & 1 while strip j-1's math runs; `math(stage, lo_off,
// j)` consumes it.
template <bool HILO, typename Math>
__device__ __forceinline__ void strip_walk(float* smem, long long first, long long last,
                                           const float* x, const float* dy, const Geom& g,
                                           const Strip& st, int va, int vb, int tid, Math math) {
  if (first < last) strip_issue(smem, first, x, dy, g, st, va, vb, tid);
  cp_async_commit();
  for (long long j = first; j < last; ++j) {
    const int b = static_cast<int>(j - first) & 1;
    float* stage = smem + b * st.raw;
    cp_async_wait_all();  // strip j has landed (for this thread)
    __syncthreads();      // ... for every thread, and strip j-1's math is done
    if constexpr (HILO) {
      strip_split(stage, smem + 2 * st.raw, st.raw, tid);
      __syncthreads();
    }
    if (j + 1 < last)  // in flight under the math
      strip_issue(smem + (b ^ 1) * st.raw, j + 1, x, dy, g, st, va, vb, tid);
    cp_async_commit();
    math(stage, (2 - b) * st.raw, j);
  }
  cp_async_wait_all();
  __syncthreads();  // every warp is past its last stage: the ring is free
}

// Pixels on K: C[(kh, kw, i), o] over the strip's pixels. Grid (blocks):
// block b walks strips [b*per, min((b+1)*per, total)). Warp w owns im2col
// columns w*MT*16.. (MT m16 tiles) and all NT n8 tiles of co. With `direct`
// (one block) it writes dW (OIHW), else its partial [p][co] into dst[b].
// Each landed stage is split into hi/lo parts once (3-7% faster than
// splitting at every fragment load at the train step's 9x9s on an H100).
template <int MT, int NT>
__global__ void __launch_bounds__(THREADS, 2)
wgrad_strip_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                   float* __restrict__ dst, Geom g, Strip st, int va, int vb, int direct) {
  constexpr bool HILO = true;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int mb = warp * MT * 16;
  const long long first = static_cast<long long>(blockIdx.x) * st.per;
  const long long last = first + st.per < st.total ? first + st.per : st.total;
  strip_zero_pad(smem, g, st, tid);

  // poff of this thread's fragment rows g and g+8 of each m16 tile: patch
  // cell (kh, kw, i) seen from a pixel at the patch's origin. The lane's
  // pixel column is t (mod 4), so the cell's column is t + kw (mod 4) at
  // s == 1, the only stride that swizzles. Rows past p read cell 0 and are
  // never written.
  int poff[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mb + i * 16 + gq + h * 8;
      const int tap = m / g.ci, kx = tap % g.kw;
      poff[i][h] = m < g.p ? tap / g.kw * st.rp + kx * g.ci + (m % g.ci ^ swap_if(t + kx, st.swz)) : 0;
    }
  // this lane's dY columns in a pixel (bit 1 of its pixel is that of t)
  int bcol[NT];
#pragma unroll
  for (int jn = 0; jn < NT; ++jn) bcol[jn] = (jn * 8 + gq) ^ swap_if(t, st.dswz);

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const int a4 = 4 * g.s * g.ci;  // from a pixel to the one 4 columns on
  strip_walk<HILO>(smem, first, last, x, dy, g, st, va, vb, tid,
                   [&](const float* patch, int lo_off, long long j) {
    const float* dys = patch + st.pr * st.rp;
    long long img;
    int y0, x0;
    strip_origin(st, j, img, y0, x0);
    const int rows = min(st.r, g.oh - y0), cols = min(st.wt, g.ow - x0);
    for (int rr = 0; rr < rows; ++rr) {
#pragma unroll 2
      for (int xb = 0; xb < cols; xb += 8) {
        // k8 step over pixels xb..xb+7 of row rr: lane t takes xb+t and xb+t+4
        const float* pa = patch + rr * g.s * st.rp + (xb + t) * g.s * g.ci;  // + qoff
        const float* pb = dys + (rr * st.wt + xb + t) * st.dp;
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int jn = 0; jn < NT; ++jn) {
          // B fragment (k8 x n8, col): (k=t, n=g) (k=t+4, n=g)
          tf32_at<HILO>(pb + bcol[jn], lo_off, bh[jn][0], bl[jn][0]);
          tf32_at<HILO>(pb + 4 * st.dp + bcol[jn], lo_off, bh[jn][1], bl[jn][1]);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          // A fragment (m16 x k8, row): (g, t) (g+8, t) (g, t+4) (g+8, t+4)
          uint32_t ah[4], al[4];
          tf32_at<HILO>(pa + poff[i][0], lo_off, ah[0], al[0]);
          tf32_at<HILO>(pa + poff[i][1], lo_off, ah[1], al[1]);
          tf32_at<HILO>(pa + a4 + poff[i][0], lo_off, ah[2], al[2]);
          tf32_at<HILO>(pa + a4 + poff[i][1], lo_off, ah[3], al[3]);
#pragma unroll
          for (int jn = 0; jn < NT; ++jn) mma3(acc[i][jn], ah, al, bh[jn], bl[jn]);
        }
      }
    }
  });

  // C fragment: (g, 2t) (g, 2t+1) (g+8, 2t) (g+8, 2t+1)
  const int kk = g.kh * g.kw;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int jn = 0; jn < NT; ++jn)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = mb + i * 16 + gq + (r >> 1) * 8;  // (kh, kw, i)
        const int n = jn * 8 + 2 * t + (r & 1);         // o
        if (m < g.p && n < g.co) {
          if (direct)
            dst[(static_cast<long long>(n) * g.ci + m % g.ci) * kk + m / g.ci] = acc[i][jn][r];
          else
            dst[(static_cast<long long>(blockIdx.x) * g.p + m) * g.co + n] = acc[i][jn][r];
        }
      }
}

// kw on N, for stride 1: C[(kh, i), (kw, o)] = sum over the strip's rows y
// and patch columns x' of Xpad[y + kh, x', i] * dY[y, x' - kw, o], dY zero
// unless x' - kw is a pixel of the strip. For co = 3 at a 9x9 that fills 27
// of 32 columns (not 3 of 8) and takes ~2x fewer mma than pixels on K. Warp
// w owns n8 tiles (w % NW)*NTW.. (NW warps span N = kw*co <= 32) and all MT
// m16 tiles of kh*ci, over the strip's rows w / NW, + RG, ...; the RG row
// groups' sums are added in a fixed order at the end. Operands split at
// use: staging hi/lo parts narrowed the strips and ran slower here.
template <int MT>
__global__ void __launch_bounds__(THREADS, 2)
wgrad_strip_kn_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                      float* __restrict__ dst, Geom g, Strip st, int va, int vb, int direct) {
  constexpr int NTW = KN_NT, NW = 4 / NTW, RG = 8 / NW;
  constexpr bool HILO = false;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int nw = warp % NW, rg = warp / NW;
  const int mk = g.kh * g.ci, nk = g.kw * g.co;  // the M and N extents
  const long long first = static_cast<long long>(blockIdx.x) * st.per;
  const long long last = first + st.per < st.total ? first + st.per : st.total;
  strip_zero_pad(smem, g, st, tid);

  // rows g and g+8 of each m16 tile: patch cell (kh, 0, i) (the lane's
  // patch column is t mod 4)
  int poff[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = i * 16 + gq + h * 8;
      poff[i][h] = m < mk ? m / g.ci * st.rp + (m % g.ci ^ swap_if(t, st.swz)) : 0;
    }
  // the lane's B column n = (kw, o) of each of its n8 tiles
  int bkw[NTW], bo[NTW];
#pragma unroll
  for (int jn = 0; jn < NTW; ++jn) {
    const int n = (nw * NTW + jn) * 8 + gq;
    bkw[jn] = n < nk ? n / g.co : -(1 << 20);  // past N: never a pixel of the strip
    bo[jn] = n < nk ? n % g.co : 0;
  }

  float acc[MT][NTW][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  strip_walk<HILO>(smem, first, last, x, dy, g, st, va, vb, tid,
                   [&](const float* patch, int lo_off, long long j) {
    const float* dys = patch + st.pr * st.rp;
    long long img;
    int y0, x0;
    strip_origin(st, j, img, y0, x0);
    const int rows = min(st.r, g.oh - y0);
    for (int rr = rg; rr < rows; rr += RG) {
      const float* drow = dys + rr * st.wt * st.dp;
#pragma unroll 2
      for (int k0 = 0; k0 < st.pc; k0 += 8) {
        // k8 step over patch columns k0..k0+7: lane t takes k0+t and k0+t+4
        const float* pa = patch + rr * st.rp + (k0 + t) * g.ci;
        uint32_t bh[NTW][2], bl[NTW][2];
#pragma unroll
        for (int jn = 0; jn < NTW; ++jn)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // B (k = x', n = (kw, o)): dY at pixel x' - kw of row rr
            const int xr = k0 + t + 4 * h - bkw[jn];
            if (xr >= 0 && xr < st.wt) {
              tf32_at<HILO>(drow + xr * st.dp + (bo[jn] ^ swap_if(xr, st.dswz)), lo_off, bh[jn][h],
                            bl[jn][h]);
            } else {
              bh[jn][h] = bl[jn][h] = 0u;
            }
          }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          uint32_t ah[4], al[4];
          tf32_at<HILO>(pa + poff[i][0], lo_off, ah[0], al[0]);
          tf32_at<HILO>(pa + poff[i][1], lo_off, ah[1], al[1]);
          tf32_at<HILO>(pa + 4 * g.ci + poff[i][0], lo_off, ah[2], al[2]);
          tf32_at<HILO>(pa + 4 * g.ci + poff[i][1], lo_off, ah[3], al[3]);
#pragma unroll
          for (int jn = 0; jn < NTW; ++jn) mma3(acc[i][jn], ah, al, bh[jn], bl[jn]);
        }
      }
    }
  });

  // row groups 1.. park their sums in the free ring; group 0 adds them in order
  float* park = smem;
  constexpr int SLOT = MT * NTW * 4 * 32;
  if (rg > 0) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int jn = 0; jn < NTW; ++jn)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          park[((rg - 1) * NW + nw) * SLOT + ((i * NTW + jn) * 4 + r) * 32 + lane] = acc[i][jn][r];
  }
  __syncthreads();
  if (rg > 0) return;
  for (int q = 1; q < RG; ++q)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int jn = 0; jn < NTW; ++jn)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[i][jn][r] += park[((q - 1) * NW + nw) * SLOT + ((i * NTW + jn) * 4 + r) * 32 + lane];

  const int kk = g.kh * g.kw;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int jn = 0; jn < NTW; ++jn)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = i * 16 + gq + (r >> 1) * 8;                 // (kh, i)
        const int n = (nw * NTW + jn) * 8 + 2 * t + (r & 1);      // (kw, o)
        if (m < mk && n < nk) {
          const int ky = m / g.ci, ch = m % g.ci, kx = n / g.co, o = n % g.co;
          if (direct)
            dst[(static_cast<long long>(o) * g.ci + ch) * kk + ky * g.kw + kx] = acc[i][jn][r];
          else
            dst[(static_cast<long long>(blockIdx.x) * g.p + (ky * g.kw + kx) * g.ci + ch) * g.co + o] =
                acc[i][jn][r];
        }
      }
}

template <int MT, int NT>
cudaError_t launch_pixels(const float* x, const float* dy, float* dst, const Geom& g,
                          const Strip& st, int blocks, int smem, int va, int vb, int direct,
                          cudaStream_t stream) {
  static std::atomic<unsigned long long> ready{0};
  const cudaError_t e = prepare(wgrad_strip_kernel<MT, NT>, SMEM_MAX, ready);
  if (e != cudaSuccess) return e;
  wgrad_strip_kernel<MT, NT><<<blocks, THREADS, smem, stream>>>(x, dy, dst, g, st, va, vb, direct);
  return cudaGetLastError();
}

template <int MT>
cudaError_t launch_kn(const float* x, const float* dy, float* dst, const Geom& g, const Strip& st,
                      int blocks, int smem, int va, int vb, int direct, cudaStream_t stream) {
  static std::atomic<unsigned long long> ready{0};
  const cudaError_t e = prepare(wgrad_strip_kn_kernel<MT>, SMEM_MAX, ready);
  if (e != cudaSuccess) return e;
  wgrad_strip_kn_kernel<MT><<<blocks, THREADS, smem, stream>>>(x, dy, dst, g, st, va, vb, direct);
  return cudaGetLastError();
}

// The pixels-on-K template for (mt, nt): mt in 2, 4, 6, 8, 11 and nt (n8
// tiles of co) 1 or 2.
cudaError_t launch_pixels_as(int mt, int nt, const float* x, const float* dy, float* dst,
                             const Geom& g, const Strip& st, int blocks, int smem, int va, int vb,
                             int direct, cudaStream_t s) {
  const bool n1 = nt == 1;
  switch (mt) {
    case 2: return n1 ? launch_pixels<2, 1>(x, dy, dst, g, st, blocks, smem, va, vb, direct, s)
                      : launch_pixels<2, 2>(x, dy, dst, g, st, blocks, smem, va, vb, direct, s);
    case 4: return n1 ? launch_pixels<4, 1>(x, dy, dst, g, st, blocks, smem, va, vb, direct, s)
                      : launch_pixels<4, 2>(x, dy, dst, g, st, blocks, smem, va, vb, direct, s);
    case 6: return n1 ? launch_pixels<6, 1>(x, dy, dst, g, st, blocks, smem, va, vb, direct, s)
                      : launch_pixels<6, 2>(x, dy, dst, g, st, blocks, smem, va, vb, direct, s);
    case 8: return n1 ? launch_pixels<8, 1>(x, dy, dst, g, st, blocks, smem, va, vb, direct, s)
                      : launch_pixels<8, 2>(x, dy, dst, g, st, blocks, smem, va, vb, direct, s);
    case 11: return n1 ? launch_pixels<11, 1>(x, dy, dst, g, st, blocks, smem, va, vb, direct, s)
                       : launch_pixels<11, 2>(x, dy, dst, g, st, blocks, smem, va, vb, direct, s);
    default: return cudaErrorInvalidValue;
  }
}

// The kw-on-N template for mt in 2, 4, 6, 9.
cudaError_t launch_kn_as(int mt, const float* x, const float* dy, float* dst, const Geom& g,
                         const Strip& st, int blocks, int smem, int va, int vb, int direct,
                         cudaStream_t s) {
  switch (mt) {
    case 2: return launch_kn<2>(x, dy, dst, g, st, blocks, smem, va, vb, direct, s);
    case 4: return launch_kn<4>(x, dy, dst, g, st, blocks, smem, va, vb, direct, s);
    case 6: return launch_kn<6>(x, dy, dst, g, st, blocks, smem, va, vb, direct, s);
    case 9: return launch_kn<9>(x, dy, dst, g, st, blocks, smem, va, vb, direct, s);
    default: return cudaErrorInvalidValue;
  }
}

// A strip kernel on float32 x and dy, after checking that the plan's
// geometry holds together.
cudaError_t launch_strip(bool kn, int mt, const void* xv, const void* dyv,
                         float* dst, const Geom& g, int n, Strip st, int blocks, int direct,
                         cudaStream_t stream) {
  const float* x = static_cast<const float*>(xv);
  const float* dy = static_cast<const float*>(dyv);
  st.pr = (st.r - 1) * g.s + g.kh;
  st.sy = st.r > 0 ? (g.oh + st.r - 1) / st.r : 0;
  st.sx = st.wt > 0 ? (g.ow + st.wt - 1) / st.wt : 0;
  st.total = static_cast<long long>(n) * st.sy * st.sx;
  st.raw = st.pr * st.rp + st.r * st.wt * st.dp;
  // two ring stages, and for pixels on K the lo buffer
  const long long smem = (kn ? 2ll : 3ll) * st.raw * static_cast<long long>(sizeof(float));
  bool ok = st.r >= 1 && st.wt >= 8 && st.wt % 8 == 0 && st.pc >= (st.wt - 1) * g.s + g.kw &&
            st.rp >= st.pc * g.ci && st.rp % 4 == 0 && (st.dp == 8 || st.dp == 16) &&
            g.co >= 1 && (st.swz == 0 || (st.swz == 8 && g.ci == 16 && g.s == 1)) &&
            (st.dswz == 0 || (st.dswz == 8 && st.dp == 16)) &&
            st.per >= 1 && static_cast<long long>(blocks) * st.per >= st.total &&
            static_cast<long long>(blocks - 1) * st.per < st.total && smem <= SMEM_MAX;
  const int nt = (g.co + 7) / 8;  // pixels on K: n8 tiles of co
  if (kn) {
    const int nw = 4 / KN_NT, rg = 8 / nw;
    ok = ok && g.s == 1 && st.pc % 8 == 0 && g.kw * g.co <= 32 && st.dp >= g.co &&
         16 * mt >= g.kh * g.ci && (rg - 1) * nw * mt * KN_NT * 128 <= 2 * st.raw;
  } else {
    ok = ok && nt <= 2 && 8 * nt == st.dp && 8 * mt * 16 >= g.p;
  }
  if (!ok) return cudaErrorInvalidValue;
  // 16-byte copies where the channels hold whole 16-byte runs and the base
  // is 16-byte aligned (so every run is)
  const int va = g.ci % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vb = g.co % 4 == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  const int bytes = static_cast<int>(smem);
  if (kn) return launch_kn_as(mt, x, dy, dst, g, st, blocks, bytes, va, vb, direct, stream);
  return launch_pixels_as(mt, nt, x, dy, dst, g, st, blocks, bytes, va, vb, direct, stream);
}

}  // namespace

extern "C" {

// x: [n, h, w, ci], dy: [n, oh, ow, co], both contiguous, float32 (is_bf16
// == 0) or bfloat16, with oh = (h + 2 ph - kh) / s + 1 (likewise ow). out:
// [co, ci, kh, kw] float32. partial: scratch of splits * kh*kw*ci * co
// floats, unused when splits == 1. One launch when splits == 1, else two
// (the reduce adds the splits' partials in order).
//   design 0, the tile kernel: rows [sp*chunk, (sp+1)*chunk) of the
//     n*oh*ow output pixels go to split sp; the caller makes chunk a
//     multiple of 32 and splits*chunk >= n*oh*ow, and tc one of 8, 16, 32,
//     64. The strip arguments are unused.
//   design 1 (pixels on K) or 2 (kw on N), the strip kernels (float32
//     only): splits blocks, each walking strips_per_block strips of
//     strip_r x strip_w output pixels; the patch has patch_cols columns and
//     row pitch row_pitch, dY pixels the pitch dy_pitch (floats); swz and
//     dswz (8 or 0) swap channel halves; mt m16 tiles a warp; chunk and tc
//     unused.
// Returns cudaGetLastError() of the last launch, or the first error
// (cudaErrorInvalidValue for a geometry the kernels do not take).
int fs_conv_wgrad(const void* x, const void* dy, void* partial, void* out, int is_bf16, int n,
                  int h, int w, int ci, int oh, int ow, int co, int kh, int kw, int s, int ph,
                  int pw, int splits, long long chunk, int tc, int design, int strip_r,
                  int strip_w, int patch_cols, int row_pitch, int dy_pitch, int swz, int dswz,
                  int strips_per_block, int mt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Geom g;
  g.h = h, g.w = w, g.ci = ci, g.oh = oh, g.ow = ow, g.co = co;
  g.kh = kh, g.kw = kw, g.s = s, g.ph = ph, g.pw = pw;
  g.p = kh * kw * ci;
  g.rows = static_cast<long long>(n) * oh * ow;
  g.chunk = chunk;
  const int direct = splits == 1;
  float* dst = static_cast<float*>(direct ? out : partial);
  cudaError_t err;
  if (design == 1 || design == 2) {
    if (is_bf16) return static_cast<int>(cudaErrorInvalidValue);
    Strip sp{};
    sp.r = strip_r, sp.wt = strip_w, sp.pc = patch_cols, sp.rp = row_pitch, sp.dp = dy_pitch;
    sp.swz = swz, sp.dswz = dswz, sp.per = strips_per_block;
    err = launch_strip(design == 2, mt, x, dy, dst, g, n, sp, splits, direct, st);
  } else if (design == 0) {
    err = is_bf16 ? launch_any<__nv_bfloat16>(tc, x, dy, dst, g, splits, direct, st)
                  : launch_any<float>(tc, x, dy, dst, g, splits, direct, st);
  } else {
    err = cudaErrorInvalidValue;
  }
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

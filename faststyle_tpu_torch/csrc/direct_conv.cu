// Direct 9x9 SAME convolution for NVIDIA Hopper (sm_90a), plain C interface:
// the Johnson transform net's two full-frame convs as the serving walk runs
// them, initconv_0 (3 -> 16 channels) and upsample_2 (16 -> 3).
//
//   y[n, oy, ox, co] = sum over kh, kw, ci of x[n, oy + kh - 4, ox + kw - 4, ci] * w[co, ci, kh, kw]
//
// x [n, h, w, ci] and y [n, h, w, co] NHWC bf16, contiguous; x is zero
// outside the image (SAME, a pad of 4 on each side, stride 1), read through
// masks and never padded in memory; w OIHW bf16 [co, ci, 9, 9]. Products and
// sums in float32 on the tensor cores, y rounded once to bf16 on the store:
// the contract cuDNN's bf16 convolutions keep.
//
// No TPU kernel stands behind it: the JAX package leaves this conv to XLA.
// It replaces cuDNN for exactly these two shapes. cuDNN's NHWC tensor-core
// kernels take channel counts in multiples of 8: for ci = 3 it first copies
// the whole frame out to 8 channels (nhwcAddPaddingKernel) and then runs
// K = 648 for 243 real; for co = 3 its sm80 fprop tiles are 32-128 outputs
// wide for 3 real. At 3840x2160 the two took 6.7 and 6.2 ms on an H100 (84%
// of the frame's conv time) against least times of 0.0996 and 0.0941 ms.
//
// What bounds them on an H100 (3.35 TB/s, 989 TFLOP/s bf16) is bytes: 68.3
// and 64.5 GFLOP against 333.7 and 315.2 MB at 4K, both below the card's
// 295 FLOP/byte line. The design stages each input row in shared memory
// once or close to it, overlaps that with the products, and keeps the
// tensor-core work near the real work (81-82 GFLOP padded, 0.13 ms at the
// ~637 TFLOP/s mma.sync reaches on an H100):
//  1. Tensor cores through mma.sync m16n8k16 (bf16 in, float32 sums), the
//     im2col fragments read from the staged rows in place: A is pixels, B
//     the weights, all 3,888 held in registers as B fragments for the
//     block's life. Each warp computes two output rows at once, so every A
//     fragment it loads (one input row's) feeds both rows' kh taps.
//  2. ci = 3, direct_conv_kernel ("pixels" form): persistent blocks, two an
//     SM, walk tiles of 16 x 128 outputs. K runs kh x (kw, ci), 27 padded
//     to 32 a kh, 288 for 243 real; N = 16 = co. For one kh the 32 values
//     of an output pixel's im2col row are 32 consecutive elements of the
//     staged input row, starting at 3 * its column, so the A fragment is
//     32-bit loads at a pixel-dependent offset. Pixels of odd column start
//     at odd elements, so the row is staged twice, once shifted by one
//     element, and each lane reads the copy that aligns its pixels (the two
//     copies 16 banks apart: conflict-free). The 5 padding slots would read
//     the next pixels' values; they are masked to zero as the fragments are
//     read, so an Inf or NaN input reaches only the outputs whose 9x9 window
//     holds it, as in a true conv. The next tile's rows come by 4-byte
//     cp.async into a raw buffer while this tile computes, and are split
//     into the two copies after it. The output channels are ordered in N so that each lane's
//     accumulators are 4 consecutive channels of a pixel: 8-byte stores, a
//     warp's covering 8 whole pixels.
//  3. co = 3, direct_conv_kn_kernel ("kn" form): N runs (kw, co), 27 of 32
//     columns, and K = ci = 16 a kh (144): the mma computes, for every
//     staged input column m, partials P[m, kw, co] summed over kh and ci,
//     and output column c is the sum over kw of P[c + kw, kw, co], taken in
//     float32 from a per-warp ring of two m16 tiles' partials in shared
//     memory, a kw's three as one 16-byte load (conv_wgrad's kw-on-N idea
//     applied to the forward). Padding co to the n8 of an mma instead would
//     leave 3 of 8 columns useful and need 9 times the A fragments. A block
//     walks down a band of 88 output columns, 8 rows a step, two m16 tiles
//     at a time (16 independent mma chains a warp); the staged rows (16
//     channels, 32 bytes a pixel) stream through a ring of 24 by 16-byte
//     cp.async with zero-fill outside the image, the next step's 8 new rows
//     flying while this step computes, so each input row is read about once.
//     A pixel's channel halves are swapped by bit 2 of its column, so
//     ldmatrix reads the ring without bank conflicts.
// No atomics: each output is computed once, in a fixed order, so two calls
// give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 9;    // kernel extent
constexpr int PAD = 4;  // SAME pad a side

// ---- pixels form (ci = 3, co = 16) ----
constexpr int PX_WARPS = 8;
constexpr int PX_THREADS = 32 * PX_WARPS;
constexpr int PX_ROWS = 2 * PX_WARPS;             // output rows a tile, two a warp
constexpr int PX_COLS = 128;                      // output columns a tile
constexpr int PX_PROWS = PX_ROWS + 2 * PAD;       // staged input rows
constexpr int PX_REAL = 3 * (PX_COLS + 2 * PAD);  // staged elements a row (408)
constexpr int PX_ROW_WORDS = (PX_REAL + 8) / 2;   // 32-bit words a staged row, zeros past PX_REAL
constexpr int PX_COPY_WORDS = PX_PROWS * PX_ROW_WORDS;
// the shifted copy starts 16 banks from the first
constexpr int PX_COPY1 = (PX_COPY_WORDS - 16 + 31) / 32 * 32 + 16;
constexpr int PX_RAW = PX_COPY1 + PX_COPY_WORDS;  // the next tile's rows as 4-byte words of x
constexpr int PX_RAW_LOADS = PX_REAL / 2 + 1;     // words a staged row spans from its even start
constexpr int PX_SMEM = 4 * (PX_RAW + PX_COPY_WORDS);

// ---- kn form (ci = 16, co = 3) ----
constexpr int KN_WARPS = 4;
constexpr int KN_THREADS = 32 * KN_WARPS;
constexpr int KN_ROWS = 2 * KN_WARPS;        // output rows a step, two a warp
constexpr int KN_COLS = 88;                  // output columns a band
constexpr int KN_MT = 6;                     // m16 tiles of staged input columns
constexpr int KN_PCOLS = 16 * KN_MT;         // staged input columns, >= KN_COLS + 8
constexpr int KN_ROW_BYTES = 32 * KN_PCOLS;  // 16 bf16 channels a pixel
constexpr int KN_SLOTS = 3 * KN_ROWS;        // the ring of staged rows: a step's 16 and the next step's 8 new
constexpr int KN_PATCH_BYTES = KN_SLOTS * KN_ROW_BYTES;
// a ring column: the partial of (kw, co) at 4 * kw + co, so a kw's three
// are one 16-byte load; columns 36 floats apart (conflict-free loads)
constexpr int KN_RING_COL = 36;
constexpr int KN_RING_ROW = 32 * KN_RING_COL;  // a warp's second output row's ring
constexpr int KN_RING = 2 * KN_RING_ROW;
constexpr int KN_SMEM = KN_PATCH_BYTES + 4 * KN_WARPS * KN_RING;

static_assert(KN_ROWS == 2 * PAD, "a step's staged rows are two steps' worth: the ring holds three");
static_assert(KN_PCOLS >= KN_COLS + 2 * PAD, "the kn tile stages every column its outputs read");
static_assert(2 * PX_ROW_WORDS >= 3 * (PX_COLS - 1) + 32 + 1, "the pixels rows hold every fragment's reads");
static_assert(PX_RAW_LOADS <= PX_ROW_WORDS, "a staged row's raw words fit its row");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes by cp.async; zeros instead when !ok (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes by cp.async, the first `bytes` (0, 2 or 4) read from src and the
// rest zeros
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 bf16 matrices; lanes 8i..8i+7 give matrix i's rows.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Two bf16 bit patterns as one register, lo in the low half (the smaller k).
__device__ __forceinline__ uint32_t pack(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

struct Tile {
  int img, y0, x0;
};

__device__ __forceinline__ Tile tile_at(long long t, int tiles_y, int tiles_x, int rows, int cols) {
  const int tx = static_cast<int>(t % tiles_x);
  const long long rest = t / tiles_x;
  return Tile{static_cast<int>(rest / tiles_y), static_cast<int>(rest % tiles_y) * rows, tx * cols};
}

// ---- the pixels form ----

// Weight k (= kw * 3 + ci, zero past 26) of tap row kh for output channel co.
__device__ __forceinline__ uint16_t px_weight(const uint16_t* w, int co, int kh, int k) {
  return k < 27 ? __ldg(w + ((co * 3 + k % 3) * K + kh) * K + k / 3) : 0;
}

// The output channel of column c of n8 tile j: lane (g, t)'s accumulator
// columns 2t, 2t+1 of tiles 0 and 1 are channels 4t..4t+3, one 8-byte run.
__device__ __forceinline__ int px_channel(int j, int c) { return 4 * (c >> 1) + 2 * j + (c & 1); }

// Issues the cp.async copies of a tile's staged rows into the raw buffer:
// word j of staged row pr holds x's elements e, e + 1 from e = (the row's
// first element rounded down to even) + 2j; words holding no element of an
// image row (outside the image, or a row of the pad) arrive as zeros, and
// nothing is read past x's `total` elements.
__device__ __forceinline__ void px_issue(uint32_t raw, const uint16_t* x, long long total, const Tile& tl, int h,
                                         int wd, int tid) {
  const long long row0 = (static_cast<long long>(tl.img) * h + tl.y0 - PAD) * wd * 3;  // staged row 0's image row
  const long long stride = 3ll * wd;
  for (int j = tid; j < PX_RAW_LOADS; j += PX_THREADS) {
    long long row = row0;
#pragma unroll 4
    for (int pr = 0; pr < PX_PROWS; ++pr, row += stride) {
      const int yy = tl.y0 - PAD + pr;
      const long long e = ((row + 3ll * (tl.x0 - PAD)) & ~1ll) + 2 * j;  // >= 0 wherever ok
      const bool ok = yy >= 0 && yy < h && e + 2 > row && e < row + stride;
      cp_async4(raw + 4 * (pr * PX_ROW_WORDS + j), ok ? x + e : x, ok ? (e + 2 <= total ? 4 : 2) : 0);
    }
  }
}

// The two aligned copies of the staged rows from the raw words: thread i
// writes word i of each copy (copy 0 holds elements 2i, 2i+1 of the row,
// copy 1 elements 2i+1, 2i+2), the halves of elements outside the image
// zeroed. A staged row's first element is odd where its row's index times
// 3 * wd plus 3 * (x0 - 4) is, so rows alternate only when wd is odd.
__device__ __forceinline__ void px_build(uint32_t* smem, const Tile& tl, int h, int wd, int tid) {
  auto inside = [&](int e) {
    const int xx = tl.x0 - PAD + e / 3;
    return e < PX_REAL && xx >= 0 && xx < wd;
  };
  const int odd0 = static_cast<int>(((static_cast<long long>(tl.img) * h + tl.y0 - PAD) * wd + tl.x0 - PAD) & 1);
  const uint32_t* raw = smem + PX_RAW;
  for (int i = tid; i < PX_REAL / 2; i += PX_THREADS) {
    const uint32_t m0 = (inside(2 * i) ? 0xffffu : 0u) | (inside(2 * i + 1) ? 0xffff0000u : 0u);
    const uint32_t m1 = (inside(2 * i + 1) ? 0xffffu : 0u) | (inside(2 * i + 2) ? 0xffff0000u : 0u);
#pragma unroll 4
    for (int pr = 0; pr < PX_PROWS; ++pr) {
      const bool odd = (odd0 + pr * wd) & 1;
      const uint32_t r0 = raw[pr * PX_ROW_WORDS + i], r1 = raw[pr * PX_ROW_WORDS + i + 1];
      const uint32_t mid = __byte_perm(r0, r1, 0x5432);  // r0's high half, r1's low half
      smem[pr * PX_ROW_WORDS + i] = (odd ? mid : r0) & m0;
      smem[PX_COPY1 + pr * PX_ROW_WORDS + i] = (odd ? r1 : mid) & m1;
    }
  }
}

// A warp's output row's accumulators of one m16 tile, out as bf16: lane
// (g, t) holds channels 4t..4t+3 (px_channel) of pixels g and g + 8 and
// writes each as one 8-byte store; a warp's store covers 8 whole pixels.
__device__ __forceinline__ void px_store(const float (&acc)[2][4], __nv_bfloat16* row, int x, int wd, int lane) {
  const int g = lane >> 2, t = lane & 3;
  if (x + g < wd) {
    *reinterpret_cast<uint2*>(row + static_cast<long long>(x + g) * 16 + 4 * t) =
        make_uint2(pack_rn(acc[0][0], acc[0][1]), pack_rn(acc[1][0], acc[1][1]));
  }
  if (x + g + 8 < wd) {
    *reinterpret_cast<uint2*>(row + static_cast<long long>(x + g + 8) * 16 + 4 * t) =
        make_uint2(pack_rn(acc[0][2], acc[0][3]), pack_rn(acc[1][2], acc[1][3]));
  }
}

__global__ void __launch_bounds__(PX_THREADS, 2)
    direct_conv_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
                       __nv_bfloat16* __restrict__ y, int h, int wd, int tiles_y, int tiles_x, long long tiles) {
  extern __shared__ uint32_t px_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;

  // b[kh][s][j]: k-step s (k 16s..16s+15), n8 tile j (co 8j..8j+7)
  uint32_t b[K][2][2][2];
#pragma unroll
  for (int kh = 0; kh < K; ++kh) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int k = 16 * s + 2 * t + 8 * r, co = px_channel(j, g);
          b[kh][s][j][r] = pack(px_weight(w, co, kh, k), px_weight(w, co, kh, k + 1));
        }
      }
    }
  }
  // the copies' words past each staged row's real elements stay zero
  for (int i = tid; i < PX_RAW; i += PX_THREADS) px_smem[i] = 0u;
  const uint32_t raw = smem_u32(px_smem + PX_RAW);
  const long long total = tiles / (static_cast<long long>(tiles_y) * tiles_x) * h * wd * 3;  // x's elements
  if (blockIdx.x < tiles) px_issue(raw, x, total, tile_at(blockIdx.x, tiles_y, tiles_x, PX_ROWS, PX_COLS), h, wd, tid);

  // lane (g, t)'s first A word in a staged row: pixel g's im2col row starts
  // at element 3g, read from the copy that makes it even
  const uint32_t* lane_a = px_smem + ((g & 1) ? PX_COPY1 : 0) + (3 * g - (g & 1)) / 2 + t;
  // the A word of k 24 + 2t, 25 + 2t: k = 27 and up are padding, zeroed
  const uint32_t pad_mask = t == 0 ? 0xffffffffu : (t == 1 ? 0x0000ffffu : 0u);

  for (long long ti = blockIdx.x; ti < tiles; ti += gridDim.x) {
    const Tile tl = tile_at(ti, tiles_y, tiles_x, PX_ROWS, PX_COLS);
    const long long img_px = static_cast<long long>(tl.img) * h * wd;
    cp_async_wait_all();
    __syncthreads();  // this tile's raw words landed; the last tile's fragments are read
    px_build(px_smem, tl, h, wd, tid);
    __syncthreads();  // the copies are built, the raw buffer free: the next tile's copies fly meanwhile
    if (ti + gridDim.x < tiles) {
      px_issue(raw, x, total, tile_at(ti + gridDim.x, tiles_y, tiles_x, PX_ROWS, PX_COLS), h, wd, tid);
    }

    const int oy = tl.y0 + 2 * warp;
    if (oy >= h) continue;
    const int mts = (min(PX_COLS, wd - tl.x0) + 15) / 16;
    __nv_bfloat16* row0 = y + (img_px + static_cast<long long>(oy) * wd) * 16;
    for (int mt = 0; mt < mts; ++mt) {
      float acc[2][2][4] = {};
      const uint32_t* base = lane_a + 24 * mt + 2 * warp * PX_ROW_WORDS;
#pragma unroll
      for (int i = 0; i < K + 1; ++i) {  // staged rows 2*warp + i: output row 0 takes kh = i, row 1 kh = i - 1
        const uint32_t* p = base + i * PX_ROW_WORDS;
        uint32_t a[2][4];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const uint32_t hi_mask = s == 1 ? pad_mask : 0xffffffffu;
          a[s][0] = p[8 * s];                      // pixel g, k 16s + 2t
          a[s][1] = p[8 * s + 12];                 // pixel g + 8
          a[s][2] = p[8 * s + 4] & hi_mask;        // pixel g, k 16s + 2t + 8
          a[s][3] = p[8 * s + 4 + 12] & hi_mask;   // pixel g + 8
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int kh = i - r;
          if (kh < 0 || kh >= K) continue;
#pragma unroll
          for (int s = 0; s < 2; ++s) {
#pragma unroll
            for (int j = 0; j < 2; ++j) mma_bf16(acc[r][j], a[s], b[kh][s][j]);
          }
        }
      }
      const int col = tl.x0 + 16 * mt;
      px_store(acc[0], row0, col, wd, lane);
      if (oy + 1 < h) px_store(acc[1], row0 + static_cast<long long>(wd) * 16, col, wd, lane);
    }
  }
}

// ---- the kn form ----

// The partials of m16 tile j (input columns 16j..16j+15, both output rows)
// into ring slot j & 1, then the output columns that tiles j - 1 and j
// complete: c = 16j - 8 + (lane & 15) of row lane >> 4 (when c < cols and
// the row < rows_left) is the sum over kw of the partials of input column
// c + kw. `slot` holds the ring offsets of lane (g, t)'s accumulator columns
// n = 8q + 2t + e ((kw, co) = (n / 3, n % 3); -1 past 26); out points at
// the warp's first output row's column 0, `row` elements a row.
__device__ __forceinline__ void kn_sum(const float (&acc)[2][4][4], float* ring, const int (&slot)[4][2], int j,
                                       int cols, int rows_left, long long row, __nv_bfloat16* out, int lane) {
  const int g = lane >> 2;
  __syncwarp();  // the last tile's sums have read the slot
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* lo = ring + r * KN_RING_ROW + ((16 * j + g) & 31) * KN_RING_COL;
    float* hi = ring + r * KN_RING_ROW + ((16 * j + g + 8) & 31) * KN_RING_COL;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (slot[q][e] >= 0) {
          lo[slot[q][e]] = acc[r][q][e];
          hi[slot[q][e]] = acc[r][q][2 + e];
        }
      }
    }
  }
  __syncwarp();
  const int r = lane >> 4, c = 16 * j - 8 + (lane & 15);
  if (c < 0 || c >= cols || r >= rows_left) return;
  const float* rr = ring + r * KN_RING_ROW;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int kw = 0; kw < K; ++kw) {
    const float4 p = *reinterpret_cast<const float4*>(rr + ((c + kw) & 31) * KN_RING_COL + 4 * kw);
    s0 += p.x;
    s1 += p.y;
    s2 += p.z;
  }
  // the pixel's three values as a 4-byte pair and a single, whichever way
  // its address aligns them
  __nv_bfloat16* o = out + r * row + 3ll * c;
  if (reinterpret_cast<uintptr_t>(o) & 2) {
    o[0] = __float2bfloat16_rn(s0);
    *reinterpret_cast<uint32_t*>(o + 1) = pack_rn(s1, s2);
  } else {
    *reinterpret_cast<uint32_t*>(o) = pack_rn(s0, s1);
    o[2] = __float2bfloat16_rn(s2);
  }
}

// Issues the cp.async copies of staged rows [first, last) of a strip (row
// R is image row y0 - 4 + R, into ring slot R % KN_SLOTS): 16-byte chunks,
// zeros outside the image, each pixel's channel halves swapped by bit 2 of
// its column (ldmatrix then reads them without bank conflicts).
__device__ __forceinline__ void kn_issue(uint32_t patch, const __nv_bfloat16* x, long long img_px, int y0, int x0,
                                         int first, int last, int h, int wd, int tid) {
  for (int c = tid; c < 2 * KN_PCOLS; c += KN_THREADS) {
    const int col = c >> 1, half = c & 1, xx = x0 - PAD + col;
    const bool col_ok = xx >= 0 && xx < wd;
    const uint32_t dst = patch + col * 32 + ((half ^ ((col >> 2) & 1)) * 16);
    for (int r = first; r < last; ++r) {
      const int yy = y0 - PAD + r;
      const bool ok = col_ok && yy >= 0 && yy < h;
      cp_async16(dst + (r % KN_SLOTS) * KN_ROW_BYTES,
                 ok ? x + (img_px + static_cast<long long>(yy) * wd + xx) * 16 + 8 * half : x, ok);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// A block walks one strip: a band of KN_COLS output columns of one image
// down `seg_steps` steps of KN_ROWS rows (its segment of the band). The
// staged rows stream through a ring: each step reads its 16 and the next
// step's 8 new rows fly meanwhile, so every input row is fetched about once.
__global__ void __launch_bounds__(KN_THREADS, 2)
    direct_conv_kn_kernel(const __nv_bfloat16* __restrict__ x, const uint16_t* __restrict__ w,
                          __nv_bfloat16* __restrict__ y, int h, int wd, int bands, int segs, int seg_steps) {
  extern __shared__ __align__(16) unsigned char kn_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int seg = static_cast<int>(blockIdx.x % segs);
  const long long strip = blockIdx.x / segs;
  const int x0 = static_cast<int>(strip % bands) * KN_COLS, y0 = seg * seg_steps * KN_ROWS;
  const long long img_px = strip / bands * static_cast<long long>(h) * wd;
  const int steps = min(seg_steps, (h - y0 + KN_ROWS - 1) / KN_ROWS);
  if (steps <= 0) return;  // a segment past the image's last row
  const uint32_t patch = smem_u32(kn_smem);
  kn_issue(patch, x, img_px, y0, x0, 0, 2 * KN_ROWS, h, wd, tid);
  kn_issue(patch, x, img_px, y0, x0, 2 * KN_ROWS, steps > 1 ? 3 * KN_ROWS : 2 * KN_ROWS, h, wd, tid);

  // b[kh][q]: n8 tile q of N = (kw, co), n = 8q + g = 3kw + co (zero past 26); k = ci
  uint32_t b[K][4][2];
#pragma unroll
  for (int kh = 0; kh < K; ++kh) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = 8 * q + g, kw = n / 3, co = n % 3;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int ci = 2 * t + 8 * r;
        b[kh][q][r] = n < 27 ? pack(__ldg(w + ((co * 16 + ci) * K + kh) * K + kw),
                                    __ldg(w + ((co * 16 + ci + 1) * K + kh) * K + kw))
                             : 0u;
      }
    }
  }
  int slot[4][2];  // kn_sum's ring offsets of this lane's accumulator columns
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 8 * q + 2 * t + e;
      slot[q][e] = n < 27 ? 4 * (n / 3) + n % 3 : -1;
    }
  }
  float* ring = reinterpret_cast<float*>(kn_smem + KN_PATCH_BYTES) + warp * KN_RING;
  // ldmatrix rows: lane l gives pixel l & 15's channel half l >> 4, stored
  // at half (l >> 4) ^ (bit 2 of the pixel)
  const int m = lane & 15;
  const uint32_t lane_a = patch + m * 32 + (((lane >> 4) ^ ((m >> 2) & 1)) * 16);
  const int cols = min(KN_COLS, wd - x0);
  const int mts = (cols + 2 * PAD + 15) / 16;

  for (int s = 0; s < steps; ++s) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // all but the next step's rows
    __syncthreads();
    const int oy = y0 + s * KN_ROWS + 2 * warp;
    if (oy < h) {
      const int base = (s * KN_ROWS + 2 * warp) % KN_SLOTS;  // the warp's first staged row's slot
      __nv_bfloat16* out = y + (img_px + static_cast<long long>(oy) * wd + x0) * 3;
      for (int j = 0; j < mts; j += 2) {  // two m16 tiles at once: 16 independent mma chains
        float acc[2][2][4][4] = {};
#pragma unroll
        for (int i = 0; i < K + 1; ++i) {  // staged rows 2*warp + i: output row 0 takes kh = i, row 1 kh = i - 1
          const int sl = base + i < KN_SLOTS ? base + i : base + i - KN_SLOTS;
          const uint32_t a_addr = lane_a + sl * KN_ROW_BYTES + j * 16 * 32;
          uint32_t a[2][4];
          ldsm_x4(a[0], a_addr);
          ldsm_x4(a[1], a_addr + 16 * 32);  // within the staged columns: mts <= KN_MT
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int kh = i - r;
            if (kh < 0 || kh >= K) continue;
#pragma unroll
            for (int u = 0; u < 2; ++u) {
#pragma unroll
              for (int q = 0; q < 4; ++q) mma_bf16(acc[u][r][q], a[u], b[kh][q]);
            }
          }
        }
        kn_sum(acc[0], ring, slot, j, cols, h - oy, 3ll * wd, out, lane);
        if (j + 1 < mts) kn_sum(acc[1], ring, slot, j + 1, cols, h - oy, 3ll * wd, out, lane);
      }
    }
    __syncthreads();  // step s's oldest 8 rows are read: step s + 2's new rows take their slots
    const int next = (s + 3) * KN_ROWS;
    kn_issue(patch, x, img_px, y0, x0, next, s + 2 < steps ? next + KN_ROWS : next, h, wd, tid);
  }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// Blocks of the form for (ci, co) an SM holds at once, into *per_sm.
int fs_direct_conv_blocks_per_sm(int ci, int co, int* per_sm) {
  cudaError_t err;
  if (ci == 3 && co == 16) {
    err = cudaFuncSetAttribute(direct_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PX_SMEM);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, direct_conv_kernel, PX_THREADS, PX_SMEM);
  } else if (ci == 16 && co == 3) {
    err = cudaFuncSetAttribute(direct_conv_kn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, KN_SMEM);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, direct_conv_kn_kernel, KN_THREADS, KN_SMEM);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// x: [n, h, wd, ci], w: [co, ci, 9, 9], y: [n, h, wd, co], all bf16 and
// contiguous; (ci, co) is (3, 16) or (16, 3); x and y 16-byte aligned. One
// launch; returns cudaGetLastError() after it, or cudaErrorInvalidValue for
// arguments the kernels do not take.
//   ci = 3: min(blocks, tiles) persistent blocks walk tiles of 16 x 128
//     outputs, tile t at image t / (tiles_y * tiles_x), rows (t / tiles_x)
//     % tiles_y, columns t % tiles_x; block b takes tiles b, b + grid, ...
//   ci = 16: strips of 88 output columns (bands) of each image, each band
//     cut into max(1, blocks / (n * bands)) segments of seg_steps steps of 8
//     rows; a block a segment, block b at band (b / segs) % bands of image
//     b / (segs * bands), segment b % segs.
int fs_direct_conv(const void* x, const void* w, void* y, int n, int h, int wd, int ci, int co, int blocks,
                   void* stream) {
  const bool pixels = ci == 3 && co == 16, kn = ci == 16 && co == 3;
  if (!(pixels || kn) || n < 1 || h < 1 || wd < 1 || blocks < 1 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (pixels) {
    const int tiles_y = cdiv(h, PX_ROWS), tiles_x = cdiv(wd, PX_COLS);
    const long long tiles = static_cast<long long>(n) * tiles_y * tiles_x;
    const unsigned grid = static_cast<unsigned>(blocks < tiles ? blocks : tiles);
    err = cudaFuncSetAttribute(direct_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    direct_conv_kernel<<<grid, PX_THREADS, PX_SMEM, s>>>(static_cast<const uint16_t*>(x),
                                                         static_cast<const uint16_t*>(w),
                                                         static_cast<__nv_bfloat16*>(y), h, wd, tiles_y, tiles_x,
                                                         tiles);
  } else {
    const int bands = cdiv(wd, KN_COLS);
    const long long strips = static_cast<long long>(n) * bands;
    const int segs = static_cast<int>(blocks / strips > 1 ? blocks / strips : 1);
    const int seg_steps = cdiv(cdiv(h, KN_ROWS), segs);
    err = cudaFuncSetAttribute(direct_conv_kn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, KN_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    direct_conv_kn_kernel<<<static_cast<unsigned>(strips * segs), KN_THREADS, KN_SMEM, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const uint16_t*>(w), static_cast<__nv_bfloat16*>(y), h,
        wd, bands, segs, seg_steps);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fs_cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"

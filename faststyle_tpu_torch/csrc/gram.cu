// Normalized Gram matrix for NVIDIA Hopper (sm_90a), plain C interface.
//
//   G[b] = F[b]^T F[b] / (h*w*c),  F[b] = feats[b] viewed as [hw, c]
//
// Replaces faststyle_tpu/ops/pallas/gram.py:_gram_kernel (the TPU kernel,
// called at gram.py:67). That kernel walks hw in order on one core and
// carries the c x c sum in VMEM; here blocks run in parallel on 132 SMs.
//
// The bound on an H100 (3.35 TB/s, 495 TFLOP/s TF32 and 989 bf16 on the
// tensor cores) is the larger of the bytes (F read once, G written once)
// and passes * b*hw*c(c+1) FLOP for the c(c+1)/2 distinct entries of the
// symmetric G, with 3 TF32 passes for float32 and 1 pass for bf16:
//
//   conv1_2  [4,256,256,64]  f32   0.0200 ms  bytes
//   conv2_2  [4,128,128,128] f32   0.0101 ms  bytes
//   conv3_3  [4,64,64,256]   f32   0.0065 ms  TF32 operations
//   conv4_3  [4,32,32,512]   f32   0.0065 ms  TF32 operations
//   conv2_2  [4,128,128,128] bf16  0.0051 ms  bytes
//
// Those peaks are wgmma's; the warp-level mma.sync used here runs below
// them, so in practice every float32 shape is bound by its 3xTF32 math.
// How the design answers it:
//  1. Tensor cores through mma.sync. bf16 input: m16n8k16 bf16 with
//     fragments from ldmatrix.trans (F is [hw, c] with c contiguous, so
//     both operands of F^T F are stored transposed); the products are
//     exact and the sums f32. float32 input: 3xTF32, x = hi + lo with hi
//     and lo = x - hi each rounded to TF32 to nearest, ties away (what
//     cvt.rna.tf32 does, in two integer operations), and lo*hi + hi*lo +
//     hi*hi accumulated in f32 by m16n8k8 TF32: error near f32's, where
//     1xTF32 would leave ~2^-11 of each entry. Fragments are 32-bit shared
//     loads; a row pitch of TE+8 elements puts the 32 lanes of a fragment
//     load (and the 8 rows of an ldmatrix) on distinct banks.
//  2. Only upper-triangle output tiles run. A diagonal tile in float32
//     needs two passes, not three: G = P + Q + Q^T with P = H^T H and
//     Q = H^T L (H, L the hi and lo parts of its columns), the transpose
//     taken through shared memory after the last stage; a warp whose
//     sub-tile lies wholly below the diagonal computes only its share of
//     Q (bf16: nothing). Diagonal tiles are launched last, so the blocks an
//     SM takes as its second are the cheap ones.
//  3. An asynchronous copy ring: STAGES slots of KSTEP rows, filled by
//     cp.async (16-byte copies when the base pointer and the row pitch are
//     16-byte aligned, 4-byte copies otherwise, and plain element copies
//     for a bf16 input that is not 4-byte aligned), with one barrier per
//     stage; the copies of the next STAGES-1 stages overlap the math. A
//     64-wide block needs at most half an SM's registers and shared
//     memory, so two run on one SM and hide each other's latency.
//  4. Each row of F is read once per output tile: a diagonal tile takes
//     both operands from one slot, and for 64 < c <= 128 one 128-wide tile
//     owns the whole c x c output, so conv1_2 and conv2_2 read every row
//     from device memory exactly once.
//  5. The host's plan (ops/cuda/gram.py) splits hw across blocks only as
//     far as filling the card's block slots needs, capped so the split
//     scratch stays at or under half the input's bytes. With one split
//     the tile kernel writes the scaled tile and its mirror straight into
//     G (one launch); otherwise it writes unscaled partial sums and
//     gram_reduce_kernel adds the splits in a fixed order with the 1/(hwc)
//     scale fused (deterministic: no atomics anywhere).
//
// Ragged edges are masked in-kernel (rows past hw, columns past c copy as
// zero), so the host never pads a copy of F.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int THREADS = 256;        // 8 warps
constexpr int KSTEP = 32;           // rows of F per ring stage
constexpr int RING_BYTES = 110592;  // two blocks' rings fit in an SM's shared memory
constexpr int MAX_STAGES = 8;

// The 8 warps of a block over a TE x TE tile: KG groups of WARPS_M x
// WARPS_N warps, each group taking every KG-th mma step of a stage, so a
// 64-wide tile still gives each warp a 32 x 32 sub-tile (fragments reused
// across 8 products instead of 4).
template <int TE>
struct Tile {
  static constexpr int PITCH = TE + 8;         // shared-memory row pitch, elements
  static constexpr int SLOT = KSTEP * PITCH;   // elements of one operand slot
  static constexpr int KG = TE == 64 ? 2 : 1;  // warp groups splitting each stage's rows
  static constexpr int WARPS_M = 2;
  static constexpr int WARPS_N = 4 / KG;
  static constexpr int WM = TE / WARPS_M;      // warp sub-tile rows
  static constexpr int WN = TE / WARPS_N;      // warp sub-tile columns
  static constexpr int MT = WM / 16;           // m16 fragments per warp
  static constexpr int NT = WN / 8;            // n8 fragments per warp
  static constexpr int QP = TE + 4;            // pitch of the epilogue's f32 tiles
  static constexpr int TT = TE * QP;           // floats of one epilogue tile
  static_assert(KG * WARPS_M * WARPS_N * 32 == THREADS, "8 warps per block");
};

// The copy ring with SLOTS operand slots per stage (1 when every tile is
// diagonal): as many stages as RING_BYTES holds, at most MAX_STAGES.
template <typename T, int TE, int SLOTS>
struct Ring {
  static constexpr int STAGE_BYTES = SLOTS * Tile<TE>::SLOT * static_cast<int>(sizeof(T));
  static constexpr int FIT = RING_BYTES / STAGE_BYTES;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int BYTES = STAGES * STAGE_BYTES;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of BYTES bytes; copies zeros instead when !ok.
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Round to TF32 (10 explicit mantissa bits), to nearest with ties away from
// zero, as cvt.rna.tf32.f32 does: add half of the 13 dropped bits to the
// magnitude and clear them. Two integer operations, which ran faster than
// the cvt on an H100.
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

// Block x of the (tile, image) grid: first the tiles above the diagonal of
// every image, then the diagonal ones, so the blocks launched last (the
// ones an SM takes as its second) are the cheaper diagonal tiles.
__device__ __forceinline__ void block_tile(int x, int nt, int b, int* tm, int* tn, int* bi) {
  const int above = nt * (nt - 1) / 2;
  if (x < above * b) {
    *bi = x / above;
    int t = x % above, row = 0;
    while (t >= nt - 1 - row) {
      t -= nt - 1 - row;
      ++row;
    }
    *tm = row;
    *tn = row + 1 + t;
  } else {
    x -= above * b;
    *bi = x / nt;
    *tm = *tn = x % nt;
  }
}

// KSTEP rows x TE columns of features with row pitch c, from src (the first
// row's first column) into a [KSTEP][PITCH] slot; rows from `rows` on and
// columns from `cols` on copy as zero. VEC is the bytes per copy: 16 or 4
// by cp.async, else one element by a plain load and store. The offsets
// depend only on the thread, so they stay in registers across stages.
template <typename T, int TE, int VEC>
__device__ __forceinline__ void load_slot(T* dst, const T* src, int rows, int cols, int c,
                                          int tid) {
  constexpr int EV = VEC >= 4 ? VEC / static_cast<int>(sizeof(T)) : 1;  // elements per copy
  constexpr int PER_ROW = TE / EV;
  constexpr int COPIES = KSTEP * PER_ROW;
  static_assert(COPIES % THREADS == 0, "copies must divide evenly over the block");
#pragma unroll
  for (int it = 0; it < COPIES / THREADS; ++it) {
    const int i = tid + it * THREADS;
    const int kr = i / PER_ROW;
    const int cc = (i % PER_ROW) * EV;
    const bool ok = kr < rows && cc < cols;
    const T* s = ok ? src + (kr * c + cc) : src;
    T* d = dst + kr * Tile<TE>::PITCH + cc;
    if constexpr (VEC >= 4) {
      cp_async<VEC>(smem_u32(d), s, ok);
    } else {
      *d = ok ? *s : T{};
    }
  }
}

// Which TF32 products a warp accumulates. An off-diagonal tile needs all
// three: acc += lo*hi + hi*lo + hi*hi. On a diagonal tile G = P + Q + Q^T
// with P = H^T H and Q = H^T L (H, L the hi and lo parts of the tile's
// columns), so a warp on or above the diagonal keeps acc = P and q = Q,
// and a warp wholly below it keeps only q; the epilogue adds Q^T from
// shared memory. Two passes where the third comes from the mirror.
enum Passes { ALL3, P_AND_Q, Q_ONLY };

// One stage of 3xTF32 on float32 slots, over the k8 steps of warp group kg,
// where a and b are [KSTEP][PITCH] slots and the warp owns rows mb..,
// columns nb..
template <int TE, Passes PASSES>
__device__ __forceinline__ void mma_stage_tf32(float (&acc)[Tile<TE>::MT][Tile<TE>::NT][4],
                                               float (&q)[Tile<TE>::MT][Tile<TE>::NT][4],
                                               const float* a, const float* b, int mb, int nb,
                                               int kg, int lane) {
  using S = Tile<TE>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KSTEP / (8 * S::KG); ++kk) {
    const int k0 = (kk * S::KG + kg) * 8;
    uint32_t ah[S::MT][4], al[S::MT][4], bh[S::NT][2], bl[S::NT][2];
#pragma unroll
    for (int i = 0; i < S::MT; ++i) {
      // A fragment (m16 x k8, row): (g, t) (g+8, t) (g, t+4) (g+8, t+4)
      const float* p = a + (k0 + t) * S::PITCH + mb + i * 16 + g;
      const float v[4] = {p[0], p[8], p[4 * S::PITCH], p[4 * S::PITCH + 8]};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (PASSES == ALL3)
          split_tf32(v[r], ah[i][r], al[i][r]);
        else
          ah[i][r] = to_tf32(v[r]);
      }
    }
#pragma unroll
    for (int j = 0; j < S::NT; ++j) {
      // B fragment (k8 x n8, col): (k=t, n=g) (k=t+4, n=g)
      const float* p = b + (k0 + t) * S::PITCH + nb + j * 8 + g;
      split_tf32(p[0], bh[j][0], bl[j][0]);
      split_tf32(p[4 * S::PITCH], bh[j][1], bl[j][1]);
    }
    // the small terms first, then the large one
    if (PASSES == ALL3) {
#pragma unroll
      for (int i = 0; i < S::MT; ++i)
#pragma unroll
        for (int j = 0; j < S::NT; ++j) mma_tf32(acc[i][j], al[i], bh[j]);
#pragma unroll
      for (int i = 0; i < S::MT; ++i)
#pragma unroll
        for (int j = 0; j < S::NT; ++j) mma_tf32(acc[i][j], ah[i], bl[j]);
    } else {
#pragma unroll
      for (int i = 0; i < S::MT; ++i)
#pragma unroll
        for (int j = 0; j < S::NT; ++j) mma_tf32(q[i][j], ah[i], bl[j]);
    }
    if (PASSES != Q_ONLY) {
#pragma unroll
      for (int i = 0; i < S::MT; ++i)
#pragma unroll
        for (int j = 0; j < S::NT; ++j) mma_tf32(acc[i][j], ah[i], bh[j]);
    }
  }
}

// One stage on bf16 slots, over the k16 steps of warp group kg: m16n8k16
// with fragments by ldmatrix.trans.
template <int TE>
__device__ __forceinline__ void mma_stage_bf16(float (&acc)[Tile<TE>::MT][Tile<TE>::NT][4],
                                               const __nv_bfloat16* a, const __nv_bfloat16* b,
                                               int mb, int nb, int kg, int lane) {
  using S = Tile<TE>;
  static_assert(S::NT % 2 == 0, "B fragments load in pairs");
  const int l7 = lane & 7, l8 = (lane >> 3) & 1, l16 = lane >> 4;
#pragma unroll
  for (int kk = 0; kk < KSTEP / (16 * S::KG); ++kk) {
    const int k0 = (kk * S::KG + kg) * 16;
    uint32_t af[S::MT][4], bf[S::NT][2];
#pragma unroll
    for (int i = 0; i < S::MT; ++i) {
      // matrices (k0, m) (k0, m+8) (k0+8, m) (k0+8, m+8) -> a0..a3
      const int k = k0 + l7 + l16 * 8;
      const int m = mb + i * 16 + l8 * 8;
      ldsm_x4_t(af[i], smem_u32(a + k * S::PITCH + m));
    }
#pragma unroll
    for (int j = 0; j < S::NT; j += 2) {
      // matrices (k0, n) (k0+8, n) (k0, n+8) (k0+8, n+8) -> b0,b1 of j, j+1
      const int k = k0 + l7 + l8 * 8;
      const int n = nb + j * 8 + l16 * 8;
      uint32_t r[4];
      ldsm_x4_t(r, smem_u32(b + k * S::PITCH + n));
      bf[j][0] = r[0];
      bf[j][1] = r[1];
      bf[j + 1][0] = r[2];
      bf[j + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < S::MT; ++i)
#pragma unroll
      for (int j = 0; j < S::NT; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
  }
}

// Grid ((upper-triangle tile, image), hw split). Each block sums rows
// [split*chunk, (split+1)*chunk) of one image into one TE x TE output tile
// and writes scale * sum for the entries on or above the diagonal, with
// their mirrors, into dst[split][b] (c x c each).
template <typename T, int TE, int SLOTS, int VEC>
__global__ void __launch_bounds__(THREADS, TE == 64 ? 2 : 1)
gram_tile_kernel(const T* __restrict__ feats, float* __restrict__ dst, int hw, int c, int chunk,
                 int nt, int b, float scale) {
  using S = Tile<TE>;
  constexpr int STAGES = Ring<T, TE, SLOTS>::STAGES;
  static_assert(STAGES >= 3, "the ring needs three stages");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  int tm, tn, bi;
  block_tile(blockIdx.x, nt, b, &tm, &tn, &bi);
  const bool diag = SLOTS == 1 || tm == tn;  // one slot: every tile is diagonal
  const int split = blockIdx.y;
  const int m0 = tm * TE;
  const int n0 = tn * TE;
  const int r_begin = split * chunk;
  const int r_end = min(r_begin + chunk, hw);
  const int steps = (r_end - r_begin + KSTEP - 1) / KSTEP;
  const T* f = feats + static_cast<size_t>(bi) * hw * c;
  constexpr int stage_elems = SLOTS * S::SLOT;  // a diagonal tile uses the first slot

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kg = warp / (S::WARPS_M * S::WARPS_N);
  const int mb = (warp / S::WARPS_N) % S::WARPS_M * S::WM;
  const int nb = warp % S::WARPS_N * S::WN;
  // on a diagonal tile, a sub-tile wholly below the diagonal holds only
  // mirrors (and, in float32, its share of Q)
  const bool below = diag && nb + S::WN <= mb;

  // stage s fills slot s % STAGES; the rows of the next stage to load
  const T* next = f + static_cast<size_t>(r_begin) * c;
  int next_r0 = r_begin, wslot = 0;
  auto load_stage = [&]() {
    if (next_r0 < r_end) {
      T* a = smem + wslot * stage_elems;
      load_slot<T, TE, VEC>(a, next + m0, r_end - next_r0, c - m0, c, tid);
      if (!diag) load_slot<T, TE, VEC>(a + S::SLOT, next + n0, r_end - next_r0, c - n0, c, tid);
      next += static_cast<size_t>(KSTEP) * c;
      next_r0 += KSTEP;
    }
    wslot = wslot + 1 == STAGES ? 0 : wslot + 1;
    cp_async_commit();  // one group per stage, empty past the end
  };

  constexpr bool F32 = sizeof(T) == 4;
  float acc[S::MT][S::NT][4], q[S::MT][S::NT][4];
#pragma unroll
  for (int i = 0; i < S::MT; ++i)
#pragma unroll
    for (int j = 0; j < S::NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = q[i][j][r] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_stage();
  for (int step = 0, rslot = 0; step < steps; ++step) {
    cp_async_wait<STAGES - 2>();  // stage `step` has landed (for this thread)
    __syncthreads();              // ... for every thread, and stage step-1 is consumed
    load_stage();                 // stage step+STAGES-1 refills the slot step-1 used
    const T* a = smem + rslot * stage_elems;
    rslot = rslot + 1 == STAGES ? 0 : rslot + 1;
    if constexpr (F32) {
      if (!diag)
        mma_stage_tf32<TE, ALL3>(acc, q, a, a + S::SLOT, mb, nb, kg, lane);
      else if (!below)
        mma_stage_tf32<TE, P_AND_Q>(acc, q, a, a, mb, nb, kg, lane);
      else
        mma_stage_tf32<TE, Q_ONLY>(acc, q, a, a, mb, nb, kg, lane);
    } else if (!below) {
      mma_stage_bf16<TE>(acc, a, diag ? a : a + S::SLOT, mb, nb, kg, lane);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is past its last stage: the ring is free

  // C fragment: (g, 2t) (g, 2t+1) (g+8, 2t) (g+8, 2t+1); its place in a
  // [TE][QP] tile, or in the transposed tile
  const int g = lane >> 2, t = lane & 3;
  auto at = [&](int i, int j, int r, bool transposed) {
    const int m = mb + i * 16 + g + (r >> 1) * 8;
    const int n = nb + j * 8 + 2 * t + (r & 1);
    return transposed ? n * S::QP + m : m * S::QP + n;
  };
  float* red = reinterpret_cast<float*>(smem_raw);
  constexpr int TILES_USED = S::KG == 2 ? (F32 ? 3 : 1) : (F32 ? 1 : 0);
  static_assert(TILES_USED * S::TT * 4 <= Ring<T, TE, SLOTS>::BYTES, "epilogue tiles fit the ring");
  if constexpr (S::KG == 2) {
    // group 1 hands its sums (acc, and q on a float32 diagonal) to group 0
    if (kg == 1) {
#pragma unroll
      for (int i = 0; i < S::MT; ++i)
#pragma unroll
        for (int j = 0; j < S::NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            red[at(i, j, r, false)] = acc[i][j][r];
            if (F32 && diag) red[S::TT + at(i, j, r, false)] = q[i][j][r];
          }
    }
    __syncthreads();
    if (kg == 0) {
#pragma unroll
      for (int i = 0; i < S::MT; ++i)
#pragma unroll
        for (int j = 0; j < S::NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc[i][j][r] += red[at(i, j, r, false)];
            if (F32 && diag) q[i][j][r] += red[S::TT + at(i, j, r, false)];
          }
    }
  }
  if (F32 && diag) {
    // acc = P becomes P + Q + Q^T, with Q^T read transposed from shared memory
    float* qs = red + (S::KG == 2 ? 2 * S::TT : 0);
    if (kg == 0) {
#pragma unroll
      for (int i = 0; i < S::MT; ++i)
#pragma unroll
        for (int j = 0; j < S::NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) qs[at(i, j, r, false)] = q[i][j][r];
    }
    __syncthreads();
    if (kg == 0 && !below) {
#pragma unroll
      for (int i = 0; i < S::MT; ++i)
#pragma unroll
        for (int j = 0; j < S::NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] += q[i][j][r] + qs[at(i, j, r, true)];
    }
  }
  if (kg != 0 || below) return;

  float* out = dst + (static_cast<size_t>(split) * b + bi) * c * c;
#pragma unroll
  for (int i = 0; i < S::MT; ++i)
#pragma unroll
    for (int j = 0; j < S::NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + mb + i * 16 + g + (r >> 1) * 8;
        const int n = n0 + nb + j * 8 + 2 * t + (r & 1);
        if (m <= n && n < c) {
          const float v = acc[i][j][r] * scale;
          out[static_cast<size_t>(m) * c + n] = v;
          if (m < n) out[static_cast<size_t>(n) * c + m] = v;
        }
      }
}

// out = inv_norm * sum over splits of partial[split] (c x c per image), V
// floats at a time. A block owns RED_ELEMS consecutive packs; thread way w
// of a pack adds splits w, w + RED_WAYS, ... in order, and one thread adds
// the RED_WAYS sums in a fixed order: deterministic, with loads in flight.
constexpr int RED_ELEMS = 64;
constexpr int RED_WAYS = 4;

template <int V>
struct alignas(4 * V) Pack {
  float v[V];
};

template <int V>
__global__ void __launch_bounds__(RED_ELEMS * RED_WAYS)
gram_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out, long long total,
                   int splits, float inv_norm) {
  __shared__ Pack<V> sums[RED_WAYS][RED_ELEMS];
  const long long n = total / V;
  const Pack<V>* p = reinterpret_cast<const Pack<V>*>(partial);
  const int e = threadIdx.x % RED_ELEMS;
  const int way = threadIdx.x / RED_ELEMS;
  const long long idx = static_cast<long long>(blockIdx.x) * RED_ELEMS + e;
  Pack<V> s = {};
  if (idx < n) {
#pragma unroll 4
    for (int sp = way; sp < splits; sp += RED_WAYS) {
      const Pack<V> x = p[sp * n + idx];
#pragma unroll
      for (int k = 0; k < V; ++k) s.v[k] += x.v[k];
    }
  }
  sums[way][e] = s;
  __syncthreads();
  if (way == 0 && idx < n) {
    Pack<V> o;
#pragma unroll
    for (int k = 0; k < V; ++k)
      o.v[k] = ((sums[0][e].v[k] + sums[1][e].v[k]) + (sums[2][e].v[k] + sums[3][e].v[k])) * inv_norm;
    reinterpret_cast<Pack<V>*>(out)[idx] = o;
  }
}

template <typename T, int TE, int SLOTS, int VEC>
cudaError_t launch_tiles(const void* feats, float* dst, int b, int hw, int c, int splits,
                         int chunk, float scale, cudaStream_t stream) {
  constexpr int smem = Ring<T, TE, SLOTS>::BYTES;
  // A function's attributes belong to one device's context: set them once
  // per kernel and device (bit d of `ready`), before the first launch there.
  static std::atomic<unsigned long long> ready{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;  // beyond 64: every launch
  if (!bit || !(ready.load(std::memory_order_relaxed) & bit)) {
    e = cudaFuncSetAttribute(gram_tile_kernel<T, TE, SLOTS, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(gram_tile_kernel<T, TE, SLOTS, VEC>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    ready.fetch_or(bit, std::memory_order_relaxed);
  }
  const int nt = (c + TE - 1) / TE;
  const dim3 grid(b * nt * (nt + 1) / 2, splits);
  gram_tile_kernel<T, TE, SLOTS, VEC><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(feats), dst, hw, c, chunk, nt, b, scale);
  return cudaGetLastError();
}

template <typename T, int TE, int SLOTS>
cudaError_t launch_tiles_vec(int vec, const void* feats, float* dst, int b, int hw, int c,
                             int splits, int chunk, float scale, cudaStream_t stream) {
  if (vec == 16)
    return launch_tiles<T, TE, SLOTS, 16>(feats, dst, b, hw, c, splits, chunk, scale, stream);
  if (vec == 4)
    return launch_tiles<T, TE, SLOTS, 4>(feats, dst, b, hw, c, splits, chunk, scale, stream);
  if constexpr (sizeof(T) == 2) {
    return launch_tiles<T, TE, SLOTS, 2>(feats, dst, b, hw, c, splits, chunk, scale, stream);
  }
  return cudaErrorInvalidValue;
}

// 64-wide tiles, with one operand slot per stage when c <= 64 (every tile
// diagonal) and two otherwise; one 128-wide tile for 64 < c <= 128.
template <typename T>
cudaError_t launch_tiles_any(int tile, int vec, const void* feats, float* dst, int b, int hw,
                             int c, int splits, int chunk, float scale, cudaStream_t stream) {
  if (tile == 64 && c <= 64)
    return launch_tiles_vec<T, 64, 1>(vec, feats, dst, b, hw, c, splits, chunk, scale, stream);
  if (tile == 64)
    return launch_tiles_vec<T, 64, 2>(vec, feats, dst, b, hw, c, splits, chunk, scale, stream);
  if (tile == 128 && c <= 128)
    return launch_tiles_vec<T, 128, 1>(vec, feats, dst, b, hw, c, splits, chunk, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// feats: [b, hw, c] contiguous, float32 (is_bf16 == 0) or bfloat16, at any
// element-aligned address. out: [b, c, c] float32. partial: scratch of
// splits*b*c*c floats, unused when splits == 1. Rows [s*chunk, (s+1)*chunk)
// of each image go to split s; the caller makes chunk a multiple of 32,
// splits*chunk >= hw, and tile 64, or 128 when c <= 128. One launch when splits == 1, else
// two. Returns cudaGetLastError() of the last launch, or the first error.
int fs_gram_forward(const void* feats, void* partial, void* out, int is_bf16, int b, int hw,
                    int c, int splits, int chunk, int tile, float inv_norm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t elem = is_bf16 ? 2 : 4;
  const size_t align = reinterpret_cast<uintptr_t>(feats) | (static_cast<size_t>(c) * elem);
  const int vec = align % 16 == 0 ? 16 : (align % 4 == 0 ? 4 : 2);
  const bool direct = splits == 1;
  float* dst = static_cast<float*>(direct ? out : partial);
  const float scale = direct ? inv_norm : 1.f;
  cudaError_t err =
      is_bf16 ? launch_tiles_any<__nv_bfloat16>(tile, vec, feats, dst, b, hw, c, splits, chunk,
                                                scale, s)
              : launch_tiles_any<float>(tile, vec, feats, dst, b, hw, c, splits, chunk, scale, s);
  if (err != cudaSuccess || direct) return static_cast<int>(err);
  const long long total = static_cast<long long>(b) * c * c;
  const bool by4 = total % 4 == 0;  // torch's allocations are 16-byte aligned
  const long long packs = by4 ? total / 4 : total;
  const unsigned blocks = static_cast<unsigned>((packs + RED_ELEMS - 1) / RED_ELEMS);
  const float* part = static_cast<const float*>(partial);
  float* g = static_cast<float*>(out);
  if (by4)
    gram_reduce_kernel<4><<<blocks, RED_ELEMS * RED_WAYS, 0, s>>>(part, g, total, splits, inv_norm);
  else
    gram_reduce_kernel<1><<<blocks, RED_ELEMS * RED_WAYS, 0, s>>>(part, g, total, splits, inv_norm);
  return static_cast<int>(cudaGetLastError());
}

const char* fs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Normalized Gram matrix for NVIDIA Hopper (sm_90a), plain C interface.
//
//   G[b] = F[b]^T F[b] / (h*w*c),  F[b] = feats[b] viewed as [hw, c]
//
// Replaces faststyle_tpu/ops/pallas/gram.py:_gram_kernel (the TPU kernel,
// called at gram.py:67). That kernel walks hw in order on one core and
// carries the c x c sum in VMEM; here blocks run in parallel on 132 SMs,
// so the design is:
//
//   gram_partial_kernel  grid (upper-triangle tile, hw split, batch). Each
//                        block owns one 64x64 output tile for one slice of
//                        `chunk` rows of F and writes its unnormalized sum to
//                        a scratch buffer [splits, b, c, c]. Only tiles with
//                        tm <= tn run: G is symmetric.
//   gram_reduce_kernel   sums the splits in a fixed order (deterministic,
//                        no atomics), mirrors the lower-triangle tiles and
//                        fuses the 1/(hwc) scale into the final write.
//
// Bound on an H100: at the training shapes (b4@256: [4,256,256,64],
// [4,128,128,128], [4,64,64,256], [4,32,32,512]) each call is
// 2*b*hw*c^2 = 2^31 FLOP but reads only 8-67 MB, so exact-f32 work is
// bound by operations (~32 us at 67 TFLOP/s FP32) rather than bytes
// (<= 20 us at 3.35 TB/s). Splitting hw is what fills the card: one tile
// per batch at conv1_2 would give 4 blocks for 132 SMs. The inner loop is
// shared-memory tiles and FFMA in f32 (a 4x4 register tile per thread);
// wgmma/TMA and a TF32 decision are left for a later redesign.
//
// Ragged edges are masked in-kernel (rows past hw, columns past c read as
// zero), so the host never pads a copy of F.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TILE = 64;      // output tile edge
constexpr int KSTEP = 32;     // rows of F staged in shared memory per step
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Linear index over the upper-triangle tiles (tm <= tn) of an nt x nt grid.
__device__ __forceinline__ void tri_tile(int t, int nt, int* tm, int* tn) {
  int row = 0;
  while (t >= nt - row) {
    t -= nt - row;
    ++row;
  }
  *tm = row;
  *tn = row + t;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gram_partial_kernel(const T* __restrict__ feats, float* __restrict__ partial,
                    int hw, int c, int chunk, int nt) {
  __shared__ __align__(16) float As[KSTEP][TILE];
  __shared__ __align__(16) float Bs[KSTEP][TILE];

  int tm, tn;
  tri_tile(blockIdx.x, nt, &tm, &tn);
  const int split = blockIdx.y;
  const int b = blockIdx.z;
  const int m0 = tm * TILE;
  const int n0 = tn * TILE;
  const int r_begin = split * chunk;
  const int r_end = min(r_begin + chunk, hw);
  const T* f = feats + (size_t)b * hw * c;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += KSTEP) {
    // neighbouring threads read neighbouring columns of one row: coalesced
    for (int i = tid; i < KSTEP * TILE; i += THREADS) {
      const int kr = i / TILE;
      const int col = i % TILE;
      const int r = r0 + kr;
      const bool row_ok = r < r_end;
      const int ca = m0 + col;
      const int cb = n0 + col;
      const size_t row_off = (size_t)r * c;
      As[kr][col] = (row_ok && ca < c) ? to_float(f[row_off + ca]) : 0.f;
      Bs[kr][col] = (row_ok && cb < c) ? to_float(f[row_off + cb]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < KSTEP; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 v = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* p = partial + ((size_t)split * gridDim.z + b) * c * c;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= c) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < c) p[(size_t)row * c + col] = acc[i][j];
    }
  }
}

__global__ void gram_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                   int b, int c, int splits, float inv_norm) {
  const size_t cc = (size_t)c * c;
  const size_t total = (size_t)b * cc;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    const size_t bi = idx / cc;
    const int rem = (int)(idx % cc);
    int i = rem / c;
    int j = rem % c;
    if (i / TILE > j / TILE) {  // lower-triangle tile: read its mirror
      const int t = i;
      i = j;
      j = t;
    }
    const size_t off = bi * cc + (size_t)i * c + j;
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += partial[(size_t)sp * total + off];
    out[idx] = s * inv_norm;
  }
}

}  // namespace

extern "C" {

// feats: [b, hw, c] contiguous, float32 (is_bf16 == 0) or bfloat16.
// partial: scratch of splits*b*c*c floats; out: [b, c, c] float32.
// Rows [s*chunk, (s+1)*chunk) of each image go to split s; the caller makes
// chunk a multiple of 32 and splits*chunk >= hw. Returns cudaGetLastError().
int fs_gram_forward(const void* feats, void* partial, void* out, int is_bf16, int b, int hw,
                    int c, int splits, int chunk, float inv_norm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt = (c + TILE - 1) / TILE;
  const dim3 grid(nt * (nt + 1) / 2, splits, b);
  float* part = static_cast<float*>(partial);
  if (is_bf16) {
    gram_partial_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(feats), part, hw, c, chunk, nt);
  } else {
    gram_partial_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(feats), part, hw, c, chunk, nt);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = (size_t)b * c * c;
  size_t blocks = (total + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  gram_reduce_kernel<<<(unsigned)blocks, 256, 0, s>>>(part, static_cast<float*>(out), b, c,
                                                      splits, inv_norm);
  return static_cast<int>(cudaGetLastError());
}

const char* fs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

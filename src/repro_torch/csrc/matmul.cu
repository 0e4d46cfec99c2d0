// Blocked GEMM, C = A @ B, on CUDA cores, for f32 and bf16 operands.
//
// Replaces: src/repro/kernels/matmul/matmul.py, _matmul_kernel /
// matmul_pallas (with the tile padding of ops.matmul).
//
// Bound on the card: operations. 2mnk FLOPs against (mk + kn + mn) words
// puts a 4096 x 2048 x 6144 product far above the H100's ridge point, so
// the roof is the f32 CUDA-core peak (67 TFLOP/s on the data sheet). What
// keeps a simple kernel from it is the traffic into the FMA units: one
// FMA per shared-memory load would cap it at the shared-memory rate.
//
// Design: one block owns a (BM, BN) output tile; the TPU's sequential k
// grid axis and its f32 VMEM accumulator become a k loop inside the
// block with the f32 accumulator in registers. Each k step stages a
// (BM, BK) slice of A (transposed, so the inner loop reads one column)
// and a (BK, BN) slice of B in shared memory, converting bf16 to f32 on
// the way in. Each thread then owns an 8 x 8 register tile, strided
// across the block tile so that a warp's shared-memory reads and global
// writes hit consecutive addresses: every value read from shared memory
// feeds 8 FMAs. Ragged edges are masked in the kernel (zero-filled loads,
// guarded stores), so the host pads nothing. Shared memory is
// (BM*BK + BK*BN) * 4 bytes, 32 KiB at most over the tile table: static,
// under the 48 KiB limit. wgmma, TMA and the tensor cores are not used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTM = 8;  // register tile rows per thread
constexpr int kTN = 8;  // register tile columns per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__((BM / kTM) * (BN / kTN))
matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
              T* __restrict__ c, int64_t m, int64_t n, int64_t k) {
  constexpr int kThreadsN = BN / kTN;
  constexpr int kThreads = (BM / kTM) * kThreadsN;
  __shared__ float as[BK][BM];  // A slice, transposed
  __shared__ float bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % kThreadsN;
  const int ty = tid / kThreadsN;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * BN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int64_t k0 = 0; k0 < k; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += kThreads) {
      const int r = idx / BK;
      const int kk = idx % BK;
      const int64_t gr = row0 + r;
      const int64_t gk = k0 + kk;
      as[kk][r] = (gr < m && gk < k) ? to_f32(a[gr * k + gk]) : 0.0f;
    }
    for (int idx = tid; idx < BK * BN; idx += kThreads) {
      const int kk = idx / BN;
      const int col = idx % BN;
      const int64_t gk = k0 + kk;
      const int64_t gc = col0 + col;
      bs[kk][col] = (gk < k && gc < n) ? to_f32(b[gk * n + gc]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float ra[kTM], rb[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) ra[i] = as[kk][ty + i * (BM / kTM)];
#pragma unroll
      for (int j = 0; j < kTN; ++j) rb[j] = bs[kk][tx + j * kThreadsN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int64_t gr = row0 + ty + i * (BM / kTM);
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int64_t gc = col0 + tx + j * kThreadsN;
      if (gc < n) from_f32(&c[gr * n + gc], acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN, int BK>
int launch(const void* a, const void* b, void* c, int64_t m, int64_t n,
           int64_t k, int device, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((n + BN - 1) / BN),
                  static_cast<unsigned>((m + BM - 1) / BM));
  const dim3 block((BM / kTM) * (BN / kTN));
  matmul_kernel<T, BM, BN, BK>
      <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(a), static_cast<const T*>(b),
          static_cast<T*>(c), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tile table: one extern "C" launcher per (dtype, BM, BN, BK), named
// rt_matmul_<dtype>_<BM>x<BN>x<BK>. The Python wrapper's TILES must list
// exactly these (BM, BN, BK) triples. Each launcher makes `device`
// current, enqueues on `stream` and returns cudaGetLastError().
#define RT_MATMUL(NAME, T, BM, BN, BK)                                      \
  extern "C" int rt_matmul_##NAME##_##BM##x##BN##x##BK(                     \
      const void* a, const void* b, void* c, int64_t m, int64_t n,          \
      int64_t k, int device, void* stream) {                                \
    return launch<T, BM, BN, BK>(a, b, c, m, n, k, device, stream);         \
  }

#define RT_MATMUL_TILES(NAME, T)  \
  RT_MATMUL(NAME, T, 64, 64, 8)   \
  RT_MATMUL(NAME, T, 64, 64, 16)  \
  RT_MATMUL(NAME, T, 64, 64, 32)  \
  RT_MATMUL(NAME, T, 64, 128, 8)  \
  RT_MATMUL(NAME, T, 64, 128, 16) \
  RT_MATMUL(NAME, T, 64, 128, 32) \
  RT_MATMUL(NAME, T, 128, 64, 8)  \
  RT_MATMUL(NAME, T, 128, 64, 16) \
  RT_MATMUL(NAME, T, 128, 64, 32) \
  RT_MATMUL(NAME, T, 128, 128, 8) \
  RT_MATMUL(NAME, T, 128, 128, 16) \
  RT_MATMUL(NAME, T, 128, 128, 32)

RT_MATMUL_TILES(f32, float)
RT_MATMUL_TILES(bf16, __nv_bfloat16)

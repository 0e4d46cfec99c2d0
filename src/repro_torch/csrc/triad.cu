// STREAM TRIAD, C = A + gamma * B, for f32 and bf16 vectors.
//
// Replaces: src/repro/kernels/triad/triad.py, _triad_kernel / triad_pallas
// (with the padding and (rows, 1024) reshaping of ops.triad).
//
// Bound on the card: bytes. 2 FLOP per element against 3 words moved
// (read A, read B, write C) puts TRIAD at 1/12 FLOP/B in f32, two orders
// of magnitude under the H100's ridge point; past the 50 MB L2 the only
// roof that matters is HBM (3.35 TB/s on the data sheet).
//
// Design: a flat 1-D grid-stride loop over 16-byte vectors (float4, or 8
// bf16 values), with kUnroll vectors per thread per iteration, all loads
// issued before any store so each thread keeps 2 * kUnroll * 16 bytes in
// flight. Neighbouring threads touch neighbouring 16-byte chunks, so
// every warp access is fully coalesced. The TPU's (rows, 1024) lane
// layout and the host-side padding it needed are gone: the vector body
// covers n rounded down to whole vectors, block 0 finishes the scalar
// tail, and a pointer that is not 16-byte aligned sends the whole call
// to a scalar grid-stride loop instead. bf16 is computed in f32 and
// rounded once (the Pallas kernel rounds gamma * B and the sum
// separately). f32 uses separately rounded multiply and add, no FMA, so
// it matches the plain `a + gamma * b` bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kUnroll = 4;
constexpr int64_t kMaxBlocks = 1 << 20;

__device__ __forceinline__ float triad_op(float a, float b, float gamma) {
  return __fadd_rn(a, __fmul_rn(gamma, b));
}

struct F32 {
  using scalar = float;
  using vec = float4;
  static constexpr int kWidth = 4;
  __device__ static float load(const float* p, int64_t i) { return p[i]; }
  __device__ static void store(float* p, int64_t i, float v) { p[i] = v; }
  __device__ static vec apply(vec a, vec b, float g) {
    return make_float4(triad_op(a.x, b.x, g), triad_op(a.y, b.y, g),
                       triad_op(a.z, b.z, g), triad_op(a.w, b.w, g));
  }
};

struct BF16 {
  using scalar = __nv_bfloat16;
  using vec = uint4;  // 8 bf16 values
  static constexpr int kWidth = 8;
  __device__ static float load(const __nv_bfloat16* p, int64_t i) {
    return __bfloat162float(p[i]);
  }
  __device__ static void store(__nv_bfloat16* p, int64_t i, float v) {
    p[i] = __float2bfloat16(v);
  }
  __device__ static vec apply(vec a, vec b, float g) {
    vec out;
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
    __nv_bfloat162* po = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float2 fa = __bfloat1622float2(pa[k]);
      float2 fb = __bfloat1622float2(pb[k]);
      po[k] = __floats2bfloat162_rn(triad_op(fa.x, fb.x, g),
                                    triad_op(fa.y, fb.y, g));
    }
    return out;
  }
};

template <typename T>
__global__ void __launch_bounds__(kBlock)
triad_vec_kernel(const typename T::scalar* __restrict__ a,
                 const typename T::scalar* __restrict__ b,
                 typename T::scalar* __restrict__ c, int64_t n, float gamma) {
  using V = typename T::vec;
  const V* va = reinterpret_cast<const V*>(a);
  const V* vb = reinterpret_cast<const V*>(b);
  V* vc = reinterpret_cast<V*>(c);
  const int64_t nvec = n / T::kWidth;
  const int64_t tile = static_cast<int64_t>(kBlock) * kUnroll;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * tile; base < nvec;
       base += static_cast<int64_t>(gridDim.x) * tile) {
    V x[kUnroll], y[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * kBlock + threadIdx.x;
      if (i < nvec) {
        x[u] = va[i];
        y[u] = vb[i];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * kBlock + threadIdx.x;
      if (i < nvec) vc[i] = T::apply(x[u], y[u], gamma);
    }
  }
  if (blockIdx.x == 0) {  // scalar tail: fewer than kWidth elements
    const int64_t i = nvec * T::kWidth + threadIdx.x;
    if (i < n) T::store(c, i, triad_op(T::load(a, i), T::load(b, i), gamma));
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
triad_scalar_kernel(const typename T::scalar* __restrict__ a,
                    const typename T::scalar* __restrict__ b,
                    typename T::scalar* __restrict__ c, int64_t n,
                    float gamma) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * kBlock) {
    T::store(c, i, triad_op(T::load(a, i), T::load(b, i), gamma));
  }
}

template <typename T>
int launch(const void* a, const void* b, void* c, int64_t n, float gamma,
           int device, void* stream) {
  if (n <= 0) return 0;
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  using S = typename T::scalar;
  const S* pa = static_cast<const S*>(a);
  const S* pb = static_cast<const S*>(b);
  S* pc = static_cast<S*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = ((reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(c)) & 15u) == 0;
  if (aligned) {
    const int64_t nvec = n / T::kWidth;
    const int64_t tile = static_cast<int64_t>(kBlock) * kUnroll;
    int64_t blocks = (nvec + tile - 1) / tile;
    if (blocks < 1) blocks = 1;  // the tail alone still needs block 0
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    triad_vec_kernel<T><<<static_cast<unsigned>(blocks), kBlock, 0, s>>>(
        pa, pb, pc, n, gamma);
  } else {
    int64_t blocks = (n + kBlock - 1) / kBlock;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    triad_scalar_kernel<T><<<static_cast<unsigned>(blocks), kBlock, 0, s>>>(
        pa, pb, pc, n, gamma);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each launcher makes `device` current, enqueues on `stream` (a stream of
// that device) and returns cudaGetLastError().
int rt_triad_f32(const void* a, const void* b, void* c, int64_t n,
                 float gamma, int device, void* stream) {
  return launch<F32>(a, b, c, n, gamma, device, stream);
}

int rt_triad_bf16(const void* a, const void* b, void* c, int64_t n,
                  float gamma, int device, void* stream) {
  return launch<BF16>(a, b, c, n, gamma, device, stream);
}

}  // extern "C"

// Flash attention forward (online softmax) on CUDA cores, float32.
//
// Replaced, on no route: it was the port of
// src/repro/kernels/flash_attention/flash_attention.py:33, _attn_kernel /
// flash_attention_pallas, for float32 operands. f32 now takes the
// tensor-core kernels, whose 3xTF32 products keep f32 accuracy:
// flash_attention_tf32x3.cu at head dims up to 128 and
// flash_attention_tf32x3_d256.cu at 256 (Q fed from registers); bf16 takes
// flash_attention_sm90.cu. This kernel stays compiled for every head dim of
// its table: chip_smoke.py and bench/flash_probe.py time it at D = 64 and
// D = 256 beside the kernels that replaced it (was_ms).
//
// Computes, per (batch, query head), o = softmax(q k^T * sm_scale + mask) v
// over (S, D) tiles: GQA (query head h reads kv head h / (H / Hkv)), a
// causal mask, a sliding window (q - k < window), keys at or past kv_len
// masked (the wrapper's zero padding), all at -1e30; f32 running (m, l,
// acc); a row with no visible key writes 0; the output is f32.
//
// Bound on the card: operations. 4 S^2 D FLOPs (halved when causal)
// against 4 S D words per head puts the model shapes far above the ridge
// point. In full f32 the roof is the CUDA cores' 67 TFLOP/s (data sheet):
// both products run as f32 FMAs from shared memory.
//
// Design. Hopper blocks run in no order, so the TPU's sequential kv grid
// axis becomes a kv loop inside the block. A block of 128 threads owns one
// (b, h, q tile of QT rows); the q tile sits in shared memory for the
// whole loop, and m, l and the (QT, D) accumulator live in registers:
// thread (ty, tx) of 16 x 8 owns rows ty + 16 i and, in the accumulator,
// dims tx + 8 n. Each kv sub-tile of KT rows is staged in shared memory
// (K transposed, V row-major); the scores are a register-tiled (QT, KT)
// product whose row max and row sum are reduced across the 8 lanes of a
// row with warp shuffles; the probabilities go to shared memory for the
// P V product. Tiles carry one float of padding per row so that every
// warp access is conflict-free or a broadcast. Ragged edges (S not a
// multiple of the tile, blocks equal to S below 128) are masked here, so
// the physical tiles (QT, KT) = (64, 64) for D <= 80, (64, 32) for D = 128
// and (32, 32) for D = 256 are fixed by the register and shared-memory
// budget, at most 102 KiB (dynamic shared memory, opted in per launch). D
// need only be a multiple of the 8 column lanes, since every load and
// store is a scalar one: D = 80 (zamba2-2.7b's 2560 / 32 heads) runs as 10
// accumulator dims per thread in 77 KiB.
//
// The tunable (bq, bk) keeps the TPU kernel's meaning: the logical block
// at which a kv block wholly outside the causal or window mask is
// skipped. A kv sub-tile runs when the logical kv block around it is not
// skipped for the logical q block around the q tile, as the TPU kernel's
// pl.when does, so a coarser logical block visits more masked sub-tiles.
// Blocks are issued heaviest first (last q tiles first) for causal masks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kRowGroups = 16;  // ty: rows ty + 16 i
constexpr int kColLanes = 8;    // tx: columns tx + 8 j, dims tx + 8 n
constexpr int kThreads = kRowGroups * kColLanes;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }

// Max and sum over the 8 lanes that share a row (lanes 8r .. 8r + 7).
__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

// Shared-memory layout of one block, in floats.
template <int D, int QT, int KT>
struct Layout {
  static constexpr int kQ = D * (QT + 1);   // q tile, transposed
  static constexpr int kK = D * (KT + 1);   // k sub-tile, transposed
  static constexpr int kV = KT * D;         // v sub-tile
  static constexpr int kP = QT * (KT + 1);  // probabilities
  static constexpr size_t kBytes =
      static_cast<size_t>(kQ + kK + kV + kP) * sizeof(float);
};

template <typename T, int D, int QT, int KT>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int64_t heads, int64_t kv_heads, int64_t seq,
                       int64_t kv_len, int64_t bq, int64_t bk, int causal,
                       int64_t window, float sm_scale) {
  constexpr int RM = QT / kRowGroups;  // rows per thread
  constexpr int CN = KT / kColLanes;   // score columns per thread
  constexpr int DN = D / kColLanes;    // accumulator dims per thread
  static_assert(QT % kRowGroups == 0 && KT % kColLanes == 0 &&
                D % kColLanes == 0 && CN <= 32, "tile shape");
  using L = Layout<D, QT, KT>;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + L::kQ;
  float* vs = ks + L::kK;
  float* ps = vs + L::kV;

  const int tid = threadIdx.x;
  const int tx = tid % kColLanes;
  const int ty = tid / kColLanes;
  const int64_t q0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * QT;
  const int64_t h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t hk = h / (heads / kv_heads);
  const T* qb = q + (b * heads + h) * seq * D;
  const T* kb = k + (b * kv_heads + hk) * seq * D;
  const T* vb = v + (b * kv_heads + hk) * seq * D;
  T* ob = o + (b * heads + h) * seq * D;

  for (int idx = tid; idx < QT * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx % D;
    const int64_t gr = q0 + r;
    qs[d * (QT + 1) + r] = gr < seq ? to_f32(qb[gr * D + d]) : 0.0f;
  }

  float m_run[RM], l_run[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.0f;
#pragma unroll
    for (int n = 0; n < DN; ++n) acc[i][n] = 0.0f;
  }

  // The logical q block(s) this tile lies in (the skip granularity).
  const int64_t q_last = (q0 + QT < seq ? q0 + QT : seq) - 1;
  const int64_t lq_lo = (q0 / bq) * bq;
  const int64_t lq_hi = (q_last / bq + 1) * bq - 1;
  __syncthreads();

  for (int64_t k0 = 0; k0 < seq; k0 += KT) {
    const int64_t k_last = (k0 + KT < seq ? k0 + KT : seq) - 1;
    const int64_t lk_lo = (k0 / bk) * bk;
    const int64_t lk_hi = (k_last / bk + 1) * bk - 1;
    if (causal && lk_lo > lq_hi) continue;               // all in the future
    if (window > 0 && lk_hi < lq_lo - window + 1) continue;  // all too old

    for (int idx = tid; idx < KT * D; idx += kThreads) {
      const int r = idx / D;
      const int d = idx % D;
      const int64_t gr = k0 + r;
      const bool in = gr < seq;
      ks[d * (KT + 1) + r] = in ? to_f32(kb[gr * D + d]) : 0.0f;
      vs[r * D + d] = in ? to_f32(vb[gr * D + d]) : 0.0f;
    }
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[RM], kk[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qa[i] = qs[d * (QT + 1) + ty + kRowGroups * i];
#pragma unroll
      for (int j = 0; j < CN; ++j) kk[j] = ks[d * (KT + 1) + tx + kColLanes * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(qa[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int64_t row = q0 + ty + kRowGroups * i;
      uint32_t ok_bits = 0u;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int64_t col = k0 + tx + kColLanes * j;
        bool ok = col < kv_len;
        if (causal) ok = ok && row >= col;
        if (window > 0) ok = ok && row - col < window;
        s[i][j] = ok ? s[i][j] * sm_scale : kNegInf;
        ok_bits |= static_cast<uint32_t>(ok) << j;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_run[i], row_max(mx));
      const float alpha = expf(m_run[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = ((ok_bits >> j) & 1u) ? expf(s[i][j] - m_new) : 0.0f;
        ps[(ty + kRowGroups * i) * (KT + 1) + tx + kColLanes * j] = p;
        sum += p;
      }
      l_run[i] = l_run[i] * alpha + row_sum(sum);
      m_run[i] = m_new;
#pragma unroll
      for (int n = 0; n < DN; ++n) acc[i][n] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < KT; ++j) {
      float pa[RM], vv[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) pa[i] = ps[(ty + kRowGroups * i) * (KT + 1) + j];
#pragma unroll
      for (int n = 0; n < DN; ++n) vv[n] = vs[j * D + tx + kColLanes * n];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int n = 0; n < DN; ++n) acc[i][n] = fmaf(pa[i], vv[n], acc[i][n]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int64_t row = q0 + ty + kRowGroups * i;
    if (row >= seq) continue;
    const float l_safe = l_run[i] == 0.0f ? 1.0f : l_run[i];
#pragma unroll
    for (int n = 0; n < DN; ++n)
      from_f32(&ob[row * D + tx + kColLanes * n], acc[i][n] / l_safe);
  }
}

template <typename T, int D, int QT, int KT>
int launch(const void* q, const void* k, const void* v, void* o,
           int64_t batch, int64_t heads, int64_t kv_heads, int64_t seq,
           int64_t kv_len, int64_t bq, int64_t bk, int causal,
           int64_t window, float sm_scale, int device, void* stream) {
  if (batch <= 0 || heads <= 0 || seq <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads != 0 || bq <= 0 || bk <= 0 ||
      kv_len < 0 || kv_len > seq || batch > 65535 || heads > 65535 ||
      (seq + QT - 1) / QT > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  constexpr size_t smem = Layout<D, QT, KT>::kBytes;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_kernel<T, D, QT, KT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>((seq + QT - 1) / QT),
                  static_cast<unsigned>(heads),
                  static_cast<unsigned>(batch));
  flash_attention_kernel<T, D, QT, KT>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o), heads, kv_heads,
          seq, kv_len, bq, bk, causal, window, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The head dims the kernel is compiled for, each with its physical
// (QT, KT) tile; the one list the launchers and the shared-memory query
// below are made from.
#define RT_FLASH_TILES(X) \
  X(16, 64, 64)           \
  X(32, 64, 64)           \
  X(64, 64, 64)           \
  X(80, 64, 64)           \
  X(128, 64, 32)          \
  X(256, 32, 32)

// One extern "C" launcher per head dim, named rt_flash_attention_f32_d<D>.
// Each launcher makes `device` current, enqueues on `stream` and returns
// cudaGetLastError(); window <= 0 means no window.
#define RT_FLASH_F32(D, QT, KT)                                             \
  extern "C" int rt_flash_attention_f32_d##D(                               \
      const void* q, const void* k, const void* v, void* o, int64_t batch,  \
      int64_t heads, int64_t kv_heads, int64_t seq, int64_t kv_len,         \
      int64_t bq, int64_t bk, int causal, int64_t window, float sm_scale,   \
      int device, void* stream) {                                           \
    return launch<float, D, QT, KT>(q, k, v, o, batch, heads, kv_heads,    \
                                    seq, kv_len, bq, bk, causal, window,    \
                                    sm_scale, device, stream);              \
  }
RT_FLASH_TILES(RT_FLASH_F32)

// Dynamic shared memory one block of the head dim's f32 launcher asks for,
// in bytes, or -1 for a head dim without a launcher.
#define RT_FLASH_SMEM(D, QT, KT) \
  case D: return static_cast<int64_t>(Layout<D, QT, KT>::kBytes);
extern "C" int64_t rt_flash_attention_smem_bytes(int head_dim) {
  switch (head_dim) {
    RT_FLASH_TILES(RT_FLASH_SMEM)
    default: return -1;
  }
}

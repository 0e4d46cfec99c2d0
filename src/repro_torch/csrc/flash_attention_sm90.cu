// Flash attention forward (online softmax), bf16, on Hopper's tensor cores.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py:33,
// _attn_kernel / flash_attention_pallas, for bfloat16 operands (with the
// padding of ops.flash_attention, which the Python wrapper keeps). The
// float32 forward has its own tensor-core kernels (3xTF32 products,
// f32-accurate), flash_attention_tf32x3.cu and, at D = 256,
// flash_attention_tf32x3_d256.cu. The Hopper building blocks live in
// hopper.cuh.
//
// Computes, per (batch, query head), o = softmax(q k^T * sm_scale + mask) v
// over (S, D) tiles: GQA (query head h reads kv head h / (H / Hkv)), a
// causal mask, a sliding window (q - k < window), keys at or past kv_len
// masked (the wrapper's zero padding); f32 running (m, l, acc); a row with
// no visible key writes 0; the output is bf16.
//
// Bound on the card: operations. 4 S^2 D FLOPs per head (halved when
// causal) against 4 S D bf16 words: the main shape (B=1, H=32, Hkv=8,
// S=4096, D=64, causal) is 68.7 GFLOP against 12.6 MB moved, so the roof
// is the tensor cores' 989 TFLOP/s in bf16 (data sheet, 700 W): 0.0695 ms.
// Both products therefore run on the tensor cores, and nothing the block
// waits on should be a load.
//
// Design.
// - Blocks: one per (b, h, q tile of QT rows), QT in {64, 128}; each 64
//   rows are one warpgroup (128 threads), which issues its own wgmma. The
//   TPU's sequential kv grid axis becomes a loop over KT-row kv tiles,
//   KT in {64, 128}; causal blocks are issued heaviest first.
// - S = Q K^T: wgmma.m64nKTk16 with Q and K both read from shared memory
//   (K-major), D/16 k-steps. The causal, window and kv_len masks and the
//   scale are applied on the accumulator fragment's own (row, column)
//   coordinates, only on tiles that cross a mask edge; the row max and row
//   sum reduce over the 4 lanes of a quad with shuffles.
// - O += P V: P is rounded to bf16 in registers, where the S accumulator's
//   layout is already wgmma's A-operand layout, and fed from registers
//   (FlashAttention-3's reuse), with V read from shared memory N-major
//   (transposed B). P never goes through shared memory. (m, l) and O stay
//   in f32 registers; O is rescaled per kv tile.
// - Loads: TMA. Q once per block; K and V through a ring of 2-3 stages
//   (as many as fit the 227 KB a block may take), each with an mbarrier
//   that the copy completes. The tile STAGES - 1 ahead is issued by one
//   thread before the current tile's products; one __syncthreads per
//   tile frees the stage the previous tile used. Rows past S are
//   zero-filled by the copy, so q, k and v need no padding of their own.
// - Head dims: a 128-byte row (64 bf16) is the widest 128-byte-swizzle
//   box, so D splits into 64-column chunks (128-byte swizzle) and a tail of
//   16 or 32 columns (32- or 64-byte swizzle): D = 16, 32, 64, 80 (64 +
//   16, zamba2-2.7b), 128 and 256. Each chunk is its own TMA box and shared
//   tile, and its wgmma descriptors carry its own swizzle; P V runs one
//   wgmma per chunk (N = chunk width).
// - Tiles: (QT, KT) is the physical tile, compiled for every pair in
//   RT_FLASH_SM90_TILES below; the wrapper maps the tuner's logical
//   (bq, bk) to one. A logical block keeps the TPU kernel's meaning, the
//   granularity at which a kv block wholly outside the causal or window
//   mask is skipped: the visited kv tiles are those whose logical kv block
//   is not skipped for the logical q block(s) around the q tile.
// Not done here: a producer warp with setmaxnreg, two warpgroups
// ping-ponging softmax against wgmma, a TMA store of O.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// Width of column chunk c of a head dim: 64 while they last, then the tail.
__host__ __device__ constexpr int chunk_width(int d, int c) {
  return c < d / 64 ? 64 : d % 64;
}
__host__ __device__ constexpr int n_chunks(int d) {
  return d / 64 + (d % 64 ? 1 : 0);
}

template <int D, int QT, int KT>
struct Shape {
  static_assert(D % 64 == 0 || D % 64 == 16 || D % 64 == 32, "head dim");
  static_assert((QT == 64 || QT == 128) && (KT == 64 || KT == 128), "tile");
  static constexpr int kWarpgroups = QT / 64;
  static constexpr int kThreads = 128 * kWarpgroups;
  static constexpr int kQBytes = QT * D * 2;
  static constexpr int kKVBytes = KT * D * 2;  // one of K, V
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr int kStages =
      1024 + kQBytes + 3 * kStageBytes + 64 <= kSmemLimit ? 3 : 2;
  // 1024 bytes of slack to align the tiles to the 128-byte swizzle's
  // 1024-byte pattern, then Q, the ring, and the mbarriers
  static constexpr size_t kSmemBytes =
      1024 + kQBytes + kStages * kStageBytes + 8 * (kStages + 1);
  static_assert(kSmemBytes <= kSmemLimit, "shared memory");
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D(64 x 64, f32) (+)= A(64 x 16) B(16 x 64), A and B from shared memory
// (K-major), scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 128, f32) (+)= A(64 x 16) B(16 x 128), A and B from shared memory
// (K-major), scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 64, f32) += A(64 x 16, bf16 registers) B(16 x 64), B from shared
// memory stored N-major (transposed).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 32, f32) += A(64 x 16, bf16 registers) B(16 x 32), B from shared
// memory stored N-major (transposed).
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 16, f32) += A(64 x 16, bf16 registers) B(16 x 16), B from shared
// memory stored N-major (transposed).
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int KT>
__device__ __forceinline__ void wgmma_ss(float (&s)[KT / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (KT == 64) {
    wgmma_ss_n64(s, da, db, scale_d);
  } else {
    wgmma_ss_n128(s, da, db, scale_d);
  }
}

template <typename T, int D, int QT, int KT>
__global__ void __launch_bounds__(Shape<D, QT, KT>::kThreads, 1)
flash_attention_sm90_kernel(const __grid_constant__ FlashMaps maps,
                            T* __restrict__ o, int heads, int kv_heads,
                            int seq, int kv_len, int bq, int bk, int causal,
                            int window, float scale_log2) {
  static_assert(sizeof(T) == 2, "bf16 only");
  using L = Shape<D, QT, KT>;
  constexpr int kChunks = n_chunks(D);
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                      // Q: chunk c at + QT*128*c
  const uint32_t kv_s = base + L::kQBytes;        // stage: K, then V
  const uint32_t bar_s = kv_s + kStages * L::kStageBytes;  // full[], q
  const uint32_t q_bar = bar_s + 8 * kStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int q0 = static_cast<int>(gridDim.x - 1 - blockIdx.x) * QT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh_q = b * heads + h;
  const int bh_kv = b * kv_heads + h / (heads / kv_heads);

  int kt_begin;
  const int n = visited_kv_tiles<KT>(q0, QT, seq, bq, bk, causal, window,
                                     &kt_begin);

  auto load_kv = [&](int i) {  // tile kt_begin + i into its stage
    const int st = i % kStages;
    const uint32_t bar = bar_s + 8 * st;
    const uint32_t k_dst = kv_s + st * L::kStageBytes;
    const int row = (kt_begin + i) * KT;
    mbar_expect_tx(bar, L::kStageBytes);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int m = c < D / 64 ? 0 : 1;
      tma_load_3d(k_dst + KT * 128 * c, &maps.k[m], bar, 64 * c, row, bh_kv);
      tma_load_3d(k_dst + L::kKVBytes + KT * 128 * c, &maps.v[m], bar, 64 * c,
                  row, bh_kv);
    }
  };
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(bar_s + 8 * st, 1);
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_bar, L::kQBytes);
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      tma_load_3d(q_s + QT * 128 * c, &maps.q[c < D / 64 ? 0 : 1], q_bar,
                  64 * c, q0, bh_q);
    for (int i = 0; i < kStages - 1 && i < n; ++i) load_kv(i);
  }

  float o_acc[kChunks][32];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o_acc[c][i] = 0.0f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.0f, l_b = 0.0f;
  const int r_lo = q0 + 64 * wg;  // this warpgroup's first row
  const int row_a = r_lo + 16 * warp + lane / 4;  // and row_a + 8
  const int col_l = 2 * (lane % 4);
  mbar_wait(q_bar, 0);

  for (int i = 0; i < n; ++i) {
    if (i > 0) __syncthreads();  // tile i - 1 is done: its stage is free
    if (tid == 0 && i + kStages - 1 < n) load_kv(i + kStages - 1);
    const int st = i % kStages;
    mbar_wait(bar_s + 8 * st, (i / kStages) & 1);
    const int k0 = (kt_begin + i) * KT;
    if (!tile_visible<KT>(k0, r_lo, kv_len, causal, window)) continue;
    const uint32_t k_st = kv_s + st * L::kStageBytes;
    const uint32_t v_st = k_st + L::kKVBytes;

    float s[KT / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk / 4;
      const int w = chunk_width(D, c);
      const uint32_t off = (16 * kk - 64 * c) * 2;
      const uint32_t qa = q_s + QT * 128 * c + 64 * w * 2 * wg + off;
      const uint32_t ka = k_st + KT * 128 * c + off;
      if (w == 64) {
        wgmma_ss<KT>(s, smem_desc<128>(qa), smem_desc<128>(ka), kk > 0);
      } else if (w == 32) {
        wgmma_ss<KT>(s, smem_desc<64>(qa), smem_desc<64>(ka), kk > 0);
      } else {
        wgmma_ss<KT>(s, smem_desc<32>(qa), smem_desc<32>(ka), kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    const float2 alpha =
        online_softmax<KT>(s, m_a, m_b, l_a, l_b, row_a, col_l, r_lo, k0,
                           kv_len, causal, window, scale_log2);
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (8 * j >= chunk_width(D, c)) continue;
        o_acc[c][4 * j] *= alpha.x;
        o_acc[c][4 * j + 1] *= alpha.x;
        o_acc[c][4 * j + 2] *= alpha.y;
        o_acc[c][4 * j + 3] *= alpha.y;
      }
    // P in bf16: the accumulator's columns 16 kk .. 16 kk + 15 are the
    // A fragment of k-step kk
    uint32_t pa[KT / 16][4];
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int w = chunk_width(D, c);
        const uint32_t va = v_st + KT * 128 * c + 16 * kk * w * 2;
        if (w == 64) {
          wgmma_rs_n64(o_acc[c], pa[kk], smem_desc<128>(va));
        } else if (w == 32) {
          wgmma_rs_n32(o_acc[c], pa[kk], smem_desc<64>(va));
        } else {
          wgmma_rs_n16(o_acc[c], pa[kk], smem_desc<32>(va));
        }
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < kChunks; ++c) fence_regs(o_acc[c]);
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) fence_regs(pa[kk]);
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float inv_a = l_a > 0.0f ? 1.0f / l_a : 0.0f;
  const float inv_b = l_b > 0.0f ? 1.0f / l_b : 0.0f;
  T* const ob = o + static_cast<int64_t>(bh_q) * seq * D;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (8 * j >= chunk_width(D, c)) continue;
      const int col = 64 * c + 8 * j + col_l;
      if (row_a < seq)
        *reinterpret_cast<uint32_t*>(ob + static_cast<int64_t>(row_a) * D +
                                     col) =
            pack_bf16(o_acc[c][4 * j] * inv_a, o_acc[c][4 * j + 1] * inv_a);
      if (row_a + 8 < seq)
        *reinterpret_cast<uint32_t*>(ob + static_cast<int64_t>(row_a + 8) * D +
                                     col) =
            pack_bf16(o_acc[c][4 * j + 2] * inv_b, o_acc[c][4 * j + 3] * inv_b);
    }
}

template <int D, int QT, int KT>
int launch(const void* q, const void* k, const void* v, void* o,
           int64_t batch, int64_t heads, int64_t kv_heads, int64_t seq,
           int64_t kv_len, int64_t bq, int64_t bk, int causal,
           int64_t window, float sm_scale, int device, void* stream) {
  using L = Shape<D, QT, KT>;
  if (batch <= 0 || heads <= 0 || seq <= 0) return 0;
  const int checked = flash_launch_check(q, k, v, o, batch, heads, kv_heads,
                                         seq, kv_len, bq, bk, device);
  if (checked != 0) return checked;
  const int s = static_cast<int>(seq);
  FlashMaps maps;
  const int mapped = make_flash_maps(
      &maps, q, k, v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, D, 64, QT, KT, s,
      static_cast<int>(batch * heads), static_cast<int>(batch * kv_heads));
  if (mapped != 0) return mapped;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_sm90_kernel<bf16, D, QT, KT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kSmemBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>((seq + QT - 1) / QT),
                  static_cast<unsigned>(heads),
                  static_cast<unsigned>(batch));
  // a window at least as long as the sequence masks nothing
  const int win = window <= 0 || window >= seq ? 0 : static_cast<int>(window);
  flash_attention_sm90_kernel<bf16, D, QT, KT>
      <<<grid, L::kThreads, L::kSmemBytes,
         static_cast<cudaStream_t>(stream)>>>(
          maps, static_cast<bf16*>(o), static_cast<int>(heads),
          static_cast<int>(kv_heads), s, static_cast<int>(kv_len),
          static_cast<int>(bq), static_cast<int>(bk), causal, win,
          sm_scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The compiled (head dim, physical q rows, physical kv rows) table: the one
// list the launchers and the queries below are made from. The Python
// wrapper's SM90_TILES must list exactly these.
#define RT_FLASH_SM90_TILES(X)                                     \
  X(16, 64, 64) X(16, 64, 128) X(16, 128, 64) X(16, 128, 128)      \
  X(32, 64, 64) X(32, 64, 128) X(32, 128, 64) X(32, 128, 128)      \
  X(64, 64, 64) X(64, 64, 128) X(64, 128, 64) X(64, 128, 128)      \
  X(80, 64, 64) X(80, 64, 128) X(80, 128, 64) X(80, 128, 128)      \
  X(128, 64, 64) X(128, 64, 128) X(128, 128, 64) X(128, 128, 128)  \
  X(256, 64, 64) X(256, 128, 64)

// One extern "C" launcher per table entry, named
// rt_flash_attention_bf16_d<D>_q<QT>_k<KT>, with the f32 launchers'
// arguments. Each makes `device` current, builds the tensor maps,
// enqueues on `stream` and returns cudaGetLastError() (or an error of its
// own: cudaErrorMisalignedAddress for an operand not 16-byte aligned,
// 100000 + CUresult for a refused tensor map); window <= 0 means none.
#define RT_FLASH_SM90(D, QT, KT)                                            \
  extern "C" int rt_flash_attention_bf16_d##D##_q##QT##_k##KT(              \
      const void* q, const void* k, const void* v, void* o, int64_t batch,  \
      int64_t heads, int64_t kv_heads, int64_t seq, int64_t kv_len,         \
      int64_t bq, int64_t bk, int causal, int64_t window, float sm_scale,   \
      int device, void* stream) {                                           \
    return launch<D, QT, KT>(q, k, v, o, batch, heads, kv_heads, seq,       \
                             kv_len, bq, bk, causal, window, sm_scale,      \
                             device, stream);                               \
  }
RT_FLASH_SM90_TILES(RT_FLASH_SM90)

// The table as (D, QT, KT) triples into out[3 * i ..]: writes at most
// `cap` triples and returns how many the table has.
#define RT_FLASH_SM90_ROW(D, QT, KT) \
  if (n < cap) {                     \
    out[3 * n] = D;                  \
    out[3 * n + 1] = QT;             \
    out[3 * n + 2] = KT;             \
  }                                  \
  ++n;
extern "C" int rt_flash_attention_sm90_tiles(int* out, int cap) {
  int n = 0;
  RT_FLASH_SM90_TILES(RT_FLASH_SM90_ROW)
  return n;
}

// Dynamic shared memory one block of a table entry asks for, in bytes, or
// -1 for an entry outside the table.
#define RT_FLASH_SM90_SMEM(D, QT, KT)                 \
  if (d == D && qt == QT && kt == KT)                 \
    return static_cast<int64_t>(Shape<D, QT, KT>::kSmemBytes);
extern "C" int64_t rt_flash_attention_sm90_smem_bytes(int d, int qt, int kt) {
  RT_FLASH_SM90_TILES(RT_FLASH_SM90_SMEM)
  return -1;
}

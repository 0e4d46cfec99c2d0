// Flash attention forward (online softmax), float32 at head dim 256, on
// Hopper's tensor cores: every product as three TF32 products (3xTF32) on
// wgmma, with Q fed to S = Q K^T from registers.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py:33,
// _attn_kernel / flash_attention_pallas, for float32 operands at head dim
// 256 (gemma-2b; with the padding of ops.flash_attention, which the Python
// wrapper keeps). f32 at head dims up to 128 takes
// flash_attention_tf32x3.cu, bf16 flash_attention_sm90.cu. It replaces the
// CUDA-core design of flash_attention.cu at D = 256 (f32 FMAs from shared
// memory), which stays compiled and is timed beside it.
//
// Computes, per (batch, query head), o = softmax(q k^T * sm_scale + mask) v
// over (S, 256) tiles: GQA (query head h reads kv head h / (H / Hkv)), a
// causal mask, a sliding window (q - k < window), keys at or past kv_len
// masked (the wrapper's zero padding); f32 running (m, l, O); a row with
// no visible key writes 0; the output is f32.
//
// Bound on the card: operations. 4 S^2 D FLOPs per head (halved when
// causal) against 4 S D f32 words: gemma-2b's widths (B=1, H=8, Hkv=1,
// S=4096, D=256, causal) are 68.72 GFLOP against 83.9 MB moved (0.025 ms
// at 3.35 TB/s). An f32-accurate product costs three TF32 products, so the
// roof is 495 / 3 = 165 TFLOP/s (data sheet, 700 W): 0.4165 ms, against
// 1.0257 ms at the CUDA cores' 67 TFLOP/s.
//
// Accuracy, as flash_attention_tf32x3.cu: each operand is split as a =
// a_hi + a_lo (hi rounded to TF32, lo exact) and a b ~ a_lo b_hi + a_hi b_lo
// + a_hi b_hi. S = Q K^T runs the two small products over the whole head
// dim first, then hi.hi; the P V product of every kv tile gets a fresh
// accumulator, which the CUDA cores add into the running O after its
// rescale, rounded to nearest (the tensor cores truncate as they add).
//
// Design. What does not fit: flash_attention_tf32x3.cu keeps Q's hi and lo
// copies in shared memory; at D = 256 they are 128 KB for 64 rows, beside
// a split kv stage of 128 KB (QT = 64, KT = 32), over the 227 KB a block
// may take.
// - Q from registers. Each consumer thread loads, once, the four Q elements
//   of each of its k steps' m64k8 A fragments (rows g and g + 8, columns t
//   and t + 4, g = lane / 4, t = lane % 4; PTX ISA, wgmma .tf32 register
//   fragment of A) straight from global memory into a thread-private,
//   conflict-free slot of shared memory, raw: 64 KB per 64 rows. At each
//   k step it reads its float4, splits it into hi and lo in registers and
//   issues wgmma.m64nKTk8 with A from registers. An A register may not
//   change until the wgmma that reads it is done, so the fragments go
//   through two register buffers, each k step one wgmma group, with
//   wgmma.wait_group 1 before a buffer is refilled.
// - K (K-major) and V^T are split into hi and lo in shared memory by a
//   producer warpgroup, through one raw TMA staging buffer of KT rows that
//   takes K and then V of each kv tile (128-byte swizzle, 32-column chunks
//   as in flash_attention_tf32x3.cu). K's split stage and V^T's split stage
//   each have their own full and empty mbarriers, so K of the next tile is
//   split while the consumers still run P V of this one. V is transposed
//   into V^T (rows d, KT kv to a row: 128-byte swizzle at KT = 32, 64-byte
//   at KT = 16) with its rows permuted as P's A fragment wants (see
//   flash_attention_tf32x3.cu: a thread's accumulator pair (2t, 2t + 1) is
//   A's k = t and t + 4).
// - O (64 x 256 f32 a warpgroup) is 128 registers a thread. P V runs in
//   four 64-column chunks of the head dim, each into a fresh 32-register
//   accumulator that is added into O before the next chunk.
// - Tiles: (QT, KT) is the physical tile. Two designs fit: (64, 32), one
//   consumer warpgroup (design a), and (128, 16), two consumers that take
//   turns at the tensor cores (named barriers: S of one, S of the other,
//   P V of one, P V of the other), the producer keeping 56 registers a
//   thread and the consumers the rest (setmaxnreg) (design b). Shared
//   memory a block: 1024 bytes of alignment slack, Q's fragments (QT / 64
//   x 64 KB), K hi and lo, V^T hi and lo, the raw buffer (5 KT KB), the
//   mbarriers: 230,440 bytes at (64, 32), 214,056 at (128, 16).
//   bench/flash_probe.py --head-dim 256 compiles both: (a) ran at 1.3 ms
//   on an H100 at gemma-2b's widths, (b) at 2.3 ms (its S products are
//   N = 16 wide), so RT_FLASH_TF32X3_D256_TILES below ships (a) alone. The
//   logical (bq, bk) keeps the TPU kernel's meaning, the granularity at
//   which a kv block wholly outside the causal or window mask is skipped;
//   causal blocks are issued heaviest first.
// The probe also times edited copies of this file (PERF.md). Not done: a
// persistent grid, a TMA store of O, a second register buffer of P V's
// accumulator (a thread has 254 of its 255 registers in use).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"


namespace {

constexpr int kD = 256;  // the head dim this kernel takes

template <int QT, int KT>
struct Shape {
  static_assert((QT == 64 && KT == 32) || (QT == 128 && KT == 16), "tile");
  static constexpr int kConsumers = QT / 64;   // consumer warpgroups
  static constexpr int kProducerThreads = 128;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  // registers a thread: with setmaxnreg (384 threads), the producer's and
  // a consumer's share of the 65,536
  static constexpr bool kSetRegs = kThreads > 256;
  static constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
  static constexpr int kProducerRegs = 56;
  static constexpr int kConsumerShare =
      (kLaunchRegs * kThreads - kProducerRegs * kProducerThreads) /
      (128 * kConsumers) / 8 * 8;
  static constexpr int kConsumerRegs =
      kConsumerShare > 256 ? 256 : kConsumerShare;
  static constexpr int kQBytes = 64 * kD * 4;   // one consumer's fragments
  static constexpr int kKVBytes = KT * kD * 4;  // one KT x 256 f32 tile
  static constexpr int kVtRowBytes = KT * 4;    // V^T's rows: 128 or 64
  // byte offsets from the 1024-aligned base
  static constexpr int kQ = 0;
  static constexpr int kKHi = kQ + kConsumers * kQBytes;
  static constexpr int kKLo = kKHi + kKVBytes;
  static constexpr int kVtHi = kKLo + kKVBytes;
  static constexpr int kVtLo = kVtHi + kKVBytes;
  static constexpr int kRaw = kVtLo + kKVBytes;
  // mbarriers: the raw buffer landed; K's and V^T's stages full and empty
  static constexpr int kRawBar = kRaw + kKVBytes;
  static constexpr int kFullK = kRawBar + 8;
  static constexpr int kFullV = kFullK + 8;
  static constexpr int kEmptyK = kFullV + 8;
  static constexpr int kEmptyV = kEmptyK + 8;
  static constexpr size_t kSmemBytes = 1024 + kEmptyV + 8;
  static_assert(kSmemBytes <= kSmemLimit, "shared memory");
  // each producer thread's float4s of one tile (K's split, V's transpose)
  static constexpr int kProducerIters = KT * kD / 4 / kProducerThreads;
};

template <int QT, int KT>
__global__ void __launch_bounds__(Shape<QT, KT>::kThreads, 1)
flash_attention_tf32x3_d256_kernel(const __grid_constant__ FlashMaps maps,
                                   const float* __restrict__ q,
                                   float* __restrict__ o, int heads,
                                   int kv_heads, int seq, int kv_len, int bq,
                                   int bk, int causal, int window,
                                   float scale_log2) {
  using L = Shape<QT, KT>;
  constexpr int D = kD;
  constexpr int kSteps = D / 8;  // k steps of S = Q K^T
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const sp = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t raw_bar = base + L::kRawBar;
  const uint32_t full_k = base + L::kFullK;
  const uint32_t full_v = base + L::kFullV;
  const uint32_t empty_k = base + L::kEmptyK;
  const uint32_t empty_v = base + L::kEmptyV;

  const int tid = threadIdx.x;
  // 0: the producer; 1 ..: consumers. Broadcast from lane 0 so that the
  // compiler sees it warp-uniform: a wgmma on a path it takes to diverge
  // is serialized (ptxas C7520).
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int q0 = static_cast<int>(gridDim.x - 1 - blockIdx.x) * QT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh_q = b * heads + h;
  const int bh_kv = b * kv_heads + h / (heads / kv_heads);

  int kt_begin;
  const int n = visited_kv_tiles<KT>(q0, QT, seq, bq, bk, causal, window,
                                     &kt_begin);

  if (tid == 0) {
    mbar_init(raw_bar, 1);
    mbar_init(full_k, L::kProducerThreads);
    mbar_init(full_v, L::kProducerThreads);
    mbar_init(empty_k, 128 * L::kConsumers);
    mbar_init(empty_v, 128 * L::kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // The producer: per kv tile, K into hi and lo, then V transposed into
    // hi and lo, each through the raw buffer, each stage once the
    // consumers are done with the previous tile's.
    if constexpr (L::kSetRegs) set_max_regs_dec<L::kProducerRegs>();
    auto load = [&](const CUtensorMap* map, int i) {  // tile kt_begin + i
      mbar_expect_tx(raw_bar, L::kKVBytes);
#pragma unroll
      for (int c = 0; c < D / 32; ++c)
        tma_load_3d(base + L::kRaw + KT * 128 * c, map, raw_bar, 32 * c,
                    (kt_begin + i) * KT, bh_kv);
    };
    if (tid == 0 && n > 0) load(&maps.k[0], 0);
    for (int i = 0; i < n; ++i) {
      mbar_wait(raw_bar, 0);
      if (i > 0) mbar_wait(empty_k, (i - 1) & 1);
      // K: hi and lo at the raw tile's (swizzled) places
#pragma unroll
      for (int it = 0; it < L::kProducerIters; ++it) {
        const int idx = tid + L::kProducerThreads * it;
        uint4 hi, lo;
        split_tf32(*reinterpret_cast<const float4*>(sp + L::kRaw + 16 * idx),
                   hi, lo);
        *reinterpret_cast<uint4*>(sp + L::kKHi + 16 * idx) = hi;
        *reinterpret_cast<uint4*>(sp + L::kKLo + 16 * idx) = lo;
      }
      fence_async_smem();  // the wgmma reads them through the async proxy
      // every producer thread is done with the raw tile
      producer_sync<L::kProducerThreads>();
      if (tid == 0) load(&maps.v[0], i);
      mbar_arrive(full_k);
      mbar_wait(raw_bar, 1);
      if (i > 0) mbar_wait(empty_v, (i - 1) & 1);
      // V^T: kv row r, columns 4u .. 4u + 3 of V go to rows 4u .. 4u + 3
      // of V^T, at r's place in its group of 8 permuted as the A fragment
      // of P wants. A warp reads rows of one 16-byte column (conflict-free
      // under the swizzle) and writes columns of one or two rows.
#pragma unroll
      for (int it = 0; it < L::kProducerIters; ++it) {
        const int idx = tid + L::kProducerThreads * it;
        const int r = idx % KT;
        const int u = idx / KT;
        const uint32_t src =
            KT * 128 * (u / 8) + swizzled<128>(r, 16 * (u % 8));
        uint4 hi, lo;
        split_tf32(*reinterpret_cast<const float4*>(sp + L::kRaw + src), hi,
                   lo);
        const int pos = (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2);
        const uint32_t e0 = swizzled<L::kVtRowBytes>(4 * u, 4 * pos);
        const uint32_t e1 = swizzled<L::kVtRowBytes>(4 * u + 1, 4 * pos);
        const uint32_t e2 = swizzled<L::kVtRowBytes>(4 * u + 2, 4 * pos);
        const uint32_t e3 = swizzled<L::kVtRowBytes>(4 * u + 3, 4 * pos);
        *reinterpret_cast<uint32_t*>(sp + L::kVtHi + e0) = hi.x;
        *reinterpret_cast<uint32_t*>(sp + L::kVtHi + e1) = hi.y;
        *reinterpret_cast<uint32_t*>(sp + L::kVtHi + e2) = hi.z;
        *reinterpret_cast<uint32_t*>(sp + L::kVtHi + e3) = hi.w;
        *reinterpret_cast<uint32_t*>(sp + L::kVtLo + e0) = lo.x;
        *reinterpret_cast<uint32_t*>(sp + L::kVtLo + e1) = lo.y;
        *reinterpret_cast<uint32_t*>(sp + L::kVtLo + e2) = lo.z;
        *reinterpret_cast<uint32_t*>(sp + L::kVtLo + e3) = lo.w;
      }
      fence_async_smem();
      producer_sync<L::kProducerThreads>();
      if (tid == 0 && i + 1 < n) load(&maps.k[0], i + 1);
      mbar_arrive(full_v);
    }
    return;
  }

  // A consumer warpgroup: 64 q rows, the products and the online softmax.
  if constexpr (L::kSetRegs) set_max_regs_inc<L::kConsumerRegs>();
  const int w = wg - 1;  // this consumer's index
  const int tq = tid % 128;
  const int warp = tq / 32;
  const int lane = tid % 32;
  const int r_lo = q0 + 64 * w;  // this warpgroup's first row
  const int row_a = r_lo + 16 * warp + lane / 4;  // and row_a + 8
  const int col_l = 2 * (lane % 4);

  // This thread's Q fragments, raw: k step kk's (row_a, kk 8 + t),
  // (row_a + 8, kk 8 + t), (row_a, kk 8 + t + 4), (row_a + 8, kk 8 + t + 4),
  // A's registers a0 .. a3, as one float4 at slot kk * 128 + tq.
  unsigned char* const q_frag = sp + L::kQ + w * L::kQBytes;
  {
    const float* const qa =
        q + (static_cast<int64_t>(bh_q) * seq + row_a) * D + lane % 4;
    const bool in_a = row_a < seq, in_b = row_a + 8 < seq;
#pragma unroll 8
    for (int kk = 0; kk < kSteps; ++kk) {
      float4 f;
      f.x = in_a ? qa[8 * kk] : 0.0f;
      f.y = in_b ? qa[8 * D + 8 * kk] : 0.0f;
      f.z = in_a ? qa[8 * kk + 4] : 0.0f;
      f.w = in_b ? qa[8 * D + 8 * kk + 4] : 0.0f;
      *reinterpret_cast<float4*>(q_frag + 16 * (kk * 128 + tq)) = f;
    }
  }
  auto q_at = [&](int kk) {
    return *reinterpret_cast<const float4*>(q_frag + 16 * (kk * 128 + tq));
  };

  float o_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.0f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.0f, l_b = 0.0f;
  // Two consumers take turns at the tensor cores, S then P V each, so that
  // one's softmax runs while the other's products do; warpgroup 0 first.
  constexpr bool kPingPong = L::kConsumers > 1;
  if (kPingPong && w == 1) turn_pass(w);
  // descriptors of the [0] hi and [1] lo tiles of K and V^T; a k step (or
  // K's 32-column chunk, V^T's 64-row chunk) adds its bytes (desc_add)
  const uint64_t k_desc[2] = {smem_desc<128>(base + L::kKHi),
                              smem_desc<128>(base + L::kKLo)};
  const uint64_t v_desc[2] = {smem_desc<L::kVtRowBytes>(base + L::kVtHi),
                              smem_desc<L::kVtRowBytes>(base + L::kVtLo)};
  // S's first k step: 0 runs the small products over the head dim first
  constexpr int kFirstStep = 0;
  // Q's register buffers: the wgmma groups of S in flight at once (4, 6
  // and 8 measured within 3% of 2 on an H100, PERF.md)
  constexpr int kQBufs = 2;
  // P V's first product: 0 is lo.hi, then hi.lo and hi.hi
  constexpr int kFirstPart = 0;

  for (int i = 0; i < n; ++i) {
    const int k0 = (kt_begin + i) * KT;
    mbar_wait(full_k, i & 1);
    if (!tile_visible<KT>(k0, r_lo, kv_len, causal, window)) {
      if (kPingPong) {  // both turns all the same, to keep them paired
        turn_wait(w);
        turn_pass(w);
        turn_wait(w);
        turn_pass(w);
      }
      mbar_arrive(empty_k);
      mbar_wait(full_v, i & 1);  // one phase at a time on each barrier
      mbar_arrive(empty_v);
      continue;
    }

    // S = Q K^T: k steps g < kSteps issue lo.hi and hi.lo, the rest hi.hi
    // (k step g - kSteps); each step one wgmma group on its own buffer.
    float s[KT / 2];
    uint32_t a_hi[kQBufs][4], a_lo[kQBufs][4];
    float4 qn = q_at(kFirstStep % kSteps);
    if (kPingPong) turn_wait(w);
#pragma unroll
    for (int g = kFirstStep; g < 2 * kSteps; ++g) {
      const int kk = g % kSteps;
      const int buf = g % kQBufs;
      // step g - kQBufs read buf
      if (g >= kFirstStep + kQBufs) wgmma_wait<kQBufs - 1>();
      split_tf32(qn.x, a_hi[buf][0], a_lo[buf][0]);
      split_tf32(qn.y, a_hi[buf][1], a_lo[buf][1]);
      split_tf32(qn.z, a_hi[buf][2], a_lo[buf][2]);
      split_tf32(qn.w, a_hi[buf][3], a_lo[buf][3]);
      if (g + 1 < 2 * kSteps) qn = q_at((g + 1) % kSteps);
      const uint32_t off = KT * 128 * (kk / 4) + 32 * (kk % 4);
      wgmma_fence();
      if (g < kSteps) {
        wgmma_rs<KT>(s, a_lo[buf], desc_add(k_desc[0], off),
                     g > kFirstStep);
        wgmma_rs<KT>(s, a_hi[buf], desc_add(k_desc[1], off), 1);
      } else {
        wgmma_rs<KT>(s, a_hi[buf], desc_add(k_desc[0], off),
                     g > kFirstStep);
      }
      wgmma_commit();
    }
    if (kPingPong) turn_pass(w);
    wgmma_wait<0>();
    fence_regs(s);
#pragma unroll
    for (int j = 0; j < kQBufs; ++j) {
      fence_regs(a_hi[j]);
      fence_regs(a_lo[j]);
    }
    mbar_arrive(empty_k);  // K's stage is free again

    const float2 alpha =
        online_softmax<KT>(s, m_a, m_b, l_a, l_b, row_a, col_l, r_lo, k0,
                           kv_len, causal, window, scale_log2);

    // P in hi and lo: the accumulator's (g, 2t), (g, 2t + 1), (g + 8, 2t),
    // (g + 8, 2t + 1) of k step kk are A's (g, t), (g, t + 4), (g + 8, t),
    // (g + 8, t + 4), whose registers are a0, a2, a1, a3
    uint32_t p_hi[KT / 8][4], p_lo[KT / 8][4];
#pragma unroll
    for (int kk = 0; kk < KT / 8; ++kk) {
      split_tf32(s[4 * kk], p_hi[kk][0], p_lo[kk][0]);
      split_tf32(s[4 * kk + 2], p_hi[kk][1], p_lo[kk][1]);
      split_tf32(s[4 * kk + 1], p_hi[kk][2], p_lo[kk][2]);
      split_tf32(s[4 * kk + 3], p_hi[kk][3], p_lo[kk][3]);
    }

    // this tile's P V, 64 head-dim columns at a time, each in a fresh
    // accumulator added into O: lo.hi, hi.lo, then hi.hi
    mbar_wait(full_v, i & 1);
    if (kPingPong) turn_wait(w);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      float o_tile[32];
      wgmma_fence();
#pragma unroll
      for (int part = kFirstPart; part < 3; ++part)
#pragma unroll
        for (int kk = 0; kk < KT / 8; ++kk)
          wgmma_rs<64>(o_tile, part == 0 ? p_lo[kk] : p_hi[kk],
                       desc_add(v_desc[part == 1],
                                64 * L::kVtRowBytes * c + 32 * kk),
                       part > kFirstPart || kk > 0);
      wgmma_commit();
      if (kPingPong && c == D / 64 - 1) turn_pass(w);
      wgmma_wait<0>();
      fence_regs(o_tile);
#pragma unroll
      for (int j = 0; j < 32; j += 4) {
        const int e = 32 * c + j;
        o_acc[e] = fmaf(o_acc[e], alpha.x, o_tile[j]);
        o_acc[e + 1] = fmaf(o_acc[e + 1], alpha.x, o_tile[j + 1]);
        o_acc[e + 2] = fmaf(o_acc[e + 2], alpha.y, o_tile[j + 2]);
        o_acc[e + 3] = fmaf(o_acc[e + 3], alpha.y, o_tile[j + 3]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < KT / 8; ++kk) {
      fence_regs(p_hi[kk]);
      fence_regs(p_lo[kk]);
    }
    mbar_arrive(empty_v);  // V^T's stage is free again
  }

  if (kPingPong && w == 0) turn_wait(w);  // the other's last pass

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float inv_a = l_a > 0.0f ? 1.0f / l_a : 0.0f;
  const float inv_b = l_b > 0.0f ? 1.0f / l_b : 0.0f;
  float* const ob = o + static_cast<int64_t>(bh_q) * seq * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + col_l;
    if (row_a < seq)
      *reinterpret_cast<float2*>(ob + static_cast<int64_t>(row_a) * D + col) =
          make_float2(o_acc[4 * j] * inv_a, o_acc[4 * j + 1] * inv_a);
    if (row_a + 8 < seq)
      *reinterpret_cast<float2*>(ob + static_cast<int64_t>(row_a + 8) * D +
                                 col) =
          make_float2(o_acc[4 * j + 2] * inv_b, o_acc[4 * j + 3] * inv_b);
  }
}

template <int QT, int KT>
int launch(const void* q, const void* k, const void* v, void* o,
           int64_t batch, int64_t heads, int64_t kv_heads, int64_t seq,
           int64_t kv_len, int64_t bq, int64_t bk, int causal,
           int64_t window, float sm_scale, int device, void* stream) {
  using L = Shape<QT, KT>;
  if (batch <= 0 || heads <= 0 || seq <= 0) return 0;
  const int checked = flash_launch_check(q, k, v, o, batch, heads, kv_heads,
                                         seq, kv_len, bq, bk, device);
  if (checked != 0) return checked;
  const int s = static_cast<int>(seq);
  FlashMaps maps;
  const int mapped = make_flash_maps(
      &maps, q, k, v, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, kD, 32, QT, KT, s,
      static_cast<int>(batch * heads), static_cast<int>(batch * kv_heads));
  if (mapped != 0) return mapped;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_tf32x3_d256_kernel<QT, KT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kSmemBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>((seq + QT - 1) / QT),
                  static_cast<unsigned>(heads),
                  static_cast<unsigned>(batch));
  // a window at least as long as the sequence masks nothing
  const int win = window <= 0 || window >= seq ? 0 : static_cast<int>(window);
  flash_attention_tf32x3_d256_kernel<QT, KT>
      <<<grid, L::kThreads, L::kSmemBytes,
         static_cast<cudaStream_t>(stream)>>>(
          maps, static_cast<const float*>(q), static_cast<float*>(o),
          static_cast<int>(heads), static_cast<int>(kv_heads), s,
          static_cast<int>(kv_len), static_cast<int>(bq),
          static_cast<int>(bk), causal, win, sm_scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The compiled (head dim, physical q rows, physical kv rows) table: the one
// list the launchers and the queries below are made from. The Python
// wrapper's TF32X3_D256_TILES must list exactly these. Design (b),
// X(256, 128, 16), is compiled by bench/flash_probe.py alone.
#define RT_FLASH_TF32X3_D256_TILES(X) X(256, 64, 32)

// One extern "C" launcher per table entry, named
// rt_flash_attention_tf32x3_d256_q<QT>_k<KT>, with the other flash
// launchers' arguments. Each makes `device` current, builds the tensor
// maps, enqueues on `stream` and returns cudaGetLastError() (or an error
// of its own: cudaErrorMisalignedAddress for an operand not 16-byte
// aligned, 100000 + CUresult for a refused tensor map); window <= 0 means
// none.
#define RT_FLASH_TF32X3_D256(D, QT, KT)                                     \
  extern "C" int rt_flash_attention_tf32x3_d##D##_q##QT##_k##KT(            \
      const void* q, const void* k, const void* v, void* o, int64_t batch,  \
      int64_t heads, int64_t kv_heads, int64_t seq, int64_t kv_len,         \
      int64_t bq, int64_t bk, int causal, int64_t window, float sm_scale,   \
      int device, void* stream) {                                           \
    return launch<QT, KT>(q, k, v, o, batch, heads, kv_heads, seq, kv_len,  \
                          bq, bk, causal, window, sm_scale, device, stream); \
  }
RT_FLASH_TF32X3_D256_TILES(RT_FLASH_TF32X3_D256)

// The table as (D, QT, KT) triples into out[3 * i ..]: writes at most
// `cap` triples and returns how many the table has.
#define RT_FLASH_TF32X3_D256_ROW(D, QT, KT) \
  if (n < cap) {                            \
    out[3 * n] = D;                         \
    out[3 * n + 1] = QT;                    \
    out[3 * n + 2] = KT;                    \
  }                                         \
  ++n;
extern "C" int rt_flash_attention_tf32x3_d256_tiles(int* out, int cap) {
  int n = 0;
  RT_FLASH_TF32X3_D256_TILES(RT_FLASH_TF32X3_D256_ROW)
  return n;
}

// Dynamic shared memory one block of a table entry asks for, in bytes, or
// -1 for an entry outside the table.
#define RT_FLASH_TF32X3_D256_SMEM(D, QT, KT)          \
  if (d == D && qt == QT && kt == KT)                 \
    return static_cast<int64_t>(Shape<QT, KT>::kSmemBytes);
extern "C" int64_t rt_flash_attention_tf32x3_d256_smem_bytes(int d, int qt,
                                                             int kt) {
  RT_FLASH_TF32X3_D256_TILES(RT_FLASH_TF32X3_D256_SMEM)
  return -1;
}

// Flash attention forward (online softmax), float32, on Hopper's tensor
// cores: every product as three TF32 products (3xTF32) on wgmma.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py:33,
// _attn_kernel / flash_attention_pallas, for float32 operands at head dims
// 16, 32, 64, 80 and 128 (with the padding of ops.flash_attention, which
// the Python wrapper keeps). bf16 operands take flash_attention_sm90.cu;
// f32 at D = 256 takes flash_attention_tf32x3_d256.cu, which feeds Q from
// registers (Q's hi/lo copies would not fit a block's shared memory).
//
// Computes, per (batch, query head), o = softmax(q k^T * sm_scale + mask) v
// over (S, D) tiles: GQA (query head h reads kv head h / (H / Hkv)), a
// causal mask, a sliding window (q - k < window), keys at or past kv_len
// masked (the wrapper's zero padding); f32 running (m, l, O); a row with
// no visible key writes 0; the output is f32.
//
// Bound on the card: operations. 4 S^2 D FLOPs per head (halved when
// causal) against 4 S D f32 words: the main shape (B=1, H=32, Hkv=8,
// S=4096, D=64, causal) is 68.72 GFLOP against 83.9 MB moved (0.025 ms at
// 3.35 TB/s). An f32-accurate product from the TF32 tensor cores costs
// three TF32 products, so the roof is 495 / 3 = 165 TFLOP/s (data sheet,
// 700 W): 0.4165 ms, against 1.0257 ms at the CUDA cores' 67 TFLOP/s,
// which bound the design this one replaces (f32 FMAs from shared memory).
//
// Accuracy. Each operand is split as a = a_hi + a_lo, a_hi rounded to TF32
// and a_lo = a - a_hi exact (split_tf32), and a b ~ a_lo b_hi + a_hi b_lo
// + a_hi b_hi: about 22 of f32's 24 bits a product, the dropped a_lo b_lo
// below 2^-22 of it. The small products go into each accumulator first.
// The tensor cores truncate as they add, so the P V product of every kv
// tile gets a fresh accumulator, which the CUDA cores add into the running
// O after its rescale, rounded to nearest; S = Q K^T (D / 8 k steps of
// three products) is one chain.
//
// Design.
// - Blocks: one per (b, h, q tile of QT rows), QT in {64, 128}, of one
//   producer warpgroup and QT / 64 consumer warpgroups (128 threads each).
//   The TPU's sequential kv grid axis becomes a loop over KT-row kv tiles,
//   KT in {32, 64}; causal blocks are issued heaviest first.
// - Operands: for .tf32, wgmma reads both shared-memory operands K-major
//   only (the transpose bits exist for 16-bit types alone). Q (q, d) and
//   K (kv, d) are K-major for S = Q K^T as they land. V (kv, d) is not for
//   O = P V, so V's tile is written transposed, (d, kv). A 128-byte
//   swizzle row holds 32 floats, so D splits into 32-column chunks plus a
//   16-column tail (64-byte swizzle): D = 80 is 32 + 32 + 16.
// - The producer: TMA copies Q once and each kv tile's K and V into a raw
//   staging buffer (an mbarrier completes each copy). It splits Q in place
//   (hi over the raw tile, lo beside it), and each kv tile into a ring of
//   split stages (two where they fit, else one): K's hi and lo at the raw
//   tile's swizzled places, and V transposed into hi and lo tiles (V^T's
//   rows are d, 32 kv to a 128-byte swizzle row). Then it issues the next
//   tile's copy into the staging buffer and marks the stage full. Its
//   loops are unrolled so that each thread's loads are in flight together:
//   the split is on the critical path otherwise. With two consumers it
//   keeps 72 registers a thread and gives the rest to them (setmaxnreg).
// - The consumers: each warpgroup owns 64 q rows and walks the full
//   stages, releasing each when its products are done. S = Q K^T is
//   wgmma.m64nKTk8 from shared memory, 3 D / 8 products. Masks and the
//   online softmax run on the accumulator fragment's own (row, column)
//   coordinates, as in flash_attention_sm90.cu. With two consumers, named
//   barriers make them take turns at the tensor cores (S of one, S of the
//   other, P V of one, P V of the other), so one's softmax runs while the
//   other's products do. No block-wide barrier runs in the kv loop.
// - O += P V: P is split into hi and lo in registers and fed as wgmma's
//   register A operand. The f32 accumulator gives a thread columns
//   (2t, 2t + 1) of each 8-column group, where the TF32 A fragment holds
//   k = (t, t + 4) (PTX ISA, wgmma m64nNk8 .tf32 register fragment of A:
//   rows g and g + 8, columns t and t + 4, g = lane / 4, t = lane % 4), so
//   a thread's pair is fed as A's k = t and t + 4: A's k index kappa takes
//   the kv column pi(kappa) = 2 kappa (kappa < 4), 2 (kappa - 4) + 1
//   (kappa >= 4) of its group of 8. The same permutation is applied to V's
//   rows as they are transposed, so no shuffle is needed. One wgmma
//   m64nDk8 a product (D = 80: 64 + 16).
// - Tiles: (QT, KT) is the physical tile, compiled for every entry of
//   RT_FLASH_TF32X3_TILES below; the wrapper maps the tuner's logical
//   (bq, bk) to one. A logical block keeps the TPU kernel's meaning, the
//   granularity at which a kv block wholly outside the causal or window
//   mask is skipped. Shared memory a block: 1024 bytes of alignment slack,
//   Q hi and lo (2 QT D floats), the raw K and V (2 KT D), each split stage
//   (4 KT D), the mbarriers: 230,464 bytes at D = 64, QT = 128, KT = 64
//   (two stages); D = 128 takes KT = 32.
// What holds it back, and what is not done here: bench/flash_probe.py
// measures edited copies of this file beside it (PERF.md). Not done: Q
// from registers (its hi and lo fragments would take 64 registers a
// thread at D = 64), a persistent grid, a TMA store of O.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"


namespace {

// Width of column chunk c of a head dim, in floats: 32 (one 128-byte
// swizzle row) while they last, then the 16-column tail.
__host__ __device__ constexpr int chunk_width(int d, int c) {
  return c < d / 32 ? 32 : d % 32;
}
__host__ __device__ constexpr int n_chunks(int d) {
  return d / 32 + (d % 32 ? 1 : 0);
}

template <int D, int QT, int KT>
struct Shape {
  static_assert((D % 32 == 0 || D % 32 == 16) && D <= 128, "head dim");
  static_assert((QT == 64 || QT == 128) && (KT == 32 || KT == 64), "tile");
  static constexpr int kConsumers = QT / 64;   // consumer warpgroups
  // producer warpgroups (bench/flash_probe.py also times 2)
  static constexpr int kProducers = 1;
  static constexpr int kProducerThreads = 128 * kProducers;
  static constexpr int kThreads = 128 * (kConsumers + kProducers);
  static_assert(QT * D / 4 % kProducerThreads == 0 &&
                KT * D / 4 % kProducerThreads == 0, "producer shares");
  // registers a thread: the launch's share of the 65,536, and with
  // setmaxnreg (384 threads and more) the producer's and a consumer's
  static constexpr bool kSetRegs = kThreads > 256;
  static constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
  static constexpr int kProducerRegs = kProducers > 1 ? 56 : 72;
  static constexpr int kConsumerShare =
      (kLaunchRegs * kThreads - kProducerRegs * kProducerThreads) /
      (128 * kConsumers) / 8 * 8;
  static constexpr int kConsumerRegs =
      kConsumerShare > 256 ? 256 : kConsumerShare;
  static constexpr int kQBytes = QT * D * 4;   // one of Q hi, Q lo
  static constexpr int kKVBytes = KT * D * 4;  // one of K, V, raw or split
  static constexpr int kSplitBytes = 4 * kKVBytes;  // K hi, lo, V^T hi, lo
  // two split stages where they fit the 227 KB a block may take, else one
  static constexpr int kStages =
      1024 + 2 * kQBytes + 2 * kKVBytes + 2 * kSplitBytes + 64 <= kSmemLimit
          ? 2 : 1;
  // byte offsets from the 1024-aligned base: Q hi (where Q lands) and lo,
  // the raw K and V, the split stages (each K hi, K lo, V^T hi, V^T lo),
  // then the mbarriers
  static constexpr int kQHi = 0;
  static constexpr int kQLo = kQHi + kQBytes;
  static constexpr int kRawK = kQLo + kQBytes;
  static constexpr int kRawV = kRawK + kKVBytes;
  static constexpr int kSplit = kRawV + kKVBytes;
  static constexpr int kKHi = 0;                // within a split stage
  static constexpr int kKLo = kKVBytes;
  static constexpr int kVtHi = 2 * kKVBytes;
  static constexpr int kVtLo = 3 * kKVBytes;
  // mbarriers: Q landed, Q split, raw K/V landed, each stage full and empty
  static constexpr int kQBar = kSplit + kStages * kSplitBytes;
  static constexpr int kQReadyBar = kQBar + 8;
  static constexpr int kRawBar = kQReadyBar + 8;
  static constexpr int kFullBar = kRawBar + 8;
  static constexpr int kEmptyBar = kFullBar + 8 * kStages;
  static constexpr size_t kSmemBytes = 1024 + kEmptyBar + 8 * kStages;
  static_assert(kSmemBytes <= kSmemLimit, "shared memory");
  static_assert(kKVBytes % 1024 == 0, "tiles on the swizzle's 1024 bytes");
};

// A shared-memory tile's wgmma descriptor, its rows kRowBytes wide (32
// floats: 128, the 16-float tail: 64).
template <int D>
__device__ __forceinline__ uint64_t chunk_desc(int c, uint32_t addr) {
  return chunk_width(D, c) == 32 ? smem_desc<128>(addr) : smem_desc<64>(addr);
}

// O(64 x D) (+)= A(64 x 8, TF32 registers) B, V^T's k step at descriptor
// dv: one wgmma of N = D, or 64 + 16 at D = 80.
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t dv,
                                         int scale_d) {
  if constexpr (D == 80) {
    wgmma_rs<64>(o, a, dv, scale_d);
    wgmma_rs<16>(o + 32, a, desc_add(dv, 64 * 128), scale_d);
  } else {
    wgmma_rs<D>(o, a, dv, scale_d);
  }
}

template <int D, int QT, int KT>
__global__ void __launch_bounds__(Shape<D, QT, KT>::kThreads, 1)
flash_attention_tf32x3_kernel(const __grid_constant__ FlashMaps maps,
                              float* __restrict__ o, int heads, int kv_heads,
                              int seq, int kv_len, int bq, int bk, int causal,
                              int window, float scale_log2) {
  using L = Shape<D, QT, KT>;
  constexpr int kChunks = n_chunks(D);
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const sp = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t q_bar = base + L::kQBar;
  const uint32_t q_ready = base + L::kQReadyBar;
  const uint32_t raw_bar = base + L::kRawBar;
  const uint32_t full_bar = base + L::kFullBar;    // + 8 * stage
  const uint32_t empty_bar = base + L::kEmptyBar;  // + 8 * stage

  const int tid = threadIdx.x;
  const int wg = tid / 128;  // 0: the producer; 1 ..: consumers
  const int q0 = static_cast<int>(gridDim.x - 1 - blockIdx.x) * QT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh_q = b * heads + h;
  const int bh_kv = b * kv_heads + h / (heads / kv_heads);

  int kt_begin;
  const int n = visited_kv_tiles<KT>(q0, QT, seq, bq, bk, causal, window,
                                     &kt_begin);

  if (tid == 0) {
    mbar_init(q_bar, 1);
    mbar_init(q_ready, L::kProducerThreads);
    mbar_init(raw_bar, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_bar + 8 * st, L::kProducerThreads);
      mbar_init(empty_bar + 8 * st, 128 * L::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg < L::kProducers) {
    // The producer: loads and splits. Q once; then per kv tile, K into hi
    // and lo and V transposed into hi and lo, into the next free stage.
    if constexpr (L::kSetRegs) set_max_regs_dec<L::kProducerRegs>();
    auto load_kv = [&](int i) {  // tile kt_begin + i into the raw buffer
      const int row = (kt_begin + i) * KT;
      mbar_expect_tx(raw_bar, 2 * L::kKVBytes);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int m = c < D / 32 ? 0 : 1;
        tma_load_3d(base + L::kRawK + KT * 128 * c, &maps.k[m], raw_bar,
                    32 * c, row, bh_kv);
        tma_load_3d(base + L::kRawV + KT * 128 * c, &maps.v[m], raw_bar,
                    32 * c, row, bh_kv);
      }
    };
    if (tid == 0) {
      mbar_expect_tx(q_bar, L::kQBytes);
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        tma_load_3d(base + L::kQHi + QT * 128 * c,
                    &maps.q[c < D / 32 ? 0 : 1], q_bar, 32 * c, q0, bh_q);
      if (n > 0) load_kv(0);
    }
    // Q split in place: hi over the raw tile, lo at the same places of
    // its own tile (an elementwise split keeps the swizzle).
    mbar_wait(q_bar, 0);
    for (int idx = tid; idx < QT * D / 4; idx += L::kProducerThreads) {
      uint4 hi, lo;
      split_tf32(*reinterpret_cast<const float4*>(sp + L::kQHi + 16 * idx),
                 hi, lo);
      *reinterpret_cast<uint4*>(sp + L::kQHi + 16 * idx) = hi;
      *reinterpret_cast<uint4*>(sp + L::kQLo + 16 * idx) = lo;
    }
    fence_async_smem();  // the wgmma reads them through the async proxy
    mbar_arrive(q_ready);
    for (int i = 0; i < n; ++i) {
      const int st = i % kStages;
      unsigned char* const stage = sp + L::kSplit + st * L::kSplitBytes;
      mbar_wait(raw_bar, i & 1);
      // the consumers are done with the tile that used this stage
      if (i >= kStages) mbar_wait(empty_bar + 8 * st, (i / kStages - 1) & 1);
      // K: hi and lo at the raw tile's (swizzled) places.
#pragma unroll
      for (int it = 0; it < KT * D / 4 / L::kProducerThreads; ++it) {
        const int idx = tid + L::kProducerThreads * it;
        uint4 hi, lo;
        split_tf32(
            *reinterpret_cast<const float4*>(sp + L::kRawK + 16 * idx), hi,
            lo);
        *reinterpret_cast<uint4*>(stage + L::kKHi + 16 * idx) = hi;
        *reinterpret_cast<uint4*>(stage + L::kKLo + 16 * idx) = lo;
      }
      // V^T: kv row r, columns 4u .. 4u + 3 of V go to rows 4u .. 4u + 3
      // of V^T's chunk r / 32 (D rows of 32 kv), at r's place in its group
      // of 8 permuted as the A fragment of P wants. A warp reads 32 rows
      // of one 16-byte column (conflict-free under the swizzle) and writes
      // 32 columns of one row.
#pragma unroll
      for (int it = 0; it < KT * D / 4 / L::kProducerThreads; ++it) {
        const int idx = tid + L::kProducerThreads * it;
        const int r = idx % KT;
        const int u = idx / KT;
        const int c = u / 8;  // V's column chunk
        const int byte = 16 * (u - 8 * c);
        const uint32_t src =
            KT * 128 * c + (chunk_width(D, c) == 32 ? swizzled<128>(r, byte)
                                                    : swizzled<64>(r, byte));
        uint4 hi, lo;
        split_tf32(*reinterpret_cast<const float4*>(sp + L::kRawV + src), hi,
                   lo);
        const int rr = r % 32;
        const int pos = (rr & ~7) | ((rr & 7) >> 1) | ((rr & 1) << 2);
        const uint32_t dst = D * 128 * (r / 32);
        const uint32_t e0 = dst + swizzled<128>(4 * u, 4 * pos);
        const uint32_t e1 = dst + swizzled<128>(4 * u + 1, 4 * pos);
        const uint32_t e2 = dst + swizzled<128>(4 * u + 2, 4 * pos);
        const uint32_t e3 = dst + swizzled<128>(4 * u + 3, 4 * pos);
        *reinterpret_cast<uint32_t*>(stage + L::kVtHi + e0) = hi.x;
        *reinterpret_cast<uint32_t*>(stage + L::kVtHi + e1) = hi.y;
        *reinterpret_cast<uint32_t*>(stage + L::kVtHi + e2) = hi.z;
        *reinterpret_cast<uint32_t*>(stage + L::kVtHi + e3) = hi.w;
        *reinterpret_cast<uint32_t*>(stage + L::kVtLo + e0) = lo.x;
        *reinterpret_cast<uint32_t*>(stage + L::kVtLo + e1) = lo.y;
        *reinterpret_cast<uint32_t*>(stage + L::kVtLo + e2) = lo.z;
        *reinterpret_cast<uint32_t*>(stage + L::kVtLo + e3) = lo.w;
      }
      fence_async_smem();
      // every producer thread is done with the raw tile
      producer_sync<L::kProducerThreads>();
      if (tid == 0 && i + 1 < n) load_kv(i + 1);
      mbar_arrive(full_bar + 8 * st);
    }
    return;
  }

  // A consumer warpgroup: 64 q rows, the products and the online softmax.
  if constexpr (L::kSetRegs) set_max_regs_inc<L::kConsumerRegs>();
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  float o_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.0f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.0f, l_b = 0.0f;
  const int w = wg - L::kProducers;  // this consumer's index
  const int r_lo = q0 + 64 * w;  // this warpgroup's first row
  const int row_a = r_lo + 16 * warp + lane / 4;  // and row_a + 8
  const int col_l = 2 * (lane % 4);
  mbar_wait(q_ready, 0);
  // Two consumers take turns at the tensor cores, S then P V each, so that
  // one's softmax runs while the other's products do; warpgroup 0 first.
  constexpr bool kPingPong = L::kConsumers > 1;
  if (kPingPong && w == 1) turn_pass(w);
  // descriptors of this warpgroup's 64 rows of Q, [0] lo and [1] hi, per
  // chunk; a k step adds its offset in the row
  uint64_t q_desc[2][kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const uint32_t qo = QT * 128 * c + 64 * chunk_width(D, c) * 4 * w;
    q_desc[0][c] = chunk_desc<D>(c, base + L::kQLo + qo);
    q_desc[1][c] = chunk_desc<D>(c, base + L::kQHi + qo);
  }

  for (int i = 0; i < n; ++i) {
    const int st = i % kStages;
    const uint32_t stage = base + L::kSplit + st * L::kSplitBytes;
    mbar_wait(full_bar + 8 * st, (i / kStages) & 1);
    const int k0 = (kt_begin + i) * KT;
    if (!tile_visible<KT>(k0, r_lo, kv_len, causal, window)) {
      if (kPingPong) {  // both turns all the same, to keep them paired
        turn_wait(w);
        turn_pass(w);
        turn_wait(w);
        turn_pass(w);
      }
      mbar_arrive(empty_bar + 8 * st);
      continue;
    }

    // S = Q K^T: lo.hi and hi.lo over the head dim first, then hi.hi.
    uint64_t k_desc[2][kChunks];  // [0] hi, [1] lo
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      k_desc[0][c] = chunk_desc<D>(c, stage + L::kKHi + KT * 128 * c);
      k_desc[1][c] = chunk_desc<D>(c, stage + L::kKLo + KT * 128 * c);
    }
    float s[KT / 2];
    if (kPingPong) turn_wait(w);
    wgmma_fence();
#pragma unroll
    for (int part = 0; part < 3; ++part)
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const int c = kk / 4;
        const uint32_t off = (8 * kk - 32 * c) * 4;
        wgmma_ss<KT>(s, desc_add(q_desc[part != 0][c], off),
                     desc_add(k_desc[part == 1][c], off), part > 0 || kk > 0);
      }
    wgmma_commit();
    if (kPingPong) turn_pass(w);
    wgmma_wait_all();
    fence_regs(s);

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

    // this tile's P V in a fresh accumulator: lo.hi, hi.lo, then hi.hi
    float o_tile[D / 2];
    const uint64_t v_desc[2] = {smem_desc<128>(stage + L::kVtHi),
                                smem_desc<128>(stage + L::kVtLo)};
    if (kPingPong) turn_wait(w);
    wgmma_fence();
#pragma unroll
    for (int part = 0; part < 3; ++part)
#pragma unroll
      for (int kk = 0; kk < KT / 8; ++kk) {
        const uint32_t vo = D * 128 * (kk / 4) + 32 * (kk % 4);
        wgmma_pv<D>(o_tile, part == 0 ? p_lo[kk] : p_hi[kk],
                    desc_add(v_desc[part == 1], vo), part > 0 || kk > 0);
      }
    wgmma_commit();
    if (kPingPong) turn_pass(w);
    wgmma_wait_all();
    fence_regs(o_tile);
#pragma unroll
    for (int kk = 0; kk < KT / 8; ++kk) {
      fence_regs(p_hi[kk]);
      fence_regs(p_lo[kk]);
    }
    mbar_arrive(empty_bar + 8 * st);  // this stage is free again
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o_acc[4 * j] = fmaf(o_acc[4 * j], alpha.x, o_tile[4 * j]);
      o_acc[4 * j + 1] = fmaf(o_acc[4 * j + 1], alpha.x, o_tile[4 * j + 1]);
      o_acc[4 * j + 2] = fmaf(o_acc[4 * j + 2], alpha.y, o_tile[4 * j + 2]);
      o_acc[4 * j + 3] = fmaf(o_acc[4 * j + 3], alpha.y, o_tile[4 * j + 3]);
    }
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
      &maps, q, k, v, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, D, 32, QT, KT, s,
      static_cast<int>(batch * heads), static_cast<int>(batch * kv_heads));
  if (mapped != 0) return mapped;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_tf32x3_kernel<D, QT, KT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kSmemBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>((seq + QT - 1) / QT),
                  static_cast<unsigned>(heads),
                  static_cast<unsigned>(batch));
  // a window at least as long as the sequence masks nothing
  const int win = window <= 0 || window >= seq ? 0 : static_cast<int>(window);
  flash_attention_tf32x3_kernel<D, QT, KT>
      <<<grid, L::kThreads, L::kSmemBytes,
         static_cast<cudaStream_t>(stream)>>>(
          maps, static_cast<float*>(o), static_cast<int>(heads),
          static_cast<int>(kv_heads), s, static_cast<int>(kv_len),
          static_cast<int>(bq), static_cast<int>(bk), causal, win,
          sm_scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The compiled (head dim, physical q rows, physical kv rows) table: the one
// list the launchers and the queries below are made from. The Python
// wrapper's TF32X3_TILES must list exactly these. D = 128 takes kv 32 only
// (its shared memory); D = 256 is flash_attention_tf32x3_d256.cu's.
#define RT_FLASH_TF32X3_TILES(X)                                   \
  X(16, 64, 64) X(16, 128, 64) X(32, 64, 64) X(32, 128, 64)        \
  X(64, 64, 64) X(64, 128, 64) X(80, 64, 64) X(80, 128, 64)        \
  X(128, 64, 32) X(128, 128, 32)

// One extern "C" launcher per table entry, named
// rt_flash_attention_tf32x3_d<D>_q<QT>_k<KT>, with the other flash
// launchers' arguments. Each makes `device` current, builds the tensor
// maps, enqueues on `stream` and returns cudaGetLastError() (or an error
// of its own: cudaErrorMisalignedAddress for an operand not 16-byte
// aligned, 100000 + CUresult for a refused tensor map); window <= 0 means
// none.
#define RT_FLASH_TF32X3(D, QT, KT)                                          \
  extern "C" int rt_flash_attention_tf32x3_d##D##_q##QT##_k##KT(            \
      const void* q, const void* k, const void* v, void* o, int64_t batch,  \
      int64_t heads, int64_t kv_heads, int64_t seq, int64_t kv_len,         \
      int64_t bq, int64_t bk, int causal, int64_t window, float sm_scale,   \
      int device, void* stream) {                                           \
    return launch<D, QT, KT>(q, k, v, o, batch, heads, kv_heads, seq,       \
                             kv_len, bq, bk, causal, window, sm_scale,      \
                             device, stream);                               \
  }
RT_FLASH_TF32X3_TILES(RT_FLASH_TF32X3)

// The table as (D, QT, KT) triples into out[3 * i ..]: writes at most
// `cap` triples and returns how many the table has.
#define RT_FLASH_TF32X3_ROW(D, QT, KT) \
  if (n < cap) {                       \
    out[3 * n] = D;                    \
    out[3 * n + 1] = QT;               \
    out[3 * n + 2] = KT;               \
  }                                    \
  ++n;
extern "C" int rt_flash_attention_tf32x3_tiles(int* out, int cap) {
  int n = 0;
  RT_FLASH_TF32X3_TILES(RT_FLASH_TF32X3_ROW)
  return n;
}

// Dynamic shared memory one block of a table entry asks for, in bytes, or
// -1 for an entry outside the table.
#define RT_FLASH_TF32X3_SMEM(D, QT, KT)               \
  if (d == D && qt == QT && kt == KT)                 \
    return static_cast<int64_t>(Shape<D, QT, KT>::kSmemBytes);
extern "C" int64_t rt_flash_attention_tf32x3_smem_bytes(int d, int qt,
                                                        int kt) {
  RT_FLASH_TF32X3_TILES(RT_FLASH_TF32X3_SMEM)
  return -1;
}

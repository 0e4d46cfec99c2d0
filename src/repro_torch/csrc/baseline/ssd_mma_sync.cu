// The mma.sync design the chunk scan of ../ssd.cu replaced, kept as its
// timing baseline: it is not part of the kernel library (kernels/build.py
// compiles csrc/*.cu only). chip_smoke.py builds it alone into its own
// shared library and times it beside the shipped kernel on the same card
// and the same operands; nothing else calls it. Its launcher keeps the
// old interface (no row strides: every operand dense). Its note follows
// as it was.
//
// Mamba2 SSD chunk scan (state-space duality), f32 results from the tensor
// cores.
//
// Replaces: src/repro/kernels/ssd/ssd.py:36, _ssd_kernel /
// ssd_chunk_scan_pallas (the model-layout reshapes of ops.ssd_chunk_scan
// stay in the Python wrapper).
//
// Computes, per (batch, head), over the chunks c = 0 .. C-1, with a (P, N)
// f32 state h that starts at h0 (or 0):
//   y_c = ((C_c B_c^T) ⊙ L_c) xdt_c + (C_c h^T) ⊙ exp(cum_c),
//         L_c[i, j] = exp(cum_i - cum_j) for i >= j, else 0;
//   h  <- exp(cum_c[Q-1]) h + (xdt_c ⊙ exp(cum_c[Q-1] - cum_c))^T B_c,
// with xdt (B, H, C, Q, P), bm and cm (B, C, Q, N) shared by the heads,
// cum (B, H, C, Q) and y (B, H, C, Q, P); and, when asked, the state after
// the last chunk, (B, H, P, N), which the TPU kernel keeps in VMEM scratch
// and drops.
//
// Bound on the card: operations. The work the function needs (C·Bᵀ once
// for all heads, both quadratic terms on the causal triangle, 2 Q P N for
// each of the inter-chunk term and the state update; ops.needed_flops)
// against 4 (2 Q P + 2 Q N / H + Q) bytes a position and head puts every
// config far above the ridge point. f32-accurate products from TF32 tensor
// cores cost three TF32 products each (below), so the roof is 495 / 3 =
// 165 TFLOP/s: 0.964 ms at mamba2-130m's serving shape (B = 4, H = 24,
// S = 32768, Q = 256, P = 64, N = 128; 159.13 GFLOP, 1.761 GB) and
// 0.0515 ms at zamba2-2.7b's train shape (B = 1, H = 80, S = 4096, Q = 128,
// P = 64, N = 64; bytes bound it there: 0.1725 GB), against 2.375 and
// 0.121 ms at the CUDA cores' 67 TFLOP/s.
//
// Design: the chunk-parallel decomposition of SSD (Dao & Gu 2024, §6; the
// four steps of mamba_ssm's ssd_combined). Only the state carry is
// sequential, and it is elementwise; the three products that do not depend
// on the carried state run for every chunk at once. One launcher enqueues
// four kernels on the caller's stream:
//
// 1. ssd_scores_kernel: each chunk's C_c B_c^T, which depends on (b, c)
//    only (the heads share B and C, n_groups = 1), once for all heads into
//    a (B, C, Q, Q) scratch, only the 64 x 64 tiles on or below the
//    diagonal. The sequential design read each score tile back from device
//    memory, and took exp of it, once per head and 32 state rows (48 times
//    at mamba2-130m's serving shape); here each head's output block reads
//    it once, from L2.
// 2. ssd_states_kernel: each chunk's own state contribution
//    s_c = (xdt_c ⊙ exp(cum_c[Q-1] - cum_c))^T B_c, a (P, N) matrix, into
//    a (B, H, C, P, N) scratch. Grid x is B·H·C (12,288 at the serving
//    shape, 2,560 at zamba2's), y the 64 x 64 tiles of (P, N), in place of
//    the sequential design's one block per (b, h, 32 state rows) walking
//    every chunk: 192 and 160 blocks on 132 SMs.
// 3. ssd_pass_kernel: the state carry, one thread per (b, h, 4 elements
//    of the P·N state; 1 where P·N is not a multiple of 4), walking the
//    chunks in order: it writes the state that enters chunk c over s_c
//    (h0, or 0, at c = 0), then h <- exp(cum_c[Q-1]) h + s_c, and the final
//    state to h_out when asked. Elementwise and bound by memory: every
//    thread and every element updates in parallel, where the sequential
//    design updated the state from its last row tile only; each thread
//    loads 8 chunks ahead of its sequential updates.
// 4. ssd_output_kernel: for each (b, c, 64-row tile of i, h, 64-column
//    tile of p), y = (C_c h_c^T) ⊙ exp(cum_i) + (scores ⊙ L) xdt_c, the
//    two terms in two cp.async rings one after the other (each loop keeps
//    only its own registers). The heads are the fastest block index, so a
//    chunk's score tile is still in L2 when its H heads read it. Only the
//    column slices that hold some j <= i are visited, and a warp skips a
//    slice that lies wholly above its rows. The causal mask and the decay
//    exp(cum_i - cum_j) are applied on the A fragment's own (row, column)
//    coordinates as it is loaded. In the tile's diagonal slices exp sees
//    cum_i - cum_j only for j <= i (elsewhere -inf, so exp gives 0 without
//    a branch); in the slices left of the tile (j < i0 <= i) the decay
//    factors as exp(cum_i - cum_i0) exp(cum_i0 - cum_j), the column factor
//    on the fragment and the row factor once on the accumulator, both <= 1.
//    So nothing overflows (cum spans more than 88 in a chunk at zamba2's
//    random-weight steps), and exp runs once a column there, not once an
//    element.
//
// Every product (C·Bᵀ, (xdt ⊙ decay)ᵀ·B, C·hᵀ, the masked scores·xdt) runs
// on mma.sync.m16n8k8 TF32 with the 3xTF32 split, in place of the
// sequential design's FMAs fed from shared memory (2 x 4 outputs a thread):
// a = a_hi + a_lo, each rounded to TF32 (in integer arithmetic, see
// split_tf32), and a·b ≈ a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, so each product
// carries about 22 of f32's 24 bits and the dropped a_lo·b_lo is below
// 2^-22 of it. The tensor cores add into their f32 accumulator with
// truncation, so a long chain of additions at one magnitude drifts toward
// zero by up to an ulp each: accumulating a whole k range in the tensor
// cores' accumulator read 11.2 ulps of the largest output on an H100
// (bench/ssd_probe.py), past the limit. So each group of 2 k8 steps
// starts fresh partial sums, adds its small terms first and its large ones
// last (two truncations at the partial's full size), and the partials are
// added into the running sums on the CUDA cores, rounded to nearest. On an
// H100 every product then stays within 5 ulps of the largest output
// (chip_smoke.py holds the scan to 8), so no product falls back to f32
// FMA.
//
// Kernels 1, 2 and 4 share one shape: 128 threads (4 warps), a 64 x 64
// output tile, each warp a 32 x 32 quarter (2 x 4 accumulator tiles of
// 16 x 8; each operand element is split by 2 warps, the fewest for 4 warps
// on 64 x 64), k in slices of 32 fed by a 3-stage cp.async ring in dynamic
// shared memory (55,936 bytes a block, past the 48 KB default: the launcher
// opts in). A tile whose rows are contiguous along k is stored with a
// 36-float row stride, one contiguous along the output's rows or columns
// with a 72-float stride, so every fragment load of a warp hits 32 distinct
// banks. Operands are copied 16 bytes at a time where their row length and
// base are 16-byte aligned, 4 bytes at a time otherwise, and zero-filled
// past their edges: any Q >= 1, any P >= 1, N <= 256. Registers: at most
// 128 a thread for the scores and states kernels (4 blocks an SM), 168 for
// the output kernel (3), none spilled.
//
// What holds it back (edited copies of this file on an H100,
// bench/ssd_probe.py; PERF.md): the work around each mma.sync more than the
// tensor cores. Counting the work the function needs, three TF32 products
// each, the kernel runs at about 30% of the 304 TFLOP/s of mma.sync TF32
// the card sustains on independent chains; the compiler keeps only two
// accumulator chains of a warp in flight within its registers. Taking the
// split away saves 18% of the output kernel's time, its loads 27%, two of
// the three products 13%. TF32 wgmma, with both operands split once into
// K-major shared memory, is the next step.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;          // 4 warps
constexpr int kTile = 64;              // rows and columns of an output tile
constexpr int kSlice = 32;             // k depth of a staged slice
constexpr int kStages = 3;             // cp.async ring depth
constexpr int kKStride = kSlice + 4;   // row stride, k-contiguous tiles
constexpr int kMStride = kTile + 8;    // row stride, row/column-contiguous
constexpr int kOperand = kTile * kKStride;       // floats of one operand
constexpr int kStage = 2 * kOperand + kSlice;    // two operands + a vector
constexpr int kSmemBytes = (kStages * kStage + kTile) * 4;
// Blocks an SM for the launch bounds: 4 (128 registers) for the scores and
// states kernels; 3 (168) for the output kernel, whose intra-chunk term
// spills at 128.
constexpr int kBlocks = 4;
constexpr int kOutputBlocks = 3;
constexpr int kMaxN = 256;             // the largest state width taken
constexpr int kPassThreads = 256;
constexpr int kPassAhead = 8;          // chunks loaded ahead in the pass
constexpr int kGroup = 2;              // k8 steps per partial sum
constexpr int kWM = 2;                 // 16-row tiles per warp
constexpr int kWN = 4;                 // 8-column tiles per warp
static_assert(kThreads / 32 == (kTile / (16 * kWM)) * (kTile / (8 * kWN)) &&
              kSlice * kMStride == kOperand && kKStride % 32 == 4 &&
              kMStride % 32 == 8 && kSlice % (8 * kGroup) == 0 &&
              kTile == 64,
              "tile shape");

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo with hi rounded to TF32 (to nearest, ties away from zero,
// as cvt.rna does) and x - hi exact; lo is returned with the same rounding
// applied to its top bits (the tensor cores read the top 19 bits of each
// operand and ignore the rest). In integer arithmetic: cvt.rna.tf32.f32
// compiles to four instructions with an inf/NaN test, these to four in all
// for both parts; the operands here are finite.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// d += a b on the tensor cores: a 16 x 8 (row), b 8 x 8 (col), TF32 in.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's accumulators: kWM x kWN tiles of 16 x 8 (a 32 x 32 warp tile).
using Acc = float[kWM][kWN][4];

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int mt = 0; mt < kWM; ++mt)
#pragma unroll
    for (int nt = 0; nt < kWN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
}

// One 32-deep k slice of a warp's 32 x 32 tile: acc += A (32 x 32) B
// (32 x 32) in 3xTF32. a_at(m, k) and b_at(k, n) read the staged operands
// at the warp's local coordinates (m, k, n < 32). g and t are the lane's
// group and thread-in-group. Fragment layouts of m16n8k8 (PTX ISA): A
// a0..a3 at (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B b0, b1 at
// (t, g), (t + 4, g); the accumulator c0..c3 at (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1). Each group of kGroup k8 steps sums into
// fresh partials, small terms first, which are then added into acc. The
// 8 tiles are the inner loop, so that runs of mma.sync are independent;
// the groups stay a loop, which halves the code.
template <class LoadA, class LoadB>
__device__ __forceinline__ void warp_slice(Acc& acc, LoadA a_at, LoadB b_at,
                                           int g, int t) {
#pragma unroll 1
  for (int k0 = 0; k0 < kSlice / 8; k0 += kGroup) {
    Acc part;
    zero(part);
    uint32_t ah[kGroup][kWM][4], bh[kGroup][kWN][2];
#pragma unroll
    for (int f = 0; f < kGroup; ++f) {
      const int k = 8 * (k0 + f) + t;
      uint32_t al[kWM][4], bl[kWN][2];
#pragma unroll
      for (int mt = 0; mt < kWM; ++mt) {
        const int m = 16 * mt + g;
        split_tf32(a_at(m, k), ah[f][mt][0], al[mt][0]);
        split_tf32(a_at(m + 8, k), ah[f][mt][1], al[mt][1]);
        split_tf32(a_at(m, k + 4), ah[f][mt][2], al[mt][2]);
        split_tf32(a_at(m + 8, k + 4), ah[f][mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < kWN; ++nt) {
        split_tf32(b_at(k, 8 * nt + g), bh[f][nt][0], bl[nt][0]);
        split_tf32(b_at(k + 4, 8 * nt + g), bh[f][nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < kWM; ++mt)
#pragma unroll
        for (int nt = 0; nt < kWN; ++nt)
          mma_tf32(part[mt][nt], al[mt], bh[f][nt][0], bh[f][nt][1]);
#pragma unroll
      for (int mt = 0; mt < kWM; ++mt)
#pragma unroll
        for (int nt = 0; nt < kWN; ++nt)
          mma_tf32(part[mt][nt], ah[f][mt], bl[nt][0], bl[nt][1]);
    }
#pragma unroll
    for (int f = 0; f < kGroup; ++f)
#pragma unroll
      for (int mt = 0; mt < kWM; ++mt)
#pragma unroll
        for (int nt = 0; nt < kWN; ++nt)
          mma_tf32(part[mt][nt], ah[f][mt], bh[f][nt][0], bh[f][nt][1]);
#pragma unroll
    for (int mt = 0; mt < kWM; ++mt)
#pragma unroll
      for (int nt = 0; nt < kWN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
  }
}

// Stage rows [r0, r0 + ROWS) x columns [c0, c0 + COLS) of a row-major
// matrix (row stride ld; rows < r_end and columns < c_end exist) into dst
// (row stride sld), zero-filling the rest; 16-byte copies when vec (ld and
// the matrix's base 16-byte aligned, so c_end is a multiple of 4 too).
template <int ROWS, int COLS>
__device__ __forceinline__ void stage_tile(float* dst, int sld,
                                           const float* src, int64_t ld,
                                           int r0, int r_end, int c0,
                                           int c_end, bool vec) {
  if (vec) {
    constexpr int kVec = COLS / 4;
    for (int idx = threadIdx.x; idx < ROWS * kVec; idx += kThreads) {
      const int r = idx / kVec;
      const int v = idx % kVec;
      const int row = r0 + r;
      const int col = c0 + 4 * v;
      const bool in = row < r_end && col < c_end;
      cp_async16(dst + r * sld + 4 * v, in ? src + row * ld + col : src,
                 in ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * COLS; idx += kThreads) {
      const int r = idx / COLS;
      const int cl = idx % COLS;
      const int row = r0 + r;
      const int col = c0 + cl;
      const bool in = row < r_end && col < c_end;
      cp_async4(dst + r * sld + cl, in ? src + row * ld + col : src,
                in ? 4 : 0);
    }
  }
}

// The k slices of a block through the cp.async ring: load(s, stage) issues
// slice s's copies, compute(s, stage) consumes them; copies issued before
// the ring starts land with slice 0. One __syncthreads a slice: the stage
// that slice s + kStages - 1 overwrites was consumed at slice s - 1, which
// every thread finished before the barrier of slice s.
template <class Load, class Compute>
__device__ __forceinline__ void pipeline(int steps, float* ring, Load load,
                                         Compute compute) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, ring + s * kStage);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = s + kStages - 1;
    if (next < steps) load(next, ring + (next % kStages) * kStage);
    cp_async_commit();
    compute(s, ring + (s % kStages) * kStage);
  }
  cp_async_wait<0>();
}

// Write a warp's 32 x 32 accumulator tile at rows r0 + (0..31), columns
// c0 + (0..31) of a row-major matrix (row stride ld), inside r_end x c_end.
__device__ __forceinline__ void store_tile(float* out, int64_t ld, int r0,
                                           int r_end, int c0, int c_end,
                                           const Acc& acc, int g, int t) {
  const bool pairs = ld % 2 == 0;
#pragma unroll
  for (int mt = 0; mt < kWM; ++mt)
#pragma unroll
    for (int nt = 0; nt < kWN; ++nt) {
      const int col = c0 + 8 * nt + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + 16 * mt + g + 8 * half;
        if (row >= r_end || col >= c_end) continue;
        float* p = out + row * ld + col;
        const float v0 = acc[mt][nt][2 * half];
        const float v1 = acc[mt][nt][2 * half + 1];
        if (pairs && col + 1 < c_end) {
          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        } else {
          p[0] = v0;
          if (col + 1 < c_end) p[1] = v1;
        }
      }
    }
}

// 1. scores[b, c] = C_c B_c^T on the 64 x 64 tiles (it, jt), jt <= it.
__global__ void __launch_bounds__(kThreads, kBlocks)
ssd_scores_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
                  float* __restrict__ scores, int64_t pairs, int q_len,
                  int n, bool vec) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  const int64_t pair = blockIdx.x % pairs;
  const int64_t bc = blockIdx.x / pairs;   // b * C + c
  int it = 0;                              // tile pair -> (row, column)
  while (static_cast<int64_t>(it + 1) * (it + 2) / 2 <= pair) ++it;
  const int jt =
      static_cast<int>(pair - static_cast<int64_t>(it) * (it + 1) / 2);
  const int i0 = it * kTile;
  const int j0 = jt * kTile;
  const float* c_rows = cm + bc * q_len * n;
  const float* b_rows = bm + bc * q_len * n;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wm = 32 * (threadIdx.x / 64);  // the warp's 32 x 32 tile
  const int wn = 32 * (threadIdx.x / 32 % 2);

  Acc acc;
  zero(acc);
  pipeline((n + kSlice - 1) / kSlice, ring,
      [&](int s, float* st) {
        stage_tile<kTile, kSlice>(st, kKStride, c_rows, n, i0, q_len,
                                  s * kSlice, n, vec);
        stage_tile<kTile, kSlice>(st + kOperand, kKStride, b_rows, n, j0,
                                  q_len, s * kSlice, n, vec);
      },
      [&](int, const float* st) {
        const float* cs = st + wm * kKStride;
        const float* bs = st + kOperand + wn * kKStride;
        warp_slice(acc,
                   [&](int m, int k) { return cs[m * kKStride + k]; },
                   [&](int k, int j) { return bs[j * kKStride + k]; }, g, t);
      });
  store_tile(scores + bc * q_len * q_len, q_len, i0 + wm, q_len, j0 + wn,
             q_len, acc, g, t);
}

// 2. states[b, h, c] = (xdt_c ⊙ exp(cum_c[Q-1] - cum_c))^T B_c, the (P, N)
//    tile (p0, n0) given by blockIdx.y.
__global__ void __launch_bounds__(kThreads, kBlocks)
ssd_states_kernel(const float* __restrict__ xdt, const float* __restrict__ bm,
                  const float* __restrict__ cum, float* __restrict__ states,
                  int64_t heads, int64_t chunks, int q_len, int p_dim, int n,
                  int n_tiles, bool vec_x, bool vec_b) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* total = ring + kStages * kStage;  // cum_c[Q-1]
  const int64_t bhc = blockIdx.x;          // (b * H + h) * C + c
  const int64_t b = bhc / (heads * chunks);
  const int64_t c = bhc % chunks;
  const int p0 = static_cast<int>(blockIdx.y / n_tiles) * kTile;
  const int n0 = static_cast<int>(blockIdx.y % n_tiles) * kTile;
  const float* x_rows = xdt + bhc * q_len * p_dim;
  const float* b_rows = bm + (b * chunks + c) * q_len * n;
  const float* cu = cum + bhc * q_len;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wm = 32 * (threadIdx.x / 64);
  const int wn = 32 * (threadIdx.x / 32 % 2);

  // cum arrives by cp.async like the tiles (a plain load here would stall
  // the warp, and at the next barrier the block, for a trip to L2)
  if (threadIdx.x == 0) cp_async4(total, cu + q_len - 1, 4);
  Acc acc;
  zero(acc);
  pipeline((q_len + kSlice - 1) / kSlice, ring,
      [&](int s, float* st) {
        const int k0 = s * kSlice;
        stage_tile<kSlice, kTile>(st, kMStride, x_rows, p_dim, k0, q_len, p0,
                                  p_dim, vec_x);
        stage_tile<kSlice, kTile>(st + kOperand, kMStride, b_rows, n, k0,
                                  q_len, n0, n, vec_b);
        if (threadIdx.x < kSlice) {
          const bool in = k0 + threadIdx.x < q_len;
          cp_async4(st + 2 * kOperand + threadIdx.x,
                    in ? cu + k0 + threadIdx.x : cu, in ? 4 : 0);
        }
      },
      [&](int, const float* st) {
        const float* xs = st + wm;
        const float* bs = st + kOperand + wn;
        const float* cum_k = st + 2 * kOperand;
        const float last = *total;
        // rows past Q are zero-filled, cum there too: exp(last) <= 1 times
        // 0 (cum <= 0)
        warp_slice(acc,
                   [&](int m, int k) {
                     return xs[k * kMStride + m] * expf(last - cum_k[k]);
                   },
                   [&](int k, int j) { return bs[k * kMStride + j]; }, g, t);
      });
  store_tile(states + bhc * p_dim * n, n, p0 + wm, p_dim, n0 + wn, n, acc, g,
             t);
}

template <int VEC>
__device__ __forceinline__ void load_vec(float (&v)[VEC], const float* p) {
  if constexpr (VEC == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
    v[0] = *p;
  }
}
template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

// 3. The state carry over the chunks of one (b, h), VEC state elements a
//    thread (4 where P·N is a multiple of 4 and h0 16-byte aligned):
//    states[b, h, c] becomes the state entering chunk c; h_out (if given)
//    the state after the last.
template <int VEC>
__global__ void __launch_bounds__(kPassThreads)
ssd_pass_kernel(const float* __restrict__ cum, const float* __restrict__ h0,
                float* states, float* __restrict__ h_out, int64_t chunks,
                int q_len, int64_t pn, int64_t blocks_per_bh) {
  const int64_t bh = blockIdx.x / blocks_per_bh;
  const int64_t e =
      ((blockIdx.x % blocks_per_bh) * kPassThreads + threadIdx.x) * VEC;
  if (e >= pn) return;
  float h[VEC];
  if (h0 != nullptr) {
    load_vec(h, h0 + bh * pn + e);
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) h[v] = 0.0f;
  }
  float* st = states + bh * chunks * pn + e;
  const float* last = cum + bh * chunks * q_len + (q_len - 1);
  for (int64_t c0 = 0; c0 < chunks; c0 += kPassAhead) {
    float s[kPassAhead][VEC], d[kPassAhead];
#pragma unroll
    for (int u = 0; u < kPassAhead; ++u) {
      if (c0 + u < chunks) {
        load_vec(s[u], st + (c0 + u) * pn);
        d[u] = expf(last[(c0 + u) * q_len]);
      }
    }
#pragma unroll
    for (int u = 0; u < kPassAhead; ++u) {
      if (c0 + u < chunks) {
        store_vec(st + (c0 + u) * pn, h);
#pragma unroll
        for (int v = 0; v < VEC; ++v) h[v] = fmaf(d[u], h[v], s[u][v]);
      }
    }
  }
  if (h_out != nullptr) store_vec(h_out + bh * pn + e, h);
}

// 4. y[b, h, c] rows i0 .. i0 + 63, columns p0 .. p0 + 63:
//    (C_c h_c^T) ⊙ exp(cum_i) + (scores ⊙ L) xdt_c. Block index, fastest
//    first: p tile, head, i tile, (b, c).
__global__ void __launch_bounds__(kThreads, kOutputBlocks)
ssd_output_kernel(const float* __restrict__ xdt, const float* __restrict__ cm,
                  const float* __restrict__ cum,
                  const float* __restrict__ scores,
                  const float* __restrict__ states, float* __restrict__ y,
                  int64_t heads, int64_t chunks, int q_len, int p_dim, int n,
                  int i_tiles, int p_tiles, bool zero_h0, bool vec_x,
                  bool vec_c, bool vec_s, bool vec_h) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* cum_i = ring + kStages * kStage;  // [kTile]
  int64_t idx = blockIdx.x;
  const int pt = static_cast<int>(idx % p_tiles);
  idx /= p_tiles;
  const int64_t h = idx % heads;
  idx /= heads;
  const int it = static_cast<int>(idx % i_tiles);
  const int64_t bc = idx / i_tiles;        // b * C + c
  const int64_t b = bc / chunks;
  const int64_t c = bc % chunks;
  const int64_t bhc = (b * heads + h) * chunks + c;
  const int i0 = it * kTile;
  const int p0 = pt * kTile;
  const float* cu = cum + bhc * q_len;
  const float* c_rows = cm + bc * q_len * n;
  const float* h_rows = states + bhc * p_dim * n;
  const float* s_rows = scores + bc * q_len * q_len;
  const float* x_rows = xdt + bhc * q_len * p_dim;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wm = 32 * (threadIdx.x / 64);
  const int wn = 32 * (threadIdx.x / 32 % 2);
  if (threadIdx.x < kTile) {              // by cp.async, as the states'
    const bool in = i0 + threadIdx.x < q_len;
    cp_async4(cum_i + threadIdx.x, in ? cu + i0 + threadIdx.x : cu,
              in ? 4 : 0);
  }

  // the state entering chunk 0 is zero without h0: no inter-chunk term
  const int n_inter = (c == 0 && zero_h0) ? 0 : (n + kSlice - 1) / kSlice;
  const int n_intra = (min(i0 + kTile, q_len) + kSlice - 1) / kSlice;
  Acc acc;
  zero(acc);
  // Two rings in turn, the inter-chunk term's and the intra-chunk term's,
  // so that each loop holds only its own registers.
  pipeline(n_inter, ring,
      [&](int s, float* st) {
        stage_tile<kTile, kSlice>(st, kKStride, c_rows, n, i0, q_len,
                                  s * kSlice, n, vec_c);
        stage_tile<kTile, kSlice>(st + kOperand, kKStride, h_rows, n, p0,
                                  p_dim, s * kSlice, n, vec_h);
      },
      [&](int, const float* st) {
        const float* cs = st + wm * kKStride;
        const float* hs = st + kOperand + wn * kKStride;
        warp_slice(acc, [&](int m, int k) { return cs[m * kKStride + k]; },
                   [&](int k, int p) { return hs[p * kKStride + k]; }, g, t);
      });
  __syncthreads();   // cum_i landed everywhere; the ring's stages are free
  // The decay of row i, exp(cum_i - x), factors through the tile's first
  // row as exp(cum_i - cum_i0) exp(cum_i0 - x), both <= 1 (cum falls along
  // the chunk) where x is cum_j for a column j < i0 or 0 for the
  // inter-chunk term: those terms are summed with the column factor only
  // and their rows scaled once, before the first slice that reaches the
  // diagonal tile, whose terms take exp(cum_i - cum_j) per element.
  const float cum_i0 = cum_i[0];
  const int n_off = i0 / kSlice;            // slices with every j < i0
  float cu_row[kWM][2];                     // cum_i of the lane's rows
#pragma unroll
  for (int mt = 0; mt < kWM; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      cu_row[mt][half] = cum_i[wm + 16 * mt + 8 * half + g];
  {
    const float e = expf(cum_i0);           // the inter-chunk term is done
#pragma unroll
    for (int mt = 0; mt < kWM; ++mt)
#pragma unroll
      for (int nt = 0; nt < kWN; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[mt][nt][v] *= e;
  }
  pipeline(n_intra, ring,
      [&](int s, float* st) {
        const int j0 = s * kSlice;
        stage_tile<kTile, kSlice>(st, kKStride, s_rows, q_len, i0, q_len, j0,
                                  q_len, vec_s);
        stage_tile<kSlice, kTile>(st + kOperand, kMStride, x_rows, p_dim, j0,
                                  q_len, p0, p_dim, vec_x);
        if (threadIdx.x < kSlice) {
          const bool in = j0 + threadIdx.x < q_len;
          cp_async4(st + 2 * kOperand + threadIdx.x,
                    in ? cu + j0 + threadIdx.x : cu, in ? 4 : 0);
        }
      },
      [&](int s, const float* st) {
        const int j0 = s * kSlice;
        const float* ss = st + wm * kKStride;
        const float* xs = st + kOperand + wn;
        const float* cum_j = st + 2 * kOperand;
        if (s < n_off) {
          // exp(cum_i0 - cum_j) depends on the column only (one exp for
          // the 4 elements of a lane that share it)
          warp_slice(acc,
                     [&](int m, int k) {
                       return ss[m * kKStride + k] *
                              expf(cum_i0 - cum_j[k]);
                     },
                     [&](int k, int p) { return xs[k * kMStride + p]; }, g,
                     t);
          return;
        }
        if (s == n_off) {
#pragma unroll
          for (int mt = 0; mt < kWM; ++mt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const float e = expf(cu_row[mt][half] - cum_i0);
#pragma unroll
              for (int nt = 0; nt < kWN; ++nt) {
                acc[mt][nt][2 * half] *= e;
                acc[mt][nt][2 * half + 1] *= e;
              }
            }
        }
        // a warp whose rows all lie above this slice's columns adds 0
        if (j0 > i0 + wm + 16 * kWM - 1) return;
        // the decay only on and below the diagonal, inside Q: elsewhere
        // exp(-inf) = 0, so nothing overflows and no branch is taken
        warp_slice(acc,
                   [&](int m, int k) {
                     const int local = m - g;     // 16 mt + 8 half
                     const int row = i0 + wm + m;
                     const bool on = j0 + k <= row && row < q_len;
                     const float d =
                         cu_row[local / 16][local / 8 % 2] - cum_j[k];
                     return ss[m * kKStride + k] * expf(on ? d : -INFINITY);
                   },
                   [&](int k, int p) { return xs[k * kMStride + p]; }, g, t);
      });
  store_tile(y + bhc * q_len * p_dim, p_dim, i0 + wm, q_len, p0 + wn, p_dim,
             acc, g, t);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The blocks of each kernel at one shape (see the Python wrapper's
// ops.grid, which mirrors it): false if a grid passes CUDA's limits.
struct Grid {
  int64_t scores, states_x, states_y, pass, output;
  int64_t pairs, n_tiles, i_tiles, p_tiles, pass_per_bh;
};

bool make_grid(int64_t batch, int64_t heads, int64_t chunks, int64_t q_len,
               int64_t p_dim, int64_t n_dim, int pass_vec, Grid* g) {
  const int64_t q_tiles = (q_len + kTile - 1) / kTile;
  g->pairs = q_tiles * (q_tiles + 1) / 2;
  g->n_tiles = (n_dim + kTile - 1) / kTile;
  g->i_tiles = q_tiles;
  g->p_tiles = (p_dim + kTile - 1) / kTile;
  g->pass_per_bh =
      (p_dim * n_dim + kPassThreads * pass_vec - 1) / (kPassThreads * pass_vec);
  g->scores = g->pairs * batch * chunks;
  g->states_x = batch * heads * chunks;
  g->states_y = g->p_tiles * g->n_tiles;
  g->pass = g->pass_per_bh * batch * heads;
  g->output = batch * chunks * g->i_tiles * heads * g->p_tiles;
  constexpr int64_t kMaxX = 0x7fffffff;
  return g->scores <= kMaxX && g->states_x <= kMaxX &&
         g->states_y <= 65535 && g->pass <= kMaxX && g->output <= kMaxX;
}

const void* const kKernels[] = {
    reinterpret_cast<const void*>(ssd_scores_kernel),
    reinterpret_cast<const void*>(ssd_states_kernel),
    reinterpret_cast<const void*>(ssd_pass_kernel<4>),
    reinterpret_cast<const void*>(ssd_output_kernel)};
constexpr int kKernelThreads[] = {kThreads, kThreads, kPassThreads, kThreads};
constexpr int kKernelSmem[] = {kSmemBytes, kSmemBytes, 0, kSmemBytes};

cudaError_t opt_in_smem() {
  for (int k = 0; k < 4; ++k) {
    if (kKernelSmem[k] == 0) continue;
    const cudaError_t err = cudaFuncSetAttribute(
        kKernels[k], cudaFuncAttributeMaxDynamicSharedMemorySize,
        kKernelSmem[k]);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Launch shape of kernel `which` (0 scores, 1 states, 2 pass, 3 output) on
// the current device: info = {threads, dynamic shared memory bytes, blocks
// an SM can hold (the runtime's occupancy)}. Returns a CUDA error code, or
// cudaErrorInvalidValue for an unknown index.
extern "C" int rt_ssd_kernel_info(int which, int64_t* info) {
  if (which < 0 || which >= 4) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = opt_in_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kKernels[which], kKernelThreads[which], kKernelSmem[which]);
  info[0] = kKernelThreads[which];
  info[1] = kKernelSmem[which];
  info[2] = blocks;
  return static_cast<int>(err);
}

// Launcher: f32 contiguous operands in the layouts above; `scores`, a
// (B, C, Q, Q) f32 scratch (only its tiles on or below the diagonal are
// written and read), and `states`, a (B, H, C, P, N) f32 scratch. h0 and
// h_out may be null (a zero initial state; no final state written). Makes
// `device` current, enqueues the four kernels on `stream` and returns
// cudaGetLastError().
extern "C" int rt_ssd_chunk_scan_f32(
    const void* xdt, const void* bm, const void* cm, const void* cum,
    const void* h0, void* y, void* h_out, void* scores, void* states,
    int64_t batch, int64_t heads, int64_t chunks, int64_t q_len,
    int64_t p_dim, int64_t n_dim, int device, void* stream) {
  Grid grid;
  const bool vec_pass = (p_dim * n_dim) % 4 == 0 &&
                        (h0 == nullptr || aligned16(h0));
  if (batch < 0 || heads < 0 || chunks < 0 || q_len < 1 || p_dim < 1 ||
      n_dim < 1 || n_dim > kMaxN || q_len > 0x7fffffff ||
      p_dim > 0x7fffffff ||
      !make_grid(batch, heads, chunks, q_len, p_dim, n_dim, vec_pass ? 4 : 1,
                 &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || heads == 0 || chunks == 0) return 0;
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaError_t err = opt_in_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int q = static_cast<int>(q_len);
  const int p = static_cast<int>(p_dim);
  const int n = static_cast<int>(n_dim);
  const float* fx = static_cast<const float*>(xdt);
  const float* fb = static_cast<const float*>(bm);
  const float* fc = static_cast<const float*>(cm);
  const float* fcum = static_cast<const float*>(cum);
  float* fscores = static_cast<float*>(scores);
  float* fstates = static_cast<float*>(states);
  const bool vec_x = p % 4 == 0 && aligned16(xdt);
  const bool vec_b = n % 4 == 0 && aligned16(bm);
  const bool vec_c = n % 4 == 0 && aligned16(cm);
  const bool vec_s = q % 4 == 0 && aligned16(scores);
  const bool vec_h = n % 4 == 0 && aligned16(states);

  ssd_scores_kernel<<<static_cast<unsigned>(grid.scores), kThreads,
                      kSmemBytes, s>>>(fb, fc, fscores, grid.pairs, q, n,
                                       vec_b && vec_c);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_states_kernel<<<dim3(static_cast<unsigned>(grid.states_x),
                           static_cast<unsigned>(grid.states_y)),
                      kThreads, kSmemBytes, s>>>(
      fx, fb, fcum, fstates, heads, chunks, q, p, n,
      static_cast<int>(grid.n_tiles), vec_x, vec_b);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  auto* pass = vec_pass ? ssd_pass_kernel<4> : ssd_pass_kernel<1>;
  pass<<<static_cast<unsigned>(grid.pass), kPassThreads, 0, s>>>(
      fcum, static_cast<const float*>(h0), fstates, static_cast<float*>(h_out),
      chunks, q, p_dim * n_dim, grid.pass_per_bh);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_output_kernel<<<static_cast<unsigned>(grid.output), kThreads,
                      kSmemBytes, s>>>(
      fx, fc, fcum, fscores, fstates, static_cast<float*>(y), heads, chunks,
      q, p, n, static_cast<int>(grid.i_tiles),
      static_cast<int>(grid.p_tiles), h0 == nullptr, vec_x, vec_c, vec_s,
      vec_h);
  return static_cast<int>(cudaGetLastError());
}

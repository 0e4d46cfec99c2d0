// Mamba2 SSD chunk scan (state-space duality), f32 results from Hopper's
// tensor cores: every product as three TF32 products (3xTF32) on wgmma,
// every operand brought in by TMA on an mbarrier ring.
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
// Decomposition: SSD's chunk-parallel form (Dao & Gu 2024, §6; the four
// steps of mamba_ssm's ssd_combined). Only the state carry is sequential,
// and it is elementwise; the three products that do not depend on the
// carried state run for every chunk at once. One launcher enqueues four
// kernels on the caller's stream:
// 1. ssd_scores_kernel: each chunk's C_c B_c^T, which depends on (b, c)
//    only (the heads share B and C, n_groups = 1), once for all heads into
//    a (B, C, Q, Q) scratch, only the 64 x 64 tiles on or below the
//    diagonal.
// 2. ssd_states_kernel: each chunk's own state contribution
//    s_c = (xdt_c ⊙ exp(cum_c[Q-1] - cum_c))^T B_c, a (P, N) matrix, into a
//    (B, H, C, P, N) scratch.
// 3. ssd_pass_kernel: the state carry, one thread per (b, h, 4 elements of
//    the P·N state; 1 where N is not a multiple of 4 or h0 is not 16-byte
//    aligned), walking the chunks in order: it writes the state that
//    enters chunk c over s_c (h0, or 0, at c = 0), then
//    h <- exp(cum_c[Q-1]) h + s_c, and the final state to h_out when
//    asked. Bound by memory; each thread loads 8 chunks ahead of its
//    sequential updates.
// 4. ssd_output_kernel: y = (C_c h_c^T) ⊙ exp(cum_i) + (scores ⊙ L) xdt_c
//    for each (b, c, 128-row tile of i, pair of heads, 64-column tile of p).
//
// The three products run on one Hopper design (sm_90a):
// - Blocks: one producer warpgroup and two consumer warpgroups (384
//   threads), one block an SM, persistent: a block walks the work items
//   blockIdx.x, + gridDim.x, ... and the ring below runs on from one item
//   to the next. The two consumers take what the heads share once: two
//   heads of one chunk in the states and output kernels (B_c, or C_c and
//   the score tile, loaded and split once for both), two column tiles of
//   one row tile in the scores kernel. A consumer's tile is 64 x 64; in
//   the output kernel 128 x 64, its head's xdt_c and h_c shared by two row
//   halves.
// - The ring: stages of k = 32, one 128-byte swizzle row of f32 (as many
//   as fit the 227 KB a block may take: 3 to 5), each with three
//   mbarriers: landed (the TMA copies' bytes), full (the producer's part)
//   and empty (both consumers done). Producer warp 0 issues the copies,
//   one thread, each stage as soon as the consumers free it; warps 1 .. 3
//   (96 threads) do each landed stage's shared work. TMA's zero fill
//   covers every ragged edge (rows past Q through 3-D tensor maps with the
//   chunk as its own dimension, columns past P, N or Q), so nothing is
//   masked at the loads.
// - Operands: for .tf32, wgmma reads both shared-memory operands K-major
//   only. Where an operand is K-major as stored (C_c and B_c for the
//   scores, C_c and h_c for the inter-chunk term) it is split in place, hi
//   over the raw tile and lo beside it: shared memory x shared memory.
//   Where it is not (B_c for the states, xdt_c for the intra-chunk term)
//   TMA lands 32 rows of 64 columns (two 32-column boxes) and it is
//   written transposed into hi and lo tiles (transpose_split). The other
//   operand of those two comes from registers: each consumer thread loads
//   its A fragment (PTX ISA, wgmma .tf32 register A: rows r and r + 8,
//   columns t and t + 4, r = 16 warp + lane / 4, t = lane % 4) from the
//   raw tile, scales it and splits it there: (xdt ⊙ exp(cum_c[Q-1] -
//   cum_c))^T with the factor the producer takes once per column, and the
//   scores with the causal mask and the decay. What the heads share the
//   producer splits or transposes; what is one head's its consumer does,
//   behind a named barrier of its warpgroup. (The producer doing it all
//   ran 1.3x slower: its three warps could not keep up.)
// - The decay never overflows (cum spans more than 88 in a chunk at
//   zamba2's random-weight steps): in the score tile's slices that reach
//   a half's diagonal exp sees cum_i - cum_j only for j <= i (elsewhere
//   -inf, so exp gives 0 without a branch); in the slices left of the tile
//   (j < i0 <= i) it factors as exp(cum_i - cum_i0) exp(cum_i0 - cum_j),
//   the column factor on the fragment (the producer's, once a column) and
//   the row factor on the partial sum as it is added, both <= 1; the
//   inter-chunk term's partials take exp(cum_i) as they are added.
// - Accuracy: a = a_hi + a_lo, each rounded to TF32 (split_tf32 in
//   tf32x3.cuh) and a·b ≈ a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, small products
//   first, so each product carries about 22 of f32's 24 bits and the
//   dropped a_lo·b_lo is below 2^-22 of it. The tensor cores truncate as
//   they add, so a long chain at one magnitude drifts toward zero by up to
//   an ulp each: accumulating a whole k range in the tensor cores'
//   accumulator read 11.2 ulps of the largest output on an H100 against
//   chip_smoke.py's limit of 8. So every stage (four k8 steps, twelve
//   wgmma m64n64k8) starts a fresh accumulator, and the CUDA cores add it
//   into the running sums, rounded to nearest (kPartialStages;
//   bench/ssd_probe.py measures longer ones).
// - What holds it back (an H100; bench/ssd_probe.py and edited copies,
//   PERF.md): not the loads (skipping every copy after the ring's first
//   fill saves 2%, and 4 to 8 stages ran alike) but each consumer's
//   serial chain a stage: its own transform, the A fragments, twelve
//   dependent wgmma, the wait and the adds, with two consumers to overlap
//   them. The split costs 12% of the time, two of the three products 15%.
//   Wider tiles amortise more of the chain, while their registers last:
//   the output kernel's 128-row tiles (halves in turn through one partial
//   sum) took 0.2 ms off 64-row ones; 128 columns in the states kernel,
//   and two partial sums or two fragment sets in the output kernel,
//   spilled and ran slower.
// - Registers: ptxas compiles every role to the launch's 168 a thread and
//   each region after a setmaxnreg to its count: the producer keeps 56 (88
//   in the states kernel, whose producer transposes) and the consumers
//   take the rest (224, 208); the launcher refuses a kernel compiled with
//   fewer than 168. The warpgroup index is broadcast from lane 0: from
//   threadIdx.x / 128 ptxas serialises every wgmma (C7520).
// TMA wants 16-byte aligned operands whose rows are a multiple of 16 bytes
// apart: the Python wrapper copies xdt, bm, cm or cum whose row is not so
// into a buffer whose rows are rounded up to 4 floats (ld_p, ld_n, ld_q),
// and lays out its scores and states scratch the same way.
// Not done here: clusters sharing a TMA load, a TMA store of the outputs,
// keeping the states out of device memory between kernels 2, 3 and 4.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "tf32x3.cuh"

namespace {

constexpr int kThreads = 384;          // a producer, two consumer warpgroups
constexpr int kTransformers = 96;      // producer warps 1 .. 3
constexpr int kConsumerThreads = 256;
// registers a thread with all 384 threads resident (ptxas's budget), and
// what setmaxnreg gives each role: the producer keeps kProducerRegs (88
// in the states kernel, whose producer transposes, else 56) and each
// consumer takes the rest (Regs<88>: 208, Regs<56>: 224)
constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;  // 168
template <int kProducer>
struct Regs {
  static constexpr int kProducerRegs = kProducer;
  static constexpr int kConsumerRegs =
      (kLaunchRegs * kThreads - 128 * kProducer) / 256 / 8 * 8;
  static_assert(128 * kProducerRegs + 256 * kConsumerRegs <=
                    kLaunchRegs * kThreads,
                "registers");
};
constexpr int kTile = 64;              // a consumer's output tile
constexpr int kK = 32;                 // k depth of a stage
static_assert(kK == 32, "a stage is one 128-byte swizzle row of f32");
constexpr int kSteps = kK / 8;         // its k8 steps
constexpr int kRowBytes = kK * 4;      // a K-major tile's rows (swizzle)
constexpr int kTileBytes = kTile * kRowBytes;  // a K-major 64 x kK tile
constexpr int kTileItems = kTileBytes / 16;    // its float4s
constexpr int kBoxBytes = kK * 32 * 4;  // kK rows of a 32-column box
// a tile's float4s (or items of a transpose) a transformer thread takes
constexpr int kTransformerIters =
    (kTileItems + kTransformers - 1) / kTransformers;
constexpr int kVecSlot = 128;          // a stage's vector of kK floats
constexpr int kMaxN = 256;             // the largest state width taken
constexpr int kPassThreads = 256;
constexpr int kPassAhead = 8;          // chunks loaded ahead in the pass
// Stages one partial sum spans before the CUDA cores add it in.
constexpr int kPartialStages = 1;
static_assert(kThreads == 128 + kConsumerThreads &&
                  kTransformers == 96 && kTransformers == kTile + kK,
              "warpgroups");

// The ring in dynamic shared memory: kStages stages of kStageBytes of tiles
// from a 1024-byte aligned base, then kVecs vector slots a stage, then the
// landed (one arrival with the copies' bytes), full (the 96 transforming
// threads) and empty (the 256 consumer threads) mbarriers of each stage.
template <int kStageBytes_, int kVecs_>
struct Ring {
  static constexpr int kStageBytes = kStageBytes_;
  static constexpr int kVecs = kVecs_;
  static constexpr int kPerStage = kStageBytes + kVecs * kVecSlot + 24;
  static constexpr int kStages = (kSmemLimit - 1024) / kPerStage;
  static constexpr int kVecBase = kStages * kStageBytes;
  static constexpr int kBarBase = kVecBase + kStages * kVecs * kVecSlot;
  static constexpr size_t kSmemBytes = 1024 + kBarBase + 24 * kStages;
  static_assert(kStages >= 2 && kSmemBytes <= kSmemLimit, "shared memory");
  static_assert(kStageBytes % 1024 == 0, "stages on the swizzle pattern");

  uint32_t base;        // stage 0, as a shared-memory address
  unsigned char* ptr;   // the same, as a generic pointer

  __device__ explicit Ring(unsigned char* raw) {
    const uint32_t a = smem_u32(raw);
    base = (a + 1023u) & ~1023u;
    ptr = raw + (base - a);
  }
  __device__ uint32_t tile(int s, int off) const {
    return base + s * kStageBytes + off;
  }
  __device__ unsigned char* at(int s, int off) const {
    return ptr + s * kStageBytes + off;
  }
  __device__ uint32_t vec(int s, int v) const {
    return base + kVecBase + (s * kVecs + v) * kVecSlot;
  }
  __device__ float* vec_at(int s, int v) const {
    return reinterpret_cast<float*>(ptr + kVecBase +
                                    (s * kVecs + v) * kVecSlot);
  }
  __device__ uint32_t landed(int s) const { return base + kBarBase + 8 * s; }
  __device__ uint32_t full(int s) const {
    return base + kBarBase + 8 * (kStages + s);
  }
  __device__ uint32_t empty(int s) const {
    return base + kBarBase + 8 * (2 * kStages + s);
  }
  __device__ void init(int tid) const {
    if (tid != 0) return;
    for (int s = 0; s < kStages; ++s) {
      mbar_init(landed(s), 1);
      mbar_init(full(s), kTransformers);
      mbar_init(empty(s), kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// Where a role is in the ring: the stage, its phase bit, and whether every
// stage has been used once (from then on the issuer waits for a stage to
// be emptied before it copies into it).
struct Cursor {
  int s = 0;
  uint32_t phase = 0;
  bool wrapped = false;
  template <int kStages>
  __device__ __forceinline__ void next() {
    if (++s == kStages) {
      s = 0;
      phase ^= 1u;
      wrapped = true;
    }
  }
};

// The issuer's turn at the cursor's stage: waits until the consumers have
// emptied it, then expects `bytes` of copies on its landed barrier.
// Returns whether to issue them.
template <class R>
__device__ __forceinline__ bool claim(const R& ring, const Cursor& c,
                                      uint32_t bytes) {
  if (c.wrapped) mbar_wait(ring.empty(c.s), c.phase ^ 1u);
  const bool load = true;
  mbar_expect_tx(ring.landed(c.s), load ? bytes : 0u);
  return load;
}

// A float at a shared-memory address (32-bit addresses keep the A
// fragments' loop-invariant offsets in half the registers of generic
// pointers); volatile, so it stays after the barrier waits before it.
__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// The 3xTF32 split of tf32x3.cuh (the one place bench/ssd_probe.py's
// no_split variant edits).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  split_tf32(x, hi, lo);
}

// The four floats at `hi` (a raw tile as TMA landed it) split in place: hi
// over them, lo at the same place of the tile kTileBytes on (an
// elementwise split keeps the swizzle).
__device__ __forceinline__ void split4(unsigned char* hi) {
  const float4 x = *reinterpret_cast<const float4*>(hi);
  uint4 h, l;
  split(x.x, h.x, l.x);
  split(x.y, h.y, l.y);
  split(x.z, h.z, l.z);
  split(x.w, h.w, l.w);
  *reinterpret_cast<uint4*>(hi) = h;
  *reinterpret_cast<uint4*>(hi + kTileBytes) = l;
}

// Row `col` of the transpose of `raw` (kK rows of 64 columns as two
// 32-column boxes, 128-byte swizzle), its columns 4 kq .. 4 kq + 3, split
// to `hi` and kTileBytes on (64 rows of kK, 128-byte swizzle). With kq a
// constant the swizzle terms are too, so each of the four loads and the
// two stores takes one XOR; a warp (32 columns) reads one row of a box
// and each quarter writes 8 rows: no bank conflicts either way.
__device__ __forceinline__ void transpose_split(const unsigned char* raw,
                                                unsigned char* hi, int col,
                                                int kq) {
  const unsigned char* box = raw + kBoxBytes * (col / 32);
  const int byte = 4 * (col % 32);
  float x[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    x[e] = *reinterpret_cast<const float*>(
        box + swizzled<128>(4 * kq + e, byte));
  uint4 h, l;
  split(x[0], h.x, l.x);
  split(x[1], h.y, l.y);
  split(x[2], h.z, l.z);
  split(x[3], h.w, l.w);
  const uint32_t dst = swizzled<kRowBytes>(col, 16 * kq);
  *reinterpret_cast<uint4*>(hi + dst) = h;
  *reinterpret_cast<uint4*>(hi + kTileBytes + dst) = l;
}

// A consumer's A fragments of one stage (kSteps k8 steps), split into hi and
// lo. PTX ISA, wgmma .tf32 register A: a0 (r, t), a1 (r + 8, t),
// a2 (r, t + 4), a3 (r + 8, t + 4), r = 16 warp + lane / 4, t = lane % 4.
struct Frag {
  uint32_t hi[kSteps][4], lo[kSteps][4];
};

// Fills `f` from `at(m, k)`, element (m, k) of the warpgroup's 64 x kK A.
template <class At>
__device__ __forceinline__ void a_fragments(Frag& f, int r, int t, At at) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const int k = 8 * kk + t;
    split(at(r, k), f.hi[kk][0], f.lo[kk][0]);
    split(at(r + 8, k), f.hi[kk][1], f.lo[kk][1]);
    split(at(r, k + 4), f.hi[kk][2], f.lo[kk][2]);
    split(at(r + 8, k + 4), f.hi[kk][3], f.lo[kk][3]);
  }
}

// One stage's products into `part`, issued and committed, not waited for:
// lo.hi and hi.lo of every k8 step, then hi.hi (small terms first); `part`
// starts afresh when `fresh`. B is a K-major 64 x kK tile in shared memory
// at b (hi; lo kTileBytes on); A too at a (issue_ss) or the fragments
// (issue_rs), which must not change until retire_products. kProducts
// counts the products from the last (bench/ssd_probe.py's one_product
// runs 1).
constexpr int kProducts = 3;
__device__ __forceinline__ void issue_ss(float (&part)[32], uint32_t a,
                                         uint32_t b, bool fresh) {
  const uint64_t ah = smem_desc<kRowBytes>(a);
  const uint64_t al = smem_desc<kRowBytes>(a + kTileBytes);
  const uint64_t bh = smem_desc<kRowBytes>(b);
  const uint64_t bl = smem_desc<kRowBytes>(b + kTileBytes);
  wgmma_fence();
#pragma unroll
  for (int prod = 3 - kProducts; prod < 3; ++prod)
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
      wgmma_ss<64>(part, desc_add(prod == 0 ? al : ah, 32 * kk),
                   desc_add(prod == 1 ? bl : bh, 32 * kk),
                   fresh && prod == 3 - kProducts && kk == 0 ? 0 : 1);
  wgmma_commit();
}
__device__ __forceinline__ void issue_rs(float (&part)[32], Frag& a,
                                         uint32_t b, bool fresh) {
  const uint64_t bh = smem_desc<kRowBytes>(b);
  const uint64_t bl = smem_desc<kRowBytes>(b + kTileBytes);
  wgmma_fence();
#pragma unroll
  for (int prod = 3 - kProducts; prod < 3; ++prod)
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
      wgmma_rs<64>(part, prod == 0 ? a.lo[kk] : a.hi[kk],
                   desc_add(prod == 1 ? bl : bh, 32 * kk),
                   fresh && prod == 3 - kProducts && kk == 0 ? 0 : 1);
  wgmma_commit();
}
// Waits for the consumer's products: `part` holds them, `a` is free.
__device__ __forceinline__ void retire_products(float (&part)[32]) {
  wgmma_wait_all();
  fence_regs(part);
}
__device__ __forceinline__ void retire_products(float (&part)[32], Frag& a) {
  retire_products(part);
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    fence_regs(a.hi[kk]);
    fence_regs(a.lo[kk]);
  }
}

// The named barrier of consumer warpgroup w (ids 1 and 2; 0 is
// __syncthreads'): its 128 threads' writes to its own tiles are done.
__device__ __forceinline__ void consumer_sync(int w) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
}

// A consumer's pass over the n stages of one work item: for each,
// prepare(c, i) waits for it at cursor c and readies it (the consumer's
// own transforms, A's fragments), issue(c, i) starts its products,
// retire(i) waits for them and adds the partial sum, and the stage goes
// back to the producer. (Preparing stage i + 1 while stage i's products
// run, from a second fragment buffer, measured no faster on an H100.)
template <class R, class Prepare, class Issue, class Retire>
__device__ __forceinline__ void run_stages(const R& ring, Cursor& cur, int n,
                                           Prepare prepare, Issue issue,
                                           Retire retire) {
  for (int i = 0; i < n; ++i, cur.template next<R::kStages>()) {
    prepare(cur, i);
    issue(cur, i);
    retire(i);
    mbar_arrive(ring.empty(cur.s));
  }
}

// The consumer's own part of a stage, a quarter of a tile's float4s a
// thread: split in place (split_own) or transposed (transpose_own), then
// made visible to wgmma across the warpgroup.
__device__ __forceinline__ void split_own(unsigned char* tile, int ct, int w) {
#pragma unroll
  for (int i = 0; i < kTileItems / 128; ++i)
    split4(tile + 16 * (ct + 128 * i));
  fence_async_smem();
  consumer_sync(w);
}
__device__ __forceinline__ void transpose_own(const unsigned char* raw,
                                              unsigned char* hi, int ct,
                                              int w) {
#pragma unroll
  for (int i = 0; i < kK / 8; ++i)  // half the column's 4-float groups
    transpose_split(raw, hi, ct % kTile, kK / 8 * (ct / kTile) + i);
  fence_async_smem();
  consumer_sync(w);
}

// Whether stage i of a run of n starts a partial sum, and whether it ends
// one (which is then added into the running sums).
__device__ __forceinline__ bool starts_partial(int i) {
  return i % kPartialStages == 0;
}
__device__ __forceinline__ bool ends_partial(int i, int n) {
  return (i + 1) % kPartialStages == 0 || i + 1 == n;
}

// acc += part · f on the CUDA cores, rounded once: accumulator element
// 4 j + e is row r + 8 (e / 2) (factor fa for r, fb for r + 8), column
// 8 j + 2 t + e % 2 of the consumer's tile.
__device__ __forceinline__ void add_partial(float (&acc)[32],
                                            const float (&part)[32], float fa,
                                            float fb) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[4 * j] = fmaf(part[4 * j], fa, acc[4 * j]);
    acc[4 * j + 1] = fmaf(part[4 * j + 1], fa, acc[4 * j + 1]);
    acc[4 * j + 2] = fmaf(part[4 * j + 2], fb, acc[4 * j + 2]);
    acc[4 * j + 3] = fmaf(part[4 * j + 3], fb, acc[4 * j + 3]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
}

// Write a consumer's 64 x 64 accumulator at rows row0 .., columns col0 ..
// of a row-major matrix (row stride ld), inside r_end x c_end.
__device__ __forceinline__ void store_acc(float* out, int64_t ld, int row0,
                                          int r_end, int col0, int c_end,
                                          const float (&acc)[32], int r,
                                          int t) {
  const bool pairs = ld % 2 == 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = col0 + 8 * j + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + r + 8 * half;
      if (row >= r_end || col >= c_end) continue;
      float* p = out + row * ld + col;
      const float v0 = acc[4 * j + 2 * half];
      const float v1 = acc[4 * j + 2 * half + 1];
      if (pairs && col + 1 < c_end) {
        *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
      } else {
        p[0] = v0;
        if (col + 1 < c_end) p[1] = v1;
      }
    }
  }
}

// ---- 1. scores ------------------------------------------------------------
// A stage: C_c's 64 rows x 32 (hi, lo), then each consumer's 64 rows of
// B_c (hi, lo).
using ScoresRing = Ring<6 * kTileBytes, 0>;
__host__ __device__ constexpr int scores_b(int w) {
  return 2 * kTileBytes * (1 + w);
}

struct ScoresMaps {
  CUtensorMap cm, bm;  // (N, Q, B·C), boxes of 32 x 64
};

// scores[b, c] = C_c B_c^T on the 64 x 64 tiles (it, jt), jt <= it. Work
// item: (b·C + c, row tile it, pair of column tiles jp); consumer w takes
// column tile 2 jp + w, pairs wholly above the diagonal are skipped. The
// producer splits C_c, each consumer its own B_c tile.
__global__ void __launch_bounds__(kThreads, 1)
ssd_scores_kernel(const __grid_constant__ ScoresMaps maps,
                  float* __restrict__ scores, int64_t bc_count, int q_len,
                  int ld_s, int n) {
  using R = ScoresRing;
  extern __shared__ unsigned char smem_raw[];
  const R ring(smem_raw);
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int q_tiles = (q_len + kTile - 1) / kTile;
  const int pairs = (q_tiles + 1) / 2;
  const int64_t items = bc_count * q_tiles * pairs;
  const int steps = (n + kK - 1) / kK;
  auto decode = [&](int64_t item, int64_t& bc, int& it, int& jp) {
    jp = static_cast<int>(item % pairs);
    item /= pairs;
    it = static_cast<int>(item % q_tiles);
    bc = item / q_tiles;
    return 2 * jp <= it;
  };
  ring.init(tid);
  __syncthreads();

  if (wg == 0) {
    set_max_regs_dec<Regs<56>::kProducerRegs>();
    Cursor cur;
    if (tid == 0) {  // the issuer
      for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
        int64_t bc;
        int it, jp;
        if (!decode(item, bc, it, jp)) continue;
        for (int st = 0; st < steps; ++st, cur.next<R::kStages>()) {
          if (!claim(ring, cur, 3 * kTileBytes)) continue;
          const uint32_t bar = ring.landed(cur.s);
          tma_load_3d(ring.tile(cur.s, 0), &maps.cm, bar, kK * st,
                      kTile * it, static_cast<int>(bc));
#pragma unroll
          for (int w = 0; w < 2; ++w)
            tma_load_3d(ring.tile(cur.s, scores_b(w)), &maps.bm, bar,
                        kK * st, kTile * (2 * jp + w), static_cast<int>(bc));
        }
      }
    } else if (tid >= 32) {  // the transformers: C_c split in place
      for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
        int64_t bc;
        int it, jp;
        if (!decode(item, bc, it, jp)) continue;
        for (int st = 0; st < steps; ++st, cur.next<R::kStages>()) {
          mbar_wait(ring.landed(cur.s), cur.phase);
          unsigned char* stage = ring.at(cur.s, 0);
#pragma unroll 4
          for (int i = 0; i < kTransformerIters; ++i) {
            const int idx = tid - 32 + kTransformers * i;
            if (idx < kTileItems) split4(stage + 16 * idx);
          }
          fence_async_smem();
          mbar_arrive(ring.full(cur.s));
        }
      }
    }
    return;
  }

  set_max_regs_inc<Regs<56>::kConsumerRegs>();
  const int w = wg - 1;
  const int ct = tid % 128;
  const int r = 16 * (ct / 32) + ct % 32 / 4;
  const int t = ct % 4;
  Cursor cur;
  float part[32];
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    int64_t bc;
    int it, jp;
    if (!decode(item, bc, it, jp)) continue;
    const int jt = 2 * jp + w;
    const bool active = jt <= it;
    float acc[32];
    zero(acc);
    run_stages(
        ring, cur, steps,
        [&](const Cursor& c, int) {
          mbar_wait(ring.landed(c.s), c.phase);
          mbar_wait(ring.full(c.s), c.phase);
          if (active) split_own(ring.at(c.s, scores_b(w)), ct, w);
        },
        [&](const Cursor& c, int st) {
          if (active)
            issue_ss(part, ring.tile(c.s, 0), ring.tile(c.s, scores_b(w)),
                     starts_partial(st));
        },
        [&](int st) {
          if (!active) return;
          retire_products(part);
          if (ends_partial(st, steps)) add_partial(acc, part, 1.0f, 1.0f);
        });
    if (active)
      store_acc(scores + bc * q_len * ld_s, ld_s, kTile * it, q_len,
                kTile * jt, q_len, acc, r, t);
  }
}

// ---- 2. states ------------------------------------------------------------
// A stage: B_c's raw 32 x 64, B_c^T hi and lo (64 x 32), each head's raw
// xdt 32 x 64; vectors: each head's cum (2 w) and decay (2 w + 1).
using StatesRing = Ring<5 * kTileBytes, 4>;
constexpr int kStatesBt = kTileBytes;
__host__ __device__ constexpr int states_x(int w) {
  return kTileBytes * (3 + w);
}

struct StatesMaps {
  CUtensorMap xdt;  // (P, Q, B·H·C), boxes of 32 x 32
  CUtensorMap bm;   // (N, Q, B·C), boxes of 32 x 32
  CUtensorMap cum;  // (Q, B·H·C), boxes of 32
};

// states[b, h, c] = (xdt_c ⊙ exp(cum_c[Q-1] - cum_c))^T B_c. Work item:
// (b·C + c, pair of heads hp, 64 rows of p, 64 columns of n); consumer w
// takes head 2 hp + w. The producer transposes B_c and takes each head's
// decay; each consumer builds its A from its head's raw xdt.
__global__ void __launch_bounds__(kThreads, 1)
ssd_states_kernel(const __grid_constant__ StatesMaps maps,
                  const float* __restrict__ cum, float* __restrict__ states,
                  int64_t bc_count, int heads, int64_t chunks, int q_len,
                  int ld_q, int p_dim, int n, int ld_n) {
  using R = StatesRing;
  extern __shared__ unsigned char smem_raw[];
  const R ring(smem_raw);
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int head_pairs = (heads + 1) / 2;
  const int p_tiles = (p_dim + kTile - 1) / kTile;
  const int n_tiles = (n + kTile - 1) / kTile;
  const int64_t items = bc_count * head_pairs * p_tiles * n_tiles;
  const int steps = (q_len + kK - 1) / kK;
  struct Item {
    int64_t bc, bhc;  // bhc of head 2 hp; the other's is bhc + chunks
    int n_heads, pt, nt;
  };
  auto decode = [&](int64_t item) {
    Item x;
    x.nt = static_cast<int>(item % n_tiles);
    item /= n_tiles;
    x.pt = static_cast<int>(item % p_tiles);
    item /= p_tiles;
    const int hp = static_cast<int>(item % head_pairs);
    x.bc = item / head_pairs;
    x.bhc = ((x.bc / chunks) * heads + 2 * hp) * chunks + x.bc % chunks;
    x.n_heads = min(2, heads - 2 * hp);
    return x;
  };
  ring.init(tid);
  __syncthreads();

  if (wg == 0) {
    set_max_regs_dec<Regs<88>::kProducerRegs>();
    Cursor cur;
    if (tid == 0) {
      for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
        const Item x = decode(item);
        for (int st = 0; st < steps; ++st, cur.next<R::kStages>()) {
          if (!claim(ring, cur,
                     kTileBytes + x.n_heads * (kTileBytes + 4 * kK)))
            continue;
          const uint32_t bar = ring.landed(cur.s);
#pragma unroll
          for (int bx = 0; bx < 2; ++bx)
            tma_load_3d(ring.tile(cur.s, kBoxBytes * bx), &maps.bm, bar,
                        kTile * x.nt + 32 * bx, kK * st,
                        static_cast<int>(x.bc));
          for (int w = 0; w < x.n_heads; ++w) {
            const int bhc = static_cast<int>(x.bhc + w * chunks);
#pragma unroll
            for (int bx = 0; bx < 2; ++bx)
              tma_load_3d(ring.tile(cur.s, states_x(w) + kBoxBytes * bx),
                          &maps.xdt, bar, kTile * x.pt + 32 * bx, kK * st,
                          bhc);
            tma_load_2d(ring.vec(cur.s, 2 * w), &maps.cum, bar, kK * st, bhc);
          }
        }
      }
    } else if (tid >= 32) {  // B_c transposed and split; the decay
      const int tt = tid - 32;
      for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
        const Item x = decode(item);
        // threads 0 .. 63 transpose a column each; 64 .. 95 take the
        // decay of position tt - 64 of both heads, from cum_c[Q-1]
        float last[2];
#pragma unroll
        for (int w = 0; w < 2; ++w)
          last[w] = w < x.n_heads
                        ? cum[(x.bhc + w * chunks) * ld_q + q_len - 1]
                        : 0.0f;
        for (int st = 0; st < steps; ++st, cur.next<R::kStages>()) {
          mbar_wait(ring.landed(cur.s), cur.phase);
          unsigned char* stage = ring.at(cur.s, 0);
          if (tt < kTile) {
            // in two passes of four 4-float groups (all eight at once
            // spill)
#pragma unroll 1
            for (int pass = 0; pass < 2; ++pass)
#pragma unroll
              for (int kq = 0; kq < kK / 8; ++kq)
                transpose_split(stage, stage + kStatesBt, tt,
                                kK / 8 * pass + kq);
          } else {
            // past Q cum reads 0: exp(last) <= 1 times a zero row of xdt
#pragma unroll
            for (int w = 0; w < 2; ++w)
              if (w < x.n_heads)
                ring.vec_at(cur.s, 2 * w + 1)[tt - kTile] =
                    expf(last[w] - ring.vec_at(cur.s, 2 * w)[tt - kTile]);
          }
          fence_async_smem();
          mbar_arrive(ring.full(cur.s));
        }
      }
    }
    return;
  }

  set_max_regs_inc<Regs<88>::kConsumerRegs>();
  const int w = wg - 1;
  const int ct = tid % 128;
  const int r = 16 * (ct / 32) + ct % 32 / 4;
  const int t = ct % 4;
  Cursor cur;
  float part[32];
  Frag a;
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    const Item x = decode(item);
    const bool active = w < x.n_heads;
    float acc[32];
    zero(acc);
    run_stages(
        ring, cur, steps,
        [&](const Cursor& c, int) {
          mbar_wait(ring.landed(c.s), c.phase);  // the raw xdt
          mbar_wait(ring.full(c.s), c.phase);
          if (!active) return;
          const uint32_t xs = ring.tile(c.s, states_x(w));
          const uint32_t d = ring.vec(c.s, 2 * w + 1);
          // A = (xdt ⊙ d)^T: element (p, q) is the raw tile's (q, p)
          a_fragments(a, r, t, [&](int m, int k) {
            return lds(xs + kBoxBytes * (m / 32) +
                       swizzled<128>(k, 4 * (m % 32))) *
                   lds(d + 4 * k);
          });
        },
        [&](const Cursor& c, int st) {
          if (active)
            issue_rs(part, a, ring.tile(c.s, kStatesBt), starts_partial(st));
        },
        [&](int st) {
          if (!active) return;
          retire_products(part, a);
          if (ends_partial(st, steps)) add_partial(acc, part, 1.0f, 1.0f);
        });
    if (active)
      store_acc(states + (x.bhc + w * chunks) * p_dim * ld_n, ld_n,
                kTile * x.pt, p_dim, kTile * x.nt, n, acc, r, t);
  }
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

// ---- 3. the state carry ---------------------------------------------------
// Over the chunks of one (b, h), VEC state elements a thread (4 where N is
// a multiple of 4, so that a chunk's (P, ld_n) state is dense, and h0
// 16-byte aligned): states[b, h, c] becomes the state entering chunk c;
// h_out (if given) the state after the last.
template <int VEC>
__global__ void __launch_bounds__(kPassThreads)
ssd_pass_kernel(const float* __restrict__ cum, const float* __restrict__ h0,
                float* states, float* __restrict__ h_out, int64_t chunks,
                int q_len, int ld_q, int n, int ld_n, int64_t pn,
                int64_t ld_pn, int64_t blocks_per_bh) {
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
  float* st =
      states + bh * chunks * ld_pn + (VEC == 4 ? e : e / n * ld_n + e % n);
  const float* last = cum + bh * chunks * ld_q + (q_len - 1);
  for (int64_t c0 = 0; c0 < chunks; c0 += kPassAhead) {
    float s[kPassAhead][VEC], d[kPassAhead];
#pragma unroll
    for (int u = 0; u < kPassAhead; ++u) {
      if (c0 + u < chunks) {
        load_vec(s[u], st + (c0 + u) * ld_pn);
        d[u] = expf(last[(c0 + u) * ld_q]);
      }
    }
#pragma unroll
    for (int u = 0; u < kPassAhead; ++u) {
      if (c0 + u < chunks) {
        store_vec(st + (c0 + u) * ld_pn, h);
#pragma unroll
        for (int v = 0; v < VEC; ++v) h[v] = fmaf(d[u], h[v], s[u][v]);
      }
    }
  }
  if (h_out != nullptr) store_vec(h_out + bh * pn + e, h);
}

// ---- 4. output ------------------------------------------------------------
// A work item's rows: 128 of i, two halves of 64, each consumer both.
constexpr int kOutRows = 2 * kTile;
// A stage of the intra-chunk term: the raw score tile (128 rows of i x 32
// of j; half hh at kTileBytes · hh) at 0, each head's raw xdt (32 x 64) at
// output_x(w) with its transpose's hi and lo after it; of the inter-chunk
// term: C_c (half hh's hi and lo at 2 kTileBytes · hh), each head's state
// h_c (64 rows of p x 32 of n; hi, lo) at output_h(w). Vectors: each
// head's cum (2 w) and column factor (2 w + 1).
using OutputRing = Ring<8 * kTileBytes, 4>;
__host__ __device__ constexpr int output_x(int w) {
  return kTileBytes * (2 + 3 * w);
}
__host__ __device__ constexpr int output_h(int w) {
  return kTileBytes * (4 + 2 * w);
}

struct OutputMaps {
  CUtensorMap scores;  // (Q, Q, B·C), boxes of 32 x 64
  CUtensorMap cm;      // (N, Q, B·C), boxes of 32 x 64
  CUtensorMap states;  // (N, P, B·H·C), boxes of 32 x 64
  CUtensorMap xdt;     // (P, Q, B·H·C), boxes of 32 x 32
  CUtensorMap cum;     // (Q, B·H·C), boxes of 32
};

// y[b, h, c] rows i0 .. i0 + 127, columns p0 .. p0 + 63:
// (C_c h_c^T) ⊙ exp(cum_i) + (scores ⊙ L) xdt_c. Work item, fastest first:
// p tile, pair of heads (consumer w takes head 2 hp + w), 128-row tile of
// i (the last first), b·C + c: the items that read one chunk's scores,
// C_c, h_c and xdt_c run side by side, so all but the first read them
// from L2, and a block's items rotate through the i tiles. The inter-chunk
// term's stages come first (none at c = 0 without h0), then the
// intra-chunk term's column slices up to the tile's diagonal; a half
// skips the slices wholly above its rows, and the lower half's rows past
// Q. The producer splits C_c and takes each head's column factors; each
// consumer splits its head's h_c and transposes its head's xdt. Every
// partial sum is one stage long here (kPartialStages is the scores' and
// the states'): the inter-chunk stages take one for each row half, the
// intra-chunk stages run the halves in turn through one.
__global__ void __launch_bounds__(kThreads, 1)
ssd_output_kernel(const __grid_constant__ OutputMaps maps,
                  const float* __restrict__ cum, float* __restrict__ y,
                  int64_t bc_count, int heads, int64_t chunks, int q_len,
                  int ld_q, int p_dim, int n, int zero_h0) {
  using R = OutputRing;
  extern __shared__ unsigned char smem_raw[];
  const R ring(smem_raw);
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int i_tiles = (q_len + kOutRows - 1) / kOutRows;
  const int head_pairs = (heads + 1) / 2;
  const int p_tiles = (p_dim + kTile - 1) / kTile;
  const int64_t items = i_tiles * bc_count * head_pairs * p_tiles;
  struct Item {
    int64_t bc, bhc;  // bhc of head 2 hp; the other's is bhc + chunks
    int n_heads, pt, i0, halves;  // halves: 2, or 1 where Q ends in the first
    int n_inter, n_off, n_intra;  // stages: inter, left of the tile, intra
  };
  auto decode = [&](int64_t item) {
    Item x;
    x.pt = static_cast<int>(item % p_tiles);
    item /= p_tiles;
    const int hp = static_cast<int>(item % head_pairs);
    item /= head_pairs;
    x.i0 = kOutRows * (i_tiles - 1 - static_cast<int>(item % i_tiles));
    x.bc = item / i_tiles;
    const int64_t c = x.bc % chunks;
    x.bhc = ((x.bc / chunks) * heads + 2 * hp) * chunks + c;
    x.n_heads = min(2, heads - 2 * hp);
    x.halves = x.i0 + kTile < q_len ? 2 : 1;
    // the state entering chunk 0 is zero without h0: no inter-chunk term
    x.n_inter = c == 0 && zero_h0 ? 0 : (n + kK - 1) / kK;
    x.n_off = x.i0 / kK;
    x.n_intra = (min(x.i0 + kOutRows, q_len) + kK - 1) / kK;
    return x;
  };
  ring.init(tid);
  __syncthreads();

  if (wg == 0) {
    set_max_regs_dec<Regs<56>::kProducerRegs>();
    Cursor cur;
    if (tid == 0) {
      for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
        const Item x = decode(item);
        const int bc = static_cast<int>(x.bc);
        for (int st = 0; st < x.n_inter + x.n_intra;
             ++st, cur.next<R::kStages>()) {
          const bool inter = st < x.n_inter;
          if (!claim(ring, cur,
                     inter ? kTileBytes * (2 + x.n_heads)
                           : 2 * kTileBytes +
                                 x.n_heads * (kTileBytes + 4 * kK)))
            continue;
          const uint32_t bar = ring.landed(cur.s);
          if (inter) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              tma_load_3d(ring.tile(cur.s, 2 * kTileBytes * hh), &maps.cm,
                          bar, kK * st, x.i0 + kTile * hh, bc);
            for (int w = 0; w < x.n_heads; ++w)
              tma_load_3d(ring.tile(cur.s, output_h(w)), &maps.states, bar,
                          kK * st, kTile * x.pt,
                          static_cast<int>(x.bhc + w * chunks));
            continue;
          }
          const int j0 = kK * (st - x.n_inter);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            tma_load_3d(ring.tile(cur.s, kTileBytes * hh), &maps.scores, bar,
                        j0, x.i0 + kTile * hh, bc);
          for (int w = 0; w < x.n_heads; ++w) {
            const int bhc = static_cast<int>(x.bhc + w * chunks);
#pragma unroll
            for (int bx = 0; bx < 2; ++bx)
              tma_load_3d(ring.tile(cur.s, output_x(w) + kBoxBytes * bx),
                          &maps.xdt, bar, kTile * x.pt + 32 * bx, j0, bhc);
            tma_load_2d(ring.vec(cur.s, 2 * w), &maps.cum, bar, j0, bhc);
          }
        }
      }
    } else if (tid >= 32) {
      // inter stages: C_c split in place; intra stages left of the tile:
      // each head's column factor exp(cum_i0 - cum_j)
      const int tt = tid - 32;
      for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
        const Item x = decode(item);
        const int w = tt / kK;
        const bool has_head = tt < 2 * kK && w < x.n_heads;
        const float cum_i0 =
            has_head ? cum[(x.bhc + w * chunks) * ld_q + x.i0] : 0.0f;
        for (int st = 0; st < x.n_inter + x.n_intra;
             ++st, cur.next<R::kStages>()) {
          mbar_wait(ring.landed(cur.s), cur.phase);
          if (st < x.n_inter) {
            unsigned char* stage = ring.at(cur.s, 0);
#pragma unroll 4
            for (int i = 0; i < 2 * kTransformerIters; ++i) {
              const int idx = tt + kTransformers * i;
              if (idx < 2 * kTileItems)
                split4(stage + 2 * kTileBytes * (idx / kTileItems) +
                       16 * (idx % kTileItems));
            }
          } else if (has_head && st - x.n_inter < x.n_off) {
            ring.vec_at(cur.s, 2 * w + 1)[tt % kK] =
                expf(cum_i0 - ring.vec_at(cur.s, 2 * w)[tt % kK]);
          }
          fence_async_smem();
          mbar_arrive(ring.full(cur.s));
        }
      }
    }
    return;
  }

  set_max_regs_inc<Regs<56>::kConsumerRegs>();
  const int w = wg - 1;
  const int ct = tid % 128;
  const int r = 16 * (ct / 32) + ct % 32 / 4;
  const int t = ct % 4;
  Cursor cur;
  float part[32];
  Frag a;
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    const Item x = decode(item);
    const bool active = w < x.n_heads;
    const int64_t bhc = x.bhc + w * chunks;
    // cum of the tile's first row and of the thread's rows
    // i0 + 64 hh + r (+ 8) (rows past Q, which are not stored, take the
    // first's); the partial sums' row factors: exp(cum_i) for the
    // inter-chunk term, exp(cum_i - cum_i0) left of the tile
    const float* cu = cum + (active ? bhc : 0) * ld_q;
    const float cu_0 = cu[x.i0];
    float cu_row[2][2], f_inter[2][2], f_left[2][2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = x.i0 + kTile * hh + r + 8 * e;
        cu_row[hh][e] = row < q_len ? cu[row] : cu_0;
        f_inter[hh][e] = expf(cu_row[hh][e]);
        f_left[hh][e] = expf(cu_row[hh][e] - cu_0);
      }
    const int n_left = x.n_inter + x.n_off;  // stages before the diagonal
    // the upper half's diagonal stages: up to its last row
    const int n_diag0 = min(kTile / kK, x.n_intra - x.n_off);
    float acc[2][32];
    zero(acc[0]);
    zero(acc[1]);
    run_stages(
        ring, cur, x.n_inter + x.n_intra,
        [&](const Cursor& c, int st) {
          mbar_wait(ring.landed(c.s), c.phase);
          mbar_wait(ring.full(c.s), c.phase);
          if (!active) return;
          unsigned char* stage = ring.at(c.s, 0);
          if (st < x.n_inter)
            split_own(stage + output_h(w), ct, w);
          else
            transpose_own(stage + output_x(w),
                          stage + output_x(w) + kTileBytes, ct, w);
        },
        [&](const Cursor& c, int st) {
          if (!active) return;
          // the row halves in turn through one partial sum (two would not
          // fit the registers)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            if (hh == x.halves) break;
            if (st < x.n_inter) {
              issue_ss(part, ring.tile(c.s, 2 * kTileBytes * hh),
                       ring.tile(c.s, output_h(w)), true);
              retire_products(part);
              add_partial(acc[hh], part, f_inter[hh][0], f_inter[hh][1]);
              continue;
            }
            const bool left = st < n_left;
            // the upper half stops at its diagonal
            if (!left && hh == 0 && st - n_left >= n_diag0) continue;
            const uint32_t ss = ring.tile(c.s, kTileBytes * hh);
            auto score = [&](int m, int k) {
              return lds(ss + swizzled<kRowBytes>(m, 4 * k));
            };
            if (left) {
              const uint32_t colf = ring.vec(c.s, 2 * w + 1);
              a_fragments(a, r, t, [&](int m, int k) {
                return score(m, k) * lds(colf + 4 * k);
              });
            } else {
              // the decay only on and below the diagonal, inside Q:
              // elsewhere exp(-inf) = 0, so nothing overflows and no
              // branch is taken
              const uint32_t cum_j = ring.vec(c.s, 2 * w);
              const int j0 = kK * (st - x.n_inter);
              a_fragments(a, r, t, [&](int m, int k) {
                const int row = x.i0 + kTile * hh + m;
                const bool on = j0 + k <= row && row < q_len;
                const float d =
                    cu_row[hh][m == r ? 0 : 1] - lds(cum_j + 4 * k);
                return score(m, k) * expf(on ? d : -INFINITY);
              });
            }
            issue_rs(part, a, ring.tile(c.s, output_x(w) + kTileBytes),
                     true);
            retire_products(part, a);
            if (left)
              add_partial(acc[hh], part, f_left[hh][0], f_left[hh][1]);
            else
              add_partial(acc[hh], part, 1.0f, 1.0f);
          }
        },
        [&](int) {});
    if (active) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        store_acc(y + bhc * q_len * p_dim, p_dim, x.i0 + kTile * hh, q_len,
                  kTile * x.pt, p_dim, acc[hh], r, t);
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// The work of each kernel at one shape (see the Python wrapper's ops.grid
// and ops.work_items, which mirror it): the persistent kernels' items and
// blocks (one an SM at most), the state carry's blocks. False if a grid or
// a tensor map's chunk coordinate passes its limit.
struct Grid {
  int64_t scores_items, states_items, output_items;
  int64_t scores, states, output, pass, pass_per_bh;
};

bool make_grid(int64_t batch, int64_t heads, int64_t chunks, int64_t q_len,
               int64_t p_dim, int64_t n_dim, int pass_vec, int64_t sms,
               Grid* g) {
  const int64_t bc = batch * chunks;
  const int64_t q_tiles = cdiv(q_len, kTile);
  const int64_t head_pairs = cdiv(heads, 2);
  const int64_t p_tiles = cdiv(p_dim, kTile);
  g->scores_items = bc * q_tiles * cdiv(q_tiles, 2);
  g->states_items = bc * head_pairs * p_tiles * cdiv(n_dim, kTile);
  g->output_items = cdiv(q_len, kOutRows) * bc * head_pairs * p_tiles;
  g->scores = g->scores_items < sms ? g->scores_items : sms;
  g->states = g->states_items < sms ? g->states_items : sms;
  g->output = g->output_items < sms ? g->output_items : sms;
  g->pass_per_bh = cdiv(p_dim * n_dim, kPassThreads * pass_vec);
  g->pass = g->pass_per_bh * batch * heads;
  return g->pass <= 0x7fffffff && batch * heads * chunks <= 0x7fffffff;
}

// A row-major f32 tensor of `depth` matrices (rows, cols), rows ld floats
// apart, as a 3-D tensor map with (32, box_rows, 1) boxes swizzled across
// their 128-byte rows. Reads past cols, rows or depth are zeros.
CUresult make_map3(CUtensorMap* map, const void* ptr, int64_t cols,
                   int64_t rows, int64_t depth, int64_t ld, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(depth)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * 4,
                                 static_cast<cuuint64_t>(rows * ld) * 4};
  const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// cum (B·H·C rows of q_len, ld_q apart) as a 2-D map with boxes of kK.
CUresult make_cum_map(CUtensorMap* map, const void* ptr, int64_t q_len,
                      int64_t rows, int64_t ld_q) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(q_len),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld_q) * 4};
  const cuuint32_t box[2] = {kK, 1};
  const cuuint32_t elem[2] = {1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

const void* const kKernels[] = {
    reinterpret_cast<const void*>(ssd_scores_kernel),
    reinterpret_cast<const void*>(ssd_states_kernel),
    reinterpret_cast<const void*>(ssd_pass_kernel<4>),
    reinterpret_cast<const void*>(ssd_output_kernel)};
constexpr int kKernelThreads[] = {kThreads, kThreads, kPassThreads, kThreads};
constexpr int kKernelSmem[] = {static_cast<int>(ScoresRing::kSmemBytes),
                               static_cast<int>(StatesRing::kSmemBytes), 0,
                               static_cast<int>(OutputRing::kSmemBytes)};

// Opts the tensor-core kernels in to their shared memory on the current
// device, and checks (once) that each was compiled with the registers its
// setmaxnreg moves need: a kernel launched with fewer would hang in
// setmaxnreg.inc.
cudaError_t prepare_kernels() {
  static const cudaError_t regs = [] {
    for (int k = 0; k < 4; ++k) {
      if (kKernelSmem[k] == 0) continue;
      cudaFuncAttributes fa;
      const cudaError_t err = cudaFuncGetAttributes(&fa, kKernels[k]);
      if (err != cudaSuccess) return err;
      if (fa.numRegs < kLaunchRegs) return cudaErrorInvalidConfiguration;
    }
    return cudaSuccess;
  }();
  if (regs != cudaSuccess) return regs;
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
  cudaError_t err = prepare_kernels();
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kKernels[which], kKernelThreads[which], kKernelSmem[which]);
  info[0] = kKernelThreads[which];
  info[1] = kKernelSmem[which];
  info[2] = blocks;
  return static_cast<int>(err);
}

// Launcher: f32 operands in the layouts above, each row-major with rows
// ld_p (xdt), ld_n (bm, cm) and ld_q (cum) floats apart (multiples of 4,
// at least P, N and Q); `scores`, a (B, C, Q, ld_q) f32 scratch (only its
// tiles on or below the diagonal are written and read), and `states`, a
// (B, H, C, P, ld_n) f32 scratch. y is dense (B, H, C, Q, P); h0 and h_out
// (dense (B, H, P, N)) may be null (a zero initial state; no final state
// written). Makes `device` current, enqueues the four kernels on `stream`
// and returns cudaGetLastError() after each, or an error of its own:
// cudaErrorInvalidValue for a size out of range, cudaErrorMisalignedAddress
// for an operand not 16-byte aligned, cudaErrorInvalidConfiguration for a
// kernel compiled with too few registers, 100000 + CUresult for a refused
// tensor map (99999 without cuTensorMapEncodeTiled).
extern "C" int rt_ssd_chunk_scan_f32(
    const void* xdt, const void* bm, const void* cm, const void* cum,
    const void* h0, void* y, void* h_out, void* scores, void* states,
    int64_t batch, int64_t heads, int64_t chunks, int64_t q_len,
    int64_t p_dim, int64_t n_dim, int64_t ld_p, int64_t ld_n, int64_t ld_q,
    int device, void* stream) {
  const bool vec_pass =
      n_dim % 4 == 0 && (h0 == nullptr || aligned16(h0));
  if (batch < 0 || heads < 0 || chunks < 0 || q_len < 1 || p_dim < 1 ||
      n_dim < 1 || n_dim > kMaxN || q_len > 0x7fffffff ||
      p_dim > 0x7fffffff || heads > 0x7fffffff || ld_p < p_dim ||
      ld_n < n_dim || ld_q < q_len || ld_p % 4 != 0 || ld_n % 4 != 0 ||
      ld_q % 4 != 0 || ld_p > 0x7fffffff || ld_q > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || heads == 0 || chunks == 0) return 0;
  if (!aligned16(xdt) || !aligned16(bm) || !aligned16(cm) ||
      !aligned16(cum) || !aligned16(scores) || !aligned16(states) ||
      !aligned16(y))
    return static_cast<int>(cudaErrorMisalignedAddress);
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Grid grid;
  if (!make_grid(batch, heads, chunks, q_len, p_dim, n_dim, vec_pass ? 4 : 1,
                 sms, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  if (encode_tiled() == nullptr) return kMapError - 1;
  if ((err = prepare_kernels()) != cudaSuccess) return static_cast<int>(err);
  const int64_t bc = batch * chunks;
  const int64_t bhc = batch * heads * chunks;
  ScoresMaps sm;
  StatesMaps tm;
  OutputMaps om;
  memset(&sm, 0, sizeof(sm));
  memset(&tm, 0, sizeof(tm));
  memset(&om, 0, sizeof(om));
  CUresult r = make_map3(&sm.cm, cm, n_dim, q_len, bc, ld_n, kTile);
  if (r == CUDA_SUCCESS)
    r = make_map3(&sm.bm, bm, n_dim, q_len, bc, ld_n, kTile);
  if (r == CUDA_SUCCESS)
    r = make_map3(&tm.xdt, xdt, p_dim, q_len, bhc, ld_p, kK);
  if (r == CUDA_SUCCESS)
    r = make_map3(&tm.bm, bm, n_dim, q_len, bc, ld_n, kK);
  if (r == CUDA_SUCCESS) r = make_cum_map(&tm.cum, cum, q_len, bhc, ld_q);
  if (r == CUDA_SUCCESS)
    r = make_map3(&om.scores, scores, q_len, q_len, bc, ld_q, kTile);
  if (r == CUDA_SUCCESS)
    r = make_map3(&om.states, states, n_dim, p_dim, bhc, ld_n, kTile);
  if (r != CUDA_SUCCESS) return kMapError + static_cast<int>(r);
  om.cm = sm.cm;
  om.xdt = tm.xdt;
  om.cum = tm.cum;

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int q = static_cast<int>(q_len);
  const int p = static_cast<int>(p_dim);
  const int n = static_cast<int>(n_dim);
  const int h = static_cast<int>(heads);
  const float* fcum = static_cast<const float*>(cum);
  ssd_scores_kernel<<<static_cast<unsigned>(grid.scores), kThreads,
                      ScoresRing::kSmemBytes, s>>>(
      sm, static_cast<float*>(scores), bc, q, static_cast<int>(ld_q), n);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_states_kernel<<<static_cast<unsigned>(grid.states), kThreads,
                      StatesRing::kSmemBytes, s>>>(
      tm, fcum, static_cast<float*>(states), bc, h, chunks, q,
      static_cast<int>(ld_q), p, n, static_cast<int>(ld_n));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  auto* pass = vec_pass ? ssd_pass_kernel<4> : ssd_pass_kernel<1>;
  pass<<<static_cast<unsigned>(grid.pass), kPassThreads, 0, s>>>(
      fcum, static_cast<const float*>(h0), static_cast<float*>(states),
      static_cast<float*>(h_out), chunks, q, static_cast<int>(ld_q), n,
      static_cast<int>(ld_n), p_dim * n_dim, p_dim * ld_n, grid.pass_per_bh);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_output_kernel<<<static_cast<unsigned>(grid.output), kThreads,
                      OutputRing::kSmemBytes, s>>>(
      om, fcum, static_cast<float*>(y), bc, h, chunks, q,
      static_cast<int>(ld_q), p, n, h0 == nullptr ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

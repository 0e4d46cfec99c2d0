// Blocked GEMM, C = A @ B, in full f32 on the CUDA cores, built for Hopper:
// a TMA ring that one producer warp fills on mbarriers, feeding consumer
// warps that only read shared memory and multiply.
//
// Replaces: src/repro/kernels/matmul/matmul.py:27, _matmul_kernel /
// matmul_pallas (with the tile padding of ops.matmul), for float32
// operands. bfloat16 operands take matmul_sm90.cu, on the tensor cores.
// The design this one replaced (a two-stage cp.async ring, A staged
// through registers and stored transposed, a __syncthreads a k slice) is
// baseline/matmul_cuda_cores.cu, outside the kernel library.
//
// Computes C = A B for row-major A (m, k), B (k, n) and C (m, n), f32, each
// output one fmaf chain over k in increasing order from 0.0f: the same
// sum, bit for bit, as the replaced design at every tile. wgmma is not
// used: on f32 operands it computes in TF32.
//
// Bound on the card: operations. The tile search's product, 4096 x 2048 x
// 6144, is 2mnk = 103.1 GFLOP against 0.15 GB of operands, far above the
// ridge point; the roof is the CUDA cores' 67 TFLOP/s (data sheet, 700 W):
// 1.5385 ms. An SM issues one warp instruction a clock on each of its four
// schedulers and does 128 FMAs a clock, so the FMA units are fed only when
// nearly every instruction a consumer issues is an FFMA and its operands
// arrive in time: the design takes the loads, their addresses and the
// barriers off the consumers.
//
// Design.
// - Blocks: one per (BM, BN) output tile, (BM, BN, BK) in {64, 128}^2 x
//   {8, 16, 32} (RT_MATMUL_F32_SM90_TILES). The TPU's sequential k grid
//   axis and its f32 VMEM accumulator become a k loop of BK-deep slices
//   with the accumulator in registers.
// - Ring: kStages = 3 stages in dynamic shared memory, each A's (BM, BK)
//   slice and B's (BK, BN) slice, with a full and an empty mbarrier. The
//   ring follows the tile (13,360 bytes at 64 x 64 x 8, 99,376 at 128 x
//   128 x 32), so that a smaller per-block limit still keeps the smaller
//   tiles. A fourth stage measured the same.
// - Producer: one warp, or a whole warpgroup where the consumers are whole
//   warpgroups, so that setmaxnreg can move its registers to them (every
//   tile but 64 x 64). Its first thread keeps the TMA loads of both slices
//   in flight, each stage as soon as every consumer has arrived on its
//   empty barrier. Rows and columns past m, n or k are TMA's zero fill.
//   No __syncthreads in the k loop: the consumers wait on a stage's full
//   barrier and arrive on its empty one.
// - Consumers: each thread owns a kTM x kTN = 8 x 8 register tile: rows
//   wm + ty + 8 i and columns wn + 4 tx + 16 j of its warp's 64 x 32 part
//   (lane = 4 ty + tx). TMA does not transpose, so A stays row-major: one
//   read gives kAK = 2 consecutive k values of a row (8 bytes), and the k
//   loop runs in pairs; B gives one row of the (BK, BN) slice a k step, 2
//   16-byte reads. Per pair a thread reads 8 words of A and 4 of B for 128
//   FMAs (one byte of shared memory a FMA). Measured on the H100 at the
//   tile search's shape, this tile ran faster than 8 x 16 (0.75 bytes a
//   FMA, 128 accumulators: fewer warps, and ptxas spaced the reads less)
//   and 2 k values a read of A faster than 4 or 1.
// - Bank conflicts: A's rows are BK * 4 = 32, 64 or 128 bytes, swizzled by
//   TMA across the row (32B, 64B, 128B swizzle: 16-byte chunk g of row r
//   lies at chunk g ^ ((r * BK * 4 >> 7) & (BK / 4 - 1))). A warp's read of
//   A touches the 8 rows ty = 0..7 at one chunk, which the swizzle spreads
//   over 8 distinct chunks, 32 banks; 8 rows further on (i) the swizzle is
//   the same. A warp's read of B is 4 consecutive 16-byte words (broadcast
//   to the 8 ty). B's box is BN * 4 = 256 or 512 bytes wide, over any
//   swizzle span, so it is not swizzled.
// - Registers: launch bounds give each setmaxnreg tile as many blocks an SM
//   as leave kConsumerBudget registers a consumer thread, the producer
//   warpgroup keeping kProducerRegs: 2 blocks at 128 x 64 and 64 x 128
//   (216 a consumer), 1 at 128 x 128 (232). 64 x 64 (96 threads) takes
//   what ptxas needs. Each scheduler runs 2 consumer warps.
// - Epilogue: 16-byte stores straight from the registers (4 columns), rows
//   and columns past m and n masked.
// TMA wants 16-byte aligned operands whose rows are a multiple of 16 bytes
// apart: the Python wrapper copies an operand that is not so into a buffer
// whose row stride is rounded up to 4 elements (lda, ldb below).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kTM = 8;  // register tile rows a consumer thread
constexpr int kTN = 8;  // register tile columns a consumer thread
constexpr int kAK = 2;  // k values of one read of A (16, 8 or 4 bytes)
constexpr int kStages = 3;
// registers a consumer thread is budgeted (the launch bounds' target) and
// what the producer warpgroup keeps under setmaxnreg
constexpr int kConsumerBudget = 200;
constexpr int kProducerRegs = 40;

template <int BM, int BN, int BK>
struct F32Shape {
  static_assert(BK == 8 || BK == 16 || BK == 32, "A's row: one swizzle span");
  static constexpr int kWarpM = 8 * kTM;  // 8 row lanes
  static constexpr int kWarpN = 4 * kTN;  // 4 column lanes
  static_assert(BM % kWarpM == 0 && BN % kWarpN == 0 && kTN % 4 == 0,
                "warp tiling");
  static constexpr int kWarpsN = BN / kWarpN;
  static constexpr int kConsumers = 32 * (BM / kWarpM) * kWarpsN;
  static constexpr bool kSetRegs = kConsumers % 128 == 0;
  static constexpr int kProducers = kSetRegs ? 128 : 32;
  static constexpr int kThreads = kProducers + kConsumers;
  // blocks an SM the launch bounds ask for. With setmaxnreg: as many as
  // give each consumer kConsumerBudget registers while the producer keeps
  // its own. Without: one, so that ptxas takes what the tile needs (its
  // cap from a larger count spilled these tiles)
  static constexpr int kDemand =
      kConsumers * kConsumerBudget + kProducers * kProducerRegs;
  static constexpr int kMinBlocks =
      kSetRegs && 65536 / kDemand > 0 ? 65536 / kDemand : 1;
  // with setmaxnreg: the registers a thread at launch, and a consumer's
  // share of its block's after the producer's decrease
  static constexpr int kLaunchRegs =
      65536 / (kThreads * kMinBlocks) / 8 * 8 > 248
          ? 248
          : 65536 / (kThreads * kMinBlocks) / 8 * 8;
  static constexpr int kConsumerShare =
      (kLaunchRegs * kThreads - kProducers * kProducerRegs) / kConsumers / 8 *
      8;
  static constexpr int kConsumerRegs =
      kConsumerShare > 256 ? 256 : kConsumerShare;
  static_assert(!kSetRegs || kConsumerRegs >= kConsumerBudget,
                "a consumer's registers");
  static constexpr int kRowBytes = BK * 4;  // A's row: the swizzle span
  static constexpr int kChunks = BK / 4;    // its 16-byte chunks
  static constexpr int kABytes = BM * kRowBytes;
  static constexpr int kBBytes = BK * BN * 4;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // 1024 bytes of slack to align the ring to the 128B swizzle's pattern,
  // then the stages and two mbarriers a stage
  static constexpr size_t kSmemBytes =
      1024 + static_cast<size_t>(kStages) * (kStageBytes + 16);
  static_assert(kSmemBytes <= kSmemLimit, "shared memory");
  static_assert(kABytes % 1024 == 0 && kStageBytes % 1024 == 0,
                "stages on the swizzle pattern");
};

// N = 4, 2 or 1 consecutive floats of shared memory (one 16-, 8- or
// 4-byte read).
template <int N>
__device__ __forceinline__ void lds(const unsigned char* p, float* out) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  } else {
    out[0] = *reinterpret_cast<const float*>(p);
  }
}

struct F32Maps {
  CUtensorMap a, b;
};

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(F32Shape<BM, BN, BK>::kThreads,
                                  F32Shape<BM, BN, BK>::kMinBlocks)
matmul_f32_sm90_kernel(const __grid_constant__ F32Maps maps,
                       float* __restrict__ c, int m, int n, int k,
                       int vec_c) {
  using L = F32Shape<BM, BN, BK>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* const ring = smem_raw + (base - raw);
  const uint32_t full = base + kStages * L::kStageBytes;  // full[s], empty[s]
  const uint32_t empty = full + 8 * kStages;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int n_slices = (k + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, L::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < L::kProducers) {
    if constexpr (L::kSetRegs) set_max_regs_dec<kProducerRegs>();
    if (tid == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int t = 0; t < n_slices; ++t) {
        if (t >= kStages) mbar_wait(empty + 8 * s, phase ^ 1u);
        const uint32_t bar = full + 8 * s;
        const uint32_t dst = base + s * L::kStageBytes;
        mbar_expect_tx(bar, L::kStageBytes);
        tma_load_2d(dst, &maps.a, bar, t * BK, row0);
        tma_load_2d(dst + L::kABytes, &maps.b, bar, col0, t * BK);
        if (++s == kStages) {
          s = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }
  if constexpr (L::kSetRegs) set_max_regs_inc<L::kConsumerRegs>();

  const int ct = tid - L::kProducers;
  const int warp = ct / 32;
  const int lane = ct % 32;
  const int ty = lane / 4;  // rows wm + ty + 8 i
  const int tx = lane % 4;  // columns wn + 4 tx + 16 j
  const int wm = (warp / L::kWarpsN) * L::kWarpM;
  const int wn = (warp % L::kWarpsN) * L::kWarpN;
  // A: this thread's first row in a stage, and the swizzle of its chunks
  // (the same 8 rows on: 8 rows are kChunks x 128 bytes)
  const int a_row = (wm + ty) * L::kRowBytes;
  const int a_swz = 16 * (((a_row >> 7) & (L::kChunks - 1)));
  const int b_col = L::kABytes + 4 * (wn + 4 * tx);

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  int s = 0;
  uint32_t phase = 0;
  for (int t = 0; t < n_slices; ++t) {
    mbar_wait(full + 8 * s, phase);
    const unsigned char* const st = ring + s * L::kStageBytes;
#pragma unroll
    for (int g = 0; g < BK / kAK; ++g) {  // k = kAK g .. kAK g + kAK - 1
      // A's bytes of these k in each row: in 16-byte chunk 4 kAK g / 16,
      // which the swizzle moves, at 4 kAK g % 16 within it
      float a[kTM][kAK];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        lds<kAK>(st + a_row + 8 * i * L::kRowBytes +
                     (((4 * kAK * g) & ~15) ^ a_swz) + ((4 * kAK * g) & 15),
                 a[i]);
#pragma unroll
      for (int kk = 0; kk < kAK; ++kk) {
        float b[kTN];
#pragma unroll
        for (int j = 0; j < kTN / 4; ++j)
          lds<4>(st + b_col + 4 * ((kAK * g + kk) * BN + 16 * j), b + 4 * j);
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j)
            acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);
      }
    }
    mbar_arrive(empty + 8 * s);
    if (++s == kStages) {
      s = 0;
      phase ^= 1u;
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int64_t row = row0 + wm + ty + 8 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < kTN / 4; ++j) {
      const int col = col0 + wn + 4 * tx + 16 * j;
      const float* v = &acc[i][4 * j];
      float* const p = c + row * n + col;
      if (vec_c && col + 3 < n) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < n) p[e] = v[e];
      }
    }
  }
}

template <int BM, int BN, int BK>
int set_smem() {
  using L = F32Shape<BM, BN, BK>;
  int optin = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (static_cast<size_t>(optin) < L::kSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(
      matmul_f32_sm90_kernel<BM, BN, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kSmemBytes)));
}

template <int BM, int BN, int BK>
int launch(const void* a, const void* b, void* c, int64_t m, int64_t n,
           int64_t k, int64_t lda, int64_t ldb, int device, void* stream) {
  using L = F32Shape<BM, BN, BK>;
  if (m <= 0 || n <= 0) return 0;
  if (k < 0 || m > INT32_MAX || n > INT32_MAX || k > INT32_MAX ||
      (m + BM - 1) / BM > 65535 || lda < k || ldb < n || lda % 4 != 0 ||
      ldb % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (!aligned(a) || !aligned(b))
    return static_cast<int>(cudaErrorMisalignedAddress);
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (encode_tiled() == nullptr) return kMapError - 1;
  F32Maps maps;
  memset(&maps, 0, sizeof(maps));
  if (k > 0) {  // with k = 0 the kernel loads nothing and writes zeros
    // A: (BK, BM) boxes swizzled across their BK * 4 bytes; B: (BN, BK)
    // boxes, 256 or 512 bytes wide, not swizzled
    CUresult r = make_map_2d(&maps.a, a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                             k, m, lda, BK, BM, swizzle_of(BK * 4));
    if (r == CUDA_SUCCESS)
      r = make_map_2d(&maps.b, b, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, n, k,
                      ldb, BN, BK, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (r != CUDA_SUCCESS) return kMapError + static_cast<int>(r);
  }
  // refused above the card's opt-in limit, before any launch
  const int smem = set_smem<BM, BN, BK>();
  if (smem != 0) return smem;
  if constexpr (L::kSetRegs) {
    // setmaxnreg.inc waits for registers that the producer's dec frees: a
    // kernel launched with fewer than the moves assume would hang
    static const int regs = [] {
      cudaFuncAttributes fa;
      return cudaFuncGetAttributes(&fa, matmul_f32_sm90_kernel<BM, BN, BK>) ==
                     cudaSuccess
                 ? fa.numRegs
                 : -1;
    }();
    if (regs * L::kThreads <
        L::kProducers * kProducerRegs + L::kConsumers * L::kConsumerRegs)
      return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int vec_c = n % 4 == 0 && aligned(c);
  const dim3 grid(static_cast<unsigned>((n + BN - 1) / BN),
                  static_cast<unsigned>((m + BM - 1) / BM));
  matmul_f32_sm90_kernel<BM, BN, BK>
      <<<grid, L::kThreads, L::kSmemBytes,
         static_cast<cudaStream_t>(stream)>>>(
          maps, static_cast<float*>(c), static_cast<int>(m),
          static_cast<int>(n), static_cast<int>(k), vec_c);
  return static_cast<int>(cudaGetLastError());
}

// What one block of a tile takes on the current device: threads, consumer
// threads, dynamic shared memory bytes, registers a thread at launch, a
// consumer's registers (setmaxnreg's, else the launch count), blocks an SM
// (the occupancy calculator at that shared memory) and the launch bounds'
// minimum blocks an SM.
template <int BM, int BN, int BK>
int info(int64_t* out) {
  using L = F32Shape<BM, BN, BK>;
  const int smem = set_smem<BM, BN, BK>();
  if (smem != 0) return smem;
  cudaFuncAttributes fa;
  cudaError_t err =
      cudaFuncGetAttributes(&fa, matmul_f32_sm90_kernel<BM, BN, BK>);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, matmul_f32_sm90_kernel<BM, BN, BK>, L::kThreads,
        L::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = L::kThreads;
  out[1] = L::kConsumers;
  out[2] = static_cast<int64_t>(L::kSmemBytes);
  out[3] = fa.numRegs;
  out[4] = L::kSetRegs ? L::kConsumerRegs : fa.numRegs;
  out[5] = blocks;
  out[6] = L::kMinBlocks;
  return 0;
}

}  // namespace

// The compiled (BM, BN, BK) table: the one list the launchers and the
// queries below are made from. The Python wrapper's TILES must list
// exactly these, in this order.
#define RT_MATMUL_F32_SM90_TILES(X)                               \
  X(64, 64, 8) X(64, 64, 16) X(64, 64, 32) X(64, 128, 8)          \
  X(64, 128, 16) X(64, 128, 32) X(128, 64, 8) X(128, 64, 16)      \
  X(128, 64, 32) X(128, 128, 8) X(128, 128, 16) X(128, 128, 32)

// One extern "C" launcher per table entry, named
// rt_matmul_f32_sm90_<BM>x<BN>x<BK>. lda and ldb are the elements from one
// row of A and B to the next (multiples of 4, at least k and n). Each makes
// `device` current, builds the tensor maps, enqueues on `stream` and
// returns cudaGetLastError() (or an error of its own:
// cudaErrorInvalidValue for a size or stride out of range or a block
// above the card's opt-in shared memory, cudaErrorMisalignedAddress for an
// operand not 16-byte aligned, cudaErrorInvalidConfiguration for too few
// registers, 100000 + CUresult for a refused tensor map).
#define RT_MATMUL_F32_SM90(BM, BN, BK)                                     \
  extern "C" int rt_matmul_f32_sm90_##BM##x##BN##x##BK(                    \
      const void* a, const void* b, void* c, int64_t m, int64_t n,         \
      int64_t k, int64_t lda, int64_t ldb, int device, void* stream) {     \
    return launch<BM, BN, BK>(a, b, c, m, n, k, lda, ldb, device, stream); \
  }
RT_MATMUL_F32_SM90_TILES(RT_MATMUL_F32_SM90)

// The table as (BM, BN, BK) triples into out[3 * i ..]: writes at most
// `cap` triples and returns how many the table has.
#define RT_MATMUL_F32_SM90_ROW(BM, BN, BK) \
  if (n < cap) {                           \
    out[3 * n] = BM;                       \
    out[3 * n + 1] = BN;                   \
    out[3 * n + 2] = BK;                   \
  }                                        \
  ++n;
extern "C" int rt_matmul_f32_sm90_tiles(int* out, int cap) {
  int n = 0;
  RT_MATMUL_F32_SM90_TILES(RT_MATMUL_F32_SM90_ROW)
  return n;
}

// Dynamic shared memory one block of a table entry asks for, in bytes, or
// -1 for an entry outside the table.
#define RT_MATMUL_F32_SM90_SMEM(BM, BN, BK) \
  if (bm == BM && bn == BN && bk == BK)     \
    return static_cast<int64_t>(F32Shape<BM, BN, BK>::kSmemBytes);
extern "C" int64_t rt_matmul_f32_sm90_smem_bytes(int bm, int bn, int bk) {
  RT_MATMUL_F32_SM90_TILES(RT_MATMUL_F32_SM90_SMEM)
  return -1;
}

// info<BM, BN, BK>'s seven numbers into out[0..6] for a table entry (0, or
// a CUDA error), or -1 for an entry outside the table.
#define RT_MATMUL_F32_SM90_INFO(BM, BN, BK) \
  if (bm == BM && bn == BN && bk == BK) return info<BM, BN, BK>(out);
extern "C" int rt_matmul_f32_sm90_info(int bm, int bn, int bk,
                                       int64_t* out) {
  RT_MATMUL_F32_SM90_TILES(RT_MATMUL_F32_SM90_INFO)
  return -1;
}

// GEMM, C = A @ B, on bf16 operands, on Hopper's tensor cores (wgmma fed by
// a TMA ring).
//
// Replaces: src/repro/kernels/matmul/matmul.py:27, _matmul_kernel /
// matmul_pallas, for bfloat16 operands: the TPU kernel runs bf16 on the
// matrix unit, jnp.dot with preferred_element_type=float32, an f32
// accumulator over the sequential k axis and the output in bf16. float32
// operands take matmul_f32_sm90.cu (full f32 on the CUDA cores). This
// kernel replaced the bf16 instantiations of the CUDA-core design, now
// baseline/matmul_cuda_cores.cu, outside the library, timed beside it.
//
// Computes C = A B for row-major A (m, k), B (k, n) and C (m, n), bf16,
// each product exact and summed in f32 (a bf16 x bf16 product on the
// tensor cores is exact), C rounded once to bf16.
//
// Bound on the card: operations. The tile search's product, 4096 x 2048 x
// 6144, is 2mnk = 103.08 GFLOP against 92.27 MB of A, B and C: 0.1042 ms at
// the tensor cores' 989 TFLOP/s in bf16 (data sheet, 700 W), against
// 0.0275 ms for the bytes at 3.35 TB/s.
//
// Design.
// - Blocks: one per (BM, BN) output tile, (BM, BN) in {64, 128, 256} x
//   {64, 128, 256} (not 256 x 256). The TPU's sequential k grid axis and
//   its f32 VMEM accumulator become a k loop of BK-deep slices with the
//   accumulator in registers.
// - Ring: stages in dynamic shared memory, as many as fit the 227 KB a
//   block may take (4 at 128 x 256 x 64), each with a full and an empty
//   mbarrier. A stage holds A's (BM, BK) slice, K-major, and B's (BK, BN)
//   slice as BN / 64 boxes of 64 columns, N-major: BK = 64 bf16 is one
//   128-byte swizzle row of A (BK = 32: 64 bytes), and 64 columns one of B.
// - Producer: warpgroup 0, whose first thread keeps the TMA loads of both
//   slices in flight, each stage as soon as the consumers free it. Rows
//   and columns past m, n or k are TMA's zero fill, so the host pads
//   nothing for a ragged m, n or k.
// - Consumers: warpgroups 1 .. BM / 64, each owning 64 rows x BN of C, run
//   wgmma.mma_async m64nBNk16 bf16 -> f32 with both operands from shared
//   memory: A K-major, B N-major through the descriptor's transpose bit
//   (its leading byte offset steps from one 64-column box to the next), so
//   nothing transposes B. Each slice's BK / 16 products are one wgmma
//   group; the group of the slice before is waited for (one stays in
//   flight) and its stage freed.
// - Registers: the accumulator of 64 x 256 f32 is 128 registers a thread.
//   With 384 threads and more the producer keeps 40 registers a thread and
//   the consumers take the rest (setmaxnreg); the launcher refuses a
//   kernel compiled with fewer registers than those moves need.
// - Epilogue: the accumulator is rounded once to bf16 and stored straight
//   from the registers, two columns a store, rows and columns past m and n
//   masked.
// - The warpgroup index is broadcast from lane 0 so that ptxas sees it
//   warp-uniform: from threadIdx.x / 128 it serialised every wgmma (C7520).
// TMA wants 16-byte aligned operands whose rows are a multiple of 16 bytes
// apart: the Python wrapper copies an operand that is not so into a buffer
// whose row stride is rounded up to 8 elements (lda, ldb below).
// Next, not done here: persistent blocks walking the output tiles (256
// blocks of 128 x 256 at the main shape fill the 132 SMs in 1.94 waves),
// clusters sharing a TMA load, and a TMA store of C.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

template <int BM, int BN, int BK>
struct GemmShape {
  static_assert(BM == 64 || BM == 128 || BM == 256, "block rows");
  static_assert(BN == 64 || BN == 128 || BN == 256, "block columns");
  static_assert(BK == 32 || BK == 64, "slice depth: one swizzle row of A");
  static_assert(BM * BN <= 128 * 256, "accumulator registers");
  static constexpr int kConsumers = BM / 64;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  // registers a thread: with setmaxnreg (384 threads and more), the
  // producer's and a consumer's share of the 65,536
  static constexpr bool kSetRegs = kThreads > 256;
  static constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerShare =
      (kLaunchRegs * kThreads - kProducerRegs * 128) / (128 * kConsumers) /
      8 * 8;
  static constexpr int kConsumerRegs =
      kConsumerShare > 256 ? 256 : kConsumerShare;
  static_assert(!kSetRegs || kConsumerRegs >= BN / 2 + 32,
                "a consumer's accumulator and its addresses");
  static constexpr int kRowBytes = BK * 2;  // A's swizzle row: 128 or 64
  static constexpr int kABytes = BM * BK * 2;
  static constexpr int kBBoxBytes = BK * 128;  // 64 columns of B
  static constexpr int kStageBytes = kABytes + BN / 64 * kBBoxBytes;
  // 1024 bytes of slack to align the ring to the swizzle's 1024-byte
  // pattern, then the stages and two mbarriers a stage
  static constexpr int kStages = (kSmemLimit - 1024) / (kStageBytes + 16);
  static constexpr size_t kSmemBytes =
      1024 + static_cast<size_t>(kStages) * (kStageBytes + 16);
  static_assert(kStages >= 2 && kSmemBytes <= kSmemLimit, "shared memory");
  static_assert(kStageBytes % 1024 == 0, "stages on the swizzle pattern");
};

// D(64 x 64, f32) += A(64 x 16) B(16 x 64), bf16, both from shared memory:
// A K-major, B N-major (transposed).
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D(64 x 128, f32) += A(64 x 16) B(16 x 128), bf16, both from shared memory:
// A K-major, B N-major (transposed).
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                         uint64_t db) {
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
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

// D(64 x 256, f32) += A(64 x 16) B(16 x 256), bf16, both from shared memory:
// A K-major, B N-major (transposed).
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// wgmma descriptor of B's N-major slice: 128-byte swizzle rows of 64
// columns, 8 k rows to a 1024-byte pattern (stride byte offset), one box of
// 64 columns to the next BK * 128 bytes on (leading byte offset).
template <int BK>
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  constexpr uint64_t lbo = BK * 128;
  constexpr uint64_t sbo = 1024;
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | ((lbo >> 4) << 16) |
         ((sbo >> 4) << 32) | (1ull << 62);
}

template <int BN>
__device__ __forceinline__ void wgmma_bf16(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 64) {
    wgmma_n64(d, da, db);
  } else if constexpr (BN == 128) {
    wgmma_n128(d, da, db);
  } else {
    wgmma_n256(d, da, db);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

struct GemmMaps {
  CUtensorMap a, b;
};

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(GemmShape<BM, BN, BK>::kThreads, 1)
matmul_sm90_kernel(const __grid_constant__ GemmMaps maps, T* __restrict__ c,
                   int m, int n, int k) {
  static_assert(sizeof(T) == 2, "bf16 only");
  using L = GemmShape<BM, BN, BK>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + kStages * L::kStageBytes;  // full[s], empty[s]
  const uint32_t empty = full + 8 * kStages;

  const int tid = threadIdx.x;
  // 0: the producer; 1 ..: consumers. Broadcast from lane 0 so that the
  // compiler sees it warp-uniform: a wgmma on a path it takes to diverge
  // is serialised (ptxas C7520).
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int n_slices = (k + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128 * L::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    if constexpr (L::kSetRegs) set_max_regs_dec<L::kProducerRegs>();
    if (tid == 0) {
      for (int t = 0; t < n_slices; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty + 8 * s, ((t / kStages) + 1) & 1);
        const uint32_t bar = full + 8 * s;
        const uint32_t a_dst = base + s * L::kStageBytes;
        mbar_expect_tx(bar, L::kStageBytes);
        tma_load_2d(a_dst, &maps.a, bar, t * BK, row0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(a_dst + L::kABytes + j * L::kBBoxBytes, &maps.b, bar,
                      col0 + 64 * j, t * BK);
      }
    }
  } else {
    if constexpr (L::kSetRegs) set_max_regs_inc<L::kConsumerRegs>();
    const int cw = wg - 1;  // this consumer's rows: row0 + 64 cw ..
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    for (int t = 0; t < n_slices; ++t) {
      const int s = t % kStages;
      mbar_wait(full + 8 * s, (t / kStages) & 1);
      const uint32_t a_s = base + s * L::kStageBytes + cw * 64 * L::kRowBytes;
      const uint32_t b_s = base + s * L::kStageBytes + L::kABytes;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_bf16<BN>(acc, smem_desc<L::kRowBytes>(a_s + 32 * kk),
                       b_desc<BK>(b_s + kk * 16 * 128));
      wgmma_commit();
      // the slice before is done: its stage is free
      wgmma_wait<1>();
      fence_regs(acc);
      if (t > 0) mbar_arrive(empty + 8 * ((t - 1) % kStages));
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // accumulator element 4 j + e: row 16 warp + lane / 4 + 8 (e / 2),
    // column 8 j + 2 (lane % 4) + e % 2 of this consumer's 64 x BN
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const int64_t row_a = row0 + 64 * cw + 16 * warp + lane / 4;
    const int col_l = col0 + 2 * (lane % 4);
    const bool pairs = n % 2 == 0;  // two columns a 4-byte store
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col_l + 8 * j;
      if (col >= n) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = row_a + 8 * h;
        if (row >= m) continue;
        const float lo = acc[4 * j + 2 * h];
        const float hi = acc[4 * j + 2 * h + 1];
        T* const p = c + row * n + col;
        if (pairs) {
          *reinterpret_cast<uint32_t*>(p) = pack_bf16(lo, hi);
        } else {
          p[0] = __float2bfloat16(lo);
          if (col + 1 < n) p[1] = __float2bfloat16(hi);
        }
      }
    }
  }
}

template <int BM, int BN, int BK>
int launch(const void* a, const void* b, void* c, int64_t m, int64_t n,
           int64_t k, int64_t lda, int64_t ldb, int device, void* stream) {
  using L = GemmShape<BM, BN, BK>;
  if (m <= 0 || n <= 0) return 0;
  if (k < 0 || m > INT32_MAX || n > INT32_MAX || k > INT32_MAX ||
      (m + BM - 1) / BM > 65535 || lda < k || ldb < n || lda % 8 != 0 ||
      ldb % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (!aligned(a) || !aligned(b) || !aligned(c))
    return static_cast<int>(cudaErrorMisalignedAddress);
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (encode_tiled() == nullptr) return kMapError - 1;
  GemmMaps maps;
  memset(&maps, 0, sizeof(maps));
  if (k > 0) {  // with k = 0 the kernel loads nothing and writes zeros
    // A: (BK, BM) boxes swizzled across their BK * 2 bytes; B: boxes of
    // 64 columns, one 128-byte swizzle row each
    CUresult r = make_map_2d(&maps.a, a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                             k, m, lda, BK, BM, swizzle_of(BK * 2));
    if (r == CUDA_SUCCESS)
      r = make_map_2d(&maps.b, b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, n, k,
                      ldb, 64, BK, CU_TENSOR_MAP_SWIZZLE_128B);
    if (r != CUDA_SUCCESS) return kMapError + static_cast<int>(r);
  }
  const cudaError_t attr = cudaFuncSetAttribute(
      matmul_sm90_kernel<bf16, BM, BN, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kSmemBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if constexpr (L::kSetRegs) {
    // setmaxnreg.inc waits for registers that the producer's dec frees: a
    // kernel launched with fewer than the moves assume would hang
    static const int regs = [] {
      cudaFuncAttributes fa;
      return cudaFuncGetAttributes(
                 &fa, matmul_sm90_kernel<bf16, BM, BN, BK>) == cudaSuccess
                 ? fa.numRegs
                 : -1;
    }();
    if (regs * L::kThreads <
        128 * (L::kProducerRegs + L::kConsumers * L::kConsumerRegs))
      return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const dim3 grid(static_cast<unsigned>((n + BN - 1) / BN),
                  static_cast<unsigned>((m + BM - 1) / BM));
  matmul_sm90_kernel<bf16, BM, BN, BK>
      <<<grid, L::kThreads, L::kSmemBytes,
         static_cast<cudaStream_t>(stream)>>>(
          maps, static_cast<bf16*>(c), static_cast<int>(m),
          static_cast<int>(n), static_cast<int>(k));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The compiled (BM, BN, BK) table: the one list the launchers and the
// queries below are made from. The Python wrapper's BF16_TILES must list
// exactly these.
#define RT_MATMUL_SM90_TILES(X)                                    \
  X(64, 64, 32) X(64, 64, 64) X(64, 128, 32) X(64, 128, 64)        \
  X(64, 256, 32) X(64, 256, 64) X(128, 64, 32) X(128, 64, 64)      \
  X(128, 128, 32) X(128, 128, 64) X(128, 256, 32) X(128, 256, 64)  \
  X(256, 64, 32) X(256, 64, 64) X(256, 128, 32) X(256, 128, 64)

// One extern "C" launcher per table entry, named
// rt_matmul_sm90_bf16_<BM>x<BN>x<BK>. lda and ldb are the elements from one
// row of A and B to the next (multiples of 8, at least k and n). Each makes
// `device` current, builds the tensor maps, enqueues on `stream` and
// returns cudaGetLastError() (or an error of its own: cudaErrorInvalidValue
// for a size or stride out of range, cudaErrorMisalignedAddress for an
// operand not 16-byte aligned, cudaErrorInvalidConfiguration for too few
// registers, 100000 + CUresult for a refused tensor map).
#define RT_MATMUL_SM90(BM, BN, BK)                                         \
  extern "C" int rt_matmul_sm90_bf16_##BM##x##BN##x##BK(                   \
      const void* a, const void* b, void* c, int64_t m, int64_t n,         \
      int64_t k, int64_t lda, int64_t ldb, int device, void* stream) {     \
    return launch<BM, BN, BK>(a, b, c, m, n, k, lda, ldb, device, stream); \
  }
RT_MATMUL_SM90_TILES(RT_MATMUL_SM90)

// The table as (BM, BN, BK) triples into out[3 * i ..]: writes at most
// `cap` triples and returns how many the table has.
#define RT_MATMUL_SM90_ROW(BM, BN, BK) \
  if (n < cap) {                       \
    out[3 * n] = BM;                   \
    out[3 * n + 1] = BN;               \
    out[3 * n + 2] = BK;               \
  }                                    \
  ++n;
extern "C" int rt_matmul_sm90_tiles(int* out, int cap) {
  int n = 0;
  RT_MATMUL_SM90_TILES(RT_MATMUL_SM90_ROW)
  return n;
}

// Dynamic shared memory one block of a table entry asks for, in bytes, or
// -1 for an entry outside the table.
#define RT_MATMUL_SM90_SMEM(BM, BN, BK)       \
  if (bm == BM && bn == BN && bk == BK)       \
    return static_cast<int64_t>(GemmShape<BM, BN, BK>::kSmemBytes);
extern "C" int64_t rt_matmul_sm90_smem_bytes(int bm, int bn, int bk) {
  RT_MATMUL_SM90_TILES(RT_MATMUL_SM90_SMEM)
  return -1;
}

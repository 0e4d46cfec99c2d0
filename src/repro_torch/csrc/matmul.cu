// Blocked GEMM, C = A @ B, on CUDA cores, for f32 and bf16 operands.
//
// Replaces: src/repro/kernels/matmul/matmul.py:27, _matmul_kernel /
// matmul_pallas (with the tile padding of ops.matmul).
//
// Bound on the card: operations. The main path's product, 4096 x 2048 x
// 6144 in f32, is 2mnk = 103.1 GFLOP against 0.15 GB of operands, far
// above the ridge point; f32 stays full f32 (as torch.matmul with TF32
// off), so the roof is the CUDA cores' 67 TFLOP/s (data sheet, 700 W):
// 1.5385 ms. What keeps a kernel from it is feeding the FMA units. An SM
// does 128 FMAs a clock but reads 128 bytes of shared memory a clock, so
// a register tile that reads a byte per FMA saturates shared memory at
// the FMA rate; and a global load that the block waits on idles both.
//
// Design. One block owns a (BM, BN) output tile; the TPU's sequential k
// grid axis and its f32 VMEM accumulator become a k loop inside the block
// with the f32 accumulator in registers.
// - Register tile: each thread owns TM x 8 outputs as 4 x 4 sub-tiles, 16
//   rows and 32 columns apart, and each warp a contiguous 4 TM x 64 part
//   of the block tile (lane = 4 row groups x 8 column groups). Per k step
//   a thread reads TM / 4 + 2 16-byte words from shared memory (LDS.128:
//   of A's column and B's row) for 8 TM FMAs; the 8 lanes of a quarter
//   warp read one broadcast A word and 8 consecutive B words, so the
//   reads are conflict-free. TM = 16 (0.75 bytes per FMA) on the 128 x 128
//   tile at BK <= 16, the main path's best, and 8 (1 byte per FMA)
//   elsewhere: the 16-row tile holds 128 accumulators a thread.
// - Ring of two stages in dynamic shared memory with one __syncthreads
//   per k step. While stage s is multiplied, the next k slice is on its
//   way: B (k x n row-major, as the register tile reads it) by cp.async
//   16-byte copies straight into stage s^1; A by 16-byte global loads
//   into registers, stored transposed (As[k][m], so that a column of A is
//   a row of shared memory) after the multiply. The A rows are padded by
//   4 words and a warp's loads cover 16 rows x 2 16-byte words, so the
//   transposing stores of a warp hit 32 distinct banks.
// - Rows whose stride is not a multiple of 16 bytes (k or n not a multiple
//   of 16 / sizeof(T)) take scalar loads into the next stage instead; the
//   ring and the register tile are the same. Ragged edges are masked in
//   the kernel (zero-filled loads, guarded stores), so the host pads
//   nothing.
// - bf16 operands take the same template: shared memory holds the bytes
//   cp.async copies, and each element becomes f32 as it is read into the
//   register tile.
// Shared memory: 2 * (BK * (BM + 4) + BK * BN) * sizeof(T), 66,560 bytes
// at 128 x 128 x 32 in f32, above the 48 KiB a block gets without the
// opt-in attribute that every launch sets. wgmma and the tensor cores are
// not used: they would compute in TF32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTN = 8;      // register tile columns per thread
constexpr int kWarpN = 64;  // warp tile columns: 8 lanes x 2 x 4 columns
constexpr int kPadA = 4;    // words of padding per transposed A row

template <typename T, int BM, int BN, int BK>
struct Tile {
  // register tile rows per thread: 16 on the 128 x 128 tile up to BK = 16
  // (a 64 x 64 warp tile), else 8 (32 x 64; at BK = 32 the 16-row tile's
  // A prefetch would spill)
  static constexpr int kTM = BM == 128 && BN == 128 && BK <= 16 ? 16 : 8;
  static constexpr int kWarpM = 4 * kTM;  // 4 lanes x kTM / 4 x 4 rows
  static constexpr int kThreads = (BM / kTM) * (BN / kTN);
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // per 16 B
  static constexpr int kAStride = BM + kPadA;
  static constexpr int kAStage = BK * kAStride;  // elements
  static constexpr int kBStage = BK * BN;
  static constexpr size_t kSmemBytes =
      2 * static_cast<size_t>(kAStage + kBStage) * sizeof(T);
  // 16-byte words of A (rows x words per row) and of B per stage
  static constexpr int kAWordsPerRow = BK / kVec;
  static constexpr int kAWords = BM * kAWordsPerRow;
  static constexpr int kBWords = BK * BN / kVec;
  static constexpr int kARegs = (kAWords + kThreads - 1) / kThreads;
  // a warp's A words: kRowRun consecutive rows x kWordRun words of a row
  static constexpr int kWordRun = kAWordsPerRow < 2 ? kAWordsPerRow : 2;
  static constexpr int kRowRun = 32 / kWordRun;
  static_assert(BM % kWarpM == 0 && BN % kWarpN == 0, "warp tiling");
  static_assert(kTM % 4 == 0, "4-row sub-tiles");
  static_assert((BM / kWarpM) * (BN / kWarpN) * 32 == kThreads, "threads");
  static_assert(BK % kVec == 0 && BM % kRowRun == 0, "A words");
};

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Element j of a 16-byte word loaded into registers (j a constant after
// unrolling, so this folds to a register move).
__device__ __forceinline__ uint32_t word32(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
template <typename T>
__device__ __forceinline__ T element(const uint4& v, int j);
template <>
__device__ __forceinline__ float element<float>(const uint4& v, int j) {
  return __uint_as_float(word32(v, j));
}
template <>
__device__ __forceinline__ __nv_bfloat16 element<__nv_bfloat16>(
    const uint4& v, int j) {
  const uint32_t w = word32(v, j / 2);
  __nv_bfloat16_raw raw;
  raw.x = static_cast<unsigned short>(j % 2 ? w >> 16 : w & 0xffffu);
  return __nv_bfloat16(raw);
}

// Four consecutive elements of shared memory as f32 (16 or 8 bytes).
__device__ __forceinline__ void lds4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void lds4(const __nv_bfloat16* p, float* out) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.y));
  out[0] = lo.x; out[1] = lo.y; out[2] = hi.x; out[3] = hi.y;
}

// Four consecutive outputs of one row (16 or 8 bytes).
__device__ __forceinline__ void stg4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void stg4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 w;
  w.x = *reinterpret_cast<uint32_t*>(&lo);
  w.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = w;
}

// 16 bytes from global to shared memory, zero-filled past src_bytes.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One block an SM is enough for the launch bounds: ptxas's default budget
// spilled the bf16 128 x 64 x 32 tile.
template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(Tile<T, BM, BN, BK>::kThreads, 1)
matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
              T* __restrict__ c, int64_t m, int64_t n, int64_t k, int vec_a,
              int vec_b, int vec_c) {
  using L = Tile<T, BM, BN, BK>;
  constexpr int kThreads = L::kThreads;
  constexpr int kVec = L::kVec;
  constexpr int kTM = L::kTM;
  constexpr int kWarpM = L::kWarpM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const as = reinterpret_cast<T*>(smem_raw);  // [2][BK][BM + 4]
  T* const bs = as + 2 * L::kAStage;             // [2][BK][BN]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = (warp / (BN / kWarpN)) * kWarpM;  // warp tile origin
  const int wn = (warp % (BN / kWarpN)) * kWarpN;
  const int ty = lane / 8;  // rows wm + 4 ty + {0..3}, + 16 i
  const int tx = lane % 8;  // columns wn + 4 tx + {0..3}, + 32
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * BN;

  // A's 16-byte word i of a stage: row and word within the row, so that a
  // warp covers kRowRun consecutive rows x kWordRun consecutive words.
  auto a_word = [&](int i, int& r, int& w) {
    const int run = i / 32;
    const int rows = BM / L::kRowRun;
    r = (run % rows) * L::kRowRun + i % L::kRowRun;
    w = (run / rows) * L::kWordRun + (i / L::kRowRun) % L::kWordRun;
  };

  uint4 a_regs[L::kARegs];
  // Next k slice: B by cp.async (or scalars) into stage `st`, A by 16-byte
  // loads into a_regs (or scalars straight into stage `st`).
  auto load_slice = [&](int64_t k0, int st) {
    T* const bst = bs + st * L::kBStage;
    if (vec_b) {
#pragma unroll
      for (int it = 0; it < (L::kBWords + kThreads - 1) / kThreads; ++it) {
        const int i = it * kThreads + tid;
        if (L::kBWords % kThreads != 0 && i >= L::kBWords) break;
        const int kk = i / (BN / kVec);
        const int cc = (i % (BN / kVec)) * kVec;
        const int64_t gk = k0 + kk;
        const int64_t gc = col0 + cc;
        const bool in = gk < k && gc < n;
        cp_async16(bst + kk * BN + cc, in ? b + gk * n + gc : b, in ? 16 : 0);
      }
      cp_async_commit();
    } else {
      for (int i = tid; i < BK * BN; i += kThreads) {
        const int kk = i / BN;
        const int cc = i % BN;
        const int64_t gk = k0 + kk;
        const int64_t gc = col0 + cc;
        bst[kk * BN + cc] = (gk < k && gc < n) ? b[gk * n + gc]
                                               : from_f32<T>(0.0f);
      }
    }
    if (vec_a) {
#pragma unroll
      for (int it = 0; it < L::kARegs; ++it) {
        const int i = it * kThreads + tid;
        a_regs[it] = make_uint4(0u, 0u, 0u, 0u);
        if (L::kAWords % kThreads != 0 && i >= L::kAWords) continue;
        int r, w;
        a_word(i, r, w);
        const int64_t gr = row0 + r;
        const int64_t gk = k0 + w * kVec;
        if (gr < m && gk < k)
          a_regs[it] = __ldg(reinterpret_cast<const uint4*>(a + gr * k + gk));
      }
    } else {
      T* const ast = as + st * L::kAStage;
      for (int i = tid; i < BM * BK; i += kThreads) {
        const int r = i % BM;
        const int kk = i / BM;
        const int64_t gr = row0 + r;
        const int64_t gk = k0 + kk;
        ast[kk * L::kAStride + r] = (gr < m && gk < k) ? a[gr * k + gk]
                                                       : from_f32<T>(0.0f);
      }
    }
  };
  // The registers' A words, transposed into stage `st`.
  auto store_a = [&](int st) {
    if (!vec_a) return;
    T* const ast = as + st * L::kAStage;
#pragma unroll
    for (int it = 0; it < L::kARegs; ++it) {
      const int i = it * kThreads + tid;
      if (L::kAWords % kThreads != 0 && i >= L::kAWords) continue;
      int r, w;
      a_word(i, r, w);
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        ast[(w * kVec + j) * L::kAStride + r] = element<T>(a_regs[it], j);
    }
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  const int64_t n_slices = (k + BK - 1) / BK;
  if (n_slices > 0) {
    load_slice(0, 0);
    store_a(0);
    cp_async_wait_all();
  }
  __syncthreads();
  for (int64_t t = 0; t < n_slices; ++t) {
    const int cur = static_cast<int>(t & 1);
    const bool more = t + 1 < n_slices;
    if (more) load_slice((t + 1) * BK, cur ^ 1);
    const T* ast = as + cur * L::kAStage;
    const T* bst = bs + cur * L::kBStage;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float ra[kTM], rb[kTN];
#pragma unroll
      for (int i = 0; i < kTM / 4; ++i)
        lds4(ast + kk * L::kAStride + wm + 16 * i + 4 * ty, ra + 4 * i);
      lds4(bst + kk * BN + wn + 4 * tx, rb);
      lds4(bst + kk * BN + wn + 32 + 4 * tx, rb + 4);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
    if (more) {
      store_a(cur ^ 1);
      cp_async_wait_all();
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int64_t gr = row0 + wm + (i / 4) * 16 + 4 * ty + i % 4;
    if (gr >= m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t gc = col0 + wn + h * 32 + 4 * tx;
      const float* v = &acc[i][4 * h];
      if (vec_c && gc + 3 < n) {
        stg4(c + gr * n + gc, v);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gc + j < n) c[gr * n + gc + j] = from_f32<T>(v[j]);
      }
    }
  }
}

template <typename T, int BM, int BN, int BK>
int launch(const void* a, const void* b, void* c, int64_t m, int64_t n,
           int64_t k, int device, void* stream) {
  using L = Tile<T, BM, BN, BK>;
  if (m <= 0 || n <= 0) return 0;
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaError_t attr = cudaFuncSetAttribute(
      matmul_kernel<T, BM, BN, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kSmemBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_a = k % L::kVec == 0 && aligned(a);
  const int vec_b = n % L::kVec == 0 && aligned(b);
  const int vec_c = n % 4 == 0 && aligned(c);
  const dim3 grid(static_cast<unsigned>((n + BN - 1) / BN),
                  static_cast<unsigned>((m + BM - 1) / BM));
  matmul_kernel<T, BM, BN, BK>
      <<<grid, L::kThreads, L::kSmemBytes,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(a), static_cast<const T*>(b),
          static_cast<T*>(c), m, n, k, vec_a, vec_b, vec_c);
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

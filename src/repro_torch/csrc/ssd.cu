// Mamba2 SSD chunk scan (state-space duality) on CUDA cores, f32.
//
// Replaces: src/repro/kernels/ssd/ssd.py:36, _ssd_kernel /
// ssd_chunk_scan_pallas (the model-layout reshapes of ops.ssd_chunk_scan
// stay in the Python wrapper).
//
// Computes, per (batch, head), over the chunks c = 0 .. C-1 in order, with
// a (P, N) f32 state h that starts at h0 (or 0):
//   y_c = ((C_c B_c^T) ⊙ L_c) xdt_c + (C_c h^T) ⊙ exp(cum_c),
//         L_c[i, j] = exp(cum_i - cum_j) for i >= j, else 0;
//   h  <- exp(cum_c[Q-1]) h + (xdt_c ⊙ exp(cum_c[Q-1] - cum_c))^T B_c,
// with xdt (B, H, C, Q, P), bm and cm (B, C, Q, N) shared by the heads,
// cum (B, H, C, Q) and y (B, H, C, Q, P); and, when asked, the state after
// the last chunk, (B, H, P, N), which the TPU kernel keeps in VMEM scratch
// and drops.
//
// Bound on the card: operations. The formula of ssd.py (2 (Q^2 N + Q^2 P +
// 2 Q P N) per chunk and head) against 4 (2 Q P + 2 Q N / H + Q) bytes puts
// every config far above the ridge point; everything is f32, so the roof is
// the CUDA cores' 67 TFLOP/s. No tensor cores, TMA or pipelining here: a
// later PR's work.
//
// Design. Two kernels, launched back to back by one launcher.
//
// 1. ssd_scores_kernel: the chunk's score matrix C_c B_c^T, which depends
//    on (b, c) only (the heads share B and C, n_groups = 1), computed once
//    for all heads into a (B, C, Q, Q) f32 scratch the wrapper allocates:
//    one block per (b, c, 64 x 64 tile on or below the diagonal), the
//    tile accumulated over N in slices of 32 staged in shared memory, 4 x 4
//    per thread. The TPU kernel recomputes it per head; here that product,
//    Q^2 N of the formula's Q^2 (N + P) + 2 Q P N per head, is done H
//    times less.
// 2. ssd_chunk_scan_kernel: the sequential part. The chunk axis is the
//    TPU's "arbitrary" grid axis with a VMEM scratch; Hopper blocks run in
//    no order, so a block owns one (b, h, slice of PT = 32 state rows p)
//    and loops over the chunks itself, keeping its (PT, N) slice of the
//    state in shared memory. Nothing carries between blocks. The rows p of
//    the state are independent (y[:, p] and h[p, :] need only xdt[:, p]),
//    so splitting P costs nothing now that the scores are shared, and
//    doubles the blocks at P = 64: 192 at mamba2-130m's serving shape
//    (B = 4, H = 24), 160 at zamba2-2.7b's (B = 1, H = 80), on 132 SMs,
//    two blocks per SM at N <= 128.
//    A chunk is tiled the way flash attention tiles a sequence: row tiles
//    of RT = 64 positions i, and for each the column tiles of CT = 64
//    positions j that hold some j <= i. The (RT, PT) output tile is
//    accumulated in registers (2 rows x 4 state rows p per thread, the p
//    contiguous, read as float4), starting as the inter-chunk term
//    (C h^T) ⊙ exp(cum_i) from the C row tile (staged transposed) and the
//    state (stored k-major). Each score tile is read from the scratch, the
//    causal mask and the decay exp(cum_i - cum_j) applied on the fly (only
//    for j <= i, so nothing overflows), and parked in shared memory for
//    the product with the xdt tile. The last row tile visits every column
//    tile, so it also stages B and accumulates the state's new
//    contribution (xdt ⊙ exp(total - cum))^T B in registers (each thread
//    owns 2 x 16 fixed (p, n) elements, B read as float4); the state is
//    overwritten only after every row tile of the chunk has read the old
//    one. Ragged edges (any Q >= 1, any P, N <= 256) are zero-padded in
//    shared memory and masked on the way out. Shared memory: 112 KB at
//    N = 128 (two blocks per SM), 69 KB at N = 64, 196 KB at N = 256.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int RT = 64;                 // positions i per row tile
constexpr int CT = 64;                 // positions j per column tile
constexpr int PT = 32;                 // state rows p per block
constexpr int NK = 32;                 // state columns per staged slice
constexpr int kMaxN = 256;             // state width the registers hold
// 16 x 16 threads: score tiles (4 x 4 per thread) and the state update
// (2 state rows p x 16 state columns n per thread)
constexpr int kTy = 16;
constexpr int kTx = 16;
constexpr int RM = RT / kTy;           // score rows per thread
constexpr int CM = CT / kTx;           // score columns per thread
constexpr int SA = PT / kTy;           // state rows per thread
constexpr int SN = kMaxN / 64;         // 64-wide state column groups
// 32 x 8 threads: the (RT, PT) output tile (2 rows x 4 contiguous p)
constexpr int kOy = 32;
constexpr int kOx = 8;
constexpr int ORM = RT / kOy;
constexpr int OPM = PT / kOx;
static_assert(kTy * kTx == kThreads && kOy * kOx == kThreads &&
              RT % kTy == 0 && CT % kTx == 0 && PT % kTy == 0 &&
              RT % kOy == 0 && OPM == 4 && RT == CT && CT <= kThreads &&
              kTx * 4 == 64 && kMaxN % 64 == 0, "tile shape");

// Row strides of the shared-memory tiles, in floats.
__host__ __device__ constexpr int pstride() { return PT + 4; }  // hs, xs
__host__ __device__ constexpr int64_t bstride(int64_t n) {      // bs
  return (n + 63) / 64 * 64 + 4;
}

// Shared memory of the scan kernel at state width n, in floats: hs, xs
// and bs first (read as float4, so their offsets stay multiples of 4),
// then cs, ss and sd.
__host__ __device__ constexpr int64_t smem_floats(int64_t n) {
  return n * pstride() + CT * pstride() + CT * bstride(n) + n * (RT + 1) +
         RT * (CT + 1) + CT;
}

__global__ void __launch_bounds__(kThreads)
ssd_scores_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
                  float* __restrict__ scores, int64_t chunks, int64_t pairs,
                  int q_len, int n) {
  __shared__ float cs[NK][RT + 1];
  __shared__ float bs[NK][CT + 1];
  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  const int64_t pair = blockIdx.x % pairs;
  const int64_t c = blockIdx.x / pairs;
  const int64_t b = blockIdx.y;
  int it = 0;                           // tile pair -> (row tile, col tile)
  while (static_cast<int64_t>(it + 1) * (it + 2) / 2 <= pair) ++it;
  const int jt = static_cast<int>(pair - static_cast<int64_t>(it) * (it + 1) / 2);
  const int i0 = it * RT;
  const int j0 = jt * CT;
  const int64_t row0 = (b * chunks + c) * q_len;

  float s[RM][CM];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CM; ++j) s[i][j] = 0.0f;
  for (int k0 = 0; k0 < n; k0 += NK) {
    for (int idx = tid; idx < RT * NK; idx += kThreads) {
      const int r = idx / NK;
      const int k = idx % NK;
      const bool kin = k0 + k < n;
      cs[k][r] = (kin && i0 + r < q_len) ? cm[(row0 + i0 + r) * n + k0 + k]
                                         : 0.0f;
      bs[k][r] = (kin && j0 + r < q_len) ? bm[(row0 + j0 + r) * n + k0 + k]
                                         : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < NK; ++k) {
      float ca[RM], cb[CM];
#pragma unroll
      for (int i = 0; i < RM; ++i) ca[i] = cs[k][ty + kTy * i];
#pragma unroll
      for (int j = 0; j < CM; ++j) cb[j] = bs[k][tx + kTx * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CM; ++j) s[i][j] = fmaf(ca[i], cb[j], s[i][j]);
    }
    __syncthreads();
  }
  float* out = scores + row0 * q_len;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = i0 + ty + kTy * i;
#pragma unroll
    for (int j = 0; j < CM; ++j) {
      const int col = j0 + tx + kTx * j;
      if (row < q_len && col < q_len)
        out[static_cast<int64_t>(row) * q_len + col] = s[i][j];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_scan_kernel(const float* __restrict__ xdt,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ cum,
                      const float* __restrict__ scores,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ h_out, int64_t heads,
                      int64_t chunks, int q_len, int p_dim, int n) {
  extern __shared__ float smem[];
  constexpr int ps = pstride();
  const int bst = static_cast<int>(bstride(n));
  float* hs = smem;                    // state slice, [n][ps] (k-major)
  float* xs = hs + n * ps;             // xdt column tile, [CT][ps]
  float* bs = xs + CT * ps;            // B column tile, [CT][bst]
  float* cs = bs + CT * bst;           // C row tile, [n][RT + 1]
  float* ss = cs + n * (RT + 1);       // masked, decayed scores, [RT][CT + 1]
  float* sd = ss + RT * (CT + 1);      // exp(total - cum_j), [CT]

  const int tid = threadIdx.x;
  const int tx = tid % kTx;            // 16 x 16 layout
  const int ty = tid / kTx;
  const int ox = tid % kOx;            // 32 x 8 layout
  const int oy = tid / kOx;
  const int p0 = blockIdx.x * PT;
  const int pn = min(PT, p_dim - p0);  // state rows of this block
  const int64_t bh = static_cast<int64_t>(blockIdx.z) * heads + blockIdx.y;
  const int64_t b = blockIdx.z;
  const int ng = (n + 63) / 64;        // state column groups in use

  for (int idx = tid; idx < PT * n; idx += kThreads) {
    const int p = idx / n;
    const int k = idx % n;
    hs[k * ps + p] = (h0 != nullptr && p < pn)
        ? h0[(bh * p_dim + p0 + p) * n + k] : 0.0f;
  }

  for (int64_t c = 0; c < chunks; ++c) {
    const int64_t xrow = (bh * chunks + c) * q_len;   // rows of xdt and y
    const int64_t brow = (b * chunks + c) * q_len;    // rows of bm and cm
    const float* cu = cum + (bh * chunks + c) * q_len;
    const float* sc = scores + brow * q_len;          // (Q, Q) of chunk c
    const float total = cu[q_len - 1];
    float hacc[SA][SN][4];
#pragma unroll
    for (int a = 0; a < SA; ++a)
#pragma unroll
      for (int g = 0; g < SN; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[a][g][e] = 0.0f;

    for (int i0 = 0; i0 < q_len; i0 += RT) {
      const bool last_rows = i0 + RT >= q_len;
      __syncthreads();   // cs free; the state written after the last chunk
      for (int idx = tid; idx < RT * n; idx += kThreads) {
        const int r = idx / n;
        const int k = idx % n;
        cs[k * (RT + 1) + r] =
            i0 + r < q_len ? cm[(brow + i0 + r) * n + k] : 0.0f;
      }
      __syncthreads();

      // inter-chunk term: (C h^T) ⊙ exp(cum_i), from the state before
      // this chunk
      float acc[ORM][OPM];
#pragma unroll
      for (int i = 0; i < ORM; ++i)
#pragma unroll
        for (int m = 0; m < OPM; ++m) acc[i][m] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        float ca[ORM];
#pragma unroll
        for (int i = 0; i < ORM; ++i) ca[i] = cs[k * (RT + 1) + oy + kOy * i];
        const float4 hv = *reinterpret_cast<const float4*>(hs + k * ps + 4 * ox);
#pragma unroll
        for (int i = 0; i < ORM; ++i) {
          acc[i][0] = fmaf(ca[i], hv.x, acc[i][0]);
          acc[i][1] = fmaf(ca[i], hv.y, acc[i][1]);
          acc[i][2] = fmaf(ca[i], hv.z, acc[i][2]);
          acc[i][3] = fmaf(ca[i], hv.w, acc[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < ORM; ++i) {
        const int row = i0 + oy + kOy * i;
        const float e = row < q_len ? expf(cu[row]) : 0.0f;
#pragma unroll
        for (int m = 0; m < OPM; ++m) acc[i][m] *= e;
      }

      float cu_i[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int row = i0 + ty + kTy * i;
        cu_i[i] = row < q_len ? cu[row] : 0.0f;
      }
      // intra-chunk term over the column tiles that hold some j <= i
      const int j_end = min(i0 + RT, q_len);
      for (int j0 = 0; j0 < j_end; j0 += CT) {
#pragma unroll
        for (int j = 0; j < CM; ++j) {
          const int col = j0 + tx + kTx * j;
          const float cu_j = col < q_len ? cu[col] : 0.0f;
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const int row = i0 + ty + kTy * i;
            const bool on = col <= row && row < q_len;
            ss[(ty + kTy * i) * (CT + 1) + tx + kTx * j] =
                on ? sc[static_cast<int64_t>(row) * q_len + col] *
                         expf(cu_i[i] - cu_j)
                   : 0.0f;
          }
        }
        for (int idx = tid; idx < CT * PT; idx += kThreads) {
          const int r = idx / PT;
          const int p = idx % PT;
          xs[r * ps + p] = (j0 + r < q_len && p < pn)
              ? xdt[(xrow + j0 + r) * p_dim + p0 + p] : 0.0f;
        }
        if (tid < CT)
          sd[tid] = j0 + tid < q_len ? expf(total - cu[j0 + tid]) : 0.0f;
        if (last_rows) {
          const int kw = ng * 64;
          for (int idx = tid; idx < CT * kw; idx += kThreads) {
            const int r = idx / kw;
            const int k = idx % kw;
            bs[r * bst + k] = (j0 + r < q_len && k < n)
                ? bm[(brow + j0 + r) * n + k] : 0.0f;
          }
        }
        __syncthreads();

#pragma unroll 4
        for (int jj = 0; jj < CT; ++jj) {
          float sv[ORM];
#pragma unroll
          for (int i = 0; i < ORM; ++i) sv[i] = ss[(oy + kOy * i) * (CT + 1) + jj];
          const float4 xv = *reinterpret_cast<const float4*>(xs + jj * ps + 4 * ox);
#pragma unroll
          for (int i = 0; i < ORM; ++i) {
            acc[i][0] = fmaf(sv[i], xv.x, acc[i][0]);
            acc[i][1] = fmaf(sv[i], xv.y, acc[i][1]);
            acc[i][2] = fmaf(sv[i], xv.z, acc[i][2]);
            acc[i][3] = fmaf(sv[i], xv.w, acc[i][3]);
          }
        }
        if (last_rows) {
          // the state's new contribution: (xdt ⊙ sd)^T B over this tile;
          // thread (ty, tx) owns p = ty + 16 a, n = 64 g + 4 tx + e
          for (int jj = 0; jj < CT; ++jj) {
            const float w = sd[jj];
            float xa[SA];
#pragma unroll
            for (int a = 0; a < SA; ++a) xa[a] = xs[jj * ps + ty + kTy * a] * w;
#pragma unroll
            for (int g = 0; g < SN; ++g) {
              if (g < ng) {
                const float4 bv = *reinterpret_cast<const float4*>(
                    bs + jj * bst + 64 * g + 4 * tx);
#pragma unroll
                for (int a = 0; a < SA; ++a) {
                  hacc[a][g][0] = fmaf(xa[a], bv.x, hacc[a][g][0]);
                  hacc[a][g][1] = fmaf(xa[a], bv.y, hacc[a][g][1]);
                  hacc[a][g][2] = fmaf(xa[a], bv.z, hacc[a][g][2]);
                  hacc[a][g][3] = fmaf(xa[a], bv.w, hacc[a][g][3]);
                }
              }
            }
          }
        }
        __syncthreads();   // ss, xs, bs and sd free for the next tile
      }

#pragma unroll
      for (int i = 0; i < ORM; ++i) {
        const int row = i0 + oy + kOy * i;
        if (row >= q_len) continue;
#pragma unroll
        for (int m = 0; m < OPM; ++m) {
          const int p = 4 * ox + m;
          if (p < pn) y[(xrow + row) * p_dim + p0 + p] = acc[i][m];
        }
      }
    }

    // every row tile has read the old state: h <- exp(total) h + contrib
    __syncthreads();
    const float decay = expf(total);
#pragma unroll
    for (int a = 0; a < SA; ++a) {
      const int p = ty + kTy * a;
#pragma unroll
      for (int g = 0; g < SN; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 64 * g + 4 * tx + e;
          if (g < ng && k < n)
            hs[k * ps + p] = fmaf(decay, hs[k * ps + p], hacc[a][g][e]);
        }
    }
  }

  if (h_out == nullptr) return;
  __syncthreads();
  for (int idx = tid; idx < PT * n; idx += kThreads) {
    const int p = idx / n;
    const int k = idx % n;
    if (p < pn) h_out[(bh * p_dim + p0 + p) * n + k] = hs[k * ps + p];
  }
}

}  // namespace

// Dynamic shared memory of one scan block at state width n_dim, in bytes,
// or -1 for a width the kernel does not take (n_dim < 1 or above 256).
extern "C" int64_t rt_ssd_chunk_scan_smem_bytes(int64_t n_dim) {
  if (n_dim < 1 || n_dim > kMaxN) return -1;
  return smem_floats(n_dim) * static_cast<int64_t>(sizeof(float));
}

// Launcher: f32 contiguous operands in the layouts above, and `scores`, a
// (B, C, Q, Q) f32 scratch (only its tiles on or below the diagonal are
// written and read); h0 and h_out may be null (a zero initial state; no
// final state written). Makes `device` current, enqueues both kernels on
// `stream` and returns cudaGetLastError().
extern "C" int rt_ssd_chunk_scan_f32(
    const void* xdt, const void* bm, const void* cm, const void* cum,
    const void* h0, void* y, void* h_out, void* scores, int64_t batch,
    int64_t heads, int64_t chunks, int64_t q_len, int64_t p_dim,
    int64_t n_dim, int device, void* stream) {
  if (batch < 0 || heads < 0 || chunks < 0 || q_len < 1 || p_dim < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t smem = rt_ssd_chunk_scan_smem_bytes(n_dim);
  const int64_t tiles = (q_len + RT - 1) / RT;
  const int64_t pairs = tiles * (tiles + 1) / 2;
  if (smem < 0 || batch > 65535 || heads > 65535 || q_len > 0x7fffffff ||
      p_dim > 0x7fffffff || pairs * chunks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || heads == 0 || chunks == 0) return 0;
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaError_t attr = cudaFuncSetAttribute(
      ssd_chunk_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ssd_scores_kernel<<<dim3(static_cast<unsigned>(pairs * chunks),
                           static_cast<unsigned>(batch)),
                      kThreads, 0, s>>>(
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<float*>(scores), chunks, pairs, static_cast<int>(q_len),
      static_cast<int>(n_dim));
  const cudaError_t first = cudaGetLastError();
  if (first != cudaSuccess) return static_cast<int>(first);
  const dim3 grid(static_cast<unsigned>((p_dim + PT - 1) / PT),
                  static_cast<unsigned>(heads), static_cast<unsigned>(batch));
  ssd_chunk_scan_kernel<<<grid, kThreads, static_cast<size_t>(smem), s>>>(
      static_cast<const float*>(xdt), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(cum),
      static_cast<const float*>(scores), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(h_out), heads, chunks,
      static_cast<int>(q_len), static_cast<int>(p_dim),
      static_cast<int>(n_dim));
  return static_cast<int>(cudaGetLastError());
}

// Batched float32 matrix product for Hopper (sm_90a): PowerSGD's P/Q products.
//
// Replaces the Pallas kernel src/repro/kernels/lowrank.py::matmul (a tiled
// A @ B with float32 accumulation and k innermost).  For B batches:
//
//     C[b] (m, n) = A[b] (m, k) @ B[b] (k, n)        (float32, contiguous C)
//
// A and B are read through their strides (sab, sai, sak) and (sbb, sbk, sbj)
// in elements, so a transposed operand (PowerSGD's M^T @ P and P @ Q'^T) is a
// view with swapped strides and is never materialised.
//
// PowerSGD runs three products per matrix M (B, a, b) at rank r = 2:
//     P  = M @ Q       m = a, k = b, n = r    reads M
//     Q' = M^T @ P     m = b, k = a, n = r    reads M through its transpose
//     ~M = P @ Q'^T    m = a, k = r, n = b    writes an M-sized result
// Each moves M's bytes once and does 4 flops per element of M, far below the
// card's float32 rate (67 TFLOP/s outside the tensor cores), so device-memory
// bytes bound all three: at full-width gpt2-paper a step's 33 products move
// about 3 x 762 MB, 0.68 ms at 3.35 TB/s.
//
// Two kinds of kernel, chosen by the wrapper (kernels/lowrank.py) from the
// shapes and strides:
//
//   * three streaming routes, one per product kind, for r <= 4 and M laid
//     out with unit stride along its rows (lowrank_stream_launch, below).
//     Each reads or writes M once, as 16-byte accesses with several in
//     flight per thread, straight between device memory and registers;
//     only the small operands (Q, P, Q') are staged on chip;
//   * a general tiled kernel for every other call (odd sizes, strided
//     views, wide outputs: lowrank_matmul_launch):
//       - two tile shapes: "skinny" for n <= 4 (a 256 x n tile with n padded
//         to 2 or 4, one output row a thread, n accumulators) and "wide"
//         otherwise (a 32 x 128 tile, 4 x 4 outputs a thread, spread so
//         that a warp's 32 threads store 32 consecutive floats);
//       - A's and B's tiles are staged through shared memory with loads that
//         run along whichever of the operand's axes has the smaller stride;
//       - split-k: when the output tiles are too few to fill the card, k is
//         cut into fixed chunks, each block writes its partial tile to a
//         workspace, and a second kernel sums the chunks in chunk order.
//     Its scalar loads staged through shared memory, with a __syncthreads
//     pair per 32-wide k step, keep too few bytes in flight to cover the
//     latency of device memory: 1.2 TB/s on PowerSGD's shapes.
//
// Every chunking depends only on the shapes and the card's SM count and
// occupancy, and every partial sum is added in a fixed order (no float
// atomics), so results are the same from run to run.  FP32 FMA throughout,
// no tensor cores (TF32 would change the numbers).  The result differs from
// torch.matmul's (cuBLAS) in the order of summation only: within a few ulps
// of |A| @ |B| per element.
//
// The launchers allocate nothing (the caller passes the workspace that the
// matching *_workspace function asks for), launch on the caller's stream,
// do not synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxSplits = 65535;          // gridDim.y
constexpr int kReduceThreads = 256;

template <int BM, int BN, int BK, int TM, int TN>
struct Tile {
  static constexpr int kBM = BM, kBN = BN, kBK = BK, kTM = TM, kTN = TN;
  static constexpr int kTX = BN / TN;      // threads along n
  static constexpr int kTY = BM / TM;      // threads along m
  static constexpr int kThreads = kTX * kTY;
};

using Skinny2 = Tile<256, 2, 32, 1, 2>;
using Skinny4 = Tile<256, 4, 32, 1, 4>;
using Wide = Tile<32, 128, 16, 4, 4>;

// Output element (i0 + ty + i * TY, j0 + tx + j * TX) belongs to thread
// (ty, tx): neighbouring threads hold neighbouring columns (coalesced stores,
// conflict-free reads of the B tile) and a warp shares its rows (broadcast
// reads of the A tile).
template <class T>
__global__ void __launch_bounds__(T::kThreads)
lowrank_matmul_kernel(const float* __restrict__ a, const float* __restrict__ b,
            float* __restrict__ c, int m, int n, int k,
            int64_t sab, int64_t sai, int64_t sak,
            int64_t sbb, int64_t sbk, int64_t sbj,
            int tiles_n, int chunk, int64_t split_stride,
            bool a_k_fast, bool b_j_fast) {
  constexpr int BM = T::kBM, BN = T::kBN, BK = T::kBK, TM = T::kTM, TN = T::kTN;
  constexpr int TX = T::kTX, TY = T::kTY, NT = T::kThreads;
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];

  const int tile = blockIdx.x;
  const int i0 = (tile / tiles_n) * BM;
  const int j0 = (tile % tiles_n) * BN;
  const int kbeg = blockIdx.y * chunk;
  const int kend = min(k, kbeg + chunk);
  a += blockIdx.z * sab;
  b += blockIdx.z * sbb;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    const int kt = min(BK, kend - k0);
    // A tile (BM x kt rows of k): zeros outside the matrix and the chunk;
    // along i, only the kt rows the product reads
    const int a_elems = a_k_fast ? BM * BK : BM * kt;
#pragma unroll 4
    for (int e = threadIdx.x; e < a_elems; e += NT) {
      const int ii = a_k_fast ? e / BK : e % BM;
      const int kk = a_k_fast ? e % BK : e / BM;
      const int gi = i0 + ii;
      As[kk][ii] = (gi < m && kk < kt)
          ? a[static_cast<int64_t>(gi) * sai + static_cast<int64_t>(k0 + kk) * sak]
          : 0.f;
    }
    // B tile (kt x BN)
    const int b_elems = b_j_fast ? kt * BN : BK * BN;
#pragma unroll 4
    for (int e = threadIdx.x; e < b_elems; e += NT) {
      const int jj = b_j_fast ? e % BN : e / BK;
      const int kk = b_j_fast ? e / BN : e % BK;
      const int gj = j0 + jj;
      Bs[kk][jj] = (gj < n && kk < kt)
          ? b[static_cast<int64_t>(k0 + kk) * sbk + static_cast<int64_t>(gj) * sbj]
          : 0.f;
    }
    __syncthreads();
    if (kt == BK) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float av[TM], bv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) av[i] = As[kk][ty + i * TY];
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + j * TX];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    } else {
      for (int kk = 0; kk < kt; ++kk) {
        float av[TM], bv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) av[i] = As[kk][ty + i * TY];
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + j * TX];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  float* cb = c + blockIdx.y * split_stride
      + static_cast<int64_t>(blockIdx.z) * m * n;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gi = i0 + ty + i * TY;
    if (gi >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gj = j0 + tx + j * TX;
      if (gj < n) cb[static_cast<int64_t>(gi) * n + gj] = acc[i][j];
    }
  }
}

// c[i] = sum over s of ws[s * total + i], s = 0, 1, ... in order.
__global__ void __launch_bounds__(kReduceThreads)
lowrank_splitk_reduce_kernel(const float* __restrict__ ws, float* __restrict__ c,
                     int64_t total, int splits) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = ws[i];
    for (int sp = 1; sp < splits; ++sp) s += ws[sp * total + i];
    c[i] = s;
  }
}

enum class Shape { kSkinny2, kSkinny4, kWide };

struct Plan {
  Shape shape;
  int bm, bn, bk, threads;
  const void* kernel;
  int tiles_m, tiles_n, splits, chunk;
};

Plan make_plan(int batch, int m, int n, int k) {
  Plan p{};
  if (n <= 2) {
    p = {Shape::kSkinny2, Skinny2::kBM, Skinny2::kBN, Skinny2::kBK, Skinny2::kThreads,
         reinterpret_cast<const void*>(lowrank_matmul_kernel<Skinny2>)};
  } else if (n <= 4) {
    p = {Shape::kSkinny4, Skinny4::kBM, Skinny4::kBN, Skinny4::kBK, Skinny4::kThreads,
         reinterpret_cast<const void*>(lowrank_matmul_kernel<Skinny4>)};
  } else {
    p = {Shape::kWide, Wide::kBM, Wide::kBN, Wide::kBK, Wide::kThreads,
         reinterpret_cast<const void*>(lowrank_matmul_kernel<Wide>)};
  }
  p.tiles_m = (m + p.bm - 1) / p.bm;
  p.tiles_n = (n + p.bn - 1) / p.bn;
  // split k until two waves of resident blocks are in flight
  int device = 0, sms = 132, resident = 1;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, p.kernel, p.threads, 0);
  const long long target = 2LL * sms * (resident > 0 ? resident : 1);
  const long long tiles = static_cast<long long>(batch) * p.tiles_m * p.tiles_n;
  const long long k_tiles = (k + p.bk - 1) / p.bk;
  long long splits = (target + tiles - 1) / tiles;
  if (splits > k_tiles) splits = k_tiles;
  if (splits > kMaxSplits) splits = kMaxSplits;
  if (splits < 1) splits = 1;
  const long long per = (k + splits - 1) / splits;
  p.chunk = static_cast<int>((per + p.bk - 1) / p.bk * p.bk);
  p.splits = static_cast<int>((k + p.chunk - 1) / p.chunk);
  return p;
}

int64_t workspace_floats(const Plan& p, int batch, int m, int n) {
  return p.splits > 1 ? static_cast<int64_t>(p.splits) * batch * m * n : 0;
}

}  // namespace

// Floats of workspace lowrank_matmul_launch needs for these sizes (0: none).
extern "C" long long lowrank_matmul_workspace(int batch, int m, int n, int k) {
  if (batch <= 0 || m <= 0 || n <= 0 || k <= 0) return 0;
  const Plan p = make_plan(batch, m, n, k);
  return workspace_floats(p, batch, m, n);
}

extern "C" int lowrank_matmul_launch(const void* a, const void* b, void* c, void* ws,
                                     long long ws_floats, int batch, int m, int n,
                                     int k, long long sab, long long sai,
                                     long long sak, long long sbb, long long sbk,
                                     long long sbj, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0 || k <= 0 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(batch, m, n, k);
  const int64_t need = workspace_floats(p, batch, m, n);
  if (need > ws_floats || (need > 0 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = need > 0 ? static_cast<float*>(ws) : static_cast<float*>(c);
  const int64_t split_stride = static_cast<int64_t>(batch) * m * n;
  const dim3 grid(static_cast<unsigned>(p.tiles_m) * p.tiles_n, p.splits, batch);
  // tile loads run along the operand's axis of smaller stride; when k is
  // shorter than a tile (P @ Q'^T, k = r), along the other axis, which the
  // tile covers whole
  const bool a_k_fast = sak <= sai && k >= p.bk;
  const bool b_j_fast = sbj <= sbk || k < p.bk;
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
#define LOWRANK_LAUNCH(T)                                                  \
  lowrank_matmul_kernel<T><<<grid, T::kThreads, 0, s>>>(                   \
      A, B, out, m, n, k, sab, sai, sak, sbb, sbk, sbj, p.tiles_n, p.chunk, \
      split_stride, a_k_fast, b_j_fast)
  switch (p.shape) {
    case Shape::kSkinny2: LOWRANK_LAUNCH(Skinny2); break;
    case Shape::kSkinny4: LOWRANK_LAUNCH(Skinny4); break;
    case Shape::kWide: LOWRANK_LAUNCH(Wide); break;
  }
#undef LOWRANK_LAUNCH
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || need == 0) return static_cast<int>(err);
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  long long blocks = (split_stride + kReduceThreads - 1) / kReduceThreads;
  if (blocks > 8LL * sms) blocks = 8LL * sms;
  lowrank_splitk_reduce_kernel<<<static_cast<unsigned>(blocks), kReduceThreads, 0,
                                 s>>>(static_cast<const float*>(ws),
                                      static_cast<float*>(c), split_stride, p.splits);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Streaming routes (r <= 4).  M is the one large operand; each route moves
// its bytes once, as float4s, straight between device memory and registers:
//
//   1. row-dot, P = M @ Q: A = M with unit stride along k.  A warp streams
//      one row (or one k-chunk of a row) with ld.global.nc.L1::no_allocate,
//      kRowUnroll float4s (128 B) in flight a lane, multiplies them with
//      Q's chunk staged in shared memory and reduces the r dot products
//      with warp shuffles.  Warps walk rows grid-stride, with the grid sized
//      so that every warp gets the same number of rows, give or take one.
//      A long k (head.w: 768 rows of 50,304) is cut into chunks whose
//      partial sums go to the workspace.
//   2. column-accumulate, Q' = M^T @ P: A = M^T, so M is read row-major.
//      Each thread owns 4 consecutive columns (one float4) and walks every
//      kColTY-th row of a chunk, kColUnroll rows in flight, with 4r
//      accumulators; a block's kColTY row groups of 32 threads span 128
//      columns and are summed through shared memory in group order.  P's
//      rows for the chunk sit in shared memory, read by broadcast.  Row
//      chunks write partial (m, r) tiles to the workspace.
//   3. outer product, P @ Q'^T (k = r): each thread keeps the r x 4 values
//      of Q' for its float4 of columns in registers (the on-chip copy of the
//      small operand: it serves every row the thread writes), reads P's row
//      from shared memory by broadcast and stores its float4 of the output
//      row with st.global.cs (streaming: the kernel never reads it back).
//
// Routes 2 and 3 cut the rows into chunks so that the blocks fill the card
// in one wave of kColBlocksPerSM blocks an SM, each with the same number of
// rows, give or take one chunk's remainder.  The constants of route 2 were
// chosen on the H100 among 1-16 row groups, 4-16 rows in flight and 1-16
// blocks an SM (see PERF.md).  lowrank_stream_reduce_kernel adds the partial
// sums in a fixed order: each of an output's kSumSlices threads sums a run
// of consecutive chunks in chunk order, then the runs are added in order,
// so the result does not depend on the schedule.
// ---------------------------------------------------------------------------

namespace {

constexpr int kStreamThreads = 256;
constexpr int kStreamWarps = kStreamThreads / 32;
constexpr int kRowUnroll = 8;              // row-dot: float4s in flight a lane
constexpr int kRowChunkMax = 3072;         // row-dot: k-chunk (floats) of Q staged
constexpr int kRowChunkMin = 1024;         // row-dot: shortest chunk a split makes
constexpr int kColUnroll = 8;              // rows in flight a thread
constexpr int kColTY = 8;                  // row groups a column-accumulate block
constexpr int kColChunkMax = 2048;         // rows of P staged a block
constexpr int kColChunkMin = 32;           // fewest rows a chunk takes
constexpr int kColBlocksPerSM = 2;         // blocks an SM aimed at: enough bytes in flight
constexpr int kSumSlices = 32;             // reduce: threads an output

enum Route { kRowDot = 1, kColAcc = 2, kOuter = 3 };

__device__ __forceinline__ float4 ld_stream(const float* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

// out[split][z][i][r] (the workspace when k is cut into chunks, else C).
template <int R>
__global__ void __launch_bounds__(kStreamThreads)
lowrank_rowdot_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      float* __restrict__ out, int m, int k,
                      int64_t sab, int64_t sai, int64_t sbb, int64_t sbk,
                      int64_t sbj, int chunk, int64_t split_stride) {
  extern __shared__ float4 q_smem[];       // chunk x R floats of Q, row-major
  float* qs = reinterpret_cast<float*>(q_smem);
  const int z = blockIdx.z;
  const int kbeg = blockIdx.y * chunk;
  const int kc = min(chunk, k - kbeg);
  const float* bz = b + z * sbb;
  for (int e = threadIdx.x; e < kc * R; e += kStreamThreads) {
    const int kk = e / R, r = e % R;
    qs[e] = bz[static_cast<int64_t>(kbeg + kk) * sbk + static_cast<int64_t>(r) * sbj];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nv = kc / 4;
  const int warps = gridDim.x * kStreamWarps;
  float* outz = out + blockIdx.y * split_stride + static_cast<int64_t>(z) * m * R;
  const float* az = a + z * sab + kbeg;
  for (int i = blockIdx.x * kStreamWarps + warp; i < m; i += warps) {
    const float* row = az + static_cast<int64_t>(i) * sai;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int v0 = 0; v0 < nv; v0 += 32 * kRowUnroll) {
      float4 x[kRowUnroll];
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        const int v = v0 + u * 32 + lane;
        x[u] = v < nv ? ld_stream(row + 4 * v) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        const int v = v0 + u * 32 + lane;
        if (v < nv) {
          // Q's rows 4v .. 4v+3: q[c * R + r] = Q[4v + c][r]
          float q[4 * R];
#pragma unroll
          for (int w = 0; w < R; ++w) {
            const float4 t = q_smem[v * R + w];
            q[4 * w] = t.x; q[4 * w + 1] = t.y; q[4 * w + 2] = t.z; q[4 * w + 3] = t.w;
          }
#pragma unroll
          for (int r = 0; r < R; ++r) {
            acc[r] = fmaf(x[u].x, q[r], acc[r]);
            acc[r] = fmaf(x[u].y, q[R + r], acc[r]);
            acc[r] = fmaf(x[u].z, q[2 * R + r], acc[r]);
            acc[r] = fmaf(x[u].w, q[3 * R + r], acc[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) outz[static_cast<int64_t>(i) * R + r] = acc[r];
    }
  }
}

// A = M^T: a[z][j][i] at j (unit stride, the streamed axis) + i * sak.  A
// block of blockDim.x = TX * kColTY threads spans 4 * TX columns; row group
// ty takes the chunk's rows ty, ty + kColTY, ...  out[chunk][z][j][r].
template <int R>
__global__ void __launch_bounds__(kStreamThreads)
lowrank_colacc_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      float* __restrict__ out, int m, int k,
                      int64_t sab, int64_t sak, int64_t sbb, int64_t sbk,
                      int64_t sbj, int chunk, int64_t split_stride) {
  extern __shared__ float4 p_smem[];       // chunk x R floats of P
  __shared__ float red[kColTY - 1][4 * R][kStreamThreads / kColTY];
  float* ps = reinterpret_cast<float*>(p_smem);
  const int z = blockIdx.z;
  const int i0 = blockIdx.y * chunk;
  const int rows = min(chunk, k - i0);
  const float* bz = b + z * sbb;
  for (int e = threadIdx.x; e < rows * R; e += blockDim.x) {
    const int ii = e / R, r = e % R;
    ps[e] = bz[static_cast<int64_t>(i0 + ii) * sbk + static_cast<int64_t>(r) * sbj];
  }
  __syncthreads();

  const int tx_count = blockDim.x / kColTY;
  const int tx = threadIdx.x % tx_count, ty = threadIdx.x / tx_count;
  const int j = 4 * (blockIdx.x * tx_count + tx);    // first of 4 columns
  const bool live = j < m;
  float acc[4][R];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[c][r] = 0.f;
  const float* col = a + z * sab + static_cast<int64_t>(i0) * sak + j;
  if (live) {
    for (int ii0 = ty; ii0 < rows; ii0 += kColTY * kColUnroll) {
      float4 x[kColUnroll];
#pragma unroll
      for (int u = 0; u < kColUnroll; ++u) {
        const int ii = ii0 + u * kColTY;
        x[u] = ii < rows ? ld_stream(col + static_cast<int64_t>(ii) * sak)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kColUnroll; ++u) {
        const int ii = ii0 + u * kColTY;
        if (ii < rows) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float p = ps[ii * R + r];
            acc[0][r] = fmaf(x[u].x, p, acc[0][r]);
            acc[1][r] = fmaf(x[u].y, p, acc[1][r]);
            acc[2][r] = fmaf(x[u].z, p, acc[2][r]);
            acc[3][r] = fmaf(x[u].w, p, acc[3][r]);
          }
        }
      }
    }
  }
  if (ty > 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < R; ++r) red[ty - 1][c * R + r][tx] = acc[c][r];
  }
  __syncthreads();
  if (ty == 0 && live) {
    float* o = out + blockIdx.y * split_stride + (static_cast<int64_t>(z) * m + j) * R;
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float s = acc[c][r];
#pragma unroll
        for (int t = 0; t < kColTY - 1; ++t) s += red[t][c * R + r][tx];
        o[c * R + r] = s;
      }
  }
}

// C[z][i][j..j+3] = sum over r of A[z][i][r] * B[z][r][j..j+3], k = R; a
// block of blockDim.x threads spans 4 * blockDim.x columns.
template <int R>
__global__ void __launch_bounds__(kStreamThreads)
lowrank_outer_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ c, int m, int n,
                     int64_t sab, int64_t sai, int64_t sak,
                     int64_t sbb, int64_t sbk, int64_t sbj, int chunk) {
  extern __shared__ float4 p_smem[];       // chunk x R floats of A (P)
  float* ps = reinterpret_cast<float*>(p_smem);
  const int z = blockIdx.z;
  const int i0 = blockIdx.y * chunk;
  const int rows = min(chunk, m - i0);
  const float* az = a + z * sab;
  for (int e = threadIdx.x; e < rows * R; e += blockDim.x) {
    const int ii = e / R, r = e % R;
    ps[e] = az[static_cast<int64_t>(i0 + ii) * sai + static_cast<int64_t>(r) * sak];
  }
  __syncthreads();

  const int j = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (j >= n) return;
  const float* bz = b + z * sbb;
  float q[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
      q[r][cc] = bz[static_cast<int64_t>(r) * sbk + static_cast<int64_t>(j + cc) * sbj];
  float* cz = c + (static_cast<int64_t>(z) * m + i0) * n + j;
  for (int ii = 0; ii < rows; ++ii) {
    float p[R];
#pragma unroll
    for (int r = 0; r < R; ++r) p[r] = ps[ii * R + r];
    float4 o;
    o.x = p[0] * q[0][0]; o.y = p[0] * q[0][1];
    o.z = p[0] * q[0][2]; o.w = p[0] * q[0][3];
#pragma unroll
    for (int r = 1; r < R; ++r) {
      o.x = fmaf(p[r], q[r][0], o.x); o.y = fmaf(p[r], q[r][1], o.y);
      o.z = fmaf(p[r], q[r][2], o.z); o.w = fmaf(p[r], q[r][3], o.w);
    }
    __stcs(reinterpret_cast<float4*>(cz + static_cast<int64_t>(ii) * n), o);
  }
}

// c[i] = sum over s of ws[s * total + i]: thread y of output i sums chunks
// y * per .. (y + 1) * per - 1 in order, then thread 0 adds the kSumSlices
// sums in order.  A block holds 32 outputs.
__global__ void __launch_bounds__(32 * kSumSlices)
lowrank_stream_reduce_kernel(const float* __restrict__ ws, float* __restrict__ c,
                             int64_t total, int splits) {
  __shared__ float part[kSumSlices][33];
  const int x = threadIdx.x % 32, y = threadIdx.x / 32;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 32 + x;
  const int per = (splits + kSumSlices - 1) / kSumSlices;
  const int s0 = y * per, s1 = min(splits, s0 + per);
  float s = 0.f;
  if (i < total) {
    int sp = s0;
    for (; sp + 8 <= s1; sp += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = ws[(sp + u) * total + i];
#pragma unroll
      for (int u = 0; u < 8; ++u) s += v[u];
    }
    for (; sp < s1; ++sp) s += ws[sp * total + i];
  }
  part[y][x] = s;
  __syncthreads();
  if (y == 0 && i < total) {
    float t = part[0][x];
    for (int yy = 1; yy < kSumSlices; ++yy) t += part[yy][x];
    c[i] = t;
  }
}

struct StreamPlan {
  const void* kernel;
  dim3 grid;
  int threads;
  int chunk;        // k-chunk (row-dot) or rows a block (column-accumulate, outer)
  int splits;       // chunks whose partial sums go to the workspace
  size_t smem;      // dynamic shared memory
};

template <int R>
const void* stream_kernel(int route) {
  switch (route) {
    case kRowDot: return reinterpret_cast<const void*>(lowrank_rowdot_kernel<R>);
    case kColAcc: return reinterpret_cast<const void*>(lowrank_colacc_kernel<R>);
    default: return reinterpret_cast<const void*>(lowrank_outer_kernel<R>);
  }
}

const void* stream_kernel_for(int route, int r) {
  switch (r) {
    case 1: return stream_kernel<1>(route);
    case 2: return stream_kernel<2>(route);
    case 3: return stream_kernel<3>(route);
    default: return stream_kernel<4>(route);
  }
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// Resident blocks of ``kernel`` on the whole card.
long long resident_blocks(const void* kernel, int threads, size_t smem) {
  int device = 0, sms = 132, per_sm = 1;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  return static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
}

// route: kRowDot (m rows of k, r = n), kColAcc (m columns, k rows, r = n) or
// kOuter (m rows, n columns, r = k).  r in 1..4, checked by the caller.
StreamPlan make_stream_plan(int route, int batch, int m, int n, int k) {
  StreamPlan p{};
  if (route == kRowDot) {
    const int r = n;
    p.kernel = stream_kernel_for(route, r);
    p.threads = kStreamThreads;
    const long long warps = kStreamWarps
        * resident_blocks(p.kernel, p.threads, sizeof(float) * kRowChunkMax * r);
    // chunks of at most kRowChunkMax floats, more while the rows are too
    // few to give every resident warp a row-chunk, down to kRowChunkMin
    long long splits = ceil_div(k, kRowChunkMax);
    const long long want = ceil_div(warps, static_cast<long long>(batch) * m);
    const long long most = k / kRowChunkMin > 1 ? k / kRowChunkMin : 1;
    if (want > splits) splits = want < most ? want : most;
    if (splits < 1) splits = 1;
    p.chunk = static_cast<int>(ceil_div(ceil_div(k, splits), 4) * 4);
    p.splits = static_cast<int>(ceil_div(k, p.chunk));
    p.smem = sizeof(float) * p.chunk * r;
    // every warp gets ``rounds`` rows, or one fewer
    const long long groups = static_cast<long long>(p.splits) * batch;
    const long long rounds = ceil_div(groups * m, warps);
    const long long bx = ceil_div(ceil_div(m, rounds), kStreamWarps);
    p.grid = dim3(static_cast<unsigned>(bx), p.splits, batch);
    return p;
  }
  // column-accumulate: the rows of M are k; outer: the rows of C are m
  const int r = route == kColAcc ? n : k;
  const long long vecs = (route == kColAcc ? m : n) / 4;
  const int rows = route == kColAcc ? k : m;
  p.kernel = stream_kernel_for(route, r);
  const int ty = route == kColAcc ? kColTY : 1;
  const int most = kStreamThreads / ty;
  const long long tx = vecs < most ? ceil_div(vecs, 32) * 32 : most;
  p.threads = static_cast<int>(tx * ty);
  const long long tiles = ceil_div(vecs, tx);
  long long blocks = resident_blocks(p.kernel, p.threads,
                                     sizeof(float) * kColChunkMax * r);
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (blocks > static_cast<long long>(kColBlocksPerSM) * sms)
    blocks = static_cast<long long>(kColBlocksPerSM) * sms;
  long long chunks = blocks / (tiles * batch);
  if (chunks > rows / kColChunkMin) chunks = rows / kColChunkMin;
  if (chunks < ceil_div(rows, kColChunkMax)) chunks = ceil_div(rows, kColChunkMax);
  if (chunks < 1) chunks = 1;
  p.chunk = static_cast<int>(ceil_div(rows, chunks));
  p.splits = static_cast<int>(ceil_div(rows, p.chunk));
  p.smem = sizeof(float) * p.chunk * r;
  p.grid = dim3(static_cast<unsigned>(tiles), p.splits, batch);
  return p;
}

int64_t stream_workspace_floats(int route, const StreamPlan& p, int batch, int m,
                                int n) {
  if (route == kOuter || p.splits <= 1) return 0;
  return static_cast<int64_t>(p.splits) * batch * m * n;
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// Floats of workspace lowrank_stream_launch needs for this route and these
// sizes (0: none).
extern "C" long long lowrank_stream_workspace(int route, int batch, int m, int n,
                                              int k) {
  if (batch <= 0 || m <= 0 || n <= 0 || k <= 0) return 0;
  if (route != kRowDot && route != kColAcc && route != kOuter) return 0;
  const StreamPlan p = make_stream_plan(route, batch, m, n, k);
  return stream_workspace_floats(route, p, batch, m, n);
}

// C (batch, m, n) = A @ B on streaming route ``route``: 1 row-dot (n <= 4,
// sak == 1, k % 4 == 0), 2 column-accumulate (n <= 4, sai == 1, m % 4 ==
// 0), 3 outer product (k <= 4, n % 4 == 0; C's rows are the streamed axis).
// The streamed operand's row and batch strides must be multiples of 4 and
// its base 16-byte aligned; anything else returns cudaErrorInvalidValue.
extern "C" int lowrank_stream_launch(int route, const void* a, const void* b, void* c,
                                     void* ws, long long ws_floats, int batch, int m,
                                     int n, int k, long long sab, long long sai,
                                     long long sak, long long sbb, long long sbk,
                                     long long sbj, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0 || k <= 0 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  bool ok = false;
  switch (route) {
    case kRowDot:
      ok = n <= 4 && sak == 1 && k % 4 == 0 && sai % 4 == 0 && sab % 4 == 0
          && aligned16(a);
      break;
    case kColAcc:
      ok = n <= 4 && sai == 1 && m % 4 == 0 && sak % 4 == 0 && sab % 4 == 0
          && aligned16(a);
      break;
    case kOuter:
      ok = k <= 4 && n % 4 == 0 && aligned16(c);
      break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const StreamPlan p = make_stream_plan(route, batch, m, n, k);
  const int64_t need = stream_workspace_floats(route, p, batch, m, n);
  if (p.splits > 65535 || need > ws_floats || (need > 0 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  float* out = need > 0 ? static_cast<float*>(ws) : static_cast<float*>(c);
  const int64_t split_stride = static_cast<int64_t>(batch) * m * n;
  const int r = route == kOuter ? k : n;
#define LOWRANK_STREAM(R)                                                        \
  switch (route) {                                                               \
    case kRowDot:                                                                \
      lowrank_rowdot_kernel<R><<<p.grid, p.threads, p.smem, s>>>(                \
          A, B, out, m, k, sab, sai, sbb, sbk, sbj, p.chunk, split_stride);      \
      break;                                                                     \
    case kColAcc:                                                                \
      lowrank_colacc_kernel<R><<<p.grid, p.threads, p.smem, s>>>(                \
          A, B, out, m, k, sab, sak, sbb, sbk, sbj, p.chunk, split_stride);      \
      break;                                                                     \
    default:                                                                     \
      lowrank_outer_kernel<R><<<p.grid, p.threads, p.smem, s>>>(                 \
          A, B, out, m, n, sab, sai, sak, sbb, sbk, sbj, p.chunk);               \
  }
  switch (r) {
    case 1: LOWRANK_STREAM(1); break;
    case 2: LOWRANK_STREAM(2); break;
    case 3: LOWRANK_STREAM(3); break;
    default: LOWRANK_STREAM(4); break;
  }
#undef LOWRANK_STREAM
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || need == 0) return static_cast<int>(err);
  lowrank_stream_reduce_kernel<<<static_cast<unsigned>(ceil_div(split_stride, 32)),
                                 32 * kSumSlices, 0, s>>>(
      static_cast<const float*>(ws), static_cast<float*>(c), split_stride, p.splits);
  return static_cast<int>(cudaGetLastError());
}

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
// Design against that bound, simple first:
//   * one tiled kernel, two tile shapes: "skinny" for n <= 4 (a 256 x n tile
//     with n padded to 2 or 4, one output row a thread, n accumulators) and
//     "wide" otherwise (a 32 x 128 tile, 4 x 4 outputs a thread, spread so
//     that a warp's 32 threads store 32 consecutive floats);
//   * A's and B's tiles are staged through shared memory with loads that run
//     along whichever of the operand's axes has the smaller stride, so M is
//     read coalesced both as M and as M^T;
//   * split-k: when the output tiles are too few to fill the card (M^T @ P on
//     embed.table has 768 x 2 outputs and k = 50,304), k is cut into fixed
//     chunks, each block writes its partial tile to a workspace, and a second
//     kernel sums the chunks in chunk order.  The chunking depends only on the
//     shapes and the card's SM count, so results are the same from run to run
//     (no float atomics);
//   * FP32 FMA throughout, no tensor cores (TF32 would change the numbers).
//
// The result differs from torch.matmul's (cuBLAS) in the order of summation
// only: within a few ulps of |A| @ |B| per element.
//
// The launcher allocates nothing (the caller passes the workspace that
// lowrank_matmul_workspace asks for), launches on the caller's stream, does
// not synchronise, and returns cudaGetLastError().

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

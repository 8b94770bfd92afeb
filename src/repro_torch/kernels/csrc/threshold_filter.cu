// Threshold filter for Top-k / DGC sparsification on Hopper (sm_90a).
//
// Replaces the Pallas kernel
// src/repro/kernels/topk_threshold.py::threshold_filter.  For a flat float32
// vector of N elements cut into blocks of `block` elements (32,768, the TPU
// kernel's ELEMWISE_BLOCK) from element 0, and a threshold t read from
// device memory (so the host never waits for it):
//
//     y[i]      = |x[i]| >= t ? x[i] : +0.0     (NaN fails the test: 0)
//     counts[b] = survivors in block b          (int32; real elements only)
//
// The TPU kernel pads the last block with zeros and, at t = 0, counts them as
// survivors; this kernel, like the plain version threshold_filter_ref, counts
// only the N real elements.
//
// Bound: 4 B read and 4 B written per element (plus 4 B per block), one
// compare and one select: device-memory bytes bound it.  At full-width
// gpt2-paper a step's 35 buckets hold 190,532,352 elements: 1.52 GB, about
// 0.455 ms at 3.35 TB/s.
//
// Design against that bound (the shape of sign_compress.cu):
//   * one pass; each thread issues 8 float4 loads before it uses the first,
//     and a 1024-thread CTA covers a whole 32,768-element block in one round
//     of loads, so a bucket's blocks are all in flight at once;
//   * a grid-stride loop over blocks on as many CTAs as the SMs hold; each
//     block's count is a warp-shuffle sum and one pass over the warps' sums,
//     so nothing crosses CTAs and no atomics are needed;
//   * float4 loads and stores when x and y are 16-byte aligned and block is
//     a multiple of 4; any other view takes the scalar path; a ragged last
//     block is a shorter range, with nothing padded.
//
// y equals the plain version's bit for bit (x itself or +0.0), and so do
// the integer counts.
//
// The launcher allocates nothing, launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 8;                   // float4 a thread loads before use

__device__ __forceinline__ float keep_or_zero(float v, float t, int& count) {
  const bool keep = fabsf(v) >= t;
  count += keep;
  return keep ? v : 0.f;
}

// The block's sum, broadcast to every thread; safe to call once per loop
// iteration (the trailing barrier guards smem against the next write).
__device__ int block_sum(int v, int* smem) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (threadIdx.x % 32 == 0) smem[threadIdx.x / 32] = v;
  __syncthreads();
  v = smem[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) v += smem[w];
  __syncthreads();
  return v;
}

__global__ void __launch_bounds__(kThreads)
threshold_filter_kernel(const float* __restrict__ x, const float* __restrict__ tp,
                        float* __restrict__ y, int* __restrict__ counts,
                        int64_t n, int64_t block, int64_t nb, bool vec) {
  __shared__ int smem[kWarps];
  const float t = *tp;
  for (int64_t b = blockIdx.x; b < nb; b += gridDim.x) {
    const int64_t start = b * block;
    const int64_t len = (n - start < block) ? n - start : block;
    const float* xb = x + start;
    float* yb = y + start;
    const int64_t len4 = vec ? len / 4 : 0;
    const float4* x4 = reinterpret_cast<const float4*>(xb);
    float4* y4 = reinterpret_cast<float4*>(yb);
    int count = 0;
    for (int64_t base = 0; base < len4; base += static_cast<int64_t>(kThreads) * kLoads) {
      float4 v[kLoads];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int64_t i = base + threadIdx.x + static_cast<int64_t>(k) * kThreads;
        if (i < len4) v[k] = x4[i];
      }
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int64_t i = base + threadIdx.x + static_cast<int64_t>(k) * kThreads;
        if (i < len4) {
          float4 o;
          o.x = keep_or_zero(v[k].x, t, count);
          o.y = keep_or_zero(v[k].y, t, count);
          o.z = keep_or_zero(v[k].z, t, count);
          o.w = keep_or_zero(v[k].w, t, count);
          y4[i] = o;
        }
      }
    }
    // scalar tail: the last len % 4 elements of an aligned view, or all of
    // an unaligned one (len4 == 0)
    for (int64_t i = len4 * 4 + threadIdx.x; i < len; i += kThreads) {
      yb[i] = keep_or_zero(xb[i], t, count);
    }
    count = block_sum(count, smem);
    if (threadIdx.x == 0) counts[b] = count;
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

extern "C" int threshold_filter_launch(const void* x, const void* threshold, void* y,
                                       void* counts, long long n, long long block,
                                       void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (block <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long nb = (n + block - 1) / block;
  int device = 0;
  int sms = 132;
  int resident = 1;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, threshold_filter_kernel,
                                                kThreads, 0);
  long long grid = static_cast<long long>(sms) * (resident > 0 ? resident : 1);
  if (grid > nb) grid = nb;
  const bool vec = aligned(x, 16) && aligned(y, 16) && block % 4 == 0;
  threshold_filter_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(threshold),
      static_cast<float*>(y), static_cast<int*>(counts), n, block, nb, vec);
  return static_cast<int>(cudaGetLastError());
}

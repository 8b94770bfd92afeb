// EFsignSGD sign compression for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/sign_compress.py::sign_compress.
// For a flat float32 vector of N elements cut into blocks of `block`
// elements (32,768, the TPU kernel's ELEMWISE_BLOCK) from element 0:
//
//     signs[i]    = x[i] >= 0 ? +1 : -1         (int8; -0.0 gives +1, NaN -1)
//     partials[b] = sum of |x[i]| over block b   (float32)
//
// The wrapper finishes the scale mean(|x|) = sum(partials) / N with one torch
// reduction on the device, as the TPU kernel's caller does with jnp.sum.
//
// Bound: 4 B read and 1 B written per element (plus 4 B per block) for two
// operations, so device-memory bytes bound it.  At full-width gpt2-paper a
// step compresses 190,532,352 elements: 0.95 GB, about 0.28 ms at 3.35 TB/s.
//
// Design against that bound:
//   * one pass: x is read once; the signs and the block's |x| sum come from
//     the same registers, and each thread issues 8 float4 loads before it
//     uses the first;
//   * a grid-stride loop over blocks, on as many CTAs as the SMs hold at
//     once (no CTA waits for a slot while others loop); each block's sum is
//     a warp-shuffle tree and one pass over the warps' sums, so nothing
//     crosses CTAs and no atomics are needed;
//   * float4 loads and 4-byte stores of four signs when x is 16-byte
//     aligned, the signs 4-byte aligned and block a multiple of 4; a view at
//     any other element offset takes the scalar path; a ragged last block is
//     a shorter range, with nothing padded.
//
// The signs equal the plain version's bit for bit.  The partials sum in
// another order than torch's sum, so they agree to a few ulps, not bitwise.
//
// The launcher allocates nothing, launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 8;                   // float4 a thread loads before use

__device__ __forceinline__ uint32_t sign_byte(float v) {
  return v >= 0.f ? 0x01u : 0xffu;          // int8 +1 / -1
}

// The block's sum, broadcast to every thread; safe to call once per loop
// iteration (the trailing barrier guards smem against the next write).
__device__ float block_sum(float v, float* smem) {
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
sign_compress_kernel(const float* __restrict__ x, int8_t* __restrict__ signs,
                     float* __restrict__ partials, int64_t n, int64_t block,
                     int64_t nb, bool vec) {
  __shared__ float smem[kWarps];
  for (int64_t b = blockIdx.x; b < nb; b += gridDim.x) {
    const int64_t start = b * block;
    const int64_t len = (n - start < block) ? n - start : block;
    const float* xb = x + start;
    int8_t* sb = signs + start;
    const int64_t len4 = vec ? len / 4 : 0;
    const float4* x4 = reinterpret_cast<const float4*>(xb);
    uint32_t* s4 = reinterpret_cast<uint32_t*>(sb);
    float acc = 0.f;
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
          acc += fabsf(v[k].x);
          acc += fabsf(v[k].y);
          acc += fabsf(v[k].z);
          acc += fabsf(v[k].w);
          s4[i] = sign_byte(v[k].x) | (sign_byte(v[k].y) << 8)
              | (sign_byte(v[k].z) << 16) | (sign_byte(v[k].w) << 24);
        }
      }
    }
    // scalar tail: the last len % 4 elements of an aligned view, or all of
    // an unaligned one (len4 == 0)
    for (int64_t i = len4 * 4 + threadIdx.x; i < len; i += kThreads) {
      const float v = xb[i];
      acc += fabsf(v);
      sb[i] = static_cast<int8_t>(sign_byte(v));
    }
    acc = block_sum(acc, smem);
    if (threadIdx.x == 0) partials[b] = acc;
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

extern "C" int sign_compress_launch(const void* x, void* signs, void* partials,
                                    long long n, long long block, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (block <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long nb = (n + block - 1) / block;
  int device = 0;
  int sms = 132;
  int resident = 1;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, sign_compress_kernel,
                                                kThreads, 0);
  long long grid = static_cast<long long>(sms) * (resident > 0 ? resident : 1);
  if (grid > nb) grid = nb;
  const bool vec = aligned(x, 16) && aligned(signs, 4) && block % 4 == 0;
  sign_compress_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(signs),
      static_cast<float*>(partials), n, block, nb, vec);
  return static_cast<int>(cudaGetLastError());
}

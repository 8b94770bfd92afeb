// Block-scaled FP8 quantize / dequantize for Hopper (sm_90a).
//
// Replaces the Pallas kernels src/repro/kernels/quantize.py::quantize_fp8 and
// src/repro/kernels/quantize.py::dequantize_fp8.  For a flat float32 vector
// of N elements cut into blocks of `block` elements from element 0 (the last
// block may be short):
//
//     scale[b] = max(amax_b / 448, 1e-12)           (NaN if the block has one)
//     q[i]     = e4m3fn(x[i] / scale[i / block])
//     x'[i]    = float(q[i]) * scale[i / block]     (dequantize)
//
// Bound: quantize reads 4 B and writes 1 B per element (plus 4 B per block),
// dequantize reads 1 B and writes 4 B; both do a few operations per element,
// so both are bound by device-memory bytes.  At full-width gpt2-paper a step
// quantizes 190,532,352 elements: 0.95 GB, about 0.28 ms at 3.35 TB/s, and
// each set of dequantize calls over the tree costs the same.
//
// Design against that bound:
//   * one CTA per block, so the amax needs no pass across CTAs and a ragged
//     last block is just a shorter range: nothing is padded or copied;
//   * quantize reads the block once: with 16-byte aligned views a block of
//     up to 8,192 elements is held in registers (4 float4 in each of 512
//     threads) between the amax reduction and the cast; longer blocks read x
//     a second time, from L2.  Three such CTAs share an SM, so one CTA's
//     loads overlap another's divisions;
//   * dequantize issues all of a thread's loads (8 words of four codes)
//     before its first store;
//   * float4 loads and 4-byte stores of four fp8 values when x is 16-byte
//     aligned, q 4-byte aligned and block a multiple of 4; a view at any
//     other element offset (an arena slot) takes the scalar path;
//   * the amax propagates NaN (fmaxf would drop it), as torch.amax and
//     jnp.max do.
//
// Rounding: scale and x / scale use IEEE division (__fdiv_rn; no fast math),
// which is PyTorch's tensor division and the eager JAX reference.  (The
// reference's train step runs under jit, where XLA turns amax / 448 into
// amax * (1/448), one ulp away on some blocks.)  The cast to e4m3fn rounds to
// nearest even; it is the bit algorithm of PyTorch's c10 conversion, with
// |v| >= 480 and NaN going to NaN (0x7f).  Quantize never feeds it a finite
// |v| above 448.0001: x / scale is at most amax / scale.  The fp8 to float32
// conversion is exact and the dequantize product rounds once, so both
// kernels equal their plain PyTorch versions bit for bit.
//
// The launchers allocate nothing, launch on the caller's stream, do not
// synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;                 // dequantize
constexpr int kQuantThreads = 512;            // quantize: one 8,192-element block
constexpr int kCached = 4;                    // float4 a quantize thread holds
constexpr int kDequantLoads = 8;              // 4-code words a dequantize thread
                                              // loads before it stores
constexpr float kFp8Max = 448.0f;
constexpr float kMinScale = 1e-12f;

__device__ __forceinline__ float nanmax(float a, float b) {
  return (b > a || b != b) ? b : a;         // a NaN on either side wins
}

__device__ __forceinline__ float absmax4(float m, float4 v) {
  m = nanmax(m, fabsf(v.x));
  m = nanmax(m, fabsf(v.y));
  m = nanmax(m, fabsf(v.z));
  return nanmax(m, fabsf(v.w));
}

// The block's NaN-propagating max, broadcast to every thread.
template <int kWarps>
__device__ float block_nanmax(float v, float* smem) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = nanmax(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  if (threadIdx.x % 32 == 0) smem[threadIdx.x / 32] = v;
  __syncthreads();
  v = smem[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) v = nanmax(v, smem[w]);
  return v;
}

// float32 -> float8_e4m3fn bits, round to nearest even (PyTorch's c10
// algorithm; overflow and NaN give 0x7f).
__device__ __forceinline__ uint32_t f32_to_e4m3fn(float f) {
  constexpr uint32_t kFirstOverflow = 1087u << 20;   // 480.0f
  constexpr uint32_t kDenormMask = 141u << 23;
  uint32_t bits = __float_as_uint(f);
  const uint32_t sign = bits & 0x80000000u;
  bits ^= sign;
  uint32_t result;
  if (bits >= kFirstOverflow) {
    result = 0x7fu;
  } else if (bits < (121u << 23)) {                   // below 2^-6: subnormal
    bits = __float_as_uint(
        __fadd_rn(__uint_as_float(bits), __uint_as_float(kDenormMask)));
    result = (bits - kDenormMask) & 0xffu;
  } else {
    const uint32_t mant_odd = (bits >> 20) & 1u;
    bits += (static_cast<uint32_t>(7 - 127) << 23) + 0x7ffffu;
    bits += mant_odd;
    result = (bits >> 20) & 0xffu;
  }
  return result | (sign >> 24);
}

// float8_e4m3fn bits -> float32, exact (NaN as c10 decodes it).
__device__ __forceinline__ float e4m3fn_to_f32(uint32_t b) {
  const uint32_t sign = (b & 0x80u) << 24;
  const uint32_t exp = (b >> 3) & 0xfu;
  const uint32_t mant = b & 0x7u;
  if (exp == 0xfu && mant == 0x7u) return __uint_as_float(sign | 0x7ff00000u);
  if (exp == 0u) {                                    // subnormal: mant * 2^-9
    return __uint_as_float(sign | __float_as_uint(static_cast<float>(mant) * 0x1p-9f));
  }
  return __uint_as_float(sign | ((exp + 120u) << 23) | (mant << 20));
}

__device__ __forceinline__ uint32_t quantize4(float4 v, float scale) {
  return f32_to_e4m3fn(__fdiv_rn(v.x, scale))
      | (f32_to_e4m3fn(__fdiv_rn(v.y, scale)) << 8)
      | (f32_to_e4m3fn(__fdiv_rn(v.z, scale)) << 16)
      | (f32_to_e4m3fn(__fdiv_rn(v.w, scale)) << 24);
}

__device__ __forceinline__ float4 dequantize4(uint32_t w, float s) {
  return make_float4(__fmul_rn(e4m3fn_to_f32(w & 0xffu), s),
                     __fmul_rn(e4m3fn_to_f32((w >> 8) & 0xffu), s),
                     __fmul_rn(e4m3fn_to_f32((w >> 16) & 0xffu), s),
                     __fmul_rn(e4m3fn_to_f32(w >> 24), s));
}

// 512 threads and at most 42 registers, so three CTAs share an SM and one
// CTA's loads overlap another's division and cast.
__global__ void __launch_bounds__(kQuantThreads, 3)
quantize_fp8_kernel(const float* __restrict__ x, uint8_t* __restrict__ q,
                    float* __restrict__ scales, int64_t n, int64_t block,
                    bool vec) {
  constexpr int kThreads = kQuantThreads;
  __shared__ float smem[kThreads / 32];
  const int64_t start = static_cast<int64_t>(blockIdx.x) * block;
  const int64_t len = (n - start < block) ? n - start : block;
  const float* xb = x + start;
  uint8_t* qb = q + start;
  const int64_t len4 = vec ? len / 4 : 0;
  const float4* x4 = reinterpret_cast<const float4*>(xb);
  const bool cached = len4 <= static_cast<int64_t>(kThreads) * kCached;

  float4 cache[kCached];
  float amax = 0.f;
  if (cached) {
#pragma unroll
    for (int k = 0; k < kCached; ++k) {
      const int64_t i = threadIdx.x + static_cast<int64_t>(k) * kThreads;
      if (i < len4) {
        cache[k] = x4[i];
        amax = absmax4(amax, cache[k]);
      }
    }
  } else {
    for (int64_t i = threadIdx.x; i < len4; i += kThreads) amax = absmax4(amax, x4[i]);
  }
  // scalar tail: the last len % 4 elements of an aligned view, or all of an
  // unaligned one (len4 == 0)
  for (int64_t i = len4 * 4 + threadIdx.x; i < len; i += kThreads) {
    amax = nanmax(amax, fabsf(xb[i]));
  }
  amax = block_nanmax<kThreads / 32>(amax, smem);

  float scale = __fdiv_rn(amax, kFp8Max);
  if (scale < kMinScale) scale = kMinScale;           // NaN stays NaN
  if (threadIdx.x == 0) scales[blockIdx.x] = scale;

  uint32_t* q4 = reinterpret_cast<uint32_t*>(qb);
  if (cached) {
#pragma unroll
    for (int k = 0; k < kCached; ++k) {
      const int64_t i = threadIdx.x + static_cast<int64_t>(k) * kThreads;
      if (i < len4) q4[i] = quantize4(cache[k], scale);
    }
  } else {
    for (int64_t i = threadIdx.x; i < len4; i += kThreads) q4[i] = quantize4(x4[i], scale);
  }
  for (int64_t i = len4 * 4 + threadIdx.x; i < len; i += kThreads) {
    qb[i] = static_cast<uint8_t>(f32_to_e4m3fn(__fdiv_rn(xb[i], scale)));
  }
}

__global__ void __launch_bounds__(kThreads)
dequantize_fp8_kernel(const uint8_t* __restrict__ q,
                      const float* __restrict__ scales, float* __restrict__ out,
                      int64_t n, int64_t block, bool vec) {
  const int64_t start = static_cast<int64_t>(blockIdx.x) * block;
  const int64_t len = (n - start < block) ? n - start : block;
  const float s = scales[blockIdx.x];
  const uint8_t* qb = q + start;
  float* ob = out + start;
  const int64_t len4 = vec ? len / 4 : 0;
  const uint32_t* q4 = reinterpret_cast<const uint32_t*>(qb);
  float4* o4 = reinterpret_cast<float4*>(ob);
  // all of a thread's loads go out before its first store
  for (int64_t base = 0; base < len4; base += static_cast<int64_t>(kThreads) * kDequantLoads) {
    uint32_t w[kDequantLoads];
#pragma unroll
    for (int k = 0; k < kDequantLoads; ++k) {
      const int64_t i = base + threadIdx.x + static_cast<int64_t>(k) * kThreads;
      if (i < len4) w[k] = q4[i];
    }
#pragma unroll
    for (int k = 0; k < kDequantLoads; ++k) {
      const int64_t i = base + threadIdx.x + static_cast<int64_t>(k) * kThreads;
      if (i < len4) o4[i] = dequantize4(w[k], s);
    }
  }
  for (int64_t i = len4 * 4 + threadIdx.x; i < len; i += kThreads) {
    ob[i] = __fmul_rn(e4m3fn_to_f32(qb[i]), s);
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

int blocks_of(long long n, long long block, unsigned* grid) {
  if (block <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long nb = (n + block - 1) / block;
  if (nb > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  *grid = static_cast<unsigned>(nb);
  return static_cast<int>(cudaSuccess);
}

}  // namespace

extern "C" int quantize_fp8_launch(const void* x, void* q, void* scales,
                                   long long n, long long block, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  unsigned grid = 0;
  const int err = blocks_of(n, block, &grid);
  if (err != static_cast<int>(cudaSuccess)) return err;
  const bool vec = aligned(x, 16) && aligned(q, 4) && block % 4 == 0;
  quantize_fp8_kernel<<<grid, kQuantThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<uint8_t*>(q),
      static_cast<float*>(scales), n, block, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dequantize_fp8_launch(const void* q, const void* scales, void* out,
                                     long long n, long long block, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  unsigned grid = 0;
  const int err = blocks_of(n, block, &grid);
  if (err != static_cast<int>(cudaSuccess)) return err;
  const bool vec = aligned(q, 4) && aligned(out, 16) && block % 4 == 0;
  dequantize_fp8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<const float*>(scales),
      static_cast<float*>(out), n, block, vec);
  return static_cast<int>(cudaGetLastError());
}

// COVAP error-feedback update for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/ef_covap.py::ef_update.
// For one bucket segment of N float32 elements and a coefficient c:
//
//     t    = g + c * r
//     send = t  (selected bucket)   or 0  (unselected)
//     r'   = 0  (selected bucket)   or t  (unselected)
//
// Bound: each element reads g and r and writes send and r' once, 16 bytes
// of device-memory traffic for 2 flops, so the kernel is memory-bound by a
// wide margin (about 0.125 flop per byte against the H100's ~20 float32
// flops per byte).  At full-width gpt2-paper a step moves 190,532,352
// elements x 16 B = 3.05 GB, about 0.91 ms at 3.35 TB/s.
//
// Design against that bound:
//   * one pass: g and r are read once and both outputs written once;
//   * 16-byte vector loads and stores (float4) whenever all four pointers
//     are 16-byte aligned, plus a scalar tail for N not divisible by 4; an
//     unaligned view takes the scalar path for all of its elements, and
//     nothing is padded to a block multiple;
//   * a grid-stride loop over a grid capped at 16 blocks per SM, so a
//     26 MB segment runs a few iterations per thread instead of launching
//     one block per 1,024 elements;
//   * the selected / unselected split is a template parameter, so each
//     specialisation stores constants without a branch per element.
//
// Rounding: t is computed as __fadd_rn(g, __fmul_rn(c, r)), two roundings
// with no FMA contraction, which is the plain PyTorch expression g + c * r
// bit for bit.  (The Pallas kernel compiles to one FMA; the two differ by
// at most one rounding of the product.)
//
// The launcher allocates nothing, launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError() so that a refused launch is
// reported to the Python wrapper.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 16;

__device__ __forceinline__ float compensate(float g, float r, float c) {
  return __fadd_rn(g, __fmul_rn(c, r));
}

template <bool kSelected>
__global__ void __launch_bounds__(kThreads)
ef_update_kernel(const float* __restrict__ g, const float* __restrict__ r,
                 float c, float* __restrict__ send, float* __restrict__ rnew,
                 int64_t n, int64_t n4) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;

  const float4* __restrict__ g4 = reinterpret_cast<const float4*>(g);
  const float4* __restrict__ r4 = reinterpret_cast<const float4*>(r);
  float4* __restrict__ send4 = reinterpret_cast<float4*>(send);
  float4* __restrict__ rnew4 = reinterpret_cast<float4*>(rnew);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int64_t i = first; i < n4; i += stride) {
    const float4 gv = g4[i];
    const float4 rv = r4[i];
    float4 t;
    t.x = compensate(gv.x, rv.x, c);
    t.y = compensate(gv.y, rv.y, c);
    t.z = compensate(gv.z, rv.z, c);
    t.w = compensate(gv.w, rv.w, c);
    send4[i] = kSelected ? t : zero4;
    rnew4[i] = kSelected ? zero4 : t;
  }
  // scalar tail: the last n % 4 elements of an aligned view, or every
  // element of an unaligned one (n4 == 0)
  for (int64_t i = n4 * 4 + first; i < n; i += stride) {
    const float t = compensate(g[i], r[i], c);
    send[i] = kSelected ? t : 0.f;
    rnew[i] = kSelected ? 0.f : t;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" int ef_update_launch(const void* g, const void* r, float c,
                                void* send, void* rnew, long long n,
                                int selected, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const bool vec = aligned16(g) && aligned16(r) && aligned16(send) && aligned16(rnew);
  const int64_t n4 = vec ? n / 4 : 0;
  const int64_t work = vec ? n4 + (n - n4 * 4) : n;

  int device = 0;
  int sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(g);
  const float* rp = static_cast<const float*>(r);
  float* sp = static_cast<float*>(send);
  float* qp = static_cast<float*>(rnew);
  if (selected) {
    ef_update_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        gp, rp, c, sp, qp, n, n4);
  } else {
    ef_update_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        gp, rp, c, sp, qp, n, n4);
  }
  return static_cast<int>(cudaGetLastError());
}

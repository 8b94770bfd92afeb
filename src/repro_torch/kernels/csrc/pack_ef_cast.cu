// Fused arena pack + error feedback + wire cast for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/pack_ef_cast.py::pack_ef_cast.
// For one bucket segment of N float32 elements, a coefficient c and the
// static specialisations selected x wire type (float32, bfloat16, float16):
//
//     t    = g + c * r
//     wire = cast(t)               selected bucket; nothing is written for
//                                  an unselected one (it has no arena slot)
//     r'   = t - float(cast(t))    selected with a cast
//            0                     selected without a cast
//            t                     unselected
//
// The wire pointer is the segment's range inside its bucket's arena slot,
// so the kernel writes the wire values straight into the flat buffer the
// collective reads: the pack itself is the only copy.
//
// Bound: per element the kernel reads g and r (8 B) and writes r' (4 B)
// and, for a selected bucket, the wire value (4 B, or 2 B with a cast):
// 16 / 14 / 12 B for selected-f32 / selected-cast / unselected, against
// 2-4 flops.  It is memory-bound by a wide margin; at full-width
// gpt2-paper a phase-0 step packs 50,925,312 selected and 139,607,040
// unselected elements, 2.49 GB, about 0.74 ms at 3.35 TB/s.
//
// Design against that bound:
//   * one pass, no padding to a block multiple (the TPU kernel pads every
//     segment to 32,768 elements): a grid-stride loop over a grid capped
//     at 16 blocks per SM;
//   * 16-byte loads of g and r and 16-byte stores of r' wherever the three
//     share their alignment; a scalar head of up to 3 elements is peeled
//     off so a view that starts mid-vector still streams as float4, and a
//     scalar tail takes the last N % 4;
//   * the wire is tested on its own: four wire values go out as one 16-
//     or 8-byte store when the wire pointer is aligned for it after the
//     peel, and as four scalar stores otherwise, so a slot at an odd
//     element offset of a 2-byte plane does not push g and r off the
//     vector path;
//   * selected x wire type and the wire store width are template
//     parameters, so each of the seven instantiations is branch-free per
//     element.
//
// Rounding: t = __fadd_rn(g, __fmul_rn(c, r)), two roundings with no FMA
// contraction, which is the plain PyTorch expression g + c * r bit for
// bit.  The casts are __float2bfloat16_rn / __float2half_rn (round to
// nearest even, overflow to inf as PyTorch's .to() does), and
// r' = __fsub_rn(t, float(cast(t))).  (The Pallas kernel contracts g + c*r
// to one FMA, so the two may differ by one rounding of the product.)
//
// The launcher allocates nothing, launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError() so that a refused launch is
// reported to the Python wrapper.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 16;

__device__ __forceinline__ float compensate(float g, float r, float c) {
  return __fadd_rn(g, __fmul_rn(c, r));
}

// Wire types: what one element is stored as, four of them as one vector,
// and the cast with the value it rounds to.
struct WireF32 {
  using Store = float;
  using Store4 = float4;
  static constexpr bool kCast = false;
  __device__ __forceinline__ static float to_wire(float t, float& back) {
    back = t;
    return t;
  }
  __device__ __forceinline__ static float4 pack4(const float* s) {
    return make_float4(s[0], s[1], s[2], s[3]);
  }
};

struct WireBF16 {
  using Store = unsigned short;
  using Store4 = uint2;
  static constexpr bool kCast = true;
  __device__ __forceinline__ static unsigned short to_wire(float t, float& back) {
    const __nv_bfloat16 q = __float2bfloat16_rn(t);
    back = __bfloat162float(q);
    return __bfloat16_as_ushort(q);
  }
  __device__ __forceinline__ static uint2 pack4(const unsigned short* s) {
    return make_uint2(static_cast<unsigned>(s[0]) | (static_cast<unsigned>(s[1]) << 16),
                      static_cast<unsigned>(s[2]) | (static_cast<unsigned>(s[3]) << 16));
  }
};

struct WireF16 {
  using Store = unsigned short;
  using Store4 = uint2;
  static constexpr bool kCast = true;
  __device__ __forceinline__ static unsigned short to_wire(float t, float& back) {
    const __half q = __float2half_rn(t);
    back = __half2float(q);
    return __half_as_ushort(q);
  }
  __device__ __forceinline__ static uint2 pack4(const unsigned short* s) {
    return make_uint2(static_cast<unsigned>(s[0]) | (static_cast<unsigned>(s[1]) << 16),
                      static_cast<unsigned>(s[2]) | (static_cast<unsigned>(s[3]) << 16));
  }
};

// One element of a selected bucket: the wire value and the residual.
template <class W>
__device__ __forceinline__ float pack_selected(float t, typename W::Store& s) {
  float back;
  s = W::to_wire(t, back);
  if constexpr (W::kCast) {
    return __fsub_rn(t, back);
  } else {
    return 0.f;
  }
}

// Elements [head, head + 4 * nvec) go through the float4 body; the peeled
// head [0, head) and the tail [head + 4 * nvec, n) through the scalar loop.
// An unaligned view has head == nvec == 0: every element is scalar.
template <bool kSelected, class W, bool kWireVec>
__global__ void __launch_bounds__(kThreads)
pack_ef_cast_kernel(const float* __restrict__ g, const float* __restrict__ r,
                    float c, typename W::Store* __restrict__ wire,
                    float* __restrict__ rnew, int64_t n, int64_t head,
                    int64_t nvec) {
  using Store = typename W::Store;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;

  const float4* __restrict__ g4 = reinterpret_cast<const float4*>(g + head);
  const float4* __restrict__ r4 = reinterpret_cast<const float4*>(r + head);
  float4* __restrict__ q4 = reinterpret_cast<float4*>(rnew + head);
  for (int64_t i = first; i < nvec; i += stride) {
    const float4 gv = g4[i];
    const float4 rv = r4[i];
    const float t[4] = {compensate(gv.x, rv.x, c), compensate(gv.y, rv.y, c),
                        compensate(gv.z, rv.z, c), compensate(gv.w, rv.w, c)};
    if constexpr (!kSelected) {
      q4[i] = make_float4(t[0], t[1], t[2], t[3]);
    } else {
      Store s[4];
      float q[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) q[k] = pack_selected<W>(t[k], s[k]);
      q4[i] = make_float4(q[0], q[1], q[2], q[3]);
      if constexpr (kWireVec) {
        reinterpret_cast<typename W::Store4*>(wire + head)[i] = W::pack4(s);
      } else {
        Store* w = wire + head + 4 * i;
#pragma unroll
        for (int k = 0; k < 4; ++k) w[k] = s[k];
      }
    }
  }

  const int64_t tail = head + 4 * nvec;
  const int64_t nscalar = head + (n - tail);
  for (int64_t j = first; j < nscalar; j += stride) {
    const int64_t i = j < head ? j : tail + (j - head);
    const float t = compensate(g[i], r[i], c);
    if constexpr (!kSelected) {
      rnew[i] = t;
    } else {
      Store s;
      rnew[i] = pack_selected<W>(t, s);
      wire[i] = s;
    }
  }
}

template <bool kSelected, class W, bool kWireVec>
int launch(const float* g, const float* r, float c, void* wire, float* rnew,
           int64_t n, int64_t head, int64_t nvec, unsigned blocks,
           cudaStream_t s) {
  pack_ef_cast_kernel<kSelected, W, kWireVec><<<blocks, kThreads, 0, s>>>(
      g, r, c, static_cast<typename W::Store*>(wire), rnew, n, head, nvec);
  return static_cast<int>(cudaGetLastError());
}

template <class W>
int launch_selected(bool wire_vec, const float* g, const float* r, float c,
                    void* wire, float* rnew, int64_t n, int64_t head,
                    int64_t nvec, unsigned blocks, cudaStream_t s) {
  return wire_vec
      ? launch<true, W, true>(g, r, c, wire, rnew, n, head, nvec, blocks, s)
      : launch<true, W, false>(g, r, c, wire, rnew, n, head, nvec, blocks, s);
}

uintptr_t addr(const void* p) { return reinterpret_cast<uintptr_t>(p); }

}  // namespace

// wire_kind: 0 float32, 1 bfloat16, 2 float16.  ``wire`` is not read or
// written when ``selected`` is 0 and may then be null.
extern "C" int pack_ef_cast_launch(const void* g, const void* r, float c,
                                   void* wire, void* rnew, long long n,
                                   int selected, int wire_kind, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (wire_kind < 0 || wire_kind > 2 || (selected && wire == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t wsize = wire_kind == 0 ? 4 : 2;

  // float4 body: g, r and r' must share their offset within 16 bytes; the
  // head peels the elements before the first 16-byte boundary.
  const uintptr_t mis = addr(g) % 16;
  const bool vec = mis % 4 == 0 && addr(r) % 16 == mis && addr(rnew) % 16 == mis;
  int64_t head = vec ? static_cast<int64_t>((16 - mis) % 16 / 4) : 0;
  if (head > n) head = n;
  const int64_t nvec = vec ? (n - head) / 4 : 0;
  if (nvec == 0) head = 0;
  const bool wire_vec =
      selected && nvec > 0 && (addr(wire) + head * wsize) % (4 * wsize) == 0;

  int device = 0;
  int sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t work = nvec + (n - 4 * nvec);
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  const unsigned nb = static_cast<unsigned>(blocks);

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(g);
  const float* rp = static_cast<const float*>(r);
  float* qp = static_cast<float*>(rnew);
  if (!selected) {
    return launch<false, WireF32, false>(gp, rp, c, nullptr, qp, n, head, nvec, nb, s);
  }
  switch (wire_kind) {
    case 0:
      return launch_selected<WireF32>(wire_vec, gp, rp, c, wire, qp, n, head, nvec, nb, s);
    case 1:
      return launch_selected<WireBF16>(wire_vec, gp, rp, c, wire, qp, n, head, nvec, nb, s);
    default:
      return launch_selected<WireF16>(wire_vec, gp, rp, c, wire, qp, n, head, nvec, nb, s);
  }
}

// AdamW's whole step for one parameter leaf, in place, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference leaves AdamW to XLA, which fuses
// the update into one pass over each leaf on its own.  PyTorch runs it as
// separate elementwise operations (optim/optimizers.py ``adamw.update``
// then ``apply_updates``), each of which reads and writes whole leaves:
// about 176 B a parameter with f32 params and grads and bf16 moments, the
// global norm included.  This kernel is that arithmetic in one pass.  Per
// element, with the moments m, v in their own dtype (f32 or bf16), the
// params p and grads g each f32 or bf16, and bc1, bc2 the bias corrections
// read from two 0-dim f32 device tensors:
//
//     m' = to_m(f32(b1) * m + f32(1 - b1) * g)
//     v' = to_m(f32(b2) * v + f32(1 - b2) * g * g)
//     u  = (m' / bc1) / (sqrt(v' / bc2) + f32(eps))
//     u  = u + f32(wd) * p                              (when wd != 0)
//     p' = to_p(p + f32(-lr) * u)
//
// and, when given a partials buffer, each block writes the sum of g * g
// over its elements (the global norm's share of this leaf).
//
// Bound: each element reads g, p, m, v once and writes p, m, v once: 20 B
// with f32 params and grads and bf16 moments, 28 B with f32 moments, 14 B
// with everything in bf16, against some 15 flops.  It is memory-bound by a
// wide margin; deepseek-moe-16b at 2 layers (1,595,156,480 parameters, bf16
// moments) moves 31.9 GB a step, 9.5 ms at 3.35 TB/s.
//
// Design against that bound:
//   * one pass, in place: nothing but p, m and v is written, and the norm's
//     square is taken from the same read of g;
//   * 8 elements a thread per iteration, loaded and stored as 16-byte words
//     (two a leaf for f32, one for bf16) whenever all four pointers are
//     16-byte aligned, with a scalar tail for N % 8; an unaligned view takes
//     the scalar loop for all of its elements;
//   * a grid-stride loop over a grid the wrapper sizes from N alone
//     (capped at kMinBlocksPerSm blocks per SM, which __launch_bounds__
//     guarantees fit at once: one wave, so every block streams to the end
//     of the leaf together), so it can place each block's partial in one
//     buffer for all the leaves of a step;
//   * the three dtypes and the norm are template parameters: one algorithm
//     whose loads and stores differ by dtype.
//
// Rounding: every product, sum, quotient and root is one IEEE operation
// rounded to nearest (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), with no
// FMA contraction, in the order the plain PyTorch expressions take, and the
// casts round to nearest even (__float2bfloat16_rn, as PyTorch's .to()).
// So on the card p', m' and v' equal the plain path's bit for bit.  The
// partials accumulate the f32 squares in double inside a thread and a
// block, in a fixed order, and round once to f32: deterministic from run to
// run, within 1e-6 relative of ``global_norm``'s f32 sum.
//
// The launcher allocates nothing, launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError() so that a refused launch is
// reported to the Python wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;
// kernels/adamw_fused.py BLOCKS_PER_SM: the grid's cap, resident at once
constexpr int kMinBlocksPerSm = 4;

enum DtypeCode { kFloat32 = 0, kBFloat16 = 1 };

struct Hyper {
  float b1, one_minus_b1, b2, one_minus_b2, eps, wd, neg_lr;
  int decay;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16-byte words holding kVec elements of T
template <typename T>
struct Words {
  static constexpr int value = kVec * static_cast<int>(sizeof(T)) / 16;
};

template <typename T>
__device__ __forceinline__ void load_vec(const T* base, int64_t i, T (&out)[kVec]) {
  const uint4* src = reinterpret_cast<const uint4*>(base) + i * Words<T>::value;
  uint4* dst = reinterpret_cast<uint4*>(out);
#pragma unroll
  for (int w = 0; w < Words<T>::value; ++w) dst[w] = src[w];
}

template <typename T>
__device__ __forceinline__ void store_vec(T* base, int64_t i, const T (&in)[kVec]) {
  uint4* dst = reinterpret_cast<uint4*>(base) + i * Words<T>::value;
  const uint4* src = reinterpret_cast<const uint4*>(in);
#pragma unroll
  for (int w = 0; w < Words<T>::value; ++w) dst[w] = src[w];
}

// One element's step, in place on p, m, v; returns g * g.
template <typename P, typename M>
__device__ __forceinline__ float step_element(P& p, float g, M& m, M& v, float bc1,
                                              float bc2, const Hyper& h) {
  const float g2 = __fmul_rn(g, g);
  m = narrow<M>(__fadd_rn(__fmul_rn(h.b1, widen(m)), __fmul_rn(h.one_minus_b1, g)));
  v = narrow<M>(__fadd_rn(__fmul_rn(h.b2, widen(v)), __fmul_rn(h.one_minus_b2, g2)));
  const float m_hat = __fdiv_rn(widen(m), bc1);
  const float v_hat = __fdiv_rn(widen(v), bc2);
  float u = __fdiv_rn(m_hat, __fadd_rn(__fsqrt_rn(v_hat), h.eps));
  const float pf = widen(p);
  if (h.decay) u = __fadd_rn(u, __fmul_rn(h.wd, pf));
  p = narrow<P>(__fadd_rn(pf, __fmul_rn(h.neg_lr, u)));
  return g2;
}

// The block's sum of x, valid in thread 0.
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warp_sums[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = x;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
  }
  return total;
}

template <typename P, typename G, typename M, bool kNorm>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
adamw_fused_kernel(P* __restrict__ p, const G* __restrict__ g, M* __restrict__ m,
                   M* __restrict__ v, const float* __restrict__ bc1_ptr,
                   const float* __restrict__ bc2_ptr, Hyper h, int64_t n,
                   int64_t n_vec, float* __restrict__ partials) {
  const float bc1 = *bc1_ptr;
  const float bc2 = *bc2_ptr;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  double sq = 0.0;

  for (int64_t i = first; i < n_vec; i += stride) {
    alignas(16) P pv[kVec];
    alignas(16) G gv[kVec];
    alignas(16) M mv[kVec];
    alignas(16) M vv[kVec];
    load_vec(p, i, pv);
    load_vec(g, i, gv);
    load_vec(m, i, mv);
    load_vec(v, i, vv);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float g2 = step_element(pv[k], widen(gv[k]), mv[k], vv[k], bc1, bc2, h);
      if (kNorm) sq += static_cast<double>(g2);
    }
    store_vec(p, i, pv);
    store_vec(m, i, mv);
    store_vec(v, i, vv);
  }
  // scalar tail: the last n % 8 elements of an aligned leaf, or every
  // element of an unaligned one (n_vec == 0)
  for (int64_t i = n_vec * kVec + first; i < n; i += stride) {
    P pe = p[i];
    M me = m[i];
    M ve = v[i];
    const float g2 = step_element(pe, widen(g[i]), me, ve, bc1, bc2, h);
    p[i] = pe;
    m[i] = me;
    v[i] = ve;
    if (kNorm) sq += static_cast<double>(g2);
  }
  if (kNorm) {
    const double total = block_sum(sq);
    if (threadIdx.x == 0) partials[blockIdx.x] = static_cast<float>(total);
  }
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

struct Launch {
  void* p;
  const void* g;
  void* m;
  void* v;
  const float* bc1;
  const float* bc2;
  Hyper h;
  int64_t n;
  unsigned blocks;
  float* partials;
  cudaStream_t stream;
};

template <typename P, typename G, typename M>
int launch_typed(const Launch& a) {
  const bool vec = aligned16(a.p) && aligned16(a.g) && aligned16(a.m) && aligned16(a.v);
  const int64_t n_vec = vec ? a.n / kVec : 0;
  P* p = static_cast<P*>(a.p);
  const G* g = static_cast<const G*>(a.g);
  M* m = static_cast<M*>(a.m);
  M* v = static_cast<M*>(a.v);
  if (a.partials != nullptr) {
    adamw_fused_kernel<P, G, M, true><<<a.blocks, kThreads, 0, a.stream>>>(
        p, g, m, v, a.bc1, a.bc2, a.h, a.n, n_vec, a.partials);
  } else {
    adamw_fused_kernel<P, G, M, false><<<a.blocks, kThreads, 0, a.stream>>>(
        p, g, m, v, a.bc1, a.bc2, a.h, a.n, n_vec, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename P, typename G>
int dispatch_moments(int m_dtype, const Launch& a) {
  if (m_dtype == kBFloat16) return launch_typed<P, G, __nv_bfloat16>(a);
  return launch_typed<P, G, float>(a);
}

template <typename P>
int dispatch_grads(int g_dtype, int m_dtype, const Launch& a) {
  if (g_dtype == kBFloat16) return dispatch_moments<P, __nv_bfloat16>(m_dtype, a);
  return dispatch_moments<P, float>(m_dtype, a);
}

bool known(int code) { return code == kFloat32 || code == kBFloat16; }

}  // namespace

// dtype codes: 0 float32, 1 bfloat16.  ``blocks`` is the grid (at least 1);
// with ``partials`` not null, block b writes its sum of g * g to
// partials[b].  ``decay`` says whether weight decay applies (the plain
// path's ``if weight_decay``), ``weight_decay`` its f32 value.
extern "C" int adamw_fused_launch(void* p, const void* g, void* m, void* v,
                                  const void* bc1, const void* bc2, float b1,
                                  float one_minus_b1, float b2, float one_minus_b2,
                                  float eps, float weight_decay, int decay,
                                  float neg_lr, long long n, int blocks,
                                  int p_dtype, int g_dtype, int m_dtype,
                                  void* partials, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (blocks <= 0 || !known(p_dtype) || !known(g_dtype) || !known(m_dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Launch a{p, g, m, v,
           static_cast<const float*>(bc1), static_cast<const float*>(bc2),
           Hyper{b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay, neg_lr, decay},
           static_cast<int64_t>(n), static_cast<unsigned>(blocks),
           static_cast<float*>(partials), static_cast<cudaStream_t>(stream)};
  if (p_dtype == kBFloat16) return dispatch_grads<__nv_bfloat16>(g_dtype, m_dtype, a);
  return dispatch_grads<float>(g_dtype, m_dtype, a);
}

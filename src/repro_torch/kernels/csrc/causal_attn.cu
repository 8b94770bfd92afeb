// Causal attention for Hopper (sm_90a): one fused forward and a backward
// without atomics, for kernels/causal_attn.py.
//
// Replaces no TPU kernel: the reference leaves attention to XLA, and its
// Pallas kernels are all in the sync path.  The plain path
// (models/attention.py ``_attend_plain``) builds every 256-query chunk's
// scores over every key, an f32 softmax and the mask afterwards, so it
// moves the whole score tensor through device memory several times and
// computes twice the causal products.  At the training shapes the work is
// bound by the tensor cores (2·(S²/2)·(hq + hv) FLOPs a head in the
// forward, twice that in the backward); these kernels keep the scores on
// chip and skip the blocks past the diagonal.  With q (B,S,K,G,hq),
// k (B,S,K,hq), v (B,S,K,hv), read through their strides (MLA's
// ``kv[..., nope:]`` is a view), o and dq in q's layout, dk and dv in k's
// and v's, and the row log-sum-exp ``lse`` and ``D`` as (B,K,G,S) f32:
//
//   causal_attn_fwd       one block per 128 query rows of a (batch, head),
//                         the last rows first; it walks the key blocks from
//                         the window's start up to the diagonal, with an
//                         online softmax in f32 (running max and sum, exp2
//                         with scale·log2 e folded in).  P is rounded to the
//                         inputs' type for P·V, O summed in f32, divided
//                         once; lse = max + log2(sum) in base 2.
//   causal_attn_bwd_prep  D = rowsum(dO ∘ O) in f32, a warp a row.
//   causal_attn_bwd_dkdv  one block per 64 keys of a (batch, key head): over
//                         the G query heads of the key head and the query
//                         blocks from the diagonal to the end (or the
//                         window's end) it rebuilds P = exp2(logit - lse),
//                         dS = P ∘ (dO·Vᵀ − D), and sums dV += Pᵀ·dO and
//                         dK += dSᵀ·Q in registers.
//   causal_attn_bwd_dq    one block per 64 query rows, over the key blocks:
//                         dQ += dS·K.
//
// Every sum runs in a fixed order in one block, so results repeat bit for
// bit.  Only the blocks that cross the diagonal, the sequence's end or a
// window's edge test each score against the mask.  With a softcap, the
// logit is cap·tanh(s·scale/cap) and dS takes the factor 1 − tanh².
//
// bf16 and fp16 inputs multiply on the tensor cores (mma.sync m16n8k16,
// operands from shared memory through ldmatrix, f32 sums), their tiles
// staged by cp.async, double-buffered, with the next key (or query) block
// in flight while the current one is used.  The head widths are template
// parameters, padded up to an instance of CAUSAL_ATTN_WIDTHS with zero columns
// (192 stays 192: twelve 16-wide steps, not 256).  Warps: the forward
// gives each of its 8 warps 16 query rows over the whole key block, so P
// passes from the score product to P·V in registers; the backward kernels
// tile their 64 x 64 score blocks 4 x 2 over the warps, stage P and dS in
// shared memory in the inputs' type, and tile the accumulated 64 x width
// products 4 x 2 again, half the width a warp.
//
// float32 inputs take SIMT kernels (one thread a row, keys or queries
// staged in shared memory, full-f32 FMAs, no TF32), for the small
// configurations' checks against the CPU.
//
// The launchers allocate nothing, launch on the caller's stream, do not
// synchronise, and return the first CUDA error (cudaErrorInvalidValue for a
// dtype or width pair without an instance).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

enum DtypeCode { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2 };

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 256;   // the backward's tensor-core kernels: 8 warps

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* out;
  float* lse;
  float* dl;
  void* dq;
  void* dk;
  void* dv;
  // strides in elements: (batch, position, head[, group]) of each operand
  long long sq[4], sk[3], sv[3], so[4], sd[4], sdq[4], sdk[3], sdv[3];
  int B, S, NK, G, hq, hv, window, vec;
  float scale;       // hq ** -0.5
  float scale_log2;  // scale * log2(e)
  float cap;         // the softcap, 0 for none
  float cap_log2;    // cap * log2(e)
  float inv_cap;     // scale / cap
};

// ---------------------------------------------------------------------------
// element types
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }

// two floats as the low and high halves of a 32-bit operand register
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c (16x8, f32) += a (16x16) · b (16x8)
template <typename T>
__device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b);
template <>
__device__ __forceinline__ void mma<__nv_bfloat16>(float* c, const uint32_t* a,
                                                   const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
template <>
__device__ __forceinline__ void mma<__half>(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm4_t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// 16 bytes global -> shared, or 16 zero bytes when !ok
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// shared pieces
// ---------------------------------------------------------------------------

// 2^x on the special-function unit (ex2.approx: 2 ulp; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// query row i sees key j
__device__ __forceinline__ bool visible(int i, int j, const Args& a) {
  return j <= i && i < a.S && (a.window == 0 || i - j < a.window);
}

// raw score -> the softmax's logit in base 2; t gets the softcap's tanh
__device__ __forceinline__ float logit2(float s, const Args& a, float& t) {
  if (a.cap > 0.f) {
    t = tanhf(s * a.inv_cap);
    return t * a.cap_log2;
  }
  t = 0.f;
  return s * a.scale_log2;
}

// Rows row0 .. row0+ROWS of a (S, width) operand (row stride rs) into
// shared memory [ROWS][LD]: rows past S and columns width .. D as zeros.
// With vec, 16-byte cp.async copies (the caller commits and waits); else
// plain loads and stores.
template <typename T, int ROWS, int D, int LD, int NT = kThreads>
__device__ __forceinline__ void load_tile(T* dst, const T* base, long long rs, int row0,
                                          int S, int width, int vec) {
  if (vec) {
    constexpr int CH = D / 8;
    for (int c = threadIdx.x; c < ROWS * CH; c += NT) {
      const int r = c / CH, col = (c % CH) * 8;
      const bool ok = row0 + r < S && col < width;
      const T* src = ok ? base + static_cast<long long>(row0 + r) * rs + col : base;
      cp16(dst + r * LD + col, src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * D; e += NT) {
      const int r = e / D, col = e % D;
      T x = from_f<T>(0.f);
      if (row0 + r < S && col < width) x = base[static_cast<long long>(row0 + r) * rs + col];
      dst[r * LD + col] = x;
    }
  }
}

// acc (16 x 8·NT) += A (16 x D) · Bᵀ, A's rows from a (row-major, stride
// lda), B's 8·NT rows from b (row-major [n][D], stride ldb)
template <typename T, int D, int NT>
__device__ __forceinline__ void product_nt(float (*acc)[4], const T* a, int lda, const T* b,
                                           int ldb, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldsm4(af, a + (lane & 15) * lda + kk * 16 + 8 * (lane >> 4));
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t bf[4];
      ldsm4(bf, b + (j * 16 + (lane & 7) + 8 * (lane >> 4)) * ldb + kk * 16 +
                    8 * ((lane >> 3) & 1));
      mma<T>(acc[2 * j], af, bf);
      mma<T>(acc[2 * j + 1], af, bf + 2);
    }
  }
}

// acc (16 x 8·NT) += A (16 x KD) · B, A from a (row-major, stride lda), B
// from b (row-major [KD][8·NT], stride ldb)
template <typename T, int KD, int NT>
__device__ __forceinline__ void product_nn(float (*acc)[4], const T* a, int lda, const T* b,
                                           int ldb, int lane) {
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk) {
    uint32_t af[4];
    ldsm4(af, a + (lane & 15) * lda + kk * 16 + 8 * (lane >> 4));
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t bf[4];
      ldsm4_t(bf, b + (kk * 16 + (lane & 15)) * ldb + j * 16 + 8 * (lane >> 4));
      mma<T>(acc[2 * j], af, bf);
      mma<T>(acc[2 * j + 1], af, bf + 2);
    }
  }
}

template <int NT>
__device__ __forceinline__ void clear(float (*acc)[4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// a warp's 16 x 8·NT accumulator, times mul, into rows row0 (+8) and
// columns col0 ... of out (row stride rs), inside S rows and width columns
template <typename T, int NT>
__device__ __forceinline__ void store_acc(T* out, long long rs, const float (*acc)[4],
                                          float mul, int row0, int col0, int S, int width,
                                          int lane) {
  const int g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g8 + 8 * half;
    if (row >= S) continue;
    T* dst = out + static_cast<long long>(row) * rs;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = col0 + j * 8 + 2 * t4;
      if (col < width) dst[col] = from_f<T>(acc[j][2 * half] * mul);
      if (col + 1 < width) dst[col + 1] = from_f<T>(acc[j][2 * half + 1] * mul);
    }
  }
}

// a warp's 16 x 8·NT accumulator into shared memory [16][ld] in T
template <typename T, int NT>
__device__ __forceinline__ void stage_acc(T* dst, int ld, const float (*acc)[4], int lane) {
  const int g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    *reinterpret_cast<uint32_t*>(dst + g8 * ld + j * 8 + 2 * t4) =
        pack2<T>(acc[j][0], acc[j][1]);
    *reinterpret_cast<uint32_t*>(dst + (g8 + 8) * ld + j * 8 + 2 * t4) =
        pack2<T>(acc[j][2], acc[j][3]);
  }
}

// ---------------------------------------------------------------------------
// tensor-core kernels (bf16, fp16)
// ---------------------------------------------------------------------------

// The tilings by (q/k, v) width: the forward's warps (16 query rows
// each) and keys a block, and for each kernel the blocks an SM that
// __launch_bounds__ asks the compiler to fit (so its register cap).  From
// a sweep of 11 forward and 2 backward tilings on an H100 (700 W) at the
// bench cells' shapes, bf16 (PERF.md gives the times): two blocks of 8
// warps an SM wherever the registers allow, 32-key blocks at 192/128.
template <int DQ, int DV>
struct FwdCfg {
  static constexpr int kWarps = 8, kKeys = 64, kMinBlocks = 2;
};
template <>
struct FwdCfg<192, 128> {
  static constexpr int kWarps = 8, kKeys = 32, kMinBlocks = 2;
};
template <>
struct FwdCfg<256, 256> {
  static constexpr int kWarps = 8, kKeys = 64, kMinBlocks = 1;
};
template <int DQ, int DV>
struct BwdCfg {
  static constexpr int kMinBlocks = DQ + DV <= 256 ? 2 : 1;
};

template <typename T, int DQ, int DV, int W, int FN>
constexpr int fwd_smem() {
  return (16 * W * (DQ + 8) + 2 * FN * (DQ + 8) + 2 * FN * (DV + 8)) * sizeof(T);
}

// the backward's 64 x 64 score blocks
template <typename T, int DQ, int DV>
struct Tile {
  static constexpr int LQ = DQ + 8, LV = DV + 8;   // shared row strides: no bank conflicts
  static constexpr int BM = 64, BN = 64, LP = 64 + 8;
  static constexpr int kDkdvSmem =
      (BN * LQ + BN * LV + 2 * BM * LQ + 2 * BM * LV + 2 * BN * LP) * sizeof(T) +
      4 * BM * sizeof(float);
  static constexpr int kDqSmem =
      (BM * LQ + BM * LV + 2 * BN * LQ + 2 * BN * LV + BM * LP) * sizeof(T);
};

template <typename T, int DQ, int DV, int W, int FN, int MB>
__global__ void __launch_bounds__(32 * W, MB) causal_attn_fwd(Args a) {
  constexpr int BM = 16 * W, BN = FN, NT = 32 * W, LQ = DQ + 8, LV = DV + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = sq + BM * LQ;
  T* sv = sk + 2 * BN * LQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const int h = blockIdx.x;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BM;   // the heaviest rows first
  const int b = h / (a.NK * a.G), kh = (h / a.G) % a.NK, g = h % a.G;
  const T* q = static_cast<const T*>(a.q) + b * a.sq[0] + kh * a.sq[2] + g * a.sq[3];
  const T* k = static_cast<const T*>(a.k) + b * a.sk[0] + kh * a.sk[2];
  const T* v = static_cast<const T*>(a.v) + b * a.sv[0] + kh * a.sv[2];
  const int lo = a.window > 0 ? max(m0 - a.window + 1, 0) / BN * BN : 0;
  const int hi = min(m0 + BM, a.S);
  const int blocks = (hi - lo + BN - 1) / BN;
  load_tile<T, BM, DQ, LQ, NT>(sq, q, a.sq[1], m0, a.S, a.hq, a.vec);
  load_tile<T, BN, DQ, LQ, NT>(sk, k, a.sk[1], lo, a.S, a.hq, a.vec);
  load_tile<T, BN, DV, LV, NT>(sv, v, a.sv[1], lo, a.S, a.hv, a.vec);
  cp_commit();

  float acc[DV / 8][4];
  clear<DV / 8>(acc);
  float mrow[2] = {-1e30f, -1e30f};   // finite: a row that met only masked keys scales by 1
  float lrow[2] = {0.f, 0.f};         // this thread's share of each row's sum
  const int row0 = m0 + warp * 16 + (lane >> 2);   // this thread's rows: row0, row0 + 8

  for (int it = 0; it < blocks; ++it) {
    const int n0 = lo + it * BN, cur = it & 1;
    if (it + 1 < blocks) {
      load_tile<T, BN, DQ, LQ, NT>(sk + (cur ^ 1) * BN * LQ, k, a.sk[1], n0 + BN, a.S, a.hq,
                                   a.vec);
      load_tile<T, BN, DV, LV, NT>(sv + (cur ^ 1) * BN * LV, v, a.sv[1], n0 + BN, a.S, a.hv,
                                   a.vec);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* kt = sk + cur * BN * LQ;
    const T* vt = sv + cur * BN * LV;
    float s[BN / 8][4];
    clear<BN / 8>(s);
    product_nt<T, DQ, BN / 8>(s, sq + warp * 16 * LQ, LQ, kt, LQ, lane);
    const bool whole = n0 + BN - 1 <= m0 && n0 + BN <= a.S &&
                       (a.window == 0 || m0 + BM - 1 - n0 < a.window);
    float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float t;
        float x = logit2(s[j][e], a, t);
        if (!whole && !visible(row0 + 8 * (e >> 1), n0 + j * 8 + 2 * t4 + (e & 1), a)) {
          x = -INFINITY;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = ex2(mrow[r] - mx[r]);
      mrow[r] = mx[r];
      lrow[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(s[j][e] - mx[e >> 1]);
        lrow[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int d = 0; d < DV / 8; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }
    // O += P · V, P straight from the score registers
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t pf[4] = {pack2<T>(s[2 * kk][0], s[2 * kk][1]),
                              pack2<T>(s[2 * kk][2], s[2 * kk][3]),
                              pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int d = 0; d < DV / 16; ++d) {
        uint32_t bf[4];
        ldsm4_t(bf, vt + (kk * 16 + (lane & 15)) * LV + d * 16 + 8 * (lane >> 4));
        mma<T>(acc[2 * d], pf, bf);
        mma<T>(acc[2 * d + 1], pf, bf + 2);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 1);
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 2);
  }
  T* o = static_cast<T*>(a.out) + b * a.so[0] + kh * a.so[2] + g * a.so[3];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = 1.f / lrow[r];
#pragma unroll
    for (int d = 0; d < DV / 8; ++d) {
      acc[d][2 * r] *= inv;
      acc[d][2 * r + 1] *= inv;
    }
    const int row = row0 + 8 * r;
    if (t4 == 0 && row < a.S) {
      a.lse[static_cast<long long>(h) * a.S + row] = mrow[r] + log2f(lrow[r]);
    }
  }
  store_acc<T, DV / 8>(o, a.so[1], acc, 1.f, m0 + warp * 16, 0, a.S, a.hv, lane);
}

template <typename T, int DQ, int DV, int MB>
__global__ void __launch_bounds__(kThreads, MB) causal_attn_bwd_dkdv(Args a) {
  using C = Tile<T, DQ, DV>;
  constexpr int BM = C::BM, BN = C::BN, LQ = C::LQ, LV = C::LV, LP = C::LP;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sk = reinterpret_cast<T*>(smem);
  T* sv = sk + BN * LQ;
  T* sq = sv + BN * LV;          // [2][BM][LQ]
  T* sdo = sq + 2 * BM * LQ;     // [2][BM][LV]
  T* sp = sdo + 2 * BM * LV;     // Pᵀ [BN][LP]
  T* sds = sp + BN * LP;         // dSᵀ [BN][LP]
  float* sl = reinterpret_cast<float*>(sds + BN * LP);   // lse [2][BM]
  float* sd = sl + 2 * BM;                              // D [2][BM]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const int wr = warp >> 1, wc = warp & 1;   // 16 keys; 32 queries / half the width
  const int bk = blockIdx.x, n0 = blockIdx.y * BN;   // the first keys, the most queries, first
  const int b = bk / a.NK, kh = bk % a.NK;
  const T* k = static_cast<const T*>(a.k) + b * a.sk[0] + kh * a.sk[2];
  const T* v = static_cast<const T*>(a.v) + b * a.sv[0] + kh * a.sv[2];
  const int hi = a.window > 0 ? min(a.S, n0 + BN - 1 + a.window) : a.S;
  const int nmb = (hi - n0 + BM - 1) / BM;   // query blocks from the diagonal (BM == BN)
  const int total = a.G * nmb;

  auto fetch = [&](int it, int buf) {
    const int g = it / nmb, m0 = n0 + (it % nmb) * BM;
    const T* q = static_cast<const T*>(a.q) + b * a.sq[0] + kh * a.sq[2] + g * a.sq[3];
    const T* dout =
        static_cast<const T*>(a.dout) + b * a.sd[0] + kh * a.sd[2] + g * a.sd[3];
    load_tile<T, BM, DQ, LQ>(sq + buf * BM * LQ, q, a.sq[1], m0, a.S, a.hq, a.vec);
    load_tile<T, BM, DV, LV>(sdo + buf * BM * LV, dout, a.sd[1], m0, a.S, a.hv, a.vec);
    if (threadIdx.x < BM) {
      const int row = m0 + threadIdx.x;
      const long long at = (static_cast<long long>(bk) * a.G + g) * a.S + row;
      sl[buf * BM + threadIdx.x] = row < a.S ? a.lse[at] : 0.f;
      sd[buf * BM + threadIdx.x] = row < a.S ? a.dl[at] : 0.f;
    }
  };

  load_tile<T, BN, DQ, LQ>(sk, k, a.sk[1], n0, a.S, a.hq, a.vec);
  load_tile<T, BN, DV, LV>(sv, v, a.sv[1], n0, a.S, a.hv, a.vec);
  fetch(0, 0);
  cp_commit();

  float dk[DQ / 16][4], dv[DV / 16][4];
  clear<DQ / 16>(dk);
  clear<DV / 16>(dv);
  const int key0 = n0 + wr * 16 + (lane >> 2);   // this thread's keys: key0, key0 + 8

  for (int it = 0; it < total; ++it) {
    const int cur = it & 1;
    if (it + 1 < total) {
      fetch(it + 1, cur ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int m0 = n0 + (it % nmb) * BM;
    const T* qt = sq + cur * BM * LQ;
    const T* dot = sdo + cur * BM * LV;
    const float* lt = sl + cur * BM;
    const float* dt = sd + cur * BM;
    float st[4][4], dpt[4][4];   // Sᵀ and dPᵀ: 16 keys x 32 queries a warp
    clear<4>(st);
    clear<4>(dpt);
    product_nt<T, DQ, 4>(st, sk + wr * 16 * LQ, LQ, qt + wc * 32 * LQ, LQ, lane);
    product_nt<T, DV, 4>(dpt, sv + wr * 16 * LV, LV, dot + wc * 32 * LV, LV, lane);
    const bool whole = m0 >= n0 + BN - 1 && m0 + BM <= a.S && n0 + BN <= a.S &&
                       (a.window == 0 || m0 + BM - 1 - n0 < a.window);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lq = wc * 32 + j * 8 + 2 * t4 + (e & 1);
        float t;
        const float x = logit2(st[j][e], a, t);
        float p = ex2(x - lt[lq]);
        if (!whole && !visible(m0 + lq, key0 + 8 * (e >> 1), a)) p = 0.f;
        float ds = p * (dpt[j][e] - dt[lq]);
        if (a.cap > 0.f) ds *= 1.f - t * t;
        st[j][e] = p;
        dpt[j][e] = ds;
      }
    }
    stage_acc<T, 4>(sp + wr * 16 * LP + wc * 32, LP, st, lane);
    stage_acc<T, 4>(sds + wr * 16 * LP + wc * 32, LP, dpt, lane);
    __syncthreads();
    product_nn<T, BM, DV / 16>(dv, sp + wr * 16 * LP, LP, dot + wc * (DV / 2), LV, lane);
    product_nn<T, BM, DQ / 16>(dk, sds + wr * 16 * LP, LP, qt + wc * (DQ / 2), LQ, lane);
    __syncthreads();
  }

  T* dko = static_cast<T*>(a.dk) + b * a.sdk[0] + kh * a.sdk[2];
  T* dvo = static_cast<T*>(a.dv) + b * a.sdv[0] + kh * a.sdv[2];
  store_acc<T, DQ / 16>(dko, a.sdk[1], dk, a.scale, n0 + wr * 16, wc * (DQ / 2), a.S, a.hq,
                        lane);
  store_acc<T, DV / 16>(dvo, a.sdv[1], dv, 1.f, n0 + wr * 16, wc * (DV / 2), a.S, a.hv,
                        lane);
}

template <typename T, int DQ, int DV, int MB>
__global__ void __launch_bounds__(kThreads, MB) causal_attn_bwd_dq(Args a) {
  using C = Tile<T, DQ, DV>;
  constexpr int BM = C::BM, BN = C::BN, LQ = C::LQ, LV = C::LV, LP = C::LP;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* sdo = sq + BM * LQ;
  T* sk = sdo + BM * LV;        // [2][BN][LQ]
  T* sv = sk + 2 * BN * LQ;     // [2][BN][LV]
  T* sds = sv + 2 * BN * LV;    // dS [BM][LP]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const int wr = warp >> 1, wc = warp & 1;   // 16 queries; 32 keys / half the width
  const int h = blockIdx.x;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BM;   // the heaviest rows first
  const int b = h / (a.NK * a.G), kh = (h / a.G) % a.NK, g = h % a.G;
  const T* q = static_cast<const T*>(a.q) + b * a.sq[0] + kh * a.sq[2] + g * a.sq[3];
  const T* dout = static_cast<const T*>(a.dout) + b * a.sd[0] + kh * a.sd[2] + g * a.sd[3];
  const T* k = static_cast<const T*>(a.k) + b * a.sk[0] + kh * a.sk[2];
  const T* v = static_cast<const T*>(a.v) + b * a.sv[0] + kh * a.sv[2];
  const int lo = a.window > 0 ? max(m0 - a.window + 1, 0) / BN * BN : 0;
  const int hi = min(m0 + BM, a.S);
  const int blocks = (hi - lo + BN - 1) / BN;
  load_tile<T, BM, DQ, LQ>(sq, q, a.sq[1], m0, a.S, a.hq, a.vec);
  load_tile<T, BM, DV, LV>(sdo, dout, a.sd[1], m0, a.S, a.hv, a.vec);
  load_tile<T, BN, DQ, LQ>(sk, k, a.sk[1], lo, a.S, a.hq, a.vec);
  load_tile<T, BN, DV, LV>(sv, v, a.sv[1], lo, a.S, a.hv, a.vec);
  cp_commit();

  const int row0 = m0 + wr * 16 + (lane >> 2);   // this thread's rows: row0, row0 + 8
  float lse[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const long long at = static_cast<long long>(h) * a.S + row;
    lse[r] = row < a.S ? a.lse[at] : 0.f;
    dd[r] = row < a.S ? a.dl[at] : 0.f;
  }
  float dq[DQ / 16][4];
  clear<DQ / 16>(dq);

  for (int it = 0; it < blocks; ++it) {
    const int n0 = lo + it * BN, cur = it & 1;
    if (it + 1 < blocks) {
      load_tile<T, BN, DQ, LQ>(sk + (cur ^ 1) * BN * LQ, k, a.sk[1], n0 + BN, a.S, a.hq,
                               a.vec);
      load_tile<T, BN, DV, LV>(sv + (cur ^ 1) * BN * LV, v, a.sv[1], n0 + BN, a.S, a.hv,
                               a.vec);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* kt = sk + cur * BN * LQ;
    const T* vt = sv + cur * BN * LV;
    float s[4][4], dp[4][4];   // S and dP: 16 queries x 32 keys a warp
    clear<4>(s);
    clear<4>(dp);
    product_nt<T, DQ, 4>(s, sq + wr * 16 * LQ, LQ, kt + wc * 32 * LQ, LQ, lane);
    product_nt<T, DV, 4>(dp, sdo + wr * 16 * LV, LV, vt + wc * 32 * LV, LV, lane);
    const bool whole = n0 + BN - 1 <= m0 && n0 + BN <= a.S &&
                       (a.window == 0 || m0 + BM - 1 - n0 < a.window);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float t;
        const float x = logit2(s[j][e], a, t);
        float p = ex2(x - lse[r]);
        if (!whole && !visible(row0 + 8 * r, n0 + wc * 32 + j * 8 + 2 * t4 + (e & 1), a)) {
          p = 0.f;
        }
        float ds = p * (dp[j][e] - dd[r]);
        if (a.cap > 0.f) ds *= 1.f - t * t;
        s[j][e] = ds;
      }
    }
    stage_acc<T, 4>(sds + wr * 16 * LP + wc * 32, LP, s, lane);
    __syncthreads();
    product_nn<T, BN, DQ / 16>(dq, sds + wr * 16 * LP, LP, kt + wc * (DQ / 2), LQ, lane);
    __syncthreads();
  }

  T* dqo = static_cast<T*>(a.dq) + b * a.sdq[0] + kh * a.sdq[2] + g * a.sdq[3];
  store_acc<T, DQ / 16>(dqo, a.sdq[1], dq, a.scale, m0 + wr * 16, wc * (DQ / 2), a.S, a.hq,
                        lane);
}

// D = rowsum(dO ∘ O) in f32, a warp a row, rows in the lse's (b, k, g, s) order
template <typename T>
__global__ void __launch_bounds__(kThreads) causal_attn_bwd_prep(Args a) {
  const long long r = static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= static_cast<long long>(a.B) * a.NK * a.G * a.S) return;
  const int s = static_cast<int>(r % a.S);
  const long long h = r / a.S;
  const long long b = h / (a.NK * a.G), kh = (h / a.G) % a.NK, g = h % a.G;
  const T* o = static_cast<const T*>(a.o) + b * a.so[0] + s * a.so[1] + kh * a.so[2] +
               g * a.so[3];
  const T* d = static_cast<const T*>(a.dout) + b * a.sd[0] + s * a.sd[1] + kh * a.sd[2] +
               g * a.sd[3];
  float acc = 0.f;
  for (int c = lane; c < a.hv; c += 32) acc = fmaf(to_f(o[c]), to_f(d[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) a.dl[r] = acc;
}

// ---------------------------------------------------------------------------
// float32: SIMT kernels, a thread a row
// ---------------------------------------------------------------------------

constexpr int kSimtRows = 64;   // a block's rows (its threads)
constexpr int kSimtTile = 32;   // the rows it stages in shared memory at a time
constexpr int kMaxHead = 256;

// rows row0 .. row0+kSimtTile of a (S, width) f32 operand into dst [kSimtTile][width]
__device__ __forceinline__ void stage_rows(float* dst, const float* base, long long rs,
                                           int row0, int S, int width) {
  for (int e = threadIdx.x; e < kSimtTile * width; e += kSimtRows) {
    const int r = e / width, c = e % width;
    dst[e] = row0 + r < S ? base[static_cast<long long>(row0 + r) * rs + c] : 0.f;
  }
}

__global__ void __launch_bounds__(kSimtRows) causal_attn_fwd_simt(Args a) {
  extern __shared__ float fsm[];
  float* sk = fsm;
  float* sv = fsm + kSimtTile * a.hq;
  const int h = blockIdx.x;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * kSimtRows;
  const int i = m0 + threadIdx.x;
  const int b = h / (a.NK * a.G), kh = (h / a.G) % a.NK, g = h % a.G;
  const float* q = static_cast<const float*>(a.q) + b * a.sq[0] + kh * a.sq[2] + g * a.sq[3];
  const float* k = static_cast<const float*>(a.k) + b * a.sk[0] + kh * a.sk[2];
  const float* v = static_cast<const float*>(a.v) + b * a.sv[0] + kh * a.sv[2];
  float qr[kMaxHead], acc[kMaxHead];
  for (int c = 0; c < a.hq; ++c) qr[c] = i < a.S ? q[static_cast<long long>(i) * a.sq[1] + c] : 0.f;
  for (int c = 0; c < a.hv; ++c) acc[c] = 0.f;
  float m = -1e30f, l = 0.f;
  const int lo = a.window > 0 ? max(m0 - a.window + 1, 0) : 0;
  const int hi = min(m0 + kSimtRows, a.S);
  for (int n0 = lo; n0 < hi; n0 += kSimtTile) {
    __syncthreads();
    stage_rows(sk, k, a.sk[1], n0, a.S, a.hq);
    stage_rows(sv, v, a.sv[1], n0, a.S, a.hv);
    __syncthreads();
    if (i >= a.S) continue;
    for (int jj = 0; jj < kSimtTile; ++jj) {
      if (!visible(i, n0 + jj, a)) continue;
      float s = 0.f;
      for (int c = 0; c < a.hq; ++c) s = fmaf(qr[c], sk[jj * a.hq + c], s);
      float t;
      const float x = logit2(s, a, t);
      const float mn = fmaxf(m, x);
      const float alpha = exp2f(m - mn), p = exp2f(x - mn);
      l = l * alpha + p;
      for (int c = 0; c < a.hv; ++c) acc[c] = fmaf(p, sv[jj * a.hv + c], acc[c] * alpha);
      m = mn;
    }
  }
  if (i >= a.S) return;
  float* o = static_cast<float*>(a.out) + b * a.so[0] + kh * a.so[2] + g * a.so[3] +
             static_cast<long long>(i) * a.so[1];
  for (int c = 0; c < a.hv; ++c) o[c] = acc[c] / l;
  a.lse[static_cast<long long>(h) * a.S + i] = m + log2f(l);
}

__global__ void __launch_bounds__(kSimtRows) causal_attn_bwd_dkdv_simt(Args a) {
  extern __shared__ float fsm[];
  float* sq = fsm;
  float* sdo = sq + kSimtTile * a.hq;
  float* sl = sdo + kSimtTile * a.hv;
  float* sd = sl + kSimtTile;
  const int bk = blockIdx.x, n0 = blockIdx.y * kSimtRows;
  const int j = n0 + threadIdx.x;
  const int b = bk / a.NK, kh = bk % a.NK;
  const float* k = static_cast<const float*>(a.k) + b * a.sk[0] + kh * a.sk[2];
  const float* v = static_cast<const float*>(a.v) + b * a.sv[0] + kh * a.sv[2];
  float kr[kMaxHead], vr[kMaxHead], dk[kMaxHead], dv[kMaxHead];
  for (int c = 0; c < a.hq; ++c) {
    kr[c] = j < a.S ? k[static_cast<long long>(j) * a.sk[1] + c] : 0.f;
    dk[c] = 0.f;
  }
  for (int c = 0; c < a.hv; ++c) {
    vr[c] = j < a.S ? v[static_cast<long long>(j) * a.sv[1] + c] : 0.f;
    dv[c] = 0.f;
  }
  const int hi = a.window > 0 ? min(a.S, n0 + kSimtRows - 1 + a.window) : a.S;
  for (int g = 0; g < a.G; ++g) {
    const float* q = static_cast<const float*>(a.q) + b * a.sq[0] + kh * a.sq[2] + g * a.sq[3];
    const float* dout =
        static_cast<const float*>(a.dout) + b * a.sd[0] + kh * a.sd[2] + g * a.sd[3];
    const long long row_at = (static_cast<long long>(bk) * a.G + g) * a.S;
    for (int m0 = n0; m0 < hi; m0 += kSimtTile) {
      __syncthreads();
      stage_rows(sq, q, a.sq[1], m0, a.S, a.hq);
      stage_rows(sdo, dout, a.sd[1], m0, a.S, a.hv);
      if (threadIdx.x < kSimtTile) {
        const int row = m0 + threadIdx.x;
        sl[threadIdx.x] = row < a.S ? a.lse[row_at + row] : 0.f;
        sd[threadIdx.x] = row < a.S ? a.dl[row_at + row] : 0.f;
      }
      __syncthreads();
      if (j >= a.S) continue;
      for (int ii = 0; ii < kSimtTile; ++ii) {
        if (!visible(m0 + ii, j, a)) continue;
        float s = 0.f, dp = 0.f;
        for (int c = 0; c < a.hq; ++c) s = fmaf(sq[ii * a.hq + c], kr[c], s);
        for (int c = 0; c < a.hv; ++c) dp = fmaf(sdo[ii * a.hv + c], vr[c], dp);
        float t;
        const float p = exp2f(logit2(s, a, t) - sl[ii]);
        float ds = p * (dp - sd[ii]);
        if (a.cap > 0.f) ds *= 1.f - t * t;
        for (int c = 0; c < a.hv; ++c) dv[c] = fmaf(p, sdo[ii * a.hv + c], dv[c]);
        for (int c = 0; c < a.hq; ++c) dk[c] = fmaf(ds, sq[ii * a.hq + c], dk[c]);
      }
    }
  }
  if (j >= a.S) return;
  float* dko = static_cast<float*>(a.dk) + b * a.sdk[0] + kh * a.sdk[2] +
               static_cast<long long>(j) * a.sdk[1];
  float* dvo = static_cast<float*>(a.dv) + b * a.sdv[0] + kh * a.sdv[2] +
               static_cast<long long>(j) * a.sdv[1];
  for (int c = 0; c < a.hq; ++c) dko[c] = dk[c] * a.scale;
  for (int c = 0; c < a.hv; ++c) dvo[c] = dv[c];
}

__global__ void __launch_bounds__(kSimtRows) causal_attn_bwd_dq_simt(Args a) {
  extern __shared__ float fsm[];
  float* sk = fsm;
  float* sv = fsm + kSimtTile * a.hq;
  const int h = blockIdx.x;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * kSimtRows;
  const int i = m0 + threadIdx.x;
  const int b = h / (a.NK * a.G), kh = (h / a.G) % a.NK, g = h % a.G;
  const float* q = static_cast<const float*>(a.q) + b * a.sq[0] + kh * a.sq[2] + g * a.sq[3];
  const float* dout =
      static_cast<const float*>(a.dout) + b * a.sd[0] + kh * a.sd[2] + g * a.sd[3];
  const float* k = static_cast<const float*>(a.k) + b * a.sk[0] + kh * a.sk[2];
  const float* v = static_cast<const float*>(a.v) + b * a.sv[0] + kh * a.sv[2];
  float qr[kMaxHead], dor[kMaxHead], dq[kMaxHead];
  for (int c = 0; c < a.hq; ++c) {
    qr[c] = i < a.S ? q[static_cast<long long>(i) * a.sq[1] + c] : 0.f;
    dq[c] = 0.f;
  }
  for (int c = 0; c < a.hv; ++c) {
    dor[c] = i < a.S ? dout[static_cast<long long>(i) * a.sd[1] + c] : 0.f;
  }
  const long long at = static_cast<long long>(h) * a.S + i;
  const float lse = i < a.S ? a.lse[at] : 0.f;
  const float dd = i < a.S ? a.dl[at] : 0.f;
  const int lo = a.window > 0 ? max(m0 - a.window + 1, 0) : 0;
  const int hi = min(m0 + kSimtRows, a.S);
  for (int n0 = lo; n0 < hi; n0 += kSimtTile) {
    __syncthreads();
    stage_rows(sk, k, a.sk[1], n0, a.S, a.hq);
    stage_rows(sv, v, a.sv[1], n0, a.S, a.hv);
    __syncthreads();
    if (i >= a.S) continue;
    for (int jj = 0; jj < kSimtTile; ++jj) {
      if (!visible(i, n0 + jj, a)) continue;
      float s = 0.f, dp = 0.f;
      for (int c = 0; c < a.hq; ++c) s = fmaf(qr[c], sk[jj * a.hq + c], s);
      for (int c = 0; c < a.hv; ++c) dp = fmaf(dor[c], sv[jj * a.hv + c], dp);
      float t;
      const float p = exp2f(logit2(s, a, t) - lse);
      float ds = p * (dp - dd);
      if (a.cap > 0.f) ds *= 1.f - t * t;
      for (int c = 0; c < a.hq; ++c) dq[c] = fmaf(ds, sk[jj * a.hq + c], dq[c]);
    }
  }
  if (i >= a.S) return;
  float* dqo = static_cast<float*>(a.dq) + b * a.sdq[0] + kh * a.sdq[2] + g * a.sdq[3] +
               static_cast<long long>(i) * a.sdq[1];
  for (int c = 0; c < a.hq; ++c) dqo[c] = dq[c] * a.scale;
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

int cdiv(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

template <typename K>
int launch(K kernel, dim3 grid, int threads, int smem, const Args& a, cudaStream_t st) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DQ, int DV, int W, int FN, int MB>
int fwd_tc_at(const Args& a, cudaStream_t st) {
  return launch(causal_attn_fwd<T, DQ, DV, W, FN, MB>,
                dim3(a.B * a.NK * a.G, cdiv(a.S, 16 * W)), 32 * W,
                fwd_smem<T, DQ, DV, W, FN>(), a, st);
}

template <typename T, int DQ, int DV>
int fwd_tc(const Args& a, cudaStream_t st) {
  using F = FwdCfg<DQ, DV>;
  return fwd_tc_at<T, DQ, DV, F::kWarps, F::kKeys, F::kMinBlocks>(a, st);
}

template <typename T, int DQ, int DV, int MB>
int bwd_tc_at(const Args& a, cudaStream_t st) {
  using C = Tile<T, DQ, DV>;
  int err = launch(causal_attn_bwd_prep<T>,
                   dim3(cdiv(static_cast<long long>(a.B) * a.NK * a.G * a.S, kThreads / 32)),
                   kThreads, 0, a, st);
  if (err) return err;
  err = launch(causal_attn_bwd_dkdv<T, DQ, DV, MB>, dim3(a.B * a.NK, cdiv(a.S, C::BN)), kThreads,
               C::kDkdvSmem, a, st);
  if (err) return err;
  return launch(causal_attn_bwd_dq<T, DQ, DV, MB>, dim3(a.B * a.NK * a.G, cdiv(a.S, C::BM)),
                kThreads, C::kDqSmem, a, st);
}

template <typename T, int DQ, int DV>
int bwd_tc(const Args& a, cudaStream_t st) {
  return bwd_tc_at<T, DQ, DV, BwdCfg<DQ, DV>::kMinBlocks>(a, st);
}

// The padded (q/k, v) widths with an instance; kernels/causal_attn.py
// WIDTHS lists the same pairs.
#define CAUSAL_ATTN_WIDTHS(X) X(32, 32) X(64, 64) X(128, 128) X(192, 128) X(256, 256)

template <typename T>
int fwd_typed(const Args& a, int dqw, int dvw, cudaStream_t st) {
#define CAUSAL_ATTN_CASE(Q, V) \
  if (dqw == Q && dvw == V) return fwd_tc<T, Q, V>(a, st);
  CAUSAL_ATTN_WIDTHS(CAUSAL_ATTN_CASE)
#undef CAUSAL_ATTN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int bwd_typed(const Args& a, int dqw, int dvw, cudaStream_t st) {
#define CAUSAL_ATTN_CASE(Q, V) \
  if (dqw == Q && dvw == V) return bwd_tc<T, Q, V>(a, st);
  CAUSAL_ATTN_WIDTHS(CAUSAL_ATTN_CASE)
#undef CAUSAL_ATTN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

int simt_smem(const Args& a) { return kSimtTile * (a.hq + a.hv + 2) * sizeof(float); }

int fwd_simt(const Args& a, cudaStream_t st) {
  return launch(causal_attn_fwd_simt, dim3(a.B * a.NK * a.G, cdiv(a.S, kSimtRows)),
                kSimtRows, simt_smem(a), a, st);
}

int bwd_simt(const Args& a, cudaStream_t st) {
  int err = launch(causal_attn_bwd_prep<float>,
                   dim3(cdiv(static_cast<long long>(a.B) * a.NK * a.G * a.S, kThreads / 32)),
                   kThreads, 0, a, st);
  if (err) return err;
  err = launch(causal_attn_bwd_dkdv_simt, dim3(a.B * a.NK, cdiv(a.S, kSimtRows)), kSimtRows,
               simt_smem(a), a, st);
  if (err) return err;
  return launch(causal_attn_bwd_dq_simt, dim3(a.B * a.NK * a.G, cdiv(a.S, kSimtRows)),
                kSimtRows, simt_smem(a), a, st);
}

Args make_args(const long long* strides, int B, int S, int NK, int G, int hq, int hv,
               int window, float scale, float cap, int vec) {
  Args a{};
  long long* dst[8] = {a.sq, a.sk, a.sv, a.so, a.sd, a.sdq, a.sdk, a.sdv};
  const int dims[8] = {4, 3, 3, 4, 4, 4, 3, 3};
  for (int t = 0, at = 0; t < 8; ++t) {
    for (int d = 0; d < dims[t]; ++d) dst[t][d] = strides[at++];
  }
  a.B = B;
  a.S = S;
  a.NK = NK;
  a.G = G;
  a.hq = hq;
  a.hv = hv;
  a.window = window;
  a.vec = vec;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  a.cap = cap;
  a.cap_log2 = cap * kLog2e;
  a.inv_cap = cap > 0.f ? scale / cap : 0.f;
  return a;
}

}  // namespace

// ``strides``: 28 element strides, (batch, position, head[, group]) of q
// (4), k (3), v (3), o (4), dO (4), dq (4), dk (3), dv (3); the forward
// reads the first 14.  dtype codes: 0 float32, 1 bfloat16, 2 float16.
// ``dqw``/``dvw`` are the padded widths of a CAUSAL_ATTN_WIDTHS instance
// (ignored for float32); ``vec`` says that q, k, v (and dO) may be copied
// as 16-byte words (aligned, strides and widths multiples of 8).
extern "C" int causal_attn_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                      float* lse, const long long* strides, int B, int S,
                                      int NK, int G, int hq, int hv, int dqw, int dvw,
                                      int window, float scale, float cap, int dtype, int vec,
                                      void* stream) {
  Args a = make_args(strides, B, S, NK, G, hq, hv, window, scale, cap, vec);
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = o;
  a.lse = lse;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return fwd_typed<__nv_bfloat16>(a, dqw, dvw, st);
  if (dtype == kFloat16) return fwd_typed<__half>(a, dqw, dvw, st);
  if (dtype == kFloat32) return fwd_simt(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// three launches: prep (D into ``dl``), dK/dV, dQ
extern "C" int causal_attn_bwd_launch(const void* q, const void* k, const void* v,
                                      const void* o, const void* dout, const float* lse,
                                      float* dl, void* dq, void* dk, void* dv,
                                      const long long* strides, int B, int S, int NK, int G,
                                      int hq, int hv, int dqw, int dvw, int window,
                                      float scale, float cap, int dtype, int vec,
                                      void* stream) {
  Args a = make_args(strides, B, S, NK, G, hq, hv, window, scale, cap, vec);
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = const_cast<float*>(lse);
  a.dl = dl;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return bwd_typed<__nv_bfloat16>(a, dqw, dvw, st);
  if (dtype == kFloat16) return bwd_typed<__half>(a, dqw, dvw, st);
  if (dtype == kFloat32) return bwd_simt(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The MoE block's slot map and row moves for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference leaves the MoE dispatch to XLA
// (src/repro/models/moe.py, a one-hot cumsum, a scatter and a gather).
// Added because the port's plain path (models/moe.py) represents "where an
// assignment goes" expensively on the card:
//   * the positions are a cumsum over an (N*k, E) int64 one-hot along its
//     outer axis, which PyTorch runs as one thread per column walking every
//     row in series (E threads busy on a 132-SM card);
//   * the combine gathers out_buf[where(keep, slot, E*C - 1)], so every
//     assignment that is not kept reads one shared row, and the backward of
//     that gather is an index_put(accumulate=True) that sorts the indices
//     and folds the run of equal ones serially.
//
// Here one slot map, computed on the card, says both ways where rows go:
//   slot[a]  the slot (row of the (E*C, d) expert buffer) of assignment a
//            = t*k + j (token t, choice j), E*C when it is not kept;
//   keep[a]  whether it is kept: its expert is held here (first <= e <
//            first + E) and its position among the assignments to e, in
//            token-major order, is below the capacity C;
//   src[s]   the assignment that fills slot s, -1 for an empty slot.
// Rows then move only by gathers with unique destinations, forward and
// backward, and no kernel uses atomics: a step is bitwise repeatable.
//
// Kernels:
//   slot_count   per block of assignments, the count of each held expert's
//                assignments (warp __match_any_sync, one leader a value);
//   slot_rank    each block sums the counts of the blocks before it (its
//                base) and of all blocks (each expert's total), then ranks
//                its assignments in order: per warp the lanes below with
//                the same expert, plus an exclusive scan over the warps of
//                each expert's per-warp count; writes slot, keep, src, and
//                -1 into the empty slots (position >= the expert's total);
//   rows_from_src    out[s] = in[src[s] / k] (times w[src[s]], rounded to
//                    the dtype), 0 where src[s] < 0.  The permute's forward
//                    (in = the tokens' rows) and the unpermute's backward
//                    (in = dy, weighted); there it also gives dw[a], the
//                    f32 sum over d of the dtype-rounded dy[t] * out_buf[s],
//                    and 0 for every assignment not kept;
//   rows_from_slots  out[t] = sum over j of in[slot[t*k + j]] (times w, each
//                    product rounded to the dtype) for kept j, in f32 in
//                    the order j = 0..k-1, rounded once.  The unpermute's
//                    forward and the permute's backward.
// The arithmetic is the plain path's: a bf16 product is an f32 product
// rounded to bf16 (__fmul_rn, no FMA contraction), a sum over a token's k
// rows is f32 rounded once.  Only the order of the f32 sums can differ
// (PyTorch's reduction may pair the k terms otherwise; dw's sum over d is a
// tree here).
//
// Bound (moonlight's MoE layer: N = 16,384 tokens, k = 6, 32 of 64 experts
// held, C = 1,920, d = 2,048 bf16; a pass at 3.35 TB/s): the slot map reads
// top_e (0.8 MB) and writes slot, keep and src (1.1 MB), ~1 us; the permute
// writes the E*C rows (0.25 GB) and reads the kept ones (0.2 GB); the
// unpermute reads the kept rows and writes N rows (0.07 GB); the backwards
// move the same bytes, the unpermute's also reading out_buf's kept rows for
// dw.  Each row kernel is one block a row, 16-byte vectors when every
// pointer is 16-byte aligned and d a multiple of the vector.
//
// The launchers allocate nothing, launch on the caller's stream, do not
// synchronise, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSlotThreads = 1024;          // one assignment a thread, a chunk a pass
constexpr int kSlotWarps = kSlotThreads / 32;
constexpr int kMaxExperts = 256;            // held experts the shared counts hold
constexpr int kRowThreads = 256;            // the row kernels' largest block
constexpr int kUnroll = 8;                  // a token's rows loaded together

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// a - first when it is a held expert, else -1 (also for a past the end)
__device__ __forceinline__ int held_expert(const int64_t* __restrict__ top_e, int64_t a,
                                           int64_t end, int64_t first, int E) {
  if (a >= end) return -1;
  const int64_t v = top_e[a] - first;
  return (v >= 0 && v < E) ? static_cast<int>(v) : -1;
}

__global__ void __launch_bounds__(kSlotThreads)
slot_count_kernel(const int64_t* __restrict__ top_e, int64_t nk, int64_t first, int E,
                  int64_t per_block, int* __restrict__ counts) {
  extern __shared__ int cnt[];  // [kSlotWarps][E], each warp its own row
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int i = tid; i < kSlotWarps * E; i += blockDim.x) cnt[i] = 0;
  __syncthreads();
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t end = begin + per_block < nk ? begin + per_block : nk;
  const unsigned below = (1u << lane) - 1u;
  for (int64_t base = begin; base < end; base += blockDim.x) {
    const int e = held_expert(top_e, base + tid, end, first, E);
    const unsigned peers = __match_any_sync(0xffffffffu, e);
    if (e >= 0 && (peers & below) == 0) cnt[warp * E + e] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  for (int e = tid; e < E; e += blockDim.x) {
    int sum = 0;
    for (int w = 0; w < kSlotWarps; ++w) sum += cnt[w * E + e];
    counts[static_cast<int64_t>(blockIdx.x) * E + e] = sum;
  }
}

__global__ void __launch_bounds__(kSlotThreads)
slot_rank_kernel(const int64_t* __restrict__ top_e, int64_t nk, int64_t first, int E,
                 int C, int64_t per_block, const int* __restrict__ counts, int nblocks,
                 int64_t* __restrict__ slot, uint8_t* __restrict__ keep,
                 int* __restrict__ src) {
  extern __shared__ int sm[];
  int* wcnt = sm;                          // [kSlotWarps][E]
  int* base = wcnt + kSlotWarps * E;       // [E]: this block's next position per expert
  int* total = base + E;                   // [E]: every block's assignments per expert
  int* part = total + E;                   // [2][G][E]: partial sums of counts
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = blockDim.x / E;            // threads a column of counts is summed by
  const int64_t n_slots = static_cast<int64_t>(E) * C;

  if (tid < G * E) {
    const int e = tid % E, g = tid / E;
    int pre = 0, tot = 0;
    for (int b = g; b < nblocks; b += G) {
      const int c = counts[static_cast<int64_t>(b) * E + e];
      tot += c;
      if (b < static_cast<int>(blockIdx.x)) pre += c;
    }
    part[g * E + e] = pre;
    part[(G + g) * E + e] = tot;
  }
  __syncthreads();
  for (int e = tid; e < E; e += blockDim.x) {
    int pre = 0, tot = 0;
    for (int g = 0; g < G; ++g) {
      pre += part[g * E + e];
      tot += part[(G + g) * E + e];
    }
    base[e] = pre;
    total[e] = tot;
  }
  __syncthreads();

  // the slots no assignment fills: positions at or past the expert's total
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + tid; s < n_slots;
       s += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int e = static_cast<int>(s / C);
    if (s - static_cast<int64_t>(e) * C >= total[e]) src[s] = -1;
  }

  const int64_t begin = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t end = begin + per_block < nk ? begin + per_block : nk;
  const unsigned below = (1u << lane) - 1u;
  for (int64_t chunk = begin; chunk < end; chunk += blockDim.x) {
    const int64_t a = chunk + tid;
    const int e = held_expert(top_e, a, end, first, E);
    const unsigned peers = __match_any_sync(0xffffffffu, e);
    const int lower = __popc(peers & below);
    for (int i = lane; i < E; i += 32) wcnt[warp * E + i] = 0;
    __syncwarp();
    if (e >= 0 && lower == 0) wcnt[warp * E + e] = __popc(peers);
    __syncthreads();
    // per expert, an exclusive scan over the warps, in order, from its base
    for (int x = tid; x < E; x += blockDim.x) {
      int run = base[x];
      for (int w = 0; w < kSlotWarps; ++w) {
        const int c = wcnt[w * E + x];
        wcnt[w * E + x] = run;
        run += c;
      }
      base[x] = run;
    }
    __syncthreads();
    if (a < end) {
      int64_t s = n_slots;
      uint8_t kept = 0;
      if (e >= 0) {
        const int pos = wcnt[warp * E + e] + lower;
        if (pos < C) {
          kept = 1;
          s = static_cast<int64_t>(e) * C + pos;
          src[s] = static_cast<int>(a);
        }
      }
      slot[a] = s;
      keep[a] = kept;
    }
    __syncthreads();
  }
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load(const T* row, int i) {
  return reinterpret_cast<const Vec<T, V>*>(row)[i];
}

template <typename T, int V>
__device__ __forceinline__ void store(T* row, int i, const Vec<T, V>& x) {
  reinterpret_cast<Vec<T, V>*>(row)[i] = x;
}

// the sum of v over the block, in a fixed order (lanes by shuffles, then
// the warps in order); the result on thread 0
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warps[kRowThreads / 32];
  for (int off = 16; off > 0; off /= 2) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) warps[warp] = v;
  __syncthreads();
  float sum = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < static_cast<int>(blockDim.x / 32); ++w) sum = __fadd_rn(sum, warps[w]);
  }
  return sum;
}

// out[s] = in[src[s] / k] (* w[src[s]]), 0 for an empty slot; with DOT also
// dw[a] = sum_d dtype(in[t] * other[s]) for the slot's assignment, and the
// blocks past the slots write dw = 0 for every assignment not kept
template <typename T, int V, bool W, bool DOT>
__global__ void __launch_bounds__(kRowThreads)
rows_from_src_kernel(const T* __restrict__ in, const T* __restrict__ w,
                     const T* __restrict__ other, const int64_t* __restrict__ slot,
                     const int* __restrict__ src, T* __restrict__ out, T* __restrict__ dw,
                     int64_t n_slots, int64_t nk, int k, int d) {
  const int64_t s = blockIdx.x;
  if (DOT && s >= n_slots) {
    const int64_t a = (s - n_slots) * blockDim.x + threadIdx.x;
    if (a < nk && slot[a] >= n_slots) dw[a] = from_f<T>(0.f);
    return;
  }
  const int nv = d / V;
  T* o = out + s * d;
  const int a = src[s];
  if (a < 0) {
    Vec<T, V> zero;
#pragma unroll
    for (int e = 0; e < V; ++e) zero.v[e] = from_f<T>(0.f);
    for (int i = threadIdx.x; i < nv; i += blockDim.x) store<T, V>(o, i, zero);
    return;
  }
  const T* r = in + static_cast<int64_t>(a / k) * d;
  const T* q = DOT ? other + s * d : nullptr;
  const float wa = W ? to_f(w[a]) : 1.f;
  float acc = 0.f;
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    const Vec<T, V> x = load<T, V>(r, i);
    Vec<T, V> y;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if (W) {
        y.v[e] = from_f<T>(__fmul_rn(to_f(x.v[e]), wa));
      } else {
        y.v[e] = x.v[e];
      }
    }
    store<T, V>(o, i, y);
    if (DOT) {
      const Vec<T, V> p = load<T, V>(q, i);
#pragma unroll
      for (int e = 0; e < V; ++e)
        acc = __fadd_rn(acc, to_f(from_f<T>(__fmul_rn(to_f(x.v[e]), to_f(p.v[e])))));
    }
  }
  if (DOT) {
    const float sum = block_sum(acc);
    if (threadIdx.x == 0) dw[a] = from_f<T>(sum);
  }
}

// out[t] = dtype(sum_j in[slot[t*k + j]] (* w[t*k + j], rounded)) over kept j
template <typename T, int V, bool W>
__global__ void __launch_bounds__(kRowThreads)
rows_from_slots_kernel(const T* __restrict__ in, const T* __restrict__ w,
                       const int64_t* __restrict__ slot, T* __restrict__ out,
                       int64_t n_slots, int k, int d) {
  const int64_t t = blockIdx.x;
  const int nv = d / V;
  const int64_t* sl = slot + t * k;
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.f;
    for (int j0 = 0; j0 < k; j0 += kUnroll) {
      Vec<T, V> x[kUnroll];
      bool kept[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t s = j0 + u < k ? sl[j0 + u] : n_slots;
        kept[u] = s < n_slots;
        if (kept[u]) x[u] = load<T, V>(in + s * d, i);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!kept[u]) continue;
        const float wj = W ? to_f(w[t * k + j0 + u]) : 1.f;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float v = W ? to_f(from_f<T>(__fmul_rn(to_f(x[u].v[e]), wj))) : to_f(x[u].v[e]);
          acc[e] = __fadd_rn(acc[e], v);
        }
      }
    }
    Vec<T, V> y;
#pragma unroll
    for (int e = 0; e < V; ++e) y.v[e] = from_f<T>(acc[e]);
    store<T, V>(out + t * d, i, y);
  }
}

int row_threads(int nv) {
  int threads = (nv + 31) / 32 * 32;
  return threads < 32 ? 32 : (threads > kRowThreads ? kRowThreads : threads);
}

template <typename T, int V>
int launch_from_src(const void* in, const void* w, const void* other, const void* slot,
                    const void* src, void* out, void* dw, long long n_slots, long long nk,
                    int k, int d, cudaStream_t stream) {
  const int threads = row_threads(d / V);
  auto* i = static_cast<const T*>(in);
  auto* wp = static_cast<const T*>(w);
  auto* q = static_cast<const T*>(other);
  auto* sl = static_cast<const int64_t*>(slot);
  auto* sr = static_cast<const int*>(src);
  auto* o = static_cast<T*>(out);
  auto* g = static_cast<T*>(dw);
  if (dw != nullptr) {
    const long long extra = (nk + threads - 1) / threads;
    rows_from_src_kernel<T, V, true, true>
        <<<static_cast<unsigned>(n_slots + extra), threads, 0, stream>>>(
            i, wp, q, sl, sr, o, g, n_slots, nk, k, d);
  } else if (w != nullptr) {
    rows_from_src_kernel<T, V, true, false>
        <<<static_cast<unsigned>(n_slots), threads, 0, stream>>>(
            i, wp, q, sl, sr, o, g, n_slots, nk, k, d);
  } else {
    rows_from_src_kernel<T, V, false, false>
        <<<static_cast<unsigned>(n_slots), threads, 0, stream>>>(
            i, wp, q, sl, sr, o, g, n_slots, nk, k, d);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_from_slots(const void* in, const void* w, const void* slot, void* out,
                      long long n_tokens, long long n_slots, int k, int d,
                      cudaStream_t stream) {
  const int threads = row_threads(d / V);
  auto* i = static_cast<const T*>(in);
  auto* wp = static_cast<const T*>(w);
  auto* sl = static_cast<const int64_t*>(slot);
  auto* o = static_cast<T*>(out);
  if (w != nullptr) {
    rows_from_slots_kernel<T, V, true>
        <<<static_cast<unsigned>(n_tokens), threads, 0, stream>>>(i, wp, sl, o, n_slots, k, d);
  } else {
    rows_from_slots_kernel<T, V, false>
        <<<static_cast<unsigned>(n_tokens), threads, 0, stream>>>(i, wp, sl, o, n_slots, k, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// dtype codes: 0 float32, 1 bfloat16; vec: 16-byte vectors
template <template <typename, int> class F, typename... A>
int by_dtype(int dtype, int vec, A... args) {
  switch (dtype) {
    case 0: return vec ? F<float, 4>::run(args...) : F<float, 1>::run(args...);
    case 1: return vec ? F<__nv_bfloat16, 8>::run(args...) : F<__nv_bfloat16, 1>::run(args...);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int V>
struct FromSrc {
  template <typename... A>
  static int run(A... args) { return launch_from_src<T, V>(args...); }
};

template <typename T, int V>
struct FromSlots {
  template <typename... A>
  static int run(A... args) { return launch_from_slots<T, V>(args...); }
};

}  // namespace

// slot, keep, src of nk = N*k assignments top_e (int64) to the E experts
// from `first` on at capacity C; `counts` holds nblocks * E ints of scratch,
// each block takes per_block assignments (a multiple of kSlotThreads)
extern "C" int moe_slots_launch(const void* top_e, long long nk, long long first, int E,
                                int C, int nblocks, long long per_block, void* counts,
                                void* slot, void* keep, void* src, void* stream) {
  if (E < 1 || E > kMaxExperts || C < 1 || nblocks < 1 || per_block % kSlotThreads != 0 ||
      per_block * nblocks < nk)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* te = static_cast<const int64_t*>(top_e);
  const size_t count_smem = sizeof(int) * kSlotWarps * E;
  slot_count_kernel<<<nblocks, kSlotThreads, count_smem, s>>>(
      te, nk, first, E, per_block, static_cast<int*>(counts));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = kSlotThreads / E;
  const size_t rank_smem = sizeof(int) * (kSlotWarps * E + 2 * E + 2 * G * E);
  slot_rank_kernel<<<nblocks, kSlotThreads, rank_smem, s>>>(
      te, nk, first, E, C, per_block, static_cast<const int*>(counts), nblocks,
      static_cast<int64_t*>(slot), static_cast<uint8_t*>(keep), static_cast<int*>(src));
  return static_cast<int>(cudaGetLastError());
}

// out (n_slots, d) from the rows in (., d) by src; w (nk,) weights the rows
// when given; dw (nk,) with `other` (n_slots, d) takes the weights' gradient
extern "C" int moe_rows_from_src_launch(const void* in, const void* w, const void* other,
                                        const void* slot, const void* src, void* out,
                                        void* dw, long long n_slots, long long nk, int k,
                                        int d, int dtype, int vec, void* stream) {
  if (n_slots <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  return by_dtype<FromSrc>(dtype, vec, in, w, other, slot, src, out, dw, n_slots, nk, k, d,
                           static_cast<cudaStream_t>(stream));
}

// out (n_tokens, d): each token's k rows of in (n_slots, d) by slot, summed
extern "C" int moe_rows_from_slots_launch(const void* in, const void* w, const void* slot,
                                          void* out, long long n_tokens, long long n_slots,
                                          int k, int d, int dtype, int vec, void* stream) {
  if (n_tokens <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  return by_dtype<FromSlots>(dtype, vec, in, w, slot, out, n_tokens, n_slots, k, d,
                             static_cast<cudaStream_t>(stream));
}

// Row top-k (k <= 8) for Hopper (sm_90a).
//
// Replaces flexflow_tpu/kernels/topk.py::_topk_kernel (the Pallas kernel
// behind pallas_topk: the serving sampler's top-k at vocab % 128 == 0 and
// the opt-in TopKOp). It computes, for every row of a (rows, dim) array,
// the k largest values and their indices, sorted by value descending with
// ties to the lowest index (the lax.top_k contract). As in the TPU kernel,
// the selection key clamps -inf to -FLT_MAX, so a row with fewer than k
// finite entries still returns k distinct indices, and the value returned
// is the input's own (-inf stays -inf). NaN inputs are not supported.
//
// What bounds it: bytes. Each element is read once and compared a few
// times; the TPU's k unrolled argmax sweeps over a VMEM-resident row become
// one pass here, since re-reading a 200 KB row k times from HBM would cost
// k times the bytes. At the sampler's shape (8 rows of 50304) the bytes
// take well under a microsecond, so what is left is the launch and the
// work of selecting; the design keeps the card busy and does little work
// for an element that cannot be selected:
//   * grid (row, chunk): a row is cut into chunks of whole 16-byte vectors,
//     the chunk size from the launch's shape and the SM count only
//     (chunk_elems_for: about one CTA an SM, no chunk under kMinChunk
//     elements, at most kMaxChunks a row, one chunk when the rows alone
//     fill the card), so the launch needs nothing from the data and
//     captures into a CUDA graph;
//   * an element is a candidate: one 64-bit integer that orders as the
//     selection does (the clamped key's bits, then the index reversed, and
//     two bits that give the input's own value back), a total order, so
//     the result does not depend on which thread, warp or CTA saw which
//     element, a compare is one integer compare, and nothing is read back
//     at the end;
//   * a CTA walks its chunk twice, in 16-byte loads, four in flight before
//     any compare (a chunk of one such batch is loaded once and held in
//     registers). The first walk finds each thread's best candidate; the
//     KP-th best of those (KP = k rounded up to a power of two; a bitonic
//     sort across each warp's lanes, then a rank in shared memory) is a
//     threshold at or below the chunk's KP-th best, since KP distinct
//     elements reach it, and only the KP threads whose best reaches it
//     hold elements that do. The second walk gathers the candidates at the
//     threshold or above into shared memory (about KP on real logits);
//     where ties let more than kCap through, the KP-th best of those
//     gathered is a higher threshold and the walk repeats. Each gathered
//     candidate's place is the number of gathered candidates that beat it,
//     counted by its own thread. For k = 1 the chunk's best is the best of
//     the warps', and there is no second walk;
//   * with one chunk the CTA writes the row. With more, each CTA writes its
//     KP candidates to scratch the wrapper allocates, takes a ticket from
//     the row's counter, and the CTA that takes the last ticket resets the
//     counter and ranks the chunks' lists together the same way. Every
//     compare obeys the total order, so an equal maximum in two chunks goes
//     to the lower index and a launch is bitwise repeatable whatever order
//     its CTAs ran in.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
// elements under which a row is not cut further: a CTA's threads then
// hold about one 16-byte vector each
constexpr int kMinChunk = 1024;
// chunks a row is cut into at most, and candidates a CTA gathers at most
// (the last CTA ranks kMaxChunks lists of 8 in shared memory)
constexpr int kMaxChunks = 128;
constexpr int kCap = 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // exact: x was read from a bf16
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);  // exact: x was read from a half
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// A candidate is one 64-bit integer that orders as the selection does:
// the clamped key's order-preserving bits (-inf clamped to -FLT_MAX, -0
// taken as +0, as a float compare sees them), then the index reversed (an
// equal key goes to the lower index), then two bits that give the input's
// own value back (-inf, -0). Indices are below 2^30. 0 is the empty
// place, below every element.
using Cand = unsigned long long;
constexpr int kIndexTop = (1 << 30) - 1;

__device__ __forceinline__ Cand pack(float v, int i) {
  const float key = __fadd_rn(fmaxf(v, -FLT_MAX), 0.f);
  uint32_t u = __float_as_uint(key);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  const uint32_t tag = v == -INFINITY                      ? 1u
                       : __float_as_uint(v) == 0x80000000u ? 2u
                                                           : 0u;
  return (static_cast<Cand>(u) << 32) |
         (static_cast<uint32_t>(kIndexTop - i) << 2) | tag;
}

__device__ __forceinline__ float value_of(Cand c) {
  const uint32_t tag = static_cast<uint32_t>(c) & 3u;
  if (tag == 1u) return -INFINITY;
  if (tag == 2u) return -0.f;
  const uint32_t u = static_cast<uint32_t>(c >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
}

__device__ __forceinline__ int index_of(Cand c) {
  return kIndexTop - static_cast<int>(static_cast<uint32_t>(c) >> 2);
}

// f(candidate) for every element of the kUnroll vectors in buf, the u-th
// at index base + u * stride, that lie below c1
template <typename T, int V, typename F>
__device__ __forceinline__ void visit(const Vec<T, V> (&buf)[kUnroll],
                                      int base, int c1, F f) {
  constexpr int stride = kThreads * V;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = base + u * stride;
    if (i < c1) {
#pragma unroll
      for (int e = 0; e < V; ++e) f(pack(to_f32(buf[u].v[e]), i + e));
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void load(Vec<T, V> (&buf)[kUnroll], const T* row,
                                     int base, int c1) {
  constexpr int stride = kThreads * V;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = base + u * stride;
    if (i < c1) buf[u] = *reinterpret_cast<const Vec<T, V>*>(row + i);
  }
}

// f(candidate) for every element of [c0, c1) this thread owns: a strided
// walk in vectors of V elements, kUnroll loads in flight before any use;
// a chunk of one batch is taken from `held` (loaded once, kept in
// registers) instead of memory
template <typename T, int V, typename F>
__device__ __forceinline__ void walk(const Vec<T, V> (&held)[kUnroll],
                                     bool one_batch, const T* row, int c0,
                                     int c1, F f) {
  constexpr int stride = kThreads * V;
  const int first = c0 + threadIdx.x * V;
  if (one_batch) {
    visit<T, V>(held, first, c1, f);
    return;
  }
  for (int base = first; base < c1; base += kUnroll * stride) {
    Vec<T, V> buf[kUnroll];
    load<T, V>(buf, row, base, c1);
    visit<T, V>(buf, base, c1, f);
  }
}

__device__ __forceinline__ Cand shfl_xor(Cand c, int m) {
  return __shfl_xor_sync(0xffffffffu, c, m);
}

// How many of the n candidates in s beat c (candidates are distinct)
__device__ __forceinline__ int rank_of(Cand c, const Cand* s, int n) {
  int rank = 0;
#pragma unroll 8
  for (int j = 0; j < n; ++j) rank += s[j] > c;
  return rank;
}

// grid (rows, chunks); kVec: 16-byte loads (dim a multiple of the vector,
// row 16-byte aligned). part: (rows, chunks, KP) candidates, read only
// with several chunks; tickets: one counter a row, zero between launches.
template <typename T, int K, bool kVec>
__global__ void __launch_bounds__(kThreads)
    topk_kernel(const T* __restrict__ x, T* __restrict__ vals,
                int* __restrict__ idx, Cand* __restrict__ part,
                int* __restrict__ tickets, int dim, int chunk) {
  constexpr int KP = K <= 1 ? 1 : K <= 2 ? 2 : K <= 4 ? 4 : 8;
  constexpr int V = kVec ? 16 / sizeof(T) : 1;
  const int r = blockIdx.x;
  const T* row = x + (size_t)r * dim;
  const int c0 = blockIdx.y * chunk;
  const int c1 = min(dim, c0 + chunk);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __shared__ Cand s_c[kCap];            // gathered candidates
  __shared__ Cand s_w[kWarps * KP];     // each warp's best thread maxima
  __shared__ Cand s_best[KP];           // the chunk's best, in order
  __shared__ Cand s_thr;
  __shared__ int s_n;
  __shared__ int s_last;

  // walk 1: the thread's best candidate
  const bool one_batch = c1 - c0 <= kUnroll * kThreads * V;
  Vec<T, V> held[kUnroll];
  if (one_batch) load<T, V>(held, row, c0 + threadIdx.x * V, c1);
  Cand best = 0;  // the empty place
  walk<T, V>(held, one_batch, row, c0, c1,
             [&](Cand c) { best = c > best ? c : best; });
  if constexpr (KP == 1) {
    // the chunk's best is the best of the warps'
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      const Cand o = shfl_xor(best, m);
      best = o > best ? o : best;
    }
    if (lane == 0) s_w[warp] = best;
    __syncthreads();
    if (threadIdx.x == 0) {
      Cand b = s_w[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) b = s_w[w] > b ? s_w[w] : b;
      s_best[0] = b;
    }
  } else {
    // the warp's KP best thread maxima (a bitonic sort across its lanes),
    // then the KP-th best of all the threads' maxima: KP distinct elements
    // reach it, so it is at or below the chunk's KP-th best, and only the
    // elements of the KP threads whose maxima reach it can
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
      for (int h = size / 2; h > 0; h >>= 1) {
        const Cand o = shfl_xor(best, h);
        const bool keep_max = ((lane & h) == 0) == ((lane & size) == 0);
        best = keep_max == (o > best) ? o : best;
      }
    }
    if (lane < KP) s_w[warp * KP + lane] = best;
    if (threadIdx.x == 0) {
      s_n = 0;
      s_thr = 0;  // stays so where fewer than KP threads hold elements
    }
    __syncthreads();
    if (threadIdx.x < kWarps * KP &&
        rank_of(s_w[threadIdx.x], s_w, kWarps * KP) == KP - 1)
      s_thr = s_w[threadIdx.x];
    __syncthreads();
    Cand thr = s_thr;
    int n;
    for (;;) {
      // walk 2: gather the candidates at the threshold or above
      walk<T, V>(held, one_batch, row, c0, c1, [&](Cand c) {
        if (c >= thr) {
          const int at = atomicAdd(&s_n, 1);
          if (at < kCap) s_c[at] = c;
        }
      });
      __syncthreads();
      n = s_n;
      if (n <= kCap) break;
      // too many (long runs of ties in few threads): the KP-th best of
      // those gathered is a higher threshold, strictly (they are
      // distinct), so the walks end
      for (int t = threadIdx.x; t < kCap; t += kThreads)
        if (rank_of(s_c[t], s_c, kCap) == KP - 1) s_thr = s_c[t];
      __syncthreads();
      thr = s_thr;
      if (threadIdx.x == 0) s_n = 0;
      __syncthreads();
    }
    // the one that m others beat goes to place m (a chunk of fewer than
    // KP elements fills only its first places)
    for (int t = threadIdx.x; t < n; t += kThreads) {
      const int rank = rank_of(s_c[t], s_c, n);
      if (rank < KP) s_best[rank] = s_c[t];
    }
  }
  __syncthreads();
  T* vrow = vals + (size_t)r * K;
  int* irow = idx + (size_t)r * K;
  const int chunks = gridDim.y;
  if (chunks == 1) {
    if (threadIdx.x < K) {
      vrow[threadIdx.x] = from_f32<T>(value_of(s_best[threadIdx.x]));
      irow[threadIdx.x] = index_of(s_best[threadIdx.x]);
    }
    return;
  }

  // publish the chunk's list, then take a ticket; the last of the row's
  // chunks ranks the chunks' lists together (every chunk holds at least
  // KP elements, so every candidate is real)
  Cand* prow = part + (size_t)r * chunks * KP;
  if (threadIdx.x < KP) {
    prow[blockIdx.y * KP + threadIdx.x] = s_best[threadIdx.x];
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(tickets + r, 1) == chunks - 1;
    if (last) atomicExch(tickets + r, 0);  // every ticket is taken
    s_last = last;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int all = chunks * KP;
  for (int t = threadIdx.x; t < all; t += kThreads) s_c[t] = __ldcg(prow + t);
  __syncthreads();
  for (int t = threadIdx.x; t < all; t += kThreads) {
    if (t % KP >= K) continue;  // beaten by K in its own chunk already
    const int rank = rank_of(s_c[t], s_c, all);
    if (rank < K) {
      vrow[rank] = from_f32<T>(value_of(s_c[t]));
      irow[rank] = index_of(s_c[t]);
    }
  }
}

int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess)
      return 132;
    return count;
  }();
  return n;
}

// Elements of a chunk, from the launch's shape and the SM count only:
// about one CTA an SM over the rows, at most kMaxChunks a row, chunks of
// at least kMinChunk elements (the last at least kMinChunk - kMaxChunks *
// v, so at least 8), a whole number of 16-byte vectors (v elements) so
// every chunk starts aligned; one chunk when the rows alone fill the card.
int chunk_elems_for(int rows, int dim, int v) {
  int chunks = sm_count() / rows;
  if (chunks > dim / kMinChunk) chunks = dim / kMinChunk;
  if (chunks > kMaxChunks) chunks = kMaxChunks;
  if (chunks < 1) chunks = 1;
  const int ce = (dim + chunks - 1) / chunks;
  return (ce + v - 1) / v * v;
}

int kp_of(int k) { return k <= 1 ? 1 : k <= 2 ? 2 : k <= 4 ? 4 : 8; }

template <typename T, int K>
void launch_k(const T* x, T* vals, int* idx, Cand* part, int* tickets,
              int rows, int dim, int chunk, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = dim % V == 0 && reinterpret_cast<size_t>(x) % 16 == 0;
  const dim3 grid(rows, (dim + chunk - 1) / chunk);
  if (vec) {
    topk_kernel<T, K, true><<<grid, kThreads, 0, stream>>>(
        x, vals, idx, part, tickets, dim, chunk);
  } else {
    topk_kernel<T, K, false><<<grid, kThreads, 0, stream>>>(
        x, vals, idx, part, tickets, dim, chunk);
  }
}

template <typename T>
int launch(const void* x, void* vals, void* idx, void* part, void* tickets,
           int rows, int dim, int k, int chunk, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* vt = static_cast<T*>(vals);
  int* it = static_cast<int*>(idx);
  Cand* pt = static_cast<Cand*>(part);
  int* tt = static_cast<int*>(tickets);
  switch (k) {
#define FF_TOPK_CASE(K)                                              \
  case K:                                                            \
    launch_k<T, K>(xt, vt, it, pt, tt, rows, dim, chunk, stream);    \
    break;
    FF_TOPK_CASE(1)
    FF_TOPK_CASE(2)
    FF_TOPK_CASE(3)
    FF_TOPK_CASE(4)
    FF_TOPK_CASE(5)
    FF_TOPK_CASE(6)
    FF_TOPK_CASE(7)
    FF_TOPK_CASE(8)
#undef FF_TOPK_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int rows, int dim, int k, int dtype) {
  return rows < 1 || dim < 1 || dim > kIndexTop || k < 1 || k > 8 ||
         k > dim || dtype < 0 || dtype > 2;
}

}  // namespace

// Elements of one chunk for a launch of this shape (dtype: 0 = float32,
// 1 = bfloat16, 2 = float16): the launch runs ceil(dim / chunk) chunks a
// row, and with more than one its scratch holds rows * chunks * kp 64-bit
// candidates, kp = k rounded up to a power of two
// (ff_topk_list_len). Negative for a shape the kernel does not take.
extern "C" int ff_topk_chunk_elems(int rows, int dim, int k, int dtype) {
  if (bad_shape(rows, dim, k, dtype)) return -1;
  return chunk_elems_for(rows, dim, dtype == 0 ? 4 : 8);
}

extern "C" int ff_topk_list_len(int k) { return kp_of(k); }

// x (rows, dim) contiguous; vals (rows, k) in x's dtype; idx (rows, k)
// int32; part: the scratch above (unread with one chunk); tickets: rows
// int32 counters, zero before the launch and left zero by it (launches
// that share them run on one stream). 1 <= k <= 8 and k <= dim; chunk from
// ff_topk_chunk_elems. Returns a cudaError_t code (0 on success); the
// launch is asynchronous on `stream`.
extern "C" int ff_topk(const void* x, void* vals, void* idx, void* part,
                       void* tickets, int rows, int dim, int k, int chunk,
                       int dtype, void* stream) {
  if (bad_shape(rows, dim, k, dtype) || chunk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, vals, idx, part, tickets, rows, dim, k, chunk,
                           st);
    case 1:
      return launch<__nv_bfloat16>(x, vals, idx, part, tickets, rows, dim, k,
                                   chunk, st);
    case 2:
      return launch<__half>(x, vals, idx, part, tickets, rows, dim, k, chunk,
                            st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

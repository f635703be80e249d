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
// k times the bytes. The design:
//   * one CTA per row, 512 threads. Each thread walks a strided slice of
//     the row in 16-byte vector loads (four loads in flight per thread
//     before any compare) and keeps a sorted list of its best k (key,
//     index) pairs in registers, ordered by key descending, then index
//     ascending: a total order, so the result does not depend on which
//     thread saw which element;
//   * the block then merges the lists in k rounds: a warp-shuffle argmax
//     over the threads' list heads, one across the warps through shared
//     memory, and the owner of the winner pops its head. Taking the k
//     winners of that total order is exactly what the k sweeps take (a
//     taken entry becomes -inf there, below every clamped key).
// Known under-fill: the serving sampler has one row per live slot (8 at
// most in the smoke's decode), so only that many of the 132 SMs work; a
// later PR can split a row across CTAs with a second merge pass.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// (ka, ia) comes before (kb, ib): larger key, or the same key and a lower
// index
__device__ __forceinline__ bool before(float ka, int ia, float kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

template <int K>
__device__ __forceinline__ void offer(float v, int i, float (&lk)[K],
                                      int (&li)[K]) {
  float key = v < -FLT_MAX ? -FLT_MAX : v;
  if (!before(key, i, lk[K - 1], li[K - 1])) return;
  int idx = i;
  // insertion: carry the new pair down the sorted list, swapping with
  // every entry it comes before
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (before(key, idx, lk[j], li[j])) {
      const float tk = lk[j];
      const int ti = li[j];
      lk[j] = key;
      li[j] = idx;
      key = tk;
      idx = ti;
    }
  }
}

__device__ __forceinline__ void warp_best(float& k, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ok = __shfl_xor_sync(0xffffffffu, k, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (before(ok, oi, k, i)) {
      k = ok;
      i = oi;
    }
  }
}

// kVec: 16-byte loads (dim a multiple of the vector, row 16-byte aligned)
template <typename T, int K, bool kVec>
__global__ void __launch_bounds__(kThreads)
    topk_kernel(const T* __restrict__ x, T* __restrict__ vals,
                int* __restrict__ idx, int dim) {
  constexpr int V = kVec ? 16 / sizeof(T) : 1;
  const T* row = x + (size_t)blockIdx.x * dim;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float lk[K];
  int li[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    lk[j] = -INFINITY;  // below every clamped key: an empty place
    li[j] = INT_MAX;
  }

  const int stride = kThreads * V;
  for (int base = threadIdx.x * V; base < dim; base += kUnroll * stride) {
    Vec<T, V> buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * stride;
      if (i < dim) buf[u] = *reinterpret_cast<const Vec<T, V>*>(row + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * stride;
      if (i < dim) {
#pragma unroll
        for (int e = 0; e < V; ++e) offer<K>(to_f32(buf[u].v[e]), i + e, lk,
                                             li);
      }
    }
  }

  __shared__ float s_key[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ int s_win;
  T* vrow = vals + (size_t)blockIdx.x * K;
  int* irow = idx + (size_t)blockIdx.x * K;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    float bk = lk[0];
    int bi = li[0];
    warp_best(bk, bi);
    if (lane == 0) {
      s_key[warp] = bk;
      s_idx[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bk = lane < kWarps ? s_key[lane] : -INFINITY;
      bi = lane < kWarps ? s_idx[lane] : INT_MAX;
      warp_best(bk, bi);
      if (lane == 0) {
        s_win = bi;
        vrow[r] = row[bi];  // the input's own value, not the clamped key
        irow[r] = bi;
      }
    }
    __syncthreads();
    // indices are unique across threads: exactly one thread pops its head
    if (li[0] == s_win) {
#pragma unroll
      for (int j = 0; j < K - 1; ++j) {
        lk[j] = lk[j + 1];
        li[j] = li[j + 1];
      }
      lk[K - 1] = -INFINITY;
      li[K - 1] = INT_MAX;
    }
  }
}

template <typename T, int K>
void launch_k(const T* x, T* vals, int* idx, int rows, int dim,
              cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec =
      dim % V == 0 && reinterpret_cast<size_t>(x) % 16 == 0;
  if (vec) {
    topk_kernel<T, K, true><<<rows, kThreads, 0, stream>>>(x, vals, idx, dim);
  } else {
    topk_kernel<T, K, false><<<rows, kThreads, 0, stream>>>(x, vals, idx,
                                                            dim);
  }
}

template <typename T>
int launch(const void* x, void* vals, void* idx, int rows, int dim, int k,
           cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* vt = static_cast<T*>(vals);
  int* it = static_cast<int*>(idx);
  switch (k) {
    case 1: launch_k<T, 1>(xt, vt, it, rows, dim, stream); break;
    case 2: launch_k<T, 2>(xt, vt, it, rows, dim, stream); break;
    case 3: launch_k<T, 3>(xt, vt, it, rows, dim, stream); break;
    case 4: launch_k<T, 4>(xt, vt, it, rows, dim, stream); break;
    case 5: launch_k<T, 5>(xt, vt, it, rows, dim, stream); break;
    case 6: launch_k<T, 6>(xt, vt, it, rows, dim, stream); break;
    case 7: launch_k<T, 7>(xt, vt, it, rows, dim, stream); break;
    case 8: launch_k<T, 8>(xt, vt, it, rows, dim, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (rows, dim) contiguous; vals (rows, k) in x's dtype; idx (rows, k)
// int32. dtype: 0 = float32, 1 = bfloat16, 2 = float16. 1 <= k <= 8 and
// k <= dim. Returns a cudaError_t code (0 on success); the launch is
// asynchronous on `stream`.
extern "C" int ff_topk(const void* x, void* vals, void* idx, int rows,
                       int dim, int k, int dtype, void* stream) {
  if (rows < 1 || dim < 1 || k < 1 || k > 8 || k > dim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, vals, idx, rows, dim, k, st);
    case 1: return launch<__nv_bfloat16>(x, vals, idx, rows, dim, k, st);
    case 2: return launch<__half>(x, vals, idx, rows, dim, k, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Row softmax, forward and backward, for Hopper (sm_90a).
//
// Replaces flexflow_tpu/kernels/softmax.py::_softmax_fwd_kernel and
// ::_softmax_bwd_kernel (the Pallas row kernels behind pallas_softmax, the
// opt-in route of SoftmaxOp). Over the last dim of a (rows, dim) array:
//
//     forward   p  = exp(x - max(x)) / sum(exp(x - max(x)))
//     backward  dx = p * (g - sum(p * g))
//
// in fp32 whatever the input dtype (fp32, bf16, fp16), each output rounded
// once to the input's dtype, as the TPU kernels do.
//
// What bounds it: bytes. A row is a few flops per element (a max, an exp,
// a sum, a divide), far below the card's flops per byte, so the bound is
// one read of each input and one write of the output. The TPU kernels keep
// a block of rows resident in VMEM for that; here one CTA (1024 threads)
// owns a row and keeps it in shared memory:
//   * forward: one pass reads the row from HBM in 16-byte vector loads,
//     stores it into shared memory and takes each thread's max; a block
//     reduction gives the row max; a pass over shared memory sums exp(x -
//     max); a last pass over shared memory writes p. Each element is read
//     from HBM once and written once. A row up to ~56K fp32 (~113K bf16)
//     elements fits the 227 KB a block may use; a longer row is read from
//     HBM three times instead (the kernel's kStaged = false form), and an
//     fp32 row of 50304 takes one CTA per SM (bf16: two);
//   * backward: one pass reads p and g, stages g in shared memory and sums
//     p * g; after the block reduction a second pass reads p again and g
//     from shared memory and writes dx. p is read twice, but the second
//     read comes right after the first from the same CTA, and the rows in
//     flight (132 x 200 KB in fp32) fit the 50 MB L2, so HBM sees it once.
//     A row too long to stage reads g twice as well.
// Not done yet (later work): rows spread over a thread-block cluster to
// fill the card when rows are few, and an exp pass that keeps exp(x - max)
// in shared memory for fp32 rows instead of computing it twice.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

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
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// elements of one vector load: 16 bytes, or one element unvectorised
template <typename T, bool kVec>
__host__ __device__ constexpr int vec_len() {
  return kVec ? 16 / static_cast<int>(sizeof(T)) : 1;
}

// block-wide max or sum of one value per thread; every thread gets the
// result. `red` is kWarps floats of shared memory, free on entry.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, w) : v + w;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[lane < kWarps ? lane : 0];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, w) : v + w;
  }
  __syncthreads();  // `red` is free again
  return v;
}

// kStaged: the row lives in dynamic shared memory (dim elements of T).
// kVec: 16-byte loads and stores (dim a multiple of the vector, rows
// 16-byte aligned).
template <typename T, bool kStaged, bool kVec>
__global__ void __launch_bounds__(kThreads)
    softmax_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int dim) {
  constexpr int V = vec_len<T, kVec>();
  using VT = Vec<T, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kWarps];
  VT* srow = reinterpret_cast<VT*>(smem);
  const VT* xr = reinterpret_cast<const VT*>(x + (size_t)blockIdx.x * dim);
  VT* yr = reinterpret_cast<VT*>(y + (size_t)blockIdx.x * dim);
  const int nv = dim / V;

  float m = -INFINITY;
#pragma unroll 4
  for (int i = threadIdx.x; i < nv; i += kThreads) {
    const VT v = xr[i];
    if (kStaged) srow[i] = v;
#pragma unroll
    for (int e = 0; e < V; ++e) m = fmaxf(m, to_f32(v.v[e]));
  }
  m = block_reduce<true>(m, red);  // its syncs also publish srow

  const VT* src = kStaged ? srow : xr;
  float s = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x; i < nv; i += kThreads) {
    const VT v = src[i];
#pragma unroll
    for (int e = 0; e < V; ++e) s += expf(to_f32(v.v[e]) - m);
  }
  s = block_reduce<false>(s, red);

#pragma unroll 4
  for (int i = threadIdx.x; i < nv; i += kThreads) {
    const VT v = src[i];
    VT o;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      o.v[e] = from_f32<T>(expf(to_f32(v.v[e]) - m) / s);
    }
    yr[i] = o;
  }
}

template <typename T, bool kStaged, bool kVec>
__global__ void __launch_bounds__(kThreads)
    softmax_bwd_kernel(const T* __restrict__ p, const T* __restrict__ g,
                       T* __restrict__ dx, int dim) {
  constexpr int V = vec_len<T, kVec>();
  using VT = Vec<T, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kWarps];
  VT* sg = reinterpret_cast<VT*>(smem);
  const size_t off = (size_t)blockIdx.x * dim;
  const VT* pr = reinterpret_cast<const VT*>(p + off);
  const VT* gr = reinterpret_cast<const VT*>(g + off);
  VT* dr = reinterpret_cast<VT*>(dx + off);
  const int nv = dim / V;

  float dot = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x; i < nv; i += kThreads) {
    const VT pv = pr[i];
    const VT gv = gr[i];
    if (kStaged) sg[i] = gv;
#pragma unroll
    for (int e = 0; e < V; ++e) dot += to_f32(pv.v[e]) * to_f32(gv.v[e]);
  }
  dot = block_reduce<false>(dot, red);

  const VT* gsrc = kStaged ? sg : gr;
#pragma unroll 4
  for (int i = threadIdx.x; i < nv; i += kThreads) {
    const VT pv = pr[i];
    const VT gv = gsrc[i];
    VT o;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float pf = to_f32(pv.v[e]);
      o.v[e] = from_f32<T>(pf * (to_f32(gv.v[e]) - dot));
    }
    dr[i] = o;
  }
}

// the largest dynamic shared memory a block of these kernels may take
int stage_limit() {
  static int limit = -1;
  if (limit < 0) {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    limit = optin - kWarps * static_cast<int>(sizeof(float)) - 64;
  }
  return limit;
}

// One kernel instantiation with `bytes` of dynamic shared memory; raises
// the kernel's limit above the default 48 KB the first time it is asked
// for more.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, int* granted) {
  if (bytes <= 48 * 1024 || static_cast<int>(bytes) <= *granted) {
    return cudaSuccess;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) *granted = static_cast<int>(bytes);
  return err;
}

template <typename T, bool kStaged, bool kVec>
int fwd_variant(const T* x, T* y, int rows, int dim, cudaStream_t stream) {
  static int granted = 0;
  const size_t bytes = kStaged ? sizeof(T) * (size_t)dim : 0;
  auto kernel = softmax_fwd_kernel<T, kStaged, kVec>;
  cudaError_t err = allow_smem(kernel, bytes, &granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<rows, kThreads, bytes, stream>>>(x, y, dim);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kStaged, bool kVec>
int bwd_variant(const T* p, const T* g, T* dx, int rows, int dim,
                cudaStream_t stream) {
  static int granted = 0;
  const size_t bytes = kStaged ? sizeof(T) * (size_t)dim : 0;
  auto kernel = softmax_bwd_kernel<T, kStaged, kVec>;
  cudaError_t err = allow_smem(kernel, bytes, &granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<rows, kThreads, bytes, stream>>>(p, g, dx, dim);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
bool use_vec(int dim, const void* a, const void* b, const void* c) {
  constexpr int V = 16 / sizeof(T);
  return dim % V == 0 && reinterpret_cast<size_t>(a) % 16 == 0 &&
         reinterpret_cast<size_t>(b) % 16 == 0 &&
         reinterpret_cast<size_t>(c) % 16 == 0;
}

template <typename T>
int fwd(const void* x, void* y, int rows, int dim, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const bool staged = sizeof(T) * (size_t)dim <= (size_t)stage_limit();
  const bool vec = use_vec<T>(dim, x, y, y);
  if (staged) {
    return vec ? fwd_variant<T, true, true>(xt, yt, rows, dim, stream)
               : fwd_variant<T, true, false>(xt, yt, rows, dim, stream);
  }
  return vec ? fwd_variant<T, false, true>(xt, yt, rows, dim, stream)
             : fwd_variant<T, false, false>(xt, yt, rows, dim, stream);
}

template <typename T>
int bwd(const void* p, const void* g, void* dx, int rows, int dim,
        cudaStream_t stream) {
  const T* pt = static_cast<const T*>(p);
  const T* gt = static_cast<const T*>(g);
  T* dt = static_cast<T*>(dx);
  const bool staged = sizeof(T) * (size_t)dim <= (size_t)stage_limit();
  const bool vec = use_vec<T>(dim, p, g, dx);
  if (staged) {
    return vec ? bwd_variant<T, true, true>(pt, gt, dt, rows, dim, stream)
               : bwd_variant<T, true, false>(pt, gt, dt, rows, dim, stream);
  }
  return vec ? bwd_variant<T, false, true>(pt, gt, dt, rows, dim, stream)
             : bwd_variant<T, false, false>(pt, gt, dt, rows, dim, stream);
}

}  // namespace

// x, y (rows, dim) contiguous, one dtype: 0 = float32, 1 = bfloat16,
// 2 = float16. Returns a cudaError_t code (0 on success); the launch is
// asynchronous on `stream`.
extern "C" int ff_softmax_fwd(const void* x, void* y, int rows, int dim,
                              int dtype, void* stream) {
  if (rows < 1 || dim < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return fwd<float>(x, y, rows, dim, st);
    case 1: return fwd<__nv_bfloat16>(x, y, rows, dim, st);
    case 2: return fwd<__half>(x, y, rows, dim, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// p (the forward's output), g (its cotangent) and dx (rows, dim)
// contiguous, one dtype.
extern "C" int ff_softmax_bwd(const void* p, const void* g, void* dx,
                              int rows, int dim, int dtype, void* stream) {
  if (rows < 1 || dim < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return bwd<float>(p, g, dx, rows, dim, st);
    case 1: return bwd<__nv_bfloat16>(p, g, dx, rows, dim, st);
    case 2: return bwd<__half>(p, g, dx, rows, dim, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Paged single-token attention ("flash decode") for Hopper (sm_90a).
//
// Replaces flexflow_tpu/kernels/flash_decode.py::_decode_kernel (the Pallas
// split-K kernel behind flash_decode, routed from ops/attention.py
// _maybe_flash_decode). It computes, for every (slot, head):
//
//     out = softmax(scale * q . K[:n]) @ V[:n]
//
// where K/V rows are the slot's first n = n_keys[slot] key positions,
// resolved through the slot's block table into a pool of
// (n_blocks, heads, block_size, dim) blocks. Scores, the running max m, the
// normaliser l and the accumulator are fp32 whatever the pool dtype (fp32,
// bf16, fp16); the output is written in the pool dtype.
//
// What bounds it: bytes. Each key row is read once and used for 2*dim
// flops (score) plus 2*dim (PV), far below the H100's ~20 flops per byte
// of fp32 balance, so the only cost that matters is streaming the used
// K/V rows from HBM. The design therefore:
//   * reads only the blocks the slot occupies: the key loop stops at
//     n_keys (ceil(n/bs) blocks), nothing past it is touched — the TPU
//     kernel's clamp of dead grid steps becomes a loop bound here;
//   * gives one CTA to each (slot, head) and splits its keys across the
//     CTA's warps; each warp scores TILE keys at a time with all K and V
//     loads of the tile issued before any arithmetic (2*TILE row loads in
//     flight per warp), lanes spread across the head dim so every row
//     load is coalesced. Where the dims and pointers allow, each lane
//     reads its kPerLane elements as one vector (8 to 32 bytes) instead of
//     kPerLane scalars strided by 32 lanes;
//   * runs as many warps per CTA as the head width's registers allow (32
//     for heads up to 64 wide, 16 up to 128, 8 up to 256): decode has only
//     slots * heads CTAs, fewer than two per SM at GPT-2 small's 8 x 12,
//     so the loads in flight that hide HBM latency must come from warps
//     inside the CTA;
//   * keeps a per-warp online softmax (m, l, acc) in registers and merges
//     the warps once through shared memory at the end — the in-CTA
//     equivalent of the TPU kernel's sequential (m, l, acc) scratch, since
//     CUDA blocks cannot carry state from one grid step to the next.
//
// int8 KV (ff_flash_decode_int8) replaces the same kernel's int8 branch
// (flash_decode.py:78-80): pools hold int8 rows and f32 per-(token, head)
// scales in (n_blocks, heads, block_size) arrays laid out like the pools'
// rows, so a key's scale sits at the same row index as its K/V row. Each
// lane loads its int8 elements (2 bytes a lane at head_dim 64: one 64-byte
// row per warp) and the row's scale, and dequantizes in registers
// (float(k) * scale, the TPU kernel's order) before the same fp32 math. q
// and the output keep the model dtype. Bound: bytes again, now kd + vd
// bytes plus 8 bytes of scales per key and head, about a quarter of the
// fp32 pool's traffic.
//
// Not done yet (later work): split-K across CTAs for long contexts with few
// slots (at 8 x 12 CTAs a third of the SMs idle), TMA/cp.async staging.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxDim = 256;
constexpr int kTile = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

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
template <>
__device__ __forceinline__ int8_t from_f32<int8_t>(float x) {
  return static_cast<int8_t>(x);
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// Head-dim element i of a lane: a contiguous run of kPerLane elements per
// lane when vectorised, else lane-strided (lane, lane + 32, ...).
template <int kPerLane, bool kVec>
__device__ __forceinline__ int dim_of(int lane, int i) {
  return kVec ? lane * kPerLane + i : lane + 32 * i;
}

// One row's elements of this lane as fp32 (zeros where dead or past dim).
// kVec requires dim % kPerLane == 0 and a row start aligned to the vector.
template <typename T, int kPerLane, bool kVec>
__device__ __forceinline__ void load_row(const T* row, int dim, int lane,
                                         bool live, float (&x)[kPerLane]) {
  if (kVec) {
    const int d0 = lane * kPerLane;
    Vec<T, kPerLane> v;
    if (live && d0 < dim) {
      v = *reinterpret_cast<const Vec<T, kPerLane>*>(row + d0);
    } else {
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) v.v[i] = from_f32<T>(0.f);
    }
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) x[i] = to_f32(v.v[i]);
  } else {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int d = lane + 32 * i;
      x[i] = (live && d < dim) ? to_f32(row[d]) : 0.f;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// kPerLane: head-dim elements each lane holds (dims up to 32 * kPerLane);
// instantiated for 64-, 128- and 256-wide heads so a narrow head does not
// pay registers for the widest one. kWarps: warps per CTA, as many as
// kPerLane's registers allow under the 64K-register file. kVec: vector
// loads (see load_row).
// T: q and output dtype. TKV: pool dtype — T itself, or int8_t with the
// f32 scale arrays kscale/vscale (null for a native pool).
template <typename T, typename TKV, int kPerLane, int kWarps, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
    flash_decode_kernel(const T* __restrict__ q,
                        const TKV* __restrict__ kpool,
                        const TKV* __restrict__ vpool,
                        const float* __restrict__ kscale,
                        const float* __restrict__ vscale,
                        const int* __restrict__ tables,
                        const int* __restrict__ n_keys, T* __restrict__ out,
                        int heads, int hd, int vd, int bs, int mb,
                        float scale) {
  constexpr bool kInt8 = sizeof(TKV) == 1;
  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][kPerLane * 32];

  // keys past the table's extent do not exist: the slot attends to at
  // most mb * bs positions (the TPU kernel's grid has exactly mb steps)
  const int n = max(0, min(n_keys[s], mb * bs));
  const int* trow = tables + (size_t)s * mb;

  float qr[kPerLane];
  load_row<T, kPerLane, kVec>(q + ((size_t)s * heads + h) * hd, hd, lane,
                              true, qr);
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) qr[i] *= scale;

  float m = -INFINITY;
  float l = 0.f;
  float acc[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) acc[i] = 0.f;

  for (int base = warp * kTile; base < n; base += kWarps * kTile) {
    float kv[kTile][kPerLane];
    float vv[kTile][kPerLane];
    // issue every K and V load of the tile first: they are independent of
    // the scores, so 2 * kTile coalesced row reads are in flight at once
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      const int j = base + t;
      const bool live = j < n;
      const int blk = live ? trow[j / bs] : 0;
      const size_t row = ((size_t)blk * heads + h) * bs + (live ? j % bs : 0);
      load_row<TKV, kPerLane, kVec>(kpool + row * hd, hd, lane, live, kv[t]);
      load_row<TKV, kPerLane, kVec>(vpool + row * vd, vd, lane, live, vv[t]);
      if constexpr (kInt8) {
        // every lane reads the row's scale (one broadcast load); dead keys
        // are zeros already and keep them
        const float ks = live ? kscale[row] : 0.f;
        const float vs = live ? vscale[row] : 0.f;
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
          kv[t][i] *= ks;
          vv[t][i] *= vs;
        }
      }
    }
    float sc[kTile];
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) part += qr[i] * kv[t][i];
      // lanes beyond the last key still join the shuffle; their score is
      // then replaced by -inf so they carry no weight
      part = warp_sum(part);
      sc[t] = (base + t < n) ? part : -INFINITY;
    }
    float tmax = sc[0];  // base < n, so key `base` is live
#pragma unroll
    for (int t = 1; t < kTile; ++t) tmax = fmaxf(tmax, sc[t]);
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);  // m == -inf on the first tile -> 0
    float p[kTile];
    float psum = 0.f;
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      p[t] = (base + t < n) ? expf(sc[t] - m_new) : 0.f;
      psum += p[t];
    }
    l = l * corr + psum;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      float a = acc[i] * corr;
#pragma unroll
      for (int t = 0; t < kTile; ++t) a += p[t] * vv[t][i];
      acc[i] = a;
    }
    m = m_new;
  }

  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int d = dim_of<kPerLane, kVec>(lane, i);
    if (d < vd) sm_acc[warp][d] = acc[i];
  }
  __syncthreads();

  float mx = -INFINITY;
#pragma unroll 4
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
  T* orow = out + ((size_t)s * heads + h) * vd;
  for (int d = threadIdx.x; d < vd; d += blockDim.x) {
    float lsum = 0.f;
    float a = 0.f;
#pragma unroll 4
    for (int w = 0; w < kWarps; ++w) {
      // a warp that saw no key has m = -inf and contributes nothing
      const float f = sm_m[w] == -INFINITY ? 0.f : expf(sm_m[w] - mx);
      lsum += sm_l[w] * f;
      a += sm_acc[w][d] * f;
    }
    orow[d] = from_f32<T>(lsum > 0.f ? a / lsum : 0.f);
  }
}

template <typename T, typename TKV, int kPerLane, int kWarps>
void launch_width(const T* q, const TKV* kpool, const TKV* vpool,
                  const float* kscale, const float* vscale, const int* tables,
                  const int* n_keys, T* out, int n_slots, int heads, int hd,
                  int vd, int bs, int mb, float scale, cudaStream_t stream) {
  const dim3 grid(heads, n_slots);
  // each lane loads kPerLane contiguous elements as one vector when the
  // dims divide and every base pointer is aligned to its vector
  const bool vec = hd % kPerLane == 0 && vd % kPerLane == 0 &&
                   reinterpret_cast<size_t>(q) % (sizeof(T) * kPerLane) == 0 &&
                   reinterpret_cast<size_t>(kpool) %
                           (sizeof(TKV) * kPerLane) == 0 &&
                   reinterpret_cast<size_t>(vpool) %
                           (sizeof(TKV) * kPerLane) == 0;
  if (vec) {
    flash_decode_kernel<T, TKV, kPerLane, kWarps, true>
        <<<grid, kWarps * 32, 0, stream>>>(q, kpool, vpool, kscale, vscale,
                                           tables, n_keys, out, heads, hd, vd,
                                           bs, mb, scale);
  } else {
    flash_decode_kernel<T, TKV, kPerLane, kWarps, false>
        <<<grid, kWarps * 32, 0, stream>>>(q, kpool, vpool, kscale, vscale,
                                           tables, n_keys, out, heads, hd, vd,
                                           bs, mb, scale);
  }
}

template <typename T, typename TKV>
int launch(const void* q, const void* kpool, const void* vpool,
           const void* kscale, const void* vscale, const void* tables,
           const void* n_keys, void* out, int n_slots, int heads, int hd,
           int vd, int bs, int mb, float scale, cudaStream_t stream) {
  const int widest = hd > vd ? hd : vd;
  const T* qt = static_cast<const T*>(q);
  const TKV* kt = static_cast<const TKV*>(kpool);
  const TKV* vt = static_cast<const TKV*>(vpool);
  const float* kst = static_cast<const float*>(kscale);
  const float* vst = static_cast<const float*>(vscale);
  const int* tt = static_cast<const int*>(tables);
  const int* nt = static_cast<const int*>(n_keys);
  T* ot = static_cast<T*>(out);
  if (widest <= 64) {
    launch_width<T, TKV, 2, 32>(qt, kt, vt, kst, vst, tt, nt, ot, n_slots,
                                heads, hd, vd, bs, mb, scale, stream);
  } else if (widest <= 128) {
    launch_width<T, TKV, 4, 16>(qt, kt, vt, kst, vst, tt, nt, ot, n_slots,
                                heads, hd, vd, bs, mb, scale, stream);
  } else {
    launch_width<T, TKV, 8, 8>(qt, kt, vt, kst, vst, tt, nt, ot, n_slots,
                               heads, hd, vd, bs, mb, scale, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int n_slots, int heads, int hd, int vd, int bs, int mb) {
  return n_slots < 1 || n_slots > 65535 || heads < 1 || hd < 1 ||
         hd > kMaxDim || vd < 1 || vd > kMaxDim || bs < 1 || mb < 1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, pools and output).
// Returns a cudaError_t code (0 on success); the launch is asynchronous on
// `stream`.
extern "C" int ff_flash_decode(const void* q, const void* kpool,
                               const void* vpool, const void* tables,
                               const void* n_keys, void* out, int n_slots,
                               int heads, int hd, int vd, int bs, int mb,
                               float scale, int dtype, void* stream) {
  if (bad_shape(n_slots, heads, hd, vd, bs, mb)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float, float>(q, kpool, vpool, nullptr, nullptr, tables,
                                  n_keys, out, n_slots, heads, hd, vd, bs,
                                  mb, scale, st);
    case 1:
      return launch<__nv_bfloat16, __nv_bfloat16>(
          q, kpool, vpool, nullptr, nullptr, tables, n_keys, out, n_slots,
          heads, hd, vd, bs, mb, scale, st);
    case 2:
      return launch<__half, __half>(q, kpool, vpool, nullptr, nullptr,
                                    tables, n_keys, out, n_slots, heads, hd,
                                    vd, bs, mb, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// int8 pools with f32 scales (n_blocks, heads, bs); dtype is q's and the
// output's (0 = float32, 1 = bfloat16, 2 = float16).
extern "C" int ff_flash_decode_int8(const void* q, const void* kpool,
                                    const void* vpool, const void* kscale,
                                    const void* vscale, const void* tables,
                                    const void* n_keys, void* out,
                                    int n_slots, int heads, int hd, int vd,
                                    int bs, int mb, float scale, int dtype,
                                    void* stream) {
  if (bad_shape(n_slots, heads, hd, vd, bs, mb) || kscale == nullptr ||
      vscale == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float, int8_t>(q, kpool, vpool, kscale, vscale, tables,
                                   n_keys, out, n_slots, heads, hd, vd, bs,
                                   mb, scale, st);
    case 1:
      return launch<__nv_bfloat16, int8_t>(q, kpool, vpool, kscale, vscale,
                                           tables, n_keys, out, n_slots,
                                           heads, hd, vd, bs, mb, scale, st);
    case 2:
      return launch<__half, int8_t>(q, kpool, vpool, kscale, vscale, tables,
                                    n_keys, out, n_slots, heads, hd, vd, bs,
                                    mb, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

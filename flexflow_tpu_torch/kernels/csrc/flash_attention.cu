// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of flexflow_tpu/kernels/flash_attention.py:
//   ff_flash_fwd     <- _flash_fwd_kernel        (B1, pallas_call :303)
//   ff_flash_bwd_kv  <- _flash_bwd_fused_kernel  (B2, pallas_call :587)
//                       with fused = 1, and
//                    <- _flash_bwd_dkv_kernel    (B3, pallas_call :617)
//                       with fused = 0
//   ff_flash_bwd_q   <- _flash_bwd_dq_kernel     (B4, pallas_call :640)
//
// What they compute, on (batch * heads, seq, head_dim) row-major tensors
// with q already scaled by 1/sqrt(d) and rounded to its dtype by the caller
// (as the JAX package does outside its kernels):
//   forward   O = softmax(q k^T) v, lse = m + log(l), masked scores -1e30,
//             causal band k_pos <= q_pos + (seq_k - seq_q), the l == 0
//             guard, dropout applied after the normaliser (l comes from the
//             undropped probabilities) through the counter hash below;
//   backward  P = exp(s - lse), dV = (P*D)^T dO, dS = P * (D*dP - delta),
//             dK = dS^T q_scaled, dQ = dS k (scaled by 1/sqrt(d) by the
//             caller for the fused schedule, in-kernel for ff_flash_bwd_q),
//             with delta = rowsum(dO * O) computed in-kernel when fused.
// All sums are fp32 whatever the input dtype (fp32, bf16, fp16); P and dS
// are rounded to the input dtype before they enter a product, as the TPU
// kernels' `.astype(v.dtype)` do.
//
// What bounds them: operations. At BERT-Large shapes (seq 512, d 64) the
// forward does 4*seq*d = 131k flops per query row against 4*d*2 bytes of
// q/o traffic plus k/v re-reads from L2; far above the H100's balance point
// of ~295 bf16 flops per byte. The design is the simple one that is right:
//   * one CTA per (batch*head, 64-row tile) — q tiles for the forward and
//     dQ kernels, k tiles for the dK/dV kernel — looping inside the CTA
//     over the other sequence's 64-row tiles (the TPU's sequential grid
//     dimension becomes this loop, since CUDA blocks carry nothing from one
//     to the next); causal loops start or stop at the band, so tiles wholly
//     above it are never read (the TPU kernels' tile skipping);
//   * the fused backward has no CTA that owns a dQ row, so dQ accumulates
//     through fp32 atomicAdd into a (b*h, seq_q, d) buffer the caller
//     zeroes;
//   * fp32 inputs run on the CUDA cores (SIMT FMA, 256 threads, tiles
//     staged as fp32 in shared memory with a one-word row pad, each thread
//     owning a 4 x 4 block of the 64 x 64 score tile, rows ty*4+i and
//     columns tx+16j; row max and sums are half-warp shuffles). fp32 has no
//     tensor-core rate that keeps fp32 products (TF32 would round them);
//   * bf16 and fp16 inputs run on the tensor cores (mma.sync m16n8k16, fp32
//     accumulators, 128 threads; see the section below).
// Not done yet: wgmma and TMA, pipelined (double-buffered) tile loads, a
// persistent schedule, and split-K for few long heads (PERF.md has the
// measured times).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 64;      // rows of a q tile and of a k tile
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 scores each
constexpr int kSP = kTile + 1; // padded row stride of score tiles
constexpr float kNegInf = -1e30f;

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

// x rounded to T and back: what `.astype(T)` leaves of an fp32 value
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// flexflow_tpu/kernels/flash_attention.py:96-113 (dropout_keep_scale_nd),
// bit for bit in uint32 arithmetic: 0 or 1/(1-rate) for one score element
// at GLOBAL coordinates, so every kernel regenerates the same mask.
__device__ __forceinline__ float keep_scale(uint32_t seed, uint32_t bh,
                                            uint32_t qpos, uint32_t kpos,
                                            uint32_t threshold,
                                            float scale) {
  uint32_t x = qpos * 0x9E3779B1u + kpos * 0x85EBCA77u + bh * 0xC2B2AE3Du +
               seed;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >= threshold ? scale : 0.f;
}

struct Dropout {
  int on;
  uint32_t seed;
  uint32_t threshold;
  float scale;
};

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [0, 64) of a (rows, D) tile at `src` into fp32 shared memory with
// row stride D + 1; coalesced reads along the row
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    dst[r * (D + 1) + c] = to_f32(src[i]);
  }
}

// acc[i][j] = sum_d A[ty*4+i][d] * B[tx+16j][d] over two (64, D) tiles of
// stride D + 1: the score tile q k^T (or dO v^T) of this thread
template <int D>
__device__ __forceinline__ void rows_dot_rows(const float* A, const float* B,
                                              int ty, int tx,
                                              float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty * 4 + i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_c S[rowsel(i)][c] * M[c][tx+16j] with S a 64 x 64 score
// tile (stride kSP) and M a (64, D) tile (stride D + 1). With `transposed`
// the score tile is read down its columns: S[c][ty*4+i] (P^T dO, dS^T q).
template <int D, bool transposed>
__device__ __forceinline__ void scores_times_tile(const float* S,
                                                  const float* M, int ty,
                                                  int tx,
                                                  float (&acc)[4][D / 16]) {
#pragma unroll 4
  for (int c = 0; c < kTile; ++c) {
    float s[4], m[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s[i] = transposed ? S[c * kSP + ty * 4 + i] : S[(ty * 4 + i) * kSP + c];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) m[j] = M[c * (D + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(s[i], m[j], acc[i][j]);
  }
}

struct Shape {
  int sq;
  int sk;
  int causal;
};

// number of k tiles a q tile starting at q0 reaches: all of them, or up to
// the causal band (the tile holding key q0 + 63 + offset)
__device__ __forceinline__ int k_tiles_for(const Shape& sh, int q0) {
  const int nkb = sh.sk / kTile;
  if (!sh.causal) return nkb;
  const int last = q0 + kTile - 1 + (sh.sk - sh.sq);
  return min(nkb, last / kTile + 1);
}

// first q tile that reaches key tile k0 under the causal band
// (_first_contributing_qb, flash_attention.py:159)
__device__ __forceinline__ int first_q_tile(const Shape& sh, int k0) {
  if (!sh.causal) return 0;
  return max(k0 - (sh.sk - sh.sq), 0) / kTile;
}

// ------------------------------------------------------------------ forward
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, Shape sh, Dropout dr) {
  extern __shared__ float smem[];
  constexpr int P = D + 1;
  float* sQ = smem;
  float* sK = sQ + kTile * P;
  float* sV = sK + kTile * P;
  float* sP = sV + kTile * P;  // 64 x kSP

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int offset = sh.sk - sh.sq;
  const T* kb_base = k + (size_t)bh * sh.sk * D;
  const T* vb_base = v + (size_t)bh * sh.sk * D;

  load_tile<T, D>(sQ, q + ((size_t)bh * sh.sq + q0) * D);

  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  }

  const int nkb = k_tiles_for(sh, q0);
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * kTile;
    __syncthreads();  // the previous tile's readers are done with sK/sV/sP
    load_tile<T, D>(sK, kb_base + (size_t)k0 * D);
    load_tile<T, D>(sV, vb_base + (size_t)k0 * D);
    __syncthreads();

    float s[4][4];
    rows_dot_rows<D>(sQ, sK, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      if (sh.causal) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (qpos + offset < k0 + tx + 16 * j) s[i][j] = kNegInf;
      }
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float p[4];
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = expf(s[i][j] - m_new);
        psum += p[j];
      }
      // the normaliser comes from the UNDROPPED probabilities
      l[i] = l[i] * alpha + half_warp_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float pj = p[j];
        if (dr.on)
          pj *= keep_scale(dr.seed, bh, qpos, k0 + tx + 16 * j, dr.threshold,
                           dr.scale);
        sP[(ty * 4 + i) * kSP + tx + 16 * j] = round_to<T>(pj);
      }
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    scores_times_tile<D, false>(sP, sV, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + ((size_t)bh * sh.sq + row) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      orow[tx + 16 * j] = from_f32<T>(acc[i][j] / l_safe);
    if (tx == 0) lse[(size_t)bh * sh.sq + row] = m[i] + logf(l_safe);
  }
}

// ------------------------------------------- backward over k tiles (dK, dV)
// fused = true: B2 — delta from dO and O in-kernel, dQ by atomicAdd into
// dq_acc. fused = false: B3 — delta read from `delta`, no dQ.
template <typename T, int D, bool kFused>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dk,
                        T* __restrict__ dv, float* __restrict__ dq_acc,
                        Shape sh, Dropout dr) {
  extern __shared__ float smem[];
  constexpr int P = D + 1;
  float* sK = smem;
  float* sV = sK + kTile * P;
  float* sQ = sV + kTile * P;
  float* sdO = sQ + kTile * P;
  float* sPd = sdO + kTile * P;  // dropped P, rounded (64 x kSP)
  float* sdS = sPd + kTile * kSP;  // dS, rounded (64 x kSP)
  float* sLse = sdS + kTile * kSP;
  float* sDelta = sLse + kTile;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int offset = sh.sk - sh.sq;
  const size_t qbase = (size_t)bh * sh.sq;

  load_tile<T, D>(sK, k + ((size_t)bh * sh.sk + k0) * D);
  load_tile<T, D>(sV, v + ((size_t)bh * sh.sk + k0) * D);

  // this thread's dK/dV rows are k rows ty*4+i, columns tx+16j
  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      dk_acc[i][j] = 0.f;
      dv_acc[i][j] = 0.f;
    }

  const int nqb = sh.sq / kTile;
  for (int qb = first_q_tile(sh, k0); qb < nqb; ++qb) {
    const int q0 = qb * kTile;
    __syncthreads();  // readers of the previous q tile are done
    load_tile<T, D>(sQ, q + (qbase + q0) * D);
    load_tile<T, D>(sdO, dout + (qbase + q0) * D);
    if (threadIdx.x < kTile) {
      sLse[threadIdx.x] = lse[qbase + q0 + threadIdx.x];
      if (!kFused) sDelta[threadIdx.x] = delta[qbase + q0 + threadIdx.x];
    }
    __syncthreads();
    if (kFused) {
      // delta = rowsum(dO * O): four threads per row, shuffled together
      const int row = threadIdx.x >> 2;
      const int part = threadIdx.x & 3;
      const T* orow = o + (qbase + q0 + row) * D;
      float sum = 0.f;
      for (int d = part; d < D; d += 4)
        sum = fmaf(sdO[row * P + d], to_f32(orow[d]), sum);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) sDelta[row] = sum;
      __syncthreads();
    }

    // score-tile rows are q rows ty*4+i, columns k rows tx+16j
    float s[4][4], dp[4][4];
    rows_dot_rows<D>(sQ, sK, ty, tx, s);
    rows_dot_rows<D>(sdO, sV, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float sv = s[i][j];
        if (sh.causal && qpos + offset < k0 + c) sv = kNegInf;
        const float p = expf(sv - sLse[r]);
        float pd = p;
        float dpj = dp[i][j];
        if (dr.on) {
          const float keep =
              keep_scale(dr.seed, bh, qpos, k0 + c, dr.threshold, dr.scale);
          pd = p * keep;
          dpj = dpj * keep;
        }
        sPd[r * kSP + c] = round_to<T>(pd);
        sdS[r * kSP + c] = round_to<T>(p * (dpj - sDelta[r]));
      }
    }
    __syncthreads();
    // dV += Pd^T dO, dK += dS^T q (q pre-scaled, so dK is exact)
    scores_times_tile<D, true>(sPd, sdO, ty, tx, dv_acc);
    scores_times_tile<D, true>(sdS, sQ, ty, tx, dk_acc);
    if (kFused) {
      // dQ rows are q rows ty*4+i: dQ += dS k, unscaled (the caller scales)
      float dq[4][D / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < D / 16; ++j) dq[i][j] = 0.f;
      scores_times_tile<D, false>(sdS, sK, ty, tx, dq);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* drow = dq_acc + (qbase + q0 + ty * 4 + i) * D;
#pragma unroll
        for (int j = 0; j < D / 16; ++j) atomicAdd(drow + tx + 16 * j, dq[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t row = (size_t)bh * sh.sk + k0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      dk[row * D + tx + 16 * j] = from_f32<T>(dk_acc[i][j]);
      dv[row * D + tx + 16 * j] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

// ------------------------------------------------- backward over q tiles (dQ)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq,
                       float sm_scale, Shape sh, Dropout dr) {
  extern __shared__ float smem[];
  constexpr int P = D + 1;
  float* sQ = smem;
  float* sdO = sQ + kTile * P;
  float* sK = sdO + kTile * P;
  float* sV = sK + kTile * P;
  float* sdS = sV + kTile * P;  // 64 x kSP
  float* sLse = sdS + kTile * kSP;
  float* sDelta = sLse + kTile;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int offset = sh.sk - sh.sq;
  const size_t qbase = (size_t)bh * sh.sq;
  const T* kb_base = k + (size_t)bh * sh.sk * D;
  const T* vb_base = v + (size_t)bh * sh.sk * D;

  load_tile<T, D>(sQ, q + (qbase + q0) * D);
  load_tile<T, D>(sdO, dout + (qbase + q0) * D);
  if (threadIdx.x < kTile) {
    sLse[threadIdx.x] = lse[qbase + q0 + threadIdx.x];
    sDelta[threadIdx.x] = delta[qbase + q0 + threadIdx.x];
  }

  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;

  const int nkb = k_tiles_for(sh, q0);
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * kTile;
    __syncthreads();
    load_tile<T, D>(sK, kb_base + (size_t)k0 * D);
    load_tile<T, D>(sV, vb_base + (size_t)k0 * D);
    __syncthreads();
    float s[4][4], dp[4][4];
    rows_dot_rows<D>(sQ, sK, ty, tx, s);
    rows_dot_rows<D>(sdO, sV, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float sv = s[i][j];
        if (sh.causal && qpos + offset < k0 + c) sv = kNegInf;
        const float p = expf(sv - sLse[r]);
        float dpj = dp[i][j];
        if (dr.on)
          dpj *= keep_scale(dr.seed, bh, qpos, k0 + c, dr.threshold, dr.scale);
        sdS[r * kSP + c] = round_to<T>(p * (dpj - sDelta[r]));
      }
    }
    __syncthreads();
    scores_times_tile<D, false>(sdS, sK, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T* drow = dq + (qbase + q0 + ty * 4 + i) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      drow[tx + 16 * j] = from_f32<T>(acc[i][j] * sm_scale);
  }
}

// ------------------------------------------------ tensor-core path (16-bit)
// bf16 and fp16 inputs take mma.sync.m16n8k16 with fp32 accumulators: 128
// threads (4 warps) per CTA, each warp owning 16 rows of the CTA's 64-row
// tile. Tiles stay in their 16-bit dtype in shared memory with a 16-byte
// row pad (row stride D + 8: the 32-bit fragment loads and the ldmatrix
// rows of a warp fall in distinct banks). A score tile leaves the
// accumulators as fp32, is masked, exponentiated and scaled in registers,
// rounded to the dtype and re-packed as the A operand of the next product
// (the accumulator layout of two adjacent 8-column tiles is the A layout
// of one 16-wide k step). Operands needed k-major (V, dO, q, K as the B of
// P V, P^T dO, dS^T q, dS K) come through ldmatrix.trans. The fused
// backward writes dS to shared memory once, transposed, for the dQ product.

constexpr int kThreadsTC = 128;

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // two fp32 values rounded to the dtype, the first in the low half
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A operand (16 x 16) of a row-major shared matrix at (row0, col0)
template <typename T>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const T* m,
                                       int stride, int row0, int col0,
                                       int lane) {
  const int g = lane >> 2, t = (lane & 3) * 2;
  const T* p = m + (row0 + g) * stride + col0 + t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * stride);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * stride + 8);
}

// B operand (k 16 x n 8) of a shared matrix stored n-major, m[n][k]
template <typename T>
__device__ __forceinline__ void frag_b(uint32_t (&b)[2], const T* m,
                                       int stride, int n0, int k0,
                                       int lane) {
  const T* p = m + (n0 + (lane >> 2)) * stride + k0 + (lane & 3) * 2;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// B operands of two n tiles (n0, n0 + 8) over k0..k0+15 of a shared matrix
// stored k-major, m[k][n]: b[0..1] for n0, b[2..3] for n0 + 8
template <typename T>
__device__ __forceinline__ void frag_b_kmajor(uint32_t (&b)[4], const T* m,
                                              int stride, int k0, int n0,
                                              int lane) {
  const int row = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int col = n0 + (lane >> 4) * 8;
  const unsigned addr = static_cast<unsigned>(
      __cvta_generic_to_shared(m + row * stride + col));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(addr));
}

// rows [0, 64) of a (rows, D) 16-bit tile into shared memory with row
// stride D + 8, in 16-byte chunks
template <typename T, int D>
__device__ __forceinline__ void load_tile16(T* dst, const T* src) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreadsTC) {
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * 8;
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) =
        *reinterpret_cast<const uint4*>(src + r * D + c);
  }
}

// A operands of a 16 x 64 tile held as accumulators (8 n tiles of 8):
// k step kk is n tiles 2kk and 2kk+1, values rounded to the dtype
template <typename T>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4][4],
                                         const float (&c)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = Mma<T>::pack(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = Mma<T>::pack(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = Mma<T>::pack(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = Mma<T>::pack(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// acc (16 x D, D/8 n tiles) += a (16 x 64) * m (64 x D), m k-major
template <typename T, int D>
__device__ __forceinline__ void tile_times_kmajor(float (&acc)[D / 8][4],
                                                  const uint32_t (&a)[4][4],
                                                  const T* m, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      uint32_t b[4];
      frag_b_kmajor(b, m, D + 8, kk * 16, n * 16, lane);
      Mma<T>::run(acc[2 * n], a[kk], b[0], b[1]);
      Mma<T>::run(acc[2 * n + 1], a[kk], b[2], b[3]);
    }
  }
}

// c (16 x 64) = rows row0.. of a (.., D) times m^T, m a (64, D) n-major tile
template <typename T, int D>
__device__ __forceinline__ void rows_times_tile_t(float (&c)[8][4],
                                                  const T* a_rows, int row0,
                                                  const T* m, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    frag_a(a, a_rows, D + 8, row0, kk * 16, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t b[2];
      frag_b(b, m, D + 8, j * 8, kk * 16, lane);
      Mma<T>::run(c[j], a, b[0], b[1]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreadsTC)
    flash_fwd_tc(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Shape sh, Dropout dr) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  constexpr int S = D + 8;
  T* sQ = reinterpret_cast<T*>(smem_tc);
  T* sK = sQ + kTile * S;
  T* sV = sK + kTile * S;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int offset = sh.sk - sh.sq;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0+8
  const T* kb_base = k + (size_t)bh * sh.sk * D;
  const T* vb_base = v + (size_t)bh * sh.sk * D;

  load_tile16<T, D>(sQ, q + ((size_t)bh * sh.sq + q0) * D);

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int nkb = k_tiles_for(sh, q0);
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * kTile;
    __syncthreads();
    load_tile16<T, D>(sK, kb_base + (size_t)k0 * D);
    load_tile16<T, D>(sV, vb_base + (size_t)k0 * D);
    __syncthreads();

    float s[8][4];
    rows_times_tile_t<T, D>(s, sQ, warp * 16, sK, lane);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        if (sh.causal && row0 + 8 * r + offset < k0 + j * 8 + t2 + (e & 1))
          s[j][e] = kNegInf;
        mx[r] = fmaxf(mx[r], s[j][e]);
      }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);
        psum[e >> 1] += p;
        // the normaliser sums the UNDROPPED probabilities
        s[j][e] = dr.on ? p * keep_scale(dr.seed, bh, row0 + 8 * (e >> 1),
                                         k0 + j * 8 + t2 + (e & 1),
                                         dr.threshold, dr.scale)
                        : p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      l[r] = l[r] * alpha[r] + psum[r];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    uint32_t pa[4][4];
    acc_to_a<T>(pa, s);
    tile_times_kmajor<T, D>(acc, pa, sV, lane);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    const size_t row = (size_t)bh * sh.sq + row0 + 8 * r;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(o + row * D + n * 8 + t2) = Mma<T>::pack(
          acc[n][2 * r] / l_safe, acc[n][2 * r + 1] / l_safe);
    if ((lane & 3) == 0) lse[row] = m[r] + logf(l_safe);
  }
}

// backward over k tiles on the tensor cores: B2 (kFused) or B3
template <typename T, int D, bool kFused>
__global__ void __launch_bounds__(kThreadsTC)
    flash_bwd_kv_tc(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, float* __restrict__ dq_acc, Shape sh,
                    Dropout dr) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  constexpr int S = D + 8;
  constexpr int SS = kTile + 8;  // stride of the dS^T tile, dS[q][key]
  T* sK = reinterpret_cast<T*>(smem_tc);
  T* sV = sK + kTile * S;
  T* sQ = sV + kTile * S;
  T* sdO = sQ + kTile * S;
  T* sdS = sdO + kTile * S;
  float* sLse = reinterpret_cast<float*>(sdS + kTile * SS);
  float* sDelta = sLse + kTile;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
  const int k0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int offset = sh.sk - sh.sq;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0+8
  const size_t qbase = (size_t)bh * sh.sq;

  load_tile16<T, D>(sK, k + ((size_t)bh * sh.sk + k0) * D);
  load_tile16<T, D>(sV, v + ((size_t)bh * sh.sk + k0) * D);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[n][e] = 0.f;
      dv_acc[n][e] = 0.f;
    }

  const int nqb = sh.sq / kTile;
  for (int qb = first_q_tile(sh, k0); qb < nqb; ++qb) {
    const int q0 = qb * kTile;
    __syncthreads();  // readers of the previous q tile are done
    load_tile16<T, D>(sQ, q + (qbase + q0) * D);
    load_tile16<T, D>(sdO, dout + (qbase + q0) * D);
    if (threadIdx.x < kTile) {
      sLse[threadIdx.x] = lse[qbase + q0 + threadIdx.x];
      if (!kFused) sDelta[threadIdx.x] = delta[qbase + q0 + threadIdx.x];
    }
    __syncthreads();
    if (kFused) {
      // delta = rowsum(dO * O): two threads per row
      const int row = threadIdx.x >> 1;
      const T* orow = o + (qbase + q0 + row) * D;
      float sum = 0.f;
      for (int d = threadIdx.x & 1; d < D; d += 2)
        sum = fmaf(to_f32(sdO[row * S + d]), to_f32(orow[d]), sum);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if ((threadIdx.x & 1) == 0) sDelta[row] = sum;
      __syncthreads();
    }

    // S^T and dP^T: this warp's 16 keys x the tile's 64 queries
    float st[8][4], dpt[8][4];
    rows_times_tile_t<T, D>(st, sK, warp * 16, sQ, lane);
    rows_times_tile_t<T, D>(dpt, sV, warp * 16, sdO, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 8 * (e >> 1);
        const int c = j * 8 + t2 + (e & 1);  // query within the tile
        float sv = st[j][e];
        if (sh.causal && q0 + c + offset < key) sv = kNegInf;
        const float p = expf(sv - sLse[c]);
        float dp = dpt[j][e];
        float pd = p;
        if (dr.on) {
          const float keep =
              keep_scale(dr.seed, bh, q0 + c, key, dr.threshold, dr.scale);
          pd = p * keep;
          dp = dp * keep;
        }
        st[j][e] = pd;
        dpt[j][e] = p * (dp - sDelta[c]);
      }
    uint32_t pa[4][4], sa[4][4];
    acc_to_a<T>(pa, st);
    acc_to_a<T>(sa, dpt);
    // dV += Pd^T dO, dK += dS^T q (q pre-scaled, so dK is exact)
    tile_times_kmajor<T, D>(dv_acc, pa, sdO, lane);
    tile_times_kmajor<T, D>(dk_acc, sa, sQ, lane);
    if (kFused) {
      // dS to shared memory as dS[q][key], rounded as in sa
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sdS[(j * 8 + t2 + (e & 1)) * SS + warp * 16 + g + 8 * (e >> 1)] =
              from_f32<T>(dpt[j][e]);
      __syncthreads();
      // dQ rows are this warp's 16 queries: dQ += dS K, unscaled
      float dq[D / 8][4];
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
      uint32_t da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        frag_a(da[kk], sdS, SS, warp * 16, kk * 16, lane);
      tile_times_kmajor<T, D>(dq, da, sK, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float* drow = dq_acc + (qbase + q0 + warp * 16 + g + 8 * r) * D;
        // the two neighbouring columns of an accumulator pair in one
        // 8-byte atomic (sm_90): on an H100 at the BERT-Large shape it
        // takes 14 % off the kernel against scalar adds, where a 16-byte
        // atomic after a lane shuffle was slower
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          atomicAdd(reinterpret_cast<float2*>(drow + n * 8 + t2),
                    make_float2(dq[n][2 * r], dq[n][2 * r + 1]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t row = (size_t)bh * sh.sk + key0 + 8 * r;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + row * D + n * 8 + t2) =
          Mma<T>::pack(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + row * D + n * 8 + t2) =
          Mma<T>::pack(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

// backward over q tiles (dQ) on the tensor cores: B4
template <typename T, int D>
__global__ void __launch_bounds__(kThreadsTC)
    flash_bwd_q_tc(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq,
                   float sm_scale, Shape sh, Dropout dr) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  constexpr int S = D + 8;
  T* sQ = reinterpret_cast<T*>(smem_tc);
  T* sdO = sQ + kTile * S;
  T* sK = sdO + kTile * S;
  T* sV = sK + kTile * S;
  float* sLse = reinterpret_cast<float*>(sV + kTile * S);
  float* sDelta = sLse + kTile;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int offset = sh.sk - sh.sq;
  const int lrow = warp * 16 + g;  // this thread's rows in the tile: +0, +8
  const size_t qbase = (size_t)bh * sh.sq;
  const T* kb_base = k + (size_t)bh * sh.sk * D;
  const T* vb_base = v + (size_t)bh * sh.sk * D;

  load_tile16<T, D>(sQ, q + (qbase + q0) * D);
  load_tile16<T, D>(sdO, dout + (qbase + q0) * D);
  if (threadIdx.x < kTile) {
    sLse[threadIdx.x] = lse[qbase + q0 + threadIdx.x];
    sDelta[threadIdx.x] = delta[qbase + q0 + threadIdx.x];
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int nkb = k_tiles_for(sh, q0);
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * kTile;
    __syncthreads();
    load_tile16<T, D>(sK, kb_base + (size_t)k0 * D);
    load_tile16<T, D>(sV, vb_base + (size_t)k0 * D);
    __syncthreads();
    float s[8][4], dp[8][4];
    rows_times_tile_t<T, D>(s, sQ, warp * 16, sK, lane);
    rows_times_tile_t<T, D>(dp, sdO, warp * 16, sV, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = lrow + 8 * (e >> 1);
        const int key = k0 + j * 8 + t2 + (e & 1);
        float sv = s[j][e];
        if (sh.causal && q0 + r + offset < key) sv = kNegInf;
        const float p = expf(sv - sLse[r]);
        float dpv = dp[j][e];
        if (dr.on)
          dpv *= keep_scale(dr.seed, bh, q0 + r, key, dr.threshold, dr.scale);
        s[j][e] = p * (dpv - sDelta[r]);
      }
    uint32_t sa[4][4];
    acc_to_a<T>(sa, s);
    tile_times_kmajor<T, D>(acc, sa, sK, lane);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    T* drow = dq + (qbase + q0 + lrow + 8 * r) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(drow + n * 8 + t2) = Mma<T>::pack(
          acc[n][2 * r] * sm_scale, acc[n][2 * r + 1] * sm_scale);
  }
}

template <int D>
constexpr size_t tc_tile_bytes() {
  return sizeof(uint16_t) * kTile * (D + 8);
}

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * kTile * (D + 1) + kTile * kSP);
}
template <int D>
constexpr size_t bwd_kv_smem() {
  return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * kSP + 2 * kTile);
}
template <int D>
constexpr size_t bwd_q_smem() {
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * kSP + 2 * kTile);
}

// Shared memory above 48 KB must be opted into for each kernel. The
// callers keep the result in a function-local static, so the attribute is
// set at the first launch only (never inside a CUDA-graph capture that
// follows a warm-up launch).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// fp32 takes the SIMT kernels, bf16 and fp16 the tensor-core ones (only
// the chosen one is instantiated for each dtype)
template <typename T>
constexpr bool kSimt = std::is_same<T, float>::value;

template <typename T, int D>
auto fwd_kernel() {
  if constexpr (kSimt<T>) {
    return flash_fwd_kernel<T, D>;
  } else {
    return flash_fwd_tc<T, D>;
  }
}

template <typename T, int D, bool kFused>
auto bwd_kv_kernel() {
  if constexpr (kSimt<T>) {
    return flash_bwd_kv_kernel<T, D, kFused>;
  } else {
    return flash_bwd_kv_tc<T, D, kFused>;
  }
}

template <typename T, int D>
auto bwd_q_kernel() {
  if constexpr (kSimt<T>) {
    return flash_bwd_q_kernel<T, D>;
  } else {
    return flash_bwd_q_tc<T, D>;
  }
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int bh, Shape sh, Dropout dr, cudaStream_t st) {
  auto kernel = fwd_kernel<T, D>();
  const size_t smem = kSimt<T> ? fwd_smem<D>() : 3 * tc_tile_bytes<D>();
  static const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(sh.sq / kTile, bh), kSimt<T> ? kThreads : kThreadsTC, smem,
           st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                 static_cast<const T*>(v), static_cast<T*>(o), lse, sh, dr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool kFused>
int launch_bwd_kv_one(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      const float* delta, void* dk, void* dv, float* dq_acc,
                      int bh, Shape sh, Dropout dr, cudaStream_t st) {
  auto kernel = bwd_kv_kernel<T, D, kFused>();
  const size_t smem =
      kSimt<T> ? bwd_kv_smem<D>()
               : 4 * tc_tile_bytes<D>() + sizeof(uint16_t) * kTile *
                     (kTile + 8) + 2 * kTile * sizeof(float);
  static const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(sh.sk / kTile, bh), kSimt<T> ? kThreads : kThreadsTC, smem,
           st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                 static_cast<const T*>(v), static_cast<const T*>(o),
                 static_cast<const T*>(dout), lse, delta,
                 static_cast<T*>(dk), static_cast<T*>(dv), dq_acc, sh, dr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_bwd_kv(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const float* lse, const float* delta,
                  void* dk, void* dv, float* dq_acc, int fused, int bh,
                  Shape sh, Dropout dr, cudaStream_t st) {
  if (fused)
    return launch_bwd_kv_one<T, D, true>(q, k, v, o, dout, lse, delta, dk,
                                         dv, dq_acc, bh, sh, dr, st);
  return launch_bwd_kv_one<T, D, false>(q, k, v, o, dout, lse, delta, dk,
                                        dv, dq_acc, bh, sh, dr, st);
}

template <typename T, int D>
int launch_bwd_q(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, float sm_scale, int bh, Shape sh, Dropout dr,
                 cudaStream_t st) {
  auto kernel = bwd_q_kernel<T, D>();
  const size_t smem = kSimt<T> ? bwd_q_smem<D>()
                               : 4 * tc_tile_bytes<D>() +
                                     2 * kTile * sizeof(float);
  static const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(sh.sq / kTile, bh), kSimt<T> ? kThreads : kThreadsTC, smem,
           st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                 static_cast<const T*>(v), static_cast<const T*>(dout), lse,
                 delta, static_cast<T*>(dq), sm_scale, sh, dr);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int bh, int sq, int sk, int d, int dtype) {
  return bh >= 1 && bh <= 65535 && sq >= kTile && sk >= kTile &&
         sq % kTile == 0 && sk % kTile == 0 && (d == 64 || d == 128) &&
         dtype >= 0 && dtype <= 2;
}

Dropout make_dropout(int on, uint32_t seed, uint32_t threshold,
                     float scale) {
  Dropout dr;
  dr.on = on;
  dr.seed = seed;
  dr.threshold = threshold;
  dr.scale = scale;
  return dr;
}

// Returns LAUNCH<T, D>(args...) for the runtime dtype code and head dim.
#define FF_DISPATCH(LAUNCH, ...)                                      \
  switch (dtype * 2 + (d == 128)) {                                   \
    case 0: return LAUNCH<float, 64>(__VA_ARGS__);                    \
    case 1: return LAUNCH<float, 128>(__VA_ARGS__);                   \
    case 2: return LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__);            \
    case 3: return LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__);           \
    case 4: return LAUNCH<__half, 64>(__VA_ARGS__);                   \
    case 5: return LAUNCH<__half, 128>(__VA_ARGS__);                  \
    default: return static_cast<int>(cudaErrorInvalidValue);          \
  }

}  // namespace

// The C interface. Tensors are contiguous (bh, seq, d) in one dtype
// (0 = float32, 1 = bfloat16, 2 = float16) except lse, delta and dq_acc,
// which are float32; q is pre-scaled by 1/sqrt(d). Each returns a
// cudaError_t code (0 on success); launches are asynchronous on `stream`.
extern "C" int ff_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int bh, int sq, int sk,
                            int d, int causal, int dropout_on, uint32_t seed,
                            uint32_t threshold, float keep_scale_value,
                            int dtype, void* stream) {
  if (!valid(bh, sq, sk, d, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{sq, sk, causal};
  const Dropout dr = make_dropout(dropout_on, seed, threshold,
                                  keep_scale_value);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FF_DISPATCH(launch_fwd, q, k, v, o, static_cast<float*>(lse), bh, sh, dr,
              st)
}

extern "C" int ff_flash_bwd_kv(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const void* lse, const void* delta, void* dk,
                               void* dv, void* dq_acc, int fused, int bh,
                               int sq, int sk, int d, int causal,
                               int dropout_on, uint32_t seed,
                               uint32_t threshold, float keep_scale_value,
                               int dtype, void* stream) {
  if (!valid(bh, sq, sk, d, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{sq, sk, causal};
  const Dropout dr = make_dropout(dropout_on, seed, threshold,
                                  keep_scale_value);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FF_DISPATCH(launch_bwd_kv, q, k, v, o, dout,
              static_cast<const float*>(lse),
              static_cast<const float*>(delta), dk, dv,
              static_cast<float*>(dq_acc), fused, bh, sh, dr, st)
}

extern "C" int ff_flash_bwd_q(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dq, float sm_scale,
                              int bh, int sq, int sk, int d, int causal,
                              int dropout_on, uint32_t seed,
                              uint32_t threshold, float keep_scale_value,
                              int dtype, void* stream) {
  if (!valid(bh, sq, sk, d, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{sq, sk, causal};
  const Dropout dr = make_dropout(dropout_on, seed, threshold,
                                  keep_scale_value);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FF_DISPATCH(launch_bwd_q, q, k, v, dout, static_cast<const float*>(lse),
              static_cast<const float*>(delta), dq, sm_scale, bh, sh, dr, st)
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

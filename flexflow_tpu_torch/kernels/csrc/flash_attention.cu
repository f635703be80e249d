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
// of ~295 bf16 flops per byte. So every 16-bit kernel (B1, B2, B3, B4)
// is built for Hopper's tensor cores (the section "Hopper path" below):
//   * every product is a wgmma (64-row warpgroup tiles, operands read from
//     shared memory through descriptors, P and dS as register operands);
//   * tiles arrive by TMA into a ring of stages guarded by mbarriers, each
//     load issued by one thread stages ahead of its use, so loads overlap
//     the products;
//   * B1: one CTA per (batch*head, 64 q rows), looping over 128-key tiles
//     up to the causal band, the softmax of one tile overlapping the P v
//     product of the one before; B2: one CTA per (batch*head, 128 keys)
//     with k and v resident, streaming 64-row q, dO and O tiles (and lse)
//     through the ring; its two warpgroups (64 keys each) work on their
//     own, each computing delta = rowsum(dO * O) from the tiles TMA brought
//     while its first products run. No CTA owns a dQ row (the TPU carried
//     dQ across its sequential grid), so each warpgroup stages its (q tile,
//     64 keys) partial in fp32 in shared memory and adds it into the zeroed
//     (b*h, seq_q, d) fp32 buffer with one bulk asynchronous reduce-add
//     (cp.reduce.async.bulk), in place of per-thread atomics;
//   * B3 is B2's body without delta and dQ (delta arrives beside lse), its
//     freed shared memory spent on a 4-stage ring; B4 is B1's skeleton
//     (one warpgroup of 64 q rows, q, dO, lse and delta resident, k and v
//     tiles streamed) with S, dP and dQ += dS k on wgmma, dS of one tile
//     formed while dQ of the tile before runs. Both write their outputs
//     once, rounded: no atomics, so a launch is bitwise repeatable.
// fp32 inputs run every kernel on the CUDA cores (SIMT FMA): fp32 has no
// tensor-core rate that keeps fp32 products (TF32 would round them). There
// the bound is the issue rate of shared-memory loads beside the FMAs: an
// SM serves about one shared-memory wavefront a clock against four
// warp-wide FFMAs. The fp32 forward (B1, flash_fwd_f32), fused backward
// (B2, flash_bwd_fused_f32) and two-pass backward (B3 dK/dV, B4 dQ; the
// section "fp32 SIMT kernels" below) are built for that:
//   * every operand load is a 128-bit LDS from tiles padded by 4 floats a
//     row, read without bank conflicts, and a lane's register block is
//     8 x 8 (8 x 4 for the d 128 score tile), so each load feeds 16 FFMAs
//     (4 for each quarter warp's wavefront; a 4 x 4 block of 32-bit loads
//     feeds 2); P = 2^(s log2 e - m log2 e) (B1) or 2^(s log2 e - lse
//     log2 e) (B2, B3, B4) on the special-function unit (ex2.approx, as in
//     the 16-bit kernels); lse stays in natural log;
//   * to hold 8 x 8 blocks in 255 registers a CTA's 8 warps form two
//     groups. In B1 each group takes every other k tile with its own
//     online softmax, merged at the end, and a warp owns whole q rows, so
//     a row's max and sum never leave it; in B2, B3 and B4 the groups split
//     each tile's products (B2 and B3: S^T, dV and dP^T, dK; B4: S and dP,
//     then half the keys of dQ each), and the two warps of a pair hand raw
//     S and dP over through shared memory under a named barrier and finish
//     P and dS for half of the rows each;
//   * B2 is B3 plus the two things that make it fused: delta = rowsum(dO *
//     O) of each q tile, computed by the CTA from global memory (16-byte
//     loads of two L2-resident tiles) one tile ahead, and dQ = dS k over
//     the CTA's keys, a fifth product split by columns between the groups
//     (4 x 4 or 4 x 8 lane blocks read as one broadcast dS^T float4 and
//     one or two k float4s a key) once every pair's dS^T is in shared
//     memory, added into the zeroed fp32 dq_acc by 16-byte vector
//     reduce-adds (no staging buffer: the ring leaves no room for one);
//   * the streamed tiles (k, v for B1 and B4; q, dO, lse, delta for B3; q,
//     dO, lse for B2) arrive by 16-byte cp.async into a 2-stage ring (one
//     stage for B1, B2 and B3 at d 128), the next tiles' copy in flight
//     while this step's products run, one CTA barrier a step (two for B2);
//   * B1 and B4 walk their q tiles from the last, and B2 and B3 start at
//     key block 0, so the CTAs with the most tiles under the causal band
//     start first; B1 and B2 put batch * head on blockIdx.x, so the first
//     wave holds the heaviest CTAs of every head; only tiles that cross the
//     band take the mask compare.
// At seq 512 a causal B1 CTA of 128 q rows sees at most 8 k tiles; its two
// groups take them two at a time, so the chain a CTA walks is at most 4
// steps, each step's loads in flight behind the step before. A causal B2
// CTA of 128 keys walks 8, 6, 4 or 2 q tiles. In every kernel the TPU's
// sequential grid dimension becomes a loop inside the CTA. Not done yet: a
// persistent schedule and split-K for few long heads (PERF.md has the
// measured times).

#include <cuda.h>  // CUtensorMap (types only: no driver library is linked)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <chrono>
#include <type_traits>

namespace {

constexpr int kTile = 64;      // rows of a q tile and of a k tile
constexpr float kNegInf = -1e30f;

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (denormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// The seed lives in device memory (a uint32 the caller owns), so a
// captured CUDA graph reads a fresh seed on every replay; each kernel loads
// it once in its prologue (load_seed) and the tiles read `seed`.
struct Dropout {
  int on;
  uint32_t seed;
  const uint32_t* seed_ptr;
  uint32_t threshold;
  float scale;
  // a shard of a larger call (a data- or tensor-parallel rank's batch and
  // heads): this launch's heads, the whole call's heads and the global
  // batch*head index of this launch's first (batch, head)
  int heads_local;
  int heads_global;
  int bh_offset;
};

// The GLOBAL batch*head coordinate of this launch's row bh: the hash keys
// on it, so a shard draws the unsharded call's mask at its elements (b*H +
// h for an unsharded launch, where heads_local == heads_global and the
// offset is 0).
__device__ __forceinline__ uint32_t global_bh(const Dropout& dr, int bh) {
  return static_cast<uint32_t>((bh / dr.heads_local) * dr.heads_global +
                               bh % dr.heads_local + dr.bh_offset);
}

__device__ __forceinline__ void load_seed(Dropout& dr) {
  dr.seed = dr.on ? __ldg(dr.seed_ptr) : 0u;
}

struct Shape {
  int sq;
  int sk;
  int causal;
};

// first q tile that reaches key tile k0 under the causal band
// (_first_contributing_qb, flash_attention.py:159)
__device__ __forceinline__ int first_q_tile(const Shape& sh, int k0) {
  if (!sh.causal) return 0;
  return max(k0 - (sh.sk - sh.sq), 0) / kTile;
}

// ------------------- fp32 SIMT kernels: B3 (dK, dV), B4 (dQ), B1 (forward)
// A CTA keeps kRows rows of one sequence resident (keys for B3, q rows for
// B4) and streams 64-row tiles of the other through a ring of kStages
// cp.async stages. Its 8 warps form two groups of 4 that split each tile's
// work: for B3, group 0 computes S^T = k q^T and dV += Pd^T dO, group 1
// dP^T = v dO^T and dK += dS^T q; for B4, group 0 computes S = q k^T,
// group 1 dP = dO v^T, and each group adds dS k over half of the tile's
// keys into its own dQ partial (summed once at the end). Warp w of group 0
// and warp w of group 1 own the same kWarpRows rows and finish P, dS (and
// B3's Pd) for half of them each, handing raw S and dP over through shared
// memory under a named barrier of the pair (dkv_hand_over, dq_hand_over).
// A lane holds an 8-row block of its warp's rows (rg + kRG*i),
// score columns cg + kCG*j and output columns 4*cg + 4*kCG*jj + e, so each
// 128-bit shared load feeds 16 FFMAs (8 x 8 blocks; 8 x 4 for the score
// tile at d 128). Operand fragments of a quarter warp are one broadcast
// address or 8 consecutive padded rows (stride D + 4: 4 banks apart), and
// the scalar P/dS exchange hits 32 distinct banks (score stride 72 or 80).
template <int D>
struct TwoPass {
  static constexpr int kThreads = 256;         // two groups of 4 warps
  static constexpr int kRG = D == 64 ? 4 : 2;  // row groups of a warp
  static constexpr int kCG = 32 / kRG;         // column groups of a warp
  static constexpr int kTM = 8;                // rows of a lane
  static constexpr int kTN = kTile / kCG;      // score columns of a lane
  static constexpr int kDN = D / kCG;          // output columns of a lane
  static constexpr int kWarpRows = kRG * kTM;  // 32 (d 64) or 16 (d 128)
  static constexpr int kRows = 4 * kWarpRows;  // resident rows: 128 or 64
  static constexpr int kStride = D + 4;        // padded row of a (rows, D) tile
  static constexpr int kSStride = kTile + 32 / kRG;  // padded score row
  static constexpr int kTileFloats = kTile * kStride;
  // B3 at d 128 holds one stage: two would pass the 227 KB of a block
  static constexpr int kDkvStages = D == 64 ? 2 : 1;
};

// 16 bytes from global to shared memory without passing through registers
// (cp.async, L1 bypassed); with `valid` false the 16 bytes are zero-filled
// and nothing is read
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile(
      "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
          static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
      "l"(src), "r"(valid ? 16 : 0)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// named barrier `id` over `threads` threads: arrive and wait
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// rows [0, kRowsT) of a (rows, D) fp32 tile at `src` into shared memory
// with row stride D + 4, as 16-byte asynchronous copies by 256 threads;
// rows from `valid` on are zero-filled
template <int D, int kRowsT>
__device__ __forceinline__ void copy_rows_async(float* dst, const float* src,
                                                int valid) {
  constexpr int kChunks = D / 4;
  static_assert(kRowsT * kChunks % 256 == 0, "whole rounds of 256 threads");
#pragma unroll
  for (int n = 0; n < kRowsT * kChunks / 256; ++n) {
    const int i = threadIdx.x + n * 256;
    const int r = i / kChunks;
    const int c = (i % kChunks) * 4;
    const bool ok = r < valid;
    cp_async16(dst + r * (D + 4) + c, ok ? src + (size_t)r * D + c : src, ok);
  }
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float float4_at(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// acc[i][j] = sum_d A[rg + kRG*i][d] * B[cg + kCG*j][d], d in order, over
// two tiles of row stride D + 4 (A: the warp's resident rows; B: a
// streamed tile)
template <int D>
__device__ __forceinline__ void nt_tile(const float* A, const float* B,
                                        int rg, int cg,
                                        float (&acc)[8][TwoPass<D>::kTN]) {
  using C = TwoPass<D>;
#pragma unroll
  for (int i = 0; i < C::kTM; ++i)
#pragma unroll
    for (int j = 0; j < C::kTN; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[C::kTM], b[C::kTN];
#pragma unroll
    for (int i = 0; i < C::kTM; ++i)
      a[i] = lds4(A + (rg + C::kRG * i) * C::kStride + d);
#pragma unroll
    for (int j = 0; j < C::kTN; ++j)
      b[j] = lds4(B + (cg + C::kCG * j) * C::kStride + d);
#pragma unroll
    for (int i = 0; i < C::kTM; ++i)
#pragma unroll
      for (int j = 0; j < C::kTN; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// acc[i][n] += sum_c X[rg + kRG*i][c] * M[c][n], c in order over kDepth
// columns of a warp's score rows X (row stride kXStride) and rows of a
// (64, D) tile M (row stride D + 4), for this lane's output columns
// n = 4*cg + 4*kCG*jj + e
template <int D, int kDepth, int kXStride = TwoPass<D>::kSStride>
__device__ __forceinline__ void nn_tile(const float* X, const float* M,
                                        int rg, int cg,
                                        float (&acc)[8][TwoPass<D>::kDN]) {
  using C = TwoPass<D>;
#pragma unroll 2
  for (int c = 0; c < kDepth; c += 4) {
    float4 x[C::kTM];
#pragma unroll
    for (int i = 0; i < C::kTM; ++i)
      x[i] = lds4(X + (rg + C::kRG * i) * kXStride + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float4 m[C::kDN / 4];
#pragma unroll
      for (int jj = 0; jj < C::kDN / 4; ++jj)
        m[jj] = lds4(M + (c + e) * C::kStride + 4 * cg + 4 * C::kCG * jj);
#pragma unroll
      for (int i = 0; i < C::kTM; ++i) {
        const float xv = float4_at(x[i], e);
#pragma unroll
        for (int jj = 0; jj < C::kDN / 4; ++jj) {
          acc[i][4 * jj + 0] = fmaf(xv, m[jj].x, acc[i][4 * jj + 0]);
          acc[i][4 * jj + 1] = fmaf(xv, m[jj].y, acc[i][4 * jj + 1]);
          acc[i][4 * jj + 2] = fmaf(xv, m[jj].z, acc[i][4 * jj + 2]);
          acc[i][4 * jj + 3] = fmaf(xv, m[jj].w, acc[i][4 * jj + 3]);
        }
      }
    }
  }
}

template <int D>
__device__ __forceinline__ float& score_at(float* X, int rg, int cg, int i,
                                           int j) {
  using C = TwoPass<D>;
  return X[(rg + C::kRG * i) * C::kSStride + cg + C::kCG * j];
}

// The hand-over between the two warps of a pair, who hold the same lane
// blocks of one score tile: group 0 S (B3: S^T), group 1 dP (B3: dP^T).
// Each writes the raw half of its block that the other finishes (rows i
// in [4, 8) go from group 0, masked; rows [0, 4) from group 1), both wait
// at the pair's barrier, each finishes its own half into the shared rows
// (P = 2^(s log2 e - lse log2 e), dS = P (D dP - delta); B3 also the
// dropped P^T), and both wait again before the products that read them.
// kMask: the tile crosses the causal band (only group 0 masks).

// B3: columns are queries q0 + cg + kCG*j (lse and delta from the stage),
// rows keys key0 + kRG*i; xp receives dS^T, xpd the dropped P^T
template <int D, int kGroup, bool kMask>
__device__ __forceinline__ void dkv_hand_over(
    const float (&sc)[8][TwoPass<D>::kTN], float* xp, float* xpd,
    const float* sLse, const float* sDelta, int key0, int q0, int rg,
    int cg, int off, int bh, const Dropout& dr, int bar) {
  using C = TwoPass<D>;
  constexpr int kMine = 4 * kGroup;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int i = 4 - kMine + ii;
#pragma unroll
    for (int j = 0; j < C::kTN; ++j) {
      float v = sc[i][j];
      if (kMask && q0 + cg + C::kCG * j + off < key0 + C::kRG * i)
        v = kNegInf;
      score_at<D>(kGroup == 0 ? xp : xpd, rg, cg, i, j) = v;
    }
  }
  bar_sync(bar, 64);
#pragma unroll
  for (int j = 0; j < C::kTN; ++j) {
    const int c = cg + C::kCG * j;
    const int qpos = q0 + c;
    const float l2 = sLse[c] * kLog2e;
    const float dl = sDelta[c];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int i = kMine + ii;
      const int key = key0 + C::kRG * i;
      float& x = score_at<D>(xp, rg, cg, i, j);
      float& xd = score_at<D>(xpd, rg, cg, i, j);
      float sv = kGroup == 0 ? sc[i][j] : x;
      if (kGroup == 0 && kMask && qpos + off < key) sv = kNegInf;
      float dpv = kGroup == 0 ? xd : sc[i][j];
      const float p = ex2(fmaf(sv, kLog2e, -l2));
      float pd = p;
      if (dr.on) {
        const float keep =
            keep_scale(dr.seed, global_bh(dr, bh), qpos, key, dr.threshold,
                       dr.scale);
        pd = p * keep;
        dpv = dpv * keep;
      }
      xd = pd;
      x = p * (dpv - dl);
    }
  }
  bar_sync(bar, 64);
}

// B4: rows are queries qpos0 + kRG*i (this group's half: lse * log2 e in
// l2, delta in dl), columns keys k0 + cg + kCG*j; xp receives dS
template <int D, int kGroup, bool kMask>
__device__ __forceinline__ void dq_hand_over(
    const float (&sc)[8][TwoPass<D>::kTN], float* xp, const float (&l2)[4],
    const float (&dl)[4], int qpos0, int k0, int rg, int cg, int off,
    int bh, const Dropout& dr, int bar) {
  using C = TwoPass<D>;
  constexpr int kMine = 4 * kGroup;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int i = 4 - kMine + ii;
#pragma unroll
    for (int j = 0; j < C::kTN; ++j) {
      float v = sc[i][j];
      if (kMask && qpos0 + C::kRG * i + off < k0 + cg + C::kCG * j)
        v = kNegInf;
      score_at<D>(xp, rg, cg, i, j) = v;
    }
  }
  bar_sync(bar, 64);
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int i = kMine + ii;
    const int qpos = qpos0 + C::kRG * i;
#pragma unroll
    for (int j = 0; j < C::kTN; ++j) {
      const int key = k0 + cg + C::kCG * j;
      float& x = score_at<D>(xp, rg, cg, i, j);
      float sv = kGroup == 0 ? sc[i][j] : x;
      if (kGroup == 0 && kMask && qpos + off < key) sv = kNegInf;
      float dpv = kGroup == 0 ? x : sc[i][j];
      if (dr.on)
        dpv *= keep_scale(dr.seed, global_bh(dr, bh), qpos, key,
                          dr.threshold, dr.scale);
      x = ex2(fmaf(sv, kLog2e, -l2[ii])) * (dpv - dl[ii]);
    }
  }
  bar_sync(bar, 64);
}

// B3 and B2 in fp32: shared memory of a CTA. Resident k, v, the score
// rows P (then dS^T) and Pd^T, and its stages of q, dO, lse (B3 also
// delta); B2 keeps the delta of two q tiles beside the ring.
template <int D, bool kFused>
struct BwdKvF32 {
  using C = TwoPass<D>;
  static constexpr int kStages = C::kDkvStages;
  static constexpr int kStage = 2 * C::kTileFloats + (kFused ? 1 : 2) * kTile;
  static constexpr size_t kBytes =
      sizeof(float) * (2 * C::kRows * C::kStride + 2 * C::kRows * C::kSStride +
                       kStages * kStage + (kFused ? 2 * kTile : 0));
};

// B2: delta = rowsum(dO * O) of the 64 rows from row0 into dst[0, 64),
// read from global memory in 16-byte loads (in a training step both
// tensors are L2-resident): kChunks lanes a row, summed by shuffles
template <int D>
__device__ __forceinline__ void delta_rows(float* dst,
                                           const float* __restrict__ dout,
                                           const float* __restrict__ o,
                                           size_t row0) {
  constexpr int kChunks = D / 4;         // float4s of a row: 16 or 32
  constexpr int kPass = 256 / kChunks;   // rows a pass of 256 threads
  constexpr int kN = kTile / kPass;
  const int c = (threadIdx.x % kChunks) * 4;
  const int r = threadIdx.x / kChunks;
  float sum[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    const size_t at = (row0 + r + n * kPass) * D + c;
    const float4 a = __ldg(reinterpret_cast<const float4*>(dout + at));
    const float4 b = __ldg(reinterpret_cast<const float4*>(o + at));
    sum[n] = fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
  }
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int m = kChunks / 2; m > 0; m >>= 1)
      sum[n] += __shfl_xor_sync(0xffffffffu, sum[n], m);
    if (threadIdx.x % kChunks == 0) dst[r + n * kPass] = sum[n];
  }
}

// B2: dQ += dS k for one q tile over the CTA's first nkeys keys (dS^T in
// the score rows sP, k resident), added into `dq_rows` (the tile's rows
// of dq_acc). Group g takes the columns [g D/2, (g + 1) D/2); lane t of
// the group (0..127) holds rows 4 (t / 8) + r and columns g D/2 + 4 (t %
// 8) + 32 jj, so for each key a quarter warp reads one broadcast dS^T
// float4 and 8 consecutive k float4s. Keys are summed in order; the
// partials of a tile's key blocks meet in 16-byte vector reduce-adds in
// no fixed order, so dQ is not bitwise repeatable.
template <int D>
__device__ __forceinline__ void dq_tile(const float* sP, const float* sK,
                                        int nkeys, float* dq_rows, int group,
                                        int t) {
  using C = TwoPass<D>;
  constexpr int kJ = D / 64;  // k float4s a lane reads for a key: 1 or 2
  const int qr = 4 * (t >> 3);
  const int col = group * (D / 2) + 4 * (t & 7);
  float acc[4][4 * kJ];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int n = 0; n < 4 * kJ; ++n) acc[r][n] = 0.f;
  const float* xs = sP + qr;
  const float* ks = sK + col;
#pragma unroll 4
  for (int key = 0; key < nkeys; ++key) {
    const float4 x = lds4(xs + key * C::kSStride);
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) {
      const float4 m = lds4(ks + key * C::kStride + 32 * jj);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float xv = float4_at(x, r);
        acc[r][4 * jj + 0] = fmaf(xv, m.x, acc[r][4 * jj + 0]);
        acc[r][4 * jj + 1] = fmaf(xv, m.y, acc[r][4 * jj + 1]);
        acc[r][4 * jj + 2] = fmaf(xv, m.z, acc[r][4 * jj + 2]);
        acc[r][4 * jj + 3] = fmaf(xv, m.w, acc[r][4 * jj + 3]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj)
      atomicAdd(reinterpret_cast<float4*>(dq_rows + (qr + r) * D + col +
                                          32 * jj),
                make_float4(acc[r][4 * jj], acc[r][4 * jj + 1],
                            acc[r][4 * jj + 2], acc[r][4 * jj + 3]));
}

// B3 and B2: one CTA per (kRows keys from k0, batch*head bh), k and v
// resident, q/dO/lse (B3 also delta) tiles of 64 rows streamed from the
// first q tile inside the band. kFused (B2) adds delta in-kernel and dQ.
template <int D, bool kFused>
__device__ __forceinline__ void bwd_kv_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ o,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, float* __restrict__ dq_acc, int k0, int bh,
    Shape sh, Dropout dr) {
  using C = TwoPass<D>;
  using L = BwdKvF32<D, kFused>;
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(16) float smem_f32[];
  float* sK = smem_f32;
  float* sV = sK + C::kRows * C::kStride;
  float* sP = sV + C::kRows * C::kStride;     // S^T / dS^T rows
  float* sPd = sP + C::kRows * C::kSStride;   // dP^T / dropped P^T rows
  float* ring = sPd + C::kRows * C::kSStride;
  float* sDel = ring + kStages * L::kStage;   // B2: delta of two q tiles

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = warp >> 2;  // 0: S^T, P, dV; 1: dP^T, dS^T, dK
  const int wr = (warp & 3) * C::kWarpRows;  // the warp's rows in the CTA
  const int rg = lane / C::kCG;
  const int cg = lane % C::kCG;
  const int off = sh.sk - sh.sq;
  const int kw = k0 + wr;  // the warp's first key
  const size_t qbase = (size_t)bh * sh.sq;
  const size_t kbase = (size_t)bh * sh.sk + k0;

  // rows past seq_k read as zeros and are never written
  copy_rows_async<D, C::kRows>(sK, k + kbase * D, sh.sk - k0);
  copy_rows_async<D, C::kRows>(sV, v + kbase * D, sh.sk - k0);
  auto load_stage = [&](int qb, int s) {
    float* st = ring + s * L::kStage;
    const size_t row0 = qbase + (size_t)qb * kTile;
    copy_rows_async<D, kTile>(st, q + row0 * D, kTile);
    copy_rows_async<D, kTile>(st + C::kTileFloats, dout + row0 * D, kTile);
    if (threadIdx.x < (kFused ? 16 : 32)) {
      const int lo = threadIdx.x < 16;
      const int part4 = 4 * (threadIdx.x & 15);
      cp_async16(st + 2 * C::kTileFloats + (lo ? 0 : kTile) + part4,
                 (lo ? lse : delta) + row0 + part4, true);
    }
    cp_async_commit();
  };

  float acc[8][C::kDN];  // dV rows (group 0) or dK rows (group 1)
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int n = 0; n < C::kDN; ++n) acc[i][n] = 0.f;

  const int nqb = sh.sq / kTile;
  const int qb0 = first_q_tile(sh, k0);
  float* xp = sP + wr * C::kSStride;
  float* xpd = sPd + wr * C::kSStride;
  const float* nt_rows = (group ? sV : sK) + wr * C::kStride;
  load_stage(qb0, 0);  // the resident k and v join this group of copies
  if constexpr (kFused)
    delta_rows<D>(sDel, dout, o, qbase + (size_t)qb0 * kTile);
  for (int qb = qb0; qb < nqb; ++qb) {
    const int s = kStages == 2 ? (qb - qb0) & 1 : 0;
    // tile qb has landed for every thread, and every thread is done with
    // the tile before it, whose stage the next copy refills
    cp_async_wait_all();
    __syncthreads();
    if (kStages == 2 && qb + 1 < nqb) load_stage(qb + 1, s ^ 1);
    const int q0 = qb * kTile;
    const float* sQ = ring + s * L::kStage;
    const float* sdO = sQ + C::kTileFloats;
    const float* sLse = sdO + C::kTileFloats;
    const float* sDelta =
        kFused ? sDel + ((qb - qb0) & 1) * kTile : sLse + kTile;
    // the pair adds nothing when its keys lie past the band of every query
    // of the tile, or past seq_k
    if (!((sh.causal && q0 + kTile - 1 + off < kw) || kw >= sh.sk)) {
      float sc[8][C::kTN];  // S^T (group 0) or dP^T (group 1)
      nt_tile<D>(nt_rows, group ? sdO : sQ, rg, cg, sc);
      const bool mask = sh.causal && q0 + off < kw + C::kWarpRows - 1;
      const int bar = 1 + (warp & 3);
      if (group == 0) {
        if (mask)
          dkv_hand_over<D, 0, true>(sc, xp, xpd, sLse, sDelta, kw + rg, q0,
                                    rg, cg, off, bh, dr, bar);
        else
          dkv_hand_over<D, 0, false>(sc, xp, xpd, sLse, sDelta, kw + rg, q0,
                                     rg, cg, off, bh, dr, bar);
        nn_tile<D, kTile>(xpd, sdO, rg, cg, acc);  // dV += Pd^T dO
      } else {
        dkv_hand_over<D, 1, false>(sc, xp, xpd, sLse, sDelta, kw + rg, q0,
                                   rg, cg, off, bh, dr, bar);
        // dK += dS^T q (q pre-scaled, so dK is exact)
        nn_tile<D, kTile>(xp, sQ, rg, cg, acc);
      }
    }
    if constexpr (kFused) {
      __syncthreads();  // the dS^T rows of every live pair are written
      // the live pairs are the first ones: keys up to the band of the
      // tile's last query and below seq_k (keys past the band in a live
      // pair have dS 0; rows past seq_k are zero k rows)
      int last = sh.sk - 1 - k0;
      if (sh.causal) last = min(last, q0 + kTile - 1 + off - k0);
      const int nkeys =
          min(C::kRows, (last / C::kWarpRows + 1) * C::kWarpRows);
      dq_tile<D>(sP, sK, nkeys, dq_acc + (qbase + q0) * D, group,
                 threadIdx.x & 127);
      // the next tile's delta, into the slot the tile before this one
      // read (every reader passed this step's first barrier)
      if (qb + 1 < nqb)
        delta_rows<D>(sDel + ((qb + 1 - qb0) & 1) * kTile, dout, o,
                      qbase + (size_t)(qb + 1) * kTile);
    }
    if (kStages == 1 && qb + 1 < nqb) {
      __syncthreads();  // every reader is done with the one stage
      load_stage(qb + 1, 0);
    }
  }

  float* out = group ? dk : dv;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int key = kw + rg + C::kRG * i;
    if (key >= sh.sk) continue;
    float* row = out + ((size_t)bh * sh.sk + key) * D;
#pragma unroll
    for (int jj = 0; jj < C::kDN / 4; ++jj)
      *reinterpret_cast<float4*>(row + 4 * cg + 4 * C::kCG * jj) =
          make_float4(acc[i][4 * jj], acc[i][4 * jj + 1],
                      acc[i][4 * jj + 2], acc[i][4 * jj + 3]);
  }
}

// B3: grid (key block, batch*head); key block 0 (the most q tiles under
// the causal band) is blockIdx.x 0, so the heaviest CTAs start first.
template <int D>
__global__ void __launch_bounds__(TwoPass<D>::kThreads, 1)
    flash_bwd_dkv_f32(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv,
                      Shape sh, Dropout dr) {
  load_seed(dr);
  bwd_kv_f32<D, false>(q, k, v, nullptr, dout, lse, delta, dk, dv, nullptr,
                       blockIdx.x * TwoPass<D>::kRows, blockIdx.y, sh, dr);
}

// B2: grid (batch*head, key block), so key block 0 of every head is in
// the first wave; delta from dO and O, dQ added into the zeroed dq_acc
// (unscaled: the caller scales by 1/sqrt(d))
template <int D>
__global__ void __launch_bounds__(TwoPass<D>::kThreads, 1)
    flash_bwd_fused_f32(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ o,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        float* __restrict__ dk, float* __restrict__ dv,
                        float* __restrict__ dq_acc, Shape sh, Dropout dr) {
  load_seed(dr);
  bwd_kv_f32<D, true>(q, k, v, o, dout, lse, nullptr, dk, dv, dq_acc,
                      blockIdx.y * TwoPass<D>::kRows, blockIdx.x, sh, dr);
}

// B4: one CTA per (kRows q rows, batch*head), q and dO resident, k/v tiles
// of 64 keys streamed up to the causal band. blockIdx.x 0 takes the LAST q
// tile (the most k tiles under the band), so the heaviest CTAs start first.
template <int D>
__global__ void __launch_bounds__(TwoPass<D>::kThreads, 1)
    flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq,
                     float sm_scale, Shape sh, Dropout dr) {
  load_seed(dr);
  using C = TwoPass<D>;
  constexpr int kStage = 2 * C::kTileFloats;  // k, v
  extern __shared__ __align__(16) float smem_f32[];
  float* sQ = smem_f32;
  float* sdO = sQ + C::kRows * C::kStride;
  float* sP = sdO + C::kRows * C::kStride;  // P, then dS
  float* ring = sP + C::kRows * C::kSStride;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = warp >> 2;  // 0: S, P; 1: dP, dS
  const int wr = (warp & 3) * C::kWarpRows;
  const int rg = lane / C::kCG;
  const int cg = lane % C::kCG;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::kRows;
  const int bh = blockIdx.y;
  const int off = sh.sk - sh.sq;
  const int qw = q0 + wr;  // the warp's first q row
  const size_t qbase = (size_t)bh * sh.sq;
  const size_t kbase = (size_t)bh * sh.sk;
  const int valid = min(C::kRows, sh.sq - q0);

  // rows past seq_q read as zeros and are never written
  copy_rows_async<D, C::kRows>(sQ, q + (qbase + q0) * D, valid);
  copy_rows_async<D, C::kRows>(sdO, dout + (qbase + q0) * D, valid);
  auto load_stage = [&](int kb, int s) {
    float* st = ring + s * kStage;
    const size_t row0 = kbase + (size_t)kb * kTile;
    copy_rows_async<D, kTile>(st, k + row0 * D, kTile);
    copy_rows_async<D, kTile>(st + C::kTileFloats, v + row0 * D, kTile);
    cp_async_commit();
  };

  // lse * log2(e) and delta of the half of the lane's rows this group
  // finishes (rows 4 * group + ii); rows past seq_q read 0
  float l2[4], dl[4], acc[8][C::kDN];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int row = qw + rg + C::kRG * (4 * group + ii);
    l2[ii] = row < sh.sq ? lse[qbase + row] * kLog2e : 0.f;
    dl[ii] = row < sh.sq ? delta[qbase + row] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int n = 0; n < C::kDN; ++n) acc[i][n] = 0.f;

  // k tiles up to the band of the CTA's last valid row
  const int nkb = sh.causal ? min(sh.sk / kTile,
                                  (q0 + valid - 1 + off) / kTile + 1)
                            : sh.sk / kTile;
  float* xp = sP + wr * C::kSStride;
  const float* nt_rows = (group ? sdO : sQ) + wr * C::kStride;
  load_stage(0, 0);  // the resident q and dO join this group of copies
  for (int kb = 0, s = 0; kb < nkb; ++kb, s ^= 1) {
    cp_async_wait_all();
    __syncthreads();
    if (kb + 1 < nkb) load_stage(kb + 1, s ^ 1);
    const int k0 = kb * kTile;
    const float* sK = ring + s * kStage;
    float sc[8][C::kTN];  // S (group 0) or dP (group 1)
    nt_tile<D>(nt_rows, sK + (group ? C::kTileFloats : 0), rg, cg, sc);
    const bool mask = sh.causal && qw + off < k0 + kTile - 1;
    const int bar = 1 + (warp & 3);
    if (group == 0) {
      if (mask)
        dq_hand_over<D, 0, true>(sc, xp, l2, dl, qw + rg, k0, rg, cg, off, bh,
                                 dr, bar);
      else
        dq_hand_over<D, 0, false>(sc, xp, l2, dl, qw + rg, k0, rg, cg, off,
                                  bh, dr, bar);
    } else {
      dq_hand_over<D, 1, false>(sc, xp, l2, dl, qw + rg, k0, rg, cg, off, bh,
                                dr, bar);
    }
    // dQ += dS k over this group's half of the tile's keys
    nn_tile<D, kTile / 2>(xp + group * (kTile / 2),
                          sK + group * (kTile / 2) * C::kStride, rg, cg, acc);
  }

  // dQ = (group 0's partial + group 1's) / sqrt(d): group 1 hands its
  // partial over through the ring, lane for lane
  constexpr int kV = 8 * C::kDN / 4;  // float4s of a lane's partial
  float4* hand = reinterpret_cast<float4*>(ring);
  __syncthreads();  // the last tile's readers are done with the ring
  if (group == 1) {
#pragma unroll
    for (int v4 = 0; v4 < kV; ++v4)
      hand[((warp & 3) * kV + v4) * 32 + lane] =
          make_float4(acc[v4 / 2][4 * (v4 & 1)], acc[v4 / 2][4 * (v4 & 1) + 1],
                      acc[v4 / 2][4 * (v4 & 1) + 2],
                      acc[v4 / 2][4 * (v4 & 1) + 3]);
  }
  __syncthreads();
  if (group == 1) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = qw + rg + C::kRG * i;
#pragma unroll
    for (int jj = 0; jj < C::kDN / 4; ++jj) {
      const float4 o = hand[((warp & 3) * kV + i * (C::kDN / 4) + jj) * 32 +
                            lane];
      if (row >= sh.sq) continue;
      *reinterpret_cast<float4*>(dq + (qbase + row) * D + 4 * cg +
                                 4 * C::kCG * jj) =
          make_float4((acc[i][4 * jj] + o.x) * sm_scale,
                      (acc[i][4 * jj + 1] + o.y) * sm_scale,
                      (acc[i][4 * jj + 2] + o.z) * sm_scale,
                      (acc[i][4 * jj + 3] + o.w) * sm_scale);
    }
  }
}

// B1 in fp32: one CTA per (kRows q rows, batch*head), q resident, k/v
// tiles of 64 keys streamed up to the causal band. The CTA's two groups of
// 4 warps take alternate k tiles (group 0 the even ones, group 1 the odd
// ones) and keep their own online softmax over them, merged once at the
// end: warp w of each group owns the same kWarpRows q rows, whole, so a
// row's max and sum never leave its warp. A stage of the ring holds the
// pair of tiles of one step (2 stages; 1 at d 128, where two would pass
// the 227 KB of a block). S = q k^T is nt_tile (8 x 8 lane blocks, 8 x 4 at
// d 128); P goes to the warp's own shared rows in two halves of 32 keys and
// O += P v is nn_tile over each half. P = 2^(s log2 e - m log2 e); the
// normaliser l sums the undropped P. The grid is (batch*head, q tile) with
// blockIdx.y 0 on the LAST q tile (the most k tiles under the band), so
// the heaviest CTAs of every head start first.
template <int D>
struct FwdF32 {
  using C = TwoPass<D>;
  static constexpr int kStages = D == 64 ? 2 : 1;
  static constexpr int kPStride = 32 + 32 / C::kRG;  // a half of P's row
  static constexpr int kStage = 4 * C::kTileFloats;  // k, v of two tiles
  static constexpr int kPFloats = 8 * C::kWarpRows * kPStride;
  static constexpr size_t kBytes =
      sizeof(float) * (C::kRows * C::kStride + kPFloats + kStages * kStage);
};

template <int D>
__global__ void __launch_bounds__(TwoPass<D>::kThreads, 1)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, Shape sh, Dropout dr) {
  load_seed(dr);
  using C = TwoPass<D>;
  using F = FwdF32<D>;
  extern __shared__ __align__(16) float smem_f32[];
  float* sQ = smem_f32;
  float* sP = sQ + C::kRows * C::kStride;
  float* ring = sP + F::kPFloats;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = warp >> 2;  // 0: even k tiles, 1: odd ones
  const int wr = (warp & 3) * C::kWarpRows;
  const int rg = lane / C::kCG;
  const int cg = lane % C::kCG;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::kRows;
  const int bh = blockIdx.x;
  const int off = sh.sk - sh.sq;
  const int qw = q0 + wr;  // the warp's first q row
  const size_t qbase = (size_t)bh * sh.sq;
  const size_t kbase = (size_t)bh * sh.sk;
  const int valid = min(C::kRows, sh.sq - q0);

  // k tiles up to the band of the CTA's last valid row
  const int nkb = sh.causal ? min(sh.sk / kTile,
                                  (q0 + valid - 1 + off) / kTile + 1)
                            : sh.sk / kTile;
  const int steps = (nkb + 1) / 2;
  // rows past seq_q read as zeros and are never written
  copy_rows_async<D, C::kRows>(sQ, q + (qbase + q0) * D, valid);
  auto load_stage = [&](int step, int s) {
    float* st = ring + s * F::kStage;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int kb = 2 * step + t;
      if (kb >= nkb) break;
      const size_t row0 = kbase + (size_t)kb * kTile;
      copy_rows_async<D, kTile>(st + 2 * t * C::kTileFloats, k + row0 * D,
                                kTile);
      copy_rows_async<D, kTile>(st + (2 * t + 1) * C::kTileFloats,
                                v + row0 * D, kTile);
    }
    cp_async_commit();
  };

  // m2: the running max in log2 units; l: the sum of undropped P
  float m2[8], l[8], acc[8][C::kDN];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m2[i] = kNegInf * kLog2e;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < C::kDN; ++n) acc[i][n] = 0.f;
  }

  const float* q_rows = sQ + wr * C::kStride;
  float* xp = sP + warp * C::kWarpRows * F::kPStride;
  load_stage(0, 0);  // the resident q joins this group of copies
  for (int step = 0, s = 0; step < steps; ++step) {
    // the step's tiles have landed for every thread, and every thread is
    // done with the step before, whose stage the next copy refills
    cp_async_wait_all();
    __syncthreads();
    if (F::kStages == 2 && step + 1 < steps) load_stage(step + 1, s ^ 1);
    const int kb = 2 * step + group;
    const int k0 = kb * kTile;
    // the warp adds nothing past the tiles, past seq_q, or where the tile
    // lies past the band of every row it owns
    if (kb < nkb && qw < sh.sq &&
        !(sh.causal && k0 > qw + C::kWarpRows - 1 + off)) {
      const float* sK = ring + s * F::kStage + 2 * group * C::kTileFloats;
      const float* sV = sK + C::kTileFloats;
      float sc[8][C::kTN];
      nt_tile<D>(q_rows, sK, rg, cg, sc);
      const bool mask = sh.causal && k0 + kTile - 1 > qw + off;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int qpos = qw + rg + C::kRG * i;
        float mx = kNegInf * kLog2e;
#pragma unroll
        for (int j = 0; j < C::kTN; ++j) {
          float x = sc[i][j];
          if (mask && qpos + off < k0 + cg + C::kCG * j) x = kNegInf;
          // s log2 e, rounded as m2 is, so a masked score against a
          // masked max gives 2^0 as exp(-1e30 + 1e30) does in the plain walk
          x = __fmul_rn(x, kLog2e);
          sc[i][j] = x;
          mx = fmaxf(mx, x);
        }
#pragma unroll
        for (int o = 1; o < C::kCG; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m2[i], mx);
        const float alpha = ex2(m2[i] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < C::kTN; ++j) {
          const float p = ex2(sc[i][j] - m_new);
          psum += p;
          sc[i][j] = dr.on ? p * keep_scale(dr.seed, global_bh(dr, bh), qpos,
                                            k0 + cg + C::kCG * j,
                                            dr.threshold, dr.scale)
                           : p;
        }
#pragma unroll
        for (int o = 1; o < C::kCG; o <<= 1)
          psum += __shfl_xor_sync(0xffffffffu, psum, o);
        l[i] = l[i] * alpha + psum;
        m2[i] = m_new;
#pragma unroll
        for (int n = 0; n < C::kDN; ++n) acc[i][n] *= alpha;
      }
      // O += P v, 32 keys at a time through the warp's shared rows
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < C::kTN / 2; ++jj) {
            const int j = half * (C::kTN / 2) + jj;
            xp[(rg + C::kRG * i) * F::kPStride + cg + C::kCG * j -
               32 * half] = sc[i][j];
          }
        __syncwarp();
        nn_tile<D, 32, F::kPStride>(xp, sV + 32 * half * C::kStride, rg, cg,
                                    acc);
        __syncwarp();  // the half is read before the next one overwrites it
      }
    }
    if (F::kStages == 1 && step + 1 < steps) {
      __syncthreads();  // every reader is done with the one stage
      load_stage(step + 1, 0);
    }
    if (F::kStages == 2) s ^= 1;
  }

  // merge the two groups: group 1 hands its (m2, l, acc) over through the
  // ring, lane for lane; group 0 writes O and lse
  constexpr int kV = 8 * C::kDN / 4;  // float4s of a lane's accumulator
  float4* hand = reinterpret_cast<float4*>(ring);
  float* hand_ml = ring + 4 * 4 * kV * 32;
  __syncthreads();  // the last step's readers are done with the ring
  if (group == 1) {
#pragma unroll
    for (int v4 = 0; v4 < kV; ++v4)
      hand[((warp & 3) * kV + v4) * 32 + lane] =
          make_float4(acc[v4 / (C::kDN / 4)][4 * (v4 % (C::kDN / 4))],
                      acc[v4 / (C::kDN / 4)][4 * (v4 % (C::kDN / 4)) + 1],
                      acc[v4 / (C::kDN / 4)][4 * (v4 % (C::kDN / 4)) + 2],
                      acc[v4 / (C::kDN / 4)][4 * (v4 % (C::kDN / 4)) + 3]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      hand_ml[(((warp & 3) * 8 + i) * 2) * 32 + lane] = m2[i];
      hand_ml[(((warp & 3) * 8 + i) * 2 + 1) * 32 + lane] = l[i];
    }
  }
  __syncthreads();
  if (group == 1 || qw >= sh.sq) return;
  constexpr float kLn2 = 0.6931471805599453f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = qw + rg + C::kRG * i;
    const float mb = hand_ml[(((warp & 3) * 8 + i) * 2) * 32 + lane];
    const float lb = hand_ml[(((warp & 3) * 8 + i) * 2 + 1) * 32 + lane];
    const float mx = fmaxf(m2[i], mb);
    const float wa = ex2(m2[i] - mx);
    const float wb = ex2(mb - mx);
    const float lt = l[i] * wa + lb * wb;
    const float l_safe = lt == 0.f ? 1.f : lt;
    const float ca = wa / l_safe;
    const float cb = wb / l_safe;
#pragma unroll
    for (int jj = 0; jj < C::kDN / 4; ++jj) {
      const float4 b = hand[((warp & 3) * kV + i * (C::kDN / 4) + jj) * 32 +
                            lane];
      *reinterpret_cast<float4*>(o + (qbase + row) * D + 4 * cg +
                                 4 * C::kCG * jj) =
          make_float4(acc[i][4 * jj] * ca + b.x * cb,
                      acc[i][4 * jj + 1] * ca + b.y * cb,
                      acc[i][4 * jj + 2] * ca + b.z * cb,
                      acc[i][4 * jj + 3] * ca + b.w * cb);
    }
    if (cg == 0) lse[qbase + row] = mx * kLn2 + logf(l_safe);
  }
}

// ------------------------------------------ Hopper path: B1 to B4, 16-bit
// bf16 and fp16 B1 to B4 run on wgmma with TMA tile loads. Each consumer
// warpgroup owns 64 rows (q rows for B1 and B4, keys for B2 and B3); a B1
// or B4 CTA is one warpgroup (two CTAs share an SM), a B2 or B3 CTA two.
// Thread 0 issues the TMA loads into a ring of kStages shared-memory
// stages whose arrival an mbarrier reports, and refills a stage as soon as
// every reader is done with it. There is no separate producer warpgroup: the register file is
// split among the SM's four schedulers, so with a third warpgroup every
// thread is held to 168 registers (the compiler does not raise the
// consumers' budget for setmaxnreg), and the fused backward spills there;
// with eight warps an SM a thread may hold 255. Tiles sit in shared memory
// as [rows][64] 16-bit sub-tiles in the 128-byte swizzle TMA writes (a
// d = 128 tile is two sub-tiles side by side); wgmma reads them through
// descriptors, K-major where the reduction runs along the row (q k^T,
// k q^T, v dO^T, dO v^T) and MN-major, i.e. transposed by the descriptor,
// where it runs down the columns (P v, P^T dO, dS^T q, and k, and B2's dS,
// in dS k).
// Accumulators are fp32 registers; a score tile is masked, exponentiated
// and scaled in the accumulator layout, rounded to the dtype and handed to
// the next product as its register A operand.

constexpr int kWG = 128;   // threads of a warpgroup
constexpr int kBM = 64;    // B1, B4: q rows of a CTA (one warpgroup)
constexpr int kBN = 128;   // B1: keys of a streamed tile; B2, B3: of a CTA
constexpr int kBQ = 64;    // B2, B3: q rows of a streamed tile

template <typename T>
constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;

// two fp32 values rounded to the dtype, the first in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kBf16<T>) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the 128-byte swizzle needs 1024-byte aligned tiles
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

// byte offset of element (row, col) of a [rows][64] 16-bit sub-tile in the
// 128-byte swizzle: 16-byte chunk c of row r sits at chunk c ^ (r % 8)
__device__ __forceinline__ uint32_t sw128(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// ---- mbarriers, TMA, bulk copies
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait until the phase of parity `parity` has completed; a wait that
// outlasts any tile by far (an arrival that never comes) traps, so the
// launch fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// one box of a 3-D tensor map (column, row, head) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row), "r"(head)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16) into shared memory
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// dst[i] += src[i] in fp32 for `bytes` of shared memory, one asynchronous
// bulk reduction into global memory
__device__ __forceinline__ void bulk_reduce_add(float* dst, const float* src,
                                                uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], "
      "[%1], %2;\n" ::"l"(dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// shared memory of the committed bulk reductions has been read
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// generic-proxy shared-memory writes become visible to wgmma and bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the 128 threads of warpgroup wg (named barrier 2 + wg)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(2 + wg), "n"(kWG) : "memory");
}

// ---- wgmma
// descriptor of a 128-byte-swizzled shared-memory operand: start address,
// leading and stride byte offsets (16-byte units), swizzle mode 1 (128 B)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | (1ull << 62);
}

// K-major: rows of 64 contiguous k values, 8-row groups 1024 B apart (a k
// step of 16 moves the start 32 B along the row)
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return gmma_desc(addr, 16, 1024);
}

// MN-major: one row of 64 contiguous m (or n) values per k, 8-k groups
// 1024 B apart, 64-wide column blocks `block` bytes apart (a k step of 16
// moves the start 2048 B)
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t block) {
  return gmma_desc(addr, block, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

#define FF_D8(o)                                                         \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),            \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define FF_D32 FF_D8(0), FF_D8(8), FF_D8(16), FF_D8(24)
#define FF_D64 FF_D32, FF_D8(32), FF_D8(40), FF_D8(48), FF_D8(56)
#define FF_R32 \
  "{" "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31" "}"
#define FF_R64 \
  "{" "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63" "}"

// d (64 x N fp32, N/2 a thread) = A (64 x 16) B (16 x N) + (acc ? d : 0),
// both operands in shared memory; kTA / kTB: A / B MN-major (transposed)
#define FF_SS(SHAPE, TY, R, DOPS, IA, IB, IS, ITA, ITB)                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"             \
               "wgmma.mma_async.sync.aligned." SHAPE ".f32." TY "." TY " " R \
               ", %" #IA ", %" #IB ", p, 1, 1, %" #ITA ", %" #ITB ";\n}\n"   \
               : DOPS                                                       \
               : "l"(a), "l"(b), "r"(acc), "n"(kTA), "n"(kTB))
// d += A (64 x 16) B (16 x N) with A in registers, four 32-bit pairs a
// thread
#define FF_RS(SHAPE, TY, R, DOPS, A4, IB, IS, ITB)                          \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"             \
               "wgmma.mma_async.sync.aligned." SHAPE ".f32." TY "." TY " " R \
               ", " A4 ", %" #IB ", p, 1, 1, %" #ITB ";\n}\n"                \
               : DOPS                                                       \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), \
                 "n"(kTB))

template <typename T, int kTA, int kTB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int acc) {
  if constexpr (kBf16<T>)
    FF_SS("m64n64k16", "bf16", FF_R32, FF_D32, 32, 33, 34, 35, 36);
  else
    FF_SS("m64n64k16", "f16", FF_R32, FF_D32, 32, 33, 34, 35, 36);
}
template <typename T, int kTA, int kTB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int acc) {
  if constexpr (kBf16<T>)
    FF_SS("m64n128k16", "bf16", FF_R64, FF_D64, 64, 65, 66, 67, 68);
  else
    FF_SS("m64n128k16", "f16", FF_R64, FF_D64, 64, 65, 66, 67, 68);
}
template <typename T, int kTB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kBf16<T>)
    FF_RS("m64n64k16", "bf16", FF_R32, FF_D32, "{%32, %33, %34, %35}", 36,
          37, 38);
  else
    FF_RS("m64n64k16", "f16", FF_R32, FF_D32, "{%32, %33, %34, %35}", 36,
          37, 38);
}
template <typename T, int kTB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kBf16<T>)
    FF_RS("m64n128k16", "bf16", FF_R64, FF_D64, "{%64, %65, %66, %67}", 68,
          69, 70);
  else
    FF_RS("m64n128k16", "f16", FF_R64, FF_D64, "{%64, %65, %66, %67}", 68,
          69, 70);
}

// The accumulator of a 64-row product: thread (warp w, lane l) of the
// warpgroup holds rows 16w + l/4 and 16w + l/4 + 8 at columns
// 8j + 2(l%4) + {0, 1}: element e is column 8(e/4) + 2(l%4) + (e&1) of the
// first row (e&2 == 0) or the second. Columns 16kk..16kk+15 rounded to the
// dtype are the register A operand of k step kk.
template <typename T, int N>
__device__ __forceinline__ void acc_to_a16(uint32_t (&a)[N / 16][4],
                                           const float (&d)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack2<T>(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

template <typename T>
__device__ __forceinline__ float2 to_f2(uint32_t v) {
  if constexpr (kBf16<T>)
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
  else
    return __half22float2(*reinterpret_cast<__half2*>(&v));
}

// sum of the products of eight 16-bit pairs
template <typename T>
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float s) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w};
  const uint32_t y[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = to_f2<T>(x[i]), v = to_f2<T>(y[i]);
    s = fmaf(u.x, v.x, s);
    s = fmaf(u.y, v.y, s);
  }
  return s;
}

// ---- B1: forward
// A CTA is one warpgroup owning 64 q rows; two CTAs share an SM. Shared
// memory (bytes from a 1024-aligned base): the q tile, then kStages stages
// of a k and a v tile (kBN rows each), then barriers.
template <int D>
struct FwdLayout {
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kQ = kBM * D * 2;
  static constexpr int kKV = kBN * D * 2;
  static constexpr int kStage0 = kQ;
  static constexpr int kBar = kQ + kStages * 2 * kKV;
  static constexpr int kBytes = kBar + 128 + 1024;
};

template <typename T, int D>
__global__ void __launch_bounds__(kWG, 2)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   T* __restrict__ o, float* __restrict__ lse, Shape sh,
                   Dropout dr) {
  load_seed(dr);
  using L = FwdLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + L::kStages;
  uint64_t* empty = v_full + L::kStages;  // the stage's readers are done

  const int q0 = blockIdx.x * kBM;
  const int bh = blockIdx.y;
  const int offset = sh.sk - sh.sq;
  // k tiles up to the causal band of the tile's last row
  int nkb = (sh.sk + kBN - 1) / kBN;
  if (sh.causal)
    nkb = min(nkb, (min(q0 + kBM, sh.sq) - 1 + offset) / kBN + 1);
  const int tw = threadIdx.x;
  const int lane = tw & 31;
  const int t2 = (lane & 3) * 2;
  const int row0 = q0 + (tw >> 5) * 16 + (lane >> 2);  // rows row0, row0 + 8
  const uint32_t base = smem_u32(smem);

  // thread 0 loads k and v tile kb into its stage
  auto load_kv = [&](int kb) {
    const int s = kb % L::kStages;
    unsigned char* kt = smem + L::kStage0 + s * 2 * L::kKV;
    mbar_expect_tx(k_full + s, L::kKV);
    for (int sub = 0; sub < D / 64; ++sub)
      tma_load(kt + sub * kBN * 128, &tm_k, k_full + s, sub * 64, kb * kBN,
               bh);
    mbar_expect_tx(v_full + s, L::kKV);
    for (int sub = 0; sub < D / 64; ++sub)
      tma_load(kt + L::kKV + sub * kBN * 128, &tm_v, v_full + s, sub * 64,
               kb * kBN, bh);
  };
  if (tw == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, kWG / 32);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tw == 0) {
    mbar_expect_tx(q_full, L::kQ);
    for (int sub = 0; sub < D / 64; ++sub)
      tma_load(smem + sub * kBM * 128, &tm_q, q_full, sub * 64, q0, bh);
    for (int kb = 0; kb < min(L::kStages, nkb); ++kb) load_kv(kb);
  }

  int lim[2];  // keys below lim[r] are inside row r's band
#pragma unroll
  for (int r = 0; r < 2; ++r)
    lim[r] = sh.causal ? min(row0 + 8 * r + offset + 1, sh.sk) : sh.sk;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[D / 2];
  zero(acc);
  float sc[kBN / 2];         // the score tile
  uint32_t pa[kBN / 16][4];  // P, rounded: the A operand of P v
  float alpha[2];            // rescale of acc for the tile in sc

  // S = q k^T of k tile kb into sc (issued, not waited for)
  auto issue_s = [&](int kb) {
    const int s = kb % L::kStages;
    const uint32_t kt = base + L::kStage0 + s * 2 * L::kKV;
    mbar_wait(k_full + s, (kb / L::kStages) & 1);
    hold(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<T, 0, 0>(sc, desc_k(base + (kk / 4) * kBM * 128 + (kk % 4) * 32),
                        desc_k(kt + (kk / 4) * kBN * 128 + (kk % 4) * 32),
                        kk > 0);
    wgmma_commit();
  };
  // the online softmax of the tile in sc, in place: masked (only where the
  // tile crosses the causal band or the end of seq_k), exponentiated
  // against the new running max, summed into l UNDROPPED, then dropped out
  auto softmax = [&](int k0) {
    const bool edge =
        k0 + kBN > sh.sk || (sh.causal && k0 + kBN - 1 > q0 + offset);
    if (edge) {
#pragma unroll
      for (int e = 0; e < kBN / 2; ++e)
        if (k0 + (e >> 2) * 8 + t2 + (e & 1) >= lim[(e >> 1) & 1])
          sc[e] = kNegInf;
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int e = 0; e < kBN / 2; ++e)
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
    float psum[2] = {0.f, 0.f}, mb[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = ex2((m[r] - m_new) * kLog2e);
      m[r] = m_new;
      mb[r] = m_new * kLog2e;
    }
#pragma unroll
    for (int e = 0; e < kBN / 2; ++e) {
      sc[e] = ex2(fmaf(sc[e], kLog2e, -mb[(e >> 1) & 1]));
      psum[(e >> 1) & 1] += sc[e];
    }
    if (dr.on) {
#pragma unroll
      for (int e = 0; e < kBN / 2; ++e)
        sc[e] *= keep_scale(dr.seed, global_bh(dr, bh),
                            row0 + 8 * ((e >> 1) & 1),
                            k0 + (e >> 2) * 8 + t2 + (e & 1), dr.threshold,
                            dr.scale);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      l[r] = l[r] * alpha[r] + psum[r];
    }
  };

  // O += P v of tile kb (v MN-major: the descriptor transposes it)
  auto issue_pv = [&](int kb) {
    const int s = kb % L::kStages;
    const uint32_t vt = base + L::kStage0 + s * 2 * L::kKV + L::kKV;
    mbar_wait(v_full + s, (kb / L::kStages) & 1);
    hold(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      wgmma_rs<T, 1>(acc, pa[kk], desc_mn(vt + kk * 2048, kBN * 128));
    wgmma_commit();
  };
  // stage of tile kb spent: once every warp is done with it, thread 0
  // refills it with tile kb + kStages
  auto release = [&](int kb) {
    const int s = kb % L::kStages;
    if (lane == 0) mbar_arrive(empty + s);
    if (tw == 0 && kb + L::kStages < nkb) {
      mbar_wait(empty + s, (kb / L::kStages) & 1);
      load_kv(kb + L::kStages);
    }
  };

  // Software pipeline: while P v of tile kb - 1 runs on the tensor cores,
  // the softmax of tile kb runs on the CUDA cores.
  mbar_wait(q_full, 0);
  issue_s(0);
  wgmma_wait<0>();
  hold(sc);
  softmax(0);
  acc_to_a16<T, kBN>(pa, sc);
  for (int kb = 1; kb < nkb; ++kb) {
    issue_s(kb);
    issue_pv(kb - 1);
    wgmma_wait<1>();
    hold(sc);
    softmax(kb * kBN);
    wgmma_wait<0>();
    hold(acc);
    release(kb - 1);
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] *= alpha[(e >> 1) & 1];
    acc_to_a16<T, kBN>(pa, sc);
  }
  issue_pv(nkb - 1);
  wgmma_wait<0>();
  hold(acc);
  release(nkb - 1);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    T* orow = o + ((size_t)bh * sh.sq + row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8 + t2) = pack2<T>(
          acc[4 * j + 2 * r] / l_safe, acc[4 * j + 2 * r + 1] / l_safe);
    if (t2 == 0) lse[(size_t)bh * sh.sq + row] = m[r] + logf(l_safe);
  }
}

// ---- B2 (fused backward) and B3 (dK, dV): one body, kFused
// A CTA is two warpgroups, each owning 64 of the CTA's kBN keys and working
// on its own: its dK and dV rows and, in B2, its dS^T in shared memory and
// its own dQ partial (dS of its keys times its rows of k), added into
// dq_acc by its own bulk reduce-add. The two meet only at a stage of the
// ring: the second to finish with it has thread 0 of its warpgroup refill
// it. Shared memory (bytes from a 1024-aligned base): the k and v tiles
// (kBN rows); in B2 each warpgroup's dS^T ([64 keys][kBQ]) and fp32 dQ
// partial ([kBQ][D]); kStages stages of q and dO ([kBQ][D] each; B2 also
// O), lse and (B3) delta; then B2's per-warpgroup delta, the stage
// counters and the barriers.
template <int D, bool kFused>
struct BwdLayout {
  // B2 at d = 128 fits one stage beside the resident tiles; B3 has no O
  // tile, dS^T tile or dQ partial and spends that room on four stages
  static constexpr int kStages = kFused ? (D == 64 ? 3 : 1) : 4;
  static constexpr int kKV = kBN * D * 2;
  static constexpr int kT = kBQ * D * 2;
  static constexpr int kV = kKV;
  static constexpr int kDS = 2 * kKV;             // + wg * kDSBytes
  static constexpr int kDSBytes = kFused ? 64 * kBQ * 2 : 0;
  static constexpr int kDQ = kDS + 2 * kDSBytes;  // + wg * kDQBytes
  static constexpr int kDQBytes = kFused ? kBQ * D * 4 : 0;
  static constexpr int kStage0 = kDQ + 2 * kDQBytes;
  static constexpr int kTiles = kFused ? 3 : 2;   // q, dO (B2: and O)
  static constexpr int kLse = kTiles * kT;        // B3: delta follows
  static constexpr int kStageBytes = kTiles * kT + 1024;
  static constexpr int kDelta = kStage0 + kStages * kStageBytes;
  static constexpr int kCount = kDelta + (kFused ? 2 * kBQ * 4 : 0);
  static constexpr int kBar = kCount + 64;
  static constexpr int kBytes = kBar + 128 + 1024;
};

// The CTA of keys [k0, k0 + kBN) of head bh. B3 (kFused false) takes delta
// from `delta` and never touches tm_o or dq_acc. Its dV and dK products
// are waited for in their own iteration: left running behind the next q
// tile's S^T and dP^T, they made the compiler serialize every wgmma of the
// kernel (ptxas C7515), which cost more than the overlap gave.
template <typename T, int D, bool kFused>
__device__ __forceinline__ void bwd_kv_sm90(
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    const CUtensorMap* tm_o, const CUtensorMap* tm_do,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dq_acc,
    int k0, int bh, Shape sh, Dropout dr) {
  using L = BwdLayout<D, kFused>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* q_full = kv_full + 1;           // q and lse (B3: delta) landed
  uint64_t* do_full = q_full + L::kStages;  // dO (B2: and O) landed
  // warpgroups done with each stage in its current use
  int* done = reinterpret_cast<int*>(smem + L::kCount);

  const int offset = sh.sk - sh.sq;
  // q tiles from the first that reaches key k0 under the causal band
  const int qb0 = sh.causal ? max(k0 - offset, 0) / kBQ : 0;
  const int n = sh.sq / kBQ - qb0;
  const int tc = threadIdx.x;  // 0 .. 2 kWG - 1
  const int wg = tc / kWG;
  const int tw = tc % kWG;
  const int lane = tw & 31;
  const int t2 = (lane & 3) * 2;
  const int kr = (tw >> 5) * 16 + (lane >> 2);  // rows kr, kr + 8 of the wg
  const uint32_t base = smem_u32(smem);

  // loads q tile `it` (q, lse, dO; B2 also O, B3 also delta) into its stage
  auto load_q = [&](int it) {
    const int s = it % L::kStages;
    const int q0 = (qb0 + it) * kBQ;
    const size_t row = (size_t)bh * sh.sq + q0;
    unsigned char* st = smem + L::kStage0 + s * L::kStageBytes;
    mbar_expect_tx(q_full + s, L::kT + (kFused ? 1 : 2) * kBQ * 4);
    for (int sub = 0; sub < D / 64; ++sub)
      tma_load(st + sub * kBQ * 128, tm_q, q_full + s, sub * 64, q0, bh);
    bulk_load(st + L::kLse, lse + row, kBQ * 4, q_full + s);
    if constexpr (!kFused)
      bulk_load(st + L::kLse + kBQ * 4, delta + row, kBQ * 4, q_full + s);
    mbar_expect_tx(do_full + s, (L::kTiles - 1) * L::kT);
    for (int sub = 0; sub < D / 64; ++sub) {
      tma_load(st + L::kT + sub * kBQ * 128, tm_do, do_full + s, sub * 64,
               q0, bh);
      if constexpr (kFused)
        tma_load(st + 2 * L::kT + sub * kBQ * 128, tm_o, do_full + s,
                 sub * 64, q0, bh);
    }
  };
  // thread 0 of a warpgroup whose readers are done with tile it's stage:
  // the second warpgroup to get here refills it
  auto release = [&](int it) {
    const int s = it % L::kStages;
    __threadfence_block();
    if (atomicAdd(done + s, 1) == 1) {
      done[s] = 0;
      __threadfence_block();
      if (it + L::kStages < n) load_q(it + L::kStages);
    }
  };
  if (tc == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(q_full + s, 1);
      mbar_init(do_full + s, 1);
      done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tc == 0) {
    mbar_expect_tx(kv_full, 2 * L::kKV);
    for (int sub = 0; sub < D / 64; ++sub) {
      tma_load(smem + sub * kBN * 128, tm_k, kv_full, sub * 64, k0, bh);
      tma_load(smem + L::kV + sub * kBN * 128, tm_v, kv_full, sub * 64, k0,
               bh);
    }
    for (int it = 0; it < min(L::kStages, n); ++it) load_q(it);
  }

  float dk_acc[D / 2], dv_acc[D / 2];
  zero(dk_acc);
  zero(dv_acc);
  const uint32_t k_rows = base + wg * 64 * 128;
  const uint32_t v_rows = base + L::kV + wg * 64 * 128;
  mbar_wait(kv_full, 0);

  for (int it = 0; it < n; ++it) {
    const int s = it % L::kStages;
    const uint32_t ph = (it / L::kStages) & 1;
    const int q0 = (qb0 + it) * kBQ;
    unsigned char* stp = smem + L::kStage0 + s * L::kStageBytes;
    const uint32_t st = base + L::kStage0 + s * L::kStageBytes;
    const float* s_lse = reinterpret_cast<const float*>(stp + L::kLse);

    // S^T = k q^T and dP^T = v dO^T (64 keys x kBQ queries each)
    float sT[kBQ / 2], dpT[kBQ / 2];
    mbar_wait(q_full + s, ph);
    hold(sT);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<T, 0, 0>(
          sT, desc_k(k_rows + (kk / 4) * kBN * 128 + (kk % 4) * 32),
          desc_k(st + (kk / 4) * kBQ * 128 + (kk % 4) * 32), kk > 0);
    wgmma_commit();
    mbar_wait(do_full + s, ph);
    hold(dpT);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<T, 0, 0>(
          dpT, desc_k(v_rows + (kk / 4) * kBN * 128 + (kk % 4) * 32),
          desc_k(st + L::kT + (kk / 4) * kBQ * 128 + (kk % 4) * 32), kk > 0);
    wgmma_commit();

    const float* s_dl;  // delta of the tile's rows
    if constexpr (kFused) {
      // while the products run: delta = rowsum(dO * O) of the tile's
      // rows, two threads a row over whole 16-byte chunks (sub-tile `part`
      // when D = 128)
      float* s_delta = reinterpret_cast<float*>(smem + L::kDelta) + wg * kBQ;
      const int row = tw >> 1, part = tw & 1;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const int chunk = part * (D / 16) + c;
        const int off = (chunk / 8) * kBQ * 128 + row * 128 +
                        (((chunk % 8) ^ (row & 7)) << 4);
        sum = dot8<T>(*reinterpret_cast<const uint4*>(stp + L::kT + off),
                      *reinterpret_cast<const uint4*>(stp + 2 * L::kT + off),
                      sum);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if (part == 0) s_delta[row] = sum;
      warpgroup_sync(wg);
      s_dl = s_delta;
    } else {
      s_dl = s_lse + kBQ;
    }

    // P = exp(S - lse), while dP^T is still running: 0 outside the band
    // and past seq_k, masked only where the tile crosses either
    const int kw0 = k0 + wg * 64;  // this warpgroup's first key
    const bool edge =
        kw0 + 63 >= sh.sk || (sh.causal && q0 + offset < kw0 + 63);
    float lse2[kBQ / 4], dl[kBQ / 4];  // of this thread's 16 columns
#pragma unroll
    for (int j = 0; j < kBQ / 8; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(s_lse + j * 8 + t2);
      lse2[2 * j] = v.x * kLog2e;
      lse2[2 * j + 1] = v.y * kLog2e;
    }
    wgmma_wait<1>();
    hold(sT);
#pragma unroll
    for (int e = 0; e < kBQ / 2; ++e)
      sT[e] = ex2(fmaf(sT[e], kLog2e, -lse2[(e >> 2) * 2 + (e & 1)]));
    if (edge) {
#pragma unroll
      for (int e = 0; e < kBQ / 2; ++e) {
        const int c = (e >> 2) * 8 + t2 + (e & 1);
        const int key = kw0 + kr + 8 * ((e >> 1) & 1);
        if (key >= sh.sk || (sh.causal && q0 + c + offset < key)) sT[e] = 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < kBQ / 8; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(s_dl + j * 8 + t2);
      dl[2 * j] = v.x;
      dl[2 * j + 1] = v.y;
    }
    wgmma_wait<0>();
    hold(dpT);
    // dS = P * (D * dP - delta); dV takes P * D. Elements are finished
    // kFin at a time and then rounded into the A operands (k step kk holds
    // elements 8 kk .. 8 kk + 7): at d = 128 one k step at a time, so P
    // and dS never stand whole beside both accumulators (they would
    // spill); at d = 64 all of them first, which schedules better (4 % at
    // seq 16384)
    constexpr int kFin = D == 128 ? 8 : kBQ / 2;
    uint32_t pa[kBQ / 16][4], sa[kBQ / 16][4];
#pragma unroll
    for (int e0 = 0; e0 < kBQ / 2; e0 += kFin) {
      if (dr.on) {
#pragma unroll
        for (int e = e0; e < e0 + kFin; ++e) {
          const float keep = keep_scale(
              dr.seed, global_bh(dr, bh), q0 + (e >> 2) * 8 + t2 + (e & 1),
              kw0 + kr + 8 * ((e >> 1) & 1), dr.threshold, dr.scale);
          const float p = sT[e];
          sT[e] = p * keep;
          dpT[e] = p * (dpT[e] * keep - dl[(e >> 2) * 2 + (e & 1)]);
        }
      } else {
#pragma unroll
        for (int e = e0; e < e0 + kFin; ++e)
          dpT[e] = sT[e] * (dpT[e] - dl[(e >> 2) * 2 + (e & 1)]);
      }
#pragma unroll
      for (int kk = e0 / 8; kk < (e0 + kFin) / 8; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[kk][i] = pack2<T>(sT[8 * kk + 2 * i], sT[8 * kk + 2 * i + 1]);
          sa[kk][i] = pack2<T>(dpT[8 * kk + 2 * i], dpT[8 * kk + 2 * i + 1]);
        }
    }

    // dV += Pd^T dO, dK += dS^T q (q pre-scaled, so dK is exact); dO and
    // q MN-major
    hold(dv_acc);
    hold(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
      wgmma_rs<T, 1>(dv_acc, pa[kk],
                     desc_mn(st + L::kT + kk * 2048, kBQ * 128));
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
      wgmma_rs<T, 1>(dk_acc, sa[kk], desc_mn(st + kk * 2048, kBQ * 128));
    wgmma_commit();
    if constexpr (!kFused) {
      // this warpgroup is done with the stage once dV and dK are
      wgmma_wait<0>();
      hold(dv_acc);
      hold(dk_acc);
      warpgroup_sync(wg);
      if (tw == 0) release(it);
    }

    if constexpr (kFused) {
      unsigned char* ds = smem + L::kDS + wg * L::kDSBytes;
      const uint32_t ds_tile = base + L::kDS + wg * L::kDSBytes;
      float* sdq = reinterpret_cast<float*>(smem + L::kDQ + wg * L::kDQBytes);
      // dS^T, rounded as in sa, to shared memory: the A operand of dQ
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = (2 * kk + h) * 8 + t2;
          *reinterpret_cast<uint32_t*>(ds + sw128(kr, c)) = sa[kk][2 * h];
          *reinterpret_cast<uint32_t*>(ds + sw128(kr + 8, c)) =
              sa[kk][2 * h + 1];
        }
      fence_proxy_async();
      // the previous tile's reduce has read this warpgroup's dQ partial
      if (tw == 0) bulk_wait_read();
      warpgroup_sync(wg);

      // dQ partial (kBQ x D) = dS (kBQ x 64 keys) k (64 keys x D): dS
      // MN-major from dS^T, k MN-major
      float dq[D / 2];
      hold(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 64 / 16; ++kk)
        wgmma_ss<T, 1, 1>(dq, desc_mn(ds_tile + kk * 2048, 64 * 128),
                          desc_mn(k_rows + kk * 2048, kBN * 128), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      hold(dq);
      hold(dv_acc);
      hold(dk_acc);

      // the fp32 partial to shared memory, then one bulk reduce-add into
      // dq_acc (the tile's rows are contiguous there)
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(sdq + (kr + 8 * h) * D + j * 8 + t2) =
              make_float2(dq[4 * j + 2 * h], dq[4 * j + 2 * h + 1]);
      fence_proxy_async();
      warpgroup_sync(wg);
      if (tw == 0) {
        bulk_reduce_add(dq_acc + ((size_t)bh * sh.sq + q0) * D, sdq,
                        kBQ * D * 4);
        release(it);
      }
    }
  }
  if constexpr (kFused) {
    if (tw == 0) bulk_wait_all();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + wg * 64 + kr + 8 * h;
    if (key >= sh.sk) continue;  // the ragged end of the last k tile
    const size_t row = (size_t)bh * sh.sk + key;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + row * D + j * 8 + t2) =
          pack2<T>(dk_acc[4 * j + 2 * h], dk_acc[4 * j + 2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dv + row * D + j * 8 + t2) =
          pack2<T>(dv_acc[4 * j + 2 * h], dv_acc[4 * j + 2 * h + 1]);
    }
  }
}

// B2: grid (key block, batch*head); delta from dO and O, dQ added into
// the zeroed dq_acc (unscaled: the caller scales by 1/sqrt(d))
template <typename T, int D>
__global__ void __launch_bounds__(2 * kWG, 1)
    flash_bwd_fused_sm90(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_o,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse, T* __restrict__ dk,
                         T* __restrict__ dv, float* __restrict__ dq_acc,
                         Shape sh, Dropout dr) {
  load_seed(dr);
  bwd_kv_sm90<T, D, true>(&tm_q, &tm_k, &tm_v, &tm_o, &tm_do, lse, nullptr,
                          dk, dv, dq_acc, blockIdx.x * kBN, blockIdx.y, sh,
                          dr);
}

// B3: grid (batch*head, key block), so key block 0 of every head (the most
// q tiles under the causal band) is in the first wave; delta given
template <typename T, int D>
__global__ void __launch_bounds__(2 * kWG, 1)
    flash_bwd_dkv_sm90(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dk,
                       T* __restrict__ dv, Shape sh, Dropout dr) {
  load_seed(dr);
  bwd_kv_sm90<T, D, false>(&tm_q, &tm_k, &tm_v, nullptr, &tm_do, lse, delta,
                           dk, dv, nullptr, blockIdx.y * kBN, blockIdx.x, sh,
                           dr);
}

// ---- B4: dQ
// A CTA is one warpgroup owning 64 q rows with q, dO, lse and delta
// resident (two CTAs share an SM, as in B1); k and v tiles of kKeys keys
// stream through a ring of kStages stages. For each tile: S = q k^T and
// dP = dO v^T on wgmma (both K-major), P = 2^(S log2 e - lse log2 e) and
// dS = P (D dP - delta) in the accumulator layout, then dQ += dS k with dS
// as the register A operand and k MN-major. The products of tile kb are
// issued together with dQ of tile kb - 1, so dS of tile kb is formed on
// the CUDA cores while dQ of tile kb - 1 runs on the tensor cores; a stage
// is released when dQ of its tile is done. Shared memory (bytes from a
// 1024-aligned base): q, dO, lse and delta, kStages stages of a k and a v
// tile, then barriers.
template <int D>
struct DqLayout {
  // 128-key tiles at d = 64; at d = 128 the S, dP and dQ accumulators of
  // 128 keys would pass the 255 registers a thread may hold
  static constexpr int kKeys = D == 64 ? 128 : 64;
  // two CTAs an SM leave room for two stages
  static constexpr int kStages = 2;
  static constexpr int kQ = kBM * D * 2;
  static constexpr int kRows = 2 * kQ;  // lse, then delta (kBM floats each)
  static constexpr int kKV = kKeys * D * 2;
  static constexpr int kStage0 = kRows + 1024;
  static constexpr int kBar = kStage0 + kStages * 2 * kKV;
  static constexpr int kBytes = kBar + 128 + 1024;
};

// grid (batch*head, q tile) with blockIdx.y 0 on the LAST q tile (the most
// k tiles under the band), so the heaviest CTAs of every head start first
template <typename T, int D>
__global__ void __launch_bounds__(kWG, 2)
    flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dq,
                      float sm_scale, Shape sh, Dropout dr) {
  load_seed(dr);
  using L = DqLayout<D>;
  constexpr int kN = L::kKeys;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* kv_full = q_full + 1;
  uint64_t* empty = kv_full + L::kStages;  // the stage's readers are done

  const int bh = blockIdx.x;
  const int q0 = (sh.sq / kBM - 1 - blockIdx.y) * kBM;
  const int offset = sh.sk - sh.sq;
  // k tiles up to the causal band of the tile's last row
  int nkb = (sh.sk + kN - 1) / kN;
  if (sh.causal) nkb = min(nkb, (q0 + kBM - 1 + offset) / kN + 1);
  const int tw = threadIdx.x;
  const int lane = tw & 31;
  const int t2 = (lane & 3) * 2;
  const int r0 = (tw >> 5) * 16 + (lane >> 2);  // rows r0, r0 + 8 of the tile
  const uint32_t base = smem_u32(smem);

  // thread 0 loads k and v tile kb into its stage
  auto load_kv = [&](int kb) {
    const int s = kb % L::kStages;
    unsigned char* kt = smem + L::kStage0 + s * 2 * L::kKV;
    mbar_expect_tx(kv_full + s, 2 * L::kKV);
    for (int sub = 0; sub < D / 64; ++sub) {
      tma_load(kt + sub * kN * 128, &tm_k, kv_full + s, sub * 64, kb * kN,
               bh);
      tma_load(kt + L::kKV + sub * kN * 128, &tm_v, kv_full + s, sub * 64,
               kb * kN, bh);
    }
  };
  if (tw == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(kv_full + s, 1);
      mbar_init(empty + s, kWG / 32);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tw == 0) {
    const size_t row = (size_t)bh * sh.sq + q0;
    mbar_expect_tx(q_full, 2 * L::kQ + 2 * kBM * 4);
    for (int sub = 0; sub < D / 64; ++sub) {
      tma_load(smem + sub * kBM * 128, &tm_q, q_full, sub * 64, q0, bh);
      tma_load(smem + L::kQ + sub * kBM * 128, &tm_do, q_full, sub * 64, q0,
               bh);
    }
    bulk_load(smem + L::kRows, lse + row, kBM * 4, q_full);
    bulk_load(smem + L::kRows + kBM * 4, delta + row, kBM * 4, q_full);
    for (int kb = 0; kb < min(L::kStages, nkb); ++kb) load_kv(kb);
  }

  float acc[D / 2];          // dQ, unscaled
  zero(acc);
  float sc[kN / 2];          // S, then dS
  float dp[kN / 2];          // dP
  uint32_t dsa[kN / 16][4];  // dS rounded: the A operand of dS k

  // S = q k^T and dP = dO v^T of tile kb (issued, not waited for)
  auto issue_sdp = [&](int kb) {
    const int s = kb % L::kStages;
    const uint32_t kt = base + L::kStage0 + s * 2 * L::kKV;
    mbar_wait(kv_full + s, (kb / L::kStages) & 1);
    hold(sc);
    hold(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<T, 0, 0>(sc,
                        desc_k(base + (kk / 4) * kBM * 128 + (kk % 4) * 32),
                        desc_k(kt + (kk / 4) * kN * 128 + (kk % 4) * 32),
                        kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<T, 0, 0>(
          dp, desc_k(base + L::kQ + (kk / 4) * kBM * 128 + (kk % 4) * 32),
          desc_k(kt + L::kKV + (kk / 4) * kN * 128 + (kk % 4) * 32), kk > 0);
    wgmma_commit();
  };
  // dQ += dS k of tile kb (k MN-major: the descriptor transposes it)
  auto issue_dq = [&](int kb) {
    const uint32_t kt = base + L::kStage0 + (kb % L::kStages) * 2 * L::kKV;
    hold(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
      wgmma_rs<T, 1>(acc, dsa[kk], desc_mn(kt + kk * 2048, kN * 128));
    wgmma_commit();
  };
  // stage of tile kb spent: once every warp is done with it, thread 0
  // refills it with tile kb + kStages
  auto release = [&](int kb) {
    const int s = kb % L::kStages;
    if (lane == 0) mbar_arrive(empty + s);
    if (tw == 0 && kb + L::kStages < nkb) {
      mbar_wait(empty + s, (kb / L::kStages) & 1);
      load_kv(kb + L::kStages);
    }
  };

  mbar_wait(q_full, 0);
  const float* s_rows = reinterpret_cast<const float*>(smem + L::kRows);
  float lse2[2], dl[2];
  int lim[2];  // keys below lim[r] are inside row r's band
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = s_rows[r0 + 8 * r] * kLog2e;
    dl[r] = s_rows[kBM + r0 + 8 * r];
    lim[r] = sh.causal ? min(q0 + r0 + 8 * r + offset + 1, sh.sk) : sh.sk;
  }

  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * kN;
    issue_sdp(kb);
    if (kb > 0) {
      issue_dq(kb - 1);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    hold(sc);
    hold(dp);
    // masked only where the tile crosses the causal band or seq_k
    const bool edge =
        k0 + kN > sh.sk || (sh.causal && k0 + kN - 1 > q0 + offset);
    if (edge) {
#pragma unroll
      for (int e = 0; e < kN / 2; ++e)
        if (k0 + (e >> 2) * 8 + t2 + (e & 1) >= lim[(e >> 1) & 1])
          sc[e] = kNegInf;
    }
    if (dr.on) {
#pragma unroll
      for (int e = 0; e < kN / 2; ++e)
        dp[e] *= keep_scale(dr.seed, global_bh(dr, bh),
                            q0 + r0 + 8 * ((e >> 1) & 1),
                            k0 + (e >> 2) * 8 + t2 + (e & 1), dr.threshold,
                            dr.scale);
    }
#pragma unroll
    for (int e = 0; e < kN / 2; ++e) {
      const int r = (e >> 1) & 1;
      sc[e] = ex2(fmaf(sc[e], kLog2e, -lse2[r])) * (dp[e] - dl[r]);
    }
    wgmma_wait<0>();  // dQ of tile kb - 1: dsa and its stage are free
    hold(acc);
    if (kb > 0) release(kb - 1);
    acc_to_a16<T, kN>(dsa, sc);
  }
  issue_dq(nkb - 1);
  wgmma_wait<0>();
  hold(acc);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    T* drow = dq + ((size_t)bh * sh.sq + q0 + r0 + 8 * r) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(drow + j * 8 + t2) =
          pack2<T>(acc[4 * j + 2 * r] * sm_scale,
                   acc[4 * j + 2 * r + 1] * sm_scale);
  }
}

// ---------------------------------------------------------------- host side
// fp32 B3 and B2: BwdKvF32; fp32 B4: resident q, dO and score rows, two
// stages of k, v
template <int D>
constexpr size_t dq_f32_smem() {
  using C = TwoPass<D>;
  return sizeof(float) * (2 * C::kRows * C::kStride + C::kRows * C::kSStride +
                          2 * 2 * C::kTileFloats);
}
static_assert(BwdKvF32<64, false>::kBytes <= 232448 &&
                  BwdKvF32<128, false>::kBytes <= 232448 &&
                  BwdKvF32<64, true>::kBytes <= 232448 &&
                  BwdKvF32<128, true>::kBytes <= 232448 &&
                  dq_f32_smem<64>() <= 232448 &&
                  dq_f32_smem<128>() <= 232448 &&
                  FwdF32<64>::kBytes <= 232448 &&
                  FwdF32<128>::kBytes <= 232448 &&
                  BwdLayout<64, true>::kBytes <= 232448 &&
                  BwdLayout<128, true>::kBytes <= 232448 &&
                  BwdLayout<64, false>::kBytes <= 232448 &&
                  BwdLayout<128, false>::kBytes <= 232448 &&
                  FwdLayout<64>::kBytes <= 232448 &&
                  FwdLayout<128>::kBytes <= 232448 &&
                  2 * (DqLayout<64>::kBytes + 1024) <= 233472 &&
                  2 * (DqLayout<128>::kBytes + 1024) <= 233472,
              "fits the 227 KB a block may use (B4: two CTAs an SM, each "
              "with 1 KB the system keeps)");

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

// cuTensorMapEncodeTiled is a driver function; the library links only the
// runtime, which hands out the driver's entry point
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A (bh, seq, d) 16-bit tensor as a 3-D map over (d, seq, bh): boxes of
// 64 columns by `rows` rows of one head in the 128-byte swizzle; rows past
// seq read as zeros.
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int bh, int seq,
                       int d, int rows, bool f16) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(seq) * d * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(
      map,
      f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// fp32 takes the SIMT kernels, bf16 and fp16 the tensor-core ones (only
// the chosen one is instantiated for each dtype)
template <typename T>
constexpr bool kSimt = std::is_same<T, float>::value;

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int bh, Shape sh, Dropout dr, cudaStream_t st) {
  if constexpr (kSimt<T>) {
    using C = TwoPass<D>;
    auto kernel = flash_fwd_f32<D>;
    constexpr size_t smem = FwdF32<D>::kBytes;
    static const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(bh, (sh.sq + C::kRows - 1) / C::kRows), C::kThreads, smem,
             st>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                   static_cast<const float*>(v), static_cast<float*>(o), lse,
                   sh, dr);
  } else {
    constexpr bool f16 = !kBf16<T>;
    CUtensorMap mq, mk, mv;
    cudaError_t e;
    if ((e = tensor_map(&mq, q, bh, sh.sq, D, kBM, f16)) != cudaSuccess ||
        (e = tensor_map(&mk, k, bh, sh.sk, D, kBN, f16)) != cudaSuccess ||
        (e = tensor_map(&mv, v, bh, sh.sk, D, kBN, f16)) != cudaSuccess)
      return static_cast<int>(e);
    auto kernel = flash_fwd_sm90<T, D>;
    constexpr size_t smem = FwdLayout<D>::kBytes;
    static const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(sh.sq / kBM, bh), kWG, smem, st>>>(
        mq, mk, mv, static_cast<T*>(o), lse, sh, dr);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_bwd_fused(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     void* dk, void* dv, float* dq_acc, int bh, Shape sh,
                     Dropout dr, cudaStream_t st) {
  if constexpr (kSimt<T>) {
    using C = TwoPass<D>;
    auto kernel = flash_bwd_fused_f32<D>;
    constexpr size_t smem = BwdKvF32<D, true>::kBytes;
    static const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(bh, (sh.sk + C::kRows - 1) / C::kRows), C::kThreads, smem,
             st>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                   static_cast<const float*>(v), static_cast<const float*>(o),
                   static_cast<const float*>(dout), lse,
                   static_cast<float*>(dk), static_cast<float*>(dv), dq_acc,
                   sh, dr);
  } else {
    constexpr bool f16 = !kBf16<T>;
    CUtensorMap mq, mk, mv, mo, mdo;
    cudaError_t e;
    if ((e = tensor_map(&mq, q, bh, sh.sq, D, kBQ, f16)) != cudaSuccess ||
        (e = tensor_map(&mk, k, bh, sh.sk, D, kBN, f16)) != cudaSuccess ||
        (e = tensor_map(&mv, v, bh, sh.sk, D, kBN, f16)) != cudaSuccess ||
        (e = tensor_map(&mo, o, bh, sh.sq, D, kBQ, f16)) != cudaSuccess ||
        (e = tensor_map(&mdo, dout, bh, sh.sq, D, kBQ, f16)) != cudaSuccess)
      return static_cast<int>(e);
    auto kernel = flash_bwd_fused_sm90<T, D>;
    constexpr size_t smem = BwdLayout<D, true>::kBytes;
    static const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3((sh.sk + kBN - 1) / kBN, bh), 2 * kWG, smem, st>>>(
        mq, mk, mv, mo, mdo, lse, static_cast<T*>(dk), static_cast<T*>(dv),
        dq_acc, sh, dr);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_bwd_kv(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const float* lse, const float* delta,
                  void* dk, void* dv, float* dq_acc, int fused, int bh,
                  Shape sh, Dropout dr, cudaStream_t st) {
  if (fused)
    return launch_bwd_fused<T, D>(q, k, v, o, dout, lse, dk, dv, dq_acc, bh,
                                  sh, dr, st);
  if constexpr (kSimt<T>) {
    using C = TwoPass<D>;
    auto kernel = flash_bwd_dkv_f32<D>;
    constexpr size_t smem = BwdKvF32<D, false>::kBytes;
    static const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3((sh.sk + C::kRows - 1) / C::kRows, bh), C::kThreads, smem,
             st>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                   static_cast<const float*>(v),
                   static_cast<const float*>(dout), lse, delta,
                   static_cast<float*>(dk), static_cast<float*>(dv), sh, dr);
  } else {
    constexpr bool f16 = !kBf16<T>;
    CUtensorMap mq, mk, mv, mdo;
    cudaError_t e;
    if ((e = tensor_map(&mq, q, bh, sh.sq, D, kBQ, f16)) != cudaSuccess ||
        (e = tensor_map(&mk, k, bh, sh.sk, D, kBN, f16)) != cudaSuccess ||
        (e = tensor_map(&mv, v, bh, sh.sk, D, kBN, f16)) != cudaSuccess ||
        (e = tensor_map(&mdo, dout, bh, sh.sq, D, kBQ, f16)) != cudaSuccess)
      return static_cast<int>(e);
    auto kernel = flash_bwd_dkv_sm90<T, D>;
    constexpr size_t smem = BwdLayout<D, false>::kBytes;
    static const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(bh, (sh.sk + kBN - 1) / kBN), 2 * kWG, smem, st>>>(
        mq, mk, mv, mdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
        sh, dr);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_bwd_q(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, float sm_scale, int bh, Shape sh, Dropout dr,
                 cudaStream_t st) {
  if constexpr (kSimt<T>) {
    using C = TwoPass<D>;
    auto kernel = flash_bwd_dq_f32<D>;
    constexpr size_t smem = dq_f32_smem<D>();
    static const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3((sh.sq + C::kRows - 1) / C::kRows, bh), C::kThreads, smem,
             st>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                   static_cast<const float*>(v),
                   static_cast<const float*>(dout), lse, delta,
                   static_cast<float*>(dq), sm_scale, sh, dr);
  } else {
    constexpr bool f16 = !kBf16<T>;
    using L = DqLayout<D>;
    CUtensorMap mq, mk, mv, mdo;
    cudaError_t e;
    if ((e = tensor_map(&mq, q, bh, sh.sq, D, kBM, f16)) != cudaSuccess ||
        (e = tensor_map(&mk, k, bh, sh.sk, D, L::kKeys, f16)) != cudaSuccess ||
        (e = tensor_map(&mv, v, bh, sh.sk, D, L::kKeys, f16)) != cudaSuccess ||
        (e = tensor_map(&mdo, dout, bh, sh.sq, D, kBM, f16)) != cudaSuccess)
      return static_cast<int>(e);
    auto kernel = flash_bwd_dq_sm90<T, D>;
    constexpr size_t smem = L::kBytes;
    static const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(bh, sh.sq / kBM), kWG, smem, st>>>(
        mq, mk, mv, mdo, lse, delta, static_cast<T*>(dq), sm_scale, sh, dr);
  }
  return static_cast<int>(cudaGetLastError());
}

bool valid(int bh, int sq, int sk, int d, int dtype) {
  return bh >= 1 && bh <= 65535 && sq >= kTile && sk >= kTile &&
         sq % kTile == 0 && sk % kTile == 0 && (d == 64 || d == 128) &&
         dtype >= 0 && dtype <= 2;
}

Dropout make_dropout(int on, const void* seed, uint32_t threshold,
                     float scale, int heads_local, int heads_global,
                     int bh_offset) {
  Dropout dr;
  dr.on = on;
  dr.seed = 0u;
  dr.seed_ptr = static_cast<const uint32_t*>(seed);
  dr.threshold = threshold;
  dr.scale = scale;
  dr.heads_local = heads_local > 0 ? heads_local : 1;
  dr.heads_global = heads_global;
  dr.bh_offset = bh_offset;
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
// which are float32; q is pre-scaled by 1/sqrt(d). `seed` is the device
// address of the dropout seed (a uint32; read only when dropout_on);
// heads_local / heads_global / bh_offset place the launch's (batch, head)
// rows in a larger call for the dropout hash (global_bh). Each
// returns a cudaError_t code (0 on success); launches are asynchronous on
// `stream`.
extern "C" int ff_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int bh, int sq, int sk,
                            int d, int causal, int dropout_on,
                            const void* seed, uint32_t threshold,
                            float keep_scale_value, int heads_local,
                            int heads_global, int bh_offset,
                            int dtype, void* stream) {
  if (!valid(bh, sq, sk, d, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{sq, sk, causal};
  const Dropout dr = make_dropout(dropout_on, seed, threshold,
                                  keep_scale_value, heads_local,
                                  heads_global, bh_offset);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FF_DISPATCH(launch_fwd, q, k, v, o, static_cast<float*>(lse), bh, sh, dr,
              st)
}

extern "C" int ff_flash_bwd_kv(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const void* lse, const void* delta, void* dk,
                               void* dv, void* dq_acc, int fused, int bh,
                               int sq, int sk, int d, int causal,
                               int dropout_on, const void* seed,
                               uint32_t threshold, float keep_scale_value,
                               int heads_local, int heads_global, int bh_offset,
                               int dtype, void* stream) {
  if (!valid(bh, sq, sk, d, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{sq, sk, causal};
  const Dropout dr = make_dropout(dropout_on, seed, threshold,
                                  keep_scale_value, heads_local,
                                  heads_global, bh_offset);
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
                              int dropout_on, const void* seed,
                              uint32_t threshold, float keep_scale_value,
                              int heads_local, int heads_global, int bh_offset,
                              int dtype, void* stream) {
  if (!valid(bh, sq, sk, d, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{sq, sk, causal};
  const Dropout dr = make_dropout(dropout_on, seed, threshold,
                                  keep_scale_value, heads_local,
                                  heads_global, bh_offset);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FF_DISPATCH(launch_bwd_q, q, k, v, dout, static_cast<const float*>(lse),
              static_cast<const float*>(delta), dq, sm_scale, bh, sh, dr, st)
}

// Dynamic shared memory of a launch: kernel 0 = 16-bit forward (B1,
// flash_fwd_sm90), 1 = 16-bit fused backward (B2, flash_bwd_fused_sm90),
// 2 = fp32 dK/dV (B3, flash_bwd_dkv_f32), 3 = fp32 dQ (B4,
// flash_bwd_dq_f32), 4 = fp32 forward (B1, flash_fwd_f32), 5 = fp32 fused
// backward (B2, flash_bwd_fused_f32), 6 = 16-bit dK/dV (B3,
// flash_bwd_dkv_sm90), 7 = 16-bit dQ (B4, flash_bwd_dq_sm90), for head dim
// d (64 or 128); -1 otherwise.
extern "C" int ff_flash_smem_bytes(int kernel, int d) {
  if (d != 64 && d != 128) return -1;
  const bool d64 = d == 64;
  switch (kernel) {
    case 0: return d64 ? FwdLayout<64>::kBytes : FwdLayout<128>::kBytes;
    case 1: return d64 ? BwdLayout<64, true>::kBytes
                       : BwdLayout<128, true>::kBytes;
    case 2: return static_cast<int>(d64 ? BwdKvF32<64, false>::kBytes
                                        : BwdKvF32<128, false>::kBytes);
    case 3: return static_cast<int>(d64 ? dq_f32_smem<64>()
                                        : dq_f32_smem<128>());
    case 4: return static_cast<int>(d64 ? FwdF32<64>::kBytes
                                        : FwdF32<128>::kBytes);
    case 5: return static_cast<int>(d64 ? BwdKvF32<64, true>::kBytes
                                        : BwdKvF32<128, true>::kBytes);
    case 6: return d64 ? BwdLayout<64, false>::kBytes
                       : BwdLayout<128, false>::kBytes;
    case 7: return d64 ? DqLayout<64>::kBytes : DqLayout<128>::kBytes;
    default: return -1;
  }
}

// Host microseconds to encode one TMA descriptor for a (bh, seq, d) bf16
// tensor, the mean over `iters` encodings (a 16-bit B1 launch encodes 3, a
// B2 launch 5, a B3 or B4 launch 4); negative if an encoding fails.
extern "C" double ff_flash_tensor_map_us(const void* ptr, int bh, int seq,
                                         int d, int iters) {
  CUtensorMap map;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i)
    if (tensor_map(&map, ptr, bh, seq, d, 64, false) != cudaSuccess)
      return -1.0;
  const std::chrono::duration<double, std::micro> us =
      std::chrono::steady_clock::now() - t0;
  return us.count() / (iters > 0 ? iters : 1);
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

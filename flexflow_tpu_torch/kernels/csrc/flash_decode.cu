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
// bf16, fp16, or int8 with scales); the output is written in q's dtype.
//
// What bounds it: bytes, and at decode sizes the latency of fetching them.
// Each key row is read once and used for 2*dim flops (score) plus 2*dim
// (PV), far below the card's flops per byte, and a decode step's whole
// attention read is a few MB: at GPT-2 small's 8 slots x 12 heads it is
// one or two memory round trips deep. The design therefore keeps as many
// 16-byte loads in flight, in as many CTAs, as it can, and puts no load
// behind another in the same round:
//   * the keys of each (slot, head) are split into chunks of whole blocks
//     across CTAs (grid: chunk, head, slot). The chunk size comes from host
//     values only (slots, heads, mb, bs and the SM count, see
//     chunk_blocks_for), never from n_keys, so a launch needs no host sync
//     and can be captured in a CUDA graph. A CTA whose chunk starts at or
//     past n_keys leaves at once (the TPU kernel's clamp of dead grid steps
//     becomes an early exit); the min(n_keys, mb * bs) clamp stays;
//   * a CTA first stages its chunk's block-table entries into shared
//     memory (issued beside the n_keys load), so no K/V load of a round
//     waits on a table load of its own round;
//   * every lane loads 16 bytes a row (4 fp32, 8 bf16/fp16 or 16 int8
//     elements): a row is kL lanes wide, so one warp-wide load covers
//     32 / kL key rows, and each lane issues kU such loads of K and of V
//     before any arithmetic. The dot products reduce over a row's kL lanes
//     with sub-warp shuffles. Pools that are not 16-byte aligned, or widths
//     that are not a multiple of the vector, take the same layout with
//     element-wise loads;
//   * each group of kL lanes keeps an online softmax (m, l, acc) over the
//     keys it saw; the groups merge by shuffles, the warps through shared
//     memory, into the CTA's partial;
//   * a (slot, head) with one live chunk writes its output directly. With
//     more, each chunk stores its fp32 (m, l, acc) to scratch the wrapper
//     allocates, takes a ticket from a per-(slot, head) counter, and the
//     CTA that takes the last ticket resets the counter and merges the
//     partials in chunk order (not arrival order), so a decode step is
//     bitwise repeatable. One launch a call; the counters persist across
//     launches (the wrapper creates them zeroed, once, outside any graph
//     capture), so launches that share them must run on one stream.
//
// int8 KV (ff_flash_decode_int8) replaces the same kernel's int8 branch
// (flash_decode.py:78-80): pools hold int8 rows and f32 per-(token, head)
// scales in (n_blocks, heads, block_size) arrays laid out like the pools'
// rows. A warp's round covers 16 consecutive keys, whose K and V scales
// are contiguous in a block: one coalesced load per warp brings all 32,
// and shuffles hand each key row its pair. Elements are dequantized in
// registers (float(k) * scale, the TPU kernel's order) before the same
// fp32 math. q and the output keep the model dtype.
//
// Segment mode (ff_flash_decode_segment, ff_flash_decode_segment_int8)
// serves sequence-parallel decode (flexflow_tpu/kernels/seqpar_decode.py,
// whose decode_shard_partial it replaces on the card): the launch covers
// only the table columns [seg_lo, seg_hi) of every slot, its chunks split
// that range as above, and in place of the normalised output it writes the
// segment's fp32 partial (m, l, acc) — the triple the chunks already merge
// — to a (slots, heads, vd + 2) array. A segment that holds none of a
// slot's keys (all of it at or past n_keys) writes m = -1e30, l = 0 and
// acc = 0: it weighs exactly 0 in the combine, and no value of a block no
// key reaches is ever read into it.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxDim = 256;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
// table entries a CTA stages: a chunk spans at most this many blocks
constexpr int kMaxChunkBlocks = 256;
// CTAs an SM the key split aims at for a full cache: each chunk then
// holds one round of keys at GPT-2 small's decode shape
constexpr int kCtasPerSm = 4;

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

// The lane layout of one pool dtype at one head width class kW (64, 128 or
// 256): a key row is kL lanes of kV 16-byte vectors of kE elements; lane g
// of a row holds elements (v * kL + g) * kE + e, so neighbouring lanes read
// neighbouring 16 bytes. kR rows share a warp-wide load; each lane keeps
// kU loads of K and of V in flight (kU * kV vectors of each, at most 8).
template <typename TKV, int kW>
struct Layout {
  static constexpr int kE = 16 / static_cast<int>(sizeof(TKV));
  static constexpr int kL = kW / kE < 32 ? kW / kE : 32;
  static constexpr int kV = kW / (kE * kL);
  static constexpr int kR = 32 / kL;
  static constexpr int kU = 16 / kR < 8 / kV ? 16 / kR : 8 / kV;
  static constexpr int kWarpKeys = kR * kU;  // keys of a warp's round
  static constexpr int kRoundKeys = kWarps * kWarpKeys;
  static constexpr int kWidth = kL * kV * kE;
  static_assert(kV >= 1 && kU >= 1 && kWidth == kW, "layout covers kW");
  static_assert(sizeof(TKV) != 1 || kWarpKeys == 16,
                "int8 rounds cover 16 keys (one scale load a warp)");
};

// 16 bytes of a row from element d0 on (zeros past dim or for a dead key):
// one vector load, or (kVec false) element by element
template <typename TKV, bool kVec>
__device__ __forceinline__ uint4 load16(const TKV* row, int d0, int dim,
                                        bool live) {
  constexpr int kE = 16 / static_cast<int>(sizeof(TKV));
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  if (!live || d0 >= dim) return u;
  if (kVec) {
    u = __ldg(reinterpret_cast<const uint4*>(row + d0));
  } else {
    TKV* t = reinterpret_cast<TKV*>(&u);
#pragma unroll
    for (int e = 0; e < kE; ++e)
      if (d0 + e < dim) t[e] = row[d0 + e];
  }
  return u;
}

template <typename TKV>
__device__ __forceinline__ float elem(const uint4& u, int e) {
  return to_f32(reinterpret_cast<const TKV*>(&u)[e]);
}

// weight of a partial with running max m under the common max mx (a
// partial that saw no key has m = -inf and weighs nothing)
__device__ __forceinline__ float weight(float m, float mx) {
  return m == -INFINITY ? 0.f : expf(m - mx);
}

// m of a partial over no key (segment mode): the decode mask's value
constexpr float kMaskNeg = -1e30f;

// T: q and output dtype. TKV: pool dtype — T itself, or int8_t with the
// f32 scale arrays kscale/vscale (null for a native pool). part: scratch of
// (slots * heads * chunks, vd + 2) fp32 partials (m, l, acc); tickets:
// slots * heads counters, zero between launches. The launch covers table
// columns [seg_lo, seg_hi) (0 and mb outside segment mode); pout, when not
// null, takes the (slots * heads, vd + 2) fp32 partial (m, l, acc) of those
// columns in place of the normalised output.
template <typename T, typename TKV, int kW, bool kVec>
__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(const T* __restrict__ q,
                        const TKV* __restrict__ kpool,
                        const TKV* __restrict__ vpool,
                        const float* __restrict__ kscale,
                        const float* __restrict__ vscale,
                        const int* __restrict__ tables,
                        const int* __restrict__ n_keys, T* __restrict__ out,
                        float* __restrict__ part, int* __restrict__ tickets,
                        float* __restrict__ pout, int heads, int hd, int vd,
                        int bs, int mb, int seg_lo, int seg_hi,
                        int chunk_blocks, float scale) {
  using C = Layout<TKV, kW>;
  constexpr int kE = C::kE, kL = C::kL, kV = C::kV, kR = C::kR, kU = C::kU;
  constexpr bool kInt8 = sizeof(TKV) == 1;
  const int chunk = blockIdx.x;
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane % kL;   // lane within its key row
  const int gr = lane / kL;  // key row of a warp-wide load

  __shared__ int sm_blk[kMaxChunkBlocks];
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][C::kWidth];
  __shared__ int sm_last;

  // the chunk's table entries, loaded beside n_keys (entries past the
  // slot's used blocks are read but never followed)
  const int b0 = seg_lo + chunk * chunk_blocks;
  const int nb = min(chunk_blocks, seg_hi - b0);
  for (int i = threadIdx.x; i < nb; i += kThreads)
    sm_blk[i] = tables[(size_t)s * mb + b0 + i];
  // keys past the table's extent do not exist: the slot attends to at
  // most mb * bs positions (the TPU kernel's grid has exactly mb steps);
  // a segment's keys end where its columns do
  const int n = min(max(0, min(n_keys[s], mb * bs)), seg_hi * bs);
  const int ck = chunk_blocks * bs;
  const int c0 = b0 * bs;
  const int first = seg_lo * bs;
  const size_t sh = (size_t)s * heads + h;
  T* orow = out != nullptr ? out + sh * vd : nullptr;
  const int stride = vd + 2;
  float* prow_out = pout != nullptr ? pout + sh * stride : nullptr;
  if (c0 >= n) {
    if (chunk == 0) {  // a slot with no keys here: zeros, or the empty
                       // partial
      if (prow_out != nullptr) {
        for (int d = threadIdx.x; d < stride; d += kThreads)
          prow_out[d] = d == 0 ? kMaskNeg : 0.f;
      } else {
        for (int d = threadIdx.x; d < vd; d += kThreads)
          orow[d] = from_f32<T>(0.f);
      }
    }
    return;
  }
  const int end = min(n, c0 + ck);

  float qf[kV][kE];
  const T* qrow = q + sh * hd;
#pragma unroll
  for (int v = 0; v < kV; ++v)
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int d = (v * kL + g) * kE + e;
      qf[v][e] = d < hd ? to_f32(qrow[d]) * scale : 0.f;
    }
  float m = -INFINITY;
  float l = 0.f;
  float acc[kV][kE];
#pragma unroll
  for (int v = 0; v < kV; ++v)
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[v][e] = 0.f;
  __syncthreads();  // sm_blk

  for (int base = c0 + warp * C::kWarpKeys; base < end;
       base += C::kRoundKeys) {
    // every load of the round is issued before any arithmetic: kU loads
    // of K and of V a lane (and, for int8, one scale load a warp)
    uint4 kr[kU][kV], vr[kU][kV];
    float sc_mine = 0.f;
    if constexpr (kInt8) {
      const int j = base + (lane & 15);
      if (j < end) {
        const size_t row =
            ((size_t)sm_blk[j / bs - b0] * heads + h) * bs + j % bs;
        sc_mine = lane < 16 ? kscale[row] : vscale[row];
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int j = base + u * kR + gr;
      const bool live = j < end;
      const size_t row =
          live ? ((size_t)sm_blk[j / bs - b0] * heads + h) * bs + j % bs : 0;
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const int d0 = (v * kL + g) * kE;
        kr[u][v] = load16<TKV, kVec>(kpool + row * hd, d0, hd, live);
        vr[u][v] = load16<TKV, kVec>(vpool + row * vd, d0, vd, live);
      }
    }
    float sc[kU], ks[kU], vs[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      ks[u] = vs[u] = 1.f;
      if constexpr (kInt8) {
        ks[u] = __shfl_sync(0xffffffffu, sc_mine, u * kR + gr);
        vs[u] = __shfl_sync(0xffffffffu, sc_mine, 16 + u * kR + gr);
      }
      float p = 0.f;
#pragma unroll
      for (int v = 0; v < kV; ++v)
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          float kx = elem<TKV>(kr[u][v], e);
          if constexpr (kInt8) kx *= ks[u];
          p += qf[v][e] * kx;
        }
#pragma unroll
      for (int o = kL / 2; o > 0; o >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, o);
      sc[u] = base + u * kR + gr < end ? p : -INFINITY;
    }
    float tmax = sc[0];
#pragma unroll
    for (int u = 1; u < kU; ++u) tmax = fmaxf(tmax, sc[u]);
    const float m_new = fmaxf(m, tmax);
    // a row group whose keys are all dead this round keeps its state
    const float corr = weight(m, m_new);
    float p[kU];
    float psum = 0.f;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      p[u] = sc[u] == -INFINITY ? 0.f : expf(sc[u] - m_new);
      psum += p[u];
    }
    l = l * corr + psum;
#pragma unroll
    for (int v = 0; v < kV; ++v)
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        float a = acc[v][e] * corr;
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          float vx = elem<TKV>(vr[u][v], e);
          if constexpr (kInt8) vx *= vs[u];
          a += p[u] * vx;
        }
        acc[v][e] = a;
      }
    m = m_new;
  }

  // the warp's row groups merge by shuffles: every group then holds it
#pragma unroll
  for (int o = kL; o < 32; o <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, o);
    const float lo = __shfl_xor_sync(0xffffffffu, l, o);
    const float mx = fmaxf(m, mo);
    const float fa = weight(m, mx);
    const float fb = weight(mo, mx);
    l = l * fa + lo * fb;
#pragma unroll
    for (int v = 0; v < kV; ++v)
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[v][e], o);
        acc[v][e] = acc[v][e] * fa + ao * fb;
      }
    m = mx;
  }
  if (lane < kL) {
#pragma unroll
    for (int v = 0; v < kV; ++v)
#pragma unroll
      for (int e = 0; e < kE; ++e) sm_acc[warp][(v * kL + g) * kE + e] =
          acc[v][e];
    if (lane == 0) {
      sm_m[warp] = m;
      sm_l[warp] = l;
    }
  }
  __syncthreads();

  // the CTA's partial over its warps (its chunk holds a live key, so the
  // common max is finite)
  float mx = sm_m[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
  float f[kWarps];
  float lsum = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    f[w] = weight(sm_m[w], mx);
    lsum += sm_l[w] * f[w];
  }
  const int live_chunks = (n - first + ck - 1) / ck;
  if (live_chunks == 1) {
    for (int d = threadIdx.x; d < vd; d += kThreads) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a += sm_acc[w][d] * f[w];
      if (prow_out != nullptr) {
        prow_out[2 + d] = a;
      } else {
        orow[d] = from_f32<T>(a / lsum);
      }
    }
    if (prow_out != nullptr && threadIdx.x == 0) {
      prow_out[0] = mx;
      prow_out[1] = lsum;
    }
    return;
  }

  float* prow = part + (sh * gridDim.x + chunk) * stride;
  for (int d = threadIdx.x; d < vd; d += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += sm_acc[w][d] * f[w];
    prow[2 + d] = a;
  }
  if (threadIdx.x == 0) {
    prow[0] = mx;
    prow[1] = lsum;
  }
  // publish the partial, then take a ticket; the last of the slot's live
  // chunks merges them all
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(tickets + sh, 1) == live_chunks - 1;
    if (last) atomicExch(tickets + sh, 0);  // every ticket is taken
    sm_last = last;
  }
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  const float* prows = part + sh * gridDim.x * stride;
  float gm = -INFINITY;
  for (int c = 0; c < live_chunks; ++c)
    gm = fmaxf(gm, __ldcg(prows + (size_t)c * stride));
  for (int d = threadIdx.x; d < vd; d += kThreads) {
    float lt = 0.f;
    float a = 0.f;
    for (int c = 0; c < live_chunks; ++c) {  // chunk order: repeatable
      const float* pc = prows + (size_t)c * stride;
      const float w = expf(__ldcg(pc) - gm);
      lt += __ldcg(pc + 1) * w;
      a += __ldcg(pc + 2 + d) * w;
    }
    if (prow_out != nullptr) {
      prow_out[2 + d] = a;
      if (d == 0) {
        prow_out[0] = gm;
        prow_out[1] = lt;
      }
    } else {
      orow[d] = from_f32<T>(a / lt);
    }
  }
}

// The lane layout's keys a CTA covers in one round, for the widest head
// dim (one of the classes 64, 128, 256)
template <typename TKV>
int round_keys(int widest) {
  if (widest <= 64) return Layout<TKV, 64>::kRoundKeys;
  if (widest <= 128) return Layout<TKV, 128>::kRoundKeys;
  return Layout<TKV, 256>::kRoundKeys;
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

// Blocks of a chunk, from host-known values only: enough chunks that the
// full cache (every slot at mb * bs keys) gives about kCtasPerSm CTAs an
// SM, each chunk one round of the CTA's keys or a whole number of rounds
// where the block size divides a round.
int chunk_blocks_for(int n_slots, int heads, int bs, int mb, int rk) {
  const long pairs = (long)n_slots * heads;
  const long target = (long)kCtasPerSm * sm_count();
  const int want = (int)((target + pairs - 1) / pairs);  // chunks a pair
  int cb = (mb + want - 1) / want;
  if (rk % bs == 0) cb = cb / (rk / bs) * (rk / bs);
  const int min_blocks = (rk + bs - 1) / bs;
  if (cb < min_blocks) cb = min_blocks;
  if (cb > mb) cb = mb;
  if (cb > kMaxChunkBlocks) cb = kMaxChunkBlocks;
  return cb;
}

template <typename T, typename TKV, int kW>
void launch_width(const T* q, const TKV* kpool, const TKV* vpool,
                  const float* kscale, const float* vscale, const int* tables,
                  const int* n_keys, T* out, float* part, int* tickets,
                  float* pout, int n_slots, int heads, int hd, int vd, int bs,
                  int mb, int seg_lo, int seg_hi, int chunk_blocks,
                  float scale, cudaStream_t stream) {
  constexpr int kE = Layout<TKV, kW>::kE;
  const int cols = seg_hi - seg_lo;
  const dim3 grid((cols + chunk_blocks - 1) / chunk_blocks, heads, n_slots);
  // 16-byte loads when both widths are whole vectors and both pools start
  // on a 16-byte boundary (every row then does too)
  const bool vec = hd % kE == 0 && vd % kE == 0 &&
                   reinterpret_cast<size_t>(kpool) % 16 == 0 &&
                   reinterpret_cast<size_t>(vpool) % 16 == 0;
  if (vec) {
    flash_decode_kernel<T, TKV, kW, true><<<grid, kThreads, 0, stream>>>(
        q, kpool, vpool, kscale, vscale, tables, n_keys, out, part, tickets,
        pout, heads, hd, vd, bs, mb, seg_lo, seg_hi, chunk_blocks, scale);
  } else {
    flash_decode_kernel<T, TKV, kW, false><<<grid, kThreads, 0, stream>>>(
        q, kpool, vpool, kscale, vscale, tables, n_keys, out, part, tickets,
        pout, heads, hd, vd, bs, mb, seg_lo, seg_hi, chunk_blocks, scale);
  }
}

template <typename T, typename TKV>
int launch(const void* q, const void* kpool, const void* vpool,
           const void* kscale, const void* vscale, const void* tables,
           const void* n_keys, void* out, void* part, void* tickets,
           void* pout, int n_slots, int heads, int hd, int vd, int bs,
           int mb, int seg_lo, int seg_hi, int chunk_blocks, float scale,
           cudaStream_t stream) {
  const int widest = hd > vd ? hd : vd;
  const T* qt = static_cast<const T*>(q);
  const TKV* kt = static_cast<const TKV*>(kpool);
  const TKV* vt = static_cast<const TKV*>(vpool);
  const float* kst = static_cast<const float*>(kscale);
  const float* vst = static_cast<const float*>(vscale);
  const int* tt = static_cast<const int*>(tables);
  const int* nt = static_cast<const int*>(n_keys);
  T* ot = static_cast<T*>(out);
  float* pt = static_cast<float*>(part);
  int* ct = static_cast<int*>(tickets);
  float* po = static_cast<float*>(pout);
  if (widest <= 64) {
    launch_width<T, TKV, 64>(qt, kt, vt, kst, vst, tt, nt, ot, pt, ct,
                             po, n_slots, heads, hd, vd, bs, mb, seg_lo,
                             seg_hi, chunk_blocks, scale, stream);
  } else if (widest <= 128) {
    launch_width<T, TKV, 128>(qt, kt, vt, kst, vst, tt, nt, ot, pt, ct,
                              po, n_slots, heads, hd, vd, bs, mb, seg_lo,
                              seg_hi, chunk_blocks, scale, stream);
  } else {
    launch_width<T, TKV, 256>(qt, kt, vt, kst, vst, tt, nt, ot, pt, ct,
                              po, n_slots, heads, hd, vd, bs, mb, seg_lo,
                              seg_hi, chunk_blocks, scale, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int n_slots, int heads, int hd, int vd, int bs, int mb,
               int chunk_blocks) {
  return n_slots < 1 || n_slots > 65535 || heads < 1 || heads > 65535 ||
         hd < 1 || hd > kMaxDim || vd < 1 || vd > kMaxDim || bs < 1 ||
         mb < 1 || chunk_blocks < 1 || chunk_blocks > kMaxChunkBlocks;
}

// One launch of any mode: native pools when kscale is null, else int8
int dispatch(const void* q, const void* kpool, const void* vpool,
             const void* kscale, const void* vscale, const void* tables,
             const void* n_keys, void* out, void* part, void* tickets,
             void* pout, int n_slots, int heads, int hd, int vd, int bs,
             int mb, int seg_lo, int seg_hi, int chunk_blocks, float scale,
             int dtype, void* stream) {
  const bool int8 = kscale != nullptr;
  if (bad_shape(n_slots, heads, hd, vd, bs, mb, chunk_blocks) ||
      seg_lo < 0 || seg_hi <= seg_lo || seg_hi > mb ||
      (int8 && vscale == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FF_LAUNCH(T, TKV)                                                    \
  launch<T, TKV>(q, kpool, vpool, kscale, vscale, tables, n_keys, out, part, \
                 tickets, pout, n_slots, heads, hd, vd, bs, mb, seg_lo,      \
                 seg_hi, chunk_blocks, scale, st)
  switch (dtype) {
    case 0:
      return int8 ? FF_LAUNCH(float, int8_t) : FF_LAUNCH(float, float);
    case 1:
      return int8 ? FF_LAUNCH(__nv_bfloat16, int8_t)
                  : FF_LAUNCH(__nv_bfloat16, __nv_bfloat16);
    case 2:
      return int8 ? FF_LAUNCH(__half, int8_t) : FF_LAUNCH(__half, __half);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FF_LAUNCH
}

}  // namespace

// Blocks of one chunk for a launch of this shape (int8: an int8 pool;
// dtype: q's, 0 = float32, 1 = bfloat16, 2 = float16; mb: the table
// columns the launch covers, a segment's in segment mode); the launch runs
// ceil(mb / chunk) chunks a (slot, head), and its scratch holds that many
// (vd + 2)-float partials for each. Negative for a shape the kernel does
// not take.
extern "C" int ff_flash_decode_chunk_blocks(int n_slots, int heads, int hd,
                                            int vd, int bs, int mb, int int8,
                                            int dtype) {
  if (bad_shape(n_slots, heads, hd, vd, bs, mb, 1) || dtype < 0 || dtype > 2)
    return -1;
  const int widest = hd > vd ? hd : vd;
  const int rk = int8 ? round_keys<int8_t>(widest)
                      : dtype == 0 ? round_keys<float>(widest)
                                   : round_keys<__half>(widest);
  return chunk_blocks_for(n_slots, heads, bs, mb, rk);
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, pools and output).
// part: fp32 scratch of n_slots * heads * ceil(mb / chunk_blocks) * (vd +
// 2) floats (unread when there is one chunk); tickets: n_slots * heads
// int32 counters, zero before the first launch and left zero by each.
// Returns a cudaError_t code (0 on success); the launch is asynchronous on
// `stream`.
extern "C" int ff_flash_decode(const void* q, const void* kpool,
                               const void* vpool, const void* tables,
                               const void* n_keys, void* out, void* part,
                               void* tickets, int n_slots, int heads, int hd,
                               int vd, int bs, int mb, int chunk_blocks,
                               float scale, int dtype, void* stream) {
  return dispatch(q, kpool, vpool, nullptr, nullptr, tables, n_keys, out,
                  part, tickets, nullptr, n_slots, heads, hd, vd, bs, mb, 0,
                  mb, chunk_blocks, scale, dtype, stream);
}

// int8 pools with f32 scales (n_blocks, heads, bs); dtype is q's and the
// output's (0 = float32, 1 = bfloat16, 2 = float16); part and tickets as
// for ff_flash_decode.
extern "C" int ff_flash_decode_int8(const void* q, const void* kpool,
                                    const void* vpool, const void* kscale,
                                    const void* vscale, const void* tables,
                                    const void* n_keys, void* out, void* part,
                                    void* tickets, int n_slots, int heads,
                                    int hd, int vd, int bs, int mb,
                                    int chunk_blocks, float scale, int dtype,
                                    void* stream) {
  if (kscale == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(q, kpool, vpool, kscale, vscale, tables, n_keys, out,
                  part, tickets, nullptr, n_slots, heads, hd, vd, bs, mb, 0,
                  mb, chunk_blocks, scale, dtype, stream);
}

// Segment mode: the partial (m, l, acc) of table columns [seg_lo, seg_hi)
// into pout, fp32 (n_slots, heads, vd + 2); chunk_blocks from
// ff_flash_decode_chunk_blocks at mb = seg_hi - seg_lo, part sized for
// ceil((seg_hi - seg_lo) / chunk_blocks) chunks. kscale/vscale null for a
// native pool, the f32 scales of an int8 one.
extern "C" int ff_flash_decode_segment(
    const void* q, const void* kpool, const void* vpool, const void* kscale,
    const void* vscale, const void* tables, const void* n_keys, void* pout,
    void* part, void* tickets, int n_slots, int heads, int hd, int vd, int bs,
    int mb, int seg_lo, int seg_hi, int chunk_blocks, float scale, int dtype,
    void* stream) {
  if (pout == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(q, kpool, vpool, kscale, vscale, tables, n_keys, nullptr,
                  part, tickets, pout, n_slots, heads, hd, vd, bs, mb, seg_lo,
                  seg_hi, chunk_blocks, scale, dtype, stream);
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

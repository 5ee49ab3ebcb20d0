// The attention body shared by the two decode-step kernels
// (decode_step.cu: the slot cache; block_decode_step.cu: the block pool).
//
// One CUDA block of kThreads attends the `rep` query heads of one kv head of
// one slot over positions 0..n_pos-1, whose K/V rows come from a row policy
// (a contiguous cache head, or the slot's block table), with the new token's
// row (position `idx`) taken from the new values instead of the cache, so no
// read waits on the write.
//
//  * Rows are walked in chunks of `cs`, copied into shared memory with
//    cp.async (16 bytes a copy, no registers held), double-buffered: the next
//    chunk's copies are in flight while the block computes on this one,
//    which keeps HBM streaming.
//  * Storage type S is the compute type T, or an 8-bit payload (int8, or fp8
//    e4m3 bytes) with one f32-held bf16 scale per row; an 8-bit value is
//    dequantized as T(f32(payload) * scale), the value a gather would store.
//    Row scales are loaded into registers when a chunk's copies are issued
//    and parked in shared memory after the current chunk's compute.
//  * Scores: products of the stored values summed in f32, times `scale`;
//    online softmax over (m, l, acc) in f32; probabilities rounded to T
//    before P.V; the output is acc / max(l, 1e-20), cast once.
#pragma once

#include <math_constants.h>
#include <cuda_fp8.h>

#include "common.cuh"

namespace dst {
namespace attend {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPerThread = 16;  // rep * dh <= kThreads * kMaxPerThread

using fp8_t = __nv_fp8_storage_t;  // e4m3 bytes

// A stored element as the f32 value of the compute type T.
template <typename T, typename S>
struct Load;
template <typename T>
struct Load<T, T> {
  static constexpr bool kQuant = false;
  __device__ static __forceinline__ float f(T v, float) { return to_f32(v); }
};
template <typename T>
struct Load<T, int8_t> {
  static constexpr bool kQuant = true;
  __device__ static __forceinline__ float f(int8_t v, float s) {
    return to_f32(from_f32<T>(static_cast<float>(v) * s));
  }
};
template <typename T>
struct Load<T, fp8_t> {
  static constexpr bool kQuant = true;
  __device__ static __forceinline__ float f(fp8_t v, float s) {
    const __half h(__nv_cvt_fp8_to_halfraw(v, __NV_E4M3));  // exact
    return to_f32(from_f32<T>(__half2float(h) * s));
  }
};

// Bytes of attend()'s shared memory, rounded up to 16.
template <typename S>
__host__ __device__ inline size_t smem_bytes(int rep, int dh, int cs, bool quant) {
  const size_t b = 4 * (size_t)cs * dh * sizeof(S)
                 + ((size_t)rep * dh + (size_t)rep * cs + 3 * (size_t)rep
                    + (quant ? 4 * (size_t)cs : 0)) * sizeof(float);
  return (b + 15) / 16 * 16;
}

// Chunk rows: one buffer of K + V rows stays within 32 KB (two in flight).
template <typename S>
inline int chunk_rows(int dh) {
  const int cs = 16384 / (dh * (int)sizeof(S));
  return cs > 64 ? 64 : (cs < 8 ? 8 : cs);
}

// Start the copies of K and V rows c0..c0+cn-1 into shared memory as one
// cp.async group. Row `idx` comes from knh/vnh: global memory (copied like
// the others) or, when kNewInSmem, shared memory (plain 16-byte stores,
// visible after the consumer's __syncthreads).
template <typename S, bool kNewInSmem, class Rows>
__device__ __forceinline__ void stage_chunk(S* k_dst, S* v_dst, const Rows& rows,
                                            const S* knh, const S* vnh, int c0,
                                            int cn, int idx, int dh) {
  constexpr int kVec = 16 / sizeof(S);  // elements per 16-byte copy
  const int vpr = dh / kVec;
  for (int i = threadIdx.x; i < cn * vpr; i += kThreads) {
    const int p = i / vpr, v = (i - p * vpr) * kVec;
    const int pos = c0 + p;
    S* kd = k_dst + (size_t)p * dh + v;
    S* vd = v_dst + (size_t)p * dh + v;
    if (pos == idx && kNewInSmem) {
      *reinterpret_cast<uint4*>(kd) = *reinterpret_cast<const uint4*>(knh + v);
      *reinterpret_cast<uint4*>(vd) = *reinterpret_cast<const uint4*>(vnh + v);
    } else {
      cp_async16(kd, (pos == idx ? knh : rows.krow(pos)) + v);
      cp_async16(vd, (pos == idx ? vnh : rows.vrow(pos)) + v);
    }
  }
  cp_async_commit();
}

// Attend one (slot, kv head): q_rows [rep][dh] and out_rows [rep][dh] in
// global memory. knh/vnh is the new token's row (position idx, in S), with
// its scales kn_s/vn_s when S is an 8-bit payload. Rows provides
// krow/vrow(pos) pointers and, for 8-bit payloads, kscale/vscale(pos).
template <typename T, typename S, bool kNewInSmem, class Rows>
__device__ __forceinline__ void attend(const T* __restrict__ q_rows, const Rows& rows,
                                       const S* knh, const S* vnh, float kn_s,
                                       float vn_s, int idx, int n_pos,
                                       T* __restrict__ out_rows, int rep, int dh,
                                       int cs, float scale, unsigned char* smem) {
  using L = Load<T, S>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t buf_elems = (size_t)cs * dh;
  S* k_sh = reinterpret_cast<S*>(smem);            // [2][cs][dh]
  S* v_sh = k_sh + 2 * buf_elems;                  // [2][cs][dh]
  float* q_sh = reinterpret_cast<float*>(v_sh + 2 * buf_elems);  // [rep][dh]
  float* p_sh = q_sh + rep * dh;                   // [rep][cs] scores, then probs
  float* m_sh = p_sh + rep * cs;                   // [rep] running max
  float* l_sh = m_sh + rep;                        // [rep] running sum
  float* c_sh = l_sh + rep;                        // [rep] this chunk's rescale
  float* ks_sh = c_sh + rep;                       // [2][cs] row scales (8-bit)
  float* vs_sh = ks_sh + 2 * cs;                   // [2][cs]

  // row `pos`'s scales (8-bit payloads only)
  auto kscale = [&](int pos) { return pos == idx ? kn_s : rows.kscale(pos); };
  auto vscale = [&](int pos) { return pos == idx ? vn_s : rows.vscale(pos); };

  // 1. the first chunk's copies start; the rep query rows and the softmax
  // state meanwhile
  const int n_chunks = n_pos > 0 ? (n_pos + cs - 1) / cs : 0;
  if (n_chunks > 0) {
    const int cn0 = min(cs, n_pos);
    stage_chunk<S, kNewInSmem>(k_sh, v_sh, rows, knh, vnh, 0, cn0, idx, dh);
    if constexpr (L::kQuant) {
      if (tid < cn0) {
        ks_sh[tid] = kscale(tid);
        vs_sh[tid] = vscale(tid);
      }
    }
  }
  for (int i = tid; i < rep * dh; i += kThreads) q_sh[i] = to_f32(q_rows[i]);
  if (tid < rep) {
    m_sh[tid] = -CUDART_INF_F;
    l_sh[tid] = 0.f;
  }
  float acc[kMaxPerThread];
#pragma unroll
  for (int j = 0; j < kMaxPerThread; ++j) acc[j] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * cs, cn = min(cs, n_pos - c0);
    const size_t cur = (size_t)(c & 1) * buf_elems, nxt = buf_elems - cur;
    const int scur = (c & 1) * cs, snxt = cs - scur;
    // 2. the next chunk's copies (and scale loads) go out; wait for this one's
    const int cn1 = c + 1 < n_chunks ? min(cs, n_pos - c0 - cs) : 0;
    float ks_next = 0.f, vs_next = 0.f;
    if (cn1 > 0) {
      stage_chunk<S, kNewInSmem>(k_sh + nxt, v_sh + nxt, rows, knh, vnh, c0 + cs,
                                 cn1, idx, dh);
      if constexpr (L::kQuant) {
        if (tid < cn1) {
          ks_next = kscale(c0 + cs + tid);
          vs_next = vscale(c0 + cs + tid);
        }
      }
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this chunk (and q/state) visible to every thread
    const S* kb = k_sh + cur;
    const S* vb = v_sh + cur;
    const float* ksc = ks_sh + scur;
    const float* vsc = vs_sh + scur;
    // 3. scores, one warp per position
    for (int p = warp; p < cn; p += kWarps) {
      const S* krow = kb + (size_t)p * dh;
      const float kps = L::kQuant ? ksc[p] : 0.f;
      for (int r = 0; r < rep; ++r) {
        float part = 0.f;
        for (int i = lane; i < dh; i += 32)
          part = fmaf(q_sh[r * dh + i], L::f(krow[i], kps), part);
        part = warp_sum(part);
        if (lane == 0) p_sh[r * cs + p] = part * scale;
      }
    }
    __syncthreads();
    // 4. online softmax update, one warp per query row
    for (int r = warp; r < rep; r += kWarps) {
      float mx = -CUDART_INF_F;
      for (int p = lane; p < cn; p += 32) mx = fmaxf(mx, p_sh[r * cs + p]);
      mx = warp_max(mx);
      const float m_old = m_sh[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int p = lane; p < cn; p += 32) {
        const float e = expf(p_sh[r * cs + p] - m_new);
        p_sh[r * cs + p] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);  // 0 on the first chunk
        c_sh[r] = corr;
        l_sh[r] = l_sh[r] * corr + sum;
        m_sh[r] = m_new;
      }
    }
    __syncthreads();
    // 5. P.V with p rounded to T; each thread owns (row, col)s
#pragma unroll
    for (int j = 0; j < kMaxPerThread; ++j) {
      const int i = tid + j * kThreads;
      if (i < rep * dh) {
        const int r = i / dh, col = i % dh;
        const float* prow = p_sh + r * cs;
        float a = acc[j] * c_sh[r];
        for (int p = 0; p < cn; ++p) {
          const float pb = to_f32(from_f32<T>(prow[p]));
          const float vps = L::kQuant ? vsc[p] : 0.f;
          a = fmaf(pb, L::f(vb[(size_t)p * dh + col], vps), a);
        }
        acc[j] = a;
      }
    }
    if constexpr (L::kQuant) {
      if (tid < cn1) {  // the next chunk's scales, into the free buffer
        ks_sh[snxt + tid] = ks_next;
        vs_sh[snxt + tid] = vs_next;
      }
    }
    __syncthreads();  // this buffer is restaged by the next iteration
  }
  // 6. normalise and cast once
#pragma unroll
  for (int j = 0; j < kMaxPerThread; ++j) {
    const int i = tid + j * kThreads;
    if (i < rep * dh) out_rows[i] = from_f32<T>(acc[j] / fmaxf(l_sh[i / dh], 1e-20f));
  }
}

}  // namespace attend
}  // namespace dst

// Fused single-token decode step: write the new token's K/V into the stacked
// cache in place, then attend over each slot's valid prefix.
//
// Replaces the TPU kernel deepspeed_tpu/ops/decode_step.py:_kernel
// (fused_decode_step). Bound on the H100: bytes. Each (slot, kv head) reads
// its valid K and V prefix once, 2 * (min(idx, S-1) + 1) * Dh elements, and
// the scores and probabilities stay on chip; at LLaMA-7B widths the math is
// a few FLOP per byte, far under the card's ~295 FLOP/byte ridge.
//
// Design (a simple form that is right; split-K flash-decoding is later work):
//  * One block per (kv head, slot): 8 slots x 32 heads = 256 blocks at
//    LLaMA-7B, enough to fill 132 SMs. Rows never mix, so a slot's result is
//    bit-identical whatever the other slots hold.
//  * The block first writes k_new/v_new into row idx[b] of its own cache head
//    and drops the write when idx[b] >= S (write_kv_cache(mode="drop")
//    semantics; the TPU kernel's 8-row window write at :197 has no such
//    guard). Reads never depend on that write landing: the staged chunk takes
//    row idx[b] from k_new/v_new directly (the TPU kernel's in-register
//    splice, :314-352).
//  * The valid prefix 0..min(idx, S-1) is walked in chunks of K and V rows
//    copied into shared memory with cp.async (16 bytes a copy, no registers
//    held), double-buffered: the next chunk's copies are in flight while the
//    block computes on this one, which is what keeps HBM streaming (the TPU
//    kernel's make_async_copy double buffer). Scores: products of the stored
//    values summed in f32, then times `scale`; online softmax over (m, l, acc)
//    in f32; probabilities are rounded to the cache dtype before P.V (:399)
//    and the output is acc / max(l, 1e-20), cast once (:418-420).
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPerThread = 16;  // rep * dh <= kThreads * kMaxPerThread

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copies of K and V rows c0..c0+cn-1 of one head into shared
// memory (row idx from k_new/v_new) as one cp.async group.
template <typename T>
__device__ __forceinline__ void stage_chunk(T* k_dst, T* v_dst, const T* kh, const T* vh,
                                            const T* knh, const T* vnh, int c0, int cn,
                                            int idx, int dh) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte copy
  const int vpr = dh / kVec;
  for (int i = threadIdx.x; i < cn * vpr; i += kThreads) {
    const int p = i / vpr, v = (i - p * vpr) * kVec;
    const int pos = c0 + p;
    const T* ks = pos == idx ? knh : kh + (size_t)pos * dh;
    const T* vs = pos == idx ? vnh : vh + (size_t)pos * dh;
    cp_async16(k_dst + (size_t)p * dh + v, ks + v);
    cp_async16(v_dst + (size_t)p * dh + v, vs + v);
  }
  cp_async_commit();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_decode_step_kernel(const T* __restrict__ q, T* kc, T* vc,
                         const T* __restrict__ kn, const T* __restrict__ vn,
                         T* __restrict__ out, const int* __restrict__ idx_vec,
                         int idx_scalar, int layer, int nb, int hq, int hkv,
                         int s_max, int dh, int cs, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int rep = hq / hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t buf_elems = (size_t)cs * dh;
  T* k_sh = reinterpret_cast<T*>(smem_raw);       // [2][cs][dh]
  T* v_sh = k_sh + 2 * buf_elems;                 // [2][cs][dh]
  float* q_sh = reinterpret_cast<float*>(v_sh + 2 * buf_elems);  // [rep][dh]
  float* p_sh = q_sh + rep * dh;                  // [rep][cs] scores, then probs
  float* m_sh = p_sh + rep * cs;                  // [rep] running max
  float* l_sh = m_sh + rep;                       // [rep] running sum
  float* c_sh = l_sh + rep;                       // [rep] this chunk's rescale

  const int idx = idx_vec ? idx_vec[b] : idx_scalar;
  const size_t head = (((size_t)layer * nb + b) * hkv + kvh) * (size_t)s_max * dh;
  T* kh = kc + head;
  T* vh = vc + head;
  const T* knh = kn + ((size_t)b * hkv + kvh) * dh;
  const T* vnh = vn + ((size_t)b * hkv + kvh) * dh;

  // 1. the cache write, dropped past the allocation
  if (idx >= 0 && idx < s_max) {
    for (int i = tid; i < dh; i += kThreads) {
      kh[(size_t)idx * dh + i] = knh[i];
      vh[(size_t)idx * dh + i] = vnh[i];
    }
  }
  // 2. the first chunk's copies start; this kv head's rep query rows and the
  // softmax state meanwhile
  const int n_pos = min(idx, s_max - 1) + 1;  // positions 0..min(idx, S-1)
  const int n_chunks = n_pos > 0 ? (n_pos + cs - 1) / cs : 0;
  if (n_chunks > 0) stage_chunk(k_sh, v_sh, kh, vh, knh, vnh, 0, min(cs, n_pos), idx, dh);
  for (int i = tid; i < rep * dh; i += kThreads)
    q_sh[i] = dst::to_f32(q[((size_t)b * hq + (size_t)kvh * rep) * dh + i]);
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
    // 3. the next chunk's copies go out; wait for this one's
    if (c + 1 < n_chunks) {
      stage_chunk(k_sh + nxt, v_sh + nxt, kh, vh, knh, vnh, c0 + cs,
                  min(cs, n_pos - c0 - cs), idx, dh);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this chunk (and q/state) visible to every thread
    const T* kb = k_sh + cur;
    const T* vb = v_sh + cur;
    // 4. scores, one warp per position
    for (int p = warp; p < cn; p += kWarps) {
      const T* krow = kb + (size_t)p * dh;
      for (int r = 0; r < rep; ++r) {
        float part = 0.f;
        for (int i = lane; i < dh; i += 32)
          part = fmaf(q_sh[r * dh + i], dst::to_f32(krow[i]), part);
        part = dst::warp_sum(part);
        if (lane == 0) p_sh[r * cs + p] = part * scale;
      }
    }
    __syncthreads();
    // 5. online softmax update, one warp per query row
    for (int r = warp; r < rep; r += kWarps) {
      float mx = -CUDART_INF_F;
      for (int p = lane; p < cn; p += 32) mx = fmaxf(mx, p_sh[r * cs + p]);
      mx = dst::warp_max(mx);
      const float m_old = m_sh[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int p = lane; p < cn; p += 32) {
        const float e = expf(p_sh[r * cs + p] - m_new);
        p_sh[r * cs + p] = e;
        sum += e;
      }
      sum = dst::warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);  // 0 on the first chunk
        c_sh[r] = corr;
        l_sh[r] = l_sh[r] * corr + sum;
        m_sh[r] = m_new;
      }
    }
    __syncthreads();
    // 6. P.V with p rounded to the cache dtype; each thread owns (row, col)s
#pragma unroll
    for (int j = 0; j < kMaxPerThread; ++j) {
      const int i = tid + j * kThreads;
      if (i < rep * dh) {
        const int r = i / dh, col = i % dh;
        const float* prow = p_sh + r * cs;
        float a = acc[j] * c_sh[r];
        for (int p = 0; p < cn; ++p) {
          const float pb = dst::to_f32(dst::from_f32<T>(prow[p]));
          a = fmaf(pb, dst::to_f32(vb[(size_t)p * dh + col]), a);
        }
        acc[j] = a;
      }
    }
    __syncthreads();  // this buffer is restaged by the next iteration
  }
  // 7. normalise and cast once
  T* orow = out + ((size_t)b * hq + (size_t)kvh * rep) * dh;
#pragma unroll
  for (int j = 0; j < kMaxPerThread; ++j) {
    const int i = tid + j * kThreads;
    if (i < rep * dh) orow[i] = dst::from_f32<T>(acc[j] / fmaxf(l_sh[i / dh], 1e-20f));
  }
}

template <typename T>
cudaError_t launch(const void* q, void* kc, void* vc, const void* kn, const void* vn,
                   void* out, const int* idx_vec, int idx_scalar, int layer, int nb,
                   int hq, int hkv, int s_max, int dh, float scale, cudaStream_t st) {
  const int rep = hq / hkv;
  // chunk rows: one buffer of K + V rows stays within 32 KB (two in flight)
  int cs = 16384 / (dh * (int)sizeof(T));
  cs = cs > 64 ? 64 : (cs < 8 ? 8 : cs);
  const size_t smem = 4 * (size_t)cs * dh * sizeof(T)
                    + ((size_t)rep * dh + (size_t)rep * cs + 3 * (size_t)rep) * sizeof(float);
  // raise the dynamic shared-memory cap once per size (before any graph
  // capture: the first call of a shape is never captured)
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(fused_decode_step_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  dim3 grid(hkv, nb);
  fused_decode_step_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<T*>(kc), static_cast<T*>(vc),
      static_cast<const T*>(kn), static_cast<const T*>(vn), static_cast<T*>(out),
      idx_vec, idx_scalar, layer, nb, hq, hkv, s_max, dh, cs, scale);
  return cudaGetLastError();
}

}  // namespace

// q [B, Hq, Dh]; k/v caches [L, B, Hkv, S, Dh] (updated in place);
// k_new/v_new [B, Hkv, Dh]; out [B, Hq, Dh]; idx: int32 [B] on the device,
// or null with idx_scalar used for every slot.
extern "C" int dst_fused_decode_step(const void* q, void* k, void* v,
                                     const void* k_new, const void* v_new,
                                     void* out, const void* idx, int idx_scalar,
                                     int layer, int b, int hq, int hkv, int s_max,
                                     int dh, float scale, int dtype, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || (hq / hkv) * dh > kThreads * kMaxPerThread)
    return cudaErrorInvalidValue;
  const int* iv = static_cast<const int*>(idx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case dst::kF32:
      return launch<float>(q, k, v, k_new, v_new, out, iv, idx_scalar, layer, b, hq,
                           hkv, s_max, dh, scale, st);
    case dst::kF16:
      return launch<__half>(q, k, v, k_new, v_new, out, iv, idx_scalar, layer, b, hq,
                            hkv, s_max, dh, scale, st);
    case dst::kBF16:
      return launch<__nv_bfloat16>(q, k, v, k_new, v_new, out, iv, idx_scalar, layer, b,
                                   hq, hkv, s_max, dh, scale, st);
  }
  return cudaErrorInvalidValue;
}

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
//  * The valid prefix 0..min(idx, S-1) is walked by the attention body
//    shared with the block-pool kernel (decode_attend.cuh): K/V chunks
//    copied into shared memory with cp.async, double-buffered, so HBM keeps
//    streaming while the block computes (the TPU kernel's make_async_copy
//    double buffer). Scores: products of the stored values summed in f32,
//    then times `scale`; online softmax over (m, l, acc) in f32;
//    probabilities are rounded to the cache dtype before P.V (:399) and the
//    output is acc / max(l, 1e-20), cast once (:418-420).
#include "decode_attend.cuh"

namespace {

using namespace dst::attend;

// Rows of one contiguous [S, Dh] cache head.
template <typename T>
struct SlotRows {
  const T* k;
  const T* v;
  int dh;
  __device__ const T* krow(int pos) const { return k + (size_t)pos * dh; }
  __device__ const T* vrow(int pos) const { return v + (size_t)pos * dh; }
  __device__ float kscale(int) const { return 0.f; }  // unquantized
  __device__ float vscale(int) const { return 0.f; }
};

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
  const int idx = idx_vec ? idx_vec[b] : idx_scalar;
  const size_t head = (((size_t)layer * nb + b) * hkv + kvh) * (size_t)s_max * dh;
  T* kh = kc + head;
  T* vh = vc + head;
  const T* knh = kn + ((size_t)b * hkv + kvh) * dh;
  const T* vnh = vn + ((size_t)b * hkv + kvh) * dh;

  // 1. the cache write, dropped past the allocation
  if (idx >= 0 && idx < s_max) {
    for (int i = threadIdx.x; i < dh; i += kThreads) {
      kh[(size_t)idx * dh + i] = knh[i];
      vh[(size_t)idx * dh + i] = vnh[i];
    }
  }
  // 2. attend over positions 0..min(idx, S-1)
  const int n_pos = min(idx, s_max - 1) + 1;
  const size_t qo = ((size_t)b * hq + (size_t)kvh * rep) * dh;
  attend<T, T, false>(q + qo, SlotRows<T>{kh, vh, dh}, knh, vnh, 0.f, 0.f, idx,
                      n_pos, out + qo, rep, dh, cs, scale, smem_raw);
}

template <typename T>
cudaError_t launch(const void* q, void* kc, void* vc, const void* kn, const void* vn,
                   void* out, const int* idx_vec, int idx_scalar, int layer, int nb,
                   int hq, int hkv, int s_max, int dh, float scale, cudaStream_t st) {
  const int rep = hq / hkv;
  const int cs = chunk_rows<T>(dh);
  const size_t smem = smem_bytes<T>(rep, dh, cs, false);
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
  if (hkv <= 0 || hq % hkv != 0 ||
      (hq / hkv) * dh > dst::attend::kThreads * dst::attend::kMaxPerThread)
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

// Fused single-token decode step against the block-paged KV pool: write the
// new token's K/V through the slot's block table (quantized on store for an
// int8/fp8 pool), then attend over the slot's valid prefix.
//
// Replaces the TPU kernel deepspeed_tpu/ops/decode_step.py:_block_kernel
// (fused_block_decode_step). Bound on the H100: bytes. Each (slot, kv head)
// reads its valid K and V prefix once, 2 * (idx + 1) * Dh stored elements (1
// byte each for an 8-bit pool, plus one 2-byte scale per row), and the scores
// and probabilities stay on chip; the math is a few FLOP per byte, far under
// the card's ~295 FLOP/byte ridge. An 8-bit pool halves the bytes of a bf16
// one, which is its point.
//
// Design (kernel B's, decode_step.cu, with table-addressed rows):
//  * One block per (kv head, slot). The block copies its slot's table row
//    into shared memory once, so a row's address costs a shared-memory read,
//    not a global one.
//  * The write: position p = idx[b] lives in pool row table[b, p / bs], row
//    p % bs; a p / bs past the table width goes to the garbage row N (the
//    einsum path's write_kv_blocks; the TPU kernel clamps to the last table
//    entry instead). An 8-bit pool quantizes the row exactly as
//    serving/kv_quant.kv_quantize_keepdims does: amax over Dh in f32,
//    s = bf16(max(amax / qmax, 1e-8)), y = x / f32(s), then int8
//    clip(rint(y), +-127) or fp8 e4m3 round-to-nearest with saturation. The
//    IEEE divide and rintf are why this file must not be built with fast
//    math: payloads and scales are bit-identical to the plain version's.
//  * The walk (decode_attend.cuh): positions 0..min(p, MB*bs - 1), copied
//    chunk by chunk into shared memory with cp.async, double-buffered. Row p
//    comes from the new values (an 8-bit pool: its quantized payload, staged
//    from shared memory, and its scale), never from the pool, so no read
//    waits on the write: the TPU kernel's splice of the dequantized image.
//  * Races: inactive slots all name the garbage row, so several blocks may
//    write it at once; their outputs are discarded. Active slots never share
//    a written block (shared prefix blocks are read-only; the copy-on-write
//    fork happens at admission).
#include "decode_attend.cuh"

namespace {

using namespace dst::attend;
using bf16 = __nv_bfloat16;

// Rows of one (slot, kv head) through the slot's table row (in shared memory).
template <typename S>
struct BlockRows {
  const S* k;          // payload pool at [layer, 0, kvh, 0, 0]
  const S* v;
  const bf16* ks;      // scale pool at [layer, 0, kvh, 0] (8-bit pools)
  const bf16* vs;
  const int* tbl;      // [mb] physical block of each logical block
  int bs, dh;
  size_t blk_stride;   // elements from one pool block to the next (Hkv*bs*Dh)
  size_t sblk_stride;  // scales from one pool block to the next (Hkv*bs)
  __device__ size_t row(int pos) const {
    return (size_t)tbl[pos / bs] * blk_stride + (size_t)(pos % bs) * dh;
  }
  __device__ size_t srow(int pos) const {
    return (size_t)tbl[pos / bs] * sblk_stride + pos % bs;
  }
  __device__ const S* krow(int pos) const { return k + row(pos); }
  __device__ const S* vrow(int pos) const { return v + row(pos); }
  __device__ float kscale(int pos) const { return __bfloat162float(ks[srow(pos)]); }
  __device__ float vscale(int pos) const { return __bfloat162float(vs[srow(pos)]); }
};

template <typename S>
struct Quant;
template <>
struct Quant<int8_t> {
  static constexpr float kQmax = 127.f;
  __device__ static int8_t q(float y) {
    return static_cast<int8_t>(fminf(fmaxf(rintf(y), -127.f), 127.f));
  }
};
template <>
struct Quant<fp8_t> {
  static constexpr float kQmax = 448.f;
  __device__ static fp8_t q(float y) {
    return __nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3);
  }
};

// max over the block of one value per thread (red: kWarps floats)
__device__ float block_max(float v, float* red) {
  v = dst::warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  return m;
}

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
fused_block_decode_step_kernel(const T* __restrict__ q, S* kp, S* vp, bf16* ksp, bf16* vsp,
                               const T* __restrict__ kn, const T* __restrict__ vn,
                               T* __restrict__ out, const int* __restrict__ idx_vec,
                               const int* __restrict__ table, int layer, int hq, int hkv,
                               int n_phys, int bs, int mb, int dh, int cs, float scale,
                               size_t attend_smem) {
  using L = Load<T, S>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kvh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int rep = hq / hkv;
  int* tbl_sh = reinterpret_cast<int*>(smem_raw + attend_smem);           // [mb]
  S* kq_sh = reinterpret_cast<S*>(smem_raw + attend_smem + (mb * 4 + 15) / 16 * 16);
  S* vq_sh = kq_sh + dh;                                                  // [dh] each
  float* red = reinterpret_cast<float*>(vq_sh + dh);                      // [kWarps]

  const int p = idx_vec[b];
  for (int i = tid; i < mb; i += kThreads) tbl_sh[i] = table[(size_t)b * mb + i];
  const int jb = p / bs;
  const int pb = jb < mb ? table[(size_t)b * mb + jb] : n_phys - 1;  // overflow: garbage
  const size_t blk_stride = (size_t)hkv * bs * dh;
  const size_t layer_off = (size_t)layer * n_phys * blk_stride + (size_t)kvh * bs * dh;
  const size_t sblk_stride = (size_t)hkv * bs;
  const size_t slayer_off = (size_t)layer * n_phys * sblk_stride + (size_t)kvh * bs;
  const size_t wrow = layer_off + (size_t)pb * blk_stride + (size_t)(p % bs) * dh;
  const T* knh = kn + ((size_t)b * hkv + kvh) * dh;
  const T* vnh = vn + ((size_t)b * hkv + kvh) * dh;

  // 1. the write of row p (quantized on store for an 8-bit pool)
  float kn_s = 0.f, vn_s = 0.f;
  if constexpr (L::kQuant) {
    float ka = 0.f, va = 0.f;
    for (int i = tid; i < dh; i += kThreads) {
      ka = fmaxf(ka, fabsf(dst::to_f32(knh[i])));
      va = fmaxf(va, fabsf(dst::to_f32(vnh[i])));
    }
    ka = block_max(ka, red);
    __syncthreads();  // red is reused
    va = block_max(va, red);
    const bf16 ksb = __float2bfloat16_rn(fmaxf(ka / Quant<S>::kQmax, 1e-8f));
    const bf16 vsb = __float2bfloat16_rn(fmaxf(va / Quant<S>::kQmax, 1e-8f));
    kn_s = __bfloat162float(ksb);
    vn_s = __bfloat162float(vsb);
    for (int i = tid; i < dh; i += kThreads) {
      const S kqv = Quant<S>::q(dst::to_f32(knh[i]) / kn_s);
      const S vqv = Quant<S>::q(dst::to_f32(vnh[i]) / vn_s);
      kq_sh[i] = kqv;
      vq_sh[i] = vqv;
      kp[wrow + i] = kqv;
      vp[wrow + i] = vqv;
    }
    if (tid == 0) {
      const size_t srow = slayer_off + (size_t)pb * sblk_stride + p % bs;
      ksp[srow] = ksb;
      vsp[srow] = vsb;
    }
  } else {
    for (int i = tid; i < dh; i += kThreads) {
      kp[wrow + i] = knh[i];
      vp[wrow + i] = vnh[i];
    }
  }
  __syncthreads();  // the table row and the quantized new row are visible

  // 2. attend over positions 0..min(p, MB*bs - 1)
  const int n_pos = min(p, mb * bs - 1) + 1;
  const BlockRows<S> rows{kp + layer_off, vp + layer_off,
                          L::kQuant ? ksp + slayer_off : nullptr,
                          L::kQuant ? vsp + slayer_off : nullptr,
                          tbl_sh, bs, dh, blk_stride, sblk_stride};
  const size_t qo = ((size_t)b * hq + (size_t)kvh * rep) * dh;
  if constexpr (L::kQuant) {
    attend<T, S, true>(q + qo, rows, kq_sh, vq_sh, kn_s, vn_s, p, n_pos, out + qo, rep,
                       dh, cs, scale, smem_raw);
  } else {
    attend<T, S, false>(q + qo, rows, reinterpret_cast<const S*>(knh),
                        reinterpret_cast<const S*>(vnh), 0.f, 0.f, p, n_pos, out + qo,
                        rep, dh, cs, scale, smem_raw);
  }
}

template <typename T, typename S>
cudaError_t launch(const void* q, void* kp, void* vp, void* ksp, void* vsp, const void* kn,
                   const void* vn, void* out, const int* idx, const int* table, int layer,
                   int b, int hq, int hkv, int n_phys, int bs, int mb, int dh, float scale,
                   cudaStream_t st) {
  constexpr bool quant = Load<T, S>::kQuant;
  const int rep = hq / hkv;
  const int cs = chunk_rows<S>(dh);
  const size_t attend_smem = smem_bytes<S>(rep, dh, cs, quant);
  const size_t smem = attend_smem + (mb * 4 + 15) / 16 * 16 + 2 * (size_t)dh * sizeof(S)
                    + kWarps * sizeof(float);
  // raise the dynamic shared-memory cap once per size (before any graph
  // capture: the first call of a shape is never captured)
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(fused_block_decode_step_kernel<T, S>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  dim3 grid(hkv, b);
  fused_block_decode_step_kernel<T, S><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<S*>(kp), static_cast<S*>(vp),
      static_cast<bf16*>(ksp), static_cast<bf16*>(vsp), static_cast<const T*>(kn),
      static_cast<const T*>(vn), static_cast<T*>(out), idx, table, layer, hq, hkv, n_phys,
      bs, mb, dh, cs, scale, attend_smem);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_kv(int kv, const void* q, void* kp, void* vp, void* ksp, void* vsp,
                      const void* kn, const void* vn, void* out, const int* idx,
                      const int* table, int layer, int b, int hq, int hkv, int n_phys, int bs,
                      int mb, int dh, float scale, cudaStream_t st) {
  switch (kv) {
    case 0:
      return launch<T, T>(q, kp, vp, ksp, vsp, kn, vn, out, idx, table, layer, b, hq, hkv,
                          n_phys, bs, mb, dh, scale, st);
    case 1:
      return launch<T, int8_t>(q, kp, vp, ksp, vsp, kn, vn, out, idx, table, layer, b, hq,
                               hkv, n_phys, bs, mb, dh, scale, st);
    case 2:
      return launch<T, fp8_t>(q, kp, vp, ksp, vsp, kn, vn, out, idx, table, layer, b, hq,
                              hkv, n_phys, bs, mb, dh, scale, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B, Hq, Dh]; pools [L, N+1, Hkv, bs, Dh] (row N is the garbage row),
// updated in place, in the compute type (kv 0) or int8 (kv 1) / fp8 e4m3
// (kv 2) payloads with bf16 scales [L, N+1, Hkv, bs] (ks/vs, else null);
// k_new/v_new [B, Hkv, Dh]; out [B, Hq, Dh]; idx int32 [B] and table int32
// [B, MB] on the device.
extern "C" int dst_fused_block_decode_step(const void* q, void* k, void* v, void* ks,
                                           void* vs, const void* k_new, const void* v_new,
                                           void* out, const void* idx, const void* table,
                                           int layer, int b, int hq, int hkv, int n_phys,
                                           int bs, int mb, int dh, float scale, int dtype,
                                           int kv, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || bs <= 0 || mb <= 0 ||
      (hq / hkv) * dh > dst::attend::kThreads * dst::attend::kMaxPerThread ||
      (kv != 0 && (!ks || !vs)))
    return cudaErrorInvalidValue;
  const int* iv = static_cast<const int*>(idx);
  const int* tb = static_cast<const int*>(table);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case dst::kF32:
      return launch_kv<float>(kv, q, k, v, ks, vs, k_new, v_new, out, iv, tb, layer, b, hq,
                              hkv, n_phys, bs, mb, dh, scale, st);
    case dst::kF16:
      return launch_kv<__half>(kv, q, k, v, ks, vs, k_new, v_new, out, iv, tb, layer, b,
                               hq, hkv, n_phys, bs, mb, dh, scale, st);
    case dst::kBF16:
      return launch_kv<__nv_bfloat16>(kv, q, k, v, ks, vs, k_new, v_new, out, iv, tb,
                                      layer, b, hq, hkv, n_phys, bs, mb, dh, scale, st);
  }
  return cudaErrorInvalidValue;
}

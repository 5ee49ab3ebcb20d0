// Kernel C's C entry point and its compute-type pool instantiations; the
// kernel is block_decode_step.cuh (the notes on its design are there).
#include "block_decode_step.cuh"

namespace dst {
namespace blockstep {

// pools in the compute type here; 8-bit pools in their own sources
template cudaError_t launch_pool<float, float>(const Ptrs&, const Geometry&, cudaStream_t);
template cudaError_t launch_pool<__half, __half>(const Ptrs&, const Geometry&, cudaStream_t);
template cudaError_t launch_pool<__nv_bfloat16, __nv_bfloat16>(const Ptrs&, const Geometry&,
                                                               cudaStream_t);
DST_BLOCKSTEP_POOL(extern, int8_t)
DST_BLOCKSTEP_POOL(extern, fp8_t)

}  // namespace blockstep
}  // namespace dst

namespace {

template <typename T>
cudaError_t by_pool(int kv, const dst::blockstep::Ptrs& p, const dst::blockstep::Geometry& geo,
                    cudaStream_t st) {
  using dst::blockstep::launch_pool;
  switch (kv) {
    case 0:
      return launch_pool<T, T>(p, geo, st);
    case 1:
      return launch_pool<T, int8_t>(p, geo, st);
    case 2:
      return launch_pool<T, dst::split::fp8_t>(p, geo, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B, Hq, Dh]; pools [L, N+1, Hkv, bs, Dh] (row N is the garbage row),
// updated in place, in the compute type (kv 0) or int8 (kv 1) / fp8 e4m3
// (kv 2) payloads with bf16 scales [L, N+1, Hkv, bs] (ks/vs, else null);
// k_new/v_new [B, Hkv, Dh]; out [B, Hq, Dh]; idx int32 [B] and table int32
// [B, MB] on the device. The prefix is split in `chunk` positions, n_splits
// = ceil(MB*bs / chunk); with n_splits > 1, ml [B, Hq, n_splits, 2] and acc
// [B, Hq, n_splits, Dh] f32 are scratch.
extern "C" int dst_fused_block_decode_step(const void* q, void* k, void* v, void* ks,
                                           void* vs, const void* k_new, const void* v_new,
                                           void* out, void* ml, void* acc, const void* idx,
                                           const void* table, int layer, int b, int hq,
                                           int hkv, int n_phys, int bs, int mb, int dh,
                                           int chunk, int n_splits, float scale, int dtype,
                                           int kv, void* stream) {
  using dst::split::kMaxPerThread;
  using dst::split::kThreads;
  const int esz = dtype == dst::kF32 ? 4 : 2;
  if (hkv <= 0 || hq % hkv != 0 || bs <= 0 || bs > 1024 || mb <= 0 || mb * bs > (1 << 20) ||
      dh <= 0 || b <= 0 || b > 65535 ||
      hkv > 65535 || (hq / hkv) * dh > kThreads * kMaxPerThread || chunk <= 0 ||
      n_splits != (mb * bs + chunk - 1) / chunk || (dh * (kv ? 1 : esz)) % 16 != 0 ||
      (kv != 0 && (!ks || !vs)) || (n_splits > 1 && (!ml || !acc)))
    return cudaErrorInvalidValue;
  using namespace dst::blockstep;
  const Ptrs p{q, k_new, v_new, k, v, ks, vs, out, static_cast<float*>(ml),
               static_cast<float*>(acc)};
  const Geometry geo{static_cast<const int*>(idx), static_cast<const int*>(table), layer, b,
                     hq, hkv, n_phys, bs, mb, dh, chunk, n_splits, scale,
                     ((1ull << 40) + bs - 1) / bs, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case dst::kF32:
      return by_pool<float>(kv, p, geo, st);
    case dst::kF16:
      return by_pool<__half>(kv, p, geo, st);
    case dst::kBF16:
      return by_pool<__nv_bfloat16>(kv, p, geo, st);
  }
  return cudaErrorInvalidValue;
}

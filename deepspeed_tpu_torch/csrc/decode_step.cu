// Fused single-token decode step: write the new token's K/V into the stacked
// cache in place, then attend over each slot's valid prefix, split along the
// cache across blocks and merged.
//
// Replaces the TPU kernel deepspeed_tpu/ops/decode_step.py:_kernel
// (fused_decode_step). Bound on the H100: bytes. Each (slot, kv head) reads
// its valid K and V prefix once, 2 * (min(idx, S-1) + 1) * Dh elements, and
// the scores and probabilities stay on chip; at LLaMA-7B widths the math is
// a few FLOP per byte, far under the card's ~295 FLOP/byte ridge.
//
// Design (the attention body is decode_split.cuh), against what held the
// first form of this kernel back (one block per (kv head, slot) walking the
// prefix with scores on the CUDA cores):
//  * Too few blocks: the grid is (split, kv head, slot). Each block takes
//    `chunk` positions, chosen by the wrapper (decode_step.split_plan,
//    flash-decode's plan too) from B, Hkv, S and the body alone: on the
//    tensor cores the grid at full S holds at most one block per SM, longer
//    chunks streaming through the ring (CodeLlama-34B at batch 4: 96 blocks
//    of 256 positions where the first form had 32 blocks). A block whose first
//    position lies past min(idx[b], S-1) returns before reading anything,
//    so bytes follow idx, not S. merge_splits then merges each query row's
//    live splits in split order: no atomics, results repeat bit for bit.
//    Scratch for the partials comes from the wrapper (torch.empty on the
//    current stream), so a call can be captured in a CUDA graph; idx is read
//    on the device (or passed by value), never by the host.
//  * Scores through shuffles: for bf16/fp16 at Dh 64/128/256 both products
//    run on the tensor cores, the rep query rows as the n dimension of
//    mma.m16n8k16 (Q^T held in registers for the walk, K and V by
//    ldmatrix), and P^T comes from the score fragments by an in-register
//    transpose.
//  * P.V as a serial walk: it is one mma per 16 Dh x 16 positions x 8 rows.
//  * Three barriers per 64-row chunk, two chunks in flight: one barrier per
//    64-position stage, three stages of cp.async in flight (two at Dh 256);
//    with four or more blocks per SM that keeps well over 25 KB per SM
//    moving at 3.35 TB/s.
//  f32, and a Dh of another size, take the CUDA-core body with the same
//  split and merge.
//
//  The write: exactly one block writes row idx[b] of the cache, the split
//  whose range holds idx, and the write is dropped when idx >= S
//  (write_kv_cache(mode="drop") semantics; the TPU kernel's 8-row window
//  write at :197 has no such guard). Every read of position idx takes the
//  row from k_new/v_new (the TPU kernel's in-register splice, :314-352), so
//  no read waits on the write.
#include "decode_split.cuh"

namespace {

using namespace dst::split;

// Rows of one contiguous [S, Dh] cache head; position idx reads the new
// token's row (decode_split.cuh's row policy).
template <typename T>
struct SlotRows {
  static constexpr bool kRaw = false;
  using Elem = T;
  const T* k;
  const T* v;
  const T* kn;
  const T* vn;
  int idx, dh;
  __device__ bool at(int pos, const T*& kr, const T*& vr) const {
    kr = k + (size_t)pos * dh;
    vr = v + (size_t)pos * dh;
    return pos == idx;
  }
  __device__ bool fresh(int pos) const { return pos == idx; }
};

struct Geometry {
  const int* idx_vec;
  int idx_scalar, layer, nb, hq, hkv, s_max, dh, chunk, n_splits;
  float scale;
};

// DH > 0: the tensor-core body at that Dh with NT n-tiles of query rows;
// DH == 0: the CUDA-core body at geo.dh.
template <typename T, int DH, int NT>
__global__ void __launch_bounds__(kThreads)
fused_decode_step_split(const T* __restrict__ q, T* kc, T* vc, const T* __restrict__ kn,
                        const T* __restrict__ vn, T* __restrict__ out, float* part_ml,
                        float* part_acc, Geometry geo) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int rep = geo.hq / geo.hkv, dh = DH > 0 ? DH : geo.dh;
  const int idx = geo.idx_vec ? geo.idx_vec[b] : geo.idx_scalar;
  const size_t head = (((size_t)geo.layer * geo.nb + b) * geo.hkv + kvh) * (size_t)geo.s_max * dh;
  T* kh = kc + head;
  T* vh = vc + head;
  const T* knh = kn + ((size_t)b * geo.hkv + kvh) * dh;
  const T* vnh = vn + ((size_t)b * geo.hkv + kvh) * dh;
  const int c0 = split * geo.chunk;

  // 1. the cache write, by the split holding idx; dropped past the allocation
  if (idx >= c0 && idx < c0 + geo.chunk && idx < geo.s_max) {
    for (int i = threadIdx.x; i < dh; i += kThreads) {
      kh[(size_t)idx * dh + i] = knh[i];
      vh[(size_t)idx * dh + i] = vnh[i];
    }
  }
  // 2. attend over this split's share of positions 0..min(idx, S-1)
  const Out<T> o{out, part_ml, part_acc, (size_t)b * geo.hq + (size_t)kvh * rep,
                 geo.n_splits, split, dh};
  const int n_pos = min(idx, geo.s_max - 1) + 1;
  if (c0 >= n_pos) {
    if (geo.n_splits == 1)  // no position at all: 0 / 1e-20
      for (int i = threadIdx.x; i < rep * dh; i += kThreads)
        out[o.row0 * dh + i] = dst::from_f32<T>(0.f);
    return;
  }
  const int c1 = min(c0 + geo.chunk, n_pos);
  const T* q_rows = q + o.row0 * dh;
  const SlotRows<T> rows{kh, vh, knh, vnh, idx, dh};
  const auto no_prep = [] {};
  if constexpr (DH > 0)
    attend_tc<T, DH, NT>(q_rows, rows, c0, c1, rep, geo.scale, o, smem_raw, no_prep);
  else
    attend_cc<T>(q_rows, rows, c0, c1, rep, dh, geo.scale, o, smem_raw, no_prep);
}

template <typename T, int DH, int NT>
cudaError_t launch(const void* q, void* kc, void* vc, const void* kn, const void* vn,
                   void* out, float* ml, float* acc, const Geometry& geo, cudaStream_t st) {
  auto kern = fused_decode_step_split<T, DH, NT>;
  size_t smem;
  if constexpr (DH > 0)
    smem = TcShape<T, DH>::template smem<NT>();
  else
    smem = cc_smem<T>(geo.hq / geo.hkv, geo.dh);
  // raise the dynamic shared-memory cap once per size (before any graph
  // capture: the first call of a shape is never captured)
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  const dim3 grid(geo.n_splits, geo.hkv, geo.nb);
  kern<<<grid, kThreads, smem, st>>>(static_cast<const T*>(q), static_cast<T*>(kc),
                                     static_cast<T*>(vc), static_cast<const T*>(kn),
                                     static_cast<const T*>(vn), static_cast<T*>(out), ml, acc,
                                     geo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || geo.n_splits == 1) return err;
  merge_splits<T><<<dim3(geo.hq, geo.nb), kThreads, 0, st>>>(
      ml, acc, static_cast<T*>(out), geo.idx_vec, 1, geo.idx_scalar, geo.hq, geo.s_max, geo.dh,
      geo.chunk, geo.n_splits);
  return cudaGetLastError();
}

// bf16/fp16: the tensor-core body where Dh is 64, 128 or 256 (n-tiles of 8
// query rows: rep * Dh <= 2048 allows 4 at Dh 64, 2 at 128, 1 at 256)
template <typename T>
cudaError_t dispatch_half(const void* q, void* kc, void* vc, const void* kn, const void* vn,
                          void* out, float* ml, float* acc, const Geometry& geo,
                          cudaStream_t st) {
  const int rep = geo.hq / geo.hkv;
  switch (geo.dh) {
    case 64:
      if (rep <= 8) return launch<T, 64, 1>(q, kc, vc, kn, vn, out, ml, acc, geo, st);
      if (rep <= 16) return launch<T, 64, 2>(q, kc, vc, kn, vn, out, ml, acc, geo, st);
      if (rep <= 32) return launch<T, 64, 4>(q, kc, vc, kn, vn, out, ml, acc, geo, st);
      break;
    case 128:
      if (rep <= 8) return launch<T, 128, 1>(q, kc, vc, kn, vn, out, ml, acc, geo, st);
      if (rep <= 16) return launch<T, 128, 2>(q, kc, vc, kn, vn, out, ml, acc, geo, st);
      break;
    case 256:
      if (rep <= 8) return launch<T, 256, 1>(q, kc, vc, kn, vn, out, ml, acc, geo, st);
      break;
  }
  return launch<T, 0, 0>(q, kc, vc, kn, vn, out, ml, acc, geo, st);
}

}  // namespace

// q [B, Hq, Dh]; k/v caches [L, B, Hkv, S, Dh] (updated in place);
// k_new/v_new [B, Hkv, Dh]; out [B, Hq, Dh]; idx: int32 [B] on the device,
// or null with idx_scalar used for every slot. The prefix is split in
// `chunk` positions, n_splits = ceil(S / chunk); with n_splits > 1, ml
// [B, Hq, n_splits, 2] and acc [B, Hq, n_splits, Dh] f32 are scratch.
extern "C" int dst_fused_decode_step(const void* q, void* k, void* v, const void* k_new,
                                     const void* v_new, void* out, void* ml, void* acc,
                                     const void* idx, int idx_scalar, int layer, int b,
                                     int hq, int hkv, int s_max, int dh, int chunk,
                                     int n_splits, float scale, int dtype, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || s_max <= 0 || dh <= 0 ||
      (hq / hkv) * dh > kThreads * kMaxPerThread || chunk <= 0 ||
      n_splits != (s_max + chunk - 1) / chunk || b <= 0 || b > 65535 || hkv > 65535 ||
      (n_splits > 1 && (ml == nullptr || acc == nullptr)))
    return cudaErrorInvalidValue;
  const Geometry geo{static_cast<const int*>(idx), idx_scalar, layer, b, hq, hkv, s_max,
                     dh, chunk, n_splits, scale};
  float* mlf = static_cast<float*>(ml);
  float* accf = static_cast<float*>(acc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case dst::kF32:
      return launch<float, 0, 0>(q, k, v, k_new, v_new, out, mlf, accf, geo, st);
    case dst::kF16:
      return dispatch_half<__half>(q, k, v, k_new, v_new, out, mlf, accf, geo, st);
    case dst::kBF16:
      return dispatch_half<__nv_bfloat16>(q, k, v, k_new, v_new, out, mlf, accf, geo, st);
  }
  return cudaErrorInvalidValue;
}

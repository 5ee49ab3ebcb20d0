// Fused single-token decode step against the block-paged KV pool (kernel C):
// write the new token's K/V through the slot's block table (quantized on
// store for an int8/fp8 pool), then attend over the slot's valid prefix,
// split along the prefix across blocks and merged.
//
// Replaces the TPU kernel deepspeed_tpu/ops/decode_step.py:_block_kernel
// (fused_block_decode_step). Bound on the H100: bytes. Each (slot, kv head)
// reads its valid K and V prefix once, 2 * (idx + 1) * Dh stored elements (1
// byte each for an 8-bit pool, plus one 2-byte scale per row), and the scores
// and probabilities stay on chip; the math is a few FLOP per byte, far under
// the card's ~295 FLOP/byte ridge. An 8-bit pool halves the bytes of a bf16
// one, which is its point.
//
// Design: kernel B's split body (decode_split.cuh) with table-addressed rows,
// against what held the first form of this kernel back (one block per
// (kv head, slot) walking the whole prefix, products on the CUDA cores: 64
// blocks on 132 SMs at GQA rep 4).
//  * Grid (split, kv head, slot), `chunk` positions per split from the
//    wrapper's block_split_plan (B, Hkv and MB*bs alone); splits past
//    min(idx, MB*bs - 1) return before reading; merge_splits merges the live
//    splits in split order (the live count from idx on the device). Scratch
//    comes from the wrapper, so a call replays in a CUDA graph.
//  * Rows: a split copies the table entries it covers into shared memory
//    once; position p is pool block tbl[p / bs], row p % bs, with p / bs a
//    multiply by a 2^40 fixed-point reciprocal (exact below 2^20
//    positions: a division per copied row had doubled the 8-bit rows'
//    integer work). A kv head's rows inside one pool block are contiguous
//    ([L, N+1, Hkv, bs, Dh]), so a 64-position stage is four 4 KB runs at
//    bs 16, Dh 128 in bf16.
//  * 8-bit pools stage the raw payload (half the bytes) and dequantize in
//    shared memory to the compute type before ldmatrix, as
//    T(f32(payload) * f32(scale)), the plain version's gather.
//  * The write: exactly one block writes, the split holding idx, once its
//    first stages' copies are in flight (the body's prep step); an idx past
//    the table (an overflow, or an inactive slot) lies in no split and goes
//    to the garbage row N, written by split 0 (the einsum path's
//    write_kv_blocks; the TPU kernel clamps to the last table entry
//    instead). An 8-bit pool quantizes the row exactly as
//    serving/kv_quant.kv_quantize_keepdims does: amax over Dh in f32,
//    s = bf16(max(amax / qmax, 1e-8)), y = x / f32(s), then int8
//    clip(rint(y), +-127) or fp8 e4m3 round-to-nearest with saturation. The
//    IEEE divide and rintf are why this file must not be built with fast
//    math: payloads and scales are bit-identical to the plain version's.
//  * Every read of the written pool row takes the new values instead (an
//    8-bit pool: the quantized payload, kept in shared memory, and its
//    scale): position idx, and, on a table that names the garbage row, every
//    position whose row is the written one. No read waits on the write, and
//    the result is the plain version's (write, then gather) whichever split
//    runs first.
//  * Build: this header holds the kernel; block_decode_step.cu (the C entry
//    point, pools in the compute type), block_decode_int8.cu and
//    block_decode_fp8.cu instantiate it, and compile in parallel.
//  * Races: inactive slots all name the garbage row, so several blocks may
//    write it at once; their outputs are discarded. Active slots never share
//    a written block (shared prefix blocks are read-only; the copy-on-write
//    fork happens at admission).
#pragma once

#include <type_traits>

#include "decode_split.cuh"

namespace dst {
namespace blockstep {

struct Geometry {
  const int* idx;      // [B] on the device
  const int* table;    // [B, MB] on the device
  int layer, nb, hq, hkv, n_phys, bs, mb, dh, chunk, n_splits;
  float scale;
  unsigned long long bs_magic;  // ceil(2^40 / bs): p / bs = (p * bs_magic) >> 40, p < 2^20
  int attend_smem;     // bytes of the attention body's shared memory
  int tbl_bytes;       // bytes of a split's table entries (16-byte multiple)
};

struct Ptrs {
  const void *q, *kn, *vn;
  void *kp, *vp, *ksp, *vsp, *out;
  float *ml, *acc;
};

// One compute type over one pool type (defined below, instantiated per pool
// type in block_decode_step.cu, block_decode_int8.cu and block_decode_fp8.cu
// so that the three compile in parallel).
template <typename T, typename S>
cudaError_t launch_pool(const Ptrs& p, const Geometry& geo, cudaStream_t st);

}  // namespace blockstep
}  // namespace dst

// The kernels and their launchers: internal to each source that includes
// this header (each instantiates its own), so that one library's launch
// statics never bind to another's.
namespace {

using namespace dst::split;
using dst::blockstep::Geometry;
using dst::blockstep::Ptrs;
using bf16 = __nv_bfloat16;

// Rows of one (slot, kv head) through the table entries of one split (in
// shared memory: entry e at tbl[e - e0]); decode_split.cuh's row policy.
template <typename T, typename S>
struct BlockRows {
  static constexpr bool kRaw = !std::is_same<T, S>::value;
  using Elem = S;
  const S* k;          // payload pools at [layer, 0, kvh, 0, 0]
  const S* v;
  const bf16* ks;      // scale pools at [layer, 0, kvh, 0] (8-bit pools)
  const bf16* vs;
  const int* tbl;
  int e0, bs, dh;
  unsigned long long bs_magic;  // Geometry::bs_magic
  size_t blk_stride;   // elements from one pool block to the next (Hkv*bs*Dh)
  size_t sblk_stride;  // scales from one pool block to the next (Hkv*bs)
  size_t wrow;         // the written row, as row(pos) gives it
  const T* kn;         // the new row (compute-type pools)
  const T* vn;
  const S* kq_new;     // its payload and scales (8-bit pools), shared memory
  const S* vq_new;
  const float* new_s;
  __device__ float kn_scale() const { return new_s[0]; }
  __device__ float vn_scale() const { return new_s[1]; }
  __device__ int entry(int pos) const { return (int)(((unsigned long long)pos * bs_magic) >> 40); }
  __device__ size_t row(int pos) const {
    const int e = entry(pos);
    return (size_t)tbl[e - e0] * blk_stride + (size_t)(pos - e * bs) * dh;
  }
  __device__ bool at(int pos, const S*& kr, const S*& vr) const {
    const size_t r = row(pos);
    kr = k + r;
    vr = v + r;
    return r == wrow;
  }
  __device__ bool fresh(int pos) const { return row(pos) == wrow; }
  __device__ size_t srow(int pos) const {
    const int e = entry(pos);
    return (size_t)tbl[e - e0] * sblk_stride + (pos - e * bs);
  }
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
__device__ __forceinline__ float block_max(float v, float* red) {
  v = dst::warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  return m;
}

// DH > 0: the tensor-core body at that Dh with NT n-tiles of query rows;
// DH == 0: the CUDA-core body at geo.dh.
template <typename T, typename S, int DH, int NT>
__global__ void __launch_bounds__(kThreads)
fused_block_decode_step_split(const T* __restrict__ q, S* kp, S* vp, bf16* ksp, bf16* vsp,
                              const T* __restrict__ kn, const T* __restrict__ vn,
                              T* __restrict__ out, float* part_ml, float* part_acc,
                              Geometry geo) {
  constexpr bool kQuant = !std::is_same<T, S>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int rep = geo.hq / geo.hkv, dh = DH > 0 ? DH : geo.dh;
  const int s_max = geo.mb * geo.bs;
  const int idx = geo.idx[b];
  const int n_pos = min(idx, s_max - 1) + 1;
  const int c0 = split * geo.chunk;
  const Out<T> o{out, part_ml, part_acc, (size_t)b * geo.hq + (size_t)kvh * rep,
                 geo.n_splits, split, dh};
  // the writer (the split holding idx, or split 0 past the table) always
  // attends: idx < MB*bs lies in [c0, min(c0 + chunk, n_pos))
  if (c0 >= n_pos) {
    if (geo.n_splits == 1)  // no position at all: 0 / 1e-20
      for (int i = tid; i < rep * dh; i += kThreads)
        out[o.row0 * dh + i] = dst::from_f32<T>(0.f);
    return;
  }
  const int c1 = min(c0 + geo.chunk, n_pos);
  const bool writer = idx < s_max ? idx < c0 + geo.chunk : split == 0;
  const int* tb = geo.table + (size_t)b * geo.mb;
  const int jb = idx / geo.bs;
  const int pb = jb < geo.mb ? tb[jb] : geo.n_phys - 1;  // overflow: garbage
  const size_t blk_stride = (size_t)geo.hkv * geo.bs * dh;
  const size_t sblk_stride = (size_t)geo.hkv * geo.bs;
  const size_t layer_off = (size_t)geo.layer * geo.n_phys * blk_stride + (size_t)kvh * geo.bs * dh;
  const size_t slayer_off =
      (size_t)geo.layer * geo.n_phys * sblk_stride + (size_t)kvh * geo.bs;
  const size_t wrow = (size_t)pb * blk_stride + (size_t)(idx - jb * geo.bs) * dh;
  const T* knh = kn + ((size_t)b * geo.hkv + kvh) * dh;
  const T* vnh = vn + ((size_t)b * geo.hkv + kvh) * dh;

  unsigned char* extra = smem_raw + geo.attend_smem;
  int* tbl_sh = reinterpret_cast<int*>(extra);               // this split's entries
  S* kq_sh = reinterpret_cast<S*>(extra + geo.tbl_bytes);     // [dh] each (8-bit)
  S* vq_sh = kq_sh + dh;
  float* red = reinterpret_cast<float*>(vq_sh + dh);          // [kWarps]
  float* new_s = red + kWarps;                                // [2] (8-bit)
  const int e0 = c0 / geo.bs, e1 = (c1 - 1) / geo.bs;
  for (int e = e0 + tid; e <= e1; e += kThreads) tbl_sh[e - e0] = tb[e];
  __syncthreads();  // the table entries are visible to the copies

  // 1. the write of row idx (quantized on store for an 8-bit pool), once the
  // first stages' copies are in flight. A split that may read the written
  // row (the writer; any split on a table that names the garbage row) keeps
  // the quantized row in shared memory. Every thread runs it (barriers).
  const auto write_new = [&] {
    if constexpr (kQuant) {
      if (writer || pb == geo.n_phys - 1) {
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
        const float kn_s = __bfloat162float(ksb), vn_s = __bfloat162float(vsb);
        for (int i = tid; i < dh; i += kThreads) {
          const S kqv = Quant<S>::q(dst::to_f32(knh[i]) / kn_s);
          const S vqv = Quant<S>::q(dst::to_f32(vnh[i]) / vn_s);
          kq_sh[i] = kqv;
          vq_sh[i] = vqv;
          if (writer) {
            kp[layer_off + wrow + i] = kqv;
            vp[layer_off + wrow + i] = vqv;
          }
        }
        if (tid == 0) {
          new_s[0] = kn_s;
          new_s[1] = vn_s;
          if (writer) {
            const size_t srow = slayer_off + (size_t)pb * sblk_stride + (idx - jb * geo.bs);
            ksp[srow] = ksb;
            vsp[srow] = vsb;
          }
        }
      }
    } else {
      if (writer) {
        for (int i = tid; i < dh; i += kThreads) {
          kp[layer_off + wrow + i] = knh[i];
          vp[layer_off + wrow + i] = vnh[i];
        }
      }
    }
  };

  // 2. attend over this split's share of positions 0..min(idx, MB*bs - 1)
  const BlockRows<T, S> rows{kp + layer_off, vp + layer_off,
                             kQuant ? ksp + slayer_off : nullptr,
                             kQuant ? vsp + slayer_off : nullptr,
                             tbl_sh, e0, geo.bs, dh, geo.bs_magic, blk_stride, sblk_stride,
                             wrow, knh, vnh, kq_sh, vq_sh, new_s};
  const T* q_rows = q + o.row0 * dh;
  if constexpr (DH > 0)
    attend_tc<T, DH, NT>(q_rows, rows, c0, c1, rep, geo.scale, o, smem_raw, write_new);
  else
    attend_cc<T>(q_rows, rows, c0, c1, rep, dh, geo.scale, o, smem_raw, write_new);
}

template <typename T, typename S, int DH, int NT>
cudaError_t launch(const Ptrs& p, Geometry geo, cudaStream_t st) {
  constexpr bool kQuant = !std::is_same<T, S>::value;
  auto kern = fused_block_decode_step_split<T, S, DH, NT>;
  size_t attend;
  if constexpr (DH > 0)
    attend = TcShape<T, DH>::template smem<NT, kQuant>();
  else
    attend = cc_smem<T>(geo.hq / geo.hkv, geo.dh);
  geo.attend_smem = (int)attend;
  const int entries = min(geo.chunk / geo.bs + 2, geo.mb);  // a split spans at most these
  geo.tbl_bytes = (entries * 4 + 15) / 16 * 16;
  const size_t smem = attend + geo.tbl_bytes + (kQuant ? 2 * (size_t)geo.dh : 0) +
                      (kWarps + 2) * sizeof(float);
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
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(p.q), static_cast<S*>(p.kp), static_cast<S*>(p.vp),
      static_cast<bf16*>(p.ksp), static_cast<bf16*>(p.vsp), static_cast<const T*>(p.kn),
      static_cast<const T*>(p.vn), static_cast<T*>(p.out), p.ml, p.acc, geo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || geo.n_splits == 1) return err;
  merge_splits<T><<<dim3(geo.hq, geo.nb), kThreads, 0, st>>>(
      p.ml, p.acc, static_cast<T*>(p.out), geo.idx, 1, 0, geo.hq, geo.mb * geo.bs, geo.dh,
      geo.chunk, geo.n_splits);
  return cudaGetLastError();
}

// bf16/fp16: the tensor-core body where Dh is 64, 128 or 256 (n-tiles of 8
// query rows: rep * Dh <= 2048 allows 4 at Dh 64, 2 at 128, 1 at 256)
template <typename T, typename S>
cudaError_t dispatch_half(const Ptrs& p, const Geometry& geo, cudaStream_t st) {
  const int rep = geo.hq / geo.hkv;
  switch (geo.dh) {
    case 64:
      if (rep <= 8) return launch<T, S, 64, 1>(p, geo, st);
      if (rep <= 16) return launch<T, S, 64, 2>(p, geo, st);
      if (rep <= 32) return launch<T, S, 64, 4>(p, geo, st);
      break;
    case 128:
      if (rep <= 8) return launch<T, S, 128, 1>(p, geo, st);
      if (rep <= 16) return launch<T, S, 128, 2>(p, geo, st);
      break;
    case 256:
      if (rep <= 8) return launch<T, S, 256, 1>(p, geo, st);
      break;
  }
  return launch<T, S, 0, 0>(p, geo, st);
}

}  // namespace

namespace dst {
namespace blockstep {

// the tensor-core body for bf16/fp16, the CUDA-core body for f32
template <typename T, typename S>
cudaError_t launch_pool(const Ptrs& p, const Geometry& geo, cudaStream_t st) {
  if constexpr (std::is_same<T, float>::value)
    return launch<T, S, 0, 0>(p, geo, st);
  else
    return dispatch_half<T, S>(p, geo, st);
}

#define DST_BLOCKSTEP_POOL(X, S) \
  X template cudaError_t launch_pool<float, S>(const Ptrs&, const Geometry&, cudaStream_t); \
  X template cudaError_t launch_pool<__half, S>(const Ptrs&, const Geometry&, cudaStream_t); \
  X template cudaError_t launch_pool<__nv_bfloat16, S>(const Ptrs&, const Geometry&, cudaStream_t);

}  // namespace blockstep
}  // namespace dst

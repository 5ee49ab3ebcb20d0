// Flash-decode: one new token's attention over a head-major [B, Hkv, S, Dh]
// cache whose position idx already holds its own K/V, split across blocks
// along the valid prefix (flash-decoding), then merged.
//
// Replaces the TPU kernels deepspeed_tpu/ops/flash_decode.py:_kernel (the
// wide-GQA slab kernel, rep >= 2) and :_mha_kernel (the rep == 1 variant,
// unrouted in the reference and here). Bound on the H100: bytes. The
// function reads the valid K and V prefix once, 2 * (min(idx, S-1) + 1) * Dh
// elements per (slot, kv head), and does 4 * rep * Dh FLOP per position:
// a few FLOP per byte, far under the card's ~295 FLOP/byte ridge. At batch 1
// (generate's route) the prefix is a few MB, so latency sets the time: how
// soon every SM has a stage of K/V in flight, and the merge after it.
//
// rep >= 2 (flash_decode_gqa): kernel B's attention (decode_split.cuh, the
// body of decode_step.cu and block_decode_step.cuh) over a row policy for a
// contiguous cache head, with no position reading a new row: the cache
// already holds it. It replaced this file's first GQA kernel (K/V loaded
// into registers with no copy in flight, a 5-shuffle butterfly per query
// row and position, all on the CUDA cores: 1.7-2.1x SDPA's time at
// CodeLlama-34B decode). Grid (split, kv head x row group, slot): each
// block attends up to 8 * NT query rows of one kv head over `chunk`
// positions, bf16/fp16 on the tensor cores (mma.sync, the rows as the n
// dimension, a 3-stage cp.async ring), f32 on the CUDA-core body; a block
// whose first position lies past idx returns before reading anything, so
// bytes follow idx, not S (the TPU kernel's clamped index map, :200-204).
// The plan is kernel B's (decode_step.split_plan, a function of the shapes
// only): on the tensor cores at most one block per SM at full S, longer
// chunks streaming through the ring (it fits two blocks an SM, and a second
// wave cost more than the longer walk); on the CUDA cores at most two.
// flash_decode_merge (kernel B's merge_row under this kernel's name, so a
// profile counts it as flash-decode) then merges each row's live splits in
// split order (no atomics: results repeat bit for bit and equal kernel
// B's), launched as a programmatic dependent of the split kernel so its
// launch overlaps the split's run. A rep wider than one block's rows (32 at
// Dh 64, 16 at 128, 8 at 256) takes several row groups, each reading the kv
// head's prefix.
//
// rep == 1 (flash_decode_split<T, EPL> + flash_decode_combine): a
// CUDA-core kernel. Each warp scores a group of positions at a time: every
// lane holds Dh/32 elements of the query row and of each K/V row (one
// coalesced load per row per warp, several rows in flight), sums its
// products in f32 and finishes the dot product with a butterfly; online
// softmax over (m, l, acc) in f32 per warp; the warps merge through shared
// memory in warp order, and a second kernel merges the splits in split
// order.
//
// Rounding points follow the TPU kernels: scores are products of the stored
// values summed in f32, times `scale`. The GQA computation rounds p to the V
// dtype before P.V (:83); the rep == 1 kernel keeps everything in f32
// (:113-125). The output is acc / max(l, 1e-20), cast once; 0 where no
// position is valid. idx is read on the device (a pointer) or passed by
// value, never read by the host, so a call replays in a CUDA graph.
#include <math_constants.h>

#include "decode_split.cuh"

namespace {

using namespace dst;
namespace ds = dst::split;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <int BYTES> struct Raw;
template <> struct Raw<4> { using type = uint32_t; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

// N consecutive elements at p (aligned to N * sizeof(T), or to 16 bytes
// when that is more) as f32, in loads of at most 16 bytes.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, float (&out)[N]) {
  constexpr int kBytes = N * (int)sizeof(T) > 16 ? 16 : N * (int)sizeof(T);
  constexpr int kPer = kBytes / (int)sizeof(T);
  using R = typename Raw<kBytes>::type;
#pragma unroll
  for (int c = 0; c < N / kPer; ++c) {
    const R raw = *reinterpret_cast<const R*>(p + c * kPer);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kPer; ++i) out[c * kPer + i] = to_f32(e[i]);
  }
}

__device__ __forceinline__ int valid_positions(const int* idx_ptr, int idx_scalar,
                                               int s_max) {
  const int idx = idx_ptr ? *idx_ptr : idx_scalar;
  return min(idx, s_max - 1) + 1;  // positions 0..n-1; <= 0: none
}

// ------------------------------------------------------------- rep >= 2
// Rows of one contiguous [S, Dh] cache head whose position idx already
// holds the new token (decode_split.cuh's row policy): no position reads
// another row, so kn/vn are never read.
template <typename T>
struct CacheRows {
  static constexpr bool kRaw = false;
  using Elem = T;
  static constexpr const T* kn = nullptr;
  static constexpr const T* vn = nullptr;
  const T* k;
  const T* v;
  int dh;
  __device__ bool at(int pos, const T*& kr, const T*& vr) const {
    kr = k + (size_t)pos * dh;
    vr = v + (size_t)pos * dh;
    return false;
  }
  __device__ bool fresh(int) const { return false; }
};

struct GqaGeometry {
  const int* idx_ptr;
  int idx_scalar, hq, hkv, s_max, dh, chunk, n_splits;
  int rows, n_groups;  // query rows per block (at most), row groups per kv head
  float scale;
};

// DH > 0: the tensor-core body at that Dh with NT n-tiles of query rows;
// DH == 0: the CUDA-core body at geo.dh.
template <typename T, int DH, int NT>
__global__ void __launch_bounds__(ds::kThreads)
flash_decode_gqa(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* part_ml, float* part_acc, GqaGeometry geo) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int split = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / geo.n_groups, grp = blockIdx.y - kvh * geo.n_groups;
  const int rep = geo.hq / geo.hkv, dh = DH > 0 ? DH : geo.dh;
  const int r0 = grp * geo.rows, nrows = min(geo.rows, rep - r0);
  const ds::Out<T> o{out, part_ml, part_acc,
                     (size_t)b * geo.hq + (size_t)kvh * rep + r0, geo.n_splits, split, dh};
  const int n_pos = valid_positions(geo.idx_ptr, geo.idx_scalar, geo.s_max);
  const int c0 = split * geo.chunk;
  // let the merge launch now (it waits for this grid to end before reading)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (c0 >= n_pos) {
    if (geo.n_splits == 1)  // no position at all: 0 / 1e-20
      for (int i = threadIdx.x; i < nrows * dh; i += ds::kThreads)
        out[o.row0 * dh + i] = from_f32<T>(0.f);
    return;
  }
  const int c1 = min(c0 + geo.chunk, n_pos);
  const size_t head = ((size_t)b * geo.hkv + kvh) * (size_t)geo.s_max * dh;
  const CacheRows<T> rows{k + head, v + head, dh};
  const T* q_rows = q + o.row0 * dh;
  const auto no_prep = [] {};
  if constexpr (DH > 0)
    ds::attend_tc<T, DH, NT>(q_rows, rows, c0, c1, nrows, geo.scale, o, smem_raw, no_prep);
  else
    ds::attend_cc<T>(q_rows, rows, c0, c1, nrows, dh, geo.scale, o, smem_raw, no_prep);
}

// kernel B's merge (merge_splits) under flash-decode's name: grid (hq, b)
template <typename T>
__global__ void __launch_bounds__(ds::kThreads)
flash_decode_merge(const float* __restrict__ ml, const float* __restrict__ acc,
                   T* __restrict__ out, const int* __restrict__ idx_ptr, int idx_scalar,
                   int hq, int s_max, int dh, int chunk, int n_splits) {
  ds::merge_row<T>(ml, acc, out, idx_ptr, 0, idx_scalar, hq, s_max, dh, chunk, n_splits);
}

template <typename T, int DH, int NT>
cudaError_t launch_gqa(const void* q, const void* k, const void* v, void* out, float* ml,
                       float* acc, const GqaGeometry& geo, int b, cudaStream_t st) {
  auto kern = flash_decode_gqa<T, DH, NT>;
  size_t smem;
  if constexpr (DH > 0)
    smem = ds::TcShape<T, DH>::template smem<NT>();
  else
    smem = ds::cc_smem<T>(geo.rows, geo.dh);
  // raise the dynamic shared-memory cap once per size (before any graph
  // capture: the first call of a shape is never captured)
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  const dim3 grid(geo.n_splits, geo.hkv * geo.n_groups, b);
  kern<<<grid, ds::kThreads, smem, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), static_cast<T*>(out), ml,
                                         acc, geo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || geo.n_splits == 1) return err;
  // the merge as a programmatic dependent launch: its blocks are scheduled
  // while the split kernel runs, hiding the second launch's latency
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(geo.hq, b);
  cfg.blockDim = dim3(ds::kThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, flash_decode_merge<T>, static_cast<const float*>(ml),
                            static_cast<const float*>(acc), static_cast<T*>(out), geo.idx_ptr,
                            geo.idx_scalar, geo.hq, geo.s_max, geo.dh, geo.chunk,
                            geo.n_splits);
}

// bf16/fp16: the tensor-core body, n-tiles of 8 query rows as kernel B picks
// them (rows * Dh <= 2048: up to 4 n-tiles at Dh 64, 2 at 128, 1 at 256)
template <typename T>
cudaError_t dispatch_gqa_half(const void* q, const void* k, const void* v, void* out,
                              float* ml, float* acc, const GqaGeometry& geo, int b,
                              cudaStream_t st) {
  const int nt = (geo.rows + 7) / 8;
  switch (geo.dh) {
    case 64:
      if (nt == 1) return launch_gqa<T, 64, 1>(q, k, v, out, ml, acc, geo, b, st);
      if (nt == 2) return launch_gqa<T, 64, 2>(q, k, v, out, ml, acc, geo, b, st);
      return launch_gqa<T, 64, 4>(q, k, v, out, ml, acc, geo, b, st);
    case 128:
      if (nt == 1) return launch_gqa<T, 128, 1>(q, k, v, out, ml, acc, geo, b, st);
      return launch_gqa<T, 128, 2>(q, k, v, out, ml, acc, geo, b, st);
    case 256:
      return launch_gqa<T, 256, 1>(q, k, v, out, ml, acc, geo, b, st);
  }
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_gqa(const void* q, const void* k, const void* v, void* out, float* ml,
                         float* acc, GqaGeometry geo, int b, int dtype, cudaStream_t st) {
  // a block's query rows: rows * Dh <= kThreads * kMaxPerThread (both bodies)
  const int rep = geo.hq / geo.hkv;
  geo.rows = min(rep, ds::kThreads * ds::kMaxPerThread / geo.dh);
  geo.n_groups = (rep + geo.rows - 1) / geo.rows;
  if (geo.hkv * geo.n_groups > 65535) return cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      return launch_gqa<float, 0, 0>(q, k, v, out, ml, acc, geo, b, st);
    case kF16:
      return dispatch_gqa_half<__half>(q, k, v, out, ml, acc, geo, b, st);
    case kBF16:
      return dispatch_gqa_half<__nv_bfloat16>(q, k, v, out, ml, acc, geo, b, st);
  }
  return cudaErrorInvalidValue;
}

// --------------------------------------------------------------- rep == 1
// One split of the valid prefix for one query head (its own kv head). EPL =
// Dh / 32 elements per lane; kGroup positions scored per warp step (8 at
// Dh <= 128, 4 at Dh 256).
template <typename T, int EPL>
__global__ void __launch_bounds__(kThreads)
flash_decode_split(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out,
                   float* __restrict__ part_ml, float* __restrict__ part_acc,
                   const int* __restrict__ idx_ptr, int idx_scalar, int hq, int s_max,
                   int chunk, int n_splits, float scale) {
  constexpr int DH = 32 * EPL;
  constexpr int kGroup = EPL >= 4 ? 32 / EPL : 8;  // 64 K/V values a lane
  __shared__ float m_sh[kWarps];
  __shared__ float l_sh[kWarps];
  __shared__ float acc_sh[kWarps][DH];

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = (size_t)b * hq + h;  // the query row, and its kv head
  const int n_pos = valid_positions(idx_ptr, idx_scalar, s_max);
  const int c0 = split * chunk;
  if (c0 >= n_pos) {  // past idx: nothing to read
    if (n_splits == 1)  // no positions at all: the reference's 0 / 1e-20
      for (int i = tid; i < DH; i += kThreads) out[row * DH + i] = from_f32<T>(0.f);
    return;
  }
  const int c1 = min(c0 + chunk, n_pos);

  float qr[EPL];
  load_f32<T, EPL>(q + row * DH + lane * EPL, qr);
  const size_t head = row * (size_t)s_max * DH;
  const T* kh = k + head + lane * EPL;
  const T* vh = v + head + lane * EPL;

  float m = -CUDART_INF_F, l = 0.f, acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;

  for (int p0 = c0 + warp * kGroup; p0 < c1; p0 += kWarps * kGroup) {
    const int np = min(kGroup, c1 - p0);
    float kf[kGroup][EPL], vf[kGroup][EPL];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (j < np) {
        load_f32<T, EPL>(kh + (size_t)(p0 + j) * DH, kf[j]);
        load_f32<T, EPL>(vh + (size_t)(p0 + j) * DH, vf[j]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kf[j][e] = vf[j][e] = 0.f;
      }
    }
    float s[kGroup];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) part = fmaf(qr[e], kf[j][e], part);
      s[j] = warp_sum(part) * scale;
      if (j < np) mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);  // 0 on the warp's first group
    float lr = l * corr;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] *= corr;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (j < np) {
        const float p = expf(s[j] - m_new);
        lr += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[e] = fmaf(p, vf[j][e], acc[e]);
      }
    }
    l = lr;
    m = m_new;
  }

  // merge the warps in warp order
  if (lane == 0) {
    m_sh[warp] = m;
    l_sh[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc_sh[warp][lane * EPL + e] = acc[e];
  __syncthreads();
  for (int d = tid; d < DH; d += kThreads) {
    float mm = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, m_sh[w]);  // finite: warp 0 has c0
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(m_sh[w] - mm);  // 0 for a warp past idx
      ll = fmaf(l_sh[w], c, ll);
      aa = fmaf(acc_sh[w][d], c, aa);
    }
    if (n_splits == 1) {
      out[row * DH + d] = from_f32<T>(aa / fmaxf(ll, 1e-20f));
    } else {
      const size_t slot = row * n_splits + split;
      part_acc[slot * DH + d] = aa;
      if (d == 0) {
        part_ml[2 * slot] = mm;
        part_ml[2 * slot + 1] = ll;
      }
    }
  }
}

// Merge the live splits of one query row, in split order.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_decode_combine(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                     T* __restrict__ out, const int* __restrict__ idx_ptr, int idx_scalar,
                     int hq, int s_max, int chunk, int n_splits) {
  const size_t row = (size_t)blockIdx.y * hq + blockIdx.x;
  const int n_pos = valid_positions(idx_ptr, idx_scalar, s_max);
  const int n_live = n_pos > 0 ? min((n_pos - 1) / chunk + 1, n_splits) : 0;
  const float* ml = part_ml + 2 * row * n_splits;
  const float* acc = part_acc + row * n_splits * DH;
  float mm = -CUDART_INF_F;
  for (int j = 0; j < n_live; ++j) mm = fmaxf(mm, ml[2 * j]);
  for (int d = threadIdx.x; d < DH; d += kThreads) {
    float ll = 0.f, aa = 0.f;
    for (int j = 0; j < n_live; ++j) {
      const float c = expf(ml[2 * j] - mm);
      ll = fmaf(ml[2 * j + 1], c, ll);
      aa = fmaf(acc[(size_t)j * DH + d], c, aa);
    }
    out[row * DH + d] = from_f32<T>(n_live ? aa / fmaxf(ll, 1e-20f) : 0.f);
  }
}

template <typename T, int EPL>
cudaError_t launch_mha(const void* q, const void* k, const void* v, void* out, float* ml,
                       float* acc, const int* idx_ptr, int idx_scalar, int b, int hq,
                       int s_max, int chunk, int n_splits, float scale, cudaStream_t st) {
  constexpr int DH = 32 * EPL;
  const dim3 grid(n_splits, hq, b);
  flash_decode_split<T, EPL><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), ml, acc, idx_ptr, idx_scalar, hq, s_max, chunk, n_splits, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  flash_decode_combine<T, DH><<<dim3(hq, b), kThreads, 0, st>>>(
      ml, acc, static_cast<T*>(out), idx_ptr, idx_scalar, hq, s_max, chunk, n_splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_mha_dh(const void* q, const void* k, const void* v, void* out, float* ml,
                            float* acc, const int* iv, int idx_scalar, int b, int hq,
                            int s_max, int dh, int chunk, int n_splits, float scale,
                            cudaStream_t st) {
  switch (dh) {
    case 64:
      return launch_mha<T, 2>(q, k, v, out, ml, acc, iv, idx_scalar, b, hq, s_max, chunk,
                              n_splits, scale, st);
    case 128:
      return launch_mha<T, 4>(q, k, v, out, ml, acc, iv, idx_scalar, b, hq, s_max, chunk,
                              n_splits, scale, st);
    case 256:
      return launch_mha<T, 8>(q, k, v, out, ml, acc, iv, idx_scalar, b, hq, s_max, chunk,
                              n_splits, scale, st);
  }
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_mha(const void* q, const void* k, const void* v, void* out, float* ml,
                         float* acc, const int* iv, int idx_scalar, int b, int hq, int s_max,
                         int dh, int chunk, int n_splits, float scale, int dtype,
                         cudaStream_t st) {
  switch (dtype) {
    case kF32:
      return dispatch_mha_dh<float>(q, k, v, out, ml, acc, iv, idx_scalar, b, hq, s_max, dh,
                                    chunk, n_splits, scale, st);
    case kF16:
      return dispatch_mha_dh<__half>(q, k, v, out, ml, acc, iv, idx_scalar, b, hq, s_max, dh,
                                     chunk, n_splits, scale, st);
    case kBF16:
      return dispatch_mha_dh<__nv_bfloat16>(q, k, v, out, ml, acc, iv, idx_scalar, b, hq,
                                            s_max, dh, chunk, n_splits, scale, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B, Hq, Dh]; k/v caches [B, Hkv, S, Dh] holding the new token at idx;
// out [B, Hq, Dh]. idx: one int32 on the device, or null with idx_scalar.
// With n_splits = ceil(S / chunk) > 1, ml [B, Hq, n_splits, 2] and
// acc [B, Hq, n_splits, Dh] f32 are the splits' partials (scratch).
// mha = 0: the GQA computation (rep >= 2, p rounded to the cache dtype;
// decode_split.cuh's body); mha = 1: the rep == 1 kernel (all f32).
extern "C" int dst_flash_decode(const void* q, const void* k, const void* v, void* out,
                                void* ml, void* acc, const void* idx, int idx_scalar,
                                int b, int hq, int hkv, int s_max, int dh, int chunk,
                                int n_splits, float scale, int dtype, int mha,
                                void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || (mha != 0) != (hq == hkv) || s_max <= 0 ||
      (dh != 64 && dh != 128 && dh != 256) || b <= 0 || b > 65535 || chunk <= 0 ||
      n_splits != (s_max + chunk - 1) / chunk ||
      (n_splits > 1 && (ml == nullptr || acc == nullptr)))
    return cudaErrorInvalidValue;
  const int* iv = static_cast<const int*>(idx);
  float* mlf = static_cast<float*>(ml);
  float* accf = static_cast<float*>(acc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mha)
    return dispatch_mha(q, k, v, out, mlf, accf, iv, idx_scalar, b, hq, s_max, dh, chunk,
                        n_splits, scale, dtype, st);
  const GqaGeometry geo{iv, idx_scalar, hq, hkv, s_max, dh, chunk, n_splits, 0, 0, scale};
  return dispatch_gqa(q, k, v, out, mlf, accf, geo, b, dtype, st);
}

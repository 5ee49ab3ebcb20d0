// Flash-decode: one new token's attention over a head-major [B, Hkv, S, Dh]
// cache whose position idx already holds its own K/V, split across blocks
// along the valid prefix (flash-decoding), then combined.
//
// Replaces the TPU kernels deepspeed_tpu/ops/flash_decode.py:_kernel (the
// wide-GQA slab kernel, rep >= 2) and :_mha_kernel (the rep == 1 variant,
// unrouted in the reference and here). Bound on the H100: bytes. The
// function reads the valid K and V prefix once, 2 * (min(idx, S-1) + 1) * Dh
// elements per (slot, kv head), and does 4 * rep * Dh FLOP per position:
// a few FLOP per byte, far under the card's ~295 FLOP/byte ridge.
//
// Design:
//  * The TPU kernel walks a (batch x kv head) row's key blocks in order on
//    one core. At the decode shapes that matter here (batch 1, 8 kv heads)
//    one block per (slot, kv head) would use 8 of 132 SMs, so the valid
//    prefix is split instead: grid (split, kv head x row group, slot), each
//    block taking `chunk` positions (chosen by the wrapper so the card holds
//    a few blocks per SM at full S). Blocks whose first position lies past
//    idx return before reading anything, so bytes follow idx, not S (the
//    TPU kernel's clamped index map, :200-204).
//  * In a block, each warp scores a group of positions at a time: every lane
//    holds Dh/32 elements of each query row and of each K/V row (one
//    coalesced load per row per warp, several rows in flight), sums its
//    products in f32 and finishes the dot product with a butterfly.
//    Online softmax over (m, l, acc) in f32 per warp; the rep query rows of
//    a kv head (up to 8 per block) share every K/V row loaded.
//  * Rounding points follow the TPU kernels: scores are products of the
//    stored values summed in f32, times `scale`. In the GQA kernel p is
//    rounded to the V dtype before P.V (:83); the rep == 1 kernel keeps
//    everything in f32 (:113-125). The output is acc / max(l, 1e-20), cast
//    once.
//  * The warps of a block merge their (m, l, acc) through shared memory in
//    warp order; a block writes its partial (or, with one split, the
//    output). A second kernel merges the live splits in split order. No
//    atomics: results are bit-identical run to run.
//  * idx is read on the device (a pointer) or passed by value, never read
//    by the host.
#include <math_constants.h>

#include "common.cuh"

namespace {

using namespace dst;

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

// One split of the valid prefix for up to ROWS query rows of one kv head.
// EPL = Dh / 32 elements per lane; kGroup positions scored per warp step
// (8 at Dh <= 128, 4 at Dh 256: 16 rows at Dh 64 spilled registers).
template <typename T, int EPL, int ROWS, bool kRoundP>
__global__ void __launch_bounds__(kThreads)
flash_decode_split(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out,
                   float* __restrict__ part_ml, float* __restrict__ part_acc,
                   const int* __restrict__ idx_ptr, int idx_scalar, int hq, int hkv,
                   int s_max, int n_groups, int chunk, int n_splits, float scale) {
  constexpr int DH = 32 * EPL;
  constexpr int kGroup = EPL >= 4 ? 32 / EPL : 8;  // 64 K/V values a lane
  __shared__ float m_sh[kWarps][ROWS];
  __shared__ float l_sh[kWarps][ROWS];
  __shared__ float acc_sh[kWarps][ROWS][DH];

  const int split = blockIdx.x;
  const int kvh = blockIdx.y / n_groups, grp = blockIdx.y - kvh * n_groups;
  const int b = blockIdx.z;
  const int rep = hq / hkv;
  const int r0 = grp * ROWS;
  const int nrows = min(ROWS, rep - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t qrow0 = (size_t)b * hq + (size_t)kvh * rep + r0;  // first q row
  const int n_pos = valid_positions(idx_ptr, idx_scalar, s_max);
  const int c0 = split * chunk;
  if (c0 >= n_pos) {  // past idx: nothing to read
    if (n_splits == 1)  // no positions at all: the reference's 0 / 1e-20
      for (int i = tid; i < nrows * DH; i += kThreads)
        out[qrow0 * DH + i] = from_f32<T>(0.f);
    return;
  }
  const int c1 = min(c0 + chunk, n_pos);

  float qr[ROWS][EPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r < nrows) {
      load_f32<T, EPL>(q + (qrow0 + r) * DH + lane * EPL, qr[r]);
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[r][e] = 0.f;
    }
  }
  const size_t head = ((size_t)b * hkv + kvh) * (size_t)s_max * DH;
  const T* kh = k + head + lane * EPL;
  const T* vh = v + head + lane * EPL;

  float m[ROWS], l[ROWS], acc[ROWS][EPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
  }

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
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= nrows) continue;
      float s[kGroup];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part = fmaf(qr[r][e], kf[j][e], part);
        s[j] = warp_sum(part) * scale;
        if (j < np) mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);  // 0 on the warp's first group
      float lr = l[r] * corr;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] *= corr;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (j < np) {
          const float p = expf(s[j] - m_new);
          lr += p;
          const float pv = kRoundP ? to_f32(from_f32<T>(p)) : p;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[r][e] = fmaf(pv, vf[j][e], acc[r][e]);
        }
      }
      l[r] = lr;
      m[r] = m_new;
    }
  }

  // merge the warps in warp order
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (lane == 0) {
      m_sh[warp][r] = m[r];
      l_sh[warp][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc_sh[warp][r][lane * EPL + e] = acc[r][e];
  }
  __syncthreads();
  for (int i = tid; i < nrows * DH; i += kThreads) {
    const int r = i / DH, d = i - r * DH;
    float mm = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, m_sh[w][r]);  // finite: warp 0 has c0
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(m_sh[w][r] - mm);  // 0 for a warp past idx
      ll = fmaf(l_sh[w][r], c, ll);
      aa = fmaf(acc_sh[w][r][d], c, aa);
    }
    const size_t row = qrow0 + r;
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

template <typename T, int EPL, int ROWS, bool kRoundP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* ml,
                   float* acc, const int* idx_ptr, int idx_scalar, int b, int hq, int hkv,
                   int s_max, int chunk, int n_splits, float scale, cudaStream_t st) {
  constexpr int DH = 32 * EPL;
  const int rep = hq / hkv;
  const int n_groups = (rep + ROWS - 1) / ROWS;
  const dim3 grid(n_splits, hkv * n_groups, b);
  flash_decode_split<T, EPL, ROWS, kRoundP><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), ml, acc, idx_ptr, idx_scalar, hq, hkv, s_max, n_groups,
      chunk, n_splits, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  flash_decode_combine<T, DH><<<dim3(hq, b), kThreads, 0, st>>>(
      ml, acc, static_cast<T*>(out), idx_ptr, idx_scalar, hq, s_max, chunk, n_splits);
  return cudaGetLastError();
}

template <typename T, bool kMha>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v, void* out, float* ml,
                        float* acc, const int* iv, int idx_scalar, int b, int hq, int hkv,
                        int s_max, int dh, int chunk, int n_splits, float scale,
                        cudaStream_t st) {
  // rows per block: 8 query rows of a kv head (4 at Dh 256, for registers);
  // the rep == 1 kernel takes one
  switch (dh) {
    case 64:
      return launch<T, 2, kMha ? 1 : 8, !kMha>(q, k, v, out, ml, acc, iv, idx_scalar, b, hq,
                                               hkv, s_max, chunk, n_splits, scale, st);
    case 128:
      return launch<T, 4, kMha ? 1 : 8, !kMha>(q, k, v, out, ml, acc, iv, idx_scalar, b, hq,
                                               hkv, s_max, chunk, n_splits, scale, st);
    case 256:
      return launch<T, 8, kMha ? 1 : 4, !kMha>(q, k, v, out, ml, acc, iv, idx_scalar, b, hq,
                                               hkv, s_max, chunk, n_splits, scale, st);
  }
  return cudaErrorInvalidValue;
}

template <bool kMha>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, void* ml,
                     void* acc, const void* idx, int idx_scalar, int b, int hq, int hkv,
                     int s_max, int dh, int chunk, int n_splits, float scale, int dtype,
                     void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || (kMha && hq != hkv) || (!kMha && hq == hkv) ||
      s_max <= 0 || chunk <= 0 || n_splits != (s_max + chunk - 1) / chunk ||
      (n_splits > 1 && (ml == nullptr || acc == nullptr)))
    return cudaErrorInvalidValue;
  const int* iv = static_cast<const int*>(idx);
  float* mlf = static_cast<float*>(ml);
  float* accf = static_cast<float*>(acc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return dispatch_dh<float, kMha>(q, k, v, out, mlf, accf, iv, idx_scalar, b, hq, hkv,
                                      s_max, dh, chunk, n_splits, scale, st);
    case kF16:
      return dispatch_dh<__half, kMha>(q, k, v, out, mlf, accf, iv, idx_scalar, b, hq, hkv,
                                       s_max, dh, chunk, n_splits, scale, st);
    case kBF16:
      return dispatch_dh<__nv_bfloat16, kMha>(q, k, v, out, mlf, accf, iv, idx_scalar, b,
                                              hq, hkv, s_max, dh, chunk, n_splits, scale,
                                              st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B, Hq, Dh]; k/v caches [B, Hkv, S, Dh] holding the new token at idx;
// out [B, Hq, Dh]. idx: one int32 on the device, or null with idx_scalar.
// With n_splits = ceil(S / chunk) > 1, ml [B, Hq, n_splits, 2] and
// acc [B, Hq, n_splits, Dh] f32 are the splits' partials (scratch).
// mha = 0: the GQA kernel (rep >= 2, p rounded to the cache dtype);
// mha = 1: the rep == 1 kernel (all f32).
extern "C" int dst_flash_decode(const void* q, const void* k, const void* v, void* out,
                                void* ml, void* acc, const void* idx, int idx_scalar,
                                int b, int hq, int hkv, int s_max, int dh, int chunk,
                                int n_splits, float scale, int dtype, int mha,
                                void* stream) {
  if (mha)
    return dispatch<true>(q, k, v, out, ml, acc, idx, idx_scalar, b, hq, hkv, s_max, dh,
                          chunk, n_splits, scale, dtype, stream);
  return dispatch<false>(q, k, v, out, ml, acc, idx, idx_scalar, b, hq, hkv, s_max, dh,
                         chunk, n_splits, scale, dtype, stream);
}

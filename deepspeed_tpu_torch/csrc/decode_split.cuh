// The attention body of the fused decode step (decode_step.cu), split along
// the cache: one CUDA block of kThreads attends the `rep` query heads of one
// kv head of one slot over positions c0..c1-1 (one split of the valid
// prefix), with position `idx` taken from the new token's row instead of the
// cache, so no read waits on the write. It leaves the split's online-softmax
// state (m, l, unnormalised acc, f32) for merge_splits, or, when the prefix
// is one split, the output itself.
//
// Two forms of the same arithmetic:
//  * attend_tc (bf16/fp16, Dh 64, 128 or 256): the products run on the tensor
//    cores (mma.sync m16n8k16, f32 accumulation), with the query rows as the
//    n dimension (rep <= 8 is one n-tile; 16 and 32 take two and four):
//      scores  S^T[pos, r] = K[pos, :] . Q[r, :]   A: 16 K rows by ldmatrix,
//                                                  B: Q^T, held in registers
//      P.V     O^T[d, r]  += V^T[d, pos] . P^T[pos, r]
//                                                  A: V by ldmatrix.trans,
//                                                  B: P^T from the score tile
//    The score tile's C fragment holds (pos, r) pairs where the B fragment
//    wants (r, pos): each 8x8 half is transposed in registers (movmatrix),
//    so P never goes through shared memory. Each warp walks its own 16
//    positions of every 64-position stage with its own (m, l, acc); the
//    warps merge in warp order at the end. K/V stages arrive through a ring
//    of cp.async copies (3 stages, 2 at Dh 256), rows padded by 16 bytes so
//    ldmatrix reads no bank twice; positions past c1 are zero-filled and
//    masked, never read from the cache.
//  * attend_cc (f32, and any other Dh the kernel takes): the CUDA cores, one
//    warp per position for the scores, one per query row for the softmax,
//    each thread owning rep * Dh / kThreads accumulators of P.V.
//
// Rounding points (both forms, the TPU kernel's and the plain version's):
// scores are products of the stored values summed in f32, then times
// `scale`; the online softmax runs in f32; p is rounded to T before P.V; the
// output is acc / max(l, 1e-20), cast once. Only the order of the f32 sums
// differs from the plain version.
#pragma once

#include <math_constants.h>

#include "common.cuh"

namespace dst {
namespace split {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStageRows = 16 * kWarps;  // positions per stage: a 16-row tile per warp
constexpr int kMaxPerThread = 16;        // attend_cc: rep * dh <= kThreads * kMaxPerThread

// Where a block's result goes: the output rows (one split) or the split's
// partial state, ml [B*Hq][n_splits][2] and acc [B*Hq][n_splits][Dh].
template <typename T>
struct Out {
  T* out;
  float* ml;
  float* acc;
  size_t row0;  // first query row of the kv head, b * hq + kvh * rep
  int n_splits, split, dh;
  __device__ void put(int r, int d, float m, float l, float a) const {
    const size_t row = row0 + r;
    if (n_splits == 1) {
      out[row * dh + d] = from_f32<T>(a / fmaxf(l, 1e-20f));
    } else {
      const size_t slot = row * n_splits + split;
      acc[slot * dh + d] = a;
      if (d == 0) {
        ml[2 * slot] = m;
        ml[2 * slot + 1] = l;
      }
    }
  }
};

// ------------------------------------------------------------ tensor cores
template <typename T>
struct Tc;
template <>
struct Tc<__nv_bfloat16> {
  __device__ static __forceinline__ void mma(float* d, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  __device__ static __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};
template <>
struct Tc<__half> {
  __device__ static __forceinline__ void mma(float* d, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  __device__ static __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// Four 8x8 b16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8. .trans hands out each matrix transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
// The transpose of an 8x8 b16 matrix held in the warp's fragment layout
// (lane l: row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1).
__device__ __forceinline__ uint32_t transpose8x8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

template <typename T, int DH>
struct TcShape {
  static constexpr int kStride = DH + 8;  // padded row (elements)
  static constexpr int kStages = DH >= 256 ? 2 : 3;
  static constexpr size_t kStage = (size_t)kStageRows * kStride;  // elements
  template <int NT>
  static size_t smem() {
    const size_t ring = 2 * kStages * kStage * sizeof(T);
    const size_t merge = (size_t)kWarps * NT * 8 * (DH + 2) * sizeof(float);
    return ring > merge ? ring : merge;
  }
};

// Rows provides krow(pos) / vrow(pos): pointers to a position's Dh stored
// elements. q_rows [rep][DH] in global memory.
template <typename T, int DH, int NT, class Rows>
__device__ __forceinline__ void attend_tc(const T* __restrict__ q_rows, const Rows& rows,
                                          const T* knh, const T* vnh, int idx, int c0,
                                          int c1, int rep, float scale, const Out<T>& o,
                                          unsigned char* smem) {
  using Sh = TcShape<T, DH>;
  constexpr int ST = Sh::kStages, STR = Sh::kStride, KD = DH / 16, R = NT * 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  T* k_sh = reinterpret_cast<T*>(smem);  // [ST][kStageRows][STR]
  T* v_sh = k_sh + ST * Sh::kStage;      // [ST][kStageRows][STR]
  const int n_st = (c1 - c0 + kStageRows - 1) / kStageRows;

  // one stage's K and V rows as one cp.async group; rows past c1 zero-filled
  auto stage = [&](int s) {
    constexpr int kVpr = DH * (int)sizeof(T) / 16;
    constexpr int kVec = 16 / (int)sizeof(T);
    const int base = c0 + s * kStageRows;
    T* kd = k_sh + (s % ST) * Sh::kStage;
    T* vd = v_sh + (s % ST) * Sh::kStage;
    for (int i = tid; i < kStageRows * kVpr; i += kThreads) {
      const int p = i / kVpr, c = (i - p * kVpr) * kVec, pos = base + p;
      const bool ok = pos < c1;
      const T* ks = pos == idx ? knh : rows.krow(ok ? pos : c0);
      const T* vs = pos == idx ? vnh : rows.vrow(ok ? pos : c0);
      cp_async16_zfill(kd + p * STR + c, ks + c, ok);
      cp_async16_zfill(vd + p * STR + c, vs + c, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < n_st) stage(s);
    cp_async_commit();
  }

  // Q^T as the B operand (B[k = d][n = r] = Q[r][d]), kept for the walk;
  // query rows past rep are zeros
  uint32_t qf[KD][NT][2];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int r = nt * 8 + g;
      const T* p = q_rows + (size_t)r * DH + kk * 16 + 2 * t;
      qf[kk][nt][0] = r < rep ? *reinterpret_cast<const uint32_t*>(p) : 0u;
      qf[kk][nt][1] = r < rep ? *reinterpret_cast<const uint32_t*>(p + 8) : 0u;
    }
  // per query row (nt, j): r = nt * 8 + 2t + j. acc^T: d-tiles of 16 x rows
  float m[NT][2], l[NT][2], acc[KD][NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    m[nt][0] = m[nt][1] = -CUDART_INF_F;
    l[nt][0] = l[nt][1] = 0.f;
#pragma unroll
    for (int mt = 0; mt < KD; ++mt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
  }

  for (int s = 0; s < n_st; ++s) {
    cp_async_wait<ST - 2>();
    __syncthreads();  // stage s visible; stage s-1's buffer free
    if (s + ST - 1 < n_st) stage(s + ST - 1);
    cp_async_commit();
    const int p0 = c0 + s * kStageRows + warp * 16;
    if (p0 >= c1) continue;  // this warp's tile lies past the split
    const T* ks = k_sh + (s % ST) * Sh::kStage + warp * 16 * STR;
    const T* vs = v_sh + (s % ST) * Sh::kStage + warp * 16 * STR;
    // scores: rows pos g, g + 8 of the tile; columns r 2t, 2t + 1
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, ks + ((lane & 7) + (lane & 8)) * STR + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) Tc<T>::mma(sc[nt], a, qf[kk][nt]);
    }
    float corr[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float s0 = p0 + g < c1 ? sc[nt][j] * scale : -CUDART_INF_F;
        const float s1 = p0 + g + 8 < c1 ? sc[nt][j + 2] * scale : -CUDART_INF_F;
        float mx = fmaxf(s0, s1);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float mn = fmaxf(m[nt][j], mx);  // finite: position p0 is live
        corr[nt][j] = expf(m[nt][j] - mn);     // 0 on the warp's first tile
        m[nt][j] = mn;
        const float e0 = expf(s0 - mn), e1 = expf(s1 - mn);
        l[nt][j] = l[nt][j] * corr[nt][j] + e0 + e1;
        sc[nt][j] = e0;
        sc[nt][j + 2] = e1;
      }
    // P^T as the B operand, p rounded to T: each 8-position half transposed
    uint32_t pb[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      pb[nt][0] = transpose8x8(Tc<T>::pack(sc[nt][0], sc[nt][1]));
      pb[nt][1] = transpose8x8(Tc<T>::pack(sc[nt][2], sc[nt][3]));
    }
#pragma unroll
    for (int mt = 0; mt < KD; ++mt) {
      uint32_t a[4];
      ldsm_x4_trans(a, vs + ((lane & 7) + ((lane >> 4) << 3)) * STR + mt * 16 + (lane & 8));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        acc[mt][nt][0] *= corr[nt][0];
        acc[mt][nt][1] *= corr[nt][1];
        acc[mt][nt][2] *= corr[nt][0];
        acc[mt][nt][3] *= corr[nt][1];
        Tc<T>::mma(acc[mt][nt], a, pb[nt]);
      }
    }
  }

  // the warps' states through shared memory, merged in warp order
  cp_async_wait<0>();
  __syncthreads();
  float* m_sh = reinterpret_cast<float*>(smem);  // [kWarps][R]
  float* l_sh = m_sh + kWarps * R;               // [kWarps][R]
  float* a_sh = l_sh + kWarps * R;               // [kWarps][R][DH]
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float ls = l[nt][j];
      ls += __shfl_xor_sync(0xffffffffu, ls, 4);
      ls += __shfl_xor_sync(0xffffffffu, ls, 8);
      ls += __shfl_xor_sync(0xffffffffu, ls, 16);
      if (g == 0) {
        m_sh[warp * R + nt * 8 + 2 * t + j] = m[nt][j];
        l_sh[warp * R + nt * 8 + 2 * t + j] = ls;
      }
    }
#pragma unroll
  for (int mt = 0; mt < KD; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = mt * 16 + g + (e >> 1) * 8, r = nt * 8 + 2 * t + (e & 1);
        a_sh[(size_t)(warp * R + r) * DH + d] = acc[mt][nt][e];
      }
  __syncthreads();
  for (int i = tid; i < rep * DH; i += kThreads) {
    const int r = i / DH, d = i - r * DH;
    float mm = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, m_sh[w * R + r]);  // warp 0 is live
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(m_sh[w * R + r] - mm);  // 0 for a warp that saw no position
      ll = fmaf(l_sh[w * R + r], c, ll);
      aa = fmaf(a_sh[(size_t)(w * R + r) * DH + d], c, aa);
    }
    o.put(r, d, mm, ll, aa);
  }
}

// --------------------------------------------------------------- CUDA cores
// Positions per copy batch of attend_cc: one buffer of K + V rows stays
// within 32 KB (two in flight).
template <typename T>
__host__ __device__ inline int cc_rows(int dh) {
  const int cs = 16384 / (dh * (int)sizeof(T));
  return cs > 64 ? 64 : (cs < 8 ? 8 : cs);
}

template <typename T>
__host__ __device__ inline size_t cc_smem(int rep, int dh) {
  const int cs = cc_rows<T>(dh);
  const size_t b = 4 * (size_t)cs * dh * sizeof(T)
                 + ((size_t)rep * dh + (size_t)rep * cs + 3 * (size_t)rep) * sizeof(float);
  return (b + 15) / 16 * 16;
}

template <typename T, class Rows>
__device__ __forceinline__ void cc_stage(T* k_dst, T* v_dst, const Rows& rows, const T* knh,
                                         const T* vnh, int c0, int cn, int idx, int dh) {
  constexpr int kVec = 16 / sizeof(T);
  const int vpr = dh / kVec;
  for (int i = threadIdx.x; i < cn * vpr; i += kThreads) {
    const int p = i / vpr, v = (i - p * vpr) * kVec, pos = c0 + p;
    cp_async16(k_dst + (size_t)p * dh + v, (pos == idx ? knh : rows.krow(pos)) + v);
    cp_async16(v_dst + (size_t)p * dh + v, (pos == idx ? vnh : rows.vrow(pos)) + v);
  }
  cp_async_commit();
}

template <typename T, class Rows>
__device__ __forceinline__ void attend_cc(const T* __restrict__ q_rows, const Rows& rows,
                                          const T* knh, const T* vnh, int idx, int c0,
                                          int c1, int rep, int dh, float scale,
                                          const Out<T>& o, unsigned char* smem) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cs = cc_rows<T>(dh);
  const size_t buf = (size_t)cs * dh;
  T* k_sh = reinterpret_cast<T*>(smem);                          // [2][cs][dh]
  T* v_sh = k_sh + 2 * buf;                                      // [2][cs][dh]
  float* q_sh = reinterpret_cast<float*>(v_sh + 2 * buf);        // [rep][dh]
  float* p_sh = q_sh + rep * dh;                                 // [rep][cs]
  float* m_sh = p_sh + rep * cs;                                 // [rep]
  float* l_sh = m_sh + rep;                                      // [rep]
  float* c_sh = l_sh + rep;                                      // [rep]
  const int n = c1 - c0, n_chunks = (n + cs - 1) / cs;

  cc_stage(k_sh, v_sh, rows, knh, vnh, c0, min(cs, n), idx, dh);
  for (int i = tid; i < rep * dh; i += kThreads) q_sh[i] = to_f32(q_rows[i]);
  if (tid < rep) {
    m_sh[tid] = -CUDART_INF_F;
    l_sh[tid] = 0.f;
  }
  float acc[kMaxPerThread];
#pragma unroll
  for (int j = 0; j < kMaxPerThread; ++j) acc[j] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    const int cc0 = c * cs, cn = min(cs, n - cc0);
    const size_t cur = (size_t)(c & 1) * buf;
    if (c + 1 < n_chunks) {
      cc_stage(k_sh + (buf - cur), v_sh + (buf - cur), rows, knh, vnh, c0 + cc0 + cs,
               min(cs, n - cc0 - cs), idx, dh);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kb = k_sh + cur;
    const T* vb = v_sh + cur;
    for (int p = warp; p < cn; p += kWarps) {  // scores, one warp per position
      const T* krow = kb + (size_t)p * dh;
      for (int r = 0; r < rep; ++r) {
        float part = 0.f;
        for (int i = lane; i < dh; i += 32) part = fmaf(q_sh[r * dh + i], to_f32(krow[i]), part);
        part = warp_sum(part);
        if (lane == 0) p_sh[r * cs + p] = part * scale;
      }
    }
    __syncthreads();
    for (int r = warp; r < rep; r += kWarps) {  // online softmax, one warp per row
      float mx = -CUDART_INF_F;
      for (int p = lane; p < cn; p += 32) mx = fmaxf(mx, p_sh[r * cs + p]);
      mx = warp_max(mx);
      const float m_old = m_sh[r], m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int p = lane; p < cn; p += 32) {
        const float e = expf(p_sh[r * cs + p] - m_new);
        p_sh[r * cs + p] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_sh[r] = corr;
        l_sh[r] = l_sh[r] * corr + sum;
        m_sh[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMaxPerThread; ++j) {  // P.V, p rounded to T
      const int i = tid + j * kThreads;
      if (i < rep * dh) {
        const int r = i / dh, col = i - r * dh;
        const float* prow = p_sh + r * cs;
        float a = acc[j] * c_sh[r];
        for (int p = 0; p < cn; ++p)
          a = fmaf(to_f32(from_f32<T>(prow[p])), to_f32(vb[(size_t)p * dh + col]), a);
        acc[j] = a;
      }
    }
    __syncthreads();  // this buffer is restaged next iteration
  }
#pragma unroll
  for (int j = 0; j < kMaxPerThread; ++j) {
    const int i = tid + j * kThreads;
    if (i < rep * dh) {
      const int r = i / dh;
      o.put(r, i - r * dh, m_sh[r], l_sh[r], acc[j]);
    }
  }
}

// ------------------------------------------------------------------ merge
// One query row's live splits, merged in split order (no atomics: the result
// repeats bit for bit). The live count comes from idx on the device, so
// splits that returned early are never read.
template <typename T>
__global__ void __launch_bounds__(kThreads)
merge_splits(const float* __restrict__ ml, const float* __restrict__ acc, T* __restrict__ out,
             const int* __restrict__ idx_vec, int idx_scalar, int hq, int s_max, int dh,
             int chunk, int n_splits) {
  const int b = blockIdx.y;
  const size_t row = (size_t)b * hq + blockIdx.x;
  const int idx = idx_vec ? idx_vec[b] : idx_scalar;
  const int n_pos = min(idx, s_max - 1) + 1;
  const int n_live = n_pos > 0 ? min((n_pos - 1) / chunk + 1, n_splits) : 0;
  const float* m = ml + 2 * row * n_splits;
  const float* a = acc + row * n_splits * dh;
  float mm = -CUDART_INF_F;
  for (int j = 0; j < n_live; ++j) mm = fmaxf(mm, m[2 * j]);
  for (int d = threadIdx.x; d < dh; d += kThreads) {
    float ll = 0.f, aa = 0.f;
    for (int j = 0; j < n_live; ++j) {
      const float c = expf(m[2 * j] - mm);
      ll = fmaf(m[2 * j + 1], c, ll);
      aa = fmaf(a[(size_t)j * dh + d], c, aa);
    }
    out[row * dh + d] = from_f32<T>(n_live ? aa / fmaxf(ll, 1e-20f) : 0.f);
  }
}

}  // namespace split
}  // namespace dst

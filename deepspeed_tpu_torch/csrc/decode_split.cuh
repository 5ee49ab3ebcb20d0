// The attention body of the fused decode steps (decode_step.cu: the slot
// cache, kernel B; block_decode_step.cu: the block pool, kernel C), split
// along the cache: one CUDA block of kThreads attends the `rep` query heads
// of one kv head of one slot over positions c0..c1-1 (one split of the valid
// prefix). A row policy says where a position's K/V row lives (a contiguous
// cache head, or a slot's block table) and which positions read the new
// token's row instead of the cache (`fresh`: position idx, or any position
// whose pool row is the one being written), so no read waits on the write.
// It leaves the split's online-softmax state (m, l, unnormalised acc, f32)
// for the merge (merge_row), or, when the prefix is one split, the output
// itself.
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
//    An 8-bit pool (Rows::kRaw: int8 or fp8 e4m3 payloads with one bf16
//    scale per row) stages the raw payload instead, half the bytes of bf16
//    (cp.async cannot convert), with each row's scale loaded into registers
//    one stage ahead and parked in shared memory. Each warp then
//    dequantizes its own 16 rows of K into its own compute-type tile, as
//    T(f32(payload) * f32(scale)) (the value the plain version's gather
//    stores), runs ldmatrix on it for the scores, and dequantizes V into
//    the same tile for P.V: no block barrier, only the warp's, and one tile
//    per warp keeps the block at 68 KB (three blocks per SM). The
//    conversions avoid the conversion pipe (a quarter of the FMA rate):
//    int8 through an f32 magic number, and one bf16x2 multiply per pair.
//  * attend_cc (f32, and any other Dh the kernels take): the CUDA cores.
//    K/V batches arrive through two cp.async buffers (an 8-bit pool is
//    dequantized as it is staged, loads through registers). Each warp takes
//    every fourth position of a batch for up to 8 query rows (4 where a
//    lane holds 8 columns) and keeps their (m, l, acc) in registers, each
//    lane the columns lane + 32 e: per group of 4 positions it loads the K
//    rows once for all the rows, runs the rows x positions butterflies side
//    by side, updates the softmax and adds P.V. A group has no branch: Dh
//    64, 128 and 256 and the row count are compile-time, rows past rep
//    score a clamped row that is never stored, and positions past the
//    batch read its first position with p = 0 (the run-time bounds of the
//    body's first form kept its loads, shuffles and exps from overlapping).
//    The warps merge in warp order at the end; further rows, and columns
//    past 256, take further passes over the positions.
//
// Rounding points (both forms, the TPU kernels' and the plain versions'):
// scores are products of the stored values summed in f32, then times
// `scale`; the online softmax runs in f32; p is rounded to T before P.V; the
// output is acc / max(l, 1e-20), cast once. Only the order of the f32 sums
// differs from the plain version.
#pragma once

#include <cuda_fp8.h>
#include <math_constants.h>

#include "common.cuh"

namespace dst {
namespace split {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStageRows = 16 * kWarps;  // positions per stage: a 16-row tile per warp
constexpr int kMaxPerThread = 16;        // rep * dh <= kThreads * kMaxPerThread
// attend_cc: query rows a warp carries at once, columns a lane owns
// (lane + 32 e, so 256 a pass), positions scored together
constexpr int kCcRows = 8;
constexpr int kCcCols = 8;
constexpr int kCcGroup = 4;

using fp8_t = __nv_fp8_storage_t;        // e4m3 bytes



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

// Row policies (decode_step.cu SlotRows, block_decode_step.cu BlockRows):
//   kRaw, Elem   false and T: rows in the compute type; true and int8 or
//                fp8_t: 8-bit payloads with one bf16 scale per row
//   at(pos, kr, vr) -> fresh
//                pointers to position pos's stored K and V rows, and whether
//                pos reads the new token's row instead (the cache's row may
//                be being written by this launch)
//   fresh(pos)   the same flag alone
//   kn, vn       (kRaw false) the new token's K/V row, in global memory
//   kq_new, vq_new, kn_scale(), vn_scale()
//                (kRaw true) its quantized payload and its scales, in shared
//                memory (set by the prep step, read after its barrier)
//   kscale(pos), vscale(pos)
//                (kRaw true) a cached row's scales as f32

// Two payload values (bytes b, b + 1 of `w`) as exact f32, without the
// conversion pipe (a quarter of the FMA rate): int8 through the f32 magic
// 2^23 + (x + 128) (one byte permute and one add each); fp8 e4m3 through
// one e4m3x2 -> f16x2 convert.
__device__ __forceinline__ float2 payload2_f32(uint32_t w, int b, int8_t) {
  const uint32_t u = w ^ 0x80808080u;  // x + 128 in each byte
  return make_float2(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u | b)) - 8388736.f,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u | (b + 1))) -
                         8388736.f);
}
__device__ __forceinline__ float2 payload2_f32(uint32_t w, int b, fp8_t) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(w >> (8 * b)), __NV_E4M3);
  return __half22float2(*reinterpret_cast<const __half2*>(&h));
}

// T(f32(x) * f32(s)) for a pair of payload values, packed. bf16: x has at
// most 8 significant bits, so the f32 value's top half is x in bf16, exact;
// and x * s is exact in f32 (at most 16 significant bits), so one bf16x2
// multiply rounds it once, to the plain version's value.
template <typename T>
struct Deq;
template <>
struct Deq<__nv_bfloat16> {
  __device__ static __forceinline__ uint32_t pair(float2 x, __nv_bfloat162 s2) {
    uint32_t xb = __byte_perm(__float_as_uint(x.x), __float_as_uint(x.y), 0x7632u);
    __nv_bfloat162 p = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&xb), s2);
    return *reinterpret_cast<uint32_t*>(&p);
  }
};
template <>
struct Deq<__half> {
  __device__ static __forceinline__ uint32_t pair(float2 x, __nv_bfloat162 s2) {
    const float s = __low2float(s2);
    return Tc<__half>::pack(x.x * s, x.y * s);
  }
};

// 8 payload values times their row scale (a bf16, held as f32), rounded to
// T, as one 16-byte store.
template <typename T, typename S>
__device__ __forceinline__ void dequant8(T* dst, const S* src, float s) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src);
  const __nv_bfloat162 s2 = __float2bfloat162_rn(s);  // exact: s is a bf16
  uint4 w;
  w.x = Deq<T>::pair(payload2_f32(raw.x, 0, S{}), s2);
  w.y = Deq<T>::pair(payload2_f32(raw.x, 2, S{}), s2);
  w.z = Deq<T>::pair(payload2_f32(raw.y, 0, S{}), s2);
  w.w = Deq<T>::pair(payload2_f32(raw.y, 2, S{}), s2);
  *reinterpret_cast<uint4*>(dst) = w;
}

template <typename T, int DH>
struct TcShape {
  static constexpr int kStride = DH + 8;  // padded row (elements)
  static constexpr int kStages = DH >= 256 ? 2 : 3;
  static constexpr size_t kStage = (size_t)kStageRows * kStride;  // elements
  static constexpr size_t kRawStage = (size_t)kStageRows * DH;    // payload bytes
  static constexpr size_t kTile = (size_t)16 * kStride;           // one warp's rows
  // RAW: the payload ring, its scales and one compute-type tile per warp
  template <int NT, bool RAW = false>
  static size_t smem() {
    const size_t ring = RAW ? 2 * kStages * (kRawStage + kStageRows * sizeof(float)) +
                                  kWarps * kTile * sizeof(T)
                            : 2 * kStages * kStage * sizeof(T);
    const size_t merge = (size_t)kWarps * NT * 8 * (DH + 2) * sizeof(float);
    return ring > merge ? ring : merge;
  }
};

// q_rows [rep][DH] in global memory. prep() runs once the first stages'
// copies are in flight, before any read of the new token's row (kernel C
// writes, and quantizes, that row there).
template <typename T, int DH, int NT, class Rows, class Prep>
__device__ __forceinline__ void attend_tc(const T* __restrict__ q_rows, const Rows& rows,
                                          int c0, int c1, int rep, float scale,
                                          const Out<T>& o, unsigned char* smem,
                                          const Prep& prep) {
  using Sh = TcShape<T, DH>;
  using S = typename Rows::Elem;
  constexpr bool RAW = Rows::kRaw;
  constexpr int ST = Sh::kStages, STR = Sh::kStride, KD = DH / 16, R = NT * 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  // compute-type rows: [ST][kStageRows][STR] each
  T* k_sh = reinterpret_cast<T*>(smem);
  T* v_sh = k_sh + ST * Sh::kStage;
  // 8-bit rows: [ST][kStageRows][DH] payloads, [ST][kStageRows] scales, and
  // this warp's [16][STR] dequantized tile (K's, then V's)
  S* kr_sh = reinterpret_cast<S*>(smem);
  S* vr_sh = kr_sh + ST * Sh::kRawStage;
  float* ksc_sh = reinterpret_cast<float*>(vr_sh + ST * Sh::kRawStage);
  float* vsc_sh = ksc_sh + ST * kStageRows;
  T* kt_sh = reinterpret_cast<T*>(vsc_sh + ST * kStageRows) + warp * Sh::kTile;
  const int n_st = (c1 - c0 + kStageRows - 1) / kStageRows;
  float ks_pf = 0.f, vs_pf = 0.f;  // 8-bit: the issued stage's scales, in flight

  // one stage's K and V rows as one cp.async group; rows past c1 (and, for a
  // payload ring, fresh rows) zero-filled and not read
  auto stage = [&](int s) {
    const int base = c0 + s * kStageRows;
    if constexpr (RAW) {
      constexpr int kVpr = DH / 16;
      S* kd = kr_sh + (s % ST) * Sh::kRawStage;
      S* vd = vr_sh + (s % ST) * Sh::kRawStage;
      for (int i = tid; i < kStageRows * kVpr; i += kThreads) {
        const int p = i / kVpr, c = (i - p * kVpr) * 16, pos = base + p;
        const S* ks;
        const S* vs;
        const bool fresh = rows.at(pos < c1 ? pos : c0, ks, vs);
        const bool ok = pos < c1 && !fresh;
        cp_async16_zfill(kd + p * DH + c, ks + c, ok);
        cp_async16_zfill(vd + p * DH + c, vs + c, ok);
      }
      if (tid < kStageRows) {
        const int pos = base + tid;
        ks_pf = pos < c1 ? rows.kscale(pos) : 0.f;
        vs_pf = pos < c1 ? rows.vscale(pos) : 0.f;
      }
    } else {
      constexpr int kVpr = DH * (int)sizeof(T) / 16;
      constexpr int kVec = 16 / (int)sizeof(T);
      T* kd = k_sh + (s % ST) * Sh::kStage;
      T* vd = v_sh + (s % ST) * Sh::kStage;
      for (int i = tid; i < kStageRows * kVpr; i += kThreads) {
        const int p = i / kVpr, c = (i - p * kVpr) * kVec, pos = base + p;
        const bool ok = pos < c1;
        const T* ks;
        const T* vs;
        if (rows.at(ok ? pos : c0, ks, vs) && ok) {
          ks = rows.kn;
          vs = rows.vn;
        }
        cp_async16_zfill(kd + p * STR + c, ks + c, ok);
        cp_async16_zfill(vd + p * STR + c, vs + c, ok);
      }
    }
  };
  // 8-bit: park the scales of stage s (loaded when it was issued) in its slot
  auto park = [&](int s) {
    if (tid < kStageRows) {
      ksc_sh[(s % ST) * kStageRows + tid] = ks_pf;
      vsc_sh[(s % ST) * kStageRows + tid] = vs_pf;
    }
  };
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < n_st) {
      stage(s);
      if constexpr (RAW) park(s);
    }
    cp_async_commit();
  }
  prep();

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
    if constexpr (RAW) {
      if (s >= 1 && s + ST - 2 < n_st) park(s + ST - 2);  // issued last iteration
    }
    cp_async_wait<ST - 2>();
    __syncthreads();  // stage s visible; stage s-1's buffer free
    if (s + ST - 1 < n_st) stage(s + ST - 1);
    cp_async_commit();
    const int p0 = c0 + s * kStageRows + warp * 16;
    if (p0 >= c1) continue;  // this warp's tile lies past the split
    const T* ks;
    const T* vs;
    // 8-bit: which of the warp's 16 rows read the new token's row, and this
    // stage's V payload and scales (dequantized after the scores)
    unsigned fresh = 0;
    const S* vr_st = nullptr;
    const float* vsc_st = nullptr;
    // rows of payload (+ the new row's for fresh rows) times their scales,
    // into a [16][STR] compute-type tile
    auto dequant_rows = [&](T* tile, const auto* raw, const auto* fresh_row, const float* sc,
                            float fresh_s) {
      constexpr int kCh = DH / 8;  // 8-byte payload chunks per row
#pragma unroll
      for (int i = lane; i < 16 * kCh; i += 32) {
        const int r = i / kCh, c = (i - r * kCh) * 8;
        const bool f = (fresh >> r) & 1u;
        dequant8(tile + r * STR + c, f ? fresh_row + c : raw + r * DH + c, f ? fresh_s : sc[r]);
      }
    };
    if constexpr (RAW) {
      // this warp's 16 rows, dequantized into its own tiles; a fresh row
      // takes the new token's payload and scales
      const S* kr = kr_sh + (s % ST) * Sh::kRawStage + warp * 16 * DH;
      const S* vr = vr_sh + (s % ST) * Sh::kRawStage + warp * 16 * DH;  // V: after the scores
      const float* ksc = ksc_sh + (s % ST) * kStageRows + warp * 16;
      const float* vsc = vsc_sh + (s % ST) * kStageRows + warp * 16;
      fresh = __ballot_sync(0xffffffffu, lane < 16 && p0 + lane < c1 && rows.fresh(p0 + lane));
      vr_st = vr;
      vsc_st = vsc;
      dequant_rows(kt_sh, kr, rows.kq_new, ksc, rows.kn_scale());
      __syncwarp();
      ks = kt_sh;
      vs = kt_sh;  // V takes the tile once the scores have read K
    } else {
      ks = k_sh + (s % ST) * Sh::kStage + warp * 16 * STR;
      vs = v_sh + (s % ST) * Sh::kStage + warp * 16 * STR;
    }
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
    if constexpr (RAW) {
      __syncwarp();  // every lane has read K from the tile
      dequant_rows(kt_sh, vr_st, rows.vq_new, vsc_st, rows.vn_scale());
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
    if constexpr (RAW) __syncwarp();  // V's tile is complete
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

// attend_cc's shared memory: q in f32, then the two K/V buffers, which the
// merge reuses ([kWarps][kCcRows] m and l, [kWarps][kCcRows][<= 256] acc).
template <typename T>
__host__ __device__ inline size_t cc_smem(int rep, int dh) {
  const size_t stage = 4 * (size_t)cc_rows<T>(dh) * dh * sizeof(T);
  const size_t merge = (size_t)kWarps * kCcRows * (2 + 32 * kCcCols) * sizeof(float);
  const size_t b = (size_t)rep * dh * sizeof(float) + (stage > merge ? stage : merge);
  return (b + 15) / 16 * 16;
}

// Start the copies of K and V rows c0..c0+cn-1 into [cn][dh] buffers as one
// cp.async group. An 8-bit pool is dequantized on the way instead (loads
// through registers: only the f32 path and odd head widths take this body).
template <typename T, class Rows>
__device__ __forceinline__ void cc_stage(T* k_dst, T* v_dst, const Rows& rows, int c0, int cn,
                                         int dh) {
  using S = typename Rows::Elem;
  if constexpr (Rows::kRaw) {
    const int vpr = dh / 16;
    for (int i = threadIdx.x; i < cn * vpr; i += kThreads) {
      const int p = i / vpr, v = (i - p * vpr) * 16, pos = c0 + p;
      const S* ks;
      const S* vs;
      const bool f = rows.at(pos, ks, vs);
      const uint4 kraw = *reinterpret_cast<const uint4*>((f ? rows.kq_new : ks) + v);
      const uint4 vraw = *reinterpret_cast<const uint4*>((f ? rows.vq_new : vs) + v);
      const float ksc = f ? rows.kn_scale() : rows.kscale(pos);
      const float vsc = f ? rows.vn_scale() : rows.vscale(pos);
      const uint32_t* kw = reinterpret_cast<const uint32_t*>(&kraw);
      const uint32_t* vw = reinterpret_cast<const uint32_t*>(&vraw);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 kx = payload2_f32(kw[j / 2], 2 * (j % 2), S{});
        const float2 vx = payload2_f32(vw[j / 2], 2 * (j % 2), S{});
        T* kd = k_dst + (size_t)p * dh + v + 2 * j;
        T* vd = v_dst + (size_t)p * dh + v + 2 * j;
        kd[0] = from_f32<T>(kx.x * ksc);
        kd[1] = from_f32<T>(kx.y * ksc);
        vd[0] = from_f32<T>(vx.x * vsc);
        vd[1] = from_f32<T>(vx.y * vsc);
      }
    }
  } else {
    constexpr int kVec = 16 / sizeof(T);
    const int vpr = dh / kVec;
    for (int i = threadIdx.x; i < cn * vpr; i += kThreads) {
      const int p = i / vpr, v = (i - p * vpr) * kVec, pos = c0 + p;
      const T* ks;
      const T* vs;
      if (rows.at(pos, ks, vs)) {
        ks = rows.kn;
        vs = rows.vn;
      }
      cp_async16(k_dst + (size_t)p * dh + v, ks + v);
      cp_async16(v_dst + (size_t)p * dh + v, vs + v);
    }
  }
  cp_async_commit();
}

// One pass of attend_cc over all positions for query rows r0.. (up to R)
// and output columns d0.. (up to 32 * NE). DHC > 0: Dh is DHC (64, 128 or
// 256) and NE = DHC / 32, so the pass covers every column and no column
// needs a bound; DHC == 0: Dh is dh at run time, columns past it are
// masked. Rows past rep score a clamped row and are never stored, and a
// group's positions past the batch read its first position with p = 0, so
// a group's work has no branch.
template <typename T, int R, int NE, int DHC, class Rows>
__device__ __forceinline__ void cc_pass(const float* __restrict__ q_sh, T* k_sh, T* v_sh,
                                        float* mg, const Rows& rows, int c0, int c1,
                                        int rep, int dh_rt, int r0, int d0, float scale,
                                        const Out<T>& o) {
  const int dh = DHC > 0 ? DHC : dh_rt;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cs = cc_rows<T>(dh);
  const size_t buf = (size_t)cs * dh;
  const int n = c1 - c0, n_chunks = (n + cs - 1) / cs;
  const int n_t = min(R, rep - r0);
  int qrow[R];  // rows past rep read the last row (never stored)
#pragma unroll
  for (int t = 0; t < R; ++t) qrow[t] = min(r0 + t, rep - 1) * dh;
  float m[R], l[R], acc[R][NE];
#pragma unroll
  for (int t = 0; t < R; ++t) {
    m[t] = -CUDART_INF_F;
    l[t] = 0.f;
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[t][e] = 0.f;
  }
  __syncthreads();  // q_sh written; the buffers' last readers are done
  cc_stage(k_sh, v_sh, rows, c0, min(cs, n), dh);
  for (int c = 0; c < n_chunks; ++c) {
    const int cc0 = c * cs, cn = min(cs, n - cc0);
    const size_t cur = (size_t)(c & 1) * buf;
    if (c + 1 < n_chunks) {
      cc_stage(k_sh + (buf - cur), v_sh + (buf - cur), rows, c0 + cc0 + cs,
               min(cs, n - cc0 - cs), dh);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kb = k_sh + cur;
    const T* vb = v_sh + cur;
    // positions warp, warp + 4, ... of the batch, kCcGroup at a time
    for (int u0 = warp; u0 < cn; u0 += kWarps * kCcGroup) {
      bool ok[kCcGroup];
      int prow[kCcGroup];
#pragma unroll
      for (int j = 0; j < kCcGroup; ++j) {
        ok[j] = u0 + kWarps * j < cn;
        prow[j] = (ok[j] ? u0 + kWarps * j : u0) * dh;
      }
      float s[R][kCcGroup];
#pragma unroll
      for (int t = 0; t < R; ++t)
#pragma unroll
        for (int j = 0; j < kCcGroup; ++j) s[t][j] = 0.f;
      for (int k0 = 0; k0 < dh; k0 += 32 * NE) {  // scores over all of Dh
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          const int col = k0 + lane + 32 * e;
          const bool in = DHC > 0 || col < dh;
          float kr[kCcGroup];
#pragma unroll
          for (int j = 0; j < kCcGroup; ++j) kr[j] = in ? to_f32(kb[prow[j] + col]) : 0.f;
#pragma unroll
          for (int t = 0; t < R; ++t) {
            const float qv = in ? q_sh[qrow[t] + col] : 0.f;
#pragma unroll
            for (int j = 0; j < kCcGroup; ++j) s[t][j] = fmaf(qv, kr[j], s[t][j]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < R; ++t)
#pragma unroll
        for (int j = 0; j < kCcGroup; ++j) s[t][j] = warp_sum(s[t][j]) * scale;
      // online softmax per row (s becomes p), then P.V with p rounded to T
#pragma unroll
      for (int t = 0; t < R; ++t) {
        float mx = s[t][0];  // position u0 < cn
#pragma unroll
        for (int j = 1; j < kCcGroup; ++j) mx = ok[j] ? fmaxf(mx, s[t][j]) : mx;
        const float m_new = fmaxf(m[t], mx);
        const float corr = expf(m[t] - m_new);  // 0 on the first group
        l[t] *= corr;
#pragma unroll
        for (int e = 0; e < NE; ++e) acc[t][e] *= corr;
#pragma unroll
        for (int j = 0; j < kCcGroup; ++j) {
          const float pj = ok[j] ? expf(s[t][j] - m_new) : 0.f;
          l[t] += pj;
          s[t][j] = to_f32(from_f32<T>(pj));
        }
        m[t] = m_new;
      }
#pragma unroll
      for (int j = 0; j < kCcGroup; ++j) {
        float vr[NE];
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          const int col = d0 + lane + 32 * e;
          vr[e] = DHC > 0 || col < dh ? to_f32(vb[prow[j] + col]) : 0.f;
        }
#pragma unroll
        for (int t = 0; t < R; ++t)
#pragma unroll
          for (int e = 0; e < NE; ++e) acc[t][e] = fmaf(s[t][j], vr[e], acc[t][e]);
      }
    }
    __syncthreads();  // this buffer is restaged next iteration
  }
  // merge the warps in warp order: [kWarps][R] m and l, then
  // [kWarps][R][32 * NE] acc, over the retired K/V buffers
  float* mg_m = mg;
  float* mg_l = mg + kWarps * R;
  float* mg_a = mg_l + kWarps * R;
  constexpr int kCols = 32 * NE;
#pragma unroll
  for (int t = 0; t < R; ++t) {
    if (lane == 0) {
      mg_m[warp * R + t] = m[t];
      mg_l[warp * R + t] = l[t];
    }
#pragma unroll
    for (int e = 0; e < NE; ++e) mg_a[(warp * R + t) * kCols + lane + 32 * e] = acc[t][e];
  }
  __syncthreads();
  const int cols = min(dh - d0, kCols);
  for (int i = threadIdx.x; i < n_t * cols; i += kThreads) {
    const int t = i / cols, col = i - t * cols;
    float mm = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, mg_m[w * R + t]);  // warp 0 saw c0
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float cw = expf(mg_m[w * R + t] - mm);  // 0 for a warp with no position
      ll = fmaf(mg_l[w * R + t], cw, ll);
      aa = fmaf(mg_a[(w * R + t) * kCols + col], cw, aa);
    }
    o.put(r0 + t, d0 + col, mm, ll, aa);
  }
}

// attend_cc's row passes at one column range: kCcRows rows a pass (4 when a
// lane holds 8 columns), the last pass at the fewest of 1, 2, 4 that holds
// its rows.
template <typename T, int NE, int DHC, class Rows>
__device__ __forceinline__ void cc_passes(const float* q_sh, T* k_sh, T* v_sh, float* mg,
                                          const Rows& rows, int c0, int c1, int rep, int dh,
                                          int d0, float scale, const Out<T>& o) {
  constexpr int kR = NE <= 4 ? kCcRows : kCcRows / 2;
  for (int r0 = 0; r0 < rep; r0 += kR) {
    const int left = rep - r0;
    if (left >= kR)
      cc_pass<T, kR, NE, DHC>(q_sh, k_sh, v_sh, mg, rows, c0, c1, rep, dh, r0, d0, scale, o);
    else if (left > 2)
      cc_pass<T, 4, NE, DHC>(q_sh, k_sh, v_sh, mg, rows, c0, c1, rep, dh, r0, d0, scale, o);
    else if (left == 2)
      cc_pass<T, 2, NE, DHC>(q_sh, k_sh, v_sh, mg, rows, c0, c1, rep, dh, r0, d0, scale, o);
    else
      cc_pass<T, 1, NE, DHC>(q_sh, k_sh, v_sh, mg, rows, c0, c1, rep, dh, r0, d0, scale, o);
  }
}

// prep() as attend_tc's, here before the first copies: an 8-bit pool's
// staging reads the new token's row.
template <typename T, class Rows, class Prep>
__device__ __forceinline__ void attend_cc(const T* __restrict__ q_rows, const Rows& rows,
                                          int c0, int c1, int rep, int dh, float scale,
                                          const Out<T>& o, unsigned char* smem,
                                          const Prep& prep) {
  prep();
  __syncthreads();  // what prep left in shared memory is visible to the copies
  float* q_sh = reinterpret_cast<float*>(smem);                     // [rep][dh]
  T* k_sh = reinterpret_cast<T*>(q_sh + rep * dh);                  // [2][cs][dh]
  T* v_sh = k_sh + 2 * (size_t)cc_rows<T>(dh) * dh;                 // [2][cs][dh]
  float* mg = reinterpret_cast<float*>(k_sh);                       // merge, reuses K/V
  for (int i = threadIdx.x; i < rep * dh; i += kThreads) q_sh[i] = to_f32(q_rows[i]);
  switch (dh) {
    case 64:
      cc_passes<T, 2, 64>(q_sh, k_sh, v_sh, mg, rows, c0, c1, rep, dh, 0, scale, o);
      break;
    case 128:
      cc_passes<T, 4, 128>(q_sh, k_sh, v_sh, mg, rows, c0, c1, rep, dh, 0, scale, o);
      break;
    case 256:
      cc_passes<T, 8, 256>(q_sh, k_sh, v_sh, mg, rows, c0, c1, rep, dh, 0, scale, o);
      break;
    default:  // column passes of 256
      for (int d0 = 0; d0 < dh; d0 += 32 * kCcCols)
        cc_passes<T, kCcCols, 0>(q_sh, k_sh, v_sh, mg, rows, c0, c1, rep, dh, d0, scale, o);
  }
}

// ------------------------------------------------------------------ merge
// One query row's live splits, merged in split order (no atomics: the result
// repeats bit for bit). The live count comes from idx on the device, so
// splits that returned early are never read. idx_step: 1 for one index per
// slot (idx_vec[b]), 0 for one index shared by every slot. Launched as a
// programmatic dependent of the split kernel (flash_decode.cu's
// flash_decode_merge), it may start before that kernel ends:
// griddepcontrol.wait holds it until the split kernel has finished and its
// partials are visible (a no-op after a plain launch).
template <typename T>
__device__ __forceinline__ void merge_row(const float* __restrict__ ml,
                                          const float* __restrict__ acc, T* __restrict__ out,
                                          const int* __restrict__ idx_vec, int idx_step,
                                          int idx_scalar, int hq, int s_max, int dh, int chunk,
                                          int n_splits) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int b = blockIdx.y;
  const size_t row = (size_t)b * hq + blockIdx.x;
  const int idx = idx_vec ? idx_vec[b * idx_step] : idx_scalar;
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

// The merge of kernels B and C: grid (hq, slots).
template <typename T>
__global__ void __launch_bounds__(kThreads)
merge_splits(const float* __restrict__ ml, const float* __restrict__ acc, T* __restrict__ out,
             const int* __restrict__ idx_vec, int idx_step, int idx_scalar, int hq,
             int s_max, int dh, int chunk, int n_splits) {
  merge_row<T>(ml, acc, out, idx_vec, idx_step, idx_scalar, hq, s_max, dh, chunk, n_splits);
}

}  // namespace split
}  // namespace dst

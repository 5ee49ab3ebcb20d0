// FlashAttention-2 forward and backward on flat [BH, T, Dh] operands.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/flash_attention.py:
//   * dst_flash_fwd     <- _fwd_kernel     (:80, pallas_call :278)
//   * dst_flash_bwd_dq  <- _bwd_dq_kernel  (:121, pallas_call :344)
//   * dst_flash_bwd_dkv <- _bwd_dkv_kernel (:154, pallas_call :364)
//
// Bound on the H100: near the ridge. At GPT-2 774M training widths (T 1024,
// Dh 64, causal) the forward does 4 * T^2/2 * Dh FLOP per head on the
// 4 * T * Dh * 2 bytes it must move, ~256 FLOP per byte, just under the
// card's ~295 FLOP/byte bf16 ridge (bytes bound it by a hair; 512 FLOP/byte
// without the mask); the backward kernels do 307 (dQ) and 341 (dK/dV),
// bound by operations. So the bf16/fp16 path runs its products on the
// tensor cores (mma.sync m16n8k16, f32 accumulation) and keeps every score,
// probability and dS tile in registers; only Q/K/V/dO tiles go through
// shared memory. A simple form that is right comes first: no wgmma, no TMA,
// no warp specialisation yet.
//
// Design:
//  * One block of 4 warps per (bh, 64-row tile); each warp owns 16 rows.
//    The walk over the other operand's tiles is a loop inside the block (the
//    TPU grid's sequential dimension), with the next K/V (or Q/dO) tile
//    copied into shared memory with cp.async while this one is computed.
//  * Causal masking is top-left aligned (query row i sees key columns
//    <= i, the reference's _causal_mask): whole tiles past the diagonal are
//    skipped, the diagonal tile is masked element by element. Rows past T
//    (the ragged tail tile) load as zeros and are masked to p = 0, so no
//    garbage reaches a product; they are never written.
//  * Rounding points of the reference: products take storage-dtype operands
//    and accumulate in f32; p (forward, dQ and dK/dV) and dS are rounded to
//    the storage dtype as the A operand of the second-stage products (P.V,
//    dS.K, P^T.dO, dS^T.Q). The score tile's C fragment is re-read as that A
//    fragment in registers (the m16n8k16 C and A layouts line up).
//  * Forward: online softmax with running max m (init -1e30) and sum l in
//    f32, per-thread partial l reduced once at the end; O = acc /
//    max(l, 1e-20) in the storage dtype, lse = m + log(max(l, 1e-20)) in f32.
//  * Backward: p = exp(s - lse), ds = p * (dp - delta) from the caller's
//    global lse and delta = rowsum(dO * O); dQ and dK are scaled once at the
//    end (s was computed from unscaled q). Two kernels and no atomics: every
//    output element is summed by one thread in a fixed order, so dQ, dK and
//    dV are bit-identical run to run.
//  * f32 operands take a CUDA-core path of the same structure (4 threads per
//    row, each owning a quarter of Dh, dot products reduced by shuffles).
#include <math_constants.h>

#include "common.cuh"

namespace {

using namespace dst;

constexpr int kThreads = 128;       // 4 warps
constexpr float kMInit = -1e30f;    // the reference's _NEG_INF, the initial m

// ------------------------------------------------------------ tensor cores
template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  __device__ static __forceinline__ void run(float* d, const uint32_t* a,
                                             const uint32_t* b) {
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
struct Mma<__half> {
  __device__ static __forceinline__ void run(float* d, const uint32_t* a,
                                             const uint32_t* b) {
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

// Two stored 16-bit elements as one 32-bit operand register (lo in the low
// half, the element order of the fragment layouts).
template <typename T>
__device__ __forceinline__ uint32_t pack_raw(T lo, T hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragment loads from a row-major shared tile with row stride S elements;
// g = lane / 4, t = lane % 4 (the PTX groupID / threadID_in_group).
// A (16 x 16): rows r0.., columns k0.. of M.
template <int S, typename T>
__device__ __forceinline__ void frag_a(uint32_t* a, const T* m, int r0, int k0,
                                       int g, int t) {
  const T* p0 = m + (r0 + g) * S + k0 + 2 * t;
  const T* p1 = p0 + 8 * S;
  a[0] = ld32(p0);
  a[1] = ld32(p1);
  a[2] = ld32(p0 + 8);
  a[3] = ld32(p1 + 8);
}
// B (16 x 8) with B[k][n] = M[n0 + n][k0 + k] (M holds B transposed: K for
// Q.K^T, V for dO.V^T).
template <int S, typename T>
__device__ __forceinline__ void frag_bt(uint32_t* b, const T* m, int n0, int k0,
                                        int g, int t) {
  const T* p = m + (n0 + g) * S + k0 + 2 * t;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}
// B (16 x 8) with B[k][n] = M[k0 + k][n0 + n] (V for P.V, K for dS.K).
template <int S, typename T>
__device__ __forceinline__ void frag_bn(uint32_t* b, const T* m, int k0, int n0,
                                        int g, int t) {
  const T* p = m + (k0 + 2 * t) * S + n0 + g;
  b[0] = pack_raw(p[0], p[S]);
  b[1] = pack_raw(p[8 * S], p[9 * S]);
}

// Copy rows row0..row0+Rows-1 of a [n_rows, Dh] slab into a [Rows][S] shared
// tile as one cp.async batch; rows past n_rows become zeros.
template <int Dh, int Rows, int S, typename T>
__device__ __forceinline__ void stage_rows(T* sm, const T* g, int row0, int n_rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVpr = Dh / kVec;
  for (int i = threadIdx.x; i < Rows * kVpr; i += kThreads) {
    const int r = i / kVpr, c = (i - r * kVpr) * kVec;
    const bool ok = row0 + r < n_rows;
    cp_async16_zfill(sm + r * S + c, g + (size_t)(ok ? row0 + r : 0) * Dh + c, ok);
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
template <>
__device__ __forceinline__ void store2<__half>(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Is (query row, key col) attended? Top-left causal alignment.
__device__ __forceinline__ bool live(int row, int col, int tq, int tk, bool causal) {
  return row < tq && col < tk && (!causal || col <= row);
}

// ---------------------------------------------------------------- forward
template <typename T, int Dh>
struct FwdTC {
  static constexpr int BM = 64, BN = 64, S = Dh + 8;
  static size_t smem() { return (size_t)(BM + 4 * BN) * S * sizeof(T); }
};

template <typename T, int Dh>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, float* __restrict__ lse, int tq, int tk, int causal,
             float scale) {
  using Cfg = FwdTC<T, Dh>;
  constexpr int BM = Cfg::BM, BN = Cfg::BN, S = Cfg::S, ND = Dh / 8, KD = Dh / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_sh = reinterpret_cast<T*>(smem_raw);   // [BM][S]
  T* k_sh = q_sh + BM * S;                     // [2][BN][S]
  T* v_sh = k_sh + 2 * BN * S;                 // [2][BN][S]
  const int bh = blockIdx.y, q0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* qb = q + (size_t)bh * tq * Dh;
  const T* kb = k + (size_t)bh * tk * Dh;
  const T* vb = v + (size_t)bh * tk * Dh;
  int n_kt = (tk + BN - 1) / BN;
  if (causal) n_kt = min(n_kt, (q0 + BM - 1) / BN + 1);

  stage_rows<Dh, BM, S>(q_sh, qb, q0, tq);
  stage_rows<Dh, BN, S>(k_sh, kb, 0, tk);
  stage_rows<Dh, BN, S>(v_sh, vb, 0, tk);
  cp_async_commit();

  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {kMInit, kMInit}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_kt; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < n_kt) {
      stage_rows<Dh, BN, S>(k_sh + (cur ^ 1) * BN * S, kb, (kt + 1) * BN, tk);
      stage_rows<Dh, BN, S>(v_sh + (cur ^ 1) * BN * S, vb, (kt + 1) * BN, tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks = k_sh + cur * BN * S;
    const T* vs = v_sh + cur * BN * S;
    // s = q . k^T, f32
    float s[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      frag_a<S>(a, q_sh, warp * 16, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        uint32_t b[2];
        frag_bt<S>(b, ks, n * 8, kk * 16, g, t);
        Mma<T>::run(s[n], a, b);
      }
    }
    // scale, mask, online softmax
    const int k0 = kt * BN;
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const bool ok = live(row[e >> 1], col, tq, tk, causal);
        s[n][e] = ok ? s[n][e] * scale : -CUDART_INF_F;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);   // masked: exp(-inf) = 0
        l[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      acc[d][0] *= corr[0];
      acc[d][1] *= corr[0];
      acc[d][2] *= corr[1];
      acc[d][3] *= corr[1];
    }
    // acc += p . v, p rounded to the storage type
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a[4] = {Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]),
                             Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]),
                             Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        uint32_t b[2];
        frag_bn<S>(b, vs, kk * 16, d * 8, g, t);
        Mma<T>::run(acc[d], a, b);
      }
    }
    __syncthreads();   // this buffer is restaged next iteration
  }
  // normalise, cast once; lse in f32
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float ls = fmaxf(quad_sum(l[i]), 1e-20f);
    const float inv = 1.f / ls;
    if (row[i] < tq) {
      T* orow = o + ((size_t)bh * tq + row[i]) * Dh;
#pragma unroll
      for (int d = 0; d < ND; ++d)
        store2<T>(orow + d * 8 + 2 * t, acc[d][2 * i] * inv, acc[d][2 * i + 1] * inv);
      if (t == 0) lse[(size_t)bh * tq + row[i]] = m[i] + logf(ls);
    }
  }
}

// -------------------------------------------------------------- backward dQ
template <typename T, int Dh>
struct DqTC {
  static constexpr int BM = 64, BN = 64, S = Dh + 8;
  static size_t smem() { return (size_t)(2 * BM + 4 * BN) * S * sizeof(T); }
};

template <typename T, int Dh>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_tc(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int tq, int tk,
                int causal, float scale) {
  using Cfg = DqTC<T, Dh>;
  constexpr int BM = Cfg::BM, BN = Cfg::BN, S = Cfg::S, ND = Dh / 8, KD = Dh / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_sh = reinterpret_cast<T*>(smem_raw);   // [BM][S]
  T* do_sh = q_sh + BM * S;                    // [BM][S]
  T* k_sh = do_sh + BM * S;                    // [2][BN][S]
  T* v_sh = k_sh + 2 * BN * S;                 // [2][BN][S]
  const int bh = blockIdx.y, q0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const size_t qoff = (size_t)bh * tq * Dh, koff = (size_t)bh * tk * Dh;
  int n_kt = (tk + BN - 1) / BN;
  if (causal) n_kt = min(n_kt, (q0 + BM - 1) / BN + 1);

  stage_rows<Dh, BM, S>(q_sh, q + qoff, q0, tq);
  stage_rows<Dh, BM, S>(do_sh, dout + qoff, q0, tq);
  stage_rows<Dh, BN, S>(k_sh, k + koff, 0, tk);
  stage_rows<Dh, BN, S>(v_sh, v + koff, 0, tk);
  cp_async_commit();

  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = row[i] < tq;
    lse_r[i] = ok ? lse[(size_t)bh * tq + row[i]] : 0.f;
    dl_r[i] = ok ? delta[(size_t)bh * tq + row[i]] : 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < n_kt) {
      stage_rows<Dh, BN, S>(k_sh + (cur ^ 1) * BN * S, k + koff, (kt + 1) * BN, tk);
      stage_rows<Dh, BN, S>(v_sh + (cur ^ 1) * BN * S, v + koff, (kt + 1) * BN, tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks = k_sh + cur * BN * S;
    const T* vs = v_sh + cur * BN * S;
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t aq[4], ad[4];
      frag_a<S>(aq, q_sh, warp * 16, kk * 16, g, t);
      frag_a<S>(ad, do_sh, warp * 16, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        uint32_t b[2];
        frag_bt<S>(b, ks, n * 8, kk * 16, g, t);
        Mma<T>::run(s[n], aq, b);
        frag_bt<S>(b, vs, n * 8, kk * 16, g, t);
        Mma<T>::run(dp[n], ad, b);
      }
    }
    const int k0 = kt * BN;
    // ds = p * (dp - delta), p = exp(s - lse); kept in s
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const float p = live(row[e >> 1], col, tq, tk, causal)
                            ? expf(s[n][e] * scale - lse_r[e >> 1]) : 0.f;
        s[n][e] = p * (dp[n][e] - dl_r[e >> 1]);
      }
    // dq += ds . k, ds rounded to the storage type
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a[4] = {Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]),
                             Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]),
                             Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        uint32_t b[2];
        frag_bn<S>(b, ks, kk * 16, d * 8, g, t);
        Mma<T>::run(acc[d], a, b);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= tq) continue;
    T* drow = dq + ((size_t)bh * tq + row[i]) * Dh;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      store2<T>(drow + d * 8 + 2 * t, acc[d][2 * i] * scale, acc[d][2 * i + 1] * scale);
  }
}

// ----------------------------------------------------------- backward dK/dV
template <typename T, int Dh>
struct DkvTC {
  static constexpr int BM = 64, BN = 32, S = Dh + 8;
  static size_t smem() {
    return (size_t)(2 * BM + 4 * BN) * S * sizeof(T) + 4 * BN * sizeof(float);
  }
};

template <typename T, int Dh>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_tc(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                 int tq, int tk, int causal, float scale) {
  using Cfg = DkvTC<T, Dh>;
  constexpr int BM = Cfg::BM, BN = Cfg::BN, S = Cfg::S, ND = Dh / 8, KD = Dh / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_sh = reinterpret_cast<T*>(smem_raw);   // [BM][S]
  T* v_sh = k_sh + BM * S;                     // [BM][S]
  T* q_sh = v_sh + BM * S;                     // [2][BN][S]
  T* do_sh = q_sh + 2 * BN * S;                // [2][BN][S]
  float* lse_sh = reinterpret_cast<float*>(do_sh + 2 * BN * S);  // [2][BN]
  float* dl_sh = lse_sh + 2 * BN;                                  // [2][BN]
  const int bh = blockIdx.y, k0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const size_t qoff = (size_t)bh * tq * Dh, koff = (size_t)bh * tk * Dh;
  const int n_qt = (tq + BN - 1) / BN;
  const int qt0 = causal ? min(k0 / BN, n_qt) : 0;   // earlier q tiles see none of these keys

  auto stage_q = [&](int qt, int buf) {
    const int r0 = qt * BN;
    stage_rows<Dh, BN, S>(q_sh + buf * BN * S, q + qoff, r0, tq);
    stage_rows<Dh, BN, S>(do_sh + buf * BN * S, dout + qoff, r0, tq);
    if (threadIdx.x < BN) {
      const int r = r0 + threadIdx.x;
      lse_sh[buf * BN + threadIdx.x] = r < tq ? lse[(size_t)bh * tq + r] : 0.f;
      dl_sh[buf * BN + threadIdx.x] = r < tq ? delta[(size_t)bh * tq + r] : 0.f;
    }
  };
  stage_rows<Dh, BM, S>(k_sh, k + koff, k0, tk);
  stage_rows<Dh, BM, S>(v_sh, v + koff, k0, tk);
  if (qt0 < n_qt) stage_q(qt0, 0);
  cp_async_commit();

  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int cur = (qt - qt0) & 1;
    if (qt + 1 < n_qt) {
      stage_q(qt + 1, cur ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* qs = q_sh + cur * BN * S;
    const T* ds_ = do_sh + cur * BN * S;
    const float* ls = lse_sh + cur * BN;
    const float* dls = dl_sh + cur * BN;
    // s^T = k . q^T and dp^T = v . dO^T, [keys x queries]
    float st[BN / 8][4], dpt[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ak[4], av[4];
      frag_a<S>(ak, k_sh, warp * 16, kk * 16, g, t);
      frag_a<S>(av, v_sh, warp * 16, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        uint32_t b[2];
        frag_bt<S>(b, qs, n * 8, kk * 16, g, t);
        Mma<T>::run(st[n], ak, b);
        frag_bt<S>(b, ds_, n * 8, kk * 16, g, t);
        Mma<T>::run(dpt[n], av, b);
      }
    }
    const int q0 = qt * BN;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = n * 8 + 2 * t + (e & 1);
        const float p = live(q0 + cl, key[e >> 1], tq, tk, causal)
                            ? expf(st[n][e] * scale - ls[cl]) : 0.f;
        st[n][e] = p;                            // p^T
        dpt[n][e] = p * (dpt[n][e] - dls[cl]);   // ds^T
      }
    // dv += p^T . dO and dk += ds^T . q, operands rounded to the storage type
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t ap[4] = {Mma<T>::pack(st[2 * kk][0], st[2 * kk][1]),
                              Mma<T>::pack(st[2 * kk][2], st[2 * kk][3]),
                              Mma<T>::pack(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                              Mma<T>::pack(st[2 * kk + 1][2], st[2 * kk + 1][3])};
      const uint32_t as[4] = {Mma<T>::pack(dpt[2 * kk][0], dpt[2 * kk][1]),
                              Mma<T>::pack(dpt[2 * kk][2], dpt[2 * kk][3]),
                              Mma<T>::pack(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                              Mma<T>::pack(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        uint32_t b[2];
        frag_bn<S>(b, ds_, kk * 16, d * 8, g, t);
        Mma<T>::run(dva[d], ap, b);
        frag_bn<S>(b, qs, kk * 16, d * 8, g, t);
        Mma<T>::run(dka[d], as, b);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= tk) continue;
    T* krow = dk + koff + (size_t)key[i] * Dh;
    T* vrow = dv + koff + (size_t)key[i] * Dh;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      store2<T>(krow + d * 8 + 2 * t, dka[d][2 * i] * scale, dka[d][2 * i + 1] * scale);
      store2<T>(vrow + d * 8 + 2 * t, dva[d][2 * i], dva[d][2 * i + 1]);
    }
  }
}

// ------------------------------------------------------------ f32, CUDA cores
// 32 rows per block, 4 threads per row (each owning HD = Dh/4 columns), the
// other operand walked in tiles of 32 rows staged in shared memory.
template <int Dh>
struct F32 {
  static constexpr int BM = 32, BN = 32, SPL = 4, HD = Dh / 4, S = Dh + 4;
};

__device__ __forceinline__ float split_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// rows row0.. of a [n_rows, Dh] f32 slab into a [Rows][S] tile (zeros past
// n_rows), plain 16-byte loads
template <int Dh, int Rows, int S>
__device__ __forceinline__ void load_rows_f32(float* sm, const float* g, int row0,
                                              int n_rows) {
  constexpr int kVpr = Dh / 4;
  for (int i = threadIdx.x; i < Rows * kVpr; i += kThreads) {
    const int r = i / kVpr, c = (i - r * kVpr) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows) x = *reinterpret_cast<const float4*>(g + (size_t)(row0 + r) * Dh + c);
    *reinterpret_cast<float4*>(sm + r * S + c) = x;
  }
}

template <int Dh>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
              int tq, int tk, int causal, float scale) {
  using C = F32<Dh>;
  constexpr int BN = C::BN, HD = C::HD, S = C::S;
  __shared__ __align__(16) float k_sh[BN * S];
  __shared__ __align__(16) float v_sh[BN * S];
  __shared__ float sc[BN * C::BM];      // this tile's scores, [key][row]
  const int bh = blockIdx.y, r = threadIdx.x / C::SPL, c0 = (threadIdx.x % C::SPL) * HD;
  const int row = blockIdx.x * C::BM + r;
  const float* kb = k + (size_t)bh * tk * Dh;
  const float* vb = v + (size_t)bh * tk * Dh;
  float qr[HD], acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = row < tq ? q[((size_t)bh * tq + row) * Dh + c0 + d] : 0.f;
    acc[d] = 0.f;
  }
  int n_kt = (tk + BN - 1) / BN;
  if (causal) n_kt = min(n_kt, (blockIdx.x * C::BM + C::BM - 1) / BN + 1);
  float m = kMInit, l = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_rows_f32<Dh, BN, S>(k_sh, kb, kt * BN, tk);
    load_rows_f32<Dh, BN, S>(v_sh, vb, kt * BN, tk);
    __syncthreads();
    float mx = -CUDART_INF_F;
    for (int j = 0; j < BN; ++j) {
      float part = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) part = fmaf(qr[d], k_sh[j * S + c0 + d], part);
      part = split_sum(part);
      const float s = live(row, kt * BN + j, tq, tk, causal) ? part * scale : -CUDART_INF_F;
      sc[j * C::BM + r] = s;   // a row's 4 threads write the same value
      mx = fmaxf(mx, s);
    }
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    m = m_new;
    l *= corr;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= corr;
    for (int j = 0; j < BN; ++j) {
      const float p = expf(sc[j * C::BM + r] - m);
      l += p;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = fmaf(p, v_sh[j * S + c0 + d], acc[d]);
    }
  }
  if (row < tq) {
    const float ls = fmaxf(l, 1e-20f);
    float* orow = o + ((size_t)bh * tq + row) * Dh + c0;
#pragma unroll
    for (int d = 0; d < HD; ++d) orow[d] = acc[d] / ls;
    if (c0 == 0) lse[(size_t)bh * tq + row] = m + logf(ls);
  }
}

template <int Dh>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq, int tq, int tk, int causal, float scale) {
  using C = F32<Dh>;
  constexpr int BN = C::BN, HD = C::HD, S = C::S;
  __shared__ __align__(16) float k_sh[BN * S];
  __shared__ __align__(16) float v_sh[BN * S];
  const int bh = blockIdx.y, r = threadIdx.x / C::SPL, c0 = (threadIdx.x % C::SPL) * HD;
  const int row = blockIdx.x * C::BM + r;
  const bool ok_row = row < tq;
  const size_t ro = ((size_t)bh * tq + (ok_row ? row : 0)) * Dh + c0;
  const float* kb = k + (size_t)bh * tk * Dh;
  const float* vb = v + (size_t)bh * tk * Dh;
  float qr[HD], dor[HD], acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = ok_row ? q[ro + d] : 0.f;
    dor[d] = ok_row ? dout[ro + d] : 0.f;
    acc[d] = 0.f;
  }
  const float lr = ok_row ? lse[(size_t)bh * tq + row] : 0.f;
  const float dl = ok_row ? delta[(size_t)bh * tq + row] : 0.f;
  int n_kt = (tk + BN - 1) / BN;
  if (causal) n_kt = min(n_kt, (blockIdx.x * C::BM + C::BM - 1) / BN + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_rows_f32<Dh, BN, S>(k_sh, kb, kt * BN, tk);
    load_rows_f32<Dh, BN, S>(v_sh, vb, kt * BN, tk);
    __syncthreads();
    for (int j = 0; j < BN; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        s = fmaf(qr[d], k_sh[j * S + c0 + d], s);
        dp = fmaf(dor[d], v_sh[j * S + c0 + d], dp);
      }
      s = split_sum(s);
      dp = split_sum(dp);
      const float p = live(row, kt * BN + j, tq, tk, causal) ? expf(s * scale - lr) : 0.f;
      const float ds = p * (dp - dl);
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = fmaf(ds, k_sh[j * S + c0 + d], acc[d]);
    }
  }
  if (ok_row) {
#pragma unroll
    for (int d = 0; d < HD; ++d) dq[ro + d] = acc[d] * scale;
  }
}

template <int Dh>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dk, float* __restrict__ dv, int tq, int tk,
                  int causal, float scale) {
  using C = F32<Dh>;
  constexpr int BN = C::BN, HD = C::HD, S = C::S;
  __shared__ __align__(16) float q_sh[BN * S];
  __shared__ __align__(16) float do_sh[BN * S];
  __shared__ float lse_sh[BN], dl_sh[BN];
  const int bh = blockIdx.y, r = threadIdx.x / C::SPL, c0 = (threadIdx.x % C::SPL) * HD;
  const int k0 = blockIdx.x * C::BM, key = k0 + r;
  const bool ok_key = key < tk;
  const size_t ko = ((size_t)bh * tk + (ok_key ? key : 0)) * Dh + c0;
  const float* qb = q + (size_t)bh * tq * Dh;
  const float* db = dout + (size_t)bh * tq * Dh;
  float kr[HD], vr[HD], dka[HD], dva[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    kr[d] = ok_key ? k[ko + d] : 0.f;
    vr[d] = ok_key ? v[ko + d] : 0.f;
    dka[d] = dva[d] = 0.f;
  }
  const int n_qt = (tq + BN - 1) / BN;
  const int qt0 = causal ? min(k0 / BN, n_qt) : 0;
  for (int qt = qt0; qt < n_qt; ++qt) {
    __syncthreads();
    load_rows_f32<Dh, BN, S>(q_sh, qb, qt * BN, tq);
    load_rows_f32<Dh, BN, S>(do_sh, db, qt * BN, tq);
    if (threadIdx.x < BN) {
      const int rq = qt * BN + threadIdx.x;
      lse_sh[threadIdx.x] = rq < tq ? lse[(size_t)bh * tq + rq] : 0.f;
      dl_sh[threadIdx.x] = rq < tq ? delta[(size_t)bh * tq + rq] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < BN; ++i) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        s = fmaf(kr[d], q_sh[i * S + c0 + d], s);
        dp = fmaf(vr[d], do_sh[i * S + c0 + d], dp);
      }
      s = split_sum(s);
      dp = split_sum(dp);
      const float p = live(qt * BN + i, key, tq, tk, causal) ? expf(s * scale - lse_sh[i]) : 0.f;
      const float ds = p * (dp - dl_sh[i]);
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        dva[d] = fmaf(p, do_sh[i * S + c0 + d], dva[d]);
        dka[d] = fmaf(ds, q_sh[i * S + c0 + d], dka[d]);
      }
    }
  }
  if (ok_key) {
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      dk[ko + d] = dka[d] * scale;
      dv[ko + d] = dva[d];
    }
  }
}

// ------------------------------------------------------------------ launch
// Raise a kernel's dynamic shared-memory cap once; ``allowed`` is that
// kernel's own counter (never set inside a graph capture: the first call of
// each kernel is a plain launch).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t& allowed) {
  if (bytes > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    allowed = bytes;
  }
  return cudaSuccess;
}

struct Args {
  const void *q, *k, *v, *dout;
  void *o, *dq, *dk, *dv;
  float *lse;
  const float *lse_in, *delta;
  int bh, tq, tk, causal;
  float scale;
  cudaStream_t st;
};

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int Dh>
cudaError_t launch_tc(Which which, const Args& a) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  cudaError_t err;
  if (which == kFwd) {
    using Cfg = FwdTC<T, Dh>;
    auto kern = flash_fwd_tc<T, Dh>;
    static size_t allowed = 48 * 1024;
    if ((err = allow_smem(kern, Cfg::smem(), allowed)) != cudaSuccess) return err;
    dim3 grid((a.tq + Cfg::BM - 1) / Cfg::BM, a.bh);
    kern<<<grid, kThreads, Cfg::smem(), a.st>>>(q, k, v, static_cast<T*>(a.o), a.lse,
                                                a.tq, a.tk, a.causal, a.scale);
  } else if (which == kDq) {
    using Cfg = DqTC<T, Dh>;
    auto kern = flash_bwd_dq_tc<T, Dh>;
    static size_t allowed = 48 * 1024;
    if ((err = allow_smem(kern, Cfg::smem(), allowed)) != cudaSuccess) return err;
    dim3 grid((a.tq + Cfg::BM - 1) / Cfg::BM, a.bh);
    kern<<<grid, kThreads, Cfg::smem(), a.st>>>(
        q, k, v, static_cast<const T*>(a.dout), a.lse_in, a.delta,
        static_cast<T*>(a.dq), a.tq, a.tk, a.causal, a.scale);
  } else {
    using Cfg = DkvTC<T, Dh>;
    auto kern = flash_bwd_dkv_tc<T, Dh>;
    static size_t allowed = 48 * 1024;
    if ((err = allow_smem(kern, Cfg::smem(), allowed)) != cudaSuccess) return err;
    dim3 grid((a.tk + Cfg::BM - 1) / Cfg::BM, a.bh);
    kern<<<grid, kThreads, Cfg::smem(), a.st>>>(
        q, k, v, static_cast<const T*>(a.dout), a.lse_in, a.delta,
        static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.tq, a.tk, a.causal, a.scale);
  }
  return cudaGetLastError();
}

template <int Dh>
cudaError_t launch_f32(Which which, const Args& a) {
  using C = F32<Dh>;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  if (which == kFwd) {
    dim3 grid((a.tq + C::BM - 1) / C::BM, a.bh);
    flash_fwd_f32<Dh><<<grid, kThreads, 0, a.st>>>(q, k, v, static_cast<float*>(a.o),
                                                   a.lse, a.tq, a.tk, a.causal, a.scale);
  } else if (which == kDq) {
    dim3 grid((a.tq + C::BM - 1) / C::BM, a.bh);
    flash_bwd_dq_f32<Dh><<<grid, kThreads, 0, a.st>>>(
        q, k, v, dout, a.lse_in, a.delta, static_cast<float*>(a.dq), a.tq, a.tk,
        a.causal, a.scale);
  } else {
    dim3 grid((a.tk + C::BM - 1) / C::BM, a.bh);
    flash_bwd_dkv_f32<Dh><<<grid, kThreads, 0, a.st>>>(
        q, k, v, dout, a.lse_in, a.delta, static_cast<float*>(a.dk),
        static_cast<float*>(a.dv), a.tq, a.tk, a.causal, a.scale);
  }
  return cudaGetLastError();
}

cudaError_t dispatch(Which which, int dh, int dtype, const Args& a) {
  if (a.bh <= 0 || a.bh > 65535 || a.tq <= 0 || a.tk <= 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      if (dh == 64) return launch_f32<64>(which, a);
      if (dh == 128) return launch_f32<128>(which, a);
      break;
    case kF16:
      if (dh == 64) return launch_tc<__half, 64>(which, a);
      if (dh == 128) return launch_tc<__half, 128>(which, a);
      break;
    case kBF16:
      if (dh == 64) return launch_tc<__nv_bfloat16, 64>(which, a);
      if (dh == 128) return launch_tc<__nv_bfloat16, 128>(which, a);
      break;
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q [BH, Tq, Dh]; k, v [BH, Tk, Dh]; o [BH, Tq, Dh]; lse f32 [BH, Tq].
extern "C" int dst_flash_fwd(const void* q, const void* k, const void* v, void* o,
                             void* lse, int bh, int tq, int tk, int dh, int causal,
                             float scale, int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.lse = static_cast<float*>(lse);
  a.bh = bh; a.tq = tq; a.tk = tk; a.causal = causal; a.scale = scale;
  a.st = static_cast<cudaStream_t>(stream);
  return dispatch(kFwd, dh, dtype, a);
}

// + dout [BH, Tq, Dh]; lse, delta f32 [BH, Tq] (global rows); dq [BH, Tq, Dh].
extern "C" int dst_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta,
                                void* dq, int bh, int tq, int tk, int dh, int causal,
                                float scale, int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.dq = dq;
  a.lse_in = static_cast<const float*>(lse); a.delta = static_cast<const float*>(delta);
  a.bh = bh; a.tq = tq; a.tk = tk; a.causal = causal; a.scale = scale;
  a.st = static_cast<cudaStream_t>(stream);
  return dispatch(kDq, dh, dtype, a);
}

// dk, dv [BH, Tk, Dh].
extern "C" int dst_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dk, void* dv, int bh, int tq, int tk, int dh,
                                 int causal, float scale, int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.dk = dk; a.dv = dv;
  a.lse_in = static_cast<const float*>(lse); a.delta = static_cast<const float*>(delta);
  a.bh = bh; a.tq = tq; a.tk = tk; a.causal = causal; a.scale = scale;
  a.st = static_cast<cudaStream_t>(stream);
  return dispatch(kDkv, dh, dtype, a);
}

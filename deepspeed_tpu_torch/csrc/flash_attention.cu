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
// tensor cores with f32 accumulation and keeps every score, probability and
// dS tile in registers.
//
// Design:
//  * Forward (kernel D, flash_fwd_wgmma): Hopper's own route to the tensor
//    cores, wgmma fed by TMA: a producer warp streams K/V tiles into a
//    ring of mbarrier-guarded stages while a consumer warpgroup computes;
//    see the note above the kernel.
//  * Backward (kernels E and F): mma.sync m16n8k16 with one block of 4 warps
//    per 64-row tile, each warp owning 16 rows. The walk over the other
//    operand's tiles is a loop inside the block (the TPU grid's sequential
//    dimension), with the next tile copied into shared memory with cp.async
//    while this one is computed.
//  * Causal masking is top-left aligned (query row i sees key columns
//    <= i, the reference's _causal_mask): whole tiles past the diagonal are
//    skipped, the diagonal tile is masked element by element. Rows past T
//    (the ragged tail tile) load as zeros and are masked to p = 0, so no
//    garbage reaches a product; they are never written.
//  * Rounding points of the reference: products take storage-dtype operands
//    and accumulate in f32; p (forward, dQ and dK/dV) and dS are rounded to
//    the storage dtype as the A operand of the second-stage products (P.V,
//    dS.K, P^T.dO, dS^T.Q). The score tile's C fragment is re-read as that A
//    fragment in registers (the m16n8k16 C and A layouts line up, and so do
//    wgmma's accumulator and register-A layouts).
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

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace dst;

constexpr int kThreads = 128;       // 4 warps
constexpr float kMInit = -1e30f;    // the reference's _NEG_INF, the initial m
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// 2^x on the special-function unit (flushes denormal results to 0: p below
// 2^-126 of the row's max adds nothing at f32)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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
// Kernel D on Hopper: one block per (bh, 64-row Q tile) of one consumer
// warpgroup (warps 0-3, 16 rows each) and one producer warp (warp 4).
//  * The producer's lane 0 loads the Q tile once, then the walk's K and V
//    tiles by TMA into two rings of mbarrier-guarded stages: a stage's
//    `full` barrier completes on its bytes, its `empty` barrier on the 128
//    consumer threads' release. K and V have rings of their own because a K
//    tile is done with as soon as its scores are in, a V tile only after
//    P.V: K's stages turn over early, and the loads run further ahead.
//  * S = Q K^T is wgmma m64n64k16 from shared memory (both K-major, 128-byte
//    swizzle); P stays in registers: the f32 accumulator of S is rounded to
//    T and becomes the A operand of O += P V (wgmma from registers, V
//    MN-major through the transpose mode).
//  * Each tile's softmax overlaps the previous tile's P.V: S(kt+1) and
//    P(kt).V(kt) are issued back to back, the softmax of S(kt+1) runs on
//    the CUDA cores while P.V finishes on the tensor cores.
//  * Softmax in the log2 domain: ex2 with log2(e) folded into the scale,
//    the running max starting at -1e30; element masks only on the tile that
//    crosses the diagonal and the ragged tail; tiles past the diagonal are
//    never loaded.
//  * Causal tiles run longest first: grid (tile, bh) with the last Q tile
//    at blockIdx.x = 0, so each bh's tiles start longest first and the
//    blocks of one bh run together, sharing its K/V in the L2.
//  * What sets its time at Dh 64 is the softmax on the CUDA cores, not the
//    products: with the products left out the kernel takes as long. So the
//    softmax is kept to one FFMA, one ex2, one max and one add a score.
//    ptxas serialises the products (warning C7514/C7515) when a branch sits
//    between a product's issue and its wait; hence the peeled last tile.
template <typename T, int Dh>
struct FwdH {
  static constexpr int BM = 64, BN = 64, kPanels = Dh / 64;
  // stages of the K and V rings (Dh 64: 72 KB a block, three blocks an SM;
  // Dh 128: 96 KB, two)
  static constexpr int kKStages = Dh == 64 ? 4 : 3, kVStages = Dh == 64 ? 4 : 2;
  static constexpr int kThreadsH = 160;  // 4 consumer warps + 1 producer warp
  static constexpr uint32_t kQBytes = BM * Dh * sizeof(T);
  static constexpr uint32_t kTileBytes = BN * Dh * sizeof(T);  // K or V
  static constexpr size_t kBarOff =
      kQBytes + (size_t)(kKStages + kVStages) * kTileBytes;
  static size_t smem() { return 1024 + kBarOff + 8 * (1 + 2 * (kKStages + kVStages)); }
};

template <typename T, int Dh, bool kNeg>
__global__ void __launch_bounds__(160, 2)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, T* __restrict__ o,
                float* __restrict__ lse, int tq, int tk, int causal, float scale_log2) {
  using namespace dst::hopper;
  using C = FwdH<T, Dh>;
  constexpr int BM = C::BM, BN = C::BN, SK = C::kKStages, SV = C::kVStages, NP = C::kPanels;
  constexpr int PANEL_Q = BM * 64, PANEL_KV = BN * 64;  // elements of one 64-column panel
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  T* q_sh = reinterpret_cast<T*>(base);                 // [NP][BM][64]
  T* k_sh = reinterpret_cast<T*>(base + C::kQBytes);    // [SK][NP][BN][64]
  T* v_sh = k_sh + SK * NP * PANEL_KV;                  // [SV][NP][BN][64]
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(base + C::kBarOff);
  uint64_t* k_full = q_bar + 1;
  uint64_t* k_empty = k_full + SK;
  uint64_t* v_full = k_empty + SK;
  uint64_t* v_empty = v_full + SV;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // longest tiles first
  int n_kt = (tk + BN - 1) / BN;
  if (causal) n_kt = min(n_kt, (q0 + BM - 1) / BN + 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < SK; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&k_empty[s], 128);
    }
    for (int s = 0; s < SV; ++s) {
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {  // ------------------------------------------ producer
    if (lane == 0) {
      mbar_expect_tx(q_bar, C::kQBytes);
      for (int p = 0; p < NP; ++p) tma_load_3d(q_sh + p * PANEL_Q, &qmap, q_bar, p * 64, q0, bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int sk = kt % SK, sv = kt % SV;
        if (kt >= SK) mbar_wait(&k_empty[sk], ((kt / SK) - 1) & 1);
        mbar_expect_tx(&k_full[sk], C::kTileBytes);
        for (int p = 0; p < NP; ++p)
          tma_load_3d(k_sh + (sk * NP + p) * PANEL_KV, &kmap, &k_full[sk], p * 64, kt * BN, bh);
        if (kt >= SV) mbar_wait(&v_empty[sv], ((kt / SV) - 1) & 1);
        mbar_expect_tx(&v_full[sv], C::kTileBytes);
        for (int p = 0; p < NP; ++p)
          tma_load_3d(v_sh + (sv * NP + p) * PANEL_KV, &vmap, &v_full[sv], p * 64, kt * BN, bh);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int g = lane >> 2, t = lane & 3;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float acc[Dh / 2];
#pragma unroll
  for (int i = 0; i < Dh / 2; ++i) acc[i] = 0.f;
  float m[2] = {kMInit, kMInit}, l[2] = {0.f, 0.f};
  mbar_wait(q_bar, 0);

  // S(kt) = Q K(kt)^T into sc, issued and committed (asynchronous)
  float sc[BN / 2];
  auto issue_s = [&](int kt) {
    const int s = kt % SK;
    mbar_wait(&k_full[s], (kt / SK) & 1);
    const T* ks = k_sh + s * NP * PANEL_KV;
#pragma unroll
    for (int kk = 0; kk < Dh / 16; ++kk) {
      const int p = kk / 4, c = (kk % 4) * 16;
      Wgmma<T>::ss_n64(sc, sw128_desc(q_sh + p * PANEL_Q + c, 16, 1024),
                       sw128_desc(ks + p * PANEL_KV + c, 16, 1024), kk > 0);
    }
    wg_commit();
  };
  // online softmax of tile kt in place (sc -> p), in the log2 domain:
  // p = 2^(s * scale_log2 - m) as one FFMA and one ex2, the tile's max
  // taken on the raw scores (scaling is monotone: kNeg flips it for a
  // negative scale). Element masks only in the copy for the tile that
  // crosses the diagonal or the ragged tail.
  float corr[2];
  auto softmax_body = [&](int kt, auto masked) {
    constexpr bool kMask = decltype(masked)::value;
    const float lo = kNeg ? CUDART_INF_F : -CUDART_INF_F;  // a masked raw score
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e];
        if constexpr (kMask) {
          const int col = kt * BN + 8 * j + 2 * t + (e & 1);
          if (col >= tk || (causal && col > row[e >> 1])) x = lo;
          sc[4 * j + e] = x;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], kNeg ? -x : x);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]) * (kNeg ? -scale_log2 : scale_log2));
      corr[i] = fast_exp2(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(fmaf(sc[4 * j + e], scale_log2, -m[e >> 1]));  // masked: 0
        sc[4 * j + e] = p;
        l[e >> 1] += p;
      }
  };
  auto softmax = [&](int kt) {
    const int k0 = kt * BN;
    if ((causal && k0 + BN - 1 > q0) || k0 + BN > tk)
      softmax_body(kt, std::true_type{});
    else
      softmax_body(kt, std::false_type{});
  };


  // p rounded to the storage type as the A operand of P.V, and the running
  // output rescaled to the tile's max
  uint32_t pa[BN / 16][4];
  auto to_operand = [&]() {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      pa[kk][0] = Mma<T>::pack(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = Mma<T>::pack(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = Mma<T>::pack(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = Mma<T>::pack(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
#pragma unroll
    for (int j = 0; j < Dh / 8; ++j) {
      acc[4 * j + 0] *= corr[0];
      acc[4 * j + 1] *= corr[0];
      acc[4 * j + 2] *= corr[1];
      acc[4 * j + 3] *= corr[1];
    }
  };
  // O += P(kt) V(kt), issued and committed
  auto issue_pv = [&](int kt) {
    mbar_wait(&v_full[kt % SV], (kt / SV) & 1);
    const T* vs = v_sh + (kt % SV) * NP * PANEL_KV;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t dv = sw128_desc(vs + kk * 16 * 64, PANEL_KV * (int)sizeof(T), 1024);
      if constexpr (Dh == 64)
        Wgmma<T>::rs_n64_mn(acc, pa[kk], dv);
      else
        Wgmma<T>::rs_n128_mn(acc, pa[kk], dv);
    }
    wg_commit();
  };

  // The walk overlaps each tile's softmax with the previous tile's P.V on
  // the tensor cores: S(kt+1) and P(kt).V(kt) are issued back to back, the
  // softmax of S(kt+1) runs while P.V finishes. The body has no branch
  // between a product's issue and its wait (the last tile is peeled), so
  // the compiler keeps the products asynchronous.
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
  fence_regs<BN / 2>(sc);
  wg_fence();
  issue_s(0);
  wg_wait<0>();
  fence_regs<BN / 2>(sc);
  mbar_arrive(&k_empty[0]);
  softmax(0);
  for (int kt = 0; kt + 1 < n_kt; ++kt) {
    to_operand();
    fence_regs<BN / 2>(sc);
    fence_regs<Dh / 2>(acc);
    wg_fence();
    issue_s(kt + 1);
    issue_pv(kt);
    wg_wait<1>();  // S(kt+1) is in; P.V(kt) may still run
    fence_regs<BN / 2>(sc);
    mbar_arrive(&k_empty[(kt + 1) % SK]);  // K(kt+1) is done with
    softmax(kt + 1);
    wg_wait<0>();
    fence_regs<Dh / 2>(acc);
    mbar_arrive(&v_empty[kt % SV]);  // V(kt) is done with
  }
  to_operand();
  fence_regs<Dh / 2>(acc);
  wg_fence();
  issue_pv(n_kt - 1);
  wg_wait<0>();
  fence_regs<Dh / 2>(acc);
  mbar_arrive(&v_empty[(n_kt - 1) % SV]);
  // normalise, cast once; lse in f32 (natural log)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float ls = fmaxf(quad_sum(l[i]), 1e-20f);
    if (row[i] < tq) {
      T* orow = o + ((size_t)bh * tq + row[i]) * Dh;
#pragma unroll
      for (int j = 0; j < Dh / 8; ++j)
        store2<T>(orow + 8 * j + 2 * t, acc[4 * j + 2 * i] / ls, acc[4 * j + 2 * i + 1] / ls);
      if (t == 0) lse[(size_t)bh * tq + row[i]] = m[i] * kLn2 + logf(ls);
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

// cuTensorMapEncodeTiled from the driver, found at run time (the library
// links no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [bh, rows, Dh] 16-bit operand as a 3-d tensor map of 64-column x
// box_rows boxes, 128-byte swizzled, zero-filled past each bh's last row.
template <typename T, int Dh>
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int bh, int rows, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)Dh, (cuuint64_t)rows, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)Dh * sizeof(T), (cuuint64_t)rows * Dh * sizeof(T)};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, sizeof(T) == 2 && std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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

template <typename T, int Dh, bool kNeg>
cudaError_t launch_fwd(const Args& a) {
  using Cfg = FwdH<T, Dh>;
  CUtensorMap qm, km, vm;
  cudaError_t err;
  if ((err = tensor_map<T, Dh>(&qm, a.q, a.bh, a.tq, Cfg::BM)) != cudaSuccess ||
      (err = tensor_map<T, Dh>(&km, a.k, a.bh, a.tk, Cfg::BN)) != cudaSuccess ||
      (err = tensor_map<T, Dh>(&vm, a.v, a.bh, a.tk, Cfg::BN)) != cudaSuccess)
    return err;
  auto kern = flash_fwd_wgmma<T, Dh, kNeg>;
  static size_t allowed = 48 * 1024;
  if ((err = allow_smem(kern, Cfg::smem(), allowed)) != cudaSuccess) return err;
  dim3 grid((a.tq + Cfg::BM - 1) / Cfg::BM, a.bh);
  kern<<<grid, Cfg::kThreadsH, Cfg::smem(), a.st>>>(qm, km, vm, static_cast<T*>(a.o), a.lse,
                                                    a.tq, a.tk, a.causal, a.scale * kLog2e);
  return cudaGetLastError();
}

template <typename T, int Dh>
cudaError_t launch_tc(Which which, const Args& a) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  cudaError_t err;
  if (which == kFwd) {
    return a.scale < 0 ? launch_fwd<T, Dh, true>(a) : launch_fwd<T, Dh, false>(a);
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

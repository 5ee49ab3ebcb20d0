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
//  * The three 16-bit kernels (D forward, E dQ, F dK/dV) take Hopper's own
//    route to the tensor cores, wgmma fed by TMA (csrc/hopper.cuh): one
//    block per 64-row tile of the operand it owns (Q for D and E, K and V
//    for F), loaded once; a producer warp streams the other operand's
//    64-row tiles into a ring of mbarrier-guarded stages; one consumer
//    warpgroup issues the products and keeps their accumulators in
//    registers. The walk over the streamed tiles is a loop inside the block
//    (the TPU grid's sequential dimension). See the notes above each kernel.
//  * Score products (S = Q K^T, dP = dO V^T, and F's S^T = K Q^T, dP^T =
//    V dO^T) read both operands K-major from shared memory. Second-stage
//    products (P V, dS K, P^T dO, dS^T Q) take the score tile, rounded to
//    the storage dtype, as the register A operand (wgmma's accumulator and
//    register-A layouts line up) and read B MN-major through the transpose
//    mode.
//  * Causal masking is top-left aligned (query row i sees key columns
//    <= i, the reference's _causal_mask): whole tiles past the diagonal are
//    never loaded; element masks run only on the tile that crosses the
//    diagonal and on the ragged tail tile. Rows past T load as zeros (the
//    tensor maps' fill) and are never written; masked scores give p = 0.
//  * Rounding points of the reference: products take storage-dtype operands
//    and accumulate in f32; p (forward, dQ and dK/dV) and dS are rounded to
//    the storage dtype as the A operand of the second-stage products.
//  * Forward: online softmax with running max m (init -1e30) and sum l in
//    f32, per-thread partial l reduced once at the end; O = acc /
//    max(l, 1e-20) in the storage dtype, lse = m + log(max(l, 1e-20)) in f32.
//  * Backward: p = exp(s - lse), ds = p * (dp - delta) from the caller's
//    global lse and delta = rowsum(dO * O), in the log2 domain (one FFMA and
//    one ex2 a score); dQ and dK are scaled once at the end (s was computed
//    from unscaled q). Two kernels and no atomics: every output element is
//    summed by one thread in a fixed order, so dQ, dK and dV are
//    bit-identical run to run and under CUDA-graph replay.
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
// Two f32 values rounded to one packed pair of T (lo in the low half).
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 64-column f32 accumulator tile (wgmma's layout) rounded to T as the
// register A operands of four k-steps of 16 (the m16n8k16 A layout).
template <typename T>
__device__ __forceinline__ void to_a_operand(uint32_t (*a)[4], const float* x) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack2<T>(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = pack2<T>(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack2<T>(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack2<T>(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// The register A operand of k-step kk (16 columns) for warp w's rows
// 16w..16w+15 of a 64-row tile kept as 128-byte-swizzled 64-column panels
// (16-byte chunk j of row r stored at chunk j ^ (r % 8)).
template <typename T>
__device__ __forceinline__ void a_from_sw128(uint32_t* a, const T* tile, int kk, int w, int g,
                                             int t) {
  const unsigned char* p = reinterpret_cast<const unsigned char*>(tile + (kk / 4) * 64 * 64);
  const int r0 = w * 16 + g, r1 = r0 + 8, ch = (kk % 4) * 2, sw = r0 & 7;
  a[0] = *reinterpret_cast<const uint32_t*>(p + r0 * 128 + ((ch ^ sw) << 4) + 4 * t);
  a[1] = *reinterpret_cast<const uint32_t*>(p + r1 * 128 + ((ch ^ sw) << 4) + 4 * t);
  a[2] = *reinterpret_cast<const uint32_t*>(p + r0 * 128 + (((ch + 1) ^ sw) << 4) + 4 * t);
  a[3] = *reinterpret_cast<const uint32_t*>(p + r1 * 128 + (((ch + 1) ^ sw) << 4) + 4 * t);
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
    to_a_operand<T>(pa, sc);
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
        Wgmma<T>::template rs_n64<1>(acc, pa[kk], dv);
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

// --------------------------------------------------------------- backward
// Kernels E (dQ) and F (dK/dV) on Hopper, on kernel D's skeleton: the rows
// a block owns are loaded once by TMA; the other operand's 64-row tiles
// stream through a ring of stages whose `full` barrier completes on the
// bytes and whose `empty` barrier on the 128 consumer threads' release.
//  * Per score: p = 2^(s * scale_log2 - lse * log2 e) as one FFMA and one
//    ex2 (lse * log2 e folded once per row; the caller's lse needs no max,
//    so a negative scale needs no care), then ds = p * (dp - delta).
//  * The elementwise step of one tile overlaps the previous tile's
//    gradient products on the tensor cores (E; F at Dh 64): the next
//    tile's two score products and this tile's gradient products are
//    issued back to back, and only the score products are waited for. The
//    body has no branch between a product's issue and its wait (the last
//    tile is peeled), so ptxas keeps the products asynchronous
//    (C7514/C7515 otherwise).
//  * Both run 256 threads: a consumer warpgroup and a producer warpgroup
//    of which one warp works. ptxas caps __launch_bounds__(160, 2) at 168
//    registers, where E at Dh 128 and F at Dh 64 spilled and had their
//    products serialised (C7512); with 256 threads the producer warpgroup
//    can give its registers to the consumers (setmaxnreg).
template <typename T, int Dh>
struct BwdTile {
  static constexpr int BM = 64, BN = 64, kPanels = Dh / 64;
  static constexpr int kPanel = 64 * 64;  // elements of one 64-row, 64-column panel
  static constexpr uint32_t kTileBytes = 64 * Dh * sizeof(T);
};

// Kernel E: one block per (bh, 64-row Q tile) of one consumer warpgroup
// (warps 0-3, 16 rows each) and a producer warpgroup whose warp 4 works.
// The producer loads the Q and dO tiles once, then the walk's (K, V) tile
// pairs, one pair a stage, released once dQ += dS K has read K. S = Q K^T
// and dP = dO V^T are wgmma with K and V K-major in shared memory; dS stays
// in registers and, rounded to T, is the A operand of dQ += dS K (K read
// MN-major). The causal walk stops at the diagonal tile; tiles run longest
// first (the last Q tile at blockIdx.x = 0), so the blocks of one bh run
// together, sharing its K/V in the L2.
//  * Dh 64: Q and dO are the register A operands of the score products,
//    loaded once from their swizzled tiles (shared-memory reads per tile
//    fall from 56 to 40 KB; 0.079 against 0.083 ms at GPT-2 774M's causal
//    shape on an H100). Two blocks an SM: the producer warpgroup gives its
//    registers to the consumers (setmaxnreg 24/232).
//  * Dh 128: both from shared memory (the registers would not fit), and a
//    3-stage ring at one block an SM (no setmaxnreg: the block has the
//    SM's registers): the walk holds two stages at once (K(kt) for dQ,
//    K(kt+1) for S), so two stages left no load in flight (0.38 against
//    0.24 ms at B 4, H 16, T 2048, causal).
template <typename T, int Dh>
struct DqH : BwdTile<T, Dh> {
  static constexpr bool kRS = Dh == 64;  // Q, dO as register A operands
  // stages of the (K, V) ring: Dh 64, 80 KB a block; Dh 128, 128 KB
  static constexpr int kStages = Dh == 64 ? 4 : 3;
  static constexpr int kMinBlocks = Dh == 64 ? 2 : 1;
  static constexpr size_t kBarOff = (size_t)(2 + 2 * kStages) * BwdTile<T, Dh>::kTileBytes;
  static size_t smem() { return 1024 + kBarOff + 8 * (1 + 2 * kStages); }
};

template <typename T, int Dh>
__global__ void __launch_bounds__(256, DqH<T, Dh>::kMinBlocks)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap domap,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   T* __restrict__ dq, int tq, int tk, int causal, float scale) {
  using namespace dst::hopper;
  using C = DqH<T, Dh>;
  constexpr int BM = C::BM, BN = C::BN, S = C::kStages, NP = C::kPanels, PANEL = C::kPanel;
  constexpr uint32_t kTile = C::kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  T* q_sh = reinterpret_cast<T*>(base);  // [NP][BM][64]
  T* do_sh = q_sh + NP * PANEL;           // [NP][BM][64]
  T* k_sh = do_sh + NP * PANEL;           // [S][NP][BN][64]
  T* v_sh = k_sh + S * NP * PANEL;        // [S][NP][BN][64]
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(base + C::kBarOff);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + S;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // longest tiles first
  int n_kt = (tk + BN - 1) / BN;
  if (causal) n_kt = min(n_kt, (q0 + BM - 1) / BN + 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4) {  // ------------------------------------------ producer
    if constexpr (C::kMinBlocks == 2) regs_dealloc<24>();
    if (warp == 4 && lane == 0) {
      mbar_expect_tx(q_bar, 2 * kTile);
      for (int p = 0; p < NP; ++p) {
        tma_load_3d(q_sh + p * PANEL, &qmap, q_bar, p * 64, q0, bh);
        tma_load_3d(do_sh + p * PANEL, &domap, q_bar, p * 64, q0, bh);
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % S;
        if (kt >= S) mbar_wait(&empty[s], ((kt / S) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * kTile);
        for (int p = 0; p < NP; ++p) {
          tma_load_3d(k_sh + (s * NP + p) * PANEL, &kmap, &full[s], p * 64, kt * BN, bh);
          tma_load_3d(v_sh + (s * NP + p) * PANEL, &vmap, &full[s], p * 64, kt * BN, bh);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int g = lane >> 2, t = lane & 3;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const float scale_log2 = scale * kLog2e;
  float lse2[2], dl[2];  // per row: lse * log2 e and delta (0 past tq)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = row[i] < tq;
    lse2[i] = ok ? lse[(size_t)bh * tq + row[i]] * kLog2e : 0.f;
    dl[i] = ok ? delta[(size_t)bh * tq + row[i]] : 0.f;
  }
  if constexpr (C::kMinBlocks == 2) regs_alloc<232>();
  float acc[Dh / 2];
#pragma unroll
  for (int i = 0; i < Dh / 2; ++i) acc[i] = 0.f;
  mbar_wait(q_bar, 0);
  uint32_t qa[C::kRS ? Dh / 16 : 1][4], doa[C::kRS ? Dh / 16 : 1][4];
  if constexpr (C::kRS) {
#pragma unroll
    for (int kk = 0; kk < Dh / 16; ++kk) {
      a_from_sw128<T>(qa[kk], q_sh, kk, warp, g, t);
      a_from_sw128<T>(doa[kk], do_sh, kk, warp, g, t);
    }
  }

  // S(kt) = Q K(kt)^T into sc and dP(kt) = dO V(kt)^T into dp, issued and
  // committed as one group
  float sc[BN / 2], dp[BN / 2];
  auto issue_sdp = [&](int kt) {
    const int s = kt % S;
    mbar_wait(&full[s], (kt / S) & 1);
    const T* ks = k_sh + s * NP * PANEL;
    const T* vs = v_sh + s * NP * PANEL;
#pragma unroll
    for (int kk = 0; kk < Dh / 16; ++kk) {
      const int p = kk / 4, c = (kk % 4) * 16;
      if constexpr (C::kRS)
        Wgmma<T>::template rs_n64<0>(sc, qa[kk], sw128_desc(ks + p * PANEL + c, 16, 1024),
                                     kk > 0);
      else
        Wgmma<T>::ss_n64(sc, sw128_desc(q_sh + p * PANEL + c, 16, 1024),
                         sw128_desc(ks + p * PANEL + c, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < Dh / 16; ++kk) {
      const int p = kk / 4, c = (kk % 4) * 16;
      if constexpr (C::kRS)
        Wgmma<T>::template rs_n64<0>(dp, doa[kk], sw128_desc(vs + p * PANEL + c, 16, 1024),
                                     kk > 0);
      else
        Wgmma<T>::ss_n64(dp, sw128_desc(do_sh + p * PANEL + c, 16, 1024),
                         sw128_desc(vs + p * PANEL + c, 16, 1024), kk > 0);
    }
    wg_commit();
  };
  // ds = p (dp - delta) in place of s; element masks only in the copy for
  // the tile that crosses the diagonal or the ragged key tail
  auto ds_body = [&](int kt, auto masked) {
    constexpr bool kMask = decltype(masked)::value;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = fast_exp2(fmaf(sc[4 * j + e], scale_log2, -lse2[e >> 1]));
        if constexpr (kMask) {
          const int col = kt * BN + 8 * j + 2 * t + (e & 1);
          if (col >= tk || (causal && col > row[e >> 1])) p = 0.f;
        }
        sc[4 * j + e] = p * (dp[4 * j + e] - dl[e >> 1]);
      }
  };
  auto ds = [&](int kt) {
    const int k0 = kt * BN;
    if ((causal && k0 + BN - 1 > q0) || k0 + BN > tk)
      ds_body(kt, std::true_type{});
    else
      ds_body(kt, std::false_type{});
  };
  // dQ += dS(kt) K(kt), K MN-major; issued and committed
  uint32_t da[BN / 16][4];
  auto issue_dq = [&](int kt) {
    const T* ks = k_sh + (kt % S) * NP * PANEL;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t kd = sw128_desc(ks + kk * 16 * 64, PANEL * (int)sizeof(T), 1024);
      if constexpr (Dh == 64)
        Wgmma<T>::template rs_n64<1>(acc, da[kk], kd);
      else
        Wgmma<T>::rs_n128_mn(acc, da[kk], kd);
    }
    wg_commit();
  };

#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = dp[i] = 0.f;
  fence_regs<BN / 2>(sc);
  fence_regs<BN / 2>(dp);
  wg_fence();
  issue_sdp(0);
  wg_wait<0>();
  fence_regs<BN / 2>(sc);
  fence_regs<BN / 2>(dp);
  ds(0);
  for (int kt = 0; kt + 1 < n_kt; ++kt) {
    to_a_operand<T>(da, sc);
    fence_regs<BN / 2>(sc);
    fence_regs<BN / 2>(dp);
    fence_regs<Dh / 2>(acc);
    wg_fence();
    issue_sdp(kt + 1);
    issue_dq(kt);
    wg_wait<1>();  // S, dP(kt+1) are in; dQ(kt) may still run
    fence_regs<BN / 2>(sc);
    fence_regs<BN / 2>(dp);
    ds(kt + 1);
    wg_wait<0>();
    fence_regs<Dh / 2>(acc);
    mbar_arrive(&empty[kt % S]);  // K(kt), V(kt) are done with
  }
  to_a_operand<T>(da, sc);
  fence_regs<Dh / 2>(acc);
  wg_fence();
  issue_dq(n_kt - 1);
  wg_wait<0>();
  fence_regs<Dh / 2>(acc);
  mbar_arrive(&empty[(n_kt - 1) % S]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= tq) continue;
    T* drow = dq + ((size_t)bh * tq + row[i]) * Dh;
#pragma unroll
    for (int j = 0; j < Dh / 8; ++j)
      store2<T>(drow + 8 * j + 2 * t, acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
  }
}

// Kernel F: one block per (bh, 64-key tile) of one consumer warpgroup
// (warps 0-3) and a producer warpgroup whose warp 4 works. The producer
// loads the K and V tiles once, then streams the walk's 64-query tiles of Q
// and dO by TMA, its 32 lanes staging the tiles' 64 lse and delta entries
// beside them (plain loads: a TMA box must start 16-byte aligned, and
// bh * Tq + row need not be), one stage each, released once dV and dK have
// read them. S^T = K Q^T and dP^T = V dO^T are wgmma from shared memory;
// each accumulator column (a query) takes its lse and delta from the staged
// entries; P^T and dS^T, rounded to T, are the A operands of dV += P^T dO
// and dK += dS^T Q (dO and Q read MN-major). The causal walk starts at the
// first query tile that sees the key tile; key tile 0, the longest walk, is
// at blockIdx.x = 0. A key tile no query sees (causal, Tk > Tq) writes
// zeros.
//  * Registers: dK and dV stay in registers for the whole walk (Dh
//    f32 a thread). The producer warpgroup gives its registers to the
//    consumers (setmaxnreg: 232 a consumer thread, 24 a producer thread), so
//    two blocks fit an SM (at 160 threads Dh 64 took 201 registers, one
//    block an SM: 0.157 against 0.115 ms at GPT-2 774M's causal shape on an
//    H100).
//  * Dh 64: the elementwise step overlaps the previous tile's dV/dK
//    products (as in kernel E). Dh 128: dK and dV alone take 128 registers
//    a thread, so a tile's score products, elementwise step and gradient
//    products run in turn; the SM's other block fills the gaps (one block
//    of 160 threads at up to 255 registers: 0.34 against 0.29 ms at B 4,
//    H 16, T 2048, causal).
template <typename T, int Dh>
struct DkvH : BwdTile<T, Dh> {
  using B = BwdTile<T, Dh>;
  static constexpr bool kOverlap = Dh == 64;
  // stages of the (Q, dO, lse, delta) ring: Dh 64, 82 KB a block; Dh 128,
  // 97 KB; two blocks an SM
  static constexpr int kStages = Dh == 64 ? 4 : 2;
  static constexpr uint32_t kRowBytes = B::BN * sizeof(float);  // one stage's lse or delta
  static constexpr size_t kRowOff = (size_t)(2 + 2 * kStages) * B::kTileBytes;
  static constexpr size_t kBarOff = kRowOff + 2 * kStages * kRowBytes;
  static size_t smem() { return 1024 + kBarOff + 8 * (1 + 2 * kStages); }
};

template <typename T, int Dh>
__global__ void __launch_bounds__(256, 2)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap domap,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dk, T* __restrict__ dv, int tq, int tk, int causal,
                    float scale) {
  using namespace dst::hopper;
  using C = DkvH<T, Dh>;
  constexpr int BM = C::BM, BN = C::BN, S = C::kStages, NP = C::kPanels, PANEL = C::kPanel;
  constexpr uint32_t kTile = C::kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  const int bh = blockIdx.y, k0 = blockIdx.x * BM;
  const int n_qt = (tq + BN - 1) / BN;
  const int qt0 = causal ? min(k0 / BN, n_qt) : 0;  // earlier q tiles see none of these keys
  const int n_walk = n_qt - qt0;
  if (n_walk == 0) {  // no query sees these keys: dK = dV = 0
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    constexpr int kVpr = Dh * sizeof(T) / 16;
    for (int i = threadIdx.x; i < BM * kVpr; i += blockDim.x) {
      const int r = k0 + i / kVpr, c = i % kVpr;
      if (r >= tk) continue;
      reinterpret_cast<uint4*>(dk + ((size_t)bh * tk + r) * Dh)[c] = zero;
      reinterpret_cast<uint4*>(dv + ((size_t)bh * tk + r) * Dh)[c] = zero;
    }
    return;
  }
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  T* k_sh = reinterpret_cast<T*>(base);  // [NP][BM][64]
  T* v_sh = k_sh + NP * PANEL;            // [NP][BM][64]
  T* q_sh = v_sh + NP * PANEL;            // [S][NP][BN][64]
  T* do_sh = q_sh + S * NP * PANEL;       // [S][NP][BN][64]
  float* lse_sh = reinterpret_cast<float*>(base + C::kRowOff);  // [S][BN]
  float* dl_sh = lse_sh + S * BN;                               // [S][BN]
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(base + C::kBarOff);
  uint64_t* full = kv_bar + 1;
  uint64_t* empty = full + S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA bytes' arrival + the 32 lanes'
      mbar_init(&empty[s], 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4) {  // ------------------------------------------ producer
    regs_dealloc<24>();
    if (warp == 4) {
      if (lane == 0) {
        mbar_expect_tx(kv_bar, 2 * kTile);
        for (int p = 0; p < NP; ++p) {
          tma_load_3d(k_sh + p * PANEL, &kmap, kv_bar, p * 64, k0, bh);
          tma_load_3d(v_sh + p * PANEL, &vmap, kv_bar, p * 64, k0, bh);
        }
      }
      const float* lse_bh = lse + (size_t)bh * tq;
      const float* dl_bh = delta + (size_t)bh * tq;
      for (int i = 0; i < n_walk; ++i) {
        const int s = i % S, r0 = (qt0 + i) * BN;
        if (i >= S) mbar_wait(&empty[s], ((i / S) - 1) & 1);
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * kTile);
          for (int p = 0; p < NP; ++p) {
            tma_load_3d(q_sh + (s * NP + p) * PANEL, &qmap, &full[s], p * 64, r0, bh);
            tma_load_3d(do_sh + (s * NP + p) * PANEL, &domap, &full[s], p * 64, r0, bh);
          }
        }
        for (int c = lane; c < BN; c += 32) {  // 0 past tq (masked there)
          const bool ok = r0 + c < tq;
          lse_sh[s * BN + c] = ok ? lse_bh[r0 + c] : 0.f;
          dl_sh[s * BN + c] = ok ? dl_bh[r0 + c] : 0.f;
        }
        mbar_arrive(&full[s]);  // releases the stores to the consumers
      }
    }
    return;
  }
  regs_alloc<232>();

  // ------------------------------------------------------------ consumers
  const int g = lane >> 2, t = lane & 3;
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const float scale_log2 = scale * kLog2e;
  float dka[Dh / 2], dva[Dh / 2];
#pragma unroll
  for (int i = 0; i < Dh / 2; ++i) dka[i] = dva[i] = 0.f;
  mbar_wait(kv_bar, 0);

  // S^T(i) = K Q(i)^T into st and dP^T(i) = V dO(i)^T into dpt, issued and
  // committed as one group
  float st[BN / 2], dpt[BN / 2];
  auto issue_sdp = [&](int i) {
    const int s = i % S;
    mbar_wait(&full[s], (i / S) & 1);
    const T* qs = q_sh + s * NP * PANEL;
    const T* dos = do_sh + s * NP * PANEL;
#pragma unroll
    for (int kk = 0; kk < Dh / 16; ++kk) {
      const int p = kk / 4, c = (kk % 4) * 16;
      Wgmma<T>::ss_n64(st, sw128_desc(k_sh + p * PANEL + c, 16, 1024),
                       sw128_desc(qs + p * PANEL + c, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < Dh / 16; ++kk) {
      const int p = kk / 4, c = (kk % 4) * 16;
      Wgmma<T>::ss_n64(dpt, sw128_desc(v_sh + p * PANEL + c, 16, 1024),
                       sw128_desc(dos + p * PANEL + c, 16, 1024), kk > 0);
    }
    wg_commit();
  };
  // p^T in place of s^T, ds^T = p^T (dp^T - delta) in place of dp^T; the
  // lse and delta of column (query) 8j + 2t + e%2 from the staged entries
  auto ew_body = [&](int i, auto masked) {
    constexpr bool kMask = decltype(masked)::value;
    const int q0 = (qt0 + i) * BN;
    const float* ls = lse_sh + (i % S) * BN;
    const float* dls = dl_sh + (i % S) * BN;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
      const float2 d = *reinterpret_cast<const float2*>(dls + 8 * j + 2 * t);
      const float nl[2] = {-l.x * kLog2e, -l.y * kLog2e}, dd[2] = {d.x, d.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = fast_exp2(fmaf(st[4 * j + e], scale_log2, nl[e & 1]));
        if constexpr (kMask) {
          const int qc = q0 + 8 * j + 2 * t + (e & 1);
          if (qc >= tq || (causal && key[e >> 1] > qc)) p = 0.f;
        }
        st[4 * j + e] = p;
        dpt[4 * j + e] = p * (dpt[4 * j + e] - dd[e & 1]);
      }
    }
  };
  auto ew = [&](int i) {
    const int q0 = (qt0 + i) * BN;
    if ((causal && q0 < k0 + BM - 1) || q0 + BN > tq)
      ew_body(i, std::true_type{});
    else
      ew_body(i, std::false_type{});
  };
  // dV += P^T(i) dO(i) and dK += dS^T(i) Q(i), dO and Q MN-major; issued
  // and committed
  uint32_t pa[BN / 16][4], sa[BN / 16][4];
  auto issue_grad = [&](int i) {
    const int s = i % S;
    const T* qs = q_sh + s * NP * PANEL;
    const T* dos = do_sh + s * NP * PANEL;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t dod = sw128_desc(dos + kk * 16 * 64, PANEL * (int)sizeof(T), 1024);
      const uint64_t qd = sw128_desc(qs + kk * 16 * 64, PANEL * (int)sizeof(T), 1024);
      if constexpr (Dh == 64) {
        Wgmma<T>::template rs_n64<1>(dva, pa[kk], dod);
        Wgmma<T>::template rs_n64<1>(dka, sa[kk], qd);
      } else {
        Wgmma<T>::rs_n128_mn(dva, pa[kk], dod);
        Wgmma<T>::rs_n128_mn(dka, sa[kk], qd);
      }
    }
    wg_commit();
  };
  auto to_operands = [&]() {
    to_a_operand<T>(pa, st);
    to_a_operand<T>(sa, dpt);
  };

#pragma unroll
  for (int i = 0; i < BN / 2; ++i) st[i] = dpt[i] = 0.f;
  if constexpr (C::kOverlap) {
    fence_regs<BN / 2>(st);
    fence_regs<BN / 2>(dpt);
    wg_fence();
    issue_sdp(0);
    wg_wait<0>();
    fence_regs<BN / 2>(st);
    fence_regs<BN / 2>(dpt);
    ew(0);
    for (int i = 0; i + 1 < n_walk; ++i) {
      to_operands();
      fence_regs<BN / 2>(st);
      fence_regs<BN / 2>(dpt);
      fence_regs<Dh / 2>(dka);
      fence_regs<Dh / 2>(dva);
      wg_fence();
      issue_sdp(i + 1);
      issue_grad(i);
      wg_wait<1>();  // S^T, dP^T(i+1) are in; dV, dK(i) may still run
      fence_regs<BN / 2>(st);
      fence_regs<BN / 2>(dpt);
      ew(i + 1);
      wg_wait<0>();
      fence_regs<Dh / 2>(dka);
      fence_regs<Dh / 2>(dva);
      mbar_arrive(&empty[i % S]);  // Q(i), dO(i) are done with
    }
    to_operands();
    fence_regs<Dh / 2>(dka);
    fence_regs<Dh / 2>(dva);
    wg_fence();
    issue_grad(n_walk - 1);
    wg_wait<0>();
    fence_regs<Dh / 2>(dka);
    fence_regs<Dh / 2>(dva);
    mbar_arrive(&empty[(n_walk - 1) % S]);
  } else {
    for (int i = 0; i < n_walk; ++i) {
      fence_regs<BN / 2>(st);
      fence_regs<BN / 2>(dpt);
      wg_fence();
      issue_sdp(i);
      wg_wait<0>();
      fence_regs<BN / 2>(st);
      fence_regs<BN / 2>(dpt);
      ew(i);
      to_operands();
      fence_regs<Dh / 2>(dka);
      fence_regs<Dh / 2>(dva);
      wg_fence();
      issue_grad(i);
      wg_wait<0>();
      fence_regs<Dh / 2>(dka);
      fence_regs<Dh / 2>(dva);
      mbar_arrive(&empty[i % S]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= tk) continue;
    T* krow = dk + ((size_t)bh * tk + key[i]) * Dh;
    T* vrow = dv + ((size_t)bh * tk + key[i]) * Dh;
#pragma unroll
    for (int j = 0; j < Dh / 8; ++j) {
      store2<T>(krow + 8 * j + 2 * t, dka[4 * j + 2 * i] * scale, dka[4 * j + 2 * i + 1] * scale);
      store2<T>(vrow + 8 * j + 2 * t, dva[4 * j + 2 * i], dva[4 * j + 2 * i + 1]);
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

// A [bh, rows, Dh] 16-bit operand as a 3-d tensor map of 64-column x
// box_rows boxes, 128-byte swizzled, zero-filled past each bh's last row.
template <typename T, int Dh>
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int bh, int rows, int box_rows) {
  const dst::hopper::EncodeTiled encode = dst::hopper::encode_tiled();
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
cudaError_t launch_dq(const Args& a) {
  using Cfg = DqH<T, Dh>;
  CUtensorMap qm, km, vm, dom;
  cudaError_t err;
  if ((err = tensor_map<T, Dh>(&qm, a.q, a.bh, a.tq, Cfg::BM)) != cudaSuccess ||
      (err = tensor_map<T, Dh>(&km, a.k, a.bh, a.tk, Cfg::BN)) != cudaSuccess ||
      (err = tensor_map<T, Dh>(&vm, a.v, a.bh, a.tk, Cfg::BN)) != cudaSuccess ||
      (err = tensor_map<T, Dh>(&dom, a.dout, a.bh, a.tq, Cfg::BM)) != cudaSuccess)
    return err;
  auto kern = flash_bwd_dq_wgmma<T, Dh>;
  static size_t allowed = 48 * 1024;
  if ((err = allow_smem(kern, Cfg::smem(), allowed)) != cudaSuccess) return err;
  dim3 grid((a.tq + Cfg::BM - 1) / Cfg::BM, a.bh);
  kern<<<grid, 256, Cfg::smem(), a.st>>>(qm, km, vm, dom, a.lse_in, a.delta,
                                         static_cast<T*>(a.dq), a.tq, a.tk, a.causal,
                                         a.scale);
  return cudaGetLastError();
}

template <typename T, int Dh>
cudaError_t launch_dkv(const Args& a) {
  using Cfg = DkvH<T, Dh>;
  CUtensorMap qm, km, vm, dom;
  cudaError_t err;
  if ((err = tensor_map<T, Dh>(&qm, a.q, a.bh, a.tq, Cfg::BN)) != cudaSuccess ||
      (err = tensor_map<T, Dh>(&km, a.k, a.bh, a.tk, Cfg::BM)) != cudaSuccess ||
      (err = tensor_map<T, Dh>(&vm, a.v, a.bh, a.tk, Cfg::BM)) != cudaSuccess ||
      (err = tensor_map<T, Dh>(&dom, a.dout, a.bh, a.tq, Cfg::BN)) != cudaSuccess)
    return err;
  auto kern = flash_bwd_dkv_wgmma<T, Dh>;
  static size_t allowed = 48 * 1024;
  if ((err = allow_smem(kern, Cfg::smem(), allowed)) != cudaSuccess) return err;
  dim3 grid((a.tk + Cfg::BM - 1) / Cfg::BM, a.bh);
  kern<<<grid, 256, Cfg::smem(), a.st>>>(qm, km, vm, dom, a.lse_in, a.delta,
                                         static_cast<T*>(a.dk), static_cast<T*>(a.dv),
                                         a.tq, a.tk, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int Dh>
cudaError_t launch_tc(Which which, const Args& a) {
  if (which == kFwd)
    return a.scale < 0 ? launch_fwd<T, Dh, true>(a) : launch_fwd<T, Dh, false>(a);
  return which == kDq ? launch_dq<T, Dh>(a) : launch_dkv<T, Dh>(a);
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


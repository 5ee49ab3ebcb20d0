// Block-sparse attention forward and backward over a block layout's
// look-up tables, on flat [BH, T, Dh] operands.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/sparse_attention/block_sparse.py:
//   * dst_block_sparse_fwd     <- _fwd_kernel     (:84, pallas_call :267)
//   * dst_block_sparse_bwd_dq  <- _bwd_dq_kernel  (:130, pallas_call :325)
//   * dst_block_sparse_bwd_dkv <- _bwd_dkv_kernel (:168, pallas_call :353)
//
// Bound on the H100: the work is the active blocks only. Each active
// block x block tile does 4 * block^2 * Dh FLOP in the forward (6 for dQ,
// 8 for dK/dV) on one K and V tile, so at block 16 and Dh 128 a tile does
// 64 FLOP per byte it loads: below the bf16 ridge but above the f32 one.
// The reference's contract is f32 throughout (q, k, v and dO read as f32, p
// and dS never rounded), so this first version runs every product on the
// CUDA cores in f32, where its floor is operations at 67 TFLOP/s; the bf16
// tensor-core route would round p and dS, a departure left for later.
//
// Design:
//  * A block of 256 threads holds 64 rows: 64 / block row groups (four
//    query blocks at block 16, one at 64). In the forward (Geo) 4 threads
//    own a row, each Dh / 4 columns in float4 chunks (thread c of a row
//    takes chunks c, c + 4, ...: the row's 4 threads read 64 contiguous
//    bytes of a shared tile, conflict-free, and dot products are reduced
//    by two shuffles).
//  * Forward: each group walks only its own row of the table,
//    count[h, block] entries, not the padded width: the loop inside the
//    group takes the place of the TPU grid's last axis. The group stages
//    one K and V tile at a time in shared memory, converted to f32, and
//    syncs on its own named barrier, so groups with rows of different
//    lengths never wait on each other. Global rows (BigBird, Longformer)
//    still make their block the slowest: the split of long rows is left for
//    later.
//  * Forward: scores of the tile first (kept in shared memory, a padded
//    [row][key] tile), then an online softmax (running max m from -1e30 and
//    sum l, in f32) and acc += p * v. out = l > 0 ? acc / max(l, 1e-20) : 0,
//    lse = m + log(max(l, 1e-20)): a row with no visible key gives 0.
//  * Masks: scores of keys past the query under causal (absolute positions,
//    the diagonal tile element by element) are -1e30, and p is 0 wherever
//    the score is at or below -5e29 (the reference's _masked_p).
//  * dQ walks the same table: p = exp(s - lse), ds = p * (dp - delta),
//    acc += ds * k, dq = acc * scale once. dK/dV walk the transposed table
//    with one thread row per key row: dv += p * do, dk += ds * (scale * q).
//  * Both backward kernels run a work list built on the host with the
//    tables (block_sparse.py work_list), for balance: a global key block's
//    column holds every later query block (509 of them at T 8192, block
//    16), its neighbours 2-4, so four key blocks to a CUDA block kept 0.26
//    of its row groups busy; BigBird's global query rows hold 256 entries
//    against a mean of 6. Each row (dQ) or column (dK/dV) is cut into parts
//    of at most 64 entries, in table order, the parts sorted by length, G
//    to a CUDA block, the longest blocks first. A row or column of one part
//    writes its output itself; a cut one's parts write f32 partials to
//    scratch, and a merge launch (block_sparse_dq_merge,
//    block_sparse_dkv_merge) sums them in part order and rounds once.
//  * Each backward group keeps its next blocks' operands in flight (a
//    cp.async ring of 3 stages, 2 in f32: K and V for dQ; Q, dO, lse and
//    delta for dK/dV) while it computes on the current one, and each thread
//    owns two rows (8 threads to a row pair, PairGeo), so a chunk read once
//    from shared memory serves both rows' products. A step takes two rows
//    of the staged tile (dK/dV at Dh 128, dQ at every Dh) and
//    reduce-scatters their eight dot products over the row pair's lanes (7
//    shuffles where a reduction per value takes 24, one exp per lane where
//    there were four): the inner loop is then mostly FMAs. dQ's first form
//    (one tile staged at a time, 4 threads per row reading each chunk
//    twice, one query block per group) reached 0.20 of its f32 floor.
//  * No atomics: every output element is summed by one thread in a fixed
//    order (partials by one thread of a merge, in part order), so out, lse,
//    dQ, dK and dV repeat bit for bit.
#include "common.cuh"

namespace {

using namespace dst;

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 64;   // kThreads / 4
constexpr float kMInit = -1e30f;    // the reference's _NEG_INF
constexpr float kMaskedBelow = -5e29f;

// 4 consecutive elements <-> float4
template <typename T> struct Vec4;
template <> struct Vec4<float> {
  static __device__ __forceinline__ float4 load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};
template <> struct Vec4<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float4 v) {
    __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&a);
    u.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

__device__ __forceinline__ float4 scale4(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float a, float4 x, float4& y) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Row group g's barrier: named barrier 1 + g of GT threads (the whole block
// when it is one group), so groups with rows of different lengths never
// wait on each other.
template <int G, int GT>
__device__ __forceinline__ void group_sync(int g) {
  if (G == 1) {
    __syncthreads();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + g), "r"(GT) : "memory");
  }
}

// Thread geometry of one block: G groups of BLK rows, 4 threads per row.
template <int Dh, int BLK>
struct Geo {
  static constexpr int G = kRowsPerBlock / BLK;    // row groups
  static constexpr int GT = BLK * 4;               // threads per group
  static constexpr int NC = Dh / 16;               // float4 chunks per thread
  static constexpr int TILE = BLK * Dh;            // floats per staged tile
  static constexpr int SC = BLK + 1;               // score tile row stride
  int g, gt, r, c;
  __device__ Geo() {
    g = threadIdx.x / GT;
    gt = threadIdx.x % GT;
    r = gt / 4;
    c = gt % 4;
  }
  // column of chunk i
  __device__ __forceinline__ int col(int i) const { return 16 * i + 4 * c; }
  __device__ __forceinline__ void sync() const { group_sync<G, GT>(g); }
};

// rows [row0, row0 + BLK) of a [T, Dh] slab into an f32 [BLK][Dh] tile,
// times `mul`, by the group's GT threads
template <typename T, int Dh, int BLK>
__device__ __forceinline__ void stage(float* sm, const T* g, int row0, int gt, float mul) {
  constexpr int kChunks = BLK * Dh / 4;
  for (int i = gt; i < kChunks; i += BLK * 4) {
    const int r = i / (Dh / 4), c = (i % (Dh / 4)) * 4;
    float4 v = Vec4<T>::load(g + (size_t)(row0 + r) * Dh + c);
    if (mul != 1.f) v = scale4(v, mul);
    *reinterpret_cast<float4*>(sm + r * Dh + c) = v;
  }
}

// the forward's K and V tiles and its score tile, per group
template <int Dh, int BLK>
constexpr size_t fwd_smem() {
  using Ge = Geo<Dh, BLK>;
  return (size_t)Ge::G * (2 * Ge::TILE + BLK * Ge::SC) * sizeof(float);
}

// Thread geometry of the backward kernels: G groups of BLK rows (query rows
// for dQ, key rows for dK/dV), as Geo, but 8 threads per row pair: thread
// (r, c) of a group owns rows r and r + BLK / 2 and float4 chunks c, c + 8,
// ... of each (Dh / 32 of them). A staged row's chunks, read once from
// shared memory, then serve both rows' dot products and both rows' updates
// from registers: a quarter of Geo's shared-memory reads per FMA (the first
// form of dK/dV, one row per 4 threads reading each chunk twice, sat at 0.28
// of the f32 peak).
template <int Dh, int BLK>
struct PairGeo {
  static constexpr int G = kRowsPerBlock / BLK;    // row groups
  static constexpr int GT = BLK * 4;               // threads per group
  static constexpr int HALF = BLK / 2;             // row pairs per group
  static constexpr int NC = Dh / 32;               // float4 chunks per row per thread
  static constexpr int TILE = BLK * Dh;            // floats per staged tile
  int g, gt, r, c;
  __device__ PairGeo() {
    g = threadIdx.x / GT;
    gt = threadIdx.x % GT;
    r = gt / 8;
    c = gt % 8;
  }
  __device__ __forceinline__ int col(int i) const { return 32 * i + 4 * c; }
  __device__ __forceinline__ void sync() const { group_sync<G, GT>(g); }
};

__device__ __forceinline__ float oct_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

// A backward kernel's shared memory, per row group: a ring of ST stages of
// two stored (T) tiles of one block (dQ: K and V; dK/dV: Q and dO) and, for
// dK/dV (VEC), the block's lse and delta (f32); then f32 tiles of the
// current block's two operands.
template <typename T, int Dh, int BLK, bool VEC>
struct PairShape {
  using Ge = PairGeo<Dh, BLK>;
  static constexpr int ST = sizeof(T) == 4 ? 2 : 3;
  static constexpr size_t kRaw = (size_t)BLK * Dh * sizeof(T);  // one stored tile
  static constexpr size_t kStage = 2 * kRaw + (VEC ? 2 * BLK * sizeof(float) : 0);
  static constexpr size_t kGroup = ST * kStage + 2 * (size_t)Ge::TILE * sizeof(float);
  static constexpr size_t bytes() { return Ge::G * kGroup; }
};

template <typename T, int Dh, int BLK>
__global__ void __launch_bounds__(kThreads)
block_sparse_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        float* __restrict__ lse, const int* __restrict__ lut,
                        const int* __restrict__ cnt, int h_count, int t,
                        int lut_width, int causal, float scale) {
  using Ge = Geo<Dh, BLK>;
  extern __shared__ __align__(16) float smem[];
  const Ge geo;
  const int nb = t / BLK;
  const int qi = blockIdx.x * Ge::G + geo.g;
  if (qi >= nb) return;     // a whole group leaves: no barrier of others waits
  const int bh = blockIdx.y, h = bh % h_count;
  float* k_sh = smem + geo.g * (2 * Ge::TILE + BLK * Ge::SC);
  float* v_sh = k_sh + Ge::TILE;
  float* sc = v_sh + Ge::TILE;
  const int row = qi * BLK + geo.r;
  const size_t base = (size_t)bh * t * Dh;
  float4 qr[Ge::NC], acc[Ge::NC];
#pragma unroll
  for (int i = 0; i < Ge::NC; ++i) {
    qr[i] = scale4(Vec4<T>::load(q + base + (size_t)row * Dh + geo.col(i)), scale);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int* my_lut = lut + ((size_t)h * nb + qi) * lut_width;
  const int n = cnt[h * nb + qi];
  float m = kMInit, l = 0.f;
  for (int jj = 0; jj < n; ++jj) {
    const int kj = my_lut[jj];
    geo.sync();
    stage<T, Dh, BLK>(k_sh, k + base, kj * BLK, geo.gt, 1.f);
    stage<T, Dh, BLK>(v_sh, v + base, kj * BLK, geo.gt, 1.f);
    geo.sync();
    float mx = kMInit;
    for (int j = 0; j < BLK; ++j) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < Ge::NC; ++i)
        s = dot4(qr[i], *reinterpret_cast<const float4*>(k_sh + j * Dh + geo.col(i)), s);
      s = quad_sum(s);
      if (causal && kj * BLK + j > row) s = kMInit;
      if (geo.c == 0) sc[geo.r * Ge::SC + j] = s;
      mx = fmaxf(mx, s);
    }
    __syncwarp();
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < Ge::NC; ++i) acc[i] = scale4(acc[i], corr);
    for (int j = 0; j < BLK; ++j) {
      const float s = sc[geo.r * Ge::SC + j];
      const float p = s > kMaskedBelow ? expf(s - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int i = 0; i < Ge::NC; ++i)
        axpy4(p, *reinterpret_cast<const float4*>(v_sh + j * Dh + geo.col(i)), acc[i]);
    }
    m = m_new;
  }
  const float ls = fmaxf(l, 1e-20f);
  const float inv_ok = l > 0.f ? 1.f : 0.f;
#pragma unroll
  for (int i = 0; i < Ge::NC; ++i) {
    const float4 a = acc[i];
    const float4 out = make_float4(inv_ok * (a.x / ls), inv_ok * (a.y / ls),
                                   inv_ok * (a.z / ls), inv_ok * (a.w / ls));
    Vec4<T>::store(o + base + (size_t)row * Dh + geo.col(i), out);
  }
  if (geo.c == 0) lse[(size_t)bh * t + row] = m + logf(ls);
}

// BLK x Dh stored elements (shared memory) into an f32 tile, times `mul`,
// by the group's GT threads
template <typename T, int Dh, int BLK>
__device__ __forceinline__ void to_f32_tile(float* dst, const T* src, int gt, float mul) {
  constexpr int kChunks = BLK * Dh / 4;
  for (int i = gt; i < kChunks; i += BLK * 4) {
    float4 v = Vec4<T>::load(src + 4 * i);
    if (mul != 1.f) v = scale4(v, mul);
    *reinterpret_cast<float4*>(dst + 4 * i) = v;
  }
}

// One work item per row group: item (h * nb + kj, first entry, count, slot)
// walks entries first..first+count-1 of key block kj's column of the
// transposed table, for batch row blockIdx.y.
template <typename T, int Dh, int BLK>
__global__ void __launch_bounds__(kThreads)
block_sparse_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ part,
                        const int* __restrict__ lut_t, const int4* __restrict__ items,
                        int n_items, int n_slots, int h_count, int t, int lut_width,
                        int causal, float scale) {
  using Ge = PairGeo<Dh, BLK>;
  using Sh = PairShape<T, Dh, BLK, true>;
  // two query rows per step at Dh 128 (one block per SM either way); Dh 64
  // keeps one, so that two blocks fit per SM
  constexpr int ST = Sh::ST, NC = Ge::NC, JU = Dh >= 128 ? 2 : 1;
  extern __shared__ __align__(16) float smem[];
  const Ge geo;
  const int it = blockIdx.x * Ge::G + geo.g;
  if (it >= n_items) return;  // a whole group leaves: no barrier of others waits
  const int4 item = items[it];
  const int nb = t / BLK;
  const int h = item.x / nb, kj = item.x - h * nb;
  const int b = blockIdx.y, bh = b * h_count + h;
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem) + geo.g * Sh::kGroup;
  float* q_sh = reinterpret_cast<float*>(ring + ST * Sh::kStage);
  float* do_sh = q_sh + Ge::TILE;
  const size_t base = (size_t)bh * t * Dh;
  // key rows kj * BLK + r + m * HALF, m = 0, 1
  int key[2];
  float4 kr[2][NC], vr[2][NC], dka[2][NC], dva[2][NC];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    key[m] = kj * BLK + geo.r + m * Ge::HALF;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const size_t at = base + (size_t)key[m] * Dh + geo.col(i);
      kr[m][i] = Vec4<T>::load(k + at);
      vr[m][i] = Vec4<T>::load(v + at);
      dka[m][i] = dva[m][i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  const int* my_lut = lut_t + ((size_t)h * nb + kj) * lut_width + item.y;
  const int n = item.z;
  // entry jj's Q, dO, lse and delta rows into stage jj % ST
  auto issue = [&](int jj) {
    unsigned char* st = ring + (jj % ST) * Sh::kStage;
    const size_t row0 = (size_t)my_lut[jj] * BLK;
    const unsigned char* qs = reinterpret_cast<const unsigned char*>(q + base + row0 * Dh);
    const unsigned char* ds = reinterpret_cast<const unsigned char*>(dout + base + row0 * Dh);
    for (int i = geo.gt; i < (int)(Sh::kRaw / 16); i += Ge::GT) {
      cp_async16(st + 16 * i, qs + 16 * i);
      cp_async16(st + Sh::kRaw + 16 * i, ds + 16 * i);
    }
    if (geo.gt < BLK / 4) {
      const size_t at = (size_t)bh * t + row0 + 4 * geo.gt;
      cp_async16(st + 2 * Sh::kRaw + 16 * geo.gt, lse + at);
      cp_async16(st + 2 * Sh::kRaw + BLK * sizeof(float) + 16 * geo.gt, delta + at);
    }
  };
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < n) issue(s);
    cp_async_commit();
  }
  for (int jj = 0; jj < n; ++jj) {
    cp_async_wait<ST - 2>();
    geo.sync();  // entry jj landed; the f32 tiles and stage jj - 1 are free
    if (jj + ST - 1 < n) issue(jj + ST - 1);
    cp_async_commit();
    const unsigned char* st = ring + (jj % ST) * Sh::kStage;
    to_f32_tile<T, Dh, BLK>(q_sh, reinterpret_cast<const T*>(st), geo.gt, scale);
    to_f32_tile<T, Dh, BLK>(do_sh, reinterpret_cast<const T*>(st + Sh::kRaw), geo.gt, 1.f);
    const float* lse_sh = reinterpret_cast<const float*>(st + 2 * Sh::kRaw);
    const float* dl_sh = lse_sh + BLK;
    geo.sync();
    const int q0 = my_lut[jj] * BLK;
    for (int j0 = 0; j0 < BLK; j0 += JU) {
      // JU query rows at a time, independent chains for the latency
      float4 qv[JU][NC], dov[JU][NC];
      float sv[JU][2], dp[JU][2];
#pragma unroll
      for (int u = 0; u < JU; ++u) {
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          qv[u][i] = *reinterpret_cast<const float4*>(q_sh + (j0 + u) * Dh + geo.col(i));
          dov[u][i] = *reinterpret_cast<const float4*>(do_sh + (j0 + u) * Dh + geo.col(i));
        }
        sv[u][0] = sv[u][1] = dp[u][0] = dp[u][1] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < NC; ++i)
#pragma unroll
        for (int u = 0; u < JU; ++u)
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            sv[u][m] = dot4(kr[m][i], qv[u][i], sv[u][m]);
            dp[u][m] = dot4(vr[m][i], dov[u][i], dp[u][m]);
          }
      if constexpr (JU == 2) {
        // the 8 partial sums s[u][m], dp[u][m] reduce-scattered over the 8
        // lanes of the row pair (7 shuffles, not 24): lane c ends with sum c
        // (s for c < 4, dp for c >= 4, of (u, m) = (c >> 1 & 1, c & 1));
        // lanes c < 4 compute one p and ds each, one exp where there were
        // four, and the 4 (p, ds) pairs go back to every lane
        const int c = geo.c;
        const float v8[8] = {sv[0][0], sv[0][1], sv[1][0], sv[1][1],
                             dp[0][0], dp[0][1], dp[1][0], dp[1][1]};
        float w4[4], w2[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float keep = (c & 4) ? v8[4 + i] : v8[i], give = (c & 4) ? v8[i] : v8[4 + i];
          w4[i] = keep + __shfl_xor_sync(0xffffffffu, give, 4);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float keep = (c & 2) ? w4[2 + i] : w4[i], give = (c & 2) ? w4[i] : w4[2 + i];
          w2[i] = keep + __shfl_xor_sync(0xffffffffu, give, 2);
        }
        const float mine = ((c & 1) ? w2[1] : w2[0]) +
                           __shfl_xor_sync(0xffffffffu, (c & 1) ? w2[0] : w2[1], 1);
        const float dpv = __shfl_xor_sync(0xffffffffu, mine, 4);  // lanes c < 4: dp
        const int u = (c >> 1) & 1, m = c & 1, j = j0 + u;
        float sm = c < 4 ? mine : kMInit;  // lanes c >= 4 hold a dp: p = 0
        if (causal && key[m] > q0 + j) sm = kMInit;
        // exp of an argument below -127 is 0 in f32 either way; the clamp
        // keeps masked lanes off exp's out-of-range path
        const float p = sm > kMaskedBelow ? expf(fmaxf(sm - lse_sh[j], -127.f)) : 0.f;
        const float ds = p * (dpv - dl_sh[j]);
#pragma unroll
        for (int uu = 0; uu < 2; ++uu)
#pragma unroll
          for (int mm = 0; mm < 2; ++mm) {
            const float pq = __shfl_sync(0xffffffffu, p, 2 * uu + mm, 8);
            const float dq = __shfl_sync(0xffffffffu, ds, 2 * uu + mm, 8);
#pragma unroll
            for (int i = 0; i < NC; ++i) {
              axpy4(pq, dov[uu][i], dva[mm][i]);
              axpy4(dq, qv[uu][i], dka[mm][i]);
            }
          }
      } else {
        const float lj = lse_sh[j0], dlj = dl_sh[j0];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          float sm = oct_sum(sv[0][m]);
          const float dpm = oct_sum(dp[0][m]);
          if (causal && key[m] > q0 + j0) sm = kMInit;
          const float p = sm > kMaskedBelow ? expf(sm - lj) : 0.f;
          const float ds = p * (dpm - dlj);
#pragma unroll
          for (int i = 0; i < NC; ++i) {
            axpy4(p, dov[0][i], dva[m][i]);
            axpy4(ds, qv[0][i], dka[m][i]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    if (item.w < 0) {  // the whole column: dK/dV themselves
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const size_t at = base + (size_t)key[m] * Dh + geo.col(i);
        Vec4<T>::store(dk + at, dka[m][i]);
        Vec4<T>::store(dv + at, dva[m][i]);
      }
    } else {           // one part: f32 partials [2][BLK][Dh] in its slot
      float* pk = part + (size_t)(b * n_slots + item.w) * 2 * BLK * Dh +
                  (geo.r + m * Ge::HALF) * Dh;
      float* pv = pk + BLK * Dh;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        *reinterpret_cast<float4*>(pk + geo.col(i)) = dka[m][i];
        *reinterpret_cast<float4*>(pv + geo.col(i)) = dva[m][i];
      }
    }
  }
}

__device__ __forceinline__ void add4(float4& y, float4 x) {
  y.x += x.x;
  y.y += x.y;
  y.z += x.z;
  y.w += x.w;
}

// The columns cut in parts: merge entry (h * nb + kj, first slot, parts, 0)
// sums its parts' partials in part order and rounds dK/dV once.
template <typename T, int Dh, int BLK>
__global__ void __launch_bounds__(kThreads)
block_sparse_dkv_merge(const float* __restrict__ part, const int4* __restrict__ merge,
                       T* __restrict__ dk, T* __restrict__ dv, int n_slots, int h_count,
                       int t) {
  const int4 m = merge[blockIdx.x];
  const int nb = t / BLK, h = m.x / nb, kj = m.x - h * nb, b = blockIdx.y;
  const size_t at = ((size_t)(b * h_count + h) * t + (size_t)kj * BLK) * Dh;
  const float* p0 = part + (size_t)(b * n_slots + m.y) * 2 * BLK * Dh;
  for (int i = 4 * threadIdx.x; i < BLK * Dh; i += 4 * kThreads) {
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int j = 0; j < m.z; ++j) {
      const float* pj = p0 + (size_t)j * 2 * BLK * Dh;
      add4(sk, *reinterpret_cast<const float4*>(pj + i));
      add4(sv, *reinterpret_cast<const float4*>(pj + BLK * Dh + i));
    }
    Vec4<T>::store(dk + at + i, sk);
    Vec4<T>::store(dv + at + i, sv);
  }
}

// One work item per row group: item (h * nb + qi, first entry, count, slot)
// walks entries first..first+count-1 of query block qi's row of the table,
// for batch row blockIdx.y. Each thread owns query rows r and r + BLK / 2
// (q scaled, dO, lse and delta in registers) and stages the entries' K and V.
template <typename T, int Dh, int BLK>
__global__ void __launch_bounds__(kThreads)
block_sparse_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       T* __restrict__ dq, float* __restrict__ part,
                       const int* __restrict__ lut, const int4* __restrict__ items,
                       int n_items, int n_slots, int h_count, int t, int lut_width,
                       int causal, float scale) {
  using Ge = PairGeo<Dh, BLK>;
  using Sh = PairShape<T, Dh, BLK, false>;
  constexpr int ST = Sh::ST, NC = Ge::NC;
  extern __shared__ __align__(16) float smem[];
  const Ge geo;
  const int it = blockIdx.x * Ge::G + geo.g;
  if (it >= n_items) return;  // a whole group leaves: no barrier of others waits
  const int4 item = items[it];
  const int nb = t / BLK;
  const int h = item.x / nb, qi = item.x - h * nb;
  const int b = blockIdx.y, bh = b * h_count + h;
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem) + geo.g * Sh::kGroup;
  float* k_sh = reinterpret_cast<float*>(ring + ST * Sh::kStage);
  float* v_sh = k_sh + Ge::TILE;
  const size_t base = (size_t)bh * t * Dh;
  // query rows qi * BLK + r + m * HALF, m = 0, 1
  int row[2];
  float lr[2], dl[2];
  float4 qr[2][NC], dor[2][NC], acc[2][NC];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    row[m] = qi * BLK + geo.r + m * Ge::HALF;
    lr[m] = lse[(size_t)bh * t + row[m]];
    dl[m] = delta[(size_t)bh * t + row[m]];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const size_t at = base + (size_t)row[m] * Dh + geo.col(i);
      qr[m][i] = scale4(Vec4<T>::load(q + at), scale);
      dor[m][i] = Vec4<T>::load(dout + at);
      acc[m][i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  const int* my_lut = lut + ((size_t)h * nb + qi) * lut_width + item.y;
  const int n = item.z;
  // entry jj's K and V rows into stage jj % ST
  auto issue = [&](int jj) {
    unsigned char* st = ring + (jj % ST) * Sh::kStage;
    const size_t row0 = (size_t)my_lut[jj] * BLK;
    const unsigned char* ks = reinterpret_cast<const unsigned char*>(k + base + row0 * Dh);
    const unsigned char* vs = reinterpret_cast<const unsigned char*>(v + base + row0 * Dh);
    for (int i = geo.gt; i < (int)(Sh::kRaw / 16); i += Ge::GT) {
      cp_async16(st + 16 * i, ks + 16 * i);
      cp_async16(st + Sh::kRaw + 16 * i, vs + 16 * i);
    }
  };
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < n) issue(s);
    cp_async_commit();
  }
  for (int jj = 0; jj < n; ++jj) {
    cp_async_wait<ST - 2>();
    geo.sync();  // entry jj landed; the f32 tiles and stage jj - 1 are free
    if (jj + ST - 1 < n) issue(jj + ST - 1);
    cp_async_commit();
    const unsigned char* st = ring + (jj % ST) * Sh::kStage;
    to_f32_tile<T, Dh, BLK>(k_sh, reinterpret_cast<const T*>(st), geo.gt, 1.f);
    to_f32_tile<T, Dh, BLK>(v_sh, reinterpret_cast<const T*>(st + Sh::kRaw), geo.gt, 1.f);
    geo.sync();
    const int k0 = my_lut[jj] * BLK;
    for (int j0 = 0; j0 < BLK; j0 += 2) {
      // two key rows at a time, independent chains for the latency (at Dh 64
      // too, unlike dK/dV: dQ holds three row arrays where dK/dV holds four,
      // so two blocks still fit an SM)
      float4 kv[2][NC], vv[2][NC];
      float sv[2][2], dp[2][2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          kv[u][i] = *reinterpret_cast<const float4*>(k_sh + (j0 + u) * Dh + geo.col(i));
          vv[u][i] = *reinterpret_cast<const float4*>(v_sh + (j0 + u) * Dh + geo.col(i));
        }
        sv[u][0] = sv[u][1] = dp[u][0] = dp[u][1] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < NC; ++i)
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            sv[u][m] = dot4(qr[m][i], kv[u][i], sv[u][m]);
            dp[u][m] = dot4(dor[m][i], vv[u][i], dp[u][m]);
          }
      // the 8 partial sums s[u][m], dp[u][m] reduce-scattered over the 8
      // lanes of the row pair as in the dK/dV kernel: lane c < 4 ends with s
      // of (u, m) = (c >> 1 & 1, c & 1) and takes its dp from lane c + 4,
      // computes one ds, and the 4 ds go back to every lane
      const int c = geo.c;
      const float v8[8] = {sv[0][0], sv[0][1], sv[1][0], sv[1][1],
                           dp[0][0], dp[0][1], dp[1][0], dp[1][1]};
      float w4[4], w2[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float keep = (c & 4) ? v8[4 + i] : v8[i], give = (c & 4) ? v8[i] : v8[4 + i];
        w4[i] = keep + __shfl_xor_sync(0xffffffffu, give, 4);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float keep = (c & 2) ? w4[2 + i] : w4[i], give = (c & 2) ? w4[i] : w4[2 + i];
        w2[i] = keep + __shfl_xor_sync(0xffffffffu, give, 2);
      }
      const float mine = ((c & 1) ? w2[1] : w2[0]) +
                         __shfl_xor_sync(0xffffffffu, (c & 1) ? w2[0] : w2[1], 1);
      const float dpv = __shfl_xor_sync(0xffffffffu, mine, 4);  // lanes c < 4: dp
      const int u = (c >> 1) & 1, m = c & 1;
      float sm = c < 4 ? mine : kMInit;  // lanes c >= 4 hold a dp: p = 0
      if (causal && k0 + j0 + u > (m ? row[1] : row[0])) sm = kMInit;
      // exp of an argument below -127 is 0 in f32 either way; the clamp
      // keeps masked lanes off exp's out-of-range path
      const float p =
          sm > kMaskedBelow ? expf(fmaxf(sm - (m ? lr[1] : lr[0]), -127.f)) : 0.f;
      const float ds = p * (dpv - (m ? dl[1] : dl[0]));
#pragma unroll
      for (int uu = 0; uu < 2; ++uu)
#pragma unroll
        for (int mm = 0; mm < 2; ++mm) {
          const float dsq = __shfl_sync(0xffffffffu, ds, 2 * uu + mm, 8);
#pragma unroll
          for (int i = 0; i < NC; ++i) axpy4(dsq, kv[uu][i], acc[mm][i]);
        }
    }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    if (item.w < 0) {  // the whole row: dQ itself, scaled once
#pragma unroll
      for (int i = 0; i < NC; ++i)
        Vec4<T>::store(dq + base + (size_t)row[m] * Dh + geo.col(i), scale4(acc[m][i], scale));
    } else {           // one part: an f32 partial [BLK][Dh] in its slot
      float* pq = part + (size_t)(b * n_slots + item.w) * BLK * Dh +
                  (geo.r + m * Ge::HALF) * Dh;
#pragma unroll
      for (int i = 0; i < NC; ++i) *reinterpret_cast<float4*>(pq + geo.col(i)) = acc[m][i];
    }
  }
}

// The rows cut in parts: merge entry (h * nb + qi, first slot, parts, 0)
// sums its parts' partials in part order, scales and rounds dQ once.
template <typename T, int Dh, int BLK>
__global__ void __launch_bounds__(kThreads)
block_sparse_dq_merge(const float* __restrict__ part, const int4* __restrict__ merge,
                      T* __restrict__ dq, int n_slots, int h_count, int t, float scale) {
  const int4 m = merge[blockIdx.x];
  const int nb = t / BLK, h = m.x / nb, qi = m.x - h * nb, b = blockIdx.y;
  const size_t at = ((size_t)(b * h_count + h) * t + (size_t)qi * BLK) * Dh;
  const float* p0 = part + (size_t)(b * n_slots + m.y) * BLK * Dh;
  for (int i = 4 * threadIdx.x; i < BLK * Dh; i += 4 * kThreads) {
    float4 sq = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < m.z; ++j)
      add4(sq, *reinterpret_cast<const float4*>(p0 + (size_t)j * BLK * Dh + i));
    Vec4<T>::store(dq + at + i, scale4(sq, scale));
  }
}

// ------------------------------------------------------------------ launch
struct Args {
  const void *q, *k, *v, *dout;
  void *o, *dq, *dk, *dv;
  float *lse, *part;
  const float *lse_in, *delta;
  const int *lut, *cnt;
  const int4 *items, *merge;
  int n_items, n_merge, n_slots;
  int bh, h, t, lut_width, causal;
  float scale;
  cudaStream_t st;
};

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

// Raise a kernel's dynamic shared-memory cap once (never inside a graph
// capture: the first call of each instantiation is a plain launch).
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

template <typename T, int Dh, int BLK>
cudaError_t launch(Which which, const Args& a) {
  using Ge = Geo<Dh, BLK>;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  cudaError_t err;
  if (which == kFwd) {
    auto kern = block_sparse_fwd_kernel<T, Dh, BLK>;
    constexpr size_t smem = fwd_smem<Dh, BLK>();
    static size_t allowed = 48 * 1024;
    if ((err = allow_smem(kern, smem, allowed)) != cudaSuccess) return err;
    const dim3 grid((a.t / BLK + Ge::G - 1) / Ge::G, a.bh);
    kern<<<grid, kThreads, smem, a.st>>>(q, k, v, static_cast<T*>(a.o), a.lse, a.lut, a.cnt,
                                         a.h, a.t, a.lut_width, a.causal, a.scale);
  } else if (which == kDq) {
    using Sh = PairShape<T, Dh, BLK, false>;
    auto kern = block_sparse_dq_kernel<T, Dh, BLK>;
    static size_t allowed = 48 * 1024;
    if ((err = allow_smem(kern, Sh::bytes(), allowed)) != cudaSuccess) return err;
    const dim3 work((a.n_items + Sh::Ge::G - 1) / Sh::Ge::G, a.bh / a.h);
    kern<<<work, kThreads, Sh::bytes(), a.st>>>(
        q, k, v, static_cast<const T*>(a.dout), a.lse_in, a.delta, static_cast<T*>(a.dq),
        a.part, a.lut, a.items, a.n_items, a.n_slots, a.h, a.t, a.lut_width, a.causal,
        a.scale);
    if ((err = cudaGetLastError()) != cudaSuccess || a.n_merge == 0) return err;
    block_sparse_dq_merge<T, Dh, BLK><<<dim3(a.n_merge, a.bh / a.h), kThreads, 0, a.st>>>(
        a.part, a.merge, static_cast<T*>(a.dq), a.n_slots, a.h, a.t, a.scale);
  } else {
    using Sh = PairShape<T, Dh, BLK, true>;
    auto kern = block_sparse_dkv_kernel<T, Dh, BLK>;
    static size_t allowed = 48 * 1024;
    if ((err = allow_smem(kern, Sh::bytes(), allowed)) != cudaSuccess) return err;
    const dim3 work((a.n_items + Sh::Ge::G - 1) / Sh::Ge::G, a.bh / a.h);
    kern<<<work, kThreads, Sh::bytes(), a.st>>>(
        q, k, v, static_cast<const T*>(a.dout), a.lse_in, a.delta,
        static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.part, a.lut, a.items, a.n_items,
        a.n_slots, a.h, a.t, a.lut_width, a.causal, a.scale);
    if ((err = cudaGetLastError()) != cudaSuccess || a.n_merge == 0) return err;
    block_sparse_dkv_merge<T, Dh, BLK><<<dim3(a.n_merge, a.bh / a.h), kThreads, 0, a.st>>>(
        a.part, a.merge, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.n_slots, a.h,
        a.t);
  }
  return cudaGetLastError();
}

template <typename T, int Dh>
cudaError_t by_block(Which which, int block, const Args& a) {
  switch (block) {
    case 16: return launch<T, Dh, 16>(which, a);
    case 32: return launch<T, Dh, 32>(which, a);
    case 64: return launch<T, Dh, 64>(which, a);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_dh(Which which, int dh, int block, const Args& a) {
  if (dh == 64) return by_block<T, 64>(which, block, a);
  if (dh == 128) return by_block<T, 128>(which, block, a);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(Which which, int dh, int block, int dtype, const Args& a) {
  if (a.bh <= 0 || a.bh > 65535 || a.h <= 0 || a.bh % a.h || block <= 0 ||
      a.t <= 0 || a.t % block || a.lut_width <= 0)
    return cudaErrorInvalidValue;
  if (dtype == kF32) return by_dh<float>(which, dh, block, a);
  if (dtype == kBF16) return by_dh<__nv_bfloat16>(which, dh, block, a);
  return cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* k, const void* v, const void* lut,
               const void* cnt, int bh, int h, int t, int lut_width, int causal,
               float scale, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v;
  a.lut = static_cast<const int*>(lut); a.cnt = static_cast<const int*>(cnt);
  a.bh = bh; a.h = h; a.t = t; a.lut_width = lut_width; a.causal = causal;
  a.scale = scale; a.st = static_cast<cudaStream_t>(stream);
  return a;
}

// The backward kernels' common arguments: dout [BH, T, Dh]; lse, delta f32
// [BH, T]; a table and its work list (block_sparse.py work_list): items
// int32 [n_items, 4], merge int32 [n_merge, 4], and part f32 scratch for the
// partials (null when n_slots is 0).
bool bad_work(int n_items, int n_merge, int n_slots, const void* part, int bh, int h) {
  return n_items <= 0 || n_merge < 0 || n_slots < 0 || (n_slots > 0 && !part) ||
         (n_merge > 0 && n_slots == 0) || (bh > 0 && h > 0 && bh / h > 65535);
}

Args bwd_args(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, const void* lut, const void* items,
              const void* merge, void* part, int n_items, int n_merge, int n_slots, int bh,
              int h, int t, int lut_width, int causal, float scale, void* stream) {
  Args a = make_args(q, k, v, lut, nullptr, bh, h, t, lut_width, causal, scale, stream);
  a.items = static_cast<const int4*>(items);
  a.merge = static_cast<const int4*>(merge);
  a.part = static_cast<float*>(part);
  a.n_items = n_items;
  a.n_merge = n_merge;
  a.n_slots = n_slots;
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  return a;
}

}  // namespace

// q, k, v, o [BH, T, Dh]; lse f32 [BH, T]; lut int32 [H, T/block, lut_width]
// (active key blocks of each query block, ascending, -1 padded); cnt int32
// [H, T/block] (active entries of each row).
extern "C" int dst_block_sparse_fwd(const void* q, const void* k, const void* v,
                                    void* o, void* lse, const void* lut,
                                    const void* cnt, int bh, int h, int t, int dh,
                                    int block, int lut_width, int causal,
                                    float scale, int dtype, void* stream) {
  Args a = make_args(q, k, v, lut, cnt, bh, h, t, lut_width, causal, scale, stream);
  a.o = o;
  a.lse = static_cast<float*>(lse);
  return dispatch(kFwd, dh, block, dtype, a);
}

// dq [BH, T, Dh]; lut as the forward's; the work list over its rows; part
// [BH / H, n_slots, block, Dh].
extern "C" int dst_block_sparse_bwd_dq(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse,
                                       const void* delta, void* dq, const void* lut,
                                       const void* items, const void* merge, void* part,
                                       int n_items, int n_merge, int n_slots, int bh, int h,
                                       int t, int dh, int block, int lut_width, int causal,
                                       float scale, int dtype, void* stream) {
  if (bad_work(n_items, n_merge, n_slots, part, bh, h)) return cudaErrorInvalidValue;
  Args a = bwd_args(q, k, v, dout, lse, delta, lut, items, merge, part, n_items, n_merge,
                    n_slots, bh, h, t, lut_width, causal, scale, stream);
  a.dq = dq;
  return dispatch(kDq, dh, block, dtype, a);
}

// dk, dv [BH, T, Dh]; lut_t int32 [H, T/block, lut_width] (active query
// blocks of each key block); the work list over its columns; part
// [BH / H, n_slots, 2, block, Dh].
extern "C" int dst_block_sparse_bwd_dkv(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse,
                                        const void* delta, void* dk, void* dv,
                                        const void* lut_t, const void* items,
                                        const void* merge, void* part, int n_items,
                                        int n_merge, int n_slots, int bh, int h, int t,
                                        int dh, int block, int lut_width, int causal,
                                        float scale, int dtype, void* stream) {
  if (bad_work(n_items, n_merge, n_slots, part, bh, h)) return cudaErrorInvalidValue;
  Args a = bwd_args(q, k, v, dout, lse, delta, lut_t, items, merge, part, n_items, n_merge,
                    n_slots, bh, h, t, lut_width, causal, scale, stream);
  a.dk = dk;
  a.dv = dv;
  return dispatch(kDkv, dh, block, dtype, a);
}

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
// and dS never rounded), so every product that takes p or dS runs on the
// CUDA cores in f32, where its floor is operations at 67 TFLOP/s; the bf16
// tensor-core route would round p and dS, a departure left for later. Only
// the 16-bit forward's q.k^T, whose operands are exact in 16 bits, runs on
// the tensor cores (f32 accumulation, the scale applied to the f32 score).
//
// Design:
//  * A block of 256 threads holds 64 rows: 64 / block row groups (four
//    blocks of rows at block 16, one at 64), each on its own named barrier,
//    so groups with rows of different lengths never wait on each other.
//    Each thread owns two rows of its group (8 threads to a row pair,
//    PairGeo): thread (r, c) owns rows r and r + block / 2 and float4 chunks
//    c, c + 8, ... of each (Dh / 32 of them), so a chunk read once from
//    shared memory serves both rows' products from registers.
//  * All three kernels run a work list built on the host with the tables
//    (block_sparse.py work_list), for balance: a global key block's column
//    holds every later query block (509 of them at T 8192, block 16), its
//    neighbours 2-4, so four key blocks to a CUDA block kept 0.26 of its row
//    groups busy; BigBird's global query rows hold 256 entries against a
//    mean of 6. Each row (forward, dQ; one list) or column (dK/dV) is cut
//    into parts of at most 64 entries, in table order, the parts sorted by
//    length, G to a CUDA block, the longest blocks first. A row or column of
//    one part writes its output itself; a cut one's parts write f32
//    partials to scratch, and a merge launch (block_sparse_fwd_merge,
//    block_sparse_dq_merge, block_sparse_dkv_merge) combines them in part
//    order and rounds once.
//  * Each group keeps its next blocks' operands in flight (a cp.async ring:
//    K and V for the forward and dQ, 2 stages in the forward; Q, dO, lse
//    and delta for dK/dV; 3 stages for 16-bit backward operands, 2 in f32)
//    while it computes on the current one. 16-bit tiles that the CUDA cores
//    read are converted to f32 tiles once per block; the f32 forward reads
//    its ring.
//  * Forward, 16-bit (block_sparse_fwd_tc): each of a group's block / 8
//    warps computes one 16-row m-tile of S = q . k^T over block / 16 8-key
//    n-tiles by mma.sync (q's A fragments held in registers for the whole
//    row; K staged with its 16-byte chunks XOR-swizzled by row, so the B
//    fragments' loads hit 32 banks) and scales it in f32; the two warps of
//    an m-tile exchange row maxima, then write p and the rows' corrections
//    to shared memory for the row-pair threads' acc += p * v. With a
//    2-stage ring the kernel takes 102 KB at block 16 and Dh 128, so two
//    blocks share an SM. On one H100 at layout (a)
//    (scripts/time_port_kernels.py) it took 3.99 ms where the same walk
//    with the scores on the CUDA cores took 6.64 (5.57 at two blocks an SM).
//  * Forward, f32 (block_sparse_fwd_kernel): the scores of four keys a
//    step; each thread's partial dot products (4 keys x 2 rows) are
//    reduce-scattered over the row pair's 8 lanes (7 shuffles), so lane c
//    ends with the score of key c / 2 for row c % 2 and computes its p once
//    (the first form had the 4 threads of a row compute every exp).
//  * Forward, both: the running max m (from -1e30) and sum l are per row,
//    in f32; p goes to a small [row][key] tile in shared memory, read back
//    as float4s by the row pair's lanes for acc += p * v. out = l > 0 ? acc
//    / max(l, 1e-20) : 0, lse = m + log(max(l, 1e-20)): a row with no
//    visible key gives 0. A part of a cut row writes
//    its acc, m and l; the merge takes M = max m_j, L = sum e^(m_j - M) l_j
//    and acc = sum e^(m_j - M) acc_j in part order (a part that saw no key
//    has m -1e30 and l 0 and adds nothing), launched as a programmatic
//    dependent of the forward (it waits on griddepcontrol.wait).
//  * Masks: scores of keys past the query under causal (absolute positions,
//    the diagonal tile element by element) are -1e30, and p is 0 wherever
//    the score is at or below -5e29 (the reference's _masked_p).
//  * dQ walks the table's rows: p = exp(s - lse), ds = p * (dp - delta),
//    acc += ds * k, dq = acc * scale once. dK/dV walk the transposed table:
//    dv += p * do, dk += ds * (scale * q). A step takes two rows of the
//    staged tile (dK/dV at Dh 128, dQ at every Dh) and reduce-scatters
//    their eight dot products over the row pair's lanes (7 shuffles where a
//    reduction per value takes 24, one exp per lane where there were four):
//    the inner loop is then mostly FMAs. dQ's first form (one tile staged
//    at a time, 4 threads per row reading each chunk twice, one query block
//    per group) reached 0.20 of its f32 floor, the forward's 0.19.
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

template <> struct Vec4<__half> {
  static __device__ __forceinline__ float4 load(const __half* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
    const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ void store(__half* p, float4 v) {
    __half2 a = __floats2half2_rn(v.x, v.y);
    __half2 b = __floats2half2_rn(v.z, v.w);
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

// Thread geometry of every kernel: G groups of BLK rows (query rows for the
// forward and dQ, key rows for dK/dV), 8 threads per row pair: thread (r, c)
// of a group owns rows r and r + BLK / 2 and float4 chunks c, c + 8, ... of
// each (Dh / 32 of them). A staged row's chunks, read once from shared
// memory, then serve both rows' dot products and both rows' updates from
// registers: a quarter of the shared-memory reads per FMA of 4 threads to a
// row (the first forms of the forward and dK/dV, which read each chunk
// twice, sat at 0.19 and 0.28 of the f32 peak).
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

// A kernel's shared memory, per row group: a ring of ST stages of two
// stored (T) tiles of one block (forward, dQ: K and V; dK/dV: Q and dO) and, for
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

// The forward's shared memory, per row group: a ring of 2 stages of K and V
// as stored (16-bit K with its 16-byte chunks XOR-swizzled by row), the f32
// V tile (16-bit inputs; the f32 forward reads its ring stage), the p tile
// [BLK][PS] and, for the tensor-core forward, per-row values: [2][BLK] row
// maxima or sums of the two warps of an m-tile, [BLK] corrections (then the
// final m), [BLK] spare. Two stages leave the 16-bit forward at 102 KB at
// block 16 and Dh 128, so two blocks share an SM.
template <typename T, int Dh, int BLK>
struct FwdShape {
  using Ring = PairShape<T, Dh, BLK, false>;
  static constexpr bool kTc = sizeof(T) == 2;        // q.k^T on the tensor cores
  static constexpr int ST = 2;
  static constexpr int PS = BLK + 4;                 // p tile row stride (floats)
  static constexpr size_t kRing = ST * Ring::kStage;
  static constexpr size_t kTiles = kTc ? (size_t)BLK * Dh * sizeof(float) : 0;
  static constexpr size_t kStats = kTc ? 4 * BLK * sizeof(float) : 0;
  static constexpr size_t kGroup =
      kRing + kTiles + (size_t)BLK * PS * sizeof(float) + kStats;
  static constexpr size_t bytes() { return (kRowsPerBlock / BLK) * kGroup; }
  // f32 floats of one partial: acc [BLK][Dh], then m [BLK], l [BLK]
  static constexpr size_t kSlot = (size_t)BLK * (Dh + 2);
};

// The f32 forward, on the CUDA cores (TF32 would round q and k). One work
// item per row group: item (h * nb + qi, first entry, count, slot) walks
// entries first..first+count-1 of query block qi's row of the table, for
// batch row blockIdx.y. Each thread owns query rows r and r + BLK / 2 (q
// scaled, acc in registers) and stages the entries' K and V.
template <typename T, int Dh, int BLK>
__global__ void __launch_bounds__(kThreads)
block_sparse_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                        float* __restrict__ part, const int* __restrict__ lut,
                        const int4* __restrict__ items, int n_items, int n_slots, int h_count,
                        int t, int lut_width, int causal, float scale) {
  using Ge = PairGeo<Dh, BLK>;
  using Sh = FwdShape<T, Dh, BLK>;
  using Ring = typename Sh::Ring;
  static_assert(sizeof(T) == 4, "16-bit inputs take block_sparse_fwd_tc");
  constexpr int ST = Sh::ST, NC = Ge::NC, PS = Sh::PS;
  extern __shared__ __align__(16) float smem[];
  // the merge (a programmatic dependent launch) may be scheduled now: it
  // waits for this grid to end before it reads
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const Ge geo;
  const int it = blockIdx.x * Ge::G + geo.g;
  if (it >= n_items) return;  // a whole group leaves: no barrier of others waits
  const int4 item = items[it];
  const int nb = t / BLK;
  const int h = item.x / nb, qi = item.x - h * nb;
  const int b = blockIdx.y, bh = b * h_count + h;
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem) + geo.g * Sh::kGroup;
  float* p_sh = reinterpret_cast<float*>(ring + Sh::kRing);
  const size_t base = (size_t)bh * t * Dh;
  // query rows qi * BLK + r + m * HALF, m = 0, 1
  int row[2];
  float4 qr[2][NC], acc[2][NC];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    row[m] = qi * BLK + geo.r + m * Ge::HALF;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      qr[m][i] = scale4(Vec4<T>::load(q + base + (size_t)row[m] * Dh + geo.col(i)), scale);
      acc[m][i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  // lane c's scores, p and running state belong to row `mine` (c % 2) of
  // its pair: m_run is that row's running max, l_run this lane's share of
  // its sum (the lanes c, c ^ 2, c ^ 4, c ^ 6 hold the rest)
  const int c = geo.c, mine = c & 1, my_row = mine ? row[1] : row[0];
  float m_run = kMInit, l_run = 0.f;
  float* p_row = p_sh + (geo.r + mine * Ge::HALF) * PS + (c >> 1);
  const float* p_r0 = p_sh + geo.r * PS;
  const float* p_r1 = p_sh + (geo.r + Ge::HALF) * PS;
  const int* my_lut = lut + ((size_t)h * nb + qi) * lut_width + item.y;
  const int n = item.z;
  // entry jj's K and V rows into stage jj % ST
  auto issue = [&](int jj) {
    unsigned char* st = ring + (jj % ST) * Ring::kStage;
    const size_t row0 = (size_t)my_lut[jj] * BLK;
    const unsigned char* ks = reinterpret_cast<const unsigned char*>(k + base + row0 * Dh);
    const unsigned char* vs = reinterpret_cast<const unsigned char*>(v + base + row0 * Dh);
    for (int i = geo.gt; i < (int)(Ring::kRaw / 16); i += Ge::GT) {
      cp_async16(st + 16 * i, ks + 16 * i);
      cp_async16(st + Ring::kRaw + 16 * i, vs + 16 * i);
    }
  };
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < n) issue(s);
    cp_async_commit();
  }
  for (int jj = 0; jj < n; ++jj) {
    cp_async_wait<ST - 2>();
    geo.sync();  // entry jj landed; the p tile and stage jj - 1 are free
    if (jj + ST - 1 < n) issue(jj + ST - 1);
    cp_async_commit();
    const unsigned char* st = ring + (jj % ST) * Ring::kStage;
    const float* kt = reinterpret_cast<const float*>(st);
    const float* vt = reinterpret_cast<const float*>(st + Ring::kRaw);
    const int k0 = my_lut[jj] * BLK;
    // scores, four keys a step: the 8 partial dot products (key u, row m)
    // reduce-scattered over the row pair's 8 lanes as in the backward
    // kernels, lane c ends with key c >> 1's score for row c & 1
    float sc[BLK / 4];
#pragma unroll
    for (int s4 = 0; s4 < BLK / 4; ++s4) {
      float pd[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u) pd[u][0] = pd[u][1] = 0.f;
#pragma unroll
      for (int i = 0; i < NC; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 kv = *reinterpret_cast<const float4*>(kt + (4 * s4 + u) * Dh + geo.col(i));
          pd[u][0] = dot4(qr[0][i], kv, pd[u][0]);
          pd[u][1] = dot4(qr[1][i], kv, pd[u][1]);
        }
      const float v8[8] = {pd[0][0], pd[0][1], pd[1][0], pd[1][1],
                           pd[2][0], pd[2][1], pd[3][0], pd[3][1]};
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
      float sv = ((c & 1) ? w2[1] : w2[0]) +
                 __shfl_xor_sync(0xffffffffu, (c & 1) ? w2[0] : w2[1], 1);
      if (causal && k0 + 4 * s4 + (c >> 1) > my_row) sv = kMInit;
      sc[s4] = sv;
    }
    // the row's tile max over the 4 lanes of its parity, then one exp per
    // score (the clamp keeps masked and far-below-max scores off exp's
    // out-of-range path: below -127 the f32 result is 0 either way)
    float mx = sc[0];
#pragma unroll
    for (int s4 = 1; s4 < BLK / 4; ++s4) mx = fmaxf(mx, sc[s4]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    const float m_new = fmaxf(m_run, mx);
    const float corr = expf(fmaxf(m_run - m_new, -127.f));
    l_run *= corr;
    m_run = m_new;
#pragma unroll
    for (int s4 = 0; s4 < BLK / 4; ++s4) {
      const float p = sc[s4] > kMaskedBelow ? expf(fmaxf(sc[s4] - m_new, -127.f)) : 0.f;
      l_run += p;
      p_row[4 * s4] = p;
    }
    const float corr_o = __shfl_xor_sync(0xffffffffu, corr, 1);  // the pair's other row
    const float c0 = mine ? corr_o : corr, c1 = mine ? corr : corr_o;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      acc[0][i] = scale4(acc[0][i], c0);
      acc[1][i] = scale4(acc[1][i], c1);
    }
    __syncwarp();  // the row pair's p (its 8 lanes are one warp's)
    // acc += p . V, four keys a step
#pragma unroll
    for (int j4 = 0; j4 < BLK; j4 += 4) {
      const float4 pa = *reinterpret_cast<const float4*>(p_r0 + j4);
      const float4 pb = *reinterpret_cast<const float4*>(p_r1 + j4);
      const float p0[4] = {pa.x, pa.y, pa.z, pa.w}, p1[4] = {pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const float4 vv = *reinterpret_cast<const float4*>(vt + (j4 + u) * Dh + geo.col(i));
          axpy4(p0[u], vv, acc[0][i]);
          axpy4(p1[u], vv, acc[1][i]);
        }
    }
  }
  // the row's sum over its 4 lanes; both rows' l in every lane
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 4);
  const float l_o = __shfl_xor_sync(0xffffffffu, l_run, 1);
  const float lr[2] = {mine ? l_o : l_run, mine ? l_run : l_o};
  if (item.w < 0) {  // the whole row: out and lse themselves
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float ls = fmaxf(lr[m], 1e-20f);
      const bool ok = lr[m] > 0.f;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const float4 a = acc[m][i];
        const float4 out = ok ? make_float4(a.x / ls, a.y / ls, a.z / ls, a.w / ls)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        Vec4<T>::store(o + base + (size_t)row[m] * Dh + geo.col(i), out);
      }
    }
    if (c < 2) lse[(size_t)bh * t + my_row] = m_run + logf(fmaxf(l_run, 1e-20f));
  } else {           // one part: acc, m and l in its f32 slot
    float* pa = part + (size_t)(b * n_slots + item.w) * Sh::kSlot;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      float* pr = pa + (geo.r + m * Ge::HALF) * Dh;
#pragma unroll
      for (int i = 0; i < NC; ++i) *reinterpret_cast<float4*>(pr + geo.col(i)) = acc[m][i];
    }
    if (c < 2) {  // lane c < 2 holds row c's m and l
      pa[BLK * Dh + geo.r + c * Ge::HALF] = m_run;
      pa[BLK * Dh + BLK + geo.r + c * Ge::HALF] = l_run;
    }
  }
}

// The 16-bit forward, with q.k^T on the tensor cores: S = q . k^T by
// mma.sync m16n8k16 (the stored q and k, exact in 16 bits, f32
// accumulation), then scaled in f32 (the scale rounds once on the score
// where the reference rounds it on q); p, its sums and p.V in f32 on the
// CUDA cores, as the f32 kernel's. Two blocks an SM (128 registers).
// Each of a group's BLK / 8 warps takes one 16-row m-tile and BLK / 16
// 8-key n-tiles of the BLK x BLK scores (the two warps of an m-tile
// exchange their row maxima and sums in shared memory). K is staged with its
// 16-byte chunks XOR-swizzled by row (chunk c of key row r at c ^ (r & 7)),
// so the B fragments' 32-bit loads hit 32 banks.
template <typename T, int Dh, int BLK>
__global__ void __launch_bounds__(kThreads, 2)
block_sparse_fwd_tc(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ o, float* __restrict__ lse, float* __restrict__ part,
                    const int* __restrict__ lut, const int4* __restrict__ items, int n_items,
                    int n_slots, int h_count, int t, int lut_width, int causal, float scale) {
  using Ge = PairGeo<Dh, BLK>;
  using Sh = FwdShape<T, Dh, BLK>;
  using Ring = typename Sh::Ring;
  constexpr int ST = Sh::ST, NC = Ge::NC, PS = Sh::PS;
  constexpr int NTG = BLK / 8;     // n-tiles (and warps) of a group
  constexpr int TPW = BLK / 16;    // n-tiles per warp
  constexpr int KS = Dh / 16;      // k-steps
  constexpr int CH = Dh / 8;       // 16-byte chunks of a row
  extern __shared__ __align__(16) float smem[];
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const Ge geo;
  const int it = blockIdx.x * Ge::G + geo.g;
  if (it >= n_items) return;  // a whole group leaves: no barrier of others waits
  const int4 item = items[it];
  const int nb = t / BLK;
  const int h = item.x / nb, qi = item.x - h * nb;
  const int b = blockIdx.y, bh = b * h_count + h;
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem) + geo.g * Sh::kGroup;
  float* v_sh = reinterpret_cast<float*>(ring + Sh::kRing);
  float* p_sh = reinterpret_cast<float*>(ring + Sh::kRing + Sh::kTiles);
  float* stat = p_sh + BLK * PS;   // [2][BLK] per-warp row values, [BLK] corr, [BLK] spare
  float* corr_sh = stat + 2 * BLK;
  const size_t base = (size_t)bh * t * Dh;
  // the mma role: warp wg of the group, m-tile mt, n-tiles nt0.. nt0 + TPW - 1
  const int wg = geo.gt >> 5, lane = geo.gt & 31, g = lane >> 2, tq = lane & 3;
  const int mt = wg >> 1, half = wg & 1, nt0 = half * TPW;
  const int ra = mt * 16 + g, rb = ra + 8;          // rows of the block
  uint32_t af[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const T* qa = q + base + (size_t)(qi * BLK + ra) * Dh + 16 * kk + 2 * tq;
    const T* qb = qa + 8 * Dh;
    af[kk][0] = *reinterpret_cast<const uint32_t*>(qa);
    af[kk][1] = *reinterpret_cast<const uint32_t*>(qb);
    af[kk][2] = *reinterpret_cast<const uint32_t*>(qa + 8);
    af[kk][3] = *reinterpret_cast<const uint32_t*>(qb + 8);
  }
  float m_a = kMInit, m_b = kMInit, l_a = 0.f, l_b = 0.f;
  // the p.V role: rows r and r + HALF
  int row[2];
  float4 acc[2][NC];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    row[m] = qi * BLK + geo.r + m * Ge::HALF;
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[m][i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float* p_r0 = p_sh + geo.r * PS;
  const float* p_r1 = p_sh + (geo.r + Ge::HALF) * PS;
  const int* my_lut = lut + ((size_t)h * nb + qi) * lut_width + item.y;
  const int n = item.z;
  auto issue = [&](int jj) {
    unsigned char* st = ring + (jj % ST) * Ring::kStage;
    const size_t row0 = (size_t)my_lut[jj] * BLK;
    const unsigned char* ks = reinterpret_cast<const unsigned char*>(k + base + row0 * Dh);
    const unsigned char* vs = reinterpret_cast<const unsigned char*>(v + base + row0 * Dh);
    for (int i = geo.gt; i < (int)(Ring::kRaw / 16); i += Ge::GT) {
      const int r = i / CH, c = i % CH;
      cp_async16(st + 16 * (r * CH + (c ^ (r & 7))), ks + 16 * i);
      cp_async16(st + Ring::kRaw + 16 * i, vs + 16 * i);
    }
  };
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < n) issue(s);
    cp_async_commit();
  }
  for (int jj = 0; jj < n; ++jj) {
    cp_async_wait<ST - 2>();
    geo.sync();  // entry jj landed; the V, p and row tiles and stage jj - 1 are free
    if (jj + ST - 1 < n) issue(jj + ST - 1);
    cp_async_commit();
    const unsigned char* st = ring + (jj % ST) * Ring::kStage;
    to_f32_tile<T, Dh, BLK>(v_sh, reinterpret_cast<const T*>(st + Ring::kRaw), geo.gt, 1.f);
    const int k0 = my_lut[jj] * BLK;
    // S = q . k^T for this warp's n-tiles
    float cf[TPW][4];
#pragma unroll
    for (int j = 0; j < TPW; ++j) cf[j][0] = cf[j][1] = cf[j][2] = cf[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int j = 0; j < TPW; ++j) {
        const int kr = (nt0 + j) * 8 + g;   // key row of the tile
        const unsigned char* kb = st + kr * (Dh * 2) + 4 * tq;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kb + 16 * ((2 * kk) ^ (kr & 7)));
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kb + 16 * ((2 * kk + 1) ^ (kr & 7)));
        mma_m16n8k16<T>(cf[j], af[kk], b0, b1);
      }
    // scale and mask; the row maxima over this warp's keys
    float mxa = kMInit, mxb = kMInit;
#pragma unroll
    for (int j = 0; j < TPW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + (nt0 + j) * 8 + 2 * tq + (e & 1);
        const int qrow = qi * BLK + (e < 2 ? ra : rb);
        float sv = cf[j][e] * scale;
        if (causal && key > qrow) sv = kMInit;
        cf[j][e] = sv;
        if (e < 2) mxa = fmaxf(mxa, sv); else mxb = fmaxf(mxb, sv);
      }
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, o2));
      mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, o2));
    }
    if (tq == 0) {
      stat[half * BLK + ra] = mxa;
      stat[half * BLK + rb] = mxb;
    }
    geo.sync();  // both warps' maxima of each m-tile row (and the V tile)
    const float na = fmaxf(m_a, fmaxf(stat[ra], stat[BLK + ra]));
    const float nbm = fmaxf(m_b, fmaxf(stat[rb], stat[BLK + rb]));
    const float ca = expf(fmaxf(m_a - na, -127.f)), cb = expf(fmaxf(m_b - nbm, -127.f));
    l_a *= ca;
    l_b *= cb;
    m_a = na;
    m_b = nbm;
#pragma unroll
    for (int j = 0; j < TPW; ++j) {
      float pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mref = e < 2 ? na : nbm;
        pv[e] = cf[j][e] > kMaskedBelow ? expf(fmaxf(cf[j][e] - mref, -127.f)) : 0.f;
      }
      l_a += pv[0] + pv[1];
      l_b += pv[2] + pv[3];
      const int col = (nt0 + j) * 8 + 2 * tq;
      *reinterpret_cast<float2*>(p_sh + ra * PS + col) = make_float2(pv[0], pv[1]);
      *reinterpret_cast<float2*>(p_sh + rb * PS + col) = make_float2(pv[2], pv[3]);
    }
    if (half == 0 && tq == 0) {
      corr_sh[ra] = ca;
      corr_sh[rb] = cb;
    }
    geo.sync();  // p and corr of every row of the group
    const float c0 = corr_sh[geo.r], c1 = corr_sh[geo.r + Ge::HALF];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      acc[0][i] = scale4(acc[0][i], c0);
      acc[1][i] = scale4(acc[1][i], c1);
    }
#pragma unroll
    for (int j4 = 0; j4 < BLK; j4 += 4) {
      const float4 pa = *reinterpret_cast<const float4*>(p_r0 + j4);
      const float4 pb = *reinterpret_cast<const float4*>(p_r1 + j4);
      const float p0[4] = {pa.x, pa.y, pa.z, pa.w}, p1[4] = {pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const float4 vv = *reinterpret_cast<const float4*>(v_sh + (j4 + u) * Dh + geo.col(i));
          axpy4(p0[u], vv, acc[0][i]);
          axpy4(p1[u], vv, acc[1][i]);
        }
    }
  }
  // each row's l: over the 4 lanes of its quad, then the m-tile's 2 warps
#pragma unroll
  for (int o2 = 1; o2 <= 2; o2 <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o2);
  }
  geo.sync();  // the last tile's readers of the row tiles are done
  if (tq == 0) {
    stat[half * BLK + ra] = l_a;
    stat[half * BLK + rb] = l_b;
    if (half == 0) {
      corr_sh[ra] = m_a;
      corr_sh[rb] = m_b;
    }
  }
  geo.sync();
  float mr[2], lr[2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int r = geo.r + m * Ge::HALF;
    mr[m] = corr_sh[r];
    lr[m] = stat[r] + stat[BLK + r];
  }
  const int c = geo.c;
  if (item.w < 0) {  // the whole row: out and lse themselves
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float ls = fmaxf(lr[m], 1e-20f);
      const bool ok = lr[m] > 0.f;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const float4 a = acc[m][i];
        const float4 out = ok ? make_float4(a.x / ls, a.y / ls, a.z / ls, a.w / ls)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        Vec4<T>::store(o + base + (size_t)row[m] * Dh + geo.col(i), out);
      }
    }
    if (c < 2)
      lse[(size_t)bh * t + (c ? row[1] : row[0])] =
          (c ? mr[1] : mr[0]) + logf(fmaxf(c ? lr[1] : lr[0], 1e-20f));
  } else {           // one part: acc, m and l in its f32 slot
    float* pa = part + (size_t)(b * n_slots + item.w) * Sh::kSlot;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      float* pr = pa + (geo.r + m * Ge::HALF) * Dh;
#pragma unroll
      for (int i = 0; i < NC; ++i) *reinterpret_cast<float4*>(pr + geo.col(i)) = acc[m][i];
    }
    if (c < 2) {
      pa[BLK * Dh + geo.r + c * Ge::HALF] = c ? mr[1] : mr[0];
      pa[BLK * Dh + BLK + geo.r + c * Ge::HALF] = c ? lr[1] : lr[0];
    }
  }
}

// The rows cut in parts: merge entry (h * nb + qi, first slot, parts, 0)
// combines its parts' (acc, m, l) in part order and rounds out once. A
// programmatic dependent of the forward: griddepcontrol.wait holds it until
// the forward has finished and its partials are visible.
template <typename T, int Dh, int BLK>
__global__ void __launch_bounds__(kThreads)
block_sparse_fwd_merge(const float* __restrict__ part, const int4* __restrict__ merge,
                       T* __restrict__ o, float* __restrict__ lse, int n_slots, int h_count,
                       int t) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  constexpr size_t kSlot = FwdShape<T, Dh, BLK>::kSlot;
  const int4 mg = merge[blockIdx.x];
  const int nb = t / BLK, h = mg.x / nb, qi = mg.x - h * nb, b = blockIdx.y;
  const size_t row0 = (size_t)(b * h_count + h) * t + (size_t)qi * BLK;
  const float* p0 = part + (size_t)(b * n_slots + mg.y) * kSlot;
  for (int i = threadIdx.x; i < BLK * Dh / 4; i += kThreads) {
    const int r = i / (Dh / 4), col = 4 * (i % (Dh / 4));
    float mm = kMInit;
    for (int j = 0; j < mg.z; ++j) mm = fmaxf(mm, p0[j * kSlot + BLK * Dh + r]);
    float ll = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < mg.z; ++j) {
      const float* pj = p0 + j * kSlot;
      const float w = expf(pj[BLK * Dh + r] - mm);
      ll = fmaf(w, pj[BLK * Dh + BLK + r], ll);
      axpy4(w, *reinterpret_cast<const float4*>(pj + r * Dh + col), a);
    }
    const float ls = fmaxf(ll, 1e-20f);
    const float4 out = ll > 0.f ? make_float4(a.x / ls, a.y / ls, a.z / ls, a.w / ls)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
    Vec4<T>::store(o + (row0 + r) * Dh + col, out);
    if (col == 0) lse[row0 + r] = mm + logf(ls);
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
  const int* lut;
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
  constexpr int G = PairGeo<Dh, BLK>::G;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const dim3 work((a.n_items + G - 1) / G, a.bh / a.h);
  cudaError_t err;
  if (which == kFwd) {
    using Sh = FwdShape<T, Dh, BLK>;
    // 16-bit inputs: q.k^T on the tensor cores; f32: the CUDA cores
    const auto kern = [] {
      if constexpr (Sh::kTc)
        return block_sparse_fwd_tc<T, Dh, BLK>;
      else
        return block_sparse_fwd_kernel<T, Dh, BLK>;
    }();
    static size_t allowed = 48 * 1024;
    if ((err = allow_smem(kern, Sh::bytes(), allowed)) != cudaSuccess) return err;
    kern<<<work, kThreads, Sh::bytes(), a.st>>>(
        q, k, v, static_cast<T*>(a.o), a.lse, a.part, a.lut, a.items, a.n_items, a.n_slots,
        a.h, a.t, a.lut_width, a.causal, a.scale);
    if ((err = cudaGetLastError()) != cudaSuccess || a.n_merge == 0) return err;
    // the merge as a programmatic dependent launch: its blocks are scheduled
    // while the forward's last blocks run, hiding the second launch
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(a.n_merge, a.bh / a.h);
    cfg.blockDim = dim3(kThreads);
    cfg.stream = a.st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, block_sparse_fwd_merge<T, Dh, BLK>,
                              static_cast<const float*>(a.part), a.merge, static_cast<T*>(a.o),
                              a.lse, a.n_slots, a.h, a.t);
  } else if (which == kDq) {
    using Sh = PairShape<T, Dh, BLK, false>;
    auto kern = block_sparse_dq_kernel<T, Dh, BLK>;
    static size_t allowed = 48 * 1024;
    if ((err = allow_smem(kern, Sh::bytes(), allowed)) != cudaSuccess) return err;
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
  if (dtype == kF16) return by_dh<__half>(which, dh, block, a);
  if (dtype == kBF16) return by_dh<__nv_bfloat16>(which, dh, block, a);
  return cudaErrorInvalidValue;
}

// Every kernel's work list (block_sparse.py work_list): items int32
// [n_items, 4], merge int32 [n_merge, 4], and part f32 scratch for the
// partials (null when n_slots is 0).
bool bad_work(int n_items, int n_merge, int n_slots, const void* part, int bh, int h) {
  return n_items <= 0 || n_merge < 0 || n_slots < 0 || (n_slots > 0 && !part) ||
         (n_merge > 0 && n_slots == 0) || (bh > 0 && h > 0 && bh / h > 65535);
}

Args make_args(const void* q, const void* k, const void* v, const void* lut, const void* items,
               const void* merge, void* part, int n_items, int n_merge, int n_slots, int bh,
               int h, int t, int lut_width, int causal, float scale, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v;
  a.lut = static_cast<const int*>(lut);
  a.items = static_cast<const int4*>(items);
  a.merge = static_cast<const int4*>(merge);
  a.part = static_cast<float*>(part);
  a.n_items = n_items; a.n_merge = n_merge; a.n_slots = n_slots;
  a.bh = bh; a.h = h; a.t = t; a.lut_width = lut_width; a.causal = causal;
  a.scale = scale; a.st = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// q, k, v, o [BH, T, Dh]; lse f32 [BH, T]; lut int32 [H, T/block, lut_width]
// (active key blocks of each query block, ascending, -1 padded); the work
// list over its rows (dQ's); part [BH / H, n_slots, block * (Dh + 2)].
extern "C" int dst_block_sparse_fwd(const void* q, const void* k, const void* v, void* o,
                                    void* lse, const void* lut, const void* items,
                                    const void* merge, void* part, int n_items, int n_merge,
                                    int n_slots, int bh, int h, int t, int dh, int block,
                                    int lut_width, int causal, float scale, int dtype,
                                    void* stream) {
  if (bad_work(n_items, n_merge, n_slots, part, bh, h)) return cudaErrorInvalidValue;
  Args a = make_args(q, k, v, lut, items, merge, part, n_items, n_merge, n_slots, bh, h, t,
                     lut_width, causal, scale, stream);
  a.o = o;
  a.lse = static_cast<float*>(lse);
  return dispatch(kFwd, dh, block, dtype, a);
}

// dout [BH, T, Dh]; lse, delta f32 [BH, T]; dq [BH, T, Dh]; lut as the
// forward's; the work list over its rows; part [BH / H, n_slots, block, Dh].
extern "C" int dst_block_sparse_bwd_dq(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse,
                                       const void* delta, void* dq, const void* lut,
                                       const void* items, const void* merge, void* part,
                                       int n_items, int n_merge, int n_slots, int bh, int h,
                                       int t, int dh, int block, int lut_width, int causal,
                                       float scale, int dtype, void* stream) {
  if (bad_work(n_items, n_merge, n_slots, part, bh, h)) return cudaErrorInvalidValue;
  Args a = make_args(q, k, v, lut, items, merge, part, n_items, n_merge, n_slots, bh, h, t,
                     lut_width, causal, scale, stream);
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
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
  Args a = make_args(q, k, v, lut_t, items, merge, part, n_items, n_merge, n_slots, bh, h, t,
                     lut_width, causal, scale, stream);
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = dk;
  a.dv = dv;
  return dispatch(kDkv, dh, block, dtype, a);
}

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
//    query blocks at block 16, one at 64), 4 threads per row, each owning
//    Dh / 4 columns in float4 chunks (thread c of a row takes chunks c,
//    c + 4, ...: the row's 4 threads read 64 contiguous bytes of a shared
//    tile, conflict-free, and dot products are reduced by two shuffles).
//  * Each group walks only its own row of the table, count[h, block]
//    entries, not the padded width: the loop inside the group takes the
//    place of the TPU grid's last axis. The group stages one K and V (or
//    Q and dO) tile at a time in shared memory, converted to f32, and syncs
//    on its own named barrier, so groups with rows of different lengths
//    never wait on each other. Global rows (BigBird, Longformer) still make
//    their block the slowest: the split of long rows is left for later.
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
//  * No atomics: every output element is summed by one thread in a fixed
//    order, so out, lse, dQ, dK and dV repeat bit for bit.
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
  // the group's barrier: named barrier 1 + g (the whole block when G == 1)
  __device__ __forceinline__ void sync() const {
    if (G == 1) {
      __syncthreads();
    } else {
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + g), "r"(GT) : "memory");
    }
  }
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

template <int Dh, int BLK>
struct Smem {
  using Ge = Geo<Dh, BLK>;
  // fwd / dq: K and V tiles (+ the forward's score tile)
  static constexpr size_t fwd() {
    return (size_t)Ge::G * (2 * Ge::TILE + BLK * Ge::SC) * sizeof(float);
  }
  static constexpr size_t dq() { return (size_t)Ge::G * 2 * Ge::TILE * sizeof(float); }
  // dkv: Q and dO tiles, lse and delta of their rows
  static constexpr size_t dkv() {
    return (size_t)Ge::G * (2 * Ge::TILE + 2 * BLK) * sizeof(float);
  }
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

template <typename T, int Dh, int BLK>
__global__ void __launch_bounds__(kThreads)
block_sparse_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       T* __restrict__ dq, const int* __restrict__ lut,
                       const int* __restrict__ cnt, int h_count, int t,
                       int lut_width, int causal, float scale) {
  using Ge = Geo<Dh, BLK>;
  extern __shared__ __align__(16) float smem[];
  const Ge geo;
  const int nb = t / BLK;
  const int qi = blockIdx.x * Ge::G + geo.g;
  if (qi >= nb) return;
  const int bh = blockIdx.y, h = bh % h_count;
  float* k_sh = smem + geo.g * 2 * Ge::TILE;
  float* v_sh = k_sh + Ge::TILE;
  const int row = qi * BLK + geo.r;
  const size_t base = (size_t)bh * t * Dh;
  float4 qr[Ge::NC], dor[Ge::NC], acc[Ge::NC];
#pragma unroll
  for (int i = 0; i < Ge::NC; ++i) {
    const size_t at = base + (size_t)row * Dh + geo.col(i);
    qr[i] = scale4(Vec4<T>::load(q + at), scale);
    dor[i] = Vec4<T>::load(dout + at);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float lr = lse[(size_t)bh * t + row];
  const float dl = delta[(size_t)bh * t + row];
  const int* my_lut = lut + ((size_t)h * nb + qi) * lut_width;
  const int n = cnt[h * nb + qi];
  for (int jj = 0; jj < n; ++jj) {
    const int kj = my_lut[jj];
    geo.sync();
    stage<T, Dh, BLK>(k_sh, k + base, kj * BLK, geo.gt, 1.f);
    stage<T, Dh, BLK>(v_sh, v + base, kj * BLK, geo.gt, 1.f);
    geo.sync();
    for (int j = 0; j < BLK; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < Ge::NC; ++i) {
        s = dot4(qr[i], *reinterpret_cast<const float4*>(k_sh + j * Dh + geo.col(i)), s);
        dp = dot4(dor[i], *reinterpret_cast<const float4*>(v_sh + j * Dh + geo.col(i)), dp);
      }
      s = quad_sum(s);
      dp = quad_sum(dp);
      if (causal && kj * BLK + j > row) s = kMInit;
      const float p = s > kMaskedBelow ? expf(s - lr) : 0.f;
      const float ds = p * (dp - dl);
#pragma unroll
      for (int i = 0; i < Ge::NC; ++i)
        axpy4(ds, *reinterpret_cast<const float4*>(k_sh + j * Dh + geo.col(i)), acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < Ge::NC; ++i)
    Vec4<T>::store(dq + base + (size_t)row * Dh + geo.col(i), scale4(acc[i], scale));
}

template <typename T, int Dh, int BLK>
__global__ void __launch_bounds__(kThreads)
block_sparse_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dk, T* __restrict__ dv,
                        const int* __restrict__ lut_t, const int* __restrict__ cnt_t,
                        int h_count, int t, int lut_width, int causal, float scale) {
  using Ge = Geo<Dh, BLK>;
  extern __shared__ __align__(16) float smem[];
  const Ge geo;
  const int nb = t / BLK;
  const int kj = blockIdx.x * Ge::G + geo.g;
  if (kj >= nb) return;
  const int bh = blockIdx.y, h = bh % h_count;
  float* q_sh = smem + geo.g * (2 * Ge::TILE + 2 * BLK);
  float* do_sh = q_sh + Ge::TILE;
  float* lse_sh = do_sh + Ge::TILE;
  float* dl_sh = lse_sh + BLK;
  const int key = kj * BLK + geo.r;
  const size_t base = (size_t)bh * t * Dh;
  float4 kr[Ge::NC], vr[Ge::NC], dka[Ge::NC], dva[Ge::NC];
#pragma unroll
  for (int i = 0; i < Ge::NC; ++i) {
    const size_t at = base + (size_t)key * Dh + geo.col(i);
    kr[i] = Vec4<T>::load(k + at);
    vr[i] = Vec4<T>::load(v + at);
    dka[i] = dva[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int* my_lut = lut_t + ((size_t)h * nb + kj) * lut_width;
  const int n = cnt_t[h * nb + kj];
  for (int jj = 0; jj < n; ++jj) {
    const int qi = my_lut[jj];
    geo.sync();
    stage<T, Dh, BLK>(q_sh, q + base, qi * BLK, geo.gt, scale);   // scaled q
    stage<T, Dh, BLK>(do_sh, dout + base, qi * BLK, geo.gt, 1.f);
    if (geo.gt < BLK) {
      lse_sh[geo.gt] = lse[(size_t)bh * t + qi * BLK + geo.gt];
      dl_sh[geo.gt] = delta[(size_t)bh * t + qi * BLK + geo.gt];
    }
    geo.sync();
    for (int j = 0; j < BLK; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < Ge::NC; ++i) {
        s = dot4(kr[i], *reinterpret_cast<const float4*>(q_sh + j * Dh + geo.col(i)), s);
        dp = dot4(vr[i], *reinterpret_cast<const float4*>(do_sh + j * Dh + geo.col(i)), dp);
      }
      s = quad_sum(s);
      dp = quad_sum(dp);
      if (causal && key > qi * BLK + j) s = kMInit;
      const float p = s > kMaskedBelow ? expf(s - lse_sh[j]) : 0.f;
      const float ds = p * (dp - dl_sh[j]);
#pragma unroll
      for (int i = 0; i < Ge::NC; ++i) {
        axpy4(p, *reinterpret_cast<const float4*>(do_sh + j * Dh + geo.col(i)), dva[i]);
        axpy4(ds, *reinterpret_cast<const float4*>(q_sh + j * Dh + geo.col(i)), dka[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < Ge::NC; ++i) {
    const size_t at = base + (size_t)key * Dh + geo.col(i);
    Vec4<T>::store(dk + at, dka[i]);
    Vec4<T>::store(dv + at, dva[i]);
  }
}

// ------------------------------------------------------------------ launch
struct Args {
  const void *q, *k, *v, *dout;
  void *o, *dq, *dk, *dv;
  float* lse;
  const float *lse_in, *delta;
  const int *lut, *cnt;
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
  using Sm = Smem<Dh, BLK>;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const dim3 grid((a.t / BLK + Ge::G - 1) / Ge::G, a.bh);
  cudaError_t err;
  if (which == kFwd) {
    auto kern = block_sparse_fwd_kernel<T, Dh, BLK>;
    static size_t allowed = 48 * 1024;
    if ((err = allow_smem(kern, Sm::fwd(), allowed)) != cudaSuccess) return err;
    kern<<<grid, kThreads, Sm::fwd(), a.st>>>(q, k, v, static_cast<T*>(a.o), a.lse,
                                              a.lut, a.cnt, a.h, a.t, a.lut_width,
                                              a.causal, a.scale);
  } else if (which == kDq) {
    auto kern = block_sparse_dq_kernel<T, Dh, BLK>;
    static size_t allowed = 48 * 1024;
    if ((err = allow_smem(kern, Sm::dq(), allowed)) != cudaSuccess) return err;
    kern<<<grid, kThreads, Sm::dq(), a.st>>>(
        q, k, v, static_cast<const T*>(a.dout), a.lse_in, a.delta,
        static_cast<T*>(a.dq), a.lut, a.cnt, a.h, a.t, a.lut_width, a.causal, a.scale);
  } else {
    auto kern = block_sparse_dkv_kernel<T, Dh, BLK>;
    static size_t allowed = 48 * 1024;
    if ((err = allow_smem(kern, Sm::dkv(), allowed)) != cudaSuccess) return err;
    kern<<<grid, kThreads, Sm::dkv(), a.st>>>(
        q, k, v, static_cast<const T*>(a.dout), a.lse_in, a.delta,
        static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.lut, a.cnt, a.h, a.t,
        a.lut_width, a.causal, a.scale);
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

// + dout [BH, T, Dh]; lse, delta f32 [BH, T]; dq [BH, T, Dh].
extern "C" int dst_block_sparse_bwd_dq(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse,
                                       const void* delta, void* dq, const void* lut,
                                       const void* cnt, int bh, int h, int t, int dh,
                                       int block, int lut_width, int causal,
                                       float scale, int dtype, void* stream) {
  Args a = make_args(q, k, v, lut, cnt, bh, h, t, lut_width, causal, scale, stream);
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  return dispatch(kDq, dh, block, dtype, a);
}

// dk, dv [BH, T, Dh]; lut_t int32 [H, T/block, lut_width] (active query
// blocks of each key block) and cnt_t [H, T/block].
extern "C" int dst_block_sparse_bwd_dkv(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse,
                                        const void* delta, void* dk, void* dv,
                                        const void* lut_t, const void* cnt_t, int bh,
                                        int h, int t, int dh, int block,
                                        int lut_width, int causal, float scale,
                                        int dtype, void* stream) {
  Args a = make_args(q, k, v, lut_t, cnt_t, bh, h, t, lut_width, causal, scale, stream);
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = dk;
  a.dv = dv;
  return dispatch(kDkv, dh, block, dtype, a);
}

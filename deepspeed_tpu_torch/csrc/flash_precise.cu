// FlashAttention-2 forward and backward in f32-precise mode, on flat
// [BH, T, Dh] operands stored in bf16, fp16 or f32.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/flash_attention.py under
// DSTPU_FLASH_F32_PRECISE=1 (its _mm_dtype, :64-70, keeps the computed p
// and dS operands of the second-stage products in f32):
//   * dst_flash_fwd_precise     <- _fwd_kernel     (:80, pallas_call :278)
//   * dst_flash_bwd_dq_precise  <- _bwd_dq_kernel  (:121, pallas_call :344)
//   * dst_flash_bwd_dkv_precise <- _bwd_dkv_kernel (:154, pallas_call :364)
//
// What it computes: every operand is converted to f32 when it is loaded
// (exact for bf16 and fp16), every product is an f32 FMA on the CUDA cores
// (not TF32, which would round p and dS to 10 mantissa bits), and only the
// outputs are rounded to the storage dtype (lse stays f32). So P.V, dS.K,
// P^T.dO and dS^T.Q see f32 p and dS, as the reference's precise mode, and
// the scores see the storage-dtype q, k, v and dO exactly.
//
// Bound on the H100: operations. The forward does 4 * Tq * Tk * Dh FLOP per
// head (half under the causal mask) against the f32 CUDA-core peak of
// 67 TFLOP/s; its bytes (q, k, v read once, o written once) are a few
// hundredths of that time at T 1024. The backward kernels do the same
// products plus the recomputed scores.
//
// Design: the simple structure of the f32 kernels in flash_attention.cu,
// templated on the storage type. 32 rows per block, 4 threads per row
// (thread s of a row owning columns s, s + 4, s + 8, ...: at each step the
// four read neighbouring words of a shared-memory row, four banks, where
// contiguous quarters of Dh put all four on one bank at Dh 128 and two at
// Dh 64), the other operand walked in 32-row tiles
// converted to f32 in shared memory; dot products reduced by shuffles
// within the 4 threads of a row. Causal tiles past the diagonal are never
// loaded. No atomics: each output element is summed by one thread in a
// fixed order, so results are bit-identical run to run. The 16-bit wgmma
// kernels of flash_attention.cu are untouched by this mode.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;      // 4 warps
constexpr float kMInit = -1e30f;   // the reference's _NEG_INF, the initial m

template <int Dh>
struct Tile {
  static constexpr int BM = 32, BN = 32, SPL = 4, HD = Dh / 4, S = Dh + 4;
};

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__half>(__half x) { return __half2float(x); }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// four consecutive elements (4-element aligned) as f32
template <typename T>
__device__ __forceinline__ float4 load4(const T* p);
template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <>
__device__ __forceinline__ float4 load4<__half>(const __half* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&raw.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float split_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Is (query row, key col) attended? Top-left causal alignment.
__device__ __forceinline__ bool live(int row, int col, int tq, int tk, bool causal) {
  return row < tq && col < tk && (!causal || col <= row);
}

// rows row0.. of a [n_rows, Dh] slab, converted to f32, into a [Rows][S]
// tile (zeros past n_rows)
template <typename T, int Dh, int Rows, int S>
__device__ __forceinline__ void load_rows(float* sm, const T* g, int row0, int n_rows) {
  constexpr int kVpr = Dh / 4;
  for (int i = threadIdx.x; i < Rows * kVpr; i += kThreads) {
    const int r = i / kVpr, c = (i - r * kVpr) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows) x = load4<T>(g + (size_t)(row0 + r) * Dh + c);
    *reinterpret_cast<float4*>(sm + r * S + c) = x;
  }
}

template <typename T, int Dh>
__global__ void __launch_bounds__(kThreads)
flash_fwd_precise(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ o, float* __restrict__ lse, int tq, int tk, int causal,
                  float scale) {
  using C = Tile<Dh>;
  constexpr int BN = C::BN, HD = C::HD, S = C::S;
  __shared__ __align__(16) float k_sh[BN * S];
  __shared__ __align__(16) float v_sh[BN * S];
  __shared__ float sc[BN * C::BM];      // this tile's scores, [key][row]
  const int bh = blockIdx.y, r = threadIdx.x / C::SPL, sp = threadIdx.x % C::SPL;
  const int row = blockIdx.x * C::BM + r;
  const T* kb = k + (size_t)bh * tk * Dh;
  const T* vb = v + (size_t)bh * tk * Dh;
  float qr[HD], acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = row < tq ? to_f32<T>(q[((size_t)bh * tq + row) * Dh + d * C::SPL + sp]) : 0.f;
    acc[d] = 0.f;
  }
  int n_kt = (tk + BN - 1) / BN;
  if (causal) n_kt = min(n_kt, (blockIdx.x * C::BM + C::BM - 1) / BN + 1);
  float m = kMInit, l = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_rows<T, Dh, BN, S>(k_sh, kb, kt * BN, tk);
    load_rows<T, Dh, BN, S>(v_sh, vb, kt * BN, tk);
    __syncthreads();
    float mx = -CUDART_INF_F;
    for (int j = 0; j < BN; ++j) {
      float part = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) part = fmaf(qr[d], k_sh[j * S + d * C::SPL + sp], part);
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
      const float p = expf(sc[j * C::BM + r] - m);   // f32 p into P.V
      l += p;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = fmaf(p, v_sh[j * S + d * C::SPL + sp], acc[d]);
    }
  }
  if (row < tq) {
    const float ls = fmaxf(l, 1e-20f);
    T* orow = o + ((size_t)bh * tq + row) * Dh + sp;
#pragma unroll
    for (int d = 0; d < HD; ++d) orow[d * C::SPL] = from_f32<T>(acc[d] / ls);
    if (sp == 0) lse[(size_t)bh * tq + row] = m + logf(ls);
  }
}

template <typename T, int Dh>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_precise(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq, int tq, int tk,
                     int causal, float scale) {
  using C = Tile<Dh>;
  constexpr int BN = C::BN, HD = C::HD, S = C::S;
  __shared__ __align__(16) float k_sh[BN * S];
  __shared__ __align__(16) float v_sh[BN * S];
  const int bh = blockIdx.y, r = threadIdx.x / C::SPL, sp = threadIdx.x % C::SPL;
  const int row = blockIdx.x * C::BM + r;
  const bool ok_row = row < tq;
  const size_t ro = ((size_t)bh * tq + (ok_row ? row : 0)) * Dh + sp;
  const T* kb = k + (size_t)bh * tk * Dh;
  const T* vb = v + (size_t)bh * tk * Dh;
  float qr[HD], dor[HD], acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = ok_row ? to_f32<T>(q[ro + d * C::SPL]) : 0.f;
    dor[d] = ok_row ? to_f32<T>(dout[ro + d * C::SPL]) : 0.f;
    acc[d] = 0.f;
  }
  const float lr = ok_row ? lse[(size_t)bh * tq + row] : 0.f;
  const float dl = ok_row ? delta[(size_t)bh * tq + row] : 0.f;
  int n_kt = (tk + BN - 1) / BN;
  if (causal) n_kt = min(n_kt, (blockIdx.x * C::BM + C::BM - 1) / BN + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_rows<T, Dh, BN, S>(k_sh, kb, kt * BN, tk);
    load_rows<T, Dh, BN, S>(v_sh, vb, kt * BN, tk);
    __syncthreads();
    for (int j = 0; j < BN; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        s = fmaf(qr[d], k_sh[j * S + d * C::SPL + sp], s);
        dp = fmaf(dor[d], v_sh[j * S + d * C::SPL + sp], dp);
      }
      s = split_sum(s);
      dp = split_sum(dp);
      const float p = live(row, kt * BN + j, tq, tk, causal) ? expf(s * scale - lr) : 0.f;
      const float ds = p * (dp - dl);                // f32 dS into dS.K
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = fmaf(ds, k_sh[j * S + d * C::SPL + sp], acc[d]);
    }
  }
  if (ok_row) {
#pragma unroll
    for (int d = 0; d < HD; ++d) dq[ro + d * C::SPL] = from_f32<T>(acc[d] * scale);
  }
}

template <typename T, int Dh>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_precise(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int tq, int tk, int causal,
                      float scale) {
  using C = Tile<Dh>;
  constexpr int BN = C::BN, HD = C::HD, S = C::S;
  __shared__ __align__(16) float q_sh[BN * S];
  __shared__ __align__(16) float do_sh[BN * S];
  __shared__ float lse_sh[BN], dl_sh[BN];
  const int bh = blockIdx.y, r = threadIdx.x / C::SPL, sp = threadIdx.x % C::SPL;
  const int k0 = blockIdx.x * C::BM, key = k0 + r;
  const bool ok_key = key < tk;
  const size_t ko = ((size_t)bh * tk + (ok_key ? key : 0)) * Dh + sp;
  const T* qb = q + (size_t)bh * tq * Dh;
  const T* db = dout + (size_t)bh * tq * Dh;
  float kr[HD], vr[HD], dka[HD], dva[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    kr[d] = ok_key ? to_f32<T>(k[ko + d * C::SPL]) : 0.f;
    vr[d] = ok_key ? to_f32<T>(v[ko + d * C::SPL]) : 0.f;
    dka[d] = dva[d] = 0.f;
  }
  const int n_qt = (tq + BN - 1) / BN;
  const int qt0 = causal ? min(k0 / BN, n_qt) : 0;
  for (int qt = qt0; qt < n_qt; ++qt) {
    __syncthreads();
    load_rows<T, Dh, BN, S>(q_sh, qb, qt * BN, tq);
    load_rows<T, Dh, BN, S>(do_sh, db, qt * BN, tq);
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
        s = fmaf(kr[d], q_sh[i * S + d * C::SPL + sp], s);
        dp = fmaf(vr[d], do_sh[i * S + d * C::SPL + sp], dp);
      }
      s = split_sum(s);
      dp = split_sum(dp);
      const float p = live(qt * BN + i, key, tq, tk, causal) ? expf(s * scale - lse_sh[i]) : 0.f;
      const float ds = p * (dp - dl_sh[i]);          // f32 p and dS
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        dva[d] = fmaf(p, do_sh[i * S + d * C::SPL + sp], dva[d]);
        dka[d] = fmaf(ds, q_sh[i * S + d * C::SPL + sp], dka[d]);
      }
    }
  }
  if (ok_key) {
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      dk[ko + d * C::SPL] = from_f32<T>(dka[d] * scale);
      dv[ko + d * C::SPL] = from_f32<T>(dva[d]);
    }
  }
}

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

struct Args {
  const void *q, *k, *v, *dout;
  void *o, *dq, *dk, *dv;
  float* lse;
  const float *lse_in, *delta;
  int bh, tq, tk, causal;
  float scale;
  cudaStream_t st;
};

template <typename T, int Dh>
cudaError_t launch(Which which, const Args& a) {
  using C = Tile<Dh>;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  if (which == kFwd) {
    dim3 grid((a.tq + C::BM - 1) / C::BM, a.bh);
    flash_fwd_precise<T, Dh><<<grid, kThreads, 0, a.st>>>(q, k, v, static_cast<T*>(a.o), a.lse,
                                                          a.tq, a.tk, a.causal, a.scale);
  } else if (which == kDq) {
    dim3 grid((a.tq + C::BM - 1) / C::BM, a.bh);
    flash_bwd_dq_precise<T, Dh><<<grid, kThreads, 0, a.st>>>(
        q, k, v, dout, a.lse_in, a.delta, static_cast<T*>(a.dq), a.tq, a.tk, a.causal,
        a.scale);
  } else {
    dim3 grid((a.tk + C::BM - 1) / C::BM, a.bh);
    flash_bwd_dkv_precise<T, Dh><<<grid, kThreads, 0, a.st>>>(
        q, k, v, dout, a.lse_in, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.tq,
        a.tk, a.causal, a.scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_dh(Which which, int dh, const Args& a) {
  if (dh == 64) return launch<T, 64>(which, a);
  if (dh == 128) return launch<T, 128>(which, a);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(Which which, int dh, int dtype, const Args& a) {
  if (a.bh <= 0 || a.bh > 65535 || a.tq <= 0 || a.tk <= 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case dst::kF32:
      return by_dh<float>(which, dh, a);
    case dst::kF16:
      return by_dh<__half>(which, dh, a);
    case dst::kBF16:
      return by_dh<__nv_bfloat16>(which, dh, a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// The arguments of dst_flash_fwd / _bwd_dq / _bwd_dkv (flash_attention.cu).
extern "C" int dst_flash_fwd_precise(const void* q, const void* k, const void* v, void* o,
                                     void* lse, int bh, int tq, int tk, int dh, int causal,
                                     float scale, int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.lse = static_cast<float*>(lse);
  a.bh = bh; a.tq = tq; a.tk = tk; a.causal = causal; a.scale = scale;
  a.st = static_cast<cudaStream_t>(stream);
  return dispatch(kFwd, dh, dtype, a);
}

extern "C" int dst_flash_bwd_dq_precise(const void* q, const void* k, const void* v,
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

extern "C" int dst_flash_bwd_dkv_precise(const void* q, const void* k, const void* v,
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

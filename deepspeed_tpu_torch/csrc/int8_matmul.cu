// Int8 weight-streaming matmul for decode: out[N, E] = (x[N, D] @ q[D, E]) * s[E].
//
// Replaces the TPU kernel deepspeed_tpu/ops/int8_matmul.py:_dma_kernel
// (int8_matmul_dma). Bound on the H100: bytes. At decode N <= 32 rows of x
// meet every weight byte once, so one pass over the int8 weight (D * E bytes
// at 3.35 TB/s) is the floor; the activations and the output are noise.
//
// Design:
//  * The weight is the whole layer-stacked [L, D, E] tensor; the launcher
//    offsets the pointer by `layer`, so no per-step slice copy exists.
//  * Each lane owns CPT consecutive output columns and loads them with one
//    CPT-byte vector load per weight row: a warp streams 32 * CPT contiguous
//    bytes of every row (coalesced). Each int8 value is upcast once in
//    registers (a byte permute into a float's mantissa and one subtract,
//    exact) and multiplies f32 copies of x staged in shared memory; all N
//    rows accumulate in f32 registers (NT * CPT of them, NT = N rounded up
//    to a power of two; CPT shrinks as NT grows to keep that at 128). The
//    loads of a warp's next rows are issued before it computes on the
//    current ones, so two groups of 16-byte loads per lane are in flight.
//  * Filling 132 SMs: E / (32 * CPT) column tiles alone are too few (E = 4096
//    gives 8), so D is split too: every block takes 128 weight rows, 32 per
//    warp, streamed with several 16-byte loads in flight per lane. The four
//    warps reduce in shared memory as a fixed tree ((w0 + w2) + (w1 + w3)),
//    stored lane-minor so no two lanes hit one bank; blocks write f32
//    partials that a second small kernel sums in a fixed order, scales per
//    column once, and casts once (the TPU kernel's rounding contract,
//    :187-190). No atomics: every output is bit-reproducible and a row's
//    result does not depend on the other rows of the batch.
//
// The gridded form, dst_int8_matmul_grid, replaces the TPU kernel
// deepspeed_tpu/ops/int8_matmul.py:_kernel (:44, pallas_call :284; unrouted
// in both packages, kept for comparison). Its grid walks E tiles in
// parallel and D in order (the reference's ("parallel", "arbitrary")): one
// block per 128 columns walks the whole of D with kernel 2's vector loads
// and exact upcast, accumulates in f32 registers, reduces its warps by the
// same tree, and scales and casts once. It has no D split and no partials,
// so at E = 4096 only 32 blocks stream the weight: it is expected to lose to
// kernel 2, as the gridded TPU kernel lost to the DMA one.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 128;  // weight rows per block (the D split)

template <int CPT> struct WeightVec;
template <> struct WeightVec<16> { using type = uint4; };
template <> struct WeightVec<8> { using type = uint2; };
template <> struct WeightVec<4> { using type = unsigned; };

__device__ __forceinline__ unsigned word(const uint4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}
__device__ __forceinline__ unsigned word(const uint2& v, int k) { return k == 0 ? v.x : v.y; }
__device__ __forceinline__ unsigned word(unsigned v, int) { return v; }

// Four signed bytes to floats, exactly: the biased byte becomes the low
// mantissa bits of 2^23, and 2^23 + 128 is subtracted.
__device__ __forceinline__ void int8x4_to_f32(unsigned w, float* f) {
  const unsigned u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
}

// x[0:NT, d0:d0 + rows] as f32 into xs (zeros past n and rows)
template <typename T, int NT>
__device__ __forceinline__ void stage_x(float (*xs)[kRows], const T* __restrict__ x,
                                        int n, int d, int d0, int rows) {
  for (int i = threadIdx.x; i < NT * kRows; i += kThreads) {
    const int r = i / kRows, c = i % kRows;
    xs[r][c] = (r < n && c < rows) ? dst::to_f32(x[(size_t)r * d + d0 + c]) : 0.f;
  }
}

// acc += xs[:, 0:rows] @ weight rows [0, rows) of the slab at wp (row stride
// e), CPT columns per lane; warp w takes rows w, w + 4, ...
template <int NT, int CPT>
__device__ __forceinline__ void accumulate_rows(float (*xs)[kRows],
                                                const int8_t* __restrict__ wp,
                                                int rows, int e, int warp,
                                                float (&acc)[NT][CPT]) {
  using V = typename WeightVec<CPT>::type;
  constexpr int kU = 4;            // rows per group; two groups in flight
  constexpr int kStep = kWarps * kU;
  V cur[kU], nxt[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int r = warp + u * kWarps;
    if (r < rows) cur[u] = *reinterpret_cast<const V*>(wp + (size_t)r * e);
  }
  for (int c = warp; c < rows; c += kStep) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int r = c + kStep + u * kWarps;
      if (r < rows) nxt[u] = *reinterpret_cast<const V*>(wp + (size_t)r * e);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int r = c + u * kWarps;
      if (r < rows) {
        float wf[CPT];
#pragma unroll
        for (int k = 0; k < CPT / 4; ++k) int8x4_to_f32(word(cur[u], k), wf + 4 * k);
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const float xv = xs[i][r];
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(xv, wf[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) cur[u] = nxt[u];
  }
}

// Sum the 4 warps' acc as a fixed tree, (w0 + w2) + (w1 + w3), lane-minor in
// red (conflict-free); warp 0's acc then holds the block's total.
template <int NT, int CPT>
__device__ __forceinline__ void reduce_warps(float (&acc)[NT][CPT],
                                             float (*red)[NT * CPT][32], int warp,
                                             int lane) {
  if (warp >= 2) {
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) red[warp - 2][i * CPT + j][lane] = acc[i][j];
  }
  __syncthreads();
  if (warp < 2) {
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] += red[warp][i * CPT + j][lane];
  }
  __syncthreads();
  if (warp == 1) {
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) red[0][i * CPT + j][lane] = acc[i][j];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] += red[0][i * CPT + j][lane];
  }
}

template <typename T, int NT, int CPT>
__global__ void __launch_bounds__(kThreads)
int8_matmul_partial(const T* __restrict__ x, const int8_t* __restrict__ w,
                    float* __restrict__ part, int n, int d, int e) {
  constexpr int TE = 32 * CPT;       // columns per block
  __shared__ float xs[NT][kRows];
  __shared__ float red[2][NT * CPT][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * TE + lane * CPT;
  const bool col_ok = col0 < e;      // e % CPT == 0 (checked by the wrapper)
  const int d0 = blockIdx.y * kRows;
  const int rows = min(kRows, d - d0);

  stage_x<T, NT>(xs, x, n, d, d0, rows);
  __syncthreads();

  float acc[NT][CPT];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  if (col_ok) accumulate_rows<NT, CPT>(xs, w + (size_t)d0 * e + col0, rows, e, warp, acc);
  reduce_warps<NT, CPT>(acc, red, warp, lane);
  if (warp == 0 && col_ok) {
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      if (i < n) {
        float* dst = part + ((size_t)blockIdx.y * n + i) * e + col0;
#pragma unroll
        for (int j = 0; j < CPT; j += 4)
          *reinterpret_cast<float4*>(dst + j) =
              make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
      }
    }
  }
}

// The gridded form (replaces _kernel, int8_matmul.py:44): one block per
// 32 * CPT columns walks the whole of D, 128 rows of x staged at a time, and
// accumulates in f32 registers; no split along D and no partials. The
// block total is scaled per column once and cast once.
template <typename T, int NT, int CPT>
__global__ void __launch_bounds__(kThreads)
int8_matmul_grid(const T* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ s, T* __restrict__ out, int n, int d,
                 int e) {
  __shared__ float xs[NT][kRows];
  __shared__ float red[2][NT * CPT][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * 32 * CPT + lane * CPT;
  const bool col_ok = col0 < e;

  float acc[NT][CPT];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int d0 = 0; d0 < d; d0 += kRows) {
    const int rows = min(kRows, d - d0);
    __syncthreads();
    stage_x<T, NT>(xs, x, n, d, d0, rows);
    __syncthreads();
    if (col_ok) accumulate_rows<NT, CPT>(xs, w + (size_t)d0 * e + col0, rows, e, warp, acc);
  }
  reduce_warps<NT, CPT>(acc, red, warp, lane);
  if (warp == 0 && col_ok) {
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      if (i < n) {
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          out[(size_t)i * e + col0 + j] = dst::from_f32<T>(acc[i][j] * s[col0 + j]);
      }
    }
  }
}

template <typename T>
__global__ void int8_matmul_finish(const float* __restrict__ part,
                                   const float* __restrict__ s, T* __restrict__ out,
                                   int n, int e, int k_splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * e) return;
  float a = 0.f;
  for (int k = 0; k < k_splits; ++k) a += part[(size_t)k * n * e + i];
  out[i] = dst::from_f32<T>(a * s[i % e]);
}

template <typename T, int NT, int CPT>
cudaError_t launch(const T* x, const int8_t* w, const float* s, T* out,
                   float* part, int n, int d, int e, int k_splits,
                   cudaStream_t st) {
  constexpr int TE = 32 * CPT;
  if (k_splits != (d + kRows - 1) / kRows) return cudaErrorInvalidValue;
  dim3 grid((e + TE - 1) / TE, k_splits);
  int8_matmul_partial<T, NT, CPT><<<grid, kThreads, 0, st>>>(x, w, part, n, d, e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = n * e;
  int8_matmul_finish<T><<<(total + 255) / 256, 256, 0, st>>>(part, s, out, n, e, k_splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const int8_t* w, const float* s, void* out,
                     float* part, int n, int d, int e, int k_splits,
                     cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (n <= 1) return launch<T, 1, 16>(xt, w, s, ot, part, n, d, e, k_splits, st);
  if (n <= 2) return launch<T, 2, 16>(xt, w, s, ot, part, n, d, e, k_splits, st);
  if (n <= 4) return launch<T, 4, 16>(xt, w, s, ot, part, n, d, e, k_splits, st);
  if (n <= 8) return launch<T, 8, 16>(xt, w, s, ot, part, n, d, e, k_splits, st);
  if (n <= 16) return launch<T, 16, 8>(xt, w, s, ot, part, n, d, e, k_splits, st);
  if (n <= 32) return launch<T, 32, 4>(xt, w, s, ot, part, n, d, e, k_splits, st);
  return cudaErrorInvalidValue;
}

// The gridded form: 4 columns per lane (128 per block), so that E = 4096
// still gives 32 blocks; NT = n rounded up to a power of two.
template <typename T, int NT>
cudaError_t launch_grid(const T* x, const int8_t* w, const float* s, T* out, int n,
                        int d, int e, cudaStream_t st) {
  constexpr int CPT = 4;
  int8_matmul_grid<T, NT, CPT><<<(e + 32 * CPT - 1) / (32 * CPT), kThreads, 0, st>>>(
      x, w, s, out, n, d, e);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_grid(const void* x, const int8_t* w, const float* s, void* out,
                          int n, int d, int e, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (n <= 1) return launch_grid<T, 1>(xt, w, s, ot, n, d, e, st);
  if (n <= 2) return launch_grid<T, 2>(xt, w, s, ot, n, d, e, st);
  if (n <= 4) return launch_grid<T, 4>(xt, w, s, ot, n, d, e, st);
  if (n <= 8) return launch_grid<T, 8>(xt, w, s, ot, n, d, e, st);
  if (n <= 16) return launch_grid<T, 16>(xt, w, s, ot, n, d, e, st);
  if (n <= 32) return launch_grid<T, 32>(xt, w, s, ot, n, d, e, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// x [n, d] (dtype), w [L, d, e] or [d, e] int8, s [L, e] or [e] f32,
// out [n, e] (dtype), part [k_splits, n, e] f32 scratch.
extern "C" int dst_int8_matmul(const void* x, const void* w, const void* s,
                               void* out, void* part, int n, int d, int e,
                               int layer, int k_splits, int dtype, void* stream) {
  const int8_t* wl = static_cast<const int8_t*>(w) + (size_t)layer * d * e;
  const float* sl = static_cast<const float*>(s) + (size_t)layer * e;
  float* p = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case dst::kF32: return dispatch<float>(x, wl, sl, out, p, n, d, e, k_splits, st);
    case dst::kF16: return dispatch<__half>(x, wl, sl, out, p, n, d, e, k_splits, st);
    case dst::kBF16: return dispatch<__nv_bfloat16>(x, wl, sl, out, p, n, d, e, k_splits, st);
  }
  return cudaErrorInvalidValue;
}

// The gridded form: x [n, d] (dtype), w [d, e] int8, s [e] f32, out [n, e].
extern "C" int dst_int8_matmul_grid(const void* x, const void* w, const void* s,
                                    void* out, int n, int d, int e, int dtype,
                                    void* stream) {
  const int8_t* wt = static_cast<const int8_t*>(w);
  const float* st = static_cast<const float*>(s);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (n < 1 || d < 1 || e < 1 || e % 16) return cudaErrorInvalidValue;
  switch (dtype) {
    case dst::kF32: return dispatch_grid<float>(x, wt, st, out, n, d, e, cs);
    case dst::kF16: return dispatch_grid<__half>(x, wt, st, out, n, d, e, cs);
    case dst::kBF16: return dispatch_grid<__nv_bfloat16>(x, wt, st, out, n, d, e, cs);
  }
  return cudaErrorInvalidValue;
}

// The CUDA-core pieces of the int8 weight-streaming matmul for f32 x (TF32
// would round x), shared by kernel 2's f32 form (int8_matmul.cu) and the
// gridded form's (int8_matmul_grid.cu):
//  * Each lane owns CPT consecutive output columns and loads them with one
//    CPT-byte vector load per weight row: a warp streams 32 * CPT contiguous
//    bytes of every row (coalesced). Each int8 value is upcast once in
//    registers (a byte permute into a float's mantissa and one subtract,
//    exact) and multiplies f32 copies of x staged in shared memory; all N
//    rows accumulate in f32 registers (NT * CPT of them). The loads of a
//    warp's next rows are issued before it computes on the current ones, so
//    two groups of 16-byte loads per lane are in flight.
//  * The four warps of a block reduce in shared memory as a fixed tree
//    ((w0 + w2) + (w1 + w3)), stored lane-minor so no two lanes hit one bank.
#pragma once

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 128;  // weight rows per block (kernel 2's D split) or per x stage

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

}  // namespace

// The gridded int8 matmul: out[N, E] = (x[N, D] @ q[D, E]) * s[E], x in bf16,
// fp16 or f32, N <= 32.
//
// Replaces the TPU kernel deepspeed_tpu/ops/int8_matmul.py:_kernel (:44,
// pallas_call :284; unrouted in both packages, kept for comparison). Its
// grid walks E tiles in parallel and D in order (the reference's
// ("parallel", "arbitrary")): one block per column tile walks the whole of
// D, with no split along D, no cluster and no partials, and scales per
// column once and casts once. Bound on the H100: bytes, one pass over the
// int8 weight, as kernel 2's (int8_matmul.cu).
//
// bf16 / fp16 x: kernel 2's tensor-core body (int8_matmul_tc.cuh: a TMA
// ring, the exact byte permute, mma.sync with f32 accumulation) at one
// split, over column tiles narrow enough to fill the SMs: `cols` comes from
// ops/int8_matmul.py:grid_plan, a function of (D, E) only: 64 where that
// gives 80 blocks or more, else 32 (4096 x 4096 at 32 columns: 128 blocks;
// 4096 x 11008 at 64: 172). A tile of 32 columns is a 32-byte box row, so the
// weight's map swizzles over 32 bytes (64 over 64).
// The first form (one block per 128 columns on the CUDA cores, 128 rows of
// x staged with __syncthreads, 32 blocks at E 4096) took 14x kernel 2's
// time.
//
// f32 x (the CUDA cores of int8_matmul_cc.cuh: TF32 would round x): one
// block per 128 columns walks the whole of D, 128 rows of x staged at a
// time, and accumulates in f32 registers.
#include "int8_matmul_cc.cuh"
#include "int8_matmul_tc.cuh"

namespace {

// f32 x: one block per 32 * CPT columns walks the whole of D, 128 rows of x
// staged at a time, and accumulates in f32 registers; no split along D and
// no partials. The block total is scaled per column once.
template <int NT, int CPT>
__global__ void __launch_bounds__(kThreads)
int8_matmul_grid(const float* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ s, float* __restrict__ out, int n, int d,
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
    stage_x<float, NT>(xs, x, n, d, d0, rows);
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
          out[(size_t)i * e + col0 + j] = acc[i][j] * s[col0 + j];
      }
    }
  }
}

// f32 x: 4 columns per lane (128 per block), NT = n rounded up to a power of
// two
template <int NT>
cudaError_t launch_grid_f32(const float* x, const int8_t* w, const float* s, float* out, int n,
                            int d, int e, cudaStream_t st) {
  constexpr int CPT = 4;
  int8_matmul_grid<NT, CPT><<<(e + 32 * CPT - 1) / (32 * CPT), kThreads, 0, st>>>(x, w, s, out,
                                                                                n, d, e);
  return cudaGetLastError();
}

cudaError_t dispatch_grid_f32(const float* x, const int8_t* w, const float* s, float* out,
                              int n, int d, int e, cudaStream_t st) {
  if (n <= 1) return launch_grid_f32<1>(x, w, s, out, n, d, e, st);
  if (n <= 2) return launch_grid_f32<2>(x, w, s, out, n, d, e, st);
  if (n <= 4) return launch_grid_f32<4>(x, w, s, out, n, d, e, st);
  if (n <= 8) return launch_grid_f32<8>(x, w, s, out, n, d, e, st);
  if (n <= 16) return launch_grid_f32<16>(x, w, s, out, n, d, e, st);
  return launch_grid_f32<32>(x, w, s, out, n, d, e, st);
}

// bf16 / fp16 x: the tensor-core body at one split of the whole of D, in
// 256-row stages, with a big ring where the tiles fit one wave
template <typename T>
cudaError_t dispatch_grid_tc(const void* x, const int8_t* w, const float* s, void* out, int n,
                             int d, int ldx, int e, int cols, int big, cudaStream_t st) {
  const int slab = (d + tc::kGridRows - 1) / tc::kGridRows * tc::kGridRows;
  if (tc::bad_plan(d, ldx, e, 1, slab, cols)) return cudaErrorInvalidValue;
  if (cols == 32 && big)
    return tc::dispatch<T, 32, true>(x, w, s, out, n, d, ldx, e, 0, 1, 1, slab, st);
  if (cols == 32) return tc::dispatch<T, 32, false>(x, w, s, out, n, d, ldx, e, 0, 1, 1, slab, st);
  if (cols == 64 && big)
    return tc::dispatch<T, 64, true>(x, w, s, out, n, d, ldx, e, 0, 1, 1, slab, st);
  if (cols == 64) return tc::dispatch<T, 64, false>(x, w, s, out, n, d, ldx, e, 0, 1, 1, slab, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// x [n, d] (dtype) in rows of ldx elements, w [d, e] int8, s [e] f32, out
// [n, e]; cols and big: the column tile of bf16 / fp16 x (32 or 64) and
// whether its grid fits one wave, so that each block takes a 200 KB ring
// (ops/int8_matmul.py grid_plan); ldx a multiple of 8 for bf16 / fp16, d for
// f32, where cols and big are unused.
extern "C" int dst_int8_matmul_grid(const void* x, const void* w, const void* s, void* out,
                                    int n, int d, int ldx, int e, int cols, int big, int dtype,
                                    void* stream) {
  const int8_t* wt = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(s);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > 32 || d < 1 || e < 1 || e % 16 || (dtype == dst::kF32 && ldx != d))
    return cudaErrorInvalidValue;
  switch (dtype) {
    case dst::kF32:
      return dispatch_grid_f32(static_cast<const float*>(x), wt, sc, static_cast<float*>(out), n,
                               d, e, cs);
    case dst::kF16: return dispatch_grid_tc<__half>(x, wt, sc, out, n, d, ldx, e, cols, big, cs);
    case dst::kBF16:
      return dispatch_grid_tc<__nv_bfloat16>(x, wt, sc, out, n, d, ldx, e, cols, big, cs);
  }
  return cudaErrorInvalidValue;
}

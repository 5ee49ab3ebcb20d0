// Int8 weight-streaming matmul for decode: out[N, E] = (x[N, D] @ q[D, E]) * s[E].
//
// Replaces the TPU kernel deepspeed_tpu/ops/int8_matmul.py:_dma_kernel
// (int8_matmul_dma). Bound on the H100: bytes. At decode N <= 32 rows of x
// meet every weight byte once, so one pass over the int8 weight (D * E bytes
// at 3.35 TB/s) is the floor; the activations and the output are noise.
// The weight is the whole layer-stacked [L, D, E] tensor; the layer is a
// coordinate of the weight's tensor map (or an offset of the pointer), so
// no per-step slice copy exists.
//
// bf16 / fp16 x (the serving path): one launch of the tensor-core body in
// int8_matmul_tc.cuh (a TMA ring of weight and x tiles, an exact byte
// permute to 16 bits, mma.sync with f32 accumulation) at 128-column tiles,
// with no f32 partials in device memory:
//  * Even work per SM: D is split into `splits` slabs of whole stages, the
//    blocks of one column tile forming a thread-block cluster (grid
//    (splits, E / 128), cluster (splits, 1, 1)). The split count comes from
//    ops/int8_matmul.py:plan, a function of (D, E) only, sized so the
//    blocks fill whole waves of 132 SMs (4096 x 4096: 4 splits, 128
//    blocks; 4096 x 11008: 3, 258; 11008 x 4096: 4, 128).
//  * Deterministic split-K with no partials in device memory: each block
//    leaves its f32 sums in its own shared memory; after a cluster barrier
//    block r finalizes every splits-th group of 4 columns, reading the
//    cluster's blocks through distributed shared memory in rank order,
//    scales once per column and casts once.
//
// f32 x (int8_matmul_partial + int8_matmul_finish, the CUDA cores of
// int8_matmul_cc.cuh: TF32 would round x) keeps the first design: every
// block takes 128 weight rows, 32 per warp, CPT columns a lane (NT = N
// rounded up to a power of two; CPT shrinks as NT grows to keep NT * CPT at
// 128); blocks write f32 partials that a second small kernel sums in a fixed
// order, scales per column once, and casts once (the TPU kernel's rounding
// contract, :187-190). No atomics.
//
// The gridded form (int8_matmul_grid.cu) runs the same tensor-core body.
#include "int8_matmul_cc.cuh"
#include "int8_matmul_tc.cuh"

namespace {

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

__global__ void int8_matmul_finish(const float* __restrict__ part,
                                   const float* __restrict__ s, float* __restrict__ out,
                                   int n, int e, int k_splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * e) return;
  float a = 0.f;
  for (int k = 0; k < k_splits; ++k) a += part[(size_t)k * n * e + i];
  out[i] = a * s[i % e];
}

template <int NT, int CPT>
cudaError_t launch_f32(const float* x, const int8_t* w, const float* s, float* out,
                       float* part, int n, int d, int e, int k_splits,
                       cudaStream_t st) {
  constexpr int TE = 32 * CPT;
  if (k_splits != (d + kRows - 1) / kRows) return cudaErrorInvalidValue;
  dim3 grid((e + TE - 1) / TE, k_splits);
  int8_matmul_partial<float, NT, CPT><<<grid, kThreads, 0, st>>>(x, w, part, n, d, e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = n * e;
  int8_matmul_finish<<<(total + 255) / 256, 256, 0, st>>>(part, s, out, n, e, k_splits);
  return cudaGetLastError();
}

// f32 x: CPT columns per lane, NT = n rounded up to a power of two
cudaError_t dispatch_f32(const float* x, const int8_t* w, const float* s, float* out,
                         float* part, int n, int d, int e, int k_splits, cudaStream_t st) {
  if (n <= 1) return launch_f32<1, 16>(x, w, s, out, part, n, d, e, k_splits, st);
  if (n <= 2) return launch_f32<2, 16>(x, w, s, out, part, n, d, e, k_splits, st);
  if (n <= 4) return launch_f32<4, 16>(x, w, s, out, part, n, d, e, k_splits, st);
  if (n <= 8) return launch_f32<8, 16>(x, w, s, out, part, n, d, e, k_splits, st);
  if (n <= 16) return launch_f32<16, 8>(x, w, s, out, part, n, d, e, k_splits, st);
  return launch_f32<32, 4>(x, w, s, out, part, n, d, e, k_splits, st);
}

}  // namespace

// x [n, d] (dtype) in rows of ldx elements, w [n_layers, d, e] int8
// (n_layers 1 for a [d, e] weight), s [n_layers, e] f32, out [n, e]
// (dtype). bf16/fp16: the tensor-core kernel, `splits` slabs of `slab` rows
// (ops/int8_matmul.py plan), part unused, ldx a multiple of 8. f32: the
// CUDA-core kernel, splits = ceil(d / 128) blocks along D writing part
// [splits, n, e] f32 scratch, slab unused, ldx = d.
extern "C" int dst_int8_matmul(const void* x, const void* w, const void* s,
                               void* out, void* part, int n, int d, int ldx, int e,
                               int layer, int n_layers, int splits, int slab,
                               int dtype, void* stream) {
  if (n < 1 || n > 32 || d < 1 || e < 1 || e % 16 || layer < 0 || layer >= n_layers ||
      splits < 1 || (dtype == dst::kF32 && ldx != d))
    return cudaErrorInvalidValue;
  const int8_t* wt = static_cast<const int8_t*>(w);
  const float* sl = static_cast<const float*>(s) + (size_t)layer * e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == dst::kF32)
    return dispatch_f32(static_cast<const float*>(x), wt + (size_t)layer * d * e, sl,
                        static_cast<float*>(out), static_cast<float*>(part), n, d, e, splits,
                        st);
  if (tc::bad_plan(d, ldx, e, splits, slab, 128)) return cudaErrorInvalidValue;
  switch (dtype) {
    case dst::kF16:
      return tc::dispatch<__half, 128, false>(x, wt, sl, out, n, d, ldx, e, layer, n_layers,
                                              splits, slab, st);
    case dst::kBF16:
      return tc::dispatch<__nv_bfloat16, 128, false>(x, wt, sl, out, n, d, ldx, e, layer,
                                                     n_layers, splits, slab, st);
  }
  return cudaErrorInvalidValue;
}


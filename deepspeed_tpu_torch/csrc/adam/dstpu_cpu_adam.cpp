// dstpu_cpu_adam — vectorized host optimizer kernels for ZeRO-Offload.
//
// Reference analog: csrc/adam/cpu_adam.cpp + csrc/adagrad/cpu_adagrad.cpp —
// the optimizer step for host-resident (offloaded) state.  The reference
// hand-writes AVX2/AVX512 intrinsics; here the loops are written so the
// compiler auto-vectorizes them (built with -O3 -mavx2/-mavx512f -fopenmp by
// the native op builder), which reaches the same memory-bound roofline on
// modern toolchains without per-ISA code paths.
//
// All arrays are dense fp32 host buffers (numpy-owned).  The fp32→bf16 copy
// kernel produces the compute-dtype image that gets pushed back to the
// device after the step (the reference's fp16 param copy, cpu_adam.h).
//
// The PyTorch port's copy of csrc/adam/dstpu_cpu_adam.cpp: the kernels are
// the same source (so the two packages' host steps give the same bits from
// one compiler and flags); the buffers are torch CPU tensors, and
// dstpu_set_num_threads sets the OpenMP team size the sweeps use.

#include <cmath>
#include <cstddef>
#include <cstdint>
#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline float bf16_to_f32(uint16_t u) {
  uint32_t bits = ((uint32_t)u) << 16;  // widening is exact
  float f;
  __builtin_memcpy(&f, &bits, 4);
  return f;
}

inline uint16_t f32_to_bf16(float f) {
  uint32_t bits;
  __builtin_memcpy(&bits, &f, 4);
  if ((bits & 0x7F800000u) == 0x7F800000u && (bits & 0x007FFFFFu))
    return 0x7FC0;  // NaN: RNE carry could silently flip it to +/-0 or Inf
  uint32_t lsb = (bits >> 16) & 1u;
  return (uint16_t)((bits + 0x7FFFu + lsb) >> 16);
}

// One-pass Adam/AdamW over a flat fp32 shard, templated on the
// loop-invariant mode flags so every instantiation is a branch-free,
// auto-vectorizable stream (the reference reaches the same place with
// hand-written AVX512 intrinsics, csrc/adam/cpu_adam.cpp:309; a modern
// -O3 -mavx2 auto-vectorizer matches it on this memory-bound loop once
// divides are hoisted and the body is branchless).
template <bool GRAD_BF16, bool WD_L2, bool WD_ADAMW, bool EMIT_BF16>
void adam_body(float* __restrict p, const void* __restrict grads,
               float grad_scale, float* __restrict m_, float* __restrict v_,
               uint16_t* __restrict bf16_out, int64_t n, float lr, float b1,
               float b2, float eps, float wd, float bc1, float bc2) {
  const float* __restrict gf = (const float*)grads;
  const uint16_t* __restrict gh = (const uint16_t*)grads;
  const float omb1 = 1.0f - b1, omb2 = 1.0f - b2;
  const float inv_bc1 = 1.0f / bc1, inv_bc2 = 1.0f / bc2;
#pragma omp parallel for simd schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    float g = GRAD_BF16 ? bf16_to_f32(gh[i]) : gf[i];
    g *= grad_scale;
    if (WD_L2) g += wd * p[i];
    float m = b1 * m_[i] + omb1 * g;
    float v = b2 * v_[i] + omb2 * g * g;
    m_[i] = m;
    v_[i] = v;
    float update = (m * inv_bc1) / (std::sqrt(v * inv_bc2) + eps);
    if (WD_ADAMW) update += wd * p[i];
    float newp = p[i] - lr * update;
    p[i] = newp;
    if (EMIT_BF16) bf16_out[i] = f32_to_bf16(newp);
  }
}

template <bool GRAD_BF16, bool WD_L2, bool WD_ADAMW>
void adam_emit(float* p, const void* g, float gs, float* m, float* v,
               uint16_t* out, int64_t n, float lr, float b1, float b2,
               float eps, float wd, float bc1, float bc2) {
  if (out)
    adam_body<GRAD_BF16, WD_L2, WD_ADAMW, true>(p, g, gs, m, v, out, n, lr,
                                                b1, b2, eps, wd, bc1, bc2);
  else
    adam_body<GRAD_BF16, WD_L2, WD_ADAMW, false>(p, g, gs, m, v, out, n, lr,
                                                 b1, b2, eps, wd, bc1, bc2);
}

template <bool GRAD_BF16>
void adam_wd(float* p, const void* g, float gs, float* m, float* v,
             uint16_t* out, int64_t n, float lr, float b1, float b2,
             float eps, float wd, int adamw, float bc1, float bc2) {
  if (wd > 0.0f && !adamw)
    adam_emit<GRAD_BF16, true, false>(p, g, gs, m, v, out, n, lr, b1, b2,
                                      eps, wd, bc1, bc2);
  else if (wd > 0.0f && adamw)
    adam_emit<GRAD_BF16, false, true>(p, g, gs, m, v, out, n, lr, b1, b2,
                                      eps, wd, bc1, bc2);
  else
    adam_emit<GRAD_BF16, false, false>(p, g, gs, m, v, out, n, lr, b1, b2,
                                       eps, wd, bc1, bc2);
}

}  // namespace

extern "C" {

// Fused one-pass step for the ZeRO-Offload hot path: optional bf16 grad
// input (decoded inline), fused unscale/clip multiplier, and optional bf16
// compute-image emission — one memory sweep instead of four (grad convert,
// grad scale, step, image copy).  bf16_out may be null.
void dstpu_adam_step_fused(float* params, const void* grads, int grads_bf16,
                           float grad_scale, float* exp_avg,
                           float* exp_avg_sq, uint16_t* bf16_out, uint64_t n,
                           int64_t step, float lr, float beta1, float beta2,
                           float eps, float weight_decay, int adamw_mode,
                           int bias_correction) {
  float bc1 = 1.0f, bc2 = 1.0f;
  if (bias_correction) {
    bc1 = 1.0f - std::pow(beta1, (float)step);
    bc2 = 1.0f - std::pow(beta2, (float)step);
  }
  if (grads_bf16)
    adam_wd<true>(params, grads, grad_scale, exp_avg, exp_avg_sq, bf16_out,
                  (int64_t)n, lr, beta1, beta2, eps, weight_decay, adamw_mode,
                  bc1, bc2);
  else
    adam_wd<false>(params, grads, grad_scale, exp_avg, exp_avg_sq, bf16_out,
                   (int64_t)n, lr, beta1, beta2, eps, weight_decay,
                   adamw_mode, bc1, bc2);
}

// One Adam/AdamW step over a flat shard.  step is the 1-based step count
// AFTER this update (bias correction uses it directly).
void dstpu_adam_step(float* params, const float* grads, float* exp_avg,
                     float* exp_avg_sq, uint64_t n, int64_t step, float lr,
                     float beta1, float beta2, float eps, float weight_decay,
                     int adamw_mode, int bias_correction) {
  dstpu_adam_step_fused(params, grads, /*grads_bf16=*/0, /*grad_scale=*/1.0f,
                        exp_avg, exp_avg_sq, /*bf16_out=*/nullptr, n, step,
                        lr, beta1, beta2, eps, weight_decay, adamw_mode,
                        bias_correction);
}

void dstpu_adagrad_step(float* params, const float* grads, float* sum_sq,
                        uint64_t n, float lr, float eps, float weight_decay) {
#pragma omp parallel for simd schedule(static)
  for (int64_t i = 0; i < (int64_t)n; ++i) {
    float g = grads[i];
    if (weight_decay > 0.0f) g += weight_decay * params[i];
    float s = sum_sq[i] + g * g;
    sum_sq[i] = s;
    params[i] -= lr * g / (std::sqrt(s) + eps);
  }
}

// fp32 → bf16 (round-to-nearest-even), for pushing compute-dtype params back
// to the device.
void dstpu_copy_f32_to_bf16(const float* src, uint16_t* dst, uint64_t n) {
#pragma omp parallel for simd schedule(static)
  for (int64_t i = 0; i < (int64_t)n; ++i) dst[i] = f32_to_bf16(src[i]);
}

// Team size of the sweeps for later calls from this thread (n <= 0 leaves
// it); returns the size now in force (1 without OpenMP).
int dstpu_set_num_threads(int n) {
#ifdef _OPENMP
  if (n > 0) omp_set_num_threads(n);
  return omp_get_max_threads();
#else
  (void)n;
  return 1;
#endif
}

}  // extern "C"

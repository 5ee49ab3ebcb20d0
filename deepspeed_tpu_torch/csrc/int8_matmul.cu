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
// bf16 / fp16 x (int8_matmul_tc, the serving path): one launch, no f32
// partials in device memory.
//  * Products on the tensor cores: mma.sync m16n8k16 with f32
//    accumulation, the weight's columns as M and x's rows as N (one n-tile
//    per 8 rows). Int8 values are exact in bf16 and fp16, so the products
//    are the reference's (the weight upcast to x's dtype, an f32 dot,
//    int8_matmul.py:182-186), summed in another order.
//  * Weight tiles of 128 rows x 128 columns (16 KB) and x's matching 128
//    columns arrive by TMA (tensor maps, 128-byte swizzle, zero-filled past
//    D and E; the weight under an L2 evict-first policy, as it is read once)
//    in an mbarrier ring fed by one producer thread: 5 stages at N <= 8, 4
//    above (the ring within 96 KB, two blocks an SM). Each launch is
//    a programmatic dependent: its first ring of weight tiles is requested
//    before griddepcontrol.wait (the weight is no output of the grid
//    before), x after it.
//  * The operand transpose happens in registers. With E contiguous an A
//    fragment's element pairs run along D, so each lane loads one 4-byte
//    word (4 columns) from each of its 4 rows of a k-step (rows 2t, 2t+1,
//    2t+8, 2t+9: the swizzle puts them in distinct banks), and one byte
//    permute pairs two rows' bytes of a column; bf16 then takes
//    (0x4300 | b & 0x7f) - (0x4300 | b & 0x80) (two LOP3 and one bf16x2
//    FMA), fp16 (0x6400 | b ^ 0x80) - 1152 (one LOP3, one half2 subtract):
//    exact. The 4x4 bytes of a lane feed two M-tiles (columns 4g + {0, 1}
//    and 4g + {2, 3}), so each lane ends with 4 adjacent columns of its rows
//    of x.
//  * Eight consumer warps: warp w takes columns 32 (w % 4) .. + 31 and
//    k-steps 4 (w / 4) .. + 3 of every stage; the two halves sum in shared
//    memory in a fixed order. A warp's reads of a slot are fenced against
//    the async proxy before it frees the slot for the next TMA write (without
//    the fence a refill overtook the reads: wrong sums, run to run).
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
//    scales once per column and casts once. A row's result depends on
//    neither the other rows nor the run.
//
// f32 x (int8_matmul_partial + int8_matmul_finish, the CUDA cores: TF32
// would round x) keeps the first design:
//  * Each lane owns CPT consecutive output columns and loads them with one
//    CPT-byte vector load per weight row: a warp streams 32 * CPT contiguous
//    bytes of every row (coalesced). Each int8 value is upcast once in
//    registers (a byte permute into a float's mantissa and one subtract,
//    exact) and multiplies f32 copies of x staged in shared memory; all N
//    rows accumulate in f32 registers (NT * CPT of them, NT = N rounded up
//    to a power of two; CPT shrinks as NT grows to keep that at 128). The
//    loads of a warp's next rows are issued before it computes on the
//    current ones, so two groups of 16-byte loads per lane are in flight.
//  * Every block takes 128 weight rows, 32 per warp. The four warps reduce
//    in shared memory as a fixed tree ((w0 + w2) + (w1 + w3)), stored
//    lane-minor so no two lanes hit one bank; blocks write f32 partials
//    that a second small kernel sums in a fixed order, scales per column
//    once, and casts once (the TPU kernel's rounding contract, :187-190).
//    No atomics.
//
// The gridded form, dst_int8_matmul_grid, replaces the TPU kernel
// deepspeed_tpu/ops/int8_matmul.py:_kernel (:44, pallas_call :284; unrouted
// in both packages, kept for comparison). Its grid walks E tiles in
// parallel and D in order (the reference's ("parallel", "arbitrary")): one
// block per 128 columns walks the whole of D with the f32 form's vector
// loads and exact upcast, accumulates in f32 registers, reduces its warps by
// the same tree, and scales and casts once. It has no D split and no
// partials, so at E = 4096 only 32 blocks stream the weight.
#include "hopper.cuh"

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

__global__ void int8_matmul_finish(const float* __restrict__ part,
                                   const float* __restrict__ s, float* __restrict__ out,
                                   int n, int e, int k_splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * e) return;
  float a = 0.f;
  for (int k = 0; k < k_splits; ++k) a += part[(size_t)k * n * e + i];
  out[i] = a * s[i % e];
}

// ------------------------------------------------- bf16 / fp16: tensor cores
namespace tc {

constexpr int kCols = 128;            // weight columns per block (one 128-byte box row)
constexpr int kStageRows = 128;       // weight rows per ring stage (8 k-steps)
constexpr int kKGroups = 2;           // warps sharing a column group, 4 k-steps each
constexpr int kStepsPerWarp = kStageRows / 16 / kKGroups;
constexpr int kColGroups = kCols / 32;                   // 32 columns each
constexpr int kConsumerWarps = kColGroups * kKGroups;    // 8
constexpr int kThreads = 32 * (kConsumerWarps + 1);
constexpr int kWBytes = kStageRows * kCols;              // 16 KB of weight per stage
constexpr int kXPanels = kStageRows / 64;                // x's 64-column boxes per stage
constexpr int kRedStride = kCols + 4;                    // f32 row of the block's sums (padded)
constexpr int kMaxSplits = 8;                            // portable cluster size

template <int NT>
struct Shape {
  static constexpr int kXPanelBytes = 64 * 2 * 8 * NT;   // x [8 NT rows][64] 16-bit
  static constexpr int kStageBytes = kWBytes + kXPanels * kXPanelBytes;  // multiple of 1024
  // as many stages as keep the ring within 96 KB (two blocks an SM), 4 to 5
  static constexpr int kStages = 98304 / kStageBytes > 5 ? 5 : 98304 / kStageBytes;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kRedSlot = 8 * NT * kRedStride;   // floats of one k-group's sums
  static constexpr int kRedBytes = (kKGroups - 1) * kRedSlot * 4;   // aliases the ring
  static constexpr int kBarOff = kRingBytes > kRedBytes ? kRingBytes : kRedBytes;
  static constexpr size_t smem() { return 1024 + kBarOff + 16 * kStages; }
};

// one m16n8k16 product, f32 accumulation
template <typename T>
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (a & b) | c and (a & b) ^ c in one instruction: the constants come in
// registers (one LOP3 takes a single immediate)
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xea;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ uint32_t and_xor(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The constants of the conversion, held in registers.
struct Consts {
  uint32_t low7, bit7, magic, lowbyte, neg1;
  __device__ __forceinline__ Consts() {
    asm volatile("mov.b32 %0, 0x007f007f;\n" : "=r"(low7));
    asm volatile("mov.b32 %0, 0x00800080;\n" : "=r"(bit7));
    asm volatile("mov.b32 %0, 0x43004300;\n" : "=r"(magic));
    asm volatile("mov.b32 %0, 0x00ff00ff;\n" : "=r"(lowbyte));
    asm volatile("mov.b32 %0, 0xBF80BF80;\n" : "=r"(neg1));
  }
};

// The A fragments of the two M-tiles of one k-step from the 4 words a lane
// loaded (w[i]: 4 columns of its row 2t, 2t+1, 2t+8, 2t+9): M-tile m takes
// columns 4g + 2m (rows g) and 4g + 2m + 1 (rows g + 8). One byte permute
// puts column j of two rows in the low bytes of a 16-bit pair; then, per
// pair, exactly: bf16 (0x4300 | b & 0x7f) - (0x4300 | b & 0x80), that is
// (128 + low 7 bits) - (128 or 256), as one bf16x2 fma by -1; fp16
// (0x6400 | b ^ 0x80) - 1152, that is (1024 + b + 128) - 1152. Every value
// and difference is an integer of at most 9 bits, so nothing rounds.
template <typename T>
__device__ __forceinline__ void a_frags(const uint32_t (&w)[4], uint32_t (&a)[2][4],
                                        const Consts& k) {
#pragma unroll
  for (int pr = 0; pr < 2; ++pr) {     // rows (2t, 2t+1), then (2t+8, 2t+9)
#pragma unroll
    for (int j = 0; j < 4; ++j) {      // column 4g + j: M-tile j / 2, row g (+8 if odd)
      const uint32_t b2 = __byte_perm(w[2 * pr], w[2 * pr + 1], 0x0400 + 0x0101 * j);
      uint32_t r;
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        const uint32_t hi = and_or(b2, k.low7, k.magic);
        const uint32_t lo = and_or(b2, k.bit7, k.magic);
        asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(lo), "r"(k.neg1), "r"(hi));
      } else {
        const uint32_t h = and_xor(b2, k.lowbyte, 0x64806480u);
        asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(r) : "r"(h), "r"(0x64806480u));
      }
      a[j >> 1][(j & 1) + 2 * pr] = r;
    }
  }
}

// Grid (splits, ceil(E / kCols)), cluster (splits, 1, 1). Block (split,
// tile) takes weight rows [split * slab, +slab) of columns [kCols tile,
// +kCols).
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
int8_matmul_tc(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap xmap,
               const float* __restrict__ s, T* __restrict__ out, int n, int d, int e,
               int layer, int slab) {
  using namespace dst::hopper;
  using S = Shape<NT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* red = reinterpret_cast<float*>(base);   // after the ring has drained
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S::kBarOff);
  uint64_t* empty = full + S::kStages;
  constexpr int kStages = S::kStages;
  const int splits = gridDim.x;
  const int e0 = blockIdx.y * kCols;
  const int d0 = blockIdx.x * slab;
  const int n_st = (min(d0 + slab, d) - d0 + kStageRows - 1) / kStageRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
  // the next launch may start its weight loads while this grid finishes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  if (warp == kConsumerWarps) {  // ------------------------------- producer
    if (lane == 0) {
      // every weight byte is read once: evict it from the L2 first
      uint64_t wpol;
      asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(wpol));
      // The weight is no output of the grid before this one (a programmatic
      // dependent launch): the first ring's weight tiles are requested
      // before waiting for that grid, x's after.
      const int first = min(n_st, kStages);
      for (int st = 0; st < first; ++st) {
        mbar_expect_tx(&full[st], S::kStageBytes);
        tma_load_3d_hint(base + st * S::kStageBytes, &wmap, &full[st], e0,
                         d0 + st * kStageRows, layer, wpol);
      }
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      for (int st = 0; st < n_st; ++st) {
        const int slot = st % kStages;
        unsigned char* sb = base + slot * S::kStageBytes;
        const int r = d0 + st * kStageRows;
        if (st >= kStages) {
          mbar_wait(&empty[slot], ((st / kStages) - 1) & 1);
          mbar_expect_tx(&full[slot], S::kStageBytes);
          tma_load_3d_hint(sb, &wmap, &full[slot], e0, r, layer, wpol);
        }
#pragma unroll
        for (int xp = 0; xp < kXPanels; ++xp)
          tma_load_2d(sb + kWBytes + xp * S::kXPanelBytes, &xmap, &full[slot], r + 64 * xp, 0);
      }
    }
    __syncwarp();
  } else {  // ------------------------------------------------------ consumers
    const int cg = warp % kColGroups, kq = warp / kColGroups, g = lane >> 2, t = lane & 3;
    const Consts k;
    // this lane's byte offsets in a stage: its 4 weight words of each k-step
    // and its x words (the swizzle is the same in every stage)
    int woff[kStepsPerWarp][4], xoff[kStepsPerWarp][NT][2];
#pragma unroll
    for (int kk = 0; kk < kStepsPerWarp; ++kk) {
      const int k16 = kStepsPerWarp * kq + kk;  // this warp's k-steps of a stage
#pragma unroll
      for (int i = 0; i < 4; ++i)
        woff[kk][i] = sw128(16 * k16 + 2 * t + (i & 1) + 8 * (i >> 1), 32 * cg + 4 * g);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int xb = kWBytes + (k16 >> 2) * S::kXPanelBytes, kb = 32 * (k16 & 3);
        xoff[kk][j][0] = xb + sw128(8 * j + g, kb + 4 * t);
        xoff[kk][j][1] = xb + sw128(8 * j + g, kb + 16 + 4 * t);
      }
    }
    float acc[2][NT][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][j][c] = 0.f;
    for (int st = 0; st < n_st; ++st) {
      const int slot = st % kStages;
      mbar_wait(&full[slot], (st / kStages) & 1);
      const unsigned char* sb = base + slot * S::kStageBytes;
#pragma unroll
      for (int kk = 0; kk < kStepsPerWarp; ++kk) {
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = *reinterpret_cast<const uint32_t*>(sb + woff[kk][i]);
        uint32_t a[2][4];
        a_frags<T>(w, a, k);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(sb + xoff[kk][j][0]);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(sb + xoff[kk][j][1]);
          mma<T>(acc[0][j], a[0], b0, b1);
          mma<T>(acc[1][j], a[1], b0, b1);
        }
      }
      // this warp's reads of the slot, before the TMA refill (async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    }
    // The k-groups of a column group: groups 1.. park their sums where the
    // ring was, group 0 adds them to its own in group order and leaves the
    // block's sums in the first slot: red[row][col], row = x's row, col =
    // this tile's column.
    const int c0 = 32 * cg + 4 * g;
    asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumerWarps) : "memory");
    if (kq > 0) {
      float* slot = red + (kq - 1) * S::kRedSlot;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int r = 8 * j + 2 * t;
        *reinterpret_cast<float4*>(slot + r * kRedStride + c0) =
            make_float4(acc[0][j][0], acc[0][j][2], acc[1][j][0], acc[1][j][2]);
        *reinterpret_cast<float4*>(slot + (r + 1) * kRedStride + c0) =
            make_float4(acc[0][j][1], acc[0][j][3], acc[1][j][1], acc[1][j][3]);
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumerWarps) : "memory");
    if (kq == 0) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int r = 8 * j + 2 * t;
        float4 v0 = make_float4(acc[0][j][0], acc[0][j][2], acc[1][j][0], acc[1][j][2]);
        float4 v1 = make_float4(acc[0][j][1], acc[0][j][3], acc[1][j][1], acc[1][j][3]);
#pragma unroll
        for (int q = 0; q < kKGroups - 1; ++q) {
          const float* slot = red + q * S::kRedSlot;
          const float4 h0 = *reinterpret_cast<const float4*>(slot + r * kRedStride + c0);
          const float4 h1 = *reinterpret_cast<const float4*>(slot + (r + 1) * kRedStride + c0);
          v0 = make_float4(v0.x + h0.x, v0.y + h0.y, v0.z + h0.z, v0.w + h0.w);
          v1 = make_float4(v1.x + h1.x, v1.y + h1.y, v1.z + h1.z, v1.w + h1.w);
        }
        *reinterpret_cast<float4*>(red + r * kRedStride + c0) = v0;
        *reinterpret_cast<float4*>(red + (r + 1) * kRedStride + c0) = v1;
      }
    }
  }
  // ------------------------------------------------- split-K in the cluster
  cluster_sync();
  // out and s are read or written below: after the grid before this one
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const uint32_t rank = cluster_rank();
  constexpr int kGroups = 8 * NT * (kCols / 4);   // (row, 4-column group) pairs
  for (int i = threadIdx.x * splits + (int)rank; i < kGroups; i += kThreads * splits) {
    const int r = i / (kCols / 4), c = 4 * (i % (kCols / 4));
    const int col = e0 + c;
    if (r < n && col < e) {  // e % 16 == 0: the group is whole
      const float* src = red + r * kRedStride + c;
      float4 v = ld_cluster_f4(map_rank(src, 0));
      for (int q = 1; q < splits; ++q) {
        const float4 o = ld_cluster_f4(map_rank(src, q));
        v.x += o.x;
        v.y += o.y;
        v.z += o.z;
        v.w += o.w;
      }
      const float4 sc = *reinterpret_cast<const float4*>(s + col);
      T res[4] = {dst::from_f32<T>(v.x * sc.x), dst::from_f32<T>(v.y * sc.y),
                  dst::from_f32<T>(v.z * sc.z), dst::from_f32<T>(v.w * sc.w)};
      *reinterpret_cast<uint2*>(out + (size_t)r * e + col) = *reinterpret_cast<const uint2*>(res);
    }
  }
  cluster_sync();  // no block leaves while another reads its shared memory
}

template <typename T, int NT>
cudaError_t launch(const void* x, const int8_t* w, const float* s, void* out, int n, int d,
                   int e, int layer, int n_layers, int splits, int slab, cudaStream_t st) {
  using namespace dst::hopper;
  CUtensorMap wmap, xmap;
  const cuuint64_t wdims[3] = {(cuuint64_t)e, (cuuint64_t)d, (cuuint64_t)n_layers};
  const cuuint64_t wstrides[2] = {(cuuint64_t)e, (cuuint64_t)d * e};
  const cuuint32_t wbox[3] = {kCols, kStageRows, 1};
  const cuuint64_t xdims[2] = {(cuuint64_t)d, (cuuint64_t)n};
  const cuuint64_t xstrides[1] = {(cuuint64_t)d * sizeof(T)};
  const cuuint32_t xbox[2] = {64, 8 * NT};
  cudaError_t err;
  if ((err = swizzled_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, w, wdims, wstrides, wbox)) !=
          cudaSuccess ||
      (err = swizzled_map(&xmap, map_type<T>(), 2, x, xdims, xstrides, xbox)) != cudaSuccess)
    return err;
  auto kern = int8_matmul_tc<T, NT>;
  constexpr size_t smem = Shape<NT>::smem();
  // raise the dynamic shared-memory cap once (before any graph capture:
  // the first call of a shape is never captured)
  static bool allowed = false;
  if (!allowed) {
    if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)) != cudaSuccess)
      return err;
    allowed = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (e + kCols - 1) / kCols);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // a programmatic dependent launch: its weight loads start while the grid
  // before it finishes (x is read after griddepcontrol.wait)
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, kern, wmap, xmap, s, static_cast<T*>(out), n, d, e, layer,
                            slab);
}

template <typename T>
cudaError_t dispatch(const void* x, const int8_t* w, const float* s, void* out, int n, int d,
                     int e, int layer, int n_layers, int splits, int slab, cudaStream_t st) {
  if (n <= 8) return launch<T, 1>(x, w, s, out, n, d, e, layer, n_layers, splits, slab, st);
  if (n <= 16) return launch<T, 2>(x, w, s, out, n, d, e, layer, n_layers, splits, slab, st);
  if (n <= 24) return launch<T, 3>(x, w, s, out, n, d, e, layer, n_layers, splits, slab, st);
  return launch<T, 4>(x, w, s, out, n, d, e, layer, n_layers, splits, slab, st);
}

}  // namespace tc

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

// x [n, d] (dtype), w [n_layers, d, e] int8 (n_layers 1 for a [d, e]
// weight), s [n_layers, e] f32, out [n, e] (dtype). bf16/fp16: the
// tensor-core kernel, `splits` slabs of `slab` rows (ops/int8_matmul.py
// plan), part unused. f32: the CUDA-core kernel, splits = ceil(d / 128)
// blocks along D writing part [splits, n, e] f32 scratch, slab unused.
extern "C" int dst_int8_matmul(const void* x, const void* w, const void* s,
                               void* out, void* part, int n, int d, int e,
                               int layer, int n_layers, int splits, int slab,
                               int dtype, void* stream) {
  if (n < 1 || n > 32 || d < 1 || e < 1 || e % 16 || layer < 0 || layer >= n_layers ||
      splits < 1)
    return cudaErrorInvalidValue;
  const int8_t* wt = static_cast<const int8_t*>(w);
  const float* sl = static_cast<const float*>(s) + (size_t)layer * e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == dst::kF32)
    return dispatch_f32(static_cast<const float*>(x), wt + (size_t)layer * d * e, sl,
                        static_cast<float*>(out), static_cast<float*>(part), n, d, e, splits,
                        st);
  // bf16/fp16: x's rows must be 16-byte strides for its tensor map; the
  // slabs are whole stages and every split holds rows
  if (d % 8 || splits > tc::kMaxSplits || slab < 1 || slab % tc::kStageRows ||
      (d + slab - 1) / slab != splits || (e + tc::kCols - 1) / tc::kCols > 65535)
    return cudaErrorInvalidValue;
  switch (dtype) {
    case dst::kF16:
      return tc::dispatch<__half>(x, wt, sl, out, n, d, e, layer, n_layers, splits, slab, st);
    case dst::kBF16:
      return tc::dispatch<__nv_bfloat16>(x, wt, sl, out, n, d, e, layer, n_layers, splits, slab,
                                         st);
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

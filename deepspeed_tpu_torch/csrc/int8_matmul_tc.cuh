// The tensor-core body of the int8 weight-streaming matmul for bf16 / fp16 x,
// shared by kernel 2 (int8_matmul.cu: 128-column tiles, D split into the
// slabs of a thread-block cluster) and the gridded form
// (int8_matmul_grid.cu: 32- or 64-column tiles, one block walking the whole
// of D). The column tile COLS is a template parameter; everything else is
// one body. See int8_matmul.cu for what bounds it and how the design answers.
//
//  * Products on the tensor cores: mma.sync m16n8k16 with f32
//    accumulation, the weight's columns as M and x's rows as N (one n-tile
//    per 8 rows). Int8 values are exact in bf16 and fp16, so the products
//    are the reference's (the weight upcast to x's dtype, an f32 dot,
//    int8_matmul.py:182-186), summed in another order.
//  * Weight tiles of 128 rows (kernel 2) or 256 (the gridded form's
//    narrower tiles: fewer, larger stages) x COLS columns and x's matching
//    columns arrive by TMA (tensor maps zero-filled past D and E; the
//    weight's map swizzled over COLS bytes, x's over 128; the weight under
//    an L2 evict-first policy, as it is read once) in an mbarrier ring fed by
//    one producer thread: the ring within 96 KB (two blocks an SM) and at
//    most 80 KB of weight in flight (5 stages at 128 columns), or, for a
//    gridded launch whose blocks fit one wave, within 200 KB with 160 KB in
//    flight. Each launch is a programmatic dependent: its first ring of
//    weight tiles is requested before griddepcontrol.wait (the weight is no
//    output of the grid before), x after it.
//  * The operand transpose happens in registers. With E contiguous an A
//    fragment's element pairs run along D, so each lane loads one 4-byte
//    word (4 columns) from each of its 4 rows of a k-step (rows 2t, 2t+1,
//    2t+8, 2t+9), and one byte permute pairs two rows' bytes of a column;
//    bf16 then takes (0x4300 | b & 0x7f) - (0x4300 | b & 0x80) (two LOP3 and
//    one bf16x2 FMA), fp16 (0x6400 | b ^ 0x80) - 1152 (one LOP3, one half2
//    subtract): exact. The 4x4 bytes of a lane feed two M-tiles (columns
//    4g + {0, 1} and 4g + {2, 3}), so each lane ends with 4 adjacent columns
//    of its rows of x.
//  * Eight consumer warps over COLS / 32 column groups of 32 columns: the
//    kKGroups warps of a column group share a stage's k-steps (4 a warp at
//    128 columns, 2 at 32 and 256 rows); their partial sums add in shared
//    memory in a fixed order. A warp's reads of a slot are fenced against the async
//    proxy before it frees the slot for the next TMA write (without the
//    fence a refill overtook the reads: wrong sums, run to run).
//  * With several splits (kernel 2) each block leaves its f32 sums in its
//    own shared memory; after a cluster barrier block r finalizes every
//    splits-th group of 4 columns, reading the cluster's blocks through
//    distributed shared memory in rank order. With one split (the gridded
//    form) the block finalizes its own sums. Either way each column is
//    scaled once and cast once, and a row's result depends on neither the
//    other rows nor the run.
#pragma once

#include "hopper.cuh"

namespace {
namespace tc {

constexpr int kStageRows = 128;       // kernel 2's weight rows per ring stage (8 k-steps)
constexpr int kGridRows = 256;        // the gridded form's (box rows of 32 or 64 bytes)
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * (kConsumerWarps + 1);
constexpr int kMaxSplits = 8;                            // portable cluster size

// A block's geometry at COLS weight columns (32, 64 or 128: one box row of
// COLS bytes) and NT n-tiles of x's rows. The 8 consumer warps split a
// stage's k-steps over COLS / 32 column groups: kKGroups warps share a
// column group, kSteps k-steps each. BIG: a ring of up to 200 KB (one block
// an SM) where the grid has no more blocks than SMs, else 96 KB (two).
template <int NT, int COLS, bool BIG>
struct Shape {
  static constexpr int kRows = COLS == 128 ? kStageRows : kGridRows;  // rows per stage
  static constexpr int kXPanels = kRows / 64;                   // x's 64-column boxes per stage
  static constexpr int kColGroups = COLS / 32;
  static constexpr int kKGroups = kConsumerWarps / kColGroups;
  static constexpr int kSteps = kRows / 16 / kKGroups;          // k-steps per warp and stage
  static constexpr int kWBytes = kRows * COLS;                  // weight bytes per stage
  static constexpr int kXPanelBytes = 64 * 2 * 8 * NT;          // x [8 NT rows][64] 16-bit
  static constexpr int kStageBytes = kWBytes + kXPanels * kXPanelBytes;  // multiple of 1024
  // as many stages as keep the ring within its budget, at most 80 KB of
  // weight in flight (5 stages at 128 columns; 160 KB in a big ring)
  static constexpr int kBudget = BIG ? 204800 : 98304;
  static constexpr int kMaxStages = (BIG ? 163840 : 81920) / kWBytes;
  static constexpr int kStages =
      kBudget / kStageBytes > kMaxStages ? kMaxStages : kBudget / kStageBytes;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kRedStride = COLS + 4;                   // f32 row of the block's sums (padded)
  static constexpr int kRedSlot = 8 * NT * kRedStride;          // floats of one k-group's sums
  static constexpr int kRedBytes = (kKGroups - 1) * kRedSlot * 4;   // aliases the ring
  static constexpr int kBarOff = kRingBytes > kRedBytes ? kRingBytes : kRedBytes;
  static constexpr size_t smem() { return 1024 + kBarOff + 16 * kStages; }
};

// Byte offset of (row r, byte b) in a stage's weight tile of COLS-byte rows
// as the tensor map's COLS-byte swizzle writes it: the offset's 16-byte
// chunk bits [4, 4 + log2(COLS / 16)) XOR its bits from 7 up. At 128
// columns hopper::sw128 computes the same offsets, and kernel 2 keeps it:
// with the XOR of the whole offset ptxas scheduled kernel 2's loop
// differently and it ran 8% slower (0.1249 against 0.1135 ms a LLaMA-7B
// layer at N 8 on one H100, scripts/time_port_kernels.py).
template <int COLS>
__device__ __forceinline__ int sw_w(int r, int b) {
  if constexpr (COLS == 128) {
    return dst::hopper::sw128(r, b);
  } else {
    const int off = r * COLS + b;
    return off ^ (((off >> 7) & (COLS / 16 - 1)) << 4);
  }
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

// Grid (splits, ceil(E / COLS)). Kernel 2 (COLS 128): a cluster of
// (splits, 1, 1); block (split, tile) takes weight rows [split * slab,
// +slab) of columns [COLS tile, +COLS). The gridded form (COLS 32 or 64):
// one split, a block walks the whole of D, and no cluster is formed.
template <typename T, int NT, int COLS, bool BIG>
__global__ void __launch_bounds__(kThreads)
int8_matmul_tc(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap xmap,
               const float* __restrict__ s, T* __restrict__ out, int n, int d, int e,
               int layer, int slab) {
  using namespace dst::hopper;
  using S = Shape<NT, COLS, BIG>;
  constexpr bool kCluster = COLS == 128;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* red = reinterpret_cast<float*>(base);   // after the ring has drained
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S::kBarOff);
  uint64_t* empty = full + S::kStages;
  constexpr int kStages = S::kStages;
  const int splits = gridDim.x;
  const int e0 = blockIdx.y * COLS;
  const int d0 = blockIdx.x * slab;
  const int n_st = (min(d0 + slab, d) - d0 + S::kRows - 1) / S::kRows;
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
                         d0 + st * S::kRows, layer, wpol);
      }
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      for (int st = 0; st < n_st; ++st) {
        const int slot = st % kStages;
        unsigned char* sb = base + slot * S::kStageBytes;
        const int r = d0 + st * S::kRows;
        if (st >= kStages) {
          mbar_wait(&empty[slot], ((st / kStages) - 1) & 1);
          mbar_expect_tx(&full[slot], S::kStageBytes);
          tma_load_3d_hint(sb, &wmap, &full[slot], e0, r, layer, wpol);
        }
#pragma unroll
        for (int xp = 0; xp < S::kXPanels; ++xp)
          tma_load_2d(sb + S::kWBytes + xp * S::kXPanelBytes, &xmap, &full[slot], r + 64 * xp, 0);
      }
    }
    __syncwarp();
  } else {  // ------------------------------------------------------ consumers
    const int cg = warp % S::kColGroups, kq = warp / S::kColGroups, g = lane >> 2, t = lane & 3;
    const Consts k;
    // this lane's byte offsets in a stage: its 4 weight words of each k-step
    // and its x words (the swizzle is the same in every stage)
    int woff[S::kSteps][4], xoff[S::kSteps][NT][2];
#pragma unroll
    for (int kk = 0; kk < S::kSteps; ++kk) {
      const int k16 = S::kSteps * kq + kk;  // this warp's k-steps of a stage
#pragma unroll
      for (int i = 0; i < 4; ++i)
        woff[kk][i] = sw_w<COLS>(16 * k16 + 2 * t + (i & 1) + 8 * (i >> 1), 32 * cg + 4 * g);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int xb = S::kWBytes + (k16 >> 2) * S::kXPanelBytes, kb = 32 * (k16 & 3);
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
      for (int kk = 0; kk < S::kSteps; ++kk) {
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = *reinterpret_cast<const uint32_t*>(sb + woff[kk][i]);
        uint32_t a[2][4];
        a_frags<T>(w, a, k);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(sb + xoff[kk][j][0]);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(sb + xoff[kk][j][1]);
          dst::mma_m16n8k16<T>(acc[0][j], a[0], b0, b1);
          dst::mma_m16n8k16<T>(acc[1][j], a[1], b0, b1);
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
        *reinterpret_cast<float4*>(slot + r * S::kRedStride + c0) =
            make_float4(acc[0][j][0], acc[0][j][2], acc[1][j][0], acc[1][j][2]);
        *reinterpret_cast<float4*>(slot + (r + 1) * S::kRedStride + c0) =
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
        for (int q = 0; q < S::kKGroups - 1; ++q) {
          const float* slot = red + q * S::kRedSlot;
          const float4 h0 = *reinterpret_cast<const float4*>(slot + r * S::kRedStride + c0);
          const float4 h1 = *reinterpret_cast<const float4*>(slot + (r + 1) * S::kRedStride + c0);
          v0 = make_float4(v0.x + h0.x, v0.y + h0.y, v0.z + h0.z, v0.w + h0.w);
          v1 = make_float4(v1.x + h1.x, v1.y + h1.y, v1.z + h1.z, v1.w + h1.w);
        }
        *reinterpret_cast<float4*>(red + r * S::kRedStride + c0) = v0;
        *reinterpret_cast<float4*>(red + (r + 1) * S::kRedStride + c0) = v1;
      }
    }
  }
  // ------------------------------------------------- split-K in the cluster
  // (the gridded form: the block's own sums, no cluster)
  if constexpr (kCluster)
    cluster_sync();
  else
    __syncthreads();
  // out and s are read or written below: after the grid before this one
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const uint32_t rank = kCluster ? cluster_rank() : 0;
  constexpr int kGroups = 8 * NT * (COLS / 4);   // (row, 4-column group) pairs
  for (int i = threadIdx.x * splits + (int)rank; i < kGroups; i += kThreads * splits) {
    const int r = i / (COLS / 4), c = 4 * (i % (COLS / 4));
    const int col = e0 + c;
    if (r < n && col < e) {  // e % 16 == 0: the group is whole
      const float* src = red + r * S::kRedStride + c;
      float4 v;
      if constexpr (kCluster) {
        v = ld_cluster_f4(map_rank(src, 0));
        for (int q = 1; q < splits; ++q) {
          const float4 o = ld_cluster_f4(map_rank(src, q));
          v.x += o.x;
          v.y += o.y;
          v.z += o.z;
          v.w += o.w;
        }
      } else {
        v = *reinterpret_cast<const float4*>(src);
      }
      const float4 sc = *reinterpret_cast<const float4*>(s + col);
      T res[4] = {dst::from_f32<T>(v.x * sc.x), dst::from_f32<T>(v.y * sc.y),
                  dst::from_f32<T>(v.z * sc.z), dst::from_f32<T>(v.w * sc.w)};
      *reinterpret_cast<uint2*>(out + (size_t)r * e + col) = *reinterpret_cast<const uint2*>(res);
    }
  }
  if constexpr (kCluster) cluster_sync();  // no block leaves while another reads its shared memory
}

// The weight's tensor map swizzles over COLS bytes, as sw_w reads it.
template <int COLS>
constexpr CUtensorMapSwizzle weight_swizzle() {
  return COLS == 32   ? CU_TENSOR_MAP_SWIZZLE_32B
         : COLS == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                      : CU_TENSOR_MAP_SWIZZLE_128B;
}

// x [n, d] in rows of ldx elements, w [n_layers, d, e] (the layer a
// coordinate of its map), s the layer's [e] scales: `splits` slabs of `slab`
// rows, COLS-column tiles.
template <typename T, int NT, int COLS, bool BIG>
cudaError_t launch(const void* x, const int8_t* w, const float* s, void* out, int n, int d,
                   int ldx, int e, int layer, int n_layers, int splits, int slab,
                   cudaStream_t st) {
  using S = Shape<NT, COLS, BIG>;
  using namespace dst::hopper;
  CUtensorMap wmap, xmap;
  const cuuint64_t wdims[3] = {(cuuint64_t)e, (cuuint64_t)d, (cuuint64_t)n_layers};
  const cuuint64_t wstrides[2] = {(cuuint64_t)e, (cuuint64_t)d * e};
  const cuuint32_t wbox[3] = {COLS, S::kRows, 1};
  const cuuint64_t xdims[2] = {(cuuint64_t)d, (cuuint64_t)n};
  const cuuint64_t xstrides[1] = {(cuuint64_t)ldx * sizeof(T)};
  const cuuint32_t xbox[2] = {64, 8 * NT};
  cudaError_t err;
  if ((err = swizzled_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, w, wdims, wstrides, wbox,
                          weight_swizzle<COLS>())) != cudaSuccess ||
      (err = swizzled_map(&xmap, map_type<T>(), 2, x, xdims, xstrides, xbox)) != cudaSuccess)
    return err;
  auto kern = int8_matmul_tc<T, NT, COLS, BIG>;
  constexpr size_t smem = S::smem();
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
  cfg.gridDim = dim3(splits, (e + COLS - 1) / COLS);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  // a programmatic dependent launch: its weight loads start while the grid
  // before it finishes (x is read after griddepcontrol.wait); kernel 2's
  // slabs of one column tile form a cluster
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = splits;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = COLS == 128 ? 2 : 1;
  return cudaLaunchKernelEx(&cfg, kern, wmap, xmap, s, static_cast<T*>(out), n, d, e, layer,
                            slab);
}

// NT = ceil(n / 8) n-tiles of x's rows
template <typename T, int COLS, bool BIG>
cudaError_t dispatch(const void* x, const int8_t* w, const float* s, void* out, int n, int d,
                     int ldx, int e, int layer, int n_layers, int splits, int slab,
                     cudaStream_t st) {
  if (n <= 8)
    return launch<T, 1, COLS, BIG>(x, w, s, out, n, d, ldx, e, layer, n_layers, splits, slab,
                                   st);
  if (n <= 16)
    return launch<T, 2, COLS, BIG>(x, w, s, out, n, d, ldx, e, layer, n_layers, splits, slab,
                                   st);
  if (n <= 24)
    return launch<T, 3, COLS, BIG>(x, w, s, out, n, d, ldx, e, layer, n_layers, splits, slab,
                                   st);
  return launch<T, 4, COLS, BIG>(x, w, s, out, n, d, ldx, e, layer, n_layers, splits, slab,
                                 st);
}

// x's rows feed a tensor map in 16-byte strides (ldx % 8 == 0; the columns
// from d to ldx lie outside the map and read as zeros); the slabs are whole
// stages and every split holds rows.
inline bool bad_plan(int d, int ldx, int e, int splits, int slab, int cols) {
  return ldx % 8 || ldx < d || splits < 1 || splits > kMaxSplits || slab < 1 ||
         slab % kStageRows || (d + slab - 1) / slab != splits || (e + cols - 1) / cols > 65535;
}

}  // namespace tc
}  // namespace

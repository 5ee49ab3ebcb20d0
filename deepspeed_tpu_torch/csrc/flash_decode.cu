// Flash-decode: one new token's attention over a head-major [B, Hkv, S, Dh]
// cache whose position idx already holds its own K/V, split across blocks
// along the valid prefix (flash-decoding), then merged.
//
// Replaces the TPU kernels deepspeed_tpu/ops/flash_decode.py:_kernel (the
// wide-GQA slab kernel, rep >= 2) and :_mha_kernel (the rep == 1 variant,
// unrouted in the reference and here). Bound on the H100: bytes. The
// function reads the valid K and V prefix once, 2 * (min(idx, S-1) + 1) * Dh
// elements per (slot, kv head), and does 4 * rep * Dh FLOP per position:
// a few FLOP per byte, far under the card's ~295 FLOP/byte ridge. At batch 1
// (generate's route) the prefix is a few MB, so latency sets the time: how
// soon every SM has a stage of K/V in flight, and the merge after it.
//
// rep >= 2 (flash_decode_gqa): kernel B's attention (decode_split.cuh, the
// body of decode_step.cu and block_decode_step.cuh) over a row policy for a
// contiguous cache head, with no position reading a new row: the cache
// already holds it. It replaced this file's first GQA kernel (K/V loaded
// into registers with no copy in flight, a 5-shuffle butterfly per query
// row and position, all on the CUDA cores: 1.7-2.1x SDPA's time at
// CodeLlama-34B decode). Grid (split, kv head x row group, slot): each
// block attends up to 8 * NT query rows of one kv head over `chunk`
// positions, bf16/fp16 on the tensor cores (mma.sync, the rows as the n
// dimension, a 3-stage cp.async ring), f32 on the CUDA-core body; a block
// whose first position lies past idx returns before reading anything, so
// bytes follow idx, not S (the TPU kernel's clamped index map, :200-204).
// The plan is kernel B's (decode_step.split_plan, a function of the shapes
// only): on the tensor cores at most one block per SM at full S, longer
// chunks streaming through the ring (it fits two blocks an SM, and a second
// wave cost more than the longer walk); on the CUDA cores at most two.
// flash_decode_merge (kernel B's merge_row under this kernel's name, so a
// profile counts it as flash-decode) then merges each row's live splits in
// split order (no atomics: results repeat bit for bit and equal kernel
// B's), launched as a programmatic dependent of the split kernel so its
// launch overlaps the split's run. A rep wider than one block's rows (32 at
// Dh 64, 16 at 128, 8 at 256) takes several row groups, each reading the kv
// head's prefix.
//
// rep == 1 (mha::flash_decode_mha): a streaming kernel on the CUDA cores,
// since the reference keeps q, K, V and p in f32 (:113-125) and the work is
// 0.5 FMA per byte, about 6% of the CUDA cores' rate at full bandwidth: the
// design keeps the bytes flowing. Grid (split, head, slot) under
// ops/flash_decode.py:plan (one split per head while the heads fill the
// SMs). One producer thread streams the K and V rows of 32 positions a
// stage with TMA (tensor maps over the cache, 128-byte swizzle, an L2
// evict-first policy: each byte is read once) into a ring whose slots each
// belong to one of the consumer warps (4 slots of 16 KB at Dh 128 bf16;
// 64-128 KB a block); it requests the first ring before q is staged, and a
// warp fences its reads of a slot against the async proxy before freeing
// it. A lane owns a position: it reads its K
// row 16 bytes at a time (the swizzle keeps a warp's 32 rows off each other's
// banks) against q kept in shared memory as f32, so a score needs no
// cross-lane sum; the warp's online softmax moves once per stage; P.V runs
// with each lane owning Dh / 32 columns and p broadcast from its lane. The
// warps merge in warp order and, where the plan splits the prefix, the
// splits merge in split order in flash_decode_merge (a programmatic
// dependent launch). Positions of the last stage past idx are read but
// scored -inf, so p is 0 there, as the TPU kernel reads its last block
// whole (:113-125); no split starts past idx.
//
// Rounding points follow the TPU kernels: scores are products of the stored
// values summed in f32, times `scale`. The GQA computation rounds p to the V
// dtype before P.V (:83); the rep == 1 kernel keeps everything in f32
// (:113-125). The output is acc / max(l, 1e-20), cast once; 0 where no
// position is valid. idx is read on the device (a pointer) or passed by
// value, never read by the host, so a call replays in a CUDA graph.
#include <math_constants.h>

#include "decode_split.cuh"
#include "hopper.cuh"

namespace {

using namespace dst;
namespace ds = dst::split;

__device__ __forceinline__ int valid_positions(const int* idx_ptr, int idx_scalar,
                                               int s_max) {
  const int idx = idx_ptr ? *idx_ptr : idx_scalar;
  return min(idx, s_max - 1) + 1;  // positions 0..n-1; <= 0: none
}

// ------------------------------------------------------------- rep >= 2
// Rows of one contiguous [S, Dh] cache head whose position idx already
// holds the new token (decode_split.cuh's row policy): no position reads
// another row, so kn/vn are never read.
template <typename T>
struct CacheRows {
  static constexpr bool kRaw = false;
  using Elem = T;
  static constexpr const T* kn = nullptr;
  static constexpr const T* vn = nullptr;
  const T* k;
  const T* v;
  int dh;
  __device__ bool at(int pos, const T*& kr, const T*& vr) const {
    kr = k + (size_t)pos * dh;
    vr = v + (size_t)pos * dh;
    return false;
  }
  __device__ bool fresh(int) const { return false; }
};

struct GqaGeometry {
  const int* idx_ptr;
  int idx_scalar, hq, hkv, s_max, dh, chunk, n_splits;
  int rows, n_groups;  // query rows per block (at most), row groups per kv head
  float scale;
};

// DH > 0: the tensor-core body at that Dh with NT n-tiles of query rows;
// DH == 0: the CUDA-core body at geo.dh.
template <typename T, int DH, int NT>
__global__ void __launch_bounds__(ds::kThreads)
flash_decode_gqa(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* part_ml, float* part_acc, GqaGeometry geo) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int split = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / geo.n_groups, grp = blockIdx.y - kvh * geo.n_groups;
  const int rep = geo.hq / geo.hkv, dh = DH > 0 ? DH : geo.dh;
  const int r0 = grp * geo.rows, nrows = min(geo.rows, rep - r0);
  const ds::Out<T> o{out, part_ml, part_acc,
                     (size_t)b * geo.hq + (size_t)kvh * rep + r0, geo.n_splits, split, dh};
  const int n_pos = valid_positions(geo.idx_ptr, geo.idx_scalar, geo.s_max);
  const int c0 = split * geo.chunk;
  // let the merge launch now (it waits for this grid to end before reading)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (c0 >= n_pos) {
    if (geo.n_splits == 1)  // no position at all: 0 / 1e-20
      for (int i = threadIdx.x; i < nrows * dh; i += ds::kThreads)
        out[o.row0 * dh + i] = from_f32<T>(0.f);
    return;
  }
  const int c1 = min(c0 + geo.chunk, n_pos);
  const size_t head = ((size_t)b * geo.hkv + kvh) * (size_t)geo.s_max * dh;
  const CacheRows<T> rows{k + head, v + head, dh};
  const T* q_rows = q + o.row0 * dh;
  const auto no_prep = [] {};
  if constexpr (DH > 0)
    ds::attend_tc<T, DH, NT>(q_rows, rows, c0, c1, nrows, geo.scale, o, smem_raw, no_prep);
  else
    ds::attend_cc<T>(q_rows, rows, c0, c1, nrows, dh, geo.scale, o, smem_raw, no_prep);
}

// kernel B's merge (merge_splits) under flash-decode's name: grid (hq, b)
template <typename T>
__global__ void __launch_bounds__(ds::kThreads)
flash_decode_merge(const float* __restrict__ ml, const float* __restrict__ acc,
                   T* __restrict__ out, const int* __restrict__ idx_ptr, int idx_scalar,
                   int hq, int s_max, int dh, int chunk, int n_splits) {
  ds::merge_row<T>(ml, acc, out, idx_ptr, 0, idx_scalar, hq, s_max, dh, chunk, n_splits);
}

template <typename T, int DH, int NT>
cudaError_t launch_gqa(const void* q, const void* k, const void* v, void* out, float* ml,
                       float* acc, const GqaGeometry& geo, int b, cudaStream_t st) {
  auto kern = flash_decode_gqa<T, DH, NT>;
  size_t smem;
  if constexpr (DH > 0)
    smem = ds::TcShape<T, DH>::template smem<NT>();
  else
    smem = ds::cc_smem<T>(geo.rows, geo.dh);
  // raise the dynamic shared-memory cap once per size (before any graph
  // capture: the first call of a shape is never captured)
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  const dim3 grid(geo.n_splits, geo.hkv * geo.n_groups, b);
  kern<<<grid, ds::kThreads, smem, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), static_cast<T*>(out), ml,
                                         acc, geo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || geo.n_splits == 1) return err;
  // the merge as a programmatic dependent launch: its blocks are scheduled
  // while the split kernel runs, hiding the second launch's latency
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(geo.hq, b);
  cfg.blockDim = dim3(ds::kThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, flash_decode_merge<T>, static_cast<const float*>(ml),
                            static_cast<const float*>(acc), static_cast<T*>(out), geo.idx_ptr,
                            geo.idx_scalar, geo.hq, geo.s_max, geo.dh, geo.chunk,
                            geo.n_splits);
}

// bf16/fp16: the tensor-core body, n-tiles of 8 query rows as kernel B picks
// them (rows * Dh <= 2048: up to 4 n-tiles at Dh 64, 2 at 128, 1 at 256)
template <typename T>
cudaError_t dispatch_gqa_half(const void* q, const void* k, const void* v, void* out,
                              float* ml, float* acc, const GqaGeometry& geo, int b,
                              cudaStream_t st) {
  const int nt = (geo.rows + 7) / 8;
  switch (geo.dh) {
    case 64:
      if (nt == 1) return launch_gqa<T, 64, 1>(q, k, v, out, ml, acc, geo, b, st);
      if (nt == 2) return launch_gqa<T, 64, 2>(q, k, v, out, ml, acc, geo, b, st);
      return launch_gqa<T, 64, 4>(q, k, v, out, ml, acc, geo, b, st);
    case 128:
      if (nt == 1) return launch_gqa<T, 128, 1>(q, k, v, out, ml, acc, geo, b, st);
      return launch_gqa<T, 128, 2>(q, k, v, out, ml, acc, geo, b, st);
    case 256:
      return launch_gqa<T, 256, 1>(q, k, v, out, ml, acc, geo, b, st);
  }
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_gqa(const void* q, const void* k, const void* v, void* out, float* ml,
                         float* acc, GqaGeometry geo, int b, int dtype, cudaStream_t st) {
  // a block's query rows: rows * Dh <= kThreads * kMaxPerThread (both bodies)
  const int rep = geo.hq / geo.hkv;
  geo.rows = min(rep, ds::kThreads * ds::kMaxPerThread / geo.dh);
  geo.n_groups = (rep + geo.rows - 1) / geo.rows;
  if (geo.hkv * geo.n_groups > 65535) return cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      return launch_gqa<float, 0, 0>(q, k, v, out, ml, acc, geo, b, st);
    case kF16:
      return dispatch_gqa_half<__half>(q, k, v, out, ml, acc, geo, b, st);
    case kBF16:
      return dispatch_gqa_half<__nv_bfloat16>(q, k, v, out, ml, acc, geo, b, st);
  }
  return cudaErrorInvalidValue;
}

// --------------------------------------------------------------- rep == 1
namespace mha {

constexpr int kPos = 32;  // positions per ring stage: one per lane

// W consumer warps, each owning SPW slots of a W * SPW-stage ring (so a
// slot's phases are always waited on in order by one warp); a stage is the
// K and V rows of 32 positions, as 128-byte panels (Dh * sizeof(T) / 128 of
// them, 32 rows each) in the 128-byte swizzle.
template <typename T, int DH>
struct Shape {
  static constexpr int kPanelElems = 128 / (int)sizeof(T);
  static constexpr int kPanels = DH / kPanelElems;
  static constexpr int kPanelBytes = kPos * 128;
  static constexpr int kTileBytes = kPanels * kPanelBytes;    // K (or V) of a stage
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int W = 4 * kStageBytes <= 128 * 1024 ? 4 : 2;
  static constexpr int SPW = 2 * W * kStageBytes <= 64 * 1024 ? 2 : 1;
  static constexpr int kStages = W * SPW;
  static constexpr int kThreads = 32 * (W + 1);
  static constexpr int kEpl = DH / 32;                        // V columns per lane
  static constexpr int kQOff = kStages * kStageBytes;         // q as f32 [DH]
  static constexpr int kMlOff = kQOff + DH * 4;               // warps' (m, l) [W][2]
  static constexpr int kAccOff = kMlOff + W * 8;              // warps' acc [W][DH]
  static constexpr int kBarOff = kAccOff + W * DH * 4;
  static constexpr size_t smem() { return 1024 + kBarOff + 16 * kStages; }
};

// Grid (split, head, slot). The block streams the K and V rows of its split
// of the valid prefix [c0, c1) through the ring (one producer thread, TMA);
// consumer warp w takes stages w, w + W, ...: lane l scores position
// 32 st + l over the whole row (K row in registers 16 bytes at a time, q
// from shared memory as f32: no cross-lane sum), the warp's online softmax
// moves by one max per stage, and P.V runs with each lane owning Dh / 32
// columns, p broadcast from its lane.
template <typename T, int DH>
__global__ void __launch_bounds__(Shape<T, DH>::kThreads)
flash_decode_mha(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                 const T* __restrict__ q, T* __restrict__ out, float* __restrict__ part_ml,
                 float* __restrict__ part_acc, const int* __restrict__ idx_ptr, int idx_scalar,
                 int hq, int s_max, int chunk, int n_splits, float scale) {
  using namespace dst::hopper;
  using S = Shape<T, DH>;
  constexpr int W = S::W, SPW = S::SPW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* q_sh = reinterpret_cast<float*>(base + S::kQOff);
  float* ml_sh = reinterpret_cast<float*>(base + S::kMlOff);
  float* acc_sh = reinterpret_cast<float*>(base + S::kAccOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S::kBarOff);
  uint64_t* empty = full + S::kStages;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = (size_t)b * hq + h;  // the query row, and its cache head
  const int n_pos = valid_positions(idx_ptr, idx_scalar, s_max);
  const int c0 = split * chunk;
  // let the merge launch now (it waits for this grid to end before reading)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (c0 >= n_pos) {  // past idx: nothing to read
    if (n_splits == 1)  // no positions at all: the reference's 0 / 1e-20
      for (int i = tid; i < DH; i += S::kThreads) out[row * DH + i] = from_f32<T>(0.f);
    return;
  }
  const int c1 = min(c0 + chunk, n_pos);
  const int n_st = (c1 - c0 + kPos - 1) / kPos;

  // The producer thread sets up the ring and requests its first stages at
  // once; the consumers stage q meanwhile.
  // K and V are read once: evict them from the L2 first
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  const auto issue = [&](int st) {
    const int w = st % W, j = st / W, slot = w + W * (j % SPW);
    if (j >= SPW) mbar_wait(&empty[slot], ((j / SPW) - 1) & 1);
    unsigned char* sb = base + slot * S::kStageBytes;
    const int p0 = c0 + st * kPos;
    mbar_expect_tx(&full[slot], S::kStageBytes);
#pragma unroll
    for (int pn = 0; pn < S::kPanels; ++pn) {
      tma_load_3d_hint(sb + pn * S::kPanelBytes, &kmap, &full[slot], pn * S::kPanelElems, p0,
                       (int)row, policy);
      tma_load_3d_hint(sb + S::kTileBytes + pn * S::kPanelBytes, &vmap, &full[slot],
                       pn * S::kPanelElems, p0, (int)row, policy);
    }
  };
  const int first = min(n_st, S::kStages);
  if (tid == 32 * W) {
    for (int i = 0; i < S::kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 1);
    }
    mbar_fence_init();
    for (int st = 0; st < first; ++st) issue(st);
  }
  if (warp < W)
    for (int i = tid; i < DH; i += 32 * W) q_sh[i] = to_f32(q[row * DH + i]);
  __syncthreads();

  if (warp == W) {  // ----------------------------------------------- producer
    if (lane == 0)
      for (int st = first; st < n_st; ++st) issue(st);
    return;
  }

  // --------------------------------------------------------------- consumers
  float m = -CUDART_INF_F, l = 0.f, acc[S::kEpl];
#pragma unroll
  for (int e = 0; e < S::kEpl; ++e) acc[e] = 0.f;
  // this lane's P.V columns: kEpl elements from column lane * kEpl
  constexpr int kVBytes = S::kEpl * (int)sizeof(T);
  constexpr int kVLoad = kVBytes < 16 ? kVBytes : 16;
  const int vcol = lane * kVBytes;  // byte offset in the row
  for (int st = warp; st < n_st; st += W) {
    const int j = st / W, slot = warp + W * (j % SPW);
    mbar_wait(&full[slot], (j / SPW) & 1);
    const unsigned char* kt = base + slot * S::kStageBytes;
    const unsigned char* vt = kt + S::kTileBytes;
    // score of position c0 + 32 st + lane: its K row against q
    float sc = 0.f;
#pragma unroll
    for (int pn = 0; pn < S::kPanels; ++pn) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(kt + pn * S::kPanelBytes + sw128(lane, 16 * c));
        const T* kv = reinterpret_cast<const T*>(&raw);
        const float* qc = q_sh + pn * S::kPanelElems + c * (16 / (int)sizeof(T));
#pragma unroll
        for (int i = 0; i < 16 / (int)sizeof(T); ++i) sc = fmaf(qc[i], to_f32(kv[i]), sc);
      }
    }
    const int pos = c0 + st * kPos + lane;
    const float s = pos < c1 ? sc * scale : -CUDART_INF_F;
    const float m_new = fmaxf(m, warp_max(s));  // finite: lane 0's position is live
    const float corr = expf(m - m_new);         // 0 on the warp's first stage
    const float p = expf(s - m_new);            // 0 past c1
    l = fmaf(l, corr, p);
#pragma unroll
    for (int e = 0; e < S::kEpl; ++e) acc[e] *= corr;
    m = m_new;
    // P.V: position r's V row, this lane's columns, in position order
#pragma unroll 4
    for (int r = 0; r < kPos; ++r) {
      const float pr = __shfl_sync(0xffffffffu, p, r);
      const unsigned char* vrow = vt + (vcol / 128) * S::kPanelBytes;
#pragma unroll
      for (int cb = 0; cb < kVBytes; cb += kVLoad) {
        const int bb = vcol % 128 + cb;
        const T* vv;
        uint4 raw16;
        uint2 raw8;
        uint32_t raw4;
        if constexpr (kVLoad == 16) {
          raw16 = *reinterpret_cast<const uint4*>(vrow + sw128(r, bb));
          vv = reinterpret_cast<const T*>(&raw16);
        } else if constexpr (kVLoad == 8) {
          raw8 = *reinterpret_cast<const uint2*>(vrow + sw128(r, bb));
          vv = reinterpret_cast<const T*>(&raw8);
        } else {
          raw4 = *reinterpret_cast<const uint32_t*>(vrow + sw128(r, bb));
          vv = reinterpret_cast<const T*>(&raw4);
        }
#pragma unroll
        for (int i = 0; i < kVLoad / (int)sizeof(T); ++i) {
          const int e = cb / (int)sizeof(T) + i;
          acc[e] = fmaf(pr, to_f32(vv[i]), acc[e]);
        }
      }
    }
    // this warp's reads of the slot, before the TMA refill (async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  }

  // merge the warps in warp order (a warp with no stage: m = -inf, l = 0)
  const float lw = warp_sum(l);
  if (lane == 0) {
    ml_sh[2 * warp] = m;
    ml_sh[2 * warp + 1] = lw;
  }
#pragma unroll
  for (int e = 0; e < S::kEpl; ++e) acc_sh[warp * DH + lane * S::kEpl + e] = acc[e];
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * W) : "memory");
  float mm = -CUDART_INF_F;
#pragma unroll
  for (int w = 0; w < W; ++w) mm = fmaxf(mm, ml_sh[2 * w]);  // finite: warp 0 has stage 0
  for (int d = tid; d < DH; d += 32 * W) {
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float c = expf(ml_sh[2 * w] - mm);
      ll = fmaf(ml_sh[2 * w + 1], c, ll);
      aa = fmaf(acc_sh[w * DH + d], c, aa);
    }
    if (n_splits == 1) {
      out[row * DH + d] = from_f32<T>(aa / fmaxf(ll, 1e-20f));
    } else {
      const size_t slot = row * n_splits + split;
      part_acc[slot * DH + d] = aa;
      if (d == 0) {
        part_ml[2 * slot] = mm;
        part_ml[2 * slot + 1] = ll;
      }
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* ml,
                   float* acc, const int* idx_ptr, int idx_scalar, int b, int hq, int s_max,
                   int chunk, int n_splits, float scale, cudaStream_t st) {
  using namespace dst::hopper;
  using S = Shape<T, DH>;
  CUtensorMap kmap, vmap;
  const cuuint64_t dims[3] = {(cuuint64_t)DH, (cuuint64_t)s_max, (cuuint64_t)b * hq};
  const cuuint64_t strides[2] = {(cuuint64_t)DH * sizeof(T), (cuuint64_t)s_max * DH * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)S::kPanelElems, kPos, 1};
  cudaError_t err;
  if ((err = swizzled_map(&kmap, map_type<T>(), 3, k, dims, strides, box)) != cudaSuccess ||
      (err = swizzled_map(&vmap, map_type<T>(), 3, v, dims, strides, box)) != cudaSuccess)
    return err;
  auto kern = flash_decode_mha<T, DH>;
  constexpr size_t smem = S::smem();
  static bool allowed = false;  // raised once, before any graph capture
  if (!allowed) {
    if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)) != cudaSuccess)
      return err;
    allowed = true;
  }
  kern<<<dim3(n_splits, hq, b), S::kThreads, smem, st>>>(
      kmap, vmap, static_cast<const T*>(q), static_cast<T*>(out), ml, acc, idx_ptr, idx_scalar,
      hq, s_max, chunk, n_splits, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  // kernel B's merge under flash-decode's name, as a programmatic dependent
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(hq, b);
  cfg.blockDim = dim3(ds::kThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, flash_decode_merge<T>, static_cast<const float*>(ml),
                            static_cast<const float*>(acc), static_cast<T*>(out), idx_ptr,
                            idx_scalar, hq, s_max, DH, chunk, n_splits);
}

template <typename T>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v, void* out, float* ml,
                        float* acc, const int* iv, int idx_scalar, int b, int hq, int s_max,
                        int dh, int chunk, int n_splits, float scale, cudaStream_t st) {
  switch (dh) {
    case 64:
      return launch<T, 64>(q, k, v, out, ml, acc, iv, idx_scalar, b, hq, s_max, chunk,
                           n_splits, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, out, ml, acc, iv, idx_scalar, b, hq, s_max, chunk,
                            n_splits, scale, st);
    case 256:
      return launch<T, 256>(q, k, v, out, ml, acc, iv, idx_scalar, b, hq, s_max, chunk,
                            n_splits, scale, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace mha

cudaError_t dispatch_mha(const void* q, const void* k, const void* v, void* out, float* ml,
                         float* acc, const int* iv, int idx_scalar, int b, int hq, int s_max,
                         int dh, int chunk, int n_splits, float scale, int dtype,
                         cudaStream_t st) {
  if (chunk % mha::kPos) return cudaErrorInvalidValue;  // whole stages per split
  switch (dtype) {
    case kF32:
      return mha::dispatch_dh<float>(q, k, v, out, ml, acc, iv, idx_scalar, b, hq, s_max, dh,
                                     chunk, n_splits, scale, st);
    case kF16:
      return mha::dispatch_dh<__half>(q, k, v, out, ml, acc, iv, idx_scalar, b, hq, s_max, dh,
                                      chunk, n_splits, scale, st);
    case kBF16:
      return mha::dispatch_dh<__nv_bfloat16>(q, k, v, out, ml, acc, iv, idx_scalar, b, hq,
                                             s_max, dh, chunk, n_splits, scale, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B, Hq, Dh]; k/v caches [B, Hkv, S, Dh] holding the new token at idx;
// out [B, Hq, Dh]. idx: one int32 on the device, or null with idx_scalar.
// With n_splits = ceil(S / chunk) > 1, ml [B, Hq, n_splits, 2] and
// acc [B, Hq, n_splits, Dh] f32 are the splits' partials (scratch).
// mha = 0: the GQA computation (rep >= 2, p rounded to the cache dtype;
// decode_split.cuh's body); mha = 1: the rep == 1 kernel (all f32).
extern "C" int dst_flash_decode(const void* q, const void* k, const void* v, void* out,
                                void* ml, void* acc, const void* idx, int idx_scalar,
                                int b, int hq, int hkv, int s_max, int dh, int chunk,
                                int n_splits, float scale, int dtype, int mha,
                                void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || (mha != 0) != (hq == hkv) || s_max <= 0 ||
      (dh != 64 && dh != 128 && dh != 256) || b <= 0 || b > 65535 || chunk <= 0 ||
      n_splits != (s_max + chunk - 1) / chunk ||
      (n_splits > 1 && (ml == nullptr || acc == nullptr)))
    return cudaErrorInvalidValue;
  const int* iv = static_cast<const int*>(idx);
  float* mlf = static_cast<float*>(ml);
  float* accf = static_cast<float*>(acc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mha)
    return dispatch_mha(q, k, v, out, mlf, accf, iv, idx_scalar, b, hq, s_max, dh, chunk,
                        n_splits, scale, dtype, st);
  const GqaGeometry geo{iv, idx_scalar, hq, hkv, s_max, dh, chunk, n_splits, 0, 0, scale};
  return dispatch_gqa(q, k, v, out, mlf, accf, geo, b, dtype, st);
}

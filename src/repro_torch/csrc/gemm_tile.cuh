// The tile loops shared by the port's GEMM kernels (matmul.cu, ag_gemm.cu,
// gemm_rs.cu).  Each output tile owns its whole K sum (no split-K),
// accumulated in fp32 registers and cast once at the store.
//
//   * bf16: WgmmaTile and wgmma_gemm, a persistent warp-specialised loop
//     on Hopper's tensor memory accelerator and wgmma (hopper.cuh).
//   * fp32: F32Tile on the CUDA cores (no TF32, which would not meet the
//     fp32 tolerance): 128 x 128 tiles, K steps of 8, 8 x 8 outputs a
//     thread, A staged transposed, read with ld.global.cg; its A rows come
//     through a row functor `a_row(r)` (nullptr: a zero row).
//
// What bounds the bf16 GEMMs: at the op-level shapes (GPT-3 175B at TP 8,
// [m, 12288] x [12288, 6144] and [m, 6144] x [6144, 12288]) the tensor
// cores from m 512 up (~295 FLOP a byte is the H100's ridge), the bytes of
// B at decode m.  A loop of mma.sync m16n8k16, ldmatrix and cp.async
// reached 31 % of that bound; the tensor cores' full rate needs wgmma fed
// by TMA.
//
// Design of wgmma_gemm:
//   * A persistent grid, one CTA a resident slot (fewer under the
//     AG-GEMM's grid bound), walks the output tiles t = blockIdx.x,
//     + gridDim.x, ... in tile_coords' raster (groups of up to kGroupM
//     tile rows, column-major inside a group: the CTAs in flight share B
//     column panels and A row panels in L2).  A group never straddles two
//     row blocks, so the blocks' tiles come in walk order: the AG-GEMM's
//     local shard first (kernels/matmul.py::raster_group).
//   * Warp specialisation: one producer warpgroup (setmaxnreg gives its
//     registers to the consumers), of which one thread issues every TMA
//     load into a STAGES-deep ring of (A, B) stages, each with a full and
//     an empty mbarrier; WGM consumer warpgroups of 64 rows each run
//     wgmma m64nBNk16 from shared memory, one k-step's group in flight
//     while the previous stage goes back to the producer.  The ring runs
//     on across tiles, so the producer loads the next tile while the
//     consumers store this one.
//   * A [rows, K] is K-major: boxes of 64 columns x box_rows rows, 128-byte
//     swizzle.  B [K, N] is N-contiguous: boxes of 64 K-rows x 64 columns
//     (one swizzle atom wide), read by wgmma with the transpose bit.
//   * Rows.  The caller's A is `shards` row blocks of m_sh rows each (one
//     for a plain GEMM; the ranks' shards for the AG-GEMM; the owners'
//     row blocks for GEMM-RS), walked in the caller's order (Op::shard).
//     Each block is padded to m_pad virtual rows: m_pad a multiple of BM
//     when m_sh >= BM (a tile never straddles two blocks), else a power of
//     two >= m_sh that divides BM (several blocks pack into one tile, one
//     box each).  The A tensor map is 3-D [shards, m_sh, K] with box
//     height box_rows = min(m_pad, BM): rows past m_sh zero-fill, and no
//     box reads another block's rows.  kernels/matmul.py::walk_args picks
//     (m_pad, box_rows) and the raster's group.
//   * Op (the kernel's): shard(s) / local(s), the map index of walk
//     position s and whether it is read through the second map; wait(s0,
//     s1), run by the producer before a tile's first load (the AG-GEMM's
//     flag wait); store(s, r, col, x, y), the epilogue of rows r < m_sh.
//   * Ragged edges: a K tail and columns past N zero-fill in TMA; boxes
//     wholly past the last block or past N are not loaded (the rows and
//     columns they would feed are not stored).  K and N must be multiples
//     of 8 and the bases 16-byte aligned (TMA's strides); the wrappers
//     check both.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace tile {

constexpr int kGroupM = 8;   // tile rows per raster group (L2 reuse)

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// The (tile row, tile column) of linear tile `pid`: tiles are numbered in
// groups of `group` tile rows, column-major inside a group, so the blocks
// in flight share A row panels and B column panels in L2
// (kernels/matmul.py::tile_coords mirrors it).
__device__ __forceinline__ void tile_coords(int pid, int tiles_m, int tiles_n,
                                            int* tm, int* tn,
                                            int group = kGroupM) {
  const int per_group = group * tiles_n;
  const int first_m = (pid / per_group) * group;
  const int group_m = min(tiles_m - first_m, group);
  *tm = first_m + (pid % per_group) % group_m;
  *tn = (pid % per_group) / group_m;
}

// Epilogue activations on the fp32 value (codes shared with the wrappers):
// 0 none, 1 silu, 2 gelu (tanh approximation, as jax.nn.gelu), 3 relu,
// 4 squared relu.
__device__ __forceinline__ float activate(int act, float x) {
  switch (act) {
    case 1: return x / (1.f + expf(-x));
    case 2: {
      const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
      return 0.5f * x * (1.f + tanhf(u));
    }
    case 3: return fmaxf(x, 0.f);
    case 4: { const float r = fmaxf(x, 0.f); return r * r; }
    default: return x;
  }
}

// ---------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------
// WGM consumer warpgroups (BM = 64 WGM rows), BN columns, K steps of 64,
// STAGES ring stages; PREGS / CREGS the producer's and consumers' register
// counts after setmaxnreg (0: not used).
template <int WGM, int BN, int STAGES, int PREGS, int CREGS>
struct WgmmaTile {
  static constexpr int kBM = 64 * WGM, kBN = BN, kBK = 64;
  static constexpr int kWGM = WGM, kStages = STAGES;
  static constexpr int kPRegs = PREGS, kCRegs = CREGS;
  static constexpr int kThreads = 128 * (WGM + 1);
  static constexpr int A_BYTES = kBM * kBK * 2;
  static constexpr int B_BYTES = kBK * BN * 2;
  static constexpr int kSmem = 1024 + STAGES * (A_BYTES + B_BYTES)
                               + 2 * STAGES * 8;
  static_assert(BN % 64 == 0 && BN <= 256, "wgmma n");
  static_assert(STAGES >= 2, "ring depth");
};

// The bf16 tiles the wrappers pick between (kernels/matmul.py TILES,
// plan_blocks), set from scripts/torch_gemm_configs.py's sweep at the
// op-level shapes, where 128 x 128 tiles were never the fastest: 0 =
// 128 x 256 (large m), 3 stages (4 were 2 % faster alone but slower with
// eight ranks' GEMMs on one card: scripts/torch_kernel_ab.py); 1 = 64 x 64,
// 6 stages (small m, bytes-bound on B; two CTAs an SM).
using LargeTile = WgmmaTile<2, 256, 3, 40, 232>;
using SmallTile = WgmmaTile<1, 64, 6, 0, 0>;

// The rows of A (see the note at the top), the product's N and K, and the
// raster's group of tile rows.
struct Walk {
  int m_sh, m_pad, box_rows, shards, n, k, group_m;
};

template <class Cfg, class Op>
__device__ __forceinline__ void wgmma_gemm(const CUtensorMap* a_map,
                                           const CUtensorMap* a_local,
                                           const CUtensorMap* b_map,
                                           const Walk& w, const Op& op) {
  using T = __nv_bfloat16;
  constexpr int BM = Cfg::kBM, BN = Cfg::kBN, BK = Cfg::kBK;
  constexpr int ST = Cfg::kStages, WGM = Cfg::kWGM;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  T* as = reinterpret_cast<T*>(smem);                 // [ST][BM][BK]
  T* bs = as + ST * BM * BK;                          // [ST][BN/64][BK][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(bs + ST * BK * BN);
  uint64_t* empty = full + ST;
  const int tiles_m = cdiv(w.shards * w.m_pad, BM);
  const int tiles_n = cdiv(w.n, BN);
  const int tiles = tiles_m * tiles_n;
  const int nk = cdiv(w.k, BK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      hopper::bar_init(full + s, 1);
      hopper::bar_init(empty + s, 4 * WGM);   // lane 0 of each consumer warp
    }
    hopper::bar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == WGM) {
    // ---- producer ----
    if constexpr (Cfg::kPRegs > 0) hopper::regs_dealloc<Cfg::kPRegs>();
    if (threadIdx.x != WGM * 128) return;
    hopper::prefetch_map(a_map);
    hopper::prefetch_map(a_local);
    hopper::prefetch_map(b_map);
    const int boxes = BM / w.box_rows;
    int stage = 0, phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int tm, tn;
      tile_coords(t, tiles_m, tiles_n, &tm, &tn, w.group_m);
      const int g0 = tm * BM, n0 = tn * BN;
      op.wait(g0 / w.m_pad, min((g0 + BM - 1) / w.m_pad, w.shards - 1));
      int a_boxes = 0;    // boxes of this tile inside the blocks
      while (a_boxes < boxes &&
             (g0 + a_boxes * w.box_rows) / w.m_pad < w.shards)
        ++a_boxes;
      const int b_boxes = min(BN / 64, cdiv(w.n - n0, 64));
      const uint32_t bytes =
          (a_boxes * w.box_rows + b_boxes * 64) * BK * 2;
      for (int kt = 0; kt < nk; ++kt) {
        hopper::bar_wait(empty + stage, phase ^ 1);
        hopper::bar_expect(full + stage, bytes);
        T* a_st = as + stage * BM * BK;
        T* b_st = bs + stage * BK * BN;
        for (int i = 0; i < a_boxes; ++i) {
          const int v = g0 + i * w.box_rows;
          const int s = v / w.m_pad;
          hopper::tma_load_3d(a_st + i * w.box_rows * BK,
                              op.local(s) ? a_local : a_map, full + stage,
                              kt * BK, v - s * w.m_pad, op.shard(s));
        }
        for (int j = 0; j < b_boxes; ++j)
          hopper::tma_load_2d(b_st + j * BK * 64, b_map, full + stage,
                              n0 + 64 * j, kt * BK);
        if (++stage == ST) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of a tile --
  if constexpr (Cfg::kCRegs > 0) hopper::regs_alloc<Cfg::kCRegs>();
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x / 32) & 3;
  float acc[BN / 2];
  int stage = 0, phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int tm, tn;
    tile_coords(t, tiles_m, tiles_n, &tm, &tn, w.group_m);
    const int g0 = tm * BM, n0 = tn * BN;
    int prev = 0;
    for (int kt = 0; kt < nk; ++kt) {
      hopper::bar_wait(full + stage, phase);
      hopper::wgmma_fence();
      if (kt == 0) hopper::fence_regs(acc);
      const uint64_t da = hopper::desc(
          as + stage * BM * BK + wg * 64 * BK, 16, 1024);
      const uint64_t db = hopper::desc(bs + stage * BK * BN, BK * 128, 1024);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        hopper::wgmma_ss<BN, 1>(acc, da + 2 * kk, db + 128 * kk,
                                kt > 0 || kk > 0);
      hopper::wgmma_commit();
      if (kt > 0) {
        hopper::wgmma_wait<1>();           // step kt - 1 is done
        if (lane == 0) hopper::bar_arrive(empty + prev);
      }
      prev = stage;
      if (++stage == ST) { stage = 0; phase ^= 1; }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (lane == 0) hopper::bar_arrive(empty + prev);

    // accumulator (jb, h): row 16 warp + lane / 4 + 8 h of the warpgroup's
    // 64, columns 8 jb + 2 (lane % 4) and + 1
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = g0 + wg * 64 + warp * 16 + lane / 4 + 8 * h;
      const int s = v / w.m_pad;
      const int r = v - s * w.m_pad;
      if (s >= w.shards || r >= w.m_sh) continue;
#pragma unroll
      for (int jb = 0; jb < BN / 8; ++jb) {
        const int col = n0 + 8 * jb + 2 * (lane & 3);
        if (col < w.n)
          op.store(s, r, col, acc[4 * jb + 2 * h], acc[4 * jb + 2 * h + 1]);
      }
    }
  }
}

// A as `shards` row blocks [shards, m_sh, k] (row-major), boxes of 64
// columns x box_rows rows
inline cudaError_t a_map(CUtensorMap* map, const void* base, int k, int m_sh,
                         int shards, int box_rows) {
  const uint64_t dims[3] = {(uint64_t)k, (uint64_t)m_sh, (uint64_t)shards};
  const uint64_t strides[2] = {(uint64_t)k * 2, (uint64_t)m_sh * k * 2};
  const uint32_t box[3] = {64, (uint32_t)box_rows, 1};
  return hopper::make_map(map, base, 3, dims, strides, box);
}

// B [k, n] (row-major), boxes of 64 K-rows x 64 columns
inline cudaError_t b_map(CUtensorMap* map, const void* base, int k, int n) {
  const uint64_t dims[2] = {(uint64_t)n, (uint64_t)k};
  const uint64_t strides[1] = {(uint64_t)n * 2};
  const uint32_t box[2] = {64, 64};
  return hopper::make_map(map, base, 2, dims, strides, box);
}

// The persistent grid: every resident CTA slot of the card, at most one a
// tile; when `share` ranks run on one card at once (share > 1), 1/share of
// the slots less `reserved` (kernels/matmul.py::persistent_grid mirrors
// it).
template <class Kernel>
cudaError_t persistent_grid(Kernel kern, int threads, int smem, int tiles,
                            int share, int reserved, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, threads, smem)) != cudaSuccess)
    return e;
  int slots = per_sm * sms;
  if (share > 1) slots = (slots - reserved) / share;
  *grid = slots < 1 ? 1 : (slots < tiles ? slots : tiles);
  return cudaSuccess;
}

struct F32Tile {
  using T = float;
  static constexpr int kBM = 128, kBN = 128, kBK = 8;
  static constexpr int kThreads = 256;
  static constexpr int kSmem = kBK * (kBM + 4) * 4 + kBK * kBN * 4;

  float acc[8][8];

  template <class ARow>
  __device__ __forceinline__ void run(ARow a_row, const float* __restrict__ b,
                                      int n, int k, int n0,
                                      unsigned char* smem) {
    float (*as)[kBM + 4] = reinterpret_cast<float (*)[kBM + 4]>(smem);  // A^T
    float (*bs)[kBN] = reinterpret_cast<float (*)[kBN]>(
        smem + kBK * (kBM + 4) * 4);
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    // one float4 of A (row ar, k ak..ak+3) and of B (k br, columns
    // bc..bc+3) a thread for each K step; k % 4 == 0 and n % 4 == 0, so a
    // float4 is wholly in range or out of it
    const int ar = tid / 2, ak = (tid % 2) * 4;
    const int br = tid / 32, bc = (tid % 32) * 4;
    const float* arow = a_row(ar);

#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < k; k0 += kBK) {
      float4 av = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 bv = av;
      if (arow != nullptr && k0 + ak < k)
        av = __ldcg(reinterpret_cast<const float4*>(arow + k0 + ak));
      if (k0 + br < k && n0 + bc < n)
        bv = *reinterpret_cast<const float4*>(b + (int64_t)(k0 + br) * n
                                              + n0 + bc);
      __syncthreads();   // the previous step's reads are done
      as[ak + 0][ar] = av.x;
      as[ak + 1][ar] = av.y;
      as[ak + 2][ar] = av.z;
      as[ak + 3][ar] = av.w;
      *reinterpret_cast<float4*>(&bs[br][bc]) = bv;
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&as[kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&bs[kk][64 + tx * 4]);
        const float ra[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float rb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // thread rows ty*4 + i and 64 + ty*4 + i, columns tx*4 + j and
  // 64 + tx*4 + j
  template <class Store>
  __device__ __forceinline__ void emit(int rows, int n, int n0,
                                       Store store) const {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4;
      if (r >= rows) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = n0 + h * 64 + tx * 4;
        if (col >= n) continue;
        store(r, col, acc[i][4 * h], acc[i][4 * h + 1]);
        store(r, col + 2, acc[i][4 * h + 2], acc[i][4 * h + 3]);
      }
    }
  }
};


// Set the dynamic shared memory a kernel needs above the default 48 KB.
template <class Kernel>
cudaError_t allow_smem(Kernel kern, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace tile

// Dense GEMM for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/matmul.py::_matmul_kernel (wrapper matmul,
// the Pallas TPU kernel behind kernels/ops.py::matmul, "the best non-split
// GEMM": GEMM_non-split of the paper's ECT metric, Eq. 1, and the
// single-device branch of both fused-collective wrappers).
//
// Computes what the TPU kernel computes, for row-major A [M, K] and B [K, N]
// of one input type (bf16 or fp32): C = A @ B accumulated in fp32 and cast
// once, at the store, to the output type (bf16 or fp32).  One block owns an
// output tile's whole K sum (no split-K), so the result is deterministic.
//
// What bounds it on the card: at the op-level shapes (GPT-3 175B at TP 8,
// [m, 12288] x [12288, 6144] and [m, 6144] x [6144, 12288], bf16) the work
// is operations-bound from m = 512 up (2 m n k FLOP against 2 (mk + kn + mn)
// bytes; 989 TFLOP/s over 3.35 TB/s is ~295 FLOP a byte) and bytes-bound at
// m = 64, where the weight B is read once in ~0.045 ms.
//
// Design (not the TPU's 256 x 512 x 256 VMEM blocks carried over):
//   * bf16: gemm_tile.cuh's wgmma_gemm with A as one row block: a
//     persistent grid (every resident CTA slot, at most one a tile) walks
//     the output tiles in groups of tile rows (L2 reuse); in each CTA a
//     producer thread keeps a ring of TMA loads (A K-major, B
//     N-contiguous, both with the 128-byte swizzle) in flight and two
//     consumer warpgroups run wgmma m64n256k16 on 128 x 256 tiles (K
//     steps of 64, three stages), or, for small M, where those tiles leave
//     half the SMs idle, one warpgroup runs m64n64k16 on 64 x 64 tiles with
//     six stages, two CTAs an SM (kernels/matmul.py::plan_blocks).  The
//     TPU's sequential K grid axis becomes the loop over the ring.  A
//     loop of mma.sync, ldmatrix and cp.async reached 31 % of the bound;
//     the tensor cores' full rate needs wgmma fed by TMA.
//   * fp32: the CUDA cores (no TF32, which would not meet the fp32
//     tolerance): gemm_tile.cuh's F32Tile, one block a 128 x 128 tile.
//   * Ragged edges: rows past M, columns past N and a K tail zero-fill on
//     load (TMA's out-of-bounds fill; F32Tile's masked loads) and are
//     masked on store (the TPU kernel needs block multiples).  K and N
//     must be multiples of 8 (bf16) or 4 (fp32), and the bases 16-byte
//     aligned; the wrapper checks both.
// The launch goes on the caller's stream; nothing is allocated or
// synchronised here.  The function returns cudaGetLastError().

#include "gemm_tile.cuh"

namespace {

// bf16: C = A @ B through wgmma_gemm with one row block of M rows
template <typename OutT>
struct MmOp {
  OutT* c;
  int n;

  __device__ int shard(int) const { return 0; }
  __device__ bool local(int) const { return false; }
  __device__ void wait(int, int) const {}
  __device__ void store(int, int r, int col, float x, float y) const {
    tile::store2(c + (int64_t)r * n + col, x, y);
  }
};

template <class Cfg, typename OutT>
__global__ void __launch_bounds__(Cfg::kThreads, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap a,
                  const __grid_constant__ CUtensorMap b, const tile::Walk w,
                  const MmOp<OutT> op) {
  tile::wgmma_gemm<Cfg>(&a, &a, &b, w, op);
}

template <class Cfg, typename OutT>
cudaError_t launch_wgmma(const void* a, const void* b, void* c, int m, int n,
                         int k, int m_pad, int box_rows, int group_m,
                         cudaStream_t stream) {
  CUtensorMap am, bm;
  cudaError_t e;
  if ((e = tile::a_map(&am, a, k, m, 1, box_rows)) != cudaSuccess ||
      (e = tile::b_map(&bm, b, k, n)) != cudaSuccess)
    return e;
  auto kern = gemm_wgmma_kernel<Cfg, OutT>;
  if ((e = tile::allow_smem(kern, Cfg::kSmem)) != cudaSuccess) return e;
  const int tiles = tile::cdiv(m_pad, Cfg::kBM) * tile::cdiv(n, Cfg::kBN);
  int grid = 0;
  if ((e = tile::persistent_grid(kern, Cfg::kThreads, Cfg::kSmem, tiles, 1,
                                 0, &grid)) != cudaSuccess)
    return e;
  const tile::Walk w{m, m_pad, box_rows, 1, n, k, group_m};
  kern<<<grid, Cfg::kThreads, Cfg::kSmem, stream>>>(
      am, bm, w, MmOp<OutT>{static_cast<OutT*>(c), n});
  return cudaGetLastError();
}

// fp32: one block a tile
template <typename OutT>
__global__ void __launch_bounds__(tile::F32Tile::kThreads)
gemm_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                OutT* __restrict__ c, int m, int n, int k) {
  using Tile = tile::F32Tile;
  extern __shared__ __align__(16) unsigned char smem[];
  int tm, tn;
  tile::tile_coords(blockIdx.x, tile::cdiv(m, Tile::kBM),
                    tile::cdiv(n, Tile::kBN), &tm, &tn);
  const int m0 = tm * Tile::kBM, n0 = tn * Tile::kBN;
  Tile t;
  t.run([&](int r) {
          return m0 + r < m ? a + (int64_t)(m0 + r) * k : nullptr;
        }, b, n, k, n0, smem);
  t.emit(m - m0, n, n0, [&](int r, int col, float x, float y) {
    tile::store2(c + (int64_t)(m0 + r) * n + col, x, y);
  });
}

template <typename OutT>
cudaError_t launch_f32(const void* a, const void* b, void* c, int m, int n,
                       int k, cudaStream_t stream) {
  using Tile = tile::F32Tile;
  auto kern = gemm_f32_kernel<OutT>;
  const cudaError_t e = tile::allow_smem(kern, Tile::kSmem);
  if (e != cudaSuccess) return e;
  const int tiles = tile::cdiv(m, Tile::kBM) * tile::cdiv(n, Tile::kBN);
  kern<<<tiles, Tile::kThreads, Tile::kSmem, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<OutT*>(c), m, n, k);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_bf16_tile(int tile_code, const void* a, const void* b,
                             void* c, int m, int n, int k, int m_pad,
                             int box_rows, int group_m, cudaStream_t s) {
  if (tile_code == 0)
    return launch_wgmma<tile::LargeTile, OutT>(a, b, c, m, n, k, m_pad,
                                               box_rows, group_m, s);
  if (tile_code == 1)   // small M
    return launch_wgmma<tile::SmallTile, OutT>(a, b, c, m, n, k, m_pad,
                                               box_rows, group_m, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16.  tile_code (bf16 only): 0 = 128 x 256,
// 1 = 64 x 64; m_pad, box_rows, group_m (bf16 only): M's
// virtual rows, the A box height and the raster's group of tile rows
// (gemm_tile.cuh).  The fp32 path has one tile and ignores all four.
extern "C" int matmul_fwd(const void* a, const void* b, void* c, int m,
                          int n, int k, int in_dtype, int out_dtype,
                          int tile_code, int m_pad, int box_rows,
                          int group_m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_dtype == 1 && out_dtype == 1)
    err = launch_bf16_tile<__nv_bfloat16>(tile_code, a, b, c, m, n, k, m_pad,
                                          box_rows, group_m, s);
  else if (in_dtype == 1 && out_dtype == 0)
    err = launch_bf16_tile<float>(tile_code, a, b, c, m, n, k, m_pad,
                                  box_rows, group_m, s);
  else if (in_dtype == 0 && out_dtype == 0)
    err = launch_f32<float>(a, b, c, m, n, k, s);
  else if (in_dtype == 0 && out_dtype == 1)
    err = launch_f32<__nv_bfloat16>(a, b, c, m, n, k, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

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
//   * bf16: one block per BM x BN output tile: 128 x 128 with 8 warps, each
//     owning 64 x 32, K steps of 32, three stages; or, for small M where
//     128 x 128 tiles leave SMs idle, 64 x 64 with 4 warps of 32 x 32, K
//     steps of 64, four stages (the two picked among twelve configurations
//     by their times at the op-level shapes; PERF.md).  The TPU's
//     sequential K grid axis becomes a loop inside the block.  A and B
//     tiles go to shared memory by cp.async, STAGES deep, each row padded
//     by 16 bytes so the ldmatrix reads of 8 rows hit 8 distinct bank
//     groups.  A comes in with ldmatrix, the row-major B with
//     ldmatrix.trans, and mma.sync.m16n8k16 (bf16 in, fp32 accumulate)
//     runs on the tensor cores.  No TMA, wgmma or warp specialisation yet.
//   * fp32: the CUDA cores (no TF32, which would not meet the fp32
//     tolerance): 128 x 128 tiles, K steps of 8, 8 x 8 outputs a thread,
//     A staged transposed so a thread reads its 8 rows as two float4.
//   * Tiles are walked in groups of kGroupM tile rows, so the blocks in
//     flight share A row panels and B column panels in L2.
//   * The tile loop itself lives in gemm_tile.cuh, shared with the fused
//     AG-GEMM and GEMM-RS kernels.
//   * Ragged edges: out-of-range rows and columns and a ragged K tail are
//     zero-filled on load (cp.async's source size 0) and masked on store
//     (the TPU kernel needs block multiples).  The 16-byte loads need K and
//     N to be multiples of 8 (bf16) or 4 (fp32), and 16-byte aligned bases;
//     the wrapper checks both.
// The launch goes on the caller's stream; nothing is allocated or
// synchronised here.  The function returns cudaGetLastError().

#include "gemm_tile.cuh"

namespace {

template <class Tile, typename OutT>
__global__ void __launch_bounds__(Tile::kThreads)
gemm_kernel(const typename Tile::T* __restrict__ a,
            const typename Tile::T* __restrict__ b, OutT* __restrict__ c,
            int m, int n, int k) {
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

template <class Tile, typename OutT>
cudaError_t launch(const void* a, const void* b, void* c, int m, int n,
                   int k, cudaStream_t stream) {
  auto kern = gemm_kernel<Tile, OutT>;
  const cudaError_t e = tile::allow_smem(kern, Tile::kSmem);
  if (e != cudaSuccess) return e;
  const int tiles = tile::cdiv(m, Tile::kBM) * tile::cdiv(n, Tile::kBN);
  kern<<<tiles, Tile::kThreads, Tile::kSmem, stream>>>(
      static_cast<const typename Tile::T*>(a),
      static_cast<const typename Tile::T*>(b), static_cast<OutT*>(c), m, n,
      k);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_bf16_tile(int tile_code, const void* a, const void* b,
                             void* c, int m, int n, int k,
                             cudaStream_t stream) {
  if (tile_code == 0)
    return launch<tile::WideTile, OutT>(a, b, c, m, n, k, stream);
  if (tile_code == 1)   // small M
    return launch<tile::NarrowTile, OutT>(a, b, c, m, n, k, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16.  tile_code (bf16 only): 0 = 128 x 128,
// 1 = 64 x 64; the fp32 path has one tile and ignores it.
extern "C" int matmul_fwd(const void* a, const void* b, void* c, int m,
                          int n, int k, int in_dtype, int out_dtype,
                          int tile_code, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_dtype == 1 && out_dtype == 1)
    err = launch_bf16_tile<__nv_bfloat16>(tile_code, a, b, c, m, n, k, s);
  else if (in_dtype == 1 && out_dtype == 0)
    err = launch_bf16_tile<float>(tile_code, a, b, c, m, n, k, s);
  else if (in_dtype == 0 && out_dtype == 0)
    err = launch<tile::F32Tile, float>(a, b, c, m, n, k, s);
  else if (in_dtype == 0 && out_dtype == 1)
    err = launch<tile::F32Tile, __nv_bfloat16>(a, b, c, m, n, k, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

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
//   * Ragged edges: out-of-range rows and columns and a ragged K tail are
//     zero-filled on load (cp.async's source size 0) and masked on store
//     (the TPU kernel needs block multiples).  The 16-byte loads need K and
//     N to be multiples of 8 (bf16) or 4 (fp32), and 16-byte aligned bases;
//     the wrapper checks both.
// The launch goes on the caller's stream; nothing is allocated or
// synchronised here.  The function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kPad = 8;      // bf16: padding of each smem row (16 bytes)
constexpr int kGroupM = 8;   // tile rows per raster group (L2 reuse)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; valid == false zero-fills the destination (source
// size 0: nothing is read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a (16 x 16, row) * b (16 x 8, col); bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  store2(p, v.x, v.y);
  store2(p + 2, v.z, v.w);
}

// The tile (row, column) of this block: tiles are numbered in groups of
// kGroupM tile rows, column-major inside a group.
__device__ __forceinline__ void tile_of_block(int m, int n, int bm, int bn,
                                              int* tm, int* tn) {
  const int tiles_m = (m + bm - 1) / bm;
  const int tiles_n = (n + bn - 1) / bn;
  const int per_group = kGroupM * tiles_n;
  const int pid = blockIdx.x;
  const int first_m = (pid / per_group) * kGroupM;
  const int group_m = min(tiles_m - first_m, kGroupM);
  *tm = first_m + (pid % per_group) % group_m;
  *tn = (pid % per_group) / group_m;
}

template <int BM, int BN, int BK, int NT>
__device__ __forceinline__ void load_tile_bf16(
    const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
    __nv_bfloat16* as, __nv_bfloat16* bs, int m, int n, int k, int m0,
    int n0, int k0, int tid) {
  constexpr int AS = BK + kPad;
  constexpr int BS = BN + kPad;
  constexpr int A_CHUNKS = BM * BK / 8;    // 16-byte chunks of the A tile
  constexpr int B_CHUNKS = BK * BN / 8;
  static_assert(A_CHUNKS % NT == 0 && B_CHUNKS % NT == 0, "chunks/thread");
#pragma unroll
  for (int i = 0; i < A_CHUNKS / NT; ++i) {
    const int c = tid + i * NT;
    const int r = c / (BK / 8);
    const int col = (c % (BK / 8)) * 8;
    const bool ok = (m0 + r < m) && (k0 + col < k);
    const __nv_bfloat16* src = ok ? a + (int64_t)(m0 + r) * k + k0 + col : a;
    cp_async16(smem_u32(as + r * AS + col), src, ok);
  }
#pragma unroll
  for (int i = 0; i < B_CHUNKS / NT; ++i) {
    const int c = tid + i * NT;
    const int r = c / (BN / 8);
    const int col = (c % (BN / 8)) * 8;
    const bool ok = (k0 + r < k) && (n0 + col < n);
    const __nv_bfloat16* src = ok ? b + (int64_t)(k0 + r) * n + n0 + col : b;
    cp_async16(smem_u32(bs + r * BS + col), src, ok);
  }
}

template <int BM, int BN, int BK, int STAGES>
constexpr int bf16_smem_bytes() {
  return STAGES * (BM * (BK + kPad) + BK * (BN + kPad)) *
         (int)sizeof(__nv_bfloat16);
}

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, int STAGES,
          typename OutT>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
gemm_bf16_kernel(const __nv_bfloat16* __restrict__ a,
                 const __nv_bfloat16* __restrict__ b, OutT* __restrict__ c,
                 int m, int n, int k) {
  constexpr int NT = WARPS_M * WARPS_N * 32;
  constexpr int WTM = BM / WARPS_M;        // warp tile rows
  constexpr int WTN = BN / WARPS_N;        // warp tile columns
  constexpr int MI = WTM / 16;             // m16 fragments a warp
  constexpr int NI = WTN / 8;              // n8 fragments a warp
  constexpr int AS = BK + kPad;
  constexpr int BS = BN + kPad;
  constexpr int A_STAGE = BM * AS;
  constexpr int B_STAGE = BK * BS;
  static_assert(WTM % 16 == 0 && NI % 2 == 0, "warp tile");
  static_assert(STAGES >= 2, "pipeline depth");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* as_all = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* bs_all = as_all + STAGES * A_STAGE;

  int tm, tn;
  tile_of_block(m, n, BM, BN, &tm, &tn);
  const int m0 = tm * BM, n0 = tn * BN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int nk = (k + BK - 1) / BK;

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // prologue: the first STAGES - 1 K steps in flight (one group each, empty
  // past the end, so the group count stays uniform)
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_tile_bf16<BM, BN, BK, NT>(a, b, as_all + s * A_STAGE,
                                     bs_all + s * B_STAGE, m, n, k, m0, n0,
                                     s * BK, tid);
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();   // step kt has landed
    __syncthreads();               // ... for all threads; step kt - 1 is done
    const int nt = kt + STAGES - 1;
    if (nt < nk)                   // into the stage step kt - 1 used
      load_tile_bf16<BM, BN, BK, NT>(a, b, as_all + (nt % STAGES) * A_STAGE,
                                     bs_all + (nt % STAGES) * B_STAGE, m, n,
                                     k, m0, n0, nt * BK, tid);
    cp_async_commit();

    const __nv_bfloat16* as = as_all + (kt % STAGES) * A_STAGE;
    const __nv_bfloat16* bs = bs_all + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MI][4];
      uint32_t bf[NI][2];
      // A: lanes 0-15 address rows 0-15 at k kk, lanes 16-31 at k kk + 8
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldmatrix_x4(af[i], smem_u32(as + (wm * WTM + i * 16 + (lane & 15)) * AS
                                    + kk + (lane >> 4) * 8));
      // B: lanes 0-15 address k rows kk..kk+15 at columns j..j+7, lanes
      // 16-31 at j+8..j+15; .trans gives each thread its column's k pairs
#pragma unroll
      for (int j = 0; j < NI / 2; ++j) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, smem_u32(bs + (kk + (lane & 15)) * BS
                                      + wn * WTN + j * 16 + (lane >> 4) * 8));
        bf[2 * j][0] = r[0];
        bf[2 * j][1] = r[1];
        bf[2 * j + 1][0] = r[2];
        bf[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
          mma_bf16(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }

  // accumulator (i, j): rows lane / 4 and lane / 4 + 8 of the fragment,
  // columns 2 (lane % 4) and + 1; n % 8 == 0, so a pair is wholly in range
  // or out of it
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int row = m0 + wm * WTM + i * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int col = n0 + wn * WTN + j * 8 + (lane & 3) * 2;
      if (col >= n) continue;
      if (row < m)
        store2(c + (int64_t)row * n + col, acc[i][j][0], acc[i][j][1]);
      if (row + 8 < m)
        store2(c + (int64_t)(row + 8) * n + col, acc[i][j][2], acc[i][j][3]);
    }
  }
}

constexpr int kF32Tile = 128;   // fp32: BM = BN
constexpr int kF32BK = 8;
constexpr int kF32Threads = 256;

template <typename OutT>
__global__ void __launch_bounds__(kF32Threads)
gemm_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                OutT* __restrict__ c, int m, int n, int k) {
  __shared__ __align__(16) float as[kF32BK][kF32Tile + 4];   // A^T: [k][m]
  __shared__ __align__(16) float bs[kF32BK][kF32Tile];

  int tm, tn;
  tile_of_block(m, n, kF32Tile, kF32Tile, &tm, &tn);
  const int m0 = tm * kF32Tile, n0 = tn * kF32Tile;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  // one float4 of A (row ar, k ak..ak+3) and of B (k br, columns bc..bc+3)
  // a thread for each K step; k % 4 == 0 and n % 4 == 0, so a float4 is
  // wholly in range or out of it
  const int ar = tid / 2, ak = (tid % 2) * 4;
  const int br = tid / 32, bc = (tid % 32) * 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kF32BK) {
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 bv = av;
    if (m0 + ar < m && k0 + ak < k)
      av = *reinterpret_cast<const float4*>(a + (int64_t)(m0 + ar) * k + k0
                                            + ak);
    if (k0 + br < k && n0 + bc < n)
      bv = *reinterpret_cast<const float4*>(b + (int64_t)(k0 + br) * n + n0
                                            + bc);
    __syncthreads();   // the previous step's reads are done
    as[ak + 0][ar] = av.x;
    as[ak + 1][ar] = av.y;
    as[ak + 2][ar] = av.z;
    as[ak + 3][ar] = av.w;
    *reinterpret_cast<float4*>(&bs[br][bc]) = bv;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kF32BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][64 + tx * 4]);
      const float ra[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float rb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
  }

  // thread rows ty*4 + i and 64 + ty*4 + i, columns tx*4 + j and 64 + tx*4 + j
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + h * 64 + tx * 4;
      if (col >= n) continue;
      store4(c + (int64_t)row * n + col,
             make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                         acc[i][4 * h + 3]));
    }
  }
}

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, int STAGES,
          typename OutT>
cudaError_t launch_bf16(const void* a, const void* b, void* c, int m, int n,
                        int k, cudaStream_t stream) {
  constexpr int smem = bf16_smem_bytes<BM, BN, BK, STAGES>();
  auto kern = gemm_bf16_kernel<BM, BN, BK, WARPS_M, WARPS_N, STAGES, OutT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const int tiles = ((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  kern<<<tiles, WARPS_M * WARPS_N * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b),
      static_cast<OutT*>(c), m, n, k);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_f32(const void* a, const void* b, void* c, int m, int n,
                       int k, cudaStream_t stream) {
  const int tiles = ((m + kF32Tile - 1) / kF32Tile) *
                    ((n + kF32Tile - 1) / kF32Tile);
  gemm_f32_kernel<OutT><<<tiles, kF32Threads, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<OutT*>(c), m, n, k);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_bf16_tile(int tile, const void* a, const void* b, void* c,
                             int m, int n, int k, cudaStream_t stream) {
  // BM, BN, BK, warps along M, warps along N, stages
  if (tile == 0)
    return launch_bf16<128, 128, 32, 2, 4, 3, OutT>(a, b, c, m, n, k, stream);
  if (tile == 1)   // small M
    return launch_bf16<64, 64, 64, 2, 2, 4, OutT>(a, b, c, m, n, k, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16.  tile (bf16 only): 0 = 128 x 128,
// 1 = 64 x 64; the fp32 path has one tile and ignores it.
extern "C" int matmul_fwd(const void* a, const void* b, void* c, int m,
                          int n, int k, int in_dtype, int out_dtype, int tile,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_dtype == 1 && out_dtype == 1)
    err = launch_bf16_tile<__nv_bfloat16>(tile, a, b, c, m, n, k, s);
  else if (in_dtype == 1 && out_dtype == 0)
    err = launch_bf16_tile<float>(tile, a, b, c, m, n, k, s);
  else if (in_dtype == 0 && out_dtype == 0)
    err = launch_f32<float>(a, b, c, m, n, k, s);
  else if (in_dtype == 0 && out_dtype == 1)
    err = launch_f32<__nv_bfloat16>(a, b, c, m, n, k, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The tile loop shared by the port's GEMM kernels (matmul.cu, ag_gemm.cu,
// gemm_rs.cu): one block computes one BM x BN output tile of A @ B with the
// whole K sum (no split-K), accumulating in fp32 registers.
//
// A tile's rows need not be contiguous in memory: the caller gives a
// functor `a_row(r)` that returns the address of the tile's row r (or
// nullptr past the valid rows, which then load as zeros).  That is what
// lets the fused kernels walk the gathered rows of several ranks' shards
// (AG-GEMM) or scatter rows to several owners (GEMM-RS) with the plain
// GEMM's inner loop.  `emit(rows, n, n0, store)` hands the fp32 results to
// `store(r, col, x, y)` two columns at a time, for r < rows and col < n.
//
//   * Bf16Tile: tensor cores.  A and B tiles go to shared memory by
//     cp.async (.cg: L2 only, so rows that a copy engine rewrote between
//     launches are never read from a stale L1 line), STAGES deep, each row
//     padded by 16 bytes so the ldmatrix reads of 8 rows hit 8 distinct
//     bank groups; A by ldmatrix, the row-major B by ldmatrix.trans, and
//     mma.sync.m16n8k16 (bf16 in, fp32 accumulate).
//   * F32Tile: the CUDA cores (no TF32): 128 x 128 tiles, K steps of 8,
//     8 x 8 outputs a thread, A staged transposed; A read with ld.global.cg.
//
// Ragged edges: rows past the valid ones, columns past N and a ragged K
// tail are zero-filled on load and masked on store.  The 16-byte loads need
// K and N to be multiples of 8 (bf16) or 4 (fp32) and 16-byte aligned
// rows; the wrappers check both.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tile {

constexpr int kPad = 8;      // bf16: padding of each smem row (16 bytes)
constexpr int kGroupM = 8;   // tile rows per raster group (L2 reuse)

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

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

// The (tile row, tile column) of linear tile `pid`: tiles are numbered in
// groups of kGroupM tile rows, column-major inside a group, so the blocks
// in flight share A row panels and B column panels in L2.
__device__ __forceinline__ void tile_coords(int pid, int tiles_m, int tiles_n,
                                            int* tm, int* tn) {
  const int per_group = kGroupM * tiles_n;
  const int first_m = (pid / per_group) * kGroupM;
  const int group_m = min(tiles_m - first_m, kGroupM);
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

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, int STAGES>
struct Bf16Tile {
  using T = __nv_bfloat16;
  static constexpr int kBM = BM, kBN = BN;
  static constexpr int kThreads = WARPS_M * WARPS_N * 32;
  static constexpr int WTM = BM / WARPS_M;    // warp tile rows
  static constexpr int WTN = BN / WARPS_N;    // warp tile columns
  static constexpr int MI = WTM / 16;         // m16 fragments a warp
  static constexpr int NI = WTN / 8;          // n8 fragments a warp
  static constexpr int AS = BK + kPad;
  static constexpr int BS = BN + kPad;
  static constexpr int A_STAGE = BM * AS;
  static constexpr int B_STAGE = BK * BS;
  static constexpr int A_CHUNKS = BM * BK / 8;   // 16-byte chunks of A
  static constexpr int B_CHUNKS = BK * BN / 8;
  static constexpr int A_PER = A_CHUNKS / kThreads;
  static constexpr int kSmem = STAGES * (A_STAGE + B_STAGE) * (int)sizeof(T);
  static_assert(WTM % 16 == 0 && NI % 2 == 0, "warp tile");
  static_assert(STAGES >= 2, "pipeline depth");
  static_assert(A_CHUNKS % kThreads == 0 && B_CHUNKS % kThreads == 0,
                "chunks/thread");

  float acc[MI][NI][4];

  __device__ __forceinline__ void load(const T* const* arow,
                                       const T* __restrict__ b, T* as, T* bs,
                                       int n, int k, int n0, int k0,
                                       int tid) const {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / (BK / 8);
      const int col = (c % (BK / 8)) * 8;
      const bool ok = arow[i] != nullptr && k0 + col < k;
      cp_async16(smem_u32(as + r * AS + col), ok ? arow[i] + k0 + col : b, ok);
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / (BN / 8);
      const int col = (c % (BN / 8)) * 8;
      const bool ok = (k0 + r < k) && (n0 + col < n);
      const T* src = ok ? b + (int64_t)(k0 + r) * n + n0 + col : b;
      cp_async16(smem_u32(bs + r * BS + col), src, ok);
    }
  }

  // acc = A_tile @ B[:, n0:n0+BN]; `a_row(r)` is the address of row r of
  // the tile (nullptr: a zero row).  Ends with a barrier, so the shared
  // memory is free for the next tile on return.
  template <class ARow>
  __device__ __forceinline__ void run(ARow a_row, const T* __restrict__ b,
                                      int n, int k, int n0,
                                      unsigned char* smem) {
    T* as_all = reinterpret_cast<T*>(smem);
    T* bs_all = as_all + STAGES * A_STAGE;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int wm = warp / WARPS_N;
    const int wn = warp % WARPS_N;
    const int nk = cdiv(k, BK);
    const T* arow[A_PER];
#pragma unroll
    for (int i = 0; i < A_PER; ++i)
      arow[i] = a_row((tid + i * kThreads) / (BK / 8));

#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    // prologue: the first STAGES - 1 K steps in flight (one group each,
    // empty past the end, so the group count stays uniform)
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk)
        load(arow, b, as_all + s * A_STAGE, bs_all + s * B_STAGE, n, k, n0,
             s * BK, tid);
      cp_async_commit();
    }

    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<STAGES - 2>();   // step kt has landed
      __syncthreads();               // ... for all threads; kt - 1 is done
      const int nt = kt + STAGES - 1;
      if (nt < nk)                   // into the stage step kt - 1 used
        load(arow, b, as_all + (nt % STAGES) * A_STAGE,
             bs_all + (nt % STAGES) * B_STAGE, n, k, n0, nt * BK, tid);
      cp_async_commit();

      const T* as = as_all + (kt % STAGES) * A_STAGE;
      const T* bs = bs_all + (kt % STAGES) * B_STAGE;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t af[MI][4];
        uint32_t bf[NI][2];
        // A: lanes 0-15 address rows 0-15 at k kk, lanes 16-31 at kk + 8
#pragma unroll
        for (int i = 0; i < MI; ++i)
          ldmatrix_x4(af[i], smem_u32(as + (wm * WTM + i * 16 + (lane & 15))
                                      * AS + kk + (lane >> 4) * 8));
        // B: lanes 0-15 address k rows kk..kk+15 at columns j..j+7, lanes
        // 16-31 at j+8..j+15; .trans gives each thread its column's k pairs
#pragma unroll
        for (int j = 0; j < NI / 2; ++j) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, smem_u32(bs + (kk + (lane & 15)) * BS
                                        + wn * WTN + j * 16
                                        + (lane >> 4) * 8));
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
    cp_async_wait<0>();
    __syncthreads();
  }

  // accumulator (i, j): rows lane / 4 and lane / 4 + 8 of the fragment,
  // columns 2 (lane % 4) and + 1; n % 8 == 0, so a pair is wholly in range
  // or out of it
  template <class Store>
  __device__ __forceinline__ void emit(int rows, int n, int n0,
                                       Store store) const {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int wm = warp / WARPS_N;
    const int wn = warp % WARPS_N;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int r = wm * WTM + i * 16 + (lane >> 2);
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int col = n0 + wn * WTN + j * 8 + (lane & 3) * 2;
        if (col >= n) continue;
        if (r < rows) store(r, col, acc[i][j][0], acc[i][j][1]);
        if (r + 8 < rows) store(r + 8, col, acc[i][j][2], acc[i][j][3]);
      }
    }
  }
};

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

// The two bf16 tiles the wrappers pick between (kernels/matmul.py
// TILES): 0 = 128 x 128 with 8 warps of 64 x 32, K steps of 32, three
// stages; 1 = 64 x 64 with 4 warps of 32 x 32, K steps of 64, four stages
// (for small m).
using WideTile = Bf16Tile<128, 128, 32, 2, 4, 3>;
using NarrowTile = Bf16Tile<64, 64, 64, 2, 2, 4>;

// Set the dynamic shared memory a kernel needs above the default 48 KB.
template <class Kernel>
cudaError_t allow_smem(Kernel kern, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace tile

// Fused AllGather-GEMM for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/ag_gemm.py::_ag_gemm_kernel (wrapper ag_gemm,
// reached through kernels/ops.py::ag_matmul_fused and FusedOp(kind="ag",
// mode="flux")): the paper's Algorithms 2 and 3.
//
// Per rank, one launch computes
//     C[n * M_sh, N_loc] = act(AllGather_m(A_shard) @ B_local + bias)
// accumulated in fp32, cast once at the store.  The ranks of a
// dist.RankGroup share one card, so a peer's shard is an address:
//   * The host (kernels/ag_gemm.py) first queues, on the rank's copy
//     stream, n - 1 device-to-device copies that pull the peers' shards
//     into this rank's aggregated buffer A_agg[n, M_sh, K], in the
//     reference's ring order owner = (me - sgn s) mod n (ag_gemm.py:66),
//     each followed on the same stream by cuStreamWriteValue32 setting
//     that shard's ready flag to this call's epoch (ag_gemm_pull below; no
//     kernel).  The local shard is read in place (its "signal is preset",
//     Alg. 2).
//   * The kernel walks the gathered rows in ring order, the local shard
//     first: tile row t covers gathered rows [t BM, t BM + BM), which map
//     to (ring step, row) and so to (owner, row).
//   * bf16: the tile loop is gemm_tile.cuh's wgmma_gemm (TMA + wgmma,
//     warp-specialised, persistent).  The flag wait sits in the producer:
//     before it issues a tile's first A loads, the producer thread waits
//     until the flag of every owner the tile touches holds the epoch
//     (ld.acquire.gpu with __nanosleep; a flag is never reset: epochs
//     cycle), then fences the async proxy, while the consumers still
//     store the previous tile (FLUX's per-tile wait, Alg. 2, in the load
//     stage).  The local shard's tiles come first (ring step 0).
//   * A through TMA, two decisions.  The local shard is read in place
//     through a second tensor map (no 25 MB copy a rank at m 8192): walk
//     position 0 uses it, the others A_agg's map [n, M_sh, K].  A small
//     M_sh (decode rows) packs several shards into one tile with one box
//     per shard: each shard is padded to m_pad virtual rows, a power of
//     two that divides the tile, and the box height is m_pad
//     (kernels/matmul.py::a_boxes); rows past M_sh zero-fill and are not
//     stored, so no box reads a neighbour shard and no cp.async path is
//     needed.
//   * fp32: one block a 128 x 128 tile (gemm_tile.cuh's F32Tile, A with
//     ld.global.cg: L2 only, the copies rewrite A_agg between calls); one
//     thread waits on the tile's flags before its loop.
//   * Epilogue on the fp32 accumulator, before the cast: + bias (fp32),
//     then the activation (ag_gemm.py:111-127); rows are stored
//     shard-major, at owner * M_sh + row (ag_gemm.py:125).
//   * No wait can hang: after kWaitNs of %globaltimer a waiting thread
//     traps, which fails the launch and the run.  The host makes the
//     rank's stream wait for every shard's producer before the launch and
//     queues every rank's copies before any rank's kernel, so a wait
//     waits only for copies.  That ordering alone does not keep the
//     copies running: a launch of every tile at TP 8 trapped (the
//     copies need block slots, or wait behind the kernels in a hardware
//     queue).  What keeps them running is the grid bound: when
//     the ranks share one card, their CTAs never hold all of its block
//     slots (tile::persistent_grid with kReservedSlots).
// What bounds it on the card: the ranks' GEMMs (2 n M_sh N_loc K
// operations a rank); the copies move (n - 1) M_sh K elements a rank
// through HBM beside them.
// The launch goes on the caller's stream; nothing is allocated or
// synchronised here.  Each function returns a cudaError_t.

#include <cuda.h>

#include "gemm_tile.cuh"

namespace {

constexpr unsigned long long kWaitNs = 2000000000ull;   // 2 s
// block slots of the card left free of AG-GEMM blocks
// (tile::persistent_grid)
constexpr int kReservedSlots = 8;

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Until *flag == epoch; trap after kWaitNs.
__device__ void wait_flag(const int* flag, int epoch) {
  const unsigned long long t0 = globaltimer();
  while (load_acquire(flag) != epoch) {
    if (globaltimer() - t0 > kWaitNs) __trap();
    __nanosleep(256);
  }
}

struct AgArgs {
  const void* a_local;   // [m_sh, k] this rank's shard
  const void* a_agg;     // [n_dev, m_sh, k] this rank's aggregated buffer
  const int* flags;      // [n_dev] this rank's ready flags
  const void* b;         // [k, n_loc]
  const float* bias;     // [n_loc] or null
  void* c;               // [n_dev * m_sh, n_loc]
  int m_sh, n_loc, k, n_dev, me, sgn, epoch, act;
};

// fp32: one block a tile, the tiles of the block's grid stride
template <class Tile, typename OutT>
__global__ void __launch_bounds__(Tile::kThreads)
ag_gemm_f32_kernel(const AgArgs params) {
  using T = typename Tile::T;
  const AgArgs p = params;   // a local copy: the lambdas below capture it
  extern __shared__ __align__(16) unsigned char smem[];
  const int m_tot = p.n_dev * p.m_sh;
  const int tiles_m = tile::cdiv(m_tot, Tile::kBM);
  const int tiles_n = tile::cdiv(p.n_loc, Tile::kBN);
  const T* a_local = static_cast<const T*>(p.a_local);
  const T* a_agg = static_cast<const T*>(p.a_agg);
  const T* b = static_cast<const T*>(p.b);
  OutT* c = static_cast<OutT*>(p.c);
  // ring step s holds the shard of rank (me - sgn s) mod n
  auto owner_of = [&](int s) {
    return ((p.me - p.sgn * s) % p.n_dev + p.n_dev) % p.n_dev;
  };
  for (int t = blockIdx.x; t < tiles_m * tiles_n; t += gridDim.x) {
    int tm, tn;
    tile::tile_coords(t, tiles_m, tiles_n, &tm, &tn);
    const int g0 = tm * Tile::kBM;             // first gathered row
    const int rows = min(Tile::kBM, m_tot - g0);
    const int n0 = tn * Tile::kBN;
    if (threadIdx.x == 0) {
      const int s_last = (g0 + rows - 1) / p.m_sh;
      for (int s = max(g0 / p.m_sh, 1); s <= s_last; ++s)
        wait_flag(p.flags + owner_of(s), p.epoch);
    }
    __syncthreads();
    Tile tl;
    tl.run([&](int r) -> const T* {
             if (r >= rows) return nullptr;
             const int g = g0 + r, s = g / p.m_sh, o = owner_of(s);
             const T* base = o == p.me ? a_local
                                       : a_agg + (int64_t)o * p.m_sh * p.k;
             return base + (int64_t)(g - s * p.m_sh) * p.k;
           }, b, p.n_loc, p.k, n0, smem);
    tl.emit(rows, p.n_loc, n0, [&](int r, int col, float x, float y) {
      const int g = g0 + r, s = g / p.m_sh;
      const int64_t row = (int64_t)owner_of(s) * p.m_sh + (g - s * p.m_sh);
      if (p.bias != nullptr) {
        x += p.bias[col];
        y += p.bias[col + 1];
      }
      tile::store2(c + row * p.n_loc + col, tile::activate(p.act, x),
                   tile::activate(p.act, y));
    });
  }
}

// bf16: gemm_tile.cuh's loop; walk position s holds the shard of rank
// (me - sgn s) mod n, position 0 (this rank's) read in place
template <typename OutT>
struct AgOp {
  const int* flags;
  const float* bias;
  OutT* c;
  int m_sh, n_loc, n_dev, me, sgn, epoch, act;

  __device__ int owner(int s) const {
    return ((me - sgn * s) % n_dev + n_dev) % n_dev;
  }
  __device__ int shard(int s) const { return s == 0 ? 0 : owner(s); }
  __device__ bool local(int s) const { return s == 0; }
  __device__ void wait(int s0, int s1) const {
    for (int s = max(s0, 1); s <= s1; ++s) wait_flag(flags + owner(s), epoch);
    hopper::fence_proxy_async_global();
  }
  __device__ void store(int s, int r, int col, float x, float y) const {
    if (bias != nullptr) {
      x += bias[col];
      y += bias[col + 1];
    }
    tile::store2(c + ((int64_t)owner(s) * m_sh + r) * n_loc + col,
                 tile::activate(act, x), tile::activate(act, y));
  }
};

template <class Cfg, typename OutT>
__global__ void __launch_bounds__(Cfg::kThreads, 1)
ag_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap a_agg,
                     const __grid_constant__ CUtensorMap a_local,
                     const __grid_constant__ CUtensorMap b,
                     const tile::Walk w, const AgOp<OutT> op) {
  tile::wgmma_gemm<Cfg>(&a_agg, &a_local, &b, w, op);
}

template <class Cfg, typename OutT>
cudaError_t launch_wgmma(const AgArgs& p, int m_pad, int box_rows,
                         int group_m, int share, cudaStream_t stream) {
  CUtensorMap am, lm, bm;
  cudaError_t e;
  if ((e = tile::a_map(&am, p.a_agg, p.k, p.m_sh, p.n_dev, box_rows)) !=
          cudaSuccess ||
      (e = tile::a_map(&lm, p.a_local, p.k, p.m_sh, 1, box_rows)) !=
          cudaSuccess ||
      (e = tile::b_map(&bm, p.b, p.k, p.n_loc)) != cudaSuccess)
    return e;
  auto kern = ag_gemm_wgmma_kernel<Cfg, OutT>;
  if ((e = tile::allow_smem(kern, Cfg::kSmem)) != cudaSuccess) return e;
  const int tiles = tile::cdiv(p.n_dev * m_pad, Cfg::kBM) *
                    tile::cdiv(p.n_loc, Cfg::kBN);
  int grid = 0;
  if ((e = tile::persistent_grid(kern, Cfg::kThreads, Cfg::kSmem, tiles,
                                 share, kReservedSlots, &grid)) !=
      cudaSuccess)
    return e;
  const tile::Walk w{p.m_sh, m_pad, box_rows, p.n_dev,
                     p.n_loc, p.k, group_m};
  const AgOp<OutT> op{p.flags, p.bias, static_cast<OutT*>(p.c), p.m_sh,
                      p.n_loc, p.n_dev, p.me, p.sgn, p.epoch, p.act};
  kern<<<grid, Cfg::kThreads, Cfg::kSmem, stream>>>(am, lm, bm, w, op);
  return cudaGetLastError();
}

// fp32: every tile a block when the rank has the card to itself (share
// <= 1), else the bounded grid of tile::persistent_grid
template <typename OutT>
cudaError_t launch_f32(const AgArgs& p, int share, cudaStream_t stream) {
  using Tile = tile::F32Tile;
  auto kern = ag_gemm_f32_kernel<Tile, OutT>;
  cudaError_t e = tile::allow_smem(kern, Tile::kSmem);
  if (e != cudaSuccess) return e;
  const int tiles = tile::cdiv(p.n_dev * p.m_sh, Tile::kBM) *
                    tile::cdiv(p.n_loc, Tile::kBN);
  int grid = tiles;
  if (share > 1 &&
      (e = tile::persistent_grid(kern, Tile::kThreads, Tile::kSmem, tiles,
                                 share, kReservedSlots, &grid)) !=
          cudaSuccess)
    return e;
  kern<<<grid, Tile::kThreads, Tile::kSmem, stream>>>(p);
  return cudaGetLastError();
}

using WriteValue32 = CUresult (*)(CUstream, CUdeviceptr, cuuint32_t,
                                  unsigned int);

// cuStreamWriteValue32 from the driver: the stream's front end writes the
// value, no SM and no copy.
WriteValue32 write_value32() {
  static const WriteValue32 fn =
      hopper::driver_entry<WriteValue32>("cuStreamWriteValue32");
  return fn;
}

template <typename OutT>
cudaError_t launch_in(int in_dtype, int tile_code, const AgArgs& p,
                      int m_pad, int box_rows, int group_m, int share,
                      cudaStream_t s) {
  if (in_dtype == 0) return launch_f32<OutT>(p, share, s);
  if (in_dtype != 1) return cudaErrorInvalidValue;
  if (tile_code == 0)
    return launch_wgmma<tile::LargeTile, OutT>(p, m_pad, box_rows, group_m,
                                               share, s);
  if (tile_code == 1)   // small M
    return launch_wgmma<tile::SmallTile, OutT>(p, m_pad, box_rows, group_m,
                                               share, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Pull one peer shard into this rank's A_agg slot (a device-to-device copy
// on the rank's copy stream), then set the slot's ready flag to the epoch
// (cuStreamWriteValue32 on the same stream, after the copy, with a memory
// fence before the write).
extern "C" int ag_gemm_pull(void* dst, const void* src, size_t bytes,
                            void* flag, int epoch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const WriteValue32 write = write_value32();
  if (write == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cudaError_t e =
      cudaMemcpyAsync(dst, src, bytes, cudaMemcpyDeviceToDevice, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const CUresult r = write(reinterpret_cast<CUstream>(s),
                           reinterpret_cast<CUdeviceptr>(flag),
                           static_cast<cuuint32_t>(epoch), 0);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorUnknown);
}

// dtype codes: 0 float32, 1 bfloat16.  tile_code (bf16 only): 0 = 128 x
// 256, 1 = 64 x 64.  m_pad, box_rows, group_m (bf16 only):
// the shards' virtual rows, the A box height and the raster's group of
// tile rows (gemm_tile.cuh).  act:
// gemm_tile.cuh's activation codes.  share: the ranks that run on this card
// at once (tile::persistent_grid).
extern "C" int ag_gemm_fwd(const void* a_local, const void* a_agg,
                           const int* flags, const void* b, const float* bias,
                           void* c, int m_sh, int n_loc, int k, int n_dev,
                           int me, int reverse, int epoch, int act,
                           int in_dtype, int out_dtype, int tile_code,
                           int m_pad, int box_rows, int group_m,
                           int share, void* stream) {
  const AgArgs p{a_local, a_agg, flags, b, bias, c, m_sh, n_loc, k, n_dev, me,
                 reverse ? -1 : 1, epoch, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (out_dtype == 1)
    err = launch_in<__nv_bfloat16>(in_dtype, tile_code, p, m_pad, box_rows,
                                   group_m, share, s);
  else if (out_dtype == 0)
    err = launch_in<float>(in_dtype, tile_code, p, m_pad, box_rows, group_m,
                           share, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

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
//     to (ring step, row) and so to (owner, row).  Before a tile's loop,
//     one thread waits until the flag of every owner the tile touches
//     holds the epoch (ld.acquire.gpu with __nanosleep; a flag is never
//     reset: epochs cycle), then __syncthreads().  A small M_sh (decode
//     rows) packs several shards into one tile instead of padding each.
//   * A tiles load with cp.async.cg (L2 only: the copies rewrite A_agg
//     between calls).  The tile loop is gemm_tile.cuh's (mma.sync
//     m16n8k16, ldmatrix, cp.async stages; fp32 on the CUDA cores).
//   * Epilogue on the fp32 accumulator, before the cast: + bias (fp32),
//     then the activation (ag_gemm.py:111-127); rows are stored
//     shard-major, at owner * M_sh + row (ag_gemm.py:125).
//   * No wait can hang: after kWaitNs of %globaltimer a waiting block
//     traps, which fails the launch and the run.  The host makes the
//     rank's stream wait for every shard's producer before the launch and
//     queues every rank's copies before any rank's kernel, so a waiting
//     block waits only for copies.  That ordering alone does not keep the
//     copies running: a launch of every tile at TP 8 traps (the copies
//     need block slots, or wait behind the kernels in a hardware queue).
//     What keeps them running is the grid bound: when the ranks share one
//     card, their waiting blocks never hold all of its block slots
//     (launch, kReservedSlots).
// What bounds it on the card: the ranks' GEMMs (2 n M_sh N_loc K
// operations a rank); the copies move (n - 1) M_sh K elements a rank
// through HBM beside them.  No TMA, wgmma or persistent schedule yet.
// The launch goes on the caller's stream; nothing is allocated or
// synchronised here.  Each function returns a cudaError_t.

#include <cuda.h>

#include <algorithm>

#include "gemm_tile.cuh"

namespace {

constexpr unsigned long long kWaitNs = 2000000000ull;   // 2 s
// block slots of the card left free of AG-GEMM blocks (see launch)
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

template <class Tile, typename OutT>
__global__ void __launch_bounds__(Tile::kThreads)
ag_gemm_kernel(const AgArgs params) {
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

// The grid: every tile when the rank has the card to itself (share <= 1);
// when `share` ranks run on one card, each gets at most 1/share of the
// card's resident block slots less kReservedSlots, and its blocks loop over
// the tiles.  Waiting blocks then never hold every slot: the copies (and
// the other ranks' work) always find room, whether or not the driver runs
// a copy on the SMs.
template <class Tile, typename OutT>
cudaError_t launch(const AgArgs& p, int share, cudaStream_t stream) {
  auto kern = ag_gemm_kernel<Tile, OutT>;
  cudaError_t e = tile::allow_smem(kern, Tile::kSmem);
  if (e != cudaSuccess) return e;
  const int tiles = tile::cdiv(p.n_dev * p.m_sh, Tile::kBM) *
                    tile::cdiv(p.n_loc, Tile::kBN);
  int grid = tiles;
  if (share > 1) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kern, Tile::kThreads, Tile::kSmem)) != cudaSuccess)
      return e;
    grid = std::min(tiles, std::max(1, (per_sm * sms - kReservedSlots) / share));
  }
  kern<<<grid, Tile::kThreads, Tile::kSmem, stream>>>(p);
  return cudaGetLastError();
}

using WriteValue32 = CUresult (*)(CUstream, CUdeviceptr, cuuint32_t,
                                  unsigned int);

// cuStreamWriteValue32 from the driver, found at run time (no link against
// libcuda): the stream's front end writes the value, no SM and no copy.
WriteValue32 write_value32() {
  static const WriteValue32 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuStreamWriteValue32", &p, cudaEnableDefault,
                                &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return static_cast<WriteValue32>(nullptr);
    return reinterpret_cast<WriteValue32>(p);
  }();
  return fn;
}

template <typename OutT>
cudaError_t launch_in(int in_dtype, int tile_code, const AgArgs& p,
                      int share, cudaStream_t s) {
  if (in_dtype == 0) return launch<tile::F32Tile, OutT>(p, share, s);
  if (in_dtype != 1) return cudaErrorInvalidValue;
  if (tile_code == 0) return launch<tile::WideTile, OutT>(p, share, s);
  if (tile_code == 1) return launch<tile::NarrowTile, OutT>(p, share, s);
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
// 128, 1 = 64 x 64.  act: gemm_tile.cuh's activation codes.  share: the
// ranks that run on this card at once (see launch).
extern "C" int ag_gemm_fwd(const void* a_local, const void* a_agg,
                           const int* flags, const void* b, const float* bias,
                           void* c, int m_sh, int n_loc, int k, int n_dev,
                           int me, int reverse, int epoch, int act,
                           int in_dtype, int out_dtype, int tile_code,
                           int share, void* stream) {
  const AgArgs p{a_local, a_agg, flags, b, bias, c, m_sh, n_loc, k, n_dev, me,
                 reverse ? -1 : 1, epoch, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (out_dtype == 1)
    err = launch_in<__nv_bfloat16>(in_dtype, tile_code, p, share, s);
  else if (out_dtype == 0)
    err = launch_in<float>(in_dtype, tile_code, p, share, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// Fused GEMM-ReduceScatter for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces: src/repro/kernels/gemm_rs.py::_gemm_rs_kernel (wrapper gemm_rs,
// reached through kernels/ops.py::matmul_rs_fused and FusedOp(kind="rs",
// mode="flux")): the paper's Algorithm 1, in the GPU original's form that
// the TPU ring replaced (gemm_rs.py:10-18): each output tile goes straight
// to its owner, and the owner reduces.
//
// Per rank, out[M_sh, N] = act(sum over ranks of (A_local @ B_local)[rows
// of this rank] + bias), A_local [M = n M_sh, K_sh], B_local [K_sh, N]:
//   * gemm_rs_fwd: one GEMM launch over the rank's M rows.  Its epilogue
//     stores each fp32 tile as a partial_dtype tile into the OWNER's
//     reduction slot ws[owner][me] (through the owner's pointer: the ranks
//     of a dist.RankGroup share one card).  Rows are walked in the
//     reference's swizzled owner order, owner = (me + sgn (n - 1 - s)) mod
//     n for s = 0..n-1 (gemm_rs.py:57; paper Fig. 7), so the ranks start
//     on different owners; a small M_sh packs several owners' rows into
//     one tile.  The tile loop is gemm_tile.cuh's: bf16 wgmma_gemm (TMA +
//     wgmma, persistent, one CTA an SM), whose A map is A_local viewed as
//     [n, M_sh, K_sh], one row block an owner; fp32 F32Tile.
//   * After an event barrier across the ranks (kernels/gemm_rs.py),
//     gemm_rs_reduce: this rank sums its n slots in fixed rank order in
//     fp32, adds the bias once, applies the activation and casts.
// No kernel waits on another, so the op cannot deadlock.  Its summation
// order differs from the reference's ring (partials rounded to
// partial_dtype once each, summed in fp32), so the tests state the
// tolerance.
// What bounds it on the card: the ranks' GEMMs (2 M K_sh N operations a
// rank) and, for the reduce, n M_sh N partials read once.  Launches go on
// the caller's stream; nothing is allocated or synchronised here.  Each
// function returns a cudaError_t.

#include "gemm_tile.cuh"

namespace {

constexpr int kMaxRanks = 8;

struct RsArgs {
  const void* a;             // [n_dev * m_sh, k]
  const void* b;             // [k, n]
  void* ws[kMaxRanks];       // owner o's workspace [n_dev, m_sh, n]
  int m_sh, n, k, n_dev, me, sgn;
};

// fp32: one block a tile
template <class Tile, typename PartT>
__global__ void __launch_bounds__(Tile::kThreads)
gemm_rs_f32_kernel(const RsArgs params) {
  using T = typename Tile::T;
  const RsArgs p = params;   // a local copy: the lambdas below capture it
  extern __shared__ __align__(16) unsigned char smem[];
  const int m_tot = p.n_dev * p.m_sh;
  const int tiles_m = tile::cdiv(m_tot, Tile::kBM);
  const int tiles_n = tile::cdiv(p.n, Tile::kBN);
  const T* a = static_cast<const T*>(p.a);
  // walk position s computes the rows of owner (me + sgn (n - 1 - s)) mod n
  auto owner_of = [&](int s) {
    return ((p.me + p.sgn * (p.n_dev - 1 - s)) % p.n_dev + p.n_dev) %
           p.n_dev;
  };
  for (int t = blockIdx.x; t < tiles_m * tiles_n; t += gridDim.x) {
    int tm, tn;
    tile::tile_coords(t, tiles_m, tiles_n, &tm, &tn);
    const int g0 = tm * Tile::kBM;
    const int rows = min(Tile::kBM, m_tot - g0);
    const int n0 = tn * Tile::kBN;
    Tile tl;
    tl.run([&](int r) -> const T* {
             if (r >= rows) return nullptr;
             const int g = g0 + r, s = g / p.m_sh;
             return a + ((int64_t)owner_of(s) * p.m_sh + (g - s * p.m_sh))
                        * p.k;
           }, static_cast<const T*>(p.b), p.n, p.k, n0, smem);
    tl.emit(rows, p.n, n0, [&](int r, int col, float x, float y) {
      const int g = g0 + r, s = g / p.m_sh;
      PartT* slot = static_cast<PartT*>(p.ws[owner_of(s)]) +
                    (int64_t)p.me * p.m_sh * p.n;
      tile::store2(slot + (int64_t)(g - s * p.m_sh) * p.n + col, x, y);
    });
  }
}

// bf16: gemm_tile.cuh's loop; walk position s computes the rows of owner
// (me + sgn (n - 1 - s)) mod n, row block `owner` of A
template <typename PartT>
struct RsOp {
  void* ws[kMaxRanks];
  int m_sh, n, n_dev, me, sgn;

  __device__ int owner(int s) const {
    return ((me + sgn * (n_dev - 1 - s)) % n_dev + n_dev) % n_dev;
  }
  __device__ int shard(int s) const { return owner(s); }
  __device__ bool local(int) const { return false; }
  __device__ void wait(int, int) const {}
  __device__ void store(int s, int r, int col, float x, float y) const {
    PartT* slot = static_cast<PartT*>(ws[owner(s)]) + (int64_t)me * m_sh * n;
    tile::store2(slot + (int64_t)r * n + col, x, y);
  }
};

template <class Cfg, typename PartT>
__global__ void __launch_bounds__(Cfg::kThreads, 1)
gemm_rs_wgmma_kernel(const __grid_constant__ CUtensorMap a,
                     const __grid_constant__ CUtensorMap b,
                     const tile::Walk w, const RsOp<PartT> op) {
  tile::wgmma_gemm<Cfg>(&a, &a, &b, w, op);
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

// out[i] = act(sum_s ws[s][i] + bias[i % n]), four elements a thread (n is
// a multiple of 4, so four never straddle a row)
template <typename PartT, typename OutT>
__global__ void __launch_bounds__(256)
rs_reduce_kernel(const PartT* __restrict__ ws, const float* __restrict__ bias,
                 OutT* __restrict__ out, int64_t count, int n, int n_dev,
                 int act) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x * 4;
  for (int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
       i < count; i += stride) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < n_dev; ++s) {
      float v[4];
      load4(ws + (int64_t)s * count + i, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] += v[j];
    }
    const int col = static_cast<int>(i % n);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (bias != nullptr) acc[j] += bias[col + j];
      acc[j] = tile::activate(act, acc[j]);
    }
    tile::store2(out + i, acc[0], acc[1]);
    tile::store2(out + i + 2, acc[2], acc[3]);
  }
}

template <class Cfg, typename PartT>
cudaError_t launch_wgmma(const RsArgs& p, int m_pad, int box_rows,
                         int group_m, cudaStream_t stream) {
  CUtensorMap am, bm;
  cudaError_t e;
  if ((e = tile::a_map(&am, p.a, p.k, p.m_sh, p.n_dev, box_rows)) !=
          cudaSuccess ||
      (e = tile::b_map(&bm, p.b, p.k, p.n)) != cudaSuccess)
    return e;
  auto kern = gemm_rs_wgmma_kernel<Cfg, PartT>;
  if ((e = tile::allow_smem(kern, Cfg::kSmem)) != cudaSuccess) return e;
  const int tiles = tile::cdiv(p.n_dev * m_pad, Cfg::kBM) *
                    tile::cdiv(p.n, Cfg::kBN);
  int grid = 0;
  if ((e = tile::persistent_grid(kern, Cfg::kThreads, Cfg::kSmem, tiles, 1,
                                 0, &grid)) != cudaSuccess)
    return e;
  RsOp<PartT> op{};
  for (int i = 0; i < kMaxRanks; ++i) op.ws[i] = p.ws[i];
  op.m_sh = p.m_sh;
  op.n = p.n;
  op.n_dev = p.n_dev;
  op.me = p.me;
  op.sgn = p.sgn;
  const tile::Walk w{p.m_sh, m_pad, box_rows, p.n_dev, p.n, p.k, group_m};
  kern<<<grid, Cfg::kThreads, Cfg::kSmem, stream>>>(am, bm, w, op);
  return cudaGetLastError();
}

template <typename PartT>
cudaError_t launch_f32(const RsArgs& p, cudaStream_t stream) {
  using Tile = tile::F32Tile;
  auto kern = gemm_rs_f32_kernel<Tile, PartT>;
  const cudaError_t e = tile::allow_smem(kern, Tile::kSmem);
  if (e != cudaSuccess) return e;
  const int tiles = tile::cdiv(p.n_dev * p.m_sh, Tile::kBM) *
                    tile::cdiv(p.n, Tile::kBN);
  kern<<<tiles, Tile::kThreads, Tile::kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <typename PartT>
cudaError_t launch_in(int in_dtype, int tile_code, const RsArgs& p,
                      int m_pad, int box_rows, int group_m,
                      cudaStream_t s) {
  if (in_dtype == 0) return launch_f32<PartT>(p, s);
  if (in_dtype != 1) return cudaErrorInvalidValue;
  if (tile_code == 0)
    return launch_wgmma<tile::LargeTile, PartT>(p, m_pad, box_rows, group_m,
                                                s);
  if (tile_code == 1)   // small M
    return launch_wgmma<tile::SmallTile, PartT>(p, m_pad, box_rows, group_m,
                                                s);
  return cudaErrorInvalidValue;
}

template <typename PartT, typename OutT>
cudaError_t launch_reduce(const void* ws, const float* bias, void* out,
                          int m_sh, int n, int n_dev, int act,
                          cudaStream_t s) {
  const int64_t count = (int64_t)m_sh * n;
  const int64_t groups = (count + 3) / 4;
  const int blocks = static_cast<int>(
      groups / 256 + 1 < 132 * 16 ? groups / 256 + 1 : 132 * 16);
  rs_reduce_kernel<PartT, OutT><<<blocks, 256, 0, s>>>(
      static_cast<const PartT*>(ws), bias, static_cast<OutT*>(out), count, n,
      n_dev, act);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16.  ws_ptrs: the n_dev owners'
// workspaces (host array of device pointers).  tile_code (bf16 only): 0 =
// 128 x 256, 1 = 64 x 64; m_pad, box_rows, group_m (bf16
// only): the owners' virtual rows, the A box height and the raster's group
// of tile rows (gemm_tile.cuh).
extern "C" int gemm_rs_fwd(const void* a, const void* b,
                           const void* const* ws_ptrs, int m_sh, int n,
                           int k, int n_dev, int me, int reverse,
                           int in_dtype, int part_dtype, int tile_code,
                           int m_pad, int box_rows, int group_m,
                           void* stream) {
  if (n_dev < 1 || n_dev > kMaxRanks) return cudaErrorInvalidValue;
  RsArgs p{};
  p.a = a;
  p.b = b;
  for (int i = 0; i < n_dev; ++i) p.ws[i] = const_cast<void*>(ws_ptrs[i]);
  p.m_sh = m_sh;
  p.n = n;
  p.k = k;
  p.n_dev = n_dev;
  p.me = me;
  p.sgn = reverse ? -1 : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (part_dtype == 1)
    err = launch_in<__nv_bfloat16>(in_dtype, tile_code, p, m_pad, box_rows,
                                   group_m, s);
  else if (part_dtype == 0)
    err = launch_in<float>(in_dtype, tile_code, p, m_pad, box_rows, group_m, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// out[m_sh, n] = act(sum_s ws[s] + bias); ws is this rank's [n_dev, m_sh,
// n] workspace; act: gemm_tile.cuh's activation codes.
extern "C" int gemm_rs_reduce(const void* ws, const float* bias, void* out,
                              int m_sh, int n, int n_dev, int act,
                              int part_dtype, int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (part_dtype == 1 && out_dtype == 1)
    err = launch_reduce<__nv_bfloat16, __nv_bfloat16>(ws, bias, out, m_sh, n,
                                                      n_dev, act, s);
  else if (part_dtype == 1 && out_dtype == 0)
    err = launch_reduce<__nv_bfloat16, float>(ws, bias, out, m_sh, n, n_dev,
                                              act, s);
  else if (part_dtype == 0 && out_dtype == 1)
    err = launch_reduce<float, __nv_bfloat16>(ws, bias, out, m_sh, n, n_dev,
                                              act, s);
  else if (part_dtype == 0 && out_dtype == 0)
    err = launch_reduce<float, float>(ws, bias, out, m_sh, n, n_dev, act, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

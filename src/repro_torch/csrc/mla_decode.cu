// Absorbed-MLA decode attention for Hopper (sm_90a): wgmma + TMA, split over
// the cache (flash-decoding), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/mla_decode.py::_mla_kernel (wrapper
// mla_decode_attention, the Pallas TPU kernel that DeepSeek-V3's decode
// reaches through models/attention.py::mla_decode and mla_decode_paged when
// ctx.use_kernels is set).
//
// Computes what the TPU kernel computes, for q_eff [B, H, R] fp32,
// q_rope [B, H, Dr] fp32, the latent cache c [B, S, R] bf16, the rope-key
// cache kr [B, S, Dr] bf16 and valid_len [B] int32 (all row-major,
// contiguous), out [B, H, R] fp32:
//   score_s = (q_eff . c_s + q_rope . kr_s) * scale in fp32, set to -1e30
//   where s >= valid_len[b]; online softmax with running m, l, acc in fp32;
//   out = acc / max(l, 1e-30),
// to 1e-4 (fp32 sums in another order, and q and P fed as bf16 hi/lo pairs,
// below).  A row with valid_len <= 0 has every score at -1e30, so it reads
// all S rows and gets their mean; valid_len > S reads all S rows.  TMA
// loads a split's last tile of 32 rows whole, so up to 31 rows past the
// read length are read and weighted 0 (score -inf): the caches must hold
// finite values there, as the plain version also assumes (it multiplies
// every row by its weight).
//
// What bounds it on the card: 2*B*H*S*(2R + Dr) operations against the
// caches' bytes.  The H heads share every latent row (about 250 operations
// a byte at H 128), so the work sits near the H100's ridge point and
// belongs on the tensor cores.  The queries are fp32: one bf16 rounding of
// q, or of the softmax weights P, misses the fp32 tolerance (1e-4) by 3-30x
// (an fp64 emulation at the lane's shape, tests/test_torch_mla_decode.py);
// TF32 misses it too.  So both fp32 operands go in as bf16 pairs, hi =
// bf16(x) and lo = bf16(x - hi), each product as two bf16 wgmmas: twice the
// bf16 tensor work, the TF32 rate that chip_smoke.py's bound divides by.
//
// Design:
//   * heads on wgmma's M: a CTA takes 64 heads of one batch row (heads
//     past H are zero rows, never stored) and one contiguous range of its
//     cache rows; the grid is n_splits x head tiles x B.  n_splits comes
//     from the host (kernels/mla_decode.py::split_plan), from B, H and S
//     only: the kernel reads valid_len[b] itself, and a CTA whose range
//     lies past the row's read length marks its split empty (m = -inf,
//     distinct from the -1e30 of a masked score, which must still count in
//     a valid_len <= 0 row's mean);
//   * 384 threads: one producer warpgroup (one thread issues TMA loads;
//     setmaxnreg hands its registers to the consumers) and two consumer
//     warpgroups;
//   * the consumers first write q_hi and q_lo ([64, 576] bf16 each, R then
//     Dr) into shared memory by hand, in the 128-byte-swizzled K-major
//     layout that TMA gives a tile (TMA cannot convert fp32), and fence it
//     for the async proxy;
//   * a 2-stage ring of 32 cache rows: nine 3-D TMA boxes [32 rows, 64
//     columns] a stage, eight of c (map [B, S, 512]) and one of kr (map
//     [B, S, 64]); a box past S zero-fills, and those rows get a score of
//     -inf;
//   * scores S[64, 32] = q_hi . [c|kr]^T + q_lo . [c|kr]^T: wgmma m64n32k16
//     with both operands K-major in shared memory.  Each warpgroup takes
//     half of the 576-deep contraction and the halves are summed through
//     an 8 KB exchange buffer (two named barriers a tile), cheaper than
//     both warpgroups computing all of it (PERF.md);
//   * the online softmax in the log2 domain on the accumulator fragment;
//     P (fp32) is split in registers into P_hi + P_lo, the m64k16
//     register-A fragments (the m64n32 accumulator layout is that
//     fragment's, as in flash_attention.cu);
//   * O[64, 512] += P_hi . C + P_lo . C: the same shared tile read
//     MN-major with the transpose bit; each consumer warpgroup owns 256 of
//     the 512 output columns (128 fp32 accumulators a thread);
//   * one split writes out = O / max(l, 1e-30) directly.  Several write
//     their unnormalised O [B, n_splits, H, R] and (m, l) [B, n_splits, H],
//     and mla_combine_kernel, a second launch on the same stream, merges
//     them: out = sum_i 2^(m_i - M) O_i / sum_i 2^(m_i - M) l_i over the
//     splits that are not empty.
// Shared memory: 2 x 73 728 (q_hi, q_lo) + 2 x 36 864 (stages) + 8 192
// (exchange) + barriers, 230 432 bytes with the alignment slack, of the
// 232 448 a block may use: one CTA an SM.  So the ring has two stages, and
// the consumers hold one while the producer fills the other: a tile's
// tensor work and its load overlap only that far.  Registers: ptxas gives
// a 384-thread kernel at most 168 a thread whatever setmaxnreg does later,
// and the 128 accumulators of O take most of them.
// The launches go on the caller's stream; nothing is allocated or
// synchronised here.  The function returns a cudaError_t.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;   // the TPU kernel's mask value
constexpr float kMinDenom = 1e-30f; // floor on l
constexpr float kLog2e = 1.4426950408889634f;
constexpr int R = 512;              // kv_lora_rank
constexpr int DR = 64;              // qk_rope_head_dim
constexpr int K = R + DR;           // the scores' contraction
constexpr int kAtoms = K / 64;      // 128-byte column blocks of a row
constexpr int kSteps = K / 16;      // k16 steps of the scores
constexpr int kHeads = 64;          // heads a CTA: wgmma's M
constexpr int kRows = 32;           // cache rows a stage: the scores' N
constexpr int kStages = 2;
constexpr int kThreads = 384;
constexpr int kConsumers = 256;
constexpr int Q_BYTES = kHeads * K * 2;         // one of q_hi, q_lo
constexpr int STAGE_BYTES = kRows * K * 2;
constexpr int BLOCK_BYTES = kRows * 128;        // one TMA box
constexpr int X_BYTES = kHeads * kRows * 4;      // the score exchange
constexpr int kSmem =
    1024 + 2 * Q_BYTES + kStages * STAGE_BYTES + X_BYTES + 2 * kStages * 8;
static_assert(kSmem <= 232448, "shared memory a block may use");
static_assert(K % 64 == 0 && R % 256 == 0, "DeepSeek-V3's widths");

struct MlaArgs {
  const float* q_eff;
  const float* q_rope;
  const int* valid_len;
  float* out;           // [B, H, R], written when n_splits == 1
  float* part_o;        // [B, n_splits, H, R] unnormalised, n_splits > 1
  float2* part_ml;      // [B, n_splits, H]: (m in log2 units, l)
  int heads, s, n_splits, split_rows;
  float scale_log2;
};

__global__ void __launch_bounds__(kThreads, 1)
mla_wgmma_kernel(const __grid_constant__ CUtensorMap c_map,
                 const __grid_constant__ CUtensorMap kr_map,
                 const MlaArgs p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_hi = smem;
  unsigned char* q_lo = smem + Q_BYTES;
  unsigned char* stages = smem + 2 * Q_BYTES;
  float* xbuf = reinterpret_cast<float*>(stages + kStages * STAGE_BYTES);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(stages + kStages * STAGE_BYTES + X_BYTES);
  uint64_t* empty = full + kStages;

  const int split = blockIdx.x;
  const int h0 = blockIdx.y * kHeads;
  const int b = blockIdx.z;
  const int vl = p.valid_len[b];
  const int rows = (vl <= 0 || vl > p.s) ? p.s : vl;   // rows the row reads
  const int row0 = split * p.split_rows;
  const int row_end = min(row0 + p.split_rows, rows);
  const int n_tiles = row_end > row0 ? (row_end - row0 + kRows - 1) / kRows
                                     : 0;
  // (b, split, head 0) of the partials
  const int64_t part = ((int64_t)b * p.n_splits + split) * p.heads;
  if (n_tiles == 0) {   // past the row's read length (never split 0)
    if (threadIdx.x < kHeads && h0 + threadIdx.x < p.heads)
      p.part_ml[part + h0 + threadIdx.x] = make_float2(-INFINITY, 0.f);
    return;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::bar_init(full + s, 1);
      hopper::bar_init(empty + s, 8);   // the consumers' 8 warps
    }
    hopper::bar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer ----
    hopper::regs_dealloc<40>();
    if (threadIdx.x == 256) {
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        hopper::bar_wait(empty + s, ((j / kStages) & 1) ^ 1);
        unsigned char* st = stages + s * STAGE_BYTES;
        const int r0 = row0 + j * kRows;
        hopper::bar_expect(full + s, STAGE_BYTES);
        for (int a = 0; a < kAtoms - 1; ++a)
          hopper::tma_load_3d(st + a * BLOCK_BYTES, &c_map, full + s, 64 * a,
                              r0, b);
        hopper::tma_load_3d(st + (kAtoms - 1) * BLOCK_BYTES, &kr_map,
                            full + s, 0, r0, b);
      }
    }
    return;
  }

  // ---- consumers ----
  hopper::regs_alloc<232>();
  // q_hi, q_lo: row r (head h0 + r), 16-byte chunk c of the 576 columns
  // (R then Dr) at column block c / 8, chunk (c % 8) ^ (r % 8)
  // (kQBatch chunks' loads in flight a thread before any store)
  constexpr int kQChunks = kHeads * (K / 8) / kConsumers;
  constexpr int kQBatch = 6;
  static_assert(kHeads * (K / 8) % kConsumers == 0 && kQChunks % kQBatch == 0,
                "q chunks a thread");
  for (int g = 0; g < kQChunks; g += kQBatch) {
    float4 x[kQBatch][2];
#pragma unroll
    for (int u = 0; u < kQBatch; ++u) {
      const int idx = threadIdx.x + (g + u) * kConsumers;
      const int r = idx / (K / 8);
      const int c = idx % (K / 8);
      x[u][0] = x[u][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (h0 + r < p.heads) {
        const int64_t bh = (int64_t)b * p.heads + h0 + r;
        const float* src = c < R / 8 ? p.q_eff + bh * R + 8 * c
                                     : p.q_rope + bh * DR + 8 * (c - R / 8);
        x[u][0] = __ldg(reinterpret_cast<const float4*>(src));
        x[u][1] = __ldg(reinterpret_cast<const float4*>(src + 4));
      }
    }
#pragma unroll
    for (int u = 0; u < kQBatch; ++u) {
      const int idx = threadIdx.x + (g + u) * kConsumers;
      const int r = idx / (K / 8);
      const int c = idx % (K / 8);
      uint4 hi, lo;
      hopper::split_bf16x2(x[u][0].x, x[u][0].y, hi.x, lo.x);
      hopper::split_bf16x2(x[u][0].z, x[u][0].w, hi.y, lo.y);
      hopper::split_bf16x2(x[u][1].x, x[u][1].y, hi.z, lo.z);
      hopper::split_bf16x2(x[u][1].z, x[u][1].w, hi.w, lo.w);
      const int off =
          (c / 8) * kHeads * 128 + r * 128 + (((c % 8) ^ (r % 8)) << 4);
      *reinterpret_cast<uint4*>(q_hi + off) = hi;
      *reinterpret_cast<uint4*>(q_lo + off) = lo;
    }
  }
  hopper::fence_proxy_async_shared();
  hopper::named_bar_sync(1, kConsumers);

  const int t = threadIdx.x & 127;
  const int lane = t & 31;
  const int warp = t / 32;
  const int col_of = 2 * (lane & 3);     // + 8 jb + (i & 1)
  // this warpgroup's half of the scores' k16 steps
  constexpr int kMine = kSteps / 2;
  const int k_first = wg * kMine;
  float o[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};               // this thread's part of the sum
  float sc[16];

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const unsigned char* st = stages + s * STAGE_BYTES;
    hopper::bar_wait(full + s, (j / kStages) & 1);

    // S = q_hi [c|kr]^T + q_lo [c|kr]^T over this warpgroup's k16 steps
    hopper::wgmma_fence();
#pragma unroll
    for (int w = 0; w < 2 * kMine; ++w) {
      const int kk = k_first + w % kMine;
      const uint64_t da =
          hopper::desc((w < kMine ? q_hi : q_lo) + (kk / 4) * kHeads * 128,
                       16, 1024) + 2 * (kk % 4);
      const uint64_t db =
          hopper::desc(st + (kk / 4) * BLOCK_BYTES, 16, 1024) + 2 * (kk % 4);
      hopper::wgmma_ss<kRows, 0>(sc, da, db, w > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // warpgroup 1's half to warpgroup 0, the sum back: thread t of each
    // holds the same (head, row) positions
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < 16; ++i) xbuf[i * 128 + t] = sc[i];
    }
    hopper::named_bar_sync(1, kConsumers);
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        sc[i] += xbuf[i * 128 + t];
        xbuf[i * 128 + t] = sc[i];
      }
    }
    hopper::named_bar_sync(2, kConsumers);
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < 16; ++i) sc[i] = xbuf[i * 128 + t];
    }

    // mask and scale (log2 domain): rows past the split's read range
    // -inf (they add nothing); a valid_len <= 0 row -1e30 everywhere
    const int r0 = row0 + j * kRows;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int row = r0 + 8 * (i / 4) + col_of + (i & 1);
      sc[i] = row >= row_end ? -INFINITY
                             : (vl <= 0 ? kNegInf : sc[i] * p.scale_log2);
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);   // finite: row r0 is read
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    // P to bf16 hi/lo A fragments (two n8 blocks a k16 step)
    uint32_t pa[2][2][4];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      sc[i] = exp2f(sc[i] - m[(i >> 1) & 1]);
      l[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        hopper::split_bf16x2(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1],
                             pa[0][kk][e], pa[1][kk][e]);
    if (alpha[0] != 1.f || alpha[1] != 1.f) {   // the row maxima moved
#pragma unroll
      for (int i = 0; i < 128; ++i) o[i] *= alpha[(i >> 1) & 1];
    }

    // O[:, 256 wg ..] += P_hi C + P_lo C; C is MN-major: LBO to the next 64
    // columns (the next box), a k16 step 16 rows further
    hopper::wgmma_fence();
    hopper::fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint64_t db =
          hopper::desc(st + 4 * wg * BLOCK_BYTES, BLOCK_BYTES, 1024) +
          128 * kk;
      hopper::wgmma_rs<256, 1>(o, pa[0][kk], db, 1);
      hopper::wgmma_rs<256, 1>(o, pa[1][kk], db, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    if (lane == 0) hopper::bar_arrive(empty + s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const bool direct = p.n_splits == 1;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int head = h0 + 16 * warp + lane / 4 + 8 * r;
    if (head >= p.heads) continue;
    const float inv = direct ? 1.f / fmaxf(l[r], kMinDenom) : 1.f;
    float* op = (direct ? p.out + ((int64_t)b * p.heads + head) * R
                        : p.part_o + (part + head) * R) +
                256 * wg + col_of;
#pragma unroll
    for (int jb = 0; jb < 32; ++jb)
      *reinterpret_cast<float2*>(op + 8 * jb) =
          make_float2(o[4 * jb + 2 * r] * inv, o[4 * jb + 2 * r + 1] * inv);
    if (!direct && wg == 0 && (lane & 3) == 0)
      p.part_ml[part + head] = make_float2(m[r], l[r]);
  }
}

// out[b, h] = sum_i w_i O_i / max(sum_i w_i l_i, 1e-30), w_i = 2^(m_i - M)
// over the splits that are not empty (m_i = -inf), M = max_i m_i; one block
// per (head, batch row), four columns a thread
__global__ void __launch_bounds__(R / 4)
mla_combine_kernel(const float* __restrict__ part_o,
                   const float2* __restrict__ part_ml, float* __restrict__ out,
                   int heads, int n_splits) {
  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int col = 4 * threadIdx.x;
  const int64_t base = (int64_t)b * n_splits * heads + head;
  float mx = -INFINITY;
  for (int i = 0; i < n_splits; ++i)
    mx = fmaxf(mx, part_ml[base + (int64_t)i * heads].x);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float l = 0.f;
  for (int i = 0; i < n_splits; ++i) {
    const float2 ml = part_ml[base + (int64_t)i * heads];
    if (ml.x == -INFINITY) continue;   // empty: its O was never written
    const float w = exp2f(ml.x - mx);
    l = fmaf(w, ml.y, l);
    const float4 v = *reinterpret_cast<const float4*>(
        part_o + (base + (int64_t)i * heads) * R + col);
    acc.x = fmaf(w, v.x, acc.x);
    acc.y = fmaf(w, v.y, acc.y);
    acc.z = fmaf(w, v.z, acc.z);
    acc.w = fmaf(w, v.w, acc.w);
  }
  const float inv = 1.f / fmaxf(l, kMinDenom);
  *reinterpret_cast<float4*>(out + ((int64_t)b * heads + head) * R + col) =
      make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
}

cudaError_t launch(const void* q_eff, const void* q_rope, const void* c,
                   const void* kr, const void* valid_len, void* out,
                   void* part_o, void* part_ml, int batch, int heads, int s,
                   int n_splits, int split_rows, float scale,
                   cudaStream_t stream) {
  CUtensorMap cm, km;
  const uint64_t cdims[3] = {R, (uint64_t)s, (uint64_t)batch};
  const uint64_t cstr[2] = {R * 2, (uint64_t)s * R * 2};
  const uint64_t kdims[3] = {DR, (uint64_t)s, (uint64_t)batch};
  const uint64_t kstr[2] = {DR * 2, (uint64_t)s * DR * 2};
  const uint32_t box[3] = {64, kRows, 1};
  cudaError_t e;
  if ((e = hopper::make_map(&cm, c, 3, cdims, cstr, box)) != cudaSuccess ||
      (e = hopper::make_map(&km, kr, 3, kdims, kstr, box)) != cudaSuccess)
    return e;
  if ((e = cudaFuncSetAttribute(mla_wgmma_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmem)) != cudaSuccess)
    return e;
  MlaArgs args{static_cast<const float*>(q_eff),
               static_cast<const float*>(q_rope),
               static_cast<const int*>(valid_len),
               static_cast<float*>(out),
               static_cast<float*>(part_o),
               static_cast<float2*>(part_ml),
               heads, s, n_splits, split_rows, scale * kLog2e};
  const dim3 grid(n_splits, (heads + kHeads - 1) / kHeads, batch);
  mla_wgmma_kernel<<<grid, kThreads, kSmem, stream>>>(cm, km, args);
  if ((e = cudaGetLastError()) != cudaSuccess || n_splits == 1) return e;
  mla_combine_kernel<<<dim3(heads, batch), R / 4, 0, stream>>>(
      static_cast<const float*>(part_o), static_cast<const float2*>(part_ml),
      static_cast<float*>(out), heads, n_splits);
  return cudaGetLastError();
}

}  // namespace

// DeepSeek-V3's widths: latent 512, rope 64.  The cache rows of each batch
// row go to n_splits ranges of split_rows (a multiple of 32) rows; with
// n_splits > 1, part_o [B, n_splits, H, 512] fp32 and part_ml [B, n_splits,
// H, 2] fp32 are the caller's workspace, and a second kernel (the combine)
// follows the first on the stream.
extern "C" int mla_decode_fwd(const void* q_eff, const void* q_rope,
                              const void* c, const void* kr,
                              const void* valid_len, void* out, void* part_o,
                              void* part_ml, int batch, int heads, int s,
                              int latent, int rope, int n_splits,
                              int split_rows, float scale, void* stream) {
  if (batch <= 0 || batch > 65535 || heads <= 0 || s <= 0 || latent != R ||
      rope != DR || n_splits <= 0 || split_rows <= 0 ||
      split_rows % kRows != 0 || (int64_t)n_splits * split_rows < s ||
      (int64_t)(n_splits - 1) * split_rows >= s ||
      (heads + kHeads - 1) / kHeads > 65535 ||
      (n_splits > 1 && (part_o == nullptr || part_ml == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)launch(q_eff, q_rope, c, kr, valid_len, out, part_o, part_ml,
                     batch, heads, s, n_splits, split_rows, scale,
                     static_cast<cudaStream_t>(stream));
}

// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_kernel (wrapper
// flash_attention, the Pallas TPU kernel the prefill path reaches through
// models/attention.py::gqa_train when ctx.use_kernels is set).
//
// Computes exactly what the TPU kernel computes, for q [B, Hq, Sq, D] and
// k, v [B, Hkv, Skv, D] (row-major, contiguous), out [B, Hq, Sq, D]:
//   s = (q . k) * scale in fp32; causal mask q_pos = kv_offset + i >= k_pos
//   with masked scores set to -1e30 (not -inf); online softmax with running
//   m, l, acc in fp32; out = acc / max(l, 1e-30) cast to the input type.
//   GQA reads kv head h / (Hq / Hkv) directly (no repeat of K/V); causal
//   kv tiles past the block's last query row are skipped.
//
// What bounds it on the card: at the slice's shape (minicpm_2b prefill,
// B=4, H=36, S=1024, D=64, bf16, causal) the work is ~19 GFLOP of QK^T and
// PV against ~75 MB of q/k/v/out, about 256 FLOP a byte, near the H100's
// bf16 ridge (~295): only the tensor cores, fed from shared memory, come
// near it.  The same kernel on the fp32 CUDA cores (67 TFLOP/s) ran at
// 1.6 % of the bound.
//
// Design of the bf16 kernel (flash_wgmma_kernel; FlashAttention-3's shape):
//   * one CTA per (128 query rows, b * Hq + h), 384 threads: two consumer
//     warpgroups of 64 query rows each and one producer warpgroup, whose
//     registers setmaxnreg hands to the consumers.  Blocks are numbered
//     heaviest first: under the causal mask the last query tiles attend
//     to the most kv tiles, and they start first, so the tail of the grid
//     is light (flash_attention.py::block_order mirrors the numbering);
//   * one producer thread issues TMA loads: Q once, then K and V tiles of
//     BKV rows (128 at D 64, 64 at D 128) into a 3-stage ring (2 stages
//     were 12-27 % slower), each with its own mbarrier, so Q K^T starts
//     before V lands.  The tensor maps
//     are 3-D [B * H, S, D]: a box past S zero-fills instead of reading
//     the next head.  A row of D 128 is two 64-column swizzle atoms, two
//     boxes;
//   * S = Q K^T by wgmma m64nBKVk16 from shared memory, Q and K both
//     K-major, fp32 accumulators in registers;
//   * softmax on the accumulator fragment in the log2 domain (scores times
//     scale * log2 e, exp2): each thread holds two rows, row max across
//     the quad by two shuffles, the row sum kept per thread and reduced
//     once at the end.  The causal and ragged-Skv masks (zero-filled K
//     rows score 0, so k_pos >= Skv is masked too) run only on the tiles
//     that cross the diagonal or the end of K;
//   * O += P V by wgmma with P as the register A operand: the m64nNk16
//     accumulator layout is the m64k16 A fragment, so P is rounded to
//     bf16 in place (about 2^-9 relative per weight); V [kv, D] is
//     MN-major and is read with the transpose bit;
//   * a software pipeline inside each warpgroup: S_j = Q K_j^T and
//     O += P_j-1 V_j-1 are in flight together, and the softmax of S_j runs
//     while the tensor cores finish P_j-1 V_j-1 (O is rescaled after);
//   * the stage goes back to the producer after P V; rows past Sq are not
//     stored.
// fp32 inputs take flash_f32_kernel on the CUDA cores (the reference's
// fp32 math; TF32 would not meet the fp32 tolerance): one block per (64
// query rows, b * Hq + h); each K/V tile staged once in shared memory as
// fp32 and read by all rows of the block; a query row owned by D/32
// threads that combine partial dots with shuffles.
// The launch goes on the caller's stream; nothing is allocated or
// synchronised here.  The function returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;   // the TPU kernel's mask value
constexpr float kMinDenom = 1e-30f; // floor on l
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------
template <int D>
struct Flash {
  static constexpr int BQ = 128;                // query rows a CTA
  static constexpr int BKV = D == 64 ? 128 : 64;
  static constexpr int HALVES = D / 64;         // 128-byte atoms a row
  static constexpr int STAGES = 3;
  static constexpr int kThreads = 384;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BKV * D * 2;  // one K or V tile
  static constexpr int kBars = 1 + 3 * STAGES;
  static constexpr int kSmem =
      1024 + Q_BYTES + 2 * STAGES * KV_BYTES + kBars * 8;
  static_assert(D == 64 || D == 128, "head dim");
};

struct FlashArgs {
  __nv_bfloat16* o;
  int hq, hkv, sq, skv, causal, kv_offset, n_qt;
  float scale_log2;
};

template <int D>
__global__ void __launch_bounds__(384, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const FlashArgs p) {
  using C = Flash<D>;
  constexpr int BKV = C::BKV;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + C::BQ * D;                  // [STAGES][BKV * D]
  __nv_bfloat16* vs = ks + C::STAGES * BKV * D;
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + C::STAGES * BKV * D);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + C::STAGES;
  uint64_t* empty = v_full + C::STAGES;

  // heaviest first: block p holds query tile n_qt - 1 - p / (B Hq) when
  // causal (flash_attention.py::block_order)
  const int bh_total = gridDim.x / p.n_qt;
  const int bh = blockIdx.x % bh_total;
  const int slot = blockIdx.x / bh_total;
  const int qi = p.causal ? p.n_qt - 1 - slot : slot;
  const int q0 = qi * C::BQ;
  const int b = bh / p.hq;
  const int kvbh = b * p.hkv + (bh % p.hq) / (p.hq / p.hkv);
  const int n_kv = (p.skv + BKV - 1) / BKV;
  int n_tiles = n_kv;
  if (p.causal) {
    const int last_q = p.kv_offset + min(q0 + C::BQ, p.sq) - 1;
    n_tiles = min(n_kv, last_q / BKV + 1);
  }

  if (threadIdx.x == 0) {
    hopper::bar_init(q_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      hopper::bar_init(k_full + s, 1);
      hopper::bar_init(v_full + s, 1);
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
      hopper::bar_expect(q_full, C::Q_BYTES);
      for (int h = 0; h < C::HALVES; ++h)
        hopper::tma_load_3d(qs + h * C::BQ * 64, &q_map, q_full, 64 * h, q0,
                            bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % C::STAGES;
        hopper::bar_wait(empty + s, ((j / C::STAGES) & 1) ^ 1);
        hopper::bar_expect(k_full + s, C::KV_BYTES);
        for (int h = 0; h < C::HALVES; ++h)
          hopper::tma_load_3d(ks + s * BKV * D + h * BKV * 64, &k_map,
                              k_full + s, 64 * h, j * BKV, kvbh);
        hopper::bar_expect(v_full + s, C::KV_BYTES);
        for (int h = 0; h < C::HALVES; ++h)
          hopper::tma_load_3d(vs + s * BKV * D + h * BKV * 64, &v_map,
                              v_full + s, 64 * h, j * BKV, kvbh);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 ----
  hopper::regs_alloc<232>();
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x / 32) & 3;
  const int row_lo = q0 + 64 * wg + 16 * warp + lane / 4;   // +8: row_hi
  const int col_of = 2 * (lane & 3);    // + 8 jb + (i & 1)
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};               // this thread's part of the sum

  // S = Q K_j^T, issued (not waited for)
  auto issue_qk = [&](int j, float (&sc)[BKV / 2]) {
    const int s = j % C::STAGES;
    const __nv_bfloat16* kt = ks + s * BKV * D;
    hopper::bar_wait(k_full + s, (j / C::STAGES) & 1);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int h = kk / 4;
      const uint64_t da =
          hopper::desc(qs + h * C::BQ * 64 + wg * 64 * 64, 16, 1024) +
          2 * (kk % 4);
      const uint64_t db =
          hopper::desc(kt + h * BKV * 64, 16, 1024) + 2 * (kk % 4);
      hopper::wgmma_ss<BKV, 0>(sc, da, db, kk > 0);
    }
    hopper::wgmma_commit();
  };
  // O += P_j V_j, P from registers, issued (not waited for)
  auto issue_pv = [&](int j, const uint32_t (&pa)[BKV / 16][4]) {
    const int s = j % C::STAGES;
    const __nv_bfloat16* vt = vs + s * BKV * D;
    hopper::bar_wait(v_full + s, (j / C::STAGES) & 1);
    hopper::wgmma_fence();
    hopper::fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint64_t db = hopper::desc(vt, BKV * 128, 1024) + 128 * kk;
      hopper::wgmma_rs<D, 1>(o, pa[kk], db, 1);
    }
    hopper::wgmma_commit();
  };
  // scores of tile j masked where the tile needs it; new row maxima (in
  // the log2 domain: scores times scale log2 e) and sums, alpha = the
  // rescale of O; sc becomes P
  auto softmax = [&](int j, float (&sc)[BKV / 2], float (&alpha)[2]) {
    const int k0 = j * BKV;
    const bool need_mask =
        k0 + BKV > p.skv ||
        (p.causal && k0 + BKV - 1 > p.kv_offset + q0 + 64 * wg);
    float mx[2] = {kNegInf, kNegInf};     // of the unscaled scores
    if (need_mask) {
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        const int col = k0 + 8 * (i / 4) + col_of + (i & 1);
        const int row = row_lo + ((i & 2) ? 8 : 0);
        if (col >= p.skv || (p.causal && p.kv_offset + row < col))
          sc[i] = kNegInf;
      }
    }
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * p.scale_log2);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    // p = 2^(s scale log2 e - m): one FFMA and one exp2 a score
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = exp2f(fmaf(sc[i], p.scale_log2, -m[r]));
      l[r] += sc[i];
    }
  };
  // P to bf16 A fragments: the accumulator's (row, n8 block) pairs are
  // the m64k16 A fragment's, two n8 blocks a k16 step
  auto pack = [&](const float (&sc)[BKV / 2], uint32_t (&pa)[BKV / 16][4]) {
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kk][e] = hopper::pack_bf16x2(sc[8 * kk + 2 * e],
                                        sc[8 * kk + 2 * e + 1]);
  };

  // Software pipeline inside the warpgroup: S_j = Q K_j^T and O += P_j-1
  // V_j-1 are in flight together; the softmax of S_j runs while the
  // tensor cores finish P_j-1 V_j-1.  O is rescaled once that is done.
  float sc[BKV / 2];
  uint32_t pa[BKV / 16][4];
  float alpha[2];
  hopper::bar_wait(q_full, 0);
  issue_qk(0, sc);
  hopper::wgmma_wait<0>();
  hopper::fence_regs(sc);
  softmax(0, sc, alpha);       // O is 0: nothing to rescale
  pack(sc, pa);
  for (int j = 1; j < n_tiles; ++j) {
    issue_qk(j, sc);
    issue_pv(j - 1, pa);
    hopper::wgmma_wait<1>();   // S_j is done
    hopper::fence_regs(sc);
    softmax(j, sc, alpha);
    hopper::wgmma_wait<0>();   // P_j-1 V_j-1 is done: stage j-1 is free
    hopper::fence_regs(o);
    if (lane == 0) hopper::bar_arrive(empty + (j - 1) % C::STAGES);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    pack(sc, pa);
  }
  issue_pv(n_tiles - 1, pa);
  hopper::wgmma_wait<0>();
  hopper::fence_regs(o);
  if (lane == 0) hopper::bar_arrive(empty + (n_tiles - 1) % C::STAGES);

  // out = O / max(l, 1e-30); rows past Sq are not stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / fmaxf(l[r], kMinDenom);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    if (row >= p.sq) continue;
    __nv_bfloat16* op = p.o + ((int64_t)bh * p.sq + row) * D + col_of;
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb)
      *reinterpret_cast<uint32_t*>(op + 8 * jb) = hopper::pack_bf16x2(
          o[4 * jb + 2 * r] * l[r], o[4 * jb + 2 * r + 1] * l[r]);
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int batch, int hq, int hkv, int sq, int skv,
                        int causal, int kv_offset, float scale,
                        cudaStream_t stream) {
  using C = Flash<D>;
  CUtensorMap qm, km, vm;
  const uint64_t qdims[3] = {D, (uint64_t)sq, (uint64_t)batch * hq};
  const uint64_t kdims[3] = {D, (uint64_t)skv, (uint64_t)batch * hkv};
  const uint64_t qstr[2] = {D * 2, (uint64_t)sq * D * 2};
  const uint64_t kstr[2] = {D * 2, (uint64_t)skv * D * 2};
  const uint32_t qbox[3] = {64, C::BQ, 1};
  const uint32_t kbox[3] = {64, C::BKV, 1};
  cudaError_t e;
  if ((e = hopper::make_map(&qm, q, 3, qdims, qstr, qbox)) != cudaSuccess ||
      (e = hopper::make_map(&km, k, 3, kdims, kstr, kbox)) != cudaSuccess ||
      (e = hopper::make_map(&vm, v, 3, kdims, kstr, kbox)) != cudaSuccess)
    return e;
  auto kern = flash_wgmma_kernel<D>;
  if ((e = cudaFuncSetAttribute(kern,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                C::kSmem)) != cudaSuccess)
    return e;
  FlashArgs args{static_cast<__nv_bfloat16*>(o), hq, hkv, sq, skv, causal,
                 kv_offset, (sq + C::BQ - 1) / C::BQ, scale * kLog2e};
  const int64_t blocks = (int64_t)args.n_qt * batch * hq;
  if (blocks >= (1ll << 31)) return cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, C::kThreads, C::kSmem, stream>>>(qm, km, vm,
                                                              args);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------
constexpr int kBlockQ = 64;         // query rows per block

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 axpy4(float p, float4 x, float4 y) {
  return make_float4(fmaf(p, x.x, y.x), fmaf(p, x.y, y.y),
                     fmaf(p, x.z, y.z), fmaf(p, x.w, y.w));
}

__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

// Thread part t of a row owns the float4 chunks t, t + TPR, t + 2*TPR, ...
// of the head dim: at any moment the TPR threads of a row read TPR
// neighbouring chunks of a shared K/V row.
template <int D>
__global__ void __launch_bounds__(kBlockQ * (D / 32))
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 int hq, int hkv, int sq, int skv, int causal, int kv_offset,
                 float scale) {
  constexpr int TPR = D / 32;               // threads per query row
  constexpr int CHUNKS = 32 / 4;            // float4 chunks per thread
  constexpr int ROW4 = D / 4;               // float4 chunks per row
  constexpr int BKV = (D == 64) ? 64 : 32;  // kv rows per tile (32 KB smem)
  constexpr int NT = kBlockQ * TPR;
  __shared__ float4 ks[BKV * ROW4];
  __shared__ float4 vs[BKV * ROW4];

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;
  const int qi = blockIdx.x;
  const int bh = blockIdx.y;                // b * hq + h
  const int b = bh / hq;
  const int h = bh % hq;
  const int kvh = h / (hq / hkv);
  const int q_row = qi * kBlockQ + row;
  const bool row_valid = q_row < sq;
  const int q_pos = kv_offset + q_row;

  const float* qp = q + ((int64_t)bh * sq + (row_valid ? q_row : 0)) * D;
  const float* kp = k + (int64_t)(b * hkv + kvh) * skv * D;
  const float* vp = v + (int64_t)(b * hkv + kvh) * skv * D;

  float4 qr[CHUNKS];
  float4 acc[CHUNKS];
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    qr[i] = load4(qp + 4 * (part + TPR * i));
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNegInf;
  float l = 0.f;

  const int n_kv = (skv + BKV - 1) / BKV;
  int last_j = n_kv - 1;
  if (causal) {
    last_j = min(last_j, (kv_offset + (qi + 1) * kBlockQ - 1) / BKV);
  }

  for (int j = 0; j <= last_j; ++j) {
    const int k0 = j * BKV;
    __syncthreads();  // every row is done with the previous tile
    for (int e = tid; e < BKV * ROW4; e += NT) {
      const int r = e / ROW4;
      const int c = e % ROW4;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kk;
      if (k0 + r < skv) {
        kk = load4(kp + (int64_t)(k0 + r) * D + 4 * c);
        vv = load4(vp + (int64_t)(k0 + r) * D + 4 * c);
      }
      ks[e] = kk;
      vs[e] = vv;
    }
    __syncthreads();

    float s[BKV];
    float m_cur = kNegInf;
#pragma unroll
    for (int jj = 0; jj < BKV; ++jj) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < CHUNKS; ++i) {
        dot = dot4(qr[i], ks[jj * ROW4 + part + TPR * i], dot);
      }
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1) {
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      }
      const int k_pos = k0 + jj;
      const bool ok = k_pos < skv && (!causal || q_pos >= k_pos);
      s[jj] = ok ? dot * scale : kNegInf;
      m_cur = fmaxf(m_cur, s[jj]);
    }

    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) acc[i] = scale4(acc[i], alpha);
    float l_add = 0.f;
#pragma unroll
    for (int jj = 0; jj < BKV; ++jj) {
      const float p = expf(s[jj] - m_new);
      l_add += p;
#pragma unroll
      for (int i = 0; i < CHUNKS; ++i) {
        acc[i] = axpy4(p, vs[jj * ROW4 + part + TPR * i], acc[i]);
      }
    }
    l = l * alpha + l_add;
    m = m_new;
  }

  if (row_valid) {
    const float denom = fmaxf(l, kMinDenom);
    float* op = o + ((int64_t)bh * sq + q_row) * D;
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const float4 a = acc[i];
      store4(op + 4 * (part + TPR * i),
             make_float4(a.x / denom, a.y / denom, a.z / denom, a.w / denom));
    }
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int batch, int hq, int hkv, int sq, int skv,
                       int causal, int kv_offset, float scale,
                       cudaStream_t stream) {
  if ((int64_t)batch * hq > 65535) return cudaErrorInvalidValue;
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, batch * hq);
  const dim3 block(kBlockQ * (D / 32));
  flash_f32_kernel<D><<<grid, block, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), hq, hkv, sq, skv,
      causal, kv_offset, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  head_dim: 64 or 128.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int batch, int hq,
                                   int hkv, int sq, int skv, int head_dim,
                                   int dtype, int causal, int kv_offset,
                                   float scale, void* stream) {
  if (batch <= 0 || hq <= 0 || hkv <= 0 || sq <= 0 || skv <= 0 ||
      hq % hkv != 0 || kv_offset < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0 && head_dim == 64)
    e = launch_f32<64>(q, k, v, o, batch, hq, hkv, sq, skv, causal,
                       kv_offset, scale, s);
  else if (dtype == 0 && head_dim == 128)
    e = launch_f32<128>(q, k, v, o, batch, hq, hkv, sq, skv, causal,
                        kv_offset, scale, s);
  else if (dtype == 1 && head_dim == 64)
    e = launch_bf16<64>(q, k, v, o, batch, hq, hkv, sq, skv, causal,
                        kv_offset, scale, s);
  else if (dtype == 1 && head_dim == 128)
    e = launch_bf16<128>(q, k, v, o, batch, hq, hkv, sq, skv, causal,
                         kv_offset, scale, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

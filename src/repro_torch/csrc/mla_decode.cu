// Absorbed-MLA decode attention for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces: src/repro/kernels/mla_decode.py::_mla_kernel (wrapper
// mla_decode_attention, the Pallas TPU kernel that DeepSeek-V3's decode
// reaches through models/attention.py::mla_decode and mla_decode_paged when
// ctx.use_kernels is set).
//
// Computes exactly what the TPU kernel computes, for q_eff [B, H, R] fp32,
// q_rope [B, H, Dr] fp32, the latent cache c [B, S, R] bf16, the rope-key
// cache kr [B, S, Dr] bf16 and valid_len [B] int32 (all row-major,
// contiguous), out [B, H, R] fp32:
//   score_s = (q_eff . c_s + q_rope . kr_s) * scale in fp32, set to -1e30
//   where s >= valid_len[b]; online softmax with running m, l, acc in fp32;
//   out = acc / max(l, 1e-30).
// Rows past the last valid one are never read: they would add exp(-1e30 -
// m) = 0.  A row with valid_len <= 0 has every score at -1e30, so it reads
// all S rows and gets their mean, as the TPU kernel does.
//
// What bounds it on the card: 2*B*H*S*(2R + Dr) operations against the
// caches' bytes.  At the lane's shape (B=4, H=128, R=512, Dr=64, S=1041)
// the 128 heads share every latent row, about 250 operations per byte: the
// work sits near the H100's ridge point, bound by operations on the tensor
// cores.  This first kernel computes on the fp32 CUDA cores (67 TFLOP/s)
// and re-reads each shared-memory tile once per head, so it is bound by
// shared-memory reads and operations well above that bound; tensor-core
// tiles, a split over S with a combine pass, and clusters sharing c tiles
// are later work.
//
// Design (the TPU kernel keeps the whole [H, R] fp32 accumulator, 256 KB,
// in VMEM; that is all of one SM's registers, so heads are split over
// blocks):
//   * one block per (group of kHeadsPerBlock heads, batch row); one warp
//     per head; lane i owns the 8-element chunks i, i + 32, ... of R for
//     q_eff and the fp32 accumulator, in registers, and the rope dims i,
//     i + 32, ... of Dr;
//   * the TPU's sequential S grid axis is a loop inside the block: tiles of
//     kTile cache rows are staged once in shared memory as bf16 (36.9 KB at
//     R=512, Dr=64) and read by every warp of the block;
//   * a score is a per-lane partial dot product summed with warp shuffles;
//     a tile has one row per lane (kTile = 32), so lane j keeps row j's
//     score, the tile's max and sum are warp reductions, and the
//     accumulation fetches each row's weight with one shuffle.  No per-row
//     array lives in registers: a first version kept the tile's 32 scores
//     there, used 255 registers and spilled 2.8 KB;
//   * each head group reads the latent rows again (from L2 at short S);
//   * any S: the ragged last tile is zero-filled and its missing rows get
//     a score of -inf, so they add nothing even when every real score is
//     -1e30.
// The launch goes on the caller's stream; nothing is allocated or
// synchronised here.  The function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // the TPU kernel's mask value
constexpr float kMinDenom = 1e-30f; // floor on l
constexpr int kHeadsPerBlock = 8;   // one warp per head
constexpr int kTile = 32;           // cache rows per shared-memory tile
constexpr int kThreads = kHeadsPerBlock * 32;

// eight bf16 -> fp32 is exact: the bf16 bits are the high half of a float
__device__ __forceinline__ void unpack8(uint4 raw, float* f) {
  f[0] = __uint_as_float(raw.x << 16);
  f[1] = __uint_as_float(raw.x & 0xffff0000u);
  f[2] = __uint_as_float(raw.y << 16);
  f[3] = __uint_as_float(raw.y & 0xffff0000u);
  f[4] = __uint_as_float(raw.z << 16);
  f[5] = __uint_as_float(raw.z & 0xffff0000u);
  f[6] = __uint_as_float(raw.w << 16);
  f[7] = __uint_as_float(raw.w & 0xffff0000u);
}

template <int R, int DR>
__global__ void __launch_bounds__(kThreads)
mla_decode_kernel(const float* __restrict__ q_eff,
                  const float* __restrict__ q_rope,
                  const __nv_bfloat16* __restrict__ c,
                  const __nv_bfloat16* __restrict__ kr,
                  const int* __restrict__ valid_len, float* __restrict__ out,
                  int heads, int s, float scale) {
  constexpr int RV = R / 8;     // 8-element chunks in a latent row
  constexpr int RC = RV / 32;   // chunks a lane owns
  constexpr int DRV = DR / 8;   // 8-element chunks in a rope row
  constexpr int DRL = DR / 32;  // rope dims a lane owns
  __shared__ uint4 cs[kTile * RV];
  __shared__ uint4 krs4[kTile * DRV];
  const __nv_bfloat16* krs = reinterpret_cast<const __nv_bfloat16*>(krs4);

  const int lane = threadIdx.x & 31;
  const int head = blockIdx.x * kHeadsPerBlock + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  const bool head_ok = head < heads;
  const int vl = valid_len[b];
  const int rows = (vl <= 0 || vl > s) ? s : vl;   // cache rows to read

  float qe[RC * 8];
  float qr[DRL];
  float acc[RC * 8];
  {
    const int64_t bh = (int64_t)b * heads + (head_ok ? head : 0);
    const float* qp = q_eff + bh * R;
#pragma unroll
    for (int i = 0; i < RC; ++i) {
      const float4 lo = *reinterpret_cast<const float4*>(qp + 8 * (lane + 32 * i));
      const float4 hi = *reinterpret_cast<const float4*>(qp + 8 * (lane + 32 * i) + 4);
      qe[8 * i + 0] = lo.x; qe[8 * i + 1] = lo.y;
      qe[8 * i + 2] = lo.z; qe[8 * i + 3] = lo.w;
      qe[8 * i + 4] = hi.x; qe[8 * i + 5] = hi.y;
      qe[8 * i + 6] = hi.z; qe[8 * i + 7] = hi.w;
    }
#pragma unroll
    for (int i = 0; i < DRL; ++i) qr[i] = q_rope[bh * DR + lane + 32 * i];
  }
#pragma unroll
  for (int i = 0; i < RC * 8; ++i) acc[i] = 0.f;
  float m = kNegInf;
  float l = 0.f;

  const uint4* cb = reinterpret_cast<const uint4*>(c + (int64_t)b * s * R);
  const uint4* kb = reinterpret_cast<const uint4*>(kr + (int64_t)b * s * DR);

  for (int t0 = 0; t0 < rows; t0 += kTile) {
    __syncthreads();  // every warp is done with the previous tile
    for (int e = threadIdx.x; e < kTile * RV; e += kThreads) {
      const int r = e / RV;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (t0 + r < rows) v = cb[(int64_t)(t0 + r) * RV + e % RV];
      cs[e] = v;
    }
    for (int e = threadIdx.x; e < kTile * DRV; e += kThreads) {
      const int r = e / DRV;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (t0 + r < rows) v = kb[(int64_t)(t0 + r) * DRV + e % DRV];
      krs4[e] = v;
    }
    __syncthreads();
    if (!head_ok) continue;   // the loop bound is the same for every warp

    // scores: every lane sums its partial dot of row j with the others';
    // lane j keeps row j's score (kTile == 32, one row a lane)
    float score = 0.f;
#pragma unroll 2
    for (int j = 0; j < kTile; ++j) {
      float d0 = 0.f, d1 = 0.f;   // two chains, for instruction overlap
#pragma unroll
      for (int i = 0; i < RC; ++i) {
        float f[8];
        unpack8(cs[j * RV + lane + 32 * i], f);
#pragma unroll
        for (int k = 0; k < 8; k += 2) {
          d0 = fmaf(qe[8 * i + k], f[k], d0);
          d1 = fmaf(qe[8 * i + k + 1], f[k + 1], d1);
        }
      }
#pragma unroll
      for (int i = 0; i < DRL; ++i) {
        d0 = fmaf(qr[i], __bfloat162float(krs[j * DR + lane + 32 * i]), d0);
      }
      float dot = d0 + d1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      }
      if (lane == j) score = dot;
    }
    const int row = t0 + lane;
    score = row >= rows ? -INFINITY : (row < vl ? score * scale : kNegInf);

    // online softmax over the tile; row t0 < rows, so m_cur is finite
    float m_cur = score;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, off));
    }
    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
    const float p_mine = expf(score - m_new);
    float l_add = p_mine;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      l_add += __shfl_xor_sync(0xffffffffu, l_add, off);
    }
#pragma unroll
    for (int i = 0; i < RC * 8; ++i) acc[i] *= alpha;
#pragma unroll 2
    for (int j = 0; j < kTile; ++j) {
      const float p = __shfl_sync(0xffffffffu, p_mine, j);
#pragma unroll
      for (int i = 0; i < RC; ++i) {
        float f[8];
        unpack8(cs[j * RV + lane + 32 * i], f);
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[8 * i + k] = fmaf(p, f[k], acc[8 * i + k]);
      }
    }
    l = l * alpha + l_add;
    m = m_new;
  }

  if (head_ok) {
    const float inv = 1.f / fmaxf(l, kMinDenom);
    float* op = out + ((int64_t)b * heads + head) * R;
#pragma unroll
    for (int i = 0; i < RC; ++i) {
      float* p = op + 8 * (lane + 32 * i);
      *reinterpret_cast<float4*>(p) =
          make_float4(acc[8 * i + 0] * inv, acc[8 * i + 1] * inv,
                      acc[8 * i + 2] * inv, acc[8 * i + 3] * inv);
      *reinterpret_cast<float4*>(p + 4) =
          make_float4(acc[8 * i + 4] * inv, acc[8 * i + 5] * inv,
                      acc[8 * i + 6] * inv, acc[8 * i + 7] * inv);
    }
  }
}

template <int R, int DR>
void launch(const void* q_eff, const void* q_rope, const void* c,
            const void* kr, const void* valid_len, void* out, int batch,
            int heads, int s, float scale, cudaStream_t stream) {
  const dim3 grid((heads + kHeadsPerBlock - 1) / kHeadsPerBlock, batch);
  mla_decode_kernel<R, DR><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q_eff), static_cast<const float*>(q_rope),
      static_cast<const __nv_bfloat16*>(c),
      static_cast<const __nv_bfloat16*>(kr),
      static_cast<const int*>(valid_len), static_cast<float*>(out), heads, s,
      scale);
}

}  // namespace

// DeepSeek-V3's widths: latent 512, rope 64.
extern "C" int mla_decode_fwd(const void* q_eff, const void* q_rope,
                              const void* c, const void* kr,
                              const void* valid_len, void* out, int batch,
                              int heads, int s, int latent, int rope,
                              float scale, void* stream) {
  if (batch <= 0 || batch > 65535 || heads <= 0 || s <= 0 || latent != 512 ||
      rope != 64) {
    return (int)cudaErrorInvalidValue;
  }
  launch<512, 64>(q_eff, q_rope, c, kr, valid_len, out, batch, heads, s,
                  scale, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

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
//   tiles above last_j = min(n_kv - 1, (kv_offset + (qi+1)*Bq - 1) / Bkv)
//   are skipped.
//
// What bounds it on the card: at the slice's shape (minicpm_2b prefill,
// B=4, H=36, S=1024, D=64, bf16, causal) the work is ~19 GFLOP against
// ~75 MB of q/k/v/out, about 256 FLOP per byte -- close to the H100's bf16
// ridge (~295), so a tensor-core kernel would sit near both limits.  This
// first kernel computes on the fp32 CUDA cores (67 TFLOP/s), so it is bound
// by operations, several times above the tensor-core bound; mma/wgmma tiles
// are later work.
//
// Design (not the TPU grid carried over block by block):
//   * one block per (query tile of kBlockQ rows, b * Hq + h); the TPU's
//     sequential kv grid axis becomes a loop inside the block;
//   * each K/V tile is staged once in shared memory as fp32 and read by all
//     kBlockQ rows of the block (broadcast reads, no bank conflicts);
//   * a query row is owned by TPR = D/32 adjacent threads, each holding 32
//     of its dims of q and of the fp32 accumulator in registers; partial
//     dot products combine with warp shuffles; m and l live in registers;
//   * the ragged edges (Sq, Skv not multiples of the tile) are masked here,
//     so prompt lengths are arbitrary (the TPU kernel needs Sq % bq == 0).
// The launch goes on the caller's stream; nothing is allocated or
// synchronised here.  The function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // the TPU kernel's mask value
constexpr float kMinDenom = 1e-30f; // floor on l
constexpr int kBlockQ = 64;         // query rows per block

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  // four bf16 -> fp32 is exact: the bf16 bits are the high half of a float
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(raw.x << 16),
                     __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16),
                     __uint_as_float(raw.y & 0xffff0000u));
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return a | (b << 16);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
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
template <typename T, int D>
__global__ void __launch_bounds__(kBlockQ * (D / 32))
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int hq, int hkv,
                 int sq, int skv, int causal, int kv_offset, float scale) {
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

  const T* qp = q + ((int64_t)bh * sq + (row_valid ? q_row : 0)) * D;
  const T* kp = k + (int64_t)(b * hkv + kvh) * skv * D;
  const T* vp = v + (int64_t)(b * hkv + kvh) * skv * D;

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
    T* op = o + ((int64_t)bh * sq + q_row) * D;
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const float4 a = acc[i];
      store4(op + 4 * (part + TPR * i),
             make_float4(a.x / denom, a.y / denom, a.z / denom, a.w / denom));
    }
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o, int batch,
            int hq, int hkv, int sq, int skv, int causal, int kv_offset,
            float scale, cudaStream_t stream) {
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, batch * hq);
  const dim3 block(kBlockQ * (D / 32));
  flash_fwd_kernel<T, D><<<grid, block, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, sq, skv, causal,
      kv_offset, scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  head_dim: 64 or 128.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int batch, int hq,
                                   int hkv, int sq, int skv, int head_dim,
                                   int dtype, int causal, int kv_offset,
                                   float scale, void* stream) {
  if (batch <= 0 || hq <= 0 || hkv <= 0 || sq <= 0 || skv <= 0 ||
      hq % hkv != 0 || kv_offset < 0 || (int64_t)batch * hq > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) {
    launch<float, 64>(q, k, v, o, batch, hq, hkv, sq, skv, causal, kv_offset,
                      scale, s);
  } else if (dtype == 0 && head_dim == 128) {
    launch<float, 128>(q, k, v, o, batch, hq, hkv, sq, skv, causal, kv_offset,
                       scale, s);
  } else if (dtype == 1 && head_dim == 64) {
    launch<__nv_bfloat16, 64>(q, k, v, o, batch, hq, hkv, sq, skv, causal,
                              kv_offset, scale, s);
  } else if (dtype == 1 && head_dim == 128) {
    launch<__nv_bfloat16, 128>(q, k, v, o, batch, hq, hkv, sq, skv, causal,
                               kv_offset, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

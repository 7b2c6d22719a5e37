"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Port of ``repro.kernels.flash_attention`` (the Pallas TPU kernel
``_flash_kernel``).  ``flash_attention`` launches the hand-written Hopper
kernel ``csrc/flash_attention.cu`` (built at first use by
``kernels.build``) for CUDA tensors, and runs the plain PyTorch version
``flash_attention_ref`` for CPU tensors.  There is no fallback: a CUDA
tensor the kernel does not take, or a build or launch failure, raises.

The bf16 kernel runs on wgmma and TMA; fp32 inputs take a kernel on the
CUDA cores (the reference's fp32 math).  ``block_order`` and ``kv_tiles``
give the bf16 kernel's CTA numbering and work per query tile.

``flash_attention.launches`` counts kernel launches (never the plain path),
so a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import build

NEG_INF = -1e30          # the TPU kernel's mask value (not -inf)
MIN_DENOM = 1e-30        # floor on the softmax denominator
HEAD_DIMS = (64, 128)    # the kernel's templated head dims
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ALIGN = 16              # TMA bases / float4 loads
BLOCK_Q = 128            # bf16 kernel: query rows a CTA (two warpgroups)


def block_kv(d: int) -> int:
    """The bf16 kernel's K/V tile rows at head dim ``d``."""
    return 128 if d == 64 else 64


def kv_tiles(qi: int, sq: int, skv: int, d: int, causal: bool,
             kv_offset: int) -> int:
    """K/V tiles the bf16 kernel's query tile ``qi`` reads: all of them,
    or under the causal mask those up to its last valid query row's
    position."""
    bkv = block_kv(d)
    n_kv = -(-skv // bkv)
    if not causal:
        return n_kv
    last_q = kv_offset + min((qi + 1) * BLOCK_Q, sq) - 1
    return min(n_kv, last_q // bkv + 1)


def block_order(sq: int, bh: int, causal: bool) -> List[Tuple[int, int]]:
    """(query tile, b * Hq + h) of each CTA of the bf16 kernel in launch
    order (csrc/flash_attention.cu): the query tile changes slowest, last
    tile first when causal, so the heaviest tiles start first."""
    n_qt = -(-sq // BLOCK_Q)
    return [((n_qt - 1 - p // bh) if causal else p // bh, p % bh)
            for p in range(n_qt * bh)]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, scale: Optional[float] = None,
                        kv_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel: q [B, Hq, Sq, D], k
    [B, Hkv, Skv, D], v [B, Hkv, Skv, Dv] -> [B, Hq, Sq, Dv] in q's dtype
    (Dv may differ from D, as in MLA's prefill; the kernel takes Dv == D).
    Scores in fp32, causal mask ``kv_offset + i >= k_pos`` with -1e30,
    softmax denominator floored at 1e-30 (``kernels/ref.py`` plus the TPU
    kernel's offset and mask semantics).  GQA reads kv head h // (Hq /
    Hkv)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = q.float().reshape(b, hkv, group, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    if causal:
        qpos = kv_offset + torch.arange(sq, device=q.device)
        kpos = torch.arange(skv, device=q.device)
        s = s.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    o = o / torch.clamp(l, min=MIN_DENOM)
    return o.reshape(b, hq, sq, v.shape[-1]).to(q.dtype)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes [B, H, S, D] tensors, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if hq % k.shape[1]:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={k.shape[1]}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: need one of "
                         "float32, bfloat16 for all three")


def _check_cuda(q, k, v, kv_offset):
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[-1]} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % _ALIGN:
            raise ValueError(f"{name} is not {_ALIGN}-byte aligned")
    if kv_offset < 0:
        raise ValueError(f"kv_offset={kv_offset} must be >= 0")
    if q.dtype == torch.float32 and q.shape[0] * q.shape[1] > 65535:
        raise ValueError("B * Hq must be <= 65535 (the fp32 kernel's "
                         "grid.y)")
    if min(q.shape[2], k.shape[2]) == 0:
        raise ValueError("empty sequence")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    kv_offset: int = 0) -> torch.Tensor:
    """q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D] with Hq % Hkv == 0.
    ``kv_offset``: absolute position of q[0] on the kv timeline (q is a
    suffix of a longer kv in chunked prefill).  CUDA tensors launch the
    kernel (float32 or bfloat16, D in 64/128, contiguous); CPU tensors run
    ``flash_attention_ref``."""
    _check(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                   kv_offset=kv_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_cuda(q, k, v, kv_offset)
    build.refuse_grad("flash_attention", "5", q, k, v)
    out = torch.empty_like(q)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    err = _library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv,
        sq, skv, d, _DTYPE_CODES[q.dtype], int(causal), int(kv_offset),
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    build.count_launch(flash_attention)
    return out


flash_attention.launches = 0


def _library() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib

"""Absorbed-MLA decode attention: the CUDA kernel's wrapper and its plain
version.

Port of ``repro.kernels.mla_decode`` (the Pallas TPU kernel
``_mla_kernel``).  ``mla_decode_attention`` launches the hand-written
Hopper kernel ``csrc/mla_decode.cu`` (built at first use by
``kernels.build``) for CUDA tensors, and runs the plain PyTorch version
``mla_decode_attention_ref`` for CPU tensors.  There is no fallback: a CUDA
tensor the kernel does not take, or a build or launch failure, raises.

    scores_s = (q_eff . c_s + q_rope . kr_s) * scale, -1e30 where
               s >= valid_len[b]
    ctx      = softmax(scores) . C                     [B, H, R] fp32

``mla_decode_attention.launches`` counts kernel launches (never the plain
path), so a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30          # the TPU kernel's mask value (not -inf)
LATENT_DIMS = (512,)      # the kernel's R (kv_lora_rank)
ROPE_DIMS = (64,)         # the kernel's Dr (qk_rope_head_dim)
_ALIGN = 16               # 16-byte vector loads


def _valid_rows(valid_len, batch: int, device: torch.device) -> torch.Tensor:
    """Per-row valid lengths [B] (a scalar broadcasts to every row)."""
    return torch.as_tensor(valid_len, device=device).reshape(-1).expand(batch)


def mla_decode_attention_ref(q_eff: torch.Tensor, q_rope: torch.Tensor,
                             c_cache: torch.Tensor, kr_cache: torch.Tensor,
                             valid_len, scale: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel (``kernels/ref.py``'s
    ``mla_decode_attention_ref``): q_eff [B, H, R], q_rope [B, H, Dr],
    c_cache [B, S, R], kr_cache [B, S, Dr], valid_len [B] (or a scalar) ->
    [B, H, R] fp32."""
    s = (torch.einsum("bhr,bsr->bhs", q_eff.float(), c_cache.float())
         + torch.einsum("bhd,bsd->bhs", q_rope.float(), kr_cache.float())
         ) * scale
    pos = torch.arange(c_cache.shape[1], device=c_cache.device)
    vl = _valid_rows(valid_len, c_cache.shape[0], c_cache.device)
    s = s.masked_fill(pos[None, None, :] >= vl[:, None, None], NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bsr->bhr", w, c_cache.float())


def _check(q_eff, q_rope, c_cache, kr_cache):
    if q_eff.dim() != 3 or q_rope.dim() != 3 or c_cache.dim() != 3 \
            or kr_cache.dim() != 3:
        raise ValueError("mla_decode_attention takes q_eff [B, H, R], q_rope "
                         "[B, H, Dr], c [B, S, R], kr [B, S, Dr]; got "
                         f"{tuple(q_eff.shape)}, {tuple(q_rope.shape)}, "
                         f"{tuple(c_cache.shape)}, {tuple(kr_cache.shape)}")
    b, h, r = q_eff.shape
    dr = q_rope.shape[-1]
    s = c_cache.shape[1]
    if (tuple(q_rope.shape) != (b, h, dr) or tuple(c_cache.shape) != (b, s, r)
            or tuple(kr_cache.shape) != (b, s, dr)):
        raise ValueError(f"shapes {tuple(q_eff.shape)}, {tuple(q_rope.shape)}"
                         f", {tuple(c_cache.shape)}, {tuple(kr_cache.shape)} "
                         "do not agree")


def _check_cuda(q_eff, q_rope, c_cache, kr_cache):
    tensors = (("q_eff", q_eff), ("q_rope", q_rope), ("c_cache", c_cache),
               ("kr_cache", kr_cache))
    for name, t in tensors:
        if t.device != q_eff.device:
            raise ValueError(f"{name} on {t.device}, q_eff on {q_eff.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % _ALIGN:
            raise ValueError(f"{name} is not {_ALIGN}-byte aligned")
    if q_eff.dtype != torch.float32 or q_rope.dtype != torch.float32:
        raise ValueError(f"q_eff/q_rope dtypes {q_eff.dtype}/{q_rope.dtype}: "
                         "the kernel takes float32")
    if c_cache.dtype != torch.bfloat16 or kr_cache.dtype != torch.bfloat16:
        raise ValueError(f"cache dtypes {c_cache.dtype}/{kr_cache.dtype}: "
                         "the kernel takes bfloat16")
    if q_eff.shape[-1] not in LATENT_DIMS:
        raise ValueError(f"latent dim {q_eff.shape[-1]} not in {LATENT_DIMS}")
    if q_rope.shape[-1] not in ROPE_DIMS:
        raise ValueError(f"rope dim {q_rope.shape[-1]} not in {ROPE_DIMS}")
    if not 0 < q_eff.shape[0] <= 65535:
        raise ValueError("batch must be in [1, 65535] (grid.y)")
    if c_cache.shape[1] == 0:
        raise ValueError("empty cache")


def mla_decode_attention(q_eff: torch.Tensor, q_rope: torch.Tensor,
                         c_cache: torch.Tensor, kr_cache: torch.Tensor,
                         valid_len, *, scale: float) -> torch.Tensor:
    """q_eff: [B, H, R]; q_rope: [B, H, Dr]; c_cache: [B, S, R]; kr_cache:
    [B, S, Dr]; valid_len: [B] per-row valid lengths (row b attends to
    positions < valid_len[b]; a scalar broadcasts).  Returns the context
    over the latent, [B, H, R] fp32.  CUDA tensors launch the kernel
    (float32 queries, bfloat16 caches, contiguous, R 512, Dr 64 as in
    DeepSeek-V3, any S); CPU tensors run ``mla_decode_attention_ref``."""
    _check(q_eff, q_rope, c_cache, kr_cache)
    devs = {t.device.type for t in (q_eff, q_rope, c_cache, kr_cache)}
    if devs == {"cpu"}:
        return mla_decode_attention_ref(q_eff, q_rope, c_cache, kr_cache,
                                        valid_len, scale)
    if q_eff.device.type != "cuda":
        raise ValueError(f"mla_decode_attention: unsupported device "
                         f"{q_eff.device}")
    _check_cuda(q_eff, q_rope, c_cache, kr_cache)
    b, h, r = q_eff.shape
    s, dr = c_cache.shape[1], q_rope.shape[-1]
    vl = _valid_rows(valid_len, b, q_eff.device).to(torch.int32).contiguous()
    out = torch.empty((b, h, r), dtype=torch.float32, device=q_eff.device)
    err = _library().mla_decode_fwd(
        q_eff.data_ptr(), q_rope.data_ptr(), c_cache.data_ptr(),
        kr_cache.data_ptr(), vl.data_ptr(), out.data_ptr(), b, h, s, r, dr,
        float(scale), torch.cuda.current_stream(q_eff.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mla_decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    build.count_launch(mla_decode_attention)
    return out


mla_decode_attention.launches = 0


def _library() -> ctypes.CDLL:
    lib = build.load("mla_decode")
    fn = lib.mla_decode_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib

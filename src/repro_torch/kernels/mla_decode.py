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

The kernel splits each batch row's cache rows into ``split_plan``'s ranges
(flash-decoding): one CTA a (range, 64 heads, row) writes a partial, and a
second launch merges them (``split_ref`` and ``combine_ref`` are the plain
versions of the two passes).

``mla_decode_attention.launches`` counts kernel launches and
``mla_decode_attention.combine_launches`` the combine's (never the plain
path), so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.kernels import build

NEG_INF = -1e30          # the TPU kernel's mask value (not -inf)
LATENT_DIMS = (512,)      # the kernel's R (kv_lora_rank)
ROPE_DIMS = (64,)         # the kernel's Dr (qk_rope_head_dim)
_ALIGN = 16               # 16-byte vector loads and TMA
LOG2E = 1.0 / math.log(2.0)
ROW_TILE = 32             # csrc/mla_decode.cu kRows: cache rows a stage
HEAD_TILE = 64            # kHeads: heads a CTA (wgmma's M)
MIN_SPLIT_TILES = 2       # row tiles a split takes at least


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


def split_plan(batch: int, heads: int, s: int, sms: int) -> Tuple[int, int]:
    """(n_splits, split_rows): the kernel's grid over each batch row's S
    cache rows, ranges [i * split_rows, (i + 1) * split_rows) for i <
    n_splits, split_rows a multiple of ROW_TILE and no range empty of
    cache rows.  From B, H, S and the card's ``sms`` only, never from the
    valid lengths, whose values live on the card (reading them would
    stall the host every layer): splits fill one wave of CTAs, one an SM
    (230 KB of shared memory each), but each takes at least
    MIN_SPLIT_TILES row tiles, since a split costs a q load and a partial
    [H, R] fp32 written and read again by the combine."""
    tiles = -(-s // ROW_TILE)
    ctas = batch * -(-heads // HEAD_TILE)
    n = max(1, min(sms // ctas, tiles // MIN_SPLIT_TILES))
    per = -(-tiles // n)            # row tiles a split
    return -(-tiles // per), per * ROW_TILE


def split_ref(q_eff: torch.Tensor, q_rope: torch.Tensor,
              c_cache: torch.Tensor, kr_cache: torch.Tensor, valid_len,
              scale: float, n_splits: int, split_rows: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel's split pass: per (batch row, split,
    head) the unnormalised context ``part_o`` [B, n_splits, H, R] and
    ``part_ml`` [B, n_splits, H, 2] = (m, l) over the split's cache rows
    before the row's read length (all S where valid_len <= 0 or > S), with
    m the max score in log2 units (scores times scale log2 e, -1e30 where
    valid_len <= 0) and l the sum of 2^(score - m).  A split with no such
    rows is empty: m = -inf, l = 0, ``part_o`` zero (the kernel leaves it
    unwritten)."""
    b, h, r = q_eff.shape
    s = c_cache.shape[1]
    vl = _valid_rows(valid_len, b, c_cache.device).long()
    rows = torch.where((vl <= 0) | (vl > s), s, vl)
    sc = (torch.einsum("bhr,bsr->bhs", q_eff.float(), c_cache.float())
          + torch.einsum("bhd,bsd->bhs", q_rope.float(), kr_cache.float())
          ) * (scale * LOG2E)
    sc = sc.masked_fill((vl <= 0)[:, None, None], NEG_INF)
    pos = torch.arange(n_splits * split_rows, device=c_cache.device)
    pad = n_splits * split_rows - s
    sc = torch.nn.functional.pad(sc, (0, pad))
    sc = sc.masked_fill(pos >= rows[:, None, None], -math.inf)
    sc = sc.reshape(b, h, n_splits, split_rows)
    m = sc.amax(-1)                                        # [B, H, n]
    empty = m == -math.inf
    p = torch.exp2(sc - torch.where(empty, 0.0, m)[..., None])
    cp = torch.nn.functional.pad(c_cache.float(), (0, 0, 0, pad))
    part_o = torch.einsum("bhns,bnsr->bnhr", p,
                          cp.reshape(b, n_splits, split_rows, r))
    part_ml = torch.stack([m, p.sum(-1)], -1).transpose(1, 2)
    return part_o, part_ml.contiguous()


def combine_ref(part_o: torch.Tensor, part_ml: torch.Tensor) -> torch.Tensor:
    """Plain version of the combine: out = sum_i w_i O_i / max(sum_i w_i
    l_i, 1e-30) with w_i = 2^(m_i - max_i m_i) over the splits that are not
    empty (m_i = -inf) -> [B, H, R]."""
    m, l = part_ml[..., 0], part_ml[..., 1]                # [B, n, H]
    empty = m == -math.inf
    w = torch.where(empty, 0.0, torch.exp2(m - m.amax(1, keepdim=True)))
    o = part_o.masked_fill(empty[..., None], 0.0)
    return ((w[..., None] * o).sum(1)
            / (w * l).sum(1).clamp_min(1e-30)[..., None])


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
        raise ValueError("batch must be in [1, 65535] (grid.z)")
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
    DeepSeek-V3, any S and H) and, with more than one split, the combine;
    they raise under grad mode when an input requires grad (the kernel has
    no backward).  CPU tensors run ``mla_decode_attention_ref``."""
    _check(q_eff, q_rope, c_cache, kr_cache)
    devs = {t.device.type for t in (q_eff, q_rope, c_cache, kr_cache)}
    if devs == {"cpu"}:
        return mla_decode_attention_ref(q_eff, q_rope, c_cache, kr_cache,
                                        valid_len, scale)
    if q_eff.device.type != "cuda":
        raise ValueError(f"mla_decode_attention: unsupported device "
                         f"{q_eff.device}")
    _check_cuda(q_eff, q_rope, c_cache, kr_cache)
    build.refuse_grad("mla_decode_attention", "5", q_eff, q_rope, c_cache,
                      kr_cache)
    b, h, r = q_eff.shape
    s, dr = c_cache.shape[1], q_rope.shape[-1]
    dev = q_eff.device
    vl = _valid_rows(valid_len, b, dev).to(torch.int32).contiguous()
    n_splits, split_rows = split_plan(
        b, h, s, torch.cuda.get_device_properties(dev).multi_processor_count)
    out = torch.empty((b, h, r), dtype=torch.float32, device=dev)
    part_o = part_ml = None
    if n_splits > 1:
        part_o = torch.empty((b, n_splits, h, r), dtype=torch.float32,
                             device=dev)
        part_ml = torch.empty((b, n_splits, h, 2), dtype=torch.float32,
                              device=dev)
    err = _library().mla_decode_fwd(
        q_eff.data_ptr(), q_rope.data_ptr(), c_cache.data_ptr(),
        kr_cache.data_ptr(), vl.data_ptr(), out.data_ptr(),
        None if part_o is None else part_o.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(), b, h, s, r, dr,
        n_splits, split_rows, float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mla_decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    build.count_launch(mla_decode_attention)
    if n_splits > 1:
        build.count_launch(mla_decode_attention, "combine_launches")
    return out


mla_decode_attention.launches = 0
mla_decode_attention.combine_launches = 0


def _library() -> ctypes.CDLL:
    lib = build.load("mla_decode")
    fn = lib.mla_decode_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib

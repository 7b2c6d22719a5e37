"""GQA attention blocks (port of ``repro.models.attention``, GQA part).

Train/prefill path (``gqa_train``): pre-norm, the ``attn_ag`` seam for the
packed QKV projection (bias in its epilogue), RoPE, causal attention over
local heads, the ``attn_rs`` seam for the output projection.  With
``ctx.use_kernels`` the attention is the hand-written flash kernel
(``kernels.flash_attention``), otherwise the plain ``blocked_attention``.

Decode paths (``gqa_decode`` dense, ``gqa_decode_paged`` through block
tables) and the paged chunked prefill (``gqa_prefill_chunk``) compute
single-token / chunk attention in plain PyTorch, as the reference does in
plain jnp.  Cache writes are in place (see ``models.layers``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import overlap
from repro_torch.kernels.flash_attention import (NEG_INF, flash_attention,
                                                 flash_attention_ref)
from repro_torch.models import init_utils as iu
from repro_torch.models import layers
from repro_torch.parallel.sharding import TPContext, pad_heads, pad_kv_heads


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Plain causal attention (the reference's pure-jnp blocked flash): q
    [B,H,Sq,Dh], k/v [B,Hkv,Skv,Dh]; q positions are the suffix of the kv
    timeline.  The reference tiles it to bound memory under ``scan``; the
    function is the plain version of the flash kernel at offset Skv - Sq."""
    return flash_attention_ref(q, k, v, causal=causal, scale=scale,
                               kv_offset=k.shape[2] - q.shape[2])


class AttnDims(NamedTuple):
    h_pad: int
    hkv_pad: int
    dh: int

    @staticmethod
    def of(cfg: ModelConfig, tp: int) -> "AttnDims":
        return AttnDims(pad_heads(cfg.num_heads, tp),
                        pad_kv_heads(cfg.num_kv_heads, tp),
                        cfg.resolved_head_dim)


def init_gqa(gen: torch.Generator, cfg: ModelConfig, tp: int,
             dtype: torch.dtype, device: torch.device) -> Dict[str, torch.Tensor]:
    """Canonical init packed into the per-device interleaved QKV layout;
    padded heads are ZERO (function-preserving)."""
    d = AttnDims.of(cfg, tp)
    dm = cfg.d_model
    std = dm ** -0.5

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device) * std

    wq = iu.interleave_heads(normal(dm, cfg.num_heads * d.dh), cfg.num_heads,
                             d.dh, tp, d.h_pad)
    wk = iu.replicate_kv_heads(normal(dm, cfg.num_kv_heads * d.dh),
                               cfg.num_kv_heads, d.dh, tp, d.hkv_pad)
    wv = iu.replicate_kv_heads(normal(dm, cfg.num_kv_heads * d.dh),
                               cfg.num_kv_heads, d.dh, tp, d.hkv_pad)
    wo = iu.zero_pad_rows(normal(cfg.num_heads * d.dh, dm), d.h_pad * d.dh)
    p = {"wqkv": iu.pack_qkv(wq, wk, wv, tp).to(dtype),
         "wo": wo.to(dtype),
         "norm": torch.ones(dm, dtype=dtype, device=device)}
    if cfg.qkv_bias:
        p["bqkv"] = torch.zeros((d.h_pad + 2 * d.hkv_pad) * d.dh, dtype=dtype,
                                device=device)
    return p


def _split_qkv(qkv: torch.Tensor, d: AttnDims, hl: int, hkvl: int):
    b, s = qkv.shape[0], qkv.shape[1]
    q, k, v = torch.split(qkv, [hl * d.dh, hkvl * d.dh, hkvl * d.dh], dim=-1)
    return (q.reshape(b, s, hl, d.dh), k.reshape(b, s, hkvl, d.dh),
            v.reshape(b, s, hkvl, d.dh))


def _rope(q, k, pos, cfg: ModelConfig):
    if cfg.rope_style == "rope":
        return (layers.apply_rope(q, pos, cfg.rope_theta),
                layers.apply_rope(k, pos, cfg.rope_theta))
    if cfg.rope_style == "none":
        return q, k
    raise NotImplementedError(
        f"rope_style={cfg.rope_style!r} is not ported yet (ROADMAP 'Modules "
        "still to port', the other families)")


def gqa_train(p, x: torch.Tensor, ctx: TPContext, cfg: ModelConfig,
              with_cache: bool = False):
    """x: [B, S, D] -> [B, S, D] (pre-norm residual block body).
    ``with_cache=True`` also returns the prefill KV cache (bf16)."""
    tp = ctx.tp
    d = AttnDims.of(cfg, tp)
    hl, hkvl = d.h_pad // tp, d.hkv_pad // tp
    b, s_loc, _ = x.shape
    s = s_loc * ctx.seq_factor

    h = layers.rms_norm(x, p["norm"], cfg.norm_eps)
    qkv = ctx.op("attn_ag", epilogue=overlap.Epilogue(bias="bqkv" in p))(
        h, p["wqkv"], bias=p.get("bqkv"))
    q, k, v = _split_qkv(qkv, d, hl, hkvl)
    pos = torch.arange(s, device=x.device).expand(b, s)
    q, k = _rope(q, k, pos, cfg)

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if ctx.use_kernels:
        # the hand-written flash kernel (CUDA) takes contiguous [B, H, S, D]
        attn = flash_attention(qt.contiguous(), kt.contiguous(),
                               vt.contiguous(), causal=True)
    else:
        attn = blocked_attention(qt, kt, vt)
    attn = attn.transpose(1, 2).reshape(b, s, hl * d.dh)
    out = ctx.op("attn_rs")(attn, p["wo"])
    if with_cache:
        return out, {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
    return out


def _qkv_decode(p, x, d: AttnDims, hl: int, hkvl: int, cfg: ModelConfig):
    h = layers.rms_norm(x, p["norm"], cfg.norm_eps)
    qkv = torch.matmul(h, p["wqkv"])               # local columns; no comm
    if "bqkv" in p:
        qkv = qkv + p["bqkv"]
    return _split_qkv(qkv, d, hl, hkvl)


def _masked_attention(q: torch.Tensor, kv_k: torch.Tensor,
                      kv_v: torch.Tensor, valid: torch.Tensor,
                      d: AttnDims, hkvl: int, dtype) -> torch.Tensor:
    """q [B, L, Hl, Dh] over kv [B, S, Hkvl, Dh] with a boolean
    ``valid`` [B or 1, L, S] mask; fp32 softmax, -1e30 on masked scores."""
    b, l, hl, _ = q.shape
    group = hl // hkvl
    qg = q.reshape(b, l, hkvl, group, d.dh)
    scores = torch.einsum("bqhgd,bshd->bhgqs", qg.float(),
                          kv_k.float()) * (d.dh ** -0.5)
    scores = scores.masked_fill(~valid[:, None, None], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    attn = torch.einsum("bhgqs,bshd->bqhgd", w, kv_v.float())
    return attn.reshape(b, l, hl * d.dh).to(dtype)


def gqa_decode(p, x: torch.Tensor, cache: Dict, pos: torch.Tensor,
               ctx: TPContext, cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """x: [B, 1, D]; cache {k, v: [B, S_max, Hkv, Dh]} updated in place;
    ``pos``: [B] — each row's own write position.  Returns (out, cache)."""
    tp = ctx.tp
    d = AttnDims.of(cfg, tp)
    hl, hkvl = d.h_pad // tp, d.hkv_pad // tp
    b = x.shape[0]
    q, k, v = _qkv_decode(p, x, d, hl, hkvl, cfg)
    pos = pos.reshape(-1).long().expand(b)
    q, k = _rope(q, k, pos[:, None], cfg)

    ck = layers.cache_update_rows(cache["k"], k, pos)
    cv = layers.cache_update_rows(cache["v"], v, pos)
    s_max = ck.shape[1]
    valid = torch.arange(s_max, device=x.device)[None, :] <= pos[:, None]
    attn = _masked_attention(q, ck, cv, valid[:, None, :], d, hkvl, x.dtype)
    out = ctx.op("decode_ar")(attn, p["wo"])
    return out, {"k": ck, "v": cv}


def gqa_decode_paged(p, x: torch.Tensor, cache: Dict, bt: torch.Tensor,
                     pos: torch.Tensor, ctx: TPContext, cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, Dict]:
    """``gqa_decode`` through the paged KV pool: cache {k, v: [N_blocks, bs,
    Hkv, Dh]} addressed by block tables bt [B, P] (inactive slots pass
    all-zero rows: their writes land in the null block)."""
    tp = ctx.tp
    d = AttnDims.of(cfg, tp)
    hl, hkvl = d.h_pad // tp, d.hkv_pad // tp
    b = x.shape[0]
    q, k, v = _qkv_decode(p, x, d, hl, hkvl, cfg)
    pos = pos.reshape(-1).long().expand(b)
    q, k = _rope(q, k, pos[:, None], cfg)

    ck = layers.pool_update_rows(cache["k"], k, bt, pos)
    cv = layers.pool_update_rows(cache["v"], v, bt, pos)
    kview = layers.pool_view(ck, bt)
    vview = layers.pool_view(cv, bt)
    s_tot = kview.shape[1]
    valid = torch.arange(s_tot, device=x.device)[None, :] <= pos[:, None]
    attn = _masked_attention(q, kview, vview, valid[:, None, :], d, hkvl,
                             x.dtype)
    out = ctx.op("decode_ar")(attn, p["wo"])
    return out, {"k": ck, "v": cv}


def gqa_prefill_chunk(p, x: torch.Tensor, cache: Dict, bt: torch.Tensor,
                      off: int, chunk_len: int, ctx: TPContext,
                      cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """One fixed-size chunk of an incremental paged prefill: x [B, C, D];
    the chunk's K/V rows are written through the table FIRST (rows past
    ``chunk_len`` go to the null block), then row i attends to every
    position <= off + i of the gathered view."""
    tp = ctx.tp
    d = AttnDims.of(cfg, tp)
    hl, hkvl = d.h_pad // tp, d.hkv_pad // tp
    b, c_len, _ = x.shape

    h = layers.rms_norm(x, p["norm"], cfg.norm_eps)
    qkv = ctx.op("attn_ag", epilogue=overlap.Epilogue(bias="bqkv" in p))(
        h, p["wqkv"], bias=p.get("bqkv"))
    q, k, v = _split_qkv(qkv, d, hl, hkvl)
    qpos = off + torch.arange(c_len, device=x.device)
    q, k = _rope(q, k, qpos.expand(b, c_len), cfg)

    offv = torch.full((b,), off, dtype=torch.long, device=x.device)
    lenv = torch.full((b,), chunk_len, dtype=torch.long, device=x.device)
    ck = layers.pool_update_rows(cache["k"], k, bt, offv, valid=lenv)
    cv = layers.pool_update_rows(cache["v"], v, bt, offv, valid=lenv)
    kview = layers.pool_view(ck, bt)
    vview = layers.pool_view(cv, bt)
    s_tot = kview.shape[1]
    valid = torch.arange(s_tot, device=x.device)[None, :] <= qpos[:, None]
    attn = _masked_attention(q, kview, vview, valid[None], d, hkvl, x.dtype)
    out = ctx.op("attn_rs")(attn, p["wo"])
    return out, {"k": ck, "v": cv}


def gqa_cache_shape(cfg: ModelConfig, tp: int, batch: int,
                    s_max: int) -> Tuple[int, ...]:
    d = AttnDims.of(cfg, tp)
    return (batch, s_max, d.hkv_pad // tp, d.dh)

"""Attention blocks (port of ``repro.models.attention``): GQA and DeepSeek
multi-head latent attention (MLA).

Train/prefill path (``gqa_train``): pre-norm, the ``attn_ag`` seam for the
packed QKV projection (bias in its epilogue), RoPE, causal attention over
local heads, the ``attn_rs`` seam for the output projection.  With
``ctx.use_kernels`` the attention is the hand-written flash kernel
(``kernels.flash_attention``, forward only: under grad it raises),
otherwise the plain ``blocked_attention``, which training runs, as the
reference's does.
``mla_train`` runs the same seams around the latent projections and always
attends in plain ``blocked_attention``, as the reference does; under grad
at tp>1 its seams (the two up-projections' ``attn_ag``, the rope key's
gather, whose transpose is ``scatter_seq_sum``, and ``attn_rs``) record
on the rank's ``SeamTape``.

Decode paths (``gqa_decode`` dense, ``gqa_decode_paged`` through block
tables) and the paged chunked prefill (``gqa_prefill_chunk``) compute
single-token / chunk attention in plain PyTorch, as the reference does in
plain jnp.  The MLA decode paths (``mla_decode``, ``mla_decode_paged``)
keep the absorbed form: the cache holds only the latent ``c`` and the
rope key ``kr`` per token; with ``ctx.use_kernels`` their attention over
the latent cache is the hand-written MLA-decode kernel
(``kernels.mla_decode``).  Cache writes are in place (see
``models.layers``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import overlap
from repro_torch.kernels.flash_attention import (NEG_INF, flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.mla_decode import mla_decode_attention
from repro_torch.models import init_utils as iu
from repro_torch.models import layers
from repro_torch.parallel.sharding import TPContext, pad_heads, pad_kv_heads


FLASH_BWD_NOT_PORTED = (
    "training through the flash-attention kernel needs its backward, which "
    "is not written yet (ROADMAP queue 1 item 5); the reference trains "
    "through plain attention: train with kernel_decode=False")


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Plain causal attention (the reference's pure-jnp blocked flash): q
    [B,H,Sq,Dh], k [B,Hkv,Skv,Dh], v [B,Hkv,Skv,Dv] (Dv may differ — MLA);
    q positions are the suffix of the kv timeline.  The reference tiles it to bound memory under ``scan``; the
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
    """x: [B, S, D] -> [B, S, D] (pre-norm residual block body); at tp>1
    [B, S/TP, D] -> [B, S/TP, D] over this rank's heads, the seams
    gathering and scattering the sequence (in the replicated layout
    [B, S, D] -> [B, S, D], the seams a local GEMM and an AllReduce).  ``with_cache=True`` also
    returns the prefill KV cache (bf16; full sequence, local KV heads)."""
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
    if ctx.use_kernels and torch.is_grad_enabled() and any(
            t.requires_grad for t in (qt, kt, vt)):
        raise NotImplementedError(FLASH_BWD_NOT_PORTED)
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


# ---------------------------------------------------------------------------
# DeepSeek-V3 multi-head latent attention
# ---------------------------------------------------------------------------
def init_mla(gen: torch.Generator, cfg: ModelConfig, tp: int,
             dtype: torch.dtype, device: torch.device
             ) -> Dict[str, torch.Tensor]:
    """The reference's shapes and scales: normal(0, 1/sqrt(fan_in)) latent
    projections (``w_o`` scaled by 1/sqrt(d_model), as the reference does),
    ones for the three norms."""
    m = cfg.mla
    dm = cfg.d_model
    h_pad = pad_heads(cfg.num_heads, tp)
    std = dm ** -0.5

    def normal(*shape, scale):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dtype)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    return {
        "w_dq": normal(dm, m.q_lora_rank, scale=std),
        "w_uq": normal(m.q_lora_rank,
                       h_pad * (m.qk_nope_head_dim + m.qk_rope_head_dim),
                       scale=m.q_lora_rank ** -0.5),
        "w_dkv": normal(dm, m.kv_lora_rank + m.qk_rope_head_dim, scale=std),
        "w_ukv": normal(m.kv_lora_rank,
                        h_pad * (m.qk_nope_head_dim + m.v_head_dim),
                        scale=m.kv_lora_rank ** -0.5),
        "w_o": normal(h_pad * m.v_head_dim, dm, scale=std),
        "q_norm": ones(m.q_lora_rank),
        "kv_norm": ones(m.kv_lora_rank),
        "norm": ones(dm),
    }


def _mla_scale(cfg: ModelConfig) -> float:
    return (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim) ** -0.5


def _mla_latents(p, x: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig,
                 axis=None):
    """Pre-norm and the latent down-projections (replicated weights, on
    this rank's rows) at positions pos [B, L]: (q_lat [B, L, Rq], kv_lat
    [B, L, R], k_rope [B, L, Dr] rotated).  The normed input (read by both
    down-projections) and the kv projection (the latent's and the rope
    key's) are cut on the seam tape (``overlap.cut`` over ``axis``, the
    context's ``tape_axis``): each feeds two seams."""
    m = cfg.mla
    h = overlap.cut(layers.rms_norm(x, p["norm"], cfg.norm_eps), axis)
    q_lat = layers.rms_norm(torch.matmul(h, p["w_dq"]), p["q_norm"],
                            cfg.norm_eps)
    kv_all = overlap.cut(torch.matmul(h, p["w_dkv"]), axis)
    kv_lat = layers.rms_norm(kv_all[..., :m.kv_lora_rank], p["kv_norm"],
                             cfg.norm_eps)
    k_rope = layers.apply_rope(kv_all[..., None, m.kv_lora_rank:], pos,
                               cfg.rope_theta)[:, :, 0, :]
    return q_lat, kv_lat, k_rope


def mla_train(p, x: torch.Tensor, ctx: TPContext, cfg: ModelConfig,
              with_cache: bool = False):
    """x: [B, S, D] -> [B, S, D] ([B, S/TP, D] sequence-sharded: each rank
    projects its rows' latents, rotates its rope key at their global
    positions, and gathers the rope key along the ``attn_ag`` seam's
    transport; the head up-projections are AllGather-GEMMs over this
    rank's H/TP heads).  ``with_cache=True`` also returns the prefill
    latent cache {"c": [B, S, R], "kr": [B, S, Dr]} (bf16), whole on
    every rank."""
    m = cfg.mla
    hl = pad_heads(cfg.num_heads, ctx.tp) // ctx.tp
    b, s_loc, _ = x.shape
    s = s_loc * ctx.seq_factor
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim

    pos_loc = layers.seq_positions(b, s_loc, x.device, ctx=ctx)
    q_lat, kv_lat, k_rope_loc = _mla_latents(p, x, pos_loc, cfg,
                                               ctx.tape_axis)
    # head up-projections: the AllGather-GEMM seams (distinct input latents,
    # so no gather sharing between them)
    ag_op = ctx.op("attn_ag")
    q = ag_op(q_lat, p["w_uq"]).reshape(b, s, hl, dn + dr)
    kv = ag_op(kv_lat, p["w_ukv"]).reshape(b, s, hl, dn + dv)
    k_nope, v = torch.split(kv, [dn, dv], dim=-1)
    # the shared rope key is a non-GEMM payload of the seam
    k_rope = ctx.gather_seq(k_rope_loc, "attn_ag")
    pos = layers.seq_positions(b, s, x.device)
    q_nope, q_rope = torch.split(q, [dn, dr], dim=-1)
    q = torch.cat([q_nope, layers.apply_rope(q_rope, pos, cfg.rope_theta)],
                  dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, hl, dr)],
                  dim=-1)
    attn = blocked_attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), scale=_mla_scale(cfg))
    attn = attn.transpose(1, 2).reshape(b, s, hl * dv)
    out = ctx.op("attn_rs")(attn, p["w_o"])
    if with_cache:
        c = ctx.gather_seq(kv_lat, "attn_ag")
        return out, {"c": c.to(torch.bfloat16),
                     "kr": k_rope.to(torch.bfloat16)}
    return out


def _mla_absorbed(p, x: torch.Tensor, pos: torch.Tensor, hl: int,
                  cfg: ModelConfig):
    """The absorbed-form projections at positions pos [B, L]: the query
    with W_uk absorbed, q_eff [B, L, H, R] fp32, the rotated q_rope
    [B, L, H, Dr], the new cache rows kv_lat / k_rope, and W_uv
    [R, H, Dv]."""
    m = cfg.mla
    b, l, _ = x.shape
    dn = m.qk_nope_head_dim
    q_lat, kv_lat, k_rope = _mla_latents(p, x, pos, cfg)
    q = torch.matmul(q_lat, p["w_uq"]).reshape(b, l, hl,
                                                dn + m.qk_rope_head_dim)
    q_nope, q_rope = torch.split(q, [dn, m.qk_rope_head_dim], dim=-1)
    q_rope = layers.apply_rope(q_rope, pos, cfg.rope_theta)
    w_ukv = p["w_ukv"].reshape(m.kv_lora_rank, hl, dn + m.v_head_dim)
    w_uk, w_uv = torch.split(w_ukv, [dn, m.v_head_dim], dim=-1)
    q_eff = torch.einsum("bqhd,rhd->bqhr", q_nope.float(), w_uk.float())
    return q_eff, q_rope, kv_lat, k_rope, w_uv


def _latent_attention(q_eff: torch.Tensor, q_rope: torch.Tensor,
                      c: torch.Tensor, kr: torch.Tensor, valid: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """Plain absorbed attention: q_eff [B, L, H, R] (fp32), q_rope
    [B, L, H, Dr] over the latent cache c [B, S, R], kr [B, S, Dr] with a
    boolean ``valid`` [B or 1, L, S] mask -> ctx [B, L, H, R] fp32."""
    cf = c.float()
    scores = (torch.einsum("bqhr,bsr->bhqs", q_eff, cf)
              + torch.einsum("bqhd,bsd->bhqs", q_rope.float(), kr.float())
              ) * scale
    scores = scores.masked_fill(~valid[:, None], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqs,bsr->bqhr", w, cf)


def _mla_decode_attention(q_eff, q_rope, c, kr, pos: torch.Tensor,
                          ctx: TPContext, cfg: ModelConfig) -> torch.Tensor:
    """One query row per batch row over its cache c/kr [B, S, ...], valid
    up to and including ``pos`` [B]: ctx [B, 1, H, R] fp32.  With
    ``ctx.use_kernels`` it is the MLA-decode kernel (one streaming pass
    over the latent cache)."""
    if ctx.use_kernels:
        return mla_decode_attention(
            q_eff[:, 0].contiguous(), q_rope[:, 0].float().contiguous(), c,
            kr, pos + 1, scale=_mla_scale(cfg))[:, None]
    valid = torch.arange(c.shape[1], device=c.device)[None, :] <= pos[:, None]
    return _latent_attention(q_eff, q_rope, c, kr, valid[:, None, :],
                             _mla_scale(cfg))


def _mla_out(p, ctx_lat: torch.Tensor, w_uv: torch.Tensor, x: torch.Tensor,
             seam: str, ctx: TPContext) -> torch.Tensor:
    """Absorb W_uv after the weighted latent sum, then the output seam."""
    b, l = ctx_lat.shape[:2]
    attn = torch.einsum("bqhr,rhd->bqhd", ctx_lat, w_uv.float())
    return ctx.op(seam)(attn.reshape(b, l, -1).to(x.dtype), p["w_o"])


def mla_decode(p, x: torch.Tensor, cache: Dict, pos: torch.Tensor,
               ctx: TPContext, cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """Absorbed-form MLA decode.  x: [B, 1, D]; cache {c: [B, S_max, R],
    kr: [B, S_max, Dr]} updated in place; ``pos``: [B] per-row write
    positions."""
    hl = pad_heads(cfg.num_heads, ctx.tp) // ctx.tp
    b = x.shape[0]
    pos = pos.reshape(-1).long().expand(b)
    q_eff, q_rope, kv_lat, k_rope, w_uv = _mla_absorbed(p, x, pos[:, None],
                                                        hl, cfg)
    cc = layers.cache_update_rows(cache["c"], kv_lat, pos)
    cr = layers.cache_update_rows(cache["kr"], k_rope, pos)
    ctx_lat = _mla_decode_attention(q_eff, q_rope, cc, cr, pos, ctx, cfg)
    return _mla_out(p, ctx_lat, w_uv, x, "decode_ar", ctx), {"c": cc,
                                                              "kr": cr}


def mla_decode_paged(p, x: torch.Tensor, cache: Dict, bt: torch.Tensor,
                     pos: torch.Tensor, ctx: TPContext, cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, Dict]:
    """``mla_decode`` over the paged latent pools {c: [N_blocks, bs, R],
    kr: [N_blocks, bs, Dr]} through block tables bt [B, P]: the gathered
    per-row views are shaped like the dense caches, so the kernel path
    applies unchanged."""
    hl = pad_heads(cfg.num_heads, ctx.tp) // ctx.tp
    b = x.shape[0]
    pos = pos.reshape(-1).long().expand(b)
    q_eff, q_rope, kv_lat, k_rope, w_uv = _mla_absorbed(p, x, pos[:, None],
                                                        hl, cfg)
    cc = layers.pool_update_rows(cache["c"], kv_lat, bt, pos)
    cr = layers.pool_update_rows(cache["kr"], k_rope, bt, pos)
    ctx_lat = _mla_decode_attention(q_eff, q_rope, layers.pool_view(cc, bt),
                                    layers.pool_view(cr, bt), pos, ctx, cfg)
    return _mla_out(p, ctx_lat, w_uv, x, "decode_ar", ctx), {"c": cc,
                                                              "kr": cr}


def mla_prefill_chunk(p, x: torch.Tensor, cache: Dict, bt: torch.Tensor,
                      off: int, chunk_len: int, ctx: TPContext,
                      cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """Absorbed-form chunked prefill over the paged latent pools: the math
    of ``mla_decode_paged`` with C query rows (x [B, C, D]); rows past
    ``chunk_len`` write the null block, row i attends to positions
    <= off + i."""
    hl = pad_heads(cfg.num_heads, ctx.tp) // ctx.tp
    b, c_len, _ = x.shape
    qpos = off + torch.arange(c_len, device=x.device)
    q_eff, q_rope, kv_lat, k_rope, w_uv = _mla_absorbed(
        p, x, qpos.expand(b, c_len), hl, cfg)
    offv = torch.full((b,), off, dtype=torch.long, device=x.device)
    lenv = torch.full((b,), chunk_len, dtype=torch.long, device=x.device)
    cc = layers.pool_update_rows(cache["c"], kv_lat, bt, offv, valid=lenv)
    cr = layers.pool_update_rows(cache["kr"], k_rope, bt, offv, valid=lenv)
    cview = layers.pool_view(cc, bt)
    valid = torch.arange(cview.shape[1], device=x.device)[None, :] \
        <= qpos[:, None]
    ctx_lat = _latent_attention(q_eff, q_rope, cview,
                                layers.pool_view(cr, bt), valid[None],
                                _mla_scale(cfg))
    return _mla_out(p, ctx_lat, w_uv, x, "attn_rs", ctx), {"c": cc, "kr": cr}


def mla_cache_shapes(cfg: ModelConfig, batch: int,
                     s_max: int) -> Dict[str, Tuple[int, ...]]:
    """The latent cache: ``c`` [batch, s_max, R] and ``kr`` [batch, s_max,
    Dr] (heads share it, so nothing is split over tp)."""
    m = cfg.mla
    return {"c": (batch, s_max, m.kv_lora_rank),
            "kr": (batch, s_max, m.qk_rope_head_dim)}

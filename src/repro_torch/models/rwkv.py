"""RWKV-6 (Finch) blocks (port of ``repro.models.rwkv``): the time-mix with
its data-dependent decay and the channel-mix, served and trained.

TP mapping (the reference's): the time-mix's heads and the channel-mix's
hidden units are cut over the TP ranks.  The five token-shift
projections of the time-mix (r, k, v, g and the decay LoRA's down
projection ``w_dec1``, replicated) ride ONE shared-gather ``attn_ag``
seam: the per-projection mix ``(1 - mu_i) h + mu_i prev`` commutes into
the weights, ``[h | prev] @ [(1 - mu_i) W ; mu_i W]``, so the activation
``[h | prev]`` is gathered once for all five (under flux one AG-GEMM
launch over the five weights side by side).  Its output projection
``w_o`` is the ``attn_rs`` seam.  The channel-mix's key projection is the
``mlp_ag`` seam with the squared-ReLU epilogue (fused into the kernel's
tile epilogue under flux), its value projection the ``mlp_rs`` seam, and
its receptance ``w_r`` a replicated square weight computed on the
sequence shard.  The WKV recurrence itself is head-local: it exchanges
nothing.

The WKV6 recurrence, per head (state S: [dh_k, dh_v])::

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

is computed chunkwise, as the reference does (``_wkv_chunk``): within a
chunk the quadratic form with decay-ratio masking, across chunks the
fp32 state carried by a loop over chunks (64 positions, halved until the
chunk divides S).  The reference computes it in ``jnp`` outside any
Pallas kernel, so it is plain PyTorch here on both devices.

Under grad the chunk loop is an autograd Function (``_WKV``) that keeps
no per-chunk intermediate: it saves its inputs and the fp32 state
carried into each chunk, and its backward walks the chunks last first,
re-runs each chunk's ``_wkv_chunk`` under grad from its carried state
and takes autograd's vjp of that one chunk with the grads of its output
and of the state it hands on.  Autograd through the loop itself would
keep about ten chunk-sized tensors a chunk (the decayed r and k, the
masked scores before and after the mask, the exponentials, ...).

``rwkv_time_train`` / ``rwkv_channel_train`` are the training forward and
the prefill (and, from a carried-in ``cache``, a chunk of the chunked
prefill).  At tp>1 each cuts its normed input on the seam tape
(``overlap.cut``): it feeds the token shift's exchange and a seam (the
channel-mix also cuts the shift's delta, which feeds two mixes).
``rwkv_time_decode`` / ``rwkv_channel_decode`` are the O(1) single-token
update, forward only (the reference's serving step).  The recurrent
state is the time-mix's ``{"state": [B, hl, dh, dh] fp32, "last": [B, D]}``
and the channel-mix's ``{"last": [B, D]}`` (``rwkv_cache_shapes``): ``last``
is the last true token's normed input, which seeds the token shift.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import overlap
from repro_torch.models import init_utils as iu
from repro_torch.models import layers
from repro_torch.parallel.sharding import TPContext, ceil_mult

DECODE_NO_GRAD = (
    "{} is the serving step and runs forward only, as the reference's; "
    "train through {}")
STATE_DTYPE = torch.float32          # the wkv state's cache dtype
LAST_DTYPE = torch.bfloat16          # the token-shift row's cache dtype


def _dims(cfg: ModelConfig, tp: int) -> Tuple[int, int, int]:
    """(heads padded to a multiple of tp, head dim, d_attn = heads * dh)."""
    dh = cfg.rwkv.head_dim
    n_heads = ceil_mult(cfg.d_model // dh, tp)
    return n_heads, dh, n_heads * dh


def init_rwkv_time(gen: torch.Generator, cfg: ModelConfig, tp: int,
                   dtype: torch.dtype, device: torch.device
                   ) -> Dict[str, torch.Tensor]:
    """The reference's time-mix leaves, drawn in its order: ``mu`` [5, D]
    uniform; ``w_r`` / ``w_k`` / ``w_v`` / ``w_g`` [D, d_attn] and
    ``w_dec2`` [decay_lora, d_attn], their padded head columns zero;
    ``w_dec1`` [D, decay_lora]; ``u_bonus`` [d_attn] and ``dec_base`` (-6)
    in fp32 whatever ``dtype``; ``w_o`` [d_attn, D], its padded rows zero;
    ``ln_x`` [dh] (the per-head group norm) and ``norm`` [D]."""
    rc = cfg.rwkv
    dm = cfg.d_model
    _, dh, d_attn = _dims(cfg, tp)
    d_can = (dm // dh) * dh                  # canonical head columns
    std = dm ** -0.5

    def normal(*shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    def cols(*shape, scale):
        return iu.zero_pad_cols(normal(*shape, scale=scale), d_attn).to(dtype)

    mu = torch.rand((5, dm), generator=gen, device=device).to(dtype)
    w_r = cols(dm, d_can, scale=std)
    w_k = cols(dm, d_can, scale=std)
    w_v = cols(dm, d_can, scale=std)
    w_g = cols(dm, d_can, scale=std)
    w_dec1 = normal(dm, rc.decay_lora, scale=std).to(dtype)
    w_dec2 = cols(rc.decay_lora, d_can, scale=rc.decay_lora ** -0.5)
    u_bonus = iu.zero_pad_cols(normal(d_can, scale=0.1), d_attn)
    w_o = iu.zero_pad_rows(normal(d_can, dm, scale=d_can ** -0.5),
                           d_attn).to(dtype)
    return {
        "mu": mu, "w_r": w_r, "w_k": w_k, "w_v": w_v, "w_g": w_g,
        "w_dec1": w_dec1, "w_dec2": w_dec2,
        "dec_base": torch.full((d_attn,), -6.0, dtype=torch.float32,
                               device=device),
        "u_bonus": u_bonus, "w_o": w_o,
        "ln_x": torch.ones(dh, dtype=dtype, device=device),
        "norm": torch.ones(dm, dtype=dtype, device=device),
    }


def init_rwkv_channel(gen: torch.Generator, cfg: ModelConfig, tp: int,
                      dtype: torch.dtype, device: torch.device
                      ) -> Dict[str, torch.Tensor]:
    """The reference's channel-mix leaves, drawn in its order: ``mu`` [2,
    D] uniform, ``w_k`` [D, ffp] (its padded columns zero), ``w_v`` [ffp,
    D] (its padded rows zero), ``w_r`` [D, D], ``norm`` [D]; ffp is d_ff
    padded to a multiple of tp * 128."""
    dm = cfg.d_model
    ffp = ceil_mult(cfg.d_ff, tp * 128)
    std = dm ** -0.5

    def normal(*shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    mu = torch.rand((2, dm), generator=gen, device=device).to(dtype)
    w_k = iu.zero_pad_cols(normal(dm, cfg.d_ff, scale=std), ffp).to(dtype)
    w_v = iu.zero_pad_rows(normal(cfg.d_ff, dm, scale=cfg.d_ff ** -0.5),
                           ffp).to(dtype)
    w_r = normal(dm, dm, scale=std).to(dtype)
    return {"mu": mu, "w_k": w_k, "w_v": w_v, "w_r": w_r,
            "norm": torch.ones(dm, dtype=dtype, device=device)}


def _refuse_grad(p: Dict, x: torch.Tensor, step: str, train: str) -> None:
    if torch.is_grad_enabled() and (x.requires_grad or any(
            t.requires_grad for t in p.values())):
        raise NotImplementedError(DECODE_NO_GRAD.format(step, train))


def _wkv_chunk(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk, the reference's matrix form: r, k, v, logw [B, H, L, dh]
    (logw <= 0), u [H, dh], s0 [B, H, dh, dh], fp32.  Returns (y [B, H, L,
    dh], the state after the chunk)."""
    n = r.shape[2]
    cw = torch.cumsum(logw, dim=2)                       # cumulative log decay
    # inter-chunk: y_t += (r_t * exp(cw_{t-1})) @ S_prev
    r_dec = r * torch.exp(cw - logw)
    y = torch.matmul(r_dec, s0)
    # intra-chunk: A[t, s] = sum_d r_dec[t, d] k[s, d] exp(-cw[s, d]) (s < t)
    # and the diagonal r . (u * k)
    kd = k * torch.exp(-cw)
    att = torch.matmul(r_dec, kd.transpose(-1, -2))
    mask = torch.tril(torch.ones((n, n), dtype=torch.bool, device=r.device),
                      diagonal=-1)
    att = torch.where(mask, att, torch.zeros((), device=r.device))
    diag = (r * (u[None, :, None, :] * k)).sum(-1)
    y = y + torch.matmul(att, v)
    y = y + diag[..., None] * v
    # S_new = diag(exp(cw_L)) S_prev + sum_t exp(cw_L - cw_t) k_t v_t^T
    wtot = torch.exp(cw[:, :, -1])                       # [B, H, dh]
    k_rem = k * torch.exp(cw[:, :, -1:] - cw)
    s_new = s0 * wtot[..., None] + torch.matmul(k_rem.transpose(-1, -2), v)
    return y, s_new


def _chunk_len(s: int, chunk: int) -> int:
    """The reference's rule: the chunk halves until it divides S."""
    chunk = min(chunk, s)
    while s % chunk:
        chunk //= 2
    return chunk


def _wkv_loop(r, k, v, logw, u, s0, step: int, states=None):
    """The loop over chunks of ``step`` positions carrying the state;
    ``states`` (a list) takes the state carried into each chunk.  Returns
    (y, the final state)."""
    ys, state = [], s0
    for i in range(0, r.shape[2], step):
        sl = slice(i, i + step)
        if states is not None:
            states.append(state)
        y, state = _wkv_chunk(r[:, :, sl], k[:, :, sl], v[:, :, sl],
                              logw[:, :, sl], u, state)
        ys.append(y)
    return torch.cat(ys, dim=2), state


class _WKV(torch.autograd.Function):
    """The chunked wkv whose backward re-runs each chunk.  The forward is
    the serving loop (``_wkv_loop``); it saves its inputs and the fp32
    state carried into each chunk, [n_chunks, B, H, dh, dh], and no
    per-chunk intermediate.  The backward walks the chunks last first:
    it re-runs a chunk's ``_wkv_chunk`` under grad from its carried state
    and takes the vjp of that chunk alone with the grads of its output
    and of the state it hands on, which gives the chunk's input grads and
    the carried state's grad for the chunk before it.  It holds one
    chunk's intermediates at a time."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, s0, chunk: int):
        step = _chunk_len(r.shape[2], chunk)
        states = []
        y, sfin = _wkv_loop(r, k, v, logw, u, s0, step, states)
        ctx.step = step
        ctx.save_for_backward(r, k, v, logw, u, s0, torch.stack(states))
        return y, sfin

    @staticmethod
    def backward(ctx, dy, ds_fin):
        r, k, v, logw, u, _, states = ctx.saved_tensors
        step = ctx.step
        dr, dk = torch.empty_like(r), torch.empty_like(k)
        dv, dlogw = torch.empty_like(v), torch.empty_like(logw)
        du, g = torch.zeros_like(u), ds_fin
        for c in reversed(range(states.shape[0])):
            sl = slice(c * step, (c + 1) * step)
            ins = [t[:, :, sl].detach().requires_grad_()
                   for t in (r, k, v, logw)]
            ins += [u.detach().requires_grad_(),
                    states[c].detach().requires_grad_()]
            with torch.enable_grad():
                y, s_new = _wkv_chunk(*ins)
                (dr[:, :, sl], dk[:, :, sl], dv[:, :, sl], dlogw[:, :, sl],
                 du_c, g) = torch.autograd.grad((y, s_new), ins,
                                                (dy[:, :, sl], g))
            du += du_c
        return dr, dk, dv, dlogw, du, g, None


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
        chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked WKV over the whole sequence: r, k, v, logw [B, H, S,
    dh], u [H, dh], s0 [B, H, dh, dh], fp32; a loop over chunks carrying
    the state (the chunk halves until it divides S, the reference's
    rule).  Returns (y [B, H, S, dh], the final state); under grad its
    backward re-runs each chunk (``_WKV``)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, logw, u, s0)):
        return _WKV.apply(r, k, v, logw, u, s0, chunk)
    return _wkv_loop(r, k, v, logw, u, s0, _chunk_len(r.shape[2], chunk))


def _shifted(h: torch.Tensor, ctx: TPContext,
             cache: Optional[Dict[str, torch.Tensor]]) -> torch.Tensor:
    """x_{t-1} of the normed input (the token shift): across the shards
    through ``layers.shift_tokens_right``; a carried-in ``cache``'s
    ``last`` takes position 0's place."""
    prev = layers.shift_tokens_right(h, ctx)
    if cache is None:
        return prev
    return torch.cat([cache["last"].to(h.dtype)[:, None], prev[:, 1:]],
                     dim=1)


def _last_row(h: torch.Tensor, ctx: TPContext,
              lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """The last true token's normed input [B, D] (the next token's shift):
    the final shard's tail, or with ``lengths`` each row's own, through
    ``gather_seq`` on the ``attn_ag`` seam's transport."""
    if lengths is None:
        return ctx.gather_seq(h[:, -1:], "attn_ag")[:, -1]
    return layers.take_rows(ctx.gather_seq(h, "attn_ag"), lengths - 1)


def _check_cache(cache, ctx: TPContext) -> None:
    if cache is not None and ctx.seq_sharded and ctx.tp > 1:
        raise ValueError("a carried-in RWKV state needs the replicated "
                         "layout (ctx.with_layout(False))")


def rwkv_time_train(p: Dict, x: torch.Tensor, ctx: TPContext,
                    cfg: ModelConfig, chunk: int = 64,
                    with_cache: bool = False,
                    lengths: Optional[torch.Tensor] = None,
                    cache: Optional[Dict[str, torch.Tensor]] = None):
    """x: [B, S/TP, D] -> [B, S/TP, D] (the replicated layout: [B, S, D]);
    the WKV sees the full sequence either way (gathered by the ``attn_ag``
    seam).

    ``lengths`` ([B], optional): each row's true prompt length in a
    right-padded batch.  Pad positions get k = 0 and logw = 0 (decay
    exp(0) = 1): the state is left as it was, so the returned ``state`` is
    each row's after its own prompt and ``last`` its last true token's
    normed input.  Outputs at pad positions are not meaningful.

    ``cache`` ({state, last}, optional): the state at position 0, which
    seeds a chunk of the chunked prefill (the replicated layout only: the
    token shift's boundary is the previous chunk's last token).  Under
    grad this is the training forward: the wkv's backward re-runs each
    chunk (``wkv``)."""
    _check_cache(cache, ctx)
    n_heads, dh, _ = _dims(cfg, ctx.tp)
    hl = n_heads // ctx.tp
    b, s_loc, _ = x.shape
    s = s_loc * ctx.seq_factor

    # the normed input feeds the token shift's exchange and the attn_ag
    # seam: cut on the seam tape, so the backward walks its segment once
    h = overlap.cut(layers.rms_norm(x, p["norm"], cfg.norm_eps),
                    ctx.tape_axis)
    prev = _shifted(h, ctx, cache)
    xcat = torch.cat([h, prev], dim=-1)                  # [B, S_loc, 2D]

    def stacked(i, w):
        # the mix in the weights' dtype, as the reference rounds it
        mu_i = p["mu"][i].to(w.dtype)
        return torch.cat([(1 - mu_i)[:, None] * w, mu_i[:, None] * w],
                         dim=0)

    r, kk, vv, g, dec_low = ctx.op("attn_ag", n_weights=5)(
        xcat, stacked(0, p["w_r"]), stacked(1, p["w_k"]),
        stacked(2, p["w_v"]), stacked(3, p["w_g"]),
        stacked(4, p["w_dec1"]))
    dec = torch.matmul(torch.tanh(dec_low), p["w_dec2"])
    logw = -torch.exp(p["dec_base"] + dec.float())       # [B, S, F] (< 0)

    def heads(t):
        return t.reshape(b, s, hl, dh).transpose(1, 2).float()

    r_, k_, v_, w_ = heads(r), heads(kk), heads(vv), heads(logw)
    if lengths is not None:
        in_prompt = (torch.arange(s, device=x.device)[None, :]
                     < lengths.to(x.device)[:, None])[:, None, :, None]
        zero = torch.zeros((), device=x.device)
        k_ = torch.where(in_prompt, k_, zero)
        w_ = torch.where(in_prompt, w_, zero)
    u_loc = p["u_bonus"].reshape(hl, dh)                 # head-local at tp>1
    s0 = (torch.zeros((b, hl, dh, dh), dtype=torch.float32, device=x.device)
          if cache is None else cache["state"].float())
    y, sfin = wkv(r_, k_, v_, w_, u_loc, s0, chunk)
    y = y.transpose(1, 2).to(x.dtype)                    # [B, S, hl, dh]
    # the per-head group norm (pad heads stay zero: TP-layout invariant)
    y = layers.rms_norm(y, p["ln_x"], cfg.norm_eps).reshape(b, s, hl * dh)
    y = y * F.silu(g)
    out = ctx.op("attn_rs")(y, p["w_o"])
    if with_cache:
        return out, {"state": sfin, "last": _last_row(h, ctx, lengths)}
    return out


def rwkv_channel_train(p: Dict, x: torch.Tensor, ctx: TPContext,
                       cfg: ModelConfig, with_cache: bool = False,
                       lengths: Optional[torch.Tensor] = None,
                       cache: Optional[Dict[str, torch.Tensor]] = None):
    """The channel-mix over a prefill batch or chunk: x [B, S/TP, D] ->
    [B, S/TP, D].  ``cache`` ({last}, optional) seeds the token shift of
    a chunk of the chunked prefill (the replicated layout only);
    ``with_cache`` returns ``{"last"}``, each row's at its ``lengths``.
    Under grad this is the training forward."""
    _check_cache(cache, ctx)
    # the normed input feeds the token shift's exchange, the mlp_ag seam
    # and the local w_r GEMM, and the shift's delta both mixes (xk into the
    # seam, xr into the root's segment): each cut on the seam tape, so the
    # backward walks each segment once
    h = overlap.cut(layers.rms_norm(x, p["norm"], cfg.norm_eps),
                    ctx.tape_axis)
    delta = overlap.cut(_shifted(h, ctx, cache) - h, ctx.tape_axis)
    xk = h + delta * p["mu"][0]
    xr = h + delta * p["mu"][1]
    # the squared ReLU fuses into the AllGather seam's epilogue
    k = ctx.op("mlp_ag", epilogue=overlap.Epilogue(activation="sqrelu"))(
        xk, p["w_k"])
    kv = ctx.op("mlp_rs")(k, p["w_v"])
    # the receptance gate: a replicated square weight, on the seq shard
    out = torch.sigmoid(torch.matmul(xr, p["w_r"])) * kv
    if with_cache:
        return out, {"last": _last_row(h, ctx, lengths)}
    return out


def rwkv_time_decode(p: Dict, x: torch.Tensor,
                     cache: Dict[str, torch.Tensor], ctx: TPContext,
                     cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The single-token update, O(1) in the sequence length, in the
    replicated layout: x [B, 1, D]; cache {state [B, hl, dh, dh], last
    [B, D]}, read and left as it is.  The projections are local; ``w_o``
    runs on the ``decode_ar`` seam.  Returns (out [B, 1, D], the new
    {state (fp32), last (the compute dtype)}).  Forward only."""
    _refuse_grad(p, x, "rwkv_time_decode", "rwkv_time_train")
    n_heads, dh, _ = _dims(cfg, ctx.tp)
    hl = n_heads // ctx.tp
    b = x.shape[0]
    h = layers.rms_norm(x, p["norm"], cfg.norm_eps)[:, 0]   # [B, D]
    delta = cache["last"] - h

    def mixed(i):
        return h + delta * p["mu"][i]

    r = torch.matmul(mixed(0), p["w_r"])
    kk = torch.matmul(mixed(1), p["w_k"])
    vv = torch.matmul(mixed(2), p["w_v"])
    g = torch.matmul(mixed(3), p["w_g"])
    dec = torch.matmul(torch.tanh(torch.matmul(mixed(4), p["w_dec1"])),
                       p["w_dec2"])
    logw = -torch.exp(p["dec_base"] + dec.float())

    def hd(t):
        return t.reshape(b, hl, dh).float()

    r_, k_, v_, w_ = hd(r), hd(kk), hd(vv), hd(logw)
    u_loc = p["u_bonus"].reshape(hl, dh)
    s_prev = cache["state"].float()
    kv = k_[..., :, None] * v_[..., None, :]             # [B, hl, dh, dh]
    y = torch.matmul(r_[..., None, :],
                     s_prev + u_loc[None, :, :, None] * kv)[..., 0, :]
    s_new = s_prev * torch.exp(w_)[..., None] + kv
    y = y.reshape(b, 1, hl, dh).to(x.dtype)
    y = layers.rms_norm(y, p["ln_x"], cfg.norm_eps).reshape(b, 1, hl * dh)
    y = y * F.silu(g.reshape(b, 1, hl * dh))
    out = ctx.op("decode_ar")(y, p["w_o"])
    return out, {"state": s_new, "last": h}


def rwkv_channel_decode(p: Dict, x: torch.Tensor,
                        cache: Dict[str, torch.Tensor], ctx: TPContext,
                        cfg: ModelConfig
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The channel-mix's single-token step: x [B, 1, D]; cache {last [B,
    D]}; ``w_v`` runs on the ``decode_ar`` seam.  Returns (out [B, 1, D],
    the new {last}).  Forward only."""
    _refuse_grad(p, x, "rwkv_channel_decode", "rwkv_channel_train")
    h = layers.rms_norm(x, p["norm"], cfg.norm_eps)[:, 0]
    delta = cache["last"] - h
    xk = (h + delta * p["mu"][0])[:, None]
    xr = (h + delta * p["mu"][1])[:, None]
    k = torch.square(F.relu(torch.matmul(xk, p["w_k"])))
    kv = ctx.op("decode_ar")(k, p["w_v"])
    out = torch.sigmoid(torch.matmul(xr, p["w_r"])) * kv
    return out, {"last": h}


def rwkv_cache_shapes(cfg: ModelConfig, tp: int, rows: int
                      ) -> Tuple[Dict[str, Tuple[Tuple[int, ...],
                                                 torch.dtype]],
                                 Dict[str, Tuple[Tuple[int, ...],
                                                 torch.dtype]]]:
    """This rank's recurrent state, (the time-mix's, the channel-mix's):
    ({"state": ((rows, hl, dh, dh), fp32), "last": ((rows, D), bf16)},
    {"last": ((rows, D), bf16)}); no sequence dim, so never paged."""
    n_heads, dh, _ = _dims(cfg, tp)
    last = ((rows, cfg.d_model), LAST_DTYPE)
    return ({"state": ((rows, n_heads // tp, dh, dh), STATE_DTYPE),
             "last": last}, {"last": last})

"""Mamba-1 selective-scan mixer (port of ``repro.models.mamba``): Jamba's SSM
layers, TP over channels.

TP mapping (the reference's): the in-projections are column-parallel (the
``attn_ag`` seam, one shared gather for ``w_in_x`` / ``w_in_z``, or the
packed per-device ``w_in_xz``), the causal depthwise conv and the selective
scan are channel-local, the x-projection ``w_x`` is row-parallel (the
``decode_ar`` seam: a GEMM and an AllReduce, since B, C and dt are shared
by every channel shard; the full sequence in both layouts) and the output
projection ``w_out`` is row-parallel (the ``attn_rs`` seam).  The scan
itself exchanges nothing.

The scan (``selective_scan``) is chunked, as the reference's: a loop over
sequence chunks carries the fp32 state [B, C_loc, N]; within a chunk a
log-depth inclusive scan (the reference's ``associative_scan`` combine
``(a1 a2, b1 a2 + b2)``, in Hillis-Steele rounds) gives every position's
state, and the chunk's [B, L, C_loc, N] tensors are freed before the next
chunk.  The reference computes it in ``jnp`` outside any Pallas kernel, so
it is plain PyTorch here on both devices.

Under grad the scan is an autograd Function (``_SelectiveScan``) that
keeps no per-position state: it saves its inputs and the state carried
into each chunk, and its backward walks the chunks last first, re-runs
each chunk's forward from its carried state and runs the adjoint
recurrence (the same linear recurrence, reversed) in log-depth rounds.
Autograd through the log-depth scan itself would keep every round's
[B, L, C_loc, N] tensors (about three a round, 8 rounds a 256-position
chunk: 26 GB a layer by that count at Jamba's full width and 2 x 1024
tokens); the reference lets XLA's ``lax.scan`` save what it chooses.

``mamba_train`` is the training forward and the prefill (and the chunked
prefill, from a carried-in ``cache``).  ``mamba_decode`` is the O(1)
single-token state update, forward only (the reference's serving
path).  The recurrent state is
``{"conv": [B, d_conv - 1, C_loc] bf16, "ssm": [B, C_loc, N] fp32}``
(``mamba_cache_shapes``, the serving caches' specs): the conv tail holds
the last d_conv - 1 pre-conv projected inputs.  ``mamba_train`` returns
it in the compute dtype, as the reference does (bf16 when serving at
bf16); a cache it is stored into keeps its own dtype.
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
    "mamba_decode is the serving step and runs forward only, as the "
    "reference's; train through mamba_train")
CONV_DTYPE = torch.bfloat16          # the conv tail's cache dtype


def _dims(cfg: ModelConfig, tp: int) -> Tuple[int, int, int, int]:
    """(d_in padded to a multiple of tp * 128, dt_rank, d_state, d_conv)."""
    mc = cfg.mamba
    d_in = ceil_mult(mc.expand * cfg.d_model, tp * 128)
    dt_rank = mc.dt_rank or max(cfg.d_model // 16, 8)
    return d_in, dt_rank, mc.d_state, mc.d_conv


def init_mamba(gen: torch.Generator, cfg: ModelConfig, tp: int,
               dtype: torch.dtype, device: torch.device,
               fuse_xz: bool = False) -> Dict[str, torch.Tensor]:
    """The reference's leaves, packing and zero padding (padded channels
    are zero in every weight, so padding never changes the function):
    ``w_in_x`` / ``w_in_z`` [D, d_in] (or ``w_in_xz`` packed per device
    with ``fuse_xz``), ``conv`` [d_conv, d_in], ``conv_b``, ``w_x`` [d_in,
    dt_rank + 2N], ``w_dt`` [dt_rank, d_in], ``dt_bias`` (softplus^-1 of
    0.01, in ``dtype``), ``a_log`` [d_in, N] and ``d_skip`` in fp32
    whatever ``dtype``, ``w_out`` [d_in, D], ``norm``."""
    d_in, dt_rank, d_state, d_conv = _dims(cfg, tp)
    dm = cfg.d_model
    d_can = cfg.mamba.expand * dm             # canonical channel count

    def normal(*shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    w_in_x = iu.zero_pad_cols(normal(dm, d_can, scale=dm ** -0.5),
                              d_in).to(dtype)
    w_in_z = iu.zero_pad_cols(normal(dm, d_can, scale=dm ** -0.5),
                              d_in).to(dtype)
    inproj = ({"w_in_xz": iu.pack_pair(w_in_x, w_in_z, tp)} if fuse_xz
              else {"w_in_x": w_in_x, "w_in_z": w_in_z})
    n = torch.arange(1, d_state + 1, dtype=torch.float32, device=device)
    return {
        **inproj,
        "conv": iu.zero_pad_cols(normal(d_conv, d_can, scale=0.1),
                                 d_in).to(dtype),
        "conv_b": torch.zeros(d_in, dtype=dtype, device=device),
        "w_x": iu.zero_pad_rows(normal(d_can, dt_rank + 2 * d_state,
                                       scale=d_can ** -0.5), d_in).to(dtype),
        "w_dt": iu.zero_pad_cols(normal(dt_rank, d_can,
                                        scale=dt_rank ** -0.5),
                                 d_in).to(dtype),
        "dt_bias": torch.full((d_in,), -4.6, dtype=dtype, device=device),
        "a_log": torch.log(n).expand(d_in, d_state).contiguous(),
        "d_skip": torch.ones(d_in, dtype=torch.float32, device=device),
        "w_out": iu.zero_pad_rows(normal(d_can, dm, scale=d_can ** -0.5),
                                  d_in).to(dtype),
        "norm": torch.ones(dm, dtype=dtype, device=device),
    }


def _scan_rounds(coef: torch.Tensor, inp: torch.Tensor, h0: torch.Tensor,
                 reverse: bool = False) -> torch.Tensor:
    """The linear recurrence h_t = coef_t h_{t-1} + inp_t over dim 1 from
    h0, every position's h, in log-depth rounds in place (``coef`` and
    ``inp`` are consumed; the result lives in ``coef``'s storage).  The
    inclusive scan of the pairs (coef, inp) under the reference's
    combine (a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2): round d folds in
    the element d back, reading the values of the previous round.  With
    ``reverse`` the recurrence runs last position first (h_t = coef_t
    h_{t+1} + inp_t): the rounds of the flipped sequence, run right to
    left so nothing is copied."""
    n, d = coef.shape[1], 1
    while d < n:
        if reverse:
            inp[:, :-d] += inp[:, d:] * coef[:, :-d]
            coef[:, :-d] = coef[:, d:] * coef[:, :-d]
        else:
            inp[:, d:] += inp[:, :-d] * coef[:, d:]
            coef[:, d:] = coef[:, :-d] * coef[:, d:]
        d *= 2
    return coef.mul_(h0[:, None]).add_(inp)


def _scan_chunk(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, a: torch.Tensor, h0: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk: x, dt [B, L, C]; b, c [B, L, N]; a [C, N]; h0 [B, C, N]
    (fp32).  Returns (y [B, L, C], the state after the chunk)."""
    decay = torch.exp(dt[..., None] * a)                  # [B, L, C, N]
    inp = (dt * x)[..., None] * b[:, :, None, :]          # dt * x * B
    h = _scan_rounds(decay, inp, h0)                      # [B, L, C, N]
    del inp
    y = torch.matmul(h, c[..., None])[..., 0]             # sum over N
    return y, h[:, -1].clone()


def _chunk_len(s: int, chunk: int) -> int:
    """The reference's rule: the chunk halves until it divides S."""
    chunk = min(chunk, s)
    while s % chunk:
        chunk //= 2
    return chunk


def _chunk_backward(x, dt, b, c, a, h_in, dy, g_next):
    """One chunk's gradients from the state carried into it (``h_in``) and
    the cotangent of the state after it (``g_next``, the next chunk's
    ``dh_in``, or the final state's).  Re-runs the chunk's forward for
    every h_t, then the adjoint recurrence g_t = C_t dy_t + exp(dt_{t+1}
    a) g_{t+1} (g_{L-1} = C dy + g_next) in reversed log-depth rounds.
    Returns (dx, ddt, db, dc, da, dh_in)."""
    decay = torch.exp(dt[..., None] * a)                  # [B, L, C, N]
    dtx = dt * x
    inp = dtx[..., None] * b[:, :, None, :]
    h = _scan_rounds(decay.clone(), inp, h_in)            # every h_t
    del inp
    dc = torch.matmul(dy[:, :, None, :], h)[:, :, 0]      # sum over C
    # the adjoint: coef_t = exp(dt_{t+1} a), and 1 at the chunk's end,
    # where g_next enters
    coef = torch.empty_like(decay)
    coef[:, :-1] = decay[:, 1:]
    coef[:, -1] = 1.0
    u = dy[..., None] * c[:, :, None, :]                  # C_t dy_t
    g = _scan_rounds(coef, u, g_next, reverse=True)
    del u
    dh_in = decay[:, 0] * g[:, 0]
    db = torch.matmul(dtx[:, :, None, :], g)[:, :, 0]     # sum over C
    d_dtx = torch.matmul(g, b[..., None])[..., 0]         # sum over N
    # g_t exp(dt_t a) h_{t-1}: the state's part in d(dt_t a)
    q = g.mul_(decay)
    del decay
    q[:, 1:] *= h[:, :-1]
    q[:, 0] *= h_in
    del h
    da = torch.einsum("blcn,blc->cn", q, dt)
    ddt = d_dtx * x + torch.einsum("blcn,cn->blc", q, a)
    return d_dtx * dt, ddt, db, dc, da, dh_in


class _SelectiveScan(torch.autograd.Function):
    """The chunked scan whose backward recomputes each chunk.  The forward
    is the serving scan (the same chunk loop under no grad); it saves its
    inputs and the fp32 state carried into each chunk, [n_chunks, B, C,
    N], and no per-position state.  The backward walks the chunks last
    first, each from its carried state (``_chunk_backward``), so it holds
    one chunk's [B, L, C, N] tensors at a time."""

    @staticmethod
    def forward(ctx, x, dt, b, c, a, h0, chunk: int):
        s = x.shape[1]
        chunk = _chunk_len(s, chunk)
        ys, states, h = [], [], h0
        for i in range(0, s, chunk):
            sl = slice(i, i + chunk)
            states.append(h)
            y, h = _scan_chunk(x[:, sl], dt[:, sl], b[:, sl], c[:, sl], a,
                               h)
            ys.append(y)
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, b, c, a, h0, torch.stack(states))
        return torch.cat(ys, dim=1), h

    @staticmethod
    def backward(ctx, dy, dh_fin):
        x, dt, b, c, a, h0, states = ctx.saved_tensors
        chunk = ctx.chunk
        dx, ddt = torch.empty_like(x), torch.empty_like(dt)
        db, dc = torch.empty_like(b), torch.empty_like(c)
        da, g = torch.zeros_like(a), dh_fin
        for k in reversed(range(states.shape[0])):
            sl = slice(k * chunk, (k + 1) * chunk)
            (dx[:, sl], ddt[:, sl], db[:, sl], dc[:, sl], da_k,
             g) = _chunk_backward(x[:, sl], dt[:, sl], b[:, sl], c[:, sl],
                                  a, states[k], dy[:, sl], g)
            da += da_k
        return dx, ddt, db, dc, da, g, None


def selective_scan(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor, h0: torch.Tensor,
                   chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked selective scan: h_t = exp(dt_t a) h_{t-1} + dt_t x_t
    B_t, y_t = h_t . C_t.  x, dt [B, S, C]; b, c [B, S, N]; a [C, N]; h0
    [B, C, N]; all fp32.  The chunk halves until it divides S (the
    reference's rule).  Returns (y [B, S, C], the final state); under
    grad its backward recomputes each chunk (``_SelectiveScan``)."""
    return _SelectiveScan.apply(x, dt, b, c, a, h0, chunk)


def _refuse_grad(p: Dict, x: torch.Tensor) -> None:
    if torch.is_grad_enabled() and (x.requires_grad or any(
            t.requires_grad for t in p.values())):
        raise NotImplementedError(DECODE_NO_GRAD)


def _in_proj(p: Dict, h: torch.Tensor, ctx: TPContext
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, z) of the in-projections over the ``attn_ag`` seam: the packed
    ``w_in_xz`` (this rank's block is [x | z]) or one shared gather of
    ``w_in_x`` and ``w_in_z`` (the z gate applies after the scan, so no
    epilogue)."""
    if "w_in_xz" in p:
        return torch.chunk(ctx.op("attn_ag")(h, p["w_in_xz"]), 2, dim=-1)
    return ctx.op("attn_ag", n_weights=2)(h, p["w_in_x"], p["w_in_z"])


def _dt(p: Dict, dt_low: torch.Tensor) -> torch.Tensor:
    """softplus(dt_low @ w_dt + dt_bias) in fp32."""
    return F.softplus(torch.matmul(dt_low, p["w_dt"])
                      + p["dt_bias"].float())


def mamba_train(p: Dict, x: torch.Tensor, ctx: TPContext, cfg: ModelConfig,
                chunk: int = 256, with_cache: bool = False,
                lengths: Optional[torch.Tensor] = None,
                cache: Optional[Dict[str, torch.Tensor]] = None):
    """x: [B, S/TP, D] -> [B, S/TP, D] (the replicated layout: [B, S, D],
    the same seams in their hidden form); the conv and the scan see the
    full sequence either way.

    ``lengths`` ([B], optional): each row's true prompt length in a
    right-padded batch.  Pad positions get dt = 0: decay exp(0) = 1 and no
    input leave the state unchanged, so the returned ``ssm`` is the state
    after each row's own prompt, and the ``conv`` tail is sliced per row
    at its own length (a prompt shorter than d_conv - 1 takes the leading
    zeros, as a token-by-token decode would).  Outputs at pad positions
    are not meaningful.

    ``cache`` ({conv, ssm}, optional): the state at position 0, which
    seeds a chunk of the chunked prefill (the replicated layout only: the
    chunk is sequence-local).  Under grad this is the training forward:
    the scan's backward recomputes each chunk (``selective_scan``)."""
    d_in, dt_rank, d_state, d_conv = _dims(cfg, ctx.tp)
    b, s_loc, _ = x.shape
    s = s_loc * ctx.seq_factor
    if cache is not None and ctx.seq_sharded and ctx.tp > 1:
        raise ValueError("a carried-in Mamba state needs the replicated "
                         "layout (ctx.with_layout(False))")

    h = layers.rms_norm(x, p["norm"], cfg.norm_eps)
    xs_raw, z = _in_proj(p, h, ctx)                        # [B, S, C_loc]

    # causal depthwise conv along the (gathered) sequence; a carried-in
    # cache takes the place of the leading zero pad
    if cache is None:
        xpad = F.pad(xs_raw, (0, 0, d_conv - 1, 0))
    else:
        xpad = torch.cat([cache["conv"].to(xs_raw.dtype), xs_raw], dim=1)
    conv = sum(xpad[:, i:i + s] * p["conv"][i] for i in range(d_conv))
    # the conv's output feeds the x_proj seam and the scan: cut on the
    # seam tape, so the backward walks the conv's segment once
    xs = overlap.cut(F.silu(conv + p["conv_b"]), ctx.tape_axis)

    # x_proj: row-parallel GEMM + AllReduce (B, C, dt shared by the shards)
    xdb = ctx.op("decode_ar")(xs, p["w_x"])
    dt_low, b_in, c_in = torch.split(xdb, [dt_rank, d_state, d_state],
                                     dim=-1)
    dt = _dt(p, dt_low)
    if lengths is not None:
        in_prompt = (torch.arange(s, device=x.device)[None, :]
                     < lengths.to(x.device)[:, None])
        dt = torch.where(in_prompt[..., None], dt, torch.zeros_like(dt))
    a = -torch.exp(p["a_log"])                             # [C_loc, N]
    h0 = (torch.zeros((b, d_in // ctx.tp, d_state), dtype=torch.float32,
                      device=x.device) if cache is None
          else cache["ssm"].float())
    xs32 = xs.float()
    y, hfin = selective_scan(xs32, dt, b_in.float(), c_in.float(), a, h0,
                             chunk)
    y = y + xs32 * p["d_skip"]
    y = (y * F.silu(z.float())).to(x.dtype)
    out = ctx.op("attn_rs")(y, p["w_out"])
    if not with_cache:
        return out
    # the conv state: the last d_conv - 1 pre-conv inputs before each
    # row's length (xpad row t + d_conv - 1 is input t)
    ends = (torch.full((b,), s, device=x.device) if lengths is None
            else lengths.to(x.device).long())
    idx = ends[:, None] + torch.arange(d_conv - 1, device=x.device)
    tail = xpad[torch.arange(b, device=x.device)[:, None], idx]
    return out, {"conv": tail.to(x.dtype), "ssm": hfin}


def mamba_decode(p: Dict, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 pos: torch.Tensor, ctx: TPContext, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The single-token state update, O(1) in the sequence length.  x: [B,
    1, D]; cache {conv: [B, d_conv - 1, C_loc], ssm: [B, C_loc, N]}, read
    and left as it is (``pos`` is unused: the state carries the position).
    The in-projections are local (replicated layout); ``w_x`` and
    ``w_out`` run on the ``decode_ar`` seam.  Returns (out [B, 1, D], the
    new state, conv in the cache's dtype)."""
    _refuse_grad(p, x)
    _, dt_rank, d_state, _ = _dims(cfg, ctx.tp)
    h = layers.rms_norm(x, p["norm"], cfg.norm_eps)
    if "w_in_xz" in p:
        xs, z = torch.chunk(torch.matmul(h, p["w_in_xz"])[:, 0], 2, dim=-1)
    else:                                                  # local, no comm
        xs = torch.matmul(h, p["w_in_x"])[:, 0]
        z = torch.matmul(h, p["w_in_z"])[:, 0]             # [B, C_loc]

    hist = torch.cat([cache["conv"].to(xs.dtype), xs[:, None]], dim=1)
    xs = F.silu(torch.einsum("bkc,kc->bc", hist, p["conv"]) + p["conv_b"])

    ar = ctx.op("decode_ar")
    xdb = ar(xs[:, None], p["w_x"])[:, 0]
    dt_low, b_in, c_in = torch.split(xdb, [dt_rank, d_state, d_state],
                                     dim=-1)
    dt = _dt(p, dt_low)                                    # [B, C_loc]
    a = -torch.exp(p["a_log"])
    xs32 = xs.float()
    decay = torch.exp(dt[..., None] * a)
    hnew = (cache["ssm"].float() * decay
            + (dt * xs32)[..., None] * b_in.float()[:, None, :])
    y = torch.matmul(hnew, c_in.float()[..., None])[..., 0]
    y = y + xs32 * p["d_skip"]
    y = (y * F.silu(z.float())).to(x.dtype)[:, None]
    out = ar(y, p["w_out"])
    return out, {"conv": hist[:, 1:].to(cache["conv"].dtype), "ssm": hnew}


def mamba_cache_shapes(cfg: ModelConfig, tp: int, batch: int
                       ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """This rank's recurrent state: {"conv": ((B, d_conv - 1, C_loc),
    bf16), "ssm": ((B, C_loc, N), fp32)}; no sequence dim, so never
    paged."""
    d_in, _, d_state, d_conv = _dims(cfg, tp)
    return {"conv": ((batch, d_conv - 1, d_in // tp), CONV_DTYPE),
            "ssm": ((batch, d_in // tp, d_state), torch.float32)}

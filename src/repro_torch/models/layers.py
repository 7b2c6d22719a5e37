"""Shared layers (port of ``repro.models.layers``): norm, rotary embedding,
the vocab-parallel embedding lookup, the LM head (the ``head_ag`` seam)
and the vocab-parallel cross-entropy, sequence positions and token
shifts, and the per-slot / paged KV-cache utilities.

The cache writers update their cache IN PLACE and return it: the reference
is functional and its server donates the cache buffers to ``jit``
(``donate_argnums``), which is the same reuse of memory spelled for an
eager framework.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import overlap
from repro_torch.parallel.sharding import TPContext


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """Normalise in fp32, cast back to ``x.dtype``, THEN scale by gamma (the
    reference's order)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [B, S, H, Dh]; positions: [B, S] absolute token positions.
    Rotate-half (split into halves, not interleaved), in fp32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # [Dh/2]
    ang = positions[..., None].float() * freqs                  # [B,S,Dh/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 ctx: Optional[TPContext] = None) -> torch.Tensor:
    """Megatron vocab-parallel embedding.  table: [V/TP, D] this rank's
    shard; tokens: [B, S], the same on every rank.  Out-of-shard ids
    contribute 0; at tp>1 the ranks' partials combine through
    ``ctx.scatter_seq``: a ReduceScatter along the sequence, which produces
    the sequence-sharded activation [B, S/TP, D] directly, or in the
    replicated layout a psum, [B, S, D] on every rank."""
    v_loc = table.shape[0]
    local = tokens - (ctx.tp_index() * v_loc if ctx is not None else 0)
    in_shard = (local >= 0) & (local < v_loc)
    x = table[local.clamp(0, v_loc - 1)]
    x = x.masked_fill(~in_shard[..., None], 0)
    if ctx is not None and ctx.tp > 1:
        x = ctx.scatter_seq(x, "head_ag")
    return x


def lm_head_logits(x: torch.Tensor, table: torch.Tensor,
                   ctx: TPContext) -> torch.Tensor:
    """x: [B, S/TP, D] -> logits [B, S, V/TP] through the ``head_ag``
    AllGather-GEMM seam over the tied table's transpose (the step's
    biggest GEMM); in the replicated layout x is [B, S, D] and the seam
    is the local GEMM."""
    return ctx.op("head_ag")(x, table.t())


def vocab_parallel_xent(logits: torch.Tensor, labels: torch.Tensor,
                        ctx: TPContext, vocab_global: int,
                        vocab_real: Optional[int] = None) -> torch.Tensor:
    """Cross-entropy over vocab-sharded logits [B, S, V/TP] with labels
    [B, S] (full sequence): the Megatron vocab-parallel log-softmax (pmax
    of the max, psum of the exp-sums and of the target logit over the TP
    ranks).  Returns the per-token loss [B, S].  ``vocab_real`` masks the
    padded vocab tail out of the partition function.  The max is a
    stability shift with no gradient (stopped before the pmax, as the
    reference); the two psums ride one exchange."""
    v_loc = logits.shape[-1]
    lf = logits.float()
    start = ctx.tp_index() * v_loc
    if vocab_real is not None and vocab_real < vocab_global:
        col = start + torch.arange(v_loc, device=logits.device)
        lf = lf.masked_fill(col >= vocab_real, -1e30)
    axis = ctx.axis
    mx = overlap.pmax(lf.detach().amax(dim=-1, keepdim=True), axis)
    denom = torch.exp(lf - mx).sum(dim=-1)
    local = labels.long() - start
    in_shard = (local >= 0) & (local < v_loc)
    tgt = torch.gather(lf, -1, local.clamp(0, v_loc - 1)[..., None])[..., 0]
    tgt = tgt.masked_fill(~in_shard, 0.0)
    if axis is not None:
        denom, tgt = overlap.psum(torch.stack([denom, tgt]), axis).unbind(0)
    return torch.log(denom) + mx[..., 0] - tgt


def shift_tokens_right(x: torch.Tensor, ctx: TPContext) -> torch.Tensor:
    """x_{t-1} for a (possibly sequence-sharded) [B, S_local, D] tensor
    (zero at the start): shifts within the shard and pulls the boundary
    row from the left neighbour (one row through ``overlap.ppermute``).
    The replicated layout shifts locally."""
    if ctx.tp == 1 or not ctx.seq_sharded:
        return torch.nn.functional.pad(x, (0, 0, 1, 0))[:, :-1]
    n = ctx.tp
    prev = overlap.ppermute(x[:, -1:], ctx.axis,
                            [(i, (i + 1) % n) for i in range(n)])
    # rank 0's incoming row wrapped around: zeroed, but kept in the graph
    # (every rank takes part in the exchange's backward)
    first = torch.full((), ctx.tp_index() == 0, device=x.device)
    prev = torch.where(first, torch.zeros_like(prev), prev)
    return torch.cat([prev, x[:, :-1]], dim=1)


def shift_tokens_left(x: torch.Tensor, ctx: TPContext) -> torch.Tensor:
    """x_{t+1} for a (possibly sequence-sharded) [B, S_local, D] tensor
    (zero at the end); the boundary row comes from the right neighbour."""
    if ctx.tp == 1 or not ctx.seq_sharded:
        return torch.nn.functional.pad(x, (0, 0, 0, 1))[:, 1:]
    n = ctx.tp
    nxt = overlap.ppermute(x[:, :1], ctx.axis,
                           [(i, (i - 1) % n) for i in range(n)])
    last = torch.full((), ctx.tp_index() == n - 1, device=x.device)
    nxt = torch.where(last, torch.zeros_like(nxt), nxt)
    return torch.cat([x[:, 1:], nxt], dim=1)


def seq_positions(batch: int, s_local: int, device: torch.device,
                  offset: int = 0,
                  ctx: Optional[TPContext] = None) -> torch.Tensor:
    """Absolute positions of this rank's sequence rows: [B, S_local].  The
    sequence-sharded layout adds the shard offset ``tp_index * s_local``;
    the replicated layout's local rows ARE the global rows."""
    if ctx is not None and ctx.seq_sharded:
        offset = offset + ctx.tp_index() * s_local
    pos = offset + torch.arange(s_local, device=device)
    return pos.expand(batch, s_local)


def cache_update_rows(cache: torch.Tensor, new: torch.Tensor,
                      pos: torch.Tensor) -> torch.Tensor:
    """Per-row KV-cache write ``cache[b, pos[b]:pos[b]+L] = new[b]``, in
    place.  cache: [B, S_max, ...]; new: [B, L, ...]; pos: [B] int.  A start
    past ``S_max - L`` clamps, as ``lax.dynamic_update_slice`` does."""
    b, l = new.shape[0], new.shape[1]
    start = pos.long().clamp(0, cache.shape[1] - l)
    rows = start[:, None] + torch.arange(l, device=cache.device)
    bidx = torch.arange(b, device=cache.device)[:, None]
    cache[bidx, rows] = new.to(cache.dtype)
    return cache


def pool_update_rows(pool: torch.Tensor, new: torch.Tensor, bt: torch.Tensor,
                     start: torch.Tensor,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paged KV write THROUGH a block table, in place.

    pool: [N_blocks, bs, ...]; new: [B, L, ...]; bt: [B, P] per-row block
    tables; start: [B] logical write offsets.  Rows with i >= valid[b] are
    padding and land in physical block 0, the reserved null block (never
    read unmasked), so duplicate writes there are harmless."""
    n_blocks, bs = pool.shape[0], pool.shape[1]
    b, l = new.shape[0], new.shape[1]
    ar = torch.arange(l, device=pool.device)
    logical = start.long()[:, None] + ar                            # [B, L]
    blk = torch.gather(bt.long(), 1,
                       torch.clamp(logical // bs, 0, bt.shape[1] - 1))
    flat = blk * bs + logical % bs
    if valid is not None:
        ok = ar[None, :] < valid.long()[:, None]
        flat = torch.where(ok, flat, logical % bs)                  # null rows
    pool_flat = pool.view(n_blocks * bs, *pool.shape[2:])
    pool_flat[flat.reshape(-1)] = new.reshape(b * l, *new.shape[2:]).to(
        pool.dtype)
    return pool


def pool_view(pool: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """Each row's logical K/V timeline through its block table:
    pool [N_blocks, bs, ...], bt [B, P] -> [B, P*bs, ...].  Positions past a
    row's length are stale or null rows the caller masks."""
    g = pool[bt.long()]                                   # [B, P, bs, ...]
    return g.reshape(bt.shape[0], bt.shape[1] * pool.shape[1],
                     *pool.shape[2:])


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-row gather ``x[b, idx[b]]`` with idx clamped into range:
    x [B, S, ...], idx [B] -> [B, ...]."""
    idx = idx.long().clamp(0, x.shape[1] - 1)
    return x[torch.arange(x.shape[0], device=x.device), idx]

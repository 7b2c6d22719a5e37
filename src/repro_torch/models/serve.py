"""Serving paths (port of ``repro.models.serve``): batched prefill, dense and
paged single-token decode, and the paged chunked prefill.  At tp>1 each runs
as one rank of a ``dist.RankGroup`` (one call per rank inside
``group.spmd``) on that rank's ``model.shard_params`` copy and its own
caches of its local KV heads, and every rank returns the same next tokens.
On a ``dist.RankMesh`` (dp, pods or ep > 1: ``make_ctx(par, mesh=)``) each
rank runs its rows of the batch (``dp_rows``) on its ``model.mesh_shard``
copy; under ZeRO-3 (the context's ``zero3``) each layer gathers its
ZeRO-3 leaves right before it runs and frees them right after, and the
MoE layers reach experts over a dedicated ep axis or ``ep_over_dp``
through the context's ``ep_group``.
Prefill runs the context's layout (sequence-sharded, or replicated under
``ctx.with_layout(False)``); decode and the chunked prefill always run the
replicated layout, whose row-parallel seams are AllReduces (``kind="ar"``).

Caches are a list with one dict per layer (expanded-pattern order): GQA
``{"k", "v"}`` shaped [B, S_max, Hkv, Dh] by ``cache_specs`` or
[N_blocks, block_size, Hkv, Dh] by ``paged_cache_specs``; MLA's latent
``{"c", "kr"}`` shaped [B, S_max, R] / [B, S_max, Dr] or their pools; both
bf16.  A Mamba layer's recurrent state ``{"conv", "ssm"}`` (bf16 [B,
d_conv - 1, C_loc] and fp32 [B, C_loc, N], ``mamba.mamba_cache_shapes``)
and an RWKV layer's (the time-mix's ``{"state", "last"}``, fp32 [B, hl,
dh, dh] and bf16 [B, D], and the channel-mix's ``last``,
``rwkv.rwkv_cache_shapes``) have no sequence dim: they stay dense per
slot, [max_batch, ...], in the paged caches too.

A layer's cache is ONE flat dict for every family: its mixer's leaves
under their own names and, for an FFN that carries state (the RWKV
channel-mix), the FFN's leaves under ``"ffn." + name`` (``FFN_PREFIX``;
the reference nests them as ``{"mixer": ..., "ffn": ...}``).  So an RWKV
layer's cache is ``{"state", "last", "ffn.last"}``; a dense or MoE FFN
adds nothing.
``decode_step`` and ``prefill_chunk_step`` write their caches IN PLACE and
return them — the reference's server donates the cache buffers to
``jit`` for the same reuse.

Contracts kept from the reference:

* ``decode_step`` takes ``pos: [B]`` — each row RoPE-rotates at, masks to
  and writes at its own position (a scalar broadcasts).  ``active: [B]``
  keeps inactive rows of DENSE caches unchanged: a dense KV cache's row at
  its position, and a recurrent layer's whole state rows (Mamba's conv
  and ssm; RWKV's state, last and ffn.last), whether or not the KV caches
  are paged (the reference's ``_freeze_inactive``: a slot
  between chunks of its chunked prefill must not see the interleaved
  decodes advance its state); paged pools need no mask (inactive slots
  pass all-zero table rows, which write the null block).
* ``prefill_step`` takes optional ``lengths: [B]`` — true prompt lengths of
  a right-padded batch: attention is pad-safe by causality, MoE routing
  keeps pad tokens out of expert capacity, a Mamba layer freezes its state
  at each row's length (dt = 0 on pad positions), an RWKV layer its wkv
  state (k = 0 and logw = 0 on pad positions) and both token-shift rows
  (each row's last true token), and the next token is
  read at ``lengths - 1`` per row.
* ``prefill_chunk_step`` takes the request's ``slot``: a recurrent layer
  (Mamba; RWKV's time-mix and channel-mix) reads the slot's state rows
  (zeroed on the first chunk, ``off == 0``, so a freed slot's state never
  leaks into the next request), runs the chunk with chunk-relative
  lengths and writes the rows back.
* the next token is the first maximum of the logits against the tied
  ``embed`` table, with the padded vocab columns masked to -inf.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import (ATTN, DENSE_FFN, MAMBA, MLA, MOE_FFN,
                                      RWKV, ModelConfig, ParallelConfig)
from repro_torch.models import attention, ffn, layers, mamba, rwkv
from repro_torch.models.model import (Model, check_ported, expanded_pattern,
                                      layer_slot, zero3_layers)
from repro_torch.parallel.sharding import TPContext, gather_ranks

Caches = List[Dict[str, torch.Tensor]]
# a layer cache's FFN leaves (the RWKV channel-mix's ``last``)
FFN_PREFIX = "ffn."


class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _specs(shapes) -> Dict[str, TensorSpec]:
    return {n: TensorSpec(shape, dtype) for n, (shape, dtype) in
            shapes.items()}


def _layer_cache_specs(kinds: Tuple[str, str], cfg: ModelConfig, tp: int,
                       rows: int, pool: Optional[Tuple[int, int]],
                       s_max: int) -> Dict[str, TensorSpec]:
    """One layer's cache specs (the module docstring's flat layout): the
    attention families' (bf16) dense [rows, s_max, ...] or, with
    ``pool``, [num_blocks, block_size, ...]; a recurrent layer's state
    [rows, ...] either way, each leaf its own dtype, an RWKV channel-mix's
    under ``FFN_PREFIX``."""
    kind = kinds[0]
    if kind == MAMBA:
        return _specs(mamba.mamba_cache_shapes(cfg, tp, rows))
    if kind == RWKV:       # its FFN is the channel-mix (``check_ported``)
        time, channel = rwkv.rwkv_cache_shapes(cfg, tp, rows)
        return {**_specs(time), **{FFN_PREFIX + n: s for n, s in
                                   _specs(channel).items()}}
    n_rows, width = pool if pool is not None else (rows, s_max)
    if kind == ATTN:
        shape = attention.gqa_cache_shape(cfg, tp, n_rows, width)
        shapes = {"k": shape, "v": shape}
    elif kind == MLA:
        shapes = attention.mla_cache_shapes(cfg, n_rows, width)
    else:
        raise ValueError(kind)
    return {n: TensorSpec(shape, torch.bfloat16)
            for n, shape in shapes.items()}


# the mesh axes the batched serve steps split their batch over, outermost
# first (``launch.mesh.dp_axes``'s order)
DP_AXES = ("pod", "ep", "data")


def _dp_sizes(par: ParallelConfig) -> Dict[str, int]:
    return {"pod": par.pods, "ep": par.ep, "data": par.dp}


def dp_rows(par: ParallelConfig, batch: int, coords: Dict[str, int]
            ) -> slice:
    """The rows of a ``batch``-row batch that the mesh rank at ``coords``
    (``launch.mesh.mesh_coords``) runs: the batch split over
    ``DP_AXES``, outermost first."""
    sizes = _dp_sizes(par)
    i, n = 0, 1
    for a in DP_AXES:
        i, n = i * sizes[a] + coords.get(a, 0), n * sizes[a]
    if batch % n:
        raise ValueError(f"a batch of {batch} rows does not split over "
                         f"{n} data-parallel ranks")
    return slice(i * batch // n, (i + 1) * batch // n)


def cache_specs(cfg: ModelConfig, par: ParallelConfig, batch: int, s_max: int,
                pool: Optional[Tuple[int, int]] = None,
                dp_axes: Tuple[str, ...] = DP_AXES
                ) -> List[Dict[str, TensorSpec]]:
    """One rank's per-layer cache specs (GQA ``{"k", "v"}`` of its local KV
    heads, MLA ``{"c", "kr"}``, Mamba ``{"conv", "ssm"}`` of its channels,
    RWKV ``{"state", "last", "ffn.last"}`` of its heads):
    dense [rows, s_max, ...], the rows its piece of ``batch`` split over
    ``dp_axes`` (the reference's ``cache_specs(dp_axes=)``), or with
    ``pool=(num_blocks, block_size)`` the attention families' shared
    [num_blocks, block_size, ...] pools addressed through per-slot block
    tables.  The attention caches are bf16 whatever the compute dtype; a
    recurrent layer's state is per row in both layouts, Mamba's conv bf16
    and ssm fp32, RWKV's state fp32 and both ``last`` rows bf16."""
    check_ported(cfg)
    ranks = math.prod(_dp_sizes(par)[a] for a in dp_axes)
    if batch % ranks:
        raise ValueError(f"a batch of {batch} rows does not split over "
                         f"{dp_axes} ({ranks} ranks)")
    return [_layer_cache_specs(kinds, cfg, par.tp, batch // ranks, pool,
                               s_max)
            for kinds in expanded_pattern(cfg)]


def paged_cache_specs(cfg: ModelConfig, par: ParallelConfig, num_blocks: int,
                      block_size: int, max_batch: int
                      ) -> List[Dict[str, TensorSpec]]:
    """Cache specs for the paged serving runtime (see ``cache_specs``):
    per replica, with no dp axis (each replica's pools hold every slot;
    the Server's replicas serve the same requests); a recurrent layer's
    state is dense [max_batch, ...], nothing of it paged."""
    return cache_specs(cfg, par, max_batch, 0, pool=(num_blocks, block_size),
                       dp_axes=())


def zeros_from_specs(specs: List[Dict[str, TensorSpec]],
                     device: torch.device) -> Caches:
    return [{n: torch.zeros(s.shape, dtype=s.dtype, device=device)
             for n, s in layer.items()} for layer in specs]


def _compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def vocab_parallel_argmax(logits: torch.Tensor, vocab_real: int,
                          ctx: Optional[TPContext] = None) -> torch.Tensor:
    """Greedy sampling over this rank's vocab shard of the logits [B,
    V_pad/TP] -> [B] global ids (first maximum; the padded vocab tail,
    columns >= ``vocab_real``, is masked with -inf).  At tp>1 every rank's
    best (value, id) pair crosses by ``gather_ranks`` and the first rank
    holding the maximum wins, so all ranks agree."""
    v_loc = logits.shape[-1]
    start = ctx.tp_index() * v_loc if ctx is not None else 0
    if vocab_real < start + v_loc:
        col = start + torch.arange(v_loc, device=logits.device)
        logits = logits.masked_fill(col >= vocab_real, float("-inf"))
    loc_idx = torch.argmax(logits, dim=-1)
    if ctx is None or ctx.tp == 1:
        return loc_idx
    loc_val = torch.gather(logits, -1, loc_idx[:, None])[:, 0]
    vals = gather_ranks(loc_val, ctx.group)                 # [B, TP]
    idxs = gather_ranks(loc_idx + start, ctx.group)         # [B, TP]
    best = torch.argmax(vals, dim=-1)
    return torch.gather(idxs, -1, best[:, None])[:, 0]


def _mixer_prefill(kind: str, p, x, ctx: TPContext, cfg: ModelConfig,
                   lengths: Optional[torch.Tensor]):
    if kind == ATTN:
        # the causal mask keeps rows < length independent of the padding
        return attention.gqa_train(p, x, ctx, cfg, with_cache=True)
    if kind == MAMBA:
        return mamba.mamba_train(p, x, ctx, cfg, with_cache=True,
                                 lengths=lengths)
    if kind == RWKV:
        return rwkv.rwkv_time_train(p, x, ctx, cfg, with_cache=True,
                                    lengths=lengths)
    return attention.mla_train(p, x, ctx, cfg, with_cache=True)


def _ffn_prefill(kind: str, p, x, ctx: TPContext, cfg: ModelConfig,
                 lengths: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The FFN over a prefill batch: (its output, its state: the RWKV
    channel-mix's ``{"last"}``, else empty); ``lengths`` keeps MoE pad
    tokens out of expert capacity and gives each RWKV row its last
    token."""
    if kind == DENSE_FFN:
        return ffn.ffn_train(p, x, ctx, cfg.norm_eps), {}
    if kind == RWKV:
        return rwkv.rwkv_channel_train(p, x, ctx, cfg, with_cache=True,
                                       lengths=lengths)
    return ffn.moe_train(p, x, ctx, cfg, cfg.norm_eps,
                         lengths=lengths)[0], {}


def _mixer_part(cache: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A layer cache's mixer leaves (the same tensors)."""
    return {n: t for n, t in cache.items() if not n.startswith(FFN_PREFIX)}


def _ffn_part(cache: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A layer cache's FFN leaves by their own names (the same tensors)."""
    return {n[len(FFN_PREFIX):]: t for n, t in cache.items()
            if n.startswith(FFN_PREFIX)}


def _layer_cache(mixer: Dict[str, torch.Tensor],
                 ffn_state: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """One layer's flat cache from its mixer's and its FFN's leaves."""
    return {**mixer, **{FFN_PREFIX + n: t for n, t in ffn_state.items()}}


@torch.no_grad()
def prefill_logits(params: Model, batch: Dict[str, torch.Tensor],
                   ctx: TPContext, cfg: ModelConfig,
                   lengths: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Caches]:
    """Full-sequence prefill up to the logits of each row's last true
    position: returns (logits [B, V_pad / TP], caches).  At tp>1 it runs
    as one rank of ``ctx.group`` (inside ``group.spmd``) on that rank's
    ``model.shard_params`` copy, in ``ctx``'s layout (a Mamba layer's
    conv and scan see the whole sequence, gathered by its in-projection's
    seam).  Sequence-sharded:
    the embedding's ReduceScatter produces [B, S/TP, D], every seam runs
    on each seam's plan transport, and ``gather_seq`` brings the last rows
    back.  Replicated: the embedding's psum gives every rank [B, S, D],
    the column-parallel GEMMs are local and the row-parallel ones
    AllReduce.  The logits are this rank's vocab shard and the caches its
    KV heads.  On a mesh (``make_ctx(par, mesh=)``) each rank runs its
    rows of the batch (``dp_rows``); under the context's ``zero3`` each
    layer's ZeRO-3 leaves are gathered over the data group right before
    it and freed right after (``model.zero3_layers``)."""
    check_ported(cfg)
    x = layers.embed_lookup(params.embed, batch["tokens"], ctx)
    x = x.to(_compute_dtype(cfg))
    if lengths is not None:
        lengths = lengths.to(x.device)
    caches: Caches = []
    for i, ((mk, fk), blk, z3) in enumerate(zip(
            expanded_pattern(cfg), params.layers,
            zero3_layers(cfg, ctx))):
        lctx = ctx.with_layer(layer_slot(cfg, i))
        mixer, ffn_p = _weights(blk, z3)
        dy, mc = _mixer_prefill(mk, mixer, x, lctx, cfg, lengths)
        x = x + dy
        dy, fc = _ffn_prefill(fk, ffn_p, x, lctx, cfg, lengths)
        x = x + dy
        _release(z3)
        caches.append(_layer_cache(mc, fc))
    h = layers.rms_norm(x, params.final_norm, cfg.norm_eps)
    # only each row's LAST true position feeds the next token
    if lengths is None:
        h_last = ctx.gather_seq(h[:, -1:], "head_ag")[:, -1]
    else:
        h_last = layers.take_rows(ctx.gather_seq(h, "head_ag"), lengths - 1)
    return torch.matmul(h_last, params.embed.T), caches


def prefill_step(params: Model, batch: Dict[str, torch.Tensor],
                 ctx: TPContext, cfg: ModelConfig,
                 lengths: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Caches]:
    """Full-sequence prefill: returns (next_token [B, 1], caches).  With
    ``ctx.use_kernels`` every GQA layer's attention is the flash kernel
    (MLA prefill attends in plain code, as the reference does); at tp>1
    see ``prefill_logits``: every rank returns the same next tokens."""
    logits, caches = prefill_logits(params, batch, ctx, cfg, lengths)
    return vocab_parallel_argmax(logits, cfg.vocab_size, ctx)[:, None], caches


def _weights(blk, z3) -> Tuple:
    """A layer's (mixer, ffn) leaves, its ZeRO-3 leaves gathered."""
    return (blk.mixer, blk.ffn) if z3 is None else z3.gather(blk)


def _release(z3) -> None:
    if z3 is not None:
        z3.release()


def _mixer_decode(kind: str, p, x, cache, pos, ctx: TPContext,
                  cfg: ModelConfig, bt: Optional[torch.Tensor]):
    if kind == ATTN:
        if bt is not None:
            return attention.gqa_decode_paged(p, x, cache, bt, pos, ctx, cfg)
        return attention.gqa_decode(p, x, cache, pos, ctx, cfg)
    if bt is not None:
        return attention.mla_decode_paged(p, x, cache, bt, pos, ctx, cfg)
    return attention.mla_decode(p, x, cache, pos, ctx, cfg)


@torch.no_grad()
def decode_logits(params: Model, caches: Caches, tokens: torch.Tensor, pos,
                  ctx: TPContext, cfg: ModelConfig,
                  block_tables: Optional[torch.Tensor] = None,
                  active: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Caches]:
    """One decode step up to the logits: returns (logits [B, V_pad / TP],
    caches), the caches updated in place (see ``decode_step``)."""
    check_ported(cfg)
    dev = params.embed.device
    b = tokens.shape[0]
    pos = torch.as_tensor(pos, device=dev).reshape(-1).long().expand(b)
    # decode always runs the replicated layout: a one-token "sequence"
    # cannot shard, and its row-parallel seams are kind="ar"
    ctx = ctx.with_layout(False)
    x = layers.embed_lookup(params.embed, tokens, ctx)
    x = x.to(_compute_dtype(cfg))
    if active is not None:
        active = torch.as_tensor(active, device=dev).reshape(-1).bool()
    # a dense KV cache restores an inactive row's entry at its position;
    # paged pools need nothing (the null block)
    inactive = (~active if active is not None and block_tables is None
                else None)
    for i, ((mk, fk), blk, z3) in enumerate(zip(
            expanded_pattern(cfg), params.layers,
            zero3_layers(cfg, ctx))):
        lc = caches[i]
        lctx = ctx.with_layer(layer_slot(cfg, i))
        mixer, ffn_p = _weights(blk, z3)
        if mk in (MAMBA, RWKV):
            # the state rows of inactive slots stay as they were, paged or
            # not (the reference's _freeze_inactive)
            state = _mixer_part(lc)
            dy, new = (mamba.mamba_decode(mixer, x, state, pos, lctx, cfg)
                       if mk == MAMBA else
                       rwkv.rwkv_time_decode(mixer, x, state, lctx, cfg))
            _store_state(state, new, active)
        else:
            saved = _rows_at(lc, pos) if inactive is not None else None
            dy, _ = _mixer_decode(mk, mixer, x, lc, pos, lctx, cfg,
                                  block_tables)
            if saved is not None:
                _restore_rows(lc, pos, saved, inactive)
        x = x + dy
        if fk == DENSE_FFN:
            x = x + ffn.ffn_decode(ffn_p, x, lctx, cfg.norm_eps)
        elif fk == MOE_FFN:
            x = x + ffn.moe_decode(ffn_p, x, lctx, cfg, cfg.norm_eps)
        else:
            # the channel-mix's token-shift row, frozen as the mixer's
            state = _ffn_part(lc)
            dy, new = rwkv.rwkv_channel_decode(ffn_p, x, state, lctx, cfg)
            _store_state(state, new, active)
            x = x + dy
        _release(z3)
    h = layers.rms_norm(x, params.final_norm, cfg.norm_eps)
    # this rank's vocab shard of the logits
    return torch.matmul(h[:, -1], params.embed.T), caches


def decode_step(params: Model, caches: Caches, tokens: torch.Tensor, pos,
                ctx: TPContext, cfg: ModelConfig,
                block_tables: Optional[torch.Tensor] = None,
                active: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Caches]:
    """One greedy decode step.  tokens: [B, 1]; pos: [B] per-slot write
    positions (a scalar broadcasts).  With ``block_tables`` [B, pages] the
    caches are paged pools.  ``active`` [B] (optional) marks the
    generating rows: the others' dense cache entries and recurrent state
    rows (Mamba's, RWKV's time-mix and channel-mix) are left as they
    were.  With ``ctx.use_kernels`` every MLA layer's
    attention is the MLA-decode kernel.  At tp>1 each rank (inside
    ``group.spmd``) embeds through the vocab-parallel psum, attends over
    its local heads and writes its KV heads; every rank returns the same
    tokens.  ZeRO-3 as in ``prefill_logits``.  Returns (next_token [B,
    1], caches), the caches updated in place."""
    logits, caches = decode_logits(params, caches, tokens, pos, ctx, cfg,
                                   block_tables, active)
    return vocab_parallel_argmax(logits, cfg.vocab_size, ctx)[:, None], caches


def _rows_at(cache: Dict[str, torch.Tensor], pos: torch.Tensor):
    """Each row's cache entry at its (clamped) write position."""
    rows = torch.arange(pos.shape[0], device=pos.device)
    return {n: t[rows, pos.clamp(0, t.shape[1] - 1)].clone()
            for n, t in cache.items()}


def _restore_rows(cache: Dict[str, torch.Tensor], pos: torch.Tensor,
                  saved: Dict[str, torch.Tensor], inactive: torch.Tensor):
    """Undo the decode write of inactive rows (the reference's
    ``_freeze_inactive`` on a dense cache)."""
    rows = torch.arange(pos.shape[0], device=pos.device)[inactive]
    for n, t in cache.items():
        t[rows, pos[inactive].clamp(0, t.shape[1] - 1)] = saved[n][inactive]


def _store_state(cache: Dict[str, torch.Tensor],
                 new: Dict[str, torch.Tensor],
                 active: Optional[torch.Tensor]) -> None:
    """Write a recurrent layer's new state (a Mamba mixer's, an RWKV
    time-mix's or channel-mix's) into its cache rows in place: every row,
    or with ``active`` the active rows only (whole rows: the state has no
    position)."""
    for n, t in cache.items():
        v = new[n].to(t.dtype)
        if active is not None:
            v = torch.where(active.reshape(-1, *([1] * (t.dim() - 1))), v, t)
        t.copy_(v)


def _chunk_state(fn, p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 slot: Optional[int], first: bool, lenv: torch.Tensor,
                 ctx: TPContext, cfg: ModelConfig) -> torch.Tensor:
    """A recurrent block's chunk of the chunked prefill (``fn``: Mamba's
    ``mamba_train``, RWKV's ``rwkv_time_train`` or
    ``rwkv_channel_train``): the slot's state row (zeros on the request's
    first chunk), the chunk at its chunk-relative length (rows past it
    freeze the state as padding does), the new state written back into
    the row."""
    if slot is None:
        raise ValueError("a recurrent layer's chunked prefill needs the "
                         "request's slot (its dense state row)")
    row = slice(slot, slot + 1)
    st = {n: torch.zeros_like(t[row]) if first else t[row]
          for n, t in cache.items()}
    dy, new = fn(p, x, ctx, cfg, with_cache=True, lengths=lenv, cache=st)
    for n, t in cache.items():
        t[row] = new[n].to(t.dtype)
    return dy


@torch.no_grad()
def prefill_chunk_logits(params: Model, caches: Caches, tokens: torch.Tensor,
                         block_tables: torch.Tensor, off: int, chunk_len: int,
                         ctx: TPContext, cfg: ModelConfig,
                         slot: Optional[int] = None
                         ) -> Tuple[torch.Tensor, Caches]:
    """One chunk of the paged prefill up to the logits of its row
    ``chunk_len - 1``: returns (logits [1, V_pad / TP], caches), the
    caches updated in place (see ``prefill_chunk_step``)."""
    check_ported(cfg)
    first = off == 0
    # the chunked prefill always runs the replicated layout: a bounded
    # chunk has no sequence-parallel residency to win
    ctx = ctx.with_layout(False)
    x = layers.embed_lookup(params.embed, tokens, ctx)
    x = x.to(_compute_dtype(cfg))
    lenv = torch.full((x.shape[0],), chunk_len, device=x.device)
    for i, ((mk, fk), blk, z3) in enumerate(zip(
            expanded_pattern(cfg), params.layers,
            zero3_layers(cfg, ctx))):
        lctx = ctx.with_layer(layer_slot(cfg, i))
        mixer, ffn_p = _weights(blk, z3)
        if mk in (MAMBA, RWKV):
            fn = mamba.mamba_train if mk == MAMBA else rwkv.rwkv_time_train
            dy = _chunk_state(fn, mixer, x, _mixer_part(caches[i]), slot,
                              first, lenv, lctx, cfg)
        else:
            chunk = (attention.gqa_prefill_chunk if mk == ATTN
                     else attention.mla_prefill_chunk)
            dy, _ = chunk(mixer, x, caches[i], block_tables, off, chunk_len,
                          lctx, cfg)
        x = x + dy
        if fk == RWKV:
            dy = _chunk_state(rwkv.rwkv_channel_train, ffn_p, x,
                              _ffn_part(caches[i]), slot, first, lenv, lctx,
                              cfg)
        else:
            # MoE: rows past chunk_len are padding, kept out of expert
            # capacity
            dy = _ffn_prefill(fk, ffn_p, x, lctx, cfg, lenv)[0]
        x = x + dy
        _release(z3)
    h = layers.rms_norm(x, params.final_norm, cfg.norm_eps)
    last = torch.full((h.shape[0],), chunk_len - 1, device=h.device)
    return torch.matmul(layers.take_rows(h, last), params.embed.T), caches


def prefill_chunk_step(params: Model, caches: Caches, tokens: torch.Tensor,
                       block_tables: torch.Tensor, off: int, chunk_len: int,
                       ctx: TPContext, cfg: ModelConfig,
                       slot: Optional[int] = None
                       ) -> Tuple[torch.Tensor, Caches]:
    """One fixed-shape chunk of an incremental paged prefill: tokens [1, C]
    (right-padded past ``chunk_len``), written at logical offset ``off``
    through ``block_tables`` [1, pages].  A recurrent layer (Mamba; RWKV's
    time-mix and channel-mix) threads the request's dense state row
    ``slot`` across its chunks: zeroed on the first chunk (``off == 0``),
    read, and written back (attention-only models need no slot).  At tp>1
    it runs as one rank, as ``decode_step`` does.  Returns (next_token [1, 1] —
    meaningful on the final chunk only — and the caches, updated in
    place)."""
    logits, caches = prefill_chunk_logits(params, caches, tokens,
                                          block_tables, off, chunk_len, ctx,
                                          cfg, slot)
    return vocab_parallel_argmax(logits, cfg.vocab_size, ctx)[:, None], caches

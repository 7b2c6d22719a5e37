"""FFN blocks (port of ``repro.models.ffn``): dense SwiGLU and the routed
MoE, its experts split over the TP ranks.

``ffn_train`` runs the two TP seams: ``mlp_ag`` with the SwiGLU gate as its
epilogue (``gate="pair"`` over separate w1/w3, or ``gate="split"`` over the
packed per-device ``w13``) and ``mlp_rs`` for w2.  ``ffn_decode`` is the
one-token path with the ``decode_ar`` seam.

``moe_train`` routes in fp32 (softmax, top-k, renormalised gates), buckets
the (token, k) assignments by expert with a capacity, and runs the experts
in one of two ways, as the reference does.  Under the sequence-sharded
layout (and at tp=1) each rank routes its own shard with a per-shard
capacity and hands the ``[ep, E_loc, cap, D]`` dispatch buffer to ONE
``ctx.op("moe_a2a")`` seam: the exchange to the experts' ranks, the
batched expert SwiGLU, the exchange back.  Under the replicated layout
(the chunked prefill, the replicated prefill) every rank holds every token:
each buckets them in one global order, runs its local experts only, and a
psum over the group combines the ranks' contributions.  ``moe_decode``
does the same with the statistical decode capacity.  The EP group is
``ctx.ep_axis``: the TP group, or on a mesh a dedicated "ep" sub-group
or the ("data", "model") view under ``ep_over_dp``; rank r of it holds
experts ``[r * E_loc, (r + 1) * E_loc)``.  With experts over another
group the replicated layout's local-experts path first brings in the
other data ranks' tokens (``_ep_blocks``) and hands each rank its own
rows of the psum: serving (decode, the chunked prefill) runs it; under
grad it raises, as the reference's does (each rank's experts would see
every data shard's tokens, which breaks the per-shard grads).  Which
tokens a saturated expert evicts depends on the layout (per shard under
"seq", one global order otherwise); drop-free, the layouts agree.  A
shared expert, when configured, is a dense FFN on the same pre-norm.  The
reference's ``segment_sum`` combine is a sum over each token's k
contiguous assignments here (deterministic on the card, where an atomic
``index_add_`` would not be).

``dropped`` counts the assignments capacity evicted, keyed by the rank
whose experts lost them, for the lanes that must show none: zero it with
``dropped.clear()``, read it with ``drop_totals``.  A checkpointed
block's recompute (``overlap.remat``) counts nothing again.

Under grad at tp>1 every seam of ``moe_train`` records on the rank's
``SeamTape``: the aux loss's psums over the TP group and, at dp>1, over
the pod and data groups (each one's transpose is the psum of the
cotangent; at tp=1 and dp>1 these are the only seams, and the tape cuts
over the data group, ``TPContext.tape_axis``), the ``moe_a2a`` exchange (its backward, ``overlap._A2ASeam``)
or the local experts' psum, and the shared expert's ``mlp_ag`` /
``mlp_rs``.  The normed tokens and the router's probabilities each feed
two of them, so both are cut on the tape (``overlap.cut``), as the model
cuts its residual stream.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core import overlap
from repro_torch.models import init_utils as iu
from repro_torch.models import layers
from repro_torch.parallel.sharding import TPContext, pad_ff


def init_ffn(gen: torch.Generator, d_model: int, d_ff: int, tp: int,
             dtype: torch.dtype, device: torch.device,
             fuse13: bool = False) -> Dict[str, torch.Tensor]:
    """d_ff zero-padded to the TP-aligned width (silu(0)*0 @ 0-rows adds
    nothing).  ``fuse13`` packs w1|w3 into one per-device-interleaved w13."""
    ffp = pad_ff(d_ff, tp)
    std = d_model ** -0.5

    def normal(*shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    w1 = iu.zero_pad_cols(normal(d_model, d_ff, scale=std), ffp).to(dtype)
    w3 = iu.zero_pad_cols(normal(d_model, d_ff, scale=std), ffp).to(dtype)
    p = {"w2": iu.zero_pad_rows(normal(d_ff, d_model, scale=d_ff ** -0.5),
                                ffp).to(dtype),
         "norm": torch.ones(d_model, dtype=dtype, device=device)}
    if fuse13:
        p["w13"] = iu.pack_pair(w1, w3, tp)
    else:
        p["w1"] = w1
        p["w3"] = w3
    return p


def ffn_train(p, x: torch.Tensor, ctx: TPContext,
              eps: float = 1e-5) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D] ([B, S/TP, D] at tp>1 in the
    sequence-sharded layout); the gate is the mlp_ag seam's epilogue,
    over one shared gather of x."""
    h = layers.rms_norm(x, p["norm"], eps)
    if "w13" in p:
        y = ctx.op("mlp_ag", epilogue=overlap.Epilogue(
            activation="silu", gate="split"))(h, p["w13"])
    else:
        y = ctx.op("mlp_ag", epilogue=overlap.Epilogue(
            activation="silu", gate="pair"), n_weights=2)(h, p["w1"], p["w3"])
    return ctx.op("mlp_rs")(y, p["w2"])


def ffn_decode(p, x: torch.Tensor, ctx: TPContext,
               eps: float = 1e-5) -> torch.Tensor:
    """x: [B, 1, D] -> [B, 1, D]; row-parallel decode_ar seam."""
    h = layers.rms_norm(x, p["norm"], eps)
    if "w13" in p:
        a, g = torch.chunk(torch.matmul(h, p["w13"]), 2, dim=-1)
    else:
        a = torch.matmul(h, p["w1"])
        g = torch.matmul(h, p["w3"])
    return ctx.op("decode_ar")(F.silu(a) * g, p["w2"])


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------
# leaves the reference keeps in fp32 whatever the model's dtype: the MoE
# router, a Mamba mixer's a_log and d_skip, an RWKV time-mix's dec_base and
# u_bonus
FP32_PARAMS = ("router", "a_log", "d_skip", "dec_base", "u_bonus")


def _normal_stack(gen: torch.Generator, shape, std: float, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """normal(0, std) [E, ...] drawn one expert at a time, so the fp32
    draw never holds more than one expert (11 GB of fp32 per full-width
    DeepSeek-V3 expert stack otherwise)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.is_meta:                   # shapes only (count_params_analytic)
        return out
    for e in range(shape[0]):
        out[e] = torch.randn(shape[1:], generator=gen, device=device) * std
    return out


def init_moe(gen: torch.Generator, cfg: ModelConfig, tp: int,
             dtype: torch.dtype, device: torch.device,
             fuse13: bool = False) -> Dict:
    """The reference's GLOBAL expert stacks (``model.shard_params`` cuts
    each rank's experts on dim 0): router [D, E] fp32, w1/w3 [E, D, F], w2
    [E, F, D], the pre-norm, and the shared expert as a dense FFN without
    its own norm."""
    mc = cfg.moe
    dm = cfg.d_model
    e, f = mc.num_experts, mc.expert_ffn
    std = dm ** -0.5
    p = {"router": torch.randn((dm, e), generator=gen, device=device) * std,
         "w1": _normal_stack(gen, (e, dm, f), std, dtype, device),
         "w3": _normal_stack(gen, (e, dm, f), std, dtype, device),
         "w2": _normal_stack(gen, (e, f, dm), f ** -0.5, dtype, device),
         "norm": torch.ones(dm, dtype=dtype, device=device)}
    if mc.num_shared_experts:
        shared = init_ffn(gen, dm, mc.shared_ffn * mc.num_shared_experts, tp,
                          dtype, device, fuse13=fuse13)
        del shared["norm"]      # the shared path uses the MoE pre-norm
        p["shared"] = shared
    return p


# (token, k) assignments that expert capacity evicted since the last
# ``dropped.clear()``, keyed by TP rank (device tensors until read): under
# the sequence-sharded layout a rank counts its shard's drops, elsewhere
# the drops of the assignments to its own experts, so the ranks' totals
# add up to the layer's.
dropped: Dict[int, torch.Tensor] = {}
_DROPPED_LOCK = threading.Lock()


def drop_totals(n_ranks: int = 1) -> List[int]:
    """Each rank's ``dropped`` total (0 for a rank that counted none)."""
    return [int(dropped.get(r, 0)) for r in range(n_ranks)]


def _capacity(tokens: int, mc: MoEConfig) -> int:
    per_expert = tokens * mc.top_k / mc.num_experts
    c = int(per_expert * mc.capacity_factor) + 1
    return max(c, 4)


def _route(p, ht: torch.Tensor, mc: MoEConfig, axis=None):
    """fp32 router: (probs [t, E], gate [t, k] renormalised, eidx [t, k]).
    Under a seam tape ``probs`` is cut (``overlap.cut`` over ``axis``, the
    context's ``tape_axis``): it feeds the aux loss's psum and the
    gates."""
    probs = overlap.cut(torch.softmax(
        torch.matmul(ht.float(), p["router"].float()), dim=-1), axis)
    gate, eidx = torch.topk(probs, mc.top_k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, eidx


def _bucket(flat_e: torch.Tensor, e: int, cap: int,
            counted: Optional[torch.Tensor] = None):
    """Arrival order of each (token, k) assignment at its expert: (slot
    [t*k] clamped into the capacity, keep [t*k]).  Assignments with
    ``counted`` False take no capacity and are never kept."""
    oh = F.one_hot(flat_e, e)
    if counted is not None:
        oh = oh * counted[:, None]
    pos = (torch.cumsum(oh, dim=0) * oh).sum(-1) - 1
    keep = (pos >= 0) & (pos < cap)
    return pos.clamp(0, cap - 1), keep


def _count_drops(ctx: TPContext, keep: torch.Tensor,
                 counted: Optional[torch.Tensor]) -> None:
    if overlap.recomputing():       # the forward counted them
        return
    lost = ~keep if counted is None else counted.bool() & ~keep
    r = ctx.tp_index()
    with _DROPPED_LOCK:         # data replicas add to the same TP rank
        dropped[r] = dropped.get(r, 0) + lost.sum()


def _dispatch(ht: torch.Tensor, flat_e, slot, keep, e: int, cap: int,
              top_k: int) -> torch.Tensor:
    """[E, cap, D] buffer holding each kept assignment's token row."""
    src = torch.arange(ht.shape[0], device=ht.device).repeat_interleave(top_k)
    disp = torch.zeros((e, cap, ht.shape[-1]), dtype=ht.dtype,
                       device=ht.device)
    return disp.index_put_((flat_e, slot),
                           torch.where(keep[:, None], ht[src], 0),
                           accumulate=True)


def _combine(out: torch.Tensor, flat_e, slot, keep, gate: torch.Tensor
             ) -> torch.Tensor:
    """Each token's gate-weighted sum of its kept expert outputs: [t, D]
    fp32 (the reference's segment_sum over the k assignments)."""
    t, k = gate.shape
    vals = torch.where(keep[:, None], out[flat_e, slot], 0)
    return (vals * gate.reshape(-1)[:, None]).reshape(t, k, -1).sum(1)


def _local(ctx: TPContext, flat_e: torch.Tensor, e_loc: int):
    """(this rank's expert index of each assignment, clamped; is it one of
    this rank's experts)."""
    local = flat_e - ctx.ep_index() * e_loc
    is_local = (local >= 0) & (local < e_loc)
    return local.clamp(0, e_loc - 1), is_local


def _ep_blocks(ctx: TPContext, ht: torch.Tensor,
               counted: Optional[torch.Tensor]):
    """The token blocks the experts' group serves in the replicated
    layout, and this rank's index among them: its own tokens when the
    experts split over the TP group (whose ranks hold the same tokens);
    over a dedicated ep axis every member's, and under ``ep_over_dp``
    each data rank's (its TP ranks hold the same), in the group's order
    (the reference's all-gather over the group's data axes).  Each block
    is (tokens [t, D], its counted mask or None)."""
    g = ctx.ep_group
    if g is None or g.n == 1:
        return [(ht, counted)], 0
    same = 1 if ctx.ep > 1 else ctx.tp     # ranks holding the same tokens
    parts = g.exchange(ht if counted is None else (ht, counted), "moe_tokens")
    blocks = [(q, None) if counted is None else q for q in parts[::same]]
    return blocks, g.rank() // same


def _replicated_experts(p, ht: torch.Tensor, ctx: TPContext, mc: MoEConfig,
                        cap_of, counted: Optional[torch.Tensor] = None,
                        routed=None) -> torch.Tensor:
    """The experts of the replicated layout (every TP rank holds the same
    tokens): for each of ``_ep_blocks``' token blocks, this rank's experts
    on the block's kept assignments, bucketed alone with capacity
    ``cap_of(t)`` (so a block's result is what one replica would
    compute), then the psum over the experts' group of the ranks'
    contributions and this rank's block: [t, D] fp32.  ``routed`` is this
    rank's (gate, eidx) when already routed; ``counted`` [t * k] keeps
    pad assignments out of capacity."""
    e_loc = _expert_split(mc.num_experts, ctx)
    blocks, me = _ep_blocks(ctx, ht, counted)
    ys = []
    for j, (hs, cs) in enumerate(blocks):
        gate, eidx = (routed if j == me and routed is not None
                      else _route(p, hs, mc)[1:])
        local_e, is_local = _local(ctx, eidx.reshape(-1), e_loc)
        mask = is_local if cs is None else is_local & cs.bool()
        cap = cap_of(hs.shape[0])
        slot, keep = _bucket(local_e, e_loc, cap, mask)
        _count_drops(ctx, keep, mask)
        disp = _dispatch(hs, local_e, slot, keep, e_loc, cap, mc.top_k)
        out = overlap._expert_fn(_SWIGLU, disp, p["w1"], p["w3"], p["w2"])
        ys.append(_combine(out, local_e, slot, keep, gate))
    t = ht.shape[0]
    return overlap.psum(torch.cat(ys), ctx.ep_axis)[me * t:(me + 1) * t]


_SWIGLU = overlap.Epilogue(activation="silu", gate="pair")


def _shared(p) -> Dict:
    return {"norm": p["norm"], **p["shared"]}


def _expert_split(e: int, ctx: TPContext) -> int:
    if e % ctx.ep_size:
        raise ValueError(f"{e} experts do not split over {ctx.ep_size} "
                         f"ranks")
    return e // ctx.ep_size


EP_REPLICATED_LAYOUT = (
    "the replicated residual layout (scatter_axis='hidden') does not train "
    "MoE with experts over another group than the TP ranks (a dedicated "
    "ep axis or ep_over_dp): the local-expert combine would give each "
    "rank's experts every data shard's tokens and break the per-shard "
    "grads, as in the reference; train it under scatter_axis='seq'")


def moe_train(p, x: torch.Tensor, ctx: TPContext, cfg: ModelConfig,
              eps: float = 1e-5, lengths: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] ([B, S/TP, D] sequence-sharded) -> (same shape,
    aux_loss).

    Router -> capacity-bucketed dispatch -> ONE ``moe_a2a`` seam (the
    exchange to the experts' ranks, the batched per-expert SwiGLU, the
    exchange back) -> gate-weighted combine; under the replicated layout
    at tp>1, the local experts and a psum instead (module docstring).
    ``lengths`` ([B], optional): true prompt lengths of a right-padded
    batch; pad tokens (at their global positions) take no expert
    capacity, are not dispatched or combined, and do not count in the
    load-balance aux loss, whose sums cover every rank's tokens."""
    mc = cfg.moe
    b, s_loc, dm = x.shape
    t = b * s_loc
    e = mc.num_experts
    e_loc = _expert_split(e, ctx)
    # the normed tokens feed the router and the dispatch (or the local
    # experts): cut on the seam tape at tp>1, as the router's probs are
    ht = overlap.cut(layers.rms_norm(x, p["norm"], eps).reshape(t, dm),
                     ctx.tape_axis)
    probs, gate, eidx = _route(p, ht, mc, ctx.tape_axis)

    valid_t = None
    if lengths is not None:
        valid_t = (layers.seq_positions(b, s_loc, x.device, ctx=ctx)
                   < lengths.to(x.device)[:, None]).reshape(t)
    # Switch-style load-balance loss over the valid tokens of every rank
    # (me, ce and the count summed over the TP group, then over the pod
    # and data groups, as the reference's psums: one exchange a group)
    vmask = (torch.ones(t, device=x.device) if valid_t is None
             else valid_t.float())
    sums = torch.cat([(probs * vmask[:, None]).sum(0),
                      (F.one_hot(eidx[:, 0], e).float()
                       * vmask[:, None]).sum(0), vmask.sum()[None]])
    for axis in (ctx.axis, *ctx.dp_groups):
        sums = overlap.psum(sums, axis)
    me, ce = sums[:e], sums[e:2 * e]
    cnt = torch.clamp(sums[-1], min=1.0)
    aux = e * torch.sum((me / cnt) * (ce / cnt))

    flat_e = eidx.reshape(-1)
    counted = (None if valid_t is None
               else valid_t.repeat_interleave(mc.top_k))
    if ctx.ep_size > 1 and not ctx.seq_sharded:
        if ctx.ep_group is not None and probs.requires_grad:
            raise NotImplementedError(EP_REPLICATED_LAYOUT)
        y = _replicated_experts(p, ht, ctx, mc,
                                lambda n: _capacity(n, mc), counted,
                                (gate, eidx))
    else:
        cap = _capacity(t, mc)
        slot, keep = _bucket(flat_e, e, cap, counted)
        _count_drops(ctx, keep, counted)
        disp = _dispatch(ht, flat_e, slot, keep, e, cap, mc.top_k)
        # dim 0 of the [ep, E_loc, cap, D] buffer is the destination EP
        # rank (experts are blocked: global id = ep rank * E_loc + local)
        ret = ctx.op("moe_a2a", epilogue=_SWIGLU, n_weights=3)(
            disp.reshape(ctx.ep_size, e_loc, cap, dm), p["w1"], p["w3"],
            p["w2"])
        y = _combine(ret.reshape(e, cap, dm), flat_e, slot, keep, gate)
    y = y.reshape(b, s_loc, dm).to(x.dtype)
    if "shared" in p:
        y = y + ffn_train(_shared(p), x, ctx, eps)
    return y, aux


def moe_decode(p, x: torch.Tensor, ctx: TPContext, cfg: ModelConfig,
               eps: float = 1e-5) -> torch.Tensor:
    """x: [B, 1, D] -> [B, 1, D], replicated over the TP ranks.  Each rank
    buckets the assignments to its own experts with the statistical
    decode capacity ``min(t*k, max(32, 8*t*k/E))`` (overflow drops), runs
    them, and a psum over the EP group combines the ranks' outputs.  With
    experts over a dedicated ep axis or ``ep_over_dp`` the other data
    ranks' tokens come in first (``_ep_blocks``), each block bucketed
    alone (the reference buckets the gathered tokens in one order: the
    two agree while no assignment drops, as at these batch sizes)."""
    mc = cfg.moe
    b, dm = x.shape[0], x.shape[-1]
    e, k = mc.num_experts, mc.top_k
    h = layers.rms_norm(x, p["norm"], eps)
    ht = h.reshape(b, dm)
    y = _replicated_experts(
        p, ht, ctx, mc, lambda t: int(min(t * k, max(32, (t * k * 8) // e))))
    y = y.reshape(b, 1, dm).to(x.dtype)
    if "shared" in p:
        y = y + ffn_decode(_shared(p), x, ctx, eps)
    return y

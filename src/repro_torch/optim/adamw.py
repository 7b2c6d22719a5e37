"""AdamW with ZeRO-1 moments and the hierarchical, optionally int8
compressed, grad sync (port of ``repro.optim.adamw``).

Runs as one rank (inside ``spmd`` at tp>1 or dp>1) on that rank's leaves,
keyed by name (``Model.named_parameters()``).  ``group`` is the rank's TP
group, ``data`` and ``pod`` its data-parallel sub-groups of the mesh
(``dist.RankMesh``; None or a group of one rank when there is no such
axis), ``ep`` its dedicated expert-parallel sub-group.  A leaf is either
replicated over data (the reference's "rep" branch: ZeRO-1 below) or
split over data in the model itself (``Zero1Leaf.sharded``: a ZeRO-3
leaf, or a routed expert under ``ep_over_dp``): autodiff of its gather
(or the ``a2a`` backward) already summed the data ranks' grads of a
data rank's piece, so it is synced over no data rank (the reference
takes no data mean of it: its grad is dp x the data mean), counted once
a data rank in the norm, and updated where it lies.

How the data ranks split a leaf is the reference's, on its layout
(``zero1_plan``): the reference stacks a repeated-pattern layer's leaves
``[reps, ...]`` and tests that stacked dim, so when dp divides the
repetitions a data rank owns whole layers of each pattern position
(``Zero1Leaf.owner``); any other leaf (the embedding, the leading
layers, the MTP head) is split along its own dim 0 when dp divides it
(``rows``); the rest stay whole.  Following the reference's layout, and
not only its values, keeps the int8 pod codec's 256-element blocks (the
flattened local piece of each reference leaf) the reference's, so the
compressed sync gives its values too.

  phase 1 — grad sync, in fp32: the trainer has psum'd the
    model-replicated leaves' grads over the TP ranks.  An owned piece
    (a row shard, or a whole layer on its owner) is reduce-scattered over
    data and divided by dp; a whole leaf takes the pmean over data.  Then
    the pod all-reduce (``pod_allreduce``) of each reference leaf's
    piece: a pmean, or with ``grad_compress`` every pod's int8
    block-quantized piece gathered and the dequantized sum divided by the
    pod count.  One exchange a phase carries every leaf.
  phase 2 — global grad-norm clip: each piece's squared sum, weighted by
    1/dp for a leaf held whole on every data rank, by 1/tp for a
    model-replicated leaf and by 1/ep for a leaf replicated over a
    dedicated ep axis (the trainer has averaged those over ep), is summed
    over the TP group, then over data, then over ep (never pod: the grads
    are pod-identical after the sync), so every element counts once.
  phase 3 — AdamW in fp32 on the owned pieces (moments in
    ``moment_dtype``, only for those pieces; the new values cast back to
    the parameter's and the moments' dtypes and written in place: the
    step never holds two copies of the moments), a leaf ``UPDATE_CHUNK``
    elements at a time so that its fp32 temporaries stay small when every
    rank updates at once on one card; then the owned pieces are
    all-gathered over data into every rank's copy.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import overlap


# elements of a leaf updated at once (a few fp32 temporaries of 256 MB)
UPDATE_CHUNK = 1 << 26
# the int8 pod wire's block (the reference's ``_quantize_int8``)
QUANT_BLOCK = 256


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"


def _size(group) -> int:
    return 1 if group is None else group.n


def _sharddable(p: torch.Tensor, n: int) -> bool:
    return p.dim() >= 1 and _sharddable_n(p.shape[0], n)


@dataclasses.dataclass(frozen=True)
class Zero1Leaf:
    """How the data ranks split one leaf (``zero1_plan``): ``rows`` — each
    owns its dim-0 shard; ``owner`` — that data rank owns the whole leaf
    (a layer of the reference's stacked leaf); ``sharded`` — the model
    itself splits it over data (ZeRO-3, experts under ``ep_over_dp``):
    each data rank holds its own piece; none — every data rank holds it
    whole.  ``stack``: the reference leaf whose local piece the int8 pod
    codec quantizes in one piece (the leaf's own name when it is not
    stacked)."""
    stack: str
    rows: bool = False
    owner: Optional[int] = None
    sharded: bool = False

    def holds(self, data_rank: int) -> bool:
        """Does this data rank update (and keep moments of) the leaf?"""
        return self.owner is None or self.owner == data_rank


def zero1_plan(params: Dict[str, torch.Tensor], dp: int,
               stacked: Dict[str, Tuple[str, int, int]],
               sharded: frozenset = frozenset()) -> Dict[str, Zero1Leaf]:
    """Each leaf's split over ``dp`` data ranks, the reference's
    ``opt_state_specs`` on its layout: a leaf of ``sharded`` (split over
    data by the model) stays so; a leaf of ``stacked`` (name -> (stacked
    key, repetition, repetitions); ``models.model.stacked_leaves``) is
    owned by data rank ``rep // (reps / dp)`` when dp divides the
    repetitions, else held whole; any other leaf is split along its dim 0
    when dp divides it."""
    plan = {}
    for n, p in params.items():
        if n in sharded:
            plan[n] = Zero1Leaf(stack=stacked[n][0] if n in stacked else n,
                                sharded=True)
        elif n in stacked:
            key, rep, reps = stacked[n]
            owner = (rep // (reps // dp) if dp > 1 and _sharddable_n(reps, dp)
                     else None)
            plan[n] = Zero1Leaf(stack=key, owner=owner)
        else:
            plan[n] = Zero1Leaf(stack=n, rows=dp > 1 and _sharddable(p, dp))
    return plan


def _sharddable_n(dim0: int, n: int) -> bool:
    return dim0 % n == 0 and dim0 >= n


def _dp_shard(x: torch.Tensor, group) -> torch.Tensor:
    """This data rank's dim-0 shard of ``x`` (a view), or ``x`` when it is
    not sharddable over the group."""
    n = _size(group)
    if n == 1 or not _sharddable(x, n):
        return x
    sh = x.shape[0] // n
    r = group.rank()
    return x[r * sh:(r + 1) * sh]


def _div(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x / n`` by a device tensor: CUDA divides by a host scalar as a
    multiply by its reciprocal, which rounds differently from the CPU's
    (and XLA's) divide."""
    return x / torch.full((), float(n), dtype=x.dtype, device=x.device)


def div_(x: torch.Tensor, n: int) -> torch.Tensor:
    """``_div`` in place."""
    return x.div_(torch.full((), float(n), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# int8 block-quantized pod all-reduce (ZeRO++ analogue)
# ---------------------------------------------------------------------------
def _quantize_int8(x: torch.Tensor, block: int = QUANT_BLOCK
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q [blocks, block] int8, scale [blocks, 1] fp32): per-block
    ``absmax / 127 + 1e-12``, values rounded half to even and clipped to
    ±127, the flat leaf zero-padded to whole blocks (the reference's
    arithmetic in its order)."""
    flat = x.reshape(-1)
    blocks = F.pad(flat, (0, (-flat.numel()) % block)).view(-1, block)
    amax = torch.amax(torch.abs(blocks), dim=1, keepdim=True)
    scale = amax / torch.full_like(amax, 127.0) + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def pod_allreduce(grads: Dict[str, torch.Tensor], pod, compress: bool = False,
                  stacks: Optional[Dict[str, str]] = None
                  ) -> Dict[str, torch.Tensor]:
    """The pmean over the pods of each reference leaf's local piece (the
    leaves of one ``stacks`` key joined flat, in order; a leaf alone
    without one), summed in pod order, every piece in one exchange.  With
    ``compress`` each pod's int8 block-quantized ``(q, scale)`` of a piece
    is gathered and the dequantized sum divided by the pod count (lossy,
    as the reference's)."""
    if _size(pod) == 1:
        return grads
    groups: Dict[str, list] = {}
    for n in grads:
        groups.setdefault((stacks or {}).get(n, n), []).append(n)
    flats = [torch.cat([grads[n].reshape(-1) for n in names])
             if len(names) > 1 else grads[names[0]].reshape(-1)
             for names in groups.values()]
    k = 2 if compress else 1
    payload = []
    for f in flats:
        payload.extend(_quantize_int8(f) if compress else (f,))
    parts = pod.exchange(tuple(payload), "pod_allreduce")
    out = {}
    for i, (names, f) in enumerate(zip(groups.values(), flats)):
        acc = None
        for part in parts:
            d = (part[k * i].float() * part[k * i + 1] if compress
                 else part[k * i])
            acc = d if acc is None else acc + d
        acc = _div(acc, pod.n).reshape(-1)[:f.numel()]
        for n, piece in zip(names, acc.split([grads[n].numel()
                                              for n in names])):
            out[n] = piece.view(grads[n].shape)
    return out


# ---------------------------------------------------------------------------
# optimizer state
# ---------------------------------------------------------------------------
def moment_shape(p: torch.Tensor, z: Optional[Zero1Leaf] = None,
                 dp: int = 1) -> Tuple[int, ...]:
    """A held leaf's moments' shape on one data rank: the leaf's, or its
    dim-0 shard under ``rows``."""
    if z is not None and z.rows:
        return (p.shape[0] // dp, *p.shape[1:])
    return tuple(p.shape)


def init_opt_state(params: Dict[str, torch.Tensor],
                   moment_dtype: str = "float32",
                   plan: Optional[Dict[str, Zero1Leaf]] = None, dp: int = 1,
                   data_rank: int = 0) -> Dict:
    """Zero moments in ``moment_dtype`` for the leaves data rank
    ``data_rank`` holds under ``plan`` (every leaf, whole, without one),
    each ``moment_shape``."""
    dt = getattr(torch, moment_dtype)

    def zeros():
        return {n: torch.zeros(moment_shape(p, z, dp), dtype=dt,
                               device=p.device)
                for n, p in params.items()
                for z in [None if plan is None else plan[n]]
                if z is None or z.holds(data_rank)}
    return {"mu": zeros(), "nu": zeros(), "count": 0}


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------
@torch.no_grad()
def sync_grads(grads: Dict[str, torch.Tensor],
               plan: Optional[Dict[str, Zero1Leaf]] = None, data=None,
               pod=None, compress: bool = False) -> Dict[str, torch.Tensor]:
    """Phase 1: the grads of the pieces a rank holds under ``plan``: an
    owned piece (a row shard, a layer on its owner) reduce-scattered over
    ``data`` and divided by dp, a whole leaf's pmean over ``data`` (each
    summed in fp32), a ``sharded`` leaf as it is; then ``pod_allreduce``
    of each reference leaf's piece, in fp32.  One exchange over data, and
    one over the pods, carries every leaf.  The grads cross as they are
    and each piece is summed in fp32 as it is read, so no fp32 copy of
    every grad is made at once; a leaf no exchange touches keeps its
    dtype (the update reads it in fp32: the same values)."""
    dp = _size(data)
    out = dict(grads)
    if dp > 1:
        names = [n for n in out if not plan[n].sharded]
        parts = dict(zip(names, zip(*data.exchange(
            tuple(out[n] for n in names), "zero1_grads"))))
        me = data.rank()
        synced = {}
        for n in out:
            z = plan[n]
            if z.sharded:
                synced[n] = out[n]
                continue
            if not z.holds(me):
                continue
            rows = slice(None)
            if z.rows:
                sh = out[n].shape[0] // dp
                rows = slice(me * sh, (me + 1) * sh)
            acc = None
            for piece in parts[n]:
                if acc is None:
                    acc = piece[rows].to(torch.float32, copy=True)
                else:
                    acc += piece[rows]
            synced[n] = _div(acc, dp)
        out = synced
    if _size(pod) > 1:
        out = {n: g.float() for n, g in out.items()}
    return pod_allreduce(out, pod, compress, None if plan is None else
                         {n: z.stack for n, z in plan.items()})


def grad_norm(grads: Dict[str, torch.Tensor], replicated: Dict[str, bool],
              group=None, data=None,
              plan: Optional[Dict[str, Zero1Leaf]] = None, ep=None,
              ep_replicated: Optional[Dict[str, bool]] = None
              ) -> torch.Tensor:
    """Phase 2: the global L2 norm of the synced grads.  A piece's squared
    sum counts 1/dp when every data rank holds the leaf whole (``plan``),
    1/tp when it is model-replicated and 1/ep when it is replicated over
    the ``ep`` group (``ep_replicated``); the sum runs over the TP group,
    then over data, then over ep.  A leaf is summed ``UPDATE_CHUNK``
    elements at a time (small fp32 temporaries)."""
    tp, dp, epn = _size(group), _size(data), _size(ep)
    total = None
    for n, g in grads.items():
        s = sum(torch.sum(torch.square(c.float()))
                for c in g.reshape(-1).split(UPDATE_CHUNK))
        z = plan[n]
        if dp > 1 and not (z.rows or z.sharded) and z.owner is None:
            s = s / dp
        if replicated[n] and tp > 1:
            s = s / tp
        if epn > 1 and ep_replicated[n]:
            s = s / epn
        total = s if total is None else total + s
    for axis in (group, data, ep):
        total = overlap.psum(total, axis)
    return torch.sqrt(total)


def _update(p: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
            grad: torch.Tensor, clip, c1: float, c2: float, lr,
            cfg: AdamWConfig) -> None:
    """One AdamW step on flat slices of a leaf and its moments, in place:
    the reference's fp32 arithmetic op for op, the fp32 moments updated in
    place and each temporary freed once read."""
    g = grad.to(torch.float32, copy=True).mul_(clip)
    mu32 = mu if mu.dtype == torch.float32 else mu.float()
    mu32.mul_(cfg.b1).add_(torch.mul(g, 1 - cfg.b1))
    nu32 = nu if nu.dtype == torch.float32 else nu.float()
    nu32.mul_(cfg.b2).add_(torch.mul(g, 1 - cfg.b2).mul_(g))
    del g
    step = torch.div(mu32, c1)
    step.div_(torch.div(nu32, c2).sqrt_().add_(cfg.eps))
    p32 = p.float()
    step.add_(torch.mul(p32, cfg.weight_decay)).mul_(lr)
    p.copy_(p32.sub_(step))
    del step, p32
    if mu32 is not mu:
        mu.copy_(mu32)
    if nu32 is not nu:
        nu.copy_(nu32)


@torch.no_grad()
def adamw_update(params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], opt: Dict,
                 cfg: AdamWConfig, lr, *, replicated: Dict[str, bool],
                 group=None, data=None, pod=None,
                 plan: Optional[Dict[str, Zero1Leaf]] = None,
                 grad_compress: bool = False, ep=None,
                 ep_replicated: Optional[Dict[str, bool]] = None
                 ) -> Tuple[Dict, Dict]:
    """One AdamW step on ``params`` and the moments (both updated in
    place) with ``grads``; returns (params, new optimizer state).
    ``replicated[name]`` is True for a model-replicated leaf
    (``model.param_specs`` dim None).  ``data`` / ``pod``: the rank's
    data-parallel groups; ``plan``: ``zero1_plan`` at dp (needed at
    dp>1; module docstring); ``ep`` / ``ep_replicated``: the dedicated
    expert-parallel group and the leaves replicated over it."""
    dp = _size(data)
    if plan is None:
        if dp > 1:
            raise ValueError("adamw_update at dp>1 needs the zero1_plan")
        plan = {n: Zero1Leaf(stack=n) for n in params}
    me = data.rank() if dp > 1 else 0
    gsync = sync_grads(grads, plan, data, pod, grad_compress)
    gnorm = grad_norm(gsync, replicated, group, data, plan, ep,
                      ep_replicated)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-6), max=1.0)
    count = opt["count"] + 1
    cnt = torch.tensor(float(count), dtype=torch.float32)
    c1 = (1.0 - torch.tensor(cfg.b1, dtype=torch.float32) ** cnt).item()
    c2 = (1.0 - torch.tensor(cfg.b2, dtype=torch.float32) ** cnt).item()
    device = next(iter(params.values())).device
    lr = torch.as_tensor(lr, dtype=torch.float32).to(device)
    pieces = {}
    for n, p in params.items():
        if not plan[n].holds(me):
            continue
        p_sh = _dp_shard(p, data) if plan[n].rows else p
        flat = [t.view(-1) for t in (p_sh, opt["mu"][n], opt["nu"][n])]
        flat.append(gsync.pop(n).reshape(-1))
        for lo in range(0, p_sh.numel(), UPDATE_CHUNK):
            _update(*(t[lo:lo + UPDATE_CHUNK] for t in flat), clip, c1, c2,
                    lr, cfg)
        del flat
        if dp > 1 and (plan[n].rows or plan[n].owner is not None):
            pieces[n] = p_sh
    if dp > 1:
        # the ZeRO re-assembly over data: every peer's updated pieces into
        # this rank's copy, one exchange for every leaf
        for q, part in enumerate(data.exchange(tuple(pieces.values()),
                                               "zero1_params")):
            if q == me:
                continue
            held = [n for n in params
                    if plan[n].rows or plan[n].owner == q]
            for n, t in zip(held, part):
                dst = params[n]
                if plan[n].rows:
                    dst = dst[q * t.shape[0]:(q + 1) * t.shape[0]]
                dst.copy_(t)
    return params, {"mu": opt["mu"], "nu": opt["nu"], "count": count}

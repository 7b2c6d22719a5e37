"""Parallelism context + padding helpers threaded through the model code.

Every TP seam routes through ``repro_torch.core.overlap`` (``ctx.op(seam)``),
as in the reference.  At tp>1 the context holds the ``dist.RankGroup`` of
the TP ranks (the reference's mesh axis) and the seams' plans: a
``tuning.plans.PlanSet`` resolved per seam and per layer
(``ctx.plan(seam)``); model code then runs inside
``group.spmd``, one call per rank.  At tp>1 the residual stream is either
sequence-sharded (``seq_sharded``: prefill and, by default, training)
or replicated (decode, the chunked prefill, the prefill under
``ctx.with_layout(False)``, and training with ``scatter_axis="hidden"``);
the seams' backward runs in both.

Expert parallelism runs, as the reference's does, over the TP ranks
when no other group is given (``ctx.ep_axes or (ctx.axis,)``): the EP
group is the TP group (``axis``), a rank's EP index is its TP index, and
rank r holds experts ``[r * E / tp, (r + 1) * E / tp)``.  A dedicated
``ep`` axis (``ParallelConfig.ep > 1``: the mesh's "ep" sub-group, which
also carries batch) or experts over ``("data", "model")``
(``ep_over_dp``: the mesh's view over both axes, axis-major) is the
context's ``ep_group`` instead; ``ep_axis`` is the group the
``moe_a2a`` seam runs over either way, and at one rank it is the local
expert FFN.

Data parallelism (dp>1, pods>1, ep>1) runs each rank as one thread of a
``dist.RankMesh`` (``launch.mesh.make_mesh``): the context holds the
rank's "model" sub-group (``group``, at tp>1) and its data-parallel
sub-groups (``dp_groups``: pod, then ep, then data, the reference's
``dp_axes``), over which the MoE aux loss sums its statistics and the
trainer and ``optim.adamw`` sync the grads.  The serve steps
(``models.serve``) and the paged Server take the same context; under
ZeRO-3 it carries the config whose ZeRO-3 leaves each serve step's layer
gathers over the "data" sub-group (``zero3``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import overlap
from repro_torch.core.overlap import Epilogue, FusedOp
from repro_torch.tuning.plans import (SEAM_KINDS, PlanSet, SeamPlan,
                                      plan_set_from_parallel)

TP_NEEDS_GROUP = ("tensor parallelism (tp>1) runs the ranks of a "
                  "dist.RankGroup of size tp inside group.spmd: pass "
                  "group= (ROADMAP queue 1 item 2)")
EP_NEEDS_MESH = ("a dedicated expert-parallel axis (ep>1) runs over the "
                 "\"ep\" axis of a dist.RankMesh: pass mesh= "
                 "(launch.mesh.make_mesh(..., ep=)) to make_ctx, the "
                 "Trainer or the Server")
DP_NEEDS_MESH = ("data parallelism (dp>1 or pods>1) runs the ranks of a "
                 "dist.RankMesh of shape (pods, ep, dp, tp) inside "
                 "mesh.spmd: pass mesh= (launch.mesh.make_mesh)")


@dataclasses.dataclass(frozen=True)
class TPContext:
    """How the current region is parallelized.

    tp          : tensor-parallel degree; tp>1 needs ``group``
    ep          : the degree of a dedicated expert-parallel axis (1: none;
                  ep>1 needs ``ep_group``)
    use_kernels : route hot paths through the hand-written kernels
                  (``gqa_train``'s attention -> flash kernel; MLA decode
                  attention -> MLA-decode kernel)
    seq_sharded : residual-stream layout (sequence-sharded by default;
                  False is the replicated layout, which the serving decode
                  and chunked prefill always run, and training runs with
                  ``ParallelConfig.scatter_axis="hidden"``)
    group       : the ``dist.RankGroup`` of the tp ranks (None at tp=1)
    dp_groups   : this rank's data-parallel sub-groups of its mesh, pod,
                  ep, then data (empty without a mesh)
    dp_axes     : the mesh axes of ``dp_groups``, in their order
    ep_group    : the group the experts split over when it is not the TP
                  group: the mesh's "ep" sub-group, or its ("data",
                  "model") view under ``ep_over_dp`` (None: the TP group)
    zero3       : under ZeRO-3 on a mesh, the ``ParallelConfig`` whose
                  ZeRO-3 leaves (``model.zero3_leaves``) the serve steps
                  gather over ``data_group`` a layer at a time (None: the
                  layers' leaves are whole)
    mode        : the transport of seams without a plan
                  (``overlap.VALID_MODES``)
    comm_chunks : the ring sub-chunking of seams without a plan
    plans       : the per-layer-seam ``PlanSet``; when set, every seam
                  resolves its knobs through ``self.plan(seam)``
    layer       : the current layer slot (``models.model.layer_slot``),
                  threaded by the model for per-layer overrides
    """
    tp: int = 1
    ep: int = 1
    use_kernels: bool = False
    seq_sharded: bool = True
    group: Optional[object] = None
    dp_groups: Tuple = ()
    dp_axes: Tuple[str, ...] = ()
    ep_group: Optional[object] = None
    zero3: Optional[object] = None
    mode: str = "decomposed"
    comm_chunks: int = 0
    plans: Optional[PlanSet] = None
    layer: Optional[int] = None

    def __post_init__(self):
        if self.tp != 1 and (self.group is None or self.group.n != self.tp):
            raise ValueError(TP_NEEDS_GROUP)
        if self.ep != 1 and (self.ep_group is None
                             or self.ep_group.n != self.ep):
            raise ValueError(EP_NEEDS_MESH)
        if self.mode not in overlap.VALID_MODES:
            raise ValueError(f"invalid overlap mode {self.mode!r}")

    @property
    def axis(self):
        """The TP group seams run over (None at tp=1)."""
        return self.group if self.tp > 1 else None

    @property
    def ep_axis(self):
        """The group the experts split over and the ``moe_a2a`` seam runs
        over: ``ep_group``, else the TP group (None at one rank)."""
        return self.ep_group if self.ep_group is not None else self.axis

    @property
    def ep_size(self) -> int:
        """The number of ranks the experts split over."""
        return 1 if self.ep_axis is None else self.ep_axis.n

    def dp_group(self, axis: str):
        """This rank's sub-group of the data-parallel mesh axis ``axis``
        (None when the mesh has no such axis)."""
        if axis not in self.dp_axes:
            return None
        return self.dp_groups[self.dp_axes.index(axis)]

    @property
    def data_group(self):
        """This rank's "data" sub-group (None without a mesh): the ZeRO-1
        sync and ZeRO-3's weight gather run over it."""
        return self.dp_group("data")

    def ep_index(self) -> int:
        """This rank's index in the experts' group (0 at one rank): it
        holds experts ``[ep_index * E_loc, (ep_index + 1) * E_loc)``."""
        return self.ep_axis.rank() if self.ep_size > 1 else 0

    @property
    def tape_axis(self):
        """The group whose size decides whether a rank's backward is cut
        into tape segments (``overlap.cut``, ``overlap.remat``): the TP
        group at tp>1; at tp=1 a data-parallel group of more than one
        rank, whose psum (the MoE aux loss's) rides the tape; else
        None."""
        if self.tp > 1:
            return self.group
        return next((g for g in self.dp_groups if g.n > 1), None)

    @property
    def seq_factor(self) -> int:
        """Global sequence length = local length * seq_factor."""
        return self.tp if self.seq_sharded else 1

    def with_layout(self, seq_sharded: bool) -> "TPContext":
        if seq_sharded == self.seq_sharded:
            return self
        return dataclasses.replace(self, seq_sharded=seq_sharded)

    def with_layer(self, layer: Optional[int]) -> "TPContext":
        if layer == self.layer:
            return self
        return dataclasses.replace(self, layer=layer)

    def plan(self, seam: str) -> SeamPlan:
        """The plan of one model seam at this layer; without a PlanSet,
        the context's mode and comm_chunks."""
        if self.plans is not None:
            return self.plans.resolve(seam, self.layer)
        return SeamPlan(mode=self.mode, comm_chunks=self.comm_chunks)

    def tp_index(self) -> int:
        """This rank's index in the TP group (0 at tp=1)."""
        return self.group.rank() if self.tp > 1 else 0

    def op(self, seam: str, epilogue: Optional[Epilogue] = None,
           n_weights: int = 1) -> FusedOp:
        """The ``overlap.FusedOp`` for one model seam — the only way model
        code reaches a seam.  The kind comes from the seam name, the knobs
        from ``self.plan(seam)``, the layout from ``seq_sharded``."""
        kind = SEAM_KINDS[seam]
        scatter_axis = None
        if kind in ("ag", "rs"):
            scatter_axis = "seq" if self.seq_sharded else "hidden"
        # the EP exchange runs over the experts' group, not the TP group
        return self.plan(seam).op(
            kind, self.ep_axis if kind == "a2a" else self.axis,
            epilogue=epilogue if epilogue is not None else Epilogue(),
            n_weights=n_weights, scatter_axis=scatter_axis)

    def gather_seq(self, x: torch.Tensor,
                   seam: str = "attn_ag") -> torch.Tensor:
        """Full-sequence view of a sequence-sharded non-GEMM payload
        (boundary rows), on ``seam``'s plan transport and direction;
        no-op at tp=1 or in the replicated layout."""
        if self.tp == 1 or not self.seq_sharded:
            return x
        plan = self.plan(seam)
        return overlap.gather_seq(x, self.group, plan.mode, plan.reverse)

    def scatter_seq(self, x: torch.Tensor,
                    seam: str = "head_ag") -> torch.Tensor:
        """ReduceScatter a per-rank full-sequence partial into this rank's
        sequence shard (the embedding seam's combine) — dual of
        ``gather_seq``, on ``seam``'s plan transport; in the replicated
        layout the psum of the partials."""
        if self.tp == 1:
            return x
        if not self.seq_sharded:
            return overlap.psum(x, self.group)
        plan = self.plan(seam)
        return overlap.scatter_seq_sum(x, self.group, plan.mode,
                                       plan.reverse)


def gather_ranks(x: torch.Tensor, group) -> torch.Tensor:
    """Stack every rank's copy of ``x`` along a NEW trailing dim:
    [...] -> [..., TP] (the vocab-parallel argmax candidates)."""
    if group is None or group.n == 1:
        return x[..., None]
    return torch.stack(group.exchange(x, "rank_gather"), dim=-1)


SCATTER_AXES = ("auto", "seq", "hidden")


def _backend(group) -> Optional[str]:
    """The device type whose tuned profiles a group loads (None: the
    registry's default)."""
    return None if group is None else group.device.type


def make_ctx(par, group=None, plans: Optional[PlanSet] = None, *,
             mesh=None, rank: Optional[int] = None) -> TPContext:
    """The context a ``ParallelConfig`` implies (the reference's
    ``trainer.make_ctx``): ``use_kernels`` from ``kernel_decode``, the
    seams' plans from ``plan_set_from_parallel(par)`` (the uniform
    ``overlap_mode`` overlaid with ``par.plan_profile``, loaded for the
    group's device, the layout stamped by ``par.scatter_axis`` unless
    "auto") unless ``plans`` is given, and the residual layout from the
    plans (``PlanSet.residual_layout``).  With ``mesh`` (a
    ``dist.RankMesh`` of shape ``(pods, ep, dp, tp)``; needed at dp>1,
    pods>1 or ep>1) the context of mesh rank ``rank`` (default: the
    calling rank thread's): its "model" sub-group at tp>1, its pod, ep
    and data sub-groups, and the experts' group: the "ep" sub-group at
    ep>1, the ("data", "model") view under ``ep_over_dp``, and under
    ``par.zero3`` ``par`` as ``zero3``."""
    dp_groups, axes = (), ()
    ep_group = zero3 = None
    if mesh is not None:
        from repro_torch.launch.mesh import dp_axes, mesh_shape
        want = mesh_shape(par)
        if tuple(mesh.shape) != want:
            raise ValueError(f"mesh {mesh.shape} {mesh.axes} is not the "
                             f"(pods, ep, dp, tp) = {want} of the config")
        rank = mesh.rank() if rank is None else rank
        group = mesh.group("model", rank) if par.tp > 1 else None
        axes = dp_axes(mesh)
        dp_groups = tuple(mesh.group(a, rank) for a in axes)
        if par.ep > 1:
            ep_group = mesh.group("ep", rank)
        elif par.ep_over_dp:
            ep_group = mesh.group(("data", "model"), rank)
        if par.zero3:
            zero3 = par
    elif par.dp * par.pods != 1:
        raise ValueError(DP_NEEDS_MESH)
    axis = getattr(par, "scatter_axis", "auto")
    if axis not in SCATTER_AXES:
        raise ValueError(f"invalid scatter_axis {axis!r}; one of "
                         f"{SCATTER_AXES}")
    if plans is None:
        plans = plan_set_from_parallel(
            par, _backend(group if mesh is None else mesh))
    return TPContext(tp=par.tp, ep=par.ep, use_kernels=par.kernel_decode,
                     seq_sharded=plans.residual_layout() == "seq",
                     group=group, dp_groups=dp_groups, dp_axes=axes,
                     ep_group=ep_group, zero3=zero3,
                     mode=par.overlap_mode, comm_chunks=par.comm_chunks,
                     plans=plans)


def ceil_mult(x: int, m: int) -> int:
    """Round x up to a multiple of m."""
    return ((x + m - 1) // m) * m


def pad_heads(num_heads: int, tp: int) -> int:
    if num_heads == 0:
        return 0
    return ceil_mult(num_heads, tp)


def pad_kv_heads(num_kv_heads: int, tp: int) -> int:
    """KV heads: replicate up to TP when fewer than TP, else pad."""
    if num_kv_heads == 0:
        return 0
    if num_kv_heads < tp:
        return tp
    return ceil_mult(num_kv_heads, tp)


def pad_ff(d_ff: int, tp: int, align: int = 128) -> int:
    return ceil_mult(d_ff, tp * align)


def pad_vocab(vocab: int, tp: int, align: int = 128) -> int:
    return ceil_mult(vocab, tp * align)

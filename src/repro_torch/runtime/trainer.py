"""Training runtime (port of ``repro.runtime.trainer``).

One train step is ``forward_loss``, its backward, the sum over the TP
ranks of the model-replicated leaves' grads, the pmean of the loss over
the data-parallel ranks, the LR schedule and ``adamw_update`` (ZeRO-1
over data, the pod all-reduce), with the weights and the optimizer state
updated in place (the reference donates them).  On a dedicated ``ep``
axis, as the reference's step does, the leaves replicated over it take
their pmean over ep and the routed experts (split over it) their grad
/ ep.  At more than one rank
``Trainer`` owns the ``dist.RankMesh`` of ``launch.mesh.make_mesh``
("pod", "ep", "data", "model"; an axis of size 1 dropped but "data" and
"model"), whose TP sub-groups run the seams.  Each rank's step runs
inside ``spmd`` on the rank's copy (``model.mesh_shard``: its TP block,
its experts, and with ``zero3`` its data shard of the ZeRO-3 leaves;
data replicas otherwise hold equal copies) and its data shard of the
global batch; the step records the forward's seams
on a ``core.overlap.SeamTape`` and drives the backward from the rank's
own thread (the autograd engine runs a card's CUDA nodes on one device
thread, where the ranks' exchanges cannot meet).

Around the step, as in the reference: checkpoints every
``checkpoint_every`` steps (``checkpoint.checkpointer``, asynchronous, in
the reference's format: the global tp-packed tree, so a checkpoint
crosses between the port and the reference at the same tp); resume from
the latest one with the data stream reseeked (``batch_at`` is a function
of the step); a failed step (``fault_hook(step)`` may raise to simulate
one) reloads the last checkpoint, or re-inits, up to ``max_retries``
times; a step slower than ``straggler_factor`` x the step-time EWMA is
counted and logged.  The checkpoint tree is global: the ranks' pieces
(``model.mesh_join``: the TP blocks, the experts, the ZeRO-3 shards)
and the ZeRO-1 moments are joined into it and cut again on restore, so
a checkpoint written on one mesh restores on another (elastic restart:
``launch.mesh.elastic_remesh`` keeps TP whole and shrinks dp, and a
``Trainer`` on the new mesh resumes from the checkpoint).
"""
from __future__ import annotations

import copy
import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core import overlap
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.device import resolve_device
from repro_torch.dist import RankGroup, RankMesh
from repro_torch.launch.mesh import make_mesh, mesh_coords
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.optim import schedule as sched
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import TPContext

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainConfig:
    total_steps: int = 100
    warmup_steps: int = 10
    base_lr: float = 3e-4
    schedule: str = "cosine"
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 50
    log_every: int = 10
    straggler_factor: float = 3.0      # step slower than EWMA*factor -> flag
    max_retries: int = 2
    seed: int = 0


def make_ctx(cfg: ModelConfig, par: ParallelConfig,
             group: Optional[RankGroup] = None, plans=None, *,
             mesh: Optional[RankMesh] = None,
             rank: Optional[int] = None) -> TPContext:
    """The reference's ``trainer.make_ctx``: the context over ``group``
    (the TP ranks; None at tp=1), or of mesh rank ``rank`` of ``mesh``
    (needed at dp>1 or pods>1; default the calling rank's), with
    ``plans`` (a ``tuning.plans.PlanSet``; default
    ``plan_set_from_parallel(par)``: the uniform ``par.overlap_mode``
    overlaid with ``par.plan_profile``)."""
    M.check_trainable(cfg, par)
    return sharding.make_ctx(par, group, plans, mesh=mesh, rank=rank)


def forward_on_tape(params: M.Model, batch: Dict[str, torch.Tensor],
                    ctx: TPContext, cfg: ModelConfig, par: ParallelConfig
                    ) -> Tuple[overlap.SeamTape, torch.Tensor]:
    """One rank's ``forward_loss`` with its seams recorded: (tape, loss)."""
    for p in params.parameters():
        p.grad = None
    with overlap.SeamTape() as tape:
        loss = M.forward_loss(params, batch, ctx, cfg, par)
    return tape, loss


def grads_from_tape(params: M.Model, tape: overlap.SeamTape,
                    loss: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The backward of ``forward_on_tape``'s loss, run from this rank's
    thread: the grads keyed as ``named_parameters()``, before the sum over
    the ranks (a model-replicated leaf's grad is this rank's partial)."""
    tape.backward(loss)
    grads = {}
    for n, p in params.named_parameters():
        grads[n] = torch.zeros_like(p) if p.grad is None else p.grad
        p.grad = None
    return grads


def loss_and_grads(params: M.Model, batch: Dict[str, torch.Tensor],
                   ctx: TPContext, cfg: ModelConfig, par: ParallelConfig
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One rank's loss and its grads (``grads_from_tape``)."""
    tape, loss = forward_on_tape(params, batch, ctx, cfg, par)
    return loss.detach(), grads_from_tape(params, tape, loss)


# elements of the leaves one psum of the grad completion carries
PSUM_BUCKET = 1 << 27


def _psum_leaves(grads: Dict[str, torch.Tensor], names: List[str], group,
                 scale: int = 1) -> None:
    """Replace each leaf of ``names`` in ``grads`` by its psum over
    ``group`` in its own dtype (the reference's per-leaf psum), divided by
    ``scale`` (a pmean at the group's size).  The leaves of one dtype
    are joined flat in buckets of at most PSUM_BUCKET elements an
    exchange (a larger leaf alone), and a bucket's leaves are replaced as
    soon as it is summed: beside the grads a rank holds one bucket's flat
    copies at a time."""
    def flush(bucket):
        total = overlap.psum(torch.cat([grads[n].reshape(-1)
                                        for n in bucket]), group)
        if scale != 1:
            adamw.div_(total, scale)
        offset = 0
        for n in bucket:
            k = grads[n].numel()
            grads[n] = total[offset:offset + k].view(grads[n].shape)
            offset += k

    by_dtype: Dict[torch.dtype, List[str]] = {}
    for n in names:
        by_dtype.setdefault(grads[n].dtype, []).append(n)
    for leaves in by_dtype.values():
        bucket, size = [], 0
        for n in leaves:
            if bucket and size + grads[n].numel() > PSUM_BUCKET:
                flush(bucket)
                bucket, size = [], 0
            bucket.append(n)
            size += grads[n].numel()
        if bucket:
            flush(bucket)


@torch.no_grad()
def complete_grads(grads: Dict[str, torch.Tensor],
                   replicated: Dict[str, bool],
                   group: Optional[RankGroup]) -> Dict[str, torch.Tensor]:
    """Sum the model-replicated leaves' grads over the TP ranks (the
    reference's ``psum`` over "model"; ``_psum_leaves``): a new dict, the
    summed leaves new tensors.  The MoE's routed experts are split over
    the ranks (expert parallelism over the TP group), so their grads are
    a rank's own, never summed; on a dedicated ep axis they are whole on
    the TP ranks, and summed."""
    names = [n for n in grads if replicated[n]]
    if group is None or group.n == 1 or not names:
        return grads
    out = dict(grads)
    _psum_leaves(out, names, group)
    return out


def zero1_plan(cfg: ModelConfig, params: M.Model, dp: int,
               par: Optional[ParallelConfig] = None
               ) -> Dict[str, adamw.Zero1Leaf]:
    """How dp data ranks split one rank's leaves (``adamw.zero1_plan`` on
    the reference's stacked layout); with ``par``, the leaves its mesh
    specs split over "data" (ZeRO-3, experts under ``ep_over_dp``) stay
    sharded."""
    named = dict(params.named_parameters())
    sharded = frozenset() if par is None else frozenset(
        n for n, sp in M.mesh_specs(cfg, par).items()
        if "data" in M.spec_axes(sp))
    return adamw.zero1_plan(named, dp, M.stacked_leaves(cfg, named),
                            sharded)


def plan_once(kept: List[Dict[str, adamw.Zero1Leaf]], cfg: ModelConfig,
              params: M.Model, par: ParallelConfig
              ) -> Dict[str, adamw.Zero1Leaf]:
    """``zero1_plan`` of ``params``, built on the first call and kept in
    ``kept`` (every rank's leaves have one shape)."""
    if not kept:
        kept.append(zero1_plan(cfg, params, par.dp, par))
    return kept[0]


@torch.no_grad()
def ep_grads(grads: Dict[str, torch.Tensor], ep_replicated: Dict[str, bool],
             ep) -> Dict[str, torch.Tensor]:
    """The reference's step on a dedicated ep axis, in place (returns
    ``grads``): the pmean over the ``ep`` group of the leaves replicated
    over it and the grad / ep of the routed experts split over it (their
    ``a2a`` backward summed every ep rank's tokens)."""
    if ep is None or ep.n == 1:
        return grads
    _psum_leaves(grads, [n for n in grads if ep_replicated[n]], ep, ep.n)
    for n, g in grads.items():
        if not ep_replicated[n]:
            adamw.div_(g, ep.n)
    return grads


def _pod_data(ctx: TPContext):
    """(pod group, data group) of a context (None where the mesh has no
    such axis)."""
    return ctx.dp_group("pod"), ctx.data_group


def make_train_step(cfg: ModelConfig, par: ParallelConfig,
                    opt_cfg: adamw.AdamWConfig, train_cfg: TrainConfig,
                    mesh: Optional[RankMesh] = None,
                    zero1: Optional[List[Dict[str, adamw.Zero1Leaf]]] = None
                    ) -> Callable:
    """(params, opt, batch, step) -> (params, opt, metrics), run by each
    rank (inside ``mesh.spmd`` at tp>1, dp>1 or pods>1; ``mesh`` None at
    one rank); ``params`` is updated in place.  ``zero1``: a list that
    keeps the ranks' ``zero1_plan`` once built (``plan_once``; shared with
    ``Trainer.zero1``).  The loss in the metrics is the pmean over the
    data-parallel ranks."""
    if mesh is None:
        ctxs = [make_ctx(cfg, par)]
    else:
        first = make_ctx(cfg, par, mesh=mesh, rank=0)
        ctxs = [first] + [make_ctx(cfg, par, plans=first.plans, mesh=mesh,
                                   rank=r) for r in range(1, mesh.size)]
    schedule_fn = sched.get_schedule(train_cfg.schedule)
    kept = [] if zero1 is None else zero1
    specs = M.mesh_specs(cfg, par)
    replicated = M.replicated_leaves(cfg, None, par)
    ep_rep = {n: "ep" not in M.spec_axes(sp) for n, sp in specs.items()}

    def step_fn(params: M.Model, opt: Dict, batch: Dict[str, torch.Tensor],
                step: int):
        ctx = ctxs[0] if mesh is None else ctxs[mesh.rank()]
        ep = ctx.ep_group if par.ep > 1 else None
        loss, grads = loss_and_grads(params, batch, ctx, cfg, par)
        # one statement each: a grad replaced in the dict is freed at once
        grads = complete_grads(grads, replicated, ctx.axis)
        grads = ep_grads(grads, ep_rep, ep)
        for axis in ctx.dp_groups:
            loss = overlap.psum(loss, axis)
        loss = loss / (par.dp * par.pods * par.ep)
        lr = schedule_fn(step, base_lr=train_cfg.base_lr,
                         warmup=train_cfg.warmup_steps,
                         total=train_cfg.total_steps)
        pod, data = _pod_data(ctx)
        _, opt = adamw.adamw_update(dict(params.named_parameters()), grads,
                                    opt, opt_cfg, lr,
                                    replicated=replicated, group=ctx.axis,
                                    data=data, pod=pod,
                                    plan=plan_once(kept, cfg, params, par),
                                    grad_compress=par.grad_compress, ep=ep,
                                    ep_replicated=ep_rep)
        return params, opt, {"loss": loss, "lr": lr,
                             "grad_count": opt["count"]}

    return step_fn


def data_peers(mesh: Optional[RankMesh], r: int) -> List[int]:
    """The ranks that share every coordinate of rank r but data, in data
    order."""
    if mesh is None:
        return [r]
    c = mesh_coords(mesh, r)
    return [q for q in range(mesh.size)
            if all(mesh_coords(mesh, q)[a] == c[a] for a in c if a != "data")]


class RankPieces:
    """One rank's leaves in its weights' layout from the data ranks'
    ZeRO-1 pieces (``held[q]``: data peer q's pieces, its moments or its
    synced grads), a leaf built when it is read: a row shard joined over
    the data peers, a layer from its owner, else the rank's own (a whole
    leaf, or one split over data)."""

    def __init__(self, held: List[Dict[str, torch.Tensor]],
                 plan: Dict[str, adamw.Zero1Leaf], peers: List[int], r: int):
        self.held, self.plan, self.peers, self.r = held, plan, peers, r

    def __iter__(self):
        return iter(self.plan)

    def __getitem__(self, n: str) -> torch.Tensor:
        z = self.plan[n]
        if z.rows:
            return torch.cat([self.held[q][n] for q in self.peers])
        if z.owner is not None:
            return self.held[self.peers[z.owner]][n]
        return self.held[self.r][n]


class Trainer:
    """Runs ``total_steps`` train steps on ``batch_at``'s stream.  The
    state is a list of one ``(Model, optimizer state)`` per rank (mesh
    ranks in row-major order); ``group`` is None at one rank, else the
    ``RankMesh`` of ``launch.mesh.make_mesh(pods, dp, tp, ep=)`` (or ``mesh``,
    e.g. from ``elastic_remesh``; its shape must be the config's), whose
    "model" sub-groups run the seams.  ``failures`` and
    ``straggler_events`` count what ``train`` survived and flagged."""

    def __init__(self, cfg: ModelConfig, par: ParallelConfig,
                 train_cfg: TrainConfig,
                 opt_cfg: Optional[adamw.AdamWConfig] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 mesh: Optional[RankMesh] = None):
        self.cfg, self.par, self.tc = cfg, par, train_cfg
        self.oc = opt_cfg or adamw.AdamWConfig(lr=train_cfg.base_lr)
        self.device = resolve_device(device)
        self.dtype = dtype
        self.step = 0
        self.failures = 0
        self.straggler_events = 0
        self._ewma: Optional[float] = None
        self._zero1: List[Dict[str, adamw.Zero1Leaf]] = []
        self._make_group(mesh)
        self.ckpt = (Checkpointer(train_cfg.checkpoint_dir)
                     if train_cfg.checkpoint_dir else None)
        self.data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=256,
                                   global_batch=8, seed=train_cfg.seed)

    def _make_group(self, mesh: Optional[RankMesh] = None) -> None:
        """A fresh mesh (more than one rank) or ``mesh``, and the step that
        runs on it."""
        par = self.par
        if mesh is None and par.pods * par.ep * par.dp * par.tp > 1:
            mesh = make_mesh(par.pods, par.dp, par.tp, self.device, par.ep)
        self.group = mesh
        self.step_fn = make_train_step(self.cfg, par, self.oc, self.tc,
                                       mesh, self._zero1)

    def zero1(self, params: M.Model) -> Dict[str, adamw.Zero1Leaf]:
        """The ZeRO-1 plan of every rank's leaves (one shape on every
        rank), built once for the trainer and its step."""
        return plan_once(self._zero1, self.cfg, params, self.par)

    # ---- the ranks --------------------------------------------------------
    @property
    def n_ranks(self) -> int:
        return 1 if self.group is None else self.group.size

    def _coord(self, axis: str, r: int) -> int:
        g = self.group
        return g.coord(axis, r) if g is not None and axis in g.axes else 0

    def tp_index(self, r: int) -> int:
        """Rank r's index in its TP group."""
        return self._coord("model", r)

    def data_index(self, r: int) -> int:
        """Rank r's coordinate on the data axis."""
        return self._coord("data", r)

    def shard_index(self, r: int) -> int:
        """Rank r's data shard: (pod · ep + ep index) · dp + data (the
        reference's axis-major ``P(("pod", "ep", "data"))`` batch
        split)."""
        return ((self._coord("pod", r) * self.par.ep + self._coord("ep", r))
                * self.par.dp + self.data_index(r))

    def coords(self, r: int) -> Dict[str, int]:
        """Rank r's index on each mesh axis (0 on an absent one)."""
        return mesh_coords(self.group, r)

    @property
    def sharded_layout(self) -> bool:
        """Do the data replicas hold different pieces (ZeRO-3, a
        dedicated ep axis, experts over data)?"""
        par = self.par
        return par.zero3 or par.ep > 1 or par.ep_over_dp

    def first_replica(self, per_rank: List[Any]) -> List[Any]:
        """The items of the TP ranks of pod 0, data 0, in TP order."""
        return [x for r, x in enumerate(per_rank) if self.shard_index(r) == 0]

    def shard(self, full: M.Model) -> List[M.Model]:
        """Every rank's copy of the global weights ``full``
        (``model.mesh_shard``)."""
        return [M.mesh_shard(full, self.cfg, self.par, self.coords(r))
                for r in range(self.n_ranks)]

    def place(self, tp_ranks: List[M.Model]) -> List[M.Model]:
        """One copy a rank from one a TP rank (``shard_params``' copies):
        the first data replica holds ``tp_ranks`` themselves, the others
        equal copies; in a ``sharded_layout`` each rank's own pieces of
        the weights they join into."""
        if self.sharded_layout:
            named = M.gather_rank_leaves(
                [dict(p.named_parameters()) for p in tp_ranks], self.cfg,
                tp_ranks[0])
            return self.shard(M.rebuild(tp_ranks[0], named))
        return [tp_ranks[self.tp_index(r)] if self.shard_index(r) == 0
                else copy.deepcopy(tp_ranks[self.tp_index(r)])
                for r in range(self.n_ranks)]

    def init_state(self) -> Tuple[List[M.Model], List[Dict]]:
        """Seeded weights (``init_model`` at this tp, cut per TP rank,
        placed on every data replica; in a ``sharded_layout`` each rank's
        pieces) and zero moments."""
        full = M.init_model(self.cfg, self.par, seed=self.tc.seed,
                            dtype=self.dtype, device=self.device,
                            trainable=True)
        tp = self.par.tp
        if self.sharded_layout:
            params = self.shard(full)
        else:
            tp_ranks = ([full] if tp == 1 else
                        [M.shard_params(full, r, tp, self.cfg)
                         for r in range(tp)])
            params = self.place(tp_ranks)
        del full
        return params, [self.init_opt(p, r) for r, p in enumerate(params)]

    def init_opt(self, params: M.Model, r: int = 0) -> Dict:
        """Zero moments for rank r's leaves (at dp>1 the pieces its data
        rank holds under ZeRO-1)."""
        return adamw.init_opt_state(
            dict(params.named_parameters()), self.oc.moment_dtype,
            self.zero1(params), self.par.dp,
            self.data_index(r))

    def batch(self, step: int, shard: int = 0, num_shards: int = 1
              ) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device) for k, v in
                batch_at(self.data_cfg, step, shard, num_shards).items()}

    def step_batch(self, step: int) -> List[Dict[str, torch.Tensor]]:
        """The step's input: every data shard's batch (``batch_at`` at
        ``shard_index`` of pods · ep · dp)."""
        n = self.par.pods * self.par.ep * self.par.dp
        return [self.batch(step, s, n) for s in range(n)]

    # ------------------------------------------------------------ checkpoint
    def global_leaves(self, per_rank: List[Dict[str, Any]]
                      ) -> Dict[str, torch.Tensor]:
        """Every rank's leaves (weights, grads or moments, keyed as
        ``named_parameters()``, in the rank's layout) joined into the
        global tp-packed ones (``model.mesh_join``)."""
        return M.mesh_join(per_rank, [self.coords(r)
                                      for r in range(len(per_rank))],
                           self.cfg, self.par)

    def _global(self, per_rank: List[Dict[str, Any]]) -> Dict[str, Any]:
        return M.reference_tree(self.global_leaves(per_rank), self.cfg)

    def _moments(self, params: List[M.Model], opt: List[Dict], key: str
                 ) -> List[RankPieces]:
        """Each rank's moments in its weights' layout (``RankPieces``)."""
        plan = self.zero1(params[0])
        held = [o[key] for o in opt]
        return [RankPieces(held, plan, data_peers(self.group, r), r)
                for r in range(len(params))]

    def checkpoint_tree(self, params: List[M.Model],
                        opt: List[Dict]) -> Dict[str, Any]:
        """The reference's checkpoint tree of the ranks' state:
        ``{"params": the global tp-packed tree (periods stacked), "opt":
        {"mu", "nu": the same, "count": int32 scalar}}``, each leaf in its
        own dtype: the ranks' pieces joined (``global_leaves``), the
        ZeRO-1 moments joined over data first."""
        return {"params": self._global([dict(p.named_parameters())
                                        for p in params]),
                "opt": {"mu": self._global(self._moments(params, opt, "mu")),
                        "nu": self._global(self._moments(params, opt, "nu")),
                        "count": np.asarray(opt[0]["count"], np.int32)}}

    def _tree_like(self, params: List[M.Model]) -> Dict[str, Any]:
        """``checkpoint_tree``'s shapes and dtypes, on the meta device."""
        moment = getattr(torch, self.oc.moment_dtype)

        def meta(p: M.Model, dtype=None):
            return {n: torch.empty(t.shape, dtype=dtype or t.dtype,
                                   device="meta")
                    for n, t in p.named_parameters()}

        mom = self._global([meta(p, moment) for p in params])
        return {"params": self._global([meta(p) for p in params]),
                "opt": {"mu": mom, "nu": mom,
                        "count": np.zeros((), np.int32)}}

    def save(self, params: List[M.Model], opt: List[Dict]) -> None:
        """Checkpoint the state after ``self.step`` steps (asynchronous)."""
        self.ckpt.save(self.step, self.checkpoint_tree(params, opt),
                       extra={"step": self.step})

    @torch.no_grad()
    def restore(self, params: List[M.Model],
                step: Optional[int] = None) -> List[Dict]:
        """Load a checkpoint (the latest by default) into ``params`` in
        place, each rank's pieces cut by ``model.mesh_cut`` and, for the
        ZeRO-1 moments, per data rank (``zero1_plan``); sets ``self.step``
        and returns the ranks' optimizer states.  The checkpoint's shapes
        must be this tp's (padding included); its dp may be any (elastic
        restart)."""
        tree, self.step, _ = self.ckpt.restore(self._tree_like(params), step)
        dp = self.par.dp

        def cut(sub, r):
            return M.mesh_cut(M.named_leaves(sub, self.cfg), self.cfg,
                              self.par, self.coords(r))

        for r, p in enumerate(params):
            weights = cut(tree["params"], r)
            for n, t in p.named_parameters():
                t.copy_(weights[n])
        moment = getattr(torch, self.oc.moment_dtype)
        plan = self.zero1(params[0])

        def to_dev(sub, r):
            out, d = {}, self.data_index(r)
            for n, t in cut(sub, r).items():
                if not plan[n].holds(d):
                    continue
                if plan[n].rows:
                    t = t.chunk(dp)[d]
                out[n] = t.to(self.device, moment, copy=True)
            return out

        count = int(tree["opt"]["count"])
        return [{"mu": to_dev(tree["opt"]["mu"], r),
                 "nu": to_dev(tree["opt"]["nu"], r), "count": count}
                for r in range(len(params))]

    # ------------------------------------------------------------------ loop
    def run_step(self, params: List[M.Model], opt: List[Dict], batch
                 ) -> Tuple[List[Dict], Dict[str, torch.Tensor]]:
        """One step on every rank; returns the new optimizer states and
        rank 0's metrics (every rank's loss is the same).  ``batch``: the
        data shards' (``step_batch``)."""
        step = self.step
        if self.group is None:
            _, o, m = self.step_fn(params[0], opt[0], batch[0], step)
            return [o], m
        args = [(p, o, batch[self.shard_index(r)])
                for r, (p, o) in enumerate(zip(params, opt))]
        outs = self.group.spmd(lambda p, o, b: self.step_fn(p, o, b, step),
                               args)
        return [o for _, o, _ in outs], outs[0][2]

    def train(self, params: Optional[List[M.Model]] = None,
              opt: Optional[List[Dict]] = None, resume: bool = True,
              fault_hook: Optional[Callable[[int], None]] = None
              ) -> Tuple[List[M.Model], List[Dict], List[Dict]]:
        """Run to ``total_steps``, resuming from the latest checkpoint when
        there is one and ``resume``.  ``fault_hook(step)`` may raise to
        simulate a failure; recovery reloads the last checkpoint and
        reseeks the data stream.  Returns (params, opt, metrics history:
        loss, lr, grad_count and the step's host seconds, a dict a
        step)."""
        if params is None:
            params, opt = self.init_state()
        if self.ckpt and resume and self.ckpt.latest_step() is not None:
            opt = self.restore(params)
            log.info("resumed at step %d", self.step)
        hist = []
        while self.step < self.tc.total_steps:
            t0 = time.perf_counter()
            batch = self.step_batch(self.step)
            try:
                if fault_hook is not None:
                    fault_hook(self.step)
                opt, metrics = self.run_step(params, opt, batch)
                metrics = {k: float(v) for k, v in metrics.items()}
            except Exception as e:  # noqa: BLE001 — any failure recovers
                self.failures += 1
                if self.failures > self.tc.max_retries:
                    raise
                log.warning("step %d failed (%s); recovering", self.step, e)
                params, opt = self._recover(params)
                continue

            # host seconds of the step, to its loss on the host
            dt = time.perf_counter() - t0
            if self._ewma is None:
                self._ewma = dt
            elif dt > self.tc.straggler_factor * self._ewma:
                self.straggler_events += 1
                log.warning("straggler: step %d took %.3fs (ewma %.3fs)",
                            self.step, dt, self._ewma)
            self._ewma = 0.9 * self._ewma + 0.1 * dt

            self.step += 1
            hist.append(dict(metrics, seconds=dt))
            if self.ckpt and self.step % self.tc.checkpoint_every == 0:
                self.save(params, opt)
            if self.step % self.tc.log_every == 0:
                log.info("step %d loss %.4f", self.step, hist[-1]["loss"])
        if self.ckpt:
            self.ckpt.wait()
        return params, opt, hist

    def _recover(self, params: List[M.Model]
                 ) -> Tuple[List[M.Model], List[Dict]]:
        """After a failed step: at more than one rank a new mesh of the same
        shape (a rank that failed inside the step leaves the
        others' exchanges, and the fused kernels' flag epochs, mid-way);
        then the last checkpoint, loaded
        over every weight and moment, or a fresh init at step 0.  A save
        still being written is waited for: until its rename it is not the
        last checkpoint."""
        if self.group is not None:
            self.group.free_symmetric()
            self._make_group()
        if self.ckpt:
            self.ckpt.wait()
        if self.ckpt and self.ckpt.latest_step() is not None:
            return params, self.restore(params)
        self.step = 0
        return self.init_state()

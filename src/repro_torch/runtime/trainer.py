"""Training runtime (port of ``repro.runtime.trainer``) at dp=1.

One train step is ``forward_loss``, its backward, the sum over the TP
ranks of the model-replicated leaves' grads, the LR schedule and
``adamw_update``, with the weights and the optimizer state updated in
place (the reference donates them).  At tp>1 ``Trainer`` owns the
``dist.RankGroup`` and runs each rank's step inside ``group.spmd`` on the
rank's ``model.shard_params`` copy; the step records the forward's seams
on a ``core.overlap.SeamTape`` and drives the backward from the rank's
own thread (the autograd engine runs a card's CUDA nodes on one device
thread, where the ranks' exchanges cannot meet).

Left out: the checkpointer (``checkpoint_dir`` raises; ROADMAP queue 1
item 5), and the fault tolerance around the step — retry and reload, the
straggler watchdog, elastic restart (queue 1 item 10).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core import overlap
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.device import resolve_device
from repro_torch.dist import RankGroup
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.optim import schedule as sched
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import TPContext

log = logging.getLogger("repro_torch.trainer")

CKPT_NOT_PORTED = ("checkpointing (TrainConfig.checkpoint_dir) is not "
                   "ported (ROADMAP queue 1 item 5)")


@dataclasses.dataclass
class TrainConfig:
    total_steps: int = 100
    warmup_steps: int = 10
    base_lr: float = 3e-4
    schedule: str = "cosine"
    checkpoint_dir: Optional[str] = None
    log_every: int = 10
    seed: int = 0


def make_ctx(cfg: ModelConfig, par: ParallelConfig,
             group: Optional[RankGroup] = None) -> TPContext:
    """The reference's ``trainer.make_ctx`` at dp=1: the TP context over
    ``group`` (None at tp=1) on ``par.overlap_mode``'s transport."""
    M.check_trainable(cfg, par)
    return sharding.make_ctx(par, group)


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


@torch.no_grad()
def complete_grads(grads: Dict[str, torch.Tensor],
                   replicated: Dict[str, bool],
                   group: Optional[RankGroup]) -> Dict[str, torch.Tensor]:
    """Sum the model-replicated leaves' grads over the TP ranks (the
    reference's ``psum`` over "model"), all of them in one exchange."""
    names = [n for n in grads if replicated[n]]
    if group is None or group.n == 1 or not names:
        return grads
    total = overlap.psum(torch.cat([grads[n].reshape(-1) for n in names]),
                         group)
    out, offset = dict(grads), 0
    for n in names:
        k = grads[n].numel()
        out[n] = total[offset:offset + k].view_as(grads[n])
        offset += k
    return out


def make_train_step(cfg: ModelConfig, par: ParallelConfig,
                    opt_cfg: adamw.AdamWConfig, train_cfg: TrainConfig,
                    group: Optional[RankGroup] = None) -> Callable:
    """(params, opt, batch, step) -> (params, opt, metrics), run by each
    rank (inside ``group.spmd`` at tp>1); ``params`` is updated in
    place."""
    ctx = make_ctx(cfg, par, group)
    schedule_fn = sched.get_schedule(train_cfg.schedule)

    def step_fn(params: M.Model, opt: Dict, batch: Dict[str, torch.Tensor],
                step: int):
        replicated = M.replicated_leaves(cfg, params)
        loss, grads = loss_and_grads(params, batch, ctx, cfg, par)
        grads = complete_grads(grads, replicated, ctx.axis)
        lr = schedule_fn(step, base_lr=train_cfg.base_lr,
                         warmup=train_cfg.warmup_steps,
                         total=train_cfg.total_steps)
        _, opt = adamw.adamw_update(dict(params.named_parameters()), grads,
                                    opt, opt_cfg, lr, replicated=replicated,
                                    group=ctx.axis)
        return params, opt, {"loss": loss, "lr": lr,
                             "grad_count": opt["count"]}

    return step_fn


class Trainer:
    """Runs ``total_steps`` train steps on ``batch_at``'s stream.  The
    state is a list of one ``(Model, optimizer state)`` per rank."""

    def __init__(self, cfg: ModelConfig, par: ParallelConfig,
                 train_cfg: TrainConfig,
                 opt_cfg: Optional[adamw.AdamWConfig] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.bfloat16):
        if train_cfg.checkpoint_dir is not None:
            raise NotImplementedError(CKPT_NOT_PORTED)
        self.cfg, self.par, self.tc = cfg, par, train_cfg
        self.oc = opt_cfg or adamw.AdamWConfig(lr=train_cfg.base_lr)
        self.device = resolve_device(device)
        self.dtype = dtype
        self.step = 0
        self.group = RankGroup(par.tp, self.device) if par.tp > 1 else None
        self.step_fn = make_train_step(cfg, par, self.oc, train_cfg,
                                       self.group)
        self.data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=256,
                                   global_batch=8, seed=train_cfg.seed)

    def init_state(self) -> Tuple[List[M.Model], List[Dict]]:
        """Seeded weights (``init_model`` at this tp, cut per rank) and
        zero moments."""
        full = M.init_model(self.cfg, self.par, seed=self.tc.seed,
                            dtype=self.dtype, device=self.device,
                            trainable=True)
        tp = self.par.tp
        params = ([full] if tp == 1 else
                  [M.shard_params(full, r, tp, self.cfg) for r in range(tp)])
        del full
        return params, [self.init_opt(p) for p in params]

    def init_opt(self, params: M.Model) -> Dict:
        return adamw.init_opt_state(dict(params.named_parameters()),
                                    self.oc.moment_dtype)

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch_at(self.data_cfg, step).items()}

    def run_step(self, params: List[M.Model], opt: List[Dict],
                 batch: Dict[str, torch.Tensor]
                 ) -> Tuple[List[Dict], Dict[str, torch.Tensor]]:
        """One step on every rank; returns the new optimizer states and
        rank 0's metrics (every rank's loss is the same)."""
        step = self.step
        if self.group is None:
            _, o, m = self.step_fn(params[0], opt[0], batch, step)
            return [o], m
        outs = self.group.spmd(
            lambda p, o: self.step_fn(p, o, batch, step),
            list(zip(params, opt)))
        return [o for _, o, _ in outs], outs[0][2]

    def train(self, params: Optional[List[M.Model]] = None,
              opt: Optional[List[Dict]] = None) -> Tuple[List[M.Model],
                                                         List[Dict],
                                                         List[Dict]]:
        """Run to ``total_steps``; returns (params, opt, metrics history:
        loss, lr, grad_count and the step's host seconds, a dict a
        step)."""
        if params is None:
            params, opt = self.init_state()
        hist = []
        while self.step < self.tc.total_steps:
            t0 = time.perf_counter()
            opt, metrics = self.run_step(params, opt, self.batch(self.step))
            self.step += 1
            hist.append({k: float(v) for k, v in metrics.items()})
            # host seconds of the step, to its loss on the host
            hist[-1]["seconds"] = time.perf_counter() - t0
            if self.step % self.tc.log_every == 0:
                log.info("step %d loss %.4f", self.step, hist[-1]["loss"])
        return params, opt, hist

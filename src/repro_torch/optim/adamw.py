"""AdamW (port of ``repro.optim.adamw``) at dp=1.

Runs as one rank of the TP group (inside ``group.spmd`` at tp>1) on that
rank's leaves, keyed by name (``Model.named_parameters()``):

  phase 1 — the gradients arrive complete: the trainer has psum'd the
    model-replicated leaves' grads over the TP ranks.  There is no data
    axis, so no reduce-scatter and no pod all-reduce.
  phase 2 — global grad-norm clip: each leaf's squared sum, weighted by
    1/tp for a model-replicated leaf (every rank holds the same grad), is
    summed over the rank group, so every element counts once (a rank's
    routed experts, like every tp-split leaf, count on their rank).
  phase 3 — AdamW in fp32 (moments in ``moment_dtype``), the new values
    cast back to the parameter's and the moments' dtypes and written in
    place (the reference donates the buffers): the step never holds two
    copies of the moments, and a leaf is updated ``UPDATE_CHUNK``
    elements at a time, so that its fp32 temporaries stay small when
    every rank of the group updates at once on one card.

Not ported (ROADMAP queue 1 item 10): the ZeRO-1 reduce-scatter over a
data axis (dp>1), the pod all-reduce and its int8 compression.  A dp>1
config raises in ``sharding.make_ctx``, and the training CLI refuses
``--dp``, ``--pods`` and ``--grad-compress``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.core import overlap


# elements of a leaf updated at once (a few fp32 temporaries of 256 MB)
UPDATE_CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"


def init_opt_state(params: Dict[str, torch.Tensor],
                   moment_dtype: str = "float32") -> Dict:
    """Zero moments shaped like each leaf, in ``moment_dtype``."""
    dt = getattr(torch, moment_dtype)

    def zeros():
        return {n: torch.zeros(p.shape, dtype=dt, device=p.device)
                for n, p in params.items()}
    return {"mu": zeros(), "nu": zeros(), "count": 0}


def grad_norm(grads: Dict[str, torch.Tensor], replicated: Dict[str, bool],
              group=None) -> torch.Tensor:
    """The global L2 norm of the grads over the rank group: a
    model-replicated leaf's squared sum counts 1/tp on each rank.  A leaf
    is summed ``UPDATE_CHUNK`` elements at a time (small fp32
    temporaries)."""
    tp = 1 if group is None else group.n
    total = None
    for n, g in grads.items():
        s = sum(torch.sum(torch.square(c.float()))
                for c in g.reshape(-1).split(UPDATE_CHUNK))
        if replicated[n] and tp > 1:
            s = s / tp
        total = s if total is None else total + s
    if tp > 1:
        total = overlap.psum(total, group)
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
                 group=None) -> Tuple[Dict, Dict]:
    """One AdamW step on ``params`` and the moments (both updated in
    place) with ``grads``; returns (params, new optimizer state).
    ``replicated[name]`` is True for a model-replicated leaf
    (``model.param_specs`` dim None)."""
    gnorm = grad_norm(grads, replicated, group)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-6), max=1.0)
    count = opt["count"] + 1
    cnt = torch.tensor(float(count), dtype=torch.float32)
    c1 = (1.0 - torch.tensor(cfg.b1, dtype=torch.float32) ** cnt).item()
    c2 = (1.0 - torch.tensor(cfg.b2, dtype=torch.float32) ** cnt).item()
    device = next(iter(params.values())).device
    lr = torch.as_tensor(lr, dtype=torch.float32).to(device)
    mu_out, nu_out = {}, {}
    for n, p in params.items():
        mu, nu = opt["mu"][n], opt["nu"][n]
        flat = [t.view(-1) for t in (p, mu, nu)] + [grads[n].reshape(-1)]
        for lo in range(0, p.numel(), UPDATE_CHUNK):
            _update(*(t[lo:lo + UPDATE_CHUNK] for t in flat), clip, c1, c2,
                    lr, cfg)
        mu_out[n], nu_out[n] = mu, nu
    return params, {"mu": mu_out, "nu": nu_out, "count": count}

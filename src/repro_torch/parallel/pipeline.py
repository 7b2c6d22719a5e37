"""Pipeline parallelism, GPipe fill-drain over a rank group (port of
``repro.parallel.pipeline``).

The reference reads the pod axis as pipeline stages at 1000+ nodes: each
stage holds a contiguous slice of layers, and microbatches stream
through it, each stage's output sent to the next stage by a
``ppermute``.  It composes with the TP seams inside a stage (the paper's
§7: "Flux can be applied in addition").  With M microbatches and P
stages the bubble fraction is (P - 1) / (M + P - 1).

The port runs the stages as the ranks of a ``dist.RankGroup`` (the pod
view of a ``RankMesh``: ``mesh.group("pod")``).  A tick in which a stage
holds no microbatch computes nothing (the reference computes and masks
it: the same values).  Like the reference, which never trains through
it, the pipeline is forward only: it raises under grad.
"""
from __future__ import annotations

from typing import Callable

import torch

GRAD_REFUSED = ("pipeline_forward is forward only, as the reference's is "
                "(its trainer never runs through it): call it under "
                "torch.no_grad()")


def _refuse_grad(t: torch.Tensor) -> None:
    if torch.is_grad_enabled() and t.requires_grad:
        raise NotImplementedError(GRAD_REFUSED)


def pipeline_forward(stage_fn: Callable[[torch.Tensor, int], torch.Tensor],
                     x: torch.Tensor, group, num_microbatches: int
                     ) -> torch.Tensor:
    """Run ``stage_fn(h, tick)`` (this rank's slice of layers) as one stage
    of a GPipe pipeline over ``group`` (stage = the rank's index).

    x: [B, ...], the stage-0 input (the other stages ignore theirs); B a
    multiple of ``num_microbatches``.  Returns the LAST stage's output
    [B, ...] on the last stage, zeros on the others (the reference's
    contract)."""
    _refuse_grad(x)
    p = 1 if group is None else group.n
    stage = 0 if group is None else group.rank()
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(f"batch {b} is not a multiple of "
                         f"{num_microbatches} microbatches")
    micro = x.reshape(num_microbatches, b // num_microbatches, *x.shape[1:])
    out = torch.zeros_like(micro)
    # a full ring: the last stage's send to stage 0 is never read
    perm = [(i, (i + 1) % p) for i in range(p)]
    buf = torch.zeros_like(micro[0])
    for t in range(num_microbatches + p - 1):
        x_in = micro[min(t, num_microbatches - 1)] if stage == 0 else buf
        if 0 <= t - stage < num_microbatches:
            y = stage_fn(x_in, t)
            _refuse_grad(y)
            if stage == p - 1:
                out[t - stage] = y
        else:
            y = torch.zeros_like(buf)
        if p > 1:
            # the stage boundary: the PIPELINE axis, not a TP seam
            buf = group.ppermute(y, perm, "pipeline")
    return out.reshape(b, *x.shape[1:])


def bubble_fraction(num_microbatches: int, stages: int) -> float:
    """The GPipe schedule's idle share: (P - 1) / (M + P - 1)."""
    return (stages - 1) / (num_microbatches + stages - 1)

"""Per-seam overlap planner (port of ``repro.core.planner``; paper §4.4).

``plan_seam`` picks a mode and its knobs for one TP seam from the
``core.ect`` roofline priced on ``hw`` (an ``ect.Hardware``, passed with
no default, as in ``core.ect``: ``ect.H100_SXM`` for the card);
``measure=True`` runs the measured sweep of ``tuning.autotune`` on
``group``, the ``dist.RankGroup`` of ``n_dev`` ranks.  ``blocks`` is the
tile the Hopper kernels pick themselves (``kernels.matmul.plan_blocks``
as ``(bm, BK, bn)``; None under fp32).  The richer subsystem (candidate
spaces over every mode and fusion knob, profiles, PlanSets) is
``repro_torch.tuning``; this module stays the lightweight analytic core.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.core import ect


@dataclasses.dataclass(frozen=True)
class Plan:
    mode: str
    comm_chunks: int
    reverse: bool
    blocks: Optional[Tuple[int, int, int]]
    predicted_overall_s: float
    predicted_overlap_eff: float
    measured_s: float = 0.0
    source: str = "analytic"         # analytic | measured


_CACHE: Dict[tuple, Plan] = {}


def plan_seam(seam: str, m: int, n: int, k: int, n_dev: int,
              dtype_bytes: int = 2, allow_flux: bool = True,
              measure: bool = False, reverse: Optional[bool] = None,
              wire_dtype: Optional[str] = None, *, hw: ect.Hardware,
              group=None) -> Plan:
    """Pick the best strategy for one TP seam (``seam`` is the kind: "ag",
    "rs", "ar").  ``reverse`` pins the ring direction (None lets the tuner
    choose; the roofline is direction-symmetric, so the analytic plan
    keeps the pinned value or False).  ``wire_dtype`` pins the wire the
    roofline prices (None: the fp wire; flux candidates always price the
    fp wire; the accuracy-gated wire sweep is ``tuning.autotune``'s, and
    the measured path never picks a wire).  The cache is keyed by the
    wire, the hardware and the group too: a plan priced for one wire or
    card never answers for another."""
    key = (seam, m, n, k, n_dev, dtype_bytes, allow_flux, bool(measure),
           reverse, wire_dtype, hw, None if group is None else id(group))
    if key in _CACHE:
        return _CACHE[key]

    if measure:
        from repro_torch.tuning import autotune
        res = autotune.tune_seam(seam, m, n, k, n_dev, hw=hw, group=group,
                                 dtype_bytes=dtype_bytes,
                                 allow_flux=allow_flux, measure=True)
        sp = res.plan
        if reverse is not None and sp.reverse != reverse:
            # pinned direction: keep the best candidate matching it
            rows = [r for r in res.table if r["reverse"] == reverse]
            if rows:
                best = min(rows, key=lambda r: r["measured_s"])
                sp = dataclasses.replace(
                    sp, mode=best["mode"], comm_chunks=best["comm_chunks"],
                    reverse=best["reverse"],
                    blocks=best["blocks"] or sp.blocks,
                    measured_s=best["measured_s"],
                    predicted_s=best["predicted_s"])
        plan = Plan(mode=sp.mode, comm_chunks=sp.comm_chunks,
                    reverse=sp.reverse, blocks=sp.blocks,
                    predicted_overall_s=sp.predicted_s,
                    predicted_overlap_eff=0.0,
                    measured_s=sp.measured_s, source="measured")
        _CACHE[key] = plan
        return plan

    candidates = []
    modes = ["xla", "decomposed"] + (["flux"] if allow_flux else [])
    for mode in modes:
        chunk_opts = ([0] if mode != "decomposed"
                      else [n_dev, 2 * n_dev, 4 * n_dev])
        wd = wire_dtype if mode != "flux" else None
        for chunks in chunk_opts:
            est = ect.model_overlap(seam, m, n, k, n_dev, mode,
                                    dtype_bytes, comm_chunks=chunks,
                                    wire_dtype=wd, hw=hw)
            candidates.append((est["overall"], mode, chunks, est))

    candidates.sort(key=lambda c: c[0])
    overall, mode, chunks, est = candidates[0]

    from repro_torch.tuning.autotune import default_blocks
    plan = Plan(mode=mode, comm_chunks=chunks, reverse=bool(reverse),
                blocks=default_blocks(seam, m, n, n_dev, dtype_bytes),
                predicted_overall_s=overall,
                predicted_overlap_eff=est["overlap_eff"])
    _CACHE[key] = plan
    return plan


def plan_model(d_model: int, d_ff: int, tokens_per_dp: int, n_dev: int,
               allow_flux: bool = True, *, hw: ect.Hardware
               ) -> Dict[str, Plan]:
    """Plans for the two MLP seams of the paper's Fig. 2 (their backward
    interchanges reuse them transposed)."""
    return {
        "mlp_ag": plan_seam("ag", tokens_per_dp, d_ff, d_model, n_dev,
                            allow_flux=allow_flux, hw=hw),
        "mlp_rs": plan_seam("rs", tokens_per_dp, d_model, d_ff, n_dev,
                            allow_flux=allow_flux, hw=hw),
    }

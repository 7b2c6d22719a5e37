"""Per-seam overlap plan registry and tuner (port of ``repro.tuning``;
paper §4.4).

FLUX's speedups come from tuning: per (GEMM shape, dtype, arch,
interconnect) it picks the template parameters, the ring direction and
the communication tile size, and caches them.  The port's subsystem:

  plans.py     ``SeamPlan`` (one seam's knobs) and ``PlanSet`` (the
               per-layer-seam table ``TPContext.plans`` resolves).
  autotune.py  the tuner: ``(mode, comm_chunks, reverse, blocks,
               shared_gather, fuse_epilogue)`` candidates per seam, timed
               on a ``dist.RankGroup`` (CUDA events on the card) or priced
               by the ``core.ect`` roofline on an explicit ``Hardware``.
  cache.py     the JSON profile cache (``experiments/plans_torch/``,
               git-ignored), the reference's schema and staleness rules
               with the backend "cuda" or "cpu".
  error_budget.py  the deviation estimates that gate the ``wire_dtype``
               sweep (``codec_rmse``, ``seam_wire_rmse``,
               ``model_logit_rmse``).
"""
from repro_torch.tuning.plans import (  # noqa: F401
    KNOWN_SEAMS, RESIDUAL_SEAMS, SEAM_KINDS, PlanSet, SeamPlan,
    plan_set_from_parallel, seam_of)
from repro_torch.tuning.cache import (PROFILE_VERSION,  # noqa: F401
                                      PlanRegistry, default_plans_dir)
from repro_torch.tuning.autotune import (WIRE_DTYPE_SWEEP,  # noqa: F401
                                         TuneResult, autotune_model,
                                         candidate_space, model_seam_shapes,
                                         sweep_model_layout, tune_seam,
                                         wire_supported)
from repro_torch.tuning import error_budget  # noqa: F401

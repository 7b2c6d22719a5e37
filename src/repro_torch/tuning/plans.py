"""SeamPlan / PlanSet: the per-layer-seam plan table (port of
``repro.tuning.plans``).

``TPContext.plans`` holds a ``PlanSet``; every TP seam of the model
resolves its knobs through ``PlanSet.resolve(seam, layer)``.  Seam names
are model-level (what the layer is doing), not collective-level:

  mlp_ag    FFN up-projection AllGather-GEMM (w1/w3/w13; the RWKV
            channel-mix's w_k with its squared-ReLU epilogue)
  mlp_rs    FFN down-projection GEMM-ReduceScatter (w2; RWKV's w_v)
  attn_ag   mixer input projection AllGather-GEMM (QKV / MLA up / mamba
            in: w_in_x and w_in_z over one shared gather / the RWKV
            time-mix's five token-shift projections r, k, v, g and
            w_dec1 over one shared gather of [h | prev])
  attn_rs   mixer output projection GEMM-ReduceScatter (wo / w_o / w_out)
  decode_ar row-parallel GEMM + AllReduce seams (the decode paths of every
            mixer and FFN, RWKV's w_o and channel w_v among them, plus
            mamba's train-path x-projection AR)
  head_ag   LM-head AllGather-GEMM (the biggest single GEMM)
  moe_a2a   MoE expert-parallel token exchange

Unknown seams fall back to the set's default.

Layer ids are the reference's: a leading layer is its index; a layer of
the repeated pattern is ``leading_dense_layers + position`` for every
repetition (the reference's ``lax.scan`` shares one trace per pattern
position; ``models.model.layer_slot`` maps the port's unstacked layers).

The JSON is the reference's, field for field, so a profile written by
either package opens in the other, its wires included.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

from repro_torch.core.overlap import (VALID_MODES, VALID_SCATTER_AXES,
                                      VALID_WIRE_DTYPES, FusedOp)

KNOWN_SEAMS: Tuple[str, ...] = ("mlp_ag", "mlp_rs", "attn_ag", "attn_rs",
                                "decode_ar", "head_ag", "moe_a2a")

# collective kind behind each model seam (candidate spaces differ per kind)
SEAM_KINDS: Dict[str, str] = {"mlp_ag": "ag", "mlp_rs": "rs",
                              "attn_ag": "ag", "attn_rs": "rs",
                              "decode_ar": "ar", "head_ag": "ag",
                              "moe_a2a": "a2a"}

# the seams that carry the residual stream between blocks: their
# ``scatter_axis`` plans must agree (one activation layout per model)
RESIDUAL_SEAMS: Tuple[str, ...] = ("mlp_ag", "mlp_rs", "attn_ag", "attn_rs",
                                   "head_ag")


def seam_of(key: str) -> str:
    """Model seam behind a (possibly shape-cell-qualified) seam key:
    ``"attn_ag@kv_up" -> "attn_ag"``."""
    return key.split("@", 1)[0]


@dataclasses.dataclass(frozen=True)
class SeamPlan:
    """Knob settings for ONE seam (the paper's §4.4 tuning record).

    ``mode`` / ``comm_chunks`` / ``reverse`` / ``blocks`` /
    ``fuse_epilogue`` / ``shared_gather`` are ``core.overlap.FusedOp``'s
    knobs.  ``blocks`` is ``(bm, bk, bn)``: under ``flux`` on the card
    ``(bm, bn)`` must be one of the Hopper tiles
    (``kernels.matmul.TILES``) and ``bk`` is the tile loop's K step; a
    TPU tile from a reference profile never reaches the card, because a
    profile tuned on another backend is stale (``tuning.cache``).
    ``scatter_axis`` is the activation layout, swept jointly across the
    residual seams (``PlanSet.residual_layout``).  ``wire_dtype`` (None |
    "int8" | "fp8_e4m3" | "int4") quantizes the seam's forward wire,
    swept by the tuner under a logit-RMSE budget
    (``tuning.error_budget``); ``logit_rmse`` records the deviation the
    tuner estimated for the chosen wire (0.0 for the fp wire)."""
    mode: str = "decomposed"
    comm_chunks: int = 0
    reverse: bool = False
    blocks: Optional[Tuple[int, int, int]] = None
    fuse_epilogue: bool = True
    shared_gather: bool = True
    scatter_axis: str = "seq"
    wire_dtype: Optional[str] = None
    source: str = "default"          # default | analytic | measured
    predicted_s: float = 0.0
    measured_s: float = 0.0
    logit_rmse: float = 0.0

    def validate(self) -> "SeamPlan":
        if self.mode not in VALID_MODES:
            raise ValueError(f"invalid overlap mode {self.mode!r}")
        if self.wire_dtype not in VALID_WIRE_DTYPES:
            raise ValueError(f"invalid wire_dtype {self.wire_dtype!r}")
        if self.comm_chunks < 0:
            raise ValueError(
                f"comm_chunks must be >= 0, got {self.comm_chunks}")
        if self.scatter_axis not in VALID_SCATTER_AXES:
            raise ValueError(f"invalid scatter_axis {self.scatter_axis!r}")
        if self.blocks is not None:
            object.__setattr__(self, "blocks", tuple(self.blocks))
        return self

    def op(self, kind: str, axis=None, epilogue=None, n_weights: int = 1,
           scatter_axis: Optional[str] = None):
        """Bind this plan to a ``core.overlap.FusedOp`` for one seam;
        ``scatter_axis`` overrides the plan's layout knob (the context
        passes the model's resolved layout so every seam stays
        coherent)."""
        return FusedOp.from_plan(kind, self, axis, epilogue=epilogue,
                                 n_weights=n_weights,
                                 scatter_axis=scatter_axis)

    def to_json(self) -> Dict:
        d = {"mode": self.mode, "comm_chunks": self.comm_chunks,
             "reverse": self.reverse, "source": self.source,
             "fuse_epilogue": self.fuse_epilogue,
             "shared_gather": self.shared_gather,
             "scatter_axis": self.scatter_axis,
             "wire_dtype": self.wire_dtype,
             "predicted_s": self.predicted_s, "measured_s": self.measured_s,
             "logit_rmse": self.logit_rmse}
        d["blocks"] = list(self.blocks) if self.blocks else None
        return d

    @staticmethod
    def from_json(d: Mapping) -> "SeamPlan":
        blocks = d.get("blocks")
        # profiles written before the wire_dtype field load as the fp wire
        return SeamPlan(mode=d["mode"],
                        comm_chunks=int(d.get("comm_chunks", 0)),
                        reverse=bool(d.get("reverse", False)),
                        blocks=tuple(blocks) if blocks else None,
                        fuse_epilogue=bool(d.get("fuse_epilogue", True)),
                        shared_gather=bool(d.get("shared_gather", True)),
                        scatter_axis=d.get("scatter_axis", "seq"),
                        wire_dtype=d.get("wire_dtype"),
                        source=d.get("source", "default"),
                        predicted_s=float(d.get("predicted_s", 0.0)),
                        measured_s=float(d.get("measured_s", 0.0)),
                        logit_rmse=float(d.get("logit_rmse", 0.0))).validate()


def _stamp(plans: "PlanSet", fn) -> "PlanSet":
    """``fn`` applied to every plan of the set (default, seams, layers)."""
    return PlanSet(default=fn(plans.default),
                   seams={s: fn(p) for s, p in plans.seams.items()},
                   layers={l: {s: fn(p) for s, p in ov.items()}
                           for l, ov in plans.layers.items()})


@dataclasses.dataclass(frozen=True)
class PlanSet:
    """Per-seam (optionally per-layer) plan table.

    Resolution order: ``layers[layer][seam]`` -> ``seams[seam]`` -> default.
    """
    default: SeamPlan = SeamPlan()
    seams: Mapping[str, SeamPlan] = dataclasses.field(default_factory=dict)
    layers: Mapping[int, Mapping[str, SeamPlan]] = dataclasses.field(
        default_factory=dict)

    def resolve(self, seam: str, layer: Optional[int] = None) -> SeamPlan:
        if layer is not None:
            per_layer = self.layers.get(layer)
            if per_layer is not None and seam in per_layer:
                return per_layer[seam]
        return self.seams.get(seam, self.default)

    def override(self, seam: str, plan: SeamPlan,
                 layer: Optional[int] = None) -> "PlanSet":
        """Functional update (PlanSet is frozen)."""
        if layer is None:
            return dataclasses.replace(
                self, seams={**dict(self.seams), seam: plan})
        layers = {k: dict(v) for k, v in self.layers.items()}
        layers.setdefault(layer, {})[seam] = plan
        return dataclasses.replace(self, layers=layers)

    @staticmethod
    def uniform(mode: str, comm_chunks: int = 0,
                reverse: bool = False) -> "PlanSet":
        """One mode for every seam (the pre-registry behaviour)."""
        return PlanSet(default=SeamPlan(mode=mode, comm_chunks=comm_chunks,
                                        reverse=reverse).validate())

    def residual_layout(self) -> str:
        """The model's activation layout ("seq" | "hidden") from the
        residual-stream seam plans.  They must agree: the RS side of one
        layer produces the layout the next AG side consumes, so a
        mismatch would be an incoherent model and raises."""
        axes = {s: self.resolve(s).scatter_axis for s in RESIDUAL_SEAMS}
        distinct = set(axes.values())
        if len(distinct) > 1:
            raise ValueError(
                f"incoherent residual-stream layout: {axes} — stamp ONE "
                f"scatter_axis across the residual seams "
                f"(PlanSet.with_scatter_axis)")
        return distinct.pop()

    def with_scatter_axis(self, scatter_axis: str) -> "PlanSet":
        """Stamp one activation layout onto every plan ("ar" seams ignore
        the knob: they are always replicated)."""
        return _stamp(self, lambda p: dataclasses.replace(
            p, scatter_axis=scatter_axis).validate())

    def with_wire_dtype(self, wire_dtype: Optional[str]) -> "PlanSet":
        """Stamp one wire dtype onto every plan (default, seams, per-layer
        overrides).  Flux plans keep the fp wire: the fused kernels have
        no quantized path and would reject the knob."""
        return _stamp(self, lambda p: p if p.mode == "flux" else
                      dataclasses.replace(p, wire_dtype=wire_dtype).validate())

    def to_json(self) -> Dict:
        return {"default": self.default.to_json(),
                "seams": {s: p.to_json() for s, p in self.seams.items()},
                "layers": {str(l): {s: p.to_json() for s, p in ov.items()}
                           for l, ov in self.layers.items()}}

    @staticmethod
    def from_json(d: Mapping) -> "PlanSet":
        return PlanSet(
            default=SeamPlan.from_json(d["default"]),
            seams={s: SeamPlan.from_json(p)
                   for s, p in d.get("seams", {}).items()},
            layers={int(l): {s: SeamPlan.from_json(p) for s, p in ov.items()}
                    for l, ov in d.get("layers", {}).items()})


def plan_set_from_parallel(par, backend: Optional[str] = None) -> PlanSet:
    """PlanSet for a ParallelConfig: the uniform ``overlap_mode`` default,
    overlaid with the per-seam plans of ``par.plan_profile`` when that
    profile exists, is fresh, and was tuned for this TP degree on
    ``backend`` ("cuda" | "cpu"; default ``cache.default_backend()``).
    ``par.scatter_axis`` ("seq" / "hidden") stamps the activation layout;
    "auto" keeps the profile's (or the "seq" default).  ``par.wire_dtype``
    stamps the wire onto every plan but the flux ones."""
    base = PlanSet.uniform(par.overlap_mode, par.comm_chunks)
    profile = getattr(par, "plan_profile", None)
    if profile:
        from repro_torch.tuning.cache import PlanRegistry
        reg = PlanRegistry.open(profile, n_dev=par.tp, backend=backend)
        seams = reg.seam_plans()
        if seams:
            base = dataclasses.replace(
                base, seams={**dict(base.seams), **seams})
            # adopt the profile's layout for the whole set: residual seams
            # the profile does not record would otherwise resolve to the
            # default's "seq" and make residual_layout() raise
            axes = {p.scatter_axis for s, p in seams.items()
                    if seam_of(s) in RESIDUAL_SEAMS}
            if len(axes) == 1:
                base = base.with_scatter_axis(axes.pop())
    forced = getattr(par, "scatter_axis", "auto")
    if forced and forced != "auto":
        base = base.with_scatter_axis(forced)
    wire = getattr(par, "wire_dtype", None)
    if wire:
        base = base.with_wire_dtype(wire)
    return base

"""Measured + analytic per-seam autotuner (port of ``repro.tuning.autotune``;
paper §4.4).

For one seam (collective kind + GEMM shape) the tuner enumerates candidate
``(mode, comm_chunks, reverse, blocks, shared_gather, fuse_epilogue,
wire_dtype)`` settings, scores each, and returns the winner as a
``SeamPlan``:

  * **measured** — every candidate's ``FusedOp`` run by the ranks of a
    ``dist.RankGroup`` of ``n_dev`` ranks on seeded inputs, timed by
    ``launch.op_level.time_tp`` (CUDA events around every rank's calls on
    the card, the host clock on the CPU): ``warmup`` calls, then the mean
    of ``iters``.  The winner is the argmin of ``measured_s``; the table
    keeps every row.  A candidate that fails to build or launch raises:
    the sweep never drops it, and never falls back to the analytic path.
  * **analytic** — the ``core.ect`` roofline priced with ``hw`` (an
    ``ect.Hardware``; ``ect.H100_SXM`` for the card).

``measure="auto"`` is measured when ``group`` is a CUDA group of ``n_dev``
ranks and analytic otherwise (the reference's rule: its single-device and
interpret-mode runs are analytic); ``True`` / ``False`` force them, and
``True`` on a CPU group is a real sweep by the host clock.  On the CPU the
flux rows are left out of a measured sweep, as the reference leaves them
out under interpret mode: their plain versions time PyTorch, not the
kernels.

``flux`` sweeps the Hopper tiles the kernels have (``kernels.matmul.TILES``
as ``(bm, BK, bn)``), not the reference's TPU block preferences; under
fp32 the kernels have one tile and the flux rows carry ``blocks=None``.
The ranks of the port's group share one card, so a measured winner is the
best on one shared card, and an analytic one the best for ranks on cards
of their own (``ect.H100_SXM``'s comment).

A measured ``a2a`` cell (the MoE exchange) times the reference's operands
(``bench_inputs``): the op forward, over ``xla`` and the ``decomposed``
ring's ``comm_chunks`` and directions.

Wire precision is a knob of its own (``Candidate.wire_dtype``), swept over
``wire_dtypes`` only where the transport carries a quantized payload
(``wire_supported``) and under an error budget: each quantized row is
scored by ``rmse_fn`` (default ``error_budget.seam_wire_rmse``), a row
beyond ``max_logit_rmse`` stays in the table with ``within_budget``
False and cannot win.  Unlike the reference, whose ``tune_seam`` and
``candidate_space`` default to its deprecated ``allow_q8=True`` (which
adds int8 rows), ``wire_dtypes=None`` is the fp wire alone: a quantized
wire is always asked for.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import ect
from repro_torch.core.overlap import VALID_MODES
from repro_torch.kernels import matmul as mm
from repro_torch.tuning.plans import PlanSet, SeamPlan, seam_of

# candidate modes per collective kind
_KIND_MODES: Dict[str, Tuple[str, ...]] = {
    "ag": ("xla", "decomposed", "decomposed_bidir", "flux"),
    "rs": ("xla", "decomposed", "decomposed_bidir", "flux"),
    "ar": ("xla", "decomposed"),
    "a2a": ("xla", "decomposed"),
}

# the wire dtypes a full sweep tries (None: the fp wire)
WIRE_DTYPE_SWEEP: Tuple[Optional[str], ...] = (None, "int8", "fp8_e4m3",
                                               "int4")


def wire_supported(kind: str, mode: str, scatter_axis: str = "seq") -> bool:
    """Whether (kind, mode, layout) carries a quantized payload: flux has
    no quantized path; ``xla``'s reductions (rs, ar) cannot carry the
    per-block scales; an ag seam in the replicated layout has no
    collective."""
    if mode == "flux":
        return False
    if kind == "ag":
        return scatter_axis != "hidden"
    if kind == "a2a":
        return True
    return mode.startswith("decomposed")

# the a2a bench's local experts a rank (the reference's)
A2A_BENCH_E_LOC = 2
_ALIGN_BYTES = 16        # the kernels load K and N rows in 16-byte chunks


@dataclasses.dataclass(frozen=True)
class Candidate:
    mode: str
    comm_chunks: int
    reverse: bool
    blocks: Optional[Tuple[int, int, int]] = None
    shared_gather: bool = True        # one ring pass for N-weight gathers
    fuse_epilogue: bool = True        # epilogue inside the overlapped loop
    scatter_axis: str = "seq"         # residual-stream layout (seq | hidden)
    wire_dtype: Optional[str] = None  # forward-wire precision (None: fp)


@dataclasses.dataclass
class TuneResult:
    seam: str                         # model seam name (or the kind itself)
    kind: str                         # ag | rs | ar | a2a
    m: int
    n: int
    k: int
    n_dev: int
    plan: SeamPlan
    table: List[Dict]                 # one row per candidate (tune_seam)
    source: str                       # measured | analytic
    pruned: int = 0                   # flux candidates the kernels refuse


def _ring_chunk_options(n_dev: int) -> Tuple[int, ...]:
    # no 0 ("auto"): auto IS n_dev in every ring op
    return (n_dev, 2 * n_dev, 4 * n_dev)


def flux_blocks(dtype_bytes: int = 2) -> Tuple[Optional[Tuple[int, int, int]],
                                                ...]:
    """The flux tiles to sweep: each bf16 Hopper tile as (bm, BK, bn); fp32
    has one tile (``F32Tile``), so None."""
    if dtype_bytes != 2:
        return (None,)
    return tuple(mm.tile_blocks(t) for t in mm.TILES)


def default_blocks(kind: str, m: int, n: int, n_dev: int,
                   dtype_bytes: int = 2) -> Optional[Tuple[int, int, int]]:
    """The tile the kernels pick themselves for a seam (``matmul.
    plan_blocks`` over the launch's rows and local columns): an ag launch
    is [m, n / n_dev], an rs one [m, n]; None under fp32."""
    if dtype_bytes != 2:
        return None
    cols = max(n // n_dev, 1) if kind == "ag" else n
    return mm.tile_blocks(mm.plan_blocks(max(m, 1), cols))


def candidate_space(kind: str, m: int, n: int, k: int, n_dev: int,
                    *, allow_flux: bool = True,
                    modes: Optional[Sequence[str]] = None,
                    n_weights: int = 1, epilogue: bool = False,
                    scatter_axis: str = "seq",
                    dtype_bytes: int = 2,
                    wire_dtypes: Optional[Sequence[Optional[str]]] = None
                    ) -> List[Candidate]:
    """All tunable settings for one seam kind (the reference's space with
    the Hopper tiles in place of its TPU blocks).  ``n_weights > 1``
    sweeps ``shared_gather`` and ``epilogue=True`` sweeps
    ``fuse_epilogue``, on the transports that consume them (ag ring and
    flux modes).  Under ``scatter_axis="hidden"`` an AG seam has no
    collective (one candidate) and an RS seam is the "ar" kind.
    ``wire_dtypes`` (default: the fp wire alone; ``WIRE_DTYPE_SWEEP`` for
    all) expands each candidate over the wires its transport carries
    (``wire_supported``)."""
    wire_dtypes = (None,) if wire_dtypes is None else tuple(wire_dtypes)
    hidden = scatter_axis == "hidden"
    if kind == "ag" and hidden:
        return [Candidate("xla", 0, False, scatter_axis="hidden")]
    mode_kind = "ar" if (kind == "rs" and hidden) else kind
    sweep_sg = kind == "ag" and n_weights > 1
    sweep_fe = kind == "ag" and epilogue
    fusion_opts = [(sg, fe)
                   for sg in ((True, False) if sweep_sg else (True,))
                   for fe in ((True, False) if sweep_fe else (True,))]
    out: List[Candidate] = []
    for mode in (modes or _KIND_MODES[mode_kind]):
        if mode not in VALID_MODES:
            raise ValueError(f"invalid overlap mode {mode!r}")
        if mode == "flux" and not allow_flux:
            continue
        if mode == "xla":
            out.append(Candidate(mode, 0, False, scatter_axis=scatter_axis))
            continue
        if mode == "flux":
            for blocks in flux_blocks(dtype_bytes):
                for reverse in (False, True):
                    for sg, fe in fusion_opts:
                        out.append(Candidate(mode, 0, reverse, blocks,
                                             shared_gather=sg,
                                             fuse_epilogue=fe,
                                             scatter_axis=scatter_axis))
            continue
        # ring modes: chunk count x direction (AR chunks the contraction —
        # no ring, so no direction; bidir already rides both directions)
        for chunks in _ring_chunk_options(n_dev):
            for reverse in (False, True):
                if reverse and (mode_kind == "ar"
                                or mode == "decomposed_bidir"):
                    continue
                for sg, fe in fusion_opts:
                    out.append(Candidate(mode, chunks, reverse,
                                         shared_gather=sg, fuse_epilogue=fe,
                                         scatter_axis=scatter_axis))
    expanded = [dataclasses.replace(c, wire_dtype=wd) for c in out
                for wd in wire_dtypes
                if wd is None or wire_supported(kind, c.mode, c.scatter_axis)]
    seen, uniq = set(), []
    for c in expanded:
        if c not in seen:
            seen.add(c)
            uniq.append(c)
    return uniq


def prune_infeasible(kind: str, cands: List[Candidate], n: int, k: int,
                     n_dev: int, *, dtype_bytes: int = 2
                     ) -> Tuple[List[Candidate], List[Candidate]]:
    """(kept, pruned): drop the flux candidates whose operands the kernels
    refuse, before any pricing or timing.  The kernels load K and N rows
    in 16-byte chunks, so both must be multiples of 8 in bf16 (4 in fp32)
    at the rank's GEMM: an ag seam multiplies [., k] by [k, n / n_dev],
    an rs seam [., k / n_dev] by [k / n_dev, n] (``matmul._check_cuda``);
    the GEMM-RS kernel takes at most ``gemm_rs.MAX_RANKS`` ranks.  Both
    Hopper tiles' shared memory fits by construction (``csrc/
    gemm_tile.cuh`` WgmmaTile::kSmem is set at compile time and checked by
    the launch), so no tile is pruned for its footprint: this replaces
    the reference's TPU VMEM model."""
    from repro_torch.kernels import gemm_rs
    if kind not in ("ag", "rs"):
        return list(cands), []
    vec = _ALIGN_BYTES // dtype_bytes
    gk, gn = (k, n // n_dev) if kind == "ag" else (k // n_dev, n)
    refused = (gk % vec or gn % vec or min(gk, gn) == 0
               or (kind == "rs" and n_dev > gemm_rs.MAX_RANKS))
    keep: List[Candidate] = []
    pruned: List[Candidate] = []
    for c in cands:
        if c.mode == "flux" and refused:
            pruned.append(c)
        else:
            keep.append(c)
    return keep, pruned


def analytic_estimate(kind: str, m: int, n: int, k: int, n_dev: int,
                      cand: Candidate, dtype_bytes: int = 2,
                      n_weights: int = 1, epilogue: bool = False,
                      full: bool = False, *, hw: ect.Hardware):
    """Roofline OverallTime for one candidate on ``hw`` (``full=True``
    returns the whole ``ect.model_overlap`` dict)."""
    est = ect.model_overlap(kind, m, n, k, n_dev, cand.mode, dtype_bytes,
                            comm_chunks=cand.comm_chunks, hw=hw,
                            n_weights=n_weights,
                            shared_gather=cand.shared_gather,
                            epilogue=epilogue,
                            fuse_epilogue=cand.fuse_epilogue,
                            scatter_axis=cand.scatter_axis,
                            wire_dtype=cand.wire_dtype)
    return est if full else est["overall"]


# ---------------------------------------------------------------------------
# measured path
# ---------------------------------------------------------------------------
def _round_to(x: int, mult: int) -> int:
    return max(mult, x - x % mult)


def _bench_epilogue(kind: str, n_weights: int, epilogue: bool):
    """The representative epilogue benched for a seam: the gated-FFN pair
    for two-weight AG seams and for the a2a op (which takes only that), a
    plain activation otherwise."""
    from repro_torch.core.overlap import Epilogue
    if kind == "a2a":
        return Epilogue(activation="silu", gate="pair")
    if not epilogue:
        return Epilogue()
    if kind == "ag" and n_weights == 2:
        return Epilogue(activation="silu", gate="pair")
    return Epilogue(activation="silu")


def bench_inputs(kind: str, m: int, n: int, k: int, group,
                 n_weights: int = 1, scatter_axis: str = "seq",
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0
                 ) -> List[Tuple[torch.Tensor, ...]]:
    """Each rank's (x, *ws) for one seam's op, standard-normal from a
    seeded ``torch.Generator`` on the group's device (weights / sqrt of
    their fan-in): ag x [1, m / n, k] (the full [1, m, k] in the hidden
    layout), ws [k, n / n]; rs / ar x [1, m, k / n], w [k / n, n]; a2a
    (the reference's: m routed rows, k = d_model, n the expert width,
    ``A2A_BENCH_E_LOC`` experts a rank) the dispatch buffer x [n, e_loc,
    cap, k] with cap = max(m / (n e_loc), 1), (w1, w3) [e_loc, k, n] and
    w2 [e_loc, n, k]."""
    nd = group.n
    dev = group.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    out = []
    for _ in range(nd):
        if kind == "a2a":
            e_loc = A2A_BENCH_E_LOC
            cap = max(m // (nd * e_loc), 1)
            out.append((randn(nd, e_loc, cap, k),
                        randn(e_loc, k, n, scale=k ** -0.5),
                        randn(e_loc, k, n, scale=k ** -0.5),
                        randn(e_loc, n, k, scale=n ** -0.5)))
        elif kind == "ag":
            rows = m if scatter_axis == "hidden" else m // nd
            out.append((randn(1, rows, k),) + tuple(
                randn(k, n // nd, scale=k ** -0.5)
                for _ in range(n_weights)))
        else:
            out.append((randn(1, m, k // nd),
                        randn(k // nd, n, scale=k ** -0.5)))
    return out


def bench_op(kind: str, cand: Candidate, group, n_weights: int = 1,
             epilogue: bool = False):
    """The ``FusedOp`` one candidate runs."""
    from repro_torch.core.overlap import FusedOp
    nw = {"ag": n_weights, "a2a": 3}.get(kind, 1)
    return FusedOp(kind, epilogue=_bench_epilogue(kind, nw, epilogue),
                   n_weights=nw, axis=group, mode=cand.mode,
                   scatter_axis=cand.scatter_axis,
                   comm_chunks=cand.comm_chunks, reverse=cand.reverse,
                   blocks=cand.blocks, fuse_epilogue=cand.fuse_epilogue,
                   shared_gather=cand.shared_gather,
                   wire_dtype=cand.wire_dtype)


def _measurable_modes(kind: str, allow_flux: bool,
                      cuda: bool) -> Tuple[str, ...]:
    """The modes a measured sweep times: flux only on the card (on the CPU
    its plain versions would time PyTorch, not the kernels)."""
    modes = _KIND_MODES[kind]
    if not (allow_flux and cuda):
        modes = tuple(md for md in modes if md != "flux")
    return modes


def _measured(measure, group, n_dev: int) -> bool:
    if measure == "auto":
        return group is not None and group.cuda and group.n == n_dev
    if measure and (group is None or group.n != n_dev):
        raise ValueError(f"a measured sweep at n_dev={n_dev} needs a "
                         f"dist.RankGroup of {n_dev} ranks, got "
                         f"{None if group is None else group.n}")
    return bool(measure)


def tune_seam(kind: str, m: int, n: int, k: int, n_dev: int,
              *, hw: ect.Hardware, group=None, dtype_bytes: int = 2,
              allow_flux: bool = True, measure="auto",
              modes: Optional[Sequence[str]] = None,
              seam: Optional[str] = None, iters: int = 3,
              warmup: int = 1, n_weights: int = 1,
              epilogue: bool = False,
              scatter_axis: str = "seq",
              wire_dtypes: Optional[Sequence[Optional[str]]] = None,
              max_logit_rmse: Optional[float] = None,
              rmse_fn=None) -> TuneResult:
    """Tune one seam.  Returns the winning plan and the table (rows:
    mode / comm_chunks / reverse / blocks / shared_gather / fuse_epilogue
    / scatter_axis / wire_dtype / comm_bytes / predicted_s / logit_rmse /
    within_budget / measured_s; ``measured_s`` is 0 on the analytic
    path).  ``n_weights`` / ``epilogue`` describe the seam's ``FusedOp``
    (the gated FFN's two-weight silu gate) so the fusion knobs are swept;
    ``scatter_axis`` is the layout it is tuned under (a model-level
    decision: ``autotune_model``).  ``wire_dtypes`` sweeps the wires (the
    fp wire alone by default); each quantized row is scored by
    ``rmse_fn(kind, m, n, k, n_dev, wire_dtype)`` (default
    ``error_budget.seam_wire_rmse``), and the winner is the best row
    within ``max_logit_rmse`` (None: no budget; every row when none
    is)."""
    if kind not in _KIND_MODES:
        raise ValueError(f"unknown seam kind {kind!r}")
    measured = _measured(measure, group, n_dev)
    if rmse_fn is None:
        from repro_torch.tuning.error_budget import seam_wire_rmse
        rmse_fn = seam_wire_rmse

    def row(c, t=0.0):
        est = analytic_estimate(kind, m, n, k, n_dev, c, dtype_bytes,
                                n_weights, epilogue, full=True, hw=hw)
        rmse = (rmse_fn(kind, m, n, k, n_dev, c.wire_dtype)
                if c.wire_dtype else 0.0)
        return {"mode": c.mode, "comm_chunks": c.comm_chunks,
                "reverse": c.reverse, "blocks": c.blocks,
                "shared_gather": c.shared_gather,
                "fuse_epilogue": c.fuse_epilogue,
                "scatter_axis": c.scatter_axis,
                "wire_dtype": c.wire_dtype,
                "comm_bytes": est["comm_bytes"],
                "predicted_s": est["overall"], "logit_rmse": rmse,
                "within_budget": (max_logit_rmse is None
                                  or rmse <= max_logit_rmse),
                "measured_s": t}

    def pick(table, key):
        eligible = [r for r in table if r["within_budget"]]
        return min(eligible or table, key=lambda r: r[key])

    mode_kind = "ar" if (kind == "rs" and scatter_axis == "hidden") else kind
    if measured and modes is None:
        modes = _measurable_modes(mode_kind, allow_flux, group.cuda)
    cands = candidate_space(kind, m, n, k, n_dev, allow_flux=allow_flux,
                            modes=modes, n_weights=n_weights,
                            epilogue=epilogue, scatter_axis=scatter_axis,
                            dtype_bytes=dtype_bytes, wire_dtypes=wire_dtypes)
    cands, dropped = prune_infeasible(kind, cands, n, k, n_dev,
                                      dtype_bytes=dtype_bytes)
    if measured:
        from repro_torch.launch.op_level import time_tp
        mr, nr, kr = (_round_to(v, n_dev) for v in (m, n, k))
        dtype = torch.bfloat16 if dtype_bytes == 2 else torch.float32
        args = bench_inputs(kind, mr, nr, kr, group, n_weights,
                            scatter_axis, dtype)
        table = [row(c, time_tp(group, bench_op(kind, c, group, n_weights,
                                                epilogue),
                                args, iters, warmup))
                 for c in cands]
        del args
        best = pick(table, "measured_s")
        source = "measured"
    else:
        table = [row(c) for c in cands]
        best = pick(table, "predicted_s")
        source = "analytic"

    blocks = best["blocks"]
    if blocks is None:
        blocks = default_blocks(kind, m, n, n_dev, dtype_bytes)
    plan = SeamPlan(mode=best["mode"], comm_chunks=best["comm_chunks"],
                    reverse=best["reverse"], blocks=blocks,
                    shared_gather=best["shared_gather"],
                    fuse_epilogue=best["fuse_epilogue"],
                    scatter_axis=best["scatter_axis"],
                    wire_dtype=best["wire_dtype"],
                    source=source, predicted_s=best["predicted_s"],
                    measured_s=best["measured_s"],
                    logit_rmse=best["logit_rmse"]).validate()
    return TuneResult(seam=seam or kind, kind=kind, m=m, n=n, k=k,
                      n_dev=n_dev, plan=plan, table=table, source=source,
                      pruned=len(dropped))


# ---------------------------------------------------------------------------
# whole-model tuning
# ---------------------------------------------------------------------------
def serving_decode_batch() -> int:
    """The decode-AR seam's m under the serving runtime: the ``Server``
    decodes ``ServeConfig.max_batch`` rows a step."""
    from repro_torch.runtime.server import ServeConfig
    return ServeConfig().max_batch


def model_seam_shapes(cfg, par, tokens_per_dp: int = 2048,
                      decode_batch: Optional[int] = None
                      ) -> Dict[str, Tuple[str, int, int, int]]:
    """(kind, m, n, k) per model seam shape cell, from the arch's padded
    GEMM shapes, formula for formula the reference's: cell-qualified keys
    (``"attn_ag@qkv"``, ``"attn_ag@q_up"``, ``"attn_ag@kv_up"``) where one
    seam runs several GEMM shapes; ``decode_ar`` at ``decode_batch``
    rows (default the ``Server``'s ``max_batch``); ``moe_a2a`` over
    ``tokens x top_k`` routed rows."""
    from repro_torch.models.attention import AttnDims
    from repro_torch.parallel.sharding import pad_ff, pad_heads, pad_vocab
    if decode_batch is None:
        decode_batch = serving_decode_batch()
    tp = par.tp
    d = cfg.d_model
    ffp = pad_ff(cfg.d_ff, tp)
    shapes: Dict[str, Tuple[str, int, int, int]] = {
        "mlp_ag": ("ag", tokens_per_dp,
                   ffp * (2 if getattr(par, "fuse_w13", False) else 1), d),
        "mlp_rs": ("rs", tokens_per_dp, d, ffp),
        "head_ag": ("ag", tokens_per_dp, pad_vocab(cfg.vocab_size, tp), d),
        "decode_ar": ("ar", decode_batch, d, ffp),
    }
    if cfg.mla is not None:
        mla = cfg.mla
        h_pad = pad_heads(cfg.num_heads, tp)
        shapes["attn_ag@q_up"] = (
            "ag", tokens_per_dp,
            h_pad * (mla.qk_nope_head_dim + mla.qk_rope_head_dim),
            mla.q_lora_rank)
        shapes["attn_ag@kv_up"] = (
            "ag", tokens_per_dp,
            h_pad * (mla.qk_nope_head_dim + mla.v_head_dim),
            mla.kv_lora_rank)
        shapes["attn_rs"] = ("rs", tokens_per_dp, d, h_pad * mla.v_head_dim)
    elif cfg.num_heads:
        dims = AttnDims.of(cfg, tp)
        shapes["attn_ag@qkv"] = (
            "ag", tokens_per_dp,
            (dims.h_pad + 2 * dims.hkv_pad) * dims.dh, d)
        shapes["attn_rs"] = ("rs", tokens_per_dp, d, dims.h_pad * dims.dh)
    if cfg.moe is not None:
        shapes["moe_a2a"] = ("a2a", tokens_per_dp * cfg.moe.top_k,
                             cfg.moe.expert_ffn, d)
    return shapes


def sweep_model_layout(cfg, par, *, hw: ect.Hardware,
                       tokens_per_dp: int = 2048,
                       dtype_bytes: int = 2) -> Dict:
    """Joint residual-layout sweep (the ``scatter_axis`` knob): per layout,
    the analytic OverallTime summed over the paired per-layer seam cells
    (mlp_ag/mlp_rs, attn_ag/attn_rs), each on its best of xla and
    decomposed, and the resident activation bytes.  Ties within 2 % go to
    "seq" (1/tp the residency), as in the reference."""
    layer_seams = ("mlp_ag", "mlp_rs", "attn_ag", "attn_rs")
    shapes = model_seam_shapes(cfg, par, tokens_per_dp)
    out: Dict[str, Dict] = {}
    for axis in ("seq", "hidden"):
        total_s, act, vol = 0.0, 0.0, 0.0
        for key, (kind, m, n, k) in shapes.items():
            if seam_of(key) not in layer_seams:
                continue
            ests = [ect.model_overlap(kind, m, n, k, par.tp, mode,
                                      dtype_bytes, scatter_axis=axis, hw=hw)
                    for mode in ("xla", "decomposed")]
            est = min(ests, key=lambda e: e["overall"])
            total_s += est["overall"]
            act += est["act_bytes"]
            vol += est["comm_bytes"]
        out[axis] = {"overall_s": total_s, "act_bytes": act,
                     "comm_bytes": vol}
    seq_s, hid_s = out["seq"]["overall_s"], out["hidden"]["overall_s"]
    out["winner"] = "seq" if seq_s <= hid_s * 1.02 else "hidden"
    out["residency_ratio"] = (out["seq"]["act_bytes"]
                              / max(out["hidden"]["act_bytes"], 1.0))
    return out


def seam_op_shape(cfg, par, seam: str) -> Dict:
    """The ``FusedOp`` shape a model seam runs (``tune_seam``'s
    ``n_weights`` / ``epilogue``): the gated FFN's two-weight silu gate
    off one gather (w1|w3 packed: one weight, a split gate, still an
    epilogue); the QKV projection's bias where the arch has one."""
    if seam == "mlp_ag":
        return {"n_weights": 1 if getattr(par, "fuse_w13", False) else 2,
                "epilogue": True}
    if seam == "attn_ag":
        return {"epilogue": bool(getattr(cfg, "qkv_bias", False))}
    if seam == "moe_a2a":
        return {"n_weights": 3, "epilogue": True}
    return {}


def autotune_model(cfg, par, *, hw: ect.Hardware, group=None,
                   tokens_per_dp: int = 2048,
                   decode_batch: Optional[int] = None, measure="auto",
                   registry=None, save_path: Optional[str] = None,
                   allow_flux: bool = True, sweep_scatter_axis: bool = True,
                   iters: int = 3, warmup: int = 1,
                   results: Optional[List[TuneResult]] = None,
                   wire_dtypes: Optional[Sequence[Optional[str]]] = None,
                   max_logit_rmse: Optional[float] = None) -> PlanSet:
    """Tune every seam cell of a model and return the PlanSet.  The layout
    is decided first (``sweep_model_layout``) and every seam is tuned
    under it; a seam's plan is its dominant (largest-FLOPs) cell's winner
    and every cell stays under its qualified key.  ``registry`` (a
    ``cache.PlanRegistry``) answers the cells it holds and records the
    rest; ``save_path`` persists it.  ``results`` collects each tuned
    cell's ``TuneResult`` (its table).  Quantized wires are lossy, so
    they are an opt-in: ``wire_dtypes`` (e.g. ``WIRE_DTYPE_SWEEP``) sweeps
    them, gated per seam by ``max_logit_rmse``."""
    if par.tp <= 1:
        return PlanSet.uniform(par.overlap_mode, par.comm_chunks)
    scatter_axis = "seq"
    if sweep_scatter_axis:
        scatter_axis = sweep_model_layout(
            cfg, par, hw=hw, tokens_per_dp=tokens_per_dp)["winner"]
    seams: Dict[str, SeamPlan] = {}
    flops: Dict[str, Tuple[int, str]] = {}
    for cell_key, (kind, m, n, k) in model_seam_shapes(
            cfg, par, tokens_per_dp, decode_batch).items():
        seam_name = seam_of(cell_key)
        cached = registry.lookup(cell_key, m, n, k) if registry else None
        if cached is not None:
            seams[cell_key] = cached
        else:
            res = tune_seam(kind, m, n, k, par.tp, hw=hw, group=group,
                            allow_flux=allow_flux, measure=measure,
                            seam=cell_key, scatter_axis=scatter_axis,
                            iters=iters, warmup=warmup,
                            wire_dtypes=wire_dtypes,
                            max_logit_rmse=max_logit_rmse,
                            **seam_op_shape(cfg, par, seam_name))
            seams[cell_key] = res.plan
            if results is not None:
                results.append(res)
            if registry is not None:
                registry.record(cell_key, kind, m, n, k, res.plan)
        cell_flops = 2 * m * n * k
        if cell_key != seam_name and (seam_name not in flops
                                      or cell_flops > flops[seam_name][0]):
            flops[seam_name] = (cell_flops, cell_key)
    for seam_name, (_, cell_key) in flops.items():
        seams[seam_name] = seams[cell_key]
    if registry is not None:
        if sweep_scatter_axis:
            registry.stamp_scatter_axis(scatter_axis)
        if save_path:
            registry.save(save_path)
    plans = PlanSet(default=SeamPlan(mode=par.overlap_mode,
                                     comm_chunks=par.comm_chunks).validate(),
                    seams=seams)
    if sweep_scatter_axis:
        plans = plans.with_scatter_axis(scatter_axis)
    return plans

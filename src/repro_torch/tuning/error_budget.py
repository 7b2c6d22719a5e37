"""Error budget for the quantized wires (port of
``repro.tuning.error_budget``).

A quantized forward wire (``FusedOp.wire_dtype``) trades accuracy for
bytes on the wire, so the tuner never picks a wire on time alone: every
quantized candidate is scored against a budget (``max_logit_rmse``)
before it may win.  Three estimates, each a RELATIVE rmse (deviation RMS
over signal RMS), so one threshold holds across seams and shapes:

  codec_rmse        one encode/decode of seeded N(0, 1) activations.
  seam_wire_rmse    the seam's transport simulated on seeded payloads:
                    one roundtrip for ag / a2a, the accumulator requantized
                    each hop for the rs / ar rings (it compounds over the
                    n_dev - 1 hops), and the ar gather's roundtrip on top.
                    The default ``rmse_fn`` of ``autotune.tune_seam``.
  model_logit_rmse  a model's prefill logits at tp on a ``dist.RankGroup``,
                    the fp-wire ``PlanSet`` against the same set stamped
                    with the wire, on identical weights and tokens.

The proxy payloads are drawn by a seeded ``torch.Generator`` (on the CPU),
not ``jax.random``: the estimates agree with the reference's
statistically, not bit for bit.  The backward never enters the budget:
cotangents ride the fp transports (``core.overlap``).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core.overlap import wire_decode, wire_encode

__all__ = ["codec_rmse", "seam_wire_rmse", "model_logit_rmse",
           "DEFAULT_MAX_LOGIT_RMSE"]

# the budget for CLI sweeps that name none: rejects int4 on deep rings,
# admits int8 / fp8 broadly (the reference's)
DEFAULT_MAX_LOGIT_RMSE = 0.05

_PROXY_D = 512          # divisible by the 128-block and by n_dev <= 8
_PROXY_ROWS = 32


def _rel_rmse(ref: torch.Tensor, got: torch.Tensor) -> float:
    ref, got = ref.double(), got.double()
    num = (ref - got).square().mean().sqrt()
    den = torch.clamp_min(ref.square().mean().sqrt(), 1e-30)
    return float(num / den)


def _roundtrip(x: torch.Tensor, wire_dtype: str) -> torch.Tensor:
    return wire_decode(wire_encode(x, wire_dtype), wire_dtype, x.dtype)


def _normal(gen: torch.Generator, rows: int, d: int) -> torch.Tensor:
    return torch.randn((rows, d), generator=gen, dtype=torch.float32)


def codec_rmse(wire_dtype: Optional[str], *, d: int = _PROXY_D,
               rows: int = _PROXY_ROWS, seed: int = 0) -> float:
    """Relative rmse of one encode/decode of seeded N(0, 1) activations;
    the fp wire is exact."""
    if wire_dtype is None:
        return 0.0
    x = _normal(torch.Generator().manual_seed(seed), rows, d)
    return _rel_rmse(x, _roundtrip(x, wire_dtype))


@functools.lru_cache(maxsize=256)
def _seam_wire_rmse_cached(kind: str, n_dev: int, wire_dtype: str,
                           seed: int) -> float:
    gen = torch.Generator().manual_seed(seed)
    parts = [_normal(gen, _PROXY_ROWS, _PROXY_D) for _ in range(n_dev)]
    if kind in ("ag", "a2a"):
        # one roundtrip a travelling shard; the errors are independent, so
        # the gathered deviation is the per-shard one
        return _rel_rmse(torch.cat(parts),
                         torch.cat([_roundtrip(p, wire_dtype)
                                    for p in parts]))
    # rs / ar: the ring requantizes the travelling accumulator every hop
    exact = sum(parts[1:], parts[0])
    acc = parts[0]
    for p in parts[1:]:
        acc = _roundtrip(acc, wire_dtype) + p
    if kind == "ar":
        # the AllGather ring ships the reduced shard through the wire once
        # more before it lands on the other ranks
        acc = _roundtrip(acc, wire_dtype)
    return _rel_rmse(exact, acc)


def seam_wire_rmse(kind: str, m: int, n: int, k: int, n_dev: int,
                   wire_dtype: Optional[str], *, seed: int = 0) -> float:
    """Deviation proxy for one seam's wire (``tune_seam``'s default
    ``rmse_fn``): shape-independent (the codec's relative rmse is scale-
    and width-invariant on gaussian payloads) but ring-depth dependent."""
    del m, n, k
    if wire_dtype is None:
        return 0.0
    return _seam_wire_rmse_cached(kind, max(int(n_dev), 2), wire_dtype,
                                  seed)


def model_logit_rmse(cfg, par, wire_dtype: Optional[str], *, device,
                     group=None, params=None, tokens=None,
                     mode: str = "decomposed", comm_chunks: int = 0,
                     batch: int = 2, seq: int = 64, seed: int = 0,
                     plans=None) -> float:
    """End-to-end logit deviation: ONE model, ONE token batch, the prefill
    logits at every position (``backbone`` then the ``head_ag`` seam) at
    ``par.tp`` on ``group`` (a ``dist.RankGroup`` of ``par.tp`` ranks on
    ``device``; made here when None) under the fp wire and under
    ``wire_dtype``; the relative rmse over the valid vocab slice.
    ``plans`` overrides the fp-wire ``PlanSet`` (default
    ``PlanSet.uniform(mode, comm_chunks)``); the quantized run uses the
    same set through ``with_wire_dtype``.  ``params`` is one ``Model`` a
    rank (``model.shard_params`` cuts, or ``convert.rank_params_from_jax``
    of the reference's weights); None draws the seeded init in the
    config's compute dtype.  ``tokens`` [B, S] defaults to seeded ids."""
    from repro_torch.dist import RankGroup
    from repro_torch.models import layers
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import make_ctx
    from repro_torch.tuning.plans import PlanSet

    if wire_dtype is None:
        return 0.0
    tp = par.tp
    device = torch.device(device)
    if group is None:
        group = RankGroup(tp, device)
    if params is None:
        full = M.init_model(cfg, par, seed=seed,
                            dtype=getattr(torch, cfg.compute_dtype),
                            device=device)
        params = [M.shard_params(full, r, tp, cfg) for r in range(tp)]
        del full
    if tokens is None:
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                               generator=gen, device=device)
    if plans is None:
        plans = PlanSet.uniform(mode, comm_chunks)

    def run(plan_set) -> torch.Tensor:
        ctx = make_ctx(par, group, plan_set)

        def logits(p):
            with torch.no_grad():
                x = layers.embed_lookup(p.embed, tokens, ctx)
                x = x.to(getattr(torch, cfg.compute_dtype))
                h, _ = M.backbone(p, x, ctx, cfg, par)
                h = layers.rms_norm(h, p.final_norm, cfg.norm_eps)
                return layers.lm_head_logits(h, p.embed, ctx)
        outs = group.spmd(logits, [(p,) for p in params])
        return torch.cat(outs, dim=-1)[..., :cfg.vocab_size].float()

    ref = run(plans)
    got = run(plans.with_wire_dtype(wire_dtype))
    return _rel_rmse(ref, got)

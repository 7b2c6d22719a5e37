"""Model assembly (port of ``repro.models.model``).

A model is ``num_layers`` blocks of its layer pattern, after its leading
dense layers.  The port holds the weights in ``Model`` (an ``nn.Module``):
the tied ``embed`` table [V_pad, D], ``final_norm`` [D] and one ``Block``
per layer in expanded-pattern order, whose ``mixer`` / ``ffn`` parameter
dicts carry the reference's leaf names and packed layouts (nested for the
MoE's ``shared`` expert).  (The reference stacks a period's layers
``[reps, ...]`` for ``lax.scan``; an eager loop needs no stacking —
``convert.params_from_jax`` unstacks.)  The ported layer kinds are
``PORTED_KINDS``; DeepSeek-V3's multi-token-prediction head is not built:
serving never reads it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import (ATTN, DENSE_FFN, MLA, MOE_FFN,
                                      ModelConfig, ParallelConfig)
from repro_torch.device import resolve_device
from repro_torch.models import attention, ffn
from repro_torch.models import init_utils as iu
from repro_torch.parallel.sharding import (EP_NOT_PORTED, TP_KIND_NOT_PORTED,
                                           pad_vocab)

# (mixer, ffn) layer kinds the port runs; at tp>1 only TP_KINDS
PORTED_KINDS = frozenset({(ATTN, DENSE_FFN), (MLA, DENSE_FFN),
                          (MLA, MOE_FFN)})
TP_KINDS = frozenset({(ATTN, DENSE_FFN)})

# the dim each leaf is split along over the TP ranks (None: replicated) —
# the reference's PartitionSpecs (model.py:83-118) for the kinds in
# TP_KINDS, on the port's unstacked per-layer leaves
_MIXER_SPECS = {ATTN: {"wqkv": 1, "wo": 0, "norm": None, "bqkv": 0}}
_FFN_SPECS = {DENSE_FFN: {"w1": 1, "w3": 1, "w13": 1, "w2": 0,
                          "norm": None}}


def expanded_pattern(cfg: ModelConfig) -> List[Tuple[str, str]]:
    """Full per-layer (mixer, ffn) list, honoring leading dense layers."""
    period = len(cfg.pattern)
    reps = cfg.num_layers // period
    if reps * period != cfg.num_layers:
        raise ValueError(f"{cfg.name}: num_layers {cfg.num_layers} not a "
                         f"multiple of pattern period {period}")
    out = [cfg.pattern[i % period] for i in range(cfg.num_layers)]
    for i in range(cfg.leading_dense_layers):
        out[i] = (out[i][0], DENSE_FFN)
    return out


def n_periods(cfg: ModelConfig) -> int:
    return (cfg.num_layers - cfg.leading_dense_layers) // len(cfg.pattern)


def check_ported(cfg: ModelConfig, tp: int = 1) -> None:
    """Raise unless every layer is one of ``PORTED_KINDS`` (at tp>1:
    ``TP_KINDS``)."""
    other = set(expanded_pattern(cfg)) - PORTED_KINDS
    if other:
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {sorted(other)} are not ported; the "
            f"port runs {sorted(PORTED_KINDS)} (ROADMAP 'Modules still to "
            "port', the other families)")
    if tp > 1 and set(expanded_pattern(cfg)) - TP_KINDS:
        raise NotImplementedError(f"{cfg.name} at tp={tp}: "
                                  + TP_KIND_NOT_PORTED)


def _frozen(params: Dict) -> nn.ParameterDict:
    return nn.ParameterDict({
        k: _frozen(v) if isinstance(v, dict)
        else nn.Parameter(v, requires_grad=False)
        for k, v in params.items()})


class Block(nn.Module):
    """One layer: ``mixer`` (GQA: wqkv, wo, norm[, bqkv]; MLA: w_dq, w_uq,
    w_dkv, w_ukv, w_o, q_norm, kv_norm, norm) and ``ffn`` (dense: w1, w3 |
    w13, w2, norm; MoE: router, w1, w3, w2, norm[, shared]) parameter
    dicts."""

    def __init__(self, mixer: Dict, ffn_params: Dict):
        super().__init__()
        self.mixer = _frozen(mixer)
        self.ffn = _frozen(ffn_params)


class Model(nn.Module):
    """Serving weights: ``embed`` [V_pad, D] (tied LM head), ``final_norm``
    [D], ``layers`` (one ``Block`` per layer)."""

    def __init__(self, embed: torch.Tensor, final_norm: torch.Tensor,
                 blocks: List[Block]):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.layers = nn.ModuleList(blocks)


def init_model(cfg: ModelConfig, par: ParallelConfig, seed: int = 0,
               dtype: torch.dtype = torch.bfloat16,
               device: Optional[Union[str, torch.device]] = None) -> Model:
    """Seeded random init (``torch.Generator``) with the reference's shapes,
    packing and zero padding: normal(0, 1/sqrt(fan_in)) weights, ones for
    norms, zeros for the QKV bias and for every padded row/column; the MoE
    router is fp32 whatever ``dtype``.  The numbers differ from JAX's for
    the same seed; tests hand the reference's weights across with
    ``convert.params_from_jax``.

    At tp>1 the same canonical weights are drawn (in the same order) and
    packed for tp — per-rank blocks interleaved, heads / d_ff / vocab
    zero-padded to tp multiples — so the model computes the same function
    at every tp (the reference's TP invariance).  The result holds the
    GLOBAL packed weights; ``shard_params`` cuts each rank's copy."""
    if par.ep != 1:
        raise NotImplementedError(EP_NOT_PORTED)
    check_ported(cfg, par.tp)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    v_pad = pad_vocab(cfg.vocab_size, par.tp)
    embed = iu.zero_pad_rows(
        torch.randn((cfg.vocab_size, cfg.d_model), generator=gen, device=dev)
        * cfg.d_model ** -0.5, v_pad).to(dtype)
    blocks = []
    for mixer_kind, ffn_kind in expanded_pattern(cfg):
        if mixer_kind == MLA:
            mixer = attention.init_mla(gen, cfg, par.tp, dtype, dev)
        else:
            mixer = attention.init_gqa(gen, cfg, par.tp, dtype, dev)
        if ffn_kind == MOE_FFN:
            f = ffn.init_moe(gen, cfg, par.tp, dtype, dev,
                             fuse13=par.fuse_w13)
        else:
            f = ffn.init_ffn(gen, cfg.d_model, cfg.d_ff, par.tp, dtype, dev,
                             fuse13=par.fuse_w13)
        blocks.append(Block(mixer, f))
    return Model(embed, torch.ones(cfg.d_model, dtype=dtype, device=dev),
                 blocks)


def param_specs(cfg: ModelConfig, params: Model) -> Dict:
    """The dim each weight is split along over the TP ranks (None:
    replicated), in ``params``' structure: ``{"embed": 0, "final_norm":
    None, "layers": [{"mixer": {...}, "ffn": {...}}, ...]}`` (the
    reference's ``param_specs``; the vocab-parallel embedding is split on
    its rows)."""
    check_ported(cfg, tp=2)
    layers = []
    for (mk, fk), blk in zip(expanded_pattern(cfg), params.layers):
        layers.append({"mixer": {n: _MIXER_SPECS[mk][n] for n in blk.mixer},
                       "ffn": {n: _FFN_SPECS[fk][n] for n in blk.ffn}})
    return {"embed": 0, "final_norm": None, "layers": layers}


def _cut(t: torch.Tensor, dim: Optional[int], rank: int,
         tp: int) -> torch.Tensor:
    if dim is None:
        return t
    if t.shape[dim] % tp:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} is not divisible "
                         f"by tp={tp}")
    # a copy of its own: a view would keep the global tensor alive
    return t.chunk(tp, dim)[rank].clone(memory_format=torch.contiguous_format)


def shard_params(params: Model, rank: int, tp: int,
                 cfg: ModelConfig) -> Model:
    """Rank ``rank``'s copy of the global packed weights (``init_model`` at
    this tp, or ``convert.params_from_jax`` of the reference's tp params):
    each leaf's contiguous 1/tp block along its ``param_specs`` dim;
    replicated leaves are shared, not copied."""
    specs = param_specs(cfg, params)
    blocks = [Block({n: _cut(t, sp["mixer"][n], rank, tp)
                     for n, t in blk.mixer.items()},
                    {n: _cut(t, sp["ffn"][n], rank, tp)
                     for n, t in blk.ffn.items()})
              for blk, sp in zip(params.layers, specs["layers"])]
    return Model(_cut(params.embed, specs["embed"], rank, tp),
                 params.final_norm, blocks)

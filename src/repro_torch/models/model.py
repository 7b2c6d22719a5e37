"""Model assembly (port of ``repro.models.model``).

A model is ``num_layers`` blocks of its layer pattern.  The port holds the
weights in ``Model`` (an ``nn.Module``): the tied ``embed`` table
[V_pad, D], ``final_norm`` [D] and one ``Block`` per layer in expanded-
pattern order, whose ``mixer`` / ``ffn`` parameter dicts carry the
reference's leaf names and packed layouts.  (The reference stacks a
period's layers ``[reps, ...]`` for ``lax.scan``; an eager loop needs no
stacking — ``convert.params_from_jax`` unstacks.)  Only the dense
``((ATTN, DENSE_FFN),)`` pattern is ported.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import (ATTN, DENSE_FFN, ModelConfig,
                                      ParallelConfig)
from repro_torch.device import resolve_device
from repro_torch.models import attention, ffn
from repro_torch.models import init_utils as iu
from repro_torch.parallel.sharding import TP_NOT_PORTED, pad_vocab


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


def check_ported(cfg: ModelConfig) -> None:
    """Raise unless every layer is the dense (ATTN, DENSE_FFN) pair."""
    kinds = set(expanded_pattern(cfg))
    if kinds != {(ATTN, DENSE_FFN)}:
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {sorted(kinds)} — only (attn, ffn) "
            "is ported (ROADMAP 'Modules still to port', the other "
            "families)")


def _frozen(params: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in params.items()})


class Block(nn.Module):
    """One layer: ``mixer`` (wqkv, wo, norm[, bqkv]) and ``ffn`` (w1, w3 |
    w13, w2, norm) parameter dicts."""

    def __init__(self, mixer: Dict[str, torch.Tensor],
                 ffn_params: Dict[str, torch.Tensor]):
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
    norms, zeros for the QKV bias and for every padded row/column.  The
    numbers differ from JAX's for the same seed; tests hand the reference's
    weights across with ``convert.params_from_jax``."""
    if par.tp != 1:
        raise NotImplementedError(TP_NOT_PORTED)
    check_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    v_pad = pad_vocab(cfg.vocab_size, par.tp)
    embed = iu.zero_pad_rows(
        torch.randn((cfg.vocab_size, cfg.d_model), generator=gen, device=dev)
        * cfg.d_model ** -0.5, v_pad).to(dtype)
    blocks = []
    for _ in range(cfg.num_layers):
        mixer = attention.init_gqa(gen, cfg, par.tp, dtype, dev)
        f = ffn.init_ffn(gen, cfg.d_model, cfg.d_ff, par.tp, dtype, dev,
                         fuse13=par.fuse_w13)
        blocks.append(Block(mixer, f))
    return Model(embed, torch.ones(cfg.d_model, dtype=dtype, device=dev),
                 blocks)

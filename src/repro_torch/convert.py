"""Hand the reference's parameters (and caches) across to the port.

The reference's parameter tree is ``{"embed", "final_norm", "lead": [...],
"periods": [per pattern position: leaves stacked [reps, ...]]}`` (see
``repro.models.model.init_model``); its caches mirror it under
``{"lead", "periods": [{"mixer": {"k", "v"}, "ffn": {}}]}``.  Layer ``i``
of the expanded pattern is ``lead[i]`` for the leading layers and
``periods[pos][rep]`` after them (``i = lead + rep * period + pos``).
Arrays cross as numpy: bf16 leaves go as float32 and are cast back, which
is exact.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import Block, Model, check_ported, n_periods


def _tensor(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        device=device, dtype=dtype)


def _layer_trees(tree: Dict[str, Any],
                 cfg: ModelConfig) -> List[Dict[str, Any]]:
    """The reference's per-layer subtrees in expanded-pattern order."""
    lead = cfg.leading_dense_layers
    period = len(cfg.pattern)
    out = list(tree.get("lead", []))[:lead]
    for rep in range(n_periods(cfg)):
        for pos in range(period):
            stacked = tree["periods"][pos]
            out.append({part: {n: a[rep] for n, a in leaves.items()}
                        for part, leaves in stacked.items()})
    return out


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    dtype: torch.dtype = torch.bfloat16,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Model:
    """The reference's parameter tree (leaves as numpy arrays) -> ``Model``."""
    check_ported(cfg)
    dev = resolve_device(device)
    blocks = [Block({n: _tensor(a, dtype, dev)
                     for n, a in layer["mixer"].items()},
                    {n: _tensor(a, dtype, dev)
                     for n, a in layer["ffn"].items()})
              for layer in _layer_trees(tree, cfg)]
    return Model(_tensor(tree["embed"], dtype, dev),
                 _tensor(tree["final_norm"], dtype, dev), blocks)


def caches_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> List[Dict[str, torch.Tensor]]:
    """The reference's attention caches (leaves as numpy) -> the port's
    per-layer ``{"k", "v"}`` list, bf16."""
    dev = resolve_device(device)
    return [{n: _tensor(a, torch.bfloat16, dev)
             for n, a in layer["mixer"].items()}
            for layer in _layer_trees(tree, cfg)]

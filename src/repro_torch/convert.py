"""Hand the reference's parameters (and caches) across to the port.

The reference's parameter tree is ``{"embed", "final_norm", "lead": [...],
"periods": [per pattern position: leaves stacked [reps, ...]], "mtp"}``
(see ``repro.models.model.init_model``; leaves may nest, as the MoE's
``shared`` expert does); its caches mirror it under ``{"lead", "periods":
[{"mixer": {"k", "v"} or {"c", "kr"}, "ffn": {}}]}``.  Layer ``i`` of the
expanded pattern is ``lead[i]`` for the leading layers and
``periods[pos][rep]`` after them (``i = lead + rep * period + pos``); a
Mamba layer's state ``{"conv", "ssm"}`` and an RWKV layer's (``mixer``
``{"state", "last"}``, ``ffn`` ``{"last"}``) ride the same tree.  The
multi-token-prediction head ``{"mixer", "ffn", "proj"}`` becomes the
``Model``'s ``mtp`` when the tree holds it.  Arrays cross as numpy: bf16
leaves go as float32 and are cast back, which is exact.

At tp>1 the reference's tree (``init_model`` with ``ParallelConfig(tp)``,
before ``shard_map`` cuts it) holds the GLOBAL weights packed for that tp;
``rank_params_from_jax`` converts it once and cuts each rank's copy with
``model.shard_params``.  The reference's training tree is the same tree:
``trainable=True`` gives trainable leaves.

The other way, ``to_jax_tree`` turns the port's named leaves (a ``Model``'s
``named_parameters()``, or the trainer's grads keyed the same way) into
the reference's tree of numpy arrays, period leaves stacked, so that tests
compare leaf by leaf.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.ffn import FP32_PARAMS
from repro_torch.models.model import (Block, Model, MTPBlock,
                                      check_ported, layer_trees,
                                      reference_tree, shard_params)
from repro_torch.models.serve import FFN_PREFIX


def _tensor(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        device=device, dtype=dtype)


def _params(leaves: Dict[str, Any], dtype: torch.dtype,
            device: torch.device) -> Dict:
    """A (nested) leaf dict as tensors: ``dtype``, except the leaves the
    reference keeps in fp32 whatever its dtype (``ffn.FP32_PARAMS``: the
    MoE router, a Mamba mixer's ``a_log`` and ``d_skip``, an RWKV
    time-mix's ``dec_base`` and ``u_bonus``)."""
    return {n: _params(a, dtype, device) if isinstance(a, dict)
            else _tensor(a, torch.float32 if n in FP32_PARAMS else dtype,
                         device)
            for n, a in leaves.items()}


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    dtype: torch.dtype = torch.bfloat16,
                    device: Optional[Union[str, torch.device]] = None,
                    trainable: bool = False) -> Model:
    """The reference's parameter tree (leaves as numpy arrays) -> ``Model``
    with ``dtype`` leaves (``ffn.FP32_PARAMS`` stay fp32, as in the
    reference)."""
    check_ported(cfg)
    dev = resolve_device(device)
    blocks = [Block(_params(layer["mixer"], dtype, dev),
                    _params(layer["ffn"], dtype, dev))
              for layer in layer_trees(tree, cfg)]
    mtp = None
    if "mtp" in tree:
        t = tree["mtp"]
        mtp = MTPBlock(_params(t["mixer"], dtype, dev),
                       _params(t["ffn"], dtype, dev),
                       _tensor(t["proj"], dtype, dev))
    return Model(_tensor(tree["embed"], dtype, dev),
                 _tensor(tree["final_norm"], dtype, dev), blocks, trainable,
                 mtp)


def rank_params_from_jax(tree: Dict[str, Any], cfg: ModelConfig, tp: int,
                         dtype: torch.dtype = torch.bfloat16,
                         device: Optional[Union[str, torch.device]] = None,
                         trainable: bool = False) -> List[Model]:
    """The reference's global tp-packed tree -> one ``Model`` per rank."""
    full = params_from_jax(tree, cfg, dtype=dtype, device=device,
                           trainable=trainable)
    return [shard_params(full, r, tp, cfg) for r in range(tp)]


def to_jax_tree(named: Dict[str, torch.Tensor],
                cfg: ModelConfig) -> Dict[str, Any]:
    """The port's leaves keyed as ``Model.named_parameters()`` ("embed",
    "final_norm", "layers.<i>.<mixer|ffn>.<name>[.<name>]", "mtp.<...>")
    -> the reference's tree of float32 numpy arrays
    (``model.reference_tree``: ``lead`` layers as a list, the periods'
    leaves stacked ``[reps, ...]`` per pattern position, ``mtp``)."""
    def np32(tree):
        if isinstance(tree, dict):
            return {n: np32(a) for n, a in tree.items()}
        if isinstance(tree, list):
            return [np32(a) for a in tree]
        return tree.detach().float().cpu().numpy()

    return np32(reference_tree(named, cfg))


# cache leaves kept in fp32: a Mamba layer's SSM state, an RWKV layer's
# wkv state
FP32_CACHES = ("ssm", "state")


def caches_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> List[Dict[str, torch.Tensor]]:
    """The reference's caches (leaves as numpy) -> the port's per-layer
    list of flat dicts (``models.serve``'s layout): ``{"k", "v"}`` (GQA),
    ``{"c", "kr"}`` (MLA), ``{"conv", "ssm"}`` (Mamba) or ``{"state",
    "last", "ffn.last"}`` (RWKV: the reference's ``ffn`` leaves under
    ``serve.FFN_PREFIX``): bf16, the SSM and wkv states fp32
    (``FP32_CACHES``)."""
    dev = resolve_device(device)

    def leaf(n, a):
        return _tensor(a, torch.float32 if n in FP32_CACHES
                       else torch.bfloat16, dev)
    return [{**{n: leaf(n, a) for n, a in layer["mixer"].items()},
             **{FFN_PREFIX + n: leaf(n, a)
                for n, a in layer.get("ffn", {}).items()}}
            for layer in layer_trees(tree, cfg)]

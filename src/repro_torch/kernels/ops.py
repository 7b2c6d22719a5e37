"""Wrappers around the port's GEMM kernels (port of ``repro.kernels.ops``).

``matmul`` is "the best non-split GEMM" (the paper's GEMM_non-split
baseline), routed to the hand-written kernel of ``kernels.matmul``.
``ag_matmul_fused`` and ``matmul_rs_fused`` keep the reference's signatures.
On one device (``n_dev == 1``) each is that GEMM followed by the epilogue
the fused kernels apply in their tile emit.  At ``n_dev > 1`` they are the
fused kernels, called by every rank of the ``dist.RankGroup`` whose
``spmd`` runs them: ``kernels.ag_gemm`` (AllGather-GEMM) and
``kernels.gemm_rs`` (GEMM-ReduceScatter).  Inside a group ``n_dev``
defaults to the group's size; ``axis_name`` is kept for the signature
(the group is the axis).

The reference's MXU-128 ``pick_block`` / ``plan_blocks`` are TPU tiling and
are not carried over; the Hopper kernels' own tile choice is
``kernels.matmul.plan_blocks``, or ``blocks=(bm, bk, bn)`` with ``(bm,
bn)`` one of ``matmul.TILES``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import dist
from repro_torch.kernels import ag_gemm as _ag
from repro_torch.kernels import gemm_rs as _rs
from repro_torch.kernels import matmul as _mm


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Best non-split GEMM (the paper's GEMM_non-split baseline)."""
    return _mm.matmul(a, b, out_dtype=out_dtype)


def _epilogue_by_hand(y: torch.Tensor, activation: Optional[str],
                      bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Single-device form of the fused kernels' tile epilogue, in the same
    fp32 order: bias onto the fp32 value, then the activation, then the
    cast back to ``y``'s dtype."""
    if activation is None and bias is None:
        return y
    return _ag.epilogue_ref(y.float(), activation, bias, y.dtype)


def _resolve(name: str, n_dev: Optional[int]):
    """(n_dev, group): ``n_dev`` defaults to the running group's size; at
    n_dev > 1 the call must run as a rank of a group of that size."""
    group = dist.current_group()
    if n_dev is None:
        if group is None:
            raise ValueError(f"{name}: pass n_dev (or call it inside "
                             "RankGroup.spmd)")
        n_dev = group.n
    if n_dev > 1 and (group is None or group.n != n_dev):
        raise ValueError(
            f"{name} with n_dev={n_dev}: call it from the ranks of a "
            f"dist.RankGroup of {n_dev} (inside group.spmd); "
            f"{'no group' if group is None else f'group of {group.n}'} here")
    return n_dev, group


def _tile(blocks: Optional[Tuple[int, int, int]]):
    return None if blocks is None else (blocks[0], blocks[2])


def ag_matmul_fused(a_shard: torch.Tensor, b_local: torch.Tensor, *,
                    axis_name: str, n_dev: Optional[int] = None,
                    reverse: bool = False, activation: Optional[str] = None,
                    bias: Optional[torch.Tensor] = None,
                    blocks: Optional[Tuple[int, int, int]] = None
                    ) -> torch.Tensor:
    """Fused AllGather-GEMM: ``act(AllGather(a_shard) @ b_local + bias)``.
    At ``n_dev == 1`` the gather is the identity: the GEMM kernel, then
    the epilogue."""
    n_dev, group = _resolve("ag_matmul_fused", n_dev)
    if n_dev == 1:
        return _epilogue_by_hand(matmul(a_shard, b_local), activation, bias)
    return _ag.ag_gemm(a_shard, b_local, group=group, reverse=reverse,
                       activation=activation, bias=bias, tile=_tile(blocks))


def matmul_rs_fused(a_local: torch.Tensor, b_local: torch.Tensor, *,
                    axis_name: str, n_dev: Optional[int] = None,
                    reverse: bool = False, activation: Optional[str] = None,
                    bias: Optional[torch.Tensor] = None,
                    blocks: Optional[Tuple[int, int, int]] = None
                    ) -> torch.Tensor:
    """Fused GEMM-ReduceScatter: ``act(ReduceScatter(a_local @ b_local) +
    bias)``.  At ``n_dev == 1`` the reduce-scatter is the identity: the
    GEMM kernel, then the epilogue."""
    n_dev, group = _resolve("matmul_rs_fused", n_dev)
    if n_dev == 1:
        return _epilogue_by_hand(matmul(a_local, b_local), activation, bias)
    return _rs.gemm_rs(a_local, b_local, group=group, reverse=reverse,
                       activation=activation, bias=bias, tile=_tile(blocks))

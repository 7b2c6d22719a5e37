"""Wrappers around the port's GEMM kernel (port of ``repro.kernels.ops``).

``matmul`` is "the best non-split GEMM" (the paper's GEMM_non-split
baseline), routed to the hand-written kernel of ``kernels.matmul``.
``ag_matmul_fused`` and ``matmul_rs_fused`` keep the reference's signatures;
on one device (``n_dev == 1``) each is that GEMM followed by the epilogue
the fused kernels apply in their tile emit.  The fused AllGather-GEMM and
GEMM-ReduceScatter kernels themselves (``n_dev > 1``) need several cards
and are not ported yet (ROADMAP queue 1 item 2): those calls raise.

The reference's MXU-128 ``pick_block`` / ``plan_blocks`` are TPU tiling and
are not carried over; the Hopper kernel's own tile choice is
``kernels.matmul.plan_blocks``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.overlap import ACTIVATIONS
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
    acc = y.float()
    if bias is not None:
        acc = acc + bias.float()
    if activation is not None:
        acc = ACTIVATIONS[activation](acc)
    return acc.to(y.dtype)


def _single_device(name: str, n_dev: Optional[int]) -> None:
    if n_dev is None:
        raise ValueError(f"{name}: pass n_dev (the port has no mesh axis "
                         "to read it from)")
    if n_dev != 1:
        raise NotImplementedError(
            f"{name} with n_dev={n_dev}: the fused collective kernel needs "
            "several cards and is not ported yet (ROADMAP queue 1 item 2)")


def ag_matmul_fused(a_shard: torch.Tensor, b_local: torch.Tensor, *,
                    axis_name: str, n_dev: Optional[int] = None,
                    reverse: bool = False, activation: Optional[str] = None,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused AllGather-GEMM: ``act(AllGather(a_shard) @ b_local + bias)``.
    At ``n_dev == 1`` the gather is the identity: the kernel GEMM, then the
    epilogue.  ``axis_name`` and ``reverse`` (the ring's axis and
    direction) take effect with the multi-card kernel."""
    _single_device("ag_matmul_fused", n_dev)
    return _epilogue_by_hand(matmul(a_shard, b_local), activation, bias)


def matmul_rs_fused(a_local: torch.Tensor, b_local: torch.Tensor, *,
                    axis_name: str, n_dev: Optional[int] = None,
                    reverse: bool = False, activation: Optional[str] = None,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused GEMM-ReduceScatter: ``act(ReduceScatter(a_local @ b_local) +
    bias)``.  At ``n_dev == 1`` the reduce-scatter is the identity: the
    kernel GEMM, then the epilogue."""
    _single_device("matmul_rs_fused", n_dev)
    return _epilogue_by_hand(matmul(a_local, b_local), activation, bias)

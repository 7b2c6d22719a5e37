"""Parallelism context + padding helpers threaded through the model code.

Every TP seam routes through ``repro_torch.core.overlap`` (``ctx.op(seam)``),
as in the reference.  The port runs one card: tp>1 (the tensor-parallel
seams over NCCL, the fused AllGather-GEMM / GEMM-ReduceScatter kernels)
and ep>1 (the MoE expert exchange over NCCL) raise until their slices
land.  At ep=1 the expert-parallel group is empty, so the ``moe_a2a``
seam is the local expert FFN.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.overlap import SEAM_KINDS, Epilogue, FusedOp

TP_NOT_PORTED = ("tensor parallelism (tp>1) is not ported yet: ROADMAP "
                 "'Modules still to port', item 2 (core/overlap.py ag/rs "
                 "seams over NCCL) with the ag_gemm / gemm_rs kernels")
EP_NOT_PORTED = ("expert parallelism (ep>1) is not ported yet: ROADMAP "
                 "'Modules still to port', item 8 (the MoE a2a seam over "
                 "NCCL, FusedOp(kind='a2a') at ep>1)")


@dataclasses.dataclass(frozen=True)
class TPContext:
    """How the current region is parallelized.

    tp          : tensor-parallel degree; only 1 runs so far, tp>1 raises
    ep          : expert-parallel degree; only 1 runs so far (an empty EP
                  group: ``moe_a2a`` is the local expert FFN), ep>1 raises
    use_kernels : route hot paths through the hand-written kernels
                  (``gqa_train``'s attention -> flash kernel; MLA decode
                  attention -> MLA-decode kernel)
    seq_sharded : residual-stream layout (sequence-sharded by default; the
                  serving decode and chunked prefill switch it off)
    """
    tp: int = 1
    ep: int = 1
    use_kernels: bool = False
    seq_sharded: bool = True

    def __post_init__(self):
        if self.tp != 1:
            raise NotImplementedError(TP_NOT_PORTED)
        if self.ep != 1:
            raise NotImplementedError(EP_NOT_PORTED)

    @property
    def seq_factor(self) -> int:
        """Global sequence length = local length * seq_factor."""
        return self.tp if self.seq_sharded else 1

    def with_layout(self, seq_sharded: bool) -> "TPContext":
        if seq_sharded == self.seq_sharded:
            return self
        return dataclasses.replace(self, seq_sharded=seq_sharded)

    def op(self, seam: str, epilogue: Optional[Epilogue] = None,
           n_weights: int = 1) -> FusedOp:
        """The ``overlap.FusedOp`` for one model seam — the only way model
        code reaches a seam."""
        return FusedOp(SEAM_KINDS[seam],
                       epilogue if epilogue is not None else Epilogue(),
                       n_weights)


def make_ctx(par) -> TPContext:
    """The context a ``ParallelConfig`` implies (the reference's
    ``trainer.make_ctx``): ``use_kernels`` from ``kernel_decode``."""
    return TPContext(tp=par.tp, ep=par.ep, use_kernels=par.kernel_decode)


def ceil_mult(x: int, m: int) -> int:
    """Round x up to a multiple of m."""
    return ((x + m - 1) // m) * m


def pad_heads(num_heads: int, tp: int) -> int:
    if num_heads == 0:
        return 0
    return ceil_mult(num_heads, tp)


def pad_kv_heads(num_kv_heads: int, tp: int) -> int:
    """KV heads: replicate up to TP when fewer than TP, else pad."""
    if num_kv_heads == 0:
        return 0
    if num_kv_heads < tp:
        return tp
    return ceil_mult(num_kv_heads, tp)


def pad_ff(d_ff: int, tp: int, align: int = 128) -> int:
    return ceil_mult(d_ff, tp * align)


def pad_vocab(vocab: int, tp: int, align: int = 128) -> int:
    return ceil_mult(vocab, tp * align)

"""Fused GEMM-ReduceScatter: the CUDA kernels' wrapper and its plain version.

Port of ``repro.kernels.gemm_rs`` (the Pallas TPU kernel
``_gemm_rs_kernel``, the paper's Algorithm 1): every rank of a
``dist.RankGroup`` calls ``gemm_rs`` with ``A_local [M, K_sh]`` (its
contraction columns) and ``B_local [K_sh, N]`` and gets ``act(
ReduceScatter_m(A_local @ B_local) + bias)`` as ``[M / n, N]``: the sum
over ranks of their partials' rows of this rank's shard.

On CUDA tensors it launches ``csrc/gemm_rs.cu`` (built at first use by
``kernels.build``), in the GPU original's form that the TPU ring replaced:
one GEMM launch per rank stores each output tile, rounded to
``partial_dtype``, straight into the owner's reduction slot of the group's
symmetric workspace; after an event barrier across the ranks, one reduce
launch per rank sums its n slots in rank order in fp32, adds the bias
once, applies the activation and casts.  On CPU tensors it runs the same
arithmetic in plain PyTorch over the partials the group exchanges.  There
is no fallback.

``gemm_rs.launches`` counts GEMM launches and ``gemm_rs.reduce_launches``
the reduce launches (never the plain path).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ag_gemm import (ACT_CODES, DTYPE_CODES, check_cuda,
                                         check_operands, epilogue_ref,
                                         tile_args)


def reduce_ref(partials: Sequence[torch.Tensor], me: int,
               activation: Optional[str], bias: Optional[torch.Tensor],
               out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the owner's reduce: rows of shard ``me`` of every
    rank's partial, summed in rank order in fp32, then the epilogue."""
    m_sh = partials[0].shape[0] // len(partials)
    acc = None
    for p in partials:
        rows = p[me * m_sh:(me + 1) * m_sh].float()
        acc = rows if acc is None else acc + rows
    return epilogue_ref(acc, activation, bias, out_dtype)


def gemm_rs_ref(a_locals: Sequence[torch.Tensor],
                b_locals: Sequence[torch.Tensor], me: int,
                activation: Optional[str] = None,
                bias: Optional[torch.Tensor] = None,
                out_dtype: Optional[torch.dtype] = None,
                partial_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version for rank ``me``: each rank's fp32 partial
    ``a @ b`` rounded to ``partial_dtype`` (default ``out_dtype``, default
    the inputs' dtype), then ``reduce_ref``."""
    out_dtype = out_dtype or a_locals[0].dtype
    partial_dtype = partial_dtype or out_dtype
    parts = [(a.float() @ b.float()).to(partial_dtype)
             for a, b in zip(a_locals, b_locals)]
    return reduce_ref(parts, me, activation, bias, out_dtype)


def gemm_rs(a_local: torch.Tensor, b_local: torch.Tensor, *, group,
            reverse: bool = False, activation: Optional[str] = None,
            bias: Optional[torch.Tensor] = None,
            out_dtype: Optional[torch.dtype] = None,
            partial_dtype: Optional[torch.dtype] = None,
            tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """out[M / n, N] = act(ReduceScatter(a_local @ b_local) + bias).
    Called by every rank of ``group`` inside ``spmd``, all with operands of
    one shape.  ``reverse`` flips the owner walk (not the result)."""
    out_dtype = out_dtype or a_local.dtype
    partial_dtype = partial_dtype or out_dtype
    check_operands("gemm_rs", a_local, b_local, bias, activation, out_dtype)
    if partial_dtype not in DTYPE_CODES:
        raise ValueError(f"gemm_rs: partial_dtype {partial_dtype}")
    n, me = group.n, group.rank()
    m, k = a_local.shape
    n_out = b_local.shape[1]
    if m % n:
        raise ValueError(f"gemm_rs: M={m} is not divisible by {n} ranks")
    m_sh = m // n
    on_cpu = all(t is None or t.device.type == "cpu"
                 for t in (a_local, b_local, bias))
    if on_cpu:
        p = (a_local.float() @ b_local.float()).to(partial_dtype)
        parts = group.exchange(p, "gemm_rs")
        if any(q.shape != p.shape for q in parts):
            raise ValueError("gemm_rs: ranks' partials differ in shape")
        return reduce_ref(parts, me, activation, bias, out_dtype)
    if a_local.device.type != "cuda":
        raise ValueError(f"gemm_rs: unsupported device {a_local.device}")
    check_cuda("gemm_rs", a_local, b_local, bias)
    build.refuse_grad("gemm_rs", "2.1", a_local, b_local, bias)
    if n > MAX_RANKS:
        raise ValueError(f"gemm_rs: {n} ranks > the kernel's {MAX_RANKS}")
    targs = tile_args(m, n_out, m_sh, a_local.dtype, tile)
    lib = _library()
    stream = torch.cuda.current_stream(a_local.device)
    # every owner's earlier reduce is done with its workspace before this
    # rank's tiles land in it
    pairs = group.publish(a_local, "gemm_rs")
    if any(t.shape != a_local.shape or t.dtype != a_local.dtype
           for t, _ in pairs):
        raise ValueError("gemm_rs: ranks' operands differ")
    for owner in range(n):
        if owner != me:
            stream.wait_event(pairs[owner][1])
    ws = group.symmetric("gemm_rs.ws", (n, m_sh, n_out), partial_dtype)
    ptrs = (ctypes.c_void_p * n)(*[w.data_ptr() for w in ws])
    err = lib.gemm_rs_fwd(a_local.data_ptr(), b_local.data_ptr(), ptrs, m_sh,
                          n_out, k, n, me, int(reverse),
                          DTYPE_CODES[a_local.dtype],
                          DTYPE_CODES[partial_dtype], *targs,
                          stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"gemm_rs kernel launch failed: CUDA error {err}")
    build.count_launch(gemm_rs)
    # every rank's tiles have landed in this rank's slots
    group.stream_barrier("gemm_rs.partials")
    bias_f = None if bias is None else bias.float().contiguous()
    out = torch.empty((m_sh, n_out), dtype=out_dtype, device=a_local.device)
    err = lib.gemm_rs_reduce(ws[me].data_ptr(),
                             None if bias_f is None else bias_f.data_ptr(),
                             out.data_ptr(), m_sh, n_out, n,
                             ACT_CODES[activation],
                             DTYPE_CODES[partial_dtype],
                             DTYPE_CODES[out_dtype], stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"gemm_rs reduce launch failed: CUDA error {err}")
    build.count_launch(gemm_rs, "reduce_launches")
    return out


gemm_rs.launches = 0
gemm_rs.reduce_launches = 0
MAX_RANKS = 8            # csrc/gemm_rs.cu kMaxRanks


def _library() -> ctypes.CDLL:
    lib = build.load("gemm_rs")
    if lib.gemm_rs_fwd.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.gemm_rs_fwd.argtypes = [vp, vp, ctypes.POINTER(vp)] \
            + [i] * 12 + [vp]
        lib.gemm_rs_fwd.restype = i
        lib.gemm_rs_reduce.argtypes = [vp, vp, vp] + [i] * 6 + [vp]
        lib.gemm_rs_reduce.restype = i
    return lib

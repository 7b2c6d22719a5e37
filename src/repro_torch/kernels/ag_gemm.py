"""Fused AllGather-GEMM: the CUDA kernel's wrapper and its plain version.

Port of ``repro.kernels.ag_gemm`` (the Pallas TPU kernel ``_ag_gemm_kernel``,
the paper's Algorithms 2/3): every rank of a ``dist.RankGroup`` calls
``ag_gemm`` with its row shard ``A_shard [M_sh, K]`` and its column shard
``B_local [K, N_loc]`` and gets ``act(AllGather_m(A_shard) @ B_local +
bias)`` as ``[n * M_sh, N_loc]``, rows in shard-major (rank) order.

On CUDA tensors it launches ``csrc/ag_gemm.cu`` (built at first use by
``kernels.build``): on the rank's copy stream, n - 1 copy-engine pulls of
the peers' shards into the rank's symmetric A_agg buffer, each followed by
a stream write of its ready flag, in the reference's ring order; on the
rank's stream, one GEMM launch whose blocks wait on the flags of the
shards they read.  On CPU
tensors it runs the plain version ``ag_gemm_ref`` over the shards the
group exchanges.  There is no fallback: a CUDA tensor the kernel does not
take, or a build or launch failure, raises.

``ag_gemm.launches`` counts kernel launches (never the plain path).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.overlap import ACTIVATIONS
from repro_torch.kernels import build
from repro_torch.kernels import matmul as _mm

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernels' epilogue activation codes (csrc/gemm_tile.cuh::activate)
ACT_CODES = {None: 0, "silu": 1, "gelu": 2, "relu": 3, "sqrelu": 4}


def epilogue_ref(acc: torch.Tensor, activation: Optional[str],
                 bias: Optional[torch.Tensor],
                 out_dtype: torch.dtype) -> torch.Tensor:
    """The kernels' tile epilogue on an fp32 value: + bias (as fp32), then
    the activation, then the cast."""
    if bias is not None:
        acc = acc + bias.float()
    if activation is not None:
        acc = ACTIVATIONS[activation](acc)
    return acc.to(out_dtype)


def ag_gemm_ref(shards: Sequence[torch.Tensor], b_local: torch.Tensor,
                activation: Optional[str] = None,
                bias: Optional[torch.Tensor] = None,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version: gather the ranks' shards in rank order
    (``torch.cat``), the fp32 product, the epilogue, the cast to
    ``out_dtype`` (default the shards' dtype)."""
    full = torch.cat(list(shards), dim=0)
    return epilogue_ref(full.float() @ b_local.float(), activation, bias,
                        out_dtype or full.dtype)


def check_operands(name: str, a: torch.Tensor, b: torch.Tensor,
                   bias: Optional[torch.Tensor], activation: Optional[str],
                   out_dtype: torch.dtype) -> None:
    """The operand rules both fused kernels share (the plain path too):
    the GEMM kernel's, an epilogue activation, a bias of N."""
    _mm._check(a, b, out_dtype, name)
    if activation not in ACT_CODES:
        raise ValueError(f"{name}: unknown activation {activation!r}")
    if bias is not None and tuple(bias.shape) != (b.shape[1],):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} != "
                         f"({b.shape[1]},)")


def check_cuda(name: str, a: torch.Tensor, b: torch.Tensor,
               bias: Optional[torch.Tensor]) -> None:
    """What the CUDA kernels take (raises otherwise): the GEMM kernel's
    rules, and the bias on the same device."""
    _mm._check_cuda(a, b, name)
    if bias is not None and bias.device != a.device:
        raise ValueError(f"{name}: bias on {bias.device}, A on {a.device}")


def tile_args(m: int, n: int, m_sh: int, dtype: torch.dtype,
              tile: Optional[Tuple[int, int]]) -> Tuple[int, int, int, int]:
    """(tile code, m_pad, box_rows, group_m) of a bf16 launch over m rows
    in row blocks of ``m_sh`` (``matmul.walk_args``): ``tile`` when given
    (one of ``matmul.TILES``), else ``matmul.plan_blocks`` over the whole
    launch's rows.  fp32 has one tile and ignores all four."""
    if dtype != torch.bfloat16:
        return 0, 0, 0, 0
    tile = tuple(tile) if tile is not None else _mm.plan_blocks(m, n)
    if tile not in _mm.TILES:
        raise ValueError(f"tile {tile}: the kernels take {list(_mm.TILES)}")
    return (_mm.TILES[tile], *_mm.walk_args(m_sh, tile))


def ag_gemm(a_shard: torch.Tensor, b_local: torch.Tensor, *, group,
            reverse: bool = False, activation: Optional[str] = None,
            bias: Optional[torch.Tensor] = None,
            out_dtype: Optional[torch.dtype] = None,
            tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """C[n * M_sh, N_loc] = act(AllGather(a_shard) @ b_local + bias), fp32
    accumulation.  Called by every rank of ``group`` inside ``spmd``, all
    with shards of one shape.  ``reverse`` flips the ring order of the
    pulls and of the kernel's walk (not the result); ``tile`` picks the
    bf16 output tile.  Every rank on the card runs at once (the group's n,
    or a mesh's size when the group is one of its sub-groups:
    ``group.share``), so each launch holds at most 1/share of its block
    slots (``csrc/ag_gemm.cu``)."""
    out_dtype = out_dtype or a_shard.dtype
    check_operands("ag_gemm", a_shard, b_local, bias, activation, out_dtype)
    on_cpu = all(t is None or t.device.type == "cpu"
                 for t in (a_shard, b_local, bias))
    if on_cpu:
        shards = group.exchange(a_shard, "ag_gemm")
        _check_same(shards, a_shard)
        return ag_gemm_ref(shards, b_local, activation, bias, out_dtype)
    if a_shard.device.type != "cuda":
        raise ValueError(f"ag_gemm: unsupported device {a_shard.device}")
    check_cuda("ag_gemm", a_shard, b_local, bias)
    build.refuse_grad("ag_gemm", "2.1", a_shard, b_local, bias)
    n, me = group.n, group.rank()
    m_sh, k = a_shard.shape
    n_loc = b_local.shape[1]
    targs = tile_args(n * m_sh, n_loc, m_sh, a_shard.dtype, tile)
    lib = _library()
    pairs = group.publish(a_shard, "ag_gemm")
    _check_same([t for t, _ in pairs], a_shard)
    stream = torch.cuda.current_stream(a_shard.device)
    comm = group.comm_stream(me)
    a_agg = group.symmetric("ag_gemm.a_agg", (n, m_sh, k), a_shard.dtype)[me]
    flags = group.symmetric("ag_gemm.flags", (n,), torch.int32,
                            zero=True)[me]
    epoch = group.next_epoch()
    # this rank's earlier launches are done with A_agg and the flags before
    # the copies rewrite them
    comm.wait_event(pairs[me][1])
    sgn = -1 if reverse else 1
    for s in range(1, n):
        owner = (me - sgn * s) % n
        src = group.wait_for(pairs[owner], comm)   # after owner's producer
        err = lib.ag_gemm_pull(a_agg[owner].data_ptr(), src.data_ptr(),
                               src.nbytes, flags.data_ptr() + 4 * owner,
                               epoch, comm.cuda_stream)
        if err != 0:
            raise RuntimeError(f"ag_gemm shard copy failed: CUDA error {err}")
    # every rank has queued its copies before any rank launches a kernel
    # that waits on them: a copy never sits behind a waiting kernel in a
    # hardware queue that the streams share
    group.barrier("ag_gemm.copies")
    # every shard's producer is done before the launch: a block that waits
    # on a flag waits only for the copies (copy engines), never for work
    # that needs an SM
    for owner in range(n):
        if owner != me:
            stream.wait_event(pairs[owner][1])
    bias_f = None if bias is None else bias.float().contiguous()
    out = torch.empty((n * m_sh, n_loc), dtype=out_dtype,
                      device=a_shard.device)
    err = lib.ag_gemm_fwd(
        a_shard.data_ptr(), a_agg.data_ptr(), flags.data_ptr(),
        b_local.data_ptr(), None if bias_f is None else bias_f.data_ptr(),
        out.data_ptr(), m_sh, n_loc, k, n, me, int(reverse), epoch,
        ACT_CODES[activation], DTYPE_CODES[a_shard.dtype],
        DTYPE_CODES[out_dtype], *targs, group.share, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"ag_gemm kernel launch failed: CUDA error {err}")
    build.count_launch(ag_gemm)
    return out


ag_gemm.launches = 0


def _check_same(shards: Sequence[torch.Tensor], mine: torch.Tensor) -> None:
    for t in shards:
        if t.shape != mine.shape or t.dtype != mine.dtype:
            raise ValueError(f"ag_gemm: ranks' shards differ: "
                             f"{tuple(t.shape)} {t.dtype} vs "
                             f"{tuple(mine.shape)} {mine.dtype}")


def _library() -> ctypes.CDLL:
    lib = build.load("ag_gemm")
    if lib.ag_gemm_fwd.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.ag_gemm_pull.argtypes = [vp, vp, ctypes.c_size_t, vp, i, vp]
        lib.ag_gemm_pull.restype = i
        lib.ag_gemm_fwd.argtypes = [vp] * 6 + [i] * 15 + [vp]
        lib.ag_gemm_fwd.restype = i
    return lib

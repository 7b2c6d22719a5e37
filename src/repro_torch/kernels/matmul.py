"""Dense GEMM: the CUDA kernel's wrapper and its plain version.

Port of ``repro.kernels.matmul`` (the Pallas TPU kernel ``_matmul_kernel``,
"the best non-split GEMM": GEMM_non-split of the paper's ECT metric, Eq. 1).
``matmul`` launches the hand-written Hopper kernel ``csrc/matmul.cu`` (built
at first use by ``kernels.build``) for CUDA tensors, and runs the plain
PyTorch version ``matmul_ref`` for CPU tensors.  There is no fallback: a
CUDA tensor the kernel does not take, or a build or launch failure, raises.

``matmul.launches`` counts kernel launches (never the plain path), so a run
can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ALIGN = 16              # cp.async / float4 loads of 16 bytes
# bf16 tiles the kernel takes (BM, BN) -> its tile code; fp32 has one tile
TILES = {(128, 128): 0, (64, 64): 1}
WIDE, NARROW = (128, 128), (64, 64)
SMS = 132                # streaming multiprocessors of an H100 SXM


def plan_blocks(m: int, n: int) -> Tuple[int, int]:
    """The bf16 kernel's output tile for an [m, n] product: 128 x 128, or
    64 x 64 when 128 x 128 tiles would not fill the card's SMs once (small
    m, the decode rows of the op-level sweep)."""
    wide_tiles = -(-m // WIDE[0]) * -(-n // WIDE[1])
    return NARROW if wide_tiles < SMS else WIDE


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version: fp32 product, cast to ``out_dtype`` (default
    ``a.dtype``), as ``kernels/ref.py::matmul_ref`` followed by the TPU
    kernel's output cast."""
    return (a.float() @ b.float()).to(out_dtype or a.dtype)


def _check(a, b, out_dtype):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul takes A [M, K] and B [K, N], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtypes {a.dtype}/{b.dtype}: need both float32 or "
                         "both bfloat16")
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"out_dtype {out_dtype}: need float32 or bfloat16")


def _check_cuda(a, b):
    if b.device != a.device:
        raise ValueError(f"a, b on different devices: {a.device}, {b.device}")
    m, k = a.shape
    n = b.shape[1]
    if min(m, k, n) == 0:
        raise ValueError(f"empty matmul ({m}, {k}, {n})")
    if max(m, k, n) >= 2 ** 31:
        raise ValueError(f"dims ({m}, {k}, {n}) exceed the kernel's int32")
    vec = _ALIGN // a.element_size()
    if k % vec or n % vec:
        raise ValueError(f"K={k} and N={n} must be multiples of {vec} for "
                         f"{a.dtype}: the kernel loads rows in 16-byte "
                         "chunks")
    for name, t in (("a", a), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (row-major)")
        if t.data_ptr() % _ALIGN:
            raise ValueError(f"{name} is not {_ALIGN}-byte aligned")


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C = A @ B with fp32 accumulation, cast to ``out_dtype`` (default
    ``a.dtype``).  A [M, K], B [K, N], both float32 or both bfloat16,
    row-major.  CUDA tensors launch the kernel (bf16 output tile from
    ``plan_blocks``; ragged M and N edges are masked and a ragged K tail
    zero-filled); CPU tensors run ``matmul_ref``."""
    out_dtype = out_dtype or a.dtype
    _check(a, b, out_dtype)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_ref(a, b, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"matmul: unsupported device {a.device}")
    _check_cuda(a, b)
    m, n = a.shape[0], b.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    err = _library().matmul_fwd(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, a.shape[1],
        _DTYPE_CODES[a.dtype], _DTYPE_CODES[out_dtype],
        TILES[plan_blocks(m, n)],
        torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"matmul kernel launch failed: CUDA error {err}")
    matmul.launches += 1
    return out


matmul.launches = 0


def _library() -> ctypes.CDLL:
    from repro_torch.kernels import build
    lib = build.load("matmul")
    fn = lib.matmul_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib

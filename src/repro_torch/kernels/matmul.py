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
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ALIGN = 16              # TMA strides and bases / float4 loads: 16 bytes
# bf16 tiles the kernel takes (BM, BN) -> its tile code
# (csrc/gemm_tile.cuh LargeTile, SmallTile); fp32 has one tile
LARGE, SMALL = (128, 256), (64, 64)
TILES = {LARGE: 0, SMALL: 1}
BK = 64                  # the bf16 tile loop's K step (gemm_tile.cuh kBK)
SMS = 132                # streaming multiprocessors of an H100 SXM
GROUP_M = 8              # csrc/gemm_tile.cuh kGroupM
MIN_BOX_ROWS = 8         # one 1024-byte swizzle atom of A rows


def plan_blocks(m: int, n: int) -> Tuple[int, int]:
    """The bf16 kernel's output tile for an [m, n] product: 128 x 256 when
    those tiles fill at least half the card's SMs (one wave of the
    persistent grid), else 64 x 64 (small m, the decode rows of the
    op-level sweep; two CTAs an SM).  Set from
    scripts/torch_gemm_configs.py's sweep (PERF.md)."""
    if -(-m // LARGE[0]) * -(-n // LARGE[1]) >= SMS // 2:
        return LARGE
    return SMALL


def tile_blocks(tile: Tuple[int, int]) -> Tuple[int, int, int]:
    """The ``blocks`` triple (bm, bk, bn) of a bf16 tile (bm, bn): what a
    ``FusedOp`` or a tuned ``SeamPlan`` carries (bk is the K step)."""
    return (tile[0], BK, tile[1])


def a_boxes(m_sh: int, bm: int) -> Tuple[int, int]:
    """(m_pad, box_rows) of the bf16 kernels' A tensor map for row blocks
    of ``m_sh`` rows under a tile of ``bm`` rows (csrc/gemm_tile.cuh):
    each block is padded to m_pad virtual rows and loaded in boxes of
    box_rows rows.  m_sh >= bm: m_pad the next multiple of bm, one box a
    tile (no tile straddles two blocks); else a power of two >= m_sh
    (at least 8 rows, one swizzle atom) that divides bm, one box a block,
    several blocks a tile."""
    if m_sh <= 0 or bm & (bm - 1):
        raise ValueError(f"a_boxes: m_sh={m_sh}, bm={bm}")
    if m_sh >= bm:
        return -(-m_sh // bm) * bm, bm
    m_pad = max(MIN_BOX_ROWS, 1 << (m_sh - 1).bit_length())
    return m_pad, m_pad


def raster_group(m_pad: int, bm: int) -> int:
    """Tile rows of a raster group of the bf16 kernels: the largest
    divisor of a row block's tiles (m_pad / bm) up to GROUP_M, so that no
    group straddles two blocks and the blocks' tiles come in walk order;
    GROUP_M when several blocks share a tile row."""
    if m_pad < bm:
        return GROUP_M
    per_block = m_pad // bm
    return max(g for g in range(1, GROUP_M + 1) if per_block % g == 0)


def walk_args(m_sh: int, tile: Tuple[int, int]) -> Tuple[int, int, int]:
    """(m_pad, box_rows, group_m) the bf16 kernels take for row blocks of
    ``m_sh`` rows under output tile ``tile``."""
    m_pad, box_rows = a_boxes(m_sh, tile[0])
    return m_pad, box_rows, raster_group(m_pad, tile[0])


def tile_coords(t: int, tiles_m: int, tiles_n: int,
                group: int = GROUP_M) -> Tuple[int, int]:
    """(tile row, tile column) of linear tile ``t`` in the kernels' raster
    (csrc/gemm_tile.cuh tile_coords): groups of ``group`` tile rows,
    column-major inside a group."""
    per_group = group * tiles_n
    first_m = (t // per_group) * group
    group_m = min(tiles_m - first_m, group)
    return first_m + (t % per_group) % group_m, (t % per_group) // group_m


def persistent_grid(tiles: int, share: int, slots: int,
                    reserved: int = 0) -> int:
    """CTAs of a persistent bf16 launch (csrc/gemm_tile.cuh
    persistent_grid): every resident slot, at most one a tile; when
    ``share`` ranks run on one card, 1/share of the slots less
    ``reserved``."""
    if share > 1:
        slots = (slots - reserved) // share
    return max(1, min(slots, tiles))


def block_tiles(block: int, grid: int, tiles_m: int, tiles_n: int,
                group: int = GROUP_M) -> List[Tuple[int, int]]:
    """The (tile row, tile column) pairs CTA ``block`` of a persistent
    ``grid`` computes, in order: tiles block, block + grid, ..."""
    return [tile_coords(t, tiles_m, tiles_n, group)
            for t in range(block, tiles_m * tiles_n, grid)]


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version: fp32 product, cast to ``out_dtype`` (default
    ``a.dtype``), as ``kernels/ref.py::matmul_ref`` followed by the TPU
    kernel's output cast."""
    return (a.float() @ b.float()).to(out_dtype or a.dtype)


def _check(a, b, out_dtype, name="matmul"):
    """The operand rules of the GEMM kernels (the fused kernels' wrappers
    use them too)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{name} takes A [M, K] and B [K, N], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtypes {a.dtype}/{b.dtype}: need both "
                         "float32 or both bfloat16")
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: out_dtype {out_dtype}: need float32 or "
                         "bfloat16")


def _check_cuda(a, b, name="matmul"):
    """What the CUDA GEMM kernels take (raises otherwise)."""
    if b.device != a.device:
        raise ValueError(f"{name}: a, b on different devices: {a.device}, "
                         f"{b.device}")
    m, k = a.shape
    n = b.shape[1]
    if min(m, k, n) == 0:
        raise ValueError(f"{name}: empty product ({m}, {k}, {n})")
    if max(m, k, n) >= 2 ** 31:
        raise ValueError(f"{name}: dims ({m}, {k}, {n}) exceed the "
                         "kernel's int32")
    vec = _ALIGN // a.element_size()
    if k % vec or n % vec:
        raise ValueError(f"{name}: K={k} and N={n} must be multiples of "
                         f"{vec} for {a.dtype}: the kernel loads rows in "
                         "16-byte chunks")
    for nm, t in (("a", a), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous (row-major)")
        if t.data_ptr() % _ALIGN:
            raise ValueError(f"{name}: {nm} is not {_ALIGN}-byte aligned")


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
    build.refuse_grad("matmul", "2.1", a, b)
    m, n = a.shape[0], b.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    block = plan_blocks(m, n)
    err = _library().matmul_fwd(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, a.shape[1],
        _DTYPE_CODES[a.dtype], _DTYPE_CODES[out_dtype], TILES[block],
        *walk_args(m, block), torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"matmul kernel launch failed: CUDA error {err}")
    build.count_launch(matmul)
    return out


matmul.launches = 0


def _library() -> ctypes.CDLL:
    lib = build.load("matmul")
    fn = lib.matmul_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib

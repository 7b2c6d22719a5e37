"""Op-level GEMM_non-split at the paper's §5.1 shapes (port of the
single-device part of ``benchmarks/op_level.py``).

  PYTHONPATH=src python -m repro_torch.launch.op_level
  PYTHONPATH=src python -m repro_torch.launch.op_level --device cpu

GPT-3 175B at TP 8: the AllGather-GEMM seam has (n, k) = (49152, 12288), so
each rank multiplies [m, 12288] x [12288, 6144]; the GEMM-ReduceScatter seam
has (n, k) = (12288, 49152), so each rank multiplies [m, 6144] x
[6144, 12288]; m runs over the reference's sweep, bf16.  Each shape goes
through ``ops.ag_matmul_fused`` / ``ops.matmul_rs_fused`` at ``n_dev=1``,
which launch the port's GEMM kernel: the GEMM_non-split of ECT (Eq. 1).
``torch.matmul`` on the same inputs is timed beside it as the library
yardstick only.  ECT itself needs the overall time of a tp>1 seam, which
one card cannot give, so no ECT or overlap efficiency is printed.

CSV on stdout: ``name,us_per_call,derived``.  ``derived`` is the share of
the card's bound (H100 SXM: 989 TFLOP/s bf16, 3.35 TB/s) that the row
reaches, in percent.  On the CPU (``--device cpu``) the dims are cut by
``--scale``, the plain version runs, and ``derived`` is ``-``: the bound is
the card's.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core import ect
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

M_SWEEP = [64, 512, 1024, 2048, 4096, 8192]
N_TP = 8                      # the paper's single-node TP degree
SEAMS = (("ag", (49152, 12288)), ("rs", (12288, 49152)))   # (n, k)
H100_SXM_BF16_FLOPS = 989e12  # dense, NVIDIA data sheet
H100_SXM_HBM_BW = 3.35e12
CPU_SCALE = 16                # dims cut for a CPU run (as the reference's)


def rank_shape(seam: str, m: int, n: int, k: int,
               scale: int = 1) -> Tuple[int, int, int]:
    """Per-rank GEMM (m, k, n) of one seam at TP ``N_TP``, dims cut by
    ``scale``: AG splits n over the ranks, RS splits k."""
    n_r, k_r = (n // N_TP, k) if seam == "ag" else (n, k // N_TP)
    return max(m // scale, 8), k_r // scale, n_r // scale


def gemm_bound_s(m: int, k: int, n: int, dtype_bytes: int = 2
                 ) -> Tuple[float, str]:
    """Least time of an [m, k] x [k, n] GEMM on an H100 SXM: the larger of
    2 m n k operations over the bf16 peak and the bytes (A, B read once, C
    written once) over HBM bandwidth, with what sets it."""
    t_ops = 2.0 * m * n * k / H100_SXM_BF16_FLOPS
    t_bytes = dtype_bytes * (m * k + k * n + m * n) / H100_SXM_HBM_BW
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def gemm_inputs(m: int, k: int, n: int, device: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Standard-normal bf16 A [m, k] and B [k, n] on ``device``, from seed
    0."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    a = torch.randn((m, k), generator=gen, device=device).bfloat16()
    b = torch.randn((k, n), generator=gen, device=device).bfloat16()
    return a, b


def seam_gemm(seam: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The seam's GEMM_non-split through its fused wrapper at one device."""
    fused = ops.ag_matmul_fused if seam == "ag" else ops.matmul_rs_fused
    return fused(a, b, axis_name="tp", n_dev=1)


def main(device: Optional[str] = None, scale: Optional[int] = None,
         iters: int = 10, warmup: int = 2) -> List[Dict]:
    """Time every (seam, m) GEMM_non-split and its ``torch.matmul``
    yardstick; print the CSV and return one dict a row pair.  Each row's
    kernel path makes ``warmup + iters`` calls (``calls``)."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    scale = scale or (1 if on_card else CPU_SCALE)
    where = torch.cuda.get_device_name(dev) if on_card else "cpu (plain)"
    print(f"# op_level on {where}, dims / {scale}, median of {iters} warm "
          "calls", file=sys.stderr)
    rows = []
    for seam, (n, k) in SEAMS:
        for m in M_SWEEP:
            mr, kr, nr = rank_shape(seam, m, n, k, scale)
            a, b = gemm_inputs(mr, kr, nr, dev)
            kern_s = ect.time_fn(seam_gemm, seam, a, b, iters=iters,
                                 warmup=warmup, device=dev)
            lib_s = ect.time_fn(torch.matmul, a, b, iters=iters,
                                warmup=warmup, device=dev)
            bound_s, bound_by = gemm_bound_s(mr, kr, nr)
            rows.append({"seam": seam, "m": m, "shape": [mr, kr, nr],
                         "calls": warmup + iters, "kernel_s": kern_s,
                         "library_s": lib_s, "bound_s": bound_s,
                         "bound_by": bound_by})
            del a, b
    print("name,us_per_call,derived")
    for r in rows:
        for tag, t in (("gemm_nonsplit", r["kernel_s"]),
                       ("torch_matmul", r["library_s"])):
            share = f"{100 * r['bound_s'] / t:.1f}" if on_card else "-"
            print(f"oplevel_{r['seam']}_m{r['m']}_{tag},{t * 1e6:.1f},{share}")
    return rows


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--scale", type=int, default=None,
                    help=f"cut every dim by this (default 1 on the card, "
                         f"{CPU_SCALE} on the CPU)")
    ap.add_argument("--iters", type=int, default=10)
    return ap.parse_args(argv)


if __name__ == "__main__":
    main(**vars(parse_args()))

"""Op-level sweep at the paper's §5.1 shapes (port of
``benchmarks/op_level.py``).

  PYTHONPATH=src python -m repro_torch.launch.op_level            # TP 8
  PYTHONPATH=src python -m repro_torch.launch.op_level --tp 1     # GEMMs
  PYTHONPATH=src python -m repro_torch.launch.op_level --device cpu

GPT-3 175B: the AllGather-GEMM seam has (n, k) = (49152, 12288) and the
GEMM-ReduceScatter seam (n, k) = (12288, 49152); m runs over the
reference's sweep, bf16.

``--tp N`` (default 8, the paper's ``N_TP``) runs each (seam, m) as the full
N-rank op through ``FusedOp`` in each of ``--modes`` (``xla``,
``decomposed``, ``flux``), the N ranks as a ``dist.RankGroup`` on ONE card:
the AG row gathers A [m, 12288] row-sharded over the ranks and multiplies
each rank's [12288, 49152 / N] columns; the RS row reduce-scatters the
ranks' [m, 49152 / N] x [49152 / N, 12288] partials.  Rows are named as
the reference names them, ``oplevel_{seam}_m{m}_{mode}``; beside each
(seam, m) stands ``..._nonsplit_x{N}``: N times the GEMM_non-split time of
the port's GEMM kernel at one rank's shape.  The ranks share the card's
SMs and HBM and their copies never cross NVLink, so these are times of N
ranks on one card, not the paper's ECT (Eq. 1) or overlap efficiency: no
ECT is printed.

``--tp 1`` times the GEMM_non-split alone: each rank shape through
``ops.ag_matmul_fused`` / ``ops.matmul_rs_fused`` at ``n_dev=1`` (the GEMM
kernel), each beside ``torch.matmul`` on the same inputs (rows
``..._gemm_nonsplit`` and ``..._torch_matmul``).

CSV on stdout: ``name,us_per_call,derived``.  ``derived`` is the share of
the card's bound (H100 SXM: 989 TFLOP/s bf16, 3.35 TB/s) that the row
reaches, in percent.  On the CPU (``--device cpu``) the dims are cut by
``--scale``, the plain versions run, and ``derived`` is ``-``: the bound
is the card's.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import ect
from repro_torch.core.overlap import FusedOp
from repro_torch.device import resolve_device
from repro_torch.dist import RankGroup
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ops

M_SWEEP = [64, 512, 1024, 2048, 4096, 8192]
N_TP = 8                      # the paper's single-node TP degree
MODES = ("xla", "decomposed", "flux")
SEAMS = (("ag", (49152, 12288)), ("rs", (12288, 49152)))   # (n, k)
CPU_SCALE = 16                # dims cut for a CPU run (as the reference's)


def rank_shape(seam: str, m: int, n: int, k: int, scale: int = 1,
               tp: int = N_TP) -> Tuple[int, int, int]:
    """Per-rank GEMM (m, k, n) of one seam at TP ``tp``, dims cut by
    ``scale``: AG splits n over the ranks, RS splits k."""
    n_r, k_r = (n // tp, k) if seam == "ag" else (n, k // tp)
    return max(m // scale, 8), k_r // scale, n_r // scale


def gemm_bound_s(m: int, k: int, n: int, dtype_bytes: int = 2
                 ) -> Tuple[float, str]:
    """Least time of an [m, k] x [k, n] GEMM on an H100 SXM: the larger of
    2 m n k operations over the bf16 peak and the bytes (A, B read once, C
    written once) over HBM bandwidth, with what sets it."""
    t_ops = 2.0 * m * n * k / ect.H100_SXM.peak_flops
    t_bytes = dtype_bytes * (m * k + k * n + m * n) / ect.H100_SXM.hbm_bw
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


def tp_inputs(seam: str, m: int, k: int, n: int, tp: int,
              device: torch.device) -> List[Tuple[torch.Tensor, ...]]:
    """Each rank's (x, w) of one op, standard-normal bf16 from seed 0:
    AG x [m / tp, k] (row shard), w [k, n / tp]; RS x [m, k / tp], w
    [k / tp, n]."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    if seam == "ag":
        xs, ws = (m // tp, k), (k, n // tp)
    else:
        xs, ws = (m, k // tp), (k // tp, n)
    return [tuple(torch.randn(sh, generator=gen, device=device).bfloat16()
                  for sh in (xs, ws)) for _ in range(tp)]


def run_tp(group: RankGroup, op: FusedOp,
           args: Sequence[Tuple[torch.Tensor, ...]], reps: int = 1
           ) -> List[torch.Tensor]:
    """``reps`` calls of ``op`` on every rank (each rank's args: x and
    the op's weights); the last outputs."""
    def body(*a):
        out = None
        for _ in range(reps):
            out = op(*a)
        return out
    return group.spmd(body, args)


def time_tp(group: RankGroup, op: FusedOp,
            args: Sequence[Tuple[torch.Tensor, ...]], iters: int,
            warmup: int) -> float:
    """Mean seconds of one n-rank op: on the card, CUDA events on the
    caller's stream around ``iters`` calls on every rank (the caller's
    stream waits for all the ranks' streams); on the CPU, the host clock."""
    run_tp(group, op, args, warmup)
    if group.cuda:
        torch.cuda.synchronize(group.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run_tp(group, op, args, iters)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    run_tp(group, op, args, iters)
    return (time.perf_counter() - t0) / iters


def tp_bound_s(m: int, k: int, n: int) -> Tuple[float, str]:
    """Least time of the whole n-rank op on one H100 SXM: the larger of the
    ranks' GEMM operations (2 m k n, split over the ranks) over the bf16
    peak and the bytes it must move (every rank's inputs read once, every
    output written once, bf16) over HBM bandwidth."""
    t_ops = 2.0 * m * k * n / ect.H100_SXM.peak_flops
    # either seam: the ranks' inputs add up to m x k and k x n, their
    # outputs to m x n (AG: tp x [m, n/tp]; RS: tp x [m/tp, n])
    t_bytes = 2.0 * (m * k + k * n + m * n) / ect.H100_SXM.hbm_bw
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def main(device: Optional[str] = None, scale: Optional[int] = None,
         iters: int = 10, warmup: int = 2, tp: int = N_TP,
         modes: Sequence[str] = MODES) -> List[Dict]:
    """Run the sweep; print the CSV and return one dict per row."""
    if tp == 1:
        return _main_gemm(device, scale, iters, warmup)
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    scale = scale or (1 if on_card else CPU_SCALE)
    where = torch.cuda.get_device_name(dev) if on_card else "cpu (plain)"
    print(f"# op_level on {where}, TP {tp} ranks on one device, dims / "
          f"{scale}, mean of {iters} warm calls", file=sys.stderr)
    group = RankGroup(tp, dev)
    rows = []
    for seam, (n, k) in SEAMS:
        for m in M_SWEEP:
            mg, kg, ng = max(m // scale, 8 * tp), k // scale, n // scale
            args = tp_inputs(seam, mg, kg, ng, tp, dev)
            bound_s, bound_by = tp_bound_s(mg, kg, ng)
            mr, kr, nr = rank_shape(seam, mg, ng, kg, 1, tp)
            a, b = gemm_inputs(mr, kr, nr, dev)
            nonsplit_s = tp * ect.time_fn(mm.matmul, a, b, iters=iters,
                                          warmup=warmup, device=dev)
            del a, b
            for mode in modes:
                op = FusedOp(seam, axis=group, mode=mode)
                t = time_tp(group, op, args, iters, warmup)
                rows.append({"seam": seam, "m": m, "mode": mode, "tp": tp,
                             "shape_mkn": [mg, kg, ng], "seconds": t,
                             "calls": warmup + iters,
                             "nonsplit_x_tp_s": nonsplit_s,
                             "bound_s": bound_s, "bound_by": bound_by})
            del args
            group.free_symmetric()
    print("name,us_per_call,derived")
    for r in rows:
        share = f"{100 * r['bound_s'] / r['seconds']:.1f}" if on_card else "-"
        print(f"oplevel_{r['seam']}_m{r['m']}_{r['mode']},"
              f"{r['seconds'] * 1e6:.1f},{share}")
        if r["mode"] == modes[-1]:
            t = r["nonsplit_x_tp_s"]
            share = f"{100 * r['bound_s'] / t:.1f}" if on_card else "-"
            print(f"oplevel_{r['seam']}_m{r['m']}_nonsplit_x{tp},"
                  f"{t * 1e6:.1f},{share}")
    return rows


def _main_gemm(device: Optional[str], scale: Optional[int], iters: int,
               warmup: int) -> List[Dict]:
    """``--tp 1``: time every (seam, m) GEMM_non-split and its
    ``torch.matmul`` yardstick; print the CSV and return one dict a row
    pair.  Each row's kernel path makes ``warmup + iters`` calls
    (``calls``)."""
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
    ap.add_argument("--tp", type=int, default=N_TP,
                    help=f"ranks of the op (default {N_TP}, the paper's "
                         "N_TP); 1 times the GEMM_non-split alone")
    ap.add_argument("--modes", default=",".join(MODES),
                    help="comma-separated FusedOp modes at tp > 1")
    args = ap.parse_args(argv)
    args.modes = tuple(args.modes.split(","))
    return args


if __name__ == "__main__":
    main(**vars(parse_args()))

"""Effective Communication Time and Overlap Efficiency (paper §2.3).

Port of ``repro.core.ect``:

  ECT       = OverallTime - GEMM_non-split                     (Eq. 1)
  E_overlap = 1 - ECT_overlap / ECT_non-overlap                (Eq. 2)

A perfect overlap method has ECT == 0 and E_overlap == 100 %.  Negative
efficiency means the "overlap" method is slower than the non-overlapping
baseline.

Two backends, as in the reference:
  * measured — ``time_fn``: the median of warm repeats, timed with CUDA
    events on a card and with ``perf_counter`` on the CPU;
  * modeled  — a roofline model from analytic FLOPs and bytes.  The
    reference prices it with TPU v5e constants; here the hardware terms
    are an explicit ``Hardware`` argument, with no default instance, so
    every modeled number names the hardware it assumed.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class Hardware:
    """The roofline terms of one device: peak FLOP/s of the GEMM's input
    type, device-memory bytes/s, and bytes/s of one link in one
    direction."""
    peak_flops: float
    hbm_bw: float
    link_bw: float


# One NVIDIA H100 SXM (data sheet, dense rates at the full 700 W): bf16
# tensor-core peak, HBM3 bandwidth, and NVLink 4's 900 GB/s split per
# direction.  The port's tp ranks share one card and cross no NVLink
# (ROADMAP queue 1 item 2.5), so the analytic price (ranks on cards of
# their own, joined by this link) and a measured sweep (ranks sharing one
# card) answer different questions.
H100_SXM = Hardware(peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9)


@dataclasses.dataclass
class ECTResult:
    name: str
    overall_s: float
    gemm_nonsplit_s: float

    @property
    def ect_s(self) -> float:
        return self.overall_s - self.gemm_nonsplit_s

    def overlap_efficiency(self, baseline: "ECTResult") -> float:
        if baseline.ect_s == 0:
            return float("nan")
        return 1.0 - self.ect_s / baseline.ect_s


def time_fn(fn: Callable, *args, iters: int = 5, warmup: int = 2,
            device: Optional[torch.device] = None) -> float:
    """Median seconds of one call of ``fn(*args)`` over ``iters`` warm
    repeats.  On a CUDA ``device`` each call sits between two CUDA events
    on the current stream; on the CPU it is timed with ``perf_counter``."""
    cuda = device is not None and torch.device(device).type == "cuda"
    for _ in range(warmup):
        fn(*args)
    ts = []
    if cuda:
        torch.cuda.synchronize(device)
        marks = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            marks.append((start, end))
        torch.cuda.synchronize(device)
        ts = [s.elapsed_time(e) / 1e3 for s, e in marks]
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


# ---------------------------------------------------------------------------
# Modeled (roofline) ECT, formula for formula the reference's.
# ---------------------------------------------------------------------------
def gemm_efficiency(m: int, m_half: float = 128.0) -> float:
    """Matrix-unit efficiency vs the m (rows) dimension: small-m GEMMs
    underuse the unit (the paper's §2.2 third critique of split GEMMs)."""
    return m / (m + m_half)


def model_gemm_time(m: int, n: int, k: int, dtype_bytes: int = 2,
                    mfu: float = 0.7, *, hw: Hardware) -> float:
    """Max of compute and memory roofline terms for one GEMM on one
    device."""
    flops = 2.0 * m * n * k
    bytes_ = dtype_bytes * (m * k + k * n + m * n)
    eff = mfu * gemm_efficiency(m)
    return max(flops / (hw.peak_flops * eff), bytes_ / hw.hbm_bw)


def model_collective_time(shard_bytes: float, n_dev: int, kind: str = "ag",
                          links: int = 1, *, hw: Hardware) -> float:
    """Ring-collective time over the links.  ``shard_bytes`` is the
    PER-DEVICE shard (AG input / RS output); a ring moves (n-1) shards over
    every link, twice for all-reduce."""
    mult = 2.0 if kind in ("ar", "allreduce", "a2a") else 1.0
    return mult * (n_dev - 1) * shard_bytes / (hw.link_bw * links)


SEAMS = ("ag", "rs", "ar", "a2a")
MODES = ("xla", "decomposed", "decomposed_bidir", "flux")

# wire_dtype payload bytes per element (plus one fp32 scale per 128-block).
# The payload factor relative to the native dtype is
# (qbytes + 4/128) / dtype_bytes.
_WIRE_QBYTES = {"int8": 1.0, "fp8_e4m3": 1.0, "int4": 0.5}
_WIRE_SCALE_OVERHEAD = 4.0 / 128.0


def wire_bytes_factor(wire_dtype: str, dtype_bytes: int = 2) -> float:
    """On-wire bytes of a quantized payload relative to the native dtype."""
    return (_WIRE_QBYTES[wire_dtype] + _WIRE_SCALE_OVERHEAD) / dtype_bytes


def model_overlap(seam: str, m: int, n: int, k: int, n_dev: int,
                  mode: str, dtype_bytes: int = 2,
                  comm_chunks: int = 0, *, hw: Hardware, n_weights: int = 1,
                  shared_gather: bool = True, epilogue: bool = False,
                  fuse_epilogue: bool = True,
                  scatter_axis: str = "seq",
                  wire_dtype: Optional[str] = None) -> Dict[str, float]:
    """Analytic OverallTime for one TP seam under each overlap strategy
    (``repro.core.ect.model_overlap`` with the hardware terms from ``hw``).

    seam="ag": C = AllGather_m(A[m/n,k]) @ B[k,n/n]   (per-device n/n_dev)
    seam="rs": C = RS_m(A[m,k/n] @ B[k/n,n])
    seam="ar": C = AllReduce(A[m,k/n] @ B[k/n,n])
    seam="a2a": MoE EP exchange of m routed rows [m, k=d_model], three
                per-expert GEMMs (w1/w3 up to n, w2 down), exchange back
    Modes: "xla" (serial), "decomposed" (chunked ring), "decomposed_bidir"
    (both link directions), "flux" (fused kernel).  ``wire_dtype`` (None |
    "int8" | "fp8_e4m3" | "int4") prices a quantized forward wire on the
    transports that carry one; the FusedOp knobs (``n_weights``,
    ``shared_gather``, ``epilogue``, ``fuse_epilogue``, ``scatter_axis``)
    price as in the reference's docstring.
    Returns dict(overall, gemm, comm, comm_bytes, act_bytes, epilogue,
    wire, exposed, ect, overlap_eff).
    """
    if seam not in SEAMS:
        raise ValueError(f"unknown seam {seam!r} (one of {SEAMS})")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r} (one of {MODES})")
    base = mode
    links = 2 if mode == "decomposed_bidir" else 1
    if base == "decomposed_bidir":
        base = "decomposed"
    seq = scatter_axis == "seq"
    if seam == "rs" and not seq:
        seam = "ar"                       # rs/hidden IS the all-reduce op
    if seam == "ag":
        gemm = (model_gemm_time(m, n // n_dev, k, dtype_bytes, hw=hw)
                * n_weights)
        if seq:
            comm_bytes = (m // n_dev) * k * dtype_bytes
        else:
            comm_bytes = 0.0              # hidden: input already replicated
            base = "xla"                  # nothing to overlap with
        rings = 1 if shared_gather else n_weights
        comm = model_collective_time(comm_bytes, n_dev, "ag", links,
                                     hw=hw) * rings
        out_elems = m * (n // n_dev) * n_weights
        act_bytes = ((m // n_dev) if seq else m) * k * dtype_bytes
    elif seam == "a2a":
        gemm = (2.0 * model_gemm_time(m, n, k, dtype_bytes, hw=hw)
                + model_gemm_time(m, k, n, dtype_bytes, hw=hw))
        comm_bytes = m * k * dtype_bytes / n_dev      # per-direction shard
        comm = model_collective_time(comm_bytes, n_dev, "a2a", links,
                                     hw=hw)
        out_elems = m * k
        act_bytes = m * k * dtype_bytes
    elif seam == "rs":
        gemm = model_gemm_time(m, n, k // n_dev, dtype_bytes, hw=hw)
        comm_bytes = (m // n_dev) * n * dtype_bytes
        comm = model_collective_time(comm_bytes, n_dev, "rs", links, hw=hw)
        out_elems = (m // n_dev) * n
        act_bytes = out_elems * dtype_bytes
    else:                                 # ar: full [m, n] output all-reduced
        gemm = model_gemm_time(m, n, k // n_dev, dtype_bytes, hw=hw)
        comm_bytes = m * n * dtype_bytes / n_dev
        comm = model_collective_time(comm_bytes, n_dev, "ar", links, hw=hw)
        out_elems = m * n
        act_bytes = out_elems * dtype_bytes

    # quantized wire: only the transports that carry one shrink; pack and
    # unpack cost one elementwise HBM pass per encode + decode
    wired = False
    wire_s = 0.0
    if wire_dtype is not None and comm_bytes:
        wired = (seam == "a2a" or (seam == "ag" and seq and base != "flux")
                 or (seam in ("rs", "ar") and base == "decomposed"))
        if wired:
            factor = wire_bytes_factor(wire_dtype, dtype_bytes)
            wire_s = 2.0 * comm_bytes * (1.0 + factor) / hw.hbm_bw
            comm_bytes *= factor
            comm *= factor

    launch_overhead = 5e-6          # per extra kernel launch (the paper's
    #                                 "scheduling overheads", §2.2)
    if base == "xla":               # serial: collective fully exposed
        overall = gemm + comm
    elif base == "decomposed":      # chunked pipeline: split-GEMM penalty
        # (chunk rows m/chunks) + launch overheads; AR chunks the
        # contraction, so no m-split penalty, but every chunk's psum moves a
        # full [m, n] partial
        chunks = max(comm_chunks or n_dev, 1)
        penalty = (1.0 if seam == "ar" else
                   gemm_efficiency(m) / gemm_efficiency(max(m // chunks, 1)))
        g = gemm * penalty + launch_overhead * chunks
        if seam == "rs":
            # the inter-chunk adds serialize the split GEMMs (§2.2)
            overall = g + comm / chunks
        elif seam == "ar" and wired:
            # quantized two-ring all-reduce: single-ring volume, pipelined
            overall = max(g, comm) + min(g, comm) / chunks
        elif seam == "ar":
            comm = comm * chunks
            comm_bytes = comm_bytes * chunks
            overall = max(g, comm) + min(g / chunks, comm / chunks)
        else:
            overall = max(g, comm) + min(g, comm) / chunks
    else:                           # flux: fused kernel, unsplit GEMM speed;
        # one comm step exposed at the head (AG) / tail (RS), paper §3.3
        step_c = comm / max(n_dev - 1, 1)
        dma_overhead = 1.02         # fused-kernel bookkeeping
        overall = max(gemm * dma_overhead, comm) + step_c
    # an unfused AG epilogue re-reads and re-writes the output
    epi_s = 0.0
    if seam == "ag" and epilogue and not fuse_epilogue:
        epi_s = 3.0 * out_elems * dtype_bytes / hw.hbm_bw
        overall += epi_s
    overall += wire_s
    exposed = overall - gemm
    rings_f = 1 if (seam != "ag" or shared_gather) else n_weights
    moved_bytes = ((2.0 if seam in ("ar", "a2a") else 1.0) * (n_dev - 1)
                   * comm_bytes * rings_f)
    return dict(overall=overall, gemm=gemm, comm=comm,
                comm_bytes=moved_bytes, act_bytes=float(act_bytes),
                epilogue=epi_s, wire=wire_s, exposed=exposed, ect=exposed,
                overlap_eff=1.0 - exposed / comm if comm else 0.0)

"""Model-level figures — the paper's Figs. 1, 16, 17 (port of
``benchmarks/model_level.py``), priced on the H100.

  PYTHONPATH=src python -m repro_torch.launch.model_level

For GPT-3 175B and Llama-2 70B (the paper's two models), the per-step time
of training, prefill and decoding under each overlap mode, from the
per-layer roofline terms of ``core.ect.model_overlap``:

  non-overlap (xla)  : T = compute + memory' + collective      (serial)
  medium (decomposed): T = max-pipelined per chunk with the split-GEMM
                       penalty (paper §2.2's critique)
  FLUX (flux)        : T = max(compute, collective) + one-chunk tail
                       (fused kernel; paper §3.3)

plus the communication fraction (Fig. 1 analogue) and each mode's speedup
over the non-overlap baseline (Figs. 16/17 analogue).  The CLI prices on
``ect.H100_SXM`` (the data sheet's bf16 peak, HBM3 bandwidth and NVLink 4
per direction, TP ranks on cards of their own) and says so in its first
line: an analytic model, not a measurement.  ``main(hw=...)`` prices on any
``ect.Hardware``; given the reference's TPU terms it prints the reference's
numbers.

A layer is the reference's four seams, with its simplified shapes: qkv as
``3 d`` columns and the FFN's AllGather-GEMM as one ``d_ff``-wide weight.
The model's real seams are wider (GQA's q | k | v columns, SwiGLU's w1 and
w3 on one gather), as ``tuning.autotune.model_seam_shapes`` prices them.

CSV: ``name,us_per_call,derived`` (derived: speedup over xla mode; the
``..._commfrac`` row: the xla step's time and its communication share in
percent).
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import get_config
from repro_torch.core import ect

N_TP = 8
PHASES = {
    "train": dict(m_tokens=8 * 2048, passes=3.0),   # fwd+bwd
    "prefill": dict(m_tokens=8 * 2048, passes=1.0),
    "decode64": dict(m_tokens=64, passes=1.0),
    "decode512": dict(m_tokens=512, passes=1.0),
}
MODES = ("xla", "decomposed", "flux")
ARCHS = ("gpt3_175b", "llama2_70b")


def layer_seam_times(cfg, m_tokens: int, mode: str, *,
                     hw: ect.Hardware) -> Dict[str, float]:
    """The two MLP seams + two attention seams of one layer under a mode:
    summed {overall, gemm, comm, exposed} seconds."""
    d, f = cfg.d_model, cfg.d_ff
    seams = [
        ("ag", m_tokens, f, d),          # h -> 4h (AllGather-GEMM)
        ("rs", m_tokens, d, f),          # 4h -> h (GEMM-ReduceScatter)
        ("ag", m_tokens, 3 * d, d),      # qkv
        ("rs", m_tokens, d, d),          # attn out
    ]
    total = dict(overall=0.0, gemm=0.0, comm=0.0, exposed=0.0)
    for seam, m, n, k in seams:
        est = ect.model_overlap(seam, m, n, k, N_TP, mode, hw=hw)
        for kk in total:
            total[kk] += est[kk]
    return total


def hardware_label(hw: ect.Hardware) -> str:
    name = ("the H100 SXM data sheet" if hw == ect.H100_SXM
            else "the given hardware terms")
    return (f"{name} ({hw.peak_flops / 1e12:g} TFLOP/s bf16, HBM "
            f"{hw.hbm_bw / 1e12:g} TB/s, link {hw.link_bw / 1e9:g} GB/s a "
            "direction)")


def rows(*, hw: ect.Hardware) -> List[Dict]:
    """Every CSV row unrounded, in print order: {name, us, derived}."""
    out = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for phase, ph in PHASES.items():
            base = None
            for mode in MODES:
                t = layer_seam_times(cfg, ph["m_tokens"], mode, hw=hw)
                step_us = t["overall"] * ph["passes"] * cfg.num_layers * 1e6
                if mode == "xla":
                    base = step_us
                    frac = t["comm"] / t["overall"] if t["overall"] else 0
                    out.append({"name": f"modellevel_{arch}_{phase}_commfrac",
                                "us": step_us, "derived": 100 * frac,
                                "fmt": ".1f"})
                speedup = base / step_us if step_us else 0.0
                out.append({"name": f"modellevel_{arch}_{phase}_{mode}",
                            "us": step_us, "derived": speedup, "fmt": ".3f"})
    return out


def main(*, hw: ect.Hardware) -> List[Dict]:
    """Print the figures priced on ``hw`` as CSV (after a ``#`` line naming
    the hardware) and return the rows unrounded."""
    print(f"# model-level figures: the roofline model (core.ect) on "
          f"{hardware_label(hw)}, TP {N_TP}; analytic, not measured")
    print("name,us_per_call,derived")
    out = rows(hw=hw)
    for r in out:
        print(f"{r['name']},{r['us']:.0f},{r['derived']:{r['fmt']}}")
    return out


if __name__ == "__main__":
    main(hw=ect.H100_SXM)

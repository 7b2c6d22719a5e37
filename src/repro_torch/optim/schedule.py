"""LR schedules (port of ``repro.optim.schedule``): cosine (default) and WSD
(warmup-stable-decay, MiniCPM).

``step`` may be a Python number or a tensor; the result is a float32 tensor
(a 0-d one for a number), computed in float32 as the reference computes it
in ``jnp.float32``.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine(step, *, base_lr: float, warmup: int, total: int,
           min_ratio: float = 0.1) -> torch.Tensor:
    s = _f32(step)
    warm = base_lr * s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    # cos of the float32 argument, rounded once from float64 (torch's
    # float32 cos is less accurate than XLA's)
    arg = math.pi * prog
    cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5
                     * (1 + torch.cos(arg.double()).float()))
    return torch.where(s < warmup, warm, cos)


def wsd(step, *, base_lr: float, warmup: int, total: int,
        decay_frac: float = 0.1, min_ratio: float = 0.01) -> torch.Tensor:
    """Warmup-Stable-Decay (MiniCPM): flat plateau, sharp final decay."""
    s = _f32(step)
    decay_start = total * (1.0 - decay_frac)
    warm = base_lr * s / max(warmup, 1)
    stable = torch.full_like(s, base_lr)
    prog = torch.clamp((s - decay_start) / max(total - decay_start, 1),
                       0.0, 1.0)
    decay = base_lr * torch.pow(torch.tensor(min_ratio, dtype=torch.float32)
                                .double(), prog.double()).float()  # anneal
    return torch.where(s < warmup, warm,
                       torch.where(s < decay_start, stable, decay))


def get_schedule(name: str):
    return {"cosine": cosine, "wsd": wsd}[name]

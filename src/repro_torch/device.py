"""Device resolution for the port's entry points.

The port runs on the card: ``resolve_device()`` gives ``cuda`` and raises
when there is no GPU.  The CPU is used only when the caller asks for it
(``device="cpu"``, as the tests do) — there is no silent fallback.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None``/"cuda" -> the current CUDA device (raises without a GPU);
    "cpu" -> the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA card and none is available; "
                "pass device='cpu' to run the plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev

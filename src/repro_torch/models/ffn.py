"""Dense SwiGLU FFN (port of ``repro.models.ffn``, dense part).

``ffn_train`` runs the two TP seams: ``mlp_ag`` with the SwiGLU gate as its
epilogue (``gate="pair"`` over separate w1/w3, or ``gate="split"`` over the
packed per-device ``w13``) and ``mlp_rs`` for w2.  ``ffn_decode`` is the
one-token path with the ``decode_ar`` seam.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.core import overlap
from repro_torch.models import init_utils as iu
from repro_torch.models import layers
from repro_torch.parallel.sharding import TPContext, pad_ff


def init_ffn(gen: torch.Generator, d_model: int, d_ff: int, tp: int,
             dtype: torch.dtype, device: torch.device,
             fuse13: bool = False) -> Dict[str, torch.Tensor]:
    """d_ff zero-padded to the TP-aligned width (silu(0)*0 @ 0-rows adds
    nothing).  ``fuse13`` packs w1|w3 into one per-device-interleaved w13."""
    ffp = pad_ff(d_ff, tp)
    std = d_model ** -0.5

    def normal(*shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    w1 = iu.zero_pad_cols(normal(d_model, d_ff, scale=std), ffp).to(dtype)
    w3 = iu.zero_pad_cols(normal(d_model, d_ff, scale=std), ffp).to(dtype)
    p = {"w2": iu.zero_pad_rows(normal(d_ff, d_model, scale=d_ff ** -0.5),
                                ffp).to(dtype),
         "norm": torch.ones(d_model, dtype=dtype, device=device)}
    if fuse13:
        p["w13"] = iu.pack_pair(w1, w3, tp)
    else:
        p["w1"] = w1
        p["w3"] = w3
    return p


def ffn_train(p, x: torch.Tensor, ctx: TPContext,
              eps: float = 1e-5) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D]; the gate is the mlp_ag seam's epilogue."""
    h = layers.rms_norm(x, p["norm"], eps)
    if "w13" in p:
        y = ctx.op("mlp_ag", epilogue=overlap.Epilogue(
            activation="silu", gate="split"))(h, p["w13"])
    else:
        y = ctx.op("mlp_ag", epilogue=overlap.Epilogue(
            activation="silu", gate="pair"), n_weights=2)(h, p["w1"], p["w3"])
    return ctx.op("mlp_rs")(y, p["w2"])


def ffn_decode(p, x: torch.Tensor, ctx: TPContext,
               eps: float = 1e-5) -> torch.Tensor:
    """x: [B, 1, D] -> [B, 1, D]; row-parallel decode_ar seam."""
    h = layers.rms_norm(x, p["norm"], eps)
    if "w13" in p:
        a, g = torch.chunk(torch.matmul(h, p["w13"]), 2, dim=-1)
    else:
        a = torch.matmul(h, p["w1"])
        g = torch.matmul(h, p["w3"])
    return ctx.op("decode_ar")(F.silu(a) * g, p["w2"])

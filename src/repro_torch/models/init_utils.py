"""TP-layout-consistent parameter packing (port of ``repro.models.init_utils``).

Packed projections interleave whole per-device blocks and padded dims are
ZERO, so padding never changes the function and a checkpoint means the
same model at every TP degree.  At tp=1 the packing is a plain
concatenation, kept in the reference's form so weights cross unchanged.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def zero_pad_cols(w: torch.Tensor, to: int) -> torch.Tensor:
    """Pad the last dim with zeros up to ``to`` columns."""
    if w.shape[-1] == to:
        return w
    return F.pad(w, (0, to - w.shape[-1]))


def zero_pad_rows(w: torch.Tensor, to: int) -> torch.Tensor:
    """Pad dim 0 with zeros up to ``to`` rows."""
    if w.shape[0] == to:
        return w
    pad = torch.zeros((to - w.shape[0], *w.shape[1:]), dtype=w.dtype,
                      device=w.device)
    return torch.cat([w, pad], dim=0)


def interleave_heads(w: torch.Tensor, n_heads: int, head_dim: int, tp: int,
                     pad_heads_to: int) -> torch.Tensor:
    """[D, H*dh] head-major columns -> zero-padded to ``pad_heads_to``."""
    d = w.shape[0]
    w = w.reshape(d, n_heads, head_dim)
    if pad_heads_to != n_heads:
        w = F.pad(w, (0, 0, 0, pad_heads_to - n_heads))
    return w.reshape(d, pad_heads_to * head_dim)


def replicate_kv_heads(w: torch.Tensor, n_kv: int, head_dim: int, tp: int,
                       pad_kv_to: int) -> torch.Tensor:
    """[D, Hkv*dh] -> replicated layout when Hkv < TP (padded kv head p maps
    to canonical head p*Hkv//TP), zero-padded otherwise."""
    d = w.shape[0]
    w = w.reshape(d, n_kv, head_dim)
    if pad_kv_to == n_kv:
        return w.reshape(d, n_kv * head_dim)
    if n_kv < tp:
        idx = torch.arange(pad_kv_to, device=w.device) * n_kv // pad_kv_to
        w = w[:, idx]
    else:
        w = F.pad(w, (0, 0, 0, pad_kv_to - n_kv))
    return w.reshape(d, pad_kv_to * head_dim)


def pack_qkv(wq: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor,
             tp: int) -> torch.Tensor:
    """Interleave per-device blocks: [dev0: q|k|v | dev1: q|k|v | ...]."""
    ql, kl, vl = wq.shape[1] // tp, wk.shape[1] // tp, wv.shape[1] // tp
    parts = []
    for i in range(tp):
        parts += [wq[:, i * ql:(i + 1) * ql], wk[:, i * kl:(i + 1) * kl],
                  wv[:, i * vl:(i + 1) * vl]]
    return torch.cat(parts, dim=1)


def pack_pair(wa: torch.Tensor, wb: torch.Tensor, tp: int) -> torch.Tensor:
    """Interleave two column-sharded weights per device: [dev0: a|b | ...]."""
    al, bl = wa.shape[1] // tp, wb.shape[1] // tp
    parts = []
    for i in range(tp):
        parts += [wa[:, i * al:(i + 1) * al], wb[:, i * bl:(i + 1) * bl]]
    return torch.cat(parts, dim=1)

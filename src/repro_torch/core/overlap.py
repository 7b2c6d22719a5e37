"""TP-seam ops (port of ``repro.core.overlap``): ``Epilogue`` + ``FusedOp``.

``FusedOp(kind="ag"|"rs"|"ar"|"a2a", ...)`` is the one object model code
calls for a parallel seam (built by ``ctx.op(seam)``):

    ag   x[B, S, D] , w[D, F]  ->  epilogue(x @ w)       (n_weights >= 1)
    rs   y[B, S, F] , w[F, D]  ->  epilogue(y @ w)
    ar   y[B, m, F] , w[F, D]  ->  epilogue(y @ w)
    a2a  x[ep, E_loc, cap, D], (w1, w3)[E_loc, D, F], w2[E_loc, F, D]
         ->  per-expert act(x @ w1) * (x @ w3) @ w2     (the MoE exchange)

On one card (tp=1, ep=1) every seam is the local GEMM plus its epilogue —
what the reference's ``_fused_ag`` / ``_rs_core`` / ``_ar_core`` do at
axis size 1 — and the a2a seam is the local expert FFN (``_a2a_impl`` with
an empty EP group).  The collective transports (``xla``, the ``decomposed*`` rings,
the fused ``flux`` kernels) and their knobs (overlap mode, chunking, ring
direction, scatter axis) exist only at tp>1; they come with that slice
(ROADMAP 'Modules still to port', item 2), and ``TPContext`` rejects tp>1
until then.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

VALID_KINDS = ("ag", "rs", "ar", "a2a")

# model-level seam name -> its collective kind
SEAM_KINDS: Dict[str, str] = {"mlp_ag": "ag", "mlp_rs": "rs",
                              "attn_ag": "ag", "attn_rs": "rs",
                              "decode_ar": "ar", "moe_a2a": "a2a"}


def _sqrelu(v):
    return torch.square(F.relu(v))


# jax.nn.gelu defaults to the tanh approximation
ACTIVATIONS = {"silu": F.silu,
               "gelu": lambda v: F.gelu(v, approximate="tanh"),
               "relu": F.relu, "sqrelu": _sqrelu}


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """Elementwise tail fused after a seam's GEMM.

    Application order (z starts as the first GEMM output)::

        z = z * scale          (scale=True;   per-column dequant multiply)
        z = z + bias           (bias=True;    broadcast over rows)
        gate == "pair" : z = act(z) * y2     (second weight's output)
        gate == "split": z = act(a) * b      (a, b = split(z, 2, dim=-1))
        else           : z = act(z)          (activation set)
        z = z + residual       (residual=True)
    """
    bias: bool = False
    activation: Optional[str] = None
    gate: Optional[str] = None
    residual: bool = False
    scale: bool = False

    def __post_init__(self):
        if self.activation is not None and self.activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {self.activation!r}")
        if self.gate not in (None, "pair", "split"):
            raise ValueError(f"unknown gate {self.gate!r}")

    @property
    def is_identity(self) -> bool:
        return not (self.bias or self.activation or self.gate
                    or self.residual or self.scale)

    def apply(self, ys: Sequence[torch.Tensor], bias=None, scale=None,
              residual=None) -> torch.Tensor:
        z = ys[0]
        if self.scale:
            z = z * scale
        if self.bias:
            z = z + bias
        act = ACTIVATIONS[self.activation] if self.activation else (lambda v: v)
        if self.gate == "pair":
            z = act(z) * ys[1]
        elif self.gate == "split":
            a, b = torch.chunk(z, 2, dim=-1)
            z = act(a) * b
        elif self.activation:
            z = act(z)
        if self.residual:
            z = z + residual
        return z


@dataclasses.dataclass(frozen=True)
class FusedOp:
    """One TP-seam GEMM with a fused epilogue (module docstring)."""
    kind: str
    epilogue: Epilogue = Epilogue()
    n_weights: int = 1

    def __post_init__(self):
        if self.kind not in VALID_KINDS:
            raise ValueError(f"invalid kind {self.kind!r}")
        if self.n_weights < 1:
            raise ValueError("n_weights must be >= 1")
        if self.kind == "a2a":
            # the op owns the whole expert computation: the (w1, w3, w2)
            # triple and the pure pair-gate epilogue
            if self.n_weights != 3:
                raise ValueError(
                    'kind="a2a" takes the expert (w1, w3, w2) triple')
            e = self.epilogue
            if e.gate != "pair" or e.bias or e.scale or e.residual:
                raise ValueError(
                    'kind="a2a" needs a pure gate="pair" epilogue')
            return
        if self.kind != "ag" and self.n_weights != 1:
            raise ValueError(f"kind={self.kind!r} ops take exactly one weight")
        if self.epilogue.gate == "pair":
            if self.kind != "ag" or self.n_weights != 2:
                raise ValueError('gate="pair" needs an ag op with n_weights=2')
        elif self.n_weights > 1 and not self.epilogue.is_identity:
            raise ValueError("multi-output ops (n_weights>1 without "
                             'gate="pair") require an identity epilogue')

    @property
    def combines(self) -> bool:
        """True when the op returns ONE tensor (single weight or pair gate);
        False -> tuple of per-weight outputs."""
        return self.n_weights == 1 or self.epilogue.gate == "pair"

    def __call__(self, x: torch.Tensor, *ws: torch.Tensor, bias=None,
                 scale=None, residual=None):
        if len(ws) != self.n_weights:
            raise ValueError(f"expected {self.n_weights} weights, "
                             f"got {len(ws)}")
        epi = self.epilogue
        for flag, name, val in ((epi.bias, "bias", bias),
                                (epi.scale, "scale", scale),
                                (epi.residual, "residual", residual)):
            if flag != (val is not None):
                raise ValueError(
                    f"epilogue.{name}={flag} but {name} operand "
                    f"{'missing' if flag else 'given'}")
        if self.kind == "a2a":
            return _expert_fn(epi, x, *ws)
        ys = [torch.matmul(x, w) for w in ws]
        if not self.combines:
            return tuple(ys)
        return epi.apply(ys, bias=bias, scale=scale, residual=residual)


def _expert_fn(epi: Epilogue, b: torch.Tensor, w1: torch.Tensor,
               w3: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Per-local-expert gated FFN on the dispatch buffer:
    b[..., E_loc, c, D] @ (w1, w3)[E_loc, D, F] -> pair gate ->
    @ w2[E_loc, F, D]."""
    a1 = torch.einsum("...ecd,edf->...ecf", b, w1)
    a3 = torch.einsum("...ecd,edf->...ecf", b, w3)
    h = epi.apply([a1, a3])
    return torch.einsum("...ecf,efd->...ecd", h, w2)

"""TP-seam ops (port of ``repro.core.overlap``): ``Epilogue`` + ``FusedOp``.

``FusedOp(kind="ag"|"rs"|"ar"|"a2a", axis=..., mode=..., ...)`` is the one
object model code calls for a parallel seam (built by ``ctx.op(seam)``).
With the sequence-sharded ("seq") residual stream of Megatron-SP:

    ag   x[B, S/N, D] , w[D, F/N]  ->  epilogue((AllGather_S x) @ w)
    rs   y[B, S, F/N] , w[F/N, D]  ->  epilogue(ReduceScatter_S(y @ w))
    ar   y[B, m, F/N] , w[F/N, D]  ->  epilogue(AllReduce(y @ w))
    a2a  x[ep, E_loc, cap, D], (w1, w3)[E_loc, D, F], w2[E_loc, F, D]
         ->  dispatch x[j] to EP rank j, per-expert
             act(b @ w1) * (b @ w3) @ w2 on what arrived, combine back
             (ep=1: the local expert FFN)

With the replicated ("hidden") residual stream, ``scatter_axis="hidden"``,
an ag op's x is already the full activation (a local GEMM, no collective)
and an rs op is the ``ar`` op: the row-parallel GEMM and an AllReduce of
the partials (decode, the chunked prefill and the replicated prefill run
this layout).

``axis`` is the ``dist.RankGroup`` of the TP ranks (the reference's mesh
axis name); ``None`` or a group of one makes every seam the local GEMM plus
its epilogue.  At tp>1 the op must run inside ``group.spmd``, and ``mode``
picks the transport, as in the reference:

* ``xla`` — the non-overlapping baseline: a monolithic gather (copies of
  every rank's shard, ``torch.cat``) before the GEMM, or a GEMM then a
  monolithic reduce-scatter (every rank's partial rows summed in rank
  order, in fp32); ``ar``: the GEMM, then one AllReduce.
* ``decomposed`` — the ring: ``n - 1`` hops of ``group.ppermute`` (a pull
  copy from the neighbour, ordered by its event), each landed shard
  multiplied, and its epilogue applied, as it arrives; ``ar``: the
  contraction dim cut into ``comm_chunks or n`` chunks, each chunk's
  partial AllReduced, the reduced chunks summed in chunk order.
* ``flux`` — the fused kernels (``kernels.ops``): the AllGather-GEMM and
  the GEMM-ReduceScatter, on CUDA tensors always the hand-written kernels
  (the reference's ``_flux_available`` fallback is not carried over);
  ``ar`` has no fused kernel in the reference either: it is ``xla``'s
  GEMM and AllReduce.

An ``ar`` op's AllReduce is one exchange of the partials over the group,
summed in rank order in fp32.

``n_weights`` > 1 ag ops share ONE gather; under flux that is one kernel
over the column-stacked weights.  A single weight's bias/activation runs
in the flux kernel's tile epilogue.

The backward of an ag/rs op at tp>1 is the reference's ``_fused_bwd``: an
ag op re-gathers ``x`` on its own transport and runs the interchanged
GEMM-ReduceScatter over the cotangents (under flux one GEMM-RS kernel);
an rs op runs the interchanged AllGather-GEMM over its cotangent and the
transposed weight (under flux one AG-GEMM kernel).  The dW contractions
are ``torch.matmul``.  Cotangents follow the reference's
``check_rep=False`` convention: a replicated tensor's cotangent is a
per-rank partial.  The collectives outside a ``FusedOp`` that training
reaches (``gather_seq``, ``scatter_seq_sum``, ``psum``; ``pmax`` is
stop-gradient) carry the reference's transposes too.

Each such collective is one *seam*: a forward and a backward that both
exchange with the other ranks.  On a CUDA card the autograd engine runs
every CUDA node of every rank on one device thread, where a rank's
barrier would wait for ranks whose nodes are queued behind it; so a seam
is never an autograd node.  Under grad at tp>1 a rank records its seams
on a ``SeamTape``: the tape cuts the step into rank-local autograd
segments at the seams (and, through ``cut``, on the residual stream), and
``SeamTape.backward`` runs each segment's backward and each seam's
exchange from the rank's own thread, last seam first (the way a pipeline
schedule drives its stages).  A seam under grad with no tape raises.

The replicated layout's backward (``scatter_axis="hidden"``, and
``kind="ar"``) is the reference's too: an ag op's dX is the local sum of
``dy @ w.T`` over its weights, with no collective (this rank's partial of
the replicated cotangent); an rs or ar op first completes its cotangent
with a psum over the group (the reference's ``cotangent_ar``), then runs
its local GEMMs.  The reference's ``lax.psum`` sums in the operand's
dtype; the port's sums every rank's partial in fp32, in rank order, and
rounds once to the operand's dtype, as the forward ``ar`` does.  Under
``flux`` the replicated layout runs no fused kernel, as in the reference.

``decomposed_bidir`` is the reference's pair of counter-rotating half
rings: each shard's top half rides the forward ring and its bottom half
the reverse ring (``_ag_bidir``, ``_rs_bidir``); an odd shard takes the
one-way ring, which is the reference's own rule.  The reference claims
half the per-link traffic of one ring, which needs a link per direction;
the ranks of one card share its memory, where each step is one exchange
with a pull copy from each neighbour (separate links come with ROADMAP
queue 1 item 2.5).  Its non-GEMM gathers and scatters ride the one-way
ring, as the reference's ``gather_seq`` and ``scatter_seq_sum`` do.

``remat`` checkpoints a block (``ParallelConfig.remat``): at tp=1 through
``torch.utils.checkpoint``; at tp>1 as one tape entry whose backward
re-runs the block, its exchanges included, on the rank's own thread.

The reference's tuning knobs ride every transport, forward and backward
(``FusedOp.from_plan`` binds a ``tuning.plans.SeamPlan``):

* ``comm_chunks`` — the AllGather ring cuts each shard into
  ``_sub_chunks(s_shard, n, comm_chunks)`` pieces, each landed, consumed
  and forwarded on its own (one exchange a piece a hop); the decomposed
  ``ar`` cuts its contraction into ``comm_chunks or n`` chunks.  As in
  the reference, the reduce-scatter rings and the counter-rotating half
  rings take the knob without using it (an odd shard's one-way ring
  does).
* ``reverse`` — the one-way rings' direction (``decomposed``, the
  re-gathers and the reduce-scatters of the backward) and the fused
  kernels' ring order under ``flux``; ``decomposed_bidir`` rides both.
* ``blocks`` — ``(bm, bk, bn)``: under ``flux`` on CUDA tensors the
  kernels' output tile ``(bm, bn)``, one of ``kernels.matmul.TILES``
  (anything else raises at the launch); the backward's interchanged
  kernels plan their own, as the reference's do.  The plain versions on
  CPU tensors take no tile: there it is carried and unused.
* ``fuse_epilogue`` — False applies an ``ag`` op's epilogue after the
  assembly instead of per chunk (or in the kernel's tile epilogue).
* ``shared_gather`` — False runs one ring (under ``flux`` one kernel) per
  weight of a multi-weight ``ag`` op instead of one over all of them.

The knobs change scheduling, never values, beyond the order of sums the
reference changes too.

``wire_dtype`` (None | "int8" | "fp8_e4m3" | "int4", ``VALID_WIRE_DTYPES``)
quantizes the FORWARD wire, as in the reference: every payload that
crosses the group is block-quantized (``wire_encode``: per-128-block
absmax fp32 scales; int4 two nibbles a byte) and decoded where it lands
(``wire_decode``), so the GEMMs see the decoded values.  It rides the
AllGather rings (each shard encoded once, its pieces cut after encoding),
``xla``'s monolithic gather, the reduce-scatter rings (the travelling
accumulator requantized each hop), the decomposed ``ar`` (the two
quantized rings of ``_ar_ring_quant`` when the output width divides by
the group, else the fp chunked sum) and the ``a2a`` dispatch (the combine
stays fp).  ``flux`` has no quantized path (``FusedOp`` raises), and
``xla``'s reduce-scatter and AllReduce ignore the knob.  The backward
never carries a wire: its transports are fp, and the ``a2a`` backward
rebuilds the fp received buffer by an exact exchange, so the grads are
the fp wire's, bit for bit.  ``wire_encode.calls`` counts the encodes.
The non-GEMM transports (``gather_seq``, ``scatter_seq_sum``, ``psum``)
take no wire.

``kind="a2a"`` is the MoE expert-parallel exchange (the reference's
``_a2a_impl``).  Dim 0 of x indexes the destination EP rank; the op
returns the same layout, ``out[j]`` holding this rank's tokens as EP rank
j's experts processed them.  ``xla`` runs the two barrier exchanges
(``a2a_exchange``: one ``RankGroup`` exchange each) around the batched
expert GEMMs; every other mode the shift ring (``_a2a_ring``): for each
shift, the block bound for the partner that far ahead travels as
``_sub_chunks(cap, n, comm_chunks)`` pieces, each piece one pull copy
out, the expert GEMMs on it, one copy back; ``reverse`` flips the ring's
direction.  Both also return the assembled received buffer, which the
backward keeps.  At n>1 under grad the op is a seam (``_A2ASeam``, the
reference's ``_a2a_bwd``): ``xla`` exchanges the cotangent, takes the
experts' vjp on the saved buffer and exchanges dX back; the ring modes
send each cotangent piece along the dispatch hops, pair it with the
saved piece it belongs to, and return dX on the inverse hops, with the
forward's shifts, pieces and direction (``_a2a_bwd_ring``).  The experts'
grads accumulate on their rank, with no exchange: each rank's experts
are its own.  The expert GEMMs are ``torch`` batched matmuls, as the
reference's ``_expert_fn`` is ``jnp.einsum``: no fused kernel, whatever
the mode.

ZeRO-3's weight gather (``zero3_gather``) is a seam of the data group,
not of a TP seam: every rank's dim-0 shards of a layer's flagged leaves
concatenated in rank order, its backward the summing reduce-scatter (the
transpose of the reference's tiled ``lax.all_gather``).  ``zero3_release``
frees the gathered copies' storage and records the gather that fills
them again when the tape's backward reaches it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.dist import clone as dist_clone


VALID_KINDS = ("ag", "rs", "ar", "a2a")
VALID_MODES = ("xla", "decomposed", "flux", "decomposed_bidir")
VALID_SCATTER_AXES = ("seq", "hidden")

VALID_WIRE_DTYPES = (None, "int8", "fp8_e4m3", "int4")


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


def _group_size(axis) -> int:
    return 1 if axis is None else axis.n


# ---------------------------------------------------------------------------
# Seams: collectives that autograd crosses
# ---------------------------------------------------------------------------
ENGINE_THREAD = (
    "a tp>1 seam ran under grad with no SeamTape recording: a seam is "
    "not an autograd node (on a CUDA card the autograd engine runs every "
    "rank's CUDA nodes on one device thread, where a rank cannot meet the "
    "others).  Record the forward on a core.overlap.SeamTape and call "
    "tape.backward(loss) from the rank (runtime.trainer does)")

_TAPE = threading.local()


def current_tape() -> Optional["SeamTape"]:
    """The tape recording this thread's seams, or None."""
    return getattr(_TAPE, "tape", None)


class SeamTape:
    """A rank's record of the seams of one forward pass, for a backward
    driven from the rank's own thread (module docstring).

        with SeamTape() as tape:
            loss = forward_loss(...)
        tape.backward(loss)

    Inside the ``with``, a seam whose inputs require grad runs its forward
    under ``no_grad`` and hands back fresh leaves that require grad: the
    autograd graph stops at every seam.  ``backward`` first runs autograd
    from the root; then, last seam first, it reads the grads its output
    leaves gathered, runs the seam's backward (the exchange) on this
    thread, and runs autograd from the seam's inputs with those grads.
    Seams are recorded in the order they ran, so every consumer of a
    seam's outputs has run its backward before the seam does.

    Each segment's autograd call frees its graph as it goes, so segments
    must not share a node: a tensor that reaches two seams' inputs (the
    residual stream) is cut with ``cut`` between them, and every segment
    is then walked once.  Grads of parameters accumulate in ``.grad`` as
    with ``loss.backward()``.  Each rank of a group holds a tape of its
    own."""

    def __init__(self):
        self.entries: List[Tuple] = []
        self._outer: Optional[SeamTape] = None

    def __enter__(self) -> "SeamTape":
        self._outer = current_tape()
        _TAPE.tape = self
        return self

    def __exit__(self, *exc) -> bool:
        _TAPE.tape = self._outer
        return False

    def record(self, seam, tensors) -> Tuple[torch.Tensor, ...]:
        with torch.no_grad():
            outs, saved = seam.forward(*tensors)
        leaves = tuple(o.detach().requires_grad_() for o in outs)
        self.entries.append((seam, tensors, leaves, saved))
        return leaves

    def backward(self, root, grad=None) -> None:
        """Backward from ``root`` (seeded with ``grad``, default ones, as
        each rank seeds its replicated loss in the reference); a tuple of
        roots takes a tuple of grads, and a root that needs no grad is
        passed over."""
        roots = root if isinstance(root, (tuple, list)) else (root,)
        grads = (grad if isinstance(grad, (tuple, list))
                 else (grad,) * len(roots))
        pairs = [(r, torch.ones_like(r) if g is None else g)
                 for r, g in zip(roots, grads) if r.requires_grad]
        torch.autograd.backward([r for r, _ in pairs], [g for _, g in pairs])
        while self.entries:
            # every rank runs every seam's backward, whatever its grads: the
            # exchange needs all ranks
            seam, tensors, leaves, saved = self.entries.pop()
            gouts = tuple(torch.zeros_like(leaf) if leaf.grad is None
                          else leaf.grad for leaf in leaves)
            with torch.no_grad():
                gins = seam.backward(saved, gouts)
            pairs = [(t, g) for t, g in zip(tensors, gins)
                     if t is not None and g is not None and t.requires_grad]
            if pairs:
                torch.autograd.backward([t for t, _ in pairs],
                                        [g for _, g in pairs])


def _needs_grad(*tensors) -> bool:
    """True when autograd would track an op on ``tensors`` (None allowed)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _run_seam(seam, *tensors) -> Tuple[torch.Tensor, ...]:
    """Run ``seam`` on ``tensors`` (None allowed): its forward alone when
    no input needs a gradient, else recorded on this thread's tape."""
    if not _needs_grad(*tensors):
        return seam.forward(*tensors)[0]
    tape = current_tape()
    if tape is None:
        raise RuntimeError(ENGINE_THREAD)
    return tape.record(seam, tensors)


class _CutSeam:
    """The identity, with no exchange: a tape boundary."""

    def forward(self, x):
        return (x,), None

    def backward(self, saved, gouts):
        return gouts


def cut(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` itself, cut out of the autograd graph on this thread's tape
    at tp>1 (its grad reaches ``x`` when the tape's backward comes to the
    cut).  The model cuts its residual stream before each sub-block, so
    that no autograd segment of the tape reaches back past the block
    boundary below it (``SeamTape``)."""
    if _group_size(axis) == 1 or current_tape() is None:
        return x
    return _run_seam(_CutSeam(), x)[0]


def recomputing() -> bool:
    """True while this thread re-runs a checkpointed block for its
    backward (``remat``): counters that the forward already bumped (the
    MoE's dropped assignments) skip the recompute."""
    return getattr(_TAPE, "recomputing", False)


class _Recompute:
    """Marks this thread as recomputing (``recomputing``)."""

    def __enter__(self):
        self._outer = recomputing()
        _TAPE.recomputing = True

    def __exit__(self, *exc):
        _TAPE.recomputing = self._outer
        return False


def _as_tuple(out) -> Tuple[torch.Tensor, ...]:
    return out if isinstance(out, tuple) else (out,)


class _RematSeam:
    """A checkpointed block as ONE tape entry.  Its forward runs the block
    under ``no_grad`` (its seams forward only) and keeps only the block's
    input; its backward re-runs the block under grad on a nested
    ``SeamTape``, on the rank's own thread (the recompute repeats the
    block's exchanges, as ``jax.checkpoint`` repeats its collectives),
    runs that tape's backward with the outputs' grads, and returns the
    input's.  The block may return a tensor or a tuple of them (a block
    and its MoE aux loss).  The block's weights gather their grads in
    ``.grad``."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def forward(self, x):
        return _as_tuple(self.fn(x)), x

    def backward(self, saved, gouts):
        x = saved.detach().requires_grad_()
        with torch.enable_grad(), SeamTape() as tape, _Recompute():
            outs = _as_tuple(self.fn(x))
        tape.backward(outs, gouts)
        return (torch.zeros_like(x) if x.grad is None else x.grad,)


def remat(fn: Callable, x: torch.Tensor, axis,
          weights: Sequence[torch.Tensor] = ()):
    """``fn(x)`` (a tensor or a tuple of tensors) with its activations
    recomputed in the backward (the reference's ``jax.checkpoint`` of a
    block); ``weights`` are the block's parameters.  At tp=1
    ``torch.utils.checkpoint``; at tp>1 one entry on this thread's tape
    (``_RematSeam``): the autograd engine's recompute would run on the
    card's device thread, where the ranks' seams cannot meet."""
    if not _needs_grad(x, *weights):
        return fn(x)
    if _group_size(axis) == 1:
        return torch.utils.checkpoint.checkpoint(
            fn, x, use_reentrant=False,
            context_fn=lambda: (contextlib.nullcontext(), _Recompute()))
    tape = current_tape()
    if tape is None:
        raise RuntimeError(ENGINE_THREAD)
    outs = tape.record(_RematSeam(fn), (x,))
    return outs if len(outs) > 1 else outs[0]


class _TransportSeam:
    """gather_seq / scatter_seq_sum / psum and their transposes."""

    def __init__(self, group, mode: str, reverse: bool, what: str):
        self.group, self.mode, self.reverse, self.what = (group, mode,
                                                          reverse, what)

    def _apply(self, what: str, x: torch.Tensor) -> torch.Tensor:
        if what == "gather":
            return _gather_seq_raw(x, self.group, self.mode, self.reverse)
        if what == "scatter":
            return _scatter_seq_raw(x, self.group, self.mode, self.reverse)
        return _psum_raw(x, self.group)

    def forward(self, x):
        return (self._apply(self.what, x),), None

    def backward(self, saved, gouts):
        transpose = {"gather": "scatter", "scatter": "gather",
                     "psum": "psum"}[self.what]
        return (self._apply(transpose, gouts[0]),)


# ---------------------------------------------------------------------------
# wire_dtype: the block-quantized wire codec (the reference's, op for op)
# ---------------------------------------------------------------------------
_WIRE_BLOCK = 128

# symmetric range of each wire dtype (the block scale is amax / qmax)
_WIRE_QMAX = {"int8": 127.0, "fp8_e4m3": 448.0, "int4": 7.0}


def wire_encode(x: torch.Tensor, wire_dtype: str
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)`` payload pair for one wire hop: per-128-block absmax
    scales (fp32; one block when the width is not a multiple of 128),
    values quantized to the wire dtype.  ``int4`` packs two sign-extended
    nibbles a uint8 when the width is even (decode detects packing by
    dtype).  An all-zero block's scale is clamped to fp32's smallest
    normal, so it decodes to exact zeros.  The reference's arithmetic in
    its order (``amax / qmax``, the clamp, ``x / scale``; ``torch.round``
    rounds half to even, as ``jnp.round``), so CPU and CUDA tensors give
    the same bytes.  Each call adds one to ``wire_encode.calls``."""
    from repro_torch.kernels.build import count_launch
    qmax = _WIRE_QMAX.get(wire_dtype)
    if qmax is None:
        raise ValueError(f"invalid wire_dtype {wire_dtype!r}")
    count_launch(wire_encode, "calls")
    d = x.shape[-1]
    blocks = d // _WIRE_BLOCK if d % _WIRE_BLOCK == 0 else 1
    xb = x.reshape(*x.shape[:-1], blocks, d // blocks).float()
    amax = xb.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: CUDA divides by a host scalar as a multiply by its
    # reciprocal, which rounds differently from the CPU's (and XLA's) divide
    scale = torch.clamp_min(amax / torch.full_like(amax, qmax),
                            torch.finfo(torch.float32).tiny)
    v = xb / scale
    if wire_dtype == "fp8_e4m3":
        q = v.to(torch.float8_e4m3fn).reshape(x.shape)
    else:
        q = torch.clamp(torch.round(v), -qmax, qmax).to(torch.int8)
        q = q.reshape(x.shape)
        if wire_dtype == "int4":
            q = _int4_pack(q)
    return q, scale[..., 0]


wire_encode.calls = 0


def wire_decode(payloads: Sequence[torch.Tensor], wire_dtype: str,
                dtype: torch.dtype) -> torch.Tensor:
    """Inverse of ``wire_encode`` on a ``(q, scale)`` pair, in ``dtype``."""
    q, scale = payloads
    if wire_dtype == "int4" and q.dtype == torch.uint8:
        q = _int4_unpack(q)
    d = q.shape[-1]
    blocks = scale.shape[-1]
    xb = q.float().reshape(*q.shape[:-1], blocks, d // blocks)
    return (xb * scale[..., None]).reshape(q.shape).to(dtype)


def _int4_pack(q4: torch.Tensor) -> torch.Tensor:
    """Two int4 values a uint8 (even positions in the low nibble); an odd
    width stays int8, a byte each."""
    if q4.shape[-1] % 2:
        return q4
    lo = q4[..., 0::2].to(torch.int32)
    hi = q4[..., 1::2].to(torch.int32)
    return ((lo & 0xF) | ((hi & 0xF) << 4)).to(torch.uint8)


def _int4_unpack(q: torch.Tensor) -> torch.Tensor:
    b = q.to(torch.int32)
    lo = ((b & 0xF) ^ 8) - 8            # sign-extend the nibble
    hi = ((b >> 4) ^ 8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(
        *q.shape[:-1], q.shape[-1] * 2).to(torch.int8)


def _encode(x: torch.Tensor, wire_dtype: Optional[str]
            ) -> Tuple[torch.Tensor, ...]:
    """The payload a transport moves: ``(x,)`` on the fp wire, else the
    ``(q, scale)`` pair."""
    return wire_encode(x, wire_dtype) if wire_dtype else (x,)


def _decode(payloads: Sequence[torch.Tensor], wire_dtype: Optional[str],
            dtype: torch.dtype) -> torch.Tensor:
    return (wire_decode(payloads, wire_dtype, dtype) if wire_dtype
            else payloads[0])


def _wire_hop(acc: torch.Tensor, group, perm, what: str,
              wire_dtype: Optional[str]) -> torch.Tensor:
    """One ring hop of ``acc``, quantized on the wire when asked (encode,
    one pull of the pair, decode: lossy each hop, by design)."""
    return _decode(group.ppermute(_encode(acc, wire_dtype), perm, what),
                   wire_dtype, acc.dtype)


# ---------------------------------------------------------------------------
# Ring transports over the rank group
# ---------------------------------------------------------------------------
def _ring_perm(n: int, reverse: bool = False) -> List[Tuple[int, int]]:
    if reverse:
        return [(i, (i - 1) % n) for i in range(n)]
    return [(i, (i + 1) % n) for i in range(n)]


def _seq_rows(x: torch.Tensor, start: int, length: int) -> torch.Tensor:
    return x.narrow(x.dim() - 2, start, length)


def _gather_full(x: torch.Tensor, group,
                 wire_dtype: Optional[str] = None) -> torch.Tensor:
    """Monolithic (xla-mode) sequence gather: every rank's shard, copied
    in rank order; on a quantized wire every rank's ``(q, scale)`` pair in
    one exchange, decoded once gathered."""
    if not wire_dtype:
        return group.all_gather(x, x.dim() - 2, "ag_full")
    parts = group.exchange(wire_encode(x, wire_dtype), "ag_full")
    return wire_decode([torch.cat([p[i] for p in parts],
                                  dim=parts[0][i].dim() - 2)
                        for i in range(2)], wire_dtype, x.dtype)


def _psum_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """Monolithic (xla-mode) reduce-scatter along dim -2: this rank's rows
    of every rank's partial, summed in rank order in fp32."""
    me = group.rank()
    s_shard = x.shape[-2] // group.n
    parts = group.exchange(x, "rs_scatter")
    acc = None
    for p in parts:
        rows = _seq_rows(p, me * s_shard, s_shard).float()
        acc = rows if acc is None else acc + rows
    return acc.to(x.dtype)


def _gather_seq_raw(x: torch.Tensor, group, mode: str,
                    reverse: bool = False) -> torch.Tensor:
    if mode.startswith("decomposed"):
        return _ag_ring(x, group, 0, reverse, lambda c: (c,))[0]
    return _gather_full(x, group)


def _scatter_seq_raw(x: torch.Tensor, group, mode: str,
                     reverse: bool = False) -> torch.Tensor:
    if not mode.startswith("decomposed"):
        return _psum_scatter(x, group)
    s_shard = x.shape[-2] // group.n
    return _reduce_ring(group, reverse, "scatter_seq",
                        lambda o: _seq_rows(x, o * s_shard, s_shard))


def _psum_raw(x: torch.Tensor, group, dtype=None) -> torch.Tensor:
    """Every rank's x summed in rank order (n > 1: a new tensor): in x's
    dtype, or, given ``dtype``, in fp32 and cast to ``dtype``."""
    acc = None
    for p in group.exchange(x, "psum"):
        if dtype is not None and acc is None:
            p = p.float()
        acc = p if acc is None else acc + p
    return acc if dtype is None else acc.to(dtype)


def gather_seq(x: torch.Tensor, axis, mode: str = "decomposed",
               reverse: bool = False) -> torch.Tensor:
    """Gather a sequence-sharded non-GEMM payload (boundary rows, cache
    tails) to full length along dim -2: the ring for the ring modes, the
    monolithic gather otherwise.  Values are identical either way.  Its
    backward is the reduce-scatter of the cotangent on the same
    transport (the transpose of the gather)."""
    if _group_size(axis) == 1:
        return x
    return _run_seam(_TransportSeam(axis, mode, reverse, "gather"), x)[0]


def scatter_seq_sum(x: torch.Tensor, axis, mode: str = "decomposed",
                    reverse: bool = False) -> torch.Tensor:
    """ReduceScatter along dim -2 of a per-rank full-sequence partial (the
    embedding seam's combine under the sequence-sharded layout):
    out[rows of my shard] = sum over ranks of x[those rows].  The ring
    modes accumulate along the ring, as ``_rs_ring`` does.  Its backward
    gathers the cotangent on the same transport."""
    if _group_size(axis) == 1:
        return x
    return _run_seam(_TransportSeam(axis, mode, reverse, "scatter"), x)[0]


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    """Sum of every rank's ``x``, in rank order (``lax.psum``).  Its
    backward is the psum of the cotangent, the reference's transpose under
    ``check_rep=False``: each rank's cotangent of the replicated sum is a
    partial, and the sum of the partials reaches every rank's operand."""
    if _group_size(axis) == 1:
        return x
    return _run_seam(_TransportSeam(axis, "xla", False, "psum"), x)[0]


def ppermute(x: torch.Tensor, axis,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Send ``x`` along ``perm`` ((src, dst) pairs; ``lax.ppermute``): the
    token-shift seam's one boundary row.  Its backward sends the cotangent
    back along the inverse permutation."""
    if _group_size(axis) == 1:
        return x
    return _run_seam(_PermuteSeam(axis, perm), x)[0]


class _PermuteSeam:
    def __init__(self, group, perm):
        self.group, self.perm = group, [tuple(p) for p in perm]

    def forward(self, x):
        return (self.group.ppermute(x, self.perm, "ppermute"),), None

    def backward(self, saved, gouts):
        inverse = [(d, s) for s, d in self.perm]
        return (self.group.ppermute(gouts[0], inverse, "ppermute"),)


class _Zero3GatherSeam:
    """ZeRO-3's per-layer weight gather over the data group: the ranks'
    dim-0 shards joined in rank order, one exchange for the layer's
    leaves; its backward sums every rank's grad rows of this rank's shard
    (the summing reduce-scatter)."""

    def __init__(self, group):
        self.group = group

    def forward(self, *shards):
        parts = self.group.exchange(tuple(shards), "zero3_gather")
        return tuple(torch.cat([p[i] for p in parts])
                     for i in range(len(shards))), None

    def backward(self, saved, gouts):
        parts = self.group.exchange(tuple(gouts), "zero3_grads")
        me = self.group.rank()
        out = []
        for i, g in enumerate(gouts):
            rows = g.shape[0] // self.group.n
            acc = None
            for p in parts:
                piece = p[i][me * rows:(me + 1) * rows]
                acc = piece.clone() if acc is None else acc.add_(piece)
            out.append(acc)
        return tuple(out)


def zero3_gather(shards: Sequence[torch.Tensor], group
                 ) -> Tuple[torch.Tensor, ...]:
    """The whole leaves of ``shards`` (each this rank's dim-0 shard) over
    the data ``group``: a seam on the rank's tape under grad (its
    backward the summing reduce-scatter); the shards themselves in a
    group of one rank."""
    if _group_size(group) == 1 or not shards:
        return tuple(shards)
    return tuple(_run_seam(_Zero3GatherSeam(group), *shards))


class _Zero3ReleaseSeam:
    """Frees gathered weights' storage in the forward; in the backward
    gathers them again into the same storage (written through ``.data``:
    the saved tensors' version counters stay as autograd saved them)."""

    def __init__(self, full, shards, group):
        self.full, self.shards, self.group = full, shards, group
        self.nbytes = [t.untyped_storage().nbytes() for t in full]

    def forward(self):
        zero3_free(self.full)
        return (), None

    def backward(self, saved, gouts):
        parts = self.group.exchange(tuple(t.detach() for t in self.shards),
                                    "zero3_regather")
        for i, (t, nb) in enumerate(zip(self.full, self.nbytes)):
            t.untyped_storage().resize_(nb)
            torch.cat([p[i] for p in parts], out=t.data)
        return ()


def zero3_free(full: Sequence[torch.Tensor]) -> None:
    """Free the storage of ``zero3_gather``'s copies ``full`` (the serve
    steps' release: no backward refills them)."""
    for t in full:
        t.untyped_storage().resize_(0)


def zero3_release(full: Sequence[torch.Tensor],
                  shards: Sequence[torch.Tensor], group) -> None:
    """Free the storage of ``zero3_gather``'s copies ``full`` once their
    layer's forward is done, and record on this thread's tape the gather
    (of ``shards``) that refills them when the backward reaches this
    point: record it after every op of the forward that reads them."""
    tape = current_tape()
    if tape is None or _group_size(group) == 1:
        return
    tape.record(_Zero3ReleaseSeam(tuple(full), tuple(shards), group), ())


def pmax(x: torch.Tensor, axis) -> torch.Tensor:
    """Elementwise max over the ranks (``lax.pmax``), with no gradient: the
    reference stops the gradient before it (the xent's stability shift)."""
    x = x.detach()
    if _group_size(axis) == 1:
        return x
    with torch.no_grad():
        return torch.stack(axis.exchange(x, "pmax")).amax(dim=0)


def _out_buffers(x: torch.Tensor, seq_len: int,
                 first: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Output buffers [..., seq_len, W_b], shaped and typed like the first
    chunk's outputs (the reference sizes them by ``jax.eval_shape``)."""
    return [c.new_empty((*x.shape[:-2], seq_len, c.shape[-1]))
            for c in first]


def _sub_chunks(s_shard: int, n: int, comm_chunks: int) -> int:
    """Pieces a shard is cut into on the ring: ``comm_chunks / n`` (at
    least 1; 0 is one piece), at most the shard's rows, lowered until it
    divides them (the reference's rule)."""
    sub = max(1, comm_chunks // n) if comm_chunks else 1
    sub = min(sub, s_shard)
    while s_shard % sub:
        sub -= 1
    return sub


def _ag_ring(x: torch.Tensor, group, comm_chunks: int, reverse: bool,
             chunk_fn: Callable, wire_dtype: Optional[str] = None
             ) -> Tuple[torch.Tensor, ...]:
    """Chunked AllGather ring of shard hops along dim -2: each shard
    travels as ``_sub_chunks`` pieces, and each landed piece is consumed
    by ``chunk_fn`` ([..., L, D] -> tuple of [..., L, W_b]) as soon as it
    arrives.  Ring order starts at the LOCAL shard (paper §4.3).  On a
    quantized wire the shard is encoded once and its ``(q, scale)``
    pieces travel; ``chunk_fn`` sees each piece decoded (the local one
    too, as in the reference)."""
    n, me = group.n, group.rank()
    s_shard = x.shape[-2]
    sub = _sub_chunks(s_shard, n, comm_chunks)
    sub_len = s_shard // sub
    payloads = _encode(x, wire_dtype)
    bufs = [tuple(_seq_rows(p, j * sub_len, sub_len) for p in payloads)
            for j in range(sub)]
    ys: Optional[List[torch.Tensor]] = None
    for step in range(n):
        owner = (me + step) % n if reverse else (me - step) % n
        for j, buf in enumerate(bufs):
            chunks = chunk_fn(_decode(buf, wire_dtype, x.dtype))
            if ys is None:
                ys = _out_buffers(x, s_shard * n, chunks)
            for y, ch in zip(ys, chunks):
                _seq_rows(y, owner * s_shard + j * sub_len,
                          sub_len).copy_(ch)
        if step < n - 1:
            bufs = [group.ppermute(b, _ring_perm(n, reverse), "ag_ring")
                    for b in bufs]
    return tuple(ys)


def _bidir_hop(group, right, left, what: str):
    """One step of the two counter-rotating rings, in one exchange:
    ``right`` moves to the next rank and ``left`` to the previous one (a
    tensor each, or a tuple: a quantized payload and its scales); each
    rank pulls a copy from each neighbour."""
    n, me = group.n, group.rank()
    pairs = group.publish((right, left), what)
    (from_prev, ev_prev), (from_next, ev_next) = (pairs[(me - 1) % n],
                                                  pairs[(me + 1) % n])
    return (dist_clone(group.wait_for((from_prev[0], ev_prev))),
            dist_clone(group.wait_for((from_next[1], ev_next))))


def _ag_bidir(x: torch.Tensor, group, comm_chunks: int,
              chunk_fn: Callable, wire_dtype: Optional[str] = None
              ) -> Tuple[torch.Tensor, ...]:
    """Counter-rotating half rings (the reference's ``_ag_bidir``): each
    shard's top half rides the forward ring and its bottom half the
    reverse ring, and ``chunk_fn`` consumes each landed half as it
    arrives.  An odd shard (or a one-row shard) takes the one-way
    forward ring, sub-chunked by ``comm_chunks``: the reference's own
    rule (its ``overlap.py:386``); the half rings themselves are not
    sub-chunked there either.  On a quantized wire each half is encoded
    once and travels as its ``(q, scale)`` pair."""
    n, me = group.n, group.rank()
    s_shard = x.shape[-2]
    half = s_shard // 2
    if half == 0 or s_shard % 2:
        return _ag_ring(x, group, comm_chunks, False, chunk_fn, wire_dtype)
    buf_r = _encode(_seq_rows(x, 0, half), wire_dtype)
    buf_l = _encode(_seq_rows(x, half, half), wire_dtype)
    ys: Optional[List[torch.Tensor]] = None
    for step in range(n):
        owner_r, owner_l = (me - step) % n, (me + step) % n
        cr = chunk_fn(_decode(buf_r, wire_dtype, x.dtype))
        cl = chunk_fn(_decode(buf_l, wire_dtype, x.dtype))
        if ys is None:
            ys = _out_buffers(x, s_shard * n, cr)
        for y, top, bottom in zip(ys, cr, cl):
            _seq_rows(y, owner_r * s_shard, half).copy_(top)
            _seq_rows(y, owner_l * s_shard + half, half).copy_(bottom)
        if step < n - 1:
            buf_r, buf_l = _bidir_hop(group, buf_r, buf_l, "ag_bidir")
    return tuple(ys)


def _reduce_ring(group, reverse: bool, what: str,
                 partial_for: Callable[[int], torch.Tensor],
                 wire_dtype: Optional[str] = None) -> torch.Tensor:
    """ReduceScatter ring: at step s each rank adds ``partial_for(owner)``
    for the owner whose sum it holds next and forwards it; after n - 1 hops
    each rank holds the sum for its own shard.  ``wire_dtype`` requantizes
    the travelling accumulator before each hop (the sum stays in its
    dtype); the non-GEMM scatter never passes one."""
    n, me = group.n, group.rank()

    def owner_at(s):
        return (me - (n - 1 - s)) % n if reverse else (me + n - 1 - s) % n

    acc = partial_for(owner_at(0))
    for s in range(1, n):
        acc = _wire_hop(acc, group, _ring_perm(n, reverse), what, wire_dtype)
        acc = acc + partial_for(owner_at(s))
    return acc


# ---------------------------------------------------------------------------
# GEMM-ReduceScatter transports (one collective pass for all pairs)
# ---------------------------------------------------------------------------
def _rs_partial(ys, ws, owner: int, s_shard: int,
                length: Optional[int] = None,
                offset: int = 0) -> torch.Tensor:
    """sum_i ys_i[owner's seq rows] @ ws_i — the per-owner partial of the
    multi-pair reduce-scatter (one ring carries the SUMMED partial);
    ``length`` rows from ``offset`` into the owner's shard (default: the
    whole shard)."""
    length = s_shard if length is None else length
    acc = None
    for y, w in zip(ys, ws):
        p = torch.matmul(_seq_rows(y, owner * s_shard + offset, length), w)
        acc = p if acc is None else acc + p
    return acc


def _rs_ring(ys, ws, group, reverse: bool = False,
             wire_dtype: Optional[str] = None) -> torch.Tensor:
    """GEMM-ReduceScatter ring: at step s each rank computes ONLY the
    output chunk the ring needs next, adds the partial arriving from its
    neighbour, and forwards (paper Fig. 3, medium-grained)."""
    seq = ys[0].shape[-2]
    if seq % group.n:
        raise ValueError(f"seq {seq} not divisible by TP {group.n}")
    s_shard = seq // group.n
    return _reduce_ring(group, reverse, "rs_ring",
                        lambda o: _rs_partial(ys, ws, o, s_shard),
                        wire_dtype)


def _rs_bidir(ys, ws, group, wire_dtype: Optional[str] = None
              ) -> torch.Tensor:
    """Counter-rotating GEMM-ReduceScatter (the reference's ``_rs_bidir``):
    the top halves of the owners' rows accumulate along the forward ring,
    the bottom halves along the reverse ring, one exchange a step.  An odd
    shard takes the one-way ring, the reference's rule (its
    ``overlap.py:563``)."""
    n, me = group.n, group.rank()
    seq = ys[0].shape[-2]
    if seq % n:
        raise ValueError(f"seq {seq} not divisible by TP {n}")
    s_shard = seq // n
    if s_shard % 2:
        return _rs_ring(ys, ws, group, False, wire_dtype)
    half = s_shard // 2

    def partial(owner: int, top: bool) -> torch.Tensor:
        return _rs_partial(ys, ws, owner, s_shard, half, 0 if top else half)

    acc_r = partial((me + n - 1) % n, True)
    acc_l = partial((me - (n - 1)) % n, False)
    for s in range(1, n):
        pr, pl = _bidir_hop(group, _encode(acc_r, wire_dtype),
                            _encode(acc_l, wire_dtype), "rs_bidir")
        acc_r = _decode(pr, wire_dtype, acc_r.dtype)
        acc_l = _decode(pl, wire_dtype, acc_l.dtype)
        acc_r = acc_r + partial((me + n - 1 - s) % n, True)
        acc_l = acc_l + partial((me - (n - 1) + s) % n, False)
    return torch.cat([acc_r, acc_l], dim=acc_r.dim() - 2)


def _rs_core(ys, ws, axis, mode: str, reverse: bool = False,
             blocks=None, wire_dtype: Optional[str] = None) -> torch.Tensor:
    """sum_i ReduceScatter_seq(ys_i @ ws_i) with ONE collective pass.
    ``wire_dtype`` quantizes the rings' travelling partials; ``xla``'s
    monolithic reduce-scatter ignores it, as the reference's
    ``psum_scatter`` does, and ``flux`` never gets one."""
    if _group_size(axis) == 1:
        return _rs_partial(ys, ws, 0, ys[0].shape[-2])
    if mode == "xla":
        return _psum_scatter(_rs_partial(ys, ws, 0, ys[0].shape[-2]), axis)
    if mode == "flux":
        # multi-pair RS == one RS of the concatenated operands (the
        # contraction dim stacks): still one fused kernel
        y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=-1)
        w = ws[0] if len(ws) == 1 else torch.cat(ws, dim=0)
        return _rs_flux(y, w, axis, reverse, blocks)
    if mode == "decomposed_bidir":
        return _rs_bidir(ys, ws, axis, wire_dtype)
    return _rs_ring(ys, ws, axis, reverse, wire_dtype)


def _ar_ring_quant(p: torch.Tensor, group, wire_dtype: str) -> torch.Tensor:
    """AllReduce of every rank's full partial ``p`` over quantized hops
    (the reference's ``_ar_ring_quant``): a reduce-scatter ring over the
    width's n shards (the travelling accumulator requantized each hop,
    each rank's own partial added in full precision), then an AllGather
    ring of the reduced shards (each encoded once; the local one stays
    unquantized).  The sums are in p's dtype, as the reference's."""
    n, me = group.n, group.rank()
    shard = p.shape[-1] // n

    def part(s):
        o = (me + n - 1 - s) % n
        return p[..., o * shard:(o + 1) * shard]

    acc = part(0)
    for s in range(1, n):
        acc = _wire_hop(acc, group, _ring_perm(n), "ar_ring", wire_dtype)
        acc = acc + part(s)
    out = torch.empty_like(p)
    out[..., me * shard:(me + 1) * shard] = acc
    payloads = wire_encode(acc, wire_dtype)
    for step in range(1, n):
        payloads = group.ppermute(payloads, _ring_perm(n), "ar_ring")
        owner = (me - step) % n
        out[..., owner * shard:(owner + 1) * shard] = wire_decode(
            payloads, wire_dtype, p.dtype)
    return out


def _ar_core(y: torch.Tensor, w: torch.Tensor, axis, mode: str,
             comm_chunks: int = 0,
             wire_dtype: Optional[str] = None) -> torch.Tensor:
    """AllReduce(y @ w): the row-parallel GEMM of the replicated layout.
    The ring modes cut the contraction dim into ``comm_chunks or n``
    chunks (fewer when that does not divide it), AllReduce each chunk's
    partial in fp32 and sum the reduced chunks in chunk order, in fp32
    (the reference rounds each reduced chunk to y's dtype first); ``xla``
    and ``flux`` reduce the one partial (a one-token GEMM is
    latency-bound).  Under the ring modes a ``wire_dtype`` rides the two
    quantized rings (``_ar_ring_quant``) when the output width divides by
    the group, as in the reference; ``xla`` and ``flux`` ignore it."""
    if _group_size(axis) == 1:
        return torch.matmul(y, w)
    if not mode.startswith("decomposed"):
        return _psum_raw(torch.matmul(y, w), axis, y.dtype)
    if wire_dtype and w.shape[-1] % axis.n == 0:
        return _ar_ring_quant(torch.matmul(y, w), axis, wire_dtype)
    k = y.shape[-1]
    chunks = max(1, min(comm_chunks or axis.n, k))
    while k % chunks:
        chunks -= 1
    ck = k // chunks
    out = None
    for c in range(chunks):
        part = _psum_raw(torch.matmul(y[..., c * ck:(c + 1) * ck],
                                      w[c * ck:(c + 1) * ck]), axis,
                         torch.float32)
        out = part if out is None else out + part
    return out.to(y.dtype)


# ---------------------------------------------------------------------------
# mode="flux": the fused kernels (kernels.ops)
# ---------------------------------------------------------------------------
def _ag_flux(x: torch.Tensor, w: torch.Tensor, group, reverse: bool = False,
             blocks=None, activation: Optional[str] = None,
             bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    from repro_torch.kernels import ops as kops
    # the kernels gather [m_shard, k] operands along m in SHARD-MAJOR order:
    # move the (sharded) sequence dim to the front so that shard-major is
    # sequence order, then flatten the batch dims into m
    n = group.n
    lead = x.shape[:-2]
    x2 = torch.movedim(x, -2, 0).reshape(-1, x.shape[-1])
    # the kernels take row-major operands: a transposed weight (the
    # backward's w.T, the LM head's table.T) is copied
    y2 = kops.ag_matmul_fused(x2, w.contiguous(), axis_name="tp", n_dev=n,
                              reverse=reverse, activation=activation,
                              bias=bias, blocks=blocks)
    yt = y2.reshape(x.shape[-2] * n, *lead, w.shape[-1])
    return torch.movedim(yt, 0, -2)                    # [*lead, S, F/N]


def _rs_flux(y: torch.Tensor, w: torch.Tensor, group, reverse: bool = False,
             blocks=None) -> torch.Tensor:
    from repro_torch.kernels import ops as kops
    n = group.n
    lead = y.shape[:-2]
    y2 = torch.movedim(y, -2, 0).reshape(-1, y.shape[-1])
    o2 = kops.matmul_rs_fused(y2, w.contiguous(), axis_name="tp", n_dev=n,
                              reverse=reverse, blocks=blocks)
    ot = o2.reshape(y.shape[-2] // n, *lead, w.shape[-1])
    return torch.movedim(ot, 0, -2)                    # [*lead, S/N, D]


# ---------------------------------------------------------------------------
# FusedOp: the declarative op object
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FusedOp:
    """One TP-seam GEMM with a fused epilogue (module docstring).  The
    reference's fields, with ``epilogue`` and ``n_weights`` second and
    third as in the port's tp=1 slices (pass the rest by keyword); the
    tuning knobs as the module docstring says."""
    kind: str
    epilogue: Epilogue = Epilogue()
    n_weights: int = 1
    axis: Optional[object] = None          # dist.RankGroup
    mode: str = "decomposed"
    scatter_axis: str = "seq"
    wire_dtype: Optional[str] = None
    comm_chunks: int = 0
    reverse: bool = False
    blocks: Optional[Tuple[int, int, int]] = None
    fuse_epilogue: bool = True
    shared_gather: bool = True

    def __post_init__(self):
        if self.kind not in VALID_KINDS:
            raise ValueError(f"invalid kind {self.kind!r}")
        if self.mode not in VALID_MODES:
            raise ValueError(f"invalid overlap mode {self.mode!r}")
        if self.scatter_axis not in VALID_SCATTER_AXES:
            raise ValueError(f"invalid scatter_axis {self.scatter_axis!r}")
        if self.wire_dtype not in VALID_WIRE_DTYPES:
            raise ValueError(f"invalid wire_dtype {self.wire_dtype!r}")
        if self.wire_dtype is not None and self.mode == "flux":
            raise ValueError(
                "wire_dtype is not supported with mode='flux' (the fused "
                "kernels have no quantized path); use a decomposed mode or "
                "drop wire_dtype")
        if self.n_weights < 1:
            raise ValueError("n_weights must be >= 1")
        if self.comm_chunks < 0:
            raise ValueError(f"comm_chunks must be >= 0, got "
                             f"{self.comm_chunks}")
        if self.blocks is not None:
            if len(self.blocks) != 3:
                raise ValueError(f"blocks {self.blocks}: (bm, bk, bn)")
            object.__setattr__(self, "blocks", tuple(self.blocks))
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
        if self.kind == "ar":
            # "ar" IS the replicated layout (one-token decode GEMMs)
            object.__setattr__(self, "scatter_axis", "hidden")
        if self.kind != "ag" and self.n_weights != 1:
            raise ValueError(f"kind={self.kind!r} ops take exactly one weight")
        if self.epilogue.gate == "pair":
            if self.kind != "ag" or self.n_weights != 2:
                raise ValueError('gate="pair" needs an ag op with n_weights=2')
        elif self.n_weights > 1 and not self.epilogue.is_identity:
            raise ValueError("multi-output ops (n_weights>1 without "
                             'gate="pair") require an identity epilogue')

    @staticmethod
    def from_plan(kind: str, plan, axis=None,
                  epilogue: Optional[Epilogue] = None, n_weights: int = 1,
                  scatter_axis: Optional[str] = None) -> "FusedOp":
        """Bind a tuning ``SeamPlan`` (anything with its fields) to a seam
        op; ``scatter_axis=None`` takes the plan's layout knob."""
        blocks = getattr(plan, "blocks", None)
        return FusedOp(
            kind, epilogue=epilogue if epilogue is not None else Epilogue(),
            n_weights=n_weights, axis=axis, mode=plan.mode,
            scatter_axis=(scatter_axis if scatter_axis is not None
                          else getattr(plan, "scatter_axis", "seq")),
            wire_dtype=getattr(plan, "wire_dtype", None),
            comm_chunks=plan.comm_chunks,
            reverse=getattr(plan, "reverse", False),
            blocks=tuple(blocks) if blocks else None,
            fuse_epilogue=getattr(plan, "fuse_epilogue", True),
            shared_gather=getattr(plan, "shared_gather", True))

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
            if _group_size(self.axis) == 1:
                return _expert_fn(epi, x, *ws)
            return _run_seam(_A2ASeam(self), x, *ws)[0]
        if _group_size(self.axis) == 1:
            # one rank: local GEMMs, plain autograd
            if self.kind == "ag":
                return _fused_ag(self, x, ws, bias, scale, residual)
            z = _fused_z(self, x, ws)
            return epi.apply([z], bias=bias, scale=scale, residual=residual)
        outs = _run_seam(_OpSeam(self), x, *ws, bias, scale, residual)
        return outs[0] if self.combines else tuple(outs)


def _apply_epilogue(op: FusedOp, ys: Sequence[torch.Tensor], bias, scale,
                    residual):
    """Epilogue at the op level: combine to one tensor, or pass the
    per-weight outputs through as a tuple (identity epilogue)."""
    if op.combines:
        return op.epilogue.apply(ys, bias=bias, scale=scale,
                                 residual=residual)
    return tuple(ys)


def _fused_ag(op: FusedOp, x, ws, bias, scale, residual):
    epi = op.epilogue
    if _group_size(op.axis) == 1 or op.scatter_axis == "hidden":
        # hidden layout / one rank: x is already the full activation
        ys = [torch.matmul(x, w) for w in ws]
        return _apply_epilogue(op, ys, bias, scale, residual)
    if op.mode == "flux":
        return _fused_ag_flux(op, x, ws, bias, scale, residual)
    if op.mode == "xla":
        full = _gather_full(x, op.axis, op.wire_dtype)
        ys = [torch.matmul(full, w) for w in ws]
        return _apply_epilogue(op, ys, bias, scale, residual)

    # the ring: the epilogue fuses PER CHUNK inside the overlapped loop
    # (residual is row-indexed by global position -> applied after
    # assembly; everything else is chunk-local)
    per_chunk = (op.fuse_epilogue and op.combines and not epi.is_identity
                 and (op.shared_gather or op.n_weights == 1))
    epi_chunk = dataclasses.replace(epi, residual=False)

    def chunk_fn(xc):
        ys = [torch.matmul(xc, w) for w in ws]
        if per_chunk:
            return (epi_chunk.apply(ys, bias=bias, scale=scale),)
        return tuple(ys)

    def run(fn):
        if op.mode == "decomposed_bidir":
            return _ag_bidir(x, op.axis, op.comm_chunks, fn, op.wire_dtype)
        return _ag_ring(x, op.axis, op.comm_chunks, op.reverse, fn,
                        op.wire_dtype)

    if op.shared_gather or op.n_weights == 1:
        outs = run(chunk_fn)          # ONE ring pass for all weights
    else:
        outs = tuple(run(lambda xc, w=w: (torch.matmul(xc, w),))[0]
                     for w in ws)     # one ring per weight
    if per_chunk:
        out = outs[0]
        if epi.residual:
            out = out + residual
        return out
    return _apply_epilogue(op, list(outs), bias, scale, residual)


def _fused_ag_flux(op: FusedOp, x, ws, bias, scale, residual):
    epi = op.epilogue
    # single-weight bias/activation fuse into the kernel's tile epilogue
    if (op.n_weights == 1 and op.fuse_epilogue and not epi.scale
            and epi.gate is None):
        y = _ag_flux(x, ws[0], op.axis, op.reverse, op.blocks,
                     activation=epi.activation,
                     bias=bias if epi.bias else None)
        if epi.residual:
            y = y + residual
        return y
    if op.n_weights == 1 or op.shared_gather:
        # shared gather: one kernel over the column-stacked weights (a
        # packed w13 is one weight already), then split the local outputs
        w = ws[0] if len(ws) == 1 else torch.cat(ws, dim=-1)
        ycat = _ag_flux(x, w, op.axis, op.reverse, op.blocks)
        ys = list(torch.split(ycat, [w_.shape[-1] for w_ in ws], dim=-1))
    else:
        ys = [_ag_flux(x, w, op.axis, op.reverse, op.blocks) for w in ws]
    return _apply_epilogue(op, ys, bias, scale, residual)


def _fused_z(op: FusedOp, x, ws):
    """Pre-epilogue output of an rs/ar op (the collective's result).  An rs
    op in the hidden layout is the row-parallel GEMM and an AllReduce
    without the sequence scatter: the ar op (and its quantized ring)."""
    if op.kind == "rs" and op.scatter_axis == "seq":
        return _rs_core((x,), ws, op.axis, op.mode, op.reverse, op.blocks,
                        op.wire_dtype)
    return _ar_core(x, ws[0], op.axis, op.mode, op.comm_chunks,
                    op.wire_dtype)


# ---------------------------------------------------------------------------
# The backward of ag / rs at tp>1 (the reference's _fused_fwd / _fused_bwd)
# ---------------------------------------------------------------------------
def _epilogue_is_linear(epi: Epilogue) -> bool:
    """True when the epilogue's vjp needs no value (bias, residual only)."""
    return not (epi.activation or epi.gate or epi.scale)


def _contract(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum over the leading dims: a[..., K] x b[..., N] -> [K, N] (the dW
    contraction ``einsum("...sd,...sf->df")``)."""
    return torch.matmul(a.reshape(-1, a.shape[-1]).t(),
                        b.reshape(-1, b.shape[-1]))


def _epilogue_vjp(op: FusedOp, ys_fn: Callable, bias, scale, residual,
                  gouts) -> Tuple[List[torch.Tensor], ...]:
    """(dys, dbias, dscale, dres): the vjp of the op's epilogue at the
    pre-epilogue outputs ``ys_fn()`` (autograd of ``Epilogue.apply``); a
    non-combining op's outputs are its ys.  A linear epilogue (bias,
    residual) needs no ys: its vjp is written out."""
    epi = op.epilogue
    if not op.combines:
        return list(gouts), None, None, None
    g = gouts[0]
    if _epilogue_is_linear(epi):
        dbias = (g.reshape(-1, g.shape[-1]).sum(0).to(bias.dtype)
                 if epi.bias else None)
        dres = g.to(residual.dtype) if epi.residual else None
        return [g], dbias, None, dres
    with torch.enable_grad():
        ys = [y.detach().requires_grad_() for y in ys_fn()]
        ops = {k: None if v is None else v.detach().requires_grad_()
               for k, v in (("bias", bias), ("scale", scale),
                            ("residual", residual))}
        out = epi.apply(ys, **ops)
        wrt = ys + [v for v in ops.values() if v is not None]
        grads = list(torch.autograd.grad(out, wrt, g, allow_unused=True))
    dys = [torch.zeros_like(y) if d is None else d
           for y, d in zip(ys, grads[:len(ys)])]
    rest = iter(grads[len(ys):])
    d = {k: None if v is None else next(rest) for k, v in ops.items()}
    return dys, d["bias"], d["scale"], d["residual"]


class _OpSeam:
    """A FusedOp ag/rs/ar at tp>1 as a seam.  ag saves x (in the
    sequence-sharded layout it re-gathers it in the backward); rs and ar
    save their pre-epilogue z when the epilogue's vjp needs it."""

    def __init__(self, op: FusedOp):
        self.op, self.group = op, op.axis

    def forward(self, x, *rest):
        op = self.op
        ws, (bias, scale, residual) = rest[:op.n_weights], rest[op.n_weights:]
        if op.kind == "ag":
            out = _fused_ag(op, x, ws, bias, scale, residual)
            outs = (out,) if op.combines else tuple(out)
            return outs, (x, ws, None, bias, scale, residual)
        z = _fused_z(op, x, ws)
        out = op.epilogue.apply([z], bias=bias, scale=scale,
                                residual=residual)
        keep = None if _epilogue_is_linear(op.epilogue) else z
        return (out,), (x, ws, keep, bias, scale, residual)

    def backward(self, saved, gouts):
        op = self.op
        x, ws, z, bias, scale, residual = saved
        hidden = op.scatter_axis == "hidden"
        if op.kind == "ag":
            # the dW contractions need the gathered x: the re-gather rides
            # the op's own transport (the replicated layout's x is full)
            xf = x if hidden else _gather_seq_raw(x, op.axis, op.mode,
                                                  op.reverse)
            dys, dbias, dscale, dres = _epilogue_vjp(
                op, lambda: [torch.matmul(xf, w) for w in ws], bias, scale,
                residual, gouts)
            wts = [w.t() for w in ws]
            if hidden:
                # no collective: x's cotangent is this rank's partial of
                # the replicated cotangent (check_rep=False), completed
                # by the psum of the next rs / ar op down the backward
                dx = _rs_partial(dys, wts, 0, x.shape[-2])
            else:
                # dX: the interchanged GEMM-ReduceScatter over the
                # sequence cotangents, ONE collective pass for all weights
                # (flux: one GEMM-RS kernel over the column-stacked
                # cotangents, whatever shared_gather), on the op's ring
                # direction; the transposed op plans its own tile
                dx = _rs_core(dys, wts, op.axis, op.mode, op.reverse)
            dws = [_contract(xf, dy).to(w.dtype) for w, dy in zip(ws, dys)]
            return (dx.to(x.dtype), *dws, dbias, dscale, dres)
        w = ws[0]
        (dz,), dbias, dscale, dres = _epilogue_vjp(
            op, lambda: [z], bias, scale, residual, gouts)
        if hidden:
            # rs in the replicated layout and ar: z is replicated, so its
            # cotangent arrives as a per-rank partial; complete it first
            # (the reference's cotangent_ar psum; summed in fp32 in rank
            # order), then the local GEMMs
            dzf = _psum_raw(dz, op.axis, dz.dtype)
            dy = torch.matmul(dzf, w.t())
            dw = _contract(x, dzf).to(w.dtype)
            return (dy.to(x.dtype), dw, dbias, dscale, dres)
        # dY: the interchanged AllGather-GEMM over the cotangent of this
        # rank's sequence rows (flux: one AG-GEMM kernel) with the op's
        # knobs, its own tile and the fp wire (cotangents never ride a
        # quantized one); dW needs the gathered cotangent too (a second
        # gather, as the reference)
        bwd_op = dataclasses.replace(op, kind="ag", epilogue=Epilogue(),
                                     blocks=None, wire_dtype=None)
        dy = _fused_ag(bwd_op, dz, (w.t(),), None, None, None)
        gf = _gather_seq_raw(dz, op.axis, op.mode, op.reverse)
        dw = _contract(x, gf).to(w.dtype)
        return (dy.to(x.dtype), dw, dbias, dscale, dres)


def _expert_fn(epi: Epilogue, b: torch.Tensor, w1: torch.Tensor,
               w3: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Per-local-expert gated FFN on the dispatch buffer:
    b[..., E_loc, c, D] @ (w1, w3)[E_loc, D, F] -> pair gate ->
    @ w2[E_loc, F, D]."""
    a1 = torch.einsum("...ecd,edf->...ecf", b, w1)
    a3 = torch.einsum("...ecd,edf->...ecf", b, w3)
    h = epi.apply([a1, a3])
    return torch.einsum("...ecf,efd->...ecd", h, w2)


# ---------------------------------------------------------------------------
# kind="a2a": the MoE expert-parallel exchange (dispatch + combine)
# ---------------------------------------------------------------------------
def a2a_exchange(buf: torch.Tensor, group) -> torch.Tensor:
    """Barrier all-to-all of ``buf[EP, ...]`` over the group: block j of
    the result is what rank j addressed to this rank (its ``buf[me]``).
    An involution, so the same call serves dispatch and combine."""
    me = group.rank()
    return torch.stack([p[me] for p in group.exchange(buf, "a2a")])


def _a2a_stages(op: FusedOp, cap: int):
    """The ring's stages, in order: (dst, src, fwd, inv, rows) for each
    shift and each of its ``_sub_chunks`` pieces: at shift sh this rank
    sends its block for rank dst = me + sh along ``fwd`` and receives rank
    src = me - sh's block, ``rows`` of it; ``inv`` is the way back
    (neither for the local shift 0)."""
    group = op.axis
    n, me = group.n, group.rank()
    sub = _sub_chunks(cap, n, op.comm_chunks)
    sub_len = cap // sub
    for s in range(n):
        sh = (n - s) % n if op.reverse else s
        fwd = [(i, (i + sh) % n) for i in range(n)] if sh else None
        inv = [(i, (i - sh) % n) for i in range(n)] if sh else None
        for j in range(sub):
            yield ((me + sh) % n, (me - sh) % n, fwd, inv,
                   slice(j * sub_len, (j + 1) * sub_len))


def _a2a_ring(op: FusedOp, x: torch.Tensor, ws) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """The over-decomposed exchange (the reference's ``_a2a_ring`` over one
    axis): at shift sh this rank sends its block for rank me + sh and
    receives rank me - sh's block for its own experts, one piece at a
    time; each landed piece goes through the local experts and hops back
    on the inverse permutation.  Returns (out, buf): ``out[dst]`` this
    rank's block as rank dst's experts processed it, ``buf[src]`` the
    block rank src sent here, identical to the barrier path's (both
    decoded from the same quantized wire under ``wire_dtype``)."""
    group = op.axis
    wd = op.wire_dtype
    out = torch.zeros_like(x)
    buf = torch.zeros_like(x)
    for dst, src, fwd, inv, rows in _a2a_stages(op, x.shape[2]):
        # on a quantized wire every dispatch piece is encoded, the local
        # one too (the reference's rule); the combine hop stays fp
        payloads = _encode(x[dst:dst + 1, :, rows], wd)
        if fwd:
            payloads = group.ppermute(payloads, fwd, "a2a_ring")
        chunk = _decode(payloads, wd, x.dtype)
        # arrived: rank src's tokens for this rank's experts
        buf[src:src + 1, :, rows] = chunk
        y = _expert_fn(op.epilogue, chunk, *ws)
        if inv:
            y = group.ppermute(y, inv, "a2a_ring")
        # back: this rank's tokens, processed by rank dst's experts
        out[dst:dst + 1, :, rows] = y
    return out, buf


def _a2a_impl(op: FusedOp, x: torch.Tensor, ws) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """(out, received buffer) of the EP exchange at n > 1: ``xla`` runs the
    two barrier exchanges around the batched expert GEMMs, every other
    mode the shift ring."""
    if op.mode == "xla":
        if op.wire_dtype:
            q, sc = wire_encode(x, op.wire_dtype)
            buf = wire_decode((a2a_exchange(q, op.axis),
                               a2a_exchange(sc, op.axis)), op.wire_dtype,
                              x.dtype)
        else:
            buf = a2a_exchange(x, op.axis)
        y = _expert_fn(op.epilogue, buf, *ws)
        return a2a_exchange(y, op.axis).to(x.dtype), buf
    return _a2a_ring(op, x, ws)


def _expert_vjp(epi: Epilogue, b: torch.Tensor, ws, ct: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(db, [dw1, dw3, dw2]): the vjp of ``_expert_fn`` at ``b`` with the
    cotangent ``ct`` (cast to b's dtype, as the reference does)."""
    with torch.enable_grad():
        b = b.detach().requires_grad_()
        wl = [w.detach().requires_grad_() for w in ws]
        y = _expert_fn(epi, b, *wl)
        db, *dws = torch.autograd.grad(y, [b, *wl], ct.to(b.dtype))
    return db, dws


def _a2a_bwd_ring(op: FusedOp, x: torch.Tensor, ws, buf: torch.Tensor,
                  g: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The ring's backward (the reference's ``_a2a_bwd_ring``): at each
    stage the cotangent piece of what rank dst's experts returned hops
    along the dispatch permutation, so that it lands on the rank whose
    experts made it, beside the saved piece of ``buf`` they read; their
    vjp's dX hops back on the inverse permutation.  The experts' grads
    sum over the stages on their own rank.  Under a quantized wire
    (``buf`` None) each stage rebuilds the fp piece it pairs with by the
    exact dispatch hop, as the reference does, so the grads are the fp
    wire's."""
    group = op.axis
    dx = torch.zeros_like(x)
    dws = None
    for dst, src, fwd, inv, rows in _a2a_stages(op, x.shape[2]):
        gc = g[dst:dst + 1, :, rows]
        if fwd:
            gc = group.ppermute(gc, fwd, "a2a_ring")
        if buf is None:
            bc = x[dst:dst + 1, :, rows]
            if fwd:
                bc = group.ppermute(bc, fwd, "a2a_ring")
        else:
            bc = buf[src:src + 1, :, rows]
        db, dw = _expert_vjp(op.epilogue, bc, ws, gc)
        dws = dw if dws is None else [a + d for a, d in zip(dws, dw)]
        if inv:
            db = group.ppermute(db, inv, "a2a_ring")
        dx[dst:dst + 1, :, rows] = db
    return dx, dws


class _A2ASeam:
    """A FusedOp a2a at n>1 as a seam: the forward saves the received
    buffer, the backward runs the reference's ``_a2a_bwd`` (module
    docstring).  Under a quantized wire the saved buffer would be the
    lossy one, so none is kept: the backward rebuilds the fp received
    buffer by an exact exchange of x (``xla``) or per stage
    (``_a2a_bwd_ring``)."""

    def __init__(self, op: FusedOp):
        self.op = op

    def forward(self, x, *ws):
        out, buf = _a2a_impl(self.op, x, ws)
        return (out,), (x, ws, None if self.op.wire_dtype else buf)

    def backward(self, saved, gouts):
        op = self.op
        x, ws, buf = saved
        g = gouts[0]
        if op.mode == "xla":
            if buf is None:
                buf = a2a_exchange(x, op.axis)
            # the combine's transpose, the experts' vjp, the dispatch's
            db, dws = _expert_vjp(op.epilogue, buf, ws,
                                  a2a_exchange(g, op.axis))
            dx = a2a_exchange(db, op.axis)
        else:
            dx, dws = _a2a_bwd_ring(op, x, ws, buf, g)
        return (dx.to(x.dtype), *(d.to(w.dtype) for d, w in zip(dws, ws)))

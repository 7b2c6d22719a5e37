"""Model assembly (port of ``repro.models.model``).

A model is ``num_layers`` blocks of its layer pattern, after its leading
dense layers.  The port holds the weights in ``Model`` (an ``nn.Module``):
the tied ``embed`` table [V_pad, D], ``final_norm`` [D], one ``Block``
per layer in expanded-pattern order, whose ``mixer`` / ``ffn`` parameter
dicts carry the reference's leaf names and packed layouts (nested for the
MoE's ``shared`` expert; a Mamba mixer's ``w_in_x`` / ``w_in_z`` packed
into ``w_in_xz`` with ``fuse_w13``, as the reference's ``fuse_xz``; an
RWKV layer's time-mix as its ``mixer`` and its channel-mix as its
``ffn``), and,
for a config with ``mtp_depth`` (DeepSeek-V3), the
multi-token-prediction head ``mtp``: a block of the
pattern's last mixer kind with a dense FFN, and ``proj`` [2D, D],
replicated.  (The reference stacks a period's layers ``[reps, ...]`` for
``lax.scan``; an eager loop needs no stacking — ``convert.params_from_jax``
unstacks.)  The ported layer kinds are ``PORTED_KINDS``; serving never
reads ``mtp``.

Weights are frozen (``requires_grad=False``) for serving; ``trainable=True``
makes every leaf a trainable ``nn.Parameter``.  ``backbone`` and
``forward_loss`` are the training forward of every ported kind (Mamba's
scan and RWKV's wkv recompute each chunk in their backward,
``mamba.selective_scan``, ``rwkv.wkv``), with
the MoE's aux loss and the MTP loss, in either residual layout
(``TPContext.seq_sharded``) and with or without ``ParallelConfig.remat``;
at tp>1 they run as one rank of the TP group, on that rank's
``shard_params`` copy.

``reference_tree`` / ``named_leaves`` map the port's named leaves to the
reference's tree (periods stacked ``[reps, ...]``) and back, each leaf's
dtype and device kept: the checkpointer's layout and ``convert``'s.

On a mesh (``launch.mesh.make_mesh``) a leaf is split along each of its
dims over the mesh axes ``mesh_specs`` names (the reference's
PartitionSpec on the unstacked leaf): the TP split over "model"; the
routed experts over their EP group ("model", a dedicated "ep" axis, or
``("data", "model")`` under ``ep_over_dp``); and with ``zero3`` each
layer leaf of two or more dims whose dim 0 is free and divisible by dp
(``zero3_flags``) over "data" as well.  ``mesh_shard`` cuts a mesh
rank's copy from the global weights, ``mesh_join`` / ``mesh_cut`` join
the ranks' leaves into the global ones and cut them again.  A ZeRO-3
layer all-gathers its flagged leaves over the data group right before
it runs (``overlap.zero3_gather``, a seam on the rank's ``SeamTape``:
its backward is the summing reduce-scatter, so a flagged leaf's grad is
the sum over the data ranks, dp x the data mean, as the reference's);
the gathered copies' storage is freed once the next layer starts and
gathered again in the backward before the layer's backward reads them
(``overlap.zero3_release``), so between its forward and its backward a
layer holds only its shards (the last layer keeps its copies: its
backward follows at once).  A checkpointed block gathers again when it
is recomputed.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, FrozenSet, List, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import (ATTN, DENSE_FFN, MAMBA, MLA, MOE_FFN,
                                      RWKV, ModelConfig, ParallelConfig)
from repro_torch.core import overlap
from repro_torch.device import resolve_device
from repro_torch.models import attention, ffn, layers, mamba, rwkv
from repro_torch.models import init_utils as iu
from repro_torch.parallel.sharding import TPContext, pad_vocab

# (mixer, ffn) layer kinds the port runs, at any tp
PORTED_KINDS = frozenset({(ATTN, DENSE_FFN), (ATTN, MOE_FFN),
                          (MLA, DENSE_FFN), (MLA, MOE_FFN),
                          (MAMBA, DENSE_FFN), (MAMBA, MOE_FFN),
                          (RWKV, RWKV)})
REMAT_MODES = ("none", "selective", "full")
EMBEDS_NOT_PORTED = ("frontend embeddings (batch['embeds']) are not ported "
                     "(ROADMAP queue 1 item 8)")

# the dim each leaf is split along over the TP ranks (None: replicated) —
# the reference's PartitionSpecs (model.py:83-125), on the port's
# unstacked per-layer leaves.  MLA: the head up-projections column-cut,
# the output row-cut, the latent down-projections and norms replicated.
# Mamba: the in-projections, the conv, w_dt and the per-channel leaves cut
# on their channel dim, w_x and w_out row-cut, the norm replicated.
# RWKV: the time-mix's r / k / v / g and w_dec2 column-cut on their heads,
# dec_base and u_bonus cut on their head dim, w_o row-cut, w_dec1, mu and
# the norms replicated; the channel-mix's w_k column-cut, w_v row-cut,
# mu, the receptance w_r and the norm replicated.
# MoE: the routed experts cut on their expert dim over the EP group (the
# TP ranks), the router and norm replicated, the shared expert cut as a
# dense FFN.
_MIXER_SPECS = {
    ATTN: {"wqkv": 1, "wo": 0, "norm": None, "bqkv": 0},
    MLA: {"w_dq": None, "w_uq": 1, "w_dkv": None, "w_ukv": 1, "w_o": 0,
          "q_norm": None, "kv_norm": None, "norm": None},
    MAMBA: {"w_in_x": 1, "w_in_z": 1, "w_in_xz": 1, "conv": 1, "conv_b": 0,
            "w_x": 0, "w_dt": 1, "dt_bias": 0, "a_log": 0, "d_skip": 0,
            "w_out": 0, "norm": None},
    RWKV: {"mu": None, "w_r": 1, "w_k": 1, "w_v": 1, "w_g": 1,
           "w_dec1": None, "w_dec2": 1, "dec_base": 0, "u_bonus": 0,
           "w_o": 0, "ln_x": None, "norm": None}}
_DENSE_SPECS = {"w1": 1, "w3": 1, "w13": 1, "w2": 0, "norm": None}
_FFN_SPECS = {DENSE_FFN: _DENSE_SPECS,
              MOE_FFN: {"router": None, "w1": 0, "w3": 0, "w2": 0,
                        "norm": None, "shared": _DENSE_SPECS},
              RWKV: {"mu": None, "w_k": 1, "w_v": 0, "w_r": None,
                     "norm": None}}


def expanded_pattern(cfg: ModelConfig) -> List[Tuple[str, str]]:
    """Full per-layer (mixer, ffn) list, honoring leading dense layers."""
    period = len(cfg.pattern)
    reps = cfg.num_layers // period
    if reps * period != cfg.num_layers:
        raise ValueError(f"{cfg.name}: num_layers {cfg.num_layers} not a "
                         f"multiple of pattern period {period}")
    out = [cfg.pattern[i % period] for i in range(cfg.num_layers)]
    for i in range(cfg.leading_dense_layers):
        out[i] = (out[i][0], DENSE_FFN)
    return out


def n_periods(cfg: ModelConfig) -> int:
    return (cfg.num_layers - cfg.leading_dense_layers) // len(cfg.pattern)


def layer_slot(cfg: ModelConfig, j: int) -> int:
    """The reference's layer id of the port's layer ``j`` (the key of a
    ``PlanSet``'s per-layer overrides): a leading layer's own index; a
    layer of the repeated pattern ``leading_dense_layers + position``, the
    same for every repetition (the reference scans the periods, so all
    repetitions of a pattern position share one trace and one plan)."""
    lead = cfg.leading_dense_layers
    return j if j < lead else lead + (j - lead) % len(cfg.pattern)


def check_ported(cfg: ModelConfig) -> None:
    """Raise unless every layer is one of ``PORTED_KINDS``."""
    other = set(expanded_pattern(cfg)) - PORTED_KINDS
    if other:
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {sorted(other)} are not ported (no "
            "reference pattern holds them); the port runs "
            f"{sorted(PORTED_KINDS)}")


def _param_dict(params: Dict) -> nn.ParameterDict:
    return nn.ParameterDict({
        k: _param_dict(v) if isinstance(v, dict)
        else nn.Parameter(v, requires_grad=False)
        for k, v in params.items()})


class Block(nn.Module):
    """One layer: ``mixer`` (GQA: wqkv, wo, norm[, bqkv]; MLA: w_dq, w_uq,
    w_dkv, w_ukv, w_o, q_norm, kv_norm, norm; Mamba: w_in_x, w_in_z |
    w_in_xz, conv, conv_b, w_x, w_dt, dt_bias, a_log, d_skip, w_out, norm)
    and ``ffn`` (dense: w1, w3 | w13, w2, norm; MoE: router, w1, w3, w2,
    norm[, shared]) parameter dicts."""

    def __init__(self, mixer: Dict, ffn_params: Dict):
        super().__init__()
        self.mixer = _param_dict(mixer)
        self.ffn = _param_dict(ffn_params)


class MTPBlock(Block):
    """DeepSeek-V3's multi-token-prediction head: a ``Block`` (the
    pattern's last mixer kind, a dense FFN) and ``proj`` [2D, D], which
    maps the final hidden state joined with the next token's embedding
    into the block."""

    def __init__(self, mixer: Dict, ffn_params: Dict, proj: torch.Tensor):
        super().__init__(mixer, ffn_params)
        self.proj = nn.Parameter(proj, requires_grad=False)


class Model(nn.Module):
    """The weights: ``embed`` [V_pad, D] (tied LM head), ``final_norm``
    [D], ``layers`` (one ``Block`` per layer) and ``mtp`` (an ``MTPBlock``,
    or None); frozen for serving, every leaf trainable with
    ``trainable=True``."""

    def __init__(self, embed: torch.Tensor, final_norm: torch.Tensor,
                 blocks: List[Block], trainable: bool = False,
                 mtp: Optional[MTPBlock] = None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.layers = nn.ModuleList(blocks)
        self.mtp = mtp
        self.requires_grad_(trainable)

    @property
    def trainable(self) -> bool:
        return self.embed.requires_grad


def init_model(cfg: ModelConfig, par: ParallelConfig, seed: int = 0,
               dtype: torch.dtype = torch.bfloat16,
               device: Optional[Union[str, torch.device]] = None,
               trainable: bool = False) -> Model:
    """Seeded random init (``torch.Generator``) with the reference's shapes,
    packing and zero padding: normal(0, 1/sqrt(fan_in)) weights, ones for
    norms, zeros for the QKV bias and for every padded row/column; the MoE
    router is fp32 whatever ``dtype``.  The numbers differ from JAX's for
    the same seed; tests hand the reference's weights across with
    ``convert.params_from_jax``.

    At tp>1 the same canonical weights are drawn (in the same order) and
    packed for tp — per-rank blocks interleaved, heads / d_ff / vocab
    zero-padded to tp multiples — so the model computes the same function
    at every tp (the reference's TP invariance).  The result holds the
    GLOBAL packed weights; ``shard_params`` cuts each rank's copy."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    embed, final_norm, layers_, mtp = _init_leaves(cfg, par, gen, dtype,
                                                   dev)
    return Model(embed, final_norm, [Block(m, f) for m, f in layers_],
                 trainable, None if mtp is None else MTPBlock(*mtp))


def _init_mixer(kind: str, gen: torch.Generator, cfg: ModelConfig, tp: int,
                dtype: torch.dtype, dev: torch.device,
                fuse13: bool = False) -> Dict:
    if kind == MLA:
        return attention.init_mla(gen, cfg, tp, dtype, dev)
    if kind == MAMBA:
        return mamba.init_mamba(gen, cfg, tp, dtype, dev, fuse_xz=fuse13)
    if kind == RWKV:
        return rwkv.init_rwkv_time(gen, cfg, tp, dtype, dev)
    return attention.init_gqa(gen, cfg, tp, dtype, dev)


def _init_leaves(cfg: ModelConfig, par: ParallelConfig,
                 gen: torch.Generator, dtype: torch.dtype,
                 dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor,
                                             List[Tuple[Dict, Dict]],
                                             Optional[Tuple]]:
    """``init_model``'s leaves: (embed, final_norm, [(mixer, ffn)] a
    layer, the MTP head's (mixer, ffn, proj) or None), drawn in that
    order; on the meta device, their shapes alone.  ``proj`` is
    normal(0, 1/sqrt(2D)), as the reference draws it."""
    check_ported(cfg)
    v_pad = pad_vocab(cfg.vocab_size, par.tp)
    embed = iu.zero_pad_rows(
        torch.randn((cfg.vocab_size, cfg.d_model), generator=gen, device=dev)
        * cfg.d_model ** -0.5, v_pad).to(dtype)
    out = []
    for mixer_kind, ffn_kind in expanded_pattern(cfg):
        mixer = _init_mixer(mixer_kind, gen, cfg, par.tp, dtype, dev,
                            par.fuse_w13)
        if ffn_kind == MOE_FFN:
            f = ffn.init_moe(gen, cfg, par.tp, dtype, dev,
                             fuse13=par.fuse_w13)
        elif ffn_kind == RWKV:          # the channel-mix plays the FFN
            f = rwkv.init_rwkv_channel(gen, cfg, par.tp, dtype, dev)
        else:
            f = ffn.init_ffn(gen, cfg.d_model, cfg.d_ff, par.tp, dtype, dev,
                             fuse13=par.fuse_w13)
        out.append((mixer, f))
    mtp = None
    if cfg.mtp_depth:
        d2 = 2 * cfg.d_model
        mtp = (_init_mixer(cfg.pattern[-1][0], gen, cfg, par.tp, dtype, dev,
                           par.fuse_w13),
               ffn.init_ffn(gen, cfg.d_model, cfg.d_ff, par.tp, dtype, dev,
                            fuse13=par.fuse_w13),
               (torch.randn((d2, cfg.d_model), generator=gen, device=dev)
                * d2 ** -0.5).to(dtype))
    return embed, torch.ones(cfg.d_model, dtype=dtype, device=dev), out, mtp


def count_params_analytic(cfg: ModelConfig, active_only: bool = False,
                          par: Optional[ParallelConfig] = None) -> int:
    """Exact parameter count from the shapes ``init_model`` builds, built
    on the meta device (nothing is allocated), padding included (the
    reference's ``count_params_analytic``; ``par`` defaults to tp=1).
    ``active_only`` scales routed-expert weights by top_k / num_experts
    (MODEL_FLOPS = 6 * N_active * D for MoE).  A packed ``w13`` counts as
    its ``w1`` and ``w3``.  DeepSeek-V3's MTP head counts, as the
    reference counts it.  The reference scales every FFN ``w1`` / ``w2``
    / ``w3`` leaf of three or more dims of a config with MoE: its routed
    experts, and also the dense FFNs of the repeated pattern, whose leaves
    it stacks ``[reps, ...]`` (Jamba's); the port counts as it does."""
    par = par or ParallelConfig(tp=1)
    embed, final_norm, layers_, mtp = _meta_leaves(cfg, par.tp, par.fuse_w13)
    total = embed.numel() + final_norm.numel()
    lead = cfg.leading_dense_layers
    blocks = [(m, f, kind == MOE_FFN or (cfg.moe is not None and j >= lead))
              for j, ((m, f), (_, kind)) in enumerate(
                  zip(layers_, expanded_pattern(cfg)))]
    if mtp is not None:
        total += mtp[2].numel()
        blocks.append((mtp[0], mtp[1], False))
    for mixer, f, moe in blocks:
        total += sum(t.numel() for t in mixer.values())
        for name, t in f.items():
            if isinstance(t, dict):            # the MoE's shared expert
                total += sum(v.numel() for v in t.values())
                continue
            n = t.numel()
            # routed experts carry an expert dim
            if active_only and moe and name in ("w1", "w2", "w3"):
                n = int(n * cfg.moe.top_k / cfg.moe.num_experts)
            total += n
    return total


def param_specs(cfg: ModelConfig, params: Model) -> Dict:
    """The dim each weight is split along over the TP ranks (None:
    replicated), in ``params``' structure: ``{"embed": 0, "final_norm":
    None, "layers": [{"mixer": {...}, "ffn": {...}}, ...], "mtp": {"mixer",
    "ffn", "proj"} or None}`` (the reference's ``param_specs``; the
    vocab-parallel embedding is split on its rows; the MTP head's block is
    split as a layer of its kinds is, its ``proj`` replicated)."""
    check_ported(cfg)

    def pick(table, leaves):
        return {n: pick(table[n], v) if isinstance(v, nn.ParameterDict)
                else table[n] for n, v in leaves.items()}

    def block(kinds, blk):
        return {"mixer": pick(_MIXER_SPECS[kinds[0]], blk.mixer),
                "ffn": pick(_FFN_SPECS[kinds[1]], blk.ffn)}
    layers = [block(kinds, blk)
              for kinds, blk in zip(expanded_pattern(cfg), params.layers)]
    mtp = None
    if params.mtp is not None:
        mtp = dict(block(mtp_kinds(cfg), params.mtp), proj=None)
    return {"embed": 0, "final_norm": None, "layers": layers, "mtp": mtp}


def mtp_kinds(cfg: ModelConfig) -> Tuple[str, str]:
    """The MTP head's (mixer, ffn) kinds: the pattern's last mixer and a
    dense FFN, as the reference builds it."""
    return cfg.pattern[-1][0], DENSE_FFN


def _cut(t: torch.Tensor, dim: Optional[int], rank: int,
         tp: int) -> torch.Tensor:
    if dim is None:
        # a copy a rank: each rank's replicated leaf gets its own grad and
        # its own update
        return t.detach().clone()
    if t.shape[dim] % tp:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} is not divisible "
                         f"by tp={tp}")
    # a copy of its own: a view would keep the global tensor alive
    return t.detach().chunk(tp, dim)[rank].clone(
        memory_format=torch.contiguous_format)


def shard_params(params: Model, rank: int, tp: int,
                 cfg: ModelConfig) -> Model:
    """Rank ``rank``'s copy of the global packed weights (``init_model`` at
    this tp, or ``convert.params_from_jax`` of the reference's tp params):
    each leaf's contiguous 1/tp block along its ``param_specs`` dim, and a
    copy of each replicated leaf; trainable as ``params`` is."""
    specs = param_specs(cfg, params)

    def cut(leaves, spec):
        return {n: cut(t, spec[n]) if isinstance(t, nn.ParameterDict)
                else _cut(t, spec[n], rank, tp) for n, t in leaves.items()}
    blocks = [Block(cut(blk.mixer, sp["mixer"]), cut(blk.ffn, sp["ffn"]))
              for blk, sp in zip(params.layers, specs["layers"])]
    mtp = None
    if params.mtp is not None:
        sp = specs["mtp"]
        mtp = MTPBlock(cut(params.mtp.mixer, sp["mixer"]),
                       cut(params.mtp.ffn, sp["ffn"]),
                       _cut(params.mtp.proj, sp["proj"], rank, tp))
    return Model(_cut(params.embed, specs["embed"], rank, tp),
                 _cut(params.final_norm, None, rank, tp), blocks,
                 params.trainable, mtp)


def _leaf_dims(cfg: ModelConfig, params: Model) -> Dict[str, Optional[int]]:
    """``param_specs`` keyed as ``named_parameters()``."""
    specs = param_specs(cfg, params)
    out = {"embed": specs["embed"], "final_norm": specs["final_norm"]}
    for i, sp in enumerate(specs["layers"]):
        for part in ("mixer", "ffn"):
            out.update(_flat_names(sp[part], f"layers.{i}.{part}."))
    if specs["mtp"] is not None:
        out.update(_flat_names(specs["mtp"], "mtp."))
    return out


def replicated_leaves(cfg: ModelConfig, params: Model,
                      par: Optional[ParallelConfig] = None
                      ) -> Dict[str, bool]:
    """``{name: True}`` for each model-replicated leaf (``param_specs`` dim
    None; with ``par``, no "model" in its ``mesh_specs``: under a
    dedicated ep axis the routed experts too), keyed as
    ``params.named_parameters()``: the leaves whose grads the trainer
    sums over the TP ranks and whose squared sums the grad norm weighs by
    1/tp."""
    if par is not None:
        return {n: "model" not in spec_axes(sp)
                for n, sp in mesh_specs(cfg, par).items()}
    return {n: dim is None for n, dim in _leaf_dims(cfg, params).items()}


# ---------------------------------------------------------------------------
# The mesh layout: the reference's PartitionSpecs, leaf by leaf
# ---------------------------------------------------------------------------
def ep_axes(cfg: ModelConfig, par: ParallelConfig) -> Tuple[str, ...]:
    """The mesh axes the routed experts split over (the reference's
    ``_ep_axes``): a dedicated "ep" axis, ("data", "model") under
    ``ep_over_dp``, else "model"; () without MoE."""
    if cfg.moe is None:
        return ()
    if par.ep > 1:
        return ("ep",)
    return ("data", "model") if par.ep_over_dp else ("model",)


def spec_axes(spec: Tuple) -> FrozenSet[str]:
    """Every mesh axis a leaf's spec names."""
    return frozenset(a for axes in spec if axes for a in axes)


def _zero3_leaf_flag(spec: Tuple, shape: Tuple[int, ...], dp: int) -> bool:
    """True when a layer leaf is ZeRO-3 dim0-sharded over "data" (the
    reference's rule): two or more dims, dim 0 free in its spec and
    divisible by dp."""
    if len(shape) < 2 or shape[0] % max(dp, 1) or shape[0] < dp:
        return False
    return spec[0] is None


def _is_expert(cfg: ModelConfig, name: str) -> bool:
    """A routed expert's leaf (w1, w3, w2 of an MoE layer, not shared)."""
    parts = name.split(".")
    return (parts[0] == "layers" and parts[2] == "ffn" and len(parts) == 4
            and parts[3] in ("w1", "w3", "w2")
            and expanded_pattern(cfg)[int(parts[1])][1] == MOE_FFN)


@functools.lru_cache(maxsize=16)
def _meta_leaves(cfg: ModelConfig, tp: int, fuse_w13: bool):
    """``_init_leaves`` on the meta device (shapes only; they depend on
    ``par.tp`` and ``par.fuse_w13`` alone)."""
    return _init_leaves(cfg, ParallelConfig(tp=tp, fuse_w13=fuse_w13),
                        torch.Generator(), torch.bfloat16,
                        torch.device("meta"))


def meta_model(cfg: ModelConfig, par: ParallelConfig) -> Model:
    """``init_model``'s global weights at ``par`` on the meta device: their
    shapes and dtypes, nothing allocated."""
    embed, final_norm, layers_, mtp = _meta_leaves(cfg, par.tp, par.fuse_w13)
    return Model(embed, final_norm, [Block(m, f) for m, f in layers_],
                 False, None if mtp is None else MTPBlock(*mtp))


@functools.lru_cache(maxsize=64)
def _mesh_specs(cfg: ModelConfig, tp: int, dp: int, ep: int,
                ep_over_dp: bool, zero3: bool, fuse_w13: bool
                ) -> Tuple[Tuple[str, Tuple], ...]:
    par = ParallelConfig(tp=tp, dp=dp, ep=ep, ep_over_dp=ep_over_dp,
                         zero3=zero3, fuse_w13=fuse_w13)
    like = meta_model(cfg, par)
    dims = _leaf_dims(cfg, like)
    eaxes = ep_axes(cfg, par)
    out = []
    for n, t in like.named_parameters():
        spec = [None] * t.dim()
        if _is_expert(cfg, n):
            spec[0] = eaxes
        elif dims[n] is not None:
            spec[dims[n]] = ("model",)
        if (zero3 and n.startswith("layers.")
                and _zero3_leaf_flag(tuple(spec), tuple(t.shape), dp)):
            spec[0] = ("data",)
        out.append((n, tuple(spec)))
    return tuple(out)


def mesh_specs(cfg: ModelConfig, par: ParallelConfig) -> Dict[str, Tuple]:
    """Each leaf's spec, keyed as ``named_parameters()``: one entry a dim,
    None (whole) or the tuple of mesh axes the dim is split over,
    axis-major (the reference's PartitionSpec on the unstacked leaf; the
    module docstring)."""
    return dict(_mesh_specs(cfg, par.tp, par.dp, par.ep, par.ep_over_dp,
                            par.zero3, par.fuse_w13))


def zero3_leaves(cfg: ModelConfig, par: ParallelConfig) -> FrozenSet[str]:
    """The names of the ZeRO-3 leaves (split over "data"); empty without
    ``zero3``."""
    return frozenset(n for n, sp in mesh_specs(cfg, par).items()
                     if "data" in (sp[0] or ()) and not _is_expert(cfg, n))


def _nest(named: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """The leaves under ``prefix`` as a nested dict (the inverse of
    ``_flat_names``)."""
    out: Dict[str, Any] = {}
    for key, t in named.items():
        if not key.startswith(prefix):
            continue
        parts = key[len(prefix):].split(".")
        node = out
        for q in parts[:-1]:
            node = node.setdefault(q, {})
        node[parts[-1]] = t
    return out


def zero3_flags(cfg: ModelConfig, par: ParallelConfig) -> Dict[str, Any]:
    """The reference's ``zero3_flags``: ``{"lead": [a bool tree a leading
    layer], "periods": [a bool tree a pattern position]}`` marking the
    ZeRO-3 leaves, both None without ``zero3``."""
    if not par.zero3:
        return {"lead": None, "periods": None}
    z3 = zero3_leaves(cfg, par)
    flags = {n: n in z3 for n in mesh_specs(cfg, par)}
    lead = cfg.leading_dense_layers

    def layer(i):
        return {part: _nest(flags, f"layers.{i}.{part}.")
                for part in ("mixer", "ffn")}
    return {"lead": [layer(i) for i in range(lead)],
            "periods": [layer(lead + pos) for pos in range(len(cfg.pattern))]}


def mesh_sizes(par: ParallelConfig) -> Dict[str, int]:
    """The size of each mesh axis a spec may name."""
    return {"pod": par.pods, "ep": par.ep, "data": par.dp, "model": par.tp}


def _piece(axes: Optional[Tuple], coords: Dict[str, int],
           sizes: Dict[str, int]) -> Tuple[int, int]:
    """(index, count) of a rank's piece of a dim split over ``axes``,
    axis-major."""
    idx, n = 0, 1
    for a in axes or ():
        idx = idx * sizes[a] + coords.get(a, 0)
        n *= sizes[a]
    return idx, n


def mesh_cut(named: Dict[str, torch.Tensor], cfg: ModelConfig,
             par: ParallelConfig, coords: Dict[str, int]
             ) -> Dict[str, torch.Tensor]:
    """A mesh rank's pieces (views) of the global leaves ``named``: each
    dim split over its ``mesh_specs`` axes, the rank's block taken
    (``coords``: the rank's index on each mesh axis, 0 where absent)."""
    specs, sizes = mesh_specs(cfg, par), mesh_sizes(par)
    out = {}
    for n, t in named.items():
        for d, axes in enumerate(specs[n]):
            idx, k = _piece(axes, coords, sizes)
            if k > 1:
                if t.shape[d] % k:
                    raise ValueError(f"{n}: dim {d} of {tuple(t.shape)} "
                                     f"does not split over {axes} ({k})")
                t = t.chunk(k, d)[idx]
        out[n] = t
    return out


def mesh_join(per_rank: List[Dict[str, torch.Tensor]],
              coords: List[Dict[str, int]], cfg: ModelConfig,
              par: ParallelConfig) -> Dict[str, torch.Tensor]:
    """The inverse of ``mesh_cut``: the mesh ranks' leaves (``coords[r]``
    rank r's coordinates) joined into the global ones; a leaf whole on
    every rank is the first rank's."""
    specs, sizes = mesh_specs(cfg, par), mesh_sizes(par)
    out = {}
    for n in per_rank[0]:
        first = per_rank[0][n]
        pieces = [_piece(axes, coords[0], sizes)[1] for axes in specs[n]]
        if all(k == 1 for k in pieces):
            out[n] = first
            continue
        full = first.new_empty([s * k for s, k in zip(first.shape, pieces)])
        seen = set()
        for leaves, c in zip(per_rank, coords):
            at = tuple(_piece(axes, c, sizes)[0] for axes in specs[n])
            if at in seen:
                continue
            seen.add(at)
            full[tuple(slice(i * s, (i + 1) * s)
                       for i, s in zip(at, first.shape))] = leaves[n]
        out[n] = full
    return out


def rebuild(like: Model, named: Dict[str, torch.Tensor]) -> Model:
    """A ``Model`` of ``like``'s structure holding ``named``'s leaves,
    trainable as ``like`` is."""
    blocks = [Block(_nest(named, f"layers.{i}.mixer."),
                    _nest(named, f"layers.{i}.ffn."))
              for i in range(len(like.layers))]
    mtp = None
    if like.mtp is not None:
        mtp = MTPBlock(_nest(named, "mtp.mixer."), _nest(named, "mtp.ffn."),
                       named["mtp.proj"])
    return Model(named["embed"], named["final_norm"], blocks, like.trainable,
                 mtp)


def mesh_shard(params: Model, cfg: ModelConfig, par: ParallelConfig,
               coords: Dict[str, int]) -> Model:
    """A mesh rank's copy of the global weights (``init_model`` at this
    tp): its pieces of every leaf (``mesh_cut``), each a copy of its own;
    trainable as ``params`` is.  At dp=1 without ``zero3`` or an ep axis
    it is ``shard_params``' copy of TP rank ``coords["model"]``."""
    named = mesh_cut({n: t.detach() for n, t in params.named_parameters()},
                     cfg, par, coords)
    return rebuild(params, {n: t.clone(memory_format=torch.contiguous_format)
                            for n, t in named.items()})


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------
def check_forward(cfg: ModelConfig, par: ParallelConfig) -> None:
    """Raise unless ``backbone`` / ``forward_loss`` run the model: ported
    layer kinds (``check_ported``) and a ``remat`` of ``REMAT_MODES``."""
    check_ported(cfg)
    if par.remat not in REMAT_MODES:
        raise ValueError(f"invalid remat {par.remat!r}; one of "
                         f"{REMAT_MODES}")


def check_trainable(cfg: ModelConfig, par: ParallelConfig) -> None:
    """Raise unless the model trains in the port: every kind it runs
    trains (Mamba's and RWKV's through the scans whose backward
    recomputes each chunk), so this is ``check_forward``."""
    check_forward(cfg, par)


class _Zero3:
    """A layer's ZeRO-3 weights: ``gather`` all-gathers its flagged
    leaves (``names``, relative to the layer: "mixer.wqkv", "ffn.shared.w1")
    over the data group (on the rank's tape under grad) and returns the
    layer's leaves with the gathered ones in their place; ``release``
    frees the copies the last gather made: in training the last recorded
    one's, through ``overlap.zero3_release``, which records their refill
    for the backward; with ``serve`` (the serve steps, off the tape) the
    last one's, through ``overlap.zero3_free``."""

    def __init__(self, names: FrozenSet[str], group, serve: bool = False):
        self.names, self.group, self.serve = names, group, serve
        self.held = None

    def gather(self, blk: Block) -> Tuple[Dict, Dict]:
        named = {f"{part}.{n}": t for part in ("mixer", "ffn")
                 for n, t in getattr(blk, part).named_parameters()}
        keys = [k for k in named if k in self.names]
        shards = [named[k] for k in keys]
        full = overlap.zero3_gather(shards, self.group)
        if self.serve:
            # a group of one rank hands back the shards themselves
            if full and full[0] is not shards[0]:
                self.held = (full, None)
        elif full and full[0].requires_grad and not overlap.recomputing():
            self.held = (full, shards)
        named.update(zip(keys, full))
        return _nest(named, "mixer."), _nest(named, "ffn.")

    def release(self) -> None:
        if self.held is None:
            return
        full, shards = self.held
        if shards is None:
            overlap.zero3_free(full)
        else:
            overlap.zero3_release(full, shards, self.group)
        self.held = None


def _block(blk: Block, x: torch.Tensor, ctx: TPContext, cfg: ModelConfig,
           kinds: Tuple[str, str], z3: Optional[_Zero3] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer of ``kinds`` (mixer, ffn): the pre-norm mixer (GQA, MLA or
    Mamba or the RWKV time-mix), then the pre-norm FFN (dense, MoE or the
    RWKV channel-mix), each added to the
    residual stream, which is cut on the seam tape before each sub-block
    (``overlap.cut``), so the backward walks each segment once.  With
    ``z3`` the layer's ZeRO-3 leaves are gathered first.  Returns (x, the
    layer's aux loss: the MoE's, else 0)."""
    mixer_kind, ffn_kind = kinds
    mixer = {MLA: attention.mla_train, MAMBA: mamba.mamba_train,
             RWKV: rwkv.rwkv_time_train}.get(mixer_kind, attention.gqa_train)
    x = overlap.cut(x, ctx.tape_axis)
    mixer_p, ffn_p = (blk.mixer, blk.ffn) if z3 is None else z3.gather(blk)
    x = x + mixer(mixer_p, x, ctx, cfg)
    x = overlap.cut(x, ctx.tape_axis)
    if ffn_kind == MOE_FFN:
        y, aux = ffn.moe_train(ffn_p, x, ctx, cfg, cfg.norm_eps)
    else:
        y = (rwkv.rwkv_channel_train(ffn_p, x, ctx, cfg) if ffn_kind == RWKV
             else ffn.ffn_train(ffn_p, x, ctx, cfg.norm_eps))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, aux


def _zero3_of(cfg: ModelConfig, par: ParallelConfig, ctx: TPContext,
              i: int, serve: bool = False) -> Optional[_Zero3]:
    """Layer i's ``_Zero3`` over the context's data group (None without
    ZeRO-3 leaves in it)."""
    prefix = f"layers.{i}."
    names = frozenset(n[len(prefix):] for n in zero3_leaves(cfg, par)
                      if n.startswith(prefix))
    return _Zero3(names, ctx.data_group, serve) if names else None


def zero3_layers(cfg: ModelConfig, ctx: TPContext
                 ) -> List[Optional[_Zero3]]:
    """Each layer's ``_Zero3`` for the serve steps, from the context's
    ``zero3`` config (all None without one): a serve step gathers a
    layer's ZeRO-3 leaves right before the layer runs and frees the
    copies right after, so at most one layer's gathered weights are
    live."""
    if ctx.zero3 is None:
        return [None] * cfg.num_layers
    return [_zero3_of(cfg, ctx.zero3, ctx, i, serve=True)
            for i in range(cfg.num_layers)]


def backbone(params: Model, x: torch.Tensor, ctx: TPContext,
             cfg: ModelConfig, par: ParallelConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S/TP, D] -> (hidden [B, S/TP, D], the layers' aux losses
    summed) (the replicated layout: [B, S, D] -> [B, S, D]), one
    ``_block`` a layer (the reference's ``backbone``).  With
    ``par.remat`` other than "none" every block after the leading dense
    layers is checkpointed (``overlap.remat``), its aux loss carried out
    beside its output, as the reference checkpoints its scanned
    blocks.  With ``par.zero3`` each layer gathers its ZeRO-3 leaves over
    the data group (``_Zero3``); once the next layer's input is cut on
    the tape, the previous layer's gathered copies are released (module
    docstring)."""
    check_forward(cfg, par)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    prev = None
    for i, (blk, kinds) in enumerate(zip(params.layers,
                                         expanded_pattern(cfg))):
        # per-layer plan overrides resolve here
        lctx = ctx.with_layer(layer_slot(cfg, i))
        z3 = _zero3_of(cfg, par, ctx, i) if par.zero3 else None
        if prev is not None:
            # the previous layer's tail reads its weights until this cut
            x = overlap.cut(x, ctx.tape_axis)
            prev.release()
        if par.remat == "none" or i < cfg.leading_dense_layers:
            x, aux = _block(blk, x, lctx, cfg, kinds, z3)
            prev = z3
        else:
            x, aux = overlap.remat(
                lambda v, b=blk, c=lctx, k=kinds, z=z3: _block(
                    b, v, c, cfg, k, z),
                x, ctx.tape_axis, list(blk.parameters()))
            prev = None
        aux_total = aux_total + aux
    return x, aux_total


def _masked_mean(ce: torch.Tensor, labels: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Mean of ``ce`` over the labels in [0, vocab)."""
    mask = (labels >= 0) & (labels < cfg.vocab_size)
    return (torch.where(mask, ce, torch.zeros_like(ce)).sum()
            / torch.clamp(mask.sum(), min=1))


def forward_loss(params: Model, batch: Dict[str, torch.Tensor],
                 ctx: TPContext, cfg: ModelConfig,
                 par: ParallelConfig) -> torch.Tensor:
    """Training loss: the mean cross-entropy over the labels in
    [0, vocab), plus 0.3 x the MTP loss (``_mtp_loss``) when the model
    has its MTP head, plus 0.01 x the MoE layers' aux loss for an MoE
    config, as the reference's.  batch: tokens [B, S] and labels [B, S],
    both full sequence and the same on every rank; the embedding's
    combine produces the residual layout (a reduce-scatter to the
    sequence-sharded layout, a psum to the replicated one), the LM head's
    ``head_ag`` seam the vocab-sharded logits.  At tp>1 every rank
    returns the same loss (its own replicated copy, as in the
    reference)."""
    check_forward(cfg, par)
    if "embeds" in batch:
        raise NotImplementedError(EMBEDS_NOT_PORTED)
    v_pad = pad_vocab(cfg.vocab_size, ctx.tp)
    x = layers.embed_lookup(params.embed, batch["tokens"], ctx)
    x = x.to(getattr(torch, cfg.compute_dtype))
    h, aux = backbone(params, x, ctx, cfg, par)
    h = layers.rms_norm(h, params.final_norm, cfg.norm_eps)
    mtp = cfg.mtp_depth and params.mtp is not None
    if mtp:
        # the final hidden state feeds both heads
        h = overlap.cut(h, ctx.tape_axis)
    logits = layers.lm_head_logits(h, params.embed, ctx)      # [B, S, V/TP]
    labels = batch["labels"]
    loss = _masked_mean(layers.vocab_parallel_xent(
        logits, labels, ctx, v_pad, cfg.vocab_size), labels, cfg)
    if mtp:
        loss = loss + 0.3 * _mtp_loss(params, h, batch, ctx, cfg, v_pad)
    if cfg.moe is not None:
        loss = loss + 0.01 * aux
    return loss


def _mtp_loss(params: Model, h: torch.Tensor,
              batch: Dict[str, torch.Tensor], ctx: TPContext,
              cfg: ModelConfig, v_pad: int) -> torch.Tensor:
    """DeepSeek's multi-token prediction (the reference's ``_mtp_loss``):
    the MTP block predicts token t+2 from the final hidden state ``h``
    joined with the embedding of token t+1, through ``proj``; its logits
    come off the tied head, its labels are the batch's shifted once
    more."""
    mtp = params.mtp
    nxt = layers.embed_lookup(params.embed, batch["tokens"], ctx)
    nxt = layers.shift_tokens_left(nxt.to(h.dtype), ctx)       # emb of t+1
    x = torch.matmul(torch.cat([h, nxt], dim=-1), mtp.proj)
    x, _ = _block(mtp, x, ctx.with_layer(None), cfg, mtp_kinds(cfg))
    logits = layers.lm_head_logits(x, params.embed, ctx)
    labels = batch["labels"]
    lab2 = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], -1)],
                     dim=1)
    return _masked_mean(layers.vocab_parallel_xent(
        logits, lab2, ctx, v_pad, cfg.vocab_size), lab2, cfg)


# ---------------------------------------------------------------------------
# Across tp degrees: the ranks' leaves, the canonical (tp=1) layout
# ---------------------------------------------------------------------------
def gather_rank_leaves(per_rank: List[Dict[str, torch.Tensor]],
                       cfg: ModelConfig, params: Model
                       ) -> Dict[str, torch.Tensor]:
    """The ranks' leaves (weights or grads, keyed as ``named_parameters``)
    -> the global tp-packed leaves: sharded leaves concatenated along their
    ``param_specs`` dim, replicated ones rank 0's."""
    dims = _leaf_dims(cfg, params)
    return {n: per_rank[0][n] if dims[n] is None
            else torch.cat([r[n] for r in per_rank], dim=dims[n])
            for n in per_rank[0]}


# ---------------------------------------------------------------------------
# The reference's tree
# ---------------------------------------------------------------------------
def _unstack(tree, rep: int):
    """Layer ``rep`` of a stacked (``[reps, ...]``) nested subtree."""
    if isinstance(tree, dict):
        return {n: _unstack(a, rep) for n, a in tree.items()}
    return tree[rep]


def layer_trees(tree: Dict[str, Any], cfg: ModelConfig) -> List[Dict]:
    """The reference's per-layer subtrees (``lead``, then ``periods``
    unstacked) in expanded-pattern order."""
    lead = cfg.leading_dense_layers
    period = len(cfg.pattern)
    out = list(tree.get("lead", []))[:lead]
    for rep in range(n_periods(cfg)):
        for pos in range(period):
            out.append(_unstack(tree["periods"][pos], rep))
    return out


def _flat_names(tree: Dict, prefix: str) -> Dict[str, Any]:
    out = {}
    for n, a in tree.items():
        if isinstance(a, dict):
            out.update(_flat_names(a, f"{prefix}{n}."))
        else:
            out[prefix + n] = a
    return out


def named_leaves(tree: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The reference's tree -> leaves keyed as ``named_parameters()``
    ("embed", "final_norm", "layers.<i>.<mixer|ffn>.<name>[.<name>]",
    "mtp.<mixer|ffn>.<name>", "mtp.proj"); a period's layers are views of
    its stacked leaves."""
    out = {"embed": tree["embed"], "final_norm": tree["final_norm"]}
    for i, layer in enumerate(layer_trees(tree, cfg)):
        for part in ("mixer", "ffn"):
            out.update(_flat_names(layer[part], f"layers.{i}.{part}."))
    if "mtp" in tree:
        out.update(_flat_names(tree["mtp"], "mtp."))
    return out


def stacked_leaves(cfg: ModelConfig, named) -> Dict[str, Tuple[str, int,
                                                               int]]:
    """For each leaf (of ``named``'s keys, as ``named_parameters()``) of a
    repeated-pattern layer: (the key of the reference's stacked leaf it is
    a layer of, "periods.<position>.<mixer|ffn>.<name>", its repetition,
    the repetitions): the reference splits those leaves over its data
    ranks along the stacked dim (``optim.adamw.zero1_plan``)."""
    lead, period, reps = (cfg.leading_dense_layers, len(cfg.pattern),
                          n_periods(cfg))
    out = {}
    for key in named:
        parts = key.split(".")
        if parts[0] != "layers" or int(parts[1]) < lead:
            continue
        rep, pos = divmod(int(parts[1]) - lead, period)
        out[key] = (".".join(["periods", str(pos), *parts[2:]]), rep, reps)
    return out


def reference_tree(named: Dict[str, torch.Tensor],
                   cfg: ModelConfig) -> Dict[str, Any]:
    """Leaves keyed as ``named_parameters()`` (weights, grads or moments)
    -> the reference's tree: ``lead`` layers as a list, the periods'
    leaves stacked ``[reps, ...]`` per pattern position, ``mtp`` when the
    leaves hold it; each leaf keeps its dtype and device."""
    layers: Dict[int, Dict[str, Any]] = {}
    mtp: Dict[str, Any] = {}
    for key, t in named.items():
        parts = key.split(".")
        if parts[0] == "layers":
            node = layers.setdefault(int(parts[1]), {"mixer": {}, "ffn": {}})
            parts = parts[2:]
        elif parts[0] == "mtp":
            node = mtp
            parts = parts[1:]
        else:
            continue
        for q in parts[:-1]:
            node = node.setdefault(q, {})
        node[parts[-1]] = t
    lead, period = cfg.leading_dense_layers, len(cfg.pattern)

    def stack(trees):
        if isinstance(trees[0], dict):
            return {n: stack([t[n] for t in trees]) for n in trees[0]}
        return torch.stack(trees)

    tree = {"embed": named["embed"], "final_norm": named["final_norm"],
            "lead": [layers[i] for i in range(lead)],
            "periods": [stack([layers[lead + rep * period + pos]
                               for rep in range(n_periods(cfg))])
                        for pos in range(period)]}
    if mtp:
        tree["mtp"] = mtp
    return tree


def _blocks(w: torch.Tensor, tp: int, widths: List[int]) -> List:
    """Split w's columns into tp device blocks of ``widths`` each ->
    [[block_0 of dev 0, ...], ...] regrouped per width: the inverse of
    ``init_utils.pack_qkv`` / ``pack_pair``."""
    step = sum(widths)
    out = []
    for j, wd in enumerate(widths):
        off = sum(widths[:j])
        out.append(torch.cat([w[..., i * step + off:i * step + off + wd]
                              for i in range(tp)], dim=-1))
    return out


def _kv_canonical(k: torch.Tensor, n_kv: int, dh: int, tp: int,
                  pad: int, grads: bool) -> torch.Tensor:
    """[..., pad*dh] padded/replicated kv heads -> [..., n_kv*dh]; a
    replicated head is its first replica (weights) or the sum over its
    replicas (grads: the grad of the canonical head)."""
    if pad == n_kv:
        return k
    lead = k.shape[:-1]
    k = k.reshape(*lead, pad, dh)
    if n_kv < tp and not grads:
        k = k[..., torch.arange(n_kv, device=k.device) * pad // n_kv, :]
    elif n_kv < tp:
        idx = torch.arange(pad, device=k.device) * n_kv // pad
        out = torch.zeros((*lead, n_kv, dh), dtype=k.dtype, device=k.device)
        out.index_add_(len(lead), idx, k)
        k = out
    else:
        k = k[..., :n_kv, :]
    return k.reshape(*lead, n_kv * dh)


def canonical_leaves(named: Dict[str, torch.Tensor], cfg: ModelConfig,
                     tp: int, grads: bool = False) -> Dict[str, torch.Tensor]:
    """Global tp-packed (weights or grads) -> the canonical layout that is
    the same at every tp: vocab, heads and d_ff padding cut off, the QKV
    columns and w1|w3 unpacked (``w13`` -> ``w1`` and ``w3``), a replicated
    KV head taken once (``grads``: summed over its replicas); MLA's padded
    heads cut off; routed experts as they are (their width is not padded),
    the shared expert cut to its width; a Mamba mixer's padded channels
    cut off and ``w_in_xz`` unpacked (-> ``w_in_x`` and ``w_in_z``); an
    RWKV time-mix's padded heads and channel-mix's padded d_ff cut off.
    Two tp degrees of one model compare leaf by leaf in this layout."""
    d = attention.AttnDims.of(cfg, tp)
    dh = d.dh
    kinds = expanded_pattern(cfg)
    out = {}
    for n, t in named.items():
        leaf = n.split(".")[-1]
        base = n[:len(n) - len(leaf)]
        width = cfg.d_ff               # a dense FFN's (the MTP head's too)
        if n.startswith("layers."):
            mixer_kind, ffn_kind = kinds[int(n.split(".")[1])]
            part = n.split(".")[2]
            if mixer_kind == RWKV:
                # an RWKV leaf's sharded dim is its head (time-mix) or
                # hidden (channel-mix) dim, zero-padded past the canonical
                # width; the replicated leaves carry no padding
                dim = (_MIXER_SPECS if part == "mixer"
                       else _FFN_SPECS)[RWKV][leaf]
                out[n] = t if dim is None else t.narrow(dim, 0, (
                    cfg.d_model // cfg.rwkv.head_dim * cfg.rwkv.head_dim
                    if part == "mixer" else cfg.d_ff))
                continue
            if ".ffn.shared." in n:
                mc = cfg.moe
                width = mc.shared_ffn * mc.num_shared_experts
            elif ".ffn." in n and ffn_kind == MOE_FFN:
                out[n] = t
                continue
        if n == "embed":
            out[n] = t[:cfg.vocab_size]
        elif leaf in ("wqkv", "bqkv"):
            q, k, v = _blocks(t, tp, [d.h_pad // tp * dh,
                                      d.hkv_pad // tp * dh,
                                      d.hkv_pad // tp * dh])
            out[n] = torch.cat(
                [q[..., :cfg.num_heads * dh],
                 _kv_canonical(k, cfg.num_kv_heads, dh, tp, d.hkv_pad, grads),
                 _kv_canonical(v, cfg.num_kv_heads, dh, tp, d.hkv_pad,
                               grads)],
                dim=-1)
        elif leaf == "wo":
            out[n] = t[:cfg.num_heads * dh]
        elif leaf in ("w_uq", "w_ukv", "w_o"):
            m = cfg.mla
            per_head = {"w_uq": m.qk_nope_head_dim + m.qk_rope_head_dim,
                        "w_ukv": m.qk_nope_head_dim + m.v_head_dim,
                        "w_o": m.v_head_dim}[leaf] * cfg.num_heads
            out[n] = t[:per_head] if leaf == "w_o" else t[..., :per_head]
        elif _MIXER_SPECS[MAMBA].get(leaf) is not None:
            # the sharded dim of a Mamba leaf is its channel dim, padded to
            # tp * 128 channels
            c = cfg.mamba.expand * cfg.d_model
            if leaf == "w_in_xz":
                wx, wz = _blocks(t, tp, [t.shape[-1] // (2 * tp)] * 2)
                out[base + "w_in_x"] = wx[..., :c]
                out[base + "w_in_z"] = wz[..., :c]
            else:
                out[n] = t.narrow(_MIXER_SPECS[MAMBA][leaf], 0, c)
        elif leaf == "w13":
            w1, w3 = _blocks(t, tp, [t.shape[-1] // (2 * tp)] * 2)
            out[base + "w1"] = w1[..., :width]
            out[base + "w3"] = w3[..., :width]
        elif leaf in ("w1", "w3"):
            out[n] = t[..., :width]
        elif leaf == "w2":
            out[n] = t[:width]
        else:
            out[n] = t
    return out

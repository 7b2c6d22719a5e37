"""Llama-4 Scout (llama4_scout_17b_a16e) in the port against the reference.

* The config: CONFIG and SMOKE_CONFIG equal the reference's field for
  field, the reference's fields the port lacks at their defaults (no
  frontend, no chunked attention, no NoPE layers).
* ``count_params_analytic`` (and ``active_only=True``) equals the
  reference's, full size and smoke, at tp=1 and with tp=4's padding:
  exact integers (the full size on the meta device).
* On SMOKE_CONFIG (GQA attention and a routed MoE FFN, 4 experts top-1,
  one shared expert) in fp32 compute with the reference's fp32 weights
  (one subprocess for the file, 4 forced host devices, ``shard_map``):
  ``prefill_step`` and 3 ``decode_step`` steps from its prefill caches,
  and ``jax.value_and_grad(forward_loss)`` (the aux loss included), at
  tp=1 and tp=4, against the port at tp=1 and at tp=4 (4 ranks of a
  ``dist.RankGroup`` on the CPU) in xla and flux: next tokens equal on
  every rank; logits (the ranks' vocab shards side by side) within
  relative L2 1e-5; the loss within relative 1e-5 and every leaf's grad
  on every rank, before and after the trainer's sum of the
  model-replicated leaves, within relative L2 1e-4.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import base as TB
from repro_torch.dist import RankGroup
from repro_torch.models import model as TM
from repro_torch.models import serve as TS
from repro_torch.parallel.sharding import make_ctx
from repro_torch.runtime import trainer as TT

ARCH = "llama4_scout_17b_a16e"
MODES = ["xla", "flux"]
TP = 4
B, S, S_MAX, N_DECODE = 2, 64, 72, 3
LENGTHS = [40, 64]
LOGIT_RTOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4

_REF = r"""
import dataclasses, functools
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.configs.base import get_smoke_config, ParallelConfig
from repro.models import model as M, serve as S
from repro.optim import adamw
from repro.parallel.sharding import TPContext

inp = dict(np.load(IN))
out = {}
seen = {}
_argmax = S.vocab_parallel_argmax


def _capture(logits_loc, *a, **k):
    seen["logits"] = logits_loc
    return _argmax(logits_loc, *a, **k)


S.vocab_parallel_argmax = _capture


def save(tree, prefix):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in flat:
        key = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                       for q in path)
        out[prefix + key] = np.asarray(leaf, np.float32)


toks, lengths = jnp.asarray(inp["tokens"]), jnp.asarray(inp["lengths"])
ltoks, labels = jnp.asarray(inp["ltokens"]), jnp.asarray(inp["labels"])
cfg = dataclasses.replace(get_smoke_config(%(arch)r), compute_dtype="float32")
for tp in (1, 4):
    par = ParallelConfig(tp=tp, dp=1)
    mesh = Mesh(np.array(jax.devices()[:tp]).reshape(1, tp),
                ("data", "model"))
    params = M.init_model(jax.random.PRNGKey(0), cfg, par, dtype=jnp.float32)
    specs = M.param_specs(cfg, par, params)
    ctx = TPContext(axis="model", mode="decomposed")
    _, cspec = S.cache_specs(cfg, par, B_, S_, dp_axes=())
    pre = f"{tp}/"

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=(specs, P(), P()),
                       out_specs=(P(), cspec, P(None, "model")),
                       check_vma=False)
    def prefill(p, t, l):
        nxt, caches = S.prefill_step(p, {"tokens": t}, ctx, cfg, par, l)
        return nxt, caches, seen.pop("logits")

    @jax.jit
    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(specs, cspec, P(), P()),
                       out_specs=(P(), cspec, P(None, "model")),
                       check_vma=False)
    def decode(p, c, t, pos):
        nxt, c = S.decode_step(p, c, t, pos, ctx, cfg, par)
        return nxt, c, seen.pop("logits")

    nxt, caches, logits = prefill(params, toks, lengths)
    out[pre + "next"] = np.asarray(nxt)
    out[pre + "logits"] = np.asarray(logits, np.float32)
    pad = int(inp["s_max"]) - toks.shape[1]
    c = {"lead": [], "periods": [jax.tree.map(
        lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, pad), (0, 0), (0, 0)]), x)
        for x in caches["periods"]]}
    save(c, pre + "caches/")
    for step in range(int(inp["n_decode"])):
        nxt, c, lg = decode(params, c, nxt, lengths + step)
        out[f"{pre}decode/{step}/next"] = np.asarray(nxt)
        out[f"{pre}decode/{step}/logits"] = np.asarray(lg, np.float32)

    rep = adamw.model_replicated_tree(specs)
    ranked = jax.tree.map(lambda _: P("model"), params)
    lctx = TPContext(axis="model", mode="xla")

    def body(p, t, l):
        loss, g = jax.value_and_grad(lambda q: M.forward_loss(
            q, {"tokens": t, "labels": l}, lctx, cfg, par))(p)
        gs = jax.tree.map(lambda a, r: jax.lax.psum(a, "model")
                          if r else a, g, rep)
        return (loss, jax.tree.map(lambda a: a[None], g),
                jax.tree.map(lambda a: a[None], gs))

    f = jax.jit(functools.partial(
        shard_map, mesh=mesh, in_specs=(specs, P(), P()),
        out_specs=(P(), ranked, ranked), check_vma=False)(body))
    loss, g, gs = f(params, ltoks, labels)
    out[pre + "loss"] = np.asarray(loss)
    save(params, pre + "params/")
    save(g, pre + "grads/")
    save(gs, pre + "gradsum/")
np.savez(OUT, **out)
print("REF_OK")
"""


# ---------------------------------------------------------------------------
# the config and the parameter count
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["CONFIG", "SMOKE_CONFIG"])
def test_config_equals_reference(which):
    ref_cfg = getattr(importlib.import_module(f"repro.configs.{ARCH}"), which)
    cfg = getattr(importlib.import_module(f"repro_torch.configs.{ARCH}"),
                  which)
    got, want = dataclasses.asdict(cfg), dataclasses.asdict(ref_cfg)
    assert set(got) <= set(want)
    assert got == {k: want[k] for k in got}
    defaults = {f.name: f.default for f in dataclasses.fields(ref_cfg)
                if f.default is not dataclasses.MISSING}
    for k in set(want) - set(got):
        assert want[k] == defaults[k], k
    assert ARCH in TB.ARCH_IDS
    get = TB.get_config if which == "CONFIG" else TB.get_smoke_config
    assert get(ARCH) is cfg


@pytest.mark.parametrize("tp", [1, TP])
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_param_count_equals_reference(size, tp):
    from repro.configs.base import ParallelConfig as RefPar
    from repro.models.model import count_params_analytic as ref_count
    get = TB.get_config if size == "full" else TB.get_smoke_config
    ref_mod = importlib.import_module(f"repro.configs.{ARCH}")
    ref_cfg = ref_mod.CONFIG if size == "full" else ref_mod.SMOKE_CONFIG
    for active in (False, True):
        got = TM.count_params_analytic(get(ARCH), active,
                                       TB.ParallelConfig(tp=tp))
        assert got == ref_count(ref_cfg, active, RefPar(tp=tp)), active


# ---------------------------------------------------------------------------
# prefill, decode and training against the reference
# ---------------------------------------------------------------------------
def _inputs():
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 512, (B, S)).astype(np.int32)
    for b, n in enumerate(LENGTHS):
        toks[b, n:] = 0                      # right padding
    ltoks = rng.integers(0, 512, (B, S)).astype(np.int32)
    labels = rng.integers(0, 512, (B, S)).astype(np.int32)
    labels[1, -5:] = -1                      # masked out of the mean
    return {"tokens": toks, "lengths": np.array(LENGTHS, np.int32),
            "ltokens": ltoks, "labels": labels, "s_max": S_MAX,
            "n_decode": N_DECODE}


@pytest.fixture(scope="module")
def ref(tmp_path_factory, subproc):
    d = tmp_path_factory.mktemp("llama4")
    np.savez(d / "in.npz", **_inputs())
    code = (_REF % {"arch": ARCH}).replace("B_, S_", f"{B}, {S}").replace(
        "IN)", repr(str(d / "in.npz")) + ")").replace(
        "OUT,", repr(str(d / "out.npz")) + ",")
    assert "REF_OK" in subproc(code, n_devices=TP)
    return dict(np.load(d / "out.npz"))


def _tree(flat, prefix):
    """The reference's nested tree from "a/0/b"-keyed numpy leaves."""
    root = {}
    for key, leaf in flat.items():
        if not key.startswith(prefix):
            continue
        parts = key[len(prefix):].split("/")
        node = root
        for i, p in enumerate(parts[:-1]):
            if isinstance(node, list):
                p = int(p)
                while len(node) <= p:
                    node.append([] if parts[i + 1].isdigit() else {})
                node = node[p]
            else:
                node = node.setdefault(
                    p, [] if parts[i + 1].isdigit() else {})
        node[parts[-1]] = leaf
    return root


def _flat(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _want(ref, prefix):
    return {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)}


def _cfg():
    return dataclasses.replace(TB.get_smoke_config(ARCH),
                               compute_dtype="float32")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _params(ref, tp, trainable=False):
    cfg = _cfg()
    tree = _tree(ref, f"{tp}/params/")
    if tp == 1:
        return cfg, [convert.params_from_jax(tree, cfg, dtype=torch.float32,
                                             device="cpu",
                                             trainable=trainable)]
    return cfg, convert.rank_params_from_jax(tree, cfg, tp,
                                             dtype=torch.float32,
                                             device="cpu",
                                             trainable=trainable)


def _spmd(tp, fn, ranks):
    """``fn(p, group)`` on every rank (tp=1: on the caller's thread)."""
    if tp == 1:
        return [fn(ranks[0], None)]
    group = RankGroup(tp, "cpu", timeout_s=60)
    return group.spmd(lambda p: fn(p, group), [(p,) for p in ranks])


def test_convert_carries_the_shared_expert(ref):
    """``convert.params_from_jax`` carries every leaf of the reference's
    Scout tree, the shared expert's included, leaf for leaf."""
    cfg, (p,) = _params(ref, 1)
    named = dict(p.named_parameters())
    assert {"layers.0.ffn.shared.w1", "layers.0.ffn.shared.w3",
            "layers.0.ffn.shared.w2", "layers.0.ffn.router"} <= set(named)
    back = _flat(convert.to_jax_tree(named, cfg))
    want = _want(ref, "1/params/")
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tp", [1, TP])
def test_prefill_decode_match_reference(ref, tp, mode):
    cfg, ranks = _params(ref, tp)
    inp = _inputs()
    toks = torch.from_numpy(inp["tokens"])
    lengths = torch.from_numpy(inp["lengths"]).long()
    caches = convert.caches_from_jax(_tree(ref, f"{tp}/caches/"), cfg,
                                     device="cpu")

    def run(p, group):
        ctx = make_ctx(TB.ParallelConfig(tp=tp, overlap_mode=mode,
                                         kernel_decode=mode == "flux"),
                       group)
        logits, _ = TS.prefill_logits(p, {"tokens": toks}, ctx, cfg,
                                      lengths)
        nxt = TS.vocab_parallel_argmax(logits, cfg.vocab_size, ctx)[:, None]
        r = ctx.tp_index()
        own = [{n: t.chunk(tp, 2)[r].clone() for n, t in layer.items()}
               for layer in caches]
        steps = [(nxt, logits)]
        for step in range(N_DECODE):
            logits, own = TS.decode_logits(p, own, nxt, lengths + step, ctx,
                                           cfg)
            nxt = TS.vocab_parallel_argmax(logits, cfg.vocab_size,
                                           ctx)[:, None]
            steps.append((nxt, logits))
        return steps

    outs = _spmd(tp, run, ranks)
    for s, what in enumerate(["", *(f"decode/{i}/" for i in
                                    range(N_DECODE))]):
        want = ref[f"{tp}/{what}next"].reshape(-1)
        for o in outs:
            np.testing.assert_array_equal(o[s][0].numpy().reshape(-1), want,
                                          err_msg=what)
        got = torch.cat([o[s][1] for o in outs], dim=-1).numpy()
        assert _rel(got, ref[f"{tp}/{what}logits"]) <= LOGIT_RTOL, what


def _assert_grads(got_named, cfg, want_flat, rank):
    got = _flat(convert.to_jax_tree(got_named, cfg))
    assert sorted(got) == sorted(want_flat)
    for key, want in want_flat.items():
        assert _rel(got[key], want[rank]) <= GRAD_RTOL, (key, rank)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tp", [1, TP])
def test_train_step0_matches_reference(ref, tp, mode):
    """Loss (with 0.01 x the MoE aux loss) and every leaf's grad on every
    rank, before and after the sum of the model-replicated leaves."""
    cfg, ranks = _params(ref, tp, trainable=True)
    inp = _inputs()
    batch = {"tokens": torch.from_numpy(inp["ltokens"]),
             "labels": torch.from_numpy(inp["labels"])}
    par = TB.ParallelConfig(tp=tp, overlap_mode=mode)

    def run(p, group):
        loss, grads = TT.loss_and_grads(p, batch,
                                        TT.make_ctx(cfg, par, group), cfg,
                                        par)
        done = (grads if group is None else TT.complete_grads(
            grads, TM.replicated_leaves(cfg, p), group))
        return loss, grads, done

    outs = _spmd(tp, run, ranks)
    want = float(ref[f"{tp}/loss"])
    for r, (loss, grads, done) in enumerate(outs):
        assert abs(loss.item() - want) <= LOSS_RTOL * abs(want)
        _assert_grads(grads, cfg, _want(ref, f"{tp}/grads/"), r)
        _assert_grads(done, cfg, _want(ref, f"{tp}/gradsum/"), r)

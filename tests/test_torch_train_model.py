"""The training loss and every leaf's grad at tp=1 and tp=4 against the
reference.

On the minicpm_2b and codeqwen15_7b (QKV bias: its ``dbias`` rides the
``attn_ag`` epilogue's backward) SMOKE_CONFIGs with fp32 parameters and
compute, the reference's ``jax.value_and_grad(forward_loss)`` runs once
for the file in one subprocess with 4 forced host devices, under
``shard_map`` (``check_vma=False``) in xla mode, at tp=1 and at tp=4; at
tp=4 every rank's grads are kept before and after the trainer's psum of
the model-replicated leaves.  Its parameters cross as numpy
(``convert.params_from_jax`` / ``rank_params_from_jax``, trainable) and
the port's grads come back through ``convert.to_jax_tree``.  The port
runs ``runtime.trainer.loss_and_grads`` (the ``SeamTape`` backward) on
the CPU, at tp=4 as the 4 ranks of a ``dist.RankGroup`` in each mode
(xla, decomposed, flux: the same function as the reference's xla, sums
in another order).

Tolerances (fp32): the loss within 1e-5 relative; each leaf's grad on
each rank within relative L2 1e-4.

Also, without the reference: the port's tp=4 grads, gathered and put in
the canonical layout (``model.canonical_leaves``), are 4x its tp=1 grads
within relative L2 1e-5.  That is the reference's convention: each rank
seeds its copy of the replicated loss with 1, so a tp=4 grad is the sum
of 4 ranks' seeds.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.base import ParallelConfig, get_smoke_config
from repro_torch.dist import RankGroup
from repro_torch.models import model as TM
from repro_torch.runtime import trainer as TT

ARCHS = ["minicpm_2b", "codeqwen15_7b"]
MODES = ["xla", "decomposed", "flux"]
TP = 4
B, S = 2, 64
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4

_REF = r"""
import dataclasses, functools
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.configs.base import get_smoke_config, ParallelConfig
from repro.models import model as M
from repro.optim import adamw
from repro.parallel.sharding import TPContext

inp = dict(np.load(IN))
out = {}


def save(tree, prefix):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in flat:
        key = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                       for q in path)
        out[prefix + key] = np.asarray(leaf, np.float32)


toks, labels = jnp.asarray(inp["tokens"]), jnp.asarray(inp["labels"])
for arch in %(archs)r:
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    for tp in (1, 4):
        par = ParallelConfig(tp=tp, dp=1)
        mesh = Mesh(np.array(jax.devices()[:tp]).reshape(1, tp),
                    ("data", "model"))
        params = M.init_model(jax.random.PRNGKey(0), cfg, par,
                              dtype=jnp.float32)
        if cfg.qkv_bias:   # the reference inits the bias to zero
            mix = params["periods"][0]["mixer"]
            rng = np.random.default_rng(1)
            mix["bqkv"] = jnp.asarray(
                0.1 * rng.standard_normal(mix["bqkv"].shape), jnp.float32)
        specs = M.param_specs(cfg, par, params)
        rep = adamw.model_replicated_tree(specs)
        ranked = jax.tree.map(lambda _: P("model"), params)
        ctx = TPContext(axis="model", mode="xla")

        def body(p, t, l):
            loss, g = jax.value_and_grad(lambda q: M.forward_loss(
                q, {"tokens": t, "labels": l}, ctx, cfg, par))(p)
            gs = jax.tree.map(lambda a, r: jax.lax.psum(a, "model")
                              if r else a, g, rep)
            return (loss, jax.tree.map(lambda a: a[None], g),
                    jax.tree.map(lambda a: a[None], gs))

        f = jax.jit(functools.partial(
            shard_map, mesh=mesh, in_specs=(specs, P(), P()),
            out_specs=(P(), ranked, ranked), check_vma=False)(body))
        loss, g, gs = f(params, toks, labels)
        pre = f"{arch}/{tp}/"
        out[pre + "loss"] = np.asarray(loss)
        save(params, pre + "params/")
        save(g, pre + "grads/")
        save(gs, pre + "gradsum/")
np.savez(OUT, **out)
print("REF_OK")
"""


def _batch(vocab=512):
    rng = np.random.default_rng(11)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels[1, -5:] = -1                    # masked out of the mean
    return toks, labels


@pytest.fixture(scope="module")
def ref(tmp_path_factory, subproc):
    d = tmp_path_factory.mktemp("train_model")
    toks, labels = _batch()
    np.savez(d / "in.npz", tokens=toks, labels=labels)
    code = (_REF % {"archs": ARCHS}).replace(
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
    """{"a/0/b": array} of a nested dict / list tree."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _cfg(arch):
    return dataclasses.replace(get_smoke_config(arch),
                               compute_dtype="float32")


def _torch_batch():
    toks, labels = _batch()
    return {"tokens": torch.from_numpy(toks),
            "labels": torch.from_numpy(labels)}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _assert_grads(got_named, cfg, want_flat, rank):
    got = _flat(convert.to_jax_tree(got_named, cfg))
    assert sorted(got) == sorted(want_flat)
    for key, want in want_flat.items():
        assert _rel(got[key], want[rank]) <= GRAD_RTOL, (key, rank)


def _want(ref, prefix):
    return {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_tp1_match_reference(ref, arch):
    cfg = _cfg(arch)
    par = ParallelConfig()
    params = convert.params_from_jax(_tree(ref, f"{arch}/1/params/"), cfg,
                                     dtype=torch.float32, device="cpu",
                                     trainable=True)
    loss, grads = TT.loss_and_grads(params, _torch_batch(),
                                    TT.make_ctx(cfg, par), cfg, par)
    want = float(ref[f"{arch}/1/loss"])
    assert abs(loss.item() - want) <= LOSS_RTOL * abs(want)
    _assert_grads(grads, cfg, _want(ref, f"{arch}/1/grads/"), 0)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_tp4_match_reference_per_rank(ref, arch, mode):
    """Every rank's grads before the trainer's psum and after it."""
    cfg = _cfg(arch)
    par = ParallelConfig(tp=TP, overlap_mode=mode)
    ranks = convert.rank_params_from_jax(
        _tree(ref, f"{arch}/4/params/"), cfg, TP, dtype=torch.float32,
        device="cpu", trainable=True)
    group = RankGroup(TP, "cpu", timeout_s=60)
    ctx = TT.make_ctx(cfg, par, group)
    batch = _torch_batch()

    def step(p):
        loss, grads = TT.loss_and_grads(p, batch, ctx, cfg, par)
        done = TT.complete_grads(grads, TM.replicated_leaves(cfg, p), group)
        return loss, grads, done

    outs = group.spmd(step, [(p,) for p in ranks])
    want = float(ref[f"{arch}/4/loss"])
    for r, (loss, grads, done) in enumerate(outs):
        assert abs(loss.item() - want) <= LOSS_RTOL * abs(want)
        _assert_grads(grads, cfg, _want(ref, f"{arch}/4/grads/"), r)
        _assert_grads(done, cfg, _want(ref, f"{arch}/4/gradsum/"), r)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp4_grads_are_four_times_tp1(arch):
    """The same canonical weights at tp=1 and tp=4 (flux, w1|w3 packed):
    the canonical-layout grads at tp=4 are 4x tp=1's."""
    cfg = _cfg(arch)
    p1 = TM.init_model(cfg, ParallelConfig(fuse_w13=True), seed=0,
                       dtype=torch.float32, device="cpu", trainable=True)
    par = ParallelConfig(tp=TP, overlap_mode="flux", fuse_w13=True)
    full = TM.init_model(cfg, par, seed=0, dtype=torch.float32,
                         device="cpu", trainable=True)
    ranks = [TM.shard_params(full, r, TP, cfg) for r in range(TP)]
    batch = _torch_batch()
    p1_par = ParallelConfig(fuse_w13=True)
    loss1, g1 = TT.loss_and_grads(p1, batch, TT.make_ctx(cfg, p1_par), cfg,
                                  p1_par)
    group = RankGroup(TP, "cpu", timeout_s=60)
    ctx = TT.make_ctx(cfg, par, group)

    def step(p):
        loss, grads = TT.loss_and_grads(p, batch, ctx, cfg, par)
        return loss, TT.complete_grads(grads, TM.replicated_leaves(cfg, p),
                                       group)

    outs = group.spmd(step, [(p,) for p in ranks])
    assert abs(outs[0][0].item() - loss1.item()) <= 1e-5 * loss1.item()
    g4 = TM.canonical_leaves(TM.gather_rank_leaves(
        [g for _, g in outs], cfg, ranks[0]), cfg, TP, grads=True)
    c1 = TM.canonical_leaves(g1, cfg, 1, grads=True)
    assert sorted(g4) == sorted(c1)
    for n in c1:
        assert _rel(g4[n].numpy() / TP, c1[n].numpy()) <= 1e-5, n

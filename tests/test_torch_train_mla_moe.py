"""Training through MLA and MoE: DeepSeek-V3's loss, with its MoE aux loss
and its multi-token-prediction (MTP) head, every leaf's grad and the
``Trainer``, against the reference.

The reference runs once for the file, in one subprocess with 4 forced
host devices: on the deepseek_v3_671b SMOKE_CONFIG (one MLA + dense-FFN
layer, one MLA + MoE layer with 4 experts, top-2, a shared expert; the MTP
head) with fp32 parameters and compute, at the config's capacity factor,
``jax.value_and_grad(forward_loss)`` under ``shard_map``
(``check_vma=False``) at tp=1, and at tp=4 in ``decomposed`` in the
sequence-sharded and the replicated ("hidden") layout, every rank's grads
kept before and after the trainer's psum of the model-replicated leaves;
its ``Trainer`` for 3 steps at tp=4 in ``decomposed`` (batch 4 x 64,
warmup 1, lr 1e-3, cosine) with a checkpoint at step 3; and its
``Checkpointer`` reading the checkpoint the port's ``Trainer`` wrote.
The reference's flux trainer does not run here (its interpreted
``dma_start`` takes one named axis; the trainer's mesh has two), so the
port's flux runs are held against the reference's decomposed ones, which
compute the same function.

The port runs ``runtime.trainer.loss_and_grads`` on the CPU (at tp=4 as
the 4 ranks of a ``dist.RankGroup`` in xla, decomposed and flux, each
rank recording its seams on a ``SeamTape``), with ``remat`` "none" and
"full" (the MoE block's aux loss carried out of the checkpointed block).

Tolerances (fp32): the loss within 1e-5 relative; each leaf's grad on
each rank within relative L2 1e-4 (the MoE's experts, router and shared
expert, MLA's leaves and the MTP head's included); the trainer's losses
within 1e-5 relative, every final leaf within relative L2 1e-5 and each
leaf's change over the 3 steps within 1e-3 (``tests/test_torch_trainer.py``'s
rule); checkpoints bit-equal both ways.  Without the reference:
drop-free (capacity factor 16), the port's tp=4 canonical grads are 4x its
tp=1 grads within relative L2 1e-5; at a capacity factor of 0.5, where
assignments drop, remat counts each dropped assignment once; and the
training CLI trains the smoke config at tp=4 in flux.
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.base import ParallelConfig, get_smoke_config
from repro_torch.dist import RankGroup
from repro_torch.models import ffn as TF
from repro_torch.models import model as TM
from repro_torch.runtime import trainer as TT

ARCH = "deepseek_v3_671b"
TP = 4
B, S = 2, 64
MODES = ["xla", "decomposed", "flux"]
LAYOUTS = ["seq", "hidden"]
REMATS = ["none", "full"]
STEPS, BATCH, SEQ, LR = 3, 4, 64, 1e-3
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_RTOL = 1e-5
UPDATE_RTOL = 1e-3
DROP_FREE_CF = 16.0
# a capacity factor at which the smoke batch's routing drops assignments
DROPPING_CF = 0.5

_REF = r"""
import dataclasses, functools, json
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.checkpoint.checkpointer import Checkpointer
from repro.compat import shard_map
from repro.configs.base import get_smoke_config, ParallelConfig
from repro.models import model as M
from repro.optim import adamw
from repro.parallel.sharding import TPContext
from repro.runtime import trainer as T

inp = dict(np.load(IN))
out, dtypes = {}, {}


def save(tree, prefix):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in flat:
        key = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                       for q in path)
        out[prefix + key] = np.asarray(leaf, np.float32)
        dtypes[prefix + key] = str(np.asarray(leaf).dtype)


cfg = dataclasses.replace(get_smoke_config("deepseek_v3_671b"),
                          compute_dtype="float32")
toks, labels = jnp.asarray(inp["tokens"]), jnp.asarray(inp["labels"])
for tp, layout in ((1, "seq"), (4, "seq"), (4, "hidden")):
    par = ParallelConfig(tp=tp, dp=1)
    mesh = Mesh(np.array(jax.devices()[:tp]).reshape(1, tp),
                ("data", "model"))
    params = M.init_model(jax.random.PRNGKey(0), cfg, par, dtype=jnp.float32)
    specs = M.param_specs(cfg, par, params)
    rep = adamw.model_replicated_tree(specs)
    ranked = jax.tree.map(lambda _: P("model"), params)
    ctx = TPContext(axis="model", mode="decomposed",
                    seq_shard=layout == "seq")

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
    pre = f"{tp}/{layout}/"
    out[pre + "loss"] = np.asarray(loss)
    save(params, pre + "params/")
    save(g, pre + "grads/")
    save(gs, pre + "gradsum/")

# the port's checkpoint (tp=4, after one step), read by the reference
par = ParallelConfig(tp=4, dp=1, overlap_mode="decomposed")
params = M.init_model(jax.random.PRNGKey(0), cfg, par, dtype=jnp.float32)
like = {"params": params, "opt": adamw.init_opt_state(params)}
state, step, _ = Checkpointer(PORT_DIR).restore(like)
out["port/step"] = np.asarray(step)
save(state, "port/")

# 3 trainer steps at tp=4, a checkpoint at step 3
mesh = Mesh(np.array(jax.devices()).reshape(1, 4), ("data", "model"))
tc = T.TrainConfig(total_steps=%(steps)d, warmup_steps=1, base_lr=%(lr)r,
                   schedule="cosine", checkpoint_dir=RUN_DIR,
                   checkpoint_every=%(steps)d, log_every=100)
tr = T.Trainer(cfg, par, mesh, tc)
tr.data_cfg = dataclasses.replace(tr.data_cfg, seq_len=%(seq)d,
                                  global_batch=%(batch)d)
specs = M.param_specs(cfg, par, params)
put = lambda t: jax.tree.map(
    lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), t, specs,
    is_leaf=lambda x: isinstance(x, P))
save(params, "run/init/")
params = put(params)
opt = adamw.init_opt_state(params)
opt = {"mu": put(opt["mu"]), "nu": put(opt["nu"]), "count": opt["count"]}
with mesh:
    params, opt, hist = tr.train(params, opt, resume=False)
save(params, "run/final/")
out["run/losses"] = np.array([h["loss"] for h in hist], np.float32)
np.savez(OUT, **out)
with open(OUT + ".json", "w") as f:
    json.dump(dtypes, f)
print("REF_OK")
"""


def _batch(vocab=512):
    rng = np.random.default_rng(13)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels[1, -5:] = -1                    # masked out of the mean
    return toks, labels


def _cfg(cf=None):
    cfg = dataclasses.replace(get_smoke_config(ARCH), compute_dtype="float32")
    if cf is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


def _trainer(mode, ckpt=None, every=STEPS):
    tr = TT.Trainer(_cfg(), ParallelConfig(tp=TP, overlap_mode=mode),
                    TT.TrainConfig(total_steps=STEPS, warmup_steps=1,
                                   base_lr=LR, schedule="cosine",
                                   checkpoint_dir=ckpt,
                                   checkpoint_every=every, log_every=100),
                    device="cpu", dtype=torch.float32)
    tr.data_cfg = dataclasses.replace(tr.data_cfg, seq_len=SEQ,
                                      global_batch=BATCH)
    return tr


def _flat(tree, prefix=""):
    """{"a/0/b": leaf} of a nested dict / list tree."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


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


def _as_np(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().float().cpu().numpy()
    return np.asarray(leaf, np.float32)


def _dtype(leaf):
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


@pytest.fixture(scope="module")
def ref(tmp_path_factory, subproc):
    """The reference's losses, grads and trainer run, and its reading of
    the checkpoint the port's trainer wrote (tp=4, one step)."""
    d = tmp_path_factory.mktemp("train_mla_moe")
    toks, labels = _batch()
    np.savez(d / "in.npz", tokens=toks, labels=labels)
    port_dir, run_dir = str(d / "port"), str(d / "run")
    tr = _trainer("decomposed", port_dir, every=1)
    tr.tc.total_steps = 1
    params, opt, _ = tr.train()
    written = _flat(tr.checkpoint_tree(params, opt))
    code = (_REF % {"steps": STEPS, "lr": LR, "seq": SEQ,
                    "batch": BATCH}).replace(
        "IN)", repr(str(d / "in.npz")) + ")").replace(
        "PORT_DIR", repr(port_dir)).replace("RUN_DIR", repr(run_dir)).replace(
        "OUT", repr(str(d / "out.npz")))
    assert "REF_OK" in subproc(code, n_devices=TP)
    with open(d / "out.npz.json") as f:
        dtypes = json.load(f)
    return {"out": dict(np.load(d / "out.npz")), "dtypes": dtypes,
            "written": written, "run_dir": run_dir}


def _torch_batch():
    toks, labels = _batch()
    return {"tokens": torch.from_numpy(toks),
            "labels": torch.from_numpy(labels)}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _want(out, prefix):
    return {k[len(prefix):]: v for k, v in out.items()
            if k.startswith(prefix)}


def _assert_grads(got_named, cfg, want_flat, rank, what):
    got = _flat(convert.to_jax_tree(got_named, cfg))
    assert sorted(got) == sorted(want_flat)
    assert any(k.startswith("mtp/") for k in got)
    for key, want in want_flat.items():
        assert _rel(got[key], want[rank]) <= GRAD_RTOL, (what, key, rank)


@pytest.mark.parametrize("remat", REMATS)
def test_loss_and_grads_tp1_match_reference(ref, remat):
    """The loss (main head, 0.3 x MTP, 0.01 x aux) and every leaf's grad
    at tp=1; with remat the MoE block's aux loss leaves the checkpointed
    block beside its output."""
    out = ref["out"]
    cfg = _cfg()
    par = ParallelConfig(remat=remat)
    params = convert.params_from_jax(_tree(out, "1/seq/params/"), cfg,
                                     dtype=torch.float32, device="cpu",
                                     trainable=True)
    assert params.mtp is not None
    loss, grads = TT.loss_and_grads(params, _torch_batch(),
                                    TT.make_ctx(cfg, par), cfg, par)
    want = float(out["1/seq/loss"])
    assert abs(loss.item() - want) <= LOSS_RTOL * abs(want)
    _assert_grads(grads, cfg, _want(out, "1/seq/grads/"), 0, remat)


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mode", MODES)
def test_loss_and_grads_tp4_match_reference_per_rank(ref, mode, layout,
                                                     remat):
    """Every rank's loss and grads, before the trainer's psum of the
    model-replicated leaves and after it (the experts count as sharded:
    their grads are not summed)."""
    out = ref["out"]
    cfg = _cfg()
    par = ParallelConfig(tp=TP, overlap_mode=mode, remat=remat,
                         scatter_axis="hidden" if layout == "hidden"
                         else "auto")
    ranks = convert.rank_params_from_jax(
        _tree(out, f"4/{layout}/params/"), cfg, TP, dtype=torch.float32,
        device="cpu", trainable=True)
    group = RankGroup(TP, "cpu", timeout_s=60)
    ctx = TT.make_ctx(cfg, par, group)
    assert ctx.seq_sharded == (layout == "seq")
    batch = _torch_batch()

    def step(p):
        loss, grads = TT.loss_and_grads(p, batch, ctx, cfg, par)
        done = TT.complete_grads(grads, TM.replicated_leaves(cfg, p), group)
        return loss, grads, done

    outs = group.spmd(step, [(p,) for p in ranks])
    want = float(out[f"4/{layout}/loss"])
    what = f"{mode} {layout} remat {remat}"
    for r, (loss, grads, done) in enumerate(outs):
        assert abs(loss.item() - want) <= LOSS_RTOL * abs(want), (what, r)
        _assert_grads(grads, cfg, _want(out, f"4/{layout}/grads/"), r, what)
        _assert_grads(done, cfg, _want(out, f"4/{layout}/gradsum/"), r,
                      what)


def test_tp4_grads_are_four_times_tp1():
    """Drop-free, the same canonical weights at tp=1 and at tp=4 (flux,
    w1|w3 packed): the canonical-layout grads at tp=4 are 4x tp=1's,
    every leaf's (the experts', the router's, MLA's and the MTP head's)."""
    cfg = _cfg(DROP_FREE_CF)
    p1_par = ParallelConfig(fuse_w13=True)
    p1 = TM.init_model(cfg, p1_par, seed=0, dtype=torch.float32,
                       device="cpu", trainable=True)
    par = ParallelConfig(tp=TP, overlap_mode="flux", fuse_w13=True)
    full = TM.init_model(cfg, par, seed=0, dtype=torch.float32,
                         device="cpu", trainable=True)
    ranks = [TM.shard_params(full, r, TP, cfg) for r in range(TP)]
    batch = _torch_batch()
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
    assert {"mtp.proj", "mtp.ffn.w1", "mtp.mixer.w_uq"} <= set(c1)
    for n in c1:
        assert _rel(g4[n].numpy() / TP, c1[n].numpy()) <= 1e-5, n


@pytest.mark.parametrize("tp", [1, TP])
def test_remat_counts_each_drop_once(tp):
    """At a capacity factor where assignments drop, remat's recompute of
    the MoE block counts none of them again."""
    cfg = _cfg(DROPPING_CF)
    batch = _torch_batch()
    full = TM.init_model(cfg, ParallelConfig(tp=tp), seed=0,
                         dtype=torch.float32, device="cpu", trainable=True)
    ranks = ([full] if tp == 1 else
             [TM.shard_params(full, r, tp, cfg) for r in range(tp)])
    group = RankGroup(tp, "cpu", timeout_s=60) if tp > 1 else None
    drops = {}
    for remat in REMATS:
        par = ParallelConfig(tp=tp, remat=remat)
        ctx = TT.make_ctx(cfg, par, group)
        TF.dropped.clear()
        if group is None:
            TT.loss_and_grads(ranks[0], batch, ctx, cfg, par)
        else:
            group.spmd(lambda p: TT.loss_and_grads(p, batch, ctx, cfg, par),
                       [(p,) for p in ranks])
        drops[remat] = TF.drop_totals(tp)
    assert sum(drops["none"]) > 0
    assert drops["full"] == drops["none"]


@pytest.mark.parametrize("mode", ["decomposed", "flux"])
def test_trainer_three_steps_match_reference(ref, mode):
    """Three steps of the port's Trainer at tp=4 on the reference's loss
    trajectory, its final weights and their change."""
    out = ref["out"]
    tr = _trainer(mode)
    init = _tree(out, "run/init/")
    params = convert.rank_params_from_jax(init, tr.cfg, TP,
                                          dtype=torch.float32, device="cpu",
                                          trainable=True)
    params, _, hist = tr.train(params, [tr.init_opt(p) for p in params])
    got = np.array([h["loss"] for h in hist])
    assert all(map(math.isfinite, got))
    np.testing.assert_allclose(got, out["run/losses"], rtol=LOSS_RTOL, atol=0)
    final = TM.gather_rank_leaves(
        [dict(p.named_parameters()) for p in params], tr.cfg, params[0])
    got = _flat(convert.to_jax_tree(final, tr.cfg))
    start = _flat(init)
    want = _flat(_tree(out, "run/final/"))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert _rel(got[key], w) <= PARAM_RTOL, key
        assert _rel(got[key] - start[key], w - start[key]) <= UPDATE_RTOL, \
            key


def test_reference_reads_the_ports_checkpoint_with_mtp(ref):
    """The port's checkpoint (the global tp=4 tree, the MTP head in it,
    fp32 moments) read by the reference's ``Checkpointer``: every leaf
    and its dtype bit-equal."""
    out, dtypes, written = ref["out"], ref["dtypes"], ref["written"]
    assert int(out["port/step"]) == 1
    assert sorted(written) == sorted(k[5:] for k in dtypes
                                     if k.startswith("port/"))
    assert {"params/mtp/proj", "opt/mu/mtp/mixer/w_uq"} <= set(written)
    for key, leaf in written.items():
        assert dtypes["port/" + key] == _dtype(leaf), key
        np.testing.assert_array_equal(out["port/" + key], _as_np(leaf),
                                      err_msg=key)


def test_port_restores_the_references_checkpoint_with_mtp(ref, tmp_path):
    """The reference trainer's step-3 checkpoint restored by the port:
    every weight, the MTP head's included, bit-equal to the reference's
    final weights; saved again by the port and restored, bit-equal."""
    out = ref["out"]
    tr = _trainer("decomposed", ref["run_dir"])
    params, _ = tr.init_state()
    opt = tr.restore(params)
    assert tr.step == STEPS and opt[0]["count"] == STEPS
    tree = tr.checkpoint_tree(params, opt)
    got = _flat(tree["params"])
    want = _flat(_tree(out, "run/final/"))
    assert sorted(got) == sorted(want) and "mtp/proj" in got
    for key, w in want.items():
        np.testing.assert_array_equal(_as_np(got[key]), w, err_msg=key)
    again = _trainer("decomposed", str(tmp_path))
    again.step = tr.step
    again.save(params, opt)
    again.ckpt.wait()
    p2, _ = again.init_state()
    opt2 = again.restore(p2)
    tree2 = again.checkpoint_tree(p2, opt2)
    for key, leaf in _flat(tree).items():
        np.testing.assert_array_equal(_as_np(_flat(tree2)[key]),
                                      _as_np(leaf), err_msg=key)


def test_train_cli_trains_deepseek_smoke_at_tp4(capsys):
    from repro_torch.launch import train as LT
    tr, hist = LT.main(["--arch", ARCH, "--smoke", "--tp", "4", "--mode",
                        "flux", "--steps", "3", "--device", "cpu"])
    assert len(hist) == 3 and tr.step == 3
    assert all(math.isfinite(h["loss"]) for h in hist)
    assert "3 steps at tp=4 (flux" in capsys.readouterr().out

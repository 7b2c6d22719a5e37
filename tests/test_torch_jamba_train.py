"""Training Jamba-v0.1 (jamba_v01_52b): the loss, every leaf's grad, the
``Trainer`` and its checkpoints against the reference.

The reference runs once for the file, in five subprocesses at once with
4 forced host devices each, on Jamba's SMOKE_CONFIG cut to one period of
its pattern (8 layers: 7 Mamba mixers and 1 GQA, 4 dense and 4 MoE FFNs
of 4 experts, top-2) with fp32 parameters and compute, at the config's
capacity factor: ``jax.value_and_grad(forward_loss)`` under
``shard_map`` (``check_vma=False``) at tp=1 and at tp=4 in
``decomposed`` in the sequence-sharded and the replicated ("hidden")
layout, every rank's grads kept before and after the trainer's psum of
the model-replicated leaves; its ``Trainer`` for one step at dp=2 x tp=2
under ZeRO-3 with remat "full" in ``decomposed`` (Jamba's production
preset on 4 ranks, batch 4 x 64) and for 3 steps at tp=4 in ``xla``
(batch 4 x 64, warmup 1, lr 1e-3, cosine; each of its steps takes about
12 s here in ``xla`` and 17 s in ``decomposed``) with a checkpoint at
step 3; and its ``Checkpointer`` reading the checkpoint the port's
``Trainer`` wrote. The reference's flux trainer does not run here
(``tests/test_torch_trainer.py``), so the port's decomposed and flux
runs are held against the reference's decomposed or xla ones, which
compute the same function. Each case runs in a subprocess of its own, so
that their tracing runs at once.

The port runs ``runtime.trainer.loss_and_grads`` on the CPU (at tp=4 as
the 4 ranks of a ``dist.RankGroup`` in xla, decomposed and flux, each
rank recording its seams on a ``SeamTape``), in both layouts, with
``remat`` "none" (and "full" at tp=1 and in flux at tp=4); its
``Trainer`` on a ``dist.RankMesh`` at dp=2 x tp=2 under ZeRO-3 with
remat "full" in flux, and at tp=4. The multi-rank cases run with one
intra-op thread (the module fixture, as in
``tests/test_torch_jamba_serve.py``).

Tolerances (fp32): the loss within 1e-5 relative; each leaf's grad on
each rank within relative L2 1e-4 (every Mamba leaf, ``a_log`` and
``d_skip`` included); the trainer's losses within 1e-5 relative, every
final leaf within relative L2 1e-5 and each leaf's change within 1e-3
(``tests/test_torch_trainer.py``'s rule); checkpoints bit-equal both
ways.  Without the reference: drop-free (capacity factor 16), the port's
tp=4 canonical grads are 4x its tp=1 grads within relative L2 1e-5; and
the training CLI trains the smoke config at ``--tp 4`` and at ``--dp 2
--tp 2 --zero3`` (on a big arch ``--zero3`` brings remat "full").
"""
import dataclasses
import json
import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.base import ParallelConfig, get_smoke_config
from repro_torch.dist import RankGroup
from repro_torch.models import model as TM
from repro_torch.runtime import trainer as TT

ARCH = "jamba_v01_52b"
LAYERS = 8                           # one period of the pattern
TP = 4
B, S = 2, 64
MODES = ["xla", "decomposed", "flux"]
LAYOUTS = ["seq", "hidden"]
REMATS = ["none", "full"]
TP4_CASES = ([(m, lay, "none") for m in MODES for lay in LAYOUTS]
             + [("flux", lay, "full") for lay in LAYOUTS])
STEPS, BATCH, SEQ, LR = 3, 4, 64, 1e-3
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_RTOL = 1e-5
UPDATE_RTOL = 1e-3
DROP_FREE_CF = 16.0
# Jamba's production preset (ZeRO-3, remat "full") on 4 ranks: (dp, tp)
Z3_DP, Z3_TP = 2, 2
# the reference's cases, one subprocess each (``tp1`` also reads the
# port's checkpoint)
REF_CASES = ["run", "z3", "tp1", "tp4_seq", "tp4_hidden"]

_REF = r"""
import dataclasses, functools, json
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.checkpoint.checkpointer import Checkpointer
from repro.compat import shard_map
from repro.configs.base import get_smoke_config, ParallelConfig
from repro.launch.mesh import make_mesh
from repro.models import model as M
from repro.optim import adamw
from repro.parallel.sharding import TPContext
from repro.runtime import trainer as T

inp = dict(np.load(IN))
out, dtypes = {}, {}


def save(tree, prefix, types=False):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in flat:
        key = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                       for q in path)
        out[prefix + key] = np.asarray(leaf, np.float32)
        if types:
            dtypes[prefix + key] = str(np.asarray(leaf).dtype)


cfg = dataclasses.replace(get_smoke_config("jamba_v01_52b"),
                          num_layers=%(layers)d, compute_dtype="float32")
toks, labels = jnp.asarray(inp["tokens"]), jnp.asarray(inp["labels"])


def grads(tp, layout):
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


def train(name, dp, tp, steps, remat, zero3, ckpt, mode="decomposed"):
    par = ParallelConfig(tp=tp, dp=dp, overlap_mode=mode,
                         zero3=zero3, remat=remat)
    mesh = make_mesh(1, dp, tp)
    params = M.init_model(jax.random.PRNGKey(0), cfg, par, dtype=jnp.float32)
    specs = M.param_specs(cfg, par, params)
    ospecs = adamw.opt_state_specs(specs, params, dp, tp)
    put = lambda tree, sp: jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), tree, sp,
        is_leaf=lambda x: isinstance(x, P))
    save(params, name + "/init/")
    opt = adamw.init_opt_state(params)
    opt = {"mu": put(opt["mu"], ospecs["mu"]),
           "nu": put(opt["nu"], ospecs["nu"]), "count": opt["count"]}
    tc = T.TrainConfig(total_steps=steps, warmup_steps=1, base_lr=%(lr)r,
                       schedule="cosine", checkpoint_dir=ckpt,
                       checkpoint_every=steps, log_every=100)
    tr = T.Trainer(cfg, par, mesh, tc)
    tr.data_cfg = dataclasses.replace(tr.data_cfg, seq_len=%(seq)d,
                                      global_batch=%(batch)d)
    with mesh:
        params, opt, hist = tr.train(put(params, specs), opt, resume=False)
    save(params, name + "/final/")
    out[name + "/losses"] = np.array([h["loss"] for h in hist], np.float32)


cases = {"run": functools.partial(train, "run", 1, 4, %(steps)d, "none",
                                  False, RUN_DIR, "xla"),
         "z3": functools.partial(train, "z3", %(z3_dp)d, %(z3_tp)d, 1,
                                 "full", True, None),
         "tp1": functools.partial(grads, 1, "seq"),
         "tp4_seq": functools.partial(grads, 4, "seq"),
         "tp4_hidden": functools.partial(grads, 4, "hidden")}
for name in CASES:
    cases[name]()

if "tp1" in CASES:
    # the port's checkpoint (tp=4, after one step), read by the reference
    par = ParallelConfig(tp=4, dp=1, overlap_mode="decomposed")
    params = M.init_model(jax.random.PRNGKey(0), cfg, par,
                          dtype=jnp.float32)
    like = {"params": params, "opt": adamw.init_opt_state(params)}
    state, step, _ = Checkpointer(PORT_DIR).restore(like)
    out["port/step"] = np.asarray(step)
    save(state, "port/", types=True)
np.savez(OUT, **out)
with open(OUT + ".json", "w") as f:
    json.dump(dtypes, f)
print("REF_OK")
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the rank threads already fill the cores (under
    the suite's workers a thread pool per rank oversubscribes them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(vocab=512):
    rng = np.random.default_rng(13)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels[1, -5:] = -1                    # masked out of the mean
    return toks, labels


def _cfg(cf=None):
    cfg = dataclasses.replace(get_smoke_config(ARCH), num_layers=LAYERS,
                              compute_dtype="float32")
    if cf is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


def _tc(steps, ckpt=None, every=None):
    return TT.TrainConfig(total_steps=steps, warmup_steps=1, base_lr=LR,
                          schedule="cosine", checkpoint_dir=ckpt,
                          checkpoint_every=every or steps, log_every=100)


def _trainer(par, steps=STEPS, ckpt=None, every=None):
    tr = TT.Trainer(_cfg(), par, _tc(steps, ckpt, every), device="cpu",
                    dtype=torch.float32)
    tr.data_cfg = dataclasses.replace(tr.data_cfg, seq_len=SEQ,
                                      global_batch=BATCH)
    return tr


def _tp4(mode):
    return ParallelConfig(tp=TP, overlap_mode=mode)


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
    """The reference's losses, grads and trainer runs, and its reading of
    the checkpoint the port's trainer wrote (tp=4, one step): each case
    in a subprocess of its own, all at once (a case spends most of its
    time tracing and compiling, which threads of one process would
    serialise)."""
    d = tmp_path_factory.mktemp("jamba_train")
    toks, labels = _batch()
    np.savez(d / "in.npz", tokens=toks, labels=labels)
    port_dir, run_dir = str(d / "port"), str(d / "run")
    tr = _trainer(_tp4("decomposed"), 1, port_dir, every=1)
    params, opt, _ = tr.train()
    written = _flat(tr.checkpoint_tree(params, opt))
    code = (_REF % {"layers": LAYERS, "steps": STEPS, "lr": LR, "seq": SEQ,
                    "batch": BATCH, "z3_dp": Z3_DP, "z3_tp": Z3_TP}
            ).replace("IN)", repr(str(d / "in.npz")) + ")").replace(
        "PORT_DIR", repr(port_dir)).replace("RUN_DIR", repr(run_dir))

    def run(name):
        path = str(d / f"{name}.npz")
        one = code.replace("CASES", repr([name])).replace("OUT",
                                                            repr(path))
        assert "REF_OK" in subproc(one, n_devices=TP), name
        return path
    with ThreadPoolExecutor(len(REF_CASES)) as pool:
        paths = list(pool.map(run, REF_CASES))
    out = {}
    for path in paths:
        out.update(np.load(path))
    with open(d / "tp1.npz.json") as f:
        dtypes = json.load(f)
    return {"out": out, "dtypes": dtypes,
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


MAMBA_LEAVES = {"w_in_x", "w_in_z", "conv", "conv_b", "w_x", "w_dt",
                "dt_bias", "a_log", "d_skip", "w_out"}


def _assert_grads(got_named, cfg, want_flat, rank, what):
    got = _flat(convert.to_jax_tree(got_named, cfg))
    assert sorted(got) == sorted(want_flat)
    assert MAMBA_LEAVES <= {k.split("/")[-1] for k in got}
    for key, want in want_flat.items():
        assert _rel(got[key], want[rank]) <= GRAD_RTOL, (what, key, rank)


@pytest.mark.parametrize("remat", REMATS)
def test_loss_and_grads_tp1_match_reference(ref, remat):
    """The loss (main head, 0.01 x the MoE aux) and every leaf's grad at
    tp=1, the seven Mamba mixers' included."""
    out = ref["out"]
    cfg = _cfg()
    par = ParallelConfig(remat=remat)
    params = convert.params_from_jax(_tree(out, "1/seq/params/"), cfg,
                                     dtype=torch.float32, device="cpu",
                                     trainable=True)
    loss, grads = TT.loss_and_grads(params, _torch_batch(),
                                    TT.make_ctx(cfg, par), cfg, par)
    want = float(out["1/seq/loss"])
    assert abs(loss.item() - want) <= LOSS_RTOL * abs(want)
    _assert_grads(grads, cfg, _want(out, "1/seq/grads/"), 0, remat)


@pytest.mark.parametrize("mode,layout,remat", TP4_CASES,
                         ids=["-".join(c) for c in TP4_CASES])
def test_loss_and_grads_tp4_match_reference_per_rank(ref, mode, layout,
                                                     remat):
    """Every rank's loss and grads, before the trainer's psum of the
    model-replicated leaves and after it: each mode in each layout, and
    remat "full" in flux (remat re-runs a block as one tape entry, the
    same in every mode)."""
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
    ``w_in_xz`` and w1|w3 packed): the canonical-layout grads at tp=4 are
    4x tp=1's, every leaf's (each Mamba leaf's padded channels cut)."""
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
    assert {"layers.0.mixer.w_in_x", "layers.0.mixer.a_log",
            "layers.7.mixer.w_out"} <= set(c1)
    for n in c1:
        assert _rel(g4[n].numpy() / TP, c1[n].numpy()) <= 1e-5, n


def _assert_run(tr, params, init, hist, out, name):
    """Losses, final leaves and their change against the reference's
    trainer run ``name``."""
    got = np.array([h["loss"] for h in hist])
    assert all(map(math.isfinite, got))
    np.testing.assert_allclose(got, out[f"{name}/losses"], rtol=LOSS_RTOL,
                               atol=0)
    final = tr.global_leaves([dict(p.named_parameters()) for p in params])
    have = _flat(convert.to_jax_tree(final, tr.cfg))
    start = _flat(init)
    want = _flat(_tree(out, f"{name}/final/"))
    assert sorted(have) == sorted(want)
    for key, w in want.items():
        assert _rel(have[key], w) <= PARAM_RTOL, key
        assert _rel(have[key] - start[key], w - start[key]) <= UPDATE_RTOL, \
            key


def test_zero3_full_remat_step_matches_reference(ref):
    """Step 0 of the production preset on 4 ranks: the port's Trainer at
    dp=2 x tp=2 under ZeRO-3 with remat "full" in flux (each layer
    gathers its flagged Mamba leaves, ``w_in_x`` / ``w_in_z``, ``conv``
    and ``w_dt``, and gathers again when it is recomputed) against the
    reference's decomposed step."""
    out = ref["out"]
    par = ParallelConfig(tp=Z3_TP, dp=Z3_DP, zero3=True, remat="full",
                         overlap_mode="flux")
    tr = _trainer(par, steps=1)
    flagged = {n.split(".", 2)[2] for n in TM.zero3_leaves(tr.cfg, par)
               if n.startswith("layers.0.")}
    assert {"mixer.w_in_x", "mixer.w_in_z", "mixer.conv",
            "mixer.w_dt"} <= flagged
    assert not {"mixer.a_log", "mixer.w_x", "mixer.w_out"} & flagged
    init = _tree(out, "z3/init/")
    full = convert.params_from_jax(init, tr.cfg, dtype=torch.float32,
                                   device="cpu", trainable=True)
    params = tr.shard(full)
    opt = [tr.init_opt(p, r) for r, p in enumerate(params)]
    params, _, hist = tr.train(params, opt)
    _assert_run(tr, params, init, hist, out, "z3")


@pytest.mark.parametrize("mode", ["decomposed", "flux"])
def test_trainer_three_steps_match_reference(ref, mode):
    """Three steps of the port's Trainer at tp=4 on the reference's loss
    trajectory (its xla run), its final weights and their change."""
    out = ref["out"]
    tr = _trainer(_tp4(mode))
    init = _tree(out, "run/init/")
    params = convert.rank_params_from_jax(init, tr.cfg, TP,
                                          dtype=torch.float32, device="cpu",
                                          trainable=True)
    params, _, hist = tr.train(params, [tr.init_opt(p) for p in params])
    _assert_run(tr, params, init, hist, out, "run")


def test_reference_reads_the_ports_checkpoint(ref):
    """The port's checkpoint (the global tp=4 tree, fp32 moments, the
    Mamba mixers' stacked leaves) read by the reference's
    ``Checkpointer``: every leaf and its dtype bit-equal."""
    out, dtypes, written = ref["out"], ref["dtypes"], ref["written"]
    assert int(out["port/step"]) == 1
    assert sorted(written) == sorted(k[5:] for k in dtypes
                                     if k.startswith("port/"))
    assert {"params/periods/0/mixer/a_log",
            "opt/nu/periods/1/mixer/w_in_x"} <= set(written)
    for key, leaf in written.items():
        assert dtypes["port/" + key] == _dtype(leaf), key
        np.testing.assert_array_equal(out["port/" + key], _as_np(leaf),
                                      err_msg=key)


def test_port_restores_the_references_checkpoint(ref, tmp_path):
    """The reference trainer's step-3 checkpoint restored by the port:
    every weight bit-equal to the reference's final weights; saved again
    by the port and restored, bit-equal."""
    out = ref["out"]
    tr = _trainer(_tp4("decomposed"), ckpt=ref["run_dir"])
    params, _ = tr.init_state()
    opt = tr.restore(params)
    assert tr.step == STEPS and opt[0]["count"] == STEPS
    tree = tr.checkpoint_tree(params, opt)
    got = _flat(tree["params"])
    want = _flat(_tree(out, "run/final/"))
    assert sorted(got) == sorted(want)
    assert "periods/0/mixer/a_log" in got
    for key, w in want.items():
        np.testing.assert_array_equal(_as_np(got[key]), w, err_msg=key)
    again = _trainer(_tp4("decomposed"), ckpt=str(tmp_path))
    again.step = tr.step
    again.save(params, opt)
    again.ckpt.wait()
    p2, _ = again.init_state()
    opt2 = again.restore(p2)
    tree2 = _flat(again.checkpoint_tree(p2, opt2))
    for key, leaf in _flat(tree).items():
        np.testing.assert_array_equal(_as_np(tree2[key]), _as_np(leaf),
                                      err_msg=key)


def test_bf16_trainer_keeps_mamba_fp32_leaves():
    """In a bf16 model under AdamW (fp32 moments) at dp=2 x tp=2 with
    ZeRO-1: the Mamba mixers' ``a_log`` and ``d_skip`` stay fp32 leaves
    with fp32 moments and move with the steps; every other leaf but the
    MoE router (fp32, as the reference's) stays bf16."""
    cfg = dataclasses.replace(_cfg(), compute_dtype="bfloat16")
    par = ParallelConfig(tp=2, dp=2, overlap_mode="flux")
    tr = TT.Trainer(cfg, par, _tc(2), device="cpu", dtype=torch.bfloat16)
    tr.data_cfg = dataclasses.replace(tr.data_cfg, seq_len=SEQ,
                                      global_batch=BATCH)
    params, opt = tr.init_state()
    start = {n: t.detach().clone() for n, t in params[0].named_parameters()}
    params, opt, hist = tr.train(params, opt)
    assert all(math.isfinite(h["loss"]) for h in hist)
    fp32 = {n for n in start if n.split(".")[-1] in ("a_log", "d_skip")}
    assert len(fp32) == 2 * 7
    for n, t in params[0].named_parameters():
        want = (torch.float32 if n in fp32 or n.endswith(".router")
                else torch.bfloat16)
        assert t.dtype == want, n
        if n in fp32:
            assert not torch.equal(t.detach(), start[n]), n
    for r in range(tr.n_ranks):
        for key in ("mu", "nu"):
            held = opt[r][key]
            assert all(m.dtype == torch.float32 for m in held.values())
    assert fp32 & set().union(*(opt[r]["mu"] for r in range(tr.n_ranks)))


@pytest.mark.parametrize("argv", [
    ["--tp", "4", "--mode", "flux"],
    ["--dp", "2", "--tp", "2", "--zero3", "--mode", "flux"]],
    ids=["tp4", "dp2-tp2-zero3-remat"])
def test_train_cli_trains_jamba_smoke(capsys, argv):
    """The training CLI on the smoke config (16 layers, bf16): at tp=4,
    and with the production preset's ZeRO-3 and full remat at dp=2 x
    tp=2: ``--zero3`` alone brings the remat on this big arch."""
    from repro_torch.launch import train as LT
    tr, hist = LT.main(["--arch", ARCH, "--smoke", "--steps", "2",
                        "--batch", "4", "--seq", "64", "--device", "cpu",
                        *argv])
    assert len(hist) == 2 and tr.step == 2
    assert all(math.isfinite(h["loss"]) for h in hist)
    assert tr.par.remat == ("full" if "--zero3" in argv else "none")
    text = capsys.readouterr().out
    assert "2 steps at tp=" in text and "failures 0" in text

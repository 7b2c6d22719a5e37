"""Training RWKV-6 (rwkv6_3b): the chunked wkv under grad, the time-mix and
channel-mix's grads, the loss and every leaf's grad at tp=1 and tp=4, the
``Trainer`` and the training CLI, against the reference on the CPU.

The reference runs once for the file, in three subprocesses at once with
4 forced host devices each, on rwkv6_3b's SMOKE_CONFIG (2 layers, d_model
128: 4 heads of 32, d_ff 256) with the inputs drawn here with numpy:

* ``jax.grad`` of the reference's ``_wkv_chunk`` chained over the same
  chunks, with cotangents on y and on the final state, for (S, chunk) in
  ``WKV_CASES`` (40 over 16 and 7 over 64 halve the chunk);
* ``jax.grad`` of ``rwkv_time_train`` / ``rwkv_channel_train`` (layer 0 of
  its ``init_model``) for every leaf and the input, in fp32 and bf16;
* ``jax.value_and_grad(forward_loss)`` under ``shard_map``
  (``check_vma=False``) at tp=1 and at tp=4 in ``xla`` (the smallest
  graph to compile; every mode computes the same function) in the
  sequence-sharded and the replicated ("hidden") layout, every rank's
  grads kept before and after the trainer's psum of the model-replicated
  leaves (its ``test_sp_residency.py`` / ``test_tp_invariance.py``
  targets under grad);
* its ``Trainer`` for 3 steps at tp=4 in ``xla`` (batch 4 x 64, warmup 1,
  lr 1e-3, cosine).  The reference's flux trainer does not run here, so
  the port's flux runs are held against its xla ones, which compute the
  same function.

The port: ``rwkv.wkv`` (``_WKV``), the two blocks, and
``runtime.trainer.loss_and_grads`` at tp=1 (remat "none" and "full") and
as the 4 ranks of a CPU ``dist.RankGroup`` in xla / decomposed / flux in
both layouts (the plain versions on the CPU, each rank recording its
seams on a ``SeamTape``); the ``Trainer`` at tp=4 in flux, at dp=2 x tp=2
under ZeRO-3 (one step, against its dp=1 step) and in bf16 (RWKV's fp32
leaves kept across a step and a checkpoint); the CLI at tp=1 and tp=2.

Tolerances, relative L2: the wkv's and fp32 grads 1e-4, bf16 2e-2; the
loss within 1e-5 relative; the trainer's losses 1e-5, every final leaf
1e-5 and each leaf's change 1e-3 (``tests/test_torch_trainer.py``'s rule).
This file imports no JAX at the top: the card's machine has none.
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
from repro_torch.models import rwkv as TR
from repro_torch.parallel.sharding import TPContext
from repro_torch.runtime import trainer as TT

ARCH = "rwkv6_3b"
F32_RTOL = 1e-4
BF16_RTOL = 2e-2
LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-5
UPDATE_RTOL = 1e-3
TP = 4
B, S = 2, 64                       # the loss's batch
BLK_B, BLK_S, BLK_CHUNK = 2, 40, 16  # the blocks' input: chunks of 8
WKV_CASES = [(64, 16), (40, 16), (7, 64)]
WKV_B, WKV_H, WKV_DH = 2, 3, 16
MODES = ["xla", "decomposed", "flux"]
LAYOUTS = ["seq", "hidden"]
STEPS, BATCH, SEQ, LR = 3, 4, 64, 1e-3
WKV_NAMES = ("r", "k", "v", "logw", "u", "s0")

_REF = r"""
import dataclasses, functools, json
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.compat import shard_map
from repro.configs.base import get_smoke_config, ParallelConfig
from repro.launch.mesh import make_mesh
from repro.models import model as M, rwkv as RR
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


def smoke(dtype):
    return dataclasses.replace(get_smoke_config("rwkv6_3b"),
                               compute_dtype=dtype)


def wkv():
    for s, chunk in %(wkv_cases)r:
        step = min(chunk, s)
        while s %% step:
            step //= 2

        def loss(args, wy, ws, s=s, step=step):
            r, k, v, logw, u, st = args
            ys = []
            for i in range(0, s, step):
                sl = slice(i, i + step)
                y, st = RR._wkv_chunk(r[:, :, sl], k[:, :, sl], v[:, :, sl],
                                      logw[:, :, sl], u, st)
                ys.append(y)
            return jnp.sum(jnp.concatenate(ys, 2) * wy) + jnp.sum(st * ws)
        pre = f"wkv/{s}/"
        args = [jnp.asarray(inp[pre + n]) for n in %(wkv_names)r]
        g = jax.jit(jax.grad(loss))(args, jnp.asarray(inp[pre + "wy"]),
                                    jnp.asarray(inp[pre + "ws"]))
        for n, a in zip(%(wkv_names)r, g):
            out[pre + "grad/" + n] = np.asarray(a)


def blocks(dtype):
    cfg = smoke(dtype)
    params = M.init_model(jax.random.PRNGKey(0), cfg,
                          ParallelConfig(tp=1, dp=1),
                          dtype=getattr(jnp, dtype))
    save(params, f"blk/{dtype}/params/")
    layer = jax.tree.map(lambda a: a[0], params["periods"][0])
    x = jnp.asarray(inp["blk/x"], dtype)
    w = jnp.asarray(inp["blk/w"])
    ctx = TPContext()
    fns = {"time": lambda p, x: RR.rwkv_time_train(p, x, ctx, cfg,
                                                    chunk=%(chunk)d),
           "channel": lambda p, x: RR.rwkv_channel_train(p, x, ctx, cfg)}
    for which, part in (("time", "mixer"), ("channel", "ffn")):
        fn = fns[which]
        gp, gx = jax.jit(jax.grad(
            lambda p, x: jnp.sum(fn(p, x).astype(jnp.float32) * w),
            argnums=(0, 1)))(layer[part], x)
        save(gp, f"blk/{dtype}/{which}/grad/")
        out[f"blk/{dtype}/{which}/dx"] = np.asarray(gx, np.float32)


cfg = smoke("float32")
toks, labels = jnp.asarray(inp["tokens"]), jnp.asarray(inp["labels"])


def grads(tp, layout):
    par = ParallelConfig(tp=tp, dp=1)
    mesh = Mesh(np.array(jax.devices()[:tp]).reshape(1, tp),
                ("data", "model"))
    params = M.init_model(jax.random.PRNGKey(0), cfg, par, dtype=jnp.float32)
    specs = M.param_specs(cfg, par, params)
    rep = adamw.model_replicated_tree(specs)
    ranked = jax.tree.map(lambda _: P("model"), params)
    ctx = TPContext(axis="model", mode="xla", seq_shard=layout == "seq")

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


def train():
    par = ParallelConfig(tp=%(tp)d, dp=1, overlap_mode="xla")
    mesh = make_mesh(1, 1, %(tp)d)
    params = M.init_model(jax.random.PRNGKey(0), cfg, par, dtype=jnp.float32)
    specs = M.param_specs(cfg, par, params)
    ospecs = adamw.opt_state_specs(specs, params, 1, %(tp)d)
    put = lambda tree, sp: jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), tree, sp,
        is_leaf=lambda x: isinstance(x, P))
    save(params, "run/init/")
    opt = adamw.init_opt_state(params)
    opt = {"mu": put(opt["mu"], ospecs["mu"]),
           "nu": put(opt["nu"], ospecs["nu"]), "count": opt["count"]}
    tc = T.TrainConfig(total_steps=%(steps)d, warmup_steps=1, base_lr=%(lr)r,
                       schedule="cosine", log_every=100)
    tr = T.Trainer(cfg, par, mesh, tc)
    tr.data_cfg = dataclasses.replace(tr.data_cfg, seq_len=%(seq)d,
                                      global_batch=%(batch)d)
    with mesh:
        params, opt, hist = tr.train(put(params, specs), opt, resume=False)
    save(params, "run/final/")
    out["run/losses"] = np.array([h["loss"] for h in hist], np.float32)


cases = {"wkv": wkv, "blocks": lambda: (blocks("float32"),
                                        blocks("bfloat16")),
         "tp1": functools.partial(grads, 1, "seq"),
         "tp4_seq": functools.partial(grads, %(tp)d, "seq"),
         "tp4_hidden": functools.partial(grads, %(tp)d, "hidden"),
         "train": train}
for name in CASES:
    cases[name]()
np.savez(OUT, **out)
with open(OUT + ".json", "w") as f:
    json.dump(dtypes, f)
print("REF_OK")
"""
# the reference's cases, in three subprocesses of about equal time (the
# tp=4 cases in two of them)
REF_RUNS = [["wkv", "blocks"], ["tp4_seq", "tp4_hidden"], ["tp1", "train"]]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the rank threads already fill the cores (under
    the suite's workers a thread pool per rank oversubscribes them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(seed, shape, scale=1.0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * scale


def _wkv_inputs(s):
    """r, k, v, logw (a mild decay: about -0.05 a position), u, s0."""
    shape = (WKV_B, WKV_H, s, WKV_DH)
    logw = -np.exp(_x(4, shape, 0.5) - 3.0)
    return [_x(1, shape), _x(2, shape), _x(3, shape), logw.astype(np.float32),
            _x(5, (WKV_H, WKV_DH), 0.5), _x(6, (WKV_B, WKV_H, WKV_DH,
                                               WKV_DH))]


def _wkv_cotangents(s):
    return (_x(7, (WKV_B, WKV_H, s, WKV_DH)),
            _x(8, (WKV_B, WKV_H, WKV_DH, WKV_DH)))


def _batch(vocab=512):
    rng = np.random.default_rng(13)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels[1, -5:] = -1                    # masked out of the mean
    return toks, labels


def _cfg(dtype="float32"):
    return dataclasses.replace(get_smoke_config(ARCH), compute_dtype=dtype)


@pytest.fixture(scope="module")
def ref(tmp_path_factory, subproc):
    """Every reference reading of the file, from ``REF_RUNS``'
    subprocesses run at once (a case spends most of its time tracing and
    compiling, which threads of one process would serialise)."""
    d = tmp_path_factory.mktemp("rwkv_train")
    toks, labels = _batch()
    arrays = {"tokens": toks, "labels": labels,
              "blk/x": _x(30, (BLK_B, BLK_S, 128)),
              "blk/w": _x(31, (BLK_B, BLK_S, 128))}
    for s, _ in WKV_CASES:
        arrays.update({f"wkv/{s}/{n}": a
                       for n, a in zip(WKV_NAMES, _wkv_inputs(s))})
        arrays[f"wkv/{s}/wy"], arrays[f"wkv/{s}/ws"] = _wkv_cotangents(s)
    np.savez(d / "in.npz", **arrays)
    code = (_REF % {"wkv_cases": WKV_CASES, "wkv_names": WKV_NAMES,
                    "chunk": BLK_CHUNK, "tp": TP, "steps": STEPS, "lr": LR,
                    "seq": SEQ, "batch": BATCH}
            ).replace("IN)", repr(str(d / "in.npz")) + ")")

    def run(i):
        path = str(d / f"ref{i}.npz")
        one = code.replace("CASES", repr(REF_RUNS[i])).replace(
            "OUT", repr(path))
        assert "REF_OK" in subproc(one, n_devices=TP), REF_RUNS[i]
        return path
    with ThreadPoolExecutor(len(REF_RUNS)) as pool:
        paths = list(pool.map(run, range(len(REF_RUNS))))
    out, dtypes = {}, {}
    for path in paths:
        out.update(np.load(path))
        with open(path + ".json") as f:
            dtypes.update(json.load(f))
    return {"out": out, "dtypes": dtypes}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _np(t):
    return t.detach().float().cpu().numpy()


def _want(out, prefix):
    return {k[len(prefix):]: v for k, v in out.items()
            if k.startswith(prefix)}


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


def _torch_batch():
    toks, labels = _batch()
    return {"tokens": torch.from_numpy(toks),
            "labels": torch.from_numpy(labels)}


# ---------------------------------------------------------------------------
# the wkv under grad
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s,chunk", WKV_CASES)
def test_wkv_grads_match_reference(ref, s, chunk):
    """The grads of r, k, v, logw, u and s0 through ``_WKV`` against
    ``jax.grad`` of the reference's chunks chained."""
    out = ref["out"]
    ts = [torch.from_numpy(a).requires_grad_() for a in _wkv_inputs(s)]
    wy, ws = (torch.from_numpy(a) for a in _wkv_cotangents(s))
    y, st = TR.wkv(*ts, chunk=chunk)
    got = torch.autograd.grad((y * wy).sum() + (st * ws).sum(), ts)
    for name, g in zip(WKV_NAMES, got):
        assert g.dtype == torch.float32
        assert _rel(_np(g), out[f"wkv/{s}/grad/{name}"]) <= F32_RTOL, (
            s, chunk, name)


@pytest.mark.parametrize("s,chunk", WKV_CASES)
def test_wkv_forward_under_grad_is_the_serving_loop(s, chunk):
    """The output and the final state under grad equal the serving loop's
    (the same inputs under ``no_grad``) bit for bit."""
    args = [torch.from_numpy(a) for a in _wkv_inputs(s)]
    with torch.no_grad():
        y0, s0 = TR.wkv(*args, chunk=chunk)
    y, st = TR.wkv(*(a.clone().requires_grad_() for a in args), chunk=chunk)
    assert y.requires_grad and st.requires_grad
    assert torch.equal(y.detach(), y0) and torch.equal(st.detach(), s0)


def _saved(fn):
    """(fn's result, every tensor autograd saved while it ran)."""
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, saved


@pytest.mark.parametrize("s,chunk", [(64, 16), (40, 16)])
def test_wkv_saves_inputs_and_chunk_states(s, chunk):
    """``_WKV`` saves its inputs and the fp32 state carried into each
    chunk, [n_chunks, B, H, dh, dh], and nothing else."""
    ts = [torch.from_numpy(a).requires_grad_() for a in _wkv_inputs(s)]
    _, saved = _saved(lambda: TR.wkv(*ts, chunk=chunk))
    n_chunks = s // TR._chunk_len(s, chunk)
    inputs = sum(t.numel() * t.element_size() for t in ts)
    states = n_chunks * WKV_B * WKV_H * WKV_DH * WKV_DH * 4
    assert sum(t.numel() * t.element_size() for t in saved) == (inputs
                                                                 + states)
    assert saved[-1].shape == (n_chunks, WKV_B, WKV_H, WKV_DH, WKV_DH)


# ---------------------------------------------------------------------------
# the blocks under grad
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,rtol", [("float32", F32_RTOL),
                                        ("bfloat16", BF16_RTOL)])
@pytest.mark.parametrize("which", ["time", "channel"])
def test_block_grads_match_reference(ref, which, dtype, rtol):
    """Every leaf's grad and the input's through ``rwkv_time_train`` (5
    chunks of 8) and ``rwkv_channel_train``, each in its own dtype:
    ``u_bonus`` and ``dec_base`` fp32 in a bf16 model, as the
    reference's."""
    out, dtypes = ref["out"], ref["dtypes"]
    cfg = _cfg(dtype)
    tdt = getattr(torch, dtype)
    model = convert.params_from_jax(_tree(out, f"blk/{dtype}/params/"), cfg,
                                    dtype=tdt, device="cpu", trainable=True)
    part = model.layers[0].mixer if which == "time" else model.layers[0].ffn
    xt = torch.from_numpy(_x(30, (BLK_B, BLK_S, cfg.d_model))).to(
        tdt).requires_grad_()
    w = torch.from_numpy(_x(31, (BLK_B, BLK_S, cfg.d_model)))
    if which == "time":
        y = TR.rwkv_time_train(part, xt, TPContext(), cfg, chunk=BLK_CHUNK)
    else:
        y = TR.rwkv_channel_train(part, xt, TPContext(), cfg)
    (y.float() * w).sum().backward()
    pre = f"blk/{dtype}/{which}/"
    assert xt.grad.dtype == tdt
    assert _rel(_np(xt.grad), out[pre + "dx"]) <= rtol
    want = _want(out, pre + "grad/")
    assert sorted(part) == sorted(want)
    for k, t in part.items():
        assert str(t.grad.dtype)[6:] == dtypes[pre + "grad/" + k], k
        assert _rel(_np(t.grad), want[k]) <= rtol, (which, dtype, k)
    if which == "time":
        assert part["u_bonus"].grad.dtype == torch.float32
        assert part["dec_base"].grad.dtype == torch.float32


def test_blocks_backward_reaches_every_leaf():
    """The time-mix then the channel-mix under grad, from the port's own
    init: the backward gives every leaf of both blocks a nonzero grad
    (``u_bonus``, ``dec_base``, ``ln_x`` and ``w_dec1`` among them)."""
    cfg = _cfg()
    model = TM.init_model(cfg, ParallelConfig(), dtype=torch.float32,
                          device="cpu", trainable=True)
    mixer, chan = model.layers[0].mixer, model.layers[0].ffn
    xt = torch.randn(BLK_B, BLK_S, cfg.d_model, requires_grad=True)
    y = TR.rwkv_channel_train(chan, TR.rwkv_time_train(
        mixer, xt, TPContext(), cfg, chunk=BLK_CHUNK), TPContext(), cfg)
    y.square().sum().backward()
    for part in (mixer, chan):
        for k, t in part.items():
            assert t.grad is not None and bool(t.grad.abs().sum() > 0), k


# ---------------------------------------------------------------------------
# the loss and every leaf's grad
# ---------------------------------------------------------------------------
def _assert_grads(got_named, cfg, want_flat, rank, what, rtol=F32_RTOL):
    got = _flat(convert.to_jax_tree(got_named, cfg))
    assert sorted(got) == sorted(want_flat)
    for key, want in want_flat.items():
        assert _rel(got[key], want[rank]) <= rtol, (what, key, rank)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_grads_tp1_match_reference(ref, remat):
    """The loss and every leaf's grad at tp=1 (both RWKV layers, the tied
    embedding), with and without remat."""
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


@pytest.mark.parametrize("mode,layout", [(m, lay) for m in MODES
                                         for lay in LAYOUTS],
                         ids=[f"{m}-{lay}" for m in MODES for lay in LAYOUTS])
def test_loss_and_grads_tp4_match_reference(ref, mode, layout):
    """Every rank's loss and grads at tp=4, before the trainer's psum of
    the model-replicated leaves (``w_dec1``, ``ln_x``, the channel-mix's
    ``w_r``, the mixes and norms: each rank's partial) and after it,
    against the reference's run in the same layout; and the
    canonical grads / 4 against the reference's tp=1 grads."""
    out = ref["out"]
    cfg = _cfg()
    par = ParallelConfig(tp=TP, overlap_mode=mode,
                         scatter_axis="hidden" if layout == "hidden"
                         else "auto")
    ranks = convert.rank_params_from_jax(
        _tree(out, f"{TP}/{layout}/params/"), cfg, TP, dtype=torch.float32,
        device="cpu", trainable=True)
    group = RankGroup(TP, "cpu", timeout_s=60)
    ctx = TT.make_ctx(cfg, par, group)
    assert ctx.seq_sharded == (layout == "seq")
    batch = _torch_batch()

    def step(p):
        loss, grads = TT.loss_and_grads(p, batch, ctx, cfg, par)
        done = TT.complete_grads(dict(grads), TM.replicated_leaves(cfg, p),
                                 group)
        return loss, grads, done

    outs = group.spmd(step, [(p,) for p in ranks])
    want = float(out[f"{TP}/{layout}/loss"])
    what = f"{mode} {layout}"
    for r, (loss, grads, done) in enumerate(outs):
        assert abs(loss.item() - want) <= LOSS_RTOL * abs(want), (what, r)
        _assert_grads(grads, cfg, _want(out, f"{TP}/{layout}/grads/"), r,
                      what)
        _assert_grads(done, cfg, _want(out, f"{TP}/{layout}/gradsum/"), r,
                      what)
    g4 = TM.canonical_leaves(TM.gather_rank_leaves(
        [done for _, _, done in outs], cfg, ranks[0]), cfg, TP, grads=True)
    rank0 = {k: v[0] for k, v in _want(out, "1/seq/grads/").items()}
    one = convert.params_from_jax(_tree(rank0, ""), cfg,
                                  dtype=torch.float32, device="cpu")
    c1 = TM.canonical_leaves(dict(one.named_parameters()), cfg, 1,
                             grads=True)
    assert sorted(g4) == sorted(c1)
    for n in c1:
        assert _rel(g4[n].numpy() / TP, c1[n].numpy()) <= F32_RTOL, (what,
                                                                     n)


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------
def _tc(steps, ckpt=None):
    return TT.TrainConfig(total_steps=steps, warmup_steps=1, base_lr=LR,
                          schedule="cosine", checkpoint_dir=ckpt,
                          checkpoint_every=steps, log_every=100)


def _trainer(par, steps=STEPS, dtype="float32", ckpt=None):
    tr = TT.Trainer(_cfg(dtype), par, _tc(steps, ckpt), device="cpu",
                    dtype=getattr(torch, dtype))
    tr.data_cfg = dataclasses.replace(tr.data_cfg, seq_len=SEQ,
                                      global_batch=BATCH)
    return tr


def _final(tr, params):
    return _flat(convert.to_jax_tree(
        tr.global_leaves([dict(p.named_parameters()) for p in params]),
        tr.cfg))


def _assert_run(got_losses, have, start, want_losses, want):
    """Losses, final leaves and their change against another run's."""
    got = np.array(got_losses)
    assert all(map(math.isfinite, got))
    np.testing.assert_allclose(got, want_losses, rtol=LOSS_RTOL, atol=0)
    assert sorted(have) == sorted(want)
    for key, w in want.items():
        assert _rel(have[key], w) <= PARAM_RTOL, key
        assert _rel(have[key] - start[key], w - start[key]) <= UPDATE_RTOL, \
            key


def test_trainer_three_steps_match_reference(ref):
    """Three steps of the port's Trainer at tp=4 in flux on the
    reference's loss trajectory (its xla run), its final weights and their
    change."""
    out = ref["out"]
    tr = _trainer(ParallelConfig(tp=TP, overlap_mode="flux"))
    init = _tree(out, "run/init/")
    params = convert.rank_params_from_jax(init, tr.cfg, TP,
                                          dtype=torch.float32, device="cpu",
                                          trainable=True)
    params, _, hist = tr.train(params, [tr.init_opt(p) for p in params])
    _assert_run([h["loss"] for h in hist], _final(tr, params), _flat(init),
                out["run/losses"], _flat(_tree(out, "run/final/")))


def test_zero3_step_matches_dp1(ref):
    """One step at dp=2 x tp=2 under ZeRO-3 in flux (each layer gathers
    its flagged leaves over the data group) against the same step at
    dp=1, tp=1 on the same weights and global batch: the loss (also the
    reference's step 0), every final leaf and its change."""
    out = ref["out"]
    init = _tree(out, "1/seq/params/")
    runs = {}
    for name, par in (("dp1", ParallelConfig()),
                      ("zero3", ParallelConfig(tp=2, dp=2, zero3=True,
                                               overlap_mode="flux"))):
        tr = _trainer(par, steps=1)
        full = convert.params_from_jax(init, tr.cfg, dtype=torch.float32,
                                       device="cpu", trainable=True)
        params = tr.shard(full)
        opt = [tr.init_opt(p, r) for r, p in enumerate(params)]
        params, _, hist = tr.train(params, opt)
        runs[name] = ([h["loss"] for h in hist], _final(tr, params))
    flagged = TM.zero3_leaves(_cfg(), ParallelConfig(tp=2, dp=2, zero3=True))
    assert {"layers.0.mixer.w_r", "layers.1.ffn.w_k"} <= set(flagged)
    np.testing.assert_allclose(runs["dp1"][0][0], out["run/losses"][0],
                               rtol=LOSS_RTOL)
    _assert_run(runs["zero3"][0], runs["zero3"][1], _flat(init),
                runs["dp1"][0], runs["dp1"][1])


def test_bf16_trainer_keeps_rwkv_fp32_leaves(tmp_path, monkeypatch):
    """In a bf16 model under AdamW (fp32 moments) at tp=2: every time-mix's
    ``u_bonus`` and ``dec_base`` stay fp32 leaves with fp32 grads and
    moments and move with the steps (2: the first, in warmup, has lr 0);
    every other leaf stays bf16; the checkpoint after step 2 restores
    them, their dtypes and the moments bit for bit."""
    par = ParallelConfig(tp=2, overlap_mode="flux")
    tr = _trainer(par, steps=2, dtype="bfloat16", ckpt=str(tmp_path))
    params, opt = tr.init_state()
    start = {n: t.detach().clone() for n, t in params[0].named_parameters()}
    fp32 = {n for n in start if n.split(".")[-1] in ("u_bonus", "dec_base")}
    assert len(fp32) == 2 * tr.cfg.num_layers
    seen = {}

    def keep(grads):
        seen.update({n: g.dtype for n, g in grads.items() if n in fp32})
        return grads
    complete = TT.complete_grads
    monkeypatch.setattr(TT, "complete_grads",
                        lambda g, *a: keep(complete(g, *a)))
    params, opt, hist = tr.train(params, opt)
    assert all(math.isfinite(h["loss"]) for h in hist)
    assert seen and set(seen.values()) == {torch.float32}
    for n, t in params[0].named_parameters():
        assert t.dtype == (torch.float32 if n in fp32 else torch.bfloat16), n
        if n in fp32:
            assert not torch.equal(t.detach(), start[n]), n
    for r in range(tr.n_ranks):
        for key in ("mu", "nu"):
            assert all(m.dtype == torch.float32
                       for m in opt[r][key].values())
    assert fp32 <= set(opt[0]["mu"])
    again = _trainer(par, steps=2, dtype="bfloat16", ckpt=str(tmp_path))
    p2, _ = again.init_state()
    opt2 = again.restore(p2)
    assert again.step == 2
    for r in range(again.n_ranks):
        got = dict(p2[r].named_parameters())
        for n, t in params[r].named_parameters():
            assert got[n].dtype == t.dtype and torch.equal(got[n], t), n
        for key in ("mu", "nu"):
            for n in fp32 & set(opt[r][key]):
                assert torch.equal(opt2[r][key][n], opt[r][key][n]), n


@pytest.mark.parametrize("argv", [[], ["--tp", "2", "--mode", "flux"]],
                         ids=["tp1", "tp2"])
def test_train_cli_trains_rwkv_smoke(capsys, argv):
    """The training CLI on the smoke config (2 layers, bf16) at tp=1 and
    tp=2, with its own remat for this arch ("none": rwkv6_3b is not one
    of the big archs)."""
    from repro_torch.launch import train as LT
    tr, hist = LT.main(["--arch", ARCH, "--smoke", "--steps", "2",
                        "--batch", "4", "--seq", "64", "--device", "cpu",
                        *argv])
    assert len(hist) == 2 and tr.step == 2
    assert all(math.isfinite(h["loss"]) for h in hist)
    assert tr.par.remat == "none"
    text = capsys.readouterr().out
    assert "2 steps at tp=" in text and "failures 0" in text


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_gpu_wkv_grads_match_cpu():
    """The wkv's backward on the card (plain PyTorch, as on the CPU)
    against the CPU's, 8 heads of 64 over 4 chunks of 64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    shape = (2, 8, 256, 64)
    args = [torch.from_numpy(a) for a in (
        _x(1, shape), _x(2, shape), _x(3, shape),
        -np.exp(_x(4, shape, 0.5) - 3.0).astype(np.float32),
        _x(5, (8, 64), 0.5), _x(6, (2, 8, 64, 64)))]
    wy, ws = _x(7, shape), _x(8, (2, 8, 64, 64))
    got = []
    for dev in ("cpu", "cuda"):
        ts = [a.to(dev).requires_grad_() for a in args]
        y, st = TR.wkv(*ts, chunk=64)
        got.append(torch.autograd.grad(
            (y * torch.from_numpy(wy).to(dev)).sum()
            + (st * torch.from_numpy(ws).to(dev)).sum(), ts))
    for name, gc, gg in zip(WKV_NAMES, *got):
        assert _rel(_np(gg), _np(gc)) <= F32_RTOL, name

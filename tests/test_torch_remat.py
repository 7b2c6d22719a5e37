"""Remat (``ParallelConfig.remat``): a checkpointed block recomputes its
activations in the backward, and the grads do not change.

At tp=1 a block is ``torch.utils.checkpoint``; at tp>1 it is one entry on
the rank's ``SeamTape`` whose backward re-runs the block, its exchanges
included, on the rank's own thread (``core.overlap.remat``).  Held, on
the minicpm_2b and codeqwen15_7b smoke configs with fp32 parameters and
compute (batch 2 x 64):

* against the port without remat: the loss and every leaf's grad at tp=1
  ("selective" and "full") and on every rank at tp=4 in every mode and
  both residual layouts, within 1e-6 relative (the same arithmetic; on
  the CPU the grads come out equal);
* against the reference's ``remat="full"`` (``jax.checkpoint`` of every
  scanned block), run once for the file in one subprocess with 4 forced
  host devices under ``shard_map`` in xla mode: the loss within 1e-5
  relative, each leaf's grad within relative L2 1e-4
  (``tests/test_torch_train_model.py``'s tolerances), at tp=1 and on every
  rank at tp=4.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert, dist
from repro_torch.configs.base import ParallelConfig, get_smoke_config
from repro_torch.core import overlap as tov
from repro_torch.data import pipeline as tdata
from repro_torch.models import model as TM
from repro_torch.runtime import trainer as TT

TP = 4
B, S = 2, 64
MODES = ["xla", "decomposed", "flux", "decomposed_bidir"]
ARCHS = ["minicpm_2b", "codeqwen15_7b"]
SAME_RTOL = 1e-6
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
cfg = dataclasses.replace(get_smoke_config("minicpm_2b"),
                          compute_dtype="float32")
for tp in (1, 4):
    par = ParallelConfig(tp=tp, dp=1, remat="full")
    mesh = Mesh(np.array(jax.devices()[:tp]).reshape(1, tp),
                ("data", "model"))
    params = M.init_model(jax.random.PRNGKey(0), cfg, par, dtype=jnp.float32)
    specs = M.param_specs(cfg, par, params)
    ranked = jax.tree.map(lambda _: P("model"), params)
    ctx = TPContext(axis="model", mode="xla")

    def body(p, t, l):
        loss, g = jax.value_and_grad(lambda q: M.forward_loss(
            q, {"tokens": t, "labels": l}, ctx, cfg, par))(p)
        return loss, jax.tree.map(lambda a: a[None], g)

    f = jax.jit(functools.partial(
        shard_map, mesh=mesh, in_specs=(specs, P(), P()),
        out_specs=(P(), ranked), check_vma=False)(body))
    loss, g = f(params, toks, labels)
    out[f"{tp}/loss"] = np.asarray(loss)
    save(params, f"{tp}/params/")
    save(g, f"{tp}/grads/")
np.savez(OUT, **out)
print("REF_OK")
"""


def _batch():
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 512, (B, S)).astype(np.int32)
    labels = rng.integers(0, 512, (B, S)).astype(np.int32)
    labels[1, -5:] = -1
    return toks, labels


def _torch_batch():
    toks, labels = _batch()
    return {"tokens": torch.from_numpy(toks),
            "labels": torch.from_numpy(labels)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory, subproc):
    d = tmp_path_factory.mktemp("remat")
    toks, labels = _batch()
    np.savez(d / "in.npz", tokens=toks, labels=labels)
    code = _REF.replace("IN)", repr(str(d / "in.npz")) + ")").replace(
        "OUT,", repr(str(d / "out.npz")) + ",")
    assert "REF_OK" in subproc(code, n_devices=TP)
    return dict(np.load(d / "out.npz"))


def _cfg(arch, **kw):
    return dataclasses.replace(get_smoke_config(arch),
                               compute_dtype="float32", **kw)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _same(got, want):
    assert sorted(got) == sorted(want)
    for n in want:
        assert _rel(got[n].detach().numpy(),
                    want[n].detach().numpy()) <= SAME_RTOL, n


def _tp1(cfg, par, params):
    return TT.loss_and_grads(params, _torch_batch(), TT.make_ctx(cfg, par),
                             cfg, par)


def _tp4(cfg, par, ranks, count=None):
    """Every rank's (loss, grads); ``count`` collects the number of remat
    entries on each rank's tape."""
    group = dist.RankGroup(TP, "cpu", timeout_s=60)
    ctx = TT.make_ctx(cfg, par, group)
    batch = _torch_batch()

    def step(p):
        tape, loss = TT.forward_on_tape(p, batch, ctx, cfg, par)
        if count is not None:
            count.append(sum(isinstance(e[0], tov._RematSeam)
                             for e in tape.entries))
        return loss.detach(), TT.grads_from_tape(p, tape, loss)

    return group.spmd(step, [(p,) for p in ranks])


@pytest.mark.parametrize("remat", ["selective", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_grads_equal_plain_at_tp1(arch, remat):
    cfg = _cfg(arch)
    params = TM.init_model(cfg, ParallelConfig(), seed=0,
                           dtype=torch.float32, device="cpu", trainable=True)
    loss0, g0 = _tp1(cfg, ParallelConfig(), params)
    loss1, g1 = _tp1(cfg, ParallelConfig(remat=remat), params)
    assert abs(loss1.item() - loss0.item()) <= SAME_RTOL * loss0.item()
    _same(g1, g0)


@pytest.mark.parametrize("scatter_axis", ["seq", "hidden"])
@pytest.mark.parametrize("mode", MODES)
def test_remat_grads_equal_plain_at_tp4(mode, scatter_axis):
    """Every rank's loss and grads; each block after the leading dense
    layer is one remat entry on the rank's tape."""
    cfg = _cfg("minicpm_2b", num_layers=3, leading_dense_layers=1)
    par = ParallelConfig(tp=TP, overlap_mode=mode, fuse_w13=True,
                         scatter_axis=scatter_axis)
    full = TM.init_model(cfg, par, seed=0, dtype=torch.float32,
                         device="cpu", trainable=True)
    ranks = [TM.shard_params(full, r, TP, cfg) for r in range(TP)]
    plain = _tp4(cfg, par, ranks)
    count = []
    rem = _tp4(cfg, dataclasses.replace(par, remat="full"), ranks, count)
    assert count == [cfg.num_layers - 1] * TP
    for (l0, g0), (l1, g1) in zip(plain, rem):
        assert abs(l1.item() - l0.item()) <= SAME_RTOL * l0.item()
        _same(g1, g0)


def test_remat_under_grad_without_a_tape_raises_and_runs_without_grad():
    """At tp>1 a checkpointed block under grad needs the rank's tape (its
    recompute exchanges with the other ranks); without grad it is the
    block's forward."""
    g = dist.RankGroup(TP, "cpu", timeout_s=10)
    op = tov.FusedOp("ag", axis=g, mode="xla")
    w = torch.ones((8, 4), requires_grad=True)

    def block(x):
        return op(x, w)

    with pytest.raises(dist.RankGroupError) as err:
        g.spmd(lambda: tov.remat(block, torch.ones((1, 2, 8)), g, [w]),
               [()] * TP)
    assert "SeamTape" in str(err.value.__cause__)

    def no_grad():
        with torch.no_grad():
            return tov.remat(block, torch.ones((1, 2, 8)), g, [w])
    assert g.spmd(no_grad, [()] * TP)[0].shape == (1, 8, 4)


def test_remat_rejects_an_unknown_value():
    with pytest.raises(ValueError, match="remat"):
        TM.check_trainable(_cfg("minicpm_2b"), ParallelConfig(remat="all"))


def _tree(flat, prefix):
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


def _assert_ref(loss, grads, cfg, ref, tp, rank):
    want = float(ref[f"{tp}/loss"])
    assert abs(loss.item() - want) <= LOSS_RTOL * abs(want)
    got = _flat(convert.to_jax_tree(grads, cfg))
    pre = f"{tp}/grads/"
    wants = {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}
    assert sorted(got) == sorted(wants)
    for key, w in wants.items():
        assert _rel(got[key], w[rank]) <= GRAD_RTOL, (key, rank)


@pytest.mark.parametrize("tp", [1, TP])
def test_remat_full_matches_reference(ref, tp):
    cfg = _cfg("minicpm_2b")
    par = ParallelConfig(tp=tp, overlap_mode="decomposed", remat="full")
    ranks = convert.rank_params_from_jax(
        _tree(ref, f"{tp}/params/"), cfg, tp, dtype=torch.float32,
        device="cpu", trainable=True)
    if tp == 1:
        outs = [_tp1(cfg, par, ranks[0])]
    else:
        outs = _tp4(cfg, par, ranks)
    for r, (loss, grads) in enumerate(outs):
        _assert_ref(loss, grads, cfg, ref, tp, r)


def test_remat_trainer_steps_equal_plain():
    """Three trainer steps at tp=4 in flux with and without remat give the
    same losses and weights."""
    cfg = _cfg("minicpm_2b")

    def run(remat):
        tr = TT.Trainer(cfg, ParallelConfig(tp=TP, overlap_mode="flux",
                                            remat=remat),
                        TT.TrainConfig(total_steps=3, warmup_steps=1,
                                       base_lr=1e-3, log_every=100),
                        device="cpu", dtype=torch.float32)
        tr.data_cfg = tdata.DataConfig(cfg.vocab_size, S, B)
        params, _, hist = tr.train()
        return [h["loss"] for h in hist], params

    l0, p0 = run("none")
    l1, p1 = run("full")
    np.testing.assert_allclose(l1, l0, rtol=SAME_RTOL)
    for a, b in zip(p0, p1):
        _same(dict(b.named_parameters()), dict(a.named_parameters()))


@pytest.mark.gpu
def test_gpu_remat_flux_grads_and_launches():
    """bf16 on the card, tp=4 in flux: with remat the grads are the plain
    backward's within relative L2 2e-2, and the backward launches each
    fused kernel 2L more times a rank (the blocks' recompute)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the fused kernels)")
    from repro_torch.kernels import ag_gemm as AG
    from repro_torch.kernels import gemm_rs as RS
    cfg = get_smoke_config("minicpm_2b")
    par = ParallelConfig(tp=TP, overlap_mode="flux", fuse_w13=True)
    full = TM.init_model(cfg, par, seed=0, device="cuda", trainable=True)
    ranks = [TM.shard_params(full, r, TP, cfg) for r in range(TP)]
    group = dist.RankGroup(TP, "cuda", timeout_s=60)
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             tdata.batch_at(tdata.DataConfig(cfg.vocab_size, 128, 4),
                            0).items()}
    launched, grads = {}, {}
    for remat in ("none", "full"):
        p = dataclasses.replace(par, remat=remat)
        ctx = TT.make_ctx(cfg, p, group)
        outs = group.spmd(lambda q: TT.forward_on_tape(q, batch, ctx, cfg,
                                                       p),
                          [(q,) for q in ranks])
        torch.cuda.synchronize()
        before = (AG.ag_gemm.launches, RS.gemm_rs.launches)
        grads[remat] = group.spmd(TT.grads_from_tape,
                                  [(q, t, l) for q, (t, l) in
                                   zip(ranks, outs)])
        torch.cuda.synchronize()
        launched[remat] = (AG.ag_gemm.launches - before[0],
                           RS.gemm_rs.launches - before[1])
    extra = 2 * cfg.num_layers * TP
    assert launched["full"] == (launched["none"][0] + extra,
                                launched["none"][1] + extra), launched
    for g0, g1 in zip(grads["none"], grads["full"]):
        for n in g0:
            assert _rel(g1[n].float().cpu().numpy(),
                        g0[n].float().cpu().numpy()) <= 2e-2, n

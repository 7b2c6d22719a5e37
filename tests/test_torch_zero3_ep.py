"""ZeRO-3, the dedicated expert-parallel axis, experts over (data, model),
the GPipe pipeline and the production presets against the reference.

The reference runs once for the file, in one subprocess with 4 forced
host devices: its ``runtime.trainer.Trainer`` for 3 steps (warmup 1, lr
1e-3, fp32 weights drawn by its ``init_model``, fp32 moments placed by
``adamw.opt_state_specs``) on
  codeqwen15_7b smoke with ``d_ff=512`` (batch 4 x 64) under ``zero3`` at
  (dp 2, tp 2) in decomposed and (dp 2, tp 1) in xla;
  the deepseek_v3_671b smoke config (batch 4 x 64) under ``zero3`` at
  (dp 2, tp 2) in decomposed;
  the deepseek smoke config with ``d_ff=512`` and a drop-free capacity
  factor of 16 (batch 4 x 32, the setup of ``tests/test_moe_a2a.py``'s
  ep-axis run) at (ep 2, dp 1, tp 2) and at (dp 2, tp 2) with
  ``ep_over_dp``;
then ``zero3_flags`` and the unstacked layers' PartitionSpecs of every
port arch (full size) under ZeRO-3, a dedicated ep axis and
``ep_over_dp``; ``production_parallel`` for every port arch, kind and
pod count; the multi-axis ``a2a_exchange`` oracle of
``tests/test_moe_a2a.py`` on a (data, model) mesh; the 4-stage GPipe case
of ``tests/test_pipeline.py``; and ``ep_over_dp`` under the replicated
layout, which raises.

The port runs the same runs on the CPU from the same weights
(``convert``) as the threads of a ``dist.RankMesh``, and the ZeRO-3
(2, 2) run in flux against the reference's decomposed one.  Tolerances
(fp32), those of ``tests/test_torch_dp.py``: each step's loss within
1e-5 relative, every final leaf within relative L2 1e-5, each leaf's
change over the run within 1e-3; GPipe within 1e-5 absolute.  Without
the reference: the port's synced ZeRO-3 grads are dp x its ZeRO-1 grads
on the flagged leaves and equal on the others, as the reference's are;
under ``ep_over_dp`` the routed experts' grads are dp x the experts-over-
model layout's, the others equal; a ZeRO-3 checkpoint written at (2, 2)
restores at (1, 2) bit for bit; between a ZeRO-3 layer's forward and its
backward its gathered copies hold no storage.  The ``gpu`` case runs the
two-axis view's exchange on the card.
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.checkpoint.checkpointer import host_leaves
from repro_torch.configs.base import (ARCH_IDS, ParallelConfig, get_config,
                                      get_smoke_config, train_schedule)
from repro_torch.core import overlap as tov
from repro_torch.dist import RankGroupError, RankMesh
from repro_torch.launch.mesh import dp_axes, make_mesh
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TA
from repro_torch.parallel.pipeline import bubble_fraction, pipeline_forward
from repro_torch.runtime import trainer as TT

STEPS, LR = 3, 1e-3
LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-5
UPDATE_RTOL = 1e-3
PIPE_ATOL = 1e-5
DP_FACTOR_RTOL = 1e-5
# the reference's runs: (name, config, pods, ep, dp, tp, mode, zero3,
# ep_over_dp, batch, seq)
RUNS = [("z3-codeqwen-2x2", "codeqwen", 1, 1, 2, 2, "decomposed", True,
         False, 4, 64),
        ("z3-codeqwen-2x1", "codeqwen", 1, 1, 2, 1, "xla", True, False, 4,
         64),
        ("z3-deepseek-2x2", "deepseek", 1, 1, 2, 2, "decomposed", True,
         False, 4, 64),
        ("ep2-deepseek", "deepseek_ep", 1, 2, 1, 2, "decomposed", False,
         False, 4, 32),
        ("epdp-deepseek", "deepseek_ep", 1, 1, 2, 2, "decomposed", False,
         True, 4, 32)]
# the port's runs: (reference run, the port's mode)
PORT_RUNS = [(0, "decomposed"), (0, "flux"), (1, "xla"), (2, "decomposed"),
             (3, "decomposed"), (4, "decomposed")]
# the layouts whose specs and flags the port restates leaf by leaf
SPEC_PARS = {"zero3": dict(tp=4, dp=2, zero3=True),
             "ep": dict(tp=2, dp=2, ep=2),
             "ep_over_dp": dict(tp=2, dp=2, ep_over_dp=True, zero3=True)}
PRESET_KINDS = ("train", "serve")
PIPE_STAGES, PIPE_MICRO = 4, 4

_REF = r"""
import dataclasses, json
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import compat
from repro.configs.base import get_config, get_smoke_config, ParallelConfig
from repro.core import overlap
from repro.launch.mesh import make_mesh
from repro.launch.presets import production_parallel
from repro.models import model as M
from repro.optim import adamw
from repro.parallel.pipeline import pipeline_forward, bubble_fraction
from repro.runtime import trainer as T

out = {}
meta = {}


def save(tree, prefix):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in flat:
        key = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                       for q in path)
        out[prefix + key] = np.asarray(leaf, np.float32)


def config(name):
    arch = {"codeqwen": "codeqwen15_7b"}.get(name, "deepseek_v3_671b")
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    if name in ("codeqwen", "deepseek_ep"):
        cfg = dataclasses.replace(cfg, d_ff=512)
    if name == "deepseek_ep":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0))
    return cfg


def state(cfg, par, mesh):
    params = M.init_model(jax.random.PRNGKey(0), cfg, par, dtype=jnp.float32)
    if cfg.qkv_bias:   # the reference inits the bias to zero
        mix = params["periods"][0]["mixer"]
        rng = np.random.default_rng(1)
        mix["bqkv"] = jnp.asarray(
            0.1 * rng.standard_normal(mix["bqkv"].shape), jnp.float32)
    init = params
    specs = M.param_specs(cfg, par, params)
    ospecs = adamw.opt_state_specs(specs, params, par.dp, par.tp,
                                   ep=max(par.ep, 1))
    put = lambda tree, sp: jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), tree, sp,
        is_leaf=lambda x: isinstance(x, P))
    opt = adamw.init_opt_state(params)
    opt = {"mu": put(opt["mu"], ospecs["mu"]),
           "nu": put(opt["nu"], ospecs["nu"]), "count": opt["count"]}
    return init, put(params, specs), opt


for (name, cname, pods, ep, dp, tp, mode, zero3, epdp, batch, seq,
     schedule) in %(runs)r:
    cfg = config(cname)
    par = ParallelConfig(tp=tp, dp=dp, pods=pods, ep=ep, overlap_mode=mode,
                         zero3=zero3, ep_over_dp=epdp)
    mesh = make_mesh(pods, dp, tp, ep=ep)
    init, params, opt = state(cfg, par, mesh)
    save(init, f"{name}/init/")
    tc = T.TrainConfig(total_steps=%(steps)d, warmup_steps=1,
                       base_lr=%(lr)r, schedule=schedule, log_every=100)
    tr = T.Trainer(cfg, par, mesh, tc)
    tr.data_cfg = dataclasses.replace(tr.data_cfg, seq_len=seq,
                                      global_batch=batch)
    with mesh:
        params, opt, hist = tr.train(params, opt, resume=False)
    save(params, f"{name}/final/")
    out[f"{name}/losses"] = np.array([h["loss"] for h in hist], np.float32)


def spec_json(spec):
    return [None if p is None else ([p] if isinstance(p, str) else list(p))
            for p in spec]


def unstacked(cfg, par):
    ex = jax.eval_shape(lambda: M.init_model(jax.random.PRNGKey(0), cfg,
                                             par))
    specs = M.param_specs(cfg, par, ex)
    lead = cfg.leading_dense_layers
    layers = {}
    for i in range(lead):
        layers[str(i)] = specs["lead"][i]
    for pos in range(len(cfg.pattern)):
        layers["p" + str(pos)] = jax.tree.map(
            lambda s: P(*list(s)[1:]), specs["periods"][pos],
            is_leaf=lambda x: isinstance(x, P))
    flat = {}
    for key, tree in layers.items():
        for path, sp in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, P))[0]:
            flat[key + "." + ".".join(str(q.key) for q in path)] = \
                spec_json(sp)
    return flat


for arch in %(archs)r:
    cfg = get_config(arch)
    for lname, kw in %(spec_pars)r.items():
        for fuse in (False, True):
            par = ParallelConfig(fuse_w13=fuse, **kw)
            flags = M.zero3_flags(cfg, par)
            meta[f"flags/{arch}/{lname}/{fuse}"] = jax.tree.map(
                bool, flags)
            meta[f"specs/{arch}/{lname}/{fuse}"] = unstacked(cfg, par)
    for kind in %(kinds)r:
        for mp in (False, True):
            meta[f"preset/{arch}/{kind}/{mp}"] = dataclasses.asdict(
                production_parallel(cfg, multi_pod=mp, kind=kind))

# the multi-axis exchange oracle (tests/test_moe_a2a.py): block j of a
# rank's buffer is addressed to flat rank j, axis-major over (data, model)
import functools
from jax import lax
from repro.compat import shard_map
xmesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2),
                          ("data", "model"))
axes = ("data", "model")
EP, C = 4, 3


def my_rank():
    r = jnp.zeros((), jnp.int32)
    for a in axes:
        r = r * compat.axis_size(a) + lax.axis_index(a)
    return r


def exch(_):
    me = my_rank()
    x = (me * EP + jnp.arange(EP)).astype(jnp.float32)[:, None] * jnp.ones(
        (EP, C))
    return overlap.a2a_exchange(x, axes)[None]


got = jax.jit(functools.partial(
    shard_map, mesh=xmesh, in_specs=(P(),), out_specs=P(axes),
    check_vma=False)(exch))(jnp.zeros(()))
out["a2a/exchange"] = np.asarray(got)

# GPipe (tests/test_pipeline.py's case)
pmesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(%(stages)d, 1),
                          ("pod", "model"))
B, S, D = 8, 4, 16
x = jax.random.normal(jax.random.PRNGKey(0), (B, S, D))
w = jax.random.normal(jax.random.PRNGKey(1), (%(stages)d, D, D)) * 0.3


@jax.jit
@functools.partial(shard_map, mesh=pmesh,
                   in_specs=(P(None, None, None), P("pod", None, None)),
                   out_specs=P(None, None, None), check_vma=False)
def piped(xx, ww):
    def stage_fn(h, t):
        return jnp.tanh(jnp.einsum("bsd,de->bse", h, ww[0]))
    o = pipeline_forward(stage_fn, xx, "pod", num_microbatches=%(micro)d)
    me = jax.lax.axis_index("pod")
    return jax.lax.psum(jnp.where(me == %(stages)d - 1, o, 0), "pod")


out["pipe/x"] = np.asarray(x)
out["pipe/w"] = np.asarray(w)
out["pipe/out"] = np.asarray(piped(x, w))
meta["pipe/bubble"] = bubble_fraction(%(micro)d, %(stages)d)

# ep_over_dp under the replicated layout raises
cfg = config("deepseek_ep")
par = ParallelConfig(tp=2, dp=2, ep_over_dp=True, scatter_axis="hidden",
                     overlap_mode="decomposed")
mesh = make_mesh(1, 2, 2)
init, params, opt = state(cfg, par, mesh)
tr = T.Trainer(cfg, par, mesh, T.TrainConfig(total_steps=1, warmup_steps=0,
                                             log_every=100))
tr.data_cfg = dataclasses.replace(tr.data_cfg, seq_len=32, global_batch=4)
try:
    with mesh:
        tr.train(params, opt, resume=False)
    meta["hidden_ep_over_dp"] = "ran"
except NotImplementedError as e:
    meta["hidden_ep_over_dp"] = str(e)
np.savez(OUT, **out)
with open(META, "w") as f:
    json.dump(meta, f)
print("REF_OK")
"""


def _cfg(name):
    arch = {"codeqwen": "codeqwen15_7b"}.get(name, "deepseek_v3_671b")
    cfg = dataclasses.replace(get_smoke_config(arch),
                              compute_dtype="float32")
    if name in ("codeqwen", "deepseek_ep"):
        cfg = dataclasses.replace(cfg, d_ff=512)
    if name == "deepseek_ep":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0))
    return cfg


@pytest.fixture(scope="module")
def ref(tmp_path_factory, subproc):
    d = tmp_path_factory.mktemp("zero3_ep")
    runs = [r + (train_schedule(_cfg(r[1]).name),) for r in RUNS]
    code = (_REF % {"runs": runs, "steps": STEPS, "lr": LR,
                    "archs": list(ARCH_IDS), "spec_pars": SPEC_PARS,
                    "kinds": PRESET_KINDS, "stages": PIPE_STAGES,
                    "micro": PIPE_MICRO}
            ).replace("OUT,", repr(str(d / "out.npz")) + ",").replace(
        "META,", repr(str(d / "meta.json")) + ",")
    assert "REF_OK" in subproc(code, n_devices=4, timeout=900)
    with open(d / "meta.json") as f:
        meta = json.load(f)
    return {"out": dict(np.load(d / "out.npz")), "meta": meta}


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


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _par(i, mode, **kw):
    _, _, pods, ep, dp, tp, _, zero3, epdp, _, _ = RUNS[i]
    fields = dict(tp=tp, dp=dp, pods=pods, ep=ep, zero3=zero3,
                  ep_over_dp=epdp, overlap_mode=mode)
    return ParallelConfig(**{**fields, **kw})


def _trainer(i, mode, steps=STEPS, ckpt=None, mesh=None, **kw):
    name, cname = RUNS[i][:2]
    batch, seq = RUNS[i][-2:]
    cfg = _cfg(cname)
    tc = TT.TrainConfig(total_steps=steps, warmup_steps=1, base_lr=LR,
                        schedule=train_schedule(cfg.name),
                        checkpoint_dir=ckpt, checkpoint_every=2,
                        log_every=100)
    tr = TT.Trainer(cfg, _par(i, mode, **kw), tc, device="cpu",
                    dtype=torch.float32, mesh=mesh)
    tr.data_cfg = dataclasses.replace(tr.data_cfg, seq_len=seq,
                                      global_batch=batch)
    return tr


def _port_state(tr, init):
    """Every mesh rank's pieces of the reference's weights, zero
    moments."""
    full = convert.params_from_jax(init, tr.cfg, dtype=torch.float32,
                                   device="cpu", trainable=True)
    params = tr.shard(full)
    return params, [tr.init_opt(p, r) for r, p in enumerate(params)]


def _final_tree(tr, params):
    named = tr.global_leaves([dict(p.named_parameters()) for p in params])
    return _flat(convert.to_jax_tree(named, tr.cfg))


@pytest.mark.parametrize("i,mode", PORT_RUNS,
                         ids=[f"{RUNS[i][0]}-{m}" for i, m in PORT_RUNS])
def test_three_steps_match_reference_trainer(ref, i, mode):
    """Three steps of the port's Trainer on a mesh under ZeRO-3, a
    dedicated ep axis or ``ep_over_dp`` against the reference's."""
    out = ref["out"]
    name = RUNS[i][0]
    tr = _trainer(i, mode)
    init = _tree(out, f"{name}/init/")
    params, opt = _port_state(tr, init)
    params, _, hist = tr.train(params, opt)
    got = np.array([h["loss"] for h in hist])
    assert all(map(math.isfinite, got))
    np.testing.assert_allclose(got, out[f"{name}/losses"], rtol=LOSS_RTOL,
                               atol=0)
    want = _flat(_tree(out, f"{name}/final/"))
    have, start = _final_tree(tr, params), _flat(init)
    assert sorted(have) == sorted(want)
    for key, w in want.items():
        assert _rel(have[key], w) <= PARAM_RTOL, key
        assert _rel(have[key] - start[key], w - start[key]) <= UPDATE_RTOL, \
            key


def _synced_grads(tr, params, batches):
    """Step 0's grads on every rank through the trainer's completion and
    ``adamw.sync_grads``, joined into the global leaves: the data ranks'
    ZeRO-1 pieces (row shards, owned layers) and the leaves split over
    data (ZeRO-3, experts under ``ep_over_dp``) put together."""
    cfg, par, mesh = tr.cfg, tr.par, tr.group
    plan = tr.zero1(params[0])
    ctxs = [TT.make_ctx(cfg, par, mesh=mesh, rank=r)
            for r in range(mesh.size)]
    replicated = TM.replicated_leaves(cfg, None, par)

    def body(p, b):
        ctx = ctxs[mesh.rank()]
        _, g = TT.loss_and_grads(p, b, ctx, cfg, par)
        g = TT.complete_grads(g, replicated, ctx.axis)
        return TA.sync_grads(g, plan, ctx.data_group, None)

    held = mesh.spmd(body, [(p, batches[tr.shard_index(r)])
                            for r, p in enumerate(params)])
    return tr.global_leaves([TT.RankPieces(held, plan,
                                           TT.data_peers(mesh, r), r)
                             for r in range(mesh.size)])


def test_zero3_grads_are_dp_times_zero1(ref):
    """The port's synced step-0 grads under ZeRO-3 at (2, 2): each
    ZeRO-3 leaf's grad is dp x its ZeRO-1 grad (the gather's transpose
    sums the data ranks' grads, and no data mean follows, as in the
    reference), every other leaf's equals ZeRO-1's; the flagged leaves
    are codeqwen's wqkv, w1 and w3."""
    out = ref["out"]
    init = _tree(out, "z3-codeqwen-2x2/init/")
    z3 = _trainer(0, "decomposed")
    z1 = _trainer(0, "decomposed", zero3=False)
    flagged = TM.zero3_leaves(z3.cfg, z3.par)
    assert {n.split(".")[-1] for n in flagged} == {"wqkv", "w1", "w3"}
    got = {}
    for tr in (z3, z1):
        params, _ = _port_state(tr, init)
        got[tr.par.zero3] = _synced_grads(tr, params, tr.step_batch(0))
    dp = z3.par.dp
    for n, g in got[True].items():
        want = got[False][n] * (dp if n in flagged else 1)
        assert _rel(g.numpy(), want.numpy()) <= DP_FACTOR_RTOL, n


def test_ep_over_dp_expert_grads_are_dp_times_the_model_layout(ref):
    """Under ``ep_over_dp`` at (2, 2) the routed experts' synced grads are
    dp x those of experts over "model" at (2, 2) on the same weights and
    batch (their ``a2a`` backward sums both data shards' tokens and the
    reference takes no data mean of a leaf split over data); every other
    leaf's grad is equal."""
    out = ref["out"]
    init = _tree(out, "epdp-deepseek/init/")
    ed = _trainer(4, "decomposed")
    mm = _trainer(4, "decomposed", ep_over_dp=False)
    got = {}
    for tr in (ed, mm):
        params, _ = _port_state(tr, init)
        got[tr.par.ep_over_dp] = _synced_grads(tr, params, tr.step_batch(0))
    experts = {n for n in got[True] if TM._is_expert(ed.cfg, n)}
    assert experts == {"layers.1.ffn.w1", "layers.1.ffn.w3",
                       "layers.1.ffn.w2"}
    for n, g in got[True].items():
        want = got[False][n] * (ed.par.dp if n in experts else 1)
        assert _rel(g.numpy(), want.numpy()) <= DP_FACTOR_RTOL, n


def _port_layer_key(cfg, key):
    """The reference's layer key ("0.mixer.wqkv" or "p0.ffn.w1") -> the
    port's name of its first layer."""
    layer, rest = key.split(".", 1)
    if layer.startswith("p"):
        layer = str(cfg.leading_dense_layers + int(layer[1:]))
    return f"layers.{layer}.{rest}"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_flags_and_specs_equal_reference(ref, arch):
    """``zero3_flags`` and each layer leaf's mesh spec equal the
    reference's (full size) under ZeRO-3, a dedicated ep axis and
    ``ep_over_dp`` with ZeRO-3, packed and unpacked: the leaf-by-leaf
    restatement of the reference's spec-driven rules."""
    meta = ref["meta"]
    cfg = get_config(arch)
    for lname, kw in SPEC_PARS.items():
        for fuse in (False, True):
            par = ParallelConfig(fuse_w13=fuse, **kw)
            got = json.loads(json.dumps(TM.zero3_flags(cfg, par)))
            assert got == meta[f"flags/{arch}/{lname}/{fuse}"], (lname, fuse)
            specs = TM.mesh_specs(cfg, par)
            want = meta[f"specs/{arch}/{lname}/{fuse}"]
            for key, spec in want.items():
                name = _port_layer_key(cfg, key)
                have = [None if a is None else list(a) for a in specs[name]]
                assert have == spec, (lname, fuse, name)
            period = len(cfg.pattern)
            for n in specs:
                if n.startswith("layers."):
                    i = int(n.split(".")[1])
                    first = (i if i < cfg.leading_dense_layers else
                             cfg.leading_dense_layers
                             + (i - cfg.leading_dense_layers) % period)
                    key = n.replace(f"layers.{i}.", f"layers.{first}.", 1)
                    assert specs[n] == specs[key], n


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_production_parallel_equals_reference(ref, arch):
    """``launch.presets.production_parallel`` field by field for every
    kind and pod count (the reference's ``ep`` 0, no ep axis, is the
    port's 1; its ``pp`` and ``seq_shard_attn``, which the port does not
    carry, at their defaults)."""
    from repro_torch.launch.presets import production_parallel
    for kind in PRESET_KINDS:
        for mp in (False, True):
            got = dataclasses.asdict(production_parallel(
                get_config(arch), multi_pod=mp, kind=kind))
            want = dict(ref["meta"][f"preset/{arch}/{kind}/{mp}"])
            assert want.pop("pp") == 1 and not want.pop("seq_shard_attn")
            want["ep"] = max(want["ep"], 1)
            assert got == want, (kind, mp)


def test_two_axis_view_exchange_is_axis_major(ref):
    """The ("data", "model") view of a (2, 2) mesh orders its ranks
    axis-major (data · tp + model), and ``a2a_exchange`` over it equals
    the reference's multi-axis exchange: block j of a rank's result is
    what flat rank j addressed to it; exchanging twice restores it."""
    mesh = make_mesh(1, 2, 2, "cpu")
    ep, c = 4, 3

    def body(r):
        view = mesh.group(("data", "model"))
        me = view.rank()
        x = (me * ep + torch.arange(ep, dtype=torch.float32))[:, None] * \
            torch.ones((ep, c))
        got = tov.a2a_exchange(x, view)
        return me, got, tov.a2a_exchange(got, view), x

    res = mesh.spmd(body, [(r,) for r in range(4)])
    want = ref["out"]["a2a/exchange"]
    for r, (me, got, back, x) in enumerate(res):
        assert me == mesh.coord("data", r) * 2 + mesh.coord("model", r)
        np.testing.assert_array_equal(got.numpy(), want[me])
        for j in range(ep):
            assert float(got[j, 0]) == j * ep + me
        assert torch.equal(back, x)
    assert mesh.group(("data", "model"), 0) is mesh.group(("data", "model"),
                                                          3)
    assert mesh.group(("model",), 1) is mesh.group("model", 1)
    with pytest.raises(ValueError, match="no axis"):
        mesh.group(("data", "data"), 0)


def test_ep_over_dp_replicated_layout_raises(ref):
    """``ep_over_dp`` under the replicated layout raises, as the
    reference's does."""
    from repro_torch.models.ffn import EP_REPLICATED_LAYOUT
    assert "scatter_axis='seq'" in ref["meta"]["hidden_ep_over_dp"]
    tr = _trainer(4, "decomposed", scatter_axis="hidden")
    params, opt = tr.init_state()
    with pytest.raises(RankGroupError) as err:
        tr.run_step(params, opt, tr.step_batch(0))
    assert isinstance(err.value.__cause__, NotImplementedError)
    assert str(err.value.__cause__) == EP_REPLICATED_LAYOUT


def test_gpipe_matches_reference_and_sequential(ref):
    """``pipeline_forward`` over the pod view of a 4-stage mesh, 4
    microbatches: the last stage's output equals the reference's GPipe
    and the stages run one after another, within 1e-5; ``bubble_fraction``
    (4, 4) is 3/7; under grad it raises."""
    out = ref["out"]
    x = torch.from_numpy(out["pipe/x"])
    w = torch.from_numpy(out["pipe/w"])
    mesh = make_mesh(PIPE_STAGES, 1, 1, "cpu")
    assert mesh.axes == ("pod", "data", "model")

    def body(r):
        pod = mesh.group("pod")
        ws = w[pod.rank()]
        return pipeline_forward(lambda h, t: torch.tanh(h @ ws), x, pod,
                                PIPE_MICRO)

    res = mesh.spmd(body, [(r,) for r in range(PIPE_STAGES)])
    seq = x
    for i in range(PIPE_STAGES):
        seq = torch.tanh(seq @ w[i])
    last = res[-1]
    assert (last - torch.from_numpy(out["pipe/out"])).abs().max() <= \
        PIPE_ATOL
    assert (last - seq).abs().max() <= PIPE_ATOL
    assert bubble_fraction(4, 4) == pytest.approx(3 / 7, abs=1e-12)
    assert ref["meta"]["pipe/bubble"] == pytest.approx(3 / 7, abs=1e-12)

    def under_grad(r):
        pod = mesh.group("pod")
        v = x.clone().requires_grad_()
        return pipeline_forward(lambda h, t: h * 2, v, pod, PIPE_MICRO)

    with pytest.raises(RankGroupError) as err:
        mesh.spmd(under_grad, [(r,) for r in range(PIPE_STAGES)])
    assert isinstance(err.value.__cause__, NotImplementedError)


def test_zero3_checkpoint_at_2x2_restores_at_1x2(ref, tmp_path):
    """A ZeRO-3 trainer at (2, 2) checkpoints after 2 steps (the global
    tree joins the ZeRO-3 shards over data); a ZeRO-3 trainer at (1, 2)
    restores it bit for bit."""
    out = ref["out"]
    tr = _trainer(0, "decomposed", steps=4, ckpt=str(tmp_path))
    params, opt = _port_state(tr, _tree(out, "z3-codeqwen-2x2/init/"))
    hist = []
    for _ in range(2):
        opt, m = tr.run_step(params, opt, tr.step_batch(tr.step))
        hist.append(float(m["loss"]))
        tr.step += 1
    np.testing.assert_allclose(hist, out["z3-codeqwen-2x2/losses"][:2],
                               rtol=LOSS_RTOL, atol=0)
    flagged = TM.zero3_leaves(tr.cfg, tr.par)
    named = dict(params[0].named_parameters())
    full = dict(tr.shard(convert.params_from_jax(
        _tree(out, "z3-codeqwen-2x2/init/"), tr.cfg, dtype=torch.float32,
        device="cpu"))[0].named_parameters())
    assert flagged and all(named[n].shape == full[n].shape for n in named)
    tr.save(params, opt)
    tr.ckpt.wait()
    want = host_leaves(tr.checkpoint_tree(params, opt))
    one = _trainer(0, "decomposed", steps=4, ckpt=str(tmp_path),
                   mesh=make_mesh(1, 1, 2, "cpu"), dp=1)
    assert one.par.dp == 1 and one.par.zero3
    p1, _ = one.init_state()
    o1 = one.restore(p1)
    assert one.step == 2
    got = host_leaves(one.checkpoint_tree(p1, o1))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_zero3_layer_holds_only_its_shards_until_its_backward():
    """Under ZeRO-3 at (2, 1) every layer's gathered copies but the last
    layer's hold no storage once the forward is done; the tape's backward
    gathers them again, and the grads equal a run with nothing freed."""
    cfg = _cfg("codeqwen")
    par = ParallelConfig(dp=2, zero3=True, overlap_mode="xla")
    tr = TT.Trainer(cfg, par, TT.TrainConfig(), device="cpu",
                    dtype=torch.float32)
    tr.data_cfg = dataclasses.replace(tr.data_cfg, seq_len=16,
                                      global_batch=2)
    params, _ = tr.init_state()
    batches = tr.step_batch(0)
    mesh = tr.group
    held = []
    real = tov._Zero3ReleaseSeam.forward
    real_bwd = tov._Zero3ReleaseSeam.backward

    def spy(self):
        out = real(self)
        held.append(self.full)
        return out

    def body(p, b, free):
        ctx = TT.make_ctx(cfg, par, mesh=mesh)
        tape, loss = TT.forward_on_tape(p, b, ctx, cfg, par)
        sizes = None
        if free:
            sizes = [t.untyped_storage().nbytes() for full in held
                     for t in full]
        return sizes, TT.grads_from_tape(p, tape, loss)

    tov._Zero3ReleaseSeam.forward = spy
    try:
        res = mesh.spmd(body, [(p, batches[r], True)
                               for r, p in enumerate(params)])
    finally:
        tov._Zero3ReleaseSeam.forward = real
    layers = cfg.num_layers
    assert len(held) == 2 * (layers - 1)
    for sizes, _ in res:
        assert sizes and all(n == 0 for n in sizes)
    # the same step with the releases recorded as no-ops
    tov._Zero3ReleaseSeam.forward = lambda self: ((), None)
    tov._Zero3ReleaseSeam.backward = lambda self, saved, gouts: ()
    try:
        base = mesh.spmd(body, [(p, batches[r], False)
                                for r, p in enumerate(params)])
    finally:
        tov._Zero3ReleaseSeam.forward = real
        tov._Zero3ReleaseSeam.backward = real_bwd
    for (_, g), (_, h) in zip(res, base):
        for n in g:
            assert torch.equal(g[n], h[n]), n


@pytest.mark.parametrize("flag,field,value", [
    (["--zero3", "--dp", "2"], "zero3", True), (["--ep", "2"], "ep", 2)])
def test_train_cli_zero3_and_ep_train(flag, field, value):
    """``launch.train --zero3`` and ``--ep 2`` train on the CPU."""
    from repro_torch.launch import train as LT
    arch = "deepseek_v3_671b" if field == "ep" else "minicpm_2b"
    tr, hist = LT.main(["--arch", arch, "--smoke", "--steps", "2", "--tp",
                        "2", "--batch", "4", "--seq", "32", "--device",
                        "cpu", *flag])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert getattr(tr.par, field) == value and tr.group.size == 4
    assert dp_axes(tr.group) == (("ep", "data") if field == "ep"
                                 else ("data",))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_gpu_two_axis_view_exchange_equals_cpu():
    """The (data, model) view's ``a2a_exchange`` and the ``a2a`` op over it
    on the card (the ranks' streams, event-ordered copies) equal the CPU
    mesh's, fp32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the ranks' streams and events)")
    gen = torch.Generator().manual_seed(5)
    e_loc, cap, dm, ff = 2, 6, 16, 24
    xs = [torch.randn(4, e_loc, cap, dm, generator=gen) for _ in range(4)]
    ws = [tuple(torch.randn(s, generator=gen) * 0.3 for s in
                ((e_loc, dm, ff), (e_loc, dm, ff), (e_loc, ff, dm)))
          for _ in range(4)]
    got = {}
    for dev in ("cpu", "cuda"):
        mesh = make_mesh(1, 2, 2, dev)

        def body(x, w):
            view = mesh.group(("data", "model"))
            op = tov.FusedOp("a2a", tov.Epilogue(activation="silu",
                                                 gate="pair"), 3, axis=view,
                             mode="xla")
            return (tov.a2a_exchange(x, view).cpu(), op(x, *w).cpu())

        got[dev] = mesh.spmd(body, [(x.to(dev), tuple(t.to(dev) for t in w))
                                    for x, w in zip(xs, ws)])
    for (ec, oc), (eg, og) in zip(got["cpu"], got["cuda"]):
        assert torch.equal(eg, ec)
        torch.testing.assert_close(og, oc, atol=1e-4, rtol=1e-4)

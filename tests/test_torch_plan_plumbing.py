"""The seam plans at work: ``FusedOp``'s tuning knobs and per-seam,
per-layer ``PlanSet``s through ``TPContext``, at 4 ranks against the
reference.

The reference runs once for the file, in one subprocess with 4 forced
host devices: ``jax.grad`` under ``shard_map`` (``check_vma=False``) of
each op against a per-rank cotangent probe, every rank's value and grads
stacked on a leading axis; ``jax.value_and_grad`` of ``forward_loss``
under the reference's ``tests/test_plan_plumbing.py`` heterogeneous
``PlanSet`` (its per-layer override included) on the codeqwen15_7b smoke
config (d_ff 512, fp32) at tp=4; and ``ffn_decode`` with the ``decode_ar``
seam at ``comm_chunks=4``.  The port runs the same numpy inputs as the 4
ranks of a ``dist.RankGroup`` on the CPU, recording its seams on a
``SeamTape``.

* ``FusedOp`` ag / rs / ar values and every input's grad with
  ``comm_chunks`` 4, 8 and 16, ``reverse``, ``shared_gather=False`` and
  ``fuse_epilogue=False``, in both layouts, under ``decomposed``,
  ``decomposed_bidir`` and ``flux`` (the plain versions on the CPU, with
  ``blocks`` set to a Hopper tile): relative L2 1e-5 (fp32, sums in
  another order).  The knobs change the schedule: a ring's exchanges
  follow ``_sub_chunks`` and a chunked ``ar``'s psums its chunk count.
* The heterogeneous ``PlanSet``: the port's loss within 2e-4 and every
  rank's grads within 2e-3 (max-abs relative), the reference test's own
  tolerances, of the reference's under the same plans, and of the port's
  uniform ``xla`` run.  The layer ids are the reference's
  (``models.model.layer_slot``).
* ``ffn_decode`` with ``decode_ar`` at ``comm_chunks=4``: within 1e-5.
* A tp=4 ``Server`` serving from a heterogeneous profile gives the tokens
  of the uniform run; the train and serve CLIs with ``--plan-profile``,
  ``--comm-chunks`` and ``--autotune --device cpu``.
* ``gpu``-marked (skipped without a card): the AG-GEMM and GEMM-RS
  kernels with each Hopper tile forced and each ring direction at the
  train lane's minicpm_2b seam shapes, against their plain versions, and
  a flux ``FusedOp`` whose tile the kernels lack raising at its launch.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch import convert, dist
from repro_torch.configs.base import ParallelConfig, get_smoke_config
from repro_torch.core import overlap as tov
from repro_torch.kernels import matmul as mm
from repro_torch.models import ffn as TF
from repro_torch.models import model as TM
from repro_torch.parallel.sharding import TPContext
from repro_torch.runtime import trainer as TT
from repro_torch.runtime.server import Request, ServeConfig, Server
from repro_torch.tuning import cache as tcache
from repro_torch.tuning.plans import PlanSet, SeamPlan

N = 4
B, S, D, F = 2, 16, 32, 32      # shards of 4 rows; ar chunks of F/N = 8
OP_RTOL = 1e-5
LOSS_ATOL = 2e-4
GRAD_RTOL = 2e-3
DECODE_ATOL = 1e-5
MS, MB = 64, 2
LARGE, SMALL = mm.tile_blocks(mm.LARGE), mm.tile_blocks(mm.SMALL)

PAIR = dict(activation="silu", gate="pair")
BIAS_SILU = dict(bias=True, activation="silu")
BIAS_GELU = dict(bias=True, activation="gelu")
RES = dict(residual=True)

# (tag, kind, layout, mode, knobs, epilogue, n_weights)
CASES = [
    ("ag_pair_cc4", "ag", "seq", "decomposed", dict(comm_chunks=4), PAIR, 2),
    ("ag_pair_cc8_rev", "ag", "seq", "decomposed",
     dict(comm_chunks=8, reverse=True), PAIR, 2),
    ("ag_pair_cc16_unshared", "ag", "seq", "decomposed",
     dict(comm_chunks=16, shared_gather=False), PAIR, 2),
    ("ag_pair_unfused_rev", "ag", "seq", "decomposed",
     dict(comm_chunks=8, reverse=True, fuse_epilogue=False), PAIR, 2),
    ("ag_bias_cc16_rev_unfused", "ag", "seq", "decomposed",
     dict(comm_chunks=16, reverse=True, fuse_epilogue=False), BIAS_SILU, 1),
    ("ag_pair_bidir_cc8_unshared", "ag", "seq", "decomposed_bidir",
     dict(comm_chunks=8, shared_gather=False), PAIR, 2),
    ("ag_bias_bidir_cc16_unfused", "ag", "seq", "decomposed_bidir",
     dict(comm_chunks=16, fuse_epilogue=False), BIAS_SILU, 1),
    ("ag_pair_flux_small_rev_unshared", "ag", "seq", "flux",
     dict(reverse=True, shared_gather=False, blocks=SMALL), PAIR, 2),
    ("ag_pair_flux_large_unfused", "ag", "seq", "flux",
     dict(fuse_epilogue=False, blocks=LARGE), PAIR, 2),
    ("ag_bias_flux_large_unfused", "ag", "seq", "flux",
     dict(fuse_epilogue=False, blocks=LARGE), BIAS_SILU, 1),
    ("ag_bias_flux_small_rev", "ag", "seq", "flux",
     dict(reverse=True, blocks=SMALL), BIAS_SILU, 1),
    ("rs_res_cc8_rev", "rs", "seq", "decomposed",
     dict(comm_chunks=8, reverse=True), RES, 1),
    ("rs_res_bidir_cc4", "rs", "seq", "decomposed_bidir",
     dict(comm_chunks=4), RES, 1),
    ("rs_res_flux_small_rev", "rs", "seq", "flux",
     dict(reverse=True, blocks=SMALL), RES, 1),
    ("rs_res_flux_large_cc16", "rs", "seq", "flux",
     dict(comm_chunks=16, blocks=LARGE), RES, 1),
    ("h_ag_pair_unshared_unfused", "ag", "hidden", "decomposed",
     dict(comm_chunks=8, shared_gather=False, fuse_epilogue=False), PAIR, 2),
    ("h_ag_bias_flux_rev", "ag", "hidden", "flux",
     dict(reverse=True, blocks=SMALL), BIAS_SILU, 1),
    ("h_rs_res_cc4", "rs", "hidden", "decomposed", dict(comm_chunks=4), RES,
     1),
    ("h_rs_res_bidir_cc16", "rs", "hidden", "decomposed_bidir",
     dict(comm_chunks=16), RES, 1),
    ("h_rs_res_flux_rev", "rs", "hidden", "flux",
     dict(reverse=True, blocks=LARGE), RES, 1),
    ("ar_bias_gelu_cc8", "ar", "hidden", "decomposed", dict(comm_chunks=8),
     BIAS_GELU, 1),
    ("ar_bias_gelu_cc16", "ar", "hidden", "decomposed",
     dict(comm_chunks=16), BIAS_GELU, 1),
    ("ar_bias_gelu_bidir_cc4", "ar", "hidden", "decomposed_bidir",
     dict(comm_chunks=4), BIAS_GELU, 1),
]

# the reference test_plan_plumbing's heterogeneous plans
HETERO = dict(
    default=dict(mode="decomposed"),
    seams={"mlp_ag": dict(mode="xla"),
           "mlp_rs": dict(mode="decomposed", comm_chunks=8, reverse=True),
           "attn_ag": dict(mode="decomposed_bidir"),
           "attn_rs": dict(mode="decomposed", comm_chunks=16),
           "head_ag": dict(mode="xla")},
    layers={0: {"attn_ag": dict(mode="decomposed", reverse=True)}})

_REF = r"""
import dataclasses, functools
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.configs.base import get_smoke_config, ParallelConfig
from repro.core import overlap as ov
from repro.models import ffn, model as M
from repro.parallel.sharding import TPContext
from repro.tuning.plans import PlanSet, SeamPlan

inp = dict(np.load(IN))
out = {}
mesh = Mesh(np.array(jax.devices()), ("tp",))
R = P("tp")


def record(tag, fn, args, specs):
    def body(*a):
        *xs, g = a
        val = fn(*xs)
        grads = jax.grad(lambda *q: jnp.sum(fn(*q) * g[0]),
                         argnums=tuple(range(len(xs))))(*xs)
        return val[None], tuple(t[None] for t in grads)
    f = jax.jit(functools.partial(
        shard_map, mesh=mesh, in_specs=tuple(specs) + (R,),
        out_specs=(R, (R,) * len(specs)), check_vma=False)(body))
    val, grads = f(*args)
    out[tag + "/val"] = np.asarray(val)
    for i, t in enumerate(grads):
        out[f"{tag}/g{i}"] = np.asarray(t)


a = {k: jnp.asarray(v) for k, v in inp.items() if k.startswith("op/")}
rep, seq, col = P(), P(None, "tp", None), P(None, None, "tp")
wcol, wrow, vec = P(None, "tp"), P("tp", None), P("tp")
for tag, kind, layout, mode, knobs, epi, nw in %(cases)r:
    knobs = {k: v for k, v in knobs.items() if k != "blocks"}
    op = ov.FusedOp(kind, axis="tp", mode=mode, scatter_axis=layout,
                    epilogue=ov.Epilogue(**epi), n_weights=nw, **knobs)
    if kind == "ag":
        xs = (a["op/x"], a["op/w1"]) + ((a["op/w3"],) if nw == 2 else ())
        sp = (seq if layout == "seq" else rep, wcol) + (
            (wcol,) if nw == 2 else ())
        if epi.get("bias"):
            fn = lambda p, q, r: op(p, q, bias=r)
            xs, sp = xs + (a["op/bias"],), sp + (vec,)
        else:
            fn = lambda *q: op(*q)
        probe = a["op/pr_col"]
    elif kind == "rs":
        fn = lambda p, q, r: op(p, q, residual=r)
        xs = (a["op/y"], a["op/w2"], a["op/res"])
        sp = (col, wrow, seq if layout == "seq" else rep)
        probe = a["op/pr_seq" if layout == "seq" else "op/pr_rep"]
    else:
        fn = lambda p, q, r: op(p, q, bias=r)
        xs = (a["op/y"], a["op/w2"], a["op/bias_d"])
        sp = (col, wrow, rep)
        probe = a["op/pr_rep"]
    record(tag, fn, xs + (probe,), sp)


def save(tree, prefix):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in flat:
        key = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                       for q in path)
        out[prefix + key] = np.asarray(leaf, np.float32)


def planset(d):
    return PlanSet(default=SeamPlan(**d["default"]),
                   seams={s: SeamPlan(**p) for s, p in d["seams"].items()},
                   layers={l: {s: SeamPlan(**p) for s, p in ov_.items()}
                           for l, ov_ in d["layers"].items()})


cfg = dataclasses.replace(get_smoke_config("codeqwen15_7b"), d_ff=512,
                          compute_dtype="float32")
par = ParallelConfig(tp=4, dp=1)
mesh2 = Mesh(np.array(jax.devices()).reshape(1, 4), ("data", "model"))
params = M.init_model(jax.random.PRNGKey(0), cfg, par, dtype=jnp.float32)
mix = params["periods"][0]["mixer"]
rng = np.random.default_rng(1)
mix["bqkv"] = jnp.asarray(0.1 * rng.standard_normal(mix["bqkv"].shape),
                          jnp.float32)
specs = M.param_specs(cfg, par, params)
ranked = jax.tree.map(lambda _: P("model"), params)
ctx = TPContext(axis="model", dp_axes=("data",), mode="xla",
                plans=planset(%(hetero)r))
toks, labels = jnp.asarray(inp["tokens"]), jnp.asarray(inp["labels"])


def body(p, t, l):
    loss, g = jax.value_and_grad(lambda q: M.forward_loss(
        q, {"tokens": t, "labels": l}, ctx, cfg, par))(p)
    return loss, jax.tree.map(lambda a_: a_[None], g)


f = jax.jit(functools.partial(
    shard_map, mesh=mesh2, in_specs=(specs, P(), P()),
    out_specs=(P(), ranked), check_vma=False)(body))
loss, g = f(params, toks, labels)
out["het/loss"] = np.asarray(loss)
save(params, "het/params/")
save(g, "het/grads/")

fp = {k: jnp.asarray(inp["dec/" + k]) for k in ("w1", "w3", "w2", "norm")}
fspec = {"w1": P(None, "tp"), "w3": P(None, "tp"), "w2": P("tp", None),
         "norm": P(None)}
dctx = TPContext(axis="tp", mode="xla", plans=PlanSet(
    default=SeamPlan(mode="xla"),
    seams={"decode_ar": SeamPlan(mode="decomposed", comm_chunks=4)}))
fd = jax.jit(functools.partial(
    shard_map, mesh=mesh, in_specs=(fspec, P()), out_specs=P(),
    check_vma=False)(lambda pp, xx: ffn.ffn_decode(pp, xx, dctx)))
out["dec/out"] = np.asarray(fd(fp, jnp.asarray(inp["dec/x"])))
np.savez(OUT, **out)
print("REF_OK")
"""


def _op_inputs():
    rng = np.random.default_rng(3)

    def normal(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    w = S // N
    pr_rep = normal(N, B, S, D)
    return {"x": normal(B, S, D), "w1": normal(D, F, scale=0.2),
            "w3": normal(D, F, scale=0.2), "bias": normal(F),
            "y": normal(B, S, F), "w2": normal(F, D, scale=0.2),
            "res": normal(B, S, D), "bias_d": normal(D),
            "pr_col": normal(N, B, S, F // N), "pr_rep": pr_rep,
            "pr_seq": np.stack([pr_rep[r][:, r * w:(r + 1) * w]
                                for r in range(N)])}


def _decode_inputs():
    rng = np.random.default_rng(5)
    d = 128
    return {"w1": (0.1 * rng.standard_normal((d, 512))).astype(np.float32),
            "w3": (0.1 * rng.standard_normal((d, 512))).astype(np.float32),
            "w2": (0.1 * rng.standard_normal((512, d))).astype(np.float32),
            "norm": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
            "x": rng.standard_normal((2, 1, d)).astype(np.float32)}


def _batch():
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 512, (MB, MS)).astype(np.int32)
    labels = rng.integers(0, 512, (MB, MS)).astype(np.int32)
    labels[1, -5:] = -1
    return toks, labels


@pytest.fixture(scope="module")
def ref(tmp_path_factory, subproc):
    d = tmp_path_factory.mktemp("plan_plumbing")
    toks, labels = _batch()
    inp = {f"op/{k}": v for k, v in _op_inputs().items()}
    inp.update({f"dec/{k}": v for k, v in _decode_inputs().items()})
    np.savez(d / "in.npz", tokens=toks, labels=labels, **inp)
    code = (_REF % {"cases": CASES, "hetero": HETERO}).replace(
        "IN)", repr(str(d / "in.npz")) + ")").replace(
        "OUT,", repr(str(d / "out.npz")) + ",")
    assert "REF_OK" in subproc(code, n_devices=N)
    return inp, dict(np.load(d / "out.npz"))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _shard(a, r, dim):
    if dim is None:
        return a
    w = a.shape[dim] // N
    return np.take(a, range(r * w, (r + 1) * w), axis=dim)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _op_case(case):
    """(FusedOp builder, call, [(input key, shard dim)], probe key)."""
    tag, kind, layout, mode, knobs, epi, nw = case

    def build(g):
        return tov.FusedOp(kind, epilogue=tov.Epilogue(**epi), n_weights=nw,
                           axis=g, mode=mode, scatter_axis=layout, **knobs)

    if kind == "ag":
        ins = [("x", 1 if layout == "seq" else None), ("w1", 1)]
        ins += [("w3", 1)] if nw == 2 else []
        if epi.get("bias"):
            ins.append(("bias", 0))
            call = (lambda op: lambda x, w, b: op(x, w, bias=b))
        else:
            call = (lambda op: op)
        return build, call, ins, "pr_col"
    if kind == "rs":
        ins = [("y", 2), ("w2", 0), ("res", 1 if layout == "seq" else None)]
        return (build, lambda op: lambda y, w, r: op(y, w, residual=r), ins,
                "pr_seq" if layout == "seq" else "pr_rep")
    ins = [("y", 2), ("w2", 0), ("bias_d", None)]
    return (build, lambda op: lambda y, w, b: op(y, w, bias=b), ins,
            "pr_rep")


def _run_op(inp, case, spy=None):
    build, call, ins, probe = _op_case(case)
    g = dist.RankGroup(N, "cpu", timeout_s=60)
    if spy is not None:
        real = g.publish

        def publish(x, what):
            if g.rank() == 0:
                spy.append(what)
            return real(x, what)
        g.publish = publish
    fn = call(build(g))
    args = [[_t(_shard(inp[f"op/{k}"], r, dim)) for k, dim in ins]
            for r in range(N)]
    probes = [_t(inp[f"op/{probe}"][r]) for r in range(N)]

    def body(xs, pr):
        xs = [x.clone().requires_grad_() for x in xs]
        with tov.SeamTape() as tape:
            out = fn(*xs)
            loss = (out * pr).sum()
        tape.backward(loss)
        return out.detach(), [x.grad for x in xs]

    return g.spmd(body, [(args[r], probes[r]) for r in range(N)]), len(ins)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_fused_op_knobs_value_and_grads_match_reference(ref, case):
    inp, out = ref
    tag = case[0]
    res, n_in = _run_op(inp, case)
    for r in range(N):
        assert _rel(res[r][0].numpy(), out[f"{tag}/val"][r]) <= OP_RTOL, r
        for i in range(n_in):
            assert _rel(res[r][1][i].numpy(),
                        out[f"{tag}/g{i}"][r]) <= OP_RTOL, (i, r)


@pytest.mark.parametrize("cc,pieces", [(0, 1), (4, 1), (8, 2), (16, 4)])
def test_ring_pieces_and_ar_chunks_follow_comm_chunks(ref, cc, pieces):
    """The schedule the knobs set: an AllGather ring's shard travels as
    ``_sub_chunks(4, 4, cc)`` pieces, one exchange a piece a hop, in the
    forward and in its backward's re-gather (the one-piece ring, as the
    reference's ``gather_seq``); the decomposed ``ar`` psums ``cc or n``
    chunks of its 8-wide contraction (at most 8); ``reverse`` changes
    none of it."""
    inp, _ = ref
    assert tov._sub_chunks(S // N, N, cc) == pieces
    for rev in (False, True):
        seen = []
        case = ("ag", "ag", "seq", "decomposed",
                dict(comm_chunks=cc, reverse=rev), PAIR, 2)
        _run_op(inp, case, spy=seen)
        assert seen.count("ag_ring") == (N - 1) * (pieces + 1)
        assert seen.count("rs_ring") == N - 1
    seen = []
    _run_op(inp, ("ar", "ar", "hidden", "decomposed", dict(comm_chunks=cc),
                  BIAS_GELU, 1), spy=seen)
    assert seen.count("psum") == min(cc or N, F // N) + 1   # + the cotangent


def test_fused_op_from_plan_carries_every_knob():
    plan = SeamPlan(mode="flux", comm_chunks=8, reverse=True, blocks=SMALL,
                    fuse_epilogue=False, shared_gather=False,
                    scatter_axis="hidden")
    op = plan.op("ag", None, epilogue=tov.Epilogue(**PAIR), n_weights=2)
    assert (op.mode, op.comm_chunks, op.reverse, op.blocks, op.fuse_epilogue,
            op.shared_gather, op.scatter_axis) == (
        "flux", 8, True, SMALL, False, False, "hidden")
    assert plan.op("ag", None, scatter_axis="seq").scatter_axis == "seq"
    assert plan.op("ar").scatter_axis == "hidden"
    with pytest.raises(ValueError, match="comm_chunks"):
        tov.FusedOp("ag", comm_chunks=-1)
    with pytest.raises(ValueError, match="bm, bk, bn"):
        tov.FusedOp("ag", blocks=(64, 64))


# ---------------------------------------------------------------------------
# the model under heterogeneous plans
# ---------------------------------------------------------------------------
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


def _planset(d):
    return PlanSet(default=SeamPlan(**d["default"]),
                   seams={s: SeamPlan(**p) for s, p in d["seams"].items()},
                   layers={l: {s: SeamPlan(**p) for s, p in ov.items()}
                           for l, ov in d["layers"].items()})


def _max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-9)


def _model_runs(out, plans_list):
    cfg = dataclasses.replace(get_smoke_config("codeqwen15_7b"), d_ff=512,
                              compute_dtype="float32")
    par = ParallelConfig(tp=N)
    ranks = convert.rank_params_from_jax(_tree(out, "het/params/"), cfg, N,
                                         dtype=torch.float32, device="cpu",
                                         trainable=True)
    toks, labels = _batch()
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    group = dist.RankGroup(N, "cpu", timeout_s=60)
    runs = []
    for plans in plans_list:
        ctx = TT.make_ctx(cfg, par, group, plans)
        runs.append(group.spmd(
            lambda p: TT.loss_and_grads(p, batch, ctx, cfg, par),
            [(p,) for p in ranks]))
    return cfg, runs


def test_heterogeneous_plan_set_matches_reference_and_uniform(ref):
    _, out = ref
    het = _planset(HETERO)
    assert TM.layer_slot(get_smoke_config("codeqwen15_7b"), 1) == 0
    cfg, (hruns, uruns) = _model_runs(out, [het, PlanSet.uniform("xla")])
    want_loss = float(out["het/loss"])
    wants = {k[len("het/grads/"):]: v for k, v in out.items()
             if k.startswith("het/grads/")}
    for r in range(N):
        (hl, hg), (ul, ug) = hruns[r], uruns[r]
        assert abs(hl.item() - want_loss) < LOSS_ATOL
        assert abs(hl.item() - ul.item()) < LOSS_ATOL
        got = _flat(convert.to_jax_tree(hg, cfg))
        uni = _flat(convert.to_jax_tree(ug, cfg))
        assert sorted(got) == sorted(wants)
        for key, w in wants.items():
            assert _max_rel(got[key], w[r]) < GRAD_RTOL, (r, key)
            assert _max_rel(got[key], uni[key]) < GRAD_RTOL, (r, key)


def test_per_layer_override_resolves_through_the_context():
    cfg = dataclasses.replace(get_smoke_config("minicpm_2b"), num_layers=3,
                              leading_dense_layers=1)
    slots = [TM.layer_slot(cfg, j) for j in range(3)]
    assert slots == [0, 1, 1]       # the lead, then one pattern position
    plans = _planset(HETERO)
    ctx = TPContext(plans=plans)
    assert ctx.with_layer(0).op("attn_ag").reverse
    assert ctx.with_layer(1).op("attn_ag").mode == "decomposed_bidir"
    assert ctx.op("mlp_rs").comm_chunks == 8
    assert ctx.with_layer(0).plan("decode_ar").mode == "decomposed"
    assert TPContext(mode="flux", comm_chunks=4).op("mlp_ag").comm_chunks == 4


def test_decode_ar_comm_chunks_in_ffn_decode(ref):
    inp, out = ref
    plans = PlanSet(default=SeamPlan(mode="xla"),
                    seams={"decode_ar": SeamPlan(mode="decomposed",
                                                 comm_chunks=4)})
    g = dist.RankGroup(N, "cpu", timeout_s=60)
    ctx = TPContext(tp=N, group=g, plans=plans, mode="xla")
    dims = {"w1": 1, "w3": 1, "w2": 0, "norm": None}
    ranks = [{k: _t(_shard(inp[f"dec/{k}"], r, dim))
              for k, dim in dims.items()} for r in range(N)]
    outs = g.spmd(lambda p: TF.ffn_decode(p, _t(inp["dec/x"]), ctx),
                  [(p,) for p in ranks])
    for o in outs:
        np.testing.assert_allclose(o.numpy(), out["dec/out"],
                                   atol=DECODE_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# serving and the CLIs from a profile
# ---------------------------------------------------------------------------
SERVE_KW = dict(max_batch=4, max_seq=64, max_new_tokens=4, block_size=8,
                prefill_chunk=8)


def _hetero_profile(path):
    """A profile of heterogeneous seam plans for the smoke minicpm_2b at
    tp=4 on the CPU (every knob set somewhere)."""
    reg = tcache.PlanRegistry(n_dev=N, backend="cpu")
    plans = {"mlp_ag": SeamPlan(mode="flux", reverse=True, blocks=SMALL,
                                shared_gather=False),
             "mlp_rs": SeamPlan(mode="decomposed_bidir", comm_chunks=8),
             "attn_ag@qkv": SeamPlan(mode="decomposed", comm_chunks=16,
                                     reverse=True, fuse_epilogue=False),
             "attn_rs": SeamPlan(mode="decomposed", comm_chunks=8),
             "head_ag": SeamPlan(mode="xla"),
             "decode_ar": SeamPlan(mode="decomposed", comm_chunks=16)}
    for seam, p in plans.items():
        reg.record(seam, "ag", 64, 64, 64, p)
    reg.save(path)


def test_server_tp4_from_heterogeneous_profile_matches_uniform(tmp_path):
    cfg = dataclasses.replace(get_smoke_config("minicpm_2b"),
                              compute_dtype="float32")
    full = TM.init_model(cfg, ParallelConfig(tp=N), seed=0,
                         dtype=torch.float32, device="cpu")
    ranks = [TM.shard_params(full, r, N, cfg) for r in range(N)]
    path = str(tmp_path / "het.json")
    _hetero_profile(path)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 512, size=(n,)).astype(np.int32)
               for n in (5, 20, 13)]
    group = dist.RankGroup(N, "cpu", timeout_s=60)
    tokens = []
    for par in (ParallelConfig(tp=N, overlap_mode="xla"),
                ParallelConfig(tp=N, overlap_mode="xla", plan_profile=path)):
        srv = Server(cfg, par, ranks, ServeConfig(**SERVE_KW), group=group)
        done = srv.serve([Request(rid=i, prompt=p)
                          for i, p in enumerate(prompts)])
        assert all(r.done and r.error is None for r in done)
        tokens.append({r.rid: list(r.output) for r in done})
    assert srv.ctx.plan("decode_ar").comm_chunks == 16
    assert srv.ctx.plan("attn_ag").reverse
    assert tokens[1] == tokens[0]


def test_train_cli_from_profile_and_comm_chunks(tmp_path, capsys):
    from repro_torch.launch import train as LT
    path = str(tmp_path / "het.json")
    _hetero_profile(path)
    base = ["--arch", "minicpm_2b", "--smoke", "--steps", "2", "--tp", "4",
            "--mode", "flux", "--batch", "2", "--seq", "32", "--device",
            "cpu"]
    losses = {}
    for tag, extra in (("uniform", []), ("profile", ["--plan-profile", path]),
                       ("chunks", ["--mode", "decomposed", "--comm-chunks",
                                   "16"])):
        tr, hist = LT.main(base + extra)
        assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
        losses[tag] = [h["loss"] for h in hist]
    assert tr.par.comm_chunks == 16 and tr.par.overlap_mode == "decomposed"
    # bf16 steps whose seams sum in another order: the train lane's
    # loss tolerance
    for tag in ("profile", "chunks"):
        np.testing.assert_allclose(losses[tag], losses["uniform"], rtol=1e-2)


def test_serve_cli_autotune_and_profile(tmp_path, capsys):
    from repro_torch.launch import serve as LS
    path = str(tmp_path / "tuned.json")
    base = ["--arch", "minicpm_2b", "--smoke", "--device", "cpu",
            "--requests", "2", "--max-new", "3", "--tp", "4", "--mode",
            "flux"]
    srv0, done0 = LS.main(base)
    srv1, done1 = LS.main(base + ["--autotune", "--plan-profile", path])
    doc = json.load(open(path))
    assert doc["backend"] == "cpu" and doc["mesh"] == {"n_dev": 4}
    # the decode seam was tuned at --max-batch rows
    ar = [e for e in doc["entries"].values() if e["seam"] == "decode_ar"]
    assert [e["m"] for e in ar] == [srv1.sc.max_batch]
    assert srv1.ctx.plans.seams and srv1.par.plan_profile == path
    srv2, done2 = LS.main(base + ["--plan-profile", path])
    assert srv2.ctx.plans.to_json() == srv1.ctx.plans.to_json()
    outs = [{r.rid: list(r.output) for r in d}
            for d in (done0, done1, done2)]
    assert outs[1] == outs[0] and outs[2] == outs[0]
    srv3, _ = LS.main(["--arch", "minicpm_2b", "--smoke", "--device", "cpu",
                       "--requests", "1", "--max-new", "1", "--autotune"])
    assert srv3.par.tp == 1 and "no TP seams" in capsys.readouterr().out
    # the wire flags are ported: they reach the parsed arguments
    args = LS.parse_args(["--arch", "minicpm_2b", "--wire-dtype", "int8",
                          "--max-logit-rmse", "0.1"])
    assert args.wire_dtype == "int8" and args.max_logit_rmse == 0.1


# ---------------------------------------------------------------------------
# on the card: the kernels with each Hopper tile forced
# ---------------------------------------------------------------------------
# minicpm_2b at the train lane's tokens (4 x 1024) and tp=4: (kind, m, n, k)
# of mlp_ag (packed w1|w3), mlp_rs, attn_ag@qkv, attn_rs, head_ag
GPU_SHAPES = [("ag", 4096, 12288, 2304), ("rs", 4096, 2304, 6144),
              ("ag", 4096, 6912, 2304), ("rs", 4096, 2304, 2304),
              ("ag", 4096, 122880, 2304)]
GPU_CASES = [(s, t, rev) for s in GPU_SHAPES for t in (LARGE, SMALL)
             for rev in (False, True)]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the AG-GEMM and GEMM-RS kernels)")


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_CASES,
                         ids=[f"{s[0]}_{s[2]}x{s[3]}_{t[0]}x{t[2]}"
                              f"{'_rev' if r else ''}"
                              for s, t, r in GPU_CASES])
def test_gpu_forced_tile_kernels_match_plain(case):
    _cuda()
    from repro_torch.kernels import ag_gemm as AG
    from repro_torch.kernels import gemm_rs as RS
    (kind, m, n, k), blocks, rev = case
    g = dist.RankGroup(N, "cuda", timeout_s=60)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).bfloat16()

    tile = (blocks[0], blocks[2])
    if kind == "ag":
        args = [(randn(m // N, k), randn(k, n // N, scale=k ** -0.5))
                for _ in range(N)]
        outs = g.spmd(lambda a, b: AG.ag_gemm(a, b, group=g, reverse=rev,
                                              tile=tile), args)
        torch.cuda.synchronize()
        full = torch.cat([a for a, _ in args]).float()
        wants = [full @ b.float() for _, b in args]
        atol_p = 0.0
    else:
        args = [(randn(m, k // N), randn(k // N, n, scale=k ** -0.5))
                for _ in range(N)]
        outs = g.spmd(lambda a, b: RS.gemm_rs(a, b, group=g, reverse=rev,
                                              tile=tile), args)
        torch.cuda.synchronize()
        parts = [a.float() @ b.float() for a, b in args]
        total = sum(parts)
        sh = m // N
        wants = [total[r * sh:(r + 1) * sh] for r in range(N)]
        atol_p = N * 2.0 ** -8 * max(p.abs().max().item() for p in parts)
    for out, want in zip(outs, wants):
        err = (out.float() - want).abs()
        atol = 1e-3 * want.abs().max().item() + atol_p
        assert bool((err <= atol + 2.0 ** -7 * want.abs()).all()), \
            err.max().item()


@pytest.mark.gpu
def test_gpu_flux_op_with_a_tile_the_kernels_lack_raises():
    _cuda()
    g = dist.RankGroup(N, "cuda", timeout_s=60)
    op = tov.FusedOp("ag", axis=g, mode="flux", blocks=(256, 512, 256))
    args = [(torch.randn(1, 64, 128, device="cuda").bfloat16(),
             torch.randn(128, 64, device="cuda").bfloat16())
            for _ in range(N)]
    with pytest.raises(dist.RankGroupError):
        g.spmd(lambda x, w: op(x, w), args)

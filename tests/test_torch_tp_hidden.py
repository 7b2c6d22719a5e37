"""The replicated ("hidden") layout's backward and ``decomposed_bidir`` at
4 ranks against the reference.

The reference runs once for the file, in one subprocess with 4 forced
host devices: ``jax.grad`` under ``shard_map`` (``check_vma=False``) of
each op against a per-rank cotangent probe (a different probe on each
rank, so a replicated output's partial cotangents must be completed
inside the ops, as the reference's ``tests/test_sp_residency.py``
stresses), every rank's value and grads stacked on a leading axis; and
``jax.value_and_grad`` of ``forward_loss`` with ``scatter_axis="hidden"``
through the reference trainer's ``make_ctx``, on the minicpm_2b and
codeqwen15_7b smoke configs at tp=4 in xla mode.  The port runs the same
numpy inputs as the 4 ranks of a ``dist.RankGroup`` on the CPU, each
recording its seams on a ``SeamTape``.

* hidden ``ag`` (bias + silu; the pair gate over two weights), hidden
  ``rs`` with a residual, ``ar`` with bias + gelu (its pre-epilogue value
  saved for the vjp), in modes xla, decomposed, flux and
  decomposed_bidir; ``decomposed_bidir`` ``ag`` (bias + silu, the pair
  gate) and ``rs`` (residual) in the sequence-sharded layout, at an even
  shard (the counter-rotating half rings) and at an odd one (the one-way
  ring, the reference's rule).  Values and every input's grad on every
  rank within relative L2 1e-5 (fp32, sums in another order).
* the training loss and every leaf's grad in the hidden layout at tp=4,
  each rank before and after the trainer's psum, in modes xla,
  decomposed, flux and decomposed_bidir: the loss within 1e-5 relative,
  each leaf within relative L2 1e-4 (``tests/test_torch_train_model.py``'s
  tolerances); and the port's hidden layout against its own seq layout
  (canonical grads, relative L2 1e-5).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert, dist
from repro_torch.configs.base import ParallelConfig, get_smoke_config
from repro_torch.core import overlap as tov
from repro_torch.models import model as TM
from repro_torch.runtime import trainer as TT

N = 4
MODES = ["xla", "decomposed", "flux", "decomposed_bidir"]
B, D, F = 2, 32, 32
S_EVEN, S_ODD = 16, 12          # shards of 4 rows (bidir) and 3 (one-way)
OP_RTOL = 1e-5
ARCHS = ["minicpm_2b", "codeqwen15_7b"]
MS, MB = 64, 2                   # the model's sequence and batch
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
LAYOUT_RTOL = 1e-5

_REF = r"""
import dataclasses, functools
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.configs.base import get_smoke_config, ParallelConfig
from repro.core import overlap as ov
from repro.models import model as M
from repro.optim import adamw
from repro.runtime import trainer as T

inp = dict(np.load(IN))
out = {}
mesh = Mesh(np.array(jax.devices()), ("tp",))
R = P("tp")                     # every rank's value on a leading axis


def record(tag, fn, args, specs):
    # each rank's value and the grads of sum(op(args) * its own probe)
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


rep, seq, col = P(), P(None, "tp", None), P(None, None, "tp")
wcol, wrow, vec = P(None, "tp"), P("tp", None), P("tp")
for s in (%(s_even)d, %(s_odd)d):
    a = {k: jnp.asarray(inp[f"{s}/{k}"]) for k in
         ("x", "w1", "w3", "bias", "y", "w2", "res", "bias_d", "pr_col",
          "pr_rep", "pr_seq")}
    hidden_modes = %(modes)r if s == %(s_even)d else []
    for mode in hidden_modes:
        ag = ov.FusedOp("ag", axis="tp", mode=mode, scatter_axis="hidden",
                        epilogue=ov.Epilogue(bias=True, activation="silu"))
        record(f"{s}/h_ag_bias/{mode}", lambda p, q, r: ag(p, q, bias=r),
               (a["x"], a["w1"], a["bias"], a["pr_col"]), (rep, wcol, vec))
        ag2 = ov.FusedOp("ag", axis="tp", mode=mode, scatter_axis="hidden",
                         n_weights=2, epilogue=ov.Epilogue(
                             activation="silu", gate="pair"))
        record(f"{s}/h_ag_pair/{mode}", lambda p, q, r: ag2(p, q, r),
               (a["x"], a["w1"], a["w3"], a["pr_col"]), (rep, wcol, wcol))
        rs = ov.FusedOp("rs", axis="tp", mode=mode, scatter_axis="hidden",
                        epilogue=ov.Epilogue(residual=True))
        record(f"{s}/h_rs_res/{mode}", lambda p, q, r: rs(p, q, residual=r),
               (a["y"], a["w2"], a["res"], a["pr_rep"]), (col, wrow, rep))
        ar = ov.FusedOp("ar", axis="tp", mode=mode, epilogue=ov.Epilogue(
            bias=True, activation="gelu"))
        record(f"{s}/ar_bias_gelu/{mode}", lambda p, q, r: ar(p, q, bias=r),
               (a["y"], a["w2"], a["bias_d"], a["pr_rep"]), (col, wrow, rep))
    mode = "decomposed_bidir"
    ag = ov.FusedOp("ag", axis="tp", mode=mode,
                    epilogue=ov.Epilogue(bias=True, activation="silu"))
    record(f"{s}/b_ag_bias", lambda p, q, r: ag(p, q, bias=r),
           (a["x"], a["w1"], a["bias"], a["pr_col"]), (seq, wcol, vec))
    ag2 = ov.FusedOp("ag", axis="tp", mode=mode, n_weights=2,
                     epilogue=ov.Epilogue(activation="silu", gate="pair"))
    record(f"{s}/b_ag_pair", lambda p, q, r: ag2(p, q, r),
           (a["x"], a["w1"], a["w3"], a["pr_col"]), (seq, wcol, wcol))
    rs = ov.FusedOp("rs", axis="tp", mode=mode,
                    epilogue=ov.Epilogue(residual=True))
    record(f"{s}/b_rs_res", lambda p, q, r: rs(p, q, residual=r),
           (a["y"], a["w2"], a["res"], a["pr_seq"]), (col, wrow, seq))


def save(tree, prefix):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in flat:
        key = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                       for q in path)
        out[prefix + key] = np.asarray(leaf, np.float32)


toks, labels = jnp.asarray(inp["tokens"]), jnp.asarray(inp["labels"])
for arch in %(archs)r:
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    par = ParallelConfig(tp=4, dp=1, overlap_mode="xla",
                         scatter_axis="hidden")
    mesh = Mesh(np.array(jax.devices()).reshape(1, 4), ("data", "model"))
    params = M.init_model(jax.random.PRNGKey(0), cfg, par, dtype=jnp.float32)
    if cfg.qkv_bias:   # the reference inits the bias to zero
        mix = params["periods"][0]["mixer"]
        rng = np.random.default_rng(1)
        mix["bqkv"] = jnp.asarray(
            0.1 * rng.standard_normal(mix["bqkv"].shape), jnp.float32)
    specs = M.param_specs(cfg, par, params)
    reps = adamw.model_replicated_tree(specs)
    ranked = jax.tree.map(lambda _: P("model"), params)
    ctx = T.make_ctx(cfg, par, mesh)
    assert not ctx.seq_sharded

    def body(p, t, l):
        loss, g = jax.value_and_grad(lambda q: M.forward_loss(
            q, {"tokens": t, "labels": l}, ctx, cfg, par))(p)
        gs = jax.tree.map(lambda a_, r: jax.lax.psum(a_, "model")
                          if r else a_, g, reps)
        return (loss, jax.tree.map(lambda a_: a_[None], g),
                jax.tree.map(lambda a_: a_[None], gs))

    f = jax.jit(functools.partial(
        shard_map, mesh=mesh, in_specs=(specs, P(), P()),
        out_specs=(P(), ranked, ranked), check_vma=False)(body))
    loss, g, gs = f(params, toks, labels)
    out[f"{arch}/loss"] = np.asarray(loss)
    save(params, f"{arch}/params/")
    save(g, f"{arch}/grads/")
    save(gs, f"{arch}/gradsum/")
np.savez(OUT, **out)
print("REF_OK")
"""


def _op_inputs(s):
    rng = np.random.default_rng(s)

    def normal(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    w = s // N
    pr_rep = normal(N, B, s, D)
    return {"x": normal(B, s, D), "w1": normal(D, F, scale=0.2),
            "w3": normal(D, F, scale=0.2), "bias": normal(F),
            "y": normal(B, s, F), "w2": normal(F, D, scale=0.2),
            "res": normal(B, s, D), "bias_d": normal(D),
            "pr_col": normal(N, B, s, F // N), "pr_rep": pr_rep,
            # an rs op's probe: each rank's own sequence rows
            "pr_seq": np.stack([pr_rep[r][:, r * w:(r + 1) * w]
                                for r in range(N)])}


def _batch():
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 512, (MB, MS)).astype(np.int32)
    labels = rng.integers(0, 512, (MB, MS)).astype(np.int32)
    labels[1, -5:] = -1
    return toks, labels


@pytest.fixture(scope="module")
def ref(tmp_path_factory, subproc):
    d = tmp_path_factory.mktemp("tp_hidden")
    inp = {f"{s}/{k}": v for s in (S_EVEN, S_ODD)
           for k, v in _op_inputs(s).items()}
    toks, labels = _batch()
    np.savez(d / "in.npz", tokens=toks, labels=labels, **inp)
    code = (_REF % {"modes": MODES, "archs": ARCHS, "s_even": S_EVEN,
                    "s_odd": S_ODD}).replace(
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


def _port_grads(g, fn, args, probes):
    """Every rank of ``g``: its value and the grads of sum(fn(args) *
    its probe), the backward driven from a ``SeamTape``."""
    def body(xs, probe):
        xs = [x.clone().requires_grad_() for x in xs]
        with tov.SeamTape() as tape:
            out = fn(*xs)
            loss = (out * probe).sum()
        tape.backward(loss)
        return out.detach(), [x.grad for x in xs]

    return g.spmd(body, [(args[r], probes[r]) for r in range(N)])


def _op(kind, mode, scatter_axis, epi, n_weights=1):
    return lambda g: tov.FusedOp(kind, axis=g, mode=mode,
                                 scatter_axis=scatter_axis,
                                 epilogue=tov.Epilogue(**epi),
                                 n_weights=n_weights)


# (tag, op builder(mode), call, inputs' shard dims (None: replicated),
#  probe key)
def _ops(mode):
    h = "hidden"
    return [
        ("h_ag_bias", _op("ag", mode, h, dict(bias=True, activation="silu")),
         lambda op: lambda a, b, c: op(a, b, bias=c),
         [("x", None), ("w1", 1), ("bias", 0)], "pr_col"),
        ("h_ag_pair", _op("ag", mode, h, dict(activation="silu",
                                              gate="pair"), 2),
         lambda op: op, [("x", None), ("w1", 1), ("w3", 1)], "pr_col"),
        ("h_rs_res", _op("rs", mode, h, dict(residual=True)),
         lambda op: lambda a, b, c: op(a, b, residual=c),
         [("y", 2), ("w2", 0), ("res", None)], "pr_rep"),
        ("ar_bias_gelu", _op("ar", mode, "seq", dict(bias=True,
                                                     activation="gelu")),
         lambda op: lambda a, b, c: op(a, b, bias=c),
         [("y", 2), ("w2", 0), ("bias_d", None)], "pr_rep"),
    ]


_BIDIR = [
    ("b_ag_bias", _op("ag", "decomposed_bidir", "seq",
                      dict(bias=True, activation="silu")),
     lambda op: lambda a, b, c: op(a, b, bias=c),
     [("x", 1), ("w1", 1), ("bias", 0)], "pr_col"),
    ("b_ag_pair", _op("ag", "decomposed_bidir", "seq",
                      dict(activation="silu", gate="pair"), 2),
     lambda op: op, [("x", 1), ("w1", 1), ("w3", 1)], "pr_col"),
    ("b_rs_res", _op("rs", "decomposed_bidir", "seq", dict(residual=True)),
     lambda op: lambda a, b, c: op(a, b, residual=c),
     [("y", 2), ("w2", 0), ("res", 1)], "pr_seq"),
]


def _check_op(ref, s, tag, build, call, ins, probe, spy=None):
    inp, out = ref
    g = dist.RankGroup(N, "cpu", timeout_s=60)
    if spy is not None:
        real = g.publish

        def publish(x, what):
            spy.add(what)
            return real(x, what)
        g.publish = publish
    args = [[_t(_shard(inp[f"{s}/{k}"], r, dim)) for k, dim in ins]
            for r in range(N)]
    probes = [_t(inp[f"{s}/{probe}"][r]) for r in range(N)]
    res = _port_grads(g, call(build(g)), args, probes)
    want_val = out[f"{s}/{tag}/val"]
    for r in range(N):
        assert _rel(res[r][0].numpy(), want_val[r]) <= OP_RTOL, ("val", r)
        for i in range(len(ins)):
            assert _rel(res[r][1][i].numpy(),
                        out[f"{s}/{tag}/g{i}"][r]) <= OP_RTOL, (i, r)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("i", range(4),
                         ids=["h_ag_bias", "h_ag_pair", "h_rs_res",
                              "ar_bias_gelu"])
def test_hidden_op_value_and_grads_match_reference(ref, i, mode):
    tag, build, call, ins, probe = _ops(mode)[i]
    _check_op(ref, S_EVEN, f"{tag}/{mode}", build, call, ins, probe)


@pytest.mark.parametrize("i", range(3), ids=[o[0] for o in _BIDIR])
def test_bidir_op_value_and_grads_match_reference(ref, i):
    """An even shard: the GEMM transports are the counter-rotating half
    rings, forward and backward (the backward's re-gather of an
    operand for dW rides the one-way ring, as the reference's
    ``gather_seq`` does)."""
    tag, build, call, ins, probe = _BIDIR[i]
    seen = set()
    _check_op(ref, S_EVEN, tag, build, call, ins, probe, spy=seen)
    assert {"ag_bidir", "rs_bidir"} <= seen and "rs_ring" not in seen, seen


@pytest.mark.parametrize("i", range(3), ids=[o[0] for o in _BIDIR])
def test_bidir_odd_shard_takes_the_one_way_ring(ref, i):
    """An odd shard (3 rows a rank) takes the one-way ring, forward and
    backward: the reference's own rule for ``decomposed_bidir``
    (``_ag_bidir`` / ``_rs_bidir``), and its values and grads."""
    tag, build, call, ins, probe = _BIDIR[i]
    seen = set()
    _check_op(ref, S_ODD, tag, build, call, ins, probe, spy=seen)
    assert not ({"ag_bidir", "rs_bidir"} & seen), seen
    assert {"ag_ring", "rs_ring"} <= seen, seen


# ---------------------------------------------------------------------------
# the model in the hidden layout
# ---------------------------------------------------------------------------
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


def _cfg(arch):
    return dataclasses.replace(get_smoke_config(arch),
                               compute_dtype="float32")


def _rank_grads(ranks, cfg, par):
    group = dist.RankGroup(N, "cpu", timeout_s=60)
    ctx = TT.make_ctx(cfg, par, group)
    toks, labels = _batch()
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}

    def step(p):
        loss, grads = TT.loss_and_grads(p, batch, ctx, cfg, par)
        done = TT.complete_grads(grads, TM.replicated_leaves(cfg, p), group)
        return loss, grads, done

    assert ctx.seq_sharded == (par.scatter_axis != "hidden")
    return group.spmd(step, [(p,) for p in ranks])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_hidden_layout_loss_and_grads_match_reference(ref, arch, mode):
    """Every rank's loss and grads before and after the trainer's psum;
    then the seq layout's canonical grads equal the hidden layout's."""
    _, out = ref
    cfg = _cfg(arch)
    ranks = convert.rank_params_from_jax(
        _tree(out, f"{arch}/params/"), cfg, N, dtype=torch.float32,
        device="cpu", trainable=True)
    par = ParallelConfig(tp=N, overlap_mode=mode, scatter_axis="hidden")
    outs = _rank_grads(ranks, cfg, par)
    want = float(out[f"{arch}/loss"])
    for r, (loss, grads, done) in enumerate(outs):
        assert abs(loss.item() - want) <= LOSS_RTOL * abs(want)
        for what, named in (("grads", grads), ("gradsum", done)):
            got = _flat(convert.to_jax_tree(named, cfg))
            wants = {k[len(f"{arch}/{what}/"):]: v for k, v in out.items()
                     if k.startswith(f"{arch}/{what}/")}
            assert sorted(got) == sorted(wants)
            for key, w in wants.items():
                assert _rel(got[key], w[r]) <= GRAD_RTOL, (what, key, r)
    seq = _rank_grads(ranks, cfg, dataclasses.replace(par,
                                                      scatter_axis="seq"))
    assert abs(seq[0][0].item() - outs[0][0].item()) <= (
        LOSS_RTOL * abs(want))

    def canonical(o):
        return TM.canonical_leaves(TM.gather_rank_leaves(
            [d for _, _, d in o], cfg, ranks[0]), cfg, N, grads=True)

    hid, sq = canonical(outs), canonical(seq)
    for n in sq:
        assert _rel(hid[n].numpy(), sq[n].numpy()) <= LAYOUT_RTOL, n


def test_scatter_axis_resolves_as_the_reference():
    """"auto" is the seq layout (no plan profile); a bad value raises."""
    from repro_torch.parallel.sharding import make_ctx
    g = dist.RankGroup(N, "cpu")
    for axis, seq in (("auto", True), ("seq", True), ("hidden", False)):
        assert make_ctx(ParallelConfig(tp=N, scatter_axis=axis),
                        g).seq_sharded is seq
    assert make_ctx(ParallelConfig()).seq_sharded
    with pytest.raises(ValueError, match="scatter_axis"):
        make_ctx(ParallelConfig(scatter_axis="rows"))

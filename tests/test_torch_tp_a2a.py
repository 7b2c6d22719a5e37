"""The MoE exchange, the MoE layer and MLA at tp=4: the port's ranks against
the reference.

The reference runs once for the whole file, in one subprocess with 4 forced
host devices (``conftest.run_subprocess_devices``), under ``shard_map``;
the port runs the same numpy inputs as the 4 ranks of a ``dist.RankGroup``
on the CPU.  Expert parallelism runs over the TP ranks in both (the
reference's ``ep_axes or (ctx.axis,)``).  fp32 throughout.

* ``FusedOp(kind="a2a")`` at 4 ranks in ``xla`` (the barrier exchanges),
  ``decomposed`` (``comm_chunks`` 0 and 8 -- two pieces a block -- with
  ``reverse`` both ways), ``decomposed_bidir`` and ``flux`` (the shift
  ring): the output and the received buffer against the reference's
  ``_a2a_impl`` within 1e-5 (the same batched GEMMs on the same rows);
  ``a2a_exchange``'s block order and its involution against the
  reference's on a payload that names (source, destination) exactly.
* The op under grad (its backward, ``overlap._A2ASeam``) in every one of
  those modes, each rank recording on a ``SeamTape``: dX, dW1, dW3 and dW2
  of sum(op(x, w1, w3, w2) * probe) on every rank against the reference's
  ``jax.grad`` through its ``_a2a_bwd``, within relative L2 1e-5; and at
  tp=1, where the op is the plain expert FFN under autograd.
* ``moe_train`` on the deepseek_v3_671b SMOKE_CONFIG (4 experts, one a
  rank; top-2; a shared expert), in the sequence-sharded and the
  replicated layout, against the reference's: at the config's capacity
  factor, where capacity drops assignments (per shard under "seq", in one
  global order under "hidden") and the port must evict the same ones; at
  16.0, drop-free, where tp=4 also equals the port's tp=1; on a
  right-padded batch whose padding lies in the last sequence shard, which
  shows that the pad mask reads each rank's global positions.  Outputs
  within 1e-5 (relative to their scale), aux loss within 1e-6 relative.
  Under grad, in each layout and case: the grads of sum(y * probe) +
  aux on every rank, the input's, the router's, the norm's, the rank's
  experts' and the shared expert's, against the reference's ``jax.grad``
  within relative L2 1e-5.
* ``mla_train`` with its cache at tp=4 in both layouts: the output and
  the latent cache ``c`` / rope key ``kr`` (bf16 on both sides) against
  the reference's; the rope key of ranks 1-3 is rotated at their global
  positions.  Under grad in both layouts: the grads of sum(out * probe)
  on every rank, every MLA leaf's and the input's, within relative L2
  1e-5.
* ``model.shard_params`` against the reference's ``param_specs`` cut of
  its tp=4 init (every leaf, the MoE's nested shared expert included),
  and ``count_params_analytic`` at tp=4 against the reference's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert, dist
from repro_torch.configs import base as TB
from repro_torch.core import overlap as tov
from repro_torch.models import attention as TA
from repro_torch.models import ffn as TF
from repro_torch.models import model as TM
from repro_torch.parallel.sharding import TPContext

ARCH = "deepseek_v3_671b"
TP = 4
# the a2a op: x [EP, E_LOC, CAP, DM] a rank, experts (w1, w3) [E_LOC, DM, FF]
EP, E_LOC, CAP, DM, FF = TP, 2, 6, 16, 24
A2A_CASES = [("xla", 0, False), ("decomposed", 0, False),
             ("decomposed", 8, False), ("decomposed", 8, True),
             ("decomposed", 0, True), ("decomposed_bidir", 0, False),
             ("flux", 0, False)]
B, S = 2, 64
S_LOC = S // TP
PAD_LENGTHS = [S, S - 6]          # row 1's padding: the last shard only
MOE_CASES = {"cf1.25": (1.25, None), "cf16": (16.0, None),
             "pad": (1.25, PAD_LENGTHS)}
LAYOUTS = ["seq", "hidden"]
OP_TOL = 1e-5
AUX_RTOL = 1e-6
CACHE_TOL = 2e-2
GRAD_RTOL = 1e-5
# the weight of moe_train's aux loss in the grad tests' objective: large
# enough that the router's grad holds a visible share of it
AUX_W = 1.0

_REF = r"""
import dataclasses, functools
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.configs.base import get_smoke_config, ParallelConfig
from repro.core import overlap as ov
from repro.models import attention as A, ffn as F, model as M
from repro.parallel.sharding import TPContext

inp = dict(np.load(IN))
out = {}

# ---- the a2a op ------------------------------------------------------------
tmesh = Mesh(np.array(jax.devices()), ("tp",))
epi = ov.Epilogue(activation="silu", gate="pair")
x, w1, w3, w2 = (jnp.asarray(inp["a2a/" + k]) for k in ("x", "w1", "w3",
                                                         "w2"))
for mode, cc, rev in %(a2a_cases)r:
    op = ov.FusedOp("a2a", axis=("tp",), mode=mode, comm_chunks=cc,
                    reverse=rev, epilogue=epi, n_weights=3)

    def f(a, b, c, d, op=op):
        o, buf = ov._a2a_impl(op, a, (b, c, d))
        return op(a, b, c, d), o, buf
    got = jax.jit(shard_map(f, mesh=tmesh, in_specs=(P("tp"),) * 4,
                            out_specs=(P("tp"),) * 3, check_vma=False))(
        x, w1, w3, w2)
    key = f"a2a/{mode}/{cc}/{int(rev)}"
    out[key + "/call"], out[key + "/out"], out[key + "/buf"] = (
        np.asarray(g) for g in got)
ex = jax.jit(shard_map(
    lambda a: (ov.a2a_exchange(a, ("tp",)),
               ov.a2a_exchange(ov.a2a_exchange(a, ("tp",)), ("tp",))),
    mesh=tmesh, in_specs=(P("tp"),), out_specs=(P("tp"), P("tp")),
    check_vma=False))(jnp.asarray(inp["a2a/payload"]))
out["a2a/exchange"], out["a2a/involution"] = (np.asarray(e) for e in ex)

# ---- the a2a op's grads: jax.grad through _a2a_bwd, every rank's ------------
probe = jnp.asarray(inp["a2a/probe"])
for mode, cc, rev in %(a2a_cases)r:
    op = ov.FusedOp("a2a", axis=("tp",), mode=mode, comm_chunks=cc,
                    reverse=rev, epilogue=epi, n_weights=3)

    def gbody(a, b, c, d, pr, op=op):
        gr = jax.grad(lambda *q: jnp.sum(op(*q) * pr),
                      argnums=(0, 1, 2, 3))(a, b, c, d)
        return tuple(t[None] for t in gr)
    got = jax.jit(shard_map(gbody, mesh=tmesh, in_specs=(P("tp"),) * 5,
                            out_specs=(P("tp"),) * 4, check_vma=False))(
        x, w1, w3, w2, probe)
    for i, g in enumerate(got):
        out[f"a2a_grad/{mode}/{cc}/{int(rev)}/{i}"] = np.asarray(g)
op1 = ov.FusedOp("a2a", axis=(), epilogue=epi, n_weights=3)
e_loc = w1.shape[0] // len(jax.devices())
got = jax.grad(lambda *q: jnp.sum(op1(*q) * probe[:1]), argnums=(0, 1, 2, 3))(
    x[:1], w1[:e_loc], w3[:e_loc], w2[:e_loc])
for i, g in enumerate(got):
    out[f"a2a_grad/tp1/{i}"] = np.asarray(g)

# ---- moe_train and mla_train ------------------------------------------------
mesh = Mesh(np.array(jax.devices()).reshape(1, 4), ("data", "model"))
base = dataclasses.replace(get_smoke_config("deepseek_v3_671b"),
                           compute_dtype="float32")
moe = F.init_moe(jax.random.PRNGKey(1), base, 4, 4, dtype=jnp.float32)
mla = A.init_mla(jax.random.PRNGKey(2), base, 4, dtype=jnp.float32)
for k, v in moe.items():
    if isinstance(v, dict):
        for k2, v2 in v.items():
            out[f"moe_p/{k}/{k2}"] = np.asarray(v2)
    else:
        out["moe_p/" + k] = np.asarray(v)
for k, v in mla.items():
    out["mla_p/" + k] = np.asarray(v)
col, row, rep = P(None, "model"), P("model", None), P()
moe_spec = {"router": rep, "w1": P("model"), "w3": P("model"),
            "w2": P("model"), "norm": rep,
            "shared": {"w1": col, "w3": col, "w2": row}}
mla_spec = {k: rep for k in mla}
mla_spec.update(w_uq=col, w_ukv=col, w_o=row)
xs = jnp.asarray(inp["x"])
probe_x = jnp.asarray(inp["probe_x"])
stack = P("model")
for layout in ("seq", "hidden"):
    ctx = TPContext(axis="model", seq_shard=layout == "seq")
    xspec = P(None, "model", None) if layout == "seq" else rep
    for case, (cf, lengths) in %(moe_cases)r.items():
        cfg = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, capacity_factor=cf))
        ln = None if lengths is None else jnp.asarray(lengths, jnp.int32)

        def g(p, a, cfg=cfg, ln=ln):
            y, aux = F.moe_train(p, a, ctx, cfg, lengths=ln)
            return y[None], aux[None]
        y, aux = jax.jit(shard_map(g, mesh=mesh, in_specs=(moe_spec, xspec),
                                   out_specs=(stack, stack),
                                   check_vma=False))(moe, xs)
        out[f"moe/{layout}/{case}/y"] = np.asarray(y)
        out[f"moe/{layout}/{case}/aux"] = np.asarray(aux)

        def gr(p, a, pr, cfg=cfg, ln=ln):
            def obj(q, b):
                y, aux = F.moe_train(q, b, ctx, cfg, lengths=ln)
                return jnp.sum(y * pr) + %(aux_w)r * aux
            gp, ga = jax.grad(obj, argnums=(0, 1))(p, a)
            return jax.tree.map(lambda t: t[None], gp), ga[None]
        gp, ga = jax.jit(shard_map(
            gr, mesh=mesh, in_specs=(moe_spec, xspec, xspec),
            out_specs=(jax.tree.map(lambda _: stack, moe_spec,
                                    is_leaf=lambda q: isinstance(q, P)),
                       stack), check_vma=False))(moe, xs, probe_x)
        pre = f"moe_grad/{layout}/{case}/"
        out[pre + "x"] = np.asarray(ga)
        for k, v in gp.items():
            if isinstance(v, dict):
                for k2, v2 in v.items():
                    out[f"{pre}{k}/{k2}"] = np.asarray(v2)
            else:
                out[pre + k] = np.asarray(v)

    def h(p, a):
        o, c = A.mla_train(p, a, ctx, base, with_cache=True)
        return o[None], c["c"][None], c["kr"][None]
    o, c, kr = jax.jit(shard_map(h, mesh=mesh, in_specs=(mla_spec, xspec),
                                 out_specs=(stack,) * 3,
                                 check_vma=False))(mla, xs)
    out[f"mla/{layout}/out"] = np.asarray(o)
    out[f"mla/{layout}/c"] = np.asarray(c, np.float32)
    out[f"mla/{layout}/kr"] = np.asarray(kr, np.float32)

    def hg(p, a, pr):
        gp, ga = jax.grad(lambda q, b: jnp.sum(A.mla_train(q, b, ctx, base)
                                               * pr), argnums=(0, 1))(p, a)
        return jax.tree.map(lambda t: t[None], gp), ga[None]
    gp, ga = jax.jit(shard_map(
        hg, mesh=mesh, in_specs=(mla_spec, xspec, xspec),
        out_specs=({k: stack for k in mla}, stack), check_vma=False))(
        mla, xs, probe_x)
    out[f"mla_grad/{layout}/x"] = np.asarray(ga)
    for k, v in gp.items():
        out[f"mla_grad/{layout}/{k}"] = np.asarray(v)

# ---- the model's specs --------------------------------------------------------
par = ParallelConfig(tp=4, dp=1)
params = M.init_model(jax.random.PRNGKey(0), base, par, dtype=jnp.float32)
specs = M.param_specs(base, par, params)
flat, _ = jax.tree_util.tree_flatten_with_path(params)
flat_s = jax.tree.leaves(specs, is_leaf=lambda s: isinstance(s, P))
for (path, leaf), sp in zip(flat, flat_s):
    key = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                   for q in path)
    out[f"params/{key}"] = np.asarray(leaf, np.float32)
    dims = [i for i, a in enumerate(sp) if a == "model"
            or (isinstance(a, tuple) and "model" in a)]
    out[f"spec/{key}"] = np.asarray(dims[0] if dims else -1)
np.savez(OUT, **out)
print("REF_OK")
"""


def _inputs():
    rng = np.random.default_rng(5)
    inp = {"a2a/x": rng.standard_normal((TP * EP, E_LOC, CAP, DM),
                                        dtype=np.float32),
           "a2a/w1": DM ** -0.5 * rng.standard_normal((TP * E_LOC, DM, FF),
                                                      dtype=np.float32),
           "a2a/w3": DM ** -0.5 * rng.standard_normal((TP * E_LOC, DM, FF),
                                                      dtype=np.float32),
           "a2a/w2": FF ** -0.5 * rng.standard_normal((TP * E_LOC, FF, DM),
                                                      dtype=np.float32)}
    # rank r's block j names (source r, destination j)
    src = np.repeat(np.arange(TP), EP)
    dst = np.tile(np.arange(EP), TP)
    inp["a2a/payload"] = np.broadcast_to(
        (src * EP + dst).astype(np.float32)[:, None], (TP * EP, 3)).copy()
    cfg = TB.get_smoke_config(ARCH)
    # a direction every token shares: the router favours the same experts
    # for most tokens, so the config's capacity factor evicts
    common = rng.standard_normal((cfg.d_model,), dtype=np.float32)
    inp["x"] = (rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
                + 2 * common)
    inp["a2a/probe"] = rng.standard_normal(inp["a2a/x"].shape,
                                           dtype=np.float32)
    inp["probe_x"] = rng.standard_normal((B, S, cfg.d_model),
                                         dtype=np.float32)
    return inp


@pytest.fixture(scope="module")
def ref(tmp_path_factory, subproc):
    d = tmp_path_factory.mktemp("tp_a2a")
    inp = _inputs()
    np.savez(d / "in.npz", **inp)
    code = (_REF % {"a2a_cases": A2A_CASES, "moe_cases": MOE_CASES,
                    "aux_w": AUX_W}).replace(
        "IN)", repr(str(d / "in.npz")) + ")").replace(
        "OUT,", repr(str(d / "out.npz")) + ",")
    assert "REF_OK" in subproc(code, n_devices=TP)
    return inp, dict(np.load(d / "out.npz"))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cut(a, r, dim):
    return a if dim is None else np.split(a, TP, axis=dim)[r]


def _cfg(cf=1.25):
    cfg = dataclasses.replace(TB.get_smoke_config(ARCH),
                              compute_dtype="float32")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


def _close(got, want, tol, what):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol,
                               err_msg=what)


# ---------------------------------------------------------------------------
# the a2a op
# ---------------------------------------------------------------------------
def _a2a_args(inp):
    return [tuple(_t(_cut(inp["a2a/" + k], r, 0))
                  for k in ("x", "w1", "w3", "w2")) for r in range(TP)]


@pytest.mark.parametrize("mode,cc,rev", A2A_CASES)
def test_a2a_op_matches_reference(ref, mode, cc, rev):
    inp, out = ref
    g = dist.RankGroup(TP, "cpu", timeout_s=60)
    op = tov.FusedOp("a2a", tov.Epilogue(activation="silu", gate="pair"), 3,
                     axis=g, mode=mode, comm_chunks=cc, reverse=rev)
    if cc:
        assert tov._sub_chunks(CAP, TP, cc) == 2
    got = g.spmd(lambda x, *ws: (op(x, *ws), *tov._a2a_impl(op, x, ws)),
                 _a2a_args(inp))
    key = f"a2a/{mode}/{cc}/{int(rev)}"
    for i, part in enumerate(("call", "out", "buf")):
        _close(torch.cat([o[i] for o in got]), out[f"{key}/{part}"], OP_TOL,
               f"{key} {part}")
    # the call returns the exchange's output; the received buffer is rank
    # src's block for this rank's experts, whatever the transport
    for r, (call, o, buf) in enumerate(got):
        assert torch.equal(call, o)
        x = inp["a2a/x"].reshape(TP, EP, E_LOC, CAP, DM)
        np.testing.assert_array_equal(buf.numpy(), x[:, r])


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["xla", "flux"])
def test_a2a_op_on_card_matches_cpu(mode):
    """The exchange on the card (the ranks' streams, event-ordered pull
    copies; ``flux`` is the shift ring) equals the CPU group's, fp32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the ranks' streams and events)")
    args = _a2a_args(_inputs())
    got = {}
    for dev in ("cpu", "cuda"):
        g = dist.RankGroup(TP, dev, timeout_s=60)
        op = tov.FusedOp("a2a", tov.Epilogue(activation="silu", gate="pair"),
                         3, axis=g, mode=mode, comm_chunks=8)
        outs = g.spmd(op, [tuple(a.to(dev) for a in r) for r in args])
        got[dev] = torch.cat(outs).cpu()
    torch.testing.assert_close(got["cuda"], got["cpu"], atol=OP_TOL,
                               rtol=OP_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["xla", "flux"])
def test_a2a_op_grads_on_card_match_cpu(mode):
    """The op's backward on the card (the ranks' streams; ``flux`` is the
    shift ring's backward) equals the CPU group's, fp32: dX and the
    experts' grads on every rank."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the ranks' streams and events)")
    inp = _inputs()
    args = _a2a_args(inp)
    probes = [_t(_cut(inp["a2a/probe"], r, 0)) for r in range(TP)]
    got = {}
    for dev in ("cpu", "cuda"):
        g = dist.RankGroup(TP, dev, timeout_s=60)
        op = tov.FusedOp("a2a", tov.Epilogue(activation="silu", gate="pair"),
                         3, axis=g, mode=mode, comm_chunks=8)
        got[dev] = g.spmd(
            lambda a, pr: [t.cpu() for t in _tape_grads(op, a, pr)],
            [(tuple(t.to(dev) for t in a), pr.to(dev))
             for a, pr in zip(args, probes)])
    for r in range(TP):
        for want, have in zip(got["cpu"][r], got["cuda"][r]):
            torch.testing.assert_close(have, want, atol=OP_TOL, rtol=OP_TOL)


def test_a2a_exchange_order_and_involution(ref):
    inp, out = ref
    g = dist.RankGroup(TP, "cpu", timeout_s=60)
    payload = inp["a2a/payload"]
    got = g.spmd(lambda a: (tov.a2a_exchange(a, g),
                            tov.a2a_exchange(tov.a2a_exchange(a, g), g)),
                 [(_t(_cut(payload, r, 0)),) for r in range(TP)])
    ex = torch.cat([o[0] for o in got]).numpy()
    np.testing.assert_array_equal(ex, out["a2a/exchange"])
    np.testing.assert_array_equal(torch.cat([o[1] for o in got]).numpy(),
                                  payload)
    np.testing.assert_array_equal(out["a2a/involution"], payload)
    # block j of rank r's result is what rank j addressed to rank r
    for r in range(TP):
        for j in range(EP):
            assert ex[r * EP + j, 0] == j * EP + r


def _rel(got, want):
    got = got.detach().double().numpy() if torch.is_tensor(got) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _tape_grads(fn, leaves, probe):
    """One rank's grads of sum(fn(*leaves) * probe) (plus the aux term
    when ``fn`` returns (y, aux)), the backward driven from a
    ``SeamTape``: the leaves' grads, in their order (a dict leaf: a dict
    of its grads)."""
    def grad_leaf(v):
        if isinstance(v, dict):
            return {k: grad_leaf(t) for k, t in v.items()}
        return v.detach().clone().requires_grad_()

    leaves = [grad_leaf(v) for v in leaves]
    with tov.SeamTape() as tape:
        out = fn(*leaves)
        if isinstance(out, tuple):
            loss = (out[0] * probe).sum() + AUX_W * out[1]
        else:
            loss = (out * probe).sum()
    tape.backward(loss)

    def grads(v):
        if isinstance(v, dict):
            return {k: grads(t) for k, t in v.items()}
        return torch.zeros_like(v) if v.grad is None else v.grad
    return [grads(v) for v in leaves]


@pytest.mark.parametrize("mode,cc,rev", A2A_CASES)
def test_a2a_op_grads_match_reference(ref, mode, cc, rev):
    """dX, dW1, dW3, dW2 on every rank: the ring's backward (cotangent
    pieces along the dispatch hops, dX back on the inverse ones) or the
    barrier exchanges around the experts' vjp, against ``_a2a_bwd``."""
    inp, out = ref
    g = dist.RankGroup(TP, "cpu", timeout_s=60)
    op = tov.FusedOp("a2a", tov.Epilogue(activation="silu", gate="pair"), 3,
                     axis=g, mode=mode, comm_chunks=cc, reverse=rev)
    probes = [_t(_cut(inp["a2a/probe"], r, 0)) for r in range(TP)]
    got = g.spmd(lambda args, pr: _tape_grads(op, args, pr),
                 [(a, pr) for a, pr in zip(_a2a_args(inp), probes)])
    key = f"a2a_grad/{mode}/{cc}/{int(rev)}"
    for i, what in enumerate(("dX", "dW1", "dW3", "dW2")):
        for r in range(TP):
            assert _rel(got[r][i], out[f"{key}/{i}"][r]) <= GRAD_RTOL, \
                (what, r)


def test_a2a_op_grads_at_tp1_match_reference(ref):
    """At tp=1 the op is the local expert FFN under plain autograd."""
    inp, out = ref
    op = tov.FusedOp("a2a", tov.Epilogue(activation="silu", gate="pair"), 3)
    args = [_t(inp["a2a/x"][:1])] + [_t(inp["a2a/" + k][:E_LOC])
                                     for k in ("w1", "w3", "w2")]
    args = [a.requires_grad_() for a in args]
    (op(*args) * _t(inp["a2a/probe"][:1])).sum().backward()
    for i, a in enumerate(args):
        assert _rel(a.grad, out[f"a2a_grad/tp1/{i}"]) <= GRAD_RTOL, i


# ---------------------------------------------------------------------------
# moe_train and mla_train
# ---------------------------------------------------------------------------
_MOE_DIMS = {"router": None, "w1": 0, "w3": 0, "w2": 0, "norm": None,
             "shared/w1": 1, "shared/w3": 1, "shared/w2": 0}
_MLA_DIMS = {"w_uq": 1, "w_ukv": 1, "w_o": 0}


def _moe_params(out, r=None):
    """The reference's global MoE params (r None) or rank r's cut."""
    p = {"shared": {}}
    for name, dim in _MOE_DIMS.items():
        a = out["moe_p/" + name]
        t = _t(a if r is None else _cut(a, r, dim))
        if name.startswith("shared/"):
            p["shared"][name.split("/")[1]] = t
        else:
            p[name] = t
    return p


def _mla_params(out, r=None):
    return {k[len("mla_p/"):]: _t(v if r is None
                                  else _cut(v, r, _MLA_DIMS.get(
                                      k[len("mla_p/"):])))
            for k, v in out.items() if k.startswith("mla_p/")}


def _rank_x(inp, r, layout):
    return _t(inp["x"][:, r * S_LOC:(r + 1) * S_LOC] if layout == "seq"
              else inp["x"])


def _ctx(g, layout):
    return TPContext(tp=TP, group=g, seq_sharded=layout == "seq")


def _moe_tp4(inp, out, layout, case):
    cf, lengths = MOE_CASES[case]
    cfg = _cfg(cf)
    g = dist.RankGroup(TP, "cpu", timeout_s=60)
    ctx = _ctx(g, layout)
    ln = None if lengths is None else torch.tensor(lengths)
    TF.dropped.clear()
    got = g.spmd(lambda p, x: TF.moe_train(p, x, ctx, cfg, lengths=ln),
                 [(_moe_params(out, r), _rank_x(inp, r, layout))
                  for r in range(TP)])
    return got, TF.drop_totals(TP)


def _tp1_drops(out, x, cfg, lengths):
    """Assignments capacity evicts when one rank routes ``x`` at tp=1."""
    TF.dropped.clear()
    TF.moe_train(_moe_params(out), _t(x), TPContext(), cfg,
                 lengths=None if lengths is None else torch.tensor(lengths))
    return TF.drop_totals()[0]


@pytest.mark.parametrize("case", list(MOE_CASES))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_moe_train_tp4_matches_reference(ref, layout, case):
    inp, out = ref
    got, drops = _moe_tp4(inp, out, layout, case)
    want_y = out[f"moe/{layout}/{case}/y"]
    want_aux = out[f"moe/{layout}/{case}/aux"]
    for r, (y, aux) in enumerate(got):
        _close(y, want_y[r], OP_TOL, f"{layout} {case} rank {r} y")
        np.testing.assert_allclose(float(aux), want_aux[r], rtol=AUX_RTOL,
                                   err_msg=f"{layout} {case} rank {r} aux")
    if case == "cf16":
        assert drops == [0] * TP
    elif case == "cf1.25":
        # capacity evicts here: the port drops what the reference drops
        # (the outputs above agree)
        assert sum(drops) > 0, drops
    cfg, lengths = _cfg(MOE_CASES[case][0]), MOE_CASES[case][1]
    if layout == "hidden":
        # one global order; each rank counts the drops of its own
        # experts, so the ranks' counts add up to tp=1's
        assert sum(drops) == _tp1_drops(out, inp["x"], cfg, lengths)
    else:
        # each rank routes its shard alone (its pad mask at the shard's
        # global positions)
        assert drops == [_tp1_drops(
            out, inp["x"][:, r * S_LOC:(r + 1) * S_LOC], cfg,
            None if lengths is None
            else [n - r * S_LOC for n in lengths]) for r in range(TP)]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_moe_train_drop_free_tp4_equals_tp1(ref, layout):
    inp, out = ref
    got, _ = _moe_tp4(inp, out, layout, "cf16")
    y1, aux1 = TF.moe_train(_moe_params(out), _t(inp["x"]), TPContext(),
                            _cfg(16.0))
    y4 = (torch.cat([y for y, _ in got], dim=1) if layout == "seq"
          else got[0][0])
    _close(y4, y1.numpy(), OP_TOL, f"{layout} tp=4 vs tp=1")
    for _, aux in got:
        assert abs(float(aux) - float(aux1)) <= AUX_RTOL * abs(float(aux1))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_mla_train_tp4_matches_reference(ref, layout):
    inp, out = ref
    cfg = _cfg()
    g = dist.RankGroup(TP, "cpu", timeout_s=60)
    ctx = _ctx(g, layout)
    got = g.spmd(lambda p, x: TA.mla_train(p, x, ctx, cfg, with_cache=True),
                 [(_mla_params(out, r), _rank_x(inp, r, layout))
                  for r in range(TP)])
    for r, (o, cache) in enumerate(got):
        _close(o, out[f"mla/{layout}/out"][r], OP_TOL, f"{layout} out {r}")
        for n in ("c", "kr"):
            assert cache[n].dtype == torch.bfloat16
            assert tuple(cache[n].shape[:2]) == (B, S)
            np.testing.assert_allclose(
                cache[n].float().numpy(), out[f"mla/{layout}/{n}"][r],
                atol=CACHE_TOL, rtol=CACHE_TOL, err_msg=f"{layout} {n} {r}")
    # every rank holds the whole latent cache, and tp=4 computes tp=1's
    o1, c1 = TA.mla_train(_mla_params(out), _t(inp["x"]), TPContext(), cfg,
                          with_cache=True)
    o4 = (torch.cat([o for o, _ in got], dim=1) if layout == "seq"
          else got[0][0])
    _close(o4, o1.numpy(), OP_TOL, f"{layout} tp=4 vs tp=1")
    for _, cache in got:
        assert torch.equal(cache["kr"], got[0][1]["kr"])
        np.testing.assert_allclose(cache["kr"].float().numpy(),
                                   c1["kr"].float().numpy(), atol=CACHE_TOL,
                                   rtol=CACHE_TOL)


def _assert_grads(got, out, prefix, r, what):
    """``got`` (a leaf -> grad dict, nested for the shared expert) against
    the reference's rank-r grads under ``prefix``."""
    for k, v in got.items():
        if isinstance(v, dict):
            _assert_grads(v, out, f"{prefix}{k}/", r, what)
        else:
            assert _rel(v, out[prefix + k][r]) <= GRAD_RTOL, (what, k, r)


@pytest.mark.parametrize("case", list(MOE_CASES))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_moe_train_grads_tp4_match_reference(ref, layout, case):
    """Every rank's grads of sum(y * probe) + aux: the input's and every
    MoE leaf's (the rank's experts, the router, the norm, the shared
    expert), through the aux loss's psum, the moe_a2a seam (seq) or the
    local experts' psum (hidden), and the shared expert's seams."""
    inp, out = ref
    cf, lengths = MOE_CASES[case]
    cfg = _cfg(cf)
    g = dist.RankGroup(TP, "cpu", timeout_s=60)
    ctx = _ctx(g, layout)
    ln = None if lengths is None else torch.tensor(lengths)
    probe = {"seq": lambda r: _t(inp["probe_x"][:, r * S_LOC:(r + 1) * S_LOC]),
             "hidden": lambda r: _t(inp["probe_x"])}[layout]
    got = g.spmd(
        lambda p, x, pr: _tape_grads(
            lambda q, a: TF.moe_train(q, a, ctx, cfg, lengths=ln),
            [p, x], pr),
        [(_moe_params(out, r), _rank_x(inp, r, layout), probe(r))
         for r in range(TP)])
    pre = f"moe_grad/{layout}/{case}/"
    for r, (gp, gx) in enumerate(got):
        assert _rel(gx, out[pre + "x"][r]) <= GRAD_RTOL, ("x", r)
        _assert_grads(gp, out, pre, r, f"{layout} {case}")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_mla_train_grads_tp4_match_reference(ref, layout):
    """Every rank's grads of sum(out * probe): the input's and every MLA
    leaf's, through the up-projections' attn_ag seams, the rope key's
    gather (its transpose a reduce-scatter) and attn_rs."""
    inp, out = ref
    cfg = _cfg()
    g = dist.RankGroup(TP, "cpu", timeout_s=60)
    ctx = _ctx(g, layout)
    probe = {"seq": lambda r: _t(inp["probe_x"][:, r * S_LOC:(r + 1) * S_LOC]),
             "hidden": lambda r: _t(inp["probe_x"])}[layout]
    got = g.spmd(
        lambda p, x, pr: _tape_grads(
            lambda q, a: TA.mla_train(q, a, ctx, cfg), [p, x], pr),
        [(_mla_params(out, r), _rank_x(inp, r, layout), probe(r))
         for r in range(TP)])
    for r, (gp, gx) in enumerate(got):
        assert _rel(gx, out[f"mla_grad/{layout}/x"][r]) <= GRAD_RTOL, r
        _assert_grads(gp, out, f"mla_grad/{layout}/", r, layout)


# ---------------------------------------------------------------------------
# the model's specs and count
# ---------------------------------------------------------------------------
def _tree(flat, prefix):
    """The reference's nested params from "a/0/b"-keyed numpy leaves."""
    root = {}
    for key, leaf in flat.items():
        if not key.startswith(prefix):
            continue
        parts = key[len(prefix):].split("/")
        node = root
        for i, p in enumerate(parts[:-1]):
            nxt = [] if parts[i + 1].isdigit() else {}
            if isinstance(node, list):
                p = int(p)
                while len(node) <= p:
                    node.append(None)
                if node[p] is None:
                    node[p] = nxt
                node = node[p]
            else:
                node = node.setdefault(p, nxt)
        node[parts[-1]] = leaf
    return root


def _port_name(key):
    """The reference's "lead/0/mixer/w_uq" / "periods/0/ffn/shared/w1" /
    "mtp/mixer/w_uq" -> the port's "layers.<i>...." / "mtp...." on the
    smoke config (one leading layer, a one-layer pattern repeated
    once)."""
    parts = key.split("/")
    if parts[0] == "mtp":
        return ".".join(parts)
    if parts[0] == "lead":
        return ".".join(["layers", parts[1]] + parts[2:])
    if parts[0] == "periods":
        return ".".join(["layers", "1"] + parts[2:])
    return key


def test_shard_params_matches_reference_specs(ref):
    """Each rank's leaf is the reference's tp=4 leaf cut along the dim its
    PartitionSpec names (replicated: whole), nested shared expert
    included; the spec dims agree leaf by leaf."""
    _, out = ref
    cfg = _cfg()
    tree = _tree(out, "params/")
    ranks = convert.rank_params_from_jax(tree, cfg, TP, dtype=torch.float32,
                                         device="cpu")
    full = convert.params_from_jax(tree, cfg, dtype=torch.float32,
                                   device="cpu")
    dims = TM._leaf_dims(cfg, full)
    want = {}
    for key, a in out.items():
        if not key.startswith("params/"):
            continue
        name = _port_name(key[len("params/"):])
        rd = int(out["spec/" + key[len("params/"):]])
        if key.startswith("params/periods/") and rd >= 0:
            rd -= 1        # the reference stacks a period's layers on dim 0
            a = a[0]
        want[name] = (a, None if rd < 0 else rd)
    assert set(dims) == set(want)
    assert {n for n in dims if ".ffn.shared." in n} == {
        "layers.1.ffn.shared.w1", "layers.1.ffn.shared.w3",
        "layers.1.ffn.shared.w2"}
    named = [dict(rp.named_parameters()) for rp in ranks]
    for n, (a, dim) in want.items():
        assert dims[n] == dim, n
        if n.startswith("layers.1.") and a.ndim == named[0][n].ndim + 1:
            a = a[0]                           # a replicated period leaf
        for r in range(TP):
            np.testing.assert_array_equal(named[r][n].numpy(),
                                          _cut(a, r, dim),
                                          err_msg=f"{n} rank {r}")
    assert sum(TM.replicated_leaves(cfg, full).values()) == sum(
        d is None for d in dims.values())


@pytest.mark.parametrize("size", ["full", "smoke"])
def test_param_count_tp4_equals_reference(size):
    from repro.configs import base as RB
    from repro.models.model import count_params_analytic as ref_count
    get_r = RB.get_config if size == "full" else RB.get_smoke_config
    get_t = TB.get_config if size == "full" else TB.get_smoke_config
    for active in (False, True):
        got = TM.count_params_analytic(get_t(ARCH), active_only=active,
                                       par=TB.ParallelConfig(tp=TP))
        assert got == ref_count(get_r(ARCH), active_only=active,
                                par=RB.ParallelConfig(tp=TP)), active
    if size == "smoke":
        # the count is the built model's, its MTP head included
        model = TM.init_model(get_t(ARCH), TB.ParallelConfig(tp=TP),
                              dtype=torch.float32, device="cpu")
        assert model.mtp is not None
        assert TM.count_params_analytic(
            get_t(ARCH), par=TB.ParallelConfig(tp=TP)) == sum(
            p.numel() for p in model.parameters())


@pytest.mark.parametrize("fuse13", [False, True], ids=["w1_w3", "w13"])
def test_canonical_leaves_tp4_equal_tp1(fuse13):
    """The same seed at tp=4 (heads, d_ff, the shared expert's width and
    the vocab padded for 4 ranks; w1|w3 packed or not) and at tp=1: the
    ranks' leaves gathered and put in the canonical layout equal tp=1's,
    leaf by leaf, the MLA and MoE leaves included."""
    cfg = _cfg()
    p1 = TM.init_model(cfg, TB.ParallelConfig(), dtype=torch.float32,
                       device="cpu")
    p4 = TM.init_model(cfg, TB.ParallelConfig(tp=TP, fuse_w13=fuse13),
                       dtype=torch.float32, device="cpu")
    ranks = [dict(TM.shard_params(p4, r, TP, cfg).named_parameters())
             for r in range(TP)]
    c4 = TM.canonical_leaves(TM.gather_rank_leaves(ranks, cfg, p4), cfg, TP)
    c1 = TM.canonical_leaves(dict(p1.named_parameters()), cfg, 1)
    assert set(c4) == set(c1)
    # the shared expert's width is padded at tp=4: the layout cuts it off
    padded = dict(p4.named_parameters())["layers.1.ffn.shared.w2"]
    assert padded.shape[0] > c1["layers.1.ffn.shared.w2"].shape[0]
    for n in c1:
        assert torch.equal(c4[n], c1[n]), n

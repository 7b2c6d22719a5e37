"""The quantized wires at tp=4: the port's ranks against the reference.

The reference runs once for the whole file, in one subprocess with 4 forced
host devices (``conftest.run_subprocess_devices``), under ``shard_map``;
the port runs the same numpy inputs as the 4 ranks of a ``dist.RankGroup``
on the CPU, each rank recording on a ``SeamTape``.  fp32 operands, d 256
(two 128-blocks), S 32.

* ``FusedOp`` under each wire (int8, fp8_e4m3, int4) in every (kind,
  mode, layout) that ``autotune.wire_supported`` admits: ag in ``xla``,
  ``decomposed`` (with ``reverse`` and ``comm_chunks`` 8: two pieces a
  shard) and ``decomposed_bidir``, with bias + silu and the gated
  two-weight op; rs with a residual in the ring modes; rs in the
  replicated layout and ar in the ring modes (the quantized two-ring
  AllReduce at an output width divisible by 4, the chunked fp sum at 202,
  which is not); the ``a2a`` exchange in ``xla`` and the ring.  The
  forward within relative L2 1e-4 of the reference's (the same
  quantization of the same values; a last-bit difference of a partial
  sum upstream can move a value across a rounding tie, which shows as
  one quantization step of one element); on every rank the grads of
  sum(op * probe) ``torch.equal`` to the port's own fp-wire op's (the
  backward never rides the wire) and within relative L2 1e-5 of the
  reference's ``jax.grad`` through its wired op.
* ``xla``'s rs / ar under a wire equal the fp wire exactly (the reference
  ignores the knob there); a ``flux`` op with a wire raises.
* ``_ar_ring_quant`` alone against the reference's on the same partials.
* ``error_budget.model_logit_rmse`` on minicpm_2b's smoke config at tp=4
  with the reference's weights and tokens: int8 within the default budget
  (0.05, the reference's own end-to-end test) and within 20 % relative of
  the reference's value (the logits are bf16, and a one-ulp difference of
  a partial can move a quantization tie); int8 < fp8 < int4.
* The encodes: the forward of each wired op performs the encodes its
  transport implies, and its backward none (``wire_encode.calls``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert, dist
from repro_torch.configs import base as TB
from repro_torch.core import overlap as tov
from repro_torch.tuning import autotune as tauto
from repro_torch.tuning import error_budget as tbudget

TP = 4
WIRES = ["int8", "fp8_e4m3", "int4"]
B, S, D, F, M_AR = 2, 32, 256, 256, 4
EP, E_LOC, CAP, FF = TP, 2, 8, 32
VAL_RTOL = 1e-4
GRAD_RTOL = 1e-5
LOGIT_REL = 0.20
# tag -> (kind, mode, comm_chunks, reverse, variant); the variant picks the
# epilogue and operands: "bias" (bias + silu), "pair" (silu pair gate over
# two weights), "res" (residual), "hidden" (the replicated layout), "w256"
# / "w202" (the ar output width)
CASES = {
    "ag/xla/bias": ("ag", "xla", 0, False, "bias"),
    "ag/dec/bias": ("ag", "decomposed", 0, False, "bias"),
    "ag/dec8r/bias": ("ag", "decomposed", 8, True, "bias"),
    "ag/dec8/pair": ("ag", "decomposed", 8, False, "pair"),
    "ag/bidir/bias": ("ag", "decomposed_bidir", 0, False, "bias"),
    "ag/bidir/pair": ("ag", "decomposed_bidir", 0, False, "pair"),
    "rs/xla/res": ("rs", "xla", 0, False, "res"),
    "rs/dec/res": ("rs", "decomposed", 0, False, "res"),
    "rs/decr/res": ("rs", "decomposed", 0, True, "res"),
    "rs/bidir/res": ("rs", "decomposed_bidir", 0, False, "res"),
    "rsh/xla": ("rs", "xla", 0, False, "hidden"),
    "rsh/dec": ("rs", "decomposed", 0, False, "hidden"),
    "rsh/bidir": ("rs", "decomposed_bidir", 0, False, "hidden"),
    "ar/xla/w256": ("ar", "xla", 0, False, "w256"),
    "ar/dec/w256": ("ar", "decomposed", 0, False, "w256"),
    "ar/dec/w202": ("ar", "decomposed", 0, False, "w202"),
    "ar/bidir/w256": ("ar", "decomposed_bidir", 0, False, "w256"),
    "a2a/xla": ("a2a", "xla", 0, False, "a2a"),
    "a2a/dec": ("a2a", "decomposed", 0, False, "a2a"),
    "a2a/dec8r": ("a2a", "decomposed", 8, True, "a2a"),
}

_REF = r"""
import dataclasses, functools
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.configs.base import ParallelConfig, get_smoke_config
from repro.core import overlap as ov
from repro.models import model as M
from repro.tuning import error_budget

inp = dict(np.load(IN))
out = {}
mesh = Mesh(np.array(jax.devices()), ("tp",))
R = P("tp")
seq, col, rep = P(None, "tp", None), P(None, None, "tp"), P()
WIRES = %(wires)r


def epilogue(variant):
    return {"bias": ov.Epilogue(bias=True, activation="silu"),
            "pair": ov.Epilogue(activation="silu", gate="pair"),
            "res": ov.Epilogue(residual=True),
            "a2a": ov.Epilogue(activation="silu", gate="pair")}.get(
                variant, ov.Epilogue())


def operands(kind, variant):
    # (names, in specs, probe name, output spec)
    if kind == "ag":
        if variant == "pair":
            return (("x", "w1", "w3"), (seq, P(None, "tp"), P(None, "tp")),
                    "g_col", col)
        return (("x", "w1", "bias"), (seq, P(None, "tp"), R), "g_col", col)
    if kind == "rs" and variant == "res":
        return (("y", "w2", "res"), (col, P("tp", None), seq), "g_seq", seq)
    if kind == "rs":
        return (("y", "w2"), (col, P("tp", None)), "g_rep", rep)
    if kind == "ar":
        w = "w_ar" + variant[1:]
        return (("y_ar", w), (col, P("tp", None)), "g_ar" + variant[1:],
                rep)
    return (("a2a_x", "a2a_w1", "a2a_w3", "a2a_w2"), (R,) * 4, "a2a_g", R)


def make_op(kind, mode, cc, rev, variant, wire):
    if kind == "a2a":
        return ov.FusedOp("a2a", axis=("tp",), mode=mode, comm_chunks=cc,
                          reverse=rev, epilogue=epilogue(variant),
                          n_weights=3, wire_dtype=wire)
    return ov.FusedOp(kind, axis="tp", mode=mode, comm_chunks=cc,
                      reverse=rev, epilogue=epilogue(variant),
                      n_weights=2 if variant == "pair" else 1,
                      scatter_axis="hidden" if variant == "hidden" else "seq",
                      wire_dtype=wire)


def call(op, variant, args):
    if variant == "bias":
        return op(args[0], args[1], bias=args[2])
    if variant == "res":
        return op(args[0], args[1], residual=args[2])
    return op(*args)


for tag, (kind, mode, cc, rev, variant) in %(cases)r.items():
    names, specs, probe, ospec = operands(kind, variant)
    args = tuple(jnp.asarray(inp[n]) for n in names)
    g = jnp.asarray(inp[probe])
    ops = [make_op(kind, mode, cc, rev, variant, w) for w in WIRES]

    def body(*a, ops=ops, variant=variant):
        *xs, pr = a
        vals, grads = [], []
        for op in ops:
            f = lambda *q, op=op: call(op, variant, q)
            vals.append(f(*xs))
            gr = jax.grad(lambda *q, f=f: jnp.sum(f(*q) * pr),
                          argnums=tuple(range(len(xs))))(*xs)
            grads.append(tuple(t[None] for t in gr))
        return tuple(vals), tuple(grads)
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=tuple(specs) + (ospec,),
                           out_specs=((ospec,) * len(ops),
                                      ((R,) * len(names),) * len(ops)),
                           check_vma=False))
    vals, grads = fn(*args, g)
    for w, v, gr in zip(WIRES, vals, grads):
        out[f"{tag}/{w}/val"] = np.asarray(v)
        for i, t in enumerate(gr):
            out[f"{tag}/{w}/g{i}"] = np.asarray(t)

# the quantized AllReduce alone, on each rank's full partial
pq = jnp.asarray(inp["ar_partial"])
aq = jax.jit(shard_map(
    lambda p: tuple(ov._ar_ring_quant(p[0], "tp", w)[None] for w in WIRES),
    mesh=mesh, in_specs=(R,), out_specs=(R,) * len(WIRES),
    check_vma=False))(pq)
for w, a in zip(WIRES, aq):
    out[f"ar_ring_quant/{w}"] = np.asarray(a)

# the reference's end-to-end budget test, its weights and tokens kept
cfg = get_smoke_config("minicpm_2b")
par = ParallelConfig(tp=4, dp=1)
out["e2e/int8"] = np.asarray(
    error_budget.model_logit_rmse(cfg, par, "int8", seq=32))
params = M.init_model(jax.random.PRNGKey(0), cfg, par)
out["e2e/tokens"] = np.asarray(jax.random.randint(
    jax.random.PRNGKey(1), (2, 32), 0, cfg.vocab_size))
flat, _ = jax.tree_util.tree_flatten_with_path(params)
for path, leaf in flat:
    key = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                   for q in path)
    out[f"e2e/params/{key}"] = np.asarray(leaf, np.float32)
np.savez(OUT, **out)
print("REF_OK")
"""


def _inputs():
    rng = np.random.default_rng(11)

    def n(*shape, scale=1.0):
        return scale * rng.standard_normal(shape, dtype=np.float32)
    inp = {"x": n(B, S, D), "w1": n(D, F, scale=D ** -0.5),
           "w3": n(D, F, scale=D ** -0.5), "bias": n(F, scale=0.1),
           "y": n(B, S, F), "w2": n(F, D, scale=F ** -0.5),
           "res": n(B, S, D), "y_ar": n(B, M_AR, F),
           "w_ar256": n(F, 256, scale=F ** -0.5),
           "w_ar202": n(F, 202, scale=F ** -0.5),
           "g_col": n(B, S, F), "g_seq": n(B, S, D), "g_rep": n(B, S, D),
           "g_ar256": n(B, M_AR, 256), "g_ar202": n(B, M_AR, 202),
           "a2a_x": n(TP * EP, E_LOC, CAP, D),
           "a2a_w1": n(TP * E_LOC, D, FF, scale=D ** -0.5),
           "a2a_w3": n(TP * E_LOC, D, FF, scale=D ** -0.5),
           "a2a_w2": n(TP * E_LOC, FF, D, scale=FF ** -0.5),
           "ar_partial": n(TP, B, M_AR, 256)}
    inp["a2a_g"] = n(*inp["a2a_x"].shape)
    return inp


@pytest.fixture(scope="module")
def ref(tmp_path_factory, subproc):
    d = tmp_path_factory.mktemp("tp_wire")
    inp = _inputs()
    np.savez(d / "in.npz", **inp)
    code = (_REF % {"wires": WIRES, "cases": CASES}).replace(
        "IN)", repr(str(d / "in.npz")) + ")").replace(
        "OUT,", repr(str(d / "out.npz")) + ",")
    assert "REF_OK" in subproc(code, n_devices=TP)
    return inp, dict(np.load(d / "out.npz"))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(got, want):
    got = np.asarray(got.detach().double().numpy() if torch.is_tensor(got)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _epilogue(variant):
    return {"bias": tov.Epilogue(bias=True, activation="silu"),
            "pair": tov.Epilogue(activation="silu", gate="pair"),
            "res": tov.Epilogue(residual=True),
            "a2a": tov.Epilogue(activation="silu", gate="pair")}.get(
                variant, tov.Epilogue())


# how each operand is cut over the ranks (None: replicated), by name
_CUT = {"x": 1, "w1": 1, "w3": 1, "bias": 0, "y": 2, "w2": 0, "res": 1,
        "y_ar": 2, "w_ar256": 0, "w_ar202": 0, "g_col": 2, "g_seq": 1,
        "g_rep": None, "g_ar256": None, "g_ar202": None, "a2a_x": 0,
        "a2a_w1": 0, "a2a_w3": 0, "a2a_w2": 0, "a2a_g": 0}


def _names(kind, variant):
    """(operand names, probe name, output cut dim) of one case."""
    if kind == "ag":
        names = ("x", "w1", "w3") if variant == "pair" else ("x", "w1",
                                                             "bias")
        return names, "g_col", 2
    if kind == "rs" and variant == "res":
        return ("y", "w2", "res"), "g_seq", 1
    if kind == "rs":
        return ("y", "w2"), "g_rep", None
    if kind == "ar":
        return ("y_ar", "w_ar" + variant[1:]), "g_ar" + variant[1:], None
    return ("a2a_x", "a2a_w1", "a2a_w3", "a2a_w2"), "a2a_g", 0


def _cut(a, r, dim):
    return a if dim is None else np.split(a, TP, axis=dim)[r]


def _op(group, case, wire):
    kind, mode, cc, rev, variant = case
    return tov.FusedOp(kind, _epilogue(variant),
                       {"pair": 2, "a2a": 3}.get(variant, 1), axis=group,
                       mode=mode, comm_chunks=cc, reverse=rev,
                       scatter_axis="hidden" if variant == "hidden" else "seq",
                       wire_dtype=wire)


def _call(op, variant, args):
    if variant == "bias":
        return op(args[0], args[1], bias=args[2])
    if variant == "res":
        return op(args[0], args[1], residual=args[2])
    return op(*args)


def _run(inp, case, wire, counts=None):
    """Every rank's (output, grads) of sum(op * probe), the backward from
    a SeamTape; ``counts`` collects the encodes of the forward and of the
    backward."""
    kind, _, _, _, variant = case
    names, probe, _ = _names(kind, variant)
    group = dist.RankGroup(TP, "cpu", timeout_s=60)
    op = _op(group, case, wire)
    per_rank = [tuple(_t(_cut(inp[n], r, _CUT[n])) for n in names)
                + (_t(_cut(inp[probe], r, _CUT[probe])),)
                for r in range(TP)]
    phase = {}

    def mark(name):
        # every rank stops here while rank 0 reads the count
        group.barrier(name)
        if group.rank() == 0:
            phase[name] = tov.wire_encode.calls
        group.barrier(name + " read")

    def body(*a):
        *xs, pr = a
        leaves = [x.clone().requires_grad_() for x in xs]
        mark("f0")
        with tov.SeamTape() as tape:
            y = _call(op, variant, leaves)
            loss = (y * pr).sum()
        mark("f1")
        tape.backward(loss)
        mark("b1")
        return y.detach(), [lf.grad for lf in leaves]
    outs = group.spmd(body, per_rank)
    if counts is not None:
        counts["forward"] = phase["f1"] - phase["f0"]
        counts["backward"] = phase["b1"] - phase["f1"]
    return outs


def _assemble(outs, kind, variant):
    _, _, dim = _names(kind, variant)
    if dim is None:
        return outs[0][0]
    return torch.cat([o[0] for o in outs], dim=dim)


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("tag", list(CASES))
def test_wired_op_matches_reference(ref, tag, wire):
    inp, out = ref
    case = CASES[tag]
    kind, mode, _, _, variant = case
    scatter = "hidden" if variant == "hidden" else "seq"
    assert tauto.wire_supported(kind, mode, scatter) == (mode != "xla" or
                                                         kind in ("ag",
                                                                  "a2a"))
    got = _run(inp, case, wire)
    fp = _run(inp, case, None)
    val = _assemble(got, kind, variant)
    rel = _rel(val, out[f"{tag}/{wire}/val"])
    assert rel <= VAL_RTOL, (tag, wire, rel)
    dev = _rel(val, _assemble(fp, kind, variant))
    if (mode == "xla" and kind in ("rs", "ar")) or variant == "w202":
        # xla's reductions ignore the wire, and an ar whose width the
        # group does not divide takes the fp chunked sum
        assert dev == 0.0
    else:
        # the wire is lossy, and the loss is finite
        assert 0.0 < dev < 1.0 and bool(torch.isfinite(val).all())
    for r in range(TP):
        for i, (gw, gf) in enumerate(zip(got[r][1], fp[r][1])):
            # the backward never rides the wire: the fp wire's grads
            assert torch.equal(gw, gf), (tag, wire, r, i)
            assert _rel(gw, out[f"{tag}/{wire}/g{i}"][r]) <= GRAD_RTOL, (
                tag, wire, r, i)


# encodes a rank's forward performs, by case (shards of S / TP = 8 rows; the
# a2a ring encodes every (shift, piece), the local one too)
def _encodes(case):
    kind, mode, cc, _, variant = case
    if kind == "ag":
        return 2 if mode == "decomposed_bidir" else 1
    if kind == "a2a":
        return 1 if mode == "xla" else TP * tov._sub_chunks(CAP, TP, cc)
    if mode == "xla" or variant == "w202":
        return 0
    if kind == "rs" and variant == "res":
        return (2 if mode == "decomposed_bidir" else 1) * (TP - 1)
    return TP               # the ar rings: n - 1 hops, one gather encode


@pytest.mark.parametrize("tag", ["ag/dec8/pair", "ag/bidir/bias",
                                 "rs/bidir/res", "rsh/dec", "ar/dec/w202",
                                 "a2a/dec8r", "a2a/xla", "ar/xla/w256"])
def test_wired_op_encodes_forward_only(ref, tag):
    inp, _ = ref
    counts = {}
    _run(inp, CASES[tag], "int8", counts)
    assert counts == {"forward": TP * _encodes(CASES[tag]), "backward": 0}


def test_flux_with_a_wire_raises():
    group = dist.RankGroup(TP, "cpu")
    for wire in WIRES:
        with pytest.raises(ValueError, match="mode='flux'"):
            tov.FusedOp("ag", axis=group, mode="flux", wire_dtype=wire)
    with pytest.raises(ValueError, match="invalid wire_dtype"):
        tov.FusedOp("ag", axis=group, mode="decomposed", wire_dtype="int2")


@pytest.mark.parametrize("wire", WIRES)
def test_ar_ring_quant_matches_reference(ref, wire):
    inp, out = ref
    group = dist.RankGroup(TP, "cpu", timeout_s=60)
    got = group.spmd(lambda p: tov._ar_ring_quant(p, group, wire),
                     [(_t(inp["ar_partial"][r]),) for r in range(TP)])
    want = out[f"ar_ring_quant/{wire}"]
    for r in range(TP):
        assert _rel(got[r], want[r]) <= VAL_RTOL
    exact = inp["ar_partial"].sum(0)
    assert 0.0 < _rel(got[0], exact) < 1.0


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


def test_model_logit_rmse_matches_reference(ref):
    _, out = ref
    cfg = TB.get_smoke_config("minicpm_2b")
    par = TB.ParallelConfig(tp=TP)
    ranks = convert.rank_params_from_jax(_tree(out, "e2e/params/"), cfg, TP,
                                         dtype=torch.bfloat16, device="cpu")
    tokens = _t(out["e2e/tokens"]).long()
    group = dist.RankGroup(TP, "cpu", timeout_s=120)
    got = {w: tbudget.model_logit_rmse(cfg, par, w, device="cpu",
                                       group=group, params=ranks,
                                       tokens=tokens) for w in WIRES}
    want = float(out["e2e/int8"])
    assert 0.0 < got["int8"] <= tbudget.DEFAULT_MAX_LOGIT_RMSE
    assert got["int8"] == pytest.approx(want, rel=LOGIT_REL), (got, want)
    assert got["int8"] < got["fp8_e4m3"] < got["int4"]
    assert tbudget.model_logit_rmse(cfg, par, None, device="cpu") == 0.0
    # the same seeded draw without the reference's weights stays in budget
    own = tbudget.model_logit_rmse(cfg, par, "int8", device="cpu",
                                   group=group, seq=32)
    assert 0.0 < own <= tbudget.DEFAULT_MAX_LOGIT_RMSE


def test_replicated_layout_rs_rides_the_quantized_ring(ref):
    """An rs seam in the replicated layout is the ar op, and under a wire
    its AllReduce is the two quantized rings, as the reference's (its
    value against the reference's is in the op test): a flux plan for it
    keeps the fp wire under ``with_wire_dtype``."""
    from repro_torch.tuning import plans as tplans
    inp, _ = ref
    counts = {}
    _run(inp, CASES["rsh/bidir"], "fp8_e4m3", counts)
    assert counts["forward"] == TP * TP and counts["backward"] == 0
    ps = tplans.PlanSet.uniform("flux").with_scatter_axis(
        "hidden").with_wire_dtype("int4")
    assert ps.resolve("mlp_rs").wire_dtype is None
    ps = dataclasses.replace(ps, default=tplans.SeamPlan(
        mode="decomposed", scatter_axis="hidden")).with_wire_dtype("int4")
    assert ps.resolve("mlp_rs").op("rs", scatter_axis="hidden").wire_dtype \
        == "int4"


# ---------------------------------------------------------------------------
# a train step under a wire: minicpm_2b smoke, fp32, tp=4
# ---------------------------------------------------------------------------
def _train_cfg():
    return dataclasses.replace(TB.get_smoke_config("minicpm_2b"),
                               compute_dtype="float32", num_layers=3,
                               leading_dense_layers=1)


def _train_step(cfg, par, ranks, counts):
    """Every rank's (loss, grads) of one step, the encodes of its forward
    and of its backward in ``counts``."""
    from repro_torch.runtime import trainer as TT
    group = dist.RankGroup(TP, "cpu", timeout_s=60)
    ctx = TT.make_ctx(cfg, par, group)
    rng = np.random.default_rng(2)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)))
             for k in ("tokens", "labels")}
    phase = {}

    def mark(name):
        group.barrier(name)
        if group.rank() == 0:
            phase[name] = tov.wire_encode.calls
        group.barrier(name + " read")

    def step(p):
        mark("f0")
        tape, loss = TT.forward_on_tape(p, batch, ctx, cfg, par)
        mark("f1")
        grads = TT.grads_from_tape(p, tape, loss)
        mark("b1")
        return loss.detach(), grads
    outs = group.spmd(step, [(p,) for p in ranks])
    counts.update(forward=phase["f1"] - phase["f0"],
                  backward=phase["b1"] - phase["f1"])
    return outs


def _step_encodes(mode, layout):
    """(a layer's, the LM head's) encodes on a rank's forward under a
    uniform wired plan set: two ag seams (one encode a shard; bidir two
    halves; xla one) and two rs seams (n - 1 hops; bidir two rings; xla
    none), then the head's ag; in the replicated layout the ag seams have
    no collective and each rs seam is the quantized AllReduce (n - 1 hops
    and one gather encode; xla none)."""
    if layout == "hidden":
        return (0 if mode == "xla" else 2 * TP), 0
    if mode == "xla":
        return 2, 1
    k = 2 if mode == "decomposed_bidir" else 1
    return 2 * (k + k * (TP - 1)), k


@pytest.mark.parametrize("layout", ["seq", "hidden"])
@pytest.mark.parametrize("mode,wire", [("decomposed", "int8"),
                                       ("decomposed_bidir", "fp8_e4m3"),
                                       ("xla", "int4")])
def test_train_step_under_a_wire(mode, wire, layout):
    """The loss moves by the wire's error, the backward encodes nothing
    and the forward encodes what the plans imply; remat's recompute runs
    the wired forward again, so its grads equal the step's without remat
    (and its backward encodes the recomputed blocks' forward)."""
    cfg = _train_cfg()
    par = TB.ParallelConfig(tp=TP, overlap_mode=mode, fuse_w13=True,
                            scatter_axis=layout)
    from repro_torch.models import model as TM
    full = TM.init_model(cfg, par, seed=0, dtype=torch.float32,
                         device="cpu", trainable=True)
    ranks = [TM.shard_params(full, r, TP, cfg) for r in range(TP)]
    fp_counts, counts, rem_counts = {}, {}, {}
    fp = _train_step(cfg, par, ranks, fp_counts)
    wpar = dataclasses.replace(par, wire_dtype=wire)
    got = _train_step(cfg, wpar, ranks, counts)
    rem = _train_step(cfg, dataclasses.replace(wpar, remat="full"), ranks,
                      rem_counts)
    assert fp_counts == {"forward": 0, "backward": 0}
    layer, head = _step_encodes(mode, layout)
    want = cfg.num_layers * layer + head
    assert counts == {"forward": TP * want, "backward": 0}
    # the recompute re-encodes the checkpointed blocks (all but the first)
    assert rem_counts == {"forward": TP * want,
                          "backward": TP * layer * (cfg.num_layers - 1)}
    for (l0, _), (l1, g1), (l2, g2) in zip(fp, got, rem):
        rel = abs(l1.item() - l0.item()) / l0.item()
        assert (rel == 0.0) == (want == 0) and rel < 1e-2
        assert l2.item() == l1.item()
        for n in g1:
            assert _rel(g2[n], g1[n].detach().numpy()) <= 1e-6, n

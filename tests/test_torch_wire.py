"""Wire precision in one process: the port's codec, error budget, wire
sweep and plumbing (``repro_torch.core.overlap.wire_encode`` /
``wire_decode``, ``repro_torch.tuning.error_budget``, the
``wire_dtype`` knob of ``tuning.autotune``, ``tuning.plans``,
``core.planner`` and both CLIs) against the reference's, on the CPU.  The
reference's codec and tuner need no devices, so they run in process.

Tolerances, by what is compared:

* the codec: bit-equal for every wire (int8, fp8_e4m3, int4): the q bytes
  (compared through ``view(uint8)``), the fp32 scales and the decoded
  values, fp32 and bf16 inputs, a zero block, a width that is not a
  multiple of 128 (one block) and int4 at an odd width (unpacked int8).
  XLA's CPU cast to ``float8_e4m3fn`` and torch's give the same bytes on
  these inputs, so fp8 is held bit-equal too.
* the budget's estimates: ``codec_rmse`` and ``seam_wire_rmse`` within 10 %
  relative of the reference's for every (kind, wire) at n 2, 4 and 8 (the
  port draws its proxy payloads with a ``torch.Generator``, the reference
  with ``jax.random``: the estimates agree statistically, not bit for
  bit), and the same within-budget decision at the reference test's
  thresholds (0.05, 0.5, 1.0).
* the tuner: with the same ``rmse_fn`` in both tuners, the analytic
  tables' ``wire_dtype`` / ``logit_rmse`` / ``within_budget`` columns and
  the winners equal; predicted times within relative 1e-9 (the
  reference's v5e terms passed in as ``ect.Hardware``).

The ``gpu``-marked tests run the codec and the wired ops on the card
against the same calls on the CPU (no JAX there) and skip with a reason
without one.
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.configs import base as rbase
from repro.core import ect as rect
from repro.core import overlap as rov
from repro.core import planner as rplanner
from repro.tuning import autotune as rauto
from repro.tuning import error_budget as rbudget
from repro.tuning import plans as rplans
from repro_torch import dist
from repro_torch.configs import base as tbase
from repro_torch.core import ect as tect
from repro_torch.core import overlap as tov
from repro_torch.core import planner as tplanner
from repro_torch.tuning import autotune as tauto
from repro_torch.tuning import cache as tcache
from repro_torch.tuning import error_budget as tbudget
from repro_torch.tuning import plans as tplans

WIRES = ["int8", "fp8_e4m3", "int4"]
# (shape, zero the first 128-block) of the codec cases
CODEC_CASES = {"two_blocks": ((4, 32, 256), False),
               "zero_block": ((2, 16, 256), True),
               "width_200": ((3, 8, 200), False),
               "odd_width": ((2, 5, 127), False),
               "three_blocks": ((2, 7, 384), True)}
BUDGET_RTOL = 0.10
THRESHOLDS = (0.05, 0.5, 1.0)
REL = 1e-9


def _v5e():
    return tect.Hardware(peak_flops=rect.PEAK_FLOPS_BF16, hbm_bw=rect.HBM_BW,
                         link_bw=rect.ICI_BW)


def _bytes(q):
    """A payload's bytes as a numpy uint8 array (either package)."""
    if isinstance(q, torch.Tensor):
        return q.contiguous().view(torch.uint8).numpy()
    return np.asarray(q).view(np.uint8)


def _codec_input(case, seed=0):
    shape, zero = CODEC_CASES[case]
    x = 3 * np.random.default_rng(seed).standard_normal(shape,
                                                        dtype=np.float32)
    if zero:
        x[..., :128] = 0
    return x


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CODEC_CASES))
@pytest.mark.parametrize("wire", WIRES)
def test_codec_matches_reference(wire, case, dtype):
    x = _codec_input(case)
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    qj, sj = rov.wire_encode(xj, wire)
    qt, st = tov.wire_encode(xt, wire)
    assert str(qt.dtype).split(".")[-1] == str(qj.dtype)
    assert tuple(qt.shape) == qj.shape and tuple(st.shape) == sj.shape
    np.testing.assert_array_equal(_bytes(qt), _bytes(qj))
    assert st.dtype == torch.float32
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    dj = np.asarray(rov.wire_decode((qj, sj), wire, xj.dtype), np.float32)
    dt = tov.wire_decode((qt, st), wire, xt.dtype)
    assert dt.dtype == xt.dtype
    np.testing.assert_array_equal(dt.float().numpy(), dj)
    if CODEC_CASES[case][1]:
        # an all-zero block decodes to exact zeros, never NaN
        assert torch.equal(dt[..., :128].float(),
                           torch.zeros_like(dt[..., :128].float()))
    assert bool(torch.isfinite(dt.float()).all())


def test_codec_shapes_blocks_and_packing():
    x = torch.from_numpy(_codec_input("two_blocks"))
    q, s = tov.wire_encode(x, "int4")
    assert q.dtype == torch.uint8 and q.shape[-1] == 128
    assert s.shape == (4, 32, 2)                     # two 128-blocks
    _, s200 = tov.wire_encode(torch.ones(3, 200), "int8")
    assert s200.shape == (3, 1)                      # one block
    q_odd, _ = tov.wire_encode(torch.ones(2, 127), "int4")
    assert q_odd.dtype == torch.int8 and q_odd.shape == (2, 127)
    with pytest.raises(ValueError, match="wire_dtype"):
        tov.wire_encode(x, "int2")


def test_int4_nibble_order_matches_reference():
    """Even positions in the low nibble, odd in the high one, sign-extended
    on the way back; the packed bytes equal the reference's."""
    q4 = np.array([[-7, 7, 0, -1, 3, -4, -6, 5]], np.int8)
    packed = tov._int4_pack(torch.from_numpy(q4))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(rov._int4_pack(jnp.asarray(q4))))
    lo, hi = q4[0, 0::2].astype(np.int32), q4[0, 1::2].astype(np.int32)
    np.testing.assert_array_equal(packed.numpy()[0],
                                  ((lo & 0xF) | ((hi & 0xF) << 4)))
    np.testing.assert_array_equal(tov._int4_unpack(packed).numpy(), q4)


def test_wire_encode_counts_calls():
    before = tov.wire_encode.calls
    for wire in WIRES:
        tov.wire_encode(torch.ones(2, 128), wire)
    tov.wire_decode(tov.wire_encode(torch.ones(2, 128), "int8"), "int8",
                    torch.float32)
    assert tov.wire_encode.calls - before == 4


# ---------------------------------------------------------------------------
# the error budget
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("wire", WIRES)
def test_codec_rmse_matches_reference(wire):
    assert tbudget.codec_rmse(None) == 0.0 == rbudget.codec_rmse(None)
    t, r = tbudget.codec_rmse(wire), rbudget.codec_rmse(wire)
    assert t == pytest.approx(r, rel=BUDGET_RTOL)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("kind", ["ag", "rs", "ar", "a2a"])
def test_seam_wire_rmse_matches_reference(kind, n_dev):
    assert tbudget.seam_wire_rmse(kind, 64, 64, 64, n_dev, None) == 0.0
    for wire in WIRES:
        t = tbudget.seam_wire_rmse(kind, 4096, 512, 256, n_dev, wire)
        r = rbudget.seam_wire_rmse(kind, 4096, 512, 256, n_dev, wire)
        assert t == pytest.approx(r, rel=BUDGET_RTOL), (wire, t, r)
        for th in THRESHOLDS:
            assert (t <= th) == (r <= th), (wire, th, t, r)


def test_budget_orders_wires_and_ring_depth():
    """The reference's ``test_error_budget_estimates`` on the port:
    int8 < fp8 < int4, and the ar two-ring compounds past one roundtrip."""
    r = {w: tbudget.codec_rmse(w) for w in WIRES}
    assert r["int8"] < r["fp8_e4m3"] < r["int4"]
    for w in WIRES:
        ag = tbudget.seam_wire_rmse("ag", 4096, 512, 256, 4, w)
        ar = tbudget.seam_wire_rmse("ar", 4096, 512, 256, 4, w)
        assert 0 < ag < ar
    assert tbudget.DEFAULT_MAX_LOGIT_RMSE == rbudget.DEFAULT_MAX_LOGIT_RMSE


# ---------------------------------------------------------------------------
# the wire sweep
# ---------------------------------------------------------------------------
def _const(kind, m, n, k, n_dev, wd):
    # the reference test's injected deviation
    return 0.5


def _per_wire(kind, m, n, k, n_dev, wd):
    return {"int8": 0.01, "fp8_e4m3": 0.04, "int4": 0.3}[wd] * (
        2.0 if kind in ("rs", "ar") else 1.0)


TUNE_CASES = [("ag", 8192, 64, 4096, 4, {}), ("ag", 4096, 1024, 512, 8,
                                               dict(n_weights=2,
                                                    epilogue=True)),
              ("rs", 4096, 512, 1024, 4, {}), ("rs", 8192, 64, 4096, 2, {}),
              ("rs", 4096, 512, 1024, 4, dict(scatter_axis="hidden")),
              ("ar", 8, 2304, 6144, 4, {}), ("a2a", 4096, 1024, 512, 4, {})]


@pytest.mark.parametrize("rmse_fn", [_const, _per_wire])
@pytest.mark.parametrize("budget", [0.05, 1.0, None])
@pytest.mark.parametrize("kind,m,n,k,nd,kw", TUNE_CASES)
def test_tune_seam_wire_table_matches_reference(kind, m, n, k, nd, kw,
                                                budget, rmse_fn):
    common = dict(measure=False, wire_dtypes=tauto.WIRE_DTYPE_SWEEP,
                  max_logit_rmse=budget, rmse_fn=rmse_fn, allow_flux=False,
                  **kw)
    r = rauto.tune_seam(kind, m, n, k, nd, allow_q8=False, **common)
    t = tauto.tune_seam(kind, m, n, k, nd, hw=_v5e(), **common)
    keys = ("mode", "comm_chunks", "reverse", "shared_gather",
            "fuse_epilogue", "scatter_axis", "wire_dtype", "logit_rmse",
            "within_budget")
    assert [tuple(x[f] for f in keys) for x in t.table] == \
        [tuple(x[f] for f in keys) for x in r.table]
    for a, b in zip(t.table, r.table):
        assert a["predicted_s"] == pytest.approx(b["predicted_s"], rel=REL)
    for f in ("mode", "comm_chunks", "reverse", "shared_gather",
              "fuse_epilogue", "scatter_axis", "wire_dtype", "logit_rmse"):
        assert getattr(t.plan, f) == getattr(r.plan, f), f
    assert t.plan.predicted_s == pytest.approx(r.plan.predicted_s, rel=REL)


def test_tune_seam_budget_is_the_gate():
    """The reference's ``test_tune_seam_budget_rejects_seeded_deviation``
    on the port: the int8 wire is predicted faster, but its injected
    deviation breaks the budget, so the fp wire wins; a budget it fits
    lets it win.  The default sweep is the fp wire alone."""
    common = dict(measure=False, wire_dtypes=(None, "int8"), rmse_fn=_const,
                  allow_flux=False, hw=_v5e())
    res = tauto.tune_seam("ag", 8192, 64, 4096, 4, max_logit_rmse=0.05,
                          **common)
    assert res.plan.wire_dtype is None
    fastest = min(res.table, key=lambda r: r["predicted_s"])
    assert fastest["wire_dtype"] == "int8" and not fastest["within_budget"]
    res2 = tauto.tune_seam("ag", 8192, 64, 4096, 4, max_logit_rmse=1.0,
                           **common)
    assert res2.plan.wire_dtype == "int8" and res2.plan.logit_rmse == 0.5
    plain = tauto.tune_seam("ag", 8192, 64, 4096, 4, measure=False,
                            hw=_v5e())
    assert {r["wire_dtype"] for r in plain.table} == {None}
    # the default rmse_fn is the seeded proxy
    res3 = tauto.tune_seam("rs", 4096, 512, 1024, 4, measure=False,
                           hw=_v5e(), wire_dtypes=("int4",), allow_flux=False)
    q = [r for r in res3.table if r["wire_dtype"]]
    assert q and all(r["logit_rmse"] == pytest.approx(
        tbudget.seam_wire_rmse("rs", 4096, 512, 1024, 4, "int4")) for r in q)


@pytest.mark.parametrize("kind,kw", [
    ("ag", {}), ("ag", dict(n_weights=2, epilogue=True)), ("rs", {}),
    ("rs", dict(scatter_axis="hidden")), ("ar", {}), ("a2a", {}),
    ("ag", dict(scatter_axis="hidden"))])
def test_candidate_space_wire_expansion_matches_reference(kind, kw):
    """The wire-expanded space equals the reference's row for row (the
    flux rows: the Hopper tiles in place of the TPU blocks, and never a
    wire); ``wire_supported`` is the reference's."""
    r = rauto.candidate_space(kind, 4096, 1024, 512, 4,
                              wire_dtypes=rauto.WIRE_DTYPE_SWEEP, **kw)
    t = tauto.candidate_space(kind, 4096, 1024, 512, 4,
                              wire_dtypes=tauto.WIRE_DTYPE_SWEEP, **kw)

    def strip(cs):
        return [(c.mode, c.comm_chunks, c.reverse, c.shared_gather,
                 c.fuse_epilogue, c.scatter_axis, c.wire_dtype)
                for c in cs if c.mode != "flux"]
    assert strip(t) == strip(r)
    assert not any(c.wire_dtype for c in t if c.mode == "flux")
    assert tauto.WIRE_DTYPE_SWEEP == rauto.WIRE_DTYPE_SWEEP
    for mode in ("xla", "decomposed", "decomposed_bidir", "flux"):
        for axis in ("seq", "hidden"):
            assert tauto.wire_supported(kind, mode, axis) == \
                rauto.wire_supported(kind, mode, axis)
    # the default is the fp wire alone
    assert {c.wire_dtype for c in tauto.candidate_space(
        kind, 4096, 1024, 512, 4, **kw)} == {None}


# ---------------------------------------------------------------------------
# plans, planner, config and CLIs
# ---------------------------------------------------------------------------
def _hetero(P):
    S = P.SeamPlan
    return P.PlanSet(
        default=S(mode="decomposed"),
        seams={"mlp_ag": S(mode="xla"), "head_ag": S(mode="flux"),
               "attn_rs": S(mode="decomposed_bidir", comm_chunks=8)},
        layers={0: {"attn_ag": S(mode="decomposed", reverse=True),
                    "mlp_rs": S(mode="flux")}})


@pytest.mark.parametrize("wire", WIRES)
def test_plans_stamp_wires_as_the_reference(wire):
    r = _hetero(rplans).with_wire_dtype(wire)
    t = _hetero(tplans).with_wire_dtype(wire)
    assert t.to_json() == r.to_json()
    # flux keeps the fp wire; per-layer overrides are stamped
    assert t.resolve("head_ag").wire_dtype is None
    assert t.resolve("mlp_rs", 0).wire_dtype is None
    assert t.resolve("attn_ag", 0).wire_dtype == wire
    assert t.resolve("mlp_ag").wire_dtype == wire
    plan = tplans.SeamPlan(mode="decomposed", wire_dtype=wire,
                           logit_rmse=0.01).validate()
    rplan = rplans.SeamPlan(mode="decomposed", wire_dtype=wire,
                            logit_rmse=0.01).validate()
    assert plan.to_json() == rplan.to_json()
    assert rplans.SeamPlan.from_json(plan.to_json()) == rplan
    assert tplans.SeamPlan.from_json(rplan.to_json()) == plan
    op = plan.op("ag")
    assert op.wire_dtype == wire


def test_plan_validation_rejects_invalid_wire_as_reference():
    for P in (rplans, tplans):
        with pytest.raises(ValueError, match="wire_dtype"):
            P.SeamPlan(mode="decomposed", wire_dtype="int2").validate()
    with pytest.raises(ValueError, match="wire_dtype"):
        tov.FusedOp("ag", wire_dtype="bf8")
    with pytest.raises(ValueError, match="mode='flux'"):
        tov.FusedOp("rs", mode="flux", wire_dtype="int8")
    with pytest.raises(ValueError, match="mode='flux'"):
        rov.FusedOp("rs", mode="flux", wire_dtype="int8")


def test_profiles_with_wires_open_in_both_packages(tmp_path):
    """A profile each package writes, with a wire in it, opens in the
    other with the same plans."""
    ps, ts = "ref.json", "port.json"
    plan = dict(mode="decomposed", comm_chunks=8, wire_dtype="fp8_e4m3",
                logit_rmse=0.03, source="analytic")
    from repro.tuning import cache as rcache
    rreg = rcache.PlanRegistry.open(str(tmp_path / ps), n_dev=4)
    rreg.record("mlp_rs", "rs", 4096, 2304, 5760,
                rplans.SeamPlan(**plan).validate())
    rreg.save(str(tmp_path / ps))
    treg = tcache.PlanRegistry.open(str(tmp_path / ts), n_dev=4,
                                    backend="cpu")
    treg.record("mlp_rs", "rs", 4096, 2304, 5760,
                tplans.SeamPlan(**plan).validate())
    treg.save(str(tmp_path / ts))
    for path in (ps, ts):
        (entry,) = json.load(open(tmp_path / path))["entries"].values()
        assert entry["plan"]["wire_dtype"] == "fp8_e4m3"
    cell = ("mlp_rs", 4096, 2304, 5760)
    got_t = tcache.PlanRegistry.open(str(tmp_path / ps), n_dev=4,
                                     backend="cpu").lookup(*cell)
    got_r = rcache.PlanRegistry.open(str(tmp_path / ts), n_dev=4,
                                     backend="cpu").lookup(*cell)
    assert got_t is not None and got_r is not None
    assert got_t.to_json() == got_r.to_json()
    assert got_t.wire_dtype == "fp8_e4m3" and got_t.logit_rmse == 0.03


@pytest.mark.parametrize("mode", ["decomposed", "flux", "xla"])
def test_plan_set_from_parallel_stamps_the_wire(mode):
    tpar = tbase.ParallelConfig(tp=4, overlap_mode=mode, wire_dtype="int8")
    rpar = rbase.ParallelConfig(tp=4, overlap_mode=mode, wire_dtype="int8")
    t = tplans.plan_set_from_parallel(tpar, backend="cpu")
    r = rplans.plan_set_from_parallel(rpar)
    assert t.to_json() == r.to_json()
    assert t.default.wire_dtype == (None if mode == "flux" else "int8")
    assert tbase.ParallelConfig().wire_dtype is None
    assert tbase.ParallelConfig().max_logit_rmse is None
    assert (rbase.ParallelConfig().wire_dtype,
            rbase.ParallelConfig().max_logit_rmse) == (None, None)


@pytest.mark.parametrize("kind,m,n,k,nd", [("ag", 8192, 64, 4096, 4),
                                           ("rs", 4096, 512, 1024, 8),
                                           ("ar", 8, 2304, 6144, 4)])
def test_planner_prices_the_pinned_wire(kind, m, n, k, nd):
    """``plan_seam(wire_dtype=)`` prices the wire as the reference's (the
    flux candidates the fp wire), and the cache is keyed by it."""
    fp = tplanner.plan_seam(kind, m, n, k, nd, hw=_v5e())
    for wire in WIRES:
        t = tplanner.plan_seam(kind, m, n, k, nd, wire_dtype=wire,
                               hw=_v5e())
        r = rplanner.plan_seam(kind, m, n, k, nd, wire_dtype=wire)
        assert (t.mode, t.comm_chunks) == (r.mode, r.comm_chunks)
        assert t.predicted_overall_s == pytest.approx(
            r.predicted_overall_s, rel=REL)
        assert tplanner.plan_seam(kind, m, n, k, nd, wire_dtype=wire,
                                  hw=_v5e()) is t
    assert tplanner.plan_seam(kind, m, n, k, nd, hw=_v5e()) is fp
    keys = [key for key in tplanner._CACHE if key[:5] == (kind, m, n, k, nd)]
    assert {key[9] for key in keys} >= {None, *WIRES}


def test_cli_wire_flags_reach_config_and_sweep(tmp_path):
    from repro_torch.launch import serve as LS
    from repro_torch.launch import train as LT
    a = LT.parse_args(["--arch", "minicpm_2b", "--wire-dtype", "int4"])
    assert LT.wire_sweep(a) == (None, "int4")
    a = LT.parse_args(["--arch", "minicpm_2b", "--max-logit-rmse", "0.05"])
    assert LT.wire_sweep(a) == tauto.WIRE_DTYPE_SWEEP
    assert LT.wire_sweep(LT.parse_args(["--arch", "minicpm_2b"])) is None
    # the serve CLI: the wire reaches the Server's config and plans
    srv, done = LS.main(["--arch", "minicpm_2b", "--smoke", "--device",
                         "cpu", "--requests", "2", "--max-new", "2", "--tp",
                         "4", "--mode", "decomposed", "--wire-dtype",
                         "int8"])
    assert srv.par.wire_dtype == "int8"
    assert srv.ctx.plans.resolve("decode_ar").wire_dtype == "int8"
    assert all(len(r.output) == 2 for r in done)
    # --autotune with a budget sweeps every wire (analytic on the CPU)
    path = str(tmp_path / "p.json")
    tr, hist = LT.main(["--arch", "minicpm_2b", "--smoke", "--steps", "1",
                        "--tp", "4", "--batch", "2", "--seq", "32",
                        "--device", "cpu", "--autotune", "--plan-profile",
                        path, "--max-logit-rmse", "0.05"])
    assert tr.par.max_logit_rmse == 0.05 and np.isfinite(hist[0]["loss"])
    doc = json.load(open(path))
    for e in doc["entries"].values():
        assert e["plan"]["logit_rmse"] <= 0.05
        if e["plan"]["wire_dtype"] is not None:
            assert e["plan"]["mode"] != "flux"


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the codec and the ranks' streams on "
                    "the device)")


@pytest.mark.gpu
@pytest.mark.parametrize("wire", WIRES)
def test_codec_on_card_equals_cpu(wire):
    """``wire_encode`` on a CUDA tensor gives the CPU's bytes and scales,
    bf16 and fp32, every edge case."""
    _cuda()
    for case in CODEC_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(_codec_input(case)).to(dtype)
            qc, sc = tov.wire_encode(x, wire)
            qg, sg = tov.wire_encode(x.cuda(), wire)
            assert torch.equal(qg.cpu().view(torch.uint8),
                               qc.view(torch.uint8)), (case, dtype)
            assert torch.equal(sg.cpu(), sc)
            assert torch.equal(tov.wire_decode((qg, sg), wire, dtype).cpu(),
                               tov.wire_decode((qc, sc), wire, dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("kind,mode", [("ag", "xla"), ("ag", "decomposed"),
                                       ("ag", "decomposed_bidir"),
                                       ("rs", "decomposed"), ("ar",
                                                              "decomposed")])
def test_wired_op_on_card_equals_cpu(kind, mode):
    """A wired op at 4 ranks on the card (pull copies of the (q, scale)
    pairs on the ranks' streams) against the CPU group's, fp32: the
    forward within relative L2 1e-3, and on each device the grads equal
    the fp wire's."""
    _cuda()
    g = torch.Generator().manual_seed(0)
    n, s, d, f = 4, 32, 256, 256
    if kind == "ag":
        args = [(torch.randn(2, s // n, d, generator=g),
                 torch.randn(d, f // n, generator=g) / 16) for _ in range(n)]
    else:
        args = [(torch.randn(2, s, f // n, generator=g),
                 torch.randn(f // n, d, generator=g) / 16) for _ in range(n)]
    outs = {}
    for dev in ("cpu", "cuda"):
        grp = dist.RankGroup(n, dev, timeout_s=60)
        dev_args = [tuple(t.to(dev) for t in a) for a in args]

        def run(wire):
            op = tov.FusedOp(kind, axis=grp, mode=mode, wire_dtype=wire)

            def body(x, w):
                x, w = (t.clone().requires_grad_() for t in (x, w))
                with tov.SeamTape() as tape:
                    y = op(x, w)
                tape.backward(y.sum())
                return y.detach().cpu(), x.grad.cpu(), w.grad.cpu()
            return grp.spmd(body, dev_args)
        outs[dev] = {w: run(w) for w in (None, "int8")}
        for (_, gx0, gw0), (_, gx1, gw1) in zip(outs[dev][None],
                                                outs[dev]["int8"]):
            assert torch.equal(gx0, gx1) and torch.equal(gw0, gw1)
    # the same quantization up to a rounding tie that a last-bit
    # difference of the GEMMs' sums can move: relative L2 1e-3
    for a, b in zip(outs["cuda"]["int8"], outs["cpu"]["int8"]):
        assert float((a[0] - b[0]).norm() / b[0].norm()) <= 1e-3

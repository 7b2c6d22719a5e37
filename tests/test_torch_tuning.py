"""The port's seam plans, profile cache, planner and tuner
(``repro_torch.tuning``, ``repro_torch.core.planner``) against the
reference's (``repro.tuning``, ``repro.core.planner``), in one process on
the CPU (the reference's tuning modules need no devices here: its tuner is
analytic with one device).

* ``SeamPlan`` / ``PlanSet``: validation, resolution order, ``override``,
  ``uniform``, ``residual_layout`` (and its incoherent-layout raise),
  ``with_scatter_axis``; every ``to_json`` equal to the reference's.
* ``PlanRegistry``: a save/open round trip; stale on version, mesh or
  backend; a missing or corrupt file loads empty.  The reference's
  committed ``experiments/plans/minicpm_2b_tp4.json`` opened by the port
  gives the ``PlanSet`` the reference's ``plan_set_from_parallel`` gives
  (JSON equal), and a profile the port writes opens in the reference.
* ``plan_seam`` / ``plan_model`` and the analytic ``tune_seam`` with the
  reference's v5e terms passed in as ``Hardware``, over a grid of (kind,
  m, n, k, n_dev in {2, 4, 8}) and the fusion knobs: the winner's mode,
  comm_chunks, reverse, shared_gather and fuse_epilogue equal, its
  predicted time within relative 1e-9, and every non-flux row of the
  table priced the same.  ``blocks`` differ by design (Hopper tiles
  against TPU blocks).
* ``candidate_space``'s structure (the reference's
  ``test_candidate_space_sweeps_fusion_knobs``, with the flux rows the two
  Hopper tiles), and ``prune_infeasible`` on operands the kernels refuse.
* ``model_seam_shapes`` and ``sweep_model_layout`` equal to the
  reference's for minicpm_2b, codeqwen15_7b and deepseek_v3_671b at tp
  1, 4 and 8.
* ``autotune_model`` (analytic) builds, persists, and serves a second run
  from the registry; a measured ``tune_seam`` on a CPU ``RankGroup(4)``
  returns the argmin of a fully timed table, the MoE exchange's (``a2a``)
  over the reference's candidates; the a2a bench's operands are the
  reference's ``_bench_callable``'s, cut over the ranks; a measured
  ``autotune_model`` of the deepseek_v3_671b smoke config plans its
  ``moe_a2a`` cell.
"""
import dataclasses
import json
import os

import pytest
import torch

from repro.configs import base as rbase
from repro.core import ect as rect
from repro.core import planner as rplanner
from repro.tuning import autotune as rauto
from repro.tuning import cache as rcache
from repro.tuning import plans as rplans
from repro_torch import dist
from repro_torch.configs import base as tbase
from repro_torch.core import ect as tect
from repro_torch.core import planner as tplanner
from repro_torch.kernels import matmul as mm
from repro_torch.tuning import autotune as tauto
from repro_torch.tuning import cache as tcache
from repro_torch.tuning import plans as tplans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_PROFILE = os.path.join(REPO, "experiments", "plans", "minicpm_2b_tp4.json")
REL = 1e-9
ARCHS = ["minicpm_2b", "codeqwen15_7b", "deepseek_v3_671b"]
HOPPER_BLOCKS = {(128, 64, 256), (64, 64, 64)}


def _v5e():
    return tect.Hardware(peak_flops=rect.PEAK_FLOPS_BF16, hbm_bw=rect.HBM_BW,
                         link_bw=rect.ICI_BW)


def _both(**kw):
    """The same SeamPlan in each package."""
    return rplans.SeamPlan(**kw).validate(), tplans.SeamPlan(**kw).validate()


def _hetero(P):
    """The reference test_plan_plumbing's heterogeneous PlanSet, built in
    package ``P`` (plus blocks and the fusion knobs)."""
    S = P.SeamPlan
    return P.PlanSet(
        default=S(mode="decomposed"),
        seams={"mlp_ag": S(mode="xla", shared_gather=False),
               "mlp_rs": S(mode="decomposed", comm_chunks=8, reverse=True),
               "attn_ag": S(mode="decomposed_bidir", fuse_epilogue=False),
               "attn_rs": S(mode="decomposed", comm_chunks=16),
               "head_ag": S(mode="flux", blocks=(64, 64, 64))},
        layers={0: {"attn_ag": S(mode="decomposed", reverse=True)}})


# ---------------------------------------------------------------------------
# SeamPlan / PlanSet
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bad", [dict(mode="ring"), dict(comm_chunks=-1),
                                 dict(scatter_axis="batch")],
                         ids=["mode", "comm_chunks", "scatter_axis"])
def test_seam_plan_validation_matches_reference(bad):
    with pytest.raises(ValueError):
        rplans.SeamPlan(**bad).validate()
    with pytest.raises(ValueError):
        tplans.SeamPlan(**bad).validate()


def test_wire_dtype_raises_not_ported():
    """Wire precision is ported: only an invalid wire raises (ValueError,
    as the reference's), and a valid one validates and stamps."""
    with pytest.raises(ValueError, match="wire_dtype"):
        tplans.SeamPlan(mode="decomposed", wire_dtype="int2").validate()
    with pytest.raises(ValueError, match="wire_dtype"):
        tplans.PlanSet().with_wire_dtype("bf8")
    for wd in ("int8", "fp8_e4m3", "int4"):
        assert (tplans.SeamPlan(mode="decomposed", wire_dtype=wd)
                .validate().wire_dtype == wd)
        assert tplans.PlanSet().with_wire_dtype(wd).default.wire_dtype == wd
    assert tplans.PlanSet().with_wire_dtype(None) == tplans.PlanSet()


def test_seam_plan_json_matches_reference():
    kw = dict(mode="flux", comm_chunks=8, reverse=True, blocks=(64, 64, 64),
              fuse_epilogue=False, shared_gather=False, scatter_axis="hidden",
              source="measured", predicted_s=1.5e-4, measured_s=2.5e-4)
    r, t = _both(**kw)
    assert t.to_json() == r.to_json()
    assert tplans.SeamPlan.from_json(r.to_json()) == t
    assert rplans.SeamPlan.from_json(t.to_json()) == r
    # a plan written before the fusion / wire fields loads with defaults
    old = {"mode": "xla", "comm_chunks": 4}
    assert (tplans.SeamPlan.from_json(old).to_json()
            == rplans.SeamPlan.from_json(old).to_json())


def test_plan_set_resolution_order_matches_reference():
    rp, tp = _hetero(rplans), _hetero(tplans)
    assert tp.to_json() == rp.to_json()
    for seam in tplans.KNOWN_SEAMS + ("unknown_seam",):
        for layer in (None, 0, 1, 5):
            assert (tp.resolve(seam, layer).to_json()
                    == rp.resolve(seam, layer).to_json()), (seam, layer)
    assert tp.resolve("attn_ag", 0).reverse
    assert tp.resolve("attn_ag", 1).mode == "decomposed_bidir"
    assert tp.resolve("decode_ar", 0).mode == "decomposed"   # the default


def test_plan_set_override_uniform_and_json_round_trip():
    for P in (rplans, tplans):
        assert P.PlanSet.uniform("flux", 8, True).default.comm_chunks == 8
    ru = rplans.PlanSet.uniform("decomposed_bidir", 16)
    tu = tplans.PlanSet.uniform("decomposed_bidir", 16)
    assert tu.to_json() == ru.to_json()
    r2 = (_hetero(rplans)
          .override("decode_ar", rplans.SeamPlan(mode="xla"))
          .override("mlp_rs", rplans.SeamPlan(mode="flux"), layer=3))
    t2 = (_hetero(tplans)
          .override("decode_ar", tplans.SeamPlan(mode="xla"))
          .override("mlp_rs", tplans.SeamPlan(mode="flux"), layer=3))
    assert t2.to_json() == r2.to_json()
    assert tplans.PlanSet.from_json(r2.to_json()) == t2
    assert (rplans.PlanSet.from_json(t2.to_json()).to_json()
            == r2.to_json())
    assert _hetero(tplans).resolve("mlp_rs", 3).mode == "decomposed"


def test_residual_layout_and_scatter_axis_stamp_match_reference():
    for P in (rplans, tplans):
        hs = _hetero(P)
        assert hs.residual_layout() == "seq"
        assert hs.with_scatter_axis("hidden").residual_layout() == "hidden"
        bad = hs.override("mlp_rs", P.SeamPlan(mode="xla",
                                               scatter_axis="hidden"))
        with pytest.raises(ValueError, match="incoherent"):
            bad.residual_layout()
        # a per-layer override does not take part in the model's layout
        odd = hs.override("attn_ag", P.SeamPlan(scatter_axis="hidden"),
                          layer=2)
        assert odd.residual_layout() == "seq"
    assert (_hetero(tplans).with_scatter_axis("hidden").to_json()
            == _hetero(rplans).with_scatter_axis("hidden").to_json())


@pytest.mark.parametrize("axis", ["auto", "seq", "hidden"])
def test_plan_set_from_parallel_without_profile_matches_reference(axis):
    r = rplans.plan_set_from_parallel(rbase.ParallelConfig(
        tp=4, overlap_mode="flux", comm_chunks=8, scatter_axis=axis))
    t = tplans.plan_set_from_parallel(tbase.ParallelConfig(
        tp=4, overlap_mode="flux", comm_chunks=8, scatter_axis=axis))
    assert t.to_json() == r.to_json()


# ---------------------------------------------------------------------------
# PlanRegistry
# ---------------------------------------------------------------------------
def _registry(n_dev=4, backend="cpu"):
    reg = tcache.PlanRegistry(n_dev=n_dev, backend=backend)
    reg.record("mlp_ag", "ag", 256, 512, 128,
               tplans.SeamPlan(mode="flux", blocks=(64, 64, 64)))
    reg.record("attn_ag@qkv", "ag", 256, 384, 128,
               tplans.SeamPlan(mode="decomposed", comm_chunks=8))
    reg.record("attn_ag@kv_up", "ag", 256, 768, 128,
               tplans.SeamPlan(mode="xla"))
    return reg


def test_registry_round_trip(tmp_path):
    path = str(tmp_path / "p.json")
    reg = _registry()
    reg.save(path)
    back = tcache.PlanRegistry.open(path, n_dev=4, backend="cpu")
    assert back.entries == reg.entries
    assert back.lookup("mlp_ag", 256, 512, 128).blocks == (64, 64, 64)
    assert back.lookup("mlp_ag", 256, 512, 64) is None
    plans = back.seam_plans()
    # the bare seam aliases the largest-FLOPs cell
    assert plans["attn_ag"].mode == "xla"
    assert plans["attn_ag@qkv"].comm_chunks == 8
    # the reference reads the same views from the port's file
    rback = rcache.PlanRegistry.open(path, n_dev=4, backend="cpu")
    assert ({k: p.to_json() for k, p in rback.seam_plans().items()}
            == {k: p.to_json() for k, p in plans.items()})


@pytest.mark.parametrize("what", ["version", "mesh", "backend", "missing",
                                  "corrupt"])
def test_registry_stale_or_unreadable_loads_empty(tmp_path, what):
    path = str(tmp_path / "p.json")
    _registry().save(path)
    n_dev, backend = 4, "cpu"
    if what == "version":
        doc = json.load(open(path))
        doc["version"] = tcache.PROFILE_VERSION + 1
        json.dump(doc, open(path, "w"))
    elif what == "mesh":
        n_dev = 8
    elif what == "backend":
        backend = "cuda"
    elif what == "missing":
        path = str(tmp_path / "absent.json")
    else:
        open(path, "w").write("{not json")
    reg = tcache.PlanRegistry.open(path, n_dev=n_dev, backend=backend)
    assert reg.entries == {} and reg.seam_plans() == {}
    rreg = rcache.PlanRegistry.open(path, n_dev=n_dev, backend=backend)
    assert rreg.entries == {}


def test_reference_profile_opens_to_the_reference_plan_set():
    """The reference's committed profile (tuned on the CPU backend) read by
    the port: the same PlanSet as the reference's plan_set_from_parallel;
    on the card's backend it is stale and the uniform mode stays."""
    for mode in ("decomposed", "flux"):
        r = rplans.plan_set_from_parallel(rbase.ParallelConfig(
            tp=4, overlap_mode=mode, plan_profile=REF_PROFILE))
        t = tplans.plan_set_from_parallel(tbase.ParallelConfig(
            tp=4, overlap_mode=mode, plan_profile=REF_PROFILE), "cpu")
        assert t.seams and t.to_json() == r.to_json()
    stale = tplans.plan_set_from_parallel(tbase.ParallelConfig(
        tp=4, overlap_mode="flux", plan_profile=REF_PROFILE), "cuda")
    assert stale == tplans.PlanSet.uniform("flux")


def test_port_profile_opens_in_the_reference(tmp_path):
    path = str(tmp_path / "port.json")
    cfg = tbase.get_smoke_config("minicpm_2b")
    par = tbase.ParallelConfig(tp=4, overlap_mode="decomposed")
    reg = tcache.PlanRegistry.open(path, n_dev=4, backend="cpu")
    tplan = tauto.autotune_model(cfg, par, hw=_v5e(), tokens_per_dp=256,
                                 decode_batch=8, registry=reg,
                                 save_path=path)
    r = rplans.plan_set_from_parallel(rbase.ParallelConfig(
        tp=4, overlap_mode="decomposed", plan_profile=path))
    t = tplans.plan_set_from_parallel(tbase.ParallelConfig(
        tp=4, overlap_mode="decomposed", plan_profile=path), "cpu")
    assert r.seams and r.to_json() == t.to_json()
    assert {s: p.to_json() for s, p in t.seams.items()} == \
        {s: p.to_json() for s, p in tplan.seams.items()}


# ---------------------------------------------------------------------------
# planner and the analytic tuner, against the reference
# ---------------------------------------------------------------------------
GRID = [(kind, m, n, k, nd)
        for kind, m, n, k in (
            ("ag", 4096, 1024, 512), ("ag", 512, 8192, 2048),
            ("ag", 64, 49152, 12288), ("rs", 4096, 512, 1024),
            ("rs", 8192, 12288, 49152), ("rs", 128, 2048, 4096),
            ("ar", 8, 2304, 6144), ("ar", 64, 4096, 8192))
        for nd in (2, 4, 8)]


@pytest.mark.parametrize("kind,m,n,k,nd", GRID)
def test_plan_seam_matches_reference(kind, m, n, k, nd):
    rp = rplanner.plan_seam(kind, m, n, k, nd)
    tp = tplanner.plan_seam(kind, m, n, k, nd, hw=_v5e())
    assert (tp.mode, tp.comm_chunks, tp.reverse) == (rp.mode, rp.comm_chunks,
                                                     rp.reverse)
    assert tp.predicted_overall_s == pytest.approx(rp.predicted_overall_s,
                                                   rel=REL)
    assert tp.predicted_overlap_eff == pytest.approx(
        rp.predicted_overlap_eff, rel=REL, abs=1e-12)
    assert tp.blocks in HOPPER_BLOCKS
    pinned = tplanner.plan_seam(kind, m, n, k, nd, reverse=True, hw=_v5e())
    assert pinned.reverse and pinned.mode == tp.mode


def test_plan_model_matches_reference():
    for nd in (2, 4, 8):
        r = rplanner.plan_model(2304, 5760, 4096, nd)
        t = tplanner.plan_model(2304, 5760, 4096, nd, hw=_v5e())
        for seam in ("mlp_ag", "mlp_rs"):
            assert (t[seam].mode, t[seam].comm_chunks) == (r[seam].mode,
                                                           r[seam].comm_chunks)
            assert t[seam].predicted_overall_s == pytest.approx(
                r[seam].predicted_overall_s, rel=REL)


FUSION = [dict(), dict(n_weights=2, epilogue=True), dict(epilogue=True),
          dict(scatter_axis="hidden"), dict(n_weights=2, epilogue=True,
                                            scatter_axis="hidden")]


@pytest.mark.parametrize("kind,m,n,k,nd", GRID)
def test_analytic_tune_seam_matches_reference(kind, m, n, k, nd):
    for kw in FUSION:
        if kind != "ag" and (kw.get("n_weights", 1) > 1):
            continue
        r = rauto.tune_seam(kind, m, n, k, nd, measure=False, allow_q8=False,
                            **kw)
        t = tauto.tune_seam(kind, m, n, k, nd, measure=False, hw=_v5e(),
                            **kw)
        assert t.source == "analytic" and t.kind == kind
        for f in ("mode", "comm_chunks", "reverse", "shared_gather",
                  "fuse_epilogue", "scatter_axis"):
            assert getattr(t.plan, f) == getattr(r.plan, f), (f, kw)
        assert t.plan.predicted_s == pytest.approx(r.plan.predicted_s,
                                                   rel=REL)
        # every non-flux candidate priced identically, in the same order
        keys = ("mode", "comm_chunks", "reverse", "shared_gather",
                "fuse_epilogue", "scatter_axis")
        rrows = [r_ for r_ in r.table if r_["mode"] != "flux"]
        trows = [t_ for t_ in t.table if t_["mode"] != "flux"]
        assert [tuple(x[f] for f in keys) for x in trows] == \
            [tuple(x[f] for f in keys) for x in rrows]
        for a, b in zip(trows, rrows):
            assert a["predicted_s"] == pytest.approx(b["predicted_s"],
                                                     rel=REL)
            assert a["comm_bytes"] == pytest.approx(b["comm_bytes"], rel=REL)
        assert {x["blocks"] for x in t.table if x["mode"] == "flux"} <= \
            HOPPER_BLOCKS


def test_candidate_space_sweeps_fusion_knobs_and_hopper_tiles():
    cands = tauto.candidate_space("ag", 4096, 1024, 512, 4, n_weights=2,
                                  epilogue=True)
    combos = {(c.shared_gather, c.fuse_epilogue) for c in cands
              if c.mode != "xla"}
    assert combos == {(True, True), (True, False), (False, True),
                      (False, False)}
    assert sum(1 for c in cands if c.mode == "xla") == 1
    plain = tauto.candidate_space("ag", 4096, 1024, 512, 4)
    assert all(c.shared_gather and c.fuse_epilogue for c in plain)
    n_xla = sum(1 for c in plain if c.mode == "xla")
    assert len(cands) == 4 * (len(plain) - n_xla) + n_xla
    rs_cands = tauto.candidate_space("rs", 4096, 512, 1024, 4, epilogue=True)
    assert all(c.shared_gather and c.fuse_epilogue for c in rs_cands)
    # flux: the two Hopper tiles x both ring directions
    flux = [c for c in plain if c.mode == "flux"]
    assert {(c.blocks, c.reverse) for c in flux} == {
        (b, r) for b in HOPPER_BLOCKS for r in (False, True)}
    assert {mm.tile_blocks(t) for t in mm.TILES} == HOPPER_BLOCKS
    # fp32: one tile, so the flux rows carry blocks=None
    f32 = tauto.candidate_space("ag", 4096, 1024, 512, 4, dtype_bytes=4)
    assert {c.blocks for c in f32 if c.mode == "flux"} == {None}
    # ring modes: the reference's chunk options; bidir and ar one-way only
    for c in plain:
        if c.mode.startswith("decomposed"):
            assert c.comm_chunks in (4, 8, 16)
            assert not (c.reverse and c.mode == "decomposed_bidir")
    ar = tauto.candidate_space("ar", 8, 2304, 6144, 4)
    assert [c.mode for c in ar] == ["xla"] + ["decomposed"] * 3
    assert not any(c.reverse for c in ar)
    hid = tauto.candidate_space("ag", 4096, 1024, 512, 4,
                                scatter_axis="hidden")
    assert len(hid) == 1 and hid[0].scatter_axis == "hidden"
    # the same non-flux space as the reference
    r = rauto.candidate_space("ag", 4096, 1024, 512, 4, n_weights=2,
                              epilogue=True, allow_q8=False)
    strip = [(c.mode, c.comm_chunks, c.reverse, c.shared_gather,
              c.fuse_epilogue) for c in r if c.mode != "flux"]
    assert strip == [(c.mode, c.comm_chunks, c.reverse, c.shared_gather,
                      c.fuse_epilogue) for c in cands if c.mode != "flux"]


@pytest.mark.parametrize("kind,n,k,nd,dtype_bytes,refused", [
    ("ag", 1024, 512, 4, 2, False), ("ag", 1024, 516, 4, 2, True),
    ("ag", 1028, 512, 4, 2, True), ("rs", 512, 1028, 4, 2, True),
    ("rs", 516, 1024, 4, 2, True), ("ag", 1040, 516, 4, 4, False),
    ("rs", 512, 1024, 16, 2, True)])
def test_prune_infeasible_drops_what_the_kernels_refuse(kind, n, k, nd,
                                                        dtype_bytes, refused):
    """A flux candidate whose rank GEMM has K or N off the 16-byte row
    chunk (8 bf16, 4 fp32), or a GEMM-RS over more ranks than the kernel
    takes, is pruned before pricing; nothing else is."""
    res = tauto.tune_seam(kind, 4096, n, k, nd, measure=False, hw=_v5e(),
                          dtype_bytes=dtype_bytes)
    n_flux = len(tauto.flux_blocks(dtype_bytes)) * 2
    assert res.pruned == (n_flux if refused else 0)
    assert any(r["mode"] == "flux" for r in res.table) != refused


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tp", [1, 4, 8])
def test_model_seam_shapes_and_layout_sweep_match_reference(arch, tp):
    for fuse in (False, True):
        rpar = rbase.ParallelConfig(tp=tp, fuse_w13=fuse)
        tpar = tbase.ParallelConfig(tp=tp, fuse_w13=fuse)
        rcfg, tcfg = rbase.get_config(arch), tbase.get_config(arch)
        r = rauto.model_seam_shapes(rcfg, rpar, 4096, decode_batch=8)
        t = tauto.model_seam_shapes(tcfg, tpar, 4096, decode_batch=8)
        assert t == r
        assert (tauto.model_seam_shapes(tcfg, tpar)["decode_ar"][1]
                == rauto.model_seam_shapes(rcfg, rpar)["decode_ar"][1])
        if tp == 1:
            continue
        rs = rauto.sweep_model_layout(rcfg, rpar, tokens_per_dp=4096)
        ts = tauto.sweep_model_layout(tcfg, tpar, hw=_v5e(),
                                      tokens_per_dp=4096)
        assert ts["winner"] == rs["winner"]
        for axis in ("seq", "hidden"):
            for key in ("overall_s", "act_bytes", "comm_bytes"):
                assert ts[axis][key] == pytest.approx(rs[axis][key], rel=REL)


def test_autotune_model_persists_and_serves_a_second_run(tmp_path,
                                                         monkeypatch):
    cfg = tbase.get_smoke_config("codeqwen15_7b")
    par = tbase.ParallelConfig(tp=4, overlap_mode="decomposed")
    path = str(tmp_path / "codeqwen15_7b_tp4.json")
    reg = tcache.PlanRegistry.open(path, n_dev=4, backend="cpu")
    results = []
    first = tauto.autotune_model(cfg, par, hw=_v5e(), tokens_per_dp=512,
                                 decode_batch=4, registry=reg,
                                 save_path=path, results=results)
    cells = tauto.model_seam_shapes(cfg, par, 512, 4)
    assert {r.seam for r in results} == set(cells)
    assert all(r.source == "analytic" for r in results)
    assert os.path.exists(path)
    # the reference tunes the same config to the same winners
    rplan = rauto.autotune_model(rbase.get_smoke_config("codeqwen15_7b"),
                                 rbase.ParallelConfig(
                                     tp=4, overlap_mode="decomposed"),
                                 tokens_per_dp=512, decode_batch=4,
                                 measure=False)
    for s, p in first.seams.items():
        rp = rplan.seams[s]
        assert ((p.mode, p.comm_chunks, p.reverse, p.shared_gather,
                 p.fuse_epilogue, p.scatter_axis)
                == (rp.mode, rp.comm_chunks, rp.reverse, rp.shared_gather,
                    rp.fuse_epilogue, rp.scatter_axis)), s

    def no_tuning(*a, **kw):
        raise AssertionError("the second run re-tuned a cached seam")
    monkeypatch.setattr(tauto, "tune_seam", no_tuning)
    reg2 = tcache.PlanRegistry.open(path, n_dev=4, backend="cpu")
    second = tauto.autotune_model(cfg, par, hw=_v5e(), tokens_per_dp=512,
                                  decode_batch=4, registry=reg2)
    assert second.to_json() == first.to_json()
    loaded = tplans.plan_set_from_parallel(
        dataclasses.replace(par, plan_profile=path), "cpu")
    for s, p in first.seams.items():
        assert loaded.resolve(s).to_json() == p.to_json()
    # tp=1: nothing to tune
    assert tauto.autotune_model(cfg, tbase.ParallelConfig(), hw=_v5e()) == \
        tplans.PlanSet.uniform("decomposed")


def test_measured_tune_seam_on_cpu_group_is_the_argmin_of_a_timed_table():
    g = dist.RankGroup(4, "cpu", timeout_s=60)
    res = tauto.tune_seam("ag", 64, 64, 32, 4, hw=_v5e(), group=g,
                          measure=True, n_weights=2, epilogue=True,
                          iters=2, warmup=1, dtype_bytes=4)
    assert res.source == "measured" and res.plan.source == "measured"
    assert len(res.table) == len(tauto.candidate_space(
        "ag", 64, 64, 32, 4, modes=("xla", "decomposed", "decomposed_bidir"),
        n_weights=2, epilogue=True, dtype_bytes=4))
    # flux is timed only on the card; every row here was timed
    assert all(r["mode"] != "flux" and r["measured_s"] > 0
               for r in res.table)
    best = min(res.table, key=lambda r: r["measured_s"])
    assert res.plan.measured_s == best["measured_s"]
    assert (res.plan.mode, res.plan.comm_chunks, res.plan.reverse,
            res.plan.shared_gather, res.plan.fuse_epilogue) == \
        (best["mode"], best["comm_chunks"], best["reverse"],
         best["shared_gather"], best["fuse_epilogue"])
    # "auto" on a CPU group stays analytic; a group of the wrong size or
    # none cannot measure
    assert tauto.tune_seam("rs", 64, 64, 32, 4, hw=_v5e(),
                           group=g).source == "analytic"
    with pytest.raises(ValueError, match="RankGroup of 4"):
        tauto.tune_seam("rs", 64, 64, 32, 4, hw=_v5e(), measure=True)
    # the MoE exchange is measured too: its op forward over the
    # reference's candidates (no flux row: the op has no fused kernel)
    res = tauto.tune_seam("a2a", 256, 64, 32, 4, hw=_v5e(), group=g,
                          measure=True, n_weights=3, epilogue=True,
                          iters=2, warmup=1, dtype_bytes=4)
    want = {(c.mode, c.comm_chunks, c.reverse)
            for c in rauto.candidate_space("a2a", 256, 64, 32, 4,
                                           allow_q8=False, n_weights=3,
                                           epilogue=True)}
    assert {(r["mode"], r["comm_chunks"], r["reverse"])
            for r in res.table} == want
    assert all(r["measured_s"] > 0 for r in res.table)
    assert (res.plan.mode, res.plan.comm_chunks, res.plan.reverse) in want
    assert res.plan.measured_s == min(r["measured_s"] for r in res.table)


@pytest.mark.parametrize("m,n,k", [(256, 64, 32), (1000, 48, 40),
                                   (8, 16, 16)])
def test_a2a_bench_inputs_match_reference_shapes(m, n, k):
    """The a2a bench's operands a rank are the reference's
    ``_bench_callable`` global ones cut over 4 ranks (its one-device run
    keeps the global shapes): x [4, 2, cap, k] with cap = m / 8, the
    experts' (w1, w3) [2, k, n] and w2 [2, n, k]."""
    import jax.numpy as jnp
    g = dist.RankGroup(4, "cpu", timeout_s=60)
    mr, nr, kr = (max(4, v - v % 4) for v in (m, n, k))
    cand = rauto.Candidate("xla", 0, False)
    _, want = rauto._bench_callable("a2a", m, n, k, 4, cand, jnp.float32)
    got = tauto.bench_inputs("a2a", mr, nr, kr, g, dtype=torch.float32)
    assert len(got) == 4
    for rank in got:
        assert [tuple(t.shape) for t in rank] == [
            (w.shape[0] // 4,) + tuple(w.shape[1:]) for w in want]
    op = tauto.bench_op("a2a", tauto.Candidate("xla", 0, False), g)
    assert (op.kind, op.n_weights, op.epilogue.gate) == ("a2a", 3, "pair")


def test_measured_tuning_of_an_mla_model_plans_moe_a2a():
    """A measured sweep of the MoE model (MLA, MoE, on a CPU group) tunes
    every seam cell, ``moe_a2a`` included; analytic tuning of it is pure
    arithmetic."""
    g = dist.RankGroup(4, "cpu", timeout_s=60)
    cfg = tbase.get_smoke_config("deepseek_v3_671b")
    results = []
    plans = tauto.autotune_model(cfg, tbase.ParallelConfig(tp=4), hw=_v5e(),
                                 group=g, measure=True, tokens_per_dp=256,
                                 iters=1, warmup=1, results=results)
    a2a = next(r for r in results if r.seam == "moe_a2a")
    assert a2a.source == "measured" and len(a2a.table) == 7
    assert plans.seams["moe_a2a"].mode in ("xla", "decomposed")
    assert plans.seams["moe_a2a"].measured_s == min(
        r["measured_s"] for r in a2a.table)
    # analytic tuning of it is pure arithmetic
    plans = tauto.autotune_model(cfg, tbase.ParallelConfig(tp=4), hw=_v5e(),
                                 tokens_per_dp=256)
    assert {"attn_ag@q_up", "attn_ag@kv_up", "moe_a2a"} <= set(plans.seams)

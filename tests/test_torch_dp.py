"""Data parallelism on a rank mesh against the reference.

The reference runs once for the file, in one subprocess with 8 forced
host devices: its ``runtime.trainer.Trainer`` for 3 steps (batch 4 x 64,
warmup 1, lr 1e-3, the arch's schedule, fp32 weights drawn by its
``init_model``, fp32 moments placed by ``adamw.opt_state_specs``) on
  codeqwen15_7b smoke with ``d_ff=512`` (the oracle config of
  ``tests/test_train_multidevice.py``) at (dp 1, tp 1), (dp 2, tp 2) in
  decomposed, (dp 2, tp 1) in xla, and (pods 2, dp 2, tp 2) with
  ``grad_compress`` (the int8 pod all-reduce);
  minicpm_2b smoke at (dp 2, tp 2) in xla in the replicated ("hidden")
  layout;
  the deepseek_v3_671b smoke config (MLA, MoE with 4 experts, MTP) at
  (dp 2, tp 2) in decomposed: its aux loss sums over data;
then the elastic restart of ``tests/test_elastic_restart.py``: codeqwen
at (2, 2) for 4 steps with a checkpoint every 2, the step-2 checkpoint
restored on ``elastic_remesh(2, tp=2)`` = (1, 2) and steps 2-3 run
again; and ``adamw._quantize_int8`` on a few arrays.

The port runs the same runs on the CPU from the same weights (``convert``)
as the threads of a ``dist.RankMesh``, and (dp 2, tp 2) in flux against
the reference's decomposed run (the reference's interpreted flux kernels
do not run on its trainer's 2-D mesh here).  Its elastic case restores
the reference's step-2 checkpoint at (1, 2) through ``elastic_remesh``
and runs steps 2-3.

Tolerances (fp32), those of ``tests/test_torch_trainer.py``: each step's
loss within 1e-5 relative, every final leaf within relative L2 1e-5, each
leaf's change over the run within 1e-3.  Without the reference: the int8
codec's bytes equal the reference's, the ZeRO-1 moments' bytes over the
data ranks sum to dp=1's, the mesh's sub-groups exchange with the right
peers and one rank's failure ends every sub-group's barrier at once, the
MoE drop counter loses no update across replicas' threads, and a port
checkpoint written at (2, 2) restores at (1, 2) bit for bit.  The
``gpu`` cases run two TP groups of one mesh through the fused kernels at
once on the card.
"""
import dataclasses
import math
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.checkpoint.checkpointer import host_leaves
from repro_torch.configs.base import (ParallelConfig, get_smoke_config,
                                      train_schedule)
from repro_torch.dist import RankGroupError, RankMesh, current_group
from repro_torch.launch.mesh import dp_axes, elastic_remesh, make_mesh
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TA
from repro_torch.parallel.sharding import DP_NEEDS_MESH, make_ctx
from repro_torch.runtime import trainer as TT

STEPS, BATCH, SEQ, LR = 3, 4, 64, 1e-3
# the reference's runs: (arch, pods, dp, tp, mode, scatter_axis, compress)
RUNS = [("codeqwen15_7b", 1, 1, 1, "decomposed", "auto", False),
        ("codeqwen15_7b", 1, 2, 2, "decomposed", "auto", False),
        ("codeqwen15_7b", 1, 2, 1, "xla", "auto", False),
        ("minicpm_2b", 1, 2, 2, "xla", "hidden", False),
        ("deepseek_v3_671b", 1, 2, 2, "decomposed", "auto", False),
        ("codeqwen15_7b", 2, 2, 2, "decomposed", "auto", True)]
# the port's runs: (reference run, the port's mode)
PORT_RUNS = [(0, "decomposed"), (1, "decomposed"), (1, "flux"), (2, "xla"),
             (3, "xla"), (4, "decomposed"), (5, "decomposed")]
ELASTIC_STEPS, ELASTIC_EVERY = 4, 2
LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-5
UPDATE_RTOL = 1e-3
# _quantize_int8's inputs: a ragged leaf, a zero block, exact halves
QUANT_SEED = 5

_REF = r"""
import dataclasses, shutil
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs.base import get_smoke_config, ParallelConfig
from repro.launch.mesh import elastic_remesh
from repro.models import model as M
from repro.optim import adamw
from repro.runtime import trainer as T

out = {}


def save(tree, prefix):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in flat:
        key = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                       for q in path)
        out[prefix + key] = np.asarray(leaf, np.float32)


def config(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    if arch == "codeqwen15_7b":
        cfg = dataclasses.replace(cfg, d_ff=512)
    return cfg


def mesh_of(pods, dp, tp):
    shape, axes = ((pods, dp, tp), ("pod", "data", "model")) if pods > 1 \
        else ((dp, tp), ("data", "model"))
    return Mesh(np.array(jax.devices()[:pods * dp * tp]).reshape(shape), axes)


def state(cfg, par, mesh):
    params = M.init_model(jax.random.PRNGKey(0), cfg, par, dtype=jnp.float32)
    if cfg.qkv_bias:   # the reference inits the bias to zero
        mix = params["periods"][0]["mixer"]
        rng = np.random.default_rng(1)
        mix["bqkv"] = jnp.asarray(
            0.1 * rng.standard_normal(mix["bqkv"].shape), jnp.float32)
    init = params
    specs = M.param_specs(cfg, par, params)
    ospecs = adamw.opt_state_specs(specs, params, par.dp, par.tp)
    put = lambda tree, sp: jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), tree, sp,
        is_leaf=lambda x: isinstance(x, P))
    opt = adamw.init_opt_state(params)
    opt = {"mu": put(opt["mu"], ospecs["mu"]),
           "nu": put(opt["nu"], ospecs["nu"]), "count": opt["count"]}
    return init, put(params, specs), opt


def trainer(cfg, par, mesh, steps, schedule, ckpt=None):
    tc = T.TrainConfig(total_steps=steps, warmup_steps=1, base_lr=%(lr)r,
                       schedule=schedule, checkpoint_dir=ckpt,
                       checkpoint_every=%(every)d, log_every=100)
    tr = T.Trainer(cfg, par, mesh, tc)
    tr.data_cfg = dataclasses.replace(tr.data_cfg, seq_len=%(seq)d,
                                      global_batch=%(batch)d)
    return tr


for i, (arch, pods, dp, tp, mode, axis, compress, schedule) in enumerate(
        %(runs)r):
    cfg = config(arch)
    par = ParallelConfig(tp=tp, dp=dp, pods=pods, overlap_mode=mode,
                         scatter_axis=axis, grad_compress=compress)
    mesh = mesh_of(pods, dp, tp)
    init, params, opt = state(cfg, par, mesh)
    save(init, f"{i}/init/")
    tr = trainer(cfg, par, mesh, %(steps)d, schedule)
    with mesh:
        params, opt, hist = tr.train(params, opt, resume=False)
    save(params, f"{i}/final/")
    out[f"{i}/losses"] = np.array([h["loss"] for h in hist], np.float32)

# elastic restart: (2, 2) for 4 steps, checkpoints at 2 and 4; the step-2
# checkpoint kept for the port; (1, 2) resumes from it
cfg = config("codeqwen15_7b")
par = ParallelConfig(tp=2, dp=2, overlap_mode="decomposed")
mesh = mesh_of(1, 2, 2)
init, params, opt = state(cfg, par, mesh)
save(init, "el/init/")
tr = trainer(cfg, par, mesh, %(el_steps)d, "cosine", RUN_DIR)
with mesh:
    _, _, hist = tr.train(params, opt, resume=False)
out["el/losses"] = np.array([h["loss"] for h in hist], np.float32)
shutil.rmtree(RUN_DIR + "/step_4")
shutil.copytree(RUN_DIR, PORT_DIR)
mesh2 = elastic_remesh(surviving_devices=2, tp=2)
assert mesh2.devices.shape == (1, 2)
par2 = ParallelConfig(tp=2, dp=1, overlap_mode="decomposed")
_, params, opt = state(cfg, par2, mesh2)
tr2 = trainer(cfg, par2, mesh2, %(el_steps)d, "cosine", RUN_DIR)
with mesh2:
    params, opt, hist2 = tr2.train(params, opt, resume=True)
assert tr2.step == %(el_steps)d and len(hist2) == 2
out["el/resumed_losses"] = np.array([h["loss"] for h in hist2], np.float32)
save(params, "el/final/")

# the int8 pod wire's codec
rng = np.random.default_rng(%(qseed)d)
halves = np.arange(-127.0, 128.0, dtype=np.float32)
halves[1:-1] -= 0.5                      # x.5 exactly, the block max 127
cases = [rng.standard_normal(1000).astype(np.float32),
         np.concatenate([np.zeros(256, np.float32),
                         rng.standard_normal(256).astype(np.float32)]),
         halves]
for j, x in enumerate(cases):
    q, s = adamw._quantize_int8(jnp.asarray(x))
    out[f"quant/{j}/x"] = x
    out[f"quant/{j}/q"] = np.asarray(q)
    out[f"quant/{j}/scale"] = np.asarray(s)
np.savez(OUT, **out)
print("REF_OK")
"""


def _cfg(arch):
    cfg = dataclasses.replace(get_smoke_config(arch),
                              compute_dtype="float32")
    if arch == "codeqwen15_7b":
        cfg = dataclasses.replace(cfg, d_ff=512)
    return cfg


@pytest.fixture(scope="module")
def ref(tmp_path_factory, subproc):
    d = tmp_path_factory.mktemp("dp")
    runs = [r + (train_schedule(r[0]),) for r in RUNS]
    code = (_REF % {"runs": runs, "steps": STEPS, "lr": LR, "seq": SEQ,
                    "batch": BATCH, "every": ELASTIC_EVERY,
                    "el_steps": ELASTIC_STEPS, "qseed": QUANT_SEED}
            ).replace("OUT,", repr(str(d / "out.npz")) + ",").replace(
        "RUN_DIR", repr(str(d / "run"))).replace(
        "PORT_DIR", repr(str(d / "port")))
    assert "REF_OK" in subproc(code, n_devices=8, timeout=900)
    return {"out": dict(np.load(d / "out.npz")), "port_dir": str(d / "port")}


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


def _trainer(arch, pods, dp, tp, mode, axis="auto", compress=False,
             steps=STEPS, ckpt=None, mesh=None):
    par = ParallelConfig(tp=tp, dp=dp, pods=pods, overlap_mode=mode,
                         scatter_axis=axis, grad_compress=compress)
    tc = TT.TrainConfig(total_steps=steps, warmup_steps=1, base_lr=LR,
                        schedule=train_schedule(arch), checkpoint_dir=ckpt,
                        checkpoint_every=ELASTIC_EVERY, log_every=100)
    tr = TT.Trainer(_cfg(arch), par, tc, device="cpu", dtype=torch.float32,
                    mesh=mesh)
    tr.data_cfg = dataclasses.replace(tr.data_cfg, seq_len=SEQ,
                                      global_batch=BATCH)
    return tr


def _port_state(tr, init):
    """Every mesh rank's copy of the reference's weights, zero moments."""
    tp_ranks = convert.rank_params_from_jax(init, tr.cfg, tr.par.tp,
                                            dtype=torch.float32,
                                            device="cpu", trainable=True)
    params = tr.place(tp_ranks)
    return params, [tr.init_opt(p, r) for r, p in enumerate(params)]


def _final_tree(tr, params):
    """The first data replica's weights as the reference's tree."""
    first = tr.first_replica(params)
    final = TM.gather_rank_leaves(
        [dict(p.named_parameters()) for p in first], tr.cfg, first[0])
    return _flat(convert.to_jax_tree(final, tr.cfg))


def _check_run(got_losses, want_losses, got, want, start):
    np.testing.assert_allclose(got_losses, want_losses, rtol=LOSS_RTOL,
                               atol=0)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert _rel(got[key], w) <= PARAM_RTOL, key
        assert _rel(got[key] - start[key], w - start[key]) <= UPDATE_RTOL, \
            key


@pytest.mark.parametrize(
    "i,mode", PORT_RUNS,
    ids=[f"{RUNS[i][0]}-pods{RUNS[i][1]}-dp{RUNS[i][2]}-tp{RUNS[i][3]}-{m}"
         + ("-hidden" if RUNS[i][5] == "hidden" else "")
         + ("-int8" if RUNS[i][6] else "") for i, m in PORT_RUNS])
def test_three_steps_match_reference_trainer(ref, i, mode):
    """Three steps of the port's Trainer on a mesh against the reference's
    (the replicas' weights stay equal, bit for bit)."""
    out = ref["out"]
    arch, pods, dp, tp, _, axis, compress = RUNS[i]
    tr = _trainer(arch, pods, dp, tp, mode, axis, compress)
    assert (tr.group is not None) == (pods * dp * tp > 1)
    init = _tree(out, f"{i}/init/")
    params, opt = _port_state(tr, init)
    params, _, hist = tr.train(params, opt)
    got = np.array([h["loss"] for h in hist])
    assert all(map(math.isfinite, got))
    _check_run(got, out[f"{i}/losses"], _final_tree(tr, params),
               _flat(_tree(out, f"{i}/final/")), _flat(init))
    for r, p in enumerate(params):
        twin = params[tr.first_replica(list(range(len(params))))[
            tr.tp_index(r)]]
        for (n, a), (_, b) in zip(p.named_parameters(),
                                  twin.named_parameters()):
            assert torch.equal(a, b), (r, n)


def test_elastic_restore_of_the_references_checkpoint(ref):
    """The reference's (2, 2) checkpoint at step 2, restored by the port
    on ``elastic_remesh(2, tp=2)`` = (1, 2): weights and moments
    bit-equal to the checkpoint; steps 2-3 against the reference's own
    elastic run."""
    out = ref["out"]
    mesh = elastic_remesh(2, 2, "cpu")
    assert mesh.shape == (1, 2) and mesh.axes == ("data", "model")
    with pytest.raises(RuntimeError, match="2-way TP group"):
        elastic_remesh(1, 2, "cpu")
    tr = _trainer("codeqwen15_7b", 1, 1, 2, "decomposed",
                  steps=ELASTIC_STEPS, ckpt=ref["port_dir"], mesh=mesh)
    assert tr.group is mesh
    params, _ = tr.init_state()
    opt = tr.restore(params)
    assert tr.step == ELASTIC_EVERY and opt[0]["count"] == ELASTIC_EVERY
    saved = dict(np.load(os.path.join(ref["port_dir"], "step_2",
                                      "shard_0.npz")))
    got = host_leaves(tr.checkpoint_tree(params, opt))
    assert len(got) == len(saved)
    for k, v in got.items():
        np.testing.assert_array_equal(v, saved[k.replace("/", "__")],
                                      err_msg=k)
    start = _final_tree(tr, params)
    _, _, hist = tr.train(params, opt, resume=False)
    assert tr.step == ELASTIC_STEPS
    _check_run(np.array([h["loss"] for h in hist]), out["el/resumed_losses"],
               _final_tree(tr, params), _flat(_tree(out, "el/final/")),
               start)


def test_port_checkpoint_at_2x2_restores_at_1x2(ref, tmp_path):
    """The port's own elastic restart: 2 steps at (2, 2) from the
    reference's weights (losses on the reference's 4-step run), a
    checkpoint at step 2 whose moments are the data ranks' ZeRO-1 shards
    joined; a (1, 2) trainer restores it bit for bit."""
    out = ref["out"]
    tr = _trainer("codeqwen15_7b", 1, 2, 2, "decomposed",
                  steps=ELASTIC_STEPS, ckpt=str(tmp_path))
    params, opt = _port_state(tr, _tree(out, "el/init/"))
    hist = []
    for _ in range(ELASTIC_EVERY):
        opt, m = tr.run_step(params, opt, tr.step_batch(tr.step))
        hist.append(float(m["loss"]))
        tr.step += 1
    np.testing.assert_allclose(hist, out["el/losses"][:ELASTIC_EVERY],
                               rtol=LOSS_RTOL, atol=0)
    tr.save(params, opt)
    tr.ckpt.wait()
    want = host_leaves(tr.checkpoint_tree(params, opt))
    one = _trainer("codeqwen15_7b", 1, 1, 2, "decomposed",
                   steps=ELASTIC_STEPS, ckpt=str(tmp_path),
                   mesh=elastic_remesh(2, 2, "cpu"))
    p1, _ = one.init_state()
    o1 = one.restore(p1)
    assert one.step == ELASTIC_EVERY
    got = host_leaves(one.checkpoint_tree(p1, o1))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_quantize_int8_bytes_equal_reference(ref):
    """The pod wire's codec: q bytes and scales equal the reference's (a
    ragged leaf, a zero block, values at exact halves)."""
    out = ref["out"]
    for j in range(3):
        x = torch.from_numpy(out[f"quant/{j}/x"])
        q, s = TA._quantize_int8(x)
        np.testing.assert_array_equal(q.numpy(), out[f"quant/{j}/q"])
        np.testing.assert_array_equal(s.numpy(), out[f"quant/{j}/scale"])


@pytest.mark.parametrize("arch", ["minicpm_2b", "deepseek_v3_671b"])
def test_zero1_moment_bytes_sum_to_dp1(arch):
    """ZeRO-1 on the reference's layout: over the data ranks of a TP index
    the moments' bytes sum to dp=1's (each row shard once, each stacked
    layer on its owner alone), and a rank holds about half of them."""
    tr2 = _trainer(arch, 1, 2, 2, "xla")
    tr1 = _trainer(arch, 1, 1, 2, "xla")
    p2, o2 = tr2.init_state()
    p1, o1 = tr1.init_state()
    plan = TT.zero1_plan(tr2.cfg, p2[0], 2)
    kinds = {"rows": 0, "owner": 0, "whole": 0}
    for n, z in plan.items():
        kinds["rows" if z.rows else "whole" if z.owner is None
              else "owner"] += 1
    # deepseek's smoke config repeats its pattern once: its layer leaves
    # stay whole (the reference's stacked dim 1 does not split over 2)
    assert kinds["rows"] > 0
    assert (kinds["owner"] > 0) == (TM.n_periods(tr2.cfg) % 2 == 0)
    for i in range(2):
        peers = [r for r in range(4) if tr2.tp_index(r) == i]
        whole = sum(t.numel() for t in o1[i]["mu"].values())
        held = [sum(t.numel() for t in o2[r]["mu"].values()) for r in peers]
        shared = sum(o1[i]["mu"][n].numel() for n, z in plan.items()
                     if not z.rows and z.owner is None)
        assert sum(held) == whole + shared
        assert max(held) < 0.6 * whole + shared


def test_mesh_subgroups_exchange_with_their_peers():
    """A (2, 2, 2) mesh: each rank's pod, data and model sub-groups hold
    the ranks that share every other coordinate, in coordinate order;
    ``current_group`` is the model sub-group; a group answers only its own
    ranks."""
    mesh = make_mesh(2, 2, 2, "cpu")
    assert mesh.axes == ("pod", "data", "model") and mesh.size == 8
    assert dp_axes(mesh) == ("pod", "data")
    assert dp_axes(make_mesh(1, 2, 2, "cpu")) == ("data",)

    def body(r):
        assert current_group() is mesh.group("model")
        assert mesh.rank() == r
        got = {a: [int(t) for t in mesh.group(a).exchange(
            torch.tensor(r), a)] for a in mesh.axes}
        return got, {a: mesh.group(a).rank() for a in mesh.axes}

    res = mesh.spmd(body, [(r,) for r in range(8)])
    for r, (got, idx) in enumerate(res):
        pod, data, model = r // 4, (r // 2) % 2, r % 2
        assert mesh.coords(r) == (pod, data, model)
        assert got["model"] == [pod * 4 + data * 2 + m for m in range(2)]
        assert got["data"] == [pod * 4 + d * 2 + model for d in range(2)]
        assert got["pod"] == [p * 4 + data * 2 + model for p in range(2)]
        assert idx == {"pod": pod, "data": data, "model": model}
    other = mesh.group("data", 0)
    with pytest.raises(RankGroupError, match="not a rank"):
        mesh.spmd(lambda r: other.rank(), [(r,) for r in range(8)])
    with pytest.raises(RankGroupError, match="inside its mesh"):
        other.spmd(lambda: None, [()] * 2)
    # the TP groups' workspaces and flag epochs are their own
    tp0, tp1 = mesh.group("model", 0), mesh.group("model", 2)
    assert tp0 is not tp1 and tp0.share == tp1.share == 8
    a = tp0.symmetric("ag_gemm.flags", (2,), torch.int32, zero=True)
    b = tp1.symmetric("ag_gemm.flags", (2,), torch.int32, zero=True)
    assert {t.data_ptr() for t in a}.isdisjoint(t.data_ptr() for t in b)


def test_one_rank_failure_ends_every_subgroup_barrier():
    """Rank 0 fails while its data peer waits on the data barrier and the
    other TP group on its model barrier: every barrier breaks at once (far
    inside ``timeout_s``), the failing rank's error is raised, and the
    mesh runs again."""
    mesh = RankMesh((2, 2), ("data", "model"), "cpu", timeout_s=30)
    started = threading.Event()

    def body(r):
        if r == 0:
            started.wait(5)
            time.sleep(0.2)
            raise ValueError("rank 0 down")
        if r == 1:
            started.set()
        axis = "data" if r == 2 else "model"
        mesh.group(axis).barrier(f"wait {axis}")
        return r

    t0 = time.perf_counter()
    with pytest.raises(RankGroupError, match="rank 0 down"):
        mesh.spmd(body, [(r,) for r in range(4)])
    assert time.perf_counter() - t0 < 5
    assert mesh.spmd(lambda r: mesh.group("data").exchange(
        torch.tensor(r), "again")[0].item(), [(r,) for r in range(4)]) == \
        [0, 1, 0, 1]


def test_drop_counter_loses_no_update_across_replicas():
    """Data replicas of one TP rank add their MoE drops to the same key of
    ``models.ffn.dropped`` from their threads at once: more threads than
    cores, a 1 us switch interval, no update lost."""
    from repro_torch.models import ffn as TF
    ctx = make_ctx(ParallelConfig())
    keep = torch.zeros(10, dtype=torch.bool)          # 10 lost a call
    n_threads, calls = max(16, 2 * (os.cpu_count() or 1)), 200
    TF.dropped.clear()

    def add():
        for _ in range(calls):
            TF._count_drops(ctx, keep, None)

    threads = [threading.Thread(target=add) for _ in range(n_threads)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert TF.drop_totals(1) == [n_threads * calls * 10]
    TF.dropped.clear()


def test_make_ctx_takes_the_mesh_at_dp_gt_1():
    """dp>1 without a mesh raises; with the mesh each rank's context holds
    its model and data sub-groups, and at tp=1 the tape cuts over the data
    group (the MoE aux loss's psum rides the tape)."""
    with pytest.raises(ValueError, match="RankMesh"):
        make_ctx(ParallelConfig(dp=2))
    assert "mesh=" in DP_NEEDS_MESH
    mesh = make_mesh(1, 2, 2, "cpu")
    with pytest.raises(ValueError, match="not the"):
        make_ctx(ParallelConfig(dp=2, tp=1), mesh=mesh, rank=0)
    ctx = make_ctx(ParallelConfig(dp=2, tp=2), mesh=mesh, rank=3)
    assert ctx.group is mesh.group("model", 3)
    assert ctx.dp_groups == (mesh.group("data", 3),)
    assert ctx.tape_axis is ctx.group
    one = make_mesh(1, 2, 1, "cpu")
    ctx1 = make_ctx(ParallelConfig(dp=2), mesh=one, rank=1)
    assert ctx1.axis is None and ctx1.tape_axis is one.group("data", 1)


@pytest.mark.parametrize("pods,dp", [(1, 2), (2, 1)])
def test_train_cli_runs_dp_and_pods(pods, dp, capsys):
    """``launch.train --dp 2 --tp 2`` and ``--pods 2 --grad-compress``
    train the smoke config on the CPU."""
    from repro_torch.launch import train as LT
    tr, hist = LT.main(["--arch", "minicpm_2b", "--smoke", "--steps", "2",
                        "--tp", "2", "--dp", str(dp), "--pods", str(pods),
                        "--batch", "4", "--seq", "32", "--device", "cpu",
                        *(["--grad-compress"] if pods > 1 else [])])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert tr.group.size == 4 and tr.par.grad_compress == (pods > 1)
    assert "dp=%d, pods=%d" % (dp, pods) in capsys.readouterr().out


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the fused kernels run only there)")


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["ag_gemm", "gemm_rs"])
def test_gpu_two_tp_groups_run_the_fused_kernels_at_once(kernel):
    """A (2, 2) mesh on the card: both TP groups launch the fused kernel at
    the same time, each rank's output against the plain version on its
    group's operands; the groups' flag arrays and workspaces are
    distinct."""
    _need_card()
    from repro_torch.kernels import ag_gemm as AG
    from repro_torch.kernels import gemm_rs as RS
    mesh = make_mesh(1, 2, 2, "cuda")
    gen = torch.Generator().manual_seed(3)
    m, k, n = 256, 512, 384
    a = [torch.randn(m, k, generator=gen).to("cuda", torch.bfloat16)
         for _ in range(4)]
    b = [torch.randn(k, n, generator=gen).div_(k ** 0.5).to(
        "cuda", torch.bfloat16) for _ in range(4)]

    def body(r):
        g = mesh.group("model")
        if kernel == "ag_gemm":
            return AG.ag_gemm(a[r], b[r], group=g)
        return RS.gemm_rs(a[r], b[r], group=g)

    before = getattr(AG.ag_gemm if kernel == "ag_gemm" else RS.gemm_rs,
                     "launches")
    outs = mesh.spmd(body, [(r,) for r in range(4)])
    torch.cuda.synchronize()
    fn = AG.ag_gemm if kernel == "ag_gemm" else RS.gemm_rs
    assert fn.launches - before == 4
    for r in range(4):
        peers = [mesh.coord("data", r) * 2 + i for i in range(2)]
        if kernel == "ag_gemm":
            want = AG.ag_gemm_ref([a[q] for q in peers], b[r])
        else:
            want = RS.gemm_rs_ref([a[q] for q in peers],
                                  [b[q] for q in peers],
                                  mesh.coord("model", r))
        err = (outs[r].float() - want.float()).abs().max().item()
        assert err <= 2e-2 * want.float().abs().max().item(), (r, err)
    names = ("ag_gemm.flags", "ag_gemm.a_agg") if kernel == "ag_gemm" \
        else ("gemm_rs.ws",)
    g0, g1 = mesh.group("model", 0), mesh.group("model", 2)
    for name in names:
        p0 = {t.data_ptr() for key, ts in g0._sym.items() if key[0] == name
              for t in ts}
        p1 = {t.data_ptr() for key, ts in g1._sym.items() if key[0] == name
              for t in ts}
        assert p0 and p1 and p0.isdisjoint(p1), name
    mesh.free_symmetric()

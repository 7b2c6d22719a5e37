"""The port's checkpointer and the trainer's fault tolerance.

The port's analogues of the reference's ``tests/test_runtime.py``
checkpoint and trainer tests (a round trip, corruption detected, ``keep``,
any tree round-trips exactly; resume, fault recovery, the straggler
counter), and the format held against the reference's ``Checkpointer``:
one subprocess with 4 forced host devices (``conftest``) reads a
checkpoint the port wrote (minicpm_2b smoke at tp=4, bf16 weights, fp32
moments, after one step) and writes one of its own, and runs the
reference's ``Trainer`` for 4 steps (fp32, tp=4, decomposed, wsd, batch
4 x 64, warmup 1, lr 1e-3) with a checkpoint every 2 steps.

Tolerances: a checkpoint crossing either way is bit-exact (every leaf,
its dtype and the step); a port ``Trainer`` resuming the reference's
step-2 checkpoint matches the reference's steps 2 and 3 within
``tests/test_torch_trainer.py``'s tolerances (each loss within 1e-5
relative, each final leaf within relative L2 1e-5, each leaf's change
over the two steps within 1e-3); on the CPU in fp32, with torch's
deterministic algorithms, a port resume equals the uninterrupted run bit
for bit, and so does a run that recovered from a failure (without them
the embedding's backward adds a token's duplicate rows in an order that
varies from run to run).
"""
import dataclasses
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

from repro_torch import convert
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ParallelConfig, get_smoke_config
from repro_torch.data import pipeline as tdata
from repro_torch.dist import current_group
from repro_torch.models import model as TM
from repro_torch.runtime import trainer as TT

TP = 4
BATCH, SEQ, LR = 4, 64, 1e-3
LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-5
UPDATE_RTOL = 1e-3

_REF = r"""
import dataclasses, json
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.checkpoint.checkpointer import Checkpointer
from repro.configs.base import get_smoke_config, ParallelConfig
from repro.models import model as M
from repro.optim import adamw
from repro.runtime import trainer as T

out, dtypes = {}, {}


def save(tree, prefix):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in flat:
        key = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                       for q in path)
        out[prefix + key] = np.asarray(leaf, np.float32)
        dtypes[prefix + key] = str(np.asarray(leaf).dtype)


cfg = dataclasses.replace(get_smoke_config("minicpm_2b"),
                          compute_dtype="float32")
par = ParallelConfig(tp=4, dp=1, overlap_mode="decomposed")

# the port's checkpoint, read by the reference's Checkpointer
params = M.init_model(jax.random.PRNGKey(0), cfg, par)
like = {"params": params, "opt": adamw.init_opt_state(params)}
state, step, extra = Checkpointer(PORT_DIR).restore(like)
out["port/step"] = np.asarray(step)
save(state, "port/")

# a checkpoint of the reference's, for the port
rng = np.random.default_rng(3)
p2 = M.init_model(jax.random.PRNGKey(3), cfg, par)
tree = {"params": p2,
        "opt": {"mu": jax.tree.map(lambda a: jnp.asarray(
                    rng.standard_normal(a.shape), jnp.float32), p2),
                "nu": jax.tree.map(lambda a: jnp.asarray(
                    rng.random(a.shape), jnp.float32), p2),
                "count": jnp.asarray(5, jnp.int32)}}
Checkpointer(REF_DIR).save(7, tree, extra={"step": 7}, blocking=True)
save(tree, "ref/")

# 4 trainer steps, a checkpoint every 2
mesh = Mesh(np.array(jax.devices()).reshape(1, 4), ("data", "model"))
tc = T.TrainConfig(total_steps=4, warmup_steps=1, base_lr=%(lr)r,
                   schedule="wsd", checkpoint_dir=RUN_DIR,
                   checkpoint_every=2, log_every=100)
tr = T.Trainer(cfg, par, mesh, tc)
tr.data_cfg = dataclasses.replace(tr.data_cfg, seq_len=%(seq)d,
                                  global_batch=%(batch)d)
params = M.init_model(jax.random.PRNGKey(0), cfg, par, dtype=jnp.float32)
specs = M.param_specs(cfg, par, params)
put = lambda t: jax.tree.map(
    lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), t, specs,
    is_leaf=lambda x: isinstance(x, P))
params = put(params)
opt = adamw.init_opt_state(params)
opt = {"mu": put(opt["mu"]), "nu": put(opt["nu"]), "count": opt["count"]}
with mesh:
    params, opt, hist = tr.train(params, opt, resume=False)
save(params, "run/final/")
out["run/losses"] = np.array([h["loss"] for h in hist], np.float32)
np.savez(OUT, **out)
with open(OUT + ".json", "w") as f:
    json.dump(dtypes, f)
print("REF_OK")
"""


def _cfg(dtype=torch.float32):
    return dataclasses.replace(get_smoke_config("minicpm_2b"),
                               compute_dtype=str(dtype).split(".")[1])


def _trainer(tp, ckpt=None, steps=4, dtype=torch.float32, mode="decomposed",
             **tc):
    cfg = _cfg(dtype)
    tr = TT.Trainer(cfg, ParallelConfig(tp=tp, overlap_mode=mode),
                    TT.TrainConfig(total_steps=steps, warmup_steps=1,
                                   base_lr=LR, schedule="wsd",
                                   checkpoint_dir=ckpt, checkpoint_every=2,
                                   log_every=100, **tc),
                    device="cpu", dtype=dtype)
    tr.data_cfg = dataclasses.replace(tr.data_cfg, seq_len=SEQ,
                                      global_batch=BATCH)
    return tr


def _flat(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _as_np(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().float().cpu().numpy()
    return np.asarray(leaf, np.float32)


def _dtype(leaf):
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


@pytest.fixture(scope="module")
def ref(tmp_path_factory, subproc):
    """The port's checkpoint (written here), the reference's reading of
    it, the reference's own checkpoint and its 4-step run."""
    d = tmp_path_factory.mktemp("ckpt")
    port_dir, ref_dir, run_dir = (str(d / n) for n in ("port", "ref", "run"))
    tr = _trainer(TP, port_dir, steps=1, dtype=torch.bfloat16)
    tr.tc.checkpoint_every = 1
    params, opt, _ = tr.train()
    written = _flat(tr.checkpoint_tree(params, opt))
    code = (_REF % {"lr": LR, "seq": SEQ, "batch": BATCH}).replace(
        "PORT_DIR", repr(port_dir)).replace("REF_DIR", repr(ref_dir)).replace(
        "RUN_DIR", repr(run_dir)).replace("OUT", repr(str(d / "out.npz")))
    assert "REF_OK" in subproc(code, n_devices=TP)
    with open(d / "out.npz.json") as f:
        dtypes = json.load(f)
    return {"written": written, "out": dict(np.load(d / "out.npz")),
            "dtypes": dtypes, "ref_dir": ref_dir, "run_dir": run_dir}


def test_reference_reads_the_ports_checkpoint(ref):
    out, dtypes = ref["out"], ref["dtypes"]
    assert int(out["port/step"]) == 1
    written = ref["written"]
    assert sorted(written) == sorted(k[5:] for k in dtypes
                                     if k.startswith("port/"))
    for key, leaf in written.items():
        assert dtypes["port/" + key] == _dtype(leaf), key
        np.testing.assert_array_equal(out["port/" + key], _as_np(leaf),
                                      err_msg=key)
    assert dtypes["port/params/embed"] == "bfloat16"
    assert dtypes["port/opt/count"] == "int32"


def test_port_reads_the_references_checkpoint(ref):
    out, dtypes = ref["out"], ref["dtypes"]
    tr = _trainer(TP, ref["ref_dir"], dtype=torch.bfloat16)
    params, _ = tr.init_state()
    opt = tr.restore(params)
    assert tr.step == 7 and opt[0]["count"] == 5
    got = _flat(tr.checkpoint_tree(params, opt))
    assert sorted(got) == sorted(k[4:] for k in dtypes if k.startswith("ref/"))
    for key, leaf in got.items():
        assert dtypes["ref/" + key] == _dtype(leaf), key
        np.testing.assert_array_equal(_as_np(leaf), out["ref/" + key],
                                      err_msg=key)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _global(tr, params):
    """The global weights as numpy copies (a CPU leaf's ``numpy()`` would
    share the weight the next step updates in place)."""
    return {k: v.copy() for k, v in _flat(convert.to_jax_tree(
        TM.gather_rank_leaves([dict(p.named_parameters()) for p in params],
                              tr.cfg, params[0]), tr.cfg)).items()}


def test_port_resumes_the_references_run(ref, tmp_path):
    """The reference's step-2 checkpoint, resumed by the port's Trainer:
    steps 2 and 3 match the reference's."""
    out = ref["out"]
    shutil.copytree(os.path.join(ref["run_dir"], "step_2"),
                    tmp_path / "step_2")
    tr = _trainer(TP, str(tmp_path))
    params, _ = tr.init_state()
    opt = tr.restore(params)
    assert tr.step == 2
    start = _global(tr, params)
    params, _, hist = tr.train(params, opt, resume=False)
    np.testing.assert_allclose([h["loss"] for h in hist],
                               out["run/losses"][2:], rtol=LOSS_RTOL, atol=0)
    got = _global(tr, params)
    for key in start:
        want = out["run/final/" + key]
        assert _rel(got[key], want) <= PARAM_RTOL, key
        assert _rel(got[key] - start[key], want - start[key]) <= \
            UPDATE_RTOL, key


# ---------------------------------------------------------------------------
# the checkpointer alone (tests/test_runtime.py's analogues)
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip_and_keep(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.ones((3, 4), dtype=torch.bfloat16),
                  "d": [np.arange(3, dtype=np.int32), np.asarray(7, np.int32)]}}
    ck.save(10, tree, extra={"foo": 1}, blocking=True)
    got, step, extra = ck.restore(tree)
    assert step == 10 and extra == {"foo": 1}
    assert torch.equal(got["a"], tree["a"])
    assert got["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(got["b"]["c"], tree["b"]["c"])
    np.testing.assert_array_equal(got["b"]["d"][0], np.arange(3))
    assert int(got["b"]["d"][1]) == 7
    with open(tmp_path / "step_10" / "manifest.json") as f:
        leaf = json.load(f)["leaves"]["b/c"]
    assert leaf["viewed"] and leaf["dtype"] == "uint16"
    # async saves, then gc to the newest two
    for s in (20, 30, 40):
        ck.save(s, tree)
    ck.wait()
    assert ck.all_steps() == [30, 40] and ck.latest_step() == 40


def test_checkpoint_corruption_and_shape_detected(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = {"w": torch.ones((4,), dtype=torch.float32)}
    ck.save(1, tree, blocking=True)
    with pytest.raises(ValueError, match="shape"):
        ck.restore({"w": torch.ones((5,))})
    np.savez(os.path.join(str(tmp_path), "step_1", "shard_0.npz"),
             w=np.zeros((4,), np.float32))
    with pytest.raises(IOError, match="corruption"):
        ck.restore(tree)


def test_save_snapshots_before_the_writer(tmp_path):
    """A leaf updated in place right after ``save`` returns (the trainer's
    next step) does not reach the pending write."""
    ck = Checkpointer(str(tmp_path))
    w = torch.ones((256, 256))
    ck.save(1, {"w": w})
    w.add_(1.0)
    got, _, _ = ck.restore({"w": w})
    assert torch.equal(got["w"], torch.ones((256, 256)))


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 1000), depth=st.integers(1, 3),
       use_bf16=st.booleans())
def test_checkpoint_roundtrip_property(tmp_path_factory, seed, depth,
                                       use_bf16):
    gen = torch.Generator().manual_seed(seed)
    dt = torch.bfloat16 if use_bf16 else torch.float32

    def make(d):
        if d == 0:
            shape = tuple(int(v) for v in torch.randint(1, 5, (2,),
                                                        generator=gen))
            return torch.randn(shape, generator=gen).to(dt)
        return {f"k{i}": make(d - 1) for i in range(2)}

    tree = make(depth)
    ck = Checkpointer(str(tmp_path_factory.mktemp("ck")))
    ck.save(1, tree, blocking=True)
    got, _, _ = ck.restore(tree)
    flat_got, flat_want = _flat(got), _flat(tree)
    assert sorted(flat_got) == sorted(flat_want)
    for k, v in flat_want.items():
        assert flat_got[k].dtype == dt and torch.equal(flat_got[k], v)


# ---------------------------------------------------------------------------
# the trainer: resume, recovery, straggler counter
# ---------------------------------------------------------------------------
@pytest.fixture
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _losses(hist):
    return [h["loss"] for h in hist]


def _weights(params):
    return [{n: t.detach().clone() for n, t in p.named_parameters()}
            for p in params]


def _assert_equal_weights(a, b):
    for ra, rb in zip(a, b):
        for n in ra:
            assert torch.equal(ra[n], rb[n]), n


@pytest.mark.parametrize("tp", [1, TP])
def test_resume_equals_uninterrupted(tmp_path, tp, deterministic):
    """fp32 on the CPU: resuming at step 2 gives the uninterrupted run's
    steps 2 and 3 bit for bit."""
    a = _trainer(tp, str(tmp_path / "a"))
    pa, _, ha = a.train(resume=False)
    assert a.ckpt.all_steps() == [2, 4]
    shutil.rmtree(tmp_path / "a" / "step_4")
    b = _trainer(tp, str(tmp_path / "a"))
    pb, _, hb = b.train()
    assert _losses(hb) == _losses(ha)[2:]
    _assert_equal_weights(_weights(pb), _weights(pa))
    # the CLI's flags: --ckpt-dir resumes, --scatter-axis picks the layout
    from repro_torch.launch import train as LT
    args = LT.parse_args(["--arch", "minicpm_2b", "--ckpt-dir", "d",
                          "--scatter-axis", "hidden"])
    assert args.ckpt_dir == "d" and args.scatter_axis == "hidden"


@pytest.mark.parametrize("tp", [1, TP])
def test_fault_hook_failure_recovers_from_the_checkpoint(tmp_path, tp,
                                                         deterministic):
    ref_tr = _trainer(tp)
    p_ref, _, h_ref = ref_tr.train()
    tr = _trainer(tp, str(tmp_path))
    armed = [True]

    def fault_hook(step):
        if step == 3 and armed[0]:
            armed[0] = False
            raise RuntimeError("simulated device failure")

    params, _, hist = tr.train(resume=False, fault_hook=fault_hook)
    assert tr.failures == 1 and tr.step == 4
    # steps 0-2, then 2 again from the step-2 checkpoint, then 3
    assert _losses(hist) == _losses(h_ref)[:3] + _losses(h_ref)[2:]
    _assert_equal_weights(_weights(params), _weights(p_ref))


def test_recovery_waits_for_a_pending_save(tmp_path, monkeypatch,
                                          deterministic):
    """A failure right after a save whose writer is still running recovers
    from that save, not from a fresh init."""
    from repro_torch.checkpoint import checkpointer as ck
    real = ck.np.savez

    def slow_savez(*args, **kw):
        time.sleep(0.5)
        return real(*args, **kw)

    monkeypatch.setattr(ck.np, "savez", slow_savez)
    ref_tr = _trainer(1)
    _, _, h_ref = ref_tr.train()
    tr = _trainer(1, str(tmp_path))
    armed = [True]

    def fault_hook(step):
        if step == 2 and armed[0]:
            armed[0] = False
            raise RuntimeError("fails while step 2's checkpoint is written")

    _, _, hist = tr.train(resume=False, fault_hook=fault_hook)
    assert tr.failures == 1 and _losses(hist) == _losses(h_ref)


def test_rank_failure_inside_the_step_recovers(tmp_path, monkeypatch,
                                               deterministic):
    """A rank that raises inside the step (the others are aborted at their
    next exchange): the trainer builds a new rank group and reloads."""
    ref_tr = _trainer(TP)
    p_ref, _, h_ref = ref_tr.train()
    tr = _trainer(TP, str(tmp_path))
    old_group = tr.group
    real = TT.loss_and_grads
    armed = [True]

    def failing(*args, **kw):
        if armed[0] and tr.step == 3 and current_group().rank() == 2:
            armed[0] = False
            raise RuntimeError("rank 2 lost")
        return real(*args, **kw)

    monkeypatch.setattr(TT, "loss_and_grads", failing)
    params, _, hist = tr.train(resume=False)
    assert tr.failures == 1 and tr.step == 4
    assert tr.group is not old_group
    assert _losses(hist) == _losses(h_ref)[:3] + _losses(h_ref)[2:]
    _assert_equal_weights(_weights(params), _weights(p_ref))


def test_failure_without_checkpoint_reinits_and_retries_run_out():
    """No checkpoint: a failure restarts from a fresh init at step 0; past
    ``max_retries`` failures the error propagates."""
    tr = _trainer(1, steps=2)
    seen = []

    def once(step):
        seen.append(step)
        if len(seen) == 2:
            raise RuntimeError("boom")

    _, _, hist = tr.train(fault_hook=once)
    assert tr.failures == 1 and seen == [0, 1, 0, 1] and len(hist) == 3

    def always(step):
        raise RuntimeError("boom")

    tr = _trainer(1, steps=2, max_retries=2)
    with pytest.raises(RuntimeError, match="boom"):
        tr.train(fault_hook=always)
    assert tr.failures == 3


def test_straggler_counter(tmp_path):
    """A step far slower than the step-time EWMA is counted once."""
    tr = _trainer(1, steps=6, straggler_factor=20.0)

    def slow(step):
        if step == 4:
            time.sleep(max(1.0, 40 * tr._ewma))

    _, _, hist = tr.train(fault_hook=slow)
    assert tr.straggler_events == 1 and len(hist) == 6
    assert hist[4]["seconds"] > 20 * min(h["seconds"] for h in hist[:4])


def test_train_cli_resumes_from_ckpt_dir(tmp_path, capsys):
    """``--ckpt-dir`` resumes from the directory's latest checkpoint and
    prints the straggler events and failures, as the reference's CLI."""
    from repro_torch.launch import train as LT
    argv = ["--arch", "minicpm_2b", "--smoke", "--steps", "3", "--tp", "4",
            "--mode", "xla", "--scatter-axis", "hidden", "--batch", "2",
            "--seq", "32", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    cfg = get_smoke_config("minicpm_2b")
    first = TT.Trainer(
        cfg, ParallelConfig(tp=4, overlap_mode="xla", fuse_w13=True,
                            scatter_axis="hidden"),
        TT.TrainConfig(total_steps=2, checkpoint_dir=str(tmp_path),
                       checkpoint_every=2, log_every=100),
        device="cpu", dtype=getattr(torch, cfg.compute_dtype))
    first.data_cfg = tdata.DataConfig(cfg.vocab_size, 32, 2)
    first.train()
    tr, hist = LT.main(argv)
    assert tr.step == 3 and len(hist) == 1
    assert np.isfinite(hist[0]["loss"])
    printed = capsys.readouterr().out
    assert "straggler events" in printed and "failures 0" in printed


# ---------------------------------------------------------------------------
# on the card (no JAX there)
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_gpu_checkpoint_resume_and_recovery(tmp_path):
    """The smoke config at tp=4 in flux on the card (bf16 weights, fp32
    moments): a checkpoint of card tensors restores bit for bit, a resume
    at step 2 continues the uninterrupted run's losses within 1e-2
    relative (the card's embedding backward adds with atomics), and a
    failed step recovers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the fused kernels)")
    from repro_torch.checkpoint.checkpointer import host_leaves
    cfg = get_smoke_config("minicpm_2b")

    def trainer(sub):
        tr = TT.Trainer(cfg, ParallelConfig(tp=TP, overlap_mode="flux"),
                        TT.TrainConfig(total_steps=4, warmup_steps=0,
                                       checkpoint_dir=str(tmp_path / sub),
                                       checkpoint_every=2, log_every=100),
                        device="cuda")
        tr.data_cfg = tdata.DataConfig(cfg.vocab_size, 128, 4)
        return tr

    a = trainer("a")
    _, _, ha = a.train()
    shutil.rmtree(tmp_path / "a" / "step_4")
    b = trainer("a")
    params, _ = b.init_state()
    opt = b.restore(params)
    with np.load(tmp_path / "a" / "step_2" / "shard_0.npz") as saved:
        for k, v in host_leaves(b.checkpoint_tree(params, opt)).items():
            np.testing.assert_array_equal(v, saved[k.replace("/", "__")])
    _, _, hb = b.train(params, opt, resume=False)
    np.testing.assert_allclose(_losses(hb), _losses(ha)[2:], rtol=1e-2)
    c = trainer("c")
    armed = [True]

    def fault_hook(step):
        if step == 3 and armed[0]:
            armed[0] = False
            raise RuntimeError("simulated failure")

    _, _, hc = c.train(fault_hook=fault_hook)
    assert c.failures == 1 and len(hc) == 5
    np.testing.assert_allclose(_losses(hc)[3:], _losses(ha)[2:], rtol=1e-2)

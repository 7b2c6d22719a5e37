"""The backward of the port's tp>1 seams at 4 ranks against the reference.

The reference runs once for the whole file, in one subprocess with 4
forced host devices (``conftest.run_subprocess_devices``): ``jax.grad``
under ``shard_map`` (``check_vma=False``) of each op against a fixed
cotangent probe, every rank's grads stacked on a leading axis.  The port
runs the same numpy inputs as the 4 ranks of a ``dist.RankGroup`` on the
CPU, where the fused kernels' wrappers run their plain versions, each
rank recording its seams on a ``SeamTape`` and driving the backward from
its own thread, as the trainer does.

* ``FusedOp`` at tp=4 in modes xla, decomposed and flux: ag with one
  weight, bias and silu; ag with the SwiGLU pair gate over two weights;
  rs with a residual.  The reference's flux runs its Pallas kernels in
  interpret mode, forward and backward.  Values and every input's grad
  on every rank within relative L2 1e-5 (fp32, sums in another order).
* ``vocab_parallel_xent`` at tp=4 with a padded vocab (640 columns, 600
  real; some labels out of range): per-token loss within 1e-5 relative,
  the logits' grads within relative L2 1e-5 on every rank.
* ``gather_seq``, ``scatter_seq_sum`` and the token shifts at tp=4: grads
  within 1e-5 of the reference's transposes.
* The schedules (``cosine``, ``wsd``) against the reference's within 2
  float32 ulps: the port rounds ``cos`` and ``pow`` once from float64,
  XLA's float32 ``cos`` is an ulp off on some inputs, and ``1 + cos``
  near the end of the decay doubles that ulp; ``batch_at`` bit-equal.
* The paths that raise, each naming its ROADMAP item; a seam under grad
  with no tape recording raises (a seam is never an autograd node, which
  the engine's device thread would run on a card).
* The tape's segments at tp=4 on the minicpm_2b smoke model: each is
  walked once, so no tape leaf is reached by more autograd calls as the
  model gets deeper.

The ``gpu``-marked tests run on the card (no JAX there): the op-level
backward in flux mode (the fused kernels, bf16) against xla mode; and the
trainer's 4 ranks taking 3 steps in flux mode with no barrier timeout.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import dist
from repro_torch.configs.base import ParallelConfig, get_smoke_config
from repro_torch.core import overlap as tov
from repro_torch.data import pipeline as tdata
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.optim import schedule as tsched
from repro_torch.parallel.sharding import TPContext, make_ctx
from repro_torch.runtime import trainer as TT

N = 4
MODES = ["xla", "decomposed", "flux"]
B, S, D, F = 2, 16, 32, 32
V_PAD, V_REAL = 640, 600
RTOL = 1e-5

_REF = r"""
import functools, sys
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.core import overlap as ov
from repro.models import layers as L
from repro.parallel.sharding import TPContext

inp = dict(np.load(sys.argv[1]))
out = {}
mesh = Mesh(np.array(jax.devices()), ("tp",))
R = P("tp")                     # every rank's value on a leading axis


def smap(fn, in_specs, out_specs):
    return jax.jit(functools.partial(shard_map, mesh=mesh, in_specs=in_specs,
                                     out_specs=out_specs,
                                     check_vma=False)(fn))


def record(tag, fn, args, specs, probe_spec):
    # value and the grads of sum(op(args) * probe) on every rank
    def body(*a):
        *xs, g = a
        val = fn(*xs)
        grads = jax.grad(lambda *q: jnp.sum(fn(*q) * g),
                         argnums=tuple(range(len(xs))))(*xs)
        return val, tuple(t[None] for t in grads)
    f = smap(body, tuple(specs) + (probe_spec,),
             (probe_spec, (R,) * len(specs)))
    val, grads = f(*args)
    out[tag + "/val"] = np.asarray(val)
    for i, t in enumerate(grads):
        out[f"{tag}/g{i}"] = np.asarray(t)


x, w1, w3, bias = (jnp.asarray(inp[k]) for k in ("x", "w1", "w3", "bias"))
y, w2, res = (jnp.asarray(inp[k]) for k in ("y", "w2", "res"))
g_col, g_seq = jnp.asarray(inp["g_col"]), jnp.asarray(inp["g_seq"])
seq, col = P(None, "tp", None), P(None, None, "tp")
for mode in %(modes)r:
    op = ov.FusedOp("ag", axis="tp", mode=mode,
                    epilogue=ov.Epilogue(bias=True, activation="silu"))
    record(f"ag_bias/{mode}", lambda a, b, c: op(a, b, bias=c),
           (x, w1, bias, g_col), (seq, P(None, "tp"), P("tp")), col)
    op2 = ov.FusedOp("ag", axis="tp", mode=mode, n_weights=2,
                     epilogue=ov.Epilogue(activation="silu", gate="pair"))
    record(f"ag_pair/{mode}", lambda a, b, c: op2(a, b, c),
           (x, w1, w3, g_col), (seq, P(None, "tp"), P(None, "tp")), col)
    op3 = ov.FusedOp("rs", axis="tp", mode=mode,
                     epilogue=ov.Epilogue(residual=True))
    record(f"rs_res/{mode}", lambda a, b, c: op3(a, b, residual=c),
           (y, w2, res, g_seq), (col, P("tp", None), seq), seq)

for mode in ("xla", "decomposed"):
    record(f"gather/{mode}", lambda a: ov.gather_seq(a, "tp", mode),
           (x, jnp.asarray(inp["g_full"])), (seq,), P("tp"))
    record(f"scatter/{mode}",
           lambda a: ov.scatter_seq_sum(a[0], "tp", mode)[None],
           (jnp.asarray(inp["parts"]), jnp.asarray(inp["g_scatter"])),
           (R,), R)
ctx = TPContext(axis="tp", mode="decomposed")
for name, fn in (("shift_right", L.shift_tokens_right),
                 ("shift_left", L.shift_tokens_left)):
    record(name, lambda a: fn(a, ctx), (x, jnp.asarray(inp["g_shift"])),
           (seq,), seq)

logits, labels = jnp.asarray(inp["logits"]), jnp.asarray(inp["labels"])
xent = lambda lg: L.vocab_parallel_xent(lg, labels, ctx, %(v_pad)d,
                                        %(v_real)d)[None]
record("xent", xent, (logits, jnp.asarray(inp["g_xent"])),
       (P(None, None, "tp"),), R)
np.savez(sys.argv[2], **out)
print("REF_OK")
"""


def _inputs(b=B, s=S, d=D, f=F):
    rng = np.random.default_rng(7)

    def normal(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    labels = rng.integers(0, V_PAD + 40, (b, s)).astype(np.int32)
    labels[0, :3] = -1
    return {"x": normal(b, s, d), "w1": normal(d, f, scale=0.2),
            "w3": normal(d, f, scale=0.2), "bias": normal(f),
            "y": normal(b, s, f), "w2": normal(f, d, scale=0.2),
            "res": normal(b, s, d), "g_col": normal(b, s, f),
            "g_seq": normal(b, s, d), "g_full": normal(N, b, s, d),
            "parts": normal(N, b, s, d), "g_scatter": normal(N, b, s // N, d),
            "g_shift": normal(b, s, d), "logits": normal(b, s, V_PAD,
                                                         scale=3.0),
            "labels": labels, "g_xent": normal(N, b, s)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory, subproc):
    """(inputs, the reference's values and per-rank grads)."""
    d = tmp_path_factory.mktemp("torch_train")
    inp = _inputs()
    np.savez(d / "in.npz", **inp)
    code = _REF % {"modes": MODES, "v_pad": V_PAD, "v_real": V_REAL}
    code = code.replace("sys.argv[1]", repr(str(d / "in.npz"))).replace(
        "sys.argv[2]", repr(str(d / "out.npz")))
    assert "REF_OK" in subproc(code, n_devices=N)
    return inp, dict(np.load(d / "out.npz"))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _shard(a, r, dim):
    w = a.shape[dim] // N
    return np.take(a, range(r * w, (r + 1) * w), axis=dim)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _port_grads(g, fn, args, probes):
    """Every rank of ``g``: its value and the grads of sum(fn(args) *
    probe), the backward driven from a ``SeamTape``."""
    def body(xs, probe):
        xs = [x.clone().requires_grad_() for x in xs]
        with tov.SeamTape() as tape:
            out = fn(*xs)
            loss = (out * probe).sum()
        tape.backward(loss)
        return out.detach(), [x.grad for x in xs]

    return g.spmd(body, [(args[r], probes[r]) for r in range(N)])


# the ops: (tag, build(group, mode) -> fn, inputs' shard dims, probe dim)
OPS = [
    ("ag_bias", lambda g, m: (lambda a, b, c: tov.FusedOp(
        "ag", axis=g, mode=m, epilogue=tov.Epilogue(
            bias=True, activation="silu"))(a, b, bias=c)),
     [("x", 1), ("w1", 1), ("bias", 0)], ("g_col", 2)),
    ("ag_pair", lambda g, m: tov.FusedOp(
        "ag", axis=g, mode=m, n_weights=2,
        epilogue=tov.Epilogue(activation="silu", gate="pair")),
     [("x", 1), ("w1", 1), ("w3", 1)], ("g_col", 2)),
    ("rs_res", lambda g, m: (lambda a, b, c: tov.FusedOp(
        "rs", axis=g, mode=m, epilogue=tov.Epilogue(residual=True))(
            a, b, residual=c)),
     [("y", 2), ("w2", 0), ("res", 1)], ("g_seq", 1)),
]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tag,build,ins,probe", OPS,
                         ids=[o[0] for o in OPS])
def test_fused_op_grads_match_reference(ref, tag, build, ins, probe, mode):
    inp, out = ref
    args = [[_t(_shard(inp[k], r, dim)) for k, dim in ins] for r in range(N)]
    probes = [_t(_shard(inp[probe[0]], r, probe[1])) for r in range(N)]
    g = dist.RankGroup(N, "cpu", timeout_s=60)
    fn = build(g, mode)
    res = _port_grads(g, fn, args, probes)
    val = np.concatenate([o.numpy() for o, _ in res], axis=probe[1])
    assert _rel(val, out[f"{tag}/{mode}/val"]) <= RTOL
    for i in range(len(ins)):
        for r in range(N):
            got = res[r][1][i].numpy()
            assert _rel(got, out[f"{tag}/{mode}/g{i}"][r]) <= RTOL, (i, r)


def test_seam_under_grad_without_a_tape_raises():
    """A tp>1 seam under grad with no tape recording raises in its
    forward, before any rank could reach a backward that would wait on
    the autograd engine's thread; under no_grad it runs."""
    g = dist.RankGroup(N, "cpu", timeout_s=10)
    op = tov.FusedOp("ag", axis=g, mode="xla")
    w = [torch.ones((D, F // N), requires_grad=True) for _ in range(N)]
    with pytest.raises(RuntimeError, match="SeamTape"):
        g.spmd(lambda w_: op(torch.ones((B, S // N, D)), w_),
               [(w_,) for w_ in w])

    def no_grad(w_):
        with torch.no_grad():
            return op(torch.ones((B, S // N, D)), w_)
    outs = g.spmd(no_grad, [(w_,) for w_ in w])
    assert outs[0].shape == (B, S, F // N)


@pytest.mark.parametrize("mode", ["xla", "decomposed"])
def test_sequence_transports_grads_match_reference(ref, mode):
    inp, out = ref
    x = inp["x"]
    g = dist.RankGroup(N, "cpu", timeout_s=60)
    res = _port_grads(g, lambda a: tov.gather_seq(a, g, mode),
                         [[_t(_shard(x, r, 1))] for r in range(N)],
                         [_t(inp["g_full"][r]) for r in range(N)])
    for r in range(N):
        assert _rel(res[r][1][0].numpy(), out[f"gather/{mode}/g0"][r]) <= RTOL
    res = _port_grads(g, lambda a: tov.scatter_seq_sum(a, g, mode),
                         [[_t(inp["parts"][r])] for r in range(N)],
                         [_t(inp["g_scatter"][r]) for r in range(N)])
    for r in range(N):
        assert _rel(res[r][1][0].numpy(),
                    out[f"scatter/{mode}/g0"][r]) <= RTOL


@pytest.mark.parametrize("name", ["shift_right", "shift_left"])
def test_token_shift_grads_match_reference(ref, name):
    inp, out = ref
    g = dist.RankGroup(N, "cpu", timeout_s=60)
    ctx = TPContext(tp=N, group=g, mode="decomposed")
    fn = getattr(TL, "shift_tokens_" + name.split("_")[1])
    res = _port_grads(g, lambda a: fn(a, ctx),
                         [[_t(_shard(inp["x"], r, 1))] for r in range(N)],
                         [_t(_shard(inp["g_shift"], r, 1)) for r in range(N)])
    val = np.concatenate([o.numpy() for o, _ in res], axis=1)
    assert _rel(val, out[f"{name}/val"]) <= RTOL
    for r in range(N):
        assert _rel(res[r][1][0].numpy(), out[f"{name}/g0"][r]) <= RTOL
    # tp=1: the same function on the whole sequence
    whole = fn(_t(inp["x"]), TPContext())
    assert _rel(whole.numpy(), out[f"{name}/val"]) <= RTOL


def test_vocab_parallel_xent_padded_vocab_matches_reference(ref):
    inp, out = ref
    g = dist.RankGroup(N, "cpu", timeout_s=60)
    ctx = TPContext(tp=N, group=g, mode="decomposed")
    labels = _t(inp["labels"])
    res = _port_grads(
        g, lambda lg: TL.vocab_parallel_xent(lg, labels, ctx, V_PAD, V_REAL),
        [[_t(_shard(inp["logits"], r, 2))] for r in range(N)],
        [_t(inp["g_xent"][r]) for r in range(N)])
    for r in range(N):
        assert _rel(res[r][0].numpy(), out["xent/val"][r]) <= RTOL
        assert _rel(res[r][1][0].numpy(), out["xent/g0"][r]) <= RTOL
    # tp=1 over the whole vocab: the same per-token loss
    whole = TL.vocab_parallel_xent(_t(inp["logits"]), labels, TPContext(),
                                   V_PAD, V_REAL)
    assert _rel(whole.numpy(), out["xent/val"][0]) <= RTOL


# ---------------------------------------------------------------------------
# the schedules and the data stream
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["cosine", "wsd"])
def test_schedules_match_reference(name):
    from repro.optim import schedule as rsched
    for total, warmup in ((3, 0), (10, 1), (100, 10), (1000, 100)):
        steps = np.arange(total + 3)
        want = np.array([np.asarray(getattr(rsched, name)(
            int(s), base_lr=3e-4, warmup=warmup, total=total))
            for s in steps], np.float32)
        got = getattr(tsched, name)(torch.from_numpy(steps), base_lr=3e-4,
                                    warmup=warmup, total=total).numpy()
        np.testing.assert_array_max_ulp(got, want, maxulp=2)
        one = getattr(tsched, name)(total // 2, base_lr=3e-4, warmup=warmup,
                                    total=total)
        assert one.dtype == torch.float32 and one.dim() == 0


def test_batch_at_bit_equal_reference():
    from repro.data import pipeline as rdata
    for vocab, seq, batch, seed in ((512, 64, 4, 0), (122753, 1024, 4, 0),
                                    (32000, 33, 8, 3)):
        rc = rdata.DataConfig(vocab_size=vocab, seq_len=seq,
                              global_batch=batch, seed=seed)
        tc = tdata.DataConfig(vocab_size=vocab, seq_len=seq,
                              global_batch=batch, seed=seed)
        for step in (0, 1, 17):
            for shard, n in ((0, 1), (1, 2)):
                want = rdata.batch_at(rc, step, shard, n)
                got = tdata.batch_at(tc, step, shard, n)
                for k in ("tokens", "labels"):
                    assert got[k].dtype == want[k].dtype
                    np.testing.assert_array_equal(got[k], want[k])
        stream = tdata.DataStream(tc, start_step=5)
        np.testing.assert_array_equal(next(stream)["tokens"],
                                      tdata.batch_at(tc, 5)["tokens"])


# ---------------------------------------------------------------------------
# what raises
# ---------------------------------------------------------------------------
def _cfg(arch="minicpm_2b", **kw):
    return dataclasses.replace(get_smoke_config(arch),
                               compute_dtype="float32", **kw)


def _batch(cfg, b=2, s=16):
    got = tdata.batch_at(tdata.DataConfig(cfg.vocab_size, s, b), 0)
    return {k: torch.from_numpy(v) for k, v in got.items()}


def test_training_paths_not_ported_raise(tmp_path):
    cfg = _cfg()
    par = ParallelConfig()
    params = TM.init_model(cfg, par, dtype=torch.float32, device="cpu",
                           trainable=True)
    # grad through the flash kernel: its backward is item 5
    ctx = make_ctx(ParallelConfig(kernel_decode=True))
    with pytest.raises(NotImplementedError, match="item 5"):
        TM.forward_loss(params, _batch(cfg), ctx, cfg, par)
    # remat is ported: the same loss
    plain = TM.forward_loss(params, _batch(cfg), make_ctx(par), cfg, par)
    remat = TM.forward_loss(params, _batch(cfg), make_ctx(par), cfg,
                            ParallelConfig(remat="full"))
    assert torch.equal(remat, plain)
    # MLA, MoE and the MTP head train (tests/test_torch_train_mla_moe.py)
    assert TM.check_trainable(get_smoke_config("deepseek_v3_671b"),
                              par) is None
    # so do Jamba's Mamba layers (tests/test_torch_jamba_train.py)
    assert TM.check_trainable(get_smoke_config("jamba_v01_52b"),
                              par) is None
    # data parallelism runs on a rank mesh: without one it raises
    with pytest.raises(ValueError, match="RankMesh"):
        TT.make_ctx(cfg, ParallelConfig(dp=2))
    # checkpoints are ported: the trainer opens its directory
    tr = TT.Trainer(cfg, par, TT.TrainConfig(checkpoint_dir=str(tmp_path)),
                    device="cpu")
    assert tr.ckpt is not None and tr.ckpt.latest_step() is None


@pytest.mark.parametrize("flag,field,value", [
    (["--zero3"], "zero3", True), (["--ep", "2"], "ep", 2),
    (["--arch", "deepseek_v3_671b", "--dp", "2"], "ep_over_dp", True)])
def test_train_cli_flags_not_ported_raise(flag, field, value):
    """The three flags that raised until ZeRO-3 and expert parallelism
    were ported: ``--zero3`` and ``--ep`` reach their ``ParallelConfig``
    fields, and ``--dp`` > 1 on an MoE config of more than 16 experts
    turns on ``ep_over_dp`` where the reference's launcher does."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import train as LT
    args = LT.parse_args(["--arch", "minicpm_2b", *flag])
    par = LT.parallel_config(args, get_config(args.arch))
    assert getattr(par, field) == value
    assert par.ep_over_dp == (args.arch == "deepseek_v3_671b")


@pytest.mark.parametrize("flag,field,value", [
    (["--dp", "2"], "dp", 2), (["--pods", "2"], "pods", 2),
    (["--grad-compress"], "grad_compress", True)])
def test_train_cli_dp_flags_reach_their_fields(flag, field, value):
    """The three data-parallel flags that raised until data parallelism
    was ported: each parses and reaches its ``ParallelConfig`` field."""
    from repro_torch.launch import train as LT
    args = LT.parse_args(["--arch", "minicpm_2b", *flag])
    par = LT.parallel_config(args, get_smoke_config("minicpm_2b"))
    assert getattr(par, field) == value


@pytest.mark.parametrize("flag,field,value", [
    (["--wire-dtype", "int8"], "wire_dtype", "int8"),
    (["--max-logit-rmse", "0.1"], "max_logit_rmse", 0.1)])
def test_train_cli_wire_flags_accepted(flag, field, value):
    """The two wire flags that raised until wire precision was ported:
    each parses and reaches its field."""
    from repro_torch.launch import train as LT
    assert getattr(LT.parse_args(["--arch", "minicpm_2b", *flag]),
                   field) == value


@pytest.mark.parametrize("flag", [["--ckpt-dir", "x"],
                                  ["--scatter-axis", "hidden"],
                                  ["--autotune", "--plan-profile", "p.json"],
                                  ["--plan-profile", "p.json"]],
                         ids=["ckpt-dir", "scatter-axis", "autotune",
                              "plan-profile"])
def test_train_cli_flags_once_not_ported_run(flag, tmp_path):
    """The flags that raised until their modules landed: each now trains
    (the smoke config at tp=4 on the CPU, 2 steps).  ``--autotune`` writes
    the profile it then trains from; a missing ``--plan-profile`` file
    loads as no profile (the uniform mode)."""
    from repro_torch.launch import train as LT
    flag = [str(tmp_path / f) if f in ("x", "p.json") else f for f in flag]
    tr, hist = LT.main(["--arch", "minicpm_2b", "--smoke", "--steps", "2",
                        "--tp", "4", "--mode", "flux", "--batch", "2",
                        "--seq", "32", "--device", "cpu", *flag])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    if flag[0] == "--scatter-axis":
        assert tr.par.scatter_axis == "hidden"
    elif flag[0] == "--ckpt-dir":
        assert tr.ckpt is not None
    else:
        assert tr.par.plan_profile == flag[-1]
        assert (tmp_path / "p.json").exists() == (flag[0] == "--autotune")


def test_train_cli_runs_on_cpu(capsys):
    from repro_torch.launch import train as LT
    tr, hist = LT.main(["--arch", "minicpm_2b", "--smoke", "--steps", "2",
                        "--tp", "4", "--mode", "flux", "--batch", "2",
                        "--seq", "32", "--device", "cpu"])
    assert tr.tc.schedule == "wsd" and len(hist) == 2
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert "final loss" in capsys.readouterr().out


@pytest.mark.parametrize("layers", [2, 4])
def test_tape_walks_each_segment_once(layers):
    """The tape's backward at tp=4 on the smoke model: one autograd call
    for the root and one a seam or cut, and no tape leaf reached by more
    than two of them (a cut leaf feeds its sub-block and the next cut), at
    any depth.  Without the residual cuts every seam's segment would walk
    back to the embedding and the calls would grow with depth squared."""
    cfg = _cfg(num_layers=layers)
    par = ParallelConfig(tp=N, overlap_mode="xla")
    full = TM.init_model(cfg, par, dtype=torch.float32, device="cpu",
                         trainable=True)
    ranks = [TM.shard_params(full, r, N, cfg) for r in range(N)]
    g = dist.RankGroup(N, "cpu", timeout_s=60)
    ctx = TT.make_ctx(cfg, par, g)
    batch = _batch(cfg)

    def body(p):
        tape, loss = TT.forward_on_tape(p, batch, ctx, cfg, par)
        reached = []
        for _, _, leaves, _ in tape.entries:
            for i, leaf in enumerate(leaves):
                reached.append(0)
                k = len(reached) - 1
                leaf.register_hook(lambda gr, k=k: reached.__setitem__(
                    k, reached[k] + 1))
        calls = 1 + len(tape.entries)
        TT.grads_from_tape(p, tape, loss)
        return calls, reached

    for calls, reached in g.spmd(body, [(p,) for p in ranks]):
        # the embedding's scatter and the head's gather, the xent's psum,
        # and per layer 4 seams and 2 cuts
        assert calls == 1 + 3 + 6 * layers
        assert 1 <= max(reached) <= 2


def test_trainable_weights_and_shard_copies():
    cfg = _cfg()
    full = TM.init_model(cfg, ParallelConfig(tp=N), dtype=torch.float32,
                         device="cpu", trainable=True)
    assert all(p.requires_grad for p in full.parameters())
    frozen = TM.init_model(cfg, ParallelConfig(), device="cpu")
    assert not any(p.requires_grad for p in frozen.parameters())
    ranks = [TM.shard_params(full, r, N, cfg) for r in range(N)]
    assert all(p.requires_grad for p in ranks[0].parameters())
    # a replicated leaf is each rank's own copy (own grad, own update)
    assert ranks[0].final_norm.data_ptr() != ranks[1].final_norm.data_ptr()
    rep = TM.replicated_leaves(cfg, ranks[0])
    assert rep["final_norm"] and rep["layers.0.mixer.norm"]
    assert not rep["embed"] and not rep["layers.0.mixer.wqkv"]


# ---------------------------------------------------------------------------
# on the card (no JAX there)
# ---------------------------------------------------------------------------
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the fused kernels)")


@pytest.mark.gpu
@pytest.mark.parametrize("tag,build,ins,probe", OPS,
                         ids=[o[0] for o in OPS])
def test_gpu_fused_op_backward_flux_matches_xla(tag, build, ins, probe):
    """bf16 on the card, 4 ranks: flux's forward and backward seams run
    the AG-GEMM and GEMM-RS kernels; xla's run torch.cat / torch.matmul.
    Values and grads within relative L2 2e-2 (bf16 rounding of partials
    summed in another order)."""
    _need_card()
    from repro_torch.kernels import ag_gemm as AG
    from repro_torch.kernels import gemm_rs as RS
    # the kernels take K and N in multiples of 8 (bf16)
    inp = _inputs(b=2, s=256, d=256, f=512)
    dev = torch.device("cuda")

    def on_card(a):
        return torch.from_numpy(a).to(dev, torch.bfloat16)

    args = [[on_card(_shard(inp[k], r, dim)) for k, dim in ins]
            for r in range(N)]
    probes = [on_card(_shard(inp[probe[0]], r, probe[1])) for r in range(N)]
    got = {}
    for mode in ("xla", "flux"):
        g = dist.RankGroup(N, dev, timeout_s=60)
        fn = build(g, mode)
        before = (AG.ag_gemm.launches, RS.gemm_rs.launches)

        def body(xs, pr):
            xs = [x.clone().requires_grad_() for x in xs]
            with tov.SeamTape() as tape:
                out = fn(*xs)
                loss = (out.float() * pr.float()).sum()
            tape.backward(loss)
            return out.detach(), [x.grad for x in xs]

        got[mode] = g.spmd(body, [(args[r], probes[r]) for r in range(N)])
        torch.cuda.synchronize()
        launched = (AG.ag_gemm.launches - before[0],
                    RS.gemm_rs.launches - before[1])
        assert launched == ((0, 0) if mode == "xla" else (N, N)), launched
    for r in range(N):
        for a, b in zip([got["flux"][r][0], *got["flux"][r][1]],
                        [got["xla"][r][0], *got["xla"][r][1]]):
            assert _rel(a.float().cpu(), b.float().cpu()) <= 2e-2


@pytest.mark.gpu
def test_gpu_four_ranks_take_three_steps():
    """The trainer's 4 ranks on the card, flux mode, bf16: 3 steps with no
    barrier timeout (the backward driven from the ranks' threads), finite
    losses, and 4L + 1 launches of each fused kernel a rank a step."""
    _need_card()
    from repro_torch.kernels import ag_gemm as AG
    from repro_torch.kernels import gemm_rs as RS
    cfg = dataclasses.replace(get_smoke_config("minicpm_2b"))
    par = ParallelConfig(tp=N, overlap_mode="flux", fuse_w13=True)
    tr = TT.Trainer(cfg, par, TT.TrainConfig(total_steps=3, warmup_steps=0),
                    device="cuda")
    tr.group.timeout_s = 60
    tr.data_cfg = dataclasses.replace(tr.data_cfg, seq_len=128,
                                      global_batch=4)
    before = (AG.ag_gemm.launches, RS.gemm_rs.launches)
    _, _, hist = tr.train()
    torch.cuda.synchronize()
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    per_step = (4 * cfg.num_layers + 1) * N * 3
    assert (AG.ag_gemm.launches - before[0],
            RS.gemm_rs.launches - before[1]) == (per_step, per_step)

"""The port's RWKV-6 blocks (``repro_torch.models.rwkv``) against the
reference's (``repro.models.rwkv``) on the CPU.

Weights: the reference's ``init_model`` of rwkv6_3b's smoke config (d_model
128: 4 heads of 32, decay LoRA 16, d_ff 256), layer 0's time-mix and
channel-mix, carried into the port by ``convert.params_from_jax``.  Inputs
are drawn with numpy from a seed.  The reference's functions run under
``jax.jit`` (one compile a signature), in the replicated layout at tp=1.

* ``_wkv_chunk`` against the reference's on the same chunk, and the chunk
  loop (``wkv``) against the reference's chunks chained, a ragged S among
  them (40 over a chunk of 16: the chunk halves to 8);
* ``rwkv_time_train`` / ``rwkv_channel_train`` whole, with ``lengths`` and
  from a carried-in ``cache``: the output and the returned state;
* the two decodes from the reference's prefill state, step by step;
* the heads padded at a tp that does not divide them (d_model 96: 3 heads
  padded to 4 at tp=2 and tp=4; d_ff 256 to 512 at tp=4): the port's ranks
  in a CPU ``RankGroup`` in the sequence-sharded layout against the
  reference at tp=1 on the same canonical weights;
* bf16 weights and compute;
* under grad both decodes raise (the serving step, forward only, as the
  reference's), and the trainable model's ``forward_loss`` reaches every
  leaf (the grads themselves: ``tests/test_torch_rwkv_train.py``).

Tolerances, relative L2: fp32 1e-4, bf16 2e-2.  The ``gpu`` case runs the
channel-mix's AG-GEMM with its squared-ReLU epilogue (activation code 4)
on the card against its plain version (skipped without a card).  This
file imports no JAX at the top: the card's machine has none.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.base import ParallelConfig, get_smoke_config
from repro_torch.dist import RankGroup
from repro_torch.models import model as TM
from repro_torch.models import rwkv as TR
from repro_torch.parallel.sharding import TPContext, make_ctx

ARCH = "rwkv6_3b"
F32_RTOL = 1e-4
BF16_RTOL = 2e-2
B, S = 3, 24
CHUNK = 8
LENGTHS = [24, 1, 13]
PAD_D = 96                       # 3 heads of 32


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The smoke blocks' ops are small: one intra-op thread runs them
    faster than a pool does, and a pool in each of the suite's workers
    oversubscribes the cores they share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _np(t):
    return t.detach().float().cpu().numpy()


def _x(seed, shape, scale=1.0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * scale


def _cfg(dtype="float32", d_model=None):
    cfg = dataclasses.replace(get_smoke_config(ARCH), compute_dtype=dtype)
    return cfg if d_model is None else dataclasses.replace(cfg,
                                                           d_model=d_model)


@functools.lru_cache(maxsize=None)
def _weights(dtype: str, d_model=None, tp: int = 1):
    """(the reference's layer-0 (time-mix, channel-mix) trees, the port's
    global ``Model``) from the reference's ``init_model`` at ``tp``
    through ``convert``."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ParallelConfig as RPar
    from repro.configs.base import get_smoke_config as rsmoke
    from repro.models import model as RM
    rcfg = dataclasses.replace(rsmoke(ARCH), compute_dtype=dtype)
    if d_model is not None:
        rcfg = dataclasses.replace(rcfg, d_model=d_model)
    tree = RM.init_model(jax.random.PRNGKey(0), rcfg, RPar(tp=tp, dp=1),
                         dtype=getattr(jnp, dtype))
    np_tree = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    port = convert.params_from_jax(np_tree, _cfg(dtype, d_model),
                                   dtype=getattr(torch, dtype), device="cpu")
    layer = jax.tree.map(lambda a: a[0], tree["periods"][0])
    return (layer["mixer"], layer["ffn"]), port


@functools.lru_cache(maxsize=None)
def _ref_fns(dtype: str, d_model=None):
    """The reference's four entry points at ``dtype``, jitted, in the
    replicated layout at tp=1 (where the reference takes a carried-in
    state)."""
    import jax
    from repro.configs.base import get_smoke_config as rsmoke
    from repro.models import rwkv as RR
    from repro.parallel.sharding import TPContext as RCtx
    rcfg = dataclasses.replace(rsmoke(ARCH), compute_dtype=dtype)
    if d_model is not None:
        rcfg = dataclasses.replace(rcfg, d_model=d_model)
    ctx = RCtx(seq_shard=False)
    return {
        "time": jax.jit(lambda p, x, lengths, cache: RR.rwkv_time_train(
            p, x, ctx, rcfg, chunk=CHUNK, with_cache=True, lengths=lengths,
            cache=cache)),
        "channel": jax.jit(lambda p, x, lengths, cache: RR.rwkv_channel_train(
            p, x, ctx, rcfg, with_cache=True, lengths=lengths,
            cache=cache)),
        "time_decode": jax.jit(lambda p, x, cache: RR.rwkv_time_decode(
            p, x, cache, ctx, rcfg)),
        "channel_decode": jax.jit(lambda p, x, cache: RR.rwkv_channel_decode(
            p, x, cache, ctx, rcfg))}


def _jnp(a):
    import jax.numpy as jnp
    return None if a is None else jnp.asarray(a)


def _ref_run(which, p, x, cfg, lengths=None, cache=None, d_model=None):
    import jax.numpy as jnp
    fn = _ref_fns(cfg.compute_dtype, d_model)[which]
    xj = jnp.asarray(x, cfg.compute_dtype)
    c = None if cache is None else {k: _jnp(v) for k, v in cache.items()}
    if which.endswith("decode"):
        out, st = fn(p, xj, c)
    else:
        out, st = fn(p, xj, None if lengths is None
                     else jnp.asarray(lengths, jnp.int32), c)
    return np.asarray(out, np.float32), {k: np.asarray(v, np.float32)
                                         for k, v in st.items()}


_PORT = {"time": TR.rwkv_time_train, "channel": TR.rwkv_channel_train,
         "time_decode": TR.rwkv_time_decode,
         "channel_decode": TR.rwkv_channel_decode}


def _port_run(which, p, x, cfg, lengths=None, cache=None):
    dt = getattr(torch, cfg.compute_dtype)
    ctx = TPContext(seq_sharded=False)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(dt)
    c = None if cache is None else {
        k: torch.from_numpy(np.array(v)).to(torch.float32 if k == "state"
                                            else dt)
        for k, v in cache.items()}
    with torch.no_grad():
        if which.endswith("decode"):
            out, st = _PORT[which](p, xt, c, ctx, cfg)
        elif which == "time":
            out, st = _PORT[which](
                p, xt, ctx, cfg, chunk=CHUNK, with_cache=True,
                lengths=None if lengths is None else torch.tensor(lengths),
                cache=c)
        else:
            out, st = _PORT[which](
                p, xt, ctx, cfg, with_cache=True,
                lengths=None if lengths is None else torch.tensor(lengths),
                cache=c)
    return _np(out), {k: _np(v) for k, v in st.items()}


def _assert_close(got, want, rtol, lengths=None):
    """Outputs at pad positions are not meaningful: only each row's own
    positions compare."""
    (gy, gs), (wy, ws) = got, want
    if lengths is not None:
        for r, n in enumerate(lengths):
            assert _rel(gy[r, :n], wy[r, :n]) <= rtol, r
    else:
        assert _rel(gy, wy) <= rtol
    assert sorted(gs) == sorted(ws)
    for k in ws:
        assert _rel(gs[k], ws[k]) <= rtol, k


def _block(port, which):
    blk = port.layers[0]
    return blk.mixer if which.startswith("time") else blk.ffn


def _ref_block(ref, which):
    return ref[0] if which.startswith("time") else ref[1]


# ---------------------------------------------------------------------------
# the wkv
# ---------------------------------------------------------------------------
def _wkv_inputs(s, h=3, dh=8, b=2):
    r, k, v = (_x(i, (b, h, s, dh)) for i in (1, 2, 3))
    logw = -np.exp(_x(4, (b, h, s, dh), 0.5) - 2.0)
    u = _x(5, (h, dh), 0.1)
    s0 = _x(6, (b, h, dh, dh))
    return r, k, v, logw.astype(np.float32), u, s0


def test_wkv_chunk_matches_reference():
    import jax
    from repro.models.rwkv import _wkv_chunk
    args = _wkv_inputs(16)
    y, st = jax.jit(_wkv_chunk)(*args)
    gy, gst = TR._wkv_chunk(*(torch.from_numpy(a) for a in args))
    assert _rel(_np(gy), np.asarray(y)) <= F32_RTOL
    assert _rel(_np(gst), np.asarray(st)) <= F32_RTOL


@pytest.mark.parametrize("s,chunk", [(64, 16), (40, 16), (7, 64)])
def test_wkv_chunk_loop_matches_reference_chunks(s, chunk):
    """The loop over chunks against the reference's ``_wkv_chunk``
    chained over the same chunks (its rule: the chunk halves until it
    divides S; 40 over 16 runs chunks of 8)."""
    import jax
    from repro.models.rwkv import _wkv_chunk
    ref_chunk = jax.jit(_wkv_chunk)
    r, k, v, logw, u, s0 = _wkv_inputs(s)
    y, st = TR.wkv(*(torch.from_numpy(a) for a in (r, k, v, logw, u, s0)),
                   chunk=chunk)
    step = TR._chunk_len(s, chunk)
    assert step == {64: 16, 40: 8, 7: 7}[s]
    ys, sr = [], s0
    for i in range(0, s, step):
        sl = slice(i, i + step)
        yc, sr = ref_chunk(r[:, :, sl], k[:, :, sl], v[:, :, sl],
                           logw[:, :, sl], u, sr)
        ys.append(np.asarray(yc))
    assert _rel(_np(y), np.concatenate(ys, 2)) <= F32_RTOL
    assert _rel(_np(st), np.asarray(sr)) <= F32_RTOL


# ---------------------------------------------------------------------------
# the blocks at tp=1
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["whole", "lengths", "cache"])
@pytest.mark.parametrize("which", ["time", "channel"])
def test_block_matches_reference(which, case):
    """The prefill of each block (a row of length 1 among ``lengths``: its
    token shift starts at the zero row, its state holds one token), and a
    chunk continuing from a carried-in state (the reference's prefill of
    5 other tokens): the output and the state."""
    cfg = _cfg()
    ref, port = _weights("float32")
    rp, pp = _ref_block(ref, which), _block(port, which)
    x = _x(10, (B, S, cfg.d_model))
    lengths = LENGTHS if case == "lengths" else None
    cache = None
    if case == "cache":
        _, cache = _ref_run(which, rp, _x(11, (B, 5, cfg.d_model)), cfg)
    _assert_close(_port_run(which, pp, x, cfg, lengths, cache),
                  _ref_run(which, rp, x, cfg, lengths, cache), F32_RTOL,
                  lengths)


@pytest.mark.parametrize("which", ["time", "channel"])
def test_chunks_equal_whole(which):
    """The sequence as two chunks (the first's state carried into the
    second, the second right-padded past its length) equals one run over
    the whole sequence: outputs and final state."""
    cfg = _cfg()
    _, port = _weights("float32")
    p = _block(port, which)
    x = _x(12, (B, S, cfg.d_model))
    y, st = _port_run(which, p, x, cfg)
    cut = 9
    y1, st1 = _port_run(which, p, x[:, :cut], cfg)
    tail = np.zeros_like(x)
    tail[:, :S - cut] = x[:, cut:]
    y2, st2 = _port_run(which, p, tail, cfg, lengths=[S - cut] * B,
                        cache=st1)
    assert _rel(np.concatenate([y1, y2[:, :S - cut]], 1), y) <= F32_RTOL
    for k in st:
        assert _rel(st2[k], st[k]) <= F32_RTOL, k


@pytest.mark.parametrize("which", ["time", "channel"])
def test_decode_continues_reference_prefill(which):
    """Four decode steps from the reference's prefill state (rows at
    their own lengths), each step's output and state against the
    reference's; then the port's steps against one prefill over the
    prompt and the stepped inputs (row 0)."""
    cfg = _cfg()
    ref, port = _weights("float32")
    rp, pp = _ref_block(ref, which), _block(port, which)
    dec = which + "_decode"
    x = _x(13, (B, S, cfg.d_model))
    steps = _x(14, (4, B, 1, cfg.d_model))
    _, rst = _ref_run(which, rp, x, cfg, LENGTHS)
    pst, outs = rst, []
    for xs in steps:
        want, rst = _ref_run(dec, rp, xs, cfg, cache=rst)
        got, pst = _port_run(dec, pp, xs, cfg, cache=pst)
        _assert_close((got, pst), (want, rst), F32_RTOL)
        outs.append(got[:, 0])
    full = np.concatenate([x[:1], steps[:, :1, 0].transpose(1, 0, 2)], 1)
    y, st = _port_run(which, pp, full, cfg)
    assert _rel(np.stack(outs, 1)[0], y[0, S:]) <= F32_RTOL
    for k in st:
        assert _rel(pst[k][:1], st[k]) <= F32_RTOL, k


@pytest.mark.parametrize("which", ["time", "channel"])
def test_bf16_matches_reference(which):
    cfg = _cfg("bfloat16")
    ref, port = _weights("bfloat16")
    mixer = port.layers[0].mixer
    assert mixer["dec_base"].dtype == mixer["u_bonus"].dtype == torch.float32
    assert mixer["w_dec2"].dtype == torch.bfloat16
    rp, pp = _ref_block(ref, which), _block(port, which)
    x = _x(15, (B, S, cfg.d_model))
    got = _port_run(which, pp, x, cfg, LENGTHS)
    want = _ref_run(which, rp, x, cfg, LENGTHS)
    _assert_close(got, want, BF16_RTOL, LENGTHS)
    xs = _x(16, (B, 1, cfg.d_model))
    cache = {k: v for k, v in want[1].items()}
    _assert_close(_port_run(which + "_decode", pp, xs, cfg, cache=cache),
                  _ref_run(which + "_decode", rp, xs, cfg, cache=cache),
                  BF16_RTOL)


# ---------------------------------------------------------------------------
# heads padded to tp
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tp", [2, 4])
def test_padded_heads_match_reference_tp1(tp):
    """d_model 96: 3 heads of 32 padded to 4 at tp=2 and tp=4 (the
    padded head's columns and ``w_o`` rows zero, its decay base -6), d_ff
    256 padded to 512 at tp=4.  The reference's init at ``tp`` carried
    into the port and cut into ranks; its canonical leaves equal the
    reference's tp=1 init's; each block on the ranks of a CPU
    ``RankGroup`` (sequence-sharded, ``lengths`` given) against the
    reference at tp=1 on the canonical weights: the output, the wkv state
    of the real heads (the padded head's stays zero) and the token-shift
    rows."""
    cfg = _cfg(d_model=PAD_D)
    ref, one = _weights("float32", PAD_D, 1)
    _, full = _weights("float32", PAD_D, tp)
    n_heads, dh, _ = TR._dims(cfg, tp)
    assert n_heads == 4 and TR._dims(cfg, 1)[0] == 3
    want_named = dict(one.named_parameters())
    got_named = TM.canonical_leaves(dict(full.named_parameters()), cfg, tp)
    assert sorted(got_named) == sorted(want_named)
    for n, t in want_named.items():
        assert torch.equal(got_named[n], t), n
    ranks = [TM.shard_params(full, r, tp, cfg) for r in range(tp)]
    group = RankGroup(tp, "cpu", timeout_s=60)
    ctx = make_ctx(ParallelConfig(tp=tp, overlap_mode="decomposed"), group)
    x = _x(17, (B, S, cfg.d_model))
    lens = [S, 7, 13]
    s_loc = S // tp

    def body(p, r):
        xs = torch.from_numpy(x[:, r * s_loc:(r + 1) * s_loc])
        with torch.no_grad():
            t_out, t_st = TR.rwkv_time_train(
                p.layers[0].mixer, xs, ctx, cfg, chunk=CHUNK,
                with_cache=True, lengths=torch.tensor(lens))
            c_out, c_st = TR.rwkv_channel_train(
                p.layers[0].ffn, xs, ctx, cfg, with_cache=True,
                lengths=torch.tensor(lens))
        return t_out, t_st, c_out, c_st

    outs = group.spmd(body, [(p, r) for r, p in enumerate(ranks)])
    hl = n_heads // tp
    for k, which in ((0, "time"), (2, "channel")):
        got_y = _np(torch.cat([o[k] for o in outs], 1))
        want_y, want_st = _ref_run(which, _ref_block(ref, which), x, cfg,
                                   lens, d_model=PAD_D)
        for r, n in enumerate(lens):
            assert _rel(got_y[r, :n], want_y[r, :n]) <= F32_RTOL, (which, r)
        for o in outs:
            assert _rel(_np(o[k + 1]["last"]), want_st["last"]) <= F32_RTOL
        if which == "time":
            st = _np(torch.cat([o[1]["state"] for o in outs], 1))
            assert st.shape[1] == hl * tp
            assert _rel(st[:, :3], want_st["state"]) <= F32_RTOL
            assert not st[:, 3:].any()


# ---------------------------------------------------------------------------
# under grad
# ---------------------------------------------------------------------------
def test_rwkv_decodes_refuse_grad():
    """Under grad (an input or a weight that requires grad) both decodes
    raise ``NotImplementedError``: they are the serving step, forward only,
    and the message names the training forward; without grad they run.
    ``check_trainable`` passes for rwkv6_3b, and a trainable model's
    ``forward_loss`` with grad on gives a finite loss whose backward
    reaches every leaf."""
    cfg = _cfg()
    model = TM.init_model(cfg, ParallelConfig(), dtype=torch.float32,
                          device="cpu")
    mixer, chan = model.layers[0].mixer, model.layers[0].ffn
    ctx = TPContext(seq_sharded=False)
    x = torch.randn(1, 1, cfg.d_model, requires_grad=True)
    time_c = {"state": torch.zeros(1, 4, 32, 32),
              "last": torch.zeros(1, cfg.d_model)}
    chan_c = {"last": torch.zeros(1, cfg.d_model)}
    calls = [("rwkv_time_train", lambda v: TR.rwkv_time_decode(
                 mixer, v, time_c, ctx, cfg)),
             ("rwkv_channel_train", lambda v: TR.rwkv_channel_decode(
                 chan, v, chan_c, ctx, cfg))]
    for train, call in calls:
        with pytest.raises(NotImplementedError,
                           match=f"serving step.*{train}"):
            call(x)
        with torch.no_grad():
            out, _ = call(x)
        assert out.shape == (1, 1, cfg.d_model)
    TM.check_trainable(get_smoke_config(ARCH), ParallelConfig())
    trainable = TM.init_model(cfg, ParallelConfig(), dtype=torch.float32,
                              device="cpu", trainable=True)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, 8)),
             "labels": torch.randint(0, cfg.vocab_size, (1, 8))}
    loss = TM.forward_loss(trainable, batch, ctx, cfg, ParallelConfig())
    assert torch.isfinite(loss)
    loss.backward()
    for n, t in trainable.named_parameters():
        assert t.grad is not None and bool(torch.isfinite(t.grad).all()), n


def test_init_matches_reference_layout():
    """The port's own init has the reference's leaves, shapes and dtypes
    at tp=1, 2 and 4 (d_model 96's padded heads among them)."""
    import jax
    from repro.configs.base import ParallelConfig as RPar
    from repro.configs.base import get_smoke_config as rsmoke
    from repro.models import model as RM
    for d in (None, PAD_D):
        rcfg = rsmoke(ARCH) if d is None else dataclasses.replace(
            rsmoke(ARCH), d_model=d)
        for tp in (1, 2, 4):
            want = jax.eval_shape(lambda: RM.init_model(
                jax.random.PRNGKey(0), rcfg, RPar(tp=tp, dp=1)))[
                "periods"][0]
            got = TM.init_model(_cfg("bfloat16", d), ParallelConfig(tp=tp),
                                device="cpu").layers[0]
            for part in ("mixer", "ffn"):
                leaves = getattr(got, part)
                assert sorted(leaves) == sorted(want[part])
                for k, t in leaves.items():
                    assert tuple(t.shape) == want[part][k].shape[1:], (
                        tp, part, k)
                    assert str(t.dtype)[6:] == str(want[part][k].dtype), (
                        tp, part, k)


def test_cache_shapes():
    cfg = get_smoke_config(ARCH)
    time, chan = TR.rwkv_cache_shapes(cfg, 2, 3)
    assert time == {"state": ((3, 2, 32, 32), torch.float32),
                    "last": ((3, 128), torch.bfloat16)}
    assert chan == {"last": ((3, 128), torch.bfloat16)}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_gpu_sqrelu_ag_gemm_matches_plain():
    """The channel-mix's ``mlp_ag`` on the card: the AG-GEMM kernel with
    the squared-ReLU epilogue (activation code 4) at 2 ranks, bf16, a
    ragged N (448 a rank), against its plain version within 2 bf16 ulps
    of the output's scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused kernels run only there")
    from repro_torch.kernels import ag_gemm as AG
    n, rows, k, nn = 2, 256, 640, 448
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    args = [tuple(torch.randn(sh, generator=gen, device="cuda").to(
        torch.bfloat16) for sh in ((rows, k), (k, nn))) for _ in range(n)]
    g = RankGroup(n, "cuda", timeout_s=60)
    outs = g.spmd(lambda a, b: AG.ag_gemm(a, b, group=g,
                                          activation="sqrelu"), args)
    torch.cuda.synchronize()
    shards = [a for a, _ in args]
    for out, (_, b) in zip(outs, args):
        want = AG.ag_gemm_ref(shards, b, "sqrelu").float().cpu().numpy()
        np.testing.assert_allclose(out.float().cpu().numpy(), want,
                                   atol=1e-3 * np.abs(want).max(),
                                   rtol=2.0 ** -7)

"""The port's Mamba mixer (``repro_torch.models.mamba``) against the
reference's (``repro.models.mamba``) on the CPU, at tp=1.

Weights: the reference's ``init_model`` of Jamba's smoke config (d_model
128, 256 channels, d_state 8, d_conv 4) cut to one period of 8 layers,
layer 0's mixer, carried into the port by ``convert.params_from_jax``, with
``fuse_w13`` off (``w_in_x`` / ``w_in_z``, one shared gather) and on
(``w_in_xz``).  Inputs are drawn with numpy from a seed.  The reference's
mixer and scan run under ``jax.jit``.

* ``selective_scan`` against the reference's ``_selective_scan_chunk``
  chained over the same chunks (the chunk halving until it divides S);
* ``mamba_train`` without and with ``lengths`` (a row shorter than
  d_conv - 1 among them) and from a carried-in ``cache``: the output and
  the returned ``conv`` / ``ssm`` state;
* a sequence run as two chunks, the state carried, equals one run over
  the whole;
* ``mamba_decode`` steps continuing the reference's prefill state, and
  the port's own decode steps against one longer prefill;
* in bf16 weights and compute, ``mamba_train`` and a decode step.

Tolerances, relative L2: fp32 1e-4 (the port's scan associates its
products in Hillis-Steele rounds, XLA's ``associative_scan`` in another
order); bf16 2e-2.  The ``gpu`` case runs the scan on the card against
the CPU's (skipped without one).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.base import ParallelConfig, get_smoke_config
from repro_torch.models import mamba as TMB
from repro_torch.models import model as TM
from repro_torch.parallel.sharding import TPContext

ARCH = "jamba_v01_52b"
F32_RTOL = 1e-4
BF16_RTOL = 2e-2
B, S = 3, 24
CHUNK = 8
LENGTHS = [24, 2, 13]            # 2 < d_conv - 1


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _np(t):
    return t.detach().float().cpu().numpy()


def _cfg(dtype="float32"):
    """The smoke config cut to one period of its pattern (8 layers): only
    layer 0's mixer is used."""
    cfg = get_smoke_config(ARCH)
    return dataclasses.replace(cfg, num_layers=len(cfg.pattern),
                               compute_dtype=dtype)


@functools.lru_cache(maxsize=None)
def _weights(fuse: bool, dtype: str):
    """(the reference's layer-0 mixer tree, the port's mixer) from the
    reference's ``init_model`` through ``convert``."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ParallelConfig as RPar
    from repro.configs.base import get_smoke_config as rsmoke
    from repro.models import model as RM
    rcfg = dataclasses.replace(rsmoke(ARCH), num_layers=_cfg().num_layers,
                               compute_dtype=dtype)
    jdt = getattr(jnp, dtype)
    tree = RM.init_model(jax.random.PRNGKey(0), rcfg,
                         RPar(tp=1, dp=1, fuse_w13=fuse), dtype=jdt)
    np_tree = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    port = convert.params_from_jax(np_tree, _cfg(dtype),
                                   dtype=getattr(torch, dtype), device="cpu")
    ref = jax.tree.map(lambda a: a[0], tree["periods"][0]["mixer"])
    return ref, port.layers[0].mixer


def _x(seed, shape, scale=1.0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * scale


def _ref_ctx():
    from repro.parallel.sharding import TPContext as RCtx
    # the replicated layout: the reference takes a carried-in state only
    # there (at tp=1 the layouts compute the same)
    return RCtx(seq_shard=False)


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s,chunk", [(64, 16), (40, 16), (7, 256)])
def test_selective_scan_matches_reference_chunks(s, chunk):
    import jax
    import jax.numpy as jnp
    from repro.models.mamba import _selective_scan_chunk
    scan_chunk = jax.jit(_selective_scan_chunk)
    c, n = 32, 8
    x = _x(1, (2, s, c))
    dt = np.log1p(np.exp(_x(2, (2, s, c)) - 2.0)).astype(np.float32)
    bb, cc = _x(3, (2, s, n)), _x(4, (2, s, n))
    a = -np.exp(_x(5, (c, n), 0.5))
    h0 = _x(6, (2, c, n))
    y, h = TMB.selective_scan(*(torch.from_numpy(v) for v in
                                (x, dt, bb, cc, a, h0)), chunk=chunk)
    step = min(chunk, s)
    while s % step:
        step //= 2
    ys, hr = [], jnp.asarray(h0)
    for i in range(0, s, step):
        sl = slice(i, i + step)
        yc, hr = scan_chunk(x[:, sl], dt[:, sl], bb[:, sl], cc[:, sl], a,
                            hr)
        ys.append(np.asarray(yc))
    assert _rel(_np(y), np.concatenate(ys, 1)) <= F32_RTOL
    assert _rel(_np(h), np.asarray(hr)) <= F32_RTOL


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _ref_fns(dtype: str):
    """The reference's ``mamba_train`` (with its cache) and
    ``mamba_decode`` at ``dtype``, jitted: one compile a signature in
    place of one a primitive."""
    import jax
    from repro.configs.base import get_smoke_config as rsmoke
    from repro.models import mamba as RMB
    rcfg = dataclasses.replace(rsmoke(ARCH), compute_dtype=dtype)
    train = jax.jit(lambda p, x, lengths, cache: RMB.mamba_train(
        p, x, _ref_ctx(), rcfg, chunk=CHUNK, with_cache=True,
        lengths=lengths, cache=cache))
    decode = jax.jit(lambda p, x, cache: RMB.mamba_decode(
        p, x, cache, 0, _ref_ctx(), rcfg))
    return train, decode


def _ref_train(ref, x, cfg, lengths=None, cache=None):
    import jax.numpy as jnp
    out, st = _ref_fns(cfg.compute_dtype)[0](
        ref, jnp.asarray(x, cfg.compute_dtype),
        None if lengths is None else jnp.asarray(lengths, jnp.int32),
        None if cache is None else {k: jnp.asarray(v)
                                    for k, v in cache.items()})
    return np.asarray(out, np.float32), {k: np.asarray(v, np.float32)
                                         for k, v in st.items()}


def _port_train(mixer, x, cfg, lengths=None, cache=None):
    dt = getattr(torch, cfg.compute_dtype)
    with torch.no_grad():
        out, st = TMB.mamba_train(
            mixer, torch.from_numpy(x).to(dt), TPContext(), cfg, chunk=CHUNK,
            with_cache=True,
            lengths=None if lengths is None else torch.tensor(lengths),
            cache=None if cache is None else {
                k: torch.from_numpy(np.array(v)) for k, v in cache.items()})
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
    for k in ("conv", "ssm"):
        assert _rel(gs[k], ws[k]) <= rtol, k


@pytest.mark.parametrize("case", ["whole", "lengths", "cache"])
@pytest.mark.parametrize("fuse", [False, True])
def test_mamba_train_matches_reference(fuse, case):
    cfg = _cfg()
    ref, mixer = _weights(fuse, "float32")
    x = _x(10, (B, S, cfg.d_model))
    lengths = LENGTHS if case == "lengths" else None
    cache = None
    if case == "cache":
        _, cache = _ref_train(ref, _x(11, (B, 5, cfg.d_model)), cfg)
    _assert_close(_port_train(mixer, x, cfg, lengths, cache),
                  _ref_train(ref, x, cfg, lengths, cache), F32_RTOL, lengths)


@pytest.mark.parametrize("fuse", [False, True])
def test_chunks_equal_whole(fuse):
    """The sequence as two chunks (the first chunk's state carried into
    the second, the second right-padded past its length) equals one run
    over the whole sequence: outputs and final state."""
    cfg = _cfg()
    _, mixer = _weights(fuse, "float32")
    x = _x(12, (B, S, cfg.d_model))
    y, st = _port_train(mixer, x, cfg)
    cut = 9
    y1, st1 = _port_train(mixer, x[:, :cut], cfg)
    tail = np.zeros_like(x[:, :S])
    tail[:, :S - cut] = x[:, cut:]
    y2, st2 = _port_train(mixer, tail, cfg, lengths=[S - cut] * B,
                          cache=st1)
    assert _rel(np.concatenate([y1, y2[:, :S - cut]], 1), y) <= F32_RTOL
    for k in ("conv", "ssm"):
        assert _rel(st2[k], st[k]) <= F32_RTOL, k


def _ref_decode(ref, x, cache, cfg):
    import jax.numpy as jnp
    out, st = _ref_fns(cfg.compute_dtype)[1](
        ref, jnp.asarray(x, cfg.compute_dtype),
        {k: jnp.asarray(v) for k, v in cache.items()})
    return np.asarray(out, np.float32), {k: np.asarray(v, np.float32)
                                         for k, v in st.items()}


def _port_decode(mixer, x, cache, cfg):
    dt = getattr(torch, cfg.compute_dtype)
    conv_dt = dt if cfg.compute_dtype == "float32" else torch.bfloat16
    with torch.no_grad():
        out, st = TMB.mamba_decode(
            mixer, torch.from_numpy(x).to(dt),
            {"conv": torch.from_numpy(np.array(cache["conv"])).to(conv_dt),
             "ssm": torch.from_numpy(np.array(cache["ssm"]))},
            torch.zeros(x.shape[0], dtype=torch.long), TPContext(), cfg)
    return _np(out), {k: _np(v) for k, v in st.items()}


@pytest.mark.parametrize("fuse", [False, True])
def test_mamba_decode_continues_prefill(fuse):
    """Four decode steps from the reference's prefill state (rows at
    their own lengths, one shorter than d_conv - 1), each step's output
    and state against the reference's; and the port's steps against one
    prefill over the prompt and the stepped inputs."""
    cfg = _cfg()
    ref, mixer = _weights(fuse, "float32")
    x = _x(13, (B, S, cfg.d_model))
    steps = _x(14, (4, B, 1, cfg.d_model))
    _, rst = _ref_train(ref, x, cfg, LENGTHS)
    pst = rst
    outs = []
    for xs in steps:
        want, rst = _ref_decode(ref, xs, rst, cfg)
        got, pst = _port_decode(mixer, xs, pst, cfg)
        assert _rel(got, want) <= F32_RTOL
        for k in ("conv", "ssm"):
            assert _rel(pst[k], rst[k]) <= F32_RTOL, k
        outs.append(got[:, 0])
    # row 0 (length S): prefill over S + 4 inputs ends with the same state
    full = np.concatenate([x[:1], steps[:, :1, 0].transpose(1, 0, 2)], 1)
    y, st = _port_train(mixer, full, cfg)
    assert _rel(np.stack(outs, 1)[0], y[0, S:]) <= F32_RTOL
    for k in ("conv", "ssm"):
        assert _rel(pst[k][:1], st[k]) <= F32_RTOL, k


@pytest.mark.parametrize("fuse", [False, True])
def test_bf16_matches_reference(fuse):
    cfg = _cfg("bfloat16")
    ref, mixer = _weights(fuse, "bfloat16")
    assert mixer["a_log"].dtype == mixer["d_skip"].dtype == torch.float32
    assert mixer["dt_bias"].dtype == torch.bfloat16
    x = _x(15, (B, S, cfg.d_model))
    got = _port_train(mixer, x, cfg, LENGTHS)
    want = _ref_train(ref, x, cfg, LENGTHS)
    _assert_close(got, want, BF16_RTOL, LENGTHS)
    xs = _x(16, (B, 1, cfg.d_model))
    gd = _port_decode(mixer, xs, want[1], cfg)
    wd = _ref_decode(ref, xs, want[1], cfg)
    assert _rel(gd[0], wd[0]) <= BF16_RTOL
    assert _rel(gd[1]["ssm"], wd[1]["ssm"]) <= BF16_RTOL


def test_init_matches_reference_layout():
    """The port's own init has the reference's leaves, shapes and dtypes
    (unfused and packed, tp=1 and tp=4's padding)."""
    import jax
    from repro.configs.base import ParallelConfig as RPar
    from repro.configs.base import get_smoke_config as rsmoke
    from repro.models import model as RM
    for tp in (1, 4):
        for fuse in (False, True):
            want = jax.eval_shape(lambda: RM.init_model(
                jax.random.PRNGKey(0), rsmoke(ARCH),
                RPar(tp=tp, dp=1, fuse_w13=fuse)))["periods"][0]["mixer"]
            got = TM.init_model(get_smoke_config(ARCH),
                                ParallelConfig(tp=tp, fuse_w13=fuse),
                                device="cpu").layers[0].mixer
            assert sorted(got) == sorted(want)
            for k, t in got.items():
                assert tuple(t.shape) == want[k].shape[1:], (tp, fuse, k)
                assert str(t.dtype)[6:] == str(want[k].dtype), (tp, k)


def test_cache_shapes():
    cfg = get_smoke_config(ARCH)
    shapes = TMB.mamba_cache_shapes(cfg, 2, 3)
    assert shapes == {"conv": ((3, 3, 128), torch.bfloat16),
                      "ssm": ((3, 128, 8), torch.float32)}


@pytest.mark.gpu
def test_gpu_scan_matches_cpu():
    """The scan on the card (plain PyTorch, as on the CPU) against the
    CPU's, at a chunk of 256 over 512 positions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = [torch.from_numpy(v) for v in (
        _x(1, (2, 512, 256)), np.abs(_x(2, (2, 512, 256), 0.05)),
        _x(3, (2, 512, 16)), _x(4, (2, 512, 16)),
        -np.exp(_x(5, (256, 16), 0.5)), _x(6, (2, 256, 16)))]
    y, h = TMB.selective_scan(*args)
    yc, hc = TMB.selective_scan(*(a.cuda() for a in args))
    assert _rel(_np(yc), _np(y)) <= F32_RTOL
    assert _rel(_np(hc), _np(h)) <= F32_RTOL

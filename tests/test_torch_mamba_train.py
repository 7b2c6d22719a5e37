"""The Mamba mixer under grad: the selective scan whose backward recomputes
each chunk (``repro_torch.models.mamba.selective_scan``) and
``mamba_train``'s grads, against ``jax.grad`` of the reference's, on the
CPU at tp=1.

* the scan's grads for x, dt, B, C, A and h0 against ``jax.grad`` of the
  reference's ``_selective_scan_chunk`` chained over the same chunks, for
  several (S, chunk) pairs, a ragged halving among them, with cotangents
  on the output and on the final state;
* its forward under grad bit-equal to the serving scan's (the same
  inputs under ``no_grad``);
* the bytes it saves, read through ``saved_tensors_hooks``: its inputs
  and the state carried into each chunk, [n_chunks, B, C, N] fp32, and
  no per-position state; ``mamba_train`` under grad saves no tensor of
  B·S·C·N elements;
* ``mamba_train``'s grads of every mixer leaf and of its input against
  the reference's, ``fuse_w13`` off and on, fp32 and bf16 (each leaf's
  grad in its own dtype: ``a_log`` and ``d_skip`` fp32, the rest in the
  compute dtype);
* ``mamba_decode`` is the serving step and refuses grad.  The ``gpu``
  case runs the scan's backward on the card against the CPU's (skipped
  without one).

Weights: the reference's ``init_model`` of Jamba's smoke config (d_model
128, 256 channels, d_state 8, d_conv 4) cut to one period, layer 0's
mixer, carried into the port by ``convert``.  Inputs and cotangents are
drawn with numpy from a seed.  Tolerances, relative L2: fp32 1e-4 (the
port's rounds associate the products in another order than XLA's
``associative_scan``), bf16 2e-2.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.base import get_smoke_config
from repro_torch.models import mamba as TMB
from repro_torch.parallel.sharding import TPContext

ARCH = "jamba_v01_52b"
F32_RTOL = 1e-4
BF16_RTOL = 2e-2
B, S = 2, 24
CHUNK = 8
SCAN_CASES = [(64, 16), (40, 16), (7, 256), (24, 8)]
SCAN_C, SCAN_N = 32, 8


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _np(t):
    return t.detach().float().cpu().numpy()


def _x(seed, shape, scale=1.0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * scale


def _scan_inputs(s):
    x = _x(1, (2, s, SCAN_C))
    dt = np.log1p(np.exp(_x(2, (2, s, SCAN_C)) - 2.0)).astype(np.float32)
    bb, cc = _x(3, (2, s, SCAN_N)), _x(4, (2, s, SCAN_N))
    a = -np.exp(_x(5, (SCAN_C, SCAN_N), 0.5))
    h0 = _x(6, (2, SCAN_C, SCAN_N))
    return [x, dt, bb, cc, a, h0]


def _chunk_of(s, chunk):
    step = min(chunk, s)
    while s % step:
        step //= 2
    return step


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _ref_scan_grad(s, step):
    """``jax.grad`` of <y, wy> + <h_final, wh> through the reference's
    chunk chained over chunks of ``step`` positions."""
    import jax
    import jax.numpy as jnp
    from repro.models.mamba import _selective_scan_chunk

    def loss(args, wy, wh):
        x, dt, bb, cc, a, h = args
        ys = []
        for i in range(0, s, step):
            sl = slice(i, i + step)
            y, h = _selective_scan_chunk(x[:, sl], dt[:, sl], bb[:, sl],
                                         cc[:, sl], a, h)
            ys.append(y)
        return (jnp.sum(jnp.concatenate(ys, 1) * wy)
                + jnp.sum(h * wh))
    return jax.jit(jax.grad(loss))


@pytest.mark.parametrize("s,chunk", SCAN_CASES)
def test_scan_grads_match_reference(s, chunk):
    args = _scan_inputs(s)
    wy, wh = _x(7, (2, s, SCAN_C)), _x(8, (2, SCAN_C, SCAN_N))
    want = _ref_scan_grad(s, _chunk_of(s, chunk))(args, wy, wh)
    ts = [torch.from_numpy(v).requires_grad_() for v in args]
    y, h = TMB.selective_scan(*ts, chunk=chunk)
    got = torch.autograd.grad(
        (y * torch.from_numpy(wy)).sum() + (h * torch.from_numpy(wh)).sum(),
        ts)
    for name, g, w in zip(("x", "dt", "b", "c", "a", "h0"), got, want):
        assert g.dtype == torch.float32
        assert _rel(_np(g), np.asarray(w)) <= F32_RTOL, (s, chunk, name)


@pytest.mark.parametrize("s,chunk", SCAN_CASES)
def test_scan_forward_under_grad_is_the_serving_scan(s, chunk):
    """The output and the final state under grad equal the serving scan's
    (the same inputs under ``no_grad``) bit for bit."""
    args = [torch.from_numpy(v) for v in _scan_inputs(s)]
    with torch.no_grad():
        y0, h0 = TMB.selective_scan(*args, chunk=chunk)
    y, h = TMB.selective_scan(*(a.clone().requires_grad_() for a in args),
                              chunk=chunk)
    assert y.requires_grad
    assert torch.equal(y.detach(), y0) and torch.equal(h.detach(), h0)


def _saved_bytes(fn):
    """(fn's result, the bytes and the shapes of every tensor autograd saved
    while it ran)."""
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, sum(t.numel() * t.element_size() for t in saved), saved


@pytest.mark.parametrize("s,chunk", [(64, 16), (40, 16)])
def test_scan_saves_no_per_position_state(s, chunk):
    """The scan saves its inputs and [n_chunks, B, C, N] fp32 carried
    states: not a multiple of B·S·C·N."""
    ts = [torch.from_numpy(v).requires_grad_() for v in _scan_inputs(s)]
    _, got, saved = _saved_bytes(
        lambda: TMB.selective_scan(*ts, chunk=chunk))
    n_chunks = s // _chunk_of(s, chunk)
    inputs = sum(t.numel() * t.element_size() for t in ts)
    assert got == inputs + n_chunks * 2 * SCAN_C * SCAN_N * 4
    assert max(t.numel() for t in saved) < 2 * s * SCAN_C * SCAN_N


# ---------------------------------------------------------------------------
# the mixer under grad
# ---------------------------------------------------------------------------
def _cfg(dtype="float32"):
    cfg = get_smoke_config(ARCH)
    return dataclasses.replace(cfg, num_layers=len(cfg.pattern),
                               compute_dtype=dtype)


@functools.lru_cache(maxsize=None)
def _weights(fuse: bool, dtype: str):
    """(the reference's layer-0 mixer tree, the port's trainable mixer)."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ParallelConfig as RPar
    from repro.configs.base import get_smoke_config as rsmoke
    from repro.models import model as RM
    rcfg = dataclasses.replace(rsmoke(ARCH), num_layers=_cfg().num_layers,
                               compute_dtype=dtype)
    tree = RM.init_model(jax.random.PRNGKey(0), rcfg,
                         RPar(tp=1, dp=1, fuse_w13=fuse),
                         dtype=getattr(jnp, dtype))
    # grads reach every leaf: a nonzero conv bias and norm scale
    rng = np.random.default_rng(21)
    mix = tree["periods"][0]["mixer"]
    for k in ("conv_b", "norm"):
        mix[k] = (mix[k] + 0.1 * rng.standard_normal(mix[k].shape)
                  ).astype(mix[k].dtype)
    np_tree = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    port = convert.params_from_jax(np_tree, _cfg(dtype),
                                   dtype=getattr(torch, dtype), device="cpu",
                                   trainable=True)
    ref = jax.tree.map(lambda a: a[0], mix)
    return ref, port.layers[0].mixer


@functools.lru_cache(maxsize=None)
def _ref_grad(dtype: str):
    """``jax.grad`` of <mamba_train(p, x), w> for (p, x), jitted."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_smoke_config as rsmoke
    from repro.models import mamba as RMB
    from repro.parallel.sharding import TPContext as RCtx
    rcfg = dataclasses.replace(rsmoke(ARCH), compute_dtype=dtype)

    def loss(p, x, w):
        out = RMB.mamba_train(p, x, RCtx(), rcfg, chunk=CHUNK)
        return jnp.sum(out.astype(jnp.float32) * w)
    return jax.jit(jax.grad(loss, argnums=(0, 1)))


@pytest.mark.parametrize("dtype,rtol", [("float32", F32_RTOL),
                                        ("bfloat16", BF16_RTOL)])
@pytest.mark.parametrize("fuse", [False, True])
def test_mamba_train_grads_match_reference(fuse, dtype, rtol):
    """Every mixer leaf's grad and the input's, in their own dtypes, over
    3 chunks of the sequence."""
    import jax.numpy as jnp
    cfg = _cfg(dtype)
    ref, mixer = _weights(fuse, dtype)
    x = _x(30, (B, S, cfg.d_model))
    w = _x(31, (B, S, cfg.d_model))
    gp, gx = _ref_grad(dtype)(ref, jnp.asarray(x, dtype), jnp.asarray(w))
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    for t in mixer.values():
        t.grad = None
    out = TMB.mamba_train(mixer, xt, TPContext(), cfg, chunk=CHUNK)
    (out.float() * torch.from_numpy(w)).sum().backward()
    assert xt.grad.dtype == tdt
    assert _rel(_np(xt.grad), np.asarray(gx, np.float32)) <= rtol
    assert sorted(mixer) == sorted(gp)
    for k, t in mixer.items():
        want = gp[k]
        assert str(t.grad.dtype)[6:] == str(want.dtype), k
        assert _rel(_np(t.grad), np.asarray(want, np.float32)) <= rtol, k


def test_mamba_train_saves_no_per_position_state():
    """Under grad the whole mixer saves no tensor of B·S·C·N elements (the
    scan's per-position states are recomputed in its backward)."""
    cfg = _cfg()
    _, mixer = _weights(False, "float32")
    xt = torch.from_numpy(_x(32, (B, S, cfg.d_model))).requires_grad_()
    out, _, saved = _saved_bytes(
        lambda: TMB.mamba_train(mixer, xt, TPContext(), cfg, chunk=CHUNK))
    c = mixer["w_in_x"].shape[1]
    assert max(t.numel() for t in saved) < B * S * c * cfg.mamba.d_state
    out.sum().backward()
    assert all(t.grad is not None for t in mixer.values())
    for t in mixer.values():
        t.grad = None


def test_mamba_decode_refuses_grad():
    """The serving step runs forward only, as the reference's."""
    cfg = _cfg()
    _, mixer = _weights(False, "float32")
    shapes = TMB.mamba_cache_shapes(cfg, 1, 1)
    cache = {k: torch.zeros(sh, dtype=torch.float32)
             for k, (sh, _) in shapes.items()}
    x = torch.zeros(1, 1, cfg.d_model, requires_grad=True)
    with pytest.raises(NotImplementedError, match="forward only"):
        TMB.mamba_decode(mixer, x, cache, torch.zeros(1, dtype=torch.long),
                         TPContext(), cfg)
    with torch.no_grad():
        out, _ = TMB.mamba_decode(mixer, x, cache,
                                  torch.zeros(1, dtype=torch.long),
                                  TPContext(), cfg)
    assert out.shape == (1, 1, cfg.d_model)


@pytest.mark.gpu
def test_gpu_scan_grads_match_cpu():
    """The scan's backward on the card (plain PyTorch, as on the CPU)
    against the CPU's, over 4 chunks of 128 at 256 channels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = [torch.from_numpy(v) for v in (
        _x(1, (2, 512, 256)), np.abs(_x(2, (2, 512, 256), 0.05)),
        _x(3, (2, 512, 16)), _x(4, (2, 512, 16)),
        -np.exp(_x(5, (256, 16), 0.5)), _x(6, (2, 256, 16)))]
    wy, wh = _x(7, (2, 512, 256)), _x(8, (2, 256, 16))
    got = []
    for dev in ("cpu", "cuda"):
        ts = [a.to(dev).requires_grad_() for a in args]
        y, h = TMB.selective_scan(*ts, chunk=128)
        got.append(torch.autograd.grad(
            (y * torch.from_numpy(wy).to(dev)).sum()
            + (h * torch.from_numpy(wh).to(dev)).sum(), ts))
    for name, gc, gg in zip(("x", "dt", "b", "c", "a", "h0"), *got):
        assert _rel(_np(gg), _np(gc)) <= F32_RTOL, name

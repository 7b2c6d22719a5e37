"""DeepSeek-V3's modules in the port against the reference, fp32.

On the deepseek_v3_671b SMOKE_CONFIG (2 layers: one leading MLA + dense
FFN, one MLA + MoE; fp32 compute and params) the reference's own init
crosses with ``convert.params_from_jax`` and the same numpy inputs go
through ``repro`` and ``repro_torch``:

* MLA: ``mla_train(with_cache=True)``, ``mla_decode`` and
  ``mla_decode_paged`` with ``use_kernels`` off and on (the reference runs
  its Pallas kernel interpreted; the port's wrapper runs its plain version
  on CPU tensors), ``mla_prefill_chunk``;
* MoE: ``moe_train`` with and without pad ``lengths`` and with capacity
  drops, ``moe_decode``, and ``FusedOp(kind="a2a")`` at ep=1.

Outputs within 1e-4 (fp32 chains of GEMMs, softmax and norms summed in
another order); aux losses within 1e-5; bf16 cache rows within 2e-2 (one
bf16 ulp at |x| ~ 2-4 when the fp32 values round to neighbours).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ParallelConfig as JaxPar
from repro.configs.base import get_smoke_config as jax_smoke
from repro.core import overlap as jov
from repro.models import attention as ja
from repro.models import ffn as jf
from repro.models import model as JM
from repro.parallel.sharding import TPContext as JaxCtx
from repro_torch import convert
from repro_torch.configs.base import (MAMBA, RWKV, ParallelConfig,
                                      get_smoke_config)
from repro_torch.core import overlap as tov
from repro_torch.kernels import mla_decode as md
from repro_torch.models import attention as ta
from repro_torch.models import ffn as tf
from repro_torch.models import model as TM
from repro_torch.parallel.sharding import TPContext, make_ctx

ARCH = "deepseek_v3_671b"
TOL = 1e-4
CACHE_TOL = 2e-2
RNG = np.random.default_rng(0)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jax_smoke(ARCH), compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(ARCH),
                               compute_dtype="float32")
    jparams = JM.init_model(jax.random.PRNGKey(0), jcfg, JaxPar(tp=1, dp=1),
                            dtype=jnp.float32)
    tparams = convert.params_from_jax(_np(jparams), tcfg,
                                      dtype=torch.float32, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _mla(model):
    """(reference, port) parameters of the leading layer's MLA."""
    _, _, jparams, tparams = model
    return jparams["lead"][0]["mixer"], tparams.layers[0].mixer


def _moe(model):
    """(reference, port) parameters of the MoE layer (the first period)."""
    _, _, jparams, tparams = model
    jp = jax.tree.map(lambda a: a[0], jparams["periods"][0]["ffn"])
    return jp, tparams.layers[1].ffn


def _x(*shape):
    return RNG.standard_normal(shape, dtype=np.float32)


def _bf16(a):
    """bf16-representable copy (the caches are bf16 on both sides)."""
    return torch.from_numpy(a).bfloat16().float().numpy()


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------
def test_config_matches_reference():
    from repro.configs import base as jb
    from repro_torch.configs import base as tb
    for getter in ("get_config", "get_smoke_config"):
        jc = getattr(jb, getter)(ARCH)
        tc = getattr(tb, getter)(ARCH)
        for f in dataclasses.fields(tc):
            got, want = getattr(tc, f.name), getattr(jc, f.name)
            if dataclasses.is_dataclass(got):
                got, want = dataclasses.asdict(got), dataclasses.asdict(want)
            assert got == want, (getter, f.name)


def test_port_init_has_the_converted_layout(model):
    """The port's own seeded init and the converted reference params have
    the same leaves (names, shapes); bf16 models keep the router fp32."""
    jcfg, tcfg, jparams, _ = model
    conv = convert.params_from_jax(_np(jparams), tcfg, dtype=torch.bfloat16,
                                   device="cpu")
    own = TM.init_model(tcfg, ParallelConfig(), seed=0, dtype=torch.bfloat16,
                        device="cpu")
    got = {n: (tuple(p.shape), p.dtype) for n, p in own.named_parameters()}
    assert got == {n: (tuple(p.shape), p.dtype)
                   for n, p in conv.named_parameters()}
    assert got["layers.1.ffn.router"][1] == torch.float32
    assert got["layers.1.ffn.w1"][1] == torch.bfloat16
    assert "layers.1.ffn.shared.w2" in got          # nested shared expert


def test_check_ported_kinds():
    TM.check_ported(get_smoke_config(ARCH))
    # Mamba is ported; so is RWKV-6 as the reference pairs it, its
    # time-mix with its channel-mix, and no other way
    hybrid = dataclasses.replace(get_smoke_config("minicpm_2b"),
                                 pattern=(("attn", "ffn"), (MAMBA, "ffn")))
    TM.check_ported(hybrid)
    TM.check_ported(dataclasses.replace(hybrid, pattern=((RWKV, RWKV),)))
    rwkv = dataclasses.replace(hybrid, pattern=(("attn", "ffn"),
                                                (RWKV, "ffn")))
    with pytest.raises(NotImplementedError, match="not ported"):
        TM.check_ported(rwkv)


def test_ep_gt_1_raises_naming_roadmap():
    """A context at ep>1 needs the "ep" axis of a mesh (the trainer's or
    the Server's): without one it raises, naming the mesh (serving at
    ep>1 is ported: ``tests/test_torch_mesh_serve.py``); with one, its
    experts' group is the mesh's "ep" sub-group.  ``init_model`` at ep=2
    draws the same global weights as at ep=1 (a mesh rank takes its
    experts with ``model.mesh_shard``)."""
    with pytest.raises(ValueError, match="make_mesh"):
        TPContext(ep=2)
    with pytest.raises(ValueError, match="make_mesh"):
        make_ctx(ParallelConfig(ep=4))
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(1, 1, 1, "cpu", ep=2)
    ctx = make_ctx(ParallelConfig(ep=2), mesh=mesh, rank=1)
    assert ctx.ep_axis is mesh.group("ep", 1) and ctx.ep_size == 2
    a = TM.init_model(get_smoke_config(ARCH), ParallelConfig(ep=2),
                      device="cpu")
    b = TM.init_model(get_smoke_config(ARCH), ParallelConfig(), device="cpu")
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def test_blocked_attention_with_distinct_v_dim():
    """MLA attends with qk dim (nope + rope) and a smaller v dim."""
    q, k = _x(2, 4, 24, 48), _x(2, 4, 24, 48)
    v = _x(2, 4, 24, 32)
    want = ja.blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), scale=48 ** -0.5)
    got = ta.blocked_attention(_t(q), _t(k), _t(v), scale=48 ** -0.5)
    assert got.shape == (2, 4, 24, 32)
    _close(got, want, 2e-5)


def test_mla_train_with_cache(model):
    jcfg, tcfg, _, _ = model
    jp, tp = _mla(model)
    x = _x(2, 16, jcfg.d_model)
    want, wcache = ja.mla_train(jp, jnp.asarray(x), JaxCtx(), jcfg,
                                with_cache=True)
    got, gcache = ta.mla_train(tp, _t(x), TPContext(), tcfg, with_cache=True)
    _close(got, want)
    assert gcache.keys() == wcache.keys() == {"c", "kr"}
    for n in gcache:
        assert gcache[n].dtype == torch.bfloat16
        _close(gcache[n], wcache[n], CACHE_TOL)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_mla_decode(model, use_kernels):
    jcfg, tcfg, _, _ = model
    jp, tp = _mla(model)
    m = jcfg.mla
    cache = {"c": _bf16(_x(2, 64, m.kv_lora_rank)),
             "kr": _bf16(_x(2, 64, m.qk_rope_head_dim))}
    x, pos = _x(2, 1, jcfg.d_model), np.array([10, 40], np.int32)
    want, wc = ja.mla_decode(
        jp, jnp.asarray(x),
        {n: jnp.asarray(a, jnp.bfloat16) for n, a in cache.items()},
        jnp.asarray(pos), JaxCtx(use_kernels=use_kernels), jcfg)
    before = md.mla_decode_attention.launches
    got, gc = ta.mla_decode(
        tp, _t(x), {n: _t(a).bfloat16() for n, a in cache.items()},
        torch.from_numpy(pos), TPContext(use_kernels=use_kernels), tcfg)
    assert md.mla_decode_attention.launches == before   # CPU: plain version
    _close(got, want)
    for n in gc:
        _close(gc[n], wc[n], CACHE_TOL)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_mla_decode_paged(model, use_kernels):
    jcfg, tcfg, _, _ = model
    jp, tp = _mla(model)
    m = jcfg.mla
    pool = {"c": _bf16(_x(9, 8, m.kv_lora_rank)),
            "kr": _bf16(_x(9, 8, m.qk_rope_head_dim))}
    bt = np.array([[3, 5, 7, 1, 0, 0], [2, 4, 6, 8, 0, 0]], np.int32)
    x, pos = _x(2, 1, jcfg.d_model), np.array([5, 30], np.int32)
    want, wc = ja.mla_decode_paged(
        jp, jnp.asarray(x),
        {n: jnp.asarray(a, jnp.bfloat16) for n, a in pool.items()},
        jnp.asarray(bt), jnp.asarray(pos), JaxCtx(use_kernels=use_kernels),
        jcfg)
    got, gc = ta.mla_decode_paged(
        tp, _t(x), {n: _t(a).bfloat16() for n, a in pool.items()},
        torch.from_numpy(bt), torch.from_numpy(pos),
        TPContext(use_kernels=use_kernels), tcfg)
    _close(got, want)
    for n in gc:
        _close(gc[n], wc[n], CACHE_TOL)


def test_mla_prefill_chunk(model):
    jcfg, tcfg, _, _ = model
    jp, tp = _mla(model)
    m = jcfg.mla
    pool = {"c": _bf16(_x(9, 4, m.kv_lora_rank)),
            "kr": _bf16(_x(9, 4, m.qk_rope_head_dim))}
    bt = np.array([[6, 2, 8, 5, 0]], np.int32)
    x = _x(1, 8, jcfg.d_model)            # a chunk of 8 rows, 5 real
    want, wc = ja.mla_prefill_chunk(
        jp, jnp.asarray(x),
        {n: jnp.asarray(a, jnp.bfloat16) for n, a in pool.items()},
        jnp.asarray(bt), 6, 5, JaxCtx(seq_shard=False), jcfg)
    got, gc = ta.mla_prefill_chunk(
        tp, _t(x), {n: _t(a).bfloat16() for n, a in pool.items()},
        torch.from_numpy(bt), 6, 5, TPContext(seq_sharded=False), tcfg)
    _close(got, want)
    for n in gc:
        # pad rows land in the null block 0 in an unspecified order
        _close(gc[n][1:], np.asarray(wc[n], np.float32)[1:], CACHE_TOL)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["all_valid", "pad_lengths", "drops"])
def test_moe_train(model, case):
    jcfg, tcfg, _, _ = model
    jp, tp = _moe(model)
    if case == "drops":
        # cap = max(int(32 * 2 / 4 * 0.25) + 1, 4) = 5 slots against a mean
        # load of 16 a expert: most assignments drop, in arrival order
        moe = dataclasses.replace(jcfg.moe, capacity_factor=0.25)
        jcfg = dataclasses.replace(jcfg, moe=moe)
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=0.25))
        assert tf._capacity(32, tcfg.moe) == 5
    x = _x(2, 16, jcfg.d_model)
    lengths = np.array([9, 16], np.int32) if case == "pad_lengths" else None
    want, waux = jf.moe_train(
        jp, jnp.asarray(x), JaxCtx(), jcfg,
        lengths=None if lengths is None else jnp.asarray(lengths))
    got, gaux = tf.moe_train(
        tp, _t(x), TPContext(), tcfg,
        lengths=None if lengths is None else torch.from_numpy(lengths))
    _close(got, want)
    np.testing.assert_allclose(float(gaux), float(waux), atol=1e-5,
                               rtol=1e-5)


def test_moe_pads_take_no_capacity(model):
    """A pad token's routing must not evict a real token: the real rows'
    output is the same whatever the pads hold."""
    jcfg, tcfg, _, _ = model
    _, tp = _moe(model)
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=0.25))
    x = _x(2, 16, jcfg.d_model)
    x2 = x.copy()
    x2[0, 9:] = _x(7, jcfg.d_model)
    lengths = torch.tensor([9, 16])
    a, _ = tf.moe_train(tp, _t(x), TPContext(), tcfg, lengths=lengths)
    b, _ = tf.moe_train(tp, _t(x2), TPContext(), tcfg, lengths=lengths)
    torch.testing.assert_close(a[0, :9], b[0, :9], atol=0, rtol=0)
    torch.testing.assert_close(a[1], b[1], atol=0, rtol=0)


def test_moe_decode(model):
    jcfg, tcfg, _, _ = model
    jp, tp = _moe(model)
    x = _x(3, 1, jcfg.d_model)
    want = jf.moe_decode(jp, jnp.asarray(x), JaxCtx(), jcfg)
    got = tf.moe_decode(tp, _t(x), TPContext(), tcfg)
    _close(got, want)


def test_fused_a2a_at_ep_1(model):
    """``ctx.op("moe_a2a")``: at ep=1 the local batched expert SwiGLU."""
    buf = _x(1, 4, 6, 32)
    w1, w3 = _x(4, 32, 16), _x(4, 32, 16)
    w2 = _x(4, 16, 32)
    epi = dict(activation="silu", gate="pair")
    jop = jov.FusedOp(kind="a2a", axis=(), epilogue=jov.Epilogue(**epi),
                      n_weights=3)
    want = jop(*map(jnp.asarray, (buf, w1, w3, w2)))
    top = TPContext().op("moe_a2a", epilogue=tov.Epilogue(**epi), n_weights=3)
    assert top.kind == "a2a"
    _close(top(*map(_t, (buf, w1, w3, w2))), want, 1e-5)


def test_fused_a2a_validation():
    with pytest.raises(ValueError, match="triple"):
        tov.FusedOp("a2a", tov.Epilogue(activation="silu", gate="pair"), 2)
    with pytest.raises(ValueError, match="pure"):
        tov.FusedOp("a2a", tov.Epilogue(activation="silu", gate="pair",
                                        bias=True), 3)
    with pytest.raises(ValueError, match="pure"):
        tov.FusedOp("a2a", tov.Epilogue(activation="silu"), 3)

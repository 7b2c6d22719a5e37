"""The port's layers and seam epilogues against the reference's, fp32.

Same numpy inputs through ``repro.models.layers`` / ``repro.core.overlap``
and their ``repro_torch`` counterparts.  Data movement (cache writes,
gathers) must match exactly; elementwise arithmetic within 1e-6 (fp32
rounding of reordered math); seams, which include a GEMM, within 1e-5
(fp32 dot products summed in another order).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import overlap as jov
from repro.models import layers as jl
from repro.parallel.sharding import TPContext as JaxCtx
from repro_torch.core import overlap as tov
from repro_torch.models import layers as tl
from repro_torch.parallel.sharding import TPContext

TOL = 1e-6
RNG = np.random.default_rng(0)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_rms_norm():
    x = RNG.standard_normal((2, 5, 64), dtype=np.float32) * 3
    g = RNG.standard_normal((64,), dtype=np.float32)
    want = np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-5))
    got = tl.rms_norm(_t(x), _t(g), 1e-5).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_rms_norm_casts_before_gamma():
    """bf16 input: normalise in fp32, cast to bf16, THEN scale by gamma."""
    x = RNG.standard_normal((3, 32), dtype=np.float32)
    g = RNG.standard_normal((32,), dtype=np.float32)
    want = np.asarray(jl.rms_norm(jnp.asarray(x, jnp.bfloat16),
                                  jnp.asarray(g, jnp.bfloat16)
                                  ).astype(jnp.float32))
    got = tl.rms_norm(_t(x).bfloat16(), _t(g).bfloat16()).float().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_apply_rope(theta):
    x = RNG.standard_normal((2, 7, 3, 32), dtype=np.float32)
    pos = RNG.integers(0, 4096, (2, 7)).astype(np.int32)
    want = np.asarray(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = tl.apply_rope(_t(x), _t(pos), theta).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_rope_freqs():
    want = np.asarray(jl.rope_freqs(64, 10000.0))
    np.testing.assert_allclose(tl.rope_freqs(64, 10000.0).numpy(), want,
                               atol=0, rtol=TOL)


@pytest.mark.parametrize("epi,n_w", [
    (dict(bias=True), 1),
    (dict(activation="silu", gate="pair"), 2),
    (dict(activation="silu", gate="split"), 1),
    (dict(bias=True, activation="gelu"), 1),
    (dict(scale=True, bias=True, activation="sqrelu", residual=True), 1),
])
def test_epilogue_matches_reference(epi, n_w):
    x = RNG.standard_normal((2, 6, 16), dtype=np.float32)
    ws = [RNG.standard_normal((16, 24), dtype=np.float32) for _ in range(n_w)]
    ops = {}
    if epi.get("bias"):
        ops["bias"] = RNG.standard_normal((24,), dtype=np.float32)
    if epi.get("scale"):
        ops["scale"] = RNG.standard_normal((24,), dtype=np.float32)
    if epi.get("residual"):
        ops["residual"] = RNG.standard_normal((2, 6, 24), dtype=np.float32)
    jop = jov.FusedOp(kind="ag", epilogue=jov.Epilogue(**epi), n_weights=n_w)
    want = np.asarray(jop(jnp.asarray(x), *map(jnp.asarray, ws),
                          **{k: jnp.asarray(v) for k, v in ops.items()}))
    top = TPContext().op("mlp_ag", epilogue=tov.Epilogue(**epi), n_weights=n_w)
    got = top(_t(x), *map(_t, ws), **{k: _t(v) for k, v in ops.items()})
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("seam", ["attn_rs", "mlp_rs", "decode_ar"])
def test_row_parallel_seams_are_local_gemms(seam):
    y = RNG.standard_normal((2, 4, 32), dtype=np.float32)
    w = RNG.standard_normal((32, 16), dtype=np.float32)
    got = TPContext().op(seam)(_t(y), _t(w)).numpy()
    np.testing.assert_allclose(got, y @ w, atol=1e-5, rtol=1e-5)


def test_multi_weight_identity_returns_tuple():
    x = _t(RNG.standard_normal((1, 3, 8), dtype=np.float32))
    w1, w2 = (_t(RNG.standard_normal((8, 4), dtype=np.float32))
              for _ in range(2))
    out = TPContext().op("attn_ag", n_weights=2)(x, w1, w2)
    assert isinstance(out, tuple) and len(out) == 2
    torch.testing.assert_close(out[1], x @ w2)


def test_tp_gt_1_raises_naming_roadmap():
    """tp>1 runs only as the ranks of a RankGroup of size tp; ep>1 only on
    the "ep" axis of a RankMesh.  The replicated (decode) layout's
    ``decode_ar`` seam under grad
    needs the rank's SeamTape, like every seam; on one its backward runs
    (the cotangent's psum, then the local GEMMs)."""
    from repro_torch.core.overlap import SeamTape
    from repro_torch.dist import RankGroup, RankGroupError
    for tp in (2, 4):
        with pytest.raises(ValueError, match="ROADMAP"):
            TPContext(tp=tp)
    group = RankGroup(4, "cpu")
    with pytest.raises(ValueError, match="ROADMAP"):
        TPContext(tp=2, group=group)
    with pytest.raises(ValueError, match="RankMesh"):
        TPContext(tp=4, ep=2, group=group)
    ctx = TPContext(tp=4, group=group).with_layout(False)
    assert ctx.op("mlp_ag").scatter_axis == "hidden"
    op = ctx.op("decode_ar")

    def under_grad():
        op(torch.ones((1, 1, 8)), torch.ones((8, 4), requires_grad=True))

    with pytest.raises(RankGroupError) as err:
        group.spmd(under_grad, [()] * 4)
    assert "SeamTape" in str(err.value.__cause__)

    def on_tape(r):
        w = torch.ones((8, 4), requires_grad=True)
        with SeamTape() as tape:
            y = op(torch.full((1, 1, 8), r + 1.0), w)
        tape.backward(y.sum())
        return y.detach(), w.grad

    for r, (y, dw) in enumerate(group.spmd(on_tape, [(r,) for r in range(4)])):
        # y = sum over ranks of 8 (r + 1) = 80; each rank's cotangent of
        # ones sums to 4 over the ranks, so dW = x^T 4 = 4 (r + 1)
        assert torch.equal(y, torch.full((1, 1, 4), 80.0))
        assert torch.equal(dw, torch.full((8, 4), 4.0 * (r + 1)))


def test_embed_lookup():
    table = RNG.standard_normal((640, 16), dtype=np.float32)
    toks = RNG.integers(0, 700, (2, 9)).astype(np.int32)   # some past V
    want = np.asarray(jl.embed_lookup(jnp.asarray(table), jnp.asarray(toks),
                                      JaxCtx(), 640))
    got = tl.embed_lookup(_t(table), _t(toks)).numpy()
    np.testing.assert_array_equal(got, want)


def test_cache_update_rows_clamps_like_dynamic_update_slice():
    cache = RNG.standard_normal((3, 10, 2, 4), dtype=np.float32)
    new = RNG.standard_normal((3, 2, 2, 4), dtype=np.float32)
    pos = np.array([0, 4, 9], np.int32)          # 9 + 2 > 10: clamps to 8
    want = np.asarray(jl.cache_update_rows(jnp.asarray(cache),
                                           jnp.asarray(new), jnp.asarray(pos)))
    got = tl.cache_update_rows(_t(cache.copy()), _t(new), _t(pos)).numpy()
    np.testing.assert_array_equal(got, want)


def test_pool_update_rows_view_and_take_rows():
    nb, bs, p = 9, 4, 3
    pool = RNG.standard_normal((nb, bs, 2, 8), dtype=np.float32)
    bt = np.array([[3, 5, 7], [1, 2, 0], [0, 0, 0]], np.int32)
    new = RNG.standard_normal((3, 5, 2, 8), dtype=np.float32)
    start = np.array([2, 0, 0], np.int32)
    valid = np.array([5, 3, 0], np.int32)      # pad rows -> null block 0
    want = np.asarray(jl.pool_update_rows(
        jnp.asarray(pool), jnp.asarray(new), jnp.asarray(bt),
        jnp.asarray(start), valid=jnp.asarray(valid)))
    got = tl.pool_update_rows(_t(pool.copy()), _t(new), _t(bt), _t(start),
                              valid=_t(valid)).numpy()
    # block 0 receives duplicate pad writes (order unspecified, never read
    # unmasked); every real block must match exactly
    np.testing.assert_array_equal(got[1:], want[1:])

    want_view = np.asarray(jl.pool_view(jnp.asarray(want), jnp.asarray(bt)))
    got_view = tl.pool_view(_t(want), _t(bt)).numpy()
    np.testing.assert_array_equal(got_view, want_view)

    idx = np.array([3, 11, 40], np.int32)      # 40 is past P*bs: clamps
    np.testing.assert_array_equal(
        tl.take_rows(_t(want_view), _t(idx)).numpy(),
        np.asarray(jl.take_rows(jnp.asarray(want_view), jnp.asarray(idx))))


def test_configs_match_reference():
    from repro.configs import base as jb
    from repro_torch.configs import base as tb
    for arch in ("minicpm_2b", "codeqwen15_7b"):
        for getter in ("get_config", "get_smoke_config"):
            jc = getattr(jb, getter)(arch)
            tc = getattr(tb, getter)(arch)
            for f in dataclasses.fields(tc):
                assert getattr(tc, f.name) == getattr(jc, f.name), \
                    (arch, getter, f.name)

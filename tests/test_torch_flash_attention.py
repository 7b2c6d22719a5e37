"""The port's flash-attention module against the reference's Pallas kernel.

The plain PyTorch version (what the wrapper runs for CPU tensors) is held
against ``repro.kernels.flash_attention.flash_attention`` in interpret mode
on the same numpy inputs, fp32, atol = rtol = 2e-5 (the reference's own
kernel-vs-oracle tolerance in tests/test_kernels.py).  The CUDA kernel is
held against the plain version by the ``gpu``-marked test, which runs only
where a card is present.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa

TOL = 2e-5


def _inputs(b, hq, hkv, sq, skv, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, skv, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, skv, d), dtype=np.float32)
    return q, k, v


def _both(q, k, v, **kw):
    # JAX is imported here, not at the top: the machine with the card has
    # no JAX, and runs this file's gpu-marked tests alone
    import jax.numpy as jnp
    from repro.kernels.flash_attention import flash_attention as jax_flash
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                bq=128, bkv=128, interpret=True, **kw))
    got = fa.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), **kw).numpy()
    return got, want


# the four shapes of tests/test_kernels.py::test_flash_attention
@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (2, 4, 2, 256, 64), (1, 8, 8, 512, 32), (1, 4, 1, 128, 64),
    (2, 2, 2, 384, 128),
])
def test_plain_matches_reference_kernel(b, hq, hkv, s, d):
    got, want = _both(*_inputs(b, hq, hkv, s, s, d), causal=True)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_plain_matches_reference_kernel_noncausal():
    got, want = _both(*_inputs(1, 2, 2, 256, 256, 64, seed=1), causal=False)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_plain_matches_reference_kernel_kv_offset():
    """q is the 128-row suffix of a 384-row kv timeline (chunked prefill)."""
    got, want = _both(*_inputs(1, 4, 2, 128, 384, 64, seed=2), causal=True,
                      kv_offset=256)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_wrapper_on_cpu_takes_plain_path():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 64, 64, 32))
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=True)
    assert fa.flash_attention.launches == before
    torch.testing.assert_close(out, fa.flash_attention_ref(q, k, v),
                               atol=0, rtol=0)


def test_wrapper_rejects_mismatched_inputs():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 3, 64, 64, 32))
    with pytest.raises(ValueError, match="multiple of Hkv"):
        fa.flash_attention(q, k, v)
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 64, 64, 32))
    with pytest.raises(ValueError, match="dtypes"):
        fa.flash_attention(q.half(), k.half(), v.half())


# ---------------------------------------------------------------------------
# the bf16 kernel's CTA numbering and work per query tile (host arithmetic)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sq", [1, 63, 128, 129, 1000, 1024])
@pytest.mark.parametrize("bh", [1, 3, 144])
@pytest.mark.parametrize("causal", [True, False])
def test_block_order_each_tile_once_heaviest_first(sq, bh, causal):
    order = fa.block_order(sq, bh, causal)
    n_qt = -(-sq // fa.BLOCK_Q)
    assert sorted(order) == [(qi, h) for qi in range(n_qt)
                             for h in range(bh)]
    for d in fa.HEAD_DIMS:
        for off in (0, 300):
            work = [fa.kv_tiles(qi, sq, sq + off, d, causal, off)
                    for qi, _ in order]
            assert work == sorted(work, reverse=True)


@pytest.mark.parametrize("sq,skv,off", [(1, 1, 0), (63, 63, 0),
                                        (65, 65, 0), (129, 129, 0),
                                        (1000, 1000, 0), (256, 1024, 768),
                                        (70, 300, 230), (1, 1000, 999)])
@pytest.mark.parametrize("d", [64, 128])
def test_kv_tiles_cover_exactly_the_attended_keys(sq, skv, off, d):
    """Causal: a query tile reads every kv tile holding a key that one of
    its valid rows attends, and no tile beyond; not causal: every tile."""
    bkv = fa.block_kv(d)
    for qi in range(-(-sq // fa.BLOCK_Q)):
        last_row = min((qi + 1) * fa.BLOCK_Q, sq) - 1
        last_key = min(skv - 1, off + last_row)
        assert fa.kv_tiles(qi, sq, skv, d, True, off) == last_key // bkv + 1
        assert fa.kv_tiles(qi, sq, skv, d, False, off) == -(-skv // bkv)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d,hq,hkv,sq,skv,causal,kv_offset", [
    (torch.bfloat16, 64, 36, 36, 200, 200, True, 0),
    (torch.bfloat16, 128, 8, 2, 130, 130, True, 0),
    (torch.bfloat16, 64, 4, 4, 70, 300, True, 230),
    (torch.float32, 64, 4, 4, 100, 100, False, 0),
    (torch.float32, 128, 4, 1, 96, 96, True, 0),
])
def test_cuda_kernel_matches_plain(dtype, d, hq, hkv, sq, skv, causal,
                                   kv_offset):
    """Kernel vs plain version on the card: bf16 atol/rtol 2e-2 (bf16
    output rounding), fp32 1e-4 (summation order)."""
    _cuda_case(dtype, d, hq, hkv, sq, skv, causal, kv_offset)


EDGES = [1, 63, 64, 65, 127, 128, 129, 1000]


@pytest.mark.gpu
@pytest.mark.parametrize("s", EDGES)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_bf16_kernel_at_tile_edges(s, d, causal):
    """The bf16 kernel's tile edges (query tiles of 128 rows, kv tiles of
    128 rows at D 64 and 64 at D 128), GQA group 4, Sq = Skv."""
    _cuda_case(torch.bfloat16, d, 8, 2, s, s, causal, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("sq,skv", [(1, 1000), (63, 129), (65, 128),
                                    (129, 1000), (64, 127)])
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_bf16_kernel_kv_offset(sq, skv, d):
    """q is the Sq-row suffix of Skv keys (chunked prefill): the diagonal
    moves by kv_offset = Skv - Sq."""
    _cuda_case(torch.bfloat16, d, 8, 2, sq, skv, True, skv - sq)


def _cuda_case(dtype, d, hq, hkv, sq, skv, causal, kv_offset):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    q, k, v = (torch.from_numpy(a).to("cuda", dtype)
               for a in _inputs(2, hq, hkv, sq, skv, d, seed=3))
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=causal, kv_offset=kv_offset)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = fa.flash_attention_ref(q, k, v, causal=causal, kv_offset=kv_offset)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)

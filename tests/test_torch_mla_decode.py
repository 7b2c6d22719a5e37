"""The port's MLA-decode module against the reference's Pallas kernel.

The plain PyTorch version (what the wrapper runs for CPU tensors) is held
against ``repro.kernels.mla_decode.mla_decode_attention`` in interpret mode
and against ``repro.kernels.ref.mla_decode_attention_ref`` on the same
numpy inputs (fp32 queries, bf16 caches), atol = rtol = 2e-5: the
reference's own kernel-vs-oracle tolerance in tests/test_kernels.py.  The
CUDA kernel is held against the plain version by the ``gpu``-marked tests,
which run only where a card is present, at 1e-4 (fp32 sums in another
order over up to 32k positions of values ~1).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import mla_decode as md
from repro_torch.models import layers

TOL = 2e-5
GPU_TOL = 1e-4
SCALE = 0.1


def _inputs(b, h, r, dr, s, seed=0):
    """fp32 queries and bf16-representable caches, as numpy fp32."""
    rng = np.random.default_rng(seed)
    qe = rng.standard_normal((b, h, r), dtype=np.float32)
    qr = rng.standard_normal((b, h, dr), dtype=np.float32)
    c = torch.from_numpy(rng.standard_normal((b, s, r), dtype=np.float32))
    kr = torch.from_numpy(rng.standard_normal((b, s, dr), dtype=np.float32))
    return (qe, qr, c.bfloat16().float().numpy(),
            kr.bfloat16().float().numpy())


def _plain(qe, qr, c, kr, valid):
    return md.mla_decode_attention_ref(
        torch.from_numpy(qe), torch.from_numpy(qr),
        torch.from_numpy(c).bfloat16(), torch.from_numpy(kr).bfloat16(),
        torch.as_tensor(valid), SCALE).numpy()


def _reference(qe, qr, c, kr, valid, kernel=True):
    # JAX is imported here, not at the top: the machine with the card has
    # no JAX, and runs this file's gpu-marked tests alone
    import jax.numpy as jnp
    from repro.kernels import ref
    from repro.kernels.mla_decode import mla_decode_attention
    args = (jnp.asarray(qe), jnp.asarray(qr), jnp.asarray(c, jnp.bfloat16),
            jnp.asarray(kr, jnp.bfloat16), jnp.asarray(valid, jnp.int32))
    if kernel:
        return np.asarray(mla_decode_attention(*args, scale=SCALE, bs=128,
                                               interpret=True))
    return np.asarray(ref.mla_decode_attention_ref(*args, SCALE))


# the cases of tests/test_kernels.py::test_mla_decode_kernel
@pytest.mark.parametrize("b,h,r,dr,s,valid", [
    (2, 4, 64, 16, 256, 200), (1, 8, 128, 32, 512, 512),
    (2, 2, 32, 8, 128, 1),
])
def test_plain_matches_reference_kernel(b, h, r, dr, s, valid):
    args = _inputs(b, h, r, dr, s)
    got = _plain(*args, valid)
    np.testing.assert_allclose(got, _reference(*args, valid), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(got, _reference(*args, valid, kernel=False),
                               atol=TOL, rtol=TOL)


def test_plain_matches_reference_kernel_per_row_lengths():
    """tests/test_kernels.py::test_mla_decode_kernel_per_row_lengths: each
    batch row masks at its own valid length."""
    args = _inputs(3, 4, 64, 16, 256, seed=1)
    valid = np.array([17, 200, 256], np.int32)
    got = _plain(*args, valid)
    np.testing.assert_allclose(got, _reference(*args, valid), atol=TOL,
                               rtol=TOL)
    for i in range(3):
        solo = _plain(*(a[i:i + 1] for a in args), valid[i:i + 1])
        np.testing.assert_allclose(got[i:i + 1], solo, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("valid", [[1, 77], [0, 40], [90, 77]])
def test_plain_matches_reference_ragged_and_edge_lengths(valid):
    """Any S (77 is no tile multiple); a valid length of 0 softmaxes
    uniformly over all -1e30 scores (the mean of the cache), and one past
    S attends to every row — the semantics the CUDA kernel reproduces."""
    args = _inputs(2, 3, 32, 8, 77, seed=2)
    valid = np.array(valid, np.int32)
    np.testing.assert_allclose(_plain(*args, valid),
                               _reference(*args, valid, kernel=False),
                               atol=TOL, rtol=TOL)


def test_wrapper_on_cpu_takes_plain_path():
    qe, qr, c, kr = (torch.from_numpy(a) for a in _inputs(2, 4, 64, 16, 40))
    c, kr = c.bfloat16(), kr.bfloat16()
    before = md.mla_decode_attention.launches
    out = md.mla_decode_attention(qe, qr, c, kr, 30, scale=SCALE)
    assert md.mla_decode_attention.launches == before
    assert out.dtype == torch.float32 and out.shape == (2, 4, 64)
    torch.testing.assert_close(
        out, md.mla_decode_attention_ref(qe, qr, c, kr, 30, SCALE),
        atol=0, rtol=0)


def test_wrapper_rejects_mismatched_shapes():
    qe, qr, c, kr = (torch.from_numpy(a) for a in _inputs(2, 4, 64, 16, 40))
    with pytest.raises(ValueError, match="do not agree"):
        md.mla_decode_attention(qe, qr, c[:, :, :32], kr, 5, scale=SCALE)
    with pytest.raises(ValueError, match="takes q_eff"):
        md.mla_decode_attention(qe[0], qr, c, kr, 5, scale=SCALE)


# ---------------------------------------------------------------------------
# the CUDA kernel on the card
# ---------------------------------------------------------------------------
def _cuda_inputs(b, h, r, dr, s, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    return (randn(b, h, r), randn(b, h, dr), randn(b, s, r).bfloat16(),
            randn(b, s, dr).bfloat16())


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,r,dr,s,valid", [
    (4, 128, 512, 64, 1041, [257, 513, 778, 1025]),   # the lane's shape
    (2, 16, 512, 64, 300, [1, 300]),
    (3, 20, 512, 64, 777, [0, 5, 900]),    # heads % 8, empty and past-S rows
    (1, 8, 512, 64, 33, [33]),
    (2, 128, 512, 64, 4100, [4100, 31]),
])
def test_cuda_kernel_matches_plain(b, h, r, dr, s, valid):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    qe, qr, c, kr = _cuda_inputs(b, h, r, dr, s, seed=s)
    vl = torch.tensor(valid, device="cuda")
    before = md.mla_decode_attention.launches
    out = md.mla_decode_attention(qe, qr, c, kr, vl, scale=SCALE)
    torch.cuda.synchronize()
    assert md.mla_decode_attention.launches == before + 1
    want = md.mla_decode_attention_ref(qe, qr, c, kr, vl, SCALE)
    torch.testing.assert_close(out, want, atol=GPU_TOL, rtol=GPU_TOL)


@pytest.mark.gpu
def test_cuda_kernel_on_paged_view():
    """The paged decode path hands the kernel ``layers.pool_view``s."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    qe, qr, _, _ = _cuda_inputs(2, 128, 512, 64, 1, seed=5)
    _, _, pc, pkr = _cuda_inputs(1, 1, 512, 64, 40 * 16, seed=6)
    pc, pkr = pc.reshape(40, 16, 512), pkr.reshape(40, 16, 64)
    bt = torch.tensor([[3, 9, 1, 30, 2], [7, 0, 0, 0, 0]], device="cuda")
    c, kr = layers.pool_view(pc, bt), layers.pool_view(pkr, bt)
    vl = torch.tensor([70, 12], device="cuda")
    out = md.mla_decode_attention(qe, qr, c, kr, vl, scale=SCALE)
    want = md.mla_decode_attention_ref(qe, qr, c, kr, vl, SCALE)
    torch.testing.assert_close(out, want, atol=GPU_TOL, rtol=GPU_TOL)


@pytest.mark.gpu
def test_cuda_wrapper_raises_on_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    qe, qr, c, kr = _cuda_inputs(2, 4, 64, 16, 40, seed=7)
    with pytest.raises(ValueError, match="latent dim"):
        md.mla_decode_attention(qe, qr, c, kr, 5, scale=SCALE)
    qe, qr, c, kr = _cuda_inputs(2, 4, 512, 64, 40, seed=8)
    with pytest.raises(ValueError, match="bfloat16"):
        md.mla_decode_attention(qe, qr, c.float(), kr, 5, scale=SCALE)
    with pytest.raises(ValueError, match="contiguous"):
        md.mla_decode_attention(qe, qr, c.transpose(0, 1).contiguous()
                                .transpose(0, 1), kr, 5, scale=SCALE)

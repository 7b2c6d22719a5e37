"""The port's MLA-decode module against the reference's Pallas kernel.

The plain PyTorch version (what the wrapper runs for CPU tensors) is held
against ``repro.kernels.mla_decode.mla_decode_attention`` in interpret mode
and against ``repro.kernels.ref.mla_decode_attention_ref`` on the same
numpy inputs (fp32 queries, bf16 caches), atol = rtol = 2e-5: the
reference's own kernel-vs-oracle tolerance in tests/test_kernels.py.  So is
the plain form of the kernel's two passes (``split_ref`` then
``combine_ref``), and the host's split plan is checked for the shapes the
kernel meets.  An fp64 emulation records why the kernel feeds both fp32
operands to the tensor cores as bf16 hi/lo pairs.  The CUDA kernel is held
against the plain version by the ``gpu``-marked tests, which run only where
a card is present, at 1e-4 (fp32 sums in another order over up to 32k
positions of values ~1).
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


LANE = (4, 128, 1041)          # the mla lane's decode: B, H, S
LONG = (8, 128, 32768)         # chip_smoke.py's long case
SMS = 132                      # the H100 SXM's streaming multiprocessors


def _check_plan(b, h, s):
    n, rows = md.split_plan(b, h, s, SMS)
    assert n >= 1 and rows > 0 and rows % md.ROW_TILE == 0
    # ranges [i * rows, (i + 1) * rows) cover [0, S), none empty of rows
    assert (n - 1) * rows < s <= n * rows
    # one wave of CTAs at most, and each split at least MIN_SPLIT_TILES
    # row tiles unless the whole cache is fewer
    ctas = b * -(-h // md.HEAD_TILE)
    assert n == 1 or n * ctas <= SMS
    assert n == 1 or rows >= md.MIN_SPLIT_TILES * md.ROW_TILE
    return n, rows


def test_split_plan_at_the_lane_and_long_shapes():
    assert _check_plan(*LANE) == (11, 96)
    assert _check_plan(*LONG) == (8, 4096)
    assert _check_plan(4, 16, 1041) == (11, 96)    # a tp 8 rank's heads
    assert _check_plan(4, 128, 1) == (1, 32)


@pytest.mark.parametrize("b", range(1, 9))
def test_split_plan_covers_every_row_once(b):
    """B 1..8 x S 1..32768: the ranges tile [0, S) exactly, from B, H and S
    alone."""
    for s in list(range(1, 300)) + [1024, 1041, 4095, 4096, 4100, 32767,
                                    32768]:
        for h in (16, 64, 65, 128):
            _check_plan(b, h, s)


@pytest.mark.parametrize("n_splits,split_rows,s", [
    (1, 256, 256), (2, 128, 256), (7, 32, 224), (16, 32, 512)])
def test_split_then_combine_matches_reference_kernel(n_splits, split_rows,
                                                     s):
    """The kernel's two passes in plain form: splits wholly past a row's
    valid length (1, 100) are empty and drop out; a row with valid length 0
    keeps every split in its mean; one past S reads all rows."""
    args = _inputs(4, 4, 64, 16, s, seed=3)
    valid = np.array([1, 0, 100, s + 7], np.int32)
    part_o, part_ml = md.split_ref(
        torch.from_numpy(args[0]), torch.from_numpy(args[1]),
        torch.from_numpy(args[2]).bfloat16(),
        torch.from_numpy(args[3]).bfloat16(), torch.from_numpy(valid),
        SCALE, n_splits, split_rows)
    empty = part_ml[..., 0] == -np.inf
    want_empty = [[i * split_rows >= (v if 0 < v <= s else s)
                   for i in range(n_splits)] for v in valid]
    assert empty.all(-1).tolist() == want_empty
    got = md.combine_ref(part_o, part_ml).numpy()
    np.testing.assert_allclose(got, _reference(*args, valid), atol=TOL,
                               rtol=TOL)


def _emulated_hilo(qe, qr, c, kr, valid, split_q):
    """The kernel's operand rounding in fp64: q as bf16 hi (+ bf16 lo), the
    softmax weights P as bf16 hi + lo, every sum exact."""
    def bf16(x):
        return torch.as_tensor(x).float().bfloat16().double()
    q = torch.from_numpy(np.concatenate([qe, qr], -1))
    q_used = bf16(q) + (bf16(q.double() - bf16(q)) if split_q else 0)
    k = torch.from_numpy(np.concatenate([c, kr], -1)).double()
    s = torch.einsum("bhk,bsk->bhs", q_used, k) * SCALE_LANE
    pos = torch.arange(k.shape[1])
    s = s.masked_fill(pos >= torch.as_tensor(valid)[:, None, None], -np.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p_used = bf16(p) + bf16(p - bf16(p))
    return (torch.einsum("bhs,bsr->bhr", p_used,
                         torch.from_numpy(c).double())
            / p.sum(-1, keepdim=True)).numpy()


SCALE_LANE = (128 + 64) ** -0.5     # deepseek_v3_671b's (nope + rope)^-0.5


def test_hilo_operands_hold_the_fp32_tolerance_and_one_bf16_rounding_does_not():
    """Why the kernel splits q (and P) into bf16 hi + lo: at the lane's
    shape the split holds the card's fp32 tolerance (1e-4) against the
    reference's plain version; q rounded to bf16 once does not."""
    import jax.numpy as jnp
    from repro.kernels import ref
    b, h, s = LANE
    qe, qr, c, kr = _inputs(b, h, 512, 64, s, seed=4)
    valid = np.array([257, 513, 778, 1025], np.int32)
    want = np.asarray(ref.mla_decode_attention_ref(
        jnp.asarray(qe), jnp.asarray(qr), jnp.asarray(c, jnp.bfloat16),
        jnp.asarray(kr, jnp.bfloat16), jnp.asarray(valid), SCALE_LANE))
    split = _emulated_hilo(qe, qr, c, kr, valid, split_q=True)
    np.testing.assert_allclose(split, want, atol=GPU_TOL, rtol=GPU_TOL)
    single = _emulated_hilo(qe, qr, c, kr, valid, split_q=False)
    assert not np.allclose(single, want, atol=GPU_TOL, rtol=GPU_TOL)
    assert np.abs(single - want).max() > 5 * np.abs(split - want).max()


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


def _sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,r,dr,s,valid", [
    (4, 128, 512, 64, 1041, [257, 513, 778, 1025]),   # the lane's shape
    (4, 32, 512, 64, 1041, [257, 513, 778, 1025]),    # a tp=4 rank's heads
    (2, 16, 512, 64, 300, [1, 300]),
    (3, 20, 512, 64, 777, [0, 5, 900]),    # heads % 8, empty and past-S rows
    (1, 8, 512, 64, 33, [33]),
    (2, 128, 512, 64, 4100, [4100, 31]),
    (2, 64, 512, 64, 500, [31, 500]),      # one head tile
    (2, 65, 512, 64, 500, [33, 0]),        # a second tile of one head
    (3, 128, 512, 64, 1, [1, 0, 7]),       # S 1
    (3, 128, 512, 64, 97, [31, 32, 33]),   # around a 32-row tile
    (3, 128, 512, 64, 200, [63, 64, 65]),  # around two tiles
    (8, 128, 512, 64, 32768, [1000] + [32768] * 7),   # the long case
])
def test_cuda_kernel_matches_plain(b, h, r, dr, s, valid):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    qe, qr, c, kr = _cuda_inputs(b, h, r, dr, s, seed=s)
    vl = torch.tensor(valid, device="cuda")
    before = md.mla_decode_attention.launches
    combines = md.mla_decode_attention.combine_launches
    out = md.mla_decode_attention(qe, qr, c, kr, vl, scale=SCALE)
    torch.cuda.synchronize()
    assert md.mla_decode_attention.launches == before + 1
    assert (md.mla_decode_attention.combine_launches - combines
            == int(md.split_plan(b, h, s, _sms())[0] > 1))
    want = md.mla_decode_attention_ref(qe, qr, c, kr, vl, SCALE)
    torch.testing.assert_close(out, want, atol=GPU_TOL, rtol=GPU_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("n_splits", [1, 2, 33])
def test_cuda_kernel_at_any_split(n_splits):
    """The lane's shape under split plans other than split_plan's: one
    split writes the output itself, 33 give every split one row tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    b, h, s = LANE
    qe, qr, c, kr = _cuda_inputs(b, h, 512, 64, s, seed=9)
    vl = torch.tensor([257, 0, 778, 1025], device="cuda")
    tiles = -(-s // md.ROW_TILE)
    per = -(-tiles // n_splits)
    plan = (-(-tiles // per), per * md.ROW_TILE)
    shipped = md.split_plan
    md.split_plan = lambda *a: plan
    try:
        out = md.mla_decode_attention(qe, qr, c, kr, vl, scale=SCALE)
    finally:
        md.split_plan = shipped
    want = md.mla_decode_attention_ref(qe, qr, c, kr, vl, SCALE)
    torch.testing.assert_close(out, want, atol=GPU_TOL, rtol=GPU_TOL)


@pytest.mark.gpu
def test_cuda_wrapper_reads_no_device_value():
    """valid_len stays on the card: the wrapper plans the launch from
    shapes alone, so a call synchronises nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    qe, qr, c, kr = _cuda_inputs(4, 128, 512, 64, 1041, seed=10)
    vl = torch.tensor([257, 513, 778, 1025], device="cuda")
    md.mla_decode_attention(qe, qr, c, kr, vl, scale=SCALE)   # built, loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = md.mla_decode_attention(qe, qr, c, kr, vl, scale=SCALE)
    finally:
        torch.cuda.set_sync_debug_mode("default")
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
def test_cuda_kernel_on_paged_view_at_the_lane_shape():
    """16-row blocks scattered over a shuffled pool, 66 a row (S 1056),
    as the Server holds them: split over S and combined."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    b, h, s = 4, 128, 66 * 16
    qe, qr, _, _ = _cuda_inputs(b, h, 512, 64, 1, seed=11)
    n_blk = b * 66 + 1
    _, _, pc, pkr = _cuda_inputs(1, 1, 512, 64, n_blk * 16, seed=12)
    pc, pkr = pc.reshape(n_blk, 16, 512), pkr.reshape(n_blk, 16, 64)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    bt = (1 + torch.randperm(n_blk - 1, generator=gen, device="cuda")
          ).reshape(b, 66)
    c, kr = layers.pool_view(pc, bt), layers.pool_view(pkr, bt)
    vl = torch.tensor([257, 513, 778, 1025], device="cuda")
    combines = md.mla_decode_attention.combine_launches
    out = md.mla_decode_attention(qe, qr, c, kr, vl, scale=SCALE)
    torch.cuda.synchronize()
    assert md.split_plan(b, h, s, _sms())[0] > 1
    assert md.mla_decode_attention.combine_launches == combines + 1
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

"""The port's GEMM_non-split slice against the reference.

Same numpy inputs (``np.random.default_rng``) through both packages; bf16
inputs are rounded to bf16 first, so both see the same values.

* ``kernels.matmul`` (plain version, what the wrapper runs for CPU
  tensors) against ``repro.kernels.ops.matmul`` in interpret mode and
  ``ref.matmul_ref``, at the reference's own shapes
  (tests/test_kernels.py::test_matmul_kernel), and on ragged shapes the TPU
  kernel does not take against ``ref.matmul_ref`` only.
* ``kernels.ops`` flux wrappers at ``n_dev=1`` against the reference's, for
  every activation with and without bias.
* ``core.ect`` formula for formula against ``repro.core.ect``, with the
  reference's v5e terms passed in as ``Hardware``: every key to rel 1e-12.
* ``launch.op_level`` on the CPU.

Tolerances: fp32 atol 1e-5·√K, rtol 1e-5 (the reference's kernel test);
bf16 outputs compared in fp32 within 2 bf16 ulps: rtol 2⁻⁷, atol
1e-3·max|C|.  The ``gpu``-marked tests hold the CUDA kernel against the
plain version with the same tolerances, on the card only.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core import ect as tect
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ops as tops
from repro_torch.launch import op_level

ACTS = [None, "silu", "gelu", "relu", "sqrelu"]
DTYPES = ["float32", "bfloat16"]
REL = 1e-12


def _inputs(m, k, n, dtype, seed=0):
    """numpy fp32 A [m, k], B [k, n], rounded to bf16 when dtype is bf16."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k), dtype=np.float32)
    b = rng.standard_normal((k, n), dtype=np.float32)
    if dtype == "bfloat16":
        a, b = (torch.from_numpy(x).bfloat16().float().numpy() for x in (a, b))
    return a, b


def _torch(x, dtype, device="cpu"):
    return torch.from_numpy(x).to(device, getattr(torch, dtype))


def _jax(x, dtype):
    import jax.numpy as jnp     # not at the top: the card's machine has no JAX
    return jnp.asarray(x, dtype=getattr(jnp, dtype))


def _assert_close(got, want, dtype, k):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "bfloat16":
        atol, rtol = 1e-3 * float(np.abs(want).max()), 2.0 ** -7
    else:
        atol, rtol = 1e-5 * math.sqrt(k), 1e-5
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _np(t):
    return t.float().numpy()


# ---------------------------------------------------------------------------
# kernels.matmul: the plain version against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n", [(256, 256, 256), (384, 640, 256),
                                   (128, 1024, 512), (512, 384, 128)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_matches_reference_kernel(m, k, n, dtype):
    import jax.numpy as jnp
    from repro.kernels import ops as kops
    from repro.kernels import ref
    a, b = _inputs(m, k, n, dtype, seed=m + k + n)
    got = _np(mm.matmul(_torch(a, dtype), _torch(b, dtype)))
    ja, jb = _jax(a, dtype), _jax(b, dtype)
    want_kernel = kops.matmul(ja, jb, interpret=True)
    want_oracle = ref.matmul_ref(ja, jb).astype(getattr(jnp, dtype))
    _assert_close(got, want_kernel, dtype, k)
    _assert_close(got, want_oracle, dtype, k)


@pytest.mark.parametrize("m,k,n", [(100, 200, 72), (777, 1000, 1032),
                                   (1, 8, 8)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_matches_oracle_on_ragged_shapes(m, k, n, dtype):
    """Shapes the TPU kernel rejects (not block multiples); the port's
    kernel masks them."""
    import jax.numpy as jnp
    from repro.kernels import ref
    a, b = _inputs(m, k, n, dtype, seed=7)
    got = _np(mm.matmul(_torch(a, dtype), _torch(b, dtype)))
    want = ref.matmul_ref(_jax(a, dtype), _jax(b, dtype))
    _assert_close(got, want.astype(getattr(jnp, dtype)), dtype, k)


def test_out_dtype_is_one_cast_of_the_fp32_product():
    from repro.kernels import ref
    a, b = _inputs(64, 256, 128, "bfloat16", seed=3)
    ta, tb = _torch(a, "bfloat16"), _torch(b, "bfloat16")
    got = mm.matmul(ta, tb, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    want = np.asarray(ref.matmul_ref(_jax(a, "bfloat16"), _jax(b, "bfloat16")))
    _assert_close(got.numpy(), want, "float32", 256)
    assert mm.matmul(ta, tb).dtype == torch.bfloat16


def test_wrapper_on_cpu_takes_plain_path():
    a, b = (torch.from_numpy(x) for x in _inputs(64, 64, 32, "float32"))
    before = mm.matmul.launches
    out = mm.matmul(a, b)
    assert mm.matmul.launches == before
    torch.testing.assert_close(out, mm.matmul_ref(a, b), atol=0, rtol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a, b = (torch.from_numpy(x) for x in _inputs(64, 64, 32, "float32"))
    with pytest.raises(ValueError, match=r"A \[M, K\]"):
        mm.matmul(a, b.T.contiguous())
    with pytest.raises(ValueError, match="dtypes"):
        mm.matmul(a.half(), b.half())
    with pytest.raises(ValueError, match="dtypes"):
        mm.matmul(a.bfloat16(), b)
    with pytest.raises(ValueError, match="out_dtype"):
        mm.matmul(a, b, out_dtype=torch.float16)
    # the card-side checks (run before any launch) on host tensors
    a16 = torch.zeros((64, 60), dtype=torch.bfloat16)
    b16 = torch.zeros((60, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        mm._check_cuda(a16, b16)
    a32, b32 = torch.zeros((8, 16)), torch.zeros((16, 6))
    with pytest.raises(ValueError, match="multiples of 4"):
        mm._check_cuda(a32, b32)
    with pytest.raises(ValueError, match="contiguous"):
        mm._check_cuda(torch.zeros((16, 8)).T, torch.zeros((16, 8)))
    with pytest.raises(ValueError, match="empty"):
        mm._check_cuda(torch.zeros((0, 8)), torch.zeros((8, 8)))


@pytest.mark.parametrize("m,n,block", [
    (64, 6144, mm.NARROW), (64, 12288, mm.NARROW), (512, 6144, mm.WIDE),
    (8192, 12288, mm.WIDE), (777, 1032, mm.NARROW), (1537, 1544, mm.WIDE)])
def test_plan_blocks_narrows_only_when_wide_tiles_leave_sms_idle(m, n, block):
    """Wide tiles at 64 x 6144: 48, 64 x 12288: 96, 512 x 6144: 192, 777 x
    1032: 63, 1537 x 1544: 169 (132 SMs)."""
    assert mm.plan_blocks(m, n) == block


# ---------------------------------------------------------------------------
# kernels.ops: the flux wrappers at n_dev = 1
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("activation", ACTS)
@pytest.mark.parametrize("wrapper", ["ag_matmul_fused", "matmul_rs_fused"])
def test_fused_wrappers_single_device(wrapper, activation, with_bias, dtype):
    from repro.kernels import ops as kops
    m, k, n = 128, 256, 128
    a, b = _inputs(m, k, n, dtype, seed=11)
    bias = (np.random.default_rng(12).standard_normal((n,), dtype=np.float32)
            if with_bias else None)
    if bias is not None and dtype == "bfloat16":
        bias = torch.from_numpy(bias).bfloat16().float().numpy()
    got = getattr(tops, wrapper)(
        _torch(a, dtype), _torch(b, dtype), axis_name="tp", n_dev=1,
        activation=activation,
        bias=None if bias is None else _torch(bias, dtype))
    want = getattr(kops, wrapper)(
        _jax(a, dtype), _jax(b, dtype), axis_name="tp", n_dev=1,
        activation=activation,
        bias=None if bias is None else _jax(bias, dtype), interpret=True)
    assert got.dtype == getattr(torch, dtype)
    _assert_close(_np(got), want, dtype, k)


@pytest.mark.parametrize("wrapper", ["ag_matmul_fused", "matmul_rs_fused"])
def test_fused_wrappers_raise_beyond_one_device(wrapper):
    a, b = (torch.from_numpy(x) for x in _inputs(32, 16, 8, "float32"))
    with pytest.raises(NotImplementedError, match="queue 1 item 2"):
        getattr(tops, wrapper)(a, b, axis_name="tp", n_dev=4)
    with pytest.raises(ValueError, match="n_dev"):
        getattr(tops, wrapper)(a, b, axis_name="tp")


def test_ops_matmul_is_the_kernel_module():
    a, b = (torch.from_numpy(x) for x in _inputs(32, 16, 8, "float32"))
    torch.testing.assert_close(tops.matmul(a, b), mm.matmul(a, b),
                               atol=0, rtol=0)


# ---------------------------------------------------------------------------
# core.ect: formula for formula against the reference
# ---------------------------------------------------------------------------
def _v5e():
    from repro.core import ect as rect
    return tect.Hardware(peak_flops=rect.PEAK_FLOPS_BF16, hbm_bw=rect.HBM_BW,
                         link_bw=rect.ICI_BW)


def _assert_same_dict(got, want, what):
    assert set(got) == set(want), what
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=REL, abs=0), \
            f"{what}: {key} {got[key]} != {want[key]}"


# the knob settings beyond the seam x mode x wire x layout grid
KNOBS = [dict(), dict(comm_chunks=2), dict(comm_chunks=16),
         dict(n_weights=2), dict(n_weights=2, shared_gather=False),
         dict(epilogue=True), dict(epilogue=True, fuse_epilogue=False),
         dict(n_weights=3, shared_gather=False, epilogue=True,
              fuse_epilogue=False, comm_chunks=4)]


@pytest.mark.parametrize("seam", ["ag", "rs", "ar", "a2a"])
def test_model_overlap_matches_reference(seam):
    from repro.core import ect as rect
    hw = _v5e()
    n_checked = 0
    for m, n, k, n_dev in ((8192, 49152, 12288, 8), (64, 12288, 49152, 8),
                           (1024, 4096, 2048, 4)):
        for mode in ("xla", "decomposed", "flux", "decomposed_bidir"):
            for wire in (None, "int8", "fp8_e4m3", "int4"):
                for axis in ("seq", "hidden"):
                    for kn in KNOBS:
                        kw = dict(kn, wire_dtype=wire, scatter_axis=axis)
                        if seam != "ag" and kn.get("n_weights", 1) > 1:
                            continue
                        want = rect.model_overlap(seam, m, n, k, n_dev, mode,
                                                  **kw)
                        got = tect.model_overlap(seam, m, n, k, n_dev, mode,
                                                 hw=hw, **kw)
                        _assert_same_dict(got, want, (seam, m, mode, kw))
                        n_checked += 1
    assert n_checked >= 3 * 4 * 4 * 2 * 3


def test_model_overlap_rejects_unknown_names():
    hw = _v5e()
    with pytest.raises(ValueError, match="mode"):
        tect.model_overlap("ag", 64, 64, 64, 8, "bogus", hw=hw)
    with pytest.raises(ValueError, match="seam"):
        tect.model_overlap("xy", 64, 64, 64, 8, "xla", hw=hw)


def test_model_terms_match_reference():
    from repro.core import ect as rect
    hw = _v5e()
    for m in (1, 64, 128, 8192):
        assert tect.gemm_efficiency(m) == pytest.approx(
            rect.gemm_efficiency(m), rel=REL)
        for dtype_bytes in (1, 2, 4):
            assert tect.model_gemm_time(m, 6144, 12288, dtype_bytes, hw=hw) \
                == pytest.approx(rect.model_gemm_time(m, 6144, 12288,
                                                      dtype_bytes), rel=REL)
    for kind in ("ag", "rs", "ar", "allreduce", "a2a"):
        for links in (1, 2):
            assert tect.model_collective_time(1e6, 8, kind, links, hw=hw) \
                == pytest.approx(rect.model_collective_time(1e6, 8, kind,
                                                            links), rel=REL)
    for wire in ("int8", "fp8_e4m3", "int4"):
        for dtype_bytes in (2, 4):
            assert tect.wire_bytes_factor(wire, dtype_bytes) == pytest.approx(
                rect.wire_bytes_factor(wire, dtype_bytes), rel=REL)


@pytest.mark.parametrize("overall,gemm,base_overall", [
    (3.0, 2.0, 4.0), (2.0, 2.0, 4.0), (5.0, 2.0, 4.0), (3.0, 2.0, 2.0)])
def test_ect_result_matches_reference(overall, gemm, base_overall):
    from repro.core import ect as rect
    got = tect.ECTResult("x", overall, gemm)
    base = tect.ECTResult("base", base_overall, gemm)
    want = rect.ECTResult("x", overall, gemm)
    want_base = rect.ECTResult("base", base_overall, gemm)
    assert got.ect_s == want.ect_s
    e_got, e_want = got.overlap_efficiency(base), \
        want.overlap_efficiency(want_base)
    assert (math.isnan(e_got) and math.isnan(e_want)) or e_got == e_want


def test_time_fn_on_cpu_is_a_median_of_calls():
    calls = []
    t = tect.time_fn(lambda x: calls.append(x), 1, iters=5, warmup=2)
    assert len(calls) == 7 and t >= 0.0


# ---------------------------------------------------------------------------
# launch.op_level
# ---------------------------------------------------------------------------
def test_op_level_rank_shapes_and_bounds():
    assert op_level.rank_shape("ag", 8192, 49152, 12288) == (8192, 12288, 6144)
    assert op_level.rank_shape("rs", 8192, 12288, 49152) == (8192, 6144, 12288)
    # the bound of each §5.1 per-rank GEMM (both seams share it)
    for m, ms, by in ((64, 0.046, "bytes"), (512, 0.078, "operations"),
                      (1024, 0.156, "operations"),
                      (2048, 0.313, "operations"),
                      (4096, 0.625, "operations"), (8192, 1.25, "operations")):
        for seam, (n, k) in op_level.SEAMS:
            bound, what = op_level.gemm_bound_s(
                *op_level.rank_shape(seam, m, n, k))
            assert what == by and bound * 1e3 == pytest.approx(ms, rel=0.01)


def test_op_level_runs_the_plain_path_on_cpu(capsys):
    before = mm.matmul.launches
    rows = op_level.main(device="cpu", scale=64, iters=1, warmup=0)
    assert mm.matmul.launches == before
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert lines.count("name,us_per_call,derived") == 1
    want = [f"oplevel_{seam}_m{m}_{tag}" for seam in ("ag", "rs")
            for m in op_level.M_SWEEP
            for tag in ("gemm_nonsplit", "torch_matmul")]
    body = [ln.split(",") for ln in lines[1:]]
    assert [r[0] for r in body] == want
    for name, us, derived in body:
        assert float(us) >= 0.0 and derived == "-"
    assert len(rows) == 12
    assert rows[0]["shape"] == [8, 12288 // 64, 6144 // 64]


def test_op_level_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        op_level.main()


# ---------------------------------------------------------------------------
# the CUDA kernel against the plain version (on the card only)
# ---------------------------------------------------------------------------
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


def _cuda_case(m, k, n, dtype, seed=5):
    a, b = _inputs(m, k, n, dtype, seed)
    return _torch(a, dtype, "cuda"), _torch(b, dtype, "cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(64, 12288, 6144), (1024, 12288, 6144),
                                   (64, 6144, 12288), (1024, 6144, 12288)])
def test_cuda_kernel_matches_plain_at_op_level_shapes(m, k, n):
    _needs_card()
    a, b = _cuda_case(m, k, n, "bfloat16")
    before = mm.matmul.launches
    out = mm.matmul(a, b)
    torch.cuda.synchronize()
    assert mm.matmul.launches == before + 1
    _assert_close(out.float().cpu().numpy(),
                  mm.matmul_ref(a, b).float().cpu().numpy(), "bfloat16", k)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(777, 1000, 1032), (1537, 1000, 1544)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernel_matches_plain_on_ragged_shapes(m, k, n, dtype):
    """The first shape takes the narrow bf16 tile, the second the wide
    one (test_plan_blocks_narrows_only_when_wide_tiles_leave_sms_idle)."""
    _needs_card()
    a, b = _cuda_case(m, k, n, dtype)
    out = mm.matmul(a, b)
    torch.cuda.synchronize()
    _assert_close(out.float().cpu().numpy(),
                  mm.matmul_ref(a, b).float().cpu().numpy(), dtype, k)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_fp32_1024():
    _needs_card()
    a, b = _cuda_case(1024, 1024, 1024, "float32")
    out = mm.matmul(a, b)
    torch.cuda.synchronize()
    _assert_close(out.cpu().numpy(), mm.matmul_ref(a, b).cpu().numpy(),
                  "float32", 1024)


@pytest.mark.gpu
@pytest.mark.parametrize("wrapper", ["ag_matmul_fused", "matmul_rs_fused"])
def test_cuda_wrappers_with_activation_and_bias(wrapper):
    _needs_card()
    a, b = _cuda_case(256, 512, 384, "bfloat16")
    bias = torch.linspace(-1, 1, 384, device="cuda").bfloat16()
    before = mm.matmul.launches
    out = getattr(tops, wrapper)(a, b, axis_name="tp", n_dev=1,
                                 activation="gelu", bias=bias)
    torch.cuda.synchronize()
    assert mm.matmul.launches == before + 1
    want = tops._epilogue_by_hand(mm.matmul_ref(a, b), "gelu", bias)
    _assert_close(out.float().cpu().numpy(), want.float().cpu().numpy(),
                  "bfloat16", 512)

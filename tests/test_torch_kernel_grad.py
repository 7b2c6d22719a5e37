"""The port's kernel wrappers refuse gradients instead of dropping them.

Each CUDA wrapper fills its output through ctypes, so the output has no
``grad_fn``: a backward pass would skip the op and raise nothing.  The
reference's Pallas kernels raise under ``jax.grad``; the port's wrappers
raise ``NotImplementedError`` (``kernels.build.refuse_grad``) for a CUDA
input that requires grad while grad mode is on, and name the ROADMAP item
that brings the backward.  The plain versions, which the wrappers run for
CPU tensors, stay differentiable.

The helper and the CPU paths are tested here; the ``gpu``-marked tests
show each of the five CUDA wrappers raising, and running under
``torch.no_grad()``, on a card.
"""
import pytest
import torch

from repro_torch import dist
from repro_torch.kernels import ag_gemm as AG
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gemm_rs as RS
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import mla_decode as md


def test_refuse_grad_raises_in_grad_mode_for_a_tensor_that_requires_grad():
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(NotImplementedError,
                       match=r"mla_decode_attention: .*no backward.*"
                             r"ROADMAP queue 1 item 5"):
        build.refuse_grad("mla_decode_attention", "5", torch.ones(2), x)


@pytest.mark.parametrize("case", ["no_grad", "inference_mode", "no_input"])
def test_refuse_grad_passes(case):
    x = torch.zeros(3, requires_grad=True)
    if case == "no_grad":
        with torch.no_grad():
            build.refuse_grad("matmul", "2.1", x, None)
    elif case == "inference_mode":
        with torch.inference_mode():
            build.refuse_grad("matmul", "2.1", x)
    else:
        build.refuse_grad("matmul", "2.1", torch.zeros(3), None)


def test_plain_paths_stay_differentiable_on_cpu():
    """CPU tensors take the plain versions, whose gradients flow."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 2, 8, 64), generator=g, requires_grad=True)
    k = torch.randn((1, 2, 8, 64), generator=g, requires_grad=True)
    fa.flash_attention(q, k, k.detach()).sum().backward()
    assert q.grad is not None and k.grad is not None

    a = torch.randn((8, 16), generator=g, requires_grad=True)
    mm.matmul(a, torch.randn((16, 8), generator=g)).sum().backward()
    assert a.grad is not None and torch.isfinite(a.grad).all()

    qe = torch.randn((2, 4, 64), generator=g, requires_grad=True)
    qr = torch.randn((2, 4, 16), generator=g)
    c = torch.randn((2, 40, 64), generator=g).bfloat16()
    kr = torch.randn((2, 40, 16), generator=g).bfloat16()
    md.mla_decode_attention(qe, qr, c, kr, 30, scale=0.1).sum().backward()
    assert qe.grad is not None and torch.isfinite(qe.grad).all()

    grp = dist.RankGroup(2, "cpu")
    w = torch.randn((16, 8), generator=g, requires_grad=True)
    shards = [torch.randn((4, 16), generator=g) for _ in range(2)]
    outs = grp.spmd(lambda s: AG.ag_gemm(s, w, group=grp), [(s,) for s in
                                                             shards])
    sum(o.sum() for o in outs).backward()
    assert w.grad is not None
    b = torch.randn((8, 8), generator=g, requires_grad=True)
    outs = grp.spmd(lambda s: RS.gemm_rs(s[:, :8], b, group=grp),
                    [(s,) for s in shards])
    sum(o.sum() for o in outs).backward()
    assert b.grad is not None


# ---------------------------------------------------------------------------
# the CUDA wrappers on the card
# ---------------------------------------------------------------------------
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


def _randn(*shape, dtype=torch.bfloat16):
    return torch.randn(shape, device="cuda").to(dtype)


def _flash(requires):
    q = _randn(1, 2, 64, 64).requires_grad_(requires)
    return [fa.flash_attention(q, _randn(1, 2, 64, 64), _randn(1, 2, 64, 64))]


def _mla(requires):
    qe = _randn(2, 16, 512, dtype=torch.float32).requires_grad_(requires)
    return [md.mla_decode_attention(
        qe, _randn(2, 16, 64, dtype=torch.float32), _randn(2, 40, 512),
        _randn(2, 40, 64), torch.tensor([40, 7], device="cuda"), scale=0.07)]


def _matmul(requires):
    return [mm.matmul(_randn(64, 128), _randn(128, 64).requires_grad_(
        requires))]


def _ag_gemm(requires):
    grp = dist.RankGroup(2, "cuda", timeout_s=60)
    b = _randn(128, 64).requires_grad_(requires)
    enabled = torch.is_grad_enabled()

    def rank(a):
        with torch.set_grad_enabled(enabled):   # grad mode is per thread
            return AG.ag_gemm(a, b, group=grp)
    return grp.spmd(rank, [(_randn(64, 128),) for _ in range(2)])


def _gemm_rs(requires):
    grp = dist.RankGroup(2, "cuda", timeout_s=60)
    enabled = torch.is_grad_enabled()

    def rank(a, b):
        with torch.set_grad_enabled(enabled):
            return RS.gemm_rs(a, b, group=grp)
    return grp.spmd(rank, [(_randn(128, 64).requires_grad_(requires),
                            _randn(64, 128)) for _ in range(2)])


WRAPPERS = {"flash_attention": (_flash, "5"), "mla_decode": (_mla, "5"),
            "matmul": (_matmul, "2.1"), "ag_gemm": (_ag_gemm, "2.1"),
            "gemm_rs": (_gemm_rs, "2.1")}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(WRAPPERS))
def test_cuda_wrapper_refuses_an_input_that_requires_grad(name):
    _cuda()
    call, item = WRAPPERS[name]
    with pytest.raises((NotImplementedError, dist.RankGroupError)) as info:
        call(True)
    err = info.value
    if isinstance(err, dist.RankGroupError):   # a rank's error, re-raised
        err = err.__cause__
    assert isinstance(err, NotImplementedError)
    assert f"no backward (ROADMAP queue 1 item {item})" in str(err)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(WRAPPERS))
def test_cuda_wrapper_runs_under_no_grad(name):
    """The same inputs, requiring grad, under no_grad (carried into each
    rank's thread for the fused kernels): the kernel runs."""
    _cuda()
    call, _ = WRAPPERS[name]
    with torch.no_grad():
        outs = call(True)
    torch.cuda.synchronize()
    for out in outs:
        assert out.grad_fn is None and torch.isfinite(out.float()).all()

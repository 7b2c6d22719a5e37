"""The tensor-parallel seams of the port at 4 ranks against the reference.

The reference runs once for the whole file, in one subprocess with 4
forced host devices (``conftest.run_subprocess_devices``), its Pallas ring
kernels in interpret mode under ``shard_map``; the port runs the same numpy
inputs as the 4 ranks of a ``dist.RankGroup`` on the CPU, where the fused
kernels' wrappers run their plain versions.

* ``kops.ag_matmul_fused`` / ``matmul_rs_fused`` at n_dev=4: the
  ``_RING_TEST`` shapes of tests/test_kernels.py, ring direction both ways,
  and every epilogue activation with and without bias.
* ``FusedOp`` ag (one weight with a bias epilogue; the SwiGLU pair gate
  over a shared gather) and rs at tp=4, modes xla, decomposed and flux.
* ``gather_seq`` / ``scatter_seq_sum``.
* The rank group itself: order, a barrier that times out, a rank's
  exception; and the kernels' launch counts under threads.

Tolerances: fp32 outputs within the reference oracle's ``1e-3 * sqrt(K)``
(tests/test_kernels.py); bf16 AllGather-GEMM within 2 bf16 ulps (rtol
2^-7, atol 1e-3 * max|C|, as tests/test_torch_matmul.py); bf16
GEMM-ReduceScatter within ``n * 2^-8 * max|partial|`` beyond that (the
reference's ring rounds the travelling partial to bf16 n - 1 times, the
port rounds each rank's partial once).  Data movement (gathers) is exact.

The ``gpu``-marked tests hold the CUDA kernels against their plain versions
on the card (ragged shapes, both bf16 tiles, both ring directions, fp32);
they skip here.
"""
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import dist
from repro_torch.core import overlap as tov
from repro_torch.kernels import ag_gemm as AG
from repro_torch.kernels import build
from repro_torch.kernels import gemm_rs as RS
from repro_torch.kernels import ops as tops

N = 4
ACTS = [None, "silu", "gelu", "relu", "sqrelu"]
# tests/test_kernels.py::_RING_TEST: (M, K, N, dtype)
RING = [(512, 512, 512, "float32"), (1024, 256, 512, "bfloat16"),
        (512, 768, 1024, "float32")]
EPI_SHAPE = (128, 128, 128)
B, S, D, F = 2, 16, 32, 32          # FusedOp: x [B, S, D], F = 4 x 8
MODES = ["xla", "decomposed", "flux"]

_REF = r"""
import functools, sys
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.core import overlap as ov
from repro.kernels import ops as kops

inp = dict(np.load(sys.argv[1]))
out = {}
mesh = Mesh(np.array(jax.devices()), ("tp",))
DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def smap(fn, in_specs, out_specs):
    return jax.jit(functools.partial(shard_map, mesh=mesh, in_specs=in_specs,
                                     out_specs=out_specs,
                                     check_vma=False)(fn))


def kernels(tag, a, b, bias, act, reverse):
    kw = dict(axis_name="tp", reverse=reverse, activation=act)
    bspec = () if bias is None else (P("tp"),)
    bargs = () if bias is None else (bias,)
    ag = smap(lambda x, w, *bb: kops.ag_matmul_fused(
        x, w, bias=bb[0] if bb else None, **kw),
        (P("tp", None), P(None, "tp")) + bspec, P(None, "tp"))
    out[tag + "/ag"] = np.asarray(ag(a, b, *bargs), np.float32)
    bspec = () if bias is None else (P(None),)
    rs = smap(lambda x, w, *bb: kops.matmul_rs_fused(
        x, w, bias=bb[0] if bb else None, **kw),
        (P(None, "tp"), P("tp", None)) + bspec, P("tp", None))
    out[tag + "/rs"] = np.asarray(rs(a, b, *bargs), np.float32)


for i, dt in enumerate(%(ring_dtypes)r):
    for rev in (False, True):
        a = jnp.asarray(inp[f"ring{i}/a"], DT[dt])
        b = jnp.asarray(inp[f"ring{i}/b"], DT[dt])
        kernels(f"ring{i}/{rev}", a, b, None, None, rev)

a, b = jnp.asarray(inp["epi/a"]), jnp.asarray(inp["epi/b"])
for j, act in enumerate(%(acts)r):
    for with_bias in (False, True):
        bias = jnp.asarray(inp["epi/bias"]) if with_bias else None
        kernels(f"epi/{act}/{with_bias}", a, b, bias, act, bool(j %% 2))

x, w1, w3 = (jnp.asarray(inp[k]) for k in ("fo/x", "fo/w1", "fo/w3"))
bias, y, w2 = (jnp.asarray(inp[k]) for k in ("fo/bias", "fo/y", "fo/w2"))
seq, col = P(None, "tp", None), P(None, None, "tp")
for mode in %(modes)r:
    op = ov.FusedOp("ag", axis="tp", mode=mode,
                    epilogue=ov.Epilogue(bias=True))
    f = smap(lambda x_, w_, b_: op(x_, w_, bias=b_),
             (seq, P(None, "tp"), P("tp")), col)
    out[f"fo/{mode}/ag_bias"] = np.asarray(f(x, w1, bias))
    op2 = ov.FusedOp("ag", axis="tp", mode=mode, n_weights=2,
                     epilogue=ov.Epilogue(activation="silu", gate="pair"))
    f = smap(lambda x_, a_, b_: op2(x_, a_, b_),
             (seq, P(None, "tp"), P(None, "tp")), col)
    out[f"fo/{mode}/ag_pair"] = np.asarray(f(x, w1, w3))
    op3 = ov.FusedOp("rs", axis="tp", mode=mode)
    f = smap(lambda y_, w_: op3(y_, w_), (col, P("tp", None)), seq)
    out[f"fo/{mode}/rs"] = np.asarray(f(y, w2))

parts = jnp.asarray(inp["seq/parts"])          # [N, B, S, D]
for mode, rev in (("xla", False), ("decomposed", False),
                  ("decomposed", True)):
    f = smap(lambda x_: ov.gather_seq(x_, "tp", mode, rev)[None],
             (seq,), P("tp"))
    out[f"seq/gather/{mode}/{rev}"] = np.asarray(f(x))
    f = smap(lambda p_: ov.scatter_seq_sum(p_[0], "tp", mode, rev),
             (P("tp"),), seq)
    out[f"seq/scatter/{mode}/{rev}"] = np.asarray(f(parts))
np.savez(sys.argv[2], **out)
print("REF_OK")
"""


def _bf16(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


def _inputs():
    rng = np.random.default_rng(0)
    inp = {}
    for i, (m, k, n, dt) in enumerate(RING):
        a = rng.standard_normal((m, k), dtype=np.float32)
        b = rng.standard_normal((k, n), dtype=np.float32)
        if dt == "bfloat16":
            a, b = _bf16(a), _bf16(b)
        inp[f"ring{i}/a"], inp[f"ring{i}/b"] = a, b
    m, k, n = EPI_SHAPE
    inp["epi/a"] = rng.standard_normal((m, k), dtype=np.float32)
    inp["epi/b"] = rng.standard_normal((k, n), dtype=np.float32)
    inp["epi/bias"] = rng.standard_normal((n,), dtype=np.float32)
    for key, shape in (("fo/x", (B, S, D)), ("fo/w1", (D, F)),
                       ("fo/w3", (D, F)), ("fo/bias", (F,)),
                       ("fo/y", (B, S, F)), ("fo/w2", (F, D)),
                       ("seq/parts", (N, B, S, D))):
        inp[key] = rng.standard_normal(shape, dtype=np.float32)
    return inp


@pytest.fixture(scope="module")
def ref(tmp_path_factory, subproc):
    """(inputs, the reference's outputs), from one 4-device subprocess."""
    d = tmp_path_factory.mktemp("tp_seams")
    inp = _inputs()
    np.savez(d / "in.npz", **inp)
    code = _REF % {"ring_dtypes": [r[3] for r in RING], "acts": ACTS,
                   "modes": MODES}
    code = code.replace("sys.argv[1]", repr(str(d / "in.npz"))).replace(
        "sys.argv[2]", repr(str(d / "out.npz")))
    assert "REF_OK" in subproc(code, n_devices=N)
    return inp, dict(np.load(d / "out.npz"))


def _t(a, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))


def _cols(a, r, n=N):
    w = a.shape[-1] // n
    return a[..., r * w:(r + 1) * w]


def _rows(a, r, n=N, dim=0):
    w = a.shape[dim] // n
    return np.take(a, range(r * w, (r + 1) * w), axis=dim)


def _port_kernels(a, b, dtype, bias=None, act=None, reverse=False):
    """The port's ag and rs wrappers at 4 ranks on the CPU: global outputs
    (AG columns and RS rows concatenated in rank order)."""
    g = dist.RankGroup(N, "cpu", timeout_s=60)
    bias_t = None if bias is None else _t(bias, dtype)
    ag = g.spmd(lambda x, w, bb: tops.ag_matmul_fused(
        x, w, axis_name="tp", reverse=reverse, activation=act, bias=bb),
        [(_t(_rows(a, r), dtype), _t(_cols(b, r), dtype),
          None if bias is None else _t(_cols(bias, r), dtype))
         for r in range(N)])
    rs = g.spmd(lambda x, w: tops.matmul_rs_fused(
        x, w, axis_name="tp", reverse=reverse, activation=act, bias=bias_t),
        [(_t(_cols(a, r), dtype), _t(_rows(b, r), dtype)) for r in range(N)])
    return (torch.cat(ag, dim=1).float().numpy(),
            torch.cat(rs, dim=0).float().numpy())


def _assert_kernel(got, want, dtype, k, rs=False, max_partial=0.0):
    if dtype == "bfloat16":
        atol = 1e-3 * np.abs(want).max()
        if rs:
            atol += N * 2.0 ** -8 * max_partial
        np.testing.assert_allclose(got, want, atol=atol, rtol=2.0 ** -7)
    else:
        np.testing.assert_allclose(got, want, atol=1e-3 * np.sqrt(k),
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# the fused kernels' wrappers (plain versions) at 4 ranks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("i", range(len(RING)))
def test_fused_kernels_match_reference_ring(ref, i, reverse):
    inp, out = ref
    m, k, n, dt = RING[i]
    a, b = inp[f"ring{i}/a"], inp[f"ring{i}/b"]
    ag, rs = _port_kernels(a, b, dt, reverse=reverse)
    max_partial = max(np.abs(_cols(a, r) @ _rows(b, r)).max()
                      for r in range(N))
    _assert_kernel(ag, out[f"ring{i}/{reverse}/ag"], dt, k)
    _assert_kernel(rs, out[f"ring{i}/{reverse}/rs"], dt, k, rs=True,
                   max_partial=max_partial)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("act", ACTS)
def test_fused_kernels_epilogue_match_reference(ref, act, with_bias):
    inp, out = ref
    bias = inp["epi/bias"] if with_bias else None
    ag, rs = _port_kernels(inp["epi/a"], inp["epi/b"], "float32", bias=bias,
                           act=act, reverse=bool(ACTS.index(act) % 2))
    k = EPI_SHAPE[1]
    _assert_kernel(ag, out[f"epi/{act}/{with_bias}/ag"], "float32", k)
    _assert_kernel(rs, out[f"epi/{act}/{with_bias}/rs"], "float32", k)


# ---------------------------------------------------------------------------
# FusedOp at tp=4 and the sequence gathers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
def test_fused_op_matches_reference(ref, mode):
    inp, out = ref
    g = dist.RankGroup(N, "cpu", timeout_s=60)
    x, w1, w3, bias, y, w2 = (inp[k] for k in ("fo/x", "fo/w1", "fo/w3",
                                                "fo/bias", "fo/y", "fo/w2"))
    xs = [_t(_rows(x, r, dim=1)) for r in range(N)]
    op = tov.FusedOp("ag", axis=g, mode=mode,
                     epilogue=tov.Epilogue(bias=True))
    got = g.spmd(lambda x_, w_, b_: op(x_, w_, bias=b_),
                 [(xs[r], _t(_cols(w1, r)), _t(_cols(bias, r)))
                  for r in range(N)])
    np.testing.assert_allclose(torch.cat(got, -1).numpy(),
                               out[f"fo/{mode}/ag_bias"], atol=1e-5,
                               rtol=1e-5)
    op2 = tov.FusedOp("ag", axis=g, mode=mode, n_weights=2,
                      epilogue=tov.Epilogue(activation="silu", gate="pair"))
    got = g.spmd(lambda x_, a_, b_: op2(x_, a_, b_),
                 [(xs[r], _t(_cols(w1, r)), _t(_cols(w3, r)))
                  for r in range(N)])
    np.testing.assert_allclose(torch.cat(got, -1).numpy(),
                               out[f"fo/{mode}/ag_pair"], atol=1e-5,
                               rtol=1e-5)
    op3 = tov.FusedOp("rs", axis=g, mode=mode)
    got = g.spmd(lambda y_, w_: op3(y_, w_),
                 [(_t(_cols(y, r)), _t(_rows(w2, r))) for r in range(N)])
    np.testing.assert_allclose(torch.cat(got, 1).numpy(),
                               out[f"fo/{mode}/rs"], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode,reverse", [("xla", False),
                                          ("decomposed", False),
                                          ("decomposed", True)])
def test_gather_and_scatter_seq_match_reference(ref, mode, reverse):
    inp, out = ref
    g = dist.RankGroup(N, "cpu", timeout_s=60)
    x, parts = inp["fo/x"], inp["seq/parts"]
    got = g.spmd(lambda x_: tov.gather_seq(x_, g, mode, reverse),
                 [(_t(_rows(x, r, dim=1)),) for r in range(N)])
    np.testing.assert_array_equal(torch.stack(got).numpy(),
                                  out[f"seq/gather/{mode}/{reverse}"])
    got = g.spmd(lambda p_: tov.scatter_seq_sum(p_, g, mode, reverse),
                 [(_t(parts[r]),) for r in range(N)])
    np.testing.assert_allclose(torch.cat(got, 1).numpy(),
                               out[f"seq/scatter/{mode}/{reverse}"],
                               atol=1e-5, rtol=1e-5)


def test_fused_op_rejects_what_is_not_ported():
    g = dist.RankGroup(N, "cpu")
    # the fused kernels have no quantized wire (the reference's rule)
    with pytest.raises(ValueError, match="mode='flux'"):
        tov.FusedOp(axis=g, kind="ag", mode="flux", wire_dtype="int8")
    # decomposed_bidir runs at tp>1: its forward equals decomposed's
    x = torch.arange(B * S * D, dtype=torch.float32).reshape(B, S, D) / 100
    w = torch.ones((D, F // N))
    outs = {m: g.spmd(tov.FusedOp("ag", axis=g, mode=m),
                      [(x[:, r * S // N:(r + 1) * S // N], w)
                       for r in range(N)])
            for m in ("decomposed", "decomposed_bidir")}
    for a, b in zip(outs["decomposed"], outs["decomposed_bidir"]):
        assert torch.equal(a, b)
    # the replicated layout's ops run under grad on a SeamTape: w's grad
    # is x^T (the psum of the ranks' cotangents of ones, for rs and ar)
    for kw, w_shape, sums in ((dict(kind="ag", scatter_axis="hidden"),
                               (D, F), 1.0),
                              (dict(kind="rs", scatter_axis="hidden"),
                               (F, D), float(N)),
                              (dict(kind="ar"), (F, D), float(N))):
        op = tov.FusedOp(axis=g, **kw)

        def body(r):
            w_ = torch.ones(w_shape, requires_grad=True)
            with tov.SeamTape() as tape:
                y = op(torch.ones((B, S, w_shape[0])), w_)
            tape.backward(y.sum())
            return w_.grad

        for dw in g.spmd(body, [(r,) for r in range(N)]):
            assert torch.equal(dw, torch.full(w_shape, B * S * sums)), kw
    # the tp>1 backward runs on a SeamTape; flux's grads equal xla's
    def grad_w(mode):
        op, w = tov.FusedOp("ag", axis=g, mode=mode), torch.ones((D, F // N))
        def body(r, w_):
            with tov.SeamTape() as tape:
                y = op(torch.full((B, S // N, D), r + 1.0), w_).sum()
            tape.backward(y)
            return w_.grad
        return g.spmd(body, [(r, w.clone().requires_grad_())
                             for r in range(N)])
    for a, b in zip(grad_w("flux"), grad_w("xla")):
        assert a.abs().sum() > 0 and torch.equal(a, b)


# ---------------------------------------------------------------------------
# the rank group and the launch counts
# ---------------------------------------------------------------------------
def test_rank_group_runs_each_rank_once_in_order():
    g = dist.RankGroup(N, "cpu")
    seen = g.spmd(lambda tag: (g.rank(), tag, dist.current_group() is g),
                  [(f"arg{r}",) for r in range(N)])
    assert seen == [(r, f"arg{r}", True) for r in range(N)]
    assert dist.current_group() is None
    got = g.spmd(lambda v: g.exchange(v, "x"),
                 [(torch.full((2,), float(r)),) for r in range(N)])
    for r in range(N):
        assert [int(t[0]) for t in got[r]] == list(range(N))
    got = g.spmd(lambda v: g.ppermute(v, [(i, (i + 1) % N)
                                          for i in range(N)], "p"),
                 [(torch.full((1,), float(r)),) for r in range(N)])
    assert [int(t[0]) for t in got] == [(r - 1) % N for r in range(N)]


def test_rank_group_barrier_timeout_raises_naming_ranks():
    g = dist.RankGroup(N, "cpu", timeout_s=0.5)

    def body(r):
        if r != 2:
            g.barrier("meet")

    t0 = time.perf_counter()
    with pytest.raises(dist.RankGroupError, match="'meet'.*2"):
        g.spmd(body, [(r,) for r in range(N)])
    assert time.perf_counter() - t0 < 10
    # the group is usable again afterwards
    assert g.spmd(lambda r: r, [(r,) for r in range(N)]) == list(range(N))


def test_rank_group_raises_a_ranks_exception():
    g = dist.RankGroup(N, "cpu", timeout_s=30)

    def body(r):
        if r == 1:
            raise KeyError("rank one fails")
        g.barrier("after")

    with pytest.raises(dist.RankGroupError, match="rank 1.*rank one fails"):
        g.spmd(body, [(r,) for r in range(N)])


def test_launch_counts_are_exact_under_threads():
    """4 threads x k counted launches count 4k (a bare ``+=`` on a function
    attribute can lose updates between threads)."""
    def fn():
        pass
    fn.launches = 0
    k = 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [build.count_launch(fn) for _ in range(k)])
            for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert fn.launches == 4 * k


# ---------------------------------------------------------------------------
# on the card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused kernels run only there")


GPU_CASES = [  # ranks, dtype, rows (AG: M_sh; RS: M_sh), K, N, tile, reverse
    (4, "bfloat16", 97, 1000, 1032, (64, 64), False),
    (4, "bfloat16", 97, 1000, 1032, (128, 256), True),
    (8, "bfloat16", 8, 2048, 768, None, True),
    (4, "float32", 64, 512, 384, None, False),
    # the bf16 tiles' edges: M_sh 8 packed into one 64-row tile and 16
    # into a 128-row one, K tails short of one box, N short of a box, M_sh
    # 200 over two 128-row tiles a shard
    (4, "bfloat16", 8, 1000, 1032, (64, 64), False),
    (4, "bfloat16", 200, 1000, 1032, (128, 256), True),
    (8, "bfloat16", 16, 72, 520, (128, 256), False),
]


def _gpu_inputs(n, dtype, rows, k, nn, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    dt = getattr(torch, dtype)
    return [tuple(torch.randn(sh, generator=gen, device="cuda").to(dt)
                  for sh in ((rows, k), (k, nn))) for _ in range(n)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_CASES)
def test_gpu_ag_gemm_matches_plain(case):
    _cuda()
    n, dtype, rows, k, nn, tile, rev = case
    g = dist.RankGroup(n, "cuda", timeout_s=60)
    args = _gpu_inputs(n, dtype, rows, k, nn, 1)
    outs = g.spmd(lambda a, b: AG.ag_gemm(a, b, group=g, reverse=rev,
                                          activation="silu", tile=tile),
                  args)
    torch.cuda.synchronize()
    shards = [a for a, _ in args]
    for out, (_, b) in zip(outs, args):
        want = AG.ag_gemm_ref(shards, b, "silu").float()
        _assert_kernel(out.float().cpu().numpy(), want.cpu().numpy(), dtype,
                       k)


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_CASES)
def test_gpu_gemm_rs_matches_plain(case):
    _cuda()
    n, dtype, rows, k, nn, tile, rev = case
    rows *= n
    g = dist.RankGroup(n, "cuda", timeout_s=60)
    args = _gpu_inputs(n, dtype, rows, k, nn, 2)
    bias = torch.randn((nn,), device="cuda").to(getattr(torch, dtype))
    outs = g.spmd(lambda a, b: RS.gemm_rs(a, b, group=g, reverse=rev,
                                          bias=bias, tile=tile), args)
    torch.cuda.synchronize()
    parts = [(a.float() @ b.float()).to(a.dtype) for a, b in args]
    max_partial = max(p.abs().max().item() for p in parts)
    for r, out in enumerate(outs):
        want = RS.reduce_ref(parts, r, None, bias, out.dtype).float()
        _assert_kernel(out.float().cpu().numpy(), want.cpu().numpy(), dtype,
                       k * n, rs=True, max_partial=max_partial)

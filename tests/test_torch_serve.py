"""The serving slice as a whole: the port against the reference, end to end.

On the minicpm_2b, codeqwen15_7b and deepseek_v3_671b (MLA + MoE: one
leading MLA + dense-FFN layer, one MLA + MoE layer) SMOKE_CONFIGs with fp32
compute and fp32 params (so the comparison is of algorithms, not of bf16
rounding), the reference's parameters cross with
``convert.params_from_jax``:

* ``prefill_step`` on a right-padded batch — the reference with
  ``TPContext(use_kernels=True)`` (its Pallas flash kernel, interpreted)
  vs the port with ``kernel_decode=True`` (the flash wrapper, which on CPU
  tensors runs its plain version; MLA prefill attends in plain code on
  both sides): next tokens equal, caches (GQA K/V, MLA latent c/kr)
  within 2e-2 (caches are bf16 on both sides: one bf16 ulp at |x| ~ 2-4);
* 8 dense ``decode_step``s from those caches, copied into an ``s_max``
  cache by the same glue for both frameworks: identical tokens;
* the paged ``Server`` serving 4 staggered requests (multi-chunk prompts,
  a shared prefix): identical token lists to the reference ``Server``, and
  concurrent serving identical to serving each request alone.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from repro.compat import shard_map
from repro.configs.base import ParallelConfig as JaxPar
from repro.configs.base import get_smoke_config as jax_smoke
from repro.models import model as JM
from repro.models import serve as JS
from repro.parallel.sharding import TPContext as JaxCtx
from repro.runtime.server import Request as JaxRequest
from repro.runtime.server import ServeConfig as JaxServeConfig
from repro.runtime.server import Server as JaxServer
from repro_torch import convert
from repro_torch.configs.base import ParallelConfig, get_smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import serve as TS
from repro_torch.parallel.sharding import make_ctx
from repro_torch.runtime.server import Request, ServeConfig, Server

ARCHS = ["minicpm_2b", "codeqwen15_7b", "deepseek_v3_671b"]
B, S, S_MAX, N_DECODE = 2, 64, 80, 8
CACHE_TOL = 2e-2


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg = dataclasses.replace(jax_smoke(arch), compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    jpar = JaxPar(tp=1, dp=1, kernel_decode=True)
    jparams = JM.init_model(jax.random.PRNGKey(0), jcfg, jpar,
                            dtype=jnp.float32)
    if jcfg.qkv_bias:
        # the reference inits the bias to zero; give the bias epilogue
        # something to add
        rng = np.random.default_rng(1)
        mix = jparams["periods"][0]["mixer"]
        mix["bqkv"] = jnp.asarray(
            0.1 * rng.standard_normal(mix["bqkv"].shape), jnp.float32)
    tparams = convert.params_from_jax(_np_tree(jparams), tcfg,
                                      dtype=torch.float32, device="cpu")
    return jcfg, tcfg, jpar, jparams, tparams


def _prompts(cfg):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lengths = np.array([40, S], np.int32)
    toks[0, 40:] = 0                                     # right padding
    return toks, lengths


def _jax_prefill(jcfg, jpar, jparams, toks, lengths):
    specs = JM.param_specs(jcfg, jpar, jparams)
    _, cspec = JS.cache_specs(jcfg, jpar, B, S)
    ctx = JaxCtx(axis="model", dp_axes=("data",), use_kernels=True)

    @jax.jit
    @functools.partial(shard_map, mesh=_mesh(),
                       in_specs=(specs, P("data", None), P("data")),
                       out_specs=(P("data", None), cspec), check_vma=False)
    def fn(p, t, l):
        return JS.prefill_step(p, {"tokens": t}, ctx, jcfg, jpar, lengths=l)

    nxt, caches = fn(jparams, jnp.asarray(toks), jnp.asarray(lengths))
    return np.asarray(nxt), caches


def _to_s_max(a):
    """The glue both frameworks share: a prefill cache [B, S, H, Dh] copied
    into a zero [B, S_MAX, H, Dh] decode cache."""
    out = np.zeros((a.shape[0], S_MAX, *a.shape[2:]), np.float32)
    out[:, :a.shape[1]] = a
    return out


@pytest.fixture(scope="module")
def prefilled(model):
    jcfg, tcfg, jpar, jparams, tparams = model
    toks, lengths = _prompts(jcfg)
    jnxt, jcaches = _jax_prefill(jcfg, jpar, jparams, toks, lengths)
    par = ParallelConfig(kernel_decode=True)
    before = fa.flash_attention.launches
    tnxt, tcaches = TS.prefill_step(tparams, {"tokens": torch.from_numpy(toks)},
                                    make_ctx(par), tcfg,
                                    lengths=torch.from_numpy(lengths))
    assert fa.flash_attention.launches == before   # CPU: plain version
    return toks, lengths, jnxt, jcaches, tnxt, tcaches


def test_prefill_matches_reference_kernel_lane(model, prefilled):
    jcfg = model[0]
    _, _, jnxt, jcaches, tnxt, tcaches = prefilled
    np.testing.assert_array_equal(tnxt.numpy(), jnxt)
    want = convert.caches_from_jax(_np_tree(jcaches), model[1], device="cpu")
    assert len(tcaches) == len(want) == jcfg.num_layers
    for got_l, want_l in zip(tcaches, want):
        assert got_l.keys() == want_l.keys()
        for n in got_l:
            assert got_l[n].dtype == torch.bfloat16
            torch.testing.assert_close(got_l[n].float(), want_l[n].float(),
                                       atol=CACHE_TOL, rtol=CACHE_TOL)


def test_dense_decode_matches_reference(model, prefilled):
    jcfg, tcfg, jpar, jparams, tparams = model
    _, lengths, jnxt, jcaches, tnxt, tcaches = prefilled
    # the same glue for both frameworks' own prefill caches
    jc = {  # lead leaves are [B, S, ...], period leaves [reps, B, S, ...]
        "lead": jax.tree.map(
            lambda a: jnp.asarray(_to_s_max(np.asarray(a, np.float32)),
                                  jnp.bfloat16), jcaches["lead"]),
        "periods": jax.tree.map(
            lambda a: jnp.asarray(np.stack([_to_s_max(x) for x in
                                            np.asarray(a, np.float32)]),
                                  jnp.bfloat16), jcaches["periods"])}
    tc = [{n: torch.from_numpy(_to_s_max(t.float().numpy())).bfloat16()
           for n, t in layer.items()} for layer in tcaches]

    specs = JM.param_specs(jcfg, jpar, jparams)
    _, cspec = JS.cache_specs(jcfg, jpar, B, S_MAX)
    jctx = JaxCtx(axis="model", dp_axes=("data",))

    @jax.jit
    @functools.partial(shard_map, mesh=_mesh(),
                       in_specs=(specs, cspec, P("data", None), P("data")),
                       out_specs=(P("data", None), cspec), check_vma=False)
    def jdecode(p, c, t, pos):
        return JS.decode_step(p, c, t, pos, jctx, jcfg, jpar)

    par = ParallelConfig()
    ctx = make_ctx(par)
    jtok, ttok = jnp.asarray(jnxt), tnxt
    for step in range(N_DECODE):
        pos = lengths + step
        jtok, jc = jdecode(jparams, jc, jtok, jnp.asarray(pos))
        ttok, tc = TS.decode_step(tparams, tc, ttok, torch.from_numpy(pos),
                                  ctx, tcfg)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok),
                                      err_msg=f"decode step {step}")


def test_decode_active_mask_freezes_dense_rows(model, prefilled):
    """``active=False`` rows leave their dense cache rows untouched."""
    _, tcfg, _, _, tparams = model
    _, lengths, _, _, tnxt, tcaches = prefilled
    tc = [{n: torch.from_numpy(_to_s_max(t.float().numpy())).bfloat16()
           for n, t in layer.items()} for layer in tcaches]
    before = [{n: t.clone() for n, t in layer.items()} for layer in tc]
    TS.decode_step(tparams, tc, tnxt, torch.from_numpy(lengths),
                   make_ctx(ParallelConfig()), tcfg,
                   active=torch.tensor([False, True]))
    for got, old in zip(tc, before):
        for n in got:
            assert torch.equal(got[n][0], old[n][0])
            assert not torch.equal(got[n][1], old[n][1])


# ---------------------------------------------------------------------------
# the paged Server
# ---------------------------------------------------------------------------
SERVE_KW = dict(max_batch=2, max_seq=64, eos_token=-1, max_new_tokens=6,
                block_size=8, prefill_chunk=16)


def _serve_prompts(cfg):
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (5, 20, 33, 12)]
    prompts[3] = np.concatenate([prompts[1][:16], prompts[3]])  # shared prefix
    return prompts


def test_server_matches_reference_and_isolated(model):
    jcfg, tcfg, _, jparams, tparams = model
    prompts = _serve_prompts(jcfg)
    jpar = JaxPar(tp=1, dp=1)
    jsrv = JaxServer(jcfg, jpar, _mesh(), jparams, JaxServeConfig(**SERVE_KW))
    want = {r.rid: list(r.output) for r in jsrv.serve(
        [JaxRequest(rid=i, prompt=p) for i, p in enumerate(prompts)])}

    par = ParallelConfig()
    srv = Server(tcfg, par, tparams, ServeConfig(**SERVE_KW))
    done = srv.serve([Request(rid=i, prompt=p) for i, p in enumerate(prompts)])
    got = {r.rid: list(r.output) for r in done}
    assert got == want
    assert all(r.done and r.error is None for r in done)
    assert srv.pool.reuse_hits == jsrv.pool.reuse_hits >= 1

    for i, p in enumerate(prompts):
        alone = Server(tcfg, par, tparams, ServeConfig(**SERVE_KW))
        assert alone.serve([Request(rid=i, prompt=p)])[0].output == got[i], i

"""Decode, the chunked prefill and the replicated layout at tp=4: the port's
ranks against the reference.

The reference runs once for the whole file, in one subprocess with 4 forced
host devices (``conftest.run_subprocess_devices``), under ``shard_map``;
the port runs the same numpy inputs as the 4 ranks of a ``dist.RankGroup``
on the CPU, in each of the modes xla, decomposed and flux (the reference
runs decomposed: its values do not depend on the mode).

* ``FusedOp(kind="ar")`` and the hidden-layout ag (bias epilogue) and rs at
  4 ranks: fp32 within 1e-5; bf16 within 2e-2 (outputs ~1: a few bf16
  ulps, the partials rounded to bf16 on both sides and summed in another
  order).
* On the minicpm_2b and codeqwen15_7b (QKV bias) SMOKE_CONFIGs, fp32
  compute and fp32 params (the reference's, drawn at tp=4, cut per rank by
  ``convert.rank_params_from_jax``):

  - ``decode_step``, 8 steps from the reference's tp=4 prefill caches,
    dense (row 1 inactive: its cache rows stay as they were) and paged
    (shuffled block tables; row 1 inactive through an all-zero table row):
    next tokens equal on every rank and equal to the reference's at every
    step; each step's logits (the ranks' vocab shards concatenated) within
    relative L2 1e-5 (fp32 sums in another order); the caches (bf16 on both
    sides) within 2e-2, one bf16 ulp at |x| ~ 2-4;
  - ``prefill_chunk_step`` over a 16-token prompt (its last chunk ends on
    the chunk boundary) and a 20-token one (a ragged last chunk of 4): each
    chunk's tokens, the pools within 2e-2, the first chunk's logits within
    relative L2 1e-5 and the later chunks' within 1e-4 (they read K/V rows
    each side rounded to bf16 itself);
  - ``prefill_logits`` in the replicated layout (``ctx.with_layout(False)``)
    against the reference's with ``seq_shard=False`` (relative L2 1e-5,
    equal next tokens), and against the port's own sequence-sharded
    prefill at tp=4 and its tp=1 prefill with the same seed (relative L2
    1e-5).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert, dist
from repro_torch.configs.base import ParallelConfig, get_smoke_config
from repro_torch.core import overlap as tov
from repro_torch.models import model as TM
from repro_torch.models import serve as TS
from repro_torch.parallel.sharding import TPContext, make_ctx

ARCHS = ["minicpm_2b", "codeqwen15_7b"]
MODES = ["xla", "decomposed", "flux"]
TP = 4
B, S, S_MAX, N_DECODE = 2, 64, 80, 8
LENGTHS = [40, 64]
ACTIVE = [True, False]
BLOCK = 8
PAGES = S_MAX // BLOCK
NUM_BLOCKS = 1 + B * PAGES
CHUNK = 8
CHUNK_PROMPTS = [16, 20]
CACHE_TOL = 2e-2
LOGIT_RTOL = 1e-5
# a chunk after the first attends over K/V rows that each side computed in
# fp32 and rounded to bf16 itself: a 1e-7 difference can round one cache
# element a bf16 ulp (2^-8 relative) apart (3.2e-5 measured on chunk 1)
CHUNK_LOGIT_RTOL = 1e-4
OP_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
OB, OM, OF, OD = 2, 3, 32, 32        # ops: y [OB, OM, OF], w [OF, OD]

_REF = r"""
import dataclasses, functools
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.configs.base import get_smoke_config, ParallelConfig
from repro.core import overlap as ov
from repro.models import model as M, serve as S
from repro.parallel.sharding import TPContext

inp = dict(np.load(IN))
out = {}
DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

# ---- the ops -------------------------------------------------------------
tmesh = Mesh(np.array(jax.devices()), ("tp",))


def smap(fn, in_specs):
    # every rank's output, stacked: [N, ...]
    return jax.jit(functools.partial(
        shard_map, mesh=tmesh, in_specs=in_specs, out_specs=P("tp"),
        check_vma=False)(lambda *a: fn(*a)[None]))


for dt in ("float32", "bfloat16"):
    y, w, x, w1, bias = (jnp.asarray(inp["op/" + k], DT[dt])
                         for k in ("y", "w", "x", "w1", "bias"))
    col, row = P(None, None, "tp"), P("tp", None)
    ar = ov.FusedOp("ar", axis="tp", mode="decomposed")
    rs = ov.FusedOp("rs", axis="tp", mode="decomposed",
                    scatter_axis="hidden")
    ag = ov.FusedOp("ag", axis="tp", mode="decomposed",
                    scatter_axis="hidden", epilogue=ov.Epilogue(bias=True))
    for mode in %(modes)r:
        ar, rs, ag = (dataclasses.replace(o, mode=mode) for o in (ar, rs, ag))
        out[f"op/{dt}/{mode}/ar"] = np.asarray(
            smap(ar, (col, row))(y, w), np.float32)
        out[f"op/{dt}/{mode}/rs"] = np.asarray(
            smap(rs, (col, row))(y, w), np.float32)
        out[f"op/{dt}/{mode}/ag"] = np.asarray(smap(
            lambda a, b, c: ag(a, b, bias=c), (P(), P(None, "tp"), P("tp"))
        )(x, w1, bias), np.float32)

# ---- the model -----------------------------------------------------------
seen = {}
_argmax = S.vocab_parallel_argmax


def _capture(logits_loc, *a, **k):
    seen["logits"] = logits_loc
    return _argmax(logits_loc, *a, **k)


S.vocab_parallel_argmax = _capture
mesh = Mesh(np.array(jax.devices()).reshape(1, 4), ("data", "model"))
kv = P(None, None, None, "model", None)
LOGITS = P(None, "model")
for arch in %(archs)r:
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    par = ParallelConfig(tp=4, dp=1)
    params = M.init_model(jax.random.PRNGKey(0), cfg, par, dtype=jnp.float32)
    if cfg.qkv_bias:   # the reference inits the bias to zero
        mix = params["periods"][0]["mixer"]
        rng = np.random.default_rng(1)
        mix["bqkv"] = jnp.asarray(
            0.1 * rng.standard_normal(mix["bqkv"].shape), jnp.float32)
    specs = M.param_specs(cfg, par, params)
    cspec = {"lead": [], "periods": [
        {"mixer": {"k": kv, "v": kv}, "ffn": {}} for _ in cfg.pattern]}
    toks, lengths = jnp.asarray(inp["tokens"]), jnp.asarray(inp["lengths"])

    def prefill_fn(ctx):
        @jax.jit
        @functools.partial(shard_map, mesh=mesh, in_specs=(specs, P(), P()),
                           out_specs=(P(), cspec, LOGITS), check_vma=False)
        def fn(p, t, l):
            nxt, caches = S.prefill_step(p, {"tokens": t}, ctx, cfg, par, l)
            return nxt, caches, seen.pop("logits")
        return fn

    nxt, caches, logits = prefill_fn(TPContext(axis="model"))(
        params, toks, lengths)
    out[arch + "/prefill/next"] = np.asarray(nxt)
    nxt_h, _, logits_h = prefill_fn(TPContext(axis="model", seq_shard=False))(
        params, toks, lengths)
    out[arch + "/hidden/next"] = np.asarray(nxt_h)
    out[arch + "/hidden/logits"] = np.asarray(logits_h, np.float32)

    per = caches["periods"][0]["mixer"]          # [reps, B, S, H, Dh]
    dense = {}
    for name in ("k", "v"):
        a = np.asarray(per[name], np.float32)
        out[f"{arch}/prefill/{name}"] = a
        z = np.zeros(a.shape[:2] + (int(inp["s_max"]),) + a.shape[3:],
                     np.float32)
        z[:, :, :a.shape[2]] = a
        dense[name] = z
    bt = inp["bt"]
    pools = {}
    for name in ("k", "v"):
        pool = np.zeros((dense[name].shape[0], int(inp["num_blocks"]),
                         int(inp["block"])) + dense[name].shape[3:],
                        np.float32)
        for b in range(bt.shape[0]):
            for pg in range(bt.shape[1]):
                blk = int(inp["block"])
                pool[:, bt[b, pg]] = dense[name][
                    :, b, pg * blk:(pg + 1) * blk]
        pools[name] = pool
    active = jnp.asarray(inp["active"])
    bt_run = jnp.asarray(np.where(inp["active"][:, None], bt, 0))

    @jax.jit
    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(specs, cspec, P(), P(), P(), P()),
                       out_specs=(P(), cspec, LOGITS), check_vma=False)
    def decode(p, c, t, pos, tables, act):
        nxt, c = S.decode_step(p, c, t, pos, TPContext(axis="model"), cfg,
                               par, block_tables=tables, active=act)
        return nxt, c, seen.pop("logits")

    for kind, tables, start in (("dense", None, dense),
                                ("paged", bt_run, pools)):
        c = {"lead": [], "periods": [{"mixer": {
            n: jnp.asarray(start[n], jnp.bfloat16) for n in ("k", "v")},
            "ffn": {}}]}
        tok = nxt
        for step in range(int(inp["n_decode"])):
            tok, c, lg = decode(params, c, tok, lengths + step, tables,
                                active)
            out[f"{arch}/{kind}/{step}/next"] = np.asarray(tok)
            out[f"{arch}/{kind}/{step}/logits"] = np.asarray(lg, np.float32)
        for n in ("k", "v"):
            out[f"{arch}/{kind}/{n}"] = np.asarray(
                c["periods"][0]["mixer"][n], np.float32)

    @jax.jit
    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(specs, cspec, P(), P(), P(), P(), P()),
                       out_specs=(P(), cspec, LOGITS), check_vma=False)
    def chunk(p, c, t, tables, slot, off, clen):
        nxt, c = S.prefill_chunk_step(p, c, t, tables, slot, off, clen,
                                      TPContext(axis="model"), cfg, par)
        return nxt, c, seen.pop("logits")

    for n_prompt in (int(v) for v in inp["chunk_prompts"]):
        shape = pools["k"].shape
        c = {"lead": [], "periods": [{"mixer": {
            n: jnp.zeros(shape, jnp.bfloat16) for n in ("k", "v")},
            "ffn": {}}]}
        prompt = inp["tokens"][0, :n_prompt]
        off, i = 0, 0
        while off < n_prompt:
            clen = min(int(inp["chunk"]), n_prompt - off)
            t = np.zeros((1, int(inp["chunk"])), np.int32)
            t[0, :clen] = prompt[off:off + clen]
            nxt_c, c, lg = chunk(params, c, jnp.asarray(t),
                                 jnp.asarray(inp["bt"][:1]), 0, off, clen)
            out[f"{arch}/chunk{n_prompt}/{i}/next"] = np.asarray(nxt_c)
            out[f"{arch}/chunk{n_prompt}/{i}/logits"] = np.asarray(
                lg, np.float32)
            off, i = off + clen, i + 1
        for n in ("k", "v"):
            out[f"{arch}/chunk{n_prompt}/{n}"] = np.asarray(
                c["periods"][0]["mixer"][n], np.float32)

    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    for path, leaf in flat:
        key = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                       for q in path)
        out[f"{arch}/params/{key}"] = np.asarray(leaf, np.float32)
np.savez(OUT, **out)
print("REF_OK")
"""


def _bf16(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


def _inputs():
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 512, (B, S)).astype(np.int32)
    for b, n in enumerate(LENGTHS):
        toks[b, n:] = 0                      # right padding
    # each row's pages in shuffled physical blocks 1..B*PAGES (0: null)
    bt = (1 + rng.permutation(B * PAGES)).reshape(B, PAGES).astype(np.int32)
    inp = {"tokens": toks, "lengths": np.array(LENGTHS, np.int32),
           "active": np.array(ACTIVE), "bt": bt, "s_max": S_MAX,
           "block": BLOCK, "num_blocks": NUM_BLOCKS, "n_decode": N_DECODE,
           "chunk": CHUNK, "chunk_prompts": np.array(CHUNK_PROMPTS)}
    for key, shape, scale in (("y", (OB, OM, OF), 1.0),
                              ("w", (OF, OD), OF ** -0.5),
                              ("x", (OB, OM, OD), 1.0),
                              ("w1", (OD, OF), OD ** -0.5),
                              ("bias", (OF,), 1.0)):
        inp["op/" + key] = _bf16(scale * rng.standard_normal(
            shape, dtype=np.float32))
    return inp


@pytest.fixture(scope="module")
def ref(tmp_path_factory, subproc):
    """(inputs, the reference's outputs), from one 4-device subprocess."""
    d = tmp_path_factory.mktemp("tp_decode")
    inp = _inputs()
    np.savez(d / "in.npz", **inp)
    code = (_REF % {"archs": ARCHS, "modes": MODES}).replace(
        "IN)", repr(str(d / "in.npz")) + ")").replace(
        "OUT,", repr(str(d / "out.npz")) + ",")
    assert "REF_OK" in subproc(code, n_devices=TP)
    return inp, dict(np.load(d / "out.npz"))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _cut(a, r, dim):
    return np.split(a, TP, axis=dim)[r]


def _cfg(arch):
    return dataclasses.replace(get_smoke_config(arch),
                               compute_dtype="float32")


def _tree(flat, prefix):
    """The reference's nested params from "a/0/b"-keyed numpy leaves."""
    root = {}
    for key, leaf in flat.items():
        if not key.startswith(prefix):
            continue
        parts = key[len(prefix):].split("/")
        node = root
        for i, p in enumerate(parts[:-1]):
            nxt = [] if parts[i + 1].isdigit() else {}
            if isinstance(node, list):
                p = int(p)
                while len(node) <= p:
                    node.append(None)
                if node[p] is None:
                    node[p] = nxt
                node = node[p]
            else:
                node = node.setdefault(p, nxt)
        node[parts[-1]] = leaf
    return root


def _ranks(out, arch, cfg):
    return convert.rank_params_from_jax(_tree(out, f"{arch}/params/"), cfg,
                                        TP, dtype=torch.float32,
                                        device="cpu")


def _ctx(group, mode):
    return make_ctx(ParallelConfig(tp=TP, overlap_mode=mode), group)


def _rank_caches(glob, r):
    """The reference's stacked [layers, ...heads at dim 3...] K/V -> rank
    r's per-layer bf16 caches of its KV heads."""
    return [{n: _t(_cut(glob[n][layer], r, 2), torch.bfloat16)
             for n in ("k", "v")} for layer in range(glob["k"].shape[0])]


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _check_step(outs, out, key, what, rtol=LOGIT_RTOL):
    """Every rank's (tokens, logits) against the reference's at ``key``."""
    want = out[key + "/next"].reshape(-1)
    for tok, _ in outs:
        np.testing.assert_array_equal(tok.reshape(-1).numpy(), want,
                                      err_msg=what)
    got = torch.cat([lg for _, lg in outs], dim=-1).numpy()
    rel = _rel(got, out[key + "/logits"])
    assert rel <= rtol, (what, rel)


def _check_caches(caches, want, what):
    for layer in range(want["k"].shape[0]):
        for n in ("k", "v"):
            got = torch.cat([c[layer][n] for c in caches], dim=2)
            assert got.dtype == torch.bfloat16
            np.testing.assert_allclose(got.float().numpy(), want[n][layer],
                                       atol=CACHE_TOL, rtol=CACHE_TOL,
                                       err_msg=f"{what} layer {layer} {n}")


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_ar_and_hidden_ops_match_reference(ref, mode, dtype):
    inp, out = ref
    dt = getattr(torch, dtype)
    tol = OP_TOL[dtype]
    g = dist.RankGroup(TP, "cpu", timeout_s=60)
    y, w, x, w1, bias = (inp["op/" + k] for k in ("y", "w", "x", "w1",
                                                  "bias"))
    row_args = [(_t(_cut(y, r, 2), dt), _t(_cut(w, r, 0), dt))
                for r in range(TP)]
    for kind, op in (("ar", tov.FusedOp("ar", axis=g, mode=mode)),
                     ("rs", tov.FusedOp("rs", axis=g, mode=mode,
                                        scatter_axis="hidden"))):
        got = g.spmd(op, row_args)
        for r, o in enumerate(got):
            assert o.dtype == dt and o.shape == (OB, OM, OD)
            np.testing.assert_allclose(o.float().numpy(),
                                       out[f"op/{dtype}/{mode}/{kind}"][r],
                                       atol=tol, rtol=tol,
                                       err_msg=f"{kind} rank {r}")
    ag = tov.FusedOp("ag", axis=g, mode=mode, scatter_axis="hidden",
                     epilogue=tov.Epilogue(bias=True))
    got = g.spmd(lambda a, b, c: ag(a, b, bias=c),
                 [(_t(x, dt), _t(_cut(w1, r, 1), dt), _t(_cut(bias, r, 0),
                                                         dt))
                  for r in range(TP)])
    want = out[f"op/{dtype}/{mode}/ag"]          # [N, OB, OM, OF/N]
    np.testing.assert_allclose(torch.stack(got).float().numpy(), want,
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# decode and the chunked prefill
# ---------------------------------------------------------------------------
def _dense_start(out, arch, r):
    """Rank r's dense [B, S_MAX] caches from the reference's prefill."""
    caches = []
    pre = {n: out[f"{arch}/prefill/{n}"] for n in ("k", "v")}
    for layer in range(pre["k"].shape[0]):
        lc = {}
        for n in ("k", "v"):
            a = _cut(pre[n][layer], r, 2)
            z = np.zeros((a.shape[0], S_MAX) + a.shape[2:], np.float32)
            z[:, :a.shape[1]] = a
            lc[n] = _t(z, torch.bfloat16)
        caches.append(lc)
    return caches


def _paged_start(dense, bt):
    """The same caches scattered into [NUM_BLOCKS, BLOCK] pools through the
    block tables (block 0, the null block, stays zero)."""
    pools = []
    for lc in dense:
        lp = {}
        for n, t in lc.items():
            pool = torch.zeros((NUM_BLOCKS, BLOCK) + t.shape[2:],
                               dtype=t.dtype)
            for b in range(bt.shape[0]):
                for pg in range(bt.shape[1]):
                    pool[bt[b, pg]] = t[b, pg * BLOCK:(pg + 1) * BLOCK]
            lp[n] = pool
        pools.append(lp)
    return pools


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_tp4_matches_reference(ref, arch, mode, paged):
    inp, out = ref
    cfg = _cfg(arch)
    ranks = _ranks(out, arch, cfg)
    g = dist.RankGroup(TP, "cpu", timeout_s=60)
    ctx = _ctx(g, mode)
    kind = "paged" if paged else "dense"
    caches = [_dense_start(out, arch, r) for r in range(TP)]
    active = torch.tensor(ACTIVE)
    tables = None
    if paged:
        caches = [_paged_start(c, inp["bt"]) for c in caches]
        tables = _t(np.where(inp["active"][:, None], inp["bt"], 0),
                    torch.long)
    lengths = torch.tensor(LENGTHS)
    tok = torch.from_numpy(out[arch + "/prefill/next"]).long()
    for step in range(N_DECODE):
        def body(p, c, t=tok, pos=lengths + step):
            lg, _ = TS.decode_logits(p, c, t, pos, ctx, cfg,
                                     block_tables=tables, active=active)
            return TS.vocab_parallel_argmax(lg, cfg.vocab_size, ctx), lg

        outs = g.spmd(body, list(zip(ranks, caches)))
        _check_step(outs, out, f"{arch}/{kind}/{step}",
                    f"{kind} {mode} step {step}")
        # decode_step itself returns those tokens on every rank
        tok = outs[0][0][:, None]
    want = {n: out[f"{arch}/{kind}/{n}"] for n in ("k", "v")}
    _check_caches(caches, want, f"{kind} {mode}")
    if not paged:
        # the inactive row's cache rows are the prefill's, untouched
        for r in range(TP):
            start = _dense_start(out, arch, r)
            for got, old in zip(caches[r], start):
                for n in ("k", "v"):
                    assert torch.equal(got[n][1], old[n][1])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_tp4_tokens_equal_on_every_rank(ref, arch, mode):
    """``decode_step`` (the entry point the Server calls) returns the
    reference's next tokens on every rank, dense, every row active."""
    _, out = ref
    cfg = _cfg(arch)
    ranks = _ranks(out, arch, cfg)
    g = dist.RankGroup(TP, "cpu", timeout_s=60)
    ctx = _ctx(g, mode)
    caches = [_dense_start(out, arch, r) for r in range(TP)]
    tok = torch.from_numpy(out[arch + "/prefill/next"]).long()
    got = g.spmd(lambda p, c: TS.decode_step(p, c, tok, torch.tensor(LENGTHS),
                                             ctx, cfg)[0],
                 list(zip(ranks, caches)))
    # row 0 is active in the reference's first step: its token is the same
    want = out[f"{arch}/dense/0/next"].reshape(-1)
    for t in got:
        assert t.shape == (B, 1)
        assert torch.equal(t, got[0])
        assert int(t[0, 0]) == int(want[0])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_tp4_matches_reference(ref, arch, mode):
    inp, out = ref
    cfg = _cfg(arch)
    ranks = _ranks(out, arch, cfg)
    g = dist.RankGroup(TP, "cpu", timeout_s=60)
    ctx = _ctx(g, mode)
    bt = _t(inp["bt"][:1], torch.long)
    for n_prompt in CHUNK_PROMPTS:
        shape = out[f"{arch}/chunk{n_prompt}/k"].shape   # [L, N, bs, H, Dh]
        pools = [[{n: torch.zeros((NUM_BLOCKS, BLOCK, shape[3] // TP,
                                   shape[4]), dtype=torch.bfloat16)
                   for n in ("k", "v")} for _ in range(shape[0])]
                 for _ in range(TP)]
        prompt = inp["tokens"][0, :n_prompt]
        off, i = 0, 0
        while off < n_prompt:
            clen = min(CHUNK, n_prompt - off)
            t = np.zeros((1, CHUNK), np.int64)
            t[0, :clen] = prompt[off:off + clen]
            t = torch.from_numpy(t)

            def body(p, c, t=t, off=off, clen=clen):
                lg, _ = TS.prefill_chunk_logits(p, c, t, bt, off, clen, ctx,
                                                cfg)
                return TS.vocab_parallel_argmax(lg, cfg.vocab_size, ctx), lg

            outs = g.spmd(body, list(zip(ranks, pools)))
            _check_step(outs, out, f"{arch}/chunk{n_prompt}/{i}",
                        f"chunk {i} of {n_prompt} ({mode})",
                        LOGIT_RTOL if i == 0 else CHUNK_LOGIT_RTOL)
            off, i = off + clen, i + 1
        want = {n: out[f"{arch}/chunk{n_prompt}/{n}"] for n in ("k", "v")}
        _check_caches(pools, want, f"chunked {n_prompt} {mode}")


# ---------------------------------------------------------------------------
# the replicated-layout prefill
# ---------------------------------------------------------------------------
def _prefill(ranks, cfg, par, fn=TS.prefill_logits, seq_sharded=False):
    g = dist.RankGroup(TP, "cpu", timeout_s=60)
    ctx = make_ctx(par, g).with_layout(seq_sharded)
    toks, lengths = (torch.from_numpy(_inputs()[k]) for k in ("tokens",
                                                              "lengths"))
    return ctx, g.spmd(lambda p: fn(p, {"tokens": toks}, ctx, cfg,
                                    lengths.long()), [(p,) for p in ranks])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_hidden_tp4_matches_reference(ref, arch, mode):
    _, out = ref
    cfg = _cfg(arch)
    par = ParallelConfig(tp=TP, overlap_mode=mode)
    ctx, outs = _prefill(_ranks(out, arch, cfg), cfg, par)
    assert not ctx.seq_sharded
    got = torch.cat([lg for lg, _ in outs], dim=-1).numpy()
    rel = _rel(got, out[arch + "/hidden/logits"])
    assert rel <= LOGIT_RTOL, (mode, rel)
    _, nxt = _prefill(_ranks(out, arch, cfg), cfg, par, TS.prefill_step)
    for n, _ in nxt:
        np.testing.assert_array_equal(n.numpy(), out[arch + "/hidden/next"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_hidden_equals_seq_layout_and_tp1(arch):
    """The port's replicated-layout prefill at tp=4 against its
    sequence-sharded one at tp=4 and its tp=1 prefill, same seed."""
    cfg = _cfg(arch)
    p1 = TM.init_model(cfg, ParallelConfig(), seed=0, dtype=torch.float32,
                       device="cpu")
    full = TM.init_model(cfg, ParallelConfig(tp=TP), seed=0,
                         dtype=torch.float32, device="cpu")
    ranks = [TM.shard_params(full, r, TP, cfg) for r in range(TP)]
    inp = _inputs()
    toks = torch.from_numpy(inp["tokens"])
    lengths = torch.from_numpy(inp["lengths"]).long()
    want, _ = TS.prefill_logits(p1, {"tokens": toks}, TPContext(), cfg,
                                lengths)
    for mode in MODES:
        got = {}
        for axis in ("seq", "hidden"):
            _, outs = _prefill(ranks, cfg, ParallelConfig(
                tp=TP, overlap_mode=mode), seq_sharded=axis == "seq")
            got[axis] = torch.cat([lg for lg, _ in outs], dim=-1)
        for what, a, b in (("hidden vs seq", got["hidden"], got["seq"]),
                           ("hidden vs tp=1", got["hidden"], want)):
            rel = ((a - b).norm() / b.norm()).item()
            assert rel <= LOGIT_RTOL, (mode, what, rel)

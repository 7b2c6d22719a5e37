"""DeepSeek-V3 (MLA + MoE) served at tp=4: the port's ranks against the
reference.

The reference runs once for the whole file, in one subprocess with 4 forced
host devices (``conftest.run_subprocess_devices``), under ``shard_map``
(its ``Server`` through ``make_mesh(1, 1, 4)``); the port runs the same
numpy inputs as the 4 ranks of a ``dist.RankGroup`` on the CPU, in each of
the modes xla, decomposed and flux (the reference runs decomposed: its
values do not depend on the mode).  The model is the deepseek_v3_671b
SMOKE_CONFIG (one leading MLA + dense layer, one MLA + MoE layer; 4 heads
and 4 experts, one of each a rank; top-2 at the config's capacity factor),
fp32 compute and fp32 params, the reference's drawn at tp=4 and cut per
rank by ``convert.rank_params_from_jax``.  Expert parallelism runs over
the TP ranks in both.  Row 0 of the batch is right-padded inside the last
sequence shard.

* ``prefill_logits`` / ``prefill_step`` in the sequence-sharded layout
  (each rank routes its own shard, the ``moe_a2a`` exchange across the
  ranks) and the replicated one (local experts and a psum): the last
  position's logits (the ranks' vocab shards concatenated) within
  relative L2 1e-5, next tokens equal on every rank and to the
  reference's; the latent caches, whole on every rank, within 2e-2 (bf16
  on both sides).
* ``decode_step``, 8 steps from the reference's prefill caches, dense (row
  1 inactive: its cache rows stay as they were) and paged (shuffled block
  tables; row 1 inactive through an all-zero table row): each step's
  tokens on every rank and the reference's, its logits within 1e-5, the
  caches within 2e-2.
* ``prefill_chunk_step`` over a 16-token prompt and a 20-token one (a
  ragged last chunk of 4): each chunk's tokens and logits (1e-5 for the
  first chunk, 1e-4 after: later chunks read latent rows each side
  rounded to bf16 itself), the pools within 2e-2.
* The paged ``Server`` at tp=4: 4 staggered requests (one sharing a prefix)
  with the reference Server's tokens and reuse hits, each equal to serving
  it alone; the same requests again, reusing every full prompt block; a
  pool too small to keep every freed prefix, which evicts as the
  reference's does, tokens unchanged.  And the serve CLI on the smoke
  config at ``--tp 4`` (bf16) against its tp=1 run: first tokens.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert, dist
from repro_torch.configs.base import ParallelConfig, get_smoke_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import ffn as TF
from repro_torch.models import serve as TS
from repro_torch.parallel.sharding import make_ctx
from repro_torch.runtime.server import Request, ServeConfig, Server

ARCH = "deepseek_v3_671b"
MODES = ["xla", "decomposed", "flux"]
TP = 4
B, S, S_MAX, N_DECODE = 2, 64, 80, 8
LENGTHS = [58, 64]                  # row 0's padding: the last shard only
ACTIVE = [True, False]
BLOCK = 8
PAGES = S_MAX // BLOCK
NUM_BLOCKS = 1 + B * PAGES
CHUNK = 8
CHUNK_PROMPTS = [16, 20]
CACHE_TOL = 2e-2
LOGIT_RTOL = 1e-5
CHUNK_LOGIT_RTOL = 1e-4
SERVE_KW = dict(max_batch=2, max_seq=64, eos_token=-1, max_new_tokens=6,
                block_size=8, prefill_chunk=16)
EVICT_KW = dict(SERVE_KW, block_size=4, num_blocks=11)

_REF = r"""
import dataclasses, functools
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.configs.base import get_smoke_config, ParallelConfig
from repro.launch.mesh import make_mesh
from repro.models import model as M, serve as S
from repro.parallel.sharding import TPContext
from repro.runtime.server import Request, ServeConfig, Server

inp = dict(np.load(IN))
out = {}
seen = {}
_argmax = S.vocab_parallel_argmax


def _capture(logits_loc, *a, **k):
    seen["logits"] = logits_loc
    return _argmax(logits_loc, *a, **k)


S.vocab_parallel_argmax = _capture
mesh = Mesh(np.array(jax.devices()).reshape(1, 4), ("data", "model"))
LOGITS = P(None, "model")
cfg = dataclasses.replace(get_smoke_config("deepseek_v3_671b"),
                          compute_dtype="float32")
par = ParallelConfig(tp=4, dp=1)
params = M.init_model(jax.random.PRNGKey(0), cfg, par, dtype=jnp.float32)
specs = M.param_specs(cfg, par, params)
B, S_LEN = inp["tokens"].shape
S_MAX, BLK, NB = (int(inp[k]) for k in ("s_max", "block", "num_blocks"))
_, cspec = S.cache_specs(cfg, par, B, S_LEN)
_, pspec = S.paged_cache_specs(cfg, par, NB, BLK, B)
toks, lengths = jnp.asarray(inp["tokens"]), jnp.asarray(inp["lengths"])


def put(tree, key):
    for i, layer in enumerate(tree["lead"]):
        for n, a in layer["mixer"].items():
            out[f"{key}/lead{i}/{n}"] = np.asarray(a, np.float32)
    for i, layer in enumerate(tree["periods"]):
        for n, a in layer["mixer"].items():
            out[f"{key}/period{i}/{n}"] = np.asarray(a, np.float32)


def prefill_fn(ctx):
    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=(specs, P(), P()),
                       out_specs=(P(), cspec, LOGITS), check_vma=False)
    def fn(p, t, l):
        nxt, caches = S.prefill_step(p, {"tokens": t}, ctx, cfg, par, l)
        return nxt, caches, seen.pop("logits")
    return fn


for layout, ctx in (("seq", TPContext(axis="model")),
                    ("hidden", TPContext(axis="model", seq_shard=False))):
    nxt, caches, logits = prefill_fn(ctx)(params, toks, lengths)
    out[f"{layout}/next"] = np.asarray(nxt)
    out[f"{layout}/logits"] = np.asarray(logits, np.float32)
    put(caches, f"{layout}/cache")
    if layout == "seq":
        prefill_next, prefill_caches = nxt, caches


def dense_of(a, stacked):
    ax = 2 if stacked else 1
    pad = [(0, 0)] * a.ndim
    pad[ax] = (0, S_MAX - a.shape[ax])
    return jnp.pad(a, pad)


def pool_of(a, stacked):
    bt = inp["bt"]
    lead = a.shape[:1] if stacked else ()
    a = dense_of(a, stacked)
    pool = jnp.zeros(lead + (NB, BLK) + a.shape[len(lead) + 2:], a.dtype)
    for b in range(bt.shape[0]):
        for pg in range(bt.shape[1]):
            rows = a[..., b, pg * BLK:(pg + 1) * BLK, :] if stacked else \
                a[b, pg * BLK:(pg + 1) * BLK]
            pool = pool.at[..., int(bt[b, pg]), :, :].set(rows)
    return pool


def start(of):
    return {"lead": [{"mixer": {n: of(a, False) for n, a in
                                l["mixer"].items()}, "ffn": {}}
                     for l in prefill_caches["lead"]],
            "periods": [{"mixer": {n: of(a, True) for n, a in
                                   l["mixer"].items()}, "ffn": {}}
                        for l in prefill_caches["periods"]]}


_, dspec = S.cache_specs(cfg, par, B, S_MAX)
active = jnp.asarray(inp["active"])
bt_run = jnp.asarray(np.where(inp["active"][:, None], inp["bt"], 0))
for kind, tables, c, spec in (("dense", None, start(dense_of), dspec),
                              ("paged", bt_run, start(pool_of), pspec)):
    @jax.jit
    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(specs, spec, P(), P(), P(), P()),
                       out_specs=(P(), spec, LOGITS), check_vma=False)
    def decode(p, c, t, pos, tables, act):
        nxt, c = S.decode_step(p, c, t, pos, TPContext(axis="model"), cfg,
                               par, block_tables=tables, active=act)
        return nxt, c, seen.pop("logits")

    tok = prefill_next
    for step in range(int(inp["n_decode"])):
        tok, c, lg = decode(params, c, tok, lengths + step, tables, active)
        out[f"{kind}/{step}/next"] = np.asarray(tok)
        out[f"{kind}/{step}/logits"] = np.asarray(lg, np.float32)
    put(c, f"{kind}/cache")


@jax.jit
@functools.partial(shard_map, mesh=mesh,
                   in_specs=(specs, pspec, P(), P(), P(), P(), P()),
                   out_specs=(P(), pspec, LOGITS), check_vma=False)
def chunk(p, c, t, tables, slot, off, clen):
    nxt, c = S.prefill_chunk_step(p, c, t, tables, slot, off, clen,
                                  TPContext(axis="model"), cfg, par)
    return nxt, c, seen.pop("logits")


zeros = jax.tree.map(lambda a: jnp.zeros_like(a), start(pool_of))
for n_prompt in (int(v) for v in inp["chunk_prompts"]):
    c = zeros
    prompt = inp["tokens"][1, :n_prompt]
    off, i = 0, 0
    while off < n_prompt:
        clen = min(int(inp["chunk"]), n_prompt - off)
        t = np.zeros((1, int(inp["chunk"])), np.int32)
        t[0, :clen] = prompt[off:off + clen]
        nxt_c, c, lg = chunk(params, c, jnp.asarray(t),
                             jnp.asarray(inp["bt"][:1]), 0, off, clen)
        out[f"chunk{n_prompt}/{i}/next"] = np.asarray(nxt_c)
        out[f"chunk{n_prompt}/{i}/logits"] = np.asarray(lg, np.float32)
        off, i = off + clen, i + 1
    put(c, f"chunk{n_prompt}/cache")

S.vocab_parallel_argmax = _argmax
smesh = make_mesh(1, 1, 4)
for case, kw in (("serve", %(serve_kw)r), ("evict", %(evict_kw)r)):
    prompts = [inp[f"{case}/{i}"] for i in range(int(inp[case + "/n"]))]
    srv = Server(cfg, par, smesh, params, ServeConfig(**kw))
    done = srv.serve([Request(rid=i, prompt=p)
                      for i, p in enumerate(prompts)])
    for r in done:
        out[f"{case}/{r.rid}"] = np.asarray(r.output, np.int32)
    out[f"{case}/reuse_hits"] = np.asarray(srv.pool.reuse_hits)
    out[f"{case}/evictions"] = np.asarray(srv.pool.evictions)

flat, _ = jax.tree_util.tree_flatten_with_path(params)
for path, leaf in flat:
    key = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                   for q in path)
    out[f"params/{key}"] = np.asarray(leaf, np.float32)
np.savez(OUT, **out)
print("REF_OK")
"""


def _prompts():
    rng = np.random.default_rng(7)
    serve = [rng.integers(0, 512, size=(n,)).astype(np.int32)
             for n in (5, 20, 33, 12)]
    serve[3] = np.concatenate([serve[1][:16], serve[3]])   # shared prefix
    rng = np.random.default_rng(13)
    uniq = [rng.integers(0, 512, size=(12,)).astype(np.int32)
            for _ in range(3)]
    return {"serve": serve, "evict": uniq + [uniq[0].copy()]}


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
    for case, prompts in _prompts().items():
        inp[case + "/n"] = np.asarray(len(prompts))
        for i, p in enumerate(prompts):
            inp[f"{case}/{i}"] = p
    return inp


@pytest.fixture(scope="module")
def ref(tmp_path_factory, subproc):
    """(inputs, the reference's outputs), from one 4-device subprocess."""
    d = tmp_path_factory.mktemp("tp_mla_moe")
    inp = _inputs()
    np.savez(d / "in.npz", **inp)
    code = (_REF % {"serve_kw": SERVE_KW, "evict_kw": EVICT_KW}).replace(
        "IN)", repr(str(d / "in.npz")) + ")").replace(
        "OUT,", repr(str(d / "out.npz")) + ",")
    assert "REF_OK" in subproc(code, n_devices=TP)
    return inp, dict(np.load(d / "out.npz"))


def _cfg():
    return dataclasses.replace(get_smoke_config(ARCH),
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


def _ranks(out, cfg):
    return convert.rank_params_from_jax(_tree(out, "params/"), cfg, TP,
                                        dtype=torch.float32, device="cpu")


def _ctx(group, mode):
    return make_ctx(ParallelConfig(tp=TP, overlap_mode=mode), group)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _layers(out, key):
    """The reference's caches under ``key`` (the smoke config: lead layer
    0, then the one period's single repetition) as [layer][name] arrays."""
    return [{n: out[f"{key}/lead0/{n}"] for n in ("c", "kr")},
            {n: out[f"{key}/period0/{n}"][0] for n in ("c", "kr")}]


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
    """Every rank holds the whole latent cache: each against the
    reference's."""
    for r, rank_caches in enumerate(caches):
        for layer, (got, w) in enumerate(zip(rank_caches, want)):
            for n in ("c", "kr"):
                assert got[n].dtype == torch.bfloat16
                np.testing.assert_allclose(
                    got[n].float().numpy(), w[n], atol=CACHE_TOL,
                    rtol=CACHE_TOL,
                    err_msg=f"{what} rank {r} layer {layer} {n}")


def _prefill(ranks, cfg, ctx, fn=TS.prefill_logits):
    inp = _inputs()
    toks = torch.from_numpy(inp["tokens"]).long()
    lengths = torch.from_numpy(inp["lengths"]).long()
    return ctx.group.spmd(lambda p: fn(p, {"tokens": toks}, ctx, cfg,
                                       lengths), [(p,) for p in ranks])


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layout", ["seq", "hidden"])
@pytest.mark.parametrize("mode", MODES)
def test_prefill_tp4_matches_reference(ref, mode, layout):
    _, out = ref
    cfg = _cfg()
    ranks = _ranks(out, cfg)
    g = dist.RankGroup(TP, "cpu", timeout_s=60)
    ctx = _ctx(g, mode).with_layout(layout == "seq")
    TF.dropped.clear()
    outs = _prefill(ranks, cfg, ctx)
    drops = TF.drop_totals(TP)
    got = torch.cat([lg for lg, _ in outs], dim=-1).numpy()
    rel = _rel(got, out[f"{layout}/logits"])
    assert rel <= LOGIT_RTOL, (mode, layout, rel)
    _check_caches([c for _, c in outs], _layers(out, f"{layout}/cache"),
                  f"{layout} {mode} prefill")
    TF.dropped.clear()
    nxt = _prefill(ranks, cfg, ctx, TS.prefill_step)
    # the same tokens route the same way: each rank evicts what it did
    assert TF.drop_totals(TP) == drops
    for n, _ in nxt:
        np.testing.assert_array_equal(n.numpy(), out[f"{layout}/next"])


# ---------------------------------------------------------------------------
# decode and the chunked prefill
# ---------------------------------------------------------------------------
def _dense_start(out):
    """Every rank's dense [B, S_MAX] caches from the reference's prefill."""
    caches = []
    for layer in _layers(out, "seq/cache"):
        lc = {}
        for n, a in layer.items():
            z = np.zeros((a.shape[0], S_MAX) + a.shape[2:], np.float32)
            z[:, :a.shape[1]] = a
            lc[n] = torch.from_numpy(z).bfloat16()
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
def test_decode_tp4_matches_reference(ref, mode, paged):
    inp, out = ref
    cfg = _cfg()
    ranks = _ranks(out, cfg)
    g = dist.RankGroup(TP, "cpu", timeout_s=60)
    ctx = _ctx(g, mode)
    kind = "paged" if paged else "dense"
    caches = [_dense_start(out) for _ in range(TP)]
    active = torch.tensor(ACTIVE)
    tables = None
    if paged:
        caches = [_paged_start(c, inp["bt"]) for c in caches]
        tables = torch.from_numpy(np.where(inp["active"][:, None], inp["bt"],
                                           0)).long()
    lengths = torch.tensor(LENGTHS)
    tok = torch.from_numpy(out["seq/next"]).long()
    for step in range(N_DECODE):
        def body(p, c, t=tok, pos=lengths + step):
            lg, _ = TS.decode_logits(p, c, t, pos, ctx, cfg,
                                     block_tables=tables, active=active)
            return TS.vocab_parallel_argmax(lg, cfg.vocab_size, ctx), lg

        outs = g.spmd(body, list(zip(ranks, caches)))
        _check_step(outs, out, f"{kind}/{step}", f"{kind} {mode} step {step}")
        tok = outs[0][0][:, None]
    _check_caches(caches, _layers(out, f"{kind}/cache"), f"{kind} {mode}")
    if not paged:
        # the inactive row's cache rows are the prefill's, untouched
        start = _dense_start(out)
        for rank_caches in caches:
            for got, old in zip(rank_caches, start):
                for n in ("c", "kr"):
                    assert torch.equal(got[n][1], old[n][1])
    # decode_step, the entry point the Server calls, returns those tokens
    # on every rank (it rewrites the last step's cache rows alike)
    last = N_DECODE - 1
    prev = torch.from_numpy(out[f"{kind}/{last - 1}/next"]).long()
    got = g.spmd(lambda p, c: TS.decode_step(p, c, prev, lengths + last, ctx,
                                             cfg, block_tables=tables,
                                             active=active)[0],
                 list(zip(ranks, caches)))
    for t in got:
        np.testing.assert_array_equal(t.numpy(), out[f"{kind}/{last}/next"])


@pytest.mark.parametrize("mode", MODES)
def test_prefill_chunk_tp4_matches_reference(ref, mode):
    inp, out = ref
    cfg = _cfg()
    ranks = _ranks(out, cfg)
    g = dist.RankGroup(TP, "cpu", timeout_s=60)
    ctx = _ctx(g, mode)
    bt = torch.from_numpy(inp["bt"][:1]).long()
    m = cfg.mla
    for n_prompt in CHUNK_PROMPTS:
        pools = [[{"c": torch.zeros((NUM_BLOCKS, BLOCK, m.kv_lora_rank),
                                    dtype=torch.bfloat16),
                   "kr": torch.zeros((NUM_BLOCKS, BLOCK, m.qk_rope_head_dim),
                                     dtype=torch.bfloat16)}
                  for _ in range(cfg.num_layers)] for _ in range(TP)]
        prompt = inp["tokens"][1, :n_prompt]
        off, i = 0, 0
        while off < n_prompt:
            clen = min(CHUNK, n_prompt - off)
            t = np.zeros((1, CHUNK), np.int64)
            t[0, :clen] = prompt[off:off + clen]
            t = torch.from_numpy(t)

            def body(p, c, t=t, off=off, clen=clen):
                nxt, _ = TS.prefill_chunk_step(p, c, t, bt, off, clen, ctx,
                                               cfg)
                lg, _ = TS.prefill_chunk_logits(p, c, t, bt, off, clen, ctx,
                                                cfg)
                return nxt, lg

            outs = g.spmd(body, list(zip(ranks, pools)))
            _check_step(outs, out, f"chunk{n_prompt}/{i}",
                        f"chunk {i} of {n_prompt} ({mode})",
                        LOGIT_RTOL if i == 0 else CHUNK_LOGIT_RTOL)
            off, i = off + clen, i + 1
        _check_caches(pools, _layers(out, f"chunk{n_prompt}/cache"),
                      f"chunked {n_prompt} {mode}")


# ---------------------------------------------------------------------------
# the Server and the CLI
# ---------------------------------------------------------------------------
def _setup(out, mode):
    cfg = _cfg()
    par = ParallelConfig(tp=TP, overlap_mode=mode)
    return cfg, par, _ranks(out, cfg), dist.RankGroup(TP, "cpu",
                                                      timeout_s=60)


def _serve(srv, prompts):
    done = srv.serve([Request(rid=i, prompt=p) for i, p in enumerate(prompts)])
    assert all(r.done and r.error is None for r in done)
    return {r.rid: list(r.output) for r in done}


def _want(out, case):
    n = len(_prompts()[case])
    return {i: out[f"{case}/{i}"].tolist() for i in range(n)}


@pytest.mark.parametrize("mode", MODES)
def test_server_tp4_matches_reference_isolated_and_reuse(ref, mode):
    _, out = ref
    cfg, par, ranks, group = _setup(out, mode)
    prompts = _prompts()["serve"]
    srv = Server(cfg, par, ranks, ServeConfig(**SERVE_KW), group=group)
    assert len(srv.caches) == TP
    got = _serve(srv, prompts)
    assert got == _want(out, "serve")
    assert srv.pool.reuse_hits == int(out["serve/reuse_hits"]) >= 1
    for i, p in enumerate(prompts):
        alone = Server(cfg, par, ranks, ServeConfig(**SERVE_KW), group=group)
        assert _serve(alone, [p])[0] == got[i], i
    # the same requests again reuse every full prompt block
    hits, dispatches = srv.pool.reuse_hits, srv.prefill_dispatches
    assert _serve(srv, prompts) == got
    full = sum(1 for p in prompts if len(p) >= SERVE_KW["block_size"])
    assert srv.pool.reuse_hits - hits == full
    assert srv.prefill_dispatches - dispatches < dispatches


@pytest.mark.parametrize("mode", MODES)
def test_server_tp4_eviction(ref, mode):
    _, out = ref
    cfg, par, ranks, group = _setup(out, mode)
    prompts = _prompts()["evict"]
    srv = Server(cfg, par, ranks, ServeConfig(**EVICT_KW), group=group)
    got = _serve(srv, prompts)
    assert srv.pool.evictions > 0
    assert srv.pool.evictions == int(out["evict/evictions"])
    assert got == _want(out, "evict")
    for i, p in enumerate(prompts[:3]):
        alone = Server(cfg, par, ranks, ServeConfig(**EVICT_KW), group=group)
        assert _serve(alone, [p])[0] == got[i], i
    assert got[3] == got[0]              # the repeat, evicted or not


def test_serve_cli_tp4_matches_tp1():
    """``launch.serve --arch deepseek_v3_671b --smoke --tp 4`` in xla and
    flux (bf16 weights): every request served in full; xla and flux the
    same tokens (the replicated layout reduces alike in both); every first
    token equal to the tp=1 run's.  Later tokens are not held to tp=1's
    here: the bf16 smoke model's decode meets near ties that the ranks'
    rounding of the AllReduce and the expert psum can overturn (request
    1's twelfth token); the fp32 tests above hold every token against the
    reference's."""
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "4"]
    _, done1 = launch_serve.main(argv)
    tp1 = {r.rid: r.output for r in done1}
    got = {}
    for mode in ("xla", "flux"):
        srv, done = launch_serve.main(argv + ["--tp", str(TP), "--mode",
                                              mode])
        assert srv.group.n == TP and srv.ctx.mode == mode
        got[mode] = {r.rid: r.output for r in done}
        assert sorted(got[mode]) == sorted(tp1)
        assert all(len(o) == 16 for o in got[mode].values())
    assert got["xla"] == got["flux"]
    assert {i: o[0] for i, o in got["flux"].items()} == {
        i: o[0] for i, o in tp1.items()}

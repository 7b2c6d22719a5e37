"""Serving on the rank mesh: prefill, decode and the paged Server at dp x tp,
with ZeRO-3 and experts over a dedicated ep axis or ``ep_over_dp``, against
the reference.

The reference runs once for the file, in one subprocess with 8 forced host
devices: its ``prefill_step`` and ``decode_step`` under ``shard_map`` on a
4-device mesh, the batch split over its data axes (``trainer.make_ctx``'s
``dp_axes``), the logits captured at ``vocab_parallel_argmax``, on
  minicpm_2b smoke at (dp 2, tp 2), with and without ``zero3``;
  llama4_scout_17b_a16e smoke at (ep 2, dp 1, tp 2);
  deepseek_v3_671b smoke at (dp 2, tp 2) with ``ep_over_dp``;
and its ``Server`` on ``make_mesh(1, 2, 2)`` under ``zero3`` (minicpm).
All in fp32 compute with fp32 weights drawn by its ``init_model``.

The port runs the same from the same weights (``convert``) as the threads
of a ``dist.RankMesh`` on the CPU, each rank on its ``model.mesh_shard``
copy and its rows of the batch; its decode steps start from the
reference's prefill caches.  Tolerances (fp32): next tokens equal, logits
(the ranks' vocab shards and batch rows put together) within relative L2
1e-5; each rank's prefill caches (bf16 on both sides) within 2e-2 of its
piece of the reference's, as in ``tests/test_torch_tp_decode.py``; the
Server's tokens equal.  The serve CLI at ``--dp 2
--tp 2`` (bf16 weights) gives the tp=1 CLI's tokens, as the tp=4 CLI does
in ``tests/test_torch_tp_server.py``.

Without the reference: two runs of the dp=2 x tp=2 ZeRO-3 prefill and a
decode step on fresh rank threads agree bit for bit; concurrent =
isolated at dp=2 x tp=2 under prefix reuse and under eviction; a ZeRO-3
serve step frees each layer's gathered copies before the next layer
gathers (storage size 0); a rank returning other tokens raises; the
Server with experts over an ep axis and under ``ep_over_dp`` gives the
tp=1 Server's tokens.  The ``gpu`` case runs the
dp x tp prefill through the kernels on the card against the plain run.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.base import ParallelConfig, get_smoke_config
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.mesh import make_mesh, mesh_coords
from repro_torch.models import model as TM
from repro_torch.models import serve as TS
from repro_torch.parallel.sharding import make_ctx
from repro_torch.runtime.server import Request, ServeConfig, Server

B, S_LEN, S_MAX, N_DECODE = 4, 16, 24, 3
LENGTHS = [16, 11, 7, 14]
LOGIT_RTOL = 1e-5
CACHE_TOL = 2e-2
ARCH = {"minicpm": "minicpm_2b", "scout": "llama4_scout_17b_a16e",
        "deepseek": "deepseek_v3_671b"}
# the reference's batched runs: (key, config, ep, dp, tp, zero3, ep_over_dp)
CASES = [("dense", "minicpm", 1, 2, 2, False, False),
         ("dense_z3", "minicpm", 1, 2, 2, True, False),
         ("ep2", "scout", 2, 1, 2, False, False),
         ("epdp", "deepseek", 1, 2, 2, False, True)]
# the port's runs: (case, mode)
PORT_RUNS = [("dense", "decomposed"), ("dense", "flux"),
             ("dense_z3", "xla"), ("dense_z3", "flux"),
             ("ep2", "decomposed"), ("epdp", "decomposed")]
SERVE_KW = dict(max_batch=2, max_seq=64, eos_token=-1, max_new_tokens=6,
                block_size=8, prefill_chunk=16)
# 10 usable blocks of 4: two 12-token requests in flight fill the pool
EVICT_KW = dict(SERVE_KW, block_size=4, num_blocks=11)

_REF = r"""
import dataclasses, functools
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.configs.base import get_smoke_config, ParallelConfig
from repro.launch.mesh import make_mesh
from repro.models import model as M, serve as S
from repro.runtime import trainer as T
from repro.runtime.server import Request, ServeConfig, Server

inp = dict(np.load(IN))
out = {}
seen = {}
_argmax = S.vocab_parallel_argmax


def _capture(logits_loc, *a, **k):
    seen["logits"] = logits_loc
    return _argmax(logits_loc, *a, **k)


S.vocab_parallel_argmax = _capture


def config(name):
    return dataclasses.replace(get_smoke_config(%(arch)r[name]),
                               compute_dtype="float32")


def save(tree, prefix):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in flat:
        key = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                       for q in path)
        out[prefix + key] = np.asarray(leaf, np.float32)


def pad_seq(caches):
    # the prefill's [.., B, S, ..] caches into [.., B, S_MAX, ..]
    def pad(a, axis):
        w = [(0, 0)] * a.ndim
        w[axis] = (0, int(inp["s_max"]) - a.shape[axis])
        return jnp.pad(a, w)
    return {"lead": [jax.tree.map(lambda a: pad(a, 1), c)
                     for c in caches["lead"]],
            "periods": [jax.tree.map(lambda a: pad(a, 2), c)
                        for c in caches["periods"]]}


toks, lengths = jnp.asarray(inp["tokens"]), jnp.asarray(inp["lengths"])
for key, name, ep, dp, tp, zero3, epdp in %(cases)r:
    cfg = config(name)
    par = ParallelConfig(tp=tp, dp=dp, ep=ep, zero3=zero3, ep_over_dp=epdp)
    mesh = make_mesh(1, dp, tp, ep=ep)
    params = M.init_model(jax.random.PRNGKey(0), cfg, par, dtype=jnp.float32)
    specs = M.param_specs(cfg, par, params)
    ctx = T.make_ctx(cfg, par, mesh)
    dpax = ctx.dp_axes
    rows, logit = P(dpax, None), P(dpax, "model")
    _, cspec = S.cache_specs(cfg, par, B_, S_, dp_axes=dpax)

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=(specs, rows, P(dpax)),
                       out_specs=(rows, cspec, logit), check_vma=False)
    def prefill(p, t, l):
        nxt, caches = S.prefill_step(p, {"tokens": t}, ctx, cfg, par, l)
        return nxt, caches, seen.pop("logits")

    @jax.jit
    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(specs, cspec, rows, P(dpax)),
                       out_specs=(rows, cspec, logit), check_vma=False)
    def decode(p, c, t, pos):
        nxt, c = S.decode_step(p, c, t, pos, ctx, cfg, par)
        return nxt, c, seen.pop("logits")

    nxt, caches, lg = prefill(params, toks, lengths)
    out[key + "/prefill/next"] = np.asarray(nxt)
    out[key + "/prefill/logits"] = np.asarray(lg, np.float32)
    c = pad_seq(caches)
    save(c, key + "/caches/")
    for step in range(int(inp["n_decode"])):
        nxt, c, lg = decode(params, c, nxt, lengths + step)
        out[f"{key}/decode/{step}/next"] = np.asarray(nxt)
        out[f"{key}/decode/{step}/logits"] = np.asarray(lg, np.float32)
    save(params, key + "/params/")

cfg = config("minicpm")
par = ParallelConfig(tp=2, dp=2, zero3=True)
mesh = make_mesh(1, 2, 2)
params = M.init_model(jax.random.PRNGKey(0), cfg, par, dtype=jnp.float32)
prompts = [inp[f"serve/{i}"] for i in range(int(inp["serve/n"]))]
srv = Server(cfg, par, mesh, params, ServeConfig(**%(serve_kw)r))
for r in srv.serve([Request(rid=i, prompt=p) for i, p in enumerate(prompts)]):
    out[f"server/{r.rid}"] = np.asarray(r.output, np.int32)
out["server/reuse_hits"] = np.asarray(srv.pool.reuse_hits)
save(params, "server/params/")
np.savez(OUT, **out)
print("REF_OK")
"""


def _inputs():
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 512, (B, S_LEN)).astype(np.int32)
    for b, n in enumerate(LENGTHS):
        toks[b, n:] = 0                      # right padding
    return {"tokens": toks, "lengths": np.array(LENGTHS, np.int32),
            "s_max": S_MAX, "n_decode": N_DECODE}


def _prompts():
    rng = np.random.default_rng(7)
    serve = [rng.integers(0, 512, size=(n,)).astype(np.int32)
             for n in (5, 20, 33, 12)]
    serve[3] = np.concatenate([serve[1][:16], serve[3]])   # shared prefix
    rng = np.random.default_rng(13)
    uniq = [rng.integers(0, 512, size=(12,)).astype(np.int32)
            for _ in range(3)]
    return {"serve": serve, "evict": uniq + [uniq[0].copy()]}


@pytest.fixture(scope="module")
def ref(tmp_path_factory, subproc):
    d = tmp_path_factory.mktemp("mesh_serve")
    inp = _inputs()
    prompts = _prompts()["serve"]
    inp["serve/n"] = np.asarray(len(prompts))
    for i, p in enumerate(prompts):
        inp[f"serve/{i}"] = p
    np.savez(d / "in.npz", **inp)
    code = (_REF % {"arch": ARCH, "cases": CASES, "serve_kw": SERVE_KW}
            ).replace("B_, S_", f"{B}, {S_LEN}").replace(
        "IN)", repr(str(d / "in.npz")) + ")").replace(
        "OUT,", repr(str(d / "out.npz")) + ",")
    assert "REF_OK" in subproc(code, n_devices=8)
    return dict(np.load(d / "out.npz"))


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


def _case(key):
    return next(c for c in CASES if c[0] == key)


def _cfg(name):
    return dataclasses.replace(get_smoke_config(ARCH[name]),
                               compute_dtype="float32")


def _mesh_ranks(full, cfg, par):
    mesh = make_mesh(par.pods, par.dp, par.tp, "cpu", ep=par.ep)
    mesh.timeout_s = 60
    return mesh, [TM.mesh_shard(full, cfg, par, mesh_coords(mesh, r))
                  for r in range(mesh.size)]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _rank_caches(caches, mesh, r, par):
    """Mesh rank r's piece of global dense caches: its rows of the batch,
    and of GQA's KV heads its TP block."""
    rows = TS.dp_rows(par, B, mesh_coords(mesh, r))
    m = mesh_coords(mesh, r)["model"]
    out = []
    for layer in caches:
        piece = {}
        for name, t in layer.items():
            t = t[rows]
            if name in ("k", "v"):
                t = t.chunk(par.tp, 2)[m]
            piece[name] = t.clone()
        out.append(piece)
    return out


def _mesh_steps(cfg, par, mesh, ranks, toks, lengths, mode, start):
    """The batched prefill, then N_DECODE decode steps from the caches
    ``start`` (the reference's prefill caches, so both sides read the same
    bf16 rows) on every mesh rank: per step, (the tokens [B], the logits
    [B, V_pad]) put together from the ranks' rows and vocab shards (every
    rank of a TP group must hold the same tokens), and each rank's
    prefill caches."""
    par = dataclasses.replace(par, overlap_mode=mode)

    def body(p, r):
        ctx = make_ctx(par, mesh=mesh)
        rows = TS.dp_rows(par, B, mesh_coords(mesh, r))
        t, lens = toks[rows], lengths[rows]
        lg, own = TS.prefill_logits(p, {"tokens": t}, ctx, cfg, lens)
        nxt = TS.vocab_parallel_argmax(lg, cfg.vocab_size, ctx)[:, None]
        steps = [(nxt, lg)]
        caches = _rank_caches(start, mesh, r, par)
        for step in range(N_DECODE):
            lg, caches = TS.decode_logits(p, caches, nxt, lens + step, ctx,
                                          cfg)
            nxt = TS.vocab_parallel_argmax(lg, cfg.vocab_size, ctx)[:, None]
            steps.append((nxt, lg))
        return steps, own

    outs = mesh.spmd(body, [(p, r) for r, p in enumerate(ranks)])
    own = [o[1] for o in outs]
    outs = [o[0] for o in outs]
    got = []
    for s in range(N_DECODE + 1):
        blocks = {}
        for r, o in enumerate(outs):
            i = TS.dp_rows(par, B, mesh_coords(mesh, r)).start
            blocks.setdefault(i, []).append(o[s])
        for i, group in blocks.items():
            assert all(torch.equal(x[0], group[0][0]) for x in group), i
        tok = torch.cat([blocks[i][0][0] for i in sorted(blocks)])
        lg = torch.cat([torch.cat([x[1] for x in blocks[i]], -1)
                        for i in sorted(blocks)])
        got.append((tok.reshape(-1).numpy(), lg.numpy()))
    return got, own


@pytest.mark.parametrize("key,mode", PORT_RUNS)
def test_mesh_prefill_decode_match_reference(ref, key, mode):
    _, name, ep, dp, tp, zero3, epdp = _case(key)
    cfg = _cfg(name)
    par = ParallelConfig(tp=tp, dp=dp, ep=ep, zero3=zero3, ep_over_dp=epdp)
    full = convert.params_from_jax(_tree(ref, key + "/params/"), cfg,
                                   dtype=torch.float32, device="cpu")
    mesh, ranks = _mesh_ranks(full, cfg, par)
    if zero3:
        z3 = TM.zero3_leaves(cfg, par)
        assert z3 and all(dict(ranks[0].named_parameters())[n].shape[0] * 2
                          == dict(full.named_parameters())[n].shape[0]
                          for n in z3)
    inp = _inputs()
    start = convert.caches_from_jax(_tree(ref, key + "/caches/"), cfg,
                                    device="cpu")
    got, own = _mesh_steps(cfg, par, mesh, ranks,
                           torch.from_numpy(inp["tokens"]),
                           torch.from_numpy(inp["lengths"]), mode, start)
    names = ["prefill"] + [f"decode/{s}" for s in range(N_DECODE)]
    for (tok, lg), what in zip(got, names):
        np.testing.assert_array_equal(
            tok, ref[f"{key}/{what}/next"].reshape(-1), err_msg=what)
        assert _rel(lg, ref[f"{key}/{what}/logits"]) <= LOGIT_RTOL, what
    # each rank's prefill caches: its piece of the reference's (bf16 both
    # sides, one bf16 ulp apart at most where the fp32 sums round apart)
    for r, caches in enumerate(own):
        want = _rank_caches(start, mesh, r, par)
        for layer, (g, w) in enumerate(zip(caches, want)):
            for n in g:
                np.testing.assert_allclose(
                    g[n].float().numpy(), w[n][:, :S_LEN].float().numpy(),
                    atol=CACHE_TOL, rtol=CACHE_TOL, err_msg=f"{r} {layer} {n}")


def _server(cfg, par, full, kw, mode="flux"):
    par = dataclasses.replace(par, overlap_mode=mode)
    mesh, ranks = _mesh_ranks(full, cfg, par)
    return Server(cfg, par, ranks, ServeConfig(**kw), mesh=mesh)


def _serve(srv, prompts):
    done = srv.serve([Request(rid=i, prompt=p) for i, p in enumerate(prompts)])
    assert all(r.done and r.error is None for r in done)
    return {r.rid: list(r.output) for r in done}


def _server_params(ref):
    cfg = _cfg("minicpm")
    return cfg, ParallelConfig(tp=2, dp=2, zero3=True), convert.params_from_jax(
        _tree(ref, "server/params/"), cfg, dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("mode", ["xla", "flux"])
def test_mesh_server_matches_reference_and_isolated(ref, mode):
    cfg, par, full = _server_params(ref)
    prompts = _prompts()["serve"]
    srv = _server(cfg, par, full, SERVE_KW, mode)
    assert srv.mesh.shape == (2, 2) and len(srv.caches) == 4
    assert all(c.zero3 is srv.par and c.data_group.n == 2 for c in srv.ctxs)
    got = _serve(srv, prompts)
    assert got == {i: ref[f"server/{i}"].tolist() for i in range(len(prompts))}
    assert srv.pool.reuse_hits == int(ref["server/reuse_hits"]) >= 1
    hits = srv.pool.reuse_hits
    assert _serve(srv, prompts) == got          # again: every prefix reused
    assert srv.pool.reuse_hits > hits
    for i, p in enumerate(prompts):
        alone = Server(cfg, srv.par, srv.params, srv.sc, mesh=srv.mesh)
        assert _serve(alone, [p])[0] == got[i], i


def test_mesh_server_eviction_concurrent_equals_isolated(ref):
    cfg, par, full = _server_params(ref)
    prompts = _prompts()["evict"]
    srv = _server(cfg, par, full, EVICT_KW)
    got = _serve(srv, prompts)
    assert srv.pool.evictions > 0
    for i, p in enumerate(prompts[:3]):
        alone = Server(cfg, srv.par, srv.params, srv.sc, mesh=srv.mesh)
        assert _serve(alone, [p])[0] == got[i], i
    assert got[3] == got[0]


def test_mesh_server_zero3_frees_each_layer(ref, monkeypatch):
    """Each ZeRO-3 layer of a serve step gathers only after the previous
    layer's copies are freed, and frees its own (storage size 0)."""
    cfg, par, full = _server_params(ref)
    srv = _server(cfg, par, full, SERVE_KW)
    held = {}                         # each mesh rank's gathered copies
    gather = TM._Zero3.gather

    def watched(self, blk):
        mine = held.setdefault(srv.mesh.rank(), [])
        assert self.serve
        assert all(t.untyped_storage().nbytes() == 0 for t in mine)
        out = gather(self, blk)
        assert all(t.untyped_storage().nbytes() > 0 for t in self.held[0])
        mine.extend(self.held[0])
        return out

    monkeypatch.setattr(TM._Zero3, "gather", watched)
    _serve(srv, _prompts()["serve"][:2])
    assert len(held) == 4
    assert all(t.untyped_storage().nbytes() == 0
               for mine in held.values() for t in mine)
    assert srv.prefill_dispatches and srv.decode_dispatches


def test_mesh_server_rank_disagreeing_raises(ref):
    cfg, par, full = _server_params(ref)
    srv = _server(cfg, par, full, SERVE_KW)

    def split(p, caches, ctx, cfg):
        return torch.full((1, 1), ctx.tp_index()), caches
    with pytest.raises(RuntimeError, match="differ from rank 0"):
        srv._run(split)


@pytest.mark.parametrize("name,kw", [("scout", dict(ep=2)),
                                     ("deepseek", dict(dp=2,
                                                       ep_over_dp=True))])
def test_mesh_server_experts_elsewhere_equal_tp1(name, kw):
    """The Server with experts over a dedicated ep axis (its chunked
    prefill and decode bring in the other replicas' tokens) or over
    (data, model) gives the tp=1 Server's tokens."""
    cfg = _cfg(name)
    par = ParallelConfig(tp=2, **kw)
    full = TM.init_model(cfg, par, seed=0, dtype=torch.float32, device="cpu")
    one = TM.init_model(cfg, ParallelConfig(), seed=0, dtype=torch.float32,
                        device="cpu")
    prompts = _prompts()["serve"]
    want = _serve(Server(cfg, ParallelConfig(), one, ServeConfig(**SERVE_KW)),
                  prompts)
    srv = _server(cfg, par, full, SERVE_KW, "decomposed")
    assert srv.ctx.ep_axis.n == (2 if "ep" in kw else 4)
    assert _serve(srv, prompts) == want


@pytest.mark.parametrize("mode", ["xla", "flux"])
def test_serve_cli_dp2_tp2_equals_tp1(mode):
    argv = ["--arch", "minicpm_2b", "--smoke", "--device", "cpu",
            "--requests", "4"]
    _, done1 = launch_serve.main(argv)
    srv, done = launch_serve.main(argv + ["--dp", "2", "--tp", "2",
                                          "--mode", mode])
    assert srv.mesh.shape == (2, 2) and srv.ctx.mode == mode
    assert {r.rid: r.output for r in done} == {r.rid: r.output
                                               for r in done1}


def test_mesh_prefill_decode_repeat_bit_for_bit():
    """Two runs of the dp=2 x tp=2 ZeRO-3 prefill and a decode step, each
    on fresh rank threads, give the same logits and caches bit for bit
    (the rank threads share the CPU's BLAS and OpenMP pools)."""
    cfg = _cfg("minicpm")
    par = ParallelConfig(tp=2, dp=2, zero3=True)
    full = TM.init_model(cfg, par, seed=0, dtype=torch.float32, device="cpu")
    toks = torch.from_numpy(_inputs()["tokens"]).long()
    lengths = torch.tensor(LENGTHS)

    def body(p, r, mesh):
        ctx = make_ctx(par, mesh=mesh)
        rows = TS.dp_rows(par, B, mesh_coords(mesh, r))
        lg, caches = TS.prefill_logits(p, {"tokens": toks[rows]}, ctx, cfg,
                                       lengths[rows])
        nxt = TS.vocab_parallel_argmax(lg, cfg.vocab_size, ctx)[:, None]
        dense = TS.zeros_from_specs(TS.cache_specs(cfg, par, B, S_MAX),
                                    "cpu")
        for d, c in zip(dense, caches):
            for n in d:
                d[n][:, :S_LEN] = c[n]
        lg2, _ = TS.decode_logits(p, dense, nxt, lengths[rows], ctx, cfg)
        return [lg, lg2] + [t for c in caches for t in c.values()]

    runs = []
    for _ in range(2):
        mesh, ranks = _mesh_ranks(full, cfg, par)
        runs.append(mesh.spmd(lambda p, r: body(p, r, mesh),
                              [(p, r) for r, p in enumerate(ranks)]))
    for a, b in zip(*runs):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_cache_specs_rows_over_data():
    cfg = get_smoke_config("minicpm_2b")
    par = ParallelConfig(tp=2, dp=2, pods=2)
    (k,) = {sp["k"].shape for sp in TS.cache_specs(cfg, par, 8, 32)}
    assert k[0] == 2
    # pod outermost, then data: (pod 1, data 0) is the third block of rows
    assert TS.dp_rows(par, 8, {"pod": 1, "data": 0, "model": 1}) == slice(4, 6)
    with pytest.raises(ValueError, match="does not split"):
        TS.cache_specs(cfg, par, 6, 32)
    paged = TS.paged_cache_specs(cfg, par, 9, 4, 8)
    assert paged[0]["k"].shape[:2] == (9, 4)


@pytest.mark.gpu
def test_gpu_mesh_prefill_kernels_match_plain():
    """dp=2 x tp=2 on the card in flux with the flash kernel: the fused
    and flash kernels launch, and the logits match the plain run's (the
    same ranks with ``kernel_decode`` off and the xla transport) within
    bf16 noise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only there)")
    from repro_torch.kernels import ag_gemm as AG
    from repro_torch.kernels import flash_attention as fa
    cfg = dataclasses.replace(get_smoke_config("minicpm_2b"), d_model=256,
                              num_heads=4, head_dim=64, d_ff=512)
    par = ParallelConfig(tp=2, dp=2, zero3=True)
    full = TM.init_model(cfg, par, seed=0, device="cuda")
    mesh = make_mesh(1, 2, 2, "cuda")
    ranks = [TM.mesh_shard(full, cfg, par, mesh_coords(mesh, r))
             for r in range(4)]
    toks = torch.randint(0, cfg.vocab_size, (4, 256), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(0))

    def run(p, r, kernels, mode):
        q = dataclasses.replace(par, kernel_decode=kernels, overlap_mode=mode)
        ctx = make_ctx(q, mesh=mesh)
        rows = TS.dp_rows(q, 4, mesh_coords(mesh, r))
        return TS.prefill_logits(p, {"tokens": toks[rows]}, ctx, cfg)[0]

    before = (AG.ag_gemm.launches, fa.flash_attention.launches)
    got = mesh.spmd(lambda p, r: run(p, r, True, "flux"),
                    [(p, r) for r, p in enumerate(ranks)])
    assert AG.ag_gemm.launches > before[0]
    assert fa.flash_attention.launches > before[1]
    want = mesh.spmd(lambda p, r: run(p, r, False, "xla"),
                     [(p, r) for r, p in enumerate(ranks)])
    for g, w in zip(got, want):
        assert (g.float() - w.float()).norm() / w.float().norm() <= 2e-2

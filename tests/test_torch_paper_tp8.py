"""The paper's models at tp=8: the port's 8 ranks against the reference's 8
forced host devices, on two shape-faithful reductions of each package's own
config (``shrink``, fp32 compute and fp32 params):

* gpt3_175b: MHA, 16 query heads and 16 KV heads of head_dim 16, d_model
  256: each rank holds 2 heads;
* llama2_70b: 64 query heads over 8 KV heads of head_dim 8, d_model 512,
  d_ff 1024: each rank holds 8 query heads over exactly 1 KV head, as the
  full model does at tp=8.

The reference runs once for the file, in one subprocess with 8 forced host
devices, under ``shard_map`` (its prefill and decode in decomposed mode, its
loss in xla mode: the values do not depend on the mode; its interpreted flux
cannot run the model here).  Its params, drawn at tp=8, cross as numpy and
are cut per rank by ``convert.rank_params_from_jax``.  The port runs the 8
ranks of a ``dist.RankGroup`` on the CPU in xla, decomposed and flux:

* ``prefill_step``: next tokens equal on every rank; last-position logits
  (the ranks' vocab shards concatenated) within relative L2 1e-5 (fp32 sums
  in another order); the K/V caches (bf16 on both sides) within 2e-2, one
  bf16 ulp at |x| ~ 2-4;
* two dense ``decode_step``s from the reference's prefill caches: each
  step's tokens equal and its logits within relative L2 1e-5;
* train step 0: the loss within relative 1e-5, every leaf's grad on every
  rank, before and after the trainer's sum of the model-replicated leaves,
  within relative L2 1e-4.

Without the reference: the port at tp=8 against itself at tp=1 from the
same seed (the same canonical weights, packed for each tp): prefill logits
within relative L2 1e-5 and equal next tokens; step 0's loss within
relative 1e-5 and its canonical grads, divided by 8, within relative L2
1e-5 of tp=1's (each rank seeds its replicated loss with 1, ROADMAP §3).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import base as TB
from repro_torch.dist import RankGroup
from repro_torch.models import model as TM
from repro_torch.models import serve as TS
from repro_torch.parallel.sharding import TPContext, make_ctx
from repro_torch.runtime import trainer as TT

TP = 8
MODES = ["xla", "decomposed", "flux"]
# shrink overrides of each paper model (the same on both sides)
REDUCTIONS = {
    "gpt3_175b": dict(num_heads=16, num_kv_heads=16, head_dim=16,
                      d_model=256),
    "llama2_70b": dict(num_heads=64, num_kv_heads=8, head_dim=8,
                       d_model=512, d_ff=1024),
}
ARCHS = list(REDUCTIONS)
B, S, S_MAX, N_DECODE = 2, 32, 40, 2
LENGTHS = [20, 32]
CACHE_TOL = 2e-2
LOGIT_RTOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
TP1_GRAD_RTOL = 1e-5

_REF = r"""
import dataclasses, functools, importlib
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.configs.base import ParallelConfig, shrink
from repro.models import model as M, serve as S
from repro.optim import adamw
from repro.parallel.sharding import TPContext

inp = dict(np.load(IN))
out = {}
seen = {}
_argmax = S.vocab_parallel_argmax


def _capture(logits_loc, *a, **k):
    seen["logits"] = logits_loc
    return _argmax(logits_loc, *a, **k)


S.vocab_parallel_argmax = _capture


def save(tree, prefix):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in flat:
        key = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                       for q in path)
        out[prefix + key] = np.asarray(leaf, np.float32)


mesh = Mesh(np.array(jax.devices()).reshape(1, 8), ("data", "model"))
kv = P(None, None, None, "model", None)
LOGITS = P(None, "model")
toks, lengths = jnp.asarray(inp["tokens"]), jnp.asarray(inp["lengths"])
ltoks, labels = jnp.asarray(inp["ltokens"]), jnp.asarray(inp["labels"])
for arch, over in %(reductions)r.items():
    base = importlib.import_module(f"repro.configs.{arch}").CONFIG
    cfg = dataclasses.replace(shrink(base, **over), compute_dtype="float32")
    par = ParallelConfig(tp=8, dp=1)
    params = M.init_model(jax.random.PRNGKey(0), cfg, par, dtype=jnp.float32)
    specs = M.param_specs(cfg, par, params)
    cspec = {"lead": [], "periods": [
        {"mixer": {"k": kv, "v": kv}, "ffn": {}} for _ in cfg.pattern]}
    ctx = TPContext(axis="model", mode="decomposed")

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=(specs, P(), P()),
                       out_specs=(P(), cspec, LOGITS), check_vma=False)
    def prefill(p, t, l):
        nxt, caches = S.prefill_step(p, {"tokens": t}, ctx, cfg, par, l)
        return nxt, caches, seen.pop("logits")

    nxt, caches, logits = prefill(params, toks, lengths)
    out[arch + "/prefill/next"] = np.asarray(nxt)
    out[arch + "/prefill/logits"] = np.asarray(logits, np.float32)
    per = caches["periods"][0]["mixer"]          # [reps, B, S, H, Dh]
    dense = {}
    for name in ("k", "v"):
        a = np.asarray(per[name], np.float32)
        out[f"{arch}/prefill/{name}"] = a
        z = np.zeros(a.shape[:2] + (int(inp["s_max"]),) + a.shape[3:],
                     np.float32)
        z[:, :, :a.shape[2]] = a
        dense[name] = z

    @jax.jit
    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(specs, cspec, P(), P()),
                       out_specs=(P(), cspec, LOGITS), check_vma=False)
    def decode(p, c, t, pos):
        nxt, c = S.decode_step(p, c, t, pos, ctx, cfg, par)
        return nxt, c, seen.pop("logits")

    c = {"lead": [], "periods": [{"mixer": {
        n: jnp.asarray(dense[n], jnp.bfloat16) for n in ("k", "v")},
        "ffn": {}}]}
    tok = nxt
    for step in range(int(inp["n_decode"])):
        tok, c, lg = decode(params, c, tok, lengths + step)
        out[f"{arch}/decode/{step}/next"] = np.asarray(tok)
        out[f"{arch}/decode/{step}/logits"] = np.asarray(lg, np.float32)

    rep = adamw.model_replicated_tree(specs)
    ranked = jax.tree.map(lambda _: P("model"), params)
    tctx = TPContext(axis="model", mode="xla")

    def body(p, t, l):
        loss, g = jax.value_and_grad(lambda q: M.forward_loss(
            q, {"tokens": t, "labels": l}, tctx, cfg, par))(p)
        gs = jax.tree.map(lambda a, r: jax.lax.psum(a, "model")
                          if r else a, g, rep)
        return (loss, jax.tree.map(lambda a: a[None], g),
                jax.tree.map(lambda a: a[None], gs))

    f = jax.jit(functools.partial(
        shard_map, mesh=mesh, in_specs=(specs, P(), P()),
        out_specs=(P(), ranked, ranked), check_vma=False)(body))
    loss, g, gs = f(params, ltoks, labels)
    out[arch + "/loss"] = np.asarray(loss)
    save(params, arch + "/params/")
    save(g, arch + "/grads/")
    save(gs, arch + "/gradsum/")
np.savez(OUT, **out)
print("REF_OK")
"""


def _inputs():
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 512, (B, S)).astype(np.int32)
    for b, n in enumerate(LENGTHS):
        toks[b, n:] = 0                      # right padding
    ltoks = rng.integers(0, 512, (B, S)).astype(np.int32)
    labels = rng.integers(0, 512, (B, S)).astype(np.int32)
    labels[0, -3:] = -1                      # masked out of the mean
    return {"tokens": toks, "lengths": np.array(LENGTHS, np.int32),
            "ltokens": ltoks, "labels": labels, "s_max": S_MAX,
            "n_decode": N_DECODE}


@pytest.fixture(scope="module")
def ref(tmp_path_factory, subproc):
    d = tmp_path_factory.mktemp("paper_tp8")
    np.savez(d / "in.npz", **_inputs())
    code = (_REF % {"reductions": REDUCTIONS}).replace(
        "IN)", repr(str(d / "in.npz")) + ")").replace(
        "OUT,", repr(str(d / "out.npz")) + ",")
    assert "REF_OK" in subproc(code, n_devices=TP)
    return dict(np.load(d / "out.npz"))


def _cfg(arch):
    import importlib
    base = importlib.import_module(f"repro_torch.configs.{arch}").CONFIG
    return dataclasses.replace(TB.shrink(base, **REDUCTIONS[arch]),
                               compute_dtype="float32")


def test_reductions_hold_the_paper_layout():
    """Each rank holds gpt3's 2 heads over 2 KV heads, llama2's 8 query
    heads over exactly 1 KV head (no KV replication, no padding)."""
    from repro_torch.models.attention import AttnDims
    g, ll = AttnDims.of(_cfg("gpt3_175b"), TP), AttnDims.of(
        _cfg("llama2_70b"), TP)
    assert (g.h_pad // TP, g.hkv_pad // TP, g.dh) == (2, 2, 16)
    assert (ll.h_pad // TP, ll.hkv_pad // TP, ll.dh) == (8, 1, 8)
    assert _cfg("llama2_70b").num_kv_heads == TP


def _tree(flat, prefix):
    """The reference's nested tree from "a/0/b"-keyed numpy leaves."""
    root = {}
    for key, leaf in flat.items():
        if not key.startswith(prefix):
            continue
        parts = key[len(prefix):].split("/")
        node = root
        for i, p in enumerate(parts[:-1]):
            if isinstance(node, list):
                p = int(p)
                while len(node) <= p:
                    node.append([] if parts[i + 1].isdigit() else {})
                node = node[p]
            else:
                node = node.setdefault(
                    p, [] if parts[i + 1].isdigit() else {})
        node[parts[-1]] = leaf
    return root


def _flat(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _ranks(ref, arch, trainable=False):
    return convert.rank_params_from_jax(
        _tree(ref, f"{arch}/params/"), _cfg(arch), TP, dtype=torch.float32,
        device="cpu", trainable=trainable)


def _batch():
    inp = _inputs()
    return (torch.from_numpy(inp["tokens"]),
            torch.from_numpy(inp["lengths"]).long())


def _ctx(group, mode):
    return make_ctx(TB.ParallelConfig(tp=TP, overlap_mode=mode,
                                      kernel_decode=mode == "flux"), group)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_tp8_matches_reference(ref, arch, mode):
    cfg, ranks = _cfg(arch), _ranks(ref, arch)
    group = RankGroup(TP, "cpu", timeout_s=60)
    ctx = _ctx(group, mode)
    toks, lengths = _batch()

    def run(p):
        nxt, caches = TS.prefill_step(p, {"tokens": toks}, ctx, cfg, lengths)
        logits, _ = TS.prefill_logits(p, {"tokens": toks}, ctx, cfg,
                                      lengths)
        return nxt, caches, logits

    outs = group.spmd(run, [(p,) for p in ranks])
    want = ref[arch + "/prefill/next"].reshape(-1)
    for nxt, _, _ in outs:
        np.testing.assert_array_equal(nxt.numpy().reshape(-1), want)
    got = torch.cat([lg for _, _, lg in outs], dim=-1).numpy()
    assert got.shape == ref[arch + "/prefill/logits"].shape
    assert _rel(got, ref[arch + "/prefill/logits"]) <= LOGIT_RTOL
    for layer in range(cfg.num_layers):
        for name in ("k", "v"):
            cat = torch.cat([c[layer][name] for _, c, _ in outs], dim=2)
            assert cat.dtype == torch.bfloat16
            np.testing.assert_allclose(
                cat.float().numpy(), ref[f"{arch}/prefill/{name}"][layer],
                atol=CACHE_TOL, rtol=CACHE_TOL,
                err_msg=f"layer {layer} {name}")


def _rank_caches(ref, arch, r):
    """Rank r's dense [B, S_MAX] bf16 caches of its KV heads, from the
    reference's prefill."""
    caches = []
    pre = {n: ref[f"{arch}/prefill/{n}"] for n in ("k", "v")}
    for layer in range(pre["k"].shape[0]):
        lc = {}
        for n in ("k", "v"):
            a = np.split(pre[n][layer], TP, axis=2)[r]
            z = np.zeros((a.shape[0], S_MAX) + a.shape[2:], np.float32)
            z[:, :a.shape[1]] = a
            lc[n] = torch.from_numpy(z).bfloat16()
        caches.append(lc)
    return caches


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_tp8_matches_reference(ref, arch, mode):
    cfg, ranks = _cfg(arch), _ranks(ref, arch)
    group = RankGroup(TP, "cpu", timeout_s=60)
    ctx = _ctx(group, mode)
    caches = [_rank_caches(ref, arch, r) for r in range(TP)]
    lengths = torch.tensor(LENGTHS)
    tok = torch.from_numpy(ref[arch + "/prefill/next"]).long()
    for step in range(N_DECODE):
        def body(p, c, t=tok, pos=lengths + step):
            lg, _ = TS.decode_logits(p, c, t, pos, ctx, cfg)
            return TS.vocab_parallel_argmax(lg, cfg.vocab_size, ctx), lg

        outs = group.spmd(body, list(zip(ranks, caches)))
        want = ref[f"{arch}/decode/{step}/next"].reshape(-1)
        for t, _ in outs:
            np.testing.assert_array_equal(t.reshape(-1).numpy(), want,
                                          err_msg=f"step {step}")
        got = torch.cat([lg for _, lg in outs], dim=-1).numpy()
        assert _rel(got, ref[f"{arch}/decode/{step}/logits"]) <= LOGIT_RTOL
        tok = outs[0][0][:, None]


def _train_batch():
    inp = _inputs()
    return {"tokens": torch.from_numpy(inp["ltokens"]),
            "labels": torch.from_numpy(inp["labels"])}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step0_tp8_matches_reference(ref, arch, mode):
    cfg, ranks = _cfg(arch), _ranks(ref, arch, trainable=True)
    par = TB.ParallelConfig(tp=TP, overlap_mode=mode)
    group = RankGroup(TP, "cpu", timeout_s=60)
    ctx = TT.make_ctx(cfg, par, group)
    batch = _train_batch()

    def step(p):
        loss, grads = TT.loss_and_grads(p, batch, ctx, cfg, par)
        done = TT.complete_grads(grads, TM.replicated_leaves(cfg, p), group)
        return loss, grads, done

    outs = group.spmd(step, [(p,) for p in ranks])
    want = float(ref[arch + "/loss"])
    wg = {k[len(arch) + 7:]: v for k, v in ref.items()
          if k.startswith(arch + "/grads/")}
    ws = {k[len(arch) + 9:]: v for k, v in ref.items()
          if k.startswith(arch + "/gradsum/")}
    for r, (loss, grads, done) in enumerate(outs):
        assert abs(loss.item() - want) <= LOSS_RTOL * abs(want)
        for got_named, want_flat in ((grads, wg), (done, ws)):
            got = _flat(convert.to_jax_tree(got_named, cfg))
            assert sorted(got) == sorted(want_flat)
            for key, w in want_flat.items():
                assert _rel(got[key], w[r]) <= GRAD_RTOL, (key, r)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_tp8_equals_tp1_same_seed(arch):
    """w1|w3 packed per rank (``fuse_w13``, as on the card) at tp=8 in
    flux, against the unpacked tp=1 model from the same seed."""
    cfg = _cfg(arch)
    p1 = TM.init_model(cfg, TB.ParallelConfig(), seed=0, dtype=torch.float32,
                       device="cpu")
    full = TM.init_model(cfg, TB.ParallelConfig(tp=TP, fuse_w13=True),
                         seed=0, dtype=torch.float32, device="cpu")
    ranks = [TM.shard_params(full, r, TP, cfg) for r in range(TP)]
    toks, lengths = _batch()
    want, _ = TS.prefill_logits(p1, {"tokens": toks}, TPContext(), cfg,
                                lengths)
    group = RankGroup(TP, "cpu", timeout_s=60)
    ctx = _ctx(group, "flux")
    outs = group.spmd(lambda p: TS.prefill_logits(
        p, {"tokens": toks}, ctx, cfg, lengths)[0], [(p,) for p in ranks])
    # the vocab is padded to 1024 at tp=8, 512 at tp=1
    got = torch.cat(outs, dim=-1)[:, :cfg.vocab_size]
    assert _rel(got.numpy(), want[:, :cfg.vocab_size].numpy()) <= LOGIT_RTOL
    nxt = group.spmd(lambda p: TS.prefill_step(
        p, {"tokens": toks}, ctx, cfg, lengths)[0], [(p,) for p in ranks])
    for n in nxt:
        np.testing.assert_array_equal(
            n.reshape(-1).numpy(),
            TS.vocab_parallel_argmax(want, cfg.vocab_size).numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step0_tp8_grads_are_eight_times_tp1(arch):
    cfg = _cfg(arch)
    par1 = TB.ParallelConfig(fuse_w13=True)
    p1 = TM.init_model(cfg, par1, seed=0, dtype=torch.float32, device="cpu",
                       trainable=True)
    par = TB.ParallelConfig(tp=TP, overlap_mode="flux", fuse_w13=True)
    full = TM.init_model(cfg, par, seed=0, dtype=torch.float32,
                         device="cpu", trainable=True)
    ranks = [TM.shard_params(full, r, TP, cfg) for r in range(TP)]
    batch = _train_batch()
    loss1, g1 = TT.loss_and_grads(p1, batch, TT.make_ctx(cfg, par1), cfg,
                                  par1)
    group = RankGroup(TP, "cpu", timeout_s=60)
    ctx = TT.make_ctx(cfg, par, group)

    def step(p):
        loss, grads = TT.loss_and_grads(p, batch, ctx, cfg, par)
        return loss, TT.complete_grads(grads, TM.replicated_leaves(cfg, p),
                                       group)

    outs = group.spmd(step, [(p,) for p in ranks])
    assert abs(outs[0][0].item() - loss1.item()) <= LOSS_RTOL * loss1.item()
    g8 = TM.canonical_leaves(TM.gather_rank_leaves(
        [g for _, g in outs], cfg, ranks[0]), cfg, TP, grads=True)
    c1 = TM.canonical_leaves(g1, cfg, 1, grads=True)
    assert sorted(g8) == sorted(c1)
    for n in c1:
        assert _rel(g8[n].numpy() / TP, c1[n].numpy()) <= TP1_GRAD_RTOL, n


@pytest.mark.parametrize("mode", ["xla", "flux"])
@pytest.mark.parametrize("arch", ARCHS)
def test_server_tp8_equals_tp1(arch, mode):
    """The paged ``Server`` at tp=8 (chunked prefill and decode in the
    replicated layout, each rank over its KV heads) against the tp=1
    ``Server`` from the same seed, fp32: every request's tokens equal,
    concurrent and one at a time."""
    from repro_torch.runtime.server import Request, ServeConfig, Server
    cfg = _cfg(arch)
    p1 = TM.init_model(cfg, TB.ParallelConfig(), seed=0, dtype=torch.float32,
                       device="cpu")
    par8 = TB.ParallelConfig(tp=TP, overlap_mode=mode)
    full = TM.init_model(cfg, par8, seed=0, dtype=torch.float32, device="cpu")
    ranks = [TM.shard_params(full, r, TP, cfg) for r in range(TP)]
    sc = dict(max_batch=2, max_seq=48, eos_token=-1, max_new_tokens=5,
              block_size=8, prefill_chunk=16)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (12, 20, 9)]

    def serve(srv, ps):
        done = srv.serve([Request(rid=i, prompt=p) for i, p in enumerate(ps)])
        assert all(r.done and r.error is None for r in done)
        return {r.rid: list(r.output) for r in done}

    want = serve(Server(cfg, TB.ParallelConfig(), p1, ServeConfig(**sc)),
                 prompts)
    srv8 = Server(cfg, par8, ranks, ServeConfig(**sc))
    assert srv8.group.n == TP
    assert serve(srv8, prompts) == want
    alone = Server(cfg, par8, ranks, ServeConfig(**sc), group=srv8.group)
    assert serve(alone, prompts[1:2]) == {0: want[1]}


@pytest.mark.parametrize("arch", ARCHS)
def test_chunk_logits_tp8_equal_tp1(arch):
    """The first-token logits of the paged chunked prefill
    (``prefill_chunk_logits`` through a ``Server``'s block tables, two
    chunks a prompt) at tp=8, the ranks' vocab shards side by side, within
    relative L2 ``LOGIT_RTOL`` of tp=1's from the same seed, fp32; their
    argmax is the first token each ``Server`` serves."""
    from repro_torch.runtime.server import Request, ServeConfig, Server
    cfg = _cfg(arch)
    p1 = TM.init_model(cfg, TB.ParallelConfig(), seed=0, dtype=torch.float32,
                       device="cpu")
    par8 = TB.ParallelConfig(tp=TP, overlap_mode="flux")
    full = TM.init_model(cfg, par8, seed=0, dtype=torch.float32, device="cpu")
    ranks = [TM.shard_params(full, r, TP, cfg) for r in range(TP)]
    sc = ServeConfig(max_batch=2, max_seq=48, eos_token=-1, max_new_tokens=1,
                     block_size=8, prefill_chunk=16)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (27, 19)]

    def first_logits(srv, prompt):
        job = srv.begin_admission(Request(rid=0, prompt=prompt))
        bt = srv._tensor(job.table.as_array(srv.pages)[None])
        while job.off < len(prompt):
            clen = min(sc.prefill_chunk, len(prompt) - job.off)
            toks = np.zeros((1, sc.prefill_chunk), np.int64)
            toks[0, :clen] = prompt[job.off:job.off + clen]
            toks = srv._tensor(toks)

            def chunk(p, cache, off=job.off, clen=clen, toks=toks):
                return TS.prefill_chunk_logits(p, cache, toks, bt, off, clen,
                                               srv.ctx, cfg)[0]
            if srv.group is None:
                logits = chunk(srv.params, srv.caches[0])
            else:
                logits = torch.cat(srv.group.spmd(
                    chunk, list(zip(srv.params, srv.caches))), -1)
            job.off += clen
        return logits[0, :cfg.vocab_size]

    srv1 = Server(cfg, TB.ParallelConfig(), p1, sc)
    srv8 = Server(cfg, par8, ranks, sc)
    for prompt in prompts:
        got, want = first_logits(srv8, prompt), first_logits(srv1, prompt)
        assert _rel(got.numpy(), want.numpy()) <= LOGIT_RTOL
        served = Server(cfg, par8, ranks, sc, group=srv8.group).serve(
            [Request(rid=0, prompt=prompt)])[0].output
        assert served == [int(got.argmax())] == [int(want.argmax())]

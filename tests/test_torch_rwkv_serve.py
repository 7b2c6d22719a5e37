"""RWKV-6 (rwkv6_3b) served by the port: the model level, against the
reference where it has a counterpart.

* The config: CONFIG and SMOKE_CONFIG equal the reference's field for
  field; ``count_params_analytic`` equals the reference's for rwkv6_3b at
  tp 1, 2 and 4 (the smoke config's too); ``tuning.autotune.model_seam_shapes``
  equals the reference's at tp 2 and 4.
* The smoke config (2 layers of (time-mix, channel-mix), d_model 128: 4
  heads of 32, d_ff 256) in fp32 compute, the reference's fp32 weights
  carried by ``convert``.  The reference runs once for the file, in one
  subprocess with 4 forced host devices (one thread a case):
  ``prefill_step`` and 4 ``decode_step`` steps under ``shard_map`` at tp=1
  and tp=4, the logits captured at ``vocab_parallel_argmax``, and
  ``forward_loss`` at tp=1 and at tp=4 in both layouts (its
  ``test_tp_invariance.py`` / ``test_sp_residency.py`` losses); the
  reference's configs, counts and seam shapes are read there too, so this
  process never imports JAX.  Its decode starts from its prefill caches
  with both token-shift rows rounded to bf16 (its serving caches' dtype),
  the port's from the same values.  The port runs tp=1 and tp=4 in xla /
  decomposed / decomposed_bidir / flux (the plain versions on the CPU) in
  both layouts.  Tolerances: next tokens equal; logits, losses and the
  wkv states within relative L2 1e-4 (fp32); ``last`` rows within 1e-4.
* Without the reference: the padded prefill against each row alone and
  against token-by-token decode (the reference's ``test_arch_smoke.py``
  and ``test_serving_regression.py`` properties); the chunked prefill
  against the batched one; the paged ``Server`` at tp=1 and tp=4 with
  recycled slots (concurrent = isolated, no prefix reuse), and a long
  prompt's chunks interleaved with another request's decodes; prefill and
  decode at dp=2 x tp=2 under ZeRO-3 against tp=1; the serve CLI; the dry
  run's cells.
"""
import dataclasses
import importlib
import json

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import base as TB
from repro_torch.configs.base import ParallelConfig, get_smoke_config
from repro_torch.dist import RankGroup
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.mesh import make_mesh, mesh_coords
from repro_torch.models import model as TM
from repro_torch.models import serve as TS
from repro_torch.parallel.sharding import make_ctx
from repro_torch.runtime.server import (Request, ServeConfig, Server,
                                        _arch_supports_reuse)

ARCH = "rwkv6_3b"
B, S, S_MAX, N_DECODE = 4, 24, 32, 4
LENGTHS = [24, 1, 13, 19]
MODES = ["xla", "decomposed", "decomposed_bidir", "flux"]
F32_RTOL = 1e-4
CHUNK_RTOL = 5e-3
STALE = 0.5                          # a freed slot's leftover state
# the reference's batched runs: (key, tp)
CASES = [("tp1", 1), ("tp4", 4)]
# the reference's losses: (tp, layout)
LOSSES = [(1, "seq"), (4, "seq"), (4, "hidden")]
# two slots and 8 usable blocks of 4: the pool holds two 12-token requests
# in flight, so four queue and take over freed slots and blocks
RECYCLE_KW = dict(max_batch=2, max_seq=64, eos_token=-1, max_new_tokens=4,
                  block_size=4, prefill_chunk=8, num_blocks=9)
# the reference's test_hybrid_state_survives_interleaved_decode's config
HYBRID_KW = dict(max_batch=2, max_seq=64, eos_token=-1, max_new_tokens=5,
                 block_size=4, prefill_chunk=4)

_REF = r"""
import dataclasses, functools, json, threading
from concurrent.futures import ThreadPoolExecutor
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.configs import rwkv6_3b as R
from repro.configs.base import get_smoke_config, ParallelConfig
from repro.launch.mesh import make_mesh
from repro.models import model as M, serve as S
from repro.parallel.sharding import TPContext
from repro.runtime import trainer as T
from repro.tuning.autotune import model_seam_shapes

inp = dict(np.load(IN))
out = {}
seen = {}

configs = {}
for which in ("CONFIG", "SMOKE_CONFIG"):
    c = getattr(R, which)
    configs[which] = {
        "fields": dataclasses.asdict(c),
        "defaults": {f.name: f.default for f in dataclasses.fields(c)
                     if f.default is not dataclasses.MISSING}}
out["configs"] = np.array(json.dumps(configs, default=dataclasses.asdict))
for size, c in (("full", R.CONFIG), ("smoke", R.SMOKE_CONFIG)):
    for tp in (1, 2, 4):
        out[f"count/{size}/{tp}"] = np.int64(M.count_params_analytic(
            c, False, ParallelConfig(tp=tp)))
out["seams"] = np.array(json.dumps({
    tp: model_seam_shapes(R.CONFIG, ParallelConfig(tp=tp))
    for tp in (2, 4)}))
_argmax = S.vocab_parallel_argmax


def _capture(logits_loc, *a, **k):
    seen[threading.get_ident()] = logits_loc
    return _argmax(logits_loc, *a, **k)


S.vocab_parallel_argmax = _capture


def save(tree, prefix):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in flat:
        key = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                       for q in path)
        out[prefix + key] = np.asarray(leaf, np.float32)


def serving(caches):
    # the token-shift rows rounded to bf16 (the serving caches' dtype),
    # held in fp32 as the fp32 decode computes on them
    def fix(path, a):
        if str(getattr(path[-1], "key", "")) == "last":
            return a.astype(jnp.bfloat16).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(fix, caches)


cfg = dataclasses.replace(get_smoke_config("rwkv6_3b"),
                          compute_dtype="float32")
toks, lengths = jnp.asarray(inp["tokens"]), jnp.asarray(inp["lengths"])
labels = jnp.asarray(inp["labels"])


def run(key, tp):
    par = ParallelConfig(tp=tp)
    mesh = make_mesh(1, 1, tp)
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
        return nxt, caches, seen.pop(threading.get_ident())

    @jax.jit
    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(specs, cspec, rows, P(dpax)),
                       out_specs=(rows, cspec, logit), check_vma=False)
    def decode(p, c, t, pos):
        nxt, c = S.decode_step(p, c, t, pos, ctx, cfg, par)
        return nxt, c, seen.pop(threading.get_ident())

    nxt, caches, lg = prefill(params, toks, lengths)
    out[key + "/prefill/next"] = np.asarray(nxt)
    out[key + "/prefill/logits"] = np.asarray(lg, np.float32)
    save(caches, key + "/caches/")
    c = serving(caches)
    save(c, key + "/start/")
    for step in range(int(inp["n_decode"])):
        nxt, c, lg = decode(params, c, nxt, lengths + step)
        out[f"{key}/decode/{step}/next"] = np.asarray(nxt)
        out[f"{key}/decode/{step}/logits"] = np.asarray(lg, np.float32)
    save(params, key + "/params/")


def loss(tp, layout):
    par = ParallelConfig(tp=tp, dp=1)
    mesh = Mesh(np.array(jax.devices()[:tp]).reshape(1, tp),
                ("data", "model"))
    params = M.init_model(jax.random.PRNGKey(0), cfg, par, dtype=jnp.float32)
    specs = M.param_specs(cfg, par, params)
    ctx = TPContext(axis="model", mode="decomposed",
                    seq_shard=layout == "seq")
    f = jax.jit(functools.partial(
        shard_map, mesh=mesh, in_specs=(specs, P(), P()), out_specs=P(),
        check_vma=False)(lambda p, t, l: M.forward_loss(
            p, {"tokens": t, "labels": l}, ctx, cfg, par)))
    out[f"loss/{tp}/{layout}"] = np.asarray(f(params, toks, labels))


jobs = [lambda c=c: run(*c) for c in %(cases)r] + [
    lambda c=c: loss(*c) for c in %(losses)r]
with ThreadPoolExecutor(len(jobs)) as pool:
    list(pool.map(lambda j: j(), jobs))
np.savez(OUT, **out)
print("REF_OK")
"""


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The smoke model's ops are small: one intra-op thread runs them
    faster than a pool does, and a pool in each of the suite's workers
    oversubscribes the cores they share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return dataclasses.replace(get_smoke_config(ARCH),
                               compute_dtype="float32")


def _inputs():
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 512, (B, S)).astype(np.int32)
    for b, n in enumerate(LENGTHS):
        toks[b, n:] = 0                      # right padding
    labels = rng.integers(0, 512, (B, S)).astype(np.int32)
    return {"tokens": toks, "lengths": np.array(LENGTHS, np.int32),
            "labels": labels, "s_max": S_MAX, "n_decode": N_DECODE}


@pytest.fixture(scope="module")
def ref(tmp_path_factory, subproc):
    d = tmp_path_factory.mktemp("rwkv")
    np.savez(d / "in.npz", **_inputs())
    code = (_REF % {"cases": CASES, "losses": LOSSES}).replace(
        "B_, S_", f"{B}, {S_MAX}").replace(
        "IN)", repr(str(d / "in.npz")) + ")").replace(
        "OUT,", repr(str(d / "out.npz")) + ",")
    assert "REF_OK" in subproc(code, n_devices=4)
    return dict(np.load(d / "out.npz"))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _tree(flat, prefix):
    """The reference's nested tree from "a/0/b"-keyed numpy leaves."""
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


# ---------------------------------------------------------------------------
# the config, the parameter count, the seam shapes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["CONFIG", "SMOKE_CONFIG"])
def test_config_equals_reference(ref, which):
    ref_cfg = json.loads(ref["configs"].item())[which]
    cfg = getattr(importlib.import_module(f"repro_torch.configs.{ARCH}"),
                  which)
    got = json.loads(json.dumps(dataclasses.asdict(cfg)))
    want = ref_cfg["fields"]
    assert set(got) <= set(want)
    assert got == {k: want[k] for k in got}
    for k in set(want) - set(got):
        assert want[k] == ref_cfg["defaults"][k], k
    assert ARCH in TB.ARCH_IDS
    get = TB.get_config if which == "CONFIG" else TB.get_smoke_config
    assert get(ARCH) is cfg


@pytest.mark.parametrize("size", ["full", "smoke"])
def test_param_count_equals_reference(ref, size):
    """rwkv6_3b's count at tp 1, 2 and 4 (its heads and d_ff padded);
    at full size and tp=1 about 2.9 B (the lane's weights)."""
    cfg = TB.get_config(ARCH) if size == "full" else get_smoke_config(ARCH)
    for tp in (1, 2, 4):
        got = TM.count_params_analytic(cfg, par=ParallelConfig(tp=tp))
        assert got == int(ref[f"count/{size}/{tp}"]), tp
        assert got == TM.count_params_analytic(cfg, True,
                                               ParallelConfig(tp=tp))
    if size == "full":
        assert 2.8e9 < TM.count_params_analytic(cfg) < 3.0e9


def test_seam_shapes_equal_reference(ref):
    from repro_torch.tuning.autotune import model_seam_shapes
    want = json.loads(ref["seams"].item())
    for tp in (2, 4):
        got = model_seam_shapes(TB.get_config(ARCH), ParallelConfig(tp=tp))
        assert json.loads(json.dumps(got)) == want[str(tp)], tp


# ---------------------------------------------------------------------------
# prefill, decode and the loss against the reference
# ---------------------------------------------------------------------------
def _full(ref, key):
    return convert.params_from_jax(_tree(ref, key + "/params/"), _cfg(),
                                   dtype=torch.float32, device="cpu")


def _start(ref, key):
    """The reference's decode start: its prefill caches, ``last`` rounded
    to bf16, held in fp32 as the fp32 reference computes on them."""
    caches = convert.caches_from_jax(_tree(ref, key + "/start/"), _cfg(),
                                     device="cpu")
    for c in caches:
        assert sorted(c) == ["ffn.last", "last", "state"]
        assert c["state"].dtype == torch.float32
        for n in ("last", "ffn.last"):
            assert c[n].dtype == torch.bfloat16
            c[n] = c[n].float()
    return caches


def _piece(caches, rows, m, tp):
    """A rank's piece of the global caches: its batch rows and its TP
    block of the heads (the wkv state's dim 1); ``last`` rows whole."""
    return [{n: (t[rows].chunk(tp, 1)[m] if n == "state" else t[rows])
             .clone() for n, t in c.items()} for c in caches]


def _run(cfg, par, ranks, mesh, group, toks, lengths, start):
    """Prefill, then N_DECODE decode steps from ``start`` on every rank:
    per step (the tokens [B], the logits [B, V_pad]) put together from the
    ranks, and each rank's prefill caches."""
    def body(p, r):
        ctx = (make_ctx(par, mesh=mesh) if mesh is not None
               else make_ctx(par, group))
        coords = (mesh_coords(mesh, r) if mesh is not None
                  else {"model": r})
        rows = TS.dp_rows(par, B, coords)
        lg, own = TS.prefill_logits(p, {"tokens": toks[rows]}, ctx, cfg,
                                    lengths[rows])
        nxt = TS.vocab_parallel_argmax(lg, cfg.vocab_size, ctx)[:, None]
        steps = [(nxt, lg)]
        caches = _piece(start, rows, coords["model"], par.tp)
        for step in range(N_DECODE):
            lg, caches = TS.decode_logits(p, caches, nxt,
                                          lengths[rows] + step, ctx, cfg)
            nxt = TS.vocab_parallel_argmax(lg, cfg.vocab_size, ctx)[:, None]
            steps.append((nxt, lg))
        return steps, own, rows.start, coords["model"]

    if mesh is not None:
        outs = mesh.spmd(body, [(p, r) for r, p in enumerate(ranks)])
    elif group is not None:
        outs = group.spmd(body, [(p, r) for r, p in enumerate(ranks)])
    else:
        outs = [body(ranks[0], 0)]
    got = []
    for s in range(N_DECODE + 1):
        blocks = {}
        for o in outs:
            blocks.setdefault(o[2], []).append(o[0][s])
        for group_ in blocks.values():
            assert all(torch.equal(x[0], group_[0][0]) for x in group_)
        tok = torch.cat([blocks[i][0][0] for i in sorted(blocks)])
        lg = torch.cat([torch.cat([x[1] for x in blocks[i]], -1)
                        for i in sorted(blocks)])
        got.append((tok.reshape(-1).numpy(), lg.numpy()))
    return got, outs


def _check(ref, key, got, outs, tp):
    names = ["prefill"] + [f"decode/{s}" for s in range(N_DECODE)]
    for (tok, lg), what in zip(got, names):
        np.testing.assert_array_equal(
            tok, ref[f"{key}/{what}/next"].reshape(-1), err_msg=what)
        assert _rel(lg, ref[f"{key}/{what}/logits"]) <= F32_RTOL, what
    # each rank's prefill caches against its piece of the reference's
    want = [{**{n: torch.from_numpy(np.array(a))
                for n, a in layer["mixer"].items()},
             **{"ffn." + n: torch.from_numpy(np.array(a))
                for n, a in layer["ffn"].items()}}
            for layer in TM.layer_trees(_tree(ref, key + "/caches/"),
                                        _cfg())]
    for own, start, m in (o[1:] for o in outs):
        n_rows = own[0]["state"].shape[0]
        for i, (g, w) in enumerate(zip(own, _piece(
                want, slice(start, start + n_rows), m, tp))):
            assert sorted(g) == sorted(w)
            for n in g:
                assert _rel(g[n].numpy(), w[n].numpy()) <= F32_RTOL, (i, n)


def _tokens():
    inp = _inputs()
    return (torch.from_numpy(inp["tokens"]).long(),
            torch.from_numpy(inp["lengths"]).long())


def test_prefill_decode_tp1_matches_reference(ref):
    toks, lengths = _tokens()
    got, outs = _run(_cfg(), ParallelConfig(), [_full(ref, "tp1")], None,
                     None, toks, lengths, _start(ref, "tp1"))
    _check(ref, "tp1", got, outs, 1)


@pytest.mark.parametrize("layout", ["seq", "hidden"])
@pytest.mark.parametrize("mode", MODES)
def test_prefill_decode_tp4_matches_reference(ref, mode, layout):
    cfg = _cfg()
    par = ParallelConfig(tp=4, overlap_mode=mode, scatter_axis=layout)
    full = _full(ref, "tp4")
    ranks = [TM.shard_params(full, r, 4, cfg) for r in range(4)]
    toks, lengths = _tokens()
    got, outs = _run(cfg, par, ranks, None, RankGroup(4, "cpu", timeout_s=60),
                     toks, lengths, _start(ref, "tp4"))
    _check(ref, "tp4", got, outs, 4)


@pytest.mark.parametrize("tp,layout,mode",
                         [(1, "seq", "decomposed"), (4, "seq", "decomposed"),
                          (4, "seq", "flux"), (4, "hidden", "decomposed"),
                          (4, "hidden", "flux")])
def test_forward_loss_matches_reference(ref, tp, layout, mode):
    """``forward_loss`` (forward only: no grad) at tp=1 and tp=4 in both
    layouts against the reference's loss at that tp and layout."""
    cfg = _cfg()
    par = ParallelConfig(tp=tp, overlap_mode=mode, scatter_axis=layout)
    full = _full(ref, f"tp{tp}")
    inp = _inputs()
    batch = {"tokens": torch.from_numpy(inp["tokens"]).long(),
             "labels": torch.from_numpy(inp["labels"]).long()}
    want = float(ref[f"loss/{tp}/{layout}"])

    def body(p, group=None):
        with torch.no_grad():
            return TM.forward_loss(p, batch, make_ctx(par, group), cfg,
                                   par).item()
    if tp == 1:
        losses = [body(full)]
    else:
        group = RankGroup(tp, "cpu", timeout_s=60)
        losses = group.spmd(lambda p: body(p, group), [
            (TM.shard_params(full, r, tp, cfg),) for r in range(tp)])
    for got in losses:
        assert abs(got - want) <= F32_RTOL * abs(want), (got, want)


# ---------------------------------------------------------------------------
# without the reference
# ---------------------------------------------------------------------------
def _ranks(cfg, tp, dtype=torch.float32):
    full = TM.init_model(cfg, ParallelConfig(tp=tp), seed=0, dtype=dtype,
                         device="cpu")
    if tp == 1:
        return full
    return [TM.shard_params(full, r, tp, cfg) for r in range(tp)]


def test_padded_prefill_equals_rows_alone_and_decode():
    """At tp=1: each row of the right-padded batch equals the row's
    prefill alone (logits, the wkv state and both ``last`` rows), other
    tokens at the pad positions change nothing bit for bit (k = 0 and
    logw = 0 freeze the state), and the prefill of a prompt equals its
    token-by-token decode from an empty state (every step's logits)."""
    cfg = _cfg()
    params = _ranks(cfg, 1)
    ctx = make_ctx(ParallelConfig())
    toks, lengths = _tokens()
    lg, caches = TS.prefill_logits(params, {"tokens": toks}, ctx, cfg,
                                   lengths)
    noise = torch.randint(0, 512, toks.shape,
                          generator=torch.Generator().manual_seed(1))
    pad = torch.arange(S)[None] >= lengths[:, None]
    lg_n, c_n = TS.prefill_logits(params, {"tokens": torch.where(
        pad, noise, toks)}, ctx, cfg, lengths)
    assert torch.equal(lg_n, lg)
    assert all(torch.equal(a[n], b[n]) for a, b in zip(caches, c_n)
               for n in a)
    for r, n in enumerate(LENGTHS):
        la, ca = TS.prefill_logits(params, {"tokens": toks[r:r + 1, :n]},
                                   ctx, cfg)
        assert _rel(la[0].numpy(), lg[r].numpy()) <= F32_RTOL, r
        for i, layer in enumerate(caches):
            for k in layer:
                assert _rel(ca[i][k][0].numpy(),
                            layer[k][r].numpy()) <= F32_RTOL, (r, i, k)
    # token by token from an empty state, the caches fp32 (the prefill's)
    row = toks[0:1, :12]
    specs = TS.cache_specs(cfg, ParallelConfig(), 1, 16)
    state = [{n: torch.zeros(s.shape) for n, s in layer.items()}
             for layer in specs]
    for t in range(row.shape[1]):
        step, state = TS.decode_logits(params, state, row[:, t:t + 1], t,
                                       ctx, cfg)
        want, _ = TS.prefill_logits(params, {"tokens": row[:, :t + 1]}, ctx,
                                    cfg)
        assert _rel(step.numpy(), want.numpy()) <= F32_RTOL, t


@pytest.mark.parametrize("tp", [1, 4])
def test_chunked_prefill_equals_batched(tp):
    """Two prompts (lengths 19 and 5) through the chunked prefill in
    chunks of 8, each in its own slot (holding a stale state, which the
    first chunk must zero), interleaved: the final chunk's logits and the
    slot's state rows against the batched prefill.  A chunk carries bf16
    ``last`` rows (the serving caches') where the batched prefill holds
    fp32: the logits, the wkv state and ``last`` within relative L2 5e-3,
    the same next tokens; another slot's state untouched."""
    cfg = _cfg()
    par = ParallelConfig(tp=tp)
    params = _ranks(cfg, tp)
    ranks = [params] if tp == 1 else params
    group = RankGroup(tp, "cpu", timeout_s=60) if tp > 1 else None
    toks = _tokens()[0][[0, 3]]
    lens = [19, 5]
    c, bs = 8, 4
    pages = S_MAX // bs

    def body(p, r):
        ctx = make_ctx(par, group)
        lg, batched = TS.prefill_logits(p, {"tokens": toks}, ctx, cfg,
                                        torch.tensor(lens))
        paged = TS.zeros_from_specs(
            TS.paged_cache_specs(cfg, par, 2 * pages + 1, bs, 3), "cpu")
        for layer in paged:
            for t in layer.values():
                t.fill_(STALE)
        bt = torch.zeros((3, pages), dtype=torch.int32)
        bt[1] = torch.arange(1, pages + 1)
        bt[2] = torch.arange(pages + 1, 2 * pages + 1)
        last = {}
        for off in range(0, max(lens), c):
            for i, slot in ((0, 1), (1, 2)):
                if off >= lens[i]:
                    continue
                n = min(c, lens[i] - off)
                chunk = torch.zeros((1, c), dtype=torch.long)
                chunk[0, :n] = toks[i, off:off + n]
                last[i], _ = TS.prefill_chunk_logits(
                    p, paged, chunk, bt[slot:slot + 1], off, n, ctx, cfg,
                    slot=slot)
        return lg, torch.cat([last[0], last[1]]), batched, paged

    outs = (group.spmd(body, [(p, r) for r, p in enumerate(ranks)])
            if group else [body(ranks[0], 0)])
    lg = torch.cat([o[0] for o in outs], -1)
    chunked = torch.cat([o[1] for o in outs], -1)
    assert _rel(chunked.numpy(), lg.numpy()) <= CHUNK_RTOL
    assert torch.equal(chunked.argmax(-1), lg.argmax(-1))
    for _, _, batched, paged in outs:
        for i, (b_layer, p_layer) in enumerate(zip(batched, paged)):
            assert sorted(p_layer) == ["ffn.last", "last", "state"]
            for j, slot in ((0, 1), (1, 2)):
                for n in p_layer:
                    assert _rel(p_layer[n][slot].float().numpy(),
                                b_layer[n][j].numpy()) <= CHUNK_RTOL, (
                        i, j, n)
            for n in p_layer:
                assert (p_layer[n][0] == STALE).all()    # slot 0 untouched


def _serve(srv, prompts):
    done = srv.serve([Request(rid=i, prompt=p) for i, p in enumerate(prompts)])
    assert all(r.done and r.error is None for r in done)
    return {r.rid: list(r.output) for r in done}


def _server(cfg, par, params, kw):
    return Server(cfg, par, params, ServeConfig(**kw))


@pytest.mark.parametrize("tp", [1, 4])
def test_server_concurrent_equals_isolated(tp):
    """Four 12-token requests on two slots and a pool that holds two (the
    later ones take over freed slots, whose state the first chunk zeroes,
    and blocks), and the reference's interleaved-decode case (the
    14-token prompt prefills over 4 chunks, each followed by a decode
    step of the generating 3-token slot, which must leave the mid-prefill
    slot's state, ``last`` and ``ffn.last`` rows alone): every request's
    tokens equal its tokens served alone; no prefix reuse (recurrent
    state is not block-addressable)."""
    cfg = _cfg()
    assert not _arch_supports_reuse(cfg)
    par = ParallelConfig(tp=tp, overlap_mode="flux")
    params = _ranks(cfg, tp)
    rng = np.random.default_rng(13)
    for kw, prompts in (
            (RECYCLE_KW, [rng.integers(0, 512, size=(12,)).astype(np.int32)
                          for _ in range(4)]),
            (HYBRID_KW, [rng.integers(0, 512, size=(n,)).astype(np.int32)
                         for n in (3, 14)])):
        srv = _server(cfg, par, params, kw)
        assert not srv._reuse_ok
        got = _serve(srv, prompts)
        assert srv.pool.reuse_hits == 0
        if kw is RECYCLE_KW:
            assert srv.pool.peak_blocks_in_use == srv.pool.num_blocks - 1
        for i, p in enumerate(prompts):
            alone = _serve(_server(cfg, par, params, kw), [p])[0]
            assert alone == got[i], (kw, i)


@pytest.mark.parametrize("mode", ["decomposed", "flux"])
def test_mesh_dp2_tp2_zero3_equals_tp1(mode):
    """Prefill and 4 decode steps at dp=2 x tp=2 under ZeRO-3 (each data
    replica its two rows of the batch; the flagged leaves gathered a
    layer at a time) against tp=1 on the same canonical weights: tokens
    equal, logits and every cache leaf within 1e-4."""
    cfg = _cfg()
    par = ParallelConfig(tp=2, dp=2, zero3=True, overlap_mode=mode)
    z3 = TM.zero3_leaves(cfg, par)
    assert {"layers.0.ffn.mu", "layers.0.ffn.w_r",
            "layers.0.mixer.w_dec1"} <= z3
    assert "layers.0.mixer.mu" not in z3               # 5 rows: dp=2 can't
    full = TM.init_model(cfg, ParallelConfig(tp=2), seed=0,
                         dtype=torch.float32, device="cpu")
    one = TM.rebuild(TM.meta_model(cfg, ParallelConfig()),
                     TM.canonical_leaves(dict(full.named_parameters()), cfg,
                                         2))
    mesh = make_mesh(1, 2, 2, "cpu")
    mesh.timeout_s = 60
    ranks = [TM.mesh_shard(full, cfg, par, mesh_coords(mesh, r))
             for r in range(mesh.size)]
    toks, lengths = _tokens()
    ctx1 = make_ctx(ParallelConfig())
    lg1, c1 = TS.prefill_logits(one, {"tokens": toks}, ctx1, cfg, lengths)
    start = [{n: t.clone() for n, t in layer.items()} for layer in c1]
    want = [(TS.vocab_parallel_argmax(lg1, cfg.vocab_size), lg1)]
    caches = [{n: t.clone() for n, t in layer.items()} for layer in c1]
    nxt = want[0][0][:, None]
    for step in range(N_DECODE):
        lg, caches = TS.decode_logits(one, caches, nxt, lengths + step,
                                      ctx1, cfg)
        nxt = TS.vocab_parallel_argmax(lg, cfg.vocab_size)[:, None]
        want.append((nxt[:, 0], lg))
    got, outs = _run(cfg, par, ranks, mesh, None, toks, lengths, start)
    for (tok, lg), (wt, wl) in zip(got, want):
        np.testing.assert_array_equal(tok, wt.numpy())
        assert _rel(lg, wl.numpy()) <= F32_RTOL
    for own, row0, m in (o[1:] for o in outs):
        rows = slice(row0, row0 + own[0]["state"].shape[0])
        for g, w in zip(own, _piece(c1, rows, m, 2)):
            for n in g:
                assert _rel(g[n].numpy(), w[n].numpy()) <= F32_RTOL, n


def test_serve_cli_tp_and_dp():
    """``launch.serve --arch rwkv6_3b`` at tp=1, ``--tp 2`` and ``--dp 2
    --tp 2`` (fp32 compute would be exact; the smoke config's bf16 tokens
    agree here), with ``--layers 1`` serving one (time-mix, channel-mix)
    layer."""
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "2",
            "--max-new", "4"]
    _, done1 = launch_serve.main(argv)
    _, done2 = launch_serve.main(argv + ["--tp", "2", "--mode", "flux"])
    srv, done = launch_serve.main(argv + ["--tp", "2", "--dp", "2", "--mode",
                                          "flux"])
    assert srv.mesh.shape == (2, 2)
    toks = [{r.rid: r.output for r in d} for d in (done1, done2, done)]
    assert all(len(o) == 4 for t in toks for o in t.values())
    assert toks[0] == toks[1] == toks[2]
    cli, done = launch_serve.main(argv + ["--layers", "1"])
    assert cli.cfg.num_layers == 1 and len(done) == 2


def test_dryrun_cells():
    """rwkv6_3b's dry-run cells, long_500k among them (sub-quadratic):
    a decode cell's cache bytes a rank are the wkv state of its heads (40
    padded to 48 at tp=16: 3 a rank) and the two ``last`` rows of its
    rows, whatever the sequence length."""
    from repro_torch.configs.base import SHAPES, get_config, shape_applicable
    from repro_torch.launch import dryrun as D
    cfg = get_config(ARCH)
    assert shape_applicable(cfg, SHAPES["long_500k"])
    cells = {s: D.cell(ARCH, s, multi_pod=False) for s in SHAPES}
    for s in ("decode_32k", "long_500k"):
        c = cells[s]
        rows = c["batch_rows_per_rank"]
        hl = -(-40 // c["axis_sizes"]["model"])    # 40 heads padded to tp
        want = cfg.num_layers * rows * (hl * 64 * 64 * 4 + 2 * 2560 * 2)
        assert c["bytes_per_rank"]["caches"] == want, s
    assert cells["train_4k"]["params"] == TM.count_params_analytic(cfg)

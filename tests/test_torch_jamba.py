"""Jamba-v0.1 (jamba_v01_52b) served by the port, against the reference.

* The config: CONFIG and SMOKE_CONFIG equal the reference's field for
  field (its fields the port lacks at their defaults);
  ``count_params_analytic`` (and ``active_only``) equals the reference's
  on the smoke config at tp=1 and with tp=4's padding.
* Jamba's smoke config cut to one period (8 layers: 7 Mamba, 1 GQA, 4
  dense and 4 MoE FFNs) in fp32 compute, the reference's fp32 weights
  carried by ``convert`` (``fuse_w13`` off at tp=1 and at dp=2 x tp=2,
  on at tp=4: ``w_in_xz`` and ``w13`` packed per device).  The reference
  runs once for the file, in one subprocess with 4 forced host devices:
  ``prefill_step`` and 4 ``decode_step`` steps under ``shard_map`` at
  tp=1, tp=4 and dp=2 x tp=2 with ZeRO-3 (the batch over "data"; one
  thread a case), the logits captured at ``vocab_parallel_argmax``; the
  reference's configs and its analytic count are read there too, so that
  this process never imports JAX.  Its decode starts from
  its prefill caches with the conv tails rounded to bf16 (its serving
  caches' dtype); the port's from the same values.  The port runs tp=1,
  tp=4 in xla, decomposed and flux (the plain versions on the CPU) in
  both layouts, and dp=2 x tp=2 under ZeRO-3 on a ``dist.RankMesh``.
  Tolerances: next tokens equal; logits (the ranks' vocab shards and rows
  put together) and the Mamba states (conv, ssm) within relative L2 1e-4
  (the scan associates its products in another order than XLA's); K/V
  (bf16 both sides) within 2e-2.

The chunked prefill, the paged ``Server`` and the serve CLI, which need no
reference run, are in ``tests/test_torch_jamba_serve.py``.
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
from repro_torch.launch.mesh import make_mesh, mesh_coords
from repro_torch.models import model as TM
from repro_torch.models import serve as TS
from repro_torch.parallel.sharding import make_ctx

ARCH = "jamba_v01_52b"
LAYERS = 8                           # one period of the pattern
B, S, S_MAX, N_DECODE = 4, 24, 32, 4
LENGTHS = [24, 2, 13, 19]            # 2 < d_conv - 1
MODES = ["xla", "decomposed", "flux"]
F32_RTOL = 1e-4
KV_TOL = 2e-2
# the reference's batched runs: (key, dp, tp, zero3, fuse_w13)
CASES = [("tp1", 1, 1, False, False), ("tp4", 1, 4, False, True),
         ("dp2tp2", 2, 2, True, False)]

_REF = r"""
import dataclasses, functools, json, threading
from concurrent.futures import ThreadPoolExecutor
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.configs import jamba_v01_52b as J
from repro.configs.base import get_smoke_config, ParallelConfig
from repro.launch.mesh import make_mesh
from repro.models import model as M, serve as S
from repro.runtime import trainer as T

inp = dict(np.load(IN))
out = {}
seen = {}

# the configs (each field and each field's default, as JSON) and the smoke
# config's analytic count
configs = {}
for which in ("CONFIG", "SMOKE_CONFIG"):
    c = getattr(J, which)
    configs[which] = {
        "fields": dataclasses.asdict(c),
        "defaults": {f.name: f.default for f in dataclasses.fields(c)
                     if f.default is not dataclasses.MISSING}}
out["configs"] = np.array(json.dumps(configs, default=dataclasses.asdict))
for tp in (1, 4):
    for active in (False, True):
        out[f"count/{tp}/{int(active)}"] = np.int64(M.count_params_analytic(
            J.SMOKE_CONFIG, active, ParallelConfig(tp=tp)))
_argmax = S.vocab_parallel_argmax


def _capture(logits_loc, *a, **k):
    # the cases trace in threads of their own: one slot a thread
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
    # K/V padded to S_MAX positions, the conv tails rounded to bf16 (held
    # in fp32, the dtype its decode returns them in: one decode compile)
    def fix(path, a):
        name = str(getattr(path[-1], "key", ""))
        if name == "conv":
            return a.astype(jnp.bfloat16).astype(a.dtype)
        if name in ("k", "v"):
            w = [(0, 0)] * a.ndim
            w[2] = (0, int(inp["s_max"]) - a.shape[2])
            return jnp.pad(a, w)
        return a
    return jax.tree_util.tree_map_with_path(fix, caches)


cfg = dataclasses.replace(get_smoke_config("jamba_v01_52b"),
                          num_layers=LAYERS_, compute_dtype="float32")
toks, lengths = jnp.asarray(inp["tokens"]), jnp.asarray(inp["lengths"])


def run(key, dp, tp, zero3, fuse):
    par = ParallelConfig(tp=tp, dp=dp, zero3=zero3, fuse_w13=fuse)
    mesh = make_mesh(1, dp, tp)
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


# one thread a case: one case's compiles overlap the others' tracing
with ThreadPoolExecutor(len(%(cases)r)) as pool:
    list(pool.map(lambda case: run(*case), %(cases)r))
np.savez(OUT, **out)
print("REF_OK")
"""


# ---------------------------------------------------------------------------
# the config and the parameter count
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["CONFIG", "SMOKE_CONFIG"])
def test_config_equals_reference(ref, which):
    """Field for field, through JSON (the reference's read in its
    subprocess), the reference's fields the port lacks at their
    defaults."""
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


@pytest.mark.parametrize("tp", [1, 4])
def test_param_count_equals_reference(ref, tp):
    """The smoke config's count, total and active, at tp=1 and with tp=4's
    padding (the full size's: ``tests/test_torch_paper_models.py``)."""
    for active in (False, True):
        got = TM.count_params_analytic(get_smoke_config(ARCH), active,
                                       ParallelConfig(tp=tp))
        assert got == int(ref[f"count/{tp}/{int(active)}"]), active


# ---------------------------------------------------------------------------
# prefill and decode against the reference
# ---------------------------------------------------------------------------
def _cfg():
    return dataclasses.replace(get_smoke_config(ARCH), num_layers=LAYERS,
                               compute_dtype="float32")


def _inputs():
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 512, (B, S)).astype(np.int32)
    for b, n in enumerate(LENGTHS):
        toks[b, n:] = 0                      # right padding
    return {"tokens": toks, "lengths": np.array(LENGTHS, np.int32),
            "s_max": S_MAX, "n_decode": N_DECODE}


@pytest.fixture(scope="module")
def ref(tmp_path_factory, subproc):
    d = tmp_path_factory.mktemp("jamba")
    np.savez(d / "in.npz", **_inputs())
    code = (_REF % {"cases": CASES}).replace("B_, S_", f"{B}, {S}").replace(
        "LAYERS_", str(LAYERS)).replace(
        "IN)", repr(str(d / "in.npz")) + ")").replace(
        "OUT,", repr(str(d / "out.npz")) + ",")
    assert "REF_OK" in subproc(code, n_devices=4)
    return dict(np.load(d / "out.npz"))


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


def _flat(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _case(key):
    return next(c for c in CASES if c[0] == key)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _full(ref, key):
    return convert.params_from_jax(_tree(ref, key + "/params/"), _cfg(),
                                   dtype=torch.float32, device="cpu")


def _start(ref, key):
    """The reference's decode start: its prefill caches, conv rounded to
    bf16 (``convert.caches_from_jax`` keeps ssm fp32), held in fp32 as the
    fp32 reference computes on them."""
    caches = convert.caches_from_jax(_tree(ref, key + "/start/"), _cfg(),
                                     device="cpu")
    for c in caches:
        if "conv" in c:
            assert c["conv"].dtype == torch.bfloat16
            assert c["ssm"].dtype == torch.float32
            c["conv"] = c["conv"].float()
    return caches


def _piece(caches, rows, m, tp):
    """A rank's piece of the global caches: its batch rows, and its TP
    block of the KV heads (K/V dim 2) and channels (conv dim 2, ssm dim
    1)."""
    dims = {"k": 2, "v": 2, "conv": 2, "ssm": 1}
    return [{n: t[rows].chunk(tp, dims[n])[m].clone() for n, t in c.items()}
            for c in caches]


def _run(cfg, par, ranks, mesh, group, toks, lengths, start):
    """Prefill, then N_DECODE decode steps from ``start`` on every rank:
    per step (the tokens [B], the logits [B, V_pad]) put together from the
    ranks, and rank 0's prefill caches with each rank's pieces put back
    together."""
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


def _ref_caches(ref, key):
    """The reference's prefill caches, a dict a layer, as saved (fp32)."""
    return [{n: torch.from_numpy(np.array(a))
             for n, a in layer["mixer"].items()}
            for layer in TM.layer_trees(_tree(ref, key + "/caches/"), _cfg())]


def _check(ref, key, got, outs, par):
    names = ["prefill"] + [f"decode/{s}" for s in range(N_DECODE)]
    for (tok, lg), what in zip(got, names):
        np.testing.assert_array_equal(
            tok, ref[f"{key}/{what}/next"].reshape(-1), err_msg=what)
        assert _rel(lg, ref[f"{key}/{what}/logits"]) <= F32_RTOL, what
    # each rank's prefill caches against its piece of the reference's
    want = _ref_caches(ref, key)
    for own, start, m in (o[1:] for o in outs):
        rows = slice(start, start + next(iter(own[0].values())).shape[0])
        for i, (g, w) in enumerate(zip(own, _piece(want, rows, m, par.tp))):
            for n in g:
                if n in ("conv", "ssm"):
                    assert _rel(g[n].numpy(), w[n].numpy()) <= F32_RTOL, (
                        i, n)
                else:
                    np.testing.assert_allclose(
                        g[n].float().numpy(), w[n].numpy(), atol=KV_TOL,
                        rtol=KV_TOL, err_msg=f"{i} {n}")


def test_convert_carries_every_leaf(ref):
    """``params_from_jax`` carries the reference's Jamba tree leaf for
    leaf, unfused (tp=1) and packed (tp=4: ``w_in_xz``, ``w13``), the
    reference's fp32 leaves (``ffn.FP32_PARAMS``) in fp32."""
    from repro_torch.models.ffn import FP32_PARAMS
    cfg = _cfg()
    for key in ("tp1", "tp4"):
        p = convert.params_from_jax(_tree(ref, key + "/params/"), cfg,
                                    dtype=torch.bfloat16, device="cpu")
        named = dict(p.named_parameters())
        assert ("layers.0.mixer.w_in_xz" in named) == _case(key)[4]
        for n in ("layers.0.mixer.a_log", "layers.0.mixer.d_skip",
                  "layers.1.ffn.router"):
            assert named[n].dtype == torch.float32, n
        assert named["layers.0.mixer.dt_bias"].dtype == torch.bfloat16
        back = _flat(convert.to_jax_tree(named, cfg))
        want = {k[len(key) + 8:]: v for k, v in ref.items()
                if k.startswith(key + "/params/")}
        assert sorted(back) == sorted(want)
        for k, v in want.items():
            dt = (torch.float32 if k.split("/")[-1] in FP32_PARAMS
                  else torch.bfloat16)
            np.testing.assert_array_equal(
                back[k], torch.from_numpy(v).to(dt).float().numpy(),
                err_msg=k)


def test_prefill_decode_tp1_matches_reference(ref):
    cfg = _cfg()
    par = ParallelConfig()
    inp = _inputs()
    got, outs = _run(cfg, par, [_full(ref, "tp1")], None, None,
                     torch.from_numpy(inp["tokens"]).long(),
                     torch.from_numpy(inp["lengths"]).long(),
                     _start(ref, "tp1"))
    _check(ref, "tp1", got, outs, par)


@pytest.mark.parametrize("layout", ["seq", "hidden"])
@pytest.mark.parametrize("mode", MODES)
def test_prefill_decode_tp4_matches_reference(ref, mode, layout):
    cfg = _cfg()
    par = ParallelConfig(tp=4, fuse_w13=True, overlap_mode=mode,
                         scatter_axis=layout)
    inp = _inputs()
    full = _full(ref, "tp4")
    ranks = [TM.shard_params(full, r, 4, cfg) for r in range(4)]
    group = RankGroup(4, "cpu", timeout_s=60)
    got, outs = _run(cfg, par, ranks, None, group,
                     torch.from_numpy(inp["tokens"]).long(),
                     torch.from_numpy(inp["lengths"]).long(),
                     _start(ref, "tp4"))
    _check(ref, "tp4", got, outs, par)


@pytest.mark.parametrize("mode", ["decomposed", "flux"])
def test_mesh_dp2_tp2_zero3_matches_reference(ref, mode):
    cfg = _cfg()
    par = ParallelConfig(tp=2, dp=2, zero3=True, overlap_mode=mode)
    full = _full(ref, "dp2tp2")
    z3 = TM.zero3_leaves(cfg, par)
    assert {"layers.0.mixer.conv", "layers.0.mixer.w_dt",
            "layers.0.mixer.w_in_x"} <= z3
    mesh = make_mesh(1, 2, 2, "cpu")
    mesh.timeout_s = 60
    ranks = [TM.mesh_shard(full, cfg, par, mesh_coords(mesh, r))
             for r in range(mesh.size)]
    inp = _inputs()
    got, outs = _run(cfg, par, ranks, mesh, None,
                     torch.from_numpy(inp["tokens"]).long(),
                     torch.from_numpy(inp["lengths"]).long(),
                     _start(ref, "dp2tp2"))
    _check(ref, "dp2tp2", got, outs, par)

"""The paged Server at tp=4: the port's ranks against the reference's Server.

The reference's ``Server`` runs at tp=4 (``make_mesh(1, 1, 4)``, its
programs under ``shard_map``) once for the whole file, in one subprocess
with 4 forced host devices; the port's ``Server`` runs the same requests
with the 4 ranks of a ``dist.RankGroup`` on the CPU, each holding its
``convert.rank_params_from_jax`` copy and its own pools, in each of the
modes xla, decomposed and flux.  On the minicpm_2b and codeqwen15_7b (QKV
bias) SMOKE_CONFIGs with fp32 compute and fp32 params:

* 4 staggered requests (prompts over several chunks, one sharing a prefix
  with another): token lists identical to the reference Server's, the same
  prefix-reuse hits, and identical to serving each request alone;
* the same requests again on the same server: identical tokens, with the
  prompts' full blocks reused;
* a pool too small to keep every freed prefix (10 usable blocks, two
  requests in flight fill it): evictions happen and the tokens still equal
  the reference's and the isolated runs'.

And the serving CLI, ``repro_torch.launch.serve --tp 4 --device cpu
--smoke`` (bf16 weights), against its tp=1 run: the same tokens in modes
xla and flux.  Its decomposed mode is held token for token by the fp32
tests above, not here: the bf16 smoke model's top two logits are as close
as one bf16 ulp (0.0156 at |logit| ~ 4), and the chunked AllReduce, which
rounds n^2 partials instead of n, lands on the other side of one such tie
(request 2's third token).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert, dist
from repro_torch.configs.base import ParallelConfig, get_smoke_config
from repro_torch.launch import serve as launch_serve
from repro_torch.runtime.server import Request, ServeConfig, Server

ARCHS = ["minicpm_2b", "codeqwen15_7b"]
MODES = ["xla", "decomposed", "flux"]
TP = 4
SERVE_KW = dict(max_batch=2, max_seq=64, eos_token=-1, max_new_tokens=6,
                block_size=8, prefill_chunk=16)
# 10 usable blocks of 4; a 12-token request reserves 5 (with its 6 new
# tokens), so two in flight fill the pool and a third admission evicts
EVICT_KW = dict(SERVE_KW, block_size=4, num_blocks=11)

_REF = r"""
import dataclasses
import jax, jax.numpy as jnp
import numpy as np
from repro.configs.base import get_smoke_config, ParallelConfig
from repro.launch.mesh import make_mesh
from repro.models import model as M
from repro.runtime.server import Request, ServeConfig, Server

inp = dict(np.load(IN))
out = {}
mesh = make_mesh(1, 1, 4)
for arch in %(archs)r:
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    par = ParallelConfig(tp=4, dp=1)
    params = M.init_model(jax.random.PRNGKey(0), cfg, par, dtype=jnp.float32)
    if cfg.qkv_bias:   # the reference inits the bias to zero
        mix = params["periods"][0]["mixer"]
        rng = np.random.default_rng(1)
        mix["bqkv"] = jnp.asarray(
            0.1 * rng.standard_normal(mix["bqkv"].shape), jnp.float32)
    for case, kw in (("serve", %(serve_kw)r), ("evict", %(evict_kw)r)):
        prompts = [inp[f"{case}/{i}"] for i in range(int(inp[case + "/n"]))]
        srv = Server(cfg, par, mesh, params, ServeConfig(**kw))
        done = srv.serve([Request(rid=i, prompt=p)
                          for i, p in enumerate(prompts)])
        for r in done:
            out[f"{arch}/{case}/{r.rid}"] = np.asarray(r.output, np.int32)
        out[f"{arch}/{case}/reuse_hits"] = np.asarray(srv.pool.reuse_hits)
        out[f"{arch}/{case}/evictions"] = np.asarray(srv.pool.evictions)
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    for path, leaf in flat:
        key = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                       for q in path)
        out[f"{arch}/params/{key}"] = np.asarray(leaf, np.float32)
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


@pytest.fixture(scope="module")
def ref(tmp_path_factory, subproc):
    d = tmp_path_factory.mktemp("tp_server")
    inp = {}
    for case, prompts in _prompts().items():
        inp[case + "/n"] = np.asarray(len(prompts))
        for i, p in enumerate(prompts):
            inp[f"{case}/{i}"] = p
    np.savez(d / "in.npz", **inp)
    code = (_REF % {"archs": ARCHS, "serve_kw": SERVE_KW,
                    "evict_kw": EVICT_KW}).replace(
        "IN)", repr(str(d / "in.npz")) + ")").replace(
        "OUT,", repr(str(d / "out.npz")) + ",")
    assert "REF_OK" in subproc(code, n_devices=TP)
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


def _setup(ref, arch, mode):
    cfg = dataclasses.replace(get_smoke_config(arch),
                              compute_dtype="float32")
    ranks = convert.rank_params_from_jax(_tree(ref, f"{arch}/params/"), cfg,
                                         TP, dtype=torch.float32,
                                         device="cpu")
    par = ParallelConfig(tp=TP, overlap_mode=mode)
    return cfg, par, ranks, dist.RankGroup(TP, "cpu", timeout_s=60)


def _serve(srv, prompts):
    done = srv.serve([Request(rid=i, prompt=p) for i, p in enumerate(prompts)])
    assert all(r.done and r.error is None for r in done)
    return {r.rid: list(r.output) for r in done}


def _want(ref, arch, case):
    n = len(_prompts()[case])
    return {i: ref[f"{arch}/{case}/{i}"].tolist() for i in range(n)}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_server_tp4_matches_reference_and_isolated(ref, arch, mode):
    cfg, par, ranks, group = _setup(ref, arch, mode)
    prompts = _prompts()["serve"]
    srv = Server(cfg, par, ranks, ServeConfig(**SERVE_KW), group=group)
    assert srv.group is group and len(srv.caches) == TP
    got = _serve(srv, prompts)
    assert got == _want(ref, arch, "serve")
    assert srv.pool.reuse_hits == int(ref[f"{arch}/serve/reuse_hits"]) >= 1
    for i, p in enumerate(prompts):
        alone = Server(cfg, par, ranks, ServeConfig(**SERVE_KW), group=group)
        assert _serve(alone, [p])[0] == got[i], i


@pytest.mark.parametrize("arch", ARCHS)
def test_server_tp4_prefix_reuse(ref, arch):
    """The same requests again on the same server reuse every full prompt
    block and give the same tokens."""
    cfg, par, ranks, group = _setup(ref, arch, "flux")
    prompts = _prompts()["serve"]
    srv = Server(cfg, par, ranks, ServeConfig(**SERVE_KW), group=group)
    first = _serve(srv, prompts)
    hits, dispatches = srv.pool.reuse_hits, srv.prefill_dispatches
    again = _serve(srv, prompts)
    assert again == first == _want(ref, arch, "serve")
    full = sum(1 for p in prompts if len(p) >= SERVE_KW["block_size"])
    assert srv.pool.reuse_hits - hits == full
    # reused blocks are not prefilled again
    assert srv.prefill_dispatches - dispatches < dispatches


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_server_tp4_eviction(ref, arch, mode):
    cfg, par, ranks, group = _setup(ref, arch, mode)
    prompts = _prompts()["evict"]
    srv = Server(cfg, par, ranks, ServeConfig(**EVICT_KW), group=group)
    got = _serve(srv, prompts)
    assert srv.pool.evictions > 0
    assert srv.pool.evictions == int(ref[f"{arch}/evict/evictions"])
    assert got == _want(ref, arch, "evict")
    for i, p in enumerate(prompts[:3]):
        alone = Server(cfg, par, ranks, ServeConfig(**EVICT_KW), group=group)
        assert _serve(alone, [p])[0] == got[i], i
    assert got[3] == got[0]              # the repeat, evicted or not


@pytest.mark.parametrize("mode", ["xla", "flux"])
def test_serve_cli_tp4_equals_tp1(mode):
    argv = ["--arch", "minicpm_2b", "--smoke", "--device", "cpu",
            "--requests", "4"]
    srv1, done1 = launch_serve.main(argv)
    srv4, done4 = launch_serve.main(argv + ["--tp", str(TP), "--mode", mode])
    assert srv4.group.n == TP and srv4.ctx.mode == mode
    assert srv1.group is None
    want = {r.rid: r.output for r in done1}
    got = {r.rid: r.output for r in done4}
    assert len(got) == 4 and got == want

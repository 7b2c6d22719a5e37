"""Prefill at tp=4: the port's ranks against the reference and against tp=1.

On the minicpm_2b and codeqwen15_7b (QKV bias) SMOKE_CONFIGs with fp32
compute and fp32 params:

* the reference's ``prefill_step`` at tp=4 (one subprocess with 4 forced
  host devices, ``shard_map``; its params drawn at tp=4 cross as numpy and
  are cut per rank by ``convert.rank_params_from_jax``) against the port's
  4 ranks of a ``dist.RankGroup`` on the CPU in each mode (xla, decomposed,
  flux): next tokens equal on every rank; caches (bf16 on both sides)
  within 2e-2, one bf16 ulp at |x| ~ 2-4, as tests/test_torch_serve.py;
  last-position logits (the vocab shards of every rank, concatenated)
  within relative L2 1e-5 of the reference's (fp32 sums in another
  order), so the last layer's FFN seams, the final norm and the
  vocab-parallel head are held to the reference beyond the next token;
* the port at tp=4 against the port at tp=1 with the same seed (the same
  canonical weights, packed for each tp): last-position logits within
  relative L2 1e-5 (fp32 sums in another order) and equal next tokens;
  also with w1|w3 packed into one w13 (``fuse_w13``, the tp lane's
  weights on the card).

Also the paths that still raise at tp>1: MLA layers, and the replicated
layout under grad.  (Decode, the chunked prefill and the paged Server at
tp>1 are tests/test_torch_tp_decode.py and tests/test_torch_tp_server.py.)
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.base import ParallelConfig, get_smoke_config
from repro_torch.core.overlap import SeamTape
from repro_torch.dist import RankGroup
from repro_torch.models import model as TM
from repro_torch.models import serve as TS
from repro_torch.parallel.sharding import TPContext, make_ctx
from repro_torch.runtime.trainer import complete_grads

ARCHS = ["minicpm_2b", "codeqwen15_7b"]
MODES = ["xla", "decomposed", "flux"]
TP = 4
B, S = 2, 64
LENGTHS = [40, 64]
CACHE_TOL = 2e-2
LOGIT_RTOL = 1e-5

_REF = r"""
import dataclasses, functools
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.configs.base import get_smoke_config, ParallelConfig
from repro.models import model as M, serve as S
from repro.parallel.sharding import TPContext

inp = dict(np.load(IN))
out = {}
# the head's last-position logits: the vocab shard each rank hands to
# vocab_parallel_argmax inside prefill_step
seen = {}
_argmax = S.vocab_parallel_argmax


def _capture(logits_loc, *a, **k):
    seen["logits"] = logits_loc
    return _argmax(logits_loc, *a, **k)


S.vocab_parallel_argmax = _capture
mesh = Mesh(np.array(jax.devices()).reshape(1, 4), ("data", "model"))
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
    ctx = TPContext(axis="model", mode="decomposed")
    kv = P(None, None, None, "model", None)
    cache_specs = {"lead": [], "periods": [
        {"mixer": {"k": kv, "v": kv}, "ffn": {}} for _ in cfg.pattern]}

    @jax.jit
    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(specs, P(), P()),
                       out_specs=(P(), cache_specs, P(None, "model")),
                       check_vma=False)
    def prefill(p, toks, lengths):
        nxt, caches = S.prefill_step(p, {"tokens": toks}, ctx, cfg, par,
                                     lengths)
        return nxt, caches, seen.pop("logits")

    nxt, caches, logits = prefill(params, jnp.asarray(inp["tokens"]),
                                  jnp.asarray(inp["lengths"]))
    out[arch + "/next"] = np.asarray(nxt)
    out[arch + "/logits"] = np.asarray(logits, np.float32)
    for pos, per in enumerate(caches["periods"]):
        for name in ("k", "v"):
            out[f"{arch}/cache/{pos}/{name}"] = np.asarray(
                per["mixer"][name], np.float32)
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    for path, leaf in flat:
        key = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                       for q in path)
        out[f"{arch}/params/{key}"] = np.asarray(leaf, np.float32)
np.savez(OUT, **out)
print("REF_OK")
"""


def _batch():
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 512, (B, S)).astype(np.int32)
    for b, n in enumerate(LENGTHS):
        toks[b, n:] = 0                      # right padding
    return toks, np.array(LENGTHS, np.int32)


@pytest.fixture(scope="module")
def ref(tmp_path_factory, subproc):
    d = tmp_path_factory.mktemp("tp_prefill")
    toks, lengths = _batch()
    np.savez(d / "in.npz", tokens=toks, lengths=lengths)
    code = (_REF % {"archs": ARCHS}).replace(
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


def _cfg(arch):
    return dataclasses.replace(get_smoke_config(arch),
                               compute_dtype="float32")


def _run_tp(ranks, cfg, mode, fn):
    group = RankGroup(TP, "cpu", timeout_s=60)
    ctx = make_ctx(ParallelConfig(tp=TP, overlap_mode=mode,
                                  kernel_decode=mode == "flux"), group)
    toks, lengths = (torch.from_numpy(a) for a in _batch())
    return group.spmd(lambda p: fn(p, {"tokens": toks}, ctx, cfg,
                                   lengths.long()), [(p,) for p in ranks])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_tp4_matches_reference(ref, arch, mode):
    cfg = _cfg(arch)
    tree = _tree(ref, f"{arch}/params/")
    ranks = convert.rank_params_from_jax(tree, cfg, TP, dtype=torch.float32,
                                         device="cpu")
    outs = _run_tp(ranks, cfg, mode, TS.prefill_step)
    want = ref[arch + "/next"].reshape(-1)
    for nxt, _ in outs:
        np.testing.assert_array_equal(nxt.numpy().reshape(-1), want)
    for layer in range(cfg.num_layers):
        for name in ("k", "v"):
            got = torch.cat([c[layer][name] for _, c in outs], dim=2)
            # the reference stacks a pattern position's layers [reps, ...]
            w = ref[f"{arch}/cache/0/{name}"][layer]
            np.testing.assert_allclose(got.float().numpy(), w,
                                       atol=CACHE_TOL, rtol=CACHE_TOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_tp4_match_reference(ref, arch, mode):
    cfg = _cfg(arch)
    ranks = convert.rank_params_from_jax(_tree(ref, f"{arch}/params/"), cfg,
                                         TP, dtype=torch.float32,
                                         device="cpu")
    outs = _run_tp(ranks, cfg, mode, TS.prefill_logits)
    got = torch.cat([lg for lg, _ in outs], dim=-1).numpy()
    want = ref[arch + "/logits"]
    assert got.shape == want.shape
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= LOGIT_RTOL, (mode, rel)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_tp4_equals_tp1_same_seed(arch):
    _check_tp4_equals_tp1(arch, fuse_w13=False)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_tp4_fused_w13_equals_tp1_same_seed(arch):
    """w1|w3 packed per rank into one w13 at tp=4 (one AG-GEMM with the
    split gate under flux) against the unpacked tp=1 model."""
    _check_tp4_equals_tp1(arch, fuse_w13=True)


def _check_tp4_equals_tp1(arch, fuse_w13):
    cfg = _cfg(arch)
    p1 = TM.init_model(cfg, ParallelConfig(), seed=0, dtype=torch.float32,
                       device="cpu")
    full = TM.init_model(cfg, ParallelConfig(tp=TP, fuse_w13=fuse_w13),
                         seed=0, dtype=torch.float32, device="cpu")
    assert ("w13" in full.layers[0].ffn) == fuse_w13
    if cfg.qkv_bias:    # zero at init: give the bias epilogue something
        bias = torch.from_numpy(np.random.default_rng(1).standard_normal(
            p1.layers[0].mixer["bqkv"].shape).astype(np.float32)) * 0.1
        _set_bias(p1, full, bias, cfg)
    ranks = [TM.shard_params(full, r, TP, cfg) for r in range(TP)]
    toks, lengths = (torch.from_numpy(a) for a in _batch())
    want, _ = TS.prefill_logits(p1, {"tokens": toks}, TPContext(), cfg,
                                lengths.long())
    for mode in MODES:
        outs = _run_tp(ranks, cfg, mode, TS.prefill_logits)
        got = torch.cat([lg for lg, _ in outs], dim=-1)
        rel = ((got - want).norm() / want.norm()).item()
        assert rel <= LOGIT_RTOL, (mode, rel)
        nxt = _run_tp(ranks, cfg, mode, TS.prefill_step)
        for n, _ in nxt:
            np.testing.assert_array_equal(
                n.reshape(-1).numpy(),
                TS.vocab_parallel_argmax(want, cfg.vocab_size).numpy())


def _set_bias(p1, full, bias, cfg):
    """The same canonical QKV bias in the tp=1 and the tp-packed layout
    (q | k | v heads; at tp=4 per-rank blocks, k/v heads replicated)."""
    from repro_torch.models import init_utils as iu
    from repro_torch.models.attention import AttnDims
    d1, d4 = AttnDims.of(cfg, 1), AttnDims.of(cfg, TP)
    q, k, v = torch.split(bias, [d1.h_pad * d1.dh, d1.hkv_pad * d1.dh,
                                 d1.hkv_pad * d1.dh])
    k4 = iu.replicate_kv_heads(k[None], cfg.num_kv_heads, d4.dh, TP,
                               d4.hkv_pad)[0]
    v4 = iu.replicate_kv_heads(v[None], cfg.num_kv_heads, d4.dh, TP,
                               d4.hkv_pad)[0]
    packed = iu.pack_qkv(q[None], k4[None], v4[None], TP)[0]
    for blk1, blk4 in zip(p1.layers, full.layers):
        blk1.mixer["bqkv"].data.copy_(bias)
        blk4.mixer["bqkv"].data.copy_(packed)


def test_tp_paths_that_raise_name_roadmap():
    """A dedicated expert-parallel axis (item 10) no longer raises: at
    ep=2 ``init_model`` draws the global experts and a mesh rank's copy
    holds E / ep of them, whole over the TP ranks
    (``tests/test_torch_zero3_ep.py`` trains it).  MLA and MoE layers
    train at tp>1 (``tests/test_torch_train_mla_moe.py``).  The
    replicated layout trains: its loss and grads equal the seq
    layout's."""
    cfg = _cfg("minicpm_2b")
    group = RankGroup(TP, "cpu")
    ctx = TPContext(tp=TP, group=group)
    ds = get_smoke_config("deepseek_v3_671b")
    ep_par = ParallelConfig(tp=TP, ep=2)
    ep_full = TM.init_model(ds, ep_par, device="cpu")
    n_exp = ds.moe.num_experts
    assert ep_full.layers[1].ffn["w1"].shape[0] == n_exp
    for e in range(2):
        rank = TM.mesh_shard(ep_full, ds, ep_par, {"ep": e, "model": 1})
        w1 = rank.layers[1].ffn["w1"]
        assert w1.shape[0] == n_exp // 2
        assert torch.equal(w1, ep_full.layers[1].ffn["w1"].chunk(2)[e])
    assert TM.check_trainable(get_smoke_config("deepseek_v3_671b"),
                              ParallelConfig(tp=TP)) is None
    full = TM.init_model(cfg, ParallelConfig(tp=TP), seed=0,
                         dtype=torch.float32, device="cpu", trainable=True)
    ranks = [TM.shard_params(full, r, TP, cfg) for r in range(TP)]
    hidden = make_ctx(ParallelConfig(tp=TP), group).with_layout(False)
    assert not hidden.seq_sharded
    batch = {"tokens": torch.arange(8).reshape(1, 8),
             "labels": torch.arange(1, 9).reshape(1, 8)}

    def loss(p, c):
        with SeamTape() as tape:
            out = TM.forward_loss(p, batch, c, cfg, ParallelConfig(tp=TP))
        tape.backward(out)
        grads = {n: t.grad for n, t in p.named_parameters()}
        for t in p.parameters():
            t.grad = None
        # a replicated leaf's grad is a per-rank partial: sum the ranks'
        return out.detach(), complete_grads(
            grads, TM.replicated_leaves(cfg, p), group)

    got = group.spmd(lambda p: loss(p, hidden), [(p,) for p in ranks])
    want = group.spmd(lambda p: loss(p, ctx), [(p,) for p in ranks])
    for (lh, gh), (ls, gs) in zip(got, want):
        assert torch.allclose(lh, ls, rtol=1e-5, atol=0)
        for n in gs:
            assert torch.allclose(gh[n], gs[n], rtol=1e-4, atol=1e-6), n

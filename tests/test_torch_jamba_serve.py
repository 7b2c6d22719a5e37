"""Jamba-v0.1 (jamba_v01_52b) served by the port, without a reference run.

The reference's parity cases (prefill, decode, the caches, the config and
the parameter count) are in ``tests/test_torch_jamba.py``; these need no
JAX run, so they sit in a file of their own:

* the canonical leaves of the tp=2 and tp=4 inits equal the tp=1 init's;
* the chunked prefill (``prefill_chunk_logits`` through block tables, the
  state threaded through a slot row) against the batched one, at tp=1 and
  tp=4;
* the paged ``Server`` at tp=1 and tp=4 with its slots and blocks
  recycled (concurrent = isolated); the port of the reference's
  ``test_hybrid_state_survives_interleaved_decode`` (same prompts and
  ``ServeConfig``);
* the serve CLI at ``--tp 2 --dp 2``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ParallelConfig, get_smoke_config
from repro_torch.dist import RankGroup
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model as TM
from repro_torch.models import serve as TS
from repro_torch.parallel.sharding import make_ctx
from repro_torch.runtime.server import Request, ServeConfig, Server

ARCH = "jamba_v01_52b"
LAYERS = 8                           # one period of the pattern
B, S, S_MAX = 4, 24, 32
LENGTHS = [24, 2, 13, 19]
KV_TOL = 2e-2
CHUNK_RTOL = 5e-3
STALE = 0.5                          # a freed slot's leftover state
# test_hybrid_state_survives_interleaved_decode's ServeConfig
HYBRID_KW = dict(max_batch=2, max_seq=64, eos_token=-1, max_new_tokens=5,
                 block_size=4, prefill_chunk=4)
# two slots and 8 usable blocks of 4: the pool holds two 12-token requests
# in flight, so four queue and take over freed slots and blocks
RECYCLE_KW = dict(max_batch=2, max_seq=64, eos_token=-1, max_new_tokens=4,
                  block_size=4, prefill_chunk=8, num_blocks=9)


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
    return dataclasses.replace(get_smoke_config(ARCH), num_layers=LAYERS,
                               compute_dtype="float32")


def _inputs():
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 512, (B, S)).astype(np.int32)
    for b, n in enumerate(LENGTHS):
        toks[b, n:] = 0                      # right padding
    return {"tokens": toks}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _ranks(cfg, tp, dtype=torch.float32, fuse=False):
    full = TM.init_model(cfg, ParallelConfig(tp=tp, fuse_w13=fuse), seed=0,
                         dtype=dtype, device="cpu")
    if tp == 1:
        return full
    return [TM.shard_params(full, r, tp, cfg) for r in range(tp)]



@pytest.mark.parametrize("fuse", [False, True])
def test_canonical_leaves_equal_across_tp(fuse):
    """``model.canonical_leaves`` of the tp=2 and tp=4 inits (Mamba's
    channels padded to 512 at tp=4, ``w_in_xz`` unpacked) equal the tp=1
    init's, leaf for leaf: the same canonical weights at every tp."""
    cfg = get_smoke_config(ARCH)
    want = dict(TM.init_model(cfg, ParallelConfig(), device="cpu")
                .named_parameters())
    for tp in (2, 4):
        full = TM.init_model(cfg, ParallelConfig(tp=tp, fuse_w13=fuse),
                             device="cpu")
        assert full.layers[0].mixer["w_x"].shape[0] == (512 if tp == 4
                                                        else 256)
        got = TM.canonical_leaves(dict(full.named_parameters()), cfg, tp)
        assert sorted(got) == sorted(want)
        for n, t in want.items():
            assert torch.equal(got[n], t), (tp, n)


@pytest.mark.parametrize("tp", [1, 4])
def test_chunked_prefill_equals_batched(tp):
    """Two prompts (lengths 19 and 5) through the chunked prefill in
    chunks of 8, each in its own slot (holding a stale state, which the
    first chunk must zero), interleaved: the final chunk's logits and the
    slot's state rows against the batched prefill, at a drop-free MoE
    capacity (the batched prefill's capacity covers all its tokens at
    once, so at the config's factor it evicts other assignments).  A
    chunk reads the bf16 K/V pools and bf16 conv tails that the batched
    prefill holds in fp32: the logits within relative L2 5e-3 (1.7e-3
    measured), the same next tokens, the ssm rows within 5e-3, the conv
    rows within bf16's 2e-2; another slot's state untouched."""
    cfg = dataclasses.replace(_cfg(), moe=dataclasses.replace(
        _cfg().moe, capacity_factor=16.0))
    par = ParallelConfig(tp=tp, fuse_w13=tp > 1)
    params = _ranks(cfg, tp, fuse=tp > 1)
    ranks = [params] if tp == 1 else params
    group = RankGroup(tp, "cpu", timeout_s=60) if tp > 1 else None
    inp = _inputs()
    toks = torch.from_numpy(inp["tokens"]).long()[[0, 3]]
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
            for n in ("conv", "ssm"):
                if n in layer:
                    layer[n].fill_(STALE)
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
            if "ssm" not in b_layer:
                continue
            for j, slot in ((0, 1), (1, 2)):
                np.testing.assert_allclose(
                    p_layer["conv"][slot].float().numpy(),
                    b_layer["conv"][j].numpy(), atol=KV_TOL, rtol=KV_TOL)
                assert _rel(p_layer["ssm"][slot].numpy(),
                            b_layer["ssm"][j].numpy()) <= CHUNK_RTOL, (i, j)
            assert (p_layer["ssm"][0] == STALE).all()    # slot 0 untouched


def _serve(srv, prompts):
    done = srv.serve([Request(rid=i, prompt=p) for i, p in enumerate(prompts)])
    assert all(r.done and r.error is None for r in done)
    return {r.rid: list(r.output) for r in done}


def _server(cfg, tp, params, kw, mode="flux"):
    par = ParallelConfig(tp=tp, overlap_mode=mode)
    return Server(cfg, par, params, ServeConfig(**kw))


@pytest.mark.parametrize("tp", [1, 4])
def test_hybrid_state_survives_interleaved_decode(tp):
    """The reference's regression test on the port: the 14-token prompt
    prefills over 4 chunks, each followed by a decode step of the
    generating 3-token slot; those decodes must leave the mid-prefill
    slot's conv and ssm rows alone (``decode_step``'s ``active``
    freeze), so concurrent = isolated."""
    cfg = get_smoke_config(ARCH)
    params = _ranks(cfg, tp, dtype=torch.bfloat16)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (3, 14)]
    srv = _server(cfg, tp, params, HYBRID_KW)
    assert not srv._reuse_ok                    # recurrent state: no reuse
    concurrent = _serve(srv, prompts)
    for i, p in enumerate(prompts):
        solo = _serve(_server(cfg, tp, params, HYBRID_KW), [p])[0]
        assert concurrent[i] == solo, f"rid {i} diverged"


@pytest.mark.parametrize("tp", [1, 4])
def test_server_recycled_slots_concurrent_equals_isolated(tp):
    """Four 12-token requests on two slots and a pool that holds two: the
    later requests wait, then take over freed slots (whose state the
    first chunk zeroes) and blocks; every request's tokens equal its
    tokens served alone."""
    cfg = _cfg()
    params = _ranks(cfg, tp)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 512, size=(12,)).astype(np.int32)
               for _ in range(4)]
    srv = _server(cfg, tp, params, RECYCLE_KW)
    got = _serve(srv, prompts)
    assert srv.pool.peak_blocks_in_use == srv.pool.num_blocks - 1
    assert srv.pool.reuse_hits == 0
    for i, p in enumerate(prompts):
        alone = _serve(_server(cfg, tp, params, RECYCLE_KW), [p])[0]
        assert alone == got[i], i


def test_serve_cli_dp2_tp2():
    """``launch.serve --arch jamba_v01_52b`` at ``--dp 2 --tp 2`` serves
    its requests on a (2, 2) mesh (every rank agreeing) with the tokens
    of ``--tp 2`` alone: each data replica runs a tp=2 group's arithmetic.
    (Against tp=1 the bf16 smoke model's tokens meet near ties.)"""
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "2",
            "--max-new", "4", "--tp", "2", "--mode", "flux"]
    _, done2 = launch_serve.main(argv)
    srv, done = launch_serve.main(argv + ["--dp", "2"])
    assert srv.mesh.shape == (2, 2)
    assert all(len(r.output) == 4 for r in done)
    assert {r.rid: r.output for r in done} == {r.rid: r.output
                                               for r in done2}

"""Paged serving runtime (port of ``repro.runtime.server``): block-table KV
cache + chunked-prefill continuous batching.

Two model calls serve everything, as in the reference:

* **Per-slot paged decode** — one ``decode_step`` advances every generating
  slot at its own position through its own block-table row; inactive
  slots pass all-zero rows (their writes land in the null block) and their
  outputs are discarded.
* **Chunked prefill** — admission reserves a slot plus pool blocks for the
  whole request horizon, then the prompt streams through
  ``prefill_chunk_step`` in fixed ``[1, C]`` chunks, interleaved with decode
  by the ``ChunkScheduler``; a recurrent layer (Mamba's, RWKV's time-mix
  and channel-mix) threads the slot's dense state rows across the chunks,
  and the interleaved decodes leave them alone (their ``active`` mask).

Prefix reuse: full prompt blocks register in the pool's hash-chain cache;
a later admission sharing the prefix acquires them and starts prefilling
at the first unmatched position (shared blocks are never written).  Only
models whose every layer keeps its sequence memory in the pool (GQA, MLA)
reuse prefixes (``_arch_supports_reuse``).

The reference jits both programs with the cache donated
(``donate_argnums``); here the model calls update ``self.caches`` in place.

At tp>1 the host keeps what the reference's does: one ``KVPool``, one
scheduler, one set of block tables and one position vector.  Each rank of
a ``dist.RankGroup`` keeps its own ``model.shard_params`` copy and its own
pools of its local KV heads; every model call runs all ranks through
``group.spmd`` (the reference's ``shard_map``) and takes rank 0's tokens
after checking that every rank returned the same ones.

On a mesh (dp, pods or ep > 1: a ``dist.RankMesh`` of
``launch.mesh.make_mesh``) the host keeps the same one pool, scheduler
and set of tables; each mesh rank keeps its ``model.mesh_shard`` copy
(its TP block, its experts, under ZeRO-3 its data shard of the layers'
leaves) and its own pools, and every model call runs through
``mesh.spmd``, each rank under its ``make_ctx(par, mesh=)`` context (under
ZeRO-3 each layer gathers its leaves over the data group).  Every replica
serves the same requests, as the reference's (its tokens are replicated
over data), and every rank of the mesh must return the same tokens.  The
contexts keep their dp axes, unlike the reference's: serving reads only
their data group (the ZeRO-3 gather) and the MoE aux loss's psum over
them, whose sums the serve steps drop.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.base import (ATTN, MLA, RWKV, ModelConfig,
                                      ParallelConfig)
from repro_torch.dist import RankGroup, RankMesh
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import serve as S
from repro_torch.models.model import Model, check_ported, expanded_pattern
from repro_torch.parallel.sharding import TPContext, make_ctx
from repro_torch.runtime.kvpool import BlockTable, KVPool
from repro_torch.tuning.plans import plan_set_from_parallel


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8            # decode slots
    max_seq: int = 512
    eos_token: int = 1
    max_new_tokens: int = 64
    block_size: int = 16          # tokens per KV pool block (page)
    num_blocks: Optional[int] = None   # default: max_batch full sequences
    prefill_chunk: int = 32       # chunked-prefill rows per call
    prefix_reuse: bool = True     # hash-chain prefix cache


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [S_prompt] int32
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    error: Optional[str] = None   # set when the server rejected the request
    # perf_counter seconds, owned by the runtime: arrival at submit, first
    # token when the final prefill chunk emits token 0, finish at completion
    t_arrival: Optional[float] = None
    t_first_token: Optional[float] = None
    t_finish: Optional[float] = None

    def ttft_s(self) -> Optional[float]:
        if self.t_arrival is None or self.t_first_token is None:
            return None
        return self.t_first_token - self.t_arrival

    def per_token_s(self) -> Optional[float]:
        """Mean inter-token latency after the first token (TPOT)."""
        if self.t_first_token is None or self.t_finish is None:
            return None
        return ((self.t_finish - self.t_first_token)
                / max(1, len(self.output) - 1))


@dataclasses.dataclass
class PrefillJob:
    """An admitted request mid-prefill: ``off`` is the next unprefilled
    prompt position (reused prefix blocks are skipped)."""
    req: Request
    slot: int
    table: BlockTable
    off: int


def _arch_supports_reuse(cfg: ModelConfig) -> bool:
    """Prefix blocks are reusable only when EVERY layer's sequence memory
    lives in the paged pool.  Recurrent families (Mamba SSM/conv, RWKV
    wkv/token-shift) fold history into dense states that are not
    block-addressable, so hybrids keep paging + eviction but skip the
    prefix cache."""
    return all(mk in (ATTN, MLA) and fk != RWKV
               for mk, fk in expanded_pattern(cfg))


class Server:
    """The paged server.  ``params`` is the model at tp=1; at tp>1 the tp
    ranks' ``model.shard_params`` copies, run by ``group`` (a
    ``dist.RankGroup`` of size tp; made on the weights' device when not
    given); on a mesh (``mesh`` given, or dp, pods or ep > 1) the mesh
    ranks' ``model.mesh_shard`` copies in rank order, run by ``mesh``
    (``launch.mesh.make_mesh``'s for ``par``, made on the weights' device
    when not given)."""

    def __init__(self, cfg: ModelConfig, par: ParallelConfig,
                 params: Union[Model, Sequence[Model]], sc: ServeConfig,
                 group: Optional[RankGroup] = None,
                 mesh: Optional[RankMesh] = None):
        check_ported(cfg)
        self.cfg = cfg
        self.par = par
        self.sc = sc
        self.params = params
        self.mesh = None
        self.ctxs: List[TPContext] = []
        if mesh is not None or par.dp * par.pods * par.ep > 1:
            self.device = params[0].embed.device
            self.mesh = (mesh if mesh is not None else make_mesh(
                par.pods, par.dp, par.tp, self.device, ep=par.ep))
            if len(params) != self.mesh.size:
                raise ValueError(f"a mesh of {self.mesh.size} ranks needs "
                                 f"as many ranks' params, got {len(params)}")
            self.group = None
            plans = plan_set_from_parallel(par, self.device.type)
            self.ctxs = [make_ctx(par, plans=plans, mesh=self.mesh, rank=r)
                         for r in range(self.mesh.size)]
            self.ctx = self.ctxs[0]
        elif par.tp > 1:
            if len(params) != par.tp:
                raise ValueError(f"tp={par.tp} needs {par.tp} ranks' params, "
                                 f"got {len(params)}")
            self.device = params[0].embed.device
            self.group = (group if group is not None
                          else RankGroup(par.tp, self.device))
        else:
            self.device = params.embed.device
            self.group = None
        if self.mesh is None:
            # both model calls force the replicated layout themselves; the
            # seams' plans are the uniform overlap_mode overlaid with
            # par.plan_profile when it is fresh for this device (the
            # reference's plan_set_from_parallel)
            self.ctx = TPContext(tp=par.tp, ep=par.ep, group=self.group,
                                 mode=par.overlap_mode,
                                 comm_chunks=par.comm_chunks,
                                 plans=plan_set_from_parallel(
                                     par, self.device.type))
        self.pages = -(-sc.max_seq // sc.block_size)   # table width
        nb = sc.num_blocks or (sc.max_batch * self.pages + 1)
        self.pool = KVPool(nb, sc.block_size)
        self.dense_equiv_blocks = sc.max_batch * self.pages
        specs = S.paged_cache_specs(cfg, par, nb, sc.block_size,
                                    sc.max_batch)
        # one pool set per rank, of its local KV heads
        self.caches = [S.zeros_from_specs(specs, self.device)
                       for _ in range(self.n_ranks)]
        self.positions = np.zeros((sc.max_batch,), np.int32)
        self.slots: List[Optional[Request]] = [None] * sc.max_batch
        self.ready: List[bool] = [False] * sc.max_batch  # prefill complete
        self.tables: List[Optional[BlockTable]] = [None] * sc.max_batch
        self._reuse_ok = sc.prefix_reuse and _arch_supports_reuse(cfg)
        self.prefill_dispatches = 0
        self.decode_dispatches = 0

    @property
    def n_ranks(self) -> int:
        if self.mesh is not None:
            return self.mesh.size
        return 1 if self.group is None else self.group.n

    def run_ranks(self, fn: Callable) -> List:
        """``fn(params, caches, ctx)`` on every rank (inside ``spmd`` on a
        group or a mesh), each on its params, pools and context; the
        ranks' results in rank order."""
        if self.mesh is not None:
            return self.mesh.spmd(fn, list(zip(self.params, self.caches,
                                               self.ctxs)))
        if self.group is None:
            return [fn(self.params, self.caches[0], self.ctx)]
        return self.group.spmd(lambda p, c: fn(p, c, self.ctx),
                               list(zip(self.params, self.caches)))

    def _run(self, fn: Callable, *args, **kw) -> torch.Tensor:
        """``fn(params, caches, *args, ctx, cfg, **kw)`` (a model call that
        returns (next_token, caches), the caches updated in place) on every
        rank; returns the next tokens, rank 0's, after checking that every
        rank returned the same."""
        outs = self.run_ranks(lambda p, c, ctx: fn(p, c, *args, ctx, self.cfg,
                                                   **kw)[0])
        for r, o in enumerate(outs[1:], 1):
            if not torch.equal(o, outs[0]):
                raise RuntimeError(f"rank {r}'s next tokens "
                                   f"{o.reshape(-1).tolist()} differ from "
                                   f"rank 0's {outs[0].reshape(-1).tolist()}")
        return outs[0]

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------ admission
    def _blocks_needed(self, n: int) -> int:
        """Blocks reserved at admission: the whole request horizon, so
        decode never allocates."""
        horizon = min(n + self.sc.max_new_tokens, self.sc.max_seq)
        return min(-(-horizon // self.sc.block_size), self.pages)

    def begin_admission(self, req: Request) -> Optional[PrefillJob]:
        """Reserve a slot + KV blocks (no model call).  None when no slot is
        free or the pool cannot cover the request; ValueError for prompts
        that can never be served."""
        slot = next((i for i, cur in enumerate(self.slots) if cur is None),
                    None)
        if slot is None:
            return None
        n = len(req.prompt)
        if not 0 < n < self.sc.max_seq:
            raise ValueError(f"prompt length {n} outside (0, "
                             f"{self.sc.max_seq}) for rid {req.rid}")
        if req.t_arrival is None:
            req.t_arrival = time.perf_counter()
        matched: List[int] = []
        n_cached = 0
        if self._reuse_ok:
            matched, n_cached = self.pool.match_prefix(req.prompt)
        need = self._blocks_needed(n) - len(matched)
        if not self.pool.can_allocate(need):
            self.pool.release(matched)
            return None
        blocks = matched + self.pool.allocate(need)
        self.pool.note_reuse(len(matched))
        table = BlockTable(blocks, n_reused=len(matched))
        self.slots[slot] = req
        self.ready[slot] = False
        self.positions[slot] = 0
        self.tables[slot] = table
        return PrefillJob(req=req, slot=slot, table=table, off=n_cached)

    def prefill_chunk(self, job: PrefillJob) -> bool:
        """Run ONE fixed-shape prefill chunk.  True when the prompt is fully
        prefilled (first token emitted, slot generating)."""
        req, slot = job.req, job.slot
        n = len(req.prompt)
        c = self.sc.prefill_chunk
        clen = min(c, n - job.off)
        toks = np.zeros((1, c), np.int64)
        toks[0, :clen] = req.prompt[job.off:job.off + clen]
        bt = job.table.as_array(self.pages)[None]
        nxt = self._run(S.prefill_chunk_step, self._tensor(toks),
                        self._tensor(bt), job.off, clen, slot=slot)
        self.prefill_dispatches += 1
        job.off += clen
        if job.off < n:
            return False
        # final chunk: its row clen-1 is the prompt's last position
        self.positions[slot] = n
        self.ready[slot] = True
        req.output.append(int(nxt[0, 0]))
        req.t_first_token = time.perf_counter()
        if self._reuse_ok:
            self.pool.register(
                job.table.blocks[:n // self.sc.block_size], req.prompt)
        self._finish_if_done(slot)
        return True

    # --------------------------------------------------------------- decode
    def _finish_if_done(self, i: int) -> Optional[Request]:
        req = self.slots[i]
        if req is None:
            return None
        if (req.output[-1] == self.sc.eos_token
                or len(req.output) >= self.sc.max_new_tokens
                or self.positions[i] >= self.sc.max_seq - 1):
            req.done = True
            req.t_finish = time.perf_counter()
            self.pool.release(self.tables[i].blocks)
            self.tables[i] = None
            self.ready[i] = False
            self.slots[i] = None
            self.positions[i] = 0
            return req
        return None

    def step(self) -> List[Request]:
        """One decode step for every generating slot, each at its own
        position through its own block-table row."""
        if not any(self.ready):
            return []
        b = self.sc.max_batch
        toks = np.zeros((b, 1), np.int64)
        bts = np.zeros((b, self.pages), np.int32)
        active = np.zeros((b,), bool)
        for i, req in enumerate(self.slots):
            if req is not None and self.ready[i]:
                active[i] = True
                toks[i, 0] = req.output[-1]
                bts[i] = self.tables[i].as_array(self.pages)
        nxt = self._run(S.decode_step, self._tensor(toks),
                        self._tensor(self.positions),
                        block_tables=self._tensor(bts),
                        active=self._tensor(active))
        self.decode_dispatches += 1
        nxt = nxt.cpu().numpy()
        finished: List[Request] = []
        for i, req in enumerate(self.slots):
            if req is None or not self.ready[i]:
                continue
            req.output.append(int(nxt[i, 0]))
            self.positions[i] += 1
            fin = self._finish_if_done(i)
            if fin is not None:
                finished.append(fin)
        return finished

    def serve(self, requests: List[Request]) -> List[Request]:
        """Run a request queue to completion through the chunk scheduler."""
        from repro_torch.runtime.scheduler import ChunkScheduler
        sched = ChunkScheduler(self)
        for req in requests:
            sched.submit(req)
        done: List[Request] = []
        done_rids = set()
        while sched.has_work():
            for fin in sched.tick():
                if fin.rid not in done_rids:
                    done_rids.add(fin.rid)
                    done.append(fin)
        return done

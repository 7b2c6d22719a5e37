"""Serving launcher (port of ``repro.launch.serve``): continuous batching over
a seeded random-init model.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm_2b \
      --requests 8 --max-batch 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm_2b \
      --tp 4 --mode flux
  PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm_2b \
      --tp 4 --mode flux --autotune     # tune (decode at --max-batch), serve
  PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm_2b \
      --tp 4 --mode decomposed --wire-dtype int8   # quantized forward wire
  PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm_2b \
      --dp 2 --tp 2 --mode flux     # two replicas of two TP ranks
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba_v01_52b \
      --layers 8                    # Mamba + attention hybrid, one period
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6_3b \
      --tp 2 --mode flux            # RWKV-6: time-mix + channel-mix

Runs on the CUDA card by default; ``--device cpu`` runs the plain PyTorch
path (use ``--smoke`` sizes there).  Every arch of ``configs.ARCH_IDS``
serves at any ``--tp`` / ``--dp``: Jamba's Mamba layers keep a dense conv /
SSM state per slot, RWKV-6's layers a dense wkv state and two token-shift
rows per slot (no prefix reuse for either).  At ``--tp`` > 1 the ranks are
the threads of one ``dist.RankGroup`` on the one device, each with its
``model.shard_params`` copy of the same seeded weights, so the tokens equal
the tp=1 run's up to the sums' rounding.  ``--plan-profile`` serves from a
tuned per-seam profile; ``--autotune`` (tp > 1) tunes first, with the
decode seam at ``--max-batch`` rows, and writes the profile as the train
CLI's does.  ``--wire-dtype`` quantizes the seams' forward wire (serving
has no backward, so this is the whole of it; flux seams keep the fp wire)
and ``--max-logit-rmse`` gates ``--autotune``'s wire sweep, as in the train
CLI.  At ``--dp`` > 1 the ranks are those of ``launch.mesh.make_mesh(1, dp,
tp)`` (a ``dist.RankMesh``), each with its ``model.mesh_shard`` copy, and
every replica serves the same requests, as the reference's Server on its
(data, model) mesh.  ZeRO-3 and expert parallelism in serving are reached
through ``ParallelConfig`` (the ``Server``), as in the reference, whose
serve CLI has neither flag.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import (ParallelConfig, get_config,
                                      get_smoke_config)
from repro_torch.core.overlap import VALID_MODES
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh, mesh_coords
from repro_torch.launch.train import add_wire_args, autotune
from repro_torch.models import model as M
from repro_torch.runtime.server import Request, ServeConfig, Server


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="keep the model's first N layers (0: all)")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel replicas of the tp ranks (a "
                         "(dp, tp) rank mesh; each serves every request)")
    ap.add_argument("--mode", default="decomposed", choices=list(VALID_MODES),
                    help="the TP seams' transport")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8,
                    help="request i's prompt has prompt_len + i tokens")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--max-batch", type=int, default=4,
                    help="concurrent decode slots")
    ap.add_argument("--eos", type=int, default=-1,
                    help="EOS token id (-1: never stop early)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV pool block (page) size in tokens")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="chunked-prefill rows per call")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--plan-profile", default=None,
                    help="tuned per-seam profile JSON (repro_torch.tuning)")
    ap.add_argument("--autotune", action="store_true",
                    help="tune the seam plans first (decode_ar at "
                         "--max-batch rows); needs --tp > 1")
    add_wire_args(ap)
    return ap.parse_args(argv)


def make_requests(vocab: int, n: int, prompt_len: int,
                  seed: int = 0) -> List[Request]:
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(
        0, vocab, size=(prompt_len + i,)).astype(np.int32))
        for i in range(n)]


def main(argv: Optional[List[str]] = None
         ) -> Tuple[Server, List[Request]]:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    par = ParallelConfig(tp=args.tp, dp=args.dp, overlap_mode=args.mode,
                         plan_profile=args.plan_profile,
                         wire_dtype=args.wire_dtype,
                         max_logit_rmse=args.max_logit_rmse)
    if args.autotune:
        # the reference tunes serving at its default 2048 tokens a seam
        par = autotune(args, cfg, par, 2048, decode_batch=args.max_batch)
    dtype = getattr(torch, cfg.compute_dtype)
    params = M.init_model(cfg, par, seed=0, dtype=dtype, device=device)
    mesh = None
    if args.dp > 1:
        mesh = make_mesh(1, args.dp, args.tp, device)
        params = [M.mesh_shard(params, cfg, par, mesh_coords(mesh, r))
                  for r in range(mesh.size)]
    elif args.tp > 1:
        params = [M.shard_params(params, r, args.tp, cfg)
                  for r in range(args.tp)]
    sc = ServeConfig(max_batch=args.max_batch, max_seq=args.max_seq,
                     eos_token=args.eos, max_new_tokens=args.max_new,
                     block_size=args.block_size,
                     prefill_chunk=args.prefill_chunk)
    server = Server(cfg, par, params, sc, mesh=mesh)
    done = server.serve(make_requests(cfg.vocab_size, args.requests,
                                      args.prompt_len))
    for r in sorted(done, key=lambda x: x.rid):
        ttft = r.ttft_s()
        ttft_ms = f"{ttft * 1e3:.1f}ms" if ttft is not None else "n/a"
        print(f"req {r.rid}: +{len(r.output)} tokens ttft={ttft_ms}: "
              f"{r.output[:12]}")
    pool = server.pool
    print(f"pool: peak {pool.peak_blocks_in_use}/{pool.num_blocks - 1} "
          f"blocks (dense equiv {server.dense_equiv_blocks}), "
          f"reuse_hits={pool.reuse_hits} reused_tokens={pool.reused_tokens} "
          f"evictions={pool.evictions}")
    return server, done


if __name__ == "__main__":
    main()

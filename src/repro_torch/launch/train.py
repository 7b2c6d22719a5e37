"""Training launcher (port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm_2b \
      --steps 3                      # full width on the card, tp=1
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm_2b \
      --smoke --steps 3 --tp 4 --mode flux --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm_2b \
      --smoke --steps 6 --tp 4 --scatter-axis hidden --ckpt-dir ckpt \
      --device cpu                   # resumes from ckpt/ when it holds one

Runs on the CUDA card by default (bf16 weights); ``--device cpu`` runs the
plain PyTorch path (use ``--smoke`` sizes there).  At ``--tp`` > 1 the
ranks are the threads of one ``dist.RankGroup`` on the one device.  The
schedule is per arch, as in the reference (``configs.base.train_schedule``:
``wsd`` for minicpm).  ``--scatter-axis`` picks the residual layout
(``auto`` is ``seq``); ``--ckpt-dir`` checkpoints there (every 50 steps,
in the reference's format) and resumes from its latest checkpoint, as the
reference's does.  The
reference's flags for what the port does not carry are accepted and raise
when set, each naming its ROADMAP item.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
from typing import List, Optional, Tuple

import torch

from repro_torch.configs.base import (ParallelConfig, get_config,
                                      get_smoke_config, train_schedule)
from repro_torch.core.overlap import VALID_MODES
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import trainer as T

# flag -> (is it set?, what it needs)
NOT_PORTED = {
    "dp": (lambda v: v != 1, "data parallelism (ROADMAP queue 1 item 10)"),
    "pods": (lambda v: v != 1, "pods (ROADMAP queue 1 item 10)"),
    "ep": (lambda v: v > 1, "expert parallelism (ROADMAP queue 1 item 8)"),
    "comm_chunks": (lambda v: v != 0,
                    "ring sub-chunking (ROADMAP queue 1 item 3)"),
    "wire_dtype": (lambda v: v is not None,
                   "wire precision (ROADMAP queue 1 item 9)"),
    "max_logit_rmse": (lambda v: v is not None,
                       "the wire error budget (ROADMAP queue 1 item 9)"),
    "plan_profile": (lambda v: v is not None,
                     "tuned seam plans (ROADMAP queue 1 item 3)"),
    "autotune": (bool, "the tuner (ROADMAP queue 1 item 6)"),
    "zero3": (bool, "ZeRO-3 (ROADMAP queue 1 item 10)"),
    "grad_compress": (bool,
                      "gradient compression (ROADMAP queue 1 item 10)"),
}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--mode", default="decomposed", choices=list(VALID_MODES))
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default=None,
                    help="cosine|wsd (default: per-arch)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--scatter-axis", default="auto",
                    choices=["auto", "seq", "hidden"],
                    help="residual-stream layout between the TP seams: "
                         "seq = sequence-sharded, hidden = replicated; "
                         "auto = seq")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory; resumes from its latest")
    # the reference's flags the port does not carry (raise when set)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--ep", type=int, default=0)
    ap.add_argument("--comm-chunks", type=int, default=0)
    ap.add_argument("--wire-dtype", default=None,
                    choices=["int8", "fp8_e4m3", "int4"])
    ap.add_argument("--max-logit-rmse", type=float, default=None)
    ap.add_argument("--plan-profile", default=None)
    ap.add_argument("--autotune", action="store_true")
    ap.add_argument("--zero3", action="store_true")
    ap.add_argument("--grad-compress", action="store_true")
    args = ap.parse_args(argv)
    for flag, (is_set, what) in NOT_PORTED.items():
        if is_set(getattr(args, flag)):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')}: {what} is not ported")
    return args


def main(argv: Optional[List[str]] = None) -> Tuple[T.Trainer, List[dict]]:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    par = ParallelConfig(tp=args.tp, overlap_mode=args.mode, fuse_w13=True,
                         scatter_axis=args.scatter_axis)
    schedule = args.schedule or train_schedule(args.arch)
    tc = T.TrainConfig(total_steps=args.steps,
                       warmup_steps=args.steps // 10, base_lr=args.lr,
                       schedule=schedule, checkpoint_dir=args.ckpt_dir,
                       log_every=10)
    tr = T.Trainer(cfg, par, tc, AdamWConfig(lr=args.lr), device=args.device,
                   dtype=getattr(torch, cfg.compute_dtype))
    tr.data_cfg = dataclasses.replace(tr.data_cfg, seq_len=args.seq,
                                      global_batch=args.batch)
    _, _, hist = tr.train(resume=args.ckpt_dir is not None)
    if hist:
        print(f"final loss: {hist[-1]['loss']:.4f} "
              f"(start {hist[0]['loss']:.4f}); {len(hist)} steps at tp="
              f"{args.tp} ({args.mode}, {args.scatter_axis})")
    else:
        print(f"nothing to run: the checkpoint is at step {tr.step}")
    print(f"straggler events {tr.straggler_events}; failures "
          f"{tr.failures}")
    return tr, hist


if __name__ == "__main__":
    main()

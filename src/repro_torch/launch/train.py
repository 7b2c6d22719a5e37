"""Training launcher (port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm_2b \
      --steps 3                      # full width on the card, tp=1
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm_2b \
      --smoke --steps 3 --tp 4 --mode flux --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm_2b \
      --smoke --steps 6 --tp 4 --scatter-axis hidden --ckpt-dir ckpt \
      --device cpu                   # resumes from ckpt/ when it holds one
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm_2b \
      --tp 4 --mode flux --autotune --steps 2     # tune, then train
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm_2b \
      --smoke --steps 3 --tp 4 --wire-dtype int8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek_v3_671b \
      --smoke --steps 3 --tp 4 --mode flux --device cpu   # MLA, MoE, MTP
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm_2b \
      --smoke --steps 3 --dp 2 --tp 2 --device cpu        # ZeRO-1 over dp
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm_2b \
      --smoke --steps 3 --pods 2 --tp 2 --grad-compress --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm_2b \
      --smoke --steps 3 --dp 2 --tp 2 --zero3 --device cpu   # ZeRO-3
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek_v3_671b \
      --smoke --steps 3 --ep 2 --tp 2 --device cpu   # a dedicated ep axis
  PYTHONPATH=src python -m repro_torch.launch.train --arch jamba_v01_52b \
      --smoke --steps 3 --dp 2 --tp 2 --zero3 --device cpu   # its preset

Runs on the CUDA card by default (bf16 weights); ``--device cpu`` runs the
plain PyTorch path (use ``--smoke`` sizes there).  At ``--tp`` > 1 the
ranks are the threads of one ``dist.RankGroup`` on the one device; at
``--dp``, ``--pods`` or ``--ep`` > 1 the threads of the ``(pods, ep,
dp, tp)`` mesh (``launch.mesh.make_mesh``): ZeRO-1 moments over the data
ranks, the batch split over pods · ep · dp shards, and
``--grad-compress`` quantizes the pod all-reduce of the grads to int8
blocks.  ``--zero3`` also shards the layers' weights over the data ranks
and gathers each layer's before it runs; on the big archs
(``launch.presets.BIG``) it also recomputes each block in the backward
(remat "full"), the two making their production preset; ``--ep`` > 1 is
a dedicated expert-parallel axis (experts split over it, replicated over
the TP ranks); without it an MoE config of more than 16 experts at ``--dp`` > 1
splits its experts over (data, model) (``ep_over_dp``), as the
reference's launcher does.  The
schedule is per arch, as in the reference (``configs.base.train_schedule``:
``wsd`` for minicpm).  ``--scatter-axis`` picks the residual layout
(``auto`` is ``seq``); ``--ckpt-dir`` checkpoints there (every 50 steps,
in the reference's format) and resumes from its latest checkpoint, as the
reference's does.  ``--plan-profile`` trains from a tuned per-seam
profile (``tuning.cache``; ignored when stale for this tp and device) and
``--comm-chunks`` sets the rings' sub-chunking of the seams it does not
cover.  ``--autotune`` at ``--tp`` > 1 first tunes every seam on a
``RankGroup`` of the run's tp on its device (a measured sweep on the
card, the ``core.ect`` roofline for an H100 on the CPU) at the run's
tokens per data replica (``--batch`` x ``--seq`` / ``--dp``, as the
reference's), writes the profile (``--plan-profile``,
default ``experiments/plans_torch/<arch>_tp<tp>.json``) and trains from
it.  ``--wire-dtype`` quantizes the TP seams' forward wire (int8,
fp8_e4m3 or int4; the backward stays fp; flux seams keep the fp wire).
With ``--autotune`` a pinned ``--wire-dtype`` sweeps the fp wire and
that one, ``--max-logit-rmse`` alone sweeps every wire
(``WIRE_DTYPE_SWEEP``), the quantized rows gated by ``--max-logit-rmse``
when given, and neither flag keeps the sweep to the fp wire.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
from typing import List, Optional, Tuple

import torch

from repro_torch.configs.base import (ParallelConfig, get_config,
                                      get_smoke_config, train_schedule)
from repro_torch.core.overlap import VALID_MODES
from repro_torch.launch.presets import BIG, EP_OVER_DP_EXPERTS
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import trainer as T



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
    ap.add_argument("--comm-chunks", type=int, default=0,
                    help="ring sub-chunking (0 = auto)")
    ap.add_argument("--plan-profile", default=None,
                    help="tuned per-seam profile JSON (repro_torch.tuning)")
    ap.add_argument("--autotune", action="store_true",
                    help="tune every seam before training and save the "
                         "profile (measured on the card, the roofline on "
                         "the CPU); needs --tp > 1")
    add_wire_args(ap)
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel ranks a pod (ZeRO-1 moments)")
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true",
                    help="int8 block-quantized pod all-reduce of the grads")
    ap.add_argument("--ep", type=int, default=0,
                    help="dedicated expert-parallel mesh axis size (0: no "
                         "\"ep\" axis; experts over \"model\" or, above "
                         "16 experts at --dp > 1, (\"data\", \"model\"))")
    ap.add_argument("--zero3", action="store_true",
                    help="shard the layers' weights over the data ranks "
                         "(gathered a layer at a time)")
    return ap.parse_args(argv)


def add_wire_args(ap: argparse.ArgumentParser) -> None:
    """The wire flags both CLIs take (the reference's)."""
    ap.add_argument("--wire-dtype", default=None,
                    choices=["int8", "fp8_e4m3", "int4"],
                    help="forward-wire precision of the TP seams (lossy on "
                         "the forward value only; flux seams keep the fp "
                         "wire)")
    ap.add_argument("--max-logit-rmse", type=float, default=None,
                    help="error budget of the --autotune wire sweep: a "
                         "quantized wire wins a seam only within it")


def wire_sweep(args: argparse.Namespace
               ) -> Optional[Tuple[Optional[str], ...]]:
    """The wires ``--autotune`` sweeps: the fp wire and a pinned
    ``--wire-dtype``; every wire when only ``--max-logit-rmse`` is given;
    else None (the fp wire alone)."""
    from repro_torch.tuning.autotune import WIRE_DTYPE_SWEEP
    if args.wire_dtype:
        return (None, args.wire_dtype)
    if args.max_logit_rmse is not None:
        return WIRE_DTYPE_SWEEP
    return None


def autotune(args: argparse.Namespace, cfg, par: ParallelConfig,
             tokens: int, decode_batch: Optional[int] = None
             ) -> ParallelConfig:
    """``--autotune``: tune every seam of ``cfg`` on a ``RankGroup`` of
    ``par.tp`` ranks on the run's device (``tuning.autotune_model``:
    measured on the card, analytic on the CPU, priced for an H100), save
    the profile, and return ``par`` reading it.  At tp=1 there is no seam
    to tune: it says so and returns ``par``."""
    if par.tp <= 1:
        print("--autotune skipped: tp=1 has no TP seams to tune; pass "
              "--tp > 1")
        return par
    from repro_torch.core import ect
    from repro_torch.device import resolve_device
    from repro_torch.dist import RankGroup
    from repro_torch.tuning import (PlanRegistry, autotune_model,
                                    default_plans_dir)
    device = resolve_device(args.device)
    path = par.plan_profile or os.path.join(
        default_plans_dir(), f"{args.arch}_tp{par.tp}.json")
    reg = PlanRegistry.open(path, n_dev=par.tp, backend=device.type)
    group = RankGroup(par.tp, device)
    autotune_model(cfg, par, hw=ect.H100_SXM, group=group,
                   tokens_per_dp=tokens, decode_batch=decode_batch,
                   registry=reg, save_path=path,
                   wire_dtypes=wire_sweep(args),
                   max_logit_rmse=args.max_logit_rmse)
    group.free_symmetric()
    print(f"autotuned seam plans -> {path}")
    return dataclasses.replace(par, plan_profile=path)


def parallel_config(args: argparse.Namespace, cfg) -> ParallelConfig:
    """The run's ``ParallelConfig``, as the reference's launcher builds
    it: ``ep_over_dp`` without a dedicated ep axis on an MoE config of
    more than 16 experts, and full remat with ZeRO-3 on the big archs, as
    their production preset pairs them."""
    return ParallelConfig(tp=args.tp, dp=args.dp, pods=args.pods,
                          ep=max(args.ep, 1), zero3=args.zero3,
                          remat=("full" if args.zero3 and cfg.name in BIG
                                 else "none"),
                          ep_over_dp=(args.ep <= 1 and cfg.moe is not None
                                      and cfg.moe.num_experts
                                      > EP_OVER_DP_EXPERTS),
                          grad_compress=args.grad_compress,
                          overlap_mode=args.mode, fuse_w13=True,
                          scatter_axis=args.scatter_axis,
                          comm_chunks=args.comm_chunks,
                          plan_profile=args.plan_profile,
                          wire_dtype=args.wire_dtype,
                          max_logit_rmse=args.max_logit_rmse)


def main(argv: Optional[List[str]] = None) -> Tuple[T.Trainer, List[dict]]:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    par = parallel_config(args, cfg)
    if args.autotune:
        par = autotune(args, cfg, par, args.batch * args.seq // args.dp)
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
              f"{args.tp} ({args.mode}, {args.scatter_axis}), dp="
              f"{args.dp}, pods={args.pods}, ep={par.ep}"
              + (", zero3" if par.zero3 else "")
              + (", ep_over_dp" if par.ep_over_dp else ""))
    else:
        print(f"nothing to run: the checkpoint is at step {tr.step}")
    print(f"straggler events {tr.straggler_events}; failures "
          f"{tr.failures}")
    return tr, hist


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The memory of the jamba train lane's Trainer under two expert layouts, on
the card.

    python3 scripts/torch_jamba_train_memory.py

The model of ``chip_smoke.py``'s ``jamba_train_lane`` (jamba_v01_52b at
full width, one period of 8 layers, 4 of its 16 experts; bf16 weights,
fp32 moments) under Jamba's production preset on 4 ranks (dp=2 x tp=2,
ZeRO-3, remat "full", flux), first with the experts over "model" (the
preset's layout), then over (data, model) (``ep_over_dp``).  For each: the
ranks' weight and moment bytes after ``Trainer.init_state`` (at one
period the reference's ZeRO-1 holds every stacked leaf's moments whole on
each data rank: the stacked dim 0 is the period count, 1), then one
training step of 2 x 1024 tokens: its peak, or the error it stopped on.
One JSON object a line, the card's name and power limit first.
"""
import dataclasses
import gc
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

GIB = float(1 << 30)


def main():
    import torch

    import chip_smoke as cs
    from repro_torch.configs.base import ParallelConfig, train_schedule
    from repro_torch.runtime import trainer as T

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cfg = cs.jamba_train_cfg()
    for ep_over_dp in (False, True):
        par = ParallelConfig(tp=cs.JAMBA_TP, dp=cs.JAMBA_TRAIN_DP,
                             zero3=True, remat="full", ep_over_dp=ep_over_dp,
                             fuse_w13=True, overlap_mode="flux")
        tc = T.TrainConfig(total_steps=1, warmup_steps=0, base_lr=3e-4,
                           schedule=train_schedule(cfg.name), log_every=1,
                           max_retries=0)
        tr = T.Trainer(cfg, par, tc, device="cuda", dtype=torch.bfloat16)
        tr.data_cfg = dataclasses.replace(
            tr.data_cfg, seq_len=cs.JAMBA_TRAIN_SEQ,
            global_batch=cs.JAMBA_TRAIN_BATCH)
        ranks, opts = tr.init_state()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        row = {"ep_over_dp": ep_over_dp,
               "weights_gib": sum(p.numel() * p.element_size()
                                  for r in ranks
                                  for p in r.parameters()) / GIB,
               "moments_gib": sum(t.numel() * t.element_size()
                                  for o in opts for k in ("mu", "nu")
                                  for t in o[k].values()) / GIB,
               "allocated_after_init_gib":
                   torch.cuda.memory_allocated() / GIB,
               "card_gib": torch.cuda.get_device_properties(0).total_memory
                   / GIB}
        torch.cuda.reset_peak_memory_stats()
        try:
            ranks, opts, hist = tr.train(ranks, opts)
            row["step_loss"] = hist[0]["loss"]
        except Exception as e:       # noqa: BLE001 — the reading to report
            row["step_error"] = repr(e)[:200]
        row["step_peak_gib"] = torch.cuda.max_memory_allocated() / GIB
        print(json.dumps(row), flush=True)
        tr.group.free_symmetric()
        del ranks, opts, tr
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

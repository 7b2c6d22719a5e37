#!/usr/bin/env python3
"""The memory of training rwkv6_3b at tp=1 on the card, with the chunked
wkv's two routes under grad.

    python3 scripts/torch_rwkv_train_memory.py

The model of ``chip_smoke.py``'s ``rwkv_train_lane`` Trainer (rwkv6_3b at
full width, all 32 layers, bf16 weights, fp32 moments, batch 4 x 1024 from
data/pipeline.py) for one step each way:

* ``function``: the port's route, ``rwkv.wkv`` under grad is ``_WKV``
  (saves its inputs and the state carried into each chunk; its backward
  re-runs each chunk), remat "none" (the training CLI's for this arch);
* ``plain_autograd``: the same step with autograd through the chunk loop
  itself (``rwkv._wkv_loop``), remat "none";
* ``function_remat_full``: the port's route with every block recomputed
  in the backward.

For each: the bytes held after ``Trainer.init_state``, then the step's
peak and host seconds, or the error it stopped on.  First, at the lane's
wkv shape [4, 40, 1024, 64] fp32, the bytes each route's forward saves
(``saved_tensors_hooks``) and the memory it holds after the forward.  One
JSON object a line, the card's name and power limit first.
"""
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

GIB = float(1 << 30)


def wkv_routes(torch, rw, cfg, cs):
    """The saved and held bytes of each route's forward at the lane's wkv
    shape."""
    dh = cfg.rwkv.head_dim
    h = cfg.d_model // dh
    b, s = cs.RWKV_TRAIN_BATCH, cs.RWKV_TRAIN_SEQ
    gen = torch.Generator(device="cuda").manual_seed(23)
    shape = (b, h, s, dh)
    args = [torch.randn(shape, generator=gen, device="cuda")
            for _ in range(3)]
    args.append(-torch.exp(torch.randn(shape, generator=gen, device="cuda")
                           * 0.5 - 3.0))
    args += [torch.randn((h, dh), generator=gen, device="cuda"),
             torch.randn((b, h, dh, dh), generator=gen, device="cuda")]
    args = [t.requires_grad_() for t in args]
    step = rw._chunk_len(s, 64)
    routes = {"function": lambda: rw.wkv(*args),
              "plain_autograd": lambda: rw._wkv_loop(*args, step)}
    for name, fn in routes.items():
        saved = []

        def pack(t):
            saved.append(t.numel() * t.element_size())
            return t
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = fn()
        torch.cuda.synchronize()
        print(json.dumps({"wkv_route": name, "shape": list(shape),
                          "saved_bytes": sum(saved),
                          "saved_tensors": len(saved),
                          "forward_held_bytes":
                              torch.cuda.memory_allocated() - before}),
              flush=True)
        del out
        torch.cuda.empty_cache()


def main():
    import torch

    import chip_smoke as cs
    from repro_torch.configs.base import ParallelConfig, train_schedule
    from repro_torch.models import rwkv as rw
    from repro_torch.runtime import trainer as T

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cfg = cs.rwkv_cfg()
    wkv_routes(torch, rw, cfg, cs)
    served = rw.wkv
    for name, remat, route in (
            ("function", "none", served),
            ("plain_autograd", "none",
             lambda r, k, v, w, u, s0, chunk=64: rw._wkv_loop(
                 r, k, v, w, u, s0, rw._chunk_len(r.shape[2], chunk))),
            ("function_remat_full", "full", served)):
        rw.wkv = route
        tc = T.TrainConfig(total_steps=1, warmup_steps=0, base_lr=3e-4,
                           schedule=train_schedule(cfg.name), log_every=1,
                           max_retries=0)
        tr = T.Trainer(cfg, ParallelConfig(remat=remat), tc, device="cuda",
                       dtype=torch.bfloat16)
        tr.data_cfg = dataclasses.replace(
            tr.data_cfg, seq_len=cs.RWKV_TRAIN_SEQ,
            global_batch=cs.RWKV_TRAIN_BATCH)
        params, opts = tr.init_state()
        torch.cuda.synchronize()
        row = {"route": name, "remat": remat,
               "allocated_after_init_gib":
                   torch.cuda.memory_allocated() / GIB,
               "card_gib": torch.cuda.get_device_properties(0).total_memory
                   / GIB}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            params, opts, hist = tr.train(params, opts)
            torch.cuda.synchronize()
            row["step_loss"] = hist[0]["loss"]
            row["step_s"] = time.perf_counter() - t0
        except Exception as e:       # noqa: BLE001 — the reading to report
            row["step_error"] = repr(e)[:200]
        row["step_peak_gib"] = torch.cuda.max_memory_allocated() / GIB
        print(json.dumps(row), flush=True)
        del params, opts, tr
        gc.collect()
        torch.cuda.empty_cache()
    rw.wkv = served


if __name__ == "__main__":
    main()

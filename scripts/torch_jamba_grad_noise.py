#!/usr/bin/env python3
"""The bf16 rounding noise of the jamba train lane's step-0 grads, on the card.

    python3 scripts/torch_jamba_grad_noise.py

The model and batch of ``chip_smoke.py``'s ``jamba_train_lane``
(jamba_v01_52b at full width, one period of 8 layers, 4 of its 16
experts, 2 x 1024 tokens, an expert capacity of E / k) from seed 0's
weights rounded to bf16: step 0 at tp=1 in fp32 on those weights (its MoE
routing kept), then with that routing replayed (``chip_smoke.replay_routes``)
step 0 at tp=1 in bf16 and at tp=2 in ``flux`` and in ``xla`` in bf16.
Prints, with the card's name and power limit first, one JSON object: for
each pair of runs the relative L2 distance of every canonical grad (the
tp=2 grads / 2), its largest and its worst leaves, and the largest for
each leaf name.  The pairs: bf16 tp=1 against fp32 tp=1 (the rounding
alone), bf16 tp=2 against fp32 and against bf16 tp=1, xla against flux.
"""
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def distances(got, want, rel_l2):
    """{max, worst 12 leaves, max a leaf name} of the relative L2 distance of
    every leaf of ``got`` from ``want``'s."""
    rel = {n: rel_l2(got[n], want[n]) for n in want}
    worst = sorted(rel, key=rel.get, reverse=True)
    names = sorted({n.split(".")[-1] for n in rel})
    return {"max": rel[worst[0]], "worst": {n: rel[n] for n in worst[:12]},
            "max_by_leaf": {leaf: max(v for n, v in rel.items()
                                      if n.split(".")[-1] == leaf)
                            for leaf in names}}


def main():
    import torch

    import chip_smoke as cs
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models import model as M
    from repro_torch.runtime import trainer as T

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cfg = cs.jamba_train_cfg()
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=e / k))
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    bsz, seq, tp = cs.JAMBA_TRAIN_BATCH, cs.JAMBA_TRAIN_SEQ, cs.JAMBA_TP
    batch = {n: torch.from_numpy(v).cuda() for n, v in batch_at(
        DataConfig(cfg.vocab_size, seq, bsz), 0).items()}
    par1 = ParallelConfig(fuse_w13=True)
    p16 = M.init_model(cfg, par1, seed=0, dtype=torch.bfloat16,
                       device="cuda", trainable=True)
    p32 = M.rebuild(p16, {n: t.detach().float()
                          for n, t in p16.named_parameters()})
    for t in p32.parameters():
        t.requires_grad_(True)
    with cs.capture_routes() as rt:
        loss32, g = T.loss_and_grads(p32, batch, T.make_ctx(cfg32, par1),
                                     cfg32, par1)
    can32 = M.canonical_leaves(g, cfg, 1, grads=True)
    routes = [(c[1].reshape(bsz, seq, -1), c[2].reshape(bsz, seq, -1))
              for c in rt.calls]
    del p32, g, rt
    torch.cuda.empty_cache()
    with cs.replay_routes(lambda i, rank: tuple(
            t.reshape(bsz * seq, -1) for t in routes[i])):
        loss16, g = T.loss_and_grads(p16, batch, T.make_ctx(cfg, par1), cfg,
                                     par1)
    can16 = M.canonical_leaves(g, cfg, 1, grads=True)
    del p16, g
    torch.cuda.empty_cache()
    out = {"losses": {"tp1_fp32": loss32.item(), "tp1_bf16": loss16.item()},
           "tp1_bf16_vs_fp32": distances(can16, can32, cs._rel_l2)}
    half = seq // tp
    flux = None
    for mode in ("flux", "xla"):
        par = ParallelConfig(tp=tp, fuse_w13=True, overlap_mode=mode)
        tr = T.Trainer(cfg, par, T.TrainConfig(total_steps=1), device="cuda",
                       dtype=torch.bfloat16)
        full = M.init_model(cfg, par, seed=0, dtype=torch.bfloat16,
                            device="cuda", trainable=True)
        ranks = [M.shard_params(full, r, tp, cfg) for r in range(tp)]
        del full
        with cs.replay_routes(lambda i, rank: tuple(
                t[:, rank * half:(rank + 1) * half].reshape(bsz * half, -1)
                for t in routes[i])):
            loss, can, _, _, _ = cs.step0(torch, cfg, par, tr.group, ranks,
                                          [batch])
        out["losses"][f"tp{tp}_{mode}_bf16"] = loss
        out[f"tp{tp}_{mode}_bf16_vs_fp32"] = distances(can, can32,
                                                       cs._rel_l2)
        out[f"tp{tp}_{mode}_bf16_vs_tp1_bf16"] = distances(can, can16,
                                                           cs._rel_l2)
        if flux is None:
            flux = can
        else:
            out["xla_vs_flux"] = distances(can, flux, cs._rel_l2)
        tr.group.free_symmetric()
        del ranks, tr, can
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""How far rounding alone moves the random rwkv6_3b's step-0 grads, on the
card.

    python3 scripts/torch_rwkv_grad_noise.py

rwkv6_3b at full width cut to its first L layers (L in ``DEPTHS``),
weights from seed 0 (drawn packed for tp=2, which pads nothing: the tp=1
model), batch 4 x 1024 from data/pipeline.py, fp32 compute.  For each L:

* ``perturbed``: tp=1 step 0 against tp=1 step 0 on weights moved by one
  rounding, w (1 + 2^-24 n) with n standard normal: what one fp32
  rounding of every weight does to the loss and to every leaf's grad;
* ``tp2_xla`` / ``tp2_flux``: step 0 at tp=2 (the canonical grads / 2)
  against tp=1's, in xla (cuBLAS) and in flux (the AG-GEMM and GEMM-RS
  kernels' fp32 path);
* ``bf16_flux_vs_xla``: step 0 at tp=2 in bf16, flux against xla.

Each reading: the loss's relative difference, the largest relative L2
over the leaves and its leaf, the five worst leaves, and each layer's
``u_bonus`` grad norm.  Then the fused kernels' fp32 path at the rwkv
lanes' seam shapes, forward and backward, against the product in fp64,
beside the plain version's (cuBLAS) distance from it.  One JSON object a
line, the card's name and power limit first.
"""
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

DEPTHS = (1, 2, 4, 8)


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
    cs.phase_build()
    tp = cs.RWKV_TP
    par1, par2 = ParallelConfig(), ParallelConfig(tp=tp, overlap_mode="flux")
    tc = T.TrainConfig(total_steps=1, warmup_steps=0, base_lr=3e-4,
                       schedule="cosine", log_every=1, max_retries=0)

    def reading(name, depth, loss, can, loss_ref, ref):
        rel = {n: cs._rel_l2(can[n], ref[n]) for n in ref}
        worst = sorted(rel, key=rel.get, reverse=True)
        print(json.dumps({
            "depth": depth, "reading": name,
            "loss_rel": abs(loss - loss_ref) / abs(loss_ref),
            "grad_rel_l2_max": rel[worst[0]], "worst_leaf": worst[0],
            "worst_leaves": {n: rel[n] for n in worst[:5]},
            "u_bonus_grad_norm": [ref[f"layers.{i}.mixer.u_bonus"].norm()
                                  .item() for i in range(depth)]}),
            flush=True)

    for depth in DEPTHS:
        cut = cs.rwkv_cfg(depth)
        cut32 = dataclasses.replace(cut, compute_dtype="float32")
        batch = {n: torch.from_numpy(v).cuda() for n, v in batch_at(
            DataConfig(cut.vocab_size, cs.RWKV_TRAIN_SEQ,
                       cs.RWKV_TRAIN_BATCH), 0).items()}

        def tp1(model):
            loss, g = T.loss_and_grads(model, batch,
                                       T.make_ctx(cut32, par1), cut32, par1)
            return loss.item(), M.canonical_leaves(g, cut, 1, grads=True)

        p1 = M.init_model(cut, par2, seed=0, dtype=torch.float32,
                          device="cuda", trainable=True)
        loss1, g1 = tp1(p1)
        gen = torch.Generator(device="cuda").manual_seed(1)
        with torch.no_grad():
            for t in p1.parameters():
                t.mul_(1 + 2.0 ** -24 * torch.randn(
                    t.shape, generator=gen, device="cuda"))
        reading("perturbed", depth, *tp1(p1), loss1, g1)
        del p1
        tr = T.Trainer(cut32, par2, tc, device="cuda", dtype=torch.float32)
        for dtype in (torch.float32, torch.bfloat16):
            full = M.init_model(cut, par2, seed=0, dtype=dtype,
                                device="cuda", trainable=True)
            ranks = [M.shard_params(full, r, tp, cut) for r in range(tp)]
            del full
            got = {}
            for mode in ("xla", "flux"):
                par = dataclasses.replace(par2, overlap_mode=mode)
                c = cut32 if dtype == torch.float32 else cut
                losses, grads, *_ = cs.step0_grads(torch, c, par, tr.group,
                                                   ranks, [batch])
                got[mode] = (losses[0], cs.synced_canonical(
                    torch, cut, par, tr.group, ranks, grads))
                del grads
            if dtype == torch.float32:
                for mode in ("xla", "flux"):
                    reading(f"tp2_{mode}", depth, *got[mode], loss1, g1)
            else:
                reading("bf16_flux_vs_xla", depth, *got["flux"],
                        *got["xla"])
            del ranks, got
        tr.group.free_symmetric()
        del tr, g1
        torch.cuda.empty_cache()

    from repro_torch.dist import RankGroup
    from repro_torch.kernels import ag_gemm as AG
    from repro_torch.kernels import gemm_rs as RS
    group = RankGroup(tp, "cuda", timeout_s=60)
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [(c, "ag") for c in (cs.rwkv_seam_cases("ag")
                                 + cs.rwkv_train_seam_cases("ag"))]
    cases += [(c, "rs") for c in (cs.rwkv_seam_cases("rs")
                                  + cs.rwkv_train_seam_cases("rs"))]
    for (name, rows, k, n, act), which in cases:
        args = [(torch.randn((rows, k), generator=gen, device="cuda"),
                 torch.randn((k, n), generator=gen, device="cuda"))
                for _ in range(tp)]
        if which == "ag":
            outs = group.spmd(lambda a, b: AG.ag_gemm(
                a, b, group=group, activation=act), args)
            full = torch.cat([a for a, _ in args]).double()
            wants = [AG.ag_gemm_ref([a for a, _ in args], b, act)
                     for _, b in args]
            exact = [full @ b.double() for _, b in args]
            if act:
                exact = [torch.relu(e) ** 2 for e in exact]
        else:
            outs = group.spmd(lambda a, b: RS.gemm_rs(a, b, group=group),
                              args)
            parts = [a @ b for a, b in args]
            wants = [RS.reduce_ref(parts, r, None, None, torch.float32)
                     for r in range(tp)]
            tot = sum(a.double() @ b.double() for a, b in args)
            exact = list(torch.chunk(tot, tp, dim=0))
        print(json.dumps({
            "kernel_case": name + "_fp32", "rows": rows, "K": k, "N": n,
            "activation": act,
            "kernel_rel_l2_vs_fp64": [cs._rel_l2(o, e) for o, e in
                                      zip(outs, exact)],
            "cublas_rel_l2_vs_fp64": [cs._rel_l2(w, e) for w, e in
                                      zip(wants, exact)]}), flush=True)
        del args, outs, wants, exact
    group.free_symmetric()


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a) and runs from
a checkout of this repository.  Phases, one JSON object per line each:

1. device  — the card, its power limit, torch and CUDA versions;
2. build   — every kernel built from ``src/repro_torch/csrc`` with nvcc, in
             parallel; the compiler's registers and spills; the SASS of
             the bf16 flash kernel, the MLA-decode kernel and the bf16
             GEMM tile in matmul, ag_gemm and gemm_rs must hold HGMMA and
             UTMALDG (wgmma, TMA);
3. kernel  — each kernel (flash attention, MLA decode) against its plain
             PyTorch version on the card at the main paths' shapes (the
             kernel lane's, the tp lane's and the paper lane's flash
             shapes, the mla lane's decode at 128 heads and at the mla
             tp lane's 32 heads a rank) and a few edge cases, with its time, the plain
             version's, the library call's and the bound; the MLA kernel
             also with its split count and its combine's time;
4. kernel_lane — full-width minicpm_2b cut to its first LANE_LAYERS (8)
             of 40 layers (seeded random weights): batched prefill
             through ``prefill_step`` with ``kernel_decode=True`` (one
             flash-kernel launch per layer), checked against the same
             prefill with plain attention, then 16 dense decode steps
             (``decode_step``'s halves, their logits kept for tp_decode);
5. server_lane — ``repro_torch.launch.serve`` answering 8 requests through
             the paged ``Server`` at full width over the kernel lane's
             layers, and the same requests served one at a time: a
             smoke check of the runtime (short
             prompts), not a serving workload;
6. mla_lane — deepseek_v3_671b's first four layers at full width (three
             MLA + dense-FFN layers, one MLA + MoE layer; seeded random
             weights): batched prefill, then dense ``decode_step``s with
             ``kernel_decode=True`` (one MLA-decode launch and one combine
             per layer a step)
             teacher-forced against the same steps with plain attention,
             and one paged step through block tables;
7. mla_server_lane — the paged ``Server`` over the same four layers: 8
             requests served together, one at a time, and again on the
             same server (prefix reuse); a smoke check, no kernel runs;
   The mla lane also keeps, before its model is freed, the tp=1
   references of the mla tp lane: the drop-free prefill's logits (every
   MoE assignment kept) and 16 greedy kernel decode steps' logits;
   mla_tp_lane — the same four layers at tp=4 (4 ranks on the one card,
             the same canonical weights, w1|w3 packed, 64 experts a
             rank): prefill at the config's capacity factor in flux (48
             AG-GEMM and 32 GEMM-RS launches: what its PlanSet implies;
             the MoE exchange across the ranks), xla and decomposed, each
             rank's dropped assignments; the flux prefill drop-free
             against tp=1's; then 16 decode steps from its caches through
             the MLA-decode kernel at 32 heads a rank, teacher-forced on
             tp=1's tokens (logits each step against tp=1's, 256 kernel
             launches), one paged step; the a2a op alone, host and
             device time;
   mla_tp_server_lane — ``launch.serve --arch deepseek_v3_671b --layers 4
             --tp 4 --mode flux``: the tp server lane's requests and gates
             (``serve_lane``, the near-tie rule), TPOT beside tp=1's;
8. matmul_kernel — the GEMM kernel against its plain version at the
             op-level shapes (GPT-3 175B at TP 8, bf16), a ragged shape and
             fp32, with its time, the plain version's, cuBLAS's
             (``torch.matmul``), the bound and the compiler's registers and
             spills;
9. op_level_lane — ``repro_torch.launch.op_level --tp 1`` over its full
             sweep (12 GEMM_non-split shapes through the flux wrappers at
             one device, each beside ``torch.matmul``), then each row's
             result against the plain version once;
10. ag_gemm_kernel, gemm_rs_kernel — the fused AllGather-GEMM and
             GEMM-ReduceScatter kernels, 8 (or 4) ranks of a ``RankGroup``
             on the one card, against their plain versions at the §5.1
             shapes (m 8192 and 64), a ragged shape, silu + bias, the
             reversed ring, the tp lane's shape and fp32; each with the
             fused n-rank time, the ``xla`` mode's, n x the GEMM kernel's,
             the plain version's and the bound;
11. tp_op_level_lane — ``launch.op_level`` at TP 8: 2 seams x 6 m x 3
             modes = 36 rows through ``FusedOp``, the fused kernels'
             launches counted, then every row against the plain version;
12. tp_lane — full-width minicpm_2b over the kernel lane's layers at
             tp=4 (4 ranks on the one card, seeded weights drawn as at
             tp=1, w1|w3 packed, cut per rank): one flux prefill with the
             kernels (64 AG-GEMM, 64 GEMM-RS and 32 flash launches), then
             xla and decomposed; last-position logits
             against the tp=1 kernel lane's and flux against xla.  The
             ranks share the card, so no ECT or overlap efficiency comes
             from these times;
   tp_decode — then 16 dense decode steps at tp=4 in flux from that
             prefill's caches (``decode_step``'s halves, their logits
             kept), teacher-forced on the kernel lane's tokens (the
             replicated layout: ``ar`` seams, no fused kernel): each
             step's logits against the kernel lane's, the first 4 steps
             also in xla and decomposed against flux, every rank's tokens
             equal, and the last step again through ``decode_step``
             itself, whose tokens must equal the halves'; the step's
             time, a profiled step, and one ``ar`` op's host time per
             mode;
   tp_server_lane — the paged ``Server`` at tp=4 in flux through
             ``launch.serve`` (minicpm_2b at full width, its first 2
             layers): 8 requests together, every second one alone and
             all again (prefix reuse), first tokens against the tp=1 Server's
             and their logits within TP_LANE_RTOL of tp=1's;
13. train_lane — full-width minicpm_2b cut to its first 4 layers, trained
             through ``runtime.trainer`` (bf16 weights, fp32 moments, wsd,
             batch 4 x 1024): 3 steps at tp=1, then at tp=4 in flux mode
             on the one card, whose forward and backward seams run the
             AG-GEMM and GEMM-RS kernels (4L + 1 of each a rank a step);
             step 0's loss and grads against tp=1's, xla's, decomposed's
             and decomposed_bidir's against flux's; step 0 with
             ``remat="full"`` at tp=1 and at tp=4 in flux against the same
             step without (the recompute launching 2L more of each fused
             kernel a rank); and the replicated ("hidden") layout's step 0
             in flux, xla and decomposed against the seq layout's flux
             (no fused kernel), each step's peak memory recorded.  The
             ag_gemm and gemm_rs phases also hold the kernels at the
             backward's operands;
   mla_train_lane — deepseek_v3_671b at full width cut to the mla lanes'
             four layers and to 16 of its 256 routed experts (4 a rank),
             its MTP head kept, batch 2 x 1024: step 0 drop-free at tp=1,
             then at tp=4 in flux (the fused launches its PlanSet implies,
             forward and backward: MLA's two up-projections, the dense and
             shared experts' seams, both heads) against tp=1 (the routed
             experts' grads, which move with the router's near ties,
             against xla's and against tp=1 on identical inputs; every
             token routed elsewhere a near tie), xla against flux; 3
             ``Trainer`` steps at tp=4 in flux at the config's capacity
             factor (losses, step ms, each rank's drops, peak memory, a
             profiled step); the ``moe_a2a`` op alone, forward and
             backward, ``xla`` against the ring; the measured sweep of
             its ``moe_a2a`` cell beside the analytic winner.  The
             ag_gemm and gemm_rs phases hold the kernels at this lane's
             backward operands (``mla_train_seam_cases``);
   dp_lane — data parallelism on a ``dist.RankMesh``: the train lane's
             cut and tokens at dp=2 x tp=2 in flux (two TP groups of 2
             launching the fused kernels at once, each data rank on its
             2 x 1024 shard): step 0 against dp=1 x tp=2 on the same global
             batch (loss and canonical grads), the launches its PlanSet
             implies per TP group; the int8 pod all-reduce of those grads
             at pods=2 x dp=1 x tp=2 against the fp32 one and one
             ``Trainer`` step there with ``grad_compress``; 3 ``Trainer``
             steps at dp=2 x tp=2 (losses, step ms, each rank's ZeRO-1
             moment bytes against dp=1's, peak memory, a profiled step);
   mesh_serve_lane — serving on the rank mesh, llama4_scout_17b_a16e at
             full width cut to 2 of 48 layers (16 experts top-1 and a
             shared expert, drop-free capacity): the tp=1 anchor (a flash
             prefill of 4 x 1024 tokens, 8 decode steps); the batched
             prefill at dp=2 x tp=2 under ZeRO-3 in flux with the kernels
             (the launches its PlanSet implies for two TP groups) and 8
             decode steps teacher-forced on tp=1's tokens; the prefill at
             ep=2 x tp=2 (experts over the ep axis); the paged Server at
             dp=2 x tp=2 under ZeRO-3 (concurrent = isolated, prefix
             reuse, every rank agreeing, first-token logits against the
             tp=1 Server's); ``launch.serve --dp 2 --tp 2``; each against
             tp=1 within TP_LANE_RTOL, tokens under the near-tie rule;
   jamba_lane — Jamba's Mamba layers served: jamba_v01_52b at full width
             cut to one period of 8 of its 32 layers (7 Mamba, 1 GQA, 4
             dense and 4 MoE FFNs, drop-free), its weights drawn once:
             the tp=1 anchor with the flash kernel (a 4 x 1024 prefill;
             other pad tokens change no state, bit for bit; each row
             alone at the batch's shape, bit for bit, and at its own
             length: its Mamba states and its logits; 8 decode steps, the
             8th against a fresh prefill over the prompt and the fed
             tokens), each comparison with the MoE routing replayed
             (``replay_routes``: bf16 noise sends tokens to other experts
             at near ties, every one held to the near-tie rule of
             ``_routing_vs``); the paged Server at tp=1
             (a prompt's chunks interleaved with the others' decode
             steps, concurrent = isolated, the pool below its dense
             equivalent, no prefix reuse); the prefill at tp=2 in flux
             (the launches its PlanSet implies: the Mamba in-projections'
             shared AG-GEMM, ``w_out``'s GEMM-RS) and 8 decode steps
             against tp=1; ``launch.serve --arch jamba_v01_52b --layers
             8``.  The kernel phases hold the flash, AG-GEMM and GEMM-RS
             kernels at the lane's shapes;
   jamba_train_lane — Jamba trained: jamba_v01_52b at full width, one
             period of 8 layers, 4 of its 16 experts, 2 x 1024 tokens:
             the selective scan's backward on the card (its grads
             against a step-by-step scan, the bytes it saves and the
             memory it adds at the lane's shape); step 0 in fp32 at tp=1
             and at tp=2 in flux (the launches its PlanSet implies; the
             loss and every canonical grad against tp=1's with tp=1's
             routing replayed); step 0 at tp=2 in bf16 in flux, its
             routing free running under the near-tie rule, against the
             same step in xla on flux's routing; 3 bf16 Trainer steps at dp=2 x
             tp=2 under ZeRO-3 with remat "full" in flux, the experts
             over (data, model) (losses, the launches with the
             recompute's, step ms, peak memory, a profiled step).  The
             AG-GEMM and GEMM-RS phases hold the kernels at two of its
             backward operands;
   rwkv_lane — RWKV-6 served: rwkv6_3b at full width, bf16: at tp=1 over
             all 32 layers a 4 x 1024 prefill (no kernel: local GEMMs and
             the plain chunked wkv; other pad tokens change no state, bit
             for bit; each row alone at the batch's shape, bit for bit,
             and at its own length: every layer's wkv state, both
             token-shift rows and its logits), 8 decode steps and the
             first against a prefill of N + 1; the paged Server (a
             prompt's chunks interleaved with the others' decode steps,
             concurrent = isolated, the requests again in the freed
             slots, no prefix reuse); the prefill at tp=2 in flux over 8
             layers (the launches its PlanSet implies: one AG-GEMM over
             the time-mix's five projections, one with the channel-mix's
             squared-ReLU epilogue, two GEMM-RS a layer a rank; the
             logits and each rank's heads of the state against tp=1's)
             and 8 decode steps; ``launch.serve --arch rwkv6_3b --layers
             8``.  The AG-GEMM and GEMM-RS phases hold the kernels at the
             lane's four seam shapes (the squared-ReLU epilogue's first
             case on the card);
14. tune_lane — the seam plans and the tuner, minicpm_2b at full width
             at tp=4 on the one card: the AG-GEMM and GEMM-RS kernels with
             each Hopper tile and ring direction forced at the lane's seam
             shapes against their plain versions; the measured sweep
             (``tuning.autotune_model``, every candidate of every seam
             timed, the flux rows launching the kernels, each cell's table
             and winner, the winner against its plain version); step 0 of
             the train lane's cut from the tuned profile and under a fixed
             heterogeneous PlanSet against the uniform flux step, with the
             launches their PlanSets imply; then the Trainer, ``launch.
             train`` (full depth, 2 steps) and ``launch.serve`` (tp=4, the
             tp server lane's layers, first tokens against tp=1's) from the
             profile;
   wire_lane — wire precision (``FusedOp.wire_dtype``) at tp=4 on the
             one card: ``wire_encode`` on the card against the CPU (bytes
             and scales bit-equal; a zero block, width 200, int4 at width
             127) with the codec's device price per hop; each wired op
             alone at the tp lane's seam shapes, the decode ``ar`` and the
             ``moe_a2a`` cell, every mode that carries a wire under int8,
             fp8_e4m3 and int4 beside the fp wire (grads equal to the fp
             wire's, no encode in the backward); minicpm_2b's prefill
             logits over its first WIRE_PREFILL_LAYERS (16) layers under
             each wire against the fp wire
             (``error_budget.model_logit_rmse``, decomposed; int8 within
             0.05) and the flux control (a wired ``ParallelConfig`` keeps
             flux's fp wire: bit-equal logits, 128 / 128 / 64 launches);
             step 0 of the train lane's cut in decomposed under int8 (the
             encodes its plans imply, none in the backward); the measured
             and the analytic wire sweep (``autotune_model`` with
             ``WIRE_DTYPE_SWEEP`` under a 0.05 budget: no winner out of
             budget); ``launch.serve --mode decomposed --wire-dtype int8``
             over the tp server lane's 2 layers and requests against
             the fp wire (first-token logits within 0.05);
15. train_remat — minicpm_2b at full width and all 40 layers, 3 trainer
             steps at tp=1 with ``remat="full"``: finite losses, step time
             and peak memory;
16. train_ckpt — minicpm_2b at full width cut to 2 layers, dp=2 x tp=2
             flux: 4 steps with a checkpoint every 2 (save and restore
             seconds, bytes on disk), a fresh trainer on the dp=1 x tp=2
             mesh of ``elastic_remesh`` resuming at step 2 (its weights and
             moments bit-equal to the checkpoint, its losses against the
             uninterrupted run's), and a run that recovers from a failure
             before step 3;
17. paper lane — the paper's §5 models at full width, cut in depth only,
             at tp=8 on the one card (8 ranks, seeded bf16 weights drawn
             as at tp=1, w1|w3 packed, cut per rank), 8 x 2048 tokens with
             the last rows shorter:
   paper_gpt3_prefill — GPT-3 175B, 2 of 96 layers: a tp=1 prefill and
             8 decode steps first (then freed); the flux prefill with the
             kernels (32 AG-GEMM, 32 GEMM-RS, 16 flash launches: what its
             PlanSet implies), its logits against tp=1's and xla's, then
             xla and decomposed (no fused kernel), each mode's ms, profiled
             flux and xla prefills;
   paper_gpt3_decode — 8 decode steps at tp=8 from the flux prefill's
             caches (``tp_decode``: ``ar`` seams, no fused kernel) against
             the tp=1 decode;
   paper_gpt3_tune — the measured sweep at tp=8 (8 x 2048 tokens a seam,
             8 decode rows), the flux prefill from its profile against the
             uniform one with the launches its PlanSet implies, one
             ``paper_tune_cell`` line a cell;
   paper_gpt3_train — GPT-3 175B, 1 layer, batch 2 x 2048: step 0 at tp=1
             and at tp=8 in flux (loss, canonical grads / 8, the launches
             its PlanSet implies) and xla, then 3 trainer steps;
   paper_llama2_prefill — Llama-2 70B, 4 of 80 layers: as GPT-3's prefill
             (the flash kernel over 8 query heads and 1 KV head a rank);
   paper_llama2_train — Llama-2 70B, 2 layers: step 0 as GPT-3's;
   paper_llama2_serve — ``launch.serve --arch llama2_70b --layers 1 --tp 8
             --mode flux``: the tp server lane's requests and gates, in
             bf16; its first-token logits within TP_LANE_RTOL of tp=1's,
             and a first token may differ from tp=1's only where tp=1's
             top-2 margin is at most twice the logits' largest difference
             (``serve_lane``'s near-tie rule).
   The kernel phase holds the flash kernel at the lane's two per-rank
   shapes.

Host-clock times are medians of warm repeats; each profiled pass reports
the device's busy share of its own wall time.

It ends with the card's ``nvidia-smi`` name/power line, the kernels line
and ``{"ok": true, "device": {...}}``.  Any failed check raises: the exit
code is then nonzero and no result line is printed.  Without a CUDA card,
or outside a checkout (no ``src/repro_torch``), it fails the same way.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# bf16 kernel vs plain: output rounding to bf16 (8 bits of mantissa) of
# values ~1; fp32: summation order only
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# the kernel lane, kernel prefill vs plain prefill over LANE_LAYERS bf16
# layers: relative L2 difference of the logits and of the last layer's K/V
# caches (the inputs of the last layer carry the earlier layers' bf16
# rounding of attention outputs summed in another order)
LANE_RTOL = 5e-2
# minicpm_2b's first layers in the kernel lane, the server lane and the
# tp lane (all 40 until the whole script neared its 1200 s limit; on an
# H100 80GB HBM3 at 700 W the kernel vs plain logits were 2.05 % apart at
# 40 layers and 1.66 % at 16, the tp=4 prefill's 2.08 % and 1.66 % and
# its decode's up to 2.14 % and 1.74 % from tp=1's)
LANE_LAYERS = 8
# MLA decode kernel vs plain: fp32 sums in another order over up to 32k
# positions of values ~1
MLA_TOL = 1e-4
# the mla lane, kernel decode vs plain decode over 4 bf16 layers: relative
# L2 difference of the last layer's latent cache (its inputs carry three
# layers of attention outputs summed in another order, rounded to bf16)
MLA_LANE_RTOL = 1e-2
# warm repeats of each host-clock timing; the median is reported
REPEATS = 5
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
PEAK_TF32 = 495e12                                      # fp32 inputs, tensor cores
PEAK_BYTES = 3.35e12                                    # H100 SXM HBM3
L2_FLUSH_BYTES = 128 << 20                              # > the 50 MB L2
KERNEL_SOURCES = ("flash_attention", "mla_decode", "matmul", "ag_gemm",
                  "gemm_rs")
L2_BYTES = 50 << 20                                     # H100 L2 cache
# GEMM kernel vs plain: bf16 outputs within 2 bf16 ulps (rtol 2^-7) plus
# atol 1e-3 * max|C| for values near 0; fp32 atol 1e-5 * sqrt(K), rtol 1e-5
# (summation order only; tests/test_kernels.py's matmul tolerance)
GEMM_BF16_RTOL = 2.0 ** -7
GEMM_BF16_ATOL_REL = 1e-3
GEMM_F32_TOL = 1e-5
# GEMM-RS kernel vs plain: each rank's partial tile is rounded to bf16 once
# in both, from fp32 sums taken in another order (one bf16 ulp of the
# partial apart at worst), and n of them are summed: atol adds
# n * 2^-8 * max|partial| to the GEMM rule; fp32 partials add n * the fp32
# GEMM rule
RS_PARTIAL_ULP = 2.0 ** -8
# the tp lane: tp=4 prefill vs the tp=1 kernel lane's logits (same
# canonical weights, reduce-scatter sums in another order over LANE_LAYERS
# bf16 layers), and flux vs xla: relative L2 of the last-position logits
TP_LANE_RTOL = 5e-2
# the kernel lane's and the tp lane's dense decode steps (the tp lane's
# teacher-forced on the kernel lane's tokens); their logits are held to the
# same TP_LANE_RTOL at each step
N_DECODE = 16
N_DECODE_OTHER_MODES = 4  # the tp lane's xla and decomposed decode steps
# the mla tp lane: deepseek_v3_671b's first four layers at tp=4, and its
# tp=1 references taken in the mla lane; drop-free, no MoE assignment is
# evicted at either tp (the reference's own TP-invariance test raises the
# factor to 16 for this: eviction order depends on the layout)
MLA_TP = 4
MLA_TP_LENGTHS = [256, 512, 777, 1024]     # the prefill's prompts
MLA_DROP_FREE_CF = 16.0
MLA_TP_SERVER_ARGV = (["--arch", "deepseek_v3_671b", "--layers", "4"]
                      + ["--requests", "8", "--max-batch", "8",
                         "--prompt-len", "40", "--max-new", "16",
                         "--max-seq", "256", "--block-size", "16",
                         "--prefill-chunk", "32"])
# the mla train lane: deepseek_v3_671b at full width, cut to the mla lanes'
# four layers (3 MLA + dense FFN, 1 MLA + MoE; the MTP head kept) and to
# 16 of its 256 routed experts (4 a rank at tp=4, top-8 kept): one MoE
# layer at 256 experts is 11.3 B parameters, 135 GB with bf16 weights and
# grads and fp32 moments, which no card holds; at 32 the 3 trainer steps
# at tp=4 ran the card out of memory (60 GB allocated, 18 GB of the
# allocator's free blocks too fragmented to hold a leaf's temporaries).
# Batch 2 x 1024 from data/pipeline.py (512 tokens a rank's shard)
MLA_TRAIN_LAYERS = 4
MLA_TRAIN_EXPERTS = 16
MLA_TRAIN_BATCH, MLA_TRAIN_SEQ, MLA_TRAIN_STEPS = 2, 1024, 3
# the tp server lane: minicpm_2b at full width, cut to its first 2 layers
# (8 until the jamba lane came, then 4 until the whole script neared its
# 1200 s limit: both servers it compares, and the tune lane's,
# run the same layers; the lane took 86.9 s at 8 layers and 37.8-53.2 s
# at 4 on an H100 80GB HBM3 at 700 W)
TP_SERVER_LAYERS = 2
TP_OP_LEVEL = 8          # the paper's N_TP: the §5.1 rows' ranks
TP_LANE = 4              # minicpm_2b prefill's and training's ranks
DP_LANE = (2, 2)         # the dp lane's mesh: (tp, dp) = 2 x 2 ranks
# the ep lane: the mla train lane's configuration at tp=2 in three layouts
# of 4 ranks (experts over "model", a dedicated ep axis, experts over
# (data, model))
EP_LANE_TP = 2
# the pipeline lane: GPipe over a 4-rank pod view, the dp lane's 4
# minicpm_2b layers 1 a stage at tp=1 with the flash kernel, its 4 x 1024
# tokens in 4 microbatches
PIPE_STAGES, PIPE_MICRO = 4, 4
EP_LANE_LAYOUTS = (("dp2_tp2", {"dp": 2}), ("ep2_tp2", {"ep": 2}),
                   ("dp2_tp2_ep_over_dp", {"dp": 2, "ep_over_dp": True}))
# the tp lane's timed calls a mode, its prefills' and its decode steps'
# (5 and 3 until the dp lane came: the script stays inside its time
# budget; host-clock times here move far more than these repeats settle)
TP_LANE_REPEATS = 2
# the mesh serve lane: llama4_scout_17b_a16e at full width cut to 2 of its 48
# layers (10.9 GB of bf16 weights: 2 x 2.2 B layer parameters and the 1.03 B
# embedding), a 4 x 1024 prefill with the rows' lengths below and 8 decode
# steps; its Server's and its CLI's requests (4 and 4, 4 new tokens each,
# until the whole script took 1157.6 s on an H100 80GB HBM3 at 700 W: the
# Server part 9.3 s and the CLI 2.8 s of the lane's 14.6)
MESH_SERVE_LAYERS = 2
MESH_SERVE_LENGTHS = [1024, 777, 512, 256]
MESH_SERVE_DECODE = 8
MESH_SERVE_PROMPTS = [40, 57, 73]
MESH_SERVE_NEW = 2
MESH_SERVE_CLI_REQUESTS = 2
MESH_SERVE_ARGV = ["--arch", "llama4_scout_17b_a16e", "--layers",
                   str(MESH_SERVE_LAYERS), "--requests",
                   str(MESH_SERVE_CLI_REQUESTS), "--prompt-len", "40",
                   "--max-new", str(MESH_SERVE_NEW), "--max-batch", "4",
                   "--prefill-chunk", "64"]
# the jamba lane: jamba_v01_52b at full width cut to its first 8 of 32
# layers (one period of the pattern: 7 Mamba, 1 GQA, 4 dense and 4 MoE
# FFNs; 13.0 B parameters, 26.1 GB of bf16), drop-free: a batched prefill
# of 4 x 1024 tokens with the rows' lengths below and 8 decode steps at
# tp=1 and at tp=JAMBA_TP; the paged Server's requests (the 73-token
# prompt prefills over three 32-token chunks while the others decode) and
# the CLI's.  Each row's prefill alone at the batch's shape (the other
# rows one pad token each) gives the batch's Mamba states, logits and
# experts bit for bit, as do other tokens at the pad positions (the
# freeze).  Each row alone at its own length, the batch's MoE routing
# replayed: the first Mamba layer's state (its input the embedding, which
# another batch shape cannot move) within JAMBA_STATE_RTOL (relative L2),
# every layer's within TP_LANE_RTOL: at another shape the GEMMs' bf16
# sums differ, 0.9-1.6 % on the rows' logits, and a later layer's conv and
# ssm states moved 0.2-2.1 % (1.2-10.0 % with free routing), on an H100
# 80GB HBM3 at 700 W
JAMBA_LAYERS = 8
JAMBA_TP = 2
JAMBA_LENGTHS = [1024, 777, 512, 256]
JAMBA_DECODE = 8
JAMBA_STATE_RTOL = 1e-2
JAMBA_PROMPTS = [40, 57, 73]
JAMBA_NEW = 4
JAMBA_ARGV = ["--arch", "jamba_v01_52b", "--layers", str(JAMBA_LAYERS),
              "--requests", "2", "--prompt-len", "40", "--max-new",
              str(JAMBA_NEW), "--max-batch", "4", "--block-size", "16",
              "--prefill-chunk", "32"]
# the jamba train lane: jamba_v01_52b at full width, one period, cut to 4
# of its 16 experts (top-2 kept, 2 a rank at tp=2: at 16 a period holds
# 13.0 B weights, 156 GB at 2 + 2 + 4 + 4 bytes a weight; at 4, 4.57 B and
# 55 GB), batch 2 x 1024; step 0 at tp=1 and at tp=2 in flux with an
# expert capacity of E / k (every token at most once an expert: drop-free
# by construction, the expert buffers 8x smaller than drop_free's 16),
# then 3 Trainer steps at dp=2 x tp=2 under ZeRO-3 with remat "full" (the
# production preset) at the config's capacity factor, the experts over
# (data, model) (``ep_over_dp``, 1 a rank): at one period the reference's
# ZeRO-1 holds every stacked leaf's moments whole on each data rank (the
# period count, 1, is the stacked dim 0, which dp=2 does not divide), so
# with the experts over "model" alone the ranks' weights and moments took
# 15.2 + 58.8 GiB before a step (74.0 of the card's 79.2) and the step ran
# out of memory, with them over (data, model) 10.0 + 37.8 and the step's
# peak 65.5 (scripts/torch_jamba_train_memory.py on an NVIDIA H100 80GB
# HBM3 at 700 W)
JAMBA_TRAIN_EXPERTS = 4
JAMBA_TRAIN_BATCH, JAMBA_TRAIN_SEQ, JAMBA_TRAIN_STEPS = 2, 1024, 3
JAMBA_TRAIN_DP = 2
# its step 0 at tp=2 in flux against tp=1, both fp32 with tp=1's routing
# replayed: the loss and every canonical grad / tp within relative (L2)
# 1e-3 (read: loss 8.2e-8, the worst grad 2.36e-5; the same pair in bf16
# lies 1.9-5.3 % apart, bf16 tp=1 2.1-5.7 % from fp32: rounding, which
# no limit near 5e-2 separates from a wrong kernel); and the trainer's
# dtype, bf16, where flux runs its wgmma kernels: step 0 at tp=2 in flux
# against the same step in xla (the seams' plain version) on flux's
# routing, each rank's loss and every grad within relative L2 1e-2
# (read: 0 on every leaf but the experts', 0.29 % there;
# scripts/torch_jamba_grad_noise.py on an NVIDIA H100 80GB HBM3 at 700 W)
JAMBA_F32_RTOL = 1e-3
JAMBA_BF16_MODES_RTOL = 1e-2
# the scan's backward on the card: its grads against autograd through a
# step-by-step scan at full channel width over (B, S, chunk), fp32 (TOL);
# and at the lane's tp=1 shape [2, 1024, 8192, 16] the memory its backward
# adds: 8 of a chunk's [B, 256, C, N] fp32 tensors (268 MB each) at most,
# where autograd through the log-depth rounds would keep about three a
# round, 8 rounds a chunk, 4 chunks a layer (about 26 GB by that count)
JAMBA_SCAN_CHECK = (1, 128, 32)
JAMBA_SCAN_MEM_GB = 2.2
# the rwkv lane: rwkv6_3b at full width, bf16, weights from seed 0 (2.91 B
# parameters: 2.74 B in the 32 layers, 0.17 B in the tied embedding; 5.8
# GB), served at full depth at tp=1: a batched prefill of 4 x 1024 tokens
# with the rows' lengths below, 8 decode steps, the paged Server's
# requests (the 73-token prompt prefills over three 32-token chunks while
# the others decode) and the CLI's.  Each row's prefill alone at the
# batch's shape (the other rows one pad token each) gives the batch's wkv
# state, both token-shift rows and its logits bit for bit, as do other
# tokens at the pad positions (the freeze: k = 0, logw = 0).  Each row
# alone at its own length (every layer's state and the logits) and a
# prefill of N then one decode step against a prefill of N + 1 (decode
# mixes h and prev before its GEMMs, the prefill folds mu into the
# weights) compute the same numbers two ways: held to TP_LANE_RTOL in fp32
# on the same draw (the decode step also read in bf16).  This random model
# amplifies a difference about 1.28x a layer: in fp32 a row alone moved
# 1e-5 at layer 3 and 1.13 % at layer 31 (the logits 0.04-0.51 %), in
# bf16 0.28 % a layer to 8.9 % at layer 31 (the logits 8.4-8.9 %), past
# TP_LANE_RTOL by rounding alone (scripts/torch_rwkv_depth_noise.py on an
# NVIDIA H100 80GB HBM3 at 700 W).  tp=RWKV_TP in flux over the first
# RWKV_TP_LAYERS layers (a depth cut set by the script's time budget)
# against tp=1 at the same depth on the same weights: 40 heads and d_ff
# 8960 divide at tp=2, so the tp=2 draw pads nothing and packs nothing,
# and its global weights are the tp=1 model's, leaf for leaf
RWKV_TP = 2
RWKV_TP_LAYERS = 8
RWKV_LENGTHS = [1024, 777, 512, 256]
RWKV_DECODE = 8
RWKV_PROMPTS = [40, 57, 73]
RWKV_NEW = 4
RWKV_ARGV = ["--arch", "rwkv6_3b", "--layers", str(RWKV_TP_LAYERS),
             "--requests", "2", "--prompt-len", "40", "--max-new",
             str(RWKV_NEW), "--max-batch", "4", "--block-size", "16",
             "--prefill-chunk", "32"]
# the rwkv train lane: rwkv6_3b at full width, weights from seed 0, batch
# 4 x 1024 from data/pipeline.py.  Step 0 at tp=RWKV_TP in flux over the
# first RWKV_TP_LAYERS layers, in fp32 and in bf16, each with its launches
# held to the PlanSet's; the same steps over the first RWKV_GATE_LAYERS
# layers held against tp=1 in fp32 (the loss and every canonical grad /
# tp within JAMBA_F32_RTOL) and in bf16 against xla, the seams' plain
# version (each rank's loss and every grad within JAMBA_BF16_MODES_RTOL);
# then the Trainer at tp=1 over all 32 layers in bf16 (fp32 moments) for
# RWKV_TRAIN_STEPS steps with the training CLI's remat for this arch.
# The gates hold at 1 layer, a depth cut of their scope: this random
# model's grads are chaotic in depth.  One fp32 rounding of every weight,
# w (1 + 2^-24 n), moves the step-0 grads by 2.2e-5 at 1 layer, 2.5e-4
# at 2, 9.7e-3 at 4 and 55 % at 8 (the worst leaf a u_bonus; its grad
# norm 98.5 at layer 0 against 0.0056 at layer 7), and tp=2 flux lies
# within that from tp=1: 8.3e-5, 1.05e-3, 3.6e-3 and 39 %; in bf16 flux
# against xla 0.88 % at 1 layer, 31 % at 2 and 234 % at 8; the fused
# kernels' fp32 path at these seams lies within 1.6e-6 of the fp64
# product, as cuBLAS's does (scripts/torch_rwkv_grad_noise.py on an
# NVIDIA H100 80GB HBM3 at 700 W).  The lane reads the 8-layer pairs and,
# beside them, the rounding floor (the perturbed tp=1 step)
RWKV_GATE_LAYERS = 1
RWKV_TRAIN_BATCH, RWKV_TRAIN_SEQ, RWKV_TRAIN_STEPS = 4, 1024, 3
# the wkv's backward on the card: its grads against autograd through the
# step-by-step WKV6 recurrence over (B, S, chunk) at the lane's 40 heads of
# 64, fp32 (TOL); at the tp=1 shape [4, 40, 1024, 64] the memory its
# backward adds: the four [4, 40, 1024, 64] fp32 input grads (168 MB) and
# one chunk's re-run (about 20 of its [4, 40, 64, 64] fp32 tensors, 2.6 MB
# each, and their grads): under RWKV_WKV_MEM_GB
RWKV_WKV_CHECK = (1, 128, 32)
RWKV_WKV_MEM_GB = 0.5
# the train lane: minicpm_2b at full width cut to its first 4 of 40 layers
# (8 until the whole script neared its 1200 s limit), batch
# 4 x 1024 from data/pipeline.py, 3 steps each at tp=1 and tp=4
TRAIN_LAYERS = 4
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 3
TAPE_DEPTHS = (8, 16)   # the seam tape's backward, timed at two depths
CKPT_LAYERS = 2         # train_ckpt: about 0.4 B weights, 4 GB a checkpoint
CKPT_STEPS = 4
# step 0 at tp=4 against tp=1 (bf16 weights and activations; the seams sum
# in another order over TRAIN_LAYERS layers): the loss within relative
# 1e-2, every leaf's grad within relative L2 5e-2 in the canonical layout
# (model.canonical_leaves), the tp=4 grads divided by 4: each rank seeds its
# replicated loss with 1, as in the reference, so a tp=4 grad is 4x the tp=1
# grad; xla and decomposed against flux with the same tolerances
TRAIN_LOSS_RTOL = 1e-2
TRAIN_GRAD_RTOL = 5e-2
# the dp lane's int8 pod all-reduce against the fp32 one on the same grads
# (pods=2): each pod's piece rounds to absmax/127 a 256-element block, at
# most 1/254 of the block's largest element an element; measured 1.09 %
# on the worst canonical leaf (PR 26's runs 5-6), limited at 2 %
POD_INT8_RTOL = 2e-2
# the compressed pods=2 step's weight update against the uncompressed
# one's from the same weights and shards, relative L2 over every leaf of
# pod 0: AdamW's first step moves an element by lr x sign(grad), so the
# elements whose synced grad int8 rounds to zero or across zero differ by
# lr or 2 lr; a wrong or missing exchange differs everywhere (about 1.4)
POD_INT8_UPDATE_RTOL = 0.25
# the tune lane: minicpm_2b at full width, tp=4 on the one card, the train
# lane's 4 x 1024 tokens a seam and 8 decode rows; each candidate of the
# measured sweep is timed over TUNE_ITERS calls after TUNE_WARMUP (CUDA
# events around every rank's calls, launch.op_level.time_tp)
TUNE_TOKENS = TRAIN_BATCH * TRAIN_SEQ
TUNE_DECODE_BATCH = 8
TUNE_ITERS, TUNE_WARMUP = 2, 1
# a seam's winning op against its plain version (fp32 products of the same
# bf16 inputs, the epilogue in fp32): relative L2 of the bf16 output, whose
# elements carry the GEMM's bf16 rounding and up to three of the
# epilogue's (2^-9 each); ring sums add n - 1 bf16 roundings of partials
TUNE_WINNER_RTOL = 1e-2
# the tp>1 server lanes (``serve_lane``) serve every second of their 8
# requests alone against the batch's tokens (all 8 until the whole script
# neared its 1200 s limit: alone, a request takes a host-bound decode step
# a token at tp>1; the three lanes took 76.0 s with 4 alone and 70.3 s
# with 2, on an H100 80GB HBM3 at 700 W)
SERVE_ALONE_STRIDE = 2
# the tp server lane's requests (minicpm_2b, its first TP_SERVER_LAYERS
# layers); the tune lane serves them again from the tuned profile
TP_SERVER_ARGV = ["--arch", "minicpm_2b", "--layers", str(TP_SERVER_LAYERS),
                  "--requests", "8", "--max-batch", "8", "--prompt-len", "40",
                  "--max-new", "16", "--max-seq", "256", "--block-size", "16",
                  "--prefill-chunk", "32"]

# the paper lane: the paper's §5 models at full width, cut in depth only,
# tp=8 on the one card (8 ranks of a RankGroup), seeded random bf16
# weights; prefill at the model-level prefill phase's 8 x 2048 tokens,
# the last rows shorter
PAPER_TP = 8
PAPER_BATCH, PAPER_SEQ = 8, 2048
PAPER_LENGTHS = [2048] * 6 + [1536, 1111]
# (GPT-3's prefill at 4, Llama-2's at 8 and its server at 2 until the
# whole script neared its 1200 s limit)
GPT3_PREFILL_LAYERS = 2     # of 96: 10.3 GB of weights
GPT3_TRAIN_LAYERS = 1
LLAMA_PREFILL_LAYERS = 4    # of 80
LLAMA_TRAIN_LAYERS = 2
LLAMA_SERVE_LAYERS = 1
PAPER_DECODE = 8
PAPER_DECODE_OTHER_MODES = 2
# train step: 2 x 2048 (at 8 x 2048 one GPT-3 layer's fp32 moments and
# attention scores would not fit beside its weights and grads)
PAPER_TRAIN_BATCH = 2
PAPER_TRAIN_STEPS = 3
PAPER_REPEATS = 3
PAPER_TUNE_DECODE_BATCH = 8
PAPER_SERVER_ARGV = (["--arch", "llama2_70b", "--layers",
                      str(LLAMA_SERVE_LAYERS)] + TP_SERVER_ARGV[4:])


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters, warmup=2):
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_ms_cold(torch, fn, iters, warmup=2):
    """Mean device time of one call of ``fn`` with the L2 cache flushed
    before each call (CUDA events around each call): a decode step finds
    its layer's cache cold, after the other layers' weights went through
    L2."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    for _ in range(warmup):
        fn()
    marks = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in marks) / iters


def wall_ms(torch, fn, repeats=REPEATS):
    """Host-clock ms of ``fn`` run to completion on the card, ``repeats``
    warm calls: (median, all samples)."""
    samples = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    return sorted(samples)[len(samples) // 2], samples


def step_and_enqueue_ms(torch, fn, repeats=REPEATS):
    """Where one call of ``fn`` spends its time: host-clock medians over
    ``repeats`` warm calls of (the whole call to completion on the card,
    the host's enqueue alone)."""
    enqueue, whole = [], []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        whole.append((time.perf_counter() - t0) * 1e3)
    return sorted(whole)[repeats // 2], sorted(enqueue)[repeats // 2]


def attention_bound(q, k, v, causal, kv_offset):
    """Least time for the attention's work on an H100: the larger of the
    bytes (q, k, v read once, out written once) over HBM bandwidth and the
    operations on the attended (q, k) pairs of THIS input (QK^T and PV:
    4 * D flops a pair) over the peak rate of the input type."""
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    if causal:
        pairs = sum(max(0, min(skv, kv_offset + i + 1)) for i in range(sq))
    else:
        pairs = sq * skv
    flops = 4.0 * b * hq * d * pairs
    nbytes = 2 * q.nbytes + k.nbytes + v.nbytes
    dtype = str(q.dtype).replace("torch.", "")
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def mla_bound(q_eff, q_rope, c, kr, valid):
    """Least time for the MLA decode attention's work on an H100.  The work
    is the cache rows each batch row needs (those before its valid length;
    all S for a valid length <= 0): 2 * H * (2R + Dr) operations a row over
    the TF32 tensor-core rate (fp32 queries), against the bytes (those
    rows of c and kr, q_eff and q_rope read once, the fp32 output written
    once) over HBM bandwidth.  Also the operations' time on the fp32 CUDA
    cores, which the first kernel computes on."""
    b, h, r = q_eff.shape
    s, dr = c.shape[1], kr.shape[-1]
    rows = sum(s if v <= 0 else min(v, s) for v in valid.tolist())
    flops = 2.0 * h * (2 * r + dr) * rows
    nbytes = (rows * (r + dr) * c.element_size() + q_eff.nbytes
              + q_rope.nbytes + b * h * r * 4)
    t_ops = flops / PEAK_TF32 * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes",
            flops / PEAK_FLOPS["float32"] * 1e3, flops, nbytes)


def gemm_bound(m, k, n, dtype):
    """Least time of an [m, k] x [k, n] GEMM on an H100: the larger of
    2 m n k operations over the peak rate of the input type and the bytes
    (A and B read once, C written once, in the input type) over HBM
    bandwidth."""
    t_ops = 2.0 * m * n * k / PEAK_FLOPS[dtype] * 1e3
    t_bytes = ({"bfloat16": 2, "float32": 4}[dtype] * (m * k + k * n + m * n)
               / PEAK_BYTES * 1e3)
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def gemm_check(torch, out, want, k):
    """The GEMM tolerance (see GEMM_BF16_RTOL): (ok, max abs err, atol,
    rtol)."""
    o, w = out.float(), want.float()
    err = (o - w).abs().max().item()
    if out.dtype == torch.bfloat16:
        atol = GEMM_BF16_ATOL_REL * w.abs().max().item()
        rtol = GEMM_BF16_RTOL
    else:
        atol, rtol = GEMM_F32_TOL * k ** 0.5, GEMM_F32_TOL
    ok = bool(((o - w).abs() <= atol + rtol * w.abs()).all())
    return ok, err, atol, rtol


def ptxas_report(name):
    """Registers, stack and spills of each kernel in ``csrc/<name>.cu``,
    from its build's ``-Xptxas -v`` log: {entry: "..."}."""
    from repro_torch.kernels import build
    log = build.library_path(name).with_suffix(".log")
    out, entry = {}, None
    for ln in log.read_text().splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
            out[entry] = ""
        elif entry and ("spill" in ln or "registers" in ln):
            out[entry] = (out[entry] + "; " + ln.split(": ")[-1].strip()
                          ).strip("; ")
    return out


def sdpa_backend(torch, *args, **kw):
    """The backend ``scaled_dot_product_attention`` picks for these
    inputs."""
    try:
        from torch.nn.attention import SDPBackend
        return SDPBackend(torch._fused_sdp_choice(*args, **kw)).name
    except Exception as e:   # a private API: report, do not fail
        return f"unknown ({type(e).__name__}: {e})"[:120]


def device_profile(torch, fn, sums=None):
    """One call of ``fn`` under torch.profiler: its wall ms (profiled),
    summed device activity ms (kernels, copies, sets; ``device_ms``), the
    ms in which at least one activity ran (the union of their spans,
    ``device_busy_ms``: the ranks' streams run activities at once, which
    the sum counts again for each), the device's busy share (that union
    over the same call's wall time), the number of device activities, the
    five largest kernels by summed time and, for each {key: substring} of
    ``sums``, the summed device ms of the kernels whose name holds the
    substring.  The profiler records the device's activities alone (no
    host op events) and they are read from its raw trace, not as an event
    tree (tens of thousands of activities, a training step's, take
    seconds to turn into events).  A discarded pass over one small kernel
    starts the tracer first; the wall time spans the call inside the
    profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA]
    with profile(activities=activities):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    dev = [(e.name(), e.start_ns() / 1e3,            # name, start, end us
            (e.start_ns() + e.duration_ns()) / 1e3)
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == cuda]
    by_name = {}
    for name, a, b in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    device_ms = sum(by_name.values()) / 1e3
    busy_us, end = 0.0, None
    for a, b in sorted((a, b) for _, a, b in dev):
        if end is None or a > end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    out = {"profiled_wall_ms": wall, "device_ms": device_ms,
           "device_busy_ms": busy_us / 1e3,
           "device_busy_share": busy_us / 1e3 / wall,
           "device_activities": len(dev),
           "top_kernels_ms": [[n[:80], t / 1e3] for n, t in top]}
    for key, sub in (sums or {}).items():
        out[key] = sum(t for n, t in by_name.items() if sub in n) / 1e3
    return out


def device_ms_cold(torch, fn, iters, names=None):
    """Device ms a call of ``fn``, the L2 cache flushed before each call
    (a 128 MB device-to-device copy, left out): the summed time of the
    call's kernels under torch.profiler, without the host's gaps between
    them.  With ``names`` ({key: substring}) also each named kernel's
    share: (ms, {key: ms})."""
    from torch.profiler import ProfilerActivity, profile
    src = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    dst = torch.empty_like(src)
    fn()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            dst.copy_(src)
            fn()
        torch.cuda.synchronize()
    dev = [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and "Memcpy" not in e.name]
    parts = {k: sum(t for n, t in dev if sub in n) / iters
             for k, sub in (names or {}).items()}
    return sum(t for _, t in dev) / iters, parts


def phase_device(torch):
    check(torch.cuda.device_count() == 1,
          f"{torch.cuda.device_count()} cards visible; the smoke run uses "
          "one (set CUDA_VISIBLE_DEVICES to one card)")
    smi = smi_line()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return smi


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as ex:
        futs = {n: ex.submit(build.build, n) for n in KERNEL_SOURCES}
        libs = {n: f.result() for n, f in futs.items()}
    build_s = time.perf_counter() - t0
    ptxas = {}
    for n, path in libs.items():
        log = path.with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        ptxas[n] = [ln.split("ptxas info    : ")[-1].strip()
                    for ln in lines if "registers" in ln or "spill" in ln]
    sass = sass_check(libs)
    emit({"phase": "build", "seconds": build_s,
          "libraries": {n: os.path.relpath(p, ROOT) for n, p in libs.items()},
          "ptxas": ptxas, "sass_hgmma_utmaldg": sass})


def sass_check(libs):
    """The bf16 flash kernel, the MLA-decode kernel and the bf16 GEMM tile
    of matmul, ag_gemm and gemm_rs run on wgmma and TMA: each of their
    kernels' SASS
    (``cuobjdump -sass``) holds HGMMA and UTMALDG instructions.  Returns
    {library: {kernel: [HGMMA count, UTMALDG count]}}."""
    from pathlib import Path
    from repro_torch.kernels import build
    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    wanted = {"flash_attention": "flash_wgmma_kernel",
              "mla_decode": "mla_wgmma_kernel",
              "matmul": "gemm_wgmma_kernel", "ag_gemm": "ag_gemm_wgmma_kernel",
              "gemm_rs": "gemm_rs_wgmma_kernel"}
    # one cuobjdump a library, all started together
    with ThreadPoolExecutor(len(wanted)) as ex:
        texts = {name: ex.submit(
            subprocess.run, [str(tool), "-sass", str(libs[name])],
            capture_output=True, text=True, check=True) for name in wanted}
        texts = {name: f.result().stdout for name, f in texts.items()}
    out = {}
    for name, kernel in wanted.items():
        text = texts[name]
        counts, fn = {}, None
        for ln in text.splitlines():
            if "Function :" in ln:
                fn = ln.split("Function :")[-1].strip()
                fn = fn if kernel in fn else None
                if fn:
                    counts[fn] = [0, 0]
            elif fn:
                counts[fn][0] += "HGMMA" in ln
                counts[fn][1] += "UTMALDG" in ln
        check(counts, f"{name}: no {kernel} in the library's SASS")
        for fn, (hgmma, utmaldg) in counts.items():
            check(hgmma > 0 and utmaldg > 0,
                  f"{name}: {fn} has {hgmma} HGMMA and {utmaldg} UTMALDG "
                  "instructions; the kernel must run on wgmma and TMA")
        out[name] = {fn[-60:]: c for fn, c in counts.items()}
    return out


def phase_kernel(torch):
    """Flash kernel vs its plain version; returns the main-path case."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    cases = [  # name, dtype, B, Hq, Hkv, Sq, Skv, D, causal, kv_offset
        ("minicpm_prefill", torch.bfloat16, 4, 36, 36, 1024, 1024, 64, True, 0),
        # also the jamba lane's tp=1 prefill (32 query heads over 8 KV
        # heads), and its tp=2 one a rank
        ("gqa_d128", torch.bfloat16, 4, 32, 8, 1024, 1024, 128, True, 0),
        ("jamba_tp2_prefill", torch.bfloat16, 4, 16, 4, 1024, 1024, 128,
         True, 0),
        ("tp_lane_prefill", torch.bfloat16, 4, 9, 9, 1024, 1024, 64, True, 0),
        # the paper lane's per-rank shapes at tp=8: GPT-3 175B (MHA) and
        # Llama-2 70B (8 query heads over 1 KV head)
        ("gpt3_tp8_prefill", torch.bfloat16, 8, 12, 12, 2048, 2048, 128,
         True, 0),
        ("llama2_tp8_prefill", torch.bfloat16, 8, 8, 1, 2048, 2048, 128, True,
         0),
        ("kv_offset_suffix", torch.bfloat16, 4, 36, 36, 256, 1024, 64, True,
         768),
        ("noncausal_ragged", torch.bfloat16, 4, 36, 36, 777, 777, 64, False,
         0),
        ("fp32", torch.float32, 2, 36, 36, 512, 512, 64, True, 0),
    ]
    gen = torch.Generator(device="cuda")
    results = {}
    for name, dtype, b, hq, hkv, sq, skv, d, causal, off in cases:
        gen.manual_seed(len(results))
        q = torch.randn((b, hq, sq, d), generator=gen, device="cuda").to(dtype)
        k = torch.randn((b, hkv, skv, d), generator=gen,
                        device="cuda").to(dtype)
        v = torch.randn((b, hkv, skv, d), generator=gen,
                        device="cuda").to(dtype)
        kw = dict(causal=causal, kv_offset=off)
        out = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = fa.flash_attention_ref(q, k, v, **kw)
        err = (out.float() - want.float()).abs().max().item()
        tol = TOL[str(dtype).replace("torch.", "")]
        ok = torch.allclose(out.float(), want.float(), atol=tol, rtol=tol)
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        check(ok, f"{name}: kernel vs plain max_abs_err {err} > tol {tol}")

        if causal and off == 0 and sq == skv:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=True, enable_gqa=hq != hkv)
        else:
            mask = None
            if causal:
                mask = (torch.arange(skv, device="cuda")[None, :]
                        <= off + torch.arange(sq, device="cuda")[:, None])
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=mask, enable_gqa=hq != hkv)
        kernel_ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, **kw),
                            20)
        plain_ms = time_ms(torch, lambda: fa.flash_attention_ref(q, k, v, **kw),
                           5)
        library_ms = time_ms(torch, lib, 20)
        bound_ms, bound_by = attention_bound(q, k, v, causal, off)
        res = {"phase": "kernel", "kernel": "flash_attention", "case": name,
               "dtype": str(dtype).replace("torch.", ""),
               "shape_q": [b, hq, sq, d], "shape_kv": [b, hkv, skv, d],
               "causal": causal, "kv_offset": off, "tol": tol,
               "max_abs_err": err, "kernel_ms": kernel_ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_share": bound_ms / kernel_ms}
        emit(res)
        results[name] = res
        del q, k, v, out, want
    torch.cuda.empty_cache()
    return results["minicpm_prefill"]


def phase_mla_kernel(torch):
    """MLA-decode kernel vs its plain version; returns the lane's case.
    ``kernel_ms``, ``plain_ms`` and ``library_ms`` are CUDA-event times of
    a call, L2 flushed, as PR 15 timed them.  A call of the wrapper spends
    more on the host than on the card, so those hold host gaps; each is
    also reported as device time (``*device_ms``: the call's kernels under
    torch.profiler, L2 flushed), the kernel's split into its two launches
    (``kernel_device_ms``, ``combine_device_ms``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import mla_decode as md
    from repro_torch.models import layers

    r, dr = 512, 64                          # deepseek_v3_671b
    scale = (128 + 64) ** -0.5               # (qk_nope + qk_rope) ** -0.5
    gen = torch.Generator(device="cuda")
    cases = [  # name, B, H, S, valid lengths, paged
        ("mla_lane_decode", 4, 128, 1041, [257, 513, 778, 1025], False),
        ("long_cache", 8, 128, 32768, [1000] + [32768] * 7, False),
        ("ragged_valid_1", 4, 128, 777, [1, 777, 400, 600], False),
        ("paged_view", 4, 128, 66 * 16, [257, 513, 778, 1025], True),
        ("tp8_rank_heads", 4, 16, 1041, [257, 513, 778, 1025], False),
        ("mla_tp4_decode", 4, 32, 1041, [257, 513, 778, 1025], False),
        ("single_row", 4, 128, 1, [1, 0, 1, 5], False),
    ]
    names = {"kernel_device_ms": "mla_wgmma_kernel",
             "combine_device_ms": "mla_combine_kernel"}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results = {}
    for name, b, h, s, valid, paged in cases:
        gen.manual_seed(100 + len(results))

        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        q_eff, q_rope = randn(b, h, r), randn(b, h, dr)
        if paged:   # rows scattered over a shuffled pool, as the Server has
            n_blk, bs = b * (s // 16) + 1, 16
            pool_c = randn(n_blk, bs, r).bfloat16()
            pool_kr = randn(n_blk, bs, dr).bfloat16()
            perm = 1 + torch.randperm(n_blk - 1, generator=gen, device="cuda")
            bt = perm.reshape(b, s // 16)
            c = layers.pool_view(pool_c, bt)
            kr = layers.pool_view(pool_kr, bt)
            del pool_c, pool_kr
        else:
            c, kr = randn(b, s, r).bfloat16(), randn(b, s, dr).bfloat16()
        vl = torch.tensor(valid, device="cuda")
        n_splits, split_rows = md.split_plan(b, h, s, sms)
        combines = md.mla_decode_attention.combine_launches
        out = md.mla_decode_attention(q_eff, q_rope, c, kr, vl, scale=scale)
        torch.cuda.synchronize()
        check(md.mla_decode_attention.combine_launches - combines
              == int(n_splits > 1), f"{name}: combine launches")
        want = md.mla_decode_attention_ref(q_eff, q_rope, c, kr, vl, scale)
        err = (out - want).abs().max().item()
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        check(torch.allclose(out, want, atol=MLA_TOL, rtol=MLA_TOL),
              f"{name}: kernel vs plain max_abs_err {err} > tol {MLA_TOL}")

        # the library call: one SDPA over [q_eff | q_rope] against [c | kr]
        # and c, in fp32 (the kernel's math).  The H heads share one latent
        # row, so they are the query rows of one head: the same function
        # as one kv head under enable_gqa, without the math backend's copy
        # of k and v per query head (77 GB at the long case)
        q_l = torch.cat([q_eff, q_rope], dim=-1)[:, None]
        k_l = torch.cat([c, kr], dim=-1).float()[:, None]
        v_l = c.float()[:, None]
        mask = (torch.arange(s, device="cuda")[None, :]
                < vl[:, None])[:, None, None]
        sdpa_kw = dict(attn_mask=mask, scale=scale)
        lib_out = F.scaled_dot_product_attention(q_l, k_l, v_l, **sdpa_kw)
        lib_err = (lib_out[:, 0] - want).abs().max().item()
        del lib_out

        def kern():
            return md.mla_decode_attention(q_eff, q_rope, c, kr, vl,
                                           scale=scale)

        def plain():
            return md.mla_decode_attention_ref(q_eff, q_rope, c, kr, vl,
                                               scale)

        def lib():
            return F.scaled_dot_product_attention(q_l, k_l, v_l, **sdpa_kw)
        kernel_ms = time_ms_cold(torch, kern, 20)
        kernel_warm_ms = time_ms(torch, kern, 20)
        plain_ms = time_ms_cold(torch, plain, 5)
        library_ms = time_ms_cold(torch, lib, 10)
        call_device_ms, parts = device_ms_cold(torch, kern, 20, names)
        device_ms = parts["kernel_device_ms"] + parts["combine_device_ms"]
        check(parts["kernel_device_ms"] > 0,
              f"{name}: the profiler saw no MLA kernel on the card")
        plain_device_ms, _ = device_ms_cold(torch, plain, 5)
        library_device_ms, _ = device_ms_cold(torch, lib, 10)
        bound_ms, bound_by, cuda_core_ms, flops, nbytes = mla_bound(
            q_eff, q_rope, c, kr, vl)
        res = {"phase": "kernel", "kernel": "mla_decode", "case": name,
               "shape": {"B": b, "H": h, "R": r, "Dr": dr, "S": s},
               "valid_len": valid, "paged": paged, "tol": MLA_TOL,
               "n_splits": n_splits, "split_rows": split_rows,
               "max_abs_err": err, "kernel_ms": kernel_ms,
               "kernel_warm_l2_ms": kernel_warm_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "device_ms": device_ms, **parts,
               "call_device_ms": call_device_ms,
               "plain_device_ms": plain_device_ms,
               "library_device_ms": library_device_ms,
               "library": "scaled_dot_product_attention",
               "library_backend": sdpa_backend(torch, q_l, k_l, v_l,
                                               **sdpa_kw),
               "library_max_abs_err": lib_err,
               "flops": flops, "bytes": nbytes,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "fp32_cuda_core_ms": cuda_core_ms,
               "bound_share": bound_ms / kernel_ms,
               "device_bound_share": bound_ms / device_ms}
        emit(res)
        results[name] = res
        del q_eff, q_rope, c, kr, out, want, q_l, k_l, v_l
    torch.cuda.empty_cache()
    return results["mla_lane_decode"], results["mla_tp4_decode"]


def phase_kernel_lane(torch):
    from repro_torch.configs.base import ParallelConfig, get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as M
    from repro_torch.models import serve as S
    from repro_torch.parallel.sharding import make_ctx

    cfg = dataclasses.replace(get_config("minicpm_2b"),
                              num_layers=LANE_LAYERS)
    par_k = ParallelConfig(kernel_decode=True)
    ctx_k, ctx_p = make_ctx(par_k), make_ctx(ParallelConfig())
    t0 = time.perf_counter()
    params = M.init_model(cfg, par_k, seed=0, dtype=torch.bfloat16,
                          device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())

    lengths = torch.tensor([256, 512, 777, 1024], device="cuda")
    s = int(lengths.max())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, s), generator=gen,
                         device="cuda")
    toks = toks.masked_fill(torch.arange(s, device="cuda")[None]
                            >= lengths[:, None], 0)       # right padding
    batch = {"tokens": toks}

    # plain-attention prefill first: the reference for the comparison
    logits_p, caches_p = S.prefill_logits(params, batch, ctx_p, cfg,
                                          lengths)
    torch.cuda.synchronize()

    # the main path: counts to 0, one prefill through the kernel, counts read
    fa.flash_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    nxt, caches_k = S.prefill_step(params, batch, ctx_k, cfg,
                                   lengths)
    torch.cuda.synchronize()
    launches = fa.flash_attention.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches == cfg.num_layers,
          f"flash kernel launched {launches} times in one prefill, expected "
          f"{cfg.num_layers} (one per layer)")

    # timings and agreement with plain attention (not counted: the main
    # path is done)
    prefill_ms, prefill_samples = wall_ms(torch, lambda: S.prefill_step(
        params, batch, ctx_k, cfg, lengths))
    logits_k, _ = S.prefill_logits(params, batch, ctx_k, cfg,
                                   lengths)
    prefill_prof = device_profile(torch, lambda: S.prefill_logits(
        params, batch, ctx_k, cfg, lengths))
    # layer 0's K/V precede any attention: equal caches show both lanes ran
    # the same weights and tokens; the kernel shows in the checks below
    check(all(torch.equal(caches_k[0][n], caches_p[0][n]) for n in "kv"),
          "layer-0 caches differ between kernel and plain prefill")
    lk = logits_k[:, :cfg.vocab_size].float()
    lp = logits_p[:, :cfg.vocab_size].float()
    check(bool(torch.isfinite(lk).all()), "non-finite logits")
    logit_rel = ((lk - lp).norm() / lp.norm()).item()
    check(logit_rel <= LANE_RTOL,
          f"kernel vs plain prefill logits differ by {logit_rel} (relative "
          f"L2) > {LANE_RTOL}")
    last_rel = max(((caches_k[-1][n].float() - caches_p[-1][n].float()).norm()
                    / caches_p[-1][n].float().norm()).item() for n in "kv")
    check(last_rel <= LANE_RTOL,
          f"kernel vs plain last-layer caches differ by {last_rel} "
          f"(relative L2) > {LANE_RTOL}")
    tok_agree = int((nxt[:, 0] == lp.argmax(-1)).sum())
    lane_logits = lk.cpu()
    del caches_p, logits_p, logits_k

    # dense decode from the kernel prefill's caches: glue them into s_max.
    # Each step is decode_step's two halves, so that its logits are kept
    # for the tp lane's decode (teacher-forced on these tokens)
    n_decode = N_DECODE
    caches = _dense_caches(torch, caches_k, s + n_decode + 1)
    del caches_k
    tok, tokens, step_samples, step_logits = nxt, [nxt], [], []
    for step in range(n_decode):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, caches = S.decode_logits(params, caches, tok, lengths + step,
                                     ctx_k, cfg)
        tok = S.vocab_parallel_argmax(lg, cfg.vocab_size)[:, None]
        torch.cuda.synchronize()
        step_samples.append((time.perf_counter() - t0) * 1e3)
        tokens.append(tok)
        step_logits.append(lg[:, :cfg.vocab_size].float().cpu())
    decode_ms = sorted(step_samples)[n_decode // 2]
    out = torch.cat(tokens, dim=1)
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          "decoded token out of [0, vocab)")

    # where one more decode step's time goes: host enqueue vs device work
    # (the step rewrites the same position each time)
    def one_step():
        return S.decode_step(params, caches, tok, lengths + n_decode,
                             ctx_k, cfg)
    step_ms, enqueue_ms = step_and_enqueue_ms(torch, one_step)
    decode_prof = device_profile(torch, one_step)
    emit({"phase": "kernel_lane", "arch": cfg.name, "params": n_params,
          "init_s": init_s, "batch": 4, "lengths": lengths.tolist(),
          "flash_launches": launches,
          "prefill_ms_median": prefill_ms,
          "prefill_ms_samples": prefill_samples,
          "prefill_peak_mem_gb": peak_gb,
          "logits_rel_l2_kernel_vs_plain": logit_rel,
          "last_layer_cache_rel_l2": last_rel, "rtol": LANE_RTOL,
          "next_token_agree_kernel_vs_plain": f"{tok_agree}/4",
          "prefill_profile": prefill_prof,
          "decode_steps": n_decode, "decode_ms_per_step_median": decode_ms,
          "decode_ms_samples": step_samples,
          "decode_step_ms_median": step_ms,
          "decode_host_enqueue_ms_median": enqueue_ms,
          "decode_profile": decode_prof,
          "tokens_row0": out[0].tolist()})
    del params, caches
    torch.cuda.empty_cache()
    decode = {"tokens": [t.cpu() for t in tokens], "logits": step_logits}
    return launches, lane_logits, decode


def phase_server_lane(torch):
    """A smoke check of the paged runtime at full width: 8 short requests,
    so its latencies are not those of a serving workload."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as launch_serve
    from repro_torch.runtime.server import Request, Server

    argv = ["--arch", "minicpm_2b", "--layers", str(LANE_LAYERS),
            "--requests", "8", "--max-batch", "8", "--prompt-len", "40",
            "--max-new", "16", "--max-seq", "256", "--block-size", "16",
            "--prefill-chunk", "32"]
    # this path's counts: the paged runtime attends in plain code (as the
    # reference's Server does), so no kernel of this slice runs here
    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    server, done = launch_serve.main(argv)
    wall_s = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    check(launches == 0, f"flash kernel launched {launches} times in the "
          "server lane, which runs no kernel")
    cfg = server.cfg
    check(len(done) == 8, f"{len(done)} of 8 requests finished")
    for r in done:
        check(r.done and r.error is None, f"request {r.rid}: {r.error}")
        check(len(r.output) == 16, f"request {r.rid}: {len(r.output)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.output),
              f"request {r.rid}: token out of [0, vocab)")
    ttfts = sorted(r.ttft_s() for r in done)
    tpots = sorted(r.per_token_s() for r in done)
    t_first = min(r.t_arrival for r in done)
    t_last = max(r.t_finish for r in done)
    n_tok = sum(len(r.output) for r in done)

    concurrent = {r.rid: r.output for r in done}
    agree = 0
    for r in sorted(done, key=lambda x: x.rid):
        alone = Server(cfg, server.par, server.params, server.sc)
        out = alone.serve([Request(rid=r.rid, prompt=r.prompt)])[0].output
        agree += int(out == concurrent[r.rid])
    emit({"phase": "server_lane", "scale": "smoke", "arch": cfg.name,
          "requests": len(done), "flash_launches": launches,
          "max_batch": server.sc.max_batch,
          "block_size": server.sc.block_size,
          "prefill_chunk": server.sc.prefill_chunk,
          "prompt_lens": [len(r.prompt) for r in done],
          "ttft_p50_ms": ttfts[len(ttfts) // 2] * 1e3,
          "tpot_p50_ms": tpots[len(tpots) // 2] * 1e3,
          "tokens_per_s": n_tok / (t_last - t_first),
          "serve_wall_s": wall_s,
          "pool_peak_blocks": server.pool.peak_blocks_in_use,
          "pool_blocks": server.pool.num_blocks - 1,
          "prefill_calls": server.prefill_dispatches,
          "decode_calls": server.decode_dispatches,
          "concurrent_equals_isolated": f"{agree}/{len(done)}"})


# the recurrent layers' cache leaves (no sequence dim): a Mamba layer's,
# an RWKV layer's time-mix and channel-mix state (``models.serve``)
STATE_LEAVES = ("conv", "ssm", "state", "last", "ffn.last")


def _dense_caches(torch, caches, s_max):
    """Prefill caches [B, S, ...] glued into zero [B, s_max, ...] decode
    caches; a recurrent layer's state (``STATE_LEAVES``: no sequence dim)
    as it is."""
    out = []
    for layer in caches:
        dense = {}
        for n, t in layer.items():
            if n in STATE_LEAVES:
                dense[n] = t
                continue
            d = torch.zeros((t.shape[0], s_max, *t.shape[2:]), dtype=t.dtype,
                            device=t.device)
            d[:, :t.shape[1]] = t
            dense[n] = d
        out.append(dense)
    return out


def _paged_caches(torch, caches, gen, block):
    """Dense [B, S, ...] caches scattered into shuffled [N, block, ...]
    pools: (pools, block tables [B, ceil(S / block)]); block 0 stays the
    null block."""
    b, s = caches[0]["c"].shape[:2]
    pages = -(-s // block)
    bt = (1 + torch.randperm(b * pages, generator=gen, device="cuda")
          ).reshape(b, pages)
    pools = []
    for layer in caches:
        pool = {}
        for n, t in layer.items():
            p = torch.zeros((b * pages + 1, block, *t.shape[2:]),
                            dtype=t.dtype, device=t.device)
            rows = torch.zeros((b, pages * block, *t.shape[2:]),
                               dtype=t.dtype, device=t.device)
            rows[:, :s] = t
            p[bt.reshape(-1)] = rows.reshape(b * pages, block, *t.shape[2:])
            pool[n] = p
        pools.append(pool)
    return pools, bt


def phase_mla_lane(torch):
    """deepseek_v3_671b's first four layers at full width: prefill, then
    the main path — 16 dense decode steps through the MLA-decode kernel —
    teacher-forced against plain attention, and one paged step.  Returns
    (params, cfg, main-path launches) for the server lane."""
    from repro_torch.configs.base import ParallelConfig, get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mla_decode as md
    from repro_torch.models import model as M
    from repro_torch.models import serve as S
    from repro_torch.parallel.sharding import make_ctx

    # the model's own first layers: 3 leading MLA + dense FFN, 1 MLA + MoE
    cfg = dataclasses.replace(get_config("deepseek_v3_671b"), num_layers=4)
    par_k = ParallelConfig(kernel_decode=True)
    ctx_k, ctx_p = make_ctx(par_k), make_ctx(ParallelConfig())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_model(cfg, par_k, seed=0, dtype=torch.bfloat16,
                          device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    weights_gb = torch.cuda.memory_allocated() / 1e9

    lengths = torch.tensor([256, 512, 777, 1024], device="cuda")
    s = int(lengths.max())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (4, s), generator=gen,
                         device="cuda")
    toks = toks.masked_fill(torch.arange(s, device="cuda")[None]
                            >= lengths[:, None], 0)       # right padding
    batch = {"tokens": toks}

    # prefill: MLA attends in plain code here, as in the reference
    logits, caches = S.prefill_logits(params, batch, ctx_k, cfg, lengths)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()),
          "non-finite prefill logits")
    m = cfg.mla
    check(all(tuple(c["c"].shape) == (4, s, m.kv_lora_rank)
              and tuple(c["kr"].shape) == (4, s, m.qk_rope_head_dim)
              for c in caches), "latent cache shapes")
    nxt, _ = S.prefill_step(params, batch, ctx_k, cfg, lengths)
    check(torch.equal(nxt[:, 0], S.vocab_parallel_argmax(
        logits, cfg.vocab_size)), "prefill_step vs prefill_logits tokens")
    prefill_ms, prefill_samples = wall_ms(torch, lambda: S.prefill_step(
        params, batch, ctx_k, cfg, lengths))
    del logits

    n_decode = 16
    s_max = s + n_decode + 1
    caches_p = _dense_caches(torch, caches, s_max)
    caches_k = _dense_caches(torch, caches, s_max)
    del caches

    # plain attention first: its tokens feed both lanes (teacher forcing)
    plain_tokens = [nxt]
    tok = nxt
    for step in range(n_decode):
        tok, caches_p = S.decode_step(params, caches_p, tok, lengths + step,
                                      ctx_p, cfg)
        plain_tokens.append(tok)
    torch.cuda.synchronize()

    # the main path: counts to 0, 16 decode steps through the kernel, read
    md.mla_decode_attention.launches = 0
    md.mla_decode_attention.combine_launches = 0
    fa.flash_attention.launches = 0
    step_samples, agree = [], 0
    for step in range(n_decode):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        k_tok, caches_k = S.decode_step(params, caches_k, plain_tokens[step],
                                        lengths + step, ctx_k, cfg)
        torch.cuda.synchronize()
        step_samples.append((time.perf_counter() - t0) * 1e3)
        agree += int((k_tok == plain_tokens[step + 1]).sum())
    launches = md.mla_decode_attention.launches
    combine_launches = md.mla_decode_attention.combine_launches
    check(launches == cfg.num_layers * n_decode,
          f"MLA-decode kernel launched {launches} times in {n_decode} decode "
          f"steps, expected {cfg.num_layers * n_decode} (one per layer a "
          "step)")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    want_combines = launches * int(
        md.split_plan(4, cfg.num_heads, s_max, sms)[0] > 1)
    check(combine_launches == want_combines,
          f"MLA combine launched {combine_launches} times, expected "
          f"{want_combines} (one per kernel launch that splits S)")
    check(fa.flash_attention.launches == 0,
          "the flash kernel ran on the MLA decode path")
    check(all(torch.equal(caches_k[0][n], caches_p[0][n]) for n in
              ("c", "kr")),
          "layer-0 latent caches differ between kernel and plain decode")
    last_rel = max(((caches_k[-1][n].float() - caches_p[-1][n].float()).norm()
                    / caches_p[-1][n].float().norm()).item()
                   for n in ("c", "kr"))
    check(last_rel <= MLA_LANE_RTOL,
          f"kernel vs plain last-layer latent caches differ by {last_rel} "
          f"(relative L2) > {MLA_LANE_RTOL}")
    decode_ms = sorted(step_samples)[n_decode // 2]
    del caches_p

    # one paged step through block tables against the same dense step
    pos = lengths + n_decode
    pools, bt = _paged_caches(torch, caches_k, gen, 16)
    md.mla_decode_attention.launches = 0
    paged_tok, _ = S.decode_step(params, pools, plain_tokens[-1], pos, ctx_k,
                                 cfg, block_tables=bt)
    torch.cuda.synchronize()
    paged_launches = md.mla_decode_attention.launches
    check(paged_launches == cfg.num_layers,
          f"paged step launched the MLA-decode kernel {paged_launches} "
          f"times, expected {cfg.num_layers}")
    dense_tok, _ = S.decode_step(params, [{n: t.clone() for n, t in
                                           layer.items()}
                                          for layer in caches_k],
                                 plain_tokens[-1], pos, ctx_k, cfg)
    check(torch.equal(paged_tok, dense_tok),
          f"paged next tokens {paged_tok.tolist()} != dense "
          f"{dense_tok.tolist()}")
    del pools

    # where one more decode step's time goes: host enqueue vs device work
    # (the step rewrites the same position each time)
    def one_step():
        return S.decode_step(params, caches_k, plain_tokens[-1], pos, ctx_k,
                             cfg)
    step_ms, enqueue_ms = step_and_enqueue_ms(torch, one_step)
    decode_prof = device_profile(torch, one_step,
                                 {"mla_kernel_ms": "mla_wgmma_kernel",
                                  "mla_combine_ms": "mla_combine_kernel"})
    out = torch.cat(plain_tokens, dim=1)
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          "decoded token out of [0, vocab)")
    tp1 = mla_tp1_reference(torch, params, cfg, batch, lengths)
    emit({"phase": "mla_lane", "arch": cfg.name, "layers": cfg.num_layers,
          "params": n_params, "weights_gb": weights_gb, "init_s": init_s,
          "batch": 4, "lengths": lengths.tolist(), "s_max": s_max,
          "prefill_ms_median": prefill_ms,
          "prefill_ms_samples": prefill_samples,
          "decode_steps": n_decode, "mla_launches": launches,
          "mla_combine_launches": combine_launches,
          "mla_launches_per_step": launches / n_decode,
          "paged_step_mla_launches": paged_launches,
          "paged_tokens_equal_dense": True,
          "last_layer_latent_cache_rel_l2": last_rel,
          "rtol": MLA_LANE_RTOL,
          "next_token_agree_kernel_vs_plain": f"{agree}/{4 * n_decode}",
          "decode_ms_per_step_median": decode_ms,
          "decode_ms_samples": step_samples,
          "decode_step_ms_median": step_ms,
          "decode_host_enqueue_ms_median": enqueue_ms,
          "decode_profile": decode_prof,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "tokens_row0": out[0].tolist(),
          "tp1_reference_drop_free_cf": MLA_DROP_FREE_CF,
          "tp1_reference_tokens_row0": torch.cat(tp1["tokens"],
                                                 dim=1)[0].tolist()})
    del caches_k
    torch.cuda.empty_cache()
    return params, cfg, (launches, combine_launches), tp1


def drop_free(cfg):
    """``cfg`` with the MoE capacity factor at which no assignment drops."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=MLA_DROP_FREE_CF))


def mla_tp1_reference(torch, params, cfg, batch, lengths, n_decode=N_DECODE):
    """The mla tp lane's tp=1 references, on the mla lane's model before it
    is freed, drop-free: the prefill's last-position logits and n_decode
    greedy decode steps through the MLA-decode kernel (each step's logits,
    and the tokens, on which the tp lane is teacher-forced), on the host.
    No MoE assignment may drop."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.models import ffn
    from repro_torch.models import serve as S
    from repro_torch.parallel.sharding import make_ctx

    cfg_df = drop_free(cfg)
    ctx = make_ctx(ParallelConfig(kernel_decode=True))
    ffn.dropped.clear()
    logits, caches = S.prefill_logits(params, batch, ctx, cfg_df, lengths)
    check(ffn.drop_totals() == [0], f"the tp=1 drop-free prefill dropped "
          f"{ffn.drop_totals()} MoE assignments")
    caches = _dense_caches(torch, caches, int(lengths.max()) + n_decode + 1)
    tok = S.vocab_parallel_argmax(logits, cfg.vocab_size)[:, None]
    out = {"prefill_logits": logits[:, :cfg.vocab_size].float().cpu(),
           "tokens": [tok.cpu()], "decode_logits": []}
    del logits
    for step in range(n_decode):
        lg, caches = S.decode_logits(params, caches, tok, lengths + step, ctx,
                                     cfg_df)
        tok = S.vocab_parallel_argmax(lg, cfg.vocab_size)[:, None]
        out["decode_logits"].append(lg[:, :cfg.vocab_size].float().cpu())
        out["tokens"].append(tok.cpu())
    check(ffn.drop_totals() == [0], f"the tp=1 decode dropped "
          f"{ffn.drop_totals()} MoE assignments")
    del caches
    torch.cuda.empty_cache()
    return out


def phase_mla_server_lane(torch, params, cfg):
    """The paged Server over the mla lane's four layers: 8 short requests
    served together and one at a time, then again on the same server,
    whose freed prompt blocks stay matchable (prefix reuse).  A smoke check
    of the runtime; the Server runs no kernel, as the reference's does
    not."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mla_decode as md
    from repro_torch.launch.serve import make_requests
    from repro_torch.runtime.server import Request, ServeConfig, Server

    par = ParallelConfig()
    sc = ServeConfig(max_batch=8, max_seq=256, eos_token=-1,
                     max_new_tokens=16, block_size=16, prefill_chunk=32)
    reqs = make_requests(cfg.vocab_size, 8, 40)
    md.mla_decode_attention.launches = 0
    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    server = Server(cfg, par, params, sc)
    done = server.serve(reqs)
    wall_s = time.perf_counter() - t0
    launches = (md.mla_decode_attention.launches
                + fa.flash_attention.launches)
    check(launches == 0, f"{launches} kernel launches in the MLA server "
          "lane, which runs no kernel")
    check(len(done) == 8, f"{len(done)} of 8 requests finished")
    for r in done:
        check(r.done and r.error is None, f"request {r.rid}: {r.error}")
        check(len(r.output) == 16, f"request {r.rid}: {len(r.output)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.output),
              f"request {r.rid}: token out of [0, vocab)")
    concurrent = {r.rid: r.output for r in done}
    ttfts = sorted(r.ttft_s() for r in done)
    tpots = sorted(r.per_token_s() for r in done)
    n_tok = sum(len(r.output) for r in done)
    span = max(r.t_finish for r in done) - min(r.t_arrival for r in done)
    first_hits = server.pool.reuse_hits

    again = server.serve([Request(rid=r.rid, prompt=r.prompt) for r in reqs])
    check(all(r.output == concurrent[r.rid] for r in again),
          "serving the same prompts again (prefix reuse) changed tokens")
    agree = 0
    for r in reqs:
        alone = Server(cfg, par, params, sc)
        out = alone.serve([Request(rid=r.rid, prompt=r.prompt)])[0].output
        agree += int(out == concurrent[r.rid])
    check(agree == len(reqs),
          f"concurrent serving equals isolated serving for {agree}/8")
    emit({"phase": "mla_server_lane", "scale": "smoke", "arch": cfg.name,
          "layers": cfg.num_layers, "requests": len(done),
          "kernel_launches": launches, "max_batch": sc.max_batch,
          "block_size": sc.block_size, "prefill_chunk": sc.prefill_chunk,
          "prompt_lens": [len(r.prompt) for r in done],
          "ttft_p50_ms": ttfts[len(ttfts) // 2] * 1e3,
          "tpot_p50_ms": tpots[len(tpots) // 2] * 1e3,
          "tokens_per_s": n_tok / span, "serve_wall_s": wall_s,
          "pool_peak_blocks": server.pool.peak_blocks_in_use,
          "pool_blocks": server.pool.num_blocks - 1,
          "prefix_reuse_hits_first_pass": first_hits,
          "prefix_reuse_hits_second_pass": server.pool.reuse_hits - first_hits,
          "reused_tokens": server.pool.reused_tokens,
          "second_pass_equals_first": True,
          "concurrent_equals_isolated": f"{agree}/{len(reqs)}"})


def mla_prefill_launches(plans, cfg, tp, mlp_weights=1):
    """The fused kernels one MLA prefill launches at ``tp``, read off a
    ``PlanSet``: a rank's flux seam in the sequence-sharded layout, each
    layer, launches two AG-GEMMs on attn_ag (the q and kv up-projections,
    distinct inputs), one GEMM-RS and its reduce on attn_rs, one AG-GEMM
    on mlp_ag (the dense FFN's or the shared expert's; one a weight when
    the gather is not shared) and one GEMM-RS on mlp_rs; the moe_a2a seam
    and the head launch none.  Every rank's, summed."""
    from repro_torch.models import model as M
    c = {"ag_gemm": 0, "gemm_rs": 0}
    if plans.residual_layout() == "seq":
        for j in range(cfg.num_layers):
            slot = M.layer_slot(cfg, j)
            for seam in ("attn_ag", "attn_rs", "mlp_ag", "mlp_rs"):
                p = plans.resolve(seam, slot)
                if p.mode != "flux":
                    continue
                if seam == "attn_ag":
                    c["ag_gemm"] += 2
                elif seam == "mlp_ag":
                    c["ag_gemm"] += 1 if p.shared_gather else mlp_weights
                else:
                    c["gemm_rs"] += 1
    c = {k: v * tp for k, v in c.items()}
    c.update(gemm_rs_reduce=c["gemm_rs"], flash_attention=0, matmul=0)
    return c


def a2a_op_ms(torch, group, ranks, cap, calls=10):
    """The MoE layer's ``moe_a2a`` op alone at the lane's shape (x [tp,
    E/tp, cap, D] bf16 a rank, the rank's 64 experts), ``xla`` (two
    barrier exchanges) and ``flux`` (the shift ring): host ms a call
    (``calls`` calls inside one ``spmd``), and one profiled call's device
    ms and busy share."""
    from repro_torch.core.overlap import Epilogue, FusedOp
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    tp = group.n
    args = []
    for rank in ranks:
        f = rank.layers[-1].ffn
        x = torch.randn((tp, f["w1"].shape[0], cap, f["w1"].shape[1]),
                        generator=gen, device="cuda").bfloat16()
        args.append((x, f["w1"], f["w3"], f["w2"]))
    out = {"shape_a_rank": list(args[0][0].shape)}
    for mode in ("xla", "flux"):
        op = FusedOp("a2a", Epilogue(activation="silu", gate="pair"), 3,
                     axis=group, mode=mode)

        def run(n=calls):
            group.spmd(lambda x, *ws: [op(x, *ws) for _ in range(n)], args)
        med, _ = wall_ms(torch, run, repeats=3)
        prof = device_profile(torch, lambda: run(1))
        out[mode] = {"host_ms": med / calls,
                     "device_ms": prof["device_ms"],
                     "device_busy_share": prof["device_busy_share"],
                     "profiled_wall_ms": prof["profiled_wall_ms"]}
    del args
    return out


def phase_mla_tp_lane(torch, tp1):
    """deepseek_v3_671b's first four layers at full width, tp=4 on the one
    card (the module docstring's mla_tp_lane): the same canonical weights
    as the mla lane's, packed for tp=4 (w1|w3 packed) and cut per rank, the
    mla lane's batch.  Returns the main paths' launches: the flux
    prefill's fused kernels and the decode's MLA-decode kernel."""
    from repro_torch.configs.base import ParallelConfig, get_config
    from repro_torch.dist import RankGroup
    from repro_torch.kernels import mla_decode as md
    from repro_torch.models import ffn
    from repro_torch.models import model as M
    from repro_torch.models import serve as S
    from repro_torch.parallel.sharding import make_ctx, pad_heads

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("deepseek_v3_671b"), num_layers=4)
    cfg_df = drop_free(cfg)
    tp = MLA_TP
    group = RankGroup(tp, "cuda", timeout_s=120)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    full = M.init_model(cfg, ParallelConfig(tp=tp, fuse_w13=True), seed=0,
                        dtype=torch.bfloat16, device="cuda")
    ranks = [M.shard_params(full, r, tp, cfg) for r in range(tp)]
    del full
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()

    lengths = torch.tensor(MLA_TP_LENGTHS, device="cuda")
    s = int(lengths.max())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)                    # the mla lane's tokens
    toks = torch.randint(0, cfg.vocab_size, (4, s), generator=gen,
                         device="cuda")
    toks = toks.masked_fill(torch.arange(s, device="cuda")[None]
                            >= lengths[:, None], 0)
    batch = {"tokens": toks}
    ctxs = {mode: make_ctx(ParallelConfig(tp=tp, kernel_decode=True,
                                          overlap_mode=mode), group)
            for mode in ("flux", "xla", "decomposed")}
    args = [(p,) for p in ranks]
    vocab = cfg.vocab_size

    def prefill(mode, c=cfg, fn=S.prefill_logits):
        ctx = ctxs[mode]
        return group.spmd(lambda p: fn(p, batch, ctx, c, lengths), args)

    def logits_of(outs):
        return torch.cat([o[0] for o in outs], dim=-1)[:, :vocab].float()

    def counts_now():
        c = read_counts()
        c["mla_decode"] = md.mla_decode_attention.launches
        return c

    def zero_all():
        zero_counts()
        md.mla_decode_attention.launches = 0
        md.mla_decode_attention.combine_launches = 0

    # the main path: counts to 0, one flux prefill_step, counts read
    zero_all()
    outs = prefill("flux", fn=S.prefill_step)
    torch.cuda.synchronize()
    counts = counts_now()
    want = mla_prefill_launches(ctxs["flux"].plans, cfg, tp)
    want["mla_decode"] = 0
    check(counts == want, f"mla tp flux prefill launches {counts}, its "
          f"PlanSet implies {want}")
    nxt = outs[0][0]
    check(all(torch.equal(o[0], nxt) for o in outs),
          "mla tp prefill: the ranks' next tokens differ")
    del outs
    res = {"phase": "mla_tp_lane", "arch": cfg.name, "tp": tp,
           "layers": cfg.num_layers, "init_s": init_s,
           "init_peak_gb": init_peak_gb,
           "weights_gb_all_ranks": sum(
               p.numel() * p.element_size() for r in ranks
               for p in r.parameters()) / 1e9,
           "experts_a_rank": ranks[0].layers[-1].ffn["w1"].shape[0],
           "batch": 4, "lengths": lengths.tolist(),
           "capacity_factor": cfg.moe.capacity_factor,
           "flux_launches": counts, "flux_launches_planset": want,
           "next_tokens": nxt[:, 0].tolist(), "rtol": TP_LANE_RTOL}
    logits, drops = {}, {}
    for mode in ("flux", "xla", "decomposed"):
        zero_all()
        ffn.dropped.clear()
        logits[mode] = logits_of(prefill(mode))
        torch.cuda.synchronize()
        drops[mode] = ffn.drop_totals(tp)
        c = counts_now()
        if mode != "flux":
            check(c["ag_gemm"] == 0 and c["gemm_rs"] == 0,
                  f"{mode} prefill launched the fused kernels: {c}")
        check(bool(torch.isfinite(logits[mode]).all()),
              f"non-finite mla tp {mode} logits")
    res["dropped_assignments_per_rank"] = drops
    for a, b in (("flux", "xla"), ("flux", "decomposed"),
                 ("xla", "decomposed")):
        rel = _rel_l2(logits[a], logits[b])
        res[f"logits_rel_l2_{a}_vs_{b}"] = rel
        check(rel <= TP_LANE_RTOL, f"mla tp prefill {a} vs {b} logits "
              f"differ by {rel} (relative L2) > {TP_LANE_RTOL}")
    for mode in ("flux", "xla", "decomposed"):
        med, samples = wall_ms(torch, lambda: prefill(mode), repeats=3)
        res[f"prefill_ms_median_{mode}"] = med
        res[f"prefill_ms_samples_{mode}"] = samples
    res["prefill_profile_flux"] = device_profile(torch,
                                                 lambda: prefill("flux"))
    del logits

    # drop-free: the flux prefill against tp=1's; its caches feed decode
    ffn.dropped.clear()
    outs = prefill("flux", c=cfg_df)
    lf = logits_of(outs)
    d = ffn.drop_totals(tp)
    check(d == [0] * tp, f"the drop-free tp prefill dropped {d} "
          "assignments")
    rel_tp1 = _rel_l2(lf, tp1["prefill_logits"].to("cuda"))
    res["drop_free"] = {"capacity_factor": MLA_DROP_FREE_CF,
                        "dropped_assignments_per_rank": d,
                        "logits_rel_l2_vs_tp1": rel_tp1,
                        "next_tokens": lf.argmax(-1).tolist(),
                        "next_tokens_tp1": tp1["tokens"][0][:, 0].tolist()}
    check(rel_tp1 <= TP_LANE_RTOL, f"mla tp drop-free prefill logits vs "
          f"tp=1 differ by {rel_tp1} (relative L2) > {TP_LANE_RTOL}")
    s_max = s + N_DECODE + 1
    caches = [_dense_caches(torch, o[1], s_max) for o in outs]
    del outs, lf
    res["prefill_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["a2a_op"] = a2a_op_ms(torch, group, ranks,
                              ffn._capacity(4 * s // tp, cfg.moe))

    # the decode: N_DECODE dense steps through the MLA-decode kernel at
    # H / tp heads a rank, teacher-forced on tp=1's tokens
    ctx = ctxs["flux"]
    tokens = [t.to("cuda") for t in tp1["tokens"]]

    def one(step, cs, tables=None):
        def body(p, c):
            lg, _ = S.decode_logits(p, c, tokens[step], lengths + step, ctx,
                                    cfg_df, block_tables=tables)
            return S.vocab_parallel_argmax(lg, vocab, ctx), lg
        outs = group.spmd(body, list(zip(ranks, cs)))
        return (torch.stack([o[0] for o in outs]),
                torch.cat([o[1] for o in outs], dim=-1)[:, :vocab].float())

    zero_all()
    samples, rels, agree, flips = [], [], 0, {}
    for step in range(N_DECODE):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks_r, lg = one(step, caches)
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
        check(bool((toks_r == toks_r[0]).all()),
              f"mla tp decode step {step}: the ranks' tokens differ")
        want_lg = tp1["decode_logits"][step].to("cuda")
        rels.append(_rel_l2(lg, want_lg))
        check(rels[-1] <= TP_LANE_RTOL, f"mla tp decode step {step} logits "
              f"vs tp=1 differ by {rels[-1]} (relative L2) > {TP_LANE_RTOL}")
        for b, (got, ref) in enumerate(zip(toks_r[0].tolist(),
                                           tokens[step + 1][:, 0].tolist())):
            if got == ref:
                agree += 1
                continue
            top2 = torch.topk(want_lg[b], 2).values
            flips[f"{step}/{b}"] = {
                "tp1": ref, "tp": got, "margin": (top2[0] - top2[1]).item(),
                "max_abs_diff": (lg[b] - want_lg[b]).abs().max().item()}
    c = counts_now()
    launches = c["mla_decode"]
    combines = md.mla_decode_attention.combine_launches
    check(launches == cfg.num_layers * tp * N_DECODE,
          f"mla tp decode launched the MLA-decode kernel {launches} times, "
          f"expected {cfg.num_layers * tp * N_DECODE} (a layer a rank a step)")
    hl = pad_heads(cfg.num_heads, tp) // tp
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_splits = md.split_plan(4, hl, s_max, sms)[0]
    check(combines == launches * int(n_splits > 1),
          f"MLA combine launched {combines} times, expected "
          f"{launches * int(n_splits > 1)}")
    check(c["ag_gemm"] == 0 and c["gemm_rs"] == 0,
          f"the replicated-layout decode launched fused kernels: {c}")
    wide = [k for k, f in flips.items() if f["margin"] > 2 * f["max_abs_diff"]]
    check(not wide, f"mla tp decode tokens differ from tp=1's at {wide}, "
          "where tp=1's top-2 margin exceeds twice the logits' largest "
          "difference")
    warm = sorted(samples[1:])
    res.update({"decode_steps": N_DECODE, "mla_launches": launches,
                "mla_combine_launches": combines,
                "mla_heads_a_rank": hl, "mla_splits": n_splits,
                "decode_logits_rel_l2_vs_tp1": rels,
                "decode_tokens_agree_tp1": f"{agree}/{4 * N_DECODE}",
                "decode_token_flips": flips,
                "decode_ms_per_step_median": warm[len(warm) // 2],
                "decode_ms_samples": samples})

    # one paged step through block tables against the same dense step
    pos_step = N_DECODE
    pools, bts = [], []
    for cs in caches:
        gp = torch.Generator(device="cuda")
        gp.manual_seed(3)                   # one block table for every rank
        pl, bt = _paged_caches(torch, cs, gp, 16)
        pools.append(pl)
        bts.append(bt)
    check(all(torch.equal(bt, bts[0]) for bt in bts), "block tables differ")
    md.mla_decode_attention.launches = 0
    paged_tok, _ = one(pos_step, pools, bts[0])
    paged_launches = md.mla_decode_attention.launches
    check(paged_launches == cfg.num_layers * tp,
          f"paged step launched the MLA-decode kernel {paged_launches} "
          f"times, expected {cfg.num_layers * tp}")
    dense_tok, _ = one(pos_step, [[{n: t.clone() for n, t in layer.items()}
                                   for layer in cs] for cs in caches])
    check(torch.equal(paged_tok, dense_tok), f"mla tp paged next tokens "
          f"{paged_tok[0].tolist()} != dense {dense_tok[0].tolist()}")
    del pools
    res["paged_step_mla_launches"] = paged_launches
    res["paged_tokens_equal_dense"] = True
    res["decode_profile_flux"] = device_profile(
        torch, lambda: one(0, caches),
        {"mla_kernel_ms": "mla_wgmma_kernel",
         "mla_combine_ms": "mla_combine_kernel"})
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    del ranks, args, caches
    group.free_symmetric()
    torch.cuda.empty_cache()
    return {"prefill": counts, "decode_mla": launches,
            "decode_combines": combines}


def phase_mla_tp_server_lane(torch):
    """The paged Server at tp=4 in flux on the one card over
    deepseek_v3_671b's first four layers at full width, through
    ``launch.serve``'s path (``serve_lane``, the near-tie rule for first
    tokens: bf16 logits of random weights are nearly flat)."""
    return serve_lane(torch, "mla_tp_server_lane", MLA_TP_SERVER_ARGV,
                      MLA_TP, ties_ok=True)


def phase_matmul_kernel(torch):
    """GEMM kernel vs its plain version; returns the main-path case (the
    AG seam's per-rank GEMM at m 8192)."""
    from repro_torch.kernels import matmul as mm

    cases = [  # name, dtype, M, K, N
        ("ag_m8192", torch.bfloat16, 8192, 12288, 6144),
        ("rs_m8192", torch.bfloat16, 8192, 6144, 12288),
        ("ag_m64", torch.bfloat16, 64, 12288, 6144),
        ("ragged", torch.bfloat16, 777, 1000, 1032),
        ("fp32_1024", torch.float32, 1024, 1024, 1024),
    ]
    gen = torch.Generator(device="cuda")
    ptxas = ptxas_report("matmul")
    results = {}
    for name, dtype, m, k, n in cases:
        gen.manual_seed(200 + len(results))
        a = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
        b = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
        out = mm.matmul(a, b)
        torch.cuda.synchronize()
        want = mm.matmul_ref(a, b)
        ok, err, atol, rtol = gemm_check(torch, out, want, k)
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        check(ok, f"{name}: kernel vs plain max_abs_err {err} beyond atol "
              f"{atol} + rtol {rtol} * |C|")
        dt = str(dtype).replace("torch.", "")
        block = mm.plan_blocks(m, n) if dtype == torch.bfloat16 else None
        kernel_ms = time_ms(torch, lambda: mm.matmul(a, b), 20)
        plain_ms = time_ms(torch, lambda: mm.matmul_ref(a, b), 3)
        library_ms = time_ms(torch, lambda: torch.matmul(a, b), 20)
        bound_ms, bound_by = gemm_bound(m, k, n, dt)
        nbytes = a.nbytes + b.nbytes + out.nbytes
        res = {"phase": "matmul_kernel", "kernel": "matmul", "case": name,
               "dtype": dt, "shape_mkn": [m, k, n], "block": block,
               "atol": atol, "rtol": rtol, "max_abs_err": err,
               "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "library": "torch.matmul (cuBLAS)",
               "timing": "mean of 20 warm calls (CUDA events); L2 "
                         + ("cannot hold the operands" if nbytes > L2_BYTES
                            else "warm: the operands fit"),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_share": bound_ms / kernel_ms,
               "tflops": 2.0 * m * n * k / kernel_ms / 1e9,
               "library_tflops": 2.0 * m * n * k / library_ms / 1e9}
        emit(res)
        results[name] = res
        del a, b, out, want
    emit({"phase": "matmul_kernel", "ptxas": ptxas})
    torch.cuda.empty_cache()
    return results["ag_m8192"]


def phase_op_level_lane(torch):
    """The main path of the GEMM kernel: ``launch.op_level``'s full sweep
    on the card, counts set to 0 just before and read just after; then
    each row's GEMM against the plain version once (not counted)."""
    import contextlib
    import io
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import mla_decode as md
    from repro_torch.launch import op_level

    fa.flash_attention.launches = 0
    md.mla_decode_attention.launches = 0
    mm.matmul.launches = 0
    csv = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(csv):
        rows = op_level.main(tp=1)
    wall_s = time.perf_counter() - t0
    launches = mm.matmul.launches
    want_launches = sum(r["calls"] for r in rows)
    check(launches == want_launches,
          f"op_level launched the GEMM kernel {launches} times, expected "
          f"{want_launches} (one per timed call of its {len(rows)} rows)")
    check(fa.flash_attention.launches + md.mla_decode_attention.launches == 0,
          "an attention kernel ran on the op-level path")
    lines = csv.getvalue().strip().splitlines()
    check(lines[0] == "name,us_per_call,derived" and len(lines) == 25,
          f"op_level CSV: {lines[:2]} ... ({len(lines)} lines)")

    dev = torch.device("cuda")
    out_rows = []
    for r in rows:
        m, k, n = r["shape"]
        a, b = op_level.gemm_inputs(m, k, n, dev)
        out = op_level.seam_gemm(r["seam"], a, b)
        torch.cuda.synchronize()
        ok, err, atol, rtol = gemm_check(torch, out, mm.matmul_ref(a, b), k)
        check(ok, f"op_level {r['seam']} m{r['m']}: kernel vs plain "
              f"max_abs_err {err} beyond atol {atol} + rtol {rtol} * |C|")
        out_rows.append({"seam": r["seam"], "m": r["m"],
                         "shape_mkn": r["shape"],
                         "block": list(mm.plan_blocks(m, n)),
                         "kernel_ms": r["kernel_s"] * 1e3,
                         "library_ms": r["library_s"] * 1e3,
                         "bound_ms": r["bound_s"] * 1e3,
                         "bound_by": r["bound_by"],
                         "bound_share": r["bound_s"] / r["kernel_s"],
                         "library_bound_share": r["bound_s"] / r["library_s"],
                         "max_abs_err": err, "atol": atol, "rtol": rtol})
        del a, b, out
    torch.cuda.empty_cache()
    emit({"phase": "op_level_lane", "rows": out_rows,
          "matmul_launches": launches, "timed_calls_per_row": rows[0]["calls"],
          "timing": "median of warm calls (CUDA events); the operands of "
                    "every row exceed the 50 MB L2",
          "wall_s": wall_s, "csv": lines})
    return launches, out_rows


def fused_check(torch, out, want, k, n_ranks=1, max_partial=0.0):
    """The fused kernels' tolerance: the GEMM rule (see GEMM_BF16_RTOL),
    widened for GEMM-RS by n partials of one ulp each (RS_PARTIAL_ULP):
    (ok, max abs err, atol, rtol)."""
    o, w = out.float(), want.float()
    err = (o - w).abs().max().item()
    if out.dtype == torch.bfloat16:
        atol = (GEMM_BF16_ATOL_REL * w.abs().max().item()
                + n_ranks * RS_PARTIAL_ULP * max_partial)
        rtol = GEMM_BF16_RTOL
    else:
        atol, rtol = GEMM_F32_TOL * k ** 0.5 * n_ranks, GEMM_F32_TOL
    ok = bool(((o - w).abs() <= atol + rtol * w.abs()).all())
    return ok, err, atol, rtol


def _rank_inputs(torch, gen, shapes, n, dtype):
    return [tuple(torch.randn(sh, generator=gen, device="cuda").to(dtype)
                  for sh in shapes) for _ in range(n)]


def _spmd_ms(torch, group, fn, args, iters, warmup=2):
    """Mean device ms of one n-rank call of ``fn``: CUDA events on the
    caller's stream around ``iters`` calls on every rank."""
    def body(*a, reps):
        for _ in range(reps):
            out = fn(*a)
        return out

    def loop(reps):
        return group.spmd(lambda *a: body(*a, reps=reps), args)
    loop(warmup)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    loop(iters)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _copy_activities(torch, group, fn, args):
    """Device activities of one n-rank call under torch.profiler: the
    names of the copies and how many, and the kernels' names (the shard
    pulls must be copy-engine memcpys, not kernels)."""
    from torch.profiler import ProfilerActivity, profile
    group.spmd(fn, args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        group.spmd(fn, args)
        torch.cuda.synchronize()
    names = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            names[e.name] = names.get(e.name, 0) + 1
    return {n: c for n, c in names.items()}


def mla_tp_seam_cases(which):
    """(name, rows, K, N) of one rank's AG-GEMM (``which="ag"``: rows its
    sequence shard) or GEMM-RS (rows M, K its shard) operands at the flux
    seams of the mla tp lane's prefill: deepseek_v3_671b at tp=MLA_TP over
    len(MLA_TP_LENGTHS) prompts padded to the longest, the shapes from
    ``autotune.model_seam_shapes`` (attn_ag's q and kv up-projections,
    attn_rs's w_o, the packed w13 and w2 of the dense FFN, which the
    shared expert's share)."""
    from repro_torch.configs.base import ParallelConfig, get_config
    from repro_torch.parallel.sharding import pad_ff
    from repro_torch.tuning.autotune import model_seam_shapes

    cfg = get_config("deepseek_v3_671b")
    mc = cfg.moe
    check(pad_ff(mc.shared_ffn * mc.num_shared_experts, MLA_TP)
          == pad_ff(cfg.d_ff, MLA_TP),
          "deepseek_v3_671b's shared expert is not the dense FFN's width")
    tokens = len(MLA_TP_LENGTHS) * max(MLA_TP_LENGTHS)
    shapes = model_seam_shapes(cfg, ParallelConfig(tp=MLA_TP, fuse_w13=True),
                               tokens)
    cases = []
    for cell, (kind, m, n, k) in shapes.items():
        if kind != which or cell == "head_ag":   # the head runs no kernel
            continue
        name = f"{which}_mla_tp_{cell.split('@')[-1]}"
        cases.append((name, m // MLA_TP, k, n // MLA_TP) if which == "ag"
                     else (name, m, k // MLA_TP, n))
    return cases


def mla_train_seam_cases(which):
    """(name, rows, K, N) of one rank's AG-GEMM (``which="ag"``) or
    GEMM-RS (``which="rs"``) operands at the backward launches of the mla
    train lane's flux seams: deepseek_v3_671b at tp=MLA_TP over
    MLA_TRAIN_BATCH x MLA_TRAIN_SEQ tokens.  An ag seam's dX is a GEMM-RS
    over its cotangent and the transposed weight (rows the M tokens, K the
    rank's columns: ``attn_ag``'s ``w_uq`` and ``w_ukv``, the packed w13
    of the dense FFN and the shared expert, the vocab shard of
    ``head_ag``), an rs seam's dY an AG-GEMM over the cotangent's shard
    (rows M / tp, N the rank's rows of ``w_o`` or ``w2``)."""
    from repro_torch.configs.base import ParallelConfig, get_config
    from repro_torch.tuning.autotune import model_seam_shapes

    shapes = model_seam_shapes(get_config("deepseek_v3_671b"),
                               ParallelConfig(tp=MLA_TP, fuse_w13=True),
                               MLA_TRAIN_BATCH * MLA_TRAIN_SEQ)
    cases = []
    for cell, (kind, m, n, k) in shapes.items():
        if kind not in ("ag", "rs") or kind == which:
            continue        # the backward runs the other kernel
        name = f"{which}_mla_train_{cell.split('@')[-1]}"
        cases.append((name, m, n // MLA_TP, k) if which == "rs"
                     else (name, m // MLA_TP, n, k // MLA_TP))
    return cases


def mla_seam_cases(cases):
    """The kernels line's digest of ``phase_fused_kernel``'s mla (or
    jamba, or rwkv) lane cases."""
    return {name: {k: r[k] for k in (
        "rank_rows", "K", "N", "activation", "max_abs_err", "fused_ms",
        "plain_ms", "bound_ms", "bound_by", "xla_ms")}
        for name, r in cases.items()}


def phase_fused_kernel(torch, which):
    """The AG-GEMM (``which="ag"``) or GEMM-RS kernel against its plain
    version, n ranks of a RankGroup on the one card; returns the §5.1
    m 8192 case, the mla tp lane's cases, the mla train lane's backward
    cases, the jamba lanes' cases (the jamba train lane's backward
    operands among them) and the rwkv lane's cases by name.  Each case:
    every rank's error, the fused n-rank time, the xla mode's (gather +
    torch.matmul, or torch.matmul + the slots' sum), n x the GEMM kernel
    at one rank's shape, the plain version's and the bound.  Then the dp lane's cases
    (``fused_mesh_cases``)."""
    from repro_torch.core.overlap import Epilogue, FusedOp
    from repro_torch.dist import RankGroup
    from repro_torch.kernels import ag_gemm as AG
    from repro_torch.kernels import gemm_rs as RS
    from repro_torch.kernels import matmul as mm
    from repro_torch.launch.op_level import tp_bound_s

    bf16, f32 = torch.bfloat16, torch.float32
    # name, ranks, dtype, rows (AG: m_sh a rank; RS: M), K (RS: K_sh), N
    # (AG: N_loc), activation, bias, reverse
    cases = [
        (f"{which}_m8192", 8, bf16, 1024 if which == "ag" else 8192,
         12288 if which == "ag" else 6144, 6144 if which == "ag" else 12288,
         None, False, False),
        (f"{which}_m64", 8, bf16, 8 if which == "ag" else 64,
         12288 if which == "ag" else 6144, 6144 if which == "ag" else 12288,
         None, False, False),
        (f"{which}_ragged", 8, bf16, 97 if which == "ag" else 776, 1000,
         1032, None, False, False),
        (f"{which}_silu_bias", 8, bf16, 128 if which == "ag" else 1024, 2304,
         1536, "silu", True, False),
        (f"{which}_reverse", 8, bf16, 128 if which == "ag" else 1024, 2304,
         1536, None, False, True),
        (f"{which}_tp_lane_mlp", 4, bf16, 1024 if which == "ag" else 4096,
         2304 if which == "ag" else 1536, 3072 if which == "ag" else 2304,
         None, False, False),
        (f"{which}_fp32", 4, f32, 64 if which == "ag" else 256, 512, 384,
         "gelu", True, False),
    ]
    # the train lane's operands the forward never gives, at its shapes
    # (tp=4, 4096 tokens; d_ff 1536 a rank, vocab 30720 a rank): the
    # backward's transposed weights, and the LM head's table.T (forward AG)
    # / table (dX of head_ag); a transposed weight is copied row-major
    # first.  name, rows (AG: m_sh a rank; RS: M), K, N, what it is
    train = {"ag": [("ag_train_dy_mlp_rs", 1024, 2304, 1536,
                     "dY of mlp_rs: the dz shard x w2.T"),
                    ("ag_train_head", 1024, 2304, 30720,
                     "the head_ag forward: x x table.T")],
             "rs": [("rs_train_dx_mlp_ag", 4096, 3072, 2304,
                     "dX of mlp_ag: the w13 cotangent x w13.T"),
                    ("rs_train_dx_head", 4096, 30720, 2304,
                     "dX of head_ag: the logits' cotangent x table")]}[which]
    cases += [(name, TP_LANE, bf16, rows, k, nn, None, False, False)
              for name, rows, k, nn, _ in train]
    # the mla tp lane's seams, at the shapes its flux prefill gives them
    mla_cases = mla_tp_seam_cases(which)
    cases += [(name, MLA_TP, bf16, rows, k, nn, None, False, False)
              for name, rows, k, nn in mla_cases]
    # the mla train lane's backward launches, at its shapes
    train_mla = mla_train_seam_cases(which)
    cases += [(name, MLA_TP, bf16, rows, k, nn, None, False, False)
              for name, rows, k, nn in train_mla]
    # the jamba lane's tp=2 flux prefill and two backward launches of the
    # jamba train lane's step, at their shapes
    jamba = jamba_seam_cases(which) + jamba_train_seam_cases(which)
    cases += [(name, JAMBA_TP, bf16, rows, k, nn, None, False, False)
              for name, rows, k, nn in jamba]
    # the rwkv lane's tp=2 flux prefill seams, at their shapes (the
    # channel-mix's AG-GEMM with its squared-ReLU epilogue), and two
    # backward launches of the rwkv train lane's step
    rwkv_train = rwkv_train_seam_cases(which)
    rwkv = rwkv_seam_cases(which) + rwkv_train
    cases += [(name, RWKV_TP, bf16, rows, k, nn, act, False, False)
              for name, rows, k, nn, act in rwkv]
    operands = {c[0]: c[4] for c in train}
    operands.update({
        "ag_rwkv_train_dy_w_o": "dY of w_o: the cotangent's shard x the "
                                "rank's w_o rows transposed",
        "rs_rwkv_train_dx_time_mix": "dX of the time-mix's attn_ag: the "
                                     "five projections' cotangent x the "
                                     "stacked weights transposed (one "
                                     "layer, one backward)"})
    check(set(operands) >= {c[0] for c in rwkv_train},
          "an rwkv train case without its transposed operand")
    kern = AG.ag_gemm if which == "ag" else RS.gemm_rs
    groups = {n: RankGroup(n, "cuda", timeout_s=60)
              for n in {JAMBA_TP, RWKV_TP, 4, 8}}
    gen = torch.Generator(device="cuda")
    ptxas = ptxas_report("ag_gemm" if which == "ag" else "gemm_rs")
    results = {}
    for name, n, dtype, rows, k, nn, act, with_bias, rev in cases:
        g = groups[n]
        gen.manual_seed(300 + len(results) + (0 if which == "ag" else 50))
        shapes = ((rows, k), (k, nn))
        args = _rank_inputs(torch, gen, shapes, n, dtype)
        bias = (torch.randn((nn,), generator=gen, device="cuda").to(dtype)
                if with_bias else None)
        kw = dict(group=g, reverse=rev, activation=act, bias=bias)
        outs = g.spmd(lambda a, b: kern(a, b, **kw), args)
        torch.cuda.synchronize()
        errs, oks, max_partial = [], [], 0.0
        if which == "ag":
            shards = [a for a, _ in args]
            wants = [AG.ag_gemm_ref(shards, b, act, bias) for _, b in args]
        else:
            parts = [(a.float() @ b.float()).to(dtype) for a, b in args]
            max_partial = max(p.abs().max().item() for p in parts)
            wants = [RS.reduce_ref(parts, r, act, bias, dtype)
                     for r in range(n)]
            del parts
        for out, want in zip(outs, wants):
            check(bool(torch.isfinite(out).all()),
                  f"{name}: non-finite output")
            ok, err, atol, rtol = fused_check(
                torch, out, want, k, n if which == "rs" else 1, max_partial)
            errs.append(err)
            oks.append(ok)
        check(all(oks), f"{name}: kernel vs plain max_abs_err {max(errs)} "
              f"beyond atol {atol} + rtol {rtol} * |C| on ranks "
              f"{[r for r, o in enumerate(oks) if not o]}")
        del outs, wants

        m_tot = rows * n if which == "ag" else rows
        # the whole op's (m, k, n) and one rank's GEMM
        op_mkn = ((m_tot, k, nn * n) if which == "ag" else
                  (m_tot, k * n, nn))
        rank_mkn = (m_tot, k, nn)
        fused_ms = _spmd_ms(torch, g, lambda a, b: kern(a, b, **kw), args, 10)
        epi = Epilogue(bias=with_bias, activation=act)
        xla = FusedOp(which, axis=g, mode="xla", epilogue=epi)
        xla_ms = _spmd_ms(torch, g, lambda a, b: xla(a, b, bias=bias),
                          args, 10)
        a1, b1 = (torch.randn(sh, generator=gen, device="cuda").to(dtype)
                  for sh in ((rank_mkn[0], rank_mkn[1]),
                             (rank_mkn[1], rank_mkn[2])))
        nonsplit_ms = n * time_ms(torch, lambda: mm.matmul(a1, b1), 10)
        del a1, b1
        if which == "ag":
            shards = [a for a, _ in args]
            plain = lambda: [AG.ag_gemm_ref(shards, b, act, bias)  # noqa
                             for _, b in args]
        else:
            def plain():    # each rank's partial once, then every reduce
                parts = [(a.float() @ b.float()).to(dtype) for a, b in args]
                return [RS.reduce_ref(parts, r, act, bias, dtype)
                        for r in range(n)]
        plain_ms = time_ms(torch, plain, 1, warmup=1)
        bound_ms, bound_by = tp_bound_s(*op_mkn)
        bound_ms *= 1e3
        res = {"phase": f"{'ag_gemm' if which == 'ag' else 'gemm_rs'}_kernel",
               "case": name, "ranks": n, "dtype": str(dtype)[6:],
               "rank_rows": rows, "K": k, "N": nn, "activation": act,
               "bias": with_bias, "reverse": rev,
               "tile": list(mm.plan_blocks(m_tot, nn)) if dtype == bf16
               else None,
               "max_abs_err": max(errs), "atol": atol, "rtol": rtol,
               "fused_ms": fused_ms, "xla_ms": xla_ms,
               "nonsplit_x_ranks_ms": nonsplit_ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_share": bound_ms / fused_ms,
               "timing": f"mean of 10 calls of all {n} ranks on one card "
                         "(CUDA events around the ranks' loop)"}
        if name in operands:
            src = torch.randn((nn, k), generator=gen, device="cuda").to(dtype)
            res["operand"] = operands[name]
            res["operand_copy_ms"] = time_ms(
                torch, lambda: src.t().contiguous(), 10)
            del src
        if name == f"{which}_m8192" and which == "ag":
            acts = _copy_activities(torch, g, lambda a, b: kern(a, b, **kw),
                                    args)
            res["profiler_activities"] = acts
            res["shard_copies_are_memcpy"] = any(
                "Memcpy" in a and "DtoD" in a for a in acts)
        emit(res)
        results[name] = res
        del args, bias
        for grp in groups.values():
            grp.free_symmetric()
        torch.cuda.empty_cache()
    fused_mesh_cases(torch, which)
    emit({"phase": results[f"{which}_m8192"]["phase"], "ptxas": ptxas})
    return (results[f"{which}_m8192"],
            {c[0]: results[c[0]] for c in mla_cases},
            {c[0]: results[c[0]] for c in train_mla},
            {c[0]: results[c[0]] for c in jamba},
            {c[0]: results[c[0]] for c in rwkv})


def mesh_seam_cases(which):
    """(name, rows, K, N) of a rank's AG-GEMM (``which="ag"``: rows its
    sequence shard) or GEMM-RS (rows M) operands on the (dp, tp) = DP_LANE
    mesh: each seam's forward and backward at the dp lane's 2 x 1024
    tokens a data rank (minicpm_2b), and the ep lane's (deepseek_v3_671b
    at tp=EP_LANE_TP, MLA_TRAIN_BATCH x MLA_TRAIN_SEQ / 2 tokens a data
    rank) ``w_uq`` / ``w_ukv`` (``attn_ag``) and dense ``mlp_ag`` forward
    AG-GEMMs and their dX GEMM-RS (``tuning.autotune.model_seam_shapes``:
    an ag seam's forward and an rs seam's dY are AG-GEMMs, the others
    GEMM-RS)."""
    from repro_torch.configs.base import ParallelConfig, get_config
    from repro_torch.tuning import autotune as AT

    tp, dp = DP_LANE
    lanes = (("dp", dataclasses.replace(get_config("minicpm_2b"),
                                        num_layers=TRAIN_LAYERS),
              TRAIN_BATCH * TRAIN_SEQ // dp, None),
             ("ep", mla_train_cfg(), MLA_TRAIN_BATCH * MLA_TRAIN_SEQ // dp,
              ("attn_ag@q_up", "attn_ag@kv_up", "mlp_ag")))
    cases = []
    for lane, cfg, tokens, keep in lanes:
        par = ParallelConfig(tp=tp, dp=dp, fuse_w13=True, overlap_mode="flux")
        for seam, (kind, m, n, k) in AT.model_seam_shapes(
                cfg, par, tokens).items():
            if kind not in ("ag", "rs") or (keep and seam not in keep):
                continue
            fwd = kind == which
            if kind == "ag":      # forward AG-GEMM; dX a GEMM-RS over N/tp
                shape = (m // tp, k, n // tp) if fwd else (m, n // tp, k)
            else:                 # forward GEMM-RS; dY an AG-GEMM
                shape = (m, k // tp, n) if fwd else (m // tp, n, k // tp)
            cases.append((f"{which}_{lane}_{seam.replace('@', '_')}_"
                          f"{'fwd' if fwd else 'bwd'}", *shape))
    return cases


def fused_mesh_cases(torch, which):
    """The mesh lanes' operands of the AG-GEMM (``which="ag"``) or GEMM-RS
    kernel (``mesh_seam_cases``): the two TP groups of a (dp, tp) =
    DP_LANE ``make_mesh`` launch at once, each its "model" sub-group (a
    launch sized for the mesh's ranks on the card, ``group.share``), every
    rank against the plain version of its own group's inputs.  One line a
    case: every rank's error, the two groups' time and their bound."""
    from repro_torch.kernels import ag_gemm as AG
    from repro_torch.kernels import gemm_rs as RS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.op_level import tp_bound_s

    tp, dp = DP_LANE
    bf16 = torch.bfloat16
    cases = mesh_seam_cases(which)
    mesh = make_mesh(1, dp, tp, "cuda")
    kern = AG.ag_gemm if which == "ag" else RS.gemm_rs
    gen = torch.Generator(device="cuda")

    def call(a, b):
        return kern(a, b, group=mesh.group("model"))

    for i, (name, rows, k, nn) in enumerate(cases):
        gen.manual_seed(700 + i + (0 if which == "ag" else 50))
        args = _rank_inputs(torch, gen, ((rows, k), (k, nn)), mesh.size,
                            bf16)
        outs = mesh.spmd(call, args)
        torch.cuda.synchronize()
        errs, bad = [], []
        for g0 in range(0, mesh.size, tp):      # a TP group's mesh ranks
            mine = args[g0:g0 + tp]
            max_partial = 0.0
            if which == "ag":
                wants = [AG.ag_gemm_ref([a for a, _ in mine], b)
                         for _, b in mine]
            else:
                parts = [(a.float() @ b.float()).to(bf16) for a, b in mine]
                max_partial = max(q.abs().max().item() for q in parts)
                wants = [RS.reduce_ref(parts, r, None, None, bf16)
                         for r in range(tp)]
                del parts
            for r, (out, want) in enumerate(zip(outs[g0:g0 + tp], wants)):
                check(bool(torch.isfinite(out).all()),
                      f"{name}: non-finite output")
                ok, err, atol, rtol = fused_check(
                    torch, out, want, k, tp if which == "rs" else 1,
                    max_partial)
                errs.append(err)
                if not ok:
                    bad.append(g0 + r)
            del wants
        check(not bad, f"{name}: kernel vs plain max_abs_err {max(errs)} "
              f"beyond atol {atol} + rtol {rtol} * |C| on mesh ranks {bad}")
        del outs
        op_mkn = ((rows * tp, k, nn * tp) if which == "ag" else
                  (rows, k * tp, nn))
        bound_s, bound_by = tp_bound_s(*op_mkn)
        fused_ms = _spmd_ms(torch, mesh, call, args, 10)
        emit({"phase": f"{'ag_gemm' if which == 'ag' else 'gemm_rs'}_kernel",
              "case": name, "mesh": {"dp": dp, "tp": tp},
              "groups_at_once": dp,
              "share": mesh.group("model", 0).share, "rank_rows": rows,
              "K": k, "N": nn, "max_abs_err": max(errs), "atol": atol,
              "rtol": rtol, "fused_ms": fused_ms,
              "bound_ms": dp * bound_s * 1e3, "bound_by": bound_by,
              "bound_share": dp * bound_s * 1e3 / fused_ms,
              "timing": f"mean of 10 calls of all {mesh.size} ranks (both "
                        "TP groups) on one card, CUDA events"})
        del args
        mesh.free_symmetric()
        torch.cuda.empty_cache()


def phase_tp_op_level_lane(torch):
    """The main path of the fused kernels at the op level:
    ``launch.op_level`` at TP 8 (2 seams x 6 m x 3 modes = 36 rows through
    ``FusedOp``), counts set to 0 just before and read just after; then
    every row once against the plain version (not counted)."""
    import contextlib
    import io
    from repro_torch.core.overlap import FusedOp
    from repro_torch.dist import RankGroup
    from repro_torch.kernels import ag_gemm as AG
    from repro_torch.kernels import gemm_rs as RS
    from repro_torch.kernels import matmul as mm
    from repro_torch.launch import op_level

    for fn in (AG.ag_gemm, RS.gemm_rs, mm.matmul):
        fn.launches = 0
    RS.gemm_rs.reduce_launches = 0
    csv = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(csv):
        rows = op_level.main(tp=TP_OP_LEVEL)
    wall_s = time.perf_counter() - t0
    counts = {"ag_gemm": AG.ag_gemm.launches,
              "gemm_rs": RS.gemm_rs.launches,
              "gemm_rs_reduce": RS.gemm_rs.reduce_launches,
              "matmul": mm.matmul.launches}
    check(len(rows) == 36, f"{len(rows)} op-level rows, expected 36")
    for seam, name in (("ag", "ag_gemm"), ("rs", "gemm_rs")):
        want = sum(r["calls"] * TP_OP_LEVEL for r in rows
                   if r["seam"] == seam and r["mode"] == "flux")
        check(counts[name] == want,
              f"{name} launched {counts[name]} times in the op-level lane, "
              f"expected {want} (flux rows x calls x ranks); the xla and "
              "decomposed rows launch none")
    check(counts["gemm_rs_reduce"] == counts["gemm_rs"],
          "gemm_rs reduce launches differ from its GEMM launches")
    lines = csv.getvalue().strip().splitlines()
    check(lines[0] == "name,us_per_call,derived" and len(lines) == 49,
          f"op_level CSV: {lines[:2]} ... ({len(lines)} lines)")

    group = RankGroup(TP_OP_LEVEL, "cuda", timeout_s=60)
    checks = []
    for seam, (n, k) in op_level.SEAMS:
        for m in op_level.M_SWEEP:
            args = op_level.tp_inputs(seam, m, k, n, TP_OP_LEVEL,
                                      torch.device("cuda"))
            max_partial = 0.0
            if seam == "ag":
                shards = [a for a, _ in args]
                wants = [AG.ag_gemm_ref(shards, b) for _, b in args]
            else:
                parts = [(a.float() @ b.float()).bfloat16() for a, b in args]
                max_partial = max(p.abs().max().item() for p in parts)
                wants = [RS.reduce_ref(parts, r, None, None, torch.bfloat16)
                         for r in range(TP_OP_LEVEL)]
                del parts
            kdim = k if seam == "ag" else k // TP_OP_LEVEL
            for mode in op_level.MODES:
                op = FusedOp(seam, axis=group, mode=mode)
                outs = op_level.run_tp(group, op, args)
                torch.cuda.synchronize()
                res = [fused_check(torch, o, w, kdim,
                                   TP_OP_LEVEL if seam == "rs" else 1,
                                   max_partial)
                       for o, w in zip(outs, wants)]
                err = max(r[1] for r in res)
                check(all(r[0] for r in res),
                      f"op_level {seam} m{m} {mode}: vs plain max_abs_err "
                      f"{err} beyond atol {res[0][2]} + rtol {res[0][3]}")
                checks.append({"seam": seam, "m": m, "mode": mode,
                               "max_abs_err": err, "atol": res[0][2]})
                del outs
            del args, wants
            group.free_symmetric()
            torch.cuda.empty_cache()
    out_rows = [{"seam": r["seam"], "m": r["m"], "mode": r["mode"],
                 "shape_mkn": r["shape_mkn"], "ms": r["seconds"] * 1e3,
                 "nonsplit_x8_ms": r["nonsplit_x_tp_s"] * 1e3,
                 "bound_ms": r["bound_s"] * 1e3, "bound_by": r["bound_by"],
                 "bound_share": r["bound_s"] / r["seconds"]}
                for r in rows]
    for o, c in zip(out_rows, checks):
        o.update(max_abs_err=c["max_abs_err"], atol=c["atol"])
    emit({"phase": "tp_op_level_lane", "ranks": TP_OP_LEVEL, "rows": out_rows,
          "launches": counts, "calls_per_row": rows[0]["calls"],
          "timing": f"mean of {rows[0]['calls'] - 2} warm calls of all "
                    f"{TP_OP_LEVEL} ranks on one card (CUDA events)",
          "wall_s": wall_s, "csv": lines})
    return counts


def phase_tp_lane(torch, tp1_logits, tp1_decode):
    """minicpm_2b at full width, tp=4 on one card: seeded weights drawn
    as at tp=1, packed for tp and cut per rank; the kernel lane's batch.
    The main path — one flux prefill with the kernels — with its counts;
    then xla and decomposed; last-position logits against the tp=1 kernel
    lane's and flux against xla.  Then the dense decode from the flux
    prefill's caches (``tp_decode``)."""
    from repro_torch.configs.base import ParallelConfig, get_config
    from repro_torch.dist import RankGroup
    from repro_torch.kernels import ag_gemm as AG
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gemm_rs as RS
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import mla_decode as md
    from repro_torch.models import model as M
    from repro_torch.models import serve as S
    from repro_torch.parallel.sharding import make_ctx

    cfg = dataclasses.replace(get_config("minicpm_2b"),
                              num_layers=LANE_LAYERS)
    tp = TP_LANE
    group = RankGroup(tp, "cuda", timeout_s=120)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # w1|w3 packed once here (fuse_w13): the mlp_ag seam's pair gate is
    # then one AG-GEMM over one weight, with no per-call concatenation
    full = M.init_model(cfg, ParallelConfig(tp=tp, fuse_w13=True), seed=0,
                        dtype=torch.bfloat16, device="cuda")
    ranks = [M.shard_params(full, r, tp, cfg) for r in range(tp)]
    del full
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    allocated_gb = torch.cuda.memory_allocated() / 1e9

    lengths = torch.tensor([256, 512, 777, 1024], device="cuda")
    s = int(lengths.max())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)                    # the kernel lane's tokens
    toks = torch.randint(0, cfg.vocab_size, (4, s), generator=gen,
                         device="cuda")
    toks = toks.masked_fill(torch.arange(s, device="cuda")[None]
                            >= lengths[:, None], 0)
    batch = {"tokens": toks}
    ctxs = {mode: make_ctx(ParallelConfig(tp=tp, kernel_decode=True,
                                          overlap_mode=mode), group)
            for mode in ("flux", "xla", "decomposed")}
    args = [(p,) for p in ranks]

    def step(mode):
        return group.spmd(lambda p: S.prefill_step(p, batch, ctxs[mode], cfg,
                                                   lengths), args)

    def logits(mode):
        outs = group.spmd(lambda p: S.prefill_logits(
            p, batch, ctxs[mode], cfg, lengths)[0], args)
        return torch.cat(outs, dim=-1)[:, :cfg.vocab_size].float()

    def zero_counts():
        for fn in (AG.ag_gemm, RS.gemm_rs, fa.flash_attention, mm.matmul,
                   md.mla_decode_attention):
            fn.launches = 0
        RS.gemm_rs.reduce_launches = 0

    def read_counts():
        return {"ag_gemm": AG.ag_gemm.launches,
                "gemm_rs": RS.gemm_rs.launches,
                "gemm_rs_reduce": RS.gemm_rs.reduce_launches,
                "flash_attention": fa.flash_attention.launches,
                "matmul": mm.matmul.launches,
                "mla_decode": md.mla_decode_attention.launches}

    # the main path: counts to 0, one flux prefill, counts read
    zero_counts()
    outs = step("flux")
    torch.cuda.synchronize()
    counts = read_counts()
    per_seam = cfg.num_layers * tp
    want = {"ag_gemm": 2 * per_seam, "gemm_rs": 2 * per_seam,
            "gemm_rs_reduce": 2 * per_seam, "flash_attention": per_seam,
            "matmul": 0, "mla_decode": 0}
    check(counts == want, f"flux prefill launches {counts}, expected {want}")
    nxt = outs[0][0]
    check(all(torch.equal(o[0], nxt) for o in outs),
          "the ranks' next tokens differ")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prefill_caches = [o[1] for o in outs]
    del outs

    lf = logits("flux")
    check(bool(torch.isfinite(lf).all()), "non-finite tp logits")
    lt1 = tp1_logits.to("cuda")
    rel_tp1 = ((lf - lt1).norm() / lt1.norm()).item()
    check(rel_tp1 <= TP_LANE_RTOL,
          f"tp={tp} flux logits vs tp=1 differ by {rel_tp1} (relative L2) "
          f"> {TP_LANE_RTOL}")
    res = {"phase": "tp_lane", "arch": cfg.name, "tp": tp,
           "layers": cfg.num_layers, "init_s": init_s,
           "weights_gb_all_ranks": sum(
               p.numel() * p.element_size() for r in ranks
               for p in r.parameters()) / 1e9,
           "allocated_gb_after_init": allocated_gb, "batch": 4,
           "lengths": lengths.tolist(), "flux_launches": counts,
           "next_tokens": nxt[:, 0].tolist(),
           "next_tokens_tp1": lt1.argmax(-1).tolist(),
           "logits_rel_l2_flux_vs_tp1": rel_tp1,
           "prefill_peak_mem_gb": peak_gb, "rtol": TP_LANE_RTOL}
    for mode in ("xla", "decomposed"):
        zero_counts()
        lm = logits(mode)
        torch.cuda.synchronize()
        c = read_counts()
        check(c["ag_gemm"] == 0 and c["gemm_rs"] == 0,
              f"{mode} prefill launched the fused kernels: {c}")
        rel = ((lf - lm).norm() / lm.norm()).item()
        if mode == "xla":
            check(rel <= TP_LANE_RTOL,
                  f"flux vs xla logits differ by {rel} (relative L2) > "
                  f"{TP_LANE_RTOL}")
        res[f"logits_rel_l2_flux_vs_{mode}"] = rel
        res[f"{mode}_launches"] = c
        del lm
    for mode in ("flux", "xla", "decomposed"):
        med, samples = wall_ms(torch, lambda: step(mode), TP_LANE_REPEATS)
        res[f"prefill_ms_median_{mode}"] = med
        res[f"prefill_ms_samples_{mode}"] = samples
    res["prefill_profile_flux"] = device_profile(torch, lambda: step("flux"))
    res["prefill_profile_xla"] = device_profile(torch, lambda: step("xla"))
    emit(res)
    group.free_symmetric()
    tp_decode(torch, group, ranks, cfg, lengths, prefill_caches, counts,
              tp1_decode, repeats=TP_LANE_REPEATS)
    del ranks, args, prefill_caches
    group.free_symmetric()
    torch.cuda.empty_cache()
    return counts


def tp_decode(torch, group, ranks, cfg, lengths, prefill_caches,
              prefill_counts, tp1_decode, n_decode=N_DECODE,
              n_other=N_DECODE_OTHER_MODES, phase="tp_decode", repeats=3):
    """A tp lane's dense decode: from the flux prefill's caches, n_decode
    steps in flux (``decode_step``'s halves) teacher-forced on the tp=1
    decode's tokens (each step's logits, the ranks' vocab shards
    concatenated, against tp=1's at that step; every rank's tokens
    equal), the last step again through ``decode_step`` (the same
    tokens), then the first n_other steps in xla and decomposed against
    flux's.  The decode runs the replicated layout: its seams are the
    AllReduces, with no fused kernel."""
    from repro_torch.models import serve as S
    from repro_torch.parallel.sharding import make_ctx
    from repro_torch.configs.base import ParallelConfig

    t_phase = time.perf_counter()
    tp = group.n
    s_max = int(lengths.max()) + n_decode + 1
    caches = [_dense_caches(torch, c, s_max) for c in prefill_caches]
    args = list(zip(ranks, caches))
    ctxs = {mode: make_ctx(ParallelConfig(tp=tp, overlap_mode=mode), group)
            for mode in ("flux", "xla", "decomposed")}
    tp1_tokens = [t.to("cuda") for t in tp1_decode["tokens"]]

    def one(mode, step):
        """decode_step's halves on every rank: (tokens [tp, B], logits
        [B, V]) of the step fed the kernel lane's token of ``step``."""
        ctx = ctxs[mode]

        def body(p, c):
            lg, _ = S.decode_logits(p, c, tp1_tokens[step], lengths + step,
                                    ctx, cfg)
            return S.vocab_parallel_argmax(lg, cfg.vocab_size, ctx), lg
        outs = group.spmd(body, args)
        return (torch.stack([o[0] for o in outs]),
                torch.cat([o[1] for o in outs], dim=-1)[:, :cfg.vocab_size])

    res = {"phase": phase, "arch": cfg.name, "tp": tp,
           "layers": cfg.num_layers, "batch": int(lengths.shape[0]),
           "lengths": lengths.tolist(), "prefill_launches": prefill_counts,
           "decode_steps": n_decode, "rtol": TP_LANE_RTOL}
    flux_logits, samples, rel_tp1, agree = [], [], [], 0
    for step in range(n_decode):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, lg = one("flux", step)
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
        check(bool((toks == toks[0]).all()),
              f"tp decode step {step}: the ranks' tokens differ")
        check(bool(torch.isfinite(lg).all()),
              f"tp decode step {step}: non-finite logits")
        want = tp1_decode["logits"][step].to("cuda")
        rel_tp1.append(_rel_l2(lg, want))
        check(rel_tp1[-1] <= TP_LANE_RTOL,
              f"tp={tp} decode step {step} logits vs tp=1 differ by "
              f"{rel_tp1[-1]} (relative L2) > {TP_LANE_RTOL}")
        agree += int((toks[0] == tp1_tokens[step + 1][:, 0]).sum())
        flux_logits.append(lg)
    # the entry point itself, on the last step's inputs (it rewrites that
    # position's cache rows with the same values)
    last = n_decode - 1

    def whole():
        return torch.stack(group.spmd(
            lambda p, c: S.decode_step(p, c, tp1_tokens[last],
                                       lengths + last, ctxs["flux"], cfg)[0],
            args))[..., 0]
    check(torch.equal(whole(), toks), "tp decode: decode_step's tokens "
          "differ from its halves' at the last step")
    res["decode_step_ms_median"], _ = wall_ms(torch, whole, repeats)
    res["logits_rel_l2_vs_tp1"] = rel_tp1
    res["tokens_agree_with_tp1"] = f"{agree}/{n_decode * len(lengths)}"
    warm = sorted(samples[1:])
    res["decode_ms_per_step_median"] = warm[len(warm) // 2]
    res["decode_ms_samples"] = samples
    for mode in ("xla", "decomposed"):
        rels = []
        for step in range(n_other):
            toks, lg = one(mode, step)
            check(bool((toks == toks[0]).all()),
                  f"tp decode {mode} step {step}: the ranks' tokens differ")
            rels.append(_rel_l2(lg, flux_logits[step]))
            check(rels[-1] <= TP_LANE_RTOL,
                  f"tp decode step {step}: {mode} vs flux logits differ by "
                  f"{rels[-1]} (relative L2) > {TP_LANE_RTOL}")
        res[f"logits_rel_l2_{mode}_vs_flux"] = rels
        med, _ = wall_ms(torch, lambda: one(mode, 0), repeats)
        res[f"decode_ms_per_step_median_{mode}"] = med
    # where one more flux step's time goes (it rewrites step 0's position)
    res["decode_profile_flux"] = device_profile(torch, lambda: one("flux", 0))
    res["ar_op_host_ms"] = ar_op_host_ms(torch, group, cfg,
                                         int(lengths.shape[0]))
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)


def ar_op_host_ms(torch, group, cfg, batch, calls=10):
    """Host-clock ms of one decode ``ar`` op (the FFN's w2 seam: y [B, 1,
    F/tp] x w [F/tp, D], bf16, all ranks), per mode: ``calls`` ops inside
    one ``spmd`` run to completion on the card, divided by ``calls``."""
    from repro_torch.core.overlap import FusedOp
    from repro_torch.parallel.sharding import pad_ff
    f_loc = pad_ff(cfg.d_ff, group.n) // group.n
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    args = [(torch.randn((batch, 1, f_loc), generator=gen, device="cuda",
                         dtype=torch.bfloat16),
             torch.randn((f_loc, cfg.d_model), generator=gen, device="cuda",
                         dtype=torch.bfloat16) * f_loc ** -0.5)
            for _ in range(group.n)]
    out = {}
    for mode in ("flux", "xla", "decomposed"):
        op = FusedOp("ar", axis=group, mode=mode)

        def run():
            group.spmd(lambda y, w: [op(y, w) for _ in range(calls)], args)
        med, _ = wall_ms(torch, run, repeats=3)
        out[mode] = med / calls
    return out


def phase_tp_server_lane(torch):
    """The paged Server at tp=4 in flux on the one card: minicpm_2b at full
    width cut to its first TP_SERVER_LAYERS layers (each decode step is
    host-bound at about two exchanges a layer), through
    ``launch.serve``'s path (``serve_lane``)."""
    return serve_lane(torch, "tp_server_lane", TP_SERVER_ARGV, TP_LANE)


def serve_lane(torch, phase, argv, tp, ties_ok=False):
    """``launch.serve`` at ``tp`` in flux with ``argv``: 8 requests served
    together, then every SERVE_ALONE_STRIDE-th of them one at a time, then
    all again on the same server (prefix reuse); then the tp=1 Server
    over the same layers and seed.  Each request's first-token logits are
    taken again from both servers' chunked prefill (``first_logits``):
    the tp server's must lie within
    ``TP_LANE_RTOL`` of tp=1's, and each server's first tokens must be
    their argmax.  The first tokens must equal tp=1's; with ``ties_ok`` a
    request may differ where tp=1's top-2 margin is at most twice the
    largest logit difference between the two servers there (a near-tied
    argmax that the measured bf16 error can overturn).  Later tokens are
    reported: with random weights the logits are nearly flat.  Its calls
    run the replicated layout: no kernel launches.  Returns the tp=1
    server's tokens by request id."""
    from repro_torch.kernels import ag_gemm as AG
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gemm_rs as RS
    from repro_torch.launch import serve as launch_serve
    from repro_torch.runtime.server import Request, Server

    kernels = (AG.ag_gemm, RS.gemm_rs, fa.flash_attention)
    for fn in kernels:
        fn.launches = 0
    t0 = t_phase = time.perf_counter()
    server, done = launch_serve.main(argv + ["--tp", str(tp),
                                             "--mode", "flux"])
    wall_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    check(not any(launches.values()), f"{phase} launched {launches}: its "
          "replicated-layout calls run no kernel")
    cfg = server.cfg
    check(server.group.n == tp and server.ctx.mode == "flux",
          f"{phase} did not run tp={tp} flux")
    check(len(done) == 8, f"{len(done)} of 8 requests finished")
    for r in done:
        check(r.done and r.error is None, f"request {r.rid}: {r.error}")
        check(len(r.output) == 16, f"request {r.rid}: {len(r.output)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.output),
              f"request {r.rid}: token out of [0, vocab)")
    ttfts = sorted(r.ttft_s() for r in done)
    tpots = sorted(r.per_token_s() for r in done)
    n_tok = sum(len(r.output) for r in done)
    tok_s = n_tok / (max(r.t_finish for r in done)
                     - min(r.t_arrival for r in done))
    concurrent = {r.rid: r.output for r in done}
    peak = server.pool.peak_blocks_in_use

    agree = 0
    alone_reqs = sorted(done, key=lambda x: x.rid)[::SERVE_ALONE_STRIDE]
    for r in alone_reqs:
        alone = Server(cfg, server.par, server.params, server.sc,
                       group=server.group)
        agree += int(alone.serve([Request(rid=r.rid, prompt=r.prompt)])[0]
                     .output == concurrent[r.rid])
    check(agree == len(alone_reqs),
          f"concurrent vs isolated: {agree}/{len(alone_reqs)}")
    hits = server.pool.reuse_hits
    again = server.serve([Request(rid=r.rid, prompt=r.prompt) for r in done])
    reused = {r.rid: r.output for r in again}
    check(reused == concurrent, "the reuse pass's tokens differ")
    check(server.pool.reuse_hits > hits,
          "the reuse pass reused no prompt block")

    srv1, done1 = launch_serve.main(argv)
    tp1 = {r.rid: r.output for r in done1}
    first = sum(int(tp1[i][0] == concurrent[i][0]) for i in tp1)
    later = sum(int(a == b) for i in tp1
                for a, b in zip(tp1[i][1:], concurrent[i][1:]))

    prompts = {r.rid: r.prompt for r in done}
    got = first_logits(torch, server, prompts)
    want = first_logits(torch, srv1, prompts)
    logits = {"rel_l2_vs_tp1": {}, "max_abs_diff": {}, "tp1_top2_margin": {},
              "tp1_rms": {}}
    flips = {}
    for i in sorted(prompts):
        g, w = got[i], want[i]
        check(int(g.argmax()) == concurrent[i][0]
              and int(w.argmax()) == tp1[i][0],
              f"request {i}: a server's first token is not the argmax of "
              "its first-token logits")
        top2 = torch.topk(w, 2).values
        diff = (g - w).abs().max().item()
        margin = (top2[0] - top2[1]).item()
        logits["rel_l2_vs_tp1"][i] = _rel_l2(g, w)
        logits["max_abs_diff"][i] = diff
        logits["tp1_top2_margin"][i] = margin
        logits["tp1_rms"][i] = w.pow(2).mean().sqrt().item()
        if concurrent[i][0] != tp1[i][0]:
            flips[i] = {"tp1": tp1[i][0], "tp": concurrent[i][0],
                        "margin": margin, "max_abs_diff": diff,
                        "tp1_logit_of_tp_token": w[concurrent[i][0]].item(),
                        "tp_logit_of_tp1_token": g[tp1[i][0]].item()}
    emit({"phase": phase, "scale": "smoke", "arch": cfg.name,
          "tp": tp, "mode": "flux", "layers": cfg.num_layers,
          "dtype": cfg.compute_dtype,
          "requests": len(done), "kernel_launches": launches,
          "max_batch": server.sc.max_batch,
          "block_size": server.sc.block_size,
          "prefill_chunk": server.sc.prefill_chunk,
          "prompt_lens": [len(r.prompt) for r in done],
          "ttft_p50_ms": ttfts[len(ttfts) // 2] * 1e3,
          "tpot_p50_ms": tpots[len(tpots) // 2] * 1e3,
          "tokens_per_s": tok_s, "serve_wall_s": wall_s,
          "pool_peak_blocks": peak,
          "pool_blocks": server.pool.num_blocks - 1,
          "prefill_calls": server.prefill_dispatches,
          "decode_calls": server.decode_dispatches,
          "concurrent_equals_isolated": f"{agree}/{len(alone_reqs)}",
          "isolated_rids": [r.rid for r in alone_reqs],
          "reuse_hits": server.pool.reuse_hits - hits,
          "first_tokens_equal_tp1": f"{first}/{len(tp1)}",
          "later_tokens_agree_tp1": f"{later}/{15 * len(tp1)}",
          "first_logits": logits, "rtol": TP_LANE_RTOL,
          "first_token_flips": flips,
          "tp1_tpot_p50_ms": sorted(r.per_token_s() for r in done1)[
              len(done1) // 2] * 1e3,
          "phase_s": time.perf_counter() - t_phase})
    worst = max(logits["rel_l2_vs_tp1"].values())
    check(worst <= TP_LANE_RTOL, f"{phase}: first-token logits {worst:.4g} "
          f"rel. L2 from tp=1 (rtol {TP_LANE_RTOL})")
    if ties_ok:
        wide = [i for i, f in flips.items()
                if f["margin"] > 2 * f["max_abs_diff"]]
        check(not wide, f"{phase}: first tokens differ from tp=1's at "
              f"requests {wide}, where tp=1's top-2 margin exceeds twice "
              "the logits' largest difference")
    else:
        check(first == len(tp1), f"first tokens vs the tp=1 Server: "
              f"{first}/{len(tp1)}")
    del server, srv1
    torch.cuda.empty_cache()
    return tp1


def first_logits(torch, server, prompts):
    """{rid: the float logits [vocab] of each prompt's first generated
    token}, from a fresh Server on ``server``'s params, group or mesh and
    serve config, through the chunked prefill that
    ``Server.prefill_chunk`` runs (``prefill_chunk_logits``: its argmax is
    the first token; a recurrent layer's state, Mamba's or RWKV's,
    threads through the job's slot); at tp>1 the TP ranks' vocab shards
    side by side."""
    import numpy as np
    from repro_torch.models import serve as S
    from repro_torch.runtime.server import Request, Server

    srv = Server(server.cfg, server.par, server.params, server.sc,
                 group=server.group, mesh=server.mesh)
    c = srv.sc.prefill_chunk
    out = {}
    for rid, prompt in prompts.items():
        job = srv.begin_admission(Request(rid=rid, prompt=prompt))
        check(job is not None, f"no slot for request {rid}")
        bt = srv._tensor(job.table.as_array(srv.pages)[None])
        n = len(prompt)
        while job.off < n:
            clen = min(c, n - job.off)
            toks = np.zeros((1, c), np.int64)
            toks[0, :clen] = prompt[job.off:job.off + clen]
            toks = srv._tensor(toks)

            def chunk(p, cache, ctx, off=job.off, clen=clen, toks=toks):
                return S.prefill_chunk_logits(p, cache, toks, bt, off, clen,
                                              ctx, srv.cfg,
                                              slot=job.slot)[0]
            # the first TP group's vocab shards (a mesh's replicas agree)
            logits = torch.cat(srv.run_ranks(chunk)[:srv.par.tp], -1)
            job.off += clen
        out[rid] = logits[0, :srv.cfg.vocab_size].float()
    del srv
    return out


def _rel_l2(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


def _worst_leaf(got, want):
    """(max relative L2 over the leaves, its leaf)."""
    rel = {n: _rel_l2(got[n], want[n]) for n in want}
    worst = max(rel, key=rel.get)
    return rel[worst], worst


def zero_counts():
    """Every kernel wrapper's launch count set to 0, and the wire codec's
    encode count (``overlap.wire_encode.calls``)."""
    from repro_torch.kernels import ag_gemm as AG
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gemm_rs as RS
    from repro_torch.kernels import matmul as mm
    from repro_torch.core import overlap as tov
    for fn in (AG.ag_gemm, RS.gemm_rs, fa.flash_attention, mm.matmul):
        fn.launches = 0
    RS.gemm_rs.reduce_launches = 0
    tov.wire_encode.calls = 0


def read_counts():
    from repro_torch.kernels import ag_gemm as AG
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gemm_rs as RS
    from repro_torch.kernels import matmul as mm
    return {"ag_gemm": AG.ag_gemm.launches,
            "gemm_rs": RS.gemm_rs.launches,
            "gemm_rs_reduce": RS.gemm_rs.reduce_launches,
            "flash_attention": fa.flash_attention.launches,
            "matmul": mm.matmul.launches}


def step0_grads(torch, cfg, par, mesh, ranks, batches, plans=None):
    """Step 0's forward and backward on every rank of ``mesh`` (a
    ``Trainer``'s ``group``), each rank on its data shard's batch
    (``batches``: ``Trainer.step_batch``; mesh rank r's shard is r // tp):
    the forward, the counts, then the backward, the replicated leaves' sum
    over each TP group and, on a dedicated ep axis, the trainer's pmean
    over it (``trainer.ep_grads``).  Returns (every rank's loss, every
    rank's grads, counts after the forward, counts of the backward, {host
    ms of the forward and of the backward, seams a rank recorded, the
    step's peak GB, the wire encodes of the forward and of the
    backward})."""
    from repro_torch.core import overlap as tov
    from repro_torch.models import model as M
    from repro_torch.runtime import trainer as T
    tp = par.tp
    first = T.make_ctx(cfg, par, plans=plans, mesh=mesh, rank=0)
    ctxs = [first] + [T.make_ctx(cfg, par, plans=first.plans, mesh=mesh,
                                 rank=r) for r in range(1, mesh.size)]
    replicated = M.replicated_leaves(cfg, None, par)
    ep_rep = {n: "ep" not in M.spec_axes(sp)
              for n, sp in M.mesh_specs(cfg, par).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def bwd(p, tape, loss):
        ctx = ctxs[mesh.rank()]
        # one statement each: a grad replaced in the dict is freed at once
        g = T.grads_from_tape(p, tape, loss)
        g = T.complete_grads(g, replicated, ctx.axis)
        return T.ep_grads(g, ep_rep, ctx.ep_group if par.ep > 1 else None)

    zero_counts()
    t0 = time.perf_counter()
    outs = mesh.spmd(lambda p, b: T.forward_on_tape(
        p, b, ctxs[mesh.rank()], cfg, par),
        [(p, batches[r // tp]) for r, p in enumerate(ranks)])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    c_fwd = read_counts()
    enc_fwd = tov.wire_encode.calls
    seams = len(outs[0][0].entries)
    zero_counts()
    grads = mesh.spmd(bwd, [(p, t, l) for p, (t, l) in zip(ranks, outs)])
    torch.cuda.synchronize()
    host = {"forward_ms": (t1 - t0) * 1e3,
            "backward_ms": (time.perf_counter() - t1) * 1e3,
            "seams_a_rank": seams,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "wire_encodes": {"forward": enc_fwd,
                             "backward": tov.wire_encode.calls}}
    c_bwd = read_counts()
    losses = [l.item() for _, l in outs]
    del outs
    for s in range(mesh.size // tp):
        group = losses[s * tp:(s + 1) * tp]
        check(max(group) == min(group),
              f"{par.overlap_mode}: shard {s}'s TP ranks' losses {group}")
    return losses, grads, c_fwd, c_bwd, host


def synced_canonical(torch, cfg, par, mesh, ranks, grads, names=None):
    """The trainer's grad sync of step 0's ``grads`` (``step0_grads``) at
    dp>1 or pods>1 (``adamw.sync_grads``: the ZeRO-1 reduce-scatter over
    data, the pod pmean; a leaf split over data as it is), the ranks'
    pieces joined into the global leaves (``model.mesh_join``), in the
    canonical layout, / tp: the leaves ``names`` (default every leaf)."""
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.runtime import trainer as T
    names = list(grads[0]) if names is None else names
    sub = [{n: g[n] for n in names} for g in grads]
    if par.pods * par.dp > 1:
        plan = T.zero1_plan(cfg, ranks[0], par.dp, par)
        groups = [T._pod_data(T.make_ctx(cfg, par, mesh=mesh, rank=r))
                  for r in range(mesh.size)]

        def sync(g):
            pod, data = groups[mesh.rank()]
            return adamw.sync_grads(g, {n: plan[n] for n in g}, data, pod)
        held = mesh.spmd(sync, [(g,) for g in sub])
        plan = {n: plan[n] for n in names}
        sub = [T.RankPieces(held, plan, T.data_peers(mesh, r), r)
               for r in range(mesh.size)]
    glob = M.mesh_join(sub, [T.mesh_coords(mesh, r)
                             for r in range(mesh.size)], cfg, par)
    del sub
    return {n: g / par.tp for n, g in
            M.canonical_leaves(glob, cfg, par.tp, grads=True).items()}


def step0(torch, cfg, par, mesh, ranks, batches, plans=None,
          grads_out=None):
    """Step 0 on every rank of ``mesh`` (``step0_grads``) and the grad
    sync (``synced_canonical``).  Returns (the loss: the shards' mean,
    canonical grads / tp, counts after the forward, counts of the
    backward, host figures); ``plans`` overrides the ``PlanSet`` ``par``
    implies; ``grads_out`` (a list) takes every rank's TP-complete grads,
    before the sync."""
    losses, grads, c_fwd, c_bwd, host = step0_grads(
        torch, cfg, par, mesh, ranks, batches, plans)
    if grads_out is not None:
        grads_out.extend(grads)
    can = synced_canonical(torch, cfg, par, mesh, ranks, grads)
    shards = mesh.size // par.tp
    return sum(losses[::par.tp]) / shards, can, c_fwd, c_bwd, host


def tape_backward_scaling(torch, depths=TAPE_DEPTHS, reps=3):
    """Host ms of the seam tape's backward (``grads_from_tape`` on every
    rank) at tp=4 in xla mode on the minicpm_2b smoke config (bf16, batch
    2 x 256), at two depths, median of ``reps`` after one warm-up: where
    the GEMMs are too small to hide it, the tape's own cost.  Each
    segment is walked once, so the time and the autograd calls a rank
    should grow linearly with depth."""
    from repro_torch.configs.base import ParallelConfig, get_smoke_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.dist import RankGroup
    from repro_torch.models import model as M
    from repro_torch.runtime import trainer as T

    out = {"arch": "minicpm_2b smoke config", "mode": "xla",
           "batch": "2 x 256"}
    for depth in depths:
        cfg = dataclasses.replace(get_smoke_config("minicpm_2b"),
                                  num_layers=depth)
        par = ParallelConfig(tp=TP_LANE, overlap_mode="xla")
        full = M.init_model(cfg, par, seed=0, dtype=torch.bfloat16,
                            device="cuda", trainable=True)
        ranks = [M.shard_params(full, r, TP_LANE, cfg)
                 for r in range(TP_LANE)]
        group = RankGroup(TP_LANE, "cuda", timeout_s=60)
        ctx = T.make_ctx(cfg, par, group)
        batch = {k: torch.from_numpy(v).cuda() for k, v in
                 batch_at(DataConfig(cfg.vocab_size, 256, 2), 0).items()}
        ms = []
        for _ in range(reps + 1):
            tapes = group.spmd(lambda p: T.forward_on_tape(p, batch, ctx,
                                                           cfg, par),
                               [(p,) for p in ranks])
            torch.cuda.synchronize()
            calls = 1 + len(tapes[0][0].entries)
            t0 = time.perf_counter()
            group.spmd(T.grads_from_tape,
                       [(p, t, l) for p, (t, l) in zip(ranks, tapes)])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        med = sorted(ms[1:])[reps // 2]
        out[f"layers_{depth}"] = {"backward_host_ms_median": med,
                                  "backward_host_ms": ms[1:],
                                  "autograd_calls_a_rank": calls,
                                  "ms_a_layer": med / depth}
    lo, hi = (out[f"layers_{d}"] for d in depths)
    out["time_ratio"] = (hi["backward_host_ms_median"]
                         / lo["backward_host_ms_median"])
    out["depth_ratio"] = depths[1] / depths[0]
    return out


def phase_train_lane(torch):
    """minicpm_2b at full width, cut to its first TRAIN_LAYERS layers,
    trained through ``runtime.trainer`` (bf16 weights from seed 0, fp32
    moments, the wsd schedule, batch 4 x 1024 from ``data/pipeline.py``):
    3 steps at tp=1, then at tp=4 on the one card in flux mode from the
    same canonical weights.  The main path is the tp=4 flux run: step 0's
    forward and backward with the counts read between them, then the 3
    trainer steps with the counts read after.  Step 0's loss and grads at
    tp=4 are held against tp=1's, and xla's and decomposed's (each one
    forward and backward, no fused kernel) against flux's."""
    from repro_torch.configs.base import (ParallelConfig, get_config,
                                          train_schedule)
    from repro_torch.models import model as M
    from repro_torch.runtime import trainer as T

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("minicpm_2b"),
                              num_layers=TRAIN_LAYERS)
    n_layers, tp = cfg.num_layers, TP_LANE
    tc = T.TrainConfig(total_steps=TRAIN_STEPS, warmup_steps=0,
                       base_lr=3e-4, schedule=train_schedule("minicpm_2b"),
                       log_every=TRAIN_STEPS)

    def trainer(par):
        tr = T.Trainer(cfg, par, tc, device="cuda", dtype=torch.bfloat16)
        tr.data_cfg = dataclasses.replace(tr.data_cfg, seq_len=TRAIN_SEQ,
                                          global_batch=TRAIN_BATCH)
        return tr

    def step_ms(hist):
        ms = sorted(h["seconds"] * 1e3 for h in hist)
        return ms[len(ms) // 2], [h["seconds"] * 1e3 for h in hist]

    res = {"phase": "train_lane", "arch": cfg.name,
           "layers": f"{n_layers} of 40 (cut in depth)",
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
           "schedule": tc.schedule, "dtype": "bfloat16 weights, "
           "float32 moments", "loss_rtol": TRAIN_LOSS_RTOL,
           "grad_rtol": TRAIN_GRAD_RTOL,
           "ln_vocab": math.log(cfg.vocab_size)}

    # what earlier phases left allocated (the peaks below include it)
    res["baseline_mem_gb"] = torch.cuda.memory_allocated() / 1e9

    # ---- tp=1: step 0's grads, then 3 trainer steps ----------------------
    par1 = ParallelConfig(tp=1, fuse_w13=True)
    tr1 = trainer(par1)
    torch.cuda.reset_peak_memory_stats()
    params1, opt1 = tr1.init_state()
    batch0 = tr1.batch(0)

    def step0_tp1(par):
        """Step 0's (loss, grads, peak GB of the step) at tp=1."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss, grads = T.loss_and_grads(params1[0], batch0,
                                       T.make_ctx(cfg, par), cfg, par)
        return loss.item(), grads, torch.cuda.max_memory_allocated() / 1e9

    loss1, g1, peak1 = step0_tp1(par1)
    can1 = M.canonical_leaves(g1, cfg, 1, grads=True)
    del g1
    # remat (every block recomputed in the backward): the same grads
    loss1r, g1r, peak1r = step0_tp1(dataclasses.replace(par1, remat="full"))
    rel_r, leaf_r = _worst_leaf(M.canonical_leaves(g1r, cfg, 1, grads=True),
                                can1)
    del g1r
    check(abs(loss1r - loss1) <= TRAIN_LOSS_RTOL * abs(loss1)
          and rel_r <= TRAIN_GRAD_RTOL,
          f"tp=1 remat step 0: loss {loss1r} vs {loss1}, grad of {leaf_r} "
          f"relative L2 {rel_r}")
    res["remat_tp1"] = {"step0_loss": loss1r, "grad_rel_l2_max": rel_r,
                        "grad_worst_leaf": leaf_r,
                        "loss_equal": loss1r == loss1,
                        "step0_peak_gb": peak1r,
                        "step0_peak_gb_without_remat": peak1}
    _, _, hist1 = tr1.train(params1, opt1)
    losses1 = [h["loss"] for h in hist1]
    check(all(map(math.isfinite, losses1)),
          f"tp=1 losses {losses1}")
    res["tp1"] = {"losses": losses1, "step0_loss": loss1,
                  "step_ms_median": step_ms(hist1)[0],
                  "step_ms": step_ms(hist1)[1],
                  "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                  "weights": sum(p.numel() for p in params1[0].parameters())}
    del params1, opt1, tr1
    torch.cuda.empty_cache()

    # ---- tp=4 on the one card --------------------------------------------
    par4 = ParallelConfig(tp=tp, fuse_w13=True, overlap_mode="flux")
    tr4 = trainer(par4)
    group = tr4.group
    torch.cuda.reset_peak_memory_stats()
    ranks, opts = tr4.init_state()

    def rank_grads(mode, **kw):
        """``step0`` in ``mode``; ``kw`` overrides ``ParallelConfig``
        fields (remat, the layout)."""
        par = dataclasses.replace(par4, overlap_mode=mode, **kw)
        return step0(torch, cfg, par, group, ranks, [batch0])

    # the main path, part 1: step 0's forward and backward in flux mode
    loss4, can4, c_fwd, c_bwd, host4 = rank_grads("flux")
    per_layer = n_layers * tp
    want_fwd = {"ag_gemm": (2 * n_layers + 1) * tp, "gemm_rs": 2 * per_layer,
                "gemm_rs_reduce": 2 * per_layer, "flash_attention": 0,
                "matmul": 0}
    want_bwd = {"ag_gemm": 2 * per_layer, "gemm_rs": (2 * n_layers + 1) * tp,
                "gemm_rs_reduce": (2 * n_layers + 1) * tp,
                "flash_attention": 0, "matmul": 0}
    check(c_fwd == want_fwd, f"tp={tp} flux forward launches {c_fwd}, "
          f"expected {want_fwd}")
    check(c_bwd == want_bwd, f"tp={tp} flux backward launches {c_bwd}, "
          f"expected {want_bwd}")
    rel_loss = abs(loss4 - loss1) / abs(loss1)
    check(rel_loss <= TRAIN_LOSS_RTOL,
          f"tp={tp} flux step-0 loss {loss4} vs tp=1 {loss1}: relative "
          f"{rel_loss} > {TRAIN_LOSS_RTOL}")
    rel_g, leaf = _worst_leaf(can4, can1)
    check(rel_g <= TRAIN_GRAD_RTOL,
          f"tp={tp} flux step-0 grad of {leaf} vs tp=1: relative L2 "
          f"{rel_g} > {TRAIN_GRAD_RTOL}")
    res["tp4_flux"] = {"step0_loss": loss4, "loss_rel_vs_tp1": rel_loss,
                       "grad_rel_l2_vs_tp1_max": rel_g,
                       "grad_worst_leaf": leaf,
                       "launches_forward": c_fwd, "launches_backward": c_bwd,
                       "step0_host": host4}
    del can1
    # train_bidir: decomposed_bidir beside xla and decomposed
    for mode in ("xla", "decomposed", "decomposed_bidir"):
        lm, canm, cf, cb, hm = rank_grads(mode)
        for c in (cf, cb):
            check(c["ag_gemm"] == 0 and c["gemm_rs"] == 0,
                  f"{mode} step launched the fused kernels: {c}")
        rl = abs(lm - loss4) / abs(loss4)
        rg, lf = _worst_leaf(canm, can4)
        check(rl <= TRAIN_LOSS_RTOL and rg <= TRAIN_GRAD_RTOL,
              f"{mode} vs flux: loss relative {rl}, grad of {lf} relative "
              f"L2 {rg}")
        res[f"tp4_{mode}"] = {"step0_loss": lm, "loss_rel_vs_flux": rl,
                              "grad_rel_l2_vs_flux_max": rg,
                              "grad_worst_leaf": lf, "step0_host": hm,
                              "launches": {"forward": cf, "backward": cb}}
        del canm
    # remat at tp=4 in flux: the same grads, and the backward launches the
    # blocks' fused kernels again (2 AG-GEMM and 2 GEMM-RS a layer a rank)
    lm, canm, cf, cb, hm = rank_grads("flux", remat="full")
    recompute = {"ag_gemm": 2 * per_layer, "gemm_rs": 2 * per_layer,
                 "gemm_rs_reduce": 2 * per_layer, "flash_attention": 0,
                 "matmul": 0}
    want_bwd_remat = {k: want_bwd[k] + recompute[k] for k in want_bwd}
    check(cf == want_fwd and cb == want_bwd_remat,
          f"tp={tp} flux remat launches {cf} / {cb}, expected {want_fwd} / "
          f"{want_bwd_remat}")
    rl = abs(lm - loss4) / abs(loss4)
    rg, lf = _worst_leaf(canm, can4)
    check(rl <= TRAIN_LOSS_RTOL and rg <= TRAIN_GRAD_RTOL,
          f"tp={tp} flux remat vs flux: loss relative {rl}, grad of {lf} "
          f"relative L2 {rg}")
    res["remat_tp4_flux"] = {"step0_loss": lm, "loss_rel_vs_flux": rl,
                             "grad_rel_l2_vs_flux_max": rg,
                             "grad_worst_leaf": lf, "step0_host": hm,
                             "launches_forward": cf,
                             "launches_backward": cb}
    del canm
    # train_hidden: the replicated layout (no fused kernel) against the seq
    # layout's flux step
    for mode in ("flux", "xla", "decomposed"):
        lm, canm, cf, cb, hm = rank_grads(mode, scatter_axis="hidden")
        for c in (cf, cb):
            check(c["ag_gemm"] == 0 and c["gemm_rs"] == 0,
                  f"hidden {mode} step launched the fused kernels: {c}")
        rl = abs(lm - loss4) / abs(loss4)
        rg, lf = _worst_leaf(canm, can4)
        check(rl <= TRAIN_LOSS_RTOL and rg <= TRAIN_GRAD_RTOL,
              f"hidden {mode} vs the seq layout's flux: loss relative {rl}, "
              f"grad of {lf} relative L2 {rg}")
        res[f"tp4_hidden_{mode}"] = {
            "step0_loss": lm, "loss_rel_vs_seq_flux": rl,
            "grad_rel_l2_vs_seq_flux_max": rg, "grad_worst_leaf": lf,
            "step0_host": hm, "peak_gb_seq_flux": host4["peak_gb"],
            "launches": {"forward": cf, "backward": cb}}
        del canm
    del can4
    torch.cuda.empty_cache()

    # the main path, part 2: 3 trainer steps in flux mode
    zero_counts()
    _, opts, hist4 = tr4.train(ranks, opts)
    torch.cuda.synchronize()
    counts = read_counts()
    want = {k: TRAIN_STEPS * (want_fwd[k] + want_bwd[k]) for k in want_fwd}
    check(counts == want, f"{TRAIN_STEPS} flux steps launched {counts}, "
          f"expected {want}")
    losses4 = [h["loss"] for h in hist4]
    check(all(map(math.isfinite, losses4)),
          f"tp={tp} losses {losses4}")
    res["tp4_flux"].update(
        losses=losses4, step_ms_median=step_ms(hist4)[0],
        step_ms=step_ms(hist4)[1], trainer_launches=counts,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    res["tp4_flux"]["profiled_step"] = device_profile(
        torch, lambda: tr4.run_step(ranks, opts, [batch0]),
        sums={"ag_gemm_ms": "ag_gemm", "gemm_rs_ms": "gemm_rs"})
    res["tape_backward_scaling"] = tape_backward_scaling(torch)
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    del ranks, opts, tr4
    group.free_symmetric()
    torch.cuda.empty_cache()
    return {"forward": c_fwd, "backward": c_bwd, "trainer_steps": counts,
            "backward_remat": res["remat_tp4_flux"]["launches_backward"],
            "losses": losses4}


def phase_dp_lane(torch, train_losses):
    """Data parallelism on a rank mesh: minicpm_2b at full width cut to
    the train lane's TRAIN_LAYERS layers, its 4 x 1024 global tokens, bf16
    weights from seed 0, flux.  Step 0 at dp=2 x tp=2 (the mesh's two TP
    groups run the fused kernels at once, each rank on its 2 x 1024
    shard; the grads through the port's ZeRO-1 sync) against dp=1 x tp=2
    on the same global batch: the loss within TRAIN_LOSS_RTOL, every
    canonical grad (/ tp on both sides) within TRAIN_GRAD_RTOL; the fused
    launches its PlanSet implies per TP group.  The int8 pod all-reduce on
    those grads at pods=2 x dp=1 x tp=2 (``adamw.sync_grads``, compressed
    against uncompressed, within POD_INT8_RTOL), then one ``Trainer`` step
    there with ``grad_compress`` and one without, from the same weights
    (put back after each): the updates within POD_INT8_UPDATE_RTOL.  Then
    3 ``Trainer`` steps at dp=2 x tp=2 from seed 0's weights (the main
    path): losses within TRAIN_LOSS_RTOL of ``train_losses`` (the train
    lane's tp=4 trainer: the same weights and global batches), host ms a
    step, each rank's ZeRO-1 moment bytes against dp=1's, peak memory, a
    profiled step's busy share.  ZeRO-3 on the same mesh, weights and
    shards (``zero3``: every layer's wqkv and packed w13 split over data,
    gathered a layer at a time): step 0's loss equal to ZeRO-1's, each
    ZeRO-3 leaf's synced grad dp x ZeRO-1's within TRAIN_GRAD_RTOL (the
    gather's summing transpose, the reference's contract), every other
    leaf equal to ZeRO-1's; the launches its PlanSet implies; each rank's
    bytes of the ZeRO-3 leaves exactly 1/dp of ZeRO-1's; then 3
    ``Trainer`` steps from seed 0's weights, their losses within
    TRAIN_LOSS_RTOL of the ZeRO-1 trainer's, peak memory beside it."""
    from repro_torch.configs.base import (ParallelConfig, get_config,
                                          train_schedule)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.runtime import trainer as T

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("minicpm_2b"),
                              num_layers=TRAIN_LAYERS)
    tp, dp = DP_LANE
    par1 = ParallelConfig(tp=tp, fuse_w13=True, overlap_mode="flux")
    par2 = dataclasses.replace(par1, dp=dp)

    def trainer(par, steps):
        tc = T.TrainConfig(total_steps=steps, warmup_steps=0, base_lr=3e-4,
                           schedule=train_schedule("minicpm_2b"),
                           log_every=steps)
        tr = T.Trainer(cfg, par, tc, device="cuda", dtype=torch.bfloat16)
        tr.data_cfg = dataclasses.replace(tr.data_cfg, seq_len=TRAIN_SEQ,
                                          global_batch=TRAIN_BATCH)
        return tr

    res = {"phase": "dp_lane", "arch": cfg.name,
           "layers": f"{TRAIN_LAYERS} of 40 (cut in depth)",
           "mesh": {"dp": dp, "tp": tp}, "mode": "flux",
           "global_batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "loss_rtol": TRAIN_LOSS_RTOL, "grad_rtol": TRAIN_GRAD_RTOL,
           "pod_int8_rtol": POD_INT8_RTOL,
           "pod_int8_update_rtol": POD_INT8_UPDATE_RTOL,
           "baseline_mem_gb": torch.cuda.memory_allocated() / 1e9}
    trd = trainer(par2, TRAIN_STEPS)
    mesh = trd.group
    ranks, _ = trd.init_state()          # 2 replicas of the tp=2 copies
    batch0 = trd.batch(0)

    # ---- step 0: dp=1 x tp=2 on the global batch, then dp=2 x tp=2 ------
    tr1 = trainer(par1, 1)
    loss1, can1, _, _, host1 = step0(torch, cfg, par1, tr1.group,
                                     ranks[:tp], [batch0])
    tr1.group.free_symmetric()
    del tr1
    grads = []
    loss2, can2, c_fwd, c_bwd, host2 = step0(
        torch, cfg, par2, mesh, ranks, trd.step_batch(0), grads_out=grads)
    plans = T.make_ctx(cfg, par2, mesh=mesh, rank=0).plans
    want_fwd, want_bwd = (
        {k: v * dp for k, v in c.items()}
        for c in plan_launches(plans, cfg, tp, mlp_weights=1))
    check(c_fwd == want_fwd and c_bwd == want_bwd,
          f"dp={dp} x tp={tp} flux step 0 launches {c_fwd} / {c_bwd}, its "
          f"PlanSet implies {want_fwd} / {want_bwd}")
    rel_loss = abs(loss2 - loss1) / abs(loss1)
    rel_g, leaf = _worst_leaf(can2, can1)
    check(rel_loss <= TRAIN_LOSS_RTOL and rel_g <= TRAIN_GRAD_RTOL,
          f"dp={dp} step 0 vs dp=1: loss {loss2} vs {loss1} (relative "
          f"{rel_loss}), grad of {leaf} relative L2 {rel_g}")
    res["step0"] = {"loss_dp1": loss1, "loss_dp2": loss2,
                    "loss_rel_vs_dp1": rel_loss,
                    "grad_rel_l2_vs_dp1_max": rel_g, "grad_worst_leaf": leaf,
                    "launches_forward": c_fwd, "launches_backward": c_bwd,
                    "launches_planset": [want_fwd, want_bwd],
                    "host_dp1": host1, "host_dp2": host2}
    del can1
    mesh.free_symmetric()

    # ---- ZeRO-3 step 0: the same mesh, weights and shards ----------------
    par3 = dataclasses.replace(par2, zero3=True)
    trz = trainer(par3, TRAIN_STEPS)
    ranks3 = trz.place(ranks[:tp])       # each rank's pieces, seed 0's
    flagged = M.zero3_leaves(cfg, par3)
    z3_bytes = [sum(dict(p.named_parameters())[n].nbytes for n in flagged)
                for p in ranks3]
    z1_bytes = [sum(dict(p.named_parameters())[n].nbytes for n in flagged)
                for p in ranks]
    check(all(b1 == dp * b3 for b1, b3 in zip(z1_bytes, z3_bytes)),
          f"ZeRO-3 leaf bytes a rank {z3_bytes}, ZeRO-1's {z1_bytes}: not "
          f"1/{dp}")
    loss3, can3, c_fwd3, c_bwd3, host3 = step0(
        torch, cfg, par3, trz.group, ranks3, trd.step_batch(0))
    check(c_fwd3 == want_fwd and c_bwd3 == want_bwd,
          f"ZeRO-3 step 0 launches {c_fwd3} / {c_bwd3}, its PlanSet implies "
          f"{want_fwd} / {want_bwd}")

    def flagged_leaf(n):            # canonical names: w13 -> w1 and w3
        base = n.rsplit(".", 1)[0]
        return n in flagged or (n.endswith((".w1", ".w3"))
                                and base + ".w13" in flagged)
    rel_z = {n: _rel_l2(can3[n], dp * can2[n]) for n in can3
             if flagged_leaf(n)}
    others = [n for n in can3 if not flagged_leaf(n)]
    rel_o = {n: _rel_l2(can3[n], can2[n]) for n in others}
    equal_o = sum(bool(torch.equal(can3[n], can2[n])) for n in others)
    worst_z = max(rel_z, key=rel_z.get)
    worst_o = max(rel_o, key=rel_o.get)
    res["zero3"] = {"flagged": sorted(flagged), "leaves": len(can3),
                    "step0": {"loss": loss3, "loss_zero1": loss2,
                              "loss_equal": loss3 == loss2,
                              "grad_rel_l2_vs_dp_x_zero1_max":
                                  rel_z[worst_z],
                              "grad_worst_leaf": worst_z,
                              "other_leaves_bit_equal":
                                  f"{equal_o}/{len(others)}",
                              "other_rel_l2_max": rel_o[worst_o],
                              "other_worst_leaf": worst_o,
                              "launches_forward": c_fwd3,
                              "launches_backward": c_bwd3,
                              "host": host3},
                    "leaf_bytes_a_rank": z3_bytes,
                    "leaf_bytes_a_rank_zero1": z1_bytes,
                    "weight_bytes_a_rank": [
                        sum(t.nbytes for t in p.parameters())
                        for p in ranks3],
                    "weight_bytes_a_rank_zero1": [
                        sum(t.nbytes for t in p.parameters())
                        for p in ranks]}
    check(loss3 == loss2, f"ZeRO-3 step-0 loss {loss3} != ZeRO-1's {loss2}")
    check(rel_z[worst_z] <= TRAIN_GRAD_RTOL,
          f"ZeRO-3 grad of {worst_z} vs dp x ZeRO-1's: relative L2 "
          f"{rel_z[worst_z]}")
    check(equal_o == len(others),
          f"ZeRO-3 grads of {len(others) - equal_o} unflagged leaves differ "
          f"from ZeRO-1's (worst {worst_o}: relative L2 {rel_o[worst_o]})")
    del can2, can3, ranks3
    trz.group.free_symmetric()

    # ---- the int8 pod all-reduce at pods=2 x dp=1 on those grads --------
    podm = make_mesh(dp, 1, tp, "cuda")
    plan = T.zero1_plan(cfg, ranks[0], 1)

    def synced(compress):
        out = podm.spmd(lambda g: adamw.sync_grads(
            g, plan, None, podm.group("pod"), compress),
            [(g,) for g in grads])
        glob = M.gather_rank_leaves(out[:tp], cfg, ranks[0])
        return {n: g / tp for n, g in
                M.canonical_leaves(glob, cfg, tp, grads=True).items()}

    plain = synced(False)
    rel_c, leaf_c = _worst_leaf(synced(True), plain)
    del plain, grads, podm
    check(rel_c <= POD_INT8_RTOL,
          f"the int8 pod sync's grad of {leaf_c}: relative L2 {rel_c} from "
          f"the fp32 sync's > {POD_INT8_RTOL}")
    fp32_bytes = 4 * sum(p.numel() for p in ranks[0].parameters())
    pieces = {}             # a reference leaf's local piece: one payload
    for n, p in ranks[0].named_parameters():
        pieces[plan[n].stack] = pieces.get(plan[n].stack, 0) + p.numel()
    blocks = sum(-(-k // adamw.QUANT_BLOCK) for k in pieces.values())
    res["pod_int8"] = {"grad_rel_l2_vs_fp32_max": rel_c,
                       "grad_worst_leaf": leaf_c,
                       "wire_bytes_a_rank": blocks * (adamw.QUANT_BLOCK + 4),
                       "fp32_bytes_a_rank": fp32_bytes}
    torch.cuda.empty_cache()

    # ---- one Trainer step at pods=2 x dp=1, with grad_compress and ------
    # without, each from the same weights (put back after it: the trainer
    # below starts from seed 0's, as the train lane's)
    saved = [[t.detach().clone() for t in p.parameters()] for p in ranks]

    def pod_step(compress):
        trp = trainer(dataclasses.replace(par1, pods=dp,
                                          grad_compress=compress), 1)
        zero_counts()
        _, _, hist = trp.train(ranks, [trp.init_opt(p, r)
                                       for r, p in enumerate(ranks)])
        torch.cuda.synchronize()
        counts = read_counts()
        trp.group.free_symmetric()
        new = [[t.detach().clone() for t in p.parameters()]
               for p in ranks[:tp]]        # pod 0's TP ranks
        with torch.no_grad():
            for p, ts in zip(ranks, saved):
                for t, v in zip(p.parameters(), ts):
                    t.copy_(v)
        return hist[0], counts, new

    hp, cp, new_c = pod_step(True)
    hu, cu, new_u = pod_step(False)
    want_p = {k: want_fwd[k] + want_bwd[k] for k in want_fwd}
    diff2 = ref2 = 0.0
    for i in range(tp):
        for w0, wc, wu in zip(saved[i], new_c[i], new_u[i]):
            du = wu.float() - w0.float()
            diff2 += (wc.float() - w0.float() - du).square().sum().item()
            ref2 += du.square().sum().item()
    rel_u = math.sqrt(diff2 / max(ref2, 1e-30))
    del new_c, new_u, saved
    rel_p = abs(hp["loss"] - loss2) / abs(loss2)
    check(cp == want_p and cu == want_p and rel_p <= TRAIN_LOSS_RTOL
          and rel_u <= POD_INT8_UPDATE_RTOL,
          f"pods={dp} steps: launches {cp} / {cu} (expected {want_p}), "
          f"loss {hp['loss']} / {hu['loss']} vs dp={dp}'s {loss2}, the "
          f"compressed update's relative L2 from the fp32 one {rel_u}")
    res["pods_compress_step"] = {"loss": hp["loss"],
                                 "loss_rel_vs_dp2_step0": rel_p,
                                 "loss_fp32_step": hu["loss"],
                                 "update_rel_l2_vs_fp32": rel_u,
                                 "step_ms": hp["seconds"] * 1e3,
                                 "step_ms_fp32": hu["seconds"] * 1e3,
                                 "launches": cp}
    torch.cuda.empty_cache()

    # ---- the main path: 3 Trainer steps at dp=2 x tp=2 ------------------
    opts = [trd.init_opt(p, r) for r, p in enumerate(ranks)]
    torch.cuda.reset_peak_memory_stats()
    start_gb = torch.cuda.memory_allocated() / 1e9
    zero_counts()
    _, opts, hist = trd.train(ranks, opts)
    torch.cuda.synchronize()
    counts = read_counts()
    want = {k: TRAIN_STEPS * v for k, v in want_p.items()}
    losses = [h["loss"] for h in hist]
    rel_t = [abs(x - y) / abs(y) for x, y in zip(losses, train_losses)]
    check(counts == want and len(losses) == len(train_losses)
          and max(rel_t) <= TRAIN_LOSS_RTOL,
          f"{TRAIN_STEPS} dp={dp} steps: launches {counts} (expected "
          f"{want}), losses {losses} vs the tp={TP_LANE} train lane's "
          f"{train_losses}")
    ms = sorted(h["seconds"] * 1e3 for h in hist)
    zplan = trd.zero1(ranks[0])
    split = [n for n, z in zplan.items() if z.rows or z.owner is not None]
    named = dict(ranks[0].named_parameters())
    dp1_split = 8 * sum(named[n].numel() for n in split)
    dp1_all = 8 * sum(t.numel() for t in named.values())
    moment_bytes = [sum(t.numel() * t.element_size() for k in ("mu", "nu")
                        for t in o[k].values()) for o in opts]
    split_bytes = [sum(o[k][n].numel() * o[k][n].element_size()
                       for k in ("mu", "nu") for n in split if n in o[k])
                   for o in opts]
    res["trainer"] = {
        "losses": losses, "train_lane_tp4_losses": train_losses,
        "loss_rel_vs_train_lane": rel_t,
        "step_ms_median": ms[len(ms) // 2],
        "step_ms": [h["seconds"] * 1e3 for h in hist],
        "launches": counts,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "start_mem_gb": start_gb,
        "moment_bytes_a_rank": moment_bytes,
        "moment_bytes_dp1_a_rank": dp1_all,
        "split_leaves": len(split), "whole_leaves": len(zplan) - len(split),
        "split_moment_bytes_a_rank": split_bytes,
        "split_moment_bytes_dp1": dp1_split,
        "split_share_vs_dp1": [b / dp1_split for b in split_bytes]}
    check(all(abs(b / dp1_split - 1 / dp) <= 0.1 for b in split_bytes),
          f"ZeRO-1 moment bytes {split_bytes} of dp=1's {dp1_split}")
    res["trainer"]["profiled_step"] = device_profile(
        torch, lambda: trd.run_step(ranks, opts, trd.step_batch(0)),
        sums={"ag_gemm_ms": "ag_gemm", "gemm_rs_ms": "gemm_rs"})
    mesh.free_symmetric()
    del ranks, opts, trd, named
    torch.cuda.empty_cache()

    # ---- ZeRO-3: 3 Trainer steps from seed 0's weights -------------------
    # (drawn again: ZeRO-1's trainer ran without ZeRO-3 copies beside it)
    ranks3, opts3 = trz.init_state()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start3_gb = torch.cuda.memory_allocated() / 1e9
    zero_counts()
    _, opts3, hist3 = trz.train(ranks3, opts3)
    torch.cuda.synchronize()
    counts3 = read_counts()
    losses3 = [h["loss"] for h in hist3]
    rel_3 = [abs(x - y) / abs(y) for x, y in zip(losses3, losses)]
    check(counts3 == want and len(losses3) == len(losses)
          and max(rel_3) <= TRAIN_LOSS_RTOL,
          f"{TRAIN_STEPS} ZeRO-3 steps: launches {counts3} (expected "
          f"{want}), losses {losses3} vs ZeRO-1's {losses}")
    ms3 = sorted(h["seconds"] * 1e3 for h in hist3)
    res["zero3"]["trainer"] = {
        "losses": losses3, "loss_rel_vs_zero1": rel_3,
        "step_ms": [h["seconds"] * 1e3 for h in hist3],
        "step_ms_median": ms3[len(ms3) // 2], "launches": counts3,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "start_mem_gb": start3_gb,
        "peak_above_start_gb": (torch.cuda.max_memory_allocated() / 1e9
                                - start3_gb),
        "peak_above_start_gb_zero1": (res["trainer"]["peak_mem_gb"]
                                      - res["trainer"]["start_mem_gb"]),
        "peak_mem_gb_zero1": res["trainer"]["peak_mem_gb"]}
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    trz.group.free_symmetric()
    del ranks3, opts3, trz
    torch.cuda.empty_cache()
    return {"step0_forward": c_fwd, "step0_backward": c_bwd,
            "pods_compress_step": cp, "trainer_steps": counts,
            "zero3_step0_forward": c_fwd3, "zero3_step0_backward": c_bwd3,
            "zero3_trainer_steps": counts3}


def mla_train_cfg():
    """deepseek_v3_671b at full width cut as the mla train lane cuts it
    (MLA_TRAIN_LAYERS layers, MLA_TRAIN_EXPERTS routed experts)."""
    from repro_torch.configs.base import get_config
    cfg = get_config("deepseek_v3_671b")
    return dataclasses.replace(
        cfg, num_layers=MLA_TRAIN_LAYERS,
        moe=dataclasses.replace(cfg.moe, num_experts=MLA_TRAIN_EXPERTS))


class capture_routes:
    """Records the MoE router's decisions while it is active: each call of
    ``models.ffn._route`` appends (the rank: its mesh rank, or -1 at one
    rank; probs [t, E] fp32, the top-k experts [t, k]) to ``calls``, on
    the host."""

    def __enter__(self):
        from repro_torch.models import ffn
        self.calls, self._route = [], ffn._route

        def route(p, ht, mc, axis=None):
            probs, gate, eidx = self._route(p, ht, mc, axis)
            rank = (-1 if axis is None else axis.mesh.rank()
                    if axis.mesh is not None else axis.rank())
            self.calls.append((rank,
                               probs.detach().float().cpu(),
                               eidx.detach().cpu()))
            return probs, gate, eidx
        ffn._route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import ffn
        ffn._route = self._route
        return False


def rank_routes(torch, calls, batch=None):
    """``capture_routes``' calls, one a rank (a rank's MoE layers in order)
    -> (probs, top-k) of every token: the ranks' rows in rank order; with
    ``batch`` each rank's rows are its sequence shard of ``batch`` rows,
    put back in token order."""
    cs = sorted(calls, key=lambda c: c[0])

    def whole(i):
        if batch is None:
            return torch.cat([c[i] for c in cs])
        width = cs[0][i].shape[-1]
        return torch.cat([c[i].reshape(batch, -1, width) for c in cs],
                         dim=1).reshape(-1, width)
    return whole(1), whole(2)


def moe_layer_grads(torch, cfg, group, ranks, seed=9):
    """The MoE layer's backward at full width on identical inputs: the
    lane's MoE layer (without its shared expert, drop-free) at tp=1 over
    the ranks' experts joined, and at tp=group.n in flux on the same
    seeded input and output cotangent (x [batch, seq, D] bf16, each rank
    its sequence shard): relative L2 against tp=1's of each rank's
    experts' grads, of the router's and the norm's summed over the ranks
    (each rank's is its shard's share), and of the input's; and the tokens
    routed elsewhere."""
    from repro_torch.core.overlap import SeamTape
    from repro_torch.models import ffn
    from repro_torch.parallel.sharding import TPContext
    tp = group.n
    names = ("router", "norm", "w1", "w3", "w2")
    per_rank = [{n: r.layers[-1].ffn[n].detach() for n in names}
                for r in ranks]
    whole = {n: (torch.cat([p[n] for p in per_rank])
                 if n in ("w1", "w3", "w2") else per_rank[0][n])
             for n in names}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    shape = (MLA_TRAIN_BATCH, MLA_TRAIN_SEQ, cfg.d_model)
    x = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    probe = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    s_loc = MLA_TRAIN_SEQ // tp

    def grads(p, xs, pr, ctx):
        leaves = {n: t.clone().requires_grad_() for n, t in p.items()}
        xs = xs.clone().requires_grad_()
        with SeamTape() as tape:
            y, _ = ffn.moe_train(leaves, xs, ctx, cfg, cfg.norm_eps)
            loss = (y.float() * pr.float()).sum()
        tape.backward(loss)
        return xs.grad, {n: leaves[n].grad for n in names}

    with capture_routes() as rt:
        g1x, g1 = grads(whole, x, probe, TPContext())
        ctx = TPContext(tp=tp, group=group, mode="flux")
        outs = group.spmd(
            lambda p, r: grads(p, x[:, r * s_loc:(r + 1) * s_loc],
                               probe[:, r * s_loc:(r + 1) * s_loc], ctx),
            [(p, r) for r, p in enumerate(per_rank)])
    g4x = torch.cat([o[0] for o in outs], dim=1)
    e_loc = whole["w1"].shape[0] // tp
    rel = {n: max(_rel_l2(o[1][n], g1[n][r * e_loc:(r + 1) * e_loc])
                  for r, o in enumerate(outs)) for n in ("w1", "w3", "w2")}
    for n in ("router", "norm"):
        rel[n] = _rel_l2(sum(o[1][n].float() for o in outs), g1[n])
    rel["x"] = _rel_l2(g4x, g1x)
    return {"input": "seeded x and output cotangent, bf16",
            "grad_rel_l2_vs_tp1": rel,
            "routing": _routing_vs(torch, [
                (*rank_routes(torch, rt.calls[1:], MLA_TRAIN_BATCH),
                 *rt.calls[0][1:])])}


def a2a_fwd_bwd_ms(torch, group, ranks, cap, calls=5, axes=None):
    """The MoE layer's ``moe_a2a`` op alone, forward and backward, at the
    lane's buffer (x [ep, E/ep, cap, D] bf16 a rank, the rank's experts as
    leaves that take grads), ``xla`` (barrier exchanges) and ``flux`` (the
    shift ring): host ms a call each way (``calls`` calls inside one
    ``spmd``; each backward's forward recorded beforehand) and the summed
    device ms of one profiled call, forward alone and forward with
    backward (the backward's device ms their difference).  The op runs
    over ``group`` (its ranks the EP group), or with ``axes`` over each
    rank's view ``group.group(axes)`` of the mesh ``group``."""
    from repro_torch.core.overlap import Epilogue, FusedOp, SeamTape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    views = [group if axes is None else group.group(axes, r)
             for r in range(len(ranks))]
    tp = views[0].n
    args = []
    for rank in ranks:
        f = rank.layers[-1].ffn
        ws = [f[k].detach().requires_grad_() for k in ("w1", "w3", "w2")]
        shape = (tp, ws[0].shape[0], cap, ws[0].shape[1])
        args.append((torch.randn(shape, generator=gen,
                                 device="cuda").bfloat16(), ws,
                     torch.randn(shape, generator=gen,
                                 device="cuda").bfloat16()))
    out = {"shape_a_rank": list(args[0][0].shape), "calls": calls}
    for mode in ("xla", "flux"):
        ops = [FusedOp("a2a", Epilogue(activation="silu", gate="pair"), 3,
                       axis=v, mode=mode) for v in views]

        def forward(x, ws, g):
            with torch.no_grad():
                return ops[group.rank()](x, *ws)

        def record(x, ws, g):
            with torch.enable_grad(), SeamTape() as tape:
                y = ops[group.rank()](x, *ws)
            return tape, y

        def backward(tape, y, g, ws):
            tape.backward(y, g)
            for w in ws:
                w.grad = None

        def both(x, ws, g):
            backward(*record(x, ws, g), g, ws)

        fwd_ms, _ = wall_ms(torch, lambda: group.spmd(
            lambda *a: [forward(*a) for _ in range(calls)], args), repeats=3)
        bwd = []
        for _ in range(3):
            tapes = group.spmd(
                lambda *a: [record(*a) for _ in range(calls)], args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            group.spmd(lambda ts, x, ws, g: [backward(t, y, g, ws)
                                             for t, y in ts],
                       [(t,) + a for t, a in zip(tapes, args)])
            torch.cuda.synchronize()
            bwd.append((time.perf_counter() - t0) * 1e3)
            del tapes
        prof_f = device_profile(torch, lambda: group.spmd(forward, args))
        prof_b = device_profile(torch, lambda: group.spmd(both, args))
        out[mode] = {"forward_host_ms": fwd_ms / calls,
                     "backward_host_ms": sorted(bwd)[1] / calls,
                     "forward_device_ms": prof_f["device_ms"],
                     "forward_backward_device_ms": prof_b["device_ms"],
                     "backward_device_ms": (prof_b["device_ms"]
                                            - prof_f["device_ms"]),
                     "forward_busy_share": prof_f["device_busy_share"],
                     "forward_backward_busy_share":
                         prof_b["device_busy_share"]}
    del args
    return out


def phase_mla_train_lane(torch):
    """deepseek_v3_671b trained through MLA, MoE and its MTP head at full
    width, cut to MLA_TRAIN_LAYERS layers and MLA_TRAIN_EXPERTS routed
    experts (``reduced``), bf16 weights from seed 0, fp32 moments, batch
    MLA_TRAIN_BATCH x MLA_TRAIN_SEQ: step 0 drop-free at tp=1 (its
    canonical grads kept on the host), then at tp=4 on the one card in
    flux (the main path: its fused launches, forward and backward, equal
    to what its PlanSet implies; its loss and every canonical grad / 4
    against tp=1's but the routed experts', whose tokens move between
    experts at the router's near ties; every token routed elsewhere a
    near tie, ``_routing_vs``) and in xla against flux, every leaf; 3
    ``Trainer`` steps at tp=4 in flux at the config's capacity factor
    (losses, step ms, each rank's dropped assignments, peak memory, a
    profiled step); the routed experts' grads against tp=1 on identical
    inputs (``moe_layer_grads``); the ``moe_a2a`` op alone forward and
    backward; the measured sweep of the lane's ``moe_a2a`` cell beside the
    analytic winner on ``ect.H100_SXM``.
    Returns the fused launches of the tp=4 flux step and of the trainer's
    steps."""
    from repro_torch.configs.base import (MOE_FFN, ParallelConfig,
                                          train_schedule)
    from repro_torch.core import ect
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.dist import RankGroup
    from repro_torch.models import ffn
    from repro_torch.models import model as M
    from repro_torch.runtime import trainer as T
    from repro_torch.tuning import autotune as AT

    t_phase = time.perf_counter()
    cfg = mla_train_cfg()
    cfg_df = drop_free(cfg)
    tp, bf16 = MLA_TP, torch.bfloat16
    tc = T.TrainConfig(total_steps=MLA_TRAIN_STEPS, warmup_steps=0,
                       base_lr=3e-4, schedule=train_schedule(cfg.name),
                       log_every=MLA_TRAIN_STEPS)
    res = {"phase": "mla_train_lane", "arch": cfg.name, "tp": tp,
           "reduced": {"num_layers": f"{cfg.num_layers} of 61 (3 MLA + "
                                     "dense FFN, 1 MLA + MoE; the MTP head "
                                     "kept)",
                       "num_experts": f"{MLA_TRAIN_EXPERTS} of 256 "
                                      f"({MLA_TRAIN_EXPERTS // tp} a rank, "
                                      "top-8 kept)"},
           "batch": MLA_TRAIN_BATCH, "seq": MLA_TRAIN_SEQ,
           "steps": MLA_TRAIN_STEPS, "schedule": tc.schedule,
           "dtype": "bfloat16 weights, float32 moments",
           "loss_rtol": TRAIN_LOSS_RTOL, "grad_rtol": TRAIN_GRAD_RTOL,
           "drop_free_capacity_factor": MLA_DROP_FREE_CF,
           "capacity_factor": cfg.moe.capacity_factor,
           "ln_vocab": math.log(cfg.vocab_size),
           "baseline_mem_gb": torch.cuda.memory_allocated() / 1e9}
    batch0 = {k: torch.from_numpy(v).cuda() for k, v in batch_at(
        DataConfig(cfg.vocab_size, MLA_TRAIN_SEQ, MLA_TRAIN_BATCH), 0).items()}

    # ---- tp=1: step 0 drop-free, its canonical grads on the host ----------
    par1 = ParallelConfig(fuse_w13=True)
    torch.cuda.reset_peak_memory_stats()
    p1 = M.init_model(cfg, par1, seed=0, dtype=bf16, device="cuda",
                      trainable=True)
    res["weights"] = sum(p.numel() for p in p1.parameters())
    res["weights_mtp"] = sum(p.numel() for p in p1.mtp.parameters())
    ffn.dropped.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with capture_routes() as rt1:
        loss1, g1 = T.loss_and_grads(p1, batch0, T.make_ctx(cfg_df, par1),
                                     cfg_df, par1)
    torch.cuda.synchronize()
    res["tp1"] = {"step0_loss": loss1.item(),
                  "step0_host_ms": (time.perf_counter() - t0) * 1e3,
                  "step0_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                  "dropped_assignments": ffn.drop_totals()}
    check(ffn.drop_totals() == [0], f"the tp=1 drop-free step dropped "
          f"{ffn.drop_totals()} MoE assignments")
    check(math.isfinite(res["tp1"]["step0_loss"]), f"tp=1 loss {loss1}")
    can1 = {n: t.to("cpu") for n, t in
            M.canonical_leaves(g1, cfg, 1, grads=True).items()}
    del p1, g1
    torch.cuda.empty_cache()

    # ---- tp=4 step 0 in flux (the main path) and in xla, drop-free ----------
    par4 = ParallelConfig(tp=tp, fuse_w13=True, overlap_mode="flux")
    tr4 = T.Trainer(cfg, par4, tc, device="cuda", dtype=bf16)
    tr4.data_cfg = dataclasses.replace(tr4.data_cfg, seq_len=MLA_TRAIN_SEQ,
                                       global_batch=MLA_TRAIN_BATCH)
    check(all(torch.equal(tr4.batch(0)[k], batch0[k]) for k in batch0),
          "the trainer's first batch is not the tp=1 step's")
    mesh = tr4.group
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    full = M.init_model(cfg, par4, seed=0, dtype=bf16, device="cuda",
                        trainable=True)
    ranks = [M.shard_params(full, r, tp, cfg) for r in range(tp)]
    del full
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    res["tp4_init_s"] = time.perf_counter() - t0
    res["tp4_init_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["weights_gb_all_ranks"] = sum(
        p.numel() * p.element_size() for r in ranks
        for p in r.parameters()) / 1e9
    want_fwd, want_bwd = plan_launches(
        T.make_ctx(cfg, par4, mesh=mesh, rank=0).plans, cfg, tp, 1)

    # the routed experts' grads sum over the tokens routed to them and the
    # router's over the gates of the experts chosen: a token whose top-k
    # set differs between the tp degrees (a near tie of the router's
    # probabilities under bf16 noise in the residual stream) moves its
    # share from one expert, and one gate, to another.  These leaves are
    # held against xla's (the same routing) and, in moe_layer_grads,
    # against tp=1 on identical inputs; every other leaf against tp=1
    kinds = M.expanded_pattern(cfg)
    routed = {n for n in can1 if n.startswith("layers.")
              and kinds[int(n.split(".")[1])][1] == MOE_FFN
              and n.split(".")[-1] in ("w1", "w3", "w2", "router")
              and ".shared." not in n}

    def vs_tp1(can):
        rel = {n: _rel_l2(can[n], can1[n].to("cuda")) for n in can1}
        rest = sorted((n for n in rel if n not in routed), key=rel.get,
                      reverse=True)
        return rel[rest[0]], rest[0], {n: rel[n] for n in rest[:8]}, {
            n: rel[n] for n in sorted(routed)}

    ffn.dropped.clear()
    with capture_routes() as rt4:
        loss4, can4, c_fwd, c_bwd, host4 = step0(torch, cfg_df, par4,
                                                 mesh, ranks, [batch0])
    d4 = ffn.drop_totals(tp)
    check(d4 == [0] * tp, f"the tp={tp} drop-free step dropped {d4}")
    check(c_fwd == want_fwd, f"mla train flux forward launches {c_fwd}, "
          f"its PlanSet implies {want_fwd}")
    check(c_bwd == want_bwd, f"mla train flux backward launches {c_bwd}, "
          f"its PlanSet implies {want_bwd}")
    check(set(can4) == set(can1), "tp=4 and tp=1 canonical leaves differ")
    rel_loss = abs(loss4 - loss1.item()) / abs(loss1.item())
    rel_g, leaf, named, experts = vs_tp1(can4)
    routing = _routing_vs(torch, [(*rank_routes(torch, rt4.calls,
                                                MLA_TRAIN_BATCH),
                                   *rt1.calls[0][1:])])
    emit({"phase": "mla_train_lane", "step0_vs_tp1": {
        "loss_tp1": loss1.item(), "loss_tp4_flux": loss4,
        "loss_rel": rel_loss, "grad_rel_l2_worst_leaves": named,
        "routing_dependent_grad_rel_l2": experts, "routing": routing}})
    check(rel_loss <= TRAIN_LOSS_RTOL,
          f"mla train tp={tp} flux step-0 loss {loss4} vs tp=1 "
          f"{loss1.item()}: relative {rel_loss} > {TRAIN_LOSS_RTOL}")
    check(rel_g <= TRAIN_GRAD_RTOL,
          f"mla train tp={tp} flux step-0 grad of {leaf} vs tp=1: relative "
          f"L2 {rel_g} > {TRAIN_GRAD_RTOL}")
    check(routing["changed_not_near_tie"] == 0
          and routing["probs_rel_l2"] <= TRAIN_GRAD_RTOL,
          f"mla train tp={tp} routing vs tp=1: {routing}")
    del can1
    res["tp4_flux"] = {"step0_loss": loss4, "loss_rel_vs_tp1": rel_loss,
                       "grad_rel_l2_vs_tp1_max": rel_g,
                       "grad_worst_leaf": leaf,
                       "grad_rel_l2_vs_tp1_worst_leaves": named,
                       "routing_dependent_grad_rel_l2_vs_tp1": experts,
                       "routing_vs_tp1": routing,
                       "dropped_assignments_per_rank": d4,
                       "launches_forward": c_fwd, "launches_backward": c_bwd,
                       "launches_planset": {"forward": want_fwd,
                                            "backward": want_bwd},
                       "step0_host": host4}
    can4 = {n: t.cpu() for n, t in can4.items()}
    torch.cuda.empty_cache()
    lx, canx, cfx, cbx, hx = step0(
        torch, cfg_df, dataclasses.replace(par4, overlap_mode="xla"), mesh,
        ranks, [batch0])
    for c in (cfx, cbx):
        check(c["ag_gemm"] == 0 and c["gemm_rs"] == 0,
              f"the xla step launched the fused kernels: {c}")
    rl = abs(lx - loss4) / abs(loss4)
    rel_x = {n: _rel_l2(canx[n], can4[n].to("cuda")) for n in can4}
    lf = max(rel_x, key=rel_x.get)
    rg = rel_x[lf]
    check(rl <= TRAIN_LOSS_RTOL and rg <= TRAIN_GRAD_RTOL,
          f"mla train xla vs flux: loss relative {rl}, grad of {lf} "
          f"relative L2 {rg}")
    res["tp4_xla"] = {"step0_loss": lx, "loss_rel_vs_flux": rl,
                      "grad_rel_l2_vs_flux_max": rg, "grad_worst_leaf": lf,
                      "step0_host": hx}
    del can4, canx
    torch.cuda.empty_cache()

    # ---- 3 trainer steps at tp=4 in flux, the config's capacity factor ----
    opts = [tr4.init_opt(p) for p in ranks]
    ffn.dropped.clear()
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    _, opts, hist = tr4.train(ranks, opts)
    torch.cuda.synchronize()
    counts = read_counts()
    want = {k: MLA_TRAIN_STEPS * (want_fwd[k] + want_bwd[k])
            for k in want_fwd}
    check(counts == want, f"{MLA_TRAIN_STEPS} mla train flux steps launched "
          f"{counts}, expected {want}")
    losses = [h["loss"] for h in hist]
    check(all(map(math.isfinite, losses)), f"mla train losses {losses}")
    ms = [h["seconds"] * 1e3 for h in hist]
    res["trainer"] = {
        "losses": losses, "step_ms": ms,
        "step_ms_median": sorted(ms)[len(ms) // 2],
        "dropped_assignments_per_rank": ffn.drop_totals(tp),
        "assignments_per_rank_a_step": (MLA_TRAIN_BATCH * MLA_TRAIN_SEQ // tp
                                        * cfg.moe.top_k),
        "launches": counts,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    torch.cuda.empty_cache()
    res["trainer"]["profiled_step"] = device_profile(
        torch, lambda: tr4.run_step(ranks, opts, [batch0]),
        sums={"ag_gemm_ms": "ag_gemm", "gemm_rs_ms": "gemm_rs"})
    del opts
    mesh.free_symmetric()
    torch.cuda.empty_cache()

    # ---- the routed experts' backward on identical inputs -------------------
    # (op-level calls: a rank group of their own)
    group = RankGroup(tp, "cuda")
    layer = moe_layer_grads(torch, cfg_df, group, ranks)
    rel_e = max(layer["grad_rel_l2_vs_tp1"].values())
    check(rel_e <= TRAIN_GRAD_RTOL
          and layer["routing"]["changed_not_near_tie"] == 0,
          f"the MoE layer's grads at tp={tp} vs tp=1 on identical inputs: "
          f"{layer}")
    res["moe_layer_grads"] = layer
    torch.cuda.empty_cache()

    # ---- the a2a op alone, at the lane's buffer -----------------------------
    cap = ffn._capacity(MLA_TRAIN_BATCH * MLA_TRAIN_SEQ // tp, cfg.moe)
    res["a2a_op"] = a2a_fwd_bwd_ms(torch, group, ranks, cap)
    del ranks
    group.free_symmetric()
    torch.cuda.empty_cache()

    # ---- the measured sweep of the lane's moe_a2a cell ----------------------
    kind, m, n, k = AT.model_seam_shapes(
        cfg, par4, MLA_TRAIN_BATCH * MLA_TRAIN_SEQ)["moe_a2a"]
    t0 = time.perf_counter()
    tuned = AT.tune_seam(kind, m, n, k, tp, hw=ect.H100_SXM, group=group,
                         measure=True, seam="moe_a2a", n_weights=3,
                         epilogue=True, iters=TUNE_ITERS, warmup=TUNE_WARMUP)
    sweep_s = time.perf_counter() - t0
    analytic = AT.tune_seam(kind, m, n, k, tp, hw=ect.H100_SXM,
                            measure=False, seam="moe_a2a", n_weights=3,
                            epilogue=True)
    check(all(r["measured_s"] > 0 for r in tuned.table),
          "an untimed a2a sweep row")

    def plan_of(p):
        return {"mode": p.mode, "comm_chunks": p.comm_chunks,
                "reverse": p.reverse}
    res["a2a_sweep"] = {
        "cell": [kind, m, n, k], "seconds": sweep_s,
        "candidates": len(tuned.table), "iters": TUNE_ITERS,
        "warmup": TUNE_WARMUP,
        "bench_x_a_rank": [tp, AT.A2A_BENCH_E_LOC,
                           max(m // (tp * AT.A2A_BENCH_E_LOC), 1), k],
        "winner": plan_of(tuned.plan), "winner_ms": tuned.plan.measured_s * 1e3,
        "rows_ms": [[r["mode"], r["comm_chunks"], r["reverse"],
                     r["measured_s"] * 1e3] for r in tuned.table],
        "analytic_winner_h100": plan_of(analytic.plan),
        "analytic_winner_ms": analytic.plan.predicted_s * 1e3}
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    del tr4
    torch.cuda.empty_cache()
    return {"forward": c_fwd, "backward": c_bwd, "trainer_steps": counts}


def phase_ep_lane(torch):
    """Expert parallelism on the rank mesh: the mla train lane's
    configuration (``mla_train_cfg``: deepseek_v3_671b at full width, 4
    layers, 16 of 256 routed experts, the MTP head; 2 x 1024 tokens;
    drop-free capacity) at tp=EP_LANE_TP in flux, its weights drawn again
    from seed 0 (that lane's are gone).  Step 0 through the trainer's grad
    completion and sync in three layouts of 4 ranks: (dp 2, tp 2) with
    the experts over "model" (8 a rank), (ep 2, dp 1, tp 2) with a
    dedicated ep axis (8 a rank, whole over "model"), and (dp 2, tp 2)
    with ``ep_over_dp`` (4 a rank over the (data, model) view).  Gates:
    each layout's loss within TRAIN_LOSS_RTOL of the first's, every
    synced canonical grad within TRAIN_GRAD_RTOL (under ``ep_over_dp``
    the routed experts' grads / dp: their ``a2a`` backward sums both data
    shards' tokens and no data mean follows, the reference's contract),
    the routed experts and the router against the near-tie rule when a
    token routes elsewhere; no assignment dropped; the launches each
    PlanSet implies per TP group.  The ``moe_a2a`` op alone over the ep
    view and over the (data, model) view.  No optimizer step: two
    replicas' fp32 moments do not fit beside them (the lane records each
    layout's step-0 peak and the moment bytes it would add).  Returns
    each layout's fused launches of step 0."""
    from repro_torch.configs.base import (MOE_FFN, ParallelConfig,
                                          train_schedule)
    from repro_torch.models import ffn
    from repro_torch.models import model as M
    from repro_torch.runtime import trainer as T

    t_phase = time.perf_counter()
    cfg = mla_train_cfg()
    cfg_df = drop_free(cfg)
    tp, bf16 = EP_LANE_TP, torch.bfloat16
    tc = T.TrainConfig(total_steps=1, warmup_steps=0, base_lr=3e-4,
                       schedule=train_schedule(cfg.name), log_every=1)
    res = {"phase": "ep_lane", "arch": cfg.name, "tp": tp,
           "reduced": "as the mla train lane: 4 of 61 layers, "
                      f"{MLA_TRAIN_EXPERTS} of 256 routed experts",
           "batch": MLA_TRAIN_BATCH, "seq": MLA_TRAIN_SEQ,
           "drop_free_capacity_factor": MLA_DROP_FREE_CF,
           "loss_rtol": TRAIN_LOSS_RTOL, "grad_rtol": TRAIN_GRAD_RTOL,
           "baseline_mem_gb": torch.cuda.memory_allocated() / 1e9}
    torch.cuda.reset_peak_memory_stats()
    par_w = ParallelConfig(tp=tp, fuse_w13=True)
    names = list(M.mesh_specs(cfg, par_w))
    groups = {}
    for n in names:      # a layer's leaves a sync, the embedding alone
        key = (".".join(n.split(".")[:2]) if n.startswith("layers.")
               else n.split(".")[0])
        groups.setdefault(key, []).append(n)
    kinds = M.expanded_pattern(cfg)
    routed = {n for n in names if n.startswith("layers.")
              and kinds[int(n.split(".")[1])][1] == MOE_FFN
              and n.split(".")[-1] in ("w1", "w3", "w2", "router")
              and ".shared." not in n}
    experts = {n for n in routed if not n.endswith("router")}
    base = {}                   # the first layout's canonical grads, host
    base_loss = base_routes = None
    counts = {}
    for name, kw in EP_LANE_LAYOUTS:
        par = ParallelConfig(tp=tp, fuse_w13=True, overlap_mode="flux", **kw)
        tr = T.Trainer(cfg_df, par, tc, device="cuda", dtype=bf16)
        tr.data_cfg = dataclasses.replace(tr.data_cfg, seq_len=MLA_TRAIN_SEQ,
                                          global_batch=MLA_TRAIN_BATCH)
        mesh = tr.group
        # seed 0's weights drawn again for each layout: the global copy is
        # dropped before the step
        t0 = time.perf_counter()
        full = M.init_model(cfg, par_w, seed=0, dtype=bf16, device="cuda",
                            trainable=True)
        ranks = tr.shard(full)
        del full
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        init_s = time.perf_counter() - t0
        ffn.dropped.clear()
        with capture_routes() as rt:
            losses, grads, c_fwd, c_bwd, host = step0_grads(
                torch, cfg_df, par, mesh, ranks, tr.step_batch(0))
        drops = ffn.drop_totals(tp)
        loss = sum(losses[::tp]) / (mesh.size // tp)
        plans = T.make_ctx(cfg_df, par, mesh=mesh, rank=0).plans
        want_f, want_b = ({k: v * (mesh.size // tp) for k, v in c.items()}
                          for c in plan_launches(plans, cfg_df, tp, 1))
        check(c_fwd == want_f and c_bwd == want_b,
              f"ep lane {name}: launches {c_fwd} / {c_bwd}, its PlanSet "
              f"implies {want_f} / {want_b}")
        check(drops == [0] * tp, f"ep lane {name} dropped {drops}")
        n_exp = ranks[0].layers[-1].ffn["w1"].shape[0]
        check(n_exp == MLA_TRAIN_EXPERTS // (
            mesh.size if par.ep_over_dp else 2),
              f"ep lane {name}: {n_exp} experts a rank")
        dp_x = par.dp if par.ep_over_dp else 1
        rel = {}
        for leaves in groups.values():
            can = synced_canonical(torch, cfg_df, par, mesh, ranks, grads,
                                   leaves)
            for n, g in can.items():
                if n in experts and dp_x > 1:
                    g = g / dp_x
                if base_routes is None:
                    base[n] = g.float().cpu()
                else:
                    rel[n] = _rel_l2(g, base[n].to("cuda"))
            del can
        del grads
        torch.cuda.empty_cache()
        params_a_rank = [sum(p.numel() for p in r.parameters())
                         for r in ranks]
        row = {"mesh": dict(zip(mesh.axes, mesh.shape)),
               "experts_a_rank": n_exp, "loss": loss,
               "launches_forward": c_fwd, "launches_backward": c_bwd,
               "launches_planset": [want_f, want_b],
               "dropped_assignments_per_rank": drops,
               "weights_gb_a_rank": [2 * n / 1e9 for n in params_a_rank],
               "fp32_moments_gb_all_ranks": 8 * sum(params_a_rank) / 1e9,
               "init_and_shard_s": init_s, "step0_host": host}
        if base_routes is None:
            base_loss, base_routes = loss, rt.calls
            row["canonical_leaves"] = len(base)
        else:
            routing = _routing_vs(torch, [(*rank_routes(torch, rt.calls),
                                           *rank_routes(torch, base_routes))])
            moved = routing["tokens_routed_elsewhere"] > 0
            strict = {n: r for n, r in rel.items()
                      if not (moved and n in routed)}
            worst = max(strict, key=strict.get)
            rel_loss = abs(loss - base_loss) / abs(base_loss)
            row.update({"loss_rel_vs_first": rel_loss,
                        "grad_rel_l2_max": strict[worst],
                        "grad_worst_leaf": worst,
                        "routed_grad_rel_l2": {n: rel[n]
                                               for n in sorted(routed)},
                        "routing_vs_first": routing,
                        "expert_grads_divided_by": dp_x})
            check(rel_loss <= TRAIN_LOSS_RTOL
                  and strict[worst] <= TRAIN_GRAD_RTOL
                  and routing["changed_not_near_tie"] == 0,
                  f"ep lane {name} vs {EP_LANE_LAYOUTS[0][0]}: loss "
                  f"{loss} vs {base_loss}, grad of {worst} relative L2 "
                  f"{strict[worst]}, routing {routing}")
        if par.ep > 1 or par.ep_over_dp:
            cap = ffn._capacity(MLA_TRAIN_BATCH * MLA_TRAIN_SEQ
                                // mesh.size, cfg.moe)
            row["a2a_op"] = a2a_fwd_bwd_ms(
                torch, mesh, ranks, cap, calls=3,
                axes="ep" if par.ep > 1 else ("data", "model"))
        res[name] = row
        emit({"phase": "ep_lane", "layout": name, **row})
        counts[name] = {"forward": c_fwd, "backward": c_bwd}
        mesh.free_symmetric()
        del ranks, tr, mesh
        torch.cuda.empty_cache()
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del base
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return counts


def phase_pipeline_lane(torch):
    """GPipe over the pod view of a (PIPE_STAGES, 1, 1) mesh
    (``parallel.pipeline.pipeline_forward``, forward only, as the
    reference's): minicpm_2b at full width cut to TRAIN_LAYERS layers,
    bf16 weights from seed 0 at tp=1 with the flash kernel
    (``kernel_decode``), TRAIN_LAYERS / PIPE_STAGES layers a stage, the
    embedded 4 x 1024 tokens in PIPE_MICRO microbatches; the counts set
    to 0 just before and read just after.  Gates: the last stage's output
    within TOL["bfloat16"] relative L2 of the layers run one after
    another on the whole batch (not counted), one flash launch a layer a
    microbatch, ``bubble_fraction`` (4, 4) = 3/7.  Returns the flash
    launches."""
    from repro_torch.configs.base import ParallelConfig, get_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers
    from repro_torch.models import model as M
    from repro_torch.parallel.pipeline import (bubble_fraction,
                                               pipeline_forward)
    from repro_torch.parallel.sharding import make_ctx

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("minicpm_2b"),
                              num_layers=TRAIN_LAYERS)
    par = ParallelConfig(fuse_w13=True, kernel_decode=True)
    ctx = make_ctx(par)
    model = M.init_model(cfg, par, seed=0, dtype=torch.bfloat16,
                         device="cuda")
    kinds = M.expanded_pattern(cfg)
    per = TRAIN_LAYERS // PIPE_STAGES
    tokens = torch.from_numpy(batch_at(DataConfig(
        cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH), 0)["tokens"]).cuda()

    def run_layers(h, lo, hi):
        for i in range(lo, hi):
            h, _ = M._block(model.layers[i], h,
                            ctx.with_layer(M.layer_slot(cfg, i)), cfg,
                            kinds[i])
        return h

    with torch.no_grad():
        x = layers.embed_lookup(model.embed, tokens, ctx).to(torch.bfloat16)
        want = run_layers(x, 0, TRAIN_LAYERS)
    mesh = make_mesh(PIPE_STAGES, 1, 1, "cuda")

    def stage(r):
        pod = mesh.group("pod")
        s = pod.rank()
        with torch.no_grad():
            return pipeline_forward(
                lambda h, t: run_layers(h, s * per, (s + 1) * per), x, pod,
                PIPE_MICRO)

    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    outs = mesh.spmd(stage, [(r,) for r in range(PIPE_STAGES)])
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    rel = _rel_l2(outs[-1], want)
    want_launches = TRAIN_LAYERS * PIPE_MICRO
    bubble = bubble_fraction(PIPE_MICRO, PIPE_STAGES)
    res = {"phase": "pipeline_lane", "arch": cfg.name,
           "layers": f"{TRAIN_LAYERS} of 40 (cut in depth), {per} a stage",
           "stages": PIPE_STAGES, "microbatches": PIPE_MICRO,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "out_rel_l2_vs_sequential": rel, "tol": TOL["bfloat16"],
           "flash_launches": counts["flash_attention"],
           "flash_launches_expected": want_launches,
           "bubble_fraction": bubble, "host_ms": host_ms,
           "other_stages_zero": all(bool((o == 0).all())
                                    for o in outs[:-1])}
    check(rel <= TOL["bfloat16"] and bool(torch.isfinite(outs[-1]).all()),
          f"pipeline output vs sequential: relative L2 {rel}")
    check(counts["flash_attention"] == want_launches,
          f"pipeline flash launches {counts['flash_attention']}, expected "
          f"{want_launches}")
    check(abs(bubble - 3 / 7) < 1e-12 and res["other_stages_zero"],
          f"bubble fraction {bubble}; other stages' outputs zero: "
          f"{res['other_stages_zero']}")
    del outs, want, x, model
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return counts["flash_attention"]


def mesh_serve_cfg():
    """The mesh serve lane's model: llama4_scout_17b_a16e at full width, its
    first MESH_SERVE_LAYERS layers, at the drop-free capacity (splitting
    the batch over data or ep changes which tokens a saturated expert
    evicts)."""
    from repro_torch.configs.base import get_config
    return drop_free(dataclasses.replace(
        get_config("llama4_scout_17b_a16e"), num_layers=MESH_SERVE_LAYERS))


def _flips(torch, got_tokens, want_tokens, got_logits, want_logits, kept):
    """{row: ...} of the rows whose token differs from tp=1's, each with
    tp=1's top-2 margin and the largest logit difference there; ``kept``
    (a list) gains the largest logit difference of every row whose token
    did not change: the noise ``_near_ties_only`` measures."""
    flips = {}
    for row, (g, w) in enumerate(zip(got_tokens, want_tokens)):
        diff = (got_logits[row] - want_logits[row]).abs().max().item()
        if g == w:
            kept.append(diff)
            continue
        top2 = torch.topk(want_logits[row], 2).values
        flips[row] = {"tp1": w, "tp": g,
                      "margin": (top2[0] - top2[1]).item(),
                      "max_abs_diff": diff}
    return flips


def _near_ties_only(what, flips, kept):
    """The near-tie rule of ``_routing_vs`` for tokens: a token may differ
    from tp=1's only where tp=1's top-2 margin is at most twice the noise,
    the largest logit difference of the rows whose token did not change
    (``kept``, from ``_flips``).  (A row's own difference bounds its
    margin by arithmetic whenever its token changes.)"""
    noise = max(kept, default=0.0)
    wide = {k: f["margin"] for k, f in flips.items()
            if f["margin"] > 2 * noise}
    check(not wide, f"{what}: tokens differ from tp=1's at {wide} (tp=1's "
          f"top-2 margins), more than twice the noise {noise} of the "
          f"{len(kept)} rows that kept their tokens")


def phase_mesh_serve_lane(torch):
    """Serving on the rank mesh (``mesh_serve_cfg``: Scout at full width, 2
    of 48 layers, drop-free), held to a tp=1 anchor drawn from seed 0: its
    flash prefill of 4 x 1024 tokens (``MESH_SERVE_LENGTHS``) and 8 decode
    steps.  (a) dp=2 x tp=2 under ZeRO-3 in flux with the kernels: the
    batched prefill, each data rank on its 2 rows, the counts set to 0
    just before and read just after (the launches its PlanSet implies for
    two TP groups of 2), then 8 decode steps teacher-forced on tp=1's
    tokens (no kernel), the last one again under the profiler (its
    device time and busy share); each rank's ZeRO-3 leaf bytes half of
    dp=1 x tp=2's.  (c) The paged Server on that mesh and those ranks: the
    MESH_SERVE_PROMPTS requests together, one at a time, then again
    (prefix reuse); every
    rank's tokens agree (the Server checks each call); first-token logits
    against the tp=1 Server's on the anchor, and bit for bit the same from
    Servers with one more slot (mesh and tp=1).  (b) ep=2 x tp=2: the same
    prefill with the 16 experts over the ep axis (8 a rank, whole over
    "model").  (d) ``launch.serve --dp 2 --tp 2`` (the config's own
    capacity), its first-token logits against the tp=1 Server's.  Logits
    within TP_LANE_RTOL of tp=1's, tokens under the near-tie rule, no MoE
    assignment dropped where the capacity is drop-free.  Returns the
    prefills' kernel launches."""
    import numpy as np
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch.mesh import make_mesh, mesh_coords
    from repro_torch.models import ffn
    from repro_torch.models import model as M
    from repro_torch.models import serve as S
    from repro_torch.parallel.sharding import make_ctx
    from repro_torch.runtime.server import Request, ServeConfig, Server

    t_phase = time.perf_counter()
    cfg = mesh_serve_cfg()
    bf16, tp, vocab = torch.bfloat16, 2, cfg.vocab_size
    b, s = len(MESH_SERVE_LENGTHS), max(MESH_SERVE_LENGTHS)
    res = {"phase": "mesh_serve_lane", "arch": cfg.name,
           "layers": f"{MESH_SERVE_LAYERS} of 48 (cut in depth)",
           "batch": b, "lengths": MESH_SERVE_LENGTHS,
           "decode_steps": MESH_SERVE_DECODE, "tp": tp,
           "capacity_factor": cfg.moe.capacity_factor, "rtol": TP_LANE_RTOL,
           "baseline_mem_gb": torch.cuda.memory_allocated() / 1e9}
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, vocab, (b, s), generator=gen, device="cuda")
    lengths = torch.tensor(MESH_SERVE_LENGTHS, device="cuda")
    s_max = s + MESH_SERVE_DECODE + 1
    par1 = ParallelConfig(fuse_w13=True)

    # the anchor: tp=1, the flash prefill, 8 greedy decode steps
    t0 = time.perf_counter()
    one = M.init_model(cfg, par1, seed=0, dtype=bf16, device="cuda")
    ctx1 = make_ctx(dataclasses.replace(par1, kernel_decode=True))
    ffn.dropped.clear()
    with torch.no_grad():
        lg, caches = S.prefill_logits(one, {"tokens": tokens}, ctx1, cfg,
                                      lengths)
        anchor = {"logits": [lg[:, :vocab].float()],
                  "tokens": [S.vocab_parallel_argmax(lg, vocab)[:, None]]}
        caches = _dense_caches(torch, caches, s_max)
        for step in range(MESH_SERVE_DECODE):
            lg, caches = S.decode_logits(one, caches, anchor["tokens"][-1],
                                         lengths + step, ctx1, cfg)
            anchor["logits"].append(lg[:, :vocab].float())
            anchor["tokens"].append(S.vocab_parallel_argmax(lg, vocab)[:,
                                                                      None])
    del caches, lg
    check(ffn.drop_totals() == [0], f"the tp=1 anchor dropped "
          f"{ffn.drop_totals()} MoE assignments")
    torch.cuda.synchronize()
    res["anchor_s"] = time.perf_counter() - t0

    def ranks_of(par):
        """Seed 0's weights drawn at tp=2 (the same canonical weights) and
        cut into each rank of ``par``'s mesh; the global copy dropped."""
        full = M.init_model(cfg, par, seed=0, dtype=bf16, device="cuda")
        mesh = make_mesh(par.pods, par.dp, par.tp, "cuda", ep=par.ep)
        ranks = [M.mesh_shard(full, cfg, par, mesh_coords(mesh, r))
                 for r in range(mesh.size)]
        del full
        torch.cuda.empty_cache()
        return mesh, ranks

    def rows(mesh, r, par):
        return S.dp_rows(par, b, mesh_coords(mesh, r))

    def joined(outs, mesh, par):
        """[B, vocab] fp32 from the ranks' rows and vocab shards."""
        parts = {}
        for r, o in enumerate(outs):
            parts.setdefault(rows(mesh, r, par).start, []).append(o)
        return torch.cat([torch.cat(parts[i], -1) for i in sorted(parts)]
                         )[:, :vocab].float()

    def prefill(name, par, mesh, ranks):
        """The batched prefill on every rank, counted; its gates against
        the anchor.  Returns (each rank's caches, the launches)."""
        ctxs = [make_ctx(par, mesh=mesh, rank=r) for r in range(mesh.size)]

        def body(p, ctx, r):
            sl = rows(mesh, r, par)
            return S.prefill_logits(p, {"tokens": tokens[sl]}, ctx, cfg,
                                    lengths[sl])

        ffn.dropped.clear()
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        outs = mesh.spmd(body, [(p, c, r) for r, (p, c) in
                                enumerate(zip(ranks, ctxs))])
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        groups = mesh.size // tp
        want = {k: groups * v for k, v in prefill_launches(
            ctxs[0].plans, cfg, tp, 1, True).items()}
        got = {k: counts[k] for k in want}
        check(got == want, f"mesh serve {name}: launches {got}, its PlanSet "
              f"implies {want} for {groups} TP groups")
        drops = ffn.drop_totals(tp)
        check(drops == [0] * tp, f"mesh serve {name} dropped {drops}")
        lg = joined([o[0] for o in outs], mesh, par)
        rel = _rel_l2(lg, anchor["logits"][0])
        kept = []
        flips = _flips(torch, lg.argmax(-1).tolist(),
                       anchor["tokens"][0][:, 0].tolist(), lg,
                       anchor["logits"][0], kept)
        res[name] = {"mesh": dict(zip(mesh.axes, mesh.shape)),
                     "prefill_launches": got, "prefill_host_ms": host_ms,
                     "prefill_logits_rel_l2_vs_tp1": rel,
                     "prefill_token_flips": flips,
                     "weights_gb_a_rank": [
                         sum(t.numel() * t.element_size()
                             for t in p.parameters()) / 1e9 for p in ranks]}
        check(rel <= TP_LANE_RTOL, f"mesh serve {name}: prefill logits "
              f"{rel:.4g} relative L2 from tp=1's (rtol {TP_LANE_RTOL})")
        _near_ties_only(f"mesh serve {name} prefill", flips, kept)
        return [o[1] for o in outs], ctxs, got

    # (a) dp=2 x tp=2, ZeRO-3, flux, kernels on
    t0 = time.perf_counter()
    par = ParallelConfig(tp=tp, dp=2, zero3=True, fuse_w13=True,
                         kernel_decode=True, overlap_mode="flux")
    mesh, ranks = ranks_of(par)
    z3 = M.zero3_leaves(cfg, par)
    tp2 = ParallelConfig(tp=tp, fuse_w13=True)
    dp1 = dict(M.mesh_shard(M.meta_model(cfg, tp2), cfg, tp2,
                            {}).named_parameters())
    want_b = sum(dp1[n].numel() * dp1[n].element_size() for n in z3)
    z3_b = [sum(t.numel() * t.element_size()
                for n, t in p.named_parameters() if n in z3) for p in ranks]
    check(z3 and all(2 * x == want_b for x in z3_b),
          f"ZeRO-3 leaf bytes a rank {z3_b}, dp=1 x tp=2's {want_b}")
    caches, ctxs, launches_a = prefill("dp2_tp2_zero3", par, mesh, ranks)
    res["dp2_tp2_zero3"].update(zero3_leaves=len(z3),
                                zero3_bytes_a_rank=z3_b,
                                zero3_bytes_dp1_tp2=want_b)
    caches = [_dense_caches(torch, c, s_max) for c in caches]
    rels, flips, kept, step_ms = [], {}, [], []
    zero_counts()
    for step in range(MESH_SERVE_DECODE):
        def body(p, c, ctx, r, step=step):
            sl = rows(mesh, r, par)
            return S.decode_logits(p, c, anchor["tokens"][step][sl],
                                   lengths[sl] + step, ctx, cfg)[0]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        outs = mesh.spmd(body, [(p, c, x, r) for r, (p, c, x) in
                                enumerate(zip(ranks, caches, ctxs))])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        lg = joined(outs, mesh, par)
        want = anchor["logits"][step + 1]
        rels.append(_rel_l2(lg, want))
        for row, f in _flips(torch, lg.argmax(-1).tolist(),
                             anchor["tokens"][step + 1][:, 0].tolist(), lg,
                             want, kept).items():
            flips[f"{step}/{row}"] = f
    counts = read_counts()
    # the last step once more under the profiler: its device time and
    # busy share (it rewrites the same cache rows with the same values)
    prof = device_profile(torch, lambda: mesh.spmd(
        body, [(p, c, x, r) for r, (p, c, x) in
               enumerate(zip(ranks, caches, ctxs))]))
    res["dp2_tp2_zero3"].update(
        decode_logits_rel_l2_vs_tp1=rels, decode_token_flips=flips,
        decode_step_host_ms=step_ms,
        decode_step_profile={k: prof[k] for k in (
            "profiled_wall_ms", "device_ms", "device_busy_ms",
            "device_busy_share")},
        decode_launches={k: counts[k] for k in ("ag_gemm", "gemm_rs",
                                                "flash_attention")},
        phase_s=time.perf_counter() - t0)
    check(max(rels) <= TP_LANE_RTOL, f"mesh serve decode logits {rels} "
          f"relative L2 from tp=1's (rtol {TP_LANE_RTOL})")
    check(not any(res["dp2_tp2_zero3"]["decode_launches"].values()),
          "the replicated-layout decode launched a kernel: "
          f"{res['dp2_tp2_zero3']['decode_launches']}")
    _near_ties_only("mesh serve decode", flips, kept)
    del caches

    # (c) the paged Server on that mesh and those ranks
    t0 = time.perf_counter()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, vocab, size=(n,)).astype(np.int32)
               for n in MESH_SERVE_PROMPTS]
    prompts[2][:32] = prompts[1][:32]             # a shared prefix
    sc = ServeConfig(max_batch=len(prompts), max_seq=256, eos_token=-1,
                     max_new_tokens=MESH_SERVE_NEW, block_size=16,
                     prefill_chunk=64)

    def serve(srv, which):
        done = srv.serve([Request(rid=i, prompt=prompts[i]) for i in which])
        check(all(r.done and r.error is None
                  and len(r.output) == MESH_SERVE_NEW for r in done),
              "a mesh Server request did not finish")
        return {r.rid: r.output for r in done}

    zero_counts()
    srv = Server(cfg, par, ranks, sc, mesh=mesh)
    concurrent = serve(srv, range(len(prompts)))
    agree = sum(int(serve(Server(cfg, par, ranks, sc, mesh=mesh), [i])[i]
                    == concurrent[i]) for i in concurrent)
    hits = srv.pool.reuse_hits
    check(serve(srv, range(len(prompts))) == concurrent,
          "the mesh Server's reuse pass gave other tokens")
    reuse = srv.pool.reuse_hits - hits
    counts = read_counts()
    srv1 = Server(cfg, par1, one, sc)
    tp1 = serve(srv1, range(len(prompts)))
    pdict = dict(enumerate(prompts))
    got, want = first_logits(torch, srv, pdict), first_logits(torch, srv1,
                                                              pdict)
    rel = {i: _rel_l2(got[i], want[i]) for i in pdict}
    # the pool's size (max_batch) changes no arithmetic: the same first
    # logits, bit for bit, from Servers with one more slot
    sc_more = dataclasses.replace(sc, max_batch=sc.max_batch + 1)
    more = {"mesh": (got, Server(cfg, par, ranks, sc_more, mesh=mesh)),
            "tp1": (want, Server(cfg, par1, one, sc_more))}
    same = {}
    for k, (base, other) in more.items():
        again = first_logits(torch, other, pdict)
        same[k] = all(torch.equal(base[i], again[i]) for i in pdict)
    del more, other
    kept = []
    flips = _flips(torch, [concurrent[i][0] for i in pdict],
                   [tp1[i][0] for i in pdict],
                   [got[i] for i in pdict], [want[i] for i in pdict], kept)
    res["server"] = {
        "mesh": dict(zip(mesh.axes, mesh.shape)), "ranks": srv.n_ranks,
        "prompt_lens": MESH_SERVE_PROMPTS, "new_tokens": MESH_SERVE_NEW,
        "concurrent_equals_isolated": f"{agree}/{len(prompts)}",
        "reuse_hits": reuse, "every_rank_agrees": True,
        "prefill_calls": srv.prefill_dispatches,
        "decode_calls": srv.decode_dispatches,
        "kernel_launches": {k: counts[k] for k in ("ag_gemm", "gemm_rs",
                                                   "flash_attention")},
        "shared_prefix": "prompt 2's first 32 tokens are prompt 1's",
        "first_logits_rel_l2_vs_tp1": rel, "first_token_flips": flips,
        "first_tokens_equal_tp1": sum(int(concurrent[i][0] == tp1[i][0])
                                      for i in pdict),
        f"first_logits_bit_equal_at_max_batch_{sc_more.max_batch}": same,
        "phase_s": time.perf_counter() - t0}
    check(agree == len(prompts), f"mesh Server concurrent vs isolated: "
          f"{agree}/{len(prompts)}")
    check(reuse > 0, "the mesh Server's reuse pass reused no prompt block")
    check(all(same.values()), f"first-token logits at max_batch "
          f"{sc_more.max_batch} differ from max_batch {sc.max_batch}'s: "
          f"{same}")
    check(max(rel.values()) <= TP_LANE_RTOL, f"mesh Server first-token "
          f"logits {rel} relative L2 from tp=1's (rtol {TP_LANE_RTOL})")
    _near_ties_only("mesh Server first tokens", flips, kept)
    mesh.free_symmetric()
    del srv, srv1, ranks, mesh, ctxs
    torch.cuda.empty_cache()

    # (b) ep=2 x tp=2: the experts over the ep axis
    t0 = time.perf_counter()
    par_ep = ParallelConfig(tp=tp, ep=2, fuse_w13=True, kernel_decode=True,
                            overlap_mode="flux")
    mesh, ranks = ranks_of(par_ep)
    n_exp = ranks[0].layers[0].ffn["w1"].shape[0]
    check(n_exp == cfg.moe.num_experts // 2, f"ep=2: {n_exp} experts a rank")
    _, _, launches_b = prefill("ep2_tp2", par_ep, mesh, ranks)
    res["ep2_tp2"].update(experts_a_rank=n_exp,
                          phase_s=time.perf_counter() - t0)
    mesh.free_symmetric()
    del ranks, mesh
    torch.cuda.empty_cache()

    # (d) the serve CLI at --dp 2 --tp 2
    t0 = time.perf_counter()
    cli, done = launch_serve.main(MESH_SERVE_ARGV + ["--dp", "2", "--tp",
                                                     str(tp), "--mode",
                                                     "flux"])
    check(cli.mesh is not None and cli.mesh.shape == (2, tp)
          and len(done) == MESH_SERVE_CLI_REQUESTS and all(
              r.done and len(r.output) == MESH_SERVE_NEW
              and all(0 <= t < vocab for t in r.output) for r in done),
          "launch.serve --dp 2 --tp 2 did not serve its requests")
    pdict = {r.rid: r.prompt for r in done}
    srv1 = Server(cli.cfg, par1, one, cli.sc)
    got, want = first_logits(torch, cli, pdict), first_logits(torch, srv1,
                                                              pdict)
    rel = {i: _rel_l2(got[i], want[i]) for i in pdict}
    firsts = {r.rid: r.output[0] for r in done}
    kept = []
    flips = _flips(torch, [firsts[i] for i in pdict],
                   [int(want[i].argmax()) for i in pdict],
                   [got[i] for i in pdict], [want[i] for i in pdict], kept)
    check(all(int(got[i].argmax()) == firsts[i] for i in pdict),
          "the CLI's first tokens are not the argmax of its first logits")
    res["cli"] = {"argv": MESH_SERVE_ARGV + ["--dp", "2", "--tp", str(tp),
                                             "--mode", "flux"],
                  "capacity_factor": cli.cfg.moe.capacity_factor,
                  "tokens": {r.rid: r.output for r in done},
                  "first_logits_rel_l2_vs_tp1": rel,
                  "first_token_flips": flips,
                  "phase_s": time.perf_counter() - t0}
    check(max(rel.values()) <= TP_LANE_RTOL, f"the CLI's first-token logits "
          f"{rel} relative L2 from tp=1's (rtol {TP_LANE_RTOL})")
    _near_ties_only("the CLI's first tokens", flips, kept)
    cli.mesh.free_symmetric()
    del cli, srv1, one, anchor
    torch.cuda.empty_cache()
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return {k: {"dp2_tp2_zero3": launches_a[k], "ep2_tp2": launches_b[k]}
            for k in ("flash_attention", "ag_gemm", "gemm_rs")}


class replay_routes(capture_routes):
    """``capture_routes`` that also routes every MoE token to the experts
    that ``plan(n, rank)`` names for the n-th router call on this thread:
    (the reference side's probabilities [t, E], its top-k [t, k]; a row of
    -1 leaves the token its own choice and out of the comparison), the
    gates this call's own router probabilities at those experts,
    renormalised: the MoE analogue of teacher-forcing the tokens, so that
    two runs whose bf16 sums differ send every token to the same experts.
    ``calls`` records (rank, probs, the experts routed to, the call's own
    top-k, the plan's probs, the plan's top-k) a call, for
    ``_routing_vs``."""

    def __init__(self, plan):
        self.plan = plan

    def __enter__(self):
        import threading

        import torch
        from repro_torch.models import ffn
        self.calls, self._route = [], ffn._route
        seen, lock = {}, threading.Lock()

        def route(p, ht, mc, axis=None):
            probs, _, own = self._route(p, ht, mc, axis)
            with lock:
                n = seen.get(threading.get_ident(), 0)
                seen[threading.get_ident()] = n + 1
            rank = -1 if axis is None else axis.rank()
            want_p, want = self.plan(n, rank)
            eidx = torch.where(want.to(own.device) >= 0,
                               want.to(own.device), own)
            gate = probs.gather(-1, eidx)
            gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
            self.calls.append((rank, probs.detach().float().cpu(),
                               eidx.detach().cpu(), own.detach().cpu(),
                               want_p.float().cpu(), want.cpu()))
            return probs, gate, eidx
        ffn._route = route
        return self


def _layer_routes(torch, calls, b, s):
    """A prefill's router calls over [b, s] tokens (each rank's calls in
    order, one a MoE layer; at tp>1 in the sequence-sharded layout a rank
    routes its sequence shard) -> [(probs [b, s, E], eidx [b, s, k]) a
    MoE layer]."""
    ranks = sorted({c[0] for c in calls})
    mine = {r: [c for c in calls if c[0] == r] for r in ranks}
    return [tuple(torch.cat([mine[r][i][j].reshape(b, s // len(ranks), -1)
                             for r in ranks], dim=1) for j in (1, 2))
            for i in range(len(mine[ranks[0]]))]


def _routing_vs(torch, pairs):
    """The tokens routed elsewhere than on the reference side, and whether
    each is a near tie.  ``pairs``: (probs [t, E], top-k [t, k]) of the
    compared run and of the reference a router call, the reference's top-k
    -1 on tokens left out (pad positions).  Every lane's routing comparison
    comes here.

    A token's top-k set can change only if the reference's k-th and
    (k+1)-th probabilities (their margin m) move toward each other by m,
    so a changed token always has m <= 2 x its own largest probability
    difference: that test cannot fail.  The noise is measured instead on
    the tokens that kept their experts: ``noise_max`` is their largest
    probability difference, and a changed token whose margin exceeds twice
    it is not a near tie (``changed_not_near_tie``)."""
    changed, delta, margin, got, want = [], [], [], [], []
    for pg, eg, pw, ew in pairs:
        valid = (ew >= 0).all(-1)
        got.append(pg[valid])
        want.append(pw[valid])
        k = ew.shape[-1]
        top = pw.sort(-1, descending=True).values
        changed.append(((eg.sort(-1).values != ew.sort(-1).values).any(-1)
                        )[valid])
        delta.append((pg - pw).abs().amax(-1)[valid])
        margin.append((top[..., k - 1] - top[..., k])[valid])
    changed, delta, margin = (torch.cat(v) for v in (changed, delta, margin))
    noise = float(delta[~changed].max()) if (~changed).any() else 0.0
    return {"tokens": int(changed.numel()),
            "tokens_routed_elsewhere": int(changed.sum()),
            "probs_rel_l2": _rel_l2(torch.cat(got), torch.cat(want)),
            "noise_max": noise,
            "changed_margin_max": (float(margin[changed].max())
                                   if changed.any() else 0.0),
            "changed_not_near_tie": int((changed & (margin > 2 * noise)
                                         ).sum())}


def _replayed(torch, calls):
    """``_routing_vs`` of a ``replay_routes`` run: each call's own top-k
    (what it would have routed to) against the plan it was given."""
    return _routing_vs(torch, [(c[1], c[3], c[4], c[5]) for c in calls])


def jamba_cfg():
    """The jamba lane's model: jamba_v01_52b at full width, its first
    JAMBA_LAYERS layers (one period of the pattern), at the drop-free
    capacity (a row alone, the batch and the tp=2 layout would otherwise
    evict other MoE assignments)."""
    from repro_torch.configs.base import get_config
    return drop_free(dataclasses.replace(get_config("jamba_v01_52b"),
                                         num_layers=JAMBA_LAYERS))


def jamba_seam_cases(which):
    """(name, rows, K, N) of one rank's AG-GEMM (``which="ag"``: rows its
    sequence shard) or GEMM-RS (rows M, K its shard) operands at the flux
    seams of the jamba lane's tp=JAMBA_TP prefill over
    len(JAMBA_LENGTHS) prompts padded to the longest: a Mamba layer's
    in-projections (``w_in_x`` and ``w_in_z``, one launch over both
    weights' columns) and ``w_out``, the GQA layer's QKV and ``wo``, the
    dense FFN's w1 and w3 (one launch) and w2."""
    from repro_torch.models.attention import AttnDims
    from repro_torch.models.mamba import _dims
    from repro_torch.parallel.sharding import pad_ff

    cfg, tp = jamba_cfg(), JAMBA_TP
    m = len(JAMBA_LENGTHS) * max(JAMBA_LENGTHS)
    d, d_in = cfg.d_model, _dims(cfg, tp)[0]
    att = AttnDims.of(cfg, tp)
    ffp = pad_ff(cfg.d_ff, tp)
    if which == "ag":
        return [("ag_jamba_mamba_in", m // tp, d, 2 * d_in // tp),
                ("ag_jamba_qkv", m // tp, d,
                 (att.h_pad + 2 * att.hkv_pad) * att.dh // tp),
                ("ag_jamba_mlp", m // tp, d, 2 * ffp // tp)]
    return [("rs_jamba_mamba_out", m, d_in // tp, d),
            ("rs_jamba_attn_out", m, att.h_pad * att.dh // tp, d),
            ("rs_jamba_mlp", m, ffp // tp, d)]


def phase_jamba_lane(torch):
    """Jamba's Mamba layers served (``jamba_cfg``: jamba_v01_52b at full
    width, one period of 8 layers, drop-free).  The weights are drawn once,
    seed 0's global copy packed for tp=2; its canonical leaves are the
    tp=1 model (at this width tp=2 pads nothing: only the QKV columns
    unpack), which shares every other leaf with it.

    Two bf16 runs of this model send some tokens to other experts at a
    router's near tie (random routers, top-2 of 16, over 4 MoE layers),
    and a token routed elsewhere gets another FFN output: its row's later
    state and logits move far more than the sums' rounding does.  So each
    comparison below runs the compared side with the reference side's
    expert choices replayed (``replay_routes``, as the decode steps are
    teacher-forced on tp=1's tokens), and every comparison's routing,
    free and replayed, is held to the near-tie rule of ``_routing_vs``:
    each token a run would route elsewhere on its own has a margin within
    twice the probability noise of the tokens that kept their experts.

    (a) The tp=1 anchor with the flash kernel: the batched prefill of 4 x
    1024 tokens (JAMBA_LENGTHS); the dt = 0 freeze (the batch with other
    tokens at the pad positions gives the same states and logits, bit for
    bit); each row alone at the batch's shape (the other rows one pad
    token each): the batch's states, logits and experts bit for bit; each
    row alone at its own length, its routing replayed: the first Mamba
    layer's conv and ssm state within JAMBA_STATE_RTOL of the batched
    prefill's, every layer's and the logits within TP_LANE_RTOL (the
    constants' comment); 8 greedy decode
    steps; the 8th step's logits against one fresh prefill over each
    prompt and the 8 fed tokens (decode's state update against the
    chunked scan), the anchor's routing replayed, within TP_LANE_RTOL.
    (c) The paged Server at tp=1: the JAMBA_PROMPTS requests together (the
    73-token prompt's chunks interleaved with the others' decode steps),
    each alone: concurrent = isolated, the pool's peak below the dense
    equivalent, no reuse hit (reuse is off for recurrent state).  (b) tp=2
    in flux with the kernels, the ranks cut from the global copy (the
    tp=1 model freed): the prefill, the counts set to 0 just before and
    read just after (the launches its PlanSet implies), its routing
    against tp=1's; the prefill again with tp=1's routing and 8 decode
    steps teacher-forced on tp=1's tokens and routing (no kernel): logits
    within TP_LANE_RTOL of tp=1's, tokens under the near-tie rule.  (d)
    ``launch.serve --arch jamba_v01_52b --layers 8`` once: its requests
    served, its first tokens the argmax of its first-token logits.
    Returns the prefills' kernel launches."""
    import numpy as np
    from repro_torch.configs.base import ATTN, MAMBA, ParallelConfig
    from repro_torch.dist import RankGroup
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import ffn
    from repro_torch.models import model as M
    from repro_torch.models import serve as S
    from repro_torch.parallel.sharding import make_ctx
    from repro_torch.runtime.server import Request, ServeConfig, Server

    t_phase = time.perf_counter()
    cfg = jamba_cfg()
    bf16, tp, vocab = torch.bfloat16, JAMBA_TP, cfg.vocab_size
    b, s = len(JAMBA_LENGTHS), max(JAMBA_LENGTHS)
    kinds = M.expanded_pattern(cfg)
    mamba_layers = [i for i, (mk, _) in enumerate(kinds) if mk == MAMBA]
    n_attn = sum(mk == ATTN for mk, _ in kinds)
    res = {"phase": "jamba_lane", "arch": cfg.name,
           "layers": f"{JAMBA_LAYERS} of 32 (cut in depth: one period)",
           "pattern": ["+".join(k) for k in kinds], "batch": b,
           "lengths": JAMBA_LENGTHS, "decode_steps": JAMBA_DECODE, "tp": tp,
           "capacity_factor": cfg.moe.capacity_factor, "rtol": TP_LANE_RTOL,
           "state_rtol": JAMBA_STATE_RTOL,
           "baseline_mem_gb": torch.cuda.memory_allocated() / 1e9}
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(13)
    tokens = torch.randint(0, vocab, (b, s), generator=gen, device="cuda")
    lengths = torch.tensor(JAMBA_LENGTHS, device="cuda")
    s_max = s + JAMBA_DECODE + 1
    par1 = ParallelConfig()

    t0 = time.perf_counter()
    full = M.init_model(cfg, ParallelConfig(tp=tp), seed=0, dtype=bf16,
                        device="cuda")
    one = M.rebuild(M.meta_model(cfg, par1), M.canonical_leaves(
        {n: t.detach() for n, t in full.named_parameters()}, cfg, tp))
    like = dict(M.meta_model(cfg, par1).named_parameters())
    check(all(t.shape == like[n].shape and t.dtype == like[n].dtype
              for n, t in one.named_parameters()),
          "the canonical leaves of the tp=2 weights are not the tp=1 model")
    torch.cuda.synchronize()
    res.update(params=sum(t.numel() for t in full.parameters()),
               weights_gb=sum(t.numel() * t.element_size()
                              for t in full.parameters()) / 1e9,
               init_s=time.perf_counter() - t0)

    # (a) the tp=1 anchor
    t0 = time.perf_counter()
    ctx1 = make_ctx(dataclasses.replace(par1, kernel_decode=True))
    ffn.dropped.clear()
    torch.cuda.synchronize()
    zero_counts()
    t1 = time.perf_counter()
    with capture_routes() as rt:
        lg, caches = S.prefill_logits(one, {"tokens": tokens}, ctx1, cfg,
                                      lengths)
        torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t1) * 1e3
    counts = read_counts()
    tp1_launches = {k: counts[k] for k in ("ag_gemm", "gemm_rs",
                                           "flash_attention")}
    check(tp1_launches == {"ag_gemm": 0, "gemm_rs": 0,
                           "flash_attention": n_attn},
          f"the tp=1 prefill launched {tp1_launches}: one flash launch a "
          f"GQA layer ({n_attn})")
    # the anchor's routes, the pad positions left out (they route freely)
    valid1 = (torch.arange(s)[None] < lengths.cpu()[:, None])[..., None]
    routes1 = [(p, torch.where(valid1, e, -1))
               for p, e in _layer_routes(torch, rt.calls, b, s)]
    anchor = {"logits": [lg[:, :vocab].float()],
              "tokens": [S.vocab_parallel_argmax(lg, vocab)[:, None]]}
    # the dt = 0 freeze: other tokens at the pad positions leave every
    # Mamba state and every row's logits as they were, bit for bit
    noise = torch.randint(0, vocab, (b, s), generator=gen, device="cuda")
    pad = torch.arange(s, device="cuda")[None] >= lengths[:, None]
    lg_pad, c_pad = S.prefill_logits(
        one, {"tokens": torch.where(pad, noise, tokens)}, ctx1, cfg, lengths)
    frozen = torch.equal(lg_pad, lg) and all(
        torch.equal(c_pad[i][k], caches[i][k])
        for i in mamba_layers for k in ("conv", "ssm"))
    del lg_pad, c_pad, noise
    check(frozen, "jamba: other tokens at the pad positions moved the "
          "batched prefill's Mamba state or logits")
    # each row alone: at its own length (free, then the batch's routing
    # replayed), and at the batch's shape (the other rows one pad token
    # each: every GEMM, the attention and the scan at the batch's shapes)
    state_rel, alone_rel, alone_free, shape_rel, shape_lg = ({}, {}, {}, {},
                                                             {})
    free_pairs, alone_calls, shape_pairs = [], [], []
    shape_equal = True
    for r, n in enumerate(JAMBA_LENGTHS):
        one_row = {"tokens": tokens[r:r + 1, :n]}
        with capture_routes() as rt:
            lga, _ = S.prefill_logits(one, one_row, ctx1, cfg)
        free_pairs += [(c[1], c[2], p1[r, :n], e1[r, :n])
                       for c, (p1, e1) in zip(rt.calls, routes1)]
        alone_free[r] = _rel_l2(lga[0, :vocab].float(), anchor["logits"][0][r])
        with replay_routes(lambda i, rank, r=r, n=n: (
                routes1[i][0][r, :n], routes1[i][1][r, :n])) as rr:
            lga, alone = S.prefill_logits(one, one_row, ctx1, cfg)
        alone_calls += rr.calls
        alone_rel[r] = _rel_l2(lga[0, :vocab].float(), anchor["logits"][0][r])
        for i in mamba_layers:
            for k in ("conv", "ssm"):
                state_rel[f"row{r}/layer{i}/{k}"] = _rel_l2(
                    caches[i][k][r], alone[i][k][0])
        del alone, lga
        solo = torch.zeros_like(tokens)
        solo[r] = tokens[r]
        solo_len = torch.ones_like(lengths)
        solo_len[r] = n
        with capture_routes() as rt:
            lga, at = S.prefill_logits(one, {"tokens": solo}, ctx1, cfg,
                                       solo_len)
        shape_pairs += [(c[1].reshape(b, s, -1)[r, :n],
                         c[2].reshape(b, s, -1)[r, :n], p1[r, :n], e1[r, :n])
                        for c, (p1, e1) in zip(rt.calls, routes1)]
        shape_lg[r] = _rel_l2(lga[r, :vocab].float(), anchor["logits"][0][r])
        shape_equal &= torch.equal(lga[r], lg[r])
        for i in mamba_layers:
            for k in ("conv", "ssm"):
                shape_rel[f"row{r}/layer{i}/{k}"] = _rel_l2(
                    caches[i][k][r], at[i][k][r])
                shape_equal &= torch.equal(caches[i][k][r], at[i][k][r])
        del at, lga, solo
    alone_routing = {"free": _routing_vs(torch, free_pairs),
                     "replayed": _replayed(torch, alone_calls)}
    shape_routing = _routing_vs(torch, shape_pairs)
    del free_pairs, alone_calls, shape_pairs
    first = {k: v for k, v in state_rel.items()
             if k.split("/")[1] == f"layer{mamba_layers[0]}"}
    worst = max(state_rel, key=state_rel.get)
    check(max(first.values()) <= JAMBA_STATE_RTOL, f"jamba: the first "
          f"Mamba layer's state after the batched prefill {first} relative "
          f"L2 from each row's prefill alone (rtol {JAMBA_STATE_RTOL})")
    check(state_rel[worst] <= TP_LANE_RTOL, f"jamba: {worst}'s state after "
          f"the batched prefill {state_rel[worst]:.4g} relative L2 from the "
          f"row's prefill alone, its routing replayed (rtol {TP_LANE_RTOL})")
    check(max(alone_rel.values()) <= TP_LANE_RTOL, f"jamba: each row's "
          f"logits alone {alone_rel} relative L2 from the batched prefill's "
          f"(rtol {TP_LANE_RTOL})")
    shape_worst = max(shape_rel, key=shape_rel.get)
    check(shape_equal and shape_routing["tokens_routed_elsewhere"] == 0,
          f"jamba: each row alone at the batch's shape is not the batched "
          f"prefill's bit for bit: {shape_worst}'s state "
          f"{shape_rel[shape_worst]:.4g}, the logits {shape_lg} relative "
          f"L2, routing {shape_routing}")
    for what, rt_ in (("each row alone, free", alone_routing["free"]),
                      ("each row alone, replayed", alone_routing["replayed"]),
                      ("each row at the batch's shape", shape_routing)):
        check(rt_["changed_not_near_tie"] == 0, f"jamba: {what}: tokens "
              f"routed elsewhere than in the batch without a near tie: {rt_}")
    check(ffn.drop_totals() == [0], f"the tp=1 anchor dropped "
          f"{ffn.drop_totals()} MoE assignments")
    caches = _dense_caches(torch, caches, s_max)
    zero_counts()
    step_ms, routes_dec = [], []
    for step in range(JAMBA_DECODE):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with capture_routes() as rt:
            lg, caches = S.decode_logits(one, caches, anchor["tokens"][-1],
                                         lengths + step, ctx1, cfg)
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        routes_dec.append([(p, e) for _, p, e in rt.calls])
        anchor["logits"].append(lg[:, :vocab].float())
        anchor["tokens"].append(S.vocab_parallel_argmax(lg, vocab)[:, None])
    counts = read_counts()
    check(not any(counts.values()), f"the tp=1 decode launched {counts}")
    del caches
    # the 8th step against one prefill over each prompt and the 8 tokens
    # fed to the decode steps (padded to a whole number of scan chunks),
    # the anchor's routing replayed (the pad positions route freely)
    fed = torch.cat(anchor["tokens"][:JAMBA_DECODE], 1)
    width = -(-(s + JAMBA_DECODE) // 256) * 256
    ext = torch.zeros((b, width), dtype=tokens.dtype, device="cuda")
    plan = []
    for i, (p1, e1) in enumerate(routes1):
        e = torch.full((b, width, e1.shape[-1]), -1, dtype=e1.dtype)
        p = torch.zeros((b, width, p1.shape[-1]))
        for r, n in enumerate(JAMBA_LENGTHS):
            e[r, :n], p[r, :n] = e1[r, :n], p1[r, :n]
            for j in range(JAMBA_DECODE):
                p[r, n + j], e[r, n + j] = (t[r] for t in routes_dec[j][i])
        plan.append((p.reshape(b * width, -1), e.reshape(b * width, -1)))
    for r, n in enumerate(JAMBA_LENGTHS):
        ext[r, :n] = tokens[r, :n]
        ext[r, n:n + JAMBA_DECODE] = fed[r]
    with capture_routes() as rt:
        lg, _ = S.prefill_logits(one, {"tokens": ext}, ctx1, cfg,
                                 lengths + JAMBA_DECODE)
    fresh_free = _rel_l2(lg[:, :vocab].float(), anchor["logits"][-1])
    fresh_routing = {"free": _routing_vs(torch, [
        (c[1], c[2], *plan[i]) for i, c in enumerate(rt.calls)])}
    with replay_routes(lambda i, rank: plan[i]) as rr:
        lg, _ = S.prefill_logits(one, {"tokens": ext}, ctx1, cfg,
                                 lengths + JAMBA_DECODE)
    fresh_routing["replayed"] = _replayed(torch, rr.calls)
    fresh = _rel_l2(lg[:, :vocab].float(), anchor["logits"][-1])
    del lg, plan, rt, rr
    res["tp1"] = {
        "prefill_host_ms": prefill_ms, "prefill_launches": tp1_launches,
        "pad_tokens_change_nothing": frozen,
        "first_layer_state_rel_l2_vs_row_alone": first,
        "state_rel_l2_vs_row_alone_max": state_rel[worst],
        "state_rel_l2_worst": worst,
        "state_rel_l2_vs_row_alone": state_rel,
        "logits_rel_l2_vs_row_alone": alone_rel,
        "logits_rel_l2_vs_row_alone_free_routing": alone_free,
        "routing_vs_batch_row_alone": alone_routing,
        "at_batch_shape_bit_equal": shape_equal,
        "at_batch_shape_state_rel_l2_max": shape_rel[shape_worst],
        "at_batch_shape_logits_rel_l2": shape_lg,
        "at_batch_shape_routing_vs_batch": shape_routing,
        "decode_step_host_ms": step_ms,
        "decode8_logits_rel_l2_vs_fresh_prefill": fresh,
        "decode8_vs_fresh_prefill_free_routing": fresh_free,
        "fresh_prefill_routing_vs_decode": fresh_routing,
        "phase_s": time.perf_counter() - t0}
    check(fresh <= TP_LANE_RTOL, f"jamba: the 8th decode step's logits "
          f"{fresh:.4g} relative L2 from a fresh prefill's (rtol "
          f"{TP_LANE_RTOL})")
    for how, rt_ in fresh_routing.items():
        check(rt_["changed_not_near_tie"] == 0, f"jamba: the fresh prefill "
              f"({how}) routed tokens elsewhere than the prefill and decode "
              f"steps without a near tie: {rt_}")

    # (c) the paged Server at tp=1
    t0 = time.perf_counter()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, vocab, size=(n,)).astype(np.int32)
               for n in JAMBA_PROMPTS]
    sc = ServeConfig(max_batch=4, max_seq=256, eos_token=-1,
                     max_new_tokens=JAMBA_NEW, block_size=16,
                     prefill_chunk=32)

    def serve(srv, which):
        done = srv.serve([Request(rid=i, prompt=prompts[i]) for i in which])
        check(all(r.done and r.error is None and len(r.output) == JAMBA_NEW
                  and all(0 <= t < vocab for t in r.output) for r in done),
              "a jamba Server request did not finish")
        return {r.rid: r.output for r in done}

    srv = Server(cfg, par1, one, sc)
    events = []
    chunk_fn, step_fn = srv.prefill_chunk, srv.step

    def chunk(job):
        events.append(("chunk", job.req.rid))
        return chunk_fn(job)

    def step():
        events.append(("decode", sum(srv.ready)))
        return step_fn()
    srv.prefill_chunk, srv.step = chunk, step
    zero_counts()
    t1 = time.perf_counter()
    concurrent = serve(srv, range(len(prompts)))
    serve_s = time.perf_counter() - t1
    # the wrappers hold srv's bound methods: while they live, srv and the
    # weights it holds live on in a reference cycle
    del srv.prefill_chunk, srv.step, chunk, step, chunk_fn, step_fn
    long_rid = JAMBA_PROMPTS.index(max(JAMBA_PROMPTS))
    at = [i for i, e in enumerate(events) if e == ("chunk", long_rid)]
    between = [e for e in events[at[0]:at[-1]] if e[0] == "decode" and e[1]]
    agree = sum(int(serve(Server(cfg, par1, one, sc), [i])[i]
                    == concurrent[i]) for i in concurrent)
    counts = read_counts()
    res["server"] = {
        "prompt_lens": JAMBA_PROMPTS, "new_tokens": JAMBA_NEW,
        "max_batch": sc.max_batch, "prefill_chunk": sc.prefill_chunk,
        "block_size": sc.block_size, "tokens": concurrent,
        "concurrent_equals_isolated": f"{agree}/{len(prompts)}",
        "long_prompt_chunks": len(at),
        "decodes_between_its_chunks": len(between),
        "pool_peak_blocks": srv.pool.peak_blocks_in_use,
        "dense_equiv_blocks": srv.dense_equiv_blocks,
        "reuse_hits": srv.pool.reuse_hits, "prefix_reuse": srv._reuse_ok,
        "prefill_calls": srv.prefill_dispatches,
        "decode_calls": srv.decode_dispatches,
        "serve_wall_s": serve_s,
        "kernel_launches": {k: counts[k] for k in (
            "ag_gemm", "gemm_rs", "flash_attention")},
        "phase_s": time.perf_counter() - t0}
    check(agree == len(prompts), f"jamba Server concurrent vs isolated: "
          f"{agree}/{len(prompts)}")
    check(len(at) == 3 and between, f"jamba Server: the {max(JAMBA_PROMPTS)}"
          f"-token prompt ran {len(at)} chunks with {len(between)} decode "
          "steps of other requests between them")
    check(srv.pool.peak_blocks_in_use < srv.dense_equiv_blocks,
          f"jamba Server pool peak {srv.pool.peak_blocks_in_use} blocks, "
          f"dense equivalent {srv.dense_equiv_blocks}")
    check(srv.pool.reuse_hits == 0 and not srv._reuse_ok,
          "jamba Server reused prompt blocks: its Mamba state is not paged")
    del srv, one
    torch.cuda.empty_cache()

    # (b) tp=2 in flux with the kernels
    t0 = time.perf_counter()
    ranks = [M.shard_params(full, r, tp, cfg) for r in range(tp)]
    del full
    torch.cuda.empty_cache()
    group = RankGroup(tp, "cuda")
    par = ParallelConfig(tp=tp, overlap_mode="flux", kernel_decode=True)
    ctx = make_ctx(par, group)

    def prefill(p):
        return S.prefill_logits(p, {"tokens": tokens}, ctx, cfg, lengths)

    ffn.dropped.clear()
    torch.cuda.synchronize()
    zero_counts()
    t1 = time.perf_counter()
    with capture_routes() as rt:
        outs = group.spmd(prefill, [(p,) for p in ranks])
        torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t1) * 1e3
    counts = read_counts()
    want = prefill_launches(ctx.plans, cfg, tp, 2, True)
    got = {k: counts[k] for k in want}
    check(got == want, f"jamba tp={tp} prefill launches {got}, its PlanSet "
          f"implies {want}")
    drops = ffn.drop_totals(tp)
    check(drops == [0] * tp, f"jamba tp={tp} prefill dropped {drops}")
    routing = {"free": _routing_vs(torch, [
        (pg.reshape(-1, pg.shape[-1]), eg.reshape(-1, eg.shape[-1]),
         pw.reshape(-1, pw.shape[-1]), ew.reshape(-1, ew.shape[-1]))
        for (pg, eg), (pw, ew) in zip(_layer_routes(torch, rt.calls, b, s),
                                      routes1)])}
    free = _rel_l2(torch.cat([o[0] for o in outs], -1)[:, :vocab].float(),
                   anchor["logits"][0])
    del outs
    # the prefill again with tp=1's routing, each rank its sequence shard
    half = s // tp
    with replay_routes(lambda i, rank: tuple(
            t[:, rank * half:(rank + 1) * half].reshape(b * half, -1)
            for t in routes1[i])) as rr:
        outs = group.spmd(prefill, [(p,) for p in ranks])
    routing["replayed"] = _replayed(torch, rr.calls)
    del rr
    lg = torch.cat([o[0] for o in outs], -1)[:, :vocab].float()
    rel = _rel_l2(lg, anchor["logits"][0])
    kept = []
    flips = _flips(torch, lg.argmax(-1).tolist(),
                   anchor["tokens"][0][:, 0].tolist(), lg,
                   anchor["logits"][0], kept)
    check(rel <= TP_LANE_RTOL, f"jamba tp={tp}: prefill logits {rel:.4g} "
          f"relative L2 from tp=1's (rtol {TP_LANE_RTOL})")
    _near_ties_only(f"jamba tp={tp} prefill", flips, kept)
    caches = [_dense_caches(torch, o[1], s_max) for o in outs]
    del outs
    rels, dflips, dkept, step_ms, dec_calls = [], {}, [], [], []
    zero_counts()
    for step in range(JAMBA_DECODE):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with replay_routes(lambda i, rank, step=step:
                           routes_dec[step][i]) as rr:
            outs = group.spmd(
                lambda p, c, step=step: S.decode_logits(
                    p, c, anchor["tokens"][step], lengths + step, ctx,
                    cfg)[0],
                list(zip(ranks, caches)))
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        dec_calls += rr.calls
        lg = torch.cat(outs, -1)[:, :vocab].float()
        want_lg = anchor["logits"][step + 1]
        rels.append(_rel_l2(lg, want_lg))
        for row, f in _flips(torch, lg.argmax(-1).tolist(),
                             anchor["tokens"][step + 1][:, 0].tolist(), lg,
                             want_lg, dkept).items():
            dflips[f"{step}/{row}"] = f
    counts = read_counts()
    decode_launches = {k: counts[k] for k in ("ag_gemm", "gemm_rs",
                                              "flash_attention")}
    routing_dec = _replayed(torch, dec_calls)
    del dec_calls, rr
    res[f"tp{tp}_flux"] = {
        "prefill_launches": got, "prefill_launches_planset": want,
        "prefill_host_ms": host_ms, "prefill_routing_vs_tp1": routing,
        "prefill_logits_rel_l2_vs_tp1_free_routing": free,
        "prefill_logits_rel_l2_vs_tp1": rel, "prefill_token_flips": flips,
        "decode_logits_rel_l2_vs_tp1": rels, "decode_token_flips": dflips,
        "decode_routing_vs_tp1": routing_dec,
        "decode_step_host_ms": step_ms, "decode_launches": decode_launches,
        "phase_s": time.perf_counter() - t0}
    check(max(rels) <= TP_LANE_RTOL, f"jamba tp={tp} decode logits {rels} "
          f"relative L2 from tp=1's (rtol {TP_LANE_RTOL})")
    for what, rt_ in (("prefill, free", routing["free"]),
                      ("prefill, replayed", routing["replayed"]),
                      ("decode, replayed", routing_dec)):
        check(rt_["changed_not_near_tie"] == 0, f"jamba tp={tp} {what}: "
              f"tokens routed elsewhere than at tp=1 without a near tie: "
              f"{rt_}")
    check(not any(decode_launches.values()), "jamba's replicated-layout "
          f"decode launched a kernel: {decode_launches}")
    _near_ties_only(f"jamba tp={tp} decode", dflips, dkept)
    group.free_symmetric()
    del caches, ranks, group, outs, lg
    torch.cuda.empty_cache()

    # (d) the serve CLI
    t0 = time.perf_counter()
    cli, done = launch_serve.main(JAMBA_ARGV)
    check(len(done) == 2 and all(
        r.done and r.error is None and len(r.output) == JAMBA_NEW
        and all(0 <= t < vocab for t in r.output) for r in done),
        "launch.serve --arch jamba_v01_52b did not serve its requests")
    firsts = first_logits(torch, cli, {r.rid: r.prompt for r in done})
    check(all(int(firsts[r.rid].argmax()) == r.output[0] for r in done),
          "the jamba CLI's first tokens are not the argmax of its "
          "first-token logits")
    res["cli"] = {"argv": JAMBA_ARGV, "tokens": {r.rid: r.output
                                                 for r in done},
                  "reuse_hits": cli.pool.reuse_hits,
                  "phase_s": time.perf_counter() - t0}
    del cli, anchor, firsts
    torch.cuda.empty_cache()
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["left_mem_gb"] = torch.cuda.memory_allocated() / 1e9
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    check(res["left_mem_gb"] < res["baseline_mem_gb"] + 0.5, f"the jamba "
          f"lane left {res['left_mem_gb']:.3f} GB allocated (it started at "
          f"{res['baseline_mem_gb']:.3f} GB)")
    return {"flash_attention": {"tp1_prefill": tp1_launches[
        "flash_attention"], f"tp{tp}_prefill": got["flash_attention"]},
            "ag_gemm": {f"tp{tp}_prefill": got["ag_gemm"]},
            "gemm_rs": {f"tp{tp}_prefill": got["gemm_rs"]}}


def jamba_train_cfg():
    """The jamba train lane's model: jamba_v01_52b at full width, its first
    JAMBA_LAYERS layers (one period) and JAMBA_TRAIN_EXPERTS of its 16
    experts, top-2 kept (the constants' comment)."""
    from repro_torch.configs.base import get_config
    cfg = get_config("jamba_v01_52b")
    return dataclasses.replace(
        cfg, num_layers=JAMBA_LAYERS,
        moe=dataclasses.replace(cfg.moe, num_experts=JAMBA_TRAIN_EXPERTS))


def jamba_train_seam_cases(which):
    """(name, rows, K, N) of one rank's operands at two backward launches
    of the jamba train lane's tp=JAMBA_TP flux step over JAMBA_TRAIN_BATCH
    x JAMBA_TRAIN_SEQ tokens: ``w_out``'s dY, an AG-GEMM over the
    cotangent's sequence shard and the rank's rows of ``w_out`` transposed
    (``which="ag"``: [M / tp, D] x [D, d_in / tp]); the in-projections' dX,
    a GEMM-RS over their cotangent and the rank's packed ``w_in_xz``
    transposed ([M, 2 d_in / tp] x [2 d_in / tp, D])."""
    from repro_torch.models.mamba import _dims
    cfg, tp = jamba_train_cfg(), JAMBA_TP
    m, d = JAMBA_TRAIN_BATCH * JAMBA_TRAIN_SEQ, cfg.d_model
    d_in = _dims(cfg, tp)[0]
    if which == "ag":
        return [("ag_jamba_train_dy_w_out", m // tp, d, d_in // tp)]
    return [("rs_jamba_train_dx_mamba_in", m, 2 * d_in // tp, d)]


def jamba_scan_checks(torch):
    """The selective scan's backward on the card (``mamba.selective_scan``,
    plain PyTorch): its grads for x, dt, B, C, A and h0 against autograd
    through an out-of-place step-by-step scan at the lane's channel width
    (JAMBA_SCAN_CHECK: B 1, S 128 in chunks of 32, fp32), within TOL; and
    at the lane's tp=1 shape [2, 1024, 8192, 16] the bytes its forward
    saves (``saved_tensors_hooks``: its inputs and the state carried into
    each chunk, nothing a position) and the memory its backward adds above
    what it started with, within JAMBA_SCAN_MEM_GB, each pass's host ms."""
    from repro_torch.models import mamba as MB
    cfg = jamba_train_cfg()
    c, n = MB._dims(cfg, 1)[0], cfg.mamba.d_state
    gen = torch.Generator(device="cuda").manual_seed(21)

    def inputs(b, s):
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        return [rnd(b, s, c), torch.nn.functional.softplus(rnd(b, s, c) - 4.6),
                rnd(b, s, n), rnd(b, s, n), -torch.exp(0.5 * rnd(c, n)),
                rnd(b, c, n)]

    def stepwise(x, dt, bb, cc, a, h):
        ys = []
        for t in range(x.shape[1]):
            h = (torch.exp(dt[:, t, :, None] * a) * h
                 + (dt[:, t] * x[:, t])[..., None] * bb[:, t, None, :])
            ys.append(torch.matmul(h, cc[:, t, :, None])[..., 0])
        return torch.stack(ys, 1), h

    b, s, chunk = JAMBA_SCAN_CHECK
    args = [t.requires_grad_() for t in inputs(b, s)]
    wy = torch.randn((b, s, c), generator=gen, device="cuda")
    wh = torch.randn((b, c, n), generator=gen, device="cuda")
    rels, grads = {}, []
    for fn in (lambda *a: MB.selective_scan(*a, chunk=chunk), stepwise):
        y, h = fn(*args)
        grads.append(torch.autograd.grad((y * wy).sum() + (h * wh).sum(),
                                          args))
    for name, got, want in zip(("x", "dt", "b", "c", "a", "h0"), *grads):
        rels[name] = _rel_l2(got, want)
    del args, grads, y, h
    worst = max(rels, key=rels.get)
    check(rels[worst] <= TOL["float32"], f"the scan's grad of {worst} on "
          f"the card {rels[worst]:.3g} relative L2 from the step-by-step "
          f"scan's (rtol {TOL['float32']})")

    bl, sl = JAMBA_TRAIN_BATCH, JAMBA_TRAIN_SEQ
    args = [t.requires_grad_() for t in inputs(bl, sl)]
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y, _ = MB.selective_scan(*args)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    dy = torch.randn_like(y)
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = torch.autograd.grad(y, args, dy)
    torch.cuda.synchronize()
    bwd_ms = (time.perf_counter() - t0) * 1e3
    added = (torch.cuda.max_memory_allocated() - start) / 1e9
    finite = all(bool(torch.isfinite(t).all()) for t in g)
    n_chunks = sl // MB._chunk_len(sl, 256)
    states = n_chunks * bl * c * n * 4
    inputs_b = sum(t.numel() * t.element_size() for t in args)
    del args, y, dy, g
    out = {"grad_check": {"shape": [b, s, c, n], "chunk": chunk,
                          "rel_l2_vs_stepwise": rels},
           "shape": [bl, sl, c, n], "chunks": n_chunks,
           "saved_bytes": sum(saved), "saved_input_bytes": inputs_b,
           "saved_state_bytes": states,
           "one_position_state_tensor_bytes": bl * sl * c * n * 4,
           "backward_added_gb": added, "backward_gb_limit": JAMBA_SCAN_MEM_GB,
           "forward_host_ms": fwd_ms, "backward_host_ms": bwd_ms}
    check(finite, "the scan's grads at the lane's shape are not finite")
    check(sum(saved) == inputs_b + states, f"the scan saved {sum(saved)} "
          f"bytes, its inputs {inputs_b} and the chunk states {states}")
    check(added <= JAMBA_SCAN_MEM_GB, f"the scan's backward added "
          f"{added:.3f} GB at {out['shape']} (limit {JAMBA_SCAN_MEM_GB})")
    return out


def phase_jamba_train_lane(torch):
    """Jamba trained (``jamba_train_cfg``: jamba_v01_52b at full width, one
    period of 8 layers, 4 of its 16 experts; weights from seed 0, batch
    JAMBA_TRAIN_BATCH x JAMBA_TRAIN_SEQ).  The scan's backward first
    (``jamba_scan_checks``).  Step 0 in fp32 at tp=1 at an expert
    capacity of E / k (drop-free), its routing kept; then the main path,
    step 0 at tp=JAMBA_TP in flux in the sequence-sharded layout (the
    Mamba in-projections' shared AG-GEMM and ``w_out``'s GEMM-RS forward,
    their interchanged kernels backward), each time with the counts set to
    0 just before and read just after (the launches its PlanSet implies):
    (a) in fp32 with tp=1's routing replayed (``replay_routes``), its loss
    and every canonical grad / tp against tp=1's within JAMBA_F32_RTOL;
    (b) in bf16, the trainer's dtype, on the wgmma kernels, its routing
    free running and held to tp=1's under ``_routing_vs``' near-tie rule,
    its loss against tp=1's, then the same step in xla (the seams' plain
    version) on flux's routing, each rank's loss and grads against flux's
    within JAMBA_BF16_MODES_RTOL.  Then 3 ``Trainer`` steps, bf16 weights
    and fp32 moments, at JAMBA_TRAIN_DP x JAMBA_TP under ZeRO-3 with remat
    "full" in flux (the production preset on 4 ranks, the experts over
    (data, model): the constants' comment) at the config's capacity
    factor: step 0's loss against tp=1's, finite losses, the drops, step
    ms, peak memory, the launches with the recompute's, a profiled step.
    Returns the fused launches of the tp=2 steps 0 and of the trainer's
    steps."""
    from repro_torch.configs.base import ParallelConfig, train_schedule
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models import ffn
    from repro_torch.models import model as M
    from repro_torch.runtime import trainer as T

    t_phase = time.perf_counter()
    cfg = jamba_train_cfg()
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    cfg_ek = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=e / k))
    tp, dp, bf16 = JAMBA_TP, JAMBA_TRAIN_DP, torch.bfloat16
    bsz, seq = JAMBA_TRAIN_BATCH, JAMBA_TRAIN_SEQ
    tc = T.TrainConfig(total_steps=JAMBA_TRAIN_STEPS, warmup_steps=0,
                       base_lr=3e-4, schedule=train_schedule(cfg.name),
                       log_every=JAMBA_TRAIN_STEPS)
    res = {"phase": "jamba_train_lane", "arch": cfg.name,
           "reduced": {"num_layers": f"{cfg.num_layers} of 32 (one period: "
                                     "7 Mamba and 1 GQA mixers, 4 dense "
                                     "and 4 MoE FFNs)",
                       "num_experts": f"{e} of 16 (top-{k} kept, {e // tp} "
                                      f"a rank at tp={tp}): 4.57 B weights "
                                      "against 13.0 B, which at 12 bytes a "
                                      "weight would not fit",
                       "trainer_experts": "over (data, model), 1 a rank "
                                          "(ep_over_dp; the constants' "
                                          "comment)"},
           "batch": bsz, "seq": seq, "steps": JAMBA_TRAIN_STEPS,
           "schedule": tc.schedule,
           "dtype": "bfloat16 weights, float32 moments",
           "loss_rtol": TRAIN_LOSS_RTOL, "fp32_rtol": JAMBA_F32_RTOL,
           "bf16_modes_rtol": JAMBA_BF16_MODES_RTOL,
           "step0_capacity_factor": e / k,
           "capacity_factor": cfg.moe.capacity_factor,
           "ln_vocab": math.log(cfg.vocab_size),
           "baseline_mem_gb": torch.cuda.memory_allocated() / 1e9}
    t0 = time.perf_counter()
    res["scan"] = jamba_scan_checks(torch)
    res["scan"]["phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    batch0 = {n: torch.from_numpy(v).cuda() for n, v in batch_at(
        DataConfig(cfg.vocab_size, seq, bsz), 0).items()}

    # ---- tp=1: step 0 in fp32 at capacity E / k, its routing kept --------
    # (fp32: the constants' comment)
    f32 = torch.float32
    cfg32 = dataclasses.replace(cfg_ek, compute_dtype="float32")
    par1 = ParallelConfig(fuse_w13=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    p1 = M.init_model(cfg, par1, seed=0, dtype=f32, device="cuda",
                      trainable=True)
    res["weights"] = sum(p.numel() for p in p1.parameters())
    ffn.dropped.clear()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with capture_routes() as rt1:
        loss1, g1 = T.loss_and_grads(p1, batch0, T.make_ctx(cfg32, par1),
                                     cfg32, par1)
    torch.cuda.synchronize()
    res["tp1"] = {"step0_loss": loss1.item(), "dtype": "float32",
                  "step0_host_ms": (time.perf_counter() - t1) * 1e3,
                  "step0_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                  "dropped_assignments": ffn.drop_totals(),
                  "init_and_step_s": time.perf_counter() - t0}
    check(ffn.drop_totals() == [0], f"the tp=1 step at capacity E/k "
          f"dropped {ffn.drop_totals()} MoE assignments")
    check(math.isfinite(loss1.item()), f"jamba tp=1 step-0 loss {loss1}")
    can1 = M.canonical_leaves(g1, cfg, 1, grads=True)
    routes1 = [(c[1].reshape(bsz, seq, -1), c[2].reshape(bsz, seq, -1))
               for c in rt1.calls]
    del p1, g1, rt1
    torch.cuda.empty_cache()

    # ---- tp=2 step 0 in flux, sequence-sharded: the main path --------------
    # (a) fp32, tp=1's routing replayed
    t0 = time.perf_counter()
    par2 = ParallelConfig(tp=tp, fuse_w13=True, overlap_mode="flux")
    tr2 = T.Trainer(cfg32, par2, tc, device="cuda", dtype=f32)
    tr2.data_cfg = dataclasses.replace(tr2.data_cfg, seq_len=seq,
                                       global_batch=bsz)
    check(all(torch.equal(tr2.batch(0)[n], batch0[n]) for n in batch0),
          "the trainer's first batch is not the tp=1 step's")
    mesh = tr2.group

    def rank_weights(dtype):
        full = M.init_model(cfg, par2, seed=0, dtype=dtype, device="cuda",
                            trainable=True)
        return [M.shard_params(full, r, tp, cfg) for r in range(tp)]
    ranks = rank_weights(f32)
    torch.cuda.empty_cache()
    plans = T.make_ctx(cfg32, par2, mesh=mesh, rank=0).plans
    check(plans.residual_layout() == "seq",
          "the tp=2 step is not sequence-sharded")
    want_fwd, want_bwd = plan_launches(plans, cfg, tp, 1)
    half = seq // tp
    ffn.dropped.clear()
    with replay_routes(lambda i, rank: tuple(
            t[:, rank * half:(rank + 1) * half].reshape(bsz * half, -1)
            for t in routes1[i])) as rr:
        losses2, grads2, c_fwd, c_bwd, host2 = step0_grads(
            torch, cfg32, par2, mesh, ranks, [batch0])
    replayed = _replayed(torch, rr.calls)
    del rr
    loss2 = losses2[0]
    d2 = ffn.drop_totals(tp)
    # the canonical grads / tp a layer at a time (the global fp32 grads
    # whole would not fit beside tp=1's)
    by_part = {}
    for n in grads2[0]:
        by_part.setdefault(".".join(n.split(".")[:2]), []).append(n)
    rel = {}
    for names in by_part.values():
        can2 = synced_canonical(torch, cfg, par2, mesh, ranks, grads2, names)
        rel.update({n: _rel_l2(g, can1[n]) for n, g in can2.items()})
        del can2
    rel_loss = abs(loss2 - loss1.item()) / abs(loss1.item())
    worst = sorted(rel, key=rel.get, reverse=True)
    res["tp2_flux"] = {
        "dtype": "float32", "step0_loss": loss2, "loss_rel_vs_tp1": rel_loss,
        "grad_rel_l2_vs_tp1_max": rel[worst[0]], "grad_worst_leaf": worst[0],
        "grad_rel_l2_vs_tp1_worst_leaves": {n: rel[n] for n in worst[:8]},
        "mamba_grad_rel_l2_vs_tp1_max": {
            leaf: max(r for n, r in rel.items()
                      if n.endswith(".mixer." + leaf))
            for leaf in ("w_in_x", "w_in_z", "conv", "conv_b", "w_x", "w_dt",
                         "dt_bias", "a_log", "d_skip", "w_out", "norm")},
        "routing_replayed_vs_tp1": replayed,
        "dropped_assignments_per_rank": d2,
        "launches_forward": c_fwd, "launches_backward": c_bwd,
        "launches_planset": {"forward": want_fwd, "backward": want_bwd},
        "step0_host": host2, "phase_s": time.perf_counter() - t0}
    check(set(rel) == set(can1), "tp=2 and tp=1 canonical leaves differ")
    del can1, grads2, ranks
    torch.cuda.empty_cache()
    check(c_fwd == want_fwd, f"jamba train flux forward launches {c_fwd}, "
          f"its PlanSet implies {want_fwd}")
    check(c_bwd == want_bwd, f"jamba train flux backward launches {c_bwd}, "
          f"its PlanSet implies {want_bwd}")
    check(d2 == [0] * tp, f"the tp={tp} step at capacity E/k dropped {d2}")
    check(rel_loss <= JAMBA_F32_RTOL, f"jamba train tp={tp} flux step-0 "
          f"loss {loss2} vs tp=1 {loss1.item()}: relative {rel_loss}")
    check(rel[worst[0]] <= JAMBA_F32_RTOL, f"jamba train tp={tp} flux "
          f"step-0 grad of {worst[0]} vs tp=1: relative L2 "
          f"{rel[worst[0]]} > {JAMBA_F32_RTOL}")
    check(replayed["changed_not_near_tie"] == 0, f"jamba train tp={tp} "
          f"routing (replayed) vs tp=1: {replayed}")

    # (b) bf16: flux free running, then xla on flux's routing
    t0 = time.perf_counter()
    ranks = rank_weights(bf16)
    ffn.dropped.clear()
    with capture_routes() as rtb:
        losses_f, grads_f, cb_fwd, cb_bwd, host_f = step0_grads(
            torch, cfg_ek, par2, mesh, ranks, [batch0])
    free = _routing_vs(torch, [
        (pg.reshape(-1, pg.shape[-1]), eg.reshape(-1, eg.shape[-1]),
         pw.reshape(-1, pw.shape[-1]), ew.reshape(-1, ew.shape[-1]))
        for (pg, eg), (pw, ew) in zip(_layer_routes(torch, rtb.calls, bsz,
                                                    seq), routes1)])
    own = [[c[1:] for c in rtb.calls if c[0] == r] for r in range(tp)]
    del rtb, routes1
    db = ffn.drop_totals(tp)
    with replay_routes(lambda i, rank: own[rank][i]) as rr:
        losses_x, grads_x, cx_fwd, cx_bwd, host_x = step0_grads(
            torch, cfg_ek, dataclasses.replace(par2, overlap_mode="xla"),
            mesh, ranks, [batch0])
    replayed_x = _replayed(torch, rr.calls)
    del rr, own
    rel_b = {}
    for r in range(tp):
        for n in grads_f[r]:
            rel_b[f"{r}:{n}"] = _rel_l2(grads_x[r][n], grads_f[r][n])
    del grads_f, grads_x, ranks
    worst_b = sorted(rel_b, key=rel_b.get, reverse=True)
    rel_lx = max(abs(a - b) / abs(b) for a, b in zip(losses_x, losses_f))
    rel_lb = abs(losses_f[0] - loss1.item()) / abs(loss1.item())
    res["tp2_flux_bf16"] = {
        "dtype": "bfloat16", "step0_loss": losses_f[0],
        "loss_rel_vs_tp1_fp32": rel_lb, "xla_step0_losses": losses_x,
        "xla_loss_rel_vs_flux": rel_lx,
        "xla_grad_rel_l2_vs_flux_max": rel_b[worst_b[0]],
        "xla_grad_worst_leaf": worst_b[0],
        "xla_grad_rel_l2_vs_flux_worst_leaves": {
            n: rel_b[n] for n in worst_b[:8]},
        "routing_free_vs_tp1_fp32": free,
        "xla_routing_replayed_vs_flux": replayed_x,
        "dropped_assignments_per_rank": db,
        "launches_forward": cb_fwd, "launches_backward": cb_bwd,
        "xla_launches": {"forward": cx_fwd, "backward": cx_bwd},
        "step0_host": host_f, "xla_step0_host": host_x,
        "phase_s": time.perf_counter() - t0}
    check(cb_fwd == want_fwd and cb_bwd == want_bwd, f"jamba train bf16 "
          f"flux launches {cb_fwd} / {cb_bwd}, its PlanSet implies "
          f"{want_fwd} / {want_bwd}")
    check(all(c["ag_gemm"] == 0 and c["gemm_rs"] == 0
              for c in (cx_fwd, cx_bwd)),
          f"the jamba train xla step launched the fused kernels: "
          f"{cx_fwd} / {cx_bwd}")
    check(db == [0] * tp, f"the bf16 tp={tp} step at capacity E/k "
          f"dropped {db}")
    check(rel_lb <= TRAIN_LOSS_RTOL, f"jamba train tp={tp} bf16 flux "
          f"step-0 loss {losses_f[0]} vs tp=1 {loss1.item()}: relative "
          f"{rel_lb}")
    check(rel_lx <= JAMBA_BF16_MODES_RTOL
          and rel_b[worst_b[0]] <= JAMBA_BF16_MODES_RTOL,
          f"jamba train tp={tp} bf16 xla vs flux: loss relative {rel_lx}, "
          f"grad of {worst_b[0]} relative L2 {rel_b[worst_b[0]]}")
    for what, r in (("bf16 flux free vs tp=1", free),
                    ("bf16 xla replayed vs flux", replayed_x)):
        check(r["changed_not_near_tie"] == 0,
              f"jamba train tp={tp} routing ({what}): {r}")
    mesh.free_symmetric()
    del tr2, mesh
    torch.cuda.empty_cache()

    # ---- 3 Trainer steps at dp x tp, ZeRO-3, remat "full", flux -----------
    t0 = time.perf_counter()
    parz = ParallelConfig(tp=tp, dp=dp, zero3=True, remat="full",
                          ep_over_dp=True, fuse_w13=True,
                          overlap_mode="flux")
    trz = T.Trainer(cfg, parz, tc, device="cuda", dtype=bf16)
    trz.data_cfg = dataclasses.replace(trz.data_cfg, seq_len=seq,
                                       global_batch=bsz)
    ranksz, optsz = trz.init_state()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    flagged = sorted({n.split(".", 2)[2] for n in M.zero3_leaves(cfg, parz)
                      if n.split(".")[1] == "0"})
    plans = T.make_ctx(cfg, parz, mesh=trz.group, rank=0).plans
    fz, bz = plan_launches(plans, cfg, tp, 1)
    head = tp if plans.resolve("head_ag", None).mode == "flux" else 0
    recompute = {"ag_gemm": fz["ag_gemm"] - head, "gemm_rs": fz["gemm_rs"],
                 "gemm_rs_reduce": fz["gemm_rs_reduce"]}
    want = {n: dp * JAMBA_TRAIN_STEPS * (fz[n] + bz[n] + recompute.get(n, 0))
            for n in fz}
    torch.cuda.reset_peak_memory_stats()
    start_gb = torch.cuda.memory_allocated() / 1e9
    ffn.dropped.clear()
    zero_counts()
    ranksz, optsz, hist = trz.train(ranksz, optsz)
    torch.cuda.synchronize()
    counts = read_counts()
    losses = [h["loss"] for h in hist]
    ms = [h["seconds"] * 1e3 for h in hist]
    rel_0 = abs(losses[0] - loss1.item()) / abs(loss1.item())
    res["trainer"] = {
        "mesh": {"data": dp, "model": tp}, "zero3": True, "remat": "full",
        "ep_over_dp": True, "overlap_mode": "flux",
        "zero3_leaves_of_layer0": flagged,
        "losses": losses, "loss0_rel_vs_tp1": rel_0, "step_ms": ms,
        "step_ms_median": sorted(ms)[len(ms) // 2],
        "dropped_assignments_per_tp_rank": ffn.drop_totals(tp),
        "state_gb_after_init": start_gb,
        "assignments_a_step": bsz * seq * k,
        "launches": counts, "launches_expected": want,
        "launches_recompute_a_step_a_group": recompute,
        "init_s": init_s, "start_mem_gb": start_gb,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "weights_gb_all_ranks": sum(
            p.numel() * p.element_size() for r in ranksz
            for p in r.parameters()) / 1e9}
    check(all(map(math.isfinite, losses)), f"jamba trainer losses {losses}")
    check(rel_0 <= TRAIN_LOSS_RTOL, f"jamba trainer step-0 loss {losses[0]} "
          f"vs tp=1 {loss1.item()}: relative {rel_0}")
    check(counts == want, f"{JAMBA_TRAIN_STEPS} jamba ZeRO-3 remat flux "
          f"steps launched {counts}, expected {want}")
    res["trainer"]["profiled_step"] = device_profile(
        torch, lambda: trz.run_step(ranksz, optsz, trz.step_batch(0)),
        sums={"ag_gemm_ms": "ag_gemm", "gemm_rs_ms": "gemm_rs"})
    check(res["trainer"]["profiled_step"]["device_activities"] > 0,
          "the profiled jamba trainer step recorded no device activity")
    res["trainer"]["phase_s"] = time.perf_counter() - t0
    trz.group.free_symmetric()
    del ranksz, optsz, trz
    torch.cuda.empty_cache()
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["left_mem_gb"] = torch.cuda.memory_allocated() / 1e9
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    check(res["trainer"]["peak_mem_gb"] < 80, "the jamba trainer's peak "
          f"{res['trainer']['peak_mem_gb']:.1f} GB")
    check(res["left_mem_gb"] < res["baseline_mem_gb"] + 0.5, f"the jamba "
          f"train lane left {res['left_mem_gb']:.3f} GB allocated (it "
          f"started at {res['baseline_mem_gb']:.3f} GB)")
    return {kern: {"tp2_step0": {"forward": c_fwd[kern],
                                 "backward": c_bwd[kern]},
                   "tp2_step0_bf16": {"forward": cb_fwd[kern],
                                      "backward": cb_bwd[kern]},
                   "trainer_steps": counts[kern]}
            for kern in ("ag_gemm", "gemm_rs")}


def rwkv_cfg(layers=None):
    """The rwkv lane's model: rwkv6_3b at full width, all 32 layers, or
    its first ``layers``."""
    from repro_torch.configs.base import get_config
    cfg = get_config("rwkv6_3b")
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          num_layers=layers)


def rwkv_seam_cases(which):
    """(name, rows, K, N, activation) of one rank's AG-GEMM (``which=
    "ag"``: rows its sequence shard) or GEMM-RS (rows M, K its shard)
    operands at the flux seams of the rwkv lane's tp=RWKV_TP prefill over
    len(RWKV_LENGTHS) prompts padded to the longest: the time-mix's
    ``attn_ag`` (one launch over the five token-shift projections side by
    side: [h | prev] x the r, k, v, g column shards and the replicated
    w_dec1, a ragged N) and ``w_o``, the channel-mix's ``w_k`` with its
    squared-ReLU epilogue and ``w_v``."""
    from repro_torch.models.rwkv import _dims
    from repro_torch.parallel.sharding import ceil_mult

    cfg, tp = rwkv_cfg(), RWKV_TP
    m = len(RWKV_LENGTHS) * max(RWKV_LENGTHS)
    d, d_attn = cfg.d_model, _dims(cfg, tp)[2]
    ffp = ceil_mult(cfg.d_ff, tp * 128)
    if which == "ag":
        return [("ag_rwkv_time_mix", m // tp, 2 * d,
                 4 * d_attn // tp + cfg.rwkv.decay_lora, None),
                ("ag_rwkv_channel_mix", m // tp, d, ffp // tp, "sqrelu")]
    return [("rs_rwkv_time_out", m, d_attn // tp, d, None),
            ("rs_rwkv_channel_out", m, ffp // tp, d, None)]


def rwkv_train_seam_cases(which):
    """(name, rows, K, N, activation) of one rank's operands at two
    backward launches of the rwkv train lane's tp=RWKV_TP flux step over
    RWKV_TRAIN_BATCH x RWKV_TRAIN_SEQ tokens: ``w_o``'s dY, an AG-GEMM over
    the cotangent's sequence shard and the rank's rows of ``w_o``
    transposed (``which="ag"``: [M / tp, D] x [D, d_attn / tp]); the
    time-mix's dX, a GEMM-RS over the five projections' cotangent and the
    stacked weights transposed ([M, N_loc] x [N_loc, 2 D], N_loc = 4 d_attn
    / tp + the decay LoRA's rank: the lane's largest RS operand)."""
    from repro_torch.models.rwkv import _dims
    cfg, tp = rwkv_cfg(), RWKV_TP
    m, d = RWKV_TRAIN_BATCH * RWKV_TRAIN_SEQ, cfg.d_model
    d_attn = _dims(cfg, tp)[2]
    if which == "ag":
        return [("ag_rwkv_train_dy_w_o", m // tp, d, d_attn // tp, None)]
    return [("rs_rwkv_train_dx_time_mix", m,
             4 * d_attn // tp + cfg.rwkv.decay_lora, 2 * d, None)]


def _rwkv_two_ways(torch, S, model, cfg, ctx, tokens, lengths,
                   rows_alone=True):
    """Two ways to the same numbers on ``model``: one decode step after
    the batched prefill against one prefill over each prompt and its
    first token (N + 1, padded to a whole number of 64-position chunks),
    and with ``rows_alone`` each row's prefill alone at its own length
    against the batched prefill's (every layer's wkv state and both
    token-shift rows, the logits; a row of 777 tokens runs the
    reference's chunk rule down to chunks of 1).  Returns the readings
    (relative L2): the decode step's, and the worst row's a layer and
    leaf, the worst of all, the logits' a row."""
    vocab, layers = cfg.vocab_size, range(cfg.num_layers)
    lg, caches = S.prefill_logits(model, {"tokens": tokens}, ctx, cfg,
                                  lengths)
    state, logits = {}, {}
    for r, n in enumerate(lengths.tolist() if rows_alone else ()):
        lga, alone = S.prefill_logits(model, {"tokens": tokens[r:r + 1, :n]},
                                      ctx, cfg)
        logits[r] = _rel_l2(lga[0, :vocab], lg[r, :vocab])
        for i in layers:
            for k in ("state", "last", "ffn.last"):
                state[f"row{r}/layer{i}/{k}"] = _rel_l2(alone[i][k][0],
                                                        caches[i][k][r])
        del lga, alone
    first = S.vocab_parallel_argmax(lg, vocab)[:, None]
    step, _ = S.decode_logits(model, caches, first, lengths, ctx, cfg)
    b, s = tokens.shape
    ext = torch.zeros((b, -(-(s + 1) // 64) * 64), dtype=tokens.dtype,
                      device=tokens.device)
    for r, n in enumerate(lengths.tolist()):
        ext[r, :n] = tokens[r, :n]
        ext[r, n] = first[r, 0]
    lge, _ = S.prefill_logits(model, {"tokens": ext}, ctx, cfg, lengths + 1)
    out = {"decode1_rel_l2": _rel_l2(step[:, :vocab], lge[:, :vocab])}
    if state:
        worst = max(state, key=state.get)
        out.update(
            state_rel_l2_by_layer={
                k: [max(state[f"row{r}/layer{i}/{k}"] for r in range(b))
                    for i in layers] for k in ("state", "last", "ffn.last")},
            state_rel_l2_max=state[worst], state_rel_l2_worst=worst,
            logits_rel_l2=logits)
    return out


def phase_rwkv_lane(torch):
    """RWKV-6 served (``rwkv_cfg``: rwkv6_3b at full width, bf16, seed 0;
    the constants' comment).  The weights are drawn once, packed for
    tp=2, which pads and packs nothing at this width: they are the tp=1
    model (checked leaf for leaf against their canonical leaves).

    (a) The tp=1 anchor over all 32 layers: the batched prefill of 4 x
    1024 tokens (RWKV_LENGTHS), which launches no kernel (the GEMMs are
    local, the wkv is plain PyTorch, as the reference computes it outside
    any Pallas kernel); the freeze (other tokens at the pad positions give
    the same states and logits, bit for bit); each row alone at the
    batch's shape (the other rows one pad token each): the batch's states
    and logits bit for bit; 8 greedy decode steps (no kernel); then two
    ways to the same numbers (``_rwkv_two_ways``: each row alone at its
    own length, every layer's state and the logits; the first decode step
    against one prefill over each prompt and its first token, N + 1), held
    to TP_LANE_RTOL in fp32 on the same draw, the decode step also read in
    bf16 (the constants' comment).  (c)
    The paged Server at tp=1 over all 32 layers: the RWKV_PROMPTS requests
    together (the 73-token prompt's chunks interleaved with the others'
    decode steps), each alone: concurrent = isolated; all three again on
    the same server, in its freed slots (whose state the first chunk
    zeroes): the same tokens; no reuse hit.  (b) tp=RWKV_TP in flux with
    the kernels over the first RWKV_TP_LAYERS layers against tp=1 at that
    depth: the prefill, the counts set to 0 just before and read just
    after (the launches its PlanSet implies: one AG-GEMM over the
    time-mix's five weights, one with the channel-mix's squared-ReLU
    epilogue and two GEMM-RS a layer a rank); its logits and each rank's
    heads of the wkv state within TP_LANE_RTOL of tp=1's, its first
    tokens tp=1's but at a near tie; 8 decode steps teacher-forced on
    tp=1's tokens (no kernel), their logits within TP_LANE_RTOL.  (d)
    ``launch.serve --arch rwkv6_3b --layers RWKV_TP_LAYERS`` once: its
    requests served, its first tokens the argmax of its first-token
    logits.  Returns the tp=2 prefill's kernel launches."""
    import numpy as np
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.dist import RankGroup
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import model as M
    from repro_torch.models import serve as S
    from repro_torch.parallel.sharding import make_ctx
    from repro_torch.runtime.server import Request, ServeConfig, Server

    t_phase = time.perf_counter()
    cfg = rwkv_cfg()
    bf16, tp, vocab = torch.bfloat16, RWKV_TP, cfg.vocab_size
    b, s = len(RWKV_LENGTHS), max(RWKV_LENGTHS)
    n_layers = cfg.num_layers
    res = {"phase": "rwkv_lane", "arch": cfg.name,
           "layers": f"{n_layers} of {n_layers} at tp=1, {RWKV_TP_LAYERS} "
                     f"at tp={tp} (cut in depth)",
           "batch": b, "lengths": RWKV_LENGTHS, "decode_steps": RWKV_DECODE,
           "tp": tp, "rtol": TP_LANE_RTOL,
           "baseline_mem_gb": torch.cuda.memory_allocated() / 1e9}
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(13)
    tokens = torch.randint(0, vocab, (b, s), generator=gen, device="cuda")
    lengths = torch.tensor(RWKV_LENGTHS, device="cuda")
    par1 = ParallelConfig()

    t0 = time.perf_counter()
    one = M.init_model(cfg, ParallelConfig(tp=tp), seed=0, dtype=bf16,
                       device="cuda")
    named = {n: t.detach() for n, t in one.named_parameters()}
    canon = M.canonical_leaves(named, cfg, tp)
    like = dict(M.meta_model(cfg, par1).named_parameters())
    check(sorted(canon) == sorted(like) and all(
        torch.equal(canon[n], t) and t.shape == like[n].shape
        for n, t in named.items()),
        "rwkv: the tp=2 weights are not the tp=1 model leaf for leaf")
    del canon, named, like
    torch.cuda.synchronize()
    res.update(params=sum(t.numel() for t in one.parameters()),
               weights_gb=sum(t.numel() * t.element_size()
                              for t in one.parameters()) / 1e9,
               init_s=time.perf_counter() - t0)
    check(res["params"] == M.count_params_analytic(cfg),
          f"rwkv: {res['params']} weights, count_params_analytic "
          f"{M.count_params_analytic(cfg)}")

    # (a) the tp=1 anchor, all layers
    t0 = time.perf_counter()
    ctx1 = make_ctx(par1)
    torch.cuda.synchronize()
    zero_counts()
    t1 = time.perf_counter()
    lg, caches = S.prefill_logits(one, {"tokens": tokens}, ctx1, cfg,
                                  lengths)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t1) * 1e3
    counts = read_counts()
    check(not any(counts.values()), f"the rwkv tp=1 prefill launched "
          f"{counts}: its GEMMs are local and its wkv plain")
    check(bool(torch.isfinite(lg[:, :vocab]).all()),
          "rwkv: non-finite prefill logits")
    anchor = {"logits": [lg[:, :vocab].float()],
              "tokens": [S.vocab_parallel_argmax(lg, vocab)[:, None]]}
    layers = range(n_layers)
    # the freeze: other tokens at the pad positions leave every state and
    # every row's logits as they were, bit for bit
    noise = torch.randint(0, vocab, (b, s), generator=gen, device="cuda")
    pad = torch.arange(s, device="cuda")[None] >= lengths[:, None]
    lg_pad, c_pad = S.prefill_logits(
        one, {"tokens": torch.where(pad, noise, tokens)}, ctx1, cfg, lengths)
    frozen = torch.equal(lg_pad, lg) and all(
        torch.equal(c_pad[i][k], caches[i][k]) for i in layers
        for k in caches[i])
    del lg_pad, c_pad, noise
    check(frozen, "rwkv: other tokens at the pad positions moved the "
          "batched prefill's state or logits")
    # each row alone at the batch's shape (the other rows one pad token
    # each: every GEMM and the wkv at the batch's shapes)
    shape_lg = {}
    shape_equal = True
    for r, n in enumerate(RWKV_LENGTHS):
        solo = torch.zeros_like(tokens)
        solo[r] = tokens[r]
        solo_len = torch.ones_like(lengths)
        solo_len[r] = n
        lga, at = S.prefill_logits(one, {"tokens": solo}, ctx1, cfg,
                                   solo_len)
        shape_lg[r] = _rel_l2(lga[r, :vocab].float(), anchor["logits"][0][r])
        shape_equal &= torch.equal(lga[r], lg[r]) and all(
            torch.equal(at[i][k][r], caches[i][k][r]) for i in layers
            for k in caches[i])
        del at, lga, solo
    check(shape_equal, f"rwkv: each row alone at the batch's shape is not "
          f"the batched prefill's bit for bit (logits {shape_lg} relative "
          "L2)")
    # 8 decode steps from the prefill's caches (no sequence dim: the
    # serving layout as they are)
    zero_counts()
    step_ms = []
    for step in range(RWKV_DECODE):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lg, caches = S.decode_logits(one, caches, anchor["tokens"][-1],
                                     lengths + step, ctx1, cfg)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        anchor["logits"].append(lg[:, :vocab].float())
        anchor["tokens"].append(S.vocab_parallel_argmax(lg, vocab)[:, None])
    counts = read_counts()
    check(not any(counts.values()), f"the rwkv tp=1 decode launched {counts}")
    check(all(bool(torch.isfinite(x).all()) for x in anchor["logits"]),
          "rwkv: non-finite decode logits")
    del caches, lg
    # two ways to the same numbers (each row alone at its own length; one
    # decode step against a prefill of N + 1): held to TP_LANE_RTOL in fp32
    # (the same draw, not rounded); in bf16 the decode step is read (the
    # rows alone, which bf16 rounding alone moves past TP_LANE_RTOL at
    # this depth, are read by the constants' comment's script)
    t1 = time.perf_counter()
    two = {"bfloat16": _rwkv_two_ways(torch, S, one, cfg, ctx1, tokens,
                                      lengths, rows_alone=False)}
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    one32 = M.init_model(cfg32, ParallelConfig(tp=tp), seed=0,
                         dtype=torch.float32, device="cuda")
    two["float32"] = _rwkv_two_ways(torch, S, one32, cfg32, ctx1, tokens,
                                    lengths)
    del one32
    torch.cuda.empty_cache()
    two_s = time.perf_counter() - t1
    f32 = two["float32"]
    res["tp1"] = {
        "layers": n_layers, "prefill_host_ms": prefill_ms,
        "prefill_launches": {k: 0 for k in ("ag_gemm", "gemm_rs")},
        "pad_tokens_change_nothing": frozen,
        "at_batch_shape_bit_equal": shape_equal,
        "at_batch_shape_logits_rel_l2": shape_lg,
        "decode_step_host_ms": step_ms,
        "two_ways": two, "two_ways_s": two_s,
        "phase_s": time.perf_counter() - t0}
    check(f32["state_rel_l2_max"] <= TP_LANE_RTOL, f"rwkv fp32: "
          f"{f32['state_rel_l2_worst']} after the batched prefill "
          f"{f32['state_rel_l2_max']:.4g} relative L2 from the row's "
          f"prefill alone (rtol {TP_LANE_RTOL})")
    check(max(f32["logits_rel_l2"].values()) <= TP_LANE_RTOL, f"rwkv fp32: "
          f"each row's logits alone {f32['logits_rel_l2']} relative L2 from "
          f"the batched prefill's (rtol {TP_LANE_RTOL})")
    check(f32["decode1_rel_l2"] <= TP_LANE_RTOL, f"rwkv fp32: the first "
          f"decode step's logits {f32['decode1_rel_l2']:.4g} relative L2 "
          f"from a prefill of N + 1 (rtol {TP_LANE_RTOL})")

    # (c) the paged Server at tp=1, all layers
    t0 = time.perf_counter()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, vocab, size=(n,)).astype(np.int32)
               for n in RWKV_PROMPTS]
    sc = ServeConfig(max_batch=4, max_seq=256, eos_token=-1,
                     max_new_tokens=RWKV_NEW, block_size=16,
                     prefill_chunk=32)

    def serve(srv, which):
        done = srv.serve([Request(rid=i, prompt=prompts[i]) for i in which])
        check(all(r.done and r.error is None and len(r.output) == RWKV_NEW
                  and all(0 <= t < vocab for t in r.output) for r in done),
              "an rwkv Server request did not finish")
        return {r.rid: r.output for r in done}

    srv = Server(cfg, par1, one, sc)
    events = []
    chunk_fn, step_fn = srv.prefill_chunk, srv.step

    def chunk(job):
        events.append(("chunk", job.req.rid))
        return chunk_fn(job)

    def step():
        events.append(("decode", sum(srv.ready)))
        return step_fn()
    srv.prefill_chunk, srv.step = chunk, step
    zero_counts()
    t1 = time.perf_counter()
    concurrent = serve(srv, range(len(prompts)))
    serve_s = time.perf_counter() - t1
    # the wrappers hold srv's bound methods: while they live, srv and the
    # weights it holds live on in a reference cycle
    del srv.prefill_chunk, srv.step, chunk, step, chunk_fn, step_fn
    long_rid = RWKV_PROMPTS.index(max(RWKV_PROMPTS))
    at = [i for i, e in enumerate(events) if e == ("chunk", long_rid)]
    between = [e for e in events[at[0]:at[-1]] if e[0] == "decode" and e[1]]
    again = serve(srv, range(len(prompts)))      # in the freed slots
    agree = sum(int(serve(Server(cfg, par1, one, sc), [i])[i]
                    == concurrent[i]) for i in concurrent)
    counts = read_counts()
    res["server"] = {
        "prompt_lens": RWKV_PROMPTS, "new_tokens": RWKV_NEW,
        "max_batch": sc.max_batch, "prefill_chunk": sc.prefill_chunk,
        "block_size": sc.block_size, "tokens": concurrent,
        "concurrent_equals_isolated": f"{agree}/{len(prompts)}",
        "recycled_slots_equal": again == concurrent,
        "long_prompt_chunks": len(at),
        "decodes_between_its_chunks": len(between),
        "pool_peak_blocks": srv.pool.peak_blocks_in_use,
        "dense_equiv_blocks": srv.dense_equiv_blocks,
        "reuse_hits": srv.pool.reuse_hits, "prefix_reuse": srv._reuse_ok,
        "prefill_calls": srv.prefill_dispatches,
        "decode_calls": srv.decode_dispatches,
        "serve_wall_s": serve_s,
        "kernel_launches": {k: counts[k] for k in ("ag_gemm", "gemm_rs")},
        "phase_s": time.perf_counter() - t0}
    check(agree == len(prompts), f"rwkv Server concurrent vs isolated: "
          f"{agree}/{len(prompts)}")
    check(again == concurrent, f"rwkv Server: the requests again in the "
          f"freed slots gave {again}, first {concurrent}")
    check(len(at) == 3 and between, f"rwkv Server: the {max(RWKV_PROMPTS)}"
          f"-token prompt ran {len(at)} chunks with {len(between)} decode "
          "steps of other requests between them")
    check(srv.pool.reuse_hits == 0 and not srv._reuse_ok,
          "rwkv Server reused prompt blocks: its state is not paged")
    check(not any(counts.values()), f"the rwkv Server launched {counts}")
    del srv

    # (b) tp=2 in flux with the kernels, at RWKV_TP_LAYERS layers, against
    # tp=1 at that depth
    t0 = time.perf_counter()
    cut = rwkv_cfg(RWKV_TP_LAYERS)
    part = M.Model(one.embed, one.final_norm,
                   list(one.layers[:RWKV_TP_LAYERS]))
    del one
    torch.cuda.empty_cache()
    lg1, c1 = S.prefill_logits(part, {"tokens": tokens}, ctx1, cut, lengths)
    want = {"logits": [lg1[:, :vocab].float()],
            "tokens": [S.vocab_parallel_argmax(lg1, vocab)[:, None]]}
    # decode writes its caches in place: from a copy, c1 is compared below
    cl = [{k: v.clone() for k, v in c.items()} for c in c1]
    for step in range(RWKV_DECODE):
        lg1, cl = S.decode_logits(part, cl, want["tokens"][-1],
                                  lengths + step, ctx1, cut)
        want["logits"].append(lg1[:, :vocab].float())
        want["tokens"].append(S.vocab_parallel_argmax(lg1, vocab)[:, None])
    del cl, lg1
    ranks = [M.shard_params(part, r, tp, cut) for r in range(tp)]
    del part
    torch.cuda.empty_cache()
    group = RankGroup(tp, "cuda")
    par = ParallelConfig(tp=tp, overlap_mode="flux")
    ctx = make_ctx(par, group)

    def prefill(p):
        return S.prefill_logits(p, {"tokens": tokens}, ctx, cut, lengths)

    torch.cuda.synchronize()
    zero_counts()
    t1 = time.perf_counter()
    outs = group.spmd(prefill, [(p,) for p in ranks])
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t1) * 1e3
    counts = read_counts()
    plan = prefill_launches(ctx.plans, cut, tp, 1, False)
    got = {k: counts[k] for k in plan}
    check(got == plan, f"rwkv tp={tp} prefill launches {got}, its PlanSet "
          f"implies {plan}")
    lg = torch.cat([o[0] for o in outs], -1)[:, :vocab].float()
    rel = _rel_l2(lg, want["logits"][0])
    kept = []
    flips = _flips(torch, lg.argmax(-1).tolist(),
                   want["tokens"][0][:, 0].tolist(), lg, want["logits"][0],
                   kept)
    hl = ranks[0].layers[0].mixer["u_bonus"].numel() // cfg.rwkv.head_dim
    state_rel = {}
    for r, o in enumerate(outs):
        for i in range(RWKV_TP_LAYERS):
            state_rel[f"rank{r}/layer{i}"] = _rel_l2(
                o[1][i]["state"], c1[i]["state"][:, r * hl:(r + 1) * hl])
    worst_state = max(state_rel, key=state_rel.get)
    check(rel <= TP_LANE_RTOL, f"rwkv tp={tp}: prefill logits {rel:.4g} "
          f"relative L2 from tp=1's (rtol {TP_LANE_RTOL})")
    check(state_rel[worst_state] <= TP_LANE_RTOL, f"rwkv tp={tp}: "
          f"{worst_state}'s wkv state {state_rel[worst_state]:.4g} relative "
          f"L2 from tp=1's heads (rtol {TP_LANE_RTOL})")
    _near_ties_only(f"rwkv tp={tp} prefill", flips, kept)
    caches = [o[1] for o in outs]
    del outs, c1
    rels, dflips, dkept, dstep_ms = [], {}, [], []
    zero_counts()
    for step in range(RWKV_DECODE):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        outs = group.spmd(
            lambda p, c, step=step: S.decode_logits(
                p, c, want["tokens"][step], lengths + step, ctx, cut)[0],
            list(zip(ranks, caches)))
        torch.cuda.synchronize()
        dstep_ms.append((time.perf_counter() - t1) * 1e3)
        lg = torch.cat(outs, -1)[:, :vocab].float()
        want_lg = want["logits"][step + 1]
        rels.append(_rel_l2(lg, want_lg))
        for row, f in _flips(torch, lg.argmax(-1).tolist(),
                             want["tokens"][step + 1][:, 0].tolist(), lg,
                             want_lg, dkept).items():
            dflips[f"{step}/{row}"] = f
    counts = read_counts()
    decode_launches = {k: counts[k] for k in ("ag_gemm", "gemm_rs")}
    res[f"tp{tp}_flux"] = {
        "layers": RWKV_TP_LAYERS,
        "prefill_launches": got, "prefill_launches_planset": plan,
        "prefill_host_ms": host_ms, "prefill_logits_rel_l2_vs_tp1": rel,
        "prefill_token_flips": flips,
        "state_rel_l2_vs_tp1_max": state_rel[worst_state],
        "state_rel_l2_worst": worst_state,
        "state_rel_l2_vs_tp1_first_last_layer": {
            k: v for k, v in state_rel.items()
            if k.split("/")[1] in ("layer0",
                                   f"layer{RWKV_TP_LAYERS - 1}")},
        "decode_logits_rel_l2_vs_tp1": rels, "decode_token_flips": dflips,
        "decode_step_host_ms": dstep_ms, "decode_launches": decode_launches,
        "phase_s": time.perf_counter() - t0}
    check(max(rels) <= TP_LANE_RTOL, f"rwkv tp={tp} decode logits {rels} "
          f"relative L2 from tp=1's (rtol {TP_LANE_RTOL})")
    check(not any(decode_launches.values()), "rwkv's replicated-layout "
          f"decode launched a kernel: {decode_launches}")
    _near_ties_only(f"rwkv tp={tp} decode", dflips, dkept)
    group.free_symmetric()
    del caches, ranks, group, outs, lg, want
    torch.cuda.empty_cache()

    # (d) the serve CLI
    t0 = time.perf_counter()
    cli, done = launch_serve.main(RWKV_ARGV)
    check(len(done) == 2 and all(
        r.done and r.error is None and len(r.output) == RWKV_NEW
        and all(0 <= t < vocab for t in r.output) for r in done),
        "launch.serve --arch rwkv6_3b did not serve its requests")
    firsts = first_logits(torch, cli, {r.rid: r.prompt for r in done})
    check(all(int(firsts[r.rid].argmax()) == r.output[0] for r in done),
          "the rwkv CLI's first tokens are not the argmax of its "
          "first-token logits")
    res["cli"] = {"argv": RWKV_ARGV, "tokens": {r.rid: r.output
                                                for r in done},
                  "reuse_hits": cli.pool.reuse_hits,
                  "phase_s": time.perf_counter() - t0}
    del cli, anchor, firsts
    torch.cuda.empty_cache()
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["left_mem_gb"] = torch.cuda.memory_allocated() / 1e9
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    check(res["left_mem_gb"] < res["baseline_mem_gb"] + 0.5, f"the rwkv "
          f"lane left {res['left_mem_gb']:.3f} GB allocated (it started at "
          f"{res['baseline_mem_gb']:.3f} GB)")
    return {"ag_gemm": {f"tp{tp}_prefill": got["ag_gemm"]},
            "gemm_rs": {f"tp{tp}_prefill": got["gemm_rs"]}}


def rwkv_wkv_checks(torch):
    """The chunked wkv's backward on the card (``rwkv.wkv``: ``_WKV``,
    plain PyTorch): its grads for r, k, v, logw, u and s0 against autograd
    through the step-by-step WKV6 recurrence written from its definition
    (S_t = diag(w_t) S_{t-1} + k_t v_t^T, y_t = r_t^T (S_{t-1} + diag(u)
    k_t v_t^T)) at RWKV_WKV_CHECK, 40 heads of 64, fp32, within TOL; and at
    the lane's tp=1 shape [4, 40, 1024, 64] (16 chunks of 64): the bytes
    the forward saves (``saved_tensors_hooks``: its inputs and the state
    carried into each chunk, exactly), beside what autograd through the
    chunk loop itself saves and holds, and the memory the backward adds,
    within RWKV_WKV_MEM_GB; each pass's host ms."""
    from repro_torch.models import rwkv as RW
    cfg = rwkv_cfg()
    dh = cfg.rwkv.head_dim
    h = cfg.d_model // dh
    gen = torch.Generator(device="cuda").manual_seed(23)

    def inputs(b, s):
        def rnd(*shape, scale=1.0):
            return torch.randn(shape, generator=gen, device="cuda") * scale
        return [rnd(b, h, s, dh), rnd(b, h, s, dh), rnd(b, h, s, dh),
                -torch.exp(rnd(b, h, s, dh, scale=0.5) - 3.0),
                rnd(h, dh, scale=0.5), rnd(b, h, dh, dh)]

    def stepwise(r, k, v, logw, u, st):
        ys = []
        for t in range(r.shape[2]):
            kv = k[:, :, t, :, None] * v[:, :, t, None, :]
            ys.append(torch.matmul(r[:, :, t, None, :],
                                   st + u[None, :, :, None] * kv)[:, :, 0])
            st = torch.exp(logw[:, :, t])[..., None] * st + kv
        return torch.stack(ys, 2), st

    names = ("r", "k", "v", "logw", "u", "s0")
    b, s, chunk = RWKV_WKV_CHECK
    args = [t.requires_grad_() for t in inputs(b, s)]
    wy = torch.randn((b, h, s, dh), generator=gen, device="cuda")
    ws = torch.randn((b, h, dh, dh), generator=gen, device="cuda")
    grads = []
    for fn in (lambda *a: RW.wkv(*a, chunk=chunk), stepwise):
        y, st = fn(*args)
        grads.append(torch.autograd.grad((y * wy).sum() + (st * ws).sum(),
                                         args))
    rels = {n: _rel_l2(got, want) for n, got, want in zip(names, *grads)}
    del args, grads, y, st
    worst = max(rels, key=rels.get)
    check(rels[worst] <= TOL["float32"], f"the wkv's grad of {worst} on the "
          f"card {rels[worst]:.3g} relative L2 from the step-by-step "
          f"recurrence's (rtol {TOL['float32']})")

    bl, sl = RWKV_TRAIN_BATCH, RWKV_TRAIN_SEQ
    args = [t.requires_grad_() for t in inputs(bl, sl)]
    step = RW._chunk_len(sl, 64)
    n_chunks = sl // step

    def forward(fn):
        """(outputs, bytes saved, allocated bytes the forward left, host
        ms) of one forward under grad."""
        saved = []

        def pack(t):
            saved.append(t.numel() * t.element_size())
            return t
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = fn()
        torch.cuda.synchronize()
        return (out, sum(saved), torch.cuda.memory_allocated() - before,
                (time.perf_counter() - t0) * 1e3)

    # autograd through the chunk loop itself, for the record
    out, plain_saved, plain_held, plain_ms = forward(
        lambda: RW._wkv_loop(*args, step))
    del out
    torch.cuda.empty_cache()
    (y, _), saved, held, fwd_ms = forward(lambda: RW.wkv(*args))
    dy = torch.randn_like(y)
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = torch.autograd.grad(y, args, dy)
    torch.cuda.synchronize()
    bwd_ms = (time.perf_counter() - t0) * 1e3
    added = (torch.cuda.max_memory_allocated() - start) / 1e9
    finite = all(bool(torch.isfinite(t).all()) for t in g)
    states = n_chunks * bl * h * dh * dh * 4
    inputs_b = sum(t.numel() * t.element_size() for t in args)
    del args, y, dy, g
    torch.cuda.empty_cache()
    out = {"grad_check": {"shape": [b, h, s, dh], "chunk": chunk,
                          "rel_l2_vs_stepwise": rels},
           "shape": [bl, h, sl, dh], "chunks": n_chunks,
           "saved_bytes": saved, "saved_input_bytes": inputs_b,
           "saved_state_bytes": states, "forward_held_bytes": held,
           "plain_autograd": {"saved_bytes": plain_saved,
                              "forward_held_bytes": plain_held,
                              "forward_host_ms": plain_ms},
           "backward_added_gb": added, "backward_gb_limit": RWKV_WKV_MEM_GB,
           "forward_host_ms": fwd_ms, "backward_host_ms": bwd_ms}
    check(finite, "the wkv's grads at the lane's shape are not finite")
    check(saved == inputs_b + states, f"the wkv saved {saved} bytes, its "
          f"inputs {inputs_b} and the chunk states {states}")
    check(added <= RWKV_WKV_MEM_GB, f"the wkv's backward added {added:.3f} "
          f"GB at {out['shape']} (limit {RWKV_WKV_MEM_GB})")
    return out


def phase_rwkv_train_lane(torch):
    """RWKV-6 trained (rwkv6_3b at full width, weights from seed 0, batch
    RWKV_TRAIN_BATCH x RWKV_TRAIN_SEQ from data/pipeline.py; the
    constants' comment).  (a) The wkv's backward (``rwkv_wkv_checks``).
    (b) The main path: step 0 at tp=RWKV_TP in flux in the
    sequence-sharded layout (the time-mix's AG-GEMM over its five weights,
    the channel-mix's with the squared-ReLU epilogue, the GEMM-RS on
    ``w_o`` and ``w_v`` forward, their interchanged kernels backward), in
    fp32, over the first RWKV_TP_LAYERS layers and over the first
    RWKV_GATE_LAYERS, each time with the counts set to 0 just before and
    read just after (the launches its PlanSet implies), against step 0 at
    tp=1 on the same leaves: at RWKV_GATE_LAYERS the loss and every
    canonical grad / tp within JAMBA_F32_RTOL; at RWKV_TP_LAYERS read,
    beside the rounding floor (tp=1 on the weights moved by one fp32
    rounding).  (c) The same steps in bf16, flux then xla: at
    RWKV_GATE_LAYERS each rank's loss and every grad within
    JAMBA_BF16_MODES_RTOL, at RWKV_TP_LAYERS read, the flux loss against
    tp=1's fp32 within TRAIN_LOSS_RTOL.  The weights are drawn packed for
    tp=RWKV_TP, which pads and packs nothing at this width: they are the
    tp=1 model (the rwkv lane checks it leaf for leaf).  (d) The Trainer
    at tp=1 over all 32 layers, bf16 weights and fp32 moments,
    RWKV_TRAIN_STEPS steps, with the training CLI's remat for this arch:
    finite losses, step 0's loss against a separate ``forward_loss`` of
    the same weights and batch, step ms, peak memory, a profiled step's
    busy share.  Returns the fused launches of the RWKV_TP_LAYERS-layer
    tp=2 steps 0 and of the trainer's steps (none at tp=1)."""
    from repro_torch.configs.base import ParallelConfig, train_schedule
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model as M
    from repro_torch.runtime import trainer as T

    t_phase = time.perf_counter()
    cfg = rwkv_cfg()
    cut = rwkv_cfg(RWKV_TP_LAYERS)
    tp, bf16, f32 = RWKV_TP, torch.bfloat16, torch.float32
    bsz, seq = RWKV_TRAIN_BATCH, RWKV_TRAIN_SEQ
    tc = T.TrainConfig(total_steps=RWKV_TRAIN_STEPS, warmup_steps=0,
                       base_lr=3e-4, schedule=train_schedule(cfg.name),
                       log_every=RWKV_TRAIN_STEPS, max_retries=0)
    res = {"phase": "rwkv_train_lane", "arch": cfg.name,
           "reduced": {"num_layers": f"{RWKV_TP_LAYERS} of 32 in the tp=2 "
                                     "steps 0 (the rwkv lane's tp cut), "
                                     f"{RWKV_GATE_LAYERS} in their gates "
                                     "(the constants' comment); all 32 in "
                                     "the Trainer"},
           "batch": bsz, "seq": seq, "steps": RWKV_TRAIN_STEPS,
           "schedule": tc.schedule, "fp32_rtol": JAMBA_F32_RTOL,
           "bf16_modes_rtol": JAMBA_BF16_MODES_RTOL,
           "loss_rtol": TRAIN_LOSS_RTOL,
           "ln_vocab": math.log(cfg.vocab_size),
           "baseline_mem_gb": torch.cuda.memory_allocated() / 1e9}
    t0 = time.perf_counter()
    res["wkv"] = rwkv_wkv_checks(torch)
    res["wkv"]["phase_s"] = time.perf_counter() - t0
    batch0 = {n: torch.from_numpy(v).cuda() for n, v in batch_at(
        DataConfig(cfg.vocab_size, seq, bsz), 0).items()}

    # ---- (b) step 0 in fp32 at tp=2 in flux (the main path) against tp=1 --
    t0 = time.perf_counter()
    par1 = ParallelConfig()
    par2 = ParallelConfig(tp=tp, overlap_mode="flux")
    tr2 = T.Trainer(dataclasses.replace(cut, compute_dtype="float32"), par2,
                    tc, device="cuda", dtype=f32)
    mesh = tr2.group
    plans = T.make_ctx(cut, par2, mesh=mesh, rank=0).plans
    check(plans.residual_layout() == "seq",
          "the rwkv tp=2 step is not sequence-sharded")

    def first(model, layers):
        """The model's first ``layers`` layers (the same leaves)."""
        return M.Model(model.embed, model.final_norm,
                       list(model.layers[:layers]), model.trainable)

    def tp1_step(model, c):
        c = dataclasses.replace(c, compute_dtype="float32")
        loss, g = T.loss_and_grads(model, batch0, T.make_ctx(c, par1), c,
                                   par1)
        return loss.item(), M.canonical_leaves(g, c, 1, grads=True)

    def tp2_step(model, c, dtype, mode="flux"):
        """Step 0 at tp=2 on ``model``'s leaves in ``mode``: (every rank's
        loss, every rank's grads, canonical grads / tp, launches forward
        and backward, the launches its PlanSet implies, host figures)."""
        c = dataclasses.replace(c, compute_dtype=str(dtype)[6:])
        par = dataclasses.replace(par2, overlap_mode=mode)
        ranks = [M.shard_params(model, r, tp, c) for r in range(tp)]
        losses, grads, c_fwd, c_bwd, host = step0_grads(
            torch, c, par, mesh, ranks, [batch0])
        can = synced_canonical(torch, c, par, mesh, ranks, grads)
        want = plan_launches(T.make_ctx(c, par, mesh=mesh, rank=0).plans, c,
                             tp, 1)
        return losses, grads, can, (c_fwd, c_bwd), want, host

    def versus(can, ref):
        rel = {n: _rel_l2(g, ref[n]) for n, g in can.items()}
        check(set(rel) == set(ref), "rwkv tp=2 and tp=1 canonical leaves "
              "differ")
        worst = sorted(rel, key=rel.get, reverse=True)
        return {"grad_rel_l2_max": rel[worst[0]], "grad_worst_leaf": worst[0],
                "grad_rel_l2_worst_leaves": {n: rel[n] for n in worst[:6]}}

    def launches_ok(what, got, want):
        check(got == want, f"rwkv train {what} launches {got[0]} / {got[1]}, "
              f"its PlanSet implies {want[0]} / {want[1]}")
        return {"launches_forward": got[0], "launches_backward": got[1],
                "launches_planset": {"forward": want[0],
                                     "backward": want[1]}}

    torch.cuda.reset_peak_memory_stats()
    p32 = M.init_model(cut, par2, seed=0, dtype=f32, device="cuda",
                       trainable=True)
    gate = rwkv_cfg(RWKV_GATE_LAYERS)
    out32 = {}
    for layers, c in ((RWKV_TP_LAYERS, cut), (RWKV_GATE_LAYERS, gate)):
        model = p32 if layers == RWKV_TP_LAYERS else first(p32, layers)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss1, g1 = tp1_step(model, c)
        tp1_ms = (time.perf_counter() - t1) * 1e3
        losses, grads, can, got, want, host = tp2_step(model, c, f32)
        del grads
        rel_loss = abs(losses[0] - loss1) / abs(loss1)
        out32[layers] = {"layers": layers, "tp1_step0_loss": loss1,
                         "tp1_step0_host_ms": tp1_ms,
                         "step0_loss": losses[0], "loss_rel_vs_tp1": rel_loss,
                         **versus(can, g1),
                         **launches_ok(f"fp32 {layers}-layer flux", got,
                                       want),
                         "step0_host": host}
        check(math.isfinite(loss1), f"rwkv tp=1 step-0 loss {loss1}")
        del can
        if layers == RWKV_TP_LAYERS:
            # the rounding floor: tp=1 on the weights moved by one rounding
            gen = torch.Generator(device="cuda").manual_seed(1)
            with torch.no_grad():
                moved = M.Model(*(t * (1 + 2.0 ** -24 * torch.randn(
                    t.shape, generator=gen, device="cuda"))
                    for t in (p32.embed, p32.final_norm)),
                    [M.Block(*({n: t * (1 + 2.0 ** -24 * torch.randn(
                        t.shape, generator=gen, device="cuda"))
                        for n, t in part.items()}
                        for part in (blk.mixer, blk.ffn)))
                     for blk in p32.layers], True)
            loss_m, g_m = tp1_step(moved, c)
            del moved
            out32[layers]["rounding_floor"] = {
                "loss_rel": abs(loss_m - loss1) / abs(loss1),
                **versus(g_m, g1)}
            del g_m
            c_fwd, c_bwd = got
        else:
            check(rel_loss <= JAMBA_F32_RTOL, f"rwkv train tp={tp} flux "
                  f"step-0 loss {losses[0]} vs tp=1 {loss1}: relative "
                  f"{rel_loss}")
            worst = out32[layers]["grad_worst_leaf"]
            check(out32[layers]["grad_rel_l2_max"] <= JAMBA_F32_RTOL,
                  f"rwkv train tp={tp} flux step-0 grad of {worst} vs tp=1 "
                  f"at {layers} layers: relative L2 "
                  f"{out32[layers]['grad_rel_l2_max']} > {JAMBA_F32_RTOL}")
        del g1
        torch.cuda.empty_cache()
    loss32 = out32[RWKV_TP_LAYERS]["tp1_step0_loss"]
    res[f"tp{tp}_flux"] = {"dtype": "float32", "gate_layers":
                           RWKV_GATE_LAYERS, "depths": out32,
                           "step0_peak_gb":
                               torch.cuda.max_memory_allocated() / 1e9,
                           "phase_s": time.perf_counter() - t0}
    del p32, model
    torch.cuda.empty_cache()

    # ---- (c) bf16 at tp=2: flux, then xla ---------------------------------
    t0 = time.perf_counter()
    p16 = M.init_model(cut, par2, seed=0, dtype=bf16, device="cuda",
                       trainable=True)
    out16 = {}
    for layers, c in ((RWKV_TP_LAYERS, cut), (RWKV_GATE_LAYERS, gate)):
        model = p16 if layers == RWKV_TP_LAYERS else first(p16, layers)
        lf, gf, _, got, want, host_f = tp2_step(model, c, bf16)
        lx, gx, _, got_x, _, host_x = tp2_step(model, c, bf16, "xla")
        rel_b = {f"{r}:{n}": _rel_l2(gx[r][n], gf[r][n])
                 for r in range(tp) for n in gf[r]}
        del gf, gx
        worst_b = sorted(rel_b, key=rel_b.get, reverse=True)
        rel_lx = max(abs(a - b) / abs(b) for a, b in zip(lx, lf))
        out16[layers] = {
            "layers": layers, "step0_losses": lf, "xla_step0_losses": lx,
            "xla_loss_rel_vs_flux": rel_lx,
            "xla_grad_rel_l2_vs_flux_max": rel_b[worst_b[0]],
            "xla_grad_worst_leaf": worst_b[0],
            "xla_grad_rel_l2_vs_flux_worst_leaves": {
                n: rel_b[n] for n in worst_b[:6]},
            **launches_ok(f"bf16 {layers}-layer flux", got, want),
            "xla_launches": {"forward": got_x[0], "backward": got_x[1]},
            "step0_host": host_f, "xla_step0_host": host_x}
        check(all(x["ag_gemm"] == 0 and x["gemm_rs"] == 0 for x in got_x),
              f"the rwkv train xla step launched the fused kernels: "
              f"{got_x}")
        if layers == RWKV_TP_LAYERS:
            rel_lb = abs(lf[0] - loss32) / abs(loss32)
            out16[layers]["loss_rel_vs_tp1_fp32"] = rel_lb
            check(rel_lb <= TRAIN_LOSS_RTOL, f"rwkv train tp={tp} bf16 flux "
                  f"step-0 loss {lf[0]} vs tp=1 fp32 {loss32}: relative "
                  f"{rel_lb}")
            cb_fwd, cb_bwd = got
        else:
            check(rel_lx <= JAMBA_BF16_MODES_RTOL
                  and rel_b[worst_b[0]] <= JAMBA_BF16_MODES_RTOL,
                  f"rwkv train tp={tp} bf16 xla vs flux at {layers} layers: "
                  f"loss relative {rel_lx}, grad of {worst_b[0]} relative "
                  f"L2 {rel_b[worst_b[0]]}")
    res[f"tp{tp}_flux_bf16"] = {"dtype": "bfloat16", "gate_layers":
                                RWKV_GATE_LAYERS, "depths": out16,
                                "phase_s": time.perf_counter() - t0}
    mesh.free_symmetric()
    del p16, model, tr2, mesh
    torch.cuda.empty_cache()

    # ---- (d) the Trainer at tp=1, all 32 layers, the CLI's remat ----------
    t0 = time.perf_counter()
    par = launch_train.parallel_config(launch_train.parse_args(
        ["--arch", cfg.name]), cfg)
    tr = T.Trainer(cfg, par, tc, device="cuda", dtype=bf16)
    tr.data_cfg = dataclasses.replace(tr.data_cfg, seq_len=seq,
                                      global_batch=bsz)
    params, opts = tr.init_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(all(torch.equal(tr.batch(0)[n], batch0[n]) for n in batch0),
          "the trainer's first batch is not the step-0 comparisons' batch")
    with torch.no_grad():
        want0 = M.forward_loss(params[0], batch0, T.make_ctx(cfg, par), cfg,
                               par).item()
    torch.cuda.reset_peak_memory_stats()
    start_gb = torch.cuda.memory_allocated() / 1e9
    zero_counts()
    params, opts, hist = tr.train(params, opts)
    torch.cuda.synchronize()
    counts = read_counts()
    losses = [h["loss"] for h in hist]
    ms = [h["seconds"] * 1e3 for h in hist]
    rel_0 = abs(losses[0] - want0) / abs(want0)
    res["trainer"] = {
        "tp": 1, "layers": cfg.num_layers, "remat": par.remat,
        "dtype": "bfloat16 weights, float32 moments",
        "losses": losses, "forward_loss_step0": want0,
        "loss0_rel_vs_forward_loss": rel_0, "step_ms": ms,
        "step_ms_median": sorted(ms)[len(ms) // 2],
        "launches": {k: counts[k] for k in ("ag_gemm", "gemm_rs")},
        "weights": sum(p.numel() for p in params[0].parameters()),
        "init_s": init_s, "start_mem_gb": start_gb,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    check(all(map(math.isfinite, losses)), f"rwkv trainer losses {losses}")
    check(rel_0 <= TRAIN_LOSS_RTOL, f"rwkv trainer step-0 loss {losses[0]} "
          f"vs forward_loss {want0}: relative {rel_0}")
    check(not any(counts.values()), f"the tp=1 rwkv trainer launched "
          f"{counts}: its GEMMs are local and its wkv plain")
    res["trainer"]["profiled_step"] = device_profile(
        torch, lambda: tr.run_step(params, opts, tr.step_batch(0)))
    check(res["trainer"]["profiled_step"]["device_activities"] > 0,
          "the profiled rwkv trainer step recorded no device activity")
    res["trainer"]["phase_s"] = time.perf_counter() - t0
    del params, opts, tr, hist
    torch.cuda.empty_cache()
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["left_mem_gb"] = torch.cuda.memory_allocated() / 1e9
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    check(res["trainer"]["peak_mem_gb"] < 80, "the rwkv trainer's peak "
          f"{res['trainer']['peak_mem_gb']:.1f} GB")
    check(res["left_mem_gb"] < res["baseline_mem_gb"] + 0.5, f"the rwkv "
          f"train lane left {res['left_mem_gb']:.3f} GB allocated (it "
          f"started at {res['baseline_mem_gb']:.3f} GB)")
    return {kern: {"tp2_step0": {"forward": c_fwd[kern],
                                 "backward": c_bwd[kern]},
                   "tp2_step0_bf16": {"forward": cb_fwd[kern],
                                      "backward": cb_bwd[kern]},
                   "tp1_trainer_steps": counts[kern]}
            for kern in ("ag_gemm", "gemm_rs")}


def prefill_launches(plans, cfg, tp, mlp_weights, use_kernels):
    """The kernels one prefill launches at ``tp``, read off a ``PlanSet``:
    a rank's flux seam in the sequence-sharded layout launches one AG-GEMM
    (an ag seam: one a weight when its gather is not shared) or one
    GEMM-RS and its reduce (an rs seam); the head gathers its rows plainly
    and launches none; with ``use_kernels`` every GQA layer's attention is
    one flash launch a rank.  Every rank's, summed."""
    from repro_torch.configs.base import ATTN
    from repro_torch.models import model as M
    fwd, _ = plan_launches(plans, cfg, tp, mlp_weights)
    if plans.residual_layout() == "seq" and plans.resolve(
            "head_ag", None).mode == "flux":
        fwd["ag_gemm"] -= tp          # the train step's head_ag seam
    n_attn = sum(mk == ATTN for mk, _ in M.expanded_pattern(cfg))
    fwd["flash_attention"] = n_attn * tp if use_kernels else 0
    return fwd


def plan_launches(plans, cfg, tp, mlp_weights):
    """The fused kernels one train step launches at ``tp``, read off a
    ``PlanSet``: ({"ag_gemm", "gemm_rs", "gemm_rs_reduce"} of the forward,
    the same of the backward), every rank's.  A flux seam in the
    sequence-sharded layout launches, a rank: an ag seam one AG-GEMM
    forward (one a weight when its gather is not shared) and one GEMM-RS
    backward (its dX over all weights); an rs seam one GEMM-RS forward and
    one AG-GEMM backward.  An MLA layer's ``attn_ag`` runs twice (the q
    and the kv up-projections, distinct inputs); a Mamba layer's
    ``attn_ag`` carries its in-projections as ``mlp_weights`` weights
    (``w_in_x`` and ``w_in_z``, or the packed ``w_in_xz``: ``fuse_w13``
    packs both pairs) and its ``decode_ar`` x-projection launches none;
    an RWKV layer's ``attn_ag`` carries its five token-shift projections
    (r, k, v, g, w_dec1) and its channel-mix's ``mlp_ag`` the one ``w_k``;
    an MoE layer's
    ``mlp_ag`` / ``mlp_rs`` are its shared expert's (its ``moe_a2a``
    launches none); the MTP head, when the config has one, is one more
    block at the default plan and a second ``head_ag``.  Each layer
    resolves at its reference layer id (``model.layer_slot``); the
    replicated layout launches none."""
    from repro_torch.configs.base import MAMBA, MLA, MOE_FFN, RWKV
    from repro_torch.models import model as M
    fwd = {"ag_gemm": 0, "gemm_rs": 0}
    bwd = {"ag_gemm": 0, "gemm_rs": 0}
    if plans.residual_layout() == "seq":
        def add(seam, layer, n_weights=1, times=1):
            p = plans.resolve(seam, layer)
            if p.mode != "flux":
                return
            if seam.endswith("_ag"):
                fwd["ag_gemm"] += times * (1 if p.shared_gather
                                           else n_weights)
                bwd["gemm_rs"] += times
            else:
                fwd["gemm_rs"] += times
                bwd["ag_gemm"] += times

        def block(layer, kinds):
            add("attn_ag", layer,
                {MAMBA: mlp_weights, RWKV: 5}.get(kinds[0], 1),
                times=2 if kinds[0] == MLA else 1)
            add("attn_rs", layer)
            if kinds[1] != MOE_FFN or cfg.moe.num_shared_experts:
                add("mlp_ag", layer, 1 if kinds[1] == RWKV else mlp_weights)
                add("mlp_rs", layer)
        for j, kinds in enumerate(M.expanded_pattern(cfg)):
            block(M.layer_slot(cfg, j), kinds)
        add("head_ag", None)
        if cfg.mtp_depth:
            block(None, M.mtp_kinds(cfg))
            add("head_ag", None)
    out = []
    for c in (fwd, bwd):
        c = {k: v * tp for k, v in c.items()}
        c.update(gemm_rs_reduce=c["gemm_rs"], flash_attention=0, matmul=0)
        out.append(c)
    return tuple(out)


def sweep_launches(results, cfg, par, calls):
    """The fused kernels a measured sweep launches: ``calls`` of each flux
    row's op, every rank's (an ag row one AG-GEMM, or one a weight when
    its gather is not shared; an rs row one GEMM-RS and its reduce), each
    row checked to be measured."""
    from repro_torch.tuning import autotune as AT
    from repro_torch.tuning import seam_of
    want = {"ag_gemm": 0, "gemm_rs": 0, "gemm_rs_reduce": 0,
            "flash_attention": 0, "matmul": 0}
    for r in results:
        check(r.source == "measured", f"{r.seam}: tuned {r.source}")
        nw = AT.seam_op_shape(cfg, par, seam_of(r.seam)).get("n_weights", 1)
        for row in r.table:
            check(row["measured_s"] > 0, f"{r.seam}: an untimed row {row}")
            if row["mode"] != "flux":
                continue
            if r.kind == "ag":
                want["ag_gemm"] += calls * (1 if row["shared_gather"]
                                            else nw)
            else:
                want["gemm_rs"] += calls
                want["gemm_rs_reduce"] += calls
    return want


def _seam_plain(torch, kind, layout, epi, args):
    """Every rank's plain output of a seam's op from all ranks' inputs
    (``tuning.autotune.bench_inputs``): fp32 products of the bf16 inputs,
    the epilogue in fp32."""
    n = len(args)
    if kind == "ag":
        full = (None if layout == "hidden"
                else torch.cat([a[0] for a in args], dim=-2).float())
        return [epi.apply([(a[0].float() if full is None else full)
                           @ w.float() for w in a[1:]]) for a in args]
    total = sum(a[0].float() @ a[1].float() for a in args)
    if kind == "rs" and layout == "seq":
        sh = total.shape[-2] // n
        return [total[..., r * sh:(r + 1) * sh, :] for r in range(n)]
    return [total] * n


def phase_tune_lane(torch, tp1_tokens):
    """The seam plans and the tuner on the card (minicpm_2b at full width,
    tp=4, 4 ranks of a RankGroup on the one card):

    1. the AG-GEMM and GEMM-RS kernels with each Hopper tile forced and
       each ring direction at the lane's seam shapes (4 x 1024 tokens:
       mlp_ag's packed w1|w3, mlp_rs, attn_ag@qkv, attn_rs, head_ag)
       against their plain versions (``fused_check``);
    2. the measured sweep: ``tuning.autotune_model`` with ``measure=True``
       on the group (every candidate of every seam cell timed, its flux
       rows launching the kernels), each cell's table, winner and the
       layout sweep emitted, the kernels' launches equal to the flux rows'
       calls, each cell's winning op against its plain version;
    3. the main path: step 0 of the train lane's 8-layer cut at tp=4 from
       the sweep's profile (``ParallelConfig.plan_profile``) against the
       uniform-flux step 0, the train lane's tolerances, its launches
       those the profile's PlanSet implies (``plan_launches``);
    4. step 0 under a fixed heterogeneous PlanSet (every knob, a per-layer
       override) against the same, launches from its PlanSet;
    5. the entry points from the profile: the Trainer 2 steps at the
       8-layer cut; ``launch.train`` at full depth, 2 steps, its launches
       from the PlanSet; ``launch.serve`` at tp=4 over the tp server
       lane's TP_SERVER_LAYERS layers, first tokens equal to its tp=1
       run's.
    The tuned and the uniform step's host ms are printed side by side: a
    finding, not a gate (both are host-bound on one card)."""
    import shutil
    import tempfile

    from repro_torch.configs.base import (ParallelConfig, get_config,
                                          train_schedule)
    from repro_torch.core import ect
    from repro_torch.dist import RankGroup
    from repro_torch.kernels import ag_gemm as AG
    from repro_torch.kernels import gemm_rs as RS
    from repro_torch.kernels import matmul as mm
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    from repro_torch.runtime import trainer as T
    from repro_torch.tuning import autotune as AT
    from repro_torch.tuning import (PlanRegistry, PlanSet, SeamPlan,
                                    plan_set_from_parallel, seam_of)

    t_phase = time.perf_counter()
    tp = TP_LANE
    cfg_full = get_config("minicpm_2b")
    res = {"phase": "tune_lane", "arch": cfg_full.name, "tp": tp,
           "tokens": TUNE_TOKENS, "decode_batch": TUNE_DECODE_BATCH,
           "iters": TUNE_ITERS, "warmup": TUNE_WARMUP,
           "hardware_priced": dataclasses.asdict(ect.H100_SXM)}
    group = RankGroup(tp, "cuda", timeout_s=120)
    bf16 = torch.bfloat16

    # ---- 1. forced tiles --------------------------------------------------
    t0 = time.perf_counter()
    shapes = AT.model_seam_shapes(cfg_full, ParallelConfig(tp=tp,
                                                           fuse_w13=True),
                                  TUNE_TOKENS, TUNE_DECODE_BATCH)
    gen = torch.Generator(device="cuda")
    forced = {}
    for cell in ("mlp_ag", "mlp_rs", "attn_ag@qkv", "attn_rs", "head_ag"):
        kind, m, n, k = shapes[cell]
        gen.manual_seed(700 + len(forced))
        if kind == "ag":
            args = _rank_inputs(torch, gen, ((m // tp, k), (k, n // tp)), tp,
                                bf16)
            wants = [AG.ag_gemm_ref([a for a, _ in args], b) for _, b in args]
            max_partial = 0.0
        else:
            args = _rank_inputs(torch, gen, ((m, k // tp), (k // tp, n)), tp,
                                bf16)
            parts = [(a.float() @ b.float()).to(bf16) for a, b in args]
            max_partial = max(p.abs().max().item() for p in parts)
            wants = [RS.reduce_ref(parts, r, None, None, bf16)
                     for r in range(tp)]
            del parts
        kern = AG.ag_gemm if kind == "ag" else RS.gemm_rs
        for tile in mm.TILES:
            for rev in (False, True):
                outs = group.spmd(
                    lambda a, b: kern(a, b, group=group, reverse=rev,
                                      tile=tile), args)
                torch.cuda.synchronize()
                errs = []
                for r, (out, want) in enumerate(zip(outs, wants)):
                    ok, err, atol, rtol = fused_check(
                        torch, out, want, k, tp if kind == "rs" else 1,
                        max_partial)
                    check(ok, f"forced tile {tile} reverse={rev} at {cell} "
                          f"rank {r}: max_abs_err {err} beyond atol {atol} "
                          f"+ rtol {rtol} * |C|")
                    errs.append(err)
                forced[f"{cell}/{tile[0]}x{tile[1]}"
                       f"{'/reverse' if rev else ''}"] = max(errs)
                del outs
        del args, wants
    res["forced_tiles"] = {"shapes": {c: shapes[c] for c in
                                      ("mlp_ag", "mlp_rs", "attn_ag@qkv",
                                       "attn_rs", "head_ag")},
                           "max_abs_err": forced,
                           "seconds": time.perf_counter() - t0}
    group.free_symmetric()
    torch.cuda.empty_cache()

    # ---- 2. the measured sweep --------------------------------------------
    par_u = ParallelConfig(tp=tp, overlap_mode="flux")
    tdir = tempfile.mkdtemp(prefix="tune_lane_")
    path = os.path.join(tdir, "minicpm_2b_tp4.json")
    reg = PlanRegistry.open(path, n_dev=tp, backend="cuda")
    results = []
    zero_counts()
    t0 = time.perf_counter()
    plans_t = AT.autotune_model(
        cfg_full, par_u, hw=ect.H100_SXM, group=group,
        tokens_per_dp=TUNE_TOKENS, decode_batch=TUNE_DECODE_BATCH,
        measure=True, registry=reg, save_path=path, iters=TUNE_ITERS,
        warmup=TUNE_WARMUP, results=results)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    sweep_counts = read_counts()
    want = sweep_launches(results, cfg_full, par_u,
                          (TUNE_WARMUP + TUNE_ITERS) * tp)
    check(sweep_counts == want, f"the sweep launched {sweep_counts}, its "
          f"flux rows call for {want}")
    layout = AT.sweep_model_layout(cfg_full, par_u, hw=ect.H100_SXM,
                                   tokens_per_dp=TUNE_TOKENS)
    res["sweep"] = {"seconds": sweep_s, "launches": sweep_counts,
                    "cells": len(results),
                    "rows": sum(len(r.table) for r in results),
                    "layout": layout, "profile_seams": sorted(plans_t.seams)}
    # every cell's table and winner; the winner against its plain version
    for r in results:
        kind, seam = r.kind, seam_of(r.seam)
        shape = AT.seam_op_shape(cfg_full, par_u, seam)
        nw = shape.get("n_weights", 1) if kind == "ag" else 1
        p = r.plan
        cand = AT.Candidate(p.mode, p.comm_chunks, p.reverse, p.blocks,
                            p.shared_gather, p.fuse_epilogue, p.scatter_axis)
        op = AT.bench_op(kind, cand, group, nw, shape.get("epilogue", False))
        args = AT.bench_inputs(kind, r.m, r.n, r.k, group, nw,
                               p.scatter_axis)
        outs = group.spmd(lambda *a: op(*a), args)
        torch.cuda.synchronize()
        plains = _seam_plain(torch, kind, p.scatter_axis, op.epilogue, args)
        rel = max(_rel_l2(o, w) for o, w in zip(outs, plains))
        check(rel <= TUNE_WINNER_RTOL, f"{r.seam}: the winner {p.mode} vs "
              f"plain: relative L2 {rel} > {TUNE_WINNER_RTOL}")
        del args, outs, plains
        emit({"phase": "tune_cell", "seam": r.seam, "kind": kind,
              "mkn": [r.m, r.n, r.k], "pruned": r.pruned,
              "rows_fields": ["mode", "comm_chunks", "reverse", "blocks",
                              "shared_gather", "fuse_epilogue",
                              "measured_ms", "predicted_ms"],
              "rows": [[x["mode"], x["comm_chunks"], x["reverse"],
                        x["blocks"], x["shared_gather"], x["fuse_epilogue"],
                        x["measured_s"] * 1e3, x["predicted_s"] * 1e3]
                       for x in r.table],
              "winner": {"mode": p.mode, "comm_chunks": p.comm_chunks,
                         "reverse": p.reverse, "blocks": p.blocks,
                         "shared_gather": p.shared_gather,
                         "fuse_epilogue": p.fuse_epilogue,
                         "measured_ms": p.measured_s * 1e3,
                         "predicted_ms": p.predicted_s * 1e3},
              "winner_rel_l2_vs_plain": rel})
    group.free_symmetric()
    torch.cuda.empty_cache()

    # ---- 3. the tuned step, against the uniform flux step ----------------
    cfg = dataclasses.replace(cfg_full, num_layers=TRAIN_LAYERS)
    tc = T.TrainConfig(total_steps=2, warmup_steps=0, base_lr=3e-4,
                       schedule=train_schedule("minicpm_2b"), log_every=2)
    tr = T.Trainer(cfg, par_u, tc, device="cuda", dtype=bf16)
    tr.data_cfg = dataclasses.replace(tr.data_cfg, seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH)
    ranks, opts = tr.init_state()
    batch0 = tr.batch(0)
    mlp_w = AT.seam_op_shape(cfg, par_u, "mlp_ag")["n_weights"]
    # the uniform flux step twice: the first (the reference values) also
    # warms the trainer's group, so that the host times below compare
    # warm steps
    loss_u, can_u, _, _, host_cold = step0(torch, cfg, par_u, tr.group,
                                           ranks, [batch0])
    par_t = dataclasses.replace(par_u, plan_profile=path)
    plans_loaded = plan_set_from_parallel(par_t, "cuda")
    check(plans_loaded.seams, f"the profile {path} did not load")
    het = PlanSet(
        default=SeamPlan(mode="flux"),
        seams={"mlp_ag": SeamPlan(mode="flux",
                                  blocks=mm.tile_blocks(mm.SMALL),
                                  reverse=True, shared_gather=False),
               "mlp_rs": SeamPlan(mode="flux",
                                  blocks=mm.tile_blocks(mm.LARGE)),
               "attn_ag": SeamPlan(mode="decomposed", comm_chunks=16,
                                   reverse=True),
               "attn_rs": SeamPlan(mode="decomposed_bidir", comm_chunks=8),
               "head_ag": SeamPlan(mode="xla")},
        layers={0: {"attn_ag": SeamPlan(mode="flux")}})
    for name, par, plans in (("uniform_flux", par_u, None),
                             ("tuned", par_t, None),
                             ("heterogeneous", par_u, het)):
        lm, canm, cf, cb, hm = step0(torch, cfg, par, tr.group, ranks,
                                     [batch0], plans)
        want_f, want_b = plan_launches(
            plans or plan_set_from_parallel(par, "cuda"), cfg, tp, mlp_w)
        check(cf == want_f and cb == want_b, f"{name} step 0 launched "
              f"{cf} / {cb}, its PlanSet implies {want_f} / {want_b}")
        rl = abs(lm - loss_u) / abs(loss_u)
        rg, lf = _worst_leaf(canm, can_u)
        check(rl <= TRAIN_LOSS_RTOL and rg <= TRAIN_GRAD_RTOL,
              f"{name} vs uniform flux step 0: loss relative {rl}, grad of "
              f"{lf} relative L2 {rg}")
        res[f"{name}_step0"] = {"step0_loss": lm, "loss_rel_vs_flux": rl,
                                "grad_rel_l2_vs_flux_max": rg,
                                "grad_worst_leaf": lf, "step0_host": hm,
                                "launches_forward": cf,
                                "launches_backward": cb}
        del canm
    del can_u
    res["host_ms_tuned_vs_uniform"] = {
        k: res[f"{k}_step0"]["step0_host"]["forward_ms"]
        + res[f"{k}_step0"]["step0_host"]["backward_ms"]
        for k in ("uniform_flux", "tuned", "heterogeneous")}
    res["host_ms_tuned_vs_uniform"]["uniform_flux_cold"] = (
        host_cold["forward_ms"] + host_cold["backward_ms"])
    res["tuned_plans"] = {s: p.to_json() for s, p in
                          plans_loaded.seams.items()}

    # ---- 5. the entry points from the profile -----------------------------
    tr_t = T.Trainer(cfg, par_t, tc, device="cuda", dtype=bf16)
    tr_t.data_cfg = tr.data_cfg
    _, _, hist = tr_t.train(ranks, opts)
    losses = [h["loss"] for h in hist]
    check(len(losses) == 2 and all(map(math.isfinite, losses)),
          f"the Trainer from the profile: losses {losses}")
    res["trainer_from_profile"] = {"losses": losses}
    del ranks, opts, tr, tr_t
    group.free_symmetric()
    torch.cuda.empty_cache()

    zero_counts()
    t0 = time.perf_counter()
    tr_cli, hist = launch_train.main(["--arch", "minicpm_2b", "--tp",
                                      str(tp), "--mode", "flux",
                                      "--plan-profile", path, "--steps", "2"])
    torch.cuda.synchronize()
    cli_counts = read_counts()
    losses = [h["loss"] for h in hist]
    check(len(losses) == 2 and all(map(math.isfinite, losses)),
          f"launch.train from the profile: losses {losses}")
    want_f, want_b = plan_launches(
        plan_set_from_parallel(tr_cli.par, "cuda"), tr_cli.cfg, tp,
        AT.seam_op_shape(tr_cli.cfg, tr_cli.par, "mlp_ag")["n_weights"])
    want = {k: 2 * (want_f[k] + want_b[k]) for k in want_f}
    check(cli_counts == want and tr_cli.failures == 0,
          f"launch.train's 2 steps launched {cli_counts}, the profile's "
          f"PlanSet implies {want} (failures {tr_cli.failures})")
    res["train_cli_from_profile"] = {
        "layers": tr_cli.cfg.num_layers,
        "batch": tr_cli.data_cfg.global_batch,
        "seq": tr_cli.data_cfg.seq_len, "losses": losses,
        "launches": cli_counts, "seconds": time.perf_counter() - t0}
    tr_cli.group.free_symmetric()
    del tr_cli, hist
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    srv, done = launch_serve.main(TP_SERVER_ARGV + [
        "--tp", str(tp), "--mode", "flux", "--plan-profile", path])
    check(srv.ctx.plans.seams, "launch.serve did not load the profile")
    got = {r.rid: r.output for r in done}
    first = sum(int(got[i][0] == tp1_tokens[i][0]) for i in tp1_tokens)
    check(first == len(tp1_tokens), f"launch.serve from the profile: first "
          f"tokens vs tp=1 {first}/{len(tp1_tokens)}")
    res["serve_cli_from_profile"] = {
        "layers": srv.cfg.num_layers, "requests": len(done),
        "first_tokens_equal_tp1": f"{first}/{len(tp1_tokens)}",
        "seconds": time.perf_counter() - t0}
    del srv, done
    torch.cuda.empty_cache()
    shutil.rmtree(tdir)
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return {"sweep": sweep_counts,
            "tuned_step": {"forward": res["tuned_step0"]["launches_forward"],
                           "backward":
                               res["tuned_step0"]["launches_backward"]},
            "heterogeneous_step": {
                "forward": res["heterogeneous_step0"]["launches_forward"],
                "backward": res["heterogeneous_step0"]["launches_backward"]}}


# ---------------------------------------------------------------------------
# the wire lane: quantized forward wires at tp=4 (minicpm_2b, full width)
# ---------------------------------------------------------------------------
WIRES = ("int8", "fp8_e4m3", "int4")
# the codec's shard: one rank's share of the tp lane's attn_ag input
# (4 x 1024 tokens over 4 ranks, d_model 2304), seeded bf16
WIRE_CODEC_SHAPE = (4, 256, 2304)
# the reference's end-to-end promise (tests/test_wire_dtype.py's
# test_minicpm_int8_end_to_end_4dev): int8 prefill logits within the
# default budget, relative RMS over the valid vocab
WIRE_BUDGET = 0.05
# the prefill's layers under each wire (40 until the whole script neared
# its 1200 s limit: the int8 logits were 4.02 % from the fp wire's there,
# on an H100 80GB HBM3 at 700 W)
WIRE_PREFILL_LAYERS = 16
# the wired ops alone: the tp lane's five seam shapes (kind, m, n, k) at
# 4 x 1024 tokens and tp=4 (tests/test_torch_plan_plumbing.py's GPU_SHAPES)
# and the decode ar at the tune lane's 8 rows
WIRE_OP_SHAPES = {"mlp_ag": ("ag", 4096, 12288, 2304),
                  "mlp_rs": ("rs", 4096, 2304, 6144),
                  "attn_ag": ("ag", 4096, 6912, 2304),
                  "attn_rs": ("rs", 4096, 2304, 2304),
                  "head_ag": ("ag", 4096, 122880, 2304),
                  "decode_ar": ("ar", 8, 2304, 6144)}
# CUDA-event calls a wired op (3 until the dp lane came: the script's time
# budget)
WIRE_OP_ITERS = 2
# the wire sweep's timed calls a candidate, and its warm calls before them
# (1 until the rwkv train lane came: the script's time budget): its 347
# rows are a report, not a gate, and the script has a time limit
WIRE_SWEEP_ITERS = 1
WIRE_SWEEP_WARMUP = 0
# the wire lane's server: the tp server lane's 8 requests, 4 new tokens
# each (its first-token logits are the gate; later tokens are reported)
WIRE_SERVE_NEW = 4
# the cells whose decomposed op is profiled under the fp wire and int8:
# the summed device activity (the codec's kernels included)
WIRE_PROFILED = ("mlp_ag", "mlp_rs", "decode_ar", "moe_a2a")


def wire_codec_phase(torch):
    """Phase 1: ``wire_encode`` of a seeded bf16 shard on the card against
    the same call on its CPU copy (q bytes and scales bit-equal), each
    wire, with three edge cases (a zero block, width 200: one block,
    int4 at width 127: unpacked); the zero block decodes to zeros.  The
    bytes on the wire beside the bf16 shard's, ``codec_rmse``, and the
    codec's device price per hop: encode and decode ms (CUDA events)
    beside the pull copy of the bf16 shard and of the (q, scale) pair."""
    from repro_torch.core import overlap as tov
    from repro_torch.tuning import error_budget as EB

    gen = torch.Generator().manual_seed(7)
    base = torch.randn(WIRE_CODEC_SHAPE, generator=gen).to(torch.bfloat16)
    zero = base.clone()
    zero[..., :128] = 0
    cases = {"shard": base, "zero_block": zero,
             "width_200": base[..., :200].contiguous(),
             "odd_width_127": base[..., :127].contiguous()}
    res = {"shape": list(WIRE_CODEC_SHAPE), "dtype": "bfloat16",
           "bf16_bytes": base.numel() * 2, "wires": {}}
    xg = base.cuda()
    copy_ms = time_ms(torch, lambda: xg.clone(), 20)
    for wire in WIRES:
        row = {}
        for name, x in cases.items():
            qc, sc = tov.wire_encode(x, wire)
            qg, sg = tov.wire_encode(x.cuda(), wire)
            check(torch.equal(qg.cpu().view(torch.uint8),
                              qc.view(torch.uint8))
                  and torch.equal(sg.cpu(), sc),
                  f"{wire} {name}: the card's codec bytes differ from the "
                  "CPU's")
            dec = tov.wire_decode((qg, sg), wire, torch.bfloat16)
            check(bool(torch.isfinite(dec.float()).all()),
                  f"{wire} {name}: non-finite decode")
            if name == "zero_block":
                check(not bool(dec[..., :128].any()),
                      f"{wire}: the zero block does not decode to zeros")
            if name == "odd_width_127" and wire == "int4":
                check(qg.dtype == torch.int8, "int4 at an odd width packed")
        q, s = tov.wire_encode(xg, wire)
        wire_bytes = q.numel() * q.element_size() + s.numel() * 4
        enc_ms = time_ms(torch, lambda: tov.wire_encode(xg, wire), 20)
        dec_ms = time_ms(torch, lambda: tov.wire_decode((q, s), wire,
                                                        torch.bfloat16), 20)
        pair_ms = time_ms(torch, lambda: (q.clone(), s.clone()), 20)
        row.update(bytes=wire_bytes, bytes_vs_bf16=wire_bytes / (
            base.numel() * 2), q_dtype=str(q.dtype), codec_rmse=EB.codec_rmse(
                wire), encode_ms=enc_ms, decode_ms=dec_ms,
            pair_copy_ms=pair_ms, bf16_copy_ms=copy_ms,
            hop_extra_ms=enc_ms + dec_ms + pair_ms - copy_ms,
            cases_bit_equal=list(cases))
        res["wires"][wire] = row
    return res


def _wired_op_run(torch, group, op, args, probes):
    """Every rank's (output, input grads) of sum(op(*args) * probe), the
    backward from a SeamTape, and the encodes of the forward and of the
    backward."""
    from repro_torch.core import overlap as tov
    phase = {}

    def mark(name):
        group.barrier(name)
        if group.rank() == 0:
            phase[name] = tov.wire_encode.calls
        group.barrier(name + " read")

    def body(*a):
        *xs, pr = a
        leaves = [x.detach().clone().requires_grad_() for x in xs]
        mark("f0")
        with tov.SeamTape() as tape:
            y = op(*leaves)
            loss = (y.float() * pr).sum()
        mark("f1")
        tape.backward(loss)
        mark("b1")
        return y.detach(), [lf.grad for lf in leaves]
    outs = group.spmd(body, [tuple(a) + (p,) for a, p in zip(args, probes)])
    torch.cuda.synchronize()
    return outs, {"forward": phase["f1"] - phase["f0"],
                  "backward": phase["b1"] - phase["f1"]}


def wire_ops_phase(torch, group):
    """Phase 2: each wired op alone at tp=4 (bf16 ``bench_inputs``), every
    (kind, mode) that ``wire_supported`` admits under each wire beside the
    fp wire, and ``xla``'s rs / ar (which ignore the wire); then the
    ``a2a`` op at the mla train lane's ``moe_a2a`` cell in ``xla`` and the
    ring.  Gates: a finite, non-zero forward deviation from the fp wire
    (zero where the wire is ignored), dX and every dW ``torch.equal`` to
    the fp wire's, no encode in the backward, ``flux`` + wire raises.
    Each row's ``event_ms`` is CUDA events around the 4-rank call (host
    gaps included, ``_spmd_ms``); the ``WIRE_PROFILED`` cells' decomposed
    rows also carry the summed device activity of one profiled call under
    int8 and the fp wire (``device_ms``)."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.core import overlap as tov
    from repro_torch.tuning import autotune as AT
    from repro_torch.tuning import error_budget as EB

    try:
        tov.FusedOp("ag", axis=group, mode="flux", wire_dtype="int8")
        raised = False
    except ValueError:
        raised = True
    check(raised, "FusedOp(mode='flux', wire_dtype='int8') did not raise")
    cells = dict(WIRE_OP_SHAPES)
    kind, m, n, k = AT.model_seam_shapes(
        mla_train_cfg(), ParallelConfig(tp=TP_LANE),
        MLA_TRAIN_BATCH * MLA_TRAIN_SEQ)["moe_a2a"]
    cells["moe_a2a"] = (kind, m, n, k)
    rows, enc_total = [], {"forward": 0, "backward": 0}
    for cell, (kind, m, n, k) in cells.items():
        modes = [md for md in AT._KIND_MODES[kind] if md != "flux"]
        args = AT.bench_inputs(kind, m, n, k, group)
        nw = 3 if kind == "a2a" else 1
        gen = torch.Generator(device="cuda").manual_seed(3)
        for mode in modes:
            def op_for(wire):
                return tov.FusedOp(
                    kind, AT._bench_epilogue(kind, nw, kind == "a2a"), nw,
                    axis=group, mode=mode, wire_dtype=wire)
            fp_op = op_for(None)
            ys = group.spmd(lambda *a: fp_op(*a), args)
            probes = [torch.randn(y.shape, generator=gen, device="cuda")
                      for y in ys]
            fp, enc = _wired_op_run(torch, group, fp_op, args, probes)
            check(enc == {"forward": 0, "backward": 0},
                  f"{cell} {mode}: the fp wire encoded {enc}")
            base_ms = _spmd_ms(torch, group, fp_op, args, WIRE_OP_ITERS)
            profiled = mode == "decomposed" and cell in WIRE_PROFILED
            if profiled:
                base_prof = device_profile(
                    torch, lambda: group.spmd(fp_op, args))["device_ms"]
            base_host, _ = wall_ms(torch, lambda: group.spmd(fp_op, args), 2)
            ignored = mode == "xla" and kind in ("rs", "ar")
            for wire in WIRES:
                op = op_for(wire)
                got, enc = _wired_op_run(torch, group, op, args, probes)
                dev = _rel_l2(torch.cat([g[0].flatten() for g in got]),
                              torch.cat([f[0].flatten() for f in fp]))
                ok_dev = dev == 0.0 if ignored else 0.0 < dev < 1.0
                check(ok_dev and all(bool(torch.isfinite(g[0]).all())
                                     for g in got),
                      f"{cell} {mode} {wire}: forward deviation {dev}")
                same = all(torch.equal(a, b) for g, f in zip(got, fp)
                           for a, b in zip(g[1], f[1]))
                check(same, f"{cell} {mode} {wire}: the grads differ from "
                      "the fp wire's")
                check(enc["backward"] == 0 and (enc["forward"] == 0)
                      == ignored, f"{cell} {mode} {wire}: encodes {enc}")
                enc_total = {d: enc_total[d] + enc[d] for d in enc}
                rows.append({
                    "cell": cell, "kind": kind, "mkn": [m, n, k],
                    "mode": mode, "wire": wire, "rel_dev_vs_fp": dev,
                    "seam_wire_rmse": (0.0 if ignored else
                                       EB.seam_wire_rmse(kind, m, n, k,
                                                         TP_LANE, wire)),
                    "grads_equal_fp": same, "encodes": enc,
                    "event_ms": _spmd_ms(torch, group, op, args,
                                         WIRE_OP_ITERS),
                    "fp_event_ms": base_ms,
                    "device_ms": (device_profile(
                        torch, lambda: group.spmd(op, args))["device_ms"]
                        if profiled and wire == "int8" else None),
                    "fp_device_ms": base_prof if profiled else None,
                    "host_ms": wall_ms(torch, lambda: group.spmd(op, args),
                                       2)[0],
                    "fp_host_ms": base_host})
                del got
            del fp, ys, probes
        del args
        group.free_symmetric()
        torch.cuda.empty_cache()
    return {"rows_fields": list(rows[0]), "rows": [list(r.values())
                                                   for r in rows],
            "encodes": enc_total, "flux_with_wire_raises": raised}


def wire_encodes_planned(plans, cfg, tp, layout, head):
    """The encodes a rank's forward performs under ``plans`` on a dense
    model: each layer's attn_ag / mlp_ag (one a shard; bidir two; xla one;
    none in the replicated layout), attn_rs / mlp_rs (n - 1 hops; bidir
    two rings; the replicated layout's quantized AllReduce n; xla none),
    and with ``head`` the LM head's ag."""
    from repro_torch.models import model as M

    def seam(name, layer):
        p = plans.resolve(name, layer)
        if not p.wire_dtype:
            return 0
        bidir = 2 if p.mode == "decomposed_bidir" else 1
        if name.endswith("_ag"):
            return 0 if layout == "hidden" else (1 if p.mode == "xla"
                                                 else bidir)
        if p.mode == "xla":
            return 0
        return tp if layout == "hidden" else bidir * (tp - 1)
    total = sum(seam(s, M.layer_slot(cfg, i)) for i in range(cfg.num_layers)
                for s in ("attn_ag", "attn_rs", "mlp_ag", "mlp_rs"))
    return total + (seam("head_ag", None) if head else 0)


def phase_wire_lane(torch):
    """Wire precision on the card (the module docstring's wire_lane): the
    codec,
    the wired ops alone, the prefill logits' deviation under each wire
    (``error_budget.model_logit_rmse``) and the flux control, step 0 of
    the train lane's cut under int8 against the fp wire, the measured
    and the analytic wire sweep, and ``launch.serve --wire-dtype int8``
    against the fp wire."""
    import dataclasses as dc

    from repro_torch.configs.base import ParallelConfig, get_config
    from repro_torch.core import ect
    from repro_torch.core import overlap as tov
    from repro_torch.dist import RankGroup
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import model as M
    from repro_torch.models import serve as S
    from repro_torch.parallel.sharding import make_ctx
    from repro_torch.runtime import trainer as T
    from repro_torch.tuning import autotune as AT
    from repro_torch.tuning import error_budget as EB
    from repro_torch.tuning import plan_set_from_parallel

    t_phase = time.perf_counter()
    tp = TP_LANE
    torch.cuda.reset_peak_memory_stats()
    res = {"phase": "wire_lane", "arch": "minicpm_2b", "tp": tp,
           "wires": list(WIRES), "budget": WIRE_BUDGET}
    launches = {"ag_gemm": 0, "gemm_rs": 0, "gemm_rs_reduce": 0,
                "flash_attention": 0}

    def add(counts):
        for key in launches:
            launches[key] += counts.get(key, 0)

    t0 = time.perf_counter()
    res["codec"] = wire_codec_phase(torch)
    res["codec"]["seconds"] = time.perf_counter() - t0
    group = RankGroup(tp, "cuda", timeout_s=120)
    t0 = time.perf_counter()
    zero_counts()
    res["ops"] = wire_ops_phase(torch, group)
    add(read_counts())
    res["ops"]["seconds"] = time.perf_counter() - t0

    # ---- 3. prefill: the logits' deviation, and the flux control ----------
    t0 = time.perf_counter()
    cfg = dc.replace(get_config("minicpm_2b"), num_layers=WIRE_PREFILL_LAYERS)
    par = ParallelConfig(tp=tp, fuse_w13=True, kernel_decode=True)
    full = M.init_model(cfg, par, seed=0, dtype=torch.bfloat16,
                        device="cuda")
    ranks = [M.shard_params(full, r, tp, cfg) for r in range(tp)]
    del full
    torch.cuda.empty_cache()
    lengths = torch.tensor([256, 512, 777, 1024], device="cuda")
    s = int(lengths.max())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)                    # the kernel and tp lanes' tokens
    toks = torch.randint(0, cfg.vocab_size, (4, s), generator=gen,
                         device="cuda")
    toks = toks.masked_fill(torch.arange(s, device="cuda")[None]
                            >= lengths[:, None], 0)
    zero_counts()
    rmse = {w: EB.model_logit_rmse(cfg, par, w, device="cuda", group=group,
                                   params=ranks, tokens=toks)
            for w in WIRES}
    torch.cuda.synchronize()
    c = read_counts()
    add(c)
    check(rmse["int8"] <= WIRE_BUDGET, f"int8 prefill logits {rmse['int8']} "
          f"relative RMS from the fp wire > {WIRE_BUDGET}")
    check(all(0.0 < v < 1.0 for v in rmse.values()), f"logit rmse {rmse}")
    check(c["ag_gemm"] == 0 and c["gemm_rs"] == 0
          and c["flash_attention"] == 2 * len(WIRES) * cfg.num_layers * tp,
          f"the decomposed prefills launched {c}")
    res["prefill"] = {
        "mode": "decomposed", "layers": cfg.num_layers, "batch": 4,
        "seq": s, "logit_rmse": rmse,
        "ordered_int8_fp8_int4": rmse["int8"] < rmse["fp8_e4m3"]
        < rmse["int4"], "launches": c}

    args = [(p,) for p in ranks]

    def flux_logits(ctx):
        outs = group.spmd(lambda p: S.prefill_logits(
            p, {"tokens": toks}, ctx, cfg, lengths)[0], args)
        return torch.cat(outs, dim=-1)[:, :cfg.vocab_size].float()
    fpar = dc.replace(par, overlap_mode="flux")
    wctx = make_ctx(dc.replace(fpar, wire_dtype="int8"), group)
    check(all(wctx.plans.resolve(sm).wire_dtype is None for sm in
              ("mlp_ag", "mlp_rs", "attn_ag", "attn_rs", "head_ag",
               "decode_ar")), "a flux plan took the wire")
    per_seam = cfg.num_layers * tp
    want = {"ag_gemm": 2 * per_seam, "gemm_rs": 2 * per_seam,
            "gemm_rs_reduce": 2 * per_seam, "flash_attention": per_seam,
            "matmul": 0}
    zero_counts()
    lf = flux_logits(make_ctx(fpar, group))
    torch.cuda.synchronize()
    add(read_counts())
    zero_counts()
    lw = flux_logits(wctx)
    torch.cuda.synchronize()
    c = read_counts()
    add(c)
    check(c == want, f"the flux control launched {c}, expected {want}")
    check(torch.equal(lw, lf), "the flux prefill under wire_dtype='int8' "
          "differs from the fp wire's")
    res["flux_control"] = {"bit_equal_fp_wire": True, "launches": c,
                           "encodes": tov.wire_encode.calls}
    check(tov.wire_encode.calls == 0, "the flux control encoded")
    del ranks, args, lf, lw
    group.free_symmetric()
    torch.cuda.empty_cache()
    res["prefill"]["seconds"] = time.perf_counter() - t0

    # ---- 4. train step 0 at tp=4 under int8 --------------------------------
    t0 = time.perf_counter()
    cfg8 = dc.replace(cfg, num_layers=TRAIN_LAYERS)
    tpar = ParallelConfig(tp=tp, overlap_mode="decomposed", fuse_w13=True)
    tr = T.Trainer(cfg8, tpar, T.TrainConfig(total_steps=1), device="cuda",
                   dtype=torch.bfloat16)
    tr.data_cfg = dc.replace(tr.data_cfg, seq_len=TRAIN_SEQ,
                             global_batch=TRAIN_BATCH)
    ranks, opts = tr.init_state()
    del opts
    batch = tr.batch(0)
    step = {}
    for wire in (None, "int8"):
        p = dc.replace(tpar, wire_dtype=wire)
        loss, can, cf, cb, host = step0(torch, cfg8, p, tr.group, ranks,
                                        [batch])
        add(cf)
        add(cb)
        step[wire] = (loss, can, host)
    plans = plan_set_from_parallel(dc.replace(tpar, wire_dtype="int8"),
                                   "cuda")
    enc_want = tp * wire_encodes_planned(plans, cfg8, tp, "seq", True)
    enc = step["int8"][2]["wire_encodes"]
    check(enc == {"forward": enc_want, "backward": 0},
          f"int8 step 0 encodes {enc}, its plans imply {enc_want} forward "
          "and none backward")
    check(step[None][2]["wire_encodes"] == {"forward": 0, "backward": 0},
          "the fp step encoded")
    worst, leaf = _worst_leaf(step["int8"][1], step[None][1])
    l0, l1 = step[None][0], step["int8"][0]
    check(math.isfinite(l1) and worst < 1.0,
          f"int8 step 0: loss {l1}, worst grad {worst} at {leaf}")
    res["train_step0"] = {
        "layers": TRAIN_LAYERS, "batch": [TRAIN_BATCH, TRAIN_SEQ],
        "mode": "decomposed", "loss_fp": l0, "loss_int8": l1,
        "loss_rel_diff": abs(l1 - l0) / abs(l0),
        "grad_rel_l2_worst": worst, "grad_worst_leaf": leaf,
        "encodes": enc, "encodes_planned": enc_want,
        "host_ms": {"fp": step[None][2]["forward_ms"]
                    + step[None][2]["backward_ms"],
                    "int8": step["int8"][2]["forward_ms"]
                    + step["int8"][2]["backward_ms"]},
        "peak_gb": step["int8"][2]["peak_gb"],
        "seconds": time.perf_counter() - t0}
    del ranks, step, tr
    torch.cuda.empty_cache()

    # ---- 5. the wire sweep, measured and analytic ---------------------------
    t0 = time.perf_counter()
    scfg = get_config("minicpm_2b")
    spar = ParallelConfig(tp=tp, overlap_mode="flux")
    sweeps = {}
    for measured in (True, False):
        results = []
        zero_counts()
        plans = AT.autotune_model(
            scfg, spar, hw=ect.H100_SXM, group=group,
            tokens_per_dp=TUNE_TOKENS, decode_batch=TUNE_DECODE_BATCH,
            measure=measured, iters=WIRE_SWEEP_ITERS,
            warmup=WIRE_SWEEP_WARMUP,
            results=results, wire_dtypes=AT.WIRE_DTYPE_SWEEP,
            max_logit_rmse=WIRE_BUDGET)
        torch.cuda.synchronize()
        c = read_counts()
        add(c)
        if measured:
            want = sweep_launches(results, scfg, spar,
                                  (WIRE_SWEEP_WARMUP + WIRE_SWEEP_ITERS)
                                  * tp)
            check(c == want, f"the wire sweep launched {c}, its flux rows "
                  f"call for {want}")
        for r in results:
            check(r.plan.logit_rmse <= WIRE_BUDGET,
                  f"{r.seam}: winner out of budget {r.plan}")
            win = [x for x in r.table if (x["mode"], x["comm_chunks"],
                                          x["reverse"], x["wire_dtype"])
                   == (r.plan.mode, r.plan.comm_chunks, r.plan.reverse,
                       r.plan.wire_dtype)]
            check(win and all(x["within_budget"] for x in win),
                  f"{r.seam}: the winner is not within budget")
        key = "measured" if measured else "analytic"
        sweeps[key] = {
            "rows": sum(len(r.table) for r in results),
            "winners": {r.seam: [r.plan.mode, r.plan.comm_chunks,
                                 r.plan.reverse, r.plan.wire_dtype,
                                 (r.plan.measured_s if measured
                                  else r.plan.predicted_s) * 1e3,
                                 r.plan.logit_rmse] for r in results},
            "wire_rows": {r.seam: [[x["mode"], x["comm_chunks"],
                                    x["reverse"], x["wire_dtype"],
                                    (x["measured_s"] if measured
                                     else x["predicted_s"]) * 1e3,
                                    x["logit_rmse"], x["within_budget"]]
                                   for x in r.table if x["wire_dtype"]]
                          for r in results},
            "launches": c}
        del plans
    sweeps["winner_fields"] = ["mode", "comm_chunks", "reverse", "wire",
                               "ms", "logit_rmse"]
    sweeps["seconds"] = time.perf_counter() - t0
    res["sweep"] = sweeps
    group.free_symmetric()
    del group
    torch.cuda.empty_cache()

    # ---- 6. serving under int8 ---------------------------------------------
    t0 = time.perf_counter()
    # the tp server lane's requests and its 2 layers: the int8 check
    # against the fp wire (WIRE_BUDGET) is held over 2 layers of int8
    # seams (8 until the whole script neared its 1200 s limit, 4 until the
    # jamba train lane joined it; the first-token logits' worst relative
    # RMS 3.03-3.23 % at 8 layers, 2.85-3.06 % at 4, on an H100 80GB HBM3
    # at 700 W)
    argv = TP_SERVER_ARGV + ["--tp", str(tp), "--mode", "decomposed",
                             "--max-new", str(WIRE_SERVE_NEW)]
    served = {}
    for wire in (None, "int8"):
        zero_counts()
        server, done = launch_serve.main(
            argv + (["--wire-dtype", wire] if wire else []))
        torch.cuda.synchronize()
        c = read_counts()
        check(not any(c.values()), f"the decomposed server launched {c}")
        check(server.par.wire_dtype == wire
              and server.ctx.plans.resolve("decode_ar").wire_dtype == wire,
              f"the server's plans do not carry wire {wire}")
        check(len(done) == 8 and all(r.done and r.error is None
                                     and len(r.output) == WIRE_SERVE_NEW
                                     for r in done),
              f"wire {wire}: not every request finished")
        prompts = {r.rid: r.prompt for r in done}
        served[wire] = ({r.rid: r.output for r in done},
                        first_logits(torch, server, prompts),
                        sorted(r.per_token_s() for r in done)[
                            len(done) // 2] * 1e3)
        del server
        torch.cuda.empty_cache()
    (tok0, lg0, tpot0), (tok1, lg1, tpot1) = served[None], served["int8"]
    rel = {i: _rel_l2(lg1[i], lg0[i]) for i in lg0}
    check(max(rel.values()) <= WIRE_BUDGET, f"int8 server first-token "
          f"logits vs the fp wire's: {rel} > {WIRE_BUDGET}")
    first = sum(tok0[i][0] == tok1[i][0] for i in tok0)
    agree = sum(a == b for i in tok0 for a, b in zip(tok0[i], tok1[i]))
    res["serve"] = {
        "argv": argv + ["--wire-dtype", "int8"],
        "first_logits_rel_rms_vs_fp": rel,
        "first_tokens_equal_fp": f"{first}/{len(tok0)}",
        "tokens_equal_fp": f"{agree}/{WIRE_SERVE_NEW * len(tok0)}",
        "tpot_p50_ms": tpot1, "tpot_p50_ms_fp": tpot0,
        "seconds": time.perf_counter() - t0}
    res["launches"] = launches
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return launches


def phase_train_remat(torch):
    """minicpm_2b at full width and all 40 layers, trained at tp=1 with
    ``remat="full"`` (every block recomputed in the backward), 3 trainer
    steps from seed 0 (bf16 weights, fp32 moments, wsd, batch 4 x 1024):
    finite losses, the step's time and the peak memory, beside what the
    earlier phases left allocated."""
    from repro_torch.configs.base import (ParallelConfig, get_config,
                                          train_schedule)
    from repro_torch.runtime import trainer as T

    t_phase = time.perf_counter()
    cfg = get_config("minicpm_2b")
    tc = T.TrainConfig(total_steps=TRAIN_STEPS, warmup_steps=0,
                       base_lr=3e-4, schedule=train_schedule("minicpm_2b"),
                       log_every=TRAIN_STEPS)
    tr = T.Trainer(cfg, ParallelConfig(tp=1, fuse_w13=True, remat="full"),
                   tc, device="cuda", dtype=torch.bfloat16)
    tr.data_cfg = dataclasses.replace(tr.data_cfg, seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH)
    baseline = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    params, opt = tr.init_state()
    _, _, hist = tr.train(params, opt)
    torch.cuda.synchronize()
    losses = [h["loss"] for h in hist]
    check(all(map(math.isfinite, losses)), f"40-layer remat losses {losses}")
    ms = [h["seconds"] * 1e3 for h in hist]
    emit({"phase": "train_remat", "arch": cfg.name,
          "layers": cfg.num_layers, "remat": "full", "tp": 1,
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
          "weights": sum(p.numel() for p in params[0].parameters()),
          "losses": losses, "step_ms_median": sorted(ms)[len(ms) // 2],
          "step_ms": ms, "peak_mem_gb": torch.cuda.max_memory_allocated()
          / 1e9, "baseline_mem_gb": baseline,
          "phase_s": time.perf_counter() - t_phase})
    del params, opt, tr
    torch.cuda.empty_cache()


def phase_train_ckpt(torch):
    """Checkpoints and elastic restart through ``runtime.trainer`` on a
    dp=2 x tp=2 mesh in flux: minicpm_2b at full width cut to its first
    CKPT_LAYERS layers (bf16 weights, fp32 ZeRO-1 moments, batch 4 x
    1024), 4 steps with a checkpoint every 2 into a temporary directory
    (removed at the end).  A fresh ``Trainer`` on the mesh that
    ``elastic_remesh`` builds from 2 surviving ranks (dp=1 x tp=2)
    restores step 2 (weights and moments equal to the checkpoint's bit for
    bit, cut per rank and joined again) and runs steps 2-3, whose losses
    must lie within TRAIN_LOSS_RTOL of the uninterrupted run's; then a run
    at dp=2 x tp=2 whose ``fault_hook`` raises once before step 3 recovers
    (a fresh mesh) from the step-2 checkpoint and finishes with one
    failure."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.checkpoint.checkpointer import host_leaves
    from repro_torch.configs.base import (ParallelConfig, get_config,
                                          train_schedule)
    from repro_torch.launch.mesh import elastic_remesh
    from repro_torch.runtime import trainer as T

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("minicpm_2b"),
                              num_layers=CKPT_LAYERS)
    tp, dp = DP_LANE
    par = ParallelConfig(tp=tp, dp=dp, fuse_w13=True, overlap_mode="flux")
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        def trainer(sub, mesh=None):
            tc = T.TrainConfig(total_steps=CKPT_STEPS, warmup_steps=0,
                               base_lr=3e-4,
                               schedule=train_schedule("minicpm_2b"),
                               checkpoint_dir=os.path.join(d, sub),
                               checkpoint_every=2, log_every=CKPT_STEPS)
            tr = T.Trainer(cfg, par if mesh is None else
                           dataclasses.replace(par, dp=mesh.shape[0]), tc,
                           device="cuda", dtype=torch.bfloat16, mesh=mesh)
            tr.data_cfg = dataclasses.replace(
                tr.data_cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
            return tr

        res = {"phase": "train_ckpt", "arch": cfg.name,
               "layers": f"{CKPT_LAYERS} of 40 (cut in depth)",
               "mesh": {"dp": dp, "tp": tp}, "mode": "flux",
               "steps": CKPT_STEPS,
               "checkpoint_every": 2, "loss_rtol": TRAIN_LOSS_RTOL,
               "disk_free_gb": shutil.disk_usage(d).free / 1e9}
        # the uninterrupted run: checkpoints at steps 2 and 4
        tra = trainer("a")
        params, opt = tra.init_state()
        res["weights"] = sum(p.numel() for r in params
                             for p in r.parameters())
        _, _, ha = tra.train(params, opt, resume=False)
        la = [h["loss"] for h in ha]
        check(all(map(math.isfinite, la)), f"losses {la}")
        check(tra.ckpt.all_steps() == [2, 4],
              f"checkpoints {tra.ckpt.all_steps()}")
        res["save"] = dict(tra.ckpt.timings)
        step2 = os.path.join(d, "a", "step_2")
        res["bytes_on_disk"] = sum(
            os.path.getsize(os.path.join(step2, f)) for f in os.listdir(step2))
        del params, opt, tra
        torch.cuda.empty_cache()

        # two ranks survive: a fresh trainer on the (1, tp) mesh resumes at
        # step 2
        shutil.rmtree(os.path.join(d, "a", "step_4"))
        trb = trainer("a", elastic_remesh(tp, tp, "cuda"))
        check(trb.group.shape == (1, tp), f"elastic mesh {trb.group.shape}")
        res["elastic_mesh"] = {"dp": 1, "tp": tp}
        params, _ = trb.init_state()
        opt = trb.restore(params)
        check(trb.step == 2, f"restored step {trb.step}")
        res["restore_s"] = trb.ckpt.timings["restore_s"]
        with np.load(os.path.join(step2, "shard_0.npz")) as saved:
            got = host_leaves(trb.checkpoint_tree(params, opt))
            bad = [k for k, v in got.items()
                   if not np.array_equal(v, saved[k.replace("/", "__")])]
            check(not bad and len(got) == len(saved.files),
                  f"restored leaves unequal to the checkpoint's: {bad}")
        res["restored_leaves_bit_equal"] = len(got)
        del got
        _, _, hb = trb.train(params, opt, resume=False)
        lb = [h["loss"] for h in hb]
        rel = [abs(x - y) / abs(y) for x, y in zip(lb, la[2:])]
        check(len(lb) == 2 and max(rel) <= TRAIN_LOSS_RTOL,
              f"resumed losses {lb} vs {la[2:]}")
        res.update(losses=la, resumed_losses=lb, resumed_loss_rel=rel,
                   resumed_bit_equal=lb == la[2:])
        trb.group.free_symmetric()
        del params, opt, trb
        torch.cuda.empty_cache()

        # a failed step before step 3: reload step 2, run 2 and 3 again
        trc = trainer("c")
        armed = [True]

        def fault_hook(step):
            if step == 3 and armed[0]:
                armed[0] = False
                raise RuntimeError("simulated failure before step 3")

        _, _, hc = trc.train(resume=False, fault_hook=fault_hook)
        lc = [h["loss"] for h in hc]
        check(trc.failures == 1 and trc.step == CKPT_STEPS and len(lc) == 5,
              f"fault run: failures {trc.failures}, step {trc.step}, "
              f"losses {lc}")
        rel_c = [abs(x - y) / abs(y) for x, y in zip(lc[3:], la[2:])]
        check(all(map(math.isfinite, lc)) and max(rel_c) <= TRAIN_LOSS_RTOL,
              f"fault run losses {lc} (steps 2-3 after recovery vs the "
              f"uninterrupted run's {la[2:]})")
        res.update(fault_failures=trc.failures, fault_losses=lc,
                   fault_loss_rel=rel_c,
                   fault_straggler_events=trc.straggler_events,
                   fault_restore_s=trc.ckpt.timings["restore_s"])
        trc.group.free_symmetric()
        del trc
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)


def _paper_batch(torch, cfg):
    """The paper lane's prefill batch: PAPER_BATCH x PAPER_SEQ seeded
    tokens, right-padded past PAPER_LENGTHS."""
    lengths = torch.tensor(PAPER_LENGTHS, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (PAPER_BATCH, PAPER_SEQ),
                         generator=gen, device="cuda")
    toks = toks.masked_fill(torch.arange(PAPER_SEQ, device="cuda")[None]
                            >= lengths[:, None], 0)
    return {"tokens": toks}, lengths


def _paper_tp1(torch, cfg, batch, lengths, n_decode):
    """The tp=1 run the tp=8 lane is held against: the same canonical
    weights (seed 0, bf16) at tp=1 with the flash kernel, the prefill's
    last-position logits kept on the host, then ``n_decode`` greedy dense
    decode steps from its caches, each step's tokens and logits kept (the
    tp=8 decode is teacher-forced on them).  Everything is freed after."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.models import model as M
    from repro_torch.models import serve as S
    from repro_torch.parallel.sharding import make_ctx

    par = ParallelConfig(kernel_decode=True)
    ctx = make_ctx(par)
    params = M.init_model(cfg, par, seed=0, dtype=torch.bfloat16,
                          device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = S.prefill_logits(params, batch, ctx, cfg, lengths)
    torch.cuda.synchronize()
    out = {"prefill_ms": (time.perf_counter() - t0) * 1e3,
           "logits": logits[:, :cfg.vocab_size].float().cpu()}
    check(bool(torch.isfinite(out["logits"]).all()),
          f"{cfg.name} tp=1: non-finite logits")
    if n_decode:
        tok = S.vocab_parallel_argmax(logits, cfg.vocab_size)[:, None]
        caches = _dense_caches(torch, caches,
                               int(lengths.max()) + n_decode + 1)
        tokens, step_logits = [tok], []
        for step in range(n_decode):
            lg, caches = S.decode_logits(params, caches, tok, lengths + step,
                                         ctx, cfg)
            tok = S.vocab_parallel_argmax(lg, cfg.vocab_size)[:, None]
            tokens.append(tok)
            step_logits.append(lg[:, :cfg.vocab_size].float().cpu())
        out["decode"] = {"tokens": [t.cpu() for t in tokens],
                         "logits": step_logits}
    del params, caches, logits
    torch.cuda.empty_cache()
    return out


def _paper_tp8_prefill(torch, cfg, phase, tp1, batch, lengths):
    """One paper model at PAPER_TP ranks on the one card: seeded weights
    drawn as at tp=1 (w1|w3 packed), cut per rank, the global copy freed.
    The main path: counts to 0, one flux prefill with the kernels, counts
    read and held to what its PlanSet implies; the ranks' next tokens
    equal; flux's last-position logits against tp=1's and xla's; xla and
    decomposed launch no fused kernel; each mode's prefill ms; a profiled
    flux and xla prefill.  Returns (group, ranks, the flux prefill's caches, its
    counts, its logits)."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.dist import RankGroup
    from repro_torch.models import model as M
    from repro_torch.models import serve as S
    from repro_torch.parallel.sharding import make_ctx

    tp = PAPER_TP
    group = RankGroup(tp, "cuda")
    baseline = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    full = M.init_model(cfg, ParallelConfig(tp=tp, fuse_w13=True), seed=0,
                        dtype=torch.bfloat16, device="cuda")
    ranks = [M.shard_params(full, r, tp, cfg) for r in range(tp)]
    del full
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ctxs = {mode: make_ctx(ParallelConfig(tp=tp, kernel_decode=True,
                                          fuse_w13=True, overlap_mode=mode),
                           group)
            for mode in ("flux", "xla", "decomposed")}
    args = [(p,) for p in ranks]

    def step(mode):
        return group.spmd(lambda p: S.prefill_step(p, batch, ctxs[mode], cfg,
                                                   lengths), args)

    def logits(mode):
        outs = group.spmd(lambda p: S.prefill_logits(
            p, batch, ctxs[mode], cfg, lengths)[0], args)
        return torch.cat(outs, dim=-1)[:, :cfg.vocab_size].float()

    # the main path: counts to 0, one flux prefill, counts read
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    outs = step("flux")
    torch.cuda.synchronize()
    counts = read_counts()
    want = prefill_launches(ctxs["flux"].plans, cfg, tp, 1, True)
    check(counts == want, f"{phase}: flux prefill launched {counts}, its "
          f"PlanSet implies {want}")
    nxt = outs[0][0]
    check(all(torch.equal(o[0], nxt) for o in outs),
          f"{phase}: the ranks' next tokens differ")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    caches = [o[1] for o in outs]
    del outs
    lf = logits("flux")
    check(bool(torch.isfinite(lf).all()), f"{phase}: non-finite logits")
    lt1 = tp1["logits"].to("cuda")
    rel_tp1 = _rel_l2(lf, lt1)
    check(rel_tp1 <= TP_LANE_RTOL,
          f"{phase}: tp={tp} flux logits vs tp=1 differ by {rel_tp1} "
          f"(relative L2) > {TP_LANE_RTOL}")
    res = {"phase": phase, "arch": cfg.name, "tp": tp,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads_a_rank": cfg.num_heads // tp,
           "kv_heads_a_rank": max(cfg.num_kv_heads // tp, 1),
           "head_dim": cfg.resolved_head_dim, "batch": PAPER_BATCH,
           "lengths": lengths.tolist(), "init_s": init_s,
           "weights_gb_all_ranks": sum(
               p.numel() * p.element_size() for r in ranks
               for p in r.parameters()) / 1e9,
           "baseline_mem_gb": baseline, "init_peak_gb": init_peak_gb,
           "flux_launches": counts, "flux_launches_planset": want,
           "next_tokens": nxt[:, 0].tolist(),
           "next_tokens_tp1": lt1.argmax(-1).tolist(),
           "logits_rel_l2_flux_vs_tp1": rel_tp1,
           "tp1_prefill_ms": tp1["prefill_ms"],
           "prefill_peak_mem_gb": peak_gb, "rtol": TP_LANE_RTOL}
    for mode in ("xla", "decomposed"):
        zero_counts()
        lm = logits(mode)
        torch.cuda.synchronize()
        c = read_counts()
        check(c["ag_gemm"] == 0 and c["gemm_rs"] == 0,
              f"{phase}: {mode} prefill launched the fused kernels: {c}")
        rel = _rel_l2(lf, lm)
        if mode == "xla":
            check(rel <= TP_LANE_RTOL,
                  f"{phase}: flux vs xla logits differ by {rel} (relative "
                  f"L2) > {TP_LANE_RTOL}")
        res[f"logits_rel_l2_flux_vs_{mode}"] = rel
        res[f"{mode}_launches"] = c
        del lm
    for mode in ("flux", "xla", "decomposed"):
        med, samples = wall_ms(torch, lambda: step(mode),
                               repeats=PAPER_REPEATS)
        res[f"prefill_ms_median_{mode}"] = med
        res[f"prefill_ms_samples_{mode}"] = samples
    sums = {"ag_gemm_ms": "ag_gemm", "gemm_rs_ms": "gemm_rs",
            "flash_ms": "flash"}
    for mode in ("flux", "xla"):
        res[f"prefill_profile_{mode}"] = device_profile(
            torch, lambda: step(mode), sums=sums)
    emit(res)
    group.free_symmetric()
    torch.cuda.empty_cache()
    return group, ranks, caches, counts, lf


def phase_paper_gpt3(torch):
    """GPT-3 175B at full width, its first GPT3_PREFILL_LAYERS layers, at
    tp=8 on the one card: the tp=1 prefill and decode first (then freed),
    the tp=8 prefill per mode (``_paper_tp8_prefill``), PAPER_DECODE
    decode steps from the flux prefill's caches against tp=1's
    (``tp_decode``: the ``ar`` seams, no fused kernel), then the measured
    sweep and the prefill from its profile (``paper_tune``)."""
    from repro_torch.configs.base import get_config

    cfg = dataclasses.replace(get_config("gpt3_175b"),
                              num_layers=GPT3_PREFILL_LAYERS)
    batch, lengths = _paper_batch(torch, cfg)
    tp1 = _paper_tp1(torch, cfg, batch, lengths, PAPER_DECODE)
    group, ranks, caches, counts, lf = _paper_tp8_prefill(
        torch, cfg, "paper_gpt3_prefill", tp1, batch, lengths)
    zero_counts()
    tp_decode(torch, group, ranks, cfg, lengths, caches, counts,
              tp1["decode"], n_decode=PAPER_DECODE,
              n_other=PAPER_DECODE_OTHER_MODES, phase="paper_gpt3_decode")
    dec = read_counts()
    check(dec["ag_gemm"] == dec["gemm_rs"] == dec["flash_attention"] == 0,
          f"the paper lane's decode launched {dec}: the replicated layout "
          "runs no fused kernel")
    del caches, tp1
    group.free_symmetric()
    torch.cuda.empty_cache()
    tune = paper_tune(torch, cfg, group, ranks, batch, lengths, lf)
    del ranks
    group.free_symmetric()
    torch.cuda.empty_cache()
    return {"prefill": counts, "decode": dec, **tune}


def paper_tune(torch, cfg, group, ranks, batch, lengths, lf_uniform):
    """The tuner at the paper's width: ``tuning.autotune_model`` measured
    on the group (tp=8, the lane's 8 x 2048 tokens a seam and
    PAPER_TUNE_DECODE_BATCH decode rows, w1|w3 packed as the ranks hold
    them), its launches equal to its flux rows' calls; the flux prefill
    with the kernels from its profile against the uniform flux prefill's
    logits, with the launches its PlanSet implies; one line a cell, with
    its table and its winner's lead over the next candidate."""
    import shutil
    import tempfile

    from repro_torch.configs.base import ParallelConfig
    from repro_torch.core import ect
    from repro_torch.models import serve as S
    from repro_torch.parallel.sharding import make_ctx
    from repro_torch.tuning import PlanRegistry
    from repro_torch.tuning import autotune as AT

    tp = PAPER_TP
    par_u = ParallelConfig(tp=tp, overlap_mode="flux", fuse_w13=True,
                           kernel_decode=True)
    tokens = PAPER_BATCH * PAPER_SEQ
    tdir = tempfile.mkdtemp(prefix="paper_tune_")
    path = os.path.join(tdir, "gpt3_175b_tp8.json")
    res = {"phase": "paper_gpt3_tune", "arch": cfg.name, "tp": tp,
           "layers": cfg.num_layers, "tokens": tokens,
           "decode_batch": PAPER_TUNE_DECODE_BATCH,
           "hardware_priced": dataclasses.asdict(ect.H100_SXM)}

    def sweep(iters, registry, save_path):
        results = []
        zero_counts()
        t0 = time.perf_counter()
        AT.autotune_model(cfg, par_u, hw=ect.H100_SXM, group=group,
                          tokens_per_dp=tokens,
                          decode_batch=PAPER_TUNE_DECODE_BATCH,
                          measure=True, registry=registry,
                          save_path=save_path, iters=iters,
                          warmup=TUNE_WARMUP, results=results)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
        want = sweep_launches(results, cfg, par_u,
                              (TUNE_WARMUP + iters) * tp)
        check(counts == want, f"the paper sweep (iters {iters}) launched "
              f"{counts}, its flux rows call for {want}")
        group.free_symmetric()
        torch.cuda.empty_cache()
        return results, secs, counts

    try:
        reg = PlanRegistry.open(path, n_dev=tp, backend="cuda")
        results, secs, sweep_counts = sweep(TUNE_ITERS, reg, path)
        res["sweep"] = {"iters": TUNE_ITERS, "warmup": TUNE_WARMUP,
                        "seconds": secs, "launches": sweep_counts,
                        "cells": len(results),
                        "rows": sum(len(r.table) for r in results)}

        # the prefill from the profile, against the uniform flux prefill
        ctx_t = make_ctx(dataclasses.replace(par_u, plan_profile=path),
                         group)
        check(ctx_t.plans.seams, f"the profile {path} did not load")
        args = [(p,) for p in ranks]

        def tuned_prefill():
            return group.spmd(lambda p: S.prefill_logits(
                p, batch, ctx_t, cfg, lengths)[0], args)

        zero_counts()
        outs = tuned_prefill()
        torch.cuda.synchronize()
        c_t = read_counts()
        want = prefill_launches(ctx_t.plans, cfg, tp, 1, True)
        check(c_t == want, f"the tuned prefill launched {c_t}, its PlanSet "
              f"implies {want}")
        lt = torch.cat(outs, dim=-1)[:, :cfg.vocab_size].float()
        del outs
        rel = _rel_l2(lt, lf_uniform)
        check(rel <= TP_LANE_RTOL, f"the tuned prefill's logits vs uniform "
              f"flux: relative L2 {rel} > {TP_LANE_RTOL}")
        med, samples = wall_ms(torch, tuned_prefill, repeats=PAPER_REPEATS)
        res["tuned_prefill"] = {"launches": c_t, "launches_planset": want,
                                "logits_rel_l2_vs_uniform_flux": rel,
                                "prefill_ms_median": med,
                                "prefill_ms_samples": samples,
                                "plans": {s: p.to_json() for s, p in
                                          ctx_t.plans.seams.items()}}
        group.free_symmetric()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tdir, ignore_errors=True)

    def plan_key(p):
        return (p.mode, p.comm_chunks, p.reverse, str(p.blocks),
                p.shared_gather, p.fuse_epilogue)

    for r in results:
        best = sorted(r.table, key=lambda x: x["measured_s"])
        lead = ((best[1]["measured_s"] - best[0]["measured_s"]) * 1e3
                if len(best) > 1 else None)
        emit({"phase": "paper_tune_cell", "seam": r.seam, "kind": r.kind,
              "mkn": [r.m, r.n, r.k], "pruned": r.pruned,
              "rows_fields": ["mode", "comm_chunks", "reverse", "blocks",
                              "shared_gather", "fuse_epilogue",
                              f"measured_ms_iters{TUNE_ITERS}",
                              "predicted_ms"],
              "rows": [[x["mode"], x["comm_chunks"], x["reverse"],
                        x["blocks"], x["shared_gather"], x["fuse_epilogue"],
                        x["measured_s"] * 1e3, x["predicted_s"] * 1e3]
                       for x in r.table],
              "winner": dict(zip(("mode", "comm_chunks", "reverse",
                                  "blocks", "shared_gather",
                                  "fuse_epilogue"), plan_key(r.plan)),
                             measured_ms=r.plan.measured_s * 1e3,
                             predicted_ms=r.plan.predicted_s * 1e3),
              "lead_over_next_ms": lead})
    emit(res)
    return {"tune_sweep": sweep_counts, "tuned_prefill": c_t}


def phase_paper_train(torch, arch, layers, steps):
    """One paper model at full width cut to ``layers`` layers, trained at
    tp=8 in flux on the one card (bf16 weights, fp32 moments, batch
    PAPER_TRAIN_BATCH x PAPER_SEQ from ``data/pipeline.py``): step 0 at
    tp=1 (then freed), step 0 at tp=8 in flux with its forward and
    backward launches held to its PlanSet's, its loss and canonical grads
    (divided by 8) against tp=1's, xla's step 0 against flux's (no fused
    kernel); then ``steps`` trainer steps (finite losses, their launches,
    ms, peak memory and one profiled step)."""
    from repro_torch.configs.base import (ParallelConfig, get_config,
                                          train_schedule)
    from repro_torch.models import model as M
    from repro_torch.runtime import trainer as T
    from repro_torch.tuning import plan_set_from_parallel

    t_phase = time.perf_counter()
    tp = PAPER_TP
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    tc = T.TrainConfig(total_steps=max(steps, 1), warmup_steps=0,
                       base_lr=3e-4, schedule=train_schedule(arch),
                       log_every=max(steps, 1))

    def trainer(par):
        tr = T.Trainer(cfg, par, tc, device="cuda", dtype=torch.bfloat16)
        tr.data_cfg = dataclasses.replace(tr.data_cfg, seq_len=PAPER_SEQ,
                                          global_batch=PAPER_TRAIN_BATCH)
        return tr

    res = {"phase": f"paper_{arch.split('_')[0]}_train", "arch": cfg.name,
           "layers": layers, "tp": tp, "batch": PAPER_TRAIN_BATCH,
           "seq": PAPER_SEQ, "dtype": "bfloat16 weights, float32 moments",
           "loss_rtol": TRAIN_LOSS_RTOL, "grad_rtol": TRAIN_GRAD_RTOL,
           "baseline_mem_gb": torch.cuda.memory_allocated() / 1e9}
    par1 = ParallelConfig(tp=1, fuse_w13=True)
    batch0 = trainer(par1).batch(0)
    params1 = M.init_model(cfg, par1, seed=tc.seed, dtype=torch.bfloat16,
                           device="cuda", trainable=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss1, g1 = T.loss_and_grads(params1, batch0, T.make_ctx(cfg, par1), cfg,
                                 par1)
    loss1 = loss1.item()
    res["tp1"] = {"step0_loss": loss1,
                  "step0_ms": (time.perf_counter() - t0) * 1e3,
                  "step0_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                  "weights": sum(p.numel() for p in params1.parameters())}
    can1 = M.canonical_leaves(g1, cfg, 1, grads=True)
    del params1, g1
    torch.cuda.empty_cache()

    par8 = ParallelConfig(tp=tp, fuse_w13=True, overlap_mode="flux")
    tr8 = trainer(par8)
    group = tr8.group
    # the weights first, the moments after the step-0 comparisons: the
    # gathered grads and tp=1's would not fit beside them
    full = M.init_model(cfg, par8, seed=tc.seed, dtype=torch.bfloat16,
                        device="cuda", trainable=True)
    ranks = [M.shard_params(full, r, tp, cfg) for r in range(tp)]
    del full
    torch.cuda.empty_cache()
    loss8, can8, c_fwd, c_bwd, host8 = step0(torch, cfg, par8, group,
                                             ranks, [batch0])
    want_f, want_b = plan_launches(plan_set_from_parallel(par8, "cuda"), cfg,
                                   tp, 1)
    check(c_fwd == want_f and c_bwd == want_b,
          f"{arch} tp={tp} flux step 0 launched {c_fwd} / {c_bwd}, its "
          f"PlanSet implies {want_f} / {want_b}")
    rel_loss = abs(loss8 - loss1) / abs(loss1)
    rel_g, leaf = _worst_leaf(can8, can1)
    check(rel_loss <= TRAIN_LOSS_RTOL and rel_g <= TRAIN_GRAD_RTOL,
          f"{arch} tp={tp} flux step 0 vs tp=1: loss relative {rel_loss}, "
          f"grad of {leaf} relative L2 {rel_g}")
    res["flux"] = {"step0_loss": loss8, "loss_rel_vs_tp1": rel_loss,
                   "grad_rel_l2_vs_tp1_max": rel_g, "grad_worst_leaf": leaf,
                   "launches_forward": c_fwd, "launches_backward": c_bwd,
                   "step0_host": host8}
    del can1
    lx, canx, cf, cb, hx = step0(
        torch, cfg, dataclasses.replace(par8, overlap_mode="xla"), group,
        ranks, [batch0])
    check(cf["ag_gemm"] == cf["gemm_rs"] == cb["ag_gemm"] == cb["gemm_rs"]
          == 0, f"{arch} xla step launched the fused kernels: {cf} / {cb}")
    rl = abs(lx - loss8) / abs(loss8)
    rg, lfx = _worst_leaf(canx, can8)
    check(rl <= TRAIN_LOSS_RTOL and rg <= TRAIN_GRAD_RTOL,
          f"{arch} xla vs flux step 0: loss relative {rl}, grad of {lfx} "
          f"relative L2 {rg}")
    res["xla"] = {"step0_loss": lx, "loss_rel_vs_flux": rl,
                  "grad_rel_l2_vs_flux_max": rg, "grad_worst_leaf": lfx,
                  "step0_host": hx}
    del canx, can8
    group.free_symmetric()
    torch.cuda.empty_cache()
    counts = None
    if steps:
        opts = [tr8.init_opt(p) for p in ranks]
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        _, opts, hist = tr8.train(ranks, opts)
        torch.cuda.synchronize()
        counts = read_counts()
        want = {k: steps * (want_f[k] + want_b[k]) for k in want_f}
        check(counts == want, f"{arch}: {steps} flux trainer steps launched "
              f"{counts}, expected {want}")
        losses = [h["loss"] for h in hist]
        check(len(losses) == steps and all(map(math.isfinite, losses)),
              f"{arch} tp={tp} losses {losses}")
        ms = [h["seconds"] * 1e3 for h in hist]
        res["trainer"] = {
            "steps": steps, "losses": losses, "step_ms": ms,
            "step_ms_median": sorted(ms)[len(ms) // 2],
            "launches": counts,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "profiled_step": device_profile(
                torch, lambda: tr8.run_step(ranks, opts, [batch0]),
                sums={"ag_gemm_ms": "ag_gemm", "gemm_rs_ms": "gemm_rs"})}
        del opts
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    del ranks, tr8
    group.free_symmetric()
    torch.cuda.empty_cache()
    return {"forward": c_fwd, "backward": c_bwd, "trainer_steps": counts}


def phase_paper_llama2(torch):
    """Llama-2 70B at full width, its first LLAMA_PREFILL_LAYERS layers, at
    tp=8 on the one card: the tp=1 prefill (then freed), then the tp=8
    prefill per mode (``_paper_tp8_prefill``): the flash kernel over 8
    query heads and 1 KV head a rank, head_dim 128."""
    from repro_torch.configs.base import get_config

    cfg = dataclasses.replace(get_config("llama2_70b"),
                              num_layers=LLAMA_PREFILL_LAYERS)
    batch, lengths = _paper_batch(torch, cfg)
    tp1 = _paper_tp1(torch, cfg, batch, lengths, 0)
    group, ranks, caches, counts, _ = _paper_tp8_prefill(
        torch, cfg, "paper_llama2_prefill", tp1, batch, lengths)
    del ranks, caches, tp1
    group.free_symmetric()
    torch.cuda.empty_cache()
    return counts


def paper_launches(paper, kernel):
    """The paper lane's launches of ``kernel`` (a wrapper's name), by
    path."""
    def get(c):
        return None if c is None else c[kernel]
    g3, g3t, l2t = paper["gpt3"], paper["gpt3_train"], paper["llama2_train"]
    return {"gpt3_prefill": get(g3["prefill"]),
            "gpt3_decode": get(g3["decode"]),
            "gpt3_train_forward": get(g3t["forward"]),
            "gpt3_train_backward": get(g3t["backward"]),
            "gpt3_trainer_steps": get(g3t["trainer_steps"]),
            "gpt3_tuned_prefill": get(g3["tuned_prefill"]),
            "gpt3_tune_sweep": get(g3["tune_sweep"]),
            "llama2_prefill": get(paper["llama2"]),
            "llama2_train_forward": get(l2t["forward"]),
            "llama2_train_backward": get(l2t["backward"])}


def paper_lane(torch, timed):
    """The paper lane's phases, each timed: GPT-3 175B's prefill, decode
    and tuner, its training, Llama-2 70B's prefill, its training and its
    server, at tp=8 on the one card.  Returns their launch counts."""
    return {
        "gpt3": timed("paper_gpt3", phase_paper_gpt3, torch),
        "gpt3_train": timed("paper_gpt3_train", phase_paper_train, torch,
                            "gpt3_175b", GPT3_TRAIN_LAYERS,
                            PAPER_TRAIN_STEPS),
        "llama2": timed("paper_llama2", phase_paper_llama2, torch),
        "llama2_train": timed("paper_llama2_train", phase_paper_train,
                              torch, "llama2_70b", LLAMA_TRAIN_LAYERS, 0),
        "llama2_serve": timed("paper_llama2_serve", serve_lane, torch,
                              "paper_llama2_serve", PAPER_SERVER_ARGV,
                              PAPER_TP, True)}


def main():
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: the port runs on the card")
    import repro_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_s = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t
        return out

    smi = timed("device", phase_device, torch)
    timed("build", phase_build)
    flash_case = timed("kernel", phase_kernel, torch)
    mla_case, mla_tp_case = timed("mla_kernel", phase_mla_kernel, torch)
    flash_launches, tp1_logits, tp1_decode = timed(
        "kernel_lane", phase_kernel_lane, torch)
    timed("server_lane", phase_server_lane, torch)
    params, cfg, (mla_launches, mla_combines), mla_tp1 = timed(
        "mla_lane", phase_mla_lane, torch)
    timed("mla_server_lane", phase_mla_server_lane, torch, params, cfg)
    del params
    torch.cuda.empty_cache()
    mla_tp = timed("mla_tp_lane", phase_mla_tp_lane, torch, mla_tp1)
    del mla_tp1
    timed("mla_tp_server_lane", phase_mla_tp_server_lane, torch)
    matmul_case = timed("matmul_kernel", phase_matmul_kernel, torch)
    matmul_launches, _ = timed("op_level_lane", phase_op_level_lane, torch)
    ag_case, ag_mla, ag_train_mla, ag_jamba, ag_rwkv = timed(
        "ag_gemm_kernel", phase_fused_kernel, torch, "ag")
    rs_case, rs_mla, rs_train_mla, rs_jamba, rs_rwkv = timed(
        "gemm_rs_kernel", phase_fused_kernel, torch, "rs")
    tp_counts = timed("tp_op_level_lane", phase_tp_op_level_lane, torch)
    timed("tp_lane", phase_tp_lane, torch, tp1_logits, tp1_decode)
    del tp1_logits, tp1_decode
    tp1_tokens = timed("tp_server_lane", phase_tp_server_lane, torch)
    train_counts = timed("train_lane", phase_train_lane, torch)
    mla_train = timed("mla_train_lane", phase_mla_train_lane, torch)
    # after the mla train lane has freed its moments
    ep_counts = timed("ep_lane", phase_ep_lane, torch)
    # after the mla train lane, whose peak leaves the least room
    dp_counts = timed("dp_lane", phase_dp_lane, torch,
                      train_counts.pop("losses"))
    pipe_flash = timed("pipeline_lane", phase_pipeline_lane, torch)
    mesh_serve = timed("mesh_serve_lane", phase_mesh_serve_lane, torch)
    # after Scout's weights are freed
    jamba = timed("jamba_lane", phase_jamba_lane, torch)
    jamba_train = timed("jamba_train_lane", phase_jamba_train_lane, torch)
    rwkv = timed("rwkv_lane", phase_rwkv_lane, torch)
    rwkv_train = timed("rwkv_train_lane", phase_rwkv_train_lane, torch)
    tune_counts = timed("tune_lane", phase_tune_lane, torch, tp1_tokens)
    wire_counts = timed("wire_lane", phase_wire_lane, torch)
    timed("train_remat", phase_train_remat, torch)
    timed("train_ckpt", phase_train_ckpt, torch)
    paper = paper_lane(torch, timed)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "phase_s": phase_s})
    print(smi, flush=True)
    emit({"kernels": [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:21",
         "launches": flash_launches,
         "max_abs_err": flash_case["max_abs_err"],
         "ms": flash_case["kernel_ms"], "plain_ms": flash_case["plain_ms"],
         "bound_ms": flash_case["bound_ms"],
         "bound_by": flash_case["bound_by"],
         "library_ms": flash_case["library_ms"],
         "paper_launches": paper_launches(paper, "flash_attention"),
         "wire_launches": wire_counts["flash_attention"],
         "pipeline_launches": pipe_flash,
         "mesh_serve_launches": mesh_serve["flash_attention"],
         "jamba_launches": jamba["flash_attention"]},
        {"name": "mla_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/mla_decode.cu",
         "replaces": "src/repro/kernels/mla_decode.py:28",
         "launches": mla_launches, "combine_launches": mla_combines,
         "mla_tp_launches": {"decode": mla_tp["decode_mla"],
                             "combine": mla_tp["decode_combines"]},
         "max_abs_err": mla_case["max_abs_err"],
         "ms": mla_case["kernel_ms"], "plain_ms": mla_case["plain_ms"],
         "device_ms": mla_case["device_ms"],
         "bound_ms": mla_case["bound_ms"], "bound_by": mla_case["bound_by"],
         "library_ms": mla_case["library_ms"],
         "tp4_rank_case": {k: mla_tp_case[k] for k in (
             "max_abs_err", "kernel_ms", "device_ms", "plain_ms",
             "library_ms", "bound_ms", "bound_by")}},
        {"name": "matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/matmul.cu",
         "replaces": "src/repro/kernels/matmul.py:19",
         "launches": matmul_launches,
         "max_abs_err": matmul_case["max_abs_err"],
         "ms": matmul_case["kernel_ms"], "plain_ms": matmul_case["plain_ms"],
         "bound_ms": matmul_case["bound_ms"],
         "bound_by": matmul_case["bound_by"],
         "library_ms": matmul_case["library_ms"]},
        {"name": "ag_gemm", "route": "cuda",
         "source": "src/repro_torch/csrc/ag_gemm.cu",
         "replaces": "src/repro/kernels/ag_gemm.py:45",
         "launches": tp_counts["ag_gemm"],
         "train_launches": {
             "forward": train_counts["forward"]["ag_gemm"],
             "backward": train_counts["backward"]["ag_gemm"],
             "backward_remat": train_counts["backward_remat"]["ag_gemm"],
             "trainer_steps": train_counts["trainer_steps"]["ag_gemm"],
             "mla_train": {d: mla_train[d]["ag_gemm"] for d in (
                 "forward", "backward", "trainer_steps")}},
         "tune_launches": {
             "sweep": tune_counts["sweep"]["ag_gemm"],
             "tuned_step": {
                 d: tune_counts["tuned_step"][d]["ag_gemm"]
                 for d in ("forward", "backward")},
             "heterogeneous_step": {
                 d: tune_counts["heterogeneous_step"][d]["ag_gemm"]
                 for d in ("forward", "backward")}},
         "dp_launches": {k: v["ag_gemm"] for k, v in dp_counts.items()},
         "ep_launches": {k: {d: v[d]["ag_gemm"] for d in v}
                         for k, v in ep_counts.items()},
         "paper_launches": paper_launches(paper, "ag_gemm"),
         "wire_launches": wire_counts["ag_gemm"],
         "mesh_serve_launches": mesh_serve["ag_gemm"],
         "jamba_launches": jamba["ag_gemm"],
         "jamba_train_launches": jamba_train["ag_gemm"],
         "jamba_cases": mla_seam_cases(ag_jamba),
         "rwkv_launches": rwkv["ag_gemm"],
         "rwkv_train_launches": rwkv_train["ag_gemm"],
         "rwkv_cases": mla_seam_cases(ag_rwkv),
         "mla_tp_launches": mla_tp["prefill"]["ag_gemm"],
         "mla_tp_cases": mla_seam_cases(ag_mla),
         "train_mla_cases": mla_seam_cases(ag_train_mla),
         "max_abs_err": ag_case["max_abs_err"],
         "ms": ag_case["fused_ms"], "plain_ms": ag_case["plain_ms"],
         "bound_ms": ag_case["bound_ms"], "bound_by": ag_case["bound_by"],
         "library_ms": ag_case["xla_ms"]},
        {"name": "gemm_rs", "route": "cuda",
         "source": "src/repro_torch/csrc/gemm_rs.cu",
         "replaces": "src/repro/kernels/gemm_rs.py:33",
         "launches": tp_counts["gemm_rs"],
         "train_launches": {
             "forward": train_counts["forward"]["gemm_rs"],
             "backward": train_counts["backward"]["gemm_rs"],
             "backward_remat": train_counts["backward_remat"]["gemm_rs"],
             "trainer_steps": train_counts["trainer_steps"]["gemm_rs"],
             "mla_train": {d: mla_train[d]["gemm_rs"] for d in (
                 "forward", "backward", "trainer_steps")}},
         "tune_launches": {
             "sweep": tune_counts["sweep"]["gemm_rs"],
             "tuned_step": {
                 d: tune_counts["tuned_step"][d]["gemm_rs"]
                 for d in ("forward", "backward")},
             "heterogeneous_step": {
                 d: tune_counts["heterogeneous_step"][d]["gemm_rs"]
                 for d in ("forward", "backward")}},
         "dp_launches": {k: v["gemm_rs"] for k, v in dp_counts.items()},
         "ep_launches": {k: {d: v[d]["gemm_rs"] for d in v}
                         for k, v in ep_counts.items()},
         "paper_launches": paper_launches(paper, "gemm_rs"),
         "wire_launches": {"gemm_rs": wire_counts["gemm_rs"],
                           "reduce": wire_counts["gemm_rs_reduce"]},
         "mesh_serve_launches": mesh_serve["gemm_rs"],
         "jamba_launches": jamba["gemm_rs"],
         "jamba_train_launches": jamba_train["gemm_rs"],
         "jamba_cases": mla_seam_cases(rs_jamba),
         "rwkv_launches": rwkv["gemm_rs"],
         "rwkv_train_launches": rwkv_train["gemm_rs"],
         "rwkv_cases": mla_seam_cases(rs_rwkv),
         "mla_tp_launches": mla_tp["prefill"]["gemm_rs"],
         "mla_tp_cases": mla_seam_cases(rs_mla),
         "train_mla_cases": mla_seam_cases(rs_train_mla),
         "max_abs_err": rs_case["max_abs_err"],
         "ms": rs_case["fused_ms"], "plain_ms": rs_case["plain_ms"],
         "bound_ms": rs_case["bound_ms"], "bound_by": rs_case["bound_by"],
         "library_ms": rs_case["xla_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

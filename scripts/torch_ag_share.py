#!/usr/bin/env python3
"""Where the AG-GEMM's time goes when the ranks of a RankGroup share one card.

    python3 scripts/torch_ag_share.py          # on the card, from the repo root

Times the fused AllGather-GEMM (``kernels/ag_gemm.py``) at the §5.1 AG
shape, each rank ``[m/n, 12288]`` gathered to ``[m, 12288]`` times
``[12288, 6144]``, bf16, m 8192, with the grid bound the kernel's launch
takes from ``share`` (the ranks running on the card at once,
``csrc/ag_gemm.cu::launch``) overridden per variant:

* n 1 (no copies, no waits, the full persistent grid): the kernel alone;
* n 8, share 8: what the port runs (each rank's launch holds at most 1/8
  of the card's CTA slots less 8; waiting CTAs can never hold them all);
* n 8, share 16: half of that;
* n 8, share 1: no bound, every slot of the card a rank.  This traps,
  with a block a tile as with the persistent grid: queuing every copy
  before any kernel does not make it safe, since waiting blocks can hold
  every slot while shards are still missing.  The grid bound is what keeps the kernel from
  hanging.

Each variant runs in a process of its own (a wait that never ends traps
after 2 s and ends its process's CUDA context) and prints one JSON line:
the mean ms of one n-rank call (CUDA events around 10 calls of every
rank), and from one profiled call the shard copies' count, summed and
longest ms and span, and each rank's kernel start and duration.
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = ((1, 8192, 1), (8, 1024, 8), (8, 1024, 16), (8, 1024, 1))

CHILD = r'''
import json, sys, torch
sys.path.insert(0, "src")
from repro_torch.dist import RankGroup
from repro_torch.kernels import ag_gemm as AG
from torch.profiler import ProfilerActivity, profile

n, rows, share = (int(v) for v in sys.argv[1:4])
lib = AG._library()


class Library:              # the loaded library, with `share` overridden
    ag_gemm_pull = lib.ag_gemm_pull

    @staticmethod
    def ag_gemm_fwd(*args):
        args = list(args)
        args[20] = share    # csrc/ag_gemm.cu ag_gemm_fwd's `share`
        return lib.ag_gemm_fwd(*args)


AG._library = lambda: Library
g = RankGroup(n, "cuda", timeout_s=60)
gen = torch.Generator(device="cuda")
gen.manual_seed(0)
args = [(torch.randn((rows, 12288), generator=gen, device="cuda").bfloat16(),
         torch.randn((12288, 6144), generator=gen, device="cuda").bfloat16())
        for _ in range(n)]


def body(a, b, reps):
    for _ in range(reps):
        out = AG.ag_gemm(a, b, group=g)
    return out


g.spmd(lambda a, b: body(a, b, 3), args)
torch.cuda.synchronize()
start = torch.cuda.Event(enable_timing=True)
end = torch.cuda.Event(enable_timing=True)
start.record()
g.spmd(lambda a, b: body(a, b, 10), args)
end.record()
end.synchronize()
res = {"ranks": n, "rank_rows": rows, "share": share,
       "ms_per_call": start.elapsed_time(end) / 10}
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    g.spmd(lambda a, b: body(a, b, 1), args)
    torch.cuda.synchronize()
ev = [e for e in prof.events()
      if e.device_type == torch.autograd.DeviceType.CUDA]
t0 = min(e.time_range.start for e in ev)
cp = [e for e in ev if "Memcpy" in e.name]
if cp:
    res["copies"] = len(cp)
    res["copies_sum_ms"] = sum(e.time_range.elapsed_us() for e in cp) / 1e3
    res["copy_max_ms"] = max(e.time_range.elapsed_us() for e in cp) / 1e3
    res["copies_last_end_ms"] = (max(e.time_range.end for e in cp) - t0) / 1e3
res["kernels_start_and_ms"] = [
    [(e.time_range.start - t0) / 1e3, e.time_range.elapsed_us() / 1e3]
    for e in ev if "ag_gemm" in e.name]
print(json.dumps(res), flush=True)
'''


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    for variant in VARIANTS:
        try:
            r = subprocess.run([sys.executable, "-c", CHILD]
                               + [str(v) for v in variant], cwd=ROOT,
                               capture_output=True, text=True, timeout=300)
            line = (r.stdout.strip().splitlines() or [""])[-1]
            if r.returncode != 0 or not line.startswith("{"):
                line = json.dumps({"variant": variant, "rc": r.returncode,
                                   "stderr": r.stderr[-600:]})
        except subprocess.TimeoutExpired:
            line = json.dumps({"variant": variant, "timeout_s": 300})
        print(line, flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""A/B of one compile-time setting of the port's Hopper kernels, on the card.

    python3 scripts/torch_kernel_ab.py [flash_stages] [large_stages]
        [mla_splits]

Each experiment rewrites one line of a copy of ``src/repro_torch/csrc``
(a variant), builds the kernel's library from it with the kernel's own nvcc
flags into ``build/repro_torch/ab/``, and times it against the shipped
source in turns (shipped, variant, variant, shipped), every variant checked
against the plain version first:

* ``flash_stages``: the bf16 flash kernel's K/V ring depth
  (``csrc/flash_attention.cu`` ``Flash::STAGES``), CUDA-event means of 50
  calls at the kernel lane's and tp lane's shapes, the gqa_d128 shape, the
  chunked-prefill suffix and a 4096-token prompt;
* ``large_stages``: the ring depth of the 128 x 256 GEMM tile
  (``csrc/gemm_tile.cuh`` ``LargeTile``), timed as the AG-GEMM at TP 8, m
  8192 (eight ranks on the card, share 8: mean of 10 calls, and each
  rank's kernel time from one profiled call), and alone (n 1), each in a
  process of its own (a wait that never ends traps);
* ``mla_splits``: the MLA-decode kernel's number of splits over S
  (``kernels/mla_decode.py::split_plan`` replaced for the call, no
  rebuild) at the mla lane's shape and the long case, in turns over two
  rounds (forward, then backward): the device time a call (its kernels
  under ``torch.profiler``) and the call's CUDA-event time, each with the
  L2 cache flushed before each call, by ``chip_smoke.py``'s own helpers
  (``device_ms_cold``, ``time_ms_cold``); the wrapper's host time is not
  in the first.

One JSON object a line, with the card's name and power limit first; exits
1 if a variant fails to build or disagrees with the plain version.
"""
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

# experiment -> (library, file, pattern of the line, {tag: the new line})
EXPERIMENTS = {
    "flash_stages": ("flash_attention", "flash_attention.cu",
                     r"static constexpr int STAGES = \d+;",
                     {f"stages{n}": f"static constexpr int STAGES = {n};"
                      for n in (2, 4)}),
    "large_stages": ("ag_gemm", "gemm_tile.cuh",
                     r"using LargeTile = WgmmaTile<2, 256, \d+, 40, 232>;",
                     {"stages4": "using LargeTile = WgmmaTile<2, 256, 4, 40, "
                                 "232>;"}),
    "mla_splits": ("mla_decode", "mla_decode.cu", None, {}),
}
MLA_CASES = [  # name, B, H, S, valid lengths (chip_smoke.py's cases)
    ("mla_lane_decode", 4, 128, 1041, [257, 513, 778, 1025]),
    ("long_cache", 8, 128, 32768, [1000] + [32768] * 7)]
MLA_KERNELS = {"kernel": "mla_wgmma_kernel", "combine": "mla_combine_kernel"}
FLASH_SHAPES = [  # B, Hq, Hkv, Sq, Skv, D, causal, kv_offset
    (4, 36, 36, 1024, 1024, 64, True, 0), (4, 9, 9, 1024, 1024, 64, True, 0),
    (4, 32, 8, 1024, 1024, 128, True, 0),
    (4, 36, 36, 256, 1024, 64, True, 768),
    (4, 36, 36, 4096, 4096, 64, True, 0)]
AG_CHILD = r'''
import ctypes, json, sys, torch
sys.path.insert(0, "src")
from torch.profiler import ProfilerActivity, profile
from repro_torch.dist import RankGroup
from repro_torch.kernels import ag_gemm as AG
so, n, rows = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
lib = ctypes.CDLL(so)
vp, i = ctypes.c_void_p, ctypes.c_int
lib.ag_gemm_pull.argtypes = [vp, vp, ctypes.c_size_t, vp, i, vp]
lib.ag_gemm_pull.restype = i
lib.ag_gemm_fwd.argtypes = [vp] * 6 + [i] * 15 + [vp]
lib.ag_gemm_fwd.restype = i
AG._library = lambda: lib
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


outs = g.spmd(lambda a, b: body(a, b, 1), args)
torch.cuda.synchronize()
shards = [a for a, _ in args]
err, ok = 0.0, True
for o, (_, b) in zip(outs, args):   # the GEMM rule: 2 bf16 ulps
    w = AG.ag_gemm_ref(shards, b).float()
    d = (o.float() - w).abs()
    err = max(err, d.max().item())
    ok &= bool((d <= 1e-3 * w.abs().max() + 2.0 ** -7 * w.abs()).all())
g.spmd(lambda a, b: body(a, b, 2), args)
torch.cuda.synchronize()
s = torch.cuda.Event(enable_timing=True)
e = torch.cuda.Event(enable_timing=True)
s.record()
g.spmd(lambda a, b: body(a, b, 10), args)
e.record()
e.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    g.spmd(lambda a, b: body(a, b, 1), args)
    torch.cuda.synchronize()
ks = [ev.time_range.elapsed_us() / 1e3 for ev in prof.events()
      if ev.device_type == torch.autograd.DeviceType.CUDA
      and "ag_gemm" in ev.name]
print(json.dumps({"ms_per_call": s.elapsed_time(e) / 10, "kernel_ms": ks,
                  "max_abs_err": err, "ok": ok}))
'''


def emit(obj):
    print(json.dumps(obj), flush=True)


def build_variant(lib_name, fname, pattern, tag, line):
    """A copy of csrc/ with `pattern`'s line replaced; its library."""
    src = build.BUILD_DIR / "ab" / f"{lib_name}-{tag}"
    if src.exists():
        shutil.rmtree(src)
    shutil.copytree(build.CSRC, src)
    path = src / fname
    text = path.read_text()
    if len(re.findall(pattern, text)) != 1:
        raise SystemExit(f"{fname}: the line {pattern!r} was not found once")
    path.write_text(re.sub(pattern, line, text))
    so = src / f"{lib_name}.so"
    res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so),
                          str(src / f"{lib_name}.cu")], capture_output=True,
                         text=True)
    return so, res.returncode, res.stdout + res.stderr


def time_ms(fn, iters=50, warmup=3):
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


def flash_stages(libs):
    from repro_torch.kernels import flash_attention as fa
    shipped = fa._library()
    loaded = {"shipped": shipped}
    for tag, so in libs.items():
        lib = ctypes.CDLL(str(so))
        lib.flash_attention_fwd.argtypes = shipped.flash_attention_fwd.argtypes
        lib.flash_attention_fwd.restype = ctypes.c_int
        loaded[tag] = lib
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    fails = 0
    for b, hq, hkv, sq, skv, d, causal, off in FLASH_SHAPES:
        q = torch.randn((b, hq, sq, d), generator=gen,
                        device="cuda").bfloat16()
        k = torch.randn((b, hkv, skv, d), generator=gen,
                        device="cuda").bfloat16()
        v = torch.randn((b, hkv, skv, d), generator=gen,
                        device="cuda").bfloat16()
        want = fa.flash_attention_ref(q, k, v, causal=causal,
                                      kv_offset=off).float()

        def run(lib):
            fa._library = lambda: lib
            return fa.flash_attention(q, k, v, causal=causal, kv_offset=off)
        row = {"experiment": "flash_stages",
               "shape": [b, hq, hkv, sq, skv, d, causal, off]}
        for tag, lib in loaded.items():
            out = run(lib).float()
            ok = torch.allclose(out, want, atol=2e-2, rtol=2e-2)
            fails += not ok
            row[f"{tag}_max_abs_err"] = (out - want).abs().max().item()
        for tag, lib in loaded.items():
            if tag == "shipped":
                continue
            t = [time_ms(lambda: run(x)) for x in (shipped, lib, lib,
                                                    shipped)]
            row[f"shipped_vs_{tag}_ms"] = t
        emit(row)
        del q, k, v, want
    fa._library = lambda: shipped
    return fails


def large_stages(libs):
    shipped = build.build("ag_gemm")
    fails = 0
    for n, rows in ((8, 1024), (1, 8192)):
        for tag, so in libs.items():
            for name, lib in (("shipped", shipped), (tag, so), (tag, so),
                              ("shipped", shipped)):
                r = subprocess.run([sys.executable, "-c", AG_CHILD, str(lib),
                                    str(n), str(rows)], cwd=ROOT,
                                   capture_output=True, text=True,
                                   timeout=300)
                lines = r.stdout.strip().splitlines()
                row = {"experiment": "large_stages", "variant": name,
                       "ranks": n, "rank_rows": rows, "rc": r.returncode}
                if r.returncode == 0 and lines:
                    row.update(json.loads(lines[-1]))
                    fails += not row["ok"]
                else:
                    row["stderr"] = r.stderr[-400:]
                    fails += 1
                emit(row)
    return fails


def mla_inputs(b, h, s, valid, seed=0):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    return (randn(b, h, 512), randn(b, h, 64), randn(b, s, 512).bfloat16(),
            randn(b, s, 64).bfloat16(), torch.tensor(valid, device="cuda"))


def mla_run(md, case, plan=None):
    """One checked call and its times under ``plan`` (n_splits,
    split_rows), or split_plan's own."""
    name, b, h, s, valid = case
    qe, qr, c, kr, vl = mla_inputs(b, h, s, valid)
    shipped_plan = md.split_plan
    if plan is not None:
        md.split_plan = lambda *a: plan
    try:
        out = md.mla_decode_attention(qe, qr, c, kr, vl, scale=0.07)
        want = md.mla_decode_attention_ref(qe, qr, c, kr, vl, 0.07)
        ok = bool(torch.allclose(out, want, atol=1e-4, rtol=1e-4))
        err = (out - want).abs().max().item()

        def call():
            return md.mla_decode_attention(qe, qr, c, kr, vl, scale=0.07)
        # the kernel's and the combine's device time, as chip_smoke.py
        # reports them (kernel_device_ms + combine_device_ms)
        dev = sum(smoke.device_ms_cold(torch, call, 10, MLA_KERNELS)[1]
                  .values())
        call_ms = smoke.time_ms_cold(torch, call, 10)
    finally:
        md.split_plan = shipped_plan
    return ok, err, dev, call_ms


def mla_splits(libs):
    from repro_torch.kernels import mla_decode as md
    fails = 0
    for case in MLA_CASES:
        name, b, h, s, _ = case
        tiles = -(-s // md.ROW_TILE)
        counts = ([1, 2, 3, 4, 6, 9, 11, 17, 33] if s < 4096 else
                  [1, 2, 4, 8, 16])
        shipped = md.split_plan(
            b, h, s, torch.cuda.get_device_properties(0).multi_processor_count)
        for rnd, order in enumerate((counts, counts[::-1])):
            for n in order:
                per = -(-tiles // n)
                plan = (-(-tiles // per), per * md.ROW_TILE)
                ok, err, dev, call = mla_run(md, case, plan)
                fails += not ok
                emit({"experiment": "mla_splits", "case": name,
                      "round": rnd, "n_splits": plan[0],
                      "split_rows": plan[1], "shipped": plan == shipped,
                      "max_abs_err": err, "device_ms": dev, "call_ms": call})
    return fails


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    names = sys.argv[1:] or list(EXPERIMENTS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit({"card": smi})
    fails = 0
    for name in names:
        lib_name, fname, pattern, variants = EXPERIMENTS[name]
        libs = {}
        for tag, line in variants.items():
            so, rc, log = build_variant(lib_name, fname, pattern, tag, line)
            emit({"experiment": name, "variant": tag, "nvcc_rc": rc,
                  "ptxas": [ln.split(": ")[-1].strip()
                            for ln in log.splitlines()
                            if "registers" in ln or "error" in ln][:6]})
            if rc:
                fails += 1
            else:
                libs[tag] = so
        fails += globals()[name](libs)
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Time candidate tile configurations of the port's bf16 GEMM kernel.

    python3 scripts/torch_gemm_configs.py          # needs one CUDA card

Each configuration (block tile BM x BN, K step, warps along M and N,
pipeline stages) rewrites the 128 x 128 dispatch line of
``src/repro_torch/csrc/matmul.cu``, is built with the kernel's own nvcc
flags into ``build/repro_torch/configs/``, checked against the plain
version (2 bf16 ulps: rtol 2^-7, atol 1e-3 * max|C|) and timed (mean of 20
warm calls, CUDA events) at the op-level shapes of GPT-3 175B at TP 8
beside ``torch.matmul``.  It also reports how far a bf16-input,
fp32-output product lands from the fp32 plain product.  One JSON object a
line; exits 1 if a configuration disagrees with the plain version.
"""
import ctypes
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402

# BM, BN, BK, warps along M, warps along N, stages
CONFIGS = {
    "128x128k32s2": "128, 128, 32, 2, 4, 2",
    "128x128k32s3": "128, 128, 32, 2, 4, 3",
    "128x128k32s4": "128, 128, 32, 2, 4, 4",
    "128x128k64s3": "128, 128, 64, 2, 4, 3",
    "128x128k64s4": "128, 128, 64, 2, 4, 4",
    "128x256k32s4": "128, 256, 32, 2, 4, 4",
    "256x128k32s3": "256, 128, 32, 4, 2, 3",
    "128x256k64s3": "128, 256, 64, 2, 4, 3",
    "256x128k64s3": "256, 128, 64, 4, 2, 3",
    "64x64k32s3": "64, 64, 32, 2, 2, 3",
    "64x64k64s4": "64, 64, 64, 2, 2, 4",
    "64x128k64s4": "64, 128, 64, 2, 2, 4",
}
LINE = "return launch_bf16<128, 128, 32, 2, 4, 3, OutT>"
SHAPES = [("ag", m, 12288, 6144) for m in (64, 512, 1024, 2048, 4096, 8192)] \
    + [("rs", m, 6144, 12288) for m in (64, 512, 1024, 2048, 4096, 8192)]
CHECKS = [(777, 1000, 1032), (130, 40, 264), (8192, 12288, 6144),
          (64, 6144, 12288)]


def emit(obj):
    print(json.dumps(obj), flush=True)


def build_config(tag, src_text, out_dir):
    src = out_dir / f"matmul_{tag}.cu"
    src.write_text(src_text.replace(
        LINE, f"return launch_bf16<{CONFIGS[tag]}, OutT>"))
    lib = out_dir / f"matmul_{tag}.so"
    res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
                          str(src)], capture_output=True, text=True)
    return tag, lib, res.returncode, res.stdout + res.stderr


def load(lib_path):
    lib = ctypes.CDLL(str(lib_path))
    lib.matmul_fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    lib.matmul_fwd.restype = ctypes.c_int
    return lib


def run(lib, a, b):
    """bf16 in, bf16 out, through the rewritten tile (code 0)."""
    out = torch.empty((a.shape[0], b.shape[1]), dtype=torch.bfloat16,
                      device="cuda")
    err = lib.matmul_fwd(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                         a.shape[0], b.shape[1], a.shape[1], 1, 1, 0,
                         torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return out


def within_2_ulps(out, want):
    o, w = out.float(), want.float()
    ok = bool(((o - w).abs() <= 2.0 ** -7 * w.abs()
               + 1e-3 * w.abs().max()).all())
    return ok, (o - w).abs().max().item()


def time_ms(fn, iters=20, warmup=3):
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    src_text = (build.CSRC / "matmul.cu").read_text()
    if LINE not in src_text:
        raise SystemExit(f"dispatch line not found: {LINE}")
    out_dir = build.BUILD_DIR / "configs"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(os.cpu_count() or 4) as ex:
        built = list(ex.map(lambda t: build_config(t, src_text, out_dir),
                            CONFIGS))
    emit({"card": smi, "build_s": time.perf_counter() - t0})
    libs = {}
    for tag, lib, rc, log in built:
        report = [ln.split(": ")[-1].strip() for ln in log.splitlines()
                  if "registers" in ln or "spill" in ln or "error" in ln]
        emit({"config": tag, "nvcc_rc": rc, "ptxas": report})
        if rc == 0:
            libs[tag] = load(lib)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    fails = 0
    for m, k, n in CHECKS:
        a = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
        b = torch.randn((k, n), generator=gen, device="cuda").bfloat16()
        want = mm.matmul_ref(a, b)
        errs = {}
        for tag, lib in libs.items():
            ok, errs[tag] = within_2_ulps(run(lib, a, b), want)
            fails += not ok
        emit({"check": [m, k, n], "max_abs_err": errs})
    # bf16 inputs, fp32 output, against the fp32 plain product
    a = torch.randn((1024, 12288), generator=gen, device="cuda").bfloat16()
    b = torch.randn((12288, 6144), generator=gen, device="cuda").bfloat16()
    c = mm.matmul(a, b, out_dtype=torch.float32)
    want = mm.matmul_ref(a, b, torch.float32)
    emit({"bf16_in_fp32_out": [1024, 12288, 6144],
          "max_abs_err": (c - want).abs().max().item(),
          "max_abs_c": want.abs().max().item(),
          "fp32_rule_atol": 1e-5 * 12288 ** 0.5})
    del a, b, c, want

    for seam, m, k, n in SHAPES:
        a = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
        b = torch.randn((k, n), generator=gen, device="cuda").bfloat16()
        row = {"seam": seam, "m": m, "k": k, "n": n,
               "cublas_ms": time_ms(lambda: torch.matmul(a, b))}
        for tag, lib in libs.items():
            row[tag] = time_ms(lambda: run(lib, a, b))
        row["cublas_again_ms"] = time_ms(lambda: torch.matmul(a, b))
        emit(row)
        del a, b
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Time configurations of the port's bf16 GEMM tile (TMA + wgmma).

    python3 scripts/torch_gemm_configs.py          # needs one CUDA card

The bf16 kernels take two tiles (``csrc/gemm_tile.cuh``: ``LargeTile``
128 x 256 and ``SmallTile`` 64 x 64, tile codes 0 and 1 of
``kernels/matmul.py::TILES``).  Each configuration rewrites the shape and
ring depth (stages) of those two ``using`` lines in a copy of the sources,
is
built with the kernel's own nvcc flags into
``build/repro_torch/configs/<tag>/``, checked against the plain version at
every tile (2 bf16 ulps: rtol 2^-7, atol 1e-3 * max|C|) and timed (mean of
20 warm calls, CUDA events) at every tile at the op-level shapes of GPT-3
175B at TP 8 beside ``torch.matmul``.  The row of each shape also names
the tile ``plan_blocks`` picks.  One JSON object a line; exits 1 if a
configuration fails to build or disagrees with the plain version.
"""
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402

# tag -> (LargeTile, SmallTile) as (consumer warpgroups, BN, stages);
# "shipped" is the source
CONFIGS = {
    "shipped": None,
    "L2x256s4_S1x64s8": ((2, 256, 4), (1, 64, 8)),
    "L2x128s5_S1x64s4": ((2, 128, 5), (1, 64, 4)),
    "L2x256s2_S1x128s4": ((2, 256, 2), (1, 128, 4)),
}
USING = re.compile(r"using (LargeTile|SmallTile) = "
                   r"WgmmaTile<(\d+), (\d+), (\d+), (\d+), (\d+)>;")
NAMES = {mm.LARGE: "large", mm.SMALL: "small"}    # by tile code's shape
SHAPES = [("ag", m, 12288, 6144) for m in (64, 512, 1024, 2048, 4096, 8192)] \
    + [("rs", m, 6144, 12288) for m in (64, 512, 1024, 2048, 4096, 8192)]
CHECKS = [(777, 1000, 1032), (130, 40, 264), (8192, 12288, 6144),
          (64, 6144, 12288), (8, 2056, 776)]


def emit(obj):
    print(json.dumps(obj), flush=True)


def build_config(tag, out_dir):
    """Copy csrc/ with the three tiles' stages rewritten; build matmul."""
    src = out_dir / tag
    if src.exists():
        shutil.rmtree(src)
    shutil.copytree(build.CSRC, src)
    if CONFIGS[tag] is not None:
        header = src / "gemm_tile.cuh"
        text = header.read_text()
        order = ("LargeTile", "SmallTile")

        def shape(match):
            name, _, _, _, preg, creg = match.groups()
            wgm, bn, st = CONFIGS[tag][order.index(name)]
            return (f"using {name} = WgmmaTile<{wgm}, {bn}, {st}, {preg}, "
                    f"{creg}>;")
        header.write_text(USING.sub(shape, text))
    lib = src / "matmul.so"
    res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
                          str(src / "matmul.cu")], capture_output=True,
                         text=True)
    return tag, lib, res.returncode, res.stdout + res.stderr


def load(lib_path):
    lib = ctypes.CDLL(str(lib_path))
    lib.matmul_fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    lib.matmul_fwd.restype = ctypes.c_int
    return lib


def run(lib, a, b, tile):
    """bf16 in, bf16 out, through tile ``tile`` of ``lib`` (the shape the
    configuration gave that tile code)."""
    m, n = a.shape[0], b.shape[1]
    out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
    err = lib.matmul_fwd(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n,
                         a.shape[1], 1, 1, mm.TILES[tile],
                         *mm.walk_args(m, tile),
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
    text = (build.CSRC / "gemm_tile.cuh").read_text()
    if len(USING.findall(text)) != 2:
        raise SystemExit("the two tile lines were not found in "
                         "gemm_tile.cuh")
    out_dir = build.BUILD_DIR / "configs"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(CONFIGS)) as ex:
        built = list(ex.map(lambda t: build_config(t, out_dir), CONFIGS))
    emit({"card": smi, "build_s": time.perf_counter() - t0})
    libs = {}
    for tag, lib, rc, log in built:
        report = [ln.split(": ")[-1].strip() for ln in log.splitlines()
                  if "registers" in ln or "spill" in ln or "error" in ln]
        emit({"config": tag, "stages": CONFIGS[tag], "nvcc_rc": rc,
              "ptxas": report})
        if rc == 0:
            libs[tag] = load(lib)
    if len(libs) < len(CONFIGS):
        sys.exit(1)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    fails = 0
    for m, k, n in CHECKS:
        a = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
        b = torch.randn((k, n), generator=gen, device="cuda").bfloat16()
        want = mm.matmul_ref(a, b)
        errs = {}
        for tag, lib in libs.items():
            for tile in mm.TILES:
                ok, errs[f"{tag}/{NAMES[tile]}"] = within_2_ulps(
                    run(lib, a, b, tile), want)
                fails += not ok
        emit({"check": [m, k, n], "max_abs_err": errs})
        del a, b, want

    for seam, m, k, n in SHAPES:
        a = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
        b = torch.randn((k, n), generator=gen, device="cuda").bfloat16()
        row = {"seam": seam, "m": m, "k": k, "n": n,
               "plan_blocks": list(mm.plan_blocks(m, n)),
               "cublas_ms": time_ms(lambda: torch.matmul(a, b))}
        for tag, lib in libs.items():
            for tile in mm.TILES:
                row[f"{tag}/{NAMES[tile]}"] = time_ms(
                    lambda: run(lib, a, b, tile))
        row["cublas_again_ms"] = time_ms(lambda: torch.matmul(a, b))
        emit(row)
        del a, b
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()

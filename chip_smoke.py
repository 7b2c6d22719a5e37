#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a) and runs from
a checkout of this repository.  Phases, one JSON object per line each:

1. device  — the card, its power limit, torch and CUDA versions;
2. build   — every kernel built from ``src/repro_torch/csrc`` with nvcc, in
             parallel;
3. kernel  — each kernel (flash attention, MLA decode) against its plain
             PyTorch version on the card at the main paths' shapes and a
             few edge cases, with its time, the plain version's, the
             library call's and the bound;
4. kernel_lane — full-width minicpm_2b (seeded random weights): batched
             prefill through ``prefill_step`` with ``kernel_decode=True``
             (one flash-kernel launch per layer), checked against the same
             prefill with plain attention, then dense ``decode_step``s;
5. server_lane — ``repro_torch.launch.serve`` answering 8 requests through
             the paged ``Server`` at full width, and the same requests
             served one at a time: a smoke check of the runtime (short
             prompts), not a serving workload;
6. mla_lane — deepseek_v3_671b's first four layers at full width (three
             MLA + dense-FFN layers, one MLA + MoE layer; seeded random
             weights): batched prefill, then dense ``decode_step``s with
             ``kernel_decode=True`` (one MLA-decode launch per layer a step)
             teacher-forced against the same steps with plain attention,
             and one paged step through block tables;
7. mla_server_lane — the paged ``Server`` over the same four layers: 8
             requests served together, one at a time, and again on the
             same server (prefix reuse); a smoke check, no kernel runs;
8. matmul_kernel — the GEMM kernel against its plain version at the
             op-level shapes (GPT-3 175B at TP 8, bf16), a ragged shape and
             fp32, with its time, the plain version's, cuBLAS's
             (``torch.matmul``), the bound and the compiler's registers and
             spills;
9. op_level_lane — ``repro_torch.launch.op_level`` over its full sweep
             (12 GEMM_non-split shapes through the flux wrappers at one
             device, each beside ``torch.matmul``), then each row's result
             against the plain version once.

Host-clock times are medians of warm repeats; each profiled pass reports
the device's busy share of its own wall time.

It ends with the card's ``nvidia-smi`` name/power line, the kernels line
and ``{"ok": true, "device": {...}}``.  Any failed check raises: the exit
code is then nonzero and no result line is printed.  Without a CUDA card,
or outside a checkout (no ``src/repro_torch``), it fails the same way.
"""
import dataclasses
import json
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
# the kernel lane, kernel prefill vs plain prefill over 40 bf16 layers:
# relative L2 difference of the logits and of the last layer's K/V caches
# (the inputs of layer 40 carry 39 layers of bf16 rounding of attention
# outputs summed in another order)
LANE_RTOL = 5e-2
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
KERNEL_SOURCES = ("flash_attention", "mla_decode", "matmul")
L2_BYTES = 50 << 20                                     # H100 L2 cache
# GEMM kernel vs plain: bf16 outputs within 2 bf16 ulps (rtol 2^-7) plus
# atol 1e-3 * max|C| for values near 0; fp32 atol 1e-5 * sqrt(K), rtol 1e-5
# (summation order only; tests/test_kernels.py's matmul tolerance)
GEMM_BF16_RTOL = 2.0 ** -7
GEMM_BF16_ATOL_REL = 1e-3
GEMM_F32_TOL = 1e-5


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


def device_profile(torch, fn):
    """One call of ``fn`` under torch.profiler: its wall ms (profiled),
    summed device activity ms (kernels, copies, sets on the one stream),
    the device's busy share of that same call's wall time, the number of
    device activities, and the five largest kernels by time.  The wall
    time spans the call inside the profiler, after a discarded pass that
    starts the tracer; the profiler's per-op host cost stays in it, so the
    busy share is a lower bound."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):
        fn()
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    device_ms = sum(by_name.values()) / 1e3
    return {"profiled_wall_ms": wall, "device_ms": device_ms,
            "device_busy_share": device_ms / wall,
            "device_activities": len(dev),
            "top_kernels_ms": [[n[:80], t / 1e3] for n, t in top]}


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
    emit({"phase": "build", "seconds": build_s,
          "libraries": {n: os.path.relpath(p, ROOT) for n, p in libs.items()},
          "ptxas": ptxas})


def phase_kernel(torch):
    """Flash kernel vs its plain version; returns the main-path case."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    cases = [  # name, dtype, B, Hq, Hkv, Sq, Skv, D, causal, kv_offset
        ("minicpm_prefill", torch.bfloat16, 4, 36, 36, 1024, 1024, 64, True, 0),
        ("gqa_d128", torch.bfloat16, 4, 32, 8, 1024, 1024, 128, True, 0),
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
    """MLA-decode kernel vs its plain version; returns the lane's case."""
    import torch.nn.functional as F
    from repro_torch.kernels import mla_decode as md
    from repro_torch.models import layers

    h, r, dr = 128, 512, 64                  # deepseek_v3_671b
    scale = (128 + 64) ** -0.5               # (qk_nope + qk_rope) ** -0.5
    gen = torch.Generator(device="cuda")
    cases = [  # name, B, S, valid lengths, paged
        ("mla_lane_decode", 4, 1041, [257, 513, 778, 1025], False),
        ("long_cache", 8, 32768, [1000] + [32768] * 7, False),
        ("ragged_valid_1", 4, 777, [1, 777, 400, 600], False),
        ("paged_view", 4, 66 * 16, [257, 513, 778, 1025], True),
    ]
    results = {}
    for name, b, s, valid, paged in cases:
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
        out = md.mla_decode_attention(q_eff, q_rope, c, kr, vl, scale=scale)
        torch.cuda.synchronize()
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
        kernel_ms = time_ms_cold(torch, kern, 20)
        kernel_warm_ms = time_ms(torch, kern, 20)
        plain_ms = time_ms_cold(torch, lambda: md.mla_decode_attention_ref(
            q_eff, q_rope, c, kr, vl, scale), 5)
        library_ms = time_ms_cold(torch, lambda: F.scaled_dot_product_attention(
            q_l, k_l, v_l, **sdpa_kw), 10)
        bound_ms, bound_by, cuda_core_ms, flops, nbytes = mla_bound(
            q_eff, q_rope, c, kr, vl)
        res = {"phase": "kernel", "kernel": "mla_decode", "case": name,
               "shape": {"B": b, "H": h, "R": r, "Dr": dr, "S": s},
               "valid_len": valid, "paged": paged, "tol": MLA_TOL,
               "max_abs_err": err, "kernel_ms": kernel_ms,
               "kernel_warm_l2_ms": kernel_warm_ms, "plain_ms": plain_ms,
               "library_ms": library_ms,
               "library": "scaled_dot_product_attention",
               "library_backend": sdpa_backend(torch, q_l, k_l, v_l,
                                               **sdpa_kw),
               "library_max_abs_err": lib_err,
               "flops": flops, "bytes": nbytes,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "fp32_cuda_core_ms": cuda_core_ms,
               "bound_share": bound_ms / kernel_ms}
        emit(res)
        results[name] = res
        del q_eff, q_rope, c, kr, out, want, q_l, k_l, v_l
    torch.cuda.empty_cache()
    return results["mla_lane_decode"]


def phase_kernel_lane(torch):
    from repro_torch.configs.base import ParallelConfig, get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as M
    from repro_torch.models import serve as S
    from repro_torch.parallel.sharding import make_ctx

    cfg = get_config("minicpm_2b")
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
    del caches_p, logits_p, logits_k

    # dense decode from the kernel prefill's caches: glue them into s_max
    n_decode = 16
    caches = _dense_caches(torch, caches_k, s + n_decode + 1)
    del caches_k
    tok, tokens, step_samples = nxt, [nxt], []
    for step in range(n_decode):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, caches = S.decode_step(params, caches, tok, lengths + step,
                                    ctx_k, cfg)
        torch.cuda.synchronize()
        step_samples.append((time.perf_counter() - t0) * 1e3)
        tokens.append(tok)
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
    return launches


def phase_server_lane(torch):
    """A smoke check of the paged runtime at full width: 8 short requests,
    so its latencies are not those of a serving workload."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as launch_serve
    from repro_torch.runtime.server import Request, Server

    argv = ["--arch", "minicpm_2b", "--requests", "8", "--max-batch", "8",
            "--prompt-len", "40", "--max-new", "16", "--max-seq", "256",
            "--block-size", "16", "--prefill-chunk", "32"]
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


def _dense_caches(torch, caches, s_max):
    """Prefill caches [B, S, ...] glued into zero [B, s_max, ...] decode
    caches."""
    out = []
    for layer in caches:
        dense = {}
        for n, t in layer.items():
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
    check(launches == cfg.num_layers * n_decode,
          f"MLA-decode kernel launched {launches} times in {n_decode} decode "
          f"steps, expected {cfg.num_layers * n_decode} (one per layer a "
          "step)")
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
    decode_prof = device_profile(torch, one_step)
    out = torch.cat(plain_tokens, dim=1)
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          "decoded token out of [0, vocab)")
    emit({"phase": "mla_lane", "arch": cfg.name, "layers": cfg.num_layers,
          "params": n_params, "weights_gb": weights_gb, "init_s": init_s,
          "batch": 4, "lengths": lengths.tolist(), "s_max": s_max,
          "prefill_ms_median": prefill_ms,
          "prefill_ms_samples": prefill_samples,
          "decode_steps": n_decode, "mla_launches": launches,
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
          "tokens_row0": out[0].tolist()})
    del caches_k
    torch.cuda.empty_cache()
    return params, cfg, launches


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
        rows = op_level.main()
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


def main():
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: the port runs on the card")
    import repro_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = phase_device(torch)
    phase_build()
    flash_case = phase_kernel(torch)
    mla_case = phase_mla_kernel(torch)
    flash_launches = phase_kernel_lane(torch)
    phase_server_lane(torch)
    params, cfg, mla_launches = phase_mla_lane(torch)
    phase_mla_server_lane(torch, params, cfg)
    del params
    torch.cuda.empty_cache()
    matmul_case = phase_matmul_kernel(torch)
    matmul_launches, _ = phase_op_level_lane(torch)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
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
         "library_ms": flash_case["library_ms"]},
        {"name": "mla_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/mla_decode.cu",
         "replaces": "src/repro/kernels/mla_decode.py:28",
         "launches": mla_launches, "max_abs_err": mla_case["max_abs_err"],
         "ms": mla_case["kernel_ms"], "plain_ms": mla_case["plain_ms"],
         "bound_ms": mla_case["bound_ms"], "bound_by": mla_case["bound_by"],
         "library_ms": mla_case["library_ms"]},
        {"name": "matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/matmul.cu",
         "replaces": "src/repro/kernels/matmul.py:19",
         "launches": matmul_launches,
         "max_abs_err": matmul_case["max_abs_err"],
         "ms": matmul_case["kernel_ms"], "plain_ms": matmul_case["plain_ms"],
         "bound_ms": matmul_case["bound_ms"],
         "bound_by": matmul_case["bound_by"],
         "library_ms": matmul_case["library_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

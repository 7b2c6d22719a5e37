#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a) and runs from
a checkout of this repository.  Phases, one JSON object per line each:

1. device  — the card, its power limit, torch and CUDA versions;
2. build   — every kernel built from ``src/repro_torch/csrc`` with nvcc;
3. kernel  — each kernel against its plain PyTorch version on the card at
             the main path's shapes and a few edge cases, with its time,
             the plain version's, the library call's and the bound;
4. kernel_lane — full-width minicpm_2b (seeded random weights): batched
             prefill through ``prefill_step`` with ``kernel_decode=True``
             (one flash-kernel launch per layer), checked against the same
             prefill with plain attention, then dense ``decode_step``s;
5. server_lane — ``repro_torch.launch.serve`` answering 8 requests through
             the paged ``Server`` at full width, and the same requests
             served one at a time: a smoke check of the runtime (short
             prompts), not a serving workload.

Host-clock times are medians of warm repeats; each profiled pass reports
the device's busy share of its own wall time.

It ends with the card's ``nvidia-smi`` name/power line, the kernels line
and ``{"ok": true, "device": {...}}``.  Any failed check raises: the exit
code is then nonzero and no result line is printed.  Without a CUDA card,
or outside a checkout (no ``src/repro_torch``), it fails the same way.
"""
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
# warm repeats of each host-clock timing; the median is reported
REPEATS = 5
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12                                    # H100 SXM HBM3
KERNEL_SOURCES = ("flash_attention",)


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
    s_max = s + n_decode + 1
    caches = []
    for layer in caches_k:
        dense = {}
        for n, t in layer.items():
            d = torch.zeros((t.shape[0], s_max, *t.shape[2:]), dtype=t.dtype,
                            device=t.device)
            d[:, :s] = t
            dense[n] = d
        caches.append(dense)
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
    enqueue, whole = [], []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step()
        enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        whole.append((time.perf_counter() - t0) * 1e3)
    enqueue_ms = sorted(enqueue)[REPEATS // 2]
    step_ms = sorted(whole)[REPEATS // 2]
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
    main_case = phase_kernel(torch)
    launches = phase_kernel_lane(torch)
    phase_server_lane(torch)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:21",
        "launches": launches, "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["kernel_ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Production dry run (port of ``repro.launch.dryrun``): one rank's memory
for every (arch x shape x mesh) cell, from shapes alone.

For each cell of the port's ``ARCH_IDS`` x ``SHAPES`` (those
``shape_applicable`` keeps) x mesh (16x16, or 2x16x16 with
``--multi-pod``), under the reference's ``production_parallel`` preset,
it writes ``<out>/<mesh>_<arch>_<shape>.json`` holding:

  - one rank's argument bytes (``bytes_per_rank``): the parameters, and
    for a train cell their grads and the AdamW moments, for a decode cell
    the caches it reads, for a prefill cell the caches it writes, and the
    batch (tokens, labels, the step or position scalar);
  - each leaf's per-rank shape (``leaves``), cut as ``model.mesh_specs``
    splits it over the mesh axes, and for a train cell its moments' shape
    under ``adamw``'s ZeRO-1 / ZeRO-3 layout (``trainer.zero1_plan``);
  - ``params``, ``active_params``, ``model_flops_global`` (6·N·D for
    train, 2·N·D for prefill and decode, N the active count, as the
    reference's) and ``model_flops_per_device``.

Everything is sized on the ``meta`` device (``models.model``'s init
draws nothing there) or from shapes: no weight is allocated and no rank
runs.  The reference AOT-compiles each cell and keeps XLA's
``memory_analysis`` / ``cost_analysis`` and its jaxpr analyzer's FLOPs and
bytes; the port has no compiler to ask, so those have no counterpart
here: the analyzer's FLOPs wait for the port's static checkers (ROADMAP
queue 1 item 11).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minicpm_2b \\
      --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import (ARCH_IDS, SHAPES, ModelConfig,
                                      ParallelConfig, ShapeConfig,
                                      get_config, shape_applicable)
from repro_torch.launch.presets import production_parallel
from repro_torch.models import model as M
from repro_torch.models import serve as S
from repro_torch.optim import adamw
from repro_torch.runtime import trainer as T

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build",
                       "dryrun_torch")
# cells where fp32 moments cannot fit (the reference's EXPERIMENTS finding)
BF16_MOMENT_ARCHS = {"deepseek_v3_671b"}
# the axes the reference's dry run splits a cell's batch over
BATCH_AXES = ("pod", "data")
INT32 = 4


def input_specs(arch: str, shape_name: str, *, multi_pod: bool = False
                ) -> Tuple[ModelConfig, ShapeConfig, ParallelConfig,
                           Dict[str, int]]:
    """(cfg, shape, par, the mesh's axis sizes) of a cell: the
    reference's production mesh, ``{"data": 16, "model": 16}`` with
    ``"pod": 2`` in front under ``multi_pod``."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    par = production_parallel(cfg, multi_pod=multi_pod, kind=shape.kind)
    sizes = {"data": par.dp, "model": par.tp}
    if multi_pod:
        sizes = {"pod": par.pods, **sizes}
    return cfg, shape, par, sizes


def rank_model(cfg: ModelConfig, par: ParallelConfig) -> M.Model:
    """Mesh rank 0's copy (``model.mesh_shard``) on the meta device."""
    return M.mesh_shard(M.meta_model(cfg, par), cfg, par, {})


def _nbytes(shape, dtype: torch.dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def batch_axes(shape: ShapeConfig, par: ParallelConfig) -> Tuple[str, ...]:
    """The mesh axes a cell's batch splits over: pod and data, or none
    when the batch does not divide over them (the reference's tiny
    batches, replicated over data)."""
    n = par.pods * par.dp
    return BATCH_AXES if shape.global_batch % n == 0 else ()


def cell(arch: str, shape_name: str, *, multi_pod: bool) -> Dict[str, Any]:
    """One applicable cell's record (module docstring)."""
    cfg, shape, par, sizes = input_specs(arch, shape_name,
                                         multi_pod=multi_pod)
    rank = rank_model(cfg, par)
    specs = M.mesh_specs(cfg, par)
    leaves: Dict[str, Dict[str, Any]] = {}
    params_b = 0
    for n, t in rank.named_parameters():
        leaves[n] = {"shape": list(t.shape), "dtype": str(t.dtype)[6:],
                     "spec": [list(a) if a else None for a in specs[n]]}
        params_b += _nbytes(t.shape, t.dtype)
    out: Dict[str, Any] = {"params": params_b}
    axes = batch_axes(shape, par)
    b_loc = shape.global_batch // (par.pods * par.dp if axes else 1)
    s = shape.seq_len
    if shape.kind == "train":
        moment = (torch.bfloat16 if arch in BF16_MOMENT_ARCHS
                  else torch.float32)
        plan = T.zero1_plan(cfg, rank, par.dp, par)
        mom_b = 0
        for n, t in rank.named_parameters():
            z = plan[n]
            if z.holds(0):
                ms = adamw.moment_shape(t, z, par.dp)
                leaves[n]["moment_shape"] = list(ms)
                mom_b += 2 * _nbytes(ms, moment)
        out.update(grads=params_b, moments=mom_b + INT32,
                   batch=2 * b_loc * s * INT32 + INT32)
    else:
        caches = S.cache_specs(cfg, par, shape.global_batch, s,
                               dp_axes=axes)
        out["caches"] = sum(_nbytes(sp.shape, sp.dtype) for layer in caches
                            for sp in layer.values())
        out["batch"] = (b_loc * s * INT32 if shape.kind == "prefill"
                        else b_loc * INT32 + INT32)
    # the prefill's caches are its output; the others are arguments
    out["arguments"] = sum(v for k, v in out.items()
                           if not (k == "caches" and shape.kind == "prefill"))
    n_params = M.count_params_analytic(cfg)
    n_active = M.count_params_analytic(cfg, active_only=True)
    tokens = shape.global_batch * (s if shape.kind != "decode" else 1)
    flops = (6.0 if shape.kind == "train" else 2.0) * n_active * tokens
    chips = math.prod(sizes.values())
    return {"arch": arch, "shape": shape_name, "kind": shape.kind,
            "mesh": mesh_tag(multi_pod), "axis_sizes": sizes,
            "chips": chips,
            "parallel": dataclasses.asdict(par),
            "moment_dtype": ("bfloat16" if arch in BF16_MOMENT_ARCHS
                             else "float32"),
            "batch_rows_per_rank": b_loc,
            "bytes_per_rank": out, "leaves": leaves,
            "params": n_params, "active_params": n_active,
            "model_flops_global": flops,
            "model_flops_per_device": flops / chips}


def mesh_tag(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             out_dir: Optional[str] = None) -> Optional[str]:
    """Write one applicable cell's JSON; returns its path (None for a cell
    ``shape_applicable`` drops)."""
    if not shape_applicable(get_config(arch), SHAPES[shape_name]):
        return None
    out_dir = out_dir or OUT_DIR
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir,
                        f"{mesh_tag(multi_pod)}_{arch}_{shape_name}.json")
    with open(path, "w") as f:
        json.dump(cell(arch, shape_name, multi_pod=multi_pod), f, indent=1)
    return path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=OUT_DIR,
                    help="output directory (default build/dryrun_torch)")
    args = ap.parse_args(argv)
    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [
        args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    written = 0
    for mp in meshes:
        for a in archs:
            for s in shapes:
                tag = f"{'2x16x16' if mp else '16x16'} {a} {s}"
                path = run_cell(a, s, multi_pod=mp, out_dir=args.out)
                if path is None:
                    print(f"[skip] {tag}: {s} needs sub-quadratic "
                          "attention")
                    continue
                with open(path) as f:
                    b = json.load(f)["bytes_per_rank"]
                written += 1
                print(f"[ok]   {tag}: {b['arguments'] / 2**30:.2f} GiB of "
                      "arguments a rank")
    print(f"done; {written} cells written to {args.out}")


if __name__ == "__main__":
    main()

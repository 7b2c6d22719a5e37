"""The port's dry run (``repro_torch.launch.dryrun``) against the reference's
specs.

The applicability matrix over the port's ``ARCH_IDS`` is the reference's
``shape_applicable`` on the same archs, and the port's presets cover every
port arch.  For every port arch x shape x mesh cell, one rank's bytes
(parameters; grads and moments for train; caches for decode and prefill;
the batch) equal those computed from the reference's ``param_specs``,
``adamw.opt_state_specs`` and ``serve.cache_specs``: shapes from
``jax.eval_shape`` (in one subprocess, no devices needed) divided by the
axis sizes each spec names, ``{pod: 2, data: 16, model: 16}``, the
reference's dry-run rules for the batch split and the moment dtype
(``BF16_MOMENT_ARCHS``, read from its source: ``repro.launch.dryrun``
forces 512 devices when imported, so it is never imported).
"""
import ast
import json
import os

import numpy as np
import pytest

from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import get_config as ref_config
from repro.configs.base import shape_applicable as ref_applicable
from repro_torch.configs.base import (ARCH_IDS, SHAPES, get_config,
                                      shape_applicable)
from repro_torch.launch import dryrun as D
from repro_torch.launch.presets import production_parallel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [(a, s, mp) for mp in (False, True) for a in ARCH_IDS
         for s in SHAPES if shape_applicable(get_config(a), SHAPES[s])]

_REF = r"""
import json
import math
import jax, jax.numpy as jnp
from repro.configs.base import SHAPES, get_config
from repro.launch.presets import production_parallel
from repro.models import model as M
from repro.models import serve as S
from repro.optim import adamw

BF16 = %(bf16)r
out = {}
evals = {}


def per_device(sds, spec, sizes):
    n = math.prod(sds.shape) * jnp.dtype(sds.dtype).itemsize
    for axes in tuple(spec):
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            if a is not None:
                n //= sizes[a]
    return n


def total(tree, specs, sizes):
    from jax.sharding import PartitionSpec as P
    leaves = jax.tree.leaves(jax.tree.map(
        lambda s, p: per_device(s, p, sizes), tree, specs,
        is_leaf=lambda x: isinstance(x, P)))
    return int(sum(leaves))


for arch, shape_name, mp in %(cells)r:
    cfg, shape = get_config(arch), SHAPES[shape_name]
    par = production_parallel(cfg, multi_pod=mp, kind=shape.kind)
    sizes = {"pod": par.pods, "data": par.dp, "model": par.tp}
    key = (arch, par.tp)
    if key not in evals:
        evals[key] = jax.eval_shape(
            lambda: M.init_model(jax.random.PRNGKey(0), cfg, par))
    params = evals[key]
    pspecs = M.param_specs(cfg, par, params)
    row = {"params": total(params, pspecs, sizes)}
    b, s = shape.global_batch, shape.seq_len
    dp_total = par.dp * par.pods
    b_loc = b // dp_total if b %% dp_total == 0 else b
    if shape.kind == "train":
        dt = "bfloat16" if arch in BF16 else "float32"
        opt = jax.eval_shape(lambda p: adamw.init_opt_state(p, dt), params)
        ospecs = adamw.opt_state_specs(pspecs, params, par.dp, par.tp)
        row["grads"] = row["params"]
        row["moments"] = (total(opt["mu"], ospecs["mu"], sizes)
                          + total(opt["nu"], ospecs["nu"], sizes) + 4)
        row["batch"] = 2 * b_loc * s * 4 + 4
    else:
        # the reference dry run's batch axes: those of its mesh
        dpax = ("pod", "data") if mp else ("data",)
        dpax = dpax if b %% dp_total == 0 else ()
        csds, cspec = S.cache_specs(cfg, par, b, s, dp_axes=dpax)
        row["caches"] = total(csds, cspec, sizes)
        row["batch"] = b_loc * s * 4 if shape.kind == "prefill" else b_loc * 4 + 4
    out["|".join([arch, shape_name, str(mp)])] = row
print("REF_JSON" + json.dumps(out))
"""


def _ref_bf16_archs():
    """``BF16_MOMENT_ARCHS`` from the reference dry run's source."""
    with open(os.path.join(ROOT, "src", "repro", "launch", "dryrun.py")) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", "") == "BF16_MOMENT_ARCHS"):
            return ast.literal_eval(node.value)
    raise AssertionError("no BF16_MOMENT_ARCHS in the reference dry run")


@pytest.fixture(scope="module")
def ref(subproc):
    code = _REF % {"cells": CELLS, "bf16": sorted(_ref_bf16_archs())}
    text = subproc(code, n_devices=1)
    return json.loads(text.split("REF_JSON", 1)[1])


def test_applicability_matrix_equals_reference():
    for a in ARCH_IDS:
        for name, shape in SHAPES.items():
            want = REF_SHAPES[name]
            assert (shape.name, shape.seq_len, shape.global_batch,
                    shape.kind) == (want.name, want.seq_len,
                                    want.global_batch, want.kind)
            assert shape_applicable(get_config(a), shape) == ref_applicable(
                ref_config(a), REF_SHAPES[name]), (a, name)
    assert set(SHAPES) == set(REF_SHAPES)
    # the cells the reference's matrix runs over the port's archs, on both
    # meshes: long_500k only for the sub-quadratic ones (Jamba)
    assert len(CELLS) == 2 * sum(
        ref_applicable(ref_config(a), REF_SHAPES[name])
        for a in ARCH_IDS for name in REF_SHAPES)
    assert ("jamba_v01_52b", "long_500k", False) in CELLS


def test_presets_cover_every_port_arch():
    for a in ARCH_IDS:
        cfg = get_config(a)
        for kind in ("train", "prefill", "decode"):
            for mp in (False, True):
                par = production_parallel(cfg, multi_pod=mp, kind=kind)
                assert par.tp == 16 and par.dp == 16
                assert par.pods == (2 if mp else 1)
                if cfg.moe and cfg.moe.num_experts > 16:
                    assert par.ep_over_dp
                if mp and kind == "train":
                    assert par.grad_compress
    assert D.BF16_MOMENT_ARCHS == _ref_bf16_archs()


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS)
def test_cell_bytes_equal_reference_specs(ref, arch, shape, multi_pod):
    got = D.cell(arch, shape, multi_pod=multi_pod)
    want = ref["|".join([arch, shape, str(multi_pod)])]
    b = got["bytes_per_rank"]
    assert {k: b[k] for k in want} == want
    assert got["chips"] == (512 if multi_pod else 256)
    per = got["model_flops_per_device"] * got["chips"]
    assert np.isclose(per, got["model_flops_global"])


def test_cell_json_keys(tmp_path):
    path = D.run_cell("llama4_scout_17b_a16e", "decode_32k", multi_pod=False,
                      out_dir=str(tmp_path))
    assert os.path.basename(path) == (
        "pod16x16_llama4_scout_17b_a16e_decode_32k.json")
    with open(path) as f:
        rec = json.load(f)
    assert {"bytes_per_rank", "leaves", "params", "active_params",
            "model_flops_global", "model_flops_per_device"} <= set(rec)
    assert {"params", "caches", "batch", "arguments"} <= set(
        rec["bytes_per_rank"])
    leaf = rec["leaves"]["layers.0.ffn.w1"]
    # 16 experts over "model" (16 ranks): one expert a rank, whole
    assert leaf["shape"] == [1, 5120, 8192] and leaf["spec"][0] == ["model"]
    assert D.run_cell("minicpm_2b", "long_500k", multi_pod=False,
                      out_dir=str(tmp_path)) is None
    # train: the embedding's rows over "model", its moments' over "data"
    train = D.cell("minicpm_2b", "train_4k", multi_pod=False)
    emb = train["leaves"]["embed"]
    assert emb["shape"] == [7680, 2304] and emb["moment_shape"] == [480, 2304]

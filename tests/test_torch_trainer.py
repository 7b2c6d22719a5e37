"""Three steps of the port's trainer against the reference's ``Trainer``.

The reference's ``runtime.trainer.Trainer`` runs once for the file, in
one subprocess with 4 forced host devices: minicpm_2b (wsd schedule) at
tp=1 in xla, at tp=4 in decomposed, and at tp=4 in xla in the replicated
("hidden") layout, and codeqwen15_7b (cosine; QKV bias) at tp=4 in xla,
each from fp32 weights drawn by its ``init_model``
with fp32 moments, 3 steps of ``batch_at``'s stream (batch 4 x 64),
warmup 1, base lr 1e-3.  The same weights cross to the port
(``convert``), whose ``Trainer`` runs the same 3 steps on the CPU (at
tp=4 as the 4 ranks of a ``dist.RankGroup``; the hidden layout in xla and
in flux against the reference's hidden run), and also minicpm_2b at
tp=4 in flux, held against the reference's decomposed run: the
reference's interpreted flux kernels do not run on its trainer's 2-D
("data", "model") mesh here (``dma_start`` takes one named axis in
interpret mode), and decomposed computes the same function.

Tolerances (fp32): each step's loss within 1e-5 relative; every leaf of
the final weights within relative L2 1e-5, and every leaf's change over
the 3 steps (final - initial, what AdamW wrote) within relative L2 1e-3
(Adam divides by sqrt(nu): a grad element near zero turns an fp32
rounding difference into a larger relative difference of its update).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.base import ParallelConfig, get_smoke_config
from repro_torch.models import model as TM
from repro_torch.runtime import trainer as TT

TP = 4
STEPS, BATCH, SEQ, LR = 3, 4, 64, 1e-3
# the reference's runs: (arch, tp, mode, schedule, scatter_axis)
RUNS = [("minicpm_2b", 1, "xla", "wsd", "auto"),
        ("minicpm_2b", 4, "decomposed", "wsd", "auto"),
        ("codeqwen15_7b", 4, "xla", "cosine", "auto"),
        ("minicpm_2b", 4, "xla", "wsd", "hidden")]
# the port's runs: (reference run, the port's mode)
PORT_RUNS = [(0, "xla"), (1, "decomposed"), (1, "flux"), (2, "xla"),
             (3, "xla"), (3, "flux")]
LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-5
UPDATE_RTOL = 1e-3

_REF = r"""
import dataclasses
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs.base import get_smoke_config, ParallelConfig
from repro.models import model as M
from repro.optim import adamw
from repro.runtime import trainer as T

out = {}


def save(tree, prefix):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in flat:
        key = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                       for q in path)
        out[prefix + key] = np.asarray(leaf, np.float32)


for i, (arch, tp, mode, schedule, axis) in enumerate(%(runs)r):
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    par = ParallelConfig(tp=tp, dp=1, overlap_mode=mode, scatter_axis=axis)
    mesh = Mesh(np.array(jax.devices()[:tp]).reshape(1, tp),
                ("data", "model"))
    tc = T.TrainConfig(total_steps=%(steps)d, warmup_steps=1,
                       base_lr=%(lr)r, schedule=schedule, log_every=100)
    tr = T.Trainer(cfg, par, mesh, tc)
    tr.data_cfg = dataclasses.replace(tr.data_cfg, seq_len=%(seq)d,
                                      global_batch=%(batch)d)
    params = M.init_model(jax.random.PRNGKey(0), cfg, par, dtype=jnp.float32)
    if cfg.qkv_bias:   # the reference inits the bias to zero
        mix = params["periods"][0]["mixer"]
        rng = np.random.default_rng(1)
        mix["bqkv"] = jnp.asarray(
            0.1 * rng.standard_normal(mix["bqkv"].shape), jnp.float32)
    save(params, f"{i}/init/")
    specs = M.param_specs(cfg, par, params)
    put = lambda tree: jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), tree, specs,
        is_leaf=lambda x: isinstance(x, P))
    params = put(params)
    opt = adamw.init_opt_state(params)
    opt = {"mu": put(opt["mu"]), "nu": put(opt["nu"]), "count": opt["count"]}
    with mesh:
        params, opt, hist = tr.train(params, opt, resume=False)
    save(params, f"{i}/final/")
    out[f"{i}/losses"] = np.array([h["loss"] for h in hist], np.float32)
np.savez(OUT, **out)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory, subproc):
    d = tmp_path_factory.mktemp("trainer")
    code = (_REF % {"runs": RUNS, "steps": STEPS, "lr": LR, "seq": SEQ,
                    "batch": BATCH}).replace(
        "OUT,", repr(str(d / "out.npz")) + ",")
    assert "REF_OK" in subproc(code, n_devices=TP)
    return dict(np.load(d / "out.npz"))


def _tree(flat, prefix):
    """The reference's nested tree from "a/0/b"-keyed numpy leaves."""
    root = {}
    for key, leaf in flat.items():
        if not key.startswith(prefix):
            continue
        parts = key[len(prefix):].split("/")
        node = root
        for i, p in enumerate(parts[:-1]):
            if isinstance(node, list):
                p = int(p)
                while len(node) <= p:
                    node.append([] if parts[i + 1].isdigit() else {})
                node = node[p]
            else:
                node = node.setdefault(
                    p, [] if parts[i + 1].isdigit() else {})
        node[parts[-1]] = leaf
    return root


def _flat(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("i,mode", PORT_RUNS,
                         ids=[f"{RUNS[i][0]}-tp{RUNS[i][1]}-{m}"
                              + ("-hidden" if RUNS[i][4] == "hidden" else "")
                              for i, m in PORT_RUNS])
def test_three_steps_match_reference_trainer(ref, i, mode):
    arch, tp, _, schedule, axis = RUNS[i]
    cfg = dataclasses.replace(get_smoke_config(arch),
                              compute_dtype="float32")
    par = ParallelConfig(tp=tp, overlap_mode=mode, scatter_axis=axis)
    tc = TT.TrainConfig(total_steps=STEPS, warmup_steps=1, base_lr=LR,
                        schedule=schedule, log_every=100)
    tr = TT.Trainer(cfg, par, tc, device="cpu", dtype=torch.float32)
    tr.data_cfg = dataclasses.replace(tr.data_cfg, seq_len=SEQ,
                                      global_batch=BATCH)
    init = _tree(ref, f"{i}/init/")
    params = convert.rank_params_from_jax(init, cfg, tp, dtype=torch.float32,
                                          device="cpu", trainable=True)
    params, _, hist = tr.train(params, [tr.init_opt(p) for p in params])
    want = ref[f"{i}/losses"]
    got = np.array([h["loss"] for h in hist])
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)
    final = TM.gather_rank_leaves(
        [dict(p.named_parameters()) for p in params], cfg, params[0])
    got = _flat(convert.to_jax_tree(final, cfg))
    start = _flat(init)
    for key, w in _flat(_tree(ref, f"{i}/final/")).items():
        assert _rel(got[key], w) <= PARAM_RTOL, key
        assert _rel(got[key] - start[key], w - start[key]) <= UPDATE_RTOL, \
            key

"""The paper's models in the port: configs, the analytic parameter count, the
model-level figures, and prefill and training at tp=1 and tp=4 against the
reference.

* Configs: ``repro_torch.configs`` holds gpt3_175b and llama2_70b (the
  paper's §5 models), phi4_mini_38b (a 200064 vocabulary) and qwen15_110b
  (QKV bias); each CONFIG and SMOKE_CONFIG equals the reference's field for
  field, and the reference's fields the port lacks are at their defaults.
* ``count_params_analytic`` (and ``active_only=True``) equals the
  reference's for every config the port has, full size and smoke, at tp=1
  and, for the dense archs, with tp=4's padding: exact integers.  The full
  sizes are built on the meta device; nothing allocates 232 B parameters.
* ``launch.model_level``: given the reference's TPU terms as an
  ``ect.Hardware`` it prints ``benchmarks/model_level.py``'s rows, the same
  names in the same order, each value within relative 1e-9 of the
  reference's unrounded one; priced on ``ect.H100_SXM`` the rows are
  well-formed and flux is no slower than xla in any phase.
* On the four new SMOKE_CONFIGs with fp32 compute and fp32 params (the
  reference's, drawn at each tp, crossing as numpy): the reference's
  ``prefill_step`` and ``jax.value_and_grad(forward_loss)`` at tp=1 and
  tp=4 (one subprocess for the file, 4 forced host devices, shard_map,
  prefill in decomposed mode and the loss in xla mode: its values do not
  depend on the mode) against the port at tp=1 and at tp=4 (4 ranks of a
  ``dist.RankGroup`` on the CPU) in xla and flux: next tokens equal on
  every rank; last-position logits (the ranks' vocab shards concatenated)
  within relative L2 1e-5 (fp32 sums in another order); the loss within
  relative 1e-5 and every leaf's grad on every rank, before and after the
  trainer's sum of the model-replicated leaves, within relative L2 1e-4.

The tp=8 reductions (one KV head a rank) are tests/test_torch_paper_tp8.py.
"""
import contextlib
import dataclasses
import importlib.util
import io
import os

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import base as TB
from repro_torch.core import ect as tect
from repro_torch.dist import RankGroup
from repro_torch.launch import model_level as tml
from repro_torch.models import model as TM
from repro_torch.models import serve as TS
from repro_torch.parallel.sharding import make_ctx
from repro_torch.runtime import trainer as TT

NEW_ARCHS = ["gpt3_175b", "llama2_70b", "phi4_mini_38b", "qwen15_110b"]
ALL_ARCHS = TB.ARCH_IDS + TB.PAPER_ARCH_IDS
DENSE_ARCHS = [a for a in ALL_ARCHS if a != "deepseek_v3_671b"]
MODES = ["xla", "flux"]
TP = 4
B, S = 2, 64
LENGTHS = [40, 64]
LOGIT_RTOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
MODEL_LEVEL_REL = 1e-9
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# configs and the parameter count
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["CONFIG", "SMOKE_CONFIG"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_equals_reference(arch, which):
    import importlib
    ref_cfg = getattr(importlib.import_module(f"repro.configs.{arch}"),
                      which)
    cfg = getattr(importlib.import_module(f"repro_torch.configs.{arch}"),
                  which)
    got, want = dataclasses.asdict(cfg), dataclasses.asdict(ref_cfg)
    assert set(got) <= set(want)
    assert got == {k: want[k] for k in got}
    defaults = {f.name: f.default for f in dataclasses.fields(ref_cfg)
                if f.name not in got}
    assert {k: want[k] for k in defaults} == defaults
    getter = TB.get_config if which == "CONFIG" else TB.get_smoke_config
    assert getter(arch) == cfg


def test_registry_lists_resolve():
    """The port's own lists: every id resolves in both packages, the paper's
    models are there, and nothing is listed twice."""
    from repro.configs import base as RB
    ids = TB.ARCH_IDS + TB.PAPER_ARCH_IDS
    assert len(set(ids)) == len(ids)
    assert set(TB.PAPER_ARCH_IDS) == {"gpt3_175b", "llama2_70b"}
    assert set(TB.ARCH_IDS) <= set(RB.ARCH_IDS)
    for arch in ids:
        assert TB.get_config(arch).name == RB.get_config(arch).name == arch


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_count_equals_reference(arch, size):
    from repro.configs import base as RB
    from repro.models.model import count_params_analytic as ref_count
    get_r = RB.get_config if size == "full" else RB.get_smoke_config
    get_t = TB.get_config if size == "full" else TB.get_smoke_config
    for active in (False, True):
        want = ref_count(get_r(arch), active_only=active)
        got = TM.count_params_analytic(get_t(arch), active_only=active)
        assert isinstance(got, int) and got == want, (arch, active)
    cfg = get_t(arch)
    assert cfg.param_count() == ref_count(get_r(arch))
    assert cfg.active_param_count() == ref_count(get_r(arch),
                                                 active_only=True)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_param_count_tp4_padding_equals_reference(arch):
    """With ``par`` at tp=4 the count holds tp=4's padding (vocab, heads,
    d_ff, replicated KV heads), as the reference's does; on the smoke
    config it is the numel of the port's own tp=4 init."""
    from repro.configs import base as RB
    from repro.models.model import count_params_analytic as ref_count
    for cfg, rcfg in ((TB.get_config(arch), RB.get_config(arch)),
                      (TB.get_smoke_config(arch),
                       RB.get_smoke_config(arch))):
        got = TM.count_params_analytic(cfg, par=TB.ParallelConfig(tp=TP))
        assert got == ref_count(rcfg, par=RB.ParallelConfig(tp=TP))
    smoke = TM.init_model(cfg, TB.ParallelConfig(tp=TP, fuse_w13=True),
                          dtype=torch.float32, device="cpu")
    assert got == sum(p.numel() for p in smoke.parameters())


# ---------------------------------------------------------------------------
# the model-level figures
# ---------------------------------------------------------------------------
def _v5e():
    from repro.core import ect as rect
    return tect.Hardware(peak_flops=rect.PEAK_FLOPS_BF16, hbm_bw=rect.HBM_BW,
                         link_bw=rect.ICI_BW)


def _reference_model_level():
    spec = importlib.util.spec_from_file_location(
        "_ref_model_level", os.path.join(REPO, "benchmarks",
                                         "model_level.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _csv(lines):
    """CSV rows after the header, the port's ``#`` line skipped."""
    rows = [ln for ln in lines if not ln.startswith("#")]
    assert rows[0] == "name,us_per_call,derived"
    return [ln.split(",") for ln in rows[1:]]


def test_model_level_matches_reference_with_its_terms():
    ref = _reference_model_level()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref.main()
    want = _csv(buf.getvalue().strip().splitlines())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got_rows = tml.main(hw=_v5e())
    lines = buf.getvalue().strip().splitlines()
    assert lines[0].startswith("#") and "analytic" in lines[0]
    got = _csv(lines)
    assert [r[0] for r in got] == [r[0] for r in want]
    assert len(got_rows) == len(want) == 32
    for g, w in zip(got, want):
        assert float(g[1]) == pytest.approx(float(w[1]), rel=MODEL_LEVEL_REL,
                                            abs=0.5), g[0]
        assert g[2] == w[2], g[0]
    # unrounded, against the reference's layer sums
    from repro.configs.base import get_config as ref_get
    for r in got_rows:
        _, arch_a, arch_b, phase, mode = r["name"].split("_")
        arch = f"{arch_a}_{arch_b}"
        ph = ref.PHASES[phase]
        cfg = ref_get(arch)
        t = ref.layer_seam_times(cfg, ph["m_tokens"],
                                 "xla" if mode == "commfrac" else mode)
        want_us = t["overall"] * ph["passes"] * cfg.num_layers * 1e6
        assert r["us"] == pytest.approx(want_us, rel=MODEL_LEVEL_REL, abs=0)
        tt = tml.layer_seam_times(TB.get_config(arch), ph["m_tokens"],
                                  "xla" if mode == "commfrac" else mode,
                                  hw=_v5e())
        for key in t:
            assert tt[key] == pytest.approx(t[key], rel=MODEL_LEVEL_REL,
                                            abs=0), (r["name"], key)


def test_model_level_on_the_h100():
    """Priced on ``ect.H100_SXM`` (the CLI's prices): the reference's row
    set, positive times, the xla rows' speedup 1, flux no slower than xla
    in any phase, and the first line naming the hardware."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = tml.main(hw=tect.H100_SXM)
    lines = buf.getvalue().strip().splitlines()
    assert "H100 SXM" in lines[0] and "not measured" in lines[0]
    names = [r["name"] for r in out]
    assert names == [r[0] for r in _csv(lines)]
    assert len(names) == 2 * 4 * 4
    by = {r["name"]: r for r in out}
    for arch in tml.ARCHS:
        for phase in tml.PHASES:
            pre = f"modellevel_{arch}_{phase}_"
            xla, flux = by[pre + "xla"], by[pre + "flux"]
            assert xla["derived"] == 1.0
            assert all(by[pre + m]["us"] > 0 for m in tml.MODES)
            assert flux["us"] <= xla["us"], pre
            assert 0 < by[pre + "commfrac"]["derived"] < 100


def test_model_level_hardware_changes_every_price():
    v5e = {r["name"]: r["us"] for r in tml.rows(hw=_v5e())}
    h100 = {r["name"]: r["us"] for r in tml.rows(hw=tect.H100_SXM)}
    assert v5e.keys() == h100.keys()
    assert all(h100[n] < v5e[n] for n in v5e)


# ---------------------------------------------------------------------------
# prefill and step 0 at tp=1 and tp=4 against the reference
# ---------------------------------------------------------------------------
_REF = r"""
import dataclasses, functools
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.configs.base import get_smoke_config, ParallelConfig
from repro.models import model as M, serve as S
from repro.optim import adamw
from repro.parallel.sharding import TPContext

inp = dict(np.load(IN))
out = {}
seen = {}
_argmax = S.vocab_parallel_argmax


def _capture(logits_loc, *a, **k):
    seen["logits"] = logits_loc
    return _argmax(logits_loc, *a, **k)


S.vocab_parallel_argmax = _capture


def save(tree, prefix):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in flat:
        key = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                       for q in path)
        out[prefix + key] = np.asarray(leaf, np.float32)


toks, lengths = jnp.asarray(inp["tokens"]), jnp.asarray(inp["lengths"])
ltoks, labels = jnp.asarray(inp["ltokens"]), jnp.asarray(inp["labels"])
for arch in %(archs)r:
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    for tp in (1, 4):
        par = ParallelConfig(tp=tp, dp=1)
        mesh = Mesh(np.array(jax.devices()[:tp]).reshape(1, tp),
                    ("data", "model"))
        params = M.init_model(jax.random.PRNGKey(0), cfg, par,
                              dtype=jnp.float32)
        if cfg.qkv_bias:   # the reference inits the bias to zero
            mix = params["periods"][0]["mixer"]
            rng = np.random.default_rng(1)
            mix["bqkv"] = jnp.asarray(
                0.1 * rng.standard_normal(mix["bqkv"].shape), jnp.float32)
        specs = M.param_specs(cfg, par, params)
        pre = f"{arch}/{tp}/"

        @jax.jit
        @functools.partial(shard_map, mesh=mesh, in_specs=(specs, P(), P()),
                           out_specs=(P(), P(None, "model")),
                           check_vma=False)
        def prefill(p, t, l):
            nxt, _ = S.prefill_step(p, {"tokens": t},
                                    TPContext(axis="model",
                                              mode="decomposed"),
                                    cfg, par, l)
            return nxt, seen.pop("logits")

        nxt, logits = prefill(params, toks, lengths)
        out[pre + "next"] = np.asarray(nxt)
        out[pre + "logits"] = np.asarray(logits, np.float32)

        rep = adamw.model_replicated_tree(specs)
        ranked = jax.tree.map(lambda _: P("model"), params)
        ctx = TPContext(axis="model", mode="xla")

        def body(p, t, l):
            loss, g = jax.value_and_grad(lambda q: M.forward_loss(
                q, {"tokens": t, "labels": l}, ctx, cfg, par))(p)
            gs = jax.tree.map(lambda a, r: jax.lax.psum(a, "model")
                              if r else a, g, rep)
            return (loss, jax.tree.map(lambda a: a[None], g),
                    jax.tree.map(lambda a: a[None], gs))

        f = jax.jit(functools.partial(
            shard_map, mesh=mesh, in_specs=(specs, P(), P()),
            out_specs=(P(), ranked, ranked), check_vma=False)(body))
        loss, g, gs = f(params, ltoks, labels)
        out[pre + "loss"] = np.asarray(loss)
        save(params, pre + "params/")
        save(g, pre + "grads/")
        save(gs, pre + "gradsum/")
np.savez(OUT, **out)
print("REF_OK")
"""


def _inputs():
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 512, (B, S)).astype(np.int32)
    for b, n in enumerate(LENGTHS):
        toks[b, n:] = 0                      # right padding
    ltoks = rng.integers(0, 512, (B, S)).astype(np.int32)
    labels = rng.integers(0, 512, (B, S)).astype(np.int32)
    labels[1, -5:] = -1                      # masked out of the mean
    return {"tokens": toks, "lengths": np.array(LENGTHS, np.int32),
            "ltokens": ltoks, "labels": labels}


@pytest.fixture(scope="module")
def ref(tmp_path_factory, subproc):
    d = tmp_path_factory.mktemp("paper_models")
    np.savez(d / "in.npz", **_inputs())
    code = (_REF % {"archs": NEW_ARCHS}).replace(
        "IN)", repr(str(d / "in.npz")) + ")").replace(
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


def _want(ref, prefix):
    return {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)}


def _cfg(arch):
    return dataclasses.replace(TB.get_smoke_config(arch),
                               compute_dtype="float32")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _params(ref, arch, tp, trainable=False):
    cfg = _cfg(arch)
    tree = _tree(ref, f"{arch}/{tp}/params/")
    if tp == 1:
        return cfg, [convert.params_from_jax(tree, cfg, dtype=torch.float32,
                                             device="cpu",
                                             trainable=trainable)]
    return cfg, convert.rank_params_from_jax(tree, cfg, tp,
                                             dtype=torch.float32,
                                             device="cpu",
                                             trainable=trainable)


def _spmd(tp, fn, ranks):
    """``fn(p, group)`` on every rank (tp=1: on the caller's thread)."""
    if tp == 1:
        return [fn(ranks[0], None)]
    group = RankGroup(tp, "cpu", timeout_s=60)
    return group.spmd(lambda p: fn(p, group), [(p,) for p in ranks])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tp", [1, TP])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_matches_reference(ref, arch, tp, mode):
    cfg, ranks = _params(ref, arch, tp)
    inp = _inputs()
    toks = torch.from_numpy(inp["tokens"])
    lengths = torch.from_numpy(inp["lengths"]).long()

    def run(p, group):
        ctx = make_ctx(TB.ParallelConfig(tp=tp, overlap_mode=mode,
                                         kernel_decode=mode == "flux"),
                       group)
        nxt, _ = TS.prefill_step(p, {"tokens": toks}, ctx, cfg, lengths)
        logits, _ = TS.prefill_logits(p, {"tokens": toks}, ctx, cfg,
                                      lengths)
        return nxt, logits

    outs = _spmd(tp, run, ranks)
    want = ref[f"{arch}/{tp}/next"].reshape(-1)
    for nxt, _ in outs:
        np.testing.assert_array_equal(nxt.numpy().reshape(-1), want)
    got = torch.cat([lg for _, lg in outs], dim=-1).numpy()
    assert got.shape == ref[f"{arch}/{tp}/logits"].shape
    assert _rel(got, ref[f"{arch}/{tp}/logits"]) <= LOGIT_RTOL


def _assert_grads(got_named, cfg, want_flat, rank):
    got = _flat(convert.to_jax_tree(got_named, cfg))
    assert sorted(got) == sorted(want_flat)
    for key, want in want_flat.items():
        assert _rel(got[key], want[rank]) <= GRAD_RTOL, (key, rank)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tp", [1, TP])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_train_step0_matches_reference(ref, arch, tp, mode):
    """Loss and every leaf's grad on every rank, before and after the sum
    of the model-replicated leaves."""
    cfg, ranks = _params(ref, arch, tp, trainable=True)
    inp = _inputs()
    batch = {"tokens": torch.from_numpy(inp["ltokens"]),
             "labels": torch.from_numpy(inp["labels"])}
    par = TB.ParallelConfig(tp=tp, overlap_mode=mode)

    def run(p, group):
        loss, grads = TT.loss_and_grads(p, batch,
                                        TT.make_ctx(cfg, par, group), cfg,
                                        par)
        done = (grads if group is None else TT.complete_grads(
            grads, TM.replicated_leaves(cfg, p), group))
        return loss, grads, done

    outs = _spmd(tp, run, ranks)
    want = float(ref[f"{arch}/{tp}/loss"])
    for r, (loss, grads, done) in enumerate(outs):
        assert abs(loss.item() - want) <= LOSS_RTOL * abs(want)
        _assert_grads(grads, cfg, _want(ref, f"{arch}/{tp}/grads/"), r)
        _assert_grads(done, cfg, _want(ref, f"{arch}/{tp}/gradsum/"), r)

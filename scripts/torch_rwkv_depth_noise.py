"""How far two ways of computing the same numbers drift apart with depth
in a random rwkv6_3b (full width, all 32 layers, seed 0), in bf16 and in
fp32 on the same draw.

The batch is ``chip_smoke.py``'s rwkv lane's: 4 x 1024 tokens from seed 13,
lengths 1024 / 777 / 512 / 256.  For each dtype, each row's prefill alone
at its own length against the batched prefill: the worst row's relative
L2 of every layer's wkv ``state`` and token-shift rows (``last``,
``ffn.last``), and each row's logits.  The GEMMs run at other shapes, so
their sums round in another order; the model amplifies the difference
layer by layer.  Prints one line a dtype and leaf, and writes the
readings as JSON to OUT (default ``build/rwkv_depth_noise.json``).

  python3 scripts/torch_rwkv_depth_noise.py [OUT]   # one H100
"""
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.configs.base import ParallelConfig, get_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import serve as S  # noqa: E402
from repro_torch.parallel.sharding import make_ctx  # noqa: E402

LENGTHS = [1024, 777, 512, 256]
LEAVES = ("state", "last", "ffn.last")


def rel(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("rwkv6_3b")
    vocab = cfg.vocab_size
    gen = torch.Generator(device="cuda").manual_seed(13)
    tokens = torch.randint(0, vocab, (len(LENGTHS), max(LENGTHS)),
                           generator=gen, device="cuda")
    lengths = torch.tensor(LENGTHS, device="cuda")
    ctx = make_ctx(ParallelConfig())
    out = {}
    for dt in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, compute_dtype=dt)
        model = M.init_model(c, ParallelConfig(tp=2), seed=0,
                             dtype=getattr(torch, dt), device="cuda")
        lg, caches = S.prefill_logits(model, {"tokens": tokens}, ctx, c,
                                      lengths)
        by_layer = {k: [0.0] * cfg.num_layers for k in LEAVES}
        logits = []
        for r, n in enumerate(LENGTHS):
            lga, alone = S.prefill_logits(
                model, {"tokens": tokens[r:r + 1, :n]}, ctx, c)
            logits.append(rel(lga[0, :vocab], lg[r, :vocab]))
            for i in range(cfg.num_layers):
                for k in LEAVES:
                    by_layer[k][i] = max(by_layer[k][i],
                                         rel(alone[i][k][0], caches[i][k][r]))
        out[dt] = {"state_rel_l2_by_layer": by_layer, "logits_rel_l2": logits}
        for k in LEAVES:
            print(dt, k, [round(v, 5) for v in by_layer[k]], flush=True)
        print(dt, "logits", [round(v, 5) for v in logits], flush=True)
        del model, caches, lg
        torch.cuda.empty_cache()
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    out["device"] = smi
    print(smi)
    path = (sys.argv[1] if len(sys.argv) > 1
            else os.path.join(ROOT, "build", "rwkv_depth_noise.json"))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()

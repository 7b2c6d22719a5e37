"""Per-architecture parallelism presets for the production meshes (port of
``repro.launch.presets``)."""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ModelConfig, ParallelConfig

# the archs the reference shards with ZeRO-3 and full remat when training
BIG = ("deepseek_v3_671b", "qwen15_110b", "qwen2_vl_72b", "gpt3_175b",
       "llama4_scout_17b_a16e", "jamba_v01_52b")
# experts over (data, model) above this count (DeepSeek-V3: 256)
EP_OVER_DP_EXPERTS = 16


def production_parallel(cfg: ModelConfig, *, multi_pod: bool = False,
                        kind: str = "train",
                        overlap_mode: str = "decomposed",
                        plan_profile: Optional[str] = None
                        ) -> ParallelConfig:
    """The ``ParallelConfig`` of the reference's (2,)16x16 meshes, sized
    per arch family: ZeRO-3 and full remat for the big archs' training,
    selective remat for the others', none when serving; experts over
    (data, model) above 16 experts; the cross-pod grad all-reduce
    compressed.  ``plan_profile`` names a tuned per-seam profile (a stale
    or mesh-mismatched one falls back to ``overlap_mode``)."""
    big = cfg.name in BIG
    train = kind == "train"
    return ParallelConfig(
        tp=16, dp=16, pods=2 if multi_pod else 1,
        ep_over_dp=(cfg.moe is not None
                    and cfg.moe.num_experts > EP_OVER_DP_EXPERTS),
        zero3=big and train,
        remat="full" if big and train else ("selective" if train
                                            else "none"),
        overlap_mode=overlap_mode,
        plan_profile=plan_profile,
        grad_compress=multi_pod,
    )

"""Model / parallelism configs (copy of ``repro.configs.base`` without jax).

Every architecture the port runs gets a module ``repro_torch/configs/<id>.py``
exposing ``CONFIG: ModelConfig`` and ``SMOKE_CONFIG``; ``ARCH_IDS`` and
``PAPER_ARCH_IDS`` list them.  Field names and
defaults match the reference so a config means the same model on both
sides; the port runs every layer kind of the reference's patterns: (ATTN,
DENSE_FFN), (ATTN, MOE_FFN), (MLA, DENSE_FFN), (MLA, MOE_FFN), (MAMBA,
DENSE_FFN), (MAMBA, MOE_FFN) and (RWKV, RWKV), the RWKV-6 time-mix and
channel-mix (``models.model.check_ported`` rejects the rest).
``SHAPES`` and ``shape_applicable`` are the reference's dry-run cells
(``launch.dryrun``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

# Layer-pattern vocabulary (same strings as the reference).
ATTN = "attn"          # softmax attention (GQA)
MLA = "mla"            # DeepSeek multi-head latent attention
MAMBA = "mamba"        # Mamba-1 selective-scan mixer
RWKV = "rwkv6"         # RWKV-6 (Finch) time-mix
DENSE_FFN = "ffn"      # SwiGLU dense FFN
MOE_FFN = "moe"        # routed expert FFN


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_ffn: int                  # d_ff of each routed expert
    num_shared_experts: int = 0      # DeepSeek-style shared expert(s)
    shared_ffn: int = 0              # d_ff of the shared expert path
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                 # 0 -> max(d_model // 16, 8)


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64             # LoRA rank of the data-dependent decay
    token_shift: bool = True


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int                   # query heads
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    pattern: Tuple[Tuple[str, str], ...] = ((ATTN, DENSE_FFN),)
    leading_dense_layers: int = 0
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None
    rope_theta: float = 10000.0
    rope_style: str = "rope"         # rope | none (mrope not ported)
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    mtp_depth: int = 0               # DeepSeek multi-token-prediction heads
    max_seq_len: int = 524288
    sub_quadratic: bool = False
    compute_dtype: str = "bfloat16"  # activation dtype (fp32 for num. tests)

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        from repro_torch.models.model import count_params_analytic
        return count_params_analytic(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model import count_params_analytic
        return count_params_analytic(self, active_only=True)


@dataclass(frozen=True)
class ParallelConfig:
    """How a model maps onto devices: the reference's fields that the port
    reads so far.  tp>1 runs its ranks in a ``dist.RankGroup``; dp>1,
    pods>1 or ep>1 runs the ``("pod", "ep", "data", "model")`` mesh of
    ``launch.mesh.make_mesh`` (a ``dist.RankMesh``): ZeRO-1 moments over
    "data" and, with ``grad_compress``, the int8 block-quantized grad
    all-reduce over "pod".  ``ep`` > 1 is a dedicated expert-parallel axis
    (it carries batch; the routed experts split over it, whole over the
    TP ranks; 1: no such axis, the reference's 0), ``ep_over_dp`` splits
    the experts over ("data", "model") instead, and ``zero3`` also splits
    the layers' weights over "data", gathered a layer at a time
    (``models.model``), in training and in the serve steps.
    The reference's ``pp`` (the pod axis read as pipeline stages,
    ``parallel.pipeline``) and ``seq_shard_attn`` are not carried.
    ``remat`` ("none" | "selective" | "full")
    recomputes each pattern block's activations in the backward (both
    values checkpoint every block, as the reference's do).
    ``kernel_decode`` turns on the hand-written kernels
    (``TPContext.use_kernels``): the flash-attention kernel of the GQA
    prefill and the MLA-decode kernel of every MLA decode step.
    ``overlap_mode`` is the TP seams' transport (``core.overlap``).
    ``comm_chunks`` is the ring seams' sub-chunking (0: auto, one chunk
    a shard; the decomposed ``ar`` cuts its contraction into
    ``comm_chunks or tp`` chunks).  ``plan_profile`` names a tuned
    per-seam profile (``tuning.cache``; a stale or missing file is
    ignored), whose plans overlay the uniform ``overlap_mode``
    (``tuning.plans.plan_set_from_parallel``).  ``scatter_axis`` is the
    residual stream's layout between the seams: "seq" (sequence-sharded,
    Megatron-SP), "hidden" (replicated), or "auto": the profile's layout,
    else "seq".  ``wire_dtype`` (None | "int8" | "fp8_e4m3" | "int4")
    quantizes the TP seams' forward wire (lossy; cotangents never ride
    it; flux seams keep the fp wire); ``max_logit_rmse`` is the error
    budget that gates the tuner's wire sweep."""
    tp: int = 1
    dp: int = 1
    pods: int = 1
    ep: int = 1
    ep_over_dp: bool = False
    zero3: bool = False
    grad_compress: bool = False
    remat: str = "none"
    fuse_w13: bool = False
    kernel_decode: bool = False
    overlap_mode: str = "decomposed"
    comm_chunks: int = 0
    plan_profile: Optional[str] = None
    scatter_axis: str = "auto"
    wire_dtype: Optional[str] = None
    max_logit_rmse: Optional[float] = None


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k only runs for sub-quadratic archs (SSM / hybrid)."""
    if shape.name == "long_500k" and not model.sub_quadratic:
        return False
    return True


# The archs the port has a config module for (the reference's ``ARCH_IDS``
# lists more: its frontend-embedding families are not ported yet, ROADMAP
# queue 1 item 8)
ARCH_IDS: List[str] = [
    "jamba_v01_52b",
    "llama4_scout_17b_a16e",
    "deepseek_v3_671b",
    "codeqwen15_7b",
    "phi4_mini_38b",
    "qwen15_110b",
    "minicpm_2b",
    "rwkv6_3b",
]

# the paper's own evaluation models (§5): GPT-3 175B, whose GEMMs give the
# op-level shapes, and Llama-2 70B (the reference lists only gpt3_175b here)
PAPER_ARCH_IDS: List[str] = ["gpt3_175b", "llama2_70b"]


def get_config(arch: str) -> ModelConfig:
    import importlib

    arch = arch.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def train_schedule(arch: str) -> str:
    """The LR schedule an arch trains with: its config module's
    ``TRAIN_SCHEDULE`` (minicpm: "wsd"), else "cosine"."""
    import importlib

    arch = arch.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return getattr(mod, "TRAIN_SCHEDULE", "cosine")


def get_smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    import importlib

    arch = arch.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    if hasattr(mod, "SMOKE_CONFIG"):
        return mod.SMOKE_CONFIG
    return shrink(mod.CONFIG)


def shrink(cfg: ModelConfig, **overrides: Any) -> ModelConfig:
    """Generic reduction used for smoke testing: tiny dims, same family/pattern
    (the reference's ``shrink`` restricted to the fields ported here)."""
    period = len(cfg.pattern)
    small: Dict[str, Any] = dict(
        num_layers=max(2 * period, 2),
        d_model=128,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        d_ff=256,
        vocab_size=512,
        head_dim=32 if cfg.num_heads else 0,
        leading_dense_layers=min(cfg.leading_dense_layers, 1),
        max_seq_len=4096,
    )
    if cfg.moe is not None:
        small["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2), expert_ffn=128,
            shared_ffn=128 if cfg.moe.shared_ffn else 0)
    if cfg.mla is not None:
        small["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                                 qk_nope_head_dim=32, qk_rope_head_dim=16,
                                 v_head_dim=32)
    if cfg.rwkv is not None:
        small["rwkv"] = RWKVConfig(head_dim=32, decay_lora=16)
    if cfg.mamba is not None:
        small["mamba"] = MambaConfig(d_state=8, d_conv=4, expand=2)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)

"""Llama-4 Scout 17B-active/16E: MoE top-1 + shared expert, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

The reference's config field for field: every layer is GQA attention and a
routed MoE FFN (16 experts, top-1) beside one shared expert.  The port has
no frontend (early fusion feeds tokens only).
"""
from repro_torch.configs.base import (ATTN, MOE_FFN, ModelConfig, MoEConfig,
                                      shrink)

CONFIG = ModelConfig(
    name="llama4_scout_17b_a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    pattern=((ATTN, MOE_FFN),),
    moe=MoEConfig(num_experts=16, top_k=1, expert_ffn=8192,
                  num_shared_experts=1, shared_ffn=8192),
    rope_style="rope",
    sub_quadratic=False,         # full attention -> long_500k skipped
)

SMOKE_CONFIG = shrink(CONFIG)

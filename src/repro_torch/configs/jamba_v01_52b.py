"""Jamba-v0.1 52B: hybrid Mamba+attention 1:7 interleave, MoE 16e top-2
every other layer.  [arXiv:2403.19887; hf]

The reference's config field for field: a period of 8 layers, seven
Mamba-1 mixers and one GQA attention layer (position 4), a routed MoE FFN
(16 experts, top-2) on every other layer and a dense SwiGLU FFN on the
rest.
"""
from repro_torch.configs.base import (ATTN, DENSE_FFN, MAMBA, MOE_FFN,
                                      MambaConfig, ModelConfig, MoEConfig,
                                      shrink)

CONFIG = ModelConfig(
    name="jamba_v01_52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    # period of 8: attention at position 4 (1:7), MoE every other layer
    pattern=(
        (MAMBA, DENSE_FFN), (MAMBA, MOE_FFN),
        (MAMBA, DENSE_FFN), (MAMBA, MOE_FFN),
        (ATTN, DENSE_FFN), (MAMBA, MOE_FFN),
        (MAMBA, DENSE_FFN), (MAMBA, MOE_FFN),
    ),
    moe=MoEConfig(num_experts=16, top_k=2, expert_ffn=14336),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    rope_style="rope",
    sub_quadratic=True,          # mamba-dominant -> long_500k cell runs
)

SMOKE_CONFIG = shrink(CONFIG)

"""Phi-4-mini 3.8B: dense, RoPE + SwiGLU + GQA.  [arXiv:2412.08905; hf]"""
from repro_torch.configs.base import ModelConfig, shrink

CONFIG = ModelConfig(
    name="phi4_mini_38b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    rope_style="rope",
    sub_quadratic=False,
)

SMOKE_CONFIG = shrink(CONFIG)

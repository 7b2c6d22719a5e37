"""Qwen1.5 110B: dense with QKV bias.  [hf:Qwen/Qwen1.5-110B; hf]"""
from repro_torch.configs.base import ModelConfig, shrink

CONFIG = ModelConfig(
    name="qwen15_110b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    rope_style="rope",
    qkv_bias=True,
    sub_quadratic=False,
)

SMOKE_CONFIG = shrink(CONFIG)

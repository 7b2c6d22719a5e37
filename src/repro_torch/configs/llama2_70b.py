"""Llama-2 70B — the paper's second model-level evaluation target
(Figs. 16/17: Megatron-LLaMA training, vLLM inference)."""
from repro_torch.configs.base import ModelConfig, shrink

CONFIG = ModelConfig(
    name="llama2_70b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=32000,
    rope_style="rope",
    sub_quadratic=False,
)

SMOKE_CONFIG = shrink(CONFIG)

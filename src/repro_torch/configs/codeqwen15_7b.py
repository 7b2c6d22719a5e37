"""CodeQwen1.5 7B: dense qwen1.5 arch.  [hf:Qwen/CodeQwen1.5-7B; hf]"""
from repro_torch.configs.base import ModelConfig, shrink

CONFIG = ModelConfig(
    name="codeqwen15_7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    rope_style="rope",
    qkv_bias=True,               # qwen1.5 family uses QKV bias
    sub_quadratic=False,
)

SMOKE_CONFIG = shrink(CONFIG)

"""RWKV-6 (Finch) 3B: attention-free, data-dependent decay.
[arXiv:2404.05892; hf]

The reference's config field for field: 32 layers of one (RWKV, RWKV)
pair, the time-mix (40 heads of 64, a decay LoRA of rank 64) and the
channel-mix (d_ff 8960, squared ReLU), no positional rotation.
"""
from repro_torch.configs.base import RWKV, ModelConfig, RWKVConfig, shrink

CONFIG = ModelConfig(
    name="rwkv6_3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=0,                 # attention-free
    num_kv_heads=0,
    d_ff=8960,
    vocab_size=65536,
    pattern=((RWKV, RWKV),),     # time-mix + channel-mix
    rwkv=RWKVConfig(head_dim=64, decay_lora=64),
    rope_style="none",
    sub_quadratic=True,          # O(1) state decode -> long_500k runs
)

SMOKE_CONFIG = shrink(CONFIG)

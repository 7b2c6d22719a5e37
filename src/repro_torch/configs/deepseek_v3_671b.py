"""DeepSeek-V3 671B: MLA, 1 shared + 256 routed experts top-8, MTP.
[arXiv:2412.19437; hf]

d_ff=2048 per the assigned table (the routed-expert width; the 3 leading
dense layers use the same width to honor the table exactly).  The port
serves it without the MTP head, which only training reads.
"""
from repro_torch.configs.base import (MLA, MOE_FFN, MLAConfig, ModelConfig,
                                      MoEConfig, shrink)

CONFIG = ModelConfig(
    name="deepseek_v3_671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,            # MLA: heads share the latent cache
    d_ff=2048,
    vocab_size=129280,
    head_dim=128,
    pattern=((MLA, MOE_FFN),),
    leading_dense_layers=3,
    moe=MoEConfig(num_experts=256, top_k=8, expert_ffn=2048,
                  num_shared_experts=1, shared_ffn=2048),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    rope_style="rope",
    mtp_depth=1,
    sub_quadratic=False,
)

SMOKE_CONFIG = shrink(CONFIG)

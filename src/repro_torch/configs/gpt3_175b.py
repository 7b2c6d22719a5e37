"""GPT-3 175B — the paper's own evaluation model; its MLP GEMMs give the
(n,k) = (49152, 12288) / (12288, 49152) shapes of the op-level benchmarks
(paper §5.1).  RoPE stands in for learned positions (irrelevant to the
communication study)."""
from repro_torch.configs.base import ModelConfig, shrink

CONFIG = ModelConfig(
    name="gpt3_175b",
    family="dense",
    num_layers=96,
    d_model=12288,
    num_heads=96,
    num_kv_heads=96,
    d_ff=49152,
    vocab_size=50304,
    rope_style="rope",
    sub_quadratic=False,
)

SMOKE_CONFIG = shrink(CONFIG)

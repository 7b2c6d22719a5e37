"""MiniCPM 2B: llama-like dense, tied embeddings; trained with the WSD
schedule (``optim/schedule.py``, picked by ``launch/train.py`` for this
arch).  [arXiv:2404.06395; hf]"""
from repro_torch.configs.base import ModelConfig, shrink

CONFIG = ModelConfig(
    name="minicpm_2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    rope_style="rope",
    tie_embeddings=True,
    sub_quadratic=False,
)

TRAIN_SCHEDULE = "wsd"

SMOKE_CONFIG = shrink(CONFIG)

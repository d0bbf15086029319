"""h2o-danube-1.8b [dense] — llama+mistral mix with sliding-window attention.

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000
[arXiv:2401.16818; hf]

SWA (window 4096) makes this arch sub-quadratic: long_500k decode runs
with a window-bounded KV cache.
"""
from repro_torch.configs.base import AttentionConfig, MLPConfig, ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2_560,
    vocab_size=32_000,
    attention=AttentionConfig(
        n_heads=32, n_kv_heads=8, head_dim=80, sliding_window=4_096
    ),
    mlp=MLPConfig(d_ff=6_912, activation="silu", gated=True),
    norm="rmsnorm",
    max_seq_len=16_384,
)

"""smollm-360m [dense] — llama-arch small.

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152
[hf:HuggingFaceTB/SmolLM-360M; hf]

Note: 15 heads / 5 kv heads are not divisible by TP=16 -> the sharding
layer falls back to head_dim-sharded attention for this arch.
"""
from repro_torch.configs.base import AttentionConfig, MLPConfig, ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    vocab_size=49_152,
    attention=AttentionConfig(n_heads=15, n_kv_heads=5, head_dim=64),
    mlp=MLPConfig(d_ff=2_560, activation="silu", gated=True),
    norm="rmsnorm",
    tie_embeddings=True,
    max_seq_len=8_192,
)

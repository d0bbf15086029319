"""stablelm-1.6b [dense].

24L d_model=2048 32H (GQA kv=32) d_ff=5632 vocab=100352
[hf:stabilityai/stablelm-2-1_6b; unverified]

StableLM-2 uses LayerNorm and partial rotary embeddings (25%).
"""
from repro_torch.configs.base import AttentionConfig, MLPConfig, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2_048,
    vocab_size=100_352,
    attention=AttentionConfig(
        n_heads=32, n_kv_heads=32, head_dim=64, rope_pct=0.25, qkv_bias=True
    ),
    mlp=MLPConfig(d_ff=5_632, activation="silu", gated=True),
    norm="layernorm",
    max_seq_len=4_096,
)

"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks.

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64
[arXiv:2411.15242; hf]

Backbone layers are Mamba2 blocks (O(1) state); a shared
attention+MLP block (2 alternating copies) is applied every 6 backbone
layers. SSM => long_500k runs (shared-attn KV is the long-context cost).
"""
from repro_torch.configs.base import (
    AttentionConfig, MLPConfig, ModelConfig, SSMConfig, ZambaConfig,
)

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2_048,
    vocab_size=32_000,
    attention=AttentionConfig(n_heads=32, n_kv_heads=32, head_dim=64),
    mlp=MLPConfig(d_ff=8_192, activation="gelu", gated=False),
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64),
    zamba=ZambaConfig(shared_attn_every=6, shared_attn_copies=2),
    norm="rmsnorm",
    max_seq_len=1_048_576,
)

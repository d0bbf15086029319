"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution.

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936
[arXiv:2409.12191; hf]

The vision frontend is a STUB per the assignment: ``input_specs()``
provides precomputed patch embeddings; this config describes the
transformer backbone with multimodal rotary position embeddings.
heads=12 ∤ 16 -> head_dim-sharded attention fallback.
"""
from repro_torch.configs.base import AttentionConfig, MLPConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1_536,
    vocab_size=151_936,
    attention=AttentionConfig(
        n_heads=12, n_kv_heads=2, head_dim=128, rope="mrope", qkv_bias=True,
        rope_theta=1_000_000.0,
    ),
    mlp=MLPConfig(d_ff=8_960, activation="silu", gated=True),
    norm="rmsnorm",
    embed_stub=True,
    tie_embeddings=True,
    max_seq_len=32_768,
)

"""qwen3-moe-30b-a3b [moe] — 128 experts top-8.

48L d_model=2048 32H (GQA kv=4) d_ff=768 vocab=151936, MoE 128e top-8
[hf:Qwen/Qwen3-30B-A3B; hf]

d_ff=768 is the per-expert hidden dim (moe_intermediate_size). 128
experts divide every mesh axis -> full expert parallelism available.
Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import AttentionConfig, MLPConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2_048,
    vocab_size=151_936,
    attention=AttentionConfig(
        n_heads=32, n_kv_heads=4, head_dim=128, rope_theta=1_000_000.0
    ),
    mlp=MLPConfig(d_ff=768, activation="silu", gated=True),
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=768),
    norm="rmsnorm",
    max_seq_len=32_768,
)

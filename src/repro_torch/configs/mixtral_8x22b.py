"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8e top-2
[arXiv:2401.04088; hf]

SWA => sub-quadratic => long_500k runs. 8 experts do not divide the
16-way model axis -> experts are TP-sharded along d_expert instead of
expert-parallel on the production mesh.
"""
from repro_torch.configs.base import AttentionConfig, MLPConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6_144,
    vocab_size=32_768,
    attention=AttentionConfig(
        n_heads=48, n_kv_heads=8, head_dim=128, sliding_window=4_096,
        rope_theta=1_000_000.0,
    ),
    mlp=MLPConfig(d_ff=16_384, activation="silu", gated=True),
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=16_384),
    norm="rmsnorm",
    max_seq_len=65_536,
)

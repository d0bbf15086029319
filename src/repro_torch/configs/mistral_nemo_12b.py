"""mistral-nemo-12b [dense] — 128k context.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072
[hf:mistralai/Mistral-Nemo-Base-2407; hf]

Full attention (no SWA) -> long_500k is skipped per the shape rules.
"""
from repro_torch.configs.base import AttentionConfig, MLPConfig, ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5_120,
    vocab_size=131_072,
    attention=AttentionConfig(
        n_heads=32, n_kv_heads=8, head_dim=128, rope_theta=1_000_000.0
    ),
    mlp=MLPConfig(d_ff=14_336, activation="silu", gated=True),
    norm="rmsnorm",
    max_seq_len=131_072,
)

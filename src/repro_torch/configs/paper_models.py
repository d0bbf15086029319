"""Model configs used in the paper's own experiments (Section 4).

These are used by the benchmark harness to reproduce the paper's
figures: Meta-Llama-3-8B (Table 1a default), Llama-2-7B-hf (Table 1b
co-simulation), plus the Exp. 1/5 sweep models (phi-2 2.7B,
CodeLlama-34B, Llama-3-70B, Qwen-72B).
"""
from repro_torch.configs.base import AttentionConfig, MLPConfig, ModelConfig

LLAMA3_8B = ModelConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4_096,
    vocab_size=128_256,
    attention=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=128,
                              rope_theta=500_000.0),
    mlp=MLPConfig(d_ff=14_336),
    max_seq_len=8_192,
)

LLAMA2_7B = ModelConfig(
    name="llama2-7b",
    family="dense",
    n_layers=32,
    d_model=4_096,
    vocab_size=32_000,
    attention=AttentionConfig(n_heads=32, n_kv_heads=32, head_dim=128),
    mlp=MLPConfig(d_ff=11_008),
    max_seq_len=4_096,
)

PHI2_2_7B = ModelConfig(
    name="phi2-2.7b",
    family="dense",
    n_layers=32,
    d_model=2_560,
    vocab_size=51_200,
    attention=AttentionConfig(n_heads=32, n_kv_heads=32, head_dim=80,
                              rope_pct=0.4, qkv_bias=True),
    mlp=MLPConfig(d_ff=10_240, activation="gelu", gated=False),
    norm="layernorm",
    max_seq_len=2_048,
)

CODELLAMA_34B = ModelConfig(
    name="codellama-34b",
    family="dense",
    n_layers=48,
    d_model=8_192,
    vocab_size=32_000,
    attention=AttentionConfig(n_heads=64, n_kv_heads=8, head_dim=128,
                              rope_theta=1_000_000.0),
    mlp=MLPConfig(d_ff=22_016),
    max_seq_len=16_384,
)

LLAMA3_70B = ModelConfig(
    name="llama3-70b",
    family="dense",
    n_layers=80,
    d_model=8_192,
    vocab_size=128_256,
    attention=AttentionConfig(n_heads=64, n_kv_heads=8, head_dim=128,
                              rope_theta=500_000.0),
    mlp=MLPConfig(d_ff=28_672),
    max_seq_len=8_192,
)

QWEN_72B = ModelConfig(
    name="qwen-72b",
    family="dense",
    n_layers=80,
    d_model=8_192,
    vocab_size=152_064,
    attention=AttentionConfig(n_heads=64, n_kv_heads=64, head_dim=128,
                              qkv_bias=True),
    mlp=MLPConfig(d_ff=24_576),
    max_seq_len=32_768,
)

PAPER_MODELS = {
    m.name: m
    for m in [LLAMA3_8B, LLAMA2_7B, PHI2_2_7B, CODELLAMA_34B, LLAMA3_70B, QWEN_72B]
}

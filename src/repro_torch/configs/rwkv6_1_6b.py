"""rwkv6-1.6b [ssm] — "Finch", attention-free with data-dependent decay.

24L d_model=2048 (attn-free) d_ff=7168 vocab=65536
[arXiv:2404.05892; unverified]

Linear recurrence (O(1) state per channel) -> long_500k runs. The
recurrence is computed by the ``gla_scan`` CUDA kernel on prefill
(``repro_torch.kernels.gla_scan``) or its plain chunked version
(``repro_torch.models.linear_attention``).
"""
from repro_torch.configs.base import MLPConfig, ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2_048,
    vocab_size=65_536,
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32, gate_lora=64),
    mlp=MLPConfig(d_ff=7_168, activation="relu_sq", gated=False),
    norm="layernorm",
    max_seq_len=1_048_576,
)

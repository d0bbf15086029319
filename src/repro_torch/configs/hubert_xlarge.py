"""hubert-xlarge [audio] — encoder-only, wav2vec2-style transformer.

48L d_model=1280 16H (GQA kv=16) d_ff=5120 vocab=504
[arXiv:2106.07447; unverified]

Encoder-only: bidirectional attention, no KV-cache decode -> decode_32k
and long_500k shapes are skipped. The CNN waveform frontend is a STUB:
``input_specs()`` provides precomputed frame embeddings
(batch, frames, d_model); vocab_size=504 is the masked-unit prediction
codebook.
"""
from repro_torch.configs.base import AttentionConfig, MLPConfig, ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1_280,
    vocab_size=504,
    attention=AttentionConfig(
        n_heads=16, n_kv_heads=16, head_dim=80, causal=False, rope="none",
        qkv_bias=True,
    ),
    mlp=MLPConfig(d_ff=5_120, activation="gelu", gated=False),
    norm="layernorm",
    is_encoder_only=True,
    embed_stub=True,
    max_seq_len=65_536,
)

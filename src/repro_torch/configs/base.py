"""Model / run configuration dataclasses.

Every assigned architecture is expressed as a ``ModelConfig``; the model
zoo (``repro_torch.models``) builds parameter modules and step functions
from it. The dataclasses are verbatim copies of the reference package's, so
field names, defaults and ``dataclasses.asdict`` digests agree between the
two packages.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class AttentionConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    # Sliding-window attention: None => full attention.
    sliding_window: Optional[int] = None
    # Rotary embedding config. "mrope" = multimodal rope (Qwen2-VL).
    rope: str = "rope"  # "rope" | "mrope" | "none"
    rope_theta: float = 10_000.0
    # Fraction of head_dim that is rotated (stablelm uses partial rotary).
    rope_pct: float = 1.0
    causal: bool = True
    qkv_bias: bool = False
    # KV-head replication factor for TP (MaxText-style): set by the
    # launcher when n_kv_heads < TP degree. Caches store replicated heads.
    kv_repeat: int = 1

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def n_kv_eff(self) -> int:
        """KV heads after TP replication (what caches actually store)."""
        return self.n_kv_heads * self.kv_repeat


@dataclass(frozen=True)
class MLPConfig:
    d_ff: int
    activation: str = "silu"  # "silu" (gated) | "gelu" (plain, hubert)
    gated: bool = True


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                   # per-expert hidden dim
    router_jitter: float = 0.0
    # load-balancing aux loss coefficient (train only)
    aux_loss_coef: float = 0.01
    n_shared_experts: int = 0       # qwen-style shared expert (unused here)


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2-style state-space block (zamba2)."""
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV6 "Finch" time-mix config."""
    head_dim: int = 64
    decay_lora: int = 64      # low-rank dim for data-dependent decay w_t
    mix_lora: int = 32        # low-rank dim for token-shift mixers
    gate_lora: int = 64


@dataclass(frozen=True)
class ZambaConfig:
    """Zamba2 hybrid layout: mamba2 backbone + shared attention block."""
    shared_attn_every: int = 6     # apply shared block every N backbone layers
    shared_attn_copies: int = 2    # zamba2 alternates between 2 shared blocks


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | vlm | ssm | hybrid | audio
    n_layers: int
    d_model: int
    vocab_size: int
    attention: Optional[AttentionConfig] = None
    mlp: Optional[MLPConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    zamba: Optional[ZambaConfig] = None
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_seq_len: int = 131_072
    # encoder-only models (hubert) have no causal decode path
    is_encoder_only: bool = False
    # modality frontend stub: inputs arrive as precomputed embeddings
    embed_stub: bool = False       # True for [audio]/[vlm] frontends
    dtype: str = "bfloat16"

    # ---------------- parameter counting ----------------
    def attn_params(self) -> int:
        a = self.attention
        if a is None:
            return 0
        return self.d_model * (a.q_dim + 2 * a.kv_dim) + a.q_dim * self.d_model

    def mlp_params(self) -> int:
        if self.mlp is None:
            return 0
        m = 3 if self.mlp.gated else 2
        return m * self.d_model * self.mlp.d_ff

    def moe_params(self) -> int:
        if self.moe is None:
            return 0
        per_expert = 3 * self.d_model * self.moe.d_expert
        return self.moe.n_experts * per_expert + self.d_model * self.moe.n_experts

    def moe_active_params(self) -> int:
        if self.moe is None:
            return 0
        per_expert = 3 * self.d_model * self.moe.d_expert
        return self.moe.top_k * per_expert + self.d_model * self.moe.n_experts

    def rwkv_params(self) -> int:
        if self.rwkv is None:
            return 0
        d, r = self.d_model, self.rwkv
        # time-mix: receptance, key, value, gate, output = 5 full matrices
        time_mix = 5 * d * d
        # token-shift mixers (5x) + data-dependent decay, all low-rank
        lora = 5 * (d * r.mix_lora + r.mix_lora * d) + (d * r.decay_lora + r.decay_lora * d)
        # channel-mix: key (d->ff), value (ff->d), receptance (d->d)
        channel_mix = 2 * d * (self.mlp.d_ff if self.mlp else 4 * d) + d * d
        return time_mix + lora + channel_mix

    def ssm_params(self) -> int:
        if self.ssm is None:
            return 0
        d_in = self.ssm.d_inner(self.d_model)
        n_h = self.ssm.n_heads(self.d_model)
        in_proj = self.d_model * (2 * d_in + 2 * self.ssm.n_groups * self.ssm.d_state + n_h)
        conv = self.ssm.d_conv * (d_in + 2 * self.ssm.n_groups * self.ssm.d_state)
        out_proj = d_in * self.d_model
        return in_proj + conv + out_proj + 2 * n_h

    def param_count(self) -> int:
        """Approximate total parameter count N (embeddings included)."""
        d = self.d_model
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":  # rwkv6
            per_layer = self.rwkv_params()
        elif self.family == "hybrid":  # zamba2: mamba backbone, shared attn+MLP
            n_shared = self.zamba.shared_attn_copies if self.zamba else 1
            backbone = self.ssm_params()
            shared = n_shared * (self.attn_params() + self.mlp_params())
            return emb + self.n_layers * backbone + shared + d
        elif self.family == "moe":
            per_layer = self.attn_params() + self.moe_params()
        else:
            per_layer = self.attn_params() + self.mlp_params()
        return emb + self.n_layers * per_layer + d

    def active_param_count(self) -> int:
        """Active params per token (= N for dense, N_active for MoE)."""
        if self.family == "moe":
            d = self.d_model
            emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
            per_layer = self.attn_params() + self.moe_active_params()
            return emb + self.n_layers * per_layer + d
        if self.family == "hybrid":
            return self.param_count()
        return self.param_count()

    # ---------------- FLOPs accounting (paper Eq. 2 terms) -------------
    # All totals are forward FLOPs per token across ALL layers (2 * MACs).
    def n_attn_applications(self) -> int:
        """How many attention blocks a token passes through."""
        if self.attention is None:
            return 0
        if self.family == "hybrid" and self.zamba is not None:
            return self.n_layers // self.zamba.shared_attn_every
        return self.n_layers

    def flops_per_token_mlp_total(self) -> float:
        """Total MLP/MoE/channel-mix + LM-head FLOPs per token (Eq. 2 FLOPs_MLP)."""
        d = self.d_model
        head = 2.0 * d * self.vocab_size
        if self.family == "moe":
            return self.n_layers * 2.0 * self.moe_active_params() + head
        if self.family == "ssm":
            ff = self.mlp.d_ff if self.mlp else 4 * d
            return self.n_layers * 2.0 * (2 * d * ff + d * d) + head
        if self.family == "hybrid":
            return self.n_attn_applications() * 2.0 * self.mlp_params() + head
        return self.n_layers * 2.0 * self.mlp_params() + head

    def flops_per_token_attn_proj_total(self) -> float:
        """Total attention/SSM projection FLOPs per token (context-free part)."""
        if self.family == "ssm":
            ff = self.mlp.d_ff if self.mlp else 4 * self.d_model
            chan = 2 * self.d_model * ff + self.d_model * self.d_model
            return self.n_layers * 2.0 * (self.rwkv_params() - chan)
        if self.family == "hybrid":
            return (self.n_layers * 2.0 * self.ssm_params()
                    + self.n_attn_applications() * 2.0 * self.attn_params())
        return self.n_layers * 2.0 * self.attn_params()

    def flops_attn_score_per_token(self, context_len: int) -> float:
        """Total score+value attention FLOPs per token given context length
        (Eq. 2 FLOPs_Attention context-dependent part)."""
        score = 0.0
        a = self.attention
        if a is not None:
            ctx = context_len
            if a.sliding_window is not None:
                ctx = min(ctx, a.sliding_window)
            score += self.n_attn_applications() * 4.0 * a.n_heads * a.head_dim * ctx
        if self.family == "ssm" and self.rwkv is not None:
            n_h = self.d_model // self.rwkv.head_dim
            score += self.n_layers * 4.0 * n_h * self.rwkv.head_dim * self.rwkv.head_dim
        if self.ssm is not None:
            n_h = self.ssm.n_heads(self.d_model)
            score += self.n_layers * 4.0 * n_h * self.ssm.head_dim * self.ssm.d_state
        return score

    def flops_per_token_total(self, context_len: int) -> float:
        return (self.flops_per_token_mlp_total()
                + self.flops_per_token_attn_proj_total()
                + self.flops_attn_score_per_token(context_len))

    # ---------------- derived helpers ----------------
    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        a = self.attention
        if a is None:
            return 0
        n_layers_attn = self.n_layers
        if self.family == "hybrid" and self.zamba is not None:
            n_layers_attn = max(1, self.n_layers // self.zamba.shared_attn_every)
        return 2 * a.n_kv_heads * a.head_dim * n_layers_attn * dtype_bytes

    def supports_decode(self) -> bool:
        return not self.is_encoder_only

    def subquadratic(self) -> bool:
        """Can this arch run 500k-token decode? (SSM/hybrid/linear/SWA)"""
        if self.family in ("ssm", "hybrid"):
            return True
        a = self.attention
        return a is not None and a.sliding_window is not None

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes assigned to the LM family (seq_len x global_batch).
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """The (arch x shape) applicability matrix. Returns (runnable, reason)."""
    if shape.kind == "decode" and not cfg.supports_decode():
        return False, "encoder-only: no decode step"
    if shape.name == "long_500k" and not cfg.subquadratic():
        return False, "pure full-attention arch: 500k decode needs sub-quadratic attention"
    return True, ""

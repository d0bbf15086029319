"""Model facade: init / prefill / decode for the dense and ssm (RWKV6)
families.

Counterpart of ``repro.models.lm``. ``build_model(cfg)`` returns a ``Model``
whose step functions the serving engine drives. ``attn_impl`` defaults to
``"kernel"``, the hand-written CUDA kernels (attention for the dense family,
the ``gla_scan`` prefill scan for RWKV6); ``"einsum"`` is the plain path.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import transformer as tf


def check_supported(cfg: ModelConfig) -> None:
    """The families the port serves: dense decoders (RoPE or none) and
    RWKV6 (ssm). MoE, hybrid, M-RoPE, encoders and stubs raise."""
    if cfg.family != "ssm":
        tf.check_supported(cfg)


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    attn_impl: str = "kernel"

    def init(self, seed: int = 0, device: DeviceLike = None):
        """Random weights drawn on ``device`` from a generator seeded with
        ``seed``."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        if self.cfg.family == "ssm":
            return rwkv_mod.init_rwkv(self.cfg, gen, dev,
                                      tf.compute_dtype(self.cfg))
        return tf.init_transformer(self.cfg, gen, dev)

    # ---------------- serving: prefill ----------------
    @torch.no_grad()
    def prefill(self, params, batch: Dict, max_len: int,
                cache: Optional[Dict] = None, slot: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict]:
        """Full-sequence forward; returns (last-token logits (B,V), cache).

        With ``cache`` and ``slot``, the (single) prompt's K/V (dense) or
        recurrent states (ssm) are written into that row of the shared cache
        in place and ``cache`` is returned; otherwise a fresh cache of
        ``max_len`` is built, as the reference does. Prompts in a batch
        share one length (the reference's padded ``lengths`` batches are not
        ported)."""
        c = self.cfg
        x = tf.embed_tokens(params, c, batch["tokens"])
        B, S, _ = x.shape
        if cache is not None and B != 1:
            raise ValueError("in-place cache insertion takes one prompt")
        if c.family == "ssm":
            h, states = rwkv_mod.rwkv_forward(params, c, x, mode="prefill",
                                              impl=self.attn_impl)
            if cache is None:
                cache = rwkv_mod.init_rwkv_cache(c, B, x.device)
                rows = slice(None)
            else:
                rows = slice(slot, slot + 1)
            rwkv_mod.write_states(cache, rows, states, S)
            return rwkv_mod.rwkv_logits(params, h[:, -1]), cache
        h, pre = tf.transformer_forward(
            params, c, x, positions=torch.arange(S, device=x.device)[None, :],
            mode="prefill", attn_impl=self.attn_impl)
        if cache is None:
            cache = tf.fill_cache_from_prefill(
                c, pre["computed_k"], pre["computed_v"], S, max_len)
        else:
            tf.write_prefill_to_cache(cache, slice(slot, slot + 1),
                                      pre["computed_k"], pre["computed_v"], S)
        # last position logits only (serving does not need all logits)
        return tf.lm_logits(params, c, h[:, -1]), cache

    # ---------------- serving: one decode step ----------------
    @torch.no_grad()
    def decode_step(self, params, batch: Dict, cache: Dict
                    ) -> Tuple[torch.Tensor, Dict]:
        """batch: {"tokens": (B,1)}. Returns ((B,V), cache); the cache's K/V
        or recurrent states are updated in place."""
        c = self.cfg
        x = tf.embed_tokens(params, c, batch["tokens"])
        if c.family == "ssm":
            h, cache = rwkv_mod.rwkv_forward(params, c, x, mode="decode",
                                             cache=cache, impl=self.attn_impl)
            return rwkv_mod.rwkv_logits(params, h)[:, 0], \
                {**cache, "lengths": cache["lengths"] + 1}
        h, new_cache = tf.transformer_forward(
            params, c, x, positions=cache["lengths"][:, None], mode="decode",
            cache=cache, attn_impl=self.attn_impl)
        return tf.lm_logits(params, c, h)[:, 0], new_cache

    # ---------------- cache factory ----------------
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device: DeviceLike = None) -> Dict:
        c = self.cfg
        check_supported(c)
        if c.family == "ssm":
            return rwkv_mod.init_rwkv_cache(c, batch, resolve_device(device))
        return attn_mod.init_kv_cache(c.n_layers, batch, c.attention, max_len,
                                      resolve_device(device), dtype)


def build_model(cfg: ModelConfig, attn_impl: str = "kernel") -> Model:
    return Model(cfg=cfg, attn_impl=attn_impl)

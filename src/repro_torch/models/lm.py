"""Model facade: init / prefill / decode for the dense family.

Counterpart of ``repro.models.lm``. ``build_model(cfg)`` returns a ``Model``
whose step functions the serving engine drives. ``attn_impl`` defaults to
``"kernel"``, the hand-written CUDA attention kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as tf


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    attn_impl: str = "kernel"

    def init(self, seed: int = 0, device: DeviceLike = None) -> tf.TransformerParams:
        """Random weights drawn on ``device`` from a generator seeded with
        ``seed``."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return tf.init_transformer(self.cfg, gen, dev)

    # ---------------- serving: prefill ----------------
    @torch.no_grad()
    def prefill(self, params, batch: Dict, max_len: int,
                cache: Optional[Dict] = None, slot: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict]:
        """Full-sequence forward; returns (last-token logits (B,V), cache).

        With ``cache`` and ``slot``, the (single) prompt's K/V are written
        into that row of the shared cache in place and ``cache`` is returned;
        otherwise a fresh cache of ``max_len`` is built, as the reference
        does. Prompts in a batch share one length (the reference's padded
        ``lengths`` batches are not ported)."""
        c = self.cfg
        x = tf.embed_tokens(params, c, batch["tokens"])
        B, S, _ = x.shape
        h, pre = tf.transformer_forward(
            params, c, x, positions=torch.arange(S, device=x.device)[None, :],
            mode="prefill", attn_impl=self.attn_impl)
        if cache is None:
            cache = tf.fill_cache_from_prefill(
                c, pre["computed_k"], pre["computed_v"], S, max_len)
        else:
            if B != 1:
                raise ValueError("in-place cache insertion takes one prompt")
            tf.write_prefill_to_cache(cache, slice(slot, slot + 1),
                                      pre["computed_k"], pre["computed_v"], S)
        # last position logits only (serving does not need all logits)
        return tf.lm_logits(params, c, h[:, -1]), cache

    # ---------------- serving: one decode step ----------------
    @torch.no_grad()
    def decode_step(self, params, batch: Dict, cache: Dict
                    ) -> Tuple[torch.Tensor, Dict]:
        """batch: {"tokens": (B,1)}. Returns ((B,V), cache); the cache's K/V
        are updated in place."""
        c = self.cfg
        x = tf.embed_tokens(params, c, batch["tokens"])
        h, new_cache = tf.transformer_forward(
            params, c, x, positions=cache["lengths"][:, None], mode="decode",
            cache=cache, attn_impl=self.attn_impl)
        return tf.lm_logits(params, c, h)[:, 0], new_cache

    # ---------------- cache factory ----------------
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device: DeviceLike = None) -> Dict:
        c = self.cfg
        tf.check_supported(c)
        return attn_mod.init_kv_cache(c.n_layers, batch, c.attention, max_len,
                                      resolve_device(device), dtype)


def build_model(cfg: ModelConfig, attn_impl: str = "kernel") -> Model:
    return Model(cfg=cfg, attn_impl=attn_impl)

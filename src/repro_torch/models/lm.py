"""Model facade: init / train-loss / prefill / decode for every family:
dense, MoE, VLM and audio transformers, RWKV6 (ssm) and Zamba2 (hybrid).

Counterpart of ``repro.models.lm``. ``build_model(cfg)`` returns a ``Model``
whose step functions the serving engine, the trainer and the dry-run drive.
``attn_impl`` defaults to ``"kernel"``, the hand-written CUDA kernels (flash
and decode attention, the ``gla_scan`` prefill scan of RWKV6 and Zamba2's
Mamba2 layers; in training flash attention's forward and backward kernels,
and the plain ``gla_chunked`` scan, as the reference); ``"einsum"`` is the
plain path; ``"auto"`` the reference's default (``models.attention``:
materialized scores for short sequences, the chunked online softmax for
long ones, plain scans), which launches no kernel. ``remat``
rematerialises each layer in training under ``remat_policy``
(``"minimal"`` or ``"dots"``).

A batch holds ``tokens`` (B, S) or, for the stub frontends (VLM patches,
audio frames), ``embeds`` (B, S, D); under M-RoPE optionally ``positions3``
(B, S, 3), else text positions (all three streams equal). Encoder-only
models (HuBERT) prefill to last-position logits and have no cache or
decode.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.axes import constrain, on_local
from repro_torch.models import attention as attn_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import transformer as tf
from repro_torch.models import zamba as zamba_mod
from repro_torch.models.layers import REMAT_POLICIES
from repro_torch.obs.spans import PROFILER


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    return logz - torch.gather(logits, -1, labels[..., None].long())[..., 0]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over valid positions; logits promoted to float32 (under a
    mesh each token's whole row of logits on its batch shard)."""
    nll = on_local(_nll, logits, labels)
    if valid is None:
        return nll.mean()
    v = valid.float()
    return (nll * v).sum() / torch.clamp(v.sum(), min=1.0)


def check_supported(cfg: ModelConfig) -> None:
    """Every family of the reference: the transformer families, RWKV6
    (ssm) and Zamba2 (hybrid). An unknown family raises."""
    if cfg.family not in ("ssm", "hybrid"):
        tf.check_supported(cfg)


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    attn_impl: str = "kernel"
    remat: bool = False
    remat_policy: str = "minimal"  # "minimal" (save nothing) | "dots"

    def init(self, seed: int = 0, device: DeviceLike = None,
             dtype: Optional[torch.dtype] = None):
        """Random weights drawn on ``device`` from a generator seeded with
        ``seed``, each tensor on its own. Matrices are stored in ``dtype``:
        by default the compute dtype (serving), ``torch.float32`` for
        training's masters (the reference's storage, cast per use); norms,
        biases and the recurrent models' mixers and decays are float32
        either way. ``device="meta"`` gives the structure without values."""
        c = self.cfg
        check_supported(c)
        dev = resolve_device(device)
        gen = (None if dev.type == "meta"
               else torch.Generator(device=dev).manual_seed(seed))
        dt = tf.compute_dtype(c) if dtype is None else dtype
        if c.family == "ssm":
            return rwkv_mod.init_rwkv(c, gen, dev, dt)
        if c.family == "hybrid":
            return zamba_mod.init_zamba(c, gen, dev, dt)
        return tf.init_transformer(c, gen, dev, dt)

    # ---------------- embeddings and positions ----------------
    def _embed(self, params, batch: Dict) -> torch.Tensor:
        if "embeds" in batch:  # modality stub (vlm / audio)
            return constrain(batch["embeds"].to(tf.compute_dtype(self.cfg)),
                             ("batch", "seq", "embed"))
        return tf.embed_tokens(params, self.cfg, batch["tokens"])

    def _positions(self, batch: Dict, B: int, S: int, device,
                   lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(1, S) text positions, or (B, 1) at decode (``lengths``); under
        M-RoPE ``positions3`` if given, else the text positions on all
        three streams ((1, S, 3) or (B, 1, 3); rows broadcast)."""
        a = self.cfg.attention
        if a is not None and a.rope == "mrope":
            if "positions3" in batch:
                return batch["positions3"]
            pos = (lengths[:, None] if lengths is not None
                   else torch.arange(S, device=device)[None])
            return pos[..., None].expand(*pos.shape, 3)
        if lengths is not None:
            return lengths[:, None]
        return torch.arange(S, device=device)[None, :]

    # ---------------- training ----------------
    def loss_fn(self, params, batch: Dict) -> Tuple[torch.Tensor, Dict]:
        """Mean next-token CE (over ``valid`` positions if given) plus the
        MoE aux loss; returns (loss, {"ce": loss, "aux": aux}), as the
        reference. batch: ``tokens`` or ``embeds``, ``labels`` (B, S)."""
        c = self.cfg
        x = self._embed(params, batch)
        B, S, _ = x.shape
        kw = dict(mode="train", remat=self.remat,
                  remat_policy=self.remat_policy)
        if c.family == "ssm":
            h, aux = rwkv_mod.rwkv_forward(params, c, x, impl=self.attn_impl,
                                           **kw)
            logits = rwkv_mod.rwkv_logits(params, h)
        else:
            forward = (zamba_mod.zamba_forward if c.family == "hybrid"
                       else tf.transformer_forward)
            h, aux = forward(params, c, x,
                             positions=self._positions(batch, B, S, x.device),
                             attn_impl=self.attn_impl, **kw)
            logits = tf.lm_logits(params, c, h)
        loss = cross_entropy(logits, batch["labels"], batch.get("valid"))
        loss = loss + aux
        return loss, {"ce": loss, "aux": aux}

    # ---------------- serving: prefill ----------------
    @torch.no_grad()
    def prefill(self, params, batch: Dict, max_len: int,
                cache: Optional[Dict] = None, slot: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
        """Full-sequence forward; returns (last-token logits (B,V), cache).

        With ``cache`` and ``slot``, the (single) prompt's K/V and
        recurrent states are written into that row of the shared cache in
        place and ``cache`` is returned; otherwise a fresh cache of
        ``max_len`` is built, as the reference does (None for an
        encoder-only model). A fresh cache may take a right-padded ragged
        batch: ``lengths`` (B,) in ``batch`` masks the padded keys
        (``kv_valid``), sets the cache's lengths and picks each row's last
        valid position's logits. RWKV6 and Mamba2 run their states over the
        padding, as the reference's do."""
        c = self.cfg
        x = self._embed(params, batch)
        B, S, _ = x.shape
        lengths = batch.get("lengths")
        if cache is not None and (B != 1 or lengths is not None):
            raise ValueError("in-place cache insertion takes one prompt")
        kv_valid = (None if lengths is None else
                    torch.arange(S, device=x.device)[None, :] < lengths[:, None])
        filled = S if lengths is None else lengths
        rows = slice(None) if cache is None else slice(slot, slot + 1)

        def last(h):   # each row's last valid position, (B, 1, D)
            if lengths is None:
                return h[:, -1:]
            return h[torch.arange(B, device=h.device),
                     torch.clamp(lengths.long() - 1, min=0)][:, None]

        if c.family == "ssm":
            h, states = rwkv_mod.rwkv_forward(params, c, x, mode="prefill",
                                              impl=self.attn_impl)
            if cache is None:
                cache = rwkv_mod.cache_from_states(states, filled)
            else:
                rwkv_mod.write_states(cache, rows, states, S)
            return rwkv_mod.rwkv_logits(params, last(h))[:, 0], cache
        positions = self._positions(batch, B, S, x.device)
        if c.family == "hybrid":
            h, pre = zamba_mod.zamba_forward(
                params, c, x, positions=positions, mode="prefill",
                kv_valid=kv_valid, attn_impl=self.attn_impl)
            if cache is None:
                cache = zamba_mod.fill_zamba_cache_from_prefill(
                    c, pre, filled, max_len, B)
            else:
                zamba_mod.write_prefill_to_zamba_cache(cache, rows, pre, S)
            with PROFILER.span("model.head"):
                return tf.lm_logits(params, c, last(h))[:, 0], cache
        if c.is_encoder_only:
            h, _ = tf.transformer_forward(params, c, x, positions=positions,
                                          mode="train", kv_valid=kv_valid,
                                          attn_impl=self.attn_impl)
            return tf.lm_logits(params, c, last(h))[:, 0], None
        h, pre = tf.transformer_forward(
            params, c, x, positions=positions, mode="prefill",
            kv_valid=kv_valid, attn_impl=self.attn_impl)
        if cache is None:
            cache = tf.fill_cache_from_prefill(
                c, pre["computed_k"], pre["computed_v"], filled, max_len)
        else:
            tf.write_prefill_to_cache(cache, rows, pre["computed_k"],
                                      pre["computed_v"], S)
        # last position logits only (serving does not need all logits)
        with PROFILER.span("model.head"):
            return tf.lm_logits(params, c, last(h))[:, 0], cache

    # ---------------- serving: one decode step ----------------
    @torch.no_grad()
    def decode_step(self, params, batch: Dict, cache: Dict
                    ) -> Tuple[torch.Tensor, Dict]:
        """batch: {"tokens": (B,1)} (+ ``positions3`` (B,1,3) under M-RoPE).
        Returns ((B,V), cache); the cache's K/V or recurrent states are
        updated in place."""
        c = self.cfg
        if c.is_encoder_only:
            raise ValueError(f"{c.name} is encoder-only: no decode")
        x = self._embed(params, batch)
        if c.family == "ssm":
            h, cache = rwkv_mod.rwkv_forward(params, c, x, mode="decode",
                                             cache=cache, impl=self.attn_impl)
            return rwkv_mod.rwkv_logits(params, h)[:, 0], \
                {**cache, "lengths": cache["lengths"] + 1}
        positions = self._positions(batch, x.shape[0], 1, x.device,
                                    lengths=cache["lengths"])
        forward = (zamba_mod.zamba_forward if c.family == "hybrid"
                   else tf.transformer_forward)
        h, new_cache = forward(params, c, x, positions=positions, mode="decode",
                               cache=cache, attn_impl=self.attn_impl)
        with PROFILER.span("model.head"):
            return tf.lm_logits(params, c, h)[:, 0], new_cache

    # ---------------- cache factory ----------------
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device: DeviceLike = None) -> Dict:
        c = self.cfg
        check_supported(c)
        if c.is_encoder_only:
            raise ValueError(f"{c.name} is encoder-only: no decode cache")
        dev = resolve_device(device)
        if c.family == "ssm":
            return rwkv_mod.init_rwkv_cache(c, batch, dev)
        if c.family == "hybrid":
            return zamba_mod.init_zamba_cache(c, batch, max_len, dev, dtype)
        return attn_mod.init_kv_cache(c.n_layers, batch, c.attention, max_len,
                                      dev, dtype)


def build_model(cfg: ModelConfig, attn_impl: str = "kernel",
                remat: bool = False, remat_policy: str = "minimal") -> Model:
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat_policy!r}")
    return Model(cfg=cfg, attn_impl=attn_impl, remat=remat,
                 remat_policy=remat_policy)

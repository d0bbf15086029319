"""PyTorch/CUDA port of ``repro``, the JAX reference package.

The port mirrors the reference's module paths (``repro_torch.models.attention``
is the counterpart of ``repro.models.attention``) and never imports JAX or the
reference package. Entry points run on the CUDA card unless the caller passes
``device="cpu"``; see ``repro_torch.device``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]

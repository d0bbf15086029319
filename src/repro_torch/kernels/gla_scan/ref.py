"""Plain PyTorch version of the GLA scan kernel: the exact token-by-token
scan.

Counterpart of ``repro/kernels/gla_scan/ref.py``. The wrapper runs it for
CPU tensors; the tests and ``chip_smoke.py`` hold the kernel against it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.linear_attention import gla_reference


def gla_scan_reference(q, k, v, log_w, u: Optional[torch.Tensor] = None,
                       mode: str = "ssd"):
    """Kernel layout (B, H, T, ·) -> delegates to the model-layer oracle
    (which uses (B, T, H, ·)). Returns (o (B, H, T, V), state (B, H, K, V))."""
    tr = lambda x: x.transpose(1, 2)
    o, s = gla_reference(tr(q), tr(k), tr(v), tr(log_w), u=u, mode=mode)
    return tr(o), s

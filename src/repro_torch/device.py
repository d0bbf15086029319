"""Device selection shared by the port's entry points.

Entry points take an explicit ``device``. ``None`` means the CUDA card; when
there is no card they raise instead of dropping to the CPU, so a run that
reports device numbers can never have measured the host by accident.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise when a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the host")
    return dev

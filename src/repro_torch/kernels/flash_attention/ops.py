"""Wrapper of the flash-attention prefill kernel (``csrc/flash_attention.cu``).

``flash_attention`` takes the model layout (q (B, S, H, D), k/v (B, S, KV, D))
and returns (B, S, H, D). On CPU tensors it runs the plain version
(``ref.attention_reference``); on CUDA tensors it launches the kernel or
raises. The C entry point picks the kernel by (dtype, head_dim): bf16 at
64, 80, 96, 112 and 128 runs the TMA + wgmma kernel (bound by operations: it
reaches the tensor cores' rate), bf16 at 16, 32 and 48 the mma.sync kernel,
float32 the FMA kernel. ``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_reference

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("flash_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i,
                                            ctypes.c_float, i, i, i, p]
        lib.flash_attention_fwd.restype = i
        lib.flash_attention_route.argtypes = [i, i, ctypes.POINTER(i)]
        lib.flash_attention_route.restype = ctypes.c_char_p
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def kernel_route(dtype: torch.dtype, head_dim: int):
    """(name, dynamic shared memory in bytes) of the kernel the C entry point
    runs for ``dtype`` and ``head_dim``: "wgmma", "mma.sync" or "fma"; name
    None where it refuses them. Builds the library (card machine only)."""
    smem = ctypes.c_int(0)
    name = _lib().flash_attention_route(DTYPE_CODES[dtype], head_dim,
                                        ctypes.byref(smem))
    return (name.decode() if name else None), smem.value


def _check(q, k, v, window):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    B, S, H, D = q.shape
    KV = k.shape[2]
    if k.shape[:2] != (B, S) or k.shape[3] != D or H % KV != 0:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do not "
                         "match as (B,S,H,D) / (B,S,KV,D) with KV | H")
    if D % 16 != 0 or D > 128:
        raise ValueError(f"head_dim {D} must be a multiple of 16 up to 128")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: need one of "
                        "float32, bfloat16 for all three")
    for name, x in (("q", q), ("k", k), ("v", v)):
        # TMA (and the 16-byte loads of the mma.sync kernel) take only
        # 16-byte aligned addresses and row strides
        if x.data_ptr() % 16 or any(
                st * x.element_size() % 16
                for st, n in zip(x.stride()[:-1], x.shape[:-1]) if n > 1):
            raise ValueError(f"{name}: data_ptr and strides must be multiples "
                             f"of 16 bytes, got {x.data_ptr() % 16} bytes off "
                             f"and strides {x.stride()}")
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError("q, k, v must lie on one CUDA device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None):
    """q: (B, S, H, D); k/v: (B, S, KV, D) (model layout). -> (B, S, H, D)."""
    if q.device.type == "cpu":
        tr = lambda x: x.transpose(1, 2)
        return tr(attention_reference(tr(q), tr(k), tr(v), causal=causal,
                                      window=window))
    _check(q, k, v, window)
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        code = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, H, k.shape[2], D, 1.0 / math.sqrt(D), int(causal),
            window or 0, DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "flash_attention",
                 lib.flash_attention_error_string(code))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

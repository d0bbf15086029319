"""Wrapper of the split-K decode-attention kernel
(``csrc/decode_attention.cu``).

``decode_attention`` takes the model layout (q (B, 1, H, D), caches
(B, W, KV, D), int32 lengths (B,)) and returns (B, 1, H, D). On CPU tensors
it runs the plain version (``ref.decode_attention_reference``); on CUDA
tensors it launches the kernel or raises. ``decode_attention.launches``
counts kernel launches (one per call: the split pass and its combine).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_reference

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (query dtype, cache dtype) pairs the kernel is built for
SUPPORTED = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
             (torch.float32, torch.bfloat16)}
CHUNK = 256   # cache slots per split (one CTA each)
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("decode_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.decode_attention_fwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i,
                                             i, i, i, i, ctypes.c_float, i, i,
                                             i, p]
        lib.decode_attention_fwd.restype = i
        lib.decode_attention_error_string.argtypes = [i]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(q, k_cache, v_cache, lengths, window):
    if q.ndim != 4 or q.shape[1] != 1 or k_cache.ndim != 4 \
            or k_cache.shape != v_cache.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} caches "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}")
    B, _, H, D = q.shape
    KV = k_cache.shape[2]
    if k_cache.shape[0] != B or k_cache.shape[3] != D or H % KV != 0:
        raise ValueError(f"q {tuple(q.shape)} and caches "
                         f"{tuple(k_cache.shape)} do not match as (B,1,H,D) / "
                         "(B,W,KV,D) with KV | H")
    if not 1 <= H // KV <= 8:
        raise ValueError(f"{H // KV} query heads per KV head: at most 8")
    if D % 16 != 0 or D > 128:
        raise ValueError(f"head_dim {D} must be a multiple of 16 up to 128")
    if (q.dtype, k_cache.dtype) not in SUPPORTED or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"dtypes q {q.dtype}, caches {k_cache.dtype}/"
                        f"{v_cache.dtype} are not supported")
    if lengths.dtype != torch.int32 or lengths.shape != (B,):
        raise TypeError("lengths must be int32 of shape (B,)")
    tensors = (q, k_cache, v_cache, lengths)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("q, caches and lengths must lie on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("q, caches and lengths must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("q and caches must be 16-byte aligned")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")


def decode_attention(q, k_cache, v_cache, lengths, *,
                     window: Optional[int] = None):
    """Model layout: q (B, 1, H, D); caches (B, W, KV, D); lengths (B,).
    Returns (B, 1, H, D)."""
    B, _, H, D = q.shape
    W, KV = k_cache.shape[1], k_cache.shape[2]
    if q.device.type == "cpu":
        out = decode_attention_reference(
            q.reshape(B, KV, H // KV, D), k_cache.transpose(1, 2),
            v_cache.transpose(1, 2), lengths, window=window)
        return out.reshape(B, 1, H, D)
    _check(q, k_cache, v_cache, lengths, window)
    G = H // KV
    n_split = -(-W // CHUNK)
    out = torch.empty_like(q)
    part_m = torch.empty((B, KV, n_split, G), dtype=torch.float32,
                         device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B, KV, n_split, G, D), dtype=torch.float32,
                           device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        code = lib.decode_attention_fwd(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), part_m.data_ptr(),
            part_l.data_ptr(), part_acc.data_ptr(), B, W, KV, G, D, CHUNK,
            n_split, 1.0 / math.sqrt(D), window or 0, DTYPE_CODES[q.dtype],
            DTYPE_CODES[k_cache.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "decode_attention",
                 lib.decode_attention_error_string(code))
    decode_attention.launches += 1
    return out


decode_attention.launches = 0

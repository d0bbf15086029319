"""Wrappers of the flash-attention kernels (``csrc/flash_attention.cu``).

``flash_attention`` (the prefill forward) takes the model layout
(q (B, S, H, D), k/v (B, S, KV, D)) and returns (B, S, H, D);
``flash_attention_fwd`` also returns each row's log-sum-exp (B, H, S)
float32, which ``flash_attention_bwd`` reads to compute (dq, dk, dv);
``FlashAttention`` is the ``torch.autograd.Function`` of the two, the
counterpart of the reference's custom-VJP ``_flash_core``. On CPU tensors
each runs its plain version (``ref``); on CUDA tensors it launches the
kernels or raises. The C forward picks its kernel by (dtype, head_dim): bf16
at every head dim (16 to 128 in steps of 16) runs the TMA + wgmma kernel
(its floor is the tensor cores' operations from D = 64 and the softmax's
exp2 below), float32 at
every head dim the TMA + wgmma kernel in TF32 with every operand split into
a hi and a lo part (3xTF32: three products a multiply, float32's precision
on the tensor cores). The backward is three launches a call (delta, dK/dV,
dQ, no atomics): TMA + wgmma kernels at every head dim, for bf16 and
(3xTF32) for float32.
``flash_attention.launches`` counts forward calls that launched (with or
without lse), ``flash_attention_bwd.launches`` backward calls.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (
    attention_backward_reference, attention_forward_reference,
    attention_reference)

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("flash_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                            ctypes.c_float, i, i, i, p]
        lib.flash_attention_fwd.restype = i
        lib.flash_attention_bwd.argtypes = [p] * 10 + [i] * 5 + [
            ctypes.c_float, i, i, i, p]
        lib.flash_attention_bwd.restype = i
        for route in (lib.flash_attention_route, lib.flash_attention_bwd_route):
            route.argtypes = [i, i, ctypes.POINTER(i)]
            route.restype = ctypes.c_char_p
        lib.flash_attention_tf32_plan.argtypes = [i, ctypes.POINTER(i)]
        lib.flash_attention_tf32_plan.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def kernel_route(dtype: torch.dtype, head_dim: int, backward: bool = False):
    """(name, dynamic shared memory in bytes) of the kernel the C forward
    (or, with ``backward``, the larger of the C backward's two tile
    kernels) runs for ``dtype`` and ``head_dim``: "wgmma" (bf16) or
    "wgmma.3xtf32" (float32), both ways at every head dim; name None where
    it refuses them. Builds the library (card machine only)."""
    smem = ctypes.c_int(0)
    lib = _lib()
    route = lib.flash_attention_bwd_route if backward else lib.flash_attention_route
    name = route(DTYPE_CODES[dtype], head_dim, ctypes.byref(smem))
    return (name.decode() if name else None), smem.value


TF32_PLAN_KEYS = ("fwd_keys", "fwd_stages", "dq_keys", "dq_stages",
                  "dkdv_keys", "dkdv_queries", "dkdv_stages", "fwd_smem",
                  "dq_smem", "dkdv_smem")


def tf32_plan(head_dim: int):
    """The float32 (3xTF32) kernels' tiles at ``head_dim``, as the library
    sizes them from its shared-memory budget: the forward's keys a tile and
    ring stages, dQ's keys a tile and stages, dK/dV's keys an item, queries
    a step and stages, and each kernel's dynamic shared memory in bytes; None where
    the head dim has no such kernels. Builds the library (card machine
    only)."""
    plan = (ctypes.c_int * len(TF32_PLAN_KEYS))()
    if _lib().flash_attention_tf32_plan(head_dim, plan) != 0:
        return None
    return dict(zip(TF32_PLAN_KEYS, plan))


def _check_aligned(**tensors):
    for name, x in tensors.items():
        # TMA takes only 16-byte aligned addresses and row strides
        if x.data_ptr() % 16 or any(
                st * x.element_size() % 16
                for st, n in zip(x.stride()[:-1], x.shape[:-1]) if n > 1):
            raise ValueError(f"{name}: data_ptr and strides must be multiples "
                             f"of 16 bytes, got {x.data_ptr() % 16} bytes off "
                             f"and strides {x.stride()}")


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
    _check_aligned(q=q, k=k, v=v)
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError("q, k, v must lie on one CUDA device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")


def _tr(x):
    return x.transpose(1, 2)


def _forward(q, k, v, causal: bool, window: Optional[int], with_lse: bool):
    """The kernel's (out, lse or None) on CUDA tensors."""
    _check(q, k, v, window)
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = _lib()
    with torch.cuda.device(q.device):
        code = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, S, H, k.shape[2], D, 1.0 / math.sqrt(D), int(causal),
            window or 0, DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "flash_attention",
                 lib.flash_attention_error_string(code))
    flash_attention.launches += 1
    return out, lse


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None):
    """q: (B, S, H, D); k/v: (B, S, KV, D) (model layout). -> (B, S, H, D)."""
    if q.device.type == "cpu":
        return _tr(attention_reference(_tr(q), _tr(k), _tr(v), causal=causal,
                                       window=window))
    return _forward(q, k, v, causal, window, with_lse=False)[0]


flash_attention.launches = 0


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None):
    """``flash_attention`` that also returns lse (B, H, S) float32, each
    row's natural-log sum of exp(q k^T / sqrt(D)) over its visible keys."""
    if q.device.type == "cpu":
        o, lse = attention_forward_reference(_tr(q), _tr(k), _tr(v),
                                             causal=causal, window=window)
        return _tr(o), lse
    return _forward(q, k, v, causal, window, with_lse=True)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: Optional[int] = None):
    """(dq, dk, dv) of ``flash_attention`` at (q, k, v) for the output
    gradient ``do``, from the forward's ``o`` and ``lse``
    (``flash_attention_fwd``). Model layout as the forward; dq, dk, dv in
    the inputs' dtype."""
    if q.device.type == "cpu":
        dq, dk, dv = attention_backward_reference(
            _tr(q), _tr(k), _tr(v), _tr(o), lse, _tr(do), causal=causal,
            window=window)
        return _tr(dq), _tr(dk), _tr(dv)
    _check(q, k, v, window)
    B, S, H, D = q.shape
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (B, H, S):
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)} and lse "
                         f"{tuple(lse.shape)} do not match q {tuple(q.shape)}")
    if o.dtype != q.dtype or do.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError(f"o, do must be {q.dtype} and lse float32, got "
                        f"{o.dtype}, {do.dtype}, {lse.dtype}")
    if not (o.device == do.device == lse.device == q.device):
        raise ValueError("o, do, lse must lie on q's device")
    _check_aligned(o=o, do=do)   # lse is read one float at a time
    if not (o.is_contiguous() and do.is_contiguous() and lse.is_contiguous()):
        raise ValueError("o, do, lse must be contiguous")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        code = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), B, S, H, k.shape[2], D,
            1.0 / math.sqrt(D), int(causal), window or 0, DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "flash_attention_bwd",
                 lib.flash_attention_error_string(code))
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward: the forward kernel writes lse
    beside the output, the backward kernels recompute P from it, so only
    q, k, v, out and lse are kept (O(S) per layer, not B H S^2 scores).
    ``FlashAttention.apply(q, k, v, causal, window)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        # autograd may hand over a non-contiguous or expanded gradient
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None

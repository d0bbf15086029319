"""Wrapper of the MoE dispatch and combine kernels (``csrc/moe_dispatch.cu``).

``moe_dispatch(x, idx, E, C)`` takes a layer's input x (B, S, D) and its
experts idx (B, S, K) and returns the capacity buffer (B, E, C, D), each
assignment's ``slot`` and ``kept`` (B, S*K) in flat (s, k) order and each
expert's assignments ``size`` (B, E): on the card three launches (count,
rank, fill), two where a row's S*K assignments fit one rank block.
``moe_combine(out_buf, slot, kept, gates, out_dtype)`` returns each token's
gate-weighted sum of its kept rows of ``out_buf``, summed in float32 in k
order and written once in ``out_dtype`` (B, S, D): one launch. On CPU
tensors both run the plain versions (``ref.py``); on CUDA tensors they
launch the kernels or raise.

With gradients on, each goes through an autograd Function whose backward
reuses the kernels: x's gradient is a combine of the buffer's gradient with
unit gates over the kept slots; ``out_buf``'s is a dispatch of gate x the
output's gradient into each kept slot, zeros elsewhere, and in the same
launch each gate's gradient, the dot product of its kept row with the
output's gradient.

The kernels move rows in 16-byte words: on the card each row of x,
``out_buf`` and the output's gradient has to be D * element size bytes, a
multiple of 16 (D a multiple of 8 in bf16, of 4 in float32), at an address
and strides that are multiples of 16; the wrapper makes the last dimension
contiguous and raises, naming D, where the rest does not hold.

Each counter counts the calls that launched its wrapper's kernels on the
card: ``moe_dispatch.launches`` and ``moe_combine.launches`` one each a
served MoE layer, the dispatch's backward (a combine) one on
``moe_combine.launches``, the combine's backward (its own two kernels) one
on ``moe_combine.grad_launches``. Fake tensors (the dry-run's abstract trace) take the plain
versions, as attention takes its plain path there: the kernels have no
fake form.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.autograd.function import once_differentiable

from repro_torch.kernels import _build
from repro_torch.kernels.moe_dispatch.ref import (moe_combine_grad_reference,
                                                  moe_combine_reference,
                                                  moe_dispatch_reference)

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("moe_dispatch")
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.moe_dispatch_fwd.argtypes = [p, q, q, i, p, q, q, q, i, i, i, i, i,
                                         i, p, p, p, p, p, p, p]
        lib.moe_combine_fwd.argtypes = [p, q, q, q, i, p, p, p, q, q, q, i, i,
                                        i, i, i, p, i, p]
        lib.moe_combine_bwd.argtypes = [p, q, q, i, p, p, p, q, q, q, p, q, q,
                                        q, i, i, i, i, i, i, p, p, p, p]
        for fn in (lib.moe_dispatch_fwd, lib.moe_combine_fwd,
                   lib.moe_combine_bwd):
            fn.restype = i
        for fn in (lib.moe_dispatch_chunk, lib.moe_dispatch_max_experts,
                   lib.moe_dispatch_max_top_k):
            fn.argtypes, fn.restype = [], i
        lib.moe_dispatch_error_string.argtypes = [i]
        lib.moe_dispatch_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=None)
def limits() -> Tuple[int, int, int]:
    """(assignments a row's count and rank block takes, most experts, most
    experts a token) as the library reports them: a row of more assignments
    than the first takes the three-launch route. Builds the library (card
    machine only)."""
    lib = _lib()
    return (lib.moe_dispatch_chunk(), lib.moe_dispatch_max_experts(),
            lib.moe_dispatch_max_top_k())


def _launch(what: str, fn, dev: torch.device, *args) -> None:
    args = (*args, torch._C._cuda_getCurrentRawStream(dev.index))
    if dev.index == torch.cuda.current_device():
        code = fn(*args)
    else:
        with torch.cuda.device(dev):
            code = fn(*args)
    if code:
        _build.check(code, what, _lib().moe_dispatch_error_string(code))


def _device(*tensors) -> torch.device:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("the MoE dispatch's tensors must lie on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _plain(*tensors) -> bool:
    """Whether the plain versions run: for CPU tensors, and for fake ones
    (the dry-run's abstract trace, where the kernels have no fake form and
    the plain gathers give the shapes and operations, as attention's plain
    path does there)."""
    return _device(*tensors).type == "cpu" or any(is_fake(t) for t in tensors)


def _rows16(t: torch.Tensor, what: str) -> Tuple[torch.Tensor, tuple]:
    """(t with its last dimension contiguous, its strides but the last, 0
    for a dimension of one). Raises unless its rows, their address and
    those strides are multiples of 16 bytes: the kernels move rows in
    16-byte words."""
    if t.stride(-1) != 1 and t.shape[-1] > 1:
        t = t.contiguous()
    es = t.element_size()
    strides = tuple(st if n > 1 else 0 for n, st in zip(t.shape[:-1], t.stride()))
    if (t.shape[-1] * es) % 16 or t.data_ptr() % 16 \
            or any(st * es % 16 for st in strides):
        raise ValueError(
            f"{what}: rows of D = {t.shape[-1]} {t.dtype} at address "
            f"{t.data_ptr():#x}, strides {t.stride()}: the kernels move rows "
            "in 16-byte words, so rows, address and strides must be "
            "multiples of 16 bytes")
    return t, strides


def _dispatch(x: torch.Tensor, idx: torch.Tensor, E: int, C: int):
    if x.ndim != 3 or idx.ndim != 3 or idx.shape[:2] != x.shape[:2]:
        raise ValueError(f"bad shapes x {tuple(x.shape)} idx {tuple(idx.shape)}: "
                         "need (B, S, D) and (B, S, K)")
    if idx.dtype != torch.int64:
        raise TypeError(f"idx must be int64, not {idx.dtype}")
    if _plain(x, idx):
        return moe_dispatch_reference(x, idx, E, C)
    lib, (chunk, max_e, _) = _lib(), limits()
    if not 1 <= E <= max_e:
        raise ValueError(f"E = {E} experts: the rank kernel's shared-memory "
                         f"table holds 1 to {max_e}")
    if C < 1:
        raise ValueError(f"capacity C = {C}: need at least 1")
    B, S, D = x.shape
    K = idx.shape[-1]
    x, (sxb, sxs) = _rows16(x, "moe_dispatch's x")
    SK = S * K
    chunks = -(-SK // chunk)
    empty = functools.partial(torch.empty, device=x.device)
    counts = empty((B, chunks, E), dtype=torch.int32) if chunks > 1 else None
    src = empty((B, E * C), dtype=torch.int32)
    buf = empty((B, E, C, D), dtype=x.dtype)
    slot, kept = empty((B, SK), dtype=torch.int64), empty((B, SK), dtype=torch.bool)
    size = empty((B, E), dtype=torch.int64)
    _launch("moe_dispatch", lib.moe_dispatch_fwd, x.device, x.data_ptr(),
            sxb, sxs, x.element_size(), idx.data_ptr(),
            *idx.stride(), B, S, K, E, C, D,
            None if counts is None else counts.data_ptr(), src.data_ptr(),
            buf.data_ptr(), slot.data_ptr(), kept.data_ptr(), size.data_ptr())
    moe_dispatch.launches += 1
    return buf, slot, kept, size


def _combine(out_buf: torch.Tensor, slot: torch.Tensor, kept: torch.Tensor,
             gates: Optional[torch.Tensor], out_dtype: torch.dtype, K: int):
    """gates None: unit gates (the dispatch's backward)."""
    B, E, C, D = out_buf.shape
    if slot.shape != kept.shape or slot.ndim != 2 or slot.shape[0] != B \
            or slot.shape[1] % K:
        raise ValueError(f"bad shapes slot {tuple(slot.shape)} kept "
                         f"{tuple(kept.shape)} for B = {B}, K = {K}")
    S = slot.shape[1] // K
    if gates is not None and gates.shape != (B, S, K):
        raise ValueError(f"gates {tuple(gates.shape)}: need {(B, S, K)}")
    if _plain(out_buf, slot, kept, *([] if gates is None else [gates])):
        if gates is None:
            gates = torch.ones((B, S, K), dtype=torch.float32,
                               device=out_buf.device)
        return moe_combine_reference(out_buf, slot, kept, gates).to(out_dtype)
    if out_buf.dtype not in DTYPE_CODES or out_dtype not in DTYPE_CODES:
        raise TypeError(f"the combine takes float32 or bfloat16, not "
                        f"{out_buf.dtype} -> {out_dtype}")
    lib, max_k = _lib(), limits()[2]
    if K > max_k:
        raise ValueError(f"K = {K} experts a token: the combine stages at most "
                         f"{max_k}")
    out_buf, ob_strides = _rows16(out_buf, "moe_combine's out_buf")
    slot, kept = slot.contiguous(), kept.contiguous()
    gstride = (0, 0, 0)
    if gates is not None:
        gates = gates.float()
        gstride = gates.stride()
    dev = out_buf.device
    out = torch.empty((B, S, D), dtype=out_dtype, device=dev)
    _launch("moe_combine", lib.moe_combine_fwd, dev, out_buf.data_ptr(),
            *ob_strides, DTYPE_CODES[out_buf.dtype], slot.data_ptr(),
            kept.data_ptr(), None if gates is None else gates.data_ptr(),
            *gstride, B, S, K, C, D, out.data_ptr(), DTYPE_CODES[out_dtype])
    moe_combine.launches += 1
    return out


def _combine_grad(grad_out, out_buf, slot, kept, gates, want_gates: bool):
    """(grad of out_buf, grad of gates or None)."""
    if _plain(grad_out, out_buf, slot, kept, gates):
        grad_buf, grad_gates = moe_combine_grad_reference(grad_out, out_buf,
                                                          slot, kept, gates)
        return grad_buf, grad_gates if want_gates else None
    B, E, C, D = out_buf.shape
    S, K = gates.shape[1], gates.shape[2]
    lib = _lib()
    out_buf, ob_strides = _rows16(out_buf, "moe_combine's out_buf")
    grad_out, go_strides = _rows16(grad_out.to(out_buf.dtype),
                                   "moe_combine's output gradient")
    slot, kept, gates = slot.contiguous(), kept.contiguous(), gates.float()
    dev = out_buf.device
    src = torch.full((B, E * C), -1, dtype=torch.int32, device=dev)
    grad_buf = torch.empty((B, E, C, D), dtype=out_buf.dtype, device=dev)
    grad_gates = (torch.zeros((B, S, K), dtype=torch.float32, device=dev)
                  if want_gates else None)
    _launch("moe_combine backward", lib.moe_combine_bwd, dev,
            grad_out.data_ptr(), *go_strides, DTYPE_CODES[out_buf.dtype],
            slot.data_ptr(), kept.data_ptr(), gates.data_ptr(),
            *gates.stride(), out_buf.data_ptr(), *ob_strides, B, S, K, E, C,
            D, src.data_ptr(), grad_buf.data_ptr(),
            None if grad_gates is None else grad_gates.data_ptr())
    moe_combine.grad_launches += 1
    return grad_buf, grad_gates


class MoEDispatch(torch.autograd.Function):
    """``moe_dispatch`` with x's gradient: a combine of the buffer's
    gradient with unit gates over the kept slots."""

    @staticmethod
    def forward(ctx, x, idx, E, C):
        buf, slot, kept, size = _dispatch(x, idx, E, C)
        ctx.mark_non_differentiable(slot, kept, size)
        ctx.save_for_backward(slot, kept)
        ctx.x_dtype, ctx.K = x.dtype, idx.shape[-1]
        return buf, slot, kept, size

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_buf, *_):
        slot, kept = ctx.saved_tensors
        return (_combine(grad_buf, slot, kept, None, ctx.x_dtype, ctx.K), None,
                None, None)


class MoECombine(torch.autograd.Function):
    """``moe_combine`` with the gradients of ``out_buf`` and ``gates``, one
    launch on the card."""

    @staticmethod
    def forward(ctx, out_buf, slot, kept, gates, out_dtype):
        ctx.save_for_backward(out_buf, slot, kept, gates)
        return _combine(out_buf, slot, kept, gates, out_dtype, gates.shape[-1])

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        out_buf, slot, kept, gates = ctx.saved_tensors
        grad_buf, grad_gates = _combine_grad(grad_out, out_buf, slot, kept,
                                             gates, ctx.needs_input_grad[3])
        return grad_buf, None, None, grad_gates, None


def moe_dispatch(x: torch.Tensor, idx: torch.Tensor, E: int, C: int):
    """x (B, S, D), idx (B, S, K) int64 experts in [0, E) on one device ->
    (buf (B, E, C, D) in x's dtype, slot (B, S*K) int64, kept (B, S*K)
    bool, size (B, E) int64), bit for bit the plain version's."""
    if torch.is_grad_enabled() and x.requires_grad:
        return MoEDispatch.apply(x, idx, E, C)
    return _dispatch(x, idx, E, C)


def moe_combine(out_buf: torch.Tensor, slot: torch.Tensor, kept: torch.Tensor,
                gates: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """out_buf (B, E, C, D), the dispatch's slot and kept (B, S*K), gates
    (B, S, K) -> (B, S, D) in ``out_dtype``: each token's kept rows times
    their gates, summed over k in float32."""
    if gates.ndim != 3:
        raise ValueError(f"gates {tuple(gates.shape)}: need (B, S, K)")
    if torch.is_grad_enabled() and (out_buf.requires_grad or gates.requires_grad):
        return MoECombine.apply(out_buf, slot, kept, gates, out_dtype)
    return _combine(out_buf, slot, kept, gates, out_dtype, gates.shape[-1])


moe_dispatch.launches = 0
moe_combine.launches = 0
moe_combine.grad_launches = 0

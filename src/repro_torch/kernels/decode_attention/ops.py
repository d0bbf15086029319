"""Wrapper of the decode-attention kernels (``csrc/decode_attention.cu``).

``decode_attention`` takes the model layout (q (B, 1, H, D), caches
(B, W, KV, D), int32 lengths (B,)) and returns (B, 1, H, D). On CPU tensors
it runs the plain version (``ref.decode_attention_reference``); on CUDA
tensors it launches the kernel or raises. The C entry point picks the kernel
by dtype: bf16 q with a bf16 cache runs the ``mma.sync`` kernel (tensor-core
tiles over a ``cp.async`` ring), a float32 q with a float32 or bf16 cache
the ``bulk.fma`` kernel (FMA products over a ring of 32-slot tiles that
TMA fills); each folds its combine in, so a call is one launch. ``decode_attention.launches`` counts calls that launched (one per
call, whichever kernel ran).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_reference

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (query dtype, cache dtype) pairs the library is built for
SUPPORTED = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
             (torch.float32, torch.bfloat16)}
PASS = 64          # slots one CTA of the mma.sync kernel covers per pass
MIN_CHUNK = 128    # at least two passes (four bulk.fma tiles) per split
MAX_SPLIT = 256    # either kernel's combine holds this many splits
_LIB = None
_SMS = {}          # device index -> SM count
_COUNTERS = {}     # device index -> zeroed int32 tickets of the combine
_RETIRED = []      # outgrown ticket buffers, kept for graphs that captured them


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("decode_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.decode_attention_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i,
                                             i, i, i, ctypes.c_float, i, i, i,
                                             p]
        lib.decode_attention_fwd.restype = i
        lib.decode_attention_route.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.decode_attention_route.restype = ctypes.c_char_p
        lib.decode_attention_error_string.argtypes = [i]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=None)
def kernel_route(q_dtype: torch.dtype, cache_dtype: torch.dtype,
                 head_dim: int) -> Tuple[Optional[str], int]:
    """(name, dynamic shared memory in bytes) of the kernel the C entry point
    runs for these dtypes and ``head_dim``: "mma.sync" (bf16 q and cache) or
    "bulk.fma" (float32 q; its shared memory at 8 query heads a KV head);
    name None where it refuses them. Builds the library (card machine
    only)."""
    smem = ctypes.c_int(0)
    name = _lib().decode_attention_route(DTYPE_CODES[q_dtype],
                                         DTYPE_CODES[cache_dtype], head_dim,
                                         ctypes.byref(smem))
    return (name.decode() if name else None), smem.value


def split_plan(W: int, KV: int, sms: int = 132) -> Tuple[int, int]:
    """(chunk, n_split) of either kernel: each (sequence, KV head)'s cache
    of W slots is cut into n_split splits of ``chunk`` slots, one CTA each.
    A function of the shapes only: the lengths live on the card, and
    reading them would sync. Not of the batch either, so that a sequence's
    result does not depend on how many others share its launch (an engine
    with 8 slots and a loop over one sequence agree to the bit). One
    sequence at its full window gets about sms / 2 CTAs (KV of them per
    split), so 8 served slots give each SM about 4, or 2 where half the
    splits lie past their sequence's valid slots; a CTA whose split holds
    no valid slot reads its sequence's length and exits. A chunk is a
    multiple of PASS (an mma.sync CTA's pass; two of the bulk.fma kernel's
    32-slot tiles; rounding up may drop a split) and at least MIN_CHUNK
    (four bulk.fma tiles: a tile for each of its three consumer warps);
    there are at most MAX_SPLIT splits. At Llama-3-8B's decode shape (W =
    4096, KV = 8) a split is 512 slots: 256 KB of float32 K and V rows."""
    want = -(-sms // (2 * KV))
    chunk = max(-(-W // want), -(-W // MAX_SPLIT), MIN_CHUNK)
    chunk = -(-chunk // PASS) * PASS
    return chunk, -(-W // chunk)


def _check(q, k_cache, v_cache, lengths, window):
    qs, ks = q.shape, k_cache.shape
    if len(qs) != 4 or qs[1] != 1 or len(ks) != 4 or ks != v_cache.shape:
        raise ValueError(f"bad shapes q {tuple(qs)} caches "
                         f"{tuple(ks)}/{tuple(v_cache.shape)}")
    B, _, H, D = qs
    KV = ks[2]
    if ks[0] != B or ks[3] != D or H % KV != 0:
        raise ValueError(f"q {tuple(qs)} and caches {tuple(ks)} do not match "
                         "as (B,1,H,D) / (B,W,KV,D) with KV | H")
    if not 1 <= H // KV <= 8:
        raise ValueError(f"{H // KV} query heads per KV head: at most 8")
    if D % 16 != 0 or D > 128:
        raise ValueError(f"head_dim {D} must be a multiple of 16 up to 128")
    if (q.dtype, k_cache.dtype) not in SUPPORTED or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"dtypes q {q.dtype}, caches {k_cache.dtype}/"
                        f"{v_cache.dtype} are not supported")
    if lengths.dtype != torch.int32 or lengths.shape != (B,):
        raise TypeError("lengths must be int32 of shape (B,)")
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        # cp.async, TMA and the kernels' vector loads take 16-byte aligned rows
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: data_ptr must be a multiple of 16 "
                             f"bytes, got {x.data_ptr() % 16} bytes off")
    dev = q.device
    if dev.type != "cuda" or not (
            dev == k_cache.device == v_cache.device == lengths.device):
        raise ValueError("q, caches and lengths must lie on one CUDA device")
    if not (q.is_contiguous() and k_cache.is_contiguous()
            and v_cache.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("q, caches and lengths must be contiguous")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")


def _counters(device: torch.device, n: int) -> int:
    """Address of at least ``n`` zeroed int32 tickets on ``device``. The
    kernel leaves them zero, so one buffer serves every launch in stream
    order; a buffer that is outgrown stays allocated, since a CUDA graph may
    hold its address."""
    buf = _COUNTERS.get(device.index)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("decode_attention: call it once at this batch "
                               "size before capturing it in a CUDA graph")
        if buf is not None:
            _RETIRED.append(buf)
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[device.index] = buf
    return buf.data_ptr()


def _sms(device: torch.device) -> int:
    n = _SMS.get(device.index)
    if n is None:
        n = _SMS[device.index] = \
            torch.cuda.get_device_properties(device).multi_processor_count
    return n


def decode_attention(q, k_cache, v_cache, lengths, *,
                     window: Optional[int] = None):
    """Model layout: q (B, 1, H, D); caches (B, W, KV, D); lengths (B,).
    Returns (B, 1, H, D).

    On the card, calls on one device (bf16 and float32 alike) share one
    buffer of the combine's tickets, which each launch leaves at zero: they
    must run in order, on one stream or on streams ordered by events. Two
    such calls that overlap (two unordered streams, or two CUDA graphs of
    this call replayed at once) take each other's tickets and may return an
    unfinished output with no error."""
    B, _, H, D = q.shape
    W, KV = k_cache.shape[1], k_cache.shape[2]
    if q.device.type == "cpu":
        out = decode_attention_reference(
            q.reshape(B, KV, H // KV, D), k_cache.transpose(1, 2),
            v_cache.transpose(1, 2), lengths, window=window)
        return out.reshape(B, 1, H, D)
    _check(q, k_cache, v_cache, lengths, window)
    G = H // KV
    dev = q.device
    chunk, n_split = split_plan(W, KV, _sms(dev))
    counters = _counters(dev, B * KV)
    out = torch.empty_like(q)
    scratch = torch.empty(B * KV * n_split * G * (D + 2), dtype=torch.float32,
                          device=dev)
    args = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), scratch.data_ptr(), counters,
            B, W, KV, G, D, chunk, n_split, 1.0 / math.sqrt(D), window or 0,
            DTYPE_CODES[q.dtype], DTYPE_CODES[k_cache.dtype])
    # the raw stream accessor builds no torch.cuda.Stream, which cost more
    # host time than any other step of this wrapper
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    lib = _lib()
    if dev.index == torch.cuda.current_device():
        code = lib.decode_attention_fwd(*args, stream)
    else:
        with torch.cuda.device(dev):
            code = lib.decode_attention_fwd(*args, stream)
    if code:
        _build.check(code, "decode_attention",
                     lib.decode_attention_error_string(code))
    decode_attention.launches += 1
    return out


decode_attention.launches = 0

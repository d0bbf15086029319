"""Wrapper of the chunked gated-linear-attention scan kernel
(``csrc/gla_scan.cu``).

``gla_scan`` takes the model layout (q/k/log_w (B, T, H, K), v (B, T, H, V),
u (H, K) or None) and returns (o (B, T, H, V) in v's dtype, final state
(B, H, K, V) float32), scanning from a zero state. On CPU tensors it runs
the plain version (``ref.gla_scan_reference``); on CUDA tensors it launches
the kernels or raises. Both dtypes run three launches on tensor cores
(chunk-local states, a prefix over chunks, chunk outputs;
``csrc/gla_scan.cu``) with a float32 scratch of chunk states that this
wrapper allocates at the size the library reports; the C entry point picks
the kernels by dtype: bf16 q, k and v take their products as bf16 pairs
(route "mma"), float32 ones as TF32 pairs (3xTF32, route "mma.3xtf32").
``gla_scan.launches`` counts calls that launched (one per call, three
kernels).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gla_scan.ref import gla_scan_reference

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MODES = ("rwkv", "ssd")
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("gla_scan")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gla_scan_fwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i,
                                     i, p]
        lib.gla_scan_fwd.restype = i
        lib.gla_scan_route.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.gla_scan_route.restype = ctypes.c_char_p
        lib.gla_scan_chunk_tokens.argtypes = [i]
        lib.gla_scan_chunk_tokens.restype = i
        lib.gla_scan_scratch_floats.argtypes = [i, i, i, i, i, i]
        lib.gla_scan_scratch_floats.restype = ctypes.c_longlong
        lib.gla_scan_error_string.argtypes = [i]
        lib.gla_scan_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=None)
def kernel_route(dtype: torch.dtype, K: int, V: int) -> Tuple[Optional[str], int]:
    """(name, dynamic shared memory of its largest CTA in bytes) of the
    kernels the C entry point runs for q/k/v of ``dtype`` and widths K, V:
    "mma" (bf16) or "mma.3xtf32" (float32); name None where it refuses them.
    Builds the library (card machine only)."""
    smem = ctypes.c_int(0)
    name = _lib().gla_scan_route(DTYPE_CODES[dtype], K, V, ctypes.byref(smem))
    return (name.decode() if name else None), smem.value


@functools.lru_cache(maxsize=None)
def chunk_tokens(dtype: torch.dtype) -> int:
    """Tokens per chunk tile of the kernels that q/k/v of ``dtype`` run, as
    the library reports it (64 for both dtypes). Builds the library (card
    machine only)."""
    return _lib().gla_scan_chunk_tokens(DTYPE_CODES[dtype])


def scratch_floats(dtype: torch.dtype, B: int, T: int, H: int, K: int,
                   V: int) -> int:
    """Floats of the scratch the kernels for q/k/v of ``dtype`` need, as the
    library reports it: a (K, V) state and K decays per (batch, head,
    chunk), for both dtypes. Builds the library (card machine only)."""
    n = _lib().gla_scan_scratch_floats(DTYPE_CODES[dtype], B, T, H, K, V)
    if n < 0:
        raise ValueError(f"no gla_scan kernel for {dtype} K={K} V={V}")
    return n


def _check(q, k, v, log_w, u, mode):
    if q.ndim != 4 or k.shape != q.shape or log_w.shape != q.shape \
            or v.ndim != 4 or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} log_w {tuple(log_w.shape)}: need "
                         "(B,T,H,K) for q/k/log_w and (B,T,H,V) for v")
    B, T, H, K = q.shape
    V = v.shape[3]
    if T < 1:
        raise ValueError("empty sequence")
    for name, n in (("K", K), ("V", V)):
        if n % 16 != 0 or not 16 <= n <= 64:
            raise ValueError(f"{name}={n} must be a multiple of 16 up to 64")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: need one of "
                        "float32, bfloat16 for q, k and v")
    if log_w.dtype not in DTYPE_CODES:
        raise TypeError(f"log_w dtype {log_w.dtype}: need float32 or bfloat16")
    if mode == "rwkv":
        if u is None or u.shape != (H, K) or u.dtype not in DTYPE_CODES:
            raise ValueError(f"mode 'rwkv' needs u of shape {(H, K)} in "
                             "float32 or bfloat16")
    for name, x in (("q", q), ("k", k), ("v", v)):
        # the kernels copy rows with 16-byte cp.async
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: data_ptr must be a multiple of 16 "
                             f"bytes, got {x.data_ptr() % 16} bytes off")
    tensors = [q, k, v, log_w] + ([u] if u is not None else [])
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("q, k, v, log_w and u must lie on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("q, k, v, log_w and u must be contiguous")


def gla_scan(q, k, v, log_w, u: Optional[torch.Tensor] = None,
             mode: str = "ssd", chunk: int = 128):
    """Model layout q/k/log_w: (B, T, H, K); v: (B, T, H, V).
    Returns (o (B, T, H, V), final_state (B, H, K, V)).

    ``chunk`` is kept for the reference's signature: the kernels use their
    own chunk tiles (``csrc/gla_scan.cu``), and the plain version scans token
    by token; the chunk changes rounding only."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if q.device.type == "cpu":
        tr = lambda x: x.transpose(1, 2)
        o, s = gla_scan_reference(tr(q), tr(k), tr(v), tr(log_w), u=u,
                                  mode=mode)
        return tr(o), s
    _check(q, k, v, log_w, u, mode)
    B, T, H, K = q.shape
    V = v.shape[3]
    dev = q.device
    # float32 decay and bonus: a bf16 log_w or u upcasts exactly
    lw = log_w.float()
    uf = u.float() if u is not None else None
    o = torch.empty_like(v)
    state = torch.empty((B, H, K, V), dtype=torch.float32, device=dev)
    scratch = torch.empty(scratch_floats(q.dtype, B, T, H, K, V),
                          dtype=torch.float32, device=dev)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
            uf.data_ptr() if uf is not None else None, o.data_ptr(),
            state.data_ptr(), scratch.data_ptr(),
            B, T, H, K, V, int(mode == "rwkv"), DTYPE_CODES[q.dtype],
            torch._C._cuda_getCurrentRawStream(dev.index))
    lib = _lib()
    if dev.index == torch.cuda.current_device():
        code = lib.gla_scan_fwd(*args)
    else:
        with torch.cuda.device(dev):
            code = lib.gla_scan_fwd(*args)
    if code:
        _build.check(code, "gla_scan", lib.gla_scan_error_string(code))
    gla_scan.launches += 1
    return o, state


gla_scan.launches = 0

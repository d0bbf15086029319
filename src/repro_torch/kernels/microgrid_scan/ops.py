"""Wrapper of the microgrid scan kernel (``csrc/microgrid_scan.cu``).

``microgrid_scan`` takes (B, T) float32 load, solar and carbon-intensity
traces and the eleven folded constants of the co-simulation
(``CONSTANTS``), and returns the seven per-step traces as one (7, B, T)
float32 tensor in ``ref.TRACE_KEYS`` order. On CPU tensors it runs the
plain step loop (``ref.microgrid_scan_reference``); on CUDA tensors it
launches the kernel or raises. ``microgrid_scan.launches`` counts calls that
launched (one launch per call; T = 0 launches nothing).
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.microgrid_scan.ref import (TRACE_KEYS,
                                                     microgrid_scan_reference)

#: the constants, in the order the kernel and the plain loop take them
CONSTANTS = ("soc_init_wh", "soc_hi", "soc_lo", "max_chg", "max_dis_w",
             "k_room", "k_avail", "k_charge", "k_discharge", "k_emis",
             "k_soc")
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("microgrid_scan")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.microgrid_scan_fwd.argtypes = [p, p, p, p, i, i] \
            + [f] * len(CONSTANTS) + [p]
        lib.microgrid_scan_fwd.restype = i
        lib.microgrid_scan_window.argtypes = []
        lib.microgrid_scan_window.restype = i
        lib.microgrid_scan_error_string.argtypes = [i]
        lib.microgrid_scan_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def window_steps() -> int:
    """Steps of the inputs the kernel stages per shared-memory window, as
    the library reports it. Builds the library (card machine only)."""
    return _lib().microgrid_scan_window()


def _check(load_w, solar_w, ci, constants):
    if load_w.ndim != 2 or solar_w.shape != load_w.shape \
            or ci.shape != load_w.shape:
        raise ValueError(f"bad shapes load {tuple(load_w.shape)} solar "
                         f"{tuple(solar_w.shape)} ci {tuple(ci.shape)}: need "
                         "one (B, T) shape")
    if len(constants) != len(CONSTANTS):
        raise ValueError(f"need the {len(CONSTANTS)} constants {CONSTANTS}, "
                         f"got {len(constants)}")
    tensors = (load_w, solar_w, ci)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("load, solar and ci must be float32")
    if any(t.device != load_w.device for t in tensors):
        raise ValueError("load, solar and ci must lie on one device")
    if load_w.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {load_w.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("load, solar and ci must be contiguous")


def microgrid_scan(load_w, solar_w, ci,
                   constants: Sequence[float]) -> torch.Tensor:
    """load_w, solar_w, ci: (B, T) float32 on one device; ``constants`` the
    eleven float32 constants in ``CONSTANTS`` order. Returns the traces
    (7, B, T) float32 there, in ``TRACE_KEYS`` order."""
    _check(load_w, solar_w, ci, constants)
    if load_w.device.type == "cpu":
        return microgrid_scan_reference(load_w, solar_w, ci, constants)
    B, T = load_w.shape
    dev = load_w.device
    out = torch.empty((len(TRACE_KEYS), B, T), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = _lib()
    args = (load_w.data_ptr(), solar_w.data_ptr(), ci.data_ptr(),
            out.data_ptr(), B, T, *(float(c) for c in constants),
            torch._C._cuda_getCurrentRawStream(dev.index))
    if dev.index == torch.cuda.current_device():
        code = lib.microgrid_scan_fwd(*args)
    else:
        with torch.cuda.device(dev):
            code = lib.microgrid_scan_fwd(*args)
    if code:
        _build.check(code, "microgrid_scan",
                     lib.microgrid_scan_error_string(code))
    microgrid_scan.launches += 1
    return out


microgrid_scan.launches = 0

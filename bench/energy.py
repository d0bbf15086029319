"""The card's energy over a window: NVML's cumulative energy counter, read
through ``ctypes`` from NVML's ``libnvidia-ml.so.1``, or, where that
call fails, ``power.draw`` sampled by ``nvidia-smi`` through the window and
integrated. Where neither answers, the run fails: no energy is guessed.
"""
from __future__ import annotations

import ctypes
import subprocess
import threading
import time
from typing import List, Optional, Tuple


class _NVML:
    """The counter of the card that CUDA calls device 0."""

    def __init__(self, uuid: Optional[str]):
        lib = ctypes.CDLL("libnvidia-ml.so.1")
        handle_p = ctypes.POINTER(ctypes.c_void_p)
        for fn, args in (("nvmlInit_v2", []), ("nvmlShutdown", []),
                         ("nvmlDeviceGetHandleByUUID", [ctypes.c_char_p, handle_p]),
                         ("nvmlDeviceGetHandleByIndex_v2", [ctypes.c_uint, handle_p]),
                         ("nvmlDeviceGetTotalEnergyConsumption",
                          [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)])):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        self._check(lib.nvmlInit_v2(), "nvmlInit_v2")
        self.lib = lib
        self.handle = ctypes.c_void_p()
        code = (-1 if uuid is None else lib.nvmlDeviceGetHandleByUUID(
            uuid.encode(), ctypes.byref(self.handle)))
        if code != 0:
            print(f"energy: no NVML handle for {uuid} ({code}); taking "
                  "NVML's device 0")
            code = lib.nvmlDeviceGetHandleByIndex_v2(0, ctypes.byref(self.handle))
        self._check(code, "nvmlDeviceGetHandle")
        self.joules()

    @staticmethod
    def _check(code: int, what: str):
        if code != 0:
            raise OSError(f"{what} returned NVML error {code}")

    def joules(self) -> float:
        mj = ctypes.c_ulonglong()
        self._check(self.lib.nvmlDeviceGetTotalEnergyConsumption(
            self.handle, ctypes.byref(mj)), "nvmlDeviceGetTotalEnergyConsumption")
        return mj.value * 1e-3

    def close(self):
        self.lib.nvmlShutdown()


class _Sampler:
    """``nvidia-smi`` printing power.draw every 50 ms; the samples, taken
    against the host clock, integrated by the trapezoid rule."""

    def __init__(self, uuid: Optional[str]):
        cmd = ["nvidia-smi", "--query-gpu=power.draw",
               "--format=csv,noheader,nounits", "-lms", "50"]
        if uuid is not None:
            cmd += ["-i", uuid]
        self.samples: List[Tuple[float, float]] = []
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self):
        for line in self.proc.stdout:
            try:
                self.samples.append((time.perf_counter(), float(line)))
            except ValueError:
                pass

    def joules_between(self, t0: float, t1: float) -> float:
        pts = [(t, w) for t, w in self.samples if t0 <= t <= t1]
        if len(pts) < 2:
            raise OSError("nvidia-smi gave fewer than two power samples "
                          "in the window")
        return sum((b[0] - a[0]) * (a[1] + b[1]) / 2
                   for a, b in zip(pts, pts[1:])) * (t1 - t0) / (pts[-1][0] - pts[0][0])

    def close(self):
        self.proc.terminate()
        self.proc.wait(timeout=30)
        self.reader.join(timeout=30)


class EnergyMeter:
    """``start()`` and ``stop()`` at the window's ends; ``joules`` between."""

    def __init__(self, uuid: Optional[str]):
        self.nvml = self.sampler = None
        try:
            self.nvml = _NVML(uuid)
            self.source = "nvml_total_energy_counter"
        except (OSError, AttributeError) as err:
            print(f"energy: NVML counter unavailable ({err}); sampling "
                  "nvidia-smi power.draw")
            self.sampler = _Sampler(uuid)
            self.source = "nvidia_smi_power_draw_50ms"

    def start(self):
        self.t0 = time.perf_counter()
        self.e0 = self.nvml.joules() if self.nvml else None

    def stop(self) -> float:
        """Joules since ``start``."""
        t1 = time.perf_counter()
        if self.nvml:
            return self.nvml.joules() - self.e0
        time.sleep(0.2)                 # let a sample past the close arrive
        return self.sampler.joules_between(self.t0, t1)

    def close(self):
        for part in (self.nvml, self.sampler):
            if part is not None:
                part.close()

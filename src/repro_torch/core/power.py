"""GPU/TPU power model (paper Eq. 1), in torch float32.

    P(mfu) = P_idle + (P_max_inst - P_idle) * (min(mfu, mfu_sat)/mfu_sat)^gamma

Counterpart of ``repro.core.power``: the device profiles are copied verbatim
and ``power`` repeats the reference's float32 operations one for one, so the
two packages agree to float32 rounding (``pow`` may differ by an ulp between
libraries, hence ``DEVICE_MODE_RTOL``).

``device`` names the simulated accelerator's profile here, as in the
reference; the torch device that evaluates Eq. 1 is ``PowerModel``'s
``torch_device`` (``None``: the CUDA card, see ``repro_torch.device``).

Eq. 1 of a stage depends on its MFU alone, not on where the stage sits in
the array (the day simulation's exact epochs agree bit for bit across day
modes only so). A CUDA kernel computes every element alike; PyTorch's CPU
``pow`` does not: it runs a vectorized loop over whole vectors and a
scalar loop over the rest, which round differently (about one result in
twenty, by one ulp), and splits arrays of 32768 elements or more between
threads. ``_pow`` therefore feeds the CPU whole blocks only.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.device import DeviceLike, resolve_device

#: relative tolerance of every quantity that passes through Eq. 1 between
#: two float32 ``pow`` implementations (torch CPU or CUDA against XLA's);
#: the port's copy of ``repro.sweep.device.DEVICE_MODE_RTOL``
DEVICE_MODE_RTOL = 5e-6

@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    name: str
    p_idle: float               # W
    p_max_inst: float           # W, observed maximum under saturation
    mfu_sat: float              # empirical MFU saturation threshold
    gamma: float                # sublinear exponent (< 1)
    peak_flops: float           # FLOP/s (dense, fp16/bf16)
    hbm_bw: float               # bytes/s
    hbm_bytes: float            # capacity
    link_bw: float              # bytes/s per interconnect link
    embodied_kg_per_hour: float  # phi_manuf: embodied carbon rate kgCO2/h


# --- paper-faithful GPU calibrations (Section 3.1 / 4.1) ---
A100_SXM = DeviceProfile(
    name="a100-sxm4-80gb", p_idle=100.0, p_max_inst=400.0, mfu_sat=0.45,
    gamma=0.7, peak_flops=312e12, hbm_bw=2.039e12, hbm_bytes=80e9,
    link_bw=300e9,
    # LLMCarbon-style amortization: ~150 kgCO2 embodied over 5y of use
    embodied_kg_per_hour=150.0 / (5 * 365 * 24))
H100_SXM = DeviceProfile(
    name="h100-sxm5", p_idle=60.0, p_max_inst=700.0, mfu_sat=0.45,
    gamma=0.7, peak_flops=989e12, hbm_bw=3.35e12, hbm_bytes=80e9,
    link_bw=450e9, embodied_kg_per_hour=180.0 / (5 * 365 * 24))
A40_PCIE = DeviceProfile(
    name="a40-pcie", p_idle=30.0, p_max_inst=300.0, mfu_sat=0.45,
    gamma=0.7, peak_flops=149.7e12, hbm_bw=696e9, hbm_bytes=48e9,
    link_bw=32e9, embodied_kg_per_hour=120.0 / (5 * 365 * 24))

# --- TPU adaptation (estimates; same Eq. 1 form) ---
TPU_V5E = DeviceProfile(
    name="tpu-v5e", p_idle=60.0, p_max_inst=200.0, mfu_sat=0.45,
    gamma=0.7, peak_flops=197e12, hbm_bw=819e9, hbm_bytes=16e9,
    link_bw=50e9, embodied_kg_per_hour=80.0 / (5 * 365 * 24))
TPU_V5P = DeviceProfile(
    name="tpu-v5p", p_idle=90.0, p_max_inst=350.0, mfu_sat=0.45,
    gamma=0.7, peak_flops=459e12, hbm_bw=2.765e12, hbm_bytes=95e9,
    link_bw=100e9, embodied_kg_per_hour=120.0 / (5 * 365 * 24))

DEVICES: Dict[str, DeviceProfile] = {
    d.name: d for d in (A100_SXM, H100_SXM, A40_PCIE, TPU_V5E, TPU_V5P)
}
DEVICES["a100"] = A100_SXM
DEVICES["h100"] = H100_SXM
DEVICES["a40"] = A40_PCIE
DEVICES["v5e"] = TPU_V5E
DEVICES["v5p"] = TPU_V5P


#: elements per CPU ``pow`` call: a multiple of every vector loop's step
#: (64 covers two vectors of up to 32 floats) and below the size at which
#: PyTorch splits an elementwise op between threads (32768)
_CPU_POW_BLOCK = 16384
_CPU_POW_STEP = 64


def _pow(x: torch.Tensor, gamma: float) -> torch.Tensor:
    """``torch.pow(x, gamma)``, each element rounded as every other: on the
    CPU, zero-padded to whole vector steps and cut into blocks that one
    thread takes whole, so every element goes through the vectorized loop."""
    if x.device.type != "cpu":
        return torch.pow(x, gamma)
    flat = x.reshape(-1)
    padded = torch.nn.functional.pad(flat, (0, -flat.numel() % _CPU_POW_STEP))
    out = torch.cat([torch.pow(b, gamma)
                     for b in padded.split(_CPU_POW_BLOCK)])
    return out[:flat.numel()].reshape(x.shape)


def power(mfu, dev: DeviceProfile) -> torch.Tensor:
    """Eq. 1, vectorized. mfu in [0, 1] (fraction, not percent)."""
    mfu = torch.clamp(torch.as_tensor(mfu, dtype=torch.float32), min=0.0)
    x = torch.minimum(mfu, torch.tensor(dev.mfu_sat, dtype=torch.float32,
                                        device=mfu.device)) / dev.mfu_sat
    return dev.p_idle + (dev.p_max_inst - dev.p_idle) * _pow(x, dev.gamma)


class PowerModel:
    """Object facade used by the simulator, the co-simulation bridge and
    the serving launcher. ``device`` is the profile; Eq. 1 runs on
    ``torch_device``, resolved at each call (``None``: the card, raising
    without one), and returns float32 tensors there."""

    def __init__(self, device: str | DeviceProfile = "a100",
                 torch_device: DeviceLike = None):
        self.dev = DEVICES[device] if isinstance(device, str) else device
        self.torch_device = torch_device

    def power(self, mfu) -> torch.Tensor:
        dev = resolve_device(self.torch_device)
        return power(torch.as_tensor(mfu, dtype=torch.float32, device=dev),
                     self.dev)

    def energy_wh(self, mfu, duration_s, n_devices: int = 1,
                  pue: float = 1.0) -> torch.Tensor:
        """Energy in Wh for stages with given MFU and duration (Eq. 3), a
        float32 scalar tensor (the reference's x64-off jnp arithmetic)."""
        p = self.power(mfu)
        dur = torch.as_tensor(duration_s, dtype=torch.float32, device=p.device)
        return torch.sum(p * dur / 3600.0) * n_devices * pue

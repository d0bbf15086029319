"""Plain PyTorch version of the microgrid scan kernel: the co-simulation's
eager step loop.

Counterpart of the step of ``repro/core/microgrid.py::simulate`` (a
``lax.scan``). The wrapper runs it for CPU tensors; the tests and
``chip_smoke.py`` hold the kernel against it. Each step is 26 tensor
operations over the batch, one launch each on a card.
"""
from __future__ import annotations

from typing import Sequence

import torch

#: the traces, in the order of the kernel's output planes
TRACE_KEYS = ("soc", "grid_import_w", "grid_export_w", "charge_w",
              "discharge_w", "emissions_g", "solar_used_w")


def microgrid_scan_reference(load_w, solar_w, ci,
                             constants: Sequence[float]) -> torch.Tensor:
    """load_w, solar_w, ci: (B, T) float32; ``constants`` the eleven float32
    constants of ``ops.CONSTANTS``. Returns the traces (7, B, T) float32, in
    ``TRACE_KEYS`` order."""
    dev = load_w.device
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    (soc_wh, soc_hi, soc_lo, max_chg, max_dis_w, k_room, k_avail, k_charge,
     k_discharge, k_emis, k_soc) = (f32(c) for c in constants)
    zero = f32(0.0)
    soc_wh = soc_wh.expand(load_w.shape[0])
    out = []
    for load, solar, ci_t in zip(load_w.T, solar_w.T, ci.T):
        surplus = solar - load
        # charge path
        room = torch.maximum(soc_hi - soc_wh, zero)
        charge = torch.clamp(surplus, zero, torch.minimum(max_chg, room * k_room))
        # discharge path
        avail = torch.maximum(soc_wh - soc_lo, zero)
        max_dis = torch.minimum(max_dis_w, avail * k_avail)
        discharge = torch.clamp(-surplus, zero, max_dis)
        soc_wh = soc_wh + charge * k_charge - discharge * k_discharge
        grid = surplus - charge + discharge   # >0 export, <0 import
        grid_import = torch.maximum(-grid, zero)
        out.append(torch.stack((
            soc_wh * k_soc, grid_import, torch.maximum(grid, zero), charge,
            discharge, grid_import * k_emis * ci_t,
            torch.minimum(solar, load + charge))))
    if not out:
        return load_w.new_zeros((len(TRACE_KEYS),) + tuple(load_w.shape))
    return torch.stack(out, dim=-1)

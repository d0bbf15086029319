"""A CPU mirror of the microgrid_scan kernel's design
(``repro_torch/kernels/microgrid_scan/csrc/microgrid_scan.cu``).

The kernel's walker carries soc_wh alone: max_chg and max_dis_w are folded
into two caps computed from each step's inputs off the chain
(``min(max(surplus, 0), max_chg)``, ``min(max(-surplus, 0), max_dis_w)``),
since min is associative with its operands kept in order, so the walker
runs seven dependent operations a step where the loop runs eight. The trace
writers then recompute each step from its inputs and its incoming soc_wh
with the loop's operations. This mirror does the same in plain torch (the
walk over steps, the traces in one vectorised pass over all steps) and
holds the result with ``torch.equal``, NaN in the same places, against the
plain step loop (``microgrid_scan_reference``), whose bits the kernel must
give: under Table 2's battery and the others, without a battery, with zero
charge and discharge rates, and with signed zeros and a NaN in the surplus.
"""
import numpy as np
import pytest
import torch

from repro_torch import core
from repro_torch.core.microgrid import constants
from repro_torch.kernels.microgrid_scan import microgrid_scan_reference

_battery = lambda **kw: core.MicrogridConfig(battery=core.BatteryConfig(**kw))
MICROGRIDS = {
    "default": core.MicrogridConfig(),
    "table1b": _battery(capacity_wh=100.0, soc_init=0.5, soc_min=0.2,
                        soc_max=0.8),
    "slow-5min": core.MicrogridConfig(step_s=300.0, battery=core.BatteryConfig(
        capacity_wh=500.0, soc_init=0.2, max_charge_w=150.0,
        max_discharge_w=90.0, efficiency=0.9)),
    "no-battery": _battery(capacity_wh=0.0),
    "zero-rates": _battery(max_charge_w=0.0, max_discharge_w=0.0),
}


def _inputs(T, seed, B=1, signed_zeros=False):
    """(B, T) float32 load, solar and CI as the card tests draw them; with
    ``signed_zeros`` the surplus is -0 every 7th step, +0 from a -0 load
    every 11th, both +0 every 13th, and a NaN load 100 steps before the
    end."""
    rng = np.random.default_rng(seed)
    load, solar, ci = (torch.as_tensor(rng.uniform(lo, hi, (B, T)),
                                       dtype=torch.float32)
                       for lo, hi in ((0, 600.0), (0, 800.0), (50, 800.0)))
    if signed_zeros:
        for every, ld, sol in ((7, 0.0, -0.0), (11, -0.0, 0.0), (13, 0.0, 0.0)):
            load[:, ::every], solar[:, ::every] = ld, sol
        load[:, T - 100] = float("nan")
    return load, solar, ci


def _as_kernel(load, solar, ci, k):
    """The kernel's arithmetic: caps staged off the chain, soc_wh walked
    alone, then the seven traces from each step's incoming soc_wh."""
    (soc_init, soc_hi, soc_lo, max_chg, max_dis_w, k_room, k_avail, k_charge,
     k_discharge, k_emis, k_soc) = (torch.tensor(c, dtype=torch.float32)
                                    for c in k)
    zero = torch.tensor(0.0)
    # the stagers: each step's caps, from its inputs alone
    surplus = solar - load
    pos = torch.minimum(torch.maximum(surplus, zero), max_chg)
    neg = torch.minimum(torch.maximum(-surplus, zero), max_dis_w)
    # the walker: seven dependent operations a step
    soc = soc_init.expand(load.shape[0])
    incoming = []
    for p, n in zip(pos.T, neg.T):
        incoming.append(soc)
        charge = torch.minimum(p, torch.maximum(soc_hi - soc, zero) * k_room)
        discharge = torch.minimum(n, torch.maximum(soc - soc_lo, zero) * k_avail)
        soc = soc + charge * k_charge - discharge * k_discharge
    soc_in = torch.stack(incoming, -1) if incoming else load.clone()
    # the writers: the loop's step from the incoming soc_wh, all steps at once
    room = torch.maximum(soc_hi - soc_in, zero)
    charge = torch.clamp(surplus, zero, torch.minimum(max_chg, room * k_room))
    avail = torch.maximum(soc_in - soc_lo, zero)
    discharge = torch.clamp(-surplus, zero,
                            torch.minimum(max_dis_w, avail * k_avail))
    soc_out = soc_in + charge * k_charge - discharge * k_discharge
    grid = surplus - charge + discharge
    grid_import = torch.maximum(-grid, zero)
    return torch.stack((soc_out * k_soc, grid_import, torch.maximum(grid, zero),
                        charge, discharge, grid_import * k_emis * ci,
                        torch.minimum(solar, load + charge)))


def _equal_nan(a, b):
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(nan_a, nan_b)) and bool(torch.equal(
        torch.where(nan_a, 0.0, a), torch.where(nan_b, 0.0, b)))


CASES = ([(name, seed, 1, 1800, False) for name in MICROGRIDS for seed in range(2)]
         + [(name, 13, 1, 1800, True) for name in ("table1b", "zero-rates")]
         + [("slow-5min", 7, 3, 300, False), ("table1b", 0, 1, 0, False)])


@pytest.mark.parametrize("name,seed,B,T,signed_zeros", CASES,
                         ids=[f"{c[0]}-s{c[1]}-B{c[2]}-T{c[3]}"
                              + ("-signed-zeros-nan" if c[4] else "")
                              for c in CASES])
def test_microgrid_walker_and_writers_give_the_loops_traces(name, seed, B, T,
                                                            signed_zeros):
    k = constants(MICROGRIDS[name])
    x = _inputs(T, seed, B, signed_zeros)
    got, want = _as_kernel(*x, k), microgrid_scan_reference(*x, k)
    assert got.shape == want.shape == (7, B, T)
    assert _equal_nan(got, want)
    if signed_zeros:
        assert bool(torch.isnan(got[0]).any())

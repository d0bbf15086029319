"""The port's ``fleet/day.py`` against the reference, on the CPU.

The day smoke sweep (a diurnal + burst stream over two sites, hybrid and
event-loop day modes, autoscaler on and off) in both packages: the same
keys; everything the planner and the event loop decide bitwise; the
columns that pass through Eq. 1 or the co-sim within
``DEVICE_MODE_RTOL``. Within the port, the two day modes plan the same
epochs and agree bit for bit on the epochs both run exactly, and a probe
changes nothing.
"""
import functools

import pytest

import repro.obs.diff as r_diff
import repro.sweep.scenarios as r_scen
import repro_torch.fleet.day as p_day
import repro_torch.sweep.scenarios as p_scen
from repro_torch.obs.recorder import FlightRecorder

CPU = "cpu"


@functools.lru_cache(maxsize=None)
def day_runs():
    """(reference records, port records, port derived line)."""
    ref = r_scen.run_sweep("day", smoke=True, mode="event_loop")[0]
    port, _, derived = p_scen.run_sweep("day", smoke=True, mode="event_loop",
                                        torch_device=CPU)
    return ref, port, derived


def test_day_smoke_modes_agree():
    """The hybrid and event_loop day modes plan identical epochs and
    agree bit for bit on planned-exact epochs (Eq. 1 rounds each stage
    alike wherever it sits in the day's trace)."""
    _, port, derived = day_runs()
    assert "plans_match=True" in derived and "exact_bitwise=True" in derived
    agree = p_scen.day_agreement(port)
    assert agree["n_pairs"] == 2 and agree["exact_max_rel"] == 0.0
    assert agree["n_exact_epochs"] > 0
    assert agree["fluid_max_rel"] <= p_scen.DAY_FLUID_RTOL


def test_day_records_match_reference():
    ref, port, _ = day_runs()
    assert [r["key"] for r in port] == [r["key"] for r in ref]
    result = r_diff.diff_records(ref, port)
    assert not result.only_a and not result.only_b
    for c in result.cells:
        assert c.contract in ("host-bitwise", "DEVICE_MODE_RTOL"), c.format()
        assert c.phase in ("power", "energy", "carbon"), c.format()


@pytest.mark.parametrize("index", [0, 1])
def test_day_probe_is_neutral(index):
    cfg = p_scen.SWEEPS["day"].build(True, n_requests=1500)[index].cfg
    off = p_day.run_fleet_day(cfg, torch_device=CPU).summary()
    rec = FlightRecorder(resolution_s=60.0, torch_device=CPU)
    on = p_day.run_fleet_day(cfg, probe=rec, torch_device=CPU).summary()
    assert on == off
    assert rec.epochs and rec.timelines and rec.n_stage_events > 0
    assert {e["site"] for e in rec.epochs} == set(range(len(cfg.sites)))

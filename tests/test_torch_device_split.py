"""Device mode's split of the group axis over local devices, on the CPU.

Counterpart of the reference's ``test_sharded_dispatch_across_two_host_devices``
(``tests/test_device_mode.py``): the device list (``sweep.device.local_devices``)
is patched to two and four CPU devices. Every block of groups gives the
records of one whole-grid program bit for bit (the program's batch
invariance), so the split is held to ``d = 1`` exactly, and the records to
the reference's event loop within ``DEVICE_MODE_RTOL``.
"""
import functools

import pytest
import torch

import repro.sweep.scenarios as r_scen
from repro_torch.core.power import DEVICE_MODE_RTOL
from repro_torch.sweep import device as p_device
from repro_torch.sweep.device import execute_device_grid, records_max_rel_err
from repro_torch.sweep.scenarios import SWEEPS

CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def one_device():
    return execute_device_grid(SWEEPS["fig4"].build(True), torch_device=CPU)


def test_one_cpu_device_is_not_split():
    assert p_device.local_devices(CPU) == [CPU]
    assert one_device()[1].devices == 1


@pytest.mark.parametrize("n", [2, 4])
def test_split_over_n_devices_equals_one_bit_for_bit(monkeypatch, n):
    monkeypatch.setattr(p_device, "local_devices", lambda dev: [CPU] * n)
    recs, stats = execute_device_grid(SWEEPS["fig4"].build(True),
                                      torch_device=CPU)
    assert stats.devices == n
    want = {r["key"]: r["metrics"] for r in one_device()[0]}
    assert {r["key"]: r["metrics"] for r in recs} == want
    ref = r_scen.run_sweep("fig4", smoke=True, mode="event_loop")[0]
    assert records_max_rel_err(recs, ref) <= DEVICE_MODE_RTOL

"""The port's ``sweep/`` against the reference, on the CPU.

- Every smoke sweep expands to the reference's scenario keys.
- The port's event-loop records (``torch_device="cpu"``) classify under
  the reference's ``repro.obs.diff`` as ``host-bitwise`` or
  ``DEVICE_MODE_RTOL`` against the reference's event loop, and only the
  columns that pass through Eq. 1 or the co-sim (power, energy, carbon)
  may leave ``host-bitwise``.
- The port's vectorized records are bitwise equal to its event loop's.
- The port's device mode on the CPU lies within ``DEVICE_MODE_RTOL`` of
  the reference's event loop (the reference's own device mode does not
  run on the installed jax), sharing traces by divergence replay where
  the reference does.
- The cache (per torch device type), the CLI, and the runner's and the
  CLI's remote backend and auditor options.
"""
import functools
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import repro.obs.diff as r_diff
import repro.sweep.scenarios as r_scen
import repro_torch.obs.diff as p_diff
import repro_torch.sweep.runner as p_runner
import repro_torch.sweep.scenarios as p_scen
from repro_torch.core.power import DEVICE_MODE_RTOL
from repro_torch.sweep import cli
from repro_torch.sweep.cache import ResultCache
from repro_torch.sweep.device import records_max_rel_err

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"
SMOKE = list(r_scen.SWEEPS)
# the sweeps held against the reference's event loop here; day runs in
# tests/test_torch_day.py, shift (15 fleet scenarios) in the obs tests
EVENT_LOOP_SWEEPS = ["fig1", "fig2", "fig3", "fig4", "fig5", "exp5",
                     "table2", "carbon", "fleet"]
DEVICE_MODE_SWEEPS = ["fig1", "fig3", "fig4", "exp5", "perf"]


@functools.lru_cache(maxsize=None)
def ref_records(name):
    """The reference's event-loop records of a smoke sweep; perf (1056
    scenarios over 12 traces) in its vectorized mode, which the
    reference pins bitwise to its event loop (tests/test_vectorized.py)."""
    mode = "vectorized" if name == "perf" else "event_loop"
    return r_scen.run_sweep(name, smoke=True, mode=mode)[0]


@functools.lru_cache(maxsize=None)
def port_records(name, mode):
    return p_scen.run_sweep(name, smoke=True, mode=mode, torch_device=CPU)[0]


def assert_eq1_only(result, mode="event_loop"):
    """Every divergent cell within DEVICE_MODE_RTOL, and only in columns
    that pass through Eq. 1 or the co-sim (in device mode also the
    program's float64 duration and GPU-hour sums)."""
    assert not result.only_a and not result.only_b
    for c in result.cells:
        assert c.contract in ("host-bitwise", "DEVICE_MODE_RTOL"), c.format()
        on_device = c.phase in ("power", "energy", "carbon") or (
            mode == "device" and c.column in ("duration_s", "gpu_hours"))
        assert on_device, c.format()


@pytest.mark.parametrize("name", SMOKE)
def test_smoke_keys_match_reference(name):
    want = [sc.key for sc in r_scen.SWEEPS[name].build(True)]
    got = [sc.key for sc in p_scen.SWEEPS[name].build(True)]
    assert got == want
    assert [sc.trace_key for sc in p_scen.SWEEPS[name].build(True)] \
        == [sc.trace_key for sc in r_scen.SWEEPS[name].build(True)]


@pytest.mark.parametrize("name", EVENT_LOOP_SWEEPS)
def test_event_loop_records_classify_against_reference(name):
    got = port_records(name, "event_loop")
    assert [r["key"] for r in got] == [r["key"] for r in ref_records(name)]
    assert_eq1_only(r_diff.diff_records(ref_records(name), got))
    # the port's explainer, with its own contract names, agrees
    assert_eq1_only(p_diff.diff_records(ref_records(name), got))


@pytest.mark.parametrize("name", ["fig4", "table2", "carbon", "fleet", "perf"])
def test_vectorized_records_bitwise_equal_event_loop(name):
    if name == "perf":       # 1056 scenarios: a slice of its grid
        scs = p_scen.SWEEPS[name].build(True)[::64]
        ev = p_runner.SweepRunner(mode="event_loop", torch_device=CPU).run(scs)[0]
        ve = p_runner.SweepRunner(mode="vectorized", torch_device=CPU).run(scs)[0]
    else:
        ev, ve = port_records(name, "event_loop"), port_records(name, "vectorized")
    assert [r["key"] for r in ve] == [r["key"] for r in ev]
    assert [r["metrics"] for r in ve] == [r["metrics"] for r in ev]


@pytest.mark.parametrize("name", DEVICE_MODE_SWEEPS)
def test_device_mode_within_device_rtol_of_reference(name):
    got = port_records(name, "device")
    want = ref_records(name)
    assert sorted(r["key"] for r in got) == sorted(r["key"] for r in want)
    assert records_max_rel_err(got, want) <= DEVICE_MODE_RTOL
    assert_eq1_only(r_diff.diff_records(want, got), mode="device")
    assert all(r["meta"]["mode"] == "device" for r in got)


def test_device_mode_replays_shared_traces_like_the_reference():
    scs = p_scen.SWEEPS["perf"].build(True)
    _, stats = p_runner.SweepRunner(mode="device", torch_device=CPU).run(scs)
    assert (stats.trace_groups, stats.event_loops, stats.replayed) == (12, 4, 8)


def test_cached_rerun_executes_nothing(tmp_path):
    cache = ResultCache(tmp_path, torch_device=CPU)
    assert cache.root == tmp_path / "cpu"
    first, s1, _ = p_scen.run_sweep("fig1", smoke=True, cache=cache,
                                    torch_device=CPU)
    again, s2, _ = p_scen.run_sweep("fig1", smoke=True,
                                    cache=ResultCache(tmp_path, torch_device=CPU),
                                    torch_device=CPU)
    assert (s1.executed, s2.executed, s2.cache_hits) == (3, 0, 3)
    assert "0 executed, 3 cache hits" in s2.summary()
    assert [r["metrics"] for r in again] == [r["metrics"] for r in first]
    assert len(list((tmp_path / "cpu").rglob("*.json"))) == 3


def test_cache_keeps_card_and_cpu_records_apart(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    card = ResultCache(tmp_path, torch_device="cuda")
    assert card.root == tmp_path / "cuda"
    with pytest.raises(ValueError, match="cpu records"):
        p_runner.SweepRunner(cache=ResultCache(tmp_path, torch_device=CPU),
                             torch_device="cuda")


def test_remote_backend_and_audit_are_not_ported(tmp_path, capsys):
    """``SweepRunner(backend="remote")`` holds the reference's checks (a
    cache, no probe, no event-loop mode), and the CLI's ``--backend
    remote`` (one spawned CPU worker, one group verified in process) and
    ``--audit`` both run to a clean exit."""
    with pytest.raises(ValueError, match="requires a ResultCache"):
        p_runner.SweepRunner(backend="remote", torch_device=CPU)
    cache = ResultCache(tmp_path / "cache", torch_device=CPU)
    with pytest.raises(ValueError, match="trace groups"):
        p_runner.SweepRunner(cache=cache, backend="remote", mode="event_loop",
                             torch_device=CPU)
    from repro_torch.obs.probe import NULL_PROBE
    with pytest.raises(ValueError, match="probe"):
        p_runner.SweepRunner(cache=cache, backend="remote", probe=NULL_PROBE,
                             torch_device=CPU)
    base = ["--smoke", "fig1", "--torch-device", CPU, "--quiet",
            "--out", str(tmp_path / "out")]
    assert cli.main([*base, "--no-cache", "--backend", "remote"]) == 2
    assert cli.main([*base, "--cache-dir", str(tmp_path / "cache"),
                     "--backend", "remote", "--remote-workers", "1",
                     "--queue-dir", str(tmp_path / "q"),
                     "--remote-verify", "1"]) == 0
    out = capsys.readouterr().out
    assert "3 scenarios: 3 executed" in out
    assert re.search(r"remote: shards=3 workers=1 expired=0 retried=0 "
                     r"quarantined=0", out), out
    assert len(list((tmp_path / "cache" / CPU).rglob("*.json"))) == 3
    assert cli.main([*base, "--no-cache", "--audit"]) == 0
    assert "audit: clean" in capsys.readouterr().out


def _cli(tmp_path, *args):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "REPRO_TORCH_SWEEP_CACHE": str(tmp_path / "cache"),
           "CUDA_VISIBLE_DEVICES": ""}     # no card, wherever it runs
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.sweep.cli", "--smoke", "fig1",
         "--quiet", "--out", str(tmp_path / "out"), *args],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)


def test_cli_runs_on_the_cpu_and_raises_without_a_card(tmp_path):
    out = _cli(tmp_path, "--torch-device", CPU)
    assert out.returncode == 0, out.stderr
    assert "3 scenarios: 3 executed" in out.stdout
    assert (tmp_path / "out" / "fig1.json").exists()
    assert len(list((tmp_path / "cache" / "cpu").rglob("*.json"))) == 3
    out = _cli(tmp_path)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_spawn_pool_gets_the_torch_device_and_matches_serial():
    """Two spawn-context workers receive the torch device as a string; the
    records equal the serial run's bitwise."""
    pooled, stats, _ = p_scen.run_sweep("fig4", smoke=True, workers=2,
                                        torch_device=CPU)
    assert stats.workers == 2 and stats.executed == 3
    assert [r["metrics"] for r in pooled] \
        == [r["metrics"] for r in port_records("fig4", "vectorized")]

"""The sim-time probe protocol (counterpart of ``repro.obs.probe``).

A ``Probe`` is an *observer* of the simulation: the event loop
(``repro_torch.fleet.simulation.drive``) and the simulations built on it call
its hooks at well-defined points, and the probe only ever reads the
state it is handed — it must never mutate schedulers, clocks or
requests. Probe-off runs (``probe=None``, the default everywhere) skip
every hook behind a single ``if probe is not None`` branch, so they
stay bitwise identical to an un-instrumented build; probe-attached
runs must produce the exact same simulation output (the neutrality
contract, pinned by tests/test_torch_obs.py).

Hook taxonomy:

* **hot-loop hooks** fire inside the event loop (``on_stage``,
  ``on_complete``, ``on_route``, ``on_scale``) and are kept cheap: the
  loop passes the live scheduler object instead of precomputed
  aggregates, so a no-op probe costs one method call per stage;
* **finalize hooks** fire once per run/site after the loop drains
  (``on_requests``, ``on_epoch_eval``, ``on_site_rollup``) and hand
  the probe the read-only rollup inputs (stage trace, power model
  name, CI signal, caller-reported Eq. 2-5 totals) it needs to derive
  — or audit — the paper's Eq. 1-5 accounting;
* **``on_run_begin``** marks a run boundary: the sweep layer fires it
  before each executed scenario so stateful probes (the
  reference's ``repro.obs.audit`` invariant auditor) can segment per-run state
  when one probe rides a whole sweep.

``NullProbe`` implements every hook as a no-op — attach it to measure
the pure dispatch overhead of instrumentation.
``MultiProbe`` fans every hook out to an ordered probe list, so a
``FlightRecorder`` and an ``AuditProbe`` can attach to one run.
"""
from __future__ import annotations

from typing import Iterable, List


class Probe:
    """Base probe: every hook is a no-op. Subclass and override what
    you need; unimplemented hooks stay free."""

    # ---- run boundary ----

    def on_run_begin(self, tag: str) -> None:
        """A new simulation run (one executed sweep scenario / trace
        group) is about to start. Stateful probes reset per-run stream
        state here; ``tag`` labels the run in their output."""

    # ---- hot-loop hooks (sim-time) ----

    def on_stage(self, t_s: float, dur_s: float, site: int, replica: int,
                 scheduler, n_prefill: int, n_decode: int,
                 batch_size: int) -> None:
        """One batch iteration committed at sim-time ``t_s`` on
        ``(site, replica)``. ``scheduler`` is the live
        ``ReplicaScheduler`` — read ``len(scheduler.waiting)`` /
        ``len(scheduler.running)`` / ``scheduler.kv_tokens`` here, do
        not hold a reference past the call."""

    def on_complete(self, t_s: float, site: int, replica: int,
                    done) -> None:
        """Requests that finished in the iteration committed at
        ``t_s`` on ``(site, replica)``. ``done`` is the live list of
        completed ``Request`` objects — read-only, same rules as the
        scheduler handle in ``on_stage``."""

    def on_route(self, t_s: float, rid: int, site: int) -> None:
        """Request ``rid`` routed to ``site`` at its ready time."""

    def on_scale(self, t_s: float, site: int, n_active: int,
                 n_warm: int, kind: str) -> None:
        """Autoscaler transition (``repro_torch.fleet.autoscale``)."""

    # ---- finalize hooks (once per run / site) ----

    def on_requests(self, arrival_s, ready_s, site: int = -1) -> None:
        """Arrival/release arrays after admission assignment — the
        deferral backlog timeline derives from (arrival, ready)
        pairs."""

    def on_epoch_eval(self, site: int, ev) -> None:
        """One epoch's ``EpochEval`` from the day simulation / hybrid."""

    def on_site_rollup(self, site: int, name: str, trace, device: str,
                       row_devices: float, pue: float = 1.0, ci=None,
                       total_devices=None, device_signal=None,
                       t_end_s=None, energy_wh=None,
                       idle_energy_wh=None, carbon_active_g=None,
                       carbon_idle_g=None, cosim=None,
                       load=None) -> None:
        """Finalize-time timeline inputs for one site: the full
        ``StageTrace``, the device key (-> ``PowerModel``), the device
        count each row's per-device power applies to
        (``row_devices``), the PUE, the CI (``Signal`` or static
        float), the total/powered device count for idle fill, and the
        horizon. See ``FlightRecorder.on_site_rollup``.

        Callers that already computed their Eq. 2-5 totals also pass
        them through (``energy_wh`` = Eq. 2-3 active energy,
        ``idle_energy_wh``, ``carbon_active_g`` / ``carbon_idle_g`` =
        Eq. 4 attribution, ``cosim`` = microgrid co-sim metrics,
        ``load`` = the Eq. 5 load ``Signal``) so an auditing probe can
        close the accounting chain against them; all default to None
        and recorders may ignore them."""


class NullProbe(Probe):
    """Explicitly-attached no-op probe: exercises every hook dispatch
    without recording anything — the obs-overhead baseline."""


#: shared no-op instance (probes are stateless unless they record)
NULL_PROBE = NullProbe()


class MultiProbe(Probe):
    """Fan every hook out to an ordered list of probes, so e.g. a
    ``FlightRecorder`` and an ``AuditProbe`` attach to one run without
    N^2 combined-probe variants. Hooks forward in list order; the
    neutrality contract holds because each inner probe is itself an
    observer."""

    def __init__(self, probes: Iterable[Probe]):
        self.probes: List[Probe] = list(probes)
        if not self.probes:
            raise ValueError("MultiProbe needs at least one probe")

    def on_run_begin(self, tag):
        for p in self.probes:
            p.on_run_begin(tag)

    def on_stage(self, t_s, dur_s, site, replica, scheduler, n_prefill,
                 n_decode, batch_size):
        for p in self.probes:
            p.on_stage(t_s, dur_s, site, replica, scheduler, n_prefill,
                       n_decode, batch_size)

    def on_complete(self, t_s, site, replica, done):
        for p in self.probes:
            p.on_complete(t_s, site, replica, done)

    def on_route(self, t_s, rid, site):
        for p in self.probes:
            p.on_route(t_s, rid, site)

    def on_scale(self, t_s, site, n_active, n_warm, kind):
        for p in self.probes:
            p.on_scale(t_s, site, n_active, n_warm, kind)

    def on_requests(self, arrival_s, ready_s, site=-1):
        for p in self.probes:
            p.on_requests(arrival_s, ready_s, site=site)

    def on_epoch_eval(self, site, ev):
        for p in self.probes:
            p.on_epoch_eval(site, ev)

    def on_site_rollup(self, site, name, trace, device, row_devices,
                       pue=1.0, ci=None, total_devices=None,
                       device_signal=None, t_end_s=None, energy_wh=None,
                       idle_energy_wh=None, carbon_active_g=None,
                       carbon_idle_g=None, cosim=None, load=None):
        for p in self.probes:
            p.on_site_rollup(site, name, trace, device, row_devices,
                             pue=pue, ci=ci, total_devices=total_devices,
                             device_signal=device_signal, t_end_s=t_end_s,
                             energy_wh=energy_wh,
                             idle_energy_wh=idle_energy_wh,
                             carbon_active_g=carbon_active_g,
                             carbon_idle_g=carbon_idle_g, cosim=cosim,
                             load=load)


class SiteIndexProbe(Probe):
    """Re-tags the ``site`` index of every hook before forwarding to
    an inner probe. The day simulation runs each site's epoch windows
    through single-site ``drive`` calls (which always report site 0);
    wrapping the recorder per site restores fleet-level indices."""

    def __init__(self, inner: Probe, site: int):
        self.inner = inner
        self.site = site

    def on_run_begin(self, tag):
        self.inner.on_run_begin(tag)

    def on_stage(self, t_s, dur_s, site, replica, scheduler, n_prefill,
                 n_decode, batch_size):
        self.inner.on_stage(t_s, dur_s, self.site, replica, scheduler,
                            n_prefill, n_decode, batch_size)

    def on_complete(self, t_s, site, replica, done):
        self.inner.on_complete(t_s, self.site, replica, done)

    def on_route(self, t_s, rid, site):
        self.inner.on_route(t_s, rid, self.site)

    def on_scale(self, t_s, site, n_active, n_warm, kind):
        self.inner.on_scale(t_s, self.site, n_active, n_warm, kind)

    def on_requests(self, arrival_s, ready_s, site=-1):
        self.inner.on_requests(arrival_s, ready_s, site=self.site)

    def on_epoch_eval(self, site, ev):
        self.inner.on_epoch_eval(self.site, ev)

    def on_site_rollup(self, site, name, trace, device, row_devices,
                       pue=1.0, ci=None, total_devices=None,
                       device_signal=None, t_end_s=None, energy_wh=None,
                       idle_energy_wh=None, carbon_active_g=None,
                       carbon_idle_g=None, cosim=None, load=None):
        self.inner.on_site_rollup(self.site, name, trace, device,
                                  row_devices, pue=pue, ci=ci,
                                  total_devices=total_devices,
                                  device_signal=device_signal,
                                  t_end_s=t_end_s, energy_wh=energy_wh,
                                  idle_energy_wh=idle_energy_wh,
                                  carbon_active_g=carbon_active_g,
                                  carbon_idle_g=carbon_idle_g,
                                  cosim=cosim, load=load)

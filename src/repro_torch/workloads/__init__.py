"""Day-scale workload generation: diurnal rate envelopes, MMPP burst
overlays, and array-native arrival streams (see ``repro_torch.workloads.
stream`` / ``repro_torch.workloads.envelope``)."""
from repro_torch.workloads.envelope import (ENVELOPES, BurstOverlay,
                                      burst_overlay, cumulative_rate,
                                      envelope_shape, rate_on_grid)
from repro_torch.workloads.stream import ArrivalStream, generate_stream

__all__ = [
    "ENVELOPES", "BurstOverlay", "burst_overlay", "cumulative_rate",
    "envelope_shape", "rate_on_grid", "ArrivalStream", "generate_stream",
]

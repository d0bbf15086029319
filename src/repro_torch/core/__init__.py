from repro_torch.core.power import DEVICES, DeviceProfile, PowerModel, power
from repro_torch.core.energy import (EnergyReport, operational_energy,
                               operational_energy_trace, stacked_energy_reports,
                               stage_mfu)
from repro_torch.core.carbon import (CarbonReport, emissions, emissions_batch,
                               stage_attributed_carbon)
from repro_torch.core.signals import Signal, aggregate_power
from repro_torch.core.microgrid import BatteryConfig, MicrogridConfig, simulate, summarize
from repro_torch.core.cosim import (CosimResult, run_cosim, stages_to_load_signal,
                              trace_to_load_signal)

__all__ = [
    "DEVICES", "DeviceProfile", "PowerModel", "power",
    "EnergyReport", "operational_energy", "operational_energy_trace",
    "stacked_energy_reports", "stage_mfu",
    "CarbonReport", "emissions", "emissions_batch", "stage_attributed_carbon",
    "Signal", "aggregate_power",
    "BatteryConfig", "MicrogridConfig", "simulate", "summarize",
    "CosimResult", "run_cosim", "stages_to_load_signal",
    "trace_to_load_signal",
]

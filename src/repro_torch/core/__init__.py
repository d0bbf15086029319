from repro_torch.core.power import DEVICES, DeviceProfile, PowerModel, power
from repro_torch.core.carbon import CarbonReport, emissions
from repro_torch.core.signals import Signal

__all__ = [
    "DEVICES", "DeviceProfile", "PowerModel", "power",
    "CarbonReport", "emissions", "Signal",
]

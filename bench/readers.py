"""Find a metric's reader by its name: ``bench/metrics/<name>.py``, whose
``read(record)`` returns the metric's value, or None where the record holds
nothing for it to read."""
import importlib.util
from pathlib import Path

METRICS = Path(__file__).resolve().parent / "metrics"


def reader(name: str):
    path = METRICS / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

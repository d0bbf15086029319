from repro_torch.sim.execmodel import (ExecModelConfig, ExecutionModel, StageBatch,
                                 StageCost, StageCostBatch,
                                 cached_execution_model)
from repro_torch.sim.requests import Request, WorkloadConfig, generate
from repro_torch.sim.scheduler import ReplicaScheduler, SchedulerConfig
from repro_torch.sim.simulator import (SimConfig, SimResult, StageLog, energy_report,
                                 run_simulation)
from repro_torch.sim.trace import StageTrace, StageTraceBuilder
from repro_torch.sim.defaults import INTEGRATION_DEFAULT, PAPER_DEFAULT, PAPER_PUE

__all__ = [
    "ExecModelConfig", "ExecutionModel", "StageBatch", "StageCost",
    "StageCostBatch", "cached_execution_model",
    "Request", "WorkloadConfig", "generate",
    "ReplicaScheduler", "RoundRobinRouter", "SchedulerConfig",
    "SimConfig", "SimResult", "StageLog", "energy_report", "run_simulation",
    "StageTrace", "StageTraceBuilder",
    "INTEGRATION_DEFAULT", "PAPER_DEFAULT", "PAPER_PUE",
]


def __getattr__(name):
    # moved to the routing layer; lazy so repro_torch.sim <-> repro_torch.fleet
    # imports never cycle at module load
    if name == "RoundRobinRouter":
        from repro_torch.fleet.routing import RoundRobinRouter
        return RoundRobinRouter
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

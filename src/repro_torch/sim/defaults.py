"""Paper Table 1 default parameterizations."""
from repro_torch.configs.paper_models import LLAMA3_8B, LLAMA2_7B
from repro_torch.sim.execmodel import ExecModelConfig
from repro_torch.sim.requests import WorkloadConfig
from repro_torch.sim.scheduler import SchedulerConfig
from repro_torch.sim.simulator import SimConfig

# Table 1(a): default Vidur configuration
PAPER_DEFAULT = SimConfig(
    model=LLAMA3_8B,
    device="a100",
    n_replicas=1, tp=1, pp=1,
    workload=WorkloadConfig(n_requests=1024, qps=6.45, arrival="poisson",
                            length_dist="zipf", zipf_theta=0.6,
                            min_len=128, max_len=4096, pd_ratio=20.0,
                            seed=0),
    scheduler=SchedulerConfig(batch_cap=128, max_tokens=4096),
)

# Table 1(b): Vidur-Vessim integration case study
INTEGRATION_DEFAULT = SimConfig(
    model=LLAMA2_7B,
    device="a100",
    n_replicas=1, tp=1, pp=1,
    workload=WorkloadConfig(n_requests=400_000, qps=20.0, arrival="poisson",
                            length_dist="zipf", zipf_theta=0.6,
                            min_len=1024, max_len=4096, pd_ratio=20.0,
                            seed=7),
    scheduler=SchedulerConfig(batch_cap=128, max_tokens=4096),
)
PAPER_PUE = 1.2

from gecco_tpu_torch.diffusion.diffusion import Diffusion, NoCond, mse
from gecco_tpu_torch.diffusion.samplers import churn_gamma, heun_sampler, heun_step
from gecco_tpu_torch.diffusion.schedule import (
    LogNormalSchedule,
    LogUniformSchedule,
    Schedule,
    low_discrepancy_uniform,
)

__all__ = [
    "Diffusion",
    "NoCond",
    "mse",
    "churn_gamma",
    "heun_sampler",
    "heun_step",
    "LogNormalSchedule",
    "LogUniformSchedule",
    "low_discrepancy_uniform",
    "Schedule",
]

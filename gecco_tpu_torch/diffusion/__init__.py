from gecco_tpu_torch.diffusion.diffusion import Diffusion, NoCond
from gecco_tpu_torch.diffusion.samplers import heun_sampler, heun_step
from gecco_tpu_torch.diffusion.schedule import LogUniformSchedule, Schedule

__all__ = [
    "Diffusion",
    "NoCond",
    "heun_sampler",
    "heun_step",
    "LogUniformSchedule",
    "Schedule",
]

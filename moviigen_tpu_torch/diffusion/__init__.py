from .flow_match import (
    compute_density_for_timestep_sampling,
    flow_match_noisy,
    flow_match_target,
    sigmas_for_timesteps,
    train_schedule,
)
from .solvers import (
    FlowDPMSolverMultistepScheduler,
    FlowMatchScheduler,
    FlowUniPCMultistepScheduler,
    get_sampling_sigmas,
    shift_sigmas,
)

__all__ = [
    "compute_density_for_timestep_sampling",
    "flow_match_noisy",
    "flow_match_target",
    "sigmas_for_timesteps",
    "train_schedule",
    "FlowUniPCMultistepScheduler",
    "FlowDPMSolverMultistepScheduler",
    "FlowMatchScheduler",
    "get_sampling_sigmas",
    "shift_sigmas",
]

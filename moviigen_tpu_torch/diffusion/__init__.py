from .solvers import (
    FlowDPMSolverMultistepScheduler,
    FlowUniPCMultistepScheduler,
    get_sampling_sigmas,
    shift_sigmas,
)

__all__ = [
    "FlowUniPCMultistepScheduler",
    "FlowDPMSolverMultistepScheduler",
    "get_sampling_sigmas",
    "shift_sigmas",
]

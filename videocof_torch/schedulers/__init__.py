from .common import flow_shift_sigmas, get_scheduler, time_shift_mu
from .ddim import DDIMScheduler, DDIMState
from .flow_dpm import DPMState, FlowDPMScheduler
from .flow_euler import EulerState, FlowEulerScheduler
from .flow_unipc import FlowUniPCScheduler, UniPCState

SCHEDULERS = {"euler": FlowEulerScheduler, "unipc": FlowUniPCScheduler,
              "dpm++": FlowDPMScheduler, "ddim": DDIMScheduler}

__all__ = ["FlowUniPCScheduler", "UniPCState", "FlowEulerScheduler",
           "EulerState", "FlowDPMScheduler", "DPMState", "DDIMScheduler",
           "DDIMState", "SCHEDULERS", "flow_shift_sigmas", "time_shift_mu",
           "get_scheduler"]

from .common import flow_shift_sigmas, get_scheduler
from .flow_dpm import DPMState, FlowDPMScheduler
from .flow_euler import EulerState, FlowEulerScheduler
from .flow_unipc import FlowUniPCScheduler, UniPCState

SCHEDULERS = {"euler": FlowEulerScheduler, "unipc": FlowUniPCScheduler,
              "dpm++": FlowDPMScheduler}

__all__ = ["FlowUniPCScheduler", "UniPCState", "FlowEulerScheduler",
           "EulerState", "FlowDPMScheduler", "DPMState", "SCHEDULERS",
           "flow_shift_sigmas", "get_scheduler"]

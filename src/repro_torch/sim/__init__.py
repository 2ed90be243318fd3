from repro_torch.sim.cluster import (ClusterSpec, Schedule, SimMetrics, Slot,
                                     simulate)
from repro_torch.sim.faults import (CrashEvent, FaultInjector, FaultPlan,
                                    ScrapeDropout, StragglerWindow)

__all__ = ["ClusterSpec", "CrashEvent", "FaultInjector", "FaultPlan",
           "Schedule", "ScrapeDropout", "SimMetrics", "Slot",
           "StragglerWindow", "simulate"]

from repro_torch.sim.cluster import (ClusterSpec, Schedule, SimMetrics, Slot,
                                     simulate)

__all__ = ["ClusterSpec", "Schedule", "SimMetrics", "Slot", "simulate"]

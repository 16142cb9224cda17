"""Async / elastic federated subsystem of the port, as :mod:`repro.fed`.

* :mod:`repro_torch.fed.async_engine`: the buffered-async Fed-Server,
  staleness-weighted seed-replay updates as they arrive.
* :mod:`repro_torch.fed.controller`: the event-driven elastic fleet loop
  (join, drop, retried faults, the mesh hook).
* :mod:`repro_torch.fed.cutplan`: profile-driven cut-layer selection
  from FLOP and byte counts of the client loss at every cut.
"""
from repro_torch.fed.async_engine import (AsyncReplayServer, AsyncTelemetry,
                                          StalenessConfig, staleness_weight)
from repro_torch.fed.controller import (FleetClient, FleetController,
                                        FleetTelemetry)
from repro_torch.fed.cutplan import (CutCost, CutPlan, DeviceProfile,
                                     PROFILES, candidate_costs,
                                     cut_candidates, plan_cut, plan_fleet,
                                     round_time_s)

__all__ = [
    "AsyncReplayServer", "AsyncTelemetry", "StalenessConfig",
    "staleness_weight", "FleetClient", "FleetController", "FleetTelemetry",
    "CutCost", "CutPlan", "DeviceProfile", "PROFILES", "candidate_costs",
    "cut_candidates", "plan_cut", "plan_fleet", "round_time_s",
]

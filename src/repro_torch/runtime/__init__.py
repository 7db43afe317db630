"""Runtime of the port: fault tolerance, the straggler watchdog and the
elastic reshard (from ``repro.runtime``)."""
from .fault_tolerance import (FaultToleranceConfig, StragglerWatchdog,
                              TrainController, reshard_state)

__all__ = ["FaultToleranceConfig", "StragglerWatchdog", "TrainController",
           "reshard_state"]

"""Runtime of the port: fault tolerance and the straggler watchdog (from
``repro.runtime``)."""
from .fault_tolerance import (FaultToleranceConfig, StragglerWatchdog,
                              TrainController)

__all__ = ["FaultToleranceConfig", "StragglerWatchdog", "TrainController"]

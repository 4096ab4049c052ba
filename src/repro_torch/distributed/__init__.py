"""Fault-tolerant training and serving (counterpart of ``repro.distributed``)."""

from .fault_tolerance import FaultTolerantRunner, RunStats, SimulatedFailure
from .resilient import (
    ResilientEngine,
    ServeInfo,
    ShardFailure,
    ShardFaultInjector,
)
from .straggler import StragglerWatchdog

__all__ = [
    "FaultTolerantRunner",
    "ResilientEngine",
    "RunStats",
    "ServeInfo",
    "ShardFailure",
    "ShardFaultInjector",
    "SimulatedFailure",
    "StragglerWatchdog",
]

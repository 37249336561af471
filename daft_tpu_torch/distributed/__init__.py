"""Distributed execution: stage planning, scheduler, workers.

The engine's flotilla-equivalent (reference: ``src/daft-distributed`` — stage
split at data movement ``stage/mod.rs:54-80``, pluggable Scheduler trait
``scheduling/scheduler/mod.rs:18-23``, Worker/WorkerManager abstractions
``scheduling/worker.rs:13-25``, mock-worker tests ``scheduling/tests.rs``).
The port's copy of ``daft_tpu/distributed/``: workers are local executors
(threads sharing the process's card, or remote worker processes), and the
exchanges between stages ride the device mesh (``parallel/``), the Flight
shuffle, or the driver's host exchange.
"""

from .stages import Stage, StagePlan
from .topology import (CollectiveExchangeGroup, MeshGroup, WorkerTopology,
                       plan_exchange_path)
from .worker import Worker, InProcessWorker, WorkerManager, StageTask
from .resilience import (FaultPlan, RetryPolicy, ResilienceContext,
                         TaskSupervisor, InjectedFault, ShuffleFetchError,
                         FailFastError, TaskTimeout)
from .scheduler import (Scheduler, RoundRobinScheduler, LeastLoadedScheduler,
                        StageRunner)

__all__ = ["Stage", "StagePlan", "Worker", "InProcessWorker",
           "WorkerManager", "StageTask", "Scheduler", "RoundRobinScheduler",
           "LeastLoadedScheduler", "StageRunner", "FaultPlan", "RetryPolicy",
           "ResilienceContext", "TaskSupervisor", "InjectedFault",
           "ShuffleFetchError", "FailFastError", "TaskTimeout",
           "WorkerTopology", "MeshGroup", "CollectiveExchangeGroup",
           "plan_exchange_path"]

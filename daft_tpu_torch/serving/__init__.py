"""daft_tpu_torch.serving: the concurrent serving plane.

The port's copy of ``daft_tpu/serving/``. A process-level
:class:`QueryScheduler` admits N concurrent queries against shared engine
resources (the card among them): per-session weighted fair queuing,
cost-model admission control against a byte budget, plan and result
caches keyed by logical-plan fingerprints, and cooperative cancellation
threaded into the executor pipelines. ``drain`` and ``release_session``
are the lifecycle hooks a router calls.

Spark Connect (``connect/``) and the fleet's replicas (``fleet/``) submit
through :func:`shared_scheduler`.
"""

from __future__ import annotations

import threading
from typing import Optional

from ..execution.cancellation import CancelToken, QueryCancelled
from .caches import PlanCache, ResultCache
from .scheduler import AdmissionRejected, QueryHandle, QueryScheduler

__all__ = [
    "AdmissionRejected", "CancelToken", "PlanCache", "QueryCancelled",
    "QueryHandle", "QueryScheduler", "ResultCache", "shared_scheduler",
    "shared_scheduler_if_running", "shutdown_shared",
]

_shared_lock = threading.Lock()
_shared: Optional[QueryScheduler] = None


def shared_scheduler() -> QueryScheduler:
    """The process-wide scheduler (lazily built from the serve knobs):
    every front door submits through this one, so all client sessions
    share one admission budget and one set of caches."""
    global _shared
    if _shared is not None:  # hot path: no lock once built
        return _shared
    with _shared_lock:
        if _shared is None:
            _shared = QueryScheduler()
        return _shared


def shared_scheduler_if_running() -> Optional[QueryScheduler]:
    """The shared scheduler if one exists (the dashboard's live queue
    view must not boot a scheduler as a side effect of being looked at)."""
    return _shared


def shutdown_shared() -> None:
    global _shared
    with _shared_lock:
        sched = _shared
        _shared = None
    if sched is not None:
        sched.shutdown()

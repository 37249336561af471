"""Rule family — per-query attribution onto worker threads, over the
port.

The port's copy of ``daft_tpu/analysis/rule_attribution.py``. Every
shared-plane counter (scan io, spill, the device-kernel ledger) credits
the query whose thread bumped it, but only because every spawn site
threads the attribution through: pool submits wrap the callable in
``observability.run_attributed`` / ``tracing.run_attached``, and
long-lived stage threads install ``observability.attributed(...)`` /
``tracing.attach`` inside their target. One unwrapped spawn and that
worker's counters land on the wrong query, or on none.

The rule: in the port's executor, push engine, serving scheduler, read
planner and distributed workers, every
``<pool>.submit(fn, ...)`` passes an attribution wrapper as the callable,
and every ``threading.Thread(target=g)`` whose target is a same-module
def has ``g`` (transitively, bounded) install attribution. Targets that
cannot be resolved statically are skipped; maintenance threads that touch
no plane counter carry a pragma saying so.

The distributed worker's fetch pool and the remote worker's task pool
(``distributed/worker.py``, ``distributed/remote_worker.py``) are in
scope too.
"""

from __future__ import annotations

import ast
from typing import List, Set

from . import dataflow
from .dataflow import ModuleIndex
from .framework import PKG, Finding, SourceFile

#: modules whose thread spawns run query work against shared planes
SCOPE = (
    f"{PKG}/execution/executor.py",
    f"{PKG}/execution/pipeline.py",
    f"{PKG}/serving/scheduler.py",
    f"{PKG}/io/read_planner.py",
    f"{PKG}/distributed/worker.py",
    f"{PKG}/distributed/remote_worker.py",
)

#: callables that wrap attribution around a submitted function
WRAPPERS = frozenset({"run_attributed", "run_attached"})

#: calls whose presence in a thread target means it installs the
#: attribution / span scope itself
INSTALLERS = {"attributed", "attach", "run_attributed", "run_attached",
              "cancel_scope", "nested_scope"}

RULE_IDS = {
    "unattributed-worker": (
        "attribution",
        "wrap the callable in observability.run_attributed(current_"
        "attribution(), fn, ...) / tracing.run_attached, or install "
        "observability.attributed(...) inside the thread target"),
}


def _call_last(call: ast.Call) -> str:
    return dataflow._call_last_name(call)


def _is_poolish(call: ast.Call) -> bool:
    if not isinstance(call.func, ast.Attribute) \
            or call.func.attr != "submit":
        return False
    recv = dataflow.dotted(call.func.value).lower()
    return "pool" in recv


def check(sources: List[SourceFile]) -> List[Finding]:
    out: List[Finding] = []
    for sf in sources:
        if sf.path not in SCOPE:
            continue
        idx = ModuleIndex(sf.tree)
        installers: Set[str] = idx.calls_anywhere(set(INSTALLERS))
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            if _is_poolish(node):
                if not node.args:
                    continue
                fn_arg = node.args[0]
                last = ""
                if isinstance(fn_arg, (ast.Attribute, ast.Name)):
                    last = fn_arg.attr if isinstance(fn_arg,
                                                     ast.Attribute) \
                        else fn_arg.id
                if last in WRAPPERS or last in installers:
                    continue
                out.append(Finding(
                    "unattributed-worker", sf.path, node.lineno,
                    f"pool submit of {ast.unparse(fn_arg)[:40]!r} without "
                    f"an attribution wrapper — this worker's plane "
                    f"counters credit the wrong query under concurrency"))
            elif _call_last(node) == "Thread":
                target = None
                for kw in node.keywords:
                    if kw.arg == "target":
                        target = kw.value
                if target is None:
                    continue
                tname = None
                if isinstance(target, ast.Attribute):
                    base = dataflow.dotted(target.value)
                    if base == "self":
                        tname = target.attr
                elif isinstance(target, ast.Name):
                    tname = target.id
                if tname is None:
                    continue  # foreign bound method: infra, not a worker
                if idx.defs.get(tname) is None:
                    continue
                if tname in installers:
                    continue
                out.append(Finding(
                    "unattributed-worker", sf.path, node.lineno,
                    f"thread target {tname}() never installs "
                    f"observability.attributed / tracing.attach — query "
                    f"work on this thread is invisible to per-query "
                    f"stats isolation"))
    return out

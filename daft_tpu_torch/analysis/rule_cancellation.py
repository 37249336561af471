"""Rule family — cancellation responsiveness of partition-drain loops,
over the port.

The port's copy of ``daft_tpu/analysis/rule_cancellation.py``. A fired
``CancelToken`` unwinds at the next check. The executors check at every
*yield* boundary, which covers pipelined loops for free, but a blocking
drain (sort consume, exchange fanout, join bucket store, merge agg)
iterates its whole input before yielding anything, so a loop without its
own poll turns a cancel into "runs to completion while holding
admission". This family proves every morsel/partition drain loop of the
port's executor and push engine reaches a cancellation check.

A loop is credited when its body (or a same-module helper it calls):

- checks a token — ``tok.check()`` / ``token.is_set()`` /
  ``self._poll_cancel()`` and friends;
- ``yield``\\ s — the driver loop's boundary check covers it;
- ``put()``\\ s into a pipeline channel — ``Channel.put`` polls the
  pipeline's cancel event on every blocked attempt.

A loop whose responsiveness lives in the *iterator* carries a pragma
naming the mechanism.

Scope: ``execution/executor.py``, ``execution/pipeline.py``, the
serving plane (``serving/``: the scheduler's drain of a non-cacheable
runner's partitions) and the distributed workers
(``distributed/worker.py``, ``distributed/remote_worker.py``).
"""

from __future__ import annotations

import ast
from typing import List, Optional

from . import dataflow
from .dataflow import ModuleIndex
from .framework import PKG, Finding, SourceFile
from .rule_resources import walk_local

#: modules whose loops drain morsels/partitions/fetch results
SCOPE_PREFIXES = (
    f"{PKG}/execution/executor.py",
    f"{PKG}/execution/pipeline.py",
    f"{PKG}/serving/",
    f"{PKG}/distributed/worker.py",
    f"{PKG}/distributed/remote_worker.py",
)

#: terminal names that identify a partition/morsel/fetch stream
STREAM_NAMES = frozenset({
    "stream", "parts", "partitions", "morsels", "buf", "lbuf", "rbuf",
    "child", "fetches", "results", "batches",
})

#: calls that produce a partition stream
STREAM_CALLS = frozenset({
    "_exec", "_exec_node", "run_iter", "stream_batches", "materialize",
})

#: call last-names that ARE a cancellation check
CHECK_CALLS = frozenset({
    "check", "check_cancel", "_check_cancel", "poll_cancel",
    "_poll_cancel",
})

#: receivers a bare ``.check()`` / ``.is_set()`` must ride to count
_TOKENISH = ("token", "tok", "cancel")

RULE_IDS = {
    "uncancellable-loop": (
        "cancellation",
        "poll the CancelToken in the loop body (self._poll_cancel() / "
        "tok.check()) or pragma the mechanism that already covers it"),
}


def _call_last(call: ast.Call) -> str:
    return dataflow._call_last_name(call)


def _iter_terminal(expr: ast.AST) -> Optional[str]:
    """The terminal identifier of an iterated expression, looking
    through enumerate/zip/iter/reversed wrappers and subscripts."""
    if isinstance(expr, ast.Call) and _call_last(expr) in (
            "enumerate", "zip", "iter", "reversed", "list"):
        for a in expr.args:
            t = _iter_terminal(a)
            if t is not None:
                return t
        return None
    if isinstance(expr, ast.IfExp):
        return _iter_terminal(expr.body) or _iter_terminal(expr.orelse)
    if isinstance(expr, ast.Subscript):
        return _iter_terminal(expr.value)
    if isinstance(expr, ast.Attribute):
        return expr.attr
    if isinstance(expr, ast.Name):
        return expr.id
    return None


def _is_stream_iter(expr: ast.AST) -> bool:
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Call) and _call_last(sub) in STREAM_CALLS:
            return True
    t = _iter_terminal(expr)
    return t is not None and t in STREAM_NAMES


def _tokenish_recv(call: ast.Call) -> bool:
    if not isinstance(call.func, ast.Attribute):
        return False
    recv = dataflow.dotted(call.func.value).lower()
    return any(t in recv for t in _TOKENISH)


def _body_credited(body: List[ast.stmt], defs, depth: int = 1) -> bool:
    for stmt in body:
        # a yield/put/check inside a nested def (a callback defined in
        # the loop body) runs on some other call, not on this drain
        # iteration — it must not credit the loop; walk_local handles
        # defs nested deeper, the isinstance skips one AS the statement
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        for sub in walk_local(stmt):
            if isinstance(sub, (ast.Yield, ast.YieldFrom)):
                return True
            if not isinstance(sub, ast.Call):
                continue
            last = _call_last(sub)
            if last in CHECK_CALLS and (
                    last != "check" or _tokenish_recv(sub)
                    or not isinstance(sub.func, ast.Attribute)):
                return True
            if last == "is_set" and _tokenish_recv(sub):
                return True
            if last == "put" and isinstance(sub.func, ast.Attribute):
                return True  # Channel.put polls the pipeline cancel event
            if depth > 0:
                callee = defs.get(last)
                if callee is not None and _body_credited(
                        callee.body, defs, depth - 1):
                    return True
    return False


def check(sources: List[SourceFile]) -> List[Finding]:
    out: List[Finding] = []
    for sf in sources:
        if not any(sf.path == p or sf.path.startswith(p)
                   for p in SCOPE_PREFIXES):
            continue
        idx = ModuleIndex(sf.tree)
        for fname, fn in idx.functions:
            for sub in walk_local(fn):
                if not isinstance(sub, (ast.For, ast.AsyncFor)):
                    continue
                if not _is_stream_iter(sub.iter):
                    continue
                if _body_credited(sub.body, idx.defs):
                    continue
                out.append(Finding(
                    "uncancellable-loop", sf.path, sub.lineno,
                    f"loop over {ast.unparse(sub.iter)[:60]} in "
                    f"{fname}() drains a partition stream without a "
                    f"CancelToken check — INTERRUPT would run it to "
                    f"completion while holding admission"))
    return out

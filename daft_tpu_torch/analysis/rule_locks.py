"""Rule family — lock discipline, over the port.

The port's copy of ``daft_tpu/analysis/rule_locks.py``. The port holds
locks in the push engine's channels (``execution/pipeline.py``), the spill
stores (``execution/memory.py``, ``execution/spill_io.py``), the device
column cache (``device/cache.py``), the fused agg's slot registry
(``device/pipeline.py``) and the tracing and observability planes. Two
static hazards:

- ``blocking-under-lock`` — a blocking call (sleep, network request,
  ``future.result()``, file/socket I/O, a thread join, a ``.wait()``) made
  while a lock is held: every waiter on the lock now waits on it too. Per
  module AST plus a one-level call graph (a lock body calling a same-module
  helper that blocks is flagged at the call site).
- ``unguarded-global-mutation`` — a function rebinds module state
  (``global X``; ``X = ...``) outside any ``with <lock>:`` scope:
  check-then-set races under the engine's thread pools.

Lock recognition is lexical (a context-manager expression whose last name
holds ``lock`` or ``mutex``). The runtime lock-order sanitizer
(``analysis/lock_sanitizer.py``) covers what this cannot see: acquisition
cycles across modules, and contention.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from .framework import PKG, Finding, SourceFile, call_name

_STR_JOIN_PREFIXES = ("os.path", "posixpath", "ntpath")


def _is_lockish(expr: ast.AST) -> bool:
    from .framework import dotted_name
    name = call_name(expr) if isinstance(expr, ast.Call) \
        else dotted_name(expr)
    last = name.rsplit(".", 1)[-1].lower()
    return "lock" in last or "mutex" in last


def _blocking_reason(node: ast.Call) -> Optional[str]:
    name = call_name(node)
    if not name:
        return None
    first = name.split(".")[0]
    last = name.rsplit(".", 1)[-1]
    if name in ("time.sleep", "sleep"):
        return "time.sleep()"
    if first == "requests":
        return f"network I/O ({name})"
    if last == "urlopen":
        return "network I/O (urlopen)"
    if first == "subprocess":
        return f"subprocess ({name})"
    if name == "open":
        return "file I/O (open)"
    if first == "socket" and last in ("connect", "recv", "send", "sendall",
                                      "accept", "create_connection"):
        return f"socket I/O ({name})"
    if isinstance(node.func, ast.Attribute):
        recv = node.func.value
        if last == "result":
            return "future .result() wait"
        if last == "wait":
            return ".wait()"
        if last == "join":
            if isinstance(recv, ast.Constant) and isinstance(recv.value, str):
                return None     # ", ".join(...) — string building
            for pref in _STR_JOIN_PREFIXES:
                if name.startswith(pref + "."):
                    return None
            return ".join() wait"
    return None


def _local_defs(tree: ast.Module) -> Dict[str, ast.FunctionDef]:
    """name → def for module functions AND methods (last-name keyed —
    a lightweight call graph, deliberately one level deep)."""
    defs: Dict[str, ast.FunctionDef] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, node)
    return defs


def _direct_blocking(body_nodes) -> List[Tuple[ast.Call, str]]:
    out = []
    for stmt in body_nodes:
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.Call):
                why = _blocking_reason(sub)
                if why:
                    out.append((sub, why))
    return out


def check(sources: List[SourceFile]) -> List[Finding]:
    out: List[Finding] = []
    for sf in sources:
        if not sf.path.startswith(PKG + "/"):
            continue
        defs = _local_defs(sf.tree)
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.With) and any(
                    _is_lockish(item.context_expr) for item in node.items):
                out.extend(_check_lock_body(sf, node, defs))
        out.extend(_check_global_mutation(sf))
    return out


def _check_lock_body(sf: SourceFile, with_node: ast.With,
                     defs: Dict[str, ast.FunctionDef]) -> List[Finding]:
    out = []
    for call, why in _direct_blocking(with_node.body):
        out.append(Finding(
            "blocking-under-lock", sf.path, call.lineno,
            f"{why} while holding "
            f"{ast.unparse(with_node.items[0].context_expr)} — waiters on "
            f"the lock now wait on this too"))
    # one-level call graph: same-module helpers that block
    for stmt in with_node.body:
        for sub in ast.walk(stmt):
            if not isinstance(sub, ast.Call):
                continue
            callee = defs.get(call_name(sub).rsplit(".", 1)[-1])
            if callee is None:
                continue
            inner = _direct_blocking(callee.body)
            if inner:
                _, why = inner[0]
                out.append(Finding(
                    "blocking-under-lock", sf.path, sub.lineno,
                    f"call to {callee.name}() (which does {why} at line "
                    f"{inner[0][0].lineno}) while holding "
                    f"{ast.unparse(with_node.items[0].context_expr)}"))
    return out


def _check_global_mutation(sf: SourceFile) -> List[Finding]:
    out = []
    for fn in ast.walk(sf.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        globals_declared = set()
        for stmt in ast.walk(fn):
            if isinstance(stmt, ast.Global):
                globals_declared.update(stmt.names)
        if not globals_declared:
            continue
        hits: List[Tuple[str, int]] = []
        _walk_guarded(fn.body, False, globals_declared, hits)
        for name, line in hits:
            out.append(Finding(
                "unguarded-global-mutation", sf.path, line,
                f"module-level {name!r} rebound outside any `with <lock>:` "
                f"scope in {fn.name}() — check-then-set races under the "
                f"engine's thread pools"))
    return out


def _walk_guarded(stmts, inside_lock: bool, names, hits):
    for s in stmts:
        if isinstance(s, ast.With):
            locked = inside_lock or any(
                _is_lockish(item.context_expr) for item in s.items)
            _walk_guarded(s.body, locked, names, hits)
        elif isinstance(s, (ast.If, ast.For, ast.While)):
            _walk_guarded(s.body, inside_lock, names, hits)
            _walk_guarded(s.orelse, inside_lock, names, hits)
        elif isinstance(s, ast.Try):
            _walk_guarded(s.body, inside_lock, names, hits)
            for h in s.handlers:
                _walk_guarded(h.body, inside_lock, names, hits)
            _walk_guarded(s.orelse, inside_lock, names, hits)
            _walk_guarded(s.finalbody, inside_lock, names, hits)
        elif isinstance(s, (ast.Assign, ast.AugAssign)) and not inside_lock:
            targets = s.targets if isinstance(s, ast.Assign) else [s.target]
            for t in targets:
                if isinstance(t, ast.Name) and t.id in names:
                    hits.append((t.id, s.lineno))

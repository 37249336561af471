"""Intraprocedural CFG + one-level-summary interprocedural dataflow.

The port's own copy of ``daft_tpu/analysis/dataflow.py`` (the flow engine
under the resource, donation, cancellation and attribution rules).

Single-statement rules miss the lifecycle invariants that come in
*pairs*:
admission acquired at submit must be released on every done / failed /
cancelled path, every started trace must close, a donated device buffer
must never be touched after dispatch. Proving those needs flow: this
module builds a per-function control-flow graph over the Python AST —
including the try/except/finally/with edges where lifecycle bugs
actually hide — and a must-reach-on-all-paths solver on top of it.

Design notes (the RacerD lesson from the static-analysis literature:
compositional per-function summaries, not whole-program models):

- ``finally`` blocks are *instantiated per continuation* (normal exit,
  exception, return, break, continue each get their own copy), so a
  release in a ``finally`` is credited on exactly the paths that really
  run it, and an exception edge can never "borrow" a release that only
  happens on the normal path.
- Exception edges are conservative: any statement containing a call (or
  an explicit ``raise`` / ``assert``) may transfer to the innermost
  handler chain, or out of the function. This is where acquire/release
  pairs break in practice — a helper call between acquire and the
  ``try`` that was supposed to protect it.
- Call summaries are one level (iterated to a small fixpoint): a helper
  that performs the paired release on *all* of its own paths credits the
  call site in its caller, so release-in-a-helper idioms don't need
  pragmas.

Solver credit semantics: a credit (release) node credits every edge
leaving it, including its own exception edge — attempting the release is
the strongest guarantee any path can carry.
"""

from __future__ import annotations

import ast
from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple


class Node:
    """One CFG node: a simple statement, a branch header, or a synthetic
    entry/exit/dispatch point. ``succ`` holds ``(target, is_exc_edge)``."""

    __slots__ = ("stmt", "line", "kind", "succ", "branch")

    def __init__(self, stmt: Optional[ast.AST], kind: str = "stmt"):
        self.stmt = stmt
        self.line = getattr(stmt, "lineno", 0)
        self.kind = kind
        self.succ: List[Tuple["Node", bool]] = []
        #: for If headers: (body_entry, orelse_entry) — lets contract
        #: rules start tracking on the branch where a conditional
        #: acquire actually succeeded
        self.branch: Optional[Tuple["Node", "Node"]] = None

    def edge(self, target: "Node", exc: bool = False) -> None:
        self.succ.append((target, exc))

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"<Node {self.kind}@{self.line}>"


def _can_raise(node: ast.AST) -> bool:
    """Conservative may-raise: calls and explicit raises. Attribute /
    subscript errors exist but flagging them would drown the signal —
    lifecycle leaks happen across *call* boundaries."""
    for sub in ast.walk(node):
        if isinstance(sub, (ast.Call, ast.Raise, ast.Assert)):
            return True
    return False


def _const_true(test: ast.AST) -> bool:
    return isinstance(test, ast.Constant) and bool(test.value)


class CFG:
    """Control-flow graph of one function body."""

    def __init__(self, fn: ast.AST):
        self.fn = fn
        self.entry = Node(None, "entry")
        self.exit = Node(None, "exit")
        self.nodes: List[Node] = [self.entry, self.exit]
        #: id(stmt) → every node instantiated for it (finally regions
        #: are duplicated per continuation, so one stmt may own several)
        self.by_stmt: Dict[int, List[Node]] = {}
        first = self._build(list(fn.body), self.exit, self.exit,
                            self.exit, self.exit, self.exit)
        self.entry.edge(first)

    # ------------------------------------------------------------ build
    def _new(self, stmt: Optional[ast.AST], kind: str = "stmt") -> Node:
        n = Node(stmt, kind)
        self.nodes.append(n)
        if stmt is not None:
            self.by_stmt.setdefault(id(stmt), []).append(n)
        return n

    def _build(self, stmts: List[ast.stmt], nxt: Node, exc: Node,
               brk: Node, cnt: Node, ret: Node) -> Node:
        """Wire ``stmts`` so control enters at the returned node and
        leaves to the given continuations."""
        entry = nxt
        for stmt in reversed(stmts):
            entry = self._stmt(stmt, entry, exc, brk, cnt, ret)
        return entry

    def _stmt(self, s: ast.stmt, nxt: Node, exc: Node, brk: Node,
              cnt: Node, ret: Node) -> Node:
        if isinstance(s, ast.Return):
            n = self._new(s)
            n.edge(ret)
            if s.value is not None and _can_raise(s.value):
                n.edge(exc, exc=True)
            return n
        if isinstance(s, ast.Raise):
            n = self._new(s)
            n.edge(exc, exc=True)
            return n
        if isinstance(s, ast.Break):
            n = self._new(s)
            n.edge(brk)
            return n
        if isinstance(s, ast.Continue):
            n = self._new(s)
            n.edge(cnt)
            return n
        if isinstance(s, ast.If):
            n = self._new(s)
            body = self._build(s.body, nxt, exc, brk, cnt, ret)
            orelse = self._build(s.orelse, nxt, exc, brk, cnt, ret)
            n.edge(body)
            if orelse is not body:
                n.edge(orelse)
            n.branch = (body, orelse)
            if _can_raise(s.test):
                n.edge(exc, exc=True)
            return n
        if isinstance(s, (ast.While,)):
            n = self._new(s)
            body = self._build(s.body, n, exc, nxt, n, ret)
            n.edge(body)
            if not _const_true(s.test):
                # the else: clause of a loop is rare; fold it into nxt
                n.edge(self._build(s.orelse, nxt, exc, brk, cnt, ret)
                       if s.orelse else nxt)
            if _can_raise(s.test):
                n.edge(exc, exc=True)
            return n
        if isinstance(s, (ast.For, ast.AsyncFor)):
            n = self._new(s)
            body = self._build(s.body, n, exc, nxt, n, ret)
            n.edge(body)
            n.edge(self._build(s.orelse, nxt, exc, brk, cnt, ret)
                   if s.orelse else nxt)
            if _can_raise(s.iter):
                n.edge(exc, exc=True)
            return n
        if isinstance(s, (ast.With, ast.AsyncWith)):
            # the context managers' __exit__ runs on every path out of
            # the body; exceptions keep propagating (suppression is rare
            # enough to ignore), so the body simply inherits our
            # continuations. The header models the __enter__ calls.
            n = self._new(s)
            body = self._build(s.body, nxt, exc, brk, cnt, ret)
            n.edge(body)
            n.edge(exc, exc=True)  # __enter__ may raise
            return n
        if isinstance(s, ast.Try):
            return self._try(s, nxt, exc, brk, cnt, ret)
        # simple statement (incl. nested def/class, which we do not
        # descend into — nested functions get their own CFGs)
        n = self._new(s)
        n.edge(nxt)
        if _can_raise(s) and not isinstance(
                s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            n.edge(exc, exc=True)
        return n

    def _try(self, s: ast.Try, nxt: Node, exc: Node, brk: Node,
             cnt: Node, ret: Node) -> Node:
        if s.finalbody:
            # one finally copy per live continuation: the release-in-
            # finally credit must hold on exactly the paths that run it
            fin_nxt = self._build(s.finalbody, nxt, exc, brk, cnt, ret)
            fin_exc = self._build(s.finalbody, exc, exc, brk, cnt, ret)
            fin_brk = self._build(s.finalbody, brk, exc, brk, cnt, ret)
            fin_cnt = self._build(s.finalbody, cnt, exc, brk, cnt, ret)
            fin_ret = self._build(s.finalbody, ret, exc, brk, cnt, ret)
        else:
            fin_nxt, fin_exc = nxt, exc
            fin_brk, fin_cnt, fin_ret = brk, cnt, ret
        if s.handlers:
            dispatch = self._new(None, "dispatch")
            caught_all = False
            for h in s.handlers:
                h_entry = self._build(h.body, fin_nxt, fin_exc,
                                      fin_brk, fin_cnt, fin_ret)
                dispatch.edge(h_entry)
                if h.type is None or (isinstance(h.type, ast.Name)
                                      and h.type.id == "BaseException"):
                    caught_all = True
            if not caught_all:
                # the exception may match no handler and escape
                dispatch.edge(fin_exc)
            body_exc = dispatch
        else:
            body_exc = fin_exc
        orelse = self._build(s.orelse, fin_nxt, fin_exc, fin_brk,
                             fin_cnt, fin_ret) if s.orelse else fin_nxt
        return self._build(s.body, orelse, body_exc, fin_brk, fin_cnt,
                           fin_ret)

    # ----------------------------------------------------------- lookup
    def nodes_for(self, stmt: ast.AST) -> List[Node]:
        return self.by_stmt.get(id(stmt), [])


# -------------------------------------------------------------- solver

def find_escape(cfg: CFG, starts: Iterable[Node],
                credit: Callable[[Node], bool],
                exc_only: bool = False) -> Optional[Tuple[int, bool]]:
    """Is there a path from ``starts`` to function exit that never passes
    a credit node? Returns ``(line, via_exception)`` of the escaping
    step, or None when every such path is credited.

    ``exc_only`` restricts the violation to paths that traverse at least
    one exception edge — the mode for contracts whose normal-path release
    is handed off dynamically (trace recorders adopted by the executor)
    but whose exception edges must still clean up.

    A credit node credits every edge leaving it (including its own
    exception edge): attempting the release is all any path can do.
    """
    seen: Set[Tuple[int, bool]] = set()
    # (node, saw_exc, last_line, last_was_exc)
    stack: List[Tuple[Node, bool, int, bool]] = []
    for n in starts:
        stack.append((n, False, n.line, False))
    best: Optional[Tuple[int, bool]] = None
    while stack:
        node, saw_exc, line, was_exc = stack.pop()
        key = (id(node), saw_exc)
        if key in seen:
            continue
        seen.add(key)
        if node.kind == "exit":
            if saw_exc or not exc_only:
                cand = (line, was_exc)
                if best is None or (cand[1] and not best[1]):
                    best = cand
                if best[1]:
                    return best
            continue
        if credit(node):
            continue  # every edge out of a credit node is credited
        nline = node.line or line
        for tgt, is_exc in node.succ:
            stack.append((tgt, saw_exc or is_exc,
                          nline if node.line else line, is_exc))
    return best


def hits_on_all_paths(cfg: CFG, credit: Callable[[Node], bool]) -> bool:
    """True when every entry→exit path passes a credit node — the
    summary predicate: "this helper releases on the caller's behalf"."""
    return find_escape(cfg, [cfg.entry], credit) is None


# ------------------------------------------------------- function index

def iter_functions(tree: ast.Module):
    """Every function/method in the module, with its dotted display
    name (``Class.method`` for methods)."""
    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield (f"{prefix}{child.name}", child)
                yield from walk(child, f"{prefix}{child.name}.")
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, f"{prefix}{child.name}.")
            else:
                yield from walk(child, prefix)
    yield from walk(tree, "")


class ModuleIndex:
    """Per-module function index with lazily built CFGs and one-level
    release summaries, shared by the flow-sensitive rule families."""

    def __init__(self, tree: ast.Module):
        self.functions: List[Tuple[str, ast.AST]] = list(iter_functions(tree))
        #: last-name → def (first wins), the lightweight call-graph key
        self.defs: Dict[str, ast.AST] = {}
        for name, fn in self.functions:
            self.defs.setdefault(fn.name, fn)
        self._cfgs: Dict[int, CFG] = {}

    def cfg(self, fn: ast.AST) -> CFG:
        c = self._cfgs.get(id(fn))
        if c is None:
            c = CFG(fn)
            self._cfgs[id(fn)] = c
        return c

    def release_summaries(
            self, is_release: Callable[[ast.AST], bool]) -> Set[str]:
        """Names of functions that perform a matching release on ALL of
        their own paths — iterated to a fixpoint so a helper calling a
        releasing helper is credited too (the "one level" the contract
        rules need, and then some)."""
        summary: Set[str] = set()
        changed = True
        rounds = 0
        while changed and rounds < 4:
            changed = False
            rounds += 1
            for name, fn in self.functions:
                if fn.name in summary:
                    continue

                def credit(node: Node, _sum=frozenset(summary)) -> bool:
                    for sub in node_header_calls(node):
                        if is_release(sub):
                            return True
                        if _call_last_name(sub) in _sum:
                            return True
                    return False

                if hits_on_all_paths(self.cfg(fn), credit):
                    summary.add(fn.name)
                    changed = True
        return summary

    def calls_anywhere(self, names: Set[str], depth: int = 3) -> Set[str]:
        """Names of functions that (transitively, bounded) call one of
        ``names`` anywhere in their body — the attribution-installer
        summary, where presence (not all-paths) is the right question."""
        installed: Set[str] = set()
        for _ in range(depth):
            grew = False
            for _, fn in self.functions:
                if fn.name in installed:
                    continue
                for sub in ast.walk(fn):
                    if isinstance(sub, ast.Call):
                        last = _call_last_name(sub)
                        if last in names or last in installed:
                            installed.add(fn.name)
                            grew = True
                            break
            if not grew:
                break
        return installed


def stmt_header_parts(stmt: ast.AST) -> List[ast.AST]:
    """The expressions a CFG node for ``stmt`` actually represents —
    compound statements contribute only their header, so a call in an
    If *body* can't credit the If header node."""
    if isinstance(stmt, (ast.If, ast.While)):
        return [stmt.test]
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.iter]
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return [i.context_expr for i in stmt.items]
    if isinstance(stmt, (ast.Try, ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return []
    return [stmt]


def node_header_calls(node: Node) -> List[ast.Call]:
    """Every call the CFG node itself evaluates (headers only, no
    descent into nested function/class definitions)."""
    if node.stmt is None:
        return []
    out: List[ast.Call] = []
    for part in stmt_header_parts(node.stmt):
        stack = [part]
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef, ast.Lambda)):
                continue
            if isinstance(n, ast.Call):
                out.append(n)
            stack.extend(ast.iter_child_nodes(n))
    return out


def _call_last_name(call: ast.Call) -> str:
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def dotted(node: ast.AST) -> str:
    """``a.b.c`` for Name/Attribute chains, else ''."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""

"""Rule family — paired-lifecycle resource contracts (flow-sensitive),
over the port.

The port's copy of ``daft_tpu/analysis/rule_resources.py``, with the
contract table pointed at the port's own acquire/release pairs: memory
admission, trace recorders, the fused agg's device slots, thread pools,
the spill stores and their writer groups, the pinned host buffer of a
device→host fetch (``column.fetch_host_async`` → ``HostFetch.wait``), and
the per-query torch.profiler capture (``observability.profile_capture`` →
``ProfileCapture.stop`` / ``end_query``). Each invariant is one entry in
:data:`CONTRACTS`; the must-reach solver (:mod:`.dataflow`) proves the
paired release on every exit path, the exception edges included.

The reference's ``shuffle-cache-leak`` (``ShuffleCache``) and
``collective-lease-leak`` (``topology.acquire_collective``) contracts wait
for the distributed tier (ROADMAP A7), which brings those resources.

Release credit, in decreasing strength:

- a matching release call on the same receiver (event style) or tracked
  name (object style);
- a ``finally`` that releases — the CFG instantiates finally per
  continuation, so this credits exactly the paths that run it;
- a call to a same-module helper that releases on ALL of its own paths
  (one-level call summaries, iterated);
- object style only: ownership transfer — the resource is returned,
  yielded, stored into an attribute/container, or passed whole to
  another call.

A second, syntactic check rides along: ``scope-helper-not-with`` — the
context installers (``cancel_scope``, ``tracing.attach``,
``observability.attributed``, ``nested_scope``, ``tracing.span``) only
uninstall via ``__exit__``, so calling one outside a ``with`` item
installs a scope that nothing removes.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, List, Optional, Set, Tuple

from . import dataflow
from .dataflow import CFG, ModuleIndex, Node, dotted
from .framework import PKG, Finding, SourceFile

#: receiver last-names that look like a memory/admission manager — the
#: engine's uniform naming (self.mem, self.admission, mm, manager)
_MEM_RECV = re.compile(r"(^|\.)(mem|memory|admission|manager|mm)$")


@dataclasses.dataclass(frozen=True)
class Contract:
    rule: str               # finding id (pragma target)
    style: str              # "event" | "object"
    mode: str               # "all" | "exc" (exception edges only)
    acquire: Tuple[str, ...]        # call last-names that acquire
    release: Tuple[str, ...]        # call last-names that release
    hint: str
    #: event style: receiver pattern the acquire must match (None = any)
    recv: Optional[re.Pattern] = None
    #: object style: callee last-names that do NOT take ownership when
    #: the tracked object is passed as an argument
    non_owning: Tuple[str, ...] = ()
    #: modules (path suffixes) whose own definitions are exempt
    defining: Tuple[str, ...] = ()
    #: object style: a release call credits regardless of its arguments
    #: — for resources adopted invisibly through thread-local context
    #: (the stats ctx picks the current trace up via tracing.current()),
    #: where the finalize chokepoint never names the tracked binding
    release_anywhere: bool = False


#: The contract table: a new acquire/release pair is one entry here, no
#: solver change.
CONTRACTS: Tuple[Contract, ...] = (
    Contract(
        rule="memory-admission-leak", style="event", mode="all",
        acquire=("acquire", "try_acquire"), release=("release",),
        recv=_MEM_RECV,
        hint="wrap the post-acquire region in try/finally: "
             "<mgr>.release(n), or release in every handler",
    ),
    Contract(
        rule="trace-recorder-leak", style="object", mode="exc",
        acquire=("maybe_start_trace",),
        release=("finalize_query", "unregister_recorder", "abort_trace",
                 "_end_trace", "set_last_stats"),
        non_owning=("attach", "span", "event", "run_attached",
                    "wire_headers", "SpanContext"),
        defining=(f"{PKG}/tracing.py", f"{PKG}/observability.py"),
        release_anywhere=True,
        hint="on the exception path call tracing.abort_trace(ctx) (or "
             "finalize) before re-raising — a registered recorder must "
             "not outlive its query",
    ),
    Contract(
        rule="recorder-registration-leak", style="event", mode="exc",
        acquire=("register_recorder",), release=("unregister_recorder",),
        defining=(f"{PKG}/tracing.py",),
        hint="pair register_recorder with unregister_recorder on every "
             "exception path (try/finally or the error handler)",
    ),
    Contract(
        rule="device-slot-leak", style="object", mode="all",
        acquire=("acquire_slot",), release=("release_slot",),
        defining=(f"{PKG}/device/pipeline.py",),
        hint="release_slot(slot) on every decline/error path, or hand "
             "the slot off whole (InflightItem) so the pipeline driver "
             "releases it on drain — an in-flight slot owns window "
             "occupancy AND memory admission",
    ),
    Contract(
        rule="pool-leak", style="object", mode="all",
        acquire=("ThreadPoolExecutor",), release=("shutdown",),
        hint="shutdown() the locally created pool on every exit path, "
             "use `with ThreadPoolExecutor(...)`, or store it on the "
             "owner that shuts it down",
    ),
    Contract(
        rule="spill-store-leak", style="object", mode="all",
        acquire=("SpillBuffer", "PartitionedSpillStore",
                 "SplitSpillBuffer", "materialize", "drain_to_store"),
        release=("close",),
        defining=(f"{PKG}/execution/memory.py",
                  f"{PKG}/execution/out_of_core.py"),
        hint="close() the spill buffer/store on every exit path "
             "(try/finally or `with`), or transfer ownership by "
             "returning/storing it — a leaked store strands its spill "
             "directory until GC",
    ),
    Contract(
        rule="spill-writer-pool-leak", style="object", mode="all",
        acquire=("SpillWriterGroup",),
        release=("drain", "close"),
        defining=(f"{PKG}/execution/spill_io.py",
                  f"{PKG}/execution/memory.py"),
        hint="drain() (raising — finalize paths) or close() (no-raise "
             "cleanup) the writer group on every exit path, or store it "
             "on the spill store that closes it — an abandoned group "
             "leaves chained writes racing the store's file deletion",
    ),
    Contract(
        rule="pinned-fetch-leak", style="object", mode="all",
        acquire=("fetch_host_async",), release=("wait",),
        defining=(f"{PKG}/device/column.py",),
        hint="wait() the fetch on every exit path, or hand it off whole "
             "(stored on the in-flight token) — its pinned host buffer "
             "and its event stay held until then",
    ),
    Contract(
        rule="profile-capture-leak", style="object", mode="all",
        acquire=("profile_capture",), release=("stop", "end_query"),
        defining=(f"{PKG}/observability.py",),
        hint="stop() the capture (or observability.end_query(stats, "
             "capture)) on every exit path — a running capture holds the "
             "process's one profiler and every later query loses its own",
    ),
)

#: context installers that only uninstall via __exit__
_SCOPE_HELPERS = ("cancel_scope", "attach", "attributed", "nested_scope",
                  "span")
_SCOPE_DEFINING = (f"{PKG}/tracing.py", f"{PKG}/observability.py",
                   f"{PKG}/execution/cancellation.py")

RULE_IDS: Dict[str, Tuple[str, str]] = {
    c.rule: ("resources", c.hint) for c in CONTRACTS
}
RULE_IDS["scope-helper-not-with"] = (
    "resources",
    "use the installer as a `with` item (or assign then `with name:`) "
    "so the scope uninstalls on every path")


def _call_last(call: ast.Call) -> str:
    return dataflow._call_last_name(call)


def _recv_text(call: ast.Call) -> str:
    if isinstance(call.func, ast.Attribute):
        return dotted(call.func.value)
    return ""


def walk_local(node: ast.AST):
    """ast.walk that yields nested function/class/lambda nodes but does
    not descend into their bodies (they own their own CFGs)."""
    stack = [node]
    first = True
    while stack:
        n = stack.pop()
        nested = not first and isinstance(
            n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                ast.Lambda))
        first = False
        if not nested:
            stack.extend(ast.iter_child_nodes(n))
        yield n


# single-sourced in dataflow (the summaries use the same header rule)
_header_parts = dataflow.stmt_header_parts
node_calls = dataflow.node_header_calls


def _stmt_of(fn: ast.AST, cfg: CFG, target: ast.AST) -> Optional[ast.AST]:
    """The innermost statement owning ``target`` that has CFG nodes."""
    chain: List[ast.AST] = []

    def find(node) -> bool:
        for child in ast.iter_child_nodes(node):
            if child is target or find(child):
                chain.append(node)
                return True
        return False

    find(fn)
    for anc in chain:  # innermost-first
        if cfg.nodes_for(anc):
            return anc
    return None


def _acquire_start_nodes(cfg: CFG, fn: ast.AST,
                         call: ast.Call) -> List[Node]:
    """Where tracking begins for one acquire call: its statement's
    normal successors — or, for a conditional ``try_acquire`` used as an
    If test, the branch where the acquisition actually succeeded."""
    stmt = _stmt_of(fn, cfg, call)
    if stmt is None:
        return []
    starts: List[Node] = []
    negated = None
    if isinstance(stmt, ast.If):
        in_test = any(sub is call for sub in ast.walk(stmt.test))
        if in_test:
            negated = isinstance(stmt.test, ast.UnaryOp) and \
                isinstance(stmt.test.op, ast.Not)
    for node in cfg.nodes_for(stmt):
        if negated is not None and node.branch is not None:
            starts.append(node.branch[1] if negated else node.branch[0])
        else:
            starts.extend(t for t, is_exc in node.succ if not is_exc)
    return starts


# ------------------------------------------------------- event contracts

def _check_event(sf: SourceFile, idx: ModuleIndex, c: Contract,
                 out: List[Finding]) -> None:
    if any(sf.path.endswith(d) for d in c.defining):
        return

    def is_release(call: ast.Call, recv: Optional[str] = None) -> bool:
        if _call_last(call) not in c.release:
            return False
        return recv is None or _recv_text(call) == recv

    summaries = idx.release_summaries(lambda call: is_release(call))

    for name, fn in idx.functions:
        cfg = None
        for sub in walk_local(fn):
            if not (isinstance(sub, ast.Call)
                    and _call_last(sub) in c.acquire):
                continue
            recv = _recv_text(sub)
            if c.recv is not None and not c.recv.search(recv or "-"):
                continue
            cfg = cfg or idx.cfg(fn)
            starts = _acquire_start_nodes(cfg, fn, sub)
            if not starts:
                continue

            def credit(node: Node) -> bool:
                for call in node_calls(node):
                    if is_release(call, recv or None):
                        return True
                    if _call_last(call) in summaries:
                        return True
                return False

            esc = dataflow.find_escape(cfg, starts, credit,
                                       exc_only=(c.mode == "exc"))
            if esc is not None:
                line, via_exc = esc
                how = "on an exception path" if (c.mode == "exc"
                                                 or via_exc) \
                    else "normally"
                out.append(Finding(
                    c.rule, sf.path, sub.lineno,
                    f"{_call_last(sub)}() in {name}() can exit {how} "
                    f"near line {line} without reaching "
                    f"{'/'.join(c.release)} — paired release must cover "
                    f"every {'exception ' if c.mode == 'exc' else ''}path"))


# ------------------------------------------------------ object contracts

def _binding_name(fn: ast.AST, call: ast.Call) -> Optional[str]:
    """The local Name a constructor call is bound to, or None when the
    result escapes immediately (attribute/subscript target, call arg,
    return) or is discarded."""
    for sub in walk_local(fn):
        if isinstance(sub, ast.Assign) and sub.value is call:
            if len(sub.targets) == 1 and isinstance(sub.targets[0],
                                                    ast.Name):
                return sub.targets[0].id
            return None
    return None


def _captured_by_nested_def(fn: ast.AST, name: str) -> bool:
    for sub in walk_local(fn):
        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef, ast.Lambda)) and sub is not fn:
            for inner in ast.walk(sub):
                if isinstance(inner, ast.Name) and inner.id == name:
                    return True
    return False


def _in_with_item(fn: ast.AST, call: ast.Call) -> bool:
    for sub in walk_local(fn):
        if isinstance(sub, (ast.With, ast.AsyncWith)):
            for item in sub.items:
                if item.context_expr is call:
                    return True
    return False


def _globals_of(fn: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for sub in walk_local(fn):
        if isinstance(sub, ast.Global):
            out.update(sub.names)
    return out


def _object_credit_stmt(stmt: ast.AST, name: str, c: Contract) -> bool:
    """Does this statement release or transfer ownership of ``name``?"""
    for part in _header_parts(stmt):
        for sub in walk_local(part):
            if isinstance(sub, ast.Call):
                if _call_last(sub) in c.release \
                        and (c.release_anywhere
                             or _recv_text(sub) == name):
                    return True
                # ownership transfer: the object passed whole as an arg
                # to anything except the known non-owning helpers
                if _call_last(sub) not in c.non_owning:
                    for a in list(sub.args) + [k.value for k in
                                               sub.keywords]:
                        if isinstance(a, ast.Name) and a.id == name:
                            return True
            if isinstance(sub, (ast.Return, ast.Yield, ast.YieldFrom)) \
                    and sub.value is not None:
                # ownership transfer only when the object itself is
                # returned (bare, or as a tuple/list element) — returning
                # `pool.submit(...).result()` hands nothing over
                cands = [sub.value]
                if isinstance(sub.value, (ast.Tuple, ast.List)):
                    cands = list(sub.value.elts)
                for inner in cands:
                    if isinstance(inner, ast.Name) and inner.id == name:
                        return True
            if isinstance(sub, ast.Assign):
                # stored into an attribute / container / another name:
                # ownership moved; also a rebind ends this tracking
                for inner in ast.walk(sub):
                    if isinstance(inner, (ast.Attribute, ast.Subscript)) \
                            and isinstance(getattr(inner, "ctx", None),
                                           ast.Store):
                        for leaf in ast.walk(sub.value):
                            if isinstance(leaf, ast.Name) \
                                    and leaf.id == name:
                                return True
                for t in sub.targets:
                    if isinstance(t, ast.Name) and t.id == name \
                            and sub.value is not None \
                            and not isinstance(sub.value, ast.Call):
                        return True
    return False


def _check_object(sf: SourceFile, idx: ModuleIndex, c: Contract,
                  out: List[Finding]) -> None:
    if any(sf.path.endswith(d) for d in c.defining):
        return
    for name, fn in idx.functions:
        for sub in walk_local(fn):
            if not (isinstance(sub, ast.Call)
                    and _call_last(sub) in c.acquire):
                continue
            if _in_with_item(fn, sub):
                continue  # context-managed: released by __exit__
            bound = _binding_name(fn, sub)
            if bound is None:
                continue  # immediate escape / ownership elsewhere
            if bound in _globals_of(fn):
                continue  # module-global singleton, owner elsewhere
            if _captured_by_nested_def(fn, bound):
                continue  # closure-captured: lifetime is the closure's
            cfg = idx.cfg(fn)
            starts = _acquire_start_nodes(cfg, fn, sub)
            if not starts:
                continue

            def credit(node: Node) -> bool:
                return node.stmt is not None and _object_credit_stmt(
                    node.stmt, bound, c)

            esc = dataflow.find_escape(cfg, starts, credit,
                                       exc_only=(c.mode == "exc"))
            if esc is not None:
                line, via_exc = esc
                how = "on an exception path" if (c.mode == "exc"
                                                 or via_exc) \
                    else "normally"
                out.append(Finding(
                    c.rule, sf.path, sub.lineno,
                    f"{_call_last(sub)}() bound to {bound!r} in {name}() "
                    f"can exit {how} near line {line} without "
                    f"{'/'.join(c.release)}() or an ownership transfer"))


# ------------------------------------------------- scope-helper misuse

def _check_scope_helpers(sf: SourceFile, out: List[Finding]) -> None:
    if any(sf.path.endswith(d) for d in _SCOPE_DEFINING):
        return
    tree = sf.tree
    with_items: Set[int] = set()
    with_names: Set[str] = set()
    arg_positions: Set[int] = set()
    assigns: Dict[int, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                with_items.add(id(item.context_expr))
                if isinstance(item.context_expr, ast.Name):
                    with_names.add(item.context_expr.id)
        if isinstance(node, ast.Call):
            for a in list(node.args) + [k.value for k in node.keywords]:
                arg_positions.add(id(a))
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            assigns[id(node.value)] = node.targets[0].id
        if isinstance(node, ast.Return) and node.value is not None:
            arg_positions.add(id(node.value))
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        last = _call_last(node)
        if last not in _SCOPE_HELPERS:
            continue
        recv = _recv_text(node)
        # `span`/`attach`/`attributed` must come off the tracing /
        # observability modules (or bare import); an arbitrary `.span()`
        # method on some other object is not ours
        if last in ("span", "attach") and recv not in (
                "", "tracing", "obs", "observability"):
            continue
        if last == "attributed" and recv not in ("", "obs",
                                                 "observability"):
            continue
        if id(node) in with_items or id(node) in arg_positions:
            continue
        bound = assigns.get(id(node))
        if bound is not None and bound in with_names:
            continue  # sp = tracing.span(...); ... with sp: — fine
        out.append(Finding(
            "scope-helper-not-with", sf.path, node.lineno,
            f"{last}() installs a thread scope that only uninstalls via "
            f"__exit__ — use it as a `with` item (or enter the bound "
            f"name in a `with`)"))


# ---------------------------------------------------------------- check

def check(sources: List[SourceFile]) -> List[Finding]:
    out: List[Finding] = []
    for sf in sources:
        if not sf.path.startswith(PKG + "/"):
            continue
        idx = ModuleIndex(sf.tree)
        for c in CONTRACTS:
            if c.style == "event":
                _check_event(sf, idx, c, out)
            else:
                _check_object(sf, idx, c, out)
        _check_scope_helpers(sf, out)
    return out

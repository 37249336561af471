"""Rule family — shape stability of the device tier, over the port (the
torch counterpart of the reference's ``rule_shapes``).

The port compiles nothing per shape, but a shape still costs: the caching
allocator keeps freed blocks by size, so a capacity that follows a literal
row count asks for a fresh size on every batch, and a fresh size past the
cached blocks is a new segment (a ``cudaMalloc``, which synchronizes the
card); the hash-agg build's launch plan (``hash_kernels._plan``) and the
join's layouts are per capacity too. Two rules:

- ``shape-unbucketed`` — a raw row count (``len(batch)``, ``.num_rows``,
  ``.row_count``) reaches a kernel or device-program capacity (``out_cap=``,
  ``capacity=``, ``cap=``, ``T=`` and the size of a ``torch.empty`` /
  ``zeros`` / ``full`` / ``ones`` / ``arange``) without passing through the
  size-class chokepoint ``device/column.bucket_capacity`` (or
  ``hash_kernels.table_capacity`` / ``join_kernels.join_table_capacity``,
  which bucket a bucketed capacity further). Host numpy allocations are
  free to be row-sized.
- ``program-not-memoized`` — a device program (``compiler.compile_projection``
  and the fused agg / region / join_agg programs of ``device/fragment.py``)
  constructed inside a function without a memo store (a cache dict, an
  object attribute or a declared-``global`` rebind): a program rebuilt per
  call where the reference memoizes one (``runtime._get_compiled``,
  ``fragment.get_fused_agg``). A harness that times the construction
  carries a pragma.

The runtime twin is ``analysis/retrace_sanitizer.py``, which charges new
device memory at the declared dispatch sites against their budgets.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from .framework import PKG, Finding, SourceFile, call_name

RULE_IDS: Dict[str, Tuple[str, str]] = {
    "shape-unbucketed": (
        "shapes", "route the row count through column.bucket_capacity "
                  "(the size-class chokepoint) before it becomes a "
                  "capacity"),
    "program-not-memoized": (
        "shapes", "memoize the device program in a module-level cache "
                  "keyed on its signature (the runtime._get_compiled "
                  "pattern)"),
}

#: modules whose shapes feed device programs and kernels
_SHAPE_SCOPE_PREFIXES = (f"{PKG}/device/",)
_SHAPE_SCOPE_FILES = (f"{PKG}/joins.py", f"{PKG}/window_exec.py")

#: the sanctioned size-class chokepoints
SANCTIONED_CALLS = ("bucket_capacity", "size_classes", "table_capacity",
                    "join_table_capacity")

#: capacity-like keyword sinks at kernel / program calls
SHAPE_KWARGS = {"out_cap", "out_capacity", "capacity", "cap", "table_cap",
                "T"}

#: device tensor constructors whose first positional argument is a size
_ARRAY_CTORS = {"torch.zeros", "torch.full", "torch.empty", "torch.ones",
                "torch.arange"}

#: row-count attribute seeds
_ROWCOUNT_ATTRS = {"num_rows", "row_count"}

#: device-program constructors (last name) the memo rule tracks
PROGRAM_CTORS = {"compile_projection", "FusedAggProgram",
                 "FusedRegionProgram", "FusedJoinAggProgram"}


# --------------------------------------------------------- memo rule

def _iter_scoped_functions(tree: ast.Module):
    """Every (FunctionDef, its own direct AST nodes) — nested defs are
    yielded separately and EXCLUDED from the parent's node set, so a
    memo decision is judged against the function that actually runs
    per call."""
    funcs = [n for n in ast.walk(tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for fn in funcs:
        own: List[ast.AST] = []
        stack: List[ast.AST] = list(fn.body)
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # the nested def's decorators execute in THIS scope
                own.extend(n.decorator_list)
                continue
            own.append(n)
            stack.extend(ast.iter_child_nodes(n))
        yield fn, own


def _memo_stored(fn: ast.AST, own_nodes: List[ast.AST],
                 ctor_call: ast.Call) -> bool:
    """True when the program (directly, via its assigned name, or via
    an object constructed from it) is stored into a cache: a Subscript
    or Attribute target, or a declared-``global`` name."""
    # the statement whose value expression contains the construction
    stmt = None
    for n in own_nodes:
        if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            if any(x is ctor_call for x in ast.walk(n)):
                stmt = n
                break
    if stmt is None:
        return False
    targets = stmt.targets if isinstance(stmt, ast.Assign) \
        else [stmt.target]
    for tgt in targets:
        if _is_store(own_nodes, tgt):
            return True
    globals_: Set[str] = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Global):
            globals_.update(n.names)
    tainted: Set[str] = set()
    for tgt in targets:
        for n in ast.walk(tgt):
            if isinstance(n, ast.Name):
                tainted.add(n.id)
    if tainted & globals_:
        return True
    # follow the name through later statements: a store into a
    # Subscript/Attribute (or a re-assignment that keeps the taint), or a
    # ``cache.setdefault(key, prog)`` on a cache the function reads
    for _ in range(4):
        grew = False
        for n in own_nodes:
            if isinstance(n, ast.Call) \
                    and isinstance(n.func, ast.Attribute) \
                    and n.func.attr == "setdefault" \
                    and any(isinstance(x, ast.Name) and x.id in tainted
                            for a in n.args for x in ast.walk(a)):
                return True
        for n in own_nodes:
            if not isinstance(n, ast.Assign):
                continue
            names = {x.id for x in ast.walk(n.value)
                     if isinstance(x, ast.Name)}
            if not names & tainted:
                continue
            for tgt in n.targets:
                if _is_store(own_nodes, tgt):
                    return True
                for x in ast.walk(tgt):
                    if isinstance(x, ast.Name) and x.id not in tainted:
                        tainted.add(x.id)
                        grew = True
            if tainted & globals_:
                return True
        if not grew:
            break
    return False


def _is_store(own_nodes: List[ast.AST], tgt: ast.AST) -> bool:
    """``tgt`` stores into a cache: an attribute, or a subscript of a
    container the function also reads (``.get``, a subscript load, an
    ``in`` test). A container only written to is a registry, not a memo:
    every call still builds its program."""
    if isinstance(tgt, ast.Attribute):
        return True
    if not isinstance(tgt, ast.Subscript):
        return False
    box = ast.dump(tgt.value)
    for n in own_nodes:
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr in ("get", "setdefault") \
                and ast.dump(n.func.value) == box:
            return True
        if isinstance(n, ast.Subscript) and isinstance(n.ctx, ast.Load) \
                and ast.dump(n.value) == box:
            return True
        if isinstance(n, ast.Compare) \
                and any(isinstance(op, (ast.In, ast.NotIn)) for op in n.ops) \
                and any(ast.dump(c) == box for c in n.comparators):
            return True
    return False


def check_program_memo(sources: List[SourceFile]) -> List[Finding]:
    out: List[Finding] = []
    for sf in sources:
        if not sf.path.startswith(PKG + "/") \
                or sf.path.startswith(f"{PKG}/analysis/"):
            continue
        for fn, own in _iter_scoped_functions(sf.tree):
            for n in own:
                if isinstance(n, ast.Call) \
                        and call_name(n).rsplit(".", 1)[-1] in PROGRAM_CTORS \
                        and not _returned(own, n) \
                        and not _cached_via_helper(own, n) \
                        and not _memo_stored(fn, own, n):
                    out.append(Finding(
                        "program-not-memoized", sf.path, n.lineno,
                        f"{call_name(n)}(...) constructed inside "
                        f"{fn.name}() without a memo store — the device "
                        f"program is rebuilt on every call"))
    return out


def _returned(own: List[ast.AST], call: ast.Call) -> bool:
    """The construction is returned to the caller, who owns the memo."""
    for n in own:
        if isinstance(n, ast.Return) and n.value is not None \
                and any(x is call for x in ast.walk(n.value)):
            return True
    return False


def _cached_via_helper(own: List[ast.AST], call: ast.Call) -> bool:
    """The construction's name (directly, or through a program built from
    it) is handed to a cache helper — a call whose name holds ``cache``
    (``fragment._cache_region(key, prog)``, a locked ``setdefault``)."""
    names: Set[str] = set()
    for _ in range(4):
        before = len(names)
        for n in own:
            if isinstance(n, ast.Assign) \
                    and (any(x is call for x in ast.walk(n.value))
                         or {x.id for x in ast.walk(n.value)
                             if isinstance(x, ast.Name)} & names):
                for t in n.targets:
                    names.update(x.id for x in ast.walk(t)
                                 if isinstance(x, ast.Name))
        if len(names) == before:
            break
    for n in own:
        if isinstance(n, ast.Call) \
                and "cache" in call_name(n).rsplit(".", 1)[-1].lower() \
                and any(isinstance(a, ast.Name) and a.id in names
                        for a in n.args):
            return True
    return False


# ------------------------------------------------------ shape taint rule

def _contains_sanctioned(expr: ast.AST) -> bool:
    for n in ast.walk(expr):
        if isinstance(n, ast.Call):
            name = call_name(n)
            if name.split(".")[-1] in SANCTIONED_CALLS:
                return True
    return False


def _is_seed(expr: ast.AST) -> bool:
    """A raw row-count expression: ``len(...)`` or ``.num_rows`` /
    ``.row_count`` attribute reads."""
    if isinstance(expr, ast.Call) and call_name(expr) == "len":
        return True
    if isinstance(expr, ast.Attribute) and expr.attr in _ROWCOUNT_ATTRS:
        return True
    return False


#: calls a row count flows THROUGH unchanged; every other call's result
#: is a fresh value the taint does not survive (a kernel returning group
#: blocks from a tainted plane is not itself a raw row count)
_PASSTHROUGH_CALLS = {"min", "max", "int", "round", "abs", "float", "len"}


def _taint_signal(expr: ast.AST, tainted: Set[str]) -> bool:
    """True when ``expr`` evaluates to a raw row count: it contains a
    seed or a tainted name OUTSIDE non-passthrough call arguments, and
    no sanctioned size-class chokepoint on the way."""
    if _contains_sanctioned(expr):
        return False
    stack = [expr]
    while stack:
        n = stack.pop()
        if _is_seed(n):
            return True
        if isinstance(n, ast.Name) and n.id in tainted:
            return True
        if isinstance(n, ast.Call):
            # len(x) seeds via _is_seed above; min/max/etc. pass the
            # count through; other calls LAUNDER the taint (their result
            # is not a row count even when their arguments were)
            if call_name(n).split(".")[-1] in _PASSTHROUGH_CALLS:
                stack.extend(n.args)
                stack.extend(kw.value for kw in n.keywords)
            continue
        stack.extend(ast.iter_child_nodes(n))
    return False


def _direct_nodes(fn: ast.AST):
    """(own AST nodes, nested function defs) — a nested def is its own
    scope; judging its sinks against the parent's taint conflates two
    bindings of the same name (the exchange closures rebind ``fk``)."""
    own: List[ast.AST] = []
    nested: List[ast.AST] = []
    stack: List[ast.AST] = list(fn.body)
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            nested.append(n)
            continue
        own.append(n)
        stack.extend(ast.iter_child_nodes(n))
    return own, nested


def _local_bindings(fn: ast.AST, own: List[ast.AST]) -> Set[str]:
    bound: Set[str] = set()
    a = fn.args
    for arg in (a.posonlyargs + a.args + a.kwonlyargs):
        bound.add(arg.arg)
    if a.vararg:
        bound.add(a.vararg.arg)
    if a.kwarg:
        bound.add(a.kwarg.arg)
    for n in own:
        if isinstance(n, ast.Assign):
            for tgt in n.targets:
                for x in ast.walk(tgt):
                    if isinstance(x, ast.Name):
                        bound.add(x.id)
        elif isinstance(n, (ast.For, ast.comprehension)):
            for x in ast.walk(n.target):
                if isinstance(x, ast.Name):
                    bound.add(x.id)
    return bound


def _tainted_names(fn: ast.AST, own: List[ast.AST],
                   inherited: Set[str]) -> Set[str]:
    """Names carrying a raw (un-bucketed) row count in THIS scope, by
    fixpoint over its direct assignments.  Starts from the closure's
    taint minus locally re-bound names; an assignment whose value passes
    through a sanctioned size-class chokepoint stays clean."""
    tainted = set(inherited) - _local_bindings(fn, own)
    for _ in range(6):
        grew = False
        for n in own:
            if not isinstance(n, ast.Assign):
                continue
            if _taint_signal(n.value, tainted):
                for tgt in n.targets:
                    for x in ast.walk(tgt):
                        if isinstance(x, ast.Name) \
                                and x.id not in tainted:
                            tainted.add(x.id)
                            grew = True
        if not grew:
            break
    return tainted


def _expr_tainted(expr: ast.AST, tainted: Set[str]) -> bool:
    return _taint_signal(expr, tainted)


def check_shape_taint(sources: List[SourceFile]) -> List[Finding]:
    out: List[Finding] = []
    for sf in sources:
        in_scope = sf.path in _SHAPE_SCOPE_FILES or any(
            sf.path.startswith(p) for p in _SHAPE_SCOPE_PREFIXES)
        if not in_scope:
            continue
        top = [n for n in sf.tree.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        top.extend(m for c in sf.tree.body if isinstance(c, ast.ClassDef)
                   for m in c.body
                   if isinstance(m, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)))
        stack = [(fn, set()) for fn in top]
        while stack:
            fn, inherited = stack.pop()
            own, nested = _direct_nodes(fn)
            tainted = _tainted_names(fn, own, inherited)
            for n in own:
                if not isinstance(n, ast.Call):
                    continue
                for kw in n.keywords:
                    if kw.arg in SHAPE_KWARGS \
                            and _expr_tainted(kw.value, tainted):
                        out.append(Finding(
                            "shape-unbucketed", sf.path, n.lineno,
                            f"raw row-count-derived value reaches "
                            f"{kw.arg}= at {call_name(n) or 'a call'} — "
                            f"a fresh allocation size per literal "
                            f"row count; bucket it first"))
                if call_name(n) in _ARRAY_CTORS and n.args \
                        and _expr_tainted(n.args[0], tainted):
                    out.append(Finding(
                        "shape-unbucketed", sf.path, n.lineno,
                        f"raw row-count-derived shape at "
                        f"{call_name(n)}() — pad to a size-class "
                        f"bucket so literal row counts share the "
                        f"allocator's blocks"))
            stack.extend((nf, tainted) for nf in nested)
    return out


def check(sources: List[SourceFile]) -> List[Finding]:
    out = check_program_memo(sources)
    out.extend(check_shape_taint(sources))
    return out

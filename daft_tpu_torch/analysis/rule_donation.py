"""Rule family — kernel workspace safety (the torch counterpart of the
reference's donated-buffer rules).

The reference donates device planes to a fused program, after which they
are dead; the port has no donation, but its hand-written kernels take raw
pointers (``.data_ptr()``) to a ``torch.empty`` workspace they own: the
hash-agg build's one uint8 workspace, whose regions
``hash_kernels.workspace_views`` lays out per ``TableLayout``, and the
join build's int32 workspace, laid out by ``join_kernels.build_layout``.
torch does not know the kernel writes it. The kernel writes exactly the
layout's regions, so every other byte is uninitialized ``torch.empty``
memory, and any read not derived from the layout is a read of garbage —
the CPU plain twins, which fill whole tensors, never show it. One rule:

- ``kernel-workspace-read`` — in a function that launches a kernel
  (``cuda_build.launch``), a tensor allocated there with ``torch.empty``
  and handed to the launch by ``.data_ptr()`` is read, before the launch
  or after it, other than through the layout: a slice whose bounds come
  from the layout (``lay.offsets[...]``, names derived from a layout) or a
  call that also takes the layout (``workspace_views(ws, plan.layout,
  ...)``). Rebinding the name (``ws = ...``) ends the tracking.

Buffers a wrapper zeroes (``torch.zeros``) are defined memory and out of
scope.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from .dataflow import iter_functions
from .framework import PKG, Finding, SourceFile, call_name

#: the kernel modules the workspace discipline applies to
KERNEL_MODULES = (
    f"{PKG}/device/hash_kernels.py",
    f"{PKG}/device/join_kernels.py",
)

RULE_IDS: Dict[str, Tuple[str, str]] = {
    "kernel-workspace-read": (
        "workspace",
        "read the kernel's workspace only through its layout (the "
        "layout's offsets or workspace_views); its other bytes are "
        "uninitialized torch.empty memory"),
}


def _is_launch(call: ast.Call) -> bool:
    return call_name(call).rsplit(".", 1)[-1] == "launch"


def _layout_names(fn: ast.AST) -> Set[str]:
    """Names carrying a layout or a value derived from one: bound from a
    ``*layout(...)`` / ``_plan(...)`` call, or from an expression that
    mentions such a name or a ``.layout`` attribute (fixpoint)."""
    names: Set[str] = set()

    def mentions(expr: ast.AST) -> bool:
        for n in ast.walk(expr):
            if isinstance(n, ast.Name) and n.id in names:
                return True
            if isinstance(n, ast.Attribute) and n.attr == "layout":
                return True
            if isinstance(n, ast.Call):
                last = call_name(n).rsplit(".", 1)[-1]
                if last.endswith("layout") or last == "_plan":
                    return True
        return False

    for _ in range(6):
        grew = False
        for n in ast.walk(fn):
            value, targets = None, []
            if isinstance(n, ast.Assign):
                value, targets = n.value, n.targets
            elif isinstance(n, ast.comprehension):
                value, targets = n.iter, [n.target]
            if value is None or not mentions(value):
                continue
            for t in targets:
                for x in ast.walk(t):
                    if isinstance(x, ast.Name) and x.id not in names:
                        names.add(x.id)
                        grew = True
        if not grew:
            break
    return names


def _workspaces(fn: ast.AST) -> Dict[str, int]:
    """name → line of a ``torch.empty`` workspace handed to a launch by
    ``.data_ptr()`` in this function."""
    empties: Dict[str, int] = {}
    for n in ast.walk(fn):
        if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                and isinstance(n.targets[0], ast.Name) \
                and isinstance(n.value, ast.Call) \
                and call_name(n.value) == "torch.empty":
            empties[n.targets[0].id] = n.lineno
    ptrs = {n.func.value.id for n in ast.walk(fn)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr == "data_ptr"
            and isinstance(n.func.value, ast.Name)}
    return {k: v for k, v in empties.items() if k in ptrs}


def _sanctioned_reads(fn: ast.AST, name: str, layout: Set[str]) -> Set[int]:
    """ids of Name loads of ``name`` that are reads through the layout (or
    the ``.data_ptr()`` hand-off itself)."""
    ok: Set[int] = set()

    def from_layout(expr: ast.AST) -> bool:
        return any((isinstance(x, ast.Name) and x.id in layout)
                   or (isinstance(x, ast.Attribute) and x.attr == "layout")
                   for x in ast.walk(expr))

    for n in ast.walk(fn):
        if isinstance(n, ast.Attribute) and n.attr == "data_ptr" \
                and isinstance(n.value, ast.Name) and n.value.id == name:
            ok.add(id(n.value))
        elif isinstance(n, ast.Subscript) and isinstance(n.value, ast.Name) \
                and n.value.id == name and from_layout(n.slice):
            ok.add(id(n.value))
        elif isinstance(n, ast.Call):
            args = list(n.args) + [k.value for k in n.keywords]
            if any(from_layout(a) for a in args):
                for a in args:
                    if isinstance(a, ast.Name) and a.id == name:
                        ok.add(id(a))
    return ok


def check(sources: List[SourceFile]) -> List[Finding]:
    out: List[Finding] = []
    for sf in sources:
        if sf.path not in KERNEL_MODULES:
            continue
        for fname, fn in iter_functions(sf.tree):
            if not any(isinstance(n, ast.Call) and _is_launch(n)
                       for n in ast.walk(fn)):
                continue
            layout = _layout_names(fn)
            for ws, alloc_line in _workspaces(fn).items():
                rebinds = sorted(
                    n.lineno for n in ast.walk(fn)
                    if isinstance(n, ast.Assign) and n.lineno > alloc_line
                    and any(isinstance(t, ast.Name) and t.id == ws
                            for t in n.targets))
                end = rebinds[0] if rebinds else float("inf")
                ok = _sanctioned_reads(fn, ws, layout)
                for n in ast.walk(fn):
                    if isinstance(n, ast.Name) and n.id == ws \
                            and isinstance(n.ctx, ast.Load) \
                            and alloc_line < n.lineno < end \
                            and id(n) not in ok:
                        out.append(Finding(
                            "kernel-workspace-read", sf.path, n.lineno,
                            f"{fname}() reads the kernel workspace {ws!r} "
                            f"outside its layout — the kernel writes only "
                            f"the layout's regions of this torch.empty "
                            f"buffer"))
    return out

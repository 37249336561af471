"""Rule family — CUDA launch discipline (the port's counterpart of the
reference's ``rule_jit`` jit hygiene and ``rule_shapes`` site registry).

The port dispatches no jit program: its device work is torch eager code
plus three hand-written kernels reached through ``ctypes``. What must stay
provable is that every launch goes through one declared path, so the
launch counters ``chip_smoke.py`` reads are the whole story:

- ``dispatch-site-unregistered`` — an ``extern "C"`` entry reached
  (``<lib>.daft_<name>``) outside its declared ``ctypes`` binding, an
  undeclared entry, or a ``dispatch_scope("<site>", ...)`` naming a site
  ``analysis/dispatch_registry.py`` does not declare;
- ``dispatch-site-stale`` — a declared runtime site whose module no longer
  enters its scope (and, with ``contracts``, the registry's own two-way
  check, :func:`dispatch_registry.findings`, reported as lint findings);
- ``compile-site-unregistered`` — ``compile_library`` called, or ``nvcc``
  run, outside ``device/cuda_build.py`` and the A/B harnesses the registry
  names;
- ``launch-wrapper-bypassed`` — an engine module calling a kernel's
  ``ctypes`` binding (``*_cuda``) anywhere but from its declared wrapper,
  which holds the CPU/CUDA dispatch and is the one path an engine takes.
  ``chip_smoke.py`` and the tests call bindings directly on purpose (to
  hold a kernel against its plain version) and are out of scope.

There is no jaxpr contract to re-verify: the registry's two-way check is
its counterpart.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from . import dispatch_registry as reg
from .dataflow import iter_functions
from .framework import PKG, Finding, SourceFile, call_name, dotted_name

RULE_IDS: Dict[str, Tuple[str, str]] = {
    "dispatch-site-unregistered": (
        "launch", "declare the entry or runtime site in "
                  "analysis/dispatch_registry.py, and reach the entry only "
                  "from its declared binding"),
    "dispatch-site-stale": (
        "launch", "drop (or repoint) the registry entry — no such entry, "
                  "binding, wrapper or scope exists anymore"),
    "compile-site-unregistered": (
        "launch", "build CUDA code only through device/cuda_build."
                  "compile_library (or a declared A/B harness)"),
    "launch-wrapper-bypassed": (
        "launch", "call the kernel's wrapper (hash_agg_build / "
                  "hash_join_build / hash_join_probe), not its ctypes "
                  "binding"),
}

_ANALYSIS = f"{PKG}/analysis/"
_PATH_RE = re.compile(r"(daft_tpu_torch/[\w/]+\.(?:py|cu))")


def _owners(tree: ast.Module) -> Dict[int, str]:
    """id(node) → name of the innermost function holding it."""
    out: Dict[int, str] = {}
    for _name, fn in iter_functions(tree):
        for sub in ast.walk(fn):
            out[id(sub)] = fn.name   # inner defs overwrite: walked later
    return out


def _scope_site(call: ast.Call) -> Optional[str]:
    if call_name(call).rsplit(".", 1)[-1] != "dispatch_scope":
        return None
    if call.args and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, str):
        return call.args[0].value
    return None


def check(sources: List[SourceFile]) -> List[Finding]:
    out: List[Finding] = []
    bindings = {e.binding[1]: e for e in reg.ENTRIES
                if e.kind == "kernel"}
    scoped: Dict[str, Set[str]] = {}
    scanned: Set[str] = set()
    for sf in sources:
        if not sf.path.startswith(PKG + "/") or sf.path.startswith(_ANALYSIS):
            continue
        scanned.add(sf.path)
        harness = sf.path in reg.COMPILE_CALLERS
        owner = _owners(sf.tree)
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Attribute) \
                    and node.attr.startswith("daft_") and not harness:
                e = reg.BY_ENTRY.get(node.attr)
                fn = owner.get(id(node))
                if e is None:
                    out.append(Finding(
                        "dispatch-site-unregistered", sf.path, node.lineno,
                        f"reaches undeclared CUDA entry {node.attr}"))
                elif (sf.path, fn) != e.binding:
                    out.append(Finding(
                        "dispatch-site-unregistered", sf.path, node.lineno,
                        f"reaches {node.attr} in {fn}() — its declared "
                        f"binding is {e.binding[0]}:{e.binding[1]}"))
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            last = name.rsplit(".", 1)[-1]
            site = _scope_site(node)
            if site is not None:
                scoped.setdefault(site, set()).add(sf.path)
                s = reg.site(site)
                if s is None:
                    out.append(Finding(
                        "dispatch-site-unregistered", sf.path, node.lineno,
                        f"dispatch_scope({site!r}) names a site "
                        f"analysis/dispatch_registry.py does not declare"))
                elif s.module != sf.path:
                    out.append(Finding(
                        "dispatch-site-unregistered", sf.path, node.lineno,
                        f"dispatch_scope({site!r}) entered outside its "
                        f"declared module {s.module}"))
            if last == "compile_library" \
                    and sf.path not in reg.COMPILE_CALLERS:
                out.append(Finding(
                    "compile-site-unregistered", sf.path, node.lineno,
                    f"{name}() outside {reg.COMPILE_SITE[0]}"))
            if name.split(".")[0] == "subprocess" \
                    and sf.path not in reg.COMPILE_CALLERS \
                    and _runs_nvcc(node):
                out.append(Finding(
                    "compile-site-unregistered", sf.path, node.lineno,
                    f"{name}() runs nvcc outside {reg.COMPILE_SITE[0]}"))
            e = bindings.get(last)
            if e is not None and not harness:
                fn = owner.get(id(node))
                if (sf.path, fn) != e.wrapper:
                    out.append(Finding(
                        "launch-wrapper-bypassed", sf.path, node.lineno,
                        f"{fn}() calls the ctypes binding {last}() of "
                        f"{e.entry}; the engine's one path is its wrapper "
                        f"{e.wrapper[0]}:{e.wrapper[1]}"))
    for s in reg.SITES:
        if s.module in scanned and s.module not in scoped.get(s.id, ()):
            out.append(Finding(
                "dispatch-site-stale", s.module, 1,
                f"registry site {s.id!r} is declared here but no "
                f"dispatch_scope({s.id!r}, ...) is entered"))
    return out


def _runs_nvcc(call: ast.Call) -> bool:
    for a in call.args[:1]:
        if isinstance(a, (ast.List, ast.Tuple)) and a.elts:
            first = a.elts[0]
            if isinstance(first, ast.Constant) and first.value == "nvcc":
                return True
            if isinstance(first, ast.Call) \
                    and dotted_name(first.func).endswith("nvcc"):
                return True
            if isinstance(first, ast.Starred):
                continue
    return False


def check_registry(root: str) -> List[Finding]:
    """The registry's own two-way check against the tree at ``root``
    (``dispatch_registry.findings``), as lint findings."""
    out = []
    for rule, detail in reg.findings(root):
        m = _PATH_RE.search(detail)
        path = m.group(1) if m else f"{PKG}/analysis/dispatch_registry.py"
        out.append(Finding(rule, path, 1, detail))
    return out

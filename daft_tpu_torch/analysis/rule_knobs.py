"""Rule family — knob registry discipline, over the port.

The port's copy of ``daft_tpu/analysis/rule_knobs.py``. Invariant: every
``DAFT_TORCH_*`` environment knob is declared once in
``daft_tpu_torch/knobs.py`` and parsed once (the typed accessors there).
The rule flags:

- ``knob-unregistered`` — an env read (or accessor call) naming a
  ``DAFT_TORCH_*`` knob the registry does not know;
- ``knob-direct-read`` — a registered knob read through raw
  ``os.environ`` / ``os.getenv`` instead of an accessor (a second parse
  site);
- ``knob-type-mismatch`` — an accessor whose type is not the registered
  one (``env_opt_int`` parses an int, ``env_raw`` reads any type);
- ``knob-unused`` — a registered knob that appears nowhere in the scanned
  tree;
- ``knob-config-drift`` — a registry ``config_field`` that is not an
  ``ExecutionConfig`` field of ``daft_tpu_torch/context.py``, or that does
  not spell the knob's name (``DAFT_TORCH_<FIELD>``);
- ``knob-doc-drift`` — the README's generated port knob tables stale
  against the registry (``knobs.readme_drift``).

Writes (``os.environ[...] = v``, the harnesses setting a knob for a run)
are not reads and are not flagged.
"""

from __future__ import annotations

import ast
import os
import re
from typing import List

from .. import knobs
from .framework import PKG, Finding, SourceFile, call_name, dotted_name

REGISTRY_MODULE = f"{PKG}/knobs.py"
_PREFIX = "DAFT_TORCH_"
_PRESENCE_ACCESSORS = ("env_raw",)
_KNOB_NAME_RE = re.compile(r"DAFT_TORCH_[A-Z0-9_]+")


def _literal_knob(node: ast.AST):
    if isinstance(node, ast.Constant) and isinstance(node.value, str) \
            and node.value.startswith(_PREFIX):
        return node.value
    return None


def check(sources: List[SourceFile]) -> List[Finding]:
    out: List[Finding] = []
    seen_anywhere = set()

    for sf in sources:
        if sf.path != REGISTRY_MODULE:
            # full-token extraction: DAFT_TORCH_DEVICE must not be "seen"
            # inside DAFT_TORCH_DEVICE_FORCE
            seen_anywhere.update(
                m for m in _KNOB_NAME_RE.findall(sf.text)
                if m in knobs.REGISTRY)
        if not sf.path.startswith(PKG + "/") or sf.path == REGISTRY_MODULE:
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call):
                name = call_name(node)
                if name.endswith("environ.get") or name.endswith("getenv"):
                    knob = _literal_knob(node.args[0]) if node.args else None
                    if knob is None:
                        continue
                    if knob not in knobs.REGISTRY:
                        out.append(Finding(
                            "knob-unregistered", sf.path, node.lineno,
                            f"env read of unregistered knob {knob} — declare "
                            f"it in {REGISTRY_MODULE}"))
                    else:
                        out.append(Finding(
                            "knob-direct-read", sf.path, node.lineno,
                            f"{knob} read through os.environ — use the "
                            f"registry accessor (knobs.env_*) so the knob "
                            f"has one parse site"))
                else:
                    short = name.rsplit(".", 1)[-1]
                    if short in knobs.ACCESSOR_TYPES or short in \
                            _PRESENCE_ACCESSORS:
                        knob = _literal_knob(node.args[0]) \
                            if node.args else None
                        if knob is None:
                            continue
                        reg = knobs.REGISTRY.get(knob)
                        if reg is None:
                            out.append(Finding(
                                "knob-unregistered", sf.path, node.lineno,
                                f"accessor read of unregistered knob {knob}"))
                        elif short in knobs.ACCESSOR_TYPES \
                                and reg.type != knobs.ACCESSOR_TYPES[short]:
                            out.append(Finding(
                                "knob-type-mismatch", sf.path, node.lineno,
                                f"{knob} is registered as {reg.type!r} but "
                                f"read via {short}()"))
            elif isinstance(node, ast.Subscript) \
                    and isinstance(node.ctx, ast.Load) \
                    and dotted_name(node.value).endswith("environ"):
                knob = _literal_knob(node.slice)
                if knob is None:
                    continue
                if knob not in knobs.REGISTRY:
                    out.append(Finding(
                        "knob-unregistered", sf.path, node.lineno,
                        f"env read of unregistered knob {knob}"))
                else:
                    out.append(Finding(
                        "knob-direct-read", sf.path, node.lineno,
                        f"{knob} read through os.environ[...] — use the "
                        f"registry accessor"))

    for name, k in knobs.REGISTRY.items():
        if name not in seen_anywhere:
            out.append(Finding(
                "knob-unused", REGISTRY_MODULE, 1,
                f"{name} is registered (owner {k.module}) but appears "
                f"nowhere in the scanned tree — stale registry entry?"))

    out.extend(_config_drift(sources))
    return out


def _config_drift(sources: List[SourceFile]) -> List[Finding]:
    """Registry ``config_field`` → ``ExecutionConfig`` field cross-check."""
    ctx = next((sf for sf in sources
                if sf.path == f"{PKG}/context.py"), None)
    if ctx is None:
        return []
    fields = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ClassDef) and node.name == "ExecutionConfig":
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) \
                        and isinstance(stmt.target, ast.Name):
                    fields.add(stmt.target.id)
    out = []
    for name, k in knobs.REGISTRY.items():
        if not k.config_field:
            continue
        if k.config_field not in fields:
            out.append(Finding(
                "knob-config-drift", REGISTRY_MODULE, 1,
                f"{name} claims ExecutionConfig.{k.config_field} but that "
                f"field does not exist"))
        if f"{_PREFIX}{k.config_field.upper()}" != name:
            out.append(Finding(
                "knob-config-drift", REGISTRY_MODULE, 1,
                f"{name}: config_field {k.config_field!r} does not spell "
                f"the knob's name ({_PREFIX}<FIELD>)"))
    return out


def check_readme(root: str) -> List[Finding]:
    path = os.path.join(root, "README.md")
    try:
        with open(path, encoding="utf-8") as f:
            text = f.read()
    except OSError:
        return [Finding("knob-doc-drift", "README.md", 1,
                        "README.md is missing")]
    return [Finding("knob-doc-drift", "README.md", 1, p)
            for p in knobs.readme_drift(text)]

"""The port's registry of hand-written CUDA entry points.

Reference: ``daft_tpu/analysis/dispatch_registry.py``, which declares every
``jax.jit`` and ``pallas_call`` construction site once. The port declares
every ``extern "C"`` entry of ``csrc/*.cu`` once: its source, its
``ctypes`` binding site (the one function that calls it), the wrapper an
engine path calls, the wrapper's plain torch twin, the launch counter the
wrapper bumps, and the TPU kernel it replaces (its row in ``PERF.md``
§6's kernel table). The one compile site is
``device/cuda_build.py:compile_library``; the A/B harnesses under
``benchmarking/`` may call it for their baseline builds (exempt, as the
reference exempts its bench sites).

:func:`findings` holds the table honest in both directions:

- ``dispatch-site-unregistered``: an entry in the sources, in
  ``cuda_build._ENTRIES`` or called from ``device/`` that is not declared;
- ``dispatch-site-stale``: a declared entry, binding, wrapper, plain twin
  or launch counter that no longer exists;
- ``compile-site-unregistered``: ``nvcc`` run, or ``compile_library``
  called, anywhere but the declared sites.

This module must stay import-light (no torch): a test and
``chip_smoke.py`` read it before any kernel is built.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List, Optional, Tuple

PKG = "daft_tpu_torch"


@dataclasses.dataclass(frozen=True)
class EntryPoint:
    id: str          # stable site id
    entry: str       # the ``extern "C"`` name
    source: str      # repo-relative ``.cu`` file holding it
    binding: Tuple[str, str]  # (module, function) that calls the entry
    wrapper: Optional[Tuple[str, str]]  # the dispatch an engine path calls
    plain: Optional[Tuple[str, str]]    # its plain torch twin (CPU tensors)
    #: the module attribute counting launches, and the key of a dict one
    launches: Optional[Tuple[str, str, Optional[str]]]
    #: the TPU kernel it replaces (``PERF.md`` §6), or None for a query
    replaces: Optional[str]
    kind: str = "kernel"  # "kernel" or "query" (no launch, no twin)


_HK = f"{PKG}/device/hash_kernels.py"
_JK = f"{PKG}/device/join_kernels.py"
_PALLAS = "daft_tpu/device/pallas_kernels.py"

ENTRIES: Tuple[EntryPoint, ...] = (
    EntryPoint("hash_agg.build", "daft_hash_agg_build",
               f"{PKG}/csrc/hash_agg.cu",
               (_HK, "hash_agg_build_cuda"), (_HK, "hash_agg_build"),
               (_HK, "hash_agg_build_plain"), (_HK, "launches", None),
               f"{_PALLAS}:_agg_build_call (:192)"),
    EntryPoint("hash_join.build", "daft_hash_join_build",
               f"{PKG}/csrc/hash_join.cu",
               (_JK, "hash_join_build_cuda"), (_JK, "hash_join_build"),
               (_JK, "hash_join_build_plain"),
               (_JK, "launches", "hash_join_build"),
               f"{_PALLAS}:_join_build_call (:455)"),
    EntryPoint("hash_join.probe", "daft_hash_join_probe",
               f"{PKG}/csrc/hash_join.cu",
               (_JK, "hash_join_probe_cuda"), (_JK, "hash_join_probe"),
               (_JK, "hash_join_probe_plain"),
               (_JK, "launches", "hash_join_probe"),
               f"{_PALLAS}:_join_probe_call (:533)"),
    # the card's SM count and shared-memory sizes, which size the
    # hash-agg build's grid and table placement: a query, not a kernel
    EntryPoint("device.info", "daft_device_info",
               f"{PKG}/csrc/hash_agg.cu", (_HK, "device_info"), None, None,
               None, None, kind="query"),
)

BY_ENTRY: Dict[str, EntryPoint] = {e.entry: e for e in ENTRIES}

#: the one compile site, and the harnesses allowed to call it
COMPILE_SITE = (f"{PKG}/device/cuda_build.py", "compile_library")
COMPILE_CALLERS = (f"{PKG}/device/cuda_build.py",
                   f"{PKG}/benchmarking/hash_agg_ab.py",
                   f"{PKG}/benchmarking/hash_join_ab.py")

_EXTERN = re.compile(r'extern\s+"C"\s+\w[\w\s\*]*?\b(\w+)\s*\(')
_CALLED = re.compile(r"\.(daft_\w+)\b")


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _read(root: str, rel: str) -> Optional[str]:
    path = os.path.join(root, rel)
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        return f.read()


def source_entries(root: str) -> Dict[str, str]:
    """``extern "C"`` name → repo-relative ``.cu`` file, from the
    sources."""
    csrc = os.path.join(root, PKG, "csrc")
    out = {}
    for name in sorted(os.listdir(csrc)):
        if name.endswith(".cu"):
            rel = f"{PKG}/csrc/{name}"
            for m in _EXTERN.finditer(_read(root, rel)):
                out[m.group(1)] = rel
    return out


def _function_body(text: str, func: str) -> Optional[str]:
    """The text of top-level ``def func`` up to the next top-level
    statement, or None."""
    m = re.search(rf"^def {func}\(.*?(?=^\S)", text + "\n_", re.S | re.M)
    return m.group(0) if m else None


def _has_name(text: str, name: str) -> bool:
    return re.search(rf"^(def {name}\(|{name}\s*=)", text, re.M) is not None


def findings(root: Optional[str] = None,
             entries: Tuple[EntryPoint, ...] = ENTRIES) -> List[Tuple[str, str]]:
    """``[(rule, detail)]`` of every disagreement between the declared
    ``entries`` and the tree at ``root`` (empty when the table is
    honest)."""
    root = root or repo_root()
    out: List[Tuple[str, str]] = []
    declared = {e.entry: e for e in entries}
    in_src = source_entries(root)
    for name, rel in sorted(in_src.items()):
        if name not in declared:
            out.append(("dispatch-site-unregistered",
                        f"{rel}: extern \"C\" {name} is not declared"))
    cb = _read(root, COMPILE_SITE[0]) or ""
    m = re.search(r"_ENTRIES\s*=\s*\{(.*?)\n\}", cb, re.S)
    bound = set(re.findall(r'"(daft_\w+)"', m.group(1))) if m else set()
    for name in sorted(bound - set(declared)):
        out.append(("dispatch-site-unregistered",
                    f"{COMPILE_SITE[0]}: _ENTRIES binds undeclared {name}"))
    device_dir = os.path.join(root, PKG, "device")
    for fname in sorted(os.listdir(device_dir)):
        if not fname.endswith(".py"):
            continue
        rel = f"{PKG}/device/{fname}"
        for name in sorted(set(_CALLED.findall(_read(root, rel)))):
            e = declared.get(name)
            if e is None:
                out.append(("dispatch-site-unregistered",
                            f"{rel}: calls undeclared entry {name}"))
            elif e.binding[0] != rel:
                out.append(("dispatch-site-unregistered",
                            f"{rel}: calls {name} outside its declared "
                            f"binding {e.binding[0]}:{e.binding[1]}"))
    for e in entries:
        if in_src.get(e.entry) != e.source:
            out.append(("dispatch-site-stale",
                        f"{e.id}: {e.entry} is not an extern \"C\" entry "
                        f"of {e.source}"))
        if e.entry not in bound:
            out.append(("dispatch-site-stale",
                        f"{e.id}: {e.entry} is not in cuda_build._ENTRIES"))
        mod = _read(root, e.binding[0]) or ""
        body = _function_body(mod, e.binding[1])
        if body is None or f".{e.entry}" not in body:
            out.append(("dispatch-site-stale",
                        f"{e.id}: {e.binding[0]}:{e.binding[1]} does not "
                        f"call {e.entry}"))
        for what in ("wrapper", "plain"):
            site = getattr(e, what)
            if site is not None and _function_body(
                    _read(root, site[0]) or "", site[1]) is None:
                out.append(("dispatch-site-stale",
                            f"{e.id}: {what} {site[0]}:{site[1]} is gone"))
        if e.launches is not None:
            mod = _read(root, e.launches[0]) or ""
            key = e.launches[2]
            if not _has_name(mod, e.launches[1]) or (
                    key is not None and f'"{key}"' not in mod):
                out.append(("dispatch-site-stale",
                            f"{e.id}: launch counter {e.launches} is gone"))
        if e.kind == "kernel" and (e.wrapper is None or e.plain is None
                                   or e.launches is None
                                   or e.replaces is None):
            out.append(("dispatch-site-stale",
                        f"{e.id}: a kernel needs a wrapper, a plain twin, "
                        f"a launch counter and its TPU source"))
    if _function_body(cb, COMPILE_SITE[1]) is None:
        out.append(("dispatch-site-stale",
                    f"compile site {COMPILE_SITE[0]}:{COMPILE_SITE[1]} is "
                    f"gone"))
    for dirpath, _, files in os.walk(os.path.join(root, PKG)):
        for fname in sorted(files):
            if not fname.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, fname),
                                  root).replace(os.sep, "/")
            if rel in COMPILE_CALLERS or rel.endswith(
                    "/analysis/dispatch_registry.py"):
                continue
            text = _read(root, rel)
            if "compile_library(" in text or (
                    "subprocess" in text and re.search(
                        r"\[\s*nvcc\(\)|\"nvcc\"\s*[,\]]", text)):
                out.append(("compile-site-unregistered",
                            f"{rel}: builds CUDA code outside "
                            f"{COMPILE_SITE[0]}:{COMPILE_SITE[1]}"))
    return out


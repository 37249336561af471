"""daft-lint core for the port: findings, pragmas, source walking, baseline.

The port's own copy of ``daft_tpu/analysis/framework.py``, pointed at the
port's tree. Each rule family encodes an invariant of ``daft_tpu_torch``
(knob registry discipline, chaos-replay determinism, lock discipline,
paired resources, cancellation and attribution, the CUDA launch registry,
shape buckets, kernel workspace safety, plan contracts); rules run on
parsed ASTs and return
:class:`Finding`\\ s.

Suppression is explicit and justified::

    something_flagged()  # daft-lint: allow(<rule-id>) -- why it is safe

The pragma may sit on the finding's line or in the comment block directly
above it. An ``allow(...)`` without a ``-- reason`` is itself a finding
(``pragma-missing-reason``), and so is one naming a rule this linter does
not have (``pragma-unknown-rule``).

The committed baseline (``analysis/baseline.json``) is **empty** and stays
empty: fix the finding or justify a pragma.

The default scan is the port's own tree — ``daft_tpu_torch/``, the
``tests/test_torch_*.py`` files and ``chip_smoke.py`` — and never
``daft_tpu/``, which the reference's own linter covers.
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Tuple

PKG = "daft_tpu_torch"

#: the canonical scan set: the port, its tests and its chip script
DEFAULT_SUBDIRS = (PKG, "tests/test_torch_*.py", "chip_smoke.py")

#: chaos-replay-critical modules: any nondeterminism here can break the
#: bit-identical replay contract of the resilience plane
#: (``distributed/resilience.py``)
REPLAY_CRITICAL = (
    f"{PKG}/distributed/resilience.py",
    f"{PKG}/distributed/shuffle_service.py",
    f"{PKG}/distributed/worker.py",
    f"{PKG}/distributed/remote_worker.py",
    f"{PKG}/distributed/scheduler.py",
    f"{PKG}/io/read_planner.py",
    f"{PKG}/execution/executor.py",
)


@dataclasses.dataclass
class Finding:
    rule: str
    path: str      # repo-relative, forward slashes
    line: int
    message: str
    family: str = ""   # rule family (filled from the registry)
    hint: str = ""     # one-line fix hint (filled from the registry)

    def key(self) -> str:
        return f"{self.path}:{self.rule}:{self.line}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def known_rules() -> Dict[str, Tuple[str, str]]:
    """rule id → (family, one-line fix hint) for every rule the linter can
    emit: the registry behind pragma validation, ``--rule`` filtering and
    the JSON ``family``/``hint`` fields."""
    from . import (rule_attribution, rule_cancellation, rule_donation,
                   rule_launch, rule_plans, rule_resources, rule_shapes)
    out: Dict[str, Tuple[str, str]] = {
        "knob-unregistered": (
            "knobs", "declare the knob in daft_tpu_torch/knobs.py"),
        "knob-direct-read": (
            "knobs", "read via knobs.env_* accessors, not os.environ"),
        "knob-type-mismatch": (
            "knobs", "use the accessor matching the registered type"),
        "knob-unused": (
            "knobs", "drop the stale registry entry or use the knob"),
        "knob-config-drift": (
            "knobs", "sync the registry's config_field with "
                     "ExecutionConfig"),
        "knob-doc-drift": (
            "knobs", "regenerate: python -m daft_tpu_torch.analysis "
                     "--knob-docs --write"),
        "unseeded-random": (
            "determinism", "use a seeded instance keyed on a stable "
                           "identity"),
        "wallclock-decision": (
            "determinism", "inject a clock (RetryPolicy pattern) instead "
                           "of reading time in a decision"),
        "unordered-pool-iteration": (
            "determinism", "iterate futures in submit order, not "
                           "completion order"),
        "blocking-under-lock": (
            "locks", "move the blocking call outside the `with <lock>:` "
                     "scope"),
        "unguarded-global-mutation": (
            "locks", "rebind module state under its lock "
                     "(check-then-set races)"),
        "pragma-missing-reason": (
            "pragma", "append `-- <reason>` to the allow(...) pragma"),
        "pragma-unknown-rule": (
            "pragma", "name a live rule id (see --stats for the list) "
                      "or drop the stale pragma"),
    }
    out.update(rule_resources.RULE_IDS)
    out.update(rule_donation.RULE_IDS)
    out.update(rule_cancellation.RULE_IDS)
    out.update(rule_attribution.RULE_IDS)
    out.update(rule_launch.RULE_IDS)
    out.update(rule_shapes.RULE_IDS)
    out.update(rule_plans.RULE_IDS)
    return out


_PRAGMA_RE = re.compile(
    r"#\s*daft-lint:\s*allow\(([\w\-,\s]+)\)(?:\s*--\s*(.*\S))?")


@dataclasses.dataclass
class SourceFile:
    """One parsed source file plus its pragma index."""
    path: str                # repo-relative
    abspath: str
    text: str
    tree: ast.Module
    lines: List[str]

    @property
    def pragmas(self) -> Dict[int, Tuple[List[str], Optional[str]]]:
        cached = getattr(self, "_pragmas", None)
        if cached is None:
            cached = {}
            for i, line in enumerate(self.lines, start=1):
                m = _PRAGMA_RE.search(line)
                if m:
                    rules = [r.strip() for r in m.group(1).split(",")
                             if r.strip()]
                    cached[i] = (rules, m.group(2))
            self._pragmas = cached
        return cached

    def allowed(self, rule: str, line: int) -> bool:
        """True when the line itself — or the contiguous comment block
        directly above it — carries a pragma for ``rule`` with a
        justification."""
        entry = self.pragmas.get(line)
        if entry and rule in entry[0] and entry[1]:
            return True
        ln = line - 1
        while 1 <= ln <= len(self.lines) \
                and self.lines[ln - 1].lstrip().startswith("#"):
            entry = self.pragmas.get(ln)
            if entry and rule in entry[0] and entry[1]:
                return True
            ln -= 1
        return False

    def pragma_findings(self) -> List[Finding]:
        """Reason-less pragmas are findings themselves."""
        out = []
        for ln, (rules, reason) in self.pragmas.items():
            if not reason:
                out.append(Finding(
                    "pragma-missing-reason", self.path, ln,
                    f"daft-lint pragma for {', '.join(rules)} has no "
                    f"`-- <reason>` justification"))
        return out


def load_source(abspath: str, root: str) -> Optional[SourceFile]:
    try:
        with open(abspath, encoding="utf-8") as f:
            text = f.read()
        tree = ast.parse(text, filename=abspath)
    except (OSError, SyntaxError):
        return None
    rel = os.path.relpath(abspath, root).replace(os.sep, "/")
    return SourceFile(rel, abspath, text, tree, text.splitlines())


def walk_sources(root: str,
                 subdirs: Iterable[str] = DEFAULT_SUBDIRS) -> List[SourceFile]:
    """Parse every ``*.py`` under ``root/<subdir>`` (skipping caches and
    the build directory); a subdir holding ``*`` is a glob over files of
    its directory."""
    out = []
    for sub in subdirs:
        if "*" in sub:
            d, pat = os.path.split(sub)
            base = os.path.join(root, d)
            names = sorted(os.listdir(base)) if os.path.isdir(base) else []
            for fn in names:
                if fn.endswith(".py") and fnmatch.fnmatch(fn, pat):
                    sf = load_source(os.path.join(base, fn), root)
                    if sf:
                        out.append(sf)
            continue
        base = os.path.join(root, sub)
        if os.path.isfile(base):
            sf = load_source(base, root)
            if sf:
                out.append(sf)
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in ("__pycache__", "_build"))
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    sf = load_source(os.path.join(dirpath, fn), root)
                    if sf:
                        out.append(sf)
    return out


def repo_root() -> str:
    """The repo root holding this daft_tpu_torch checkout."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(here))


BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "baseline.json")


def load_baseline(path: Optional[str] = None) -> List[str]:
    path = path or BASELINE_PATH
    try:
        with open(path) as f:
            data = json.load(f)
        return list(data.get("findings", []))
    except (OSError, ValueError):
        return []


def apply_baseline(findings: List[Finding],
                   baseline: Iterable[str]) -> List[Finding]:
    grandfathered = set(baseline)
    return [f for f in findings if f.key() not in grandfathered]


def pragma_rule_findings(sources: List[SourceFile],
                         rules: Dict[str, Tuple[str, str]]
                         ) -> List[Finding]:
    """A pragma naming a rule this linter does not have is a finding: a
    stale suppression stops suppressing the day its rule is renamed."""
    out: List[Finding] = []
    for sf in sources:
        for ln, (names, _reason) in sf.pragmas.items():
            for name in names:
                if name not in rules:
                    out.append(Finding(
                        "pragma-unknown-rule", sf.path, ln,
                        f"pragma allows {name!r}, which is not a rule "
                        f"this linter has — stale suppression"))
    return out


def run_analysis(root: Optional[str] = None,
                 subdirs: Iterable[str] = DEFAULT_SUBDIRS,
                 contracts: bool = True,
                 readme: bool = True,
                 baseline: Optional[List[str]] = None,
                 stats: Optional[Dict] = None) -> List[Finding]:
    """Run every rule family over the tree; returns the findings no pragma
    and no baseline entry covers, sorted by location. ``contracts`` adds
    the CUDA entry-point registry's two-way check
    (``dispatch_registry.findings``) and the fusion-region schema check
    (which plans with the engine, so it imports torch). Pass a dict as
    ``stats`` for the burn-down summary."""
    from . import (rule_attribution, rule_cancellation, rule_determinism,
                   rule_donation, rule_knobs, rule_launch, rule_locks,
                   rule_plans, rule_resources, rule_shapes)

    root = root or repo_root()
    sources = walk_sources(root, subdirs)
    rules = known_rules()
    findings: List[Finding] = []
    for sf in sources:
        findings.extend(sf.pragma_findings())
    findings.extend(pragma_rule_findings(sources, rules))

    findings.extend(rule_knobs.check(sources))
    if readme:
        findings.extend(rule_knobs.check_readme(root))
    findings.extend(rule_determinism.check(sources))
    findings.extend(rule_locks.check(sources))
    findings.extend(rule_launch.check(sources))
    if contracts:
        findings.extend(rule_launch.check_registry(root))
    findings.extend(rule_resources.check(sources))
    findings.extend(rule_donation.check(sources))
    findings.extend(rule_cancellation.check(sources))
    findings.extend(rule_attribution.check(sources))
    findings.extend(rule_shapes.check(sources))
    findings.extend(rule_plans.check(sources))
    if contracts:
        findings.extend(rule_plans.check_fusion_contracts())

    # pragma suppression (a pragma never suppresses the pragma rules)
    by_path = {sf.path: sf for sf in sources}
    kept = []
    for f in findings:
        sf = by_path.get(f.path)
        if (not f.rule.startswith("pragma-") and sf is not None
                and sf.allowed(f.rule, f.line)):
            continue
        kept.append(f)

    kept = apply_baseline(kept, load_baseline() if baseline is None
                          else baseline)
    for f in kept:
        fam, hint = rules.get(f.rule, ("", ""))
        f.family = f.family or fam
        f.hint = f.hint or hint
    kept.sort(key=lambda f: (f.path, f.line, f.rule))

    if stats is not None:
        from . import dataflow
        by_family: Dict[str, int] = {}
        for f in kept:
            by_family[f.family or "?"] = by_family.get(
                f.family or "?", 0) + 1
        stats.update({
            "files_scanned": len(sources),
            "functions_analyzed": sum(
                len(list(dataflow.iter_functions(sf.tree)))
                for sf in sources),
            "rules": sorted(rules),
            "findings_by_family": by_family,
        })
    return kept


# ------------------------------------------------------------- ast utils

def dotted_name(node: ast.AST) -> str:
    """``a.b.c`` for Name/Attribute chains, else ''."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def call_name(node: ast.Call) -> str:
    return dotted_name(node.func)

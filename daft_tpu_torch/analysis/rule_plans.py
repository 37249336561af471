"""Rule family — plan contracts, over the port.

The port's copy of ``daft_tpu/analysis/rule_plans.py``: the port's
planner contracts, proven both ways against
``analysis/plan_contracts.py``:

- ``plan-node-unregistered`` / ``plan-node-stale`` — every
  ``LogicalPlan`` / ``PhysicalPlan`` subclass is declared once with its
  schema/partitioning/ordering derivations, and every entry names a real
  class;
- ``plan-field-undeclared`` / ``plan-field-stale`` — the declared field
  inventory (semantic + estimate fields) matches the constructor's
  ``self.X = …`` assignments exactly;
- ``plan-schema-convention`` — a physical node's declared schema class
  ("child" vs "computed") matches what its constructor passes to
  ``super().__init__``;
- ``plan-rule-unregistered`` / ``plan-rule-stale`` — every optimizer
  ``Rule`` subclass is registered as schema-preserving or not (the
  runtime sanitizer enforces the claim per application);
- ``plan-foreign-field`` — ``physical/adaptive.py`` may mutate only the
  registered estimate/strategy fields of a built plan, and never through
  ``setattr``;
- ``plan-fusion-fallback-schema`` — a functional check: exemplar plans of
  each region grammar are fused on CPU tensors and every region's schema
  must equal its fallback subtree's, field for field.

The runtime twin of this family is ``analysis/plan_sanitizer.py``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from . import plan_contracts
from .framework import PKG, Finding, SourceFile, call_name

RULE_IDS: Dict[str, Tuple[str, str]] = {
    "plan-node-unregistered": (
        "plans", "declare a NodeContract for the plan node in "
                 "analysis/plan_contracts.py (schema, partitioning, "
                 "ordering, fields)"),
    "plan-node-stale": (
        "plans", "drop (or repoint) the registry entry — no such plan "
                 "node class exists anymore"),
    "plan-field-undeclared": (
        "plans", "add the constructor field to the node's NodeContract "
                 "(semantic_fields or estimate_fields)"),
    "plan-field-stale": (
        "plans", "the NodeContract declares a field the constructor no "
                 "longer assigns — drop or repoint it"),
    "plan-schema-convention": (
        "plans", "make the constructor's super().__init__ schema "
                 "argument match the contract's declared derivation "
                 "(child.schema() vs explicit schema)"),
    "plan-rule-unregistered": (
        "plans", "register the optimizer Rule subclass in "
                 "plan_contracts.RULE_CONTRACTS as schema-preserving or "
                 "schema-rewriting"),
    "plan-rule-stale": (
        "plans", "drop the RULE_CONTRACTS entry — no such Rule subclass "
                 "exists anymore"),
    "plan-foreign-field": (
        "plans", "replan/adaptive may mutate only the fields in "
                 "plan_contracts.REPLAN_MUTABLE; register the field "
                 "with a reason or stop mutating it"),
    "plan-fusion-fallback-schema": (
        "plans", "keep the FusedRegion's schema identical to its "
                 "fallback subtree's schema — fusion must never change "
                 "semantics"),
}

_LOGICAL_PATH = f"{PKG}/logical/plan.py"
_PHYSICAL_PATH = f"{PKG}/physical/plan.py"
_OPTIMIZER_PATH = f"{PKG}/logical/optimizer.py"
_FUSION_PATH = f"{PKG}/physical/fusion.py"
#: the re-planning modules; the distributed re-planner comes with A7
_REPLAN_PATHS = (f"{PKG}/physical/adaptive.py",)

#: non-node helper classes living in the plan modules
_NON_NODE_CLASSES = {"ClusteringSpec", "LogicalPlan", "PhysicalPlan"}


# ------------------------------------------------------- class inventory

def _init_fields(cls: ast.ClassDef) -> List[Tuple[str, int]]:
    """Public ``self.X = …`` (and annotated / tuple-unpacked) targets in
    ``__init__``, with line numbers. Underscore-prefixed attributes are
    internal caches owned by the class and stay out of the contract."""
    out: List[Tuple[str, int]] = []
    for item in cls.body:
        if not (isinstance(item, ast.FunctionDef)
                and item.name == "__init__"):
            continue
        for stmt in ast.walk(item):
            targets: List[ast.AST] = []
            if isinstance(stmt, ast.Assign):
                targets = list(stmt.targets)
            elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
                targets = [stmt.target]
            for t in targets:
                elts = t.elts if isinstance(t, ast.Tuple) else [t]
                for e in elts:
                    if isinstance(e, ast.Attribute) \
                            and isinstance(e.value, ast.Name) \
                            and e.value.id == "self" \
                            and not e.attr.startswith("_"):
                        out.append((e.attr, stmt.lineno))
    return out


def _super_schema_arg(cls: ast.ClassDef):
    """The schema argument of the ``super().__init__(children, schema)``
    call in a physical node's constructor (or None)."""
    for item in cls.body:
        if not (isinstance(item, ast.FunctionDef)
                and item.name == "__init__"):
            continue
        for stmt in ast.walk(item):
            if isinstance(stmt, ast.Call) \
                    and call_name(stmt).endswith("__init__") \
                    and isinstance(stmt.func, ast.Attribute) \
                    and isinstance(stmt.func.value, ast.Call) \
                    and call_name(stmt.func.value) == "super" \
                    and len(stmt.args) >= 2:
                return stmt.args[1]
    return None


def _is_child_schema_call(expr: ast.AST) -> bool:
    """``<child>.schema()`` — the "inherit from first child" convention."""
    return (isinstance(expr, ast.Call)
            and isinstance(expr.func, ast.Attribute)
            and expr.func.attr == "schema")


def _node_classes(sf: SourceFile, base: str) -> List[ast.ClassDef]:
    out = []
    for node in sf.tree.body:
        if isinstance(node, ast.ClassDef) \
                and node.name not in _NON_NODE_CLASSES \
                and any(isinstance(b, ast.Name) and b.id == base
                        for b in node.bases):
            out.append(node)
    return out


def _check_layer(sf: SourceFile, base: str,
                 registry: Dict[str, "plan_contracts.NodeContract"],
                 check_schema_convention: bool) -> List[Finding]:
    out: List[Finding] = []
    seen: Set[str] = set()
    for cls in _node_classes(sf, base):
        seen.add(cls.name)
        contract = registry.get(cls.name)
        if contract is None:
            out.append(Finding(
                "plan-node-unregistered", sf.path, cls.lineno,
                f"{base} subclass {cls.name} has no NodeContract in "
                f"analysis/plan_contracts.py — every plan node needs a "
                f"declared schema/partitioning/ordering derivation"))
            continue
        declared = set(contract.semantic_fields) \
            | set(contract.estimate_fields)
        assigned = _init_fields(cls)
        assigned_names = {name for name, _ln in assigned}
        for name, ln in assigned:
            if name not in declared:
                out.append(Finding(
                    "plan-field-undeclared", sf.path, ln,
                    f"{cls.name}.__init__ assigns self.{name} but the "
                    f"NodeContract does not declare it — add it to "
                    f"semantic_fields or estimate_fields"))
        for name in sorted(declared - assigned_names):
            out.append(Finding(
                "plan-field-stale", sf.path, cls.lineno,
                f"NodeContract for {cls.name} declares field {name!r} "
                f"but the constructor no longer assigns it"))
        if check_schema_convention:
            arg = _super_schema_arg(cls)
            if arg is not None:
                is_child = _is_child_schema_call(arg)
                if contract.schema == "child" and not is_child:
                    out.append(Finding(
                        "plan-schema-convention", sf.path, cls.lineno,
                        f"{cls.name} is declared schema='child' but its "
                        f"constructor does not pass "
                        f"<child>.schema() to super().__init__"))
                elif contract.schema != "child" and is_child:
                    out.append(Finding(
                        "plan-schema-convention", sf.path, cls.lineno,
                        f"{cls.name} is declared schema="
                        f"{contract.schema!r} but its constructor "
                        f"inherits the child schema verbatim — declare "
                        f"it 'child' or pass an explicit schema"))
    for name, contract in sorted(registry.items()):
        if name not in seen:
            out.append(Finding(
                "plan-node-stale", sf.path, 1,
                f"NodeContract {name!r} ({contract.layer}) names a plan "
                f"node class that no longer exists"))
    return out


# ---------------------------------------------------------- rule registry

def _check_rules(sf: SourceFile) -> List[Finding]:
    out: List[Finding] = []
    seen: Set[str] = set()
    for cls in sf.tree.body:
        if not isinstance(cls, ast.ClassDef):
            continue
        if not any(isinstance(b, ast.Name) and b.id == "Rule"
                   for b in cls.bases):
            continue
        seen.add(cls.name)
        if cls.name not in plan_contracts.RULE_CONTRACTS:
            out.append(Finding(
                "plan-rule-unregistered", sf.path, cls.lineno,
                f"optimizer Rule subclass {cls.name} is not registered "
                f"in plan_contracts.RULE_CONTRACTS — declare it "
                f"schema-preserving or schema-rewriting"))
    for name in sorted(plan_contracts.RULE_CONTRACTS):
        if name not in seen:
            out.append(Finding(
                "plan-rule-stale", sf.path, 1,
                f"RULE_CONTRACTS entry {name!r} names a Rule subclass "
                f"that no longer exists"))
    return out


# ------------------------------------------------------- replan mutation

def _check_replan_mutations(sf: SourceFile) -> List[Finding]:
    """Non-``self`` attribute stores in the re-planning modules must hit
    only registered mutable fields; ``setattr`` is banned outright (a
    dynamic attribute name defeats this rule)."""
    out: List[Finding] = []
    allowed = plan_contracts.REPLAN_MUTABLE_FIELDS
    for stmt in ast.walk(sf.tree):
        targets: List[ast.AST] = []
        if isinstance(stmt, ast.Assign):
            targets = list(stmt.targets)
        elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
            targets = [stmt.target]
        elif isinstance(stmt, ast.Call) and call_name(stmt) == "setattr":
            out.append(Finding(
                "plan-foreign-field", sf.path, stmt.lineno,
                "setattr() on a plan object in a re-planning module — "
                "use an explicit attribute assignment so the mutable "
                "field set stays statically checkable"))
            continue
        for t in targets:
            elts = t.elts if isinstance(t, ast.Tuple) else [t]
            for e in elts:
                if not isinstance(e, ast.Attribute):
                    continue
                root = e.value
                while isinstance(root, ast.Attribute):
                    root = root.value
                if isinstance(root, ast.Name) and root.id == "self":
                    continue
                if e.attr not in allowed:
                    out.append(Finding(
                        "plan-foreign-field", sf.path, e.lineno,
                        f"re-planning code mutates .{e.attr} on an "
                        f"already-built plan object, which is not in "
                        f"plan_contracts.REPLAN_MUTABLE — semantic "
                        f"fields are frozen after planning"))
    return out


# -------------------------------------------------- fusion fallback check

def check_fusion_contracts() -> List[Finding]:
    """Functional check: build exemplar queries for each region grammar
    (chain / topk / join_agg), plan them with every region admitted on CPU
    tensors, and prove every region that forms keeps its schema identical
    to its fallback subtree's — a contract proven against the real
    planner, not the AST."""
    out: List[Finding] = []
    try:
        import daft_tpu_torch
        from daft_tpu_torch import col
        from daft_tpu_torch.context import (ExecutionConfig,
                                            execution_config_ctx)
        from daft_tpu_torch.physical import fusion
        from daft_tpu_torch.physical import plan as pp
        from daft_tpu_torch.physical.translate import translate
    except Exception as exc:  # pragma: no cover - import skew
        return [Finding("plan-fusion-fallback-schema", _FUSION_PATH, 1,
                        f"fusion contract check could not import the "
                        f"engine: {exc!r}")]

    cfg = ExecutionConfig(fusion="1", device="cpu")
    left = daft_tpu_torch.from_pydict({
        "k": [1, 2, 3, 4, 5, 6, 7, 8],
        "v": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0],
    })
    # build-side column names disjoint from the probe source's (the
    # join_agg grammar keys its joined plane dict by raw name)
    right = daft_tpu_torch.from_pydict({"rk": [1, 2, 3, 4],
                                        "w": [10, 20, 30, 40]})
    exemplars = {
        "chain": left.where(col("k") > 1)
                     .select(col("k"), (col("v") * 2).alias("v2")),
        "topk": left.where(col("k") > 1)
                    .select(col("k"), col("v"))
                    .sort("k").limit(3),
        "join_agg": left.join(right, left_on="k", right_on="rk")
                        .groupby("w").agg(col("v").sum()),
    }
    for shape, df in exemplars.items():
        try:
            with execution_config_ctx(fusion="1", device="cpu"):
                plan = translate(df._builder.optimize()._plan)
                fused = fusion.fuse_regions(plan, cfg)
        except Exception as exc:
            out.append(Finding(
                "plan-fusion-fallback-schema", _FUSION_PATH, 1,
                f"fusion contract exemplar {shape!r} failed to plan: "
                f"{exc!r}"))
            continue
        stack, seen = [fused], set()
        while stack:
            n = stack.pop()
            if id(n) in seen:
                continue
            seen.add(id(n))
            if isinstance(n, pp.FusedRegion):
                rf = list(n.schema().fields)
                ff = list(n.fallback.schema().fields)
                if rf != ff:
                    out.append(Finding(
                        "plan-fusion-fallback-schema", _FUSION_PATH, 1,
                        f"{n.shape} region schema "
                        f"{[f.name for f in rf]} != fallback schema "
                        f"{[f.name for f in ff]} on exemplar "
                        f"{shape!r} — fusion changed semantics"))
                stack.append(n.fallback)
            stack.extend(n.children)
    return out


# ----------------------------------------------------------------- entry

def check(sources: List[SourceFile]) -> List[Finding]:
    out: List[Finding] = []
    for sf in sources:
        if sf.path == _LOGICAL_PATH:
            out.extend(_check_layer(sf, "LogicalPlan",
                                    plan_contracts.LOGICAL_NODES,
                                    check_schema_convention=False))
        elif sf.path == _PHYSICAL_PATH:
            out.extend(_check_layer(sf, "PhysicalPlan",
                                    plan_contracts.PHYSICAL_NODES,
                                    check_schema_convention=True))
        elif sf.path == _OPTIMIZER_PATH:
            out.extend(_check_rules(sf))
        if sf.path in _REPLAN_PATHS:
            out.extend(_check_replan_mutations(sf))
    return out

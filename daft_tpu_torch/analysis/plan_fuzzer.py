"""The differential plan fuzzer (``python -m daft_tpu_torch.analysis
--fuzz``).

Reference: ``daft_tpu/analysis/plan_fuzzer.py``. Seeded and fully
deterministic: each seed expands (through an explicit
``random.Random``, so one seed gives the same tables and ops in both
packages) to a random relational program (join / filter / project /
group-agg / distinct / sort / top-n) over a nullable multi-dtype schema.
The program runs through a matrix of engine modes, and each answer is
compared bit for bit with the *unoptimized* oracle: the raw logical plan
translated with no optimizer rule and no fusion region, and run on the
pull interpreter on the host tier (:func:`run_reference`).

- ``optimized``: the optimizer and the default local engine (push)
- ``fused``: every fusion region admitted (``fusion="1"``)
- ``spilled``: the grace join's partitioned pairs forced
  (``spill_join="1"``)
- ``replanned``: the runner's AQE loop (``enable_aqe=True``)
- ``device``: every priced decision on the device, hash group-bys and
  hash joins (``DAFT_TORCH_DEVICE_FORCE=1``, ``DAFT_TORCH_KERNEL_GROUPBY``
  and ``_JOIN=hash``, ``DAFT_TORCH_DEVICE_JOIN=1``): on a card the
  hand-written kernels, on CPU tensors their plain versions
- ``bounded``: every breaker under ``DAFT_TORCH_MEMORY_LIMIT=1KB``, so
  the spill stores, the spilling agg reducer and its bucket merges run
  (the out-of-core parity tests' 400KB holds a whole fuzzer table, about
  6KB at most, and spills nothing)
- ``combined`` (not in :data:`MODES`): the distributed runner, which
  comes with ROADMAP A7; asking for it raises ``NotImplementedError``

The device is the caller's (``DAFT_TORCH_DEVICE``): ``cuda`` on a card,
``cpu`` in the CPU tests. Every mode restores the execution config and
the environment it changed, so the fuzzer leaves no state behind.

Rows are canonicalized (sorted on a total normalization of every cell)
before the comparison, so legal row-order differences never count, and
value differences always do. Floats aggregate only by min, max and count
(sums only over integers), so the exact oracle holds under any addition
order (the card's atomics). A mismatch is minimized greedily (ops dropped
while it persists) and reported with its seed: the tables regenerate from
the seed, so ``seed + ops`` is the whole repro.

Every run arms the plan sanitizer (``analysis/plan_sanitizer.py``) for
its duration, as the reference's armed test session does, and counts the
contract violations its queries raise (``sanitizer_violations``; the CLI
exits 1 on any).

Knobs: ``DAFT_TORCH_FUZZ_SEED`` (base seed, 0) and
``DAFT_TORCH_FUZZ_COUNT`` (seeds per run, 50).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import random
import time
from typing import Dict, List, Optional, Tuple

from .. import knobs

MODES = ("optimized", "fused", "spilled", "replanned", "device", "bounded")

_STRINGS = ("ant", "bee", "cat", "dog", "elk", "fox", None)

#: the environment each environment-driven mode sets
MODE_ENV = {
    "device": {"DAFT_TORCH_DEVICE_FORCE": "1",
               "DAFT_TORCH_KERNEL_GROUPBY": "hash",
               "DAFT_TORCH_KERNEL_JOIN": "hash",
               "DAFT_TORCH_DEVICE_JOIN": "1"},
    # below one fuzzer table, so every breaker spills
    "bounded": {"DAFT_TORCH_MEMORY_LIMIT": "1KB"},
}


def fuzz_seed_base() -> int:
    return knobs.env_int("DAFT_TORCH_FUZZ_SEED")


def fuzz_count() -> int:
    return knobs.env_int("DAFT_TORCH_FUZZ_COUNT")


# ------------------------------------------------------------------ data


def _gen_tables(rng: random.Random) -> Dict[str, Dict[str, list]]:
    """Two deterministic base tables with disjoint column names (so any
    join grammar is legal), every column nullable, keys low-cardinality
    (so joins and group-bys actually collide)."""
    nl = rng.randint(30, 120)
    nr = rng.randint(10, 60)
    left = {
        "id": list(range(nl)),  # unique: total-order tiebreaker
        "k": [rng.choice((None, 0, 1, 2, 3, 4, 5, 6, 7)) for _ in range(nl)],
        "v": [rng.choice((None, rng.randint(-50, 50))) for _ in range(nl)],
        "f": [rng.choice((None, round(rng.uniform(-5.0, 5.0), 3)))
              for _ in range(nl)],
        "s": [rng.choice(_STRINGS) for _ in range(nl)],
        "b": [rng.choice((None, True, False)) for _ in range(nl)],
    }
    right = {
        "rk": [rng.choice((None, 0, 1, 2, 3, 4, 5, 6, 7))
               for _ in range(nr)],
        "w": [rng.choice((None, rng.randint(0, 20))) for _ in range(nr)],
        "g": [rng.choice((None, round(rng.uniform(0.0, 9.0), 3)))
              for _ in range(nr)],
    }
    return {"left": left, "right": right}


# ------------------------------------------------------------- op algebra


def _apply_op(df, right_df, op):
    """Replay one concrete op spec onto a DataFrame. Specs are plain
    tuples (picklable, printable) so a repro is ``seed + ops``."""
    from .. import col
    kind = op[0]
    if kind == "join":
        return df.join(right_df, left_on="k", right_on="rk", how=op[1])
    if kind == "filter":
        _, name, cmp, const = op
        e = col(name)
        e = {"gt": e > const, "lt": e < const, "ge": e >= const,
             "le": e <= const, "eq": e == const}[cmp]
        return df.where(e)
    if kind == "filter_null":
        _, name, keep_null = op
        e = col(name).is_null()
        return df.where(e if keep_null else ~e)
    if kind == "project":
        _, names, computed = op
        exprs = [col(n) for n in names]
        if computed is not None:
            exprs.append((col(computed) * 2 + 1).alias(computed + "_x2"))
        return df.select(*exprs)
    if kind == "groupby":
        _, keys, aggs = op
        exprs = []
        for fn, name in aggs:
            e = col(name)
            e = {"sum": e.sum, "min": e.min, "max": e.max,
                 "count": e.count}[fn]()
            exprs.append(e.alias(f"{fn}_{name}"))
        return df.groupby(*keys).agg(*exprs)
    if kind == "distinct":
        return df.distinct()
    if kind == "sort":
        _, names, descs = op
        return df.sort(list(names), desc=list(descs))
    if kind == "topn":
        _, n, names, descs = op
        return df.sort(list(names), desc=list(descs)).limit(n)
    raise ValueError(f"unknown op {op!r}")


def build_df(tables: Dict[str, Dict[str, list]], ops: List[tuple]):
    from .. import from_pydict
    df = from_pydict(tables["left"])
    right = from_pydict(tables["right"])
    for op in ops:
        df = _apply_op(df, right, op)
    return df


def _cols_by_kind(df) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {"i": [], "f": [], "s": [], "b": []}
    for field in df.schema():
        t = str(field.dtype).lower()
        if "bool" in t:
            out["b"].append(field.name)
        elif "int" in t:
            out["i"].append(field.name)
        elif "float" in t or "double" in t:
            out["f"].append(field.name)
        elif "utf8" in t or "str" in t:
            out["s"].append(field.name)
    return out


def gen_case(seed: int) -> Tuple[Dict[str, Dict[str, list]], List[tuple]]:
    """Expand one seed into (tables, op chain). Every candidate op is
    validated against the live schema as it is appended: an op the schema
    can't host is skipped, keeping generation total."""
    from .. import from_pydict
    rng = random.Random(seed * 2654435761 % (2 ** 31))
    tables = _gen_tables(rng)
    ops: List[tuple] = []

    def try_push(op, df):
        try:
            nxt = _apply_op(df, _right, op)
            nxt.schema()  # force plan-time validation
        except Exception:
            return df
        ops.append(op)
        return nxt

    df = from_pydict(tables["left"])
    _right = from_pydict(tables["right"])

    if rng.random() < 0.65:
        df = try_push(("join",
                       rng.choice(("inner", "left", "semi", "anti"))), df)

    for _ in range(rng.randint(0, 3)):
        kinds = _cols_by_kind(df)
        num = kinds["i"] + kinds["f"]
        if num and rng.random() < 0.8:
            name = rng.choice(num)
            cmp = rng.choice(("gt", "lt", "ge", "le", "eq"))
            const = (rng.randint(-10, 10) if name in kinds["i"]
                     else round(rng.uniform(-5.0, 5.0), 2))
            df = try_push(("filter", name, cmp, const), df)
        else:
            anyc = [c for v in kinds.values() for c in v]
            if anyc:
                df = try_push(("filter_null", rng.choice(anyc),
                               rng.random() < 0.3), df)

    if rng.random() < 0.5:
        kinds = _cols_by_kind(df)
        anyc = [c for v in kinds.values() for c in v]
        if len(anyc) >= 2:
            keep = rng.sample(anyc, rng.randint(1, len(anyc) - 1))
            num = [c for c in kinds["i"] + kinds["f"] if c not in keep]
            computed = rng.choice(num) if num and rng.random() < 0.6 \
                else None
            df = try_push(("project", sorted(keep), computed), df)

    roll = rng.random()
    if roll < 0.4:
        kinds = _cols_by_kind(df)
        keyable = kinds["i"] + kinds["s"] + kinds["b"]
        if keyable:
            keys = rng.sample(keyable, min(len(keyable),
                                           rng.randint(1, 2)))
            aggs = []
            for c in kinds["i"]:
                if c not in keys and rng.random() < 0.7:
                    aggs.append((rng.choice(("sum", "min", "max",
                                             "count")), c))
            for c in kinds["f"]:
                # floats: order-independent reductions only, so the
                # bit-identical oracle survives re-partitioned addition
                if c not in keys and rng.random() < 0.7:
                    aggs.append((rng.choice(("min", "max", "count")), c))
            if aggs:
                df = try_push(("groupby", sorted(keys), aggs), df)
    elif roll < 0.55:
        df = try_push(("distinct",), df)

    kinds = _cols_by_kind(df)
    anyc = sorted(c for v in kinds.values() for c in v)
    if anyc and rng.random() < 0.6:
        if rng.random() < 0.5:
            by = rng.sample(anyc, min(len(anyc), rng.randint(1, 2)))
            df = try_push(("sort", by,
                           [rng.random() < 0.5 for _ in by]), df)
        else:
            # top-n must follow a TOTAL order or the cut itself is
            # nondeterministic across modes: sort by every column
            df = try_push(("topn", rng.randint(1, 12), anyc,
                           [rng.random() < 0.5 for _ in anyc]), df)
    return tables, ops


# ------------------------------------------------------- oracle & modes


def _norm(v):
    if v is None:
        return ("n",)
    if isinstance(v, bool):
        return ("b", v)
    if isinstance(v, float):
        return ("f", repr(v))  # exact: bit-identical, NaN-stable
    if isinstance(v, int):
        return ("i", v)
    return ("s", str(v))


def canonical_rows(pydict: Dict[str, list]) -> List[tuple]:
    cols = sorted(pydict)
    rows = list(zip(*(pydict[c] for c in cols))) if cols else []
    return sorted((tuple(_norm(v) for v in r) for r in rows))


def _concat_pydict(parts, schema) -> Dict[str, list]:
    out: Dict[str, list] = {name: [] for name in schema.column_names}
    for p in parts:
        d = p.to_pydict()
        for name in out:
            out[name].extend(d.get(name, []))
    return out


def run_reference(df) -> Dict[str, list]:
    """The differential oracle: the RAW logical plan (no optimizer rule),
    translated with no fusion region and run on the pull interpreter on
    the host tier: no spill planning, no AQE, no device."""
    from ..context import execution_config_ctx
    from ..execution.executor import LocalExecutor
    from ..physical.translate import translate
    with execution_config_ctx(device="0", fusion="0", enable_aqe=False,
                              local_executor="interp"):
        plan = translate(df._builder.plan)
        return _concat_pydict(list(LocalExecutor(None).run(plan)),
                              df.schema())


@contextlib.contextmanager
def _env(values: Dict[str, str]):
    """Set environment knobs, and put back exactly what was there."""
    prev = {k: os.environ.get(k) for k in values}
    try:
        os.environ.update(values)
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def _mode_ctx(mode: str):
    from ..context import execution_config_ctx
    if mode == "combined":
        raise NotImplementedError(
            "plan fuzzer mode 'combined' needs the distributed runner "
            "(runners/distributed_runner.py), which comes with ROADMAP A7")
    cfg = {"optimized": {}, "fused": {"fusion": "1"},
           "spilled": {"spill_join": "1"},
           "replanned": {"enable_aqe": True},
           "device": {}, "bounded": {}}
    if mode not in cfg:
        raise ValueError(f"unknown mode {mode!r}")
    with _env(MODE_ENV.get(mode, {})), execution_config_ctx(**cfg[mode]):
        yield


def run_mode(tables, ops, mode: str) -> Dict[str, list]:
    with _mode_ctx(mode):
        return build_df(tables, ops).to_pydict()


# ------------------------------------------------------------- the loop


@dataclasses.dataclass
class Mismatch:
    seed: int
    mode: str
    ops: List[tuple]
    detail: str

    def repro(self) -> str:
        lines = [f"seed={self.seed} mode={self.mode}",
                 "minimized ops:"]
        lines.extend(f"  {op!r}" for op in self.ops)
        lines.append(f"detail: {self.detail}")
        lines.append("replay: from daft_tpu_torch.analysis import "
                     f"plan_fuzzer; plan_fuzzer.replay({self.seed}, "
                     f"{self.mode!r})")
        return "\n".join(lines)


@dataclasses.dataclass
class FuzzResult:
    seeds_run: int = 0
    cases_compared: int = 0
    mismatches: List[Mismatch] = dataclasses.field(default_factory=list)
    errors: List[str] = dataclasses.field(default_factory=list)
    #: per mode: cases compared, mismatches (answers that differ) and
    #: errors (the mode raised; also listed in ``mismatches``)
    per_mode: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)
    #: plan-contract violations the run's queries raised, and their text
    sanitizer_violations: int = 0
    sanitizer_detail: List[str] = dataclasses.field(default_factory=list)

    def summary(self) -> Dict[str, int]:
        return {"seeds_run": self.seeds_run,
                "cases_compared": self.cases_compared,
                "mismatches": len(self.mismatches),
                "errors": len(self.errors),
                "sanitizer_violations": self.sanitizer_violations}


def _diff_detail(ref_rows, got_rows) -> str:
    if len(ref_rows) != len(got_rows):
        return (f"row count: reference {len(ref_rows)} vs mode "
                f"{len(got_rows)}")
    for i, (a, b) in enumerate(zip(ref_rows, got_rows)):
        if a != b:
            return f"first differing canonical row {i}: {a!r} vs {b!r}"
    return "rows differ"


def _compare(tables, ops, mode: str) -> Optional[str]:
    """None if mode agrees with the reference, else a human detail."""
    ref = canonical_rows(run_reference(build_df(tables, ops)))
    got = canonical_rows(run_mode(tables, ops, mode))
    if ref == got:
        return None
    return _diff_detail(ref, got)


def _minimize(tables, ops: List[tuple], mode: str) -> List[tuple]:
    """Greedy delta-debug: drop ops one at a time while the mismatch
    persists; the survivor is the minimal failing chain."""
    ops = list(ops)
    shrunk = True
    while shrunk and len(ops) > 1:
        shrunk = False
        for i in range(len(ops)):
            trial = ops[:i] + ops[i + 1:]
            try:
                if _compare(tables, trial, mode) is not None:
                    ops = trial
                    shrunk = True
                    break
            except Exception:
                continue  # dropping this op broke the plan: keep it
    return ops


def replay(seed: int, mode: str) -> Optional[str]:
    """Re-run one seed against one mode; returns the mismatch detail or
    None. The entry point mismatch repros print."""
    tables, ops = gen_case(seed)
    return _compare(tables, ops, mode)


def run_fuzz(count: Optional[int] = None, seed: Optional[int] = None,
             modes: Optional[Tuple[str, ...]] = None,
             log=None, budget_s: Optional[float] = None) -> FuzzResult:
    """``count`` seeds from ``seed`` in each of ``modes``; with
    ``budget_s``, further seeds while the run's wall is under it. The plan
    sanitizer is armed for the run (and disarmed after it, when the run
    armed it)."""
    from . import plan_sanitizer
    armed_here = not plan_sanitizer.is_enabled()
    if armed_here:
        plan_sanitizer.enable()
    try:
        viol0 = len(plan_sanitizer.summary().get("violations", []))
        res = _run_fuzz(count, seed, modes, log, budget_s)
        viol = plan_sanitizer.summary().get("violations", [])[viol0:]
        res.sanitizer_violations = len(viol)
        res.sanitizer_detail = list(viol)
        return res
    finally:
        if armed_here:
            plan_sanitizer.disable()


def _run_fuzz(count, seed, modes, log, budget_s) -> FuzzResult:
    base = fuzz_seed_base() if seed is None else seed
    n = fuzz_count() if count is None else count
    t0 = time.perf_counter()
    modes = tuple(modes or MODES)
    for mode in modes:
        with _mode_ctx(mode):  # an unknown or unported mode fails first
            pass
    res = FuzzResult(per_mode={m: {"cases": 0, "mismatches": 0,
                                   "errors": 0} for m in modes})
    i = 0
    while i < n or (budget_s is not None
                    and time.perf_counter() - t0 < budget_s):
        s = base + i
        i += 1
        try:
            tables, ops = gen_case(s)
            ref = canonical_rows(run_reference(build_df(tables, ops)))
        except Exception as e:  # a generation/reference bug, not a diff
            res.errors.append(f"seed {s}: reference failed: {e!r}")
            continue
        res.seeds_run += 1
        for mode in modes:
            counts = res.per_mode[mode]
            try:
                got = canonical_rows(run_mode(tables, ops, mode))
            except Exception as e:
                counts["errors"] += 1
                res.mismatches.append(Mismatch(
                    s, mode, ops, f"mode raised: {e!r}"))
                continue
            res.cases_compared += 1
            counts["cases"] += 1
            if got != ref:
                counts["mismatches"] += 1
                small = _minimize(tables, ops, mode)
                detail = _compare(tables, small, mode) \
                    or _diff_detail(ref, got)
                res.mismatches.append(Mismatch(s, mode, small, detail))
        if log is not None and i % 10 == 0:
            log(f"plan fuzzer: {i}/{n} seeds, "
                f"{len(res.mismatches)} mismatches")
    return res

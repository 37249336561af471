"""Rule family — chaos-replay determinism, over the port.

The port's copy of ``daft_tpu/analysis/rule_determinism.py``. The
resilience plane's contract (``distributed/resilience.py``) is that a
seeded chaos run
replays **bit-identically**: every fault decision hashes stable
planner-minted identities, and every retry/recovery event sequence is a
pure function of (plan, seed). One unseeded ``random.*`` call, one
wall-clock read feeding a *decision*, or one unordered pool iteration in
a replay-critical module silently voids that contract — long after the
CI chaos test was written.

Scope: :data:`framework.REPLAY_CRITICAL` modules only. Flags:

- ``unseeded-random`` — module-level ``random.*`` / ``np.random.*``
  draws (seeded ``random.Random(seed)`` / ``default_rng(seed)``
  instances are fine — the rule flags the shared global streams);
- ``wallclock-decision`` — ``time.time()`` / ``time.monotonic()`` /
  ``time.perf_counter()`` inside an ``if``/``while`` test or a
  comparison: a wall-clock read steering control flow rather than
  feeding a metric. Injected-clock indirection (``self.clock()``) is
  the sanctioned pattern and is not flagged;
- ``unordered-pool-iteration`` — ``as_completed(...)`` /
  ``imap_unordered(...)`` without a downstream re-order: completion
  order is scheduler noise, so any stateful consumer diverges between
  runs.
"""

from __future__ import annotations

import ast
from typing import List

from .framework import REPLAY_CRITICAL, Finding, SourceFile, call_name

_RANDOM_FNS = {
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "gauss", "normalvariate", "betavariate",
    "expovariate", "triangular", "random_sample", "rand", "randn",
    "permutation", "bytes", "getrandbits",
}

_CLOCK_CALLS = ("time.time", "time.monotonic", "time.perf_counter",
                "monotonic", "perf_counter")

_UNORDERED = ("as_completed", "imap_unordered")


def _is_unseeded_random(node: ast.Call) -> bool:
    name = call_name(node)
    parts = name.split(".")
    if len(parts) < 2:
        return False
    # random.X(...) / np.random.X(...) — the process-global streams
    if parts[-2] == "random" and parts[-1] in _RANDOM_FNS:
        return True
    return False


def _clock_calls(node: ast.AST) -> List[ast.Call]:
    out = []
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and call_name(sub) in _CLOCK_CALLS:
            out.append(sub)
    return out


def check(sources: List[SourceFile]) -> List[Finding]:
    out: List[Finding] = []
    for sf in sources:
        if sf.path not in REPLAY_CRITICAL:
            continue
        decision_clocks = set()
        for node in ast.walk(sf.tree):
            if isinstance(node, (ast.If, ast.While)):
                for c in _clock_calls(node.test):
                    decision_clocks.add(id(c))
                    out.append(Finding(
                        "wallclock-decision", sf.path, c.lineno,
                        f"{call_name(c)}() steers an "
                        f"{'if' if isinstance(node, ast.If) else 'while'} "
                        f"branch in a replay-critical module — inject a "
                        f"clock (the RetryPolicy pattern) or justify"))
            elif isinstance(node, ast.Compare):
                for c in _clock_calls(node):
                    if id(c) not in decision_clocks:
                        decision_clocks.add(id(c))
                        out.append(Finding(
                            "wallclock-decision", sf.path, c.lineno,
                            f"{call_name(c)}() inside a comparison in a "
                            f"replay-critical module — decisions must not "
                            f"read the wall clock directly"))
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            if _is_unseeded_random(node):
                out.append(Finding(
                    "unseeded-random", sf.path, node.lineno,
                    f"{call_name(node)}() draws from the process-global "
                    f"random stream in a replay-critical module — use a "
                    f"seeded instance keyed on a stable identity"))
            name = call_name(node).rsplit(".", 1)[-1]
            if name in _UNORDERED:
                out.append(Finding(
                    "unordered-pool-iteration", sf.path, node.lineno,
                    f"{name}() yields futures in completion order — "
                    f"replay-critical consumers must re-order results "
                    f"(or iterate the future list in submit order)"))
    return out

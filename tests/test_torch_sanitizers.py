"""The port's runtime sanitizers (lock order, retrace, plan) against the
reference's, and armed end to end.

The process-wide lock patch is never armed in this process: both packages
are imported here and share one ``threading`` module. Parity runs on
instances (the same event sequences through a ``daft_tpu`` and a
``daft_tpu_torch`` sanitizer); the armed run is a subprocess with
``DAFT_TORCH_SANITIZE=1``, ``DAFT_TORCH_SANITIZE_PLAN=1`` and
``DAFT_TORCH_SANITIZE_RETRACE=1`` on CPU tensors.
"""

import json
import math
import os
import subprocess
import sys
import threading
import time

import pytest

import daft_tpu
from daft_tpu import col as r_col
from daft_tpu.analysis import lock_sanitizer as r_lock
from daft_tpu.analysis import plan_sanitizer as r_plan
from daft_tpu.analysis import retrace_sanitizer as r_retrace
from daft_tpu.micropartition import MicroPartition as RMP
from daft_tpu.recordbatch import RecordBatch as RRB

import daft_tpu_torch
from daft_tpu_torch import col as p_col
from daft_tpu_torch import observability as p_obs
from daft_tpu_torch.analysis import lock_sanitizer as p_lock
from daft_tpu_torch.analysis import plan_sanitizer as p_plan
from daft_tpu_torch.analysis import retrace_sanitizer as p_retrace
from daft_tpu_torch.micropartition import MicroPartition as PMP
from daft_tpu_torch.recordbatch import RecordBatch as PRB

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ lock order

def _inverted_pair(mod):
    san = mod.LockOrderSanitizer()
    la = san.track(threading.Lock(), "a.py:1")
    lb = san.track(threading.Lock(), "b.py:1")
    ab_done = threading.Event()

    def t1():
        with la:
            with lb:
                pass
        ab_done.set()

    def t2():
        ab_done.wait(5)
        with lb:
            with la:
                pass

    th = [threading.Thread(target=t1), threading.Thread(target=t2)]
    for t in th:
        t.start()
    for t in th:
        t.join(5)
    return san


def _consistent(mod):
    san = mod.LockOrderSanitizer()
    la = san.track(threading.Lock(), "a.py:1")
    lb = san.track(threading.Lock(), "b.py:1")
    for _ in range(3):
        with la:
            with lb:
                pass
    return san


def _reentrant(mod):
    san = mod.LockOrderSanitizer()
    lr = san.track(threading.RLock(), "r.py:1")
    other = san.track(threading.Lock(), "o.py:1")
    with lr:
        with lr:
            with other:
                pass
    return san


def _contended(mod):
    san = mod.LockOrderSanitizer()
    lock = san.track(threading.Lock(), "c.py:1")
    acquired, release = threading.Event(), threading.Event()

    def holder():
        with lock:
            acquired.set()
            release.wait(5)

    th = threading.Thread(target=holder)
    th.start()
    acquired.wait(5)
    waiter = threading.Thread(
        target=lambda: lock.acquire() or lock.release())
    waiter.start()
    time.sleep(0.05)   # the waiter hits the contended probe
    release.set()
    th.join(5)
    waiter.join(5)
    return san


def _sleep_under_lock(mod):
    san = mod.LockOrderSanitizer()
    lock = san.track(threading.Lock(), "s.py:1")
    with lock:
        san.note_blocking("time.sleep(0.001)")
    san.note_blocking("time.sleep(0.001)")   # not held: not counted
    return san


LOCK_CASES = {"inverted-pair": _inverted_pair, "consistent": _consistent,
              "rlock-reentrance": _reentrant, "contention": _contended,
              "sleep-under-lock": _sleep_under_lock}


@pytest.mark.parametrize("case", sorted(LOCK_CASES))
def test_lock_sanitizer_parity_on_instances(case):
    ref = LOCK_CASES[case](r_lock).summary()
    port = LOCK_CASES[case](p_lock).summary()
    keys = ("locks", "edges", "cycles", "acquisitions",
            "blocking_while_held", "blocking_sites")
    assert {k: port[k] for k in keys} == {k: ref[k] for k in keys}
    assert (port["contended"] >= 1) == (ref["contended"] >= 1)
    if case == "inverted-pair":
        assert len(port["cycles"]) == 1
    if case == "sleep-under-lock":
        assert port["blocking_while_held"] == 1


def test_condition_over_a_tracked_rlock_waits_and_wakes():
    """A bare ``threading.Condition()`` built by the port's code gets a
    tracked RLock: the proxy forwards the RLock's own wait internals, so a
    wait releases every level and the wake-up re-takes them, books
    included."""
    san = p_lock.LockOrderSanitizer()
    cond = threading.Condition(san.track(threading.RLock(), "cv.py:1"))
    box = []

    def waiter():
        with cond:
            with cond:          # re-entrant: two levels released by wait
                while not box:
                    cond.wait(5)
                box.append(len(san.held_sites()))

    th = threading.Thread(target=waiter)
    th.start()
    time.sleep(0.05)
    with cond:
        box.append("go")
        cond.notify()
    th.join(5)
    assert box == ["go", 2]
    assert san.held_sites() == []
    assert san.summary()["cycles"] == []


def test_queue_over_a_tracked_lock_keeps_the_reference_protocol():
    import queue
    san = p_lock.LockOrderSanitizer()
    q = queue.Queue(maxsize=2)
    q.mutex = san.track(threading.Lock(), "q.py:1")
    for name in ("not_empty", "not_full", "all_tasks_done"):
        setattr(q, name, threading.Condition(q.mutex))
    q.put(1)
    q.put(2)
    assert q.get() == 1 and q.get() == 2
    assert san.summary()["acquisitions"] >= 4


def test_lock_patch_is_off_by_default():
    assert not p_lock.is_enabled()
    assert threading.Lock is p_lock._real_lock
    assert threading.RLock is p_lock._real_rlock
    assert p_lock.counters_snapshot() == {}


# --------------------------------------------------------------- retrace

#: a reference site and a port site of the same budget, and their exempt
#: warm-up sites
_R_SITE, _P_SITE = "fragment.packed", "fragment.fused_agg"
_R_EXEMPT, _P_EXEMPT = "warmup.aot", "warmup.aot"


def _drive(mod, san, event, sequence):
    for op in sequence:
        kind = op[0]
        if kind == "dispatch":      # one scope entry, two events in it
            _, site, key = op
            san.push(site, key)
            san.note_event(event, 0.01)
            san.note_event(event, 0.001)
            san.pop()
        elif kind == "unscoped":
            san.note_event(event, 0.01)
        elif kind == "nested":      # an outer entry, an inner one charged
            _, outer, inner, key = op
            san.push(outer, key)
            san.push(inner, key)
            san.note_event(event, 0.01)
            san.pop()
            san.pop()


def _retrace_pair(sequence, multiplier):
    ref = r_retrace.RetraceSanitizer(budget_multiplier=multiplier)
    port = p_retrace.RetraceSanitizer(budget_multiplier=multiplier)
    rename = {_R_SITE: _P_SITE, _R_EXEMPT: _P_EXEMPT,
              "kernels.argsort": "runtime.argsort"}
    _drive(r_retrace, ref, r_retrace.TRACE_EVENT, sequence)
    port_seq = [tuple(rename.get(x, x) if isinstance(x, str) else x
                      for x in op) for op in sequence]
    _drive(p_retrace, port, p_retrace.SEGMENT_EVENT, port_seq)
    return ref.summary(), port.summary(), rename


RETRACE_CASES = {
    "one-signature-twice": ([("dispatch", _R_SITE, "k1")] * 2, 1),
    "distinct-signatures": ([("dispatch", _R_SITE, "k1"),
                             ("dispatch", _R_SITE, "k2")], 1),
    "budget-multiplier": ([("dispatch", _R_SITE, "k1")] * 3, 2),
    "exempt-site": ([("dispatch", _R_EXEMPT, "k1")] * 4, 1),
    "unscoped": ([("unscoped",), ("unscoped",),
                  ("dispatch", _R_SITE, "k1")], 1),
    "nesting": ([("nested", _R_SITE, "kernels.argsort", "k1")] * 2, 1),
}


@pytest.mark.parametrize("case", sorted(RETRACE_CASES))
def test_retrace_sanitizer_parity_on_instances(case):
    seq, mult = RETRACE_CASES[case]
    ref, port, rename = _retrace_pair(seq, mult)
    assert port["events"] == ref["traces"]
    assert port["unscoped_events"] == ref["unscoped_traces"]
    assert port["site_events"] == {rename[k]: v for k, v in
                                   ref["site_traces"].items()}
    assert len(port["violations"]) == len(ref["violations"])
    assert sorted(port["unscoped_sites"].values()) \
        == sorted(ref["unscoped_sites"].values())


def test_retrace_scope_measures_exclusive_growth_and_launches():
    """On a card the scopes read the allocator: growth inside a nested
    scope charges the inner site only, the outer site its own remainder;
    a kernel launch is credited to every site on the stack."""
    counts = [0, 0]
    san = p_retrace.RetraceSanitizer(measure=lambda: tuple(counts))
    san.push("fragment.fused_agg", ("p", 1024))
    counts[0] += 2                                  # the outer's own
    san.push("hash_agg.build", (1024, 2048))
    counts[0] += 3
    counts[1] += 1                                  # a pinned block
    san.note_launch("hash_agg.build")
    san.pop()
    san.pop()
    san.note_launch("hash_join.probe")              # no scope: unscoped
    s = san.summary()
    assert s["site_segments"] == {"fragment.fused_agg": 2,
                                  "hash_agg.build": 3}
    assert s["site_pinned"] == {"hash_agg.build": 1}
    assert s["site_launches"] == {
        "fragment.fused_agg": {"hash_agg.build": 1},
        "hash_agg.build": {"hash_agg.build": 1}}
    assert s["unscoped_launches"] == {"hash_join.probe": 1}
    # under an engine site: the fused agg's; a wrapper's own scope alone
    # (a path that enters no engine site) is not an engine launch
    assert s["engine_launches"] == {"hash_agg.build": 1}
    san.push("hash_join.build", (64, 128))
    san.note_launch("hash_join.build")
    san.pop()
    assert san.summary()["engine_launches"] == {"hash_agg.build": 1}
    assert s["site_entries"] == {"fragment.fused_agg": 1,
                                 "hash_agg.build": 1}
    # the steady repeat allocates nothing: no new event, no violation
    san.push("fragment.fused_agg", ("p", 1024))
    san.pop()
    # outer: one event; inner: a segment event and a pinned one
    assert san.summary()["events"] == s["events"] == 3
    assert s["site_events"] == {"fragment.fused_agg": 1,
                                "hash_agg.build": 1}
    assert san.summary()["violations"] == []
    # ...and a repeat that still grows is the budget violation
    san.push("fragment.fused_agg", ("p", 1024))
    counts[0] += 1
    san.pop()
    assert len(san.summary()["violations"]) == 1


def test_retrace_first_run_is_warmup_repeats_are_budgeted():
    """Armed in a process, the runner marks each query with its plan's
    identity: the allocating entries of a query's first run at a signature
    are the allocator's warm-up (counted, never enforced); a repeat of the
    same query may allocate nothing at a signature it has warmed, and
    another query's first run is its own warm-up."""
    counts = [0, 0]
    san = p_retrace.RetraceSanitizer(measure=lambda: tuple(counts))

    def entry(key, grow):
        san.push("joins.device_match", key)
        counts[0] += grow
        san.pop()

    san.begin_query("q3")
    for _ in range(5):          # five pairs of one query, each allocating
        entry("k", 1)
    assert san.summary()["violations"] == []
    assert san.summary()["warmup_events"] == 5
    san.begin_query("q9")       # another query at the same signature
    entry("k", 1)
    entry("k", 1)
    assert san.summary()["warmup_events"] == 7
    san.begin_query("q3")       # the repeat: steady, nothing new
    entry("k", 0)
    entry("k2", 1)              # a new signature: its own warm-up
    assert san.summary()["violations"] == []
    san.begin_query("q3")
    entry("k", 1)               # a repeat allocating at a warmed signature
    assert len(san.summary()["violations"]) == 1
    entry("k", 1)               # reported once per query and signature
    assert len(san.summary()["violations"]) == 1
    san.begin_query("q9")
    entry("k", 1)               # q9's repeat: its own violation
    assert len(san.summary()["violations"]) == 2
    assert san.summary()["queries"] == 5


def test_slot_streams_are_reused_across_queries(monkeypatch):
    """Found by the retrace sanitizer on the card: a fresh stream per
    pipeline window found none of the caching allocator's blocks (they
    are kept per stream), so even a steady repeat allocated new segments.
    A pipeline run now leases a set of ``window + 1`` streams, slot
    ``seq`` on stream ``seq % (window + 1)``: serial runs reuse one set,
    concurrent runs each get their own, and a released set is reused
    lowest first."""
    import torch
    from daft_tpu_torch.device import pipeline as dpipe
    made = []

    class FakeStream:
        def __init__(self, device=None):
            made.append(self)

    monkeypatch.setattr(torch.cuda, "Stream", FakeStream)
    monkeypatch.setattr(dpipe, "_stream_sets", {})
    monkeypatch.setattr(dpipe, "_free_sets", {})
    dev = torch.device("cuda", 0)

    def run(gate):
        return [dpipe.slot_stream(gate, dev, seq) for seq in range(8)]

    g1 = dpipe.WindowGate(2)
    first = run(g1)
    assert first[0] is first[3] is first[6] and len(made) == 3
    dpipe.release_streams(g1)
    g2 = dpipe.WindowGate(2)
    assert run(g2) == first and len(made) == 3     # the next query's
    g3 = dpipe.WindowGate(2)                       # a concurrent one's
    other = run(g3)
    assert not set(map(id, other)) & set(map(id, first))
    assert len(made) == 6
    dpipe.release_streams(g2)
    dpipe.release_streams(g3)
    g4 = dpipe.WindowGate(2)
    assert run(g4) == first                        # lowest set first
    dpipe.release_streams(g4)
    dpipe.release_streams(g4)                      # idempotent
    assert sorted(dpipe._free_sets[0]) == [0, 1]
    assert dpipe.slot_stream(g4, torch.device("cpu"), 0) is None
    assert dpipe.slot_stream(g4, None, 0) is None


def test_a_repeat_run_is_recognized_as_a_repeat(tmp_path, monkeypatch):
    """Found on the card: a query's identity was its plan's semantic id,
    which names a scan by its operator object, and the fused agg's
    signature key held a program compiled anew per morsel; so every run
    of a query was a first run at new signatures, and the repeat budget
    could never fire. A query is now named by its plan's content id (its
    scans by their files) and the fused program is memoized, as the
    reference memoizes it: a repeat over DataFrames built anew that still
    allocates is a violation; its first run is warm-up."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq
    from daft_tpu_torch.device import fragment
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("DAFT_TORCH_DEVICE_FORCE", "1")
    monkeypatch.setenv("DAFT_TORCH_KERNEL_GROUPBY", "hash")
    rng = np.random.default_rng(0)
    pq.write_table(pa.table({"k": rng.integers(0, 50, 4000),
                             "v": rng.random(4000)}),
                   str(tmp_path / "p.parquet"))
    grows = [0]

    def measure():              # every scope entry allocates a segment
        grows[0] += 1
        return grows[0], 0

    san = p_retrace.RetraceSanitizer(measure=measure)
    monkeypatch.setattr(p_retrace, "_global", san)
    monkeypatch.setattr(p_retrace, "_enabled", True)

    def run():
        df = daft_tpu_torch.read_parquet(str(tmp_path / "*.parquet"))
        return df.groupby("k").agg(p_col("v").sum()).sort("k").to_pydict()

    def plan():
        df = daft_tpu_torch.read_parquet(str(tmp_path / "*.parquet"))
        return df.groupby("k").agg(p_col("v").sum()).builder.plan

    assert plan().content_id() == plan().content_id()
    assert plan().semantic_id() != plan().semantic_id()
    first = run()
    s = san.summary()
    assert s["queries"] == 1 and s["site_entries"]["fragment.fused_agg"]
    assert s["warmup_events"] == s["events"] > 0
    assert s["violations"] == [] and s["repeat_entries"] == 0
    assert run() == first
    s = san.summary()
    assert s["queries"] == 2 and s["repeat_entries"] > 0
    assert any(v.startswith("fragment.fused_agg: a repeat of query")
               for v in s["violations"]), s["violations"]
    progs = fragment.fused_programs()
    assert len({id(p) for p in progs}) == len(progs)


def test_retrace_is_off_by_default_and_allocation_free():
    assert not p_retrace.is_enabled()
    a = p_retrace.dispatch_scope("fragment.fused_agg", 1)
    b = p_retrace.dispatch_scope("hash_join.probe", 2)
    assert a is b is p_retrace._NOOP
    p_retrace.note_launch("hash_agg.build")   # no-op, no error
    assert p_retrace.counters_snapshot() == {}


# ------------------------------------------------------------------ plan

def _mp(pkg_mp, pkg_rb, data):
    return pkg_mp.from_recordbatch(pkg_rb.from_pydict(data))


def _plan_cases(mod, pkg, col, MP, RB):
    out = {}
    s = mod.PlanSanitizer()
    a = pkg.from_pydict({"x": [1]}).schema()
    b = pkg.from_pydict({"x": [1.5]}).schema()
    s.check_rule("PushDownFilter", a, b)
    s.check_rule("PushDownFilter", a, a)
    out["schema-change"] = s.summary()

    s = mod.PlanSanitizer()
    s.check_rule("TotallyNovelRule", a, a)
    out["unregistered-rule"] = s.summary()

    class Stub:
        sort_by = (col("k"),)
        descending = (False,)
        nulls_first = (False,)

    s = mod.PlanSanitizer(sample_rows=16)
    s._check_order(Stub(), _mp(MP, RB, {"k": [3, 1, 2]}))
    s._check_order(Stub(), _mp(MP, RB, {"k": [1, 2, 3]}))
    out["unsorted-partition"] = s.summary()

    class Filter:
        children = ()

    class Project:
        def __init__(self, child):
            self.children = [child]

    s = mod.PlanSanitizer()
    child = Filter()
    list(s.wrap(child, iter([_mp(MP, RB, {"x": [1, 2, 3]})])))
    list(s.wrap(Project(child), iter([_mp(MP, RB, {"x": [1, 2]})])))
    child2 = Filter()
    list(s.wrap(child2, iter([_mp(MP, RB, {"x": [1, 2, 3]})])))
    list(s.wrap(Project(child2), iter([_mp(MP, RB, {"x": [4, 5, 6]})])))
    out["row-loss"] = s.summary()

    part = _mp(MP, RB, {"k": [7] * 12, "v": list(range(12))})
    true_bucket = next(i for i, p in enumerate(
        part.partition_by_hash([col("k")], 4)) if len(p))
    s = mod.PlanSanitizer(sample_rows=16)
    saved = (mod._global, mod._enabled)
    mod._global, mod._enabled = s, True
    try:
        mod.check_grace_pair(true_bucket, 4, [col("k")], part)
        mod.check_grace_pair((true_bucket + 1) % 4, 4, [col("k")], part)
    finally:
        mod._global, mod._enabled = saved
    out["grace-pair"] = s.summary()
    out["grace-bucket"] = true_bucket
    return out


def test_plan_sanitizer_parity_on_instances(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    ref = _plan_cases(r_plan, daft_tpu, r_col, RMP, RRB)
    port = _plan_cases(p_plan, daft_tpu_torch, p_col, PMP, PRB)
    assert port == ref
    assert len(port["schema-change"]["violations"]) == 1
    assert "not registered" in port["unregistered-rule"]["violations"][0]
    assert len(port["unsorted-partition"]["violations"]) == 1
    assert len(port["row-loss"]["violations"]) == 1
    assert port["row-loss"]["conservation_checks"] == 2
    assert len(port["grace-pair"]["violations"]) == 1


def test_plan_sanitizer_is_off_by_default():
    assert not p_plan.is_enabled()
    it = iter([1, 2])
    assert p_plan.wrap_node(object(), it) is it
    assert p_plan.counters_snapshot() == {}
    p_plan.check_rule("PushDownFilter", None, None)   # returns at once


def _bad_pair():
    """A depth-0 grace bucket pair whose rows hash to another bucket."""
    rb = PRB.from_pydict({"k": [7] * 12, "v": list(range(12))})
    true = next(i for i, p in enumerate(
        PMP.from_recordbatch(rb).partition_by_hash([p_col("k")], 4))
        if len(p))

    class Node:
        left_on = [p_col("k")]
        right_on = [p_col("k")]

    return (true + 1) % 4, Node(), [rb]


def test_grace_pair_check_runs_only_when_armed(monkeypatch):
    """The grace join's pair check lives behind the plan sanitizer, as in
    the reference: unarmed, nothing runs; armed, a stray pair is a counted
    ``plansan`` violation and never an exception."""
    from daft_tpu_torch.execution import out_of_core
    bucket, node, batches = _bad_pair()
    calls = []
    monkeypatch.setattr(p_plan, "check_grace_pair",
                        lambda *a: calls.append(a))
    out_of_core._grace_pair_check(bucket, 4, node, batches, batches)
    assert calls == []
    monkeypatch.undo()

    san = p_plan.PlanSanitizer(sample_rows=16)
    monkeypatch.setattr(p_plan, "_global", san)
    monkeypatch.setattr(p_plan, "_enabled", True)
    out_of_core._grace_pair_check(bucket, 4, node, batches, batches)
    v = san.summary()["violations"]
    assert len(v) == 2 and all("bucket membership" in x for x in v)


def test_fuzzer_runs_armed_and_counts_violations():
    from daft_tpu_torch.analysis import plan_fuzzer
    os.environ.setdefault("DAFT_TORCH_DEVICE", "cpu")
    res = plan_fuzzer.run_fuzz(count=2, seed=3,
                               modes=("optimized", "spilled"))
    s = res.summary()
    assert s["seeds_run"] == 2 and s["sanitizer_violations"] == 0
    assert not p_plan.is_enabled()   # the run disarmed what it armed


# --------------------------------------------------- observability blocks

def test_sanitizer_and_plansan_blocks_render_the_reference_text():
    from daft_tpu import observability as r_obs
    lock = {"acquisitions": 9, "contended": 2, "blocking_while_held": 1,
            "graph_locks": 4, "graph_edges": 3, "graph_cycles": 1}
    plan = {"rule_checks": 13, "membership_parts": 4,
            "membership_rows": 100, "order_parts": 2,
            "conservation_checks": 5, "violations": 1,
            "total_violations": 3}
    assert p_obs.render_sanitizer_block(lock) \
        == r_obs.render_sanitizer_block(lock)
    assert p_obs.render_plansan_block(plan) \
        == r_obs.render_plansan_block(plan)
    assert p_obs.render_sanitizer_block({}) == []
    assert p_obs.render_plansan_block({}) == []


def test_retrace_block_renders_the_port_counters():
    """The reference's block reads trace and compile events; the port's
    counts new device memory and kernel launches under the same header
    and the same violation line."""
    from daft_tpu import observability as r_obs
    assert p_obs.render_retrace_block({}) == []
    lines = p_obs.render_retrace_block(
        {"events": 3, "segments": 4, "pinned": 1, "launches": 12,
         "unscoped_events": 1, "violations": 1, "total_violations": 4})
    ref = r_obs.render_retrace_block(
        {"traces": 3, "compiles": 2, "compile_seconds": 1.25,
         "unscoped_traces": 1, "violations": 1, "total_violations": 4})
    assert lines[0] == ref[0]
    assert lines[2] == ref[2] and "RETRACE TAX" in lines[2]
    assert "3 allocating events (4 new segments, 1 new pinned blocks)" \
        in lines[1] and "12 kernel launches" in lines[1]


def test_flight_entry_and_render_carry_the_blocks():
    ctx = p_obs.RuntimeStatsContext()
    ctx.finish()
    assert ctx.sanitizer == {} and ctx.retrace == {} and ctx.plansan == {}
    ctx.sanitizer = {"acquisitions": 1.0, "graph_cycles": 0}
    ctx.retrace = {"events": 1.0, "launches": 2.0}
    ctx.plansan = {"rule_checks": 5.0}
    entry = p_obs.flight_entry(ctx)
    assert entry["retrace"] == {"events": 1.0, "launches": 2.0}
    assert entry["plansan"] == {"rule_checks": 5.0}
    assert entry["sanitizer"]["acquisitions"] == 1.0
    out = ctx.render()
    assert "concurrency (lock sanitizer):" in out
    assert "shape discipline (retrace sanitizer):" in out
    assert "plan discipline (plan sanitizer):" in out


def test_metrics_carry_the_sanitizer_planes_and_parse_strictly(monkeypatch):
    import urllib.request

    from daft_tpu_torch import dashboard, tracing
    monkeypatch.setattr(p_plan, "_global", p_plan.PlanSanitizer())
    monkeypatch.setattr(p_plan, "_enabled", True)
    monkeypatch.setattr(p_retrace, "_global", p_retrace.RetraceSanitizer())
    monkeypatch.setattr(p_retrace, "_enabled", True)
    p_plan.sanitizer().check_rule("PushDownFilter",
                                  daft_tpu_torch.from_pydict(
                                      {"x": [1]}).schema(),
                                  daft_tpu_torch.from_pydict(
                                      {"x": [1]}).schema())
    text = tracing.prometheus_text()
    assert "daft_torch_plansan_rule_checks_total 1" in text
    assert "daft_torch_retrace_violations_total 0" in text
    tracing.parse_prometheus_text(text)
    port = dashboard.launch(0)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as r:
            served = r.read().decode()
    finally:
        dashboard.shutdown()
    parsed = tracing.parse_prometheus_text(served)
    assert any("plansan" in str(k) for k in parsed)


# ---------------------------------------------------- armed, end to end

_ARMED = r'''
import json, os, sys
root = sys.argv[1]
from benchmarking.tpch.datagen import generate_tpch
generate_tpch(root, scale_factor=0.003, num_parts=3)
import daft_tpu_torch as dt
from daft_tpu_torch import col
from daft_tpu_torch import observability as obs
from daft_tpu_torch.analysis import (lock_sanitizer, plan_sanitizer,
                                     retrace_sanitizer)
from daft_tpu_torch.benchmarking import tpch_queries as Q
from daft_tpu_torch.context import execution_config_ctx
from daft_tpu_torch.execution import memory

def get(t):
    return dt.read_parquet(f"{root}/{t}/*.parquet")

def run_all():
    out = {}
    out["q1"] = Q.q1(get).to_pydict()
    out["q3"] = Q.q3(get).to_pydict()
    import numpy as np
    rng = np.random.default_rng(1)
    k = [int(x) for x in rng.integers(0, 10_000, 30_000)]
    os.environ["DAFT_TORCH_MEMORY_LIMIT"] = "400KB"
    try:
        out["spilled_join"] = (
            dt.from_pydict({"k": k, "v": list(range(30_000))})
            .join(dt.from_pydict({"k": k[:15_000],
                                  "w": list(range(15_000))}),
                  on="k", strategy="hash")
            .groupby("k").agg(col("w").sum().alias("w"),
                              col("v").count().alias("n"))
            .to_pydict())
    finally:
        del os.environ["DAFT_TORCH_MEMORY_LIMIT"]
    left = dt.from_pydict({"k": list(range(256)),
                           "v": [float(i) for i in range(256)]})
    right = dt.from_pydict({"rk": list(range(0, 256, 2)),
                            "w": list(range(128))})
    with execution_config_ctx(broadcast_join_size_bytes_threshold=1):
        out["partitioned_join_sort"] = (
            left.into_partitions(4).join(right.into_partitions(4),
                                         left_on="k", right_on="rk")
            .sort("k").to_pydict())
    return out

answers = run_all()
render = obs.last_query_stats().render()
print("RESULT " + json.dumps({
    "answers": answers,
    "armed": [lock_sanitizer.is_enabled(), plan_sanitizer.is_enabled(),
              retrace_sanitizer.is_enabled()],
    "lock": lock_sanitizer.summary(),
    "lock_sites": sorted(lock_sanitizer.sanitizer()._sites),
    "plan": plan_sanitizer.summary(),
    "retrace": retrace_sanitizer.summary(),
    "spill": memory.spill_counters_snapshot(),
    "render": render,
    "jax": "jax" in sys.modules,
    "reference": any(m == "daft_tpu" or m.startswith("daft_tpu.")
                     for m in sys.modules),
}, default=str))
'''


def _close(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-12)
    return a == b


def _same_answer(got: dict, want: dict) -> bool:
    if sorted(got) != sorted(want):
        return False
    cols = sorted(want)
    rows_g = sorted(zip(*(got[c] for c in cols)), key=repr)
    rows_w = sorted(zip(*(want[c] for c in cols)), key=repr)
    return len(rows_g) == len(rows_w) and all(
        all(_close(x, y) for x, y in zip(rg, rw))
        for rg, rw in zip(rows_g, rows_w))


def test_armed_end_to_end_matches_the_unarmed_answers(tmp_path,
                                                      monkeypatch):
    env = dict(os.environ, DAFT_TORCH_SANITIZE="1",
               DAFT_TORCH_SANITIZE_PLAN="1", DAFT_TORCH_SANITIZE_RETRACE="1",
               DAFT_TORCH_DEVICE="cpu", PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _ARMED, str(tmp_path / "d")],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = next(x for x in r.stdout.splitlines() if x.startswith("RESULT "))
    res = json.loads(line[len("RESULT "):])
    assert res["armed"] == [True, True, True]
    assert res["jax"] is False and res["reference"] is False
    lock, plan, retrace = res["lock"], res["plan"], res["retrace"]
    # engine locks tracked (the push engine's channels among them), no
    # cycle, and the checks really ran
    assert lock["locks"] > 0 and lock["acquisitions"] > 0
    sites = res["lock_sites"]
    assert any(x.startswith("daft_tpu_torch/execution/pipeline.py:")
               for x in sites), sites
    assert all(x.startswith("daft_tpu_torch/") for x in sites), sites
    assert lock["cycles"] == []
    assert plan["violations"] == []
    assert plan["rule_checks"] > 0 and plan["order_parts"] > 0
    assert plan["membership_parts"] > 0 and plan["conservation_checks"] > 0
    assert retrace["violations"] == []
    assert retrace["site_entries"], retrace
    assert res["spill"].get("joins_partitioned", 0) > 0
    for block in ("concurrency (lock sanitizer):",
                  "shape discipline (retrace sanitizer):",
                  "plan discipline (plan sanitizer):"):
        assert block in res["render"], res["render"]

    # the unarmed answers, in this (unarmed) process
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    sys.path.insert(0, REPO)
    try:
        ns = {}
        prog = _ARMED.split("answers = run_all()")[0]
        prog = prog.replace("generate_tpch(root, scale_factor=0.003, "
                            "num_parts=3)", "")
        prog = prog.replace("root = sys.argv[1]", "root = None")
        exec(compile(prog, "unarmed", "exec"), ns)  # noqa: S102
        ns["root"] = str(tmp_path / "d")
        # the same JSON round trip the armed answers took (dates as text)
        want = json.loads(json.dumps(ns["run_all"](), default=str))
    finally:
        sys.path.remove(REPO)
    for q, got in res["answers"].items():
        assert _same_answer(got, want[q]), q

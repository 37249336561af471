"""daft-lint over the port (``daft_tpu_torch/analysis``) against the
reference's (``daft_tpu/analysis``).

- Rule parity, one family at a time: the reference's fixtures from
  ``tests/test_analysis.py`` run through the reference rule with the module
  under ``daft_tpu/`` and through the port's rule with the same source under
  ``daft_tpu_torch/``; the rule ids and lines must be equal. The knob
  fixtures swap each reference knob for a port knob of the same type.
- The port's analogues (``rule_launch``, ``rule_shapes``,
  ``rule_donation``) and its own resource contracts have fixtures of their
  own: one that fires and one that is clean.
- The port's tier-1 gate: the linter is clean on the port's tree with the
  baseline empty, and its CLI imports neither ``jax`` nor ``daft_tpu``.
"""

import ast
import json
import os
import subprocess
import sys

import pytest

from daft_tpu.analysis import dataflow as r_dataflow
from daft_tpu.analysis import framework as r_fw
from daft_tpu.analysis import (rule_attribution as r_attribution,
                               rule_cancellation as r_cancellation,
                               rule_knobs as r_knobs, rule_locks as r_locks,
                               rule_plans as r_plans,
                               rule_resources as r_resources)
from daft_tpu_torch import knobs as p_knobs_registry
from daft_tpu_torch.analysis import dataflow as p_dataflow
from daft_tpu_torch.analysis import dispatch_registry as p_registry
from daft_tpu_torch.analysis import framework as p_fw
from daft_tpu_torch.analysis import plan_contracts as p_contracts
from daft_tpu_torch.analysis import (rule_attribution as p_attribution,
                                     rule_cancellation as p_cancellation,
                                     rule_donation as p_donation,
                                     rule_knobs as p_knobs,
                                     rule_launch as p_launch,
                                     rule_locks as p_locks,
                                     rule_plans as p_plans,
                                     rule_resources as p_resources,
                                     rule_shapes as p_shapes)

REPO = p_fw.repo_root()

# fixture literals are split so this file's own text never reads as a knob
# mention or a pragma to the repo-wide scans (both linters scan tests/)
PRAGMA = "# daft-" + "lint: "
REF_BOGUS = "DAFT_TPU_" + "BOGUS"
PORT_BOGUS = "DAFT_TORCH_" + "BOGUS"

#: reference knob → a port knob of the same registered type
KNOB_MAP = {
    "DAFT_TPU_MAX_RETRIES": "DAFT_TORCH_FUZZ_COUNT",              # int
    "DAFT_TPU_SHUFFLE_COMPRESSION": "DAFT_TORCH_SPILL_COMPRESSION",  # str
    REF_BOGUS: PORT_BOGUS,
    "from daft_tpu.analysis import knobs": "from daft_tpu_torch import knobs",
}

#: findings that describe the whole (one-file) tree, not a fixture's lines
_TREE_WIDE = ("knob-unused", "knob-config-drift", "plan-node-stale",
              "plan-rule-stale", "dispatch-site-stale")


def _port_code(code: str) -> str:
    for a, b in KNOB_MAP.items():
        code = code.replace(a, b)
    return code


def _write(root, rel: str, code: str) -> None:
    p = root / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(code)


def _pair(tmp_path, rel: str, code: str, ref_mod, port_mod):
    """(reference findings, port findings) of one fixture as sorted
    ``(rule, line)`` lists, the port's source with its knobs mapped."""
    _write(tmp_path / "ref", f"daft_tpu/{rel}", code)
    _write(tmp_path / "port", f"daft_tpu_torch/{rel}", _port_code(code))
    rs = r_fw.walk_sources(str(tmp_path / "ref"), ("daft_tpu",))
    ps = p_fw.walk_sources(str(tmp_path / "port"), ("daft_tpu_torch",))
    ref = sorted((f.rule, f.line) for f in ref_mod.check(rs)
                 if f.rule not in _TREE_WIDE)
    port = sorted((f.rule, f.line) for f in port_mod.check(ps)
                  if f.rule not in _TREE_WIDE)
    return ref, port


def _pair_full(tmp_path, rel: str, code: str):
    """The same through each package's whole ``run_analysis`` (pragmas and
    their suppression included), restricted to the fixture's file."""
    _write(tmp_path / "ref", f"daft_tpu/{rel}", code)
    _write(tmp_path / "port", f"daft_tpu_torch/{rel}", _port_code(code))
    ref = r_fw.run_analysis(str(tmp_path / "ref"), subdirs=("daft_tpu",),
                            contracts=False, readme=False, baseline=[])
    port = p_fw.run_analysis(str(tmp_path / "port"),
                             subdirs=("daft_tpu_torch",), contracts=False,
                             readme=False, baseline=[])
    return (sorted((f.rule, f.line) for f in ref
                   if f.path == f"daft_tpu/{rel}"),
            sorted((f.rule, f.line) for f in port
                   if f.path == f"daft_tpu_torch/{rel}"))


# --------------------------------------------------- reference fixtures
# (case id, module path under the package, source, family, the rule the
# fixture is about, whether it fires)

_F = "foo.py"
_EX = "execution/executor.py"
_PL = "execution/pipeline.py"

CASES = [
    # ---- knobs
    ("knob-unregistered", _F,
     f'import os\nv = os.environ.get("{REF_BOGUS}")\n',
     "knobs", "knob-unregistered", True),
    ("knob-direct-read", _F,
     'import os\nv = os.environ["DAFT_TPU_MAX_RETRIES"]\n',
     "knobs", "knob-direct-read", True),
    ("knob-type-mismatch", _F,
     'from daft_tpu.analysis import knobs\n'
     'v = knobs.env_int("DAFT_TPU_SHUFFLE_COMPRESSION")\n',
     "knobs", "knob-type-mismatch", True),
    ("knob-correct-accessors", _F,
     'from daft_tpu.analysis import knobs\n'
     'v = knobs.env_int("DAFT_TPU_MAX_RETRIES")\n'
     'w = knobs.env_str("DAFT_TPU_SHUFFLE_COMPRESSION")\n',
     "knobs", "knob-type-mismatch", False),
    ("knob-env-write", _F,
     'import os\nos.environ["DAFT_TPU_MAX_RETRIES"] = "5"\n',
     "knobs", "knob-direct-read", False),
    # ---- locks
    ("sleep-under-lock", _F,
     "import threading, time\n_lock = threading.Lock()\n"
     "def f():\n"
     "    with _lock:\n"
     "        time.sleep(1)\n",
     "locks", "blocking-under-lock", True),
    ("blocking-helper-under-lock", _F,
     "import threading\n_lock = threading.Lock()\n"
     "def helper(p):\n"
     "    with open(p) as f:\n"
     "        return f.read()\n"
     "def f(p):\n"
     "    with _lock:\n"
     "        return helper(p)\n",
     "locks", "blocking-under-lock", True),
    ("string-join-under-lock", _F,
     "import threading, os\n_lock = threading.Lock()\n"
     "def f(parts):\n"
     "    with _lock:\n"
     "        return ', '.join(parts) + os.path.join('a', 'b')\n",
     "locks", "blocking-under-lock", False),
    ("unguarded-global-rebind", _F,
     "_POOL = None\n"
     "def pool():\n"
     "    global _POOL\n"
     "    if _POOL is None:\n"
     "        _POOL = object()\n"
     "    return _POOL\n",
     "locks", "unguarded-global-mutation", True),
    ("guarded-global-rebind", _F,
     "import threading\n_POOL = None\n_lock = threading.Lock()\n"
     "def pool():\n"
     "    global _POOL\n"
     "    with _lock:\n"
     "        if _POOL is None:\n"
     "            _POOL = object()\n"
     "        return _POOL\n",
     "locks", "unguarded-global-mutation", False),
    # ---- resources
    ("admission-leak-exception-edge", _F,
     "def run(self, est):\n"
     "    self.mem.acquire(est)\n"
     "    do_work(est)\n"
     "    self.mem.release(est)\n",
     "resources", "memory-admission-leak", True),
    ("admission-try-finally", _F,
     "def run(self, est):\n"
     "    self.mem.acquire(est)\n"
     "    try:\n"
     "        return do_work(est)\n"
     "    finally:\n"
     "        self.mem.release(est)\n",
     "resources", "memory-admission-leak", False),
    ("admission-helper-summary", _F,
     "def _done(self, est):\n"
     "    self.mem.release(est)\n"
     "\n"
     "def run(self, est):\n"
     "    self.mem.acquire(est)\n"
     "    try:\n"
     "        return do_work(est)\n"
     "    finally:\n"
     "        self._done(est)\n",
     "resources", "memory-admission-leak", False),
    ("admission-helper-may-not-release", _F,
     "def _done(self, est):\n"
     "    if maybe():\n"
     "        self.mem.release(est)\n"
     "\n"
     "def run(self, est):\n"
     "    self.mem.acquire(est)\n"
     "    try:\n"
     "        return do_work(est)\n"
     "    finally:\n"
     "        self._done(est)\n",
     "resources", "memory-admission-leak", True),
    ("admission-conditional-try-acquire", _F,
     "def run(self, est):\n"
     "    if not self.admission.try_acquire(est):\n"
     "        return None\n"
     "    try:\n"
     "        return do_work(est)\n"
     "    finally:\n"
     "        self.admission.release(est)\n",
     "resources", "memory-admission-leak", False),
    ("device-slot-transfer-or-release", _F,
     "def submit(gate, seq, mem, rb):\n"
     "    slot = acquire_slot(gate, seq, mem, 100)\n"
     "    try:\n"
     "        tok = dispatch(rb)\n"
     "    except BaseException:\n"
     "        release_slot(slot)\n"
     "        raise\n"
     "    if tok is None:\n"
     "        release_slot(slot)\n"
     "        return host(rb)\n"
     "    return InflightItem(slot, tok)\n",
     "resources", "device-slot-leak", False),
    ("device-slot-decline-path", _F,
     "def submit(gate, seq, mem, rb):\n"
     "    slot = acquire_slot(gate, seq, mem, 100)\n"
     "    tok = dispatch(rb)\n"
     "    if tok is None:\n"
     "        return host(rb)\n"
     "    return InflightItem(slot, tok)\n",
     "resources", "device-slot-leak", True),
    ("trace-recorder-exception-path", _F,
     "def run(builder):\n"
     "    tctx = tracing.maybe_start_trace('q')\n"
     "    plan = builder.optimize()\n"
     "    return execute(plan)\n",
     "resources", "trace-recorder-leak", True),
    ("trace-recorder-abort", "bar.py",
     "def run(builder):\n"
     "    tctx = tracing.maybe_start_trace('q')\n"
     "    try:\n"
     "        plan = builder.optimize()\n"
     "        it = execute(plan)\n"
     "    except BaseException:\n"
     "        tracing.abort_trace(tctx)\n"
     "        raise\n"
     "    yield from it\n",
     "resources", "trace-recorder-leak", False),
    ("recorder-registration-leak", _F,
     "def run(rec):\n"
     "    tracing.register_recorder(rec)\n"
     "    work(rec)\n"
     "    tracing.unregister_recorder(rec.trace_id)\n",
     "resources", "recorder-registration-leak", True),
    ("pool-with-and-attr-escape", _F,
     "def a(xs):\n"
     "    with ThreadPoolExecutor(4) as pool:\n"
     "        return [f.result() for f in map(pool.submit, xs)]\n"
     "\n"
     "def b(self):\n"
     "    self._pool = ThreadPoolExecutor(4)\n",
     "resources", "pool-leak", False),
    ("local-pool-without-shutdown", _F,
     "def a(xs):\n"
     "    pool = ThreadPoolExecutor(4)\n"
     "    return pool.submit(work).result()\n",
     "resources", "pool-leak", True),
    ("spill-store-leak", _F,
     "def run(stream, n):\n"
     "    store = PartitionedSpillStore(n)\n"
     "    for mp in stream:\n"
     "        store.push(mp)\n"
     "    store.close()\n",
     "resources", "spill-store-leak", True),
    ("spill-store-with", _F,
     "def run(stream, n):\n"
     "    with PartitionedSpillStore(n) as store:\n"
     "        for mp in stream:\n"
     "            store.push(mp)\n",
     "resources", "spill-store-leak", False),
    ("spill-writer-group-leak", _F,
     "def run(tables, budget):\n"
     "    io = SpillWriterGroup(budget)\n"
     "    for t in tables:\n"
     "        io.submit(t)\n"
     "    io.drain()\n",
     "resources", "spill-writer-pool-leak", True),
    ("scope-helper-outside-with", _F,
     "def run(tok, stats):\n"
     "    cancel_scope(tok)\n"
     "    with obs.attributed(stats):\n"
     "        pass\n",
     "resources", "scope-helper-not-with", True),
    ("scope-helper-assigned-then-entered", _F,
     "def run():\n"
     "    sp = tracing.span('scan', key='k')\n"
     "    with sp:\n"
     "        pass\n",
     "resources", "scope-helper-not-with", False),
    # ---- cancellation
    ("uncancellable-drain-loop", _EX,
     "def consume(self, stream):\n"
     "    out = []\n"
     "    for mp in stream:\n"
     "        out.append(mp)\n"
     "    return out\n",
     "cancellation", "uncancellable-loop", True),
    ("polled-drain-loop", _EX,
     "def consume(self, stream):\n"
     "    out = []\n"
     "    for mp in stream:\n"
     "        self._poll_cancel()\n"
     "        out.append(mp)\n"
     "    return out\n",
     "cancellation", "uncancellable-loop", False),
    ("yielding-loop", _EX,
     "def passthrough(self, stream):\n"
     "    for mp in stream:\n"
     "        yield transform(mp)\n",
     "cancellation", "uncancellable-loop", False),
    ("channel-put-loop", _PL,
     "def dispatch(self, child, out):\n"
     "    for mp in child:\n"
     "        out.put(mp)\n",
     "cancellation", "uncancellable-loop", False),
    ("loop-checking-via-helper", _EX,
     "def _poll(self):\n"
     "    tok = self.cancel_token\n"
     "    if tok is not None:\n"
     "        tok.check()\n"
     "\n"
     "def consume(self, stream):\n"
     "    for mp in stream:\n"
     "        self._poll()\n"
     "        use(mp)\n",
     "cancellation", "uncancellable-loop", False),
    ("out-of-scope-module-loop", "io/readers.py",
     "def consume(stream):\n"
     "    return [mp for mp in stream]\n",
     "cancellation", "uncancellable-loop", False),
    ("nested-def-in-loop-body", _EX,
     "def consume(self, stream, q):\n"
     "    cbs = []\n"
     "    for mp in stream:\n"
     "        def cb(mp=mp):\n"
     "            q.put(mp)\n"
     "        cbs.append(cb)\n"
     "    return cbs\n",
     "cancellation", "uncancellable-loop", True),
    # ---- attribution
    ("unwrapped-pool-submit", _EX,
     "def fan(pool, fn, xs):\n"
     "    return [pool.submit(fn, x) for x in xs]\n",
     "attribution", "unattributed-worker", True),
    ("wrapped-pool-submit", _EX,
     "def fan(pool, fn, xs):\n"
     "    return [pool.submit(obs.run_attributed,\n"
     "                        obs.current_attribution(), fn, x)\n"
     "            for x in xs]\n",
     "attribution", "unattributed-worker", False),
    ("thread-target-installing-attribution", _PL,
     "def _guard(self, fn):\n"
     "    with obs.attributed(self.stats_ctx):\n"
     "        fn()\n"
     "\n"
     "def spawn(self, fn, name):\n"
     "    t = threading.Thread(target=self._guard, args=(fn,),\n"
     "                         name=name, daemon=True)\n"
     "    t.start()\n",
     "attribution", "unattributed-worker", False),
    ("bare-thread-target", _PL,
     "def _loop(self):\n"
     "    while True:\n"
     "        self._step()\n"
     "\n"
     "def start(self):\n"
     "    threading.Thread(target=self._loop, daemon=True).start()\n",
     "attribution", "unattributed-worker", True),
    ("foreign-bound-method-target", _PL,
     "def start(self, server):\n"
     "    threading.Thread(target=server.serve_forever,\n"
     "                     daemon=True).start()\n",
     "attribution", "unattributed-worker", False),
    ("attribution-out-of-scope-module", "io/readers.py",
     "def fan(pool, fn, xs):\n"
     "    return [pool.submit(fn, x) for x in xs]\n",
     "attribution", "unattributed-worker", False),
]

_MODS = {
    "knobs": (r_knobs, p_knobs), "locks": (r_locks, p_locks),
    "resources": (r_resources, p_resources),
    "cancellation": (r_cancellation, p_cancellation),
    "attribution": (r_attribution, p_attribution),
}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_rule_parity_with_the_reference(tmp_path, case):
    _, rel, code, family, rule, fires = case
    ref, port = _pair(tmp_path, rel, code, *_MODS[family])
    assert port == ref
    assert any(r == rule for r, _ in port) == fires, port


# ------------------------------------------- pragmas, through run_analysis

PRAGMA_CASES = [
    ("with-reason-suppresses", _F,
     'import os\n'
     'v = os.environ.get("DAFT_TPU_MAX_RETRIES")  '
     + PRAGMA + 'allow(knob-direct-read) -- bootstrap read\n',
     {"knob-direct-read": False, "pragma-missing-reason": False}),
    ("without-reason-is-a-finding", _F,
     'import os\n'
     'v = os.environ.get("DAFT_TPU_MAX_RETRIES")  '
     + PRAGMA + 'allow(knob-direct-read)\n',
     {"knob-direct-read": True, "pragma-missing-reason": True}),
    ("unknown-rule", _F,
     "x = 1  " + PRAGMA + "allow(no-such-" + "rule) -- stale\n",
     {"pragma-unknown-rule": True}),
    ("live-rule", _F,
     "import os\n"
     "v = os.environ.get('DAFT_TPU_MAX_RETRIES')  "
     + PRAGMA + "allow(knob-direct-read) -- bootstrap\n",
     {"pragma-unknown-rule": False}),
    ("admission-leak-suppressed", _F,
     "def run(self, est):\n"
     "    " + PRAGMA + "allow(memory-admission-leak) -- test dummy\n"
     "    self.mem.acquire(est)\n"
     "    do_work(est)\n"
     "    self.mem.release(est)\n",
     {"memory-admission-leak": False}),
    ("device-slot-suppressed", _F,
     "def submit(gate, seq, mem, rb):\n"
     "    " + PRAGMA + "allow(device-slot-leak) -- fixture reason\n"
     "    slot = acquire_slot(gate, seq, mem, 100)\n"
     "    return dispatch(rb)\n",
     {"device-slot-leak": False}),
    ("cancellation-suppressed", _EX,
     "def consume(self, stream):\n"
     "    " + PRAGMA + "allow(uncancellable-loop) -- iterator polls\n"
     "    for mp in stream:\n"
     "        use(mp)\n",
     {"uncancellable-loop": False}),
    ("multi-line-reason", _F,
     "import threading, time\n_lock = threading.Lock()\n"
     "def f():\n"
     "    with _lock:\n"
     "        " + PRAGMA + "allow(blocking-under-lock) -- a reason\n"
     "        # that runs on for a second line\n"
     "        time.sleep(1)\n",
     {"blocking-under-lock": False}),
]


@pytest.mark.parametrize("case", PRAGMA_CASES,
                         ids=[c[0] for c in PRAGMA_CASES])
def test_pragma_parity_with_the_reference(tmp_path, case):
    _, rel, code, expect = case
    ref, port = _pair_full(tmp_path, rel, code)
    assert port == ref
    rules = {r for r, _ in port}
    for rule, present in expect.items():
        assert (rule in rules) == present, (rule, port)


# ------------------------------------------------------------ the CFGs

CFG_CASES = [
    ("finally-credits-exception-paths",
     "def f(self, est):\n"
     "    self.mem.acquire(est)\n"
     "    try:\n"
     "        return work(est)\n"
     "    finally:\n"
     "        self.mem.release(est)\n", "release", "after-first", False),
    ("exception-edge-escapes-without-finally",
     "def f(self, est):\n"
     "    self.mem.acquire(est)\n"
     "    mid(est)\n"
     "    self.mem.release(est)\n", "release", "entry", False),
    ("except-baseexception-is-catch-all",
     "def f(x):\n"
     "    try:\n"
     "        work(x)\n"
     "    except BaseException:\n"
     "        stop(x)\n"
     "        raise\n"
     "    stop(x)\n", "stop", "entry", True),
    ("return-inside-with",
     "def f(x):\n"
     "    with lock:\n"
     "        if x:\n"
     "            return g(x)\n"
     "        h(x)\n"
     "    done(x)\n", "done", "entry", False),
    ("loop-break-continue",
     "def f(xs):\n"
     "    for x in xs:\n"
     "        try:\n"
     "            if x:\n"
     "                break\n"
     "            continue\n"
     "        finally:\n"
     "            done(x)\n"
     "    done(xs)\n", "done", "entry", False),
]


def _escape(dataflow, code, word, start, exc_only):
    fn = ast.parse(code).body[0]
    cfg = dataflow.CFG(fn)

    def credit(node):
        return node.stmt is not None and word in ast.unparse(node.stmt)

    if start == "entry":
        starts = [cfg.entry]
    else:
        starts = [t for n in cfg.nodes_for(fn.body[0])
                  for t, is_exc in n.succ if not is_exc]
    return (dataflow.find_escape(cfg, starts, credit, exc_only=exc_only),
            dataflow.hits_on_all_paths(cfg, credit),
            len(cfg.nodes))


@pytest.mark.parametrize("case", CFG_CASES, ids=[c[0] for c in CFG_CASES])
def test_cfg_parity_with_the_reference(case):
    _, code, word, start, exc_only = case
    assert _escape(p_dataflow, code, word, start, exc_only) \
        == _escape(r_dataflow, code, word, start, exc_only)


def test_cfg_cases_say_what_the_reference_tests_say():
    fin = _escape(p_dataflow, *CFG_CASES[0][1:])
    assert fin[0] is None
    assert not _escape(p_dataflow, *CFG_CASES[1][1:])[1]
    assert _escape(p_dataflow, *CFG_CASES[2][1:])[0] is None


# ---------------------------------------- the port's own contracts

PORT_CASES = [
    ("pinned-fetch-leak", "device/runtime.py",
     "def run(planes):\n"
     "    f = dcol.fetch_host_async(planes)\n"
     "    decode(planes)\n"
     "    return f.wait()\n",
     p_resources, "pinned-fetch-leak", True),
    ("pinned-fetch-handed-off", "device/runtime.py",
     "def run(tok, planes):\n"
     "    f = dcol.fetch_host_async(planes)\n"
     "    tok.fetch = f\n"
     "    return tok\n",
     p_resources, "pinned-fetch-leak", False),
    ("profile-capture-leak", "execution/executor.py",
     "def run(self, stats, plan):\n"
     "    capture = obs.profile_capture(self.device)\n"
     "    try:\n"
     "        it.close()\n"
     "        obs.end_query(stats, capture)\n"
     "    except ValueError:\n"
     "        pass\n",
     p_resources, "profile-capture-leak", True),
    ("profile-capture-nested-finally", "execution/executor.py",
     "def run(self, stats, it):\n"
     "    capture = obs.profile_capture(self.device)\n"
     "    try:\n"
     "        drain(it)\n"
     "    finally:\n"
     "        try:\n"
     "            it.close()\n"
     "        finally:\n"
     "            obs.end_query(stats, capture)\n",
     p_resources, "profile-capture-leak", False),
    # ---- launch discipline
    ("entry-outside-binding", "device/hash_kernels.py",
     "def hash_agg_build_fast(lib, dev):\n"
     "    return lib.daft_hash_agg_build(dev)\n",
     p_launch, "dispatch-site-unregistered", True),
    ("entry-in-its-binding", "device/hash_kernels.py",
     "def hash_agg_build_cuda(lib, dev):\n"
     "    return lib.daft_hash_agg_build(dev)\n",
     p_launch, "dispatch-site-unregistered", False),
    ("undeclared-entry", "device/foo.py",
     "def go(lib):\n"
     "    return lib.daft_something_new()\n",
     p_launch, "dispatch-site-unregistered", True),
    ("compile-outside-cuda-build", "device/foo.py",
     "def build(cuda_build):\n"
     "    return cuda_build.compile_library([], 'x.so')\n",
     p_launch, "compile-site-unregistered", True),
    ("nvcc-outside-cuda-build", "device/foo.py",
     "import subprocess\n"
     "def build(src):\n"
     "    return subprocess.run(['nvcc', '-c', src])\n",
     p_launch, "compile-site-unregistered", True),
    ("binding-called-past-its-wrapper", "joins.py",
     "def match(code, live, T):\n"
     "    return jk.hash_join_build_cuda(code, live, T)\n",
     p_launch, "launch-wrapper-bypassed", True),
    ("binding-called-from-its-wrapper", "device/join_kernels.py",
     "def hash_join_build(code, live, T):\n"
     "    return hash_join_build_cuda(code, live, T)\n",
     p_launch, "launch-wrapper-bypassed", False),
    ("undeclared-retrace-site", "device/fragment.py",
     "def go(prog):\n"
     "    with retrace_sanitizer.dispatch_scope('fragment.nope', 1):\n"
     "        prog()\n",
     p_launch, "dispatch-site-unregistered", True),
    ("declared-retrace-site", "device/fragment.py",
     "def go(prog):\n"
     "    with retrace_sanitizer.dispatch_scope('fragment.region', 1):\n"
     "        prog()\n",
     p_launch, "dispatch-site-unregistered", False),
    # ---- shapes
    ("rowcount-into-device-tensor", "device/foo.py",
     "import torch\n"
     "def go(batch, dev):\n"
     "    n = len(batch)\n"
     "    return torch.zeros(n, device=dev)\n",
     p_shapes, "shape-unbucketed", True),
    ("bucketed-device-tensor", "device/foo.py",
     "import torch\n"
     "def go(batch, dev):\n"
     "    cap = dcol.bucket_capacity(len(batch))\n"
     "    return torch.zeros(cap, device=dev)\n",
     p_shapes, "shape-unbucketed", False),
    ("rowcount-into-out-cap", "joins.py",
     "def go(batch, prog):\n"
     "    return prog.run(out_cap=batch.num_rows)\n",
     p_shapes, "shape-unbucketed", True),
    ("taint-does-not-cross-calls", "device/foo.py",
     "def go(batch, prog):\n"
     "    g = count_groups(len(batch))\n"
     "    return prog.run(out_cap=g)\n",
     p_shapes, "shape-unbucketed", False),
    ("program-rebuilt-per-call", "device/foo.py",
     "def go(exprs, schema, batch):\n"
     "    c = compiler.compile_projection(exprs, schema)\n"
     "    return run(c, batch)\n",
     p_shapes, "program-not-memoized", True),
    ("program-memoized", "device/foo.py",
     "_cache = {}\n"
     "def go(exprs, schema, key):\n"
     "    hit = _cache.get(key)\n"
     "    if hit is not None:\n"
     "        return hit\n"
     "    c = compiler.compile_projection(exprs, schema)\n"
     "    _cache[key] = c\n"
     "    return c\n",
     p_shapes, "program-not-memoized", False),
    ("program-memoized-by-setdefault", "device/foo.py",
     "_cache = {}\n"
     "def go(exprs, schema, key):\n"
     "    if key in _cache:\n"
     "        return _cache[key]\n"
     "    c = compiler.compile_projection(exprs, schema)\n"
     "    prog = FusedAggProgram(c)\n"
     "    return _cache.setdefault(key, prog)\n",
     p_shapes, "program-not-memoized", False),
    # the fused agg's program before it was memoized: a registry written
    # on every call and never read, so every morsel compiled anew
    ("program-stored-never-read", "device/foo.py",
     "_seen = {}\n"
     "def go(exprs, schema, key):\n"
     "    c = compiler.compile_projection(exprs, schema)\n"
     "    prog = FusedAggProgram(c)\n"
     "    _seen[key] = prog\n"
     "    return prog\n",
     p_shapes, "program-not-memoized", True),
    ("program-cached-via-helper", "device/foo.py",
     "def go(exprs, schema, key):\n"
     "    c = compiler.compile_projection(exprs, schema)\n"
     "    prog = FusedRegionProgram(c)\n"
     "    return _cache_region(key, prog)\n",
     p_shapes, "program-not-memoized", False),
    # ---- kernel workspaces (the donation analogue)
    ("workspace-read-outside-layout", "device/hash_kernels.py",
     "import torch\n"
     "def build_cuda(code, dev, n):\n"
     "    ws = torch.empty(n, dtype=torch.uint8, device=dev)\n"
     "    cuda_build.launch(lib.daft_hash_agg_build, dev,\n"
     "                      code.data_ptr(), ws.data_ptr())\n"
     "    return ws[0:8]\n",
     p_donation, "kernel-workspace-read", True),
    ("workspace-read-before-launch", "device/join_kernels.py",
     "import torch\n"
     "def build_cuda(code, C, T):\n"
     "    lay = build_layout(C, T)\n"
     "    ws = torch.empty(lay.nbytes, device=code.device)\n"
     "    head = ws.sum()\n"
     "    cuda_build.launch(lib.daft_hash_join_build, code.device,\n"
     "                      ws.data_ptr())\n"
     "    return head\n",
     p_donation, "kernel-workspace-read", True),
    ("workspace-read-through-layout", "device/join_kernels.py",
     "import torch\n"
     "def build_cuda(code, C, T):\n"
     "    lay = build_layout(C, T)\n"
     "    ws = torch.empty(lay.nbytes, device=code.device)\n"
     "    cuda_build.launch(lib.daft_hash_join_build, code.device,\n"
     "                      ws.data_ptr(), lay.meta.ctypes.data)\n"
     "    tk = lay.offsets['tk']\n"
     "    return ws[tk:tk + T], workspace_views(ws, lay, T)\n",
     p_donation, "kernel-workspace-read", False),
    ("zeroed-buffer-out-of-scope", "device/join_kernels.py",
     "import torch\n"
     "def probe_cuda(code, W):\n"
     "    buf = torch.zeros(3 * W, device=code.device)\n"
     "    cuda_build.launch(lib.daft_hash_join_probe, code.device,\n"
     "                      buf.data_ptr())\n"
     "    return buf[:3 * W]\n",
     p_donation, "kernel-workspace-read", False),
]


@pytest.mark.parametrize("case", PORT_CASES, ids=[c[0] for c in PORT_CASES])
def test_port_rule_fixtures(tmp_path, case):
    _, rel, code, mod, rule, fires = case
    _write(tmp_path, f"daft_tpu_torch/{rel}", code)
    srcs = p_fw.walk_sources(str(tmp_path), ("daft_tpu_torch",))
    rules = [f.rule for f in mod.check(srcs) if f.rule not in _TREE_WIDE]
    assert (rule in rules) == fires, rules


def test_port_contracts_wait_for_their_resources():
    """ShuffleCache and the collective lease come with the distributed
    tier: the port's table leaves them out (and says so)."""
    rules = {c.rule for c in p_resources.CONTRACTS}
    assert "shuffle-cache-leak" not in rules
    assert "collective-lease-leak" not in rules
    assert {"pinned-fetch-leak", "profile-capture-leak",
            "spill-store-leak", "device-slot-leak"} <= rules
    assert "A7" in p_resources.__doc__


def test_plan_rule_parity_on_an_unregistered_node(tmp_path):
    code = ("class PhysicalPlan:\n    pass\n\n\n"
            "class Bogus(PhysicalPlan):\n"
            "    def __init__(self, child):\n"
            "        super().__init__([child], child.schema())\n"
            "        self.x = 1\n")
    ref, port = _pair(tmp_path, "physical/plan.py", code, r_plans, p_plans)
    assert port == ref == [("plan-node-unregistered", 5)]


def test_plan_rule_parity_on_a_registered_node(tmp_path):
    """The clean case: a declared node whose constructor assigns exactly
    its declared fields and inherits its child's schema."""
    code = ("class PhysicalPlan:\n    pass\n\n\n"
            "class Filter(PhysicalPlan):\n"
            "    def __init__(self, child, predicate):\n"
            "        super().__init__([child], child.schema())\n"
            "        self.predicate = predicate\n")
    ref, port = _pair(tmp_path, "physical/plan.py", code, r_plans, p_plans)
    assert port == ref == []


def test_plan_rule_flags_an_unregistered_optimizer_rule(tmp_path):
    code = "class Rule:\n    pass\n\n\nclass NovelRule(Rule):\n    pass\n"
    ref, port = _pair(tmp_path, "logical/optimizer.py", code, r_plans,
                      p_plans)
    assert port == ref == [("plan-rule-unregistered", 5)]


# --------------------------------------------------- the registries

def test_knob_registry_types_and_accessors(monkeypatch):
    for k in p_knobs_registry.REGISTRY.values():
        assert k.type in ("int", "float", "bool", "str", "bytes"), k
        assert k.group in p_knobs_registry.GROUPS
        assert k.name.startswith("DAFT_TORCH_")
    monkeypatch.setenv("DAFT_TORCH_FUZZ_COUNT", "7")
    assert p_knobs_registry.env_int("DAFT_TORCH_FUZZ_COUNT") == 7
    with pytest.raises(TypeError):
        p_knobs_registry.env_str("DAFT_TORCH_FUZZ_COUNT")
    with pytest.raises(KeyError):
        p_knobs_registry.env_raw(PORT_BOGUS)
    monkeypatch.setenv("DAFT_TORCH_QUERY_LOG_BYTES", "2KiB")
    assert p_knobs_registry.env_bytes("DAFT_TORCH_QUERY_LOG_BYTES") == 2048
    monkeypatch.delenv("DAFT_TORCH_QUERY_LOG_BYTES")
    assert p_knobs_registry.env_bytes(
        "DAFT_TORCH_QUERY_LOG_BYTES") == 16 << 20
    assert p_knobs_registry.env_bool("DAFT_TORCH_SANITIZE") is False


def test_every_port_knob_mentioned_is_registered():
    import re
    pat = re.compile(r"DAFT_TORCH_[A-Z0-9_]+")
    mentioned = set()
    for sf in p_fw.walk_sources(REPO, p_fw.DEFAULT_SUBDIRS):
        if sf.path != "tests/test_torch_analysis.py":
            mentioned.update(pat.findall(sf.text))
    with open(os.path.join(REPO, "README.md"), encoding="utf-8") as f:
        mentioned.update(pat.findall(f.read()))
    # a name ending in "_" is a family prefix in prose (`DAFT_TORCH_IO_*`)
    assert sorted(m for m in mentioned if not m.endswith("_")
                  and m not in p_knobs_registry.REGISTRY) == []


def test_readme_port_knob_tables_in_sync():
    from daft_tpu.analysis import knobs as r_registry
    with open(os.path.join(REPO, "README.md"), encoding="utf-8") as f:
        text = f.read()
    assert p_knobs_registry.readme_drift(text) == []
    # the reference's generated tables stay byte-identical
    assert r_registry.readme_drift(text) == []
    broken = text.replace("`DAFT_TORCH_FUZZ_COUNT`",
                          "`DAFT_TORCH_FUZZ_" + "CNT`", 1)
    assert p_knobs_registry.readme_drift(broken) != []


def test_dispatch_sites_resolve():
    for s in p_registry.SITES:
        assert os.path.exists(os.path.join(REPO, s.module)), s
        assert p_registry.enforced(s.id) != bool(s.exempt)
        assert s.signature and s.budget
        if s.entry is not None:
            assert s.entry in p_registry.BY_ENTRY
    kernels = {s.entry for s in p_registry.SITES if s.entry}
    assert kernels == {e.entry for e in p_registry.ENTRIES
                       if e.kind == "kernel"}
    assert not p_registry.enforced("nope")


def test_rule_contracts_cover_the_port_optimizer():
    from daft_tpu_torch.logical.optimizer import Optimizer
    for batch in Optimizer().batches:
        for rule in batch.rules:
            assert type(rule).__name__ in p_contracts.RULE_CONTRACTS


def test_replan_mutable_fields_registered():
    from daft_tpu_torch.physical import plan as pp
    for m in p_contracts.REPLAN_MUTABLE:
        assert hasattr(pp, m.cls), m
        assert m.field in p_contracts.REPLAN_MUTABLE_FIELDS
        c = p_contracts.PHYSICAL_NODES[m.cls]
        assert m.field in c.estimate_fields + c.late_fields


def _pwalk(plan):
    stack, out = [plan], []
    while stack:
        n = stack.pop()
        out.append(n)
        stack.extend(n.children)
    return out


def test_estimate_fields_declared_on_built_plans():
    import daft_tpu_torch as dt
    from daft_tpu_torch import col
    from daft_tpu_torch.context import execution_config_ctx
    from daft_tpu_torch.physical import plan as pp
    from daft_tpu_torch.physical.translate import translate
    df = dt.from_pydict({"k": [1, 2, 2, 3], "v": [1.0, 2.0, 3.0, 4.0]})
    plan = translate(df.groupby("k").agg(col("v").sum())
                     ._builder.optimize()._plan)
    aggs = [n for n in _pwalk(plan) if isinstance(n, pp.Aggregate)]
    assert aggs
    for a in aggs:
        assert "group_rows_est" in a.__dict__ and "group_ndv" in a.__dict__
    left = dt.from_pydict({"k": list(range(64)),
                           "v": [float(i) for i in range(64)]})
    right = dt.from_pydict({"rk": list(range(0, 64, 2)),
                            "w": list(range(32))})
    with execution_config_ctx(broadcast_join_size_bytes_threshold=1):
        q = left.into_partitions(4).join(right.into_partitions(4),
                                         left_on="k", right_on="rk")
        plan = translate(q._builder.optimize()._plan)
    joins = [n for n in _pwalk(plan) if isinstance(n, pp.HashJoin)]
    exchanges = [n for n in _pwalk(plan) if isinstance(n, pp.Exchange)]
    assert joins and exchanges
    for j in joins:
        assert "left_bytes_est" in j.__dict__
        assert "right_bytes_est" in j.__dict__
    for e in exchanges:
        assert "join_side" in e.__dict__


def test_fusion_contract_check_forms_regions():
    """The functional fusion check is not vacuous: each exemplar forms a
    region, and every region keeps its fallback's schema."""
    assert p_plans.check_fusion_contracts() == []


# ------------------------------------------------------- the tier-1 gate

def test_baseline_is_empty():
    assert p_fw.load_baseline() == []


def test_port_linter_clean_on_the_port_tree():
    """The counterpart of ``test_linter_clean_on_repo_tree``: every
    finding in the port fixed or pragma-justified, the baseline empty,
    the README's port knob tables generated, the CUDA registry honest."""
    findings = p_fw.run_analysis(REPO)
    assert [f.render() for f in findings] == []


def test_every_emitted_rule_is_registered():
    rules = p_fw.known_rules()
    for mod in (p_resources, p_donation, p_cancellation, p_attribution,
                p_launch, p_shapes, p_plans):
        for rid, (family, hint) in mod.RULE_IDS.items():
            assert rules[rid] == (family, hint)
    for rid, (family, hint) in rules.items():
        assert family and hint, rid


def test_default_scan_is_the_port_tree_only():
    paths = [sf.path for sf in p_fw.walk_sources(REPO)]
    assert paths and not any(p.startswith("daft_tpu/") for p in paths)
    assert "chip_smoke.py" in paths
    assert "tests/test_torch_analysis.py" in paths
    assert not any(p.startswith("tests/") and "test_torch_" not in p
                   for p in paths)


def _cli(*args, timeout=300):
    code = (
        "import sys\n"
        "from daft_tpu_torch.analysis.__main__ import main\n"
        f"rc = main({list(args)!r})\n"
        "print('MODULES', int('jax' in sys.modules), int(any(\n"
        "    m == 'daft_tpu' or m.startswith('daft_tpu.')\n"
        "    for m in sys.modules)))\n"
        "sys.exit(rc)\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DAFT_TORCH_")}
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_cli_clean_on_the_port_without_jax_or_the_reference():
    r = _cli("--stats")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "daft-lint: 0 finding(s)" in r.stdout
    assert "daft-lint stats: files=" in r.stdout
    assert "MODULES 0 0" in r.stdout


def test_cli_exit_codes_and_json(tmp_path):
    r = _cli("--rule", "no-such-rule")
    assert r.returncode == 2 and "unknown rule id" in r.stdout
    # one file of the tree: every other knob reads as unused → exit 1
    r = _cli("daft_tpu_torch/knobs.py", "--no-contracts", "--no-readme",
             "--json", "--rule", "knob-unused")
    assert r.returncode == 1
    data = json.loads(r.stdout[:r.stdout.rindex("]") + 1])
    assert data and data[0]["family"] == "knobs" and data[0]["hint"]


def test_cli_knob_docs_prints_every_group():
    r = _cli("--knob-docs")
    assert r.returncode == 0
    for g in p_knobs_registry.GROUPS:
        assert f"### {g}" in r.stdout


# ----------------------------------------- burn-down fix regressions

def test_capture_stops_when_closing_the_stream_raises(monkeypatch):
    """Found by ``profile-capture-leak``: an exception from closing the
    query's stream skipped ``end_query``, leaving the per-query profiler
    running (and every later query without its capture). Both executors
    now publish in a nested ``finally``."""
    import daft_tpu_torch as dt
    from daft_tpu_torch import observability as obs
    from daft_tpu_torch.execution import executor as ex_mod
    from daft_tpu_torch.execution import pipeline as pipe_mod
    ended = []
    monkeypatch.setattr(obs, "end_query",
                        lambda stats, capture: ended.append(stats))
    plan = dt.from_pydict({"x": [1, 2, 3]})._builder
    from daft_tpu_torch.physical.translate import translate
    phys = translate(plan.optimize()._plan)

    class Boom(Exception):
        pass

    def closing_raises(self, node):
        def gen():
            try:
                yield from []
            finally:
                raise Boom()
        return gen()

    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(ex_mod.LocalExecutor, "_exec", closing_raises)
    it = ex_mod.LocalExecutor(None).run(phys)
    with pytest.raises(Boom):
        list(it)
    assert len(ended) == 1

    def join_raises(self, timeout=5.0):
        raise Boom()

    monkeypatch.setattr(pipe_mod.PipelineContext, "join", join_raises)
    monkeypatch.setattr(pipe_mod.PushExecutor, "_exec",
                        lambda self, node: iter(()))
    it = pipe_mod.PushExecutor(None).run(phys)
    with pytest.raises(Boom):
        list(it)
    assert len(ended) == 2

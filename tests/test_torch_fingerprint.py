"""The port's plan fingerprints (``daft_tpu_torch/logical/fingerprint.py``)
against the reference's (``daft_tpu/logical/fingerprint.py``).

The 22 TPC-H DataFrame plans (SF 0.003 files read by both packages),
each with two literal sets: the queries' own, and every literal of the
built logical plan moved by one rule (integers +1, floats x1.5, dates a
day later, strings with a suffix) in both packages' plans alike. For
every plan:

- ``params`` (the bound-literal vector) and ``sources`` (per-file size and
  mtime) are equal;
- the same plans are uncacheable;
- the plans partition into the same classes of equal ``structure`` (the
  hashes themselves differ: each package hashes its own config repr and
  node reprs), the two literal sets of a query in one class.

Plus the uncacheable cases (an in-memory source, a write sink, a scan
with no file set, a UDF parameter, a remote object without a version)
and a remote object with one, and ``calibration.plan_token()``: an
active calibrated constant changes ``structure`` and leaves
``history_structure`` alone. All on the CPU (``DAFT_TORCH_DEVICE=cpu``).
"""

import datetime
import decimal
import http.server
import threading

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import daft_tpu
import daft_tpu_torch as dt
from benchmarking.tpch import queries as RQ
from benchmarking.tpch.datagen import generate_tpch
from daft_tpu.logical import fingerprint as r_fp
from daft_tpu_torch.benchmarking import tpch_queries as Q
from daft_tpu_torch.logical import fingerprint as p_fp

PKGS = {"ref": (daft_tpu, r_fp, RQ.ALL), "port": (dt, p_fp, Q.ALL)}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("DAFT_TORCH_CALIBRATION", raising=False)
    monkeypatch.delenv("DAFT_TPU_CALIBRATION", raising=False)


@pytest.fixture(scope="module")
def tpch_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_torch_fingerprint")
    generate_tpch(str(root), scale_factor=0.003, num_parts=3)
    return str(root)


def _moved(v):
    """The second literal set's value for ``v``."""
    if isinstance(v, bool) or v is None:
        return v
    if isinstance(v, int):
        return v + 1
    if isinstance(v, float):
        return v * 1.5
    if isinstance(v, datetime.datetime):
        return v + datetime.timedelta(seconds=1)
    if isinstance(v, datetime.date):
        return v + datetime.timedelta(days=1)
    if isinstance(v, str):
        return v + "~"
    if isinstance(v, decimal.Decimal):
        return v + 1
    if isinstance(v, (list, tuple)):
        return type(v)(_moved(x) for x in v)
    return v


def _move_literals(plan, expr_cls) -> None:
    """Move every ``lit`` of a built logical plan in place (the plan was
    built for this call alone)."""
    seen = set()

    def expr(e):
        if id(e) in seen:
            return
        seen.add(id(e))
        if e.op == "lit":
            e.params = (_moved(e.params[0]),) + tuple(e.params[1:])
            return
        for a in e.args:
            expr(a)
        for p in e.params:
            value(p)

    def value(v):
        if isinstance(v, expr_cls):
            expr(v)
        elif isinstance(v, (list, tuple)):
            for x in v:
                value(x)
        elif isinstance(v, dict):
            for x in v.values():
                value(x)

    def node(n):
        for k, v in vars(n).items():
            if k != "materialized_tasks":
                value(v)
        for c in n.children:
            node(c)

    node(plan)


def _fingerprints(root):
    """(query, literal set) → fingerprint, per package."""
    out = {}
    for side, (pkg, fp_mod, queries) in PKGS.items():
        cfg = pkg.get_context().execution_config
        get = lambda t, pkg=pkg: pkg.read_parquet(  # noqa: E731
            f"{root}/{t}/*.parquet")
        for q, fn in queries.items():
            for lits in ("own", "moved"):
                plan = fn(get)._builder.plan
                if lits == "moved":
                    _move_literals(plan, pkg.Expression)
                out[side, q, lits] = fp_mod.fingerprint(plan, cfg)
    return out


def test_tpch_fingerprints_equal_the_reference(tpch_root):
    fps = _fingerprints(tpch_root)
    keys = sorted({(q, lits) for _, q, lits in fps})
    assert len(keys) == 44
    for q, lits in keys:
        p, r = fps["port", q, lits], fps["ref", q, lits]
        assert (p is None) == (r is None), (q, lits)
        if p is None:
            continue
        assert p.params == r.params, (q, lits)
        assert p.sources == r.sources, (q, lits)
        assert p.history_structure == p.structure  # calibration off
    # the same partition into equal-structure classes
    for side in ("port", "ref"):
        classes = {}
        for q, lits in keys:
            f = fps[side, q, lits]
            if f is not None:
                classes.setdefault(f.structure, set()).add((q, lits))
        fps[side] = sorted(sorted(c) for c in classes.values())
    assert fps["port"] == fps["ref"]
    # each query's two literal sets share one class, and the sets differ
    for q in range(1, 23):
        own, moved = fps["port", q, "own"], fps["port", q, "moved"]
        assert own is not None, q
        assert own.structure == moved.structure, q
        if own.params:
            assert own.params != moved.params, q
            assert own.key != moved.key, q


def _uncacheable_plans(pkg, root):
    from importlib import import_module
    io_scan = import_module(pkg.__name__ + ".io.scan")
    lp = import_module(pkg.__name__ + ".logical.plan")
    li = pkg.read_parquet(f"{root}/lineitem/*.parquet")

    @pkg.udf(return_dtype=pkg.DataType.int64())
    def ident(s):
        return s.to_pylist()

    schema = li.schema()
    return {
        "in_memory": pkg.from_pydict({"a": [1]}).where(pkg.col("a") > 0)
        ._builder.plan,
        "sink": li._builder.table_write("parquet", f"{root}/out").plan,
        "no_file_set": lp.Source(
            scan_op=io_scan.GeneratorScanOperator(schema, [], "entries"),
            schema=schema),
        "udf": li.select(ident(pkg.col("l_orderkey")))._builder.plan,
    }


def test_uncacheable_cases_equal_the_reference(tpch_root):
    for side, (pkg, fp_mod, _) in PKGS.items():
        cfg = pkg.get_context().execution_config
        for name, plan in _uncacheable_plans(pkg, tpch_root).items():
            assert fp_mod.fingerprint(plan, cfg) is None, (side, name)


class _Versioned(http.server.BaseHTTPRequestHandler):
    """HEAD and ranged GET over one parquet object; ``etag`` None sends
    no version signal."""
    data = b""
    etag = None

    def log_message(self, *a):
        pass

    def _head(self, code, n):
        self.send_response(code)
        self.send_header("Content-Length", str(n))
        if self.etag:
            self.send_header("ETag", self.etag)
        self.end_headers()

    def do_HEAD(self):
        self._head(200, len(self.data))

    def do_GET(self):
        rng = self.headers.get("Range")
        if rng:
            a, b = rng.split("=")[1].split("-")
            chunk = self.data[int(a):min(int(b), len(self.data) - 1) + 1]
            self._head(206, len(chunk))
        else:
            chunk = self.data
            self._head(200, len(chunk))
        self.wfile.write(chunk)


@pytest.mark.parametrize("etag", [None, '"v1"'], ids=["no_version",
                                                       "etag"])
def test_remote_source_cacheable_only_with_a_version(etag):
    import io as _io
    buf = _io.BytesIO()
    pq.write_table(pa.table({"g": [1, 2, 3], "v": [1.0, 2.0, 3.0]}), buf)
    handler = type("H", (_Versioned,), {"data": buf.getvalue(),
                                        "etag": etag})
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_port}/p.parquet"
    try:
        got = {}
        for side, (pkg, fp_mod, _) in PKGS.items():
            plan = pkg.read_parquet(url).where(pkg.col("g") > 1) \
                ._builder.plan
            got[side] = fp_mod.fingerprint(
                plan, pkg.get_context().execution_config)
        if etag is None:
            assert got["port"] is None and got["ref"] is None
        else:
            assert got["port"] is not None and got["ref"] is not None
            assert got["port"].sources == got["ref"].sources
            assert got["port"].sources[0][1][0][1:] == (
                "http", len(buf.getvalue()), etag)
            assert got["port"].params == got["ref"].params
    finally:
        srv.shutdown()
        srv.server_close()


def test_plan_token_moves_structure_not_history(tpch_root, monkeypatch):
    from daft_tpu_torch.device import calibration
    plan = lambda: Q.ALL[6](  # noqa: E731
        lambda t: dt.read_parquet(f"{tpch_root}/{t}/*.parquet"))._builder.plan
    cfg = dt.get_context().execution_config
    before = p_fp.fingerprint(plan(), cfg)
    calibration.reset_for_tests()
    monkeypatch.setenv("DAFT_TORCH_CALIBRATION", "1")
    monkeypatch.setenv("DAFT_TORCH_CALIBRATION_MIN_SAMPLES", "1")
    monkeypatch.delenv("DAFT_TORCH_CALIBRATION_DIR", raising=False)
    monkeypatch.delenv("DAFT_TORCH_QUERY_LOG", raising=False)
    try:
        assert calibration.plan_token() == ""  # nothing active yet
        calibration.observe("DEV_AGG_BPS", 123e9)
        token = calibration.plan_token()
        assert token
        after = p_fp.fingerprint(plan(), cfg)
        assert after.structure != before.structure
        assert after.history_structure == before.history_structure
        assert after.params == before.params
        # a nudge within the quantization keeps the token
        calibration.observe("DEV_AGG_BPS", 123.1e9)
        assert calibration.plan_token() == token
    finally:
        calibration.reset_for_tests()

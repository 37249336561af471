"""SQL through the port (``daft_tpu_torch.sql``) against the reference.

1. All 22 TPC-H queries of ``benchmarking/tpch/sql_queries.ALL`` (the port
   keeps its own copy of the texts, ``daft_tpu_torch/benchmarking/
   tpch_sql.py``), on the device tier on CPU tensors with the per-operator
   row floor at 0: equal to ``daft_tpu.sql`` on JAX-CPU (floats at 1e-9,
   ``tests/test_tpch.py``) and to the port's DataFrame forms (floats at
   1e-6, ``tests/test_tpch_sql.py``, where the two forms write an
   expression differently). Data: SF 0.003, 3 files per table, seed 42.
2. Q15's ``revenue`` CTE runs once: one shared physical node with two
   consumers, lineitem scanned once.
3. Every test of ``tests/test_subquery.py``, ``tests/test_sql.py`` and
   ``tests/test_sql_statements.py`` replayed through both packages at once
   (:class:`Pair`): each call runs on the reference and on the port with
   the same arguments, every value that comes back is compared, and the
   original assertions then run on the reference's values. The port's
   file-system catalog writes a warehouse of its own beside the
   reference's. Where the port raises ``NotImplementedError`` naming a
   ROADMAP item, the rest of that test runs on the reference only, and the
   test asserts the message names the item.
"""

import ast
import datetime
import decimal
import importlib
import math
import os
import re
import sys

import pytest

import daft_tpu
from benchmarking.tpch import sql_queries as RSQ
from benchmarking.tpch.datagen import generate_tpch

REL = 1e-9
REL_DF = 1e-6
TESTS = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def tpch_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_torch_sql")
    generate_tpch(str(root), scale_factor=0.003, num_parts=3)
    return str(root)


def _reader(pkg, root):
    return lambda t: pkg.read_parquet(f"{root}/{t}/*.parquet")


def _rows(d):
    cols = list(d.values())
    return [tuple(c[i] for c in cols) for i in range(len(cols[0]))] \
        if cols else []


def _same_rows(got, want, rel, what):
    g, w = _rows(got), _rows(want)
    assert len(g) == len(w), (what, len(g), len(w))
    for i, (gr, wr) in enumerate(zip(g, w)):
        assert len(gr) == len(wr), (what, i)
        for a, b in zip(gr, wr):
            if isinstance(a, float) and isinstance(b, float):
                assert abs(a - b) <= rel * max(abs(a), abs(b)), \
                    (what, i, a, b)
            else:
                assert a == b, (what, i, a, b)


@pytest.mark.parametrize("q", list(range(1, 23)))
def test_tpch_sql_matches_reference_and_dataframe_form(tpch_root,
                                                       monkeypatch, q):
    import daft_tpu_torch
    from daft_tpu_torch.benchmarking import tpch_queries, tpch_sql
    from daft_tpu_torch.device import runtime
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("DAFT_TORCH_DEVICE_MIN_ROWS", "0")
    # every priced decision (the fused fragment, the joins) on the device
    monkeypatch.setenv("DAFT_TORCH_DEVICE_FORCE", "1")
    runtime.reset_counters()
    got = tpch_sql.run(q, _reader(daft_tpu_torch, tpch_root)).to_pydict()
    counts = runtime.counters()
    want = RSQ.run(q, _reader(daft_tpu, tpch_root)).to_pydict()
    assert list(got) == list(want)
    _same_rows(got, want, REL, f"q{q} port SQL vs daft_tpu.sql")
    df_form = tpch_queries.ALL[q](_reader(daft_tpu_torch, tpch_root))
    _same_rows(got, df_form.to_pydict(), REL_DF,
               f"q{q} port SQL vs port DataFrame form")
    assert counts.get("host_morsels", 0) == 0, counts


def test_tpch_sql_binds_the_function_not_the_module():
    """``daft_tpu_torch.sql`` is the function (the package imports it
    after the submodule), and the submodule stays importable."""
    import daft_tpu_torch
    mod = importlib.import_module("daft_tpu_torch.sql")
    assert callable(daft_tpu_torch.sql) and daft_tpu_torch.sql is mod.sql
    assert daft_tpu_torch.sql_expr is mod.sql_expr


def test_sql_shared_cte_runs_once(tpch_root, monkeypatch):
    """Q15's SQL reads its ``revenue`` CTE twice (the rows and their
    maximum): one physical node with two consumers, lineitem scanned
    once, one row."""
    import daft_tpu_torch
    from daft_tpu_torch.benchmarking import tpch_sql
    from daft_tpu_torch.io import scan
    from daft_tpu_torch.physical.translate import translate
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    df = tpch_sql.run(15, _reader(daft_tpu_torch, tpch_root))
    shared = []

    def walk(n):
        if getattr(n, "shared_consumers", 1) > 1:
            shared.append(n.shared_consumers)
        for ch in n.children:
            walk(ch)
    walk(translate(df.builder.optimize().plan))
    assert shared and 2 in shared
    paths = []
    execute = scan.ScanTask.execute

    def counted(self, *a, **k):
        paths.extend(self.paths)
        return execute(self, *a, **k)
    monkeypatch.setattr(scan.ScanTask, "execute", counted)
    # an empty device column cache: a cached lineitem task is not read
    from daft_tpu_torch.device import cache
    cache.get_cache().clear()
    got = df.to_pydict()
    assert len(got["s_suppkey"]) == 1
    li = [p for p in paths if "lineitem" in p]
    assert len(li) == len(set(li)) == 3


def test_window_function_names_its_roadmap_item(monkeypatch, tmp_path):
    """Windows are ported (ROADMAP A5a): the rank query gives the
    reference's answer; so do the CSV and JSON table functions (ported
    with the scan data plane), ``split`` (ROADMAP A8c) and the tokenize
    functions (ROADMAP A8d)."""
    import daft_tpu_torch
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    data = {"g": [1, 1, 2], "v": [1.0, 2.0, 3.0]}
    q = "SELECT g, rank() OVER (PARTITION BY g ORDER BY v) AS r FROM t"
    got = daft_tpu_torch.sql(q, t=daft_tpu_torch.from_pydict(data))
    want = daft_tpu.sql(q, t=daft_tpu.from_pydict(data))
    assert got.to_pydict() == want.to_pydict()
    t = daft_tpu_torch.from_pydict(data)
    (tmp_path / "x.csv").write_text("g,v\n1,1.5\n2,2.5\n")
    (tmp_path / "x.json").write_text('{"g": 1}\n{"g": 3}\n')
    for fn, f in (("read_csv", "x.csv"), ("read_json", "x.json")):
        q = f"SELECT g FROM {fn}('{tmp_path / f}') ORDER BY g"
        assert daft_tpu_torch.sql(q).to_pydict() \
            == daft_tpu.sql(q).to_pydict()
    q = "SELECT split(s, ',') AS p FROM t"
    assert daft_tpu_torch.sql(
        q, t=daft_tpu_torch.from_pydict({"s": ["a,b"]})).to_pydict() \
        == daft_tpu.sql(q, t=daft_tpu.from_pydict({"s": ["a,b"]})).to_pydict()
    q = ("SELECT tokenize_decode(tokenize_encode(s, 'bytes'), 'bytes') AS d,"
         " tokenize_encode(s, 'bytes') AS p FROM t")
    assert daft_tpu_torch.sql(
        q, t=daft_tpu_torch.from_pydict({"s": ["a,b"]})).to_pydict() \
        == daft_tpu.sql(q, t=daft_tpu.from_pydict({"s": ["a,b"]})).to_pydict()


@pytest.mark.parametrize("query", [
    "SELECT x FROM a INTERSECT SELECT x FROM b",
    "SELECT x FROM a EXCEPT SELECT x FROM b",
    "SELECT x FROM a UNION SELECT x FROM b",
])
def test_set_operations_match_reference(query, monkeypatch):
    import daft_tpu_torch
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    a, b = {"x": [1, 2, 2, 3, None]}, {"x": [2, 3, 4, None]}
    got = daft_tpu_torch.sql(query, a=daft_tpu_torch.from_pydict(a),
                             b=daft_tpu_torch.from_pydict(b)).to_pydict()
    want = daft_tpu.sql(query, a=daft_tpu.from_pydict(a),
                        b=daft_tpu.from_pydict(b)).to_pydict()
    key = lambda v: (v is None, v or 0)  # noqa: E731
    assert sorted(got["x"], key=key) == sorted(want["x"], key=key)


# --------------------------------------------------- replay through both

_VALUE_TYPES = {"Identifier", "DataType", "Field", "Schema", "TimeUnit"}
_PLAIN = (type(None), bool, int, float, str, bytes, datetime.date,
          datetime.datetime, datetime.time, datetime.timedelta,
          decimal.Decimal)


class Declined:
    """The port's side after it raised NotImplementedError naming its
    ROADMAP item."""

    def __init__(self, exc):
        self.exc = exc


class _Replay:
    """Per-test state: the declines met so far."""
    declined = []


def _side(x, i):
    if isinstance(x, Pair):
        return x.r if i == 0 else x.p
    if isinstance(x, (list, tuple)):
        return type(x)(_side(v, i) for v in x)
    if isinstance(x, dict):
        return {k: _side(v, i) for k, v in x.items()}
    return x


def _equal(a, b, what):
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) and math.isnan(b):
            return
        assert abs(a - b) <= REL * max(abs(a), abs(b)), (what, a, b)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (what, a, b)
        for k in a:
            _equal(a[k], b[k], what)
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), \
            (what, a, b)
        for x, y in zip(a, b):
            _equal(x, y, what)
    elif type(a).__name__ in _VALUE_TYPES:
        assert str(a) == str(b), (what, a, b)
    else:
        assert a == b, (what, a, b)


def _plain(x) -> bool:
    if isinstance(x, _PLAIN) or type(x).__name__ in _VALUE_TYPES:
        return True
    if isinstance(x, (list, tuple, set)):
        return all(_plain(v) for v in x)
    if isinstance(x, dict):
        return all(_plain(v) for v in x.values())
    return False


def _wrap(r, p, what):
    if isinstance(p, Declined) or _Replay.declined:
        return Pair(r, Declined(None)) if not _plain(r) else r
    if _plain(r):
        _equal(r, p, what)
        return r
    return Pair(r, p)


def _call(fr, fp, args, kwargs, what):
    port_off = isinstance(fp, Declined) or bool(_Replay.declined) \
        or any(isinstance(v, Declined) for v in
               list(_side(args, 1)) + list(_side(kwargs, 1).values()))
    try:
        r = fr(*_side(args, 0), **_side(kwargs, 0))
    except Exception:
        if not port_off:
            with pytest.raises(Exception):
                fp(*_side(args, 1), **_side(kwargs, 1))
        raise
    if port_off:
        return _wrap(r, Declined(None), what)
    try:
        p = fp(*_side(args, 1), **_side(kwargs, 1))
    except NotImplementedError as exc:
        assert "ROADMAP" in str(exc), exc
        _Replay.declined.append(exc)
        return _wrap(r, Declined(exc), what)
    return _wrap(r, p, what)


class Pair:
    """One object of each package, driven in step."""

    __slots__ = ("r", "p")

    def __init__(self, r, p):
        object.__setattr__(self, "r", r)
        object.__setattr__(self, "p", p)

    def __getattr__(self, name):
        ra = getattr(self.r, name)
        pa_ = self.p if isinstance(self.p, Declined) \
            or _Replay.declined else getattr(self.p, name)
        if callable(ra):
            return Pair(ra, pa_)
        return _wrap(ra, pa_, name)

    def __call__(self, *args, **kwargs):
        return _call(self.r, self.p, args, kwargs,
                     getattr(self.r, "__name__", repr(self.r)))

    def __iter__(self):
        ps = []
        if not isinstance(self.p, Declined) and not _Replay.declined:
            ps = list(self.p)
        for i, rv in enumerate(self.r):
            yield _wrap(rv, ps[i] if i < len(ps) else Declined(None),
                        "iter")

    def __len__(self):
        return _wrap(len(self.r), Declined(None) if isinstance(
            self.p, Declined) else len(self.p), "len")

    def __bool__(self):
        return bool(self.r)

    def __hash__(self):
        return id(self)

    def __repr__(self):
        return repr(self.r)

    def __str__(self):
        return _wrap(str(self.r), Declined(None) if isinstance(
            self.p, Declined) else str(self.p), "str")


def _binop(name):
    def op(self, *others):
        return _call(getattr(self.r, name), Declined(None)
                     if isinstance(self.p, Declined)
                     else getattr(self.p, name), others, {}, name)
    return op


for _nm in ("__add__", "__radd__", "__sub__", "__rsub__", "__mul__",
            "__rmul__", "__truediv__", "__rtruediv__", "__lt__", "__le__",
            "__gt__", "__ge__", "__eq__", "__ne__", "__and__", "__or__",
            "__invert__", "__neg__", "__getitem__", "__contains__",
            "__mod__", "__floordiv__"):
    setattr(Pair, _nm, _binop(_nm))


def _port_catalog(root, *args, **kwargs):
    """The port's catalog over a warehouse of its own beside the
    reference's (both create the same tables)."""
    from daft_tpu_torch.catalog_fs import FilesystemCatalog
    os.makedirs(root + "_port", exist_ok=True)
    return FilesystemCatalog(root + "_port", *args, **kwargs)


def _dual_namespace():
    import daft_tpu_torch
    rsql = importlib.import_module("daft_tpu.sql")
    psql = importlib.import_module("daft_tpu_torch.sql")
    from daft_tpu.catalog_fs import FilesystemCatalog

    def sql(query, catalog=None, **kwargs):
        if catalog is None:
            # bind DataFrames from the caller's frame, as ``sql`` does
            frame = sys._getframe(1)
            for scope in (frame.f_globals, frame.f_locals):
                for k, v in scope.items():
                    if isinstance(v, Pair) and isinstance(
                            v.r, daft_tpu.DataFrame):
                        kwargs.setdefault(k, v)
            return _call(rsql.sql, psql.sql, (query,), kwargs, query)
        return _call(rsql.sql, psql.sql, (query, catalog), kwargs, query)

    dual = Pair(daft_tpu, daft_tpu_torch)
    return {
        "dt": _DualModule(dual, sql), "daft_tpu": _DualModule(dual, sql),
        "col": dual.col, "Session": dual.Session,
        "SQLCatalog": Pair(rsql.SQLCatalog, psql.SQLCatalog), "sql": sql,
        "sql_expr": Pair(rsql.sql_expr, psql.sql_expr),
        "FilesystemCatalog": Pair(FilesystemCatalog, _port_catalog),
    }


class _DualModule:
    def __init__(self, dual, sql):
        self._dual = dual
        self.sql = sql

    def __getattr__(self, name):
        return getattr(self._dual, name)


_FILES = ("test_subquery.py", "test_sql.py", "test_sql_statements.py")
# the reference's TPC-H parity test drives the reference's own DataFrame
# queries module; its port form is the 22-query test above
_NOT_REPLAYED = {"test_tpch_subquery_sql_matches_dataframe"}


def _replay_cases():
    out = []
    for f in _FILES:
        tree = ast.parse(open(os.path.join(TESTS, f)).read())
        for node in tree.body:
            if isinstance(node, ast.FunctionDef) \
                    and node.name.startswith("test_") \
                    and node.name not in _NOT_REPLAYED:
                out.append((f, node.name))
    return out


_LOADED = {}


def _load(fname):
    if fname not in _LOADED:
        src = open(os.path.join(TESTS, fname)).read()
        src = re.sub(r"^(import daft_tpu.*|from daft_tpu[\w.]* import .*)$",
                     "", src, flags=re.M)
        src = re.sub(r"^@pytest\.fixture.*$", "", src, flags=re.M)
        ns = {"__name__": f"replay_{fname[:-3]}"}
        ns.update(_dual_namespace())
        exec(compile(src, os.path.join(TESTS, fname), "exec"), ns)
        _LOADED[fname] = ns
    return _LOADED[fname]


@pytest.mark.parametrize("fname,test", _replay_cases(),
                         ids=[f"{f[:-3]}::{t}" for f, t in _replay_cases()])
def test_replay_through_both_packages(fname, test, tmp_path,
                                      tmp_path_factory, monkeypatch):
    import inspect
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    ns = _load(fname)
    given = {"tmp_path": tmp_path, "tmp_path_factory": tmp_path_factory,
             "monkeypatch": monkeypatch}

    def resolve(fn):
        kw = {}
        for p in inspect.signature(fn).parameters:
            kw[p] = given[p] if p in given else resolve(ns[p])
        return fn(**kw)

    _Replay.declined = []
    try:
        resolve(ns[test])
        for exc in _Replay.declined:
            assert re.search(r"ROADMAP A\d", str(exc)), exc
    finally:
        _Replay.declined = []

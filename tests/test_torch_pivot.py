"""``Pivot``/``Unpivot`` and the DataFrame methods of ROADMAP A5b, held
against ``daft_tpu``: the parity subsets of ``tests/test_dataframe.py``
(``test_describe_count_rows``, the unpivot half of
``test_explode_unpivot``, ``test_pivot``; ``nparts`` 1 and 3),
``tests/test_recordbatch.py`` (``test_unpivot``, ``test_pivot``, on the
host tier and the device tier), ``tests/test_api_parity.py::
test_drop_nan_and_drop_null`` and ``tests/test_sql_statements.py::
test_describe``; the set methods, ``union_by_name``, ``num_partitions``
and ``explain`` (its analyzed form included); and the physical plans of pivot and unpivot queries node
for node. The port runs on CPU tensors (``DAFT_TORCH_DEVICE=cpu``); its
device tier takes every priced decision on the device
(``DAFT_TORCH_DEVICE_FORCE=1``), so a pivot's pre-aggregation runs the
hash agg strategy's plain twin.
"""

import math
import re

import pytest

import daft_tpu
from daft_tpu import col as rcol


@pytest.fixture(params=[1, 3], ids=["p1", "p3"])
def nparts(request):
    return request.param


@pytest.fixture(params=["host", "device"])
def tier(request, monkeypatch):
    """Both packages on their host tier, or on their device tier (the
    port on CPU tensors with every priced decision on the device and the
    hash group-by)."""
    from daft_tpu_torch.device import runtime
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    if request.param == "device":
        monkeypatch.setenv("DAFT_TPU_DEVICE", "1")
        monkeypatch.setenv("DAFT_TORCH_DEVICE_FORCE", "1")
        monkeypatch.setenv("DAFT_TORCH_KERNEL_GROUPBY", "hash")
    else:
        monkeypatch.setenv("DAFT_TPU_DEVICE", "0")
        monkeypatch.setenv("DAFT_TORCH_DEVICE", "0")
    runtime.reset_counters()
    return request.param


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")


def _both(data, nparts=1):
    import daft_tpu_torch
    out = []
    for pkg in (daft_tpu, daft_tpu_torch):
        df = pkg.from_pydict(data)
        out.append(df.into_partitions(nparts) if nparts > 1 else df)
    return out


def _col(pkg_df, name):
    import daft_tpu_torch
    return (daft_tpu_torch.col if type(pkg_df).__module__.startswith(
        "daft_tpu_torch") else rcol)(name)


def _rows(d):
    cols = list(d)
    def key(v):
        return (v is None, repr(v))
    return cols, sorted(zip(*(d[c] for c in cols)),
                        key=lambda r: tuple(key(v) for v in r))


# ------------------------------------------------ tests/test_dataframe.py


def test_describe_count_rows(nparts, cpu):
    ref, port = _both({"a": [1, 2, None], "s": ["x", "y", "z"]}, nparts)
    assert port.count_rows() == ref.count_rows() == 3
    want = ref.describe().to_pydict()
    got = port.describe().to_pydict()
    assert got == want
    assert got["a_count"] == [2] and got["a_mean"] == [1.5]
    assert port.summarize().to_pydict() == ref.summarize().to_pydict()


def test_unpivot(nparts, cpu):
    ref, port = _both({"id": [1, 2], "x": [10, 20], "y": [30, 40]}, nparts)
    want = ref.unpivot("id").sort(["variable", "id"]).to_pydict()
    got = port.unpivot("id").sort(["variable", "id"]).to_pydict()
    assert got == want == {"id": [1, 2, 1, 2],
                           "variable": ["x", "x", "y", "y"],
                           "value": [10, 20, 30, 40]}
    assert port.melt("id", ["y"], "k", "w").sort("id").to_pydict() == \
        ref.melt("id", ["y"], "k", "w").sort("id").to_pydict()


def test_unpivot_takes_the_values_supertype(cpu):
    ref, port = _both({"id": [1, 2], "i": [1, None], "f": [0.5, 2.5]})
    want = ref.unpivot(["id"], ["i", "f"]).to_pydict()
    got = port.unpivot(["id"], ["i", "f"]).to_pydict()
    assert _rows(got) == _rows(want)
    assert str(port.unpivot(["id"], ["i", "f"]).schema()["value"].dtype) \
        == str(ref.unpivot(["id"], ["i", "f"]).schema()["value"].dtype)


def test_pivot(nparts, tier):
    from daft_tpu_torch.device import runtime
    data = {"g": ["a", "a", "b"], "p": ["x", "y", "x"], "v": [1, 2, 3]}
    ref, port = _both(data, nparts)
    want = ref.pivot("g", rcol("p"), rcol("v"), "sum").sort("g").to_pydict()
    got = port.pivot("g", _col(port, "p"), _col(port, "v"), "sum") \
        .sort("g").to_pydict()
    assert got == want == {"g": ["a", "b"], "x": [1, 3], "y": [2, None]}
    counts = runtime.counters()
    on_device = counts.get("agg_hash", 0) + counts.get("hash", 0)
    assert (on_device > 0) == (tier == "device"), counts


@pytest.mark.parametrize("how", ["distributed", "set_runner"])
def test_pivot_probe_runs_through_the_selected_runner(how, cpu,
                                                      monkeypatch):
    """``pivot`` without ``names`` probes the pivot column's distinct
    values through the process's runner, as the reference does
    (``runners/runner_io.py``): under ``DAFT_TORCH_RUNNER=distributed``
    the distributed runner, after ``set_runner`` the installed one. The
    answer equals the reference's."""
    import daft_tpu_torch
    from daft_tpu_torch import context
    from daft_tpu_torch.runners import distributed_runner as dr
    from daft_tpu_torch.runners.native_runner import NativeRunner
    from daft_tpu_torch.runners.runner import Runner
    data = {"g": [1, 1, 2, 2, 3], "p": ["x", "y", "x", "z", "y"],
            "v": [1.0, 2.0, 3.0, 4.0, 5.0]}
    want = daft_tpu.from_pydict(data).pivot("g", "p", "v", "sum") \
        .sort("g").to_pydict()
    runs = []
    if how == "distributed":
        monkeypatch.setenv("DAFT_TORCH_RUNNER", "distributed")
        monkeypatch.setenv("DAFT_TORCH_NUM_WORKERS", "2")
        orig = dr.DistributedRunner.run_iter

        def counted(self, builder, *a, **k):
            runs.append(type(self).__name__)
            return orig(self, builder, *a, **k)
        monkeypatch.setattr(dr.DistributedRunner, "run_iter", counted)
        installed = None
    else:
        class Counting(Runner):
            def run_iter(self, builder, results_buffer_size=None):
                runs.append(type(self).__name__)
                return NativeRunner().run_iter(builder)
        installed = Counting()
    prev = context.get_context()._runner
    context.set_runner(installed)
    try:
        df = daft_tpu_torch.from_pydict(data).pivot("g", "p", "v", "sum")
        # the probe ran at plan time, through the selected runner
        assert runs == (["DistributedRunner"] if how == "distributed"
                        else ["Counting"])
        got = df.sort("g").to_pydict()
    finally:
        runner = context.get_context()._runner
        if isinstance(runner, dr.DistributedRunner):
            runner.shutdown()
        context.set_runner(prev)
    assert list(got) == list(want) and _rows(got) == _rows(want)


@pytest.mark.parametrize("agg_fn", ["sum", "mean", "min", "max", "count"])
def test_pivot_aggregations_and_names(agg_fn, cpu):
    # no null pivot value: an integer pivot column's null name raises in
    # both packages (``int(None)``, ROADMAP reference caveats)
    data = {"g": [1, 1, 2, 2, 2, None], "p": [7, 8, 7, 7, 9, 8],
            "v": [1.5, 2.0, None, 4.0, 5.0, 6.0]}
    ref, port = _both(data, 3)
    want = ref.pivot("g", "p", "v", agg_fn).to_pydict()
    got = port.pivot("g", "p", "v", agg_fn).to_pydict()
    assert list(got) == list(want)
    assert _rows(got) == _rows(want)
    want = ref.pivot(["g"], "p", "v", agg_fn, names=["8", "9"]).to_pydict()
    got = port.pivot(["g"], "p", "v", agg_fn, names=["8", "9"]).to_pydict()
    assert list(got) == list(want) and _rows(got) == _rows(want)


def test_pivot_and_unpivot_under_other_operators(cpu):
    data = {"g": ["a", "b", "a", "c", "b"], "p": ["x", "y", "y", "x", "x"],
            "v": [1, 2, 3, 4, 5], "w": [0.5, 1.5, 2.5, 3.5, 4.5]}
    ref, port = _both(data, 3)

    def q(df):
        c = _col(df, "g")
        wide = df.pivot("g", "p", "v", "sum").where(c != "c")
        back = wide.unpivot("g", ["x", "y"]).where(
            _col(df, "value").not_null())
        return back.select("g", "value")
    assert _rows(q(port).to_pydict()) == _rows(q(ref).to_pydict())


# ---------------------------------------------- tests/test_recordbatch.py


def test_recordbatch_unpivot(tier):
    import daft_tpu_torch
    data = {"id": [1, 2], "x": [10, 20], "y": [30, 40]}
    want = daft_tpu.RecordBatch.from_pydict(data).unpivot(
        [rcol("id")], [rcol("x"), rcol("y")]).to_pydict()
    c = daft_tpu_torch.col
    got = daft_tpu_torch.RecordBatch.from_pydict(data).unpivot(
        [c("id")], [c("x"), c("y")]).to_pydict()
    assert got == want and len(got["id"]) == 4
    assert set(got["variable"]) == {"x", "y"}


def test_recordbatch_pivot(tier):
    import daft_tpu_torch
    data = {"g": ["a", "a", "b"], "p": ["x", "y", "x"], "v": [1, 2, 3]}
    want = daft_tpu.RecordBatch.from_pydict(data).pivot(
        [rcol("g")], rcol("p"), rcol("v"), ["x", "y"]).sort(
        [rcol("g")]).to_pydict()
    c = daft_tpu_torch.col
    got = daft_tpu_torch.RecordBatch.from_pydict(data).pivot(
        [c("g")], c("p"), c("v"), ["x", "y"]).sort([c("g")]).to_pydict()
    assert got == want == {"g": ["a", "b"], "x": [1, 3], "y": [2, None]}


# ---------------------------------------------- tests/test_api_parity.py


def test_drop_nan_and_drop_null(cpu):
    ref, port = _both({"f": [1.0, float("nan"), 3.0, None],
                       "s": ["a", "b", None, "d"]})
    for name, f in (("drop_nan", lambda d: d.drop_nan()),
                    ("drop_null s", lambda d: d.drop_null("s")),
                    ("drop_null", lambda d: d.drop_null()),
                    ("drop_nan f", lambda d: d.drop_nan("f"))):
        got, want = f(port).to_pydict(), f(ref).to_pydict()
        assert _rows(got)[0] == _rows(want)[0], name
        assert [[None if isinstance(v, float) and math.isnan(v) else v
                 for v in r] for r in _rows(got)[1]] == \
            [[None if isinstance(v, float) and math.isnan(v) else v
              for v in r] for r in _rows(want)[1]], name
    assert port.drop_nan().count_rows() == 3       # nan gone, null stays
    assert port.drop_null("s").count_rows() == 3
    assert port.drop_null().count_rows() == 2


# ------------------------------------------- tests/test_sql_statements.py


def test_sql_describe(cpu):
    import daft_tpu_torch
    from daft_tpu.session import Session as RefSession
    out = []
    for sess in (RefSession(), daft_tpu_torch.Session()):
        sess.sql("CREATE TEMP TABLE t AS SELECT 1 AS x, 'a' AS s")
        out.append(sess.sql("DESCRIBE t").to_pydict())
    want, got = out
    assert got == want
    assert got["column"] == ["x", "s"] and "int" in got["type"][0].lower()


# -------------------------------------------------------- set operations


@pytest.mark.parametrize("op", ["union", "union_all", "intersect",
                                "intersect_all", "except_distinct",
                                "except_all"])
def test_set_methods(op, nparts, cpu):
    a = {"x": [1, 1, 2, 3, None, None], "y": ["a", "a", "b", "c", None,
                                               None]}
    b = {"x": [1, 3, 3, None, 4], "y": ["a", "c", "c", None, "d"]}
    ra, pa_ = _both(a, nparts)
    rb, pb = _both(b)
    want = getattr(ra, op)(rb).to_pydict()
    got = getattr(pa_, op)(pb).to_pydict()
    assert _rows(got) == _rows(want)


def test_union_by_name(cpu):
    ra, pa_ = _both({"x": [1, 1], "y": ["a", "a"]})
    rb, pb = _both({"y": ["b", "a"], "x": [2, 1]})
    for op in ("union_by_name", "union_all_by_name"):
        want = getattr(ra, op)(rb).to_pydict()
        got = getattr(pa_, op)(pb).to_pydict()
        assert _rows(got) == _rows(want), op
    assert pa_.union_by_name(pb).sort("x").to_pydict() == \
        {"x": [1, 2], "y": ["a", "b"]}
    _, other = _both({"z": [1]})
    with pytest.raises(ValueError, match="column sets differ"):
        pa_.union_by_name(other)


# ------------------------------------------------- num_partitions, explain


def test_num_partitions(nparts, cpu):
    ref, port = _both({"a": list(range(10))}, nparts)
    assert port.num_partitions() == ref.num_partitions() == nparts
    assert port.where(_col(port, "a") > 3).num_partitions() == \
        ref.where(rcol("a") > 3).num_partitions()


def test_explain(cpu, capsys):
    ref, port = _both({"a": [1, 2, 3]})

    def text(df, **kw):
        df.where(_col(df, "a") > 1).select("a").explain(**kw)
        return capsys.readouterr().out
    for kw in ({}, {"show_all": True}):
        got, want = text(port, **kw), text(ref, **kw)
        heads = [ln for ln in got.splitlines() if ln.startswith("==")]
        assert heads == [ln for ln in want.splitlines()
                         if ln.startswith("==")], kw
        assert "Filter" in got and "Project" in got

    def analyzed(df):
        """The analyzed render's header and its operators with their
        rows (the times differ from run to run)."""
        return [re.sub(r" total=.*", "", ln)
                for ln in text(df, analyze=True).splitlines()
                if ln.startswith("==") or "rows_out=" in ln]
    got = analyzed(port)
    assert got == analyzed(ref)
    assert got[0] == "== Physical Plan (analyzed) =="
    assert any("rows_out=2 " in ln for ln in got)


# ------------------------------------------------------- plans node for node


def _sig(n):
    t = type(n).__name__
    extra = (n.kind, n.num_partitions) if t == "Exchange" else ()
    return (t,) + extra + tuple(_sig(c) for c in n.children)


def test_pivot_and_unpivot_plan_node_for_node(monkeypatch, cpu):
    from daft_tpu.parallel import mesh
    from daft_tpu.physical.translate import translate as ref_translate

    from daft_tpu_torch.physical.translate import translate
    monkeypatch.setattr(mesh, "mesh_size", lambda: 1)
    data = {"g": ["a", "b", "a"], "p": ["x", "y", "y"], "v": [1, 2, 3]}
    ref, port = _both(data, 3)
    for q in (lambda d: d.pivot("g", "p", "v", "sum", names=["x", "y"]),
              lambda d: d.unpivot("g", ["v"]).where(
                  _col(d, "value") > 1),
              lambda d: d.pivot("g", "p", "v", "max", names=["x"])
              .unpivot("g")):
        want = _sig(ref_translate(q(ref)._builder.optimize()._plan))
        got = _sig(translate(q(port).builder.optimize().plan))
        assert got == want


_NO_JAX_SCRIPT = r"""
import os, sys
os.environ["DAFT_TORCH_DEVICE"] = "cpu"
import daft_tpu_torch
from daft_tpu_torch.analysis import dispatch_registry, plan_fuzzer
df = daft_tpu_torch.from_pydict({"g": ["a", "a", "b"], "p": ["x", "y", "x"],
                                 "v": [1, 2, 3]})
wide = df.pivot("g", "p", "v", "sum").sort("g").to_pydict()
assert wide == {"g": ["a", "b"], "x": [1, 3], "y": [2, None]}, wide
assert len(df.unpivot("g").to_pydict()["g"]) == 6
assert df.describe().to_pydict()["v_count"] == [3]
res = plan_fuzzer.run_fuzz(count=2, seed=0)
assert res.seeds_run == 2 and not res.mismatches, res.summary()
assert dispatch_registry.findings() == []
leaked = sorted(m for m in sys.modules
                if m in ("jax", "jaxlib", "daft_tpu")
                or m.startswith(("jax.", "jaxlib.", "daft_tpu.")))
print("LEAKED", leaked)
assert leaked == [], leaked
"""


def test_pivot_fuzzer_and_registry_run_without_jax():
    """A pivot, an unpivot, describe, two fuzzer seeds in every mode and
    the registry's check import neither JAX nor daft_tpu."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT], cwd=repo,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LEAKED []" in r.stdout

"""The port's vendored pyspark-flavored Connect client against the
reference's (``tests/test_connect_client.py``).

The reference's 8 cases, each driven through both packages: the
reference's client against the reference's server and the port's client
against the port's server, both over gRPC in this process, queries on CPU
tensors (``DAFT_TORCH_DEVICE=cpu``). Rows must be equal (integers,
strings, the schemas' names and types). Port-only: the same cases'
answers over the in-process transport, and the client's interrupt and
release of a reattachable operation.
"""

import pyarrow as pa
import pytest

from daft_tpu.connect import start_server as ref_start_server
from daft_tpu.connect import client as ref_client
from daft_tpu_torch import serving
from daft_tpu_torch.connect import SparkConnectService, start_server
from daft_tpu_torch.connect import client as port_client


@pytest.fixture(scope="module")
def sparks():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DAFT_TORCH_DEVICE", "cpu")
        ref_srv, port_srv = ref_start_server(), start_server()
        out = {"ref": (ref_client,
                       ref_client.connect(f"127.0.0.1:{ref_srv.port}")),
               "port": (port_client,
                        port_client.connect(f"127.0.0.1:{port_srv.port}"))}
        yield out
        for _, s in out.values():
            s.stop()
        ref_srv.stop()
        port_srv.stop()
        serving.shutdown_shared()


def _each(sparks, fn):
    """``fn(client_module, session)`` on both sides: equal answers, the
    port's returned."""
    got = {side: fn(mod, s) for side, (mod, s) in sparks.items()}
    assert got["port"] == got["ref"], got
    return got["port"]


def test_version(sparks):
    v = _each(sparks, lambda m, s: bool(s.version))
    assert v


def test_range_filter_select_collect(sparks):
    rows = _each(sparks, lambda m, s: (
        s.range(100).filter(m.col("id") >= 95)
        .select((m.col("id") * 2).alias("x")).sort("x").collect()))
    assert [r["x"] for r in rows] == [190, 192, 194, 196, 198]


def test_create_dataframe_groupby_agg(sparks):
    rows = _each(sparks, lambda m, s: (
        s.createDataFrame({"k": ["a", "a", "b"], "v": [1, 2, 10]})
        .groupBy("k").agg(m._agg_fn("sum", m.col("v")).alias("s"))
        .sort("k").collect()))
    assert rows == [{"k": "a", "s": 3}, {"k": "b", "s": 10}]


def test_join(sparks):
    def run(m, s):
        left = s.createDataFrame({"k": [1, 2, 3], "v": ["x", "y", "z"]})
        right = s.createDataFrame({"k": [2, 3, 4], "w": [20, 30, 40]})
        return left.join(right, on="k").sort("k").collect()
    rows = _each(sparks, run)
    assert rows == [{"k": 2, "v": "y", "w": 20},
                    {"k": 3, "v": "z", "w": 30}]


def test_sql_and_temp_view(sparks):
    def run(m, s):
        s.createDataFrame({"x": [1, 2, 3, 4]}).createOrReplaceTempView(
            "nums")
        return s.sql("SELECT sum(x) AS total FROM nums WHERE x > 1") \
            .collect()
    assert _each(sparks, run) == [{"total": 9}]


def test_schema_analyze(sparks):
    def run(m, s):
        sch = s.createDataFrame({"a": [1], "b": ["x"]}).schema
        assert isinstance(sch, pa.Schema)
        return sch
    s = _each(sparks, run)
    assert s.names == ["a", "b"]
    assert pa.types.is_integer(s.field("a").type)
    assert pa.types.is_large_string(s.field("b").type) \
        or pa.types.is_string(s.field("b").type)


def test_write_then_read_parquet(sparks, tmp_path):
    def run(m, s):
        out = str(tmp_path / m.__name__.split(".")[0] / "out")
        s.createDataFrame({"a": [1, 2, 3]}).write.parquet(out)
        return s.read_parquet(out + "/*.parquet").sort("a").collect()
    back = _each(sparks, run)
    assert [r["a"] for r in back] == [1, 2, 3]


def test_with_column_and_limit(sparks):
    rows = _each(sparks, lambda m, s: (
        s.range(10).withColumn("double", m.col("id") * 2)
        .sort("id").limit(3).collect()))
    assert [r["double"] for r in rows] == [0, 2, 4]


# ------------------------------------------------------------ port-only

def test_in_process_client_gives_the_grpc_answers(sparks, monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    ip = port_client.connect_in_process(SparkConnectService())
    _, grpc_side = sparks["port"]
    col = port_client.col
    for build in (
            lambda s: s.range(100).filter(col("id") >= 95)
            .select((col("id") * 2).alias("x")).sort("x"),
            lambda s: s.createDataFrame({"k": ["a", "a", "b"],
                                         "v": [1, 2, 10]}).groupBy("k")
            .agg(port_client._agg_fn("sum", col("v")).alias("s"))
            .sort("k"),
            lambda s: s.sql("SELECT 1 + 1 AS two")):
        assert build(ip).collect() == build(grpc_side).collect()
    assert ip.version == grpc_side.version


def test_client_release_of_a_reattachable_operation(sparks, monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    svc = SparkConnectService()
    ip = port_client.connect_in_process(svc)
    t = ip.range(10).execute_arrow(operation_id="op-keep",
                                   reattachable=True)
    assert t.column("id").to_pylist() == list(range(10))
    st = svc._sessions[ip.session_id]
    assert "op-keep" in st.operations
    assert ip.interrupt("op-keep") == []  # finished: nothing to interrupt
    assert ip.release("op-keep") == "op-keep"
    assert "op-keep" not in st.operations

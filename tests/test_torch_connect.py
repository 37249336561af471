"""The port's Spark Connect server (``daft_tpu_torch/connect/``) against
the reference's (``tests/test_connect.py``).

The reference's 21 cases, each sent over raw gRPC to both servers, one of
each package in this process: the same requests (one set of ``pb``
messages: the two packages' ``spark_connect_subset_pb2`` register one
byte-identical descriptor, so their message classes are the same), the
answers equal table for table (values, column names and Arrow types),
and each case's own expectations held on the port's side. Queries run on
CPU tensors (``DAFT_TORCH_DEVICE=cpu``) through the shared scheduler of
each package. Port-only: the serialized descriptor equals the
reference's, and the in-process transport (no gRPC) gives the gRPC
server's answers and status codes.
"""

import io
import zlib

import grpc
import pyarrow as pa
import pytest

import daft_tpu.connect.spark_connect_subset_pb2 as ref_pb
import daft_tpu_torch.connect.spark_connect_subset_pb2 as pb
from daft_tpu.connect import start_server as ref_start_server
from daft_tpu_torch import serving
from daft_tpu_torch.connect import (ConnectAbort, SparkConnectService,
                                    StatusCode, start_server)

SERVICE = "/spark.connect.SparkConnectService/"
SIDES = ("ref", "port")


@pytest.fixture(scope="module")
def channels():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DAFT_TORCH_DEVICE", "cpu")
        servers = {"ref": ref_start_server(), "port": start_server()}
        chans = {k: grpc.insecure_channel(f"127.0.0.1:{s.port}")
                 for k, s in servers.items()}
        yield chans
        for ch in chans.values():
            ch.close()
        for s in servers.values():
            s.stop()
        serving.shutdown_shared()


def _execute(channel, relation, session="sess-1") -> pa.Table:
    stub = channel.unary_stream(
        SERVICE + "ExecutePlan",
        request_serializer=pb.ExecutePlanRequest.SerializeToString,
        response_deserializer=pb.ExecutePlanResponse.FromString)
    req = pb.ExecutePlanRequest(session_id=session,
                                plan=pb.Plan(root=relation))
    tables = []
    complete = False
    for resp in stub(req):
        if resp.WhichOneof("response_type") == "arrow_batch":
            with pa.ipc.open_stream(
                    pa.BufferReader(resp.arrow_batch.data)) as r:
                tables.append(r.read_all())
        elif resp.WhichOneof("response_type") == "result_complete":
            complete = True
    assert complete
    return pa.concat_tables(tables)


def _both(channels, relation, session="sess-1") -> pa.Table:
    """The relation through both servers: equal tables, the port's
    returned."""
    ref = _execute(channels["ref"], relation, session)
    got = _execute(channels["port"], relation, session)
    assert got.schema.names == ref.schema.names
    assert got.schema.types == ref.schema.types, (got.schema, ref.schema)
    assert got.to_pydict() == ref.to_pydict()
    return got


def _analyze(channel, session="sess-1", **kwargs) -> pb.AnalyzePlanResponse:
    stub = channel.unary_unary(
        SERVICE + "AnalyzePlan",
        request_serializer=pb.AnalyzePlanRequest.SerializeToString,
        response_deserializer=pb.AnalyzePlanResponse.FromString)
    return stub(pb.AnalyzePlanRequest(session_id=session, **kwargs))


def _execute_stub(channel):
    return channel.unary_stream(
        SERVICE + "ExecutePlan",
        request_serializer=pb.ExecutePlanRequest.SerializeToString,
        response_deserializer=pb.ExecutePlanResponse.FromString)


def _attr(name):
    return pb.Expression(unresolved_attribute=pb.Expression
                         .UnresolvedAttribute(unparsed_identifier=name))


def _lit_i(v):
    return pb.Expression(literal=pb.Expression.Literal(long=v))


def _fn(name, *args):
    return pb.Expression(unresolved_function=pb.Expression.UnresolvedFunction(
        function_name=name, arguments=list(args)))


def _ipc(table):
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, table.schema) as w:
        w.write_table(table)
    return sink.getvalue()


def test_range_collect(channels):
    t = _both(channels, pb.Relation(range=pb.Range(start=2, end=10, step=2)))
    assert t.column("id").to_pylist() == [2, 4, 6, 8]


def test_filter_project_sort(channels):
    rng = pb.Relation(range=pb.Range(end=10, step=1))
    flt = pb.Relation(filter=pb.Filter(
        input=rng, condition=_fn(">", _attr("id"), _lit_i(5))))
    proj = pb.Relation(project=pb.Project(
        input=flt,
        expressions=[pb.Expression(alias=pb.Expression.Alias(
            expr=_fn("*", _attr("id"), _lit_i(10)), name=["x"]))]))
    srt = pb.Relation(sort=pb.Sort(
        input=proj, order=[pb.Expression.SortOrder(
            child=_attr("x"),
            direction=pb.Expression.SortOrder.SORT_DIRECTION_DESCENDING)]))
    t = _both(channels, srt)
    assert t.column("x").to_pylist() == [90, 80, 70, 60]


def test_aggregate_groupby(channels):
    rng = pb.Relation(range=pb.Range(end=10, step=1))
    grouped = pb.Relation(aggregate=pb.Aggregate(
        input=rng,
        group_type=pb.Aggregate.GROUP_TYPE_GROUPBY,
        grouping_expressions=[pb.Expression(alias=pb.Expression.Alias(
            expr=_fn("%", _attr("id"), _lit_i(2)), name=["parity"]))],
        aggregate_expressions=[pb.Expression(alias=pb.Expression.Alias(
            expr=_fn("sum", _attr("id")), name=["s"]))]))
    srt = pb.Relation(sort=pb.Sort(
        input=grouped, order=[pb.Expression.SortOrder(
            child=_attr("parity"),
            direction=pb.Expression.SortOrder.SORT_DIRECTION_ASCENDING)]))
    t = _both(channels, srt)
    assert t.column("parity").to_pylist() == [0, 1]
    assert t.column("s").to_pylist() == [20, 25]


def test_count_star(channels):
    rng = pb.Relation(range=pb.Range(end=7, step=1))
    star = pb.Expression(unresolved_star=pb.Expression.UnresolvedStar())
    agg = pb.Relation(aggregate=pb.Aggregate(
        input=rng, group_type=pb.Aggregate.GROUP_TYPE_GROUPBY,
        aggregate_expressions=[_fn("count", star)]))
    t = _both(channels, agg)
    assert t.column("count").to_pylist() == [7]


def test_local_relation_and_join(channels):
    left = pb.Relation(local_relation=pb.LocalRelation(
        data=_ipc(pa.table({"k": [1, 2, 3], "a": ["x", "y", "z"]}))))
    right = pb.Relation(local_relation=pb.LocalRelation(
        data=_ipc(pa.table({"k": [2, 3, 4], "b": [20, 30, 40]}))))
    join = pb.Relation(join=pb.Join(
        left=left, right=right, join_type=pb.Join.JOIN_TYPE_INNER,
        using_columns=["k"]))
    srt = pb.Relation(sort=pb.Sort(
        input=join, order=[pb.Expression.SortOrder(
            child=_attr("k"),
            direction=pb.Expression.SortOrder.SORT_DIRECTION_ASCENDING)]))
    t = _both(channels, srt)
    assert t.column("k").to_pylist() == [2, 3]
    assert t.column("b").to_pylist() == [20, 30]


def test_to_schema_and_schema_only_local_relation(channels):
    rng = pb.Relation(range=pb.Range(end=3, step=1))
    cast = pb.Relation(to_schema=pb.ToSchema(
        input=rng, schema=pb.DataType(struct=pb.DataType.Struct(fields=[
            pb.DataType.StructField(
                name="id", data_type=pb.DataType(
                    integer=pb.DataType.Integer()))]))))
    t = _both(channels, cast)
    assert t.column("id").to_pylist() == [0, 1, 2]
    assert t.schema.field("id").type == pa.int32()

    empty = pb.Relation(local_relation=pb.LocalRelation(
        schema="a INT, b STRING"))
    t2 = _both(channels, empty)
    assert t2.schema.names == ["a", "b"] and t2.num_rows == 0


def test_html_string_escapes_markup(channels):
    rng = pb.Relation(range=pb.Range(end=2, step=1))
    h = pb.Relation(html_string=pb.HtmlString(input=rng, num_rows=10,
                                              truncate=20))
    html = _both(channels, h).column("html_string").to_pylist()[0]
    assert "<table" in html and "<th>id</th>" in html

    # data must never inject markup
    evil = pb.Relation(project=pb.Project(
        input=rng, expressions=[pb.Expression(alias=pb.Expression.Alias(
            expr=pb.Expression(literal=pb.Expression.Literal(
                string="<td>x&y</table>")), name=["s"]))]))
    h2 = pb.Relation(html_string=pb.HtmlString(input=evil, num_rows=5,
                                               truncate=100))
    html2 = _both(channels, h2).column("html_string").to_pylist()[0]
    assert "<td>&lt;td&gt;x&amp;y&lt;/table&gt;</td>" in html2


def test_sql_command_roundtrip(channels):
    cmd = pb.Plan(command=pb.Command(sql_command=pb.SqlCommand(
        sql="SELECT 1 + 1 AS two")))
    rels = {}
    for side in SIDES:
        for resp in _execute_stub(channels[side])(
                pb.ExecutePlanRequest(session_id="sess-1", plan=cmd)):
            if resp.WhichOneof("response_type") == "sql_command_result":
                rels[side] = resp.sql_command_result.relation
    assert rels["port"] == rels["ref"]
    t = _both(channels, rels["port"])
    assert t.column("two").to_pylist() == [2]


def test_view_then_sql(channels):
    view_cmd = pb.Plan(command=pb.Command(
        create_dataframe_view=pb.CreateDataFrameViewCommand(
            input=pb.Relation(range=pb.Range(end=5, step=1)),
            name="nums", replace=True)))
    for side in SIDES:
        list(_execute_stub(channels[side])(
            pb.ExecutePlanRequest(session_id="sess-1", plan=view_cmd)))
    t = _both(channels, pb.Relation(sql=pb.SQL(
        query="SELECT SUM(id) AS s FROM nums")))
    assert t.column("s").to_pylist() == [10]


def test_analyze_schema_and_version(channels):
    plan = pb.Plan(root=pb.Relation(range=pb.Range(end=3, step=1)))
    resp = {s: _analyze(channels[s],
                        schema=pb.AnalyzePlanRequest.Schema(plan=plan))
            for s in SIDES}
    assert resp["port"].schema == resp["ref"].schema
    fields = resp["port"].schema.schema.struct.fields
    assert len(fields) == 1 and fields[0].name == "id"
    assert fields[0].data_type.WhichOneof("kind") == "long"

    ver = {s: _analyze(channels[s], spark_version=pb.AnalyzePlanRequest
                       .SparkVersion()).spark_version.version
           for s in SIDES}
    assert "daft-tpu" in ver["ref"] and "daft-torch" in ver["port"]
    assert ver["port"].split("+")[0] == ver["ref"].split("+")[0]


def test_analyze_ddl_parse(channels):
    resp = {s: _analyze(channels[s],
                        ddl_parse=pb.AnalyzePlanRequest.DDLParse(
                            ddl_string="a INT, b STRING, c ARRAY<DOUBLE>"))
            for s in SIDES}
    assert resp["port"].ddl_parse == resp["ref"].ddl_parse
    fields = resp["port"].ddl_parse.parsed.struct.fields
    assert [f.name for f in fields] == ["a", "b", "c"]
    assert fields[2].data_type.array.element_type.WhichOneof(
        "kind") == "double"


def test_config_roundtrip(channels):
    got = {}
    for side in SIDES:
        stub = channels[side].unary_unary(
            SERVICE + "Config",
            request_serializer=pb.ConfigRequest.SerializeToString,
            response_deserializer=pb.ConfigResponse.FromString)
        set_op = pb.ConfigRequest.Operation(set=pb.ConfigRequest.Set(
            pairs=[pb.KeyValue(key="spark.sql.shuffle.partitions",
                               value="16")]))
        stub(pb.ConfigRequest(session_id="cfg-sess", operation=set_op))
        get_op = pb.ConfigRequest.Operation(get=pb.ConfigRequest.Get(
            keys=["spark.sql.shuffle.partitions"]))
        got[side] = stub(pb.ConfigRequest(session_id="cfg-sess",
                                          operation=get_op))
    assert list(got["port"].pairs) == list(got["ref"].pairs)
    assert got["port"].pairs[0].value == "16"


def test_unsupported_relation_is_unimplemented(channels):
    codes = {}
    for side in SIDES:
        with pytest.raises(grpc.RpcError) as ei:
            list(_execute_stub(channels[side])(pb.ExecutePlanRequest(
                session_id="s", plan=pb.Plan(root=pb.Relation()))))
        codes[side] = ei.value.code()
    assert codes == {"ref": grpc.StatusCode.UNIMPLEMENTED,
                     "port": grpc.StatusCode.UNIMPLEMENTED}


def test_write_parquet_roundtrip(channels, tmp_path):
    backs = {}
    for side in SIDES:
        out = str(tmp_path / side / "out")
        wr = pb.Plan(command=pb.Command(write_operation=pb.WriteOperation(
            input=pb.Relation(range=pb.Range(end=6, step=1)),
            source="parquet", path=out,
            mode=pb.WriteOperation.SAVE_MODE_OVERWRITE)))
        list(_execute_stub(channels[side])(
            pb.ExecutePlanRequest(session_id="s", plan=wr)))
        backs[side] = _execute(channels[side], pb.Relation(read=pb.Read(
            data_source=pb.Read.DataSource(format="parquet", paths=[out]))))
    assert sorted(backs["port"].column("id").to_pylist()) == \
        sorted(backs["ref"].column("id").to_pylist()) == [0, 1, 2, 3, 4, 5]


# ------------------------------------------- operation-lifecycle RPCs

def _lifecycle_stubs(channel):
    return {
        "execute": _execute_stub(channel),
        "reattach": channel.unary_stream(
            SERVICE + "ReattachExecute",
            request_serializer=pb.ReattachExecuteRequest.SerializeToString,
            response_deserializer=pb.ExecutePlanResponse.FromString),
        "release": channel.unary_unary(
            SERVICE + "ReleaseExecute",
            request_serializer=pb.ReleaseExecuteRequest.SerializeToString,
            response_deserializer=pb.ReleaseExecuteResponse.FromString),
        "interrupt": channel.unary_unary(
            SERVICE + "Interrupt",
            request_serializer=pb.InterruptRequest.SerializeToString,
            response_deserializer=pb.InterruptResponse.FromString),
        "artifacts": channel.stream_unary(
            SERVICE + "AddArtifacts",
            request_serializer=pb.AddArtifactsRequest.SerializeToString,
            response_deserializer=pb.AddArtifactsResponse.FromString),
    }


def _reattachable_req(session, op_id, rel):
    req = pb.ExecutePlanRequest(session_id=session, operation_id=op_id,
                                plan=pb.Plan(root=rel))
    req.request_options.add().reattach_options.reattachable = True
    return req


def _kinds(responses):
    return [r.WhichOneof("response_type") for r in responses]


def test_reattach_replays_buffered_responses(channels):
    rel = pb.Relation(range=pb.Range(start=0, end=50, step=1))
    kinds = {}
    for side in SIDES:
        stubs = _lifecycle_stubs(channels[side])
        first = list(stubs["execute"](_reattachable_req("life-1", "op-re-1",
                                                        rel)))
        assert first[-1].WhichOneof("response_type") == "result_complete"
        replay = list(stubs["reattach"](pb.ReattachExecuteRequest(
            session_id="life-1", operation_id="op-re-1")))
        assert [r.response_id for r in replay] == \
            [r.response_id for r in first]
        tail = list(stubs["reattach"](pb.ReattachExecuteRequest(
            session_id="life-1", operation_id="op-re-1",
            last_response_id=first[0].response_id)))
        assert [r.response_id for r in tail] == \
            [r.response_id for r in first[1:]]
        kinds[side] = (_kinds(first), _kinds(replay), _kinds(tail))
    assert kinds["port"] == kinds["ref"]


def test_release_execute_frees_operation(channels):
    rel = pb.Relation(range=pb.Range(start=0, end=10, step=1))
    for side in SIDES:
        stubs = _lifecycle_stubs(channels[side])
        list(stubs["execute"](_reattachable_req("life-2", "op-rel-1", rel)))
        out = stubs["release"](pb.ReleaseExecuteRequest(
            session_id="life-2", operation_id="op-rel-1",
            release_all=pb.ReleaseExecuteRequest.ReleaseAll()))
        assert out.operation_id == "op-rel-1"
        with pytest.raises(grpc.RpcError) as err:
            list(stubs["reattach"](pb.ReattachExecuteRequest(
                session_id="life-2", operation_id="op-rel-1")))
        assert err.value.code() == grpc.StatusCode.NOT_FOUND, side
        stubs["release"](pb.ReleaseExecuteRequest(
            session_id="life-2", operation_id="op-rel-1",
            release_all=pb.ReleaseExecuteRequest.ReleaseAll()))


def test_release_until_trims_replay(channels):
    rel = pb.Relation(range=pb.Range(start=0, end=10, step=1))
    kinds = {}
    for side in SIDES:
        stubs = _lifecycle_stubs(channels[side])
        first = list(stubs["execute"](_reattachable_req("life-3", "op-ru-1",
                                                        rel)))
        stubs["release"](pb.ReleaseExecuteRequest(
            session_id="life-3", operation_id="op-ru-1",
            release_until=pb.ReleaseExecuteRequest.ReleaseUntil(
                response_id=first[0].response_id)))
        replay = list(stubs["reattach"](pb.ReattachExecuteRequest(
            session_id="life-3", operation_id="op-ru-1")))
        assert [r.response_id for r in replay] == \
            [r.response_id for r in first[1:]]
        kinds[side] = _kinds(replay)
    assert kinds["port"] == kinds["ref"]


def test_interrupt_completed_and_unknown_ops(channels):
    rel = pb.Relation(range=pb.Range(start=0, end=10, step=1))
    T = pb.InterruptRequest.InterruptType
    for side in SIDES:
        stubs = _lifecycle_stubs(channels[side])
        list(stubs["execute"](pb.ExecutePlanRequest(
            session_id="life-4", operation_id="op-int-1",
            plan=pb.Plan(root=rel))))
        for op_id in ("op-int-1", "nope"):
            out = stubs["interrupt"](pb.InterruptRequest(
                session_id="life-4",
                interrupt_type=T.INTERRUPT_TYPE_OPERATION_ID,
                operation_id=op_id))
            assert list(out.interrupted_ids) == [], (side, op_id)


def test_add_artifacts_batch_and_chunked(channels):
    blob = b"x" * 100

    def reqs():
        a = pb.AddArtifactsRequest(session_id="life-5")
        art = a.batch.artifacts.add()
        art.name = "files/a.txt"
        art.data.data = blob
        art.data.crc = zlib.crc32(blob)
        bad = a.batch.artifacts.add()
        bad.name = "files/bad.txt"
        bad.data.data = blob
        bad.data.crc = 1  # wrong on purpose
        yield a
        b = pb.AddArtifactsRequest(session_id="life-5")
        b.begin_chunk.name = "jars/big.jar"
        b.begin_chunk.num_chunks = 2
        b.begin_chunk.total_bytes = 200
        b.begin_chunk.initial_chunk.data = blob
        b.begin_chunk.initial_chunk.crc = zlib.crc32(blob)
        yield b
        c = pb.AddArtifactsRequest(session_id="life-5")
        c.chunk.data = blob
        c.chunk.crc = zlib.crc32(blob)
        yield c

    got = {}
    for side in SIDES:
        out = _lifecycle_stubs(channels[side])["artifacts"](reqs())
        got[side] = {s.name: s.is_crc_successful for s in out.artifacts}
    assert got["port"] == got["ref"] == {
        "files/a.txt": True, "files/bad.txt": False, "jars/big.jar": True}


def test_plain_execute_is_not_buffered(channels):
    rel = pb.Relation(range=pb.Range(start=0, end=10, step=1))
    for side in SIDES:
        stubs = _lifecycle_stubs(channels[side])
        list(stubs["execute"](pb.ExecutePlanRequest(
            session_id="life-6", operation_id="op-plain-1",
            plan=pb.Plan(root=rel))))
        with pytest.raises(grpc.RpcError) as err:
            list(stubs["reattach"](pb.ReattachExecuteRequest(
                session_id="life-6", operation_id="op-plain-1")))
        assert err.value.code() == grpc.StatusCode.NOT_FOUND, side


def test_interrupt_running_operation_cancels_stream(channels):
    """Interrupting a RUNNING execute surfaces CANCELLED to the consuming
    client, in both packages."""
    rel = pb.Relation(range=pb.Range(start=0, end=3_000_000, step=1))
    T = pb.InterruptRequest.InterruptType
    for side in SIDES:
        stubs = _lifecycle_stubs(channels[side])
        it = stubs["execute"](_reattachable_req("life-7", "op-int-run", rel))
        first = next(it)
        assert first.operation_id == "op-int-run"
        out = stubs["interrupt"](pb.InterruptRequest(
            session_id="life-7",
            interrupt_type=T.INTERRUPT_TYPE_OPERATION_ID,
            operation_id="op-int-run"))
        assert list(out.interrupted_ids) == ["op-int-run"], side
        with pytest.raises(grpc.RpcError) as err:
            for _ in it:
                pass
        assert err.value.code() == grpc.StatusCode.CANCELLED, side


# ------------------------------------------------------------ port-only

def test_descriptor_is_byte_identical_to_the_reference():
    """One ``spark_connect_subset.proto`` in protobuf's default pool: the
    port's serialized descriptor equals the reference's, so both modules
    load in one process and share their message classes."""
    assert pb.DESCRIPTOR.serialized_pb == ref_pb.DESCRIPTOR.serialized_pb
    assert pb.DESCRIPTOR.name == "spark_connect_subset.proto"
    assert pb.DESCRIPTOR.package == "spark.connect"
    assert pb.ExecutePlanRequest is ref_pb.ExecutePlanRequest


def test_in_process_transport_gives_the_grpc_answers(channels):
    """The handlers called in-process (no gRPC) answer as the gRPC server
    does, and abort with the same status codes."""
    svc = SparkConnectService()
    rel = pb.Relation(aggregate=pb.Aggregate(
        input=pb.Relation(range=pb.Range(end=10, step=1)),
        group_type=pb.Aggregate.GROUP_TYPE_GROUPBY,
        aggregate_expressions=[pb.Expression(alias=pb.Expression.Alias(
            expr=_fn("sum", _attr("id")), name=["s"]))]))
    req = pb.ExecutePlanRequest(session_id="ip", plan=pb.Plan(root=rel))
    tables = []
    for resp in svc.call("ExecutePlan", req):
        if resp.WhichOneof("response_type") == "arrow_batch":
            with pa.ipc.open_stream(
                    pa.BufferReader(resp.arrow_batch.data)) as r:
                tables.append(r.read_all())
    assert pa.concat_tables(tables).to_pydict() == \
        _execute(channels["port"], rel).to_pydict() == {"s": [45]}
    with pytest.raises(ConnectAbort) as ei:
        list(svc.call("ExecutePlan", pb.ExecutePlanRequest(
            session_id="ip", plan=pb.Plan(root=pb.Relation()))))
    assert ei.value.code() is StatusCode.UNIMPLEMENTED
    with pytest.raises(ConnectAbort) as ei:
        list(svc.call("ReattachExecute", pb.ReattachExecuteRequest(
            session_id="ip", operation_id="nope")))
    assert ei.value.code() is StatusCode.NOT_FOUND
    v = svc.call("AnalyzePlan", pb.AnalyzePlanRequest(
        session_id="ip", spark_version=pb.AnalyzePlanRequest.SparkVersion()))
    assert "daft-torch" in v.spark_version.version

"""Vendored minimal Spark Connect CLIENT, pyspark-flavored.

The port's copy of ``daft_tpu/connect/client.py``. pyspark is not
installable in every environment, so wire-compatibility is validated by
this vendored client: it mirrors the pyspark Spark Connect client's
REQUEST PATTERNS (a ``SparkSession``-style entry point, ``UserContext``
and ``client_type`` on every request, ``AnalyzePlan(schema)`` before a
``.schema`` access, streaming ``ExecutePlan`` with Arrow-IPC batch decode,
Column-expression building via ``UnresolvedFunction`` /
``UnresolvedAttribute``, exactly the proto shapes
``pyspark.sql.connect.expressions`` emits) against the server's proto
subset.

Two transports: ``connect(address)`` speaks gRPC to a server (needs
``grpcio``); ``connect_in_process(service)`` calls a
:class:`~daft_tpu_torch.connect.SparkConnectService`'s handlers in this
process, each request and response through the wire format (needs
``protobuf`` only)::

    from daft_tpu_torch.connect.client import connect
    spark = connect("127.0.0.1:15002")
    spark.sql("SELECT 1 AS x").collect()

The port's client adds ``interrupt``, ``release`` and reattachable
executions with a caller-chosen operation id (``execute_arrow``). Known incompatibilities with a full
pyspark client (the proto SUBSET omits them): artifact transfer (UDF
pickles), streaming queries, and the full literal/datatype matrix.
"""

from __future__ import annotations

import io
import uuid
from typing import Any, Dict, List, Optional

import pyarrow as pa

from . import spark_connect_subset_pb2 as pb
from .server import _METHODS

_SERVICE = "/spark.connect.SparkConnectService/"
_CLIENT_TYPE = "daft-torch vendored pyspark-connect client"


# ------------------------------------------------------------ expressions

class Column:
    """pyspark.sql.Column lookalike building Spark Connect proto exprs."""

    def __init__(self, expr: pb.Expression):
        self._expr = expr

    @staticmethod
    def _lit(v) -> "Column":
        if isinstance(v, Column):
            return v
        lit = pb.Expression.Literal()
        if isinstance(v, bool):
            lit.boolean = v
        elif isinstance(v, int):
            lit.long = v
        elif isinstance(v, float):
            lit.double = v
        elif isinstance(v, str):
            lit.string = v
        else:
            raise TypeError(f"unsupported literal {type(v)}")
        return Column(pb.Expression(literal=lit))

    def _fn(self, name: str, *args) -> "Column":
        return Column(pb.Expression(
            unresolved_function=pb.Expression.UnresolvedFunction(
                function_name=name,
                arguments=[self._expr] + [Column._lit(a)._expr
                                          for a in args])))

    def __gt__(self, o): return self._fn(">", o)
    def __ge__(self, o): return self._fn(">=", o)
    def __lt__(self, o): return self._fn("<", o)
    def __le__(self, o): return self._fn("<=", o)
    def __eq__(self, o): return self._fn("==", o)  # noqa: comparison API
    def __ne__(self, o): return self._fn("!=", o)
    def __add__(self, o): return self._fn("+", o)
    def __sub__(self, o): return self._fn("-", o)
    def __mul__(self, o): return self._fn("*", o)
    def __truediv__(self, o): return self._fn("/", o)
    def __and__(self, o): return self._fn("and", o)
    def __or__(self, o): return self._fn("or", o)

    def alias(self, name: str) -> "Column":
        return Column(pb.Expression(alias=pb.Expression.Alias(
            expr=self._expr, name=[name])))


def col(name: str) -> Column:
    return Column(pb.Expression(
        unresolved_attribute=pb.Expression.UnresolvedAttribute(
            unparsed_identifier=name)))


def lit(v) -> Column:
    return Column._lit(v)


_DT_PRIMITIVES = {
    "null": pa.null(), "binary": pa.large_binary(), "boolean": pa.bool_(),
    "byte": pa.int8(), "short": pa.int16(), "integer": pa.int32(),
    "long": pa.int64(), "float": pa.float32(), "double": pa.float64(),
    "string": pa.large_string(), "date": pa.date32(),
    "timestamp": pa.timestamp("us", "UTC"),
    "timestamp_ntz": pa.timestamp("us"),
}


def _datatype_to_arrow(dt: "pb.DataType") -> pa.DataType:
    kind = dt.WhichOneof("kind")
    if kind in _DT_PRIMITIVES:
        return _DT_PRIMITIVES[kind]
    if kind == "decimal":
        return pa.decimal128(dt.decimal.precision or 38,
                             dt.decimal.scale or 0)
    if kind == "array":
        return pa.large_list(_datatype_to_arrow(dt.array.element_type))
    if kind == "map":
        return pa.map_(_datatype_to_arrow(dt.map.key_type),
                       _datatype_to_arrow(dt.map.value_type))
    if kind == "struct":
        return pa.struct([
            pa.field(f.name, _datatype_to_arrow(f.data_type),
                     nullable=f.nullable) for f in dt.struct.fields])
    raise NotImplementedError(f"DataType kind {kind!r}")


def _datatype_to_arrow_schema(dt: "pb.DataType") -> pa.Schema:
    """AnalyzePlan returns the root as a struct DataType — the same shape
    pyspark converts into its StructType; here it becomes a pa.Schema."""
    t = _datatype_to_arrow(dt)
    if not pa.types.is_struct(t):
        raise ValueError(f"schema root is {t}, expected struct")
    return pa.schema(list(t))


def _agg_fn(name: str, c: Column) -> Column:
    return Column(pb.Expression(
        unresolved_function=pb.Expression.UnresolvedFunction(
            function_name=name, arguments=[c._expr])))


# ---------------------------------------------------------------- session

class _GrpcTransport:
    def __init__(self, address: str):
        import grpc
        self._channel = grpc.insecure_channel(address)

    def call(self, method: str, request):
        arity, req_t, resp_t, _ = _METHODS[method]
        stub = getattr(self._channel, arity)(
            _SERVICE + method,
            request_serializer=getattr(pb, req_t).SerializeToString,
            response_deserializer=getattr(pb, resp_t).FromString)
        return stub(request)

    def close(self) -> None:
        self._channel.close()


class _InProcessTransport:
    def __init__(self, service):
        self._service = service

    def call(self, method: str, request):
        return self._service.call(method, request)

    def close(self) -> None:
        pass


class SparkSession:
    """pyspark.sql.SparkSession lookalike over the Connect wire."""

    def __init__(self, address: Optional[str] = None, transport=None):
        self._transport = transport if transport is not None \
            else _GrpcTransport(address)
        self._session_id = str(uuid.uuid4())
        self._user = pb.UserContext(user_id="daft_tpu_torch",
                                    user_name="daft_tpu_torch")

    @property
    def session_id(self) -> str:
        return self._session_id

    # -- RPC plumbing (the pyspark client's request shapes) -------------
    def _execute_plan(self, plan: pb.Plan,
                      operation_id: Optional[str] = None,
                      reattachable: bool = False) -> pa.Table:
        req = pb.ExecutePlanRequest(
            session_id=self._session_id, user_context=self._user,
            operation_id=operation_id or str(uuid.uuid4()),
            client_type=_CLIENT_TYPE, plan=plan)
        if reattachable:
            req.request_options.add().reattach_options.reattachable = True
        tables = []
        complete = False
        for resp in self._transport.call("ExecutePlan", req):
            kind = resp.WhichOneof("response_type")
            if kind == "arrow_batch":
                with pa.ipc.open_stream(
                        pa.BufferReader(resp.arrow_batch.data)) as r:
                    tables.append(r.read_all())
            elif kind == "result_complete":
                complete = True
        if not complete:
            raise RuntimeError("server stream ended without ResultComplete")
        if not tables:
            return pa.table({})
        return pa.concat_tables(tables)

    def _analyze(self, **kwargs) -> pb.AnalyzePlanResponse:
        return self._transport.call("AnalyzePlan", pb.AnalyzePlanRequest(
            session_id=self._session_id, user_context=self._user,
            client_type=_CLIENT_TYPE, **kwargs))

    def interrupt(self, operation_id: Optional[str] = None) -> List[str]:
        """Interrupt one running operation (or all of this session's when
        ``operation_id`` is None); the ids the server interrupted."""
        T = pb.InterruptRequest.InterruptType
        req = pb.InterruptRequest(
            session_id=self._session_id, user_context=self._user,
            client_type=_CLIENT_TYPE,
            interrupt_type=(T.INTERRUPT_TYPE_ALL if operation_id is None
                            else T.INTERRUPT_TYPE_OPERATION_ID))
        if operation_id is not None:
            req.operation_id = operation_id
        return list(self._transport.call("Interrupt", req).interrupted_ids)

    def release(self, operation_id: str) -> str:
        """ReleaseExecute(release_all) of one reattachable operation."""
        return self._transport.call("ReleaseExecute", pb.ReleaseExecuteRequest(
            session_id=self._session_id, user_context=self._user,
            client_type=_CLIENT_TYPE, operation_id=operation_id,
            release_all=pb.ReleaseExecuteRequest.ReleaseAll())).operation_id

    # -- public API ------------------------------------------------------
    def range(self, end: int, start: int = 0, step: int = 1) -> "DataFrame":
        return DataFrame(self, pb.Relation(
            range=pb.Range(start=start, end=end, step=step)))

    def sql(self, query: str) -> "DataFrame":
        return DataFrame(self, pb.Relation(sql=pb.SQL(query=query)))

    def createDataFrame(self, data: Dict[str, list]) -> "DataFrame":
        t = pa.table(data)
        buf = io.BytesIO()
        with pa.ipc.new_stream(buf, t.schema) as w:
            w.write_table(t)
        return DataFrame(self, pb.Relation(
            local_relation=pb.LocalRelation(data=buf.getvalue())))

    def read_parquet(self, path: str) -> "DataFrame":
        ds = pb.Read.DataSource(format="parquet", paths=[path])
        return DataFrame(self, pb.Relation(read=pb.Read(data_source=ds)))

    @property
    def version(self) -> str:
        r = self._analyze(spark_version=pb.AnalyzePlanRequest.SparkVersion())
        return r.spark_version.version

    def stop(self):
        self._transport.close()


def connect(address: str) -> SparkSession:
    """A session over gRPC to ``host:port`` (or ``sc://host:port``)."""
    if address.startswith("sc://"):
        address = address[len("sc://"):]
    return SparkSession(address)


def connect_in_process(service) -> SparkSession:
    """A session calling ``service``'s handlers in this process."""
    return SparkSession(transport=_InProcessTransport(service))


# -------------------------------------------------------------- dataframe

class GroupedData:
    def __init__(self, df: "DataFrame", keys: List[Column]):
        self._df = df
        self._keys = keys

    def agg(self, *aggs: Column) -> "DataFrame":
        rel = pb.Relation(aggregate=pb.Aggregate(
            input=self._df._rel,
            group_type=pb.Aggregate.GROUP_TYPE_GROUPBY,
            grouping_expressions=[k._expr for k in self._keys],
            aggregate_expressions=[a._expr for a in aggs]))
        return DataFrame(self._df._session, rel)


class DataFrameWriter:
    def __init__(self, df: "DataFrame"):
        self._df = df

    def parquet(self, path: str, mode: str = "error"):  # pyspark default
        mode_map = {"overwrite": pb.WriteOperation.SAVE_MODE_OVERWRITE,
                    "append": pb.WriteOperation.SAVE_MODE_APPEND,
                    "error": pb.WriteOperation.SAVE_MODE_ERROR_IF_EXISTS,
                    "ignore": pb.WriteOperation.SAVE_MODE_IGNORE}
        cmd = pb.Command(write_operation=pb.WriteOperation(
            input=self._df._rel, source="parquet", path=path,
            mode=mode_map[mode]))
        self._df._session._execute_plan(pb.Plan(command=cmd))


class DataFrame:
    def __init__(self, session: SparkSession, rel: pb.Relation):
        self._session = session
        self._rel = rel

    def filter(self, cond: Column) -> "DataFrame":
        return DataFrame(self._session, pb.Relation(
            filter=pb.Filter(input=self._rel, condition=cond._expr)))

    where = filter

    def select(self, *cols) -> "DataFrame":
        exprs = [c._expr if isinstance(c, Column) else col(c)._expr
                 for c in cols]
        return DataFrame(self._session, pb.Relation(
            project=pb.Project(input=self._rel, expressions=exprs)))

    def withColumn(self, name: str, c: Column) -> "DataFrame":
        alias = pb.Expression.Alias(expr=c._expr, name=[name])
        return DataFrame(self._session, pb.Relation(
            with_columns=pb.WithColumns(
                input=self._rel, aliases=[alias])))

    def groupBy(self, *keys) -> GroupedData:
        ks = [k if isinstance(k, Column) else col(k) for k in keys]
        return GroupedData(self, ks)

    def join(self, other: "DataFrame", on: str,
             how: str = "inner") -> "DataFrame":
        how_map = {"inner": pb.Join.JOIN_TYPE_INNER,
                   "left": pb.Join.JOIN_TYPE_LEFT_OUTER,
                   "right": pb.Join.JOIN_TYPE_RIGHT_OUTER,
                   "outer": pb.Join.JOIN_TYPE_FULL_OUTER,
                   "semi": pb.Join.JOIN_TYPE_LEFT_SEMI,
                   "anti": pb.Join.JOIN_TYPE_LEFT_ANTI}
        return DataFrame(self._session, pb.Relation(join=pb.Join(
            left=self._rel, right=other._rel,
            join_type=how_map[how], using_columns=[on])))

    def sort(self, *keys: str) -> "DataFrame":
        SO = pb.Expression.SortOrder
        orders = [SO(child=col(k)._expr,
                     direction=SO.SORT_DIRECTION_ASCENDING)
                  for k in keys]
        return DataFrame(self._session, pb.Relation(
            sort=pb.Sort(input=self._rel, order=orders)))

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(self._session, pb.Relation(
            limit=pb.Limit(input=self._rel, limit=n)))

    def createOrReplaceTempView(self, name: str):
        cmd = pb.Command(
            create_dataframe_view=pb.CreateDataFrameViewCommand(
                input=self._rel, name=name, replace=True))
        self._session._execute_plan(pb.Plan(command=cmd))

    @property
    def write(self) -> DataFrameWriter:
        return DataFrameWriter(self)

    @property
    def schema(self) -> pa.Schema:
        r = self._session._analyze(schema=pb.AnalyzePlanRequest.Schema(
            plan=pb.Plan(root=self._rel)))
        return _datatype_to_arrow_schema(r.schema.schema)

    def collect(self) -> List[dict]:
        return self.toArrow().to_pylist()

    def toArrow(self) -> pa.Table:
        return self._session._execute_plan(pb.Plan(root=self._rel))

    def execute_arrow(self, operation_id: Optional[str] = None,
                      reattachable: bool = False) -> pa.Table:
        """``toArrow`` under a caller-chosen operation id, optionally
        reattachable (the server then retains its responses until
        ``SparkSession.release``)."""
        return self._session._execute_plan(
            pb.Plan(root=self._rel), operation_id=operation_id,
            reattachable=reattachable)

    def toPandas(self):
        return self.toArrow().to_pandas()

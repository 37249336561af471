"""Embedded Spark Connect server.

The port's copy of ``daft_tpu/connect/server.py`` (reference capability:
``src/daft-connect/src/connect_service.rs:235-334``, a tonic
``SparkConnectService`` whose ``execute_plan`` / ``analyze_plan`` /
``config`` translate Spark protos through the engine and stream Arrow
batches back). The handlers live in :class:`SparkConnectService`, which
needs no transport: :class:`SparkConnectServer` mounts them on grpc's
generic method handlers, so a Spark Connect client can point at
``sc://host:port``; without ``grpcio`` they are called in-process with
``pb`` requests and an :class:`InProcessContext`.

Usage::

    from daft_tpu_torch.connect import start_server
    server = start_server()           # SparkConnectServer, .port/.address
    ...
    server.stop()
"""

from __future__ import annotations

import enum
import io
import threading
import time
import uuid
from typing import Dict, Iterator, Optional

import pyarrow as pa

from .. import knobs
from . import spark_connect_subset_pb2 as pb
from .analyzer import (SparkAnalyzer, Unsupported, dtype_to_proto, parse_ddl,
                       schema_to_proto)

_SERVICE = "spark.connect.SparkConnectService"
_VERSION = "3.5.1+daft-torch"

# rows per streamed ArrowBatch message (Spark chunks large results the same
# way; grpc messages default-cap at 4MB)
_BATCH_ROWS = 1 << 16


class StatusCode(enum.Enum):
    """The gRPC status codes the handlers raise, for the in-process
    transport (the gRPC server passes ``grpc.StatusCode`` instead)."""

    CANCELLED = "cancelled"
    INVALID_ARGUMENT = "invalid argument"
    NOT_FOUND = "not found"
    RESOURCE_EXHAUSTED = "resource exhausted"
    UNIMPLEMENTED = "unimplemented"
    INTERNAL = "internal"
    UNAVAILABLE = "unavailable"


class ConnectAbort(Exception):
    """An in-process call's abort: the status a gRPC client would see,
    with ``grpc.RpcError``'s ``code()`` and ``details()``."""

    def __init__(self, code, details: str):
        super().__init__(f"{code}: {details}")
        self._code, self._details = code, details

    def code(self):
        return self._code

    def details(self) -> str:
        return self._details


class InProcessContext:
    """The servicer context of an in-process call: ``abort`` raises
    :class:`ConnectAbort`, trailing metadata is kept for the caller."""

    def __init__(self):
        self.trailing_metadata = ()

    def abort(self, code, details: str):
        raise ConnectAbort(code, details)

    def set_trailing_metadata(self, md) -> None:
        self.trailing_metadata = tuple(md)


class _Operation:
    """Lifecycle record for one ExecutePlan.

    Responses are buffered ONLY for reattachable executions (the client
    opted in via ``ReattachOptions`` — Spark's own rule; buffering every
    plain execute would pin each query's whole result in session RAM),
    retained until the client RELEASES them, so a dropped connection can
    REATTACH and resume from its last response id. INTERRUPT flips the
    cancel flag, honored between streamed batches (a batch mid-kernel
    finishes). A failure is recorded as (code, message) and re-raised to
    reattaching clients — a truncated replay that ends cleanly would read
    as a complete result."""

    def __init__(self, op_id: str, tags, reattachable: bool):
        self.op_id = op_id
        self.tags = set(tags or ())
        self.reattachable = reattachable
        self.cancel = threading.Event()
        self.done = threading.Event()
        self.cond = threading.Condition()
        self.buffer: list = []          # ExecutePlanResponse, in order
        self.base = 0                   # absolute index of buffer[0] —
        #                                 released prefixes are DELETED
        #                                 (a release must actually free
        #                                 the acknowledged bytes)
        self.error = None               # (grpc code, message) on failure
        self.finished_at: Optional[float] = None  # monotonic; sweep clock
        self.retained_bytes = 0         # serialized bytes in self.buffer
        self._cancel_cbs: list = []     # real cancellation hooks (the
        #                                 serving scheduler's handle)

    def bind_cancel(self, fn) -> None:
        """Register a callback fired on INTERRUPT — wires the client's
        cancel through to the scheduler's cooperative CancelToken so a
        running query actually unwinds (not just the response stream)."""
        fire_now = False
        with self.cond:
            if self.cancel.is_set():
                fire_now = True
            else:
                self._cancel_cbs.append(fn)
        if fire_now:
            try:
                fn()
            except Exception:
                pass

    def request_cancel(self) -> None:
        with self.cond:
            self.cancel.set()
            cbs = list(self._cancel_cbs)
        for fn in cbs:
            try:
                fn()
            except Exception:
                pass

    def record(self, r) -> None:
        if not self.reattachable:
            return
        with self.cond:
            self.buffer.append(r)
            self.retained_bytes += r.ByteSize()
            self.cond.notify_all()

    def finish(self, error=None) -> None:
        with self.cond:
            if error is not None and self.error is None:
                self.error = error
            if self.finished_at is None:
                self.finished_at = time.monotonic()
            self.done.set()
            self.cond.notify_all()

    def total(self) -> int:
        """Absolute count of responses produced so far."""
        return self.base + len(self.buffer)

    def after(self, last_response_id: Optional[str]):
        """(responses after the given id — all retained when None, the
        released prefix is gone), absolute high-water mark."""
        with self.cond:
            start = self.base
            if last_response_id:
                for i in range(len(self.buffer) - 1, -1, -1):
                    if self.buffer[i].response_id == last_response_id:
                        start = self.base + i + 1
                        break
            return list(self.buffer[start - self.base:]), self.total()

    def release_until(self, response_id: str) -> None:
        with self.cond:
            for i, r in enumerate(self.buffer):
                if r.response_id == response_id:
                    self.retained_bytes -= sum(
                        b.ByteSize() for b in self.buffer[:i + 1])
                    del self.buffer[:i + 1]
                    self.base += i + 1
                    break


class _SessionState:
    def __init__(self):
        self.config: Dict[str, str] = {}
        self.views: Dict[str, object] = {}
        self.artifacts: Dict[str, bytes] = {}
        self.operations: Dict[str, _Operation] = {}
        self.server_side_id = uuid.uuid4().hex

    @property
    def analyzer(self) -> SparkAnalyzer:
        return SparkAnalyzer(self.views)


#: RPC name → (arity, request type, response type, handler attribute)
_METHODS = {
    "ExecutePlan": ("unary_stream", "ExecutePlanRequest",
                    "ExecutePlanResponse", "_execute_plan"),
    "AnalyzePlan": ("unary_unary", "AnalyzePlanRequest",
                    "AnalyzePlanResponse", "_analyze_plan"),
    "Config": ("unary_unary", "ConfigRequest", "ConfigResponse", "_config"),
    "AddArtifacts": ("stream_unary", "AddArtifactsRequest",
                     "AddArtifactsResponse", "_add_artifacts"),
    "Interrupt": ("unary_unary", "InterruptRequest", "InterruptResponse",
                  "_interrupt"),
    "ReattachExecute": ("unary_stream", "ReattachExecuteRequest",
                        "ExecutePlanResponse", "_reattach_execute"),
    "ReleaseExecute": ("unary_unary", "ReleaseExecuteRequest",
                       "ReleaseExecuteResponse", "_release_execute"),
}


class SparkConnectService:
    """The Spark Connect handlers and their session state, without a
    transport. ``codes`` is the status-code namespace the handlers abort
    with: :class:`StatusCode` in-process, ``grpc.StatusCode`` under the
    gRPC server."""

    def __init__(self, codes=StatusCode):
        self._codes = codes
        self._sessions: Dict[str, _SessionState] = {}
        self._lock = threading.Lock()

    def handler(self, method: str):
        """The bound handler of one RPC (``handler(name)(request,
        context)``)."""
        return getattr(self, _METHODS[method][3])

    def call(self, method: str, request):
        """One in-process call: the request and every response cross the
        wire format (serialized and parsed), as over gRPC. Unary calls
        return the response, streaming ones a list of responses; an abort
        raises :class:`ConnectAbort`."""
        arity, req_t, resp_t, _ = _METHODS[method]
        parse_req = getattr(pb, req_t).FromString
        parse_resp = getattr(pb, resp_t).FromString
        if arity == "stream_unary":
            request = iter([parse_req(r.SerializeToString())
                            for r in request])
        else:
            request = parse_req(request.SerializeToString())
        out = self.handler(method)(request, InProcessContext())
        if arity == "unary_stream":
            return (parse_resp(r.SerializeToString()) for r in out)
        return parse_resp(out.SerializeToString())

    def sessions(self) -> list:
        with self._lock:
            return list(self._sessions)

    def release_session(self, session_id: str) -> bool:
        """Fleet handoff: drop this session's server-side state NOW.
        The 60s idle-TTL sweeps (the scheduler's session reaper and the
        finished-operation sweep) would reclaim it eventually; on a
        handoff the re-homed session must not leak a queue or pinned
        response buffers on the OLD replica for even that long. Running
        operations are interrupted (their scheduler handles cancel
        cooperatively), buffers are dropped with the session state, and
        the scheduler's session queue is released. True when any state
        existed."""
        with self._lock:
            st = self._sessions.pop(session_id, None)
        if st is not None:
            for op in list(st.operations.values()):
                op.request_cancel()
        released = st is not None
        from .. import serving
        sched = serving.shared_scheduler_if_running()
        if sched is not None:
            released = sched.release_session(session_id) or released
        return released

    # ------------------------------------------------------------ helpers
    def _session(self, session_id: str) -> _SessionState:
        with self._lock:
            st = self._sessions.get(session_id)
            if st is None:
                st = self._sessions[session_id] = _SessionState()
            self._sweep_operations_locked(st)
            return st

    @staticmethod
    def _sweep_operations_locked(st: _SessionState) -> None:
        """Bound finished-operation retention. Finished reattachable
        operations hold their whole response buffer until the client
        RELEASEs them; a client that never does (crashed, lazy) used to
        pin every result it ever produced for the life of the session.
        Two bounds, swept opportunistically on every RPC that touches the
        session: a TTL after finish (``DAFT_TORCH_SERVE_OP_TTL``) and a
        per-session retained-byte budget (``DAFT_TORCH_SERVE_OP_RETAIN_BYTES``,
        newest kept first). Running operations are never swept; a swept
        operation reattaches as NOT_FOUND, same as an explicit release."""
        ttl = knobs.env_float("DAFT_TORCH_SERVE_OP_TTL")
        cap = knobs.env_bytes("DAFT_TORCH_SERVE_OP_RETAIN_BYTES")
        now = time.monotonic()
        finished = [(op.finished_at, oid, op)
                    for oid, op in st.operations.items()
                    if op.done.is_set() and op.finished_at is not None]
        if ttl and ttl > 0:
            for t, oid, _op in finished:
                if now - t > ttl:
                    st.operations.pop(oid, None)
        if cap and cap > 0:
            kept = 0
            still = sorted(((op.finished_at, oid, op)
                            for oid, op in st.operations.items()
                            if op.done.is_set()
                            and op.finished_at is not None),
                           key=lambda x: x[0], reverse=True)
            for _t, oid, op in still:
                kept += max(op.retained_bytes, 0)
                if kept > cap:
                    st.operations.pop(oid, None)

    def _abort(self, context, exc: Exception):
        from ..execution.cancellation import QueryCancelled
        from ..fleet.router import ReplicaUnavailable
        from ..serving import AdmissionRejected
        codes = self._codes
        if isinstance(exc, Unsupported):
            context.abort(codes.UNIMPLEMENTED,
                          f"unsupported by daft_tpu_torch connect: {exc}")
        if isinstance(exc, ReplicaUnavailable):
            # a dead-replica routed session is a RETRYABLE condition, not
            # an internal error: structured UNAVAILABLE + retry-info (the
            # delay rides trailing metadata AND the message, so clients
            # without metadata plumbing still see it)
            try:
                context.set_trailing_metadata((
                    ("retry-delay-ms",
                     str(int(exc.retry_after_s * 1000))),))
            except Exception:
                pass
            context.abort(
                codes.UNAVAILABLE,
                f"replica unavailable, retry in {exc.retry_after_s:.1f}s "
                f"(retry-info: retry-delay-ms="
                f"{int(exc.retry_after_s * 1000)}): {exc}")
        if isinstance(exc, AdmissionRejected):
            context.abort(codes.RESOURCE_EXHAUSTED,
                          f"admission rejected ({exc.kind}): {exc}")
        if isinstance(exc, QueryCancelled):
            context.abort(codes.CANCELLED, str(exc))
        context.abort(codes.INTERNAL, f"{type(exc).__name__}: "
                      f"{exc}")

    # ----------------------------------------------------------- execute
    def _execute_plan(self, request: pb.ExecutePlanRequest, context
                      ) -> Iterator[pb.ExecutePlanResponse]:
        st = self._session(request.session_id)
        op_id = request.operation_id or str(uuid.uuid4())
        reattachable = any(
            o.WhichOneof("request_option") == "reattach_options"
            and o.reattach_options.reattachable
            for o in request.request_options)
        op = _Operation(op_id, request.tags, reattachable)
        with self._lock:
            st.operations[op_id] = op

        def resp() -> pb.ExecutePlanResponse:
            r = pb.ExecutePlanResponse()
            r.session_id = request.session_id
            r.server_side_session_id = st.server_side_id
            r.operation_id = op_id
            r.response_id = str(uuid.uuid4())
            return r

        aborting = False
        try:
            which = request.plan.WhichOneof("op_type")
            if which == "command":
                gen = self._execute_command(request.plan.command, st, resp)
            else:
                df = st.analyzer.plan_to_df(request.plan)
                gen = self._stream_df(df, resp, op=op,
                                      session_id=request.session_id)
            for r in gen:
                if op.cancel.is_set():
                    op.finish(error=(self._codes.CANCELLED,
                                     f"operation {op_id} interrupted"))
                    aborting = True
                    context.abort(self._codes.CANCELLED,
                                  f"operation {op_id} interrupted")
                op.record(r)
                yield r
            done = resp()
            done.result_complete.SetInParent()
            op.record(done)
            op.finish()
            yield done
        except Exception as exc:  # noqa: BLE001 - surfaced via grpc status
            if aborting:  # context.abort's unwind exception — re-raise
                raise
            from ..execution.cancellation import QueryCancelled
            from ..fleet.router import ReplicaUnavailable
            from ..serving import AdmissionRejected
            code = self._codes.INTERNAL
            if isinstance(exc, QueryCancelled):
                code = self._codes.CANCELLED
            elif isinstance(exc, AdmissionRejected):
                code = self._codes.RESOURCE_EXHAUSTED
            elif isinstance(exc, ReplicaUnavailable):
                code = self._codes.UNAVAILABLE
            op.finish(error=(code, f"{type(exc).__name__}: {exc}"))
            self._abort(context, exc)
        finally:
            # covers GeneratorExit (client disconnected mid-stream): a
            # reattacher must never wait on an operation whose producer is
            # gone, and a truncated buffer must not replay as a clean
            # result — record an explicit status
            if not op.done.is_set():
                op.finish(error=(
                    self._codes.UNAVAILABLE,
                    f"operation {op_id}'s producer disconnected before "
                    f"completion"))
            if not reattachable:
                with self._lock:
                    st.operations.pop(op_id, None)

    # ------------------------------------------- operation-lifecycle RPCs
    def _interrupt(self, request: pb.InterruptRequest, context
                   ) -> pb.InterruptResponse:
        st = self._session(request.session_id)
        out = pb.InterruptResponse()
        out.session_id = request.session_id
        out.server_side_session_id = st.server_side_id
        T = pb.InterruptRequest.InterruptType
        with self._lock:
            ops = list(st.operations.values())
        for op in ops:
            if op.done.is_set():
                continue
            hit = (request.interrupt_type == T.INTERRUPT_TYPE_ALL
                   or (request.interrupt_type
                       == T.INTERRUPT_TYPE_OPERATION_ID
                       and op.op_id == request.operation_id)
                   or (request.interrupt_type == T.INTERRUPT_TYPE_TAG
                       and request.operation_tag in op.tags))
            if hit:
                # fires the scheduler handle's CancelToken too: the
                # running executor unwinds at its next morsel boundary
                # and releases its memory admission
                op.request_cancel()
                out.interrupted_ids.append(op.op_id)
        return out

    def _reattach_execute(self, request: pb.ReattachExecuteRequest, context
                          ) -> Iterator[pb.ExecutePlanResponse]:
        st = self._session(request.session_id)
        with self._lock:
            op = st.operations.get(request.operation_id)
        if op is None:
            context.abort(
                self._codes.NOT_FOUND,
                f"operation {request.operation_id!r} not found "
                f"(never started, not reattachable, or released)")
        if not op.reattachable:
            context.abort(
                self._codes.INVALID_ARGUMENT,
                f"operation {request.operation_id!r} was not started with "
                f"ReattachOptions.reattachable")
        pending, seen = op.after(request.last_response_id or None)
        yield from pending
        # still running: follow the buffer via the producer's condition
        # variable (never holding it across a yield — a slow client must
        # not block Release/Interrupt on this operation). ``seen`` is the
        # ABSOLUTE high-water mark; released prefixes shift op.base.
        while True:
            with op.cond:
                op.cond.wait_for(
                    lambda: op.done.is_set() or op.total() > seen)
                fresh = list(op.buffer[max(0, seen - op.base):])
                seen = op.total()
                finished = op.done.is_set()
            yield from fresh
            if finished and seen >= op.total():
                break
        if op.error is not None:
            context.abort(op.error[0], op.error[1])

    def _release_execute(self, request: pb.ReleaseExecuteRequest, context
                         ) -> pb.ReleaseExecuteResponse:
        st = self._session(request.session_id)
        out = pb.ReleaseExecuteResponse()
        out.session_id = request.session_id
        out.server_side_session_id = st.server_side_id
        out.operation_id = request.operation_id
        with self._lock:
            op = st.operations.get(request.operation_id)
        if op is None:
            return out  # releasing an unknown/already-released op is a no-op
        if request.WhichOneof("release") == "release_until":
            op.release_until(request.release_until.response_id)
        else:  # release_all (and unset, which clients treat the same)
            with self._lock:
                st.operations.pop(request.operation_id, None)
        return out

    def _add_artifacts(self, request_iterator, context
                       ) -> pb.AddArtifactsResponse:
        import zlib
        out = pb.AddArtifactsResponse()
        cur_name: Optional[str] = None
        cur_parts: list = []
        cur_ok = True
        cur_expect = (0, 0)  # (num_chunks, total_bytes) promised by begin
        st = None

        def finish_chunked():
            nonlocal cur_name, cur_parts, cur_ok
            if cur_name is None:
                return
            data = b"".join(cur_parts)
            # a truncated upload (client died mid-stream) must not be
            # stored as clean: the begin message promised the shape
            complete = (len(cur_parts) == cur_expect[0]
                        and len(data) == cur_expect[1])
            ok = cur_ok and complete
            if ok:  # corrupt/incomplete uploads are reported, never stored
                st.artifacts[cur_name] = data
            s = out.artifacts.add()
            s.name = cur_name
            s.is_crc_successful = ok
            cur_name, cur_parts, cur_ok = None, [], True

        for req in request_iterator:
            if st is None:
                st = self._session(req.session_id)
                out.session_id = req.session_id
                out.server_side_session_id = st.server_side_id
            which = req.WhichOneof("payload")
            if which == "batch":
                finish_chunked()
                for a in req.batch.artifacts:
                    ok = zlib.crc32(a.data.data) == a.data.crc
                    if ok:  # corrupt uploads are reported, never stored
                        st.artifacts[a.name] = a.data.data
                    s = out.artifacts.add()
                    s.name = a.name
                    s.is_crc_successful = ok
            elif which == "begin_chunk":
                finish_chunked()
                b = req.begin_chunk
                cur_name = b.name
                cur_parts = [b.initial_chunk.data]
                cur_expect = (b.num_chunks, b.total_bytes)
                cur_ok = zlib.crc32(b.initial_chunk.data) \
                    == b.initial_chunk.crc
            elif which == "chunk" and cur_name is not None:
                cur_parts.append(req.chunk.data)
                cur_ok = cur_ok and zlib.crc32(req.chunk.data) \
                    == req.chunk.crc
        if st is not None:
            finish_chunked()
        return out

    def _stream_df(self, df, resp, op: Optional[_Operation] = None,
                   session_id: str = "default"
                   ) -> Iterator[pb.ExecutePlanResponse]:
        # ExecutePlan routes through the process-shared query scheduler:
        # every Spark Connect session becomes a serving-plane session
        # (weighted fair queuing + admission control across clients), and
        # INTERRUPT cancels the RUNNING query cooperatively through the
        # handle, not just the response stream. With a fleet router
        # installed the session is consistent-hashed onto a replica
        # instead (sticky; re-routed on replica death/drain).
        from .. import fleet, serving
        router = fleet.installed_router()
        if router is not None:
            handle = router.submit(df, session=session_id)
        else:
            handle = serving.shared_scheduler().submit(
                df, session=session_id)
        if op is not None:
            op.bind_cancel(handle.cancel)
        ps = handle.result()
        table = ps.to_recordbatch().to_arrow_table()
        first = resp()
        first.schema.CopyFrom(schema_to_proto(df.schema()))
        start = 0
        emitted = False
        for chunk_start in range(0, max(table.num_rows, 1), _BATCH_ROWS):
            chunk = table.slice(chunk_start, _BATCH_ROWS)
            if chunk.num_rows == 0 and emitted:
                break
            r = first if not emitted else resp()
            sink = io.BytesIO()
            with pa.ipc.new_stream(sink, table.schema) as w:
                w.write_table(chunk)
            r.arrow_batch.row_count = chunk.num_rows
            r.arrow_batch.data = sink.getvalue()
            r.arrow_batch.start_offset = start
            start += chunk.num_rows
            emitted = True
            yield r

    def _execute_command(self, cmd: pb.Command, st: _SessionState, resp
                         ) -> Iterator[pb.ExecutePlanResponse]:
        which = cmd.WhichOneof("command_type")
        if which == "sql_command":
            # queries stay lazy: hand back a relation the client re-submits
            # (Spark's behavior for SELECTs); daft_tpu_torch SQL is query-only so
            # every statement takes this path.
            rel = (cmd.sql_command.input if
                   cmd.sql_command.HasField("input") else
                   pb.Relation(sql=pb.SQL(query=cmd.sql_command.sql)))
            r = resp()
            r.sql_command_result.relation.CopyFrom(rel)
            yield r
            return
        if which == "create_dataframe_view":
            c = cmd.create_dataframe_view
            name = c.name
            if name in st.views and not c.replace:
                raise Unsupported(f"view {name!r} exists (replace=False)")
            st.views[name] = st.analyzer.relation_to_df(c.input)
            return
        if which == "write_operation":
            self._write(cmd.write_operation, st)
            return
        raise Unsupported(f"command {which!r}")

    def _write(self, w: pb.WriteOperation, st: _SessionState) -> None:
        import os

        df = st.analyzer.relation_to_df(w.input)
        fmt = (w.source or "parquet").lower()
        if w.WhichOneof("save_type") != "path":
            raise Unsupported("write without path (saveAsTable)")
        M = pb.WriteOperation
        exists = os.path.exists(w.path) and bool(os.listdir(w.path)) \
            if os.path.isdir(w.path) else os.path.exists(w.path)
        # Spark's default mode is errorifexists; honor it and IGNORE
        # rather than silently appending
        if w.mode in (M.SAVE_MODE_ERROR_IF_EXISTS,
                      M.SAVE_MODE_UNSPECIFIED) and exists:
            raise FileExistsError(
                f"path {w.path!r} already exists (write mode errorifexists)")
        if w.mode == M.SAVE_MODE_IGNORE and exists:
            return
        mode = ("overwrite" if w.mode == M.SAVE_MODE_OVERWRITE
                else "append")
        part_cols = list(w.partitioning_columns)
        if fmt == "parquet":
            df.write_parquet(w.path, write_mode=mode,
                             partition_cols=part_cols or None)
        elif fmt == "csv":
            df.write_csv(w.path, write_mode=mode,
                         partition_cols=part_cols or None)
        elif fmt == "json":
            df.write_json(w.path, write_mode=mode,
                          partition_cols=part_cols or None)
        else:
            raise Unsupported(f"write format {fmt!r}")

    # ----------------------------------------------------------- analyze
    def _analyze_plan(self, request: pb.AnalyzePlanRequest, context
                      ) -> pb.AnalyzePlanResponse:
        st = self._session(request.session_id)
        out = pb.AnalyzePlanResponse()
        out.session_id = request.session_id
        out.server_side_session_id = st.server_side_id
        try:
            which = request.WhichOneof("analyze")
            if which == "schema":
                df = st.analyzer.plan_to_df(request.schema.plan)
                out.schema.schema.CopyFrom(schema_to_proto(df.schema()))
            elif which == "explain":
                df = st.analyzer.plan_to_df(request.explain.plan)
                out.explain.explain_string = _explain_str(df)
            elif which == "tree_string":
                df = st.analyzer.plan_to_df(request.tree_string.plan)
                out.tree_string.tree_string = _explain_str(df)
            elif which == "spark_version":
                out.spark_version.version = _VERSION
            elif which == "ddl_parse":
                out.ddl_parse.parsed.CopyFrom(
                    parse_ddl(request.ddl_parse.ddl_string))
            else:
                raise Unsupported(f"analyze {which!r}")
        except Exception as exc:  # noqa: BLE001
            self._abort(context, exc)
        return out

    # ------------------------------------------------------------ config
    def _config(self, request: pb.ConfigRequest, context
                ) -> pb.ConfigResponse:
        st = self._session(request.session_id)
        out = pb.ConfigResponse()
        out.session_id = request.session_id
        out.server_side_session_id = st.server_side_id
        op = request.operation
        which = op.WhichOneof("op_type")
        if which == "set":
            for kv in op.set.pairs:
                st.config[kv.key] = kv.value if kv.HasField("value") else ""
        elif which == "get":
            for k in op.get.keys:
                kv = out.pairs.add()
                kv.key = k
                if k in st.config:
                    kv.value = st.config[k]
        elif which == "get_with_default":
            for d in op.get_with_default.pairs:
                kv = out.pairs.add()
                kv.key = d.key
                kv.value = st.config.get(
                    d.key, d.value if d.HasField("value") else "")
        elif which == "get_option":
            for k in op.get_option.keys:
                if k in st.config:
                    kv = out.pairs.add()
                    kv.key = k
                    kv.value = st.config[k]
        elif which == "get_all":
            prefix = (op.get_all.prefix
                      if op.get_all.HasField("prefix") else "")
            for k, v in sorted(st.config.items()):
                if k.startswith(prefix):
                    kv = out.pairs.add()
                    kv.key = k
                    kv.value = v
        elif which == "unset":
            for k in op.unset.keys:
                st.config.pop(k, None)
        elif which == "is_modifiable":
            for k in op.is_modifiable.keys:
                kv = out.pairs.add()
                kv.key = k
                kv.value = "true"
        return out


class SparkConnectServer(SparkConnectService):
    """grpc server exposing daft_tpu_torch as a Spark Connect endpoint
    (needs ``grpcio``)."""

    def __init__(self, port: int = 0, max_workers: int = 8):
        import concurrent.futures as cf

        import grpc

        super().__init__(codes=grpc.StatusCode)
        factories = {"unary_unary": grpc.unary_unary_rpc_method_handler,
                     "unary_stream": grpc.unary_stream_rpc_method_handler,
                     "stream_unary": grpc.stream_unary_rpc_method_handler}
        handlers = {
            name: factories[arity](
                self.handler(name),
                request_deserializer=getattr(pb, req_t).FromString,
                response_serializer=getattr(pb, resp_t).SerializeToString)
            for name, (arity, req_t, resp_t, _) in _METHODS.items()}
        self._server = grpc.server(
            cf.ThreadPoolExecutor(max_workers=max_workers,
                                  thread_name_prefix="daft-torch-connect"))
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(_SERVICE, handlers),))
        self.port = self._server.add_insecure_port(f"127.0.0.1:{port}")
        self._server.start()

    @property
    def address(self) -> str:
        return f"sc://127.0.0.1:{self.port}"

    def stop(self, grace: Optional[float] = None) -> None:
        self._server.stop(grace)


def _explain_str(df) -> str:
    import contextlib
    import io as _io
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        df.explain(show_all=True)
    return buf.getvalue()


def start_server(port: int = 0) -> SparkConnectServer:
    return SparkConnectServer(port)

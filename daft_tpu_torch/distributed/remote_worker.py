"""Multi-host worker: stage tasks over the wire.

Reference: flotilla's RaySwordfishActor — one worker process per node
receiving whole LocalPhysicalPlan fragments and streaming MicroPartitions
back (``daft/runners/flotilla.py:53``, ``scheduling/worker.rs``). Here the
transport is HTTP + cloudpickle for the plan fragment and Arrow IPC for the
result partitions; ``RemoteWorker`` plugs into the same ``Worker`` seam the
in-process workers use, so the scheduler/stage runner is transport-blind.
A worker process is started with ``python -m
daft_tpu_torch.distributed.remote_worker --port N`` on each host."""

from __future__ import annotations

import concurrent.futures as cf
import http.server
import io
import json
import pickle
import threading
import urllib.request
from typing import Dict, List

import pyarrow as pa
import pyarrow.ipc as paipc

from ..micropartition import MicroPartition
from ..recordbatch import RecordBatch
from .worker import StageTask, Worker


def _dumps(obj) -> bytes:
    try:
        import cloudpickle
        return cloudpickle.dumps(obj)
    except ImportError:
        return pickle.dumps(obj)


class RemoteTaskError(RuntimeError):
    """A remote task failed with an exception that could not be
    reconstructed locally; carries the remote type name + traceback."""


def _exc_payload(exc: BaseException) -> dict:
    """Serialize a worker-side exception so the scheduler's retry
    classification (and the user) sees the TRUE cause — the exception
    object itself when picklable (ShuffleFetchError must survive the
    wire for lineage recovery), plus type/message/traceback always."""
    import traceback
    try:
        pickled = _dumps(exc)
        pickle.loads(pickled)  # prove it round-trips
    except Exception:
        pickled = None
    return {"pickled": pickled, "type": type(exc).__name__,
            "message": str(exc), "traceback": traceback.format_exc()}


def _raise_remote(payload: dict) -> None:
    if payload.get("pickled"):
        try:
            exc = pickle.loads(payload["pickled"])
        except Exception:
            exc = None
        if isinstance(exc, BaseException):
            exc.remote_traceback = payload.get("traceback", "")
            raise exc
    raise RemoteTaskError(
        f"remote worker failed: {payload.get('type')}: "
        f"{payload.get('message')}\n{payload.get('traceback', '')}")


def _parts_to_ipc(parts: List[MicroPartition]) -> bytes:
    sink = io.BytesIO()
    offsets = []
    # daft-lint: allow(uncancellable-loop) -- serializes a finished
    # task's result list; no query work runs in this loop
    for p in parts:
        t = p.combined().to_arrow_table()
        w = paipc.new_stream(sink, t.schema)
        w.write_table(t)
        w.close()
        offsets.append(sink.tell())
    return pickle.dumps((offsets, sink.getvalue()))


def _parts_from_ipc(blob: bytes) -> List[MicroPartition]:
    offsets, payload = pickle.loads(blob)
    out = []
    start = 0
    for end in offsets:
        with paipc.open_stream(pa.BufferReader(payload[start:end])) as r:
            out.append(MicroPartition.from_recordbatch(
                RecordBatch.from_arrow_table(r.read_all())))
        start = end
    return out


def worker_status() -> dict:
    """This worker process's pid, its query device (``cuda``, ``cpu`` or
    ``host``) and its kernel launch counts."""
    import os

    from ..device import backend, hash_kernels, join_kernels
    dev = backend.resolve_device()
    launches = {"hash_agg_build": hash_kernels.launches}
    launches.update(join_kernels.launches)
    return {"pid": os.getpid(),
            "device": "host" if dev is None else dev.type,
            "launches": launches}


def fetch_status(address: str, timeout: float = 30.0) -> dict:
    """GET a WorkerServer's :func:`worker_status`."""
    with urllib.request.urlopen(address.rstrip("/") + "/status",
                                timeout=timeout) as r:
        return json.loads(r.read())


class WorkerServer:
    """Executes posted stage fragments on a local streaming executor."""

    def __init__(self, port: int = 0, num_slots: int = 2,
                 host: str = "127.0.0.1", advertise_host: str = ""):
        self.num_slots = num_slots
        self._advertise = advertise_host or (
            "127.0.0.1" if host == "0.0.0.0" else host)
        # the worker's shuffle server must be reachable by the same route
        # as the worker itself — reduce tasks on OTHER hosts fetch from it;
        # configure it eagerly so no map task lazily boots a loopback one
        if host != "127.0.0.1":
            from .shuffle_service import configure_local_shuffle_server
            configure_local_shuffle_server(host, self._advertise)
        import os as _os

        # daft-torch prefix so run_task's lane parser yields a stable
        # per-worker-process lane instead of "ThreadPoolExecutor-0"
        pool = cf.ThreadPoolExecutor(
            max_workers=num_slots,
            thread_name_prefix=f"daft-torch-remote-{_os.getpid()}")
        # per-trace span buffers for foreign-driver tasks: refcounted so
        # two concurrent tasks of ONE trace share a buffer and each
        # response drains (never double-ships, never drops) its spans
        trace_bufs: Dict[str, list] = {}
        trace_bufs_lock = threading.Lock()

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                # health probe: where this worker runs its fragments and
                # how many hand-written kernels it has launched
                if self.path.rstrip("/") != "/status":
                    self.send_error(404)
                    return
                body = json.dumps(worker_status()).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                import time as _time

                from .. import tracing
                n = int(self.headers.get("Content-Length", 0))
                blob = self.rfile.read(n)
                temp_rec = None
                trace_ctx = None
                try:
                    task_plan, inputs_wire, shuffle_out, *rest = \
                        pickle.loads(blob)
                    fault_key = rest[0] if rest else ""
                    attempt = rest[1] if len(rest) > 1 else 0
                    trace_ctx = rest[2] if len(rest) > 2 else None
                    if trace_ctx is not None:
                        # foreign driver: buffer this task's spans
                        # locally and ship them back with the result.
                        # Refcounted get-or-create under ONE lock: two
                        # concurrent tasks of the same trace share the
                        # buffer (a bare check-then-register would let
                        # the loser's spans vanish into an unregistered
                        # recorder)
                        with trace_bufs_lock:
                            ent = trace_bufs.get(trace_ctx[0])
                            if ent is None \
                                    and tracing.recorder_for(
                                        trace_ctx[0]) is None:
                                ent = [tracing.SpanRecorder(trace_ctx[0]),
                                       0]
                                trace_bufs[trace_ctx[0]] = ent
                                # daft-lint: allow(recorder-registration-leak) -- refcounted
                                # pairing: the drain block after the try
                                # decrements under the same lock and the
                                # LAST task out unregisters; the path-
                                # insensitive solver cannot see the
                                # refcount invariant, and the registry
                                # cap bounds the worst case (a
                                # BaseException escaping do_POST kills
                                # the server anyway)
                                tracing.register_recorder(ent[0])
                            if ent is not None:
                                ent[1] += 1
                                temp_rec = ent[0]
                    # cloudpickle-serialized closures need cloudpickle's
                    # reducers importable on this host; plan fragments
                    # without closure UDFs decode with plain pickle
                    plan = pickle.loads(task_plan)
                    from .worker import StageTask, run_task
                    stage_inputs = {
                        k: (v[1] if v[0] == "fetch"
                            else _parts_from_ipc(v[1]))
                        for k, v in inputs_wire.items()}

                    def run():
                        return run_task(StageTask(
                            -1, plan, stage_inputs,
                            shuffle_out=shuffle_out,
                            fault_key=fault_key, attempt=attempt,
                            trace_ctx=trace_ctx))

                    # daft-lint: allow(unattributed-worker) -- run_task
                    # (worker.py, cross-module so the one-level summary
                    # can't see it) installs the span context itself from
                    # StageTask.trace_ctx; stats attribution is driver-
                    # side — this process ships spans back instead
                    res = pool.submit(run).result()
                    from .worker import ShuffleResult
                    if isinstance(res, ShuffleResult):
                        body = ("shuffle", res)
                    else:
                        body = ("parts", _parts_to_ipc(res))
                    status = 200
                except Exception as exc:
                    # serialize the REAL exception (type + traceback, and
                    # the object itself when picklable) so the scheduler's
                    # retry classification sees the true cause instead of
                    # an opaque text blob
                    body = ("error", _exc_payload(exc))
                    status = 500
                trace_payload = None
                if temp_rec is not None:
                    # this task's run_task has fully recorded by now;
                    # drain (not snapshot) so a concurrent sibling task's
                    # later spans ship with ITS response, and only the
                    # last task out unregisters the shared buffer
                    with trace_bufs_lock:
                        ent = trace_bufs.get(temp_rec.trace_id)
                        if ent is not None:
                            ent[1] -= 1
                            if ent[1] <= 0:
                                trace_bufs.pop(temp_rec.trace_id)
                                tracing.unregister_recorder(
                                    temp_rec.trace_id)
                        spans = temp_rec.drain()
                    trace_payload = {"spans": spans,
                                     "now_us": int(_time.time() * 1e6)}
                body = pickle.dumps(body + (trace_payload,))
                self.send_response(status)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = http.server.ThreadingHTTPServer((host, port),
                                                       Handler)
        threading.Thread(target=self._server.serve_forever, daemon=True,
                         name="daft-torch-worker").start()

    @property
    def address(self) -> str:
        return f"http://{self._advertise}:{self._server.server_port}"

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()


class RemoteWorker(Worker):
    """Worker-seam client for a WorkerServer on another process/host."""

    def __init__(self, worker_id: str, address: str, num_slots: int = 2):
        self.id = worker_id
        self.address = address
        self.num_slots = num_slots
        self._pool = cf.ThreadPoolExecutor(
            max_workers=num_slots, thread_name_prefix=f"daft-torch-{worker_id}")

    def submit(self, task: StageTask):
        return self._pool.submit(self._post, task)

    def _post(self, task: StageTask):
        import os
        import time as _time
        import urllib.error

        from .. import tracing
        from .resilience import active_fault_plan
        from .worker import FetchSpec
        rec = None
        if task.trace_ctx is not None:
            rec = tracing.recorder_for(task.trace_ctx[0])
        with tracing.attach(
                tracing.SpanContext(rec, task.trace_ctx[2])
                if rec is not None else None), \
                tracing.span("rpc:post",
                             key=f"rpc:{task.fault_key}#a{task.attempt}",
                             attrs={"worker": self.id}):
            plan = active_fault_plan()
            if plan is not None:  # injection site 3: remote-worker RPC
                plan.maybe_fail("rpc", task.fault_key or f"rpc.{self.id}",
                                attempt=task.attempt)
            inputs_wire = {}
            for k, v in task.stage_inputs.items():
                if isinstance(v, FetchSpec):
                    inputs_wire[k] = ("fetch", v)
                else:
                    inputs_wire[k] = ("parts", _parts_to_ipc(v))
            blob = pickle.dumps((_dumps(task.plan), inputs_wire,
                                 task.shuffle_out, task.fault_key,
                                 task.attempt, task.trace_ctx))
            req = urllib.request.Request(self.address, data=blob,
                                         method="POST")
            from .. import knobs
            timeout = knobs.env_float("DAFT_TORCH_WORKER_TIMEOUT")
            t0_us = int(_time.time() * 1e6)
            try:
                with urllib.request.urlopen(req, timeout=timeout) as r:
                    body = r.read()
            except urllib.error.HTTPError as exc:
                # the body carries the serialized worker-side exception:
                # re-raise the original object (retry classification and
                # lineage recovery see the true cause) or a
                # RemoteTaskError with the remote type + traceback
                raw = exc.read()
                try:
                    kind, payload, *rest = pickle.loads(raw)
                except Exception:
                    raise RuntimeError(
                        "remote worker failed:\n"
                        + raw.decode(errors="replace")) from exc
                self._merge_spans(rec, rest, t0_us,
                                  int(_time.time() * 1e6))
                if kind == "error":
                    _raise_remote(payload)
                raise RuntimeError(
                    f"remote worker failed: {payload!r}") from exc
            kind, payload, *rest = pickle.loads(body)
            self._merge_spans(rec, rest, t0_us, int(_time.time() * 1e6))
            if kind == "error":
                _raise_remote(payload)
            if kind == "shuffle":
                return payload
            return _parts_from_ipc(payload)

    def _merge_spans(self, rec, rest, t0_us: int, t1_us: int) -> None:
        """Fold the worker's shipped spans into the driver's recorder,
        correcting their wall clock by the measured offset (worker send
        time vs the RPC's midpoint on the driver clock)."""
        tp = rest[0] if rest else None
        if rec is None or not tp:
            return
        offset_us = (t0_us + t1_us) // 2 - tp["now_us"]
        rec.add_remote(tp["spans"], offset_us, worker=self.address)

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False)


def main(argv=None) -> int:
    import argparse
    import time
    p = argparse.ArgumentParser(prog="daft-torch-worker")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--slots", type=int, default=2)
    p.add_argument("--host", default="0.0.0.0",
                   help="bind address (default all interfaces)")
    p.add_argument("--advertise-host", default="",
                   help="hostname peers should use to reach this worker")
    args = p.parse_args(argv)
    srv = WorkerServer(args.port, args.slots, host=args.host,
                       advertise_host=args.advertise_host)
    print(f"daft-torch worker on {srv.address}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.shutdown()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())

"""Process actor pools for stateful UDFs.

Reference: ``daft_tpu/actor_pool.py`` (after
``daft/execution/actor_pool_udf.py:22-114``): each stateful UDF gets a
pool of OS processes holding one instance each, with batches shipped over
IPC, so N-way concurrency runs N real interpreters (no GIL sharing, true
per-actor state). The transport is Arrow IPC over ``multiprocessing``
pipes; the UDF class and its init args ship once, at spawn. Actors start
with ``spawn``: a child that touches a CUDA card opens its own context.

:func:`try_make_pool` returns None, and the UDF keeps its one in-process
instance, when the UDF does not pickle (a class defined in a closure, a
live lock among its init args), when its actors cannot start, or when
``DAFT_TORCH_ACTOR_POOL=0``.
"""

from __future__ import annotations

import io
import pickle
import queue
import traceback
import weakref
from typing import Optional

import pyarrow as pa

from . import knobs


#: seconds an actor may take to build its instance and report ready
START_TIMEOUT_S = 300.0


def _series_to_ipc(series_list) -> bytes:
    import pyarrow.ipc as paipc
    # lengths can differ (scalar args): each column is a stream of its own
    sink = io.BytesIO()
    meta = []
    for i, s in enumerate(series_list):
        arr = s.to_arrow()
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        t = pa.table({f"c{i}": arr})
        w = paipc.new_stream(sink, t.schema)
        w.write_table(t)
        w.close()
        meta.append(sink.tell())
    return pickle.dumps((meta, sink.getvalue()))


def _series_from_ipc(blob: bytes):
    import pyarrow.ipc as paipc
    from .series import Series
    meta, payload = pickle.loads(blob)
    out = []
    start = 0
    for end in meta:
        rdr = paipc.open_stream(pa.BufferReader(payload[start:end]))
        t = rdr.read_all()
        out.append(Series.from_arrow(t.column(0), t.column_names[0]))
        start = end
    return out


def _loads_udf(blob: bytes):
    try:
        import cloudpickle
    except ImportError:
        return pickle.loads(blob)
    return cloudpickle.loads(blob)


def _dumps_udf(obj) -> bytes:
    # a class decorated by @udf is shadowed by its UDF wrapper at module
    # scope, so pickling it by reference cannot resolve it: cloudpickle
    # ships it by value where it imports
    try:
        import cloudpickle
    except ImportError:
        return pickle.dumps(obj)
    return cloudpickle.dumps(obj)


def _actor_main(conn, udf_blob: bytes) -> None:
    """Child process: instantiate once, serve call messages until told to
    stop or the pipe closes."""
    try:
        cls, init_args, return_dtype, batch_size, name = _loads_udf(udf_blob)
        a, kw = init_args or ((), {})
        instance = cls(*a, **kw)
        conn.send(("ready", None))
    except Exception:  # the actor's boundary: the parent reports it
        conn.send(("err", traceback.format_exc()))
        return
    from .udf import run_udf_batches
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return
        if msg is None or msg[0] == "stop":
            return
        try:
            _, ipc_in, arg_spec, kw_spec, length = msg
            evaluated = _series_from_ipc(ipc_in)
            out = run_udf_batches(instance, evaluated, arg_spec, kw_spec,
                                  length, batch_size, return_dtype, name)
            conn.send(("ok", _series_to_ipc([out])))
        except Exception:  # the actor's boundary: the parent raises it
            conn.send(("err", traceback.format_exc()))


def _stop_actors(actors) -> None:
    for a in actors:
        a.stop()


class _Actor:
    def __init__(self, udf_blob: bytes):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self._parent, child = ctx.Pipe()
        self.process = ctx.Process(target=_actor_main, args=(child, udf_blob),
                                   daemon=True)
        self.process.start()
        child.close()
        kind, detail = "err", (f"the actor sent nothing in "
                               f"{START_TIMEOUT_S:g} s")
        try:
            if self._parent.poll(START_TIMEOUT_S):
                kind, detail = self._parent.recv()
        except EOFError:
            kind, detail = "err", "the actor exited before it was ready"
        if kind != "ready":
            self.stop()
            raise RuntimeError(f"actor failed to initialize:\n{detail}")

    @property
    def pid(self) -> int:
        return self.process.pid

    def call(self, evaluated, arg_spec, kw_spec, length):
        self._parent.send(("call", _series_to_ipc(evaluated), arg_spec,
                           kw_spec, length))
        try:
            kind, payload = self._parent.recv()
        except EOFError:
            raise RuntimeError(f"actor {self.pid} exited during a call "
                               f"(exit code {self.process.exitcode})")
        if kind != "ok":
            raise RuntimeError(f"actor UDF raised:\n{payload}")
        return _series_from_ipc(payload)[0]

    def stop(self):
        try:
            self._parent.send(("stop",))
        except (OSError, BrokenPipeError):
            pass
        self.process.join(timeout=2)
        if self.process.is_alive():
            self.process.terminate()
            self.process.join(timeout=2)
        self._parent.close()


class ActorPool:
    """N OS-process actors; calls check out an idle actor (blocking when all
    are busy), giving concurrency == pool size."""

    def __init__(self, udf, size: int):
        blob = _dumps_udf((udf.func, udf.init_args, udf.return_dtype,
                           udf.batch_size, udf.name))
        self._actors = []
        try:
            for _ in range(max(size, 1)):
                self._actors.append(_Actor(blob))
        except RuntimeError:
            _stop_actors(self._actors)
            raise
        self._idle: "queue.Queue[_Actor]" = queue.Queue()
        for a in self._actors:
            self._idle.put(a)
        # finalize (not atexit): a discarded pool's workers stop when the
        # pool is garbage-collected, not at process exit
        self._finalizer = weakref.finalize(self, _stop_actors, self._actors)

    @property
    def size(self) -> int:
        return len(self._actors)

    @property
    def pids(self):
        return [a.pid for a in self._actors]

    def call(self, evaluated, arg_spec, kw_spec, length):
        actor = self._idle.get()
        try:
            return actor.call(evaluated, arg_spec, kw_spec, length)
        finally:
            self._idle.put(actor)

    def shutdown(self):
        """Stop every actor (their CUDA contexts close with them)."""
        self._finalizer()


def pool_enabled() -> bool:
    return knobs.env_bool("DAFT_TORCH_ACTOR_POOL")


def try_make_pool(udf) -> Optional[ActorPool]:
    """A pool for a stateful UDF, or None when the UDF cannot ship across
    a process boundary or its actors cannot start (the UDF then keeps its
    shared in-process instance)."""
    if not pool_enabled():
        return None
    try:
        _dumps_udf((udf.func, udf.init_args))
    except (pickle.PicklingError, TypeError, AttributeError):
        return None
    try:
        return ActorPool(udf, udf.concurrency or 1)
    except RuntimeError:
        return None

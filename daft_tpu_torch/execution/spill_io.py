"""Spill-plane IO: a bounded writer pool and prefetch-piped reads.

The port of ``daft_tpu/execution/spill_io.py``:

- **bounded writer pool** — spill writes run on a shared IO pool,
  serialized *per bucket* (futures chain key-ordered, so within-bucket
  push order — the read-side contract — is preserved) but concurrent
  *across* buckets; Arrow IPC serialization and the codec release the
  GIL, so the radix-splitting producer keeps running while batches drain
  to disk. Pending (enqueued, unwritten) bytes are capped by the store
  budget: a pusher past the cap takes a bounded wait that the draining
  writers release (one oversize batch is always admitted when nothing
  else is pending, so a giant morsel cannot deadlock).
- **prefetch-piped reads** — :func:`prefetch_ordered` resolves up to a
  small window of bucket reads ahead of the consumer on the same pool,
  so pair N+1's IPC decode overlaps pair N's join.

``DAFT_TORCH_SPILL_IO_PARALLELISM`` sizes the pool; ``0`` writes serially
under the store lock and reads in line.
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
from typing import Callable, Dict, Iterator, Optional

_SPILL_POOL: Optional[cf.ThreadPoolExecutor] = None
_pool_lock = threading.Lock()

#: pool thread ceiling — parallelism beyond this saturates one NVMe
_MAX_POOL = 8


def spill_io_parallelism(cfg=None) -> int:
    """``DAFT_TORCH_SPILL_IO_PARALLELISM``: concurrent spill write/read
    tasks (default ``ExecutionConfig.spill_io_parallelism``, 4); ``0`` =
    the serial path. (The reference also forces 0 under a chaos fault
    plan; the port has none until ROADMAP A7/A8.)"""
    from .. import knobs
    v = knobs.env_opt_int("DAFT_TORCH_SPILL_IO_PARALLELISM")
    if v is None:
        if cfg is None:
            from ..context import get_context
            cfg = get_context().execution_config
        v = cfg.spill_io_parallelism
    return max(min(int(v), _MAX_POOL), 0)


def _pool() -> cf.ThreadPoolExecutor:
    """Shared spill-IO pool. Dedicated (not the exec pool): a spill
    write blocked on disk must never hold an exec slot a downstream
    operator needs, and the scan pool's producers block on admission.
    Sized to the ceiling once; per-store concurrency is bounded by the
    per-bucket chains, not pool width."""
    global _SPILL_POOL
    if _SPILL_POOL is not None:
        return _SPILL_POOL
    with _pool_lock:
        if _SPILL_POOL is None:
            _SPILL_POOL = cf.ThreadPoolExecutor(
                max_workers=_MAX_POOL,
                thread_name_prefix="daft-torch-spill-io")
        return _SPILL_POOL


class SpillWriterGroup:
    """Per-store async write front: ``submit(key, fn, nbytes)`` chains
    ``fn`` after the previous write of the same ``key`` (within-bucket
    order preserved) and runs chains of different keys concurrently on
    the shared pool. ``drain()`` blocks until every chained write
    landed and re-raises the first write error; ``close()`` is the
    no-raise cleanup variant. Pending bytes are capped at
    ``pending_cap``: over-cap submits wait (bounded by writer progress —
    writes always terminate) unless nothing is pending (the
    single-huge-request rule)."""

    def __init__(self, pending_cap: int):
        self.pending_cap = max(int(pending_cap), 1 << 20)
        self._cond = threading.Condition()
        self._pending_bytes = 0
        self._inflight = 0
        self._tails: Dict[object, cf.Future] = {}
        self._err: Optional[BaseException] = None

    def submit(self, key, fn: Callable[[], None], nbytes: int) -> None:
        if self._err is not None:
            raise self._err
        nbytes = max(int(nbytes), 0)
        with self._cond:
            while self._pending_bytes > 0 and \
                    self._pending_bytes + nbytes > self.pending_cap:
                self._cond.wait(0.1)
                if self._err is not None:
                    raise self._err
            self._pending_bytes += nbytes
            self._inflight += 1

        def run():
            try:
                fn()
            except BaseException as exc:  # noqa: BLE001
                with self._cond:
                    if self._err is None:
                        self._err = exc
            finally:
                with self._cond:
                    self._pending_bytes -= nbytes
                    self._inflight -= 1
                    self._cond.notify_all()

        placeholder: cf.Future = cf.Future()

        def kick(_prev=None):
            real = _pool().submit(run)
            real.add_done_callback(
                lambda f: placeholder.set_result(None))

        with self._cond:
            prev = self._tails.get(key)
            self._tails[key] = placeholder
        if prev is None:
            kick()
        else:
            prev.add_done_callback(kick)

    def drain(self) -> None:
        """Wait for every chained write; raise the first write error
        (the store's ``finalize()`` calls this before sealing — a
        swallowed write error would read back truncated buckets)."""
        with self._cond:
            while self._inflight > 0:
                self._cond.wait(0.1)
            if self._err is not None:
                raise self._err

    def close(self) -> None:
        """No-raise drain for cleanup paths (store ``close()``): waits
        out in-flight writes so files aren't deleted under a writer."""
        try:
            with self._cond:
                while self._inflight > 0:
                    self._cond.wait(0.1)
        except Exception:
            pass


def prefetch_ordered(thunks: Iterator[Callable[[], object]],
                     window: int) -> Iterator[object]:
    """Resolve ``thunks`` on the spill pool up to ``window`` ahead of
    the consumer, yielding results in order — the bucket-read analogue
    of the scan plane's prefetch pipeline (pair N+1's IPC decode
    overlaps pair N's join). ``window <= 0`` degrades to the serial
    in-line path."""
    if window <= 0:
        for t in thunks:
            yield t()
        return
    pool = _pool()
    pending = []
    it = iter(thunks)
    done = False
    try:
        while True:
            while not done and len(pending) < window + 1:
                try:
                    t = next(it)
                except StopIteration:
                    done = True
                    break
                pending.append(pool.submit(t))
            if not pending:
                return
            yield pending.pop(0).result()
    finally:
        for f in pending:  # abandoned consumer: don't run queued reads
            f.cancel()


def read_prefetch_window(cfg=None) -> int:
    """Bucket-read lookahead: capped at 2 (a bucket pair is large), 0
    when the writer pool is serialized (parallelism 0), and
    governor-narrowed under memory pressure — prefetched buckets are
    resident bytes."""
    par = spill_io_parallelism(cfg)
    if par <= 0:
        return 0
    from . import governor
    return governor.prefetch_window(min(par, 2), cfg)

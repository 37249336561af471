"""Memory budget and host-spill tier of the pipeline breakers.

The port of ``daft_tpu/execution/memory.py``:

- ``MemoryManager``: byte-budget admission (reference
  ``resource_manager.rs``); a request larger than the whole budget is
  admitted when nothing else is held, so one huge request cannot deadlock.
  The executor keeps one for the device pipeline's slots and one for the
  host bytes of out-of-core work units (``DAFT_TORCH_MEMORY_LIMIT``);
- the spill counters, the spill codec and the spill directory
  (``DAFT_TORCH_SPILL_DIR``);
- ``SpillBuffer`` / :func:`materialize` / :func:`breaker_budget_bytes`,
  ``PartitionedSpillStore`` and ``SplitSpillBuffer``: blocking sinks
  (sort, exchange, join build) stay under the budget by writing overflow
  to Arrow IPC files (reference ``shuffle_cache.rs:14-80``) and
  re-streaming them on read.

A batch read back from a spill file is Arrow-typed again; the readers
(``executor._emit_buckets``, ``out_of_core._concat_or_empty``) cast it to
the declared schema, so dictionary-coded strings, dates, decimals and
unsigned ints come back as the values they were.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
import uuid
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import pyarrow.ipc as paipc

from .. import knobs

# --------------------------------------------------------- spill counters
# process-wide spill-tier accounting; a caller diffs two snapshots for one
# query's block (bytes written/read, partitions spilled, grace-join
# recursions, per-store peak residency)

_spill_counters_lock = threading.Lock()
_spill_counters: Dict[str, float] = {}


def spill_count(name: str, n: float = 1) -> None:
    with _spill_counters_lock:
        _spill_counters[name] = _spill_counters.get(name, 0) + n
    # also credit the thread's attributed query (its ``spill`` block)
    from .. import observability as obs
    obs.bump_plane("spill", name, n)


def spill_counters_snapshot() -> Dict[str, float]:
    with _spill_counters_lock:
        return dict(_spill_counters)


def spill_counters_delta(before: Dict[str, float],
                         after: Optional[Dict[str, float]] = None
                         ) -> Dict[str, float]:
    if after is None:
        after = spill_counters_snapshot()
    out = {}
    for k, v in after.items():
        d = v - before.get(k, 0)
        if d:
            out[k] = d
    return out


# ------------------------------------------------------ spill compression
# Arrow IPC buffer compression is self-describing, so no reader needs to
# be told the codec.

_spill_ipc_cache: Dict[str, Optional[object]] = {}


def spill_compression(cfg=None) -> str:
    """Resolved spill codec (``lz4`` | ``zstd`` | ``none``):
    ``DAFT_TORCH_SPILL_COMPRESSION`` wins, else
    ``ExecutionConfig.spill_compression``, else ``lz4``."""
    pref = knobs.env_raw("DAFT_TORCH_SPILL_COMPRESSION")
    if not pref:
        if cfg is None:
            from ..context import get_context
            cfg = get_context().execution_config
        pref = cfg.spill_compression or "lz4"
    return pref.strip().lower()


def spill_ipc_options() -> Optional["paipc.IpcWriteOptions"]:
    """IPC write options for spill files per :func:`spill_compression`;
    uncompressed when the codec is missing from this pyarrow build."""
    pref = spill_compression()
    if pref in ("none", "off", "0", ""):
        return None
    if pref in _spill_ipc_cache:
        return _spill_ipc_cache[pref]
    try:
        opts = paipc.IpcWriteOptions(compression=pref)
    except Exception:
        opts = None  # unknown codec / not built in → uncompressed
    _spill_ipc_cache[pref] = opts
    return opts


def parse_bytes(v: str) -> int:
    v = v.strip().upper()
    for suffix, mult in (("TIB", 1 << 40), ("GIB", 1 << 30), ("MIB", 1 << 20),
                         ("KIB", 1 << 10),
                         ("TB", 10 ** 12), ("GB", 10 ** 9), ("MB", 10 ** 6),
                         ("KB", 10 ** 3),
                         ("T", 1 << 40), ("G", 1 << 30), ("M", 1 << 20),
                         ("K", 1 << 10), ("B", 1)):
        if v.endswith(suffix):
            return int(float(v[:-len(suffix)]) * mult)
    return int(v)


def memory_limit_bytes() -> Optional[int]:
    """Budget from ``DAFT_TORCH_MEMORY_LIMIT`` (e.g. "4GB", "512MiB");
    None = unbounded. A malformed value is a hard error: silently dropping
    a configured limit would trade an error message for an OOM."""
    v = knobs.env_raw("DAFT_TORCH_MEMORY_LIMIT")
    if not v:
        return None
    try:
        return parse_bytes(v)
    except ValueError:
        raise ValueError(
            f"unparseable DAFT_TORCH_MEMORY_LIMIT={v!r}; "
            f"expected e.g. '4GB', '512MiB', '1TiB', or a byte count")


class MemoryManager:
    """``budget`` bytes, or None for no limit (every request admitted at
    once and nothing counted)."""

    def __init__(self, budget: Optional[int] = None):
        self.budget = budget
        self._held = 0
        self._cond = threading.Condition()

    def _fits(self, nbytes: int) -> bool:
        return self._held == 0 or self._held + nbytes <= self.budget

    def acquire(self, nbytes: int) -> None:
        if self.budget is None:
            return
        with self._cond:
            while not self._fits(nbytes):
                self._cond.wait()
            self._held += nbytes

    def try_acquire(self, nbytes: int, deadline: Optional[float] = None,
                    cancel=None) -> bool:
        """Wait until the request fits, the monotonic ``deadline`` passes
        or ``cancel.is_set()``; True iff the bytes were admitted."""
        if self.budget is None:
            return True
        with self._cond:
            while not self._fits(nbytes):
                if cancel is not None and cancel.is_set():
                    return False
                timeout = 0.1   # poll, so a cancel fires within ~100 ms
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                    timeout = min(timeout, remaining)
                self._cond.wait(timeout)
            self._held += nbytes
            return True

    @property
    def outstanding(self) -> int:
        """Bytes admitted and not yet released (0 without a budget)."""
        with self._cond:
            return self._held if self.budget is not None else 0

    def release(self, nbytes: int) -> None:
        if self.budget is None:
            return
        with self._cond:
            self._held = max(self._held - nbytes, 0)
            self._cond.notify_all()


_spill_lock = threading.Lock()
_spill_dir: Optional[str] = None


def spill_dir() -> str:
    global _spill_dir
    with _spill_lock:
        if _spill_dir is None:
            base = knobs.env_raw("DAFT_TORCH_SPILL_DIR")
            _spill_dir = base or tempfile.mkdtemp(prefix="daft_torch_spill_")
            os.makedirs(_spill_dir, exist_ok=True)
        return _spill_dir


class SpillBuffer:
    """Multi-pass materialized partition buffer with a byte budget.

    Append partitions; once in-memory bytes exceed the budget, further
    partitions are written to Arrow IPC files (compressed per
    ``spill_ipc_options``). Iteration re-yields all partitions in append
    order (disk ones re-loaded lazily). ``close()`` (deterministic —
    breaker sites own it via try/finally or ``with``; ``__del__`` is only
    the last-resort GC net) deletes spill files.
    """

    def __init__(self, budget: Optional[int] = None):
        self.budget = budget if budget is not None else memory_limit_bytes()
        self._entries: List[Tuple[str, object]] = []  # ("mem", mp)|("disk", path)
        self._mem_bytes = 0
        self.peak_mem_bytes = 0
        self.bytes_spilled = 0
        self.total_rows = 0
        self._accounted = False

    def append(self, mp) -> None:
        self.total_rows += len(mp)
        sz = mp.size_bytes() or 0
        if self.budget is not None and self._mem_bytes + sz > self.budget:
            path = self._write_ipc(mp)
            self._entries.append(("disk", path))
            self.bytes_spilled += sz
            spill_count("bytes_written", sz)
            spill_count("partitions_spilled")
        else:
            self._entries.append(("mem", mp))
            self._mem_bytes += sz
            self.peak_mem_bytes = max(self.peak_mem_bytes, self._mem_bytes)

    def _write_ipc(self, mp) -> str:
        path = os.path.join(spill_dir(), f"{uuid.uuid4().hex}.arrow")
        table = mp.combined().to_arrow_table()
        with paipc.new_stream(path, table.schema,
                              options=spill_ipc_options()) as w:
            w.write_table(table)
        # disk_bytes_written is the POST-codec file size; bytes_written
        # (logical) stays the cross-PR comparable series — the ratio is
        # the codec's measured win
        try:
            spill_count("disk_bytes_written", os.path.getsize(path))
        except OSError:
            pass
        return path

    @staticmethod
    def _read_ipc(path: str):
        from ..micropartition import MicroPartition
        from ..recordbatch import RecordBatch
        try:
            spill_count("disk_bytes_read", os.path.getsize(path))
        except OSError:
            pass
        with paipc.open_stream(path) as r:
            table = r.read_all()
        spill_count("bytes_read", table.nbytes)
        return MicroPartition.from_recordbatch(
            RecordBatch.from_arrow_table(table))

    @property
    def total_bytes(self) -> int:
        """Materialized size across memory + spill (AQE's stage actuals)."""
        return self._mem_bytes + self.bytes_spilled

    def __len__(self) -> int:
        return len(self._entries)

    def __iter__(self) -> Iterator:
        for kind, v in self._entries:
            yield v if kind == "mem" else self._read_ipc(v)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self._entries)))]
        kind, v = self._entries[i]
        return v if kind == "mem" else self._read_ipc(v)

    def close(self):
        # only stores that really hit disk count toward the spill block:
        # a resident-only buffer is ordinary breaker memory, not spill
        # evidence (and would make zero-spill queries render the block)
        if not self._accounted and self.bytes_spilled:
            self._accounted = True
            spill_count("stores")
            spill_count("store_peak_bytes", self.peak_mem_bytes)
        for kind, v in self._entries:
            if kind == "disk":
                try:
                    os.unlink(v)
                except OSError:
                    pass
        self._entries = []
        self._mem_bytes = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def materialize(parts: Iterable, budget: Optional[int] = None) -> SpillBuffer:
    """Drain a partition stream into a (possibly spilling) buffer. The
    buffer closes itself if the DRAIN fails — the caller only owns it
    once it is returned whole."""
    buf = SpillBuffer(budget)
    try:
        for p in parts:
            buf.append(p)
    except BaseException:
        buf.close()
        raise
    return buf


def breaker_budget_bytes() -> int:
    """In-memory byte budget for pipeline-breaker buffers (sort input,
    bucket stores, gather). The user's DAFT_TORCH_MEMORY_LIMIT wins; without
    one, a quarter of physical RAM — a breaker must never degenerate into
    an unbounded in-memory materialize just because no limit was set."""
    lim = memory_limit_bytes()
    if lim is not None:
        return lim
    try:
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
        return max(total // 4, 256 << 20)
    except (ValueError, OSError, AttributeError):
        return 1 << 30


class PartitionedSpillStore:
    """n-bucket accumulator with one SHARED in-memory byte budget: pushes
    stay in RAM until the store exceeds the budget, then whole buckets
    (largest first) convert to per-bucket Arrow IPC spill files and any
    later push to a spilled bucket appends to its file — push order within
    a bucket is preserved. This is the blocking-sink store behind the
    streaming breakers (hash/random/range exchanges, external sort buckets,
    spill-partitioned joins): peak RSS ≈ budget + one bucket at read time
    (reference: ``sinks/blocking_sink.rs:32-55`` consume-all-then-emit with
    memory-pressure spilling)."""

    def __init__(self, n: int, budget: Optional[int] = None):
        import uuid as _uuid
        from . import spill_io
        self.n = n
        self.budget = budget if budget is not None else breaker_budget_bytes()
        self._mem: List[List] = [[] for _ in range(n)]  # pa.Table lists
        self._mem_bytes_per = [0] * n
        self._mem_bytes = 0
        self.peak_mem_bytes = 0
        self._writers: List[Optional[Tuple[object, object]]] = [None] * n
        self._spilled = [False] * n
        self.rows = [0] * n
        self.nbytes = [0] * n
        self.bytes_spilled = 0
        self._root = os.path.join(spill_dir(),
                                  f"pstore_{_uuid.uuid4().hex}")
        self._lock = threading.Lock()
        self._sealed = False
        self._accounted = False
        # writes to spilled buckets run on the bounded writer pool,
        # chained per bucket (push order preserved) and capped at one
        # budget of pending bytes — worst-case resident overshoot is
        # budget (resident) + budget (enqueued). Parallelism 0 keeps the
        # serial write-under-lock path.
        self._io = (spill_io.SpillWriterGroup(self.budget)
                    if spill_io.spill_io_parallelism() > 0 else None)

    def _path(self, i: int) -> str:
        return os.path.join(self._root, f"bucket-{i}.arrow")

    def _write_table(self, i: int, table) -> None:
        """Append one Arrow table to bucket i's IPC file, creating the
        writer on first touch and counting post-codec disk bytes. Called
        either under the store lock (serial path) or from the writer
        pool with per-bucket exclusivity (async path) — never both for
        the same store, so writer slots need no extra lock."""
        w = self._writers[i]
        if w is None:
            os.makedirs(self._root, exist_ok=True)
            f = open(self._path(i), "ab")
            w = (paipc.new_stream(f, table.schema,
                                  options=spill_ipc_options()), f)
            self._writers[i] = w
        before = w[1].tell()
        w[0].write_table(table)
        spill_count("disk_bytes_written", w[1].tell() - before)

    def _make_write(self, j: int, batches: List):
        def write():
            for b in batches:
                self._write_table(j, b.to_arrow_table())
        return write

    def push(self, i: int, batch) -> None:
        """Append a RecordBatch to bucket i. Resident batches stay AS-IS
        (no Arrow conversion on the hot path); conversion happens only
        when a bucket spills — on the writer pool when the spill-IO fast
        path is on, inline when serialized."""
        nb = batch.size_bytes()
        to_write: List[Tuple[int, List, int, bool]] = []
        with self._lock:
            self.rows[i] += len(batch)
            self.nbytes[i] += nb
            if self._spilled[i]:
                self.bytes_spilled += nb
                spill_count("bytes_written", nb)
                if self._io is not None:
                    to_write.append((i, [batch], nb, False))
                else:
                    # the serial path (parallelism 0): writer state and
                    # budget accounting as one atomic unit
                    self._write_table(i, batch.to_arrow_table())
            else:
                self._mem[i].append(batch)
                self._mem_bytes_per[i] += nb
                self._mem_bytes += nb
                self.peak_mem_bytes = max(self.peak_mem_bytes,
                                          self._mem_bytes)
                while self._mem_bytes > self.budget:
                    j = max(range(self.n),
                            key=lambda x: self._mem_bytes_per[x])
                    if self._mem_bytes_per[j] == 0:
                        break
                    if self._io is not None:
                        evicted = self._mem[j]
                        jb = self._mem_bytes_per[j]
                        self._mem[j] = []
                        self._mem_bytes -= jb
                        self._mem_bytes_per[j] = 0
                        self._spilled[j] = True
                        self.bytes_spilled += jb
                        spill_count("bytes_written", jb)
                        spill_count("partitions_spilled")
                        to_write.append((j, evicted, jb, True))
                    else:
                        self._spill_bucket(j)
        # enqueue OUTSIDE the lock: submit() may wait on the pending-byte
        # cap, and a blocked pusher must not hold the store lock the
        # draining writer's counters (or a concurrent pusher) need
        for j, batches, jb, _newly in to_write:
            self._io.submit(j, self._make_write(j, batches), jb)

    def _spill_bucket(self, j: int) -> None:
        for b in self._mem[j]:
            self._write_table(j, b.to_arrow_table())
        self.bytes_spilled += self._mem_bytes_per[j]
        spill_count("bytes_written", self._mem_bytes_per[j])
        spill_count("partitions_spilled")
        self._mem_bytes -= self._mem_bytes_per[j]
        self._mem_bytes_per[j] = 0
        self._mem[j] = []
        self._spilled[j] = True

    def finalize(self) -> None:
        if self._io is not None:
            # outside the lock: drain() blocks on writer progress, and
            # the writers never take the store lock
            self._io.drain()
        with self._lock:
            for w in self._writers:
                if w is not None:
                    w[0].close()
                    w[1].close()
            self._writers = [None] * self.n
            self._sealed = True

    def bucket_batches(self, i: int) -> List:
        """All of bucket i's RecordBatches, disk ones first then resident
        (push order: a bucket spills wholly before disk appends begin)."""
        from ..recordbatch import RecordBatch
        assert self._sealed, "finalize() before reading buckets"
        out = []
        if self._spilled[i] and os.path.exists(self._path(i)):
            read = 0
            try:
                spill_count("disk_bytes_read",
                            os.path.getsize(self._path(i)))
            except OSError:
                pass
            with open(self._path(i), "rb") as f:
                while True:
                    try:
                        r = paipc.open_stream(f)
                    except Exception:
                        break
                    t = r.read_all()
                    read += t.nbytes
                    out.append(RecordBatch.from_arrow_table(t))
            if read:
                spill_count("bytes_read", read)
        out.extend(self._mem[i])
        return out

    def close(self) -> None:
        # spilling stores only — see SpillBuffer.close
        if not self._accounted and self.bytes_spilled:
            self._accounted = True
            spill_count("stores")
            spill_count("store_peak_bytes", self.peak_mem_bytes)
        if self._io is not None:
            # wait out in-flight writes before deleting their files
            self._io.close()
        with self._lock:
            for w in self._writers:
                if w is not None:
                    try:
                        w[0].close()
                        w[1].close()
                    except Exception:
                        pass
            self._writers = [None] * self.n
            self._mem = [[] for _ in range(self.n)]
            self._mem_bytes = 0
            self._mem_bytes_per = [0] * self.n
        try:
            import shutil
            shutil.rmtree(self._root, ignore_errors=True)
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class SplitSpillBuffer:
    """Budgeted holder for fanout outputs: each input partition contributes a
    row of ``n`` split partitions; rows accumulate under the same spill
    budget so the exchange's peak (all fanout outputs live at once) is
    bounded, not just its input buffer."""

    def __init__(self, budget: Optional[int] = None):
        self._buf = SpillBuffer(budget)
        self._n: Optional[int] = None
        self.rows = 0

    def append_row(self, mps: List) -> None:
        if self._n is None:
            self._n = len(mps)
        assert len(mps) == self._n
        for mp in mps:
            self._buf.append(mp)
        self.rows += 1

    def get(self, row: int, i: int):
        return self._buf[row * self._n + i]

    def close(self):
        self._buf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

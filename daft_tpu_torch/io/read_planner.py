"""Scan-side byte-range read planner (reference: ``daft-parquet/read_planner``).

The port's copy of ``daft_tpu/io/read_planner.py``. The scan fast path's
planning layer: given a parquet footer plus the projected columns and pruned
row groups, emit the EXACT byte ranges the decode will touch, coalesce them
(hole tolerance + request floor) into few large GETs, fetch them
concurrently over the source's connection pool
(``ObjectSource.get_ranges``), and hand pyarrow an in-memory
:class:`RangeCache` file shim so it never sends its own small GETs.

Also owns the process-wide scan-plane counters: requests sent vs ranges
planned (coalescing evidence), bytes fetched vs bytes used (over-fetch),
and prefetch overlap wall (``scan_span_us``) vs serial-equivalent
(``scan_task_us``). Callers take deltas (:func:`scan_counters_delta`); each
bump also credits the thread's attributed query, whose ``io`` block
``explain(analyze=True)`` renders.
"""

from __future__ import annotations

import io
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from .. import knobs
from .object_io import IOStatsContext


# ------------------------------------------------------- scan-plane counters

_counters_lock = threading.Lock()
_counters: Dict[str, float] = {}


def scan_count(name: str, n: float = 1) -> None:
    with _counters_lock:
        _counters[name] = _counters.get(name, 0) + n
    from .. import observability as obs
    obs.bump_plane("io", name, n)


def scan_counters_snapshot() -> Dict[str, float]:
    with _counters_lock:
        return dict(_counters)


def scan_counters_delta(before: Dict[str, float],
                        after: Optional[Dict[str, float]] = None
                        ) -> Dict[str, float]:
    if after is None:
        after = scan_counters_snapshot()
    out = {}
    for k, v in after.items():
        d = v - before.get(k, 0)
        if d:
            out[k] = d
    return out


class _ScanIOStats(IOStatsContext):
    """Every scan-path object GET records here AND mirrors into the
    process-wide scan counters."""

    def record_get(self, nbytes: int):
        super().record_get(nbytes)
        scan_count("gets")
        scan_count("bytes_fetched", nbytes)

    def record_list(self):
        super().record_list()
        scan_count("lists")


#: process-wide stats context threaded through planner / fetch / scan reads
SCAN_STATS = _ScanIOStats("scan")


# ----------------------------------------------------------------- knobs

def _env_bytes(name: str) -> Optional[int]:
    from ..execution.memory import parse_bytes
    v = knobs.env_raw(name)
    return None if v is None else parse_bytes(v)


def _cfg(attr: str):
    from ..context import get_context
    return getattr(get_context().execution_config, attr)


def coalesce_gap_bytes() -> int:
    """Hole tolerance for range coalescing (``DAFT_TORCH_IO_COALESCE_GAP``,
    else ``ExecutionConfig.io_coalesce_gap``, 1MiB): two needed ranges
    separated by at most this many waste bytes merge into one request."""
    v = _env_bytes("DAFT_TORCH_IO_COALESCE_GAP")
    return v if v is not None else int(_cfg("io_coalesce_gap"))


def min_request_bytes() -> int:
    """Request floor (``DAFT_TORCH_IO_MIN_REQUEST``, else
    ``ExecutionConfig.io_min_request``, 8MiB): after gap-coalescing, a
    sub-floor request absorbs its neighbor when the hole between them is
    itself smaller than the floor — request count drops toward
    per-RTT-amortizing sizes with bounded waste."""
    v = _env_bytes("DAFT_TORCH_IO_MIN_REQUEST")
    return v if v is not None else int(_cfg("io_min_request"))


def range_parallelism() -> int:
    """Concurrent range GETs per source
    (``DAFT_TORCH_IO_RANGE_PARALLELISM``, else
    ``ExecutionConfig.io_range_parallelism``, 8; each source additionally
    caps at its configured ``max_connections``)."""
    v = knobs.env_opt_int("DAFT_TORCH_IO_RANGE_PARALLELISM")
    return max(v if v is not None else int(_cfg("io_range_parallelism")),
               1)


def planned_reads_enabled() -> bool:
    """``DAFT_TORCH_IO_PLANNED_READS=0`` (or
    ``ExecutionConfig.io_planned_reads=False``) restores the naive
    per-column-chunk ranged-read path."""
    if knobs.env_raw("DAFT_TORCH_IO_PLANNED_READS") is not None:
        return knobs.env_bool("DAFT_TORCH_IO_PLANNED_READS")
    return bool(_cfg("io_planned_reads"))


def scan_prefetch_tasks() -> int:
    """How many upcoming ScanTasks the scan source resolves ahead of the
    consumer (``DAFT_TORCH_SCAN_PREFETCH``, else
    ``ExecutionConfig.scan_prefetch``, 2; 0 disables)."""
    v = knobs.env_opt_int("DAFT_TORCH_SCAN_PREFETCH")
    return max(v if v is not None else int(_cfg("scan_prefetch")), 0)


def stream_chunk_bytes() -> int:
    """Chunk size for streaming whole-object reads (CSV/JSON),
    ``DAFT_TORCH_IO_STREAM_CHUNK``, else ``ExecutionConfig.io_stream_chunk``
    (8MiB)."""
    v = _env_bytes("DAFT_TORCH_IO_STREAM_CHUNK")
    return v if v is not None else int(_cfg("io_stream_chunk"))


def infer_head_bytes() -> int:
    """Byte budget for head-range schema inference on remote CSV/JSON
    (``DAFT_TORCH_IO_INFER_BYTES``, else ``ExecutionConfig.io_infer_bytes``,
    1MiB; 0 → whole object)."""
    v = _env_bytes("DAFT_TORCH_IO_INFER_BYTES")
    return v if v is not None else int(_cfg("io_infer_bytes"))


def scan_sequential_fallback() -> bool:
    """True when the scan must take the sequential whole-task path:
    ``DAFT_TORCH_SCAN_PREFETCH=0``, ``DAFT_TORCH_CHAOS_SERIALIZE=1`` or an
    active fault plan (the chaos replay contract wants the injected-fault
    exposure and event order of the sequential scan loop)."""
    from .. import knobs
    from ..distributed.resilience import active_fault_plan
    if scan_prefetch_tasks() <= 0:
        return True
    if knobs.env_bool("DAFT_TORCH_CHAOS_SERIALIZE"):
        return True
    return active_fault_plan() is not None


# -------------------------------------------------------------- planning

def plan_parquet_ranges(md, row_groups: Optional[Sequence[int]] = None,
                        columns: Optional[Sequence[str]] = None
                        ) -> List[Tuple[int, int]]:
    """Exact [start, end) byte ranges of the column chunks a read of
    ``row_groups`` × ``columns`` will touch (dictionary page through last
    data page — parquet stores them contiguously per chunk). ``None``
    means all groups / all columns. Nested columns match on their root
    name. Sorted and overlap-merged."""
    groups = range(md.num_row_groups) if row_groups is None else row_groups
    roots = None if columns is None else {c for c in columns}
    out: List[Tuple[int, int]] = []
    for g in groups:
        rg = md.row_group(g)
        for ci in range(rg.num_columns):
            cc = rg.column(ci)
            if roots is not None \
                    and cc.path_in_schema.split(".")[0] not in roots:
                continue
            start = cc.data_page_offset
            if cc.dictionary_page_offset is not None:
                start = min(start, cc.dictionary_page_offset)
            out.append((start, start + cc.total_compressed_size))
    return _normalize(out)


def _normalize(ranges: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Sort and merge overlapping/adjacent ranges."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted(r for r in ranges if r[1] > r[0]):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def coalesce_ranges(ranges: Sequence[Tuple[int, int]],
                    gap: Optional[int] = None,
                    floor: Optional[int] = None) -> List[Tuple[int, int]]:
    """Needed ranges → request ranges. Two passes:

    1. **hole tolerance**: merge neighbors separated by at most ``gap``
       waste bytes (column chunks of adjacent projected columns are
       usually separated only by the chunks of pruned columns' headers
       or nothing at all);
    2. **request floor**: a request smaller than ``floor`` absorbs its
       neighbor when the hole between them is itself under ``floor`` —
       tiny scattered chunks (many row groups × narrow projection) batch
       into RTT-amortizing GETs with bounded waste (every absorbed hole
       < floor).
    """
    gap = coalesce_gap_bytes() if gap is None else gap
    floor = min_request_bytes() if floor is None else floor
    merged = _normalize(ranges)
    if not merged:
        return []

    def merge_pass(rs: List[Tuple[int, int]], want) -> List[Tuple[int, int]]:
        out = [rs[0]]
        for s, e in rs[1:]:
            ps, pe = out[-1]
            if want(ps, pe, s, e):
                out[-1] = (ps, max(pe, e))
            else:
                out.append((s, e))
        return out

    merged = merge_pass(merged, lambda ps, pe, s, e: s - pe <= gap)
    merged = merge_pass(
        merged, lambda ps, pe, s, e: s - pe < floor
        and (pe - ps < floor or e - s < floor))
    return merged


# ------------------------------------------------------------ range cache

class RangeCache:
    """Fetched [start, end) → bytes segments; serves sub-range reads by
    slicing across segments (requests may each cover several needed
    ranges). ``read`` raises ``KeyError`` on any uncovered byte so the
    caller can fall back to a direct GET."""

    def __init__(self, segments: Sequence[Tuple[Tuple[int, int], bytes]]):
        self._segs = sorted(((s, s + len(data), data)
                             for (s, _e), data in segments),
                            key=lambda x: x[0])

    def covers(self, start: int, end: int) -> bool:
        try:
            self.read(start, end)
            return True
        except KeyError:
            return False

    def read(self, start: int, end: int) -> bytes:
        if end <= start:
            return b""
        parts = []
        pos = start
        for s, e, data in self._segs:
            if e <= pos:
                continue
            if s > pos:
                break
            take_end = min(end, e)
            parts.append(data[pos - s:take_end - s])
            pos = take_end
            if pos >= end:
                return b"".join(parts)
        raise KeyError(f"range [{start}, {end}) not covered")


class RangeCacheFile(io.RawIOBase):
    """Seekable file shim over a :class:`RangeCache`, with per-read
    fallback to direct ranged GETs for bytes the planner did not fetch
    (pyarrow header probes, planner misses). Feeds ``pa.PythonFile``."""

    def __init__(self, cache: RangeCache, source, path: str,
                 size: Optional[int] = None,
                 stats: Optional[IOStatsContext] = None):
        self._cache = cache
        self._src = source
        self._path = path
        self._lazy_size = size
        self._stats = stats
        self._pos = 0

    @property
    def _size(self) -> int:
        if self._lazy_size is None:
            self._lazy_size = self._src.get_size(self._path)
        return self._lazy_size

    def readable(self):
        return True

    def seekable(self):
        return True

    def seek(self, offset, whence=io.SEEK_SET):
        if whence == io.SEEK_SET:
            self._pos = offset
        elif whence == io.SEEK_CUR:
            self._pos += offset
        else:
            self._pos = self._size + offset
        return self._pos

    def tell(self):
        return self._pos

    def read(self, n=-1):
        if n is None or n < 0:
            n = self._size - self._pos
        if n <= 0:
            return b""
        start, end = self._pos, self._pos + n
        try:
            data = self._cache.read(start, end)
        except KeyError:
            # planner miss — bounded by the file size, counted so the
            # stats expose any systematic planning hole
            end = min(end, self._size)
            if end <= start:
                return b""
            scan_count("planner_miss_gets")
            data = self._src.get(self._path, (start, end), self._stats)
        self._pos += len(data)
        return data

    def size(self):
        return self._size


class ChunkedObjectReader(io.RawIOBase):
    """Sequential streaming reader over chunked ranged GETs — the
    single-pass formats' (CSV/JSON) replacement for buffering the whole
    object: resident memory is chunk-sized, and the parser starts before
    the tail arrives."""

    def __init__(self, source, path: str, chunk: Optional[int] = None,
                 stats: Optional[IOStatsContext] = None):
        self._src = source
        self._path = path
        self._chunk = chunk or stream_chunk_bytes()
        self._stats = stats
        self._size = source.get_size(path)
        self._pos = 0  # next byte to hand out
        self._buf = b""
        self._buf_at = 0  # file offset of _buf[0]

    def readable(self):
        return True

    def read(self, n=-1):
        if n is None or n < 0:
            n = self._size - self._pos
        out = []
        need = n
        while need > 0 and self._pos < self._size:
            off = self._pos - self._buf_at
            avail = len(self._buf) - off
            if avail <= 0:
                fetch_end = min(self._pos + max(self._chunk, need),
                                self._size)
                self._buf = self._src.get(self._path,
                                          (self._pos, fetch_end),
                                          self._stats)
                self._buf_at = self._pos
                off, avail = 0, len(self._buf)
                if avail == 0:
                    break
            take = min(avail, need)
            out.append(self._buf[off:off + take])
            self._pos += take
            need -= take
        return b"".join(out)

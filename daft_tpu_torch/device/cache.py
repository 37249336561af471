"""Device column cache: encoded scan columns kept on the card across
queries.

The torch rewrite of ``daft_tpu/device/cache.py`` (itself the analogue of
the reference's ``PartitionSetCache``, one level down): encoded columns
are cached on the device, keyed by the scan task's fingerprint and the
column name, so queries touching different column subsets of one file
share entries. Entries are evicted least recently used first, down to a
byte budget (``DAFT_TORCH_DEVICE_CACHE_BYTES``, default 8 GiB).

Invalidation: the fingerprint covers the file's path, size and mtime, its
format, the row groups, the pushdown filter and the limit, so a changed
file misses; a remote or generated task is never cached.
Dictionaries stay on the host with their ``DeviceColumn``. A cached
plane is read-only: tables served from here are ``resident``.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import torch

from .. import knobs
from . import column as dcol


def budget() -> int:
    return knobs.env_int("DAFT_TORCH_DEVICE_CACHE_BYTES")


def task_fingerprint(task, device: torch.device) -> Optional[Tuple]:
    """Stable identity of a scan task's loaded rows on ``device``, or None
    when the task has none that is cheap to check (reference
    ``daft_tpu/device/cache.py:43``): a generator source, or a file that
    does not exist locally (a remote one, which has no cheap invalidation
    signal) or cannot be stat-ed. It keys on the file format, so a CSV
    and a parquet task over one path never share an entry."""
    if task.generator is not None:
        return None
    try:
        stats = []
        for p in task.paths:
            if not os.path.exists(p):
                return None
            st = os.stat(p)
            stats.append((p, st.st_size, st.st_mtime_ns))
    except (OSError, TypeError):
        return None
    pd = task.pushdowns
    filt = pd.filters._key() if pd.filters is not None else None
    rg = tuple(tuple(r) if r is not None else None
               for r in task.row_groups) if task.row_groups else None
    return (tuple(stats), task.file_format, rg, filt, pd.limit,
            str(device))


class DeviceColumnCache:
    def __init__(self):
        self._lock = threading.Lock()
        self._cols: "OrderedDict[Tuple, Tuple[dcol.DeviceColumn, int]]" = \
            OrderedDict()
        #: fingerprint → (row mask, rows, capacity, copy event)
        self._masks: "OrderedDict[Tuple, Tuple]" = OrderedDict()
        self._bytes = 0
        self._counters: Dict[str, int] = {}

    def _bump(self, name: str, n: int = 1) -> None:
        self._counters[name] = self._counters.get(name, 0) + n

    def stats(self) -> Dict[str, int]:
        """``entries`` and ``bytes`` held, and the counters ``hits`` /
        ``misses`` (per table asked for), ``puts``, ``evictions`` (per
        column), ``refused`` (tables over the budget), ``bytes_put`` and
        ``bytes_evicted``."""
        with self._lock:
            return dict(self._counters, entries=len(self._cols),
                        bytes=self._bytes)

    def reset_counters(self) -> None:
        with self._lock:
            self._counters.clear()

    def clear(self) -> None:
        with self._lock:
            self._cols.clear()
            self._masks.clear()
            self._bytes = 0

    def get_table(self, fp: Tuple, cols: List[str]
                  ) -> Optional[dcol.DeviceTable]:
        """Every requested column cached → a DeviceTable of them, else
        None."""
        with self._lock:
            mask = self._masks.get(fp)
            out = {}
            for c in cols if mask is not None else ():
                e = self._cols.get((fp, c))
                if e is None:
                    break
                out[c] = e[0]
            if mask is None or len(out) != len(cols):
                self._bump("misses")
                return None
            for c in cols:
                self._cols.move_to_end((fp, c))
            self._masks.move_to_end(fp)
            self._bump("hits")
            row_mask, rows, cap, ready = mask
            return dcol.DeviceTable(out, row_mask, rows, cap, resident=True,
                                    ready=ready)

    def put_table(self, fp: Tuple, dt: dcol.DeviceTable) -> None:
        """Cache a freshly encoded table's columns; a table larger than
        the whole budget is not cached. The table becomes ``resident``."""
        sized = [(name, c, c.data.nbytes + c.validity.nbytes)
                 for name, c in dt.columns.items()]
        add = sum(nb for _, _, nb in sized)
        with self._lock:
            if add > budget():
                self._bump("refused")
                return
            dt.resident = True
            self._masks[fp] = (dt.row_mask, dt.row_count, dt.capacity,
                               dt.ready)
            for name, c, nbytes in sized:
                old = self._cols.pop((fp, name), None)
                if old is not None:
                    self._bytes -= old[1]
                self._cols[(fp, name)] = (c, nbytes)
                self._bytes += nbytes
            self._bump("puts")
            self._bump("bytes_put", add)
            self._evict_locked()

    def _evict_locked(self) -> None:
        cap = budget()
        while self._bytes > cap and self._cols:
            _, (_, nbytes) = self._cols.popitem(last=False)
            self._bytes -= nbytes
            self._bump("evictions")
            self._bump("bytes_evicted", nbytes)
        live = {k[0] for k in self._cols}
        for fp in [f for f in self._masks if f not in live]:
            del self._masks[fp]


_cache: Optional[DeviceColumnCache] = None
_cache_lock = threading.Lock()


def get_cache() -> DeviceColumnCache:
    global _cache
    with _cache_lock:
        if _cache is None:
            _cache = DeviceColumnCache()
        return _cache

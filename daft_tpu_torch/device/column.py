"""Host⇄device column transport: RecordBatch → DeviceTable and back.

The torch twin of ``daft_tpu/device/column.py``: a dict of fixed-width
tensors plus validity planes and a live-row mask, padded to a power-of-two
capacity bucket. String/binary columns ride sorted-dictionary codes, so code
order is string order. Float64 lanes stay float64 (the H100 has native f64;
the reference's f32 downcast exists only for TPUs).

Transfers on a card: an encode stages each padded plane in a pinned host
buffer and copies it with ``non_blocking=True`` on the card's copy stream
(:func:`copy_stream`); the current stream waits on an event recorded after
the copies, and the table keeps that event (``ready``) and its staging
buffers until its first drain. A fetch is two halves
(:func:`fetch_host_async`): the submit concatenates the planes on the
current stream and starts one copy into a pinned host buffer; the wait
blocks on the copy's event before numpy reads a byte.

Both halves take their pinned buffers from the port's own pool
(:class:`PinnedPool`), not straight from torch's caching host allocator:
torch records a freed block's reuse event at free time on every stream
that used it, so when that stream is busy with later work the block stays
out of reach and the next request allocates anew. A pooled buffer comes
back when the last numpy view of it dies, and is reusable once its own
copy has finished, so the pool grows only when every buffer of a size is
held at once; a small size starts with several buffers, since a warm
repeat of a query overlaps more fetches than its cold first run.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from ..series import Series

_MIN_CAPACITY = 16

#: numpy dtypes the device planes may carry. Unsigned ints wider than a
#: byte widen to the next signed type (torch's uint16/32/64 support few
#: ops). uint64 rides an int64 plane, which holds it losslessly only below
#: 2^63: a column with a larger value has no device plane
#: (:func:`has_device_plane`), and no op on the device sees a uint64 tensor.
_WIDEN = {np.dtype("uint16"): np.dtype("int32"),
          np.dtype("uint32"): np.dtype("int64"),
          np.dtype("uint64"): np.dtype("int64")}

_U64_PLANE_LIMIT = 2 ** 63


#: numpy dtype of each torch dtype a device plane may have
NP_DTYPE = {torch.bool: np.bool_, torch.uint8: np.uint8,
            torch.int8: np.int8, torch.int16: np.int16,
            torch.int32: np.int32, torch.int64: np.int64,
            torch.float32: np.float32, torch.float64: np.float64}


def bucket_capacity(n: int) -> int:
    """Pad row counts to power-of-two buckets (minimum 16)."""
    c = _MIN_CAPACITY
    while c < n:
        c *= 2
    return c


def device_np_dtype(np_dtype) -> np.dtype:
    """The numpy dtype a plane of this numpy dtype carries on the device;
    raises ValueError for one that has no device plane."""
    d = np.dtype(np_dtype)
    d = _WIDEN.get(d, d)
    if d.kind not in "biuf":
        raise ValueError(f"{d} has no device plane")
    return d


def is_lossless_device_dtype(dtype) -> bool:
    """True when the device encoding round-trips bit-exactly, as pure
    data movement (the mesh repartition) needs (reference
    ``column.is_lossless_device_dtype``): decimals ride float64 (lossy),
    strings and binary ride dictionary codes, and a type without a device
    plane has nothing to move. float64 stays float64 on a CUDA card."""
    if dtype.is_decimal() or dtype.is_string() or dtype.is_binary():
        return False
    return dtype.to_physical().device_repr() is not None


def has_device_plane(s: Series) -> bool:
    """Whether this column's values travel to the device losslessly: not
    Python objects, and no uint64 value at or above 2^63."""
    if s.is_pyobject():
        return False
    arr = s.to_arrow()
    if pa.types.is_uint64(arr.type):
        top = pc.max(arr).as_py()
        return top is None or top < _U64_PLANE_LIMIT
    return True


@dataclass
class DeviceColumn:
    data: torch.Tensor                     # [capacity]
    validity: torch.Tensor                 # [capacity] bool
    dtype: object                          # logical DataType
    dictionary: Optional[pa.Array] = None  # sorted dictionary for codes


@dataclass
class DeviceTable:
    columns: Dict[str, DeviceColumn]
    row_mask: torch.Tensor                 # [capacity] bool — live rows
    row_count: int                         # host-side live count
    capacity: int
    #: the planes are shared with the device column cache or the residency
    #: registry: nothing may write into them
    resident: bool = False
    #: event recorded on the copy stream after this table's host→device
    #: copies (None on the CPU, or when nothing was copied)
    ready: Optional[object] = None
    #: the pinned staging buffers of those copies (numpy arrays over
    #: :class:`PinnedPool` buffers), held until a drain
    staging: Optional[list] = None

    @property
    def device(self) -> torch.device:
        return self.row_mask.device

    def planes(self) -> List[torch.Tensor]:
        return [t for c in self.columns.values()
                for t in (c.data, c.validity)] + [self.row_mask]

    def nbytes(self) -> int:
        return sum(t.nbytes for t in self.planes())


# ------------------------------------------------------- pinned pool

_PIN_MIN_BYTES = 4096
#: a size class of at most 1 MiB (the fetches of partial aggregates and
#: scalars, small staging) starts with 8 buffers: how many of them are
#: held at once follows the threads' timing (a warm repeat's dispatches
#: overlap more than its cold first run's), and 8 covers the default
#: window's slots (``device_inflight`` 2) with their fetches and
#: drains in flight; at most 8 MiB of pinned memory per class
_PIN_SMALL_CLASS = 1 << 20
_PIN_FIRST_BUFFERS = 8


class PinnedPool:
    """Pinned host buffers, one free list per power-of-two size. A
    :meth:`take` hands out a numpy view of a pooled buffer; the buffer
    goes back to its free list when that array (and every view of it, an
    Arrow array made from it included) dies, and is taken again only
    after the copy its lease names has finished. The free lists are
    deques (append and popleft are atomic), so a return may run on any
    thread, inside a garbage collection too. A small class starts with
    ``_PIN_FIRST_BUFFERS`` buffers; any class then grows one at a
    time."""

    def __init__(self, alloc=None):
        #: ``alloc(nbytes)`` → a uint8 host tensor (pinned on a card)
        self._alloc = alloc or (lambda n: torch.empty(
            n, dtype=torch.uint8, pin_memory=True))
        self._free: Dict[int, collections.deque] = {}
        self._grow_lock = threading.Lock()
        self._grown: set = set()       # the size classes allocated so far
        #: buffers allocated and their bytes (the pool's growth)
        self.counters = {"allocated": 0, "bytes": 0}

    @staticmethod
    def size_class(nbytes: int) -> int:
        b = _PIN_MIN_BYTES
        while b < nbytes:
            b *= 2
        return b

    def take(self, nbytes: int, dtype: torch.dtype = torch.uint8):
        """→ (tensor, array, lease): ``nbytes`` of a pooled buffer as a
        ``dtype`` tensor for the copy, the numpy array over the same bytes
        that holds the buffer out of the pool while it (or a view) lives,
        and the lease whose ``event`` the caller sets once the copy that
        uses the buffer is queued."""
        size = self.size_class(nbytes)
        free = self._free.setdefault(size, collections.deque())
        try:
            buf, ev = free.popleft()
        except IndexError:
            buf, ev = self._grow(size, free), None
        if ev is not None and not ev.query():
            ev.synchronize()
        t = buf[:nbytes].view(dtype)
        arr = t.numpy()
        lease = _Lease()
        weakref.finalize(arr, _give_back, free, buf, lease).atexit = False
        return t, arr, lease

    def _grow(self, size: int, free: collections.deque):
        """A new buffer of ``size`` for the caller; on a small class's first
        growth, its other first buffers go straight to ``free``."""
        with self._grow_lock:
            first = size not in self._grown
            self._grown.add(size)
        n = _PIN_FIRST_BUFFERS if first and size <= _PIN_SMALL_CLASS else 1
        bufs = [self._alloc(size) for _ in range(n)]
        with self._grow_lock:
            self.counters["allocated"] += n
            self.counters["bytes"] += n * size
        for b in bufs[1:]:
            free.append((b, None))
        return bufs[0]


class _Lease:
    """One hand-out of a pooled buffer: the event after which the copy
    that uses it has finished (None: no copy queued)."""

    __slots__ = ("event",)

    def __init__(self):
        self.event = None


def _give_back(free: collections.deque, buf, lease: _Lease) -> None:
    free.append((buf, lease.event))


#: the process's pool (every card's pinned buffers are host memory)
_pinned = PinnedPool()


# ------------------------------------------------------------ streams

_copy_streams: Dict[int, object] = {}
_stream_lock = threading.Lock()


def copy_stream(device: torch.device):
    """The card's dedicated host→device copy stream (one per card)."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    s = _copy_streams.get(idx)
    if s is None:
        with _stream_lock:
            s = _copy_streams.get(idx)
            if s is None:
                s = _copy_streams[idx] = torch.cuda.Stream(device=idx)
    return s


def use_on_current_stream(dt: DeviceTable) -> None:
    """Make a table safe to compute on from the current stream: wait for
    its copies, and mark every plane used there, so that the caching
    allocator does not hand a plane's memory to another stream (an
    eviction from the cache, say) while this stream's kernels still read
    it. A no-op on the CPU."""
    if dt.device.type != "cuda":
        return
    cur = torch.cuda.current_stream(dt.device)
    if dt.ready is not None:
        cur.wait_event(dt.ready)
    for t in dt.planes():
        t.record_stream(cur)


def on_stream(stream):
    """``torch.cuda.stream(stream)``, or nothing for None (the CPU)."""
    return torch.cuda.stream(stream) if stream is not None \
        else contextlib.nullcontext()


_uncounted = threading.local()


@contextlib.contextmanager
def uncounted():
    """Copies made inside, on this thread, bump no transfer counter: the
    link measurement and the rate measurements are not query work."""
    prev = getattr(_uncounted, "on", False)
    _uncounted.on = True
    try:
        yield
    finally:
        _uncounted.on = prev


def _count(name: str, n: int = 1) -> None:
    if getattr(_uncounted, "on", False):
        return
    from . import runtime
    runtime.count(name, n)


def _upload(planes: Sequence[np.ndarray], capacity: int,
            device: torch.device):
    """Host planes → ``[capacity]`` device tensors, zero-padded →
    (tensors, ready event or None, staging buffers or None). On a card:
    pooled pinned staging, one ``non_blocking`` copy each on the copy
    stream into tensors allocated on the current stream (which uses
    them), and the current stream waits on the copies' event."""
    _count("bytes_up", sum(capacity * a.dtype.itemsize for a in planes))
    if device.type != "cuda":
        return [torch.from_numpy(_pad(a, capacity)).to(device)
                for a in planes], None, None
    staging, srcs, leases, outs = [], [], [], []
    for a in planes:
        t, h, lease = _pinned.take(capacity * a.dtype.itemsize,
                                   torch.from_numpy(
                                       np.empty(0, dtype=a.dtype)).dtype)
        h[:len(a)] = a
        h[len(a):] = 0
        staging.append(h)
        srcs.append(t)
        leases.append(lease)
        outs.append(torch.empty(capacity, dtype=t.dtype, device=device))
    cur = torch.cuda.current_stream(device)
    cs = copy_stream(device)
    # the new tensors' memory may have been freed by work still queued on
    # the current stream: the copies start after it
    cs.wait_stream(cur)
    with torch.cuda.stream(cs):
        for d, t in zip(outs, srcs):
            d.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(cs)
    for lease in leases:
        lease.event = ev
    cur.wait_event(ev)
    _count("h2d_copies", len(planes))
    return outs, ev, staging


def _np_encode(s: Series):
    """Series → (values ndarray, validity ndarray, dictionary|None).

    Same lowering as the reference: strings become codes into their
    sorted dictionary, dates int32 days, other temporals int64, decimals
    float64; nulls fill with zero."""
    arr = s.to_arrow()
    dt = s.datatype()
    n = len(arr)
    validity = np.asarray(pc.is_valid(arr).to_numpy(zero_copy_only=False),
                          dtype=np.bool_)
    if dt.is_null():
        return np.zeros(n, dtype=np.int32), validity, None
    if dt.is_string() or dt.is_binary():
        enc = arr.dictionary_encode()
        d = enc.dictionary
        sort_idx = pc.array_sort_indices(d).to_numpy()
        ranks = np.empty(len(d), dtype=np.int32)
        ranks[sort_idx] = np.arange(len(d), dtype=np.int32)
        codes_raw = pc.fill_null(enc.indices, 0).to_numpy(
            zero_copy_only=False)
        codes = ranks[np.asarray(codes_raw, dtype=np.int64)] if len(d) \
            else np.zeros(n, dtype=np.int32)
        return codes.astype(np.int32), validity, d.take(pa.array(sort_idx))
    if dt.to_physical().device_repr() is None:
        raise ValueError(
            f"column {s.name()!r}: {dt!r} is not device-representable")
    if dt.kind == "date":
        arr = arr.cast(pa.int32())
    elif dt.is_temporal():
        arr = arr.cast(pa.int64())
    elif dt.is_decimal():
        arr = arr.cast(pa.float64())
    if dt.is_boolean():
        vals = np.asarray(pc.fill_null(arr, False).to_numpy(
            zero_copy_only=False), dtype=np.bool_)
    else:
        if not validity.all():
            # fill at the Arrow level so nullable ints don't decay to f64
            arr = pc.fill_null(arr, pa.scalar(0, type=arr.type))
        vals = np.asarray(arr.to_numpy(zero_copy_only=False))
    if vals.dtype == np.uint64 and len(vals) \
            and int(vals.max()) >= _U64_PLANE_LIMIT:
        raise ValueError(f"column {s.name()!r}: a uint64 value at or "
                         "above 2^63 has no int64 plane")
    return vals.astype(device_np_dtype(vals.dtype), copy=False), \
        validity, None


def _pad(x: np.ndarray, capacity: int) -> np.ndarray:
    out = np.zeros(capacity, dtype=x.dtype)
    out[:len(x)] = x
    return out


def encode_series(s: Series, capacity: int,
                  device: torch.device) -> DeviceColumn:
    """One Series onto ``device``, padded to ``capacity`` rows (its
    resident planes when they are still on the card at that capacity).
    Raises ValueError for a column that has no device plane."""
    res = _resident_column(s, capacity, device)
    if res is not None:
        return res
    vals, validity, dictionary = _np_encode(s)
    (data, valid), _, _ = _upload([vals, validity], capacity, device)
    return DeviceColumn(data, valid, s.datatype(), dictionary)


def _resident_column(s: Series, capacity: int,
                     device: torch.device) -> Optional[DeviceColumn]:
    """A decoded Series' resident planes, when they are on ``device`` at
    exactly ``capacity`` (reference ``column.py:275``)."""
    from . import pipeline
    hit = pipeline.resident_planes(s, len(s))
    if hit is None:
        return None
    data, validity, dictionary, cap = hit
    if cap != capacity or data.device != device:
        return None
    return DeviceColumn(data, validity, s.datatype(), dictionary)


def encoded_nbytes(batch, columns: Sequence[str]) -> int:
    """Bytes these columns occupy once encoded: the device plane's
    itemsize (strings: int32 dictionary codes; the dictionary stays on the
    host) times the power-of-two capacity, plus one validity byte per
    slot."""
    cap = bucket_capacity(max(len(batch), 1))
    total = 0
    for nm in columns:
        rep = batch.get_column(nm).datatype().to_physical().device_repr()
        total += cap * ((8 if rep is None else np.dtype(rep).itemsize) + 1)
    return total


def encode_batch(batch, columns: Sequence[str],
                 device: torch.device) -> DeviceTable:
    """Encode the named columns of a RecordBatch onto ``device``: every
    plane and the live-row mask in one round of copies (or the batch's
    resident planes, :func:`_resident_batch`)."""
    n = len(batch)
    cap = bucket_capacity(n)
    resident = _resident_batch(batch, columns, n, cap, device)
    if resident is not None:
        return resident
    enc = [(nm, _np_encode(batch.get_column(nm))) for nm in columns]
    host = [a for _, (vals, valid, _) in enc for a in (vals, valid)]
    host.append(np.ones(n, dtype=np.bool_))
    planes, ready, staging = _upload(host, cap, device)
    cols = {nm: DeviceColumn(planes[2 * i], planes[2 * i + 1],
                             batch.get_column(nm).datatype(), d)
            for i, (nm, (_, _, d)) in enumerate(enc)}
    return DeviceTable(cols, planes[-1], n, cap, ready=ready,
                       staging=staging)


def _resident_batch(batch, names, n: int, cap: int, device: torch.device
                    ) -> Optional[DeviceTable]:
    """Every requested column's decoded planes still resident on
    ``device`` at one shared capacity of at least ``cap`` → a table of
    them and a fresh live-row mask, marked ``resident`` (reference
    ``column.py:330``); else None."""
    from . import pipeline
    hits = {}
    shared_cap = None
    for nm in names:
        s = batch.get_column(nm)
        hit = pipeline.resident_planes(s, n)
        if hit is None:
            return None
        data, validity, dictionary, ccap = hit
        if ccap < cap or data.device != device \
                or (shared_cap is not None and ccap != shared_cap):
            return None
        shared_cap = ccap
        hits[nm] = DeviceColumn(data, validity, s.datatype(), dictionary)
    if shared_cap is None:
        return None
    mask = torch.arange(shared_cap, device=device) < n
    return DeviceTable(hits, mask, n, shared_cap, resident=True)


def from_reference_planes(arrays: Dict[str, np.ndarray],
                          valids: Dict[str, np.ndarray],
                          row_mask: np.ndarray,
                          device: torch.device,
                          dtypes: Optional[Dict[str, object]] = None,
                          dictionaries: Optional[Dict[str, pa.Array]] = None
                          ) -> DeviceTable:
    """Carry-over: the reference's encoded device planes (as numpy arrays,
    already padded to one capacity) become this package's DeviceTable, so
    both packages compute on bit-identical inputs."""
    cap = int(row_mask.shape[0])
    cols = {}
    for nm, a in arrays.items():
        a = np.ascontiguousarray(a)
        a = a.astype(device_np_dtype(a.dtype), copy=False)
        v = np.ascontiguousarray(valids[nm], dtype=np.bool_)
        if a.shape != (cap,) or v.shape != (cap,):
            raise ValueError(f"plane {nm!r} is not [{cap}]")
        cols[nm] = DeviceColumn(
            torch.from_numpy(a.copy()).to(device),
            torch.from_numpy(v.copy()).to(device),
            (dtypes or {}).get(nm), (dictionaries or {}).get(nm))
    mask = np.ascontiguousarray(row_mask, dtype=np.bool_)
    return DeviceTable(cols, torch.from_numpy(mask.copy()).to(device),
                       int(mask.sum()), cap)


def decode_np(name: str, dtype, vals: np.ndarray, validity: np.ndarray,
              dictionary: Optional[pa.Array] = None) -> Series:
    """Host-side decode of already-fetched planes → Series of the logical
    ``dtype`` (codes route through ``dictionary``)."""
    count = len(vals)
    if dtype.is_null():
        return Series(name, dtype, arrow=pa.nulls(count))
    if dictionary is not None and len(dictionary) == 0:
        # a column with no valid value encodes to an empty dictionary:
        # every row is null
        return Series(name, dtype,
                      arrow=pa.nulls(count, type=dtype.to_arrow()))
    if dictionary is not None:
        codes = np.where(validity, vals.astype(np.int64), 0)
        arr = dictionary.take(pa.array(codes, type=pa.int64()))
        if arr.type != dtype.to_arrow():
            arr = arr.cast(dtype.to_arrow())
        if not validity.all():
            arr = pc.if_else(pa.array(validity), arr,
                             pa.nulls(count, type=dtype.to_arrow()))
        return Series(name, dtype, arrow=arr)
    target = dtype.to_arrow()
    if dtype.kind == "date":
        arr = pa.array(vals.astype(np.int32), mask=~validity).cast(target)
    elif dtype.is_temporal():
        arr = pa.array(vals.astype(np.int64), mask=~validity).cast(target)
    elif dtype.is_boolean():
        arr = pa.array(vals.astype(np.bool_), mask=~validity)
    else:
        rep = dtype.device_repr()
        if rep is not None and vals.dtype != rep:
            vals = vals.astype(rep)
        arr = pa.array(vals, mask=~validity)
        if arr.type != target:
            arr = arr.cast(target)
    return Series(name, dtype, arrow=arr)


class HostFetch:
    """One device→host copy in flight: :meth:`wait` blocks on its event
    and splits the pinned host buffer into the planes."""

    __slots__ = ("_planes", "_order", "_host", "_event", "_out")

    def __init__(self, planes, order=None, host=None, event=None,
                 out=None):
        self._planes = [(tuple(p.shape), p.dtype, p.numel()
                         * p.element_size()) for p in planes]
        self._order, self._host, self._event = order, host, event
        self._out = out

    def wait(self) -> List[np.ndarray]:
        if self._out is not None:
            return self._out
        self._event.synchronize()
        host = self._host
        out: List[Optional[np.ndarray]] = [None] * len(self._planes)
        off = 0
        for i in self._order:
            shape, dt, nb = self._planes[i]
            out[i] = host[off:off + nb].view(NP_DTYPE[dt]).reshape(shape)
            off += nb
        self._out = out
        return out


def fetch_host_async(planes: Sequence[torch.Tensor]) -> HostFetch:
    """Start ONE device→host copy of many device planes on the current
    stream: their bytes are concatenated on the device (widest dtype
    first, so every plane stays aligned in the host buffer) and copied
    with ``non_blocking=True`` into a pinned buffer. CPU tensors come
    back as views, at once."""
    if not planes or all(p.device.type == "cpu" for p in planes):
        return HostFetch([], out=[p.numpy() for p in planes])
    order = sorted(range(len(planes)),
                   key=lambda i: -planes[i].element_size())
    flat = torch.cat([planes[i].contiguous().reshape(-1).view(torch.uint8)
                      for i in order])
    host, arr, lease = _pinned.take(flat.numel())
    host.copy_(flat, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(flat.device))
    lease.event = ev
    _count("d2h_copies")
    _count("bytes_down", flat.numel())
    return HostFetch(planes, order, arr, ev)


def fetch_host(planes: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Many device planes → host numpy arrays in ONE device→host copy
    (:func:`fetch_host_async`, then its wait)."""
    return fetch_host_async(planes).wait()



def fetch_columns(named: Sequence[Tuple[str, DeviceColumn]],
                  count: int) -> List[np.ndarray]:
    """The first ``count`` rows of every data and validity plane of many
    DeviceColumns, in ONE device→host copy (:func:`decode_fetched`
    decodes them)."""
    return fetch_host([p for _, c in named
                       for p in (c.data[:count], c.validity[:count])])


def decode_fetched(named: Sequence[Tuple[str, DeviceColumn]],
                   host: Sequence[np.ndarray], count: int) -> List[Series]:
    """Decode :func:`fetch_columns`' planes into Series. While the
    pipeline is on, each decoded Series registers its device planes for
    reuse by a later encode (reference ``column.py:384``); decimals do
    not, since their float64 encoding is lossy."""
    from . import pipeline
    register = pipeline.inflight_window() > 0
    out = []
    for i, (name, c) in enumerate(named):
        s = decode_np(name, c.dtype, host[2 * i], host[2 * i + 1],
                      c.dictionary)
        if register and not c.dtype.is_decimal() \
                and not c.dtype.is_null():
            pipeline.note_decoded(s, c.data, c.validity, c.dictionary,
                                  count, int(c.data.shape[0]))
        out.append(s)
    return out

"""WARC (Web ARChive / Common Crawl) streaming reader.

Capability mirror of the reference's ``src/daft-warc`` crate: parses
``.warc`` / ``.warc.gz`` files into the fixed 7-column schema
(``src/daft-warc/src/lib.rs:615-632``) — mandatory metadata columns,
``warc_content`` raw bytes, and the remaining record headers as a JSON
string.

The port's copy of ``daft_tpu/io/warc.py``.
"""

from __future__ import annotations

import datetime
import gzip
import io
import json
from typing import BinaryIO, Iterator, Optional, Tuple

import pyarrow as pa

from ..datatype import DataType, TimeUnit
from ..schema import Field, Schema

# the reference's fixed WARC schema (lib.rs:615)
WARC_SCHEMA = Schema([
    Field("WARC-Record-ID", DataType.string()),
    Field("WARC-Type", DataType.string()),
    Field("WARC-Date", DataType.timestamp(TimeUnit.ns, "Etc/UTC")),
    Field("Content-Length", DataType.int64()),
    Field("WARC-Identified-Payload-Type", DataType.string()),
    Field("warc_content", DataType.binary()),
    Field("warc_headers", DataType.string()),
])

_MANDATORY = ("WARC-Record-ID", "WARC-Type", "WARC-Date", "Content-Length",
              "WARC-Identified-Payload-Type")


def _open(path: str) -> BinaryIO:
    if path.endswith(".gz"):
        # gzip.open(path) owns + closes the underlying fd (a passed fileobj
        # would be left open); handles multi-member (one member per record)
        return gzip.open(path, "rb")
    return open(path, "rb")


def _read_record(f: BinaryIO) -> Optional[Tuple[dict, bytes]]:
    """Parse one WARC record: version line, CRLF headers, blank line,
    Content-Length bytes of block, trailing CRLF CRLF."""
    # skip inter-record blank lines
    line = f.readline()
    while line in (b"\r\n", b"\n"):
        line = f.readline()
    if not line:
        return None
    if not line.startswith(b"WARC/"):
        raise ValueError(f"malformed WARC record header: {line[:40]!r}")
    headers = {}
    last_key = None
    while True:
        line = f.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        text = line.decode("utf-8", errors="replace")
        if text[:1] in (" ", "\t") and last_key is not None:
            # folded (continuation) header line per the WARC/1.1 grammar:
            # append to the previous header's value
            headers[last_key] += " " + text.strip()
            continue
        k, _, v = text.partition(":")
        last_key = k.strip()
        headers[last_key] = v.strip()
    length = int(headers.get("Content-Length", 0))
    content = f.read(length)
    return headers, content


_EPOCH_UTC = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)


def _parse_warc_date(v: Optional[str]) -> Optional[int]:
    """→ ns since epoch. Naive dates are taken as UTC (WARC-Date is defined
    as UTC); integer arithmetic keeps ns exact (float timestamp() has ~256ns
    spacing at current epochs)."""
    if not v:
        return None
    try:
        dt = datetime.datetime.fromisoformat(v.replace("Z", "+00:00"))
    except ValueError:
        return None
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=datetime.timezone.utc)
    micros = (dt - _EPOCH_UTC) // datetime.timedelta(microseconds=1)
    return micros * 1000


def iter_records(path: str) -> Iterator[Tuple[dict, bytes]]:
    with _open(path) as f:
        # gzip.open(fileobj) lacks readline buffering guarantees we rely on
        if isinstance(f, gzip.GzipFile):
            f = io.BufferedReader(f)
        while True:
            rec = _read_record(f)
            if rec is None:
                return
            yield rec


def read_warc_file(path: str, limit: Optional[int] = None) -> pa.Table:
    ids, types, dates, lengths, payload_types = [], [], [], [], []
    contents, extra_headers = [], []
    for headers, content in iter_records(path):
        ids.append(headers.get("WARC-Record-ID"))
        types.append(headers.get("WARC-Type"))
        dates.append(_parse_warc_date(headers.get("WARC-Date")))
        cl = headers.get("Content-Length")
        lengths.append(int(cl) if cl is not None else None)
        payload_types.append(headers.get("WARC-Identified-Payload-Type"))
        contents.append(content)
        rest = {k: v for k, v in headers.items() if k not in _MANDATORY}
        extra_headers.append(json.dumps(rest))
        if limit is not None and len(ids) >= limit:
            break
    ts_type = pa.timestamp("ns", tz="Etc/UTC")
    return pa.table({
        "WARC-Record-ID": pa.array(ids, pa.large_string()),
        "WARC-Type": pa.array(types, pa.large_string()),
        "WARC-Date": pa.array(dates, pa.int64()).cast(ts_type),
        "Content-Length": pa.array(lengths, pa.int64()),
        "WARC-Identified-Payload-Type": pa.array(payload_types,
                                                 pa.large_string()),
        "warc_content": pa.array(contents, pa.large_binary()),
        "warc_headers": pa.array(extra_headers, pa.large_string()),
    })

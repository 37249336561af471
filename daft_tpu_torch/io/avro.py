"""Minimal Avro Object Container File codec (read + write).

Iceberg's manifest lists and manifest files are Avro; the reference reads
them through pyiceberg (``daft/io/_iceberg.py``). This is a
dependency-free, schema-driven implementation of the Avro 1.11 spec subset
those files use: container framing (magic ``Obj\\x01``, metadata map, sync
markers, deflate/null codecs) and the binary encoding of null / boolean /
int / long (zigzag varints) / float / double / bytes / string / fixed /
enum / array / map / union / record. Values decode to plain dicts keyed by
field name, so callers pull what they need without hardcoding Iceberg's
schemas.

The port's copy of ``daft_tpu/io/avro.py``.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

_MAGIC = b"Obj\x01"


# ---------------------------------------------------------------- binary

def _read_varint(buf) -> int:
    shift = 0
    out = 0
    while True:
        b = buf.read(1)
        if not b:
            raise EOFError("truncated varint")
        v = b[0]
        out |= (v & 0x7F) << shift
        if not v & 0x80:
            break
        shift += 7
    return out


def _read_long(buf) -> int:
    n = _read_varint(buf)
    return (n >> 1) ^ -(n & 1)  # zigzag


def _write_varint(out, n: int) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _write_long(out, v: int) -> None:
    _write_varint(out, (v << 1) ^ (v >> 63))


class _Decoder:
    def __init__(self, data: bytes):
        self.buf = io.BytesIO(data)

    def decode(self, schema) -> Any:
        if isinstance(schema, list):  # union
            idx = _read_long(self.buf)
            return self.decode(schema[idx])
        if isinstance(schema, dict):
            t = schema["type"]
            if t == "record":
                return {f["name"]: self.decode(f["type"])
                        for f in schema["fields"]}
            if t == "array":
                return self._blocks(lambda: self.decode(schema["items"]))
            if t == "map":
                out = {}
                for k, v in self._blocks(lambda: (
                        self._string(), self.decode(schema["values"]))):
                    out[k] = v
                return out
            if t == "fixed":
                return self.buf.read(schema["size"])
            if t == "enum":
                return schema["symbols"][_read_long(self.buf)]
            return self.decode(t)  # {"type": "string", logicalType...}
        if schema == "null":
            return None
        if schema == "boolean":
            return self.buf.read(1) == b"\x01"
        if schema in ("int", "long"):
            return _read_long(self.buf)
        if schema == "float":
            return struct.unpack("<f", self.buf.read(4))[0]
        if schema == "double":
            return struct.unpack("<d", self.buf.read(8))[0]
        if schema == "bytes":
            return self.buf.read(_read_long(self.buf))
        if schema == "string":
            return self._string()
        raise ValueError(f"unsupported avro type {schema!r}")

    def _string(self) -> str:
        return self.buf.read(_read_long(self.buf)).decode("utf-8")

    def _blocks(self, item) -> List[Any]:
        out = []
        while True:
            n = _read_long(self.buf)
            if n == 0:
                return out
            if n < 0:  # block with byte size prefix
                n = -n
                _read_long(self.buf)
            for _ in range(n):
                out.append(item())


class _Encoder:
    def __init__(self):
        self.out = bytearray()

    def encode(self, schema, value) -> None:
        if isinstance(schema, list):  # union: pick first matching branch
            idx = _union_branch(schema, value)
            _write_long(self.out, idx)
            self.encode(schema[idx], value)
            return
        if isinstance(schema, dict):
            t = schema["type"]
            if t == "record":
                for f in schema["fields"]:
                    self.encode(f["type"], value.get(f["name"]))
                return
            if t == "array":
                if value:
                    _write_long(self.out, len(value))
                    for v in value:
                        self.encode(schema["items"], v)
                _write_long(self.out, 0)
                return
            if t == "map":
                if value:
                    _write_long(self.out, len(value))
                    for k, v in value.items():
                        self._string(k)
                        self.encode(schema["values"], v)
                _write_long(self.out, 0)
                return
            if t == "fixed":
                assert len(value) == schema["size"]
                self.out += value
                return
            if t == "enum":
                _write_long(self.out, schema["symbols"].index(value))
                return
            self.encode(t, value)
            return
        if schema == "null":
            return
        if schema == "boolean":
            self.out.append(1 if value else 0)
        elif schema in ("int", "long"):
            _write_long(self.out, int(value))
        elif schema == "float":
            self.out += struct.pack("<f", value)
        elif schema == "double":
            self.out += struct.pack("<d", value)
        elif schema == "bytes":
            _write_long(self.out, len(value))
            self.out += value
        elif schema == "string":
            self._string(value)
        else:
            raise ValueError(f"unsupported avro type {schema!r}")

    def _string(self, s: str) -> None:
        b = s.encode("utf-8")
        _write_long(self.out, len(b))
        self.out += b


def _union_branch(union: list, value) -> int:
    def matches(s) -> bool:
        name = s if isinstance(s, str) else s.get("type")
        if value is None:
            return name == "null"
        if name == "null":
            return False
        if isinstance(value, bool):
            return name == "boolean"
        if isinstance(value, int):
            return name in ("int", "long")
        if isinstance(value, float):
            return name in ("float", "double")
        if isinstance(value, str):
            return name in ("string", "enum")
        if isinstance(value, bytes):
            return name in ("bytes", "fixed")
        if isinstance(value, dict):
            return name in ("record", "map")
        if isinstance(value, list):
            return name == "array"
        return False

    for i, s in enumerate(union):
        if matches(s):
            return i
    raise ValueError(f"no union branch for {type(value)} in {union}")


# ------------------------------------------------------------- container

def read_avro(data: bytes) -> Tuple[dict, List[dict]]:
    """→ (metadata, records). ``metadata`` holds the decoded file metadata
    (``avro.schema`` parsed to JSON under key ``schema``)."""
    buf = io.BytesIO(data)
    if buf.read(4) != _MAGIC:
        raise ValueError("not an avro object container file")
    dec = _Decoder(b"")
    dec.buf = buf
    meta_raw = {}
    while True:
        n = _read_long(buf)
        if n == 0:
            break
        if n < 0:
            n = -n
            _read_long(buf)
        for _ in range(n):
            k = dec._string()
            v = buf.read(_read_long(buf))
            meta_raw[k] = v
    sync = buf.read(16)
    # metadata keys decode as strings, values stay bytes
    schema = json.loads(meta_raw["avro.schema"])
    codec = meta_raw.get("avro.codec", b"null").decode()
    records: List[dict] = []
    while True:
        head = buf.read(1)
        if not head:
            break
        buf.seek(-1, io.SEEK_CUR)
        count = _read_long(buf)
        nbytes = _read_long(buf)
        block = buf.read(nbytes)
        if codec == "deflate":
            block = zlib.decompress(block, -15)
        elif codec != "null":
            raise ValueError(f"unsupported avro codec {codec!r}")
        bd = _Decoder(block)
        for _ in range(count):
            records.append(bd.decode(schema))
        if buf.read(16) != sync:
            raise ValueError("avro sync marker mismatch")
    return {"schema": schema, "codec": codec}, records


def write_avro(schema: dict, records: List[dict],
               metadata: Optional[Dict[str, str]] = None,
               codec: str = "null") -> bytes:
    """Records → one-block Avro object container file."""
    out = bytearray()
    out += _MAGIC
    meta = {"avro.schema": json.dumps(schema), "avro.codec": codec}
    meta.update(metadata or {})
    enc = _Encoder()
    _write_long(enc.out, len(meta))
    for k, v in meta.items():
        enc._string(k)
        vb = v.encode() if isinstance(v, str) else v
        _write_long(enc.out, len(vb))
        enc.out += vb
    _write_long(enc.out, 0)
    out += enc.out
    sync = os.urandom(16)
    out += sync
    body = _Encoder()
    for r in records:
        body.encode(schema, r)
    block = bytes(body.out)
    if codec == "deflate":
        c = zlib.compressobj(wbits=-15)
        block = c.compress(block) + c.flush()
    tail = _Encoder()
    _write_long(tail.out, len(records))
    _write_long(tail.out, len(block))
    out += tail.out
    out += block
    out += sync
    return bytes(out)

"""The port's object sources against in-process mock servers, and its
remote reads against the reference's (the subsets of ``tests/test_s3.py``,
``tests/test_gcs_azure.py`` and ``tests/test_hf.py``). The mock servers
are those files' own: stdlib HTTP servers speaking just enough of each
REST API (ranged GET, HEAD or stat, PUT, paginated listing). Every
end-to-end read runs through ``daft_tpu`` (JAX on the CPU) and
``daft_tpu_torch`` (``DAFT_TORCH_DEVICE=cpu``) and the answers must be
equal."""

import base64
import http.server
import io as _io
import json
import re
import threading
import urllib.parse

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.io import object_io as ref_object_io
from daft_tpu_torch.io import object_io
from daft_tpu_torch.io.azure import AzureBlobSource, _parse_az_url
from daft_tpu_torch.io.gcs import GCSSource
from daft_tpu_torch.io.hf import HFSource, _parse_hf_url
from daft_tpu_torch.io.object_io import (AzureConfig, GCSConfig,
                                         IOStatsContext, S3Config)
from daft_tpu_torch.io.s3 import S3ReadableFile, S3Source, _glob_regex


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("DAFT_TPU_DEVICE", "0")


def _fresh_clients(monkeypatch):
    """Both packages' default IO clients rebuilt from the environment."""
    monkeypatch.setattr(object_io, "_default_client", None)
    monkeypatch.setattr(ref_object_io, "_default_client", None)


def _both(fn):
    want, got = fn(daft_tpu), fn(daft_tpu_torch)
    assert got == want
    return got


def _parquet_bytes(t) -> bytes:
    buf = _io.BytesIO()
    pq.write_table(t, buf)
    return buf.getvalue()


def _serve(handler):
    handler.store = {}
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


# ------------------------------------------------------------------- S3

class _MockS3Handler(http.server.BaseHTTPRequestHandler):
    store = {}
    fail_next = []  # status codes to fail with, consumed per request

    def log_message(self, *a):
        pass

    def _fail_if_scripted(self):
        if self.fail_next:
            code = self.fail_next.pop(0)
            self.send_response(code)
            self.end_headers()
            return True
        return False

    def _parse(self):
        u = urllib.parse.urlparse(self.path)
        parts = u.path.lstrip("/").split("/", 1)
        bucket = parts[0]
        key = urllib.parse.unquote(parts[1]) if len(parts) > 1 else ""
        return bucket, key, urllib.parse.parse_qs(u.query)

    def do_PUT(self):
        if self._fail_if_scripted():
            return
        bucket, key, _ = self._parse()
        n = int(self.headers.get("Content-Length", 0))
        self.store[(bucket, key)] = self.rfile.read(n)
        self.send_response(200)
        self.end_headers()

    def do_HEAD(self):
        bucket, key, _ = self._parse()
        data = self.store.get((bucket, key))
        if data is None:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()

    def do_GET(self):
        if self._fail_if_scripted():
            return
        bucket, key, q = self._parse()
        if "list-type" in q:
            prefix = q.get("prefix", [""])[0]
            token = q.get("continuation-token", [None])[0]
            keys = sorted(k for (b, k) in self.store
                          if b == bucket and k.startswith(prefix))
            page = 2  # force pagination
            start = keys.index(token) if token else 0
            chunk = keys[start:start + page]
            truncated = start + page < len(keys)
            items = "".join(
                f"<Contents><Key>{k}</Key>"
                f"<Size>{len(self.store[(bucket, k)])}</Size></Contents>"
                for k in chunk)
            nxt = (f"<NextContinuationToken>{keys[start + page]}"
                   f"</NextContinuationToken>") if truncated else ""
            body = (f"<?xml version='1.0'?><ListBucketResult>"
                    f"<IsTruncated>{'true' if truncated else 'false'}"
                    f"</IsTruncated>{items}{nxt}</ListBucketResult>"
                    ).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        data = self.store.get((bucket, key))
        if data is None:
            self.send_response(404)
            self.end_headers()
            return
        rng = self.headers.get("Range")
        if rng:
            spec = rng.split("=")[1]
            start_s, end_s = spec.split("-")
            start = int(start_s)
            end = min(int(end_s), len(data) - 1)
            chunk = data[start:end + 1]
            self.send_response(206)
            self.send_header("Content-Length", str(len(chunk)))
            self.end_headers()
            self.wfile.write(chunk)
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


@pytest.fixture(scope="module")
def mock_s3():
    server = _serve(_MockS3Handler)
    yield f"http://127.0.0.1:{server.server_port}"
    server.shutdown()


@pytest.fixture
def s3(mock_s3, monkeypatch):
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "test-key")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "test-secret")
    monkeypatch.setenv("AWS_ENDPOINT_URL", mock_s3)
    monkeypatch.setenv("AWS_REGION", "us-east-1")
    _fresh_clients(monkeypatch)
    return S3Source(S3Config(endpoint_url=mock_s3, key_id="test-key",
                             access_key="test-secret",
                             region_name="us-east-1"))


def test_s3_put_get_roundtrip(s3):
    s3.put("s3://bkt/a/hello.bin", b"hello world")
    assert s3.get("s3://bkt/a/hello.bin") == b"hello world"
    assert s3.get_size("s3://bkt/a/hello.bin") == 11


def test_s3_range_get(s3):
    s3.put("s3://bkt/range.bin", bytes(range(100)))
    assert s3.get("s3://bkt/range.bin", (10, 20)) == bytes(range(10, 20))


def test_s3_missing_object_raises(s3):
    with pytest.raises(FileNotFoundError):
        s3.get("s3://bkt/nope.bin")


def test_s3_glob_with_pagination(s3):
    for i in range(5):
        s3.put(f"s3://bkt/glob/part-{i}.parquet", b"x" * i)
    s3.put("s3://bkt/glob/skip.csv", b"y")
    s3.put("s3://bkt/glob/sub/deep-0.parquet", b"z")
    stats = IOStatsContext()
    hits = s3.glob("s3://bkt/glob/*.parquet", stats=stats)
    assert hits == [f"s3://bkt/glob/part-{i}.parquet" for i in range(5)]
    assert stats.num_lists >= 3  # paginated (2 keys per page)
    assert "s3://bkt/glob/sub/deep-0.parquet" in s3.glob("s3://bkt/glob/**")


def test_s3_retry_on_5xx(s3):
    s3.put("s3://bkt/flaky.bin", b"ok")
    _MockS3Handler.fail_next = [500, 503]
    assert s3.get("s3://bkt/flaky.bin") == b"ok"
    _MockS3Handler.fail_next = [404]
    with pytest.raises(FileNotFoundError):
        s3.get("s3://bkt/flaky.bin")  # a 404 is not retried
    _MockS3Handler.fail_next = []


def test_s3_ranged_file_reads_parquet(s3):
    t = pa.table({"x": list(range(1000)),
                  "y": [i * 0.5 for i in range(1000)]})
    s3.put("s3://bkt/data/t.parquet", _parquet_bytes(t))
    stats = IOStatsContext()
    f = S3ReadableFile(s3, "s3://bkt/data/t.parquet", stats=stats)
    assert pq.read_table(pa.PythonFile(f, mode="r")).equals(t)
    assert stats.num_gets >= 1


def test_s3_read_parquet_end_to_end(s3):
    t = pa.table({"k": [1, 2, 3, 1, 2], "v": [1.0, 2.0, 3.0, 4.0, 5.0]})
    for i in range(2):
        s3.put(f"s3://bkt/tbl/part-{i}.parquet", _parquet_bytes(t))
    out = _both(lambda pkg: pkg.read_parquet("s3://bkt/tbl/*.parquet")
                .groupby("k").agg(pkg.col("v").sum().alias("s"))
                .sort("k").to_pydict())
    assert out == {"k": [1, 2, 3], "s": [10.0, 14.0, 6.0]}


def test_s3_read_csv_end_to_end(s3):
    s3.put("s3://bkt/csv/a.csv", b"a,b\n1,x\n2,y\n")
    assert _both(lambda pkg: pkg.read_csv("s3://bkt/csv/a.csv")
                 .to_pydict()) == {"a": [1, 2], "b": ["x", "y"]}


def test_s3_io_config_reaches_the_source(mock_s3, monkeypatch):
    """An explicit ``IOConfig`` (no environment) carries the endpoint and
    keys to the scan's planning and its reads."""
    for k in ("AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY",
              "AWS_ENDPOINT_URL"):
        monkeypatch.delenv(k, raising=False)
    cfg = daft_tpu_torch.IOConfig(s3=daft_tpu_torch.S3Config(
        endpoint_url=mock_s3, key_id="k2", access_key="s2",
        region_name="us-east-1"))
    src = S3Source(cfg.s3)
    t = pa.table({"x": [5, 6, 7]})
    src.put("s3://cfg/t.parquet", _parquet_bytes(t))
    df = daft_tpu_torch.read_parquet("s3://cfg/*.parquet", io_config=cfg)
    assert df.where(daft_tpu_torch.col("x") > 5).to_pydict() == \
        {"x": [6, 7]}


def test_glob_regex_segments():
    assert re.match(_glob_regex("a/*.parquet"), "a/x.parquet")
    assert not re.match(_glob_regex("a/*.parquet"), "a/b/x.parquet")
    assert re.match(_glob_regex("a/**"), "a/b/c.parquet")
    assert re.match(_glob_regex("a/part-?.csv"), "a/part-1.csv")
    assert not re.match(_glob_regex("a/part-?.csv"), "a/part-10.csv")


# ------------------------------------------------------------- GCS, Azure

class _MockGCSHandler(http.server.BaseHTTPRequestHandler):
    store = {}

    def log_message(self, *a):
        pass

    def _send(self, status, body=b"", ctype="application/json"):
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        u = urllib.parse.urlparse(self.path)
        q = urllib.parse.parse_qs(u.query)
        # /upload/storage/v1/b/<bucket>/o?uploadType=media&name=<key>
        parts = u.path.strip("/").split("/")
        assert parts[:4] == ["upload", "storage", "v1", "b"], parts
        bucket = parts[4]
        key = urllib.parse.unquote(q["name"][0])
        n = int(self.headers.get("Content-Length", 0))
        self.store[(bucket, key)] = self.rfile.read(n)
        self._send(200, b"{}")

    def do_GET(self):
        u = urllib.parse.urlparse(self.path)
        q = urllib.parse.parse_qs(u.query)
        parts = u.path.strip("/").split("/", 4)
        # /storage/v1/b/<bucket>/o[/<key>]
        bucket = parts[3]
        rest = parts[4] if len(parts) > 4 else "o"
        if rest == "o":  # list
            prefix = q.get("prefix", [""])[0]
            token = q.get("pageToken", [None])[0]
            keys = sorted(k for (b, k) in self.store
                          if b == bucket and k.startswith(prefix))
            page = 2  # force pagination
            start = keys.index(token) if token else 0
            chunk = keys[start:start + page]
            payload = {"items": [
                {"name": k, "size": str(len(self.store[(bucket, k)]))}
                for k in chunk]}
            if start + page < len(keys):
                payload["nextPageToken"] = keys[start + page]
            self._send(200, json.dumps(payload).encode())
            return
        key = urllib.parse.unquote(rest[2:])  # strip "o/"
        data = self.store.get((bucket, key))
        if data is None:
            self._send(404, b"{}")
            return
        if q.get("alt", [None])[0] == "media":
            rng = self.headers.get("Range")
            if rng:
                spec = rng.split("=")[1]
                s, e = spec.split("-")
                chunk = data[int(s):int(e) + 1]
                self._send(206, chunk, "application/octet-stream")
                return
            self._send(200, data, "application/octet-stream")
            return
        self._send(200, json.dumps({"name": key,
                                    "size": str(len(data))}).encode())



class _MockAzureHandler(http.server.BaseHTTPRequestHandler):
    store = {}
    seen_auth = []

    def log_message(self, *a):
        pass

    def _parse(self):
        u = urllib.parse.urlparse(self.path)
        # path-style /<account>/<container>[/<blob>]
        parts = u.path.lstrip("/").split("/", 2)
        account, container = parts[0], parts[1] if len(parts) > 1 else ""
        blob = urllib.parse.unquote(parts[2]) if len(parts) > 2 else ""
        return account, container, blob, urllib.parse.parse_qs(u.query)

    def _send(self, status, body=b"", headers=()):
        self.send_response(status)
        for k, v in headers:
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_PUT(self):
        _, container, blob, _ = self._parse()
        self.seen_auth.append(self.headers.get("Authorization", ""))
        n = int(self.headers.get("Content-Length", 0))
        self.store[(container, blob)] = self.rfile.read(n)
        self._send(201)

    def do_HEAD(self):
        _, container, blob, _ = self._parse()
        data = self.store.get((container, blob))
        if data is None:
            self._send(404)
            return
        # HEAD: Content-Length carries the blob size, no body follows
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()

    def do_GET(self):
        _, container, blob, q = self._parse()
        self.seen_auth.append(self.headers.get("Authorization", ""))
        if q.get("comp", [None])[0] == "list":
            prefix = q.get("prefix", [""])[0]
            marker = q.get("marker", [None])[0]
            keys = sorted(k for (c, k) in self.store
                          if c == container and k.startswith(prefix))
            page = 2
            start = keys.index(marker) if marker else 0
            chunk = keys[start:start + page]
            blobs = "".join(
                f"<Blob><Name>{k}</Name><Properties><Content-Length>"
                f"{len(self.store[(container, k)])}</Content-Length>"
                f"</Properties></Blob>" for k in chunk)
            nxt = keys[start + page] if start + page < len(keys) else ""
            body = (f"<?xml version='1.0'?><EnumerationResults>"
                    f"<Blobs>{blobs}</Blobs><NextMarker>{nxt}</NextMarker>"
                    f"</EnumerationResults>").encode()
            self._send(200, body)
            return
        data = self.store.get((container, blob))
        if data is None:
            self._send(404)
            return
        rng = self.headers.get("Range") or self.headers.get("range")
        if rng:
            spec = rng.split("=")[1]
            s, e = spec.split("-")
            self._send(206, data[int(s):int(e) + 1])
            return
        self._send(200, data)


@pytest.fixture(scope="module")
def gcs():
    server = _serve(_MockGCSHandler)
    src = GCSSource(GCSConfig(
        endpoint_url=f"http://127.0.0.1:{server.server_port}",
        access_token="test-token"))
    yield src
    server.shutdown()


@pytest.fixture(scope="module")
def az():
    server = _serve(_MockAzureHandler)
    # base64 key so SharedKey signing round-trips
    key = base64.b64encode(b"secret-key-bytes").decode()
    src = AzureBlobSource(AzureConfig(
        storage_account="acct", access_key=key,
        endpoint_url=f"http://127.0.0.1:{server.server_port}"))
    yield src
    server.shutdown()


def test_gcs_put_get_roundtrip(gcs):
    gcs.put("gs://bkt/dir/x.bin", b"gcs bytes")
    assert gcs.get("gs://bkt/dir/x.bin") == b"gcs bytes"
    assert gcs.get_size("gs://bkt/dir/x.bin") == 9


def test_gcs_range_get(gcs):
    gcs.put("gs://bkt/r.bin", b"0123456789")
    assert gcs.get("gs://bkt/r.bin", byte_range=(2, 6)) == b"2345"
    assert gcs.get_ranges("gs://bkt/r.bin", [(0, 2), (8, 10)],
                          parallelism=2) == [b"01", b"89"]


def test_gcs_glob_with_pagination(gcs):
    for i in range(5):
        gcs.put(f"gs://bkt/part/{i}.parquet", b"x" * (i + 1))
    gcs.put("gs://bkt/part/readme.txt", b"no")
    stats = IOStatsContext()
    hits = gcs.glob("gs://bkt/part/*.parquet", stats=stats)
    assert hits == [f"gs://bkt/part/{i}.parquet" for i in range(5)]
    assert stats.num_lists >= 3  # paginated (2 per page)


def test_gcs_missing_raises(gcs):
    with pytest.raises(FileNotFoundError):
        gcs.get("gs://bkt/absent")


def test_gcs_read_parquet_end_to_end(gcs, monkeypatch):
    gcs.put("gs://data/t.parquet", _parquet_bytes(
        pa.table({"a": [1, 2, 3], "b": ["x", "y", "z"]})))
    monkeypatch.setenv("GCS_ENDPOINT_URL", gcs.config.endpoint_url)
    monkeypatch.setenv("GCS_ACCESS_TOKEN", "test-token")
    _fresh_clients(monkeypatch)
    assert _both(lambda pkg: pkg.read_parquet("gs://data/t.parquet")
                 .to_pydict()) == {"a": [1, 2, 3], "b": ["x", "y", "z"]}


def test_az_url_forms():
    assert _parse_az_url("az://cont/a/b.txt") == (None, "cont", "a/b.txt")
    assert _parse_az_url(
        "abfss://cont@acct.dfs.core.windows.net/a/b.txt") == \
        ("acct", "cont", "a/b.txt")


def test_az_put_get_roundtrip_sharedkey(az):
    az.put("az://cont/dir/y.bin", b"azure bytes")
    assert az.get("az://cont/dir/y.bin") == b"azure bytes"
    # SharedKey Authorization header was actually sent
    assert any(a.startswith("SharedKey acct:")
               for a in _MockAzureHandler.seen_auth)


def test_az_range_get(az):
    az.put("az://cont/r.bin", b"abcdefghij")
    assert az.get("az://cont/r.bin", byte_range=(1, 4)) == b"bcd"


def test_az_glob_with_pagination(az):
    for i in range(5):
        az.put(f"az://cont/part/{i}.parquet", b"y" * (i + 1))
    az.put("az://cont/part/notes.md", b"no")
    hits = az.glob("az://cont/part/*.parquet")
    assert hits == [f"az://cont/part/{i}.parquet" for i in range(5)]


def test_az_missing_raises(az):
    with pytest.raises(FileNotFoundError):
        az.get("az://cont/absent")


def test_az_read_parquet_end_to_end(az, monkeypatch):
    az.put("az://data/t.parquet", _parquet_bytes(
        pa.table({"k": [10, 20], "v": [0.5, 1.5]})))
    monkeypatch.setenv("AZURE_ENDPOINT_URL", az.config.endpoint_url)
    monkeypatch.setenv("AZURE_STORAGE_ACCOUNT", "acct")
    monkeypatch.setenv("AZURE_STORAGE_KEY",
                       base64.b64encode(b"secret-key-bytes").decode())
    _fresh_clients(monkeypatch)
    assert _both(lambda pkg: pkg.read_parquet("az://data/t.parquet")
                 .to_pydict()) == {"k": [10, 20], "v": [0.5, 1.5]}


# ---------------------------------------------------------- Hugging Face

class _MockHubHandler(http.server.BaseHTTPRequestHandler):
    files = {}  # (repo_id, rev, path) -> bytes

    def log_message(self, *a):
        pass

    def _send(self, status, body=b""):
        self.send_response(status)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        u = urllib.parse.urlparse(self.path)
        parts = u.path.strip("/").split("/")
        if parts[0] == "api":  # /api/datasets/org/repo/tree/rev[/sub]
            repo_id = "/".join(parts[2:4])
            rev = parts[5]
            sub = "/".join(parts[6:])
            entries = [
                {"type": "file", "path": p, "size": len(b)}
                for (r, rv, p), b in self.files.items()
                if r == repo_id and rv == rev and p.startswith(sub)]
            self._send(200, json.dumps(entries).encode())
            return
        # /datasets/org/repo/resolve/rev/path
        repo_id = "/".join(parts[1:3])
        rev = parts[4]
        path = "/".join(parts[5:])
        data = self.files.get((repo_id, rev, path))
        if data is None:
            self._send(404)
            return
        rng = self.headers.get("Range")
        if rng:
            s, e = rng.split("=")[1].split("-")
            self._send(206, data[int(s):int(e) + 1])
            return
        self._send(200, data)

    def do_HEAD(self):
        u = urllib.parse.urlparse(self.path)
        parts = u.path.strip("/").split("/")
        repo_id = "/".join(parts[1:3])
        data = self.files.get((repo_id, parts[4], "/".join(parts[5:])))
        if data is None:
            self._send(404)
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()


@pytest.fixture(scope="module")
def hub(tmp_path_factory):
    data = _parquet_bytes(pa.table({"a": [1, 2, 3], "b": ["x", "y", "z"]}))
    _MockHubHandler.files = {
        ("org/repo", "main", "data/part-0.parquet"): data,
        ("org/repo", "main", "data/part-1.parquet"): data,
        ("org/repo", "main", "README.md"): b"# hi",
        ("org/repo", "v2", "data/part-0.parquet"): data,
    }
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                             _MockHubHandler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{server.server_port}"
    server.shutdown()


@pytest.fixture
def hf(hub, monkeypatch):
    monkeypatch.setenv("HF_ENDPOINT", hub)
    _fresh_clients(monkeypatch)
    return HFSource()


def test_hf_url_parsing():
    assert _parse_hf_url("hf://datasets/org/repo/a/b.parquet") == \
        ("datasets", "org/repo", "main", "a/b.parquet")
    assert _parse_hf_url("hf://org/repo/a.parquet") == \
        ("datasets", "org/repo", "main", "a.parquet")
    assert _parse_hf_url("hf://datasets/org/repo@v2/a.parquet") == \
        ("datasets", "org/repo", "v2", "a.parquet")


def test_hf_get_and_size(hf):
    assert hf.get("hf://datasets/org/repo/README.md") == b"# hi"
    assert hf.get_size("hf://datasets/org/repo/README.md") == 4


def test_hf_glob_and_ls(hf):
    hits = hf.glob("hf://datasets/org/repo/data/*.parquet")
    assert hits == ["hf://datasets/org/repo/data/part-0.parquet",
                    "hf://datasets/org/repo/data/part-1.parquet"]
    assert len(dict(hf.ls("hf://datasets/org/repo/data"))) == 2


def test_hf_revision_pinning(hf):
    hits = hf.glob("hf://datasets/org/repo@v2/data/*.parquet")
    assert hits == ["hf://datasets/org/repo@v2/data/part-0.parquet"]
    assert hf.get("hf://datasets/org/repo@v2/data/part-0.parquet")


def test_hf_read_parquet_end_to_end(hf):
    out = _both(lambda pkg: pkg.read_parquet(
        "hf://datasets/org/repo/data/*.parquet").to_pydict())
    assert out["a"] == [1, 2, 3, 1, 2, 3]


def test_io_client_routes_each_scheme():
    client = object_io.IOClient()
    for url, cls in (("/tmp/x", object_io.LocalSource),
                     ("file:///tmp/x", object_io.LocalSource),
                     ("http://h/x", object_io.HTTPSource),
                     ("https://h/x", object_io.HTTPSource),
                     ("s3://b/x", S3Source), ("s3a://b/x", S3Source),
                     ("gs://b/x", GCSSource), ("az://c/x", AzureBlobSource),
                     ("abfss://c@a.dfs.core.windows.net/x", AzureBlobSource),
                     ("hf://datasets/o/r/x", HFSource)):
        assert isinstance(client.source_for(url), cls), url
    assert client.source_for("s3://a/1") is client.source_for("s3://b/2")
    with pytest.raises(ValueError, match="unsupported"):
        client.source_for("ftp://h/x")

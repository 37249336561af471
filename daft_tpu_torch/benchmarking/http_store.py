"""A local HTTP object store over a directory, for remote-scan runs.

Serves the files under ``root`` at ``http://127.0.0.1:<port>/<relative
path>`` from a stdlib ``ThreadingHTTPServer`` in a child process of its
own, so the store's request threads never contend for the interpreter
lock of the process whose scan they serve. ``HEAD`` answers with the
file's size, ``GET`` with the whole file or one ``Range`` (``bytes=a-b``,
``bytes=a-`` to the end, ``bytes=-n`` for the last ``n`` bytes; ``416``
for a range it cannot satisfy), read by seeking in the file on disk (never
the whole file per request). Every request first sleeps ``delay_s``,
which models an object store's round trip; the store counts its GETs,
HEADs and the bytes it sent, and :meth:`FileStore.counts` reads them
back. Use it as a context manager::

    with FileStore(root, delay_s=0.015) as store:
        df = daft_tpu_torch.read_parquet(store.urls("lineitem"))

Alone, ``python http_store.py ROOT [DELAY_S]`` prints its port on the
first line and serves until its standard input closes. It imports only
the standard library.
"""

from __future__ import annotations

import http.client
import http.server
import json
import os
import subprocess
import sys
import threading
import time
import urllib.parse
from typing import Dict, List, Optional, Tuple

_CHUNK = 1 << 20
#: the path that answers the counts (never a file: the store serves no
#: dot-directory)
_COUNTS_PATH = "/.store/counts"
_COUNT_KEYS = ("gets", "heads", "bytes_sent")


def byte_range(header: str, size: int) -> Optional[Tuple[int, int]]:
    """The ``[start, end)`` bytes one ``Range`` header asks of a file of
    ``size`` bytes, or None when the store cannot satisfy it (a unit other
    than bytes, several ranges, a malformed or empty range, or a start at
    or past the end)."""
    unit, _, spec = header.partition("=")
    first, dash, last = spec.strip().partition("-")
    if unit.strip() != "bytes" or not dash or "," in spec:
        return None
    try:
        if not first:  # a suffix: the last ``last`` bytes
            n = int(last)
            start, end = max(size - n, 0), (size if n > 0 else 0)
        else:
            start = int(first)
            end = size if not last else min(int(last) + 1, size)
    except ValueError:
        return None
    if start < 0 or start >= end:
        return None
    return start, end


def serve(root: str, delay_s: float) -> http.server.ThreadingHTTPServer:
    """A server over ``root`` on a free port of 127.0.0.1, not started."""
    root = os.path.abspath(root)
    lock = threading.Lock()
    counts = dict.fromkeys(_COUNT_KEYS, 0)

    def bump(name: str, n: int = 1) -> None:
        with lock:
            counts[name] += n

    class Handler(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def _file(self):
            rel = urllib.parse.unquote(
                urllib.parse.urlparse(self.path).path).lstrip("/")
            p = os.path.normpath(os.path.join(root, rel))
            if not p.startswith(root + os.sep) or not os.path.isfile(p):
                return None
            return p

        def _empty(self, status: int, *headers) -> None:
            self.send_response(status)
            for k, v in headers:
                self.send_header(k, v)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def do_HEAD(self):
            bump("heads")
            time.sleep(delay_s)
            p = self._file()
            if p is None:
                return self._empty(404)
            self.send_response(200)
            self.send_header("Content-Length", str(os.path.getsize(p)))
            self.send_header("Accept-Ranges", "bytes")
            self.end_headers()

        def do_GET(self):
            if self.path == _COUNTS_PATH:
                with lock:
                    body = json.dumps(counts).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            bump("gets")
            time.sleep(delay_s)
            p = self._file()
            if p is None:
                return self._empty(404)
            size = os.path.getsize(p)
            start, end = 0, size
            rng = self.headers.get("Range")
            if rng:
                got = byte_range(rng, size)
                if got is None:
                    return self._empty(416,
                                       ("Content-Range", f"bytes */{size}"))
                start, end = got
                self.send_response(206)
                self.send_header("Content-Range",
                                 f"bytes {start}-{end - 1}/{size}")
            else:
                self.send_response(200)
            n = end - start
            self.send_header("Content-Length", str(n))
            self.end_headers()
            with open(p, "rb") as f:
                f.seek(start)
                while n > 0:
                    chunk = f.read(min(n, _CHUNK))
                    if not chunk:
                        break
                    self.wfile.write(chunk)
                    n -= len(chunk)
            bump("bytes_sent", end - start)

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    srv.daemon_threads = True
    return srv


class FileStore:
    """:func:`serve` over ``root`` in a child process, for the length of a
    ``with`` block."""

    def __init__(self, root: str, delay_s: float = 0.0):
        self.root = os.path.abspath(root)
        self.delay_s = delay_s
        self._proc: Optional[subprocess.Popen] = None
        self._port = 0

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self._port}"

    def urls(self, subdir: str) -> List[str]:
        """The URLs of the files directly under ``root/subdir``, sorted
        (an HTTP store has no listing: reads take explicit URLs)."""
        d = os.path.join(self.root, subdir)
        return [f"{self.url}/{subdir}/{f}" for f in sorted(os.listdir(d))
                if os.path.isfile(os.path.join(d, f))
                and not f.startswith((".", "_"))]

    def counts(self) -> Dict[str, int]:
        """``gets``, ``heads`` and ``bytes_sent`` so far (read from the
        child; the read itself is not counted)."""
        conn = http.client.HTTPConnection("127.0.0.1", self._port,
                                          timeout=30)
        try:
            conn.request("GET", _COUNTS_PATH)
            return json.loads(conn.getresponse().read())
        finally:
            conn.close()

    def __enter__(self) -> "FileStore":
        self._proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), self.root,
             repr(self.delay_s)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        line = self._proc.stdout.readline()
        if not line.strip().isdigit():
            self.__exit__()
            raise RuntimeError(f"the HTTP store did not start ({line!r})")
        self._port = int(line)
        return self

    def __exit__(self, *exc) -> None:
        proc, self._proc = self._proc, None
        if proc is None:
            return
        proc.stdin.close()  # the child serves until its stdin closes
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        proc.stdout.close()


def _main(argv: List[str]) -> None:
    srv = serve(argv[0], float(argv[1]) if len(argv) > 1 else 0.0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    print(srv.server_port, flush=True)
    sys.stdin.read()  # until the parent closes it, or dies
    srv.shutdown()
    srv.server_close()


if __name__ == "__main__":
    _main(sys.argv[1:])

"""Embedded query dashboard.

The port's copy of ``daft_tpu/dashboard.py`` (reference engine:
``src/daft-dashboard``, a localhost HTTP server receiving broadcast query
plans and timings, launched through ``dashboard.launch()``). The server
renders the engine's own runtime stats as plain HTML: recent queries with
per-operator rows and timings (``observability.RuntimeStatsContext``) and
their io block, the flight recorder's history (``/api/history``), the
queries as JSON (``/api/queries``), the serving scheduler's live queue
(``/api/serving`` and a panel on the page) and a Prometheus scrape
(``/metrics``). The in-memory history is bounded by count and by bytes.

The fleet panel (``/api/fleet``) comes with the fleet (ROADMAP A8b).
"""

from __future__ import annotations

import html
import http.server
import json
import threading
import time
from typing import List, Optional

DEFAULT_PORT = 3238

_history_lock = threading.Lock()
_history: List[dict] = []
_history_bytes: List[int] = []  # parallel to _history: entry JSON sizes
#: broadcast-history bounds — BOTH apply: a count cap and a byte cap (one
#: query with a giant explain must not let 49 more like it pin hundreds
#: of MB in a long-lived process)
_MAX_HISTORY = 50
_MAX_HISTORY_BYTES = 4 << 20
_server: Optional[http.server.ThreadingHTTPServer] = None


def broadcast_query(stats) -> None:
    """Record a finished query's stats for the dashboard (called at
    ``observability.set_last_stats`` while the server is up)."""
    try:
        entry = {
            "ts": time.strftime("%H:%M:%S"),
            "operators": stats.as_dict(),
            "explain": stats.render(getattr(stats, "plan", None)),
            # resilience plane: recovery events (retries, quarantines,
            # recomputed map tasks, speculative wins) of this query
            "recovery": dict(getattr(stats, "recovery", {}) or {}),
            # shuffle data plane: bytes written and fetched, the
            # combine's reduction, fetch overlap, mesh exchanges
            "shuffle": dict(getattr(stats, "shuffle", {}) or {}),
            # scan-side IO plane: GETs vs planned ranges (coalescing),
            # bytes fetched vs used, prefetch overlap
            "io": dict(getattr(stats, "io", {}) or {}),
            # device kernels: per-family dispatch/byte/MFU ledger delta,
            # with the hash-vs-sort strategy and the table load factor
            "device_kernels": dict(
                getattr(stats, "device_kernels", {}) or {}),
            # self-tuning plane: calibration observations and re-plans
            "adaptive": dict(getattr(stats, "adaptive", {}) or {}),
            # lock-order sanitizer (DAFT_TORCH_SANITIZE=1): graph size,
            # cycles, this query's acquisitions
            "sanitizer": dict(getattr(stats, "sanitizer", {}) or {}),
            # serving plane: session, priority, queue wait, admission and
            # the plan and result cache outcomes of scheduler-run queries
            "serving": dict(getattr(stats, "serving", {}) or {}),
            # tracing plane: the trace's summary (id, span count)
            "trace": dict(getattr(stats, "trace_summary", {}) or {}),
        }
        size = len(json.dumps(entry, default=str))
    except Exception:
        return
    with _history_lock:
        _history.append(entry)
        _history_bytes.append(size)
        # count cap, then byte cap: evict oldest-first until both hold
        while len(_history) > _MAX_HISTORY \
                or (sum(_history_bytes) > _MAX_HISTORY_BYTES
                    and len(_history) > 1):
            _history.pop(0)
            _history_bytes.pop(0)


def _serving_view() -> dict:
    """The shared scheduler's live state, or {} when none runs (looking
    never boots a scheduler)."""
    from . import serving
    sched = serving.shared_scheduler_if_running()
    return sched.live_view() if sched is not None else {}


def _serving_html(live: dict) -> str:
    if not live:
        return ""
    sess = live.get("sessions") or {}
    sess_rows = "".join(
        f"<tr><td>{html.escape(str(n))}</td>"
        f"<td>{s.get('queued')}</td><td>{s.get('weight')}</td></tr>"
        for n, s in sorted(sess.items()))
    return ("<h2>serving queue (live)</h2>"
            f"<p>running {live.get('running', 0)}/"
            f"{live.get('concurrency', 0)} · queued "
            f"{live.get('queued', 0)} · admitted "
            f"{live.get('admitted_bytes', 0)} / "
            f"{live.get('admission_budget')} bytes</p>"
            + ("<table border=1><tr><th>session</th><th>queued</th>"
               "<th>weight</th></tr>" + sess_rows + "</table>"
               if sess_rows else ""))


class _Handler(http.server.BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def _reply(self, body: bytes, ctype: str) -> None:
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        from . import tracing
        if self.path.startswith("/metrics"):
            # Prometheus text-format scrape of the process-wide planes
            self._reply(tracing.prometheus_text().encode(),
                        "text/plain; version=0.0.4")
            return
        if self.path.startswith("/api/history"):
            # flight-recorder history (DAFT_TORCH_QUERY_LOG JSONL)
            self._reply(json.dumps(tracing.flight_history()).encode(),
                        "application/json")
            return
        if self.path.startswith("/api/serving"):
            self._reply(json.dumps(_serving_view()).encode(),
                        "application/json")
            return
        if self.path.startswith("/api/queries"):
            with _history_lock:
                body = json.dumps(_history).encode()
            self._reply(body, "application/json")
            return
        rows = []
        with _history_lock:
            for i, q in enumerate(reversed(_history)):
                srv = q.get("serving") or {}
                srv_html = ("<p><b>serving:</b> "
                            + html.escape(json.dumps(srv, default=str))
                            + "</p>" if srv else "")
                rec = q.get("recovery") or {}
                rec_html = ("<p><b>recovery events:</b> "
                            + html.escape(json.dumps(rec)) + "</p>"
                            if rec else "")
                shf = q.get("shuffle") or {}
                shf_html = ("<p><b>shuffle:</b> "
                            + html.escape(json.dumps(
                                {k: round(v, 1) for k, v in shf.items()}))
                            + "</p>" if shf else "")
                sio = q.get("io") or {}
                io_html = ("<p><b>io:</b> "
                           + html.escape(json.dumps(
                               {k: round(v, 1) for k, v in sio.items()}))
                           + "</p>" if sio else "")
                rows.append(
                    f"<h3>query {len(_history) - i} — {q['ts']}</h3>"
                    f"{srv_html}{rec_html}{shf_html}{io_html}"
                    f"<pre>{html.escape(q['explain'])}</pre>")
        # flight-recorder history (persisted across restarts, unlike the
        # in-memory broadcast list above)
        entries = tracing.flight_history(limit=20)
        hist_html = ""
        if entries:
            hist_rows = "".join(
                f"<tr><td>{html.escape(str(e.get('ts')))}</td>"
                f"<td>{float(e.get('wall_us', 0)) / 1e3:.1f}ms</td>"
                f"<td>{'SLOW' if e.get('slow') else ''}</td>"
                f"<td>{html.escape(str((e.get('trace') or {}).get('trace_id', '')))}</td>"
                f"</tr>" for e in entries)
            hist_html = ("<h2>query history (flight recorder)</h2>"
                         "<table border=1><tr><th>ts</th><th>wall</th>"
                         "<th>slow</th><th>trace</th></tr>"
                         + hist_rows + "</table>")
        body = ("<html><head><title>daft-tpu-torch dashboard</title>"
                "</head><body><h1>daft-tpu-torch queries</h1>"
                + _serving_html(_serving_view()) + hist_html
                + ("".join(rows) or "<p>no queries yet</p>")
                + "</body></html>").encode()
        self._reply(body, "text/html")


_server_lock = threading.Lock()


def launch(port: int = DEFAULT_PORT, block: bool = False) -> int:
    """Start the dashboard server on localhost; returns the bound port
    (``port=0`` picks a free one)."""
    global _server
    with _server_lock:
        if _server is None:
            _server = http.server.ThreadingHTTPServer(("127.0.0.1", port),
                                                      _Handler)
            t = threading.Thread(target=_server.serve_forever, daemon=True,
                                 name="daft-torch-dashboard")
            t.start()
        srv = _server
    if block:
        try:
            while _server is srv:
                time.sleep(1)
        except KeyboardInterrupt:
            pass
    return srv.server_port


def shutdown() -> None:
    global _server
    with _server_lock:
        if _server is not None:
            _server.shutdown()
            _server.server_close()  # release the listening socket
            _server = None

"""Phase 7q of ``chip_smoke.py``: the lake formats of ROADMAP A8e under
TPC-H at SF1 on the card. Alone, from the repository root on a machine
with a CUDA card:

    python3 daft_tpu_torch/benchmarking/lake_phase.py [--runs N]

(builds the kernels and the native library, generates the SF1 files into
``.cache/`` with ``chip_smoke.tpch_root``, runs the phase N times, then
holds its hash and join rungs against the plain versions as phase 8
does; exits non-zero when a check fails).

The phase, over the SF1 files under ``root``, with the tables written
fresh into ``.cache/lake/`` each run:

- writes, each timed: ``lineitem`` (6.0M rows) with ``write_deltalake``
  and ``write_iceberg``, ``orders`` with ``write_lance``, and a
  copy-on-write Hudi table of ``orders`` laid out as
  ``tests/test_hudi.py`` lays one out (one file group per SF1 file, one
  commit);
- queries: Q1 and the ``l_suppkey`` group-by over the Delta and the
  Iceberg ``lineitem``, and Q3 with ``lineitem`` from Iceberg, ``orders``
  from Lance and ``customer`` from parquet, and again with ``lineitem``
  from Delta and ``orders`` from Hudi; each at the default knobs and at
  ``DAFT_TORCH_DEVICE_FORCE=1`` (with the hash group-by and join), each
  answer held to the pyarrow answers over the parquet files that phases 5
  and 6 hold. At the forced knobs each format's ``l_suppkey`` group-by
  must launch the hash-agg build and each Q3 the join build and probe;
- Unity: Q1 through a ``Session`` over a ``UnityCatalog`` whose
  in-process mock server points at the Delta table;
- time travel: after an append of 10,000 rows, the Delta and Iceberg
  ``lineitem`` and the Lance ``orders`` read the parquet row count at
  their first version and that count plus 10,000 at the second; the Hudi
  snapshot's count equals the parquet ``orders`` count.

Each write and each query prints a ``lake`` line: the format, the wall,
the scan path taken (fused dispatches by strategy, host morsels, the
per-operator and join dispatches), the cost model's decisions and the
launches per kernel. Nothing here imports ``jax`` or ``daft_tpu``.
"""

from __future__ import annotations

import glob
import http.server
import json
import os
import shutil
import sys
import threading
import time
import urllib.parse

import pyarrow.parquet as pq

FORCED = dict(DAFT_TORCH_DEVICE_FORCE="1", DAFT_TORCH_KERNEL_GROUPBY="hash",
              DAFT_TORCH_KERNEL_JOIN="hash")
APPEND_ROWS = 10_000
#: the scan-path counters a ``lake`` line carries
PATH_KEYS = ("dense", "hash", "sort", "global", "host_morsels", "agg_hash",
             "agg_sort", "agg_global", "projection", "predicate", "argsort",
             "host_ops", "join_hash", "join_sort", "host_joins")


def write_hudi_cow(src_files, uri: str) -> dict:
    """A copy-on-write Hudi table of the parquet ``src_files``: one file
    group per file at instant 001 and one ``commit`` (the on-disk layout
    ``io/hudi.py`` reads: ``{fileId}_{writeToken}_{instant}.parquet``)."""
    os.makedirs(os.path.join(uri, ".hoodie"), exist_ok=True)
    with open(os.path.join(uri, ".hoodie", "hoodie.properties"), "w") as f:
        f.write("hoodie.table.name=orders\n"
                "hoodie.table.type=COPY_ON_WRITE\n")
    for i, src in enumerate(src_files):
        shutil.copyfile(src, os.path.join(uri, f"fg{i}_0-1-0_001.parquet"))
    with open(os.path.join(uri, ".hoodie", "001.commit"), "w") as f:
        json.dump({"operationType": "INSERT"}, f)
    return dict(file_groups=len(src_files))


class UnityMock(http.server.BaseHTTPRequestHandler):
    """The open Unity Catalog REST surface the adapter reads
    (``tests/test_catalog_unity.py``'s mock): schemas, tables, and one
    table's storage location and format."""

    tables: dict = {}

    def log_message(self, *a):
        pass

    def _send(self, status, payload=None):
        body = json.dumps(payload or {}).encode()
        self.send_response(status)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        u = urllib.parse.urlparse(self.path)
        q = urllib.parse.parse_qs(u.query)
        parts = u.path.split("/api/2.1/unity-catalog/", 1)[-1].split("/", 1)
        if parts[0] == "schemas":
            self._send(200, {"schemas": [{"name": n} for n in sorted(
                {f.split(".")[1] for f in self.tables})]})
        elif parts[0] == "tables" and len(parts) == 1:
            self._send(200, {"tables": [
                {"name": f.split(".")[2]} for f in sorted(self.tables)
                if f.split(".")[1] == q["schema_name"][0]]})
        elif parts[0] == "tables" and urllib.parse.unquote(parts[1]) \
                in self.tables:
            self._send(200, self.tables[urllib.parse.unquote(parts[1])])
        else:
            self._send(404)


def phase(cs, root: str, card: str, ref=None, q3_ref=None) -> dict:
    """Phase 7q over the SF1 files under ``root``; ``cs`` is the
    ``chip_smoke`` module. ``ref`` / ``q3_ref``: the pyarrow answers
    (``cs.pyarrow_answers``, ``cs.q3_reference``), computed here when
    absent."""
    import daft_tpu_torch as dtt
    from daft_tpu_torch.benchmarking import tpch_queries as Q
    from daft_tpu_torch.catalog_unity import UnityCatalog
    from daft_tpu_torch.io import iceberg as ice
    t_phase = time.perf_counter()
    if ref is None:
        ref = cs.pyarrow_answers(root)
    if q3_ref is None:
        q3_ref = cs.q3_reference(root)
    lake = os.path.join(os.path.dirname(os.path.abspath(root)), "lake")
    shutil.rmtree(lake, ignore_errors=True)
    os.makedirs(lake)
    rec = cs.KernelRecorder("lake")
    lines = []

    def parquet(t):
        return dtt.read_parquet(os.path.join(root, t))

    def line(**d):
        d["card"] = card
        lines.append(d)
        cs.log("lake " + json.dumps(d))

    # ---------------------------------------------------------- writes
    uris = {k: os.path.join(lake, k) for k in (
        "delta_lineitem", "iceberg_lineitem", "lance_orders", "hudi_orders")}
    n_li = pq.ParquetDataset(os.path.join(root, "lineitem")).read(
        columns=["l_orderkey"]).num_rows
    n_o = pq.ParquetDataset(os.path.join(root, "orders")).read(
        columns=["o_orderkey"]).num_rows
    for fmt, table, fn in (
            ("delta", "lineitem", lambda: parquet("lineitem")
             .write_deltalake(uris["delta_lineitem"])),
            ("iceberg", "lineitem", lambda: parquet("lineitem")
             .write_iceberg(uris["iceberg_lineitem"])),
            ("lance", "orders", lambda: parquet("orders")
             .write_lance(uris["lance_orders"])),
            ("hudi", "orders", lambda: write_hudi_cow(sorted(glob.glob(
                os.path.join(root, "orders", "*.parquet"))),
                uris["hudi_orders"]))):
        t0 = time.perf_counter()
        fn()
        line(step="write", format=fmt, table=table,
             wall_s=time.perf_counter() - t0,
             rows=n_li if table == "lineitem" else n_o)

    # --------------------------------------------------------- queries
    sources = {
        "delta": dict(lineitem=lambda: dtt.read_deltalake(
            uris["delta_lineitem"]), orders=lambda: dtt.read_hudi(
            uris["hudi_orders"])),
        "iceberg": dict(lineitem=lambda: dtt.read_iceberg(
            uris["iceberg_lineitem"]), orders=lambda: dtt.read_lance(
            uris["lance_orders"])),
    }
    names = {"delta": "delta lineitem, hudi orders",
             "iceberg": "iceberg lineitem, lance orders"}
    for fmt, src in sources.items():
        def get(t, src=src):
            return src[t]() if t in src else parquet(t)
        for name in ("q1", "suppkey_agg", "q3"):
            for way in ("default", "forced"):
                with cs._env(**(FORCED if way == "forced" else {})):
                    got, wall, counts, launches = rec.counted(
                        f"lake {fmt} {name} {way}",
                        lambda: Q.QUERIES[name](get).to_pydict())
                if name == "q3":
                    cs.check_table(f"lake q3 {fmt} {way}", got, q3_ref[0],
                                   ["o_orderkey"],
                                   ["o_orderdate", "o_shippriority"],
                                   ["revenue"])
                else:
                    cs.check_answer(name, got, ref)
                path = {k: counts.get(k, 0) for k in PATH_KEYS}
                fused = sum(path[k] for k in ("dense", "hash", "sort",
                                              "global"))
                line(step="query", format=fmt, sources=names[fmt],
                     query=name, way=way, wall_s=wall, launches=launches,
                     fused_dispatches=fused, scan_path=(
                         "fused fragment" if fused else
                         "no fused fragment (per-operator and host paths)"),
                     counters=path, decisions=rec.decisions)
                if way != "forced":
                    continue
                if name == "suppkey_agg" and launches["hash_agg_build"] < 1:
                    raise AssertionError(f"lake {fmt} {name}: no hash-agg "
                                         f"build launched ({launches})")
                if name == "q3" and min(launches["hash_join_build"],
                                        launches["hash_join_probe"]) < 1:
                    raise AssertionError(f"lake {fmt} q3: the join kernels "
                                         f"did not launch ({launches})")
        rec.to_host()

    # ----------------------------------------------------------- Unity
    UnityMock.tables = {"unity.tpch.lineitem": {
        "storage_location": uris["delta_lineitem"],
        "data_source_format": "DELTA"}}
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), UnityMock)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        sess = dtt.Session()
        sess.attach(UnityCatalog(f"http://127.0.0.1:{server.server_port}",
                                 token="t", catalog="unity", name="uc"))
        got, wall, counts, launches = rec.counted(
            "lake unity q1", lambda: Q.QUERIES["q1"](
                lambda t: sess.read_table(f"uc.tpch.{t}")).to_pydict())
        cs.check_answer("q1", got, ref)
        line(step="query", format="unity (delta)", query="q1",
             way="default", wall_s=wall, launches=launches,
             counters={k: counts.get(k, 0) for k in PATH_KEYS},
             decisions=rec.decisions)
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=10)

    # ----------------------------------------------------- time travel
    t0 = time.perf_counter()
    extra_li = parquet("lineitem").limit(APPEND_ROWS)
    extra_o = parquet("orders").limit(APPEND_ROWS)
    extra_li.write_deltalake(uris["delta_lineitem"], mode="append")
    extra_li.write_iceberg(uris["iceberg_lineitem"], mode="append")
    extra_o.write_lance(uris["lance_orders"], mode="append")
    snaps = [s["snapshot-id"] for s in ice.load_table_metadata(
        uris["iceberg_lineitem"])["snapshots"]]
    counts = {
        "delta": [dtt.read_deltalake(uris["delta_lineitem"], version=v)
                  .count_rows() for v in (0, 1)],
        "iceberg": [dtt.read_iceberg(uris["iceberg_lineitem"],
                                     snapshot_id=s).count_rows()
                    for s in snaps],
        "lance": [dtt.read_lance(uris["lance_orders"], version=v)
                  .count_rows() for v in (1, 2)],
        "hudi": [dtt.read_hudi(uris["hudi_orders"]).count_rows()]}
    want = {"delta": [n_li, n_li + APPEND_ROWS],
            "iceberg": [n_li, n_li + APPEND_ROWS],
            "lance": [n_o, n_o + APPEND_ROWS], "hudi": [n_o]}
    if counts != want:
        raise AssertionError(f"lake time travel: {counts} != {want}")
    line(step="time travel", counts=counts,
         wall_s=time.perf_counter() - t0)
    cs.log(f"lake phase wall: {time.perf_counter() - t_phase:.3f} s")
    rec.to_host("cuda" if _on_card() else "cpu")
    return dict(rec=rec, lines=lines)


def _on_card() -> bool:
    from daft_tpu_torch.device import backend
    return backend.is_accelerator()


def main() -> int:
    import argparse
    import subprocess
    ap = argparse.ArgumentParser(description="phase 7q alone")
    ap.add_argument("--runs", type=int, default=1)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    os.environ["DAFT_TORCH_LINK_CACHE"] = "0"
    from daft_tpu_torch import native
    from daft_tpu_torch.device import cuda_build
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    card = card.splitlines()[0]
    cs.log(f"card: {card}")
    t0 = time.perf_counter()
    cuda_build.library()
    cs.log(f"kernel build: {time.perf_counter() - t0:.3f} s")
    native.library()
    root = cs.tpch_root(1.0)
    bw = cs.copy_bandwidth()
    ref, q3_ref = cs.pyarrow_answers(root), cs.q3_reference(root)
    for i in range(args.runs):
        t0 = time.perf_counter()
        out = cs.run_phase("7q", lambda: phase(cs, root, card, ref, q3_ref),
                           t0)
        cs.log(f"phase 7q run {i + 1}: {time.perf_counter() - t0:.3f} s")
    rec = out["rec"]
    hash_recs = cs.main_path_kernel_timing(rec.hash_rungs(), bw)
    join_recs = cs.join_rung_timing(
        {k: dict(v, pass_=rec.pass_) for k, v in rec.join_rungs.items()}, bw)
    cs.log(f"lake rungs held: {len(hash_recs)} hash, {len(join_recs)} join")
    return 0


if __name__ == "__main__":
    sys.exit(main())

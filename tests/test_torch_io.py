"""The port's reads and writes against the reference's
(``tests/test_io.py``, case for case): glob and directory reads, column,
filter and limit pushdowns, CSV/JSON round trips, partitioned writes and
write modes, ``from_glob_path``, scan-task merging and splitting, CSV
without a header and WARC reads, plus ``read_sql``, ``write_sink``, the
exported IO configs and the device column cache's key.

Every case runs the same inputs through ``daft_tpu`` (JAX on the CPU) and
``daft_tpu_torch`` (``DAFT_TORCH_DEVICE=cpu``) and holds the port's answer
to the reference's.
"""

import datetime
import gzip
import json
import os
import sqlite3

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import daft_tpu
import daft_tpu_torch

PKGS = {"ref": daft_tpu, "port": daft_tpu_torch}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("DAFT_TPU_DEVICE", "0")


@pytest.fixture
def pq_dir(tmp_path):
    for i in range(4):
        t = pa.table({"a": np.arange(i * 10, (i + 1) * 10),
                      "b": [f"s{j}" for j in range(10)],
                      "d": [datetime.date(2020, 1, 1 + j)
                            for j in range(10)]})
        pq.write_table(t, tmp_path / f"part{i}.parquet")
    return str(tmp_path)


def _both(fn):
    """``fn(pkg)`` for the reference and the port; asserts they agree and
    returns the port's."""
    want, got = fn(daft_tpu), fn(daft_tpu_torch)
    assert got == want
    return got


def test_read_parquet_glob(pq_dir):
    got = _both(lambda pkg: (pkg.read_parquet(pq_dir + "/*.parquet")
                             .schema().column_names,
                             sorted(pkg.read_parquet(pq_dir + "/*.parquet")
                                    .to_pydict()["a"])))
    assert got == (["a", "b", "d"], list(range(40)))


def test_read_parquet_dir(pq_dir):
    assert _both(lambda pkg: len(pkg.read_parquet(pq_dir)
                                 .to_pydict()["a"])) == 40


def test_column_pushdown(pq_dir):
    from daft_tpu_torch.logical import plan as lp

    def find_source(n):
        if isinstance(n, lp.Source):
            return n
        for c in n.children:
            s = find_source(c)
            if s is not None:
                return s
        return None
    df = daft_tpu_torch.read_parquet(pq_dir + "/*.parquet").select("a")
    assert find_source(df.builder.optimize().plan).pushdowns.columns \
        == ("a",)
    assert _both(lambda pkg: sorted(pkg.read_parquet(
        pq_dir + "/*.parquet").select("a").to_pydict()["a"])) \
        == list(range(40))


def test_filter_pushdown_rowgroup_prune(pq_dir):
    assert _both(lambda pkg: sorted(pkg.read_parquet(
        pq_dir + "/*.parquet").where(pkg.col("a") >= 35)
        .to_pydict()["a"])) == list(range(35, 40))


def test_limit_pushdown(pq_dir):
    assert _both(lambda pkg: len(pkg.read_parquet(
        pq_dir + "/*.parquet").limit(7).to_pydict()["a"])) == 7


def test_csv_roundtrip(tmp_path):
    def run(pkg):
        out = str(tmp_path / f"out_{pkg.__name__}")
        pkg.from_pydict({"x": [1, 2, 3], "y": ["a", "b", "c"]}) \
            .write_csv(out)
        return pkg.read_csv(out + "/*.csv").sort("x").to_pydict()
    assert _both(run) == {"x": [1, 2, 3], "y": ["a", "b", "c"]}


def test_json_roundtrip(tmp_path):
    def run(pkg):
        out = str(tmp_path / f"out_{pkg.__name__}")
        pkg.from_pydict({"x": [1, 2], "y": [[1, 2], [3]]}).write_json(out)
        return pkg.read_json(out + "/*.json").sort("x").to_pydict()["y"]
    assert _both(run) == [[1, 2], [3]]


def test_partitioned_write(tmp_path):
    def run(pkg):
        out = tmp_path / f"out_{pkg.__name__}"
        pkg.from_pydict({"g": ["a", "a", "b"], "v": [1, 2, 3]}) \
            .write_parquet(str(out), partition_cols=["g"])
        assert os.path.isdir(out / "g=a") and os.path.isdir(out / "g=b")
        return pkg.read_parquet(str(out / "**" / "*.parquet"),
                                hive_partitioning=True).sort("v") \
            .to_pydict()
    d = _both(run)
    assert d["v"] == [1, 2, 3]
    assert d["g"] == ["a", "a", "b"]


def test_partitioned_write_hive_paths_and_nulls(tmp_path):
    """A null partition value writes to ``__HIVE_DEFAULT_PARTITION__``; the
    result lists each file with its partition values."""
    def run(pkg):
        out = tmp_path / f"out_{pkg.__name__}"
        res = pkg.from_pydict({"g": ["a", None, "a"], "h": [1, 1, 2],
                               "v": [1.0, 2.0, 3.0]}) \
            .write_csv(str(out), partition_cols=["g", "h"]).to_pydict()
        dirs = sorted(os.path.relpath(os.path.dirname(p), out)
                      for p in res["path"])
        return dirs, sorted(zip(res["g"], res["h"]),
                            key=lambda r: (r[0] is None, r))
    dirs, parts = _both(run)
    assert dirs == ["g=__HIVE_DEFAULT_PARTITION__/h=1", "g=a/h=1",
                    "g=a/h=2"]
    assert parts == [("a", 1), ("a", 2), (None, 1)]


def test_write_modes(tmp_path):
    def run(pkg):
        out = str(tmp_path / f"o_{pkg.__name__}")
        df = pkg.from_pydict({"x": [1]})
        df.write_parquet(out)
        df.write_parquet(out)  # append
        n_append = len(pkg.read_parquet(out).to_pydict()["x"])
        df.write_parquet(out, write_mode="overwrite")
        return n_append, len(pkg.read_parquet(out).to_pydict()["x"])
    assert _both(run) == (2, 1)


def test_write_returns_paths(tmp_path):
    res = daft_tpu_torch.from_pydict({"x": [1, 2]}).write_parquet(
        str(tmp_path / "w"))
    paths = res.to_pydict()["path"]
    assert len(paths) >= 1 and all(p.endswith(".parquet") for p in paths)
    assert res.schema().column_names == ["path"]
    ref = daft_tpu.from_pydict({"x": [1, 2]}).write_parquet(
        str(tmp_path / "w_ref"))
    assert [str(f.dtype) for f in res.schema()] \
        == [str(f.dtype) for f in ref.schema()]


def test_write_splits_at_the_target_file_size(tmp_path, monkeypatch):
    """A partition above the target size (in-memory bytes over the
    format's inflation factor) writes several files, as the reference's
    ``TargetBatchWriter`` does. The reference's target is a config field,
    the port's a constant of ``io/writers.py``."""
    from daft_tpu_torch.io import writers
    monkeypatch.setattr(writers, "PARQUET_TARGET_FILESIZE", 4_000)

    def run(pkg, ctx):
        with ctx():
            res = pkg.from_pydict({"x": list(range(3000))}).write_parquet(
                str(tmp_path / f"s_{pkg.__name__}")).to_pydict()
        return len(res["path"]), sorted(pkg.read_parquet(
            str(tmp_path / f"s_{pkg.__name__}")).to_pydict()["x"])
    want = run(daft_tpu, lambda: daft_tpu.context.execution_config_ctx(
        parquet_target_filesize=4_000))
    got = run(daft_tpu_torch, daft_tpu_torch.execution_config_ctx)
    assert got == want and got[0] > 1 and got[1] == list(range(3000))


def test_from_glob_path(pq_dir):
    d = _both(lambda pkg: pkg.from_glob_path(pq_dir + "/*.parquet")
              .to_pydict())
    assert len(d["path"]) == 4 and all(s > 0 for s in d["size"])


def test_scan_task_merging(pq_dir):
    from daft_tpu.io.scan import GlobScanOperator as RefOp
    from daft_tpu.io.scan import Pushdowns as RefPush
    from daft_tpu_torch.io.scan import GlobScanOperator, Pushdowns
    tasks = GlobScanOperator(pq_dir + "/*.parquet", "parquet") \
        .to_scan_tasks(Pushdowns())
    ref = RefOp(pq_dir + "/*.parquet", "parquet").to_scan_tasks(RefPush())
    # 4 tiny files merge into 1 task under the 96MB min-size target
    assert len(tasks) == len(ref) == 1
    assert tasks[0].paths == ref[0].paths and len(tasks[0].paths) == 4
    assert tasks[0].num_rows() == ref[0].num_rows() == 40
    assert all(md is not None for _, md, _ in tasks[0].files())


def test_csv_no_header(tmp_path):
    p = tmp_path / "x.csv"
    p.write_text("1,a\n2,b\n")
    d = _both(lambda pkg: pkg.read_csv(str(p), has_headers=False)
              .to_pydict())
    assert len(d) == 2


def test_csv_options(tmp_path):
    p = tmp_path / "x.tsv"
    p.write_text("k|s\n1|'a|b'\n2|c\n")
    d = _both(lambda pkg: pkg.read_csv(
        str(p), delimiter="|", quote="'",
        schema={"k": pkg.DataType.int32(), "s": pkg.DataType.string()})
        .to_pydict())
    assert d == {"k": [1, 2], "s": ["a|b", "c"]}


def test_csv_and_json_scan_tasks_are_per_file(tmp_path):
    """CSV and JSON files have no footer: one task per file, merged by
    their byte size, with no row count, and a filter over them."""
    for i in range(3):
        (tmp_path / f"p{i}.json").write_text(
            "".join(json.dumps({"a": i * 10 + j, "s": f"v{j}"}) + "\n"
                    for j in range(10)))
    got = _both(lambda pkg: sorted(pkg.read_json(
        str(tmp_path / "*.json")).where(pkg.col("a") % 7 == 0)
        .select("a").to_pydict()["a"]))
    assert got == [0, 7, 14, 21, 28]
    from daft_tpu_torch.io.scan import GlobScanOperator, Pushdowns
    tasks = GlobScanOperator(str(tmp_path / "*.json"), "json") \
        .to_scan_tasks(Pushdowns())
    assert len(tasks) == 1 and len(tasks[0].paths) == 3
    assert tasks[0].num_rows() is None and tasks[0].size_bytes() > 0
    assert [md for _, md, _ in tasks[0].files()] == [None] * 3


# -- WARC (reference: src/daft-warc) ----------------------------------------

def _write_warc(path, gz=False):
    recs = []
    for i, (rtype, body) in enumerate([
            ("warcinfo", b"software: test\r\n"),
            ("request", b"GET / HTTP/1.1\r\nHost: example.com\r\n"),
            ("response", b"HTTP/1.1 200 OK\r\n\r\n<html>hello</html>")]):
        hdr = (f"WARC/1.1\r\n"
               f"WARC-Record-ID: <urn:uuid:0000-{i}>\r\n"
               f"WARC-Type: {rtype}\r\n"
               f"WARC-Date: 2024-01-0{i+1}T00:00:00Z\r\n"
               f"WARC-Target-URI: http://example.com/{i}\r\n"
               f"Content-Length: {len(body)}\r\n\r\n").encode()
        recs.append(hdr + body + b"\r\n\r\n")
    blob = b"".join(recs)
    with open(path, "wb") as f:
        f.write(gzip.compress(blob) if gz else blob)


@pytest.mark.parametrize("gz", [False, True])
def test_read_warc(tmp_path, gz):
    p = str(tmp_path / ("x.warc.gz" if gz else "x.warc"))
    _write_warc(p, gz)
    out = _both(lambda pkg: pkg.read_warc(p).to_pydict())
    assert out["WARC-Type"] == ["warcinfo", "request", "response"]
    assert out["WARC-Record-ID"] == [f"<urn:uuid:0000-{i}>"
                                     for i in range(3)]
    assert out["warc_content"][2] == \
        b"HTTP/1.1 200 OK\r\n\r\n<html>hello</html>"
    assert out["Content-Length"] == [16, 35, 37]
    hdrs = json.loads(out["warc_headers"][1])
    assert hdrs["WARC-Target-URI"] == "http://example.com/1"
    assert out["WARC-Date"][0].year == 2024


def test_read_warc_pushdowns(tmp_path):
    p = str(tmp_path / "x.warc")
    _write_warc(p)
    out = _both(lambda pkg: pkg.read_warc(p)
                .where(pkg.col("WARC-Type") == "response")
                .select("WARC-Record-ID").to_pydict())
    assert out == {"WARC-Record-ID": ["<urn:uuid:0000-2>"]}
    assert _both(lambda pkg: pkg.read_warc(p).limit(2)
                 .to_pydict()["WARC-Type"]) == ["warcinfo", "request"]


def test_split_scan_tasks_by_row_group(tmp_path):
    """Oversized parquet files split into per-row-group-range tasks
    (reference: scan_task_iters/split_parquet)."""
    p = str(tmp_path / "big.parquet")
    t = pa.table({"x": list(range(10000)),
                  "y": [float(i) for i in range(10000)]})
    pq.write_table(t, p, row_group_size=1000)  # 10 row groups

    def run(pkg, ctx):
        with ctx(scan_tasks_max_size_bytes=20_000,
                 scan_tasks_min_size_bytes=10_000):
            df = pkg.read_parquet(p)
            nparts = df.num_partitions()
            out = df.to_pydict()
        with ctx(scan_tasks_max_size_bytes=20_000):
            s = pkg.read_parquet(p).sum("y").to_pydict()
        return nparts, out, s
    want = run(daft_tpu, daft_tpu.context.execution_config_ctx)
    got = run(daft_tpu_torch, daft_tpu_torch.execution_config_ctx)
    assert got == want
    assert got[0] > 1
    assert got[1]["x"] == list(range(10000))
    assert got[2]["y"] == [sum(float(i) for i in range(10000))]


# -- read_sql, sinks, configs, the cache key ---------------------------------

@pytest.mark.parametrize("parts", [None, 3])
def test_read_sql(tmp_path, parts):
    db = str(tmp_path / "t.db")
    c = sqlite3.connect(db)
    c.execute("CREATE TABLE t (k INTEGER, v REAL, s TEXT)")
    c.executemany("INSERT INTO t VALUES (?, ?, ?)",
                  [(i, i * 0.5, f"s{i % 3}") for i in range(20)])
    c.commit()
    c.close()

    def run(pkg):
        kw = {} if parts is None else {"partition_col": "k",
                                       "num_partitions": parts}
        df = pkg.read_sql("SELECT * FROM t", lambda: sqlite3.connect(db),
                          **kw)
        return df.num_partitions(), df.where(pkg.col("k") >= 5).sort("k") \
            .to_pydict()
    nparts, d = _both(run)
    assert nparts == (parts or 1)
    assert d["k"] == list(range(5, 20)) and d["s"][0] == "s2"


def test_write_sink(tmp_path):
    def run(pkg):
        from importlib import import_module
        sink_mod = import_module(f"{pkg.__name__}.io.sink")

        class Counting(sink_mod.DataSink):
            def write(self, micropartitions):
                for mp in micropartitions:
                    yield sink_mod.WriteResult(len(mp), rows_written=len(mp))
        df = pkg.from_pydict({"x": list(range(10))}).into_partitions(2)
        return sorted(df.write_sink(Counting()).to_pydict()["write_results"])
    assert _both(run) == [5, 5]


def test_io_configs_are_exported():
    for name in ("IOConfig", "S3Config", "GCSConfig", "AzureConfig",
                 "HTTPConfig"):
        port, ref = getattr(daft_tpu_torch, name), getattr(daft_tpu, name)
        assert [f.name for f in __import__("dataclasses").fields(port)] \
            == [f.name for f in __import__("dataclasses").fields(ref)]
        assert port() == port()
    cfg = daft_tpu_torch.IOConfig(s3=daft_tpu_torch.S3Config(anonymous=True))
    assert cfg.s3.anonymous and cfg.http.num_tries == 3


def test_cache_fingerprint_keys_on_format_and_locality(tmp_path):
    """The device column cache's key (reference
    ``device/cache.py:task_fingerprint``): the file format is in it, and a
    remote or generated task has none."""
    import torch
    from daft_tpu.device import cache as ref_cache
    from daft_tpu.io.scan import Pushdowns as RefPush, ScanTask as RefTask
    from daft_tpu_torch.device import cache
    from daft_tpu_torch.io.scan import Pushdowns, ScanTask
    from daft_tpu_torch.schema import Schema
    p = str(tmp_path / "x.parquet")
    pq.write_table(pa.table({"x": [1, 2]}), p)
    schema = Schema.from_arrow(pq.read_schema(p))
    cpu = torch.device("cpu")

    def port_fp(paths, fmt, gen=None):
        return cache.task_fingerprint(ScanTask(
            paths, schema, Pushdowns(), file_format=fmt, generator=gen), cpu)

    def ref_fp(paths, fmt, gen=None):
        return ref_cache.task_fingerprint(RefTask(
            paths, fmt, None, RefPush(), generator=gen))
    for paths, fmt, gen in (([p], "parquet", None), ([p], "csv", None),
                            (["http://127.0.0.1:1/x.parquet"], "parquet",
                             None),
                            ([], "memory", lambda: iter([])),
                            ([str(tmp_path / "gone")], "parquet", None)):
        got, want = port_fp(paths, fmt, gen), ref_fp(paths, fmt, gen)
        assert (got is None) == (want is None), (paths, fmt)
    assert port_fp([p], "parquet") != port_fp([p], "csv")
    assert port_fp([p], "parquet") == port_fp([p], "parquet")


def test_generator_and_in_memory_scan_operators():
    """The scan operators over pre-resolved entries and materialized
    partitions plan and read as the reference's: a pruned entry is
    dropped at planning, the pushdowns reach each loader, an all-pruned
    scan yields the empty schema."""
    def run(pkg):
        from importlib import import_module
        scan = import_module(f"{pkg.__name__}.io.scan")
        builder = import_module(f"{pkg.__name__}.logical.builder")
        rb_mod = import_module(f"{pkg.__name__}.recordbatch")
        mp_mod = import_module(f"{pkg.__name__}.micropartition")
        df_mod = import_module(f"{pkg.__name__}.dataframe")
        rbs = [rb_mod.RecordBatch.from_pydict({"k": [i, i + 10],
                                               "v": [i * 1.5, i * 2.5]})
               for i in range(3)]
        seen = []

        def loader(i):
            def load(pushdowns):
                seen.append((i, pushdowns.columns))
                yield rbs[i]
            return load
        op = scan.GeneratorScanOperator(
            rbs[0].schema, [([f"e{i}"], loader(i)) for i in range(3)],
            "entries", prune_fn=lambda i, pd: i != 1)
        gen = df_mod.DataFrame(builder.LogicalPlanBuilder.from_scan(op))
        out1 = gen.where(pkg.col("k") > 0).select("k").sort("k") \
            .to_pydict()
        none = scan.GeneratorScanOperator(
            rbs[0].schema, [(["e0"], loader(0))], "none",
            prune_fn=lambda i, pd: False)
        out2 = df_mod.DataFrame(builder.LogicalPlanBuilder.from_scan(
            none)).to_pydict()
        parts = [mp_mod.MicroPartition.from_recordbatch(rb) for rb in rbs]
        mem = scan.InMemoryScanOperator(rbs[0].schema, parts)
        out3 = df_mod.DataFrame(builder.LogicalPlanBuilder.from_scan(
            mem)).sort("v", desc=True).to_pydict()
        return out1, out2, out3, sorted({i for i, _ in seen})
    got = _both(run)
    assert got[0] == {"k": [2, 10, 12]}
    assert got[1] == {"k": [], "v": []}
    assert len(got[2]["k"]) == 6 and got[3] == [0, 2]


@pytest.mark.parametrize("fmt", ["parquet", "json"])
def test_read_with_a_given_schema(tmp_path, fmt):
    """A given schema replaces the inferred one: its columns only, each
    cast to its type."""
    p = str(tmp_path / f"t.{fmt}")
    if fmt == "parquet":
        pq.write_table(pa.table({"a": [1, 2, 3], "b": ["x", "y", "z"],
                                 "c": [1.5, 2.5, 3.5]}), p)
    else:
        with open(p, "w") as f:
            f.write('{"a": 1, "b": "x"}\n{"a": 2, "b": "y"}\n')

    def run(pkg):
        df = getattr(pkg, f"read_{fmt}")(p, schema={
            "a": pkg.DataType.float64(), "b": pkg.DataType.string()})
        return str(df.schema()), df.to_pydict()
    names, d = _both(run)
    assert d["a"][:2] == [1.0, 2.0] and list(d) == ["a", "b"]

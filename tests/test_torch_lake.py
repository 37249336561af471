"""The lake formats of ROADMAP A8e (``daft_tpu_torch/io/{delta,iceberg,
hudi,lance,avro}.py``, ``catalog_unity.py``) held against ``daft_tpu``:

- a Delta, an Iceberg and a Lance table written by each package (create,
  append, overwrite) and read by the other, the data equal at every
  version;
- the logs the two writers leave, with the fields no two writers share
  masked (UUIDs, snapshot ids, timestamps, the engine's name): Delta's
  actions, Iceberg's metadata, manifest lists and manifests (file lists
  and record counts), Lance's version manifests. File bytes are never
  compared;
- a copy-on-write Hudi table laid out as ``tests/test_hudi.py`` lays one
  out (file groups, one commit, then a newer slice) read alike;
- the Avro codec's bytes read by the other package's reader;
- a Unity catalog over one mock server (phase 7q's ``UnityMock``, after
  ``tests/test_catalog_unity.py``'s handler) listed and read alike
  through both packages' adapters;
- ``count_rows`` of tables past one scan morsel.
"""

import http.server
import json
import os
import re
import threading

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import daft_tpu
import daft_tpu_torch

PKGS = (daft_tpu, daft_tpu_torch)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")


def _frames(p):
    return [p.from_pydict({"k": [1, 2, 3], "s": ["a", "b", None],
                           "f": [0.5, None, 2.5]}),
            p.from_pydict({"k": [4], "s": ["d"], "f": [4.5]}),
            p.from_pydict({"k": [9, 8], "s": ["z", "y"], "f": [9.0, 8.0]})]


def _sorted(d: dict) -> dict:
    order = sorted(range(len(d["k"])), key=lambda i: d["k"][i])
    return {c: [v[i] for i in order] for c, v in d.items()}


# (writer method, its modes in order, the reader and its version keyword)
FORMATS = {
    "delta": ("write_deltalake", ("append", "append", "overwrite"),
              "read_deltalake", "version", 0),
    "iceberg": ("write_iceberg", ("append", "append", "overwrite"),
                "read_iceberg", None, None),
    "lance": ("write_lance", ("create", "append", "overwrite"),
              "read_lance", "version", 1),
}


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("writer", ["daft_tpu", "daft_tpu_torch"])
def test_written_by_one_read_by_the_other(tmp_path, fmt, writer):
    meth, modes, reader, vkw, v0 = FORMATS[fmt]
    w = daft_tpu if writer == "daft_tpu" else daft_tpu_torch
    uri = str(tmp_path / fmt)
    expect = []
    for df, mode in zip(_frames(w), modes):
        getattr(df, meth)(uri, mode=mode)
        expect.append(df.to_pydict())
    latest = {c: expect[2][c] for c in expect[2]}
    for p in PKGS:
        assert _sorted(getattr(p, reader)(uri).to_pydict()) \
            == _sorted(latest)
    if vkw is None:  # Iceberg: time travel by snapshot id
        ids = {}
        for p in PKGS:
            mod = __import__(f"{p.__name__}.io.iceberg", fromlist=["x"])
            meta = mod.load_table_metadata(uri)
            ids[p.__name__] = [s["snapshot-id"] for s in meta["snapshots"]]
        assert ids["daft_tpu"] == ids["daft_tpu_torch"]
        versions = [dict(snapshot_id=s) for s in ids["daft_tpu"]]
    else:
        versions = [{vkw: v0 + i} for i in range(3)]
    first_two = {c: expect[0][c] + expect[1][c] for c in expect[0]}
    for kw, want in zip(versions, (expect[0], first_two, latest)):
        for p in PKGS:
            got = getattr(p, reader)(uri, **kw).to_pydict()
            assert _sorted(got) == _sorted(want), (p.__name__, kw)


# ------------------------------------------------------------- the logs

_UUID = re.compile(r"[0-9a-f]{8}-?[0-9a-f]{4}-?[0-9a-f]{4}-?[0-9a-f]{4}-?"
                   r"[0-9a-f]{12}|[0-9a-f]{32}")
_PART = re.compile(r"(part-\d+-\d+-)[0-9a-f]{8}")
_LONG = re.compile(r"\b\d{12,}\b")


def _mask(text: str, root: str) -> str:
    text = text.replace(root, "ROOT")
    text = _UUID.sub("UUID", text)
    text = _PART.sub(r"\1PART", text)
    text = _LONG.sub("0", text)
    return text.replace("daft-tpu-torch", "daft-tpu")


def _write_both(tmp_path, meth, modes):
    roots = {}
    for p, d in zip(PKGS, ("ref", "prt")):
        # roots of one length: a manifest's byte length counts its paths
        root = str(tmp_path / d)
        for df, mode in zip(_frames(p), modes):
            getattr(df, meth)(root, mode=mode)
        roots[p.__name__] = root
    return roots


def _json_objects(path: str):
    with open(path) as f:
        return [json.loads(x) for x in f.read().splitlines() if x.strip()]


def test_delta_logs_agree(tmp_path):
    roots = _write_both(tmp_path, *FORMATS["delta"][:2])
    logs = {}
    for name, root in roots.items():
        d = os.path.join(root, "_delta_log")
        logs[name] = [
            _mask(json.dumps(_json_objects(os.path.join(d, f)),
                             sort_keys=True), root)
            for f in sorted(os.listdir(d))]
    assert len(logs["daft_tpu"]) == 3
    assert logs["daft_tpu_torch"] == logs["daft_tpu"]
    actions = [json.loads(x) for x in logs["daft_tpu"]]
    kinds = [sorted({k for a in c for k in a}) for c in actions]
    assert "metaData" in kinds[0] and "add" in kinds[1] \
        and "remove" in kinds[2]


def _iceberg_log(root: str, p) -> list:
    avro = __import__(f"{p.__name__}.io.avro", fromlist=["x"])
    mdir = os.path.join(root, "metadata")
    out = []
    for f in sorted(os.listdir(mdir)):
        if not f.endswith(".metadata.json"):
            continue
        meta = json.load(open(os.path.join(mdir, f)))
        snaps = []
        for s in meta.get("snapshots", []):
            ml = s["manifest-list"]
            ml = ml if os.path.isabs(ml) else os.path.join(
                os.path.dirname(root), ml) if not os.path.exists(ml) else ml
            manifests = []
            for m in avro.read_avro(open(ml, "rb").read())[1]:
                entries = avro.read_avro(open(m["manifest_path"], "rb")
                                         .read())[1]
                manifests.append(dict(
                    m, entries=[dict(e["data_file"], status=e["status"])
                                for e in entries]))
            snaps.append(dict(s, manifests=manifests))
        out.append(dict(meta, snapshots=snaps))
    return out


def test_iceberg_logs_agree(tmp_path):
    roots = _write_both(tmp_path, *FORMATS["iceberg"][:2])
    logs = {name: _mask(json.dumps(_iceberg_log(root, p), sort_keys=True,
                                   default=str), root)
            for (name, root), p in zip(roots.items(), PKGS)}
    assert logs["daft_tpu_torch"] == logs["daft_tpu"]
    log = json.loads(logs["daft_tpu"])
    assert len(log) == 3 and len(log[-1]["snapshots"]) == 3
    counts = [sum(e["record_count"] for m in s["manifests"]
                  for e in m["entries"] if e["status"] != 2)
              for s in log[-1]["snapshots"]]
    assert counts == [3, 4, 2]


def test_lance_versions_agree(tmp_path):
    roots = _write_both(tmp_path, *FORMATS["lance"][:2])
    logs = {}
    for name, root in roots.items():
        d = os.path.join(root, "_versions")
        logs[name] = [_mask(open(os.path.join(d, f)).read(), root)
                      for f in sorted(os.listdir(d))]
    assert len(logs["daft_tpu"]) == 3
    assert logs["daft_tpu_torch"] == logs["daft_tpu"]


# ------------------------------------------------------------------ Hudi

def _hudi_table(root, groups: int):
    """``groups`` copy-on-write file groups at instant 001, the first
    rewritten at 002 (``tests/test_hudi.py``'s layout)."""
    h = root / ".hoodie"
    h.mkdir(parents=True)
    (h / "hoodie.properties").write_text(
        "hoodie.table.name=t\nhoodie.table.type=COPY_ON_WRITE\n")
    for g in range(groups):
        pq.write_table(pa.table({"id": [g * 10, g * 10 + 1],
                                 "v": [float(g), g + 0.5]}),
                       root / f"fg{g}_0-1-0_001.parquet")
    (h / "001.commit").write_text(json.dumps({}))
    pq.write_table(pa.table({"id": [0, 1, 2], "v": [7.0, 7.5, 8.0]}),
                   root / "fg0_0-1-0_002.parquet")
    (h / "002.commit").write_text(json.dumps({}))
    # an uncommitted slice stays invisible
    pq.write_table(pa.table({"id": [99], "v": [9.9]}),
                   root / "fg1_0-1-0_003.parquet")


def test_hudi_snapshot_read_alike(tmp_path):
    _hudi_table(tmp_path / "h", 8)
    got = {p.__name__: p.read_hudi(str(tmp_path / "h")).sort("id")
           .to_pydict() for p in PKGS}
    assert got["daft_tpu_torch"] == got["daft_tpu"]
    assert len(got["daft_tpu"]["id"]) == 3 + 7 * 2
    files = {p.__name__: sorted(
        (os.path.basename(f["path"]), f["file_id"], f["instant"])
        for f in __import__(f"{p.__name__}.io.hudi", fromlist=["x"])
        .snapshot_files(str(tmp_path / "h"))) for p in PKGS}
    assert files["daft_tpu_torch"] == files["daft_tpu"]


# ------------------------------------------------------------------ Avro

def test_avro_bytes_cross_read():
    schema = {"type": "record", "name": "r", "fields": [
        {"name": "a", "type": "long"}, {"name": "b", "type": ["null",
                                                             "string"]},
        {"name": "c", "type": {"type": "array", "items": "double"}}]}
    recs = [{"a": i, "b": None if i % 2 else str(i), "c": [i / 2.0]}
            for i in range(20)]
    from daft_tpu.io import avro as ref_avro
    from daft_tpu_torch.io import avro as port_avro
    for w, r in ((ref_avro, port_avro), (port_avro, ref_avro)):
        blob = w.write_avro(schema, recs)
        assert r.read_avro(blob)[1] == recs


# ----------------------------------------------------------------- Unity

def test_unity_catalog_alike(tmp_path):
    daft_tpu_torch.from_pydict({"k": [2, 1], "v": [20.0, 10.0]}) \
        .write_deltalake(str(tmp_path / "orders"))
    daft_tpu.from_pydict({"e": ["a", "b"]}).write_iceberg(
        str(tmp_path / "events"))
    from daft_tpu_torch.benchmarking.lake_phase import UnityMock
    UnityMock.tables = {
        "unity.sales.orders": {"storage_location": str(tmp_path / "orders"),
                               "data_source_format": "DELTA"},
        "unity.sales.events": {"storage_location": str(tmp_path / "events"),
                               "data_source_format": "ICEBERG"}}
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), UnityMock)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{server.server_port}"
        out = {}
        for p in PKGS:
            uc = __import__(f"{p.__name__}.catalog_unity", fromlist=["x"])
            cat = uc.UnityCatalog(url, token="t", catalog="unity", name="uc")
            sess = p.Session()
            sess.attach(cat)
            out[p.__name__] = (
                sorted(str(t) for t in cat.list_tables()),
                sess.sql("SELECT k, v FROM uc.sales.orders ORDER BY k")
                .to_pydict(),
                sess.sql("SELECT e FROM uc.sales.events ORDER BY e")
                .to_pydict())
        assert out["daft_tpu_torch"] == out["daft_tpu"]
        assert out["daft_tpu"][1] == {"k": [1, 2], "v": [10.0, 20.0]}
    finally:
        server.shutdown()
        server.server_close()


def test_count_rows_past_one_morsel(tmp_path):
    """A count scans no column; the scan cuts a file's batch into morsels
    of 131,072 rows, and a morsel without columns keeps its row count (the
    reference counts 0 for a file past one morsel: ROADMAP Queue C
    caveats)."""
    import numpy as np
    n = 200_000
    path = str(tmp_path / "x.parquet")
    pq.write_table(pa.table({"a": np.arange(n)}), path)
    df = daft_tpu_torch.read_parquet(path)
    df.write_iceberg(str(tmp_path / "ice"))
    df.write_lance(str(tmp_path / "lance"))
    assert df.count_rows() == n
    assert daft_tpu_torch.read_iceberg(str(tmp_path / "ice")).count_rows() \
        == n
    assert daft_tpu_torch.read_lance(str(tmp_path / "lance")).count_rows() \
        == n


def test_catalog_factories_raise_for_missing_sdks():
    for p in PKGS:
        for meth, pkg in (("from_iceberg", "pyiceberg"),
                          ("from_unity", "unitycatalog")):
            with pytest.raises(ImportError, match=pkg):
                getattr(p.Catalog, meth)(object())

"""The port's filesystem catalog against the reference's
(``tests/test_catalog_fs.py``): a warehouse directory whose subdirectories
are namespaces and whose table directories are detected as Iceberg,
Delta, Hudi or parquet. The warehouse's lake tables are written by
``daft_tpu``; both packages list the same tables and namespaces and read
every table alike (through the catalog and through SQL); the port's
writes append to the lake tables and create Iceberg tables."""

import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.catalog_fs import FilesystemCatalog as RefCatalog
from daft_tpu_torch.catalog import Identifier, NotFoundError
from daft_tpu_torch.catalog_fs import FilesystemCatalog


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("DAFT_TPU_DEVICE", "0")


@pytest.fixture
def warehouse(tmp_path):
    root = tmp_path / "wh"
    (root / "sales").mkdir(parents=True)
    daft_tpu.from_pydict({"k": [1, 2], "v": [10.0, 20.0]}) \
        .write_iceberg(str(root / "sales" / "orders"))
    from daft_tpu.io.delta import write_deltalake
    write_deltalake(daft_tpu.from_pydict({"c": ["a", "b"]}),
                    str(root / "sales" / "customers"))
    daft_tpu_torch.from_pydict({"p": [7]}) \
        .write_parquet(str(root / "raw_events"))
    daft_tpu_torch.from_pydict({"k": [2, 1, 3], "v": [2.5, 1.5, 3.5]}) \
        .write_parquet(str(root / "sales" / "returns"))
    return root


def test_list_and_detect_formats(warehouse):
    cat = FilesystemCatalog(str(warehouse), name="lake")
    ref = RefCatalog(str(warehouse), name="lake")
    tables = {str(t) for t in cat._list_tables()}
    assert tables == {str(t) for t in ref._list_tables()} == {
        "sales.orders", "sales.customers", "sales.returns", "raw_events"}
    for ident, fmt in ((("sales", "orders"), "iceberg"),
                       (("sales", "customers"), "delta"),
                       (("sales", "returns"), "parquet"),
                       (("raw_events",), "parquet")):
        assert cat._get_table(Identifier(*ident)).format == fmt
    assert cat.list_tables() == [Identifier(*str(t).split("."))
                                 for t in cat._list_tables()]


def test_read_through_catalog(warehouse):
    cat = FilesystemCatalog(str(warehouse))
    ref = RefCatalog(str(warehouse))
    for ident in (("raw_events",), ("sales", "returns"), ("sales", "orders"),
                  ("sales", "customers")):
        got = cat._get_table(Identifier(*ident)).read()
        want = ref._get_table(daft_tpu.catalog.Identifier(*ident)).read()
        assert got.sort(got.column_names[0]).to_pydict() \
            == want.sort(want.column_names[0]).to_pydict()
    assert cat._get_table(Identifier("raw_events")).read().to_pydict() \
        == {"p": [7]}
    assert cat._get_table(Identifier("sales", "orders")).read() \
        .sort("k").to_pydict() == {"k": [1, 2], "v": [10.0, 20.0]}
    with pytest.raises(NotFoundError):
        cat._get_table(Identifier("sales", "absent"))


def test_sql_over_attached_catalog(warehouse):
    q = "SELECT k, v * 2 AS v2 FROM lake.sales.returns ORDER BY k"
    sess = daft_tpu_torch.Session()
    sess.attach(FilesystemCatalog(str(warehouse), name="lake"))
    ref = daft_tpu.Session()
    ref.attach(RefCatalog(str(warehouse), name="lake"))
    got = sess.sql(q).to_pydict()
    assert got == ref.sql(q).to_pydict() == {"k": [1, 2, 3],
                                             "v2": [3.0, 5.0, 7.0]}


def test_append_overwrite_and_drop_roundtrip(warehouse):
    """A parquet table takes appends and overwrites through the port's
    writes; the Iceberg and Delta tables take appends, read back by the
    reference; ``create_table`` makes an empty Iceberg table."""
    from daft_tpu_torch.datatype import DataType
    from daft_tpu_torch.schema import Field, Schema
    cat = FilesystemCatalog(str(warehouse))
    ident = Identifier("sales", "returns")
    t = cat._get_table(ident)
    t.append(daft_tpu_torch.from_pydict({"k": [5], "v": [5.5]}))
    assert sorted(cat._get_table(ident).read().to_pydict()["k"]) \
        == [1, 2, 3, 5]
    t.overwrite(daft_tpu_torch.from_pydict({"k": [9], "v": [9.5]}))
    assert cat._get_table(ident).read().to_pydict() == {"k": [9],
                                                       "v": [9.5]}
    with pytest.raises(ValueError, match="write mode"):
        t.write(daft_tpu_torch.from_pydict({"k": [1], "v": [1.0]}),
                mode="upsert")
    cat._get_table(Identifier("sales", "orders")).append(
        daft_tpu_torch.from_pydict({"k": [3], "v": [1.0]}))
    cat._get_table(Identifier("sales", "customers")).append(
        daft_tpu_torch.from_pydict({"c": ["z"]}))
    ref = RefCatalog(str(warehouse))
    ids = daft_tpu.catalog.Identifier
    assert sorted(ref._get_table(ids("sales", "orders")).read()
                  .to_pydict()["k"]) == [1, 2, 3]
    assert sorted(ref._get_table(ids("sales", "customers")).read()
                  .to_pydict()["c"]) == ["a", "b", "z"]
    new = cat._create_table(Identifier("sales", "new_tbl"),
                            Schema([Field("x", DataType.int64())]))
    assert new.format == "iceberg"
    assert ref._get_table(ids("sales", "new_tbl")).read().to_pydict() \
        == {"x": []}
    with pytest.raises(ValueError, match="already exists"):
        cat._create_table(ident, Schema([Field("x", DataType.int64())]))
    cat._drop_table(ident)
    with pytest.raises(NotFoundError):
        cat._get_table(ident)


def test_namespaces(warehouse):
    cat = FilesystemCatalog(str(warehouse))
    ref = RefCatalog(str(warehouse))
    assert [str(n) for n in cat._list_namespaces()] \
        == [str(n) for n in ref._list_namespaces()] == ["sales"]
    cat._create_namespace(Identifier("marketing"))
    assert cat._has_namespace(Identifier("marketing"))
    with pytest.raises(ValueError):
        cat._create_namespace(Identifier("marketing"))
    cat._drop_namespace(Identifier("marketing"))
    assert not cat._has_namespace(Identifier("marketing"))
    with pytest.raises(ValueError, match="not empty"):
        cat._drop_namespace(Identifier("sales"))

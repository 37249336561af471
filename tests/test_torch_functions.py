"""The ``binary``, ``json`` and ``url`` namespaces and the object IO
client, held against ``daft_tpu``: the 15 non-image cases of
``tests/test_functions.py``, each run through both packages on the same
inputs, the answers equal (bytes, strings and nulls exactly) and the
reference's own assertions kept. The three image cases are replayed in
``tests/test_torch_image.py``.
"""

import base64

import pytest

import daft_tpu
import daft_tpu_torch


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")


PKGS = (daft_tpu, daft_tpu_torch)


def _both(fn):
    """``fn(pkg)`` for the reference and the port; asserts the two agree
    and returns the reference's value."""
    ref, port = (fn(p) for p in PKGS)
    assert port == ref
    return ref


def _one_col(df, name):
    return df.to_pydict()[name]


# -- binary -----------------------------------------------------------------

def test_binary_concat_length_slice():
    def run(p):
        df = p.from_pydict({"a": [b"hello", b"", None],
                            "b": [b"!", b"x", b"y"]})
        return df.select(
            p.col("a").binary.concat(p.col("b")).alias("cat"),
            p.col("a").binary.length().alias("len"),
            p.col("a").binary.slice(1, 3).alias("sl"),
        ).to_pydict()
    out = _both(run)
    assert out["cat"] == [b"hello!", b"x", None]
    assert out["len"] == [5, 0, None]
    assert out["sl"] == [b"ell", b"", None]


@pytest.mark.parametrize("codec,plain,coded", [
    ("base64", b"daft", base64.b64encode(b"daft")),
    ("hex", b"\x01\xff", b"01ff"),
])
def test_binary_encode_decode(codec, plain, coded):
    def run(p):
        df = p.from_pydict({"a": [plain]})
        enc = _one_col(df.select(p.col("a").binary.encode(codec)), "a")
        dec = _one_col(p.from_pydict({"a": enc}).select(
            p.col("a").binary.decode(codec)), "a")
        return enc, dec
    enc, dec = _both(run)
    assert enc == [coded]
    assert dec == [plain]


def test_binary_roundtrip_compression():
    data = b"a" * 1000

    def run(p):
        df = p.from_pydict({"a": [data]})
        out = {}
        for codec in ("gzip", "zlib", "deflate"):
            enc = _one_col(df.select(p.col("a").binary.encode(codec)), "a")
            dec = _one_col(p.from_pydict({"a": enc})
                           .select(p.col("a").binary.decode(codec)), "a")
            # gzip stamps the time: compare lengths and round trips
            out[codec] = (len(enc[0]) < len(data), dec)
        return out
    for ok, dec in _both(run).values():
        assert ok and dec == [data]


def test_binary_try_decode_null_on_error():
    def run(p):
        df = p.from_pydict({"a": [b"!!!not-base64!!!",
                                  base64.b64encode(b"ok")]})
        return _one_col(df.select(p.col("a").binary.try_decode("base64")),
                        "a")
    out = _both(run)
    assert out[0] is None
    assert out[1] == b"ok"


# -- json -------------------------------------------------------------------

def test_json_query_paths():
    docs = ['{"a": {"b": 1}, "c": [10, 20, 30]}',
            '{"a": {"b": "x"}, "c": []}',
            None]

    def run(p):
        df = p.from_pydict({"j": docs})
        return df.select(
            p.col("j").json.query(".a.b").alias("ab"),
            p.col("j").json.query(".c[1]").alias("c1"),
            p.col("j").json.query(".c[]").alias("call"),
        ).to_pydict()
    out = _both(run)
    assert out["ab"] == ["1", "x", None]
    assert out["c1"] == ["20", None, None]
    assert out["call"] == ["[10, 20, 30]", "[]", None]


def test_json_query_iteration_always_array():
    def run(p):
        df = p.from_pydict({"j": ['{"c": [10]}', '{"c": [10, 20]}']})
        return _one_col(df.select(p.col("j").json.query(".c[]")), "j")
    assert _both(run) == ["[10]", "[10, 20]"]


def test_json_query_pipe():
    def run(p):
        df = p.from_pydict({"j": ['{"a": [{"b": 5}]}']})
        return _one_col(df.select(p.col("j").json.query(".a[0] | .b")), "j")
    assert _both(run) == ["5"]


# -- url --------------------------------------------------------------------

def test_url_download_local(tmp_path):
    paths = []
    for i in range(3):
        f = tmp_path / f"f{i}.bin"
        f.write_bytes(bytes([i]) * 4)
        paths.append(str(f))

    def run(p):
        df = p.from_pydict({"u": paths + [None]})
        return _one_col(df.select(p.col("u").url.download()), "u")
    assert _both(run) == [b"\x00" * 4, b"\x01" * 4, b"\x02" * 4, None]


def test_url_download_on_error_null(tmp_path):
    def run(p):
        df = p.from_pydict({"u": [str(tmp_path / "missing.bin")]})
        out = _one_col(df.select(p.col("u").url.download(on_error="null")),
                       "u")
        with pytest.raises(Exception):
            df.select(p.col("u").url.download(on_error="raise")).collect()
        return out
    assert _both(run) == [None]


def test_url_upload_roundtrip(tmp_path):
    def run(p):
        d = tmp_path / p.__name__
        d.mkdir()
        df = p.from_pydict({"data": [b"abc", b"def"]})
        out = _one_col(df.select(p.col("data").url.upload(str(d))), "data")
        files = sorted(d.iterdir())
        return (all(x is not None and x.startswith(str(d)) for x in out),
                len(files), sorted(f.read_bytes() for f in files))
    assert _both(run) == (True, 2, [b"abc", b"def"])


def test_url_parse():
    def run(p):
        df = p.from_pydict({"u": ["https://example.com:8080/p/q?x=1#frag",
                                  "http://host:notaport/x"]})
        return _one_col(df.select(p.col("u").url.parse()), "u")
    out = _both(run)
    assert out[0]["scheme"] == "https"
    assert out[0]["host"] == "example.com"
    assert out[0]["port"] == 8080
    assert out[0]["path"] == "/p/q"
    assert out[1] is None


def test_url_upload_unique_across_partitions(tmp_path):
    def run(p):
        d = tmp_path / p.__name__
        d.mkdir()
        (p.from_pydict({"data": [b"A", b"B", b"C", b"D"]})
         .repartition(2)
         .select(p.col("data").url.upload(str(d)))).collect()
        files = list(d.iterdir())
        return len(files), sorted(f.read_bytes() for f in files)
    assert _both(run) == (4, [b"A", b"B", b"C", b"D"])


def test_binary_decode_base64_strict():
    def run(p):
        df = p.from_pydict({"a": [b"####"]})
        with pytest.raises(Exception):
            df.select(p.col("a").binary.decode("base64")).collect()
        return _one_col(df.select(p.col("a").binary.try_decode("base64")),
                        "a")
    assert _both(run) == [None]


# -- object IO --------------------------------------------------------------

def test_local_source_get_range_and_stats(tmp_path):
    f = tmp_path / "x.bin"
    f.write_bytes(b"0123456789")

    def run(p):
        oio = __import__(f"{p.__name__}.io.object_io",
                         fromlist=["object_io"])
        src = oio.LocalSource()
        stats = oio.IOStatsContext("t")
        got = src.get(str(f), (2, 5), stats)
        return got, src.get_size(str(f)), stats.num_gets, stats.bytes_read
    assert _both(run) == (b"234", 10, 1, 3)


def test_io_client_glob(tmp_path):
    for n in ("a.parquet", "b.parquet", "c.csv"):
        (tmp_path / n).write_bytes(b"")

    def run(p):
        oio = __import__(f"{p.__name__}.io.object_io",
                         fromlist=["object_io"])
        hits = oio.get_io_client().glob(str(tmp_path / "*.parquet"))
        return [h.rsplit("/", 1)[1] for h in hits]
    assert _both(run) == ["a.parquet", "b.parquet"]


def test_image_namespace_names_its_roadmap_item():
    """The ``image`` namespace and ``str.tokenize_*`` (ROADMAP A8d) build
    the reference's expressions."""
    def run(p):
        c = p.col("x")
        return [repr(e) for e in (
            c.image.resize(4, 3), c.image.decode(), c.image.to_mode("L"),
            c.str.tokenize_encode(), c.str.tokenize_decode("bytes"))]
    _both(run)

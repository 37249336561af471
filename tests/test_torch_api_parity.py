"""The DataFrame and Expression API additions of ``tests/test_api_parity.py``
held against ``daft_tpu``: its 11 cases, each through both packages on
the same inputs, the answers equal (floats of the math functions within
1e-12 relative) and the reference's assertions kept.
"""

import math

import pyarrow as pa
import pytest

import daft_tpu
import daft_tpu_torch

PKGS = (daft_tpu, daft_tpu_torch)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")


def _both(fn):
    ref, port = (fn(p) for p in PKGS)
    assert port == ref
    return ref


def test_dataframe_aliases_and_pipe():
    def run(p):
        df = p.from_pydict({"x": [1, 2, 2, 3]})
        assert df.melt is not None
        return (df.filter(p.col("x") > 1).count_rows(),
                sorted(df.unique().to_pydict()["x"]),
                df.pipe(lambda d, n: d.limit(n), 2).to_pydict()["x"])
    assert _both(run) == (3, [1, 2, 3], [1, 2])


def test_drop_nan_and_drop_null():
    def run(p):
        df = p.from_pydict({"f": [1.0, float("nan"), 3.0, None],
                            "s": ["a", "b", None, "d"]})
        return (df.drop_nan().count_rows(), df.drop_null("s").count_rows(),
                df.drop_null().count_rows())
    assert _both(run) == (3, 3, 2)


def test_union_by_name_reorders_columns():
    def run(p):
        a = p.from_pydict({"x": [1], "y": ["a"]})
        b = p.from_pydict({"y": ["b"], "x": [2]})
        with pytest.raises(ValueError, match="column sets differ"):
            a.union_by_name(p.from_pydict({"z": [1]}))
        return a.union_all_by_name(b).sort("x").to_pydict()
    assert _both(run) == {"x": [1, 2], "y": ["a", "b"]}


def test_agg_set():
    def run(p):
        df = p.from_pydict({"g": [1, 1, 2], "v": [5, 5, 7]})
        out = df.groupby("g").agg_set("v").sort("g").to_pydict()
        return [sorted(s) for s in out["v"]]
    assert _both(run) == [[5], [7]]


def test_to_arrow_iter_streams_batches():
    def run(p):
        df = p.from_pydict({"x": list(range(100))}).into_partitions(4)
        batches = list(df.to_arrow_iter())
        assert all(isinstance(b, pa.RecordBatch) for b in batches)
        return sorted(v for b in batches for v in b.column(0).to_pylist())
    assert _both(run) == list(range(100))


def test_gated_bridges_error_actionably(tmp_path):
    def run(p):
        df = p.from_pydict({"x": [1]})
        out = []
        for meth, pkg in (("to_ray_dataset", "ray"),
                          ("to_dask_dataframe", "dask")):
            with pytest.raises(ImportError, match=pkg) as e:
                getattr(df, meth)()
            out.append(str(e.value))
        # lance is native (io/lance.py): a real write round-trips
        ds = str(tmp_path / p.__name__)
        df.write_lance(ds)
        out.append(p.read_lance(ds).to_pydict())
        return out
    assert _both(run)[-1] == {"x": [1]}


def test_extended_math_functions():
    def run(p):
        c = p.col
        return p.from_pydict({"x": [0.5]}).select(
            c("x").arcsinh().alias("asinh"),
            (c("x") + 1).arccosh().alias("acosh"),
            c("x").arctanh().alias("atanh"),
            c("x").cot().alias("cot"),
            c("x").csc().alias("csc"),
            c("x").sec().alias("sec"),
            c("x").expm1().alias("em1"),
            c("x").log1p().alias("l1p"),
            c("x").signum().alias("sg"),
            c("x").negative().alias("neg"),
        ).to_pydict()
    ref, port = (run(p) for p in PKGS)
    assert port.keys() == ref.keys()
    for k in ref:
        assert port[k][0] == pytest.approx(ref[k][0], rel=1e-12)
    assert ref["asinh"][0] == pytest.approx(math.asinh(0.5))
    assert ref["acosh"][0] == pytest.approx(math.acosh(1.5))
    assert ref["atanh"][0] == pytest.approx(math.atanh(0.5))
    assert ref["cot"][0] == pytest.approx(1 / math.tan(0.5))
    assert ref["csc"][0] == pytest.approx(1 / math.sin(0.5))
    assert ref["sec"][0] == pytest.approx(1 / math.cos(0.5))
    assert ref["em1"][0] == pytest.approx(math.expm1(0.5))
    assert ref["l1p"][0] == pytest.approx(math.log1p(0.5))
    assert ref["sg"][0] == 1
    assert ref["neg"][0] == -0.5


def test_bitwise_ops():
    def run(p):
        return p.from_pydict({"a": [0b1100], "b": [0b1010]}).select(
            p.col("a").bitwise_and(p.col("b")).alias("and_"),
            p.col("a").bitwise_or(p.col("b")).alias("or_"),
            p.col("a").bitwise_xor(p.col("b")).alias("xor_"),
        ).to_pydict()
    assert _both(run) == {"and_": [0b1000], "or_": [0b1110], "xor_": [0b0110]}


def test_toplevel_codec_and_serde():
    def run(p):
        col, DT = p.col, p.DataType
        rt = p.from_pydict({"b": [b"hello"]}).select(
            col("b").encode("zlib").decode("zlib")).to_pydict()
        bad = p.from_pydict({"b": [b"not-zlib"]}).select(
            col("b").try_decode("zlib")).to_pydict()
        js = p.from_pydict({"j": ['{"a": 1}', "oops", None]})
        out = js.select(col("j").try_deserialize(
            "json", DT.struct({"a": DT.int64()}))).to_pydict()
        with pytest.raises(Exception):
            js.select(col("j").deserialize(
                "json", DT.struct({"a": DT.int64()}))).to_pydict()
        return rt, bad, out
    rt, bad, out = _both(run)
    assert rt["b"] == [b"hello"] and bad["b"] == [None]
    assert out["j"][0] == {"a": 1}
    assert out["j"][1] is None and out["j"][2] is None


def test_deserialize_enforces_declared_dtype():
    def run(p):
        js = p.from_pydict({"j": ['"abc"', "5"]})
        out = js.select(p.col("j").try_deserialize(
            "json", p.DataType.int64())).to_pydict()
        with pytest.raises(Exception):
            js.select(p.col("j").deserialize(
                "json", p.DataType.int64())).to_pydict()
        return out
    assert _both(run)["j"] == [None, 5]


def test_jq_alias():
    def run(p):
        return p.from_pydict({"j": ['{"a": {"b": 7}}']}).select(
            p.col("j").jq(".a.b")).to_pydict()
    assert _both(run)["j"] == ["7"]

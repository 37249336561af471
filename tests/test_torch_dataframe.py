"""The DataFrame surface of ROADMAP A8c held against ``daft_tpu``: the cases
of ``tests/test_dataframe.py`` this slice makes runnable (``explode``, the
list aggregations, monotonic ids and ``apply``, each over the reference's
``nparts`` 1 and 3), ``drop_duplicates``, ``columns_*``, the ``list`` /
``struct`` / ``map`` / ``embedding`` / ``partitioning`` namespaces, the
new ``str`` functions, ``hash`` / ``minhash``, ``list_`` / ``struct``,
each newly enabled SQL function, and a small-scale copy of the card's
MinHash near-dedup phase (``benchmarking/expr_phase.py``) through both
packages. Floats (``list.mean``, ``cosine_distance``) match at 1e-9
relative; everything else exactly.
"""

import datetime

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch

PKGS = (daft_tpu, daft_tpu_torch)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")


@pytest.fixture(params=[1, 3], ids=["p1", "p3"])
def nparts(request):
    return request.param


def mkdf(p, data, nparts=1):
    df = p.from_pydict(data)
    return df.into_partitions(nparts) if nparts > 1 else df


def _both(fn):
    ref, port = (fn(p) for p in PKGS)
    assert port == ref
    return ref


def _close(a, b, rel=1e-9):
    """Equal, floats within ``rel``."""
    if isinstance(a, float) and isinstance(b, float):
        return a == pytest.approx(b, rel=rel, nan_ok=True)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y, rel)
                                        for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k], rel)
                                            for k in a)
    return a == b


# ------------------------------------------- tests/test_dataframe.py cases

def test_agg_list_concat(nparts):
    def run(p):
        df = mkdf(p, {"g": ["a", "a", "b"], "v": [1, 2, 3]}, nparts)
        d = df.groupby("g").agg(p.col("v").agg_list().alias("l")) \
            .sort("g").to_pydict()
        return d["g"], [sorted(x) for x in d["l"]]
    assert _both(run) == (["a", "b"], [[1, 2], [3]])


def test_explode(nparts):
    def run(p):
        df = mkdf(p, {"i": [1, 2], "l": [[1, 2], [3]]}, nparts)
        return df.explode("l").sort(["i", "l"]).to_pydict()
    assert _both(run)["l"] == [1, 2, 3]


def test_explode_nulls_and_empty_lists(nparts):
    def run(p):
        df = mkdf(p, {"i": [1, 2, 3, 4, 5],
                      "l": [["a", None], None, [], ["b"], ["c", "d", "e"]]},
                  nparts)
        return df.explode(p.col("l")).sort(["i", "l"]).to_pydict()
    out = _both(run)
    assert out["i"] == [1, 1, 2, 3, 4, 5, 5, 5]


def test_monotonic_id(nparts):
    def run(p):
        from importlib import import_module
        fns = import_module(f"{p.__name__}.functions")
        df = mkdf(p, {"a": [1, 2, 3, 4]}, nparts)
        ids = df.add_monotonically_increasing_id().to_pydict()["id"]
        sel = df.select(p.col("a"), fns.monotonically_increasing_id()
                        .alias("rid")).to_pydict()
        wc = df.with_column("rid", fns.monotonically_increasing_id() + 1) \
            .to_pydict()
        return ids, sel, wc
    ids, sel, wc = _both(run)
    assert len(set(ids)) == 4 and len(set(sel["rid"])) == 4
    assert wc["rid"] == [r + 1 for r in sel["rid"]]


def test_apply(nparts):
    def run(p):
        df = mkdf(p, {"a": [1, 2, None]}, nparts)
        return df.select(p.col("a").apply(lambda x: x * 10,
                                          p.DataType.int64())).to_pydict()
    assert _both(run) == {"a": [10, 20, None]}


# ------------------------------------------- DataFrame methods

def test_list_aggregations_on_frames(nparts):
    data = {"g": ["a", "b", "a", "b", "a"], "v": [3, 1, 3, None, 2],
            "s": ["x", "y", "z", "w", None]}

    def run(p):
        df = mkdf(p, data, nparts)
        whole = df.agg_list("v").to_pydict(), df.agg_set("v").to_pydict(), \
            df.agg_concat("s").to_pydict()
        g = df.groupby("g")
        grouped = [x.sort("g").to_pydict() for x in
                   (g.agg_list("v"), g.agg_set("v"), g.agg_concat("s"))]
        return ([sorted(w[k][0], key=str) for w, k in
                 zip(whole[:2], ("v", "v"))], sorted(whole[2]["s"][0]),
                [{k: [sorted(v, key=str) if isinstance(v, list)
                      else sorted(v) if isinstance(v, str) else v
                      for v in vs] for k, vs in d.items()}
                 for d in grouped])
    _both(run)


def test_drop_duplicates(nparts):
    def run(p):
        df = mkdf(p, {"a": [1, 1, 2, 2, None, None],
                      "b": ["x", "x", "y", "z", None, None]}, nparts)
        return (df.drop_duplicates().sort(["a", "b"]).to_pydict(),
                sorted(df.drop_duplicates("a").to_pydict()["a"],
                       key=lambda v: (v is None, v)))
    out = _both(run)
    assert len(out[0]["a"]) == 4


def test_columns_functions():
    data = {"a": [1, None, 3, None], "b": [4, 5, None, None],
            "c": [7.5, 8.0, 9.0, None]}

    def run(p):
        from importlib import import_module
        f = import_module(f"{p.__name__}.functions")
        df = p.from_pydict(data)
        return df.select(
            f.columns_sum("a", "b").alias("sum"),
            f.columns_mean("a", p.col("c")).alias("mean"),
            f.columns_avg("a", "b").alias("avg"),
            f.columns_min("a", "b", "c").alias("min"),
            f.columns_max(p.col("a"), "b").alias("max")).to_pydict()
    ref, port = (run(p) for p in PKGS)
    assert _close(port, ref)


# ------------------------------------------- expression namespaces

LISTS = {"l": [[3, 1, None, 2], None, [], [5, 5, 4], [None]],
         "f": [[1.5, 2.5], [0.1, 0.2, 0.4], None, [], [7.0]],
         "s": [["a", "b", None], ["c"], None, [], ["d", "d"]],
         "b": [[True, False], [True], None, [], [None, True]],
         "i": [0, 1, -1, 2, 5]}


@pytest.mark.parametrize("op", [
    "lengths", "count_valid", "count_all", "count_null", "join", "get0",
    "get_neg", "get_col", "get_default", "slice", "slice_col", "chunk",
    "sum", "mean", "min", "max", "bool_and", "bool_or", "sort",
    "sort_desc", "sort_nulls_first", "distinct", "value_counts",
])
def test_list_namespace(op):
    def expr(p):
        c = p.col
        return {
            "lengths": c("l").list.lengths(),
            "count_valid": c("l").list.count(),
            "count_all": c("l").list.count("all"),
            "count_null": c("l").list.count("null"),
            "join": c("s").list.join("-"),
            "get0": c("l").list.get(0),
            "get_neg": c("s").list.get(-1),
            "get_col": c("l").list.get(c("i")),
            "get_default": c("l").list.get(3, default=-9),
            "slice": c("l").list.slice(1, 3),
            "slice_col": c("s").list.slice(c("i")),
            "chunk": c("l").list.chunk(2),
            "sum": c("l").list.sum(),
            "mean": c("f").list.mean(),
            "min": c("s").list.min(),
            "max": c("l").list.max(),
            "bool_and": c("b").list.bool_and(),
            "bool_or": c("b").list.bool_or(),
            "sort": c("l").list.sort(),
            "sort_desc": c("s").list.sort(desc=True),
            "sort_nulls_first": c("l").list.sort(nulls_first=True),
            "distinct": c("l").list.distinct(),
            "value_counts": c("s").list.value_counts(),
        }[op].alias("out")
    ref, port = (p.from_pydict(LISTS).select(expr(p)).to_pydict()
                 for p in PKGS)
    assert _close(port, ref)


def test_struct_map_embedding_namespaces():
    emb = [[1.0, 0.0, 2.0], [0.5, 0.5, 0.5], [3.0, -1.0, 0.25]]

    def run(p):
        c, DT = p.col, p.DataType
        df = p.from_pydict({"x": [1, 2, None], "y": ["a", None, "c"]})
        st = df.select(p.struct(c("x"), c("y")).alias("st"))
        got = st.select(c("st").struct.get("y").alias("y"),
                        c("st").struct.get("x").alias("x")).to_pydict()
        m = p.from_pydict({"m": [[("k", 1), ("j", 2)], [("j", 3)], None]})
        m = m.select(c("m").cast(DT.map(DT.string(), DT.int64())))
        mg = m.select(c("m").map.get("j").alias("j")).to_pydict()
        e = p.from_pydict({"e": emb, "o": emb[::-1]}).select(
            c("e").cast(DT.embedding(DT.float64(), 3)),
            c("o").cast(DT.embedding(DT.float64(), 3)))
        cd = e.select(c("e").embedding.cosine_distance(c("o"))
                      .alias("d")).to_pydict()
        return got, mg, cd
    ref, port = (run(p) for p in PKGS)
    assert _close(port, ref)


@pytest.mark.parametrize("fn", ["days", "hours", "months", "years",
                                "bucket", "truncate_int", "truncate_str"])
def test_partitioning_namespace(fn):
    ts = [datetime.datetime(2021, 3, 4, 5, 6, 7),
          datetime.datetime(1969, 12, 31, 23, 0, 0), None]

    def run(p):
        c = p.col
        df = p.from_pydict({"t": ts, "i": [17, -3, 250],
                            "s": ["abcdef", "xy", None]})
        e = {"days": c("t").partitioning.days(),
             "hours": c("t").partitioning.hours(),
             "months": c("t").partitioning.months(),
             "years": c("t").partitioning.years(),
             "bucket": c("i").partitioning.iceberg_bucket(7),
             "truncate_int": c("i").partitioning.iceberg_truncate(10),
             "truncate_str": c("s").partitioning.iceberg_truncate(3)}[fn]
        return df.select(e.alias("out")).to_pydict()
    _both(run)


STR = {"s": ["Hello, World!  foo", None, "A.b;C  d\te", "", "2021-03-04",
             "x=1, y=22, z=333", "Ünïcode, Straße!"]}


@pytest.mark.parametrize("case", [
    "split", "split_regex", "extract", "extract_group", "extract_all",
    "length_bytes", "to_date", "to_datetime", "to_datetime_tz",
    "normalize_all", "normalize_punct", "normalize_nfd", "count_matches",
    "count_matches_words",
])
def test_str_functions(case):
    def run(p):
        s = p.col("s").str
        e = {"split": s.split(" "),
             "split_regex": s.split(r"[,\s]+", regex=True),
             "extract": s.extract(r"\d+"),
             "extract_group": s.extract(r"(\w)=(\d+)", 2),
             "extract_all": s.extract_all(r"\d+"),
             "length_bytes": s.length_bytes(),
             "to_date": s.to_date("%Y-%m-%d"),
             "to_datetime": s.to_datetime("%Y-%m-%d"),
             "to_datetime_tz": s.to_datetime("%Y-%m-%d", "UTC"),
             "normalize_all": s.normalize(True, True, True, True),
             "normalize_punct": s.normalize(remove_punct=True,
                                            white_space=True),
             "normalize_nfd": s.normalize(nfd_unicode=True, lowercase=True),
             "count_matches": s.count_matches(["o", "l"]),
             "count_matches_words": s.count_matches(
                 "foo", whole_words=True, case_sensitive=False)}[case]
        return p.from_pydict(STR).select(e.alias("out")).to_pydict()
    _both(run)


def test_hash_minhash_and_constructors():
    def run(p):
        c = p.col
        df = p.from_pydict({"s": ["a b c d", None, "a b c e", "x"],
                            "i": [1, 2, None, 4], "f": [1.5, None, 0.0, -2.0],
                            "b": [b"a", b"", None, b"zz"]})
        return df.select(
            c("s").hash().alias("hs"), c("i").hash().alias("hi"),
            c("f").hash().alias("hf"), c("b").hash().alias("hb"),
            c("s").hash(seed=c("i").hash()).alias("h2"),
            c("s").minhash(num_hashes=6, ngram_size=2, seed=9).alias("m"),
            p.list_(c("i"), c("i") * 2, p.lit(7)).alias("li"),
            p.struct(c("i"), c("s")).alias("st")).to_pydict()
    _both(run)


def test_hash_of_a_list_column_within_one_process():
    """A list column hashes ``repr(v)`` with Python's salted ``hash`` in
    both packages: equal within one process, not across processes."""
    def run(p):
        return p.from_pydict({"l": [[1, 2], None, [3]]}).select(
            p.col("l").hash()).to_pydict()
    _both(run)


# ------------------------------------------- SQL

SQL_DATA = {"s": ["a,b,c", "hello world", None, "x1y22"],
            "a": [3, 1, None, 7], "b": [2, 5, 4, None],
            "l": [[1, 1, 2], [3], None, []]}


@pytest.mark.parametrize("q", [
    "SELECT split(s, ',') AS o FROM t",
    r"SELECT regexp_extract(s, '\d+') AS o FROM t",
    r"SELECT regexp_extract_all(s, '\d+') AS o FROM t",
    "SELECT normalize(s) AS o FROM t",
    "SELECT count_matches(s, 'l') AS o FROM t",
    "SELECT to_date('2021-03-04') AS o FROM t",
    "SELECT greatest(a, b) AS o FROM t",
    "SELECT least(a, b) AS o FROM t",
    "SELECT hash(s) AS o FROM t",
    "SELECT list_value_counts(l) AS o FROM t",
])
def test_sql_functions(q):
    _both(lambda p: p.sql(q, t=p.from_pydict(SQL_DATA)).to_pydict())


@pytest.mark.parametrize("q", [
    r"SELECT regexp_extract(s, '^\S+') AS w, count(*) AS n FROM t "
    r"GROUP BY regexp_extract(s, '^\S+')",
    "SELECT hash(s) AS h, count(*) AS n FROM t GROUP BY hash(s)",
])
def test_sql_group_by_function(q):
    def run(p):
        out = p.sql(q, t=p.from_pydict({"s": ["a b", "a c", "b", None,
                                             "a b"] * 3})).to_pydict()
        k = list(out)[0]
        return sorted(zip(out[k], out["n"]), key=lambda r: (r[0] is None,
                                                            r[0]))
    _both(run)


# ------------------------------------------- the card phase, small

def test_near_dedup_pipeline_small():
    """Phase 7o's word count and MinHash near-dedup over 2,000 seeded
    comments through both packages: equal answers, and the port's equal
    to the phase's numpy and pyarrow oracles."""
    from daft_tpu_torch.benchmarking import expr_phase as ep
    comments, keys = ep.seeded_comments(2000, seed=7)
    data = {"o_orderkey": keys, "o_comment": comments}
    ref, port = (ep.run_pipelines(lambda p=p: mkdf(p, data, 3), p)
                 for p in PKGS)
    assert ep.same(ep.canonical(port), ep.canonical(ref))
    assert ep.canonical_words(port["words"]) == \
        ep.word_count_oracle(comments)
    oracle = ep.near_dedup_oracle(ep.signatures(comments), np.asarray(keys))
    assert ep.same(ep.canonical_dedup(port["dedup"]), oracle)
    assert len(oracle["groups"]) and len(oracle["pairs"])


def test_multimodal_layouts_and_casts():
    """The tensor, sparse-tensor, fixed-shape and embedding layouts of
    ``Series`` (``tests/test_datatypes.py::test_multimodal_cast_matrix``'s
    non-image half): the same physical arrays and rows in both
    packages."""
    def run(p):
        from importlib import import_module
        S = import_module(f"{p.__name__}.series").Series
        DT = p.DataType
        t = S.from_pylist([np.array([[0., 2.], [5., 0.]], np.float32),
                           None, np.arange(3, dtype=np.float32)], "t",
                          dtype=DT.tensor(DT.float32()))
        sp = t.cast(DT.sparse_tensor(DT.float32()))
        back = sp.cast(DT.tensor(DT.float32()))
        ft = S.from_pylist([np.arange(6).reshape(2, 3).astype(np.float32),
                            None], "ft", dtype=DT.tensor(DT.float32(), (2, 3)))
        emb = S.from_pylist([[1.0, 2.0, 3.0], None], "e",
                            dtype=DT.embedding(DT.float32(), 3))

        def rows(s):
            return [None if v is None else (v.shape, v.ravel().tolist())
                    for v in s.to_pylist()]
        return (t.is_pyobject(), t.to_arrow().to_pylist(), rows(t),
                sp.to_pylist(), rows(back),
                rows(ft.cast(DT.tensor(DT.float32()))),
                rows(emb.cast(DT.tensor(DT.float32()))),
                [None if v is None else v.tolist() for v in t.to_numpy()])
    out = _both(run)
    assert out[0] is False
    assert out[3][0] == {"values": [2.0, 5.0], "indices": [1, 2],
                         "shape": [2, 2]}


def test_explode_on_the_distributed_runner(tmp_path):
    """``Explode`` is row-local in the stage planner (``is_map_like``, the
    worker's row-local set): an explode, a group-by over the exploded
    rows and monotonic ids through the distributed runner on 2 workers
    give the native runner's answers, in both packages."""
    import importlib
    import pyarrow as pa
    import pyarrow.parquet as pq
    for i in range(3):
        pq.write_table(pa.table({
            "k": list(range(i * 10, i * 10 + 10)),
            "l": [[j % 4, j % 3] if j % 5 else None for j in range(10)]}),
            tmp_path / f"part{i}.parquet")

    def run(p):
        def query():
            df = p.read_parquet(str(tmp_path / "*.parquet")).explode("l")
            return df.groupby("l").agg(p.col("k").count().alias("n"),
                                       p.col("k").agg_list().alias("ks")) \
                .sort("l").to_pydict()
        native = query()
        ctx = importlib.import_module(f"{p.__name__}.context")
        DR = importlib.import_module(
            f"{p.__name__}.runners.distributed_runner").DistributedRunner
        c = ctx.get_context()
        old, runner = c._runner, DR(num_workers=2)
        c.set_runner(runner)
        try:
            dist = query()
        finally:
            c.set_runner(old)
            mgr = getattr(runner, "_manager", None)
            if mgr is not None:
                mgr.shutdown()
        for d in (native, dist):
            d["ks"] = [sorted(x) for x in d["ks"]]
        assert dist == native
        return native
    _both(run)


def test_explode_plans_fingerprint_and_run_through_the_scheduler(tmp_path):
    """A plan with ``Explode`` over files has a fingerprint (its exprs are
    plain values) that differs from the plan without it, and the serving
    scheduler runs it to the native runner's answer."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from daft_tpu_torch.logical.fingerprint import fingerprint
    from daft_tpu_torch.serving import QueryScheduler
    pq.write_table(pa.table({"k": [1, 2], "l": [[1, 2], [3]]}),
                   tmp_path / "t.parquet")
    df = daft_tpu_torch.read_parquet(str(tmp_path / "t.parquet"))
    ex = df.explode("l")
    fp, base = fingerprint(ex._builder._plan), fingerprint(df._builder._plan)
    assert fp is not None and base is not None
    assert fp.structure != base.structure
    sched = QueryScheduler(concurrency=1)
    try:
        got = sched.submit(ex).result(timeout=60).to_recordbatch() \
            .to_pydict()
    finally:
        sched.shutdown()
    assert got == ex.to_pydict() == {"k": [1, 1, 2], "l": [1, 2, 3]}

"""Plan-level parity of the port's optimizer with the reference's.

1. The 14 fixtures of ``tests/test_optimizer_join_rules.py`` (one per
   test there; the null-key side table's five join types are cases of
   one), built in both packages and run through each package's single
   rule: the same rewrite shape (a canonical post-order of every node)
   and the same root schema; where the reference fixture checks an
   answer or idempotence, the port's rewritten plan is held to it too.
2. ``stats.estimate`` and ``stats.column_ndv`` give the reference's
   values on the TPC-H fixture's sources (SF 0.003, 3 files per table).
3. For each of the 22 TPC-H queries, as DataFrame code and as SQL, the
   port's optimized plan has the reference's join tree: a post-order of
   (node type, how, left_on, right_on) over the join nodes. No cross
   join of the comma-join kind is left in either form: the only cross
   joins left pair rows with a one-row aggregate (an uncorrelated scalar
   subquery, Q11 and Q22), as in the reference's plan.
"""

import re

import pytest

import daft_tpu
from benchmarking.tpch import queries as RQ, sql_queries as RSQ
from benchmarking.tpch.datagen import generate_tpch

def _pkgs():
    import daft_tpu_torch
    return daft_tpu, daft_tpu_torch


def _opt(pkg):
    return __import__(f"{pkg.__name__}.logical.optimizer",
                      fromlist=["x"])


def _norm(s: str) -> str:
    """Names that embed a per-process counter or a content hash of a
    plan (its sources' object ids) differ between the packages."""
    s = re.sub(r"__sjr[0-9a-f]{8}_", "__sjr_", s)
    return re.sub(r"(__[a-z]+)\d+", r"\1#", s)


def _shape(plan):
    """Post-order of every node: type plus what decides its rows."""
    out = []

    def walk(n):
        for c in n.children:
            walk(c)
        nm = type(n).__name__
        if nm == "Join":
            out.append((nm, n.how, tuple(_norm(repr(e)) for e in n.left_on),
                        tuple(_norm(repr(e)) for e in n.right_on)))
        elif nm == "Filter":
            out.append((nm, _norm(repr(n.predicate))))
        elif nm == "Project":
            out.append((nm, tuple(_norm(repr(e)) for e in n.exprs)))
        elif nm == "Source":
            out.append((nm, tuple(n.schema().column_names),
                        _norm(repr(n.pushdowns.filters))))
        else:
            out.append((nm,))
    walk(plan)
    return out


def _schema(plan):
    return [(f.name, str(f.dtype)) for f in plan.schema()]


def _left(pkg):
    return pkg.from_pydict({"k": [1, 2, 3, None], "v": [10, 20, 30, 40]})


def _right(pkg):
    return pkg.from_pydict({"rk": [2, 3, None], "w": [7, 8, 9]})


def _lr(pkg, how):
    return _left(pkg).join(_right(pkg), left_on="k", right_on="rk",
                           how=how)


def _sjr(pkg):
    a = pkg.from_pydict({"k": [1, 2, 3], "v": [1, 2, 3]})
    s = pkg.from_pydict({"k": [i % 8 for i in range(64)],
                         "x": list(range(64))})
    return a.join(s.select("k").distinct(), left_on="k", right_on="k",
                  how="inner")


# (fixture, rule, program, small SemiJoinReduction thresholds,
#  rewritten answer to hold the port's plan to)
FIXTURES = [
    ("left_to_inner", "SimplifyNullFilteredJoin",
     lambda pkg: _lr(pkg, "left").where(pkg.col("w") > 0), False, None),
    ("outer_by_rejected_side", "SimplifyNullFilteredJoin",
     lambda pkg: _lr(pkg, "outer").where(pkg.col("w") > 0), False, None),
    ("preserved_side_keeps_left", "SimplifyNullFilteredJoin",
     lambda pkg: _lr(pkg, "left").where(pkg.col("v") > 0), False, None),
    ("null_safe_keeps_left", "SimplifyNullFilteredJoin",
     lambda pkg: _lr(pkg, "left").where(pkg.col("w").is_null()), False,
     None),
    ("null_key_side_table", "FilterNullJoinKey", None, False, None),
    ("null_key_idempotent", "FilterNullJoinKey",
     lambda pkg: _lr(pkg, "inner"), False, None),
    ("null_key_answer", "FilterNullJoinKey",
     lambda pkg: _lr(pkg, "inner"), False,
     [(2, 20, 2, 7), (3, 30, 3, 8)]),
    ("sjr_rewrites_distinct_side", "SemiJoinReduction", _sjr, True, None),
    ("sjr_respects_thresholds", "SemiJoinReduction", _sjr, False, None),
    ("sjr_preserves_answer", "SemiJoinReduction", _sjr, True,
     [(1, 1), (2, 2), (3, 3)]),
    ("key_predicate_left_to_right", "PushDownJoinPredicate",
     lambda pkg: _left(pkg).where(pkg.col("k") > 1).join(
         _right(pkg), left_on="k", right_on="rk", how="inner"),
     False, None),
    ("key_predicate_right_to_left", "PushDownJoinPredicate",
     lambda pkg: _left(pkg).join(_right(pkg).where(pkg.col("rk") >= 2),
                                 left_on="k", right_on="rk", how="semi"),
     False, None),
    ("non_key_predicate_stays", "PushDownJoinPredicate",
     lambda pkg: _left(pkg).where(pkg.col("v") > 15).join(
         _right(pkg), left_on="k", right_on="rk", how="inner"),
     False, None),
    ("key_predicate_idempotent", "PushDownJoinPredicate",
     lambda pkg: _left(pkg).where(pkg.col("k") > 1).join(
         _right(pkg), left_on="k", right_on="rk", how="inner"),
     False, [(2, 20, 2, 7), (3, 30, 3, 8)]),
]


def _rewrite(pkg, rule, program, small, monkeypatch):
    cls = getattr(_opt(pkg), rule)
    if small:
        monkeypatch.setattr(cls, "MIN_ROWS", 10)
        monkeypatch.setattr(cls, "RATIO", 1.5)
    before = program(pkg)._builder._plan
    after = cls().apply(before)
    assert _schema(after) == _schema(before), "root schema preserved"
    return before, after, cls


def _run_port_plan(plan):
    from daft_tpu_torch.execution.executor import LocalExecutor
    from daft_tpu_torch.physical.translate import translate
    rows = []
    for p in LocalExecutor().run(translate(plan)):
        d = p.to_pydict()
        rows.extend(zip(*d.values()))
    return sorted(rows)


@pytest.mark.parametrize("name,rule,program,small,answer", FIXTURES,
                         ids=[f[0] for f in FIXTURES])
def test_join_rule_fixture_rewrites_as_reference(name, rule, program, small,
                                                 answer, monkeypatch):
    ref, port = _pkgs()
    monkeypatch.setenv("DAFT_TORCH_DEVICE", "cpu")
    programs = [program] if program is not None else [
        (lambda pkg, how=how: _lr(pkg, how))
        for how in ("inner", "semi", "left", "right", "anti")]
    for prog in programs:
        rb, ra, _ = _rewrite(ref, rule, prog, small, monkeypatch)
        pb, pa_, cls = _rewrite(port, rule, prog, small, monkeypatch)
        assert _shape(pb) == _shape(rb)
        assert _shape(pa_) == _shape(ra), name
        assert _schema(pa_) == _schema(ra)
        if name.endswith("idempotent"):
            assert cls().apply(pa_).semantic_id() == pa_.semantic_id()
        if answer is not None:
            assert _run_port_plan(pa_) == sorted(answer)
    if name == "sjr_rewrites_distinct_side":
        assert any(type(j).__name__ == "Join" and j.how == "semi"
                   for j in _walk(pa_))
    if name == "sjr_respects_thresholds":
        assert pa_.semantic_id() == pb.semantic_id()


def _walk(plan):
    yield plan
    for c in plan.children:
        yield from _walk(c)


# ------------------------------------------------------------------ stats

@pytest.fixture(scope="module")
def tpch_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_torch_opt")
    generate_tpch(str(root), scale_factor=0.003, num_parts=3)
    return str(root)


_NDV_COLS = {"lineitem": ["l_orderkey", "l_partkey", "l_suppkey",
                          "l_shipdate", "l_quantity", "l_returnflag"],
             "orders": ["o_orderkey", "o_custkey", "o_orderdate"],
             "customer": ["c_custkey", "c_nationkey"],
             "part": ["p_partkey", "p_size"],
             "partsupp": ["ps_partkey", "ps_suppkey"],
             "supplier": ["s_suppkey", "s_nationkey"],
             "nation": ["n_nationkey", "n_regionkey"],
             "region": ["r_regionkey"]}


@pytest.mark.parametrize("table", sorted(_NDV_COLS))
def test_stats_match_reference(tpch_root, table):
    ref, port = _pkgs()
    from daft_tpu.logical import stats as rstats
    from daft_tpu_torch.logical import stats as pstats
    path = f"{tpch_root}/{table}/*.parquet"
    for mk in (lambda pkg: pkg.read_parquet(path),
               lambda pkg: pkg.read_parquet(path).where(
                   pkg.col(_NDV_COLS[table][0]) > 3)):
        rp = mk(ref)._builder.optimize().plan
        pp = mk(port)._builder.optimize().plan
        assert pstats.estimate(pp) == \
            pstats.Stats(*tuple(vars(rstats.estimate(rp)).values()))
        for c in _NDV_COLS[table]:
            want = rstats.column_ndv(rp, c)
            assert pstats.column_ndv(pp, c) == want, (table, c)
            assert pstats.column_ndv_footer(pp, c) == \
                rstats.column_ndv_footer(rp, c), (table, c)
    assert pstats.FILTER_SELECTIVITY == rstats.FILTER_SELECTIVITY
    assert pstats.EQ_FILTER_SELECTIVITY == rstats.EQ_FILTER_SELECTIVITY
    assert pstats.AGG_GROUP_FACTOR == rstats.AGG_GROUP_FACTOR


# -------------------------------------------------------------- join trees

def _join_tree(plan):
    out = []

    def walk(n):
        for c in n.children:
            walk(c)
        if type(n).__name__ == "Join":
            out.append(("Join", n.how,
                        tuple(_norm(repr(e)) for e in n.left_on),
                        tuple(_norm(repr(e)) for e in n.right_on)))
    walk(plan)
    return out


@pytest.mark.parametrize("form", ["dataframe", "sql"])
@pytest.mark.parametrize("q", list(range(1, 23)))
def test_join_tree_matches_reference(tpch_root, q, form):
    ref, port = _pkgs()
    from daft_tpu_torch.benchmarking import tpch_queries, tpch_sql
    rget = lambda t: ref.read_parquet(f"{tpch_root}/{t}/*.parquet")  # noqa
    pget = lambda t: port.read_parquet(f"{tpch_root}/{t}/*.parquet")  # noqa
    if form == "dataframe":
        rdf, pdf = RQ.ALL[q](rget), tpch_queries.ALL[q](pget)
    else:
        rdf, pdf = RSQ.run(q, rget), tpch_sql.run(q, pget)
    want = _join_tree(rdf._builder.optimize().plan)
    plan = pdf._builder.optimize().plan
    got = _join_tree(plan)
    assert got == want
    from daft_tpu_torch.logical.optimizer import unconverted_cross_joins
    assert unconverted_cross_joins(plan) == 0, got

"""Parity of the port's expression compiler with the reference's.

The reference encodes a seeded lineitem-shaped batch and compiles each
expression list with ``daft_tpu.device.compiler.compile_projection``; its
encoded planes (numpy) enter the port through ``from_reference_planes``,
so both packages evaluate the same expressions on identical inputs. Values
and validity must match exactly: every operation here is the same IEEE
operation in the same order on both sides.
"""

import datetime

import numpy as np
import pytest

import daft_tpu
from daft_tpu.device import column as ref_col
from daft_tpu.device import compiler as ref_compiler
from daft_tpu.device import runtime as ref_runtime


def _exprs(pkg, which):
    col, lit = pkg.col, pkg.lit
    disc = col("l_extendedprice") * (1 - col("l_discount"))
    if which == "q1":
        return [col("l_returnflag"), col("l_linestatus"),
                col("l_quantity"), col("l_extendedprice"), disc,
                disc * (1 + col("l_tax")), col("l_discount"),
                col("l_shipdate") <= lit(datetime.date(1998, 9, 2))]
    if which == "q6":
        return [(col("l_shipdate") >= lit(datetime.date(1994, 1, 1)))
                & (col("l_shipdate") < lit(datetime.date(1995, 1, 1)))
                & col("l_discount").between(0.05, 0.07)
                & (col("l_quantity") < 24),
                col("l_extendedprice") * col("l_discount")]
    # strings against the sorted dictionary, is_in, if_else, date parts,
    # integer arithmetic and null logic
    return [col("l_returnflag") == "R", col("l_returnflag") < "N",
            lit("F") <= col("l_linestatus"), col("l_returnflag") != "Z",
            col("l_returnflag").is_in(["A", "R"]),
            col("l_quantity").is_in([1.0, 2.0, 3.0]),
            (col("l_quantity") > 25).if_else(col("l_tax"),
                                             col("l_discount")),
            col("l_shipdate").dt.year(), col("l_shipdate").dt.month(),
            col("l_shipdate").dt.day(), col("l_shipdate").dt.day_of_week(),
            col("l_linenumber") * 3 + 7, col("l_linenumber") // 2,
            col("l_linenumber") % 3, col("l_quantity") / col("l_linenumber"),
            (col("l_tax") > 0.04) | col("l_discount").is_null(),
            ~(col("l_tax") > 0.04), col("l_tax").fill_null(0.5),
            col("l_quantity").abs() - col("l_tax")]


def _batch(seed=0, n=700):
    rng = np.random.default_rng(seed)
    null = lambda: rng.random(n) < 0.05  # noqa: E731

    def with_nulls(vals):
        m = null()
        return [None if m[i] else v for i, v in enumerate(vals)]
    days = rng.integers(8036, 10561, n)
    return {
        "l_quantity": with_nulls(rng.integers(1, 51, n).astype(float)
                                 .tolist()),
        "l_extendedprice": with_nulls(np.round(rng.uniform(900, 105000, n),
                                               2).tolist()),
        "l_discount": with_nulls(np.round(rng.integers(0, 11, n) / 100.0,
                                          2).tolist()),
        "l_tax": with_nulls(np.round(rng.integers(0, 9, n) / 100.0,
                                     2).tolist()),
        "l_linenumber": with_nulls(rng.integers(1, 8, n).tolist()),
        "l_returnflag": with_nulls(rng.choice(["A", "N", "R"], n).tolist()),
        "l_linestatus": with_nulls(rng.choice(["F", "O"], n).tolist()),
        "l_shipdate": with_nulls([datetime.date(1970, 1, 1)
                                  + datetime.timedelta(days=int(d))
                                  for d in days]),
    }


@pytest.mark.parametrize("which", ["q1", "q6", "mixed"])
def test_compile_projection_matches_reference(which):
    import torch
    import daft_tpu_torch
    from daft_tpu_torch.device import column as dcol, compiler, runtime
    data = _batch(["q1", "q6", "mixed"].index(which))
    rb = daft_tpu.from_pydict(data).to_arrow()
    ref_rb = daft_tpu.RecordBatch.from_arrow_table(rb)
    schema = ref_rb.schema
    rc = ref_compiler.compile_projection(_exprs(daft_tpu, which), schema,
                                         jit=False)
    dt = ref_col.encode_batch(ref_rb, rc.needs_cols)
    scalars = ref_runtime._prep_scalars(rc, dt)
    arrays = {k: c.data for k, c in dt.columns.items()}
    valids = {k: c.validity for k, c in dt.columns.items()}
    ref_out = rc.fn(arrays, valids, dt.row_mask, scalars)

    port_rb = daft_tpu_torch.RecordBatch.from_arrow_table(rb)
    pc = compiler.compile_projection(_exprs(daft_tpu_torch, which),
                                     port_rb.schema)
    assert pc.needs_cols == rc.needs_cols
    pdt = dcol.from_reference_planes(
        {k: np.asarray(c.data) for k, c in dt.columns.items()},
        {k: np.asarray(c.validity) for k, c in dt.columns.items()},
        np.asarray(dt.row_mask), torch.device("cpu"),
        dictionaries={k: c.dictionary for k, c in dt.columns.items()})
    p_scalars = runtime._prep_scalars(pc, pdt)
    p_out = pc.fn({k: c.data for k, c in pdt.columns.items()},
                  {k: c.validity for k, c in pdt.columns.items()},
                  pdt.row_mask, p_scalars)
    assert len(p_out) == len(ref_out)
    n = len(ref_rb)
    for i, ((pv, pm), (rv, rm)) in enumerate(zip(p_out, ref_out)):
        pm, rm = pm.numpy()[:n], np.asarray(rm)[:n]
        np.testing.assert_array_equal(pm, rm, err_msg=f"validity {i}")
        pv, rv = pv.numpy()[:n][rm], np.asarray(rv)[:n][rm]
        if rv.dtype.kind == "f":
            np.testing.assert_array_equal(pv.astype(rv.dtype), rv,
                                          err_msg=f"value {i}")
        else:
            np.testing.assert_array_equal(pv.astype(np.int64),
                                          rv.astype(np.int64),
                                          err_msg=f"value {i}")


def test_uncompilable_expression_raises_not_compilable():
    import daft_tpu_torch
    from daft_tpu_torch.device import compiler
    rb = daft_tpu_torch.RecordBatch.from_pydict(
        {"d": [datetime.date(1994, 1, 1), datetime.date(1995, 6, 30)]})
    with pytest.raises(compiler.NotCompilable):
        compiler.compile_projection(
            [daft_tpu_torch.col("d").dt.strftime()], rb.schema)

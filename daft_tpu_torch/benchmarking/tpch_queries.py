"""The TPC-H queries of the grouped-aggregation and equi-join slices,
written against daft_tpu_torch: Q1, Q3 and Q6 as in
``benchmarking/tpch/queries.py``, plus the two hash-keyed group-bys over
``lineitem`` that exercise the hash strategy with 2-word (int64
``l_suppkey``) and 1-word (date ``l_shipdate``) keys.
"""

from __future__ import annotations

import datetime
from typing import Callable

from .. import DataFrame, col, lit

GetDF = Callable[[str], DataFrame]


def q1(get_df: GetDF) -> DataFrame:
    li = get_df("lineitem")
    disc_price = col("l_extendedprice") * (1 - col("l_discount"))
    charge = disc_price * (1 + col("l_tax"))
    return (li.where(col("l_shipdate") <= lit(datetime.date(1998, 9, 2)))
            .groupby("l_returnflag", "l_linestatus")
            .agg(col("l_quantity").sum().alias("sum_qty"),
                 col("l_extendedprice").sum().alias("sum_base_price"),
                 disc_price.sum().alias("sum_disc_price"),
                 charge.sum().alias("sum_charge"),
                 col("l_quantity").mean().alias("avg_qty"),
                 col("l_extendedprice").mean().alias("avg_price"),
                 col("l_discount").mean().alias("avg_disc"),
                 col("l_quantity").count().alias("count_order"))
            .sort(["l_returnflag", "l_linestatus"]))


def q3(get_df: GetDF) -> DataFrame:
    cust = get_df("customer").where(col("c_mktsegment") == "BUILDING")
    orders = get_df("orders").where(
        col("o_orderdate") < lit(datetime.date(1995, 3, 15)))
    li = get_df("lineitem").where(
        col("l_shipdate") > lit(datetime.date(1995, 3, 15)))
    return (cust.join(orders, left_on="c_custkey", right_on="o_custkey")
            .join(li, left_on="o_orderkey", right_on="l_orderkey")
            .with_column("volume",
                         col("l_extendedprice") * (1 - col("l_discount")))
            .groupby(col("o_orderkey"), col("o_orderdate"),
                     col("o_shippriority"))
            .agg(col("volume").sum().alias("revenue"))
            .sort([col("revenue"), col("o_orderdate")], desc=[True, False])
            .limit(10)
            .select("o_orderkey", "revenue", "o_orderdate", "o_shippriority"))


def q6(get_df: GetDF) -> DataFrame:
    li = get_df("lineitem")
    return (li.where((col("l_shipdate") >= lit(datetime.date(1994, 1, 1)))
                     & (col("l_shipdate") < lit(datetime.date(1995, 1, 1)))
                     & col("l_discount").between(0.05, 0.07)
                     & (col("l_quantity") < 24))
            .agg((col("l_extendedprice") * col("l_discount")).sum()
                 .alias("revenue")))


def suppkey_agg(get_df: GetDF) -> DataFrame:
    """int64-keyed group-by (2-word hash keys): one group per supplier."""
    return (get_df("lineitem").groupby("l_suppkey")
            .agg(col("l_quantity").sum().alias("sum_qty"),
                 col("l_extendedprice").mean().alias("avg_price"),
                 col("l_discount").count().alias("n"),
                 col("l_quantity").min().alias("min_qty"),
                 col("l_extendedprice").max().alias("max_price"),
                 col("l_discount").any_value().alias("any_disc"),
                 col("l_extendedprice").stddev().alias("std_price"))
            .sort("l_suppkey"))


def shipdate_agg(get_df: GetDF) -> DataFrame:
    """date-keyed group-by (1-word hash keys): one group per ship day."""
    return (get_df("lineitem").groupby("l_shipdate")
            .agg(col("l_quantity").sum().alias("sum_qty"),
                 col("l_extendedprice").sum().alias("sum_price"),
                 col("l_discount").mean().alias("avg_disc"),
                 col("l_quantity").count().alias("n"),
                 col("l_discount").max().alias("max_disc"))
            .sort("l_shipdate"))


QUERIES = {"q1": q1, "q3": q3, "q6": q6, "suppkey_agg": suppkey_agg,
           "shipdate_agg": shipdate_agg}

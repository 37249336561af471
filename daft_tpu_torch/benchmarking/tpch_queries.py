"""TPC-H Q1–Q22 written against daft_tpu_torch as in
``benchmarking/tpch/queries.py`` (the 22 standard queries, which are public
specification; column names lowercase as the in-repo generator writes
them), plus two hash-keyed group-bys over ``lineitem`` that exercise the
hash strategy with 2-word (int64 ``l_suppkey``) and 1-word (date
``l_shipdate``) keys.
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


def q2(get_df: GetDF) -> DataFrame:
    region = get_df("region").where(col("r_name") == "EUROPE")
    nation = get_df("nation")
    supplier = get_df("supplier")
    partsupp = get_df("partsupp")
    part = get_df("part").where((col("p_size") == 15)
                                & col("p_type").str.endswith("BRASS"))
    europe = (region
              .join(nation, left_on="r_regionkey", right_on="n_regionkey")
              .join(supplier, left_on="n_nationkey", right_on="s_nationkey")
              .join(partsupp, left_on="s_suppkey", right_on="ps_suppkey"))
    brass = part.join(europe, left_on="p_partkey", right_on="ps_partkey")
    min_cost = brass.groupby("p_partkey").agg(
        col("ps_supplycost").min().alias("min_cost"))
    return (brass.join(min_cost, on="p_partkey")
            .where(col("ps_supplycost") == col("min_cost"))
            .select("s_acctbal", "s_name", "n_name", "p_partkey", "p_mfgr",
                    "s_address", "s_phone", "s_comment")
            .sort(["s_acctbal", "n_name", "s_name", "p_partkey"],
                  desc=[True, False, False, False])
            .limit(100))


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


def q4(get_df: GetDF) -> DataFrame:
    orders = get_df("orders").where(
        (col("o_orderdate") >= lit(datetime.date(1993, 7, 1)))
        & (col("o_orderdate") < lit(datetime.date(1993, 10, 1))))
    late = get_df("lineitem").where(col("l_commitdate") < col("l_receiptdate"))
    return (orders.join(late, left_on="o_orderkey", right_on="l_orderkey",
                        how="semi")
            .groupby("o_orderpriority")
            .agg(col("o_orderkey").count().alias("order_count"))
            .sort("o_orderpriority"))


def q5(get_df: GetDF) -> DataFrame:
    region = get_df("region").where(col("r_name") == "ASIA")
    orders = get_df("orders").where(
        (col("o_orderdate") >= lit(datetime.date(1994, 1, 1)))
        & (col("o_orderdate") < lit(datetime.date(1995, 1, 1))))
    out = (region
           .join(get_df("nation"), left_on="r_regionkey", right_on="n_regionkey")
           .join(get_df("supplier"), left_on="n_nationkey", right_on="s_nationkey")
           .join(get_df("lineitem"), left_on="s_suppkey", right_on="l_suppkey")
           .join(orders, left_on="l_orderkey", right_on="o_orderkey")
           .join(get_df("customer"), left_on=["o_custkey", "s_nationkey"],
                 right_on=["c_custkey", "c_nationkey"]))
    return (out.with_column("volume",
                            col("l_extendedprice") * (1 - col("l_discount")))
            .groupby("n_name")
            .agg(col("volume").sum().alias("revenue"))
            .sort("revenue", desc=True))


def q6(get_df: GetDF) -> DataFrame:
    li = get_df("lineitem")
    return (li.where((col("l_shipdate") >= lit(datetime.date(1994, 1, 1)))
                     & (col("l_shipdate") < lit(datetime.date(1995, 1, 1)))
                     & col("l_discount").between(0.05, 0.07)
                     & (col("l_quantity") < 24))
            .agg((col("l_extendedprice") * col("l_discount")).sum()
                 .alias("revenue")))


def q7(get_df: GetDF) -> DataFrame:
    n1 = get_df("nation").select(col("n_nationkey").alias("supp_nationkey"),
                                 col("n_name").alias("supp_nation"))
    n2 = get_df("nation").select(col("n_nationkey").alias("cust_nationkey"),
                                 col("n_name").alias("cust_nation"))
    li = get_df("lineitem").where(
        (col("l_shipdate") >= lit(datetime.date(1995, 1, 1)))
        & (col("l_shipdate") <= lit(datetime.date(1996, 12, 31))))
    out = (li
           .join(get_df("supplier"), left_on="l_suppkey", right_on="s_suppkey")
           .join(get_df("orders"), left_on="l_orderkey", right_on="o_orderkey")
           .join(get_df("customer"), left_on="o_custkey", right_on="c_custkey")
           .join(n1, left_on="s_nationkey", right_on="supp_nationkey")
           .join(n2, left_on="c_nationkey", right_on="cust_nationkey")
           .where(((col("supp_nation") == "FRANCE")
                   & (col("cust_nation") == "GERMANY"))
                  | ((col("supp_nation") == "GERMANY")
                     & (col("cust_nation") == "FRANCE"))))
    return (out.with_column("l_year", col("l_shipdate").dt.year())
            .with_column("volume",
                         col("l_extendedprice") * (1 - col("l_discount")))
            .groupby("supp_nation", "cust_nation", "l_year")
            .agg(col("volume").sum().alias("revenue"))
            .sort(["supp_nation", "cust_nation", "l_year"]))


def q8(get_df: GetDF) -> DataFrame:
    region = get_df("region").where(col("r_name") == "AMERICA")
    part = get_df("part").where(col("p_type") == "ECONOMY ANODIZED STEEL")
    orders = get_df("orders").where(
        (col("o_orderdate") >= lit(datetime.date(1995, 1, 1)))
        & (col("o_orderdate") <= lit(datetime.date(1996, 12, 31))))
    n2 = get_df("nation").select(col("n_nationkey").alias("supp_nationkey"),
                                 col("n_name").alias("supp_nation"))
    out = (part
           .join(get_df("lineitem"), left_on="p_partkey", right_on="l_partkey")
           .join(orders, left_on="l_orderkey", right_on="o_orderkey")
           .join(get_df("customer"), left_on="o_custkey", right_on="c_custkey")
           .join(get_df("nation"), left_on="c_nationkey", right_on="n_nationkey")
           .join(region, left_on="n_regionkey", right_on="r_regionkey")
           .join(get_df("supplier"), left_on="l_suppkey", right_on="s_suppkey")
           .join(n2, left_on="s_nationkey", right_on="supp_nationkey"))
    out = (out.with_column("o_year", col("o_orderdate").dt.year())
           .with_column("volume",
                        col("l_extendedprice") * (1 - col("l_discount")))
           .with_column("brazil_volume",
                        (col("supp_nation") == "BRAZIL")
                        .if_else(col("volume"), 0.0)))
    return (out.groupby("o_year")
            .agg(col("brazil_volume").sum().alias("brazil"),
                 col("volume").sum().alias("total"))
            .select(col("o_year"),
                    (col("brazil") / col("total")).alias("mkt_share"))
            .sort("o_year"))


def q9(get_df: GetDF) -> DataFrame:
    part = get_df("part").where(col("p_name").str.contains("green"))
    out = (part
           .join(get_df("partsupp"), left_on="p_partkey", right_on="ps_partkey")
           .join(get_df("lineitem"),
                 left_on=["p_partkey", "ps_suppkey"],
                 right_on=["l_partkey", "l_suppkey"])
           .join(get_df("supplier"), left_on="ps_suppkey", right_on="s_suppkey")
           .join(get_df("orders"), left_on="l_orderkey", right_on="o_orderkey")
           .join(get_df("nation"), left_on="s_nationkey", right_on="n_nationkey"))
    amount = (col("l_extendedprice") * (1 - col("l_discount"))
              - col("ps_supplycost") * col("l_quantity"))
    return (out.with_column("o_year", col("o_orderdate").dt.year())
            .with_column("amount", amount)
            .groupby(col("n_name").alias("nation"), col("o_year"))
            .agg(col("amount").sum().alias("sum_profit"))
            .sort(["nation", "o_year"], desc=[False, True]))


def q10(get_df: GetDF) -> DataFrame:
    orders = get_df("orders").where(
        (col("o_orderdate") >= lit(datetime.date(1993, 10, 1)))
        & (col("o_orderdate") < lit(datetime.date(1994, 1, 1))))
    li = get_df("lineitem").where(col("l_returnflag") == "R")
    out = (get_df("customer")
           .join(orders, left_on="c_custkey", right_on="o_custkey")
           .join(li, left_on="o_orderkey", right_on="l_orderkey")
           .join(get_df("nation"), left_on="c_nationkey", right_on="n_nationkey"))
    return (out.with_column("volume",
                            col("l_extendedprice") * (1 - col("l_discount")))
            .groupby("c_custkey", "c_name", "c_acctbal", "c_phone", "n_name",
                     "c_address", "c_comment")
            .agg(col("volume").sum().alias("revenue"))
            .sort([col("revenue"), col("c_custkey")], desc=[True, False])
            .limit(20)
            .select("c_custkey", "c_name", "revenue", "c_acctbal", "n_name",
                    "c_address", "c_phone", "c_comment"))


def q11(get_df: GetDF) -> DataFrame:
    germany = (get_df("nation").where(col("n_name") == "GERMANY")
               .join(get_df("supplier"), left_on="n_nationkey",
                     right_on="s_nationkey")
               .join(get_df("partsupp"), left_on="s_suppkey",
                     right_on="ps_suppkey"))
    germany = germany.with_column(
        "value", col("ps_supplycost") * col("ps_availqty"))
    total = germany.agg((col("value").sum() * 0.0001).alias("threshold"))
    by_part = germany.groupby("ps_partkey").agg(
        col("value").sum().alias("part_value"))
    return (by_part.join(total, how="cross")
            .where(col("part_value") > col("threshold"))
            .select(col("ps_partkey"), col("part_value").alias("value"))
            .sort("value", desc=True))


def q12(get_df: GetDF) -> DataFrame:
    li = get_df("lineitem").where(
        col("l_shipmode").is_in(["MAIL", "SHIP"])
        & (col("l_commitdate") < col("l_receiptdate"))
        & (col("l_shipdate") < col("l_commitdate"))
        & (col("l_receiptdate") >= lit(datetime.date(1994, 1, 1)))
        & (col("l_receiptdate") < lit(datetime.date(1995, 1, 1))))
    out = get_df("orders").join(li, left_on="o_orderkey",
                                right_on="l_orderkey")
    is_high = col("o_orderpriority").is_in(["1-URGENT", "2-HIGH"])
    return (out
            .with_column("high", is_high.if_else(1, 0))
            .with_column("low", is_high.if_else(0, 1))
            .groupby("l_shipmode")
            .agg(col("high").sum().alias("high_line_count"),
                 col("low").sum().alias("low_line_count"))
            .sort("l_shipmode"))


def q13(get_df: GetDF) -> DataFrame:
    orders = get_df("orders").where(
        ~col("o_comment").str.match(".*special.*requests.*"))
    counts = (get_df("customer")
              .join(orders, left_on="c_custkey", right_on="o_custkey",
                    how="left")
              .groupby("c_custkey")
              .agg(col("o_orderkey").count().alias("c_count")))
    return (counts.groupby("c_count")
            .agg(col("c_custkey").count().alias("custdist"))
            .sort(["custdist", "c_count"], desc=[True, True]))


def q14(get_df: GetDF) -> DataFrame:
    li = get_df("lineitem").where(
        (col("l_shipdate") >= lit(datetime.date(1995, 9, 1)))
        & (col("l_shipdate") < lit(datetime.date(1995, 10, 1))))
    out = li.join(get_df("part"), left_on="l_partkey", right_on="p_partkey")
    vol = col("l_extendedprice") * (1 - col("l_discount"))
    promo = col("p_type").str.startswith("PROMO")
    return (out.with_column("volume", vol)
            .with_column("promo_volume", promo.if_else(col("volume"), 0.0))
            .agg(col("promo_volume").sum().alias("promo"),
                 col("volume").sum().alias("total"))
            .select((100.0 * col("promo") / col("total"))
                    .alias("promo_revenue")))


def q15(get_df: GetDF) -> DataFrame:
    li = get_df("lineitem").where(
        (col("l_shipdate") >= lit(datetime.date(1996, 1, 1)))
        & (col("l_shipdate") < lit(datetime.date(1996, 4, 1))))
    revenue = (li.with_column("v", col("l_extendedprice") * (1 - col("l_discount")))
               .groupby(col("l_suppkey").alias("supplier_no"))
               .agg(col("v").sum().alias("total_revenue")))
    top = revenue.agg(col("total_revenue").max().alias("max_revenue"))
    return (revenue.join(top, how="cross")
            .where(col("total_revenue") == col("max_revenue"))
            .join(get_df("supplier"), left_on="supplier_no",
                  right_on="s_suppkey")
            .select(col("supplier_no").alias("s_suppkey"),
                    "s_name", "s_address", "s_phone", "total_revenue")
            .sort("s_suppkey"))


def q16(get_df: GetDF) -> DataFrame:
    part = get_df("part").where(
        (col("p_brand") != "Brand#45")
        & ~col("p_type").str.startswith("MEDIUM POLISHED")
        & col("p_size").is_in([49, 14, 23, 45, 19, 3, 36, 9]))
    bad_supp = get_df("supplier").where(
        col("s_comment").str.match(".*Customer.*Complaints.*"))
    ps = (get_df("partsupp")
          .join(bad_supp, left_on="ps_suppkey", right_on="s_suppkey",
                how="anti"))
    return (part.join(ps, left_on="p_partkey", right_on="ps_partkey")
            .groupby("p_brand", "p_type", "p_size")
            .agg(col("ps_suppkey").count_distinct().alias("supplier_cnt"))
            .sort([col("supplier_cnt"), col("p_brand"), col("p_type"),
                   col("p_size")], desc=[True, False, False, False]))


def q17(get_df: GetDF) -> DataFrame:
    part = get_df("part").where((col("p_brand") == "Brand#23")
                                & (col("p_container") == "MED BOX"))
    li = get_df("lineitem")
    joined = part.join(li, left_on="p_partkey", right_on="l_partkey")
    avg_qty = (joined.groupby("p_partkey")
               .agg((col("l_quantity").mean() * 0.2).alias("avg_qty_threshold")))
    return (joined.join(avg_qty, on="p_partkey")
            .where(col("l_quantity") < col("avg_qty_threshold"))
            .agg((col("l_extendedprice").sum() / 7.0).alias("avg_yearly")))


def q18(get_df: GetDF) -> DataFrame:
    big = (get_df("lineitem").groupby("l_orderkey")
           .agg(col("l_quantity").sum().alias("sum_qty"))
           .where(col("sum_qty") > 300))
    return (get_df("orders")
            .join(big, left_on="o_orderkey", right_on="l_orderkey")
            .join(get_df("customer"), left_on="o_custkey", right_on="c_custkey")
            .select("c_name", "o_custkey", "o_orderkey", "o_orderdate",
                    "o_totalprice", col("sum_qty").alias("total_quantity"))
            .sort([col("o_totalprice"), col("o_orderdate")],
                  desc=[True, False])
            .limit(100))


def q19(get_df: GetDF) -> DataFrame:
    out = get_df("lineitem").join(get_df("part"), left_on="l_partkey",
                                  right_on="p_partkey")
    common = (col("l_shipinstruct") == "DELIVER IN PERSON") \
        & col("l_shipmode").is_in(["AIR", "AIR REG"])
    b1 = ((col("p_brand") == "Brand#12")
          & col("p_container").is_in(["SM CASE", "SM BOX", "SM PACK", "SM PKG"])
          & (col("l_quantity") >= 1) & (col("l_quantity") <= 11)
          & col("p_size").between(1, 5))
    b2 = ((col("p_brand") == "Brand#23")
          & col("p_container").is_in(["MED BAG", "MED BOX", "MED PKG", "MED PACK"])
          & (col("l_quantity") >= 10) & (col("l_quantity") <= 20)
          & col("p_size").between(1, 10))
    b3 = ((col("p_brand") == "Brand#34")
          & col("p_container").is_in(["LG CASE", "LG BOX", "LG PACK", "LG PKG"])
          & (col("l_quantity") >= 20) & (col("l_quantity") <= 30)
          & col("p_size").between(1, 15))
    return (out.where(common & (b1 | b2 | b3))
            .agg((col("l_extendedprice") * (1 - col("l_discount"))).sum()
                 .alias("revenue")))


def q20(get_df: GetDF) -> DataFrame:
    forest_parts = get_df("part").where(
        col("p_name").str.startswith("forest")).select("p_partkey")
    shipped = (get_df("lineitem").where(
        (col("l_shipdate") >= lit(datetime.date(1994, 1, 1)))
        & (col("l_shipdate") < lit(datetime.date(1995, 1, 1))))
        .groupby("l_partkey", "l_suppkey")
        .agg((col("l_quantity").sum() * 0.5).alias("half_qty")))
    eligible_ps = (get_df("partsupp")
                   .join(forest_parts, left_on="ps_partkey",
                         right_on="p_partkey", how="semi")
                   .join(shipped, left_on=["ps_partkey", "ps_suppkey"],
                         right_on=["l_partkey", "l_suppkey"])
                   .where(col("ps_availqty") > col("half_qty")))
    canada = (get_df("supplier")
              .join(get_df("nation").where(col("n_name") == "CANADA"),
                    left_on="s_nationkey", right_on="n_nationkey"))
    return (canada.join(eligible_ps, left_on="s_suppkey",
                        right_on="ps_suppkey", how="semi")
            .select("s_name", "s_address")
            .sort("s_name"))


def q21(get_df: GetDF) -> DataFrame:
    saudi_supp = (get_df("supplier")
                  .join(get_df("nation").where(col("n_name") == "SAUDI ARABIA"),
                        left_on="s_nationkey", right_on="n_nationkey"))
    li = get_df("lineitem")
    l1 = li.where(col("l_receiptdate") > col("l_commitdate"))
    failed_orders = get_df("orders").where(col("o_orderstatus") == "F")
    base = (l1.join(failed_orders, left_on="l_orderkey",
                    right_on="o_orderkey", how="semi")
            .join(saudi_supp, left_on="l_suppkey", right_on="s_suppkey"))
    # exists: another supplier on the same order
    others = (li.select(col("l_orderkey").alias("o2_orderkey"),
                        col("l_suppkey").alias("o2_suppkey"))
              .distinct())
    multi = (base.join(others, left_on="l_orderkey", right_on="o2_orderkey")
             .where(col("o2_suppkey") != col("l_suppkey"))
             .select("l_orderkey", "l_suppkey").distinct())
    base_keys = base.select("l_orderkey", "l_suppkey", "s_name").distinct()
    with_exists = base_keys.join(multi, on=["l_orderkey", "l_suppkey"],
                                 how="semi")
    # not exists: another supplier who ALSO missed the deadline on the order
    late_others = (l1.select(col("l_orderkey").alias("lo_orderkey"),
                             col("l_suppkey").alias("lo_suppkey"))
                   .distinct())
    pairs = (with_exists.join(late_others, left_on="l_orderkey",
                              right_on="lo_orderkey")
             .where(col("lo_suppkey") != col("l_suppkey"))
             .select("l_orderkey", "l_suppkey").distinct())
    final = with_exists.join(pairs, on=["l_orderkey", "l_suppkey"], how="anti")
    return (final.groupby("s_name")
            .agg(col("l_orderkey").count().alias("numwait"))
            .sort([col("numwait"), col("s_name")], desc=[True, False])
            .limit(100))


def q22(get_df: GetDF) -> DataFrame:
    codes = ["13", "31", "23", "29", "30", "18", "17"]
    cust = (get_df("customer")
            .with_column("cntrycode", col("c_phone").str.left(2))
            .where(col("cntrycode").is_in(codes)))
    avg_bal = (cust.where(col("c_acctbal") > 0.0)
               .agg(col("c_acctbal").mean().alias("avg_acctbal")))
    no_orders = cust.join(get_df("orders"), left_on="c_custkey",
                          right_on="o_custkey", how="anti")
    return (no_orders.join(avg_bal, how="cross")
            .where(col("c_acctbal") > col("avg_acctbal"))
            .groupby("cntrycode")
            .agg(col("c_acctbal").count().alias("numcust"),
                 col("c_acctbal").sum().alias("totacctbal"))
            .sort("cntrycode"))


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

ALL = {i: fn for i, fn in enumerate(
    [q1, q2, q3, q4, q5, q6, q7, q8, q9, q10, q11, q12, q13, q14, q15, q16,
     q17, q18, q19, q20, q21, q22], start=1)}

"""The 99 TPC-DS queries as SQL text, run through ``daft_tpu_torch.sql``.

The port's own copy of the texts of ``benchmarking/tpcds/queries.py`` and
``queries_remaining.py``: the clause structure follows the public TPC-DS
specification, and the literal vocabularies (years 1999-2001, names,
``d_month_seq`` from 1200) match the in-repo generator
(``benchmarking/tpcds/datagen.py``), so every query returns rows. Fifteen
queries use windows (``OVER``): 12, 20, 36, 44, 47, 49, 51, 53, 57, 63, 67,
70, 86, 89, 98.

``run(q, get_df)`` binds only the tables a query names; ``both_tiers(q,
get_df)`` runs a query on the device tier and then on the host tier
(``device="0"``) and returns both answers, both walls and the device run's
counters (its fusion-region counters: :func:`region_counters`).
"""

from __future__ import annotations

import re
from typing import Callable, Dict

from .. import DataFrame

GetDF = Callable[[str], DataFrame]

TABLES = ("store_sales", "store_returns", "item", "date_dim", "store",
          "customer", "customer_address", "customer_demographics",
          "promotion", "household_demographics", "time_dim", "reason",
          "income_band", "warehouse", "call_center", "catalog_page",
          "ship_mode", "catalog_sales", "catalog_returns", "web_site",
          "web_page", "web_sales", "web_returns", "inventory")

#: the queries that hold window functions
WINDOW_QUERIES = (12, 20, 36, 44, 47, 49, 51, 53, 57, 63, 67, 70, 86, 89, 98)

#: the rank windows whose order values are float sums: ``{query: (rank
#: column, partition columns, order columns)}``. Summed in another order
#: (the card's atomics), tied sums may differ in their last bits and rank
#: apart where the host ranks them as one tie; ``chip_smoke.py`` holds
#: such a rank to within the tie's size in its partition, and every other
#: column exactly. Q67: three rollup levels of one product sum the same
#: rows.
RANK_TIES = {67: ("rk", ("i_category",), ("sumsales",))}

#: the queries whose plans hold ``join_agg`` fusion regions (eleven regions
#: in all: two in 51, 77 and 97), in both packages' planners at scale 0.01
REGION_QUERIES = (1, 32, 51, 59, 65, 77, 92, 97)

ALL: Dict[int, str] = {
    1: """
WITH customer_total_return AS (
  SELECT sr_customer_sk AS ctr_customer_sk,
         sr_store_sk AS ctr_store_sk,
         SUM(sr_return_amt) AS ctr_total_return
  FROM store_returns, date_dim
  WHERE sr_returned_date_sk = d_date_sk AND d_year = 2000
  GROUP BY sr_customer_sk, sr_store_sk
)
SELECT c_customer_id
FROM customer_total_return ctr1, store, customer
WHERE ctr1.ctr_total_return > (
    SELECT AVG(ctr_total_return) * 1.2
    FROM customer_total_return ctr2
    WHERE ctr1.ctr_store_sk = ctr2.ctr_store_sk)
  AND s_store_sk = ctr1.ctr_store_sk
  AND s_state = 'TN'
  AND ctr1.ctr_customer_sk = c_customer_sk
ORDER BY c_customer_id
LIMIT 100
""",
    2: """
WITH wscs AS (
  SELECT sold_date_sk, sales_price
  FROM (SELECT ws_sold_date_sk AS sold_date_sk,
               ws_ext_sales_price AS sales_price
        FROM web_sales
        UNION ALL
        SELECT cs_sold_date_sk AS sold_date_sk,
               cs_ext_sales_price AS sales_price
        FROM catalog_sales) x
), wswscs AS (
  SELECT d_week_seq,
         SUM(CASE WHEN d_day_name = 'Sunday' THEN sales_price END)
             AS sun_sales,
         SUM(CASE WHEN d_day_name = 'Monday' THEN sales_price END)
             AS mon_sales,
         SUM(CASE WHEN d_day_name = 'Tuesday' THEN sales_price END)
             AS tue_sales,
         SUM(CASE WHEN d_day_name = 'Wednesday' THEN sales_price END)
             AS wed_sales,
         SUM(CASE WHEN d_day_name = 'Thursday' THEN sales_price END)
             AS thu_sales,
         SUM(CASE WHEN d_day_name = 'Friday' THEN sales_price END)
             AS fri_sales,
         SUM(CASE WHEN d_day_name = 'Saturday' THEN sales_price END)
             AS sat_sales
  FROM wscs, date_dim
  WHERE d_date_sk = sold_date_sk
  GROUP BY d_week_seq
)
SELECT d_week_seq1, ROUND(sun_sales1 / sun_sales2, 2) AS r_sun,
       ROUND(mon_sales1 / mon_sales2, 2) AS r_mon,
       ROUND(tue_sales1 / tue_sales2, 2) AS r_tue,
       ROUND(wed_sales1 / wed_sales2, 2) AS r_wed,
       ROUND(thu_sales1 / thu_sales2, 2) AS r_thu,
       ROUND(fri_sales1 / fri_sales2, 2) AS r_fri,
       ROUND(sat_sales1 / sat_sales2, 2) AS r_sat
FROM (SELECT wswscs.d_week_seq AS d_week_seq1,
             sun_sales AS sun_sales1, mon_sales AS mon_sales1,
             tue_sales AS tue_sales1, wed_sales AS wed_sales1,
             thu_sales AS thu_sales1, fri_sales AS fri_sales1,
             sat_sales AS sat_sales1
      FROM wswscs, date_dim
      WHERE date_dim.d_week_seq = wswscs.d_week_seq AND d_year = 1999) y,
     (SELECT wswscs.d_week_seq AS d_week_seq2,
             sun_sales AS sun_sales2, mon_sales AS mon_sales2,
             tue_sales AS tue_sales2, wed_sales AS wed_sales2,
             thu_sales AS thu_sales2, fri_sales AS fri_sales2,
             sat_sales AS sat_sales2
      FROM wswscs, date_dim
      WHERE date_dim.d_week_seq = wswscs.d_week_seq AND d_year = 2000) z
WHERE d_week_seq1 = d_week_seq2 - 52
ORDER BY d_week_seq1
""",
    3: """
SELECT d_year, i_brand_id, i_brand, SUM(ss_ext_sales_price) AS sum_agg
FROM date_dim, store_sales, item
WHERE d_date_sk = ss_sold_date_sk
  AND ss_item_sk = i_item_sk
  AND i_manufact_id = 128
  AND d_moy = 11
GROUP BY d_year, i_brand_id, i_brand
ORDER BY d_year, sum_agg DESC, i_brand_id
LIMIT 100
""",
    4: """
WITH year_total AS
  (SELECT c_customer_id customer_id, c_first_name customer_first_name,
          c_last_name customer_last_name,
          c_preferred_cust_flag customer_preferred_cust_flag,
          c_birth_country customer_birth_country,
          c_login customer_login, c_email_address customer_email_address,
          d_year dyear,
          SUM(((ss_ext_list_price - ss_ext_wholesale_cost
                - ss_ext_discount_amt) + ss_ext_sales_price) / 2) year_total,
          's' sale_type
   FROM customer, store_sales, date_dim
   WHERE c_customer_sk = ss_customer_sk AND ss_sold_date_sk = d_date_sk
   GROUP BY c_customer_id, c_first_name, c_last_name, c_preferred_cust_flag,
            c_birth_country, c_login, c_email_address, d_year
   UNION ALL
   SELECT c_customer_id, c_first_name, c_last_name, c_preferred_cust_flag,
          c_birth_country, c_login, c_email_address, d_year,
          SUM(((cs_ext_list_price - cs_ext_wholesale_cost
                - cs_ext_discount_amt) + cs_ext_sales_price) / 2),
          'c' sale_type
   FROM customer, catalog_sales, date_dim
   WHERE c_customer_sk = cs_bill_customer_sk AND cs_sold_date_sk = d_date_sk
   GROUP BY c_customer_id, c_first_name, c_last_name, c_preferred_cust_flag,
            c_birth_country, c_login, c_email_address, d_year
   UNION ALL
   SELECT c_customer_id, c_first_name, c_last_name, c_preferred_cust_flag,
          c_birth_country, c_login, c_email_address, d_year,
          SUM(((ws_ext_list_price - ws_ext_wholesale_cost
                - ws_ext_discount_amt) + ws_ext_sales_price) / 2),
          'w' sale_type
   FROM customer, web_sales, date_dim
   WHERE c_customer_sk = ws_bill_customer_sk AND ws_sold_date_sk = d_date_sk
   GROUP BY c_customer_id, c_first_name, c_last_name, c_preferred_cust_flag,
            c_birth_country, c_login, c_email_address, d_year)
SELECT t_s_secyear.customer_id, t_s_secyear.customer_first_name,
       t_s_secyear.customer_last_name,
       t_s_secyear.customer_preferred_cust_flag
FROM year_total t_s_firstyear, year_total t_s_secyear,
     year_total t_c_firstyear, year_total t_c_secyear,
     year_total t_w_firstyear, year_total t_w_secyear
WHERE t_s_secyear.customer_id = t_s_firstyear.customer_id
  AND t_s_firstyear.customer_id = t_c_secyear.customer_id
  AND t_s_firstyear.customer_id = t_c_firstyear.customer_id
  AND t_s_firstyear.customer_id = t_w_firstyear.customer_id
  AND t_s_firstyear.customer_id = t_w_secyear.customer_id
  AND t_s_firstyear.sale_type = 's' AND t_c_firstyear.sale_type = 'c'
  AND t_w_firstyear.sale_type = 'w' AND t_s_secyear.sale_type = 's'
  AND t_c_secyear.sale_type = 'c' AND t_w_secyear.sale_type = 'w'
  AND t_s_firstyear.dyear = 2000 AND t_s_secyear.dyear = 2000 + 1
  AND t_c_firstyear.dyear = 2000 AND t_c_secyear.dyear = 2000 + 1
  AND t_w_firstyear.dyear = 2000 AND t_w_secyear.dyear = 2000 + 1
  AND t_s_firstyear.year_total > 0 AND t_c_firstyear.year_total > 0
  AND t_w_firstyear.year_total > 0
  AND CASE WHEN t_c_firstyear.year_total > 0
           THEN (t_c_secyear.year_total * 1.0000) / t_c_firstyear.year_total
           ELSE NULL END
    > CASE WHEN t_s_firstyear.year_total > 0
           THEN (t_s_secyear.year_total * 1.0000) / t_s_firstyear.year_total
           ELSE NULL END
  AND CASE WHEN t_c_firstyear.year_total > 0
           THEN (t_c_secyear.year_total * 1.0000) / t_c_firstyear.year_total
           ELSE NULL END
    > CASE WHEN t_w_firstyear.year_total > 0
           THEN (t_w_secyear.year_total * 1.0000) / t_w_firstyear.year_total
           ELSE NULL END
ORDER BY t_s_secyear.customer_id, t_s_secyear.customer_first_name,
         t_s_secyear.customer_last_name,
         t_s_secyear.customer_preferred_cust_flag
LIMIT 100
""",
    5: """
WITH ssr AS (
  SELECT s_store_id, SUM(sales_price) AS sales, SUM(profit) AS profit,
         SUM(return_amt) AS returns_, SUM(net_loss) AS profit_loss
  FROM (SELECT ss_store_sk AS store_sk, ss_sold_date_sk AS date_sk,
               ss_ext_sales_price AS sales_price, ss_net_profit AS profit,
               CAST(0 AS DOUBLE) AS return_amt, CAST(0 AS DOUBLE) AS net_loss
        FROM store_sales
        UNION ALL
        SELECT sr_store_sk AS store_sk, sr_returned_date_sk AS date_sk,
               CAST(0 AS DOUBLE) AS sales_price, CAST(0 AS DOUBLE) AS profit,
               sr_return_amt AS return_amt, sr_net_loss AS net_loss
        FROM store_returns) salesreturns, date_dim, store
  WHERE date_sk = d_date_sk
    AND d_date BETWEEN DATE '2000-08-23'
                   AND DATE '2000-08-23' + INTERVAL '14' DAY
    AND store_sk = s_store_sk
  GROUP BY s_store_id
), csr AS (
  SELECT cp_catalog_page_id, SUM(sales_price) AS sales,
         SUM(profit) AS profit, SUM(return_amt) AS returns_,
         SUM(net_loss) AS profit_loss
  FROM (SELECT cs_catalog_page_sk AS page_sk, cs_sold_date_sk AS date_sk,
               cs_ext_sales_price AS sales_price, cs_net_profit AS profit,
               CAST(0 AS DOUBLE) AS return_amt, CAST(0 AS DOUBLE) AS net_loss
        FROM catalog_sales
        UNION ALL
        SELECT cr_catalog_page_sk AS page_sk,
               cr_returned_date_sk AS date_sk,
               CAST(0 AS DOUBLE) AS sales_price, CAST(0 AS DOUBLE) AS profit,
               cr_return_amount AS return_amt, cr_net_loss AS net_loss
        FROM catalog_returns) salesreturns, date_dim, catalog_page
  WHERE date_sk = d_date_sk
    AND d_date BETWEEN DATE '2000-08-23'
                   AND DATE '2000-08-23' + INTERVAL '14' DAY
    AND page_sk = cp_catalog_page_sk
  GROUP BY cp_catalog_page_id
), wsr AS (
  SELECT web_site_id, SUM(sales_price) AS sales, SUM(profit) AS profit,
         SUM(return_amt) AS returns_, SUM(net_loss) AS profit_loss
  FROM (SELECT ws_web_site_sk AS wsr_web_site_sk,
               ws_sold_date_sk AS date_sk,
               ws_ext_sales_price AS sales_price, ws_net_profit AS profit,
               CAST(0 AS DOUBLE) AS return_amt, CAST(0 AS DOUBLE) AS net_loss
        FROM web_sales
        UNION ALL
        SELECT ws_web_site_sk AS wsr_web_site_sk,
               wr_returned_date_sk AS date_sk,
               CAST(0 AS DOUBLE) AS sales_price, CAST(0 AS DOUBLE) AS profit,
               wr_return_amt AS return_amt, wr_net_loss AS net_loss
        FROM web_returns
        LEFT JOIN web_sales
          ON wr_item_sk = ws_item_sk
         AND wr_order_number = ws_order_number) salesreturns, date_dim,
       web_site
  WHERE date_sk = d_date_sk
    AND d_date BETWEEN DATE '2000-08-23'
                   AND DATE '2000-08-23' + INTERVAL '14' DAY
    AND wsr_web_site_sk = web_site_sk
  GROUP BY web_site_id
)
SELECT channel, id, SUM(sales) AS sales, SUM(returns_) AS returns_,
       SUM(profit) AS profit
FROM (SELECT 'store channel' AS channel, 'store' + s_store_id AS id,
             sales, returns_, profit - profit_loss AS profit
      FROM ssr
      UNION ALL
      SELECT 'catalog channel' AS channel,
             'catalog_page' + cp_catalog_page_id AS id,
             sales, returns_, profit - profit_loss AS profit
      FROM csr
      UNION ALL
      SELECT 'web channel' AS channel, 'web_site' + web_site_id AS id,
             sales, returns_, profit - profit_loss AS profit
      FROM wsr) x
GROUP BY ROLLUP (channel, id)
ORDER BY channel, id
LIMIT 100
""",
    6: """
WITH target_month AS (
  SELECT DISTINCT d_month_seq AS m
  FROM date_dim WHERE d_year = 2000 AND d_moy = 1
)
SELECT a.ca_state AS state, COUNT(*) AS cnt
FROM customer_address a, customer c, store_sales s, date_dim d, item i
WHERE a.ca_address_sk = c.c_current_addr_sk
  AND c.c_customer_sk = s.ss_customer_sk
  AND s.ss_sold_date_sk = d.d_date_sk
  AND s.ss_item_sk = i.i_item_sk
  AND d.d_month_seq = (SELECT m FROM target_month)
  AND i.i_current_price > 1.2 * (
      SELECT AVG(j.i_current_price) FROM item j
      WHERE j.i_category = i.i_category)
GROUP BY a.ca_state
HAVING COUNT(*) >= 10
ORDER BY cnt, state
LIMIT 100
""",
    7: """
SELECT i_item_id, AVG(ss_quantity) AS agg1, AVG(ss_list_price) AS agg2,
       AVG(ss_coupon_amt) AS agg3, AVG(ss_sales_price) AS agg4
FROM store_sales, customer_demographics, date_dim, item, promotion
WHERE ss_sold_date_sk = d_date_sk
  AND ss_item_sk = i_item_sk
  AND ss_cdemo_sk = cd_demo_sk
  AND ss_promo_sk = p_promo_sk
  AND cd_gender = 'M'
  AND cd_marital_status = 'S'
  AND cd_education_status = 'College'
  AND (p_channel_email = 'N' OR p_channel_event = 'N')
  AND d_year = 2000
GROUP BY i_item_id
ORDER BY i_item_id
LIMIT 100
""",
    8: """
WITH zips AS (
  SELECT substr(ca_zip, 1, 5) AS ca_zip
  FROM customer_address
  WHERE substr(ca_zip, 1, 2) IN ('10', '22', '35', '47', '58', '63')
  INTERSECT
  SELECT substr(ca_zip, 1, 5) AS ca_zip
  FROM customer_address ca, customer c
  WHERE ca.ca_address_sk = c.c_current_addr_sk
    AND c.c_preferred_cust_flag = 'Y'
)
SELECT s_store_name, SUM(ss_net_profit) AS profit
FROM store_sales, date_dim, store
WHERE ss_store_sk = s_store_sk
  AND ss_sold_date_sk = d_date_sk
  AND d_qoy = 2 AND d_year = 2000
  AND substr(s_zip, 1, 2) IN (SELECT substr(ca_zip, 1, 2) FROM zips)
GROUP BY s_store_name
ORDER BY s_store_name
LIMIT 100
""",
    9: """
SELECT CASE WHEN (SELECT COUNT(*) FROM store_sales
                  WHERE ss_quantity BETWEEN 1 AND 20) > 1000
            THEN (SELECT AVG(ss_ext_discount_amt) FROM store_sales
                  WHERE ss_quantity BETWEEN 1 AND 20)
            ELSE (SELECT AVG(ss_net_paid) FROM store_sales
                  WHERE ss_quantity BETWEEN 1 AND 20) END bucket1,
       CASE WHEN (SELECT COUNT(*) FROM store_sales
                  WHERE ss_quantity BETWEEN 21 AND 40) > 1000
            THEN (SELECT AVG(ss_ext_discount_amt) FROM store_sales
                  WHERE ss_quantity BETWEEN 21 AND 40)
            ELSE (SELECT AVG(ss_net_paid) FROM store_sales
                  WHERE ss_quantity BETWEEN 21 AND 40) END bucket2,
       CASE WHEN (SELECT COUNT(*) FROM store_sales
                  WHERE ss_quantity BETWEEN 41 AND 60) > 1000
            THEN (SELECT AVG(ss_ext_discount_amt) FROM store_sales
                  WHERE ss_quantity BETWEEN 41 AND 60)
            ELSE (SELECT AVG(ss_net_paid) FROM store_sales
                  WHERE ss_quantity BETWEEN 41 AND 60) END bucket3,
       CASE WHEN (SELECT COUNT(*) FROM store_sales
                  WHERE ss_quantity BETWEEN 61 AND 80) > 1000
            THEN (SELECT AVG(ss_ext_discount_amt) FROM store_sales
                  WHERE ss_quantity BETWEEN 61 AND 80)
            ELSE (SELECT AVG(ss_net_paid) FROM store_sales
                  WHERE ss_quantity BETWEEN 61 AND 80) END bucket4,
       CASE WHEN (SELECT COUNT(*) FROM store_sales
                  WHERE ss_quantity BETWEEN 81 AND 100) > 1000
            THEN (SELECT AVG(ss_ext_discount_amt) FROM store_sales
                  WHERE ss_quantity BETWEEN 81 AND 100)
            ELSE (SELECT AVG(ss_net_paid) FROM store_sales
                  WHERE ss_quantity BETWEEN 81 AND 100) END bucket5
FROM reason
WHERE r_reason_sk = 1
""",
    10: """
SELECT cd_gender, cd_marital_status, cd_education_status, COUNT(*) cnt1,
       cd_purchase_estimate, COUNT(*) cnt2, cd_credit_rating, COUNT(*) cnt3,
       cd_dep_count, COUNT(*) cnt4, cd_dep_employed_count, COUNT(*) cnt5,
       cd_dep_college_count, COUNT(*) cnt6
FROM customer c, customer_address ca, customer_demographics
WHERE c.c_current_addr_sk = ca.ca_address_sk
  AND ca_county IN ('Ziebach County', 'Williamson County', 'Walker County')
  AND cd_demo_sk = c.c_current_cdemo_sk
  AND EXISTS (SELECT * FROM store_sales, date_dim
              WHERE c.c_customer_sk = ss_customer_sk
                AND ss_sold_date_sk = d_date_sk AND d_year = 2001
                AND d_moy BETWEEN 1 AND 1 + 3)
  AND (EXISTS (SELECT * FROM web_sales, date_dim
               WHERE c.c_customer_sk = ws_bill_customer_sk
                 AND ws_sold_date_sk = d_date_sk AND d_year = 2001
                 AND d_moy BETWEEN 1 AND 1 + 3)
       OR EXISTS (SELECT * FROM catalog_sales, date_dim
                  WHERE c.c_customer_sk = cs_ship_customer_sk
                    AND cs_sold_date_sk = d_date_sk AND d_year = 2001
                    AND d_moy BETWEEN 1 AND 1 + 3))
GROUP BY cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate, cd_credit_rating, cd_dep_count,
         cd_dep_employed_count, cd_dep_college_count
ORDER BY cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate, cd_credit_rating, cd_dep_count,
         cd_dep_employed_count, cd_dep_college_count
LIMIT 100
""",
    11: """
WITH year_total AS
  (SELECT c_customer_id customer_id, c_first_name customer_first_name,
          c_last_name customer_last_name,
          c_preferred_cust_flag customer_preferred_cust_flag,
          c_birth_country customer_birth_country, c_login customer_login,
          c_email_address customer_email_address, d_year dyear,
          SUM(ss_ext_list_price - ss_ext_discount_amt) year_total,
          's' sale_type
   FROM customer, store_sales, date_dim
   WHERE c_customer_sk = ss_customer_sk AND ss_sold_date_sk = d_date_sk
   GROUP BY c_customer_id, c_first_name, c_last_name, c_preferred_cust_flag,
            c_birth_country, c_login, c_email_address, d_year
   UNION ALL
   SELECT c_customer_id, c_first_name, c_last_name, c_preferred_cust_flag,
          c_birth_country, c_login, c_email_address, d_year,
          SUM(ws_ext_list_price - ws_ext_discount_amt), 'w' sale_type
   FROM customer, web_sales, date_dim
   WHERE c_customer_sk = ws_bill_customer_sk AND ws_sold_date_sk = d_date_sk
   GROUP BY c_customer_id, c_first_name, c_last_name, c_preferred_cust_flag,
            c_birth_country, c_login, c_email_address, d_year)
SELECT t_s_secyear.customer_id, t_s_secyear.customer_first_name,
       t_s_secyear.customer_last_name,
       t_s_secyear.customer_preferred_cust_flag
FROM year_total t_s_firstyear, year_total t_s_secyear,
     year_total t_w_firstyear, year_total t_w_secyear
WHERE t_s_secyear.customer_id = t_s_firstyear.customer_id
  AND t_s_firstyear.customer_id = t_w_secyear.customer_id
  AND t_s_firstyear.customer_id = t_w_firstyear.customer_id
  AND t_s_firstyear.sale_type = 's' AND t_w_firstyear.sale_type = 'w'
  AND t_s_secyear.sale_type = 's' AND t_w_secyear.sale_type = 'w'
  AND t_s_firstyear.dyear = 2000 AND t_s_secyear.dyear = 2000 + 1
  AND t_w_firstyear.dyear = 2000 AND t_w_secyear.dyear = 2000 + 1
  AND t_s_firstyear.year_total > 0 AND t_w_firstyear.year_total > 0
  AND CASE WHEN t_w_firstyear.year_total > 0
           THEN (t_w_secyear.year_total * 1.0000) / t_w_firstyear.year_total
           ELSE 0.0 END
    > CASE WHEN t_s_firstyear.year_total > 0
           THEN (t_s_secyear.year_total * 1.0000) / t_s_firstyear.year_total
           ELSE 0.0 END
ORDER BY t_s_secyear.customer_id, t_s_secyear.customer_first_name,
         t_s_secyear.customer_last_name,
         t_s_secyear.customer_preferred_cust_flag
LIMIT 100
""",
    12: """
SELECT i_item_id, i_item_desc, i_category, i_class, i_current_price,
       SUM(ws_ext_sales_price) AS itemrevenue,
       SUM(ws_ext_sales_price) * 100.0000
         / SUM(SUM(ws_ext_sales_price)) OVER (PARTITION BY i_class)
         AS revenueratio
FROM web_sales, item, date_dim
WHERE ws_item_sk = i_item_sk
  AND i_category IN ('Sports', 'Books', 'Home')
  AND ws_sold_date_sk = d_date_sk
  AND d_date BETWEEN CAST('1999-02-22' AS DATE)
                 AND CAST('1999-03-24' AS DATE)
GROUP BY i_item_id, i_item_desc, i_category, i_class, i_current_price
ORDER BY i_category, i_class, i_item_id, i_item_desc, revenueratio
LIMIT 100
""",
    13: """
SELECT AVG(ss_quantity) AS avg_q, AVG(ss_ext_sales_price) AS avg_esp,
       AVG(ss_ext_wholesale_cost) AS avg_ewc,
       SUM(ss_ext_wholesale_cost) AS sum_ewc
FROM store_sales, store, customer_demographics, household_demographics,
     customer_address, date_dim
WHERE s_store_sk = ss_store_sk
  AND ss_sold_date_sk = d_date_sk AND d_year = 2001
  AND ((ss_hdemo_sk = hd_demo_sk AND cd_demo_sk = ss_cdemo_sk
        AND cd_marital_status = 'M' AND cd_education_status = 'Advanced Degree'
        AND ss_sales_price BETWEEN 100.00 AND 150.00 AND hd_dep_count = 3)
       OR (ss_hdemo_sk = hd_demo_sk AND cd_demo_sk = ss_cdemo_sk
           AND cd_marital_status = 'S' AND cd_education_status = 'College'
           AND ss_sales_price BETWEEN 50.00 AND 100.00 AND hd_dep_count = 1)
       OR (ss_hdemo_sk = hd_demo_sk AND cd_demo_sk = ss_cdemo_sk
           AND cd_marital_status = 'W' AND cd_education_status = 'Secondary'
           AND ss_sales_price BETWEEN 150.00 AND 200.00 AND hd_dep_count = 1))
  AND ((ss_addr_sk = ca_address_sk AND ca_country = 'United States'
        AND ca_state IN ('TX', 'OR', 'WA')
        AND ss_net_profit BETWEEN 100 AND 200)
       OR (ss_addr_sk = ca_address_sk AND ca_country = 'United States'
           AND ca_state IN ('CA', 'NY', 'TN')
           AND ss_net_profit BETWEEN 150 AND 300)
       OR (ss_addr_sk = ca_address_sk AND ca_country = 'United States'
           AND ca_state IN ('SD', 'GA', 'KY')
           AND ss_net_profit BETWEEN 50 AND 250))
""",
    14: """
WITH cross_items AS
  (SELECT i_item_sk ss_item_sk
   FROM item,
     (SELECT iss.i_brand_id brand_id, iss.i_class_id class_id,
             iss.i_category_id category_id
      FROM store_sales, item iss, date_dim d1
      WHERE ss_item_sk = iss.i_item_sk AND ss_sold_date_sk = d1.d_date_sk
        AND d1.d_year BETWEEN 1999 AND 1999 + 2
      INTERSECT
      SELECT ics.i_brand_id, ics.i_class_id, ics.i_category_id
      FROM catalog_sales, item ics, date_dim d2
      WHERE cs_item_sk = ics.i_item_sk AND cs_sold_date_sk = d2.d_date_sk
        AND d2.d_year BETWEEN 1999 AND 1999 + 2
      INTERSECT
      SELECT iws.i_brand_id, iws.i_class_id, iws.i_category_id
      FROM web_sales, item iws, date_dim d3
      WHERE ws_item_sk = iws.i_item_sk AND ws_sold_date_sk = d3.d_date_sk
        AND d3.d_year BETWEEN 1999 AND 1999 + 2) sq1
   WHERE i_brand_id = brand_id AND i_class_id = class_id
     AND i_category_id = category_id),
     avg_sales AS
  (SELECT AVG(quantity * list_price) average_sales
   FROM (SELECT ss_quantity quantity, ss_list_price list_price
         FROM store_sales, date_dim
         WHERE ss_sold_date_sk = d_date_sk
           AND d_year BETWEEN 1999 AND 1999 + 2
         UNION ALL
         SELECT cs_quantity, cs_list_price
         FROM catalog_sales, date_dim
         WHERE cs_sold_date_sk = d_date_sk
           AND d_year BETWEEN 1999 AND 1999 + 2
         UNION ALL
         SELECT ws_quantity, ws_list_price
         FROM web_sales, date_dim
         WHERE ws_sold_date_sk = d_date_sk
           AND d_year BETWEEN 1999 AND 1999 + 2) sq2)
SELECT channel, i_brand_id, i_class_id, i_category_id,
       SUM(sales) AS sum_sales, SUM(number_sales) AS sum_number_sales
FROM
  (SELECT 'store' channel, i_brand_id, i_class_id, i_category_id,
          SUM(ss_quantity * ss_list_price) sales, COUNT(*) number_sales
   FROM store_sales, item, date_dim
   WHERE ss_item_sk IN (SELECT ss_item_sk FROM cross_items)
     AND ss_item_sk = i_item_sk AND ss_sold_date_sk = d_date_sk
     AND d_year = 1999 + 2 AND d_moy = 11
   GROUP BY i_brand_id, i_class_id, i_category_id
   HAVING SUM(ss_quantity * ss_list_price)
          > (SELECT average_sales FROM avg_sales)
   UNION ALL
   SELECT 'catalog' channel, i_brand_id, i_class_id, i_category_id,
          SUM(cs_quantity * cs_list_price) sales, COUNT(*) number_sales
   FROM catalog_sales, item, date_dim
   WHERE cs_item_sk IN (SELECT ss_item_sk FROM cross_items)
     AND cs_item_sk = i_item_sk AND cs_sold_date_sk = d_date_sk
     AND d_year = 1999 + 2 AND d_moy = 11
   GROUP BY i_brand_id, i_class_id, i_category_id
   HAVING SUM(cs_quantity * cs_list_price)
          > (SELECT average_sales FROM avg_sales)
   UNION ALL
   SELECT 'web' channel, i_brand_id, i_class_id, i_category_id,
          SUM(ws_quantity * ws_list_price) sales, COUNT(*) number_sales
   FROM web_sales, item, date_dim
   WHERE ws_item_sk IN (SELECT ss_item_sk FROM cross_items)
     AND ws_item_sk = i_item_sk AND ws_sold_date_sk = d_date_sk
     AND d_year = 1999 + 2 AND d_moy = 11
   GROUP BY i_brand_id, i_class_id, i_category_id
   HAVING SUM(ws_quantity * ws_list_price)
          > (SELECT average_sales FROM avg_sales)) y
GROUP BY ROLLUP (channel, i_brand_id, i_class_id, i_category_id)
ORDER BY channel, i_brand_id, i_class_id, i_category_id
LIMIT 100
""",
    15: """
SELECT ca_zip, SUM(cs_sales_price) AS total_sales
FROM catalog_sales, customer, customer_address, date_dim
WHERE cs_bill_customer_sk = c_customer_sk
  AND c_current_addr_sk = ca_address_sk
  AND (substr(ca_zip, 1, 5) IN ('85669', '86197', '88274', '83405',
                                '86475', '85392', '85460', '80348', '81792')
       OR ca_state IN ('CA', 'WA', 'GA')
       OR cs_sales_price > 500)
  AND cs_sold_date_sk = d_date_sk
  AND d_qoy = 2 AND d_year = 2000
GROUP BY ca_zip
ORDER BY ca_zip
LIMIT 100
""",
    16: """
SELECT COUNT(DISTINCT cs_order_number) AS order_count,
       SUM(cs_ext_ship_cost) AS total_shipping_cost,
       SUM(cs_net_profit) AS total_net_profit
FROM catalog_sales cs1, date_dim, customer_address, call_center
WHERE d_date BETWEEN DATE '2000-02-01'
                 AND DATE '2000-02-01' + INTERVAL '60' DAY
  AND cs1.cs_ship_date_sk = d_date_sk
  AND cs1.cs_ship_addr_sk = ca_address_sk
  AND ca_state = 'CA'
  AND cs1.cs_call_center_sk = cc_call_center_sk
  AND EXISTS (SELECT 1 FROM catalog_sales cs2
              WHERE cs1.cs_order_number = cs2.cs_order_number
                AND cs1.cs_warehouse_sk <> cs2.cs_warehouse_sk)
  AND NOT EXISTS (SELECT 1 FROM catalog_returns cr1
                  WHERE cs1.cs_order_number = cr1.cr_order_number)
ORDER BY order_count
LIMIT 100
""",
    17: """
SELECT i_item_id, i_item_desc, s_state,
       COUNT(ss_quantity) AS store_sales_quantitycount,
       AVG(ss_quantity) AS store_sales_quantityave,
       STDDEV(ss_quantity) AS store_sales_quantitystdev,
       STDDEV(ss_quantity) / AVG(ss_quantity) AS store_sales_quantitycov,
       COUNT(sr_return_quantity) AS store_returns_quantitycount,
       AVG(sr_return_quantity) AS store_returns_quantityave,
       STDDEV(sr_return_quantity) AS store_returns_quantitystdev,
       STDDEV(sr_return_quantity) / AVG(sr_return_quantity)
         AS store_returns_quantitycov,
       COUNT(cs_quantity) AS catalog_sales_quantitycount,
       AVG(cs_quantity) AS catalog_sales_quantityave,
       STDDEV(cs_quantity) AS catalog_sales_quantitystdev,
       STDDEV(cs_quantity) / AVG(cs_quantity) AS catalog_sales_quantitycov
FROM store_sales, store_returns, catalog_sales,
     date_dim d1, date_dim d2, date_dim d3, store, item
WHERE d1.d_quarter_name = '2000Q1'
  AND d1.d_date_sk = ss_sold_date_sk
  AND i_item_sk = ss_item_sk AND s_store_sk = ss_store_sk
  AND ss_customer_sk = sr_customer_sk AND ss_item_sk = sr_item_sk
  AND ss_ticket_number = sr_ticket_number
  AND sr_returned_date_sk = d2.d_date_sk
  AND d2.d_quarter_name IN ('2000Q1', '2000Q2', '2000Q3')
  AND sr_customer_sk = cs_bill_customer_sk AND sr_item_sk = cs_item_sk
  AND cs_sold_date_sk = d3.d_date_sk
  AND d3.d_quarter_name IN ('2000Q1', '2000Q2', '2000Q3')
GROUP BY i_item_id, i_item_desc, s_state
ORDER BY i_item_id, i_item_desc, s_state
LIMIT 100
""",
    18: """
SELECT i_item_id, ca_country, ca_state, ca_county,
       AVG(CAST(cs_quantity AS DOUBLE)) AS agg1,
       AVG(CAST(cs_list_price AS DOUBLE)) AS agg2,
       AVG(CAST(cs_coupon_amt AS DOUBLE)) AS agg3,
       AVG(CAST(cs_sales_price AS DOUBLE)) AS agg4,
       AVG(CAST(cs_net_profit AS DOUBLE)) AS agg5,
       AVG(CAST(c_birth_year AS DOUBLE)) AS agg6,
       AVG(CAST(cd1.cd_dep_count AS DOUBLE)) AS agg7
FROM catalog_sales, customer_demographics cd1, customer_demographics cd2,
     customer, customer_address, date_dim, item
WHERE cs_sold_date_sk = d_date_sk
  AND cs_item_sk = i_item_sk
  AND cs_bill_cdemo_sk = cd1.cd_demo_sk
  AND cs_bill_customer_sk = c_customer_sk
  AND cd1.cd_gender = 'F'
  AND cd1.cd_education_status = 'Unknown'
  AND c_current_cdemo_sk = cd2.cd_demo_sk
  AND c_current_addr_sk = ca_address_sk
  AND c_birth_month IN (1, 6, 8, 9, 12, 2)
  AND d_year = 2000
  AND ca_state IN ('CA', 'NY', 'TX', 'WA', 'OR', 'TN', 'SD')
GROUP BY ROLLUP (i_item_id, ca_country, ca_state, ca_county)
ORDER BY ca_country, ca_state, ca_county, i_item_id
LIMIT 100
""",
    19: """
SELECT i_brand_id, i_brand, i_manufact_id,
       SUM(ss_ext_sales_price) AS ext_price
FROM date_dim, store_sales, item, customer, customer_address, store
WHERE d_date_sk = ss_sold_date_sk
  AND ss_item_sk = i_item_sk
  AND i_manager_id BETWEEN 1 AND 40
  AND d_moy = 11
  AND d_year = 1999
  AND ss_customer_sk = c_customer_sk
  AND c_current_addr_sk = ca_address_sk
  AND ss_store_sk = s_store_sk
GROUP BY i_brand_id, i_brand, i_manufact_id
ORDER BY ext_price DESC, i_brand_id, i_manufact_id
LIMIT 100
""",
    20: """
WITH revenue AS (
  SELECT i_item_id, i_item_desc, i_category, i_class, i_current_price,
         SUM(cs_ext_sales_price) AS itemrevenue
  FROM catalog_sales, item, date_dim
  WHERE cs_item_sk = i_item_sk
    AND i_category IN ('Sports', 'Books', 'Home')
    AND cs_sold_date_sk = d_date_sk
    AND d_date BETWEEN DATE '1999-02-22'
                   AND DATE '1999-02-22' + INTERVAL '30' DAY
  GROUP BY i_item_id, i_item_desc, i_category, i_class, i_current_price
)
SELECT i_item_id, i_item_desc, i_category, i_class, i_current_price,
       itemrevenue,
       itemrevenue * 100.0 / SUM(itemrevenue) OVER (PARTITION BY i_class)
           AS revenueratio
FROM revenue
ORDER BY i_category, i_class, i_item_id, i_item_desc, revenueratio
LIMIT 100
""",
    21: """
SELECT w_warehouse_name, i_item_id,
       SUM(CASE WHEN d_date < DATE '2000-03-11' THEN inv_quantity_on_hand
                ELSE 0 END) AS inv_before,
       SUM(CASE WHEN d_date >= DATE '2000-03-11' THEN inv_quantity_on_hand
                ELSE 0 END) AS inv_after
FROM inventory, warehouse, item, date_dim
WHERE i_current_price BETWEEN 0.99 AND 1.49
  AND i_item_sk = inv_item_sk
  AND inv_warehouse_sk = w_warehouse_sk
  AND inv_date_sk = d_date_sk
  AND d_date BETWEEN DATE '2000-03-11' - INTERVAL '30' DAY
                 AND DATE '2000-03-11' + INTERVAL '30' DAY
GROUP BY w_warehouse_name, i_item_id
HAVING (CASE WHEN SUM(CASE WHEN d_date < DATE '2000-03-11'
                           THEN inv_quantity_on_hand ELSE 0 END) > 0
             THEN SUM(CASE WHEN d_date >= DATE '2000-03-11'
                           THEN inv_quantity_on_hand ELSE 0 END) * 1.0 /
                  SUM(CASE WHEN d_date < DATE '2000-03-11'
                           THEN inv_quantity_on_hand ELSE 0 END)
             ELSE NULL END) BETWEEN 0.666667 AND 1.5
ORDER BY w_warehouse_name, i_item_id
LIMIT 100
""",
    22: """
SELECT i_product_name, i_brand, i_class, i_category,
       AVG(inv_quantity_on_hand) AS qoh
FROM inventory, date_dim, item
WHERE inv_date_sk = d_date_sk
  AND inv_item_sk = i_item_sk
  AND d_month_seq BETWEEN 1212 AND 1212 + 11
GROUP BY ROLLUP (i_product_name, i_brand, i_class, i_category)
ORDER BY qoh, i_product_name, i_brand, i_class, i_category
LIMIT 100
""",
    23: """
WITH frequent_ss_items AS
  (SELECT itemdesc, i_item_sk item_sk, d_date solddate, COUNT(*) cnt
   FROM store_sales, date_dim,
        (SELECT SUBSTR(i_item_desc, 1, 30) itemdesc, * FROM item) sq1
   WHERE ss_sold_date_sk = d_date_sk AND ss_item_sk = i_item_sk
     AND d_year IN (1999, 1999 + 1, 1999 + 2)
   GROUP BY itemdesc, i_item_sk, d_date
   HAVING COUNT(*) > 4),
     max_store_sales AS
  (SELECT MAX(csales) tpcds_cmax
   FROM (SELECT c_customer_sk, SUM(ss_quantity * ss_sales_price) csales
         FROM store_sales, customer, date_dim
         WHERE ss_customer_sk = c_customer_sk
           AND ss_sold_date_sk = d_date_sk
           AND d_year IN (1999, 1999 + 1, 1999 + 2)
         GROUP BY c_customer_sk) sq2),
     best_ss_customer AS
  (SELECT c_customer_sk, SUM(ss_quantity * ss_sales_price) ssales
   FROM store_sales, customer, max_store_sales
   WHERE ss_customer_sk = c_customer_sk
   GROUP BY c_customer_sk
   HAVING SUM(ss_quantity * ss_sales_price) > (50 / 100.0) * MAX(tpcds_cmax))
SELECT c_last_name, c_first_name, sales
FROM (SELECT c_last_name, c_first_name,
             SUM(cs_quantity * cs_list_price) sales
      FROM catalog_sales, customer, date_dim, frequent_ss_items,
           best_ss_customer
      WHERE d_year = 2000 AND d_moy = 2 AND cs_sold_date_sk = d_date_sk
        AND cs_item_sk = item_sk
        AND cs_bill_customer_sk = best_ss_customer.c_customer_sk
        AND cs_bill_customer_sk = customer.c_customer_sk
      GROUP BY c_last_name, c_first_name
      UNION ALL
      SELECT c_last_name, c_first_name,
             SUM(ws_quantity * ws_list_price) sales
      FROM web_sales, customer, date_dim, frequent_ss_items,
           best_ss_customer
      WHERE d_year = 2000 AND d_moy = 2 AND ws_sold_date_sk = d_date_sk
        AND ws_item_sk = item_sk
        AND ws_bill_customer_sk = best_ss_customer.c_customer_sk
        AND ws_bill_customer_sk = customer.c_customer_sk
      GROUP BY c_last_name, c_first_name) sq3
ORDER BY c_last_name, c_first_name, sales
LIMIT 100
""",
    24: """
WITH ssales AS
  (SELECT c_last_name, c_first_name, s_store_name, ca_state, s_state,
          i_color, i_current_price, i_manager_id, i_units, i_size,
          SUM(ss_net_paid) netpaid
   FROM store_sales, store_returns, store, item, customer,
        customer_address
   WHERE ss_ticket_number = sr_ticket_number AND ss_item_sk = sr_item_sk
     AND ss_customer_sk = c_customer_sk AND ss_item_sk = i_item_sk
     AND ss_store_sk = s_store_sk AND c_current_addr_sk = ca_address_sk
     AND c_birth_country <> UPPER(ca_country)
     AND s_market_id = 8
   GROUP BY c_last_name, c_first_name, s_store_name, ca_state, s_state,
            i_color, i_current_price, i_manager_id, i_units, i_size)
SELECT c_last_name, c_first_name, s_store_name, SUM(netpaid) paid
FROM ssales
WHERE i_color = 'peach'
GROUP BY c_last_name, c_first_name, s_store_name
HAVING SUM(netpaid) > (SELECT 0.05 * AVG(netpaid) FROM ssales)
ORDER BY c_last_name, c_first_name, s_store_name
""",
    25: """
SELECT i_item_id, i_item_desc, s_store_id, s_store_name,
       SUM(ss_net_profit) AS store_sales_profit,
       SUM(sr_net_loss) AS store_returns_loss,
       SUM(cs_net_profit) AS catalog_sales_profit
FROM store_sales, store_returns, catalog_sales, date_dim d1, date_dim d2,
     date_dim d3, store, item
WHERE d1.d_moy = 4 AND d1.d_year = 2000 AND d1.d_date_sk = ss_sold_date_sk
  AND i_item_sk = ss_item_sk AND s_store_sk = ss_store_sk
  AND ss_customer_sk = sr_customer_sk AND ss_item_sk = sr_item_sk
  AND ss_ticket_number = sr_ticket_number
  AND sr_returned_date_sk = d2.d_date_sk
  AND d2.d_moy BETWEEN 4 AND 10 AND d2.d_year = 2000
  AND sr_customer_sk = cs_bill_customer_sk AND sr_item_sk = cs_item_sk
  AND cs_sold_date_sk = d3.d_date_sk
  AND d3.d_moy BETWEEN 4 AND 10 AND d3.d_year = 2000
GROUP BY i_item_id, i_item_desc, s_store_id, s_store_name
ORDER BY i_item_id, i_item_desc, s_store_id, s_store_name
LIMIT 100
""",
    26: """
SELECT i_item_id, AVG(ss_quantity) AS agg1, AVG(ss_list_price) AS agg2,
       AVG(ss_coupon_amt) AS agg3, AVG(ss_sales_price) AS agg4
FROM store_sales, customer_demographics, date_dim, item, promotion
WHERE ss_sold_date_sk = d_date_sk
  AND ss_item_sk = i_item_sk
  AND ss_cdemo_sk = cd_demo_sk
  AND ss_promo_sk = p_promo_sk
  AND cd_gender = 'F'
  AND cd_marital_status = 'W'
  AND cd_education_status = 'Primary'
  AND (p_channel_email = 'N' OR p_channel_event = 'N')
  AND d_year = 2000
GROUP BY i_item_id
ORDER BY i_item_id
LIMIT 100
""",
    27: """
SELECT i_item_id, s_state, GROUPING(s_state) AS g_state,
       AVG(CAST(ss_quantity AS DOUBLE)) AS agg1,
       AVG(CAST(ss_list_price AS DOUBLE)) AS agg2,
       AVG(CAST(ss_coupon_amt AS DOUBLE)) AS agg3,
       AVG(CAST(ss_sales_price AS DOUBLE)) AS agg4
FROM store_sales, customer_demographics, date_dim, store, item
WHERE ss_sold_date_sk = d_date_sk
  AND ss_item_sk = i_item_sk
  AND ss_store_sk = s_store_sk
  AND ss_cdemo_sk = cd_demo_sk
  AND cd_gender = 'M'
  AND cd_marital_status = 'S'
  AND cd_education_status = 'College'
  AND d_year = 2000
  AND s_state IN ('TN', 'SD', 'CA')
GROUP BY ROLLUP (i_item_id, s_state)
ORDER BY i_item_id, s_state
LIMIT 100
""",
    28: """
SELECT *
FROM (SELECT AVG(ss_list_price) b1_lp, COUNT(ss_list_price) b1_cnt,
             COUNT(DISTINCT ss_list_price) b1_cntd
      FROM store_sales
      WHERE ss_quantity BETWEEN 0 AND 5
        AND (ss_list_price BETWEEN 8 AND 8 + 10
             OR ss_coupon_amt BETWEEN 459 AND 459 + 1000
             OR ss_wholesale_cost BETWEEN 57 AND 57 + 20)) b1,
     (SELECT AVG(ss_list_price) b2_lp, COUNT(ss_list_price) b2_cnt,
             COUNT(DISTINCT ss_list_price) b2_cntd
      FROM store_sales
      WHERE ss_quantity BETWEEN 6 AND 10
        AND (ss_list_price BETWEEN 90 AND 90 + 10
             OR ss_coupon_amt BETWEEN 2323 AND 2323 + 1000
             OR ss_wholesale_cost BETWEEN 31 AND 31 + 20)) b2,
     (SELECT AVG(ss_list_price) b3_lp, COUNT(ss_list_price) b3_cnt,
             COUNT(DISTINCT ss_list_price) b3_cntd
      FROM store_sales
      WHERE ss_quantity BETWEEN 11 AND 15
        AND (ss_list_price BETWEEN 142 AND 142 + 10
             OR ss_coupon_amt BETWEEN 12214 AND 12214 + 1000
             OR ss_wholesale_cost BETWEEN 79 AND 79 + 20)) b3,
     (SELECT AVG(ss_list_price) b4_lp, COUNT(ss_list_price) b4_cnt,
             COUNT(DISTINCT ss_list_price) b4_cntd
      FROM store_sales
      WHERE ss_quantity BETWEEN 16 AND 20
        AND (ss_list_price BETWEEN 135 AND 135 + 10
             OR ss_coupon_amt BETWEEN 6071 AND 6071 + 1000
             OR ss_wholesale_cost BETWEEN 38 AND 38 + 20)) b4,
     (SELECT AVG(ss_list_price) b5_lp, COUNT(ss_list_price) b5_cnt,
             COUNT(DISTINCT ss_list_price) b5_cntd
      FROM store_sales
      WHERE ss_quantity BETWEEN 21 AND 25
        AND (ss_list_price BETWEEN 122 AND 122 + 10
             OR ss_coupon_amt BETWEEN 836 AND 836 + 1000
             OR ss_wholesale_cost BETWEEN 17 AND 17 + 20)) b5,
     (SELECT AVG(ss_list_price) b6_lp, COUNT(ss_list_price) b6_cnt,
             COUNT(DISTINCT ss_list_price) b6_cntd
      FROM store_sales
      WHERE ss_quantity BETWEEN 26 AND 30
        AND (ss_list_price BETWEEN 154 AND 154 + 10
             OR ss_coupon_amt BETWEEN 7326 AND 7326 + 1000
             OR ss_wholesale_cost BETWEEN 7 AND 7 + 20)) b6
LIMIT 100
""",
    29: """
SELECT i_item_id, i_item_desc, s_store_id, s_store_name,
       SUM(ss_quantity) AS store_sales_quantity,
       SUM(sr_return_quantity) AS store_returns_quantity,
       SUM(cs_quantity) AS catalog_sales_quantity
FROM store_sales, store_returns, catalog_sales, date_dim d1, date_dim d2,
     date_dim d3, store, item
WHERE d1.d_moy = 4 AND d1.d_year = 1999 AND d1.d_date_sk = ss_sold_date_sk
  AND i_item_sk = ss_item_sk AND s_store_sk = ss_store_sk
  AND ss_customer_sk = sr_customer_sk AND ss_item_sk = sr_item_sk
  AND ss_ticket_number = sr_ticket_number
  AND sr_returned_date_sk = d2.d_date_sk
  AND d2.d_moy BETWEEN 4 AND 7 AND d2.d_year = 1999
  AND sr_customer_sk = cs_bill_customer_sk AND sr_item_sk = cs_item_sk
  AND cs_sold_date_sk = d3.d_date_sk
  AND d3.d_year IN (1999, 2000, 2001)
GROUP BY i_item_id, i_item_desc, s_store_id, s_store_name
ORDER BY i_item_id, i_item_desc, s_store_id, s_store_name
LIMIT 100
""",
    30: """
WITH customer_total_return AS (
  SELECT wr_returning_customer_sk AS ctr_customer_sk,
         ca_state AS ctr_state,
         SUM(wr_return_amt) AS ctr_total_return
  FROM web_returns, date_dim, customer_address
  WHERE wr_returned_date_sk = d_date_sk AND d_year = 2000
    AND wr_returning_addr_sk = ca_address_sk
  GROUP BY wr_returning_customer_sk, ca_state
)
SELECT c_customer_id, c_salutation, c_first_name, c_last_name,
       c_preferred_cust_flag, c_birth_day, c_birth_month, c_birth_year,
       c_birth_country, c_login, c_email_address, ctr_total_return
FROM customer_total_return ctr1, customer_address, customer
WHERE ctr1.ctr_total_return > (
    SELECT AVG(ctr_total_return) * 1.2
    FROM customer_total_return ctr2
    WHERE ctr1.ctr_state = ctr2.ctr_state)
  AND ca_address_sk = c_current_addr_sk
  AND ca_state = 'CA'
  AND ctr1.ctr_customer_sk = c_customer_sk
ORDER BY c_customer_id, c_salutation, c_first_name, c_last_name
LIMIT 100
""",
    31: """
WITH ss AS
  (SELECT ca_county, d_qoy, d_year,
          SUM(ss_ext_sales_price) AS store_sales
   FROM store_sales, date_dim, customer_address
   WHERE ss_sold_date_sk = d_date_sk AND ss_addr_sk = ca_address_sk
   GROUP BY ca_county, d_qoy, d_year),
     ws AS
  (SELECT ca_county, d_qoy, d_year,
          SUM(ws_ext_sales_price) AS web_sales
   FROM web_sales, date_dim, customer_address
   WHERE ws_sold_date_sk = d_date_sk AND ws_bill_addr_sk = ca_address_sk
   GROUP BY ca_county, d_qoy, d_year)
SELECT ss1.ca_county, ss1.d_year,
       (ws2.web_sales * 1.0000) / ws1.web_sales web_q1_q2_increase,
       (ss2.store_sales * 1.0000) / ss1.store_sales store_q1_q2_increase,
       (ws3.web_sales * 1.0000) / ws2.web_sales web_q2_q3_increase,
       (ss3.store_sales * 1.0000) / ss2.store_sales store_q2_q3_increase
FROM ss ss1, ss ss2, ss ss3, ws ws1, ws ws2, ws ws3
WHERE ss1.d_qoy = 1 AND ss1.d_year = 2000
  AND ss1.ca_county = ss2.ca_county AND ss2.d_qoy = 2
  AND ss2.d_year = 2000
  AND ss2.ca_county = ss3.ca_county AND ss3.d_qoy = 3
  AND ss3.d_year = 2000
  AND ss1.ca_county = ws1.ca_county AND ws1.d_qoy = 1
  AND ws1.d_year = 2000
  AND ws1.ca_county = ws2.ca_county AND ws2.d_qoy = 2
  AND ws2.d_year = 2000
  AND ws1.ca_county = ws3.ca_county AND ws3.d_qoy = 3
  AND ws3.d_year = 2000
  AND CASE WHEN ws1.web_sales > 0
           THEN (ws2.web_sales * 1.0000) / ws1.web_sales ELSE NULL END
    > CASE WHEN ss1.store_sales > 0
           THEN (ss2.store_sales * 1.0000) / ss1.store_sales
           ELSE NULL END
  AND CASE WHEN ws2.web_sales > 0
           THEN (ws3.web_sales * 1.0000) / ws2.web_sales ELSE NULL END
    > CASE WHEN ss2.store_sales > 0
           THEN (ss3.store_sales * 1.0000) / ss2.store_sales
           ELSE NULL END
ORDER BY ss1.ca_county
""",
    32: """
SELECT SUM(cs_ext_discount_amt) AS excess_discount_amount
FROM catalog_sales, item, date_dim
WHERE i_manufact_id = 77
  AND i_item_sk = cs_item_sk
  AND d_date BETWEEN DATE '2000-01-27'
                 AND DATE '2000-01-27' + INTERVAL '90' DAY
  AND d_date_sk = cs_sold_date_sk
  AND cs_ext_discount_amt > (
      SELECT 1.3 * AVG(cs_ext_discount_amt)
      FROM catalog_sales cs2, date_dim d2
      WHERE cs2.cs_item_sk = i_item_sk
        AND d2.d_date BETWEEN DATE '2000-01-27'
                          AND DATE '2000-01-27' + INTERVAL '90' DAY
        AND d2.d_date_sk = cs2.cs_sold_date_sk)
ORDER BY excess_discount_amount
LIMIT 100
""",
    33: """
WITH ss AS (
  SELECT i_manufact_id, SUM(ss_ext_sales_price) AS total_sales
  FROM store_sales, date_dim, customer_address, item
  WHERE i_manufact_id IN (SELECT i_manufact_id FROM item
                          WHERE i_category IN ('Books'))
    AND ss_item_sk = i_item_sk
    AND ss_sold_date_sk = d_date_sk
    AND d_year = 2000 AND d_moy = 1
    AND ss_addr_sk = ca_address_sk
    AND ca_gmt_offset = -5
  GROUP BY i_manufact_id
), cs AS (
  SELECT i_manufact_id, SUM(cs_ext_sales_price) AS total_sales
  FROM catalog_sales, date_dim, customer_address, item
  WHERE i_manufact_id IN (SELECT i_manufact_id FROM item
                          WHERE i_category IN ('Books'))
    AND cs_item_sk = i_item_sk
    AND cs_sold_date_sk = d_date_sk
    AND d_year = 2000 AND d_moy = 1
    AND cs_bill_addr_sk = ca_address_sk
    AND ca_gmt_offset = -5
  GROUP BY i_manufact_id
), ws AS (
  SELECT i_manufact_id, SUM(ws_ext_sales_price) AS total_sales
  FROM web_sales, date_dim, customer_address, item
  WHERE i_manufact_id IN (SELECT i_manufact_id FROM item
                          WHERE i_category IN ('Books'))
    AND ws_item_sk = i_item_sk
    AND ws_sold_date_sk = d_date_sk
    AND d_year = 2000 AND d_moy = 1
    AND ws_bill_addr_sk = ca_address_sk
    AND ca_gmt_offset = -5
  GROUP BY i_manufact_id
)
SELECT i_manufact_id, SUM(total_sales) AS total_sales
FROM (SELECT * FROM ss UNION ALL SELECT * FROM cs
      UNION ALL SELECT * FROM ws) tmp1
GROUP BY i_manufact_id
ORDER BY total_sales
LIMIT 100
""",
    34: """
WITH tickets AS (
  SELECT ss_ticket_number, ss_customer_sk, COUNT(*) AS cnt
  FROM store_sales, date_dim, store, household_demographics
  WHERE ss_sold_date_sk = d_date_sk
    AND ss_store_sk = s_store_sk
    AND ss_hdemo_sk = hd_demo_sk
    AND d_dom BETWEEN 1 AND 3
    AND hd_vehicle_count > 0
    AND d_year = 2000
  GROUP BY ss_ticket_number, ss_customer_sk
)
SELECT c_last_name, c_first_name, ss_ticket_number, cnt
FROM tickets, customer
WHERE ss_customer_sk = c_customer_sk
  AND cnt BETWEEN 15 AND 20
ORDER BY c_last_name, c_first_name, ss_ticket_number DESC
""",
    35: """
SELECT ca_state, cd_gender, cd_marital_status, cd_dep_count,
       COUNT(*) cnt1, MIN(cd_dep_count) min1, MAX(cd_dep_count) max1,
       AVG(cd_dep_count) avg1, cd_dep_employed_count, COUNT(*) cnt2,
       MIN(cd_dep_employed_count) min2, MAX(cd_dep_employed_count) max2,
       AVG(cd_dep_employed_count) avg2, cd_dep_college_count,
       COUNT(*) cnt3, MIN(cd_dep_college_count) min3,
       MAX(cd_dep_college_count) max3, AVG(cd_dep_college_count) avg3
FROM customer c, customer_address ca, customer_demographics
WHERE c.c_current_addr_sk = ca.ca_address_sk
  AND cd_demo_sk = c.c_current_cdemo_sk
  AND EXISTS (SELECT * FROM store_sales, date_dim
              WHERE c.c_customer_sk = ss_customer_sk
                AND ss_sold_date_sk = d_date_sk AND d_year = 2001
                AND d_qoy < 4)
  AND (EXISTS (SELECT * FROM web_sales, date_dim
               WHERE c.c_customer_sk = ws_bill_customer_sk
                 AND ws_sold_date_sk = d_date_sk AND d_year = 2001
                 AND d_qoy < 4)
       OR EXISTS (SELECT * FROM catalog_sales, date_dim
                  WHERE c.c_customer_sk = cs_ship_customer_sk
                    AND cs_sold_date_sk = d_date_sk AND d_year = 2001
                    AND d_qoy < 4))
GROUP BY ca_state, cd_gender, cd_marital_status, cd_dep_count,
         cd_dep_employed_count, cd_dep_college_count
ORDER BY ca_state, cd_gender, cd_marital_status, cd_dep_count,
         cd_dep_employed_count, cd_dep_college_count
LIMIT 100
""",
    36: """
WITH results AS
  (SELECT SUM(ss_net_profit) AS ss_net_profit,
          SUM(ss_ext_sales_price) AS ss_ext_sales_price,
          (SUM(ss_net_profit) * 1.0000) / SUM(ss_ext_sales_price)
            AS gross_margin,
          i_category, i_class, 0 AS g_category, 0 AS g_class
   FROM store_sales, date_dim d1, item, store
   WHERE d1.d_year = 2000 AND d1.d_date_sk = ss_sold_date_sk
     AND i_item_sk = ss_item_sk AND s_store_sk = ss_store_sk
     AND s_state = 'TN'
   GROUP BY i_category, i_class),
     results_rollup AS
  (SELECT gross_margin, i_category, i_class, 0 AS t_category,
          0 AS t_class, 0 AS lochierarchy
   FROM results
   UNION
   SELECT (SUM(ss_net_profit) * 1.0000) / SUM(ss_ext_sales_price)
            AS gross_margin,
          i_category, NULL AS i_class, 0 AS t_category, 1 AS t_class,
          1 AS lochierarchy
   FROM results GROUP BY i_category
   UNION
   SELECT (SUM(ss_net_profit) * 1.0000) / SUM(ss_ext_sales_price)
            AS gross_margin,
          NULL AS i_category, NULL AS i_class, 1 AS t_category,
          1 AS t_class, 2 AS lochierarchy
   FROM results)
SELECT gross_margin, i_category, i_class, lochierarchy,
       RANK() OVER (PARTITION BY lochierarchy,
                                 CASE WHEN t_class = 0 THEN i_category END
                    ORDER BY gross_margin ASC) AS rank_within_parent
FROM results_rollup
ORDER BY lochierarchy DESC,
         CASE WHEN lochierarchy = 0 THEN i_category END,
         rank_within_parent
LIMIT 100
""",
    37: """
SELECT i_item_id, i_item_desc, i_current_price
FROM item, inventory, date_dim, catalog_sales
WHERE i_current_price BETWEEN 20 AND 50
  AND inv_item_sk = i_item_sk
  AND d_date_sk = inv_date_sk
  AND d_date BETWEEN DATE '2000-02-01' AND DATE '2000-02-01' + INTERVAL '60' DAY
  AND i_manufact_id IN (100, 120, 140, 160)
  AND inv_quantity_on_hand BETWEEN 100 AND 500
  AND cs_item_sk = i_item_sk
GROUP BY i_item_id, i_item_desc, i_current_price
ORDER BY i_item_id
LIMIT 100
""",
    38: """
SELECT COUNT(*) AS cnt
FROM (SELECT DISTINCT c_last_name, c_first_name, d_date
      FROM store_sales, date_dim, customer
      WHERE ss_sold_date_sk = d_date_sk
        AND ss_customer_sk = c_customer_sk
        AND d_month_seq BETWEEN 1200 AND 1200 + 11
      INTERSECT
      SELECT DISTINCT c_last_name, c_first_name, d_date
      FROM catalog_sales, date_dim, customer
      WHERE cs_sold_date_sk = d_date_sk
        AND cs_bill_customer_sk = c_customer_sk
        AND d_month_seq BETWEEN 1200 AND 1200 + 11
      INTERSECT
      SELECT DISTINCT c_last_name, c_first_name, d_date
      FROM web_sales, date_dim, customer
      WHERE ws_sold_date_sk = d_date_sk
        AND ws_bill_customer_sk = c_customer_sk
        AND d_month_seq BETWEEN 1200 AND 1200 + 11) hot_cust
LIMIT 100
""",
    39: """
WITH inv AS (
  SELECT w_warehouse_name, w_warehouse_sk, i_item_sk, d_moy, stdev, mean,
         CASE mean WHEN 0 THEN NULL ELSE stdev / mean END AS cov
  FROM (SELECT w_warehouse_name, w_warehouse_sk, i_item_sk, d_moy,
               STDDEV(inv_quantity_on_hand) AS stdev,
               AVG(inv_quantity_on_hand) AS mean
        FROM inventory, item, warehouse, date_dim
        WHERE inv_item_sk = i_item_sk
          AND inv_warehouse_sk = w_warehouse_sk
          AND inv_date_sk = d_date_sk
          AND d_year = 2000
        GROUP BY w_warehouse_name, w_warehouse_sk, i_item_sk, d_moy) foo
  WHERE CASE mean WHEN 0 THEN 0 ELSE stdev / mean END > 1
)
SELECT inv1.w_warehouse_sk AS wsk1, inv1.i_item_sk AS isk1,
       inv1.d_moy AS moy1, inv1.mean AS mean1, inv1.cov AS cov1,
       inv2.w_warehouse_sk AS wsk2, inv2.i_item_sk AS isk2,
       inv2.d_moy AS moy2, inv2.mean AS mean2, inv2.cov AS cov2
FROM inv inv1, inv inv2
WHERE inv1.i_item_sk = inv2.i_item_sk
  AND inv1.w_warehouse_sk = inv2.w_warehouse_sk
  AND inv1.d_moy = 1
  AND inv2.d_moy = 1 + 1
ORDER BY wsk1, isk1, moy1, mean1, cov1
LIMIT 100
""",
    40: """
SELECT w_state, i_item_id,
       SUM(CASE WHEN d_date < DATE '2000-03-11'
                THEN cs_sales_price - COALESCE(cr_refunded_cash, 0)
                ELSE 0 END) AS sales_before,
       SUM(CASE WHEN d_date >= DATE '2000-03-11'
                THEN cs_sales_price - COALESCE(cr_refunded_cash, 0)
                ELSE 0 END) AS sales_after
FROM catalog_sales
LEFT JOIN catalog_returns
  ON cs_order_number = cr_order_number AND cs_item_sk = cr_item_sk
, warehouse, item, date_dim
WHERE i_current_price BETWEEN 0.99 AND 1.49
  AND i_item_sk = cs_item_sk
  AND cs_warehouse_sk = w_warehouse_sk
  AND cs_sold_date_sk = d_date_sk
  AND d_date BETWEEN DATE '2000-03-11' - INTERVAL '30' DAY
                 AND DATE '2000-03-11' + INTERVAL '30' DAY
GROUP BY w_state, i_item_id
ORDER BY w_state, i_item_id
LIMIT 100
""",
    41: """
SELECT DISTINCT i_product_name
FROM item i1
WHERE i_manufact_id BETWEEN 70 AND 110
  AND EXISTS (
    SELECT * FROM item i2
    WHERE i2.i_manufact = i1.i_manufact
      AND ((i2.i_category = 'Women'
            AND i2.i_color IN ('powder', 'orchid')
            AND i2.i_units IN ('Oz', 'Each')
            AND i2.i_size IN ('medium', 'N/A'))
           OR (i2.i_category = 'Men'
               AND i2.i_color IN ('slate', 'navy')
               AND i2.i_units IN ('Bunch', 'Ton')
               AND i2.i_size IN ('large', 'petite'))))
ORDER BY i_product_name
LIMIT 100
""",
    42: """
SELECT d_year, i_category_id, i_category,
       SUM(ss_ext_sales_price) AS sum_sales
FROM date_dim, store_sales, item
WHERE d_date_sk = ss_sold_date_sk
  AND ss_item_sk = i_item_sk
  AND i_manager_id = 1
  AND d_moy = 11
  AND d_year = 2000
GROUP BY d_year, i_category_id, i_category
ORDER BY sum_sales DESC, d_year, i_category_id, i_category
LIMIT 100
""",
    43: """
SELECT s_store_name, s_store_sk,
       SUM(CASE WHEN d_day_name = 'Sunday' THEN ss_sales_price
                ELSE NULL END) AS sun_sales,
       SUM(CASE WHEN d_day_name = 'Monday' THEN ss_sales_price
                ELSE NULL END) AS mon_sales,
       SUM(CASE WHEN d_day_name = 'Friday' THEN ss_sales_price
                ELSE NULL END) AS fri_sales,
       SUM(CASE WHEN d_day_name = 'Saturday' THEN ss_sales_price
                ELSE NULL END) AS sat_sales
FROM date_dim, store_sales, store
WHERE d_date_sk = ss_sold_date_sk
  AND s_store_sk = ss_store_sk
  AND s_gmt_offset = -5.0
  AND d_year = 2000
GROUP BY s_store_name, s_store_sk
ORDER BY s_store_name, s_store_sk
LIMIT 100
""",
    44: """
SELECT asceding.rnk, i1.i_product_name best_performing,
       i2.i_product_name worst_performing
FROM (SELECT *
      FROM (SELECT item_sk, RANK() OVER (ORDER BY rank_col ASC) rnk
            FROM (SELECT ss_item_sk item_sk, AVG(ss_net_profit) rank_col
                  FROM store_sales ss1
                  WHERE ss_store_sk = 4
                  GROUP BY ss_item_sk
                  HAVING AVG(ss_net_profit) > 0.9 *
                    (SELECT AVG(ss_net_profit) rank_col
                     FROM store_sales
                     WHERE ss_store_sk = 4 AND ss_addr_sk IS NULL
                     GROUP BY ss_store_sk)) v1) v11
      WHERE rnk < 11) asceding,
     (SELECT *
      FROM (SELECT item_sk, RANK() OVER (ORDER BY rank_col DESC) rnk
            FROM (SELECT ss_item_sk item_sk, AVG(ss_net_profit) rank_col
                  FROM store_sales ss1
                  WHERE ss_store_sk = 4
                  GROUP BY ss_item_sk
                  HAVING AVG(ss_net_profit) > 0.9 *
                    (SELECT AVG(ss_net_profit) rank_col
                     FROM store_sales
                     WHERE ss_store_sk = 4 AND ss_addr_sk IS NULL
                     GROUP BY ss_store_sk)) v2) v21
      WHERE rnk < 11) descending,
     item i1, item i2
WHERE asceding.rnk = descending.rnk
  AND i1.i_item_sk = asceding.item_sk
  AND i2.i_item_sk = descending.item_sk
ORDER BY asceding.rnk
LIMIT 100
""",
    45: """
SELECT ca_zip, ca_city, SUM(ws_sales_price) AS total_sales
FROM web_sales, customer, customer_address, date_dim, item
WHERE ws_bill_customer_sk = c_customer_sk
  AND c_current_addr_sk = ca_address_sk
  AND ws_item_sk = i_item_sk
  AND (SUBSTR(ca_zip, 1, 5) IN ('85669', '86197', '88274', '83405',
                                '86475', '85392', '85460', '80348',
                                '81792')
       OR i_item_id IN (SELECT i_item_id FROM item
                        WHERE i_item_sk IN (2, 3, 5, 7, 11, 13, 17, 19,
                                            23, 29)))
  AND ws_sold_date_sk = d_date_sk
  AND d_qoy = 2 AND d_year = 2000
GROUP BY ca_zip, ca_city
ORDER BY ca_zip, ca_city
LIMIT 100
""",
    46: """
WITH dn AS (
  SELECT ss_ticket_number, ss_customer_sk, ca_city AS bought_city,
         SUM(ss_coupon_amt) AS amt, SUM(ss_net_profit) AS profit
  FROM store_sales, date_dim, store, household_demographics,
       customer_address
  WHERE ss_sold_date_sk = d_date_sk
    AND ss_store_sk = s_store_sk
    AND ss_hdemo_sk = hd_demo_sk
    AND ss_addr_sk = ca_address_sk
    AND (hd_dep_count = 4 OR hd_vehicle_count = 3)
    AND d_dow IN (5, 6)
    AND d_year = 2000
    AND s_city IN ('rivertown', 'lakeside')
  GROUP BY ss_ticket_number, ss_customer_sk, ca_city
)
SELECT c_last_name, c_first_name, ca_city AS current_city, bought_city,
       ss_ticket_number, amt, profit
FROM dn, customer, customer_address current_addr
WHERE ss_customer_sk = c_customer_sk
  AND c_current_addr_sk = current_addr.ca_address_sk
  AND current_addr.ca_city <> bought_city
ORDER BY c_last_name, c_first_name, current_city, bought_city,
         ss_ticket_number
LIMIT 100
""",
    47: """
WITH v1 AS (
  SELECT i_category, i_brand, s_store_name, s_company_name,
         d_year, d_moy,
         SUM(ss_sales_price) AS sum_sales
  FROM item, store_sales, date_dim, store
  WHERE ss_item_sk = i_item_sk
    AND ss_sold_date_sk = d_date_sk
    AND ss_store_sk = s_store_sk
    AND (d_year = 2000
         OR (d_year = 2000 - 1 AND d_moy = 12)
         OR (d_year = 2000 + 1 AND d_moy = 1))
  GROUP BY i_category, i_brand, s_store_name, s_company_name,
           d_year, d_moy
), v1w AS (
  SELECT i_category, i_brand, s_store_name, s_company_name, d_year, d_moy,
         sum_sales,
         AVG(sum_sales) OVER (
             PARTITION BY i_category, i_brand, s_store_name,
                          s_company_name, d_year) AS avg_monthly_sales,
         RANK() OVER (
             PARTITION BY i_category, i_brand, s_store_name,
                          s_company_name
             ORDER BY d_year, d_moy) AS rn
  FROM v1
), v2 AS (
  SELECT v1w.i_category, v1w.i_brand, v1w.s_store_name,
         v1w.s_company_name, v1w.d_year, v1w.d_moy,
         v1w.avg_monthly_sales, v1w.sum_sales,
         v1w_lag.sum_sales AS psum, v1w_lead.sum_sales AS nsum
  FROM v1w, v1w v1w_lag, v1w v1w_lead
  WHERE v1w.i_category = v1w_lag.i_category
    AND v1w.i_category = v1w_lead.i_category
    AND v1w.i_brand = v1w_lag.i_brand
    AND v1w.i_brand = v1w_lead.i_brand
    AND v1w.s_store_name = v1w_lag.s_store_name
    AND v1w.s_store_name = v1w_lead.s_store_name
    AND v1w.s_company_name = v1w_lag.s_company_name
    AND v1w.s_company_name = v1w_lead.s_company_name
    AND v1w.rn = v1w_lag.rn + 1
    AND v1w.rn = v1w_lead.rn - 1
)
SELECT i_category, i_brand, s_store_name, s_company_name, d_year, d_moy,
       avg_monthly_sales, sum_sales, psum, nsum
FROM v2
WHERE d_year = 2000
  AND avg_monthly_sales > 0
  AND CASE WHEN avg_monthly_sales > 0
           THEN abs(sum_sales - avg_monthly_sales) / avg_monthly_sales
           ELSE NULL END > 0.1
ORDER BY sum_sales - avg_monthly_sales, i_category, i_brand,
         s_store_name, s_company_name, d_year, d_moy
LIMIT 100
""",
    48: """
SELECT SUM(ss_quantity) AS total_q
FROM store_sales, store, customer_demographics, customer_address, date_dim
WHERE s_store_sk = ss_store_sk
  AND ss_sold_date_sk = d_date_sk AND d_year = 2000
  AND ((cd_demo_sk = ss_cdemo_sk AND cd_marital_status = 'M'
        AND cd_education_status = 'College'
        AND ss_sales_price BETWEEN 100.00 AND 150.00)
       OR (cd_demo_sk = ss_cdemo_sk AND cd_marital_status = 'D'
           AND cd_education_status = 'Primary'
           AND ss_sales_price BETWEEN 50.00 AND 100.00)
       OR (cd_demo_sk = ss_cdemo_sk AND cd_marital_status = 'W'
           AND cd_education_status = 'Secondary'
           AND ss_sales_price BETWEEN 150.00 AND 200.00))
  AND ((ss_addr_sk = ca_address_sk AND ca_country = 'United States'
        AND ca_state IN ('TX', 'NM', 'OR')
        AND ss_net_profit BETWEEN 0 AND 2000)
       OR (ss_addr_sk = ca_address_sk AND ca_country = 'United States'
           AND ca_state IN ('CA', 'NY', 'WA')
           AND ss_net_profit BETWEEN 150 AND 3000)
       OR (ss_addr_sk = ca_address_sk AND ca_country = 'United States'
           AND ca_state IN ('TN', 'GA', 'KY')
           AND ss_net_profit BETWEEN 50 AND 25000))
""",
    49: """
SELECT channel, item, return_ratio, return_rank, currency_rank
FROM
  (SELECT 'web' AS channel, web.item, web.return_ratio,
          web.return_rank, web.currency_rank
   FROM (SELECT item, return_ratio, currency_ratio,
                RANK() OVER (ORDER BY return_ratio) AS return_rank,
                RANK() OVER (ORDER BY currency_ratio) AS currency_rank
         FROM (SELECT ws.ws_item_sk AS item,
                      (SUM(COALESCE(wr.wr_return_quantity, 0)) * 1.0000)
                        / SUM(COALESCE(ws.ws_quantity, 0)) AS return_ratio,
                      (SUM(COALESCE(wr.wr_return_amt, 0)) * 1.0000)
                        / SUM(COALESCE(ws.ws_net_paid, 0))
                        AS currency_ratio
               FROM web_sales ws
               LEFT OUTER JOIN web_returns wr
                 ON (ws.ws_order_number = wr.wr_order_number
                     AND ws.ws_item_sk = wr.wr_item_sk), date_dim
               WHERE wr.wr_return_amt > 100
                 AND ws.ws_net_profit > 1 AND ws.ws_net_paid > 0
                 AND ws.ws_quantity > 0 AND ws_sold_date_sk = d_date_sk
                 AND d_year = 2000 AND d_moy = 12
               GROUP BY ws.ws_item_sk) in_web) web
   WHERE web.return_rank <= 10 OR web.currency_rank <= 10
   UNION
   SELECT 'catalog' AS channel, catalog.item, catalog.return_ratio,
          catalog.return_rank, catalog.currency_rank
   FROM (SELECT item, return_ratio, currency_ratio,
                RANK() OVER (ORDER BY return_ratio) AS return_rank,
                RANK() OVER (ORDER BY currency_ratio) AS currency_rank
         FROM (SELECT cs.cs_item_sk AS item,
                      (SUM(COALESCE(cr.cr_return_quantity, 0)) * 1.0000)
                        / SUM(COALESCE(cs.cs_quantity, 0)) AS return_ratio,
                      (SUM(COALESCE(cr.cr_return_amount, 0)) * 1.0000)
                        / SUM(COALESCE(cs.cs_net_paid, 0))
                        AS currency_ratio
               FROM catalog_sales cs
               LEFT OUTER JOIN catalog_returns cr
                 ON (cs.cs_order_number = cr.cr_order_number
                     AND cs.cs_item_sk = cr.cr_item_sk), date_dim
               WHERE cr.cr_return_amount > 100
                 AND cs.cs_net_profit > 1 AND cs.cs_net_paid > 0
                 AND cs.cs_quantity > 0 AND cs_sold_date_sk = d_date_sk
                 AND d_year = 2000 AND d_moy = 12
               GROUP BY cs.cs_item_sk) in_cat) catalog
   WHERE catalog.return_rank <= 10 OR catalog.currency_rank <= 10
   UNION
   SELECT 'store' AS channel, store.item, store.return_ratio,
          store.return_rank, store.currency_rank
   FROM (SELECT item, return_ratio, currency_ratio,
                RANK() OVER (ORDER BY return_ratio) AS return_rank,
                RANK() OVER (ORDER BY currency_ratio) AS currency_rank
         FROM (SELECT sts.ss_item_sk AS item,
                      (SUM(COALESCE(sr.sr_return_quantity, 0)) * 1.0000)
                        / SUM(COALESCE(sts.ss_quantity, 0))
                        AS return_ratio,
                      (SUM(COALESCE(sr.sr_return_amt, 0)) * 1.0000)
                        / SUM(COALESCE(sts.ss_net_paid, 0))
                        AS currency_ratio
               FROM store_sales sts
               LEFT OUTER JOIN store_returns sr
                 ON (sts.ss_ticket_number = sr.sr_ticket_number
                     AND sts.ss_item_sk = sr.sr_item_sk), date_dim
               WHERE sr.sr_return_amt > 100
                 AND sts.ss_net_profit > 1 AND sts.ss_net_paid > 0
                 AND sts.ss_quantity > 0 AND ss_sold_date_sk = d_date_sk
                 AND d_year = 2000 AND d_moy = 12
               GROUP BY sts.ss_item_sk) in_store) store
   WHERE store.return_rank <= 10 OR store.currency_rank <= 10) sq1
ORDER BY channel, return_rank, currency_rank, item
LIMIT 100
""",
    50: """
SELECT s_store_name, s_company_id, s_street_number, s_street_name,
       SUM(CASE WHEN sr_returned_date_sk - ss_sold_date_sk <= 30
                THEN 1 ELSE 0 END) AS days_30,
       SUM(CASE WHEN sr_returned_date_sk - ss_sold_date_sk > 30
                 AND sr_returned_date_sk - ss_sold_date_sk <= 60
                THEN 1 ELSE 0 END) AS days_31_60,
       SUM(CASE WHEN sr_returned_date_sk - ss_sold_date_sk > 60
                 AND sr_returned_date_sk - ss_sold_date_sk <= 90
                THEN 1 ELSE 0 END) AS days_61_90,
       SUM(CASE WHEN sr_returned_date_sk - ss_sold_date_sk > 90
                 AND sr_returned_date_sk - ss_sold_date_sk <= 120
                THEN 1 ELSE 0 END) AS days_91_120,
       SUM(CASE WHEN sr_returned_date_sk - ss_sold_date_sk > 120
                THEN 1 ELSE 0 END) AS days_over_120
FROM store_sales, store_returns, store, date_dim d1, date_dim d2
WHERE d2.d_year = 2000 AND d2.d_moy = 8
  AND ss_ticket_number = sr_ticket_number AND ss_item_sk = sr_item_sk
  AND ss_sold_date_sk = d1.d_date_sk
  AND sr_returned_date_sk = d2.d_date_sk
  AND ss_customer_sk = sr_customer_sk
  AND ss_store_sk = s_store_sk
GROUP BY s_store_name, s_company_id, s_street_number, s_street_name
ORDER BY s_store_name, s_company_id
LIMIT 100
""",
    51: """
WITH web_v1 AS
  (SELECT ws_item_sk item_sk, d_date,
          SUM(SUM(ws_sales_price))
            OVER (PARTITION BY ws_item_sk ORDER BY d_date
                  ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW)
            cume_sales
   FROM web_sales, date_dim
   WHERE ws_sold_date_sk = d_date_sk
     AND d_month_seq BETWEEN 1200 AND 1200 + 11
     AND ws_item_sk IS NOT NULL
   GROUP BY ws_item_sk, d_date),
     store_v1 AS
  (SELECT ss_item_sk item_sk, d_date,
          SUM(SUM(ss_sales_price))
            OVER (PARTITION BY ss_item_sk ORDER BY d_date
                  ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW)
            cume_sales
   FROM store_sales, date_dim
   WHERE ss_sold_date_sk = d_date_sk
     AND d_month_seq BETWEEN 1200 AND 1200 + 11
     AND ss_item_sk IS NOT NULL
   GROUP BY ss_item_sk, d_date)
SELECT *
FROM (SELECT item_sk, d_date, web_sales, store_sales,
             MAX(web_sales)
               OVER (PARTITION BY item_sk ORDER BY d_date
                     ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW)
               web_cumulative,
             MAX(store_sales)
               OVER (PARTITION BY item_sk ORDER BY d_date
                     ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW)
               store_cumulative
      FROM (SELECT CASE WHEN web.item_sk IS NOT NULL THEN web.item_sk
                        ELSE store.item_sk END item_sk,
                   CASE WHEN web.d_date IS NOT NULL THEN web.d_date
                        ELSE store.d_date END d_date,
                   web.cume_sales web_sales,
                   store.cume_sales store_sales
            FROM web_v1 web
            FULL OUTER JOIN store_v1 store
              ON (web.item_sk = store.item_sk
                  AND web.d_date = store.d_date)) x) y
WHERE web_cumulative > store_cumulative
ORDER BY item_sk, d_date
LIMIT 100
""",
    52: """
SELECT d_year, i_brand_id, i_brand, SUM(ss_ext_sales_price) AS ext_price
FROM date_dim, store_sales, item
WHERE d_date_sk = ss_sold_date_sk
  AND ss_item_sk = i_item_sk
  AND i_manager_id = 1
  AND d_moy = 11
  AND d_year = 2000
GROUP BY d_year, i_brand_id, i_brand
ORDER BY d_year, ext_price DESC, i_brand_id
LIMIT 100
""",
    53: """
WITH quarterly AS (
  SELECT i_manufact_id, d_qoy, SUM(ss_sales_price) AS sum_sales
  FROM store_sales, item, date_dim
  WHERE ss_item_sk = i_item_sk
    AND ss_sold_date_sk = d_date_sk
    AND d_year = 2000
    AND i_category IN ('Books', 'Home', 'Electronics')
  GROUP BY i_manufact_id, d_qoy
)
SELECT i_manufact_id, sum_sales,
       AVG(sum_sales) OVER (PARTITION BY i_manufact_id)
           AS avg_quarterly_sales
FROM quarterly
ORDER BY avg_quarterly_sales DESC, sum_sales, i_manufact_id
LIMIT 100
""",
    54: """
WITH my_customers AS
  (SELECT DISTINCT c_customer_sk, c_current_addr_sk
   FROM (SELECT cs_sold_date_sk sold_date_sk,
                cs_bill_customer_sk customer_sk, cs_item_sk item_sk
         FROM catalog_sales
         UNION ALL
         SELECT ws_sold_date_sk, ws_bill_customer_sk, ws_item_sk
         FROM web_sales) cs_or_ws_sales, item, date_dim, customer
   WHERE sold_date_sk = d_date_sk AND item_sk = i_item_sk
     AND i_category = 'Women' AND i_class = 'dresses'
     AND c_customer_sk = cs_or_ws_sales.customer_sk
     AND d_moy = 12 AND d_year = 1999),
     my_revenue AS
  (SELECT c_customer_sk, SUM(ss_ext_sales_price) AS revenue
   FROM my_customers, store_sales, customer_address, store, date_dim
   WHERE c_current_addr_sk = ca_address_sk
     AND ca_county = s_county AND ca_state = s_state
     AND ss_sold_date_sk = d_date_sk
     AND c_customer_sk = ss_customer_sk
     AND d_month_seq BETWEEN (SELECT DISTINCT d_month_seq + 1
                              FROM date_dim
                              WHERE d_year = 1999 AND d_moy = 12)
                         AND (SELECT DISTINCT d_month_seq + 3
                              FROM date_dim
                              WHERE d_year = 1999 AND d_moy = 12)
   GROUP BY c_customer_sk),
     segments AS
  (SELECT CAST(ROUND(revenue / 50) AS INT) AS segment FROM my_revenue)
SELECT segment, COUNT(*) AS num_customers, segment * 50 AS segment_base
FROM segments
GROUP BY segment
ORDER BY segment, num_customers, segment_base
LIMIT 100
""",
    55: """
SELECT i_brand_id, i_brand, SUM(ss_ext_sales_price) AS ext_price
FROM date_dim, store_sales, item
WHERE d_date_sk = ss_sold_date_sk
  AND ss_item_sk = i_item_sk
  AND i_manager_id = 28
  AND d_moy = 11
  AND d_year = 1999
GROUP BY i_brand_id, i_brand
ORDER BY ext_price DESC, i_brand_id
LIMIT 100
""",
    56: """
WITH ss AS (
  SELECT i_item_id, SUM(ss_ext_sales_price) AS total_sales
  FROM store_sales, date_dim, customer_address, item
  WHERE i_item_id IN (SELECT i_item_id FROM item
                      WHERE i_color IN ('slate', 'blanched', 'burnished'))
    AND ss_item_sk = i_item_sk
    AND ss_sold_date_sk = d_date_sk
    AND d_year = 2000 AND d_moy = 2
    AND ss_addr_sk = ca_address_sk
    AND ca_gmt_offset = -5
  GROUP BY i_item_id
), cs AS (
  SELECT i_item_id, SUM(cs_ext_sales_price) AS total_sales
  FROM catalog_sales, date_dim, customer_address, item
  WHERE i_item_id IN (SELECT i_item_id FROM item
                      WHERE i_color IN ('slate', 'blanched', 'burnished'))
    AND cs_item_sk = i_item_sk
    AND cs_sold_date_sk = d_date_sk
    AND d_year = 2000 AND d_moy = 2
    AND cs_bill_addr_sk = ca_address_sk
    AND ca_gmt_offset = -5
  GROUP BY i_item_id
), ws AS (
  SELECT i_item_id, SUM(ws_ext_sales_price) AS total_sales
  FROM web_sales, date_dim, customer_address, item
  WHERE i_item_id IN (SELECT i_item_id FROM item
                      WHERE i_color IN ('slate', 'blanched', 'burnished'))
    AND ws_item_sk = i_item_sk
    AND ws_sold_date_sk = d_date_sk
    AND d_year = 2000 AND d_moy = 2
    AND ws_bill_addr_sk = ca_address_sk
    AND ca_gmt_offset = -5
  GROUP BY i_item_id
)
SELECT i_item_id, SUM(total_sales) AS total_sales
FROM (SELECT * FROM ss UNION ALL SELECT * FROM cs
      UNION ALL SELECT * FROM ws) tmp1
GROUP BY i_item_id
ORDER BY total_sales, i_item_id
LIMIT 100
""",
    57: """
WITH v1 AS
  (SELECT i_category, i_brand, cc_name, d_year, d_moy,
          SUM(cs_sales_price) sum_sales,
          AVG(SUM(cs_sales_price))
            OVER (PARTITION BY i_category, i_brand, cc_name, d_year)
            avg_monthly_sales,
          RANK() OVER (PARTITION BY i_category, i_brand, cc_name
                       ORDER BY d_year, d_moy) rn
   FROM item, catalog_sales, date_dim, call_center
   WHERE cs_item_sk = i_item_sk AND cs_sold_date_sk = d_date_sk
     AND cc_call_center_sk = cs_call_center_sk
     AND (d_year = 2000
          OR (d_year = 2000 - 1 AND d_moy = 12)
          OR (d_year = 2000 + 1 AND d_moy = 1))
   GROUP BY i_category, i_brand, cc_name, d_year, d_moy),
     v2 AS
  (SELECT v1.i_category, v1.i_brand, v1.cc_name, v1.d_year, v1.d_moy,
          v1.avg_monthly_sales, v1.sum_sales,
          v1_lag.sum_sales psum, v1_lead.sum_sales nsum
   FROM v1, v1 v1_lag, v1 v1_lead
   WHERE v1.i_category = v1_lag.i_category
     AND v1.i_category = v1_lead.i_category
     AND v1.i_brand = v1_lag.i_brand
     AND v1.i_brand = v1_lead.i_brand
     AND v1.cc_name = v1_lag.cc_name
     AND v1.cc_name = v1_lead.cc_name
     AND v1.rn = v1_lag.rn + 1
     AND v1.rn = v1_lead.rn - 1)
SELECT *
FROM v2
WHERE d_year = 2000
  AND avg_monthly_sales > 0
  AND CASE WHEN avg_monthly_sales > 0
           THEN ABS(sum_sales - avg_monthly_sales) / avg_monthly_sales
           ELSE NULL END > 0.1
ORDER BY sum_sales - avg_monthly_sales, cc_name
LIMIT 100
""",
    58: """
WITH ss_items AS
  (SELECT i_item_id item_id, SUM(ss_ext_sales_price) ss_item_rev
   FROM store_sales, item, date_dim
   WHERE ss_item_sk = i_item_sk
     AND d_date IN (SELECT d_date FROM date_dim
                    WHERE d_week_seq = (SELECT d_week_seq FROM date_dim
                                        WHERE d_date
                                          = CAST('2000-01-03' AS DATE)))
     AND ss_sold_date_sk = d_date_sk
   GROUP BY i_item_id),
     cs_items AS
  (SELECT i_item_id item_id, SUM(cs_ext_sales_price) cs_item_rev
   FROM catalog_sales, item, date_dim
   WHERE cs_item_sk = i_item_sk
     AND d_date IN (SELECT d_date FROM date_dim
                    WHERE d_week_seq = (SELECT d_week_seq FROM date_dim
                                        WHERE d_date
                                          = CAST('2000-01-03' AS DATE)))
     AND cs_sold_date_sk = d_date_sk
   GROUP BY i_item_id),
     ws_items AS
  (SELECT i_item_id item_id, SUM(ws_ext_sales_price) ws_item_rev
   FROM web_sales, item, date_dim
   WHERE ws_item_sk = i_item_sk
     AND d_date IN (SELECT d_date FROM date_dim
                    WHERE d_week_seq = (SELECT d_week_seq FROM date_dim
                                        WHERE d_date
                                          = CAST('2000-01-03' AS DATE)))
     AND ws_sold_date_sk = d_date_sk
   GROUP BY i_item_id)
SELECT ss_items.item_id, ss_item_rev,
       (ss_item_rev * 1.0000)
         / ((ss_item_rev + cs_item_rev + ws_item_rev) / 3) * 100 ss_dev,
       cs_item_rev,
       (cs_item_rev * 1.0000)
         / ((ss_item_rev + cs_item_rev + ws_item_rev) / 3) * 100 cs_dev,
       ws_item_rev,
       (ws_item_rev * 1.0000)
         / ((ss_item_rev + cs_item_rev + ws_item_rev) / 3) * 100 ws_dev,
       (ss_item_rev + cs_item_rev + ws_item_rev) / 3 average
FROM ss_items, cs_items, ws_items
WHERE ss_items.item_id = cs_items.item_id
  AND ss_items.item_id = ws_items.item_id
  AND ss_item_rev BETWEEN 0.9 * cs_item_rev AND 1.1 * cs_item_rev
  AND ss_item_rev BETWEEN 0.9 * ws_item_rev AND 1.1 * ws_item_rev
  AND cs_item_rev BETWEEN 0.9 * ss_item_rev AND 1.1 * ss_item_rev
  AND cs_item_rev BETWEEN 0.9 * ws_item_rev AND 1.1 * ws_item_rev
  AND ws_item_rev BETWEEN 0.9 * ss_item_rev AND 1.1 * ss_item_rev
  AND ws_item_rev BETWEEN 0.9 * cs_item_rev AND 1.1 * cs_item_rev
ORDER BY ss_items.item_id, ss_item_rev
LIMIT 100
""",
    59: """
WITH wss AS (
  SELECT d_week_seq, ss_store_sk,
         SUM(CASE WHEN d_day_name = 'Sunday' THEN ss_sales_price END)
             AS sun_sales,
         SUM(CASE WHEN d_day_name = 'Monday' THEN ss_sales_price END)
             AS mon_sales,
         SUM(CASE WHEN d_day_name = 'Tuesday' THEN ss_sales_price END)
             AS tue_sales,
         SUM(CASE WHEN d_day_name = 'Wednesday' THEN ss_sales_price END)
             AS wed_sales,
         SUM(CASE WHEN d_day_name = 'Thursday' THEN ss_sales_price END)
             AS thu_sales,
         SUM(CASE WHEN d_day_name = 'Friday' THEN ss_sales_price END)
             AS fri_sales,
         SUM(CASE WHEN d_day_name = 'Saturday' THEN ss_sales_price END)
             AS sat_sales
  FROM store_sales, date_dim
  WHERE d_date_sk = ss_sold_date_sk
  GROUP BY d_week_seq, ss_store_sk
)
SELECT s_store_name1, s_store_id1, d_week_seq1,
       sun_sales1 / sun_sales2 AS r_sun, mon_sales1 / mon_sales2 AS r_mon,
       tue_sales1 / tue_sales2 AS r_tue, wed_sales1 / wed_sales2 AS r_wed,
       thu_sales1 / thu_sales2 AS r_thu, fri_sales1 / fri_sales2 AS r_fri,
       sat_sales1 / sat_sales2 AS r_sat
FROM (SELECT s_store_name AS s_store_name1, wss.d_week_seq AS d_week_seq1,
             s_store_id AS s_store_id1, sun_sales AS sun_sales1,
             mon_sales AS mon_sales1, tue_sales AS tue_sales1,
             wed_sales AS wed_sales1, thu_sales AS thu_sales1,
             fri_sales AS fri_sales1, sat_sales AS sat_sales1
      FROM wss, store, date_dim d
      WHERE d.d_week_seq = wss.d_week_seq
        AND ss_store_sk = s_store_sk
        AND d_month_seq BETWEEN 1200 AND 1200 + 11) y,
     (SELECT s_store_name AS s_store_name2, wss.d_week_seq AS d_week_seq2,
             s_store_id AS s_store_id2, sun_sales AS sun_sales2,
             mon_sales AS mon_sales2, tue_sales AS tue_sales2,
             wed_sales AS wed_sales2, thu_sales AS thu_sales2,
             fri_sales AS fri_sales2, sat_sales AS sat_sales2
      FROM wss, store, date_dim d
      WHERE d.d_week_seq = wss.d_week_seq
        AND ss_store_sk = s_store_sk
        AND d_month_seq BETWEEN 1212 AND 1212 + 11) x
WHERE s_store_id1 = s_store_id2
  AND d_week_seq1 = d_week_seq2 - 52
ORDER BY s_store_name1, s_store_id1, d_week_seq1
LIMIT 100
""",
    60: """
WITH ss AS (
  SELECT i_item_id, SUM(ss_ext_sales_price) AS total_sales
  FROM store_sales, date_dim, customer_address, item
  WHERE i_item_id IN (SELECT i_item_id FROM item
                      WHERE i_category IN ('Music'))
    AND ss_item_sk = i_item_sk
    AND ss_sold_date_sk = d_date_sk
    AND d_year = 2000 AND d_moy = 9
    AND ss_addr_sk = ca_address_sk
    AND ca_gmt_offset = -5
  GROUP BY i_item_id
), cs AS (
  SELECT i_item_id, SUM(cs_ext_sales_price) AS total_sales
  FROM catalog_sales, date_dim, customer_address, item
  WHERE i_item_id IN (SELECT i_item_id FROM item
                      WHERE i_category IN ('Music'))
    AND cs_item_sk = i_item_sk
    AND cs_sold_date_sk = d_date_sk
    AND d_year = 2000 AND d_moy = 9
    AND cs_bill_addr_sk = ca_address_sk
    AND ca_gmt_offset = -5
  GROUP BY i_item_id
), ws AS (
  SELECT i_item_id, SUM(ws_ext_sales_price) AS total_sales
  FROM web_sales, date_dim, customer_address, item
  WHERE i_item_id IN (SELECT i_item_id FROM item
                      WHERE i_category IN ('Music'))
    AND ws_item_sk = i_item_sk
    AND ws_sold_date_sk = d_date_sk
    AND d_year = 2000 AND d_moy = 9
    AND ws_bill_addr_sk = ca_address_sk
    AND ca_gmt_offset = -5
  GROUP BY i_item_id
)
SELECT i_item_id, SUM(total_sales) AS total_sales
FROM (SELECT * FROM ss UNION ALL SELECT * FROM cs
      UNION ALL SELECT * FROM ws) tmp1
GROUP BY i_item_id
ORDER BY i_item_id, total_sales
LIMIT 100
""",
    61: """
SELECT promotions, total,
       CAST(promotions AS DOUBLE) / CAST(total AS DOUBLE) * 100 AS ratio
FROM (SELECT SUM(ss_ext_sales_price) AS promotions
      FROM store_sales, store, promotion, date_dim, customer,
           customer_address, item
      WHERE ss_sold_date_sk = d_date_sk
        AND ss_store_sk = s_store_sk
        AND ss_promo_sk = p_promo_sk
        AND ss_customer_sk = c_customer_sk
        AND ca_address_sk = c_current_addr_sk
        AND ss_item_sk = i_item_sk
        AND ca_gmt_offset = -5
        AND i_category = 'Jewelry'
        AND (p_channel_dmail = 'Y' OR p_channel_email = 'Y'
             OR p_channel_tv = 'Y')
        AND s_gmt_offset = -5
        AND d_year = 2000 AND d_moy = 11) promotional_sales,
     (SELECT SUM(ss_ext_sales_price) AS total
      FROM store_sales, store, date_dim, customer, customer_address, item
      WHERE ss_sold_date_sk = d_date_sk
        AND ss_store_sk = s_store_sk
        AND ss_customer_sk = c_customer_sk
        AND ca_address_sk = c_current_addr_sk
        AND ss_item_sk = i_item_sk
        AND ca_gmt_offset = -5
        AND i_category = 'Jewelry'
        AND s_gmt_offset = -5
        AND d_year = 2000 AND d_moy = 11) all_sales
ORDER BY promotions, total
LIMIT 100
""",
    62: """
SELECT substr(w_warehouse_name, 1, 20) AS wh, sm_type, web_name,
       SUM(CASE WHEN ws_ship_date_sk - ws_sold_date_sk <= 30
                THEN 1 ELSE 0 END) AS days_30,
       SUM(CASE WHEN ws_ship_date_sk - ws_sold_date_sk > 30
                 AND ws_ship_date_sk - ws_sold_date_sk <= 60
                THEN 1 ELSE 0 END) AS days_31_60,
       SUM(CASE WHEN ws_ship_date_sk - ws_sold_date_sk > 60
                 AND ws_ship_date_sk - ws_sold_date_sk <= 90
                THEN 1 ELSE 0 END) AS days_61_90,
       SUM(CASE WHEN ws_ship_date_sk - ws_sold_date_sk > 90
                 AND ws_ship_date_sk - ws_sold_date_sk <= 120
                THEN 1 ELSE 0 END) AS days_91_120,
       SUM(CASE WHEN ws_ship_date_sk - ws_sold_date_sk > 120
                THEN 1 ELSE 0 END) AS days_over_120
FROM web_sales, warehouse, ship_mode, web_site, date_dim
WHERE d_month_seq BETWEEN 1212 AND 1212 + 11
  AND ws_ship_date_sk = d_date_sk
  AND ws_warehouse_sk = w_warehouse_sk
  AND ws_ship_mode_sk = sm_ship_mode_sk
  AND ws_web_site_sk = web_site_sk
GROUP BY substr(w_warehouse_name, 1, 20), sm_type, web_name
ORDER BY wh, sm_type, web_name
LIMIT 100
""",
    63: """
WITH tmp1 AS (
  SELECT i_manager_id, d_moy, SUM(ss_sales_price) AS sum_sales
  FROM item, store_sales, date_dim, store
  WHERE ss_item_sk = i_item_sk
    AND ss_sold_date_sk = d_date_sk
    AND ss_store_sk = s_store_sk
    AND d_month_seq IN (1200, 1200 + 1, 1200 + 2, 1200 + 3, 1200 + 4,
                        1200 + 5, 1200 + 6, 1200 + 7, 1200 + 8, 1200 + 9,
                        1200 + 10, 1200 + 11)
    AND ((i_category IN ('Books', 'Children', 'Electronics')
          AND i_class IN ('personal', 'portable', 'reference',
                          'self-help'))
         OR (i_category IN ('Women', 'Music', 'Men')
             AND i_class IN ('accessories', 'classical', 'fragrances',
                             'pants')))
  GROUP BY i_manager_id, d_moy
), tmp2 AS (
  SELECT i_manager_id, sum_sales,
         AVG(sum_sales) OVER (PARTITION BY i_manager_id)
             AS avg_monthly_sales
  FROM tmp1
)
SELECT i_manager_id, sum_sales, avg_monthly_sales
FROM tmp2
WHERE CASE WHEN avg_monthly_sales > 0
           THEN abs(sum_sales - avg_monthly_sales) / avg_monthly_sales
           ELSE NULL END > 0.1
ORDER BY i_manager_id, avg_monthly_sales, sum_sales
LIMIT 100
""",
    64: """
WITH cs_ui AS
  (SELECT cs_item_sk, SUM(cs_ext_list_price) AS sale,
          SUM(cr_refunded_cash + cr_reversed_charge + cr_store_credit)
            AS refund
   FROM catalog_sales, catalog_returns
   WHERE cs_item_sk = cr_item_sk AND cs_order_number = cr_order_number
   GROUP BY cs_item_sk
   HAVING SUM(cs_ext_list_price)
          > 2 * SUM(cr_refunded_cash + cr_reversed_charge
                    + cr_store_credit)),
     cross_sales AS
  (SELECT i_product_name product_name, i_item_sk item_sk,
          s_store_name store_name, s_zip store_zip,
          ad1.ca_street_number b_street_number,
          ad1.ca_street_name b_street_name, ad1.ca_city b_city,
          ad1.ca_zip b_zip, ad2.ca_street_number c_street_number,
          ad2.ca_street_name c_street_name, ad2.ca_city c_city,
          ad2.ca_zip c_zip, d1.d_year AS syear, d2.d_year AS fsyear,
          d3.d_year s2year, COUNT(*) cnt, SUM(ss_wholesale_cost) s1,
          SUM(ss_list_price) s2, SUM(ss_coupon_amt) s3
   FROM store_sales, store_returns, cs_ui, date_dim d1, date_dim d2,
        date_dim d3, store, customer, customer_demographics cd1,
        customer_demographics cd2, promotion,
        household_demographics hd1, household_demographics hd2,
        customer_address ad1, customer_address ad2, income_band ib1,
        income_band ib2, item
   WHERE ss_store_sk = s_store_sk AND ss_sold_date_sk = d1.d_date_sk
     AND ss_customer_sk = c_customer_sk AND ss_cdemo_sk = cd1.cd_demo_sk
     AND ss_hdemo_sk = hd1.hd_demo_sk AND ss_addr_sk = ad1.ca_address_sk
     AND ss_item_sk = i_item_sk AND ss_item_sk = sr_item_sk
     AND ss_ticket_number = sr_ticket_number
     AND ss_item_sk = cs_ui.cs_item_sk
     AND c_current_cdemo_sk = cd2.cd_demo_sk
     AND c_current_hdemo_sk = hd2.hd_demo_sk
     AND c_current_addr_sk = ad2.ca_address_sk
     AND c_first_sales_date_sk = d2.d_date_sk
     AND c_first_shipto_date_sk = d3.d_date_sk
     AND ss_promo_sk = p_promo_sk
     AND hd1.hd_income_band_sk = ib1.ib_income_band_sk
     AND hd2.hd_income_band_sk = ib2.ib_income_band_sk
     AND cd1.cd_marital_status <> cd2.cd_marital_status
     AND i_color IN ('powder', 'orchid', 'slate', 'peach', 'smoke',
                     'sienna')
     AND i_current_price BETWEEN 40 AND 40 + 30
   GROUP BY i_product_name, i_item_sk, s_store_name, s_zip,
            ad1.ca_street_number, ad1.ca_street_name, ad1.ca_city,
            ad1.ca_zip, ad2.ca_street_number, ad2.ca_street_name,
            ad2.ca_city, ad2.ca_zip, d1.d_year, d2.d_year, d3.d_year)
SELECT cs1.product_name, cs1.store_name, cs1.store_zip,
       cs1.b_street_number, cs1.b_street_name, cs1.b_city, cs1.b_zip,
       cs1.c_street_number, cs1.c_street_name, cs1.c_city, cs1.c_zip,
       cs1.syear cs1syear, cs1.cnt cs1cnt, cs1.s1 AS s11,
       cs1.s2 AS s21, cs1.s3 AS s31, cs2.s1 AS s12, cs2.s2 AS s22,
       cs2.s3 AS s32, cs2.syear, cs2.cnt
FROM cross_sales cs1, cross_sales cs2
WHERE cs1.item_sk = cs2.item_sk AND cs1.syear = 1999
  AND cs2.syear = 1999 + 1 AND cs2.cnt <= cs1.cnt
  AND cs1.store_name = cs2.store_name AND cs1.store_zip = cs2.store_zip
ORDER BY cs1.product_name, cs1.store_name, cs2.cnt, cs1.s1, cs2.s1
""",
    65: """
SELECT s_store_name, i_item_desc, sc.revenue, i_current_price,
       i_wholesale_cost, i_brand
FROM store, item,
     (SELECT ss_store_sk, AVG(revenue) AS ave
      FROM (SELECT ss_store_sk, ss_item_sk,
                   SUM(ss_sales_price) AS revenue
            FROM store_sales, date_dim
            WHERE ss_sold_date_sk = d_date_sk
              AND d_month_seq BETWEEN 1200 AND 1200 + 11
            GROUP BY ss_store_sk, ss_item_sk) sa
      GROUP BY ss_store_sk) sb,
     (SELECT ss_store_sk, ss_item_sk, SUM(ss_sales_price) AS revenue
      FROM store_sales, date_dim
      WHERE ss_sold_date_sk = d_date_sk
        AND d_month_seq BETWEEN 1200 AND 1200 + 11
      GROUP BY ss_store_sk, ss_item_sk) sc
WHERE sb.ss_store_sk = sc.ss_store_sk
  AND sc.revenue <= 0.1 * sb.ave
  AND s_store_sk = sc.ss_store_sk
  AND i_item_sk = sc.ss_item_sk
ORDER BY s_store_name, i_item_desc
LIMIT 100
""",
    66: """
SELECT w_warehouse_name, w_warehouse_sq_ft, w_city, w_county, w_state,
       w_country, ship_carriers, year_,
       SUM(jan_sales) AS jan_sales, SUM(feb_sales) AS feb_sales,
       SUM(mar_sales) AS mar_sales, SUM(apr_sales) AS apr_sales,
       SUM(may_sales) AS may_sales, SUM(jun_sales) AS jun_sales,
       SUM(jul_sales) AS jul_sales, SUM(aug_sales) AS aug_sales,
       SUM(sep_sales) AS sep_sales, SUM(oct_sales) AS oct_sales,
       SUM(nov_sales) AS nov_sales, SUM(dec_sales) AS dec_sales,
       SUM(jan_sales / w_warehouse_sq_ft) AS jan_sales_per_sq_foot,
       SUM(dec_sales / w_warehouse_sq_ft) AS dec_sales_per_sq_foot,
       SUM(jan_net) AS jan_net, SUM(dec_net) AS dec_net
FROM (SELECT w_warehouse_name, w_warehouse_sq_ft, w_city, w_county,
             w_state, w_country, 'DHL,UPS' AS ship_carriers,
             d_year AS year_,
             SUM(CASE WHEN d_moy = 1 THEN ws_ext_sales_price * ws_quantity
                      ELSE 0 END) AS jan_sales,
             SUM(CASE WHEN d_moy = 2 THEN ws_ext_sales_price * ws_quantity
                      ELSE 0 END) AS feb_sales,
             SUM(CASE WHEN d_moy = 3 THEN ws_ext_sales_price * ws_quantity
                      ELSE 0 END) AS mar_sales,
             SUM(CASE WHEN d_moy = 4 THEN ws_ext_sales_price * ws_quantity
                      ELSE 0 END) AS apr_sales,
             SUM(CASE WHEN d_moy = 5 THEN ws_ext_sales_price * ws_quantity
                      ELSE 0 END) AS may_sales,
             SUM(CASE WHEN d_moy = 6 THEN ws_ext_sales_price * ws_quantity
                      ELSE 0 END) AS jun_sales,
             SUM(CASE WHEN d_moy = 7 THEN ws_ext_sales_price * ws_quantity
                      ELSE 0 END) AS jul_sales,
             SUM(CASE WHEN d_moy = 8 THEN ws_ext_sales_price * ws_quantity
                      ELSE 0 END) AS aug_sales,
             SUM(CASE WHEN d_moy = 9 THEN ws_ext_sales_price * ws_quantity
                      ELSE 0 END) AS sep_sales,
             SUM(CASE WHEN d_moy = 10 THEN ws_ext_sales_price * ws_quantity
                      ELSE 0 END) AS oct_sales,
             SUM(CASE WHEN d_moy = 11 THEN ws_ext_sales_price * ws_quantity
                      ELSE 0 END) AS nov_sales,
             SUM(CASE WHEN d_moy = 12 THEN ws_ext_sales_price * ws_quantity
                      ELSE 0 END) AS dec_sales,
             SUM(CASE WHEN d_moy = 1 THEN ws_net_paid * ws_quantity
                      ELSE 0 END) AS jan_net,
             SUM(CASE WHEN d_moy = 12 THEN ws_net_paid * ws_quantity
                      ELSE 0 END) AS dec_net
      FROM web_sales, warehouse, date_dim, time_dim, ship_mode
      WHERE ws_warehouse_sk = w_warehouse_sk
        AND ws_sold_date_sk = d_date_sk
        AND ws_sold_time_sk = t_time_sk
        AND ws_ship_mode_sk = sm_ship_mode_sk
        AND d_year = 2000
        AND t_time BETWEEN 30838 AND 30838 + 28800
        AND sm_carrier IN ('DHL', 'UPS')
      GROUP BY w_warehouse_name, w_warehouse_sq_ft, w_city, w_county,
               w_state, w_country, d_year
      UNION ALL
      SELECT w_warehouse_name, w_warehouse_sq_ft, w_city, w_county,
             w_state, w_country, 'DHL,UPS' AS ship_carriers,
             d_year AS year_,
             SUM(CASE WHEN d_moy = 1 THEN cs_sales_price * cs_quantity
                      ELSE 0 END) AS jan_sales,
             SUM(CASE WHEN d_moy = 2 THEN cs_sales_price * cs_quantity
                      ELSE 0 END) AS feb_sales,
             SUM(CASE WHEN d_moy = 3 THEN cs_sales_price * cs_quantity
                      ELSE 0 END) AS mar_sales,
             SUM(CASE WHEN d_moy = 4 THEN cs_sales_price * cs_quantity
                      ELSE 0 END) AS apr_sales,
             SUM(CASE WHEN d_moy = 5 THEN cs_sales_price * cs_quantity
                      ELSE 0 END) AS may_sales,
             SUM(CASE WHEN d_moy = 6 THEN cs_sales_price * cs_quantity
                      ELSE 0 END) AS jun_sales,
             SUM(CASE WHEN d_moy = 7 THEN cs_sales_price * cs_quantity
                      ELSE 0 END) AS jul_sales,
             SUM(CASE WHEN d_moy = 8 THEN cs_sales_price * cs_quantity
                      ELSE 0 END) AS aug_sales,
             SUM(CASE WHEN d_moy = 9 THEN cs_sales_price * cs_quantity
                      ELSE 0 END) AS sep_sales,
             SUM(CASE WHEN d_moy = 10 THEN cs_sales_price * cs_quantity
                      ELSE 0 END) AS oct_sales,
             SUM(CASE WHEN d_moy = 11 THEN cs_sales_price * cs_quantity
                      ELSE 0 END) AS nov_sales,
             SUM(CASE WHEN d_moy = 12 THEN cs_sales_price * cs_quantity
                      ELSE 0 END) AS dec_sales,
             SUM(CASE WHEN d_moy = 1 THEN cs_net_paid_inc_tax * cs_quantity
                      ELSE 0 END) AS jan_net,
             SUM(CASE WHEN d_moy = 12
                      THEN cs_net_paid_inc_tax * cs_quantity
                      ELSE 0 END) AS dec_net
      FROM catalog_sales, warehouse, date_dim, time_dim, ship_mode
      WHERE cs_warehouse_sk = w_warehouse_sk
        AND cs_sold_date_sk = d_date_sk
        AND cs_sold_time_sk = t_time_sk
        AND cs_ship_mode_sk = sm_ship_mode_sk
        AND d_year = 2000
        AND t_time BETWEEN 30838 AND 30838 + 28800
        AND sm_carrier IN ('DHL', 'UPS')
      GROUP BY w_warehouse_name, w_warehouse_sq_ft, w_city, w_county,
               w_state, w_country, d_year) x
GROUP BY w_warehouse_name, w_warehouse_sq_ft, w_city, w_county, w_state,
         w_country, ship_carriers, year_
ORDER BY w_warehouse_name
LIMIT 100
""",
    67: """
SELECT *
FROM (SELECT i_category, i_class, i_brand, i_product_name, d_year, d_qoy,
             d_moy, s_store_id, sumsales,
             RANK() OVER (PARTITION BY i_category
                          ORDER BY sumsales DESC) AS rk
      FROM (SELECT i_category, i_class, i_brand, i_product_name, d_year,
                   d_qoy, d_moy, s_store_id,
                   SUM(COALESCE(ss_sales_price * ss_quantity, 0))
                       AS sumsales
            FROM store_sales, date_dim, store, item
            WHERE ss_sold_date_sk = d_date_sk
              AND ss_item_sk = i_item_sk
              AND ss_store_sk = s_store_sk
              AND d_month_seq BETWEEN 1212 AND 1212 + 11
            GROUP BY ROLLUP (i_category, i_class, i_brand, i_product_name,
                             d_year, d_qoy, d_moy, s_store_id)) dw1) dw2
WHERE rk <= 100
ORDER BY i_category, i_class, i_brand, i_product_name, d_year, d_qoy,
         d_moy, s_store_id, sumsales, rk
LIMIT 100
""",
    68: """
WITH dn AS (
  SELECT ss_ticket_number, ss_customer_sk, ca_city AS bought_city,
         SUM(ss_ext_sales_price) AS extended_price,
         SUM(ss_ext_list_price) AS list_price,
         SUM(ss_ext_tax) AS extended_tax
  FROM store_sales, date_dim, store, household_demographics,
       customer_address
  WHERE ss_sold_date_sk = d_date_sk
    AND ss_store_sk = s_store_sk
    AND ss_hdemo_sk = hd_demo_sk
    AND ss_addr_sk = ca_address_sk
    AND d_dom BETWEEN 1 AND 2
    AND (hd_dep_count = 4 OR hd_vehicle_count = 3)
    AND d_year = 2000
    AND s_city IN ('rivertown', 'hilltop')
  GROUP BY ss_ticket_number, ss_customer_sk, ca_city
)
SELECT c_last_name, c_first_name, ca_city AS current_city, bought_city,
       ss_ticket_number, extended_price, extended_tax, list_price
FROM dn, customer, customer_address current_addr
WHERE ss_customer_sk = c_customer_sk
  AND c_current_addr_sk = current_addr.ca_address_sk
  AND current_addr.ca_city <> bought_city
ORDER BY c_last_name, ss_ticket_number
LIMIT 100
""",
    69: """
SELECT cd_gender, cd_marital_status, cd_education_status,
       COUNT(*) AS cnt1, cd_purchase_estimate, COUNT(*) AS cnt2,
       cd_credit_rating, COUNT(*) AS cnt3
FROM customer c, customer_address ca, customer_demographics
WHERE c.c_current_addr_sk = ca.ca_address_sk
  AND ca_state IN ('CA', 'TX', 'NY')
  AND cd_demo_sk = c.c_current_cdemo_sk
  AND EXISTS (SELECT 1 FROM store_sales, date_dim
              WHERE c.c_customer_sk = ss_customer_sk
                AND ss_sold_date_sk = d_date_sk
                AND d_year = 2000 AND d_moy BETWEEN 1 AND 3)
  AND NOT EXISTS (SELECT 1 FROM web_sales, date_dim
                  WHERE c.c_customer_sk = ws_bill_customer_sk
                    AND ws_sold_date_sk = d_date_sk
                    AND d_year = 2000 AND d_moy BETWEEN 1 AND 3)
  AND NOT EXISTS (SELECT 1 FROM catalog_sales, date_dim
                  WHERE c.c_customer_sk = cs_ship_customer_sk
                    AND cs_sold_date_sk = d_date_sk
                    AND d_year = 2000 AND d_moy BETWEEN 1 AND 3)
GROUP BY cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate, cd_credit_rating
ORDER BY cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate, cd_credit_rating
LIMIT 100
""",
    70: """
SELECT SUM(ss_net_profit) AS total_sum, s_state, s_county,
       GROUPING(s_state) + GROUPING(s_county) AS lochierarchy,
       RANK() OVER (PARTITION BY GROUPING(s_state) + GROUPING(s_county),
                                 CASE WHEN GROUPING(s_county) = 0
                                      THEN s_state END
                    ORDER BY SUM(ss_net_profit) DESC) AS rank_within_parent
FROM store_sales, date_dim d1, store
WHERE d1.d_month_seq BETWEEN 1200 AND 1200 + 11
  AND d1.d_date_sk = ss_sold_date_sk
  AND s_store_sk = ss_store_sk
  AND s_state IN
    (SELECT s_state
     FROM (SELECT s_state AS s_state,
                  RANK() OVER (PARTITION BY s_state
                               ORDER BY SUM(ss_net_profit) DESC) AS ranking
           FROM store_sales, store, date_dim
           WHERE d_month_seq BETWEEN 1200 AND 1200 + 11
             AND d_date_sk = ss_sold_date_sk
             AND s_store_sk = ss_store_sk
           GROUP BY s_state) tmp1
     WHERE ranking <= 5)
GROUP BY ROLLUP (s_state, s_county)
ORDER BY lochierarchy DESC,
         CASE WHEN GROUPING(s_state) + GROUPING(s_county) = 0
              THEN s_state END,
         rank_within_parent
LIMIT 100
""",
    71: """
SELECT i_brand_id AS brand_id, i_brand AS brand, t_hour, t_minute,
       SUM(ext_price) AS ext_price
FROM item,
     (SELECT ws_ext_sales_price AS ext_price,
             ws_sold_date_sk AS sold_date_sk, ws_item_sk AS sold_item_sk,
             ws_sold_time_sk AS time_sk
      FROM web_sales, date_dim
      WHERE d_date_sk = ws_sold_date_sk AND d_moy = 11 AND d_year = 2000
      UNION ALL
      SELECT cs_ext_sales_price AS ext_price,
             cs_sold_date_sk AS sold_date_sk, cs_item_sk AS sold_item_sk,
             cs_sold_time_sk AS time_sk
      FROM catalog_sales, date_dim
      WHERE d_date_sk = cs_sold_date_sk AND d_moy = 11 AND d_year = 2000
      UNION ALL
      SELECT ss_ext_sales_price AS ext_price,
             ss_sold_date_sk AS sold_date_sk, ss_item_sk AS sold_item_sk,
             ss_sold_time_sk AS time_sk
      FROM store_sales, date_dim
      WHERE d_date_sk = ss_sold_date_sk AND d_moy = 11 AND d_year = 2000
     ) tmp, time_dim
WHERE sold_item_sk = i_item_sk
  AND i_manager_id = 1
  AND time_sk = t_time_sk
  AND (t_meal_time = 'breakfast' OR t_meal_time = 'dinner')
GROUP BY i_brand, i_brand_id, t_hour, t_minute
ORDER BY ext_price DESC, i_brand_id
""",
    72: """
SELECT i_item_desc, w_warehouse_name, d1.d_week_seq,
       SUM(CASE WHEN p_promo_sk IS NULL THEN 1 ELSE 0 END) no_promo,
       SUM(CASE WHEN p_promo_sk IS NOT NULL THEN 1 ELSE 0 END) promo,
       COUNT(*) total_cnt
FROM catalog_sales
JOIN inventory ON (cs_item_sk = inv_item_sk)
JOIN warehouse ON (w_warehouse_sk = inv_warehouse_sk)
JOIN item ON (i_item_sk = cs_item_sk)
JOIN customer_demographics ON (cs_bill_cdemo_sk = cd_demo_sk)
JOIN household_demographics ON (cs_bill_hdemo_sk = hd_demo_sk)
JOIN date_dim d1 ON (cs_sold_date_sk = d1.d_date_sk)
JOIN date_dim d2 ON (inv_date_sk = d2.d_date_sk)
JOIN date_dim d3 ON (cs_ship_date_sk = d3.d_date_sk)
LEFT OUTER JOIN promotion ON (cs_promo_sk = p_promo_sk)
LEFT OUTER JOIN catalog_returns ON (cr_item_sk = cs_item_sk
                                    AND cr_order_number = cs_order_number)
WHERE d1.d_week_seq = d2.d_week_seq
  AND inv_quantity_on_hand < cs_quantity
  AND d3.d_date > d1.d_date + INTERVAL '5' DAY
  AND hd_buy_potential = '>10000'
  AND d1.d_year = 2000
  AND cd_marital_status = 'D'
GROUP BY i_item_desc, w_warehouse_name, d1.d_week_seq
ORDER BY total_cnt DESC, i_item_desc, w_warehouse_name, d1.d_week_seq
LIMIT 100
""",
    73: """
WITH tickets AS (
  SELECT ss_ticket_number, ss_customer_sk, COUNT(*) AS cnt
  FROM store_sales, date_dim, store, household_demographics
  WHERE ss_sold_date_sk = d_date_sk
    AND ss_store_sk = s_store_sk
    AND ss_hdemo_sk = hd_demo_sk
    AND d_dom BETWEEN 1 AND 2
    AND hd_buy_potential IN ('>10000', 'Unknown')
    AND hd_vehicle_count > 0
    AND d_year = 2000
  GROUP BY ss_ticket_number, ss_customer_sk
)
SELECT c_last_name, c_first_name, ss_ticket_number, cnt
FROM tickets, customer
WHERE ss_customer_sk = c_customer_sk
  AND cnt BETWEEN 1 AND 5
ORDER BY cnt DESC, c_last_name
""",
    74: """
WITH year_total AS
  (SELECT c_customer_id customer_id, c_first_name customer_first_name,
          c_last_name customer_last_name, d_year AS year_,
          SUM(ss_net_paid) year_total, 's' sale_type
   FROM customer, store_sales, date_dim
   WHERE c_customer_sk = ss_customer_sk AND ss_sold_date_sk = d_date_sk
     AND d_year IN (2000, 2000 + 1)
   GROUP BY c_customer_id, c_first_name, c_last_name, d_year
   UNION ALL
   SELECT c_customer_id, c_first_name, c_last_name, d_year AS year_,
          SUM(ws_net_paid) year_total, 'w' sale_type
   FROM customer, web_sales, date_dim
   WHERE c_customer_sk = ws_bill_customer_sk
     AND ws_sold_date_sk = d_date_sk
     AND d_year IN (2000, 2000 + 1)
   GROUP BY c_customer_id, c_first_name, c_last_name, d_year)
SELECT t_s_secyear.customer_id, t_s_secyear.customer_first_name,
       t_s_secyear.customer_last_name
FROM year_total t_s_firstyear, year_total t_s_secyear,
     year_total t_w_firstyear, year_total t_w_secyear
WHERE t_s_secyear.customer_id = t_s_firstyear.customer_id
  AND t_s_firstyear.customer_id = t_w_secyear.customer_id
  AND t_s_firstyear.customer_id = t_w_firstyear.customer_id
  AND t_s_firstyear.sale_type = 's' AND t_w_firstyear.sale_type = 'w'
  AND t_s_secyear.sale_type = 's' AND t_w_secyear.sale_type = 'w'
  AND t_s_firstyear.year_ = 2000 AND t_s_secyear.year_ = 2000 + 1
  AND t_w_firstyear.year_ = 2000 AND t_w_secyear.year_ = 2000 + 1
  AND t_s_firstyear.year_total > 0 AND t_w_firstyear.year_total > 0
  AND CASE WHEN t_w_firstyear.year_total > 0
           THEN t_w_secyear.year_total / t_w_firstyear.year_total
           ELSE NULL END
    > CASE WHEN t_s_firstyear.year_total > 0
           THEN t_s_secyear.year_total / t_s_firstyear.year_total
           ELSE NULL END
ORDER BY 1
LIMIT 100
""",
    75: """
WITH all_sales AS
  (SELECT d_year, i_brand_id, i_class_id, i_category_id, i_manufact_id,
          SUM(sales_cnt) AS sales_cnt, SUM(sales_amt) AS sales_amt
   FROM (SELECT d_year, i_brand_id, i_class_id, i_category_id,
                i_manufact_id,
                cs_quantity - COALESCE(cr_return_quantity, 0)
                  AS sales_cnt,
                cs_ext_sales_price - COALESCE(cr_return_amount, 0.0)
                  AS sales_amt
         FROM catalog_sales
         JOIN item ON i_item_sk = cs_item_sk
         JOIN date_dim ON d_date_sk = cs_sold_date_sk
         LEFT JOIN catalog_returns
           ON (cs_order_number = cr_order_number
               AND cs_item_sk = cr_item_sk)
         WHERE i_category = 'Books'
         UNION
         SELECT d_year, i_brand_id, i_class_id, i_category_id,
                i_manufact_id,
                ss_quantity - COALESCE(sr_return_quantity, 0),
                ss_ext_sales_price - COALESCE(sr_return_amt, 0.0)
         FROM store_sales
         JOIN item ON i_item_sk = ss_item_sk
         JOIN date_dim ON d_date_sk = ss_sold_date_sk
         LEFT JOIN store_returns
           ON (ss_ticket_number = sr_ticket_number
               AND ss_item_sk = sr_item_sk)
         WHERE i_category = 'Books'
         UNION
         SELECT d_year, i_brand_id, i_class_id, i_category_id,
                i_manufact_id,
                ws_quantity - COALESCE(wr_return_quantity, 0),
                ws_ext_sales_price - COALESCE(wr_return_amt, 0.0)
         FROM web_sales
         JOIN item ON i_item_sk = ws_item_sk
         JOIN date_dim ON d_date_sk = ws_sold_date_sk
         LEFT JOIN web_returns
           ON (ws_order_number = wr_order_number
               AND ws_item_sk = wr_item_sk)
         WHERE i_category = 'Books') sales_detail
   GROUP BY d_year, i_brand_id, i_class_id, i_category_id,
            i_manufact_id)
SELECT prev_yr.d_year AS prev_year, curr_yr.d_year AS year_,
       curr_yr.i_brand_id, curr_yr.i_class_id, curr_yr.i_category_id,
       curr_yr.i_manufact_id, prev_yr.sales_cnt AS prev_yr_cnt,
       curr_yr.sales_cnt AS curr_yr_cnt,
       curr_yr.sales_cnt - prev_yr.sales_cnt AS sales_cnt_diff,
       curr_yr.sales_amt - prev_yr.sales_amt AS sales_amt_diff
FROM all_sales curr_yr, all_sales prev_yr
WHERE curr_yr.i_brand_id = prev_yr.i_brand_id
  AND curr_yr.i_class_id = prev_yr.i_class_id
  AND curr_yr.i_category_id = prev_yr.i_category_id
  AND curr_yr.i_manufact_id = prev_yr.i_manufact_id
  AND curr_yr.d_year = 2001 AND prev_yr.d_year = 2001 - 1
  AND (curr_yr.sales_cnt * 1.0000) / prev_yr.sales_cnt < 0.9
ORDER BY sales_cnt_diff, sales_amt_diff
LIMIT 100
""",
    76: """
SELECT channel, col_name, d_year, d_qoy, i_category, COUNT(*) AS sales_cnt,
       SUM(ext_sales_price) AS sales_amt
FROM (SELECT 'store' AS channel, 'ss_store_sk' AS col_name, d_year, d_qoy,
             i_category, ss_ext_sales_price AS ext_sales_price
      FROM store_sales, item, date_dim
      WHERE ss_store_sk IS NULL
        AND ss_sold_date_sk = d_date_sk
        AND ss_item_sk = i_item_sk
      UNION ALL
      SELECT 'web' AS channel, 'ws_ship_customer_sk' AS col_name, d_year,
             d_qoy, i_category, ws_ext_sales_price AS ext_sales_price
      FROM web_sales, item, date_dim
      WHERE ws_ship_customer_sk IS NULL
        AND ws_sold_date_sk = d_date_sk
        AND ws_item_sk = i_item_sk
      UNION ALL
      SELECT 'catalog' AS channel, 'cs_ship_addr_sk' AS col_name, d_year,
             d_qoy, i_category, cs_ext_sales_price AS ext_sales_price
      FROM catalog_sales, item, date_dim
      WHERE cs_ship_addr_sk IS NULL
        AND cs_sold_date_sk = d_date_sk
        AND cs_item_sk = i_item_sk) foo
GROUP BY channel, col_name, d_year, d_qoy, i_category
ORDER BY channel, col_name, d_year, d_qoy, i_category
LIMIT 100
""",
    77: """
WITH ss AS (
  SELECT s_store_sk, SUM(ss_ext_sales_price) AS sales,
         SUM(ss_net_profit) AS profit
  FROM store_sales, date_dim, store
  WHERE ss_sold_date_sk = d_date_sk
    AND d_date BETWEEN DATE '2000-08-23'
                   AND DATE '2000-08-23' + INTERVAL '30' DAY
    AND ss_store_sk = s_store_sk
  GROUP BY s_store_sk
), sr AS (
  SELECT s_store_sk AS sr_store_sk, SUM(sr_return_amt) AS returns_,
         SUM(sr_net_loss) AS profit_loss
  FROM store_returns, date_dim, store
  WHERE sr_returned_date_sk = d_date_sk
    AND d_date BETWEEN DATE '2000-08-23'
                   AND DATE '2000-08-23' + INTERVAL '30' DAY
    AND sr_store_sk = s_store_sk
  GROUP BY s_store_sk
), cs AS (
  SELECT cs_call_center_sk, SUM(cs_ext_sales_price) AS sales,
         SUM(cs_net_profit) AS profit
  FROM catalog_sales, date_dim
  WHERE cs_sold_date_sk = d_date_sk
    AND d_date BETWEEN DATE '2000-08-23'
                   AND DATE '2000-08-23' + INTERVAL '30' DAY
  GROUP BY cs_call_center_sk
), cr AS (
  SELECT cr_call_center_sk, SUM(cr_return_amount) AS returns_,
         SUM(cr_net_loss) AS profit_loss
  FROM catalog_returns, date_dim
  WHERE cr_returned_date_sk = d_date_sk
    AND d_date BETWEEN DATE '2000-08-23'
                   AND DATE '2000-08-23' + INTERVAL '30' DAY
  GROUP BY cr_call_center_sk
), ws AS (
  SELECT wp_web_page_sk, SUM(ws_ext_sales_price) AS sales,
         SUM(ws_net_profit) AS profit
  FROM web_sales, date_dim, web_page
  WHERE ws_sold_date_sk = d_date_sk
    AND d_date BETWEEN DATE '2000-08-23'
                   AND DATE '2000-08-23' + INTERVAL '30' DAY
    AND ws_web_page_sk = wp_web_page_sk
  GROUP BY wp_web_page_sk
), wr AS (
  SELECT wp_web_page_sk AS wr_web_page_sk, SUM(wr_return_amt) AS returns_,
         SUM(wr_net_loss) AS profit_loss
  FROM web_returns, date_dim, web_page
  WHERE wr_returned_date_sk = d_date_sk
    AND d_date BETWEEN DATE '2000-08-23'
                   AND DATE '2000-08-23' + INTERVAL '30' DAY
    AND wr_web_page_sk = wp_web_page_sk
  GROUP BY wp_web_page_sk
)
SELECT channel, id, SUM(sales) AS sales, SUM(returns_) AS returns_,
       SUM(profit) AS profit
FROM (SELECT 'store channel' AS channel, ss.s_store_sk AS id, sales,
             COALESCE(returns_, 0) AS returns_,
             profit - COALESCE(profit_loss, 0) AS profit
      FROM ss LEFT JOIN sr ON ss.s_store_sk = sr.sr_store_sk
      UNION ALL
      SELECT 'catalog channel' AS channel, cs_call_center_sk AS id, sales,
             COALESCE(returns_, 0) AS returns_,
             profit - COALESCE(profit_loss, 0) AS profit
      FROM cs LEFT JOIN cr ON cs.cs_call_center_sk = cr.cr_call_center_sk
      UNION ALL
      SELECT 'web channel' AS channel, ws.wp_web_page_sk AS id, sales,
             COALESCE(returns_, 0) AS returns_,
             profit - COALESCE(profit_loss, 0) AS profit
      FROM ws LEFT JOIN wr ON ws.wp_web_page_sk = wr.wr_web_page_sk) x
GROUP BY ROLLUP (channel, id)
ORDER BY channel, id
LIMIT 100
""",
    78: """
WITH ws AS
  (SELECT d_year AS ws_sold_year, ws_item_sk,
          ws_bill_customer_sk ws_customer_sk, SUM(ws_quantity) ws_qty,
          SUM(ws_wholesale_cost) ws_wc, SUM(ws_sales_price) ws_sp
   FROM web_sales
   LEFT JOIN web_returns ON wr_order_number = ws_order_number
                        AND ws_item_sk = wr_item_sk
   JOIN date_dim ON ws_sold_date_sk = d_date_sk
   WHERE wr_order_number IS NULL
   GROUP BY d_year, ws_item_sk, ws_bill_customer_sk),
     cs AS
  (SELECT d_year AS cs_sold_year, cs_item_sk,
          cs_bill_customer_sk cs_customer_sk, SUM(cs_quantity) cs_qty,
          SUM(cs_wholesale_cost) cs_wc, SUM(cs_sales_price) cs_sp
   FROM catalog_sales
   LEFT JOIN catalog_returns ON cr_order_number = cs_order_number
                            AND cs_item_sk = cr_item_sk
   JOIN date_dim ON cs_sold_date_sk = d_date_sk
   WHERE cr_order_number IS NULL
   GROUP BY d_year, cs_item_sk, cs_bill_customer_sk),
     ss AS
  (SELECT d_year AS ss_sold_year, ss_item_sk, ss_customer_sk,
          SUM(ss_quantity) ss_qty, SUM(ss_wholesale_cost) ss_wc,
          SUM(ss_sales_price) ss_sp
   FROM store_sales
   LEFT JOIN store_returns ON sr_ticket_number = ss_ticket_number
                          AND ss_item_sk = sr_item_sk
   JOIN date_dim ON ss_sold_date_sk = d_date_sk
   WHERE sr_ticket_number IS NULL
   GROUP BY d_year, ss_item_sk, ss_customer_sk)
SELECT ss_sold_year, ss_item_sk, ss_customer_sk,
       ROUND((ss_qty * 1.00) / (COALESCE(ws_qty, 0)
                                + COALESCE(cs_qty, 0)), 2) ratio,
       ss_qty store_qty, ss_wc store_wholesale_cost,
       ss_sp store_sales_price,
       COALESCE(ws_qty, 0) + COALESCE(cs_qty, 0) other_chan_qty,
       COALESCE(ws_wc, 0) + COALESCE(cs_wc, 0)
         other_chan_wholesale_cost,
       COALESCE(ws_sp, 0) + COALESCE(cs_sp, 0) other_chan_sales_price
FROM ss
LEFT JOIN ws ON (ws_sold_year = ss_sold_year
                 AND ws_item_sk = ss_item_sk
                 AND ws_customer_sk = ss_customer_sk)
LEFT JOIN cs ON (cs_sold_year = ss_sold_year
                 AND cs_item_sk = ss_item_sk
                 AND cs_customer_sk = ss_customer_sk)
WHERE (COALESCE(ws_qty, 0) > 0 OR COALESCE(cs_qty, 0) > 0)
  AND ss_sold_year = 2000
ORDER BY ss_sold_year, ss_item_sk, ss_customer_sk, ss_qty DESC,
         ss_wc DESC, ss_sp DESC, other_chan_qty,
         other_chan_wholesale_cost, other_chan_sales_price, ratio
LIMIT 100
""",
    79: """
SELECT c_last_name, c_first_name, substr(s_city, 1, 30) AS city,
       ss_ticket_number, amt, profit
FROM (SELECT ss_ticket_number, ss_customer_sk, s_city,
             SUM(ss_coupon_amt) AS amt, SUM(ss_net_profit) AS profit
      FROM store_sales, date_dim, store, household_demographics
      WHERE ss_sold_date_sk = d_date_sk
        AND ss_store_sk = s_store_sk
        AND ss_hdemo_sk = hd_demo_sk
        AND (hd_dep_count = 6 OR hd_vehicle_count > 2)
        AND d_dow = 1
        AND d_year IN (1999, 2000, 2001)
        AND s_number_employees BETWEEN 200 AND 295
      GROUP BY ss_ticket_number, ss_customer_sk, ss_addr_sk, s_city) ms,
     customer
WHERE ss_customer_sk = c_customer_sk
ORDER BY c_last_name, c_first_name, city, profit
LIMIT 100
""",
    80: """
WITH ssr AS (
  SELECT s_store_id AS store_id, SUM(ss_ext_sales_price) AS sales,
         SUM(COALESCE(sr_return_amt, 0)) AS returns_,
         SUM(ss_net_profit - COALESCE(sr_net_loss, 0)) AS profit
  FROM store_sales
  LEFT JOIN store_returns
    ON ss_item_sk = sr_item_sk AND ss_ticket_number = sr_ticket_number
  , date_dim, store, item, promotion
  WHERE ss_sold_date_sk = d_date_sk
    AND d_date BETWEEN DATE '2000-08-23'
                   AND DATE '2000-08-23' + INTERVAL '30' DAY
    AND ss_store_sk = s_store_sk
    AND ss_item_sk = i_item_sk
    AND i_current_price > 50
    AND ss_promo_sk = p_promo_sk
    AND p_channel_tv = 'N'
  GROUP BY s_store_id
), csr AS (
  SELECT cp_catalog_page_id AS catalog_page_id,
         SUM(cs_ext_sales_price) AS sales,
         SUM(COALESCE(cr_return_amount, 0)) AS returns_,
         SUM(cs_net_profit - COALESCE(cr_net_loss, 0)) AS profit
  FROM catalog_sales
  LEFT JOIN catalog_returns
    ON cs_item_sk = cr_item_sk AND cs_order_number = cr_order_number
  , date_dim, catalog_page, item, promotion
  WHERE cs_sold_date_sk = d_date_sk
    AND d_date BETWEEN DATE '2000-08-23'
                   AND DATE '2000-08-23' + INTERVAL '30' DAY
    AND cs_catalog_page_sk = cp_catalog_page_sk
    AND cs_item_sk = i_item_sk
    AND i_current_price > 50
    AND cs_promo_sk = p_promo_sk
    AND p_channel_tv = 'N'
  GROUP BY cp_catalog_page_id
), wsr AS (
  SELECT web_site_id, SUM(ws_ext_sales_price) AS sales,
         SUM(COALESCE(wr_return_amt, 0)) AS returns_,
         SUM(ws_net_profit - COALESCE(wr_net_loss, 0)) AS profit
  FROM web_sales
  LEFT JOIN web_returns
    ON ws_item_sk = wr_item_sk AND ws_order_number = wr_order_number
  , date_dim, web_site, item, promotion
  WHERE ws_sold_date_sk = d_date_sk
    AND d_date BETWEEN DATE '2000-08-23'
                   AND DATE '2000-08-23' + INTERVAL '30' DAY
    AND ws_web_site_sk = web_site_sk
    AND ws_item_sk = i_item_sk
    AND i_current_price > 50
    AND ws_promo_sk = p_promo_sk
    AND p_channel_tv = 'N'
  GROUP BY web_site_id
)
SELECT channel, id, SUM(sales) AS sales, SUM(returns_) AS returns_,
       SUM(profit) AS profit
FROM (SELECT 'store channel' AS channel, 'store' + store_id AS id,
             sales, returns_, profit
      FROM ssr
      UNION ALL
      SELECT 'catalog channel' AS channel,
             'catalog_page' + catalog_page_id AS id,
             sales, returns_, profit
      FROM csr
      UNION ALL
      SELECT 'web channel' AS channel, 'web_site' + web_site_id AS id,
             sales, returns_, profit
      FROM wsr) x
GROUP BY ROLLUP (channel, id)
ORDER BY channel, id
LIMIT 100
""",
    81: """
WITH customer_total_return AS (
  SELECT cr_returning_customer_sk AS ctr_customer_sk,
         ca_state AS ctr_state,
         SUM(cr_return_amt_inc_tax) AS ctr_total_return
  FROM catalog_returns, date_dim, customer_address
  WHERE cr_returned_date_sk = d_date_sk AND d_year = 2000
    AND cr_returning_addr_sk = ca_address_sk
  GROUP BY cr_returning_customer_sk, ca_state
)
SELECT c_customer_id, c_salutation, c_first_name, c_last_name,
       ca_street_number, ca_street_name, ca_street_type, ca_suite_number,
       ca_city, ca_county, ca_state, ca_zip, ca_country, ca_gmt_offset,
       ca_location_type, ctr_total_return
FROM customer_total_return ctr1, customer_address, customer
WHERE ctr1.ctr_total_return > (
    SELECT AVG(ctr_total_return) * 1.2
    FROM customer_total_return ctr2
    WHERE ctr1.ctr_state = ctr2.ctr_state)
  AND ca_address_sk = c_current_addr_sk
  AND ca_state = 'CA'
  AND ctr1.ctr_customer_sk = c_customer_sk
ORDER BY c_customer_id, c_salutation, c_first_name, c_last_name
LIMIT 100
""",
    82: """
SELECT i_item_id, i_item_desc, i_current_price
FROM item, inventory, date_dim, store_sales
WHERE i_current_price BETWEEN 30 AND 60
  AND inv_item_sk = i_item_sk
  AND d_date_sk = inv_date_sk
  AND d_date BETWEEN DATE '2000-05-25' AND DATE '2000-05-25' + INTERVAL '60' DAY
  AND i_manufact_id IN (50, 70, 90, 110)
  AND inv_quantity_on_hand BETWEEN 100 AND 500
  AND ss_item_sk = i_item_sk
GROUP BY i_item_id, i_item_desc, i_current_price
ORDER BY i_item_id
LIMIT 100
""",
    83: """
WITH sr_items AS
  (SELECT i_item_id item_id, SUM(sr_return_quantity) sr_item_qty
   FROM store_returns, item, date_dim
   WHERE sr_item_sk = i_item_sk
     AND d_date IN (SELECT d_date FROM date_dim
                    WHERE d_week_seq IN
                        (SELECT d_week_seq FROM date_dim
                         WHERE d_date IN (CAST('2000-06-30' AS DATE),
                                          CAST('2000-09-27' AS DATE),
                                          CAST('2000-11-17' AS DATE))))
     AND sr_returned_date_sk = d_date_sk
   GROUP BY i_item_id),
     cr_items AS
  (SELECT i_item_id item_id, SUM(cr_return_quantity) cr_item_qty
   FROM catalog_returns, item, date_dim
   WHERE cr_item_sk = i_item_sk
     AND d_date IN (SELECT d_date FROM date_dim
                    WHERE d_week_seq IN
                        (SELECT d_week_seq FROM date_dim
                         WHERE d_date IN (CAST('2000-06-30' AS DATE),
                                          CAST('2000-09-27' AS DATE),
                                          CAST('2000-11-17' AS DATE))))
     AND cr_returned_date_sk = d_date_sk
   GROUP BY i_item_id),
     wr_items AS
  (SELECT i_item_id item_id, SUM(wr_return_quantity) wr_item_qty
   FROM web_returns, item, date_dim
   WHERE wr_item_sk = i_item_sk
     AND d_date IN (SELECT d_date FROM date_dim
                    WHERE d_week_seq IN
                        (SELECT d_week_seq FROM date_dim
                         WHERE d_date IN (CAST('2000-06-30' AS DATE),
                                          CAST('2000-09-27' AS DATE),
                                          CAST('2000-11-17' AS DATE))))
     AND wr_returned_date_sk = d_date_sk
   GROUP BY i_item_id)
SELECT sr_items.item_id, sr_item_qty,
       (sr_item_qty * 1.0000) / (sr_item_qty + cr_item_qty + wr_item_qty)
         / 3.0000 * 100 sr_dev,
       cr_item_qty,
       (cr_item_qty * 1.0000) / (sr_item_qty + cr_item_qty + wr_item_qty)
         / 3.0000 * 100 cr_dev,
       wr_item_qty,
       (wr_item_qty * 1.0000) / (sr_item_qty + cr_item_qty + wr_item_qty)
         / 3.0000 * 100 wr_dev,
       (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0 average
FROM sr_items, cr_items, wr_items
WHERE sr_items.item_id = cr_items.item_id
  AND sr_items.item_id = wr_items.item_id
ORDER BY sr_items.item_id, sr_item_qty
LIMIT 100
""",
    84: """
SELECT c_customer_id AS customer_id,
       c_last_name + ', ' + c_first_name AS customername
FROM customer, customer_address, customer_demographics,
     household_demographics, income_band, store_returns
WHERE ca_city = 'hilltop'
  AND c_current_addr_sk = ca_address_sk
  AND ib_lower_bound >= 30000
  AND ib_upper_bound <= 80000
  AND ib_income_band_sk = hd_income_band_sk
  AND cd_demo_sk = c_current_cdemo_sk
  AND hd_demo_sk = c_current_hdemo_sk
  AND sr_cdemo_sk = cd_demo_sk
ORDER BY c_customer_id
LIMIT 100
""",
    85: """
SELECT substr(r_reason_desc, 1, 20) AS reason_desc,
       AVG(ws_quantity) AS avg_q,
       AVG(wr_refunded_cash) AS avg_cash,
       AVG(wr_fee) AS avg_fee
FROM web_sales, web_returns, web_page, customer_demographics cd1,
     customer_demographics cd2, customer_address, date_dim, reason
WHERE ws_web_page_sk = wp_web_page_sk
  AND ws_item_sk = wr_item_sk
  AND ws_order_number = wr_order_number
  AND ws_sold_date_sk = d_date_sk AND d_year = 2000
  AND cd1.cd_demo_sk = wr_refunded_cdemo_sk
  AND cd2.cd_demo_sk = wr_returning_cdemo_sk
  AND ca_address_sk = wr_refunded_addr_sk
  AND r_reason_sk = wr_reason_sk
  AND ((cd1.cd_marital_status = 'M'
        AND cd1.cd_marital_status = cd2.cd_marital_status
        AND cd1.cd_education_status = 'Advanced Degree'
        AND cd1.cd_education_status = cd2.cd_education_status
        AND ws_sales_price BETWEEN 100.00 AND 150.00)
       OR (cd1.cd_marital_status = 'S'
           AND cd1.cd_marital_status = cd2.cd_marital_status
           AND cd1.cd_education_status = 'College'
           AND cd1.cd_education_status = cd2.cd_education_status
           AND ws_sales_price BETWEEN 50.00 AND 100.00)
       OR (cd1.cd_marital_status = 'W'
           AND cd1.cd_marital_status = cd2.cd_marital_status
           AND cd1.cd_education_status = '2 yr Degree'
           AND cd1.cd_education_status = cd2.cd_education_status
           AND ws_sales_price BETWEEN 150.00 AND 200.00))
  AND ((ca_country = 'United States'
        AND ca_state IN ('CA', 'TX', 'NY')
        AND ws_net_profit BETWEEN 100 AND 200)
       OR (ca_country = 'United States'
           AND ca_state IN ('WA', 'OR', 'TN')
           AND ws_net_profit BETWEEN 150 AND 300)
       OR (ca_country = 'United States'
           AND ca_state IN ('SD', 'GA', 'NM')
           AND ws_net_profit BETWEEN 50 AND 250))
GROUP BY r_reason_desc
ORDER BY substr(r_reason_desc, 1, 20), avg_q, avg_cash, avg_fee
LIMIT 100
""",
    86: """
SELECT SUM(ws_net_paid) AS total_sum, i_category, i_class,
       GROUPING(i_category) + GROUPING(i_class) AS lochierarchy,
       RANK() OVER (PARTITION BY GROUPING(i_category)
                                 + GROUPING(i_class),
                                 CASE WHEN GROUPING(i_class) = 0
                                      THEN i_category END
                    ORDER BY SUM(ws_net_paid) DESC) AS rank_within_parent
FROM web_sales, date_dim d1, item
WHERE d1.d_month_seq BETWEEN 1200 AND 1200 + 11
  AND d1.d_date_sk = ws_sold_date_sk
  AND i_item_sk = ws_item_sk
GROUP BY ROLLUP (i_category, i_class)
ORDER BY lochierarchy DESC,
         CASE WHEN GROUPING(i_category) + GROUPING(i_class) = 0
              THEN i_category END,
         rank_within_parent
LIMIT 100
""",
    87: """
SELECT COUNT(*) AS cnt
FROM ((SELECT DISTINCT c_last_name, c_first_name, d_date
       FROM store_sales, date_dim, customer
       WHERE ss_sold_date_sk = d_date_sk
         AND ss_customer_sk = c_customer_sk
         AND d_month_seq BETWEEN 1200 AND 1200 + 11)
      EXCEPT
      (SELECT DISTINCT c_last_name, c_first_name, d_date
       FROM catalog_sales, date_dim, customer
       WHERE cs_sold_date_sk = d_date_sk
         AND cs_bill_customer_sk = c_customer_sk
         AND d_month_seq BETWEEN 1200 AND 1200 + 11)
      EXCEPT
      (SELECT DISTINCT c_last_name, c_first_name, d_date
       FROM web_sales, date_dim, customer
       WHERE ws_sold_date_sk = d_date_sk
         AND ws_bill_customer_sk = c_customer_sk
         AND d_month_seq BETWEEN 1200 AND 1200 + 11)) cool_cust
""",
    88: """
SELECT *
FROM
 (SELECT COUNT(*) AS h8_30_to_9 FROM store_sales, household_demographics,
         time_dim, store
  WHERE ss_sold_time_sk = t_time_sk AND ss_hdemo_sk = hd_demo_sk
    AND ss_store_sk = s_store_sk AND t_hour = 8 AND t_minute >= 30
    AND ((hd_dep_count = 4 AND hd_vehicle_count <= 6)
         OR (hd_dep_count = 2 AND hd_vehicle_count <= 4)
         OR (hd_dep_count = 0 AND hd_vehicle_count <= 2))
    AND s_store_name = 'ese') s1,
 (SELECT COUNT(*) AS h9_to_9_30 FROM store_sales, household_demographics,
         time_dim, store
  WHERE ss_sold_time_sk = t_time_sk AND ss_hdemo_sk = hd_demo_sk
    AND ss_store_sk = s_store_sk AND t_hour = 9 AND t_minute < 30
    AND ((hd_dep_count = 4 AND hd_vehicle_count <= 6)
         OR (hd_dep_count = 2 AND hd_vehicle_count <= 4)
         OR (hd_dep_count = 0 AND hd_vehicle_count <= 2))
    AND s_store_name = 'ese') s2,
 (SELECT COUNT(*) AS h9_30_to_10 FROM store_sales, household_demographics,
         time_dim, store
  WHERE ss_sold_time_sk = t_time_sk AND ss_hdemo_sk = hd_demo_sk
    AND ss_store_sk = s_store_sk AND t_hour = 9 AND t_minute >= 30
    AND ((hd_dep_count = 4 AND hd_vehicle_count <= 6)
         OR (hd_dep_count = 2 AND hd_vehicle_count <= 4)
         OR (hd_dep_count = 0 AND hd_vehicle_count <= 2))
    AND s_store_name = 'ese') s3,
 (SELECT COUNT(*) AS h10_to_10_30 FROM store_sales,
         household_demographics, time_dim, store
  WHERE ss_sold_time_sk = t_time_sk AND ss_hdemo_sk = hd_demo_sk
    AND ss_store_sk = s_store_sk AND t_hour = 10 AND t_minute < 30
    AND ((hd_dep_count = 4 AND hd_vehicle_count <= 6)
         OR (hd_dep_count = 2 AND hd_vehicle_count <= 4)
         OR (hd_dep_count = 0 AND hd_vehicle_count <= 2))
    AND s_store_name = 'ese') s4
""",
    89: """
WITH tmp1 AS (
  SELECT i_category, i_class, i_brand, s_store_name, s_company_name,
         d_moy, SUM(ss_sales_price) AS sum_sales
  FROM item, store_sales, date_dim, store
  WHERE ss_item_sk = i_item_sk
    AND ss_sold_date_sk = d_date_sk
    AND ss_store_sk = s_store_sk
    AND d_year = 2000
    AND ((i_category IN ('Books', 'Electronics', 'Sports')
          AND i_class IN ('computers', 'stereo', 'football'))
         OR (i_category IN ('Men', 'Jewelry', 'Women')
             AND i_class IN ('shirts', 'birdal', 'dresses')))
  GROUP BY i_category, i_class, i_brand, s_store_name, s_company_name,
           d_moy
), tmp2 AS (
  SELECT i_category, i_class, i_brand, s_store_name, s_company_name,
         d_moy, sum_sales,
         AVG(sum_sales) OVER (
             PARTITION BY i_category, i_brand, s_store_name,
                          s_company_name) AS avg_monthly_sales
  FROM tmp1
)
SELECT i_category, i_class, i_brand, s_store_name, s_company_name, d_moy,
       sum_sales, avg_monthly_sales
FROM tmp2
WHERE CASE WHEN avg_monthly_sales <> 0
           THEN abs(sum_sales - avg_monthly_sales) / avg_monthly_sales
           ELSE NULL END > 0.1
ORDER BY sum_sales - avg_monthly_sales, s_store_name, i_category,
         i_class, i_brand, d_moy
LIMIT 100
""",
    90: """
SELECT CAST(amc AS DOUBLE) / CAST(pmc AS DOUBLE) AS am_pm_ratio
FROM (SELECT COUNT(*) AS amc
      FROM web_sales, household_demographics, time_dim, web_page
      WHERE ws_sold_time_sk = t_time_sk
        AND ws_ship_hdemo_sk = hd_demo_sk
        AND ws_web_page_sk = wp_web_page_sk
        AND t_hour BETWEEN 8 AND 9
        AND hd_dep_count = 6
        AND wp_char_count BETWEEN 5000 AND 5200) at_,
     (SELECT COUNT(*) AS pmc
      FROM web_sales, household_demographics, time_dim, web_page
      WHERE ws_sold_time_sk = t_time_sk
        AND ws_ship_hdemo_sk = hd_demo_sk
        AND ws_web_page_sk = wp_web_page_sk
        AND t_hour BETWEEN 19 AND 20
        AND hd_dep_count = 6
        AND wp_char_count BETWEEN 5000 AND 5200) pt
ORDER BY am_pm_ratio
LIMIT 100
""",
    91: """
SELECT cc_call_center_id AS call_center, cc_name AS center_name,
       cc_manager AS manager, SUM(cr_net_loss) AS returns_loss
FROM call_center, catalog_returns, date_dim, customer,
     customer_demographics, household_demographics
WHERE cr_call_center_sk = cc_call_center_sk
  AND cr_returned_date_sk = d_date_sk
  AND cr_returning_customer_sk = c_customer_sk
  AND cd_demo_sk = c_current_cdemo_sk
  AND hd_demo_sk = c_current_hdemo_sk
  AND d_year = 2000 AND d_moy = 11
  AND ((cd_marital_status = 'M' AND cd_education_status = 'Unknown')
       OR (cd_marital_status = 'W'
           AND cd_education_status = 'Advanced Degree'))
  AND hd_buy_potential LIKE 'Unknown%'
GROUP BY cc_call_center_id, cc_name, cc_manager, cd_marital_status,
         cd_education_status
ORDER BY returns_loss DESC
""",
    92: """
SELECT SUM(ws_ext_discount_amt) AS excess_discount_amount
FROM web_sales, item, date_dim
WHERE i_manufact_id = 77
  AND i_item_sk = ws_item_sk
  AND d_date BETWEEN DATE '2000-01-27'
                 AND DATE '2000-01-27' + INTERVAL '90' DAY
  AND d_date_sk = ws_sold_date_sk
  AND ws_ext_discount_amt > (
      SELECT 1.3 * AVG(ws_ext_discount_amt)
      FROM web_sales ws2, date_dim d2
      WHERE ws2.ws_item_sk = i_item_sk
        AND d2.d_date BETWEEN DATE '2000-01-27'
                          AND DATE '2000-01-27' + INTERVAL '90' DAY
        AND d2.d_date_sk = ws2.ws_sold_date_sk)
ORDER BY excess_discount_amount
LIMIT 100
""",
    93: """
SELECT ss_customer_sk, SUM(act_sales) AS sumsales
FROM (SELECT ss_item_sk, ss_ticket_number, ss_customer_sk,
             CASE WHEN sr_return_quantity IS NOT NULL
                  THEN (ss_quantity - sr_return_quantity) * ss_sales_price
                  ELSE ss_quantity * ss_sales_price END AS act_sales
      FROM store_sales
      LEFT JOIN store_returns
        ON sr_item_sk = ss_item_sk AND sr_ticket_number = ss_ticket_number
      , reason
      WHERE sr_reason_sk = r_reason_sk AND r_reason_desc = 'reason 1') t
GROUP BY ss_customer_sk
ORDER BY sumsales, ss_customer_sk
LIMIT 100
""",
    94: """
SELECT COUNT(DISTINCT ws_order_number) AS order_count,
       SUM(ws_ext_ship_cost) AS total_shipping_cost,
       SUM(ws_net_profit) AS total_net_profit
FROM web_sales ws1, date_dim, customer_address, web_site
WHERE d_date BETWEEN DATE '2000-02-01'
                 AND DATE '2000-02-01' + INTERVAL '60' DAY
  AND ws1.ws_ship_date_sk = d_date_sk
  AND ws1.ws_ship_addr_sk = ca_address_sk
  AND ca_state = 'CA'
  AND ws1.ws_web_site_sk = web_site_sk
  AND web_company_name = 'pri'
  AND EXISTS (SELECT 1 FROM web_sales ws2
              WHERE ws1.ws_order_number = ws2.ws_order_number
                AND ws1.ws_warehouse_sk <> ws2.ws_warehouse_sk)
  AND NOT EXISTS (SELECT 1 FROM web_returns wr1
                  WHERE ws1.ws_order_number = wr1.wr_order_number)
ORDER BY order_count
LIMIT 100
""",
    95: """
WITH ws_wh AS (
  SELECT ws1.ws_order_number, ws1.ws_warehouse_sk AS wh1,
         ws2.ws_warehouse_sk AS wh2
  FROM web_sales ws1, web_sales ws2
  WHERE ws1.ws_order_number = ws2.ws_order_number
    AND ws1.ws_warehouse_sk <> ws2.ws_warehouse_sk
)
SELECT COUNT(DISTINCT ws_order_number) AS order_count,
       SUM(ws_ext_ship_cost) AS total_shipping_cost,
       SUM(ws_net_profit) AS total_net_profit
FROM web_sales ws1, date_dim, customer_address, web_site
WHERE d_date BETWEEN DATE '2000-02-01'
                 AND DATE '2000-02-01' + INTERVAL '60' DAY
  AND ws1.ws_ship_date_sk = d_date_sk
  AND ws1.ws_ship_addr_sk = ca_address_sk
  AND ca_state = 'CA'
  AND ws1.ws_web_site_sk = web_site_sk
  AND web_company_name = 'pri'
  AND ws1.ws_order_number IN (SELECT ws_order_number FROM ws_wh)
  AND ws1.ws_order_number IN (SELECT wr_order_number
                              FROM web_returns, ws_wh
                              WHERE wr_order_number = ws_wh.ws_order_number)
ORDER BY order_count
LIMIT 100
""",
    96: """
SELECT COUNT(1) AS cnt
FROM store_sales, household_demographics, time_dim, store
WHERE ss_sold_time_sk = t_time_sk
  AND ss_hdemo_sk = hd_demo_sk
  AND ss_store_sk = s_store_sk
  AND t_hour = 20
  AND t_minute >= 30
  AND hd_dep_count = 7
ORDER BY cnt
LIMIT 100
""",
    97: """
WITH ssci AS (
  SELECT ss_customer_sk AS customer_sk, ss_item_sk AS item_sk
  FROM store_sales, date_dim
  WHERE ss_sold_date_sk = d_date_sk
    AND d_month_seq BETWEEN 1200 AND 1200 + 11
  GROUP BY ss_customer_sk, ss_item_sk
), csci AS (
  SELECT cs_bill_customer_sk AS customer_sk, cs_item_sk AS item_sk
  FROM catalog_sales, date_dim
  WHERE cs_sold_date_sk = d_date_sk
    AND d_month_seq BETWEEN 1200 AND 1200 + 11
  GROUP BY cs_bill_customer_sk, cs_item_sk
)
SELECT SUM(CASE WHEN ssci.customer_sk IS NOT NULL
                 AND csci.customer_sk IS NULL THEN 1 ELSE 0 END)
           AS store_only,
       SUM(CASE WHEN ssci.customer_sk IS NULL
                 AND csci.customer_sk IS NOT NULL THEN 1 ELSE 0 END)
           AS catalog_only,
       SUM(CASE WHEN ssci.customer_sk IS NOT NULL
                 AND csci.customer_sk IS NOT NULL THEN 1 ELSE 0 END)
           AS store_and_catalog
FROM ssci
FULL OUTER JOIN csci
  ON ssci.customer_sk = csci.customer_sk AND ssci.item_sk = csci.item_sk
LIMIT 100
""",
    98: """
WITH revenue AS (
  SELECT i_item_id, i_item_desc, i_category, i_class, i_current_price,
         SUM(ss_ext_sales_price) AS itemrevenue
  FROM store_sales, item, date_dim
  WHERE ss_item_sk = i_item_sk
    AND ss_sold_date_sk = d_date_sk
    AND i_category IN ('Sports', 'Books', 'Home')
    AND d_year = 2000
    AND d_moy BETWEEN 2 AND 4
  GROUP BY i_item_id, i_item_desc, i_category, i_class, i_current_price
)
SELECT i_item_id, i_item_desc, i_category, i_class, i_current_price,
       itemrevenue,
       itemrevenue * 100.0 / SUM(itemrevenue) OVER (PARTITION BY i_class)
           AS revenueratio
FROM revenue
ORDER BY i_category, i_class, i_item_id, i_item_desc, revenueratio
""",
    99: """
SELECT substr(w_warehouse_name, 1, 20) AS wh, sm_type, cc_name,
       SUM(CASE WHEN cs_ship_date_sk - cs_sold_date_sk <= 30
                THEN 1 ELSE 0 END) AS days_30,
       SUM(CASE WHEN cs_ship_date_sk - cs_sold_date_sk > 30
                 AND cs_ship_date_sk - cs_sold_date_sk <= 60
                THEN 1 ELSE 0 END) AS days_31_60,
       SUM(CASE WHEN cs_ship_date_sk - cs_sold_date_sk > 60
                 AND cs_ship_date_sk - cs_sold_date_sk <= 90
                THEN 1 ELSE 0 END) AS days_61_90,
       SUM(CASE WHEN cs_ship_date_sk - cs_sold_date_sk > 90
                 AND cs_ship_date_sk - cs_sold_date_sk <= 120
                THEN 1 ELSE 0 END) AS days_91_120,
       SUM(CASE WHEN cs_ship_date_sk - cs_sold_date_sk > 120
                THEN 1 ELSE 0 END) AS days_over_120
FROM catalog_sales, warehouse, ship_mode, call_center, date_dim
WHERE d_month_seq BETWEEN 1212 AND 1212 + 11
  AND cs_ship_date_sk = d_date_sk
  AND cs_warehouse_sk = w_warehouse_sk
  AND cs_ship_mode_sk = sm_ship_mode_sk
  AND cs_call_center_sk = cc_call_center_sk
GROUP BY substr(w_warehouse_name, 1, 20), sm_type, cc_name
ORDER BY wh, sm_type, cc_name
LIMIT 100
""",
}


def tables_of(qnum: int):
    """The tables a query names (``store`` never matches inside
    ``store_sales``: underscores are word characters)."""
    sql = ALL[qnum]
    return [t for t in TABLES if re.search(rf"\b{t}\b", sql)]


def run(qnum: int, get_df: GetDF, cut: bool = True) -> DataFrame:
    """Plan a query with only its tables bound from ``get_df(name)``;
    with ``cut=False``, without its final ``LIMIT``."""
    from .. import sql
    text = ALL[qnum] if cut else _LIMIT.sub("", ALL[qnum].strip())
    return sql(text, **{name: get_df(name) for name in tables_of(qnum)})


def region_counters(counters: dict) -> dict:
    """The fusion-region counters of a ``runtime.counters()`` dict:
    dispatches per shape, ladder climbs, builds and declines by cause."""
    return {k: v for k, v in counters.items() if k.startswith("region_")}


def both_tiers(qnum: int, get_df: GetDF) -> dict:
    """One query on the device tier (the caller's knobs; the device column
    cache cleared first), then on the host tier → answers, walls and the
    device run's counters."""
    import time

    from ..context import execution_config_ctx
    from ..device import backend, cache, runtime
    cache.get_cache().clear()
    runtime.reset_counters()
    t0 = time.perf_counter()
    device = run(qnum, get_df).to_pydict()
    dev = backend.resolve_device()
    if dev is not None and dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)
    device_s = time.perf_counter() - t0
    counters = runtime.counters()
    with execution_config_ctx(device="0"):
        t0 = time.perf_counter()
        host = run(qnum, get_df).to_pydict()
        host_s = time.perf_counter() - t0
    return dict(device=device, host=host, device_s=device_s, host_s=host_s,
                counters=counters)



# ---------------------------------------------------------------------------
# the order oracle: rows that tie on every ORDER BY key may come in any order


def _minus(a: str, b: str) -> Callable[[dict], object]:
    """The key ``a - b`` of two output columns (Q47, Q57, Q89)."""
    def key(row):
        x, y = row[a], row[b]
        return None if x is None or y is None else x - y
    key.__name__ = f"{a} - {b}"
    return key


def _when_zero(flag: str, then: str) -> Callable[[dict], object]:
    """The key ``CASE WHEN flag = 0 THEN then END`` (Q36, Q70, Q86, whose
    ``GROUPING`` sums are the ``lochierarchy`` column)."""
    def key(row):
        return row[then] if row[flag] == 0 else None
    key.__name__ = f"CASE WHEN {flag} = 0 THEN {then} END"
    return key


#: each query's ``ORDER BY`` keys, in order, as its output columns (a key
#: that is an expression of output columns is a function of the row); a
#: query without ``ORDER BY`` has none, so its whole answer is one run
ORDER_KEYS: Dict[int, tuple] = {
    1: ("c_customer_id",),
    2: ("d_week_seq1",),
    3: ("d_year", "sum_agg", "i_brand_id"),
    4: ("customer_id", "customer_first_name", "customer_last_name",
        "customer_preferred_cust_flag"),
    5: ("channel", "id"),
    6: ("cnt", "state"),
    7: ("i_item_id",),
    8: ("s_store_name",),
    9: (),
    10: ("cd_gender", "cd_marital_status", "cd_education_status",
         "cd_purchase_estimate", "cd_credit_rating", "cd_dep_count",
         "cd_dep_employed_count", "cd_dep_college_count"),
    11: ("customer_id", "customer_first_name", "customer_last_name",
         "customer_preferred_cust_flag"),
    12: ("i_category", "i_class", "i_item_id", "i_item_desc",
         "revenueratio"),
    13: (),
    14: ("channel", "i_brand_id", "i_class_id", "i_category_id"),
    15: ("ca_zip",),
    16: ("order_count",),
    17: ("i_item_id", "i_item_desc", "s_state"),
    18: ("ca_country", "ca_state", "ca_county", "i_item_id"),
    19: ("ext_price", "i_brand_id", "i_manufact_id"),
    20: ("i_category", "i_class", "i_item_id", "i_item_desc",
         "revenueratio"),
    21: ("w_warehouse_name", "i_item_id"),
    22: ("qoh", "i_product_name", "i_brand", "i_class", "i_category"),
    23: ("c_last_name", "c_first_name", "sales"),
    24: ("c_last_name", "c_first_name", "s_store_name"),
    25: ("i_item_id", "i_item_desc", "s_store_id", "s_store_name"),
    26: ("i_item_id",),
    27: ("i_item_id", "s_state"),
    28: (),
    29: ("i_item_id", "i_item_desc", "s_store_id", "s_store_name"),
    30: ("c_customer_id", "c_salutation", "c_first_name", "c_last_name"),
    31: ("ca_county",),
    32: ("excess_discount_amount",),
    33: ("total_sales",),
    34: ("c_last_name", "c_first_name", "ss_ticket_number"),
    35: ("ca_state", "cd_gender", "cd_marital_status", "cd_dep_count",
         "cd_dep_employed_count", "cd_dep_college_count"),
    36: ("lochierarchy", _when_zero("lochierarchy", "i_category"),
         "rank_within_parent"),
    37: ("i_item_id",),
    38: (),
    39: ("wsk1", "isk1", "moy1", "mean1", "cov1"),
    40: ("w_state", "i_item_id"),
    41: ("i_product_name",),
    42: ("sum_sales", "d_year", "i_category_id", "i_category"),
    43: ("s_store_name", "s_store_sk"),
    44: ("rnk",),
    45: ("ca_zip", "ca_city"),
    46: ("c_last_name", "c_first_name", "current_city", "bought_city",
         "ss_ticket_number"),
    47: (_minus("sum_sales", "avg_monthly_sales"), "i_category", "i_brand",
         "s_store_name", "s_company_name", "d_year", "d_moy"),
    48: (),
    49: ("channel", "return_rank", "currency_rank", "item"),
    50: ("s_store_name", "s_company_id"),
    51: ("item_sk", "d_date"),
    52: ("d_year", "ext_price", "i_brand_id"),
    53: ("avg_quarterly_sales", "sum_sales", "i_manufact_id"),
    54: ("segment", "num_customers", "segment_base"),
    55: ("ext_price", "i_brand_id"),
    56: ("total_sales", "i_item_id"),
    57: (_minus("sum_sales", "avg_monthly_sales"), "cc_name"),
    58: ("item_id", "ss_item_rev"),
    59: ("s_store_name1", "s_store_id1", "d_week_seq1"),
    60: ("i_item_id", "total_sales"),
    61: ("promotions", "total"),
    62: ("wh", "sm_type", "web_name"),
    63: ("i_manager_id", "avg_monthly_sales", "sum_sales"),
    64: ("product_name", "store_name", "cnt", "s11", "s12"),
    65: ("s_store_name", "i_item_desc"),
    66: ("w_warehouse_name",),
    67: ("i_category", "i_class", "i_brand", "i_product_name", "d_year",
         "d_qoy", "d_moy", "s_store_id", "sumsales", "rk"),
    68: ("c_last_name", "ss_ticket_number"),
    69: ("cd_gender", "cd_marital_status", "cd_education_status",
         "cd_purchase_estimate", "cd_credit_rating"),
    70: ("lochierarchy", _when_zero("lochierarchy", "s_state"),
         "rank_within_parent"),
    71: ("ext_price", "brand_id"),
    72: ("total_cnt", "i_item_desc", "w_warehouse_name", "d_week_seq"),
    73: ("cnt", "c_last_name"),
    74: ("customer_id",),
    75: ("sales_cnt_diff", "sales_amt_diff"),
    76: ("channel", "col_name", "d_year", "d_qoy", "i_category"),
    77: ("channel", "id"),
    78: ("ss_sold_year", "ss_item_sk", "ss_customer_sk", "store_qty",
         "store_wholesale_cost", "store_sales_price", "other_chan_qty",
         "other_chan_wholesale_cost", "other_chan_sales_price", "ratio"),
    79: ("c_last_name", "c_first_name", "city", "profit"),
    80: ("channel", "id"),
    81: ("c_customer_id", "c_salutation", "c_first_name", "c_last_name"),
    82: ("i_item_id",),
    83: ("item_id", "sr_item_qty"),
    84: ("customer_id",),
    85: ("reason_desc", "avg_q", "avg_cash", "avg_fee"),
    86: ("lochierarchy", _when_zero("lochierarchy", "i_category"),
         "rank_within_parent"),
    87: (),
    88: (),
    89: (_minus("sum_sales", "avg_monthly_sales"), "s_store_name",
         "i_category", "i_class", "i_brand", "d_moy"),
    90: ("am_pm_ratio",),
    91: ("returns_loss",),
    92: ("excess_discount_amount",),
    93: ("sumsales", "ss_customer_sk"),
    94: ("order_count",),
    95: ("order_count",),
    96: ("cnt",),
    97: (),
    98: ("i_category", "i_class", "i_item_id", "i_item_desc",
         "revenueratio"),
    99: ("wh", "sm_type", "cc_name"),
}


_LIMIT = re.compile(r"\bLIMIT\s+(\d+)\s*;?\s*$", re.I)


def limit_of(qnum: int):
    """The query's final ``LIMIT``, or None."""
    m = _LIMIT.search(ALL[qnum].strip())
    return int(m.group(1)) if m else None


def _key_fns(keys) -> list:
    return [k if callable(k) else (lambda row, k=k: row[k]) for k in keys]


def _near(a, b, rel: float) -> bool:
    """Exact, but floats at relative ``rel`` (NaN equal to NaN)."""
    if isinstance(a, float) and isinstance(b, float):
        return (a != a and b != b) or abs(a - b) <= max(
            rel * max(abs(a), abs(b)), 1e-12)
    return a == b


def _rows(d: dict) -> list:
    cols = list(d)
    n = len(d[cols[0]]) if cols else 0
    return [{c: d[c][i] for c in cols} for i in range(n)]


def tie_runs(answer: dict, keys, rel: float = 1e-9) -> list:
    """``[start, end)`` of each run of adjacent rows whose ``keys`` are
    equal (floats within ``rel``)."""
    fns = _key_fns(keys)
    vals = [tuple(f(r) for f in fns) for r in _rows(answer)]
    out, i = [], 0
    while i < len(vals):
        j = i + 1
        while j < len(vals) and all(
                _near(a, b, rel) for a, b in zip(vals[j], vals[i])):
            j += 1
        out.append((i, j))
        i = j
    return out


def cut_run(full: dict, keys, limit: int, rel: float = 1e-9):
    """The rows of ``full`` (an answer without its ``LIMIT``) in the run of
    equal keys that the cut after row ``limit`` splits, or None where the
    cut falls between two runs."""
    for s, e in tie_runs(full, keys, rel):
        if s < limit < e:
            return _rows(full)[s:e]
    return None


def same_order(got: dict, want: dict, keys, rel: float = 1e-9,
               cut_pool=None) -> list:
    """Hold ``got`` to ``want`` as an ordered answer whose rows tie on
    ``keys``: the same columns and row count; the keys row for row; and
    the rows inside each run of equal keys (``want``'s runs) as a
    multiset, exact but floats at relative ``rel``. With ``cut_pool`` (a
    ``LIMIT`` cuts the last run, whose rows are then any of the tied
    ones: the whole run's rows in the answer without the ``LIMIT``,
    ``cut_run``) the last run's rows as a multiset drawn from the pool.
    Never sorts whole rows across runs. → ``want``'s runs; raises
    AssertionError naming the first difference."""
    if list(got) != list(want):
        raise AssertionError(f"columns {list(got)} != {list(want)}")
    g, w = _rows(got), _rows(want)
    if len(g) != len(w):
        raise AssertionError(f"{len(g)} rows, not {len(w)}")
    fns = _key_fns(keys)
    for i, (a, b) in enumerate(zip(g, w)):
        for k, f in zip(keys, fns):
            if not _near(f(a), f(b), rel):
                raise AssertionError(
                    f"row {i}: key {getattr(k, '__name__', k)} "
                    f"{f(a)!r} vs {f(b)!r}")
    runs = tie_runs(want, keys, rel)
    for n, (s, e) in enumerate(runs):
        left = list(cut_pool if n == len(runs) - 1 and cut_pool is not None
                    else w[s:e])
        for r in g[s:e]:
            hit = next((j for j, x in enumerate(left)
                        if all(_near(r[c], x[c], rel) for c in x)), None)
            if hit is None:
                raise AssertionError(
                    f"rows {s}..{e - 1} (tied on the keys): {r!r} is not "
                    f"among the reference's {left!r}")
            left.pop(hit)
    return runs

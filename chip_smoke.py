#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``trino_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # what the card check runs: SF1, then SF10

Phases (each one fails the run, with a non-zero exit, on any mismatch or error):

1. The card: the ``nvidia-smi`` name/power-limit line; build the CUDA kernels
   from ``trino_tpu_torch/csrc`` (one ``nvcc`` per source, all at once).
2. TPC-H end to end at SF1 (``TpchConnector(sf=1, split_rows=1<<21)``, the
   scale and split size of ``bench.py``): bench.py's five queries and the 17
   other queries of tests/test_sql_tpch*.py (Q15 over the view ``Q15_VIEW``
   creates first) through
   ``Engine(device="cuda").execute_sql``, cold and warm, with host reads and
   peak device memory per query.  Every kernel launch counter is set to 0
   just before and read just after; each query must launch the kernels that
   ``REQUIRED`` names (the kernels the JAX reference's SF1 path reaches), and
   every kernel but ``fused_segment_agg`` (which has no caller in the engine,
   as in the reference) must launch.  Each result is held against the same
   query run by the port on the CPU.
3. Each kernel against its plain PyTorch version on the card: insert, probe
   and compaction at the largest and the most frequent shape they launched
   at in phase 2, compaction also at its most selective shape with rows
   past out_len dropped, and insert also on the main path's own keys
   (``l_orderkey`` of the first SF1 lineitem split), in both its forms (in
   place and functional); the probe in both payload modes (a payload array,
   and the slot index), over a table the CUDA insert built, and
   ``hashjoin.probe`` around it; insert on observables, probe and compaction
   bit for bit.  ``fused_segment_agg`` at Q1's group-by shape over the first
   SF1 lineitem split and at its 128-slot ceiling (counts exactly, sums
   against a float64 sum of the same inputs).  Times are CUDA-event medians
   after warm-up; every kernel's call is also split into kernel-only device
   time, other device work, idle and host time (``device_split``).
4. bench.py's five queries at SF10 on the card alone: warm wall time and
   lineitem rows/s.
5. TPC-DS parity: every query of the TPC-DS corpus (the SQL of
   tests/test_tpcds*.py, read by ``trino_tpu_torch/connectors/tpcds_queries.py``)
   at SF0.1 on the card and on the CPU; each card result must equal the CPU
   result.  The plan nodes each query runs (its
   plan-time subqueries included) are recorded here.
6. TPC-DS at SF1 (``TpcdsConnector(sf=1, split_rows=1<<21)``, ~2.88M
   store_sales rows): every corpus query on the card, cold and warm, with
   host reads, peak device memory and the launches of each kernel; the
   counters are set to 0 just before the run and read just after, each
   query must launch the kernels that ``TPCDS_REQUIRED`` names (those the
   JAX reference's SF1 path reaches), and the run as a whole must launch
   every one of them.  Queries that run a Window, Union, Values or a Limit
   over anything but a Sort are also held against the port's CPU run at SF1.
   Then each kernel the run launched is held against its plain version at
   this path's own shapes, as in phase 3 (``tpcds_kernel_checks``; the
   most selective compaction is a streaming LIMIT's; insert also on
   ``ss_ticket_number``); the kernels line reports each path's launches and
   checks under ``by_path``.
7. Five TPC-DS queries at SF10 on the card alone (the star join, cumulative
   frames, the rollup union and windows over an aggregate): warm wall,
   store_sales rows/s and peak memory.
8. The memory catalog at SF1: TPC-H's refresh functions (``refresh_path``)
   over memory copies of orders and lineitem, with ``tpch`` at SF1 beside
   them: CTAS of both tables, RF1 (MERGE as an upsert of the last 1500
   orders, INSERT of their line items), the query block (``MEMORY_QUERIES``,
   Q15 through its view, cold and warm, between two checksums of the stored
   tables that must be equal), RF2 (DELETE of the first 1500 orders and
   their line items, an UPDATE to a constant and one to an expression), the
   query block again.  Each statement's seconds, host reads, peak device
   memory, launches per kernel and host RSS; affected rows equal to what
   ``tpch`` counts in each key band; the results after RF1 equal phase 2's
   over ``tpch`` (strings by value), those after RF2 equal the port's CPU
   run of the whole sequence; every kernel ``MEMORY_REQUIRED`` names is
   launched (the JAX reference's recording), and DELETE compacts the stored
   lineitem in one ``compact_rows`` launch per 16 arrays.  Then the kernels
   against their plain versions at this path's shapes (the probe of a
   memory lineitem page, the insert at the orders build's shape and on
   ``o_orderkey``, compaction, also on DELETE's own inputs); the kernels
   line's ``by_path`` gains ``memory_sf1``.

It prints the card line, then one JSON line with every kernel's numbers, and
last ``{"ok": true, "device": {...}}``.  Without a card, or without the
package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

# bench.py's QUERIES, as bench.py states them
QUERIES = {
    "q1": """
    select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
           sum(l_extendedprice) as sum_base_price,
           sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
           sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
           avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price,
           avg(l_discount) as avg_disc, count(*) as count_order
    from lineitem where l_shipdate <= date '1998-12-01' - interval '90' day
    group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus""",
    "q3": """
    select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
           o_orderdate, o_shippriority
    from customer, orders, lineitem
    where c_mktsegment = 'BUILDING' and c_custkey = o_custkey
      and l_orderkey = o_orderkey and o_orderdate < date '1995-03-15'
      and l_shipdate > date '1995-03-15'
    group by l_orderkey, o_orderdate, o_shippriority
    order by revenue desc, o_orderdate limit 10""",
    "q4": """
    select o_orderpriority, count(*) as order_count from orders
    where o_orderdate >= date '1993-07-01'
      and o_orderdate < date '1993-07-01' + interval '3' month
      and exists (select 1 from lineitem where l_orderkey = o_orderkey
                  and l_commitdate < l_receiptdate)
    group by o_orderpriority order by o_orderpriority""",
    "q9": """
    select nation, o_year, sum(amount) as sum_profit from (
      select n_name as nation, extract(year from o_orderdate) as o_year,
        l_extendedprice * (1 - l_discount) - ps_supplycost * l_quantity as amount
      from part, supplier, lineitem, partsupp, orders, nation
      where s_suppkey = l_suppkey and ps_suppkey = l_suppkey and ps_partkey = l_partkey
        and p_partkey = l_partkey and o_orderkey = l_orderkey
        and s_nationkey = n_nationkey and p_name like '%green%') as profit
    group by nation, o_year order by nation, o_year desc""",
    "q18": """
    select c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice, sum(l_quantity)
    from customer, orders, lineitem
    where o_orderkey in (select l_orderkey from lineitem group by l_orderkey
                         having sum(l_quantity) > 300)
      and c_custkey = o_custkey and o_orderkey = l_orderkey
    group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
    order by o_totalprice desc, o_orderdate limit 100""",
}

# the rest of TPC-H, as tests/test_sql_tpch*.py state them (Q15 reads the
# view that Q15_VIEW creates)
TPCH_QUERIES = {
    "q2": """
        select s_acctbal, s_name, n_name, p_partkey, p_mfgr, s_address, s_phone, s_comment
        from part, supplier, partsupp, nation, region
        where p_partkey = ps_partkey and s_suppkey = ps_suppkey and p_size = 15
          and p_type like '%BRASS' and s_nationkey = n_nationkey
          and n_regionkey = r_regionkey and r_name = 'EUROPE'
          and ps_supplycost = (
              select min(ps_supplycost) from partsupp, supplier, nation, region
              where p_partkey = ps_partkey and s_suppkey = ps_suppkey
                and s_nationkey = n_nationkey and n_regionkey = r_regionkey
                and r_name = 'EUROPE')
        order by s_acctbal desc, n_name, s_name, p_partkey
        limit 100""",
    "q5": """
        select n_name, sum(l_extendedprice * (1 - l_discount)) as revenue
        from customer, orders, lineitem, supplier, nation, region
        where c_custkey = o_custkey and l_orderkey = o_orderkey
          and l_suppkey = s_suppkey and c_nationkey = s_nationkey
          and s_nationkey = n_nationkey and n_regionkey = r_regionkey
          and r_name = 'ASIA' and o_orderdate >= date '1994-01-01'
          and o_orderdate < date '1994-01-01' + interval '1' year
        group by n_name order by revenue desc""",
    "q6": """
        select sum(l_extendedprice * l_discount) as revenue
        from lineitem
        where l_shipdate >= date '1994-01-01'
          and l_shipdate < date '1994-01-01' + interval '1' year
          and l_discount between 0.05 and 0.07
          and l_quantity < 24""",
    "q7": """
        select supp_nation, cust_nation, l_year, sum(volume) as revenue
        from (select n1.n_name as supp_nation, n2.n_name as cust_nation,
                     extract(year from l_shipdate) as l_year,
                     l_extendedprice * (1 - l_discount) as volume
              from supplier, lineitem, orders, customer, nation n1, nation n2
              where s_suppkey = l_suppkey and o_orderkey = l_orderkey
                and c_custkey = o_custkey and s_nationkey = n1.n_nationkey
                and c_nationkey = n2.n_nationkey
                and ((n1.n_name = 'FRANCE' and n2.n_name = 'GERMANY')
                     or (n1.n_name = 'GERMANY' and n2.n_name = 'FRANCE'))
                and l_shipdate between date '1995-01-01' and date '1996-12-31'
             ) as shipping
        group by supp_nation, cust_nation, l_year
        order by supp_nation, cust_nation, l_year""",
    "q8": """
        select o_year,
               sum(case when nation = 'BRAZIL' then volume else 0 end) / sum(volume)
                   as mkt_share
        from (select extract(year from o_orderdate) as o_year,
                     l_extendedprice * (1 - l_discount) as volume, n2.n_name as nation
              from part, supplier, lineitem, orders, customer, nation n1, nation n2, region
              where p_partkey = l_partkey and s_suppkey = l_suppkey
                and l_orderkey = o_orderkey and o_custkey = c_custkey
                and c_nationkey = n1.n_nationkey and n1.n_regionkey = r_regionkey
                and r_name = 'AMERICA' and s_nationkey = n2.n_nationkey
                and o_orderdate between date '1995-01-01' and date '1996-12-31'
                and p_type = 'ECONOMY ANODIZED STEEL'
             ) as all_nations
        group by o_year order by o_year""",
    "q10": """
        select c_custkey, c_name, sum(l_extendedprice * (1 - l_discount)) as revenue,
               c_acctbal, n_name
        from customer, orders, lineitem, nation
        where c_custkey = o_custkey and l_orderkey = o_orderkey
          and o_orderdate >= date '1993-10-01'
          and o_orderdate < date '1993-10-01' + interval '3' month
          and l_returnflag = 'R' and c_nationkey = n_nationkey
        group by c_custkey, c_name, c_acctbal, n_name
        order by revenue desc
        limit 20""",
    "q11": """
        select ps_partkey, sum(ps_supplycost * ps_availqty) as value
        from partsupp, supplier, nation
        where ps_suppkey = s_suppkey and s_nationkey = n_nationkey
          and n_name = 'GERMANY'
        group by ps_partkey
        having sum(ps_supplycost * ps_availqty) >
               (select sum(ps_supplycost * ps_availqty) * 0.0001
                from partsupp, supplier, nation
                where ps_suppkey = s_suppkey and s_nationkey = n_nationkey
                  and n_name = 'GERMANY')
        order by value desc limit 100""",
    "q12": """
        select l_shipmode,
               sum(case when o_orderpriority = '1-URGENT' or o_orderpriority = '2-HIGH'
                        then 1 else 0 end) as high_line_count,
               sum(case when o_orderpriority <> '1-URGENT' and o_orderpriority <> '2-HIGH'
                        then 1 else 0 end) as low_line_count
        from orders, lineitem
        where o_orderkey = l_orderkey and l_shipmode in ('MAIL', 'SHIP')
          and l_commitdate < l_receiptdate and l_shipdate < l_commitdate
          and l_receiptdate >= date '1994-01-01'
          and l_receiptdate < date '1994-01-01' + interval '1' year
        group by l_shipmode order by l_shipmode""",
    "q13": """
        select c_count, count(*) as custdist
        from (select c_custkey, count(o_orderkey) as c_count
              from customer left outer join orders on c_custkey = o_custkey
                   and o_comment not like '%special%requests%'
              group by c_custkey) as c_orders (c_custkey, c_count)
        group by c_count
        order by custdist desc, c_count desc""",
    "q14": """
        select 100.00 * sum(case when p_type like 'PROMO%'
                                 then l_extendedprice * (1 - l_discount) else 0 end)
               / sum(l_extendedprice * (1 - l_discount)) as promo_revenue
        from lineitem, part
        where l_partkey = p_partkey and l_shipdate >= date '1995-09-01'
          and l_shipdate < date '1995-09-01' + interval '1' month""",
    "q15": """
            select s_suppkey, s_name, s_address, s_phone, total_revenue
            from supplier, revenue0
            where s_suppkey = supplier_no
              and total_revenue = (select max(total_revenue) from revenue0)
            order by s_suppkey""",
    "q16": """
        select p_brand, p_type, p_size, count(distinct ps_suppkey) as supplier_cnt
        from partsupp, part
        where p_partkey = ps_partkey and p_brand <> 'Brand#45'
          and p_type not like 'MEDIUM POLISHED%'
          and p_size in (49, 14, 23, 45, 19, 3, 36, 9)
          and ps_suppkey not in (select s_suppkey from supplier
                                 where s_comment like '%Customer%Complaints%')
        group by p_brand, p_type, p_size
        order by supplier_cnt desc, p_brand, p_type, p_size""",
    "q17": """
        select sum(l_extendedprice) / 7.0 as avg_yearly
        from lineitem, part
        where p_partkey = l_partkey and p_brand = 'Brand#23' and p_container = 'MED BOX'
          and l_quantity < (select 0.2 * avg(l_quantity) from lineitem
                            where l_partkey = p_partkey)""",
    "q19": """
        select sum(l_extendedprice * (1 - l_discount)) as revenue
        from lineitem, part
        where (p_partkey = l_partkey and p_brand = 'Brand#12'
               and p_container in ('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')
               and l_quantity >= 1 and l_quantity <= 11 and p_size between 1 and 5
               and l_shipmode in ('AIR', 'AIR REG')
               and l_shipinstruct = 'DELIVER IN PERSON')
           or (p_partkey = l_partkey and p_brand = 'Brand#23'
               and p_container in ('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK')
               and l_quantity >= 10 and l_quantity <= 20 and p_size between 1 and 10
               and l_shipmode in ('AIR', 'AIR REG')
               and l_shipinstruct = 'DELIVER IN PERSON')
           or (p_partkey = l_partkey and p_brand = 'Brand#34'
               and p_container in ('LG CASE', 'LG BOX', 'LG PACK', 'LG PKG')
               and l_quantity >= 20 and l_quantity <= 30 and p_size between 1 and 15
               and l_shipmode in ('AIR', 'AIR REG')
               and l_shipinstruct = 'DELIVER IN PERSON')""",
    "q20": """
        select s_name, s_address
        from supplier, nation
        where s_suppkey in (
              select ps_suppkey from partsupp
              where ps_partkey in (select p_partkey from part
                                   where p_name like 'forest%')
                and ps_availqty > (
                    select 0.5 * sum(l_quantity) from lineitem
                    where l_partkey = ps_partkey and l_suppkey = ps_suppkey
                      and l_shipdate >= date '1994-01-01'
                      and l_shipdate < date '1994-01-01' + interval '1' year))
          and s_nationkey = n_nationkey and n_name = 'CANADA'
        order by s_name""",
    "q21": """
        select s_name, count(*) as numwait
        from supplier, lineitem l1, orders, nation
        where s_suppkey = l1.l_suppkey and o_orderkey = l1.l_orderkey
          and o_orderstatus = 'F' and l1.l_receiptdate > l1.l_commitdate
          and exists (select * from lineitem l2
                      where l2.l_orderkey = l1.l_orderkey
                        and l2.l_suppkey <> l1.l_suppkey)
          and not exists (select * from lineitem l3
                          where l3.l_orderkey = l1.l_orderkey
                            and l3.l_suppkey <> l1.l_suppkey
                            and l3.l_receiptdate > l3.l_commitdate)
          and s_nationkey = n_nationkey and n_name = 'SAUDI ARABIA'
        group by s_name
        order by numwait desc, s_name
        limit 100""",
    "q22": """
        select cntrycode, count(*) as numcust, sum(c_acctbal) as totacctbal
        from (select substring(c_phone, 1, 2) as cntrycode, c_acctbal
              from customer
              where substring(c_phone, 1, 2) in ('13', '31', '23', '29', '30', '18', '17')
                and c_acctbal > (select avg(c_acctbal) from customer
                                 where c_acctbal > 0.00
                                   and substring(c_phone, 1, 2) in
                                       ('13', '31', '23', '29', '30', '18', '17'))
                and not exists (select * from orders
                                where o_custkey = c_custkey)) as custsale
        group by cntrycode
        order by cntrycode""",
}
# the view Q15 reads, as tests/test_sql_tpch3.py creates it
Q15_VIEW = """
        create view revenue0 as
            select l_suppkey as supplier_no,
                   sum(l_extendedprice * (1 - l_discount)) as total_revenue
            from lineitem
            where l_shipdate >= date '1996-01-01' and l_shipdate < date '1996-04-01'
            group by l_suppkey"""
ALL_QUERIES = dict(sorted({**QUERIES, **TPCH_QUERIES}.items(),
                          key=lambda kv: int(kv[0][1:])))
# the kernels each query must launch on the main path: those the JAX
# reference's SF1 path reaches (a call recording of trino_tpu at SF1, PERF.md)
REQUIRED = {
    "q2": ("compact_rows",),
    "q3": ("hash_insert",),
    "q5": ("hash_insert", "hash_probe", "compact_rows"),
    "q7": ("hash_insert",),
    "q8": ("hash_insert", "compact_rows"),
    "q9": ("hash_insert", "hash_probe", "compact_rows"),
    "q10": ("hash_insert", "compact_rows"),
    "q13": ("hash_insert",),
    "q16": ("hash_insert",),
    "q17": ("compact_rows",),
    "q18": ("hash_insert",),
    "q20": ("hash_insert", "hash_probe", "compact_rows"),
    "q21": ("hash_insert", "compact_rows"),
}
# the TPC-DS corpus: the kernels each query must launch at SF1, those the JAX
# reference's SF1 path reaches (a call recording of trino_tpu's hash group-by
# inserts, hash join builds and probes, and compactions at SF1, split_rows
# 2^21: the table that ``scripts/record_tpcds_kernels.py --sf 1`` prints);
# queries not named here reach none of them
TPCDS_REQUIRED = {
    "q42_category_report": ('compact_rows', 'hash_insert'),
    "q55_brand_revenue": ('compact_rows', 'hash_insert'),
    "q3_brand_by_year": ('compact_rows', 'hash_insert'),
    "q7_demographic_averages": ('compact_rows',),
    "q89_monthly_category_window": ('compact_rows', 'hash_insert'),
    "q98_class_revenue_ratio": ('compact_rows',),
    "catalog_channel_by_year": ('hash_insert',),
    "cross_channel_union": ('hash_insert',),
    "q19_brand_revenue_by_geography": ('compact_rows', 'hash_insert'),
    "q65_store_item_revenue": ('hash_insert',),
    "q26_catalog_demographics": ('compact_rows',),
    "q52_brand_revenue_november": ('compact_rows', 'hash_insert'),
    "q43_store_sales_by_day_name": ('compact_rows', 'hash_insert'),
    "q96_evening_shoppers": ('compact_rows',),
    "q77_multichannel_profit_rollup": ('hash_insert',),
    "q33_multichannel_manufact_revenue": ('compact_rows', 'hash_insert'),
    "q18_catalog_rollup_averages": ('compact_rows',),
    "q73_ticket_count_buckets": ('compact_rows', 'hash_insert'),
    "q42_category_revenue_rollup_by_year": ('compact_rows', 'hash_insert'),
    "q36_gross_margin_rollup": ('compact_rows',),
    "q86_web_rollup_counts": ('compact_rows',),
    "q01_returns_above_store_average": ('hash_insert',),
    "q30_web_returns_above_state_average": ('compact_rows', 'hash_insert'),
    "q92_excess_web_discount": ('compact_rows', 'hash_insert'),
    "q48_disjunctive_quantity_price_sum": ('compact_rows',),
    "q88_time_bucket_cross_counts": ('compact_rows',),
    "q34_ticket_dep_count_buckets": ('hash_insert',),
    "q44_best_worst_items_by_rank": ('hash_insert',),
    "q51_cumulative_channel_windows": ('hash_insert', 'hash_probe'),
    "q50_return_lag_buckets": ('compact_rows', 'hash_insert', 'hash_probe'),
    "q59_weekly_sales_year_over_year": ('hash_insert', 'hash_probe'),
    "q15_catalog_zip_report": ('compact_rows', 'hash_insert'),
    "q25_sale_return_catalog_flow": ('compact_rows', 'hash_insert', 'hash_probe'),
    "q45_zip_list_or_item_subquery": ('hash_insert',),
    "q46_city_ticket_amounts": ('hash_insert',),
    "q79_ticket_profit_by_city": ('compact_rows', 'hash_insert'),
    "q16_catalog_ship_not_exists_returns": ('compact_rows', 'hash_insert'),
    "q69_demographics_store_only_shoppers": ('hash_insert',),
    "q97_channel_overlap_counts": ('hash_insert', 'hash_probe'),
    "q71_brand_revenue_by_hour_channels": ('hash_insert',),
    "q93_reason_adjusted_sales": ('hash_insert', 'hash_probe'),
    "q47_monthly_brand_vs_yearly_average": ('compact_rows', 'hash_insert'),
    "q39_inventory_mean_stdev": ('compact_rows',),
    "q13_demographic_band_averages": ('compact_rows',),
    "q28_price_band_buckets": ('hash_insert',),
    "q32_excess_discount": ('compact_rows', 'hash_insert'),
    "q37_inventory_price_band": ('compact_rows', 'hash_insert'),
    "q38_channel_intersect": ('hash_insert',),
    "q40_returns_adjusted_pivot": ('hash_insert', 'hash_probe'),
    "q66_warehouse_monthly": ('compact_rows',),
    "q84_income_band_customers": ('compact_rows',),
    "q87_channel_except": ('hash_insert',),
    "q91_call_center_losses": ('compact_rows',),
    "q94_ship_anti_join": ('hash_insert',),
    "q95_repeat_ship_sites": ('hash_insert',),
    "q12_category_revenue_ratio": ('compact_rows',),
    "q17_sales_returns_stats": ('compact_rows', 'hash_insert', 'hash_probe'),
    "q31_county_quarter_growth": ('compact_rows', 'hash_insert'),
    "q35_multi_channel_exists": ('hash_insert',),
    "q49_ranked_return_ratios": ('hash_insert', 'hash_probe'),
    "q53_manufact_window_avg": ('compact_rows', 'hash_insert'),
    "q68_city_pair_tickets": ('compact_rows', 'hash_insert'),
    "q20_catalog_revenue_ratio": ('compact_rows',),
    "q27_demographic_rollup": ('compact_rows',),
    "q29_quantity_flow_three_channels": ('compact_rows', 'hash_insert', 'hash_probe'),
    "q56_color_items_three_channel_union": ('compact_rows',),
    "q57_call_center_brand_vs_average": ('compact_rows', 'hash_insert'),
    "q63_manager_window_avg": ('compact_rows', 'hash_insert'),
    "q76_channel_union_pivot": ('hash_insert',),
    "q81_catalog_returns_above_state_average": ('compact_rows', 'hash_insert'),
    "q82_store_inventory_price_band": ('compact_rows', 'hash_insert'),
    "q83_return_quantity_ratios": ('compact_rows',),
    "q8_preferred_zip_prefix_profit": ('compact_rows', 'hash_insert'),
}
# phase 8: the kernels each statement of the refresh path must launch, those
# the JAX reference reaches over the same statements (a call recording of
# trino_tpu at SF0.1: the table that ``scripts/record_memory_kernels.py``
# prints; over memory tables, which report no column ranges, joins and
# group-bys take the hash paths at every scale); statements not named here
# reach none of them, nor does Q15 over tpch (phase 2)
MEMORY_REQUIRED = {
    "q3": ('hash_insert',),
    "q4": ('hash_insert',),
    "q9": ('compact_rows', 'hash_insert', 'hash_probe'),
    "q15": ('hash_insert',),
    "q18": ('hash_insert',),
}
TPCDS_SF_PARITY = 0.1  # every corpus query on the card and the CPU
TPCDS_SF_MAIN = 1.0
TPCDS_SF_BIG = 10.0
# the star join, cumulative frames, the rollup union, windows over an aggregate
TPCDS_BIG = ("q3_brand_by_year", "q51_cumulative_channel_windows",
             "q77_multichannel_profit_rollup", "q89_monthly_category_window",
             "q98_class_revenue_ratio")
# plan nodes this slice ported; a query that runs one is also held against the
# CPU at SF1 ("Limit" is a Limit over anything but a Sort, which is a TopN)
TPCDS_NEW_NODES = ("Window", "Union", "Values", "Limit")
# the one kernel with no caller in the engine (nor in the reference's)
NO_ENGINE_CALLER = ("fused_segment_agg",)
# the kernel's float32 sums against float64: each thread adds a few dozen
# rows in order, then warp, block and grid partials are added as a tree of
# float32 sums, so the error grows like log(n) roundings (5.2e-7 to 6.6e-7
# relative at Q1's shape and 1.3e-6 to 1.4e-6 at the ceiling, measured by
# this script on an H100), and 1e-4 leaves ~70x; a wrong slot or one lost
# row of Q1 is off by more (and the counts are held exactly).  The plain
# version's index_add_ adds row by row into one float32 word per slot and
# drifts by ~1.6e-3 on Q1's discounts (on the CPU and on the card), so it is
# held to PLAIN_SEGMENT_RTOL.
SEGMENT_RTOL = 1e-4
PLAIN_SEGMENT_RTOL = 1e-2

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth, and the
# non-tensor-core rate used as the ceiling for the kernels' integer work
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
DEVICE = "cuda"
SF_MAIN = 1.0  # bench.py's scale
SF_BIG = 10.0  # the size users of a single-node engine run
SPLIT_ROWS = 1 << 21  # bench.py's split size

# -- phase 8: TPC-H's refresh functions (TPC-H Standard Specification 3.0.1,
# clause 2.5) around the query set, over memory copies of orders and lineitem
MEMORY_QUERIES = ("q1", "q3", "q4", "q9", "q15", "q18")
ORDERS_COLUMNS = ("o_orderkey", "o_custkey", "o_orderstatus", "o_totalprice", "o_orderdate",
                  "o_orderpriority", "o_clerk", "o_shippriority", "o_comment")
# count and sums of every numeric column: what a query over a stored table
# must leave as it found it
CHECKSUMS = {
    "orders": "select count(*) n, sum(o_orderkey) k, sum(o_custkey) c, "
              "sum(o_totalprice) p, sum(o_shippriority) s from orders",
    "lineitem": "select count(*) n, sum(l_orderkey) k, sum(l_partkey) p, sum(l_suppkey) s, "
                "sum(l_linenumber) ln, sum(l_quantity) q, sum(l_extendedprice) e, "
                "sum(l_discount) d, sum(l_tax) t from lineitem",
}


def refresh_path(n_orders: int) -> dict:
    """Phase 8's statements at a scale of ``n_orders`` orders (keys 1 to
    n_orders): the memory copies first hold every order but the last band of
    SF x 1500 (n_orders / 1000); RF1 ("new sales") adds that band with its
    line items, MERGE as an upsert for orders; RF2 ("old sales") deletes the
    first band, then one UPDATE to a constant and one to an expression over
    the next band.  ``counts`` are the queries over ``tpch`` whose counts the
    affected-row counts must equal."""
    band = n_orders // 1000
    cut = n_orders - band
    values = ", ".join(f"s.{c}" for c in ORDERS_COLUMNS)
    nxt = f"between {band + 1} and {2 * band}"
    return {
        "band": band,
        "load": [
            ("ctas_orders", f"create table orders as select * from tpch.orders "
                            f"where o_orderkey <= {cut}"),
            ("ctas_lineitem", f"create table lineitem as select * from tpch.lineitem "
                              f"where l_orderkey <= {cut}")],
        "rf1": [
            ("merge_orders", f"merge into orders t using (select * from tpch.orders "
                             f"where o_orderkey > {cut}) s on t.o_orderkey = s.o_orderkey "
                             f"when not matched then insert values ({values})"),
            ("insert_lineitem", f"insert into lineitem select * from tpch.lineitem "
                                f"where l_orderkey > {cut}")],
        "rf2": [
            ("delete_lineitem", f"delete from lineitem where l_orderkey <= {band}"),
            ("delete_orders", f"delete from orders where o_orderkey <= {band}"),
            ("update_orders", f"update orders set o_orderpriority = '1-URGENT' "
                              f"where o_orderkey {nxt}"),
            ("update_lineitem", f"update lineitem set l_discount = l_discount + 0.01 "
                                f"where l_orderkey {nxt}")],
        "counts": {
            "merge_orders": f"select count(*) from tpch.orders where o_orderkey > {cut}",
            "insert_lineitem": f"select count(*) from tpch.lineitem where l_orderkey > {cut}",
            "delete_lineitem": f"select count(*) from tpch.lineitem where l_orderkey <= {band}",
            "delete_orders": f"select count(*) from tpch.orders where o_orderkey <= {band}",
            "update_orders": f"select count(*) from tpch.orders where o_orderkey {nxt}",
            "update_lineitem": f"select count(*) from tpch.lineitem where l_orderkey {nxt}"},
    }


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def same_result(a, b, what, by_value=False):
    """Exact for integer/decimal/date/bool/string columns, rtol 1e-9 for DOUBLE.
    Strings compare as dictionary ids, or as their values with ``by_value``
    (results over two catalogs, whose dictionaries number them differently)."""
    import numpy as np

    check(tuple(a.names) == tuple(b.names), f"{what}: column names differ")
    check(len(a) == len(b), f"{what}: {len(a)} rows vs {len(b)}")
    for name, t, ca, cb, da, db in zip(a.names, a.types, a.raw_columns, b.raw_columns,
                                       a.columns, b.columns):
        ca, cb = np.asarray(ca), np.asarray(cb)
        if t.is_string and by_value:
            ok = [str(x) for x in list(da)] == [str(x) for x in list(db)]
        elif t.is_floating:
            ok = np.allclose(ca, cb, rtol=1e-9, atol=0.0, equal_nan=True)
        else:
            ok = ca.shape == cb.shape and bool((ca == cb).all())
        check(ok, f"{what}: column {name} differs")


def run_queries(engine, queries, conn_rows, label, catalog="tpch", fact="lineitem"):
    """Cold and warm run of each query; per-query launches, host reads (plan-
    time subqueries included) and peak device memory from the cold run;
    ``conn_rows`` rows of the ``fact`` table per warm wall."""
    import torch

    from trino_tpu_torch.ops import cuda_kernels as ck

    out = {}
    for q, sql in queries.items():
        sess = engine.create_session(catalog)
        before = {k: s.launches for k, s in ck.STATS.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = engine.execute_sql(sql, sess)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        launches = {k: s.launches - before[k] for k, s in ck.STATS.items()}
        reads = dict(engine.last_query_counters)
        peak = torch.cuda.max_memory_allocated()
        warm = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res2 = engine.execute_sql(sql, sess)
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t0)
            same_result(res, res2, f"{label} {q} warm vs cold")
        out[q] = {"result": res, "rows": len(res), "cold_s": cold,
                  "warm_s": min(warm), "launches": launches,
                  "host_reads": reads.get("host_reads"),
                  "host_bytes": reads.get("host_bytes"), "peak_bytes": peak,
                  "rows_per_s": conn_rows / min(warm)}
        print(f"{label} {q}: rows={len(res)} cold_s={cold} warm_s={min(warm)} "
              f"launches={ {k: v for k, v in launches.items() if v} } "
              f"host_reads={reads.get('host_reads')} peak_bytes={peak} "
              f"{fact}_rows_per_s={conn_rows / min(warm)}", flush=True)
    return out


def time_ms(fn, reps=20, warmup=3, setup=None):
    """Median per-call milliseconds by CUDA events around each call.
    ``setup`` (untimed, finished before the first event) runs before every
    call, for example to refill a table that the call fills in place."""
    import torch

    for _ in range(warmup):
        if setup is not None:
            setup()
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
            torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_names(name):
    """The ``__global__`` functions of kernel wrapper ``name``'s CUDA source,
    read from the package that is imported."""
    import re

    from trino_tpu_torch.ops import cuda_kernels as ck

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(ck.__file__))),
                        "csrc", os.path.basename(ck.STATS[name].source))
    with open(path) as f:
        return tuple(re.findall(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)\s+)?"
                                r"(?:void\s+)?(\w+)\s*\(", f.read()))


def is_port_kernel(event_name, names):
    """Whether a profiler device event is one of the kernels ``names``."""
    import re

    return bool(names) and re.search(r"(?:^|[\s:])(?:%s)[<(]" % "|".join(names),
                                     event_name) is not None


def device_events(prof):
    """The device activity of a profile, without the ranges that
    ``record_function`` mirrors onto the device timeline."""
    import torch

    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_split(fn, names, setup=None, reps=20):
    """One wrapper call's time split three ways, per call: ``wall_ms`` (CUDA
    events around the call), ``kernel_ms`` (device time of the port's own
    kernels ``names``, from ``torch.profiler``), ``other_device_ms`` (every
    other device operation the call made: fills, copies, memsets), and
    ``idle_ms`` = wall - both, the device waiting on the host between the
    call's launches.  ``host_ms`` is the host's enqueue time of one call
    (host clock, from an idle device).  ``setup`` runs before every call and
    its device work is measured alone and taken out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    wall = time_ms(fn, reps=reps, setup=setup)
    host = []
    for _ in range(reps):
        if setup is not None:
            setup()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()

    def ops(body):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            # the trace loses the device operations at the start of its
            # window: the first one, and up to five of twenty 0.9 ms insert
            # launches at the TPC-DS path's largest shape (an H100, this
            # script's own profile, ~5 ms of device time): let those be
            # throwaway spins of ~1 ms each, left out below
            for _ in range(16):
                torch.cuda._sleep(2_000_000)
            for _ in range(reps):
                body()
            torch.cuda.synchronize()
        return [e for e in device_events(prof) if "spin_kernel" not in e.name]

    def call():
        if setup is not None:
            setup()
        fn()

    # every call of a wrapper makes the same number of launches, so a
    # window whose count of the port's kernels is no whole multiple of reps
    # lost records (16 of 20 at the memory path's 0.034 ms insert in one
    # run of this script on an H100; a later run of three windows at that
    # shape recorded 20 of 20 in each): profile the window again, up to
    # three times, and keep every window's count (``profile_counts``) so
    # that each run shows how often a window loses records, and where
    counts_seen = []
    for _ in range(3):
        got = ops(call)
        kern = [e for e in got if is_port_kernel(e.name, names)]
        counts_seen.append(len(kern))
        if len(kern) % reps == 0:
            break
    setup_ops = ops(setup) if setup is not None else []
    if not got:
        return {"wall_ms": wall, "host_ms": statistics.median(host), "kernel_ms": None,
                "profile_counts": counts_seen,
                "note": "the profiler recorded no device activity"}
    rest = [e for e in got if not is_port_kernel(e.name, names)]
    kernel_ms = sum(e.time_range.elapsed_us() for e in kern) / reps / 1e3
    other_ms = (sum(e.time_range.elapsed_us() for e in rest)
                - sum(e.time_range.elapsed_us() for e in setup_ops)) / reps / 1e3
    counts = {}
    for e in rest:
        counts[e.name[:80]] = counts.get(e.name[:80], 0) + 1
    for e in setup_ops:
        counts[e.name[:80]] = counts.get(e.name[:80], 0) - 1
    return {"wall_ms": wall, "host_ms": statistics.median(host), "kernel_ms": kernel_ms,
            "kernel_launches": len(kern) / reps, "profile_counts": counts_seen,
            "other_device_ms": other_ms,
            "other_ops": {k: v / reps for k, v in counts.items() if v},
            "idle_ms": wall - kernel_ms - other_ms}


def insert_case(gen, n, C):
    """Synthetic insert input at (n, C): keys drawn uniformly with
    duplicates from at most C/2 distinct ones (every row places well inside
    64 rounds), 90 % of rows valid."""
    import numpy as np
    import torch

    distinct = max(min(n, C // 2), 1)
    keys = gen.integers(0, 1 << 62, size=distinct, dtype=np.int64)
    packed = torch.as_tensor(keys[gen.integers(0, distinct, size=n)], device=DEVICE)
    valid = torch.as_tensor(gen.random(n) < 0.9, device=DEVICE)
    return packed, valid


def split_keys(conn, table, column):
    """A path's own insert keys: ``column`` of ``table``'s first split,
    packed as a one-key hash group-by packs it, and the split's valid
    lanes."""
    from trino_tpu_torch.ops.hashing import pack_keys

    page = conn.generate(conn.splits(table)[0], [column])
    packed, _ = pack_keys((page.columns[0],), (page.schema.fields[0].type,))
    return packed, page.valid_mask()


def lineitem_keys(conn):
    """The TPC-H path's own insert keys: ``l_orderkey`` of the first
    lineitem split (the lineitem rows of one order are adjacent, 1-7 of
    them)."""
    return split_keys(conn, "lineitem", "l_orderkey")


def compact_case(gen, n, out_len, widths, live=None):
    """Synthetic compaction input: one column per width, and a mask keeping
    about ``live`` rows: by default half of out_len, so nothing is dropped."""
    import torch

    by_width = {1: torch.bool, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    cols = []
    for w in widths:
        raw = torch.as_tensor(gen.integers(-(1 << 30), 1 << 30, size=n), device=DEVICE)
        cols.append(raw.to(by_width[w]) if w != 1 else raw > 0)
    keep = min((0.5 * out_len if live is None else live) / max(n, 1), 1.0)
    return tuple(cols), torch.as_tensor(gen.random(n) < keep, device=DEVICE)


def bound(nbytes, ops):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sector_bytes(rows, width):
    """Bytes of the distinct 32-byte sectors (the least the memory moves for a
    scattered access) holding elements ``rows`` of a ``width``-byte column."""
    import torch

    if rows.numel() == 0:
        return 0
    return 32 * int(torch.unique(rows.long() * width // 32).numel())


def probe_chains(table, packed, valid):
    """The slots a probe reads: every slot of each valid row's chain up to its
    match or first EMPTY, and the slots whose payload a match reads."""
    import torch

    from trino_tpu_torch.ops import cuda_kernels as ck
    from trino_tpu_torch.ops.hashing import EMPTY_KEY, probe_step, splitmix64

    C = table.shape[0]
    h0 = splitmix64(packed)
    stp = probe_step(h0)
    seen, hits = [packed.new_empty(0)], [packed.new_empty(0)]
    done = ~valid
    for p in range(ck.MAX_PROBES):
        if bool(done.all()):
            break
        idx = (h0 + p * stp) & (C - 1)
        cur = table[idx]
        seen.append(idx[~done])
        hit = (cur == packed) & ~done
        hits.append(idx[hit])
        done = done | hit | (cur == EMPTY_KEY)
    return torch.cat(seen), torch.cat(hits)


Q1_COLUMNS = ["l_returnflag", "l_linestatus", "l_shipdate", "l_quantity",
              "l_extendedprice", "l_discount", "l_tax"]


def segment_cases(q1_page):
    """fused_segment_agg's two shapes: Q1's group-by over one lineitem split
    (8 slots = returnflag x linestatus, valid = Q1's shipdate filter, the
    four summed columns as float32), and the contract's ceiling (128 random
    slots, 8 columns) at the same n.  Returns [(label, case dict)]."""
    import numpy as np
    import torch

    dev = torch.device(DEVICE)
    cols = dict(zip(q1_page.schema.names, q1_page.columns))
    types = {f.name: f.type for f in q1_page.schema.fields}
    cutoff = int((np.datetime64("1998-09-02") - np.datetime64("1970-01-01")).astype(int))
    q1 = {
        "slot": (cols["l_returnflag"].to(torch.int32) * 2
                 + cols["l_linestatus"].to(torch.int32)),
        "valid": q1_page.valid_mask() & (cols["l_shipdate"].to(torch.int64) <= cutoff),
        "values": tuple((cols[c].to(torch.float64) / 10 ** types[c].scale).to(torch.float32)
                        for c in ("l_quantity", "l_extendedprice", "l_discount", "l_tax")),
        "n_slots": 8,
    }
    gen = np.random.default_rng(11)
    n = q1["slot"].shape[0]
    ceiling = {
        "slot": torch.as_tensor(gen.integers(0, 128, n).astype(np.int32), device=dev),
        "valid": torch.as_tensor(gen.random(n) < 0.9, device=dev),
        "values": tuple(torch.as_tensor(gen.random(n).astype(np.float32) * 10 ** j,
                                        device=dev) for j in range(8)),
        "n_slots": 128,
    }
    return [("q1_groupby", q1), ("ceiling", ceiling)]


def segment_agg_checks(q1_page):
    """fused_segment_agg against its plain version at ``segment_cases``.
    Counts must be exact; the kernel's sums are held to SEGMENT_RTOL of a
    float64 sum of the same float32 inputs, the plain version's to
    PLAIN_SEGMENT_RTOL; max_abs_err is the kernel's largest relative error
    against it (the plain version's is reported beside it)."""
    import torch

    from trino_tpu_torch.ops import cuda_kernels as ck

    dev = torch.device(DEVICE)
    names = kernel_names("fused_segment_agg")
    shapes = []
    for label, case in segment_cases(q1_page):
        slot, valid, values, n_slots = (case[k] for k in ("slot", "valid", "values",
                                                          "n_slots"))
        n, k = slot.shape[0], len(values)
        live = valid & (slot >= 0) & (slot < n_slots)
        idx = torch.where(live, slot.to(torch.int64), n_slots)
        want_counts = torch.bincount(idx, minlength=n_slots + 1)[:n_slots]
        want = torch.zeros((n_slots + 1, k), dtype=torch.float64, device=dev)
        want.index_add_(0, idx, torch.stack(values, 1).to(torch.float64))
        want = want[:n_slots]
        err = {}
        for impl, fn in (("kernel", ck.fused_segment_agg),
                         ("plain", ck.fused_segment_agg_plain)):
            counts, sums = fn(slot, valid, values, n_slots)
            torch.cuda.synchronize()
            check(bool((counts.to(torch.int64) == want_counts).all()),
                  f"fused_segment_agg {label}: {impl} counts differ from bincount")
            got = torch.stack(sums, 1).to(torch.float64) if k else want
            scale = torch.clamp(want.abs(), min=1e-30)
            err[impl] = float(((got - want).abs() / scale).max()) if k else 0.0
            tol = SEGMENT_RTOL if impl == "kernel" else PLAIN_SEGMENT_RTOL
            check(err[impl] <= tol, f"fused_segment_agg {label}: {impl} sums off "
                  f"by {err[impl]:.3g} relative to float64 (limit {tol:g})")
        stacked = torch.stack(values, 1)
        split = device_split(lambda: ck.fused_segment_agg(slot, valid, values, n_slots), names)
        if split.get("kernel_ms") is not None:
            check(split["kernel_launches"] == 1,
                  f"fused_segment_agg {label}: {split['kernel_launches']} launches a call")
        ms = split["wall_ms"]
        plain_ms = time_ms(lambda: ck.fused_segment_agg_plain(slot, valid, values, n_slots))

        def library():
            acc = torch.zeros((n_slots + 1, k), dtype=torch.float32, device=dev)
            acc.index_add_(0, idx, stacked)
            torch.bincount(idx, minlength=n_slots + 1)

        library_ms = time_ms(library)
        # each row read once (slot, valid, k float32 values); the outputs
        # written once; one add per live value
        b_ms, b_by = bound(n * (4 + 1 + 4 * k) + n_slots * 4 * (k + 1),
                           int(live.sum()) * (k + 1))
        shapes.append({"case": label, "shape": [n, n_slots, k], "live": int(live.sum()),
                       "max_abs_err": err["kernel"], "rel_err_plain": err["plain"],
                       "ms": ms, "kernel_ms": split.get("kernel_ms"), "split": split,
                       "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                       "library_ms": library_ms})
        print(f"kernel fused_segment_agg {label}: shape={[n, n_slots, k]} "
              f"rel_err kernel={err['kernel']:.3g} plain={err['plain']:.3g} "
              f"ms={ms:.4f} kernel_ms={split.get('kernel_ms')} "
              f"host_ms={split['host_ms']:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.6g} library_ms={library_ms:.4f} "
              f"profiled={split['profile_counts']}", flush=True)
    first = shapes[0]
    return {"name": "fused_segment_agg", "shape": first["shape"],
            "max_abs_err": max(x["max_abs_err"] for x in shapes),
            **{k: first[k] for k in ("ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")},
            "shapes": shapes}

def main_path_shapes(seen):
    """(label, shape) of the largest and the most frequent launch shape."""
    import collections

    seen = [tuple(x) for x in seen]
    largest = max(seen, key=lambda x: (x[0], x[1]))
    frequent = collections.Counter(seen).most_common(1)[0][0]
    return [("largest", largest), ("most_frequent", frequent)]


def insert_observables(table, slot, placed, ref_table, ref_placed, packed, valid):
    """{what: count} of the observables on which an insert's result
    disagrees with the plain version's (layouts legitimately differ)."""
    import torch

    from trino_tpu_torch.ops import cuda_kernels as ck
    from trino_tpu_torch.ops.hashing import EMPTY_KEY

    C = table.shape[0] - 1
    live = valid & placed
    words = torch.unique(table[:C][table[:C] != EMPTY_KEY])
    ref_words = torch.unique(ref_table[:C][ref_table[:C] != EMPTY_KEY])
    got = ck.hash_probe_plain(table[:C], None, packed, valid)
    ref = ck.hash_probe_plain(ref_table[:C], None, packed, valid)
    return {
        "placed sets differ": int((placed != ref_placed).sum()),
        "valid rows not placed": int((valid & ~placed).sum()),
        "table[slot] != packed for placed rows":
            int((table[slot.long()[live]] != packed[live]).sum()),
        "invalid rows not at the sink": int((slot[~valid] != C).sum()),
        "sink word written": int(int(table[C]) != EMPTY_KEY),
        "table word sets differ": words.numel() + ref_words.numel()
            - 2 * int(torch.isin(words, ref_words).sum()),
        "probe results over the two tables differ":
            int((got[1] != ref[1]).sum()) + int((got[1] != valid).sum()),
    }


def insert_checks(seen, own_keys, gen):
    """hash_insert in both forms (functional ``hash_insert``, in-place
    ``hash_insert_``) against the plain version, on uniform synthetic keys at
    the largest and the most frequent shape of a path, and on the path's
    own keys (``own_keys`` = (label, packed, valid), for example
    ``lineitem_keys``; table sized as the group-by sizes it: the next power
    of two at or above twice the distinct keys).  The error is
    the count of disagreeing observables; the top-level numbers are the
    in-place form's at the largest shape."""
    import torch

    from trino_tpu_torch.ops import cuda_kernels as ck
    from trino_tpu_torch.ops.hashing import EMPTY_KEY

    names = kernel_names("hash_insert")
    cases = []
    for label, (n, C) in main_path_shapes(seen):
        cases.append((label, *insert_case(gen, n, C), C))
    own_label, packed, valid = own_keys
    distinct = int(torch.unique(packed[valid]).numel())
    cases.append((own_label, packed, valid, 1 << (2 * distinct - 1).bit_length()))
    out, wrong_total = [], 0
    for label, packed, valid, C in cases:
        n = packed.shape[0]
        table0 = torch.full((C + 1,), EMPTY_KEY, dtype=torch.int64, device=DEVICE)
        ref_t, _, ref_p = ck.hash_insert_plain(table0, packed, valid)
        t_f, s_f, p_f = ck.hash_insert(table0, packed, valid)
        t_i = table0.clone()
        s_i, p_i = ck.hash_insert_(t_i, packed, valid)
        torch.cuda.synchronize()
        wrong = {"functional": insert_observables(t_f, s_f, p_f, ref_t, ref_p, packed, valid),
                 "in_place": insert_observables(t_i, s_i, p_i, ref_t, ref_p, packed, valid)}
        wrong["functional"]["input table modified"] = int((table0 != EMPTY_KEY).sum())
        for form, w in wrong.items():
            for what, count in w.items():
                check(count == 0, f"hash_insert {label} {form}: {what} ({count})")
        nv = int(valid.sum())
        # chain walks: one per run of equal keys among a warp's valid rows
        rows = torch.nonzero(valid).flatten()
        walks = int(rows.numel() and 1 + ((rows[1:] // 32 != rows[:-1] // 32)
                                          | (packed[rows][1:] != packed[rows][:-1])).sum())
        # what the rows need: packed and valid in, slot and placed out; in
        # place, the distinct table sectors the chains touch (the final
        # table replays each chain: slots only go from EMPTY to a key); the
        # functional form reads and writes the whole table besides
        chains, _ = probe_chains(t_i[:C], packed, valid)
        table_sectors = sector_bytes(chains, 8)
        fill = lambda: t_i.fill_(EMPTY_KEY)  # noqa: E731
        forms = {
            "in_place": (lambda: ck.hash_insert_(t_i, packed, valid),
                         lambda: ck.hash_insert_plain_(t_i, packed, valid), fill,
                         n * (8 + 1 + 4 + 1) + table_sectors),
            "functional": (lambda: ck.hash_insert(table0, packed, valid),
                           lambda: ck.hash_insert_plain(table0, packed, valid), None,
                           8 * (C + 1) * 2 + n * (8 + 1 + 4 + 1)),
        }
        for form, (fn, plain, setup, nbytes) in forms.items():
            split = device_split(fn, names, setup=setup)
            if split.get("kernel_ms") is not None:
                check(split["kernel_launches"] == 1,
                      f"hash_insert {label} {form}: {split['kernel_launches']} launches a call")
                if form == "in_place":
                    check(not split["other_ops"], f"hash_insert {label} in place: other "
                          f"device operations {split['other_ops']}")
            plain_ms = time_ms(plain, reps=3, warmup=1, setup=setup)
            b_ms, b_by = bound(nbytes, nv * 27)
            rec = {"case": label, "form": form, "shape": [n, C], "valid_rows": nv,
                   "chain_walks": walks, "max_abs_err": float(sum(wrong[form].values())),
                   "ms": split["wall_ms"], "kernel_ms": split.get("kernel_ms"),
                   "split": split, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": None}
            wrong_total += rec["max_abs_err"]
            out.append(rec)
            print(f"kernel hash_insert {label} {form}: shape={[n, C]} valid={nv} "
                  f"walks={walks} ms={rec['ms']:.4f} kernel_ms={rec['kernel_ms']} "
                  f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.6g} ({b_by}) "
                  f"profiled={split['profile_counts']}", flush=True)
    top = out[0]
    return {"name": "hash_insert", "shape": top["shape"], "form": top["form"],
            "max_abs_err": wrong_total,
            **{k: top[k] for k in ("ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")},
            "shapes": out}


def compact_checks(seen, gen):
    """compact_rows against its plain version, byte for byte, at the largest
    and the most frequent shape of a path; the top-level numbers are the
    largest shape's.  Also at the path's most selective shape (least
    out_len / n, out_len < n: for example a streaming LIMIT's) with about
    twice out_len live rows, so the rows past out_len are dropped.  A call
    of up to 16 columns must make at most two kernel launches and no fill
    of its outputs."""
    import torch

    from trino_tpu_torch.ops import cuda_kernels as ck

    names = kernel_names("compact_rows")
    cases = [(label, shape, None) for label, shape in main_path_shapes(seen)]
    short = [tuple(x) for x in seen if x[1] < x[0]]
    if short:
        n, out_len, widths = min(short, key=lambda x: (x[1] / x[0], -x[0]))
        cases.append(("dropping", (n, out_len, widths), min(2 * out_len, n)))
    out = []
    for label, (n, out_len, widths), live in cases:
        cols, valid = compact_case(gen, n, out_len, widths, live)
        a, ta = ck.compact_rows(cols, valid, out_len)
        b, tb = ck.compact_rows_plain(cols, valid, out_len)
        torch.cuda.synchronize()
        check(int(ta) == int(tb), f"compact_rows {label}: live counts differ")
        err = float(abs(int(ta) - int(tb)))
        for x, y in zip(a, b):
            check(x.dtype == y.dtype and bool((x == y).all()),
                  f"compact_rows {label}: kernel and plain version differ")
            if out_len:
                err = max(err, float((x.long() - y.long()).abs().max()))
        split = device_split(lambda: ck.compact_rows(cols, valid, out_len), names)
        if split.get("kernel_ms") is not None:
            check(split["kernel_launches"] <= -(-len(cols) // 16),
                  f"compact_rows {label}: {split['kernel_launches']} launches a call")
            fills = [k for k in split["other_ops"] if "fill" in k.lower()]
            check(not fills, f"compact_rows {label}: fills its outputs ({fills})")
        plain_ms = time_ms(lambda: ck.compact_rows_plain(cols, valid, out_len))
        library_ms = time_ms(lambda: [c[valid][:out_len] for c in cols])
        # what this mask needs: the mask; in each column the sectors holding
        # live rows that are kept; the outputs in full (the tail is zeros);
        # the count
        kept = torch.nonzero(valid).flatten()[:out_len]
        b_ms, b_by = bound(n + sum(sector_bytes(kept, w) for w in widths)
                           + out_len * sum(widths) + 8, n * 4)
        rec = {"case": label, "shape": [n, out_len, list(widths)], "live": int(tb),
               "max_abs_err": err, "ms": split["wall_ms"], "kernel_ms": split.get("kernel_ms"),
               "split": split, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": library_ms}
        out.append(rec)
        print(f"kernel compact_rows {label}: shape={rec['shape']} live={rec['live']} "
              f"ms={rec['ms']:.4f} kernel_ms={rec['kernel_ms']} plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms:.4f} bound_ms={b_ms:.6g} "
              f"profiled={split['profile_counts']}", flush=True)
    top = out[0]
    return {"name": "compact_rows", "shape": top["shape"], "live": top["live"],
            "max_abs_err": max(r["max_abs_err"] for r in out),
            **{k: top[k] for k in ("ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")},
            "shapes": out}


def probe_case(gen, n, C):
    """Synthetic probe input at (n, C): a table holding C/4 distinct keys,
    inserted by the CUDA insert (the join build's own kernel), the build row
    of each as the payload, and probe keys half hits and half misses, 95 %
    of rows valid.  Returns (table [C+1], rows [C+1], packed, valid)."""
    import numpy as np
    import torch

    from trino_tpu_torch.ops import cuda_kernels as ck
    from trino_tpu_torch.ops.hashing import EMPTY_KEY

    nb = max(C // 4, 1)
    draw = np.unique(gen.integers(0, 1 << 40, size=nb + nb // 8 + 16, dtype=np.int64))
    nb = min(nb, len(draw))
    bkeys = torch.as_tensor(gen.permutation(draw)[:nb], device=DEVICE)
    table = torch.full((C + 1,), EMPTY_KEY, dtype=torch.int64, device=DEVICE)
    slot, placed = ck.hash_insert_(table, bkeys, torch.ones(nb, dtype=torch.bool,
                                                            device=DEVICE))
    check(bool(placed.all()), f"probe_case ({n}, {C}): a build key was not placed")
    rows = torch.zeros(C + 1, dtype=torch.int32, device=DEVICE)
    rows[slot.long()] = torch.arange(nb, dtype=torch.int32, device=DEVICE)
    pick = torch.as_tensor(gen.integers(0, nb, size=n), device=DEVICE)
    miss = torch.as_tensor(gen.random(n) < 0.5, device=DEVICE)
    packed = torch.where(miss, bkeys[pick] + (1 << 41), bkeys[pick])
    valid = torch.as_tensor(gen.random(n) < 0.95, device=DEVICE)
    return table, rows, packed, valid


def join_probe_call(table, rows, packed, valid):
    """A closure that runs ``hashjoin.probe`` as a join's probe side calls it
    (pack one BIGINT key column, hash, walk the chains) over a JoinTable
    holding ``table`` and ``rows``: the probe's whole work, the same in
    every version of the package."""
    import torch

    from trino_tpu_torch import types
    from trino_tpu_torch.ops import hashjoin

    dev = table.device
    jt = hashjoin.JoinTable(table, rows, (), (), torch.zeros((), dtype=torch.int32, device=dev),
                            torch.zeros((), dtype=torch.int32, device=dev),
                            torch.zeros((), dtype=torch.bool, device=dev))
    return lambda: hashjoin.probe(jt, (packed,), (types.BIGINT,), valid)


def probe_checks(seen, gen):
    """hash_probe against its plain version, bit for bit, in both payload
    modes (the build rows, and the slot index: ``vals=None``), at the
    largest and the most frequent main-path shape, over ``probe_case``
    tables; and ``hashjoin.probe`` (pack, hash, probe) split the same way.
    Bounds count what these rows need: the valid mask, the key of each valid
    row, the 32-byte sectors of each walked chain and, with a payload array,
    of each match's payload, and the two outputs; ``old_bound_ms`` counts
    the earlier contract, which also read h0 and step (8 bytes each) of
    every valid row and took an iota payload in slot mode.  The top-level
    numbers are the largest shape's payload mode."""
    import torch

    from trino_tpu_torch.ops import cuda_kernels as ck

    names = kernel_names("hash_probe")
    out = []
    for label, (n, C) in main_path_shapes(seen):
        table, rows, packed, valid = probe_case(gen, n, C)
        chain, hits = probe_chains(table[:C], packed, valid)
        key_bytes = sector_bytes(torch.nonzero(valid).flatten(), 8)
        chain_bytes, payload_bytes = sector_bytes(chain, 8), sector_bytes(hits, 4)
        nv = int(valid.sum())
        join = device_split(join_probe_call(table, rows, packed, valid), names)
        for mode, vals in (("payload", rows[:C]), ("slots", None)):
            a = ck.hash_probe(table[:C], vals, packed, valid)
            b = ck.hash_probe_plain(table[:C], vals, packed, valid)
            torch.cuda.synchronize()
            check(bool((a[0] == b[0]).all()) and bool((a[1] == b[1]).all()),
                  f"hash_probe {label} {mode}: kernel and plain version differ")
            err = max(float((a[0].long() - b[0].long()).abs().max()),
                      float((a[1].long() - b[1].long()).abs().max())) if n else 0.0
            split = device_split(lambda: ck.hash_probe(table[:C], vals, packed, valid), names)
            if split.get("kernel_ms") is not None:
                check(split["kernel_launches"] == 1,
                      f"hash_probe {label} {mode}: {split['kernel_launches']} launches a call")
                check(not split["other_ops"], f"hash_probe {label} {mode}: other device "
                      f"operations {split['other_ops']}")
            plain_ms = time_ms(lambda: ck.hash_probe_plain(table[:C], vals, packed, valid),
                               reps=3, warmup=1)
            # ~20 integer operations a valid row for the two splitmix64
            # rounds, ~6 a slot visited
            b_ms, b_by = bound(n + key_bytes + chain_bytes
                               + (payload_bytes if vals is not None else 0) + n * (4 + 1),
                               chain.numel() * 6 + nv * 20)
            old_ms, _ = bound(n + 3 * key_bytes + chain_bytes + payload_bytes + n * (4 + 1),
                              chain.numel() * 6)
            rec = {"case": label, "mode": mode, "shape": [n, C], "valid_rows": nv,
                   "slots_visited": int(chain.numel()), "max_abs_err": err,
                   "ms": split["wall_ms"], "kernel_ms": split.get("kernel_ms"),
                   "split": split, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "old_bound_ms": old_ms, "library_ms": None, "join_probe": join}
            out.append(rec)
            print(f"kernel hash_probe {label} {mode}: shape={[n, C]} valid={nv} "
                  f"visited={rec['slots_visited']} ms={rec['ms']:.4f} "
                  f"kernel_ms={rec['kernel_ms']} host_ms={split['host_ms']:.4f} "
                  f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.6g} ({b_by}) "
                  f"old_bound_ms={old_ms:.6g} hashjoin.probe ms={join['wall_ms']:.4f} "
                  f"kernel_ms={join.get('kernel_ms')} "
                  f"profiled={split['profile_counts']}", flush=True)
    top = out[0]
    return {"name": "hash_probe", "shape": top["shape"], "mode": top["mode"],
            "max_abs_err": max(r["max_abs_err"] for r in out),
            **{k: top[k] for k in ("ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                                   "old_bound_ms", "library_ms")},
            "shapes": out}


def kernel_checks(shapes, launches, q1_page, li_keys):
    """Phase 3: each kernel against its plain version at the main path's
    largest and most frequent launch shapes (insert also on the main path's
    own keys; fused_segment_agg, which the main path does not launch, at
    Q1's group-by shape and its ceiling).  Returns the kernels' JSON
    records."""
    import numpy as np

    from trino_tpu_torch.ops import cuda_kernels as ck

    gen = np.random.default_rng(7)
    records = [insert_checks(shapes["hash_insert"], ("lineitem_orderkey", *li_keys), gen),
               probe_checks(shapes["hash_probe"], gen),
               compact_checks(shapes["compact_rows"], gen),
               segment_agg_checks(q1_page)]

    out = []
    for r in records:
        s = ck.STATS[r["name"]]
        out.append({"name": r["name"], "route": "cuda", "source": s.source,
                    "replaces": s.replaces, "launches": launches[r["name"]],
                    **{k: v for k, v in r.items() if k != "name"}})
        print(f"kernel {r['name']}: shape={r['shape']} max_abs_err={r['max_abs_err']} "
              f"ms={r['ms']:.4f} kernel_ms={r['kernel_ms']} "
              f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.6g} "
              f"({r['bound_by']}) library_ms={r['library_ms']} "
              f"launches={launches[r['name']]}", flush=True)
    return out


def tpcds_kernel_checks(shapes, ds_conn):
    """Phase 6's kernels against their plain versions at the TPC-DS path's
    own shapes: insert and probe at its largest and most frequent launch
    shapes, insert also on its own keys (``ss_ticket_number`` of the first
    store_sales split), compaction at its largest and most frequent shapes
    and, dropping rows past out_len, at its most selective one.  Returns
    {kernel: {"max_abs_err", "shapes"}} for the kernels the path launched."""
    import numpy as np

    gen = np.random.default_rng(11)
    out = {}
    if shapes["hash_insert"]:
        own = ("store_sales_ticket", *split_keys(ds_conn, "store_sales", "ss_ticket_number"))
        out["hash_insert"] = insert_checks(shapes["hash_insert"], own, gen)
    if shapes["hash_probe"]:
        out["hash_probe"] = probe_checks(shapes["hash_probe"], gen)
    if shapes["compact_rows"]:
        out["compact_rows"] = compact_checks(shapes["compact_rows"], gen)
    return {k: {"max_abs_err": r["max_abs_err"], "shapes": r["shapes"]}
            for k, r in out.items()}


def node_name(node) -> str:
    """A plan node's name; a Limit over a Sort is a TopN."""
    from trino_tpu_torch.sql import plan as P

    if isinstance(node, P.Limit) and isinstance(node.child, P.Sort):
        return "TopN"
    return type(node).__name__


def tpcds_parity(card, cpu, queries):
    """Phase 5: every query on the card and on the CPU, results equal.
    Returns {query: set of plan node names the CPU run executed, plan-time
    subqueries included}."""
    from trino_tpu_torch.exec import local_executor as LE

    seen: set = set()
    execute = LE.LocalExecutor.execute

    def recording(self, node):
        stack = [node]
        while stack:
            nd = stack.pop()
            name = node_name(nd)
            seen.add(name)
            stack.extend(nd.child.children if name == "TopN" else nd.children)
        return execute(self, node)

    nodes = {}
    LE.LocalExecutor.execute = recording
    try:
        for q, sql in queries.items():
            seen.clear()
            ref = cpu.execute_sql(sql, cpu.create_session("tpcds"))
            nodes[q] = set(seen)
            got = card.execute_sql(sql, card.create_session("tpcds"))
            same_result(got, ref, f"tpcds sf{TPCDS_SF_PARITY:g} {q} card vs CPU")
    finally:
        LE.LocalExecutor.execute = execute
    print(f"tpcds sf{TPCDS_SF_PARITY:g}: {len(queries)} queries on the card equal the "
          f"port's CPU results", flush=True)
    return nodes


def tpcds_main(card, cpu, queries, nodes, fact_rows):
    """Phase 6: every query at SF1 on the card (cold, warm, launches, host
    reads, peak memory); the queries that run a node this slice ported are
    held against the CPU.  Returns (per-query results, launches of the run,
    launch shapes of the run)."""
    from trino_tpu_torch.ops import cuda_kernels as ck

    ck.reset_stats()
    got = run_queries(card, queries, fact_rows, f"tpcds sf{TPCDS_SF_MAIN:g}", "tpcds",
                      "store_sales")
    launches = {k: s.launches for k, s in ck.STATS.items()}
    shapes = {k: list(s.shapes) for k, s in ck.STATS.items()}
    for q, kernels in TPCDS_REQUIRED.items():
        for k in kernels:
            check(got[q]["launches"][k] > 0, f"tpcds {q} launched no {k} kernel")
    for k in sorted({k for ks in TPCDS_REQUIRED.values() for k in ks}):
        check(launches[k] > 0, f"the TPC-DS path launched no {k} kernel")
    held = [q for q in queries if nodes[q] & set(TPCDS_NEW_NODES)]
    t0 = time.perf_counter()
    for q in held:
        ref = cpu.execute_sql(queries[q], cpu.create_session("tpcds"))
        same_result(got[q]["result"], ref, f"tpcds sf{TPCDS_SF_MAIN:g} {q} card vs CPU")
    print(f"tpcds sf{TPCDS_SF_MAIN:g}: {len(held)} queries with "
          f"{'/'.join(TPCDS_NEW_NODES)} equal the port's CPU results "
          f"(CPU {time.perf_counter() - t0:.1f} s): {' '.join(held)}", flush=True)
    for q in queries:
        print(f"tpcds nodes {q}: {' '.join(sorted(nodes[q]))}", flush=True)
    return got, launches, shapes


def host_rss_gib() -> float:
    """This process's resident host memory now, in GiB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2**20
    return float("nan")


def memory_engine(device, sf):
    """An engine with ``tpch`` at ``sf`` and an empty ``memory`` catalog, the
    session catalog of the refresh path."""
    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.connectors.tpch import TpchConnector

    e = Engine(device=device)
    e.register_catalog("tpch", TpchConnector(sf=sf, split_rows=SPLIT_ROWS))
    e.register_catalog("memory", MemoryConnector())
    return e, e.create_session("memory")


def run_statement(engine, sess, label, sql):
    """One statement on the card: seconds (and the share of them python's
    garbage collector took), host reads, peak device memory, launches per
    kernel, host RSS after it, and its affected-row count."""
    import gc

    import torch

    from trino_tpu_torch.ops import cuda_kernels as ck

    gc_s, gc_t0 = [0.0], []

    def on_gc(phase, info):
        if phase == "start":
            gc_t0.append(time.perf_counter())
        elif gc_t0:
            gc_s[0] += time.perf_counter() - gc_t0.pop()

    before = {k: s.launches for k, s in ck.STATS.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gc.callbacks.append(on_gc)
    t0 = time.perf_counter()
    try:
        res = engine.execute_sql(sql, sess)
        torch.cuda.synchronize()
    finally:
        gc.callbacks.remove(on_gc)
    rec = {"step": label, "seconds": time.perf_counter() - t0, "gc_s": gc_s[0],
           "host_reads": engine.last_query_counters.get("host_reads"),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "launches": {k: s.launches - before[k] for k, s in ck.STATS.items()},
           "rss_gib": host_rss_gib(),
           "rows": None if res is None else int(res.columns[0][0])}
    print(f"memory {label}: seconds={rec['seconds']} gc_s={rec['gc_s']} rows={rec['rows']} "
          f"host_reads={rec['host_reads']} peak_bytes={rec['peak_bytes']} "
          f"launches={ {k: v for k, v in rec['launches'].items() if v} } "
          f"host_rss_gib={rec['rss_gib']:.2f}", flush=True)
    return rec


def memory_queries(engine, sess, label, fact_rows):
    """The query block: MEMORY_QUERIES over the memory tables (Q15 through its
    view), cold and warm, between two checksums of the stored tables that
    must be equal."""
    sums = {t: engine.execute_sql(sql, sess) for t, sql in CHECKSUMS.items()}
    engine.execute_sql(Q15_VIEW, sess)
    got = run_queries(engine, {q: ALL_QUERIES[q] for q in MEMORY_QUERIES}, fact_rows,
                      f"memory {label}", "memory")
    engine.execute_sql("drop view revenue0", sess)
    for t, sql in CHECKSUMS.items():
        same_result(sums[t], engine.execute_sql(sql, sess),
                    f"memory {label}: {t} changed by the queries over it")
    print(f"memory {label}: checksums of orders and lineitem unchanged by the queries: "
          f"{ {t: r.rows()[0] for t, r in sums.items()} }", flush=True)
    return got


def delete_compact_check(arrays, keep, kept):
    """compact_rows against its plain version on DELETE's own inputs: the
    stored columns of a table and the kept rows' mask, byte for byte."""
    import torch

    from trino_tpu_torch.ops import cuda_kernels as ck

    names = kernel_names("compact_rows")
    n = keep.shape[0]
    a, ta = ck.compact_rows(arrays, keep, kept)
    b, tb = ck.compact_rows_plain(arrays, keep, kept)
    torch.cuda.synchronize()
    check(int(ta) == int(tb) == kept, "compact_rows delete: live counts differ")
    for x, y in zip(a, b):
        check(x.dtype == y.dtype and bool((x == y).all()),
              "compact_rows delete: kernel and plain version differ")
    split = device_split(lambda: ck.compact_rows(arrays, keep, kept), names)
    if split.get("kernel_ms") is not None:
        check(split["kernel_launches"] <= -(-len(arrays) // 16),
              f"compact_rows delete: {split['kernel_launches']} launches a call")
    plain_ms = time_ms(lambda: ck.compact_rows_plain(arrays, keep, kept))
    library_ms = time_ms(lambda: [c[keep] for c in arrays])
    widths = [c.element_size() for c in arrays]
    rows = torch.nonzero(keep).flatten()
    b_ms, b_by = bound(n + sum(sector_bytes(rows, w) for w in widths)
                       + kept * sum(widths) + 8, n * 4)
    rec = {"case": "delete", "shape": [n, kept, widths], "live": kept, "max_abs_err": 0.0,
           "ms": split["wall_ms"], "kernel_ms": split.get("kernel_ms"), "split": split,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}
    print(f"kernel compact_rows delete: shape={rec['shape']} ms={rec['ms']:.4f} "
          f"kernel_ms={rec['kernel_ms']} plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} bound_ms={b_ms:.6g} "
          f"profiled={split['profile_counts']}", flush=True)
    return rec


def memory_path(tpch_ref):
    """Phase 8: TPC-H's refresh path at SF1 over the memory catalog on the
    card, then the same statements on the CPU.  ``tpch_ref`` holds phase 2's
    results of MEMORY_QUERIES over ``tpch``.  Returns (launches of the run,
    {kernel: checks at this path's shapes})."""
    import numpy as np
    import torch

    from trino_tpu_torch.ops import cuda_kernels as ck

    t_phase = time.perf_counter()
    print(f"memory path: host RSS before the load {host_rss_gib():.2f} GiB", flush=True)
    card, sess = memory_engine(DEVICE, SF_MAIN)
    tpch = card.catalogs["tpch"]
    mem = card.catalogs["memory"]
    path = refresh_path(tpch.exact_row_count("orders"))
    want = {label: int(card.execute_sql(sql, sess).columns[0][0])
            for label, sql in path["counts"].items()}
    steps = {}
    ck.reset_stats()
    for label, sql in path["load"]:
        steps[label] = run_statement(card, sess, label, sql)
    li_rows = mem.row_count("lineitem")
    n_orders = mem.row_count("orders")
    for label, sql in path["rf1"]:
        steps[label] = run_statement(card, sess, label, sql)
    check(steps["insert_lineitem"]["rows"] == want["insert_lineitem"],
          f"RF1 inserted {steps['insert_lineitem']['rows']} line items, "
          f"tpch has {want['insert_lineitem']}")
    check(mem.row_count("orders") - n_orders == want["merge_orders"] == path["band"],
          f"RF1's MERGE added {mem.row_count('orders') - n_orders} orders, "
          f"not {path['band']}")
    check(mem.row_count("lineitem") == tpch.exact_row_count("lineitem"),
          "after RF1 the memory lineitem is not TPC-H's")
    after_rf1 = memory_queries(card, sess, "after RF1", mem.row_count("lineitem"))
    for q in MEMORY_QUERIES:
        same_result(tpch_ref[q], after_rf1[q]["result"],
                    f"memory after RF1 {q} vs tpch (phase 2)", by_value=True)
    print(f"memory after RF1: {len(MEMORY_QUERIES)} queries equal phase 2's tpch "
          f"results", flush=True)

    # DELETE's own compaction inputs: the stored lineitem and the kept rows
    t = mem._tables["lineitem"]
    del_arrays = list(t.columns) + [m for m in t.nulls if m is not None]
    del_keep = t.columns[t.schema.index("l_orderkey")] > path["band"]
    for label, sql in path["rf2"]:
        steps[label] = run_statement(card, sess, label, sql)
        check(steps[label]["rows"] == want[label],
              f"{label} affected {steps[label]['rows']} rows, tpch has {want[label]}")
    after_rf2 = memory_queries(card, sess, "after RF2", mem.row_count("lineitem"))
    launches = {k: s.launches for k, s in ck.STATS.items()}
    shapes = {k: list(s.shapes) for k, s in ck.STATS.items()}

    # which kernels each statement must launch
    ran = {**{label: r["launches"] for label, r in steps.items()},
           **{q: after_rf1[q]["launches"] for q in MEMORY_QUERIES}}
    for label, kernels in MEMORY_REQUIRED.items():
        for k in kernels:
            check(ran[label][k] > 0, f"memory {label} launched no {k} kernel")
    for k in sorted({k for ks in MEMORY_REQUIRED.values() for k in ks}):
        check(launches[k] > 0, f"the memory path launched no {k} kernel")
    # DELETE's compaction is the port's own: one launch per 16 stored arrays,
    # at (rows before, rows kept)
    n_li, kept = int(del_keep.shape[0]), int(del_keep.sum())
    per = -(-len(del_arrays) // 16)
    at = [s for s in shapes["compact_rows"] if s[0] == n_li and s[1] == kept]
    check(len(at) == per and steps["delete_lineitem"]["launches"]["compact_rows"] >= per,
          f"DELETE from lineitem made {len(at)} compactions at ({n_li}, {kept}), not {per}")
    print(f"memory: DELETE compacted {len(del_arrays)} stored arrays of lineitem "
          f"({n_li} -> {kept} rows) in {len(at)} compact_rows launches", flush=True)
    card_s = time.perf_counter() - t_phase

    # the same statements on the CPU; its results after RF2 are the oracle
    t_cpu = time.perf_counter()
    cpu, csess = memory_engine("cpu", SF_MAIN)
    for step in ("load", "rf1", "rf2"):
        for label, sql in path[step]:
            res = cpu.execute_sql(sql, csess)
            check((None if res is None else int(res.columns[0][0])) == steps[label]["rows"],
                  f"{label}: the CPU's affected rows differ from the card's")
    cpu.execute_sql(Q15_VIEW, csess)
    for q in MEMORY_QUERIES:
        same_result(after_rf2[q]["result"], cpu.execute_sql(ALL_QUERIES[q], csess),
                    f"memory after RF2 {q} card vs CPU")
    print(f"memory after RF2: {len(MEMORY_QUERIES)} queries equal the port's CPU run of "
          f"the sequence (CPU {time.perf_counter() - t_cpu:.1f} s)", flush=True)
    del cpu, csess

    gen = np.random.default_rng(13)
    checks = {
        "hash_insert": insert_checks(shapes["hash_insert"], (
            "memory_orders_orderkey", *split_keys(mem, "orders", "o_orderkey")), gen),
        "hash_probe": probe_checks(shapes["hash_probe"], gen),
        "compact_rows": compact_checks(shapes["compact_rows"], gen),
    }
    checks["compact_rows"]["shapes"].append(delete_compact_check(del_arrays, del_keep, kept))
    print(f"memory path: card {card_s:.1f} s, phase {time.perf_counter() - t_phase:.1f} s, "
          f"launches { {k: v for k, v in launches.items() if v} }", flush=True)
    del card, sess, mem, t, del_arrays, del_keep
    torch.cuda.empty_cache()
    return launches, {k: {"max_abs_err": r["max_abs_err"], "shapes": r["shapes"]}
                      for k, r in checks.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from trino_tpu_torch import Engine
        from trino_tpu_torch.connectors.tpcds import TpcdsConnector
        from trino_tpu_torch.connectors.tpcds_queries import corpus
        from trino_tpu_torch.connectors.tpch import TpchConnector
        from trino_tpu_torch.ops import cuda_kernels as ck
    except ImportError as e:
        print(f"chip_smoke: trino_tpu_torch is not beside this script: {e}",
              file=sys.stderr)
        return 3

    t_start = time.perf_counter()
    try:
        card = card_line()
        print(f"card: {card}", flush=True)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)}", flush=True)

        built = ck.build_kernels()
        print(f"build: {built['seconds']:.2f} s for {len(built['log'])} sources", flush=True)
        for src, log in built["log"].items():
            for line in log.splitlines():
                if "registers" in line or "error" in line.lower():
                    print(f"  {src}: {line.strip()}")

        # -- phase 2: the main path at SF1 -------------------------------------
        conn = TpchConnector(sf=SF_MAIN, split_rows=SPLIT_ROWS)
        engine = Engine(device=DEVICE)
        engine.register_catalog("tpch", conn)
        engine.execute_sql(Q15_VIEW, engine.create_session("tpch"))
        li_rows = conn.exact_row_count("lineitem")
        ck.reset_stats()
        main = run_queries(engine, ALL_QUERIES, li_rows, f"sf{SF_MAIN:g}")
        launches = {k: s.launches for k, s in ck.STATS.items()}
        shapes = {k: list(s.shapes) for k, s in ck.STATS.items()}
        for q, kernels in REQUIRED.items():
            for k in kernels:
                check(main[q]["launches"][k] > 0, f"{q} launched no {k} kernel")
        for k, n in launches.items():
            if k in NO_ENGINE_CALLER:
                print(f"main path: {k} launched {n} times (no engine caller)", flush=True)
            else:
                check(n > 0, f"main path launched no {k} kernel")

        cpu = Engine(device="cpu")
        cpu.register_catalog("tpch", TpchConnector(sf=SF_MAIN, split_rows=SPLIT_ROWS))
        cpu.execute_sql(Q15_VIEW, cpu.create_session("tpch"))
        t_cpu = time.perf_counter()
        for q, sql in ALL_QUERIES.items():
            t0 = time.perf_counter()
            ref = cpu.execute_sql(sql, cpu.create_session("tpch"))
            same_result(main[q]["result"], ref, f"sf{SF_MAIN:g} {q} card vs CPU")
            check(len(ref) > 0, f"{q} returned no rows")
            print(f"sf{SF_MAIN:g} {q}: equal to the port's CPU result "
                  f"({len(ref)} rows, CPU {time.perf_counter() - t0:.2f} s)", flush=True)
        print(f"CPU pass: {time.perf_counter() - t_cpu:.1f} s", flush=True)
        del cpu
        # phase 8's oracle after RF1
        tpch_ref = {q: main[q]["result"] for q in MEMORY_QUERIES}

        # -- phase 3: kernels against their plain versions ---------------------
        q1_page = conn.generate(conn.splits("lineitem")[0], Q1_COLUMNS)
        li_keys = lineitem_keys(conn)
        kernels = kernel_checks(shapes, launches, q1_page, li_keys)
        del q1_page, li_keys

        # -- phase 4: SF10 on the card alone -----------------------------------
        del engine, main, conn
        torch.cuda.empty_cache()
        big = TpchConnector(sf=SF_BIG, split_rows=SPLIT_ROWS)
        engine = Engine(device=DEVICE)
        engine.register_catalog("tpch", big)
        big_res = run_queries(engine, QUERIES, big.exact_row_count("lineitem"),
                              f"sf{SF_BIG:g}")
        for q, r in big_res.items():
            check(r["rows"] > 0, f"sf{SF_BIG:g} {q} returned no rows")
        print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)

        # -- phase 5: TPC-DS parity at SF0.1 ------------------------------------
        del engine, big_res, big
        torch.cuda.empty_cache()
        gpu = Engine(device=DEVICE)
        gpu.register_catalog("tpcds", TpcdsConnector(sf=TPCDS_SF_PARITY,
                                                      split_rows=SPLIT_ROWS))
        cpu = Engine(device="cpu")
        cpu.register_catalog("tpcds", TpcdsConnector(sf=TPCDS_SF_PARITY,
                                                     split_rows=SPLIT_ROWS))
        tpcds_queries = corpus()
        nodes = tpcds_parity(gpu, cpu, tpcds_queries)

        # -- phase 6: TPC-DS at SF1 ----------------------------------------------
        ds = TpcdsConnector(sf=TPCDS_SF_MAIN, split_rows=SPLIT_ROWS)
        gpu = Engine(device=DEVICE)
        gpu.register_catalog("tpcds", ds)
        cpu = Engine(device="cpu")
        cpu.register_catalog("tpcds", TpcdsConnector(sf=TPCDS_SF_MAIN,
                                                     split_rows=SPLIT_ROWS))
        ds_main, ds_launches, ds_shapes = tpcds_main(gpu, cpu, tpcds_queries, nodes,
                                                     ds.exact_row_count("store_sales"))
        del cpu, ds_main
        ds_checks = tpcds_kernel_checks(ds_shapes, ds)

        # -- phase 7: TPC-DS SF10 on the card alone ------------------------------
        del gpu, ds
        torch.cuda.empty_cache()
        ds_big = TpcdsConnector(sf=TPCDS_SF_BIG, split_rows=SPLIT_ROWS)
        gpu = Engine(device=DEVICE)
        gpu.register_catalog("tpcds", ds_big)
        big_res = run_queries(gpu, {q: tpcds_queries[q] for q in TPCDS_BIG},
                              ds_big.exact_row_count("store_sales"),
                              f"tpcds sf{TPCDS_SF_BIG:g}", "tpcds", "store_sales")
        for q, r in big_res.items():
            check(r["rows"] > 0, f"tpcds sf{TPCDS_SF_BIG:g} {q} returned no rows")
        # -- phase 8: the memory catalog at SF1, TPC-H's refresh path -----------
        del gpu, ds_big, big_res
        torch.cuda.empty_cache()
        mem_launches, mem_checks = memory_path(tpch_ref)

        # per path: its launches, and the checks at its own shapes (the
        # top-level times stay the TPC-H path's largest shape's)
        for r in kernels:
            name = r["name"]
            r["by_path"] = {
                "tpch_sf1": {"launches": r["launches"], "max_abs_err": r["max_abs_err"],
                             "checked_shapes": [x["shape"] for x in r["shapes"]]},
                "tpcds_sf1": {"launches": ds_launches[name],
                              **ds_checks.get(name, {"max_abs_err": None, "shapes": []})},
                "memory_sf1": {"launches": mem_launches[name],
                               **mem_checks.get(name, {"max_abs_err": None, "shapes": []})}}
            for checks in (ds_checks, mem_checks):
                if name in checks:
                    r["max_abs_err"] = max(r["max_abs_err"], checks[name]["max_abs_err"])
            r["launches"] += ds_launches[name] + mem_launches[name]
        print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

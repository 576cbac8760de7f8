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
9. The function library (``functions_path``): the statements of
   tests/test_torch_functions.py and tests/test_torch_aggregates.py
   (``FUNCTION_CASES``, ``AGGREGATE_CASES``, over TPC-H at SF0.01 and memory
   tables) on the card and the CPU, the same outcome for each; F1-F7
   (``FUNCTIONS``: percentiles, max_by/min_by, date keys with the new
   accumulators, checksums, exact sums past 2^63, math and bitwise calls,
   listagg) at SF1 on the card, cold and warm, with host reads, peak memory
   and launches, each equal to the port's CPU result, each launching the
   kernels ``FUNCTIONS_REQUIRED`` names (the JAX reference's recording);
   the kernels the path launched against their plain versions at its
   shapes (insert also on F4's ``l_orderkey % 1024``); then F1, F3 and F5
   at SF10 on the card alone, held by oracles that need no CPU run
   (``functions_big``).  The kernels line's ``by_path`` gains
   ``functions_sf1``.
10. Arrays, maps, UNNEST and MATCH_RECOGNIZE (``arrays_path``): the
   statements of tests/test_torch_arrays.py and tests/test_torch_match.py
   (``ARRAY_CASES``, ``MATCH_CASES``) on the card and the CPU, the same
   outcome for each; then ``orders_nested`` (TPC-H SF1's orders with their
   line items as arrays, built through the memory connector's ``append`` and
   timed on its own) and A1-A6 (``ARRAYS``: UNNEST with ordinality, a hash
   group-by over unnested elements, element calls, lambdas, array- and
   map-valued aggregates, MATCH_RECOGNIZE over orders) at SF1 on the card,
   cold and warm, with host reads, H2D bytes, peak memory and launches, each
   equal to the port's CPU result, A1 also to its lineitem oracle
   (``A1_ORACLE``), and A7 (ALL ROWS PER MATCH) at SF0.1 against the CPU;
   the kernels ``ARRAYS_REQUIRED`` names (the JAX reference's recording)
   must launch, and those the path launched are held against their plain
   versions at its shapes (insert also on A2's keys).  ``by_path`` gains
   ``arrays_sf1``.
11. The coordinator entry point (``server_path``): a ``CoordinatorServer``
   (``dispatch_threads=4``) in this process over a card engine holding TPC-H
   at SF1, a memory catalog and the system catalog; clients on loopback
   HTTP.  (a) The 22 queries through ``Client``, each equal to phase 2's
   direct result as the server sends it (``_json_value``), with the host
   reads and launches of each statement equal to phase 2's
   (``SERVER_REQUIRED``), and a warm wall from POST to the last page beside
   the direct warm wall; (b) bench.py's five queries from one client and
   from four at once (each runs them twice, in its own order): statements/s,
   peak memory, every result equal to the serial one, each statement's
   launches equal to its serial run's and the summed launches 8x the
   serial ones; (c) the 1,500,000 rows of SF1 orders pulled inline and
   spooled (json+zlib), rows/s at the client, row count and column sums
   equal to the direct run's; (d) SHOW, EXPLAIN [ANALYZE], PREPARE /
   EXECUTE and protocol parameters of Q3, SET SESSION of
   join_distribution_type (EXPLAIN of Q3 must show every join
   partitioned), CTAS of Q1 into memory, system.queries listing the phase's statements, a cancel and a
   wrong password, held against the direct engine; (e) the DB-API over HTTP
   (Q1 and a parameterized Q6) and the verifier over the 22 at SF0.1, the
   port on the CPU as control and a card server as test, all MATCH.  Then
   insert, probe and compaction against their plain versions at the shapes
   recorded while the four clients ran.  ``by_path`` gains ``server_sf1``.

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
# phase 9: the function library's path, the reports an analyst runs over
# TPC-H's fact tables (F1-F7; F4 is two statements)
FUNCTIONS = {
    "f1_percentiles": "select l_returnflag, l_linestatus, "
                      "approx_percentile(l_extendedprice, 0.5) p50, "
                      "approx_percentile(l_quantity, 0.9) p90, count(*) c from lineitem "
                      "group by 1, 2 order by 1, 2",
    "f2_max_by": "select o_custkey, max_by(o_orderkey, o_totalprice), "
                 "min_by(o_orderdate, o_totalprice) from orders group by o_custkey "
                 "order by o_custkey",
    "f3_date_keys": "select date_trunc('month', l_shipdate) m, quarter(l_shipdate) q, "
                    "day_of_week(l_shipdate) dw, count(*), "
                    "avg(date_diff('day', l_shipdate, l_receiptdate)), "
                    "bool_and(l_receiptdate > l_shipdate), bool_or(l_returnflag = 'R'), "
                    "arbitrary(l_shipmode) from lineitem group by 1, 2, 3 order by 1, 3",
    "f4_checksums": "select checksum(l_orderkey), checksum(l_extendedprice), "
                    "checksum(l_comment), count(*) from lineitem",
    "f4_checksum_buckets": "select l_orderkey % 1024 b, checksum(l_partkey) from lineitem "
                           "group by 1 order by 1",
    "f5_wide_sums": "select l_returnflag, l_linestatus, "
                    "sum(cast(l_extendedprice as decimal(38,12))) from lineitem "
                    "group by 1, 2 order by 1, 2",
    "f6_math": "select l_shipmode, stddev(ln(l_extendedprice)), avg(power(l_discount, 2)), "
               "max(round(sqrt(l_quantity), 3)), max(greatest(l_tax, l_discount)), "
               "count_if(bitwise_and(l_orderkey, 7) = 0), "
               "max(width_bucket(l_extendedprice, 0, 100000, 10)) from lineitem "
               "group by l_shipmode order by 1",
    "f7_listagg": "select n_regionkey, listagg(n_name, ',') within group (order by n_name) "
                  "from nation group by n_regionkey order by 1",
}
# phase 9a and tests/test_torch_functions.py: the SQL of the reference's
# scalar function tests, (catalog, statement): "tpch" over TPC-H SF0.01,
# "mem" over FUNCTION_SETUP's tables
FUNCTION_CASES = {
    # tests/test_scalar_functions.py
    "math": ("tpch", "select power(2, 10) p, mod(10, 3) m, sign(-5) s, trunc(3.9) t, "
                     "round(2.567, 2) r from region limit 1"),
    "math_2": ("tpch", "select ln(exp(2.0)) l, log10(1000) lt, sin(0) s, pi() p "
                       "from region limit 1"),
    "date_functions": ("tpch", "select o_orderdate d, date_trunc('month', o_orderdate) m, "
                               "date_trunc('year', o_orderdate) y, quarter(o_orderdate) q, "
                               "day_of_week(o_orderdate) dw, day_of_year(o_orderdate) dy "
                               "from orders order by o_orderkey limit 50"),
    "conditional": ("tpch", "select nullif(n_nationkey, 0) z, nullif(n_nationkey, 9) nz, "
                            "if(n_nationkey = 0, 'zero', 'other') i "
                            "from nation where n_nationkey = 0"),
    "nullif_null_second": ("tpch", "select nullif(n_nationkey, nullif(0, 0)) v from nation "
                                   "where n_nationkey = 2"),
    "round_half_away": ("tpch", "select round(0.125, 2) a, round(2.5) b, round(-2.5) c "
                                "from region limit 1"),
    "width_bucket": ("tpch", "select width_bucket(5.5, 0, 10, 5) w from region limit 1"),
    "date_add_month_clamps": ("tpch", "select date_add('month', 2, date '1995-12-31') "
                                      "= date '1996-02-29'"),
    "date_add_year_clamps": ("tpch", "select date_add('year', 1, date '1996-02-29') "
                                     "= date '1997-02-28'"),
    "date_diff_month": ("tpch", "select date_diff('month', date '1995-01-15', "
                                "date '1995-03-14')"),
    "date_diff_week": ("tpch", "select date_diff('week', date '1995-01-01', "
                               "date '1995-01-15')"),
    "try_cast_bigint": ("mem", "select try_cast(v as bigint) from tc"),
    "try_cast_double": ("mem", "select try_cast(v as double) from tc"),
    "try_cast_count": ("mem", "select count(try_cast(v as bigint)) from tc"),
    "nullif_string_literal": ("tpch", "select n_name, nullif(n_name, 'FRANCE') v "
                                      "from nation order by n_name"),
    "nullif_literal_first": ("tpch", "select n_name, nullif('FRANCE', n_name) v "
                                     "from nation order by n_name"),
    "nullif_absent_literal": ("tpch", "select n_name, nullif(n_name, 'banana') v "
                                      "from nation order by n_name"),
    # tests/test_functions_ext.py (its memory table t)
    "hyperbolic_and_log": ("mem", "select sinh(x) a, cosh(x) b, tanh(x) c, log(2, 8) d, "
                                  "e() e from t order by n"),
    "float_tests_and_truncate": ("mem", "select is_nan(nan()) a, is_finite(infinity()) b, "
                                        "is_infinite(infinity()) c, truncate(1.999) d, "
                                        "truncate(1.987, 2) e, truncate(-1.987, 2) f, "
                                        "truncate(x, 1) g from t order by n"),
    "bitwise_family": ("mem", "select bitwise_and(n, 3) a, bitwise_or(n, 3) b, "
                              "bitwise_xor(n, 3) c, bitwise_not(n) d, "
                              "bitwise_left_shift(n, 2) e, bitwise_right_shift(n, 1) f, "
                              "bitwise_right_shift(-8, 1) g, "
                              "bitwise_right_shift_arithmetic(-8, 1) h, "
                              "bit_count(n, 64) i, bit_count(-1, 8) j from t order by n"),
    "bit_count_out_of_range": ("mem", "select n, bit_count(n, 8) c from t order by n"),
    "datetime_family": ("mem", "select d, day_of_week(d) a, day_of_year(d) b, "
                               "last_day_of_month(d) c, week_of_year(d) w, "
                               "year_of_week(d) yw, date_trunc('week', d) tw, "
                               "date_trunc('quarter', d) tq, month(d) m, day(d) dd "
                               "from t order by n"),
    "date_arith": ("mem", "select date_add('day', -3, d) a, date_add('week', 2, d) b, "
                          "date_add('year', -1, d) c, date_diff('day', d, date '2024-03-31') e, "
                          "date_diff('year', d, date '2030-01-01') f from t order by n"),
    # tests/test_functions_ext2.py and test_functions_stats.py
    "trig_family": ("mem", "select sin(x) a, cos(x) b, tan(x) c, asin(x / 4) d, "
                           "acos(x / 4) e, atan(x) f, atan2(x, 2.0) g, degrees(x) h, "
                           "radians(x) i, cbrt(x) j, sqrt(abs(x)) k from t order by n"),
    "cbrt_exact": ("mem", "select cbrt(27.0) a, cbrt(-8.0) b, cbrt(x * x * x) c "
                          "from t order by n"),
    "greatest_least": ("mem", "select greatest(n, 10, 7) a, least(x, 0.0) b, "
                              "greatest(d, date '2021-06-01') c from t order by n"),
    "mod_negative": ("mem", "select mod(n - 100, 7) a, mod(x, 0.75) b, n % -4 c "
                            "from t order by n"),
    "power_and_exp": ("mem", "select power(x, 2) a, power(2, n / 10) b, exp(x) c, "
                             "ln(abs(x)) d, log10(n) e, log2(n) f from t order by n"),
    "sign_and_rounding": ("mem", "select sign(x) a, floor(x) b, ceil(x) c, round(x) d, "
                                 "round(x, 1) e, trunc(x) f, abs(n - 100) g from t order by n"),
    "normal_cdf": ("mem", "select normal_cdf(0, 1, x) a, inverse_normal_cdf(1, 2, 0.3) b "
                          "from t order by n"),
    "beta_cdf": ("mem", "select beta_cdf(2, 5, 0.3) a, beta_cdf(0.5, 0.5, 0.9) b, "
                        "beta_cdf(3, 1.5, abs(x) / 4) c from t order by n"),
    "wilson_interval": ("mem", "select wilson_interval_lower(n, 300, 1.96) lo, "
                               "wilson_interval_upper(n, 300, 1.96) hi, "
                               "wilson_interval_lower(20, 100, 0) z from t order by n"),
    "width_bucket_column": ("mem", "select width_bucket(x, -3, 3, 6) w from t order by n"),
    # tests/test_spatial.py
    "st_distance": ("mem", "select st_distance(st_point(x, 1.0), st_point(0.0, n)) v "
                           "from t order by n"),
    "spatial_join": ("mem", "select a.n an, b.n bn from t a, t b "
                            "where st_distance(st_point(a.x, 0.0), st_point(b.x, 0.0)) < 2.0 "
                            "order by an, bn"),
    # tests/test_parametric_types.py: timestamps at the result surface
    "timestamp_columns": ("mem", "select ts, t3 from ev"),
    "timestamp_order": ("mem", "select ts, t3 from ev order by ts nulls last"),
    "timestamp_interval": ("mem", "select ts + interval '1' day a, t3 - interval '2' hour b "
                                  "from ev order by ts nulls last"),
    "timestamp_compare": ("mem", "select count(*) from ev "
                                 "where ts > timestamp '2000-01-01 00:00:00'"),
    "timestamp_extract": ("mem", "select hour(ts) h, minute(ts) mi, second(ts) s, "
                                 "millisecond(t3) ms, year(ts) y, month(ts) mo, day(ts) d "
                                 "from ev order by ts nulls last"),
    "timestamp_casts": ("mem", "select cast(ts as timestamp(3)) a, cast(t3 as timestamp(6)) b, "
                               "cast(ts as date) c, cast(cast(ts as date) as timestamp(6)) d "
                               "from ev order by ts nulls last"),
    "timestamp_literal": ("mem", "select timestamp '2024-03-15 10:30:45.123456' x, "
                                 "timestamp '1969-12-31 23:59:59.999' y"),
    "from_unixtime": ("mem", "select from_unixtime(1710498645) x"),
    "timestamp_group_by": ("mem", "select cast(ts as date) dd, count(*) c from ev "
                                  "group by 1 order by 1 nulls last"),
    # tests/test_scalar_functions.py, the rest
    "string_functions": ("tpch", "select upper(n_name) u, length(n_name) n, reverse(n_name) rv, "
                                 "strpos(n_name, 'GER') sp, starts_with(n_name, 'ALG') sw, "
                                 "replace(n_name, 'A', '@') rp, concat('pre-', n_name) c1, "
                                 "n_name || '-post' c2, lpad(n_name, 10, '.') lp, "
                                 "rpad(n_name, 3) rp2, lpad(n_name, 12, 'xy') lxy "
                                 "from nation order by n_nationkey"),
    "lpad_empty_pad": ("tpch", "select lpad(n_name, 12, '') from nation"),
    "case_group_by": ("tpch", "select case when n_nationkey < 5 then 'low' when n_nationkey < 15 "
                              "then 'mid' else 'high' end b, count(*) c from nation "
                              "group by 1 order by 1"),
    "string_case_order": ("tpch", "select distinct case when n_nationkey < 5 then 'b-low' "
                                  "else 'a-high' end v from nation order by v"),
    "regexp_like_count": ("tpch", "select count(*) from nation where regexp_like(n_name, '^.*IA$')"),
    "split_part_position": ("tpch", "select split_part(n_name, 'I', 2) a, position('I' in n_name) b "
                                    "from nation order by n_nationkey"),
    "codepoint": ("tpch", "select codepoint('A')"),
    "having_over_formatter_dict": ("tpch", "select c_nationkey, min(c_name) m from customer "
                                           "group by c_nationkey having min(c_name) = 'nobody'"),
    # tests/test_functions_ext.py, the rest (its table t)
    "regexp_family": ("mem", "select regexp_extract(s, '\\d+') a, "
                             "regexp_extract(s, '([a-z]+)-(\\d+)', 2) b, regexp_extract(s, 'ZZZ') c, "
                             "regexp_replace(s, '\\d', '#') d, regexp_replace(s, '(\\d+)', '<$1>') e, "
                             "regexp_count(s, '\\d') f, regexp_position(s, '1') g, "
                             "regexp_position(s, 'ZZZ') h, regexp_replace(s, '\\d+', '[$0]') i "
                             "from t order by n"),
    "regexp_bad_group": ("mem", "select regexp_replace(s, '(\\d)', '$9') v from t where n = 255"),
    "string_distance": ("mem", "select levenshtein_distance(s, 'abc-124-xyz') a, "
                               "hamming_distance(s, 'abc-124-xyz') b, ends_with(s, 'xyz') c, "
                               "translate(s, 'abc', 'AB') d, translate(s, 'aa', 'bc') e "
                               "from t order by n"),
    "url_family": ("mem", "select url_extract_protocol(s) a, url_extract_host(s) b, "
                          "url_extract_port(s) c, url_extract_path(s) d, url_extract_query(s) e, "
                          "url_extract_fragment(s) f, url_extract_parameter(s, 'r') g, "
                          "url_encode('a b&c') h, url_decode('a+b%26c') i from t order by n"),
    "datetime_breadth": ("mem", "select week(d) a, yow(d) b, day_of_month(d) c, "
                                "from_iso8601_date('2023-07-04') e from t order by n"),
    "truncate_negative_scale": ("mem", "select truncate(1987.6, -2) v from t where n = 5"),
    "truncate_bad_literal": ("mem", "select truncate(1.9, 1.5) v from t where n = 5"),
    # tests/test_functions_ext2.py (its table fx2); test_now is a clock case
    "digests": ("mem", "select sha1(s) a, sha512(s) b, crc32(s) c, xxhash64(s) d from fx2 "
                       "order by n"),
    "hmac": ("mem", "select hmac_md5(s, 'key') a, hmac_sha1(s, 'key') b, "
                    "hmac_sha256(s, 'key') c, hmac_sha512(s, 'key') d from fx2 order by n"),
    "base64": ("mem", "select to_base64(s) a, from_base64(s) b, to_base64url(s) c, "
                      "from_base64url(s) d from fx2 where n = 3"),
    "base64_encode": ("mem", "select to_base64(s) a, to_base64url(s) c from fx2 order by n"),
    "from_base": ("mem", "select from_base('ff', 16) a, from_base('101', 2) b, from_base(s, 16) c "
                         "from fx2 order by n"),
    "soundex_luhn": ("mem", "select soundex('Robert') a, soundex(s) b, luhn_check(s) c "
                            "from fx2 order by n"),
    "concat_ws": ("mem", "select concat_ws('-', s, 'x') a, concat_ws(', ', 'a', 'b', 'c') b "
                         "from fx2 order by n"),
    "json_family": ("mem", "select json_parse(j) a, json_format(j) b, is_json_scalar(j) c, "
                           "json_array_contains(j, 2) d, json_array_get(j, 1) e, "
                           "json_array_get(j, -1) f, json_array_get(j, 7) g from fx2 order by n"),
    "iso8601": ("mem", "select to_iso8601(date '2024-02-29') a, "
                       "from_iso8601_timestamp('2024-02-29T12:30:45') b from fx2 where n = 1"),
    "cdf_constants": ("mem", "select normal_cdf(0, 1, 0) a, normal_cdf(0, 1, 1.96) b, "
                             "inverse_normal_cdf(0, 1, 0.975) c, beta_cdf(2, 2, 0.5) d, "
                             "wilson_interval_lower(20, 100, 1.96) e, "
                             "wilson_interval_upper(20, 100, 1.96) f from fx2 where n = 1"),
    "cdf_on_column": ("mem", "select normal_cdf(0, 1, x) v from fx2 order by n"),
    "datetime_batch3": ("mem", "select parse_datetime('2024-02-29 12:30', 'yyyy-MM-dd HH:mm') a, "
                               "parse_datetime('junk', 'yyyy-MM-dd') b, current_timezone() c, "
                               "timezone_hour(now()) d, timezone_minute(now()) e, version() f "
                               "from fx2 where n = 1"),
    "base32": ("mem", "select from_base32(to_base32('hello')) a, to_base32(s) b from fx2 "
                      "order by n"),
    # tests/test_functions_stats.py (TPC-H SF0.01)
    "covariance_family": ("tpch", "select covar_pop(l_extendedprice, l_quantity) cp, "
                                  "covar_samp(l_extendedprice, l_quantity) cs, "
                                  "corr(l_extendedprice, l_quantity) c, "
                                  "regr_slope(l_extendedprice, l_quantity) sl, "
                                  "regr_intercept(l_extendedprice, l_quantity) ic, "
                                  "regr_count(l_extendedprice, l_quantity) n, "
                                  "regr_avgx(l_extendedprice, l_quantity) ax, "
                                  "regr_avgy(l_extendedprice, l_quantity) ay from lineitem"),
    "moments_family": ("tpch", "select skewness(l_quantity) sk, kurtosis(l_quantity) ku, "
                               "regr_sxy(l_extendedprice, l_quantity) sxy from lineitem"),
    "regr_count_grouped": ("tpch", "select l_returnflag, regr_count(l_extendedprice, l_quantity) n, "
                                   "count(*) c from lineitem group by l_returnflag "
                                   "order by l_returnflag"),
    "covar_samp_null_pairs": ("tpch", "select covar_samp(x, y) from (select cast(null as double) x, "
                                      "1.0 y union all select 2.0, 2.0 union all select 3.0, 4.0)"),
    "date_format_families": ("tpch", "select date_format(o_orderdate, '%Y-%m') a, "
                                     "format_datetime(o_orderdate, 'yyyy/MM/dd') b, "
                                     "date_format(o_orderdate, '%W, %e %M %Y') c, "
                                     "format_datetime(o_orderdate, 'EEE, dd MMM yyyy') d "
                                     "from orders order by o_orderkey limit 20"),
    "date_parse_roundtrip": ("tpch", "select date_parse(date_format(o_orderdate, '%Y-%m-%d'), "
                                     "'%Y-%m-%d') p, date_parse(date_format(o_orderdate, "
                                     "'%M %d, %Y'), '%M %d, %Y') q, o_orderdate "
                                     "from orders order by o_orderkey limit 20"),
    "date_format_out_of_range": ("tpch", "select date_format(date '1899-12-31', '%Y-%m-%d') v"),
    "regr_r2_constant": ("tpch", "select regr_r2(y, x) from (select 7.0 y, 1.0 x union all "
                                 "select 7.0, 2.0 union all select 7.0, 5.0)"),
    "unixtime_roundtrip": ("tpch", "select to_unixtime(from_unixtime(1700000000.25)) v"),
    "md5_group_by": ("tpch", "select md5(c_mktsegment) m, c_mktsegment s from customer "
                             "group by md5(c_mktsegment), c_mktsegment order by s"),
    "hex_group_by": ("tpch", "select from_hex(to_hex(c_mktsegment)) v, c_mktsegment s "
                             "from customer group by from_hex(to_hex(c_mktsegment)), "
                             "c_mktsegment order by s"),
    # tests/test_spatial.py (its point tables)
    "st_distance_constants": ("mem", "select st_distance(st_point(0.0, 0.0), st_point(3.0, 4.0)) v"),
    "st_x_st_y": ("mem", "select st_x(st_point(ax, ay)) x, st_y(st_point(ax, ay)) y from pts_a "
                         "where aid < 10 order by aid"),
    **{f"spatial_join_count_{r}": ("mem", "select count(*) c from pts_a, pts_b where "
                                          "st_distance(st_point(ax, ay), st_point(qx, qy)) "
                                          f"<= {r}") for r in ("2.0", "5.0", "11.5")},
    "spatial_join_pairs": ("mem", "select aid, bid from pts_a, pts_b where "
                                  "st_distance(st_point(ax, ay), st_point(qx, qy)) <= 3.0 "
                                  "order by aid, bid"),
    "spatial_join_extra_conjuncts": ("mem", "select count(*) c from pts_a, pts_b where "
                                            "st_distance(st_point(ax, ay), st_point(qx, qy)) "
                                            "<= 5.0 and aid < 200 and bid >= 10"),
    "st_point_standalone": ("mem", "select st_point(1.0, 2.0) p from pts_a limit 1"),
    "spatial_degenerate_join": ("mem", "select count(*) c from pts_a a join pts_b b on 1 = 2 "
                                       "where st_distance(st_point(ax, ay), st_point(qx, qy)) "
                                       "<= 50.0"),
    "spatial_large_coordinates": ("mem", "select i, j from big_a, big_b where "
                                         "st_distance(st_point(big_a.x, big_a.y), "
                                         "st_point(big_b.x, big_b.y)) <= 1.0 order by i, j"),
    # tests/test_parametric_types.py (its tables pev and ch); the clock case
    # is test_clock_functions_are_timestamps
    "pev_literal_storage": ("mem", "select ts from pev order by id"),
    "pev_compare": ("mem", "select id from pev where ts > timestamp '2023-01-01 00:00:00'"),
    "pev_extract_parts": ("mem", "select extract(year from ts) y, extract(month from ts) mo, "
                                 "extract(day from ts) d, extract(hour from ts) h, "
                                 "extract(minute from ts) mi, extract(second from ts) se, "
                                 "hour(ts) h2, minute(ts) mi2, second(ts) se2, millisecond(ts) ms "
                                 "from pev order by id"),
    "pev_precision_casts": ("mem", "select cast(ts as timestamp(3)) t3, cast(ts3 as timestamp(6)) t6, "
                                   "cast(ts as timestamp(0)) t0 from pev order by id"),
    "pev_date_casts": ("mem", "select cast(ts as date) d, cast(date '2024-03-15' as timestamp(6)) t "
                              "from pev order by id"),
    "pev_order": ("mem", "select id from pev order by ts desc"),
    "char_casts": ("mem", "select cast(name as char(8)) c, cast(name as char(3)) c3 from pev "
                          "order by id"),
    "char_compare": ("mem", "select id from pev where cast(name as char(8)) = 'beta'"),
    "char_column": ("mem", "select v from ch where k = 'ab'"),
    "char_column_order": ("mem", "select k from ch order by v"),
    "finer_literal": ("mem", "select id from pev where ts3 = '2021-01-01 00:00:00.000500'"),
    "finer_literal_gt": ("mem", "select id from pev where ts3 > '2020-12-31 23:59:59.999999'"),
    "pev_interval": ("mem", "select ts + interval '2' hour a, ts - interval '90' second b "
                            "from pev order by id"),
    "pev_interval_bounds": ("mem", "select id from pev where ts > timestamp '2021-01-01 00:00:00' "
                                   "- interval '1' minute and ts < timestamp "
                                   "'2021-01-01 00:00:00' + interval '1' minute"),
    # the slice's F3 and F6 at SF0.01 (its aggregates are in test_torch_aggregates.py)
    "f3_date_keys": ("tpch", "select date_trunc('month', l_shipdate) m, quarter(l_shipdate) q, "
                             "day_of_week(l_shipdate) dw, count(*) c from lineitem "
                             "group by 1, 2, 3 order by 1, 3"),
    "f6_math": ("tpch", "select l_shipmode, max(round(sqrt(l_quantity), 3)) a, "
                        "max(greatest(l_tax, l_discount)) b, "
                        "count_if(bitwise_and(l_orderkey, 7) = 0) c, "
                        "max(width_bucket(l_extendedprice, 0, 100000, 10)) d "
                        "from lineitem group by l_shipmode order by 1"),
}

FUNCTION_SETUP = (
    "create table t (x double, n bigint, s varchar, d date)",
    "insert into t values (1.5, 5, 'http://example.com:8080/a/b?q=1&r=two#frag', "
    "date '2024-02-29'), (-2.25, 12, 'https://trino.io/docs', date '2021-01-01'), "
    "(0.5, 255, 'abc-123-xyz', date '2020-12-31'), (3.75, 128, 'x', date '1969-12-28'), "
    "(-0.5, 1, 'y', date '2027-01-03')",
    "create table tc (v varchar)",
    "insert into tc values ('12'), ('x'), ('3.5'), (''), ('  7 ')",
    "create table ev (ts timestamp(6), t3 timestamp(3))",
    "insert into ev values (timestamp '2024-03-15 10:30:45.123456', "
    "timestamp '2024-03-15 10:30:45.123'), (timestamp '1969-07-20 20:17:40.000001', "
    "timestamp '1969-12-31 23:59:59.999'), (null, null), "
    "(timestamp '2000-02-29 23:59:59.999999', timestamp '2000-02-29 23:59:59.9995')",
    # tests/test_functions_ext2.py's table
    "create table fx2 (x double, n bigint, s varchar, j varchar)",
    "insert into fx2 values (0.25, 1, 'hello', '[1, 2, 3]'), "
    "(0.5, 2, 'world', '{\"a\": {\"b\": 7}}'), (0.75, 3, 'MTIzNDU2', '\"scalar\"'), "
    "(0.9, 4, '79927398713', 'not json')",
    # tests/test_parametric_types.py's tables
    "create table pev (id bigint, ts timestamp(6), ts3 timestamp(3), name varchar)",
    "insert into pev values (1, timestamp '2024-03-15 10:30:45.123456', "
    "timestamp '2024-03-15 10:30:45.123', 'alpha'), (2, timestamp '2021-01-01 00:00:00', "
    "timestamp '2021-01-01 00:00:00', 'beta  '), (3, timestamp '1969-12-31 23:59:59', "
    "timestamp '1969-12-31 23:59:59', 'gamma')",
    "create table ch (k char(3), v bigint)",
    "insert into ch values ('ab', 1), ('xyz', 2)",
    # tests/test_spatial.py's tables: points from a seeded generator
    "create table pts_a (aid bigint, ax double, ay double)",
    "create table pts_b (bid bigint, qx double, qy double)",
    "insert into pts_a values " + ", ".join(
        f"({i}, {(i * 7919 % 10007) / 100.07:.6f}, {(i * 104729 % 10009) / 100.09:.6f})"
        for i in range(400)),
    "insert into pts_b values " + ", ".join(
        f"({i}, {(i * 6271 % 10007) / 100.07:.6f}, {(i * 3571 % 10009) / 100.09:.6f})"
        for i in range(300)),
    "create table big_a (i bigint, x double, y double)",
    "create table big_b (j bigint, x double, y double)",
    "insert into big_a values " + ", ".join(
        f"({i}, {4.0e6 + i * 0.4:.6f}, {4.0e6 - i * 0.3:.6f})" for i in range(60)),
    "insert into big_b values " + ", ".join(
        f"({j}, {4.0e6 + j * 0.4 + 0.05:.6f}, {4.0e6 - j * 0.3 + 0.05:.6f})"
        for j in range(60)),
)

_WIDE_ROWS = ", ".join(f"({i % 2}, {8_600_000_000_000_000 + i * 7}.25)" for i in range(40))

AGGREGATE_SETUP = (
    "create table t (g bigint, n bigint, x double, s varchar)",
    "insert into t values (1, 10, 1.5, 'a'), (1, 30, 0.5, 'b'), (1, 20, 2.5, 'c'), "
    "(2, 7, 9.0, 'd'), (2, 5, 8.0, 'd'), (3, null, 1.0, null)",
    "create table rk (p varchar, s varchar)",
    "insert into rk values ('pz', 'zebra'), ('pa', 'apple'), ('pm', 'mango')",
    "create table cg (g bigint, x double, b boolean)",
    "insert into cg values (1, 2.0, true), (1, 8.0, false), (2, 3.0, true), "
    "(2, 9.0, true), (2, 1.0, null)",
    "create table an (g bigint, x bigint, d decimal(10,2))",
    "insert into an values (1, null, null), (2, 5, 1.50)",
    "create table md (k bigint, v bigint, w bigint)",
    "insert into md values (1, 5, 7), (1, 5, 8), (null, 6, 9), (null, 7, 9)",
    "create table pn (k bigint, v double)",
    "insert into pn values (1, 10.0), (1, 20.0), (1, 30.0), (2, null), (2, null), (3, 5.0)",
    "create table la (k bigint, v varchar)",
    "insert into la values (1, 'b'), (1, null), (1, 'a'), (2, null)",
    "create table nt (a bigint, b bigint)",
    "insert into nt values (null, 3), (null, 1), (null, 2), (5, 0), (6, 0)",
    "create table z (g bigint, x double, y double, s varchar)",
    "insert into z values (1, -0.0, 1.0, 'p'), (1, 0.0, 2.0, 'q'), (1, 0.0, 3.0, 'r'), "
    "(2, 1.5, 1.0, 's'), (2, -2.5, 2.0, 't'), (2, 1.5, 3.0, 'u'), (null, 4.0, 1.0, 'v'), "
    "(null, 4.0, 2.0, 'w')",
    "create table big (g bigint, v decimal(18,2))",
    f"insert into big values {_WIDE_ROWS}",
    "create table w (k bigint, v decimal(38, 4))",
    "create table d (k bigint, name varchar)",
    "insert into w values (1, 123456789012345.6789), (1, 876543210987654.3211), "
    "(2, 500000000000000.5000), (2, 0.0001), (3, 899999999999999.9999)",
    "insert into d values (1, 'one'), (2, 'two'), (3, 'three')",
    "create table big38 (v decimal(38, 2))",
    "insert into big38 values " + ", ".join(["(92233720368547758.07)"] * 40),
    "create table p (a decimal(20, 2), b decimal(20, 2))",
    "insert into p values (100000.25, 3.50)",
    "create table o (v decimal(38, 10))",
)

# phase 9a and tests/test_torch_aggregates.py: the SQL of the reference's
# aggregate tests and F1-F7, (catalog, statement): "tpch" is TPC-H SF0.01,
# "tpchs" the same with splits of 2^13 rows, "mem" the tables of AGGREGATE_SETUP
AGGREGATE_CASES = {
    # tests/test_agg_functions.py
    "variance_global": ("tpch", "select var_pop(l_quantity), var_samp(l_quantity), "
                                "stddev_pop(l_quantity), stddev(l_quantity), "
                                "variance(l_quantity) from lineitem"),
    "variance_grouped": ("tpch", "select l_returnflag, var_pop(l_quantity) from lineitem "
                                 "group by l_returnflag order by l_returnflag"),
    "bool_and_or_global": ("tpch", "select bool_and(l_quantity > 0), "
                                   "bool_or(l_quantity > 4900), every(l_quantity > 2500) "
                                   "from lineitem"),
    "bool_and_or_direct": ("tpch", "select l_returnflag, bool_and(l_quantity > 10), "
                                   "bool_or(l_quantity > 49), arbitrary(l_linestatus) "
                                   "from lineitem group by 1 order by 1"),
    "bool_and_or_hash": ("mem", "select g, bool_and(x > 1), bool_or(x > 8.5), "
                                "bool_and(n > 4), arbitrary(n) from t group by g order by g"),
    "approx_distinct_global": ("tpch", "select approx_distinct(l_orderkey) from lineitem"),
    "approx_distinct_grouped": ("tpch", "select l_returnflag, approx_distinct(l_orderkey) "
                                        "from lineitem group by l_returnflag "
                                        "order by l_returnflag"),
    "arbitrary": ("tpch", "select arbitrary(l_orderkey), any_value(l_orderkey) "
                          "from lineitem where l_orderkey = 7"),
    "arbitrary_string_global": ("tpch", "select arbitrary(n_name) from nation "
                                        "where n_nationkey = 3"),
    "var_samp_single_row": ("tpch", "select var_samp(l_quantity) from lineitem "
                                    "where l_orderkey = 1 and l_linenumber = 1"),
    "count_if_geometric_mean": ("mem", "select g, count_if(b) ci, geometric_mean(x) gm "
                                       "from cg group by g order by g"),
    "having_count_if": ("mem", "select g from cg group by g having count_if(b) >= 2"),
    "sqrt_of_var_pop": ("mem", "select g, sqrt(var_pop(x)) sd from cg group by g order by g"),
    "all_null_groups": ("mem", "select g, sum(x) s, min(x) mn, max(x) mx, avg(x) a, "
                               "sum(d) sd from an group by g order by g"),
    "empty_global": ("mem", "select sum(x) s, min(x) mn, count(x) c from an where g = 99"),
    "count_if_empty": ("mem", "select count_if(x > 0) ci from an where g = 99"),
    "bool_and_empty": ("mem", "select bool_and(x > 0), bool_or(x > 0), arbitrary(x), "
                              "checksum(x) from an where g = 99"),
    "mixed_distinct": ("tpch", "select l_returnflag, count(*) n, count(distinct l_suppkey) ds, "
                               "count(distinct l_shipmode) dm, sum(l_quantity) q "
                               "from lineitem group by l_returnflag order by l_returnflag"),
    "mixed_distinct_global": ("tpch", "select count(*) n, count(distinct l_orderkey) o "
                                      "from lineitem"),
    "mixed_distinct_null_keys": ("mem", "select k, count(*) c, count(distinct v) dv, sum(w) sw "
                                        "from md group by k order by k"),
    # tests/test_agg_functions2.py
    "max_by_min_by": ("mem", "select g, max_by(s, n) mx, min_by(s, n) mn from t "
                             "group by g order by g"),
    "max_by_numeric_payload": ("mem", "select g, max_by(x, n) v from t group by g order by g"),
    "max_by_global": ("mem", "select max_by(s, n) v from t"),
    "checksum": ("mem", "select g, checksum(n) c from t group by g order by g"),
    "checksum_reordered": ("mem", "select g, checksum(n) c from (select * from t order by n desc) "
                                  "group by g order by g"),
    "checksum_global_mixed": ("mem", "select checksum(n) c, count(*) k, sum(n) s from t"),
    "checksum_strings_and_doubles": ("mem", "select g, checksum(s), checksum(x) from t "
                                            "group by g order by g"),
    "bitwise_aggs": ("mem", "select g, bitwise_and_agg(n) a, bitwise_or_agg(n) o, "
                            "bitwise_xor_agg(n) x from t group by g order by g"),
    "max_by_string_ranking": ("mem", "select max_by(p, s) mx, min_by(p, s) mn from rk"),
    "sorted_mix_hash": ("mem", "select g, max_by(s, n) mx, count(*) k, sum(n) t from t "
                               "group by g order by g"),
    "sorted_mix_global": ("mem", "select max_by(s, n) mx, count(*) k from t"),
    "sorted_all_filtered": ("mem", "select g, max_by(s, n) mx from t where n > 100 group by g"),
    "sorted_all_filtered_percentile": ("mem", "select g, approx_percentile(x, 0.5) p from t "
                                              "where n > 100 group by g"),
    "sorted_global_all_filtered": ("mem", "select max_by(s, n) mx from t where n > 100"),
    "mixed_sorted_distinct_rejected": ("mem", "select g, approx_distinct(n), max_by(s, n) "
                                              "from t group by g"),
    "arity_checksum": ("mem", "select checksum() from t"),
    "arity_histogram": ("mem", "select histogram() from t"),
    "arity_array_agg": ("mem", "select array_agg() from t"),
    "wilson_z_zero": ("mem", "select wilson_interval_lower(20, 100, 0) lo, "
                             "wilson_interval_upper(20, 100, 0) hi from t where n = 5"),
    "topn_null_ties": ("mem", "select a, b from nt order by a nulls first, b limit 3"),
    "nan_values_sorted": ("mem", "select g, approx_percentile(v, 0.5) p, max_by(s, v) mx, "
                                 "min_by(s, v) mn from (select g, s, if(n > 15, nan(), x) v "
                                 "from t) group by g order by g nulls last"),
    # NaN group keys: each NaN row is a group of its own, as in the reference
    # (ROADMAP C)
    "nan_keys_sorted": ("mem", "select k, max_by(n, n) m from (select if(n > 15, nan(), x) k, "
                               "n from t) group by k"),
    "zero_and_null_keys": ("mem", "select g, approx_percentile(x, 0.5) p, max_by(s, x) mx, "
                                  "min_by(s, x) mn, min_by(y, x) my from z group by g "
                                  "order by g nulls last"),
    # tests/test_percentile.py
    "global_percentiles": ("tpchs", "select approx_percentile(l_quantity, 0.5) p50, "
                                    "approx_percentile(l_quantity, 0.95) p95, "
                                    "approx_percentile(l_extendedprice, 0.99) p99 "
                                    "from lineitem"),
    "grouped_percentile": ("tpchs", "select l_returnflag, approx_percentile(l_extendedprice, "
                                    "0.5) med from lineitem group by l_returnflag "
                                    "order by l_returnflag"),
    "percentile_filter_join": ("tpch", "select o_orderpriority, approx_percentile(l_quantity, "
                                        "0.9) q90 from lineitem, orders "
                                        "where l_orderkey = o_orderkey "
                                        "and l_shipdate > date '1995-01-01' "
                                        "group by o_orderpriority order by o_orderpriority"),
    "percentile_nulls_empty_groups": ("mem", "select k, approx_percentile(v, 0.5) m from pn "
                                             "group by k order by k"),
    "percentile_mixes_hash": ("tpch", "select approx_percentile(l_quantity, 0.5) p, "
                                       "count(*) c from lineitem"),
    "listagg_grouped_ordered": ("tpch", "select r_name, listagg(n_name, ', ') within group "
                                         "(order by n_name) nations from nation, region "
                                         "where n_regionkey = r_regionkey group by r_name "
                                         "order by r_name"),
    "listagg_global_desc": ("tpch", "select listagg(r_name, '|') within group "
                                     "(order by r_name desc) x from region"),
    "listagg_null_values": ("mem", "select k, listagg(v, '+') within group (order by v) x "
                                   "from la group by k order by k"),
    # tests/test_decimal128.py (exact sums past 2^63)
    "wide_sum_global": ("mem", "select sum(v) s from big"),
    "wide_sum_group_by": ("mem", "select g, sum(v) s from big group by g order by g"),
    "wide_avg": ("mem", "select g, avg(v) a, count(*) c from big group by g order by g"),
    "wide_sum_small_values": ("tpch", "select l_returnflag, sum(l_quantity) q, "
                                       "sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) ch "
                                       "from lineitem group by l_returnflag "
                                       "order by l_returnflag"),
    "wide_sum_expression_raises": ("mem", "select sum(v) + 1 x from big"),
    "wide_sum_in_subquery": ("mem", "select s from (select g, sum(v) s from big group by g) "
                                    "order by g"),
    "wide_sum_union": ("mem", "select s from (select sum(v) s from big union all "
                              "select sum(v) s from big where g = 0)"),
    # tests/test_decimal38.py
    "decimal38_agg_join_sort": ("mem", "select name, sum(v) sv, min(v) mn, max(v) mx, "
                                       "count(*) c from w, d where w.k = d.k group by name "
                                       "order by sv desc"),
    "decimal38_sum_beyond_int64": ("mem", "select sum(v) from big38"),
    "decimal38_arithmetic": ("mem", "select a + b, a * b, a - b from p"),
    "decimal38_ingest_overflow": ("mem", "insert into o values (99999999999999999999999999.0)"),
    # the slice's queries, F1-F7 (chip_smoke.FUNCTIONS), at SF0.01
    **{f"f_{q}": ("tpchs" if q == "f1_percentiles" else "tpch", sql)
       for q, sql in FUNCTIONS.items()},
}

# phase 10a and tests/test_torch_arrays.py: the SQL of the reference's array,
# map and UNNEST tests (tests/test_arrays.py, test_arrays2.py,
# test_array_lambdas.py), of its array- and map-valued aggregates
# (test_agg_functions2.py, test_functions_stats.py) and of
# test_functions_ext2.py::test_split_family, with each file's table under a
# name of its own; setup statements are compared too
ARRAY_SETUP = (
    "create table ar (id bigint, tags array(varchar), nums array(bigint))",
    "insert into ar values (1, array['red', 'blue'], array[10, 20]), "
    "(2, array['blue'], array[30]), (3, null, array[])",
    "create table ia (id bigint, xs array(bigint), ss array(varchar))",
    "insert into ia values (1, array[1,2], array['a','b']), (2, array[], null)",
    "create table rt (id bigint, a array(bigint))",
    "insert into rt values (1, array[3,1,2]), (2, array[10]), (3, array[]), (4, null)",
    "create table a2 (a array(bigint), b array(bigint), sa array(varchar), n bigint)",
    "insert into a2 values (array[1,2,3], array[3,4], array['b','a','b'], 1), "
    "(array[5,6], array[7,8], array['z'], 2), (null, array[1], null, 3)",
    "create table lam (id bigint)",
    "insert into lam values (1), (2)",
    "create table ag (g bigint, n bigint, x double, s varchar)",
    "insert into ag values (1, 10, 1.5, 'a'), (1, 30, 0.5, 'b'), (1, 20, 2.5, 'c'), "
    "(2, 7, 9.0, 'd'), (2, 5, 8.0, 'd'), (3, null, 1.0, null)",
    "create table sp (s varchar, n bigint)",
    "insert into sp values ('a,b,c', 1), ('x', 2), ('k1=v1;k2=v2', 3)",
    # DELETE and UPDATE over a table with array columns: spans move, heaps stay
    "create table ad (id bigint, xs array(bigint), ws array(varchar))",
    "insert into ad values (1, array[1, 2], array['p']), (2, array[3], array['q', 'r']), "
    "(3, array[4, 5, 6], null), (4, array[], array['s'])",
    "delete from ad where id = 2",
    "update ad set id = id + 10 where id >= 3",
    "insert into ad values (5, array[7, 8, 9, 10], array['t', 'p'])",
    "create table mp (id bigint, m map(bigint, bigint))",
)
ARRAY_CASES = {
    # tests/test_arrays.py
    "literal_ops": ("mem", "select cardinality(array[1,2,3]) c, array[5,6,7][2] x, "
                           "contains(array[1,2,3], 2) a, contains(array[1,2,3], 9) b"),
    "literal_element_at_past_end": ("mem", "select element_at(array[1,2], 5) v"),
    "literal_element_at_string": ("mem", "select element_at(array['a','b','c'], 3) v"),
    "unnest_with_ordinality": ("mem", "select n, o from unnest(array[10,20,30]) "
                                      "with ordinality as t(n, o)"),
    "unnest_sequence_filtered": ("mem", "select n from unnest(sequence(1,5)) t(n) where n > 2"),
    "unnest_zipped_pads_null": ("mem", "select a, b from unnest(array[1,2,3], array[7,8]) "
                                       "t(a, b)"),
    "map_subscript": ("mem", "select map(array['x','y'], array[7,8])['y'] v, "
                             "cardinality(map(array[1,2], array[3,4])) c"),
    "map_missing_key": ("mem", "select element_at(map(array[1], array[9]), 5) v"),
    "map_keys_values": ("mem", "select cardinality(map_keys(map(array[1,2], array[3,4]))) k, "
                               "map_values(map(array['a'], array[42]))[1] v"),
    "row_field_access": ("mem", "select row(1, 'two', 3.5)[3] a, row(4, 5)[1] b"),
    "storage_scan": ("mem", "select id, tags, nums from ar order by id"),
    "storage_lateral_unnest": ("mem", "select t.id, u.tag from ar t cross join unnest(t.tags) "
                                      "u(tag) order by id, tag"),
    "storage_unnest_aggregate": ("mem", "select sum(n) sn, count(*) c from ar "
                                        "cross join unnest(nums) u(n)"),
    "storage_cardinality": ("mem", "select id, cardinality(nums) c from ar order by id"),
    "unnest_cross_join_region": ("tpch", "select r_name, n from region cross join "
                                         "unnest(sequence(1,3)) u(n) where n <= 2 "
                                         "order by r_name, n"),
    "unnest_group_by": ("tpch", "select n % 2 k, count(*) c from unnest(sequence(1,10)) t(n) "
                                "group by n % 2 order by k"),
    "insert_array_literals": ("mem", "select id, xs, ss from ia order by id"),
    "sequence_step_zero": ("tpch", "select n from unnest(sequence(1,5,0)) t(n)"),
    "reductions_and_position": ("mem", "select id, array_min(a) mn, array_max(a) mx, "
                                       "array_sum(a) sm, array_average(a) av, "
                                       "array_position(a, 2) p from rt order by id"),
    "reduction_filter": ("mem", "select id from rt where array_sum(a) > 7"),
    # element calls and lambdas over stored arrays, and after DELETE/UPDATE
    "storage_element_calls": ("mem", "select id, contains(tags, 'blue') c, element_at(nums, 2) e, "
                                     "array_position(nums, 20) p, nums[1] f, "
                                     "array_max(nums) m from ar order by id"),
    "storage_lambdas": ("mem", "select id, transform(nums, x -> x + 1) t, "
                               "filter(nums, x -> x > 10) f, "
                               "reduce(nums, 0, (s, x) -> s + x) r from ar order by id"),
    "storage_after_dml": ("mem", "select id, xs, ws, cardinality(xs) c from ad order by id"),
    "storage_unnest_after_dml": ("mem", "select id, x, o from ad cross join unnest(xs) "
                                        "with ordinality u(x, o) order by id, o"),
    "storage_unnest_zipped": ("mem", "select id, x, w from ad cross join unnest(xs, ws) u(x, w)"),
    # tests/test_arrays2.py
    "arrays_overlap": ("mem", "select n, arrays_overlap(a, b) o from a2 order by n"),
    "slice": ("mem", "select n, slice(a, 2, 2) s, slice(a, -2, 2) s2 from a2 order by n"),
    "slice_zero_start": ("mem", "select slice(a, 0, 1) s from a2 where n = 1"),
    "trim_array": ("mem", "select n, trim_array(a, 1) tr from a2 order by n"),
    "trim_array_past_length": ("mem", "select trim_array(a, 9) tr from a2 where n = 1"),
    "array_remove": ("mem", "select array_remove(a, 3) x from a2 order by n"),
    "array_remove_string": ("mem", "select array_remove(sa, 'b') x from a2 where n = 1"),
    "distinct_sort_repeat": ("mem", "select array_distinct(array[3,1,3,2,1]) d, "
                                    "array_sort(array[3,1,2]) s, "
                                    "array_sort(array['b','a','c']) ss, "
                                    "repeat(7, 3) rp from a2 where n = 1"),
    "slice_negative_start_past_head": ("mem", "select slice(a, -5, 2) s from a2 where n = 1"),
    "array_remove_null": ("mem", "select array_remove(a, null) x from a2 where n = 1"),
    "composition_with_lambdas": ("mem", "select cardinality(filter(slice(a, 1, 3), "
                                        "x -> x > 1)) c from a2 where n = 1"),
    "map_lambdas": ("mem", "select transform_values(map(array[1,2,3], array[10,20,30]), "
                           "(k, v) -> v * k) tv, transform_keys(map(array[1,2], array[10,20]), "
                           "(k, v) -> k + 100) tk, map_filter(map(array[1,2,3], "
                           "array[10,20,30]), (k, v) -> v > 15) mf from a2 where n = 1"),
    # tests/test_array_lambdas.py (each test's expressions as one statement)
    "lambda_transform": ("mem", "select transform(array[1,2,3], x -> x * 2 + 1) v, "
                                "transform(array[1.5, 2.5], x -> x * 2) w from lam where id = 1"),
    "lambda_filter": ("mem", "select filter(array[5,-2,7,0], x -> x > 0) v, "
                             "filter(array[1,2,3], x -> x > 9) w, "
                             "cardinality(filter(array[5,-2,7,0], x -> x >= 5)) c "
                             "from lam where id = 1"),
    "lambda_matches": ("mem", "select any_match(array[1,2,3], x -> x > 2) a, "
                              "any_match(array[1,2,3], x -> x > 9) b, "
                              "all_match(array[1,2,3], x -> x > 0) c, "
                              "all_match(array[1,2,3], x -> x > 1) d, "
                              "none_match(array[1,2,3], x -> x > 9) e, "
                              "none_match(array[1,2,3], x -> x = 2) f from lam where id = 1"),
    "lambda_compose": ("mem", "select transform(filter(array[1,2,3,4], x -> x % 2 = 0), "
                              "y -> y * 10) v, array_sum(transform(array[1,2,3], x -> x * x)) w "
                              "from lam where id = 1"),
    "lambda_two_params_rejected": ("mem", "select transform(array[1], (a, b) -> a + b) v "
                                          "from lam where id = 1"),
    # tests/test_functions_stats.py::test_reduce_family
    "reduce_sum": ("tpch", "select reduce(array[1, 2, 3, 4, 5], 0, (s, x) -> s + x) v"),
    "reduce_max": ("tpch", "select reduce(array[3, 1, 4, 1, 5], -1, (s, x) -> if(x > s, x, s)) v"),
    "reduce_finalizer": ("tpch", "select reduce(array[2, 3], 1, (s, x) -> s * x, "
                                 "s -> s + 100) v"),
    "reduce_empty": ("tpch", "select reduce(filter(array[1], x -> x > 9), 42, "
                             "(s, x) -> s + x) v"),
    # tests/test_functions_ext2.py::test_split_family
    "split": ("mem", "select n, split(s, ',') v from sp order by n"),
    "split_subscript": ("mem", "select split(s, ',')[2] v, cardinality(split(s, ',')) c "
                               "from sp where n = 1"),
    "split_limit": ("mem", "select split('a,b,c,d', ',', 2) v from sp where n = 1"),
    "split_to_map": ("mem", "select split_to_map(s, ';', '=') m from sp where n = 3"),
    # tests/test_agg_functions2.py
    "array_agg": ("mem", "select g, array_agg(n) a from ag group by g order by g"),
    "array_agg_strings": ("mem", "select g, array_agg(s) a from ag group by g order by g"),
    "histogram": ("mem", "select g, histogram(s) h from ag group by g order by g"),
    "map_agg": ("mem", "select g, map_agg(s, n) m from ag group by g order by g"),
    "array_agg_global_and_cardinality": ("mem", "select array_agg(x) a, map_agg(n, x) m, "
                                                "histogram(g) h from ag"),
    "array_agg_empty_input": ("mem", "select array_agg(n) a from ag where g > 9"),
    "map_agg_over_tpch": ("tpchs", "select o_custkey, array_agg(o_orderkey) a, "
                                   "map_agg(o_orderkey, o_totalprice) m from orders "
                                   "where o_custkey < 40 group by 1 order by 1"),
    "histogram_over_tpch": ("tpchs", "select l_returnflag, histogram(l_shipmode) h "
                                     "from lineitem group by 1 order by 1"),
    # tests/test_functions_stats.py::test_approx_most_frequent
    "approx_most_frequent": ("tpch", "select l_returnflag, approx_most_frequent(3, l_linenumber, "
                                     "100) m from lineitem group by l_returnflag "
                                     "order by l_returnflag"),
    "approx_most_frequent_strings": ("tpch", "select approx_most_frequent(2, o_orderpriority, 10) "
                                             "m from orders"),
    "approx_most_frequent_zero_buckets": ("tpch", "select approx_most_frequent(0, l_linenumber, 9) "
                                                  "from lineitem"),
    # the reference's gaps, which both packages refuse
    "ctas_of_array_query": ("mem", "create table arc as select id, nums from ar"),
    "element_call_over_array_agg": ("mem", "select element_at(array_agg(id), 1) from ar"),
    "unnest_of_array_agg": ("mem", "select x from (select array_agg(id) a from ar) "
                                   "cross join unnest(a) t(x)"),
    "cardinality_of_array_agg_in_its_select": ("mem", "select cardinality(array_agg(id)) "
                                                      "from ar"),
    "insert_of_a_map_value": ("mem", "insert into mp values (1, map(array[1], array[2]))"),
    "update_of_an_array_column": ("mem", "update ad set xs = array[5] where id = 1"),
}


def _tick_rows() -> str:
    """tests/test_match_recognize.py's random walk: 4 series of 200 ticks."""
    import numpy as np

    rng = np.random.default_rng(7)
    rows = []
    for g in range(4):
        price = 100
        for i in range(200):
            price += int(rng.integers(-8, 9))
            rows.append(f"({g}, {i}, {price})")
    return "insert into ticks values " + ", ".join(rows)


# phase 10a and tests/test_torch_match.py: the SQL of
# tests/test_match_recognize.py, and the A6/A7 shapes over TPC-H SF0.01
MATCH_SETUP = (
    "create table px (sym varchar, d bigint, price double)",
    "insert into px values ('a',1,10),('a',2,8),('a',3,7),('a',4,9),('a',5,12),('a',6,11),"
    "('b',1,5),('b',2,6),('b',3,4),('b',4,3),('b',5,8)",
    "create table ticks (g bigint, t bigint, price bigint)",
    _tick_rows(),
)
V_SHAPE_TICKS = """select * from ticks match_recognize (
  partition by g order by t
  measures first(down.price) as top, last(down.price) as bottom, last(up.price) as rebound
  pattern (down+ up+)
  define down as price < prev(price), up as price > prev(price)
) order by 1, 2"""
MATCH_CASES = {
    "v_shape": ("mem", """select * from px match_recognize (
  partition by sym order by d
  measures first(a.price) as start_price, last(b.price) as bottom_price,
           last(c.price) as end_price
  one row per match after match skip past last row
  pattern (a b+ c+)
  define b as price < prev(price), c as price > prev(price)
) as m order by sym"""),
    "decreasing_runs": ("mem", """select * from px match_recognize (
  partition by sym order by d
  measures first(s.price) as top, last(d.price) as low
  pattern (s d+)
  define d as price < prev(price)
) as m order by sym, top"""),
    "optional_tail": ("mem", """select * from px match_recognize (
  order by sym, d
  measures first(r.price) as p0, last(r.price) as p1
  pattern (r r?)
  define r as true
) as m"""),
    "unmatched_optional_is_null": ("mem", """select * from px match_recognize (
  partition by sym order by d
  measures last(z.price) as spike
  pattern (s z?)
  define z as price > 100
) as m order by sym"""),
    "next_navigation": ("mem", """select * from px match_recognize (
  partition by sym order by d
  measures first(t.d) as at_day
  pattern (t)
  define t as price < next(price)
) as m order by sym, at_day"""),
    "alternation_group": ("mem", """select * from px match_recognize (
  partition by sym order by d
  measures first(m.price) as st, last(u.price) as lastup, last(dn.price) as lastdn
  pattern (m (u|dn)+)
  define u as price > prev(price), dn as price < prev(price)
) as x order by sym"""),
    "all_rows_per_match": ("mem", """select sym, d, price, low from px match_recognize (
  partition by sym order by d
  measures last(dn.price) as low
  all rows per match
  pattern (st dn+)
  define dn as price < prev(price)
) as x order by sym, d"""),
    "alternation_all_rows": ("mem", """select sym, d, price from px match_recognize (
  partition by sym order by d
  measures first(m.price) as st
  all rows per match
  pattern (m (u|dn)+)
  define u as price > prev(price), dn as price < prev(price)
) as x order by sym, d"""),
    "v_shape_random_ticks": ("mem", V_SHAPE_TICKS),
    "classifier_measure_refused": ("mem", """select * from px match_recognize (
  partition by sym order by d
  measures classifier() as cl
  pattern (a b+)
  define b as price < prev(price)
)"""),
    # A6 and A7 at SF0.01
    "orders_v_shape": ("tpch", "select * from orders match_recognize (partition by o_custkey "
                               "order by o_orderdate, o_orderkey measures "
                               "first(b.o_totalprice) as top, last(b.o_totalprice) as bottom, "
                               "last(c.o_totalprice) as rebound one row per match "
                               "pattern (b+ c+) define b as o_totalprice < prev(o_totalprice), "
                               "c as o_totalprice > prev(o_totalprice))"),
    "orders_all_rows": ("tpch", "select o_custkey, o_orderkey, low from orders match_recognize ("
                                "partition by o_custkey order by o_orderdate, o_orderkey "
                                "measures last(b.o_totalprice) as low all rows per match "
                                "pattern (b+ c+) define b as o_totalprice < prev(o_totalprice), "
                                "c as o_totalprice > prev(o_totalprice))"),
}

# phase 9: the kernels each query must launch, those the JAX reference
# reaches over the same queries (a call recording of trino_tpu at SF0.1: the
# table that ``scripts/record_function_kernels.py`` prints); F1's count(*)
# beside its percentiles is planned as a join of two aggregations on the
# group keys, and F3 and F4 group by computed keys, which have no column
# range; queries not named here reach none of them
FUNCTIONS_REQUIRED = {
    "f1_percentiles": ('hash_insert', 'hash_probe'),
    "f3_date_keys": ('hash_insert',),
    "f4_checksum_buckets": ('hash_insert',),
}
# phase 10: arrays, maps, UNNEST and MATCH_RECOGNIZE over the nested TPC-H
# orders table (``orders_nested`` in the memory catalog: one row per order,
# its line items as arrays in l_linenumber order, as nested Parquet and ORC
# tables hold them; built by ``nested_orders``) and TPC-H's orders and
# lineitem; the session catalog is ``memory``
ARRAYS = {
    # every line item back out of its order, zipped with its ordinal
    "a1_unnest_zip": "select count(*) n, sum(p) sp, sum(s) ss, sum(o) so, count_if(o > 4) late "
                     "from orders_nested cross join unnest(partkeys, suppkeys) "
                     "with ordinality u(p, s, o)",
    # a hash group-by over an unnested element, after a filter on the ordinal
    "a2_unnest_group_by": "select p % 100000 b, count(*) c, sum(o) so from orders_nested "
                          "cross join unnest(partkeys) with ordinality u(p, o) "
                          "where o <= 3 group by 1 order by 1",
    # element calls over every row
    "a3_element_calls": "select count(*) n, sum(cardinality(partkeys)) items, "
                        "sum(element_at(partkeys, 1)) first_part, "
                        "count_if(contains(shipmodes, 'AIR')) by_air, "
                        "sum(array_position(suppkeys, element_at(suppkeys, 2))) pos, "
                        "sum(array_sum(partkeys)) part_sum, max(array_max(suppkeys)) top_supp, "
                        "sum(cardinality(slice(partkeys, 2, 3))) sliced, "
                        "count_if(arrays_overlap(partkeys, suppkeys)) overlap "
                        "from orders_nested",
    # the lambdas: transform, filter, reduce
    "a4_lambdas": "select sum(reduce(partkeys, 0, (s, x) -> s + x)) folded, "
                  "sum(cardinality(filter(partkeys, x -> x % 2 = 0))) even_parts, "
                  "sum(array_sum(transform(suppkeys, x -> x * 2))) doubled "
                  "from orders_nested",
    # array- and map-valued aggregates, reduced at the surface
    "a5_array_map_agg": "select count(*) customers, sum(cardinality(a)) orders_n, "
                        "sum(cardinality(m)) keys_n from (select o_custkey, "
                        "array_agg(o_orderkey) a, map_agg(o_orderkey, o_totalprice) m "
                        "from tpch.orders group by o_custkey)",
    "a5_histogram": "select l_returnflag, histogram(l_shipmode) h, "
                    "approx_most_frequent(3, l_shipinstruct, 10) f from tpch.lineitem "
                    "group by 1 order by 1",
    # V-shaped price runs per customer, ONE ROW PER MATCH
    "a6_match_recognize": "select * from tpch.orders match_recognize (partition by o_custkey "
                          "order by o_orderdate, o_orderkey measures "
                          "first(b.o_orderkey) as start_key, first(b.o_totalprice) as top, "
                          "last(b.o_totalprice) as bottom, last(c.o_totalprice) as rebound "
                          "one row per match pattern (b+ c+) "
                          "define b as o_totalprice < prev(o_totalprice), "
                          "c as o_totalprice > prev(o_totalprice)) order by start_key",
}
# A7: the same pattern with ALL ROWS PER MATCH (the host backtracker), at
# ARRAYS_SF_ALL_ROWS
ARRAYS_ALL_ROWS = {
    "a7_all_rows": "select o_custkey, o_orderkey, o_totalprice, low from tpch.orders "
                   "match_recognize (partition by o_custkey order by o_orderdate, o_orderkey "
                   "measures last(b.o_totalprice) as low all rows per match "
                   "pattern (b+ c+) define b as o_totalprice < prev(o_totalprice), "
                   "c as o_totalprice > prev(o_totalprice)) order by o_orderkey",
}
ARRAYS_SF_ALL_ROWS = 0.1
# phase 10: the kernels each statement must launch, those the JAX reference
# reaches over the same statements (a call recording of trino_tpu at SF0.1:
# the table that ``scripts/record_array_kernels.py`` prints); A2 groups by a
# computed key, which has no column range; statements not named here reach
# none of them in the reference (the port's UNNEST filters and nested
# aggregates also pack rows through ``compact_rows``)
ARRAYS_REQUIRED = {
    "a2_unnest_group_by": ('hash_insert',),
}
# A1's oracle over tpch.lineitem: the ordinal is l_linenumber
A1_ORACLE = ("select count(*) n, sum(l_partkey) sp, sum(l_suppkey) ss, sum(l_linenumber) so, "
             "count_if(l_linenumber > 4) late from tpch.lineitem")
# phase 9c: 60M lineitem rows on the card alone, held by oracles that need no
# CPU run
FUNCTIONS_BIG = ("f1_percentiles", "f3_date_keys", "f5_wide_sums")
FUNCTIONS_SF_PARITY = 0.01  # the parity corpora's scale, as the CPU tests run them
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
                  "host_bytes": reads.get("host_bytes"),
                  "h2d_bytes": reads.get("h2d_bytes"), "peak_bytes": peak,
                  "rows_per_s": conn_rows / min(warm)}
        print(f"{label} {q}: rows={len(res)} cold_s={cold} warm_s={min(warm)} "
              f"launches={ {k: v for k, v in launches.items() if v} } "
              f"host_reads={reads.get('host_reads')} h2d_bytes={reads.get('h2d_bytes')} "
              f"peak_bytes={peak} {fact}_rows_per_s={conn_rows / min(warm)}", flush=True)
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

    def ops(body, attempt=0):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            # the trace loses the device operations at the start of its
            # window: the first one, and up to five of twenty 0.9 ms insert
            # launches at the TPC-DS path's largest shape (an H100, this
            # script's own profile, ~5 ms of device time): let those be
            # throwaway spins of ~1 ms each, left out below, twice as many
            # on each profile of a window again
            for _ in range(16 << attempt):
                torch.cuda._sleep(2_000_000)
            for _ in range(reps):
                body()
            torch.cuda.synchronize()
        return [e for e in device_events(prof) if "spin_kernel" not in e.name]

    def call():
        if setup is not None:
            setup()
        fn()

    def complete(events):
        """Whether the window holds device operations and each kind occurs a
        whole multiple of reps times: every call makes the same launches."""
        seen: dict = {}
        for e in events:
            seen[e.name] = seen.get(e.name, 0) + 1
        return bool(seen) and all(c % reps == 0 for c in seen.values())

    # a window with a count that is no whole multiple of reps lost records
    # (16 of 20 at the memory path's 0.034 ms insert in one run of this
    # script on an H100; in two runs of phase 9, 1 of 20 table fills of the
    # setup in the call's window and 2 of 20 in the setup's own, which read
    # as fills the call made or did not make; in a third, the setup's whole
    # window): profile the window again, up
    # to three times, and keep every window's count of the port's kernels
    # (``profile_counts``) and of the setup's operations
    # (``setup_profile_counts``), so that each run shows how often a window
    # loses records, and where
    counts_seen = []
    for attempt in range(3):
        got = ops(call, attempt)
        kern = [e for e in got if is_port_kernel(e.name, names)]
        counts_seen.append(len(kern))
        if kern and complete(got):
            break
    setup_ops, setup_counts = [], []
    for attempt in range(3 if setup is not None else 0):
        setup_ops = ops(setup, attempt)
        setup_counts.append(len(setup_ops))
        if complete(setup_ops):
            break
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
            "setup_profile_counts": setup_counts,
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
                  f"profiled={split['profile_counts']} "
                  f"setup_profiled={split.get('setup_profile_counts')}", flush=True)
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


def ordered_sql(sql: str) -> bool:
    """Whether a statement's outermost query orders its rows."""
    import re

    return re.search(r"order\s+by[^()]*$", sql.strip(), re.I) is not None


def rows_sorted(res):
    """(names, types, raw columns, row count) of a result with its rows in one
    canonical order, for statements that do not order their rows: by the
    non-DOUBLE columns, then the DOUBLE ones."""
    import numpy as np

    raw = [np.asarray(c) for c in res.raw_columns]
    flt = [t.is_floating for t in res.types]

    def key(i):
        return tuple(repr(c[i]) for c, f in zip(raw, flt) if not f) + tuple(
            float(c[i]) for c, f in zip(raw, flt) if f)

    order = np.array(sorted(range(len(res)), key=key), dtype=np.int64)
    return res.names, res.types, [c[order] for c in raw], len(res)


def same_outcome(card, cpu, sql, card_sess, cpu_sess, what):
    """One statement on the card and on the CPU: the same error, or equal
    results (rows compared in order only where the statement orders them)."""
    outs = []
    for e, sess in ((card, card_sess), (cpu, cpu_sess)):
        try:
            outs.append(("ok", e.execute_sql(sql, sess)))
        except Exception as ex:  # noqa: BLE001 - both sides' errors are compared
            outs.append(("error", ex))
    (kc, a), (kp, b) = outs
    check(kc == kp, f"{what}: the card gave {a!r}, the CPU {b!r}")
    if kc == "error":
        check(type(a) is type(b) and str(a) == str(b), f"{what}: errors differ: {a!r} {b!r}")
        return
    if a is None or b is None:
        check(a is None and b is None, f"{what}: one side returned no result")
        return
    same_outcome_result(a, b, sql, what)


def same_nested(a, b, what, ordered):
    """Array and map columns as their decoded lists and dicts (as a multiset
    of values where the statement does not order its rows)."""
    for name, t, da, db in zip(a.names, a.types, a.columns, b.columns):
        if type(t).__name__ not in ("ArrayType", "MapType"):
            continue
        ra, rb = [repr(x) for x in list(da)], [repr(x) for x in list(db)]
        check(ra == rb if ordered else sorted(ra) == sorted(rb),
              f"{what}: column {name} differs as decoded values")


def same_outcome_result(a, b, sql, what):
    """Two results of one statement equal: in row order where it orders its
    rows, else as sorted rows."""
    same_nested(a, b, what, ordered_sql(sql))
    if not ordered_sql(sql):
        import numpy as np

        (names, types, ra, na), (_, _, rb, nb) = rows_sorted(a), rows_sorted(b)
        check(tuple(a.names) == tuple(b.names) and na == nb,
              f"{what}: {na} rows vs {nb}, or the names differ")
        for name, t, ca, cb in zip(names, types, ra, rb):
            ok = np.allclose(ca.astype(np.float64), cb.astype(np.float64), rtol=1e-9, atol=0.0,
                             equal_nan=True) if t.is_floating else bool((ca == cb).all())
            check(ok, f"{what}: column {name} differs")
        return
    same_result(a, b, what)


def corpus_engines(device, setup):
    """An engine over TPC-H at FUNCTIONS_SF_PARITY (``tpch``; ``tpchs`` with
    splits of 2^13 rows) and a memory catalog holding ``setup``'s tables."""
    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.connectors.tpch import TpchConnector

    e = Engine(device=device)
    e.register_catalog("tpch", TpchConnector(sf=FUNCTIONS_SF_PARITY))
    e.register_catalog("tpchs", TpchConnector(sf=FUNCTIONS_SF_PARITY, split_rows=1 << 13))
    e.register_catalog("mem", MemoryConnector())
    sessions = {c: e.create_session(c) for c in ("tpch", "tpchs", "mem")}
    for sql in setup:
        e.execute_sql(sql, sessions["mem"])
    return e, sessions


def functions_parity():
    """Phase 9a: the statements of tests/test_torch_functions.py and
    tests/test_torch_aggregates.py on the card and on the CPU, equal."""
    t0 = time.perf_counter()
    n = 0
    for label, cases, setup in (("functions", FUNCTION_CASES, FUNCTION_SETUP),
                                ("aggregates", AGGREGATE_CASES, AGGREGATE_SETUP)):
        card, card_s = corpus_engines(DEVICE, setup)
        cpu, cpu_s = corpus_engines("cpu", setup)
        for case, (catalog, sql) in cases.items():
            same_outcome(card, cpu, sql, card_s[catalog], cpu_s[catalog],
                         f"{label} {case} card vs CPU")
            n += 1
        del card, cpu
    print(f"functions parity: {n} statements on the card equal the port's CPU outcomes "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


def functions_keys(conn):
    """Phase 9's own insert keys: F4's ``l_orderkey % 1024`` over the first
    lineitem split, packed as a one-key hash group-by packs it."""
    from trino_tpu_torch.ops.hashing import pack_keys
    from trino_tpu_torch.types import BIGINT

    page = conn.generate(conn.splits("lineitem")[0], ["l_orderkey"])
    packed, _ = pack_keys((page.columns[0] % 1024,), (BIGINT,))
    return packed, page.valid_mask()


def functions_main(tpch):
    """Phase 9b: F1-F7 at SF1 on the card (cold, warm, launches, host reads,
    peak memory); FUNCTIONS_REQUIRED; each kernel the path launched against
    its plain version at the path's shapes; then each query held against
    the port's CPU run.  Returns (launches of the run, {kernel: checks})."""
    import numpy as np

    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.ops import cuda_kernels as ck

    card = Engine(device=DEVICE)
    card.register_catalog("tpch", tpch)
    ck.reset_stats()
    got = run_queries(card, FUNCTIONS, tpch.exact_row_count("lineitem"),
                      f"functions sf{SF_MAIN:g}")
    launches = {k: s.launches for k, s in ck.STATS.items()}
    shapes = {k: list(s.shapes) for k, s in ck.STATS.items()}
    for q, kernels in FUNCTIONS_REQUIRED.items():
        for k in kernels:
            check(got[q]["launches"][k] > 0, f"functions {q} launched no {k} kernel")
    gen = np.random.default_rng(17)
    checks = {"hash_insert": insert_checks(
        shapes["hash_insert"], ("lineitem_orderkey_mod_1024", *functions_keys(tpch)), gen)}
    if shapes["hash_probe"]:
        checks["hash_probe"] = probe_checks(shapes["hash_probe"], gen)
    if shapes["compact_rows"]:
        checks["compact_rows"] = compact_checks(shapes["compact_rows"], gen)
    cpu = Engine(device="cpu")
    cpu.register_catalog("tpch", TpchConnector(sf=SF_MAIN, split_rows=SPLIT_ROWS))
    t0 = time.perf_counter()
    for q, sql in FUNCTIONS.items():
        t1 = time.perf_counter()
        ref = cpu.execute_sql(sql, cpu.create_session("tpch"))
        same_result(got[q]["result"], ref, f"functions sf{SF_MAIN:g} {q} card vs CPU")
        check(len(ref) > 0, f"functions {q} returned no rows")
        print(f"functions sf{SF_MAIN:g} {q}: equal to the port's CPU result ({len(ref)} "
              f"rows, CPU {time.perf_counter() - t1:.2f} s)", flush=True)
    print(f"functions CPU pass: {time.perf_counter() - t0:.1f} s", flush=True)
    del cpu
    return launches, {k: {"max_abs_err": r["max_abs_err"], "shapes": r["shapes"]}
                      for k, r in checks.items()}


def decimal_text(raw: int, scale: int) -> str:
    """A non-negative scaled decimal as an exact SQL literal."""
    return f"{raw // 10 ** scale}.{raw % 10 ** scale:0{scale}d}"


def functions_big():
    """Phase 9c: F1, F3 and F5 at SF10 on the card alone, held by oracles
    that need no CPU run: F5's sums are sum(l_extendedprice) * 10^10 of the
    same groups, exactly; F1's and F3's counts are those of plain group-bys
    (F3's summed on the host from a group-by over l_shipdate); each of F1's
    medians sits at its rank, count_if(v < p50) <= round(0.5 (c - 1)) <
    count_if(v <= p50)."""
    import numpy as np
    import torch

    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector

    big = TpchConnector(sf=SF_BIG, split_rows=SPLIT_ROWS)
    card = Engine(device=DEVICE)
    card.register_catalog("tpch", big)
    sess = card.create_session("tpch")
    got = run_queries(card, {q: FUNCTIONS[q] for q in FUNCTIONS_BIG},
                      big.exact_row_count("lineitem"), f"functions sf{SF_BIG:g}")
    plain = card.execute_sql("select l_returnflag, l_linestatus, count(*), "
                             "sum(l_extendedprice) from lineitem group by 1, 2 order by 1, 2",
                             sess)
    keys = list(zip(*[list(c) for c in plain.columns[:2]]))
    counts = [int(c) for c in plain.raw_columns[2]]
    sums = [int(v) for v in plain.raw_columns[3]]
    f5 = got["f5_wide_sums"]["result"]
    check(list(zip(*[list(c) for c in f5.columns[:2]])) == keys, "F5's groups differ")
    check([int(v) for v in f5.raw_columns[2]] == [v * 10 ** 10 for v in sums],
          "F5's exact sums are not sum(l_extendedprice) * 10^10")
    f1 = got["f1_percentiles"]["result"]
    check(list(zip(*[list(c) for c in f1.columns[:2]])) == keys, "F1's groups differ")
    check([int(c) for c in f1.raw_columns[4]] == counts, "F1's counts differ")
    p50 = [int(v) for v in f1.raw_columns[2]]
    terms = []
    for (rf, ls), p in zip(keys, p50):
        cond = f"l_returnflag = '{rf}' and l_linestatus = '{ls}' and l_extendedprice"
        terms += [f"count_if({cond} < {decimal_text(p, 2)})",
                  f"count_if({cond} <= {decimal_text(p, 2)})"]
    ranks = card.execute_sql(f"select {', '.join(terms)} from lineitem", sess).rows()[0]
    for i, c in enumerate(counts):
        lo, hi, k = int(ranks[2 * i]), int(ranks[2 * i + 1]), round(0.5 * (c - 1))
        check(lo <= k < hi, f"F1's p50 of {keys[i]} is not at rank {k}: {lo}, {hi}")
    by_day = card.execute_sql("select l_shipdate, count(*) from lineitem group by 1", sess)
    days = np.asarray(by_day.raw_columns[0]).astype(np.int64)
    month = days.astype("datetime64[D]").astype("datetime64[M]")
    m = month.astype("datetime64[D]").astype(np.int64)
    q = month.astype(np.int64) % 12 // 3 + 1
    dw = (days + 3) % 7 + 1
    want: dict = {}
    for key, c in zip(zip(m.tolist(), q.tolist(), dw.tolist()), by_day.raw_columns[1].tolist()):
        want[key] = want.get(key, 0) + int(c)
    f3 = got["f3_date_keys"]["result"]
    have = {(int(a), int(b), int(c)): int(n) for a, b, c, n in zip(*f3.raw_columns[:4])}
    check(have == want, "F3's counts differ from the group-by over l_shipdate")
    print(f"functions sf{SF_BIG:g}: F5's {len(sums)} exact sums, F1's counts and medians' "
          f"ranks and F3's {len(have)} group counts hold; peak device memory "
          f"{max(r['peak_bytes'] for r in got.values()) / 2**30:.2f} GiB", flush=True)
    del card, big
    torch.cuda.empty_cache()


def functions_path():
    """Phase 9: the function library's path.  Returns (launches of 9b,
    {kernel: checks at its shapes})."""
    from trino_tpu_torch.connectors.tpch import TpchConnector

    t0 = time.perf_counter()
    functions_parity()
    launches, checks = functions_main(TpchConnector(sf=SF_MAIN, split_rows=SPLIT_ROWS))
    functions_big()
    print(f"functions path: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, checks


def nested_orders(orders, lineitem):
    """The columns of ``orders_nested`` as python values for
    ``MemoryConnector.append``: ``orders`` = (o_orderkey, o_custkey,
    o_orderdate as epoch days), ``lineitem`` = (l_orderkey, l_linenumber,
    l_partkey, l_suppkey, l_shipmode as strings), numpy arrays; each order's
    line items become lists in l_linenumber order."""
    import numpy as np

    ok, ock, od = (np.asarray(c) for c in orders)
    lk, ln, lp, ls, lm = (np.asarray(c) for c in lineitem)
    order = np.lexsort((ln, lk))
    lk = lk[order]
    oo = np.argsort(ok, kind="stable")
    ok, ock, od = ok[oo], ock[oo], od[oo]
    starts = np.searchsorted(lk, ok, side="left").tolist()
    ends = np.searchsorted(lk, ok, side="right").tolist()

    def lists(col):
        flat = np.asarray(col)[order].tolist()
        return [flat[a:b] for a, b in zip(starts, ends)]

    return [ok.tolist(), ock.tolist(), od.tolist(), lists(lp), lists(ls), lists(lm)]


NESTED_DDL = ("create table orders_nested (o_orderkey bigint, o_custkey bigint, "
              "o_orderdate date, partkeys array(bigint), suppkeys array(bigint), "
              "shipmodes array(varchar))")


def build_nested(engine, sess, columns) -> float:
    """CREATE TABLE orders_nested and one ``append`` of ``columns``; seconds."""
    t0 = time.perf_counter()
    engine.execute_sql(NESTED_DDL, sess)
    engine.catalogs["memory"].append("orders_nested", columns)
    return time.perf_counter() - t0


def arrays_parity():
    """Phase 10a: the statements of tests/test_torch_arrays.py and
    tests/test_torch_match.py on the card and on the CPU, equal."""
    t0 = time.perf_counter()
    n = 0
    for label, cases, setup in (("arrays", ARRAY_CASES, ARRAY_SETUP),
                                ("match", MATCH_CASES, MATCH_SETUP)):
        card, card_s = corpus_engines(DEVICE, ())
        cpu, cpu_s = corpus_engines("cpu", ())
        for i, sql in enumerate(setup):
            same_outcome(card, cpu, sql, card_s["mem"], cpu_s["mem"], f"{label} setup {i}")
            n += 1
        for case, (catalog, sql) in cases.items():
            same_outcome(card, cpu, sql, card_s[catalog], cpu_s[catalog],
                         f"{label} {case} card vs CPU")
            n += 1
        del card, cpu
    print(f"arrays parity: {n} statements on the card equal the port's CPU outcomes "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


def nested_keys(columns):
    """Phase 10's own insert keys: A2's ``p % 100000`` over every unnested
    part key, packed as a one-key hash group-by packs it."""
    import itertools

    import torch

    from trino_tpu_torch.ops.hashing import pack_keys
    from trino_tpu_torch.types import BIGINT

    p = torch.tensor(list(itertools.chain.from_iterable(columns[3])), dtype=torch.int64,
                     device=DEVICE)
    packed, _ = pack_keys((p % 100000,), (BIGINT,))
    return packed, torch.ones(p.shape, dtype=torch.bool, device=DEVICE)


def arrays_main():
    """Phase 10b: ``orders_nested`` built at SF1 on the card (timed on its
    own), A1-A6 on the card (cold, warm, launches, host reads, H2D bytes,
    peak memory), ARRAYS_REQUIRED, A1 against its lineitem oracle, the
    kernels the path launched against their plain versions at its shapes,
    then A1-A6 against the port's CPU run at SF1 and A7 at
    ARRAYS_SF_ALL_ROWS on the card against the CPU.  Returns (launches of
    A1-A7, {kernel: checks})."""
    import numpy as np
    import torch

    from trino_tpu_torch.ops import cuda_kernels as ck

    card, sess = memory_engine(DEVICE, SF_MAIN)
    t0 = time.perf_counter()
    li = card.execute_sql("select l_orderkey, l_linenumber, l_partkey, l_suppkey, l_shipmode "
                          "from tpch.lineitem", sess)
    od = card.execute_sql("select o_orderkey, o_custkey, o_orderdate from tpch.orders", sess)
    columns = nested_orders(od.raw_columns, [li.raw_columns[i] for i in range(4)]
                            + [li.columns[4]])
    n_items = len(li)
    del li, od
    lists_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build_s = build_nested(card, sess, columns)
    torch.cuda.synchronize()
    print(f"arrays: orders_nested {len(columns[0])} rows, {n_items} elements per array "
          f"column: lists {lists_s:.2f} s, build (CREATE + append) {build_s:.2f} s, "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    ck.reset_stats()
    got = run_queries(card, ARRAYS, n_items, f"arrays sf{SF_MAIN:g}", catalog="memory")
    small, _ = memory_engine(DEVICE, ARRAYS_SF_ALL_ROWS)
    got.update(run_queries(small, ARRAYS_ALL_ROWS, 0, f"arrays sf{ARRAYS_SF_ALL_ROWS:g}",
                           catalog="memory"))
    launches = {k: s.launches for k, s in ck.STATS.items()}
    shapes = {k: list(s.shapes) for k, s in ck.STATS.items()}
    for q, kernels in ARRAYS_REQUIRED.items():
        for k in kernels:
            check(got[q]["launches"][k] > 0, f"arrays {q} launched no {k} kernel")
    oracle = card.execute_sql(A1_ORACLE, sess)
    a1 = got["a1_unnest_zip"]["result"]
    check([int(v[0]) for v in a1.raw_columns] == [int(v[0]) for v in oracle.raw_columns]
          and a1.raw_columns[0][0] == n_items,
          f"A1 {a1.rows()} differs from its lineitem oracle {oracle.rows()}")
    print(f"arrays A1: equal to its lineitem oracle {oracle.rows()[0]}", flush=True)
    gen = np.random.default_rng(19)
    checks = {}
    if shapes["hash_insert"]:
        checks["hash_insert"] = insert_checks(
            shapes["hash_insert"], ("unnested_partkey_mod_100000", *nested_keys(columns)), gen)
    if shapes["hash_probe"]:
        checks["hash_probe"] = probe_checks(shapes["hash_probe"], gen)
    if shapes["compact_rows"]:
        checks["compact_rows"] = compact_checks(shapes["compact_rows"], gen)
    cpu, cpu_sess = memory_engine("cpu", SF_MAIN)
    build_nested(cpu, cpu_sess, columns)
    del columns
    t1 = time.perf_counter()
    for q, sql in ARRAYS.items():
        t2 = time.perf_counter()
        same_outcome_result(got[q]["result"], cpu.execute_sql(sql, cpu_sess), sql,
                            f"arrays sf{SF_MAIN:g} {q} card vs CPU")
        check(len(got[q]["result"]) > 0, f"arrays {q} returned no rows")
        print(f"arrays sf{SF_MAIN:g} {q}: equal to the port's CPU result "
              f"({len(got[q]['result'])} rows, CPU {time.perf_counter() - t2:.2f} s)",
              flush=True)
    del cpu
    cpu, cpu_sess = memory_engine("cpu", ARRAYS_SF_ALL_ROWS)
    for q, sql in ARRAYS_ALL_ROWS.items():
        same_outcome_result(got[q]["result"], cpu.execute_sql(sql, cpu_sess), sql,
                            f"arrays sf{ARRAYS_SF_ALL_ROWS:g} {q} card vs CPU")
        check(len(got[q]["result"]) > 0, f"arrays {q} returned no rows")
    print(f"arrays CPU pass: {time.perf_counter() - t1:.1f} s", flush=True)
    del cpu, card, small
    torch.cuda.empty_cache()
    return launches, {k: {"max_abs_err": r["max_abs_err"], "shapes": r["shapes"]}
                      for k, r in checks.items()}


def arrays_path():
    """Phase 10: arrays, maps, UNNEST and MATCH_RECOGNIZE.  Returns (launches
    of 10b, {kernel: checks at its shapes})."""
    t0 = time.perf_counter()
    arrays_parity()
    launches, checks = arrays_main()
    print(f"arrays path: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, checks


# -- phase 11: the coordinator entry point, TPC-H SF1 over the statement protocol --------
# the kernels each query must launch through the server: those phase 2
# requires of it (REQUIRED)
SERVER_REQUIRED = REQUIRED
SERVER_CLIENTS = 4
BIG_RESULT = ("select o_orderkey, o_custkey, o_orderstatus, o_totalprice, o_orderdate "
              "from orders")
SPOOL_THRESHOLD = 10_000
VERIFIER_SF = 0.1
# Q3 with ``?`` for the segment and the date; Q6 with ``?`` for the discount
# band and the quantity
Q3_PARAMS = (QUERIES["q3"].replace("c_mktsegment = 'BUILDING'", "c_mktsegment = ?")
             .replace("o_orderdate < date '1995-03-15'", "o_orderdate < ?"))
Q6_PARAMS = (TPCH_QUERIES["q6"].replace("between 0.05 and 0.07", "between ? and ?")
             .replace("l_quantity < 24", "l_quantity < ?"))


def json_rows(res):
    """A direct result's rows as the server sends them: through the server's
    ``_json_value`` and a JSON round trip."""
    from trino_tpu_torch.server.server import _json_value

    return json.loads(json.dumps([[_json_value(v) for v in row] for row in res.rows()]))


def same_json_rows(got, want, columns, sql, what):
    """Protocol rows equal: DOUBLE columns within rtol 1e-9, every other
    column exactly; in order where the statement orders its rows."""
    import numpy as np

    check(len(got) == len(want), f"{what}: {len(got)} rows vs {len(want)}")
    flt = [c["type"] in ("double", "real") for c in columns]
    if not ordered_sql(sql):
        key = lambda r: tuple(repr(v) for v, f in zip(r, flt) if not f)  # noqa: E731
        got, want = sorted(got, key=key), sorted(want, key=key)
    for i, (name, f) in enumerate(zip([c["name"] for c in columns], flt)):
        a, b = [r[i] for r in got], [r[i] for r in want]
        if f:
            check([v is None for v in a] == [v is None for v in b],
                  f"{what}: column {name} NULLs differ")
            x = np.array([v for v in a if v is not None], np.float64)
            y = np.array([v for v in b if v is not None], np.float64)
            ok = np.allclose(x, y, rtol=1e-9, atol=0.0, equal_nan=True)
        else:
            ok = a == b
        check(ok, f"{what}: column {name} differs")


def statement_counters(engine, sql):
    """The counters of the last finished statement with this text (the
    engine's query tracker)."""
    done = [q for q in engine.query_tracker.all_queries() if q.sql == sql and q.is_done]
    check(done, f"no finished statement in the tracker for {sql[:60]!r}")
    return done[-1].counters


def timed_client(client, sql, **kw):
    """(result, seconds from POST to the last page)."""
    t0 = time.perf_counter()
    res = client.execute(sql, **kw)
    return res, time.perf_counter() - t0


def server_queries(engine, srv, direct):
    """11a: the 22 queries through the protocol, cold and warm, each equal to
    phase 2's direct card result; host reads and launches per query equal
    the direct run's; warm wall per query beside the direct warm wall on
    the same engine."""
    import torch

    from trino_tpu_torch.server import Client

    client = Client(srv.url, catalog="tpch")
    out = {}
    for q, sql in ALL_QUERIES.items():
        res, cold = timed_client(client, sql)
        check([c["name"] for c in res.columns] == list(direct[q]["names"]),
              f"server {q}: column names differ")
        same_json_rows(res.rows, direct[q]["rows"], res.columns, sql,
                       f"server {q} vs phase 2")
        c = statement_counters(engine, sql)
        check(c["host_reads"] == direct[q]["host_reads"],
              f"server {q}: {c['host_reads']} host reads vs {direct[q]['host_reads']} direct")
        launches = {k: v for k, v in c["launches"].items() if v}
        check(launches == direct[q]["launches"],
              f"server {q}: launches {launches} vs phase 2's {direct[q]['launches']}")
        for k in SERVER_REQUIRED.get(q, ()):
            check(launches.get(k, 0) > 0, f"server {q} launched no {k} kernel")
        warm, direct_warm = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.execute_sql(sql, engine.create_session("tpch"))
            torch.cuda.synchronize()
            direct_warm.append(time.perf_counter() - t0)
            res2, s = timed_client(client, sql)
            warm.append(s)
            same_json_rows(res2.rows, direct[q]["rows"], res2.columns, sql,
                           f"server {q} warm vs phase 2")
        out[q] = {"rows": len(res.rows), "cold_s": cold, "warm_s": min(warm),
                  "direct_warm_s": min(direct_warm),
                  "overhead_s": min(warm) - min(direct_warm),
                  "host_reads": c["host_reads"], "launches": launches}
        print(f"server {q}: rows={len(res.rows)} cold_s={cold} warm_s={min(warm)} "
              f"direct_warm_s={min(direct_warm)} overhead_s={min(warm) - min(direct_warm)} "
              f"host_reads={c['host_reads']} launches={launches}", flush=True)
    return out


def server_clients(engine, srv):
    """11b: bench.py's five queries from one client, then from four at once
    (each runs the five twice, in its own order); every result equal to the
    serial one, each statement's launches equal to its serial run's, and
    the kernels' summed launches 8x the serial ones.  Returns the record
    and the launch shapes recorded while the four clients ran."""
    import torch

    from trino_tpu_torch.ops import cuda_kernels as ck
    from trino_tpu_torch.server import Client

    names = list(QUERIES)
    client = Client(srv.url, catalog="tpch")
    serial, serial_launches = {}, {}
    for q in names:
        ck.reset_stats()
        serial[q] = client.execute(QUERIES[q]).rows
        serial_launches[q] = {k: s.launches for k, s in ck.STATS.items()}
        c = statement_counters(engine, QUERIES[q])
        check({k: v for k, v in c["launches"].items() if v}
              == {k: v for k, v in serial_launches[q].items() if v},
              f"server {q}: the statement's launches differ from the kernels' counts")
    t0 = time.perf_counter()
    for _ in range(2):
        for q in names:
            client.execute(QUERIES[q])
    one_s = time.perf_counter() - t0
    orders = [names[i:] + names[:i] for i in range(SERVER_CLIENTS)]
    results, errors = {}, []
    before = {q.query_id for q in engine.query_tracker.all_queries()}

    def run(i):
        try:
            c = Client(srv.url, catalog="tpch")
            for j, q in enumerate(orders[i] + orders[i][::-1]):
                results[(i, j, q)] = c.execute(QUERIES[q])
        except Exception as e:  # noqa: BLE001 - reported by the check below
            errors.append(e)

    import threading

    ck.reset_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(SERVER_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    four_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check(not errors, f"concurrent clients failed: {errors!r}")
    check(len(results) == SERVER_CLIENTS * 2 * len(names), "a client statement was lost")
    for (_, _, q), res in results.items():
        same_json_rows(res.rows, serial[q], res.columns, QUERIES[q],
                       f"server {q} under {SERVER_CLIENTS} clients vs serial")
    launches = {k: s.launches for k, s in ck.STATS.items()}
    shapes = {k: list(s.shapes) for k, s in ck.STATS.items()}
    runs = 2 * SERVER_CLIENTS
    for k, n in launches.items():
        want = runs * sum(serial_launches[q][k] for q in names)
        check(n == want, f"{SERVER_CLIENTS} clients: {n} {k} launches vs {want} "
              f"({runs}x the serial ones)")
    new = [q for q in engine.query_tracker.all_queries() if q.query_id not in before]
    check(len(new) == len(results), f"{len(new)} tracked statements vs {len(results)}")
    by_sql = {QUERIES[q]: q for q in names}
    for qsm in new:
        q = by_sql[qsm.sql]
        got = {k: v for k, v in qsm.counters["launches"].items() if v}
        check(got == {k: v for k, v in serial_launches[q].items() if v},
              f"server {q} under {SERVER_CLIENTS} clients: its launches {got} vs serial")
    rec = {"statements_per_s_1": 2 * len(names) / one_s,
           "statements_per_s_4": len(results) / four_s, "seconds_1": one_s,
           "seconds_4": four_s, "peak_bytes": peak, "launches": launches,
           "serial_launches": serial_launches}
    print(f"server clients: 1 client {rec['statements_per_s_1']} statements/s "
          f"({2 * len(names)} in {one_s} s), {SERVER_CLIENTS} clients "
          f"{rec['statements_per_s_4']} statements/s ({len(results)} in {four_s} s), "
          f"peak {peak / 2**30:.2f} GiB, launches {launches} = {runs}x serial", flush=True)
    return rec, shapes


def column_sums(names, rows):
    """Per-column checks of a large result: sums of the numbers, value counts
    of the status, the sum of the dates' epoch days."""
    import collections

    import numpy as np

    cols = list(zip(*rows)) if rows else [()] * len(names)
    out = {}
    for name, col in zip(names, cols):
        if name == "o_orderstatus":
            out[name] = dict(collections.Counter(col))
        elif name == "o_orderdate":
            out[name] = int(np.array(col, dtype="datetime64[D]").astype(np.int64).sum())
        elif name == "o_totalprice":
            out[name] = round(float(np.sum(np.array(col, np.float64))), 2)
        else:
            out[name] = int(np.sum(np.array(col, np.int64)))
    return out


def server_big_result(engine, srv, spool_srv):
    """11c: the 1,500,000 rows of SF1 orders pulled inline (pages of
    DATA_ROWS_PER_FETCH rows) and spooled (json+zlib segments); the row
    count and per-column sums equal the direct run's."""
    import torch

    from trino_tpu_torch.server import Client
    from trino_tpu_torch.server.server import DATA_ROWS_PER_FETCH

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    direct = engine.execute_sql(BIG_RESULT, engine.create_session("tpch"))
    torch.cuda.synchronize()
    direct_s = time.perf_counter() - t0
    want = column_sums(direct.names, json_rows(direct))
    n = len(direct)
    out = {"rows": n, "direct_s": direct_s, "direct_rows_per_s": n / direct_s,
           "pages": -(-n // DATA_ROWS_PER_FETCH)}
    for form, server in (("inline", srv), ("spooled", spool_srv)):
        res, s = timed_client(Client(server.url, catalog="tpch"), BIG_RESULT)
        check(len(res.rows) == n, f"{form} pull: {len(res.rows)} rows vs {n}")
        got = column_sums(res.column_names, res.rows)
        check(got == want, f"{form} pull: column sums {got} vs direct {want}")
        out[f"{form}_s"] = s
        out[f"{form}_rows_per_s"] = n / s
        print(f"server big result {form}: {n} rows in {s} s, {n / s} rows/s at the client "
              f"(direct {direct_s} s); sums equal the direct run's", flush=True)
    return out


def join_markers(rows):
    """{"joins": each join's distribution, "exchanges": each Exchange's kind}
    of an EXPLAIN's rows, in plan order."""
    import re

    text = "\n".join(r[0] for r in rows)
    return {"joins": re.findall(r"Join\[.*?, (replicated|partitioned|broadcast)\b", text),
            "exchanges": re.findall(r"Exchange\[([^\]]*\]?)\]", text)}


def _status(url, headers=None, method="GET", body=None):
    import urllib.error
    import urllib.request

    try:
        urllib.request.urlopen(urllib.request.Request(url, data=body, method=method,
                                                      headers=headers or {}), timeout=60)
        return 200
    except urllib.error.HTTPError as e:
        return e.code


def server_statements(engine, srv, auth_srv, direct):
    """11d: SHOW, EXPLAIN [ANALYZE], PREPARE / EXECUTE, protocol parameters,
    SET SESSION of join_distribution_type (held on EXPLAIN of Q3), CTAS of
    Q1 into memory, system.queries, a cancel and a wrong password, each held
    against the direct engine."""
    import base64
    import urllib.request

    from trino_tpu_torch.server import Client

    client = Client(srv.url, catalog="tpch")
    sess = engine.create_session("tpch")
    # the statements of the phase so far, and of this step before the read of
    # system.queries
    phase_sql = set(ALL_QUERIES.values()) | {BIG_RESULT}
    for sql in ("show catalogs", "show tables", "show columns from lineitem", "show session",
                "show stats for lineitem", "explain " + QUERIES["q3"]):
        res = client.execute(sql)
        phase_sql.add(sql)
        check(res.rows == json_rows(engine.execute_sql(sql, sess)),
              f"server {sql[:40]!r} differs from the direct engine")
    text = "\n".join(r[0] for r in client.execute("explain analyze " + QUERIES["q3"]).rows)
    check("executed in" in text and f"{len(direct['q3']['rows'])} output rows" in text,
          "server EXPLAIN ANALYZE of Q3 reports no run")
    want = direct["q3"]["rows"]
    engine.execute_sql("prepare q3p from " + Q3_PARAMS, sess)
    res = engine.execute_sql("execute q3p using 'BUILDING', date '1995-03-15'", sess)
    same_json_rows(json_rows(res), want, [{"name": n, "type": t.name}
                                          for n, t in zip(res.names, res.types)],
                   QUERIES["q3"], "EXECUTE q3p vs Q3")
    res = client.execute(Q3_PARAMS, params=["BUILDING", "1995-03-15"])
    phase_sql.add(Q3_PARAMS)
    same_json_rows(res.rows, want, res.columns, QUERIES["q3"], "protocol parameters vs Q3")
    # SET SESSION of the one property the planner reads: it must reach the plan
    setting = "set session join_distribution_type = 'PARTITIONED'"
    check(client.execute(setting).rows == [[True]], "server SET SESSION")
    phase_sql.add(setting)
    default = join_markers(json_rows(engine.execute_sql("explain " + QUERIES["q3"], sess)))
    engine.execute_sql(setting, sess)
    forced = join_markers(json_rows(engine.execute_sql("explain " + QUERIES["q3"], sess)))
    check(forced != default and set(default["joins"]) != {"partitioned"},
          f"EXPLAIN Q3 unchanged by SET SESSION: {default}")
    check(forced["joins"] and set(forced["joins"]) == {"partitioned"}
          and "auto" not in forced["exchanges"]
          and any(x.startswith("hash on") for x in forced["exchanges"]),
          f"EXPLAIN Q3 after SET SESSION join_distribution_type: {forced}")
    mem = Client(srv.url, catalog="memory")
    q1 = QUERIES["q1"].replace("from lineitem", "from tpch.lineitem")
    check(mem.execute("create table q1_result as " + q1).rows == [[True]], "CTAS of Q1")
    res = mem.execute("select * from q1_result order by l_returnflag, l_linestatus")
    same_json_rows(res.rows, direct["q1"]["rows"], res.columns, QUERIES["q1"],
                   "CTAS of Q1 read back vs Q1")
    mem.execute("drop table q1_result")
    phase_sql |= {"create table q1_result as " + q1, "drop table q1_result",
                  "select * from q1_result order by l_returnflag, l_linestatus"}
    listed = {r[0] for r in client.execute("select query from system.queries").rows}
    missing = [s for s in phase_sql if s not in listed]
    check(not missing, f"system.queries lacks {len(missing)} statements of the phase, "
          f"e.g. {missing[:1]!r}")
    # a cancel: the statement waits at the gate behind a writer, is canceled,
    # never runs, and its page is terminal
    srv._engine_lock.acquire_exclusive()
    try:
        req = urllib.request.Request(f"{srv.url}/v1/statement", method="POST",
                                     data=QUERIES["q9"].encode(),
                                     headers={"X-Trino-Catalog": "tpch"})
        qid = json.loads(urllib.request.urlopen(req, timeout=60).read())["id"]
        urllib.request.urlopen(urllib.request.Request(f"{srv.url}/v1/statement/{qid}",
                                                      method="DELETE"), timeout=60)
    finally:
        srv._engine_lock.release_exclusive()
    q = srv.queries[qid]
    for _ in range(500):
        if q.finished_at is not None:
            break
        time.sleep(0.01)
    body = json.loads(urllib.request.urlopen(
        f"{srv.url}/v1/statement/executing/{qid}/0", timeout=60).read())
    check(q.state == "CANCELED" and "nextUri" not in body
          and body["stats"]["state"] == "CANCELED", f"cancel: {q.state} {body}")
    wrong = {"Authorization": "Basic " + base64.b64encode(b"smoke:nope").decode()}
    right = {"Authorization": "Basic " + base64.b64encode(b"smoke:pw").decode()}
    codes = (_status(f"{auth_srv.url}/v1/statement", wrong, "POST", b"select 1"),
             _status(f"{auth_srv.url}/v1/statement", right, "POST", b"select 1"))
    check(codes == (401, 200), f"wrong password / right password: HTTP {codes}")
    print(f"server statements: SHOW x5, EXPLAIN, EXPLAIN ANALYZE, PREPARE/EXECUTE and "
          f"protocol parameters of Q3, SET SESSION join_distribution_type (EXPLAIN Q3's "
          f"joins {default['joins']} -> {forced['joins']}), CTAS of Q1, system.queries "
          f"({len(phase_sql)} statements listed), cancel, HTTP {codes[0]} on a wrong "
          f"password: all held", flush=True)


def _normal(rows):
    """Rows for the verifier: DOUBLEs to 12 significant digits (the card and
    the CPU sum in different orders; the parity rule is rtol 1e-9)."""
    return [tuple(float(f"{v:.12g}") if isinstance(v, float) else
                  (v.item() if hasattr(v, "item") else v) for v in row) for row in rows]


def server_dbapi_and_verifier(srv, direct):
    """11e: the DB-API over HTTP runs Q1 and a parameterized Q6; the verifier
    runs the 22 at VERIFIER_SF with the port on the CPU as the control and a
    card server as the test: all must MATCH."""
    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.server import Client, CoordinatorServer, dbapi
    from trino_tpu_torch.server.server import _json_value
    from trino_tpu_torch.verifier import Verifier, VerifierQuery

    cur = dbapi.connect(url=srv.url, catalog="tpch").cursor()
    cur.execute(QUERIES["q1"])
    check([list(r) for r in cur.fetchall()] == direct["q1"]["rows"], "DB-API Q1")
    cur.execute(Q6_PARAMS, (0.05, 0.07, 24))
    got = [list(r) for r in cur.fetchall()]
    same_json_rows(got, direct["q6"]["rows"], [{"name": "revenue", "type": "double"}],
                   TPCH_QUERIES["q6"], "DB-API parameterized Q6 vs Q6")
    cpu = Engine(device="cpu")
    cpu.register_catalog("tpch", TpchConnector(sf=VERIFIER_SF, split_rows=SPLIT_ROWS))
    card = Engine(device=DEVICE)
    card.register_catalog("tpch", TpchConnector(sf=VERIFIER_SF, split_rows=SPLIT_ROWS))
    for e in (cpu, card):
        e.execute_sql(Q15_VIEW, e.create_session("tpch"))
    test_srv = CoordinatorServer(card, port=0, dispatch_threads=SERVER_CLIENTS)
    test_srv.start()
    try:
        c = Client(test_srv.url, catalog="tpch")
        results = Verifier(
            lambda q: _normal([[_json_value(v) for v in row]
                               for row in cpu.execute_sql(q, cpu.create_session("tpch"))
                               .rows()]),
            lambda q: _normal(c.execute(q).rows),
        ).run([VerifierQuery(q, sql) for q, sql in ALL_QUERIES.items()])
    finally:
        test_srv.stop()
    report = Verifier.report(results)
    print(report, flush=True)
    check(all(r.status == "MATCH" for r in results),
          f"verifier at SF{VERIFIER_SF:g}: not every query matched")
    return {"matched": sum(r.status == "MATCH" for r in results), "queries": len(results),
            "control_s": sum(r.control_wall_s for r in results),
            "test_s": sum(r.test_wall_s for r in results)}


def server_path(direct):
    """Phase 11: a ``CoordinatorServer`` over a card engine holding TPC-H at
    SF1, a memory catalog and the system catalog; clients on loopback HTTP.
    ``direct``: phase 2's per-query JSON rows, host reads and launches.
    Returns (the phase's record, launches of 11b, {kernel: checks at the
    shapes recorded while the clients ran})."""
    import shutil

    import numpy as np
    import torch

    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.server import CoordinatorServer

    t_phase = time.perf_counter()
    engine = Engine(device=DEVICE)
    engine.register_catalog("tpch", TpchConnector(sf=SF_MAIN, split_rows=SPLIT_ROWS))
    engine.register_catalog("memory", MemoryConnector())
    engine.execute_sql(Q15_VIEW, engine.create_session("tpch"))
    # system.queries must list every statement of the phase
    engine.query_tracker.max_history = 100_000
    spool = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "spool")
    servers = (CoordinatorServer(engine, port=0, dispatch_threads=SERVER_CLIENTS),
               CoordinatorServer(engine, port=0, dispatch_threads=SERVER_CLIENTS,
                                 spool_dir=spool, spool_threshold_rows=SPOOL_THRESHOLD),
               CoordinatorServer(engine, port=0, passwords={"smoke": "pw"}))
    for s in servers:
        s.start()
    srv, spool_srv, auth_srv = servers
    try:
        rec = {"queries": server_queries(engine, srv, direct)}
        rec["clients"], shapes = server_clients(engine, srv)
        rec["big_result"] = server_big_result(engine, srv, spool_srv)
        server_statements(engine, srv, auth_srv, direct)
        rec["verifier"] = server_dbapi_and_verifier(srv, direct)
    finally:
        for s in servers:
            s.stop()
        shutil.rmtree(spool, ignore_errors=True)
    li_keys = lineitem_keys(engine.catalogs["tpch"])
    gen = np.random.default_rng(23)
    checks = {}
    if shapes["hash_insert"]:
        checks["hash_insert"] = insert_checks(shapes["hash_insert"],
                                              ("lineitem_orderkey", *li_keys), gen)
    if shapes["hash_probe"]:
        checks["hash_probe"] = probe_checks(shapes["hash_probe"], gen)
    if shapes["compact_rows"]:
        checks["compact_rows"] = compact_checks(shapes["compact_rows"], gen)
    for k in ("hash_insert", "hash_probe", "compact_rows"):
        check(k in checks, f"server path: the {SERVER_CLIENTS} clients launched no {k}")
    overheads = [r["overhead_s"] for r in rec["queries"].values()]
    rec["overhead_s_median"] = statistics.median(overheads)
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"server path: {rec['seconds']:.1f} s; protocol overhead per query median "
          f"{rec['overhead_s_median']} s (min {min(overheads)}, max {max(overheads)})",
          flush=True)
    print(json.dumps({"server_sf1": rec}, default=str), flush=True)
    del engine
    torch.cuda.empty_cache()
    return rec, rec["clients"]["launches"], {
        k: {"max_abs_err": r["max_abs_err"], "shapes": r["shapes"]} for k, r in checks.items()}


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
        # phase 11's: each query's rows as the server sends them, its host
        # reads and its launches
        direct = {q: {"names": list(r["result"].names), "rows": json_rows(r["result"]),
                      "host_reads": r["host_reads"],
                      "launches": {k: v for k, v in r["launches"].items() if v}}
                  for q, r in main.items()}

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
        # -- phase 9: the function library at SF0.01, SF1 and SF10 ------------
        fn_launches, fn_checks = functions_path()
        # -- phase 10: arrays, maps, UNNEST and MATCH_RECOGNIZE -----------------
        torch.cuda.empty_cache()
        ar_launches, ar_checks = arrays_path()
        # -- phase 11: the coordinator entry point, TPC-H SF1 over the protocol -
        torch.cuda.empty_cache()
        _, sv_launches, sv_checks = server_path(direct)

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
                               **mem_checks.get(name, {"max_abs_err": None, "shapes": []})},
                "functions_sf1": {"launches": fn_launches[name],
                                  **fn_checks.get(name, {"max_abs_err": None, "shapes": []})},
                "arrays_sf1": {"launches": ar_launches[name],
                               **ar_checks.get(name, {"max_abs_err": None, "shapes": []})},
                "server_sf1": {"launches": sv_launches[name],
                               **sv_checks.get(name, {"max_abs_err": None, "shapes": []})}}
            for checks in (ds_checks, mem_checks, fn_checks, ar_checks, sv_checks):
                if name in checks:
                    r["max_abs_err"] = max(r["max_abs_err"], checks[name]["max_abs_err"])
            r["launches"] += (ds_launches[name] + mem_launches[name] + fn_launches[name]
                              + ar_launches[name] + sv_launches[name])
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

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
   query run by the port on the CPU: that CPU pass runs in a child process
   (``ChildPass`` of ``cpu_pass_child``: spawned at the top of ``main``
   before the card is touched, half the host's cores for its torch threads), and
   its 22 card-vs-CPU checks are made when it is joined, just before phase
   14, which reads its per-node records; a child that fails, runs past
   ``CPU_PASS_TIMEOUT_S`` of waiting or returns nothing fails the run.
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
   result.  The CPU half runs in a child process started at the top of
   ``main`` (``ChildPass`` of ``tpcds_cpu_child``, ``CPU_CHILD_THREADS``
   torch threads), beside phases 1-4, and records the plan nodes each query
   runs (its plan-time subqueries included).
6. TPC-DS at SF1 (``TpcdsConnector(sf=1, split_rows=1<<21)``, ~2.88M
   store_sales rows): every corpus query on the card, cold and warm, with
   host reads, peak device memory and the launches of each kernel; the
   counters are set to 0 just before the run and read just after, each
   query must launch the kernels that ``TPCDS_REQUIRED`` names (those the
   JAX reference's SF1 path reaches), and the run as a whole must launch
   every one of them.  Queries that run a Window, Union, Values or a Limit
   over anything but a Sort are also held against the port's CPU run, both
   at ``TPCDS_SF_HELD`` (0.25: the CPU's SF1 generation alone took 111 s)
   with ``TPCDS_SPLIT_HELD`` (2^18) rows a split, so that store_sales spans
   three pages there as it spans two at SF1 and windows and streaming LIMITs
   are held across a page boundary; the run fails if it spans fewer than two.
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
   run of the whole sequence (run in a child process beside phases 1-7,
   ``memory_cpu_child``); every kernel ``MEMORY_REQUIRED`` names is
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
   and launches, each equal to the port's CPU result (run in a child
   process beside the earlier phases, ``functions_cpu_child``), each
   launching the
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
   (``A1_ORACLE``), and A7 (ALL ROWS PER MATCH) at SF0.1 against the CPU
   (the CPU's runs, ``orders_nested`` built from its own generation, in a
   child process beside the earlier phases, ``arrays_cpu_child``);
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
   serial ones; (c) 300,000 rows of SF1 orders pulled inline and
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
12. The plan cache and the device buffer pool at their defaults
   (``cache_path``; phases 2-11 run with the pool's tiers off, phase 12 with
   the page tier at a quarter of the card's memory; phases 2-13 with the
   adaptive advisor off, ``TRINO_TPU_ADAPTIVE=0``, whose re-plans phase 14
   measures, 14e with every default): (a) the 22 queries twice
   on one SF1 engine, each result equal to phase 2's, with wall, launches,
   H2D bytes, host reads and the pool's hits, misses and bytes saved per
   query and pass; the second pass plans nothing, hits the page tier on
   every scan, checks every join build out (no hashed build runs, so no
   ``hash_insert`` launch for one) and copies no more H2D bytes; the pool's
   resident bytes against its budget beside the card's peak and reserved
   memory; (b) the 22 over a 1 GiB page tier: equal results, evictions, the
   resident bytes never past the budget; (c) bench.py's five with a 256 MiB
   result tier: a hit equals the miss and counts no launch, no host read,
   no H2D byte, and ``now()`` never enters; (d) CTAS of orders into memory,
   a read that hits, then INSERT, DELETE and UPDATE: after each no tier
   holds anything, the read misses, and its rows equal a numpy oracle of the
   same writes; (e) the planner milliseconds a warm repeat saves; (f) a
   kernel launched at the whole lineitem page (6,000,026 rows at SF1), and
   insert, compaction and probe against their plain versions at the second
   pass's shapes.  ``by_path`` gains ``cache_sf1``.
13. Plan templates and the template batcher (``templates_path``): one
   statement shape with new values on every request, as a dashboard or an
   API backend sends it, on one SF1 engine at its defaults (page tier on;
   the result tier off through the ``result_cache`` session property);
   bindings from ``numpy.random.default_rng(13)``.  (a) PREPARE each of
   ``TEMPLATES`` (T1-T6) and EXECUTE it ``TEMPLATE_EXECUTES`` times (a NULL
   binding and one outside the domain among them): the first EXECUTE
   creates the template, every later one hits it and plans nothing (no
   ``Planner.plan_query`` call, no ``planner`` span); every result equal
   byte for byte to a card engine with templates off (the substitution
   path), four bindings of each also to the port's CPU engine; per
   statement the median wall of a hit and of the substitution path, host
   reads, H2D bytes and launches per request.  (b) The same values inline
   as ad-hoc SELECTs (auto-parameterization): the same checks.  (c) Fused
   windows of 4 and 16 requests of T1, T3 and T4 (the leader parked in
   ``batcher.LEADER_EXIT_HOOK`` until the window has queued): every lane
   equal to its own serial answer, T4's window scanning the union of its
   members' kept splits, and a warm window of 4 reading the host at most
   twice as often as one warm serial request; each window's wall beside
   the sum of its members' serial walls.  (d) A
   ``CoordinatorServer(dispatch_threads=4)`` over the engine: DB-API
   clients send T3 and T4 with parameters, ``TEMPLATE_SERVER_REQUESTS``
   requests per setting from 1, 4 and 16 clients, the batcher on and then
   off; every response equal to the direct answer for its binding;
   statements/s, p50 and p99 wall and the batches formed.  (e) T4 and T1
   on a TPC-H SF10 engine (lineitem not cut): bind-time pruning reads one
   lineitem split per binding; results equal a templates-off card engine;
   the warm walls of both.  (f) ``compact_rows`` against its plain version
   at the phase's largest and most frequent shapes.  ``by_path`` gains
   ``templates_sf1``: the launches and shapes of the templates engine's own
   requests at SF1 (13a-13d), counted from zero around each of them, so the
   templates-off comparator and the SF10 engines are left out.
14. Per-node stats, plan history and adaptive execution (``history_path``),
   TPC-H SF1 on card engines at their defaults.  (a) The 22 queries with
   history on (the page and build tiers off, as on the CPU): each result
   equal to phase 2's, each node's history record (operator, estimate,
   actual rows, the unestimated marker, split counts) equal to the port's
   CPU engine's record of the same query in phase 2; bench.py's five warm
   and T1-T6 template hits with history on and with the store
   ``TRINO_TPU_PLAN_HISTORY=0`` builds, in turns on one engine: results
   equal, host reads and launches equal, walls and the history record's own
   seconds, the adaptive advisor off as in phases 2-13.  (b) EXPLAIN
   ANALYZE of bench.py's five and of a nation count:
   every recorded node's ``[rows: N, ms]`` and ``[est ... x actual ...]``,
   and the ``Misestimates:`` line, as the CPU engine's records give them;
   the per-operator ``[boundary: ...]`` records sum to the run's totals;
   nation's plan lines equal the CPU engine's.  (c) The adaptive advisor,
   at its default (on) from here, on fresh engines with ``price_scale = 0``: ``ADAPTIVE_PROBE`` (a direct
   group-by) and ``ADAPTIVE_PROBE_HASH`` (a hash group-by) each record,
   re-plan with a capacity correction and confirm, rows equal in key
   order; the hash group-by's corrected plan launches ``hash_insert_`` only
   at the advisor's capacity; warm uncorrected against corrected; the
   default price's verdict; ``ADAPTIVE_JOIN`` re-planned to
   ``partitioned``.  (e) The 22 queries three times on one engine with
   every default, the advisor included: each run's result equal to phase
   2's (sorted rows where a statement does not order them); which queries
   re-planned or held, their corrections, whether each confirmed or
   demoted, and each re-planned query's predicted win and price beside its
   warm walls, host reads and launches uncorrected and corrected, in
   turns.  (d) ``hash_insert_`` against its plain version at the
   corrected shape, ``hash_probe`` and ``compact_rows`` at the phase's
   largest and most frequent.  ``by_path`` gains ``adaptive_sf1``: the
   launches of 14a-14c and 14e with history on.
15. The flight recorder, the kernel-build log, the in-flight registry and
   the stall watchdog at SF1 (``flight_path``; the tiers and the advisor
   off, as phase 2 ran).  (a) The 22 queries on an engine whose recorder
   is at its default with an on-disk ring in a temporary directory, and on
   one built with ``TRINO_TPU_FLIGHT_RECORDS=0``: each result equal to
   phase 2's, one FINISHED record per statement, host reads, H2D bytes and
   launches equal between the two; then bench.py's five warm and T1-T6
   template hits with the recorder off, in memory and with its disk ring,
   in turns (``FlightSwitch``), and ``_record_flight``'s seconds.  (b) An
   erroring statement's record holds its error, in memory and on disk.
   (c) ``COMPILE_LOG`` holds one record per CUDA library from the build at
   startup, with its nvcc seconds or ``cached``.  (d) An engine armed with
   ``TRINO_TPU_STALL_S=0.05``: the test hook holds one host read of a warm
   Q1 for 0.5 s; ``health()`` reads "stalled" at that site, a stall event
   lands in the recorder, ``health()`` is "ok" after.  (e) A child process
   runs bench.py's five into a disk ring and is killed with SIGKILL;
   ``read_flight_dir`` reads the five records back.  (f) ``hash_insert_``,
   ``hash_probe`` and ``compact_rows`` against their plain versions at the
   phase's largest and most frequent shapes.  (g) The in-flight registry's
   host cost on the main path: a timed loop of ``INFLIGHT.enter``/``exit``
   pairs against no-op stand-ins, the entries each of bench.py's five and
   of a T1-T6 hit makes, and their warm walls with the registry live and
   stubbed out, in turns (``InflightStub``).  ``by_path`` gains
   ``flight_sf1``: the launches of 15a's statements on the recorder's
   engine.
16. Memory-bounded execution (``spill_path``; the tiers and the advisor
   off, as phase 2 ran; spill files in a temporary directory the phase
   removes).  (a) ``chaos_matrix.PRESSURE``'s eight scenarios over SF1
   orders in ``SPILL_SPLIT_ROWS`` (65,536) rows a split (1.5M groups
   against a 512 KiB pool: Grace aggregation over the
   device, host, disk and mixed tiers, a denied device tier, a write error,
   a full disk and a denied read), each held against the unconstrained card
   run or to its typed error, the leak check after each.  (b) Q18 at SF1
   (``SPILL_SPLIT_ROWS`` rows a split) under a 1 MiB pool, a 96 KiB host
   watermark and a 128 KiB buffer pool: the device, host and disk tiers all
   take bytes, the result byte-identical to the unconstrained card run and
   equal to phase 2's (the port's CPU result); Q18 at SF10 under a 256 MiB
   pool (device and host tiers) against the unconstrained SF10 run.
   (c) The reference's at-scale test at full size: SF34 orders grouped by
   ``o_orderkey`` under the default pool, 51,000,000 groups (1.5x
   ``MAX_GROUP_CAPACITY``), counts exactly ``(51000000, 51000000)``, at least
   four partitions and spilled bytes.  (d) orders joined with lineitem at
   SF10 by ``o_orderpriority``, and lineitem joined with partsupp on two
   keys (a hashed table, so the probe kernel runs), under a pool neither
   build fits (the partitioned join), each against its unconstrained run.
   (e) The admission
   rung: a hog past ``BLOCKED_FRACTION`` on the engine's pool queues a
   second statement, which completes once the hog is freed with
   ``admission_queued`` 1.  (f) ``hash_insert_``, ``hash_probe`` and
   ``compact_rows`` against their plain versions at the phase's largest and
   most frequent shapes.  Per step: the wall, peak device memory, bytes and
   host seconds per tier (write and readback GB/s) and the forced wall over
   the unconstrained one.  ``by_path`` gains ``spill_sf1``: the launches of
   the forced runs.
17. The fault injector at the port's local chokepoints and the chaos matrix
   (``chaos_path``; the advisor off).  (a) ``chaos_matrix.SCENARIOS`` (cache
   checkout deny, cache store error, reservation deny, dispatch delay,
   dispatch error, generation error, fatal host read, H2D error) x
   ``chaos_matrix.QUERIES`` (q1, q3, q9, q18) at SF1 on one engine with the
   reference fixture's 6 GiB page tier (``CHAOS_PAGE_TIER``; a ``page_cache
   = false`` session for the generation and H2D classes): each scenario
   fires at least once; a recoverable one is byte-identical to the query's
   fault-free baseline on the engine, an unrecoverable one raises
   ``InjectedFaultError`` or ``FatalInjectedFaultError``; the leak check is
   clean and a fault-free rerun equals the baseline after each; per run the
   fires, wall and error type.  (b) ``RESULT_SCENARIOS`` over q1 and q3 on a
   result-enabled engine through ``run_result_scenario``.  (c) Faults that
   land on the spill readback's producer thread (``producer_faults``:
   ``spill_read`` and ``h2d``) on phase 16a's setup, the host tier forced
   and then the disk tier: each statement fails typed with
   ``faults_injected`` 1 charged to it, and no producer thread outlives
   it.  (d) An errored statement's flight record after a ``fatal`` at
   ``dispatch``, the ``/v1/metrics`` fault and retry series, EXPLAIN
   ANALYZE's ``N faults injected``.  (e) bench.py's five on an engine
   configured as phase 2's, the injector disarmed: launches, host reads and
   H2D bytes per query equal phase 2's; the host time of a disarmed
   ``maybe_inject`` call beside phase 3's wrapper host times.  (f)
   ``hash_insert_``, ``hash_probe`` and ``compact_rows`` against their plain
   versions at the phase's largest and most frequent shapes.  ``by_path``
   gains ``chaos_sf1``: the launches of 17a-17c.
18. The connectors past the generators (``federation_path``; the tiers
   and the advisor off).  (a) SF0.5 (``FED_SF``) orders and customer from
   the generator written into a sqlite file (dates as integer days, decimals as REAL, an
   index on each join key) by a child process beside the earlier phases
   (``ChildPass`` of ``fed_pass_child``, spawned at the top of ``main``),
   which also runs each ``FED_CPU`` statement on a CPU engine over that
   file; the load is timed there, out of every statement's wall.  A card
   engine reads it as catalog ``db`` (``DbapiConnector``) beside ``tpch``
   on the card.  (b) ``FED_Q3`` (TPC-H Q3 with orders from ``db``) and
   ``FED_RECONCILE`` (the remote copy against its source on two keys: every
   order matches, none differs), cold and warm, each equal to the CPU run;
   they must launch ``hash_insert_``, ``hash_probe`` and ``compact_rows``,
   and stage at least 8 bytes of every remote row to the card (the
   connector decodes on the host; the executor's producer copies).
   (c) ``FED_INDEX``: the index join looks up 188 customers' orders by
   key, ships only the matched rows, EXPLAIN ANALYZE shows ``[index lookup:
   188 keys]``, the rows equal the CPU's and the run with
   ``TRINO_TPU_INDEX_JOIN=0``.  (d) ``FED_TOPN`` ships at most 20 rows (tied
   dates held as multisets) and ``FED_JOIN_PUSH`` runs orders x customer
   inside sqlite with its key range (``c_custkey <= FED_JOIN_CUSTKEYS``,
   carried in the remote query), shipping only the orders sqlite counts in
   that range; both equal the CPU run.  (e) A blackhole table of 2^27
   rows in 2^22-row pages: count, min, max, sums and a group-by on
   ``id % 1000003`` against their oracles, and an INSERT of 1,048,576 rows
   swallowed and counted.  The file connectors need ``pyarrow``: without
   it they are named as skipped; with it, SF0.5 orders in Parquet, a
   partitioned Hive table and an ORC file are scanned on the card (their
   pages staged by the prefetch producer) against the CPU.  (f)
   ``hash_insert_``, ``hash_probe`` and ``compact_rows`` against their
   plain versions at the phase's largest and most frequent shapes.
   ``by_path`` gains ``federation_sf1``: the launches of 18b-18e.
19. The worker mesh (``distributed_path``; the tiers and the advisor off):
   ``execute_sql(..., distributed=True, mesh=worker_mesh(8))``, a virtual
   8-position mesh over the card (its first line names the positions and
   their distinct devices).  (a) The 16 ``DIST_QUERIES``
   (tests/test_distributed.py's) at SF1 in 2^18-row splits, cold and warm,
   each equal to the local card run at the same split size (ties on the
   ORDER BY columns as multisets); q1, q9 and q18 run no ``local``
   fragment; per query its ``exec_trace``, host reads, bytes read at each
   ``dist.*`` site, shard skew and peak device memory.  (b) bench.py's Q1,
   Q3, Q9 and Q18 at SF10 on ``worker_mesh(4)``, each equal to phase 4's
   local result, warm wall and lineitem rows/s beside phase 4's.  (c) The
   six ``chaos_matrix.DIST_SCENARIOS`` at SF1, each firing at least once,
   with the leak check and a fault-free rerun.  (d) ``hash_insert_``,
   ``hash_probe`` and ``compact_rows`` against their plain versions at the
   largest and most frequent shapes of (a) and (c).  ``by_path`` gains
   ``distributed_sf1``: the launches of 19a and 19c.
20. Fault-tolerant execution and the multi-process cluster
   (``cluster_path``; the tiers and the advisor off, the spool's frame codec
   ``CLUSTER_PAGE_CODEC``).  (a) bench.py's Q1, Q3, Q9 and Q18 with
   ``fault_tolerant=True`` at SF1 in 2^18-row splits, each equal to the
   local card run (warm walls, spool bytes, tasks); Q1 under injected
   TASK_FAILURE x2, TASK_GET_RESULTS_FAILURE and POST_COMMIT_FAILURE
   (attempts 3, 2, 1; no sum doubled); Q18's inner group-by under a pool
   that holds the first group table but not the grown one, its two-split
   partial tasks bisecting.  (b) A coordinator and ``CLUSTER_WORKERS``
   worker processes started as a user would (``python -m
   trino_tpu_torch.server.cluster``, no ``--device``: the card), each with
   ``CLUSTER_POOL_BYTES`` and ``CLUSTER_CACHE_BYTES``: bench.py's five at
   SF1 (its q3 and q9 are tests/test_cluster.py's join queries) and Q1, Q9
   at SF10, cold and warm, each equal to the local card run (SF10: phase
   4's results); per query its tasks, local fallbacks (0 for Q1, Q9, Q18),
   the merged and the workers' counters, spool bytes and the straggler
   record; the stream bytes served; every shipped fragment pickled with no
   tensor.  (c) One worker process killed by SIGKILL mid-Q9 (the query
   recovers), then on workers in this process: the ``task`` fault on Q9 and
   a dropped commit on Q1 (each retried, the leak report clean), an
   exhausted budget (the FTE executor raises, the cluster answers locally
   and records it).  (d) A point query alone and beside a long scan on a
   one-slot worker.  (e) The memory ladder: a blocked worker sheds its
   cache, the policy kills the hog (``QueryKilledError`` at its next
   reservation) while Q1 completes, a running query killed on every worker
   fails typed and is not rerun locally, ``cluster_memory()`` sums the
   nodes, a worker drains and leaves.  (f) ``hash_insert_``,
   ``hash_probe`` and ``compact_rows`` against their plain versions at the
   largest and most frequent shapes of the worker processes and this one.
   ``by_path`` gains ``cluster_sf1``: the launches of (b), from the merged
   counters (workers and coordinator).
21. Dispatch coalescing and the scan-fused runners (``coalesce_path``):
   bench.py's five at SF10 (``TpchConnector(sf=10, split_rows=1<<21)``,
   51 lineitem splits: lineitem is generated by order ranges), the tiers and the advisor off, in three modes
   (``COALESCE_MODES``): per-split (``TRINO_TPU_DISPATCH_BATCH=1``,
   ``TRINO_TPU_SCAN_FUSED=0``), coalesced (4, 0) and the defaults (4, fused
   on: CUDA graphs).  (a) Per query and mode the cold wall and the median of
   three warm walls, launches per kernel, host reads, ``coalesced_splits``,
   the fused runners that took the query, graph captures and replays, peak
   device memory and the fused cache's graph pool bytes; modes 2 and 3 equal
   mode 1 (ties on the ORDER BY columns as multisets), mode 2 reads the host
   and launches the port's kernels no more than mode 1 and less on every
   query whose per-split loop does either per split (Q3, Q9, Q18), else
   issues fewer device operations (Q1 and Q4: one read and no port kernel
   per scan at either width), mode 3 takes the fused grouped runner on Q1
   with a replay per lineitem split, and no warm run of mode 3 captures a
   graph.  (b) The card's busy share (profiler device time over wall) and
   device operations of one more warm run of Q1, Q3 and Q4 in each mode.  (c) Every fused scan of Q1 and Q3 at SF1, over its first
   split, replayed as a graph and run eagerly: integer state bit for bit
   (a hash table's groups as sets, its slots follow the claim races), DOUBLE
   within rtol 1e-9.  (d) ``hash_insert_``, ``hash_probe`` and
   ``compact_rows`` against their plain versions at the largest and most
   frequent shapes of (a)'s cold runs in the three modes (the coalesced
   groups and the graphs' bodies, up to 2^24-slot tables) and on SF10's own
   lineitem keys.  ``by_path`` gains ``coalesce_sf10``: the launches of (a)
   (a cold run's count includes the eager warm-up of each body it
   captures) and the checks of (d).

Modes: phases 2, 4, 5, 7, 11, 13-16 and 18-20 run at the defaults (dispatch
coalescing at 4 everywhere; the scan-fused runners on, the engine being on
the card).  Phases 6, 9 and 10 pin ``TRINO_TPU_SCAN_FUSED=0``: their
``*_REQUIRED`` kernel tables are recordings of the JAX reference's page-loop
path.  Phase 12 pins it too: it holds the page tier, which the fused runners
never read (they generate each split again on the card).  Phase 17 pins it
for 17a-17c, whose faults fire at the page loop's ``generate`` and ``h2d``
points; 17e runs at the defaults, as phase 2 did.  Every phase prints its
seconds on a line of its own.

It prints the card line, then one JSON line with every kernel's numbers, and
last ``{"ok": true, "device": {...}}``.  Without a card, or without the
package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
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

# phase 19: tests/test_distributed.py's QUERIES, as that file states them
# (tests/test_torch_distributed.py holds the two equal)
DIST_QUERIES = {
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
          and l_discount between 0.05 and 0.07 and l_quantity < 24""",
    "scan_filter": """
        select o_orderkey, o_totalprice from orders
        where o_orderdate >= date '1998-01-01' and o_custkey < 50
        order by o_orderkey limit 50""",
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
                             having sum(l_quantity) > 100)
          and c_custkey = o_custkey and o_orderkey = l_orderkey
        group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
        order by o_totalprice desc, o_orderdate limit 100""",
    "topn_stream": """
        select l_orderkey, l_extendedprice from lineitem
        order by l_extendedprice desc, l_orderkey limit 7""",
    "left_filter": """
        select count(*) c, sum(o_totalprice) sp from orders
        left join customer on o_custkey = c_custkey and c_acctbal > 5000""",
    "anti_empty": """
        select count(*) c from orders where o_custkey not in
        (select c_custkey from customer where c_acctbal > 99999999)""",
    "full_sort": """
        select o_orderkey, o_totalprice, o_orderdate from orders
        order by o_totalprice desc, o_orderkey""",
    "full_sort_dict": """
        select c_custkey, c_mktsegment from customer
        order by c_mktsegment, c_custkey desc""",
    "window_dist": """
        select o_custkey, o_orderkey, o_totalprice,
               row_number() over (partition by o_custkey order by o_totalprice desc,
                                  o_orderkey) rn,
               sum(o_totalprice) over (partition by o_custkey) tot,
               lag(o_orderkey) over (partition by o_custkey order by o_orderdate,
                                     o_orderkey) prev
        from orders order by o_custkey, o_orderkey""",
    "q4": """
        select o_orderpriority, count(*) as order_count from orders
        where o_orderdate >= date '1993-07-01'
          and o_orderdate < date '1993-07-01' + interval '3' month
          and exists (select 1 from lineitem where l_orderkey = o_orderkey
                      and l_commitdate < l_receiptdate)
        group by o_orderpriority order by o_orderpriority""",
    "var_global": """
        select var_pop(l_discount) v, stddev_samp(l_quantity) s,
               sum(l_tax) t from lineitem where l_orderkey < 1000""",
    "window_dist_frame": """
        select o_custkey, o_orderkey,
               sum(o_totalprice) over (partition by o_custkey
                 order by o_orderdate, o_orderkey
                 rows between 1 preceding and current row) s
        from orders order by o_custkey, o_orderkey""",
}
# each DIST_QUERIES statement's ORDER BY columns (held row by row, the rows
# tied on them as multisets); None: one row
DIST_ORDER_BY = {
    "q1": ("l_returnflag", "l_linestatus"), "q3": ("revenue", "o_orderdate"),
    "q5": ("revenue",), "q6": None, "scan_filter": ("o_orderkey",),
    "q9": ("nation", "o_year"), "q18": ("o_totalprice", "o_orderdate"),
    "topn_stream": ("l_extendedprice", "l_orderkey"), "left_filter": None,
    "anti_empty": None, "full_sort": ("o_totalprice", "o_orderkey"),
    "full_sort_dict": ("c_mktsegment", "c_custkey"),
    "window_dist": ("o_custkey", "o_orderkey"), "q4": ("o_orderpriority",),
    "var_global": None, "window_dist_frame": ("o_custkey", "o_orderkey"),
}
# the statements that must run no fragment locally (the north-star set of
# tests/test_distributed_hostfed.py)
DIST_NO_LOCAL = ("q1", "q9", "q18")
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
# phase 6: the scale at which the queries that run a Window, Union, Values or
# non-Sort Limit node are held against the CPU (on the 8-core host of an
# H100 machine their CPU runs took 111 s at SF1 and 12-35 s at SF0.25, so
# the script's time limit keeps them small; the card's SF1 runs keep their
# scale), and the split size of both sides there: small enough that
# store_sales spans several pages (two at SF0.1), so windows and streaming
# LIMITs are held across a page boundary as at SF1
TPCDS_SF_HELD = 0.1
TPCDS_SPLIT_HELD = 1 << 18
TPCDS_HELD_MIN_SPLITS = 2
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


def same_result(a, b, what, by_value=False, order_by=None):
    """Exact for integer/decimal/date/bool/string columns, rtol 1e-9 for DOUBLE.
    Strings compare as dictionary ids, or as their values with ``by_value``
    (results over two catalogs, whose dictionaries number them differently).
    Rows are held row by row, unless ``order_by`` names the columns the
    statement orders its rows by: then those columns are held row by row,
    and the rows tied on them (a run of equal keys) as multisets, since
    tied rows have no defined order in either package."""
    import numpy as np

    check(tuple(a.names) == tuple(b.names), f"{what}: column names differ")
    check(len(a) == len(b), f"{what}: {len(a)} rows vs {len(b)}")
    cols = []
    for name, t, ca, cb, da, db in zip(a.names, a.types, a.raw_columns, b.raw_columns,
                                       a.columns, b.columns):
        ca, cb = np.asarray(ca), np.asarray(cb)
        if t.is_string and by_value:
            ca = np.array([str(x) for x in list(da)], dtype=object)
            cb = np.array([str(x) for x in list(db)], dtype=object)
        cols.append((name, t, ca, cb))
    if order_by:
        check(set(order_by) <= set(a.names), f"{what}: order_by {order_by} not in the result")
        keys = [c for c in cols if c[0] in order_by]
        for name, t, ca, cb in keys:
            check(_same_column(t, ca, cb), f"{what}: order key {name} differs")
        n = len(a)
        brk = np.zeros(n, bool)
        brk[:1] = True
        for _, _, ca, _ in keys:
            brk[1:] |= ca[1:] != ca[:-1]
        run = np.cumsum(brk)
        ranks = [_sort_codes(ca, cb) for _, _, ca, cb in cols]
        # within each run, both sides in one canonical order of whole rows
        pa_ = np.lexsort([r[0] for r in reversed(ranks)] + [run])
        pb_ = np.lexsort([r[1] for r in reversed(ranks)] + [run])
        cols = [(name, t, ca[pa_], cb[pb_]) for name, t, ca, cb in cols]
    for name, t, ca, cb in cols:
        check(_same_column(t, ca, cb), f"{what}: column {name} differs")


def _same_column(t, ca, cb) -> bool:
    import numpy as np

    if ca.dtype == object or cb.dtype == object:
        return ca.shape == cb.shape and list(ca) == list(cb)
    if t.is_floating:
        return bool(np.allclose(ca, cb, rtol=1e-9, atol=0.0, equal_nan=True))
    return ca.shape == cb.shape and bool((ca == cb).all())


def _sort_codes(ca, cb):
    """Sortable codes of two columns, consistent across both (object
    columns by their strings' order)."""
    import numpy as np

    if ca.dtype != object and cb.dtype != object:
        return ca, cb
    _, inv = np.unique(np.array([str(x) for x in list(ca) + list(cb)]), return_inverse=True)
    return inv[:len(ca)], inv[len(ca):]


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
    lanes.  A host-decoding connector's page is staged to the card as the
    executor stages it."""
    import torch

    from trino_tpu_torch.exec.local_executor import _page_to_device
    from trino_tpu_torch.ops.hashing import pack_keys

    page = conn.generate(conn.splits(table)[0], [column])
    if getattr(conn, "HOST_DECODE", False):
        page = _page_to_device(page, torch.device(DEVICE), None)[0]
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
            if form == "in_place" and split.get("other_ops"):
                # a window that lost some of the setup's table fills reads
                # as fills the call made (4 of 20 at [2^23, 2^25] in one
                # run of phase 21 on an H100; the same shape was clean in
                # phase 20 of that run): measure again, once; an operation
                # the call really makes shows in both
                split = dict(device_split(fn, names, setup=setup),
                             first_other_ops=split["other_ops"])
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


def tpcds_cpu_child(out_path: str, threads: int, sf: float, split_rows: int) -> None:
    """Phase 5's CPU half: every corpus query on the CPU at ``sf`` in
    ``split_rows`` splits with ``threads`` torch intra-op threads, recording
    the plan node names each run executed (plan-time subqueries included);
    pickles {query: result}, {query: node names} and the seconds to
    ``out_path``."""
    import pickle

    import torch

    torch.set_num_threads(threads)
    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpcds import TpcdsConnector
    from trino_tpu_torch.connectors.tpcds_queries import corpus
    from trino_tpu_torch.exec import local_executor as LE

    t0 = time.perf_counter()
    cpu = Engine(device="cpu")
    cpu.register_catalog("tpcds", TpcdsConnector(sf=sf, split_rows=split_rows))
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

    results, nodes = {}, {}
    LE.LocalExecutor.execute = recording
    for q, sql in corpus().items():
        seen.clear()
        results[q] = cpu.execute_sql(sql, cpu.create_session("tpcds"))
        nodes[q] = set(seen)
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump({"results": results, "nodes": nodes,
                     "seconds": time.perf_counter() - t0, "threads": threads}, f)
    os.replace(tmp, out_path)


def tpcds_parity(card, ds_pass, queries):
    """Phase 5: every query on the card, each equal to the CPU's run, which
    ran in a child process beside the earlier phases (``ds_pass``:
    ``ChildPass`` of ``tpcds_cpu_child``).  Returns {query: set of plan node
    names the CPU run executed, plan-time subqueries included}."""
    got = {q: card.execute_sql(sql, card.create_session("tpcds"))
           for q, sql in queries.items()}
    rec, waited = ds_pass.join(CPU_PASS_TIMEOUT_S)
    check(set(rec["results"]) == set(queries), "tpcds: the CPU child ran another corpus")
    for q in queries:
        same_result(got[q], rec["results"][q], f"tpcds sf{TPCDS_SF_PARITY:g} {q} card vs CPU")
    print(f"tpcds sf{TPCDS_SF_PARITY:g}: {len(queries)} queries on the card equal the "
          f"port's CPU results (CPU {rec['seconds']:.1f} s at {rec['threads']} threads in "
          f"a child; the join waited {waited:.1f} s)", flush=True)
    return rec["nodes"]


def tpcds_main(card, held_card, cpu, queries, nodes, fact_rows):
    """Phase 6: every query at SF1 on the card (cold, warm, launches, host
    reads, peak memory); the queries that run a Window, Union, Values or
    non-Sort Limit node are held against the CPU at TPCDS_SF_HELD
    (``held_card`` and ``cpu``).  Returns (per-query results, launches of
    the SF1 run, launch shapes of the SF1 run)."""
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
    cpu_s = 0.0
    for q in held:
        res = held_card.execute_sql(queries[q], held_card.create_session("tpcds"))
        t0 = time.perf_counter()
        ref = cpu.execute_sql(queries[q], cpu.create_session("tpcds"))
        cpu_s += time.perf_counter() - t0
        same_result(res, ref, f"tpcds sf{TPCDS_SF_HELD:g} {q} card vs CPU")
    print(f"tpcds sf{TPCDS_SF_HELD:g}: {len(held)} queries with "
          f"{'/'.join(TPCDS_NEW_NODES)} equal the port's CPU results "
          f"(CPU {cpu_s:.1f} s): {' '.join(held)}", flush=True)
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


def memory_cpu_child(out_path: str, threads: int, sf: float) -> None:
    """Phase 8's CPU half: the refresh path's statements on the CPU at
    scale ``sf`` with ``threads`` torch intra-op threads; pickles each
    statement's affected-row count, MEMORY_QUERIES' results after RF2 (phase
    8's oracle) and the seconds to ``out_path``."""
    import pickle

    import torch

    torch.set_num_threads(threads)
    t0 = time.perf_counter()
    cpu, csess = memory_engine("cpu", sf)
    path = refresh_path(cpu.catalogs["tpch"].exact_row_count("orders"))
    rows = {}
    for step in ("load", "rf1", "rf2"):
        for label, sql in path[step]:
            res = cpu.execute_sql(sql, csess)
            rows[label] = None if res is None else int(res.columns[0][0])
    cpu.execute_sql(Q15_VIEW, csess)
    results = {q: cpu.execute_sql(ALL_QUERIES[q], csess) for q in MEMORY_QUERIES}
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump({"rows": rows, "results": results,
                     "seconds": time.perf_counter() - t0, "threads": threads}, f)
    os.replace(tmp, out_path)


def memory_path(tpch_ref, mem_pass):
    """Phase 8: TPC-H's refresh path at SF1 over the memory catalog on the
    card, then held against the same statements on the CPU, which ran in a
    child process beside the earlier phases (``mem_pass``: ``ChildPass`` of
    ``memory_cpu_child``).  ``tpch_ref`` holds phase 2's results of
    MEMORY_QUERIES over ``tpch``.  Returns (launches of the run, {kernel:
    checks at this path's shapes})."""
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
    cpu_rec, waited = mem_pass.join(CPU_PASS_TIMEOUT_S)
    for step in ("load", "rf1", "rf2"):
        for label, _ in path[step]:
            check(cpu_rec["rows"][label] == steps[label]["rows"],
                  f"{label}: the CPU's affected rows differ from the card's")
    for q in MEMORY_QUERIES:
        same_result(after_rf2[q]["result"], cpu_rec["results"][q],
                    f"memory after RF2 {q} card vs CPU")
    print(f"memory after RF2: {len(MEMORY_QUERIES)} queries equal the port's CPU run of "
          f"the sequence (CPU {cpu_rec['seconds']:.1f} s at {cpu_rec['threads']} threads "
          f"in a child; the join waited {waited:.1f} s)", flush=True)
    del cpu_rec

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


def functions_cpu_child(out_path: str, threads: int, sf: float, split_rows: int) -> None:
    """Phase 9b's CPU half: F1-F7 on the CPU at ``sf`` in ``split_rows``
    splits with ``threads`` torch intra-op threads; pickles {query: (result,
    seconds)} and the seconds to ``out_path``."""
    import pickle

    import torch

    torch.set_num_threads(threads)
    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector

    t0 = time.perf_counter()
    cpu = Engine(device="cpu")
    cpu.register_catalog("tpch", TpchConnector(sf=sf, split_rows=split_rows))
    out = {}
    for q, sql in FUNCTIONS.items():
        t1 = time.perf_counter()
        out[q] = (cpu.execute_sql(sql, cpu.create_session("tpch")), time.perf_counter() - t1)
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump({"results": out, "seconds": time.perf_counter() - t0,
                     "threads": threads}, f)
    os.replace(tmp, out_path)


def functions_main(tpch, fn_pass):
    """Phase 9b: F1-F7 at SF1 on the card (cold, warm, launches, host reads,
    peak memory); FUNCTIONS_REQUIRED; each kernel the path launched against
    its plain version at the path's shapes; then each query held against
    the port's CPU run, made in a child process beside the earlier phases
    (``fn_pass``: ``ChildPass`` of ``functions_cpu_child``).  Returns
    (launches of the run, {kernel: checks})."""
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
    rec, waited = fn_pass.join(CPU_PASS_TIMEOUT_S)
    for q in FUNCTIONS:
        ref, cpu_s = rec["results"][q]
        same_result(got[q]["result"], ref, f"functions sf{SF_MAIN:g} {q} card vs CPU")
        check(len(ref) > 0, f"functions {q} returned no rows")
        print(f"functions sf{SF_MAIN:g} {q}: equal to the port's CPU result ({len(ref)} "
              f"rows, CPU {cpu_s:.2f} s)", flush=True)
    print(f"functions CPU pass: {rec['seconds']:.1f} s at {rec['threads']} threads in a "
          f"child; the join waited {waited:.1f} s", flush=True)
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


def functions_path(fn_pass):
    """Phase 9: the function library's path (``fn_pass``: the child
    process of 9b's CPU half).  Returns (launches of 9b, {kernel: checks at
    its shapes})."""
    from trino_tpu_torch.connectors.tpch import TpchConnector

    t0 = time.perf_counter()
    functions_parity()
    launches, checks = functions_main(TpchConnector(sf=SF_MAIN, split_rows=SPLIT_ROWS),
                                      fn_pass)
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


def nested_columns(engine, sess):
    """``orders_nested``'s columns from ``engine``'s TPC-H orders and
    lineitem (host lists), and the line-item count."""
    li = engine.execute_sql("select l_orderkey, l_linenumber, l_partkey, l_suppkey, "
                            "l_shipmode from tpch.lineitem", sess)
    od = engine.execute_sql("select o_orderkey, o_custkey, o_orderdate from tpch.orders", sess)
    return nested_orders(od.raw_columns, [li.raw_columns[i] for i in range(4)]
                         + [li.columns[4]]), len(li)


def arrays_cpu_child(out_path: str, threads: int, sf: float, sf_all_rows: float) -> None:
    """Phase 10b's CPU half: ``orders_nested`` built on the CPU at ``sf``
    (from the CPU's own generation, which equals the card's), A1-A6 over it,
    and A7 at ``sf_all_rows``, with ``threads`` torch intra-op threads;
    pickles {query: (result, seconds)} and the seconds to ``out_path``."""
    import pickle

    import torch

    torch.set_num_threads(threads)
    t0 = time.perf_counter()
    cpu, sess = memory_engine("cpu", sf)
    columns, _ = nested_columns(cpu, sess)
    build_nested(cpu, sess, columns)
    del columns
    out = {}
    for q, sql in ARRAYS.items():
        t1 = time.perf_counter()
        out[q] = (cpu.execute_sql(sql, sess), time.perf_counter() - t1)
    del cpu
    cpu, sess = memory_engine("cpu", sf_all_rows)
    for q, sql in ARRAYS_ALL_ROWS.items():
        t1 = time.perf_counter()
        out[q] = (cpu.execute_sql(sql, sess), time.perf_counter() - t1)
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump({"results": out, "seconds": time.perf_counter() - t0,
                     "threads": threads}, f)
    os.replace(tmp, out_path)


def arrays_main(ar_pass):
    """Phase 10b: ``orders_nested`` built at SF1 on the card (timed on its
    own), A1-A6 on the card (cold, warm, launches, host reads, H2D bytes,
    peak memory), ARRAYS_REQUIRED, A1 against its lineitem oracle, the
    kernels the path launched against their plain versions at its shapes,
    then A1-A6 against the port's CPU run at SF1 and A7 at
    ARRAYS_SF_ALL_ROWS on the card against the CPU; the CPU runs are made in
    a child process beside the earlier phases (``ar_pass``: ``ChildPass`` of
    ``arrays_cpu_child``).  Returns (launches of A1-A7, {kernel: checks})."""
    import numpy as np
    import torch

    from trino_tpu_torch.ops import cuda_kernels as ck

    card, sess = memory_engine(DEVICE, SF_MAIN)
    t0 = time.perf_counter()
    columns, n_items = nested_columns(card, sess)
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
    del columns
    rec, waited = ar_pass.join(CPU_PASS_TIMEOUT_S)
    for q, sql in ARRAYS.items():
        ref, cpu_s = rec["results"][q]
        same_outcome_result(got[q]["result"], ref, sql, f"arrays sf{SF_MAIN:g} {q} card vs CPU")
        check(len(got[q]["result"]) > 0, f"arrays {q} returned no rows")
        print(f"arrays sf{SF_MAIN:g} {q}: equal to the port's CPU result "
              f"({len(got[q]['result'])} rows, CPU {cpu_s:.2f} s)", flush=True)
    for q, sql in ARRAYS_ALL_ROWS.items():
        same_outcome_result(got[q]["result"], rec["results"][q][0], sql,
                            f"arrays sf{ARRAYS_SF_ALL_ROWS:g} {q} card vs CPU")
        check(len(got[q]["result"]) > 0, f"arrays {q} returned no rows")
    print(f"arrays CPU pass: {rec['seconds']:.1f} s at {rec['threads']} threads in a "
          f"child; the join waited {waited:.1f} s", flush=True)
    del card, small
    torch.cuda.empty_cache()
    return launches, {k: {"max_abs_err": r["max_abs_err"], "shapes": r["shapes"]}
                      for k, r in checks.items()}


def arrays_path(ar_pass):
    """Phase 10: arrays, maps, UNNEST and MATCH_RECOGNIZE (``ar_pass``: the
    child process of 10b's CPU half).  Returns (launches of 10b, {kernel:
    checks at its shapes})."""
    t0 = time.perf_counter()
    arrays_parity()
    launches, checks = arrays_main(ar_pass)
    print(f"arrays path: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, checks


# -- phase 11: the coordinator entry point, TPC-H SF1 over the statement protocol --------
# the kernels each query must launch through the server: those phase 2
# requires of it (REQUIRED)
SERVER_REQUIRED = REQUIRED
SERVER_CLIENTS = 4
# 11c's extract: 300,000 of SF1's 1.5M orders (the generated keys are dense;
# from a server over an H100 engine the pull runs 58-92K rows/s at the
# client, so the whole table took 41 s)
BIG_RESULT = ("select o_orderkey, o_custkey, o_orderstatus, o_totalprice, o_orderdate "
              "from orders where o_orderkey <= 300000")
SPOOL_THRESHOLD = 10_000
VERIFIER_SF = 0.05  # 11e: its control runs the port on the CPU (~22 s at SF0.1)
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
        # the serial baseline is a warm run: a cold statement also counts
        # the eager warm-up of each scan-fused body it captures (and a plan
        # the advisor corrects captures again)
        for _ in range(4):
            client.execute(QUERIES[q])
            if statement_counters(engine, QUERIES[q])["graph_captures"] == 0:
                break
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
    """11c: 300,000 rows of SF1 orders pulled inline (pages of
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


# -- phase 12: the plan cache and the device buffer pool at SF1 ---------------------------
CACHE_EVICT_BUDGET = 1 << 30  # 12b: the page tier's budget under pressure
CACHE_RESULT_BUDGET = 256 << 20  # 12c: TRINO_TPU_RESULT_CACHE
CACHE_COUNTERS = ("page_cache_hits", "page_cache_misses", "page_cache_bytes_saved",
                  "build_cache_hits", "build_cache_misses", "build_cache_bytes_saved",
                  "result_cache_hits", "result_cache_misses", "result_cache_bytes_saved")
# 12d: TPC-H orders copied into the memory catalog, one read, and three writes
CACHE_CTAS = "create table o as select * from tpch.orders"
CACHE_READ = ("select o_orderstatus, count(*) c, sum(o_totalprice) s, max(o_orderkey) mk "
              "from o group by o_orderstatus order by o_orderstatus")
CACHE_WRITES = (
    ("insert", "insert into o select * from tpch.orders where o_orderkey < 1000"),
    ("delete", "delete from o where o_orderkey % 7 = 3"),
    ("update", "update o set o_totalprice = o_totalprice * 2 where o_orderstatus = 'P'"),
)
CACHE_VOLATILE = "select n_name, now() t from nation"


def counted_builds():
    """Count the calls of the executor's two hashed join builds
    (``build_insert``, ``multi_build``) and the hash_insert launches they
    make.  Returns (the counts, a function that undoes the wrapping)."""
    import trino_tpu_torch.exec.local_executor as LE
    from trino_tpu_torch.ops import cuda_kernels as ck

    counts = {"calls": 0, "hash_insert": 0}
    saved = {name: getattr(LE, name) for name in ("build_insert", "multi_build")}

    def wrap(real):
        def counted(*a, **k):
            before = ck.STATS["hash_insert"].launches
            try:
                return real(*a, **k)
            finally:
                counts["calls"] += 1
                counts["hash_insert"] += ck.STATS["hash_insert"].launches - before
        return counted

    for name, real in saved.items():
        setattr(LE, name, wrap(real))
    return counts, lambda: [setattr(LE, n, f) for n, f in saved.items()]


def launch_counts():
    from trino_tpu_torch.ops import cuda_kernels as ck

    return {k: s.launches for k, s in ck.STATS.items()}


class OwnLaunches:
    """Launches and launch shapes of one engine's own calls.  Each region
    counts from zero (``reset_stats`` just before it) and is read just
    after, so what other engines launch between the regions is left out."""

    def __init__(self):
        from trino_tpu_torch.ops import cuda_kernels as ck

        self.launches = {k: 0 for k in ck.STATS}
        self.shapes = {k: [] for k in ck.STATS}

    @contextlib.contextmanager
    def region(self):
        from trino_tpu_torch.ops import cuda_kernels as ck

        ck.reset_stats()
        try:
            yield
        finally:
            for k, s in ck.STATS.items():
                self.launches[k] += s.launches
                self.shapes[k].extend(s.shapes)


def cache_pass(engine, label, phase2, builds):
    """12a: the 22 queries once, each equal to phase 2's result.  Per query:
    wall, launches per kernel, H2D bytes and host reads, the pool's hits,
    misses and bytes saved, the planner span's milliseconds and the hashed
    join builds that ran."""
    import torch

    out = {}
    for q, sql in ALL_QUERIES.items():
        before, b0 = launch_counts(), dict(builds)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.execute_sql(sql, engine.create_session("tpch"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        same_result(res, phase2[q], f"cache {label} {q} vs phase 2")
        c = engine.last_query_counters
        planner = [s["duration_s"] for s in engine.last_query_trace["spans"]
                   if s["name"] == "planner"]
        after = launch_counts()
        rec = {"wall_s": wall, "launches": {k: after[k] - before[k] for k in after
                                            if after[k] > before[k]},
               "h2d_bytes": c["h2d_bytes"], "host_reads": c["host_reads"],
               **{k: c[k] for k in CACHE_COUNTERS},
               "planned": bool(planner), "planner_ms": 1e3 * sum(planner),
               "build_calls": builds["calls"] - b0["calls"],
               "build_inserts": builds["hash_insert"] - b0["hash_insert"]}
        out[q] = rec
        print(f"cache {label} {q}: wall_s={wall} launches={rec['launches']} "
              f"h2d_bytes={rec['h2d_bytes']} host_reads={rec['host_reads']} "
              f"page hits/misses/saved={rec['page_cache_hits']}/{rec['page_cache_misses']}/"
              f"{rec['page_cache_bytes_saved']} build hits/misses/saved="
              f"{rec['build_cache_hits']}/{rec['build_cache_misses']}/"
              f"{rec['build_cache_bytes_saved']} planner_ms={rec['planner_ms']} "
              f"build_calls={rec['build_calls']} build_inserts={rec['build_inserts']}",
              flush=True)
    return out


def pool_line(engine, what):
    """The pool's resident bytes against its budget, beside the card's peak
    and reserved memory."""
    import torch

    info = engine.buffer_pool.info()
    line = {"what": what, "device_bytes": info["device_bytes"],
            "budget_bytes": engine.buffer_pool.budget(), "entries": info["entries"],
            "evictions": info["evictions"],
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "memory_reserved": torch.cuda.memory_reserved()}
    print(f"cache pool {what}: resident {line['device_bytes']} of {line['budget_bytes']} "
          f"bytes in {line['entries']} entries, {line['evictions']} evictions; "
          f"max_memory_allocated {line['max_memory_allocated']} "
          f"memory_reserved {line['memory_reserved']}", flush=True)
    return line


def cache_eviction(engine, phase2):
    """12b: the 22 queries again over a page tier of CACHE_EVICT_BUDGET:
    results equal phase 2's, the pool evicts, and its resident bytes never
    pass the budget."""
    from trino_tpu_torch.execution.bufferpool import DeviceBufferPool

    engine.buffer_pool.clear()
    engine.buffer_pool = bp = DeviceBufferPool(budget_bytes=CACHE_EVICT_BUDGET,
                                               device=engine.device)
    most = 0
    for q, sql in ALL_QUERIES.items():
        res = engine.execute_sql(sql, engine.create_session("tpch"))
        same_result(res, phase2[q], f"cache eviction {q} vs phase 2")
        most = max(most, bp.info()["device_bytes"])
        check(bp.info()["device_bytes"] <= CACHE_EVICT_BUDGET,
              f"cache eviction {q}: {bp.info()['device_bytes']} resident bytes past "
              f"the budget {CACHE_EVICT_BUDGET}")
    check(bp.evictions > 0, "cache eviction: a 1 GiB page tier evicted nothing")
    line = pool_line(engine, "12b")
    line["most_resident_bytes"] = most
    return line


def result_hit_counts(engine, sql, sess, what):
    """A statement the result tier must answer: no launch, no host read, no
    H2D byte, one hit."""
    before = launch_counts()
    res = engine.execute_sql(sql, sess)
    c = engine.last_query_counters
    check(launch_counts() == before, f"{what}: a result-tier hit launched a kernel")
    check(c["result_cache_hits"] == 1 and c["result_cache_misses"] == 0
          and c["launches"] == {} and c["host_reads"] == 0 and c["h2d_bytes"] == 0,
          f"{what}: a result-tier hit counted {c}")
    return res


def cache_results(engine, phase2):
    """12c: bench.py's five with a CACHE_RESULT_BUDGET result tier: a miss
    stores, the hit equals it and counts nothing; ``now()`` never enters."""
    from trino_tpu_torch.execution.bufferpool import DeviceBufferPool

    os.environ["TRINO_TPU_RESULT_CACHE"] = str(CACHE_RESULT_BUDGET)
    try:
        engine.buffer_pool.clear()
        engine.buffer_pool = bp = DeviceBufferPool(device=engine.device)
        check(bp.result_budget() == CACHE_RESULT_BUDGET, "cache results: the tier's budget")
    finally:
        os.environ.pop("TRINO_TPU_RESULT_CACHE")
    out = {}
    for q, sql in QUERIES.items():
        sess = engine.create_session("tpch")
        t0 = time.perf_counter()
        miss = engine.execute_sql(sql, sess)
        miss_s = time.perf_counter() - t0
        check(engine.last_query_counters["result_cache_misses"] == 1,
              f"cache results {q}: the first run was no miss of the tier")
        same_result(miss, phase2[q], f"cache results {q} miss vs phase 2")
        t0 = time.perf_counter()
        hit = result_hit_counts(engine, sql, sess, f"cache results {q}")
        hit_s = time.perf_counter() - t0
        same_result(hit, miss, f"cache results {q} hit vs miss")
        out[q] = {"miss_s": miss_s, "hit_s": hit_s,
                  "bytes_saved": engine.last_query_counters["result_cache_bytes_saved"]}
        print(f"cache results {q}: miss_s={miss_s} hit_s={hit_s} "
              f"bytes_saved={out[q]['bytes_saved']}", flush=True)
    sess = engine.create_session("tpch")
    for _ in range(2):
        engine.execute_sql(CACHE_VOLATILE, sess)
        c = engine.last_query_counters
        check(c["result_cache_hits"] == 0 and c["result_cache_misses"] == 0,
              "cache results: now() entered the result tier")
    return out


def orders_oracle(keys, status, price):
    """CACHE_READ over host arrays: (status, count, raw sum, max key) per
    status, in status order."""
    out = []
    for s in sorted(set(status.tolist())):
        m = status == s
        out.append((s, int(m.sum()), int(price[m].sum()), int(keys[m].max())))
    return out


def cache_invalidation(engine):
    """12d: a memory copy of orders read twice (the second read a hit), then
    INSERT, DELETE and UPDATE: after each, every tier is empty, the read
    misses and returns the new rows, its repeat hits, and the rows equal a
    numpy oracle over the same writes applied to the orders the card
    returned."""
    import numpy as np

    from trino_tpu_torch.connectors.memory import MemoryConnector

    engine.register_catalog("memory", MemoryConnector())
    sess = engine.create_session("memory")
    base = engine.execute_sql("select o_orderkey, o_orderstatus, o_totalprice from tpch.orders",
                              engine.create_session("tpch"))
    keys = np.asarray(base.raw_columns[0]).astype(np.int64)
    status = np.asarray([str(v) for v in base.columns[1]], dtype=object)
    price = np.asarray(base.raw_columns[2]).astype(np.int64)
    t0 = time.perf_counter()
    engine.execute_sql(CACHE_CTAS, sess)
    steps = {"ctas_s": time.perf_counter() - t0}

    def read(what):
        res = engine.execute_sql(CACHE_READ, sess)
        c = engine.last_query_counters
        check(c["result_cache_hits"] == 0 and c["result_cache_misses"] == 1
              and c["page_cache_hits"] == 0 and c["build_cache_hits"] == 0,
              f"cache invalidation {what}: the read after the write hit a tier: {c}")
        same_result(result_hit_counts(engine, CACHE_READ, sess, f"cache invalidation {what}"),
                    res, f"cache invalidation {what} hit vs miss")
        got = [(str(s), int(n), int(t), int(k)) for s, n, t, k in zip(
            res.columns[0], res.raw_columns[1], res.raw_columns[2], res.raw_columns[3])]
        want = orders_oracle(keys, status, price)
        check(got == want, f"cache invalidation {what}: {got} vs the oracle's {want}")
        print(f"cache invalidation {what}: {got} equal the oracle's", flush=True)
        return got

    prev = read("ctas")
    for label, sql in CACHE_WRITES:
        t0 = time.perf_counter()
        engine.execute_sql(sql, sess)
        steps[f"{label}_s"] = time.perf_counter() - t0
        check(engine.buffer_pool.info()["entries"] == 0 and not engine._plan_cache,
              f"cache invalidation {label}: a cache survived the write")
        if label == "insert":
            m = keys < 1000
            keys, status, price = (np.concatenate([a, a[m]]) for a in (keys, status, price))
        elif label == "delete":
            m = keys % 7 != 3
            keys, status, price = keys[m], status[m], price[m]
        else:
            price = np.where(status == "P", price * 2, price)
        got = read(label)
        check(got != prev, f"cache invalidation {label}: the write changed no row the read sees")
        prev = got
    return steps


def cache_path(phase2):
    """Phase 12: the plan cache and the buffer pool at their defaults on one
    card, the adaptive advisor off (``TRINO_TPU_ADAPTIVE=0``, set in
    ``main``): pass 2 holds that a warm repeat plans nothing, and the
    advisor's re-plans of a repeat are phase 14e's, where every default
    holds.  ``phase2``: phase 2's result of each of the 22 queries.  Returns
    (the record, launches of the phase, {kernel: checks at its shapes})."""
    import numpy as np
    import torch

    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.exec.local_executor import LocalExecutor
    from trino_tpu_torch.ops import cuda_kernels as ck
    from trino_tpu_torch.ops.hashing import pack_keys

    t_phase = time.perf_counter()
    # the defaults: the page tier at a quarter of the card's memory, the
    # result tier off
    os.environ.pop("TRINO_TPU_PAGE_CACHE", None)
    os.environ.pop("TRINO_TPU_RESULT_CACHE", None)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    conn = TpchConnector(sf=SF_MAIN, split_rows=SPLIT_ROWS)
    engine = Engine(device=DEVICE)
    engine.register_catalog("tpch", conn)
    engine.execute_sql(Q15_VIEW, engine.create_session("tpch"))
    _free, total = torch.cuda.mem_get_info()
    budget = engine.buffer_pool.budget()
    check(0 < budget <= total // 4, f"the page tier's default budget {budget} of {total}")
    li_rows = conn.exact_row_count("lineitem")
    rec = {"budget_bytes": budget, "total_bytes": total}
    launches = dict.fromkeys(ck.STATS, 0)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    builds, restore = counted_builds()
    try:
        ck.reset_stats()
        p1 = cache_pass(engine, "pass1", phase2, builds)
        add(launch_counts())
        ck.reset_stats()
        p2 = cache_pass(engine, "pass2", phase2, builds)
        add(launch_counts())
        shapes = {k: list(s.shapes) for k, s in ck.STATS.items()}
    finally:
        restore()
    check(sum(r["build_inserts"] for r in p1.values()) > 0,
          "cache pass1: no hashed join build launched hash_insert")
    for q, r in p2.items():
        check(not r["planned"], f"cache pass2 {q} planned again")
        check(r["page_cache_misses"] == 0 and r["page_cache_hits"] > 0,
              f"cache pass2 {q}: {r['page_cache_hits']} page hits, "
              f"{r['page_cache_misses']} misses")
        check(r["build_cache_misses"] == 0, f"cache pass2 {q}: a join built again")
        check(r["build_calls"] == 0 and r["build_inserts"] == 0,
              f"cache pass2 {q}: {r['build_inserts']} hash_insert launches for builds")
        check(r["h2d_bytes"] <= p1[q]["h2d_bytes"], f"cache pass2 {q}: more H2D bytes")
    rec["pass1"], rec["pass2"] = p1, p2
    rec["pool_12a"] = pool_line(engine, "12a")
    check(rec["pool_12a"]["device_bytes"] <= budget, "cache: the pool passed its budget")
    # 12e: a warm repeat plans nothing; the host time saved is the cold
    # planner span (plan-time subqueries included)
    for q in ALL_QUERIES:
        print(f"cache plan {q}: planner_ms saved {p1[q]['planner_ms']} "
              f"(pass1 wall_s {p1[q]['wall_s']}, pass2 wall_s {p2[q]['wall_s']})", flush=True)
    # 12f: a cached scan reaches the kernels as one page of the whole table
    whole = {k: sum(1 for s in v if s[0] == li_rows) for k, v in shapes.items()}
    check(any(whole.values()), f"cache pass2: no kernel launched at the whole lineitem "
          f"page of {li_rows} rows")
    rec["whole_page_launches"] = whole
    print(f"cache pass2: launches at the whole lineitem page ({li_rows} rows): {whole}",
          flush=True)

    before = launch_counts()
    rec["eviction"] = cache_eviction(engine, phase2)
    rec["results"] = cache_results(engine, phase2)
    rec["invalidation"] = cache_invalidation(engine)
    after = launch_counts()
    add({k: after[k] - before[k] for k in after})

    # the kernels at this path's shapes (pass 2's: whole-table pages), the
    # insert also on the whole cached lineitem's l_orderkey
    ex = LocalExecutor(engine.catalogs, DEVICE)
    page = ex._stage_scan_entry([conn.generate(s, ["l_orderkey"])
                                 for s in conn.splits("lineitem")])
    check(page.capacity == li_rows, f"the staged lineitem page holds {page.capacity} rows")
    packed, _ = pack_keys((page.columns[0],), (page.schema.fields[0].type,))
    gen = np.random.default_rng(29)
    checks = {"hash_insert": insert_checks(shapes["hash_insert"], (
                  "whole_lineitem_orderkey", packed, page.valid_mask()), gen),
              "compact_rows": compact_checks(shapes["compact_rows"], gen)}
    if shapes["hash_probe"]:
        checks["hash_probe"] = probe_checks(shapes["hash_probe"], gen)
    del page, packed, ex
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"cache path: {rec['seconds']:.1f} s, launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    print(json.dumps({"cache_sf1": rec}, default=str), flush=True)
    del engine, conn
    torch.cuda.empty_cache()
    return rec, launches, {k: {"max_abs_err": r["max_abs_err"], "shapes": r["shapes"]}
                           for k, r in checks.items()}


# -- phase 13: plan templates and the template batcher ---------------------------------
# one statement shape, new values on every request (a dashboard, an API backend)
TEMPLATES = {
    "t1": "select c_name, c_acctbal from customer where c_custkey = ?",
    "t2": "select c_custkey from customer where c_mktsegment = ? order by c_custkey limit 6",
    "t3": "select o_orderkey, o_totalprice, o_orderstatus from orders where o_custkey = ?",
    "t4": "select l_linenumber, l_quantity, l_extendedprice from lineitem where l_orderkey = ?",
    "t5": "select o_orderkey from orders where o_orderdate < ? order by o_orderkey limit 5",
    "t6": ("select c_custkey from customer where c_acctbal between ? and ? "
           "order by c_custkey limit 5"),
}
TEMPLATE_EXECUTES = 32
TEMPLATE_NULL_AT, TEMPLATE_OUTSIDE_AT = 5, 9  # which EXECUTE binds NULL, which a missing value
TEMPLATE_CPU_CHECKED = (0, 1, TEMPLATE_NULL_AT, TEMPLATE_OUTSIDE_AT)  # also held to the CPU
TEMPLATE_FUSED = (4, 16)  # fused window sizes of 13c
TEMPLATE_FUSED_STATEMENTS = ("t1", "t3", "t4")
TEMPLATE_SERVER_STATEMENTS = ("t3", "t4")
TEMPLATE_SERVER_CLIENTS = (1, 4, 16)
# requests per setting of 13d (200 before the 700 s budget of the whole script)
TEMPLATE_SERVER_REQUESTS = 64
TEMPLATE_SERVER_POOL = 50  # distinct bindings per statement in 13d
TEMPLATE_SERVER_POLL_S = 0.005  # the DB-API client's poll, so the engine and not the poll sets the rate
TEMPLATE_BIG_EXECUTES = 8  # 13e: bindings of T4 and T1 at SF10
# phase 11b's rate from four clients (bench.py's five queries at SF1) on an
# NVIDIA H100 80GB HBM3 at 700 W, as PERF.md §6 records it
PHASE11_FOUR_CLIENT_RATE = 3.1950313862430493
SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY")


def same_bytes(a, b, what):
    """Two port results equal byte for byte: names, types, each raw column's
    dtype and bytes (an object column's values), and the decoded values."""
    import numpy as np

    check(tuple(a.names) == tuple(b.names) and tuple(a.types) == tuple(b.types),
          f"{what}: names or types differ")
    for name, ra, rb, da, db in zip(a.names, a.raw_columns, b.raw_columns, a.columns,
                                    b.columns):
        ra, rb = np.asarray(ra), np.asarray(rb)
        same = list(ra) == list(rb) if ra.dtype == object else ra.tobytes() == rb.tobytes()
        check(ra.dtype == rb.dtype and ra.shape == rb.shape and same,
              f"{what}: raw column {name} differs")
        check([repr(x) for x in list(da)] == [repr(x) for x in list(db)],
              f"{what}: column {name} differs as decoded values")


def template_values(gen, name, n, sf):
    """``n`` bindings of statement ``name`` (tuples of python values, None
    for NULL) at scale ``sf``: at TEMPLATE_NULL_AT a NULL, at
    TEMPLATE_OUTSIDE_AT a value outside the table's domain, where the
    statement has one."""
    import datetime

    customers, orders = int(150_000 * sf), int(1_500_000 * sf)
    out = []
    for i in range(n):
        if name in ("t1", "t3"):
            v = (int(gen.integers(1, customers + 1)),)
            if name == "t1" and i == TEMPLATE_OUTSIDE_AT:
                v = (customers + 1 + int(gen.integers(0, 1000)),)
        elif name == "t2":
            v = (SEGMENTS[int(gen.integers(0, len(SEGMENTS)))],)
            if i == TEMPLATE_OUTSIDE_AT:
                v = ("no-such-segment",)
        elif name == "t4":
            v = (int(gen.integers(1, orders + 1)),)
            if i == TEMPLATE_OUTSIDE_AT:
                v = (orders + 1 + int(gen.integers(0, 1000)),)
        elif name == "t5":
            day = datetime.date(1992, 1, 1) + datetime.timedelta(days=int(gen.integers(0, 2400)))
            v = (day,)
        else:
            lo = int(gen.integers(-99_999, 900_000))
            v = (f"{lo / 100:.2f}", f"{(lo + int(gen.integers(0, 100_000))) / 100:.2f}")
        if i == TEMPLATE_NULL_AT:
            v = (None,) + v[1:]
        out.append(v)
    return out


def sql_literal(v) -> str:
    """A binding's SQL literal: decimals are given as text with two digits."""
    import datetime

    if v is None:
        return "null"
    if isinstance(v, datetime.date):
        return f"date '{v.isoformat()}'"
    if isinstance(v, str) and not v.lstrip("-").replace(".", "").isdigit():
        return "'" + v.replace("'", "''") + "'"
    return str(v)


def inline_sql(text, values) -> str:
    parts = text.split("?")
    check(len(parts) == len(values) + 1, f"{text}: {len(values)} values")
    return parts[0] + "".join(sql_literal(v) + p for v, p in zip(values, parts[1:]))


def counted_plans():
    """Count ``Planner.plan_query`` calls.  Returns (the counts, a function
    that undoes the wrapping)."""
    from trino_tpu_torch.sql import frontend

    counts = {"plans": 0}
    real = frontend.Planner.plan_query

    def counted(self, *a, **k):
        counts["plans"] += 1
        return real(self, *a, **k)

    frontend.Planner.plan_query = counted
    return counts, lambda: setattr(frontend.Planner, "plan_query", real)


def recorded_scans():
    """Record the split list of every scan the executor reads (a page
    source of ``_scan_pages_source`` when it is iterated), as (table, split
    lo's).  Returns (the list, a function that undoes the wrapping)."""
    from trino_tpu_torch.exec.local_executor import LocalExecutor

    seen = []
    real = LocalExecutor._scan_pages_source

    def recorded(self, conn, catalog, table, splits, columns):
        pages = real(self, conn, catalog, table, splits, columns)
        los = tuple(s.lo for s in splits)

        def read():
            seen.append((table, los))
            yield from pages()

        return read

    LocalExecutor._scan_pages_source = recorded
    return seen, lambda: setattr(LocalExecutor, "_scan_pages_source", real)


def timed_statement(engine, sql, sess, plans, **kw):
    """(result, record) of one statement: wall to a synchronized card, its
    template hits and misses, plan_query calls, whether a planner span
    opened, host reads, H2D bytes and launches."""
    import torch

    torch.cuda.synchronize()
    p0 = plans["plans"]
    t0 = time.perf_counter()
    res = engine.execute_sql(sql, sess, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = engine.last_query_counters
    spans = [x.get("name") for x in engine.last_query_trace.get("spans", ())]
    return res, {"wall_s": wall, "hits": c["plan_template_hits"],
                 "misses": c["plan_template_misses"], "plans": plans["plans"] - p0,
                 "planner_span": "planner" in spans, "host_reads": c["host_reads"],
                 "h2d_bytes": c["h2d_bytes"], "launches": sum(c["launches"].values()),
                 "batched_with": engine.last_batched_with}


def template_sessions(*engines):
    """A session per engine with the result tier off."""
    out = []
    for e in engines:
        s = e.create_session("tpch")
        e.execute_sql("set session result_cache = false", s)
        out.append(s)
    return out


def template_statements(engine, off, cpu, values, plans, label, inline, own):
    """13a (EXECUTE) and 13b (``inline``: the values in the text): each
    statement's requests on the templates engine and the templates-off one,
    byte-equal; the first a template miss, every later one a hit that plans
    nothing; TEMPLATE_CPU_CHECKED bindings also equal the CPU engine.  The
    templates engine's requests count their launches in ``own``."""
    from trino_tpu_torch.sql.params import parameterize_text

    st, so, sc = template_sessions(engine, off, cpu)
    rec = {}
    for name, text in TEMPLATES.items():
        vals = values[name]
        if inline:
            # a NULL literal changes the text's shape: it is not the same template
            idx = [i for i, v in enumerate(vals) if None not in v]
            stmts = {i: inline_sql(text, vals[i]) for i in idx}
            kw = {}
        else:
            idx = list(range(len(vals)))
            for e, sess in ((engine, st), (off, so), (cpu, sc)):
                e.execute_sql(f"prepare {name} from {text}", sess)
            stmts = {i: f"execute {name} using " + ", ".join(sql_literal(x) for x in vals[i])
                     for i in idx}
        reqs, subs, shapes = [], [], set()
        for i in idx:
            with own.region():
                res, r = timed_statement(engine, stmts[i], st, plans)
            want, w = timed_statement(off, stmts[i], so, plans)
            same_bytes(res, want, f"{label} {name} binding {i} vs templates off")
            # the shape a request templates under: an inline negative number
            # keeps its sign in the text, so it is a shape of its own
            shape = parameterize_text(stmts[i])[0] if inline else text
            if shape not in shapes:
                shapes.add(shape)
                check(r["misses"] == 1 and r["hits"] == 0,
                      f"{label} {name} binding {i}: the first request of its shape is not "
                      f"a template miss ({r})")
            else:
                check(r["hits"] == 1 and r["misses"] == 0 and r["plans"] == 0
                      and not r["planner_span"],
                      f"{label} {name} binding {i}: not a template hit that plans nothing ({r})")
            check(w["hits"] == 0 and w["misses"] == 0,
                  f"{label} {name}: the templates-off engine used a template")
            if i in TEMPLATE_CPU_CHECKED:
                same_result(res, cpu.execute_sql(stmts[i], sc),
                            f"{label} {name} binding {i} card vs CPU")
            reqs.append(r)
            subs.append(w)
        hits = [r for r in reqs if r["hits"]]
        rec[name] = {
            "requests": len(reqs), "shapes": len(shapes), "rows": len(res),
            "hit_wall_s": statistics.median(r["wall_s"] for r in hits),
            "miss_wall_s": reqs[0]["wall_s"],
            "substitution_wall_s": statistics.median(w["wall_s"] for w in subs[1:]),
            "host_reads": statistics.median(r["host_reads"] for r in hits),
            "substitution_host_reads": statistics.median(w["host_reads"] for w in subs[1:]),
            "h2d_bytes": statistics.median(r["h2d_bytes"] for r in hits),
            "substitution_h2d_bytes": statistics.median(w["h2d_bytes"] for w in subs[1:]),
            "launches": statistics.median(r["launches"] for r in hits),
            "substitution_launches": statistics.median(w["launches"] for w in subs[1:]),
            "plans_per_hit": max(r["plans"] for r in hits),
        }
        print(f"templates {label} {name}: {len(reqs)} requests in {len(shapes)} template(s), "
              f"hit wall_s "
              f"{rec[name]['hit_wall_s']} (miss {rec[name]['miss_wall_s']}), substitution "
              f"wall_s {rec[name]['substitution_wall_s']}; per request host_reads "
              f"{rec[name]['host_reads']} vs {rec[name]['substitution_host_reads']}, h2d_bytes "
              f"{rec[name]['h2d_bytes']} vs {rec[name]['substitution_h2d_bytes']}, launches "
              f"{rec[name]['launches']} vs {rec[name]['substitution_launches']}; no planner "
              f"span and 0 plan_query calls on every hit", flush=True)
    return rec


def fused_window(engine, text, leader, members):
    """One fused window: the leader runs and parks in LEADER_EXIT_HOOK until
    every member queued behind it; then (member results in order, records,
    wall from the release to the last member's answer)."""
    import threading

    import torch

    from trino_tpu_torch.execution import batcher as BA

    bt = engine.template_batcher
    key = engine._template_key(text, engine.create_session("tpch"))
    ready = threading.Event()
    out, recs, errors = [None] * len(members), [None] * len(members), []
    BA.LEADER_EXIT_HOOK = lambda k: ready.wait(120) if k == key else None

    def run(i, v):
        try:
            sess = engine.create_session("tpch")
            engine.execute_sql("set session result_cache = false", sess)
            res = engine.execute_sql(text, sess, parameters=list(v))
            if i is not None:
                out[i] = res
                recs[i] = {"batched_with": engine.last_batched_with,
                           **{k: engine.last_query_counters[k]
                              for k in ("host_reads", "batched_requests", "plan_template_hits")}}
        except Exception as e:  # noqa: BLE001 - reported by the check below
            errors.append(e)

    try:
        lead = threading.Thread(target=run, args=(None, leader))
        lead.start()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 60:
            with bt._lock:
                if key in bt._lanes and bt._lanes[key].busy:
                    break
            time.sleep(0.0005)
        threads = [threading.Thread(target=run, args=(i, v)) for i, v in enumerate(members)]
        for t in threads:
            t.start()
        while time.perf_counter() - t0 < 60:
            with bt._lock:
                if len(bt._lanes[key].queue) >= len(members):
                    break
            time.sleep(0.0005)
        t1 = time.perf_counter()
        ready.set()
        for t in threads:
            t.join(120)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        lead.join(120)
    finally:
        BA.LEADER_EXIT_HOOK = None
    check(not errors, f"fused window: {errors!r}")
    return out, recs, wall


def template_windows(engine, gen, scans):
    """13c: fused windows of TEMPLATE_FUSED sizes on T1, T3 and T4, each
    lane equal to its serial answer; T4's scans the union of its members'
    kept splits; a warm window of 4 within 2x one warm serial request's host
    reads."""
    import torch

    bt = engine.template_batcher
    rec = {}
    for name in TEMPLATE_FUSED_STATEMENTS:
        text = TEMPLATES[name]
        sess = template_sessions(engine)[0]
        for size in TEMPLATE_FUSED:
            vals = template_values(gen, name, size + 1, SF_MAIN)
            vals = [v if v[0] is not None else template_values(gen, name, 1, SF_MAIN)[0]
                    for v in vals]
            # serial answers and walls, the batcher off; the kept splits of each
            # (the leader's first)
            bt.enabled = False
            serial, walls, kept = [], [], []
            try:
                for v in vals:
                    torch.cuda.synchronize()
                    n0 = len(scans)
                    t0 = time.perf_counter()
                    serial.append(engine.execute_sql(text, sess, parameters=list(v)))
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                    kept.append([lo for tab, los in scans[n0:] for lo in los])
                serial_reads = engine.last_query_counters["host_reads"]
            finally:
                bt.enabled = True
            serial, walls = serial[1:], walls[1:]
            before = bt.info()
            n0 = len(scans)
            out, recs, wall = fused_window(engine, text, vals[0], vals[1:])
            fused_scans = [lo for tab, los in scans[n0:] for lo in los]
            after = bt.info()
            check(after["batches_total"] == before["batches_total"] + 1,
                  f"fused {name} x{size}: {after['batches_total'] - before['batches_total']} "
                  f"batches formed")
            for i, (got, want, r) in enumerate(zip(out, serial, recs)):
                same_bytes(got, want, f"fused {name} x{size} lane {i} vs its serial answer")
                check(r["batched_with"] == size and r["batched_requests"] == 1,
                      f"fused {name} x{size} lane {i}: {r}")
            reads = sum(r["host_reads"] for r in recs)
            union = sorted(set(lo for ks in kept[1:] for lo in ks))
            if name == "t4":
                # the leader's own scan comes first, then the window's, once
                # over each split of the union, in split order
                check(fused_scans == kept[0] + union,
                      f"fused t4 x{size}: scanned splits {fused_scans} vs the leader's "
                      f"{kept[0]} and the union {union} of its members' kept splits")
            if size == 4:
                check(0 < reads <= 2 * serial_reads,
                      f"fused {name} x4: {reads} host reads vs {serial_reads} for one request")
            rec[f"{name}_x{size}"] = {"wall_s": wall, "serial_walls_s": sum(walls),
                                      "host_reads": reads, "serial_host_reads": serial_reads,
                                      "kept_union": union if name == "t4" else None}
            print(f"templates fused {name} x{size}: window wall_s {wall} vs serial sum "
                  f"{sum(walls)} ({size} requests); host_reads {reads} vs one serial request's "
                  f"{serial_reads}; every lane equal to its serial answer"
                  + (f"; scanned the union of kept splits {union}" if name == "t4" else ""),
                  flush=True)
    info = bt.info()
    rec["batches_total"], rec["sizes"] = info["batches_total"], info["sizes"]
    print(f"templates fused: batches_total {info['batches_total']}, sizes {info['sizes']}",
          flush=True)
    return rec


def template_server(engine, gen):
    """13d: DB-API clients over a CoordinatorServer(dispatch_threads=4)
    send T3 and T4 with parameters, from 1, 4 and 16 clients, the batcher on
    and then off; every response equal to the direct answer."""
    import threading

    from trino_tpu_torch.server import CoordinatorServer, dbapi

    direct, pools = {}, {}
    sess = template_sessions(engine)[0]
    for name in TEMPLATE_SERVER_STATEMENTS:
        pools[name] = [v for v in template_values(gen, name, TEMPLATE_SERVER_POOL + 1, SF_MAIN)
                       if v[0] is not None][:TEMPLATE_SERVER_POOL]
        for v in pools[name]:
            direct[(name, v)] = json_rows(engine.execute_sql(TEMPLATES[name], sess,
                                                             parameters=list(v)))
    srv = CoordinatorServer(engine, port=0, dispatch_threads=4)
    srv.start()
    rec = {}
    try:
        for on in (True, False):
            engine.template_batcher.enabled = on
            for name in TEMPLATE_SERVER_STATEMENTS:
                for clients in TEMPLATE_SERVER_CLIENTS:
                    picks = [pools[name][int(i)] for i in
                             gen.integers(0, len(pools[name]), TEMPLATE_SERVER_REQUESTS)]
                    walls, errors = [], []

                    def run(share):
                        try:
                            conn = dbapi.connect(url=srv.url, catalog="tpch")
                            conn._client.poll_interval = TEMPLATE_SERVER_POLL_S
                            cur = conn.cursor()
                            for v in share:
                                t0 = time.perf_counter()
                                cur.execute(TEMPLATES[name], list(v))
                                got = [list(r) for r in cur.fetchall()]
                                walls.append(time.perf_counter() - t0)
                                if got != direct[(name, v)]:
                                    errors.append(f"{name} {v}: {got} vs {direct[(name, v)]}")
                        except Exception as e:  # noqa: BLE001 - reported below
                            errors.append(repr(e))

                    b0 = engine.template_batcher.info()["batches_total"]
                    threads = [threading.Thread(target=run, args=(picks[i::clients],))
                               for i in range(clients)]
                    t0 = time.perf_counter()
                    for t in threads:
                        t.start()
                    for t in threads:
                        t.join(600)
                    secs = time.perf_counter() - t0
                    check(not errors, f"server {name} x{clients} batcher "
                          f"{'on' if on else 'off'}: {errors[:3]}")
                    check(len(walls) == TEMPLATE_SERVER_REQUESTS, "a server request was lost")
                    walls.sort()
                    r = {"statements_per_s": len(walls) / secs, "seconds": secs,
                         "p50_s": walls[len(walls) // 2],
                         "p99_s": walls[min(len(walls) - 1, int(0.99 * len(walls)))],
                         "batches": engine.template_batcher.info()["batches_total"] - b0}
                    rec[f"{name}_c{clients}_{'on' if on else 'off'}"] = r
                    print(f"templates server {name}: {clients} clients, batcher "
                          f"{'on' if on else 'off'}: {r['statements_per_s']} statements/s, "
                          f"p50 {r['p50_s']} s, p99 {r['p99_s']} s, {r['batches']} batches; "
                          f"every response equal to the direct answer", flush=True)
    finally:
        engine.template_batcher.enabled = True
        srv.stop()
    for name in TEMPLATE_SERVER_STATEMENTS:
        four = rec[f"{name}_c4_off"]["statements_per_s"]
        print(f"templates server {name}: 4 clients, batcher off {four} statements/s against "
              f"phase 11b's {PHASE11_FOUR_CLIENT_RATE} (bench.py's five queries): "
              f"{'within' if 0.5 <= four / PHASE11_FOUR_CLIENT_RATE <= 2 else 'not within'} 2x",
              flush=True)
    return rec


def template_big(scans, plans):
    """13e: T4 and T1 at SF10 (lineitem not cut): one kept lineitem split per
    T4 binding, results equal to a templates-off card engine, warm walls."""
    import numpy as np
    import torch

    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector

    conn = TpchConnector(sf=SF_BIG, split_rows=SPLIT_ROWS)
    engine, off = Engine(device=DEVICE), Engine(device=DEVICE)
    off.plan_templates_enabled = False
    for e in (engine, off):
        e.register_catalog("tpch", conn)
    st, so = template_sessions(engine, off)
    gen = np.random.default_rng(13)
    rec = {"lineitem_rows": conn.exact_row_count("lineitem"),
           "lineitem_splits": len(conn.splits("lineitem"))}
    for name in ("t4", "t1"):
        vals = [v for v in template_values(gen, name, TEMPLATE_BIG_EXECUTES + 1, SF_BIG)
                if v[0] is not None][:TEMPLATE_BIG_EXECUTES]
        for e, sess in ((engine, st), (off, so)):
            e.execute_sql(f"prepare {name} from {TEMPLATES[name]}", sess)
        hits, subs, kept = [], [], []
        for k, v in enumerate(vals):
            stmt = f"execute {name} using {sql_literal(v[0])}"
            n0 = len(scans)
            res, r = timed_statement(engine, stmt, st, plans)
            read = [los for tab, los in scans[n0:] if tab == "lineitem"]
            want, w = timed_statement(off, stmt, so, plans)
            same_bytes(res, want, f"sf{SF_BIG:g} {name} {v} vs templates off")
            check(k == 0 or r["hits"] == 1, f"sf{SF_BIG:g} {name} {v}: not a template hit")
            if name == "t4":
                check(len(read) == 1 and len(read[0]) == 1,
                      f"sf{SF_BIG:g} t4 {v}: read lineitem splits {read}, not one")
                kept.append(read[0][0])
            if k:
                hits.append(r["wall_s"])
                subs.append(w["wall_s"])
        rec[name] = {"hit_wall_s": statistics.median(hits),
                     "substitution_wall_s": statistics.median(subs),
                     "kept_split_lo": kept or None}
        print(f"templates sf{SF_BIG:g} {name}: hit wall_s {rec[name]['hit_wall_s']}, "
              f"templates-off wall_s {rec[name]['substitution_wall_s']}"
              + (f"; one of {rec['lineitem_splits']} lineitem splits read per binding "
                 f"({rec['lineitem_rows']} rows)" if name == "t4" else ""), flush=True)
    del engine, off, conn
    torch.cuda.empty_cache()
    return rec


def templates_path():
    """Phase 13: plan templates and the template batcher on one card.
    Returns (the record, launches of the phase, {kernel: checks at its
    shapes})."""
    import numpy as np
    import torch

    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector

    t_phase = time.perf_counter()
    os.environ.pop("TRINO_TPU_PAGE_CACHE", None)
    os.environ.pop("TRINO_TPU_RESULT_CACHE", None)
    torch.cuda.empty_cache()
    conn = TpchConnector(sf=SF_MAIN, split_rows=SPLIT_ROWS)
    engine, off = Engine(device=DEVICE), Engine(device=DEVICE)
    off.plan_templates_enabled = False
    cpu = Engine(device="cpu")
    for e in (engine, off):
        e.register_catalog("tpch", conn)
    cpu.register_catalog("tpch", TpchConnector(sf=SF_MAIN, split_rows=SPLIT_ROWS))
    check(engine.plan_templates_enabled and engine.template_batcher.enabled,
          "templates or the batcher are off by default")
    gen = np.random.default_rng(13)
    values = {name: template_values(gen, name, TEMPLATE_EXECUTES, SF_MAIN)
              for name in TEMPLATES}
    plans, unplan = counted_plans()
    scans, unscan = recorded_scans()
    # the templates engine's own requests: 13a and 13b count each of its
    # requests, 13c and 13d run on it alone
    own = OwnLaunches()
    rec = {}
    try:
        rec["execute"] = template_statements(engine, off, cpu, values, plans, "13a", False,
                                             own)
        # 13b starts with no template and no plan in either engine: the
        # templates-off engine plans every new text, as 13a's substitution did
        for e in (engine, off):
            with e._plan_lock:
                e._template_cache.clear()
                e._plan_cache.clear()
        rec["inline"] = template_statements(engine, off, cpu, values, plans, "13b", True, own)
        del cpu
        with own.region():
            rec["fused"] = template_windows(engine, gen, scans)
            rec["server"] = template_server(engine, gen)
        del engine, off
        rec["sf10"] = template_big(scans, plans)
    finally:
        unplan()
        unscan()
    launches, shapes = own.launches, own.shapes
    check(launches["compact_rows"] > 0,
          "the templates engine's requests launched no compact_rows")
    # the template subset has no join and no group-by
    check(launches["hash_insert"] == 0 and launches["hash_probe"] == 0,
          f"the templates path launched a hash kernel: {launches}")
    checks = {"compact_rows": compact_checks(shapes["compact_rows"],
                                             np.random.default_rng(31))}
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"templates path: {rec['seconds']:.1f} s, launches of the templates engine's "
          f"own SF1 requests {launches}", flush=True)
    print(json.dumps({"templates_sf1": rec}, default=str), flush=True)
    torch.cuda.empty_cache()
    return rec, launches, {k: {"max_abs_err": r["max_abs_err"], "shapes": r["shapes"]}
                           for k, r in checks.items()}


# -- phase 14: per-node stats, plan history and adaptive execution at SF1 ---------------
# the opaque-predicate trick of tests/test_adaptive.py's JOIN_Q applied to a
# group-by: both conjuncts hold on every row, but the CBO prices each at a
# comparison's selectivity, so the group-by's input and groups are 16x and
# 4x under-estimated
_OPAQUE = "l_orderkey * 2 >= l_orderkey and l_linenumber + l_orderkey >= 0"
ADAPTIVE_PROBE = (f"select l_orderkey, sum(l_quantity) q from lineitem where {_OPAQUE} "
                  "group by l_orderkey")
# the same over an expression key, which has no static range: the group-by
# takes the hash path, so the advisor's capacity reaches hash_insert_ (the
# plain key's range makes the probe above a direct group-by)
ADAPTIVE_PROBE_HASH = (f"select l_orderkey * 2 k, sum(l_quantity) q from lineitem "
                       f"where {_OPAQUE} group by l_orderkey * 2")
# tests/test_adaptive.py's JOIN_Q: a join build the CBO under-estimates 16x
ADAPTIVE_JOIN = ("select count(*) from orders join customer "
                 "on o_custkey = c_custkey "
                 "where c_custkey * 2 >= c_custkey and c_nationkey + c_custkey >= 0")
# 14c: JOIN_Q's distribution thresholds, shrunk as tests/test_adaptive.py
# shrinks them, under the corrected build (150000 customers at SF1) and
# above nothing the uncorrected plan can use (its estimate is not confident)
ADAPTIVE_JOIN_THRESHOLDS = {"BROADCAST_ABS_CAP": 256, "PARTITIONED_JOIN_THRESHOLD": 1024}
DEFAULT_RUNS = 3  # 14e: runs of the 22 on one engine at its defaults, the advisor included
DEFAULT_TURNS = 2  # 14e: warm uncorrected and corrected runs of a re-planned query, in turns
HISTORY_TURNS = 2  # 14a: warm runs per setting, in turns (on, off, off, on)
HISTORY_TEMPLATE_HITS = 8  # 14a: template hits per statement and setting
RECORD_KEYS = ("op", "est_rows", "actual_rows", "unestimated", "splits")


def record_view(records):
    """Per node path, what two engines' history records of one statement
    must agree on: operator, CBO estimate, actual rows, the unestimated
    marker and split count."""
    return {p: {k: r.get(k) for k in RECORD_KEYS} for p, r in records.items()}


def record_diff(got, want):
    return {p: (got.get(p), want.get(p)) for p in sorted(set(got) | set(want))
            if got.get(p) != want.get(p)}


def stats_records(records):
    """The records of the nodes the executor's stats recorded (those EXPLAIN
    ANALYZE annotates), without the scan and build facts."""
    return {p: r for p, r in records.items() if not r.get("splits") and not r.get("build")}


def history_statement(engine, sql, sess, own=None):
    """(result, record) of one card statement: wall to a synchronized card,
    host reads, launches, ``hash_insert`` shapes and the advisor's counts,
    the launches counted from zero around it (and added to ``own``)."""
    import torch

    from trino_tpu_torch.ops import cuda_kernels as ck

    engine.last_plan_actuals = None
    with own.region() if own is not None else contextlib.nullcontext():
        ck.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.execute_sql(sql, sess)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: st.launches for k, st in ck.STATS.items()}
        inserts = [tuple(x) for x in ck.STATS["hash_insert"].shapes]
    c = engine.last_query_counters
    return res, {"wall_s": wall, "host_reads": c["host_reads"],
                 "device_dispatches": c["device_dispatches"], "launches": launches,
                 "insert_shapes": inserts, "replans": c["adaptive_replans"],
                 "holds": c["adaptive_holds"]}


def tierless_session(engine):
    """A session with the page and build tiers off, as the CPU engine runs:
    a build-tier hit skips its fragment, whose scans then record no split
    count (in the reference too), so records compare only tier for tier."""
    sess = engine.create_session("tpch")
    engine.execute_sql("set session page_cache = false", sess)
    return sess


def history_queries(engine, phase2, cpu_actuals, own):
    """14a: the 22 queries once with history on: each result equal to phase
    2's, and each node's history record equal to the port's CPU engine's for
    the same SQL in phase 2 (operator, estimate, actual rows, the
    unestimated marker, split counts), the page and build tiers off as
    there."""
    out = {}
    for q, sql in ALL_QUERIES.items():
        res, r = history_statement(engine, sql, tierless_session(engine), own)
        same_result(res, phase2[q], f"history {q} vs phase 2")
        check(engine.last_plan_actuals is not None, f"history {q}: no plan-history record")
        got, want = record_view(engine.last_plan_actuals["nodes"]), record_view(cpu_actuals[q])
        check(got == want, f"history {q}: records differ from the CPU engine's: "
                           f"{record_diff(got, want)}")
        out[q] = {"nodes": len(got), "cold_s": r["wall_s"]}
    print(f"history 14a: the 22 queries equal phase 2's; per-node records equal the CPU "
          f"engine's ({sum(x['nodes'] for x in out.values())} node records)", flush=True)
    return out


class HistorySwitch:
    """Turns an engine's plan history on and off between statements: off is
    the store ``TRINO_TPU_PLAN_HISTORY=0`` builds.  Times each call of the
    engine's ``_record_plan_history`` (collection, the batched read of the
    row counts, the store's merge) while on."""

    def __init__(self, engine):
        from trino_tpu_torch.execution.history import PlanHistoryStore

        self.engine, self.on_store = engine, engine.plan_history
        os.environ["TRINO_TPU_PLAN_HISTORY"] = "0"
        try:
            self.off_store = PlanHistoryStore()
        finally:
            os.environ.pop("TRINO_TPU_PLAN_HISTORY")
        check(self.on_store.enabled and not self.off_store.enabled,
              "TRINO_TPU_PLAN_HISTORY=0 did not turn the store off")
        self.record_s = []
        inner = engine._record_plan_history

        def timed(plan, ex):
            t0 = time.perf_counter()
            try:
                return inner(plan, ex)
            finally:
                if engine.plan_history is self.on_store:
                    self.record_s.append(time.perf_counter() - t0)

        engine._record_plan_history = timed

    def set(self, on: bool) -> None:
        self.engine.plan_history = self.on_store if on else self.off_store

    def close(self) -> None:
        self.set(True)
        del self.engine._record_plan_history


def history_cost(engine, switch, own):
    """14a: bench.py's five warm on one engine, history on and off in turns
    (on, off, off, on); host reads and launches per statement equal between
    the two; the seconds the history record took per statement."""
    sess = engine.create_session("tpch")
    out = {}
    for q, sql in QUERIES.items():
        walls = {True: [], False: []}
        rec = {}
        history_statement(engine, sql, sess)  # the tiers' first touch, untimed
        switch.record_s.clear()
        for _ in range(HISTORY_TURNS):
            for on in (True, False, False, True):
                switch.set(on)
                _, r = history_statement(engine, sql, sess, own if on else None)
                walls[on].append(r["wall_s"])
                rec[on] = r
        switch.set(True)
        for k in ("host_reads", "device_dispatches"):
            check(rec[True][k] == rec[False][k],
                  f"history cost {q}: {k} {rec[True][k]} with history vs {rec[False][k]}")
        out[q] = {"on_s": min(walls[True]), "off_s": min(walls[False]),
                  "record_s": statistics.median(switch.record_s),
                  "host_reads": rec[True]["host_reads"]}
        print(f"history 14a {q}: warm wall_s history on {out[q]['on_s']} off "
              f"{out[q]['off_s']} (min of {2 * HISTORY_TURNS} each, in turns); history "
              f"record {out[q]['record_s']} s a statement (median); host_reads "
              f"{rec[True]['host_reads']} both", flush=True)
    return out


def history_templates(engine, switch, own):
    """14a: phase 13's T1-T6 template hits on one engine, history on and off
    in turns: results byte-equal, host reads equal; the seconds the history
    record took per hit."""
    import numpy as np

    gen = np.random.default_rng(14)
    (sess,) = template_sessions(engine)
    plans = {"plans": 0}
    out = {}
    for name, text in TEMPLATES.items():
        vals = [v for i, v in enumerate(template_values(gen, name, TEMPLATE_EXECUTES, SF_MAIN))
                if i not in (TEMPLATE_NULL_AT, TEMPLATE_OUTSIDE_AT)][:HISTORY_TEMPLATE_HITS + 1]
        stmts = [f"execute {name} using " + ", ".join(sql_literal(x) for x in v) for v in vals]
        engine.execute_sql(f"prepare {name} from {text}", sess)
        engine.execute_sql(stmts[0], sess)  # the miss that creates the template
        walls = {True: [], False: []}
        switch.record_s.clear()
        for i, stmt in enumerate(stmts[1:]):
            # a binding's first request may read a split the page tier has
            # not seen (one more host read, to store it): untimed
            engine.execute_sql(stmt, sess)
            got = {}
            for on in ((True, False) if i % 2 == 0 else (False, True)):
                switch.set(on)
                with own.region() if on else contextlib.nullcontext():
                    res, r = timed_statement(engine, stmt, sess, plans)
                check(r["hits"] == 1, f"history templates {name}: not a template hit ({r})")
                walls[on].append(r["wall_s"])
                got[on] = (res, r)
            same_bytes(got[True][0], got[False][0], f"history templates {name} binding {i}")
            check(got[True][1]["host_reads"] == got[False][1]["host_reads"],
                  f"history templates {name}: host reads {got[True][1]['host_reads']} with "
                  f"history vs {got[False][1]['host_reads']}")
        switch.set(True)
        out[name] = {"hit_on_s": statistics.median(walls[True]),
                     "hit_off_s": statistics.median(walls[False]),
                     "record_s": statistics.median(switch.record_s),
                     "host_reads": got[True][1]["host_reads"]}
        print(f"history 14a {name}: template hit wall_s history on {out[name]['hit_on_s']} "
              f"off {out[name]['hit_off_s']} (median of {len(walls[True])}, in turns); "
              f"history record {out[name]['record_s']} s a hit (median); host_reads "
              f"{out[name]['host_reads']} both", flush=True)
    return out


def explain_lines(engine, sql, sess):
    return [r[0] for r in engine.execute_sql(f"explain analyze {sql}", sess).rows()]


def boundary_sums(lines, what):
    """Check that the per-operator ``[boundary: ...]`` records and the
    ``result:`` line sum to the run's ``Device boundary:`` totals."""
    import re

    total = next(x for x in lines if x.startswith("Device boundary:"))
    want = [int(x) for x in re.findall(r"(\d+) (?:dispatches|host transfers|bytes pulled)",
                                       total)]
    got = [0, 0, 0]
    for line in lines:
        for m in re.finditer(r"\[boundary: (\d+) dispatches, (\d+) transfers, (\d+) bytes\]",
                             line):
            got = [a + int(b) for a, b in zip(got, m.groups())]
        m = re.match(r"    result: (\d+) dispatches, (\d+) transfers, (\d+) bytes", line)
        if m:
            got = [a + int(b) for a, b in zip(got, m.groups())]
    check(got == want, f"{what}: boundary records sum to {got}, the run counts {want}")
    return want


def masked_plan_lines(lines):
    """EXPLAIN ANALYZE's plan lines and Misestimates line, each node's wall
    and boundary record masked."""
    import re

    out = []
    for line in lines:
        if line.startswith(("Adaptive:", "Wall breakdown:", "Device boundary:")):
            break
        line = re.sub(r"\[rows: (\d+), [0-9.]+ ms\]", r"[rows: \1]", line)
        out.append(re.sub(r" \[boundary: [^\]]*\]", "", line))
    return out


def history_explain(engine, cpu_actuals, own):
    """14b: EXPLAIN ANALYZE of bench.py's five and of ``select count(*) from
    nation`` on the card, the page and build tiers off.  Every node the run's stats recorded carries
    ``[rows: N, ms]``, N and the ``[est ... x actual ...]`` annotations
    equal the CPU engine's records of the same SQL (phase 2), the
    ``Misestimates:`` line equals the one those records give, and the
    boundary records sum to the run's totals.  Nation's text also equals
    the CPU engine's EXPLAIN ANALYZE, wall and boundary masked."""
    import re

    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.execution.history import misestimate
    from trino_tpu_torch.sql.planprinter import _misestimate_summary

    out = {}
    for q, sql in QUERIES.items():
        engine.last_plan_actuals = None
        with own.region():
            lines = explain_lines(engine, sql, tierless_session(engine))
        got, want = record_view(engine.last_plan_actuals["nodes"]), record_view(cpu_actuals[q])
        check(got == want, f"history explain {q}: the ANALYZE run's records differ from the "
                           f"CPU engine's: {record_diff(got, want)}")
        text = "\n".join(lines)
        recs = stats_records(cpu_actuals[q])
        rows = sorted(int(n) for n in re.findall(r"\[rows: (\d+), [0-9.]+ ms\]", text))
        check(rows == sorted(r["actual_rows"] for r in recs.values()),
              f"history explain {q}: [rows: N] {rows} vs the CPU engine's records")
        ests = sorted(re.findall(r"\[est ([0-9,]+) x actual ([0-9,]+) -> ([^\]]+)\]", text))
        want = []
        for r in recs.values():
            if r["est_rows"] is None:
                continue
            ratio, d = misestimate(r["est_rows"], r["actual_rows"])
            want.append((f"{int(r['est_rows']):,}", f"{r['actual_rows']:,}",
                         "on estimate" if d == "exact" else f"{ratio:.1f}x {d}"))
        check(ests == sorted(want), f"history explain {q}: estimates {ests} vs {sorted(want)}")
        mis = next((x for x in lines if x.startswith("Misestimates:")), "")
        want_mis = _misestimate_summary(
            {i: {"est_rows": r["est_rows"], "rows": r["actual_rows"], "path": p}
             for i, (p, r) in enumerate(recs.items()) if r["est_rows"] is not None}, {}, {})
        check(mis == want_mis, f"history explain {q}: {mis!r} vs {want_mis!r}")
        totals = boundary_sums(lines, f"history explain {q}")
        out[q] = {"annotated": len(rows), "estimates": len(ests), "misestimates": mis,
                  "boundary": totals}
        print(f"history 14b {q}: {len(rows)} breaker lines with [rows: N, ms], "
              f"{len(ests)} estimates, as the CPU engine's records; boundary sums = "
              f"{totals}; {mis or 'no Misestimates line'}", flush=True)
    nation = "select count(*) from nation"
    cpu = Engine(device="cpu")
    cpu.register_catalog("tpch", TpchConnector(sf=SF_MAIN, split_rows=SPLIT_ROWS))
    with own.region():
        card = explain_lines(engine, nation, tierless_session(engine))
    ref = explain_lines(cpu, nation, cpu.create_session("tpch"))
    check(masked_plan_lines(card) == masked_plan_lines(ref),
          f"history explain nation: {card} vs the CPU engine's {ref}")
    out["nation"] = {"lines": len(card), "boundary": boundary_sums(card, "nation")}
    print(f"history 14b nation: {len(card)} lines, the CPU engine's plan lines; "
          f"{chr(10).join(card)}", flush=True)
    return out


def by_key(res):
    """A group-by result's raw columns in key order (a hash group-by's
    output order follows its table's capacity)."""
    import numpy as np

    cols = [np.asarray(c) for c in res.raw_columns]
    order = np.argsort(cols[0], kind="stable")
    return [c[order] for c in cols]


def adaptive_runs(engine, name, sql, own):
    """Three runs of one statement with ``price_scale = 0``: the first
    records, the second runs the corrected plan, the third (warm) confirms.
    Then the warm uncorrected plan (a session with adaptive_execution off)
    and the warm corrected one, in turns.  Every run's rows byte-equal to
    the first's in key order.  Returns (the three runs, the advisor's
    trace, {"uncorrected", "corrected"}: the faster warm run of each)."""
    sess, plain = engine.create_session("tpch"), engine.create_session("tpch")
    engine.execute_sql("set session adaptive_execution = false", plain)
    first = None

    def run(s, i):
        nonlocal first
        res, r = history_statement(engine, sql, s, own)
        rows = by_key(res)
        if first is None:
            first = rows
        check(all(a.tobytes() == b.tobytes() for a, b in zip(first, rows)),
              f"adaptive {name} run {i}: rows differ from run 1's")
        r["rows"] = len(res)
        return r

    runs = [run(sess, i) for i in (1, 2, 3)]
    check([r["replans"] for r in runs] == [0, 1, 1],
          f"adaptive {name}: replans per run {[r['replans'] for r in runs]}")
    trace = engine.adaptive_advisor.decision_trace()[-1]
    check(trace["state"] == "confirmed", f"adaptive {name}: {trace['state']} after run 3")
    run(plain, "uncorrected cold")
    warm = {"uncorrected": [], "corrected": []}
    for key, s in (("uncorrected", plain), ("corrected", sess)) * 2:
        warm[key].append(run(s, f"{key} warm"))
    # a warm corrected run slower than 1.5x the uncorrected EWMA demotes the
    # correction, and the runs after it hold: count only what ran corrected
    warm["corrected"] = [r for r in warm["corrected"] if r["replans"]]
    check(warm["corrected"], f"adaptive {name}: demoted during the warm turns "
                             f"({engine.adaptive_advisor.decision_trace()[-1]})")
    best = {k: min(v, key=lambda r: r["wall_s"]) for k, v in warm.items()}
    return runs, trace, best


def adaptive_path(conn, own):
    """14c on a fresh card engine with ``price_scale = 0``: the probe (a
    direct group-by: its correction has no table to size) and the probe over
    an expression key (a hash group-by: the corrected plan's hash_insert_
    runs at the advisor's capacity); then the default price's verdict on a
    fresh engine, and tests/test_adaptive.py's JOIN_Q, whose corrected plan
    shows ``partitioned`` and ``Adaptive: replan``.  Returns (the record,
    the corrected hash_insert_ shapes)."""
    from trino_tpu_torch import Engine
    from trino_tpu_torch.sql import exchanges

    engine = Engine(device=DEVICE)
    engine.register_catalog("tpch", conn)
    engine.adaptive_advisor.price_scale = 0.0
    rec = {}
    for name, sql in (("probe", ADAPTIVE_PROBE), ("probe_hash", ADAPTIVE_PROBE_HASH)):
        runs, trace, best = adaptive_runs(engine, name, sql, own)
        cap = trace["corrections"]["capacity"]["Aggregate#0.0.0"]
        check(cap == 1 << (2 * runs[0]["rows"] - 1).bit_length(),
              f"adaptive {name}: capacity {cap} for {runs[0]['rows']} groups")
        caps = {k: sorted({C for _, C in r["insert_shapes"]}) for k, r in best.items()}
        rec[name] = {"corrections": trace["corrections"], "groups": runs[0]["rows"],
                     "runs_wall_s": [r["wall_s"] for r in runs],
                     **{k: {"wall_s": r["wall_s"], "hash_insert": r["launches"]["hash_insert"],
                            "capacities": caps[k], "host_reads": r["host_reads"],
                            "device_dispatches": r["device_dispatches"]}
                        for k, r in best.items()}}
        if name == "probe_hash":
            check(caps["corrected"] == [cap] and sorted(
                {C for _, C in runs[1]["insert_shapes"]}) == [cap],
                f"adaptive {name}: the corrected plan inserted at {caps['corrected']}, "
                f"not {cap}")
            check(caps["uncorrected"] and caps["uncorrected"][0] != cap,
                  f"adaptive {name}: the uncorrected plan started at {caps['uncorrected']}")
            shapes = runs[1]["insert_shapes"]
        print(f"adaptive 14c {name}: {runs[0]['rows']} groups; corrections "
              f"{trace['corrections']}; runs 1-3 wall_s {rec[name]['runs_wall_s']}; warm "
              f"uncorrected {rec[name]['uncorrected']} against corrected "
              f"{rec[name]['corrected']}", flush=True)
    # the default price: a fresh engine, price_scale 1
    fresh = Engine(device=DEVICE)
    fresh.register_catalog("tpch", conn)
    sess = fresh.create_session("tpch")
    for _ in range(2):
        history_statement(fresh, ADAPTIVE_PROBE_HASH, sess, own)
    t = fresh.adaptive_advisor.decision_trace()[-1]
    rec["default_price"] = {k: t[k] for k in ("last_verdict", "compile_price_s",
                                              "predicted_win_s", "reasons")}
    print(f"adaptive 14c default price: verdict {t['last_verdict']}, price (planning) "
          f"{t['compile_price_s']} s, predicted win {t['predicted_win_s']} s x "
          f"{fresh.adaptive_advisor.horizon:g}", flush=True)
    del fresh
    # JOIN_Q, its distribution thresholds shrunk
    saved = {k: getattr(exchanges, k) for k in ADAPTIVE_JOIN_THRESHOLDS}
    try:
        for k, v in ADAPTIVE_JOIN_THRESHOLDS.items():
            setattr(exchanges, k, v)
        sess = engine.create_session("tpch")
        before = "\n".join(r[0] for r in engine.execute_sql(
            f"explain {ADAPTIVE_JOIN}", sess).rows())
        check("partitioned" not in before, f"adaptive join: partitioned before any history")
        runs, trace, best = adaptive_runs(engine, "join", ADAPTIVE_JOIN, own)
        after = "\n".join(r[0] for r in engine.execute_sql(
            f"explain {ADAPTIVE_JOIN}", sess).rows())
        check("partitioned" in after and "Adaptive: replan" in after,
              f"adaptive join: the corrected plan's EXPLAIN: {after}")
    finally:
        for k, v in saved.items():
            setattr(exchanges, k, v)
    rec["join"] = {"corrections": trace["corrections"],
                   "runs_wall_s": [r["wall_s"] for r in runs],
                   **{k: {"wall_s": r["wall_s"], "device_dispatches": r["device_dispatches"]}
                      for k, r in best.items()}}
    print(f"adaptive 14c join: run 2 replanned to partitioned; corrections "
          f"{trace['corrections']}; runs 1-3 wall_s {rec['join']['runs_wall_s']}; warm "
          f"uncorrected {rec['join']['uncorrected']} against corrected "
          f"{rec['join']['corrected']}", flush=True)
    return rec, shapes


def nonzero(launches):
    return {k: v for k, v in launches.items() if v}


def default_advisor(conn, phase2, own):
    """14e: the 22 queries three times on one card engine with everything at
    its defaults, the advisor included (the page tier at a quarter of the
    card, the result tier off, history on, planning as a re-plan's price).
    Every run's result equals phase 2's: in row order where the statement
    orders its rows, else as sorted rows (a corrected hash group-by's output
    order follows its capacity).  Per query: the runs that re-planned or
    held.  For each query the advisor re-planned: its corrections, its
    state after run 3 (probation, confirmed or demoted), the predicted win
    and the price beside the warm walls, host reads, dispatches and
    launches of its uncorrected plan (a session with adaptive_execution
    off) and of its corrected one, in turns."""
    from trino_tpu_torch import Engine

    engine = Engine(device=DEVICE)
    engine.register_catalog("tpch", conn)
    engine.execute_sql(Q15_VIEW, engine.create_session("tpch"))
    check(engine.buffer_pool.budget() > 0, "advisor 14e: the page tier is off")
    sess, plain = engine.create_session("tpch"), engine.create_session("tpch")
    engine.execute_sql("set session adaptive_execution = false", plain)

    def run(q, s, what):
        res, r = history_statement(engine, ALL_QUERIES[q], s, own)
        same_outcome_result(res, phase2[q], ALL_QUERIES[q], f"advisor 14e {q} {what} vs phase 2")
        return r

    runs = {q: [] for q in ALL_QUERIES}
    for i in range(DEFAULT_RUNS):
        for q in ALL_QUERIES:
            runs[q].append(run(q, sess, f"run {i + 1}"))
    trace = {t["sql"]: t for t in engine.adaptive_advisor.decision_trace()}
    out = {}
    for q, sql in ALL_QUERIES.items():
        r, t = runs[q], trace.get(sql) or {}
        check(r[0]["replans"] == 0 and r[0]["holds"] == 0,
              f"advisor 14e {q}: run 1 had no history, yet {r[0]}")
        out[q] = {"replans": [x["replans"] for x in r], "holds": [x["holds"] for x in r],
                  "state_after_run3": t.get("state"), "last_verdict": t.get("last_verdict"),
                  "corrections": t.get("corrections"),
                  "predicted_win_s": t.get("predicted_win_s"),
                  "price_s": t.get("compile_price_s"),
                  "runs_wall_s": [x["wall_s"] for x in r]}
    replanned = [q for q, v in out.items() if any(v["replans"])]
    check(replanned, "advisor 14e: no query re-planned at the defaults")
    for q in replanned:
        run(q, plain, "uncorrected cold")  # the uncorrected plan's own plan-cache entry
        warm = {"uncorrected": [], "corrected": []}
        for _ in range(DEFAULT_TURNS):
            for key, s in (("uncorrected", plain), ("corrected", sess)):
                warm[key].append(run(q, s, f"{key} warm"))
        # a demoted correction holds: its later runs are uncorrected
        corrected = [x for x in warm["corrected"] if x["replans"]] or \
            [x for x in runs[q][2:] if x["replans"]]
        best = {"uncorrected": min(warm["uncorrected"], key=lambda x: x["wall_s"]),
                "corrected": min(corrected, key=lambda x: x["wall_s"]) if corrected else None}
        t = trace.get(ALL_QUERIES[q]) or {}
        now = next((x for x in engine.adaptive_advisor.decision_trace()
                    if x["sql"] == ALL_QUERIES[q]), {})
        v = out[q]
        v["state_after_turns"] = now.get("state")
        for key, x in best.items():
            v[key] = None if x is None else {
                "wall_s": x["wall_s"], "host_reads": x["host_reads"],
                "device_dispatches": x["device_dispatches"],
                "launches": nonzero(x["launches"])}
        v["measured_win_s"] = None if best["corrected"] is None else \
            best["uncorrected"]["wall_s"] - best["corrected"]["wall_s"]
        print(f"advisor 14e {q}: replans per run {v['replans']}, holds {v['holds']}; "
              f"corrections {v['corrections']}; state after run 3 {v['state_after_run3']}, "
              f"after the turns {v['state_after_turns']}; predicted win "
              f"{t.get('predicted_win_s')} s x {engine.adaptive_advisor.horizon:g} against "
              f"price (planning) {t.get('compile_price_s')} s; warm uncorrected "
              f"{v['uncorrected']} corrected {v['corrected']}; measured win "
              f"{v['measured_win_s']} s", flush=True)
    held = {q: v for q, v in out.items() if any(v["holds"])}
    for q, v in held.items():
        print(f"advisor 14e {q}: held, holds per run {v['holds']}; predicted win "
              f"{v['predicted_win_s']} s against price {v['price_s']} s", flush=True)
    print(f"advisor 14e: the 22 queries x {DEFAULT_RUNS} at the defaults equal phase 2's; "
          f"re-planned {replanned}, held {sorted(held)}, advisor "
          f"{engine.adaptive_advisor.info()}", flush=True)
    del engine
    return out


def history_path(phase2, cpu_actuals):
    """Phase 14: per-node stats, plan history and adaptive execution at SF1
    on card engines at their defaults.  ``phase2``: phase 2's results;
    ``cpu_actuals``: the CPU engine's history record of each of phase 2's
    queries.  Returns (the record, launches of the phase's card statements
    with history on, {kernel: checks at the phase's shapes})."""
    import numpy as np
    import torch

    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.ops.hashing import pack_keys

    t_phase = time.perf_counter()
    os.environ.pop("TRINO_TPU_PAGE_CACHE", None)
    os.environ.pop("TRINO_TPU_RESULT_CACHE", None)
    torch.cuda.empty_cache()
    conn = TpchConnector(sf=SF_MAIN, split_rows=SPLIT_ROWS)
    engine = Engine(device=DEVICE)
    engine.register_catalog("tpch", conn)
    engine.execute_sql(Q15_VIEW, engine.create_session("tpch"))
    own = OwnLaunches()
    rec = {"queries": history_queries(engine, phase2, cpu_actuals, own)}
    switch = HistorySwitch(engine)
    try:
        rec["cost"] = history_cost(engine, switch, own)
        rec["templates"] = history_templates(engine, switch, own)
    finally:
        switch.close()
    rec["explain"] = history_explain(engine, cpu_actuals, own)
    del engine
    torch.cuda.empty_cache()
    # 14c: the advisor at its default, on
    os.environ.pop("TRINO_TPU_ADAPTIVE", None)
    rec["adaptive"], shapes = adaptive_path(conn, own)
    torch.cuda.empty_cache()
    rec["defaults"] = default_advisor(conn, phase2, own)
    torch.cuda.empty_cache()
    launches = dict(own.launches)
    check(launches["hash_insert"] > 0 and launches["hash_probe"] > 0
          and launches["compact_rows"] > 0,
          f"the history path launched no hash_insert, hash_probe or compact_rows: {launches}")
    # 14d: hash_insert_ at the corrected run's shape and on its own keys;
    # the probe and compaction at the phase's largest and most frequent
    page = conn.generate(conn.splits("lineitem")[0], ["l_orderkey"])
    packed, _ = pack_keys((page.columns[0] * 2,), (page.schema.fields[0].type,))
    gen = np.random.default_rng(41)
    checks = {"hash_insert": insert_checks(shapes, ("lineitem_orderkey_x2", packed,
                                                    page.valid_mask()), gen),
              "hash_probe": probe_checks(own.shapes["hash_probe"], gen),
              "compact_rows": compact_checks(own.shapes["compact_rows"], gen)}
    del page, packed
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"history path: {rec['seconds']:.1f} s, launches of the card statements with "
          f"history on {launches}", flush=True)
    print(json.dumps({"adaptive_sf1": rec}, default=str), flush=True)
    torch.cuda.empty_cache()
    return rec, launches, {k: {"max_abs_err": r["max_abs_err"], "shapes": r["shapes"]}
                           for k, r in checks.items()}


# -- phase 15: the flight recorder, the build log, the in-flight registry --------------
FLIGHT_TURNS = 2  # 15a: warm runs per recorder mode and statement, in turns
FLIGHT_TEMPLATE_HITS = 6  # 15a: template hits per statement, each mode in turns
FLIGHT_ERROR = "select no_such_column from lineitem"
FLIGHT_STALL_S = 0.05  # 15d: TRINO_TPU_STALL_S
FLIGHT_STALL_HOLD_S = 0.5  # 15d: how long the hook holds one host read
FLIGHT_INFLIGHT_PAIRS = 200_000  # 15g: enter/exit pairs in the timed loop
FLIGHT_INFLIGHT_TURNS = 3  # 15g: warm runs per side and statement, in turns
FLIGHT_CHILD = """
import sys
sys.path.insert(0, {root!r})
import chip_smoke
from trino_tpu_torch import Engine
from trino_tpu_torch.connectors.tpch import TpchConnector
e = Engine()
e.register_catalog("tpch", TpchConnector(sf={sf}, split_rows={split}))
s = e.create_session("tpch")
for sql in chip_smoke.QUERIES.values():
    e.execute_sql(sql, s)
print("ran", flush=True)
sys.stdin.read()
"""


class FlightSwitch:
    """Swaps an engine's flight recorder between ``off`` (what
    ``TRINO_TPU_FLIGHT_RECORDS=0`` builds), ``memory`` (the in-memory ring
    alone) and ``disk`` (the engine's own recorder: the ring and its
    on-disk JSONL ring), and times each ``_record_flight`` call per mode."""

    MODES = ("off", "memory", "disk")

    def __init__(self, engine):
        from trino_tpu_torch.execution.flightrecorder import FlightRecorder

        self.engine = engine
        os.environ["TRINO_TPU_FLIGHT_RECORDS"] = "0"
        try:
            off = FlightRecorder(flight_dir="")
        finally:
            os.environ.pop("TRINO_TPU_FLIGHT_RECORDS")
        self.recorders = {"off": off, "memory": FlightRecorder(flight_dir=""),
                          "disk": engine.flight_recorder}
        check(not off.enabled and not self.recorders["memory"].flight_dir
              and self.recorders["disk"].flight_dir,
              "flight switch: the three recorders are not off, memory and disk")
        self.record_s = {m: [] for m in self.MODES}
        self.mode = "disk"
        inner = engine._record_flight

        def timed(qsm, snap):
            mode = self.mode
            t0 = time.perf_counter()
            try:
                return inner(qsm, snap)
            finally:
                self.record_s[mode].append(time.perf_counter() - t0)

        engine._record_flight = timed

    def set(self, mode: str) -> None:
        self.mode = mode
        self.engine.flight_recorder = self.recorders[mode]

    def close(self) -> None:
        self.set("disk")
        del self.engine._record_flight


def flight_statement(engine, sql, sess, own=None):
    """history_statement's record plus the statement's H2D bytes."""
    res, r = history_statement(engine, sql, sess, own)
    r["h2d_bytes"] = engine.last_query_counters["h2d_bytes"]
    return res, r


def flight_queries(engine, off, phase2, own):
    """15a: the 22 queries on the recorder's engine (its disk ring on) and on
    one built with TRINO_TPU_FLIGHT_RECORDS=0: each result equal to phase 2's;
    each statement leaves one query record, FINISHED, with its rows and its
    host reads; host reads, H2D bytes and launches equal between the two."""
    fr = engine.flight_recorder
    out = {}
    for q, sql in ALL_QUERIES.items():
        before = fr.records_total
        res, on_r = flight_statement(engine, sql, engine.create_session("tpch"), own)
        rec = fr.snapshot(kind="query")[-1]
        _, off_r = flight_statement(off, sql, off.create_session("tpch"))
        same_result(res, phase2[q], f"flight {q} vs phase 2")
        check(fr.records_total == before + 1,
              f"flight {q}: {fr.records_total - before} records for one statement")
        check(rec["state"] == "FINISHED" and rec["rows"] == len(res)
              and rec["counters"]["host_reads"] == on_r["host_reads"],
              f"flight {q}: record {rec['state']} rows {rec['rows']} reads "
              f"{rec['counters']['host_reads']} vs the run's {len(res)}, {on_r['host_reads']}")
        for k in ("host_reads", "h2d_bytes", "launches"):
            check(on_r[k] == off_r[k],
                  f"flight {q}: {k} {on_r[k]} with the recorder vs {off_r[k]} without")
        out[q] = {"cold_on_s": on_r["wall_s"], "cold_off_s": off_r["wall_s"],
                  "host_reads": on_r["host_reads"], "h2d_bytes": on_r["h2d_bytes"],
                  "launches": nonzero(on_r["launches"]),
                  "spans": len(rec["trace"]["spans"])}
    print(f"flight 15a: the 22 queries equal phase 2's; one record each; host reads, H2D "
          f"bytes and launches equal with TRINO_TPU_FLIGHT_RECORDS=0", flush=True)
    return out


def flight_cost(engine, switch):
    """15a: bench.py's five warm, the recorder off, in memory and with its
    disk ring, in turns; host reads equal; the seconds ``_record_flight``
    took a statement in each mode."""
    sess = engine.create_session("tpch")
    out = {}
    order = ("memory", "disk", "off", "off", "disk", "memory")
    for q, sql in QUERIES.items():
        history_statement(engine, sql, sess)  # warm, untimed
        walls = {m: [] for m in FlightSwitch.MODES}
        reads = {}
        for m in switch.MODES:
            switch.record_s[m].clear()
        for _ in range(FLIGHT_TURNS):
            for m in order:
                switch.set(m)
                _, r = history_statement(engine, sql, sess)
                walls[m].append(r["wall_s"])
                reads[m] = r["host_reads"]
        switch.set("disk")
        check(len(set(reads.values())) == 1, f"flight cost {q}: host reads {reads}")
        out[q] = {"wall_s": {m: min(v) for m, v in walls.items()},
                  "record_s": {m: statistics.median(switch.record_s[m])
                               for m in switch.MODES},
                  "host_reads": reads["off"]}
        print(f"flight 15a {q}: warm wall_s {out[q]['wall_s']} (min of "
              f"{2 * FLIGHT_TURNS} each, in turns); _record_flight s a statement "
              f"(median) {out[q]['record_s']}; host_reads {reads['off']} in every mode",
              flush=True)
    return out


def flight_templates(engine, switch, keep):
    """15a: phase 13's T1-T6 template hits, each mode in turns: results
    byte-equal, host reads equal; the seconds ``_record_flight`` took a hit.
    ``keep`` gets the session and each template's hit statements (for 15g)."""
    import numpy as np

    gen = np.random.default_rng(15)
    (sess,) = template_sessions(engine)
    plans = {"plans": 0}
    out = {}
    for name, text in TEMPLATES.items():
        vals = [v for i, v in enumerate(template_values(gen, name, TEMPLATE_EXECUTES, SF_MAIN))
                if i not in (TEMPLATE_NULL_AT, TEMPLATE_OUTSIDE_AT)][:FLIGHT_TEMPLATE_HITS + 1]
        stmts = [f"execute {name} using " + ", ".join(sql_literal(x) for x in v) for v in vals]
        engine.execute_sql(f"prepare {name} from {text}", sess)
        engine.execute_sql(stmts[0], sess)  # the miss that creates the template
        keep[name] = (sess, stmts[1:])
        walls = {m: [] for m in switch.MODES}
        for m in switch.MODES:
            switch.record_s[m].clear()
        for i, stmt in enumerate(stmts[1:]):
            engine.execute_sql(stmt, sess)  # the binding's first request, untimed
            got = {}
            modes = switch.MODES if i % 2 == 0 else tuple(reversed(switch.MODES))
            for m in modes:
                switch.set(m)
                res, r = timed_statement(engine, stmt, sess, plans)
                check(r["hits"] == 1, f"flight templates {name}: not a template hit ({r})")
                walls[m].append(r["wall_s"])
                got[m] = (res, r)
            for m in ("memory", "disk"):
                same_bytes(got[m][0], got["off"][0], f"flight templates {name} {m} binding {i}")
                check(got[m][1]["host_reads"] == got["off"][1]["host_reads"],
                      f"flight templates {name}: host reads {got[m][1]['host_reads']} "
                      f"({m}) vs {got['off'][1]['host_reads']} off")
        switch.set("disk")
        out[name] = {"hit_s": {m: statistics.median(v) for m, v in walls.items()},
                     "record_s": {m: statistics.median(switch.record_s[m])
                                  for m in switch.MODES}}
        print(f"flight 15a {name}: template hit wall_s {out[name]['hit_s']} (median of "
              f"{len(walls['off'])}, in turns); _record_flight s a hit (median) "
              f"{out[name]['record_s']}", flush=True)
    return out


class InflightStub:
    """15g: the process registry ``INFLIGHT`` live, or with ``enter`` and
    ``exit`` replaced on the instance by no-ops (what a port without the
    registry pays per launch and host read: one Python call each)."""

    SIDES = ("live", "stub")

    def __init__(self):
        from trino_tpu_torch.execution.tracing import INFLIGHT

        self.reg = INFLIGHT

    def set(self, side: str) -> None:
        if side == "live":
            self.reg.__dict__.pop("enter", None)
            self.reg.__dict__.pop("exit", None)
        else:
            self.reg.enter = lambda kind, site=None, compiling=False: 0
            self.reg.exit = lambda token: None

    def count(self, run) -> int:
        """Entries ``run()`` makes with the registry live."""
        live = type(self.reg).enter
        n = [0]

        def counted(kind, site=None, compiling=False):
            n[0] += 1
            return live(self.reg, kind, site, compiling)

        self.reg.enter = counted
        try:
            run()
        finally:
            self.set("live")
        return n[0]

    def pair_s(self, side: str) -> float:
        """Seconds of one enter/exit pair, a timed loop on this thread."""
        self.set(side)
        reg = self.reg
        try:
            t0 = time.perf_counter()
            for _ in range(FLIGHT_INFLIGHT_PAIRS):
                reg.exit(reg.enter("dispatch", "hash_probe"))
            return (time.perf_counter() - t0) / FLIGHT_INFLIGHT_PAIRS
        finally:
            self.set("live")


def flight_inflight_cost(engine, templates):
    """15g: the in-flight registry's host cost.  A timed loop of enter/exit
    pairs live and with no-op stand-ins; per statement of bench.py's five
    and per T1-T6 hit the entries it makes, their cost by the loop's
    difference, and warm walls live and stubbed out in turns (min of
    FLIGHT_INFLIGHT_TURNS for the five, median of the hits); results and
    host reads equal on both sides."""
    stub = InflightStub()
    check(stub.reg.depth() == 0, f"flight 15g: {stub.reg.depth()} entries open at the start")
    live_s, stub_s = stub.pair_s("live"), stub.pair_s("stub")
    pair = live_s - stub_s
    print(f"flight 15g: enter/exit pair {live_s * 1e6:.4f} us live, {stub_s * 1e6:.4f} us "
          f"with no-op stand-ins, registry cost {pair * 1e6:.4f} us a pair (loop of "
          f"{FLIGHT_INFLIGHT_PAIRS})", flush=True)
    out = {"pair_live_us": live_s * 1e6, "pair_stub_us": stub_s * 1e6,
           "pair_cost_us": pair * 1e6, "statements": {}, "hits": {}}
    sess = engine.create_session("tpch")
    plans = {"plans": 0}
    try:
        for q, sql in QUERIES.items():
            history_statement(engine, sql, sess)  # warm, untimed
            entries = stub.count(lambda: engine.execute_sql(sql, sess))
            walls = {s: [] for s in stub.SIDES}
            got = {}
            for i in range(FLIGHT_INFLIGHT_TURNS):
                for side in stub.SIDES if i % 2 == 0 else tuple(reversed(stub.SIDES)):
                    stub.set(side)
                    got[side] = history_statement(engine, sql, sess)
                    walls[side].append(got[side][1]["wall_s"])
            stub.set("live")
            same_result(got["stub"][0], got["live"][0], f"flight 15g {q} stub vs live")
            check(got["stub"][1]["host_reads"] == got["live"][1]["host_reads"],
                  f"flight 15g {q}: host reads differ between the sides")
            w = {s: min(v) for s, v in walls.items()}
            out["statements"][q] = {"entries": entries, "est_ms": entries * pair * 1e3,
                                    "wall_s": w}
            print(f"flight 15g {q}: {entries} entries, {entries * pair * 1e3:.4f} ms by the "
                  f"loop; warm wall_s live {w['live']} stub {w['stub']} (min of "
                  f"{FLIGHT_INFLIGHT_TURNS}, in turns)", flush=True)
        for name, (tsess, stmts) in templates.items():
            entries = stub.count(lambda: engine.execute_sql(stmts[0], tsess))
            walls = {s: [] for s in stub.SIDES}
            for i, stmt in enumerate(stmts):
                got = {}
                for side in stub.SIDES if i % 2 == 0 else tuple(reversed(stub.SIDES)):
                    stub.set(side)
                    got[side] = timed_statement(engine, stmt, tsess, plans)
                    check(got[side][1]["hits"] == 1,
                          f"flight 15g {name}: not a template hit ({got[side][1]})")
                    walls[side].append(got[side][1]["wall_s"])
                stub.set("live")
                same_bytes(got["stub"][0], got["live"][0], f"flight 15g {name} binding {i}")
            w = {s: statistics.median(v) for s, v in walls.items()}
            out["hits"][name] = {"entries": entries, "est_ms": entries * pair * 1e3,
                                 "hit_s": w}
            print(f"flight 15g {name}: {entries} entries a hit, {entries * pair * 1e3:.4f} ms "
                  f"by the loop; hit wall_s live {w['live']} stub {w['stub']} (median of "
                  f"{len(stmts)}, in turns)", flush=True)
    finally:
        stub.set("live")
    return out


def flight_error(engine, ring):
    """15b: an erroring statement's record, in memory and in the disk ring."""
    from trino_tpu_torch.execution.flightrecorder import read_flight_dir

    fr = engine.flight_recorder
    before = fr.records_total
    try:
        engine.execute_sql(FLIGHT_ERROR, engine.create_session("tpch"))
        raised = None
    except Exception as e:  # noqa: BLE001 - the error is what 15b records
        raised = str(e)
    check(raised is not None, "flight 15b: the erroring statement did not raise")
    rec = fr.snapshot(kind="query")[-1]
    check(fr.records_total == before + 1 and rec["state"] == "FAILED"
          and rec["error"] == raised and "no_such_column" in raised,
          f"flight 15b: record {rec['state']} error {rec['error']!r} vs raised {raised!r}")
    on_disk = [r for r in read_flight_dir(ring) if r.get("query_id") == rec["query_id"]]
    check(on_disk and on_disk[-1]["error"] == raised,
          f"flight 15b: the disk ring holds {len(on_disk)} records of the statement")
    print(f"flight 15b: {rec['query_id']} FAILED, its record's error {raised!r}, in memory "
          f"and on disk", flush=True)
    return {"error": raised, "query_id": rec["query_id"]}


def flight_compiles(ck):
    """15c: one build-log record per CUDA library, from the build at
    startup: its nvcc seconds, or cached."""
    from trino_tpu_torch.execution.tracing import COMPILE_LOG

    recs = COMPILE_LOG.snapshot()
    libs = sorted({src for src, _ in ck._SIGNATURES.values()})
    got = sorted(r.get("library") for r in recs)
    check(got == libs, f"flight 15c: build records for {got}, the libraries are {libs}")
    for r in recs:
        check(r["duration_s"] >= 0 and r["exe_bytes"] > 0 and r["signature"],
              f"flight 15c: build record {r}")
        print(f"flight 15c: {r['library']}: {'cached' if r['cached'] else 'nvcc'} "
              f"{r['duration_s']} s, {r['exe_bytes']} bytes, digest {r['signature']}, "
              f"site {r['site']}, query {r['query_id']}", flush=True)
    return [{k: r.get(k) for k in ("library", "cached", "duration_s", "exe_bytes",
                                   "signature", "site", "query_id")} for r in recs]


def flight_stall(conn):
    """15d: an engine armed with TRINO_TPU_STALL_S: one host read of a warm
    statement held FLIGHT_STALL_HOLD_S by the test hook; health() turns
    "stalled" naming the read's site, a stall event lands in the recorder,
    and health() is "ok" afterwards."""
    import threading

    import torch

    from trino_tpu_torch import Engine
    from trino_tpu_torch.execution import tracing

    os.environ["TRINO_TPU_STALL_S"] = str(FLIGHT_STALL_S)
    try:
        engine = Engine(device=DEVICE)
    finally:
        os.environ.pop("TRINO_TPU_STALL_S")
    wd = engine.stall_watchdog
    try:
        check(wd.enabled and wd._thread is not None, "flight 15d: the watchdog is not armed")
        engine.register_catalog("tpch", conn)
        sess = engine.create_session("tpch")
        sql = QUERIES["q1"]
        engine.execute_sql(sql, sess)
        check(engine.health()["status"] == "ok", f"flight 15d: before {engine.health()}")
        held = threading.Event()
        t_hold = []

        def hook(label):
            if not held.is_set():
                t_hold.append(time.perf_counter())
                held.set()
                time.sleep(FLIGHT_STALL_HOLD_S)

        seen = []
        tracing.DISPATCH_TEST_HOOK = hook
        try:
            th = threading.Thread(target=engine.execute_sql, args=(sql, sess))
            t0 = time.perf_counter()
            th.start()
            check(held.wait(30), "flight 15d: the statement made no host read")
            while th.is_alive() and not seen:
                h = engine.health()
                if h["status"] == "stalled":
                    seen.append((time.perf_counter(), h, list(tracing.INFLIGHT.snapshot())))
                time.sleep(0.002)
            th.join(60)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            tracing.DISPATCH_TEST_HOOK = None
        check(seen, "flight 15d: health() never read stalled while the read was held")
        t_seen, h, entries = seen[0]
        report = engine.last_stall_report
        check(report is not None and report["stalled"]
              and report["stalled"][0]["kind"] == "host_pull",
              f"flight 15d: stall report {report}")
        site = report["stalled"][0]["label"]
        stalls = engine.flight_recorder.snapshot(kind="stall")
        check(stalls and stalls[-1]["stalled"][0]["label"] == site,
              f"flight 15d: {len(stalls)} stall events in the recorder")
        after = engine.health()
        check(after["status"] == "ok", f"flight 15d: after the hold {after}")
        rec = {"stalled_site": site, "health_stalled": h,
               "detect_s": t_seen - t_hold[0], "statement_wall_s": wall,
               "stall_events": len(stalls), "health_after": after["status"],
               "reports": wd.reports}
        print(f"flight 15d: health() stalled {rec['detect_s']:.4f} s into a "
              f"{FLIGHT_STALL_HOLD_S} s hold (TRINO_TPU_STALL_S={FLIGHT_STALL_S}) at {site}; "
              f"{len(stalls)} stall event(s) recorded; statement wall {wall:.4f} s; "
              f"health after: {after['status']}", flush=True)
        return rec
    finally:
        wd.stop()
        del engine


def flight_dead_process():
    """15e: a child process runs bench.py's five at SF1 on the card into a
    disk ring and is killed with SIGKILL; read_flight_dir reads the five
    records back."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="trino-flight-child-") as ring:
        return dead_process_ring(ring)


def dead_process_ring(ring):
    """15e in ``ring``, a directory its caller removes."""
    import signal

    from trino_tpu_torch.execution.flightrecorder import read_flight_dir

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, TRINO_TPU_FLIGHT_DIR=ring)
    t0 = time.perf_counter()
    child = subprocess.Popen([sys.executable, "-c", FLIGHT_CHILD.format(
        root=root, sf=SF_MAIN, split=SPLIT_ROWS)], env=env, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = child.stdout.readline()
        check(line.strip() == "ran", f"flight 15e: the child said {line!r}: "
              f"{child.stderr.read()[-2000:] if child.poll() is not None else ''}")
        child.send_signal(signal.SIGKILL)
        child.wait(30)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(30)
    check(child.returncode == -signal.SIGKILL, f"flight 15e: child exit {child.returncode}")
    recs = [r for r in read_flight_dir(ring) if r.get("kind") == "query"]
    from trino_tpu_torch.engine import _normalize_statement

    want = [_normalize_statement(sql) for sql in QUERIES.values()]
    check([r["sql"] for r in recs] == want and all(r["state"] == "FINISHED" for r in recs),
          f"flight 15e: read back {[(r['sql'][:20], r['state']) for r in recs]}")
    rec = {"records": len(recs), "child_s": time.perf_counter() - t0,
           "ring_bytes": sum(os.path.getsize(os.path.join(ring, n)) for n in os.listdir(ring))}
    print(f"flight 15e: a child killed by SIGKILL left {len(recs)} records in its ring "
          f"({rec['ring_bytes']} bytes), all read back; {rec['child_s']:.1f} s", flush=True)
    return rec


def flight_path(phase2):
    """Phase 15: the flight recorder, the kernel-build log, the in-flight
    registry and the stall watchdog on card engines at SF1, the tiers and
    the advisor off (as phase 2 ran).  Returns (the record, launches of 15a's
    card statements on the recorder's engine, {kernel: checks at their
    shapes})."""
    import tempfile

    import numpy as np
    import torch

    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.ops import cuda_kernels as ck

    t_phase = time.perf_counter()
    os.environ["TRINO_TPU_PAGE_CACHE"] = "0"
    os.environ["TRINO_TPU_RESULT_CACHE"] = "0"
    os.environ["TRINO_TPU_ADAPTIVE"] = "0"
    # the disk ring lives in a temporary directory, removed once the
    # recorder's engine is gone
    with tempfile.TemporaryDirectory(prefix="trino-flight-") as ring:
        torch.cuda.empty_cache()
        conn = TpchConnector(sf=SF_MAIN, split_rows=SPLIT_ROWS)
        os.environ["TRINO_TPU_FLIGHT_DIR"] = ring
        try:
            engine = Engine(device=DEVICE)
        finally:
            os.environ.pop("TRINO_TPU_FLIGHT_DIR")
        os.environ["TRINO_TPU_FLIGHT_RECORDS"] = "0"
        try:
            off = Engine(device=DEVICE)
        finally:
            os.environ.pop("TRINO_TPU_FLIGHT_RECORDS")
        check(engine.flight_recorder.enabled and engine.flight_recorder.flight_dir == ring
              and engine.flight_recorder.max_records == 256 and not off.flight_recorder.enabled,
              "flight: the recorder is not at its default with a disk ring, or not off")
        for e in (engine, off):
            e.register_catalog("tpch", conn)
            e.execute_sql(Q15_VIEW, e.create_session("tpch"))
        own = OwnLaunches()
        rec = {"ring": ring, "queries": flight_queries(engine, off, phase2, own)}
        del off
        switch = FlightSwitch(engine)
        try:
            rec["cost"] = flight_cost(engine, switch)
            templates = {}
            rec["templates"] = flight_templates(engine, switch, templates)
            switch.set("memory")
            rec["inflight"] = flight_inflight_cost(engine, templates)
        finally:
            switch.close()
        rec["error"] = flight_error(engine, ring)
        rec["disk"] = engine.flight_recorder.info()
        del engine
    rec["compiles"] = flight_compiles(ck)
    torch.cuda.empty_cache()
    rec["stall"] = flight_stall(conn)
    rec["dead_process"] = flight_dead_process()
    launches = dict(own.launches)
    check(launches["hash_insert"] > 0 and launches["hash_probe"] > 0
          and launches["compact_rows"] > 0,
          f"the flight path launched no hash_insert, hash_probe or compact_rows: {launches}")
    # 15f: each kernel the path launched against its plain version at the
    # path's largest and most frequent shapes
    li_keys = lineitem_keys(conn)
    gen = np.random.default_rng(47)
    checks = {"hash_insert": insert_checks(own.shapes["hash_insert"],
                                           ("lineitem_orderkey", *li_keys), gen),
              "hash_probe": probe_checks(own.shapes["hash_probe"], gen),
              "compact_rows": compact_checks(own.shapes["compact_rows"], gen)}
    del li_keys
    for k in ("TRINO_TPU_PAGE_CACHE", "TRINO_TPU_RESULT_CACHE", "TRINO_TPU_ADAPTIVE"):
        os.environ.pop(k, None)
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"flight path: {rec['seconds']:.1f} s, launches of 15a's statements on the "
          f"recorder's engine {launches}", flush=True)
    print(json.dumps({"flight_sf1": rec}, default=str), flush=True)
    torch.cuda.empty_cache()
    return rec, launches, {k: {"max_abs_err": r["max_abs_err"], "shapes": r["shapes"]}
                           for k, r in checks.items()}


# -- phase 16: memory-bounded execution: the tiered spill, Grace partitioning, admission --
# 16a and 16b at SF1: splits of 65,536 rows, so that one partition's share of a
# routed page (16,384 orderkeys, 128 KiB) fits the 512 KiB pool's host tier and
# small routed pages fit 16b's 128 KiB device tier, as the reference's tests
# split SF0.02 by 4,096 rows and SF0.1 by 65,536 (at 2^21 rows a split every
# chunk of 16a went past the pool to disk)
SPILL_SPLIT_ROWS = 1 << 16
SPILL_Q18 = {"pool": 1 << 20, "host": 96 << 10, "buffer": 128 << 10}  # 16b at SF1
SPILL_Q18_BIG = {"pool": 256 << 20, "buffer": 8 << 30}  # 16b at SF10: device and host
SPILL_SF_GROUPS = 34.0  # 16c: 51,000,000 orders, 1.5x MAX_GROUP_CAPACITY groups
SPILL_GROUPS_SQL = ("select count(*) c, sum(n) rows_total from "
                    "(select o_orderkey, count(*) n from orders group by o_orderkey)")
SPILL_JOIN_SQL = ("select o_orderpriority, count(*) c from orders, lineitem "
                  "where o_orderkey = l_orderkey group by o_orderpriority "
                  "order by o_orderpriority")
# a join on two keys: its table is hashed (a one-key join over a dense key
# range takes the direct table, which launches no probe kernel)
SPILL_JOIN2_SQL = ("select count(*) c, sum(ps_supplycost) s from lineitem, partsupp "
                   "where l_partkey = ps_partkey and l_suppkey = ps_suppkey")
SPILL_JOIN = {"pool": 256 << 20, "buffer": 2 << 30}  # 16d at SF10: the builds do not fit


class SpillLog:
    """Each spill's partitions, bytes and seconds per tier, recorded as it
    closes (``SpilledPartitions.close`` wrapped); ``take`` sums and empties
    what was recorded since the last call."""

    def __init__(self):
        from trino_tpu_torch.exec import spill

        self._cls = spill.SpilledPartitions
        self._orig = self._cls.close
        self._seen: list = []
        orig, seen = self._orig, self._seen

        def close(sp):
            if not sp._closed:
                seen.append({"parts": sp.parts, "columns": list(sp.schema.names),
                             "rows": sum(sp.rows), "bytes": dict(sp.tier_bytes),
                             "write_s": dict(sp.write_s), "read_s": dict(sp.read_s)})
            orig(sp)

        self._cls.close = close

    def take(self) -> dict:
        seen, self._seen[:] = list(self._seen), []
        out = {"spills": len(seen), "parts": [s["parts"] for s in seen],
               "each": [{"parts": s["parts"], "columns": s["columns"], "rows": s["rows"],
                         "bytes": s["bytes"]} for s in seen]}
        for tier in ("hbm", "host", "disk"):
            b = sum(s["bytes"][tier] for s in seen)
            w = sum(s["write_s"][tier] for s in seen)
            r = sum(s["read_s"][tier] for s in seen)
            out[tier] = {"bytes": b, "write_s": w, "read_s": r,
                         "write_gb_s": b / w / 1e9 if w else None,
                         "read_gb_s": b / r / 1e9 if r and tier != "hbm" else None}
        return out

    def close(self):
        self._cls.close = self._orig


def tier_text(t: dict) -> str:
    def gbs(x):
        return "-" if x is None else f"{x:.3f}"

    return " ".join(f"{tier}={t[tier]['bytes']}B w{t[tier]['write_s']:.4f}s/"
                    f"{gbs(t[tier]['write_gb_s'])}GB/s r{t[tier]['read_s']:.4f}s/"
                    f"{gbs(t[tier]['read_gb_s'])}GB/s" for tier in ("hbm", "host", "disk"))


def timed_execute(ex, plan):
    """(result, counters, wall seconds, peak device bytes) of one execution
    on executor ``ex``, synchronised, its counters in a set of their own."""
    import torch

    from trino_tpu_torch.execution import tracing

    c = tracing.QueryCounters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with tracing.track_counters(c):
        res = ex.execute(plan)
    torch.cuda.synchronize()
    return res, c, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def unconstrained(engine, plan):
    """The unconstrained card run (default pool, no buffer pool): a warm-up,
    then the timed run.  -> (result, wall, peak)."""
    from trino_tpu_torch.exec.local_executor import LocalExecutor

    timed_execute(LocalExecutor(engine.catalogs, DEVICE), plan)
    res, _, wall, peak = timed_execute(LocalExecutor(engine.catalogs, DEVICE), plan)
    return res, wall, peak


@contextlib.contextmanager
def env_vars(**values):
    """Set (a string) or unset (None) environment variables for a block."""
    prev = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def spill_env(spill_dir, host_bytes=None):
    """TRINO_TPU_SPILL_DIR and TRINO_TPU_SPILL_HOST_BYTES for a forced run;
    ``spill_dir`` must be empty after it."""
    os.makedirs(spill_dir, exist_ok=True)
    with env_vars(TRINO_TPU_SPILL_DIR=spill_dir,
                  TRINO_TPU_SPILL_HOST_BYTES=None if host_bytes is None else str(host_bytes)):
        yield
    check(not os.listdir(spill_dir), f"spill files survived the query: {os.listdir(spill_dir)}")


def forced_run(engine, plan, label, own, log, pool, buffer, spill_dir, host_bytes=None):
    """One forced execution of ``plan`` on a fresh executor with a pool of
    ``pool`` bytes and a buffer pool of ``buffer`` (None: none); counted in
    ``own``; its spills from ``log``.  The leak check follows."""
    from trino_tpu_torch.exec.local_executor import LocalExecutor
    from trino_tpu_torch.execution import chaos_matrix as cm
    from trino_tpu_torch.execution.bufferpool import DeviceBufferPool
    from trino_tpu_torch.memory import MemoryPool

    bp = None if buffer is None else DeviceBufferPool(budget_bytes=buffer, device=DEVICE)
    ex = LocalExecutor(engine.catalogs, DEVICE, memory_pool=MemoryPool(max_bytes=pool),
                       buffer_pool=bp)
    log.take()
    with spill_env(spill_dir, host_bytes), own.region():
        res, c, wall, peak = timed_execute(ex, plan)
    tiers = log.take()
    check(not ex._spills and ex.memory_pool.info()["by_tag"].get("spill", 0) == 0,
          f"{label}: a spill or its reservation outlived the query")
    check(bp is None or bp.memory_pool is None
          or bp.memory_pool.info()["by_tag"].get("spill", 0) == 0,
          f"{label}: a device spill reservation outlived the query")
    leaks = cm.leak_report(engine)
    check(not leaks, f"{label}: leak check {leaks}")
    parts = sorted(st["spill_partitions"] for st in ex.stats.values()
                   if st.get("spill_partitions"))
    return {"result": res, "counters": c, "wall_s": wall, "peak_bytes": peak,
            "tiers": tiers, "spill_partitions": parts}


def spill_pressure(engine, scratch, own, log):
    """16a: PRESSURE's eight scenarios over SF1 orders, each held against
    the unconstrained card run, the leak check after each."""
    import torch

    from trino_tpu_torch.execution import chaos_matrix as cm
    from trino_tpu_torch.sql.frontend import compile_sql

    plan = compile_sql(cm.PRESSURE_QUERY, engine, engine.create_session("tpch"))
    base_res, base_wall, base_peak = unconstrained(engine, plan)
    base = cm.result_signature(base_res)
    out = {"unconstrained_s": base_wall, "unconstrained_peak_bytes": base_peak}
    print(f"spill 16a unconstrained: wall_s={base_wall:.4f} peak_bytes={base_peak}",
          flush=True)
    for name, cfg, spec, kind in cm.PRESSURE:
        d = os.path.join(scratch, name)
        os.makedirs(d)
        log.take()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with own.region():
            r = cm.run_pressure_scenario(engine, plan, base, name, cfg, spec, kind, d)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tiers = log.take()
        check(r["ok"], f"16a {name}: {({k: v for k, v in r.items() if k not in ('signature', 'counters')})}")
        leaks = cm.leak_report(engine)
        check(not leaks, f"16a {name}: leak check {leaks}")
        out[name] = {"kind": kind, "wall_s": wall, "ratio": wall / base_wall,
                     "peak_bytes": torch.cuda.max_memory_allocated(),
                     "error_type": r.get("error_type"), "fires": r.get("fires"),
                     "spill_partitions": r["spill_partitions"], "tiers": tiers}
        print(f"spill 16a {name} ({kind}): wall_s={wall:.4f} x{wall / base_wall:.2f} "
              f"peak_bytes={out[name]['peak_bytes']} parts={r['spill_partitions']} "
              f"error={r.get('error_type')} fires={r.get('fires')} {tier_text(tiers)}",
              flush=True)
    return out


def spill_q18(phase2, scratch, own, log):
    """16b: Q18 at SF1 under a 1 MiB pool, a 96 KiB host watermark and a
    128 KiB buffer pool (device, host and disk tiers), byte-identical to the
    unconstrained card run and equal to phase 2's (the port's CPU result);
    Q18 at SF10 under a 256 MiB pool (device and host tiers) against the
    unconstrained SF10 run."""
    import torch

    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.execution import chaos_matrix as cm
    from trino_tpu_torch.sql.frontend import compile_sql

    out = {}
    for sf, split, cfg in ((SF_MAIN, SPILL_SPLIT_ROWS, SPILL_Q18),
                           (SF_BIG, SPLIT_ROWS, SPILL_Q18_BIG)):
        label = f"16b q18 sf{sf:g}"
        engine = Engine(device=DEVICE)
        engine.register_catalog("tpch", TpchConnector(sf=sf, split_rows=split))
        plan = compile_sql(ALL_QUERIES["q18"], engine, engine.create_session("tpch"))
        full, full_wall, full_peak = unconstrained(engine, plan)
        r = forced_run(engine, plan, label, own, log, cfg["pool"], cfg["buffer"],
                       os.path.join(scratch, f"q18-sf{sf:g}"), cfg.get("host"))
        check(cm.result_signature(r["result"]) == cm.result_signature(full),
              f"{label}: the forced run differs from the unconstrained one")
        if sf == SF_MAIN:
            same_result(full, phase2["q18"], f"{label} unconstrained vs phase 2")
            same_result(r["result"], phase2["q18"], f"{label} forced vs phase 2")
        want = ("hbm", "host", "disk") if sf == SF_MAIN else ("hbm", "host")
        for tier in want:
            check(r["tiers"][tier]["bytes"] > 0, f"{label}: the {tier} tier took no bytes: "
                  f"{r['tiers']}")
        out[f"sf{sf:g}"] = {"rows": len(full), "unconstrained_s": full_wall,
                            "unconstrained_peak_bytes": full_peak, "wall_s": r["wall_s"],
                            "ratio": r["wall_s"] / full_wall, "peak_bytes": r["peak_bytes"],
                            "spill_partitions": r["spill_partitions"], "tiers": r["tiers"],
                            "config": cfg}
        print(f"spill {label}: rows={len(full)} unconstrained_s={full_wall:.4f} "
              f"forced_s={r['wall_s']:.4f} x{r['wall_s'] / full_wall:.2f} "
              f"peak {full_peak} -> {r['peak_bytes']} parts={r['spill_partitions']} "
              f"{tier_text(r['tiers'])}", flush=True)
        del engine, plan, full, r
        torch.cuda.empty_cache()
    return out


def spill_groups(scratch, own, log):
    """16c: the reference's at-scale test at full size: SF34 orders grouped
    by o_orderkey (51,000,000 groups, 1.5x MAX_GROUP_CAPACITY) under the
    default pool, which Grace-partitions."""
    import torch

    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.exec.local_executor import MAX_GROUP_CAPACITY, LocalExecutor
    from trino_tpu_torch.sql.frontend import compile_sql

    engine = Engine(device=DEVICE)
    engine.register_catalog("tpch", TpchConnector(sf=SPILL_SF_GROUPS, split_rows=SPLIT_ROWS))
    plan = compile_sql(SPILL_GROUPS_SQL, engine, engine.create_session("tpch"))
    ex = LocalExecutor(engine.catalogs, DEVICE)
    d = os.path.join(scratch, "groups")
    log.take()
    with spill_env(d), own.region():
        res, _c, wall, peak = timed_execute(ex, plan)
    tiers = log.take()
    n = int(SPILL_SF_GROUPS * 1_500_000)
    got = [tuple(int(x) for x in row) for row in res.rows()]
    check(got == [(n, n)], f"16c: {got} != {[(n, n)]}")
    spilled = [st for st in ex.stats.values() if st.get("spill_partitions")]
    check(spilled and spilled[0]["spill_partitions"] >= 4
          and spilled[0].get("spilled_bytes", 0) > 0,
          f"16c: the Grace-partitioned aggregation did not engage: {spilled}")
    out = {"groups": n, "max_group_capacity": MAX_GROUP_CAPACITY, "wall_s": wall,
           "peak_bytes": peak, "spill_partitions": spilled[0]["spill_partitions"],
           "spilled_bytes": spilled[0]["spilled_bytes"], "tiers": tiers,
           "groups_per_s": n / wall}
    print(f"spill 16c sf{SPILL_SF_GROUPS:g} orders by o_orderkey: {got} wall_s={wall:.3f} "
          f"groups/s={n / wall:.4g} peak_bytes={peak} parts={out['spill_partitions']} "
          f"spilled_bytes={out['spilled_bytes']} {tier_text(tiers)}", flush=True)
    del engine, ex, res
    torch.cuda.empty_cache()
    return out


def spill_join(scratch, own, log):
    """16d: orders joined with lineitem at SF10, grouped by o_orderpriority,
    and lineitem joined with partsupp on two keys, under a pool neither build
    fits: the partitioned join, each against its unconstrained run."""
    import torch

    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.execution import chaos_matrix as cm
    from trino_tpu_torch.sql.frontend import compile_sql

    engine = Engine(device=DEVICE)
    engine.register_catalog("tpch", TpchConnector(sf=SF_BIG, split_rows=SPLIT_ROWS))
    out = {}
    for name, sql in (("orders_lineitem", SPILL_JOIN_SQL),
                      ("lineitem_partsupp", SPILL_JOIN2_SQL)):
        label = f"16d {name}"
        plan = compile_sql(sql, engine, engine.create_session("tpch"))
        full, full_wall, full_peak = unconstrained(engine, plan)
        r = forced_run(engine, plan, label, own, log, SPILL_JOIN["pool"],
                       SPILL_JOIN["buffer"], os.path.join(scratch, name))
        check(cm.result_signature(r["result"]) == cm.result_signature(full),
              f"{label}: the partitioned join differs from the unconstrained run")
        check(any(p > 1 for p in r["spill_partitions"]),
              f"{label}: no partitioned join: {r['spill_partitions']}")
        out[name] = {"unconstrained_s": full_wall, "unconstrained_peak_bytes": full_peak,
                     "wall_s": r["wall_s"], "ratio": r["wall_s"] / full_wall,
                     "peak_bytes": r["peak_bytes"], "spill_partitions": r["spill_partitions"],
                     "tiers": r["tiers"], "config": SPILL_JOIN}
        print(f"spill {label} sf{SF_BIG:g}: unconstrained_s={full_wall:.4f} "
              f"forced_s={r['wall_s']:.4f} x{r['wall_s'] / full_wall:.2f} peak {full_peak} "
              f"-> {r['peak_bytes']} parts={r['spill_partitions']} {tier_text(r['tiers'])}",
              flush=True)
        del plan, full, r
        torch.cuda.empty_cache()
    return out


def spill_admission(engine):
    """16e: a hog reservation on the engine's pool past BLOCKED_FRACTION and a
    running statement: a second statement queues, completes once the hog is
    freed, and carries admission_queued 1."""
    import threading

    from trino_tpu_torch.execution.memory_killer import BLOCKED_FRACTION

    sess = engine.create_session("tpch")
    engine.execute_sql("select count(*) from nation", sess)
    pool = engine.memory_pool
    before = engine.counters_total.admission_queued
    hog = int(pool.max_bytes * (BLOCKED_FRACTION + 0.05)) - pool.reserved
    check(pool.try_reserve(hog, "hog"), "16e: the hog reservation was refused")
    group = engine.resource_groups.get_or_create("global.holder")
    engine.resource_groups.submit(group, lambda: None)
    done = {}
    t0 = time.perf_counter()
    t = threading.Thread(target=lambda: done.update(
        r=engine.execute_sql("select count(*) from nation", sess)))
    t.start()
    deadline = time.time() + 10
    while time.time() < deadline and engine.resource_groups.memory_queued_total == 0:
        time.sleep(0.005)
    queued = engine.resource_groups.memory_queued_total
    early = "r" in done
    time.sleep(0.05)
    pool.free(hog, "hog")
    engine.resource_groups.finish(group)
    t.join(timeout=60)
    wall = time.perf_counter() - t0
    check(not t.is_alive() and not early and queued >= 1,
          f"16e: queued={queued} finished early={early}")
    entry = engine.query_tracker.all_queries()[-1]
    check(entry.counters["admission_queued"] == 1
          and engine.counters_total.admission_queued == before + 1,
          f"16e: admission_queued {entry.counters['admission_queued']}")
    check(done["r"].rows()[0][0] == 25, "16e: the queued statement's result")
    info = entry.info()
    out = {"queued": queued, "wall_s": wall, "queued_s": info.queued_s}
    print(f"spill 16e admission: queued={queued} queued_s={info.queued_s} "
          f"wall_s={wall:.3f} admission_queued=1", flush=True)
    return out


def spill_path(phase2):
    """Phase 16: memory-bounded execution at SF1 to SF34 (the tiers and the
    advisor off, as phase 2 ran).  Returns (the record, launches of the
    phase's forced runs, {kernel: checks at their shapes})."""
    import tempfile

    import numpy as np
    import torch

    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector

    t_phase = time.perf_counter()
    own = OwnLaunches()
    log = SpillLog()
    rec = {}
    try:
        with tempfile.TemporaryDirectory(prefix="trino-spill-") as scratch:
            torch.cuda.empty_cache()
            conn = TpchConnector(sf=SF_MAIN, split_rows=SPILL_SPLIT_ROWS)
            engine = Engine(device=DEVICE)
            engine.register_catalog("tpch", conn)
            rec["pressure"] = spill_pressure(engine, scratch, own, log)
            rec["q18"] = spill_q18(phase2, scratch, own, log)
            rec["groups"] = spill_groups(scratch, own, log)
            rec["join"] = spill_join(scratch, own, log)
            rec["admission"] = spill_admission(engine)
    finally:
        log.close()
    launches = dict(own.launches)
    check(launches["hash_insert"] > 0 and launches["hash_probe"] > 0
          and launches["compact_rows"] > 0,
          f"the spill path launched no hash_insert, hash_probe or compact_rows: {launches}")
    # 16f: each kernel the path launched against its plain version at the
    # path's largest and most frequent shapes
    gen = np.random.default_rng(53)
    checks = {"hash_insert": insert_checks(own.shapes["hash_insert"],
                                           ("orders_orderkey",
                                            *split_keys(conn, "orders", "o_orderkey")), gen),
              "hash_probe": probe_checks(own.shapes["hash_probe"], gen),
              "compact_rows": compact_checks(own.shapes["compact_rows"], gen)}
    del engine
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"spill path: {rec['seconds']:.1f} s, launches of the forced runs {launches}",
          flush=True)
    print(json.dumps({"spill_sf1": rec}, default=str), flush=True)
    torch.cuda.empty_cache()
    return rec, launches, {k: {"max_abs_err": r["max_abs_err"], "shapes": r["shapes"]}
                           for k, r in checks.items()}


# -- phase 17: the fault injector at the local chokepoints and the chaos matrix --
CHAOS_PAGE_TIER = 6 << 30  # the page tier of the reference's chaos fixture (tests/test_chaos.py)
CHAOS_RESULT_TIER = 256 << 20  # 17b's result tier
CHAOS_RESULT_QUERIES = ("q1", "q3")
CHAOS_DISARMED_CALLS = 1_000_000  # 17e: timed disarmed maybe_inject calls
CPU_PASS_TIMEOUT_S = 600.0  # the most the join of a CPU child (phases 2, 5, 8) may wait
CPU_CHILD_THREADS = 2  # torch threads of the CPU children of phases 5, 8, 9 and 10


def timed_sync(fn):
    """(fn(), seconds), synchronised on both ends."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def chaos_local(engine, own):
    """17a: the eight ``SCENARIOS`` x ``QUERIES`` on one engine with the
    reference fixture's page tier.  A ``recover`` run is byte-identical to
    the query's fault-free baseline on the engine, a ``fail`` one raises
    the typed error; each fires at least once, the leak check is
    clean after each, and a fault-free rerun equals the baseline."""
    from trino_tpu_torch.execution import chaos_matrix as cm
    from trino_tpu_torch.execution import faults
    from trino_tpu_torch.execution.faults import InjectedFaultError

    session = engine.create_session("tpch")
    nocache = engine.create_session("tpch")
    engine.session_properties.set_property(nocache, "page_cache", False)
    out = {}
    for q, sql in cm.QUERIES.items():
        with own.region():
            engine.execute_sql(sql, session)  # cold: plans, fills the page tier
            base, base_s = timed_sync(lambda: cm.result_signature(
                engine.execute_sql(sql, session)))
        out[q] = {"baseline_s": base_s}
        print(f"chaos 17a {q}: fault-free warm wall_s={base_s:.4f}", flush=True)
        for name, spec, kind, clear_pool, cache_on in cm.SCENARIOS:
            if clear_pool:
                engine.buffer_pool.clear()  # the run regenerates and stores
            sess = session if cache_on else nocache
            with own.region(), faults.injected(spec) as plan:
                def run():
                    try:
                        return cm.result_signature(engine.execute_sql(sql, sess)), None
                    except InjectedFaultError as e:
                        return None, e
                (got, err), wall = timed_sync(run)
            fires = plan.total_fires()
            what = f"chaos 17a {q} {name}"
            check(fires >= 1, f"{what}: never fired: {plan.stats()}")
            if kind == "recover":
                check(err is None, f"{what}: a recoverable fault raised {err!r}")
                check(got == base, f"{what}: the result differs from the fault-free baseline")
            else:
                check(err is not None, f"{what}: no typed error was raised")
            leaks = cm.leak_report(engine)
            check(not leaks, f"{what}: leak check {leaks}")
            with own.region():
                again = cm.result_signature(engine.execute_sql(sql, session))
            check(again == base, f"{what}: the fault-free rerun differs from the baseline")
            out[q][name] = {"kind": kind, "fires": fires, "wall_s": wall,
                            "error_type": None if err is None else type(err).__name__}
            print(f"chaos 17a {q} {name} ({kind}): fires={fires} wall_s={wall:.4f} "
                  f"error={out[q][name]['error_type']}", flush=True)
    return out


def chaos_results(conn, own):
    """17b: ``RESULT_SCENARIOS`` on a result-enabled engine over q1 and q3,
    through ``run_result_scenario``."""
    from trino_tpu_torch import Engine
    from trino_tpu_torch.execution import chaos_matrix as cm

    with env_vars(TRINO_TPU_PAGE_CACHE="0", TRINO_TPU_RESULT_CACHE=str(CHAOS_RESULT_TIER)):
        engine = Engine(device=DEVICE)
        engine.register_catalog("tpch", conn)
        engine.buffer_pool.budget()  # both budgets are read at first use
        engine.buffer_pool.result_budget()
    s = engine.create_session("tpch")
    out = {}
    for q in CHAOS_RESULT_QUERIES:
        sql = cm.QUERIES[q]
        with own.region():
            engine.execute_sql(sql, s)
            base = cm.result_signature(engine.execute_sql(sql, s))
        for name, spec, kind in cm.RESULT_SCENARIOS:
            with own.region():
                rec, wall = timed_sync(lambda: cm.run_result_scenario(
                    engine, sql, s, base, name, spec, kind))
            check(rec.get("ok"), f"chaos 17b {q} {name}: {rec}")
            out[f"{q}/{name}"] = {"fires": rec["fires"], "wall_s": wall}
            print(f"chaos 17b {q} {name}: fires={rec['fires']} wall_s={wall:.4f} "
                  f"(byte-identical, no entry under a store fault, no leak)", flush=True)
    engine._invalidate()
    return out


def chaos_producer(scratch, own):
    """17c: faults that land on the spill readback's producer thread, on
    phase 16a's setup (``PRESSURE_QUERY`` over SF1 orders in
    ``SPILL_SPLIT_ROWS`` rows a split, the 512 KiB pool, the host tier and
    then the disk tier forced): each statement fails typed with one firing
    charged to it, and no producer thread outlives it."""
    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.execution import chaos_matrix as cm
    from trino_tpu_torch.sql.frontend import compile_sql

    conn = TpchConnector(sf=SF_MAIN, split_rows=SPILL_SPLIT_ROWS)
    engine = Engine(device=DEVICE)
    engine.register_catalog("tpch", conn)
    plan = compile_sql(cm.PRESSURE_QUERY, engine, engine.create_session("tpch"))
    base_res, _, _ = unconstrained(engine, plan)
    base = cm.result_signature(base_res)
    out = {}
    for name, cfg, spec in cm.producer_faults(len(conn.splits("orders"))):
        d = os.path.join(scratch, f"chaos-{name}")
        os.makedirs(d)
        with own.region():
            r, wall = timed_sync(lambda: cm.run_pressure_scenario(
                engine, plan, base, name, cfg, spec, "fail", d))
        what = f"chaos 17c {name} ({spec})"
        check(r["ok"], f"{what}: {({k: v for k, v in r.items() if k != 'counters'})}")
        check(r["error_type"] == "InjectedFaultError" and r["fires"] == 1
              and r["counters"].faults_injected == 1,
              f"{what}: error {r['error_type']} fires {r['fires']} faults_injected "
              f"{r['counters'].faults_injected}")
        left = cm.settle()
        check(not left, f"{what}: a producer outlived the statement: {left}")
        leaks = cm.leak_report(engine)
        check(not leaks, f"{what}: leak check {leaks}")
        out[name] = {"spec": spec, "wall_s": wall, "error_type": r["error_type"],
                     "faults_injected": r["counters"].faults_injected}
        print(f"chaos 17c {name}: {r['error_type']}, faults_injected="
              f"{r['counters'].faults_injected}, no producer left, wall_s={wall:.4f}",
              flush=True)
    return out


def chaos_observability(engine):
    """17d: the errored flight record of a ``fatal`` at ``dispatch``, the
    ``/v1/metrics`` fault and retry series, and EXPLAIN ANALYZE's clause."""
    import re

    from trino_tpu_torch.execution import chaos_matrix as cm
    from trino_tpu_torch.execution import faults
    from trino_tpu_torch.execution.faults import FatalInjectedFaultError
    from trino_tpu_torch.server.server import CoordinatorServer

    s = engine.create_session("tpch")
    # warm: the page tier holds q1's scan again (17a's store scenarios
    # cleared it), so the fault lands on the statement's own first dispatch
    # and not on the page store's staging, whose guard keeps a store
    # failure from failing a query, as the reference's does
    engine.execute_sql(cm.QUERIES["q1"], s)
    raised = None
    with faults.injected("point=dispatch,action=fatal,nth=1") as plan:
        try:
            engine.execute_sql(cm.QUERIES["q1"], s)
        except FatalInjectedFaultError as e:
            raised = str(e)
    check(raised is not None, f"chaos 17d: the fatal dispatch fault raised nothing: "
          f"{plan.stats()}")
    rec = engine.flight_recorder.snapshot(kind="query")[-1]
    check(rec["state"] == "FAILED" and rec["error"] == raised
          and "injected fatal at dispatch" in raised
          and rec["counters"]["faults_injected"] == 1,
          f"chaos 17d: record {rec['state']} error {rec['error']!r} faults "
          f"{rec['counters'].get('faults_injected')}")
    text = CoordinatorServer(engine)._metrics_text()
    series = {}
    for name in ("trino_tpu_faults_injected_total", "trino_tpu_task_retries_total"):
        m = re.search(rf"^{name} (\d+)$", text, re.M)
        check(m is not None and f"# TYPE {name} counter" in text,
              f"chaos 17d: /v1/metrics has no {name} series")
        series[name] = int(m.group(1))
    check(series["trino_tpu_faults_injected_total"] > 0,
          f"chaos 17d: the fault series reads {series}")
    with faults.injected("point=dispatch,action=delay,s=0,every=1"):
        r = engine.execute_sql(f"explain analyze {cm.QUERIES['q1']}", s)
    n = engine.last_query_counters["faults_injected"]
    text = "\n".join(str(row[0]) for row in r.rows())
    check(n > 0 and f"{n} faults injected" in text,
          f"chaos 17d: EXPLAIN ANALYZE names no faults ({n})")
    print(f"chaos 17d: flight record FAILED {raised!r}; metrics {series}; EXPLAIN ANALYZE "
          f"'{n} faults injected'", flush=True)
    return {"record_error": raised, "metrics": series, "explain_faults": n}


def wrapper_host_ms(kernels) -> dict:
    """Phase 3's host time of one call of each wrapper, at its first
    checked shape."""
    out = {}
    for r in kernels:
        shapes = r.get("shapes") or []
        split = shapes[0].get("split") if shapes else None
        out[r["name"]] = None if not split else split.get("host_ms")
    return out


def chaos_disarmed(counts2, host_ms):
    """17e: bench.py's five at SF1 on an engine configured as phase 2's
    (the tiers and the advisor off, the injector disarmed): launches, host
    reads and H2D bytes per query equal phase 2's; and the host time of a
    disarmed ``maybe_inject`` call."""
    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.execution import faults

    check(faults.active() is None, "chaos 17e: the injector is armed")
    with env_vars(TRINO_TPU_PAGE_CACHE="0", TRINO_TPU_RESULT_CACHE="0"):
        engine = Engine(device=DEVICE)
        engine.register_catalog("tpch", TpchConnector(sf=SF_MAIN, split_rows=SPLIT_ROWS))
        engine.buffer_pool.budget()
    out = {}
    for q, sql in QUERIES.items():
        before = launch_counts()
        engine.execute_sql(sql, engine.create_session("tpch"))
        c = engine.last_query_counters
        got = {"launches": {k: v - before[k] for k, v in launch_counts().items()},
               "host_reads": c["host_reads"], "h2d_bytes": c["h2d_bytes"]}
        check(got == counts2[q], f"chaos 17e {q}: {got} against phase 2's {counts2[q]}")
        out[q] = got
        print(f"chaos 17e {q}: launches, host reads ({got['host_reads']}) and H2D bytes "
              f"({got['h2d_bytes']}) equal phase 2's", flush=True)
    del engine
    mi = faults.maybe_inject

    def noop(point, site=None):
        return None

    timed = {}
    for label, fn in (("maybe_inject", mi), ("empty call", noop)):
        t0 = time.perf_counter_ns()
        for _ in range(CHAOS_DISARMED_CALLS):
            fn("dispatch", "hash_insert")
        timed[label] = (time.perf_counter_ns() - t0) / CHAOS_DISARMED_CALLS
    print(f"chaos 17e: a disarmed maybe_inject call {timed['maybe_inject']:.1f} ns "
          f"({timed['empty call']:.1f} ns for an empty call of the same arguments) over "
          f"{CHAOS_DISARMED_CALLS} calls; phase 3's wrapper host ms per call {host_ms}",
          flush=True)
    return {"queries": out, "maybe_inject_ns": timed["maybe_inject"],
            "empty_call_ns": timed["empty call"], "wrapper_host_ms": host_ms}


def chaos_path(counts2, host_ms):
    """Phase 17: the fault injector at the port's local chokepoints and the
    chaos matrix on the card at SF1 (the advisor off).  Returns (the
    record, launches of 17a-17c's statements, {kernel: checks at their
    shapes})."""
    import tempfile

    import numpy as np
    import torch

    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector

    t_phase = time.perf_counter()
    own = OwnLaunches()
    rec = {}
    torch.cuda.empty_cache()
    conn = TpchConnector(sf=SF_MAIN, split_rows=SPLIT_ROWS)
    with env_vars(TRINO_TPU_ADAPTIVE="0", TRINO_TPU_RESULT_CACHE="0"):
        with env_vars(TRINO_TPU_PAGE_CACHE=str(CHAOS_PAGE_TIER)):
            engine = Engine(device=DEVICE)
            engine.register_catalog("tpch", conn)
            check(engine.buffer_pool.budget() == CHAOS_PAGE_TIER,
                  "chaos: the page tier is not the fixture's")
        # 17a-17c fault the page loop's generate and h2d points, which the
        # scan-fused runners pass by; 17e runs at the defaults, as phase 2
        with env_vars(TRINO_TPU_SCAN_FUSED="0"):
            t0 = time.perf_counter()
            rec["local"] = chaos_local(engine, own)
            rec["local_s"] = time.perf_counter() - t0
            rec["observability"] = chaos_observability(engine)
            engine._invalidate()
            del engine
            torch.cuda.empty_cache()
            rec["results"] = chaos_results(conn, own)
            with tempfile.TemporaryDirectory(prefix="trino-chaos-") as scratch, \
                    env_vars(TRINO_TPU_PAGE_CACHE="0"):
                rec["producer"] = chaos_producer(scratch, own)
        rec["disarmed"] = chaos_disarmed(counts2, host_ms)
    launches = dict(own.launches)
    check(launches["hash_insert"] > 0 and launches["hash_probe"] > 0
          and launches["compact_rows"] > 0,
          f"the chaos path launched no hash_insert, hash_probe or compact_rows: {launches}")
    # 17f: each kernel the path launched against its plain version at the
    # path's largest and most frequent shapes
    li_keys = lineitem_keys(conn)
    gen = np.random.default_rng(59)
    checks = {"hash_insert": insert_checks(own.shapes["hash_insert"],
                                           ("lineitem_orderkey", *li_keys), gen),
              "hash_probe": probe_checks(own.shapes["hash_probe"], gen),
              "compact_rows": compact_checks(own.shapes["compact_rows"], gen)}
    del li_keys
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"chaos path: {rec['seconds']:.1f} s, launches of 17a-17c {launches}", flush=True)
    print(json.dumps({"chaos_sf1": rec}, default=str), flush=True)
    torch.cuda.empty_cache()
    return rec, launches, {k: {"max_abs_err": r["max_abs_err"], "shapes": r["shapes"]}
                           for k, r in checks.items()}


# -- phase 18: the connectors past the generators ------------------------------------
FED_SF = 0.5  # phase 18's scale: its walls are the host's (sqlite's fetch, the decode)
FED_TABLES = ("orders", "customer")  # 18a: written from the generator into sqlite
FED_SPLIT_ROWS = 1 << 16  # the dbapi connector's default rowid range a split
FED_DAY = 9204  # 1995-03-15 as epoch days: dates live in the remote table as integers
# 18b: TPC-H Q3 with orders read from the remote database
FED_Q3 = f"""select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
       o_orderdate, o_shippriority
from tpch.customer, db.orders, tpch.lineitem
where c_mktsegment = 'BUILDING' and c_custkey = o_custkey and l_orderkey = o_orderkey
  and o_orderdate < {FED_DAY} and l_shipdate > date '1995-03-15'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate, l_orderkey limit 10"""
# 18b: the remote copy reconciled with its source on two keys (a hashed table:
# a one-key join over a dense key range takes the direct table, no probe kernel)
FED_RECONCILE = """select count(*) c,
       sum(case when abs(r.o_totalprice - t.o_totalprice) > 0.005 then 1 else 0 end) bad
from db.orders r, tpch.orders t
where r.o_orderkey = t.o_orderkey and r.o_custkey = t.o_custkey"""
# 18c: 188 customers' orders (375 at SF1), looked up by key in the remote table
FED_INDEX = """select c_custkey, count(*) n, sum(o_totalprice) s
from tpch.customer, db.orders
where c_custkey = o_custkey and c_custkey % 400 = 1
group by c_custkey order by c_custkey"""
FED_INDEX_KEYS = (100, 500)  # the build's distinct keys the lookup must ship
# 18d: the TopN (ties on the date: held as multisets within a tied run) and
# the join pushed into the remote database with its key range (a fifth of
# the customers), which the remote query carries
FED_TOPN = ("select o_orderdate, o_custkey, o_totalprice from db.orders "
            "order by o_orderdate desc limit 20")
FED_TOPN_N = 20
FED_JOIN_CUSTKEYS = 15000
FED_JOIN_PUSH = f"""select c_mktsegment, count(*) c, sum(o_totalprice) s
from db.orders, db.customer where o_custkey = c_custkey and c_custkey <= {FED_JOIN_CUSTKEYS}
group by c_mktsegment order by c_mktsegment"""
# 18e: blackhole, 2^27 rows in 2^22-row pages
BH_PAGE_ROWS, BH_SPLITS = 1 << 22, 32
BH_GROUPS = 1000003
BH_AGG = "select count(*) n, min(id) lo, max(id) hi, sum(id) s, sum(v) sv from t"
BH_GROUP = (f"select count(*) g, sum(c) n, min(c) lo, max(c) hi from "
            f"(select id % {BH_GROUPS} k, count(*) c from t group by id % {BH_GROUPS})")
BH_INSERT = "insert into t select id, v from t where id % 128 = 0"
FILE_CONNECTORS = ("parquet", "orc", "filetable", "hive", "iceberg", "delta")
FED_PASS_THREADS = 2  # the phase's CPU child: sqlite is one thread, Q3's generation two
FED_PASS_TIMEOUT_S = 300.0  # the most the join of that child may wait
# the statements the child runs on the CPU, each held against the card's run
FED_CPU = {"q3": FED_Q3, "reconcile": FED_RECONCILE, "index": FED_INDEX,
           "topn": FED_TOPN, "join": FED_JOIN_PUSH}


def load_remote(path, conn):
    """18a: ``FED_TABLES`` from the generator into a sqlite file: dates as
    integer days, decimals as REAL (as a remote database of the dbapi
    connector's type mapping holds them), an index on each join key.
    Returns {table: rows}."""
    import sqlite3

    import numpy as np

    from trino_tpu_torch.types import DecimalType

    con = sqlite3.connect(path)
    con.execute("pragma journal_mode = off")
    con.execute("pragma synchronous = off")
    rows = {}
    for table in FED_TABLES:
        fields = conn.schema(table).fields
        dicts = conn.dictionaries(table)
        decl = ", ".join(
            f"{f.name} {'text' if f.type.is_string else 'real' if f.type.is_floating or isinstance(f.type, DecimalType) else 'integer'}"
            for f in fields)
        con.execute(f"create table {table} ({decl})")
        n = 0
        for split in conn.splits(table):
            page = conn.generate(split, list(conn.schema(table).names))
            live = page.valid_mask().cpu().numpy()
            cols = []
            for f, c in zip(fields, page.columns):
                a = c.cpu().numpy()[live]
                if f.type.is_string:
                    a = dicts[f.name].decode(a.astype(np.int64))
                elif isinstance(f.type, DecimalType):
                    a = a / 10 ** f.type.scale
                cols.append(a.tolist())
            con.executemany(f"insert into {table} values ({', '.join('?' * len(fields))})",
                            zip(*cols))
            n += len(cols[0])
        rows[table] = n
    con.execute("create index orders_custkey on orders (o_custkey)")
    con.execute("create index customer_custkey on customer (c_custkey)")
    con.commit()
    con.close()
    return rows


def fed_engine(path, device):
    """An engine on ``device`` with the remote database as ``db`` and the
    generator as ``tpch``, at SF1."""
    import sqlite3

    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.dbapi import DbapiConnector
    from trino_tpu_torch.connectors.tpch import TpchConnector

    e = Engine(device=device)
    e.register_catalog("db", DbapiConnector(lambda: sqlite3.connect(path),
                                            split_rows=FED_SPLIT_ROWS))
    e.register_catalog("tpch", TpchConnector(sf=FED_SF, split_rows=SPLIT_ROWS))
    return e


def fed_pass_child(out_path: str, threads: int) -> None:
    """Phase 18's CPU side, beside the card phases: 18a's load of the
    remote database (``remote.db`` beside ``out_path``, from the CPU
    generator, which makes the card's rows) and the port's CPU run of each
    ``FED_CPU`` statement over it; pickles the rows loaded, the load's and
    the metadata snapshot's seconds and each result with its seconds."""
    import pickle

    import torch

    from trino_tpu_torch.connectors.tpch import TpchConnector

    torch.set_num_threads(threads)
    t0 = time.perf_counter()
    path = os.path.join(os.path.dirname(out_path), "remote.db")
    rec = {"path": path, "threads": threads}
    rec["loaded"] = load_remote(path, TpchConnector(sf=FED_SF, split_rows=SPLIT_ROWS,
                                                    device="cpu"))
    rec["load_s"] = time.perf_counter() - t0
    rec["db_bytes"] = os.path.getsize(path)
    e = fed_engine(path, "cpu")
    t1 = time.perf_counter()
    for table in FED_TABLES:
        e.catalogs["db"].dictionaries(table)
    rec["snapshot_s"] = time.perf_counter() - t1
    rec["results"] = {}
    for label, sql in FED_CPU.items():
        t1 = time.perf_counter()
        res = e.execute_sql(sql, e.create_session("db"))
        rec["results"][label] = {"result": res, "seconds": time.perf_counter() - t1}
    rec["seconds"] = time.perf_counter() - t0
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(rec, f)
    os.replace(tmp, out_path)


def fed_run(card, cpu, sql, own, label, order_by=None, by_value=False, warm=True):
    """The statement on the card engine, its launches counted by ``own``,
    cold and (``warm``) warm, held against ``cpu``: the child's CPU record
    of the same statement, or None for a check of the caller's own."""
    import torch

    sess = card.create_session("db")
    walls = []
    for _ in range(2 if warm else 1):
        with own.region():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = card.execute_sql(sql, sess)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    counters = dict(card.last_query_counters)
    rec = {"rows": len(res), "cold_s": walls[0], "warm_s": walls[-1] if warm else None,
           "host_reads": counters.get("host_reads"), "h2d_bytes": counters.get("h2d_bytes")}
    if cpu is not None:
        same_result(res, cpu["result"], f"federation {label} card vs CPU", by_value=by_value,
                    order_by=order_by)
        rec["cpu_s"] = cpu["seconds"]
    print(f"federation {label}: {rec}", flush=True)
    return res, rec


def pushed_rows(conn, kind):
    """The rows the newest pushed handle of ``kind`` ships, read through
    the connector as a scan reads them."""
    handle = [h for h, sp in conn._pushed.items() if sp["kind"] == kind][-1]
    spec = conn._pushed[handle]
    names = [f.name for f in conn.schema(handle).fields]
    return spec, sum(conn.generate(sp, names[:1]).capacity for sp in conn.splits(handle))


def fed_index(card, cpu, own):
    """18c: the index join ships only the matched rows; EXPLAIN ANALYZE shows
    the key count; the rows equal the CPU's and the run with
    ``TRINO_TPU_INDEX_JOIN=0``."""
    import re

    import torch

    conn = card.catalogs["db"]
    before = conn.pushed_queries
    res, rec = fed_run(card, cpu["index"], FED_INDEX, own, "18c index join")
    check(conn.pushed_queries - before == 2,
          f"18c: {conn.pushed_queries - before} lookups in two statements")
    spec, shipped = pushed_rows(conn, "index")
    matched = int(sum(res.columns[1]))
    keys = len(spec["keys"])
    check(FED_INDEX_KEYS[0] <= keys <= FED_INDEX_KEYS[1], f"18c: {keys} lookup keys")
    check(shipped == matched, f"18c: the lookup shipped {shipped} rows for {matched} matches")
    text = "\n".join(str(r[0]) for r in card.execute_sql(
        "explain analyze " + FED_INDEX, card.create_session("db")).rows())
    m = re.search(r"\[index lookup: (\d+) keys\]", text)
    check(m is not None and int(m.group(1)) == keys,
          f"18c: EXPLAIN ANALYZE shows no index lookup of {keys} keys")
    with env_vars(TRINO_TPU_INDEX_JOIN="0"):
        sess = card.create_session("db")
        card.execute_sql(FED_INDEX, sess)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        off = card.execute_sql(FED_INDEX, sess)
        torch.cuda.synchronize()
        rec["off_warm_s"] = time.perf_counter() - t0
    same_result(res, off, "18c index join on vs off")
    rec.update(keys=keys, shipped=shipped, remote_rows=conn.row_count("orders"))
    print(f"federation 18c: {keys} keys, {shipped} rows shipped of "
          f"{rec['remote_rows']}; warm {rec['warm_s']:.4f} s, lookup off "
          f"{rec['off_warm_s']:.4f} s", flush=True)
    return rec


def fed_pushdowns(card, cpu, own, path):
    """18d: the TopN ships at most N rows; the join runs inside sqlite with
    its key range, shipping only the orders of ``FED_JOIN_CUSTKEYS``
    customers, counted in the sqlite file at ``path``; both equal the CPU
    run."""
    import sqlite3

    conn = card.catalogs["db"]
    rec = {}
    before = conn.pushed_queries
    _, rec["topn"] = fed_run(card, cpu["topn"], FED_TOPN, own, "18d topn",
                             order_by=("o_orderdate",))
    spec, shipped = pushed_rows(conn, "topn")
    check(conn.pushed_queries > before and shipped <= FED_TOPN_N,
          f"18d: the TopN shipped {shipped} rows")
    rec["topn"]["shipped"] = shipped
    before = conn.pushed_queries
    res, rec["join"] = fed_run(card, cpu["join"], FED_JOIN_PUSH, own, "18d join pushdown",
                               by_value=True)
    check(conn.pushed_queries > before and any(sp["kind"] == "join"
                                               for sp in conn._pushed.values()),
          "18d: the join did not run in the remote database")
    spec, shipped = pushed_rows(conn, "join")
    check(("c_custkey", "lte", FED_JOIN_CUSTKEYS) in spec["right_filter"],
          f"18d: the pushed join carries no key range: {spec}")
    con = sqlite3.connect(path)
    try:
        want = con.execute("select count(*) from orders where o_custkey <= ?",
                           (FED_JOIN_CUSTKEYS,)).fetchone()[0]
    finally:
        con.close()
    check(int(sum(res.columns[1])) == want == shipped,
          f"18d: the pushed join counted {int(sum(res.columns[1]))} and shipped "
          f"{shipped} of the {want} orders in its range")
    rec["join"].update(shipped=shipped, remote_rows=conn.row_count("orders"))
    return rec


def fed_blackhole(own):
    """18e: a blackhole table of 2^27 rows on the card against its oracle;
    an INSERT swallowed and counted."""
    import torch

    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.blackhole import BlackHoleConnector
    from trino_tpu_torch.page import Field, Schema
    from trino_tpu_torch.types import BIGINT, DOUBLE

    bh = BlackHoleConnector()
    bh.create_table("t", Schema((Field("id", BIGINT), Field("v", DOUBLE))),
                    rows_per_page=BH_PAGE_ROWS, pages_per_split=1, splits=BH_SPLITS)
    e = Engine(device=DEVICE)
    e.register_catalog("bh", bh)
    check(str(bh.device) == DEVICE, "18e: blackhole is not bound to the card")
    sess = e.create_session("bh")
    n = BH_PAGE_ROWS * BH_SPLITS
    rec = {}
    for label, sql, want in (
            ("agg", BH_AGG, [(n, 0, n - 1, n * (n - 1) // 2, 0.0)]),
            ("group", BH_GROUP, [(BH_GROUPS, n, n // BH_GROUPS, -(-n // BH_GROUPS))])):
        walls = []
        for _ in range(2):
            with own.region():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = e.execute_sql(sql, sess).rows()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
        check([tuple(r) for r in got] == want, f"18e {label}: {got} != {want}")
        rec[label] = {"cold_s": walls[0], "warm_s": walls[1], "rows_per_s": n / walls[1]}
    t0 = time.perf_counter()
    with own.region():
        ins = e.execute_sql(BH_INSERT, sess).rows()
    rec["insert_s"] = time.perf_counter() - t0
    check(ins == [(n // 128,)] and bh._tables["t"].inserted_rows == n // 128,
          f"18e: the INSERT counted {ins}, {bh._tables['t'].inserted_rows} rows")
    check(e.execute_sql("select count(*) from t", sess).rows()[0][0] == n,
          "18e: the INSERT was not swallowed")
    print(f"federation 18e blackhole: {rec}", flush=True)
    del e
    torch.cuda.empty_cache()
    return rec


FILES_SQL = {  # the file connectors on the card, each against the CPU engine
    "parquet": ("select o_orderstatus, count(*) c, sum(o_totalprice) s, min(o_orderdate) d, "
                "max(o_orderkey) k from orders group by o_orderstatus order by o_orderstatus"),
    "hive": "select ds, count(*) c, sum(v) s from ev group by ds order by ds",
    "orc": "select tag, count(*) c, sum(x) s from t group by tag order by tag",
}


def fed_files():
    """The file connectors need pyarrow: without it they are reported by
    name as skipped.  With it, SF1 orders written to Parquet (CTAS on the
    CPU), a partitioned Hive table (CREATE ... partitioned_by and INSERT)
    and an ORC file are scanned on the card, cold and warm (the page tier
    off: every run decodes and stages), their host-decoded pages staged by
    the prefetch producer, each result equal to the CPU engine's."""
    import importlib.util

    if importlib.util.find_spec("pyarrow") is None:
        print(f"federation: file connectors skipped (no pyarrow on this machine): "
              f"{', '.join(FILE_CONNECTORS)}", flush=True)
        return {"skipped": list(FILE_CONNECTORS)}
    import tempfile

    import pyarrow
    import torch

    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.hive import HiveConnector
    from trino_tpu_torch.connectors.orc import OrcConnector
    from trino_tpu_torch.connectors.parquet import ParquetConnector
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.types import BIGINT, DOUBLE, VarcharType

    rec = {"pyarrow": pyarrow.__version__}
    with tempfile.TemporaryDirectory(prefix="trino-files-") as d:
        src = Engine(device="cpu")
        src.register_catalog("tpch", TpchConnector(sf=FED_SF, split_rows=SPLIT_ROWS))
        src.register_catalog("pq", ParquetConnector(os.path.join(d, "pq")))
        src.register_catalog("hive", HiveConnector(os.path.join(d, "hive")))
        t0 = time.perf_counter()
        src.execute_sql("create table orders as select o_orderkey, o_custkey, o_orderstatus, "
                        "o_totalprice, o_orderdate from tpch.orders", src.create_session("pq"))
        rec["parquet_write_s"] = time.perf_counter() - t0
        hs = src.create_session("hive")
        src.execute_sql("create table ev (k bigint, v double, ds varchar) "
                        "with (partitioned_by = array['ds'])", hs)
        src.execute_sql("insert into ev select n_nationkey, n_nationkey * 1.5, r_name "
                        "from tpch.nation, tpch.region where n_regionkey = r_regionkey", hs)
        OrcConnector(os.path.join(d, "orc")).write_table(
            "t", ["k", "x", "tag"], [BIGINT, DOUBLE, VarcharType.of(None)],
            [list(range(3000)), [i * 0.5 for i in range(3000)],
             [None if i % 7 == 0 else f"tag{i % 5}" for i in range(3000)]])
        conns = {"parquet": lambda: ParquetConnector(os.path.join(d, "pq")),
                 "hive": lambda: HiveConnector(os.path.join(d, "hive")),
                 "orc": lambda: OrcConnector(os.path.join(d, "orc"))}
        for name, sql in FILES_SQL.items():
            out = {}
            for device in (DEVICE, "cpu"):
                e = Engine(device=device)
                e.register_catalog(name, conns[name]())
                sess = e.create_session(name)
                walls = []
                for _ in range(2):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out[device] = e.execute_sql(sql, sess)
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                if device == DEVICE:
                    rec[name] = {"cold_s": walls[0], "warm_s": walls[1],
                                 "h2d_bytes": e.last_query_counters["h2d_bytes"],
                                 "splits": len(e.catalogs[name].splits(
                                     "orders" if name == "parquet" else
                                     "ev" if name == "hive" else "t"))}
            same_result(out[DEVICE], out["cpu"], f"{name} card vs CPU", by_value=True)
            # at least a byte of each row of every column the statement
            # reads (parquet's four, the others' as many as they output)
            cols = 4 if name == "parquet" else len(out["cpu"].names)
            check(rec[name]["h2d_bytes"] >= cols * int(out["cpu"].columns[1].sum()),
                  f"{name}: {rec[name]['h2d_bytes']} bytes staged to the card")
    print(f"federation: pyarrow {rec['pyarrow']} on this machine, the file connectors on "
          f"the card: {rec}", flush=True)
    return rec


def federation_path(fed_pass):
    """Phase 18: the dbapi connector at SF1 beside the generator on the card
    (18a the load, made with the CPU runs in ``fed_pass``'s child beside the
    earlier phases; 18b a federated Q3 and a two-key reconciliation, 18c the
    index join, 18d the TopN and join pushdowns), blackhole at 2^27 rows
    (18e), and the kernels at the phase's shapes (18f).  Returns (the record,
    launches, {kernel: checks at their shapes})."""
    import numpy as np
    import torch

    t_phase = time.perf_counter()
    data, waited = fed_pass.join(FED_PASS_TIMEOUT_S)
    check(list(data["results"]) == list(FED_CPU),
          f"phase 18's CPU pass returned {sorted(data['results'])}")
    cpu = data["results"]
    rec = {k: data[k] for k in ("loaded", "load_s", "db_bytes", "snapshot_s")}
    rec["cpu_pass"] = {"seconds": data["seconds"], "threads": data["threads"],
                       "waited_s": waited}
    print(f"federation 18a: {rec['loaded']} rows into sqlite in {rec['load_s']:.2f} s "
          f"({rec['db_bytes']} bytes) in the child, whose CPU pass took "
          f"{data['seconds']:.1f} s; the join waited {waited:.1f} s", flush=True)
    own = OwnLaunches()
    torch.cuda.empty_cache()
    card = fed_engine(data["path"], DEVICE)
    t0 = time.perf_counter()
    for table in FED_TABLES:  # the metadata snapshot, outside the walls
        card.catalogs["db"].dictionaries(table)
    rec["card_snapshot_s"] = time.perf_counter() - t0
    with env_vars(TRINO_TPU_PAGE_CACHE="0", TRINO_TPU_RESULT_CACHE="0"):
        q3_launches = OwnLaunches()
        _, rec["q3"] = fed_run(card, cpu["q3"], FED_Q3, q3_launches, "18b q3")
        res, rec["reconcile"] = fed_run(card, cpu["reconcile"], FED_RECONCILE, q3_launches,
                                        "18b reconcile")
        check(res.rows() == [(rec["loaded"]["orders"], 0)],
              f"18b: the remote copy does not reconcile: {res.rows()}")
        # the connector decodes on the host: the executor stages its pages,
        # at least one 8-byte column of every remote row
        for label in ("q3", "reconcile"):
            check(rec[label]["h2d_bytes"] >= 8 * rec["loaded"]["orders"],
                  f"18b {label}: {rec[label]['h2d_bytes']} bytes staged to the card")
        for k in ("hash_insert", "hash_probe", "compact_rows"):
            check(q3_launches.launches[k] > 0, f"18b launched no {k} kernel: "
                                               f"{q3_launches.launches}")
        for k in own.launches:
            own.launches[k] += q3_launches.launches[k]
            own.shapes[k].extend(q3_launches.shapes[k])
        rec["q3"]["launches"] = dict(q3_launches.launches)
        rec["index"] = fed_index(card, cpu, own)
        rec["pushdowns"] = fed_pushdowns(card, cpu, own, data["path"])
    keys = split_keys(card.catalogs["db"], "orders", "o_orderkey")
    del card
    torch.cuda.empty_cache()
    rec["blackhole"] = fed_blackhole(own)
    with env_vars(TRINO_TPU_PAGE_CACHE="0", TRINO_TPU_RESULT_CACHE="0"):
        rec["files"] = fed_files()
    launches = dict(own.launches)
    # 18f: each kernel the path launched against its plain version at the
    # path's largest and most frequent shapes
    gen = np.random.default_rng(61)
    checks = {"hash_insert": insert_checks(own.shapes["hash_insert"],
                                           ("remote_orderkey", *keys), gen),
              "hash_probe": probe_checks(own.shapes["hash_probe"], gen),
              "compact_rows": compact_checks(own.shapes["compact_rows"], gen)}
    del keys
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"federation path: {rec['seconds']:.1f} s, launches {launches}", flush=True)
    print(json.dumps({"federation_sf1": rec}, default=str), flush=True)
    torch.cuda.empty_cache()
    return rec, launches, {k: {"max_abs_err": r["max_abs_err"], "shapes": r["shapes"]}
                           for k, r in checks.items()}


# -- phase 2's CPU parity pass, in a child process ----------------------------------
# -- phase 19: the worker mesh ------------------------------------------------------
DIST_SPLIT_ROWS = 1 << 18  # 19a/19c: lineitem ~23 splits at SF1, about 3 a position
DIST_POSITIONS = 8  # 19a, 19c: a virtual mesh of 8 positions over the card
DIST_BIG_POSITIONS = 4  # 19b at SF10
DIST_BIG_QUERIES = ("q1", "q3", "q9", "q18")  # bench.py --distributed's set
DIST_BIG_ORDER_BY = {"q1": ("l_returnflag", "l_linestatus"), "q3": ("revenue", "o_orderdate"),
                     "q9": ("nation", "o_year"), "q18": ("o_totalprice", "o_orderdate")}


def dist_sites(counters) -> dict:
    """Host bytes read at each ``dist.*`` site of a statement's counters."""
    return {k: v["bytes"] for k, v in sorted(counters.get("sites", {}).items())
            if "dist." in k}


def dist_statement(engine, sql, sess, mesh, own):
    """One statement on the mesh through ``execute_sql``, cold then warm,
    each in ``own``'s launch region: (cold result, warm result, record)."""
    import torch

    out, walls, rec = [], [], {}
    for i in range(2):
        torch.cuda.synchronize()
        if i == 0:
            torch.cuda.reset_peak_memory_stats()
        with own.region():
            t0 = time.perf_counter()
            out.append(engine.execute_sql(sql, sess, distributed=True, mesh=mesh))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        c = engine.last_query_counters
        if i == 0:
            rec = {"cold_s": walls[0], "peak_bytes": torch.cuda.max_memory_allocated(),
                   "exec_trace": engine.last_exec_trace, "dist_site_bytes": dist_sites(c)}
        else:
            rec.update(warm_s=walls[1], host_reads=c.get("host_reads"),
                       warm_dist_site_bytes=dist_sites(c),
                       skew=[round(r["ratio"], 3) for r in c.get("shard_stats", [])])
    return out[0], out[1], rec


def dist_queries(mesh, own):
    """19a: the 16 DIST_QUERIES at SF1 on the mesh, cold and warm, each held
    against the local card run at the same split size."""
    import torch

    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector

    engine = Engine(device=DEVICE)
    conn = TpchConnector(sf=SF_MAIN, split_rows=DIST_SPLIT_ROWS)
    engine.register_catalog("tpch", conn)
    sess = engine.create_session("tpch")
    print(f"19a: lineitem {len(conn.splits('lineitem'))} splits, orders "
          f"{len(conn.splits('orders'))} of {DIST_SPLIT_ROWS} rows", flush=True)
    rec = {}
    for name, sql in DIST_QUERIES.items():
        engine.execute_sql(sql, sess)  # the local run, cold
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        local = engine.execute_sql(sql, sess)
        torch.cuda.synchronize()
        local_warm = time.perf_counter() - t0
        cold, warm, r = dist_statement(engine, sql, sess, mesh, own)
        for what, res in (("cold", cold), ("warm", warm)):
            same_result(res, local, f"19a {name} {what} mesh vs local",
                        order_by=DIST_ORDER_BY[name])
        modes = [m for _, m, _ in r["exec_trace"] or []]
        check("mesh" in modes, f"19a {name}: no fragment ran on the mesh: {r['exec_trace']}")
        if name in DIST_NO_LOCAL:
            check("local" not in modes, f"19a {name} ran a local fragment: {r['exec_trace']}")
        r.update(rows=len(local), local_warm_s=local_warm)
        rec[name] = r
        print(f"19a {name}: {json.dumps(r, default=str)}", flush=True)
    del engine
    torch.cuda.empty_cache()
    return rec


def dist_big(phase4, own):
    """19b: bench.py's Q1, Q3, Q9 and Q18 at SF10 on ``worker_mesh(4)``,
    held against phase 4's local results, warm walls beside phase 4's."""
    import torch

    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.parallel.mesh import worker_mesh

    mesh = worker_mesh(DIST_BIG_POSITIONS)
    conn = TpchConnector(sf=SF_BIG, split_rows=SPLIT_ROWS)
    engine = Engine(device=DEVICE)
    engine.register_catalog("tpch", conn)
    sess = engine.create_session("tpch")
    li_rows = conn.exact_row_count("lineitem")
    rec = {}
    for q in DIST_BIG_QUERIES:
        cold, warm, r = dist_statement(engine, QUERIES[q], sess, mesh, own)
        for what, res in (("cold", cold), ("warm", warm)):
            same_result(res, phase4[q]["result"], f"19b sf{SF_BIG:g} {q} {what} vs phase 4",
                        order_by=DIST_BIG_ORDER_BY[q])
        r.update(lineitem_rows_per_s=li_rows / r["warm_s"],
                 local_warm_s=phase4[q]["warm_s"],
                 local_rows_per_s=phase4[q]["rows_per_s"])
        rec[q] = r
        print(f"19b sf{SF_BIG:g} {q} on {mesh}: {json.dumps(r, default=str)}", flush=True)
    del engine
    torch.cuda.empty_cache()
    return rec


def dist_chaos(mesh, own):
    """19c: the six DIST_SCENARIOS at SF1 on the mesh, each firing at least
    once, recovering byte-identical or failing typed, with the leak check
    and a fault-free rerun (``chaos_matrix.run_dist_scenario``)."""
    import torch

    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.execution import chaos_matrix as cm

    engine = Engine(device=DEVICE)
    engine.register_catalog("tpch", TpchConnector(sf=SF_MAIN, split_rows=DIST_SPLIT_ROWS))
    sess = engine.create_session("tpch")
    baselines = {k: cm.result_signature(engine.execute_sql(sql, sess))
                 for k, sql in cm.DIST_QUERIES.items()}
    rec = {}
    for name, query, spec, kind in cm.DIST_SCENARIOS:
        t0 = time.perf_counter()
        with own.region():
            r = cm.run_dist_scenario(engine, cm.DIST_QUERIES[query], sess, mesh,
                                     baselines[query], name, spec, kind)
        r["seconds"] = time.perf_counter() - t0
        check(r.get("ok") and r.get("fires", 0) >= 1, f"19c {name}: {r}")
        rec[name] = r
    print(f"19c: {json.dumps(rec, default=str)}", flush=True)
    del engine
    torch.cuda.empty_cache()
    return rec


def distributed_path(phase4):
    """Phase 19: the worker mesh, a virtual 8-position mesh over the card.
    Returns (the record, launches of 19a and 19c, {kernel: checks at their
    shapes})."""
    import numpy as np
    import torch

    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.parallel.mesh import worker_mesh

    t_phase = time.perf_counter()
    mesh = worker_mesh(DIST_POSITIONS)
    print(f"phase 19: {mesh.size} positions over {[str(d) for d in mesh.distinct_devices]}",
          flush=True)
    own, big_own = OwnLaunches(), OwnLaunches()
    rec = {"positions": mesh.size, "devices": [str(d) for d in mesh.distinct_devices]}
    with env_vars(TRINO_TPU_ADAPTIVE="0", TRINO_TPU_RESULT_CACHE="0",
                  TRINO_TPU_PAGE_CACHE="0"):
        t0 = time.perf_counter()
        rec["queries"] = dist_queries(mesh, own)
        rec["queries_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec["big"] = dist_big(phase4, big_own)
        rec["big_s"] = time.perf_counter() - t0
        rec["big_launches"] = dict(big_own.launches)
        t0 = time.perf_counter()
        rec["chaos"] = dist_chaos(mesh, own)
        rec["chaos_s"] = time.perf_counter() - t0
    launches = dict(own.launches)
    check(launches["hash_insert"] > 0 and launches["hash_probe"] > 0
          and launches["compact_rows"] > 0,
          f"the distributed path launched no hash_insert, hash_probe or compact_rows: "
          f"{launches}")
    # 19d: each kernel the path launched against its plain version at the
    # path's largest and most frequent shapes
    conn = TpchConnector(sf=SF_MAIN, split_rows=DIST_SPLIT_ROWS, device=DEVICE)
    li_keys = lineitem_keys(conn)
    gen = np.random.default_rng(61)
    checks = {"hash_insert": insert_checks(own.shapes["hash_insert"],
                                           ("lineitem_orderkey", *li_keys), gen),
              "hash_probe": probe_checks(own.shapes["hash_probe"], gen),
              "compact_rows": compact_checks(own.shapes["compact_rows"], gen)}
    del li_keys
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"distributed path: {rec['seconds']:.1f} s, launches of 19a and 19c {launches}, "
          f"of 19b {rec['big_launches']}", flush=True)
    print(json.dumps({"distributed_sf1": rec}, default=str), flush=True)
    torch.cuda.empty_cache()
    return rec, launches, {k: {"max_abs_err": r["max_abs_err"], "shapes": r["shapes"]}
                           for k, r in checks.items()}


# -- phase 20: fault-tolerant execution and the multi-process cluster -------------
CLUSTER_SPLIT_ROWS = 1 << 18  # lineitem in 23 splits at SF1, 12 tasks of two
CLUSTER_WORKERS = 2  # worker processes on the one card
CLUSTER_POOL_BYTES = 12 << 30  # each worker's share of the card's memory pool
CLUSTER_CACHE_BYTES = 1 << 30  # and of its page cache
CLUSTER_FTE = ("q1", "q3", "q9", "q18")  # 20a
CLUSTER_BENCH = ("q1", "q3", "q4", "q9", "q18")  # 20b: bench.py's five; its q3 and
# q9 are also tests/test_cluster.py's join queries, statement for statement
CLUSTER_NO_FALLBACK = ("q1", "q9", "q18")
CLUSTER_BIG = ("q1", "q9")  # 20b at SF10, against phase 4
CLUSTER_ORDER_BY = DIST_BIG_ORDER_BY
# 20a's bisection: Q18's inner group-by; two splits' 74,898 orders overflow the
# 65,536-slot first table, and the pool refuses the grown one
CLUSTER_BISECT_SQL = "select l_orderkey, sum(l_quantity) q from lineitem group by l_orderkey"
CLUSTER_LONG_SPLIT_ROWS = 1 << 16  # 20d and 20e's long scan: lineitem in 161 splits
CLUSTER_LONG_SPLITS = 64  # 20d's long task takes the first 64 of them
CLUSTER_POINT_SQL = ("select c_custkey, c_acctbal from customer "
                     "order by c_acctbal desc, c_custkey limit 3")
# the spool's frame codec in phase 20: every worker shares the host, and zlib
# level 1 (the default where zstandard is missing, as on the card machine)
# doubled SF10 Q9's cluster wall (PERF.md §6; scripts/cluster_codec_ab.py)
CLUSTER_PAGE_CODEC = "none"
CLUSTER_WORKER_START_S = 180.0
CLUSTER_WORKER_DEVICE = None  # the workers' device: None is the card (no --device)


def cluster_catalogs(sf_big):
    """The workers' catalogs: SF1 in 2^18-row splits, SF1 in 2^16 (20d-20e),
    and SF10 in bench.py's 2^21 (20b), each generating on the worker's
    device."""
    return {"tpch": {"connector": "tpch", "sf": SF_MAIN, "split_rows": CLUSTER_SPLIT_ROWS},
            "tpch_long": {"connector": "tpch", "sf": SF_MAIN,
                          "split_rows": CLUSTER_LONG_SPLIT_ROWS},
            "tpch_big": {"connector": "tpch", "sf": sf_big, "split_rows": SPLIT_ROWS}}


def cluster_engine(sf_big):
    """The coordinator's engine over the workers' catalogs, on the card."""
    from trino_tpu_torch import Engine
    from trino_tpu_torch.server.cluster import build_catalogs

    engine = Engine(device=DEVICE)
    for name, conn in build_catalogs(cluster_catalogs(sf_big), None).items():
        engine.register_catalog(name, conn)
    return engine


def start_workers(url, spool, n, log_dir, env_extra=None):
    """``n`` worker processes on the card, started as a user would
    (``python -m trino_tpu_torch.server.cluster``, no ``--device``: the
    card), each with its share of the pool and the cache."""
    import subprocess

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""),
               **(env_extra or {}))
    procs = []
    for i in range(n):
        log = open(os.path.join(log_dir, f"w{i}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "trino_tpu_torch.server.cluster", "--coordinator", url,
             "--catalogs", json.dumps(cluster_catalogs(SF_BIG)), "--spool", spool,
             "--node-id", f"w{i}", "--pool-bytes", str(CLUSTER_POOL_BYTES),
             "--cache-bytes", str(CLUSTER_CACHE_BYTES)]
            + ([] if CLUSTER_WORKER_DEVICE is None else ["--device", CLUSTER_WORKER_DEVICE]),
            env=env, stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def stop_workers(procs):
    for p, log in procs:
        if p.poll() is None:
            p.terminate()
    for p, log in procs:
        try:
            p.wait(timeout=30)
        except Exception:  # noqa: BLE001 - a worker that ignores SIGTERM
            p.kill()
            p.wait(timeout=30)
        log.close()


def worker_info(coord):
    """Each live worker's /v1/info."""
    from trino_tpu_torch.server.cluster import _http

    out = {}
    for w in list(coord.workers.values()):
        try:
            out[w.node_id] = json.loads(_http(f"{w.url}/v1/info", timeout=5.0))
        except Exception:  # noqa: BLE001 - a dead worker has none
            pass
    return out


def worker_kernels(coord):
    """Each live worker process's kernel launches and launch shapes."""
    from trino_tpu_torch.server.cluster import _http

    out = {}
    for w in list(coord.workers.values()):
        if w.alive:
            out[w.node_id] = json.loads(_http(f"{w.url}/v1/kernels", timeout=5.0))
    return out


def cluster_statement(coord, sql, sess, cl):
    """One statement through the coordinator, cold then warm: (cold result,
    warm result, record); each run's merged launches add to ``cl``."""
    import torch

    out, rec = [], {}
    for i in range(2):
        fb = coord.local_fallbacks
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out.append(coord.execute_sql(sql, sess))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c, w = coord.last_query_counters, coord._qc_workers
        for k, v in c.launches.items():
            cl[k] = cl.get(k, 0) + v
        strag = [s for s in c.shard_stats if s.get("kind") == "task"]
        rec["cold_s" if i == 0 else "warm_s"] = wall
        if i == 1:
            rec.update(tasks=coord._task_seq, local_fallbacks=coord.local_fallbacks - fb,
                       launches=dict(c.launches), worker_launches=dict(w.launches),
                       worker_dispatches=w.device_dispatches,
                       worker_host_bytes=w.host_bytes, host_reads=c.host_reads,
                       spool_bytes=coord.last_spool_bytes,
                       straggler={k: strag[-1][k] for k in ("ratio", "imbalance_s", "labels")}
                       if strag else None)
    return out[0], out[1], rec


def cluster_fte(engine, own):
    """20a: bench.py's Q1, Q3, Q9, Q18 with ``fault_tolerant=True`` against
    the local card run; Q1 under injected failures; a memory failure that
    bisects partial tasks under a small pool."""
    import torch

    from trino_tpu_torch.exec import fte as F
    from trino_tpu_torch.memory import MemoryPool
    from trino_tpu_torch.sql.frontend import compile_sql

    sess = engine.create_session("tpch")
    rec = {}
    for q in CLUSTER_FTE:
        # the local runs plan and cache the statement (FTE shares the plan
        # cache's entry) and build nothing else: the port compiles no plan,
        # so the one FTE run is warm
        walls = []
        for mode in ("local", "local", "fte"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with own.region():
                res = engine.execute_sql(QUERIES[q], sess, fault_tolerant=mode == "fte")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if mode == "local":
                local = res
        same_result(res, local, f"20a {q} fte vs local", order_by=CLUSTER_ORDER_BY[q])
        fx = engine._fte_executor
        rec[q] = {"local_warm_s": walls[1], "fte_warm_s": walls[2],
                  "spool_bytes": fx.last_spool_bytes, "tasks": len(fx.task_attempts),
                  "retries": sum(a - 1 for a in fx.task_attempts.values())}
        print(f"20a {q}: {json.dumps(rec[q])}", flush=True)
    # Q1 under TASK_FAILURE x2, TASK_GET_RESULTS_FAILURE and POST_COMMIT_FAILURE
    inj = F.FailureInjector()
    inj.inject(0, "TASK_FAILURE", times=2)
    inj.inject(1, "TASK_GET_RESULTS_FAILURE", times=1)
    inj.inject(2, "POST_COMMIT_FAILURE", times=1)
    with tempfile.TemporaryDirectory() as d:
        ex = F.FaultTolerantExecutor(engine.catalogs, d, injector=inj, device=engine.device,
                                     memory_pool=engine.memory_pool)
        with own.region():
            got = ex.execute(compile_sql(QUERIES["q1"], engine, sess))
    same_result(got, engine.execute_sql(QUERIES["q1"], sess), "20a q1 injected vs local")
    check(ex.task_attempts[0] == 3 and ex.task_attempts[1] == 2 and ex.task_attempts[2] == 1,
          f"20a injected attempts {ex.task_attempts}")
    rec["injected"] = {"attempts": {str(k): v for k, v in ex.task_attempts.items() if v > 1}}
    # the bisection: the pool holds the first table, not the grown one
    plan = compile_sql(CLUSTER_BISECT_SQL, engine, sess)
    agg = plan
    while not hasattr(agg, "aggs"):
        agg = agg.child
    key_types = tuple(agg.child.schema.fields[i].type for i in agg.keys)
    acc_specs = [(dt, init) for s in agg.aggs for _k, dt, init in F._accumulators_for(s)]
    pool = MemoryPool(device=DEVICE,
                      max_bytes=3 * F._state_bytes(F.DEFAULT_GROUP_CAPACITY, key_types,
                                                   acc_specs))
    calls = []
    orig = F._partial_once

    def spy(local, node, kt, specs, splits, tick=None):
        calls.append(len(splits))
        return orig(local, node, kt, specs, splits, tick)

    F._partial_once = spy
    try:
        with tempfile.TemporaryDirectory() as d:
            ex = F.FaultTolerantExecutor(engine.catalogs, d, device=engine.device,
                                         memory_pool=pool)
            t0 = time.perf_counter()
            with own.region():
                got = ex.execute(plan)
            bisect_s = time.perf_counter() - t0
    finally:
        F._partial_once = orig
    want = engine.execute_sql(CLUSTER_BISECT_SQL, sess)
    same_result(by_order(got, 0), by_order(want, 0), "20a bisected group-by vs local")
    # a task of one split is the scan's odd last one, or a bisection's half
    odd = len(engine.catalogs["tpch"].splits("lineitem")) % 2
    check(max(calls) == 2 and calls.count(1) >= 2 + odd and pool.reserved == 0,
          f"20a: no bisection under the small pool: {calls}, {pool.reserved} reserved")
    rec["bisect"] = {"pool_bytes": pool.max_bytes, "task_sizes": dict(
        collections.Counter(calls)), "seconds": bisect_s, "rows": len(got)}
    print(f"20a injected {rec['injected']}, bisection {rec['bisect']}", flush=True)
    return rec


def by_order(res, col):
    """A result with its rows ordered by raw column ``col`` (a group-by
    without ORDER BY returns its groups in table order)."""
    import numpy as np

    order = np.argsort(np.asarray(res.raw_columns[col]), kind="stable")
    return dataclasses.replace(res, columns=[np.asarray(c)[order] for c in res.columns],
                               raw_columns=[np.asarray(c)[order] for c in res.raw_columns])


def cluster_queries(coord, engine, phase4, cl):
    """20b: bench.py's five at SF1 and Q1, Q9 at SF10 through the
    coordinator and the worker processes, each against the local card run
    at the same split size (SF10: phase 4's results)."""
    import torch

    sess = engine.create_session("tpch")
    sess.properties["page_cache"] = False  # the workers' page tier off, as phase 2
    rec = {}
    for q in CLUSTER_BENCH:
        engine.execute_sql(QUERIES[q], sess)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        local = engine.execute_sql(QUERIES[q], sess)
        torch.cuda.synchronize()
        local_warm = time.perf_counter() - t0
        cold, warm, r = cluster_statement(coord, QUERIES[q], sess, cl)
        for what, res in (("cold", cold), ("warm", warm)):
            same_result(res, local, f"20b {q} {what} cluster vs local",
                        order_by=CLUSTER_ORDER_BY.get(q))
        if q in CLUSTER_NO_FALLBACK:
            check(r["local_fallbacks"] == 0, f"20b {q} fell back: {coord.last_fallback_error}")
        r["local_warm_s"] = local_warm
        rec[q] = r
        print(f"20b {q}: {json.dumps(r, default=str)}", flush=True)
    big = engine.create_session("tpch_big")
    big.properties["page_cache"] = False
    for q in CLUSTER_BIG:
        cold, warm, r = cluster_statement(coord, QUERIES[q], big, cl)
        for what, res in (("cold", cold), ("warm", warm)):
            same_result(res, phase4[q]["result"], f"20b sf{SF_BIG:g} {q} {what} vs phase 4",
                        order_by=CLUSTER_ORDER_BY[q])
        check(r["local_fallbacks"] == 0, f"20b sf{SF_BIG:g} {q} fell back")
        r["local_warm_s"] = phase4[q]["warm_s"]
        rec[f"{q}_sf{SF_BIG:g}"] = r
        print(f"20b sf{SF_BIG:g} {q}: {json.dumps(r, default=str)}", flush=True)
    check(coord.shipped_fragments > 0, "20b shipped no fragment")
    return rec


def cluster_kill(coord, engine, procs, local_q9):
    """20c: SIGKILL one worker process in the middle of Q9; the query
    recovers on the other."""
    import signal
    import threading

    import torch

    from trino_tpu_torch.execution.chaos_matrix import leak_report

    sess = engine.create_session("tpch")
    sess.properties["page_cache"] = False
    out = {}

    def run():
        try:
            out["res"] = coord.execute_sql(QUERIES["q9"], sess)
        except Exception as e:  # noqa: BLE001 - reported below
            out["err"] = e

    seq0 = coord._task_seq
    t0 = time.perf_counter()
    th = threading.Thread(target=run)
    coord._task_seq = 0
    th.start()
    deadline = time.time() + 30
    while coord._task_seq < 2 and th.is_alive() and time.time() < deadline:
        time.sleep(0.005)
    victim = procs[1][0]
    os.kill(victim.pid, signal.SIGKILL)
    killed_at = time.perf_counter() - t0
    # the card as this process sees it while the dead process's context is
    # torn down: one small copy and a synchronise
    t1 = time.perf_counter()
    torch.ones(1, device=DEVICE).add_(1).cpu()
    torch.cuda.synchronize()
    card_probe_s = time.perf_counter() - t1
    th.join(120)
    check(not th.is_alive() and "res" in out, f"20c: Q9 did not recover: {out.get('err')}")
    same_result(out["res"], local_q9, "20c q9 after a worker's SIGKILL")
    victim.wait(30)
    leaks = leak_report(engine)
    check(not leaks, f"20c SIGKILL leaks {leaks}")
    rec = {"killed_at_s": killed_at, "wall_s": time.perf_counter() - t0,
           "card_probe_after_kill_s": card_probe_s,
           "task_retries": coord.last_query_counters.task_retries,
           "stream_retries": coord.stream_retries,
           "retry_schedule": [(t, a, round(d, 3)) for t, a, d in coord.last_retry_schedule],
           "local_fallbacks": coord.local_fallbacks, "tasks_before": seq0,
           "live_workers": [w.node_id for w in coord.live_workers()],
           "wall_breakdown": {k: round(v, 3) for k, v in
                              (coord.last_query_trace.get("wall_breakdown") or {}).items()
                              if isinstance(v, float)}}
    print(f"20c SIGKILL: {json.dumps(rec)}", flush=True)
    return rec


def cluster_faults(coord, engine, local, leaks):
    """20c on in-process card workers: the ``task`` point fires on Q9 and
    the query retries; a dropped commit is dispatched again; an exhausted
    retry budget raises; the leak report is clean after each."""
    from trino_tpu_torch.exec.fte import FailureInjector, FaultTolerantExecutor
    from trino_tpu_torch.execution import faults
    from trino_tpu_torch.execution.chaos_matrix import leak_report
    from trino_tpu_torch.sql.frontend import compile_sql

    sess = engine.create_session("tpch")
    sess.properties["page_cache"] = False
    rec = {}
    for name, spec, q in (("task-error", "point=task,action=error,nth=1", "q9"),
                          ("dropped-commit", "point=exchange_write,action=drop,nth=1", "q1")):
        t0 = time.perf_counter()
        with faults.injected(spec) as plan:
            got = coord.execute_sql(QUERIES[q], sess)
        same_result(got, local[q], f"20c {name} {q}", order_by=CLUSTER_ORDER_BY[q])
        r = {"fires": plan.total_fires(), "task_retries": coord.last_query_counters.task_retries,
             "wall_s": time.perf_counter() - t0, "fallbacks": coord.local_fallbacks,
             "leaks": leak_report(engine)}
        check(r["fires"] == 1 and r["task_retries"] >= 1 and not r["leaks"],
              f"20c {name}: {r}")
        rec[name] = r
    # an exhausted budget: the FTE executor raises its typed message, and a
    # cluster query whose every task fails records the budget and answers
    # from the coordinator's executor
    inj = FailureInjector()
    inj.inject(0, "TASK_FAILURE", times=5)
    with tempfile.TemporaryDirectory() as d:
        ex = FaultTolerantExecutor(engine.catalogs, d, injector=inj, max_attempts=2,
                                   device=engine.device, memory_pool=engine.memory_pool)
        try:
            ex.execute(compile_sql(QUERIES["q1"], engine, sess))
            raised = None
        except RuntimeError as e:
            raised = str(e)
    check(raised is not None and "failed after 2 attempts" in raised, f"20c fte budget: {raised}")
    budget, coord.max_query_retries = coord.max_query_retries, 2
    fb = coord.local_fallbacks
    try:
        with faults.injected("point=task,action=error,every=1") as plan:
            got = coord.execute_sql(QUERIES["q1"], sess)
    finally:
        coord.max_query_retries = budget
    same_result(got, local["q1"], "20c exhausted budget q1 (answered locally)",
                order_by=CLUSTER_ORDER_BY["q1"])
    check(coord.local_fallbacks == fb + 1
          and "retry budget exhausted" in (coord.last_fallback_error or ""),
          f"20c cluster budget: {coord.last_fallback_error}")
    rec["budget"] = {"fte": raised.splitlines()[0][:120], "fires": plan.total_fires(),
                     "leaks": leak_report(engine)}
    check(not rec["budget"]["leaks"], f"20c budget leaks {rec['budget']['leaks']}")
    leaks.extend(r.get("leaks", []) for r in rec.values())
    print(f"20c faults: {json.dumps(rec, default=str)}", flush=True)
    return rec


def cluster_fair(spool, url_engine):
    """20d: on a one-slot worker a point query overtakes a long scan: the
    point query's wall alone and beside the scan."""
    from trino_tpu_torch.exec.fte import SpoolingExchange
    from trino_tpu_torch.server.cluster import WorkerServer, _dumps_fragment, _http
    from trino_tpu_torch.sql import plan as P
    from trino_tpu_torch.sql.frontend import compile_sql

    engine = url_engine
    sess = engine.create_session("tpch_long")
    with env_vars(TRINO_TPU_WORKER_EXEC_SLOTS="1", TRINO_TPU_SCHED_QUANTUM="0.05"):
        w = WorkerServer(cluster_catalogs(SF_BIG), spool, node_id="fair",
                         pool_bytes=CLUSTER_POOL_BYTES, cache_bytes=0,
                         device=CLUSTER_WORKER_DEVICE)
    url = w.start()
    try:
        long_plan = compile_sql(CLUSTER_BISECT_SQL, engine, sess)
        agg = long_plan
        while not isinstance(agg, P.Aggregate):
            agg = agg.child
        splits = tuple(engine.catalogs["tpch_long"].splits("lineitem"))[:CLUSTER_LONG_SPLITS]
        short = compile_sql(CLUSTER_POINT_SQL, engine, sess)
        _http(f"{url}/v1/fragment", _dumps_fragment({"fragment_id": "long", "plan": agg}))
        _http(f"{url}/v1/fragment", _dumps_fragment({"fragment_id": "short", "plan": short}))

        def run(tid, frag, kind, xdir, **extra):
            _http(f"{url}/v1/task", pickle.dumps({"task_id": tid, "fragment_id": frag,
                                                  "kind": kind, "exchange_dir": xdir,
                                                  **extra}))

        def wait(ex, tid, timeout=120):
            deadline = time.time() + timeout
            while not ex.is_committed(tid):
                st = json.loads(_http(f"{url}/v1/task/{tid}"))
                check(st.get("state") != "failed" and time.time() < deadline,
                      f"20d {tid}: {st.get('error')}")
                time.sleep(0.002)

        xdir = os.path.join(spool, "fair")
        ex = SpoolingExchange(xdir)
        walls = []
        for i in range(2):  # the point query alone, cold then warm
            t0 = time.perf_counter()
            run(f"alone{i}", "short", "fragment", xdir)
            wait(ex, f"alone{i}")
            walls.append(time.perf_counter() - t0)
        t_long = time.perf_counter()
        run("long", "long", "partial_agg", xdir, splits=splits)
        time.sleep(0.3)  # the long task holds the only slot
        t0 = time.perf_counter()
        run("beside", "short", "fragment", xdir)
        wait(ex, "beside")
        beside = time.perf_counter() - t0
        long_running = json.loads(_http(f"{url}/v1/task/long"))["state"] == "running"
        wait(ex, "long", 300)
        long_s = time.perf_counter() - t_long
        sched = json.loads(_http(f"{url}/v1/info"))["scheduler"]
        check(long_running or sched["preemptions"] >= 1,
              f"20d: the point query waited for the scan: {sched}")
        check(beside < long_s, f"20d: the point query took {beside:.3f} s of the scan's "
              f"{long_s:.3f} s")
        rec = {"point_alone_s": walls, "point_beside_s": beside, "long_s": long_s,
               "long_splits": len(splits), "long_running_at_point_end": long_running,
               "preemptions": sched["preemptions"]}
        print(f"20d fair scheduler: {json.dumps(rec)}", flush=True)
        return rec
    finally:
        w.stop()


def cluster_memory_ladder(coord, workers, engine, local_q1):
    """20e: a worker whose pool is blocked sheds its cache first, then the
    policy kills the query holding the most memory there, which dies with
    QueryKilledError at its next reservation while another query completes;
    a running query whose key is killed fails with QueryKilledError and is
    not rerun locally; ``cluster_memory()`` sums the nodes; a worker drains
    gracefully."""
    import threading

    from trino_tpu_torch.memory import QueryKilledError

    sess = engine.create_session("tpch")
    mem = coord.cluster_memory()
    check(mem["total_max"] == sum(w.memory_pool.max_bytes for w in workers),
          f"20e: cluster_memory {mem['total_max']} is not the nodes' sum")
    coord.execute_sql("select o_orderpriority, count(*) from orders group by 1", sess)
    cached = {w.node_id: w.buffer_pool.info()["bytes"] for w in workers}
    hog = max(workers, key=lambda w: cached[w.node_id])
    check(cached[hog.node_id] > 0, f"20e: no worker cached a page: {cached}")
    # the hog: a query holding 95% of one worker's pool
    kills0, sheds0 = coord.oom_kills, hog.cache_sheds
    fill = int(hog.memory_pool.max_bytes * 0.95)
    t0 = time.perf_counter()
    with hog.memory_pool.query_scope("hog-query"):
        check(hog.memory_pool.try_reserve(fill, "group-by"), "20e: the hog did not fit")
    try:
        deadline = time.time() + 30
        while time.time() < deadline and coord.oom_kills == kills0:
            time.sleep(0.01)
        killed_s = time.perf_counter() - t0
        rungs = [e["rung"] for e in coord.pressure_events[-2:]]
        check(coord.oom_kills == kills0 + 1 and coord.last_oom_victim == "hog-query"
              and rungs == ["evict-cache", "kill"], f"20e ladder {coord.pressure_events[-3:]}")
        check(hog.cache_sheds > sheds0 and hog.buffer_pool.info()["bytes"] == 0,
              "20e: the blocked worker kept its cache")
        # the kill lands on the worker through its /v1/kill_query
        died, deadline = False, time.time() + 10
        while not died and time.time() < deadline:
            with hog.memory_pool.query_scope("hog-query"):
                try:
                    hog.memory_pool.check_killed()
                    time.sleep(0.01)
                except QueryKilledError:
                    died = True
        with hog.memory_pool.query_scope("hog-query"):
            try:
                hog.memory_pool.try_reserve(1, "group-by")
                died = False
            except QueryKilledError:
                pass
        check(died, "20e: the victim reserved again")
    finally:
        with hog.memory_pool.query_scope("hog-query"):
            hog.memory_pool.free(fill, "group-by")
    same_result(coord.execute_sql(QUERIES["q1"], sess), local_q1, "20e q1 beside the kill",
                order_by=CLUSTER_ORDER_BY["q1"])
    # a running query killed on every worker fails typed, not rerun locally
    out = {}

    def run():
        try:
            out["res"] = coord.execute_sql(CLUSTER_BISECT_SQL,
                                           engine.create_session("tpch_long"))
        except Exception as e:  # noqa: BLE001 - the kill, checked below
            out["err"] = e

    fb = coord.local_fallbacks
    th = threading.Thread(target=run)
    th.start()
    key = None
    deadline = time.time() + 60
    while key is None and th.is_alive() and time.time() < deadline:
        for w in workers:
            with w._wlock:
                keys = list(w._running_queries)
            if keys:
                key = keys[0]
        time.sleep(0.002)
    for w in workers:
        w.memory_pool.kill_query(key)
    th.join(120)
    check(not th.is_alive() and isinstance(out.get("err"), QueryKilledError)
          and coord.local_fallbacks == fb,
          f"20e: the killed query ended with {out.get('err')!r}, {coord.local_fallbacks - fb} "
          "local reruns")
    rec = {"hog_killed_after_s": killed_s, "rungs": rungs,
           "cache_sheds": hog.cache_sheds - sheds0, "cached_before": cached,
           "admission_denials": sum(w.admission_denials for w in workers),
           "cluster_memory_total_max": mem["total_max"], "running_victim": key}
    w = workers[-1]
    w.shutdown_gracefully()
    deadline = time.time() + 30
    while time.time() < deadline and w.node_id in coord.workers:
        time.sleep(0.02)
    check(w.node_id not in coord.workers, "20e: the drained worker never left")
    rec["drained"] = w.node_id
    print(f"20e memory ladder: {json.dumps(rec, default=str)}", flush=True)
    return rec


def cluster_path(phase4):
    """Phase 20: fault-tolerant execution and the multi-process cluster on
    the card.  Returns (the record, the cluster path's launches: 20b's
    merged counters, {kernel: checks at the path's shapes})."""
    import shutil

    import numpy as np
    import torch

    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.server.cluster import ClusterCoordinator, WorkerServer

    from trino_tpu_torch.exec import fte

    t_phase = time.perf_counter()
    rec = {"workers": CLUSTER_WORKERS, "pool_bytes": CLUSTER_POOL_BYTES,
           "cache_bytes": CLUSTER_CACHE_BYTES, "page_codec": CLUSTER_PAGE_CODEC}
    own = OwnLaunches()  # this process's launches: 20a and the coordinator's
    cl = {}  # the cluster path's merged launches (workers and coordinator)
    spool = tempfile.mkdtemp(prefix="trino-cluster-")
    procs = []
    codec, fte.PAGE_CODEC = fte.PAGE_CODEC, CLUSTER_PAGE_CODEC  # read per frame
    try:
        with env_vars(TRINO_TPU_ADAPTIVE="0", TRINO_TPU_RESULT_CACHE="0",
                      TRINO_TPU_PAGE_CACHE="0", TRINO_TPU_PAGE_CODEC=CLUSTER_PAGE_CODEC):
            engine = cluster_engine(SF_BIG)
            coord = ClusterCoordinator(engine, spool, heartbeat_interval=0.2)
            url = coord.start()
            procs = start_workers(url, spool, CLUSTER_WORKERS, spool)  # ~10 s to the card
            t0 = time.perf_counter()
            rec["fte"] = cluster_fte(engine, own)
            rec["fte_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            coord.wait_for_workers(CLUSTER_WORKERS, timeout=CLUSTER_WORKER_START_S)
            rec["workers_waited_s"] = time.perf_counter() - t0
            info = worker_info(coord)
            check(all(i["device"].startswith(CLUSTER_WORKER_DEVICE or "cuda")
                      for i in info.values()), f"a worker is not on its device: {info}")
            stream0 = sum(i["stream_bytes_served"] for i in info.values())
            t0 = time.perf_counter()
            with own.region():
                rec["queries"] = cluster_queries(coord, engine, phase4, cl)
            rec["queries_s"] = time.perf_counter() - t0
            info = worker_info(coord)
            rec["stream_bytes"] = sum(i["stream_bytes_served"] for i in info.values()) - stream0
            rec["shipped_fragments"] = coord.shipped_fragments
            kernels_seen = worker_kernels(coord)
            local = {q: engine.execute_sql(QUERIES[q], engine.create_session("tpch"))
                     for q in ("q1", "q9")}
            t0 = time.perf_counter()
            rec["kill"] = cluster_kill(coord, engine, procs, local["q9"])
            rec["kill_s"] = time.perf_counter() - t0
            stop_workers(procs)
            procs = []
            coord.stop()
            # 20c-20e on workers in this process, on the card
            t0 = time.perf_counter()
            coord = ClusterCoordinator(engine, spool, heartbeat_interval=0.2)
            url = coord.start()
            workers = [WorkerServer(cluster_catalogs(SF_BIG), spool, coordinator_url=url,
                                    node_id=f"in{i}", announce_interval=0.2,
                                    pool_bytes=CLUSTER_POOL_BYTES,
                                    cache_bytes=CLUSTER_CACHE_BYTES,
                                    device=CLUSTER_WORKER_DEVICE)
                       for i in range(2)]
            try:
                for w in workers:
                    w.start()
                coord.wait_for_workers(2, timeout=60)
                leaks = []
                with own.region():
                    rec["faults"] = cluster_faults(coord, engine, local, leaks)
                    rec["fair"] = cluster_fair(spool, engine)
                    rec["ladder"] = cluster_memory_ladder(coord, workers, engine, local["q1"])
            finally:
                for w in workers:
                    w.stop()
                coord.stop()
            rec["in_process_s"] = time.perf_counter() - t0
    finally:
        fte.PAGE_CODEC = codec
        stop_workers(procs)
        shutil.rmtree(spool, ignore_errors=True)
    check(cl.get("hash_insert", 0) > 0 and cl.get("hash_probe", 0) > 0
          and cl.get("compact_rows", 0) > 0,
          f"the cluster path launched no hash_insert, hash_probe or compact_rows: {cl}")
    # 20f: each kernel the path launched against its plain version at the
    # path's largest and most frequent shapes: the worker processes' shapes
    # and this process's (the coordinator's merges and finishes, 20a, the
    # in-process workers)
    shapes = {k: list(v) for k, v in own.shapes.items()}
    for ks in kernels_seen.values():
        for k, v in ks.items():
            shapes[k].extend(tuple(tuple(y) if isinstance(y, list) else y for y in x)
                             for x in v["shapes"])
    conn = TpchConnector(sf=SF_MAIN, split_rows=CLUSTER_SPLIT_ROWS, device=DEVICE)
    li_keys = lineitem_keys(conn)
    gen = np.random.default_rng(67)
    checks = {"hash_insert": insert_checks(shapes["hash_insert"],
                                           ("lineitem_orderkey", *li_keys), gen),
              "hash_probe": probe_checks(shapes["hash_probe"], gen),
              "compact_rows": compact_checks(shapes["compact_rows"], gen)}
    del li_keys
    launches = {k: cl.get(k, 0) for k in own.launches}
    rec["launches"] = launches
    rec["worker_process_launches"] = {n: {k: v["launches"] for k, v in ks.items()}
                                      for n, ks in kernels_seen.items()}
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"cluster path: {rec['seconds']:.1f} s, launches of 20b (merged) {launches}",
          flush=True)
    print(json.dumps({"cluster_sf1": rec}, default=str), flush=True)
    torch.cuda.empty_cache()
    return rec, launches, {k: {"max_abs_err": r["max_abs_err"], "shapes": r["shapes"]}
                           for k, r in checks.items()}


# -- phase 21: dispatch coalescing and the scan-fused runners -----------------------
# (label, TRINO_TPU_DISPATCH_BATCH, TRINO_TPU_SCAN_FUSED)
COALESCE_MODES = (("per-split", "1", "0"), ("coalesced", "4", "0"), ("defaults", "4", "1"))
COALESCE_WARM = 3  # warm walls per query and mode; the median is kept
# 21b: a warm run of each under the profiler (Q1 and Q4's per-split loops
# read the host and launch the port's kernels once per scan: 21a holds their
# coalescing by the device operations the profile counts)
COALESCE_BUSY = ("q1", "q3", "q4")
COALESCE_REPLAY = ("q1", "q3")  # 21c: their fused scans, graph against eager
FUSED_RUNNERS = ("_run_aggregate_scan_fused", "_run_global_scan_fused", "_concat_traced")


def busy_share(engine, sql):
    """A warm run's wall (the statement ran before), the device time the
    profiler saw (the sum of its device operations, graph replays' kernels
    included) and their ratio."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sess = engine.create_session("tpch")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.execute_sql(sql, sess)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = device_events(prof)
    device_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    return {"wall_ms": wall * 1e3, "device_ms": device_ms, "device_ops": len(dev),
            "busy_share": device_ms / (wall * 1e3) if wall else None}


def fused_state_rows(key, state):
    """A fused scan's final state as host arrays to compare: a hash table's
    occupied slots as (packed key, key columns, accumulators) rows sorted by
    the packed key (its slot layout follows the claim races); any other
    state leaf as it is."""
    import numpy as np

    from trino_tpu_torch.ops.hashing import EMPTY_KEY

    arrs = [t.cpu().numpy() for t in state]
    if key[:1] != ("agg",) or key[2:3] != ("hash",):
        return arrs
    table = arrs[0][:-1]
    occ = table != EMPTY_KEY
    order = np.argsort(table[occ], kind="stable")
    return [a[:-1][occ][order] for a in arrs[:-1]] + [arrs[-1]]


def replay_against_eager(engine, sql, label):
    """21c: every fused scan of ``sql``, over its first split, run eagerly
    and replayed as a captured graph; integer leaves bit for bit, DOUBLE
    within rtol 1e-9.  Returns one record per scan."""
    import numpy as np

    import trino_tpu_torch.exec.local_executor as LE

    out = []
    orig = LE.LocalExecutor._fused_scan

    def both(self, key, node, site, los, state, aux, body):
        one = tuple(los[:1])
        runs = {}
        for graphs in (False, True):
            LE.FUSED_GRAPHS = graphs
            try:
                runs[graphs] = orig(self, key + ("one-split",), node, site, one,
                                    [t.clone() for t in state], aux, body)
            finally:
                LE.FUSED_GRAPHS = True
        a, b = fused_state_rows(key, runs[False]), fused_state_rows(key, runs[True])
        err = 0.0
        for x, y in zip(a, b):
            check(x.shape == y.shape, f"21c {label} {key[0]}: state shapes differ")
            if x.dtype.kind == "f":
                check(np.allclose(x, y, rtol=1e-9, equal_nan=True),
                      f"21c {label} {key[0]}: a DOUBLE leaf differs past rtol 1e-9")
                if x.size:
                    err = max(err, float(np.max(np.abs(x - y))))
            else:
                check(np.array_equal(x, y), f"21c {label} {key[0]}: an integer leaf differs")
        out.append({"scan": key[0], "mode": str(key[2]) if len(key) > 2 else None,
                    "leaves": len(a), "max_abs_err": err})
        return orig(self, key, node, site, los, state, aux, body)

    LE.LocalExecutor._fused_scan = both
    try:
        engine.execute_sql(sql, engine.create_session("tpch"))
    finally:
        LE.LocalExecutor._fused_scan = orig
    return out


def coalesce_path():
    """Phase 21: bench.py's five at SF10 per-split, coalesced and at the
    defaults (21a), the busy share of warm Q1 and Q3 in each mode (21b), and
    the fused scans of Q1 and Q3 replayed as graphs against their eager
    bodies (21c), and each kernel against its plain version at 21a's shapes
    (21d).  Returns (the record, the launches of 21a, the checks of 21d)."""
    import numpy as np
    import torch

    import trino_tpu_torch.exec.local_executor as LE
    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector

    t_phase = time.perf_counter()
    own = OwnLaunches()
    took: dict = {}
    originals = {n: getattr(LE.LocalExecutor, n) for n in FUSED_RUNNERS}

    def counting(name):
        def run(self, *a, _orig=originals[name], **k):
            out = _orig(self, *a, **k)
            if out is not None:
                took[name] = took.get(name, 0) + 1
            return out
        return run

    rec = {"modes": {}}
    results = {}
    conn = TpchConnector(sf=SF_BIG, split_rows=SPLIT_ROWS)
    rec["lineitem_splits"] = len(conn.splits("lineitem"))
    torch.cuda.empty_cache()
    try:
        for name in FUSED_RUNNERS:
            setattr(LE.LocalExecutor, name, counting(name))
        for label, batch, fused in COALESCE_MODES:
            with env_vars(TRINO_TPU_DISPATCH_BATCH=batch, TRINO_TPU_SCAN_FUSED=fused,
                          TRINO_TPU_PAGE_CACHE="0", TRINO_TPU_RESULT_CACHE="0",
                          TRINO_TPU_ADAPTIVE="0"):
                engine = Engine(device=DEVICE)
                engine.register_catalog("tpch", conn)
                mode = rec["modes"][label] = {"queries": {}}
                for q, sql in QUERIES.items():
                    sess = engine.create_session("tpch")
                    took.clear()
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    with own.region():
                        t0 = time.perf_counter()
                        res = engine.execute_sql(sql, sess)
                        torch.cuda.synchronize()
                        cold = time.perf_counter() - t0
                    c = dict(engine.last_query_counters)
                    runners = dict(took)
                    warm, warm_captures = [], 0
                    for _ in range(COALESCE_WARM):
                        t0 = time.perf_counter()
                        again = engine.execute_sql(sql, sess)
                        torch.cuda.synchronize()
                        warm.append(time.perf_counter() - t0)
                        warm_captures += engine.last_query_counters["graph_captures"]
                    same_result(res, again, f"21a {q} {label} warm vs cold",
                                order_by=DIST_ORDER_BY.get(q))
                    results[(label, q)] = res
                    if label != "per-split":
                        same_result(results[("per-split", q)], res,
                                    f"21a {q} {label} vs per-split",
                                    order_by=DIST_ORDER_BY.get(q))
                    launches = {k: v for k, v in c["launches"].items() if v}
                    mode["queries"][q] = {
                        "cold_s": cold, "warm_s": statistics.median(warm), "warm_all_s": warm,
                        "launches": launches, "host_reads": c["host_reads"],
                        "dispatches": c["host_reads"] + sum(launches.values()),
                        "coalesced_splits": c["coalesced_splits"],
                        "graph_captures": c["graph_captures"],
                        "graph_replays": c["graph_replays"], "warm_captures": warm_captures,
                        "fused_runners": runners,
                        "peak_bytes": torch.cuda.max_memory_allocated()}
                    print(f"21a {label} {q}: cold_s={cold} warm_s={statistics.median(warm)} "
                          f"launches={launches} host_reads={c['host_reads']} "
                          f"coalesced={c['coalesced_splits']} captures={c['graph_captures']} "
                          f"replays={c['graph_replays']} warm_captures={warm_captures} "
                          f"runners={runners} peak={torch.cuda.max_memory_allocated()}",
                          flush=True)
                for q in COALESCE_BUSY:
                    mode["queries"][q]["busy"] = busy_share(engine, QUERIES[q])
                    print(f"21b {label} {q}: {mode['queries'][q]['busy']}", flush=True)
                cache = engine._fused_cache
                mode["graphs"] = cache.graphs()
                mode["graph_pool_bytes"] = cache.pool_bytes
                mode["pool_held_bytes"] = engine.memory_pool.info()["by_tag"].get(
                    cache.TAG, 0)
                mode["reserved_bytes"] = torch.cuda.memory_reserved()
                engine._invalidate()
                del engine
                torch.cuda.empty_cache()
    finally:
        for name, fn in originals.items():
            setattr(LE.LocalExecutor, name, fn)
    per, coal, dflt = (rec["modes"][m]["queries"] for m, _, _ in COALESCE_MODES)
    for q in QUERIES:
        check(coal[q]["coalesced_splits"] > 0 and per[q]["coalesced_splits"] == 0,
              f"21a {q}: coalesced_splits {per[q]['coalesced_splits']} per-split, "
              f"{coal[q]['coalesced_splits']} coalesced")
        # the port's per-split Q1 and Q4 read the host and launch its kernels
        # once per scan, not per split: there the width shows in the device
        # operations the host issues (torch's kernels and copies with them)
        ops = (coal[q].get("busy", {}).get("device_ops"),
               per[q].get("busy", {}).get("device_ops"))
        check(coal[q]["dispatches"] <= per[q]["dispatches"]
              and (coal[q]["dispatches"] < per[q]["dispatches"]
                   or (None not in ops and ops[0] < ops[1])),
              f"21a {q}: coalesced reads and launches {coal[q]['dispatches']}, device "
              f"ops {ops[0]}; per-split {per[q]['dispatches']}, {ops[1]}")
        check(dflt[q]["warm_captures"] == 0,
              f"21a {q}: a warm run at the defaults captured {dflt[q]['warm_captures']} graphs")
    check(dflt["q1"]["fused_runners"].get("_run_aggregate_scan_fused", 0) > 0,
          f"21a q1: the fused grouped runner did not take Q1 ({dflt['q1']['fused_runners']})")
    check(dflt["q1"]["graph_replays"] >= rec["lineitem_splits"],
          f"21a q1: {dflt['q1']['graph_replays']} replays for "
          f"{rec['lineitem_splits']} lineitem splits")
    # 21c at SF1, the defaults
    with env_vars(TRINO_TPU_SCAN_FUSED="1", TRINO_TPU_PAGE_CACHE="0",
                  TRINO_TPU_RESULT_CACHE="0", TRINO_TPU_ADAPTIVE="0"):
        engine = Engine(device=DEVICE)
        engine.register_catalog("tpch", TpchConnector(sf=SF_MAIN, split_rows=SPLIT_ROWS))
        rec["replay_vs_eager"] = {q: replay_against_eager(engine, QUERIES[q], q)
                                  for q in COALESCE_REPLAY}
        del engine
    for q, scans in rec["replay_vs_eager"].items():
        check(scans, f"21c {q}: no fused scan ran")
    # 21d: each kernel 21a launched against its plain version at the largest
    # and most frequent shapes of its cold runs in the three modes (the
    # coalesced groups, the graphs' bodies), and on SF10's own lineitem keys
    launches = dict(own.launches)
    check(all(launches[k] > 0 for k in ("hash_insert", "hash_probe", "compact_rows")),
          f"21a launched no hash_insert, hash_probe or compact_rows: {launches}")
    li_keys = lineitem_keys(TpchConnector(sf=SF_BIG, split_rows=SPLIT_ROWS, device=DEVICE))
    gen = np.random.default_rng(71)
    checks = {"hash_insert": insert_checks(own.shapes["hash_insert"],
                                           ("lineitem_orderkey_sf10", *li_keys), gen),
              "hash_probe": probe_checks(own.shapes["hash_probe"], gen),
              "compact_rows": compact_checks(own.shapes["compact_rows"], gen)}
    del li_keys
    rec["checks"] = {k: {"max_abs_err": r["max_abs_err"],
                         "shapes": [x["shape"] for x in r["shapes"]]}
                     for k, r in checks.items()}
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"coalesce path: {rec['seconds']:.1f} s, launches of 21a {launches}", flush=True)
    print(json.dumps({"coalesce_sf10": rec}, default=str), flush=True)
    torch.cuda.empty_cache()
    return rec, launches, {k: {"max_abs_err": r["max_abs_err"], "shapes": r["shapes"]}
                           for k, r in checks.items()}


def cpu_pass_child(out_path: str, threads: int, sf: float, split_rows: int) -> None:
    """Phase 2's CPU pass: the port on the CPU over ``ALL_QUERIES`` at
    scale ``sf`` in ``split_rows`` splits (phase 2's), with ``threads``
    torch intra-op threads; pickles each query's result and ``last_plan_actuals["nodes"]``
    (phase 14's reference records), and the seconds, to ``out_path``."""
    import pickle

    import torch

    torch.set_num_threads(threads)
    from trino_tpu_torch import Engine
    from trino_tpu_torch.connectors.tpch import TpchConnector

    t0 = time.perf_counter()
    cpu = Engine(device="cpu")
    cpu.register_catalog("tpch", TpchConnector(sf=sf, split_rows=split_rows))
    cpu.execute_sql(Q15_VIEW, cpu.create_session("tpch"))
    out = {}
    for q, sql in ALL_QUERIES.items():
        t1 = time.perf_counter()
        cpu.last_plan_actuals = None
        res = cpu.execute_sql(sql, cpu.create_session("tpch"))
        out[q] = {"result": res, "seconds": time.perf_counter() - t1,
                  "nodes": None if cpu.last_plan_actuals is None
                  else cpu.last_plan_actuals["nodes"]}
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump({"queries": out, "seconds": time.perf_counter() - t0,
                     "threads": threads}, f)
    os.replace(tmp, out_path)


class ChildPass:
    """A CPU pass in a spawned child process, started at the top of
    ``main`` (before this process touches the card) and joined before the
    first phase that needs its results.  ``target(out_path, threads,
    *args)`` pickles its record to ``out_path``; the child's directory (its
    record and whatever else it writes there) is removed by ``stop``, which
    also ends the child, whatever state it is in."""

    def __init__(self, target, name: str, threads: int, *args):
        import multiprocessing
        import tempfile

        self.name = name
        self.dir = tempfile.mkdtemp(prefix=f"trino-{name}-")
        self.path = os.path.join(self.dir, f"{name}.pkl")
        self.threads = threads
        ctx = multiprocessing.get_context("spawn")
        self.proc = ctx.Process(target=target, args=(self.path, threads, *args),
                                name=name, daemon=True)
        self.started = time.perf_counter()
        self.proc.start()

    def join(self, timeout: float):
        """(the child's record, seconds this join waited); fails the run if
        the child failed, ran past ``timeout`` or returned nothing."""
        import pickle

        t0 = time.perf_counter()
        self.proc.join(timeout)
        waited = time.perf_counter() - t0
        check(not self.proc.is_alive(), f"{self.name} ran past {timeout:.0f} s of waiting")
        check(self.proc.exitcode == 0, f"{self.name} exited with code {self.proc.exitcode}")
        check(os.path.exists(self.path), f"{self.name} returned nothing")
        with open(self.path, "rb") as f:
            return pickle.load(f), waited

    def stop(self) -> None:
        import shutil

        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(5)
            if self.proc.is_alive():
                self.proc.kill()
                self.proc.join(5)
        shutil.rmtree(self.dir, ignore_errors=True)


def cpu_parity(cpu_pass, phase2):
    """Phase 2's card-vs-CPU checks over the child's results: each of the
    22 equal to the card's result, non-empty, with a history record.
    Returns phase 14's reference records."""
    data, waited = cpu_pass.join(CPU_PASS_TIMEOUT_S)
    check(list(data["queries"]) == list(ALL_QUERIES),
          f"phase 2's CPU pass returned {sorted(data['queries'])}")
    cpu_actuals = {}
    for q in ALL_QUERIES:
        ent = data["queries"][q]
        ref = ent["result"]
        check(ent["nodes"] is not None, f"{q}: the CPU run left no history record")
        cpu_actuals[q] = ent["nodes"]
        same_result(phase2[q], ref, f"sf{SF_MAIN:g} {q} card vs CPU")
        check(len(ref) > 0, f"{q} returned no rows")
        print(f"sf{SF_MAIN:g} {q}: equal to the port's CPU result "
              f"({len(ref)} rows, CPU {ent['seconds']:.2f} s)", flush=True)
    began = time.perf_counter() - cpu_pass.started - waited
    print(f"CPU pass: {data['seconds']:.1f} s in the child ({data['threads']} torch threads); "
          f"the join began {began:.1f} s after the child started and waited {waited:.1f} s",
          flush=True)
    return cpu_actuals


class PhaseClock:
    """Seconds of each phase, printed on a line of its own as it ends."""

    def __init__(self):
        self.t = time.perf_counter()
        self.seconds = {}

    def done(self, phase: int) -> None:
        now = time.perf_counter()
        self.seconds[phase] = now - self.t
        self.t = now
        print(f"phase {phase}: {self.seconds[phase]:.1f} s", flush=True)


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
    clock = PhaseClock()
    # phases 2-11 measure the port with the buffer pool's tiers off, as their
    # launch tables and H2D checks were recorded (every scan generated);
    # phase 12 measures the pool's and the plan cache's defaults.  Phases
    # 2-13 and 14a-14b run with the adaptive advisor off: its re-plans (a
    # statement with a material misestimate is planned again on its second
    # run) are phase 14c's and 14e's to measure, 14e with every default, and
    # the earlier phases hold plan-cache hits and per-statement counts
    # recorded without them
    os.environ["TRINO_TPU_PAGE_CACHE"] = "0"
    os.environ["TRINO_TPU_RESULT_CACHE"] = "0"
    os.environ["TRINO_TPU_ADAPTIVE"] = "0"
    # phase 2's CPU parity pass runs beside the card phases, in a child
    # started before this process touches the card; phase 14 joins it
    half = max(1, len(os.sched_getaffinity(0)) // 2)
    cpu_pass = ChildPass(cpu_pass_child, "cpu-pass", half, SF_MAIN, SPLIT_ROWS)
    fed_pass = ChildPass(fed_pass_child, "fed-pass", FED_PASS_THREADS)
    # the CPU halves of phases 5, 8, 9 and 10, likewise
    ds_pass = ChildPass(tpcds_cpu_child, "tpcds-pass", CPU_CHILD_THREADS, TPCDS_SF_PARITY,
                        SPLIT_ROWS)
    mem_pass = ChildPass(memory_cpu_child, "memory-pass", CPU_CHILD_THREADS, SF_MAIN)
    fn_pass = ChildPass(functions_cpu_child, "functions-pass", CPU_CHILD_THREADS, SF_MAIN,
                        SPLIT_ROWS)
    ar_pass = ChildPass(arrays_cpu_child, "arrays-pass", CPU_CHILD_THREADS, SF_MAIN,
                        ARRAYS_SF_ALL_ROWS)
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
        clock.done(1)

        # -- phase 2: the main path at SF1 -------------------------------------
        conn = TpchConnector(sf=SF_MAIN, split_rows=SPLIT_ROWS)
        engine = Engine(device=DEVICE)
        engine.register_catalog("tpch", conn)
        engine.execute_sql(Q15_VIEW, engine.create_session("tpch"))
        check(engine.buffer_pool.budget() == 0, "phase 2 runs with the page tier on")
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

        # phase 12's oracle, and phase 8's after RF1 (each held against the
        # CPU pass when it is joined, before phase 14)
        phase2 = {q: main[q]["result"] for q in ALL_QUERIES}
        # phase 17e's: bench.py's five's launches, host reads and H2D bytes
        counts2 = {q: {"launches": main[q]["launches"], "host_reads": main[q]["host_reads"],
                       "h2d_bytes": main[q]["h2d_bytes"]} for q in QUERIES}
        tpch_ref = {q: phase2[q] for q in MEMORY_QUERIES}
        # phase 11's: each query's rows as the server sends them, its host
        # reads and its launches
        direct = {q: {"names": list(r["result"].names), "rows": json_rows(r["result"]),
                      "host_reads": r["host_reads"],
                      "launches": {k: v for k, v in r["launches"].items() if v}}
                  for q, r in main.items()}
        clock.done(2)

        # -- phase 3: kernels against their plain versions ---------------------
        q1_page = conn.generate(conn.splits("lineitem")[0], Q1_COLUMNS)
        li_keys = lineitem_keys(conn)
        kernels = kernel_checks(shapes, launches, q1_page, li_keys)
        del q1_page, li_keys
        clock.done(3)

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
        # phase 19b's oracle: the local SF10 results and warm walls
        phase4 = {q: {k: big_res[q][k] for k in ("result", "warm_s", "rows_per_s")}
                  for q in DIST_BIG_QUERIES}
        print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        clock.done(4)

        # -- phase 5: TPC-DS parity at SF0.1 ------------------------------------
        del engine, big_res, big
        torch.cuda.empty_cache()
        gpu = Engine(device=DEVICE)
        gpu.register_catalog("tpcds", TpcdsConnector(sf=TPCDS_SF_PARITY,
                                                      split_rows=SPLIT_ROWS))
        tpcds_queries = corpus()
        nodes = tpcds_parity(gpu, ds_pass, tpcds_queries)
        clock.done(5)

        # -- phase 6: TPC-DS at SF1 ----------------------------------------------
        ds = TpcdsConnector(sf=TPCDS_SF_MAIN, split_rows=SPLIT_ROWS)
        gpu = Engine(device=DEVICE)
        gpu.register_catalog("tpcds", ds)
        held_gpu = Engine(device=DEVICE)
        held_ds = TpcdsConnector(sf=TPCDS_SF_HELD, split_rows=TPCDS_SPLIT_HELD)
        held_gpu.register_catalog("tpcds", held_ds)
        held_splits = len(held_ds.splits("store_sales"))
        check(held_splits >= TPCDS_HELD_MIN_SPLITS,
              f"tpcds sf{TPCDS_SF_HELD:g}: store_sales spans {held_splits} split(s)")
        print(f"tpcds sf{TPCDS_SF_HELD:g}: store_sales "
              f"{held_ds.exact_row_count('store_sales')} rows in {held_splits} splits "
              f"of {TPCDS_SPLIT_HELD} on both sides", flush=True)
        cpu = Engine(device="cpu")
        cpu.register_catalog("tpcds", TpcdsConnector(sf=TPCDS_SF_HELD,
                                                     split_rows=TPCDS_SPLIT_HELD))
        # TPCDS_REQUIRED is the reference's page-loop recording: the page loop
        with env_vars(TRINO_TPU_SCAN_FUSED="0"):
            ds_main, ds_launches, ds_shapes = tpcds_main(gpu, held_gpu, cpu, tpcds_queries,
                                                         nodes,
                                                         ds.exact_row_count("store_sales"))
        del cpu, held_gpu, ds_main
        ds_checks = tpcds_kernel_checks(ds_shapes, ds)
        clock.done(6)

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
        clock.done(7)
        # -- phase 8: the memory catalog at SF1, TPC-H's refresh path -----------
        del gpu, ds_big, big_res
        torch.cuda.empty_cache()
        mem_launches, mem_checks = memory_path(tpch_ref, mem_pass)
        clock.done(8)
        # -- phase 9: the function library at SF0.01, SF1 and SF10 ------------
        with env_vars(TRINO_TPU_SCAN_FUSED="0"):  # FUNCTIONS_REQUIRED: the page loop's
            fn_launches, fn_checks = functions_path(fn_pass)
        clock.done(9)
        # -- phase 10: arrays, maps, UNNEST and MATCH_RECOGNIZE -----------------
        torch.cuda.empty_cache()
        with env_vars(TRINO_TPU_SCAN_FUSED="0"):  # ARRAYS_REQUIRED: the page loop's
            ar_launches, ar_checks = arrays_path(ar_pass)
        clock.done(10)
        # -- phase 11: the coordinator entry point, TPC-H SF1 over the protocol -
        torch.cuda.empty_cache()
        _, sv_launches, sv_checks = server_path(direct)
        clock.done(11)
        # -- phase 12: the plan cache and the buffer pool at their defaults, ---
        # the advisor off (phase 14e runs the 22 with the advisor on)
        with env_vars(TRINO_TPU_SCAN_FUSED="0"):  # the page tier: the page loop reads it
            _, ca_launches, ca_checks = cache_path(phase2)
        clock.done(12)
        # -- phase 13: plan templates and the template batcher -----------------
        _, tp_launches, tp_checks = templates_path()
        clock.done(13)
        # -- phase 2's card-vs-CPU checks: the CPU pass joined ----------------
        cpu_actuals = cpu_parity(cpu_pass, phase2)  # phase 14's reference records
        # -- phase 14: per-node stats, plan history and adaptive execution -----
        _, ad_launches, ad_checks = history_path(phase2, cpu_actuals)
        clock.done(14)
        # -- phase 15: the flight recorder, the build log, the in-flight -------
        # registry and the stall watchdog
        _, fl_launches, fl_checks = flight_path(phase2)
        clock.done(15)
        # -- phase 16: memory-bounded execution: the tiered spill, Grace -------
        # partitioning and the admission rung
        _, sp_launches, sp_checks = spill_path(phase2)
        clock.done(16)
        # -- phase 17: the fault injector at the local chokepoints and the ----
        # chaos matrix
        _, ch_launches, ch_checks = chaos_path(counts2, wrapper_host_ms(kernels))
        clock.done(17)
        # -- phase 18: the connectors past the generators: federation over ---
        # DB-API with the index join and the pushdowns, blackhole
        _, fd_launches, fd_checks = federation_path(fed_pass)
        clock.done(18)
        # -- phase 19: the worker mesh: the distributed executor over a -------
        # virtual 8-position mesh on the card
        _, di_launches, di_checks = distributed_path(phase4)
        clock.done(19)
        # -- phase 20: fault-tolerant execution and the multi-process cluster: -
        # a coordinator and worker processes on the one card
        _, cl_launches, cl_checks = cluster_path(phase4)
        del phase4
        clock.done(20)
        # -- phase 21: dispatch coalescing and the scan-fused runners: three --
        # modes at SF10, the busy share, graph replays against eager bodies
        _, co_launches, co_checks = coalesce_path()
        clock.done(21)

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
                               **sv_checks.get(name, {"max_abs_err": None, "shapes": []})},
                "cache_sf1": {"launches": ca_launches[name],
                              **ca_checks.get(name, {"max_abs_err": None, "shapes": []})},
                "templates_sf1": {"launches": tp_launches[name],
                                  **tp_checks.get(name, {"max_abs_err": None, "shapes": []})},
                "adaptive_sf1": {"launches": ad_launches[name],
                                 **ad_checks.get(name, {"max_abs_err": None, "shapes": []})},
                "flight_sf1": {"launches": fl_launches[name],
                               **fl_checks.get(name, {"max_abs_err": None, "shapes": []})},
                "spill_sf1": {"launches": sp_launches[name],
                              **sp_checks.get(name, {"max_abs_err": None, "shapes": []})},
                "chaos_sf1": {"launches": ch_launches[name],
                              **ch_checks.get(name, {"max_abs_err": None, "shapes": []})},
                "federation_sf1": {"launches": fd_launches[name],
                                   **fd_checks.get(name, {"max_abs_err": None, "shapes": []})},
                "distributed_sf1": {"launches": di_launches[name],
                                    **di_checks.get(name, {"max_abs_err": None,
                                                           "shapes": []})},
                "cluster_sf1": {"launches": cl_launches[name],
                                **cl_checks.get(name, {"max_abs_err": None, "shapes": []})},
                "coalesce_sf10": {"launches": co_launches[name],
                                  **co_checks.get(name, {"max_abs_err": None,
                                                         "shapes": []})}}
            for checks in (ds_checks, mem_checks, fn_checks, ar_checks, sv_checks, ca_checks,
                           tp_checks, ad_checks, fl_checks, sp_checks, ch_checks, fd_checks,
                           di_checks, cl_checks, co_checks):
                if name in checks:
                    r["max_abs_err"] = max(r["max_abs_err"], checks[name]["max_abs_err"])
            r["launches"] += (ds_launches[name] + mem_launches[name] + fn_launches[name]
                              + ar_launches[name] + sv_launches[name] + ca_launches[name]
                              + tp_launches[name] + ad_launches[name] + fl_launches[name]
                              + sp_launches[name] + ch_launches[name] + fd_launches[name]
                              + di_launches[name] + cl_launches[name] + co_launches[name])
        print(f"phases: {json.dumps({k: round(v, 1) for k, v in clock.seconds.items()})}",
              flush=True)
        print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        for child in (cpu_pass, fed_pass, ds_pass, mem_pass, fn_pass, ar_pass):
            child.stop()

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
